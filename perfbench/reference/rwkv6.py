"""RWKV-6 "Finch" as the port serves it: RMSNorm pre-norm blocks of a time
mix (static token-shift mixing, a data-dependent decay through a low-rank
deck, the WKV recurrence with its bonus, a per-head group norm and a SiLU
gate) and a channel mix (squared-ReLU key, sigmoid receptance).

Per layer, on hidden states x (S, d) in fp32, x_prev the sequence shifted
one token down (zeros before the first):

    h = rms(x) * ln1;  m_i = h + (h_prev - h) * tm_mix[i], i = r k v w g
    r, k, v = m_r Wr, m_k Wk, m_v Wv (heads of K);  g = m_g Wg
    lw = -exp(clamp(w0 + tanh(m_w Wa) Wb, -12, 3))            (<= 0)
    y_t = r_t . (S + diag(u) k_t v_t^T);  S <- diag(exp(lw_t)) S + k_t v_t^T
    x = x + (groupnorm_heads(y) * silu(g)) Wo
    h = rms(x) * ln2;  n_j = h + (h_prev - h) * cm_mix[j], j = k r
    x = x + sigmoid(n_r Wr') * (relu(n_k Wk')^2 Wv')

then rms(x) * final_norm and the head. The recurrence runs in chunks of
``CHUNK`` tokens, exactly (every decay is a product of per-step decays,
taken as the exp of a float64 sum); it is the sequential recurrence
rearranged, not an approximation of it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench import counts
from perfbench.reference.common import head, lin, prep, rms

CHUNK = 64
CHUNKS_AT_ONCE = 16        # chunks whose in-chunk pairs are formed together
DECAY_LORA = 64            # the decay deck's width (tm_wa, tm_wb), for counts


def shift(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]])


def wkv(r, k, v, lw, u):
    """r/k/v/lw (T, H, K) fp32, u (H, K): y (T, H, K) from a zero state."""
    T, H, K = r.shape
    C = CHUNK
    N = math.ceil(T / C)
    pad = N * C - T
    if pad:
        r, k, v, lw = (torch.cat([a, a.new_zeros((pad, H, K))])
                       for a in (r, k, v, lw))
    r, k, v = (a.view(N, C, H, K) for a in (r, k, v))
    p = torch.cumsum(lw.view(N, C, H, K).double(), 1)      # inclusive
    pp = p - lw.view(N, C, H, K).double()                  # exclusive
    plast = p[:, -1]                                       # (N, H, K)
    # each chunk's own contribution to the state it hands on, and the
    # states entering the chunks, one chunk after another
    kd = k * torch.exp(plast[:, None] - p).float()
    contrib = torch.einsum("njhi,njho->nhio", kd, v)
    decay = torch.exp(plast).float()[..., None]            # (N, H, K, 1)
    state = torch.zeros((H, K, K), dtype=torch.float32, device=r.device)
    s_in = torch.empty((N, H, K, K), dtype=torch.float32, device=r.device)
    for n in range(N):
        s_in[n] = state
        state = decay[n] * state + contrib[n]
    y = torch.einsum("nthi,nhio->ntho", r * torch.exp(pp).float(), s_in)
    # the pairs inside a chunk (j < t), and each token's bonus
    earlier = torch.ones((C, C), dtype=torch.bool,
                         device=r.device).tril(-1)[None, :, :, None, None]
    bonus = (r * u * k).sum(-1, keepdim=True)
    for a in range(0, N, CHUNKS_AT_ONCE):
        b = min(N, a + CHUNKS_AT_ONCE)
        diff = pp[a:b, :, None] - p[a:b, None, :]          # (n, t, j, H, K)
        e = torch.exp(diff.masked_fill(~earlier, float("-inf"))).float()
        att = (r[a:b, :, None] * k[a:b, None] * e).sum(-1)  # (n, t, j, H)
        y[a:b] += torch.einsum("ntjh,njho->ntho", att, v[a:b]) \
            + bonus[a:b] * v[a:b]
    return y.reshape(N * C, H, K)[:T]


def group_norm(y: torch.Tensor, w, b, heads: int, eps: float):
    S, d = y.shape
    g = y.view(S, heads, d // heads)
    g = (g - g.mean(-1, keepdim=True)) * torch.rsqrt(
        g.var(-1, keepdim=True, correction=0) + eps)
    return g.reshape(S, d) * w.float() + b.float()


def logits(config: dict, params: dict, seqs: list, starts: list,
           fp8: bool) -> list:
    d, K = config["hidden_size"], config["head_size"]
    H = d // K
    eps = config["layer_norm_epsilon"]
    xs = [params["embed"][torch.as_tensor(s, device=params["embed"].device)
                          .long()].float() for s in seqs]
    mats = ("tm_wr", "tm_wk", "tm_wv", "tm_wg", "tm_wo", "tm_wa", "tm_wb",
            "cm_wk", "cm_wv", "cm_wr")
    for i in range(config["num_hidden_layers"]):
        W = {n: prep(params[n][i], fp8) for n in mats}
        P = {n: params[n][i].float() for n in ("ln1", "ln2", "tm_mix",
                                                "tm_w0", "tm_u", "tm_ln_w",
                                                "tm_ln_b", "cm_mix")}
        for j, x in enumerate(xs):
            S = x.shape[0]
            h = rms(x, P["ln1"], eps)
            hp = shift(h)
            mr, mk, mv, mw, mg = (h + (hp - h) * P["tm_mix"][m]
                                  for m in range(5))
            r = lin(mr, W["tm_wr"], fp8).view(S, H, K)
            k = lin(mk, W["tm_wk"], fp8).view(S, H, K)
            v = lin(mv, W["tm_wv"], fp8).view(S, H, K)
            g = lin(mg, W["tm_wg"], fp8)
            lora = lin(torch.tanh(lin(mw, W["tm_wa"], fp8)), W["tm_wb"], fp8)
            lw = -torch.exp(torch.clamp(P["tm_w0"] + lora, -12.0, 3.0))
            y = wkv(r, k, v, lw.view(S, H, K), P["tm_u"]).reshape(S, d)
            y = group_norm(y, P["tm_ln_w"], P["tm_ln_b"], H, eps) * F.silu(g)
            x = x + lin(y, W["tm_wo"], fp8)
            h = rms(x, P["ln2"], eps)
            hp = shift(h)
            nk = h + (hp - h) * P["cm_mix"][0]
            nr = h + (hp - h) * P["cm_mix"][1]
            kk = torch.square(F.relu(lin(nk, W["cm_wk"], fp8)))
            xs[j] = x + torch.sigmoid(lin(nr, W["cm_wr"], fp8)) \
                * lin(kk, W["cm_wv"], fp8)
    return head(config, params, xs, starts, eps, fp8)


def layer_macs(config: dict) -> int:
    """Multiply-adds of one token through one layer's products: r, k, v, g
    and the output (5 d x d), the decay's two low-rank decks, and the
    channel mix (d x F, F x d, d x d)."""
    d, F = config["hidden_size"], config["intermediate_size"]
    return 5 * d * d + 2 * d * DECAY_LORA + 2 * d * F + d * d


def wkv_ops(config: dict, t: int) -> int:
    """counts.wkv6_bound's operation count for t tokens of one sequence."""
    K = config["head_size"]
    return counts.wkv6_bound(1, t, config["hidden_size"] // K, K,
                             "bfloat16")[3]


def prefill_flops(config: dict, s: int) -> int:
    """FLOPs of a prompt of s tokens: every layer over every token, the
    recurrence, and the last position's logits."""
    return config["num_hidden_layers"] * (2 * s * layer_macs(config)
                                          + wkv_ops(config, s)) \
        + 2 * config["hidden_size"] * config["vocab_size"]


def decode_flops(config: dict, positions) -> int:
    """FLOPs of one decode step over its live lanes: one token each."""
    return len(positions) * (
        config["num_hidden_layers"] * (2 * layer_macs(config)
                                       + wkv_ops(config, 1))
        + 2 * config["hidden_size"] * config["vocab_size"])
