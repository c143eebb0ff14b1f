"""A dense decoder (mistral-nemo's family): pre-norm blocks of causal
grouped-query attention with RoPE and a SwiGLU MLP, RMSNorm everywhere.

Per layer, on hidden states x (S, d) in fp32:

    h = rms(x) * ln1;  q = h Wq, k = h Wk, v = h Wv     (heads of D)
    q, k rotated by RoPE (half split, angle pos / theta^(2i/D))
    o = softmax(q k^T / sqrt(D), causal) v, each query head reading the
        key head of its group
    x = x + o Wo
    h = rms(x) * ln2;  x = x + (silu(h Wg) * (h Wu)) Wd

then rms(x) * final_norm and the head. No bias, no tied embedding.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench import counts
from perfbench.reference.common import head, lin, prep, rms

QUERY_BLOCK = 1024       # queries attended at a time (bounds the scores)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, D) rotated by position, half split."""
    S, _, D = x.shape
    freqs = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                          device=x.device) / D))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal GQA: q (S, H, D), k/v (S, Hkv, D) -> (S, H, D)."""
    S, H, D = q.shape
    Hkv = k.shape[1]
    qg = q.view(S, Hkv, H // Hkv, D)
    out = torch.empty_like(q)
    for a in range(0, S, QUERY_BLOCK):
        b = min(S, a + QUERY_BLOCK)
        s = torch.einsum("qhgd,khd->hgqk", qg[a:b], k[:b]) / D ** 0.5
        qpos = torch.arange(a, b, device=q.device)[:, None]
        kpos = torch.arange(b, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
        o = torch.einsum("hgqk,khd->qhgd", torch.softmax(s, -1), v[:b])
        out[a:b] = o.reshape(b - a, H, D)
    return out


def logits(config: dict, params: dict, seqs: list, starts: list,
           fp8: bool) -> list:
    d = config["hidden_size"]
    H, Hkv = config["num_attention_heads"], config["num_key_value_heads"]
    D = config["head_dim"]
    eps, theta = config["rms_norm_eps"], config["rope_theta"]
    xs = [params["embed"][torch.as_tensor(s, device=params["embed"].device)
                          .long()].float() for s in seqs]
    for i in range(config["num_hidden_layers"]):
        W = {n: prep(params[n][i], fp8)
             for n in ("mlp_wi_gate", "mlp_wi_up", "mlp_wo")}
        wq, wk, wv = (prep(params[n][i].reshape(d, -1), fp8)
                      for n in ("wq", "wk", "wv"))
        wo = prep(params["wo"][i].reshape(H * D, d), fp8)
        ln1, ln2 = params["ln1"][i], params["ln2"][i]
        for j, x in enumerate(xs):
            S = x.shape[0]
            h = rms(x, ln1, eps)
            q = rope(lin(h, wq, fp8).view(S, H, D), theta)
            k = rope(lin(h, wk, fp8).view(S, Hkv, D), theta)
            v = lin(h, wv, fp8).view(S, Hkv, D)
            x = x + lin(attend(q, k, v).reshape(S, H * D), wo, fp8)
            h = rms(x, ln2, eps)
            g = F.silu(lin(h, W["mlp_wi_gate"], fp8)) \
                * lin(h, W["mlp_wi_up"], fp8)
            xs[j] = x + lin(g, W["mlp_wo"], fp8)
    return head(config, params, xs, starts, eps, fp8)


def layer_macs(config: dict) -> int:
    """Multiply-adds of one token through one layer's products."""
    d, F = config["hidden_size"], config["intermediate_size"]
    H, Hkv = config["num_attention_heads"], config["num_key_value_heads"]
    D = config["head_dim"]
    return d * (H + 2 * Hkv) * D + H * D * d + 3 * d * F


def prefill_flops(config: dict, s: int) -> int:
    """FLOPs of a prompt of s tokens: every layer over every token, the
    causal (q, k) pairs, and the last position's logits."""
    attn = 4 * config["head_dim"] * config["num_attention_heads"] \
        * counts.causal_pairs(s, s)
    return config["num_hidden_layers"] * (2 * s * layer_macs(config) + attn) \
        + 2 * config["hidden_size"] * config["vocab_size"]


def decode_flops(config: dict, positions) -> int:
    """FLOPs of one decode step over its live lanes, lane b at position
    positions[b] attending positions[b] + 1 rows."""
    n = len(positions)
    rows = sum(int(p) + 1 for p in positions)
    attn = 4 * config["head_dim"] * config["num_attention_heads"] * rows
    return config["num_hidden_layers"] * (2 * n * layer_macs(config) + attn) \
        + n * 2 * config["hidden_size"] * config["vocab_size"]
