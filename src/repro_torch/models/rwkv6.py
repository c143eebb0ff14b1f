"""RWKV-6 "Finch": token-shift mixing + data-dependent decay WKV recurrence.

The port's counterpart of ``repro.models.rwkv6`` for serving: the
time-mix projections into the ``wkv6`` operand layout (``time_mix_pre``),
its output stage (``time_mix_post``), the channel mix, ``wkv_core``/
``time_mix`` over the kernel registry (the full-sequence recurrence), and
the engine's decode state (``state_specs``) and single-token time mix
(``time_mix_step``, stock ops; the channel mix at T = 1 is its own step).
The RCTC per-layer lowering runs ``time_mix_pre``, ``time_mix_post`` and
``channel_mix`` as its ``tm_pre``/``tm_post``/``cm`` glue around
``Op.WKV6``. The full-sequence
recurrence takes the registry route, or with ``impl="autograd"``
(training) the JAX package's differentiable chunked scan,
``wkv_chunked``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (cumsum, grad_placed_as,
                                              low_rank_operands, matmul,
                                              replicate_dims, shard)
from repro_torch.models.common import AUTOGRAD, ParamSpec, group_norm

LORA_DIM = 64


def rwkv_specs(cfg: ModelConfig) -> dict:
    L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    K = cfg.rwkv_head_dim
    H = d // K
    dt = cfg.dtype
    return {
        # time-mix
        "tm_mix": ParamSpec((L, 5, d), dt, "uniform", 0.5,
                            ("layers", None, None)),
        "tm_w0": ParamSpec((L, d), "float32", "decay", axes=("layers", None)),
        "tm_wa": ParamSpec((L, d, LORA_DIM), dt,
                           axes=("layers", "fsdp", None)),
        "tm_wb": ParamSpec((L, LORA_DIM, d), dt,
                           axes=("layers", None, "fsdp")),
        "tm_u": ParamSpec((L, H, K), "float32", "uniform", 0.5,
                          ("layers", "heads", None)),
        "tm_wr": ParamSpec((L, d, d), dt, axes=("layers", "fsdp", "heads")),
        "tm_wk": ParamSpec((L, d, d), dt, axes=("layers", "fsdp", "heads")),
        "tm_wv": ParamSpec((L, d, d), dt, axes=("layers", "fsdp", "heads")),
        "tm_wg": ParamSpec((L, d, d), dt, axes=("layers", "fsdp", "heads")),
        "tm_wo": ParamSpec((L, d, d), dt, axes=("layers", "heads", "fsdp")),
        "tm_ln_w": ParamSpec((L, d), dt, "ones", axes=("layers", None)),
        "tm_ln_b": ParamSpec((L, d), dt, "zeros", axes=("layers", None)),
        # channel-mix
        "cm_mix": ParamSpec((L, 2, d), dt, "uniform", 0.5,
                            ("layers", None, None)),
        "cm_wk": ParamSpec((L, d, f), dt, axes=("layers", "fsdp", "mlp")),
        "cm_wv": ParamSpec((L, f, d), dt, axes=("layers", "mlp", "fsdp")),
        "cm_wr": ParamSpec((L, d, d), dt, axes=("layers", "fsdp", None)),
    }


def state_specs(cfg: ModelConfig, batch: int) -> dict:
    """The engine's per-layer decode state: the WKV state (L, B, H, K, K)
    fp32 and the two token-shift rows (L, B, d)."""
    L, d = cfg.num_layers, cfg.d_model
    K = cfg.rwkv_head_dim
    H = d // K
    return {"wkv": ParamSpec((L, batch, H, K, K), "float32", "zeros",
                             axes=("layers", "batch", "heads", None, None)),
            "ts_tm": ParamSpec((L, batch, d), cfg.dtype, "zeros",
                               axes=("layers", "batch", None)),
            "ts_cm": ParamSpec((L, batch, d), cfg.dtype, "zeros",
                               axes=("layers", "batch", None))}


def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x: (B,T,d); prev: (B,d) last token of the previous segment."""
    return torch.cat([prev[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


def _decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent decay log-weights lw = -exp(w0 + lora(x)) (<= 0); the
    LoRA runs in fp32 and is clipped to [-12, 3]."""
    lora = torch.tanh(torch.matmul(xw.float(), p["tm_wa"].float()))
    lora, wb = low_rank_operands(lora, p["tm_wb"])
    w_raw = p["tm_w0"].float() + torch.matmul(lora, wb.float())
    return -torch.exp(torch.clamp(w_raw, -12.0, 3.0))


def time_mix_pre(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 ts_prev: torch.Tensor):
    """Token-shift mixing + projections into the WKV operand layout.

    Returns (r, k, v, lw — all (B,T,H,K) fp32, lw <= 0; g (B,T,d)): the
    first four are the tensor operands of ``Op.WKV6``."""
    B, T, d = x.shape
    K = cfg.rwkv_head_dim
    H = d // K
    xprev = _shift(x, ts_prev)
    mix = p["tm_mix"].to(x.dtype)                           # (5, d)
    xr, xk, xv, xw, xg = [x + (xprev - x) * mix[i] for i in range(5)]
    r = torch.matmul(xr, p["tm_wr"]).reshape(B, T, H, K)
    k = torch.matmul(xk, p["tm_wk"]).reshape(B, T, H, K)
    v = torch.matmul(xv, p["tm_wv"]).reshape(B, T, H, K)
    g = torch.matmul(xg, p["tm_wg"])
    lw = _decay(p, xw).reshape(B, T, H, K)
    return r.float(), k.float(), v.float(), lw, g


def time_mix_post(cfg: ModelConfig, p: dict, y: torch.Tensor,
                  g: torch.Tensor, x_dtype: torch.dtype) -> torch.Tensor:
    """Group-norm + silu gate + output projection (shared tail).
    y: (B,T,H,K) fp32 WKV output; g: (B,T,d) gate projection."""
    B, T, H, K = y.shape
    y = y.reshape(B, T, H * K).to(x_dtype)
    y = group_norm(y, p["tm_ln_w"], p["tm_ln_b"], H, cfg.norm_eps)
    y = y * F.silu(g.float()).to(x_dtype)
    y = shard(y, "batch", "seq", "heads")
    return matmul(y, p["tm_wo"])


def wkv_chunked(r, k, v, lw, u, s0, chunk: int = 16):
    """Chunked WKV6 (``repro.models.rwkv6.wkv_chunked``), the training
    route: differentiable stock ops. r/k/v/lw (B,T,H,K) fp32, u (H,K), s0
    (B,H,K,K).

    T is padded to a whole number of chunks of min(chunk, T) (k = v = 0
    adds nothing to the state, lw = 0 leaves it undecayed). In a chunk,
    with p the inclusive and p_prev the exclusive cumsum of lw, token t
    reads the earlier tokens j < t through ``exp(p_prev_t - p_j)``, its
    own through the bonus ``u``, and the entering state through
    ``exp(p_prev_t)``; the state leaves decayed by ``exp(p_last)`` with
    each token's ``k exp(p_last - p_j) v^T`` added. Every exponent is <=
    0: the pairs j >= t are masked to -inf before the exp, so neither
    their value nor their gradient can overflow. Returns (y (B,T,H,K),
    s_final)."""
    r, k, v, lw, u, s0 = _whole_heads(r, k, v, lw, u, s0)
    B, T, H, K = r.shape
    C = min(chunk, T)
    Tp = (T + C - 1) // C * C
    if Tp != T:
        r, k, v, lw = (F.pad(a, (0, 0, 0, 0, 0, Tp - T))
                       for a in (r, k, v, lw))
    earlier = torch.ones((C, C), dtype=torch.bool,
                         device=r.device).tril(-1)[None, :, :, None, None]
    S, ys = s0, []
    for c0 in range(0, Tp, C):
        r_, k_, v_, lw_ = (a[:, c0:c0 + C] for a in (r, k, v, lw))
        p = cumsum(lw_, 1)                                  # inclusive
        pprev = p - lw_                                     # exclusive
        diff = pprev[:, :, None] - p[:, None, :]            # (B,Ct,Cj,H,K)
        e = torch.exp(diff.masked_fill(~earlier, float("-inf")))
        att = torch.sum(r_[:, :, None] * k_[:, None] * e, dim=-1)
        y = torch.einsum("btjh,bjho->btho", att, v_)
        coef = torch.sum(r_ * u * k_, dim=-1)               # the bonus
        y = y + coef[..., None] * v_
        y = y + torch.einsum("bthi,bhio->btho", r_ * torch.exp(pprev), S)
        kd = k_ * torch.exp(p[:, -1:] - p)                  # to chunk end
        S = torch.exp(p[:, -1])[..., None] * S + torch.einsum(
            "bthi,btho->bhio", kd, v_)
        ys.append(y)
    # y, whole along heads, takes its gradient back whole along heads:
    # each chunk's einsums fold (b, h) in their backward
    y = replicate_dims(torch.cat(ys, 1)[:, :T], (2,))
    return grad_placed_as(y), S


def _whole_heads(r, k, v, lw, u, s0):
    """The WKV operands made whole along heads where DTensors split them
    (r/k/v/lw dim 2, u dim 0, s0 dim 1); plain tensors as they are. The
    einsums fold (b, h), which torch 2.11's DTensor cannot do with both
    split."""
    return (*(replicate_dims(a, (2,)) for a in (r, k, v, lw)),
            replicate_dims(u, (0,)), replicate_dims(s0, (1,)))


def wkv_core(r, k, v, lw, u, s0, impl=None):
    """Full-sequence WKV recurrence through the registry ``wkv6``. Returns
    (y, s_final). ``impl="ref"`` runs the kernel's plain version whatever
    the device; ``impl="autograd"`` takes ``wkv_chunked`` instead of the
    registry.

    The kernel computes the zero-state recurrence: an entering state s0 is
    folded in exactly with ``y += (r * exp(p_prev)) @ s0`` (p_prev the
    exclusive cumsum of lw), and the final state comes in closed form; every
    exponent is <= 0, so nothing overflows."""
    if impl == AUTOGRAD:
        return wkv_chunked(r, k, v, lw, u, s0)
    from repro_torch.kernels import registry
    y = registry.call("wkv6", r, k, v, lw, u, impl=impl)
    r, k, v, lw, u, s0 = _whole_heads(r, k, v, lw, u, s0)
    p = torch.cumsum(lw, dim=1)                             # inclusive
    pprev = p - lw                                          # exclusive
    y = y + torch.einsum("bthi,bhio->btho", r * torch.exp(pprev), s0)
    s_final = torch.exp(p[:, -1])[..., None] * s0 + torch.einsum(
        "bthi,btho->bhio", k * torch.exp(p[:, -1:] - p), v)
    return y, s_final


def time_mix(cfg: ModelConfig, p: dict, x: torch.Tensor,
             ts_prev: torch.Tensor, s0: torch.Tensor, impl=None):
    """RWKV6 attention replacement. Returns (y, new_ts, new_state)."""
    r, k, v, lw, g = time_mix_pre(cfg, p, x, ts_prev)
    y, s1 = wkv_core(r, k, v, lw, p["tm_u"].float(), s0, impl)
    return time_mix_post(cfg, p, y, g, x.dtype), x[:, -1], s1


def time_mix_step(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  ts_prev: torch.Tensor, s0: torch.Tensor):
    """Single-token decode step. x (B,1,d); ts_prev (B,d); s0 (B,H,K,K)
    fp32, only read. ``y = r . (S + (u*k) v^T)``, ``S' = diag(w) S + k
    v^T``. Returns (y (B,1,d), new_ts (B,d), new_state)."""
    B, _, d = x.shape
    K = cfg.rwkv_head_dim
    H = d // K
    mix = p["tm_mix"].to(x.dtype)
    xp = ts_prev[:, None, :].to(x.dtype)
    xr, xk, xv, xw, xg = [x + (xp - x) * mix[i] for i in range(5)]

    def proj(a, w):
        return torch.matmul(a, w)[:, 0]                     # (B,d)
    r = proj(xr, p["tm_wr"]).reshape(B, H, K).float()
    k = proj(xk, p["tm_wk"]).reshape(B, H, K).float()
    v = proj(xv, p["tm_wv"]).reshape(B, H, K).float()
    g = proj(xg, p["tm_wg"])
    w = torch.exp(_decay(p, xw)[:, 0]).reshape(B, H, K)     # per channel
    u = p["tm_u"].float()
    kv = k[..., :, None] * v[..., None, :]                  # (B,H,K,K)
    r, s_ = replicate_dims(r, (1,)), replicate_dims(
        s0 + u[None, :, :, None] * kv, (1,))
    y = torch.einsum("bhi,bhio->bho", r, s_)
    s1 = w[..., None] * s0 + kv
    y = y.reshape(B, d).to(x.dtype)
    y = group_norm(y, p["tm_ln_w"], p["tm_ln_b"], H, cfg.norm_eps)
    y = y * F.silu(g.float()).to(x.dtype)
    return torch.matmul(y, p["tm_wo"])[:, None], x[:, -1], s1


def channel_mix(cfg: ModelConfig, p: dict, x: torch.Tensor,
                ts_prev: torch.Tensor):
    """RWKV6 FFN replacement. Returns (y, new_ts). At T = 1 it is the JAX
    package's ``channel_mix_step``, the decode step's channel mix."""
    xprev = _shift(x, ts_prev)
    mix = p["cm_mix"].to(x.dtype)
    xk = x + (xprev - x) * mix[0]
    xr = x + (xprev - x) * mix[1]
    k = shard(torch.square(F.relu(torch.matmul(xk, p["cm_wk"]))),
              "batch", "seq", "mlp")
    kv = matmul(k, p["cm_wv"])
    r = torch.sigmoid(torch.matmul(xr, p["cm_wr"]).float())
    return r.to(x.dtype) * kv, x[:, -1]

