"""GQA attention for the LM serving engine, full or sliding-window:
prefill on the hand-written flash-attention kernel where the window masks
nothing, one-token decode against a dense or ring-buffered KV cache on
stock torch ops.

The port's counterpart of ``repro.models.attention``'s dense-cache paths.
``_attend_full`` there is, below S = 16384, one chunk of causal GQA
attention at scale 1/sqrt(D). For full attention, and for a sliding window
W at S <= W (the window then masks nothing), that is the function the
``flash_attention`` kernel computes, so prefill runs the kernel (the plain
version on a CPU tensor). A sliding window at S > W is plain ``jnp`` in
the JAX package (its Pallas kernel takes no window) and stock torch ops
here, chosen by shape. A sliding-window cache is a ring of min(seq_len, W)
rows: prefill keeps the last W keys rolled so that token t sits at row
t % W, the row decode writes token t to (the JAX package keeps them
unrolled at rows 0 to W-1, so its decode after a prompt longer than W,
and not a multiple of it, reads the wrong keys). Decode is plain ``jnp``
in the JAX package and stays on stock torch ops here, with its K/V
written into the cache in place. What every layer of a pass shares
(RoPE's cos and sin; in decode also the row indices, the cache slots, the
valid-row mask and the scale) is built once a pass by ``rope_for`` and
``decode_consts`` and handed to each layer. Query chunking (S >= 16384)
raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.oplib import f32_scalar
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref_bshd
from repro_torch.models.common import (ParamSpec, apply_rope, rms_norm,
                                       rope_table)

NEG_INF = -1e30
CHUNKED_FROM = 16384          # _attend_full splits the queries from here on


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """KV-cache shape specs, (L, B, S, Hkv, D) each; a sliding window
    keeps a ring of S = min(seq_len, W) rows."""
    _check_ported(cfg)
    s = min(seq_len, cfg.sliding_window) if _sliding(cfg) else seq_len
    shp = (cfg.num_layers, batch, s, cfg.num_kv_heads, cfg.head_dim)
    return {"k": ParamSpec(shp, cfg.dtype, "zeros"),
            "v": ParamSpec(shp, cfg.dtype, "zeros")}


def _sliding(cfg: ModelConfig) -> bool:
    return cfg.attention == "sliding"


def _check_ported(cfg: ModelConfig, seq_len: int = 0) -> None:
    if cfg.attention not in ("full", "sliding") or seq_len >= CHUNKED_FROM:
        raise NotImplementedError(
            f"attention {cfg.attention!r} at S={seq_len} is not ported: "
            f"full or sliding-window causal attention below "
            f"S={CHUNKED_FROM} only")


def _project(x, w, b):
    """x (B,S,d) @ w (d,H,D) [+ b (H,D)] -> (B,S,H,D)."""
    B, S, d = x.shape
    _, H, D = w.shape
    y = (x @ w.reshape(d, H * D)).view(B, S, H, D)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def rope_for(cfg: ModelConfig, positions):
    """RoPE's (cos, sin) of ``positions`` (B, S) for every layer of a
    pass, or None when the config has no RoPE."""
    if not cfg.use_rope:
        return None
    return rope_table(positions, cfg.head_dim, cfg.rope_theta)


class DecodeConsts(NamedTuple):
    """What every layer of one decode step shares, built once a step from
    the device tensor ``pos`` (no host read): the lanes' row indices, their
    cache slots (``pos``, or ``pos % S`` in a ring), the (B, 1, 1, 1, S)
    valid-row mask (``idx <= pos``; in a ring every row once ``pos >=
    S``), the 0-d fp32 sqrt(D) the scores are divided by, and RoPE's
    table at ``pos``."""
    rows: torch.Tensor
    slot: torch.Tensor
    valid: torch.Tensor
    scale: torch.Tensor
    rope: Optional[tuple]


def decode_consts(cfg: ModelConfig, pos, seq_len: int) -> DecodeConsts:
    """The step's ``DecodeConsts`` for pos (B,) against caches of
    ``seq_len`` rows."""
    dev = pos.device
    p = pos.long()
    valid = torch.arange(seq_len, device=dev)[None, :] <= p[:, None]
    slot = p
    if _sliding(cfg):
        slot = torch.remainder(p, seq_len)
        valid = valid | (p[:, None] >= seq_len)
    return DecodeConsts(rows=torch.arange(pos.shape[0], device=dev),
                        slot=slot, valid=valid[:, None, None, None, :],
                        scale=f32_scalar(cfg.head_dim ** 0.5, pos),
                        rope=rope_for(cfg, pos[:, None]))


def _qkv(cfg: ModelConfig, p: dict, x, positions, rope=None):
    """Shared projection + qk-norm + RoPE for both full and decode paths;
    ``rope`` is ``rope_for(cfg, positions)`` when the caller has it."""
    q = _project(x, p["wq"], p.get("bq"))
    k = _project(x, p["wk"], p.get("bk"))
    v = _project(x, p["wv"], p.get("bv"))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.use_rope:
        if rope is None:
            rope = rope_for(cfg, positions)
        q = apply_rope(q, positions, cfg.rope_theta, rope)
        k = apply_rope(k, positions, cfg.rope_theta, rope)
    return q, k, v


def _grouped_scores(q, k):
    """q: (B,Sq,Hkv,G,D)  k: (B,Skv,Hkv,D) -> (B,Hkv,G,Sq,Skv) fp32."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())


def _out_proj(o, wo):
    """o (B,S,H,D) @ wo (H,D,d) -> (B,S,d)."""
    B, S, H, D = o.shape
    return o.reshape(B, S, H * D) @ wo.reshape(H * D, wo.shape[-1])


def _attend_windowed(cfg: ModelConfig, q, k, v, out_dtype):
    """Causal attention in a sliding window of W keys at S > W, on stock
    ops as the JAX package's ``_attend_full`` computes it: fp32 scores at
    scale 1/sqrt(D), masked to ``qpos - W < kpos <= qpos`` with NEG_INF,
    softmax in fp32, cast to ``out_dtype`` before the product with V."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    W = cfg.sliding_window
    s_ = _grouped_scores(q.reshape(B, S, Hkv, H // Hkv, D), k) \
        * (1.0 / D ** 0.5)
    idx = torch.arange(S, device=q.device)
    qpos, kpos = idx[:, None], idx[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - W)
    s_ = torch.where(mask, s_, NEG_INF)
    a = torch.softmax(s_, dim=-1).to(out_dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", a, v.to(out_dtype)).reshape(
        B, S, H, D)


def _attend_full(cfg: ModelConfig, p: dict, q, k, v, out_dtype, impl=None):
    """Causal GQA attention over the whole sequence, then the output
    projection. A sliding window at S > W takes ``_attend_windowed``, its
    only route. Otherwise ``impl="ref"`` computes the attention with the
    kernel's plain version whatever the device (the card-side check of
    the kernel inside the model); by default it is the kernel on a CUDA
    tensor."""
    S = q.shape[1]
    _check_ported(cfg, S)
    if impl not in (None, "ref"):
        raise ValueError(f"unknown attention impl {impl!r} (None or 'ref')")
    if _sliding(cfg) and S > cfg.sliding_window:
        o = _attend_windowed(cfg, q, k, v, out_dtype)
    elif impl == "ref":
        o = attention_ref_bshd(q, k, v, causal=True)
    else:
        o = flash_attention(q, k, v, causal=True)
    return _out_proj(o.to(out_dtype), p["wo"])


def full_attention(cfg: ModelConfig, p: dict, x, positions, impl=None,
                   rope=None):
    q, k, v = _qkv(cfg, p, x, positions, rope)
    return _attend_full(cfg, p, q, k, v, x.dtype, impl)


def prefill_attention(cfg: ModelConfig, p: dict, x, positions, impl=None,
                      rope=None):
    """Full attention that also returns the (layer-local) KV cache entry:
    every row, or in a sliding window of W the last min(S, W) rows, rolled
    by S % W so that token t sits at ring row t % W."""
    q, k, v = _qkv(cfg, p, x, positions, rope)
    y = _attend_full(cfg, p, q, k, v, x.dtype, impl)
    S, W = x.shape[1], cfg.sliding_window
    if _sliding(cfg) and S >= W:
        k, v = (torch.roll(t[:, -W:], S % W, dims=1) for t in (k, v))
    return y, (k, v)


def decode_attention(cfg: ModelConfig, p: dict, x, pos, k_cache, v_cache,
                     consts: Optional[DecodeConsts] = None):
    """One-token decode: x (B,1,d), pos (B,), caches (B,S,Hkv,D) holding
    ``pos`` valid tokens each (0 <= pos < S), or in a sliding window's ring
    the last min(pos, S) tokens, token t at row t % S; ``consts`` is
    ``decode_consts(cfg, pos, S)`` when the caller has it.

    The new token's K/V is written at its slot in place; scores in fp32
    over every cache row, masked to the valid rows with NEG_INF, softmax
    in fp32, cast to x's dtype before the product with V. Returns (out
    (B,1,d), k_cache, v_cache)."""
    _check_ported(cfg)
    B, S, Hkv, D = k_cache.shape
    H = cfg.num_heads
    c = consts if consts is not None else decode_consts(cfg, pos, S)
    q, k, v = _qkv(cfg, p, x, pos[:, None], c.rope)
    k_cache[c.rows, c.slot] = k[:, 0].to(k_cache.dtype)
    v_cache[c.rows, c.slot] = v[:, 0].to(v_cache.dtype)

    qg = q.reshape(B, 1, Hkv, H // Hkv, D)
    s_ = _grouped_scores(qg, k_cache) / c.scale
    s_ = torch.where(c.valid, s_, NEG_INF)
    a = torch.softmax(s_, dim=-1).to(x.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", a, v_cache).reshape(B, 1, H, D)
    return _out_proj(o, p["wo"]), k_cache, v_cache
