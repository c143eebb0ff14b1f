"""GQA attention for the LM serving engine, full or sliding-window:
prefill on the hand-written flash-attention kernel where the window masks
nothing, one-token decode against a dense or ring-buffered KV cache on
stock torch ops; and for training (``impl="autograd"``) the full sequence
on stock ops under autograd, as the JAX package trains it.

The port's counterpart of ``repro.models.attention``'s dense-cache paths.
``_attend_full`` there is causal GQA attention at scale 1/sqrt(D), its
queries split into chunks of 8192 from S = 16384 on (which bounds the
scores' memory and leaves the function as it is). For full attention,
and for a sliding window W at S <= W (the window then masks nothing),
that is the function the
``flash_attention`` kernel computes, so prefill runs the kernel (the plain
version on a CPU tensor). A sliding window at S > W is plain ``jnp`` in
the JAX package (its Pallas kernel takes no window) and stock torch ops
here, chosen by shape. A sliding-window cache is a ring of min(seq_len, W)
rows: prefill keeps the last W keys rolled so that token t sits at row
t % W, the row decode writes token t to (the JAX package keeps them
unrolled at rows 0 to W-1, so its decode after a prompt longer than W,
and not a multiple of it, reads the wrong keys). Decode is plain ``jnp``
in the JAX package and stays on stock torch ops here, with its K/V
written into the cache in place. Paged decode (``decode_attention_paged``)
writes the new K/V into a block pool through block tables and gathers each
lane's blocks back into a contiguous span: the same scores, mask, softmax
and P.V as dense decode (one shared tail, ``_attend_decode``), over the
gathered rows. What every layer of a pass shares (RoPE's cos and sin; in
decode also the rows or blocks written, the slots in them, the valid-row
mask and the scale; in paged decode the gather index) is built once a
pass by ``rope_for``, ``decode_consts`` and ``paged_decode_consts`` and
handed to each layer. Inside an ``axis_rules`` binding the activations
are placed by logical axes (``shard``), the kernel runs on each rank's
shard through its DTensor rule, and decode writes a sharded cache with a
masked insert.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.oplib import f32_scalar
from repro_torch.distributed.sharding import (is_dtensor, matmul,
                                              replicate_dims, reshape, shard,
                                              shard_reshape, sharded_dims)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref_bshd
from repro_torch.models.common import (AUTOGRAD, ParamSpec, apply_rope,
                                       rms_norm, rope_table)

NEG_INF = -1e30
CHUNKED_FROM = 16384          # _attend_windowed splits the queries from here
QUERY_CHUNK = 8192            # on, into S // QUERY_CHUNK chunks


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """KV-cache shape specs, (L, B, S, Hkv, D) each; a sliding window
    keeps a ring of S = min(seq_len, W) rows."""
    _check_ported(cfg)
    s = min(seq_len, cfg.sliding_window) if _sliding(cfg) else seq_len
    shp = (cfg.num_layers, batch, s, cfg.num_kv_heads, cfg.head_dim)
    axes = ("layers", "batch", "seq", "kv_heads", "head_dim")
    return {"k": ParamSpec(shp, cfg.dtype, "zeros", axes=axes),
            "v": ParamSpec(shp, cfg.dtype, "zeros", axes=axes)}


def _sliding(cfg: ModelConfig) -> bool:
    return cfg.attention == "sliding"


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.attention not in ("full", "sliding"):
        raise NotImplementedError(
            f"attention {cfg.attention!r} is not ported: full or "
            f"sliding-window causal attention only")


def _project(x, w, b, heads: str = "heads"):
    """x (B,S,d) @ w (d,H,D) [+ b (H,D)] -> (B,S,H,D). Inside a binding
    the product's H*D columns are first placed as the ``heads`` axis
    places H (dim 2 of both shapes): DTensor may split the columns
    anywhere, and the view needs whole heads on each rank."""
    B, S, d = x.shape
    _, H, D = w.shape
    y = shard_reshape(x @ reshape(w, (d, H * D)), (B, S, H, D),
                      "batch", None, heads, None)
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
    the device tensors ``pos`` (and, paged, ``tables``; no host read): the
    new K/V's write index, ``cache[rows, slot]`` (dense: the lanes' row
    indices and cache slots, ``pos`` or ``pos % S`` in a ring; paged: the
    lanes' physical blocks and the offsets in them), the (B, 1, 1, 1, S)
    valid-row mask (``idx <= pos``; in a ring every row once ``pos >=
    S``), the 0-d fp32 sqrt(D) the scores are divided by, RoPE's table at
    ``pos`` and, paged only, the (lanes, W) int64 block table the keys and
    values are gathered through (``paged_decode_consts``)."""
    rows: torch.Tensor
    slot: torch.Tensor
    valid: torch.Tensor
    scale: torch.Tensor
    rope: Optional[tuple]
    blocks: Optional[torch.Tensor] = None


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


def paged_decode_consts(cfg: ModelConfig, pos, tables,
                        block_size: int) -> DecodeConsts:
    """The step's ``DecodeConsts`` for pos (B,) against a block pool of
    ``block_size`` rows a block, addressed through tables (lanes, W),
    lanes >= B: logical position t of lane b lives at (tables[b, t //
    block_size], t % block_size), and the W gathered blocks give W *
    block_size rows. The new token's block is ``tables[b, (pos // bs) %
    W]`` (a pad lane, all null, writes the null block). Rows of ``tables``
    past B are null lanes that only the scores see
    (``decode_attention_paged``)."""
    _check_ported(cfg)
    p = pos.long()
    blocks = tables.long()
    B, W = p.shape[0], blocks.shape[1]
    blk = torch.gather(blocks[:B], 1, torch.remainder(
        torch.div(p, block_size, rounding_mode="floor"), W)[:, None])[:, 0]
    valid = torch.arange(W * block_size, device=pos.device)[None, :] \
        <= p[:, None]
    return DecodeConsts(
        rows=blk, slot=torch.remainder(p, block_size),
        valid=valid[:, None, None, None, :],
        scale=f32_scalar(cfg.head_dim ** 0.5, pos),
        rope=rope_for(cfg, pos[:, None]), blocks=blocks)


def _qkv(cfg: ModelConfig, p: dict, x, positions, rope=None):
    """Shared projection + qk-norm + RoPE for both full and decode paths;
    ``rope`` is ``rope_for(cfg, positions)`` when the caller has it."""
    q = _project(x, p["wq"], p.get("bq"))
    k = _project(x, p["wk"], p.get("bk"), "kv_heads")
    v = _project(x, p["wv"], p.get("bv"), "kv_heads")
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
    if _split_past_batch(q, k):
        qp = replicate_dims(q, (2, 3)).float().permute(0, 2, 3, 1, 4)
        kp = replicate_dims(k, (2,)).float().permute(0, 2, 3, 1)
        return torch.matmul(qp, kp[:, :, None])
    return torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())


def _grouped_values(a, v):
    """a: (B,Hkv,G,Sq,Skv)  v: (B,Skv,Hkv,D) -> (B,Sq,Hkv,G,D)."""
    if _split_past_batch(a, v):
        ap = replicate_dims(a, (1, 2))
        vp = replicate_dims(v, (2,)).permute(0, 2, 1, 3)
        return torch.matmul(ap, vp[:, :, None]).permute(0, 3, 1, 2, 4)
    return torch.einsum("bhgqk,bkhd->bqhgd", a, v)


def _split_past_batch(a, b) -> bool:
    """Either DTensor operand of a grouped product is split along a dim
    other than batch. DTensor runs an einsum as views and one batched
    product, and torch 2.11's (the card's) cannot fold (b, h) or (g, q)
    with a split dim past the first; such operands go through
    ``torch.matmul`` instead, which folds only (b, h, g) and keeps the
    queries (and in decode the cache rows) split, after the heads are
    made whole. Plain tensors, and DTensors split along batch only, take
    the einsum."""
    return bool((sharded_dims(a) | sharded_dims(b)) - {0})


def _out_proj(o, wo):
    """o (B,S,H,D) @ wo (H,D,d) -> (B,S,d)."""
    B, S, H, D = o.shape
    return matmul(reshape(o, (B, S, H * D)), reshape(wo, (H * D,
                                                        wo.shape[-1])))


def _attend_windowed(cfg: ModelConfig, q, k, v, out_dtype):
    """Causal attention on stock ops as the JAX package's ``_attend_full``
    computes it: fp32 scores at scale 1/sqrt(D), masked to ``kpos <=
    qpos`` (in a sliding window of W also ``kpos > qpos - W``) with
    NEG_INF, softmax in fp32, cast to ``out_dtype`` before the product
    with V. From S = ``CHUNKED_FROM`` on the queries go in S //
    ``QUERY_CHUNK`` chunks, each against the keys it can see (in a window,
    those from W before the chunk). The route of a window at S > W, and
    of training."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    qg = shard_reshape(q, (B, S, Hkv, H // Hkv, D),
                       "batch", "seq", "kv_heads", None, None)
    k = shard(k, "batch", None, "kv_heads", None)
    v = shard(v, "batch", None, "kv_heads", None)
    n_chunks = max(1, S // QUERY_CHUNK) if S >= CHUNKED_FROM else 1
    cs = S // n_chunks
    outs = []
    for ci in range(n_chunks):
        q0, k1 = ci * cs, (ci + 1) * cs
        k0 = max(0, q0 - cfg.sliding_window) if _sliding(cfg) else 0
        s_ = _grouped_scores(qg[:, q0:k1], k[:, k0:k1]) * (1.0 / D ** 0.5)
        qpos = torch.arange(q0, k1, device=q.device)[:, None]
        kpos = torch.arange(k0, k1, device=q.device)[None, :]
        mask = kpos <= qpos
        if _sliding(cfg):
            mask = mask & (kpos > qpos - cfg.sliding_window)
        s_ = torch.where(mask, s_, NEG_INF)
        a = torch.softmax(s_, dim=-1).to(out_dtype)
        outs.append(_grouped_values(a, v[:, k0:k1].to(out_dtype)))
    o = outs[0] if n_chunks == 1 else torch.cat(outs, dim=1)
    return reshape(o, (B, S, H, D))


def _attend_full(cfg: ModelConfig, p: dict, q, k, v, out_dtype, impl=None):
    """Causal GQA attention over the whole sequence, then the output
    projection. A sliding window at S > W takes ``_attend_windowed``, its
    only route, and so does ``impl="autograd"`` (the training route, on
    any device: the JAX package's grouped scores and softmax, with the
    window's mask where it has one; the kernel has no backward).
    Otherwise ``impl="ref"`` computes the attention with the kernel's
    plain version whatever the device (the card-side check of the kernel
    inside the model); by default it is the kernel on a CUDA tensor."""
    S = q.shape[1]
    _check_ported(cfg)
    if impl not in (None, "ref", AUTOGRAD):
        raise ValueError(f"unknown attention impl {impl!r} (None, 'ref' or "
                         f"{AUTOGRAD!r})")
    if impl == AUTOGRAD or (_sliding(cfg) and S > cfg.sliding_window):
        o = _attend_windowed(cfg, q, k, v, out_dtype)
    elif impl == "ref":
        o = attention_ref_bshd(q, k, v, causal=True)
    else:
        o = flash_attention(q, k, v, causal=True)
    o = shard(o, "batch", "seq", "heads", None)
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
        k, v = (_roll_rows(t[:, -W:], S % W) for t in (k, v))
    return y, (k, v)


def _roll_rows(t, s: int):
    """``torch.roll(t, s, dims=1)`` as the two slices it swaps: the same
    copy, and torch 2.11's DTensor has a rule for cat but none for roll."""
    return torch.cat([t[:, t.shape[1] - s:], t[:, :t.shape[1] - s]], dim=1)


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
    c = consts if consts is not None else decode_consts(cfg, pos,
                                                        k_cache.shape[1])
    q = _write_new_kv(cfg, p, x, pos, k_cache, v_cache, c)
    kc = shard(k_cache, "batch", "seq", "kv_heads", None)
    vc = shard(v_cache, "batch", "seq", "kv_heads", None)
    scores = _grouped_scores(_group(q, kc.shape[2]), kc)
    return (_attend_decode(cfg, p, scores, vc, c, x.dtype),
            k_cache, v_cache)


def decode_attention_paged(cfg: ModelConfig, p: dict, x, pos, pool_k,
                           pool_v, tables,
                           consts: Optional[DecodeConsts] = None):
    """One-token decode against a paged KV pool (one layer's slice).

    x: (B,1,d); pos: (B,) logical position of the new token; pool_k/v:
    (num_blocks+1, block_size, Hkv, D), the last row the null block;
    tables: (lanes, W) int32 physical block ids, null-padded, lanes >= B
    (rows past B all null); ``consts`` is ``paged_decode_consts(cfg, pos,
    tables, block_size)`` when the caller has it.

    The new token's K/V is written at its (block, offset) in place: live
    lanes hold disjoint blocks, so their writes never collide; pad lanes
    all write the null row (duplicate indices, so which write lands there
    is unspecified), which is only ever gathered back behind the mask.
    Then the W blocks of each of the ``lanes`` rows are gathered into W *
    block_size rows and attended exactly as dense decode attends its cache
    rows: the valid rows carry the same scores, and the masked ones a
    weight of exactly 0. The scores q.k run over all ``lanes`` rows, q
    padded with zero lanes, and are cut back to the B live ones: on an
    H100 their batched GEMM rounds by its shape, so the paged engine passes
    tables of its dense counterpart's shape (max_batch lanes, max_seq rows;
    tests/test_torch_paged_gpu.py finds the op), and its streams equal the
    dense engine's. Returns (out (B,1,d), pool_k, pool_v)."""
    _, bs, Hkv, D = pool_k.shape
    B = x.shape[0]
    c = consts if consts is not None else paged_decode_consts(cfg, pos,
                                                              tables, bs)
    lanes, W = c.blocks.shape
    q = _write_new_kv(cfg, p, x, pos, pool_k, pool_v, c)
    kg = pool_k[c.blocks].reshape(lanes, W * bs, Hkv, D)  # gather blocks
    vg = pool_v[c.blocks[:B]].reshape(B, W * bs, Hkv, D)
    qd = torch.cat([q, q.new_zeros((lanes - B,) + tuple(q.shape[1:]))])
    scores = _grouped_scores(_group(qd, Hkv), kg)[:B]
    return (_attend_decode(cfg, p, scores, vg, c, x.dtype), pool_k,
            pool_v)


def _write_new_kv(cfg: ModelConfig, p: dict, x, pos, k_store, v_store,
                  c: DecodeConsts):
    """Project the new token and write its K/V at ``store[c.rows,
    c.slot]`` in place; returns q (B,1,H,D)."""
    q, k, v = _qkv(cfg, p, x, pos[:, None], c.rope)
    if is_dtensor(k_store):
        # A sharded cache: DTensor has no rule for ``index_put_`` into a
        # sharded dim, so the new row goes in as the reference writes it,
        # a masked elementwise insert that each rank runs on its own rows
        # (the same values, written in place).
        S = k_store.shape[1]
        hit = (torch.arange(S, device=pos.device)[None, :]
               == c.slot[:, None])[:, :, None, None]
        k_store.copy_(torch.where(hit, k.to(k_store.dtype), k_store))
        v_store.copy_(torch.where(hit, v.to(v_store.dtype), v_store))
        return q
    k_store[c.rows, c.slot] = k[:, 0].to(k_store.dtype)
    v_store[c.rows, c.slot] = v[:, 0].to(v_store.dtype)
    return q



def _group(q, Hkv: int):
    """q (B,1,H,D) -> (B,1,Hkv,G,D)."""
    B, _, H, D = q.shape
    return shard_reshape(q, (B, 1, Hkv, H // Hkv, D),
                         "batch", None, "kv_heads", None, None)


def _attend_decode(cfg: ModelConfig, p: dict, scores, values,
                   c: DecodeConsts, out_dtype):
    """The fp32 scores q.k (B,Hkv,G,1,S) over every row of values
    (B,S,Hkv,D): divided by sqrt(D), masked to ``c.valid`` with NEG_INF,
    softmax in fp32, cast to ``out_dtype`` before the product with V, then
    the output projection."""
    B, _, _, D = values.shape
    s_ = torch.where(c.valid, scores / c.scale, NEG_INF)
    a = torch.softmax(s_, dim=-1).to(out_dtype)
    o = _grouped_values(a, values).reshape(
        B, 1, cfg.num_heads, D)
    return _out_proj(o, p["wo"])
