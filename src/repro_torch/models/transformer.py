"""Parameter layout, initialization and input embedding of the LM families
(dense, vlm and audio; moe: attention + a top-k mixture of experts; hybrid:
attention + Mamba + SwiGLU; ssm: RWKV-6), and their forward passes for the
serving engine.

The port's counterpart of the parts of ``repro.models.transformer`` and
``repro.models.common`` that the per-layer RCB lowering and the engine
need: the stacked parameter specs (leading ``num_layers`` dim on block
entries), their initialization from a seed on a device, ``split_params``,
``embed_inputs``, ``params_from_jax`` to carry the JAX package's parameters
across, the decode state's ``cache_specs`` (KV cache, ring-buffered for a
sliding window; plus the SSM state in the hybrid family; the WKV state and
token-shift rows in the ssm family), ``forward_full`` (prefill: attention
on the flash-attention kernel, the scans on ``ssm_scan`` and ``wkv6``),
``forward_decode`` (one token against the cache, which it writes in place,
recurrent states included; an expert layer routes it as a group of one
token, which drops nothing), and for the paged engine (full attention
only) ``forward_decode_paged`` (one token against a KV block pool through
block tables, written in place) and ``scatter_prefill_cache`` (a dense
prefill cache into the pool). Every forward pass takes tokens or, for a vlm or
audio config, the frontend stub's embeddings, as the reference's do; only the
serving engines refuse embeddings. The reference scans its layers with
``lax.scan``; here they run in a Python loop, which computes the same thing;
what the layers share (RoPE's table, decode's per-step invariants) is built
once a pass, before it. Every spec carries the reference's
logical sharding axes; inside an ``axis_rules`` binding the parameters
are DTensors, the activations are placed at the reference's ``shard``
sites and the residual stream after each sublayer (``_residual``).

Training runs ``forward_full(impl="autograd")``: every kernel's
differentiable stock-op form (attention as grouped scores and a softmax,
``ssm_chunked``, ``wkv_chunked``), tokens or a vlm/audio config's (B, S, d)
embeddings as input, the stacked parameters split into layers by one
``unbind`` a pass (whose backward is one ``stack``, where a ``v[i]`` a
layer would zero-fill a whole stacked gradient each), and each block
optionally rematerialized (``remat``, ``remat_policy``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt_mod

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (carry_binding, is_dtensor,
                                              replicate_dims, shard,
                                              split_once)
from repro_torch.dtypes import as_tensor, torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models.common import ParamSpec, draw_param, rms_norm
from repro_torch.models import mamba
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models.mlp import mlp_specs, moe_ffn, moe_specs, swiglu

PORTED_FAMILIES = ("dense", "hybrid", "ssm", "moe", "vlm", "audio")
AUX_LOSS_WEIGHT = 0.01
REMAT_POLICIES = ("full", "dots")


def check_ported(cfg: ModelConfig) -> None:
    """Refuse what the port lacks: families other than
    ``PORTED_FAMILIES``."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to PyTorch yet "
            f"({', '.join(PORTED_FAMILIES)} only)")


def model_specs(cfg: ModelConfig) -> dict:
    """Stacked parameter specs (names and shapes as in
    ``repro.models.transformer.model_specs``): the norms, embedding and
    head, then attention and the SwiGLU MLP (the experts in its place where
    the config has experts), plus the Mamba branch in the hybrid family, or
    the RWKV-6 time and channel mixes in the ssm one."""
    check_ported(cfg)
    L, d, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    dt = cfg.dtype
    specs = {
        "ln1": ParamSpec((L, d), dt, "ones", axes=("layers", None)),
        "ln2": ParamSpec((L, d), dt, "ones", axes=("layers", None)),
        "final_norm": ParamSpec((d,), dt, "ones", axes=(None,)),
    }
    if cfg.input_kind == "tokens":
        specs["embed"] = ParamSpec((V, d), dt, "embed",
                                   axes=("vocab", "embed"))
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, V), dt, axes=("embed", "vocab"))
    if cfg.family == "ssm":
        specs.update(rwkv.rwkv_specs(cfg))
        return specs
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs.update({
        "wq": ParamSpec((L, d, H, D), dt,
                        axes=("layers", "fsdp", "heads", "head_dim")),
        "wk": ParamSpec((L, d, Hkv, D), dt,
                        axes=("layers", "fsdp", "kv_heads", "head_dim")),
        "wv": ParamSpec((L, d, Hkv, D), dt,
                        axes=("layers", "fsdp", "kv_heads", "head_dim")),
        "wo": ParamSpec((L, H, D, d), dt,
                        axes=("layers", "heads", "head_dim", "fsdp")),
    })
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((L, H, D), dt, "zeros",
                                axes=("layers", "heads", "head_dim"))
        specs["bk"] = ParamSpec((L, Hkv, D), dt, "zeros",
                                axes=("layers", "kv_heads", "head_dim"))
        specs["bv"] = ParamSpec((L, Hkv, D), dt, "zeros",
                                axes=("layers", "kv_heads", "head_dim"))
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((L, D), dt, "ones",
                                    axes=("layers", "head_dim"))
        specs["k_norm"] = ParamSpec((L, D), dt, "ones",
                                    axes=("layers", "head_dim"))
    if cfg.family == "hybrid":
        specs.update(mamba.mamba_specs(cfg))
    specs.update(moe_specs(cfg) if has_experts(cfg) else mlp_specs(cfg))
    return specs


def has_experts(cfg: ModelConfig) -> bool:
    """The FFN is a mixture of experts (the hybrid family ignores
    ``num_experts``, as the reference does)."""
    return cfg.num_experts > 0 and cfg.family != "hybrid"


def _ffn(cfg: ModelConfig, p: dict, h2):
    """The block's FFN on the normed hidden state: (y, aux), aux the MoE
    load-balance loss, None for a SwiGLU."""
    if has_experts(cfg):
        return moe_ffn(cfg, p, h2)
    return swiglu(p, h2), None


def init_params(cfg: ModelConfig, seed: int, device="cuda") -> dict:
    """Draw parameters from ``seed`` with a ``torch.Generator`` on
    ``device``, one spec after another in name order (``draw_param`` has
    the init kinds)."""
    dev = device_mod.resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    specs = model_specs(cfg)
    return {name: draw_param(specs[name], gen, dev) for name in sorted(specs)}


def params_from_jax(np_params: dict, device="cuda") -> dict:
    """The JAX package's stacked parameter dict (as numpy arrays, bf16 as
    ml_dtypes arrays) as the port's tensors on ``device``, bit for bit.
    Each is a copy: a CPU tensor would otherwise share the array's
    memory (``np.asarray`` of a JAX array may be a view of its buffer),
    and a training step writes its parameters in place."""
    dev = device_mod.resolve(device)
    out = {k: as_tensor(np.asarray(v), dev) for k, v in np_params.items()}
    return {k: t.clone() if dev.type == "cpu" else t for k, t in out.items()}


_BLOCK_KEYS_GLOBAL = ("embed", "lm_head", "final_norm")


def split_params(params: dict):
    blocks = {k: v for k, v in params.items() if k not in _BLOCK_KEYS_GLOBAL}
    glob = {k: v for k, v in params.items() if k in _BLOCK_KEYS_GLOBAL}
    return glob, blocks


def embed_inputs(cfg: ModelConfig, glob: dict, tokens) -> torch.Tensor:
    """tokens (B,S) -> hidden (B,S,d) on the embedding's device; a vlm or
    audio config's (B,S,d) embeddings (the frontend stub's output; (B,1,d)
    at decode) are cast to the config's dtype on the final norm's
    device."""
    if cfg.input_kind != "tokens":
        dev = glob["final_norm"].device
        x = as_tensor(tokens, dev).to(torch_dtype(cfg.dtype))
    else:
        emb = glob["embed"]
        idx = as_tensor(tokens, emb.device).long()
        if is_dtensor(emb):
            # the embedding op, whose backward DTensor places (torch
            # 2.11's fails on index_put, the backward of emb[idx]), on a
            # table whole along vocab (DTensor's masked lookup of a split
            # vocab loses its mask when the output is placed by batch)
            # and an index split over one mesh dim at most
            x = F.embedding(split_once(idx), replicate_dims(emb, (0,)))
        else:
            x = emb[idx]
    return shard(x, "batch", None, "embed")


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """Decode-state specs per family: the KV cache (a ring for a sliding
    window), plus the SSM state in the hybrid family; the WKV state and
    token-shift rows in the ssm family."""
    check_ported(cfg)
    if cfg.family == "ssm":
        return rwkv.state_specs(cfg, batch)
    c = attn.cache_specs(cfg, batch, seq_len)
    if cfg.family == "hybrid":
        c.update(mamba.mamba_state_specs(cfg, batch))
    return c


# ---------------------------------------------------------------------------
# Blocks (per-layer params, the leading L dim already sliced away)
# ---------------------------------------------------------------------------

def _residual(x):
    """The residual stream after each sublayer, placed as the embedding
    places it (the reference's scan carry keeps one sharding). Inside a
    binding this reduces a row-parallel product's partial sums: DTensor
    would otherwise carry them on and run the next layer's products whole
    on every rank; it also makes every layer cost the same."""
    return shard(x, "batch", None, "embed")


def block_full(cfg: ModelConfig, p: dict, x, positions, want_cache: bool,
               impl=None, rope=None):
    """Full-sequence block from zero recurrent states. Returns (x,
    cache_entry, aux), aux the MoE load-balance loss (None without
    experts). ``impl="ref"`` runs every kernel's plain version."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    cache: dict = {}
    B = x.shape[0]
    if cfg.family == "ssm":
        K = cfg.rwkv_head_dim
        s0 = torch.zeros((B, cfg.d_model // K, K, K), dtype=torch.float32,
                         device=x.device)
        ts0 = torch.zeros((B, cfg.d_model), dtype=x.dtype, device=x.device)
        y, ts_tm, s1 = rwkv.time_mix(cfg, p, h, ts0, s0, impl)
        x = _residual(x + y)
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        y2, ts_cm = rwkv.channel_mix(cfg, p, h2, ts0)
        if want_cache:
            dt = torch_dtype(cfg.dtype)
            cache = {"wkv": s1, "ts_tm": ts_tm.to(dt), "ts_cm": ts_cm.to(dt)}
        return _residual(x + y2), cache, None
    if want_cache:
        ya, (kc, vc) = attn.prefill_attention(cfg, p, h, positions, impl,
                                              rope)
        cache = {"k": kc, "v": vc}
    else:
        ya = attn.full_attention(cfg, p, h, positions, impl, rope)
    if cfg.family == "hybrid":
        h0 = torch.zeros((B, cfg.d_model, cfg.ssm_state),
                         dtype=torch.float32, device=x.device)
        ym, h1 = mamba.mamba_mix(cfg, p, h, h0, impl)
        if is_dtensor(ya) and ya.placements != ym.placements:
            # over the 512-rank mesh DTensor leaves the two branches'
            # partial sums on different mesh dims, which it cannot add
            ya, ym = _residual(ya), _residual(ym)
        x = _residual(x + 0.5 * (ya + ym))
        if want_cache:
            cache["ssm"] = h1
    else:
        x = _residual(x + ya)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    y2, aux = _ffn(cfg, p, h2)
    return _residual(x + y2), cache, aux


def block_decode(cfg: ModelConfig, p: dict, x, pos, cache: dict,
                 consts=None):
    """One-token block. x (B,1,d); cache entries are per-layer slices,
    every one written in place (the KV rows at their slots, the
    recurrent states whole); ``consts`` the step's
    ``attn.DecodeConsts``."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.family == "ssm":
        y, ts_tm, s1 = rwkv.time_mix_step(cfg, p, h, cache["ts_tm"],
                                          cache["wkv"])
        x = _residual(x + y)
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        y2, ts_cm = rwkv.channel_mix(cfg, p, h2, cache["ts_cm"])
        cache["wkv"].copy_(s1)
        cache["ts_tm"].copy_(ts_tm)
        cache["ts_cm"].copy_(ts_cm)
        return _residual(x + y2), cache
    ya, _, _ = attn.decode_attention(cfg, p, h, pos, cache["k"], cache["v"],
                                     consts)
    if cfg.family == "hybrid":
        ym, h1 = mamba.mamba_step(cfg, p, h, cache["ssm"])
        cache["ssm"].copy_(h1)
        x = _residual(x + 0.5 * (ya + ym))
    else:
        x = _residual(x + ya)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return _residual(x + _ffn(cfg, p, h2)[0]), cache


def _slice_layer(tree: dict, i: int) -> dict:
    return {k: v[i] for k, v in tree.items()}


# "dots": the matmul outputs are kept and the rest recomputed, as
# ``jax.checkpoint_policies.dots_saveable`` keeps every dot_general's
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    return (ckpt_mod.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt_mod.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: str):
    """``fn`` rematerialized in the backward (``torch.utils.checkpoint``,
    non-reentrant): ``"full"`` keeps only its inputs, ``"dots"`` also
    its matmul outputs. The recompute runs under the forward's sharding
    binding (``carry_binding``)."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r} "
                         f"({', '.join(REMAT_POLICIES)})")
    context_fn = ckpt_mod.noop_context_fn if policy == "full" else \
        functools.partial(ckpt_mod.create_selective_checkpoint_contexts,
                          _dots_saveable)

    def run(*args):
        return ckpt_mod.checkpoint(carry_binding(fn), *args,
                                   use_reentrant=False, context_fn=context_fn)
    return run


def _layers(blocks: dict, num_layers: int) -> list:
    """Each layer's parameters, from one ``unbind`` a stacked parameter:
    the same views ``v[i]`` gives, but under autograd its backward is one
    ``stack`` instead of a zero-filled stacked gradient a layer."""
    parts = {k: torch.unbind(v) for k, v in blocks.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(num_layers)]


def run_blocks_full(cfg: ModelConfig, blocks: dict, x, positions,
                    want_cache: bool, impl=None, remat: bool = False,
                    remat_policy: str = "full"):
    """Every layer in turn; returns (x, cache, aux), aux summed over the
    layers from an fp32 zero, as the reference's scan carries it. The
    layers come from one ``unbind`` (``_layers``); with ``remat`` each
    block is rematerialized under ``remat_policy``."""
    rope = attn.rope_for(cfg, positions)
    caches = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def fn(pl, xc):
        return block_full(cfg, pl, xc, positions, want_cache, impl, rope)
    if remat:
        fn = _remat(fn, remat_policy)
    for pl in _layers(blocks, cfg.num_layers):
        x, c, a = fn(pl, x)
        caches.append(c)
        if a is not None:
            aux = aux + a
    if not want_cache:
        return x, {}, aux
    return x, {k: torch.stack([c[k] for c in caches]) for k in caches[0]}, \
        aux


def run_blocks_decode(cfg: ModelConfig, blocks: dict, x, pos, cache: dict):
    """Every layer against its slice of ``cache``, which is updated in
    place; returns (x, cache). The step's attention invariants are built
    once, for every layer, where the family has attention."""
    consts = attn.decode_consts(cfg, pos, cache["k"].shape[2]) \
        if "k" in cache else None
    for i in range(cfg.num_layers):
        x, _ = block_decode(cfg, _slice_layer(blocks, i), x, pos,
                            _slice_layer(cache, i), consts)
    return x, cache


# ---------------------------------------------------------------------------
# Model entry points
# ---------------------------------------------------------------------------

def logits_head(cfg: ModelConfig, glob: dict, x):
    x = rms_norm(x, glob["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ glob["embed"].T
    else:
        logits = x @ glob["lm_head"]
    return shard(logits, "batch", None, "vocab")


def forward_full(cfg: ModelConfig, params: dict, inputs,
                 want_cache: bool = False, impl=None, remat: bool = False,
                 remat_policy: str = "full"):
    """Prefill or training forward from zero recurrent states. inputs:
    (B,S) int tokens, or a vlm or audio config's (B,S,d) embeddings (the
    frontend stub's output), on every route; on the training route
    (``impl="autograd"``) with ``remat`` and ``remat_policy`` (``"full"``
    or ``"dots"``) as ``run_blocks_full`` takes them. Returns
    (logits (B,S,V), cache, aux), the cache stacked by layer
    (``cache_specs``' keys; K/V (L,B,S',Hkv,D) with S' = min(S, W) in a
    sliding window) when ``want_cache``, aux the MoE load-balance loss
    summed over the layers (an fp32 zero without experts).
    ``impl="ref"`` runs every kernel (attention, ``ssm_scan``, ``wkv6``) on
    its plain version: a check of the kernels inside the model, which the
    engine never asks for."""
    check_ported(cfg)
    glob, blocks = split_params(params)
    x = embed_inputs(cfg, glob, inputs)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    x, cache, aux = run_blocks_full(cfg, blocks, x, positions, want_cache,
                                    impl, remat, remat_policy)
    return logits_head(cfg, glob, x), cache, aux


def forward_decode(cfg: ModelConfig, params: dict, inputs, pos, cache: dict):
    """One-token decode. inputs (B,1) tokens or (B,1,d) embeddings; pos
    (B,) int32, each lane's position (below the KV cache's rows, unless it
    is a sliding window's ring). Returns (logits (B,1,V), cache), the cache
    updated in place."""
    check_ported(cfg)
    glob, blocks = split_params(params)
    x = embed_inputs(cfg, glob, inputs)
    x, cache = run_blocks_decode(cfg, blocks, x, pos, cache)
    return logits_head(cfg, glob, x), cache


# ---------------------------------------------------------------------------
# Paged KV (the paged serving engine)
# ---------------------------------------------------------------------------

def _check_paged_family(cfg: ModelConfig) -> None:
    if cfg.family in ("ssm", "hybrid") or cfg.attention != "full":
        raise NotImplementedError(
            f"paged KV decode supports full-attention transformer families "
            f"only (got family={cfg.family}, attention={cfg.attention}); "
            f"recurrent/sliding state does not page")


def block_decode_paged(cfg: ModelConfig, p: dict, x, pos, pool_k, pool_v,
                       tables, consts=None):
    """One-token block against a paged KV pool layer slice, written in
    place. Identical math to ``block_decode`` around the attention call —
    greedy bit-identity with the dense engine hinges on this."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    ya, _, _ = attn.decode_attention_paged(cfg, p, h, pos, pool_k, pool_v,
                                           tables, consts)
    x = x + ya
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn(cfg, p, h2)[0], pool_k, pool_v


def forward_decode_paged(cfg: ModelConfig, params: dict, inputs, pos,
                         pool_k, pool_v, tables):
    """One-token decode addressing a paged KV pool through block tables.

    inputs (B,1) tokens or (B,1,d) embeddings; pos (B,) int32; pool_k/v
    (L, num_blocks+1, block_size, Hkv, D), each layer's slice written in
    place; tables
    (lanes, W) int32, lanes >= B, the rows past B null lanes. Those lanes
    join the step as pad lanes (a zero hidden state at position 0, their
    K/V written to the null block), so that every op of every layer runs
    at ``lanes`` rows: the engine passes tables of its dense counterpart's
    shape (max_batch lanes), and on an H100 several of a layer's ops
    round by their row count (the attention scores' batched GEMM, the
    RMSNorm's mean, the MoE router's fp32 GEMM), so only that shape gives
    each live lane the dense step's bits. What every layer shares
    (the write index, mask, gather indices and RoPE) is built once, before
    the layers. Returns (logits (B,1,V), pool_k, pool_v)."""
    _check_paged_family(cfg)
    check_ported(cfg)
    glob, blocks = split_params(params)
    x = embed_inputs(cfg, glob, inputs)
    B, lanes = x.shape[0], tables.shape[0]
    if lanes > B:
        x = torch.cat([x, x.new_zeros((lanes - B,) + tuple(x.shape[1:]))])
        pos = torch.cat([pos, pos.new_zeros(lanes - B)])
    consts = attn.paged_decode_consts(cfg, pos, tables, pool_k.shape[2])
    for i in range(cfg.num_layers):
        x, _, _ = block_decode_paged(cfg, _slice_layer(blocks, i), x, pos,
                                     pool_k[i], pool_v[i], tables, consts)
    return logits_head(cfg, glob, x)[:B], pool_k, pool_v


def scatter_prefill_cache(pool_k, pool_v, cache_k, cache_v, tables):
    """Write a dense prefill cache (L, B, S, Hkv, D) into the paged pool in
    place through block tables (B, W), W * block_size >= S. Pad lanes
    (tables all null) land their rows in the null block. Returns (pool_k,
    pool_v)."""
    L, B, S, Hkv, D = cache_k.shape
    bs = pool_k.shape[2]
    W = tables.shape[1]
    tpos = torch.arange(S, device=pool_k.device)[None, :]      # (1, S)
    blk = torch.gather(tables.long(), 1, torch.remainder(
        torch.div(tpos, bs, rounding_mode="floor"), W).expand(B, S))
    off = torch.remainder(tpos, bs).expand(B, S)
    pool_k[:, blk, off] = cache_k.to(pool_k.dtype)
    pool_v[:, blk, off] = cache_v.to(pool_v.dtype)
    return pool_k, pool_v
