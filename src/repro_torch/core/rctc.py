"""RCTC — the offline toolchain (forward translation / data packaging).

The port's counterpart of ``repro.core.rctc`` for the per-layer LM lowering
of the dense, hybrid and ssm families: every attention, projection, norm and
residual of the layer stack becomes its own RCB op — ``Op.ATTENTION``,
``Op.SSM_SCAN`` and ``Op.WKV6`` dispatch through the kernel registry, the
glue (RMSNORM / ROPE / SILU_MUL / SCALE_SHIFT / GEMM / ADD / RESHAPE)
through the generic vtable, and the Mamba branch's projections and the
RWKV-6 token-shift mixes run as ``GRAPH_EXEC`` artifacts (plain torch
callables) — and the weights flatten into a RIMFS image. From the same
parameters it emits the same program bytes and the same image bytes as the
JAX package. Other families (experts, vision, audio) raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import opt as opt_mod
from repro_torch.core import rimfs as rimfs_mod
from repro_torch.core.rcb import Op, RCB, RCBOp, RCBProgram, TensorDesc
from repro_torch.dtypes import name_of, torch_dtype
from repro_torch.models import mamba, rwkv6


class _Builder:
    """Incremental RCB program builder."""

    def __init__(self, name: str):
        self.name = name
        self.tensors: dict[str, TensorDesc] = {}
        self.blocks: list[RCB] = []
        self._ops: list[RCBOp] = []
        self._bid = 0
        self._uniq = 0

    def tensor(self, name, shape, dtype, kind, axes=()):
        self.tensors[name] = TensorDesc(name, tuple(shape), dtype, kind,
                                        tuple(axes))
        return name

    def scratch(self, shape, dtype, hint="t"):
        self._uniq += 1
        return self.tensor(f"{hint}.{self._uniq}", shape, dtype, "scratch")

    def emit(self, op: Op, dsts=(), srcs=(), **attrs):
        self._ops.append(RCBOp(op, tuple(dsts), tuple(srcs), attrs))

    def close_block(self, block_type="layer", deps="prev"):
        if not self._ops:
            return
        if deps == "prev":
            deps = (self._bid - 1,) if self._bid > 0 else ()
        self.blocks.append(RCB(self._bid, block_type, tuple(deps),
                               tuple(self._ops)))
        self._bid += 1
        self._ops = []

    def build(self, artifacts: Optional[dict] = None) -> RCBProgram:
        self.close_block()
        prog = RCBProgram(self.name, self.tensors, self.blocks,
                          artifacts or {})
        prog.validate()
        return prog


def _ssm_pre_artifact(cfg, keys):
    def fn(h, *ws):
        return mamba.ssm_kernel_inputs(cfg, dict(zip(keys, ws)), h)
    return fn


def _ssm_post_artifact(cfg, keys, x_dtype):
    def fn(y, u, z, *ws):
        return mamba.ssm_output(cfg, dict(zip(keys, ws)), y, u, z, x_dtype)
    return fn


def _rwkv_pre_artifact(cfg, keys):
    def fn(h, *ws):
        ts0 = torch.zeros((h.shape[0], h.shape[2]), dtype=h.dtype,
                          device=h.device)
        return rwkv6.time_mix_pre(cfg, dict(zip(keys, ws)), h, ts0)
    return fn


def _rwkv_post_artifact(cfg, keys, x_dtype):
    def fn(y, g, *ws):
        return rwkv6.time_mix_post(cfg, dict(zip(keys, ws)), y, g, x_dtype)
    return fn


def _rwkv_cm_artifact(cfg, keys):
    def fn(h, *ws):
        ts0 = torch.zeros((h.shape[0], h.shape[2]), dtype=h.dtype,
                          device=h.device)
        return rwkv6.channel_mix(cfg, dict(zip(keys, ws)), h, ts0)[0]
    return fn


def compile_transformer_block(cfg, params: dict, batch: int, seq_len: int,
                              optimize: bool = True):
    """Translate an LM's layer stack into a per-layer RCB program.

    ``params``: stacked model params (models/transformer.model_specs layout,
    leading num_layers dim on block entries) as torch tensors on any
    device. Inputs: ``hidden`` (B,S,d) pre-embedded states and, with RoPE
    outside the ssm family, ``positions`` (B,S) int32. Output: ``logits``
    (B,S,V). Returns (RCBProgram, RIMFS image bytes); the glue artifacts
    ride on the program under the JAX package's ids (hybrid:
    ``L{li}.ssm_pre``, ``L{li}.ssm_post``; ssm: ``L{li}.tm_pre``,
    ``L{li}.tm_post``, ``L{li}.cm``)."""
    from repro_torch.models.transformer import check_ported, split_params

    check_ported(cfg)
    if cfg.attention == "sliding" and seq_len > cfg.sliding_window:
        raise NotImplementedError(
            f"Op.ATTENTION lowers full causal attention; sliding window "
            f"{cfg.sliding_window} < seq_len {seq_len} would diverge")

    B, S, d, V = batch, seq_len, cfg.d_model, cfg.vocab_size
    dt = cfg.dtype
    eps = float(cfg.norm_eps)
    b = _Builder(f"lm_blocks_{cfg.name}")
    files: dict[str, torch.Tensor] = {}
    artifacts: dict = {}

    def weight(name, t: torch.Tensor):
        t = t.detach().cpu().contiguous()
        files[name] = t
        b.tensor(name, t.shape, name_of(t.dtype), "weight")
        return name

    def layer_weights(li, pl, keys):
        return [weight(f"L{li}.{k}", pl[k]) for k in keys]

    glob, blocks = split_params(params)
    layers = [{k: v[li] for k, v in blocks.items()}
              for li in range(cfg.num_layers)]

    b.tensor("hidden", (B, S, d), dt, "input", ("batch", None, None))
    if cfg.family != "ssm" and cfg.use_rope:
        b.tensor("positions", (B, S), "int32", "input", ("batch", None))

    def emit_rmsnorm(x, wname, warr):
        w = weight(wname, warr)
        t = b.scratch((B, S, d), dt, "ln")
        b.emit(Op.RMSNORM, [t], [x, w], eps=eps)
        return t

    def emit_add(a, c, shape=None):
        t = b.scratch(shape or (B, S, d), dt)
        b.emit(Op.ADD, [t], [a, c])
        return t

    def emit_attention(x_h, li, pl):
        H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

        def proj(tag, nh, norm_key):
            w = weight(f"L{li}.w{tag}", pl[f"w{tag}"].reshape(d, nh * D))
            t = b.scratch((B, S, nh * D), dt, tag)
            b.emit(Op.GEMM, [t], [x_h, w])
            if cfg.qkv_bias and f"b{tag}" in pl:
                bias = weight(f"L{li}.b{tag}", pl[f"b{tag}"].reshape(nh * D))
                t = emit_add(t, bias, (B, S, nh * D))
            t4 = b.scratch((B, S, nh, D), dt)
            b.emit(Op.RESHAPE, [t4], [t], shape=[B, S, nh, D])
            if cfg.qk_norm and norm_key:
                nw = weight(f"L{li}.{norm_key}", pl[norm_key])
                t5 = b.scratch((B, S, nh, D), dt)
                b.emit(Op.RMSNORM, [t5], [t4, nw], eps=eps)
                t4 = t5
            if cfg.use_rope and tag != "v":
                t6 = b.scratch((B, S, nh, D), dt)
                b.emit(Op.ROPE, [t6], [t4, "positions"],
                       theta=float(cfg.rope_theta))
                t4 = t6
            return t4

        q = proj("q", H, "q_norm")
        k = proj("k", Hkv, "k_norm")
        v = proj("v", Hkv, None)
        att = b.scratch((B, S, H, D), dt, "att")
        b.emit(Op.ATTENTION, [att], [q, k, v], causal=True)
        af = b.scratch((B, S, H * D), dt)
        b.emit(Op.RESHAPE, [af], [att], shape=[B, S, H * D])
        wo = weight(f"L{li}.wo", pl["wo"].reshape(H * D, d))
        ao = b.scratch((B, S, d), dt)
        b.emit(Op.GEMM, [ao], [af, wo])
        return ao

    def emit_swiglu(h2, li, pl):
        f = cfg.d_ff
        wg = weight(f"L{li}.mlp_gate", pl["mlp_wi_gate"])
        wu = weight(f"L{li}.mlp_up", pl["mlp_wi_up"])
        wo = weight(f"L{li}.mlp_out", pl["mlp_wo"])
        g = b.scratch((B, S, f), dt, "ffg")
        b.emit(Op.GEMM, [g], [h2, wg])
        u = b.scratch((B, S, f), dt, "ffu")
        b.emit(Op.GEMM, [u], [h2, wu])
        m = b.scratch((B, S, f), dt)
        b.emit(Op.SILU_MUL, [m], [g, u])
        o = b.scratch((B, S, d), dt)
        b.emit(Op.GEMM, [o], [m, wo])
        return o

    def emit_mamba(h, li, pl):
        di, N = cfg.d_model, cfg.ssm_state
        pre_keys = ["m_in", "m_x", "m_dt", "m_dt_b", "m_alog"]
        srcs = [h] + layer_weights(li, pl, pre_keys)
        da = b.scratch((B, S, di, N), "float32", "da")
        bx = b.scratch((B, S, di, N), "float32", "bx")
        c = b.scratch((B, S, N), "float32", "ssc")
        u = b.scratch((B, S, di), "float32", "ssu")
        z = b.scratch((B, S, di), dt, "ssz")
        name = f"L{li}.ssm_pre"
        artifacts[name] = _ssm_pre_artifact(cfg, pre_keys)
        b.emit(Op.GRAPH_EXEC, [da, bx, c, u, z], srcs, artifact=name)
        ys = b.scratch((B, S, di), "float32", "ssy")
        b.emit(Op.SSM_SCAN, [ys], [da, bx, c])
        post_keys = ["m_d", "m_out"]
        srcs2 = [ys, u, z] + layer_weights(li, pl, post_keys)
        ym = b.scratch((B, S, d), dt, "ssm")
        name2 = f"L{li}.ssm_post"
        artifacts[name2] = _ssm_post_artifact(cfg, post_keys,
                                              torch_dtype(dt))
        b.emit(Op.GRAPH_EXEC, [ym], srcs2, artifact=name2)
        return ym

    def emit_rwkv_layer(x, li, pl):
        K = cfg.rwkv_head_dim
        H = d // K
        h = emit_rmsnorm(x, f"L{li}.ln1", pl["ln1"])
        pre_keys = ["tm_mix", "tm_wr", "tm_wk", "tm_wv", "tm_wg",
                    "tm_w0", "tm_wa", "tm_wb"]
        srcs = [h] + layer_weights(li, pl, pre_keys)
        r = b.scratch((B, S, H, K), "float32", "wr")
        k = b.scratch((B, S, H, K), "float32", "wk")
        v = b.scratch((B, S, H, K), "float32", "wv")
        lw = b.scratch((B, S, H, K), "float32", "wlw")
        g = b.scratch((B, S, d), dt, "wg")
        name = f"L{li}.tm_pre"
        artifacts[name] = _rwkv_pre_artifact(cfg, pre_keys)
        b.emit(Op.GRAPH_EXEC, [r, k, v, lw, g], srcs, artifact=name)
        uw = weight(f"L{li}.tm_u", pl["tm_u"].float())
        y = b.scratch((B, S, H, K), "float32", "wy")
        b.emit(Op.WKV6, [y], [r, k, v, lw, uw])
        post_keys = ["tm_ln_w", "tm_ln_b", "tm_wo"]
        srcs2 = [y, g] + layer_weights(li, pl, post_keys)
        to = b.scratch((B, S, d), dt, "tm")
        name2 = f"L{li}.tm_post"
        artifacts[name2] = _rwkv_post_artifact(cfg, post_keys,
                                               torch_dtype(dt))
        b.emit(Op.GRAPH_EXEC, [to], srcs2, artifact=name2)
        x = emit_add(x, to)
        h2 = emit_rmsnorm(x, f"L{li}.ln2", pl["ln2"])
        cm_keys = ["cm_mix", "cm_wk", "cm_wv", "cm_wr"]
        srcs3 = [h2] + layer_weights(li, pl, cm_keys)
        y2 = b.scratch((B, S, d), dt, "cm")
        name3 = f"L{li}.cm"
        artifacts[name3] = _rwkv_cm_artifact(cfg, cm_keys)
        b.emit(Op.GRAPH_EXEC, [y2], srcs3, artifact=name3)
        return emit_add(x, y2)

    hybrid = cfg.family == "hybrid"
    if hybrid:
        half = weight("c.half", torch.full((1,), 0.5, dtype=torch_dtype(dt)))
        zero = weight("c.zero", torch.zeros((1,), dtype=torch_dtype(dt)))

    x = "hidden"
    for li, pl in enumerate(layers):
        if cfg.family == "ssm":
            x = emit_rwkv_layer(x, li, pl)
            b.close_block("layer")
            continue
        h = emit_rmsnorm(x, f"L{li}.ln1", pl["ln1"])
        ya = emit_attention(h, li, pl)
        if hybrid:
            s1 = emit_add(ya, emit_mamba(h, li, pl))
            s2 = b.scratch((B, S, d), dt)
            b.emit(Op.SCALE_SHIFT, [s2], [s1, half, zero])
            x = emit_add(x, s2)
        else:
            x = emit_add(x, ya)
        h2 = emit_rmsnorm(x, f"L{li}.ln2", pl["ln2"])
        x = emit_add(x, emit_swiglu(h2, li, pl))
        b.close_block("layer")

    xf = emit_rmsnorm(x, "final_norm", glob["final_norm"])
    b.tensor("logits", (B, S, V), dt, "output", ("batch", None, "vocab"))
    if cfg.tie_embeddings:
        ew = weight("embed", glob["embed"])                 # (V, d)
        b.emit(Op.GEMM, ["logits"], [xf, ew], tb=True)
    else:
        lw_ = weight("lm_head", glob["lm_head"])            # (d, V)
        b.emit(Op.GEMM, ["logits"], [xf, lw_])
    b.emit(Op.FENCE)
    b.close_block("head")

    prog = b.build(artifacts)
    if optimize:
        prog = opt_mod.optimize(prog)
    image = rimfs_mod.pack(files)
    return prog, image
