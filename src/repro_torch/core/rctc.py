"""RCTC — the offline toolchain (forward translation / data packaging).

The port's counterpart of ``repro.core.rctc``: the paper's Conv2D -> ReLU ->
Softmax pipeline (``compile_conv_relu_softmax``), ResNet-18 in fp32 and INT8
(``compile_resnet18``: one op per conv / folded BN / relu / residual add /
pool, the INT8 variant quantizing around every conv), and the per-layer LM
lowering of every LM family (dense, vlm and audio on pre-embedded
input, moe, hybrid and ssm): every attention, projection, norm and
residual of the layer stack becomes its own RCB op — ``Op.ATTENTION``,
``Op.SSM_SCAN`` and ``Op.WKV6`` dispatch through the kernel registry, the
glue (RMSNORM / ROPE / SILU_MUL / SCALE_SHIFT / GEMM / ADD / RESHAPE)
through the generic vtable, and the Mamba branch's projections, the
RWKV-6 token-shift mixes and the expert FFN run as ``GRAPH_EXEC``
artifacts (plain torch callables) — and the weights flatten into a RIMFS
image; and the LM serving engines' service programs
(``compile_lm_service``, ``compile_paged_lm_service``). From the same
parameters it emits the same program bytes and the same image bytes as the
JAX package. The microbenchmark programs (pass-through,
transfer chains, GEMM, the DMA pipelines and the GEMM chain the partition
tests cut) come out byte-identical too.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.resnet18 import ResNetConfig
from repro_torch.core import opt as opt_mod
from repro_torch.core import rimfs as rimfs_mod
from repro_torch.core.rcb import Op, RCB, RCBOp, RCBProgram, TensorDesc
from repro_torch.dtypes import as_tensor, name_of, torch_dtype
from repro_torch.models import mamba, mlp, rwkv6


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


def _host(arr) -> torch.Tensor:
    """A weight (torch tensor on any device, or numpy array) as a contiguous
    CPU tensor for the RIMFS image."""
    return as_tensor(arr, torch.device("cpu")).detach().contiguous()


# ---------------------------------------------------------------------------
# Microbenchmark programs (paper §3.4: pass-through and 64x64 matmul)
# ---------------------------------------------------------------------------

def compile_passthrough(shape, dtype="float32") -> RCBProgram:
    b = _Builder("passthrough")
    b.tensor("input", shape, dtype, "input")
    b.tensor("output", shape, dtype, "output")
    b.emit(Op.PASSTHROUGH, ["output"], ["input"])
    b.emit(Op.FENCE)
    return b.build()


def compile_transfer_chain(n: int, block_shape, dtype="float32") -> RCBProgram:
    """n independent block transfers flattened into ONE control stream:
    the per-transfer control cost is paid once for the whole stream."""
    b = _Builder(f"chain_{n}")
    for i in range(n):
        b.tensor(f"in{i}", block_shape, dtype, "input")
        b.tensor(f"out{i}", block_shape, dtype, "output")
        b.emit(Op.PASSTHROUGH, [f"out{i}"], [f"in{i}"])
    b.emit(Op.FENCE)
    return b.build()


def compile_matmul(n=64, dtype="float32", with_dma: bool = False) -> RCBProgram:
    """An n x n GEMM; ``with_dma`` adds explicit input and output DMA
    stages around it."""
    b = _Builder(f"xgemm_{n}")
    b.tensor("a", (n, n), dtype, "input")
    b.tensor("b", (n, n), dtype, "weight")
    b.tensor("output", (n, n), dtype, "output")
    if with_dma:
        ad = b.scratch((n, n), dtype, "a_dev")
        b.emit(Op.DMA_H2D, [ad], ["a"])
        od = b.scratch((n, n), dtype, "o_dev")
        b.emit(Op.GEMM, [od], [ad, "b"])
        b.emit(Op.DMA_D2H, ["output"], [od])
    else:
        b.emit(Op.GEMM, ["output"], ["a", "b"])
    b.emit(Op.FENCE)
    return b.build()


def compile_dma_pipeline(n_stages: int, n: int = 64, dtype="float32",
                         with_dma: bool = True) -> RCBProgram:
    """``n_stages`` independent H2D -> GEMM -> D2H stages in one control
    stream, one block a stage; ``with_dma=False`` emits the same compute
    without the transfers."""
    b = _Builder(f"dma_pipeline_{n_stages}" + ("" if with_dma else "_nodma"))
    b.tensor("b", (n, n), dtype, "weight")
    for i in range(n_stages):
        b.tensor(f"in{i}", (n, n), dtype, "input")
        b.tensor(f"out{i}", (n, n), dtype, "output")
        if with_dma:
            dev = b.scratch((n, n), dtype, f"dev{i}")
            b.emit(Op.DMA_H2D, [dev], [f"in{i}"])
            acc = b.scratch((n, n), dtype, f"acc{i}")
            b.emit(Op.GEMM, [acc], [dev, "b"])
            b.emit(Op.DMA_D2H, [f"out{i}"], [acc])
        else:
            b.emit(Op.GEMM, [f"out{i}"], [f"in{i}", "b"])
        b.close_block("transfer")      # one block a stage: the partition
    b.emit(Op.FENCE)                   # cuts at this granularity
    return b.build()


def compile_transfer_pipeline(n_blocks: int, floats: int,
                              dtype="float32") -> RCBProgram:
    """``n_blocks`` independent H2D -> D2H block transfers (no compute),
    one block a transfer."""
    b = _Builder(f"transfer_pipeline_{n_blocks}")
    for i in range(n_blocks):
        b.tensor(f"in{i}", (floats,), dtype, "input")
        b.tensor(f"out{i}", (floats,), dtype, "output")
        dev = b.scratch((floats,), dtype, f"dev{i}")
        b.emit(Op.DMA_H2D, [dev], [f"in{i}"])
        b.emit(Op.DMA_D2H, [f"out{i}"], [dev])
        b.close_block("transfer")
    b.emit(Op.FENCE)
    return b.build()


def compile_gemm_chain(depth: int, n: int = 32,
                       dtype="float32") -> RCBProgram:
    """``depth`` chained GEMM -> RELU layers, one RCB block a layer: every
    block boundary the partition pass cuts at becomes a cut edge."""
    b = _Builder(f"gemm_chain_{depth}")
    b.tensor("input", (n, n), dtype, "input")
    x = "input"
    for i in range(depth):
        w = b.tensor(f"w{i}", (n, n), dtype, "weight")
        t = b.scratch((n, n), dtype, f"g{i}")
        b.emit(Op.GEMM, [t], [x, w])
        r = b.scratch((n, n), dtype, f"r{i}")
        b.emit(Op.RELU, [r], [t])
        x = r
        b.close_block()
    b.tensor("output", (n, n), dtype, "output")
    b.emit(Op.PASSTHROUGH, ["output"], [x])
    b.emit(Op.FENCE)
    return b.build()


def gemm_chain_weights(depth: int, n: int = 32, seed: int = 0) -> dict:
    """Weight files for ``compile_gemm_chain`` (scaled by 1/sqrt(n) to keep
    activations in range), the same numbers as the JAX package's."""
    rng = np.random.RandomState(seed)
    return {f"w{i}": (rng.randn(n, n) / np.sqrt(n)).astype(np.float32)
            for i in range(depth)}


def compile_conv_relu_softmax(n=1, h=8, w=8, cin=3, cout=9) -> RCBProgram:
    """The paper's data-path correctness pipeline (Conv2D->ReLU->Softmax)."""
    b = _Builder("conv_relu_softmax")
    b.tensor("input", (n, h, w, cin), "float32", "input")
    b.tensor("w_conv", (3, 3, cin, cout), "float32", "weight")
    t1 = b.scratch((n, h, w, cout), "float32")
    b.emit(Op.CONV2D, [t1], ["input", "w_conv"], stride=(1, 1),
           padding="SAME")
    t2 = b.scratch((n, h, w, cout), "float32")
    b.emit(Op.RELU, [t2], [t1])
    t3 = b.scratch((n, cout), "float32")
    b.emit(Op.AVGPOOL_GLOBAL, [t3], [t2])
    b.tensor("output", (n, cout), "float32", "output")
    b.emit(Op.SOFTMAX, ["output"], [t3])
    return b.build()


# ---------------------------------------------------------------------------
# ResNet-18 forward translation (fp32 and INT8)
# ---------------------------------------------------------------------------

def _emit_conv_bn_relu(b: _Builder, x, wname, scale, shift, out_shape,
                       stride, relu=True, int8: Optional[dict] = None,
                       x_scale: float = 1.0):
    """One conv+foldedBN(+relu) stage; int8 mode quantizes around the conv."""
    if int8 is None:
        t = b.scratch(out_shape, "float32")
        b.emit(Op.CONV2D, [t], [x, wname], stride=(stride, stride),
               padding="SAME")
    else:
        xq = b.scratch(b.tensors[x].shape, "int8")
        b.emit(Op.QUANTIZE, [xq], [x], scale=x_scale)
        ti = b.scratch(out_shape, "int32")
        b.emit(Op.CONV2D_I8, [ti], [xq, wname], stride=(stride, stride),
               padding="SAME")
        t = b.scratch(out_shape, "float32")
        # requant: int32 * (x_scale * w_scale_per_channel), then +shift
        b.emit(Op.SCALE_SHIFT, [t], [ti, int8["requant_scale"],
                                     int8["zero"]])
    t2 = b.scratch(out_shape, "float32")
    b.emit(Op.SCALE_SHIFT, [t2], [t, scale, shift])
    if not relu:
        return t2
    t3 = b.scratch(out_shape, "float32")
    b.emit(Op.RELU, [t3], [t2])
    return t3


def compile_resnet18(cfg: ResNetConfig, folded: dict, batch: int = 1,
                     int8: Optional[dict] = None, optimize: bool = True):
    """Translate ResNet-18 into (RCBProgram, RIMFS image bytes).

    ``folded``: BN-folded weights from models/resnet.fold_bn (torch tensors
    on any device, or the JAX package's numpy arrays). ``int8``: optional
    quantization pack from core/quant.quantize_resnet — {weights int8,
    requant scales, activation scales}. ``optimize``: run the core/opt.py
    peephole pass (bit-exact rules only) before emission. The same weights
    and pack give the JAX package's program and image bytes.
    """
    b = _Builder("resnet18_int8" if int8 else "resnet18")
    img = cfg.image_size
    files: dict[str, torch.Tensor] = {}

    def weight(name, arr):
        t = _host(arr)
        files[name] = t
        b.tensor(name, tuple(t.shape), name_of(t.dtype), "weight")
        return name

    def act_scale(name):
        return float(int8["act_scales"][name]) if int8 else 1.0

    wsrc = int8["weights"] if int8 else folded
    b.tensor("input", (batch, img, img, 3), "float32", "input")

    def conv_pack(prefix, key):
        w = weight(key, wsrc[key])
        scale = weight(key + ".bn_scale", folded[prefix + "_scale"])
        shift = weight(key + ".bn_shift", folded[prefix + "_shift"])
        pack = None
        if int8:
            rq = _host(int8["requant"][key])
            pack = {"requant_scale": weight(key + ".rq", rq),
                    "zero": weight(key + ".zero", torch.zeros_like(rq))}
        return w, scale, shift, pack

    # stem
    w, sc, sh, pk = conv_pack("stem_bn", "stem_conv")
    h = img // 2
    x = _emit_conv_bn_relu(b, "input", w, sc, sh, (batch, h, h,
                                                   cfg.stem_width), 2,
                           int8=pk, x_scale=act_scale("stem_conv"))
    b.close_block()
    if img >= 64:
        t = b.scratch((batch, h // 2, h // 2, cfg.stem_width), "float32")
        b.emit(Op.MAXPOOL, [t], [x], window=(3, 3), stride=(2, 2),
               padding="SAME")
        x = t
        h = h // 2
        b.close_block()

    cin = cfg.stem_width
    for si, (n_blocks, width) in enumerate(zip(cfg.stage_sizes,
                                               cfg.stage_widths)):
        for bi in range(n_blocks):
            pre = f"s{si}b{bi}_"
            stride = 2 if (bi == 0 and si > 0) else 1
            h_out = h // stride
            shp = (batch, h_out, h_out, width)
            res = x
            w1, sc1, sh1, pk1 = conv_pack(pre + "bn1", pre + "conv1")
            y = _emit_conv_bn_relu(b, x, w1, sc1, sh1, shp, stride,
                                   int8=pk1, x_scale=act_scale(pre + "conv1"))
            w2, sc2, sh2, pk2 = conv_pack(pre + "bn2", pre + "conv2")
            y = _emit_conv_bn_relu(b, y, w2, sc2, sh2, shp, 1, relu=False,
                                   int8=pk2, x_scale=act_scale(pre + "conv2"))
            if (pre + "proj") in folded:
                wp, scp, shp_, pkp = conv_pack(pre + "proj_bn", pre + "proj")
                res = _emit_conv_bn_relu(b, x, wp, scp, shp_, shp, stride,
                                         relu=False, int8=pkp,
                                         x_scale=act_scale(pre + "proj"))
            t = b.scratch(shp, "float32")
            b.emit(Op.ADD, [t], [y, res])
            t2 = b.scratch(shp, "float32")
            b.emit(Op.RELU, [t2], [t])
            x = t2
            h = h_out
            cin = width
            b.close_block()

    t = b.scratch((batch, cin), "float32")
    b.emit(Op.AVGPOOL_GLOBAL, [t], [x])
    fw = weight("fc_w", folded["fc_w"])
    fb = weight("fc_b", folded["fc_b"])
    t2 = b.scratch((batch, cfg.num_classes), "float32")
    b.emit(Op.DENSE, [t2], [t, fw, fb])
    b.tensor("output", (batch, cfg.num_classes), "float32", "output")
    b.emit(Op.SOFTMAX, ["output"], [t2])
    b.emit(Op.FENCE)
    prog = b.build()
    if optimize:
        prog = opt_mod.optimize(prog)
    image = rimfs_mod.pack(files)
    return prog, image


# ---------------------------------------------------------------------------
# LM service translation (compiled-graph artifacts, the paper's ADF ingestion)
# ---------------------------------------------------------------------------

def compile_lm_service(cfg, batch: int, seq_len: int,
                       prefill_fn, decode_fn) -> RCBProgram:
    """Wrap the serving engine's prefill and decode steps ("compiled ADF
    graph artifacts") into an RCB service program: bind -> dispatch(prefill)
    -> poll -> dispatch(decode) -> sync. The steps ride as the ``prefill``
    and ``decode`` GRAPH_EXEC artifacts, outside the program's bytes, which
    equal the JAX package's for the same config, batch and length."""
    b = _Builder(f"lm_{cfg.name}")
    tok_shape = (batch, seq_len) if cfg.input_kind == "tokens" \
        else (batch, seq_len, cfg.d_model)
    b.tensor("params", (0,), "float32", "input")       # pytree passthrough
    b.tensor("tokens", tok_shape, "int32" if cfg.input_kind == "tokens"
             else cfg.dtype, "input", ("batch", None))
    b.tensor("cache", (0,), "float32", "scratch")
    b.tensor("first_logits", (batch, cfg.vocab_size), "float32", "output")
    b.emit(Op.GRAPH_EXEC, ["first_logits", "cache"], ["params", "tokens"],
           artifact="prefill")
    b.emit(Op.POLL, [], ["first_logits"])
    b.close_block("prefill")
    b.tensor("next_token", (batch, 1), "int32", "input", ("batch", None))
    b.tensor("pos", (batch,), "int32", "input", ("batch",))
    b.tensor("logits", (batch, cfg.vocab_size), "float32", "output")
    b.emit(Op.GRAPH_EXEC, ["logits", "cache"],
           ["params", "cache", "next_token", "pos"], artifact="decode")
    b.emit(Op.POLL, [], ["logits"])
    b.close_block("decode")
    return b.build({"prefill": prefill_fn, "decode": decode_fn})


def compile_paged_lm_service(cfg, batch: int, max_seq: int, block_size: int,
                             num_blocks: int, prefill_fn, decode_fn,
                             greedy: bool = True,
                             temperature: float = 1.0) -> RCBProgram:
    """The paged-KV LM service program: the KV pool is a scratch tensor
    with an explicit block axis (num_blocks + 1 rows, the last the null
    block), and both GRAPH_EXEC artifacts take the batch's int32 block
    table as a device input, addressing the pool inside the steps. The
    decode artifact samples on the device (greedy or temperature, baked
    into the program and so into its CRC) and returns the window's new
    tokens instead of logits.
    The bytes equal the JAX package's for the same arguments."""
    b = _Builder(f"lm_paged_{cfg.name}")
    bps = (max_seq + block_size - 1) // block_size    # table width bound
    pool_shape = (cfg.num_layers, num_blocks + 1, block_size,
                  cfg.num_kv_heads, cfg.head_dim)
    b.tensor("params", (0,), "float32", "input")      # pytree passthrough
    b.tensor("pool_k", pool_shape, cfg.dtype, "scratch")
    b.tensor("pool_v", pool_shape, cfg.dtype, "scratch")
    b.tensor("tables", (batch, bps), "int32", "input", ("batch", None))
    b.tensor("tokens", (batch, max_seq), "int32", "input", ("batch", None))
    b.tensor("first_logits", (batch, cfg.vocab_size), "float32", "output")
    b.emit(Op.GRAPH_EXEC, ["first_logits", "pool_k", "pool_v"],
           ["params", "pool_k", "pool_v", "tokens", "tables"],
           artifact="paged_prefill", block_size=block_size)
    b.emit(Op.POLL, [], ["first_logits"])
    b.close_block("prefill")
    b.tensor("next_token", (batch,), "int32", "input", ("batch",))
    b.tensor("pos", (batch,), "int32", "input", ("batch",))
    b.tensor("new_tokens", (batch, 1), "int32", "output", ("batch", None))
    b.emit(Op.GRAPH_EXEC, ["new_tokens", "pool_k", "pool_v"],
           ["params", "pool_k", "pool_v", "next_token", "pos", "tables"],
           artifact="paged_decode", block_size=block_size,
           greedy=bool(greedy), temperature=float(temperature))
    b.emit(Op.POLL, [], ["new_tokens"])
    b.close_block("decode")
    return b.build({"paged_prefill": prefill_fn, "paged_decode": decode_fn})


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


def _moe_artifact(cfg, keys):
    def fn(h, *ws):
        return mlp.moe_ffn(cfg, dict(zip(keys, ws)), h)[0]
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
    ``L{li}.tm_post``, ``L{li}.cm``; moe: ``L{li}.moe``, the whole
    expert FFN)."""
    from repro_torch.models.transformer import (check_ported, has_experts,
                                                split_params)

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
        t = _host(t)
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

    def emit_moe(h2, li, pl):
        keys = ["router", "we_gate", "we_up", "we_out"]
        if cfg.moe_dense_residual:
            keys += ["dense_wi_gate", "dense_wi_up", "dense_wo"]
        srcs = [h2] + layer_weights(li, pl, keys)
        y2 = b.scratch((B, S, d), dt, "moe")
        name = f"L{li}.moe"
        artifacts[name] = _moe_artifact(cfg, keys)
        b.emit(Op.GRAPH_EXEC, [y2], srcs, artifact=name)
        return y2

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
        ffn = emit_moe if has_experts(cfg) else emit_swiglu
        x = emit_add(x, ffn(h2, li, pl))
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
