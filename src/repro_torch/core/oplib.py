"""PyTorch semantics for every RCB compute op.

The port's counterpart of ``repro.core.oplib``: one function per opcode,
shared by the interpreted path (``dispatch_compute``) and the linked path
(``link_compute``), so the two are equivalent by construction. Buffers keep
the program's layouts (NHWC activations, HWIO conv weights); the vision ops
permute to torch's NCHW/OIHW at the op and back. ``lax``'s SAME padding
puts the odd pixel at the end, so it is applied explicitly (``F.pad``), not
through ``F.conv2d``'s symmetric ``padding=``. The integer ops are exact:
``GEMM_I8`` and ``CONV2D_I8`` (im2col on the int8 tensor) run the int32-out
INT8 GEMM kernel, and ``QUANTIZE``/``DEQUANT`` divide and multiply by a
float32 tensor, never a Python scalar (CUDA's division by a host scalar is a
multiplication by its reciprocal, which can round differently). An opcode
outside the table (the executor's own: DMA, GRAPH_EXEC, FENCE, ...) raises
``NotImplementedError`` naming it.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.rcb import Op
from repro_torch.models.common import apply_rope, rms_norm


def gemm(a, b, attrs):
    # jnp's ``.T`` reverses every axis, whatever the rank
    if attrs.get("ta", False):
        a = a.permute(*reversed(range(a.ndim)))
    if attrs.get("tb", False):
        b = b.permute(*reversed(range(b.ndim)))
    return torch.matmul(a, b)


def gemm_i8(a, b, attrs):
    from repro_torch.kernels import registry
    return registry.call("matmul_int8_i32", a, b)


def same_pads(size: int, window: int, stride: int) -> tuple:
    """``lax.padtype_to_pads`` for one spatial dim under SAME: the output
    is ceil(size / stride), and the odd pixel of padding goes at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pads(x_hw, win_hw, stride_hw, padding) -> list:
    """(lo, hi) per spatial dim for a SAME, VALID or explicit padding."""
    if padding == "SAME":
        return [same_pads(s, k, st) for s, k, st in zip(x_hw, win_hw,
                                                        stride_hw)]
    if padding == "VALID":
        return [(0, 0), (0, 0)]
    return [tuple(int(v) for v in p) for p in padding]


def _pad_nhwc(x, pads, value=0):
    (hlo, hhi), (wlo, whi) = pads
    if not (hlo or hhi or wlo or whi):
        return x
    # F.pad pads trailing dims first: (C), then W, then H
    return F.pad(x, (0, 0, wlo, whi, hlo, hhi), value=value)


def conv2d(x, w, attrs):
    """x: (N,H,W,C), w: (KH,KW,C,O) -> (N,OH,OW,O)."""
    stride = tuple(attrs.get("stride", (1, 1)))
    pads = _pads(x.shape[1:3], w.shape[:2], stride,
                 attrs.get("padding", "SAME"))
    xp = _pad_nhwc(x, pads).permute(0, 3, 1, 2)
    y = F.conv2d(xp, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()


def _im2col_nhwc(x, kh: int, kw: int, stride, pads):
    """(N,H,W,C) -> (N*OH*OW, KH*KW*C) patches in HWIO's (kh, kw, c) order,
    taken from a padded, strided view of ``x`` in its own dtype."""
    xp = _pad_nhwc(x, pads)
    p = xp.unfold(1, kh, stride[0]).unfold(2, kw, stride[1])
    n, oh, ow = p.shape[:3]                     # (N, OH, OW, C, KH, KW)
    return p.permute(0, 1, 2, 4, 5, 3).reshape(n * oh * ow, -1), (n, oh, ow)


def conv2d_i8(x, w, attrs):
    """int8 x (N,H,W,C), int8 w (KH,KW,C,O) -> exact int32 (N,OH,OW,O):
    im2col, then the INT8 GEMM kernel through the registry (its tuned
    plan, where the autotune cache holds one)."""
    from repro_torch.kernels import registry
    stride = tuple(attrs.get("stride", (1, 1)))
    kh, kw, c, o = w.shape
    pads = _pads(x.shape[1:3], (kh, kw), stride,
                 attrs.get("padding", "SAME"))
    cols, (n, oh, ow) = _im2col_nhwc(x, kh, kw, stride, pads)
    y = registry.call("matmul_int8_i32", cols, w.reshape(kh * kw * c, o))
    return y.reshape(n, oh, ow, o)


def dense(x, w, b=None, attrs=None):
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y


def add(a, b, attrs):
    return a + b


def relu(x, attrs=None):
    return torch.relu(x)


def softmax(x, attrs):
    return torch.softmax(x.float(), dim=attrs.get("axis", -1)).to(x.dtype)


def maxpool(x, attrs):
    """NHWC max over windows; SAME pads with -inf (an int dtype's min)."""
    win = tuple(attrs.get("window", (2, 2)))
    stride = tuple(attrs.get("stride", win))
    pads = _pads(x.shape[1:3], win, stride, attrs.get("padding", "VALID"))
    fill = (float("-inf") if x.dtype.is_floating_point
            else torch.iinfo(x.dtype).min)
    p = _pad_nhwc(x, pads, fill).unfold(1, win[0], stride[0]) \
        .unfold(2, win[1], stride[1])
    return p.amax(dim=(-2, -1))


def avgpool_global(x, attrs):
    return torch.mean(x, dim=(1, 2))


def scale_shift_relu(x, scale, shift, attrs=None):
    """Fused SCALE_SHIFT+RELU slot (core/opt.py rule F1): the same two
    torch ops, then the relu, so it is bit-identical to the pair."""
    return torch.relu(x * scale + shift)


def add_relu(a, b, attrs=None):
    """Fused ADD+RELU slot (core/opt.py rule F2)."""
    return torch.relu(a + b)


def f32_scalar(value, like: torch.Tensor) -> torch.Tensor:
    """A Python scale as a 0-d float32 tensor on ``like``'s device (filled
    there, no host copy): the same float32 rounding of the double as jnp's
    weak-typed scalar."""
    return torch.full((), float(value), dtype=torch.float32,
                      device=like.device)


def quantize(x, attrs):
    """round-half-to-even(x / scale), clipped to +-127, as int8."""
    q = torch.round(x / f32_scalar(attrs["scale"], x))
    return torch.clamp(q, -127, 127).to(torch.int8)


def dequantize(x, attrs):
    return x.float() * f32_scalar(attrs["scale"], x)


def reshape(x, attrs):
    return torch.reshape(x, tuple(attrs["shape"]))


def passthrough(x, attrs):
    return x


def rmsnorm(x, w, attrs):
    return rms_norm(x, w, eps=float((attrs or {}).get("eps", 1e-5)))


def rope(x, positions, attrs):
    return apply_rope(x, positions,
                      theta=float((attrs or {}).get("theta", 10000.0)))


def silu_mul(gate, x, attrs=None):
    return F.silu(gate) * x


def scale_shift(x, scale, shift, attrs=None):
    return x * scale + shift


# Kernel opcodes dispatch through the registry (kernels/registry.py), so the
# interpreted and linked paths share one implementation per kernel.
OP_KERNELS: dict[Op, str] = {
    Op.ATTENTION: "attention",
    Op.MATMUL_INT8: "matmul_int8",
    Op.SSM_SCAN: "ssm_scan",
    Op.WKV6: "wkv6",
}


def _kernel_fn(name: str) -> Callable:
    def fn(srcs, attrs):
        from repro_torch.kernels import registry
        return registry.call_op(name, srcs, attrs)
    return fn


_TABLE: dict[Op, Callable] = {
    Op.GEMM: lambda srcs, attrs: gemm(srcs[0], srcs[1], attrs),
    Op.GEMM_I8: lambda srcs, attrs: gemm_i8(srcs[0], srcs[1], attrs),
    Op.CONV2D: lambda srcs, attrs: conv2d(srcs[0], srcs[1], attrs),
    Op.CONV2D_I8: lambda srcs, attrs: conv2d_i8(srcs[0], srcs[1], attrs),
    Op.DENSE: lambda srcs, attrs: dense(*srcs, attrs=attrs),
    Op.ADD: lambda srcs, attrs: add(srcs[0], srcs[1], attrs),
    Op.RELU: lambda srcs, attrs: relu(srcs[0], attrs),
    Op.SOFTMAX: lambda srcs, attrs: softmax(srcs[0], attrs),
    Op.MAXPOOL: lambda srcs, attrs: maxpool(srcs[0], attrs),
    Op.AVGPOOL_GLOBAL: lambda srcs, attrs: avgpool_global(srcs[0], attrs),
    Op.SCALE_SHIFT_RELU: lambda srcs, attrs: scale_shift_relu(*srcs,
                                                              attrs=attrs),
    Op.ADD_RELU: lambda srcs, attrs: add_relu(srcs[0], srcs[1], attrs),
    Op.QUANTIZE: lambda srcs, attrs: quantize(srcs[0], attrs),
    Op.DEQUANT: lambda srcs, attrs: dequantize(srcs[0], attrs),
    Op.RESHAPE: lambda srcs, attrs: reshape(srcs[0], attrs),
    Op.PASSTHROUGH: lambda srcs, attrs: passthrough(srcs[0], attrs),
    Op.RMSNORM: lambda srcs, attrs: rmsnorm(srcs[0], srcs[1], attrs),
    Op.ROPE: lambda srcs, attrs: rope(srcs[0], srcs[1], attrs),
    Op.SILU_MUL: lambda srcs, attrs: silu_mul(srcs[0], srcs[1], attrs),
    Op.SCALE_SHIFT: lambda srcs, attrs: scale_shift(*srcs, attrs),
    Op.ATTENTION: _kernel_fn("attention"),
    Op.MATMUL_INT8: _kernel_fn("matmul_int8"),
    Op.SSM_SCAN: _kernel_fn("ssm_scan"),
    Op.WKV6: _kernel_fn("wkv6"),
}


def lookup(op: Op) -> Callable:
    """Resolve one opcode to its handler ``fn(srcs, attrs)`` ahead of time
    (the linker calls this once per op at link time)."""
    fn = _TABLE.get(op)
    if fn is None:
        raise NotImplementedError(
            f"opcode {Op(op).name} is not ported to PyTorch yet")
    return fn


def compute(op: Op, srcs, attrs):
    """Execute one compute opcode on already-bound operands."""
    return lookup(op)(srcs, attrs)
