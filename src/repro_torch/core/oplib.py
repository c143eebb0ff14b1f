"""PyTorch semantics for the RCB compute ops of the dense LM program.

The port's counterpart of ``repro.core.oplib``: one function per opcode,
shared by the interpreted path (``dispatch_compute``) and the linked path
(``link_compute``), so the two are equivalent by construction. The port
covers the opcodes ``rctc.compile_transformer_block`` emits for the dense,
hybrid and ssm families; any other opcode raises ``NotImplementedError``
naming it.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.rcb import Op


def gemm(a, b, attrs):
    # jnp's ``.T`` reverses every axis, whatever the rank
    if attrs.get("ta", False):
        a = a.permute(*reversed(range(a.ndim)))
    if attrs.get("tb", False):
        b = b.permute(*reversed(range(b.ndim)))
    return torch.matmul(a, b)


def add(a, b, attrs):
    return a + b


def reshape(x, attrs):
    return torch.reshape(x, tuple(attrs["shape"]))


def passthrough(x, attrs):
    return x


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    """fp32 math, cast back to x's dtype (models/common.py rms_norm)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * w.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int. fp32
    math, rotation by half-split (models/common.py apply_rope)."""
    dt = x.dtype
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                # (d/2,)
    ang = positions.float()[..., None] * freqs            # (..., seq, d/2)
    cos = torch.cos(ang)[..., None, :]                    # (..., seq, 1, d/2)
    sin = torch.sin(ang)[..., None, :]
    x = x.float()
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


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
    Op.ADD: lambda srcs, attrs: add(srcs[0], srcs[1], attrs),
    Op.RESHAPE: lambda srcs, attrs: reshape(srcs[0], attrs),
    Op.PASSTHROUGH: lambda srcs, attrs: passthrough(srcs[0], attrs),
    Op.RMSNORM: lambda srcs, attrs: rmsnorm(srcs[0], srcs[1], attrs),
    Op.ROPE: lambda srcs, attrs: rope(srcs[0], srcs[1], attrs),
    Op.SILU_MUL: lambda srcs, attrs: silu_mul(srcs[0], srcs[1], attrs),
    Op.SCALE_SHIFT: lambda srcs, attrs: scale_shift(*srcs, attrs),
    Op.ATTENTION: _kernel_fn("attention"),
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
