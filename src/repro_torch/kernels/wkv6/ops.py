"""Public wrapper for the RWKV-6 WKV kernel, layout (B, T, H, K).

On a CUDA tensor it launches the hand-written chunked scan (``csrc/wkv6.cu``)
on the current stream, or raises; on a CPU tensor it computes the plain
version (``ref.py``). Nothing falls back from one to the other. The wrapper
reaches either through the custom op ``torch.ops.aeg.wkv6``, whose vmap rule
folds the lane axis into B. ``wkv6.launches`` counts calls that launched the scan: each is two kernel
launches (local chunk states, then outputs), three above ``INBLOCK_CHUNKS``
chunks of 64 steps, where a carry kernel builds the entering states. A
``plan`` ({"states": "inblock"} or {"states": "carry"}, an autotuned
winner from ``kernels/registry.py``) picks the build whatever the number of
chunks; the two agree within the kernel's tolerance.

For the dry run and the sharded paths the op also has a fake (``meta``)
implementation, a FLOP formula (``flops``) and a DTensor sharding rule
(``dtensor_rule``: batch or heads; the time axis stays whole).
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.common import (DTYPE_CODE, check_float_dtype,
                                        check_rank, fold_lanes, unfold_lanes)
from repro_torch.kernels.wkv6.ref import wkv6_ref_bthk

HEAD_SIZES = (8, 16, 32, 64)      # the CUDA kernel's template instances
# Up to this many chunks each output block builds its entering state
# itself; above, the carry kernel does. On an H100 the in-block build was
# ahead up to 11 chunks (T = 704) and behind from 12 (PERF.md, "wkv6").
INBLOCK_CHUNKS = 11
INBLOCK, CARRY = "inblock", "carry"
_ALWAYS_INBLOCK = 1 << 30          # more chunks than any T gives


def candidates() -> list:
    """The plans an autotune sweep times: each output block building its
    entering states, then the carry kernel building them."""
    return [{"states": INBLOCK}, {"states": CARRY}]


def _max_inblock(plan) -> int:
    """A plan dict as the custom op's int: the most chunks the in-block
    build takes (-1: ``INBLOCK_CHUNKS``)."""
    if plan is None:
        return -1
    if plan["states"] not in (INBLOCK, CARRY):
        raise ValueError(f"wkv6: bad plan {plan!r}")
    return _ALWAYS_INBLOCK if plan["states"] == INBLOCK else 0


def check_contract(r, k, v, lw, u) -> None:
    """The JAX package's shape/dtype contract as its registry applies it
    (chunk=1: any T), with the same ``ValueError``s."""
    for name, a in (("r", r), ("k", k), ("v", v), ("lw", lw)):
        check_rank("wkv6", name, a, 4)
        check_float_dtype("wkv6", name, a)
        if tuple(a.shape) != tuple(r.shape):
            raise ValueError(
                f"wkv6: operand {name!r} shape {tuple(a.shape)} differs "
                f"from r {tuple(r.shape)}")
    check_rank("wkv6", "u", u, 2)
    check_float_dtype("wkv6", "u", u)
    b, t, h, kk = r.shape
    if tuple(u.shape) != (h, kk):
        raise ValueError(
            f"wkv6: u must be (H,K)=({h},{kk}), got {tuple(u.shape)}")
    if t == 0:
        raise ValueError("wkv6: zero-length sequence (t=0)")
    if h == 0 or kk == 0:
        raise ValueError(f"wkv6: zero-size head layout (h={h}, k={kk})")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         lw: torch.Tensor, u: torch.Tensor, plan=None) -> torch.Tensor:
    """r/k/v/lw: (B,T,H,K) with lw the per-step log-decay (<= 0); u: (H,K)
    the bonus. Returns y (B,T,H,K) in r's dtype, from a zero state."""
    check_contract(r, k, v, lw, u)
    if r.shape[-1] not in HEAD_SIZES:
        raise ValueError(
            f"wkv6: head size K={r.shape[-1]} not supported by the kernel; "
            f"supported: {HEAD_SIZES}")
    devices = {a.device for a in (r, k, v, lw, u)}
    if len(devices) != 1:
        raise ValueError(f"wkv6: operands on several devices "
                         f"{sorted(map(str, devices))}")
    if r.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"wkv6: unsupported device {r.device}")
    return _wkv6_op(r, k, v, lw, u, _max_inblock(plan))


@torch.library.custom_op(
    "aeg::wkv6", mutates_args=(), device_types="cpu",
    schema="(Tensor r, Tensor k, Tensor v, Tensor lw, Tensor u, "
           "int max_inblock) -> Tensor")
def _wkv6_op(r, k, v, lw, u, max_inblock):
    """The op ``wkv6`` dispatches to: the plain version on the CPU, the
    hand kernel on CUDA (``_launch``), nothing elsewhere."""
    return wkv6_ref_bthk(r, k, v, lw, u)


@_wkv6_op.register_kernel("cuda")
def _launch(r, k, v, lw, u, max_inblock):
    if not k.dtype == v.dtype == lw.dtype == r.dtype:
        raise ValueError(f"wkv6: the kernel takes one dtype for r, k, v, lw, "
                         f"got {r.dtype}, {k.dtype}, {v.dtype}, {lw.dtype}")
    # the kernel stages rows by 16-byte cp.async: an operand off a 16-byte
    # boundary (a view at an odd offset) is copied into a fresh buffer
    r, k, v, lw = (a.contiguous() for a in (r, k, v, lw))
    r, k, v, lw = (a if a.data_ptr() % 16 == 0 else a.clone()
                   for a in (r, k, v, lw))
    u = u.float().contiguous()        # exact, as the TPU kernel reads it
    b, t, h, kk = r.shape
    y = torch.empty_like(r)
    lib = build.library()
    scratch = torch.empty(lib.aeg_wkv6_scratch_floats(b, t, h, kk),
                          dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):        # launch on the operands' card
        err = lib.aeg_wkv6(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            u.data_ptr(), y.data_ptr(), scratch.data_ptr(), b, t, h, kk,
            DTYPE_CODE[r.dtype],
            INBLOCK_CHUNKS if max_inblock < 0 else max_inblock,
            torch.cuda.current_stream(r.device).cuda_stream)
    build.check(lib, err, "wkv6")
    wkv6.launches += 1
    return y


@_wkv6_op.register_vmap
def _vmap(info, in_dims, r, k, v, lw, u, max_inblock):
    """Under ``torch.func.vmap`` the lane axis folds into B: one call
    covers every lane. The kernel takes one u (H, K) for all of B, so a u
    that differs by lane cannot fold, and raises."""
    if in_dims[4] is not None:
        raise ValueError("wkv6: u carries the vmap lane axis; the kernel "
                         "takes one (H, K) bonus for every batch row, so "
                         "the lanes cannot fold into B")
    n = info.batch_size
    r, k, v, lw = fold_lanes(n, in_dims[:4], (r, k, v, lw))
    return unfold_lanes(n, _wkv6_op(r, k, v, lw, u, max_inblock)), 0


wkv6.launches = 0


@_wkv6_op.register_fake
def _fake(r, k, v, lw, u, max_inblock):
    return torch.empty_like(r)


@register_flop_formula(torch.ops.aeg.wkv6)
def flops(r_shape, k_shape, v_shape, lw_shape, u_shape, max_inblock, *,
          out_shape=None, **kw):
    """k v^T and two multiply-adds a (b, t, h, i, o); the exp and the
    bonus term, about 4, a (b, t, h, i)."""
    b, t, h, kk = r_shape
    return 5 * b * t * h * kk * kk + 4 * b * t * h * kk


def dtensor_rule(r, k, v, lw, u, max_inblock):
    """Each mesh dim may split batch (dim 0 of r, k, v, lw and y; u whole)
    or heads (dim 2 of those, dim 0 of u); otherwise every operand is
    replicated."""
    from torch.distributed.tensor import Replicate, Shard
    return [([Replicate()], [Replicate()] * 5 + [None]),
            ([Shard(0)], [Shard(0)] * 4 + [Replicate(), None]),
            ([Shard(2)], [Shard(2)] * 4 + [Shard(0), None])]
