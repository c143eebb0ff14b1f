"""Public wrapper for the flash-attention kernel, layout (B, S, H, D).

The wrapper checks the contract and calls the custom op
``torch.ops.aeg.flash_attention``. On a CUDA tensor the op launches the
hand-written kernel (``csrc/flash_attention.cu``: bf16/f16 on the tensor
cores, fp32 on the CUDA cores) on the current stream, or raises; on a CPU
tensor it computes the plain version (``ref.py``). Nothing falls back from
one to the other. The op's vmap rule folds the lane axis into B, so a
program mapped over a batch (``Executor.run_batched``) launches the kernel
once. ``flash_attention.launches`` counts kernel launches.

For the dry run and the sharded paths the op also has a fake (``meta``)
implementation, a FLOP formula (``flops``: the multiply-adds of the
unmasked (q, k) pairs, as the kernel skips masked blocks) and a DTensor
sharding rule (``dtensor_rule``: batch or heads; the sequence stays whole),
with which the kernel runs on each rank's local shard.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.common import (DTYPE_CODE, check_float_dtype,
                                        check_rank, fold_lanes, unfold_lanes)
from repro_torch.kernels.flash_attention.ref import attention_ref_bshd

HEAD_DIMS = (16, 64, 128)         # the CUDA kernel's template instances
MAX_GRID_Y = 65535                # the fp32 kernel puts B*H on gridDim.y


def check_contract(q, k, v) -> None:
    """The JAX package's shape/dtype contract, same ``ValueError``s."""
    for name, a in (("q", q), ("k", k), ("v", v)):
        check_rank("flash_attention", name, a, 4)
        check_float_dtype("flash_attention", name, a)
    b, s, h, d = q.shape
    bk, sk, hkv, dk = k.shape
    if tuple(k.shape) != tuple(v.shape):
        raise ValueError(
            f"flash_attention: k/v shapes differ: {tuple(k.shape)} vs "
            f"{tuple(v.shape)}")
    if bk != b or dk != d:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} "
            f"disagree on batch/head_dim")
    if hkv == 0 or h % hkv != 0:
        raise ValueError(
            f"flash_attention: GQA grouping requires num_heads % "
            f"num_kv_heads == 0, got h={h}, hkv={hkv}")
    if s == 0 or sk == 0:
        raise ValueError(
            f"flash_attention: zero-length sequence (s={s}, s_kv={sk})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,D); k/v: (B,Sk,Hkv,D); returns (B,S,H,D) in q's dtype.

    The scale is 1/sqrt(D). Causal masking is top-left aligned."""
    check_contract(q, k, v)
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention: head_dim {q.shape[-1]} not supported by the "
            f"kernel; supported: {HEAD_DIMS}")
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"flash_attention: operands on several devices "
                         f"{sorted(map(str, devices))}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _flash_attention_op(q, k, v, bool(causal))


@torch.library.custom_op(
    "aeg::flash_attention", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, bool causal) -> Tensor")
def _flash_attention_op(q, k, v, causal):
    """The op ``flash_attention`` dispatches to: the plain version on the
    CPU, the hand kernel on CUDA (``_launch``), nothing elsewhere."""
    return attention_ref_bshd(q, k, v, causal=causal)


@_flash_attention_op.register_kernel("cuda")
def _launch(q, k, v, causal):
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: the kernel takes one dtype, got "
                         f"q {q.dtype}, k {k.dtype}, v {v.dtype}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, s, h, d = q.shape
    if q.dtype == torch.float32:
        check_grid(b, h)
    else:
        # an operand off a 16-byte boundary is copied into a fresh (aligned)
        # buffer, and the same kernel runs on the copy
        q, k, v = (a if a.data_ptr() % 16 == 0 else a.clone()
                   for a in (q, k, v))
        check_alignment(q, k, v)
    sk, hkv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lib = build.library()
    with torch.cuda.device(q.device):        # launch on the operands' card
        err = lib.aeg_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, sk,
            h, hkv, d, DTYPE_CODE[q.dtype], 1.0 / d ** 0.5,
            int(bool(causal)), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return o


@_flash_attention_op.register_vmap
def _vmap(info, in_dims, q, k, v, causal):
    """Under ``torch.func.vmap`` the lane axis folds into B: one launch
    covers every lane (lane j's heads are batch rows [j*B, (j+1)*B))."""
    n = info.batch_size
    q, k, v = fold_lanes(n, in_dims[:3], (q, k, v))
    return unfold_lanes(n, _flash_attention_op(q, k, v, causal)), 0


flash_attention.launches = 0


@_flash_attention_op.register_fake
def _fake(q, k, v, causal):
    return torch.empty_like(q)


def causal_pairs(s: int, sk: int, causal: bool) -> int:
    """The (q, k) pairs a call attends: top-left aligned, query i sees
    keys 0..i when causal."""
    if not causal:
        return s * sk
    m = min(s, sk)
    return m * (m + 1) // 2 + (s - m) * sk


@register_flop_formula(torch.ops.aeg.flash_attention)
def flops(q_shape, k_shape, v_shape, causal, *, out_shape=None, **kw):
    """q.k and p.v over the unmasked pairs: 4 D operations a pair a head."""
    b, s, h, d = q_shape
    return 4 * d * causal_pairs(s, k_shape[1], causal) * h * b


def dtensor_rule(q, k, v, causal):
    """Each mesh dim may split batch (dim 0 of q, k, v and o) or heads
    (dim 2) where it divides the kv heads, so each rank keeps whole GQA
    groups; otherwise every operand is replicated."""
    from torch.distributed.tensor import Replicate, Shard
    out = [([Replicate()], [Replicate()] * 3 + [None]),
           ([Shard(0)], [Shard(0)] * 3 + [None])]
    hkv = k.shape[2]
    if all(hkv % n == 0 for n in q.mesh.shape):
        out.append(([Shard(2)], [Shard(2)] * 3 + [None]))
    return out


def check_grid(b: int, h: int) -> None:
    """The fp32 kernel puts B*H on ``gridDim.y``, which stops at 65535."""
    if b * h > MAX_GRID_Y:
        raise ValueError(
            f"flash_attention: the float32 kernel takes B*H <= {MAX_GRID_Y}, "
            f"got B={b}, H={h}")


def check_alignment(q, k, v) -> None:
    """The bf16/f16 kernel stages rows with 16-byte ``cp.async``: each
    operand must start on a 16-byte boundary. (Its row strides, H*D and
    Hkv*D elements, are multiples of 8 for every head_dim in HEAD_DIMS.) A
    contiguous view at an odd storage offset fails here, as ``buf[1:]``
    would; ``flash_attention`` copies such an operand before it checks."""
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.data_ptr() % 16:
            raise ValueError(
                f"flash_attention: {name} starts at a {a.data_ptr() % 16}-"
                f"byte offset from a 16-byte boundary; the {a.dtype} kernel "
                f"loads 16-byte rows (copy it with .clone())")
