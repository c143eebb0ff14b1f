"""Public wrapper for the flash-attention kernel, layout (B, S, H, D).

On a CUDA tensor it launches the hand-written kernel
(``csrc/flash_attention.cu``: bf16/f16 on the tensor cores, fp32 on the CUDA
cores) on the current stream, or raises; on a CPU tensor it computes the
plain version (``ref.py``). Nothing falls back from one to the other.
``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (DTYPE_CODE, check_float_dtype,
                                        check_rank)
from repro_torch.kernels.flash_attention.ref import attention_ref_bshd

HEAD_DIMS = (16, 64, 128)         # the CUDA kernel's template instances


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
    if q.device.type == "cpu":
        return attention_ref_bshd(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: the kernel takes one dtype, got "
                         f"q {q.dtype}, k {k.dtype}, v {v.dtype}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.dtype != torch.float32:
        check_alignment(q, k, v)
    b, s, h, d = q.shape
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


flash_attention.launches = 0


def check_alignment(q, k, v) -> None:
    """The bf16/f16 kernel stages rows with 16-byte ``cp.async``: each
    operand must start on a 16-byte boundary. (Its row strides, H*D and
    Hkv*D elements, are multiples of 8 for every head_dim in HEAD_DIMS.) A
    contiguous view at an odd storage offset fails here, as ``buf[1:]``
    would."""
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.data_ptr() % 16:
            raise ValueError(
                f"flash_attention: {name} starts at a {a.data_ptr() % 16}-"
                f"byte offset from a 16-byte boundary; the {a.dtype} kernel "
                f"loads 16-byte rows (copy it with .clone())")
