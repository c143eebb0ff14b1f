"""Plain PyTorch version of the INT8 GEMM (port of ``int8_matmul_ref``).

The CPU path of the wrapper, the ``impl="ref"`` route of the registry and
the card-side check of the CUDA kernel all use it. ``torch.matmul`` takes
no int8 or int32 operands on CUDA, so the product is taken in float64: every
partial sum of int8 products is an integer far below 2^53, so it is exact
in any order of summation, and the cast to int32 is exact while
``K * 128 * 128 < 2^31`` (K up to 131,072).
"""
from __future__ import annotations

import torch


def int8_matmul_i32_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M, K) int8; w: (K, N) int8. Returns the int32 sums (M, N)."""
    return torch.matmul(x.double(), w.double()).to(torch.int32)


def int8_matmul_ref(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The JAX oracle's arithmetic: ``f32(acc) * scale[n]``, one rounding to
    ``out_dtype``."""
    acc = int8_matmul_i32_ref(x, w)
    return (acc.float() * scale.float()[None, :]).to(out_dtype)
