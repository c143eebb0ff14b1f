"""Shared by the kernel wrappers (the port's counterpart of
``repro.kernels.common``): the floating dtypes every CUDA kernel takes,
their codes at the C interface, the shape/dtype checks whose
``ValueError`` text matches the JAX package's, and the card's SM count.
``csrc/`` holds the CUDA side (element conversions and the error-string
entry point)."""
from __future__ import annotations

import functools

import torch

FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def check_float_dtype(kernel: str, name: str, a: torch.Tensor) -> None:
    if a.dtype not in FLOAT_DTYPES:
        raise ValueError(f"{kernel}: operand {name!r} has unsupported dtype "
                         f"{a.dtype}; supported: float32, bfloat16, float16")


def check_rank(kernel: str, name: str, a: torch.Tensor, rank: int) -> None:
    if a.ndim != rank:
        raise ValueError(f"{kernel}: operand {name!r} must be rank-{rank}, "
                         f"got shape {tuple(a.shape)}")


@functools.cache
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index`` (the kernels' plans use it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def fold_lanes(lanes: int, in_dims, tensors) -> list:
    """A vmap rule's operands with the lane axis folded into each one's
    leading axis: the lane axis moves first (an operand without one is
    expanded to every lane), then (lanes, B, ...) becomes (lanes * B, ...).
    Lane j's rows are then rows [j * B, (j + 1) * B) of the kernel's
    operand, so per-lane outputs come back with ``unfold_lanes``."""
    out = []
    for t, d in zip(tensors, in_dims):
        t = t.expand(lanes, *t.shape) if d is None else t.movedim(d, 0)
        out.append(t.reshape(lanes * t.shape[1], *t.shape[2:]))
    return out


def unfold_lanes(lanes: int, t: torch.Tensor) -> torch.Tensor:
    """Inverse of ``fold_lanes`` on a kernel's output: (lanes * B, ...) ->
    (lanes, B, ...)."""
    return t.reshape(lanes, t.shape[0] // lanes, *t.shape[1:])


def lane(t: torch.Tensor, d, j: int) -> torch.Tensor:
    """Lane ``j`` of a vmap rule's operand (the operand itself without a
    lane axis)."""
    return t if d is None else t.select(d, j)
