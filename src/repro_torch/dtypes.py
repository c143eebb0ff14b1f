"""Dtype names shared by RCB tensor descriptors, RIMFS images and the wire.

The JAX package names dtypes the numpy way (``"float32"``, ``"int32"``) and
ships bfloat16 through ml_dtypes. The port has neither JAX nor ml_dtypes on
the card's machine, so bf16 travels as its uint16 bit pattern and is viewed
as ``torch.bfloat16`` on arrival; every other dtype keeps its numpy form.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

BF16 = "bfloat16"

_TORCH: dict[str, torch.dtype] = {
    "float32": torch.float32, "float16": torch.float16,
    "float64": torch.float64, BF16: torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_NAME = {v: k for k, v in _TORCH.items()}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _TORCH[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def name_of(dtype: torch.dtype) -> str:
    """The JAX package's name for a torch dtype (``str(np_array.dtype)``)."""
    try:
        return _NAME[dtype]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype}") from None


def itemsize(name: str) -> int:
    return torch_dtype(name).itemsize


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def host_bits(t: torch.Tensor) -> np.ndarray:
    """A contiguous CPU numpy array holding the tensor's bytes: bf16 as its
    uint16 bits, every other dtype as itself (zero-copy for a contiguous
    CPU tensor)."""
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
        return t.numpy().view(np.uint16)
    return t.numpy()


def from_host_bits(a: np.ndarray, name: str) -> torch.Tensor:
    """Inverse of ``host_bits``: a CPU tensor sharing ``a``'s memory.

    RIMFS images and wire payloads are immutable ``bytes``; torch warns that
    it cannot mark such memory read-only. Nothing in the port writes into a
    weight or an input in place, so the warning is silenced here."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        if name == BF16:
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)


def bf16_from_float(a) -> torch.Tensor:
    """A CPU ``torch.bfloat16`` tensor of ``a``'s values, each rounded to
    nearest even through float32: the bits ml_dtypes' ``astype(bfloat16)``
    gives the JAX package."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(
        torch.bfloat16)


def to_host(t) -> object:
    """A device result as the host value the wire carries: a numpy array,
    or a CPU ``torch.bfloat16`` tensor (numpy has no bfloat16)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """A host input (numpy array or tensor) on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.asarray(x)
    if a.dtype.kind == "V" and a.dtype.name == BF16:      # an ml_dtypes array
        return from_host_bits(np.ascontiguousarray(a).view(np.uint16),
                              BF16).to(device)
    return from_host_bits(np.ascontiguousarray(a), str(a.dtype)).to(device)
