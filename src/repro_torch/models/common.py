"""Parameter specs and norms shared by the model modules (the port's
counterpart of ``repro.models.common``: ``ParamSpec`` without the sharding
axes, since the port runs on one device, and ``group_norm``)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class ParamSpec(NamedTuple):
    shape: tuple
    dtype: str
    init: str = "normal"      # normal | zeros | ones | embed | decay | uniform
    scale: float = 1.0


def group_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the trailing dim (rwkv6 ln_x), fp32 math, cast back to
    x's dtype. The variance is the population one, as ``jnp.var``'s."""
    dt = x.dtype
    *lead, d = x.shape
    x = x.float().reshape(*lead, groups, d // groups)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    x = (x - mu) * torch.rsqrt(var + eps)
    x = x.reshape(*lead, d)
    return (x * w.float() + b.float()).to(dt)
