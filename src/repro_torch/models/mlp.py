"""Dense SwiGLU MLP (the port's counterpart of ``repro.models.mlp.swiglu``;
the mixture-of-experts half of that module is not ported yet)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def swiglu(p: dict, x: torch.Tensor, prefix: str = "mlp_") -> torch.Tensor:
    """x (B,S,d) -> (B,S,d): ``silu(x Wg) * (x Wu)`` then ``Wo``; the SiLU in
    fp32, cast back to x's dtype before the product."""
    h = x @ p[prefix + "wi_gate"]
    u = x @ p[prefix + "wi_up"]
    h = F.silu(h.float()).to(x.dtype) * u
    return h @ p[prefix + "wo"]
