"""Plain PyTorch version of the selective scan (port of ``ssm_scan_ref``).

The CPU path of the wrapper, the ``impl="ref"`` route of the registry and
the card-side check of the CUDA kernel all use it.
"""
from __future__ import annotations

import torch


def ssm_scan_ref(da: torch.Tensor, bx: torch.Tensor,
                 c: torch.Tensor) -> torch.Tensor:
    """da/bx: (B,T,di,N) (da = log decay); c: (B,T,N) -> y (B,T,di).

    From h0 = 0: ``h = exp(da_t) * h + bx_t``, ``y_t = sum_n h * c_t``, in
    fp32, with y in da's dtype."""
    b, t, di, n = da.shape
    daf, bxf, cf = da.float(), bx.float(), c.float()
    h = torch.zeros((b, di, n), dtype=torch.float32, device=da.device)
    ys = []
    for i in range(t):
        h = torch.exp(daf[:, i]) * h + bxf[:, i]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, i]))
    return torch.stack(ys, dim=1).to(da.dtype)
