"""What both references share: RMSNorm, a product in fp32 or through
float8, and the head."""
from __future__ import annotations

import torch

FP8_MAX = 448.0                        # largest finite float8 e4m3fn


def round_fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t rounded to float8 e4m3, scaled along ``dim`` so that each slice's
    largest magnitude maps to the format's largest, and back to fp32."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def prep(w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """A weight (in, out) as ``lin`` takes it: fp32, and with ``fp8``
    rounded by output column."""
    w = w.float()
    return round_fp8(w, 0) if fp8 else w


def lin(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """x (..., in) @ w (in, out, from ``prep``) in fp32; with ``fp8`` x
    rounded by row first."""
    return (round_fp8(x, -1) if fp8 else x) @ w


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * w.float()


def head(config: dict, params: dict, xs: list, starts: list, eps: float,
         fp8: bool) -> list:
    """The final norm and the output head at positions start..end of each
    hidden sequence (S, d)."""
    w = prep(params["lm_head"], fp8)
    out = []
    for x, s in zip(xs, starts):
        out.append(lin(rms(x[s:], params["final_norm"], eps), w, fp8))
    return out
