"""Public wrapper for the selective-scan kernel, layout (B, T, di, N).

On a CUDA tensor it launches the hand-written kernel (``csrc/ssm_scan.cu``)
on the current stream, or raises; on a CPU tensor it computes the plain
version (``ref.py``). Nothing falls back from one to the other.
``ssm_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (DTYPE_CODE, check_float_dtype,
                                        check_rank)
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

STATE_SIZES = (4, 8, 16, 32)      # the CUDA kernel's template instances


def check_contract(da, bx, c) -> None:
    """The JAX package's shape/dtype contract as its registry applies it
    (chunk=1, d_block=1: any T and di tile), with the same ``ValueError``s."""
    for name, a, rank in (("da", da, 4), ("bx", bx, 4), ("c", c, 3)):
        check_rank("ssm_scan", name, a, rank)
    for name, a in (("da", da), ("bx", bx), ("c", c)):
        check_float_dtype("ssm_scan", name, a)
    b, t, di, n = da.shape
    if tuple(bx.shape) != tuple(da.shape):
        raise ValueError(
            f"ssm_scan: da/bx shapes differ: {tuple(da.shape)} vs "
            f"{tuple(bx.shape)}")
    if tuple(c.shape) != (b, t, n):
        raise ValueError(
            f"ssm_scan: c must be (B,T,N)=({b},{t},{n}), got "
            f"{tuple(c.shape)}")
    if t == 0:
        raise ValueError("ssm_scan: zero-length sequence (t=0)")
    if di == 0 or n == 0:
        raise ValueError(f"ssm_scan: zero-size state (di={di}, n={n})")


def ssm_scan(da: torch.Tensor, bx: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """da/bx: (B,T,di,N) with da the per-step log-decay (<= 0); c: (B,T,N).
    Returns y (B,T,di) in da's dtype, from a zero initial state."""
    check_contract(da, bx, c)
    if da.shape[-1] not in STATE_SIZES:
        raise ValueError(
            f"ssm_scan: state size N={da.shape[-1]} not supported by the "
            f"kernel; supported: {STATE_SIZES}")
    devices = {da.device, bx.device, c.device}
    if len(devices) != 1:
        raise ValueError(f"ssm_scan: operands on several devices "
                         f"{sorted(map(str, devices))}")
    if da.device.type == "cpu":
        return ssm_scan_ref(da, bx, c)
    if da.device.type != "cuda":
        raise ValueError(f"ssm_scan: unsupported device {da.device}")
    if bx.dtype != da.dtype or c.dtype != da.dtype:
        raise ValueError(f"ssm_scan: the kernel takes one dtype, got "
                         f"da {da.dtype}, bx {bx.dtype}, c {c.dtype}")
    da, bx, c = da.contiguous(), bx.contiguous(), c.contiguous()
    b, t, di, n = da.shape
    y = torch.empty((b, t, di), dtype=da.dtype, device=da.device)
    lib = build.library()
    with torch.cuda.device(da.device):       # launch on the operands' card
        err = lib.aeg_ssm_scan(
            da.data_ptr(), bx.data_ptr(), c.data_ptr(), y.data_ptr(), b, t,
            di, n, DTYPE_CODE[da.dtype],
            torch.cuda.current_stream(da.device).cuda_stream)
    build.check(lib, err, "ssm_scan")
    ssm_scan.launches += 1
    return y


ssm_scan.launches = 0
