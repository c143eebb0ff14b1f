"""Selective SSM (Mamba-style) branch of the Hymba hybrid architecture.

The port's counterpart of ``repro.models.mamba`` for serving: the
projections into the ``ssm_scan`` operand layout (``ssm_kernel_inputs``),
the shared output stage (``ssm_output``), ``ssm_core``/``mamba_mix`` over
the kernel registry (the full-sequence scan), and the engine's decode
state (``mamba_state_specs``) and single-token step (``mamba_step``, stock
ops). The RCTC per-layer lowering runs the first two as its
``ssm_pre``/``ssm_post`` glue around ``Op.SSM_SCAN``. The full-sequence
scan takes the registry route, or with ``impl="autograd"`` (training) the
JAX package's differentiable chunked scan, ``ssm_chunked``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import low_rank_operands, matmul, shard
from repro_torch.models.common import AUTOGRAD, ParamSpec

DT_RANK = 32


def mamba_specs(cfg: ModelConfig) -> dict:
    L, d = cfg.num_layers, cfg.d_model
    di, N = cfg.d_model, cfg.ssm_state          # d_inner == d_model (Hymba)
    dt = cfg.dtype
    return {
        "m_in": ParamSpec((L, d, 2 * di), dt, axes=("layers", "fsdp", "mlp")),
        "m_x": ParamSpec((L, di, DT_RANK + 2 * N), dt,
                         axes=("layers", "fsdp", None)),
        "m_dt": ParamSpec((L, DT_RANK, di), dt, axes=("layers", None, "fsdp")),
        "m_dt_b": ParamSpec((L, di), "float32", "zeros",
                            axes=("layers", None)),
        "m_alog": ParamSpec((L, di, N), "float32", "uniform", 1.0,
                            ("layers", "fsdp", "state")),
        "m_d": ParamSpec((L, di), "float32", "ones", axes=("layers", None)),
        "m_out": ParamSpec((L, di, d), dt, axes=("layers", "mlp", "fsdp")),
    }


def mamba_state_specs(cfg: ModelConfig, batch: int) -> dict:
    """The engine's per-layer SSM state, (L, B, di, N) fp32."""
    L, di, N = cfg.num_layers, cfg.d_model, cfg.ssm_state
    return {"ssm": ParamSpec((L, batch, di, N), "float32", "zeros",
                             axes=("layers", "batch", "mlp", "state"))}


def _ssm_inputs(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """Project x -> (u, z, dt, B, C). u/z (B,T,di); dt (B,T,di) fp32;
    B/C (B,T,N) fp32."""
    N = cfg.ssm_state
    uz = torch.matmul(x, p["m_in"])
    u, z = torch.chunk(uz, 2, dim=-1)
    proj = torch.matmul(u, p["m_x"]).float()
    dtr, B_, C_ = torch.split(proj, [DT_RANK, N, N], dim=-1)
    dtr, w_dt = low_rank_operands(dtr, p["m_dt"])
    dt = F.softplus(torch.matmul(dtr, w_dt.float()) + p["m_dt_b"])
    return u, z, dt, B_, C_


def ssm_kernel_inputs(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """Project x into the kernel-registry ``ssm_scan`` operand layout.

    Returns (da_log (B,T,di,N) fp32 <= 0, bx (B,T,di,N) fp32, c (B,T,N)
    fp32, u (B,T,di) fp32, z (B,T,di)): the first three are the operands of
    ``Op.SSM_SCAN``; u/z feed the output stage (skip + gate)."""
    u, z, dt, B_, C_ = _ssm_inputs(cfg, p, x)
    A = -torch.exp(p["m_alog"])
    u32 = u.float()
    da_log = dt[..., None] * A[None, None]            # (B,T,di,N)  <= 0
    bx = (dt * u32)[..., None] * B_[:, :, None, :]    # (B,T,di,N)
    return da_log, bx, C_, u32, z


def ssm_output(cfg: ModelConfig, p: dict, y: torch.Tensor, u: torch.Tensor,
               z: torch.Tensor, x_dtype: torch.dtype) -> torch.Tensor:
    """Skip connection + silu gate + output projection (shared tail)."""
    y = y + u * p["m_d"][None, None]
    y = y.to(x_dtype) * F.silu(z.float()).to(x_dtype)
    y = shard(y, "batch", "seq", "mlp")
    return matmul(y, p["m_out"])


def _scan_chunk(a, b):
    """Inclusive scan of ``h_t = a_t * h_{t-1} + b_t`` along axis 1 of
    (B, C, di, N), from h = 0 (b_0 carries any entering state), in
    log2(C) doubling steps: element t takes in the element ``off`` before
    it as ``(a_t a_{t-off}, a_t b_{t-off} + b_t)``. Every factor is a
    decay in (0, 1], so nothing overflows, and each step is out of place,
    so autograd differentiates it. Returns every h_t."""
    off = 1
    while off < a.shape[1]:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return b


def ssm_chunked(u, dt, B_, C_, A, D, h0, chunk: int = 64):
    """Chunked selective scan (``repro.models.mamba.ssm_chunked``), the
    training route: differentiable stock ops.

    u (B,T,di) fp32, dt (B,T,di), B_/C_ (B,T,N), A (di,N) negative, D
    (di,), h0 (B,di,N). T is padded to a whole number of chunks of
    min(chunk, T) with identity steps (da = 0 keeps h, b = 0 adds
    nothing); in each chunk the recurrence seeded by the carried state
    runs as a doubling scan (``_scan_chunk``; the JAX package's is
    ``lax.associative_scan``, which pairs the steps in another order).
    Returns (y (B,T,di) with the ``u * D`` skip term, h_final)."""
    Bb, T, di = u.shape
    C = min(chunk, T)
    Tp = (T + C - 1) // C * C
    da_log = dt[..., None] * A[None, None]            # (B,T,di,N)  <= 0
    binp = (dt * u)[..., None] * B_[:, :, None, :]    # (B,T,di,N)
    if Tp != T:
        da_log = F.pad(da_log, (0, 0, 0, 0, 0, Tp - T))
        binp = F.pad(binp, (0, 0, 0, 0, 0, Tp - T))
        C_ = F.pad(C_, (0, 0, 0, Tp - T))
    h, ys = h0, []
    for c0 in range(0, Tp, C):
        a_ = torch.exp(da_log[:, c0:c0 + C])
        b_ = binp[:, c0:c0 + C]
        b_ = torch.cat([(b_[:, 0] + a_[:, 0] * h)[:, None], b_[:, 1:]], 1)
        hs = _scan_chunk(a_, b_)
        ys.append(torch.einsum("btdn,btn->btd", hs, C_[:, c0:c0 + C]))
        h = hs[:, -1]
    y = torch.cat(ys, 1)[:, :T]
    return y + u * D[None, None], h


def ssm_core(u, dt, B_, C_, A, D, h0, impl=None):
    """Full-sequence selective scan through the registry ``ssm_scan``.
    Returns (y, h_final), y already carrying the ``u * D`` skip term.
    ``impl="ref"`` runs the kernel's plain version whatever the device;
    ``impl="autograd"`` takes ``ssm_chunked`` instead of the registry.

    The kernel computes the zero-state scan: h0 is folded in by seeding step
    0's input with ``exp(da_0) * h0``, and the final state comes in closed
    form from the inclusive cumsum P of da, as ``sum_t exp(P_T - P_t) bx_t``
    (every exponent <= 0, so nothing overflows)."""
    if impl == AUTOGRAD:
        return ssm_chunked(u, dt, B_, C_, A, D, h0)
    from repro_torch.kernels import registry
    da_log = dt[..., None] * A[None, None]
    bx = (dt * u)[..., None] * B_[:, :, None, :]
    bx[:, 0] += torch.exp(da_log[:, 0]) * h0      # bx is this call's own
    y = registry.call("ssm_scan", da_log, bx, C_, impl=impl)
    P = torch.cumsum(da_log, dim=1)
    h_final = torch.sum(torch.exp(P[:, -1:] - P) * bx, dim=1)
    return y + u * D[None, None], h_final


def mamba_mix(cfg: ModelConfig, p: dict, x: torch.Tensor, h0: torch.Tensor,
              impl=None):
    """Full-sequence Mamba branch. Returns (y, h_final)."""
    u, z, dt, B_, C_ = _ssm_inputs(cfg, p, x)
    A = -torch.exp(p["m_alog"])
    y, h1 = ssm_core(u.float(), dt, B_, C_, A, p["m_d"], h0, impl)
    y = y.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    y = shard(y, "batch", "seq", "mlp")
    return matmul(y, p["m_out"]), h1


def mamba_step(cfg: ModelConfig, p: dict, x: torch.Tensor,
               h0: torch.Tensor):
    """Single-token decode. x (B,1,d); h0 (B,di,N) fp32. Returns (y
    (B,1,d), h1); h0 is only read."""
    u, z, dt, B_, C_ = _ssm_inputs(cfg, p, x)
    A = -torch.exp(p["m_alog"])
    u0 = u[:, 0].float()
    da = torch.exp(dt[:, 0, :, None] * A[None])              # (B,di,N)
    h1 = da * h0 + (dt[:, 0] * u0)[..., None] * B_[:, 0, None, :]
    y = torch.einsum("bdn,bn->bd", h1, C_[:, 0]) + u0 * p["m_d"]
    y = y[:, None].to(x.dtype) * F.silu(z.float()).to(x.dtype)
    return torch.matmul(y, p["m_out"]), h1
