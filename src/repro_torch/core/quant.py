"""INT8 post-training quantization for the RCB deployment path.

The port's counterpart of ``repro.core.quant``. Activation scales come from a
calibration run *through the runtime itself* (the executor probes every
buffer of the fp32 RCB program on the driver's device), weights are
per-output-channel symmetric INT8, convolutions accumulate in INT32 and
requantize with fused ``x_scale * w_scale_c`` vectors. The arithmetic is
the JAX package's float32 arithmetic; a division by a constant divides by a
float32 tensor, never a Python scalar (on CUDA that becomes a multiplication
by the reciprocal, which can round differently). fp32 convolutions on
another device or library differ in their last bits, so activation scales
(and the requant vectors) agree with the JAX package's to a few ulps, while
the int8 weights, which depend on the weights alone, agree exactly.
"""
from __future__ import annotations

import torch

from repro_torch.configs.resnet18 import ResNetConfig
from repro_torch.core import rbl as rbl_mod
from repro_torch.core import rctc, rimfs as rimfs_mod
from repro_torch.core.oplib import f32_scalar
from repro_torch.core.executor import Executor
from repro_torch.core.rcb import Op
from repro_torch.dtypes import as_tensor


def per_channel_scales(w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Symmetric per-output-channel scales for HWIO conv weights."""
    dims = tuple(i for i in range(w.ndim) if i != (axis % w.ndim))
    amax = torch.amax(torch.abs(w), dim=dims)
    return torch.clamp_min(amax, 1e-8) / f32_scalar(127.0, amax)


def quantize_weight(w: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    q = torch.round(w / scales.reshape((1,) * (w.ndim - 1) + (-1,)))
    return torch.clamp(q, -127, 127).to(torch.int8)


def calibrate(cfg: ResNetConfig, folded: dict, calib_x,
              device="cuda") -> dict:
    """Run the fp32 RCB program through the executor on ``device`` and
    record the per-symbol abs-max (the runtime IS the calibration
    harness). ``calib_x``: (N, H, W, 3) float32, numpy or torch."""
    ex = Executor(device=device)          # no CUDA: raises before work
    prog, image = rctc.compile_resnet18(cfg, folded,
                                        batch=calib_x.shape[0])
    bound = rbl_mod.bind(prog, rimfs=rimfs_mod.mount(image),
                         inputs={"input": calib_x}, driver=ex.driver)
    probe: dict = {}
    ex.run(bound, probe=probe)
    return probe


def quantize_resnet(cfg: ResNetConfig, folded: dict, calib_x,
                    device="cuda") -> dict:
    """Produce the INT8 pack consumed by rctc.compile_resnet18(int8=...):
    int8 weights and float32 requant vectors as CPU tensors, activation
    scales as floats."""
    probe = calibrate(cfg, folded, calib_x, device)
    prog, _ = rctc.compile_resnet18(cfg, folded, batch=calib_x.shape[0])

    weights: dict[str, torch.Tensor] = {}
    requant: dict[str, torch.Tensor] = {}
    act_scales: dict[str, float] = {}
    for op in prog.ops():
        if op.op != Op.CONV2D:
            continue
        x_sym, w_key = op.srcs[0], op.srcs[1]
        sx = max(probe.get(x_sym, 1.0), 1e-8) / 127.0
        w = as_tensor(folded[w_key], torch.device("cpu"))
        sw = per_channel_scales(w)
        weights[w_key] = quantize_weight(w, sw)
        requant[w_key] = sx * sw
        act_scales[w_key] = float(sx)
    return {"weights": weights, "requant": requant,
            "act_scales": act_scales}


def top1_agreement(p_fp, p_q) -> float:
    """The share of rows whose argmax agrees (numpy arrays or tensors)."""
    a = torch.as_tensor(p_fp).argmax(-1).cpu()
    b = torch.as_tensor(p_q).argmax(-1).cpu()
    return float((a == b).double().mean())
