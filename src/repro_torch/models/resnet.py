"""ResNet-18 (He et al. 2016), the paper's case-study workload.

The port's counterpart of ``repro.models.resnet``: the parameter specs, their
initialization from a seed on a device, the plain forward (the oracle the
RCB program is held against), BN folding into inference scale/shift pairs,
and ``params_from_jax`` to carry the JAX package's parameters across.
Activations are NHWC and conv weights HWIO, as in the JAX package; the
forward runs the same SAME-padded convolutions and maxpool as the RCB
program's opcodes (``core/oplib.py``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.configs.resnet18 import ResNetConfig
from repro_torch.core import oplib
from repro_torch.dtypes import as_tensor
from repro_torch.models.common import ParamSpec, draw_param

BN_KEYS = ("scale", "bias", "mean", "var")


def _conv_spec(kh, kw, cin, cout):
    return ParamSpec((kh, kw, cin, cout), "float32", "normal", 1.4)


def _bn_specs(c):
    return {
        "scale": ParamSpec((c,), "float32", "ones"),
        "bias": ParamSpec((c,), "float32", "zeros"),
        "mean": ParamSpec((c,), "float32", "zeros"),
        "var": ParamSpec((c,), "float32", "ones"),
    }


def resnet_specs(cfg: ResNetConfig) -> dict:
    specs: dict[str, Any] = {
        "stem_conv": _conv_spec(7, 7, 3, cfg.stem_width),
        "stem_bn": _bn_specs(cfg.stem_width),
        "fc_w": ParamSpec((cfg.stage_widths[-1], cfg.num_classes),
                          "float32"),
        "fc_b": ParamSpec((cfg.num_classes,), "float32", "zeros"),
    }
    cin = cfg.stem_width
    for si, (n_blocks, width) in enumerate(zip(cfg.stage_sizes,
                                               cfg.stage_widths)):
        for bi in range(n_blocks):
            pre = f"s{si}b{bi}_"
            stride = 2 if (bi == 0 and si > 0) else 1
            specs[pre + "conv1"] = _conv_spec(3, 3, cin, width)
            specs[pre + "bn1"] = _bn_specs(width)
            specs[pre + "conv2"] = _conv_spec(3, 3, width, width)
            specs[pre + "bn2"] = _bn_specs(width)
            if stride != 1 or cin != width:
                specs[pre + "proj"] = _conv_spec(1, 1, cin, width)
                specs[pre + "proj_bn"] = _bn_specs(width)
            cin = width
    return specs


def init_resnet(cfg: ResNetConfig, seed: int, device="cuda") -> dict:
    """Draw the nested parameters (BN entries are dicts) from ``seed`` with
    a ``torch.Generator`` on ``device``, in name order."""
    dev = device_mod.resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    out: dict[str, Any] = {}
    for name, spec in sorted(resnet_specs(cfg).items()):
        if isinstance(spec, dict):
            out[name] = {k: draw_param(spec[k], gen, dev) for k in BN_KEYS}
        else:
            out[name] = draw_param(spec, gen, dev)
    return out


def params_from_jax(np_params: dict, device="cuda") -> dict:
    """The JAX package's nested ResNet parameters (numpy arrays, BN entries
    as dicts) as the port's tensors on ``device``, bit for bit."""
    dev = device_mod.resolve(device)
    return {k: ({kk: as_tensor(np.asarray(vv), dev) for kk, vv in v.items()}
                if isinstance(v, dict) else as_tensor(np.asarray(v), dev))
            for k, v in np_params.items()}


def _bn(x, p, eps=1e-5):
    inv = torch.rsqrt(p["var"] + eps)
    return (x - p["mean"]) * inv * p["scale"] + p["bias"]


def _conv(x, w, stride=1):
    return oplib.conv2d(x, w, {"stride": (stride, stride),
                               "padding": "SAME"})


def resnet_forward(cfg: ResNetConfig, params: dict, x: torch.Tensor,
                   softmax: bool = True) -> torch.Tensor:
    """The plain forward: x (N,H,W,3) float32 -> (N, classes)."""
    h = _conv(x, params["stem_conv"], stride=2)
    h = torch.relu(_bn(h, params["stem_bn"]))
    if cfg.image_size >= 64:
        h = oplib.maxpool(h, {"window": (3, 3), "stride": (2, 2),
                              "padding": "SAME"})
    for si, (n_blocks, width) in enumerate(zip(cfg.stage_sizes,
                                               cfg.stage_widths)):
        for bi in range(n_blocks):
            pre = f"s{si}b{bi}_"
            stride = 2 if (bi == 0 and si > 0) else 1
            res = h
            y = _conv(h, params[pre + "conv1"], stride)
            y = torch.relu(_bn(y, params[pre + "bn1"]))
            y = _conv(y, params[pre + "conv2"], 1)
            y = _bn(y, params[pre + "bn2"])
            if pre + "proj" in params:
                res = _bn(_conv(h, params[pre + "proj"], stride),
                          params[pre + "proj_bn"])
            h = torch.relu(y + res)
    h = torch.mean(h, dim=(1, 2))
    logits = h @ params["fc_w"] + params["fc_b"]
    return torch.softmax(logits, dim=-1) if softmax else logits


def fold_bn(params: dict, eps: float = 1e-5) -> dict:
    """Fold BN into per-channel (scale, shift) pairs for inference RCBs:
    ``{name}_scale``/``{name}_shift`` for every BN dict, every other entry
    as it is. The JAX package's float32 arithmetic in its order, so the
    pairs equal its pairs bit for bit."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict) and set(v) == set(BN_KEYS):
            inv = 1.0 / torch.sqrt(v["var"] + eps)
            out[k + "_scale"] = v["scale"] * inv
            out[k + "_shift"] = v["bias"] - v["mean"] * v["scale"] * inv
        else:
            out[k] = v
    return out
