"""The weights of a run, drawn on the device from ``--seed``.

Every tensor of the port's ``model_specs`` (names, shapes, dtypes) is a
view into one flat buffer per (dtype, draw), each filled by one call of a
``torch.Generator`` on the device, in the dtype the model is served in;
the views are then scaled in place. The port and the reference get the
same tensors.

Draws, by the spec's init kind: ``normal`` N(0, 1) / sqrt(fan_in), fan_in
the input width of the product the weight takes part in (not the port's
``shape[-2]``, which gives a (d, H, D) projection a fan-in of H and
scores of some hundreds); ``embed`` N(0, 1) / sqrt(d); ``uniform`` U(-1,
1) * scale; ``decay`` -6 + 5 U(0, 1) (rwkv's decay base); ``ones`` and
``zeros`` as named.
"""
from __future__ import annotations

import math

import torch

RANDN = ("normal", "embed")
RAND = ("uniform", "decay")


def fan_in(name: str, shape: tuple) -> int:
    """The input width of the product a ``normal`` weight takes part in:
    a stacked (L, in, ...) weight's dim 1, except an output projection
    over heads (L, H, D, d), whose input is H * D; an unstacked (in, out)
    weight's dim 0."""
    if len(shape) == 2:
        return shape[0]
    if name == "wo" and len(shape) == 4:
        return shape[1] * shape[2]
    return shape[1]


def draw(specs: dict, seed: int, device) -> dict:
    """``{name: tensor}`` for every spec, drawn from ``seed`` on
    ``device``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    groups: dict = {}
    for name in sorted(specs):
        s = specs[name]
        if s.init in RANDN + RAND:
            groups.setdefault((s.dtype, s.init in RANDN), []).append(name)
        elif s.init not in ("ones", "zeros"):
            raise ValueError(f"{name}: unknown init {s.init!r}")
    out = {}
    for (dtype, normal), names in sorted(groups.items()):
        dt = getattr(torch, dtype)
        total = sum(math.prod(specs[n].shape) for n in names)
        flat = torch.empty(total, dtype=dt, device=dev)
        if normal:
            flat.normal_(generator=gen)
        else:
            flat.uniform_(generator=gen)
        off = 0
        for n in names:
            s = specs[n]
            size = math.prod(s.shape)
            v = flat[off:off + size].view(s.shape)
            off += size
            if s.init == "normal":
                v.mul_(s.scale / math.sqrt(fan_in(n, s.shape)))
            elif s.init == "embed":
                v.mul_(s.shape[-1] ** -0.5)
            elif s.init == "uniform":
                v.mul_(2.0).sub_(1.0).mul_(s.scale)
            else:                                   # decay
                v.mul_(5.0).sub_(6.0)
            out[n] = v
    for name in sorted(specs):
        s = specs[name]
        if s.init == "ones":
            out[name] = torch.ones(s.shape, dtype=getattr(torch, s.dtype),
                                   device=dev)
        elif s.init == "zeros":
            out[name] = torch.zeros(s.shape, dtype=getattr(torch, s.dtype),
                                    device=dev)
    return out
