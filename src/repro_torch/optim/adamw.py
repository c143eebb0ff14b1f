"""AdamW with global-norm clipping (the port's counterpart of
``repro.optim.adamw``).

The arithmetic is the JAX package's, written out: ``torch.optim.AdamW``
decays the weights as ``p *= 1 - lr * wd`` and adds ``eps`` after the
bias correction of the second moment's square root, which rounds
otherwise. Here the gradients are clipped by their global norm (fp32 sums
of squares a leaf, stacked and summed), the bias corrections are
``1 - b ** step`` in fp32, and each parameter takes ``p - lr * (mhat /
(sqrt(vhat) + eps) + wd * p)`` in fp32, cast back to its dtype. The
moments are fp32 whatever the parameters' dtype.

A parameter tree is a flat dict of tensors, as the port's models keep
them; leaves are taken in sorted key order, as ``jax.tree.leaves`` takes a
dict's. ``adamw_update`` writes the parameters and moments in place,
under ``torch.no_grad()``: the step of a 1.5B-parameter model then holds
one copy of each, not two.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models.common import ParamSpec, spec_tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    step: Any            # 0-d int32 tensor
    m: Any               # fp32 dict like params
    v: Any               # fp32 dict like params


def adamw_init_specs(param_specs) -> AdamWState:
    """Spec tree for the optimizer state: an int32 0-d step and fp32 zero
    moments shaped like the parameters. Moment axes rename ``fsdp`` ->
    ``opt_shard``: under the default rules both map to the data axis
    (ZeRO-3), but the ``train_zero1`` rule set replicates params over data
    while keeping moments sharded (ZeRO-1)."""
    def mom(s: ParamSpec) -> ParamSpec:
        axes = tuple("opt_shard" if a == "fsdp" else a for a in s.axes)
        return ParamSpec(s.shape, "float32", "zeros", axes=axes)
    return AdamWState(
        step=ParamSpec((), "int32", "zeros", axes=()),
        m=spec_tree_map(mom, param_specs),
        v=spec_tree_map(mom, param_specs),
    )


def adamw_init(params: dict) -> AdamWState:
    """Zero fp32 moments like ``params`` on their devices and an int32
    0-d step of 0 (what ``init_params`` makes of the JAX package's
    ``adamw_init_specs``: every spec there is zeros)."""
    dev = next(iter(params.values())).device
    zeros = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
             for k, v in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros,
                      v={k: torch.zeros_like(z) for k, z in zeros.items()})


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum, over the leaves in sorted key order, of each
    leaf's fp32 sum of squares."""
    with torch.no_grad():
        leaves = [torch.sum(torch.square(tree[k].float()))
                  for k in sorted(tree)]
        return torch.sqrt(torch.sum(torch.stack(leaves)))


def _placed_like(g, p):
    """A DTensor gradient placed as its parameter is (reduced onto the
    parameter's shards, ZeRO-style), so the update runs on the
    parameter's shards whatever placement the backward left; a plain
    gradient as it is."""
    if not is_dtensor(p) or tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def adamw_update(cfg: AdamWConfig, grads: dict, state: AdamWState,
                 params: dict, lr: torch.Tensor):
    """One AdamW step. ``lr`` is a 0-d fp32 tensor on the parameters'
    device. Writes ``params``, ``state.m`` and ``state.v`` in place and
    returns (params, AdamWState(step + 1, m, v), {"grad_norm",
    "clip_scale"}). Every constant that divides is a 0-d tensor on the
    device: CUDA divides by a host scalar by multiplying with its
    reciprocal."""
    with torch.no_grad():
        grads = {k: _placed_like(g, params[k]) for k, g in grads.items()}
        gnorm = global_norm(grads)
        scale = torch.clamp(gnorm.new_tensor(cfg.clip_norm) / (gnorm + 1e-9),
                            max=1.0)
        step = state.step + 1
        s32 = step.float()
        b1c = 1.0 - torch.pow(s32.new_tensor(cfg.b1), s32)
        b2c = 1.0 - torch.pow(s32.new_tensor(cfg.b2), s32)
        for k in sorted(params):
            p, m, v = params[k], state.m[k], state.v[k]
            g = grads[k].float() * scale
            m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
            v.mul_(cfg.b2).add_(torch.square(g).mul_(1.0 - cfg.b2))
            del g
            p32 = p.float()
            delta = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
            delta.add_(cfg.weight_decay * p32)
            p.copy_(p32 - delta.mul_(lr))
    return params, AdamWState(step, state.m, state.v), {
        "grad_norm": gnorm, "clip_scale": scale}
