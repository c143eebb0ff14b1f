"""Pipeline parallelism (GPipe schedule) over ``torch.distributed`` (the
port's counterpart of ``repro.distributed.pipeline``).

The production meshes dedicate their axes to DP/FSDP x TP, so the dry run
does not use PP; this module provides the stage-parallel schedule for
deployments that add a stage axis. Each rank of ``group`` is one stage;
microbatches stream through the stages over a ring of point-to-point
hops (``batch_isend_irecv``, the reference's ``ppermute``); the bubble
fraction is the usual (S-1)/(M+S-1).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _index(tree, i: int):
    """Stage ``i``'s slice of a stacked parameter tree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _ring_hop(y: torch.Tensor, group, idx: int, n: int) -> torch.Tensor:
    """Send ``y`` to the next stage and take the previous stage's; at one
    stage the hop is the identity (the reference's pair (0, 0))."""
    if n == 1:
        return y
    nxt, prv = (idx + 1) % n, (idx - 1) % n
    if group is not None:
        nxt = dist.get_global_rank(group, nxt)
        prv = dist.get_global_rank(group, prv)
    y = y.contiguous()
    buf = torch.empty_like(y)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, y, nxt, group),
                                   dist.P2POp(dist.irecv, buf, prv, group)])
    for r in reqs:
        r.wait()
    return buf


def pipeline_forward(stage_fn, group=None):
    """Build fn(stage_params, microbatches) -> outputs, run on every rank.

    ``stage_params``: a tensor or dict of tensors with a leading stage dim
    (this rank takes its own slice). ``microbatches``: (M, mb, ...) the
    same on every rank. ``stage_fn(params_i, x) -> y`` with y.shape ==
    x.shape. Every rank returns all M outputs."""
    def run(stage_params, mbs: torch.Tensor) -> torch.Tensor:
        n = dist.get_world_size(group)
        idx = dist.get_rank(group)
        params_local = _index(stage_params, idx)
        M = mbs.shape[0]
        T = M + n - 1
        state = torch.zeros(mbs.shape[1:], dtype=mbs.dtype,
                            device=mbs.device)       # stage input register
        outs = torch.zeros_like(mbs)
        for t in range(T):
            # stage 0 ingests microbatch t (if any); others take the wire
            x = mbs[min(t, M - 1)] if idx == 0 else state
            y = stage_fn(params_local, x)
            # push to next stage over the ring
            nxt = _ring_hop(y, group, idx, n)
            # last stage commits microbatch (t - (n-1)) when valid
            commit = t - (n - 1)
            if idx == n - 1 and 0 <= commit < M:
                outs[commit] = y
            state = nxt
        # everyone but the last stage holds zeros; the sum broadcasts it
        if idx != n - 1:
            outs = torch.zeros_like(outs)
        dist.all_reduce(outs, group=group)
        return outs

    return run
