"""Per-device cost accounting of one traced step: the port's stand-in for
XLA's ``cost_analysis``, ``memory_analysis`` and the dry run's parse of the
optimized HLO's collectives.

``CostMode`` is a dispatch mode. On an op whose arguments are DTensors it
steps aside, so DTensor first turns the op into each rank's local ops and
collectives; the mode then sees those, on this rank's shards:

* **FLOPs** — torch's ``flop_counter`` formulas (matmuls, convolutions,
  attention) and the hand kernels' own (``flash_attention``, ``ssm_scan``,
  ``wkv6``), on the local shapes. That is each op's global count divided
  by the mesh dims its output is ``Shard`` or ``Partial`` on; a
  ``Replicate`` dim computes redundantly. Elementwise ops count none.
* **Bytes** — per op, its local tensor inputs and outputs (views,
  factories and collectives move none).
* **Collectives** — operand bytes and counts in the reference's five kinds.
* **Memory** — the peak of live op outputs (``temp_bytes``), tracked with
  a ``weakref`` finalizer on each output: the port's own reckoning, not
  comparable to XLA's buffer assignment.

It works on ``meta`` tensors (nothing is allocated) and on a card's, where
the counts of a step must equal those of the same step on ``meta``.
"""
from __future__ import annotations

import weakref

import torch
from torch._guards import detect_fake_mode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "wait_tensor", "_wrap_tensor_autograd"}


def tensor_bytes(t) -> int:
    """Bytes of ``t``'s elements; a DTensor's local shard's."""
    local = getattr(t, "_local_tensor", t)
    return local.numel() * local.element_size()


def tree_tensors(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples (named or not)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree, key=str) for t in
                tree_tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_tensors(v)]
    return []


def tree_bytes(tree) -> int:
    return sum(tensor_bytes(t) for t in tree_tensors(tree))


def _is_view(func) -> bool:
    """The op returns an alias of an input that it does not write."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


class CostMode(TorchDispatchMode):
    """Counts FLOPs, bytes, collectives and live memory of the ops run
    under it on this rank (see the module docstring), on tensors of
    ``device_type`` only: DTensor's sharding propagation runs small ops of
    its own the first time it meets an op, on the CPU."""

    def __init__(self, device_type: str):
        super().__init__()
        self.device_type = device_type
        from torch.distributed.tensor import DTensor
        self._dtensor = DTensor
        self.flops = 0
        self.bytes = 0
        self.coll_bytes = {k: 0 for k in KINDS}
        self.coll_counts = {k: 0 for k in KINDS}
        self.live = 0
        self.peak = 0

    def _release(self, n: int) -> None:
        self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        n = tensor_bytes(t)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._release, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented          # DTensor desugars it first
        out = func(*args, **kwargs)
        if detect_fake_mode((args, kwargs)) is not None:
            return out       # DTensor inferring an output's shape, not a step
        ins = tree_tensors((args, kwargs))
        if not any(t.device.type == self.device_type
                   for t in ins + tree_tensors(out)):
            return out
        name = func._overloadpacket.__name__
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            self.coll_bytes[kind] += tensor_bytes(ins[0])
            self.coll_counts[kind] += 1
            return out
        if func._overloadpacket in flop_registry:
            self.flops += int(flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
        if _is_view(func) or name in _NO_BYTES:
            return out
        outs = [t for t in tree_tensors(out)
                if not any(t is i for i in ins)]
        self.bytes += sum(tensor_bytes(t) for t in ins + outs)
        for t in outs:
            self._track(t)
        return out

    def record(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": {"bytes": dict(self.coll_bytes),
                                "counts": dict(self.coll_counts),
                                "total_bytes": sum(self.coll_bytes.values())},
                "temp_bytes": self.peak}

