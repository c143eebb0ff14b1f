"""Runtime Binding Layer — symbolic -> physical resolution.

The port's counterpart of ``repro.core.rbl``:

  * **Data binding** — weight symbols resolve to zero-copy RIMFS views,
    pinned once on the driver's device when a driver is given; caller
    inputs bind to their symbols.
  * **Address resolution** — inside an ``axis_rules`` binding each
    TensorDesc's logical axes resolve to ``(mesh, placements)`` through
    the shape-aware rule engine (``distributed/sharding.py``); outside one,
    and for a tensor without axes, to ``None``.
  * **Dependency & buffer management** — liveness intervals over the
    linear op stream; scratch is released after its last read.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.rcb import Op, RCBProgram
from repro_torch.core.rimfs import RIMFS
from repro_torch.distributed.sharding import sharding_for


@dataclasses.dataclass
class BoundProgram:
    program: RCBProgram
    buffers: dict                    # symbol -> host/device buffer
    last_use: dict                   # symbol -> linear op index of last read
    shardings: dict                  # symbol -> (mesh, placements) or None
    missing_inputs: tuple            # input symbols the caller must feed


def liveness(program: RCBProgram) -> dict:
    """Last linear-op index at which each symbol is read."""
    last: dict[str, int] = {}
    for i, op in enumerate(program.ops()):
        for s in op.srcs:
            last[s] = i
    return last


def explicitly_freed(program: RCBProgram) -> set:
    """Symbols released by an explicit FREE op (driver-managed lifetime)."""
    return {op.dsts[0] for op in program.ops()
            if op.op is Op.FREE and op.dsts}


def scratch_free_lists(program: RCBProgram,
                       last_use: Optional[dict] = None) -> list:
    """Per-linear-op tuples of scratch symbols whose last read is that op —
    the release schedule the linker bakes into each thunk. Symbols with an
    explicit FREE op are excluded: their release belongs to the driver."""
    last_use = liveness(program) if last_use is None else last_use
    explicit = explicitly_freed(program)
    n_ops = sum(len(b.ops) for b in program.blocks)
    frees: list[list] = [[] for _ in range(n_ops)]
    for sym, idx in last_use.items():
        t = program.tensors.get(sym)
        if t is not None and t.kind == "scratch" and sym not in explicit:
            frees[idx].append(sym)
    return [tuple(f) for f in frees]


def resolve_shardings(program: RCBProgram) -> dict:
    out = {}
    for name, t in program.tensors.items():
        if t.axes:
            out[name] = sharding_for(t.shape, t.axes)
        else:
            out[name] = None
    return out


def bind(program: RCBProgram,
         rimfs: Optional[RIMFS] = None,
         inputs: Optional[dict] = None,
         driver=None, weights: Optional[dict] = None) -> BoundProgram:
    """Produce a fully resolved program (the paper's Binding phase).

    With a driver, weights resolve through the image's per-driver residency
    cache: the first bind pins this program's weight files on the driver's
    device ONCE; later binds reuse the pinned buffers and move zero bytes.
    Without one they stay zero-copy host views (usable on the CPU only).
    Every weight file's CRC is checked on its first read. ``weights``
    supplies already-resolved weight buffers (a tile program re-bound from
    an earlier bind's buffers needs no image)."""
    program.validate()
    inputs = inputs or {}
    weights = weights or {}
    buffers: dict = {}
    missing = []
    unresolved = [n for n, t in program.tensors.items()
                  if t.kind == "weight" and n not in weights]
    resident = None
    if unresolved and rimfs is None:
        raise ValueError(f"weight {unresolved[0]!r} needs a RIMFS image")
    if driver is not None and unresolved:
        resident = rimfs.resident(driver, names=unresolved)
    for name, t in program.tensors.items():
        if t.kind == "weight":
            if name in weights:
                buffers[name] = weights[name]       # caller-resolved
            elif resident is not None:
                buffers[name] = resident[name]      # pinned device buffer
            else:
                buffers[name] = rimfs.read(name)    # zero-copy host view
        elif t.kind == "input":
            if name in inputs:
                buffers[name] = inputs[name]
            else:
                missing.append(name)
    return BoundProgram(program, buffers, liveness(program),
                        resolve_shardings(program), tuple(missing))


def rebind(bound: BoundProgram, **updates) -> BoundProgram:
    """Elastic re-binding: same control stream, new physical resources."""
    buffers = dict(bound.buffers)
    buffers.update(updates.get("buffers", {}))
    return BoundProgram(bound.program, buffers, bound.last_use,
                        resolve_shardings(bound.program),
                        bound.missing_inputs)
