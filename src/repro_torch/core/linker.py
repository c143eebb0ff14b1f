"""Program linker — the compiled RCB dispatch + data-movement path.

The port's counterpart of ``repro.core.linker``. The interpreted executor
re-decodes every op on every step; the linker pays those costs ONCE:

  * every symbolic tensor ref resolves to an index into a dense slot array;
  * every opcode resolves to a handler through the RHAL ``link_compute``
    slot (for kernel opcodes, the kernel registry's handler);
  * every scratch release point is baked in as a precomputed free-list;
  * every transfer is scheduled by a static **residency plan**
    (``plan_residency``): arena offsets from a simulated first-fit walk over
    the RBL liveness intervals, H2D transfers whose source is live at entry
    hoisted into a prefetch prologue, D2H transfers nothing re-reads sunk
    into a drain epilogue.

The result is a ``LinkedProgram`` whose execution is
``prologue; for thunk in thunks: thunk(slots, rimfs); epilogue`` — see
``Executor.run``. ``stage_callable`` wraps the same walk as a function of
the inputs and weights alone, which ``Executor.fuse`` captures into a CUDA
graph and ``Executor.run_batched`` maps over a batch axis first
(``batch_analysis`` says which programs may).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Optional

from repro_torch.core import rbl as rbl_mod
from repro_torch.core.rcb import Op, RCBProgram
from repro_torch.core.rhal import (ARENA_ALIGN, DeviceArena, DmaTicket,
                                   _nbytes_of)


@dataclasses.dataclass(frozen=True)
class ResidencyPlan:
    """Static buffer-residency + transfer schedule for one LinkedProgram.

    Computed once at link time from the RBL liveness intervals — never per
    dispatch (DESIGN.md §6). Offsets come from a simulated first-fit
    ``DeviceArena`` walk, so ``high_water`` is exactly the peak the arena
    would reach replaying the program's alloc/free sequence.
    """
    offsets: dict            # device-resident symbol -> arena offset
    sizes: dict              # symbol -> aligned nbytes
    high_water: int          # peak arena bytes over the program
    arena_align: int
    prefetch_syms: tuple     # DMA_H2D dsts issued in the prologue
    drain_syms: tuple        # DMA_D2H dsts redeemed in the epilogue
    donated: tuple           # scratch syms whose dead range a later alloc reuses
    bytes_moved: int         # total DMA payload bytes per execution
    bytes_overlapped: int    # bytes issued split-phase (overlap-eligible)


def plan_residency(bound: rbl_mod.BoundProgram) -> ResidencyPlan:
    """Simulate device residency over the linear op stream.

    Weights pin at offset order 0..n at program entry (the RIMFS residency
    set); scratch/output ranges allocate at first definition and scratch
    frees at last read (the same schedule the thunk free-lists apply);
    outputs stay live to program exit.  Host-side symbols (inputs and
    DMA_D2H destinations) never enter the arena.
    """
    prog = bound.program
    last_use = bound.last_use
    ops = list(prog.ops())

    d2h_dsts = {op.dsts[0] for op in ops if op.op is Op.DMA_D2H}
    written_before: set = set()
    prefetch, drain = [], []
    bytes_moved = bytes_overlapped = 0
    for i, op in enumerate(ops):
        if op.op in (Op.DMA_H2D, Op.DMA_D2H, Op.DMA_D2D):
            t = prog.tensors.get(op.srcs[0])
            nbytes = _nbytes_of(t.shape, t.dtype) if t is not None else 0
            bytes_moved += nbytes
            if op.op is Op.DMA_H2D and op.srcs[0] not in written_before:
                # source is live at program entry -> issue in the prologue
                prefetch.append(op.dsts[0])
                bytes_overlapped += nbytes
            elif op.op is Op.DMA_D2H and last_use.get(op.dsts[0], -1) <= i:
                # nothing re-reads the host copy -> redeem at the drain
                drain.append(op.dsts[0])
                bytes_overlapped += nbytes
        written_before.update(op.dsts)

    def resident(sym: str) -> bool:
        t = prog.tensors.get(sym)
        return (t is not None and t.kind != "input" and sym not in d2h_dsts)

    sizes = {n: _nbytes_of(t.shape, t.dtype)
             for n, t in prog.tensors.items() if resident(n)}
    total = sum(max(ARENA_ALIGN, ((s + ARENA_ALIGN - 1) // ARENA_ALIGN)
                    * ARENA_ALIGN) for s in sizes.values())
    arena = DeviceArena(max(total, ARENA_ALIGN) + ARENA_ALIGN)
    offsets: dict[str, int] = {}
    freed_at: dict[str, tuple] = {}      # sym -> (offset, size, op index)
    donated: list = []
    for name, t in prog.tensors.items():             # weights pin first
        if t.kind == "weight" and resident(name):
            offsets[name] = arena.alloc(sizes[name])
    frees_by_idx = rbl_mod.scratch_free_lists(prog, last_use)
    for i, op in enumerate(ops):
        for dst in op.dsts:
            if op.op is not Op.FREE and resident(dst) \
                    and dst not in offsets:
                off = arena.alloc(sizes[dst])
                offsets[dst] = off
                for sym, (foff, fsz, fidx) in freed_at.items():
                    if sym not in donated and fidx < i \
                            and off < foff + fsz \
                            and foff < off + sizes[dst]:
                        donated.append(sym)          # dead range reused
        released = list(frees_by_idx[i])
        if op.op is Op.FREE and op.dsts[0] in offsets:
            released.append(op.dsts[0])
        for sym in released:
            if sym in offsets and sym not in freed_at:
                arena.free(offsets[sym])
                freed_at[sym] = (offsets[sym], arena._round(sizes[sym]), i)
    return ResidencyPlan(offsets, sizes, arena.high_water, ARENA_ALIGN,
                         tuple(prefetch), tuple(drain), tuple(donated),
                         bytes_moved, bytes_overlapped)


@dataclasses.dataclass
class LinkedProgram:
    """A BoundProgram lowered to positional, pre-resolved form."""
    program: RCBProgram
    driver: Any
    slot_of: dict                  # symbol -> dense slot index
    names: list                    # slot index -> symbol
    thunks: list                   # thunk(slots, rimfs) -> None
    block_spans: list              # (block_id, thunk_start, thunk_end)
    input_slots: dict              # input symbol -> slot
    weight_slots: dict             # weight symbol -> slot
    output_slots: tuple            # (symbol, slot) pairs
    missing_inputs: tuple          # (symbol, slot) the caller must feed
    free_lists: tuple              # per-thunk tuple of slot indices released
    n_compute: int                 # compute dispatches (bulk stats update)
    residency: Optional[ResidencyPlan] = None
    prologue: tuple = ()           # prefetch issue thunks (run before thunks)
    epilogue: tuple = ()           # drain redeem thunks (run after thunks)
    dst_lists: tuple = ()          # per-thunk tuple of slot indices written

    @property
    def n_slots(self) -> int:
        return len(self.names)

    def fresh_slots(self, buffers: dict,
                    inputs: Optional[dict] = None) -> list:
        """Dense buffer array for one execution."""
        slots: list = [None] * len(self.names)
        slot_of = self.slot_of
        for sym, buf in buffers.items():
            slots[slot_of[sym]] = buf
        if inputs:
            for sym, buf in inputs.items():
                i = slot_of.get(sym)
                if i is not None:
                    slots[i] = buf
        return slots


def _mk_compute(handler: Callable, d: int, src_idx: tuple, frees: tuple):
    """Compute thunk factory, arity-specialized for the hot loop."""
    if len(src_idx) == 1:
        (i0,) = src_idx

        def thunk(slots, rimfs):
            slots[d] = handler(slots[i0])
            for f in frees:
                slots[f] = None
    elif len(src_idx) == 2:
        i0, i1 = src_idx

        def thunk(slots, rimfs):
            slots[d] = handler(slots[i0], slots[i1])
            for f in frees:
                slots[f] = None
    elif len(src_idx) == 3:
        i0, i1, i2 = src_idx

        def thunk(slots, rimfs):
            slots[d] = handler(slots[i0], slots[i1], slots[i2])
            for f in frees:
                slots[f] = None
    else:
        def thunk(slots, rimfs):
            slots[d] = handler(*[slots[i] for i in src_idx])
            for f in frees:
                slots[f] = None
    return thunk


@dataclasses.dataclass(frozen=True)
class BatchAnalysis:
    """Verdict of the per-program batch-axis analysis."""
    batchable: bool
    reason: str


def batch_analysis(bound: rbl_mod.BoundProgram) -> BatchAnalysis:
    """Decide whether a program can stage under a leading batch axis.

    The batched path runs the staged linked form under ``torch.func.vmap``
    (inputs mapped, weights broadcast), which is only sound for programs
    whose every op is a pure device computation per sample:

      * COLLECTIVE ops coordinate across a mesh axis — a mapped replica
        would silently change the collective's participant set;
      * GRAPH_EXEC artifacts are opaque host callables written for one
        batch shape (and are not covered by the program CRC the staging
        cache keys on);
      * split-phase DMA (any H2D the residency plan hoists into the
        prefetch prologue, or D2H it sinks into the drain epilogue)
        carries per-execution host-side ticket state — the host engine
        moves ONE buffer per descriptor, not a batch-of-N.

    Everything else (compute dispatches, ALLOC/FREE, BIND_CONST, FENCE,
    POLL, non-split-phase transfers) stages cleanly. The verdict and its
    reason strings are the JAX package's; it is cached on the
    BoundProgram. ``Executor.run_batched`` runs a refused program
    serially.
    """
    cached = getattr(bound, "_batch_analysis", None)
    if cached is not None:
        return cached

    def analyze() -> BatchAnalysis:
        for op in bound.program.ops():
            if op.op is Op.COLLECTIVE:
                return BatchAnalysis(False, "COLLECTIVE op (mesh-axis "
                                     "semantics do not vmap)")
            if op.op is Op.GRAPH_EXEC:
                return BatchAnalysis(False, "GRAPH_EXEC artifact (opaque "
                                     "host callable, fixed batch shape)")
        plan = plan_residency(bound)
        if plan.prefetch_syms or plan.drain_syms:
            syms = (plan.prefetch_syms + plan.drain_syms)[:3]
            return BatchAnalysis(False, "host split-phase DMA (prefetch/"
                                 f"drain schedule over {list(syms)})")
        return BatchAnalysis(True, "batchable")

    verdict = analyze()
    bound._batch_analysis = verdict
    return verdict


def stage_callable(linked: LinkedProgram):
    """The staged form of a linked program: ``fn(inputs, weights) -> outs``.

    ``Executor.fuse`` captures this function into one CUDA graph, and
    ``Executor.run_batched`` wraps it in ``torch.func.vmap`` (inputs mapped
    over a leading batch axis, weights broadcast) before capturing one
    graph per batch bucket. Linked against the capture driver
    (``rhal.make_capture_driver``), it syncs nothing and reads nothing back
    to the host, so every op it runs can be captured.
    """
    weight_slots = linked.weight_slots
    input_slots = linked.input_slots
    thunks = linked.thunks
    output_slots = linked.output_slots
    n_slots = linked.n_slots
    prologue = linked.prologue
    epilogue = linked.epilogue

    def staged(inputs: dict, weights: dict) -> dict:
        slots: list = [None] * n_slots
        for k, i in weight_slots.items():
            slots[i] = weights[k]
        for k, i in input_slots.items():
            slots[i] = inputs[k]
        for pre in prologue:
            pre(slots, None)
        for thunk in thunks:
            thunk(slots, None)
        for epi in epilogue:
            epi(slots, None)
        return {name: slots[i] for name, i in output_slots
                if slots[i] is not None}

    return staged


def link(bound: rbl_mod.BoundProgram, driver,
         artifacts: Optional[dict] = None) -> LinkedProgram:
    """Lower a BoundProgram into a LinkedProgram against one driver.

    Linking is pure resolution — no device work happens here (a kernel
    library builds at its first launch; DMA issue happens when the
    prologue runs, not when it is built).
    """
    prog = bound.program
    names = list(prog.tensors.keys())
    slot_of = {n: i for i, n in enumerate(names)}
    frees_by_idx = rbl_mod.scratch_free_lists(prog, bound.last_use)
    link_compute = driver.link_compute
    artifacts = {**prog.artifacts, **(artifacts or {})}
    plan = plan_residency(bound)
    use_async = driver.dma_async is not None and driver.dma_wait is not None
    if not use_async:
        # blocking driver: nothing issues split-phase, so the attached
        # plan must not advertise overlap this link will never execute
        plan = dataclasses.replace(plan, prefetch_syms=(), drain_syms=(),
                                   bytes_overlapped=0)
    prefetch_syms = set(plan.prefetch_syms)
    drain_syms = set(plan.drain_syms)
    dma_async, dma_redeem = driver.dma_async, driver.dma_wait

    thunks: list = []
    block_spans: list = []
    prefetch_entries: list = []                    # (dst_slot, src_slot, sym)
    epilogue: list = []
    n_compute = 0
    free_lists: list = []
    dst_lists: list = []
    idx = 0                                        # linear op index
    for block in prog.blocks:
        start = len(thunks)
        for op in block.ops:
            kind = op.op
            frees = tuple(slot_of[s] for s in frees_by_idx[idx])
            idx += 1
            if kind is Op.NOP or kind is Op.HALT:
                continue                           # zero dispatch cost
            dslots = tuple(slot_of[d] for d in op.dsts)
            sslots = tuple(slot_of[s] for s in op.srcs)
            attrs = op.attrs
            if kind is Op.ALLOC:
                shape = tuple(attrs["shape"])
                dtype = attrs["dtype"]
                alloc = driver.alloc
                d = dslots[0]

                def thunk(slots, rimfs, _a=alloc, _d=d, _sh=shape,
                          _dt=dtype):
                    slots[_d] = _a(_sh, _dt)
            elif kind is Op.FREE:
                free = driver.free
                d = dslots[0]

                def thunk(slots, rimfs, _f=free, _d=d):
                    _f(slots[_d])
                    slots[_d] = None
            elif kind is Op.BIND_CONST:
                bind_const = driver.bind_const
                value = attrs["value"]
                d = dslots[0]

                def thunk(slots, rimfs, _b=bind_const, _d=d, _v=value):
                    slots[_d] = _b(_v)
            elif kind is Op.DMA_H2D:
                d, s, sname = dslots[0], sslots[0], op.srcs[0]
                if use_async and op.dsts[0] in prefetch_syms:
                    # split phase: issue in the prologue (before the first
                    # compute dispatch), redeem the ticket at the op site —
                    # the transfer rides under every dispatch in between.
                    prefetch_entries.append((d, s, sname))

                    def thunk(slots, rimfs, _w=dma_redeem, _ia=dma_async,
                              _d=d, _s=s, _n=sname, _fr=frees):
                        t = slots[_d]
                        if type(t) is DmaTicket:
                            slots[_d] = _w(t)
                        else:                      # prologue skipped
                            host = slots[_s]
                            if host is None and rimfs is not None:
                                host = rimfs.read(_n)
                            slots[_d] = _w(_ia(host, "h2d"))
                        for f in _fr:
                            slots[f] = None
                elif use_async:
                    def thunk(slots, rimfs, _w=dma_redeem, _ia=dma_async,
                              _d=d, _s=s, _n=sname, _fr=frees):
                        host = slots[_s]
                        if host is None and rimfs is not None:
                            host = rimfs.read(_n)
                        slots[_d] = _w(_ia(host, "h2d"))
                        for f in _fr:
                            slots[f] = None
                else:
                    initiate, wait = driver.initiate_dma, driver.wait_dma

                    def thunk(slots, rimfs, _i=initiate, _w=wait, _d=d,
                              _s=s, _n=sname, _fr=frees):
                        host = slots[_s]
                        if host is None and rimfs is not None:
                            host = rimfs.read(_n)
                        slots[_d] = _w(_i(host, "h2d"))
                        for f in _fr:
                            slots[f] = None
            elif kind is Op.DMA_D2H and use_async \
                    and op.dsts[0] in drain_syms:
                d, s = dslots[0], sslots[0]
                # issue here, redeem in the epilogue: the device->host copy
                # of op k-1 completes under op k's compute.
                def thunk(slots, rimfs, _ia=dma_async, _d=d, _s=s,
                          _fr=frees):
                    slots[_d] = _ia(slots[_s], "d2h", prefetched=True)
                    for f in _fr:
                        slots[f] = None

                def epi(slots, rimfs, _w=dma_redeem, _d=d):
                    t = slots[_d]
                    if type(t) is DmaTicket:
                        slots[_d] = _w(t)
                epilogue.append(epi)
            elif kind is Op.DMA_D2H or kind is Op.DMA_D2D:
                direction = "d2h" if kind is Op.DMA_D2H else "d2d"
                d, s = dslots[0], sslots[0]
                if use_async:
                    def thunk(slots, rimfs, _w=dma_redeem, _ia=dma_async,
                              _d=d, _s=s, _dir=direction, _fr=frees):
                        slots[_d] = _w(_ia(slots[_s], _dir))
                        for f in _fr:
                            slots[f] = None
                else:
                    initiate, wait = driver.initiate_dma, driver.wait_dma

                    def thunk(slots, rimfs, _i=initiate, _w=wait, _d=d,
                              _s=s, _dir=direction, _fr=frees):
                        slots[_d] = _w(_i(slots[_s], _dir))
                        for f in _fr:
                            slots[f] = None
            elif kind is Op.GRAPH_EXEC:
                fn = artifacts.get(attrs["artifact"])
                if fn is None:
                    raise KeyError(
                        f"GRAPH_EXEC artifact {attrs['artifact']!r} "
                        f"not attached")
                if len(dslots) == 1:
                    d = dslots[0]

                    def thunk(slots, rimfs, _f=fn, _d=d, _s=sslots,
                              _fr=frees):
                        slots[_d] = _f(*[slots[i] for i in _s])
                        for f in _fr:
                            slots[f] = None
                else:
                    def thunk(slots, rimfs, _f=fn, _ds=dslots, _s=sslots,
                              _fr=frees):
                        outs = _f(*[slots[i] for i in _s])
                        for d, o in zip(_ds, outs):
                            slots[d] = o
                        for f in _fr:
                            slots[f] = None
            elif kind is Op.COLLECTIVE:
                coll = driver.collective
                ckind = attrs.get("kind", "all_reduce")
                d, s = dslots[0], sslots[0]

                def thunk(slots, rimfs, _c=coll, _k=ckind, _d=d, _s=s,
                          _at=attrs, _fr=frees):
                    slots[_d] = _c(_k, slots[_s], _at)
                    for f in _fr:
                        slots[f] = None
            elif kind is Op.FENCE:
                fence = driver.fence

                def thunk(slots, rimfs, _f=fence):
                    _f([b for b in slots
                        if b is not None and type(b) is not DmaTicket])
            elif kind is Op.POLL:
                poll = driver.poll
                s = sslots[0] if sslots else None

                def thunk(slots, rimfs, _p=poll, _s=s):
                    _p(slots[_s] if _s is not None else None)
            else:                                  # compute dispatch
                if link_compute is not None:
                    # (opcode, attrs) sites repeat across layers, tiles of
                    # a partitioned program, and re-links after elasticity
                    # events — resolve each distinct site ONCE per driver
                    key = (int(kind), json.dumps(attrs, sort_keys=True,
                                                 default=repr))
                    handler = driver.link_cache.get(key)
                    if handler is None:
                        handler = link_compute(kind, attrs)
                        driver.link_cache[key] = handler
                    # specialized handlers bypass dispatch_compute, so the
                    # executor bulk-updates the driver's dispatch stat;
                    # the fallback below counts itself per call
                    n_compute += 1
                else:
                    dispatch = driver.dispatch_compute

                    def handler(*srcs, _dc=dispatch, _k=kind, _at=attrs):
                        return _dc(_k, list(srcs), _at)
                thunk = _mk_compute(handler, dslots[0], sslots, frees)
            if frees and kind in (Op.ALLOC, Op.FREE, Op.BIND_CONST,
                                  Op.FENCE, Op.POLL):
                # these thunks don't apply free-lists themselves, but a POLL
                # can be a scratch symbol's last reader — chain the release
                # so linked matches the interpreted liveness plan.  (NOP/
                # HALT read nothing, so their frees are always empty.)
                inner = thunk

                def thunk(slots, rimfs, _i=inner, _fr=frees):
                    _i(slots, rimfs)
                    for f in _fr:
                        slots[f] = None
            thunks.append(thunk)
            free_lists.append(frees)
            dst_lists.append(dslots)
        block_spans.append((block.block_id, start, len(thunks)))

    prologue: list = []
    if prefetch_entries:
        batch = driver.dma_async_batch
        if batch is not None:
            # the whole prefetch stream issues under ONE engine call: n
            # transfers, one descriptor (paper §5.3 batching)
            def pro(slots, rimfs, _ia=batch, _es=tuple(prefetch_entries)):
                hosts = []
                for _, s_, n_ in _es:
                    host = slots[s_]
                    if host is None and rimfs is not None:
                        host = rimfs.read(n_)
                    hosts.append(host)
                for (d_, _, _), t in zip(_es, _ia(hosts, "h2d",
                                                  prefetched=True)):
                    slots[d_] = t
            prologue.append(pro)
        else:
            for d_, s_, n_ in prefetch_entries:
                def pro(slots, rimfs, _ia=dma_async, _d=d_, _s=s_, _n=n_):
                    host = slots[_s]
                    if host is None and rimfs is not None:
                        host = rimfs.read(_n)
                    slots[_d] = _ia(host, "h2d", prefetched=True)
                prologue.append(pro)

    output_slots = tuple((n, slot_of[n]) for n, t in prog.tensors.items()
                         if t.kind == "output")
    missing = tuple((n, slot_of[n]) for n in bound.missing_inputs)
    input_slots = {n: slot_of[n] for n, t in prog.tensors.items()
                   if t.kind == "input"}
    weight_slots = {n: slot_of[n] for n, t in prog.tensors.items()
                    if t.kind == "weight"}
    return LinkedProgram(prog, driver, slot_of, names, thunks, block_spans,
                         input_slots, weight_slots, output_slots, missing, tuple(free_lists),
                         n_compute, plan, tuple(prologue), tuple(epilogue),
                         tuple(dst_lists))
