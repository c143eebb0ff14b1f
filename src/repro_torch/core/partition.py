"""Partitioned multi-tile execution — the paper's array-of-tiles shape.

The port's counterpart of ``repro.core.partition``. The paper runs
ResNet-18 over an array of tiles, each tile group owning a contiguous run of
layers and streaming its boundary activations to the next group. Here:

  * ``partition`` cuts a bound program into per-group ``TileProgram``s at
    RCB block boundaries when the program has enough blocks, by balanced
    linear-op splits otherwise. A symbol defined in group *f* and read in
    group *g* > *f* is a **cut edge**: an output of *f*'s subprogram, an
    input of *g*'s. The cut is data: its tables and each tile's bytes equal
    the JAX package's.
  * Each ``TileProgram`` is a standalone, validated ``RCBProgram``: bound
    against its group's driver, RIMFS residency pins only that group's
    weights into that group's arena.
  * ``execute`` runs the stages in order over a ``TileMesh``. On one card a
    group is a logical partition with its own CUDA stream, so each stage's
    kernels queue on its group's stream; when stage *k* completes its cut
    edges are issued split-phase on its stream (``TileMesh.stream``) and
    redeemed only when the consuming stage starts, whose stream then waits
    on the producer's event. With an RTPM ``Platform`` every group is a
    heartbeat-monitored worker and a failed stage re-queues on a surviving
    group (the ``TileFailure`` path, and only it: nothing re-runs on the
    CPU or on the plain kernels).
  * ``execute_stream`` software-pipelines a stream of inputs: each tick
    advances every in-flight sample one stage, so the groups' streams hold
    different samples' stages at once.

Both return outputs that are ready on the caller's current stream: it waits
on the producing group's stream, and the outputs are marked for it.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import time
import weakref
from typing import Iterable, Iterator, Optional

import torch

from repro_torch.core import rbl as rbl_mod
from repro_torch.core.rcb import Op, RCB, RCBProgram
from repro_torch.core.rhal import DmaTicket, TileFailure, TileMesh, _nbytes_of


# Per-tile bind cache bound: a tile binds against its own group's driver
# plus (during failover) a few survivors — anything past this is a
# discarded mesh whose buffers must not be retained.
_BIND_CACHE_CAP = 8


@dataclasses.dataclass(frozen=True)
class CutEdge:
    """One cut-edge tensor: produced by group ``src``, consumed by group
    ``dst``; ``nbytes`` is the movement this edge costs per execution."""
    sym: str
    src: int
    dst: int
    nbytes: int


@dataclasses.dataclass
class TileProgram:
    """One tile group's slice of the workload.

    ``program`` is a standalone RCBProgram: cut-in symbols are re-kinded
    ``input`` (they arrive over inter-tile DMA), cut-out symbols ``output``
    (they stay live to stage exit so the mesh can stream them). Binding is
    cached per driver, so repeated executions re-link nothing.
    """
    gid: int
    program: RCBProgram
    cut_ins: tuple            # symbols arriving over inter-tile streams
    cut_outs: tuple           # symbols streamed to later groups
    input_syms: tuple         # global input symbols this tile consumes
    output_syms: tuple        # global output symbols this tile defines
    weight_syms: tuple
    _bound: dict = dataclasses.field(default_factory=dict, repr=False)

    def bind(self, driver, rimfs=None,
             weights: Optional[dict] = None) -> rbl_mod.BoundProgram:
        """Bind (and cache) against one group's driver: weights pin into
        THAT group's arena through the RIMFS residency cache, or resolve
        from ``weights`` (the original bind's buffers) without an image."""
        entry = self._bound.get(id(driver))
        if entry is not None and entry[0]() is driver:
            return entry[1]
        # the cached BoundProgram's linked form holds its driver strongly,
        # so bound FIFO eviction keeps a run over fresh meshes from
        # retaining every discarded mesh's buffers; re-binding an evicted
        # driver is pure resolution
        while len(self._bound) >= _BIND_CACHE_CAP:
            self._bound.pop(next(iter(self._bound)))
        bound = rbl_mod.bind(self.program, rimfs=rimfs, driver=driver,
                             weights=weights)
        self._bound[id(driver)] = (weakref.ref(driver), bound)
        return bound

    def residency(self, driver):
        """The group's static ResidencyPlan, once linked (None before)."""
        entry = self._bound.get(id(driver))
        linked = getattr(entry[1], "_linked", None) if entry else None
        return linked.residency if linked is not None else None


@dataclasses.dataclass
class PartitionedProgram:
    """The partition: ordered tile programs + the cut-edge tensor table."""
    bound: rbl_mod.BoundProgram        # the original single-device binding
    tiles: list                        # list[TileProgram], stage order
    edges: tuple                       # tuple[CutEdge]

    @property
    def n_groups(self) -> int:
        return len(self.tiles)

    def edges_from(self, gid: int) -> list:
        return [e for e in self.edges if e.src == gid]

    def cut_bytes(self) -> int:
        """Planned inter-tile movement per execution (sum over edges)."""
        return sum(e.nbytes for e in self.edges)


# ---------------------------------------------------------------------------
# Cut-point selection
# ---------------------------------------------------------------------------

def _contiguous_split(weights: list, k: int) -> list:
    """Balanced contiguous split of ``weights`` into <= k non-empty runs."""
    n = len(weights)
    k = max(1, min(k, n))
    prefix = [0]
    for w in weights:
        prefix.append(prefix[-1] + w)
    total = prefix[-1]
    cuts = [0]
    for g in range(1, k):
        ideal = total * g / k
        j = bisect.bisect_left(prefix, ideal)
        j = max(j, cuts[-1] + 1)           # every group stays non-empty
        j = min(j, n - (k - g))            # leave room for the rest
        cuts.append(j)
    cuts.append(n)
    return [(cuts[i], cuts[i + 1]) for i in range(len(cuts) - 1)]


def _reads(op) -> tuple:
    """Symbols an op consumes. FREE's dst is a *read* for cut purposes:
    the op needs the live buffer, it defines nothing."""
    return op.srcs + (op.dsts if op.op is Op.FREE else ())


def _defs(op) -> tuple:
    return () if op.op is Op.FREE else op.dsts


def _group_blocks(prog: RCBProgram, n_groups: int) -> list:
    """Per-group block lists: cuts at RCB block boundaries when the program
    has enough blocks, balanced linear-op splits (re-blocked as one
    "partition" RCB a group) otherwise."""
    if len(prog.blocks) >= n_groups:
        spans = _contiguous_split([len(b.ops) for b in prog.blocks],
                                  n_groups)
        out = []
        for start, end in spans:
            group = prog.blocks[start:end]
            ids = {b.block_id for b in group}
            out.append([dataclasses.replace(
                b, deps=tuple(d for d in b.deps if d in ids))
                for b in group])
        return out
    flat = [op for b in prog.blocks for op in b.ops]
    spans = _contiguous_split([1] * len(flat), n_groups)
    return [[RCB(g, "partition", (), tuple(flat[start:end]))]
            for g, (start, end) in enumerate(spans)]


# ---------------------------------------------------------------------------
# The partition pass
# ---------------------------------------------------------------------------

def partition(bound: rbl_mod.BoundProgram,
              n_groups: int) -> PartitionedProgram:
    """Split a bound program into ``n_groups`` tile-group stages.

    Cuts are contiguous over the linear op stream, so every cross-group
    dependency points forward: the producing group marks the symbol an
    output, every consuming group an input, and the pair becomes a
    ``CutEdge``. A symbol redefined across the cut edges from its *latest*
    producer. Each tile keeps the program's GRAPH_EXEC artifacts.
    """
    prog = bound.program
    groups = _group_blocks(prog, max(1, int(n_groups)))
    n = len(groups)

    group_ops = [[op for b in blocks for op in b.ops] for blocks in groups]
    cut_ins: list = [set() for _ in range(n)]
    cut_outs: list = [set() for _ in range(n)]
    edge_set: dict = {}
    last_def: dict = {}
    for g, ops in enumerate(group_ops):
        for op in ops:
            for sym in _reads(op):
                dg = last_def.get(sym)
                if dg is not None and dg != g:
                    cut_ins[g].add(sym)
                    cut_outs[dg].add(sym)
                    t = prog.tensors[sym]
                    edge_set[(sym, dg, g)] = _nbytes_of(t.shape, t.dtype)
            for sym in _defs(op):
                last_def[sym] = g

    tiles: list = []
    for g, blocks in enumerate(groups):
        ops = group_ops[g]
        defs_g = {s for op in ops for s in _defs(op)}
        syms = {s for op in ops for s in (*op.dsts, *op.srcs)}
        tensors: dict = {}
        for name in prog.tensors:              # keep original symtab order
            if name not in syms:
                continue
            t = prog.tensors[name]
            if t.kind == "weight":
                kind = "weight"
            elif name in cut_outs[g] or (t.kind == "output"
                                         and name in defs_g):
                kind = "output"
            elif name in cut_ins[g] or t.kind == "input":
                kind = "input"
            else:
                kind = t.kind
            tensors[name] = t if t.kind == kind \
                else dataclasses.replace(t, kind=kind)
        sub = RCBProgram(f"{prog.name}.tile{g}", tensors, blocks,
                         dict(prog.artifacts))
        sub.validate()
        tiles.append(TileProgram(
            gid=g, program=sub,
            cut_ins=tuple(s for s in tensors if s in cut_ins[g]),
            cut_outs=tuple(s for s in tensors if s in cut_outs[g]),
            input_syms=tuple(s for s, t in tensors.items()
                             if t.kind == "input" and s not in cut_ins[g]),
            output_syms=tuple(s for s in tensors if s in defs_g
                              and prog.tensors[s].kind == "output"),
            weight_syms=tuple(s for s, t in tensors.items()
                              if t.kind == "weight")))
    edges = tuple(CutEdge(sym, src, dst, nb)
                  for (sym, src, dst), nb in edge_set.items())
    return PartitionedProgram(bound, tiles, edges)


def ensure_partition(bound: rbl_mod.BoundProgram,
                     n_groups: int) -> PartitionedProgram:
    """Cut once per (bound, n_groups), reuse forever."""
    cache = getattr(bound, "_partitions", None)
    if cache is None:
        cache = bound._partitions = {}
    part = cache.get(n_groups)
    if part is None:
        part = cache[n_groups] = partition(bound, n_groups)
    return part


def _tile_weights(part: PartitionedProgram, tile: TileProgram, rimfs):
    """A tile's ``weights=`` for ``bind``: None with an image (pin from
    it), else the original bind's buffers."""
    if rimfs is not None:
        return None
    base = part.bound.buffers
    return {s: base[s] for s in tile.weight_syms if s in base}


def prewarm_group(part: PartitionedProgram, driver, gid: int,
                  rimfs=None) -> None:
    """Bind + link ONE tile's subprogram against a driver (a replacement
    group's): only that driver's arena is populated."""
    from repro_torch.core.executor import Executor   # avoids an import cycle
    tile = part.tiles[gid]
    Executor(driver=driver).link(
        tile.bind(driver, rimfs, weights=_tile_weights(part, tile, rimfs)))


def prewarm(part: PartitionedProgram, mesh: TileMesh, rimfs=None) -> None:
    """Bind + link every tile against its group's driver ahead of traffic,
    so the first request pays no residency upload or link."""
    for tile in part.tiles:
        prewarm_group(part, mesh.group(tile.gid).driver, tile.gid, rimfs)


# ---------------------------------------------------------------------------
# Streams: the caller's against the groups'
# ---------------------------------------------------------------------------

def _caller_event(mesh: TileMesh, values) -> Optional[torch.cuda.Event]:
    """An event on the caller's current stream when any of ``values`` is a
    tensor on the card (made there, it may still be in flight); None
    otherwise."""
    if mesh.device.type == "cuda" and any(
            isinstance(v, torch.Tensor) and v.is_cuda for v in values):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(mesh.device))
        return ev
    return None


def _feed_group(driver, stage_in: dict, ev) -> None:
    """Order the caller's tensors before the group's stream and keep the
    allocator from recycling them while the group reads them."""
    if ev is None or driver.stream is None:
        return
    driver.stream.wait_event(ev)
    for v in stage_in.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            v.record_stream(driver.stream)


def _hand_back(mesh: TileMesh, outs: dict, producers: dict) -> dict:
    """Make outputs ready on the caller's current stream: it waits on each
    producing group's stream (on the device, no host sync), and each
    output is marked for it."""
    if mesh.device.type != "cuda":
        return outs
    current = torch.cuda.current_stream(mesh.device)
    for gid in set(producers.values()):
        stream = mesh.group(gid).driver.stream
        if stream is not None:
            current.wait_stream(stream)
    for v in outs.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            v.record_stream(current)
    return outs


def _stage_timer(driver):
    """(start, end) timing events on the group's stream, or None without
    one (the CPU)."""
    if driver.stream is None:
        return None
    start = torch.cuda.Event(enable_timing=True)
    start.record(driver.stream)
    return start, torch.cuda.Event(enable_timing=True)


# ---------------------------------------------------------------------------
# The schedule driver
# ---------------------------------------------------------------------------

def execute(part: PartitionedProgram, mesh: TileMesh,
            inputs: Optional[dict] = None, rimfs=None,
            platform=None, stage_times: Optional[list] = None,
            stage_events: Optional[list] = None) -> dict:
    """Run the partitioned schedule over a tile mesh.

    Stage *k* (tile group *k*) redeems its cut-in tickets (its stream waits
    on the producers'), runs its linked subprogram on its own driver and
    stream, then issues its cut-out streams split-phase on its stream. With
    a ``platform``, each group is a heartbeat-monitored worker
    ("tile<g>"); a ``TileFailure`` triggers an fsck of the image, a
    liveness sweep and a re-queue of the stage on the first surviving
    group, re-bound against that group's driver. Missing tickets after a
    failover are re-streamed from the producer's retained buffer, on the
    stream of the group that produced it.

    ``stage_times`` gets (gid, host seconds) a stage; ``stage_events`` gets
    (gid, start, end) CUDA timing events recorded on the group's stream
    around the stage (none on the CPU): read them after a sync.
    """
    from repro_torch.core.executor import Executor   # avoids an import cycle
    if mesh.n_groups < part.n_groups:
        raise ValueError(f"mesh has {mesh.n_groups} groups, partition "
                         f"needs {part.n_groups}")
    feed = dict(part.bound.buffers)
    if inputs:
        feed.update(inputs)
    for sym in part.bound.missing_inputs:
        if sym not in feed:
            raise ValueError(f"missing input {sym!r}")
    fed = _caller_event(mesh, [v for s, v in feed.items()
                               if part.bound.program.tensors[s].kind
                               == "input"])

    hb = platform.heartbeats if platform is not None else None
    if hb is not None:
        for gid in mesh.gids:          # registration doubles as a poll:
            if mesh.alive(gid):        # only responsive groups beat
                hb.beat(f"tile{gid}", 0)
            else:
                hb.register_silent(f"tile{gid}")

    env: dict = {}                 # cut-out sym -> (buffer, producing gid)
    tickets: dict = {}             # (sym, dst_gid) -> in-flight ticket
    outs: dict = {}
    producers: dict = {}           # output sym -> producing gid
    for stage_idx, tile in enumerate(part.tiles):
        gid = tile.gid
        tried: set = set()
        while True:
            group = mesh.group(gid)
            mesh.active_gid = gid      # watchdog target for a hung stage
            ist0 = {k: group.driver.stats.get(k, 0)
                    for k in ("dma_retry", "dma_crc_mismatch")} \
                if platform is not None else None
            try:
                # stage busy time starts at ticket redemption: a group
                # whose inbound transfers stall is slow in a way its
                # compute alone won't show
                t0 = time.perf_counter()
                timer = _stage_timer(group.driver) \
                    if stage_events is not None else None
                stage_in = {s: feed[s] for s in tile.input_syms
                            if s in feed}
                _feed_group(group.driver, stage_in, fed)
                for sym in tile.cut_ins:
                    t = tickets.pop((sym, gid), None)
                    if t is None:              # failover: re-stream from
                        buf, src = env[sym]    # the producer's buffer
                        t = mesh.stream(sym, buf, src, gid)
                    stage_in[sym] = group.driver.dma_wait(t) \
                        if type(t) is DmaTicket else t
                bound_t = tile.bind(group.driver, rimfs,
                                    weights=_tile_weights(part, tile, rimfs))
                result = Executor(driver=group.driver).run(
                    bound_t, inputs=stage_in)
                stage_dt = time.perf_counter() - t0
                if timer is not None:
                    timer[1].record(group.driver.stream)
                    stage_events.append((gid, *timer))
                if stage_times is not None:
                    stage_times.append((gid, stage_dt))
                if ist0 is not None:
                    # corruptions the driver caught and retried this stage
                    for key, kind in (("dma_retry", "dma_retry"),
                                      ("dma_crc_mismatch",
                                       "integrity_error")):
                        d = group.driver.stats.get(key, 0) - ist0[key]
                        if d:
                            platform.post(kind, {"n": d, "group": gid})
                break
            except TileFailure:
                tried.add(gid)
                mesh.active_gid = None
                if rimfs is not None:
                    # a group's death may have interrupted a write-side
                    # path: re-verify the store's CRCs before any survivor
                    # re-binds from it
                    rimfs.fsck(strict=False)
                if platform is not None:
                    platform.post("tile_failure",
                                  {"group": gid, "stage": stage_idx})
                    if rimfs is not None:
                        platform.post("rimfs_fsck",
                                      {"phase": "tile_failure"})
                    # liveness sweep: live groups answer the poll, the
                    # dead one cannot; the deadline policy judges
                    for g2 in mesh.gids:
                        if mesh.alive(g2):
                            hb.beat(f"tile{g2}", stage_idx)
                    verdict = hb.check()
                    platform.post("worker_failed",
                                  {"workers": verdict["failed"],
                                   "stage": stage_idx})
                survivors = [g2 for g2 in mesh.gids
                             if mesh.alive(g2) and g2 not in tried]
                if not survivors:
                    raise
                if platform is not None:
                    platform.post("stage_requeued",
                                  {"stage": stage_idx, "from": gid,
                                   "to": survivors[0]})
                gid = survivors[0]
        for sym in tile.output_syms:
            if sym in result:
                outs[sym] = result[sym]
                producers[sym] = gid
        for edge in part.edges_from(tile.gid):
            buf = result.get(edge.sym)
            if buf is None:
                continue
            env[edge.sym] = (buf, gid)         # retained for re-streams
            if mesh.alive(edge.dst):
                try:                           # issue NOW, redeem at use
                    tickets[(edge.sym, edge.dst)] = mesh.stream(
                        edge.sym, buf, gid, edge.dst)
                except TileFailure:
                    pass                       # consumer re-queues later
        mesh.active_gid = None
        if hb is not None:
            hb.beat(f"tile{gid}", stage_idx + 1)
        if platform is not None:
            platform.post("stage_complete",
                          {"stage": stage_idx, "group": gid,
                           "seconds": stage_dt})
    return _hand_back(mesh, outs, producers)


# ---------------------------------------------------------------------------
# Streaming pipeline fill (a stream of independent inputs over the groups)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Sample:
    """One in-flight input's pipeline state."""
    idx: int
    feed: dict
    fed: Optional[torch.cuda.Event] = None   # the caller's tensors' event
    stage: int = 0
    tickets: dict = dataclasses.field(
        default_factory=dict)            # (sym, dst_gid) -> in-flight ticket
    outs: dict = dataclasses.field(default_factory=dict)
    producers: dict = dataclasses.field(default_factory=dict)


def execute_stream(part: PartitionedProgram, mesh: TileMesh,
                   inputs_iter: Iterable, rimfs=None, depth: int = 4,
                   fused: bool = True,
                   stats: Optional[dict] = None) -> Iterator[dict]:
    """Software-pipeline a STREAM of inputs over the partitioned schedule.

    Each clock tick advances every in-flight sample exactly one stage,
    newest first, so group *g* runs sample *i* while group *g+1* runs
    sample *i−1*: on the card their kernels sit on two streams at once.
    ``depth`` bounds in-flight samples (admission is one a tick).
    Outputs yield lazily, in submission order.

    With ``fused=True`` each stage is one ``Executor.fuse`` of its tile (on
    the card a CUDA graph, replayed on the group's stream); ``fused=False``
    runs the linked path with the full vtable. Both equal serial execution
    bit for bit. Cut edges stay split-phase: the ticket a group issues for
    sample *i* this tick is redeemed by the next group next tick.

    ``stats`` gets per-group busy seconds (``busy``: host time inside each
    stage's dispatch), tick and sample counts. There is no re-queue: a
    fused stage is a graph replay with no vtable slot for a killed group's
    guard to trip, and a re-queued middle stage would reorder the stream's
    tickets, so a ``TileFailure`` (the cut-edge stream into a dead group
    still touches its driver) propagates; callers needing failover run
    ``execute`` per sample under a Platform.
    """
    from repro_torch.core.executor import Executor   # avoids an import cycle
    if mesh.n_groups < part.n_groups:
        raise ValueError(f"mesh has {mesh.n_groups} groups, partition "
                         f"needs {part.n_groups}")
    if depth < 1:
        raise ValueError(f"in-flight depth must be >= 1, got {depth}")
    if stats is None:
        stats = {}
    stats.update({"busy": {t.gid: 0.0 for t in part.tiles},
                  "ticks": 0, "samples": 0, "depth": depth,
                  "fused": fused})
    base = part.bound.buffers
    executors = {t.gid: Executor(driver=mesh.group(t.gid).driver)
                 for t in part.tiles}
    edges_by_gid = {t.gid: part.edges_from(t.gid) for t in part.tiles}
    tile_weights = [_tile_weights(part, t, rimfs) for t in part.tiles]
    stage_fns = None
    if fused:
        # one staged callable + weight feed a stage, resolved before the
        # first sample is admitted (cached on the tile's BoundProgram)
        stage_fns = []
        for idx, tile in enumerate(part.tiles):
            bt = tile.bind(mesh.group(tile.gid).driver, rimfs,
                           weights=tile_weights[idx])
            ex = executors[tile.gid]
            stage_fns.append((ex.fuse(bt), ex.weights_from(bt)))
    busy = stats["busy"]
    n_stages = len(part.tiles)
    it = iter(inputs_iter)
    inflight: collections.deque = collections.deque()
    next_idx = 0
    exhausted = False
    while True:
        if not exhausted and len(inflight) < depth:
            try:
                inputs = next(it)
            except StopIteration:
                exhausted = True
            else:
                feed = dict(inputs) if inputs else {}
                for sym in part.bound.missing_inputs:
                    if sym not in feed and sym not in base:
                        raise ValueError(f"missing input {sym!r} "
                                         f"(stream sample {next_idx})")
                inflight.append(_Sample(next_idx, feed,
                                        _caller_event(mesh, feed.values())))
                next_idx += 1
                stats["samples"] += 1
        if not inflight:
            return
        stats["ticks"] += 1
        # one clock tick: every sample consumes only tickets issued in a
        # PREVIOUS tick, so in-tick order is free; newest first puts the
        # pipeline's synchronizing tail after the younger samples' work
        for s in reversed(inflight):
            tile = part.tiles[s.stage]
            gid = tile.gid
            driver = mesh.group(gid).driver
            stage_in = {}
            for sym in tile.input_syms:
                v = s.feed.get(sym)
                if v is None:
                    v = base.get(sym)
                if v is not None:
                    stage_in[sym] = v
            _feed_group(driver, stage_in, s.fed)
            for sym in tile.cut_ins:
                t = s.tickets.pop((sym, gid))
                stage_in[sym] = driver.dma_wait(t) \
                    if type(t) is DmaTicket else t
            t0 = time.perf_counter()
            if stage_fns is not None:
                fn, w = stage_fns[s.stage]
                with driver.scope():
                    result = fn(stage_in, w)
            else:
                bound_t = tile.bind(driver, rimfs,
                                    weights=tile_weights[s.stage])
                result = executors[gid].run(bound_t, inputs=stage_in)
            busy[gid] += time.perf_counter() - t0
            for sym in tile.output_syms:
                if sym in result:
                    s.outs[sym] = result[sym]
                    s.producers[sym] = gid
            for edge in edges_by_gid[gid]:
                buf = result.get(edge.sym)
                if buf is not None:
                    s.tickets[(edge.sym, edge.dst)] = mesh.stream(
                        edge.sym, buf, gid, edge.dst)
            s.stage += 1
        while inflight and inflight[0].stage >= n_stages:
            done = inflight.popleft()
            yield _hand_back(mesh, done.outs, done.producers)
