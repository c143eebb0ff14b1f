"""The generic RCB executor — cyclic Fetch-Decode-Dispatch.

The port's counterpart of ``repro.core.executor``. The executor knows
nothing about models: it walks the linear op stream and invokes RHAL vtable
slots. Four modes:

  * ``interpreted`` — every op is re-decoded through the opcode switch and
    dispatched with a host synchronization after it (the per-op baseline).
  * ``linked`` — the default ``run`` path: the program is linked ONCE
    (core/linker.py) into pre-resolved thunks over a dense slot array; ops
    launch asynchronously on the device queue, syncing only at FENCE ops.
  * ``fused`` — ``fuse``: the same thunks, linked against the capture
    driver, captured once into a CUDA graph and replayed as one launch.
  * ``batched`` — ``run_batched``: the fused form under
    ``torch.func.vmap``, one graph per batch bucket (1/2/4/8/16), over a
    list of independent requests.

The first three run the same op implementations in the same order on the
same device, so their outputs are bit-identical. ``run_partitioned`` cuts
the program into stages over a ``TileMesh`` (core/partition.py); each stage
runs linked on its group's driver and stream, so it is bit-identical too.
Host inputs (numpy arrays or CPU tensors) are moved onto the driver's
device explicitly; outputs stay on the device.
Either mode can ``probe`` the abs-max of every buffer it holds (INT8
calibration, core/quant.py). ``run(..., trace_ops=True)`` and
``run_interpreted(..., trace_ops=True)`` record one ``OpTrace`` per op in
``Executor.op_traces`` (the per-op measurement mode).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import vmap

from repro_torch.core import linker as linker_mod
from repro_torch.core import rhal as rhal_mod
from repro_torch.core.rbl import BoundProgram
from repro_torch.core.rbl import explicitly_freed as rbl_explicitly_freed
from repro_torch.core.rcb import Op
from repro_torch.dtypes import as_tensor, to_host, torch_dtype
from repro_torch.kernels import registry

_CPU = torch.device("cpu")


@dataclasses.dataclass
class OpTrace:
    """One interpreted op's host wall clock around its dispatch. The eager
    driver syncs the host after every compute op and DMA it dispatches
    (``rhal.make_eager_driver``), so on the card ``seconds`` holds the
    op's device time too, launch and sync included; a ``GRAPH_EXEC``
    artifact is not synced, so its entry holds its enqueue only."""
    block_id: int
    op: Op
    seconds: float


def _probe_update(probe_dev: dict, sym: str, buf) -> None:
    """Device-side abs-max accumulation: no host round-trip per op. A slot
    that holds no tensor (empty, or a DMA ticket not yet redeemed) and an
    empty tensor record nothing; an input kept on the host for its DMA is
    read there."""
    if isinstance(buf, np.ndarray):
        buf = as_tensor(buf, _CPU)
    if not isinstance(buf, torch.Tensor) or buf.numel() == 0:
        return
    m = torch.amax(torch.abs(buf))
    prev = probe_dev.get(sym)
    probe_dev[sym] = m if prev is None else torch.maximum(prev, m)


def _probe_flush(probe: dict, probe_dev: dict) -> None:
    """Convert the accumulated device scalars to host floats once, at
    exit."""
    for sym, m in probe_dev.items():
        probe[sym] = max(probe.get(sym, 0.0), float(m))


def _dma_only_inputs(prog) -> frozenset:
    """The program's inputs that no op but ``DMA_H2D`` reads."""
    dma, other = set(), set()
    for op in prog.ops():
        (dma if op.op == Op.DMA_H2D else other).update(op.srcs)
    return frozenset(n for n in dma - other
                     if prog.tensors.get(n) is not None
                     and prog.tensors[n].kind == "input")


def _weight_key(weights: dict) -> tuple:
    """The device addresses a captured graph reads its weights from."""
    return tuple((k, w.data_ptr()) for k, w in sorted(weights.items()))


def _check_weights(weights: dict, device: torch.device) -> None:
    for k, w in weights.items():
        if not isinstance(w, torch.Tensor) or w.device != device:
            raise ValueError(f"weight {k!r} is not a tensor on {device}: a "
                             f"captured graph reads it in place (bind with "
                             f"the executor's driver, or allocate it on the "
                             f"device)")


class CapturedGraph:
    """A staged callable captured as one ``torch.cuda.CUDAGraph``.

    ``inputs`` are the graph's static input buffers on the device, filled
    before each replay; ``weights`` are the tensors the callable reads in
    place (a bound program's weights) or also writes in place (the serving
    engine's KV cache, for its decode step): their addresses are baked into
    the graph, so it holds them and the caller must never rebind them.
    Capture runs the callable once on a side stream first (so it writes, on
    the warm-up inputs, what a replay would write): that first run builds
    the kernel library, sets each kernel's shared-memory attribute at its
    first launch and lets cuBLAS and cuDNN pick their algorithms, none of
    which a capture can hold. The capture itself uses
    ``capture_error_mode="thread_local"``, so the server's handler threads
    stay free to run while the dispatcher captures. Anything in the
    callable that syncs or reads the host makes the capture raise; nothing
    falls back to an uncaptured run.

    The kernel wrappers' ``launches`` counts move at capture but nothing
    runs then: the capture's counts are recorded as ``launches`` (a
    replay's launches by kernel) and taken back, and every replay adds
    them.

    A callable that draws random numbers from its own CUDA ``generator``
    passes it here: the graph registers it, so each replay draws the next
    numbers of its stream, and the warm-up's draws are taken back (its
    state is restored before the capture), so the stream a replay sees
    does not depend on when the graph was captured."""

    def __init__(self, fn: Callable, inputs: dict, weights: dict,
                 dev: torch.device,
                 generator: Optional[torch.Generator] = None):
        _check_weights(weights, dev)
        self.inputs = inputs
        self.weights = weights
        self.weight_key = _weight_key(weights)
        counters = registry.launch_counters()
        t0 = time.perf_counter()
        state = generator.get_state() if generator is not None else None
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(inputs, weights)                    # warm-up, uncaptured
        torch.cuda.current_stream(dev).wait_stream(side)
        before = {name: w.launches for name, w in counters.items()}
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            generator.set_state(state)
            self.graph.register_generator_state(generator)
        try:
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self.outputs = fn(inputs, weights)
        finally:
            self.launches = {name: w.launches - before[name]
                             for name, w in counters.items()}
            for name, w in counters.items():
                w.launches = before[name]
        self.capture_s = time.perf_counter() - t0

    def __call__(self, inputs: dict) -> dict:
        """Copy ``inputs`` into the static buffers, replay, and return
        clones of the outputs (the next replay cannot overwrite them)."""
        for k, buf in self.inputs.items():
            v = inputs[k]
            if tuple(v.shape) != tuple(buf.shape) or v.dtype != buf.dtype:
                raise ValueError(
                    f"input {k!r}: {tuple(v.shape)} {v.dtype} does not match "
                    f"the captured {tuple(buf.shape)} {buf.dtype}")
            buf.copy_(v)
        self.replay()
        return {k: v.clone() for k, v in self.outputs.items()}

    def replay(self) -> None:
        self.graph.replay()
        counters = registry.launch_counters()
        for name, n in self.launches.items():
            counters[name].launches += n


class FusedProgram:
    """What ``Executor.fuse`` returns: ``fn(inputs, weights) -> outputs``.

    On CUDA each distinct set of weight tensors (by their device addresses)
    and of input shapes and dtypes gets its own ``CapturedGraph``, captured
    at its first call: a call with other weight tensors captures anew and
    never replays a graph that reads stale addresses. On the CPU the staged
    callable runs uncaptured."""

    def __init__(self, staged: Callable, device: torch.device,
                 bound_inputs: dict, input_syms: tuple,
                 donate_weights: bool):
        self.staged = staged
        self.device = device
        self.bound_inputs = bound_inputs
        self.input_syms = input_syms
        self.donate_weights = donate_weights
        self.graphs: dict = {}               # (weight key, input sig) -> graph

    def _inputs(self, inputs: Optional[dict]) -> dict:
        vals = {**self.bound_inputs, **(inputs or {})}
        missing = [s for s in self.input_syms if s not in vals]
        if missing:
            raise ValueError(f"missing input {missing[0]!r}")
        return {s: vals[s] for s in self.input_syms}

    def __call__(self, inputs: dict, weights: dict) -> dict:
        vals = self._inputs(inputs)
        if self.device.type != "cuda":
            return self.staged({k: as_tensor(v, self.device)
                                for k, v in vals.items()}, weights)
        vals = {k: v if isinstance(v, torch.Tensor) else as_tensor(v, _CPU)
                for k, v in vals.items()}
        key = (_weight_key(weights),
               tuple((k, tuple(v.shape), v.dtype) for k, v in vals.items()))
        graph = self.graphs.get(key)
        if graph is None:
            static = {k: v.to(self.device, copy=True)
                      for k, v in vals.items()}
            graph = self.graphs[key] = CapturedGraph(
                self.staged, static, dict(weights), self.device)
        return graph(vals)

    def release(self) -> None:
        """Drop every captured graph (and with it its memory pool and its
        hold on the weight tensors)."""
        self.graphs.clear()


class Executor:
    def __init__(self, driver: Optional[rhal_mod.HalDriver] = None,
                 rtpm=None, device="cuda"):
        self.driver = driver or rhal_mod.make_eager_driver(device)
        self.rtpm = rtpm
        self.op_traces: list[OpTrace] = []      # cleared by the caller

    # ------------------------------------------------------------- linking
    def link(self, bound: BoundProgram) -> linker_mod.LinkedProgram:
        """Link (and cache on the BoundProgram) against this driver."""
        linked = getattr(bound, "_linked", None)
        if linked is None or linked.driver is not self.driver \
                or linked.program is not bound.program:
            linked = linker_mod.link(bound, self.driver)
            bound._linked = linked
        return linked

    def _inputs_on_device(self, bound: BoundProgram,
                          inputs: Optional[dict],
                          keep_host: frozenset = frozenset()) -> dict:
        """Every input-kind buffer (bound or passed) on the driver's
        device; the caller's host arrays move here, explicitly. Those
        named in ``keep_host`` stay as they were given."""
        dev = self.driver.device
        out = {n: b for n, b in bound.buffers.items()
               if bound.program.tensors[n].kind == "input"}
        out.update(inputs or {})
        return {n: b if n in keep_host else as_tensor(b, dev)
                for n, b in out.items()}

    # ------------------------------------------------------------ dispatch
    def _dispatch(self, driver, op, buffers, free_after: Optional[dict],
                  idx: int, rimfs):
        """Decode + dispatch one RCBOp through the vtable (interpreted)."""
        if op.op == Op.NOP or op.op == Op.HALT:
            return
        if op.op == Op.ALLOC:
            buffers[op.dsts[0]] = driver.alloc(tuple(op.attrs["shape"]),
                                               op.attrs["dtype"])
        elif op.op == Op.FREE:
            driver.free(buffers.pop(op.dsts[0], None))
        elif op.op == Op.BIND_CONST:
            buffers[op.dsts[0]] = driver.bind_const(op.attrs["value"])
        elif op.op == Op.DMA_H2D:
            src = op.srcs[0]
            host = buffers.get(src)
            if host is None and rimfs is not None:
                host = rimfs.read(src)
            buffers[op.dsts[0]] = driver.wait_dma(
                driver.initiate_dma(host, "h2d"))
        elif op.op == Op.DMA_D2H:
            buffers[op.dsts[0]] = driver.wait_dma(
                driver.initiate_dma(buffers[op.srcs[0]], "d2h"))
        elif op.op == Op.DMA_D2D:
            buffers[op.dsts[0]] = driver.wait_dma(
                driver.initiate_dma(buffers[op.srcs[0]], "d2d"))
        elif op.op == Op.GRAPH_EXEC:
            fn = self._artifact(op.attrs["artifact"])
            outs = fn(*[buffers[s] for s in op.srcs])
            if len(op.dsts) == 1:
                buffers[op.dsts[0]] = outs
            else:
                for d, o in zip(op.dsts, outs):
                    buffers[d] = o
        elif op.op == Op.COLLECTIVE:
            buffers[op.dsts[0]] = driver.collective(
                op.attrs.get("kind", "all_reduce"), buffers[op.srcs[0]],
                op.attrs)
        elif op.op == Op.FENCE:
            driver.fence(list(buffers.values()))
        elif op.op == Op.POLL:
            driver.poll(buffers.get(op.srcs[0]) if op.srcs else None)
        else:                                    # compute dispatch
            srcs = [buffers[s] for s in op.srcs]
            buffers[op.dsts[0]] = driver.dispatch_compute(op.op, srcs,
                                                          op.attrs)
        # Scratch is released by reference-drop after its last read (the
        # RBL liveness plan); symbols with an explicit FREE op are exempt.
        # The linked path applies the same policy via its free-lists.
        if free_after is not None:
            for s in op.srcs:
                if free_after.get(s) == idx and s not in self._explicit_free:
                    t = self._prog.tensors.get(s)
                    if t is not None and t.kind == "scratch":
                        buffers.pop(s, None)

    def _artifact(self, name: str) -> Callable:
        fn = self._prog.artifacts.get(name)
        if fn is None:
            raise KeyError(f"GRAPH_EXEC artifact {name!r} not attached")
        return fn

    def _block_done(self, block_id: int, t_blk: float) -> None:
        """RTPM completion event; the driver's queue is synced first so the
        block time is execution, not enqueue."""
        self.driver.barrier()
        self.rtpm.post("rcb_complete",
                       {"block": block_id,
                        "seconds": time.perf_counter() - t_blk})

    # -------------------------------------------------------------- linked
    def run(self, bound: BoundProgram, inputs: Optional[dict] = None,
            rimfs=None, trace_ops: bool = False,
            probe: Optional[dict] = None) -> dict:
        """Execute the program through the linked (compiled-dispatch) path.

        ``probe``: optional dict filled with the per-symbol abs-max of every
        buffer the run holds (the bound ones and every one produced), for
        INT8 calibration. The abs-max accumulates on the device; the host
        reads each symbol's once, at exit.

        ``trace_ops=True`` takes the interpreted path instead: per-op wall
        timing needs the per-op host sync that defines that mode.

        Everything runs on the driver's stream (``HalDriver.scope``): a
        tile group's own, else the current one."""
        if trace_ops:
            return self.run_interpreted(bound, inputs=inputs, rimfs=rimfs,
                                        trace_ops=True, probe=probe)
        with self.driver.scope():
            return self._run(bound, inputs, rimfs, probe)

    def _run(self, bound: BoundProgram, inputs: Optional[dict], rimfs,
             probe: Optional[dict]) -> dict:
        linked = self.link(bound)
        istats0 = None
        if self.rtpm is not None:
            istats0 = {k: self.driver.stats.get(k, 0)
                       for k in ("dma_retry", "dma_crc_mismatch")}
        slots = linked.fresh_slots(bound.buffers,
                                   self._inputs_on_device(bound, inputs))
        for sym, i in linked.missing_inputs:
            if slots[i] is None:
                raise ValueError(f"missing input {sym!r}")
        probe_dev: Optional[dict] = None
        if probe is not None:
            probe_dev = {}
            for i, buf in enumerate(slots):
                _probe_update(probe_dev, linked.names[i], buf)
        for pre in linked.prologue:                # prefetch issue phase
            pre(slots, rimfs)
        if probe_dev is None and self.rtpm is None:
            for thunk in linked.thunks:            # THE hot loop
                thunk(slots, rimfs)
        else:                                      # instrumented
            thunks = linked.thunks
            for block_id, start, end in linked.block_spans:
                t_blk = time.perf_counter()
                for k in range(start, end):
                    thunks[k](slots, rimfs)
                    if probe_dev is not None:
                        for d in linked.dst_lists[k]:
                            _probe_update(probe_dev, linked.names[d],
                                          slots[d])
                if self.rtpm is not None:
                    self._block_done(block_id, t_blk)
        for epi in linked.epilogue:                # drain redeem phase
            epi(slots, rimfs)
        self.driver._count("dispatch", linked.n_compute)
        plan = linked.residency
        if self.rtpm is not None and plan is not None and plan.bytes_moved:
            self.rtpm.post("dma_complete",
                           {"bytes_moved": plan.bytes_moved,
                            "bytes_overlapped": plan.bytes_overlapped})
        if istats0 is not None:
            # integrity-plane activity caught in the driver, as telemetry
            for key, kind in (("dma_retry", "dma_retry"),
                              ("dma_crc_mismatch", "integrity_error")):
                delta = self.driver.stats.get(key, 0) - istats0[key]
                if delta:
                    self.rtpm.post(kind, {"n": delta, "source": "executor"})
        if probe_dev is not None:
            _probe_flush(probe, probe_dev)
        return {name: slots[i] for name, i in linked.output_slots
                if slots[i] is not None}

    # --------------------------------------------------------------- fused
    def fuse(self, bound: BoundProgram, donate_weights: bool = False):
        """Stage the whole program into one CUDA graph.

        Returns ``fn(inputs: dict, weights: dict) -> outputs: dict`` (a
        ``FusedProgram``): the SAME linked thunk form ``run`` executes,
        linked against the capture driver (``rhal.make_capture_driver``,
        the JAX package's trace driver), captured once and replayed as one
        launch. ``weights`` are the program's weight tensors
        (``weights_from``); the graph reads them in place. Outputs are
        fresh device tensors, bit-identical to ``run``'s: the same kernels
        run in the same order. The fused form posts no per-block RTPM
        events (the JAX package's fused form posts none either).

        The callable is cached on the BoundProgram, keyed by
        ``donate_weights``, and holds one graph per set of weight tensors
        (by device address), so repeated calls replay. The cache is
        invalidated if the bound's program object is swapped out from
        under it. ``donate_weights`` keeps the JAX package's signature and
        cache key; on the card a graph reads its weights in place and
        never writes them, so there is nothing to donate and the flag
        changes nothing but the cache entry. On the CPU (only when the
        executor's driver is there) the staged callable runs uncaptured.
        """
        cache = getattr(bound, "_fused", None)
        if cache is None or cache[0] is not bound.program:
            cache = bound._fused = (bound.program, {})
        fn = cache[1].get(donate_weights)
        if fn is None:
            dev = self.driver.device
            linked = linker_mod.link(bound,
                                     rhal_mod.make_capture_driver(dev))
            fn = FusedProgram(
                linker_mod.stage_callable(linked), dev,
                {n: b for n, b in bound.buffers.items()
                 if bound.program.tensors[n].kind == "input"},
                tuple(linked.input_slots), donate_weights)
            cache[1][donate_weights] = fn
        return fn

    # -------------------------------------------------------------- batched
    #: Batch-bucket ladder: every batched dispatch stages at one of these
    #: leading-axis sizes, so the number of captured graphs per program is
    #: bounded (len(buckets)), not O(#distinct request counts).
    BATCH_BUCKETS: tuple = (1, 2, 4, 8, 16)

    # (program CRC, bucket, device, weight addresses) -> batched callable.
    # Module-wide on purpose: re-binds, fresh BoundPrograms and every
    # Executor instance of the same program over the same weight tensors
    # (two binds of one image on one driver share RIMFS's resident
    # tensors) share ONE graph per bucket.
    _batch_cache: dict = {}
    _BATCH_CACHE_CAP = 64

    @classmethod
    def aot_cache_get(cls, key):
        """Look up a staged callable in the module-wide cache."""
        return cls._batch_cache.get(key)

    @classmethod
    def aot_cache_put(cls, key, fn) -> None:
        """Insert under the capacity bound, evicting the oldest entries
        (an evicted graph frees its memory pool with it)."""
        while len(cls._batch_cache) >= cls._BATCH_CACHE_CAP:
            cls._batch_cache.pop(next(iter(cls._batch_cache)))
        cls._batch_cache[key] = fn

    def _batch_key(self, bound: BoundProgram, bucket: int) -> tuple:
        return (bound.program.crc(), bucket, str(self.driver.device),
                _weight_key(self.weights_from(bound)))

    def _batched_callable(self, bound: BoundProgram, bucket: int):
        """``fn(stacked_inputs, weights) -> outputs`` for one bucket: the
        staged program under ``torch.func.vmap`` (inputs mapped over a
        leading axis of ``bucket`` lanes, weights broadcast). On CUDA it is
        captured as one graph at the bucket's input shapes (from the
        program's input descs) when it is first staged."""
        key = self._batch_key(bound, bucket)
        fn = Executor.aot_cache_get(key)
        if fn is None:
            dev = self.driver.device
            linked = linker_mod.link(bound,
                                     rhal_mod.make_capture_driver(dev))
            mapped = vmap(linker_mod.stage_callable(linked),
                          in_dims=(0, None))
            if dev.type == "cuda":
                static = {
                    n: torch.zeros((bucket,) + tuple(t.shape),
                                   dtype=torch_dtype(t.dtype), device=dev)
                    for n, t in bound.program.tensors.items()
                    if t.kind == "input"}
                graph = CapturedGraph(mapped, static,
                                      self.weights_from(bound), dev)

                def fn(stacked, weights, _g=graph):
                    if _weight_key(weights) != _g.weight_key:
                        raise ValueError("batched graph: weight tensors "
                                         "differ from the captured ones")
                    return _g(stacked)
                fn.graph = graph
            else:
                def fn(stacked, weights, _m=mapped, _dev=dev):
                    return _m({k: v.to(_dev) for k, v in stacked.items()},
                              weights)
            Executor.aot_cache_put(key, fn)
        return fn

    @classmethod
    def release_graphs(cls, bound: BoundProgram) -> int:
        """Drop every graph captured over ``bound``'s weight tensors: its
        fused graphs and its batch buckets (the server calls this before a
        re-provision unpins the weights the graphs read). Returns the
        number of batch buckets dropped."""
        cache = getattr(bound, "_fused", None)
        if cache is not None:
            for fn in cache[1].values():
                fn.release()
            bound._fused = None
        weights = {n: b for n, b in bound.buffers.items()
                   if bound.program.tensors[n].kind == "weight"}
        crc, wkey = bound.program.crc(), _weight_key(weights)
        stale = [k for k in cls._batch_cache
                 if k[0] == crc and k[3] == wkey]
        for k in stale:
            del cls._batch_cache[k]
        return len(stale)

    def _bucket_for(self, n: int) -> int:
        """Smallest ladder bucket >= n (pad-to-bucket), or the largest
        bucket when n exceeds the ladder (the caller chunks)."""
        for b in self.BATCH_BUCKETS:
            if b >= n:
                return b
        return self.BATCH_BUCKETS[-1]

    def run_batched(self, bound: BoundProgram, inputs_list,
                    rimfs=None, max_bucket: Optional[int] = None) -> list:
        """Execute one program over a batch of independent requests.

        The program is staged ONCE per batch bucket (sizes 1/2/4/8/16, via
        ``torch.func.vmap`` over a leading axis on the input slots with
        weights broadcast, captured as one CUDA graph) and the request
        list is chunked greedily onto the ladder: full largest-bucket
        chunks first, then the remainder pads up to the smallest covering
        bucket — padded lanes replicate the chunk's last request and are
        sliced away from the results (pad-to-bucket + slice-back).
        ``max_bucket`` clamps the ladder top (e.g. to a serving batch
        window).

        Execution is two-phase: every chunk is DISPATCHED first (a replay
        is asynchronous; each chunk's outputs are cloned off the graph's
        static buffers on the device), then results materialize in request
        order — each output tensor crosses d2h ONCE per chunk, and the
        per-request entries are views of it, as host values (numpy, or a
        CPU bf16 tensor). Integer outputs and the hand kernels' outputs
        equal a serial ``run``'s per lane; a float op whose library
        (cuBLAS, cuDNN) picks its algorithm by the batched shape may differ
        from the serial run by rounding.

        Programs the batch analysis rejects (split-phase DMA, collectives,
        GRAPH_EXEC — see ``linker.batch_analysis``) run serially through
        ``run``: same results, no batch amortization.
        ``self.batch_stats`` reports what happened either way.
        """
        reqs = list(inputs_list)
        verdict = linker_mod.batch_analysis(bound)
        self.batch_stats = {"batchable": verdict.batchable,
                            "reason": verdict.reason,
                            "requests": len(reqs), "buckets": [],
                            "padded": 0}
        if not reqs:
            return []
        if not verdict.batchable:
            return [self.run(bound, inputs=req, rimfs=rimfs)
                    for req in reqs]
        input_syms = tuple(n for n, t in bound.program.tensors.items()
                           if t.kind == "input")
        weights = self.weights_from(bound)
        top = self.BATCH_BUCKETS[-1] if max_bucket is None \
            else max(1, min(max_bucket, self.BATCH_BUCKETS[-1]))
        # phase 1: stack + dispatch every chunk (no sync anywhere)
        pending: list = []                 # (pos, take, {sym: device out})
        pos = 0
        while pos < len(reqs):
            rem = len(reqs) - pos
            take = top if rem >= top else rem
            # a non-ladder max_bucket stages its own chunk size rather
            # than padding past the caller's clamp
            bucket = min(self._bucket_for(take), top)
            chunk = reqs[pos:pos + take]
            stacked = {}
            for sym in input_syms:
                vals = []
                for req in chunk:
                    v = req.get(sym) if req else None
                    if v is None:
                        v = bound.buffers.get(sym)
                    if v is None:
                        raise ValueError(f"missing input {sym!r} in "
                                         f"batched request {pos}")
                    vals.append(as_tensor(v, _CPU))
                vals.extend([vals[-1]] * (bucket - take))   # pad lanes
                stacked[sym] = torch.stack(vals)   # host-side: one copy
            fn = self._batched_callable(bound, bucket)
            pending.append((pos, take, fn(stacked, weights)))
            self.batch_stats["buckets"].append(bucket)
            self.batch_stats["padded"] += bucket - take
            pos += take
        # phase 2: materialize in order — ONE d2h per output tensor per
        # chunk, per-lane views of it; blocking on chunk k overlaps chunk
        # k+1's in-flight replay
        results: list = [None] * len(reqs)
        for cpos, take, outs in pending:
            hosts = {k: v.cpu() for k, v in outs.items()}
            for j in range(take):
                results[cpos + j] = {k: to_host(h[j])
                                     for k, h in hosts.items()}
        return results

    # --------------------------------------------------------- partitioned
    def run_partitioned(self, bound: BoundProgram,
                        inputs: Optional[dict] = None, rimfs=None,
                        mesh=None, n_groups: int = 2,
                        platform=None) -> dict:
        """Execute over a tile mesh: the program is cut into per-group
        stages (core/partition.py), each stage runs linked on its own
        group's driver and stream, and cut-edge tensors stream split-phase
        between groups.

        ``mesh`` defaults to a fresh ``TileMesh(n_groups)`` on this
        executor's device; a ``platform`` (rtpm.Platform) adds
        heartbeat-monitored groups and stage re-queue on tile failure. The
        partition is cached on the BoundProgram per group count. Outputs
        are ready on the caller's current stream."""
        from repro_torch.core import partition as partition_mod
        if mesh is None:
            mesh = rhal_mod.TileMesh(n_groups, device=self.driver.device)
        part = partition_mod.ensure_partition(bound, mesh.n_groups)
        return partition_mod.execute(part, mesh, inputs=inputs,
                                     rimfs=rimfs, platform=platform)

    # ------------------------------------------------------------- helpers
    def weights_from(self, bound: BoundProgram) -> dict:
        return {n: b for n, b in bound.buffers.items()
                if bound.program.tensors[n].kind == "weight"}

    # --------------------------------------------------- interpreted baseline
    def run_interpreted(self, bound: BoundProgram,
                        inputs: Optional[dict] = None, rimfs=None,
                        trace_ops: bool = False,
                        probe: Optional[dict] = None) -> dict:
        """Interpret the program op-by-op (the per-op baseline and the
        per-op measurement mode): with ``trace_ops`` each op appends an
        ``OpTrace`` to ``op_traces`` in program order. ``probe`` as in
        ``run``, on the driver's stream as ``run``."""
        with self.driver.scope():
            return self._run_interpreted(bound, inputs, rimfs, trace_ops,
                                         probe)

    def _run_interpreted(self, bound: BoundProgram, inputs: Optional[dict],
                         rimfs, trace_ops: bool,
                         probe: Optional[dict]) -> dict:
        self._prog = bound.program
        self._explicit_free = rbl_explicitly_freed(bound.program)
        buffers = dict(bound.buffers)
        # an input the program moves itself (read by DMA_H2D ops only)
        # stays on the host until its op, which then times the transfer
        buffers.update(self._inputs_on_device(
            bound, inputs, _dma_only_inputs(bound.program)))
        for sym in bound.missing_inputs:
            if sym not in buffers:
                raise ValueError(f"missing input {sym!r}")
        probe_dev: Optional[dict] = None
        if probe is not None:
            probe_dev = {}
            for sym, buf in buffers.items():
                _probe_update(probe_dev, sym, buf)
        idx = 0
        for block in bound.program.blocks:
            t_blk = time.perf_counter()
            for op in block.ops:
                t0 = time.perf_counter()
                self._dispatch(self.driver, op, buffers, bound.last_use,
                               idx, rimfs)
                if trace_ops:
                    self.op_traces.append(
                        OpTrace(block.block_id, op.op,
                                time.perf_counter() - t0))
                if probe_dev is not None:
                    for dd in op.dsts:
                        _probe_update(probe_dev, dd, buffers.get(dd))
                idx += 1
            if self.rtpm is not None:
                self._block_done(block.block_id, t_blk)
        if probe_dev is not None:
            _probe_flush(probe, probe_dev)
        return {name: buffers[name]
                for name, t in bound.program.tensors.items()
                if t.kind == "output" and name in buffers}
