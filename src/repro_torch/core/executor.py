"""The generic RCB executor — cyclic Fetch-Decode-Dispatch.

The port's counterpart of ``repro.core.executor``. The executor knows
nothing about models: it walks the linear op stream and invokes RHAL vtable
slots. Two modes:

  * ``interpreted`` — every op is re-decoded through the opcode switch and
    dispatched with a host synchronization after it (the per-op baseline).
  * ``linked`` — the default ``run`` path: the program is linked ONCE
    (core/linker.py) into pre-resolved thunks over a dense slot array; ops
    launch asynchronously on the device queue, syncing only at FENCE ops.

Both modes run the same op implementations on the same device, so their
outputs are bit-identical. Host inputs (numpy arrays or CPU tensors) are
moved onto the driver's device explicitly; outputs stay on the device.
Either mode can ``probe`` the abs-max of every buffer it holds (INT8
calibration, core/quant.py).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch import device as device_mod
from repro_torch.core import linker as linker_mod
from repro_torch.core import rhal as rhal_mod
from repro_torch.core.rbl import BoundProgram
from repro_torch.core.rbl import explicitly_freed as rbl_explicitly_freed
from repro_torch.core.rcb import Op
from repro_torch.dtypes import as_tensor


def _probe_update(probe_dev: dict, sym: str, buf) -> None:
    """Device-side abs-max accumulation: no host round-trip per op. A slot
    that holds no tensor (empty, or a DMA ticket not yet redeemed) and an
    empty tensor record nothing."""
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


class Executor:
    def __init__(self, driver: Optional[rhal_mod.HalDriver] = None,
                 rtpm=None, device="cuda"):
        self.driver = driver or rhal_mod.make_eager_driver(device)
        self.rtpm = rtpm

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
                          inputs: Optional[dict]) -> dict:
        """Every input-kind buffer (bound or passed) on the driver's
        device; the caller's host arrays move here, explicitly."""
        dev = self.driver.device
        out = {n: b for n, b in bound.buffers.items()
               if bound.program.tensors[n].kind == "input"}
        out.update(inputs or {})
        return {n: as_tensor(b, dev) for n, b in out.items()}

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
        """RTPM completion event; the device is synced first so the block
        time is execution, not enqueue."""
        device_mod.synchronize(self.driver.device)
        self.rtpm.post("rcb_complete",
                       {"block": block_id,
                        "seconds": time.perf_counter() - t_blk})

    # -------------------------------------------------------------- linked
    def run(self, bound: BoundProgram, inputs: Optional[dict] = None,
            rimfs=None, probe: Optional[dict] = None) -> dict:
        """Execute the program through the linked (compiled-dispatch) path.

        ``probe``: optional dict filled with the per-symbol abs-max of every
        buffer the run holds (the bound ones and every one produced), for
        INT8 calibration. The abs-max accumulates on the device; the host
        reads each symbol's once, at exit."""
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

    # --------------------------------------------------- interpreted baseline
    def run_interpreted(self, bound: BoundProgram,
                        inputs: Optional[dict] = None, rimfs=None,
                        probe: Optional[dict] = None) -> dict:
        """Interpret the program op-by-op (the per-op baseline); ``probe``
        as in ``run``."""
        self._prog = bound.program
        self._explicit_free = rbl_explicitly_freed(bound.program)
        buffers = dict(bound.buffers)
        buffers.update(self._inputs_on_device(bound, inputs))
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
                self._dispatch(self.driver, op, buffers, bound.last_use,
                               idx, rimfs)
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
