"""One run of one cell: set-up, the closed loop over the wire, the window,
the drain, the check against the reference, and the result line.

The system under test is the port's serving path, whole: an
``InferenceServer`` on loopback with a ``ServingEngine`` (continuous
batching, eager B = 1 prefills on the hand kernels, the decode step as one
captured CUDA graph, greedy sampling), driven through ``Client``
connections, one a client of the mix. One thread drives every client: it
waits on all their sockets and sends a client's next request as soon as
its reply is in.

Set-up runs from process start to the window: the weights drawn on the
device, the engine built (its decode graph captured), the server started,
the clients connected, and the loop run until every client has had a
reply. The window then measures ``seconds`` of the same loop; the
requests still in flight when it closes are abandoned, not counted. A traced run
also wraps the engine instance's ``_pop_admitted``, ``_prefill``,
``_sample``, ``_decode`` and ``step`` from here (spans; nothing inside the
port changes) and profiles the last ``profile_seconds`` of the window on
the dispatcher thread.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import selectors
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

from perfbench import check, spec, trace, traffic, weights
from perfbench.record import Done, Record

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WAIT_S = 300.0             # the longest the harness waits on a reply or a
                           # control op before it gives the run up


class Spans:
    """Host spans around the engine instance's steps (traced runs only):
    each prefill from its call to the end of its first token's sampling
    (``_sample`` reads the token to the host, so that end is synced), each
    decode step's start and live positions. ``record_function`` marks the
    same spans for the profiler."""

    def __init__(self, engine):
        self.prefills: list = []      # (t0, t1, S)
        self.decodes: list = []       # (t0, positions)
        self.first: dict = {}         # prompt bytes -> t1 of its prefill
        self._admitted: list = []
        self._pending = None
        e = engine
        pop, prefill, sample = e._pop_admitted, e._prefill, e._sample
        decode, step = e._decode, e.step
        rf = torch.profiler.record_function

        def pop_admitted(free_slots, feasible=None):
            out = pop(free_slots, feasible)
            self._admitted.extend(out)
            return out

        def prefill_(params, batch):
            t0 = time.perf_counter()
            req = self._admitted.pop(0)
            with rf("bench.prefill"):
                out = prefill(params, batch)
            self._pending = (t0, req)
            return out

        def sample_(logits):
            with rf("bench.sample"):
                picks = sample(logits)
            if self._pending is not None:
                t0, req = self._pending
                t1 = time.perf_counter()
                self._pending = None
                self.prefills.append((t0, t1, len(req.prompt)))
                self.first[req.prompt.tobytes()] = t1
            return picks

        def decode_(params, cache, batch):
            live = [i for i, r in enumerate(e._slots) if r is not None]
            self.decodes.append((time.perf_counter(),
                                 e._pos[live].tolist()))
            with rf("bench.decode"):
                return decode(params, cache, batch)

        def step_():
            with rf("bench.step"):
                return step()

        e._pop_admitted, e._prefill, e._sample = pop_admitted, prefill_, \
            sample_
        e._decode, e.step = decode_, step_


class Profiler:
    """``torch.profiler`` over [start, stop) of the window, started and
    stopped on the dispatcher thread (where the engine's host ops run)
    between two engine steps, after a synchronize."""

    def __init__(self, server, device):
        self.server, self.device = server, device
        self.prof = None
        self.window_s = 0.0

    def _start(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA],
                            record_shapes=True)
        self.prof.start()
        self._t0 = time.perf_counter()

    def _stop(self):
        torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()

    def run(self, t_start: float, t_stop: float) -> threading.Thread:
        def job():
            time.sleep(max(0.0, t_start - time.perf_counter()))
            self.server.run_on_dispatcher(self._start, timeout=WAIT_S)
            time.sleep(max(0.0, t_stop - time.perf_counter()))
            self.server.run_on_dispatcher(self._stop, timeout=WAIT_S)
        th = threading.Thread(target=job, name="bench-profiler")
        th.start()
        return th


class Loop:
    """The closed loop: every client keeps one request in flight."""

    def __init__(self, address, mix: traffic.ClosedLoop):
        from repro_torch.serving.server import Client
        self.mix = mix
        self.clients = [Client(address) for _ in range(mix.clients)]
        self.sel = selectors.DefaultSelector()
        for c, cl in enumerate(self.clients):
            self.sel.register(cl.sock, selectors.EVENT_READ, c)
        self.sent = [0] * mix.clients
        self.inflight: dict = {}          # client -> (rid, request, t_send)
        self.done: list = []

    def send(self, c: int) -> None:
        req = self.mix.request(c, self.sent[c])
        self.sent[c] += 1
        t = time.perf_counter()
        rid = self.clients[c].infer_async(prompt=req.prompt,
                                          max_new=req.max_new)
        self.inflight[c] = (rid, req, t)

    def _receive(self, c: int) -> Done:
        rid, req, t_send = self.inflight.pop(c)
        try:
            out = self.clients[c].result(rid)
            tokens, err = np.asarray(out["tokens"], np.int64), None
        except Exception as e:                  # a refused or failed reply
            tokens, err = None, f"{type(e).__name__}: {e}"
        d = Done(client=c, index=req.index, prompt=req.prompt,
                 max_new=req.max_new, t_send=t_send,
                 t_reply=time.perf_counter(), tokens=tokens, error=err)
        self.done.append(d)
        return d

    def run(self, until, resend: bool, deadline: float) -> None:
        """Serve replies, resending while ``resend``, until ``until()``
        holds; raise TimeoutError past ``deadline``."""
        while not until():
            if time.perf_counter() > deadline:
                raise TimeoutError(f"{len(self.inflight)} requests had no "
                                   f"reply by the deadline")
            for key, _ in self.sel.select(timeout=0.05):
                c = key.data
                if c in self.inflight:
                    self._receive(c)
                    if resend:
                        self.send(c)

    def close(self) -> None:
        self.sel.close()
        for cl in self.clients:
            cl.close()


def _forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Served:
    """What a served run leaves once the program's state is freed: the
    weights the harness drew, every request as its client saw it, and the
    readers' record of the window."""
    cell: spec.Cell
    cfg: object
    params: dict
    done: list
    rec: Record
    memory_peak: int
    forbidden: list
    phases: dict              # seconds of set-up's parts


def serve(cell_name: str, seed: int, seconds: float, traced: bool,
          device="cuda", t_process: Optional[float] = None,
          root=None) -> Served:
    """Set up ``cell_name`` from ``seed``, run its closed loop until every
    client has had a reply, measure ``seconds`` of it, abandon what is
    still in flight, and free the program's state. ``device="cpu"`` runs
    the same path on the CPU (tests, at a tiny configuration); the command
    line refuses it."""
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.server import InferenceServer

    t_process = time.perf_counter() if t_process is None else t_process
    root = spec.ROOT if root is None else root
    cell = spec.load_cell(cell_name, root)
    cfg = spec.port_config(cell.config)
    eng_spec = cell.config["port"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    mix = traffic.ClosedLoop(cell.traffic, seed, cfg.vocab_size)
    if mix.longest() >= eng_spec["max_seq"]:
        raise ValueError(f"{cell_name}: a request of {mix.longest()} "
                         f"positions exceeds max_seq {eng_spec['max_seq']}")

    phases = {}
    t = time.perf_counter()
    params = weights.draw(tf.model_specs(cfg), seed, dev)
    if on_card:
        torch.cuda.synchronize(dev)
    phases["weights_s"] = time.perf_counter() - t
    t = time.perf_counter()
    engine = ServingEngine(cfg, params, max_batch=eng_spec["max_batch"],
                           max_seq=eng_spec["max_seq"], device=dev)
    phases["engine_s"] = time.perf_counter() - t
    spans = Spans(engine) if traced else None
    server = InferenceServer(device=dev, engine=engine)
    server.start()
    loop = Loop(server.address, mix)
    prof_thread = profiler = None
    try:
        t_ramp = time.perf_counter()
        for c in range(mix.clients):
            loop.send(c)
        served = set()

        def ramped():
            served.update(d.client for d in loop.done)
            return len(served) == mix.clients
        loop.run(ramped, resend=True, deadline=t_ramp + WAIT_S)
        if on_card:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        phases["ramp_s"] = t0 - t_ramp
        setup_s = t0 - t_process
        t1 = t0 + seconds
        n_ramp = len(loop.done)
        n_tel = engine.telemetry.count()
        if traced and on_card:
            profiler = Profiler(server, dev)
            prof_s = min(float(cell.traffic.get("profile_seconds", 3)),
                         seconds / 2)
            prof_thread = profiler.run(t1 - prof_s, t1)
        loop.run(lambda: time.perf_counter() >= t1, resend=True,
                 deadline=t1 + WAIT_S)
        decode_tel = engine.telemetry.summary(warmup=n_tel)
        n_window = len(loop.done)
        if prof_thread is not None:
            prof_thread.join(WAIT_S)
    finally:
        # the requests still in flight are abandoned: their clients close
        # and the dispatcher stops after its current step
        loop.close()
        server.stop(drain=False)
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    forbidden = _forbidden_modules()

    window = [d for d in loop.done[n_ramp:n_window] if t0 <= d.t_reply <= t1]
    rec = Record(cfg=cfg, config=cell.config, window=(t0, t1),
                 setup_s=setup_s, done=window, decode_step_s=decode_tel)
    if spans is not None:
        for d in loop.done:
            d.t_first = spans.first.get(d.prompt.tobytes())
        rec.prefills = [p for p in spans.prefills if t0 <= p[1] <= t1]
        rec.decodes = [x for x in spans.decodes if t0 <= x[0] <= t1]
    if profiler is not None and profiler.prof is not None:
        rec.trace = trace.reduce(profiler.prof, profiler.window_s)

    # the program's state goes before the reference runs: only the weights
    # the harness drew stay
    server.engine = None
    del engine, server, spans, profiler
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return Served(cell=cell, cfg=cfg, params=params, done=loop.done,
                  rec=rec, memory_peak=int(memory_peak), forbidden=forbidden,
                  phases=phases)


def run(cell_name: str, seed: int, seconds: float, traced: bool,
        device="cuda", t_process: Optional[float] = None,
        root=None) -> dict:
    """One run of ``cell_name`` (``serve``), checked against the
    reference; returns the result dict, ``checks`` last."""
    root = spec.ROOT if root is None else root
    limits = check.load_limits(cell_name, root)
    s = serve(cell_name, seed, seconds, traced, device, t_process, root)
    picked = check.pick(s.done, seed, s.cell.traffic["check"])
    gaps = check.served_gaps(s.cell.config, s.params, picked)
    result_checks = check.checks(s.done, s.cfg.vocab_size, gaps, limits)
    rec = s.rec
    metrics = {}
    for m in spec.metrics_for(s.cell, traced):
        v = spec.load_reader(m["name"], root).read(rec)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    on_card = torch.device(device).type == "cuda"
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card
                   else "cpu",
                   "count": 1, "memory_peak_bytes": s.memory_peak}
    if traced and rec.trace is not None:
        device_info["busy_s"] = rec.trace["busy_s"]
        device_info["window_s"] = rec.trace["window_s"]
    out = {"correct": check.passed(result_checks) and not s.forbidden,
           "attempted": len(rec.done),
           "failed": sum(1 for d in rec.done if not d.ok),
           "metrics": metrics, "device": device_info}
    if traced and rec.trace is not None:
        out["breakdown"] = rec.trace["breakdown"]
    out["forbidden_modules"] = s.forbidden
    out["setup_phases"] = s.phases
    out["checks"] = result_checks
    return out
