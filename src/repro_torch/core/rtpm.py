"""Runtime Platform Management — the system executive.

The port's counterpart of ``repro.core.rtpm``. In the paper RTPM replaces
the OS for asynchronous event handling (a unified ISR dispatcher) and host
connectivity/telemetry over a CRC-32-framed network stack. This module
provides:

  * ``EventDispatcher`` — the unified ISR analogue: typed events
    (completion, error, heartbeat, preemption) fan out to registered
    handlers from a single queue.
  * ``Telemetry``       — per-step latency ring buffer; mean / percentile /
    CV (the paper's headline determinism metric).
  * ``HeartbeatMonitor``— worker liveness with an injectable clock; a
    deadline policy yields failure + straggler verdicts (the 1000-node
    fault-tolerance hook; tests drive it with a fake clock).
  * ``ServiceLoop``     — the single-owner dispatcher worker: N producer
    threads enqueue work into a bounded queue, ONE heartbeat-monitored
    thread drains it, so every piece of state the handler touches is
    owned by exactly one thread (the serving path's concurrency model).
  * ``Platform``        — glue: provisioning (mount RIMFS image + decode
    RCB program from bytes — the network payloads, CRC-checked before any
    parse), fsck at bring-up, and binding onto the platform's RHAL driver.

Thread-safety: the network server calls into RTPM from connection-handler
threads while the dispatcher runs, so ``EventDispatcher``, ``Telemetry``
and ``HeartbeatMonitor`` take internal locks (handlers run outside the
dispatcher lock so they may re-post without deadlocking).
"""
from __future__ import annotations

import collections
import dataclasses
import queue as queue_mod
import statistics
import threading
import time
from typing import Any, Callable, Optional

from repro_torch.core import rbl as rbl_mod
from repro_torch.core import rhal as rhal_mod
from repro_torch.core import rimfs as rimfs_mod
from repro_torch.core.rcb import RCBProgram


# ---------------------------------------------------------------------------
# Events (unified ISR dispatcher)
# ---------------------------------------------------------------------------

class EventDispatcher:
    def __init__(self):
        self._handlers: dict[str, list[Callable]] = collections.defaultdict(list)
        self._queue: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self.dropped = 0

    def register(self, kind: str, handler: Callable[[dict], None]) -> None:
        with self._lock:
            self._handlers[kind].append(handler)

    def post(self, kind: str, payload: Optional[dict] = None) -> None:
        self._queue.append((kind, payload or {}))

    def process(self, max_events: Optional[int] = None) -> int:
        """Drain the queue; safe to call from several threads at once.
        Events pop under the lock but handlers run OUTSIDE it, so a
        handler may ``post`` (or even ``process``) without deadlocking."""
        n = 0
        while max_events is None or n < max_events:
            with self._lock:
                if not self._queue:
                    return n
                kind, payload = self._queue.popleft()
                handlers = list(self._handlers.get(kind) or ())
                if not handlers:
                    self.dropped += 1
            for h in handlers:
                h(payload)
            n += 1
        return n


# ---------------------------------------------------------------------------
# Telemetry
# ---------------------------------------------------------------------------

class Telemetry:
    def __init__(self, capacity: int = 65536):
        self._lat: collections.deque = collections.deque(maxlen=capacity)
        self._metrics: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.bytes_moved = 0
        self.bytes_overlapped = 0
        self._counters: dict = collections.defaultdict(int)

    def incr(self, name: str, n: int = 1) -> None:
        """Monotonic fault/recovery counters (the integrity plane's
        telemetry surface: DESIGN.md §11 maps each fault class here)."""
        with self._lock:
            self._counters[name] += int(n)

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def record_latency(self, seconds: float) -> None:
        self._lat.append(seconds)

    def count(self) -> int:
        """Samples recorded so far (ring-capped). With ``summary(warmup=
        prev_count)`` this gives windowed stats over only the samples that
        landed since a controller's previous observation (the brown-out
        ladder's queue-wait p99 signal)."""
        return len(self._lat)

    def record_dma(self, bytes_moved: int, bytes_overlapped: int = 0) -> None:
        """Data-movement accounting from the residency plan: total DMA
        payload vs the split-phase share that overlapped compute (the
        paper's 3-7x data-movement story, DESIGN.md §6)."""
        with self._lock:
            self.bytes_moved += int(bytes_moved)
            self.bytes_overlapped += int(bytes_overlapped)

    def dma_summary(self) -> dict:
        moved, over = self.bytes_moved, self.bytes_overlapped
        return {"bytes_moved": moved, "bytes_overlapped": over,
                "overlap_fraction": over / moved if moved else 0.0}

    def record(self, **metrics) -> None:
        self._metrics.append(dict(metrics, t=time.time()))

    def summary(self, warmup: int = 0) -> dict:
        xs = list(self._lat)[warmup:]
        if len(xs) < 2:
            return {"n": len(xs)}
        xs_sorted = sorted(xs)
        mu = statistics.fmean(xs)
        sd = statistics.stdev(xs)
        q = lambda p: xs_sorted[min(len(xs) - 1, int(p * len(xs)))]
        return {
            "n": len(xs), "mean": mu, "std": sd,
            "cv_percent": 100.0 * sd / mu if mu else float("inf"),
            "p50": q(0.50), "p95": q(0.95), "p99": q(0.99),
            "min": xs_sorted[0], "max": xs_sorted[-1],
        }


# ---------------------------------------------------------------------------
# Heartbeats / failure & straggler detection
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WorkerState:
    last_beat: float
    step: int = 0
    alive: bool = True
    gap_ewma: Optional[float] = None   # EWMA of inter-beat gaps (seconds)


class HeartbeatMonitor:
    """Deadline-policy liveness. ``clock`` injectable for determinism.

    Two verdict tiers: a worker silent past ``deadline`` is **failed**
    (dead until it beats again); a live worker whose silence exceeds its
    own measured rhythm — EWMA of inter-beat gaps × ``straggler_factor``
    — is a **straggler**. The per-worker EWMA is what lets a fleet
    controller distinguish a slow-but-alive group from a dead one long
    before the wall-clock deadline expires: a worker that beat every
    50 ms and has been silent for half a second is in trouble *now*,
    not in ``deadline`` seconds. ``straggler_floor`` keeps sub-floor
    silences from flagging fast beaters between polls.
    """

    def __init__(self, deadline: float = 10.0, straggler_factor: float = 3.0,
                 clock: Callable[[], float] = time.monotonic,
                 gap_alpha: float = 0.3, straggler_floor: float = 0.05):
        self.deadline = deadline
        self.straggler_factor = straggler_factor
        self.clock = clock
        self.gap_alpha = gap_alpha
        self.straggler_floor = straggler_floor
        self.workers: dict[str, WorkerState] = {}
        self._lock = threading.Lock()

    def beat(self, worker: str, step: int = 0) -> None:
        now = self.clock()
        with self._lock:
            w = self.workers.get(worker)
            if w is None:
                self.workers[worker] = WorkerState(now, step)
            else:
                if w.alive and w.last_beat > float("-inf"):
                    gap = max(0.0, now - w.last_beat)
                    w.gap_ewma = gap if w.gap_ewma is None else \
                        (1 - self.gap_alpha) * w.gap_ewma \
                        + self.gap_alpha * gap
                else:
                    w.gap_ewma = None      # revival: old rhythm is stale
                w.last_beat, w.step, w.alive = now, step, True

    def register_silent(self, worker: str, step: int = 0) -> None:
        """Register a worker that did NOT answer the registration poll: it
        fails the next deadline check instead of looking freshly alive (a
        beat would stamp 'now' and mask the silence)."""
        with self._lock:
            if worker not in self.workers:
                self.workers[worker] = WorkerState(float("-inf"), step)

    def check(self) -> dict:
        """Returns {"failed": [...], "stragglers": [...], "median_step": n,
        "verdicts": {worker: "failed"|"straggler"|"ok"}}.

        Straggler evidence, any of: silence past ``deadline/factor``
        (wall-clock policy), step count lagging the live median, or —
        the per-worker rhythm signal — silence past
        ``max(floor, gap_ewma * factor)`` for workers with a measured
        inter-beat EWMA."""
        now = self.clock()
        failed, stragglers = [], []
        verdicts: dict[str, str] = {}
        with self._lock:
            steps = [w.step for w in self.workers.values() if w.alive]
            median_step = sorted(steps)[len(steps) // 2] if steps else 0
            for name, w in self.workers.items():
                if not w.alive:
                    verdicts[name] = "failed"
                    continue
                age = now - w.last_beat
                rhythm_lag = w.gap_ewma is not None and \
                    age > max(self.straggler_floor,
                              w.gap_ewma * self.straggler_factor)
                if age > self.deadline:
                    w.alive = False
                    failed.append(name)
                    verdicts[name] = "failed"
                elif age > self.deadline / self.straggler_factor or \
                        w.step + 2 < median_step or rhythm_lag:
                    stragglers.append(name)
                    verdicts[name] = "straggler"
                else:
                    verdicts[name] = "ok"
        return {"failed": failed, "stragglers": stragglers,
                "median_step": median_step, "verdicts": verdicts}


# ---------------------------------------------------------------------------
# ServiceLoop — the single-owner dispatcher worker
# ---------------------------------------------------------------------------

_DRAIN = object()          # sentinel: drain what's queued, then exit


class Watchdog:
    """Per-dispatch deadline enforcement for the ServiceLoop.

    ``arm(item)`` before the handler runs, ``disarm()`` after; a monitor
    thread polls and, once the armed dispatch outlives its budget,
    fires ``on_hang(item)`` exactly ONCE for that dispatch (outside the
    lock, so the hook may kill tile groups and post events freely — the
    hung handler thread then unwedges through the normal ``TileFailure``
    path, because the guarded driver slots start raising).

    Budgets come from ``budget_fn(item)`` at arm time — the scheduler
    EWMA × slack policy lives in the caller's closure, not here. A
    ``None`` / non-finite budget leaves the dispatch unwatched (boot
    grace: no EWMA observation yet means no defensible deadline).
    """

    def __init__(self, budget_fn: Callable[[Any], Optional[float]],
                 on_hang: Callable[[Any], None], poll: float = 0.02):
        self.budget_fn = budget_fn
        self.on_hang = on_hang
        self.poll = poll
        self.stats = {"armed": 0, "preemptions": 0}
        self._lock = threading.Lock()
        self._gen = 0
        self._fired_gen = -1
        self._armed: Optional[tuple] = None     # (gen, item, deadline)
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rtpm-watchdog")
        self._thread.start()

    def arm(self, item: Any) -> None:
        try:
            budget = self.budget_fn(item)
        except Exception:
            budget = None
        with self._lock:
            self._gen += 1
            if budget is None or not (0 <= budget < float("inf")):
                self._armed = None
                return
            self.stats["armed"] += 1
            self._armed = (self._gen, item, time.monotonic() + budget)

    def disarm(self) -> None:
        with self._lock:
            self._armed = None

    def _run(self) -> None:
        while not self._closed.wait(self.poll):
            fire = None
            with self._lock:
                if self._armed is not None:
                    gen, item, deadline = self._armed
                    if time.monotonic() >= deadline and \
                            gen != self._fired_gen:
                        self._fired_gen = gen   # once per dispatch
                        self.stats["preemptions"] += 1
                        fire = item
            if fire is not None:
                try:
                    self.on_hang(fire)
                except Exception:
                    pass                        # the hook must never kill us

    def close(self) -> None:
        self._closed.set()
        self._thread.join(timeout=2.0)


class ServiceLoop:
    """Bounded work queue drained by ONE heartbeat-monitored thread.

    The serving path's concurrency model in one object: any number of
    producer threads call ``submit`` (non-blocking — a full queue or a
    draining loop returns ``False``, the caller's backpressure signal),
    and a single worker thread owns everything the ``handler`` touches.
    No shared device state, no lock sprinkling — races are eliminated at
    the root by ownership.

    The worker registers with the platform's ``HeartbeatMonitor`` under
    ``name`` and beats every iteration (including idle polls), so a hung
    handler is caught by the same deadline policy that watches tile
    workers. ``on_idle`` (optional) runs whenever the queue is empty —
    and, when it reports progress by returning True, between queue pops —
    which is how the serving engine's continuous-batching decode steps
    interleave with request intake. Queue-wait and handler latency land
    in two ``Telemetry`` rings for the TELEMETRY wire message.
    """

    def __init__(self, platform: "Platform", handler: Callable[[Any], None],
                 name: str = "dispatcher", max_queue: int = 256,
                 poll: float = 0.02,
                 on_idle: Optional[Callable[[], bool]] = None,
                 on_drop: Optional[Callable[[Any], None]] = None,
                 watchdog_budget: Optional[Callable[[Any],
                                                    Optional[float]]] = None,
                 on_hang: Optional[Callable[[Any], None]] = None,
                 watchdog_poll: float = 0.02):
        self.platform = platform
        self.handler = handler
        self.name = name
        self.poll = poll
        self.on_idle = on_idle
        self.on_drop = on_drop
        self.queue_wait = Telemetry()
        self.dispatch_latency = Telemetry()
        self.stats = {"processed": 0, "rejected": 0, "errors": 0}
        self._stats_lock = threading.Lock()   # "rejected" is multi-producer
        self._submit_lock = threading.Lock()  # orders submits vs close()
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=max_queue)
        self._draining = threading.Event()
        self._drain_on_exit = True
        self._step = 0
        self._current: Any = None             # in-flight item (worker-owned)
        self.watchdog: Optional[Watchdog] = None
        if watchdog_budget is not None and on_hang is not None:
            self.watchdog = Watchdog(watchdog_budget, on_hang,
                                     poll=watchdog_poll)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"rtpm-{name}")
        platform.heartbeats.beat(name, 0)
        self._thread.start()

    # ------------------------------------------------------------- producers
    def submit(self, item: Any) -> bool:
        """Enqueue from any thread. False == rejected (backpressure).

        The drain-check + put happen under ``_submit_lock`` — ``close``
        sets the draining flag under the same lock, so an accepted item
        is ALWAYS ahead of the drain sentinel in the queue (a submit that
        returned True cannot be silently dropped by a racing shutdown)."""
        with self._submit_lock:
            if not self._draining.is_set():
                try:
                    self._q.put_nowait((time.monotonic(), item))
                    return True
                except queue_mod.Full:
                    pass
        with self._stats_lock:
            self.stats["rejected"] += 1
        return False

    def reject(self) -> None:
        """Count an item the caller refused BEFORE enqueue (e.g. an
        admission-cap refusal) so the rejected stat covers all paths."""
        with self._stats_lock:
            self.stats["rejected"] += 1

    def depth(self) -> int:
        return self._q.qsize()

    # --------------------------------------------------------------- worker
    def _idle(self) -> bool:
        """on_idle, guarded: an exception must degrade to 'no progress',
        never kill the dispatcher thread (the whole server would go dark
        while still accepting connections)."""
        if self.on_idle is None:
            return False
        try:
            return bool(self.on_idle())
        except Exception as e:
            self.stats["errors"] += 1
            self.platform.post("dispatch_error",
                               {"worker": self.name, "error": repr(e)})
            return False

    def _run(self) -> None:
        hb = self.platform.heartbeats
        while True:
            busy = self._idle()
            try:
                got = self._q.get_nowait() if busy \
                    else self._q.get(timeout=self.poll)
            except queue_mod.Empty:
                hb.beat(self.name, self._step)
                continue
            if got is _DRAIN:
                # graceful drain: finish whatever on_idle is still working
                # through (e.g. in-flight continuous-batching decodes).
                # A forced close (drain=False) skips this — the caller
                # refuses the leftovers explicitly instead.
                while self._drain_on_exit and self._idle():
                    hb.beat(self.name, self._step)
                hb.beat(self.name, self._step)
                return
            t_enq, item = got
            self._step += 1
            hb.beat(self.name, self._step)
            self.queue_wait.record_latency(time.monotonic() - t_enq)
            self._current = item
            if self.watchdog is not None:
                self.watchdog.arm(item)
            t0 = time.perf_counter()
            try:
                self.handler(item)
            except Exception as e:      # handler owns replies; never die
                self.stats["errors"] += 1
                self.platform.post("dispatch_error",
                                   {"worker": self.name, "error": repr(e)})
            finally:
                if self.watchdog is not None:
                    self.watchdog.disarm()
                self._current = None
            self.stats["processed"] += 1
            self.dispatch_latency.record_latency(time.perf_counter() - t0)

    # ------------------------------------------------------------ lifecycle
    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the worker. ``drain=True`` processes everything already
        queued first (graceful SHUTDOWN); ``drain=False`` hands each
        dropped item to ``on_drop`` so its submitter can be refused
        explicitly rather than left waiting forever.

        ``timeout`` bounds the WHOLE call. If the worker is wedged inside
        a handler and the drain promise cannot be kept, every still-queued
        item is handed to ``on_drop`` on the way out (refused, not lost)
        and the sentinel is left queued so a worker that eventually
        unwedges still exits; the heartbeat monitor is what reports the
        wedged dispatcher dead."""
        deadline = time.monotonic() + timeout
        with self._submit_lock:     # no submit can land after the sentinel
            self._draining.set()
        self._drain_on_exit = drain
        if not drain:
            self._hand_back()
        try:
            self._q.put(_DRAIN, timeout=max(0.0, deadline - time.monotonic()))
        except queue_mod.Full:      # worker stuck with a full queue: the
            pass                    # heartbeat deadline is the real alarm
        self._thread.join(max(0.0, deadline - time.monotonic()))
        if self._thread.is_alive():
            # wedged: the drain promise is broken — refuse the leftovers
            # explicitly (including the in-flight dispatch, whose
            # submitter would otherwise wait forever; reply-once guards
            # downstream make a late handler completion harmless), then
            # re-arm the sentinel for a late unwedge. The watchdog stays
            # up: its preemption is what unwedges the worker.
            self._drain_on_exit = False
            self._hand_back()
            cur = self._current
            if cur is not None and self.on_drop is not None:
                try:
                    self.on_drop(cur)
                except Exception:
                    pass
            try:
                self._q.put_nowait(_DRAIN)
            except queue_mod.Full:
                pass
        elif self.watchdog is not None:
            self.watchdog.close()

    def _hand_back(self) -> None:
        """Drain queued (never-started) items to ``on_drop``."""
        try:
            while True:
                got = self._q.get_nowait()
                if got is not _DRAIN and self.on_drop is not None:
                    self.on_drop(got[1])
        except queue_mod.Empty:
            pass

    def alive(self) -> bool:
        return self._thread.is_alive()

    def summary(self) -> dict:
        out = {**self.stats, "depth": self.depth(),
               "queue_wait": self.queue_wait.summary(),
               "dispatch": self.dispatch_latency.summary()}
        if self.watchdog is not None:
            out["watchdog"] = dict(self.watchdog.stats)
        return out


# ---------------------------------------------------------------------------
# Platform
# ---------------------------------------------------------------------------

class Platform:
    """The executive: provisioning, binding, readiness and elasticity on
    one device.

    The platform owns the RHAL driver of its device (``device=``, default
    ``"cuda"``), so every bind pins the weight image there once. Over a
    ``TileMesh`` it orchestrates partitioned runs (``run_partitioned``):
    every group a heartbeat-monitored worker, a failed stage re-queued on a
    survivor, the ``worker_failed`` / ``stage_requeued`` /
    ``stage_complete`` events fanned out through its dispatcher."""

    def __init__(self, deadline: float = 10.0,
                 clock: Callable[[], float] = time.monotonic,
                 device="cuda"):
        self._boot_t0 = time.perf_counter()
        self._ready_at: Optional[float] = None
        self.driver = rhal_mod.make_eager_driver(device)
        self.events = EventDispatcher()
        self.telemetry = Telemetry()
        self.heartbeats = HeartbeatMonitor(deadline=deadline, clock=clock)
        self.rimfs: Optional[rimfs_mod.RIMFS] = None
        self.program: Optional[RCBProgram] = None
        self.events.register("rcb_complete",
                             lambda p: self.telemetry.record(**p))
        self.events.register(
            "dma_complete",
            lambda p: self.telemetry.record_dma(
                p.get("bytes_moved", 0), p.get("bytes_overlapped", 0)))
        # fault-taxonomy counters: every integrity-plane event increments a
        # monotonic telemetry counter, observable over the TELEMETRY message
        for kind, counter in (("integrity_error", "integrity_errors"),
                              ("watchdog_preempt", "watchdog_preemptions"),
                              ("dma_retry", "dma_retries"),
                              ("rimfs_fsck", "rimfs_fscks"),
                              ("tile_failure", "tile_failures"),
                              ("batched_fallback", "batched_fallbacks")):
            self.events.register(
                kind, lambda p, c=counter: self.telemetry.incr(
                    c, p.get("n", 1)))

    # ------------------------------------------------------------ provision
    def provision(self, image=None, program_bytes=None,
                  program: Optional[RCBProgram] = None,
                  verify: bool = True) -> None:
        """Paper phase 1: load the model binary (RCBs + weights). Nothing
        parses before its CRC checks out: the program's whole-program CRC,
        the image's trailer CRC; then every file's CRC, before any bind.
        An image holding ``kernels/autotune.json`` loads its winner table
        into the kernel registry and posts ``autotune_loaded``."""
        if program_bytes is not None:
            program = RCBProgram.decode(bytes(program_bytes))
        if image is not None:
            if verify:
                rimfs_mod.check_image(image)     # trailer CRC, then parse
            fs = rimfs_mod.mount(image)
            if verify:
                fs.verify()                      # every file's CRC
                self.events.post("rimfs_fsck", {"phase": "provision"})
            if self.rimfs is not None:           # a re-provision frees the
                self.rimfs.unpin_all()           # old image's arena ranges
            self.rimfs = fs
            # the autotune cache's reload: an image carrying the kernel
            # registry's winner table installs it now (merged, an existing
            # key wins), so the kernels run their tuned plans with zero
            # sweep trials
            from repro_torch.kernels import registry as kreg
            if kreg.AUTOTUNE_FILE in fs.files():
                n = kreg.load_image(fs)
                self.events.post("autotune_loaded", {"entries": n})
        if program is not None:
            self.program = program
        self._ready_at = time.perf_counter()
        self.events.post("provisioned",
                         {"files": self.rimfs.files() if self.rimfs else []})

    def bind(self, inputs: Optional[dict] = None, driver=None,
             artifacts: Optional[dict] = None) -> rbl_mod.BoundProgram:
        """Paper phase 2: symbolic -> physical resolution, with the weights
        pinned on ``driver`` (the platform's own by default). ``artifacts``
        attaches the program's GRAPH_EXEC callables by id: they are not
        part of its bytes."""
        if self.program is None:
            raise RuntimeError("provision() first")
        if artifacts:
            self.program.artifacts.update(artifacts)
        return rbl_mod.bind(self.program, rimfs=self.rimfs, inputs=inputs,
                            driver=driver or self.driver)

    def time_to_service(self) -> float:
        """Boot -> ready: seconds from the platform's creation to the end
        of its last provision (the paper's Table 2 metric)."""
        if self._ready_at is None:
            raise RuntimeError("provision() first")
        return self._ready_at - self._boot_t0

    def post(self, kind: str, payload: Optional[dict] = None) -> None:
        self.events.post(kind, payload)
        self.events.process()

    # ---------------------------------------------------------- tile groups
    def run_partitioned(self, bound, inputs: Optional[dict] = None,
                        mesh=None, n_groups: int = 2, rimfs=None) -> dict:
        """Partitioned execution over a ``TileMesh`` (default: a fresh
        ``TileMesh(n_groups)`` on the platform's device) under this
        platform: every group is a heartbeat-monitored worker ("tile<g>")
        and a failed stage re-queues on a surviving group. ``bound`` is a
        BoundProgram (cut once per group count, cached) or a
        ``PartitionedProgram``; ``rimfs`` defaults to the provisioned
        image."""
        from repro_torch.core import partition as partition_mod
        from repro_torch.core.executor import Executor
        if mesh is None:
            mesh = rhal_mod.TileMesh(n_groups, device=self.driver.device)
        rimfs = rimfs if rimfs is not None else self.rimfs
        if isinstance(bound, partition_mod.PartitionedProgram):
            return partition_mod.execute(bound, mesh, inputs=inputs,
                                         rimfs=rimfs, platform=self)
        # the executor's driver is unused: the groups' drivers dispatch
        return Executor(driver=self.driver).run_partitioned(
            bound, inputs=inputs, rimfs=rimfs, mesh=mesh, platform=self)

    # ------------------------------------------------------------ elasticity
    def handle_failures(self, bound: rbl_mod.BoundProgram,
                        on_shrink: Optional[Callable] = None) -> dict:
        """Failure/straggler sweep. When workers died: post
        ``worker_failed``, call ``on_shrink(failed)``, and re-bind the
        program (the control stream is untouched, only the physical
        resources change). Returns the monitor's verdict."""
        verdict = self.heartbeats.check()
        if verdict["failed"]:
            self.post("worker_failed", {"workers": verdict["failed"]})
            if on_shrink is not None:
                on_shrink(verdict["failed"])
            rbl_mod.rebind(bound)
        return verdict
