"""Network-attached inference service (RTPM host-connectivity role).

The port's counterpart of ``repro.serving.server``: a socket server speaking
the CRC-framed protocol (v1 + v2), serving a provisioned RCB program through
the plain-RCB route and, when built with a ``ServingEngine`` or a
``PagedServingEngine``, LM prompts through the engine's continuous
batching. The v2 frame extension (per-frame ``request_id`` +
flags) lets one connection pipeline many INFER_REQUESTs and receive the
responses out of order.

Concurrency model — **all device state behind one thread**: connection
handler threads only parse frames and enqueue work; a single dispatcher
thread (an ``rtpm.ServiceLoop`` worker, heartbeat-monitored) owns the
``Platform``, the ``Executor``, the bound program and the engine.

Flow per request:

  handler thread:  recv_frame -> parse npz + admission metadata
                   -> INFER: ScheduledRequest into the DeadlineScheduler
                      (deadline anchored HERE, so queue wait counts against
                      it) + a dispatcher kick; admission-cap overflow ->
                      immediate ERROR/F_BUSY
                   -> an LM prompt (engine attached): the parsed prompt
                      to the dispatcher, where it enters the engine
                   -> everything else: ServiceLoop.submit
                      (queue full -> immediate ERROR/F_BUSY)
  dispatcher:      drains the scheduler through admit(1) in priority/EDF
                   order -> shed? ERROR/F_SHED with the verdict, before any
                   compute -> else the linked Executor path on the device;
                   results return to the host for the reply. When the
                   program passes the batch analysis, a backlog that is
                   ALREADY queued behind the head coalesces (up to
                   ``batch_window`` requests of one shape) into one
                   ``Executor.run_batched`` dispatch: one CUDA graph
                   replay per batch bucket
  idle hook:       after the plain backlog, one engine step (admission,
                   grouped prefill, one decode across the live slots);
                   finished prompts reply ``tokens`` by request id
  control op:      a callable the fleet or brown-out controller hands in
                   (``run_on_dispatcher``): it runs between two requests,
                   so a mesh flip, a binding swap or a rung change lands
                   atomically and no lock is added to the request path
  SHUTDOWN:        graceful drain — queued work is answered, then stop.

PROVISION binds with the executor's driver, so the weight image is pinned
on the device once and every request reuses it. With a ``TileMesh``
(``mesh=``) plain-RCB requests go through ``Executor.run_partitioned``
instead: the program binds to host views and each group pins its own
tile's weights on its first stage; a backlog never coalesces; and the
watchdog kills the group of the stage that hangs (``mesh.active_gid``),
whose stage then fails over to a survivor.

With ``platform.telemetry.tracing`` on, the LM route records each
request's ``server.queue`` under its engine id (the INFER frame parsed
and enqueued on its handler thread, to ``_infer_lm`` on the dispatcher;
the stamps of the dispatcher's queue-wait ring), and mirrors each reply
(the finished request seen in ``_pump_engine``, to its frame sent) into
``torch.profiler`` as ``server.reply``. The engine's own spans go into
``engine.telemetry``.
"""
from __future__ import annotations

import dataclasses
import itertools
import random
import select
import socket
import struct
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import linker as linker_mod
from repro_torch.core import rbl as rbl_mod
from repro_torch.core.executor import Executor
from repro_torch.core.integrity import IntegrityError
from repro_torch.core.rhal import TileFailure
from repro_torch.core.rtpm import NOSPAN, Platform, ServiceLoop
from repro_torch.dtypes import to_host
from repro_torch.serving import protocol as proto
from repro_torch.serving.scheduler import (RETRYABLE_KINDS, DeadlineScheduler,
                                           ScheduledRequest)


class ServerBusy(RuntimeError):
    """Reply carried F_BUSY/F_DRAINING: backpressure, retry later.

    ``kind`` / ``retry_after_ms`` mirror the reply payload when the
    server sent a structured refusal (v2 typed verdicts)."""
    kind: str = "busy"
    retry_after_ms: Optional[float] = None
    retryable: bool = True


class RequestShed(RuntimeError):
    """Reply carried F_SHED: admission policy shed the request.

    ``kind`` is the machine-readable verdict class (busy / shed /
    infeasible / out_of_blocks / brownout); ``retryable`` is False for
    terminal verdicts (an infeasible deadline, or an LM request that
    already sampled tokens and is no longer idempotent)."""
    kind: str = "shed"
    retry_after_ms: Optional[float] = None
    retryable: bool = True


class _Route:
    """Reply path to one connection: socket + send lock (the dispatcher
    and the connection's handler thread may both write to it).

    ``SO_SNDTIMEO`` bounds how long a non-reading client can stall the
    dispatcher — on timeout the route dies and the peer is on its own,
    instead of head-of-line blocking every other connection. The kernel
    option only affects sends, so the handler's blocking recv on the same
    socket is untouched (``settimeout`` would flip the shared file
    description to non-blocking and break it)."""

    def __init__(self, conn: socket.socket, send_timeout: float = 30.0):
        self.conn = conn
        if send_timeout:
            sec = int(send_timeout)
            usec = int((send_timeout - sec) * 1e6)
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                            struct.pack("ll", sec, usec))
        self.lock = threading.Lock()
        self.alive = True
        self._finals: dict = {}            # id(token) -> token (reply-once)
        self._finals_lock = threading.Lock()

    def send_final(self, token: Any, kind: proto.Msg, payload: bytes,
                   rid: int = 0, version: int = 1, flags: int = 0) -> bool:
        """Exactly-once terminal reply for ``token`` (the request object).

        A watchdog preemption racing ``close(timeout=)`` can leave two
        parties believing they own the reply — the unwedged dispatcher
        finishing late and the drop path refusing the in-flight item.
        Whichever calls first wins; the loser's send is a silent no-op,
        so a request id is NEVER answered twice. Tokens are held by
        strong reference (id() reuse after gc would break the guard)."""
        with self._finals_lock:
            if id(token) in self._finals:
                return False
            self._finals[id(token)] = token
        return self.send(kind, payload, rid=rid, version=version,
                         flags=flags)

    def send(self, kind: proto.Msg, payload: bytes, rid: int = 0,
             version: int = 1, flags: int = 0) -> bool:
        if not self.alive:
            return False
        try:
            with self.lock:
                if version >= 2:
                    proto.send_frame(self.conn, kind, payload,
                                     request_id=rid, flags=flags)
                else:
                    proto.send_frame(self.conn, kind, payload)
            return True
        except (OSError, ValueError):
            self.alive = False
            # tear the connection down rather than leaving the peer
            # blocked on a truncated frame (and the handler feeding more
            # work to a route that can no longer answer)
            try:
                self.conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            return False

    def close(self) -> None:
        """Retire the route (the handler's ``with conn`` owns the socket)."""
        self.alive = False


@dataclasses.dataclass
class _Work:
    frame: Optional[proto.Frame]        # None == dispatcher kick
    route: Optional[_Route]
    tensors: Optional[dict] = None      # parsed npz (INFER, LM path)
    meta: Optional[dict] = None         # admission metadata (LM path)
    control: Optional[Any] = None       # control op (callable): runs ON the
                                        # dispatcher thread, between requests


_KICK = _Work(frame=None, route=None)   # wake the dispatcher to drain


def _no_delay(sock: socket.socket) -> None:
    """A frame goes out as its head, payload parts and 4-byte CRC trailer
    (``protocol.send_frame``, so a multi-GB payload is never joined);
    with Nagle's algorithm on, the trailer waits for the peer's delayed
    ACK, tens of ms on each side of a request."""
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


class InferenceServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 device="cuda", artifacts: Optional[dict] = None,
                 engine=None, mesh=None,
                 scheduler: Optional[DeadlineScheduler] = None,
                 max_queue: int = 128, max_frame: int = proto.MAX_FRAME,
                 send_timeout: float = 30.0, batch_window: int = 8,
                 watchdog: bool = True, watchdog_slack: float = 16.0,
                 watchdog_floor: float = 2.0, watchdog_poll: float = 0.02):
        self.platform = Platform(device=device)
        self.executor = Executor(driver=self.platform.driver,
                                 rtpm=self.platform)
        # GRAPH_EXEC callables, attached to every provisioned program by id
        self.artifacts = artifacts or {}
        self.engine = engine            # optional ServingEngine (LM path)
        if engine is not None and engine.device != self.platform.driver.device:
            raise ValueError(f"engine on {engine.device}, server on "
                             f"{self.platform.driver.device}")
        self.mesh = mesh                # optional TileMesh (partitioned)
        if mesh is not None and mesh.device != self.platform.driver.device:
            raise ValueError(f"mesh on {mesh.device}, server on "
                             f"{self.platform.driver.device}")
        # the plain-RCB path and the engine each get their OWN scheduler: a
        # shared heap would let admit(1) pop the other path's entries
        self.scheduler = scheduler or DeadlineScheduler()
        if engine is not None and engine.scheduler is None:
            engine.scheduler = DeadlineScheduler()
        self.max_frame = max_frame
        self.max_queue = max_queue
        self.send_timeout = send_timeout
        # Dispatcher request coalescing: up to this many compatible
        # backlogged requests dispatch as ONE batched execution. 1 disables
        # coalescing. The window never delays a solo request — it only
        # widens over work that is ALREADY queued when the EDF head is
        # popped. ``fallbacks`` counts requests re-run one by one after a
        # batched dispatch failed (each also posts a platform event).
        self.batch_window = max(1, int(batch_window))
        self.batched_stats = {"dispatches": 0, "requests": 0,
                              "max_batch": 0, "fallbacks": 0,
                              "seconds": 0.0}
        # canary A/B state (core.fleet.CanaryState), installed and cleared
        # by the FleetController through control ops: dispatcher-owned, so
        # the request path reads it without a lock
        self.canary = None
        # brown-out rung 2 (serving.overload): the admission-time clamp on
        # an LM request's max_new; None is no clamp
        self.max_new_clamp: Optional[int] = None
        # control ops submitted and not yet run: the plain drain yields to
        # them after each admission round, so a flip is not held back for
        # as long as clients keep the admission queue non-empty
        self._controls_waiting = 0
        self._controls_lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.address = self._sock.getsockname()
        self._bound = None
        self._inflight: dict = {}       # iid -> (Request, _Route, rid, ver)
        self._iid = itertools.count(1)
        self._stop = threading.Event()
        self._stop_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        # Execution watchdog policy: per-dispatch budget = scheduler EWMA
        # x slack (floored — cold caches and kernel builds must not read as
        # hangs), with a boot grace until the first EWMA observation.
        self.watchdog_slack = watchdog_slack
        self.watchdog_floor = watchdog_floor
        self._executing: Any = None     # in-flight ScheduledRequest
        # the dispatcher: the ONE thread that touches device state
        self._loop = ServiceLoop(
            self.platform, self._dispatch_one,
            name="dispatcher", max_queue=max_queue,
            on_idle=self._on_idle, on_drop=self._drop_work,
            watchdog_budget=self._watchdog_budget if watchdog else None,
            on_hang=self._preempt_hung if watchdog else None,
            watchdog_poll=watchdog_poll)

    # ----------------------------------------------------------- lifecycle
    def start(self) -> tuple:
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        return self.address

    def stop(self, drain: bool = True) -> None:
        with self._stop_lock:
            if not self._stop.is_set():
                self._stop.set()
                try:
                    # unblock accept()
                    socket.create_connection(self.address, timeout=1).close()
                except OSError:
                    pass
                self._loop.close(drain=drain)
                # every accepted request still gets an explicit refusal
                payload = proto.pack_json({"error": "draining"})
                for s in self.scheduler.drain_pending():
                    r, srid, sver, _ = s.payload
                    r.send(proto.Msg.ERROR, payload, rid=srid,
                           flags=proto.F_DRAINING, version=sver)
                if not self._loop.alive():
                    # only touch dispatcher-owned state once the worker is
                    # really gone (a wedged worker may still resume)
                    for req, route, rid, ver in self._inflight.values():
                        route.send(proto.Msg.ERROR, payload, rid=rid,
                                   flags=proto.F_DRAINING, version=ver)
                    self._inflight.clear()
                self._sock.close()
                if self._bound is not None and not self._loop.alive():
                    # the batch buckets hold the bound weights: the
                    # module-wide cache must not outlive the server
                    Executor.release_graphs(self._bound)
        if self._thread and self._thread is not threading.current_thread():
            self._thread.join(timeout=5)

    # ------------------------------------------------------------- serving
    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            if self._stop.is_set():
                conn.close()
                return
            _no_delay(conn)
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            t.start()

    def _handle(self, conn: socket.socket) -> None:
        """Per-connection frame pump: parse + enqueue ONLY."""
        route = _Route(conn, send_timeout=self.send_timeout)
        with conn:
            try:
                self._pump_frames(conn, route)
            finally:
                route.close()

    def _pump_frames(self, conn: socket.socket, route: _Route) -> None:
        while not self._stop.is_set():
            try:
                frame = proto.recv_frame_ex(conn, max_frame=self.max_frame)
            except (ConnectionError, OSError):
                return
            except proto.ProtocolError as e:
                # malformed frame mid-stream: report with the reserved id 0
                # and close cleanly
                route.send(proto.Msg.ERROR,
                           proto.pack_json({"error": f"protocol: {e}"}),
                           rid=0, version=2)
                return
            try:
                if frame.kind == proto.Msg.HEARTBEAT:
                    self.platform.heartbeats.beat(
                        proto.unpack_json(frame.payload).get("worker", "?"))
                elif frame.kind == proto.Msg.SHUTDOWN:
                    route.send(proto.Msg.TELEMETRY,
                               proto.pack_json({"status": "draining"}),
                               rid=frame.request_id, version=frame.version)
                    self.stop(drain=True)       # graceful: queued work runs
                    return
                elif frame.kind == proto.Msg.INFER_REQUEST:
                    self._enqueue_infer(frame, route)
                elif not self._loop.submit(_Work(frame, route)):
                    flags = proto.F_DRAINING if self._stop.is_set() \
                        else proto.F_BUSY
                    route.send(
                        proto.Msg.ERROR,
                        self._busy_payload("busy: dispatch queue full",
                                           pending=self._loop.depth()),
                        rid=frame.request_id, flags=flags,
                        version=frame.version)
            except Exception as e:              # report, keep serving
                route.send(proto.Msg.ERROR,
                           proto.pack_json({"error": str(e)}),
                           rid=frame.request_id, version=frame.version)

    def _enqueue_infer(self, frame: proto.Frame, route: _Route) -> None:
        """Handler-thread half of an INFER_REQUEST: parse the npz and the
        admission metadata, then either enqueue a ScheduledRequest (plain
        RCB, deadline anchored NOW) or ship the parsed prompt to the
        dispatcher (LM path: the engine's state has one owner). No device
        state is touched here."""
        tensors = proto.unpack_tensors(frame.payload)
        meta = {k: tensors.pop(k) for k in list(tensors)
                if k.startswith("__")}
        priority = int(meta["__priority"]) if "__priority" in meta else 1
        deadline = None
        if "__deadline_ms" in meta:
            deadline = time.monotonic() + float(meta["__deadline_ms"]) / 1e3
        rid, ver = frame.request_id, frame.version
        if self.engine is not None and "prompt" in tensors:
            admission = {"priority": priority, "deadline": deadline,
                         "max_new": int(meta.get("__max_new", 16))}
            if not self._loop.submit(_Work(frame, route, tensors=tensors,
                                           meta=admission)):
                route.send(proto.Msg.ERROR,
                           self._busy_payload("busy: dispatch queue full"),
                           rid=rid, flags=proto.F_BUSY, version=ver)
            return
        if self.scheduler.pending() >= self.max_queue:
            self._loop.reject()
            route.send(proto.Msg.ERROR,
                       self._busy_payload("busy: admission queue full",
                                          pending=self.scheduler.pending()),
                       rid=rid, flags=proto.F_BUSY, version=ver)
            return
        # the kick IS the admission ticket: an accepted kick guarantees a
        # live dispatcher will drain this request; a refused kick means the
        # dispatcher is full or draining, so the request is refused too
        if not self._loop.submit(_KICK):
            flags = proto.F_DRAINING if self._stop.is_set() \
                else proto.F_BUSY
            route.send(proto.Msg.ERROR,
                       self._busy_payload("busy: dispatch queue full"),
                       rid=rid, flags=flags, version=ver)
            return
        self.scheduler.submit(ScheduledRequest(
            rid=rid, tokens_needed=1, priority=priority, deadline=deadline,
            payload=(route, rid, ver, tensors)))

    # ------------------------------------------------------------ watchdog
    def _watchdog_budget(self, token: Any) -> Optional[float]:
        """Deadline for one armed dispatch; None == unwatched. ``_Work``
        items (PROVISION, kicks) are never watched at the loop level; the
        server arms the request itself around its execution."""
        if isinstance(token, _Work):
            return None
        if self.scheduler.observations == 0:
            return None                 # boot grace: no EWMA evidence yet
        return max(self.watchdog_floor,
                   self.scheduler.est * self.watchdog_slack)

    def _preempt_hung(self, token: Any) -> None:
        """Watchdog hook (on the watchdog thread): a dispatch blew its
        deadline. Over a mesh, kill the hung stage's tile group through the
        ``TileFailure`` path: its guarded slots start raising in the hung
        dispatcher, which unwedges and fails the stage over to a survivor;
        the dead group's arena stays quarantined until revived. Without a
        mesh the preemption is only counted."""
        mesh = self.mesh
        gid = mesh.active_gid if mesh is not None else None
        self.platform.post("watchdog_preempt", {"group": gid})
        if gid is not None and mesh.alive(gid):
            mesh.kill(gid)

    # ------------------------------------------------------ typed refusals
    def _retry_after_ms(self) -> int:
        """Backpressure hint: roughly how long the current backlog takes to
        drain at the admission EWMA's pace."""
        est = self.scheduler.est if self.scheduler.observations else 0.01
        depth = self._loop.depth() + self.scheduler.pending()
        return int(min(2000.0, max(1.0, est * (depth + 1) * 1000.0)))

    def _shed_payload(self, kind: str, verdict: str,
                      retryable: Optional[bool] = None) -> bytes:
        """Machine-readable shed reply: ``kind`` tells the client why, so
        it can tell retryable pressure from terminal verdicts."""
        kind = kind or "shed"
        if retryable is None:
            retryable = kind in RETRYABLE_KINDS
        return proto.pack_json(
            {"error": "shed", "kind": kind, "verdict": verdict,
             "retryable": retryable,
             "retry_after_ms": self._retry_after_ms() if retryable else 0})

    def _busy_payload(self, msg: str, **extra) -> bytes:
        return proto.pack_json(
            {"error": msg, "kind": "busy", "retryable": True,
             "retry_after_ms": self._retry_after_ms(), **extra})

    # ---------------------------------------------------------- dispatcher
    def _dispatch_one(self, work: _Work) -> None:
        """Runs ONLY on the ServiceLoop worker thread."""
        if work.control is not None:            # control op: between
            work.control()                      # requests IS the drain point
            return
        if work.frame is None:                  # kick: drain the admission q
            self._drain_plain()
            return
        frame, route = work.frame, work.route
        rid, ver = frame.request_id, frame.version
        try:
            if frame.kind == proto.Msg.PROVISION:
                self._provision(frame.payload)
                route.send(proto.Msg.TELEMETRY,
                           proto.pack_json({"status": "ready"}),
                           rid=rid, version=ver)
            elif frame.kind == proto.Msg.INFER_REQUEST:
                self._infer_lm(work)
            elif frame.kind == proto.Msg.TELEMETRY:
                route.send(proto.Msg.TELEMETRY,
                           proto.pack_json(self._telemetry_summary()),
                           rid=rid, version=ver)
            else:
                raise RuntimeError(f"unexpected message {frame.kind!r}")
        except Exception as e:                  # report, keep serving
            route.send(proto.Msg.ERROR, proto.pack_json({"error": str(e)}),
                       rid=rid, version=ver)

    def _coalescible(self) -> bool:
        """True when backlogged requests may batch: no tile mesh is
        attached (the partitioned path runs one sample through the stages),
        no canary is installed (its A/B split and per-request compare are
        defined per request id), the program is provisioned and it passes
        the batch analysis — otherwise a batched dispatch would just
        serialize inside run_batched and inflate queue wait for nothing."""
        return (self.batch_window > 1 and self.mesh is None
                and self._bound is not None and self.canary is None
                and linker_mod.batch_analysis(self._bound).batchable)

    @staticmethod
    def _tensor_sig(tensors: dict) -> tuple:
        """Shape/dtype signature two requests must share to ride one
        batched dispatch (they stack on a new leading axis)."""
        sig = []
        for k, v in tensors.items():
            if not hasattr(v, "dtype"):
                v = np.asarray(v)
            sig.append((k, tuple(v.shape), str(v.dtype)))
        return tuple(sorted(sig))

    def _drain_plain(self) -> bool:
        """Drain the admission queue in priority/EDF order: shed infeasible
        requests with their verdicts, execute the rest.

        Coalescing: EDF picks the head as before; when the program is
        batchable, a bounded batch window then gathers up to
        ``batch_window - 1`` more requests that are ALREADY in the backlog
        (``admit`` pops only queued work — a solo request is never delayed
        waiting for company). Same-signature runs dispatch as one batched
        execution (replies scatter back by request id); signature changes
        split the window, preserving admission order. A run of one stays
        on ``Executor.run``."""
        progressed = False
        while True:
            admitted = self.scheduler.admit(1)
            if admitted and self._coalescible():
                admitted += self.scheduler.admit(self.batch_window - 1)
            for s in self.scheduler.drain_shed():
                r, srid, sver, _ = s.payload
                r.send(proto.Msg.ERROR,
                       self._shed_payload(s.verdict_kind, s.verdict),
                       rid=srid, flags=proto.F_SHED, version=sver)
                progressed = True
            if not admitted:
                return progressed
            # split the admitted window into maximal same-signature runs
            # (EDF order preserved across runs)
            runs: list = []
            for s in admitted:
                sig = self._tensor_sig(s.payload[3])
                if runs and runs[-1][0] == sig:
                    runs[-1][1].append(s)
                else:
                    runs.append((sig, [s]))
            for _, run in runs:
                if len(run) == 1:
                    self._dispatch_single(run[0])
                else:
                    self._dispatch_batch(run)
                progressed = True
            if self._controls_waiting:      # the rest drains after it
                return progressed

    def _execute_request(self, tensors: dict, rid: int) -> tuple:
        """One plain-RCB execution, canary-aware. Returns (out, flags).

        With a canary installed, a hash-routed fraction of requests runs on
        the shadow binding; a sampled subset of those ALSO runs the primary
        and bit-compares, feeding the SPRT an agree/disagree observation. A
        sampled disagreement is answered with the PRIMARY's bytes: the
        canary never serves a byte it has been caught getting wrong.
        Shadow-served replies carry F_CANARY."""
        canary = self.canary
        if canary is None or not canary.routes(rid):
            return self._infer(tensors), 0
        canary.stats["routed"] += 1
        shadow_out = self._infer(tensors, bound=canary.bound, fs=canary.fs)
        if canary.samples(rid):
            primary_out = self._infer(tensors)
            agree = canary.judge(primary_out, shadow_out)
            canary.record(agree)
            self.platform.post("canary_sample",
                               {"rid": rid, "agree": agree})
            if not (agree and canary.serve_shadow):
                return primary_out, 0
        elif not canary.serve_shadow:
            return self._infer(tensors), 0
        canary.stats["served_shadow"] += 1
        return shadow_out, proto.F_CANARY

    def _dispatch_single(self, s) -> None:
        r, srid, sver, sts = s.payload
        wd = self._loop.watchdog
        self._executing = s
        t0 = time.perf_counter()
        try:
            if wd is not None:
                wd.arm(s)
            try:
                out, oflags = self._execute_request(sts, srid)
            except (TileFailure, IntegrityError) as e:
                # recoverable fault taxonomy: one re-run (a corrupted
                # transfer re-issues from its retained source)
                kind = "integrity_error" if isinstance(e, IntegrityError) \
                    else "tile_failure"
                self.platform.post(kind, {"stage": "dispatch",
                                          "error": str(e)})
                if wd is not None:
                    wd.arm(s)           # fresh budget for the re-run
                out, oflags = self._execute_request(sts, srid)
        except Exception as e:                  # report, keep draining
            r.send_final(s, proto.Msg.ERROR,
                         proto.pack_json({"error": str(e)}),
                         rid=srid, version=sver)
            return
        finally:
            if wd is not None:
                wd.disarm()
            self._executing = None
        dt = time.perf_counter() - t0
        self.platform.telemetry.record_latency(dt)
        self.scheduler.observe_step_latency(dt)
        r.send_final(s, proto.Msg.INFER_RESPONSE, proto.pack_tensors(out),
                     rid=srid, version=sver, flags=oflags)

    def _dispatch_batch(self, run: list) -> None:
        """One coalesced dispatch for a same-signature request run.

        The whole run executes through ``Executor.run_batched`` (one
        captured graph per batch bucket); replies scatter back by request
        id, and telemetry and the scheduler EWMA are fed the per-request
        AMORTIZED latency — the whole batch's wall time would make the
        admission policy believe a step costs batch_size times what a
        request actually experiences, and shed feasible work.

        A failed batched dispatch retries each member through the solo path
        (which reports its own error if the failure is really the
        request's), as the JAX package's server does; the failure is never
        silent: every retried request counts in ``fallbacks`` and the error
        is posted as a ``batched_fallback`` platform event."""
        if self._bound is None:
            for s in run:                       # mirror _infer's refusal
                r, srid, sver, _ = s.payload
                r.send_final(s, proto.Msg.ERROR,
                             proto.pack_json({"error": "not provisioned"}),
                             rid=srid, version=sver)
            return
        wd = self._loop.watchdog
        self._executing = run
        failed: Optional[Exception] = None
        t0 = time.perf_counter()
        try:
            if wd is not None:
                wd.arm(run)
            outs = self.executor.run_batched(
                self._bound, [s.payload[3] for s in run],
                rimfs=self.platform.rimfs)
            outs = [{k: to_host(v) for k, v in out.items()} for out in outs]
        except Exception as e:
            failed = e
        finally:
            if wd is not None:
                wd.disarm()
            self._executing = None
        if failed is not None:
            self.batched_stats["fallbacks"] += len(run)
            self.platform.post("batched_fallback",
                               {"n": len(run), "error": repr(failed)})
            for s in run:
                self._dispatch_single(s)
            return
        wall = time.perf_counter() - t0
        amortized = wall / len(run)
        st = self.batched_stats
        st["dispatches"] += 1
        st["requests"] += len(run)
        st["max_batch"] = max(st["max_batch"], len(run))
        st["seconds"] += wall
        for s, out in zip(run, outs):
            r, srid, sver, _ = s.payload
            self.platform.telemetry.record_latency(amortized)
            self.scheduler.observe_step_latency(amortized)
            r.send_final(s, proto.Msg.INFER_RESPONSE,
                         proto.pack_tensors(out), rid=srid, version=sver)

    def _infer_lm(self, work: _Work) -> None:
        """An LM prompt into the engine's continuous batching; the reply
        goes back by request id when its slot finishes (``_pump_engine``).
        The in-flight prompts are capped like the dispatch queue:
        pipelining past the cap gets backpressure, not unbounded
        buffering."""
        from repro_torch.serving.engine import Request
        frame, route = work.frame, work.route
        rid, ver = frame.request_id, frame.version
        if len(self._inflight) >= self.max_queue:
            self._loop.reject()
            route.send(proto.Msg.ERROR,
                       self._busy_payload(
                           "busy: too many in-flight prompts",
                           inflight=len(self._inflight)),
                       rid=rid, flags=proto.F_BUSY, version=ver)
            return
        max_new = work.meta["max_new"]
        if self.max_new_clamp is not None:
            # brown-out rung 2: bound every admission's decode budget so a
            # queue of long generations cannot starve the fleet
            max_new = min(max_new, self.max_new_clamp)
        prompt = np.asarray(work.tensors["prompt"]).astype(
            np.int32).reshape(-1)
        if prompt.size + max_new >= self.engine.max_seq:
            raise RuntimeError(
                f"prompt ({prompt.size} tokens) + max_new ({max_new}) "
                f"exceeds engine max_seq {self.engine.max_seq}")
        iid = next(self._iid)
        tel = self.platform.telemetry
        if tel.tracing:
            tel.record_span("server.queue", self._loop.t_enqueued,
                            self._loop.t_dequeued, iid)
        req = Request(rid=iid, prompt=prompt, max_new=max_new,
                      priority=work.meta["priority"],
                      deadline=work.meta["deadline"])
        self.engine.submit(req)
        self._inflight[iid] = (req, route, rid, ver)

    def _on_idle(self) -> bool:
        plain = self._drain_plain()
        lm = self._pump_engine()
        return plain or lm

    def _pump_engine(self) -> bool:
        """Idle hook: one continuous-batching step, then route finished (or
        shed) prompts back by id. Returns True while prompts are in flight,
        so the loop keeps spinning."""
        if self.engine is None or not self._inflight:
            return False
        try:
            self.engine.step()
        except Exception as e:
            # poisoned engine state would re-raise on every pump and hang
            # every in-flight client: fail them all explicitly instead
            for req, route, rid, ver in self._inflight.values():
                route.send(proto.Msg.ERROR,
                           proto.pack_json({"error": f"engine: {e}"}),
                           rid=rid, version=ver)
            self._inflight.clear()
            raise
        tel = self.platform.telemetry
        for iid, (req, route, rid, ver) in list(self._inflight.items()):
            if not req.done:
                continue
            del self._inflight[iid]
            with torch.profiler.record_function("server.reply") \
                    if tel.tracing else NOSPAN:
                if req.shed:
                    # an LM request that already sampled tokens is NOT safe
                    # to retry blindly (a re-run would draw fresh samples);
                    # admission-time sheds always are
                    kind = req.verdict_kind
                    retryable = kind in RETRYABLE_KINDS and \
                        not req.out_tokens
                    route.send(proto.Msg.ERROR,
                               self._shed_payload(kind, req.verdict,
                                                  retryable=retryable),
                               rid=rid, flags=proto.F_SHED, version=ver)
                else:
                    route.send(proto.Msg.INFER_RESPONSE,
                               proto.pack_tensors(
                                   {"tokens": np.asarray(req.out_tokens,
                                                         np.int32)}),
                               rid=rid, version=ver)
        return bool(self._inflight)

    def _drop_work(self, work: _Work) -> None:
        """close(drain=False) hand-back: refuse explicitly, never drop a
        request whose submit was already acknowledged."""
        if work.control is not None:
            if work.meta is not None:           # fail the waiting caller
                work.meta["error"] = RuntimeError(
                    "control op dropped: dispatcher closing")
                work.meta["done"].set()
            return
        if work.frame is not None:
            work.route.send(proto.Msg.ERROR,
                            proto.pack_json({"error": "draining"}),
                            rid=work.frame.request_id,
                            flags=proto.F_DRAINING,
                            version=work.frame.version)
            return
        # a dropped KICK may stand for the dispatch (one request, or a
        # batched run of them) a wedged worker is still executing: refuse
        # it (send_final keeps the reply exactly-once)
        ex = self._executing
        if ex is None:
            return
        payload = proto.pack_json({"error": "preempted: dispatcher "
                                   "closing"})
        for s in (ex if isinstance(ex, list) else [ex]):
            r, srid, sver, _ = s.payload
            r.send_final(s, proto.Msg.ERROR, payload, rid=srid,
                         flags=proto.F_DRAINING, version=sver)

    def run_on_dispatcher(self, fn, timeout: float = 60.0):
        """Execute ``fn`` ON the dispatcher thread and return its result.

        The dispatcher runs exactly one work item at a time, so a control
        op observes the server between requests: no request is
        mid-execution while it runs. That makes it the fleet controller's
        atomic flip point for mesh reshapes and binding swaps, with no lock
        on the request path. While it waits, the plain drain stops after
        each admission round, so requests that keep arriving do not hold
        it back. Called from the dispatcher thread itself the op runs
        inline (re-entrant control flows)."""
        if threading.current_thread() is self._loop._thread:
            return fn()
        box: dict = {"done": threading.Event(), "result": None,
                     "error": None}

        def ctl():
            with self._controls_lock:
                self._controls_waiting -= 1
            try:
                box["result"] = fn()
            except BaseException as e:
                box["error"] = e
            finally:
                box["done"].set()

        with self._controls_lock:
            self._controls_waiting += 1
        if not self._loop.submit(_Work(frame=None, route=None, control=ctl,
                                       meta=box)):
            with self._controls_lock:
                self._controls_waiting -= 1
            raise ServerBusy("dispatcher refused control op "
                             "(draining or queue full)")
        if not box["done"].wait(timeout):
            raise TimeoutError(f"control op not executed in {timeout}s "
                               f"(dispatcher wedged?)")
        if box["error"] is not None:
            raise box["error"]
        return box["result"]

    def _telemetry_summary(self) -> dict:
        s = dict(self.platform.telemetry.summary(warmup=1))
        batched = dict(self.batched_stats)
        if self._bound is not None:
            verdict = linker_mod.batch_analysis(self._bound)
            batched.update(batchable=verdict.batchable,
                           reason=verdict.reason)
        shed = self.scheduler.shed_count
        if self.engine is not None:
            shed += self.engine.scheduler.shed_count
        s["serving"] = {**self._loop.summary(), "shed": shed,
                        "inflight": len(self._inflight),
                        "batched": batched}
        s["counters"] = self.platform.telemetry.counters()
        s["device"] = str(self.platform.driver.device)
        if self.engine is not None:
            s["engine"] = self.engine.telemetry.summary(warmup=1)
            if hasattr(self.engine, "kv_stats"):
                # paged-KV engines report pool occupancy: the capacity
                # signal behind block-aware admission (shed verdicts)
                s["engine"]["kv"] = self.engine.kv_stats()
        return s

    def _provision(self, payload) -> None:
        # payload = frame-in-frame: [image_frame][program_frame]; sliced as
        # memoryviews so the image is not copied again
        view = memoryview(payload)
        _, image = proto.decode_frame(view, max_frame=self.max_frame)
        rest = view[proto.HEADER.size + len(image) + 4:]
        _, prog = proto.decode_frame(rest, max_frame=self.max_frame)
        if self._bound is not None:
            # the graphs read the old image's pinned weights in place:
            # drop them (and their memory pools) before it is unpinned
            Executor.release_graphs(self._bound)
            self._bound = None
        self.platform.provision(image=image, program_bytes=prog)
        if self.mesh is not None:
            # host views: each tile group pins its own tile's weights
            if self.artifacts:
                self.platform.program.artifacts.update(self.artifacts)
            self._bound = rbl_mod.bind(self.platform.program,
                                       rimfs=self.platform.rimfs)
        else:
            self._bound = self.platform.bind(driver=self.executor.driver,
                                             artifacts=self.artifacts)

    def _infer(self, tensors: dict, bound=None, fs=None) -> dict:
        """Run on the device (over the mesh's groups when one is attached)
        on the primary binding, or, when the fleet passes a (bound, fs)
        pair, on a canary's shadow binding; results come back as host
        values."""
        if bound is None:
            bound, fs = self._bound, self.platform.rimfs
        if bound is None:
            raise RuntimeError("not provisioned")
        if self.mesh is not None:
            out = self.executor.run_partitioned(
                bound, inputs=tensors, rimfs=fs, mesh=self.mesh,
                platform=self.platform)
        else:
            out = self.executor.run(bound, inputs=tensors, rimfs=fs)
        return {k: to_host(v) for k, v in out.items()}


# ------------------------------------------------------------------ client
class Client:
    """Protocol v2 client with request pipelining.

    ``infer`` is the synchronous one-shot; ``infer_async``/``result`` pipe
    many requests down one connection and collect responses out of order
    (frames for other request ids are parked for their waiters, so one
    ``Client`` may be shared across threads). ``version=1`` speaks the
    legacy rid-less protocol for back-compat testing.

    Backpressure retry: ``retries > 0`` makes ``infer`` re-send a request
    refused with F_BUSY/F_SHED up to that many times, sleeping a jittered
    exponential backoff (``backoff * 2**attempt``, capped, ×[0.5, 1.0)
    jitter so a refused burst doesn't re-arrive in lockstep). Scale
    events and drain windows then read as added latency instead of hard
    failures. Off by default — zero-retry callers see refusals
    immediately, exactly as before.
    """

    def __init__(self, address: tuple, version: int = 2,
                 max_frame: int = proto.MAX_FRAME, retries: int = 0,
                 backoff: float = 0.05, backoff_cap: float = 2.0,
                 retry_seed: Optional[int] = None):
        self.sock = socket.create_connection(address)
        _no_delay(self.sock)
        self.version = version
        self.max_frame = max_frame
        self.retries = int(retries)
        self.backoff = backoff
        self.backoff_cap = backoff_cap
        self._retry_rng = random.Random(retry_seed)
        self.retry_stats = {"retries": 0, "busy": 0, "shed": 0,
                            "hinted": 0}
        self._send_lock = threading.Lock()
        self._cond = threading.Condition()
        self._parked: dict = {}           # rid -> Frame (out-of-order)
        self._receiving = False
        self._dead: Optional[BaseException] = None
        self._rids = itertools.count(1)

    # -------------------------------------------------------------- frames
    def _send(self, kind: proto.Msg, payload: bytes, rid: int = 0) -> None:
        with self._send_lock:
            if self.version >= 2:
                proto.send_frame(self.sock, kind, payload, request_id=rid)
            else:
                proto.send_frame(self.sock, kind, payload)

    def _await(self, rid: int,
               timeout: Optional[float] = None) -> proto.Frame:
        """Block until the reply for ``rid`` arrives. Exactly one thread
        receives at a time; frames for other ids are parked and their
        waiters notified. A receive failure marks the connection dead so
        every parked waiter errors out instead of waiting forever.

        ``timeout`` bounds the whole wait: a request id orphaned by a
        server that never replies raises ``TimeoutError`` instead of
        parking forever. The receive slot polls the socket with
        ``select`` slices (``settimeout`` would flip the shared file
        description and break concurrent senders) so a timed waiter
        holding the slot still hands it back promptly on expiry."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout

        def _expired() -> float:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"no reply for request {rid} within {timeout}s")
            return remaining

        with self._cond:
            while True:
                if rid in self._parked:
                    return self._parked.pop(rid)
                if self._dead is not None:
                    raise ConnectionError(
                        f"connection failed: {self._dead!r}")
                if not self._receiving:
                    self._receiving = True
                    break
                self._cond.wait(None if deadline is None
                                else min(_expired(), 0.1))
        try:
            while True:
                if deadline is not None:
                    ready, _, _ = select.select(
                        [self.sock], [], [], min(_expired(), 0.1))
                    if not ready:
                        continue
                try:
                    f = proto.recv_frame_ex(self.sock,
                                            max_frame=self.max_frame)
                except Exception as e:
                    with self._cond:
                        self._dead = e
                    raise
                # v1 frames carry no id: deliver to the active waiter
                if f.version == 1 or f.request_id == rid:
                    return f
                with self._cond:
                    self._parked[f.request_id] = f
                    self._cond.notify_all()
        finally:
            with self._cond:
                self._receiving = False
                self._cond.notify_all()

    @staticmethod
    def _raise_error(f: proto.Frame) -> None:
        info = proto.unpack_json(f.payload)
        msg = info.get("error", str(info))
        if f.flags & proto.F_SHED:
            exc: Any = RequestShed(info.get("verdict", msg))
            exc.kind = info.get("kind", "shed")
        elif f.flags & (proto.F_BUSY | proto.F_DRAINING):
            exc = ServerBusy(msg)
            exc.kind = info.get("kind", "busy")
        else:
            raise RuntimeError(msg)
        exc.retry_after_ms = info.get("retry_after_ms")
        exc.retryable = bool(info.get("retryable", True))
        raise exc

    def _rpc(self, kind: proto.Msg, payload: bytes) -> proto.Frame:
        rid = next(self._rids)
        self._send(kind, payload, rid=rid)
        f = self._await(rid)
        if f.kind == proto.Msg.ERROR:
            self._raise_error(f)
        return f

    # ----------------------------------------------------------------- api
    def provision(self, image: bytes, program_bytes: bytes) -> dict:
        # frame-in-frame, sent part by part: the image is never copied
        inner = proto.frame_parts(proto.Msg.PROVISION, image) + \
            proto.frame_parts(proto.Msg.PROVISION, program_bytes)
        return proto.unpack_json(
            self._rpc(proto.Msg.PROVISION, inner).payload)

    def infer_async(self, deadline_ms: Optional[float] = None,
                    priority: Optional[int] = None,
                    max_new: Optional[int] = None, **tensors) -> int:
        """Send one pipelined INFER_REQUEST; returns its request id.
        Admission metadata rides as reserved ``__``-prefixed npz entries
        (``max_new``: the decode tokens an LM ``prompt`` asks for)."""
        rid = next(self._rids)
        meta: dict = {}
        if deadline_ms is not None:
            meta["__deadline_ms"] = np.float64(deadline_ms)
        if priority is not None:
            meta["__priority"] = np.int32(priority)
        if max_new is not None:
            meta["__max_new"] = np.int32(max_new)
        self._send(proto.Msg.INFER_REQUEST,
                   proto.pack_tensors({**tensors, **meta}), rid=rid)
        return rid

    def result(self, rid: int, timeout: Optional[float] = None,
               with_flags: bool = False):
        """Collect the response for a pipelined request id (any order).
        ``timeout`` raises ``TimeoutError`` for an orphaned id (e.g. a
        dead server that will never answer) instead of parking forever.
        ``with_flags=True`` returns ``(tensors, flags)``, so a caller sees
        reply metadata such as F_CANARY (shadow-served bytes)."""
        f = self._await(rid, timeout=timeout)
        if f.kind == proto.Msg.ERROR:
            self._raise_error(f)
        out = proto.unpack_tensors(f.payload)
        return (out, f.flags) if with_flags else out

    def infer(self, deadline_ms: Optional[float] = None,
              priority: Optional[int] = None,
              max_new: Optional[int] = None,
              timeout: Optional[float] = None, **tensors) -> dict:
        """One-shot inference; with ``retries`` set, bounded re-send on
        backpressure refusals (a refused request was never executed, so
        re-sending cannot double-run it)."""
        attempt = 0
        while True:
            try:
                return self.result(self.infer_async(
                    deadline_ms=deadline_ms, priority=priority,
                    max_new=max_new, **tensors), timeout=timeout)
            except (ServerBusy, RequestShed) as e:
                kind = "busy" if isinstance(e, ServerBusy) else "shed"
                self.retry_stats[kind] += 1
                if not getattr(e, "retryable", True):
                    # terminal verdict (infeasible deadline, or a non-
                    # idempotent mid-sampling shed): retrying is either
                    # futile or unsafe — fail fast regardless of budget
                    raise
                if attempt >= self.retries:
                    raise
                delay = min(self.backoff_cap, self.backoff * (2 ** attempt))
                delay *= 0.5 + self._retry_rng.random() / 2
                hint = getattr(e, "retry_after_ms", None)
                if hint:
                    # the server told us when capacity plausibly exists;
                    # arriving earlier only burns a retry on the same wall
                    self.retry_stats["hinted"] += 1
                    delay = max(delay, float(hint) / 1e3)
                time.sleep(delay)
                attempt += 1
                self.retry_stats["retries"] += 1

    def telemetry(self) -> dict:
        return proto.unpack_json(self._rpc(proto.Msg.TELEMETRY, b"").payload)

    def shutdown(self) -> dict:
        """Graceful server drain; returns the server's drain ack."""
        return proto.unpack_json(
            self._rpc(proto.Msg.SHUTDOWN, b"").payload)

    def close(self) -> None:
        self.sock.close()
