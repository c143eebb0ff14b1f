"""Deadline-aware request admission for the serving engine.

The paper's headline property is latency *determinism* (CV = 0.03%): worth
protecting at the scheduler level too. This admission policy orders the
queue by (priority, earliest deadline) and sheds requests whose deadline
cannot be met given the measured per-step latency — bounded-tardiness
behaviour instead of queue-length-dependent tail blowup.

Shed verdicts are *typed* (DESIGN.md §14): every refusal carries a
machine-readable ``verdict_kind`` alongside the human-readable string, so
a client can distinguish a retryable shed (``brownout``, ``out_of_blocks``,
``busy``) from a terminal one (``infeasible`` — the deadline is already
unmeetable, re-sending the same request cannot help).

``priority_ceiling`` is the brown-out ladder's priority-class shedding
rung: when set, requests whose priority is *at or past* the ceiling
(higher number = less urgent) are shed at admission with an honest
``brownout`` verdict — load is cut by class, never by silent drop.

Thread-safety: ``submit`` may be called from any producer thread
(connection handlers, client code) while a single dispatcher thread calls
``admit``/``drain_shed`` — the heap is guarded by a lock. Shed requests
are queued on the side and drained by the dispatcher, which marks their
payloads done with the shed verdict (the caller-observable outcome).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time
from typing import Any, Callable, Optional

# The closed verdict vocabulary (wire-visible: rides Msg.ERROR payloads).
VERDICT_KINDS = ("busy", "shed", "infeasible", "out_of_blocks", "brownout")
# Kinds a client may safely re-send: the request was refused before any
# compute (and before any sampling), so a retry cannot double-run it and
# the condition that refused it is transient.
RETRYABLE_KINDS = frozenset({"busy", "shed", "out_of_blocks", "brownout"})


@dataclasses.dataclass(order=False)
class ScheduledRequest:
    rid: int
    tokens_needed: int                  # decode steps to finish
    priority: int = 1                   # lower = more urgent
    deadline: Optional[float] = None    # absolute seconds (monotonic)
    admitted: bool = False
    shed: bool = False
    verdict: str = ""                   # admission outcome, human-readable
    verdict_kind: str = ""              # machine-readable (VERDICT_KINDS)
    payload: Any = None                 # caller's request object (e.g.
                                        # engine.Request / a reply route)


def split_verdict(verdict) -> tuple:
    """Normalize a feasibility-veto return into ``(kind, message)``.

    Vetoes may return a bare string (kind defaults to ``"shed"`` for
    back-compat) or a ``(kind, message)`` tuple from VERDICT_KINDS."""
    if isinstance(verdict, tuple):
        kind, msg = verdict
        return (kind if kind in VERDICT_KINDS else "shed"), msg
    return "shed", verdict


class DeadlineScheduler:
    def __init__(self, step_latency_estimate: float = 1e-2,
                 clock: Callable[[], float] = time.monotonic):
        self.est = step_latency_estimate
        self.clock = clock
        self._heap: list = []
        self._ctr = itertools.count()
        self._lock = threading.Lock()
        self._shed: list[ScheduledRequest] = []
        self.shed_count = 0
        self.observations = 0     # EWMA sample count (watchdog boot grace)
        # Brown-out priority-class shedding (serving/overload.py): when
        # set, priority >= ceiling is shed at admission, kind "brownout".
        self.priority_ceiling: Optional[int] = None

    # ------------------------------------------------------------------ api
    def observe_step_latency(self, seconds: float, alpha: float = 0.2):
        """EWMA of the engine's decode-step latency."""
        self.est = (1 - alpha) * self.est + alpha * seconds
        self.observations += 1

    def submit(self, req: ScheduledRequest) -> None:
        key = (req.priority,
               req.deadline if req.deadline is not None else float("inf"),
               next(self._ctr))
        with self._lock:
            heapq.heappush(self._heap, (key, req))

    def eta(self, req: ScheduledRequest, queue_depth: int) -> float:
        """Predicted completion time if admitted now."""
        return self.clock() + (req.tokens_needed + queue_depth) * self.est

    def _shed_req(self, req: ScheduledRequest, kind: str,
                  verdict: str) -> None:
        req.shed = True
        req.verdict = verdict
        req.verdict_kind = kind
        self.shed_count += 1
        self._shed.append(req)

    def admit(self, free_slots: int,
              feasible: Optional[Callable[[ScheduledRequest],
                                          Optional[Any]]] = None) -> list:
        """Pop up to `free_slots` feasible requests; shed infeasible ones.

        Returns admitted requests (priority + EDF order). Shedding happens
        at admission — before any compute is spent — keeping live-slot
        latency flat (the determinism property). Shed requests land in the
        side queue for ``drain_shed`` so the dispatcher can fail them back
        to their callers with the verdict.

        ``feasible`` lets the engine veto admission on resources the
        scheduler cannot see (KV block budget, arena headroom): it
        returns ``None`` to admit, a human-readable verdict string
        (kind defaults to ``"shed"``), or a ``(kind, message)`` tuple —
        resource exhaustion becomes a typed admission verdict instead
        of a mid-step crash.
        """
        out: list[ScheduledRequest] = []
        with self._lock:
            while self._heap and len(out) < free_slots:
                _, req = heapq.heappop(self._heap)
                ceiling = self.priority_ceiling
                if ceiling is not None and req.priority >= ceiling:
                    self._shed_req(
                        req, "brownout",
                        f"brownout: priority {req.priority} class shed "
                        f"(ceiling {ceiling})")
                    continue
                if req.deadline is not None:
                    eta = self.eta(req, len(out))
                    if eta > req.deadline:
                        self._shed_req(
                            req, "infeasible",
                            f"shed: eta {eta:.4f}s past deadline "
                            f"{req.deadline:.4f}s "
                            f"(est {self.est:.4f}s/step)")
                        continue
                if feasible is not None:
                    verdict = feasible(req)
                    if verdict:
                        kind, msg = split_verdict(verdict)
                        self._shed_req(req, kind, msg)
                        continue
                req.admitted = True
                req.verdict = "admitted"
                req.verdict_kind = ""
                out.append(req)
        return out

    def drain_shed(self) -> list:
        """Hand back (and clear) requests shed since the last drain."""
        with self._lock:
            out, self._shed = self._shed, []
        return out

    def drain_pending(self) -> list:
        """Remove and return everything still queued (forced shutdown:
        the caller owes each request an explicit refusal)."""
        with self._lock:
            out = [req for _, req in self._heap]
            self._heap.clear()
        return out

    def pending(self) -> int:
        return len(self._heap)
