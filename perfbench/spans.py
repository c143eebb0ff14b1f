"""The program's own spans (``repro_torch.core.rtpm.Telemetry`` with
``tracing`` on), reduced for the readers of ``queue_wait_ms.p95``,
``prefill_stall_share``, ``lane_occupancy`` and
``prefill_device_idle_share``.

A run that traces the program leaves on its ``Record``:

- ``spans``: ``collect``'s list, every span of the server's and the
  engine's rings as ``(name, key, t0, t1, attrs)`` with ``t0``/``t1`` in
  seconds of ``time.perf_counter`` (the harness's clock: the program
  stamps on ``time.perf_counter_ns``);
- ``spans_dropped``: ``collect``'s count of spans the rings overwrote that
  may have fallen inside the window;
- ``device_busy`` and ``admit_mirrors``: ``from_profile``'s merged device
  intervals and ``engine.admit`` mirrors, on the profiler's timeline.

The spans (``repro_torch.serving``): ``server.queue`` the INFER frame
enqueued on its handler thread to the dispatcher's ``_infer_lm``;
``engine.wait`` submitted to placed in a slot; ``engine.slot`` placed to
freed; ``engine.admit`` (``prompt``, ``lanes_waiting``) the prompt's
prefill call to its first token on the host. Tracing must be on before the
first request is sent: a request submitted before has no ``engine.wait``
and counts nowhere.
"""
from __future__ import annotations

import bisect
from typing import Optional

from perfbench import trace


def collect(telemetries, since: float) -> tuple:
    """``(spans, dropped)`` from the program's ``Telemetry`` rings: every
    span in seconds, and the spans overwritten by each ring whose oldest
    span kept ended after ``since`` (so what it dropped may lie after)."""
    out, dropped = [], 0
    for tel in telemetries:
        kept = tel.spans()
        if tel.spans_dropped and (not kept or kept[0].t1 * 1e-9 > since):
            dropped += tel.spans_dropped
        out += [(s.name, s.key, s.t0 * 1e-9, s.t1 * 1e-9, s.attrs)
                for s in kept]
    return out, dropped


def of(rec) -> Optional[list]:
    """The record's spans, or None where the run traced no span or spans
    were dropped inside the window."""
    spans = getattr(rec, "spans", None)
    if not spans or getattr(rec, "spans_dropped", 0):
        return None
    return spans


def _overlap(a: float, b: float, window: tuple) -> float:
    return max(0.0, min(b, window[1]) - max(a, window[0]))


def _named(spans: list, name: str) -> dict:
    return {s[1]: s for s in spans if s[0] == name}


def queue_waits_ms(spans: list, window: tuple) -> list:
    """``server.queue`` + ``engine.wait`` of each request placed in a slot
    inside the window, in ms."""
    queued = _named(spans, "server.queue")
    return [((q[3] - q[2]) + (w[3] - w[2])) * 1e3
            for k, w in _named(spans, "engine.wait").items()
            if window[0] <= w[3] <= window[1] and (q := queued.get(k))]


def slot_seconds(spans: list, window: tuple) -> float:
    """Live lane-seconds inside the window: each request's slot, from its
    placement (``engine.wait``'s end) to its ``engine.slot``'s end, or to
    the window's end where it still held its slot."""
    freed = _named(spans, "engine.slot")
    return sum(_overlap(w[3], freed[k][3] if k in freed else window[1],
                        window)
               for k, w in _named(spans, "engine.wait").items())


def stalled_seconds(spans: list, window: tuple) -> float:
    """Lane-seconds inside the window that live lanes spent waiting on
    another request's admission: each ``engine.admit`` inside it times
    its ``lanes_waiting``."""
    return sum(_overlap(s[2], s[3], window) * s[4]["lanes_waiting"]
               for s in spans if s[0] == "engine.admit")


def from_profile(prof) -> tuple:
    """``(device_busy, admit_mirrors)`` of a ``torch.profiler`` trace: the
    device's activity merged as ``trace.reduce`` counts busy, and the
    ``engine.admit`` mirrors on the host, in the trace's microseconds."""
    from torch.autograd import DeviceType
    device, mirrors = [], []
    for e in prof.events():
        iv = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not (e.name.startswith("bench.")
                    or getattr(e, "is_user_annotation", False)):
                device.append(iv)
        elif e.name == "engine.admit":
            mirrors.append(iv)
    return trace._merge(device), sorted(mirrors)


def idle_inside(busy: list, mirrors: list) -> tuple:
    """``(idle, total)``: the time inside the mirrors with no device
    activity, and the mirrors' time; ``busy`` merged and sorted."""
    starts = [s for s, _ in busy]
    idle = total = 0.0
    for a, b in mirrors:
        covered = 0.0
        for s, e in busy[max(0, bisect.bisect_right(starts, a) - 1):]:
            if s >= b:
                break
            covered += max(0.0, min(e, b) - max(s, a))
        total += b - a
        idle += (b - a) - covered
    return idle, total
