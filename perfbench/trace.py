"""Reduce a ``torch.profiler`` trace of a short steady part of the window,
in memory, to what the readers and the result line need.

- ``busy_s``: the union of the device's activity intervals (kernels,
  copies, sets; not the spans' mirrors on the device's timeline);
  ``window_s`` is the host clock between the profiler's start and its
  stop, both taken on the dispatcher thread with the device idle (between
  engine steps, after a synchronize).
- ``ops``: each ``aeg::`` custom op (the hand kernels) by input shapes,
  with its calls and the device time of what it launched.
- ``kernels``: device seconds by kernel name.
- ``gaps``: idle device time by what the host was doing then: the
  innermost harness span (``bench.*``) and the innermost other host op
  running at the gap's middle.
"""
from __future__ import annotations

import bisect
import collections

TOP = 10
WALK = 256               # host ops looked back at for the innermost one


def _device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, attr, None)
        if v:
            return float(v)
    return 0.0


def _merge(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class _Innermost:
    """The innermost host range containing a time point, among ranges
    sorted by start."""

    def __init__(self, ranges: list):
        self.ranges = sorted(ranges)
        self.starts = [r[0] for r in self.ranges]

    def at(self, t: float):
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(-1, i - WALK), -1):
            s, e, name = self.ranges[j]
            if s <= t <= e:
                return name
        return None


def reduce(prof, window_s: float) -> dict:
    """The profiler's trace as a dict: ``busy_s``, ``window_s``,
    ``device_events``, ``ops``, ``kernels`` and ``breakdown``."""
    from torch.autograd import DeviceType
    events = prof.events()
    device, spans, host = [], [], []
    kernels: dict = collections.defaultdict(float)
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        on_device = e.device_type == DeviceType.CUDA
        if on_device and (e.name.startswith("bench.")
                          or getattr(e, "is_user_annotation", False)):
            continue            # a span's mirror on the device's timeline
        if on_device:
            device.append((s, t))
            kernels[e.name] += (t - s) / 1e6
        elif e.name.startswith("bench."):
            spans.append((s, t, e.name))
        else:
            host.append((s, t, e.name))
    busy = _merge(device)
    busy_s = sum(e - s for s, e in busy) / 1e6
    gaps: dict = collections.defaultdict(float)
    if busy:
        starts = [s for s, _, _ in spans + host] + [busy[0][0]]
        ends = [t for _, t, _ in spans + host] + [busy[-1][1]]
        edges = [min(starts)] + [x for iv in busy for x in iv] + [max(ends)]
        span_at, host_at = _Innermost(spans), _Innermost(host)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            label = (f"{span_at.at(mid) or 'outside engine.step'} / "
                     f"{host_at.at(mid) or '-'}")
            gaps[label] += (b - a) / 1e6
    ops = []
    for avg in prof.key_averages(group_by_input_shape=True):
        if avg.key.startswith("aeg::"):
            ops.append({"name": avg.key, "shapes": avg.input_shapes,
                        "calls": int(avg.count),
                        "device_s": _device_us(avg) / 1e6})
    top_k = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]
    top_g = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_s, "window_s": window_s,
            "device_events": len(device), "ops": ops,
            "kernels": dict(kernels),
            "breakdown": {"device_ops": [[n[:160], s] for n, s in top_k],
                          "idle_gaps": [[n[:160], s] for n, s in top_g]}}
