"""Share of the admissions' host time, over the profiled part of the
window, in which nothing ran on the device, in %: the time inside the
``engine.admit`` mirrors (a prompt's prefill call to its first token on
the host) with no kernel, copy or set running, counted as ``trace.reduce``
counts busy, over those mirrors' time. None without a device trace or
without a mirror in it."""
from perfbench import spans


def read(rec):
    busy = getattr(rec, "device_busy", None)
    mirrors = getattr(rec, "admit_mirrors", None)
    if not busy or not mirrors:
        return None
    idle, total = spans.idle_inside(busy, mirrors)
    return 100.0 * idle / total if total > 0 else None
