"""Share of the profiled part of the window in which nothing ran on the
device (no kernel, copy or set), in %. Traced runs only."""


def read(rec):
    t = rec.trace
    if not t or not t["device_events"] or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
