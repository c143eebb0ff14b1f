"""Median host wall of the window's decode steps, to the sync after the
captured graph's replay, as the engine's own ``Telemetry`` records it."""


def read(rec):
    tel = rec.decode_step_s or {}
    return tel["p50"] * 1e3 if "p50" in tel else None
