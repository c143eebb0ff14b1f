"""Metric readers, one file a metric, found by the metric's name:
``<name>.py`` defines ``read(rec)`` over a ``perfbench.record.Record`` and
returns the number in the metric's unit, or None when the run left it
nothing to read (never 0 for a share of a roofline or of a peak)."""
