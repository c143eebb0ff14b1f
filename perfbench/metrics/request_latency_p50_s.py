"""Median of a client's send-to-reply time over every request completed
in the window; a failed or refused request counts as missing (infinite)."""
from perfbench.record import percentile


def read(rec):
    return percentile([d.t_reply - d.t_send if d.ok else float("inf")
                       for d in rec.done], 50)
