"""Share of the live lanes' time inside the window spent waiting on
another request's admission, in %: each ``engine.admit`` inside the window
times its ``lanes_waiting`` (the slots other requests held), over the
lane-seconds of every ``engine.slot`` inside it. None without the
program's spans, or where spans were dropped inside the window."""
from perfbench import spans


def read(rec):
    s = spans.of(rec)
    if s is None:
        return None
    live = spans.slot_seconds(s, rec.window)
    return 100.0 * spans.stalled_seconds(s, rec.window) / live \
        if live > 0 else None
