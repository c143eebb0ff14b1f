"""Share of the engine's lanes held by a request over the window, in %:
the lane-seconds of every ``engine.slot`` inside the window, over the
window's seconds times ``max_batch``. None without the program's spans,
or where spans were dropped inside the window."""
from perfbench import spans


def read(rec):
    s = spans.of(rec)
    if s is None:
        return None
    lanes = rec.config["port"]["max_batch"]
    return 100.0 * spans.slot_seconds(s, rec.window) / \
        (rec.window_s * lanes)
