"""95th percentile, over the requests placed in a slot inside the window,
of the program's own queueing before its prefill: ``server.queue`` (the
INFER frame enqueued on its handler thread, to the dispatcher's
``_infer_lm``) plus ``engine.wait`` (``engine.submit`` to placed in a
slot), in ms. None without the program's spans, or where spans were
dropped inside the window."""
from perfbench import spans
from perfbench.record import percentile


def read(rec):
    s = spans.of(rec)
    return None if s is None else \
        percentile(spans.queue_waits_ms(s, rec.window), 95)
