"""Generated tokens of the requests completed in the window (every served
token, the prefill's first included), over the window's seconds."""


def read(rec):
    return sum(len(d.tokens) for d in rec.done if d.ok) / rec.window_s
