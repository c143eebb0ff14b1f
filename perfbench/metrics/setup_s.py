"""Process start to the window's start: imports, the weights drawn on the
card, the engine built and its decode graph captured, the kernel library
built where the checkout has none, the server and clients started, and
the closed loop run until every client has had a reply."""


def read(rec):
    return rec.setup_s
