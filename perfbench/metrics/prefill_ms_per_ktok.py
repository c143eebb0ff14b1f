"""Host wall of the window's prefills (call to first token on the host)
over their prompt tokens, per thousand tokens. Traced runs only."""


def read(rec):
    toks = sum(s for _, _, s in rec.prefills)
    if not toks:
        return None
    return sum(t1 - t0 for t0, t1, _ in rec.prefills) * 1e3 / toks * 1e3
