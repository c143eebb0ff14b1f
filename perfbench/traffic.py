"""The one traffic generator: a closed loop of clients, each sending a
prompt and waiting for its reply before it sends the next.

A mix is a data file, ``traffic/<name>.json``::

    {"loop": "closed", "clients": 32, "sizes_per_client": 8,
     "prompt_len": {"dist": "log_uniform", "min": 128, "max": 1024},
     "max_new": {"dist": "uniform", "min": 64, "max": 256},
     "sizes_seed": 0, "check": {...}, "profile_seconds": 3}

Lengths are a fixed design, the same for every ``--seed``: the clients x
sizes_per_client points sit at evenly spaced quantiles of each length's
distribution, every client holds one point of each of the
``sizes_per_client`` strata of both lengths, and their pairing, the rows'
deal to the clients and each client's cycle are fixed by ``sizes_seed``.
The run's seed draws only the prompt ids: request i of client c from
``(seed, c, i)``. Every seed thus sends the same sizes in the same order,
and a run's work does not depend on its seed: in a closed loop with a
window of a few requests a client, the order decides which requests the
window holds, and seeds that only reordered the sizes read a median
latency 12% apart where two runs of one seed read 2% apart (nemo.chat,
H100).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

DISTRIBUTIONS = ("uniform", "log_uniform")


@dataclasses.dataclass
class Request:
    client: int
    index: int              # the client's i-th request
    prompt: np.ndarray      # (S,) int32
    max_new: int            # decode tokens; the reply holds max_new + 1


def quantile(dist: dict, u: float) -> int:
    """The integer length at quantile u in [0, 1) of ``dist``: uniform or
    log-uniform over [min, max] (log-uniform: uniform in log space)."""
    kind = dist["dist"]
    lo, hi = int(dist["min"]), int(dist["max"])
    if kind == "uniform":
        return min(hi, lo + int(math.floor(u * (hi - lo + 1))))
    if kind == "log_uniform":
        v = math.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo)))
        return max(lo, min(hi, int(math.floor(v + 1e-9))))
    raise ValueError(f"unknown length distribution {kind!r} "
                     f"({', '.join(DISTRIBUTIONS)})")


def design_quantiles(spec: dict) -> np.ndarray:
    """The (clients, sizes_per_client, 2) quantiles of (prompt length,
    max_new): the clients x sizes_per_client points of each length at
    (j + 0.5) / n, row c holding one in each of the K strata [m/K,
    (m+1)/K) of both. It does not depend on the run's seed."""
    C, K = int(spec["clients"]), int(spec["sizes_per_client"])
    n = C * K
    rng = np.random.default_rng(int(spec.get("sizes_seed", 0)))
    out_rows = rng.permutation(C)        # which client's output strata
    u = np.zeros((C, K, 2))
    for c in range(C):
        order = rng.permutation(K)       # output stratum paired with each
        for m in range(K):
            u[c, m] = ((c + C * m + 0.5) / n,
                       (out_rows[c] + C * order[m] + 0.5) / n)
    return u


def design(spec: dict) -> np.ndarray:
    """The mix's (clients, sizes_per_client, 2) int array of (prompt
    length, max_new) at ``design_quantiles``."""
    u = design_quantiles(spec)
    rows = np.zeros(u.shape, np.int64)
    for idx in np.ndindex(u.shape[:2]):
        rows[idx] = (quantile(spec["prompt_len"], u[idx][0]),
                     quantile(spec["max_new"], u[idx][1]))
    return rows


class ClosedLoop:
    """The requests of one run: ``request(c, i)`` is client c's i-th,
    cycling through the client's sizes; ids are uniform over [0, vocab)
    from ``seed``."""

    def __init__(self, spec: dict, seed: int, vocab: int):
        if spec.get("loop", "closed") != "closed":
            raise ValueError(f"loop {spec.get('loop')!r}: the generator "
                             f"runs closed loops only")
        self.seed = int(seed) % (1 << 64)
        self.vocab = int(vocab)
        self.clients = int(spec["clients"])
        rows = design(spec)
        rng = np.random.default_rng([int(spec.get("sizes_seed", 0)), 0xD1CE])
        deal = rng.permutation(self.clients)
        self.cycles = [rows[deal[c]][rng.permutation(rows.shape[1])]
                       for c in range(self.clients)]

    def request(self, c: int, i: int) -> Request:
        plen, max_new = self.cycles[c][i % len(self.cycles[c])]
        ids = np.random.default_rng([self.seed, c, i]).integers(
            0, self.vocab, int(plen), dtype=np.int32)
        return Request(client=c, index=i, prompt=ids, max_new=int(max_new))

    def longest(self) -> int:
        """The most positions a request of the mix takes (prompt plus its
        max_new + 1 served tokens)."""
        return int(max(int(p) + int(m) + 1
                       for cyc in self.cycles for p, m in cyc))
