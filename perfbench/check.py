"""What decides ``correct``: the served tokens held against the plain
reference, once the window has closed and the program's state is freed.

A sample of the finished requests, drawn from the seed with the longest
among them, is run through the reference once each, over its prompt and
its served tokens; for every served token the reading is how far its
logit lies below the reference's best at that position. The widest such
gap is compared with the cell's limit (``limits/<cell>.json``), which was
set between the program's readings on a dozen seeds and those of the
control: the reference one precision step down (float8), whose first
choice at each position is read the same way (``control_gaps``).
"""
from __future__ import annotations

import json

import numpy as np
import torch

from perfbench import reference
from perfbench.spec import HERE


def load_limits(cell: str, root=None) -> dict:
    base = HERE if root is None else root / "perfbench"
    with open(base / "limits" / f"{cell}.json") as f:
        return json.load(f)


def pick(done: list, seed: int, spec: dict) -> list:
    """The requests to check: the longest finished one (prompt plus
    served tokens), then others drawn from ``seed`` until ``min_tokens``
    served tokens or ``max_requests`` requests."""
    ok = [d for d in done if d.ok]
    if not ok:
        return []
    longest = max(range(len(ok)),
                  key=lambda i: (len(ok[i].prompt) + len(ok[i].tokens), -i))
    rng = np.random.default_rng([int(seed) % (1 << 64), 0xC4EC])
    order = [longest] + [int(i) for i in rng.permutation(len(ok))
                         if i != longest]
    out, served = [], 0
    for i in order:
        if served >= spec["min_tokens"] or len(out) >= spec["max_requests"]:
            break
        out.append(ok[i])
        served += len(ok[i].tokens)
    return out


def _inputs(reqs: list) -> tuple:
    seqs = [np.concatenate([r.prompt, r.tokens[:-1]]) for r in reqs]
    starts = [len(r.prompt) - 1 for r in reqs]
    return seqs, starts


def served_gaps(config: dict, params: dict, reqs: list) -> list:
    """For each request, the (served,) gaps best - logit[served token]
    under the fp32 reference."""
    if not reqs:
        return []
    seqs, starts = _inputs(reqs)
    out = []
    for r, lg in zip(reqs, reference.logits(config, params, seqs, starts)):
        tok = torch.as_tensor(r.tokens, device=lg.device).long()
        best = lg.max(-1).values
        out.append((best - lg.gather(1, tok[:, None])[:, 0]).cpu().numpy())
    return out


def control_gaps(config: dict, params: dict, reqs: list) -> list:
    """For each request, the gaps under the fp32 reference of the token
    the float8 reference puts first at each served position."""
    seqs, starts = _inputs(reqs)
    ref = reference.logits(config, params, seqs, starts)
    low = reference.logits(config, params, seqs, starts, precision="fp8")
    out = []
    for a, b in zip(ref, low):
        pick8 = b.argmax(-1)
        best = a.max(-1).values
        out.append((best - a.gather(1, pick8[:, None])[:, 0]).cpu().numpy())
    return out


def checks(done_all: list, vocab: int, gaps: list, limits: dict) -> dict:
    """Each number compared, with its limit: the widest logit gap, failed
    requests, replies of the wrong length, tokens outside the vocabulary."""
    served = [d for d in done_all if d.ok]
    widest = max((float(g.max()) for g in gaps if len(g)), default=None)
    return {
        "logit_gap": {"value": widest, "limit": limits["logit_gap"]},
        "checked_tokens": {"value": int(sum(len(g) for g in gaps)),
                           "limit": limits["min_checked_tokens"]},
        "failed": {"value": sum(1 for d in done_all if not d.ok),
                   "limit": 0},
        "wrong_length": {"value": sum(1 for d in served
                                      if len(d.tokens) != d.max_new + 1),
                         "limit": 0},
        "out_of_vocab": {"value": sum(int(((d.tokens < 0)
                                           | (d.tokens >= vocab)).sum())
                                      for d in served),
                         "limit": 0},
    }


def passed(result: dict) -> bool:
    """Every number within its limit (``checked_tokens`` at least its)."""
    for name, c in result.items():
        v = c["value"]
        if v is None:
            return False
        if name == "checked_tokens":
            if v < c["limit"]:
                return False
        elif v > c["limit"]:
            return False
    return True
