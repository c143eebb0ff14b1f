"""What a run leaves for the metric readers (``metrics/<name>.py``).

A reader is ``read(rec: Record) -> float | None``: None where the run gave
it nothing to read (an untraced run for a trace metric, a kernel that did
not run in the traced window), and the harness then leaves the metric out.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Done:
    """One request as the client saw it."""
    client: int
    index: int
    prompt: np.ndarray
    max_new: int
    t_send: float                     # host clock, seconds
    t_reply: float
    tokens: Optional[np.ndarray]      # None when it failed
    error: Optional[str] = None
    t_first: Optional[float] = None   # end of its prefill (traced runs)

    @property
    def ok(self) -> bool:
        return self.error is None


@dataclasses.dataclass
class Record:
    cfg: object                       # the served ModelConfig's sizes
    config: dict                      # the cell's configuration file
    window: tuple                     # (t0, t1) on the host clock
    setup_s: float
    done: list                        # every request completed in the window
    prefills: list = dataclasses.field(default_factory=list)
    # (t0, t1, prompt tokens) of each prefill that ended in the window,
    # t1 after its first token was sampled (traced runs)
    decodes: list = dataclasses.field(default_factory=list)
    # (t0, positions of the live lanes) of each decode step begun in the
    # window (traced runs)
    decode_step_s: Optional[dict] = None
    # the engine telemetry's summary over the window's decode steps
    trace: Optional[dict] = None      # trace.reduce() of the profiled part

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def percentile(xs, q: float) -> Optional[float]:
    """The q-th percentile (linear between order statistics), or None for
    no samples; an infinite sample (a failed request) sorts last."""
    if len(xs) == 0:
        return None
    with np.errstate(invalid="ignore"):     # interpolating between two infs
        v = float(np.percentile(np.asarray(xs, dtype=np.float64), q))
    return float("inf") if np.isnan(v) else v
