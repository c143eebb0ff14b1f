"""Deterministic, shardable synthetic data pipeline (the port's own copy of
``repro.data.pipeline``, numpy only).

Generates a stationary Markov-ish token stream (a model has real signal to
learn: loss drops well below uniform entropy) with per-(step, shard)
determinism: worker i of n draws exactly the global batch rows [i*b/n,
(i+1)*b/n), so a restart or a re-sharded fleet replays identical global
batches. The rows are the JAX package's bit for bit: the same
``np.random.RandomState`` seeds and draws.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    structure: int = 97         # hidden-state count of the generator

    def _rows(self, step: int, row_lo: int, row_hi: int) -> np.ndarray:
        """Deterministic rows of the global batch for [row_lo, row_hi)."""
        out = np.empty((row_hi - row_lo, self.seq_len + 1), np.int32)
        for r in range(row_lo, row_hi):
            rng = np.random.RandomState(
                (self.seed * 1_000_003 + step) % (2**31) ^ (r * 2_654_435))
            # token t+1 = f(token t) + small noise -> learnable structure
            s = rng.randint(self.structure)
            row = np.empty(self.seq_len + 1, np.int32)
            for t in range(self.seq_len + 1):
                s = (s * 31 + 7) % self.structure
                noise = rng.randint(0, 4)
                row[t] = (s * (self.vocab_size // self.structure) + noise) \
                    % self.vocab_size
            out[r - row_lo] = row
        return out

    def global_batch_at(self, step: int) -> dict:
        rows = self._rows(step, 0, self.global_batch)
        return {"inputs": rows[:, :-1], "targets": rows[:, 1:]}

    def shard_at(self, step: int, shard: int, num_shards: int) -> dict:
        assert self.global_batch % num_shards == 0
        per = self.global_batch // num_shards
        rows = self._rows(step, shard * per, (shard + 1) * per)
        return {"inputs": rows[:, :-1], "targets": rows[:, 1:]}


def make_batch_specs(vocab: int, batch: int, seq: int) -> dict:
    """Stand-ins for one batch that allocate nothing: int32 tensors on the
    ``meta`` device."""
    return {k: torch.empty((batch, seq), dtype=torch.int32, device="meta")
            for k in ("inputs", "targets")}
