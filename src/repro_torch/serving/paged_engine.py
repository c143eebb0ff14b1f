"""Paged-KV continuous batching over the port's runtime.

The port's counterpart of ``repro.serving.paged_engine``.
``PagedServingEngine`` replaces the dense (L, B, max_seq, Hkv, D) slot
cache with block tables over one shared pool (serving/paged_cache.py):

* **Device-side addressing** — block tables are int32 device inputs of the
  prefill and decode steps; the pool is written and gathered over its block
  axis inside them, in place. The host never rebuilds the pool; it only
  tracks lifetimes.
* **Prefill** — one prompt a dispatch, B = 1, in admission order, on the
  hand-written ``flash_attention`` kernel (its plain version on a CPU
  tensor). The JAX package prefills a same-length group as one (k, S)
  dispatch, and XLA gives each row the bits of its single-prompt prefill;
  on the card cuBLAS picks each GEMM for M = k * S rows, and a row's bits
  depend on that pick (the dense engine, serving/engine.py ``_admit``,
  keeps the same rule), so what a prompt is answered never depends on what
  arrived with it.
* **Decode windows** — one dispatch advances every live lane w in
  ``DECODE_WINDOWS`` tokens (the largest rung no lane's budget would
  overshoot): forward, sample and feed-back run w times on the device, and
  the host reads one (bucket, w) int32 array. Live lanes pack into a
  power-of-two bucket, capped at max_batch. On CUDA each (bucket, window)
  rung is one CUDA graph (``launch/steps.py`` ``CompiledPagedDecode``),
  all of them captured when the engine is built: 3 buckets x 4 windows at
  4 slots. The JAX package also buckets the span of gathered blocks to a
  power of two; here every window gathers the whole table, max_seq rows a
  lane, and the tables carry max_batch lanes, which the step runs as pad
  lanes: every op then runs at the dense engine's shape (on the card the
  attention scores' batched GEMM, the RMSNorm's mean and the MoE router's
  GEMM round by their row count, and greedy streams are to equal the
  dense engine's bit for bit where block_size divides max_seq;
  ``tf.forward_decode_paged``), so
  every bucket does max_batch lanes' device work (a decode step reads the
  weights once, whatever its lanes), and a span bucket would save only
  the value gather and P.V (PERF.md holds an H100's times of a window at
  several spans).
* **Occupancy-aware admission** — a feasibility veto reserves worst-case
  blocks (prompt + max(max_new, 1)) at admission; an infeasible reservation
  is a shed verdict (``out_of_blocks``), so ``OutOfBlocksError`` cannot
  fire mid-step. Completion releases the sequence's blocks without moving
  any data.
* **Residency** — the pool registers with the driver's DeviceArena (a
  ``TileMesh``'s primary group's, when built from a mesh).

Full-attention families only, as in the JAX package. Entry points take
``device=`` (default ``"cuda"``) and raise without CUDA unless
``device="cpu"`` is given.
"""
from __future__ import annotations

import itertools
import time
from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import rctc
from repro_torch.core.rhal import TileMesh
from repro_torch.dtypes import as_tensor
from repro_torch.launch.steps import (CompiledPagedDecode,
                                      make_paged_prefill_step)
from repro_torch.models import transformer as tf
from repro_torch.serving.engine import (EngineBase, Request,
                                        params_from_rimfs)
from repro_torch.serving.paged_cache import PagedKVCache

#: Decode-window ladder: one dispatch advances every lane w tokens
#: (largest rung that no live lane's remaining budget would overshoot).
DECODE_WINDOWS = (8, 4, 2, 1)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


class PagedServingEngine(EngineBase):
    """Continuous batching with paged KV: slots hold block tables, not
    worst-case dense cache stripes, so capacity is bounded by *blocks in
    use*, not ``max_batch * max_seq``."""

    def __init__(self, cfg: ModelConfig, params: dict, max_batch: int = 4,
                 max_seq: int = 256, greedy: bool = True, scheduler=None,
                 temperature: float = 1.0, seed: int = 0,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 driver=None, device="cuda", mesh=None):
        tf._check_paged_family(cfg)
        if cfg.input_kind != "tokens":
            raise NotImplementedError("paged serving takes token prompts")
        super().__init__(cfg, params, max_batch, max_seq, greedy, scheduler,
                         temperature, seed, device, mesh)
        self.block_size = block_size
        self.blocks_per_seq = (max_seq + block_size - 1) // block_size
        if num_blocks is None:
            # full capacity: every slot can hold a max_seq sequence (the
            # dense engine's memory envelope); callers shrink this to
            # trade capacity for admission pressure
            num_blocks = max_batch * self.blocks_per_seq
        self.cache = PagedKVCache(
            num_layers=cfg.num_layers, num_blocks=num_blocks,
            block_size=block_size, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, dtype=cfg.dtype, device=self.device)
        self._seqs: list[Optional[int]] = [None] * max_batch
        self._seq_ctr = itertools.count(1)
        if driver is None and mesh is not None:
            driver = mesh.primary
        self.driver = driver
        if driver is not None:
            self.cache.register_residency(driver)
        self._prefill = make_paged_prefill_step(cfg)
        self.program = rctc.compile_paged_lm_service(
            cfg, max_batch, max_seq, block_size, num_blocks, self._prefill,
            None, greedy=greedy, temperature=temperature)
        self.buckets = sorted({min(1 << k, max_batch)
                               for k in range(max_batch.bit_length() + 1)})
        self._decode = CompiledPagedDecode(
            cfg, self.params, self.cache.k, self.cache.v,
            [(b, w) for b in self.buckets for w in DECODE_WINDOWS],
            (max_batch, self.blocks_per_seq), greedy, temperature,
            self._gen)
        self.program.artifacts["paged_decode"] = self._decode

    @classmethod
    def from_rimfs(cls, cfg, fs, driver=None, device="cuda", **kwargs):
        """Like the base provisioner, but the pool also registers with the
        driver's arena (a mesh's primary group's)."""
        if isinstance(driver, TileMesh):
            kwargs.setdefault("mesh", driver)
            driver = driver.primary
        return cls(cfg, params_from_rimfs(cfg, fs, driver, device),
                   driver=driver, device=device, **kwargs)

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        """Release any blocks still held, return the arena ranges and drop
        the captured decode windows."""
        for seq in list(self.cache.tables):
            self.cache.release(seq)
        self.cache.unregister_residency()
        self.program.artifacts["paged_decode"].release()

    def kv_stats(self) -> dict:
        c = self.cache
        return {"num_blocks": c.num_blocks, "free_blocks": c.free_blocks(),
                "block_size": c.block_size,
                "utilization": round(c.utilization(), 4),
                "pool_bytes": c.pool_bytes()}

    def _tensor(self, a: np.ndarray):
        return as_tensor(a, self.device)

    # ------------------------------------------------------------- admission
    def _admit(self) -> None:
        free = [i for i in range(self.max_batch) if self._slots[i] is None]
        if not free:
            return
        # worst-case block reservation at admission: a request is placed
        # only if prompt + max_new tokens fit the pool RIGHT NOW (budget
        # is cumulative across this admission round), so OutOfBlocksError
        # can never fire mid-step — infeasible becomes a shed verdict.
        budget = self.cache.free_blocks()

        def feasible(req: Request):
            nonlocal budget
            need = self.cache.blocks_needed(self._reserve(req))
            if need > budget:
                return ("out_of_blocks",
                        f"shed: out of KV blocks (need {need}, free "
                        f"{budget} of {self.cache.num_blocks})")
            budget -= need
            return None

        # one prompt a prefill dispatch, B = 1, in admission order (the
        # module docstring says why)
        for i, req in zip(free, self._pop_admitted(len(free), feasible)):
            plen = len(req.prompt)
            seq = next(self._seq_ctr)
            self.cache.allocate(seq, tokens=self._reserve(req))
            tables = self.cache.table_array(
                [seq], width=self.cache.blocks_needed(plen))
            logits, _, _ = self._prefill(
                self.params, self.cache.k, self.cache.v,
                {"inputs": self._tensor(req.prompt[None]),
                 "tables": self._tensor(tables)})
            self._slots[i] = req
            self._seqs[i] = seq
            self.cache.advance(seq, plen)
            self._pos[i] = plen
            req.out_tokens.append(int(self._sample(logits)[0]))

    def _reserve(self, req: Request) -> int:
        # max(., 1): the decode window always emits >= 1 token, even for a
        # degenerate max_new=0 request
        return min(len(req.prompt) + max(req.max_new, 1), self.max_seq)

    # --------------------------------------------------------------- decode
    def step(self) -> int:
        """One decode dispatch across all live slots — advances every lane
        by the window (up to 8 tokens). Returns #live."""
        self._admit()
        live = [i for i, r in enumerate(self._slots) if r is not None]
        if not live:
            return 0
        # window: largest rung no lane overshoots (budget nor seq cap)
        room = min(
            min(self._slots[i].max_new - (len(self._slots[i].out_tokens) - 1)
                for i in live),
            min(self.max_seq - 1 - int(self._pos[i]) for i in live))
        window = next(w for w in DECODE_WINDOWS if w <= max(1, room))
        # lanes compact into a batch bucket; the tables keep max_batch
        # lanes of every block (the module docstring says why)
        bucket = min(self.max_batch, _pow2_at_least(len(live)))
        seqs = [self._seqs[i] for i in live]
        tables = self.cache.table_array(seqs, width=self.blocks_per_seq,
                                        rows=self.max_batch)
        tokens = np.zeros((bucket,), np.int32)
        pos = np.zeros((bucket,), np.int32)
        for j, i in enumerate(live):
            tokens[j] = self._slots[i].out_tokens[-1]
            pos[j] = self._pos[i]
        batch = {"tokens": self._tensor(tokens), "pos": self._tensor(pos),
                 "tables": self._tensor(tables)}
        t0 = time.perf_counter()
        toks, _, _ = self._decode(self.params, self.cache.k, self.cache.v,
                                  batch, window)
        toks = toks.cpu().numpy()                # (bucket, window), a sync
        dt = time.perf_counter() - t0
        # telemetry and the admission EWMA are per-TOKEN quantities: a
        # window-w dispatch is w decode steps' worth of progress
        self.telemetry.record_latency(dt / window)
        if self.scheduler is not None:
            self.scheduler.observe_step_latency(dt / window)
        for j, i in enumerate(live):
            r = self._slots[i]
            r.out_tokens.extend(int(t) for t in toks[j])
            self.cache.advance(self._seqs[i], window)
            self._pos[i] += window
            if self._finish(i, r):
                r.done = True
                self.cache.release(self._seqs[i])   # recycled, no copy
                self._slots[i] = None
                self._seqs[i] = None
        return len(live)
