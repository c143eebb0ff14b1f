"""Batched LM serving engine over the port's runtime.

The port's counterpart of ``repro.serving.engine``: the paper's execution
flow (Provision -> Bind -> Dispatch -> Sync) drives LM serving. RCTC wraps
the prefill and decode steps as GRAPH_EXEC artifacts (``program``), RIMFS
holds the weights, pinned once on the device, and the engine batches user
requests with a continuous-batching slot table over a decode state that
lives on the device and is updated in place: a dense KV cache (a ring of W
rows for a sliding window), plus the recurrent states of the hybrid
(Mamba) and ssm (RWKV-6) families.

Prefill runs the hand-written kernels on CUDA tensors (their plain
versions on CPU ones), eagerly, one prompt a dispatch: ``flash_attention``
(where a sliding window masks nothing), ``ssm_scan`` and ``wkv6``; decode
runs stock torch ops, on CUDA as one CUDA graph a step
(``CompiledDecodeStep``), captured when the engine is built. The paged
engine (``serving/paged_engine.py``) shares ``EngineBase``: its admission
veto (``feasible``) sheds what its KV block pool cannot hold.
Entry points take ``device=`` (default ``"cuda"``) and raise without CUDA
unless ``device="cpu"`` is given; parameters on another device raise too.
``from_rimfs`` takes a ``TileMesh`` in place of a driver: the weights pin in
its primary group's arena and the mesh rides on the engine as
``engine.mesh``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.checkpoint.ckpt import flatten
from repro_torch.configs.base import ModelConfig
from repro_torch.core import rctc
from repro_torch.core import rimfs as rimfs_mod
from repro_torch.core.rhal import TileMesh
from repro_torch.core.rtpm import Telemetry
from repro_torch.dtypes import as_tensor, torch_dtype
from repro_torch.launch.steps import (CompiledDecodeStep, make_prefill_step,
                                      sample_tokens)
from repro_torch.models import transformer as tf
from repro_torch.serving.scheduler import ScheduledRequest, split_verdict


def pack_params_image(params: dict) -> bytes:
    """Flatten a params dict into a RIMFS image (one file per leaf, keyed
    as the JAX package's checkpoints key them): the same bytes as the JAX
    package's ``pack_params_image`` for the same parameters."""
    return rimfs_mod.pack(flatten(params))


def params_from_rimfs(cfg: ModelConfig, fs: rimfs_mod.RIMFS, driver=None,
                      device="cuda") -> dict:
    """Rebuild the params dict from a mounted RIMFS image.

    With a ``driver``, leaves resolve through the image's per-driver
    residency cache (``RIMFS.resident``): the first call uploads every
    weight once into the driver's arena, and later calls (a second engine
    over the same image) reuse the pinned device buffers and move zero
    bytes. The driver's device must be ``device``. Without a driver every
    leaf is copied onto ``device``. A ``TileMesh`` is accepted in place of
    a driver: residency anchors on its primary (first live) group."""
    dev = device_mod.resolve(device)
    if isinstance(driver, TileMesh):
        driver = driver.primary
    if driver is not None and driver.device != dev:
        raise ValueError(f"driver on {driver.device}, engine on {dev}")
    resident = fs.resident(driver) if driver is not None else None
    out = {}
    for key, name in flatten({n: n for n in tf.model_specs(cfg)}).items():
        out[name] = resident[key] if resident is not None \
            else fs.read(key).to(dev)
    return out


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new: int = 16
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    priority: int = 1             # admission priority (lower = more urgent)
    deadline: Optional[float] = None   # absolute monotonic seconds
    shed: bool = False            # shed by the admission policy
    verdict: str = ""             # admission outcome ("admitted"/"shed: ...")
    verdict_kind: str = ""        # machine-readable shed kind
                                  # (scheduler.VERDICT_KINDS)


class EngineBase:
    """Shared continuous-batching scaffolding: submission queue / scheduler
    admission, token sampling, and the drain loop. Subclasses own the cache layout and the
    prefill/decode steps."""

    def __init__(self, cfg: ModelConfig, params: dict, max_batch: int = 4,
                 max_seq: int = 256, greedy: bool = True, scheduler=None,
                 temperature: float = 1.0, seed: int = 0, device="cuda",
                 mesh: Optional[TileMesh] = None):
        self.device = device_mod.resolve(device)
        elsewhere = sorted(k for k, v in params.items()
                           if v.device != self.device)
        if elsewhere:
            raise ValueError(f"params {elsewhere} are not on the engine's "
                             f"device {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.greedy = greedy
        self.temperature = temperature
        self.scheduler = scheduler      # optional DeadlineScheduler
        self.mesh = mesh                # optional TileMesh the weights on
        self.telemetry = Telemetry()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self._slots: list[Optional[Request]] = [None] * max_batch
        self._pos = np.zeros((max_batch,), np.int32)
        self._queue: list[Request] = []

    @classmethod
    def from_rimfs(cls, cfg: ModelConfig, fs: rimfs_mod.RIMFS, driver=None,
                   device="cuda", **kwargs):
        """Provision an engine straight from a RIMFS weight image. Weights
        resolve through ``RIMFS.resident(driver)``: building a second engine
        over the same image and driver re-binds the pinned device buffers
        instead of uploading again (zero DMA bytes). ``driver`` may be a
        ``TileMesh``: the weights pin into its primary group's arena and the
        mesh is ``engine.mesh``."""
        if isinstance(driver, TileMesh):
            kwargs.setdefault("mesh", driver)
        return cls(cfg, params_from_rimfs(cfg, fs, driver, device),
                   device=device, **kwargs)

    # ----------------------------------------------------------------- api
    def submit(self, req: Request) -> None:
        """Enqueue a request. With a scheduler attached it routes through
        ``DeadlineScheduler.submit``, so admission (and shedding) happens at
        ``_admit`` time; without one, plain FIFO. A prompt that leaves no
        cache row to decode into raises ``ValueError``."""
        if not 0 < len(req.prompt) < self.max_seq:
            raise ValueError(f"prompt of {len(req.prompt)} tokens: the "
                             f"engine takes 1 to {self.max_seq - 1}")
        if self.scheduler is not None:
            self.scheduler.submit(ScheduledRequest(
                rid=req.rid, tokens_needed=req.max_new,
                priority=req.priority, deadline=req.deadline, payload=req))
        else:
            self._queue.append(req)

    def _pop_admitted(self, free_slots: int, feasible=None) -> list:
        """Next requests to place into free slots: scheduler admission
        (priority + EDF + shedding) when attached, FIFO otherwise.

        ``feasible``: optional resource veto (the paged engine's KV block
        budget) returning ``None`` to admit, a verdict string, or a
        ``(kind, message)`` tuple. A verdict sheds the request — marked
        done with the typed verdict, zero compute spent — on both the
        scheduler and the FIFO path."""
        if self.scheduler is None:
            admitted = []
            while self._queue and len(admitted) < free_slots:
                req = self._queue.pop(0)
                verdict = feasible(req) if feasible is not None else None
                if verdict:
                    kind, msg = split_verdict(verdict)
                    req.shed, req.done = True, True
                    req.verdict, req.verdict_kind = msg, kind
                    continue
                req.verdict = "admitted"
                admitted.append(req)
            return admitted
        admitted = []
        wrapped = None if feasible is None else \
            (lambda s: feasible(s.payload))
        for s in self.scheduler.admit(free_slots, feasible=wrapped):
            s.payload.verdict = s.verdict
            admitted.append(s.payload)
        for s in self.scheduler.drain_shed():
            # shed == done, with a caller-observable typed verdict: the
            # request never reaches a slot, so no compute is spent on it
            r = s.payload
            r.shed, r.done = True, True
            r.verdict, r.verdict_kind = s.verdict, s.verdict_kind
        return admitted

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """(B, V) logits -> (B,) int32 next-token picks on the host. Greedy
        is a pure argmax; otherwise temperature sampling from the engine's
        generator, seeded from ``seed`` (replays are deterministic for a
        fixed seed and submission order)."""
        picks = sample_tokens(logits, self.greedy, self.temperature,
                              None if self.greedy else self._gen)
        return picks.cpu().numpy()

    def _finish(self, slot: int, req: Request) -> bool:
        """Completion check after a decode append. ``max_new`` counts
        DECODE tokens: the prefill-sampled token rides along in
        ``out_tokens`` (so a finished request carries max_new + 1 tokens)
        but does not consume the budget."""
        return (len(req.out_tokens) - 1 >= req.max_new
                or self._pos[slot] >= self.max_seq - 1)

    def pending(self) -> int:
        """Requests waiting for a slot (wherever they queue)."""
        if self.scheduler is not None:
            return self.scheduler.pending()
        return len(self._queue)

    def step(self) -> int:
        raise NotImplementedError

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if self.step() == 0 and self.pending() == 0:
                return


class ServingEngine(EngineBase):
    """Fixed-slot continuous batching (decode batch = ``max_batch`` lanes)
    against a dense (L, B, max_seq, Hkv, D) cache on the device (a ring of
    min(max_seq, W) rows for a sliding window) — every slot holds
    worst-case sequence memory — plus each lane's recurrent states in the
    hybrid and ssm families. It takes token prompts only, as the JAX
    package's engines do: a vlm or audio config raises.

    The cache is allocated once and never rebound: the compiled decode step
    (one CUDA graph on the card, captured here while every slot is free)
    writes it in place at addresses baked into the graph."""

    def __init__(self, cfg: ModelConfig, params: dict, max_batch: int = 4,
                 max_seq: int = 256, greedy: bool = True, scheduler=None,
                 temperature: float = 1.0, seed: int = 0, device="cuda",
                 mesh: Optional[TileMesh] = None):
        if cfg.input_kind != "tokens":
            raise NotImplementedError("dense serving takes token prompts")
        super().__init__(cfg, params, max_batch, max_seq, greedy, scheduler,
                         temperature, seed, device, mesh)
        self._prefill = make_prefill_step(cfg)
        self._cache = {
            k: torch.zeros(s.shape, dtype=torch_dtype(s.dtype),
                           device=self.device)
            for k, s in tf.cache_specs(cfg, max_batch, max_seq).items()}
        self._decode = CompiledDecodeStep(cfg, self.params, self._cache,
                                          max_batch)
        # The RCB program view of this service (paper-faithful packaging).
        self.program = rctc.compile_lm_service(
            cfg, max_batch, max_seq, self._prefill, self._decode)

    def _admit(self) -> None:
        free = [i for i in range(self.max_batch) if self._slots[i] is None]
        placed = list(zip(free, self._pop_admitted(len(free))))
        if not placed:
            return
        # One prompt a prefill dispatch, B = 1, in admission order. The JAX
        # package prefills a same-length group as one (k, S) dispatch, and
        # XLA gives each row the bits of its single-prompt prefill. On the
        # card cuBLAS picks each GEMM for M = k * S rows, and a row's bits
        # depend on that pick: on an H100 the MLP's down projection (K =
        # 8960) at M = 2 x 256 rounds otherwise than at M = 256
        # (tests/test_torch_engine_gpu.py finds the op), so a grouped
        # prompt would be answered otherwise than the same prompt admitted
        # alone. A B = 1 dispatch is the one sequential admission runs, so
        # what a prompt is answered never depends on what arrived with it.
        for i, req in placed:
            plen = len(req.prompt)
            logits, cache = self._prefill(
                self.params, {"inputs": as_tensor(req.prompt[None],
                                                  self.device)})
            self._slots[i] = req
            # splice the prompt's state into slot i: its KV rows over [0,
            # min(plen, ring)), already in ring order (the tail keeps the
            # last occupant's rows, masked until decode writes them); each
            # recurrent state whole, so nothing of the last occupant stays
            for key, c in self._cache.items():
                src = cache[key][:, 0]
                if key in ("k", "v"):
                    c[:, i, :src.shape[1]].copy_(src)
                else:
                    c[:, i].copy_(src)
            self._pos[i] = plen
            req.out_tokens.append(int(self._sample(logits)[0]))

    def step(self) -> int:
        """One decode step across all live slots. Returns #live."""
        self._admit()
        live = [i for i, r in enumerate(self._slots) if r is not None]
        if not live:
            return 0
        toks = np.zeros((self.max_batch, 1), np.int32)
        pos = np.zeros((self.max_batch,), np.int32)   # free lanes: row 0
        for i in live:
            toks[i, 0] = self._slots[i].out_tokens[-1]
            pos[i] = self._pos[i]
        t0 = time.perf_counter()
        logits, _ = self._decode(
            self.params, self._cache,
            {"inputs": as_tensor(toks, self.device),
             "pos": as_tensor(pos, self.device)})
        device_mod.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.telemetry.record_latency(dt)
        if self.scheduler is not None:
            # feed the admission policy's EWMA with the measured decode
            # latency, not the constructor default
            self.scheduler.observe_step_latency(dt)
        nxt = self._sample(logits)
        for i in live:
            r = self._slots[i]
            r.out_tokens.append(int(nxt[i]))
            self._pos[i] += 1
            if self._finish(i, r):
                r.done = True
                self._slots[i] = None
        return len(live)
