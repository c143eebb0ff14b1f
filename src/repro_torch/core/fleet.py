"""Elastic fleet operations — RTPM as the serving control plane.

The port's counterpart of ``repro.core.fleet``: one controller composes the
recovery primitives (heartbeat verdicts, stage re-queue on tile failure,
graceful drain, per-group-count partition caching, zero-byte RIMFS
re-binds) into a self-healing serving fleet over a ``TileMesh``.

  * ``FleetController.tick`` runs observe -> decide -> act: dispatcher queue
    depth and admission backlog, the shed rate and the heartbeat verdicts
    (with the per-group stage-time EWMA straggler signal) feed a hysteresis
    scaler that walks the mesh ladder (2 -> 4 -> 8 -> 2), a healer that
    replaces a mesh with dead groups and a partial reshape that replaces
    one dead or straggling group in place.
  * Every mutation of dispatcher-owned state (``server.mesh``,
    ``server._bound``, ``platform.rimfs``, ``server.canary``, a group slot)
    is a **control op on the dispatcher thread**
    (``InferenceServer.run_on_dispatcher``): the dispatcher runs one item
    at a time, so a flip lands between two requests. The expensive work
    (partition, tile binds, weight pinning, linking) runs OFF the
    dispatcher beforehand; the flip itself is a pointer swap.
  * Hot weight swap: mount and CRC-verify the new image, bind a shadow
    program, probe it with golden inputs bit-compared against the live
    binding's answer, prewarm the live mesh from it, flip. A probe mismatch
    (or a shed spike during probation) rolls back to the old binding,
    whose residency was never unpinned: rollback moves zero weight bytes.
    Probation ends after ``probation_requests`` served requests.
  * Canary A/B: a hash-routed fraction of live traffic runs on a shadow
    binding, a sampled share also runs the primary and is bit-compared; an
    SPRT over the agree/disagree stream promotes or aborts. A sampled
    disagreement is answered with the primary's bytes.

On the card the groups are CUDA streams, which PyTorch does not order
against each other or against the thread that prewarms, as XLA orders the
JAX package's buffers. So a prewarm ends with an event recorded on every
stream it touched (each group's and the prewarming thread's), and the flip
makes the installed groups' streams and the dispatcher's stream wait on
those events before any request can read the new buffers. Releasing an
image drops every holder of its device tensors (the residency tables, the
old binding's linked slots and per-group-count tile binds, the swap state,
the probe's driver) after each group's stream has drained, so
``torch.cuda.memory_allocated`` really falls back; the groups' arenas are
accounting only (each a share of the card's free memory at creation).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import partition as partition_mod
from repro_torch.core import rbl as rbl_mod
from repro_torch.core import rhal as rhal_mod
from repro_torch.core import rimfs as rimfs_mod
from repro_torch.core.executor import Executor
from repro_torch.dtypes import BF16, bf16_from_float, to_host


class FleetError(RuntimeError):
    pass


@dataclasses.dataclass
class FleetConfig:
    """Control-loop policy knobs (hysteresis lives here, not in code)."""
    ladder: tuple = (2, 4, 8)          # mesh sizes the scaler walks
    min_groups: int = 2
    max_groups: int = 8
    scale_up_depth: int = 8            # queue depth that argues for growth
    scale_down_depth: int = 1          # ... and for shrinking
    scale_up_ticks: int = 2            # consecutive ticks before acting
    scale_down_ticks: int = 3
    miss_rate_up: float = 0.10         # shed fraction that argues for growth
    probation_ticks: int = 3           # post-swap minimum watch ticks
    probation_requests: int = 8        # served requests before finalize
    miss_spike: float = 0.25           # post-swap shed fraction -> rollback
    spike_min_window: int = 4          # min requests before judging a spike
    mesh_cache_cap: int = 4
    control_timeout: float = 60.0      # dispatcher flip wait
    probe_seed: int = 0xF1EE7          # golden-input generator seed
    finalize_unpin: bool = True        # release old image after probation
    # --- partial reshape (replace one group instead of a full heal) ---
    partial_reshape: bool = True
    straggler_ticks: int = 3           # consecutive slow verdicts -> replace
    stage_straggler_ratio: float = 2.5  # group stage-EWMA vs median -> slow
    stage_ewma_alpha: float = 0.3
    # --- canary A/B rollout (SPRT over per-request agreement) ---
    canary_fraction: float = 0.25      # traffic hash-routed to the shadow
    canary_sample_fraction: float = 1.0  # routed requests also dual-run
    canary_serve_shadow: bool = True   # serve shadow bytes when they agree
    canary_p_good: float = 0.995       # H_good: per-request agree prob
    canary_p_bad: float = 0.80         # H_bad: a broken image's agree prob
    canary_alpha: float = 0.05         # P(abort | image good)
    canary_beta: float = 0.05          # P(promote | image bad)
    canary_min_samples: int = 4
    canary_max_samples: int = 400      # forced verdict at the cap
    canary_token_threshold: float = 1.0  # int outputs: agree fraction >= thr


@dataclasses.dataclass
class _SwapState:
    """A committed swap under probation (rollback stays possible)."""
    old_rimfs: Any
    old_bound: Any
    new_rimfs: Any
    new_bound: Any
    shed_baseline: int
    served_baseline: int
    ticks: int = 0


def golden_inputs(program, seed: int = 0xF1EE7) -> dict:
    """Deterministic probe inputs for a service program: every swap probe,
    canary check and circuit-breaker half-open probe runs the same goldens,
    so their reference answers compare across bindings and across time.
    The JAX package's draws, bit for bit: integers from ``randint(0, 4)``,
    floats from ``randn``; a bf16 input is rounded to nearest even from
    the same draws and held as a CPU ``torch.bfloat16`` tensor (numpy has
    no bfloat16)."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, t in program.tensors.items():
        if t.kind != "input":
            continue
        if t.dtype == BF16:
            out[name] = bf16_from_float(rng.randn(*t.shape))
            continue
        dt = np.dtype(t.dtype)
        if dt.kind in "iu":
            out[name] = rng.randint(0, 4, size=t.shape).astype(dt)
        else:
            out[name] = rng.randn(*t.shape).astype(dt)
    return out


def _bits(a) -> np.ndarray:
    """A host value's raw bytes (bf16 tensors as their uint16 bits)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    return np.asarray(a)


def same_outputs(a: dict, b: dict) -> bool:
    """Two replies hold the same names, shapes, dtypes and bytes."""
    if set(a) != set(b):
        return False
    for k in a:
        x, y = _bits(a[k]), _bits(b[k])
        if x.shape != y.shape or x.dtype != y.dtype \
                or not np.array_equal(x, y):
            return False
    return True


class SPRT:
    """Wald's sequential probability ratio test over a Bernoulli
    agree/disagree stream.

    ``llr`` accumulates log P(obs | H_bad)/P(obs | H_good): an agreement
    drives it down (toward *promote*), a disagreement sharply up (toward
    *abort*). With the default priors (p_good=0.995, p_bad=0.8,
    alpha=beta=0.05) one disagreement adds about +3.7 and an agreement
    about -0.2, so a clean canary promotes after 14 agreed samples and a
    broken one aborts after one or two disagreements."""

    def __init__(self, p_good: float = 0.995, p_bad: float = 0.80,
                 alpha: float = 0.05, beta: float = 0.05,
                 min_samples: int = 4, max_samples: int = 400):
        self.min_samples = min_samples
        self.max_samples = max_samples
        self.llr = 0.0
        self.n = 0
        self.agrees = 0
        self._abort_at = math.log((1.0 - beta) / alpha)
        self._promote_at = math.log(beta / (1.0 - alpha))
        self._l_agree = math.log(p_bad / p_good)
        self._l_disagree = math.log((1.0 - p_bad) / (1.0 - p_good))

    def observe(self, agree: bool) -> None:
        self.n += 1
        if agree:
            self.agrees += 1
            self.llr += self._l_agree
        else:
            self.llr += self._l_disagree

    def verdict(self) -> Optional[str]:
        """"promote" | "abort" | None (keep sampling)."""
        if self.n < self.min_samples:
            return None
        if self.llr >= self._abort_at:
            return "abort"
        if self.llr <= self._promote_at:
            return "promote"
        if self.n >= self.max_samples:     # undecided at the cap: the
            return "abort"                 # image failed to prove itself
        return None

    def summary(self) -> dict:
        return {"n": self.n, "agrees": self.agrees,
                "disagrees": self.n - self.agrees,
                "llr": round(self.llr, 4), "verdict": self.verdict()}


class CanaryState:
    """Dispatcher-visible state of one canary rollout.

    Installed on ``server.canary`` by a control op; the dispatcher consults
    it per request (routing and sampling are pure functions of the request
    id, so the split is deterministic and replayable) and feeds
    agree/disagree bits back through ``record``. The controller polls
    ``sprt.verdict()`` from its tick and promotes or aborts."""

    def __init__(self, bound, fs, fraction: float, sprt: SPRT,
                 label: str = "", sample_fraction: float = 1.0,
                 serve_shadow: bool = True, token_threshold: float = 1.0):
        self.bound = bound
        self.fs = fs
        self.fraction = max(0.0, min(1.0, fraction))
        self.sprt = sprt
        self.label = label
        self.sample_fraction = max(0.0, min(1.0, sample_fraction))
        self.serve_shadow = serve_shadow
        self.token_threshold = token_threshold
        self.stats = {"routed": 0, "sampled": 0, "agree": 0,
                      "disagree": 0, "served_shadow": 0}

    @staticmethod
    def _hash(tag: bytes, rid: int) -> int:
        return zlib.crc32(tag + int(rid).to_bytes(8, "little")) % 10_000

    def routes(self, rid: int) -> bool:
        """Deterministic traffic split: the same rid always lands on the
        same side, whatever the arrival order or thread."""
        return self._hash(b"route", rid) < int(self.fraction * 10_000)

    def samples(self, rid: int) -> bool:
        """Of the routed requests, which also dual-run the primary for an
        agree/disagree SPRT sample (an independent hash stream)."""
        return self._hash(b"sample", rid) < int(
            self.sample_fraction * 10_000)

    def judge(self, primary: dict, shadow: dict) -> bool:
        """Bit-compare float outputs; integer (token) outputs may use an
        agreement-fraction threshold for sampled LM decode."""
        if set(primary) != set(shadow):
            return False
        for k in primary:
            a, b = _bits(primary[k]), _bits(shadow[k])
            if a.shape != b.shape or a.dtype != b.dtype:
                return False
            if a.dtype.kind in "iu" and self.token_threshold < 1.0:
                agree = float(np.mean(a == b)) if a.size else 1.0
                if agree < self.token_threshold:
                    return False
            elif not np.array_equal(a, b):
                return False
        return True

    def record(self, agree: bool) -> None:
        self.sprt.observe(agree)
        self.stats["sampled"] += 1
        self.stats["agree" if agree else "disagree"] += 1


class FleetController:
    """Observe -> decide -> drain -> reshape/swap -> resume.

    Owns NO request-path state: everything the dispatcher touches is
    flipped by control ops. ``tick`` runs from a background thread
    (``start``/``stop``) or is stepped by hand for deterministic tests. No
    accepted request is dropped, outputs stay bit-identical to one driver's
    and every transition posts an event through the platform.
    ``timings[action]`` holds the seconds of each step of the last
    scale, heal, reshape, swap and canary.
    """

    EVENTS = ("scale_started", "scale_complete", "heal_started",
              "heal_complete", "swap_started", "swap_probed",
              "swap_committed", "swap_rolled_back", "swap_finalized",
              "straggler_detected", "fleet_error",
              "canary_started", "canary_promoted", "canary_aborted",
              "reshape_started", "reshape_complete")

    def __init__(self, server, config: Optional[FleetConfig] = None):
        self.server = server
        self.cfg = config or FleetConfig()
        self.events: list = []          # (kind, payload) in emit order
        self.history: list = []         # per-tick reports
        self.timings: dict = {}         # action -> {step: seconds}
        self._mesh_cache: "collections.OrderedDict[int, Any]" = \
            collections.OrderedDict()
        if server.mesh is not None:
            self._mesh_cache[server.mesh.n_groups] = server.mesh
        self._swap: Optional[_SwapState] = None
        self._canary: Optional[CanaryState] = None
        self._up_streak = 0
        self._down_streak = 0
        self._stage_ewma: dict = {}     # gid -> EWMA stage busy seconds
        self._straggler_streak: dict = {"gid": None, "n": 0}
        self._last = {"shed": self._shed_total(),
                      "served": self._served_total()}
        self._lock = threading.RLock()  # serializes control actions
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        for kind in self.EVENTS:        # record every fleet event locally
            server.platform.events.register(
                kind, (lambda k: lambda p: self.events.append((k, p)))(kind))
        # per-group stage busy time feeds the straggler EWMA (posted by
        # partition.execute on the dispatcher, host clock around a stage)
        server.platform.events.register("stage_complete", self._on_stage)

    def _on_stage(self, payload: dict) -> None:
        gid, dt = payload.get("group"), payload.get("seconds")
        if gid is None or dt is None:
            return
        a = self.cfg.stage_ewma_alpha
        prev = self._stage_ewma.get(gid)
        self._stage_ewma[gid] = dt if prev is None else \
            (1.0 - a) * prev + a * dt

    # ----------------------------------------------------------- telemetry
    def _post(self, kind: str, payload: dict) -> None:
        self.server.platform.post(kind, payload)

    def _shed_total(self) -> int:
        s = self.server.scheduler.shed_count
        eng = self.server.engine
        if eng is not None and eng.scheduler is not None:
            s += eng.scheduler.shed_count
        return s

    def _served_total(self) -> int:
        return self.server.platform.telemetry.count()

    def observe(self) -> dict:
        """One control-loop observation: queue pressure, miss rate since the
        previous observation, heartbeat verdicts (the poll beats live
        groups and registers dead ones silent, the liveness sweep
        partition.execute performs) and the mesh's ground truth."""
        server = self.server
        depth = server._loop.depth() + server.scheduler.pending()
        shed, served = self._shed_total(), self._served_total()
        shed_d = shed - self._last["shed"]
        served_d = served - self._last["served"]
        self._last = {"shed": shed, "served": served}
        mesh = server.mesh
        mesh_dead: list = []
        if mesh is not None:
            hb = server.platform.heartbeats
            for gid in mesh.gids:
                if mesh.alive(gid):
                    # step 0 on purpose: pipeline stages beat with their
                    # stage index, which differs across groups legitimately
                    hb.beat(f"tile{gid}", 0)
                else:
                    hb.register_silent(f"tile{gid}")
            mesh_dead = [g for g in mesh.gids if not mesh.alive(g)]
        verdict = server.platform.heartbeats.check()
        lat = server.platform.telemetry.summary(warmup=0)
        return {"depth": depth, "shed_delta": shed_d,
                "served_delta": served_d,
                "miss_rate": shed_d / max(1, shed_d + served_d),
                "n_groups": mesh.n_groups if mesh is not None else 1,
                "mesh_dead": mesh_dead, "verdicts": verdict["verdicts"],
                "failed": verdict["failed"],
                "stragglers": verdict["stragglers"],
                "p99": lat.get("p99")}

    # -------------------------------------------------------------- policy
    def _ladder_up(self, cur: int) -> Optional[int]:
        for n in sorted(self.cfg.ladder):
            if cur < n <= self.cfg.max_groups:
                return n
        return None

    def _ladder_down(self, cur: int) -> Optional[int]:
        for n in sorted(self.cfg.ladder, reverse=True):
            if cur > n >= self.cfg.min_groups:
                return n
        return None

    def _stage_straggler(self, obs: dict) -> Optional[int]:
        """A group whose stage-time EWMA is ``stage_straggler_ratio`` times
        the median of its peers', for ``straggler_ticks`` consecutive
        observations, is a straggler: replace it in place."""
        cfg = self.cfg
        if obs["n_groups"] < 2 or len(self._stage_ewma) < obs["n_groups"]:
            return None
        ew = {g: self._stage_ewma[g] for g in range(obs["n_groups"])
              if g in self._stage_ewma}
        if len(ew) < 2:
            return None
        worst = max(ew, key=ew.get)
        peers = [v for g, v in ew.items() if g != worst]
        med = float(np.median(peers))
        if med > 0 and ew[worst] > cfg.stage_straggler_ratio * med:
            st = self._straggler_streak
            st["n"] = st["n"] + 1 if st["gid"] == worst else 1
            st["gid"] = worst
            if st["n"] >= cfg.straggler_ticks:
                return worst
        else:
            self._straggler_streak = {"gid": None, "n": 0}
        return None

    def decide(self, obs: dict) -> Optional[tuple]:
        """Pure policy: observation -> action (None = hold). Hysteresis by
        consecutive-tick streaks, so one noisy sample never reshapes."""
        cfg = self.cfg
        if obs["mesh_dead"]:
            dead = tuple(obs["mesh_dead"])
            # one dead group in a multi-group mesh: splice in a single
            # replacement instead of rebuilding the world
            if cfg.partial_reshape and len(dead) == 1 and \
                    obs["n_groups"] > 1:
                return ("replace", dead[0], "dead")
            return ("heal", dead)
        slow = self._stage_straggler(obs)
        if slow is not None and cfg.partial_reshape:
            return ("replace", slow, "straggler")
        pressure_up = obs["depth"] >= cfg.scale_up_depth or \
            obs["miss_rate"] > cfg.miss_rate_up
        pressure_down = obs["depth"] <= cfg.scale_down_depth and \
            obs["shed_delta"] == 0
        if pressure_up:
            self._up_streak += 1
            self._down_streak = 0
        elif pressure_down:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = self._down_streak = 0
        cur = obs["n_groups"]
        if self._up_streak >= cfg.scale_up_ticks:
            nxt = self._ladder_up(cur)
            if nxt is not None:
                return ("scale", nxt)
        if self._down_streak >= cfg.scale_down_ticks:
            nxt = self._ladder_down(cur)
            if nxt is not None:
                return ("scale", nxt)
        return None

    def tick(self) -> dict:
        """One full control-loop iteration."""
        with self._lock:
            obs = self.observe()
            report: dict = {"obs": obs, "action": None}
            tile_stragglers = [w for w in obs["stragglers"]
                               if w.startswith("tile")]
            if tile_stragglers:
                self._post("straggler_detected",
                           {"workers": tile_stragglers})
            if self._swap is not None:
                report["swap"] = self._probation(obs)
            if self._canary is not None:
                report["canary"] = self._canary_tick()
            action = self.decide(obs)
            if action is not None:
                report["action"] = action
                try:
                    if action[0] == "heal":
                        self.heal(dead=action[1])
                    elif action[0] == "scale":
                        self.scale_to(action[1])
                    elif action[0] == "replace":
                        try:
                            self.replace_group(action[1], reason=action[2])
                        except Exception as e:
                            # a failed splice must not strand a dead
                            # group: fall back to the full heal path
                            self._post("fleet_error",
                                       {"action": action,
                                        "error": repr(e),
                                        "fallback": "heal"})
                            self.heal()
                except Exception as e:
                    report["error"] = repr(e)
                    self._post("fleet_error",
                               {"action": action, "error": repr(e)})
            self.history.append(report)
            return report

    # ------------------------------------------------- streams and memory
    @staticmethod
    def _fence(drivers, device) -> list:
        """Events recorded at the end of a prewarm: one on each touched
        group's stream and one on the calling thread's current stream (a
        group's uploads run on its own stream, but nothing else in a
        prewarm may be left unordered either). Empty on the CPU."""
        if device.type != "cuda":
            return []
        events = []
        for stream in {d.stream for d in drivers if d.stream is not None} \
                | {torch.cuda.current_stream(device)}:
            ev = torch.cuda.Event()
            ev.record(stream)
            events.append(ev)
        return events

    @staticmethod
    def _order_after(events: list, drivers, device) -> None:
        """Run inside a flip, on the dispatcher: the installed groups'
        streams and the dispatcher's current stream wait (on the device,
        no host stall) for everything the prewarm enqueued, so no request
        reads a buffer whose upload has not landed."""
        if not events:
            return
        streams = {d.stream for d in drivers if d.stream is not None} \
            | {torch.cuda.current_stream(device)}
        for stream in streams:
            for ev in events:
                stream.wait_event(ev)

    def _device(self):
        return self.server.platform.driver.device

    def _images(self) -> list:
        """Every mounted image the fleet may hold resident."""
        imgs = [self.server.platform.rimfs]
        if self._swap is not None:
            imgs += [self._swap.old_rimfs, self._swap.new_rimfs]
        if self._canary is not None:
            imgs.append(self._canary.fs)
        out = []
        for fs in imgs:
            if fs is not None and all(fs is not o for o in out):
                out.append(fs)
        return out

    def _bindings(self) -> list:
        bounds = [self.server._bound]
        if self._swap is not None:
            bounds += [self._swap.old_bound, self._swap.new_bound]
        if self._canary is not None:
            bounds.append(self._canary.bound)
        return [b for b in bounds if b is not None]

    @staticmethod
    def _release_residency(fs) -> int:
        """Unpin every driver's resident copy of ``fs`` (arena ranges freed,
        device tensors dropped; the host image is untouched). Each
        driver's stream drains first: the allocator must not hand a block
        to another stream while a group's last kernels may still read
        it."""
        if fs is None:
            return 0
        freed = 0
        for _key, (ref, ri) in list(fs._resident.items()):
            driver = ref()
            if driver is not None:
                driver.barrier()
            freed += ri.nbytes()
            ri.unpin()
        fs._resident.clear()
        return freed

    @staticmethod
    def _drop_binding(bound) -> None:
        """Drop what a retired binding holds on the card: its per-group-
        count partitions' tile binds (each with its linked slots), its own
        linked form and any graph captured over its weights."""
        if bound is None:
            return
        for part in (getattr(bound, "_partitions", None) or {}).values():
            for tile in part.tiles:
                tile._bound.clear()
        bound.__dict__.pop("_partitions", None)
        bound.__dict__.pop("_linked", None)
        Executor.release_graphs(bound)

    def _retire_drivers(self, drivers) -> None:
        """Release what retired group drivers (a replaced slot, a healed or
        evicted mesh) hold: every image's residency on them and every tile
        bind against them."""
        ids = {id(d) for d in drivers}
        for d in drivers:
            d.barrier()
        for fs in self._images():
            for key in [k for k in fs._resident if k in ids]:
                fs._resident[key][1].unpin()
        for bound in self._bindings():
            for part in (getattr(bound, "_partitions", None)
                         or {}).values():
                for tile in part.tiles:
                    for key in [k for k in tile._bound if k in ids]:
                        del tile._bound[key]

    def pinned_bytes(self) -> dict:
        """Bytes of each mounted image resident on each cached mesh: n ->
        bytes (the arenas are accounting only, so this is what the cached
        meshes really hold on the card)."""
        out = {}
        for n, mesh in self._mesh_cache.items():
            total = 0
            for g in mesh.groups:
                for fs in self._images():
                    entry = fs._resident.get(id(g.driver))
                    if entry is not None and entry[0]() is g.driver:
                        total += entry[1].nbytes()
            out[n] = total
        return out

    # ------------------------------------------------------------- scaling
    def _build_mesh(self, n: int):
        mesh = self._mesh_cache.get(n)
        if mesh is not None and all(mesh.alive(g) for g in mesh.gids):
            self._mesh_cache.move_to_end(n)
            return mesh, True
        stale = self._mesh_cache.pop(n, None)  # never reuse dead groups
        if stale is not None and stale is not self.server.mesh:
            self._retire_drivers([g.driver for g in stale.groups])
        return rhal_mod.TileMesh(n, device=self._device()), False

    def _prewarm(self, mesh, bound=None, rimfs=None) -> list:
        """Partition + bind + link + pin weights against the mesh's
        drivers, OFF the dispatcher thread, each group inside its own
        stream's scope; by flip time the first request pays nothing.
        Returns the fence events the flip waits on."""
        server = self.server
        bound = bound if bound is not None else server._bound
        rimfs = rimfs if rimfs is not None else server.platform.rimfs
        part = partition_mod.ensure_partition(bound, mesh.n_groups)
        drivers = []
        for tile in part.tiles:
            driver = mesh.group(tile.gid).driver
            with driver.scope():
                partition_mod.prewarm_group(part, driver, tile.gid,
                                            rimfs=rimfs)
            drivers.append(driver)
        return self._fence(drivers, mesh.device)

    def _cache_mesh(self, mesh) -> None:
        self._mesh_cache[mesh.n_groups] = mesh
        self._mesh_cache.move_to_end(mesh.n_groups)
        while len(self._mesh_cache) > self.cfg.mesh_cache_cap:
            _, old = self._mesh_cache.popitem(last=False)
            if old is not self.server.mesh:
                self._retire_drivers([g.driver for g in old.groups])

    def scale_to(self, n: int) -> dict:
        """Reshape the live mesh to ``n`` tile groups without dropping a
        request: prewarm off-thread, flip on the dispatcher (between
        requests), resume. Returns the scale report."""
        with self._lock:
            server = self.server
            if server._bound is None:
                raise FleetError("cannot scale: server not provisioned")
            cur = server.mesh.n_groups if server.mesh is not None else 1
            if n == cur and server.mesh is not None:
                return {"from": cur, "to": n, "noop": True}
            t0 = time.perf_counter()
            self._post("scale_started", {"from": cur, "to": n})
            mesh, cached = self._build_mesh(n)
            events = self._prewarm(mesh)
            t1 = time.perf_counter()

            def flip():
                self._order_after(events, [g.driver for g in mesh.groups],
                                  mesh.device)
                server.mesh = mesh
                return server._loop.depth()

            depth_at_flip = server.run_on_dispatcher(
                flip, timeout=self.cfg.control_timeout)
            t2 = time.perf_counter()
            if server.mesh is not None:
                self._cache_mesh(mesh)
            self._up_streak = self._down_streak = 0
            self.timings["scale"] = {"prewarm": t1 - t0, "flip": t2 - t1}
            report = {"from": cur, "to": n, "cached_mesh": cached,
                      "depth_at_flip": depth_at_flip,
                      "seconds": time.perf_counter() - t0}
            self._post("scale_complete", report)
            return report

    def heal(self, dead: tuple = ()) -> dict:
        """Replace a mesh with dead groups by a fresh same-size mesh.
        In-flight stages already failed over to survivors (partition
        re-queue); healing restores full capacity for what follows."""
        with self._lock:
            server = self.server
            mesh = server.mesh
            if mesh is None:
                raise FleetError("no mesh to heal")
            n = mesh.n_groups
            dead = tuple(dead) or tuple(g for g in mesh.gids
                                        if not mesh.alive(g))
            t0 = time.perf_counter()
            self._post("heal_started", {"n_groups": n, "dead": list(dead)})
            self._mesh_cache.pop(n, None)      # poisoned: drop it
            if server.platform.rimfs is not None:
                # tile-group death integrity sweep: the fresh mesh must
                # only ever prewarm from a CRC-clean weight store
                server.platform.rimfs.fsck(strict=False)
                self._post("rimfs_fsck", {"phase": "heal"})
            fresh = rhal_mod.TileMesh(n, device=self._device())
            events = self._prewarm(fresh)
            t1 = time.perf_counter()

            def flip():
                self._order_after(events, [g.driver for g in fresh.groups],
                                  fresh.device)
                server.mesh = fresh
                return True

            server.run_on_dispatcher(flip, timeout=self.cfg.control_timeout)
            t2 = time.perf_counter()
            self._retire_drivers([g.driver for g in mesh.groups])
            self._cache_mesh(fresh)
            # dead tile workers answered their last poll long ago; revive
            # the names so the fresh mesh's groups are not born "failed"
            for gid in fresh.gids:
                server.platform.heartbeats.beat(f"tile{gid}", 0)
            self.timings["heal"] = {"prewarm": t1 - t0, "flip": t2 - t1}
            report = {"n_groups": n, "dead": list(dead),
                      "seconds": time.perf_counter() - t0}
            self._post("heal_complete", report)
            return report

    # ----------------------------------------------------- partial reshape
    def replace_group(self, gid: int, reason: str = "manual") -> dict:
        """Replace ONE tile group in place (partial reshape).

        Off-thread: spawn a fresh driver for the slot, prewarm exactly that
        stage's tile bind against it (one stage's weight bytes move; the
        survivors' arenas, bind caches and DMA counters are untouched) and
        CRC re-validate the new residency on its stream. On-thread: a
        one-pointer ``install_group`` splice between requests, ordered
        after the prewarm's uploads. The retired driver's residency and
        tile binds are released."""
        with self._lock:
            server = self.server
            mesh = server.mesh
            if mesh is None:
                raise FleetError("no mesh to reshape")
            if server._bound is None:
                raise FleetError("cannot reshape: server not provisioned")
            t0 = time.perf_counter()
            self._post("reshape_started", {"group": gid, "reason": reason})
            fs = server.platform.rimfs
            if fs is not None:
                # the replacement must only prewarm from a CRC-clean store
                fs.fsck(strict=False)
                self._post("rimfs_fsck", {"phase": "reshape"})
            fresh = mesh.spawn_replacement(gid)
            part = partition_mod.ensure_partition(server._bound,
                                                  mesh.n_groups)
            with fresh.driver.scope():
                partition_mod.prewarm_group(part, fresh.driver, gid,
                                            rimfs=fs)
                if fs is not None:
                    entry = fs._resident.get(id(fresh.driver))
                    if entry is not None and not entry[1].revalidate():
                        raise FleetError(f"replacement group {gid} failed "
                                         f"CRC revalidation")
            events = self._fence([fresh.driver], mesh.device)
            t1 = time.perf_counter()

            def splice():
                self._order_after(events, [fresh.driver], mesh.device)
                old = mesh.install_group(fresh)
                return server._loop.depth(), old

            depth_at_splice, old = server.run_on_dispatcher(
                splice, timeout=self.cfg.control_timeout)
            t2 = time.perf_counter()
            self._retire_drivers([old.driver])
            # the slot's worker name is live again; reset its rhythm and
            # the straggler bookkeeping that targeted the old hardware
            server.platform.heartbeats.beat(f"tile{gid}", 0)
            self._stage_ewma.pop(gid, None)
            self._straggler_streak = {"gid": None, "n": 0}
            self.timings["reshape"] = {"prewarm": t1 - t0,
                                       "splice": t2 - t1}
            report = {"group": gid, "reason": reason,
                      "depth_at_splice": depth_at_splice,
                      "seconds": time.perf_counter() - t0}
            self._post("reshape_complete", report)
            return report

    # ------------------------------------------------------------ hot swap
    def _golden_inputs(self, program) -> dict:
        return golden_inputs(program, seed=self.cfg.probe_seed)

    @staticmethod
    def _mount(image: bytes):
        """Mount and check the image's trailer CRC (every file's CRC is
        checked on its first read, at bind)."""
        fs = rimfs_mod.mount(image)
        fs.verify_image()
        return fs

    def _shadow(self, new_fs):
        """The shadow binding of the new image: host views over a mesh
        (each group pins its own tile on prewarm), pinned on the server's
        driver without one."""
        server = self.server
        program = server.platform.program
        if server.mesh is not None:
            return rbl_mod.bind(program, rimfs=new_fs)
        return rbl_mod.bind(program, rimfs=new_fs,
                            driver=server.executor.driver)

    def _probe(self, shadow, new_fs, golden: dict) -> dict:
        """The shadow's answer to the goldens, off the dispatcher. Over a
        mesh it runs on a probe driver of its own, whose residency is
        released before returning; without one, on the shadow binding."""
        server = self.server
        if server.mesh is None:
            out = Executor(driver=server.executor.driver).run(
                shadow, inputs=golden, rimfs=new_fs)
            return {k: to_host(v) for k, v in out.items()}
        ex = Executor(device=self._device())
        probe_bound = None
        try:
            probe_bound = rbl_mod.bind(server.platform.program,
                                       rimfs=new_fs, driver=ex.driver)
            out = ex.run(probe_bound, inputs=golden, rimfs=new_fs)
            return {k: to_host(v) for k, v in out.items()}
        finally:
            ex.driver.barrier()
            entry = new_fs._resident.get(id(ex.driver))
            if entry is not None:
                entry[1].unpin()
            if probe_bound is not None:
                self._drop_binding(probe_bound)
                probe_bound.buffers.clear()

    def swap_weights(self, image: bytes, label: str = "") -> str:
        """Zero-downtime weight swap. Returns "committed" or "rolled_back".
        The old binding's residency survives until ``finalize_swap``
        (probation's end), so rollback is a pointer flip that re-uploads
        zero bytes."""
        with self._lock:
            server = self.server
            if server._bound is None:
                raise FleetError("cannot swap: server not provisioned")
            if self._swap is not None:
                raise FleetError("swap already in probation; finalize or "
                                 "roll back first")
            self._post("swap_started",
                       {"label": label, "bytes": len(image)})
            steps: dict = {}
            self.timings["swap"] = steps
            t = time.perf_counter()
            try:
                new_fs = self._mount(image)
            except Exception as e:
                self._post("swap_rolled_back",
                           {"label": label, "reason": f"mount: {e}"})
                return "rolled_back"
            steps["mount_crc"] = time.perf_counter() - t
            t = time.perf_counter()
            shadow = self._shadow(new_fs)
            steps["bind"] = time.perf_counter() - t
            t = time.perf_counter()
            golden = self._golden_inputs(server.platform.program)
            # reference answer from the LIVE binding, on the dispatcher
            # (exactly what clients are being served)
            ref = server.run_on_dispatcher(
                lambda: server._infer(golden),
                timeout=self.cfg.control_timeout)
            probe = self._probe(shadow, new_fs, golden)
            ok = same_outputs(probe, ref)
            steps["probe"] = time.perf_counter() - t
            self._post("swap_probed", {"label": label, "ok": ok})
            if not ok:
                self._release_residency(new_fs)
                self._drop_binding(shadow)
                self._post("swap_rolled_back",
                           {"label": label, "reason": "probe mismatch"})
                return "rolled_back"
            t = time.perf_counter()
            events: list = []
            mesh = server.mesh
            if mesh is not None:
                # pin the new image into the live mesh's arenas BEFORE the
                # flip, alongside the old image, never displacing it
                events = self._prewarm(mesh, bound=shadow, rimfs=new_fs)
            steps["prewarm"] = time.perf_counter() - t
            t = time.perf_counter()

            def flip():
                if mesh is not None:
                    self._order_after(events,
                                      [g.driver for g in mesh.groups],
                                      mesh.device)
                old = (server.platform.rimfs, server._bound)
                server.platform.rimfs = new_fs
                server._bound = shadow
                return old

            old_rimfs, old_bound = server.run_on_dispatcher(
                flip, timeout=self.cfg.control_timeout)
            steps["flip"] = time.perf_counter() - t
            self._swap = _SwapState(
                old_rimfs=old_rimfs, old_bound=old_bound,
                new_rimfs=new_fs, new_bound=shadow,
                shed_baseline=self._shed_total(),
                served_baseline=self._served_total())
            self._post("swap_committed", {"label": label})
            return "committed"

    def _probation(self, obs: dict) -> dict:
        """Post-swap watch: a shed spike rolls the swap back; a quiet window
        finalizes it. Finalization is gated by REQUEST count (and
        ``probation_ticks`` as a floor): an idle fleet never silently
        passes probation, so rollback stays a zero-byte flip."""
        swap = self._swap
        swap.ticks += 1
        shed = self._shed_total() - swap.shed_baseline
        served = self._served_total() - swap.served_baseline
        window = shed + served
        rate = shed / max(1, window)
        if window >= self.cfg.spike_min_window and \
                rate > self.cfg.miss_spike:
            self.rollback(reason=f"miss_spike: {rate:.2f} over "
                          f"{window} requests")
            return {"state": "rolled_back", "miss_rate": rate,
                    "served": served}
        if swap.ticks >= self.cfg.probation_ticks and \
                served >= self.cfg.probation_requests:
            self.finalize_swap()
            return {"state": "finalized", "miss_rate": rate,
                    "served": served}
        return {"state": "probation", "tick": swap.ticks,
                "served": served, "miss_rate": rate}

    def rollback(self, reason: str = "manual") -> None:
        """Flip back to the pre-swap binding. The old residency was kept
        pinned through probation, so this moves zero weight bytes; the new
        image's residency and binding are released."""
        with self._lock:
            swap = self._swap
            if swap is None:
                raise FleetError("no swap to roll back")
            server = self.server

            def flip_back():
                server.platform.rimfs = swap.old_rimfs
                server._bound = swap.old_bound
                return True

            server.run_on_dispatcher(flip_back,
                                     timeout=self.cfg.control_timeout)
            self._release_residency(swap.new_rimfs)
            self._drop_binding(swap.new_bound)
            self._swap = None
            self._post("swap_rolled_back", {"reason": reason})

    def finalize_swap(self) -> None:
        """End probation: the new image is trusted; release the old image's
        device residency and binding (configurable)."""
        with self._lock:
            swap = self._swap
            if swap is None:
                return
            freed = 0
            if self.cfg.finalize_unpin and \
                    swap.old_rimfs is not swap.new_rimfs:
                freed = self._release_residency(swap.old_rimfs)
                self._drop_binding(swap.old_bound)
            self._swap = None
            self._post("swap_finalized", {"freed_bytes": freed})

    # -------------------------------------------------------------- canary
    def canary(self, image: bytes, fraction: Optional[float] = None,
               label: str = "", sample_fraction: Optional[float] = None,
               serve_shadow: Optional[bool] = None) -> str:
        """Start a canary A/B rollout of ``image``: mount and CRC-verify it,
        bind it as a shadow, prewarm the live mesh from it (beside the
        primary), then install a ``CanaryState`` on the dispatcher. A
        hash-routed ``fraction`` of plain-RCB traffic runs on the shadow,
        and a ``sample_fraction`` of that also dual-runs the primary to feed
        the SPRT. A sampled disagreement is answered with the primary's
        bytes. Returns "started" or "aborted"."""
        with self._lock:
            server = self.server
            cfg = self.cfg
            if server._bound is None:
                raise FleetError("cannot canary: server not provisioned")
            if self._canary is not None:
                raise FleetError("canary already in flight; promote or "
                                 "abort it first")
            if self._swap is not None:
                raise FleetError("swap in probation; finalize or roll "
                                 "back before starting a canary")
            frac = cfg.canary_fraction if fraction is None else fraction
            self._post("canary_started",
                       {"label": label, "fraction": frac,
                        "bytes": len(image)})
            steps: dict = {}
            self.timings["canary"] = steps
            t = time.perf_counter()
            try:
                new_fs = self._mount(image)
            except Exception as e:
                self._post("canary_aborted",
                           {"label": label, "reason": f"mount: {e}"})
                return "aborted"
            steps["mount_crc"] = time.perf_counter() - t
            t = time.perf_counter()
            shadow = self._shadow(new_fs)
            events: list = []
            mesh = server.mesh
            if mesh is not None:
                events = self._prewarm(mesh, bound=shadow, rimfs=new_fs)
            steps["bind_prewarm"] = time.perf_counter() - t
            state = CanaryState(
                bound=shadow, fs=new_fs, fraction=frac,
                sprt=SPRT(p_good=cfg.canary_p_good,
                          p_bad=cfg.canary_p_bad,
                          alpha=cfg.canary_alpha, beta=cfg.canary_beta,
                          min_samples=cfg.canary_min_samples,
                          max_samples=cfg.canary_max_samples),
                label=label,
                sample_fraction=cfg.canary_sample_fraction
                if sample_fraction is None else sample_fraction,
                serve_shadow=cfg.canary_serve_shadow
                if serve_shadow is None else serve_shadow,
                token_threshold=cfg.canary_token_threshold)
            t = time.perf_counter()

            def install():
                if mesh is not None:
                    self._order_after(events,
                                      [g.driver for g in mesh.groups],
                                      mesh.device)
                server.canary = state
                return True

            server.run_on_dispatcher(install,
                                     timeout=cfg.control_timeout)
            steps["install"] = time.perf_counter() - t
            self._canary = state
            return "started"

    def _canary_tick(self) -> dict:
        """Poll the SPRT from the control loop and act on its verdict."""
        state = self._canary
        verdict = state.sprt.verdict()
        if verdict == "promote":
            self.promote_canary()
        elif verdict == "abort":
            self.abort_canary(reason="sprt")
        return dict(state.sprt.summary(), stats=dict(state.stats),
                    state=verdict or "sampling")

    def promote_canary(self) -> None:
        """The SPRT accepted H_good: flip the shadow to primary (between
        requests) and release the OLD image's residency and binding. The
        shadow was prewarmed at canary start, so promotion moves zero
        weight bytes."""
        with self._lock:
            state = self._canary
            if state is None:
                raise FleetError("no canary to promote")
            server = self.server

            def flip():
                server.canary = None
                old = (server.platform.rimfs, server._bound)
                server.platform.rimfs = state.fs
                server._bound = state.bound
                return old

            old_fs, old_bound = server.run_on_dispatcher(
                flip, timeout=self.cfg.control_timeout)
            self._canary = None
            freed = 0
            if self.cfg.finalize_unpin and old_fs is not state.fs:
                freed = self._release_residency(old_fs)
                self._drop_binding(old_bound)
            self._post("canary_promoted",
                       dict(state.sprt.summary(), label=state.label,
                            stats=dict(state.stats), freed_bytes=freed))

    def abort_canary(self, reason: str = "manual") -> None:
        """The SPRT accepted H_bad (or the operator pulled the cord): detach
        the canary and drop the shadow's residency and binding. The primary
        binding was never touched."""
        with self._lock:
            state = self._canary
            if state is None:
                raise FleetError("no canary to abort")
            server = self.server

            def clear():
                server.canary = None
                return True

            server.run_on_dispatcher(clear,
                                     timeout=self.cfg.control_timeout)
            self._canary = None
            self._release_residency(state.fs)
            self._drop_binding(state.bound)
            self._post("canary_aborted",
                       dict(state.sprt.summary(), label=state.label,
                            stats=dict(state.stats), reason=reason))

    # ----------------------------------------------------------- lifecycle
    def start(self, interval: float = 0.2) -> None:
        """Run ``tick`` on a background thread every ``interval`` s."""
        if self._thread is not None:
            raise FleetError("controller already running")
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval):
                try:
                    self.tick()
                except Exception as e:   # a bad tick must not kill the loop
                    self._post("fleet_error", {"error": repr(e)})

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="fleet-controller")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=10)
        self._thread = None

    def summary(self) -> dict:
        kinds = collections.Counter(k for k, _ in self.events)
        return {"ticks": len(self.history), "events": dict(kinds),
                "mesh_cache": sorted(self._mesh_cache),
                "swap_in_probation": self._swap is not None,
                "canary": self._canary.sprt.summary()
                if self._canary is not None else None}
