"""Fault injection and the chaos schedules of the serving fleet.

The port's counterpart of the JAX package's chaos harness
(``tests/chaos.py``): sustained, paced client traffic against a live
``InferenceServer`` over a ``TileMesh`` with a ``FleetController`` (and a
``BrownoutController``), while a coordinator injects the fault taxonomy at
traffic milestones (fractions of the requests completed) and the report
records that the fleet converged:

  * zero failed client requests (backpressure refusals retried by the
    client count as latency, not failure) and every reply bit-identical to
    its precomputed reference;
  * ``run_chaos``: a scale cycle, a tile-group kill and its repair, a
    journaled install through a fault at every mid-write point, corrupted
    DMA payloads retried in place, a good and a bad hot swap, a hung
    redemption preempted by the watchdog, a slow DMA path, a corrupt frame;
  * ``run_rollout_chaos``: a good and a bad canary, a straggling group
    replaced in place, a low-priority burst walking the brown-out ladder.

A schedule runs over any ``Workload`` (a program, its image, an image of
wrong weights, a pool of requests and their references); ``gemm_workload``
builds the GEMM chain the JAX package's harness uses.

    python -m repro_torch.serving.chaos --scenario core --device cuda

exits 1 on any violated invariant.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import socket
import sys
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import rbl, rctc, rhal, rimfs
from repro_torch.core.executor import Executor
from repro_torch.core.fleet import FleetConfig, FleetController, same_outputs
from repro_torch.core.integrity import IntegrityError
from repro_torch.dtypes import to_host
from repro_torch.serving import protocol as proto
from repro_torch.serving.overload import BrownoutController, OverloadConfig
from repro_torch.serving.scheduler import VERDICT_KINDS
from repro_torch.serving.server import (Client, InferenceServer, RequestShed,
                                        ServerBusy)


# ---------------------------------------------------------------------------
# Fault injectors (each returns an undo callable)
# ---------------------------------------------------------------------------

def delay_dma(mesh, gid: int, seconds: float) -> Callable:
    """Slow one group's async DMA issue path by ``seconds`` a transfer (a
    congested interconnect segment, not a dead one)."""
    driver = mesh.group(gid).driver
    orig = driver.dma_async

    def slow(host_buf, direction, prefetched=False):
        time.sleep(seconds)
        return orig(host_buf, direction, prefetched=prefetched)

    driver.dma_async = slow
    return lambda: setattr(driver, "dma_async", orig)


def slow_group_redeem(mesh, gid: int, seconds: float) -> Callable:
    """Stall one group's inbound ticket redemption by ``seconds`` a
    transfer. This lands inside the stage's host-timed window, so the fleet
    controller's per-group stage EWMA reads the group as a straggler."""
    driver = mesh.group(gid).driver
    orig = driver.dma_wait

    def slow(ticket):
        time.sleep(seconds)
        return orig(ticket)

    driver.dma_wait = slow
    return lambda: setattr(driver, "dma_wait", orig)


def corrupt_dma_payload(mesh, gid: int, count: int = 3):
    """Flip one bit of the delivered payload of the next ``count``
    CRC-stamped transfers landing on one group (a flaky lane). The ticket's
    CRC and retained source were stamped from the clean bytes inside the
    real issue, so redemption detects it and re-issues from the source.
    The corrupted copy is made on the issuing stream. Returns ``(undo,
    state)``."""
    driver = mesh.group(gid).driver
    orig = driver.dma_async
    state = {"corrupted": 0}

    def corrupting(host_buf, direction, prefetched=False):
        ticket = orig(host_buf, direction, prefetched=prefetched)
        if state["corrupted"] < count and ticket.crc is not None:
            bad = ticket.buf.clone()          # the producer's stays clean
            bad.view(torch.uint8).view(-1)[0] ^= 0x01
            ticket.buf = bad
            if ticket.event is not None:      # the consumer waits for it
                ticket.event.record()
            state["corrupted"] += 1
        return ticket

    driver.dma_async = corrupting
    return (lambda: setattr(driver, "dma_async", orig)), state


def hang_until_killed(mesh, gid: int):
    """The next DMA redemption on one group blocks until the group is
    killed (the watchdog preemption's hardware-reset analogue); the guarded
    slot then raises ``TileFailure`` and the stage fails over. Returns
    ``(undo, state)``."""
    group = mesh.group(gid)
    driver = group.driver
    orig = driver.dma_wait
    state = {"hung": False, "released": False}

    def hang(ticket):
        if not state["hung"]:
            state["hung"] = True
            while group.alive:
                time.sleep(0.005)
            state["released"] = True
        return orig(ticket)

    driver.dma_wait = hang
    return (lambda: setattr(driver, "dma_wait", orig)), state


def inject_corrupt_frame(address) -> bool:
    """Send an INFER frame whose CRC trailer is flipped. A healthy server
    answers with a connection-level protocol ERROR (or closes the
    connection) without disturbing any other route."""
    s = socket.create_connection(address)
    try:
        frame = bytearray(proto.encode_frame(proto.Msg.INFER_REQUEST,
                                             b"\x00" * 64))
        frame[-1] ^= 0xFF                       # corrupt the CRC-32
        s.sendall(bytes(frame))
        try:
            f = proto.recv_frame_ex(s, max_frame=proto.MAX_FRAME)
            return f.kind == proto.Msg.ERROR
        except Exception:
            return True                         # server closed on us: fine
    finally:
        s.close()


# ---------------------------------------------------------------------------
# Workloads and traffic
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Workload:
    """A served program, its image, an image of wrong weights (the bad swap
    and canary), a pool of requests and each one's reference reply."""
    prog: object
    image: bytes
    bad_image: bytes
    pool: list
    refs: list
    output: str = "output"
    max_frame: int = proto.MAX_FRAME


def reference_replies(prog, image: bytes, pool: list, device) -> list:
    """Each request's reply from one driver's linked run."""
    ex = Executor(device=device)
    fs = rimfs.mount(image)
    bound = rbl.bind(prog, rimfs=fs, driver=ex.driver)
    refs = [{k: to_host(v) for k, v in ex.run(bound, inputs=x).items()}
            for x in pool]
    fs.unpin_all()
    return refs


def gemm_workload(depth: int = 8, n: int = 24, seed: int = 7,
                  device="cuda") -> Workload:
    """The GEMM chain (``depth`` fp32 layers of n x n), a pool of 8 inputs
    and the chain's weights from ``seed + 1`` as the wrong image."""
    rng = np.random.RandomState(seed)
    prog = rctc.compile_gemm_chain(depth, n)
    image = rimfs.pack(rctc.gemm_chain_weights(depth, n))
    pool = [{"input": rng.randn(n, n).astype(np.float32)}
            for _ in range(8)]
    return Workload(prog, image,
                    rimfs.pack(rctc.gemm_chain_weights(depth, n,
                                                       seed=seed + 1)),
                    pool, reference_replies(prog, image, pool, device))


def _percentile(xs: list, p: float) -> float:
    if not xs:
        return 0.0
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * len(xs)))]


class Traffic:
    """Paced clients, each sending its share of ``requests`` from the pool
    and checking every reply against its reference bit for bit. ``pause``
    holds new sends and waits out the ones in flight; ``resume`` lets them
    go on."""

    def __init__(self, address, work: Workload, requests: int,
                 clients: int, seed: int, retries: int = 10,
                 pace_s: float = 0.03, priority: Optional[int] = None):
        self.address, self.work = address, work
        self.per_client = requests // clients
        self.total = self.per_client * clients
        self.seed, self.retries = seed, retries
        self.pace_s, self.priority = pace_s, priority
        self.counters = {"sent": 0, "ok": 0, "mismatch": 0}
        self.failures: list = []
        self.latencies: list = []
        self.lock = threading.Lock()
        self._open = threading.Event()
        self._open.set()
        self._inflight = 0
        self.threads = [threading.Thread(target=self._run, args=(c,),
                                         daemon=True)
                        for c in range(clients)]

    def start(self) -> "Traffic":
        for t in self.threads:
            t.start()
        return self

    def _run(self, cid: int) -> None:
        w = self.work
        cl = Client(self.address, retries=self.retries, backoff=0.02,
                    retry_seed=self.seed * 1000 + cid,
                    max_frame=w.max_frame)
        try:
            for i in range(self.per_client):
                while True:            # count in flight only once admitted
                    with self.lock:
                        if self._open.is_set():
                            self._inflight += 1
                            self.counters["sent"] += 1
                            break
                    self._open.wait(0.05)
                j = (cid * self.per_client + i) % len(w.pool)
                t0 = time.perf_counter()
                try:
                    out = cl.infer(priority=self.priority, **w.pool[j])
                except Exception as e:
                    with self.lock:
                        self.failures.append(f"client{cid} req{i}: {e!r}")
                        self._inflight -= 1
                    continue
                dt = time.perf_counter() - t0
                ident = same_outputs(out, w.refs[j])
                with self.lock:
                    self.latencies.append(dt)
                    self.counters["ok" if ident else "mismatch"] += 1
                    self._inflight -= 1
                time.sleep(self.pace_s)
        finally:
            cl.close()

    def completed(self) -> int:
        with self.lock:
            return self.counters["ok"] + self.counters["mismatch"] + \
                len(self.failures)

    def pause(self, timeout: float = 60.0) -> None:
        with self.lock:
            self._open.clear()
        deadline = time.monotonic() + timeout
        while True:
            with self.lock:
                if self._inflight == 0:
                    return
            if time.monotonic() > deadline:
                raise TimeoutError("traffic did not drain")
            time.sleep(0.005)

    def resume(self) -> None:
        self._open.set()

    def join(self, timeout: float = 180.0) -> None:
        for t in self.threads:
            t.join(timeout=timeout)

    def report(self) -> dict:
        with self.lock:
            return {"sent": self.counters["sent"], "ok": self.counters["ok"],
                    "failed": len(self.failures),
                    "failures": self.failures[:10],
                    "mismatches": self.counters["mismatch"],
                    "p50_s": _percentile(self.latencies, 0.50),
                    "p99_s": _percentile(self.latencies, 0.99)}


def check_probe(address, work: Workload, j: int, seed: int,
                retries: int = 10) -> Optional[str]:
    """One more checked request; returns an error string or None."""
    pc = Client(address, retries=retries, backoff=0.02,
                retry_seed=seed * 1000 + 999, max_frame=work.max_frame)
    try:
        out = pc.infer(**work.pool[j])
    except Exception as e:
        return f"{e!r}"
    finally:
        pc.close()
    return None if same_outputs(out, work.refs[j]) else "not bit-identical"


def journal_fault_matrix(image: bytes, path=None) -> tuple:
    """A journaled install of ``image`` through a fault after the intent,
    after the stage and after the commit, each recovered by ``fsck``.
    Returns (report, the recovered image)."""
    store = rimfs.ImageStore(image, path=path)
    jres = {"rolled_back": 0, "replayed": 0}
    for phase in ("after_intent", "after_stage", "after_commit"):
        try:
            store.install(image, fail_at=phase)
        except IntegrityError:
            pass                    # the injected "crash"
        fr = store.fsck(strict=True)
        jres["rolled_back"] += len(fr["rolled_back"])
        jres["replayed"] += len(fr["replayed"])
    jres["image_ok"] = bool(store.fsck(strict=True)["image"]["ok"])
    return jres, store.image()


# ---------------------------------------------------------------------------
# The core schedule: scale, kill, journal, corruption, swaps, hang, delay
# ---------------------------------------------------------------------------

def run_chaos(work: Optional[Workload] = None, groups: int = 2,
              seed: int = 7, requests: int = 90, clients: int = 3,
              scale_peak: int = 8, retries: int = 10,
              dma_delay_s: float = 0.2, p99_bound_s: float = 30.0,
              pace_s: float = 0.03, watchdog_floor: float = 2.0,
              device="cuda", verbose: bool = False) -> dict:
    """One full chaos scenario; returns the report (``check_report`` holds
    its invariants)."""
    if scale_peak == groups:                   # a scale cycle needs two
        scale_peak = 2 if groups > 2 else 8    # distinct mesh sizes
    rng = np.random.RandomState(seed)
    work = work or gemm_workload(seed=seed, device=device)
    server = InferenceServer(device=device,
                             mesh=rhal.TileMesh(groups, device=device),
                             max_queue=256, max_frame=work.max_frame,
                             watchdog_floor=watchdog_floor)
    addr = server.start()
    boot = Client(addr, max_frame=work.max_frame)
    boot.provision(work.image, work.prog.encode())
    boot.close()
    # the schedule scripts the scale transitions itself, so the depth-based
    # autoscaler is parked (thresholds unreachable); ticks still run the
    # observe/heal/probation machinery
    cfg = FleetConfig(min_groups=min(2, groups),
                      max_groups=max(scale_peak, groups),
                      scale_up_depth=10 ** 6, scale_down_depth=-1)
    fleet = FleetController(server, cfg)
    traffic = Traffic(addr, work, requests, clients, seed, retries,
                      pace_s).start()
    kill_gid = int(rng.randint(1, scale_peak))
    report: dict = {"schedule": {"seed": seed, "kill_gid": kill_gid},
                    "faults": [], "timings": {}}

    def timed(key: str, fn):
        t0 = time.perf_counter()
        out = fn()
        report["timings"][key] = time.perf_counter() - t0
        return out

    def wait_frac(frac: float, timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        while traffic.completed() < int(traffic.total * frac):
            if time.monotonic() > deadline:
                return
            fleet.tick()
            time.sleep(0.02)

    def log(msg: str) -> None:
        if verbose:
            print(f"[chaos {traffic.completed():3d}/{traffic.total}] {msg}",
                  flush=True)

    failures: list = []
    undo_delay = None
    try:
        wait_frac(0.10)
        log(f"scale {groups} -> {scale_peak}")
        timed("scale_up", lambda: fleet.scale_to(scale_peak))
        report["faults"].append("scale_up")

        wait_frac(0.25)
        log(f"kill tile group {kill_gid}")
        server.mesh.kill(kill_gid)          # in-flight stages fail over
        report["faults"].append(f"kill_g{kill_gid}")
        t_kill = time.perf_counter()
        for _ in range(20):                 # tick until repaired
            fleet.tick()
            if any(k in ("heal_complete", "reshape_complete")
                   for k, _ in fleet.events):
                break
            time.sleep(0.02)
        report["timings"]["kill_to_heal"] = time.perf_counter() - t_kill

        wait_frac(0.33)
        log("journaled install: a fault at every mid-write point")
        report["journal"], recovered_image = journal_fault_matrix(
            work.image)
        report["faults"].append("journal_fault")

        wait_frac(0.36)
        tgt = 1 if server.mesh.n_groups > 1 else 0
        log(f"corrupt DMA payloads toward group {tgt}")
        undo_corrupt, cstate = corrupt_dma_payload(server.mesh, tgt, 3)
        for _ in range(200):            # traffic drives the transfers
            if cstate["corrupted"] >= 3:
                break
            time.sleep(0.03)
        undo_corrupt()
        drv = server.mesh.group(tgt).driver
        report["dma_crc"] = {k: drv.stats.get(k, 0) for k in
                             ("dma_crc_checked", "dma_crc_mismatch",
                              "dma_retry", "dma_retry_recovered")}
        report["faults"].append("dma_payload_corruption")

        wait_frac(0.40)
        log("hot swap: identical weights, journal-recovered image")
        report["good_swap"] = timed("swap_good", lambda: fleet.swap_weights(
            recovered_image, label="repack"))
        report["faults"].append("swap_good")
        for _ in range(cfg.probation_ticks + 1):   # probation -> finalize
            fleet.tick()
        fleet.finalize_swap()                      # no-op if already done

        wait_frac(0.55)
        log("hot swap: WRONG weights (the probe must roll back)")
        report["bad_swap"] = timed("swap_bad", lambda: fleet.swap_weights(
            work.bad_image, label="bad"))
        report["faults"].append("swap_bad")

        wait_frac(0.62)
        tgt = 1 if server.mesh.n_groups > 1 else 0
        log(f"hang DMA redemption on group {tgt} (watchdog must preempt)")
        undo_hang, hstate = hang_until_killed(server.mesh, tgt)
        # a dedicated probe drives one dispatch through the mesh so the
        # wedge triggers even if the traffic has already drained
        probe: dict = {}
        pt = threading.Thread(target=lambda: probe.update(
            error=check_probe(addr, work, 0, seed, retries)), daemon=True)
        pt.start()
        t_hang = time.perf_counter()
        for _ in range(800):            # watchdog budget + failover
            if hstate["released"]:
                break
            fleet.tick()                # the repair restores capacity
            time.sleep(0.02)
        undo_hang()
        pt.join(timeout=30)
        if probe.get("error", "no reply") is not None:
            failures.append(f"hang probe: {probe.get('error', 'no reply')}")
        report["timings"]["hang_to_preempt"] = time.perf_counter() - t_hang
        report["watchdog"] = {
            "released": hstate["released"],
            "preemptions": server.platform.telemetry.counter(
                "watchdog_preemptions")}
        report["faults"].append("hung_dispatch")

        wait_frac(0.68)
        log(f"DMA delay {dma_delay_s}s on group 0")
        undo_delay = delay_dma(server.mesh, 0, dma_delay_s)
        report["faults"].append("dma_delay_g0")
        straggler_seen = False
        for _ in range(40):
            v = server.platform.heartbeats.check()
            if v["verdicts"].get("dispatcher") == "straggler":
                straggler_seen = True
                break
            time.sleep(0.03)
        undo_delay()
        undo_delay = None
        report["dispatcher_straggler_seen"] = straggler_seen

        wait_frac(0.80)
        log("corrupt-CRC frame on a sacrificial connection")
        report["crc_fault_contained"] = inject_corrupt_frame(addr)
        report["faults"].append("crc_corruption")

        wait_frac(0.90)
        log(f"scale {scale_peak} -> {groups}")
        timed("scale_down", lambda: fleet.scale_to(groups))
        report["faults"].append("scale_down")
        traffic.join()
    finally:
        if undo_delay is not None:
            undo_delay()
        fleet.stop()
        server.stop()
    report.update(traffic.report())
    report["failed"] += len(failures)
    report["failures"] = (failures + report["failures"])[:10]
    report.update({
        "p99_bound_s": p99_bound_s,
        "n_groups_final": server.mesh.n_groups,
        "events": [k for k, _ in fleet.events],
        "fleet": fleet.summary(),
        "counters": server.platform.telemetry.counters()})
    return report


def check_report(report: dict) -> list:
    """The invariants the core scenario must satisfy; returns the list of
    violations (empty == converged)."""
    bad = []
    if report["failed"]:
        bad.append(f"{report['failed']} failed requests: "
                   f"{report['failures']}")
    if report["mismatches"]:
        bad.append(f"{report['mismatches']} non-bit-identical responses")
    if report["ok"] != report["sent"]:
        bad.append(f"ok {report['ok']} != sent {report['sent']}")
    if report.get("good_swap") != "committed":
        bad.append(f"good swap not committed: {report.get('good_swap')}")
    if report.get("bad_swap") != "rolled_back":
        bad.append(f"bad swap not rolled back: {report.get('bad_swap')}")
    if not report.get("crc_fault_contained"):
        bad.append("CRC corruption was not contained")
    ev = report["events"]
    for needed in ("scale_complete", "swap_committed",
                   "swap_probed", "swap_rolled_back"):
        if needed not in ev:
            bad.append(f"missing fleet event {needed!r}")
    if "heal_complete" not in ev and "reshape_complete" not in ev:
        bad.append("no repair event: neither heal_complete nor "
                   "reshape_complete")
    if report["p99_s"] > report["p99_bound_s"]:
        bad.append(f"p99 {report['p99_s']:.3f}s past bound "
                   f"{report['p99_bound_s']:.3f}s")
    faults = report.get("faults", ())
    if "dma_payload_corruption" in faults:
        dc = report.get("dma_crc", {})
        if not dc.get("dma_retry_recovered"):
            bad.append("corrupted DMA payloads never recovered by the "
                       f"in-place retry: {dc}")
    if "hung_dispatch" in faults:
        wd = report.get("watchdog", {})
        if not wd.get("released"):
            bad.append("hung dispatch was never preempted")
        if not wd.get("preemptions"):
            bad.append("watchdog_preemptions counter never incremented")
    j = report.get("journal")
    if j is not None:
        if j.get("replayed") != 1 or j.get("rolled_back") != 2:
            bad.append(f"journal recovery wrong shape: {j} "
                       "(want 1 replay, 2 rollbacks)")
        if not j.get("image_ok"):
            bad.append("post-recovery image failed fsck")
    return bad


# ---------------------------------------------------------------------------
# The rollout schedule: canaries, a straggler, the brown-out ladder
# ---------------------------------------------------------------------------

def run_rollout_chaos(work: Optional[Workload] = None, groups: int = 2,
                      seed: int = 7, requests: int = 96, clients: int = 3,
                      retries: int = 10, slow_s: float = 0.15,
                      burst: int = 48, p99_bound_s: float = 30.0,
                      pace_s: float = 0.03, device="cuda",
                      verbose: bool = False) -> dict:
    """The safe-rollout and overload scenario: a good canary promotes, a
    bad one aborts with zero wrong bytes served, a straggling group is
    replaced in place (the survivors' drivers untouched), and a
    low-priority burst engages the brown-out ladder, which sheds with
    typed verdicts, circuit-breaks the failing group, probes it back and
    walks back to rung 0."""
    work = work or gemm_workload(seed=seed, device=device)
    server = InferenceServer(device=device,
                             mesh=rhal.TileMesh(groups, device=device),
                             max_queue=256, max_frame=work.max_frame)
    addr = server.start()
    boot = Client(addr, max_frame=work.max_frame)
    boot.provision(work.image, work.prog.encode())
    boot.close()
    # stage_straggler_ratio clears the mesh's natural stage imbalance and
    # still catches the scripted slow_s stall (100x+ the median)
    fleet = FleetController(server, FleetConfig(
        scale_up_depth=10 ** 6, scale_down_depth=-1, straggler_ticks=2,
        stage_straggler_ratio=50.0))
    over = BrownoutController(server, OverloadConfig(
        p99_high=0.05, min_window=2, escalate_ticks=1, recover_ticks=2,
        shed_priority=2, breaker_cooldown_ticks=1))
    traffic = Traffic(addr, work, requests, clients, seed, retries, pace_s,
                      priority=0).start()
    report: dict = {"schedule": {"seed": seed, "groups": groups},
                    "faults": [], "timings": {}}

    def wait_frac(frac: float, timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        while traffic.completed() < int(traffic.total * frac):
            if time.monotonic() > deadline:
                return
            fleet.tick()
            time.sleep(0.02)

    def log(msg: str) -> None:
        if verbose:
            print(f"[rollout {traffic.completed():3d}/{traffic.total}] "
                  f"{msg}", flush=True)

    def tick_until(pred, limit: int = 400, overload: bool = False,
                   fleet_ticks: bool = True):
        # fleet_ticks=False while the breaker owns a group: the fleet's
        # dead-group replacement must not race the circuit's cycle
        for _ in range(limit):
            if fleet_ticks:
                fleet.tick()
            if overload:
                over.tick()
            if pred():
                return True
            time.sleep(0.02)
        return pred()

    def seen(kind: str) -> int:
        return sum(1 for k, _ in fleet.events if k == kind)

    undo_slow = None
    try:
        wait_frac(0.08)
        log("canary GOOD image (identical weights repack)")
        t0 = time.perf_counter()
        report["canary_good_started"] = fleet.canary(
            work.image, fraction=0.5, label="good")
        promoted = tick_until(lambda: seen("canary_promoted") > 0)
        report["timings"]["canary_to_promote"] = time.perf_counter() - t0
        report["canary_good"] = "promoted" if promoted else "undecided"
        good_ev = [p for k, p in fleet.events if k == "canary_promoted"]
        if good_ev:
            report["canary_good_stats"] = good_ev[-1].get("stats")
        report["faults"].append("canary_good")

        wait_frac(0.30)
        log("canary BAD image (wrong weights: the SPRT must abort)")
        report["canary_bad_started"] = fleet.canary(
            work.bad_image, fraction=0.5, label="bad")
        aborted = tick_until(lambda: seen("canary_aborted") > 0)
        report["canary_bad"] = "aborted" if aborted else "undecided"
        bad_ev = [p for k, p in fleet.events if k == "canary_aborted"]
        if bad_ev:
            report["canary_bad_stats"] = bad_ev[-1].get("stats")
        report["faults"].append("canary_bad_image")

        wait_frac(0.45)
        slow_gid = 1 if groups > 1 else 0
        mesh_before = server.mesh
        peers = {g: mesh_before.group(g).driver
                 for g in mesh_before.gids if g != slow_gid}
        old_driver = mesh_before.group(slow_gid).driver
        log(f"slow group {slow_gid}: stalled redemption {slow_s}s")
        undo_slow = slow_group_redeem(server.mesh, slow_gid, slow_s)
        report["faults"].append("slow_group")
        t0 = time.perf_counter()
        n_reshapes = seen("reshape_complete")
        reshaped = tick_until(lambda: seen("reshape_complete") > n_reshapes)
        undo_slow()
        undo_slow = None
        report["timings"]["slow_to_reshape"] = time.perf_counter() - t0
        report["reshape"] = {
            "happened": reshaped,
            "same_mesh": server.mesh is mesh_before,
            "replaced_driver_changed":
                server.mesh.group(slow_gid).driver is not old_driver,
            "survivors_untouched": all(
                server.mesh.group(g).driver is d for g, d in peers.items()),
            "log": [(p.get("group"), p.get("reason"))
                    for k, p in fleet.events if k == "reshape_complete"]}

        wait_frac(0.60)
        log(f"overload burst: {burst} low-priority requests + a scripted "
            f"failing group")
        flaky_gid = 0
        for _ in range(3):
            server.platform.post("tile_failure",
                                 {"group": flaky_gid, "stage": 0})
        shed_kinds: list = []
        burst_ok = [0]
        lock = threading.Lock()

        def burst_traffic(bid: int) -> None:
            cl = Client(addr, retry_seed=seed * 77 + bid,
                        max_frame=work.max_frame)
            try:
                for i in range(burst // 6):
                    j = (bid + i) % len(work.pool)
                    try:
                        out = cl.infer(priority=3, **work.pool[j])
                        with lock:
                            burst_ok[0] += 1
                            if not same_outputs(out, work.refs[j]):
                                shed_kinds.append("mismatch")
                    except (RequestShed, ServerBusy) as e:
                        with lock:
                            shed_kinds.append(getattr(e, "kind", ""))
                    except Exception:
                        with lock:
                            shed_kinds.append("")
            finally:
                cl.close()

        bt = [threading.Thread(target=burst_traffic, args=(b,), daemon=True)
              for b in range(6)]
        t0 = time.perf_counter()
        for t in bt:
            t.start()
        max_rung = [0]

        def pump_burst():
            over.tick()
            max_rung[0] = max(max_rung[0], over.rung)
            return not any(t.is_alive() for t in bt)

        tick_until(pump_burst, limit=800, fleet_ticks=False)
        for t in bt:
            t.join(timeout=60)
        recovered = tick_until(
            lambda: over.rung == 0 and over.breaker.state == "closed",
            limit=800, overload=True, fleet_ticks=False)
        report["timings"]["overload_recovery"] = time.perf_counter() - t0
        report["overload"] = {
            "max_rung": max_rung[0], "final_rung": over.rung,
            "recovered": recovered,
            "burst_ok": burst_ok[0], "burst_shed": len(shed_kinds),
            "shed_kinds": sorted(set(shed_kinds)),
            "untyped_sheds": sum(1 for k in shed_kinds
                                 if k not in VERDICT_KINDS),
            "breaker": dict(over.breaker.stats, state=over.breaker.state),
            "summary": over.summary()}
        report["faults"].append("overload_burst")
        traffic.join()
    finally:
        if undo_slow is not None:
            undo_slow()
        fleet.stop()
        over.stop()
        server.stop()
    report.update(traffic.report())
    report.update({
        "p99_bound_s": p99_bound_s,
        "events": [k for k, _ in fleet.events] + [k for k, _ in over.events],
        "fleet": fleet.summary(),
        "counters": server.platform.telemetry.counters()})
    return report


def check_rollout_report(report: dict) -> list:
    """Invariants of the rollout scenario (empty == converged)."""
    bad = []
    if report["failed"]:
        bad.append(f"{report['failed']} failed requests: "
                   f"{report['failures']}")
    if report["mismatches"]:
        bad.append(f"{report['mismatches']} non-bit-identical responses "
                   "(a canary served wrong bytes?)")
    if report["ok"] != report["sent"]:
        bad.append(f"ok {report['ok']} != sent {report['sent']}")
    if report.get("canary_good") != "promoted":
        bad.append(f"good canary not promoted: {report.get('canary_good')}")
    if report.get("canary_bad") != "aborted":
        bad.append(f"bad canary not aborted: {report.get('canary_bad')}")
    bstats = report.get("canary_bad_stats") or {}
    if bstats.get("served_shadow", 0):
        bad.append(f"bad canary served {bstats['served_shadow']} shadow "
                   "responses")
    rs = report.get("reshape", {})
    if not rs.get("happened"):
        bad.append("slow group never partial-reshaped")
    if not rs.get("same_mesh"):
        bad.append("partial reshape rebuilt the mesh instead of splicing")
    if not rs.get("replaced_driver_changed"):
        bad.append("straggler group's driver not replaced")
    if not rs.get("survivors_untouched"):
        bad.append("partial reshape touched a surviving group's driver")
    ov = report.get("overload", {})
    if ov.get("max_rung", 0) < 1:
        bad.append("overload burst never engaged the brown-out ladder")
    if ov.get("final_rung") != 0 or not ov.get("recovered"):
        bad.append(f"ladder did not walk back to rung 0: {ov}")
    if ov.get("untyped_sheds"):
        bad.append(f"{ov['untyped_sheds']} sheds carried no typed verdict "
                   f"kind (kinds seen: {ov.get('shed_kinds')})")
    if ov.get("burst_shed", 0) + ov.get("burst_ok", 0) == 0:
        bad.append("overload burst sent no traffic")
    ev = report["events"]
    for needed in ("canary_started", "canary_promoted", "canary_aborted",
                   "reshape_started", "reshape_complete"):
        if needed not in ev:
            bad.append(f"missing rollout event {needed!r}")
    if ov.get("max_rung", 0) >= 4:
        br = ov.get("breaker", {})
        if not br.get("trips"):
            bad.append("rung 4 reached but the breaker never tripped")
        if br.get("state") != "closed":
            bad.append(f"breaker did not recover: {br}")
    if report["p99_s"] > report["p99_bound_s"]:
        bad.append(f"p99 {report['p99_s']:.3f}s past bound "
                   f"{report['p99_bound_s']:.3f}s")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenario", choices=("core", "rollout"),
                    default="core")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--groups", type=int, default=2)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--requests", type=int, default=90)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--log", type=str, default=None,
                    help="write the full report as JSON")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    kw = dict(groups=args.groups, seed=args.seed, requests=args.requests,
              clients=args.clients, device=args.device,
              verbose=args.verbose)
    if args.scenario == "rollout":
        report = run_rollout_chaos(**kw)
        violations = check_rollout_report(report)
    else:
        report = run_chaos(**kw)
        violations = check_report(report)
    if args.log:
        with open(args.log, "w") as f:
            json.dump({"report": report, "violations": violations}, f,
                      indent=2, default=str)
    print(json.dumps({k: report[k] for k in ("sent", "ok", "failed",
                                             "mismatches", "p50_s",
                                             "p99_s", "faults")}))
    for v in violations:
        print(f"VIOLATION: {v}", file=sys.stderr)
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
