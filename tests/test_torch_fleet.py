"""The port's fleet controller on the CPU, held against the JAX package
(tests/test_fleet.py's scenarios): autoscaling decisions, a live mesh
reshape with zero dropped requests, partial reshape and full heal, hot
weight swap (probe, commit, probation, rollback), canary A/B with its SPRT,
RIMFS residency under a swap, client backpressure retry and a chaos smoke
run. Every reply equals the port's ``Executor.run`` bit for bit and the JAX
package's at 1e-5; ``golden_inputs``, the SPRT's verdicts, the canary's
routing and a fixed schedule's event kinds equal the JAX package's exactly.
The dispatcher is held on a gate, never on sleeps."""
import dataclasses
import functools
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import fleet as jax_fleet
from repro.core import rbl as jax_rbl
from repro.core import rctc as jax_rctc
from repro.core import rhal as jax_rhal
from repro.core import rimfs as jax_rimfs
from repro.core.executor import Executor as JaxExecutor
from repro.serving.server import Client as JaxClient
from repro.serving.server import InferenceServer as JaxInferenceServer
from repro_torch.configs import get_config
from repro_torch.core import rbl, rctc, rhal, rimfs
from repro_torch.core.executor import Executor
from repro_torch.core.fleet import (SPRT, CanaryState, FleetConfig,
                                    FleetController, golden_inputs)
from repro_torch.models import transformer as tf
from repro_torch.serving import chaos
from repro_torch.serving.protocol import F_CANARY
from repro_torch.serving.server import (Client, InferenceServer, ServerBusy,
                                        _Work)

DEPTH, N = 8, 24
OP_ATOL = 1e-5                     # fp32 ops: tests/test_torch_oplib.py


@pytest.fixture(scope="module")
def chain_setup():
    prog = rctc.compile_gemm_chain(DEPTH, N)
    files = rctc.gemm_chain_weights(DEPTH, N)
    return prog, files, rimfs.pack(files)


def _x(seed=0):
    return np.random.RandomState(seed).randn(N, N).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _refs(seed: int, wseed: int = 0):
    """(the port's Executor.run, the JAX package's) reply to ``_x(seed)``
    under the chain's weights from ``wseed``."""
    x = _x(seed)
    files = rctc.gemm_chain_weights(DEPTH, N, seed=wseed)
    fs = rimfs.mount(rimfs.pack(files))
    port = Executor(device="cpu").run(
        rbl.bind(rctc.compile_gemm_chain(DEPTH, N), rimfs=fs,
                 inputs={"input": x}))["output"].numpy()
    jfs = jax_rimfs.mount(jax_rimfs.pack(files))
    jax_out = np.asarray(JaxExecutor().run(
        jax_rbl.bind(jax_rctc.compile_gemm_chain(DEPTH, N), rimfs=jfs,
                     inputs={"input": x}))["output"])
    return port, jax_out


def _check(out, seed, wseed=0):
    port, jax_out = _refs(seed, wseed)
    np.testing.assert_array_equal(out["output"], port)
    np.testing.assert_allclose(out["output"], jax_out, rtol=0, atol=OP_ATOL)


def _start(prog, image, mesh_groups=2, **kw):
    mesh = rhal.TileMesh(mesh_groups, device="cpu") if mesh_groups else None
    server = InferenceServer(device="cpu", mesh=mesh, **kw)
    addr = server.start()
    client = Client(addr)
    client.provision(image, prog.encode())
    return server, addr, client


def _wedge_dispatcher(server):
    """Park the dispatcher on a gate via a control op (the deterministic
    stand-in for a drain window or a long dispatch)."""
    gate = threading.Event()
    entered = threading.Event()

    def ctl():
        entered.set()
        gate.wait(30)

    assert server._loop.submit(_Work(frame=None, route=None, control=ctl))
    assert entered.wait(5)
    return gate


def _total_dma(mesh):
    return sum(g.driver.stats.get("dma_bytes", 0) for g in mesh.groups)


# ------------------------------------------------------------- scale cycle
def test_scale_cycle_bit_identical_and_cached_mesh(chain_setup):
    """2 -> 4 -> 8 -> 2 under pipelined traffic: every reply bit-identical,
    scaling back reuses the cached original mesh and re-uploads zero weight
    bytes."""
    prog, files, image = chain_setup
    server, addr, client = _start(prog, image, mesh_groups=2)
    try:
        fleet = FleetController(server)
        x = _x(1)
        _check(client.infer(input=x), 1)
        d0 = _total_dma(server.mesh)
        client.infer(input=x)
        per_req = _total_dma(server.mesh) - d0      # steady per request
        for n_groups in (4, 8):
            rids = [client.infer_async(input=x) for _ in range(3)]
            rep = fleet.scale_to(n_groups)
            assert server.mesh.n_groups == n_groups
            assert rep["from"] != rep["to"] == n_groups
            for rid in rids:            # in flight across the flip: all ok
                _check(client.result(rid), 1)
        rep = fleet.scale_to(2)
        assert rep["cached_mesh"], "original 2-mesh should be cache-hit"
        d2 = _total_dma(server.mesh)
        _check(client.infer(input=x), 1)
        assert _total_dma(server.mesh) - d2 == per_req
        assert [k for k, _ in fleet.events].count("scale_complete") == 3
        assert set(fleet.timings["scale"]) == {"prewarm", "flip"}
        # the 4- and 8-meshes stay cached, each holding its pinned image
        pinned = fleet.pinned_bytes()
        assert sorted(pinned) == [2, 4, 8]
        assert len(set(pinned.values())) == 1 and pinned[2] > 0
    finally:
        client.close()
        server.stop()


def test_autoscaler_decides_up_on_real_backlog(chain_setup):
    """Queue depth from a wedged dispatcher drives observe->decide up the
    ladder after the hysteresis streak; the backlog then drains without a
    dropped request."""
    prog, files, image = chain_setup
    server, addr, client = _start(prog, image, mesh_groups=2)
    try:
        # the stage-time straggler reads one request's host-clock stage
        # times here, which a loaded CPU can skew past its ratio on the
        # third decide; this test holds the depth scaler alone
        fleet = FleetController(server, FleetConfig(
            scale_up_depth=6, scale_up_ticks=2, stage_straggler_ratio=1e9))
        x = _x(2)
        _check(client.infer(input=x), 2)
        gate = _wedge_dispatcher(server)
        try:
            rids = [client.infer_async(input=x) for _ in range(8)]
            deadline = time.monotonic() + 5     # enqueue is async: wait
            while server.scheduler.pending() < 8:   # for the backlog
                assert time.monotonic() < deadline
                time.sleep(0.005)
            a1 = fleet.decide(fleet.observe())
            a2 = fleet.decide(fleet.observe())
            assert a1 is None                 # streak not yet reached
            assert a2 == ("scale", 4)         # second tick over threshold
        finally:
            gate.set()
        for rid in rids:
            _check(client.result(rid), 2)
        # the idle hook may drain the backlog while the burst's kicks, each
        # counted in the depth, still wait in the dispatcher's queue
        deadline = time.monotonic() + 10
        while server._loop.depth() and time.monotonic() < deadline:
            time.sleep(0.005)
        obs = fleet.observe()                 # drained: pressure gone
        assert fleet.decide(obs) is None and fleet._up_streak == 0
    finally:
        client.close()
        server.stop()


def test_control_op_runs_before_requests_that_arrive_after_it(chain_setup):
    """A flip waiting on the dispatcher is not held back by a backlog that
    keeps refilling: requests admitted after the control op was submitted
    get at most one admission round ahead of it, and every one is then
    served bit for bit."""
    prog, files, image = chain_setup
    server, addr, client = _start(prog, image, mesh_groups=2)
    try:
        x = _x(11)
        _check(client.infer(input=x), 11)
        tele = server.platform.telemetry
        gate = _wedge_dispatcher(server)
        seen: dict = {}
        try:
            flip = threading.Thread(target=lambda: seen.update(
                served=server.run_on_dispatcher(tele.count)))
            flip.start()
            deadline = time.monotonic() + 5
            while server._loop.depth() < 1:       # the op is queued
                assert time.monotonic() < deadline
                time.sleep(0.005)
            served0 = tele.count()
            rids = [client.infer_async(input=x) for _ in range(8)]
            while server.scheduler.pending() < 8:
                assert time.monotonic() < deadline
                time.sleep(0.005)
        finally:
            gate.set()
        flip.join(timeout=60)
        assert seen["served"] - served0 <= 1
        for rid in rids:
            _check(client.result(rid, timeout=60), 11)
    finally:
        client.close()
        server.stop()


def test_single_dead_group_partial_reshape_zero_survivor_bytes(chain_setup):
    """One dead group is spliced out by a partial reshape: the mesh object
    survives, only the slot's driver changes, the survivors' DMA counters
    move zero bytes, and the replacement uploads exactly its tile's
    weights; the retired driver's residency is released."""
    prog, files, image = chain_setup
    server, addr, client = _start(prog, image, mesh_groups=4)
    try:
        fleet = FleetController(server)
        x = _x(3)
        _check(client.infer(input=x), 3)
        mesh = server.mesh
        survivors = {g: mesh.group(g).driver for g in mesh.gids if g != 2}
        dma_before = {g: d.stats.get("dma_bytes", 0)
                      for g, d in survivors.items()}
        old_driver = mesh.group(2).driver
        fs = server.platform.rimfs
        assert id(old_driver) in fs._resident
        mesh.kill(2)
        rep = fleet.tick()
        assert rep["action"] == ("replace", 2, "dead")
        assert "error" not in rep
        assert server.mesh is mesh
        fresh = mesh.group(2).driver
        assert fresh is not old_driver
        for g, d in survivors.items():
            assert mesh.group(g).driver is d
            assert d.stats.get("dma_bytes", 0) == dma_before[g]
        tile = server._bound._partitions[4].tiles[2]
        want = sum(fs.stat(s)["nbytes"] for s in tile.weight_syms)
        assert fresh.stats["dma_bytes"] == want
        assert id(old_driver) not in fs._resident
        assert id(old_driver) not in tile._bound
        assert all(mesh.alive(g) for g in mesh.gids)
        _check(client.infer(input=x), 3)
        kinds = [k for k, _ in fleet.events]
        assert "reshape_started" in kinds and "reshape_complete" in kinds
        assert "heal_complete" not in kinds
    finally:
        client.close()
        server.stop()


def test_multi_dead_groups_fall_back_to_full_heal(chain_setup):
    prog, files, image = chain_setup
    server, addr, client = _start(prog, image, mesh_groups=4)
    try:
        fleet = FleetController(server)
        x = _x(3)
        _check(client.infer(input=x), 3)
        doomed = server.mesh
        server.mesh.kill(1)
        server.mesh.kill(2)
        rep = fleet.tick()
        assert rep["action"] == ("heal", (1, 2))
        assert "error" not in rep
        assert server.mesh is not doomed
        assert all(server.mesh.alive(g) for g in server.mesh.gids)
        # the healed mesh's drivers hold nothing any more
        fs = server.platform.rimfs
        assert not any(id(g.driver) in fs._resident for g in doomed.groups)
        _check(client.infer(input=x), 3)
        kinds = [k for k, _ in fleet.events]
        assert "heal_started" in kinds and "heal_complete" in kinds
    finally:
        client.close()
        server.stop()


# ---------------------------------------------------------------- hot swap
def test_hot_swap_commits_and_stays_bit_identical(chain_setup):
    prog, files, image = chain_setup
    server, addr, client = _start(prog, image, mesh_groups=2)
    try:
        fleet = FleetController(server)
        x = _x(4)
        _check(client.infer(input=x), 4)
        old_bound, old_fs = server._bound, server.platform.rimfs
        assert fleet.swap_weights(rimfs.pack(files),
                                  label="repack") == "committed"
        assert server._bound is not old_bound
        _check(client.infer(input=x), 4)
        kinds = [k for k, _ in fleet.events]
        assert kinds[-3:] == ["swap_started", "swap_probed",
                              "swap_committed"]
        assert set(fleet.timings["swap"]) == {"mount_crc", "bind", "probe",
                                              "prewarm", "flip"}
        # the probe's own driver let go of its copy of the new image
        new_fs = server.platform.rimfs
        mesh_ids = {id(g.driver) for g in server.mesh.groups}
        assert set(new_fs._resident) == mesh_ids
        for i in range(fleet.cfg.probation_requests):
            client.infer(input=_x(40 + i))
        for _ in range(fleet.cfg.probation_ticks + 1):
            fleet.tick()
        assert not fleet.summary()["swap_in_probation"]
        fin = [p for k, p in fleet.events if k == "swap_finalized"]
        assert fin and fin[-1]["freed_bytes"] == len(files) * N * N * 4
        assert old_fs._resident == {}
        assert getattr(old_bound, "_partitions", None) is None
    finally:
        client.close()
        server.stop()


def test_zero_traffic_probation_never_auto_commits(chain_setup):
    """Probation counts SERVED REQUESTS, not ticks: an idle fleet spins the
    control loop without the swap finalizing, and rollback stays clean."""
    prog, files, image = chain_setup
    server, addr, client = _start(prog, image, mesh_groups=2)
    try:
        fleet = FleetController(server)
        client.infer(input=_x(4))
        assert fleet.swap_weights(rimfs.pack(files),
                                  label="idle") == "committed"
        for _ in range(fleet.cfg.probation_ticks * 5):
            rep = fleet.tick()
        assert rep["swap"]["state"] == "probation"
        assert rep["swap"]["served"] == 0
        assert fleet.summary()["swap_in_probation"]
        assert "swap_finalized" not in [k for k, _ in fleet.events]
        new_fs = server.platform.rimfs
        fleet.rollback(reason="test")
        assert not fleet.summary()["swap_in_probation"]
        assert new_fs._resident == {}          # the shadow's copy is gone
        _check(client.infer(input=_x(4)), 4)
    finally:
        client.close()
        server.stop()


def test_bad_swap_detected_by_probe_and_rolled_back(chain_setup):
    prog, files, image = chain_setup
    server, addr, client = _start(prog, image, mesh_groups=2)
    try:
        fleet = FleetController(server)
        x = _x(5)
        _check(client.infer(input=x), 5)
        old_bound, old_fs = server._bound, server.platform.rimfs
        wrong = rctc.gemm_chain_weights(DEPTH, N, seed=123)
        assert fleet.swap_weights(rimfs.pack(wrong),
                                  label="wrong") == "rolled_back"
        assert server._bound is old_bound
        assert server.platform.rimfs is old_fs
        _check(client.infer(input=x), 5)
        probed = [p for k, p in fleet.events if k == "swap_probed"]
        assert probed and probed[-1]["ok"] is False
        broken = bytearray(rimfs.pack(files))
        broken[-2] ^= 0xFF
        assert fleet.swap_weights(bytes(broken),
                                  label="corrupt") == "rolled_back"
        reasons = [p["reason"] for k, p in fleet.events
                   if k == "swap_rolled_back"]
        assert any(r.startswith("mount:") for r in reasons)
    finally:
        client.close()
        server.stop()


def test_post_swap_miss_spike_triggers_auto_rollback(chain_setup):
    """A committed swap in probation rolls back when the shed rate spikes;
    the old binding resumes with zero re-upload."""
    prog, files, image = chain_setup
    server, addr, client = _start(prog, image, mesh_groups=2)
    try:
        fleet = FleetController(server, FleetConfig(miss_spike=0.25,
                                                    spike_min_window=4))
        x = _x(6)
        _check(client.infer(input=x), 6)
        old_bound = server._bound
        assert fleet.swap_weights(rimfs.pack(files),
                                  label="regressing") == "committed"
        server.scheduler.shed_count += 10      # simulated miss spike
        rep = fleet.tick()
        assert rep["swap"]["state"] == "rolled_back"
        assert server._bound is old_bound
        d0 = _total_dma(server.mesh)
        _check(client.infer(input=x), 6)
        assert _total_dma(server.mesh) - d0 < len(image) / 2
        reasons = [p["reason"] for k, p in fleet.events
                   if k == "swap_rolled_back"]
        assert any(r.startswith("miss_spike") for r in reasons)
    finally:
        client.close()
        server.stop()


# ------------------------------------------------------------------ canary
def test_canary_good_image_auto_promotes_bit_identical(chain_setup):
    prog, files, image = chain_setup
    server, addr, client = _start(prog, image, mesh_groups=2)
    try:
        fleet = FleetController(server)
        x = _x(8)
        _check(client.infer(input=x), 8)
        old_bound, old_fs = server._bound, server.platform.rimfs
        assert fleet.canary(rimfs.pack(files), fraction=1.0,
                            label="repack") == "started"
        assert server.canary is not None
        flagged = 0
        for _ in range(16):                 # > 14 agrees the SPRT needs
            out, flags = client.result(client.infer_async(input=x),
                                       with_flags=True)
            _check(out, 8)
            flagged += bool(flags & F_CANARY)
        assert flagged == 16                # fraction 1.0: all shadow-served
        rep = fleet.tick()
        assert rep["canary"]["state"] == "promote"
        assert server.canary is None and fleet._canary is None
        assert server._bound is not old_bound
        assert old_fs._resident == {}       # the old image let go
        promoted = [p for k, p in fleet.events if k == "canary_promoted"]
        assert promoted and promoted[-1]["disagrees"] == 0
        assert promoted[-1]["stats"]["served_shadow"] == 16
        _check(client.infer(input=x), 8)
    finally:
        client.close()
        server.stop()


def test_canary_bad_image_serves_zero_wrong_bytes_then_aborts(chain_setup):
    prog, files, image = chain_setup
    server, addr, client = _start(prog, image, mesh_groups=2)
    try:
        fleet = FleetController(server)
        x = _x(9)
        _check(client.infer(input=x), 9)
        old_bound, old_fs = server._bound, server.platform.rimfs
        wrong = rimfs.pack(rctc.gemm_chain_weights(DEPTH, N, seed=321))
        assert fleet.canary(wrong, fraction=1.0, label="bad") == "started"
        shadow_fs = fleet._canary.fs
        for _ in range(6):
            out, flags = client.result(client.infer_async(input=x),
                                       with_flags=True)
            assert not (flags & F_CANARY)   # never the shadow's bytes
            _check(out, 9)                  # always the primary's answer
        rep = fleet.tick()
        assert rep["canary"]["state"] == "abort"
        assert server.canary is None and fleet._canary is None
        assert server._bound is old_bound
        assert server.platform.rimfs is old_fs
        assert shadow_fs._resident == {}
        aborted = [p for k, p in fleet.events if k == "canary_aborted"]
        assert aborted and aborted[-1]["reason"] == "sprt"
        assert aborted[-1]["stats"]["served_shadow"] == 0
        assert aborted[-1]["stats"]["disagree"] >= \
            fleet.cfg.canary_min_samples
        _check(client.infer(input=x), 9)
    finally:
        client.close()
        server.stop()


def test_stage_ewma_straggler_replaced_in_place(chain_setup):
    prog, files, image = chain_setup
    server, addr, client = _start(prog, image, mesh_groups=2)
    try:
        fleet = FleetController(server, FleetConfig(
            straggler_ticks=2, stage_straggler_ratio=2.0))
        x = _x(10)
        _check(client.infer(input=x), 10)
        mesh = server.mesh
        old_slow = mesh.group(1).driver
        fast = mesh.group(0).driver
        fleet._stage_ewma = {0: 0.01, 1: 0.25}
        r1 = fleet.tick()
        assert r1["action"] is None          # hysteresis: streak 1 of 2
        r2 = fleet.tick()
        assert r2["action"] == ("replace", 1, "straggler")
        assert "error" not in r2
        assert server.mesh is mesh
        assert mesh.group(1).driver is not old_slow
        assert mesh.group(0).driver is fast
        assert 1 not in fleet._stage_ewma
        _check(client.infer(input=x), 10)
        started = [p for k, p in fleet.events if k == "reshape_started"]
        assert started and started[-1]["reason"] == "straggler"
    finally:
        client.close()
        server.stop()


# ------------------------------------------------- RIMFS residency (swap)
def test_shadow_image_residency_no_evict_no_alias_zero_byte_rollback(rng):
    """Pinning a second image while the first is live neither evicts,
    moves nor aliases the first image's arena ranges; after dropping the
    shadow, re-binding the original moves zero bytes."""
    drv = rhal.make_eager_driver("cpu")
    files_a = {f"w{i}": rng.randn(16, 16).astype(np.float32)
               for i in range(4)}
    files_b = {f"w{i}": rng.randn(16, 16).astype(np.float32)
               for i in range(4)}
    fs_a = rimfs.mount(rimfs.pack(files_a))
    fs_b = rimfs.mount(rimfs.pack(files_b))
    ra = fs_a.resident(drv)
    ranges_a = ra.pinned_ranges()
    live_a = {n: ra[n].clone() for n in ra.files()}
    rb = fs_b.resident(drv)                    # the shadow pin
    assert ra.pinned_ranges() == ranges_a      # nothing moved or evicted
    for o1, s1 in ranges_a:                    # no aliasing
        for o2, s2 in rb.pinned_ranges():
            assert o1 + s1 <= o2 or o2 + s2 <= o1
    for n in ra.files():                       # old bytes untouched
        assert torch.equal(live_a[n], ra[n])
        np.testing.assert_array_equal(ra[n].numpy(), files_a[n])
    assert FleetController._release_residency(fs_b) == 4 * 16 * 16 * 4
    before = drv.stats.get("dma_bytes", 0)
    assert fs_a.resident(drv) is ra            # cache hit, same pinning
    assert drv.stats.get("dma_bytes", 0) == before
    drv.arena.check()


# ------------------------------------------------------------ client retry
def test_client_retry_drains_busy_burst(chain_setup):
    """A burst into a held dispatcher hard-fails without retry and fully
    succeeds with bounded jittered-backoff retry. Six retrying clients meet
    an admission cap of four, and the dispatcher is released only once the
    server has refused one of them, so the test waits on the server's
    counters, never on a sleep."""
    prog, files, image = chain_setup
    server, addr, client = _start(prog, image, mesh_groups=0, max_queue=4)
    try:
        x = _x(7)
        _check(client.infer(input=x), 7)
        stats = server._loop.stats
        gate = _wedge_dispatcher(server)
        try:
            plain = Client(addr)
            r0 = stats["rejected"]
            rids = [plain.infer_async(input=x) for _ in range(12)]
            # every request is either queued behind the gate or refused
            # (each refusal path counts one rejection): wait for all 12
            deadline = time.monotonic() + 10
            while server.scheduler.pending() + stats["rejected"] - r0 < 12:
                assert time.monotonic() < deadline
                time.sleep(0.005)
        finally:
            gate.set()
        outcomes = []
        for rid in rids:
            try:
                outcomes.append(plain.result(rid, timeout=60))
            except ServerBusy:
                outcomes.append("busy")
        assert "busy" in outcomes
        for out in outcomes:
            if out != "busy":
                _check(out, 7)
        plain.close()

        gate = _wedge_dispatcher(server)
        r0 = stats["rejected"]
        results, errors = [], []

        def worker(cid):
            cl = Client(addr, retries=20, backoff=0.01, retry_seed=cid)
            try:
                for _ in range(4):
                    results.append((cl.infer(input=x, timeout=60),
                                    cl.retry_stats["busy"]))
            except Exception as e:      # pragma: no cover
                errors.append(e)
            finally:
                cl.close()

        # six clients in flight at once against a cap of four: the held
        # dispatcher must refuse some of them
        threads = [threading.Thread(target=worker, args=(c,))
                   for c in range(6)]
        for t in threads:
            t.start()
        try:                # the burst has hit the held dispatcher
            deadline = time.monotonic() + 30
            while stats["rejected"] == r0:
                assert time.monotonic() < deadline
                time.sleep(0.005)
        finally:
            gate.set()
        for t in threads:
            t.join(timeout=60)
        assert not errors
        assert len(results) == 24
        for out, _ in results:
            _check(out, 7)
        assert any(busy > 0 for _, busy in results)
    finally:
        client.close()
        server.stop()


# ------------------------------------------------------------ chaos smoke
def test_chaos_smoke_converges():
    """A reduced core chaos scenario (test_torch_chaos.py runs the fuller
    ones): zero failed requests, bit-identical outputs, every swap and
    repair event present."""
    report = chaos.run_chaos(groups=2, seed=3, requests=24, clients=2,
                             scale_peak=4, pace_s=0.01, dma_delay_s=0.1,
                             watchdog_floor=0.5, device="cpu")
    assert chaos.check_report(report) == []


# ---------------------------------------------- equal to the JAX package
def _golden_programs():
    bf16 = dataclasses.replace(get_config("qwen2-1.5b-smoke"),
                               dtype="bfloat16")
    params = tf.init_params(bf16, 0, device="cpu")
    prog, _ = rctc.compile_transformer_block(bf16, params, 1, 8)
    return {"fp32": rctc.compile_gemm_chain(2, 8),
            "int32": rctc.compile_passthrough((3, 5), "int32"),
            "bf16_and_int32": prog}


@pytest.mark.parametrize("seed", [0xF1EE7, 5])
def test_golden_inputs_bit_equal_jax(seed):
    from repro.core.rcb import RCBProgram as JaxRCBProgram
    for name, prog in _golden_programs().items():
        jprog = JaxRCBProgram.decode(prog.encode())
        got, want = golden_inputs(prog, seed), jax_fleet.golden_inputs(
            jprog, seed)
        assert list(got) == list(want), name
        for k in want:
            w = np.asarray(want[k])
            if w.dtype.kind == "V":             # ml_dtypes bfloat16
                assert got[k].dtype == torch.bfloat16
                g = got[k].view(torch.int16).numpy().view(np.uint16)
                w = w.view(np.uint16)
            else:
                g = got[k]
                assert g.dtype == w.dtype, (name, k)
            assert g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    kinds = {str(np.asarray(v).dtype) if not isinstance(v, torch.Tensor)
             else str(v.dtype) for v in golden_inputs(
                 _golden_programs()["bf16_and_int32"], seed).values()}
    assert kinds == {"torch.bfloat16", "int32"}


@pytest.mark.parametrize("p_bad", [0.80, 0.5])
def test_sprt_and_canary_routing_equal_jax(p_bad):
    rng = np.random.RandomState(11)
    for trial in range(40):
        agree_p = rng.choice([1.0, 0.99, 0.9, 0.6])
        stream = rng.rand(300) < agree_p
        port, ref = SPRT(p_bad=p_bad), jax_fleet.SPRT(p_bad=p_bad)
        for bit in stream:
            port.observe(bool(bit))
            ref.observe(bool(bit))
            assert port.verdict() == ref.verdict()
            assert port.llr == ref.llr
        assert port.summary() == ref.summary()
    for frac, sample in ((0.25, 1.0), (0.5, 0.3), (0.07, 0.9)):
        port = CanaryState(None, None, frac, SPRT(), sample_fraction=sample)
        ref = jax_fleet.CanaryState(None, None, frac, jax_fleet.SPRT(),
                                    sample_fraction=sample)
        rids = list(range(0, 2000)) + [2 ** 40 + 3, 2 ** 63 - 1]
        assert [port.routes(r) for r in rids] == [ref.routes(r)
                                                  for r in rids]
        assert [port.samples(r) for r in rids] == [ref.samples(r)
                                                   for r in rids]
        routed = sum(port.routes(r) for r in range(2000)) / 2000
        assert abs(routed - frac) < 0.05


def _schedule(server, client, fleet, mod, files, image, wrong):
    """A fixed schedule: scale 2 -> 4 -> 8 -> 2, a good swap finalized, a
    bad swap; returns the event kinds in order."""
    x = _x(12)
    client.infer(input=x)
    for n in (4, 8, 2):
        fleet.scale_to(n)
        client.infer(input=x)
    assert fleet.swap_weights(mod.pack(files), label="good") == "committed"
    client.infer(input=x)
    fleet.finalize_swap()
    assert fleet.swap_weights(mod.pack(wrong), label="bad") == "rolled_back"
    client.infer(input=x)
    return [k for k, _ in fleet.events]


def test_fixed_schedule_event_kinds_equal_jax(chain_setup):
    prog, files, image = chain_setup
    wrong = rctc.gemm_chain_weights(DEPTH, N, seed=77)
    server, addr, client = _start(prog, image, mesh_groups=2)
    try:
        kinds = _schedule(server, client, FleetController(server), rimfs,
                          files, image, wrong)
    finally:
        client.close()
        server.stop()
    jserver = JaxInferenceServer(mesh=jax_rhal.TileMesh(2))
    jclient = JaxClient(jserver.start())
    try:
        jclient.provision(jax_rimfs.pack(files),
                          jax_rctc.compile_gemm_chain(DEPTH, N).encode())
        jkinds = _schedule(jserver, jclient,
                           jax_fleet.FleetController(jserver), jax_rimfs,
                           files, image, wrong)
    finally:
        jclient.close()
        jserver.stop()
    assert kinds == jkinds
    assert kinds == ["scale_started", "scale_complete"] * 3 + [
        "swap_started", "swap_probed", "swap_committed", "swap_finalized",
        "swap_started", "swap_probed", "swap_rolled_back"]
