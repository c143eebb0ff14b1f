"""Tile groups in the port on the CPU, held against the JAX package.

The small RCTC compilers' bytes (and the GEMM chain's weight image); stage
failover under a ``Platform`` at the first, middle and last stage, run
through the same scenario in both packages (tests/test_rtpm.py:275-340):
the same events, heartbeat verdicts, counters and outputs; all groups dead;
``register_silent``; ``handle_failures`` and ``time_to_service``; the
integrity plane (tests/test_integrity.py:91-120, :354): a kill quarantines
the arena and revive re-validates it, a corrupted resident weight keeps it
quarantined, a corrupted cut-edge payload is retried in place; the server
over a ``TileMesh`` (tests/test_serving_concurrency.py:430, :545, :705):
equal to a single-driver server, no coalescing, the watchdog's kill of a
hung group answered bit-identically; the engines from a mesh
(tests/test_serving.py:223, tests/test_paged_engine.py:137); and the entry
point's default device. The dispatcher is held on events, never on sleeps.
"""
import dataclasses
import functools
import threading
import time

import numpy as np
import pytest
import torch

import jax

from repro.core import rbl as jax_rbl
from repro.core import rctc as jax_rctc
from repro.core import rhal as jax_rhal
from repro.core import rimfs as jax_rimfs
from repro.core.executor import Executor as JaxExecutor
from repro.core.rtpm import HeartbeatMonitor as JaxHeartbeatMonitor
from repro.core.rtpm import Platform as JaxPlatform
from repro_torch.configs import get_config
from repro_torch.configs.resnet18 import CONFIG as RESNET
from repro_torch.core import rbl, rctc, rhal, rimfs
from repro_torch.core.executor import Executor
from repro_torch.core.integrity import IntegrityError
from repro_torch.core.rtpm import HeartbeatMonitor, Platform
from repro_torch.models import resnet as rn
from repro_torch.models import transformer as tf
from repro_torch.serving.engine import (Request, ServingEngine,
                                        pack_params_image)
from repro_torch.serving.paged_engine import PagedServingEngine
from repro_torch.serving.server import Client, InferenceServer

OP_ATOL = 1e-5                     # fp32 ops: tests/test_torch_oplib.py


# ---------------------------------------------------------------------------
# The small compilers: the JAX package's bytes
# ---------------------------------------------------------------------------

SMALL_PROGRAMS = {
    "passthrough": lambda m: m.compile_passthrough((4, 8)),
    "passthrough_bf16": lambda m: m.compile_passthrough((16,), "bfloat16"),
    "transfer_chain": lambda m: m.compile_transfer_chain(3, (8, 8)),
    "matmul": lambda m: m.compile_matmul(64),
    "matmul_dma": lambda m: m.compile_matmul(16, with_dma=True),
    "dma_pipeline": lambda m: m.compile_dma_pipeline(3, 16),
    "dma_pipeline_nodma": lambda m: m.compile_dma_pipeline(2, 8,
                                                           with_dma=False),
    "transfer_pipeline": lambda m: m.compile_transfer_pipeline(4, 40),
    "gemm_chain": lambda m: m.compile_gemm_chain(6, 8),
}


@pytest.mark.parametrize("name", sorted(SMALL_PROGRAMS))
def test_small_compilers_emit_the_jax_bytes(name):
    make = SMALL_PROGRAMS[name]
    assert make(rctc).encode() == make(jax_rctc).encode()


@pytest.mark.parametrize("depth,n,seed", [(5, 16, 0), (3, 8, 4)])
def test_gemm_chain_weights_pack_the_jax_image(depth, n, seed):
    files = rctc.gemm_chain_weights(depth, n, seed)
    jfiles = jax_rctc.gemm_chain_weights(depth, n, seed)
    assert rimfs.pack(files) == jax_rimfs.pack(jfiles)


# ---------------------------------------------------------------------------
# Failover under a Platform, the same scenario in both packages
# ---------------------------------------------------------------------------

def _chain(depth=4, n=16, seed=0):
    prog = rctc.compile_gemm_chain(depth, n)
    files = rctc.gemm_chain_weights(depth, n)
    x = np.random.RandomState(seed).randn(n, n).astype(np.float32)
    return prog, files, x


def _scenario(pkg, n_groups, victim, depth=4):
    """Run the GEMM chain partitioned over ``n_groups`` under a Platform
    with a fake clock, killing group ``victim`` before its stage: before
    the run for group 0, else on the ``stage_complete`` of the stage just
    before it (past the 5 s heartbeat deadline). Returns the outputs as
    numpy, the event log, the heartbeat flags, the counters and the mesh."""
    prog, files, x = _chain(depth)
    t = {"now": 0.0}
    if pkg == "jax":
        plat = JaxPlatform(deadline=5.0, clock=lambda: t["now"])
        mesh = jax_rhal.TileMesh(n_groups)
        fs = jax_rimfs.mount(jax_rimfs.pack(files))
        bound = jax_rbl.bind(jax_rctc.compile_gemm_chain(depth, 16),
                             rimfs=fs, inputs={"input": x})
    else:
        plat = Platform(deadline=5.0, clock=lambda: t["now"], device="cpu")
        mesh = rhal.TileMesh(n_groups, device="cpu")
        fs = rimfs.mount(rimfs.pack(files))
        bound = rbl.bind(prog, rimfs=fs, inputs={"input": x})
    log = []
    for kind in ("worker_failed", "stage_requeued", "tile_failure"):
        plat.events.register(kind, lambda p, k=kind: log.append((k, dict(p))))

    def on_stage(p):
        log.append(("stage_complete", {"stage": p["stage"],
                                       "group": p["group"]}))
        if p["stage"] == victim - 1:
            mesh.kill(victim)
            t["now"] += 10.0
    plat.events.register("stage_complete", on_stage)
    if victim == 0:
        mesh.kill(0)
        t["now"] = 10.0
    out = plat.run_partitioned(bound, mesh=mesh, rimfs=fs)
    alive = {w: s.alive for w, s in plat.heartbeats.workers.items()}
    counters = {k: plat.telemetry.counter(k)
                for k in ("tile_failures", "rimfs_fscks")}
    return {k: np.asarray(v) for k, v in out.items()}, log, alive, \
        counters, mesh


@pytest.mark.parametrize("victim", [0, 1, 2], ids=["first", "middle", "last"])
def test_stage_failover_like_jax(victim):
    out, log, alive, counters, mesh = _scenario("port", 3, victim)
    jout, jlog, jalive, jcounters, _ = _scenario("jax", 3, victim)
    assert log == jlog
    assert alive == jalive and alive[f"tile{victim}"] is False
    assert counters == jcounters and counters["tile_failures"] == 1
    requeued = [p for k, p in log if k == "stage_requeued"]
    assert requeued and requeued[0]["from"] == victim
    assert any(f"tile{victim}" in p["workers"] for k, p in log
               if k == "worker_failed")
    prog, files, x = _chain()
    ex = Executor(device="cpu")
    ref = ex.run(rbl.bind(prog, rimfs=rimfs.mount(rimfs.pack(files)),
                          inputs={"input": x}, driver=ex.driver))
    np.testing.assert_array_equal(out["output"], ref["output"].numpy())
    np.testing.assert_allclose(out["output"], jout["output"], rtol=0,
                               atol=OP_ATOL)
    assert mesh.group(victim).driver.arena.poisoned
    with pytest.raises(rhal.TileFailure, match="quarantined"):
        mesh.group(victim).driver.arena.alloc(128)


def test_all_tiles_dead_raises():
    prog, files, x = _chain(depth=2)
    fs = rimfs.mount(rimfs.pack(files))
    mesh = rhal.TileMesh(2, device="cpu")
    mesh.kill(0)
    mesh.kill(1)
    with pytest.raises(rhal.TileFailure):
        Executor(device="cpu").run_partitioned(
            rbl.bind(prog, rimfs=fs, inputs={"input": x}), rimfs=fs,
            mesh=mesh)
    with pytest.raises(rhal.TileFailure, match="no live tile group"):
        mesh.primary


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_register_silent_fails_at_the_next_check(pkg):
    t = {"now": 100.0}
    cls = HeartbeatMonitor if pkg == "port" else JaxHeartbeatMonitor
    hb = cls(deadline=5.0, clock=lambda: t["now"])
    hb.beat("tile0", 0)
    hb.register_silent("tile1")
    hb.register_silent("tile0")          # a beating worker stays beating
    verdict = hb.check()
    assert verdict["failed"] == ["tile1"]
    assert verdict["verdicts"] == {"tile0": "ok", "tile1": "failed"}
    hb.beat("tile1", 3)                  # a revived worker is alive again
    assert hb.check()["verdicts"]["tile1"] == "ok"


def _failures(pkg):
    t = {"now": 0.0}
    prog, files, x = _chain(depth=2)
    if pkg == "port":
        plat = Platform(deadline=5.0, clock=lambda: t["now"], device="cpu")
        bound = rbl.bind(prog, rimfs=rimfs.mount(rimfs.pack(files)))
    else:
        plat = JaxPlatform(deadline=5.0, clock=lambda: t["now"])
        bound = jax_rbl.bind(jax_rctc.compile_gemm_chain(2, 16),
                             rimfs=jax_rimfs.mount(jax_rimfs.pack(files)))
    events, shrunk = [], []
    plat.events.register("worker_failed", events.append)
    for w in ("w0", "w1", "w2"):
        plat.heartbeats.beat(w, 1)
    first = plat.handle_failures(bound, on_shrink=shrunk.append)
    t["now"] = 3.0
    plat.heartbeats.beat("w0", 2)
    plat.heartbeats.beat("w2", 2)
    t["now"] = 6.0
    second = plat.handle_failures(bound, on_shrink=shrunk.append)
    return first, second, events, shrunk


def test_handle_failures_like_jax():
    got, want = _failures("port"), _failures("jax")
    assert got == want
    first, second, events, shrunk = got
    assert first["failed"] == [] and second["failed"] == ["w1"]
    assert events == [{"workers": ["w1"]}] and shrunk == [["w1"]]


def test_time_to_service():
    plat = Platform(device="cpu")
    with pytest.raises(RuntimeError, match="provision"):
        plat.time_to_service()
    prog, files, _ = _chain(depth=2)
    plat.provision(image=rimfs.pack(files), program_bytes=prog.encode())
    first = plat.time_to_service()
    assert first > 0
    plat.provision(image=rimfs.pack(files), program_bytes=prog.encode())
    assert plat.time_to_service() >= first


def test_tile_mesh_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="CUDA requested"):
        rhal.TileMesh(2)
    # a run without a mesh builds one on the executor's device
    prog, files, x = _chain(depth=2)
    fs = rimfs.mount(rimfs.pack(files))
    ex = Executor(device="cpu")
    bound = rbl.bind(prog, rimfs=fs, inputs={"input": x}, driver=ex.driver)
    assert torch.equal(ex.run_partitioned(bound, rimfs=fs)["output"],
                       ex.run(bound)["output"])


def test_mesh_groups_split_the_arena():
    mesh = rhal.TileMesh(4, device="cpu")
    assert [g.gid for g in mesh.groups] == [0, 1, 2, 3]
    caps = {g.driver.arena.capacity for g in mesh.groups}
    assert caps == {rhal.DEFAULT_ARENA_BYTES // 4}
    assert all(g.driver.stream is None for g in mesh.groups)   # the CPU
    assert len({id(g.driver) for g in mesh.groups}) == 4
    fresh = mesh.spawn_replacement(2)
    assert fresh.gid == 2 and fresh.driver is not mesh.group(2).driver
    old = mesh.install_group(fresh)
    assert mesh.group(2) is fresh and old.gid == 2
    with pytest.raises(ValueError):
        mesh.install_group(rhal.TileGroup(7, fresh.driver))


# ---------------------------------------------------------------------------
# The integrity plane over a mesh
# ---------------------------------------------------------------------------

def test_kill_quarantines_arena_and_revive_revalidates(rng):
    mesh = rhal.TileMesh(2, device="cpu")
    fs = rimfs.mount(rimfs.pack({"w": rng.randn(8, 8).astype(np.float32)}))
    ri = fs.resident(mesh.group(0).driver)
    ((offset, nbytes),) = ri.pinned_ranges()
    assert nbytes == 256 and offset % rhal.ARENA_ALIGN == 0
    mesh.kill(0)
    arena = mesh.group(0).driver.arena
    assert arena.poisoned and not mesh.alive(0)
    with pytest.raises(rhal.TileFailure, match="quarantined"):
        arena.alloc(128)
    with pytest.raises(rhal.TileFailure, match="is down"):
        mesh.group(0).driver.fence([])
    assert mesh.primary is mesh.group(1).driver
    mesh.revive(0, rimfs=fs)                 # CRC-clean: quarantine lifts
    assert not arena.poisoned and mesh.alive(0)
    assert arena.alloc(128) >= 0
    assert mesh.primary is mesh.group(0).driver


def test_revive_rejects_corrupted_residency(rng):
    mesh = rhal.TileMesh(1, device="cpu")
    fs = rimfs.mount(rimfs.pack({"w": rng.randn(8, 8).astype(np.float32)}))
    ri = fs.resident(mesh.group(0).driver)
    mesh.kill(0)
    ri.buffer("w").view(torch.int32).view(-1)[3] ^= 0x40   # half-written
    with pytest.raises(IntegrityError, match="re-validation") as err:
        mesh.revive(0, rimfs=fs)
    assert err.value.kind == "residency_crc"
    assert mesh.group(0).driver.arena.poisoned    # still quarantined
    assert not mesh.alive(0)


def _corrupt_dma_payload(mesh, gid, count):
    """Flip one bit of the delivered payload of the next ``count``
    CRC-stamped transfers landing on group ``gid``; the ticket's CRC and
    retained source were stamped from the clean bytes inside the real
    issue, so redemption re-issues from the source. Returns (undo,
    state)."""
    driver = mesh.group(gid).driver
    orig = driver.dma_async
    state = {"corrupted": 0}

    def corrupting(host_buf, direction, prefetched=False):
        ticket = orig(host_buf, direction, prefetched=prefetched)
        if state["corrupted"] < count and ticket.crc is not None:
            bad = ticket.buf.clone()          # the producer's stays clean
            bad.view(torch.uint8).view(-1)[0] ^= 0x01
            ticket.buf = bad
            state["corrupted"] += 1
        return ticket

    driver.dma_async = corrupting
    return (lambda: setattr(driver, "dma_async", orig)), state


def test_partitioned_corruption_recovers_bit_identical(rng):
    prog, files, x = _chain()
    fs = rimfs.mount(rimfs.pack(files))
    ref = Executor(device="cpu").run(rbl.bind(prog, rimfs=fs,
                                              inputs={"input": x}))
    plat = Platform(device="cpu")
    mesh = rhal.TileMesh(2, device="cpu")
    undo, state = _corrupt_dma_payload(mesh, 1, count=2)
    try:
        out = plat.run_partitioned(rbl.bind(prog, rimfs=fs,
                                            inputs={"input": x}),
                                   mesh=mesh, rimfs=fs)
    finally:
        undo()
    assert state["corrupted"] == 1            # one cut edge into group 1
    assert torch.equal(out["output"], ref["output"])
    drv = mesh.group(1).driver
    assert drv.stats["dma_retry_recovered"] == state["corrupted"]
    assert plat.telemetry.counter("dma_retries") >= 1
    assert plat.telemetry.counter("integrity_errors") >= 1
    # the same bytes through the JAX package's mesh
    jfs = jax_rimfs.mount(jax_rimfs.pack(files))
    jout = JaxExecutor().run_partitioned(
        jax_rbl.bind(jax_rctc.compile_gemm_chain(4, 16), rimfs=jfs,
                     inputs={"input": x}), rimfs=jfs,
        mesh=jax_rhal.TileMesh(2))
    np.testing.assert_allclose(out["output"].numpy(),
                               np.asarray(jout["output"]), rtol=0,
                               atol=OP_ATOL)


# ---------------------------------------------------------------------------
# The server over a mesh
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _resnet():
    cfg = RESNET.smoke()
    folded = rn.fold_bn(rn.init_resnet(cfg, 0, device="cpu"))
    prog, image = rctc.compile_resnet18(cfg, folded, batch=1)
    return cfg, prog.encode(), image


def _image(cfg, seed):
    return np.random.RandomState(seed).rand(
        1, cfg.image_size, cfg.image_size, 3).astype(np.float32)


def _start(prog_bytes, image, **kw):
    server = InferenceServer(device="cpu", **kw)
    client = Client(server.start())
    assert client.provision(image, prog_bytes) == {"status": "ready"}
    return server, client


def _gate_dispatcher(server):
    """Hold the dispatcher at its next item (and keep the idle hook from
    draining around the gate); returns (gate, started)."""
    gate, started = threading.Event(), threading.Event()

    def install():
        # on the dispatcher thread, between items: no call of the old idle
        # hook is under way, so none can admit a request around the gate
        inner, idle = server._loop.handler, server._loop.on_idle

        def gated(item):
            started.set()
            gate.wait(30)
            inner(item)

        server._loop.handler = gated
        server._loop.on_idle = lambda: idle() if gate.is_set() else False

    server.run_on_dispatcher(install)
    return gate, started


def test_server_over_a_mesh_equals_a_single_driver_server():
    cfg, prog_bytes, image = _resnet()
    mesh = rhal.TileMesh(2, device="cpu")
    server, client = _start(prog_bytes, image, mesh=mesh)
    single, sclient = _start(prog_bytes, image)
    try:
        for seed in (13, 14):
            x = _image(cfg, seed)
            np.testing.assert_array_equal(client.infer(input=x)["output"],
                                          sclient.infer(input=x)["output"])
        assert mesh.moved_bytes() > 0            # cut edges streamed
        # the program bound to host views: only the groups pinned weights
        assert server.platform.driver.stats.get("dma_bytes", 0) == 0
    finally:
        client.close()
        sclient.close()
        server.stop()
        single.stop()


def test_no_coalescing_over_a_mesh():
    """A held burst of 3 on a batchable program dispatches one at a time
    over a mesh (the same burst coalesces without one)."""
    cfg, prog_bytes, image = _resnet()
    xs = [_image(cfg, 60 + i) for i in range(3)]
    counts = {}
    for label, kw in (("mesh", {"mesh": rhal.TileMesh(2, device="cpu")}),
                      ("single", {})):
        server, client = _start(prog_bytes, image, max_queue=32, **kw)
        try:
            refs = [client.infer(input=x)["output"] for x in xs]
            gate, started = _gate_dispatcher(server)
            rids = [client.infer_async(input=x) for x in xs]
            assert started.wait(10)
            # the handler threads queue all three before the gate opens
            deadline = time.monotonic() + 10
            while (server.scheduler.pending() < len(xs)
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            assert server.scheduler.pending() == len(xs)
            gate.set()
            for rid, ref in zip(rids, refs):
                np.testing.assert_array_equal(
                    client.result(rid, timeout=60)["output"], ref)
            counts[label] = dict(server.batched_stats)
            assert server._coalescible() == (label == "single")
        finally:
            client.close()
            server.stop()
    assert counts["mesh"]["dispatches"] == 0
    assert counts["single"]["dispatches"] == 1
    assert counts["single"]["requests"] == 3


def test_watchdog_kills_a_hung_group_and_the_stage_fails_over(rng):
    """A dispatch wedged in a DMA redemption blows its EWMA deadline; the
    watchdog kills the hung group (quarantining its arena), its stage
    fails over to the survivor and the client gets the bit-identical
    answer."""
    prog = rctc.compile_gemm_chain(4, 16)
    image = rimfs.pack(rctc.gemm_chain_weights(4, 16))
    mesh = rhal.TileMesh(2, device="cpu")
    server = InferenceServer(device="cpu", mesh=mesh, watchdog_floor=0.3,
                             watchdog_slack=8.0, watchdog_poll=0.01)
    client = Client(server.start())
    killed = threading.Event()
    kill = mesh.kill

    def kill_and_signal(gid):
        kill(gid)
        killed.set()
    mesh.kill = kill_and_signal
    group = mesh.group(1)
    orig = group.driver.dma_wait
    state = {"hung": 0, "released": False}

    def hang(ticket):
        # a wedged endpoint: the first redemption blocks until the group
        # is killed, then the guarded slot raises TileFailure
        if not state["hung"]:
            state["hung"] = 1
            state["released"] = killed.wait(30)
        return orig(ticket)
    try:
        client.provision(image, prog.encode())
        x = rng.randn(16, 16).astype(np.float32)
        ref = client.infer(input=x)          # warms the scheduler EWMA
        group.driver.dma_wait = hang
        out = client.infer(input=x, timeout=60)
        assert state["released"]             # the kill broke the wedge
        np.testing.assert_array_equal(out["output"], ref["output"])
        assert server.platform.telemetry.counter(
            "watchdog_preemptions") >= 1
        assert server.platform.telemetry.counter("tile_failures") >= 1
        assert not mesh.alive(1)
        assert mesh.group(1).driver.arena.poisoned
    finally:
        group.driver.dma_wait = orig
        client.close()
        server.stop()


# ---------------------------------------------------------------------------
# The engines from a mesh
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lm():
    cfg = dataclasses.replace(get_config("qwen2-1.5b-smoke"),
                              dtype="float32")
    params = tf.init_params(cfg, 0, device="cpu")
    return cfg, params, pack_params_image(params)


def _tokens(eng, prompt, max_new):
    req = Request(rid=0, prompt=prompt, max_new=max_new)
    eng.submit(req)
    eng.run_until_drained()
    return req.out_tokens


def test_engine_from_a_mesh(rng):
    cfg, params, image = _lm()
    fs = rimfs.mount(image)
    mesh = rhal.TileMesh(2, device="cpu")
    eng_m = ServingEngine.from_rimfs(cfg, fs, driver=mesh, max_batch=2,
                                     max_seq=64, device="cpu")
    assert eng_m.mesh is mesh
    primary = mesh.primary
    uploaded = primary.stats.get("dma_bytes", 0)
    assert uploaded > 0                       # pinned in group 0's arena
    assert mesh.group(1).driver.stats.get("dma_bytes", 0) == 0
    ServingEngine.from_rimfs(cfg, fs, driver=mesh, max_batch=2, max_seq=64,
                             device="cpu")
    assert primary.stats.get("dma_bytes", 0) == uploaded   # zero re-upload
    eng_d = ServingEngine.from_rimfs(cfg, fs,
                                     driver=rhal.make_eager_driver("cpu"),
                                     max_batch=2, max_seq=64, device="cpu")
    assert eng_d.mesh is None
    prompt = rng.randint(0, cfg.vocab_size, (6,)).astype(np.int32)
    assert _tokens(eng_m, prompt, 3) == _tokens(eng_d, prompt, 3)


def test_paged_engine_from_a_mesh(rng):
    cfg, params, image = _lm()
    fs = rimfs.mount(image)
    mesh = rhal.TileMesh(2, device="cpu")
    base = mesh.primary.arena.bytes_in_use
    eng_m = PagedServingEngine.from_rimfs(cfg, fs, driver=mesh, max_batch=2,
                                          max_seq=64, block_size=8,
                                          device="cpu")
    assert eng_m.mesh is mesh and eng_m.driver is mesh.primary
    # the weights and the pool both sit in the primary group's arena
    assert mesh.primary.arena.bytes_in_use >= base + eng_m.cache.pool_bytes()
    eng_d = PagedServingEngine(cfg, params, max_batch=2, max_seq=64,
                               block_size=8, device="cpu")
    p = rng.randint(0, cfg.vocab_size, (6,)).astype(np.int32)
    assert _tokens(eng_m, p, 4) == _tokens(eng_d, p, 4)
    with_pool = mesh.primary.arena.bytes_in_use
    eng_m.close()
    assert mesh.primary.arena.bytes_in_use == \
        with_pool - eng_m.cache.pool_bytes()
