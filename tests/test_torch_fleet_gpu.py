"""The fleet controller on the card: stream order at a flip, memory given
back on release, and a partial reshape that leaves the survivors alone.

These tests need a CUDA device and skip without one: the CPU has no
streams and no caching allocator to give memory back. On the machine with
the card:

    PYTHONPATH=src python -m pytest -q -s -m gpu tests/test_torch_fleet_gpu.py

(``chip_smoke.py`` runs them.) The file imports torch and the port only, so
it runs where JAX is absent.

* A prewarm whose uploads are still in flight on the device's default
  stream, not the groups' (slowed on purpose behind ``torch.cuda._sleep``,
  copied non-blocking from pinned memory), is flipped in at once: through
  ``scale_to`` the flip makes the groups' streams wait on the prewarm's
  events and the first request's bytes are right; the same flip done
  without the wait reads the buffers before their bytes land (the
  ``FLIP_ORDER`` line records both).
* ``torch.cuda.memory_allocated`` falls back to its pre-swap value, within
  1% of the image's pinned bytes, after ``finalize_swap``, ``rollback``,
  ``promote_canary`` and ``abort_canary`` (``SWAP_MEMORY``).
* ``replace_group`` moves no byte on a surviving group's DMA counters and
  uploads exactly the replaced stage's weights.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import rbl, rctc, rhal, rimfs
from repro_torch.core.executor import Executor
from repro_torch.core.fleet import FleetConfig, FleetController
from repro_torch.core.rhal import DmaTicket
from repro_torch.dtypes import to_host
from repro_torch.serving.server import Client, InferenceServer

SPIN = 2_000_000_000        # cycles of torch.cuda._sleep: ~1 s on an H100
DEPTH, N = 8, 1024          # 32 MiB of fp32 weights


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CPU has no streams")
    return torch.device("cuda")


def _chain(seed=0):
    return rctc.compile_gemm_chain(DEPTH, N), rimfs.pack(
        rctc.gemm_chain_weights(DEPTH, N, seed=seed))


def _x(seed):
    return np.random.RandomState(seed).randn(N, N).astype(np.float32)


def _ref(prog, image, x):
    ex = Executor()
    fs = rimfs.mount(image)
    out = to_host(ex.run(rbl.bind(prog, rimfs=fs, driver=ex.driver),
                         inputs={"input": x})["output"])
    fs.unpin_all()
    return out


def _serve(prog, image, groups=2):
    server = InferenceServer(mesh=rhal.TileMesh(groups))
    client = Client(server.start())
    client.provision(image, prog.encode())
    return server, client


def _late_uploads(mesh):
    """Every h2d upload of the mesh's groups lands late and off the groups'
    streams: on the device's default stream (the prewarming thread's own,
    outside any group's scope) the buffer is filled with NaN, the first
    upload spins ~1 s, and the real bytes follow as non-blocking copies
    from pinned memory; no CRC stamp reads them back."""
    spun = []
    for g in mesh.groups:
        drv = g.driver
        drv.integrity.enabled = False
        orig = drv.dma_async

        def late(host_buf, direction, prefetched=False, _orig=orig,
                 _drv=drv):
            if direction != "h2d":
                return _orig(host_buf, direction, prefetched=prefetched)
            src = torch.as_tensor(host_buf).pin_memory()
            with torch.cuda.stream(torch.cuda.default_stream(_drv.device)):
                buf = torch.full_like(src, float("nan"), device=_drv.device)
                if not spun:
                    torch.cuda._sleep(SPIN)
                    spun.append(True)
                buf.copy_(src, non_blocking=True)
            return DmaTicket(buf, "h2d", src.numel() * src.element_size(),
                             prefetched)

        drv.dma_async = late
        drv.dma_async_batch = lambda bufs, direction, prefetched=False, \
            _late=late: [_late(h, direction, prefetched) for h in bufs]


@pytest.mark.gpu
def test_flip_waits_for_the_prewarm_uploads(cuda):
    prog, image = _chain()
    x = _x(1)
    want = _ref(prog, image, x)
    server, client = _serve(prog, image)
    try:
        fleet = FleetController(server)
        assert np.array_equal(client.infer(input=x)["output"], want)
        # through the fleet: prewarm, flip (with the wait), first request
        mesh4 = rhal.TileMesh(4)
        _late_uploads(mesh4)
        fleet._mesh_cache[4] = mesh4
        torch.cuda.synchronize()
        fleet.scale_to(4)
        ordered = client.infer(input=x)["output"]
        # the same, flipped without the wait
        mesh8 = rhal.TileMesh(8)
        _late_uploads(mesh8)
        torch.cuda.synchronize()
        fleet._prewarm(mesh8)
        server.run_on_dispatcher(lambda: setattr(server, "mesh", mesh8))
        unordered = client.infer(input=x)["output"]
        torch.cuda.synchronize()
        after = client.infer(input=x)["output"]   # the bytes have landed
    finally:
        client.close()
        server.stop()
    print("FLIP_ORDER " + json.dumps({
        "ordered_read_equal": bool(np.array_equal(ordered, want)),
        "read_without_the_wait_equal": bool(np.array_equal(unordered, want)),
        "read_without_the_wait_nan": bool(np.isnan(unordered).any()),
        "later_read_equal": bool(np.array_equal(after, want))}))
    assert np.array_equal(ordered, want)
    assert not np.array_equal(unordered, want)   # the hazard is real
    assert np.array_equal(after, want)


@pytest.mark.gpu
def test_memory_falls_back_after_every_release(cuda):
    prog, image = _chain()
    _, wrong = _chain(seed=9)
    pinned = DEPTH * N * N * 4
    x = _x(2)
    want = _ref(prog, image, x)
    server, client = _serve(prog, image)
    # no straggler replacement in between: it would re-pin a stage
    fleet = FleetController(server, FleetConfig(
        probation_requests=2, probation_ticks=1, stage_straggler_ratio=1e9))
    seen: dict = {}

    def mem():
        # a freed block marked for another stream (record_stream) stays
        # counted until the allocator's next allocation processes its
        # events: one tiny allocation after the sync settles the count
        torch.cuda.synchronize()
        torch.empty(1, device="cuda")
        return torch.cuda.memory_allocated()

    def served():
        assert np.array_equal(client.infer(input=x)["output"], want)

    try:
        served()
        base = mem()
        # swap -> probation -> finalize
        assert fleet.swap_weights(image, label="good") == "committed"
        seen["swap_probation"] = mem() - base
        served()
        served()
        fleet.tick()
        assert not fleet.summary()["swap_in_probation"]
        seen["after_finalize"] = mem() - base
        base = mem()
        # swap -> rollback
        assert fleet.swap_weights(image, label="again") == "committed"
        seen["rollback_probation"] = mem() - base
        fleet.rollback(reason="test")
        served()
        seen["after_rollback"] = mem() - base
        # canary -> promote
        assert fleet.canary(image, fraction=1.0) == "started"
        seen["canary"] = mem() - base
        for _ in range(16):
            served()
        assert fleet.tick()["canary"]["state"] == "promote"
        seen["after_promote"] = mem() - base
        base = mem()
        # canary of wrong weights -> abort
        assert fleet.canary(wrong, fraction=1.0) == "started"
        for _ in range(6):
            served()
        assert fleet.tick()["canary"]["state"] == "abort"
        seen["after_abort"] = mem() - base
        # a probe that fails moves nothing into the mesh either
        assert fleet.swap_weights(wrong, label="bad") == "rolled_back"
        seen["after_bad_probe"] = mem() - base
        served()
    finally:
        client.close()
        server.stop()
    print("SWAP_MEMORY " + json.dumps({"pinned_bytes": pinned, **seen}))
    for key in ("swap_probation", "rollback_probation", "canary"):
        assert seen[key] >= pinned               # the new image was pinned
    for key in ("after_finalize", "after_rollback", "after_promote",
                "after_abort", "after_bad_probe"):
        assert abs(seen[key]) <= pinned // 100, (key, seen[key])


@pytest.mark.gpu
def test_replace_group_moves_no_survivor_bytes(cuda):
    prog, image = _chain()
    x = _x(3)
    want = _ref(prog, image, x)
    server, client = _serve(prog, image, groups=4)
    try:
        fleet = FleetController(server)
        assert np.array_equal(client.infer(input=x)["output"], want)
        mesh = server.mesh
        survivors = {g: mesh.group(g).driver for g in mesh.gids if g != 2}
        before = {g: dict(d.stats) for g, d in survivors.items()}
        mesh.kill(2)
        rep = fleet.tick()
        assert rep["action"] == ("replace", 2, "dead") and "error" not in rep
        for g, d in survivors.items():
            assert mesh.group(g).driver is d
            assert d.stats.get("dma_bytes", 0) == \
                before[g].get("dma_bytes", 0)
        fresh = mesh.group(2).driver
        fs = server.platform.rimfs
        tile = server._bound._partitions[4].tiles[2]
        assert fresh.stats["dma_bytes"] == sum(
            fs.stat(s)["nbytes"] for s in tile.weight_syms)
        assert np.array_equal(client.infer(input=x)["output"], want)
    finally:
        client.close()
        server.stop()
