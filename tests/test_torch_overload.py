"""The port's brown-out overload control plane on the CPU
(tests/test_overload.py's scenarios): the degradation ladder's walk with
hysteresis, typed shed verdicts on the wire, terminal verdicts that never
burn retries, retry-after hints, the LM decode clamp (its greedy stream
equal to the JAX server's) and the tile-group circuit breaker; and the
telemetry the ladder reads (``Telemetry.count``, windowed ``summary``,
``dma_summary``) against the JAX package's. The dispatcher is held on a
gate and the server's counters, never on sleeps."""
import functools
import threading
import time

import numpy as np
import pytest

from repro.core.rtpm import Telemetry as JaxTelemetry
from repro_torch.configs import get_config
from repro_torch.core import rctc, rhal, rimfs
from repro_torch.core.executor import Executor
from repro_torch.core import rbl
from repro_torch.core.rtpm import Telemetry
from repro_torch.models import transformer as tf
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.overload import (MAX_RUNG, RUNGS,
                                          BrownoutController, OverloadConfig)
from repro_torch.serving.server import (Client, InferenceServer, RequestShed,
                                        ServerBusy, _Work)

DEPTH, N = 6, 16


@pytest.fixture(scope="module")
def chain_setup():
    prog = rctc.compile_gemm_chain(DEPTH, N)
    files = rctc.gemm_chain_weights(DEPTH, N)
    return prog, files, rimfs.pack(files)


def _start(prog, image, mesh_groups=0, **kw):
    mesh = rhal.TileMesh(mesh_groups, device="cpu") if mesh_groups else None
    server = InferenceServer(device="cpu", mesh=mesh, **kw)
    addr = server.start()
    client = Client(addr)
    client.provision(image, prog.encode())
    return server, addr, client


def _x(seed=0):
    return np.random.RandomState(seed).randn(N, N).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ref(seed):
    prog = rctc.compile_gemm_chain(DEPTH, N)
    fs = rimfs.mount(rimfs.pack(rctc.gemm_chain_weights(DEPTH, N)))
    return Executor(device="cpu").run(
        rbl.bind(prog, rimfs=fs, inputs={"input": _x(seed)}))[
            "output"].numpy()


def _check(out, seed):
    np.testing.assert_array_equal(out["output"], _ref(seed))


def _heat(server, n, seconds=0.4):
    """Feed the dispatcher's queue-wait telemetry over-threshold samples
    (the ladder's pressure signal), deterministically."""
    for _ in range(n):
        server._loop.queue_wait.record_latency(seconds)


def _wedge_dispatcher(server):
    gate = threading.Event()
    entered = threading.Event()

    def ctl():
        entered.set()
        gate.wait(30)

    deadline = time.monotonic() + 5
    while not server._loop.submit(
            _Work(frame=None, route=None, control=ctl)):
        assert time.monotonic() < deadline, "dispatch queue never drained"
        time.sleep(0.01)
    assert entered.wait(5)
    return gate


def _wait_rejected(server, r0, n, timeout=10.0):
    """Until ``n`` refusals past ``r0`` are on the server's counter."""
    deadline = time.monotonic() + timeout
    while server._loop.stats["rejected"] - r0 < n:
        assert time.monotonic() < deadline
        time.sleep(0.005)


# ----------------------------------------------------------------- ladder
def test_ladder_walks_down_and_back_with_hysteresis(chain_setup):
    prog, files, image = chain_setup
    server, addr, client = _start(prog, image)
    try:
        saved_window = server.batch_window
        cfg = OverloadConfig(p99_high=0.1, min_window=2, escalate_ticks=2,
                             recover_ticks=2, max_new_clamp=4,
                             shed_priority=2)
        over = BrownoutController(server, cfg)
        rungs = []
        for _ in range(2 * MAX_RUNG):
            _heat(server, cfg.min_window, 0.4)
            over.tick()
            rungs.append(over.rung)
        assert rungs[0] == 0 and rungs[1] == 1   # hysteresis held tick 1
        assert over.rung == MAX_RUNG
        assert server.batch_window == 1
        assert server.max_new_clamp == cfg.max_new_clamp
        assert server.scheduler.priority_ceiling == cfg.shed_priority
        assert over.breaker.state == "closed"    # no failing group
        over.tick()
        assert over.rung == MAX_RUNG             # one cool tick holds
        for _ in range(2 * MAX_RUNG + 2):
            over.tick()
        assert over.rung == 0
        assert server.batch_window == saved_window
        assert server.max_new_clamp is None
        assert server.scheduler.priority_ceiling is None
        moves = [(p["from"], p["to"]) for k, p in over.events
                 if k == "brownout_rung"]
        assert moves[:4] == [(0, 1), (1, 2), (2, 3), (3, 4)]
        assert moves[-1] == (1, 0)
        assert [p["name"] for k, p in over.events
                if k == "brownout_rung"][:4] == [r[1] for r in RUNGS[1:]]
        assert over.summary()["name"] == "normal"
    finally:
        client.close()
        server.stop()


# ----------------------------------------------------------- typed sheds
def test_rung3_sheds_low_priority_with_typed_verdict(chain_setup):
    prog, files, image = chain_setup
    server, addr, client = _start(prog, image)
    try:
        over = BrownoutController(server, OverloadConfig(shed_priority=2))
        x = _x(1)
        _check(client.infer(input=x), 1)
        over.set_rung(3, reason="test")
        with pytest.raises(RequestShed) as ei:
            client.infer(input=x, priority=5)
        e = ei.value
        assert e.kind == "brownout"
        assert e.retryable is True
        assert e.retry_after_ms >= 1
        _check(client.infer(input=x), 1)          # priority 1: still served
        over.tick()                               # honest accounting
        shed_n = sum(p["n"] for k, p in over.events
                     if k == "brownout_shed")
        assert shed_n == 1
        over.set_rung(0, reason="test")
        _check(client.infer(input=x, priority=5), 1)  # capacity returned
    finally:
        client.close()
        server.stop()


def test_infeasible_deadline_is_terminal_never_retried(chain_setup):
    prog, files, image = chain_setup
    server, addr, client = _start(prog, image)
    try:
        cl = Client(addr, retries=5, backoff=0.01)
        with pytest.raises(RequestShed) as ei:
            cl.infer(input=_x(2), deadline_ms=0.0)
        e = ei.value
        assert e.kind == "infeasible"
        assert e.retryable is False
        assert e.retry_after_ms == 0
        assert cl.retry_stats["retries"] == 0
        cl.close()
    finally:
        client.close()
        server.stop()


def test_client_honors_retry_after_hint(chain_setup):
    """Busy refusals carry a retry_after_ms hint; a retrying client sleeps
    at least that long and counts every honored hint. Six clients meet a
    cap of four, released once the server has refused one of them."""
    prog, files, image = chain_setup
    server, addr, client = _start(prog, image, max_queue=4)
    try:
        x = _x(3)
        _check(client.infer(input=x), 3)
        stats = server._loop.stats
        gate = _wedge_dispatcher(server)
        plain = Client(addr)
        try:
            r0 = stats["rejected"]
            rids = [plain.infer_async(input=x) for _ in range(10)]
            deadline = time.monotonic() + 10   # queued or refused: all 10
            while server.scheduler.pending() + stats["rejected"] - r0 < 10:
                assert time.monotonic() < deadline
                time.sleep(0.005)
        finally:
            gate.set()
        hints, served = [], 0
        for rid in rids:
            try:
                _check(plain.result(rid, timeout=60), 3)
                served += 1
            except ServerBusy as e:
                assert e.kind == "busy" and e.retryable is True
                hints.append(e.retry_after_ms)
        assert hints and all(h >= 1 for h in hints)
        assert served + len(hints) == 10
        plain.close()

        gate = _wedge_dispatcher(server)
        r0 = stats["rejected"]
        results, errors, cstats = [], [], []
        lock = threading.Lock()

        def worker(cid):
            cl = Client(addr, retries=20, backoff=0.01, retry_seed=cid)
            try:
                for _ in range(4):
                    out = cl.infer(input=x, timeout=60)
                    with lock:
                        results.append(out)
                with lock:
                    cstats.append(dict(cl.retry_stats))
            except Exception as e:          # pragma: no cover
                errors.append(e)
            finally:
                cl.close()

        threads = [threading.Thread(target=worker, args=(c,))
                   for c in range(6)]
        for t in threads:
            t.start()
        try:
            _wait_rejected(server, r0, 1, timeout=30)
        finally:
            gate.set()
        for t in threads:
            t.join(timeout=60)
        assert not errors and len(results) == 24
        for out in results:
            _check(out, 3)
        assert sum(s["busy"] for s in cstats) > 0
        for s in cstats:
            assert s["hinted"] == s["busy"]
    finally:
        client.close()
        server.stop()


# ---------------------------------------------------------------- LM path
@functools.lru_cache(maxsize=None)
def _lm_params():
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models import transformer as jax_tf
    from repro.models.common import init_params as jax_init_params
    jcfg = jax_get_config("qwen2-1.5b-smoke")
    jp = jax_init_params(jax.random.PRNGKey(0), jax_tf.model_specs(jcfg))
    return jcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


def _lm_server(jax_side: bool, **over_kw):
    jcfg, jp, np_params = _lm_params()
    if jax_side:
        from repro.serving.engine import ServingEngine as JaxEngine
        from repro.serving.overload import BrownoutController as JaxBrownout
        from repro.serving.overload import OverloadConfig as JaxOverload
        from repro.serving.server import Client as JaxClient
        from repro.serving.server import InferenceServer as JaxServer
        server = JaxServer(engine=JaxEngine(jcfg, jp, max_batch=2,
                                            max_seq=64))
        client = JaxClient(server.start())
        over = JaxBrownout(server, JaxOverload(**over_kw))
    else:
        cfg = get_config("qwen2-1.5b-smoke")
        eng = ServingEngine(cfg, tf.params_from_jax(np_params, device="cpu"),
                            max_batch=2, max_seq=64, device="cpu")
        server = InferenceServer(device="cpu", engine=eng)
        client = Client(server.start())
        over = BrownoutController(server, OverloadConfig(**over_kw))
    prompt = np.random.RandomState(0).randint(
        0, jcfg.vocab_size, (6,)).astype(np.int32)
    return server, client, over, prompt


def _clamp_walk(jax_side: bool) -> tuple:
    server, client, over, prompt = _lm_server(jax_side, max_new_clamp=2)
    try:
        full = list(client.infer(prompt=prompt, max_new=6)["tokens"])
        short = list(client.infer(prompt=prompt, max_new=2)["tokens"])
        over.set_rung(2, reason="test")
        clamped = list(client.infer(prompt=prompt, max_new=6)["tokens"])
        over.set_rung(0, reason="test")
        again = list(client.infer(prompt=prompt, max_new=6)["tokens"])
    finally:
        client.close()
        server.stop()
    return [int(t) for t in full], [int(t) for t in short], \
        [int(t) for t in clamped], [int(t) for t in again]


def test_rung2_clamps_lm_decode_budget():
    """At rung 2 LM admissions get max_new clamped: the same request yields
    a greedy PREFIX of the full answer, never a different one; recovery
    restores the full budget. Every stream equals the JAX server's."""
    full, short, clamped, again = _clamp_walk(jax_side=False)
    assert len(short) < len(full)
    assert clamped == short == full[:len(short)]
    assert again == full
    assert (full, short, clamped, again) == _clamp_walk(jax_side=True)


def test_lm_brownout_shed_is_typed_and_idempotent_retryable():
    """The engine path sheds with the same typed verdicts; a request
    refused at admission sampled zero tokens, so it is retryable."""
    server, client, over, prompt = _lm_server(False, shed_priority=2)
    try:
        ref = list(client.infer(prompt=prompt, max_new=3)["tokens"])
        over.set_rung(3, reason="test")
        with pytest.raises(RequestShed) as ei:
            client.infer(prompt=prompt, max_new=3, priority=5)
        e = ei.value
        assert e.kind == "brownout"
        assert e.retryable is True
        assert e.retry_after_ms >= 1
        assert list(client.infer(prompt=prompt, max_new=3)["tokens"]) == ref
        over.set_rung(0, reason="test")
    finally:
        client.close()
        server.stop()


# -------------------------------------------------------- circuit breaker
def test_circuit_breaker_trips_probes_and_closes(chain_setup):
    """Rung 4 circuit-breaks the worst FAILING group: the kill rides the
    quarantine path (failover serves bit-identical), the half-open probe
    golden-checks the revived group against the survivors' answer, and
    only a bit-identical probe closes the circuit."""
    prog, files, image = chain_setup
    server, addr, client = _start(prog, image, mesh_groups=2)
    try:
        over = BrownoutController(server, OverloadConfig(
            breaker_cooldown_ticks=1, recover_ticks=100))
        x = _x(5)
        _check(client.infer(input=x), 5)
        mesh = server.mesh
        server.platform.post("tile_failure", {"group": 1})
        server.platform.post("tile_failure", {"group": 1})
        rep = over.set_rung(4, reason="test")
        assert rep["tripped"] == 1
        assert over.breaker.state == "open"
        assert not mesh.alive(1)
        assert mesh.group(1).driver.arena.poisoned
        _check(client.infer(input=x), 5)         # quarantined: failover
        over.tick()                              # cooldown over: the probe
        assert over.breaker.state == "closed"
        assert mesh.alive(1) and not mesh.group(1).driver.arena.poisoned
        kinds = [k for k, _ in over.events]
        assert "circuit_open" in kinds and "circuit_closed" in kinds
        assert over.breaker.stats == {"trips": 1, "probes": 1, "closes": 1}
        _check(client.infer(input=x), 5)         # full mesh in rotation
        over.set_rung(0, reason="test")
    finally:
        client.close()
        server.stop()


# ------------------------------------------------------------- telemetry
def test_telemetry_count_window_and_dma_summary_equal_jax(rng):
    port, ref = Telemetry(), JaxTelemetry()
    seen = 0
    for n in (1, 5, 0, 17, 3):
        xs = rng.rand(n).tolist()
        for x in xs:
            port.record_latency(x)
            ref.record_latency(x)
        assert port.count() == ref.count()
        assert port.summary(warmup=seen) == ref.summary(warmup=seen)
        seen = port.count()
        moved, over = int(rng.randint(1, 1 << 20)), int(rng.randint(0, 99))
        port.record_dma(moved, over)
        ref.record_dma(moved, over)
        assert port.dma_summary() == ref.dma_summary()
    assert Telemetry().dma_summary() == JaxTelemetry().dma_summary()
