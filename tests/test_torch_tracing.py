"""Spans of the LM serving path: ``Telemetry`` with ``tracing`` on records
each request's life (``server.queue``, ``engine.wait``, ``engine.slot``,
``engine.admit``) on ``Telemetry.clock``, and mirrors the host work into
``torch.profiler`` (``engine.admit`` around ``engine.prefill`` /
``engine.splice`` / ``engine.sample``, each decode step's
``engine.decode`` and ``engine.sample``, ``server.reply``); with it off,
no span site reads the clock or records anything. A few prompts of the
smoke config through ``InferenceServer`` and ``Client`` on the CPU."""
import functools
import itertools
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.rtpm import Telemetry
from repro_torch.models import transformer as tf
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.server import Client, InferenceServer

CFG = "mistral-nemo-12b-smoke"
MAX_BATCH = 2
PROMPTS = (7, 12, 5, 9)             # prompt lengths, two more than the slots
MAX_NEW = (3, 5, 2, 4)
KEYED = ("server.queue", "engine.wait", "engine.slot", "engine.admit")
INSIDE_ADMIT = ("engine.prefill", "engine.splice", "engine.sample")


@functools.lru_cache(maxsize=None)
def _params():
    return tf.init_params(get_config(CFG), 0, device="cpu")


def _prompts():
    rng = np.random.RandomState(3)
    vocab = get_config(CFG).vocab_size
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in PROMPTS]


def _wait(cond, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


class _Served:
    """Every prompt sent while the dispatcher holds the engine, so the
    last two wait for a slot; then the engine runs them to their ends."""

    def __init__(self, tracing: bool, profile: bool = False):
        eng = ServingEngine(get_config(CFG), _params(), max_batch=MAX_BATCH,
                            max_seq=64, device="cpu")
        self.occupied_at_prefill, self.live_at_decode = [], []
        prefill, decode = eng._prefill, eng._decode

        def prefill_(params, batch):
            self.occupied_at_prefill.append(
                sum(r is not None for r in eng._slots))
            return prefill(params, batch)

        def decode_(params, cache, batch):
            self.live_at_decode.append(sum(r is not None for r in eng._slots))
            return decode(params, cache, batch)
        eng._prefill, eng._decode = prefill_, decode_
        server = InferenceServer(device="cpu", engine=eng)
        eng.telemetry.tracing = server.platform.telemetry.tracing = tracing
        client = Client(server.start())
        self.prof = None
        try:
            gate = threading.Event()

            def hold():
                idle = server._loop.on_idle
                server._loop.on_idle = lambda: idle() if gate.is_set() \
                    else False
            server.run_on_dispatcher(hold)
            if profile:
                server.run_on_dispatcher(self._start)
            rids = [client.infer_async(prompt=p, max_new=n)
                    for p, n in zip(_prompts(), MAX_NEW)]
            _wait(lambda: eng.pending() == len(PROMPTS),
                  "every prompt in the engine's queue")
            gate.set()
            self.tokens = [client.result(r, timeout=60)["tokens"].tolist()
                           for r in rids]
            if profile:
                server.run_on_dispatcher(self.prof.stop)
        finally:
            client.close()
            server.stop()
        self.server, self.engine = server, eng
        self.spans = server.platform.telemetry.spans() + \
            eng.telemetry.spans()

    def _start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU])
        self.prof.start()
        self.offset = Telemetry.profiler_offset_ns()

    def named(self, name):
        return [s for s in self.spans if s.name == name]


@pytest.fixture(scope="module")
def traced():
    return _Served(tracing=True)


@pytest.fixture(scope="module")
def profiled():
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with torch.profiler.record_function("warm-up"):
            pass
    return _Served(tracing=True, profile=True)


def test_tracing_off_records_nothing_and_reads_no_clock(monkeypatch,
                                                         traced):
    reads = itertools.count()
    clock = Telemetry.clock

    def counted():
        next(reads)
        return clock()

    def refuse(*a, **k):
        raise AssertionError("a span site ran with tracing off")
    monkeypatch.setattr(Telemetry, "clock", staticmethod(counted))
    for name in ("span", "record_span"):
        monkeypatch.setattr(Telemetry, name, refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    off = _Served(tracing=False)
    assert off.spans == [] and off.tokens == traced.tokens
    assert [len(t) for t in off.tokens] == [n + 1 for n in MAX_NEW]
    # only the rings read the clock: the dispatcher queue's enqueue and
    # dequeue stamps and its handler's two, and each decode step's two
    n_items = off.server._loop.stats["processed"]
    n_steps = off.engine.telemetry.count()
    assert next(reads) == 4 * n_items + 2 * n_steps
    assert n_steps == len(off.live_at_decode)


def test_every_request_has_its_spans_in_order(traced):
    keys = sorted({s.key for s in traced.named("server.queue")})
    assert len(keys) == len(PROMPTS)
    by = {}
    for s in traced.spans:
        assert (s.name, s.key) not in by, (s.name, s.key)
        by[s.name, s.key] = s
    assert set(by) == {(n, k) for n in KEYED for k in keys}
    for k in keys:
        q, w, slot, adm = (by[n, k] for n in KEYED)
        assert q.t0 <= q.t1 <= w.t0 <= w.t1 == slot.t0 <= adm.t0 <= adm.t1 \
            <= slot.t1
        assert adm.attrs["prompt"] == slot.attrs["prompt"] \
            == PROMPTS[k - 1]
        assert slot.attrs["max_new"] == MAX_NEW[k - 1]


def test_lanes_waiting_is_the_slots_occupied(traced):
    admits = sorted(traced.named("engine.admit"), key=lambda s: s.t0)
    assert [s.attrs["lanes_waiting"] for s in admits] == \
        traced.occupied_at_prefill
    # the first two prompts take both slots; the other two wait for one
    assert traced.occupied_at_prefill[:2] == [0, 1]
    assert max(traced.live_at_decode) == MAX_BATCH


def _mirrors(run, name):
    return sorted((e.time_range.start, e.time_range.end)
                  for e in run.prof.events() if e.name == name)


def test_host_work_is_mirrored_in_order(profiled):
    admits = _mirrors(profiled, "engine.admit")
    assert len(admits) == len(PROMPTS)
    inside = {n: _mirrors(profiled, n) for n in INSIDE_ADMIT}
    decodes = _mirrors(profiled, "engine.decode")
    assert len(decodes) == profiled.engine.telemetry.count() \
        == len(profiled.live_at_decode)
    assert len(inside["engine.sample"]) == len(admits) + len(decodes)
    for a0, a1 in admits:
        (p0, p1), (s0, s1), (m0, m1) = (
            next(iv for iv in inside[n] if a0 <= iv[0] <= a1)
            for n in INSIDE_ADMIT)
        assert a0 <= p0 <= p1 <= s0 <= s1 <= m0 <= m1 <= a1
    # each decode step's sample follows it
    steps = [iv for iv in inside["engine.sample"]
             if not any(a0 <= iv[0] <= a1 for a0, a1 in admits)]
    assert len(steps) == len(decodes)
    assert all(d[1] <= m[0] for d, m in zip(decodes, steps))
    assert len(_mirrors(profiled, "server.reply")) == len(PROMPTS)


def test_mirrors_lie_on_the_profiler_timeline(profiled):
    start_ns = profiled.prof.profiler.kineto_results.trace_start_ns()
    ring = sorted(s.t0 for s in profiled.named("engine.admit"))
    mirrors = [a for a, _ in _mirrors(profiled, "engine.admit")]
    assert ring and len(mirrors) == len(ring)
    conv = [(t + profiled.offset - start_ns) / 1e3 for t in ring]
    worst = max(abs(a - b) for a, b in zip(conv, mirrors))
    assert worst < 1e3, worst                    # microseconds
    # waits are not host work: no mirror
    assert not any(e.name in ("server.queue", "engine.wait", "engine.slot")
                   for e in profiled.prof.events())


def test_a_small_ring_counts_what_it_drops():
    tel = Telemetry(capacity=4)
    tel.tracing = True
    for i in range(10):
        tel.record_span("w", i, i + 1, key=i)
    with tel.span("h", 10, n=3):
        pass
    assert tel.spans_dropped == 7
    got = tel.spans()
    assert [s.key for s in got] == [7, 8, 9, 10]
    assert got[-1].attrs == {"n": 3} and got[0].attrs is None
    assert got[-1].t0 <= got[-1].t1


def test_server_queue_and_the_queue_wait_ring_share_their_stamps(traced):
    waits = traced.server._loop.queue_wait
    ring = list(waits._lat)
    for s in traced.named("server.queue"):
        assert any(abs((s.t1 - s.t0) * 1e-9 - x) < 1e-12 for x in ring)
