"""The readers of the program's spans (``perfbench/spans.py``): known
answers on hand-built records, None where spans are missing or were
dropped inside the window, and a tiny cell served on the CPU with the
program's tracing switched on after the server is built."""
import importlib.util

import pytest

from perfbench import harness, spans, spec
from perfbench.record import Record
from perfbench.spec import HERE
from repro_torch.core.rtpm import Telemetry
from repro_torch.serving.server import InferenceServer

SEED = 2**31 + 17
NAMES = ("queue_wait_ms.p95", "prefill_stall_share", "lane_occupancy",
         "prefill_device_idle_share")


def _read(name, rec):
    return spec.load_reader(name).read(rec)


def _record(**kw):
    return Record(cfg=None, config={"port": {"max_batch": 2}},
                  window=(10.0, 20.0), setup_s=1.0, done=[], **kw)


# three requests over a window of [10, 20] s and 2 lanes: request 0 placed
# before it and freed at 12; request 1 placed at 11 and freed at 15;
# request 2 placed at 13 and holding its slot past the window's end
SPANS = [
    ("server.queue", 0, 1.0, 2.0, None), ("engine.wait", 0, 2.0, 5.0, None),
    ("engine.admit", 0, 5.0, 6.0, {"prompt": 8, "lanes_waiting": 0}),
    ("engine.slot", 0, 5.0, 12.0, {"prompt": 8, "max_new": 4}),
    ("server.queue", 1, 9.0, 9.5, None), ("engine.wait", 1, 9.6, 11.0, None),
    ("engine.admit", 1, 11.0, 12.0, {"prompt": 8, "lanes_waiting": 1}),
    ("engine.slot", 1, 11.0, 15.0, {"prompt": 8, "max_new": 4}),
    ("server.queue", 2, 10.0, 10.2, None),
    ("engine.wait", 2, 10.3, 13.0, None),
    ("engine.admit", 2, 13.0, 14.0, {"prompt": 8, "lanes_waiting": 1}),
]


def test_span_readers_give_their_known_answers():
    rec = _record()
    rec.spans, rec.spans_dropped = SPANS, 0
    # queue + wait of requests 1 and 2: 1.9 s and 2.9 s
    assert _read("queue_wait_ms.p95", rec) == pytest.approx(
        1900 + 0.95 * 1000)
    # lane-seconds in the window: 2 + 4 + 7; stalled: 1 x 1 + 1 x 1
    assert _read("prefill_stall_share", rec) == pytest.approx(100 * 2 / 13)
    assert _read("lane_occupancy", rec) == pytest.approx(100 * 13 / 20)


def test_device_idle_inside_the_admissions():
    rec = _record()
    rec.device_busy = [[0.0, 10.0], [15.0, 20.0], [30.0, 40.0]]
    rec.admit_mirrors = [(5.0, 25.0), (50.0, 60.0)]
    # (5, 25) is covered 10 of 20; (50, 60) not at all
    assert _read("prefill_device_idle_share", rec) == pytest.approx(
        100 * 20 / 30)
    rec.admit_mirrors = []
    assert _read("prefill_device_idle_share", rec) is None


@pytest.mark.parametrize("dropped", [0, 3])
def test_without_spans_or_with_spans_dropped_the_readers_give_none(dropped):
    rec = _record()
    if dropped:
        rec.spans, rec.spans_dropped = SPANS, dropped
    assert all(_read(n, rec) is None for n in NAMES)


def test_collect_counts_drops_only_where_they_may_lie_in_the_window():
    tel = Telemetry(capacity=2)
    for i in range(3):
        tel.record_span("engine.wait", i * 10**9, (i + 1) * 10**9, key=i)
    got, dropped = spans.collect([tel, Telemetry()], since=1.5)
    assert [s[1] for s in got] == [1, 2] and got[0][2:4] == (1.0, 2.0)
    assert dropped == 1                 # the oldest kept ended after 1.5
    assert spans.collect([tel], since=2.5)[1] == 0


@pytest.mark.parametrize("traced", [False, True])
def test_a_tiny_cell_with_the_program_traced(tiny_root, monkeypatch,
                                             traced):
    tels = []
    start = InferenceServer.start

    def start_traced(self):
        self.platform.telemetry.tracing = True
        self.engine.telemetry.tracing = True
        tels[:] = [self.platform.telemetry, self.engine.telemetry]
        return start(self)
    monkeypatch.setattr(InferenceServer, "start", start_traced)
    s = harness.serve("tiny.dense", SEED, 1.5, traced, device="cpu",
                      root=tiny_root)
    rec = s.rec
    rec.spans, rec.spans_dropped = spans.collect(tels, rec.window[0])
    assert rec.spans_dropped == 0
    got = {n: spec.load_reader(n, tiny_root).read(rec) for n in NAMES}
    assert got["prefill_device_idle_share"] is None     # no device trace
    assert got["queue_wait_ms.p95"] >= 0
    assert 0 <= got["prefill_stall_share"] < 100
    assert 0 < got["lane_occupancy"] <= 100
    if traced:       # the harness's own spans see the same prefills
        admits = [x for x in rec.spans if x[0] == "engine.admit"
                  and rec.window[0] <= x[3] <= rec.window[1]]
        assert abs(len(admits) - len(rec.prefills)) <= 1


@pytest.mark.parametrize("tracing", [0, 1])
def test_the_traced_run_tool_on_a_tiny_cell(tiny_root, tracing):
    path = HERE / "tools" / "traced_run.py"
    mod_spec = importlib.util.spec_from_file_location("traced_run", path)
    tool = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(tool)
    out = tool.main(["--workload", "tiny.dense", "--seed", str(SEED),
                     "--seconds", "1.5", "--trace", "1", "--tracing",
                     str(tracing), "--device", "cpu",
                     "--root", str(tiny_root)])
    got = out["program"]
    assert out["correct"] and not out["forbidden_modules"]
    assert got["tracing"] == tracing and got["spans_dropped"] == 0
    assert got["decode_step_ms.p50"] > 0
    assert got["prefill_device_idle_share"] is None     # no device trace
    if tracing:
        assert got["queue_wait_ms.p95"] >= 0 and got["admits"] > 0
        assert 0 < got["lane_occupancy"] <= 100
    else:
        assert all(got[n] is None for n in tool.NAMES)
        assert got["admits"] == 0
    # the harness's own hooks are back as they were
    assert harness.serve.__module__ == "perfbench.harness"
