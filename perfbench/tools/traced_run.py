"""One run of a cell with the program's span tracing switched on (or off),
and the four span metrics that the harness does not read yet.

    python3 perfbench/tools/traced_run.py --workload nemo.chat --seed 7 \
        --seconds 51 --trace 1 --tracing 1

Runs ``harness.run`` as ``perfbench/run.py`` does (its result also keeps
``forbidden_modules`` and ``setup_phases``), with these additions,
all made from outside the harness: ``Telemetry.tracing`` switched on in
the server's and the engine's telemetry once the server is built and
before the ramp (``--tracing 1``); the program's spans copied into the
``Record`` (``spans.collect``) and, in a traced run, the profiled device
intervals and ``engine.admit`` mirrors (``spans.from_profile``). Prints
the result line with a ``program`` key last: ``queue_wait_ms.p95``,
``prefill_stall_share``, ``lane_occupancy``,
``prefill_device_idle_share`` (each None where its reader finds nothing),
the engine's ``decode_step_ms.p50``, ``spans_dropped``, the window's
split of the queueing between ``server.queue`` and ``engine.wait``, the
admissions' count and mean ``lanes_waiting``, and in a traced run the
widest distance between a ring's ``engine.admit`` start, converted onto
the profiler's timeline, and its mirror's.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

NAMES = ("queue_wait_ms.p95", "prefill_stall_share", "lane_occupancy",
         "prefill_device_idle_share")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--tracing", type=int, choices=(0, 1), default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT),
                    help="the checkout whose cells are run")
    return ap.parse_args(argv)


@contextlib.contextmanager
def _hooked(tracing: bool, box: dict):
    """Switch tracing on once the server is built, and keep the server's
    telemetries, the served run, the profiler's offset and its reduction."""
    from perfbench import harness, spans, trace
    from repro_torch.core.rtpm import Telemetry
    from repro_torch.serving.server import InferenceServer

    start, serve = InferenceServer.start, harness.serve
    pstart, reduce = harness.Profiler._start, trace.reduce

    def start_(self):
        tels = [self.platform.telemetry, self.engine.telemetry]
        for tel in tels:
            tel.tracing = tracing
        box["tels"] = tels
        return start(self)

    def serve_(*args, **kw):
        box["served"] = s = serve(*args, **kw)
        return s

    def pstart_(self):
        pstart(self)
        box["offset"] = Telemetry.profiler_offset_ns()

    def reduce_(prof, window_s):
        box["busy"], box["mirrors"] = spans.from_profile(prof)
        box["trace_start_ns"] = prof.profiler.kineto_results.trace_start_ns()
        return reduce(prof, window_s)

    InferenceServer.start, harness.serve = start_, serve_
    harness.Profiler._start, trace.reduce = pstart_, reduce_
    try:
        yield
    finally:
        InferenceServer.start, harness.serve = start, serve
        harness.Profiler._start, trace.reduce = pstart, reduce


def _program(rec, box: dict, root: Path) -> dict:
    """The ``program`` key of the result line."""
    from perfbench import spans, spec
    from perfbench.record import percentile

    rec.spans, rec.spans_dropped = spans.collect(box["tels"], rec.window[0])
    if "busy" in box:
        rec.device_busy, rec.admit_mirrors = box["busy"], box["mirrors"]
    out = {n: spec.load_reader(n, root).read(rec) for n in NAMES}
    tel = rec.decode_step_s or {}
    out["decode_step_ms.p50"] = tel["p50"] * 1e3 if "p50" in tel else None
    out["spans_dropped"] = rec.spans_dropped
    w0, w1 = rec.window
    placed = {s[1]: s for s in rec.spans
              if s[0] == "engine.wait" and w0 <= s[3] <= w1}
    queued = {s[1]: s for s in rec.spans if s[0] == "server.queue"}
    sq = [(queued[k][3] - queued[k][2]) * 1e3 for k in placed if k in queued]
    ew = [(s[3] - s[2]) * 1e3 for s in placed.values()]
    out["split_ms"] = {"server.queue.p50": percentile(sq, 50),
                       "server.queue.p95": percentile(sq, 95),
                       "engine.wait.p50": percentile(ew, 50),
                       "engine.wait.p95": percentile(ew, 95)}
    admits = [s for s in rec.spans
              if s[0] == "engine.admit" and w0 <= s[3] <= w1]
    out["admits"] = len(admits)
    out["lanes_waiting.mean"] = (sum(s[4]["lanes_waiting"] for s in admits)
                                 / len(admits)) if admits else None
    mirrors = [a for a, _ in box.get("mirrors", [])]
    if mirrors and box.get("offset") is not None:
        # ring starts on the profiler's timeline (Telemetry's docstring)
        ring = sorted((s[2] * 1e9 + box["offset"] - box["trace_start_ns"])
                      / 1e3 for s in rec.spans if s[0] == "engine.admit")
        near = [t for t in ring
                if mirrors[0] - 5e3 <= t <= mirrors[-1] + 5e3]
        out["mirror_vs_ring_us.max"] = max(
            abs(a - b) for a, b in zip(near, mirrors)) \
            if len(near) == len(mirrors) else None
    return out


def main(argv=None) -> dict:
    args = parse_args(argv)
    from perfbench import harness
    root, box = Path(args.root), {}
    with _hooked(bool(args.tracing), box):
        out = harness.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), device=args.device,
                          t_process=T_PROCESS, root=root)
    out["program"] = _program(box["served"].rec, box, root)
    out["program"]["tracing"] = args.tracing
    return out


if __name__ == "__main__":
    print(json.dumps(main()), flush=True)
