"""Run one cell of the port's benchmark on this machine's card.

    python perfbench/run.py --workload nemo.chat --seed 7 --seconds 40 --trace 0

Prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``,
and last the ``checks`` that decided ``correct``, each number beside its
limit (also the last lines on standard error). Exits non-zero, with no
result line, without a CUDA card, with fewer cards than the cell asks
for, or when ``jax``, ``jaxlib``, ``flax`` or ``repro`` is loaded once the
window has closed.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch
    from perfbench import harness, spec
    cell = spec.load_cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_process=T_PROCESS)
    forbidden = out.pop("forbidden_modules")
    print("setup phases: " + ", ".join(
        f"{k} {v:.3f}" for k, v in out.pop("setup_phases").items()),
        file=sys.stderr)
    if forbidden:
        print(f"loaded once the window closed: {', '.join(forbidden)}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
