"""The readings a cell's ``logit_gap`` limit is set from, on the card:

    python perfbench/control.py --workload nemo.chat --seconds 5 \\
        --seeds 11 12 13 ... --control-seeds 11 12 13

For each seed, in one process: the cell's served path at its own size and
load for a short window (``harness.serve``), then the widest gap of its
served tokens under the fp32 reference on the requests a run checks (the
lower reading). For each control seed also the control's on the same
prompts and tokens: the reference in float8 put in the program's place,
the widest gap of its first choice at each served position (the upper
reading). One JSON line a seed on standard output. The benchmark's own
runs do not run this.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def readings(cell: str, seed: int, seconds: float, control: bool,
             device="cuda", root=None) -> dict:
    """One seed's program reading and, with ``control``, its control
    reading, with what they were taken over."""
    from perfbench import check, harness
    t = time.perf_counter()
    s = harness.serve(cell, seed, seconds, False, device, root=root)
    reqs = check.pick(s.done, seed, s.cell.traffic["check"])
    served = check.served_gaps(s.cell.config, s.params, reqs)
    out = {"cell": cell, "seed": seed, "requests": len(reqs),
           "tokens": int(sum(len(g) for g in served)),
           "positions": [len(r.prompt) + len(r.tokens) for r in reqs],
           "program_gap": float(max(g.max() for g in served)),
           "program_off_best": int(sum((g > 0).sum() for g in served))}
    if control:
        low = check.control_gaps(s.cell.config, s.params, reqs)
        out.update({"control_gap": float(max(g.max() for g in low)),
                    "control_off_best": int(sum((g > 0).sum()
                                                for g in low))})
    out["seconds"] = time.perf_counter() - t
    del s
    gc.collect()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control readings need a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        r = readings(args.workload, seed, args.seconds,
                     seed in args.control_seeds)
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
