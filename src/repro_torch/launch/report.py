"""Tables of the port's dry-run and roofline records (the port's
counterpart of ``repro.launch.report``, which regenerates EXPERIMENTS.md's
sections; the port has no such document, so ``main`` prints the tables or
writes them to ``--out``).

  PYTHONPATH=src python -m repro_torch.launch.report [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.launch.roofline import RESULTS, load, markdown_table


def dryrun_table(results=None) -> str:
    root = pathlib.Path(results) if results is not None else RESULTS
    hdr = ("| arch | shape | mesh | trace s | flops/dev | bytes/dev | "
           "coll/dev | temp GB | args GB |\n" + "|---|" * 9 + "\n")
    rows = []
    for mesh in ("pod256", "pod512"):
        for p in sorted((root / "dryrun" / mesh).glob("*.json")):
            if "__full" in p.name or "__train_zero1" in p.name:
                continue
            r = json.loads(p.read_text())
            if r.get("skipped"):
                rows.append(f"| {r['arch']} | {r['shape']} | {mesh} | — | — "
                            f"| — | — | — | SKIP ({r['reason']}) |")
                continue
            m = r["memory"]
            rows.append(
                f"| {r['arch']} | {r['shape']} | {mesh} | "
                f"{r['compile_seconds']:.0f} | {r['flops_per_device']:.2e} | "
                f"{r['bytes_per_device']:.2e} | "
                f"{r['collective_bytes_per_device']:.2e} | "
                f"{m['temp_bytes'] / 1e9:.2f} | "
                f"{m['argument_bytes'] / 1e9:.2f} |")
    return hdr + "\n".join(rows) + "\n"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--results", default=None,
                    help="records' root (default results/torch)")
    args = ap.parse_args(argv)
    roof = markdown_table(load("pod256", include_skips=True,
                               results=args.results))
    dry = dryrun_table(args.results)
    text = "## Roofline (pod256)\n\n" + roof + "\n## Dry run\n\n" + dry
    if args.out:
        pathlib.Path(args.out).write_text(text)
        print(f"{args.out} written ({len(roof.splitlines())} roofline "
              f"rows, {len(dry.splitlines())} dry-run rows)")
    else:
        print(text)


if __name__ == "__main__":
    main()
