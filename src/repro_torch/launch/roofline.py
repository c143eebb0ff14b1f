"""Roofline analysis over the dry-run records, with H100 constants (the
port's counterpart of ``repro.launch.roofline``).

Per (arch x shape x mesh) cell, from results/torch/dryrun/*/*.json:

  compute term    = FLOPs_per_device / peak_FLOP/s
  memory term     = bytes_per_device / HBM_bandwidth
  collective term = collective_bytes_per_device / link_bandwidth

(the dry run counts each rank's own ops, so the "chips x" denominators are
already divided out.)

Additionally: MODEL_FLOPS = 6*N*D (train) or 2*N*D (inference steps), with
N_active for MoE; the ratio MODEL_FLOPS/FLOPs exposes remat/dispatch/
attention overheads; roofline_fraction = ideal compute time over the
dominant term; and a per-cell bottleneck note. The H100 constants below
are datasheet figures, none a measurement.

Usage:  python -m repro_torch.launch.roofline [--mesh pod256] [--markdown]
"""
from __future__ import annotations

import argparse
import json
import pathlib

# H100 SXM5, dense bf16 on the tensor cores (no sparsity), per card
H100_PEAK_FLOPS = 989e12
# H100 SXM5 HBM3, per card
H100_HBM_BW = 3.35e12
# One NDR 400 Gb/s InfiniBand port a card: a 16-wide model axis spans more
# than one 8-card NVLink node, so this is the link the production meshes
# cross. NVLink's 450 GB/s a direction holds only inside a node.
H100_LINK_BW = 50e9

REPO = pathlib.Path(__file__).resolve().parents[3]
RESULTS = REPO / "results" / "torch"
# where ``launch/dryrun.py`` writes its records: named here, a module with
# no side effects, so that a reader need not import the dry run (which
# starts its fake process group on import)
DRYRUN_RESULTS = RESULTS / "dryrun"


def model_flops_per_device(rec: dict) -> float:
    m = rec["model"]
    n = m["active_params"]
    if rec["kind"] == "train":
        toks = m["global_batch"] * m["seq_len"]
        total = 6.0 * n * toks
    elif rec["kind"] == "prefill":
        toks = m["global_batch"] * m["seq_len"]
        total = 2.0 * n * toks
    else:                                     # decode: one token per seq
        toks = m["global_batch"]
        total = 2.0 * n * toks
    return total / rec["devices"]


def analyze(rec: dict) -> dict:
    t_c = rec["flops_per_device"] / H100_PEAK_FLOPS
    t_m = rec["bytes_per_device"] / H100_HBM_BW
    t_x = rec["collective_bytes_per_device"] / H100_LINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    dom = max(terms, key=terms.get)
    mf = model_flops_per_device(rec)
    t_ideal = mf / H100_PEAK_FLOPS
    frac = t_ideal / max(terms.values()) if max(terms.values()) > 0 else 0.0
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "kind": rec["kind"],
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
        "dominant": dom,
        "model_flops_per_device": mf,
        "useful_ratio": mf / rec["flops_per_device"]
        if rec["flops_per_device"] else 0.0,
        "roofline_fraction": frac,
        "note": note_for(rec, dom, terms),
    }


def note_for(rec: dict, dom: str, terms: dict) -> str:
    kind = rec["kind"]
    if dom == "collective":
        return ("shrink collective volume: fewer/larger fused all-reduces, "
                "EP all-to-all instead of all-gather dispatch, keep TP "
                "traffic inside an NVLink node" if kind != "decode" else
                "decode collective-bound: replicate small states instead of "
                "gathering, batch KV-sharded partial-softmax reductions")
    if dom == "memory":
        if kind == "decode":
            return ("decode is KV/weight-streaming bound (expected): raise "
                    "batch per card, quantize KV cache, or fuse cache "
                    "read+attend (flash-decode kernel)")
        return ("cut HBM traffic: fuse softmax/norm chains (flash kernels), "
                "bf16 intermediates, larger remat blocks")
    return ("compute-bound (good): push the tensor cores' utilization via "
            "larger per-card tiles and int8 where the paper's quantized "
            "path applies")


def load(mesh: str, include_skips: bool = False, results=None) -> list:
    root = pathlib.Path(results) if results is not None else RESULTS
    out = []
    for p in sorted((root / "dryrun" / mesh).glob("*.json")):
        if p.name.count("__") > 1:       # __full / __train_zero1 variants
            continue
        rec = json.loads(p.read_text())
        if rec.get("skipped"):
            if include_skips:
                out.append(rec)
            continue
        out.append(analyze(rec))
    return out


def markdown_table(rows: list) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant "
           "| useful ratio | roofline frac | note |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    body = ""
    for r in rows:
        if r.get("skipped"):
            body += (f"| {r['arch']} | {r['shape']} | — | — | — | — | — | — "
                     f"| SKIP: {r['reason']} |\n")
            continue
        body += (f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | "
                 f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | "
                 f"**{r['dominant']}** | {r['useful_ratio']:.2f} | "
                 f"{r['roofline_fraction']:.2%} | {r['note']} |\n")
    return hdr + body


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod256", choices=("pod256", "pod512"))
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)
    rows = load(args.mesh, include_skips=True)
    analyzed = [r for r in rows if not r.get("skipped")]
    RESULTS.mkdir(parents=True, exist_ok=True)
    (RESULTS / f"roofline_{args.mesh}.json").write_text(
        json.dumps(rows, indent=2))
    if args.markdown:
        print(markdown_table(rows))
    else:
        for r in analyzed:
            print(f"{r['arch']:24s} {r['shape']:12s} dom={r['dominant']:10s} "
                  f"frac={r['roofline_fraction']:7.2%} "
                  f"useful={r['useful_ratio']:.2f}")
    worst = sorted(analyzed, key=lambda r: r["roofline_fraction"])[:5]
    print("\n# worst roofline fractions:")
    for r in worst:
        print(f"  {r['arch']} x {r['shape']}: {r['roofline_fraction']:.2%} "
              f"({r['dominant']}-bound)")
    collb = [r for r in analyzed if r["dominant"] == "collective"]
    print(f"# collective-bound cells: {len(collb)}")


if __name__ == "__main__":
    main()
