"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step over a
fake process group of 512 ranks, on ``meta`` DTensors (the port's
counterpart of ``repro.launch.dryrun``).

The process-group lines below MUST stay the first statements of this
module, as the reference's ``XLA_FLAGS`` lines must: the production meshes
(256 and 512 ranks) exist only over the ``fake`` group, which no real
collective ever reaches. Nothing touches a card: every tensor is ``meta``.

Per cell we record the trace's wall time, the per-device memory of rank 0
(arguments, outputs, donated arguments, peak live intermediates), the
per-device FLOPs and bytes for the roofline, and the collectives' operand
bytes by kind (``launch/cost.py`` says how each is reckoned; the
reference's ``parse_collectives`` reads HLO text, which the port never
makes, and has no counterpart). Records land in
``results/torch/dryrun/<mesh>/`` as JSON.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape train_4k [--mode full] [--multipod] [--rules train_zero1]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]
"""
import torch.distributed as _dist
from torch.testing._internal.distributed.fake_pg import FakeStore as _Store

if not _dist.is_initialized():
    _dist.init_process_group("fake", store=_Store(), rank=0, world_size=512)

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

from repro_torch.launch.roofline import DRYRUN_RESULTS  # noqa: E402


def _greedy_redistribute_plans() -> None:
    """Plan every DTensor redistribution greedily, mesh dim by mesh dim.
    DTensor searches a graph of placements for the cheapest plan where a
    spec's shard order is not the mesh's, and over the 3-D pod512 mesh
    that search priced one attention einsum's candidate strategies in
    350 s on a CPU core (greedy: 1.2 s). The plans price strategies and
    move ``meta`` shards here, so the dry run takes the greedy plan and
    the search only where the greedy planner refuses. A torch without the
    search (greedy only) is left as it is."""
    from torch.distributed.tensor import _redistribute as red
    planner = getattr(red, "DTensorRedistributePlanner", None)
    search = getattr(planner, "generate_graph_based_transform_infos", None)
    if search is None or getattr(search, "greedy_first", False):
        return

    def greedy_first(self, src_spec, dst_spec, *args, **kwargs):
        try:
            return self.generate_greedy_transform_infos(src_spec, dst_spec)
        except Exception:
            return search(self, src_spec, dst_spec, *args, **kwargs)
    greedy_first.greedy_first = True
    planner.generate_graph_based_transform_infos = greedy_first


_greedy_redistribute_plans()

REPO = pathlib.Path(__file__).resolve().parents[3]
RESULTS = DRYRUN_RESULTS

_RULES_BY_KIND = {"train": "train", "prefill": "prefill", "decode": "decode"}


def _trace_once(cfg, shape, mesh, rules, run: bool = True):
    """Build one step's arguments under the binding and, with ``run``,
    trace the step under ``CostMode``. Returns (cost record or None,
    memory of the arguments and outputs, seconds)."""
    from repro_torch.distributed.sharding import axis_rules
    from repro_torch.launch import steps as st
    from repro_torch.launch.cost import CostMode, tree_bytes

    t0 = time.time()
    with axis_rules(mesh, rules):
        fn, args, donate = st.step_for(cfg, shape)
        mem = {"argument_bytes": tree_bytes(args),
               "alias_bytes": sum(tree_bytes(args[i]) for i in donate)}
        rec = None
        if run:
            with CostMode("meta") as cm:
                out = fn(*args)
            mem["output_bytes"] = tree_bytes(out)
            rec = cm.record()
            del out
    return rec, mem, time.time() - t0


def _skip_reason(cfg, shape_name: str):
    from repro_torch.configs import applicable_shapes
    if shape_name not in applicable_shapes(cfg):
        return "long_500k reserved for sub-quadratic archs"
    return None


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             unroll: bool = False, force: bool = False, save: bool = True,
             rules_variant: str = "", mesh=None, results=None,
             num_layers=None) -> dict:
    """One dry-run cell.

    Default ("extrapolate") protocol, as the reference's: 1-layer and
    2-layer traces give exact per-layer FLOPs/bytes/collectives, and the
    totals extrapolate as X1 + (L-1)(X2-X1); the full config's arguments
    are built (not traced) for the memory record, whose ``temp_bytes``
    extrapolates the same way. ``unroll=True`` (--mode full) traces the
    whole model instead. The port's layers are a Python loop, so both
    modes' totals agree exactly (every layer is the same ops on the same
    shapes, and everything else costs the same at any depth).

    ``mesh`` replaces the production mesh (a test's small mesh over the
    same fake group), ``results`` the records' root directory and
    ``num_layers`` the config's depth."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.sharding import mesh_sizes
    from repro_torch.launch.mesh import make_production_mesh

    if mesh is None:
        mesh_tag = "pod512" if multi_pod else "pod256"
    else:
        mesh_tag = "mesh" + "x".join(map(str, mesh_sizes(mesh).values()))
    suffix = "__full" if unroll else ""
    if rules_variant:
        suffix += f"__{rules_variant}"
    root = pathlib.Path(results) if results is not None else RESULTS
    out_path = root / mesh_tag / f"{arch}__{shape_name}{suffix}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg = get_config(arch)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    shape = SHAPES[shape_name]
    reason = _skip_reason(cfg, shape_name)
    if reason is not None:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "skipped": True, "reason": reason}
        if save:
            out_path.parent.mkdir(parents=True, exist_ok=True)
            out_path.write_text(json.dumps(rec, indent=2))
        return rec

    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    rules = rules_variant or _RULES_BY_KIND[shape.kind]
    L = cfg.num_layers

    if unroll:                                   # --mode full (validation)
        c, mem, secs = _trace_once(cfg, shape, mesh, rules)
        t_proof = secs
        totals = {"flops": c["flops"], "bytes": c["bytes"],
                  "coll_bytes": c["collectives"]["total_bytes"],
                  "coll_counts": c["collectives"]["counts"]}
        mem["temp_bytes"] = c["temp_bytes"]
        per_layer = {}
    else:
        _, mem, t_proof = _trace_once(cfg, shape, mesh, rules, run=False)
        r1, m1, s1 = _trace_once(dataclasses.replace(cfg, num_layers=1),
                                 shape, mesh, rules)
        r2, m2, s2 = _trace_once(dataclasses.replace(cfg, num_layers=2),
                                 shape, mesh, rules)
        secs = t_proof + s1 + s2

        def extra(a, b):
            return a + (L - 1) * (b - a)

        cb1 = r1["collectives"]["total_bytes"]
        cb2 = r2["collectives"]["total_bytes"]
        coll_by_kind = {k: extra(r1["collectives"]["bytes"][k],
                                 r2["collectives"]["bytes"][k])
                        for k in r1["collectives"]["bytes"]}
        totals = {"flops": extra(r1["flops"], r2["flops"]),
                  "bytes": extra(r1["bytes"], r2["bytes"]),
                  "coll_bytes": extra(cb1, cb2),
                  "coll_bytes_by_kind": coll_by_kind}
        mem["output_bytes"] = extra(m1["output_bytes"], m2["output_bytes"])
        mem["temp_bytes"] = extra(r1["temp_bytes"], r2["temp_bytes"])
        per_layer = {"flops_1L": r1["flops"], "flops_2L": r2["flops"],
                     "bytes_1L": r1["bytes"], "bytes_2L": r2["bytes"],
                     "coll_1L": cb1, "coll_2L": cb2,
                     "coll_counts_2L": r2["collectives"]["counts"],
                     "temp_1L": r1["temp_bytes"], "temp_2L": r2["temp_bytes"]}

    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_tag,
        "kind": shape.kind,
        "devices": int(mesh.size()),
        "mode": "full_unroll" if unroll else "extrapolated",
        "compile_seconds": round(secs, 2),
        "proof_compile_seconds": round(t_proof, 2),
        "flops_per_device": totals["flops"],
        "bytes_per_device": totals["bytes"],
        "collective_bytes_per_device": totals["coll_bytes"],
        "collective_detail": totals.get("coll_bytes_by_kind",
                                        totals.get("coll_counts")),
        "per_layer": per_layer,
        "memory": {
            "argument_bytes": mem["argument_bytes"],
            "output_bytes": mem["output_bytes"],
            "temp_bytes": mem["temp_bytes"],
            "alias_bytes": mem["alias_bytes"],
        },
        "model": {
            "num_layers": L,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "global_batch": shape.global_batch,
            "seq_len": shape.seq_len,
        },
    }
    print(f"[dryrun] {arch} x {shape_name} x {mesh_tag} ({rec['mode']}): "
          f"trace={secs:.1f}s flops/dev={totals['flops']:.3e} "
          f"coll/dev={totals['coll_bytes'] / 1e6:.1f}MB "
          f"temp={mem['temp_bytes'] / 1e9:.2f}GB")
    if save:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(rec, indent=2))
    return rec


def _all_cells():
    from repro_torch.configs import ARCHES, SHAPES
    for arch in ARCHES:
        for shape in SHAPES:
            yield arch, shape


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every cell in crash-isolated subprocesses")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--mode", choices=("extrapolate", "full"),
                    default="extrapolate")
    ap.add_argument("--rules", default="",
                    help="rule-set variant override (e.g. train_zero1)")
    args = ap.parse_args(argv)

    if args.all:
        fails = []
        meshes = [False, True] if args.both_meshes or not args.multipod \
            else [True]
        for arch, shape in _all_cells():
            for mp in meshes:
                tag = "pod512" if mp else "pod256"
                suffix = "__full" if args.mode == "full" else ""
                out = RESULTS / tag / f"{arch}__{shape}{suffix}.json"
                if out.exists() and not args.force:
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape,
                       "--mode", args.mode]
                if mp:
                    cmd.append("--multipod")
                if args.force:
                    cmd.append("--force")
                r = subprocess.run(cmd, cwd=str(REPO),
                                   env={**os.environ,
                                        "PYTHONPATH": str(REPO / "src")})
                if r.returncode != 0:
                    fails.append((arch, shape, tag))
                    print(f"[dryrun] FAILED {arch} x {shape} x {tag}")
        if fails:
            print("FAILURES:", fails)
            return 1
        print("[dryrun] all cells green")
        return 0

    if not args.arch or not args.shape:
        ap.error("--arch and --shape are required without --all")
    rec = run_cell(args.arch, args.shape, args.multipod,
                   unroll=(args.mode == "full"), force=args.force,
                   rules_variant=args.rules)
    return 0 if rec else 1


if __name__ == "__main__":
    sys.exit(main())
