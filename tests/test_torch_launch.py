"""Launch-layer units of the port: the roofline with H100 constants, the
dry run's per-device FLOP rule and collective counter over a fake process
group, ``run_cell`` in both modes, and the report's tables."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs import applicable_shapes, get_config
from repro_torch.launch import report
from repro_torch.launch.roofline import (H100_HBM_BW, H100_LINK_BW,
                                         H100_PEAK_FLOPS, analyze, load,
                                         markdown_table,
                                         model_flops_per_device)

REPO_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


def _run(script: str, timeout: int = 120) -> list:
    """``script`` in a fresh process whose first import starts the dry
    run's fake group of 512 ranks; returns its stdout's lines."""
    env = dict(os.environ, PYTHONPATH=REPO_SRC)
    code = "import repro_torch.launch.dryrun as dryrun\n" + \
        textwrap.dedent(script)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=timeout)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return r.stdout.splitlines()


def _rec(kind="train", flops=1e13, bts=1e12, coll=1e10, devices=256):
    return {
        "arch": "x", "shape": "s", "mesh": "pod256", "kind": kind,
        "devices": devices, "flops_per_device": flops,
        "bytes_per_device": bts, "collective_bytes_per_device": coll,
        "model": {"params": 1e9, "active_params": 1e9,
                  "global_batch": 256, "seq_len": 4096},
    }


def test_h100_constants_are_the_datasheet_figures():
    assert (H100_PEAK_FLOPS, H100_HBM_BW, H100_LINK_BW) == (989e12, 3.35e12,
                                                            50e9)


def test_roofline_terms_and_dominance():
    r = analyze(_rec())
    assert r["compute_s"] == pytest.approx(1e13 / H100_PEAK_FLOPS)
    assert r["memory_s"] == pytest.approx(1e12 / H100_HBM_BW)
    assert r["collective_s"] == pytest.approx(1e10 / H100_LINK_BW)
    assert r["dominant"] == "memory"
    assert 0 < r["roofline_fraction"] < 1
    r = analyze(_rec(flops=1e15))
    assert r["dominant"] == "compute" and "tensor cores" in r["note"]
    assert analyze(_rec(coll=1e13))["dominant"] == "collective"


def test_model_flops_train_vs_decode():
    train = model_flops_per_device(_rec("train"))
    assert train == pytest.approx(6 * 1e9 * 256 * 4096 / 256)
    dec = model_flops_per_device(_rec("decode"))
    assert dec == pytest.approx(2 * 1e9 * 256 / 256)
    pre = model_flops_per_device(_rec("prefill"))
    assert pre == pytest.approx(2 * 1e9 * 256 * 4096 / 256)


def test_applicable_shapes_policy():
    assert "long_500k" in applicable_shapes(get_config("rwkv6-1.6b"))
    assert "long_500k" in applicable_shapes(get_config("hymba-1.5b"))
    assert "long_500k" not in applicable_shapes(get_config("qwen3-14b"))


def test_per_device_flops_of_a_sharded_matmul():
    """A (256, 512, 1536) batch-sharded input times a (1536, 8960)
    column-sharded weight on a fake 16 x 16 mesh: the count of this
    rank's ops equals its local product's, which is the global count
    (``FlopCounterMode`` above the DTensors) over 256."""
    out = _run("""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.cost import CostMode
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh()
    x = DTensor.from_local(torch.empty(16, 512, 1536, device="meta",
                                       dtype=torch.bfloat16), mesh,
                           [Shard(0), Replicate()], run_check=False)
    w = DTensor.from_local(torch.empty(1536, 560, device="meta",
                                       dtype=torch.bfloat16), mesh,
                           [Replicate(), Shard(1)], run_check=False)
    with CostMode("meta") as cm:
        y = x @ w
    with FlopCounterMode(display=False) as fc:
        x @ w
    print(cm.flops, fc.get_total_flops(), *y.to_local().shape,
          sum(cm.coll_counts.values()))
    """)
    local, total, *shape, colls = map(int, out[-1].split())
    assert local == 2 * 16 * 512 * 1536 * 560
    assert total == 2 * 256 * 512 * 1536 * 8960
    assert local * 256 == total
    assert shape == [16, 512, 560] and colls == 0


def test_collective_counter_on_known_redistributes():
    """On a fake 4-rank mesh: Shard(0) -> Replicate of an (8, 16) fp32
    tensor is one all-gather of the 2 x 16 local rows; Partial ->
    Replicate one all-reduce of all 8 x 16; Shard(0) -> Shard(1) one
    all-to-all."""
    out = _run("""
    import json, torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.launch.cost import CostMode
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh((4,), ("data",))
    rec = {}
    for name, src, dst in (("gather", Shard(0), Replicate()),
                           ("reduce", Partial(), Replicate()),
                           ("a2a", Shard(0), Shard(1))):
        local = (2, 16) if src == Shard(0) else (8, 16)
        x = DTensor.from_local(torch.empty(local, device="meta"), mesh,
                               [src], run_check=False)
        with CostMode("meta") as cm:
            x.redistribute(mesh, [dst])
        rec[name] = cm.record()["collectives"]
    print(json.dumps(rec))
    """)
    rec = json.loads(out[-1])
    assert rec["gather"]["counts"]["all-gather"] == 1
    assert rec["gather"]["bytes"]["all-gather"] == 2 * 16 * 4
    assert rec["gather"]["total_bytes"] == 2 * 16 * 4
    assert rec["reduce"]["counts"] == {"all-gather": 0, "all-reduce": 1,
                                       "reduce-scatter": 0, "all-to-all": 0,
                                       "collective-permute": 0}
    assert rec["reduce"]["bytes"]["all-reduce"] == 8 * 16 * 4
    assert rec["a2a"]["counts"]["all-to-all"] == 1
    assert rec["a2a"]["bytes"]["all-to-all"] == 2 * 16 * 4


@pytest.mark.parametrize("num_layers", [2, 3])
def test_run_cell_modes_agree_on_a_small_mesh(num_layers, tmp_path):
    """qwen2-1.5b-smoke's train step on a fake 2 x 4 mesh: the
    extrapolated totals (1- and 2-layer traces) equal the full trace's,
    exactly, and the records land where the report reads them."""
    out = _run(f"""
    import json
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh((2, 4))
    kw = dict(mesh=mesh, results={str(tmp_path)!r}, num_layers={num_layers})
    a = dryrun.run_cell("qwen2-1.5b-smoke", "train_4k", **kw)
    b = dryrun.run_cell("qwen2-1.5b-smoke", "train_4k", unroll=True, **kw)
    print(json.dumps([a, b]))
    """, timeout=180)
    a, b = json.loads(out[-1])
    assert (a["mode"], b["mode"]) == ("extrapolated", "full_unroll")
    for k in ("flops_per_device", "bytes_per_device",
              "collective_bytes_per_device"):
        assert a[k] == b[k] > 0, k
    assert sum(a["collective_detail"].values()) == \
        a["collective_bytes_per_device"]
    assert a["devices"] == 8 and a["model"]["num_layers"] == num_layers
    mem = a["memory"]
    assert mem["argument_bytes"] == b["memory"]["argument_bytes"] > 0
    assert 0 < mem["alias_bytes"] < mem["argument_bytes"]
    assert mem["temp_bytes"] > 0
    saved = tmp_path / "mesh2x4" / "qwen2-1.5b-smoke__train_4k.json"
    assert json.loads(saved.read_text()) == a
    assert (tmp_path / "mesh2x4" /
            "qwen2-1.5b-smoke__train_4k__full.json").exists()


@pytest.mark.parametrize("arch", ["pixtral-12b-smoke",
                                  "musicgen-medium-smoke"])
def test_embeddings_cells_are_priced_like_their_tokens_twin(arch, tmp_path):
    """A vlm or audio config's prefill and decode cells on a fake 2 x 4
    mesh: each record is priced (not skipped) on its (B, S, d) and (B, 1,
    d) embeddings, and its FLOPs a device equal those of the same config
    on tokens (the lookup is a gather: no arithmetic), its bytes fewer
    (no index and table rows to read)."""
    out = _run(f"""
    import dataclasses, json
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh((2, 4))
    recs = []
    for shape in ("prefill_32k", "decode_32k"):
        rec = dryrun.run_cell({arch!r}, shape, mesh=mesh,
                              results={str(tmp_path)!r}, num_layers=2)
        twin = dataclasses.replace(get_config({arch!r}), num_layers=2,
                                   input_kind="tokens")
        rules = dryrun._RULES_BY_KIND[SHAPES[shape].kind]
        cost, _, _ = dryrun._trace_once(twin, SHAPES[shape], mesh, rules)
        recs.append([rec, cost["flops"], cost["bytes"]])
    print(json.dumps(recs))
    """, timeout=180)
    for (rec, twin_flops, twin_bytes), kind in zip(json.loads(out[-1]),
                                                   ("prefill", "decode")):
        assert "skipped" not in rec
        assert rec["kind"] == kind and rec["devices"] == 8
        assert rec["flops_per_device"] == twin_flops > 0
        # the twin's lookup reads its index and the table's rows
        assert 0 < rec["bytes_per_device"] < twin_bytes


def _write(root, mesh, name, rec):
    d = root / "dryrun" / mesh
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{name}.json").write_text(json.dumps(rec))


def test_report_tables_over_written_records(tmp_path):
    rec = dict(_rec(), arch="qwen2-1.5b", shape="train_4k",
               compile_seconds=12.3,
               memory={"argument_bytes": 2e9, "output_bytes": 2e9,
                       "temp_bytes": 5e9, "alias_bytes": 2e9})
    _write(tmp_path, "pod256", "qwen2-1.5b__train_4k", rec)
    _write(tmp_path, "pod256", "qwen2-1.5b__train_4k__full", rec)
    _write(tmp_path, "pod256", "qwen2-1.5b__long_500k",
           {"arch": "qwen2-1.5b", "shape": "long_500k", "mesh": "pod256",
            "skipped": True, "reason": "long_500k reserved"})
    rows = load("pod256", include_skips=True, results=tmp_path)
    assert len(rows) == 2
    md = markdown_table(rows)
    assert "| qwen2-1.5b | train_4k |" in md and "**memory**" in md
    assert "SKIP: long_500k reserved" in md
    table = report.dryrun_table(tmp_path)
    assert table.count("| qwen2-1.5b |") == 2
    assert "| 12 | 1.00e+13 | 1.00e+12 | 1.00e+10 | 5.00 | 2.00 |" in table
    out = tmp_path / "tables.md"
    report.main(["--results", str(tmp_path), "--out", str(out)])
    assert "## Dry run" in out.read_text()
