"""BENCHMARK.json against the files it names: each configuration's sizes
equal the port's registered configuration, and every cell, mix, limit and
metric reader exists under its name."""
import json
import re

import pytest

from perfbench import reference, spec, traffic

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_equals_the_port(entry):
    config = json.loads((spec.ROOT / entry["file"]).read_text())
    cfg = spec.port_config(config)          # raises where a size differs
    assert config["source"] == entry["source"]
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:            # a cut names a key of the file
        assert NAME.match(key) and key in config, key
        assert not key.endswith(("_dim", "_rank", "_size")), key
    ref = reference.module(config)          # found by name, as a file
    assert callable(ref.logits) and callable(ref.prefill_flops) \
        and callable(ref.decode_flops)
    for key in spec.WIDTH_KEYS:
        if key in config:
            assert config[key] == getattr(cfg, spec.WIDTH_KEYS[key])


def test_a_changed_width_is_refused():
    entry = BENCH["configs"][0]
    config = json.loads((spec.ROOT / entry["file"]).read_text())
    config["hidden_size"] += 128
    with pytest.raises(ValueError, match="differ"):
        spec.port_config(config)


@pytest.mark.parametrize("work", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_exist_and_fit(work):
    cell = spec.load_cell(work["name"])
    assert work["chips"] in (1, 4)
    assert len(work["why"]) <= 200
    limits = json.loads((spec.HERE / "limits" / f"{work['name']}.json")
                        .read_text())
    assert 0 < limits["logit_gap"]
    cfg = spec.port_config(cell.config)
    mix = traffic.ClosedLoop(cell.traffic, 1, cfg.vocab_size)
    assert mix.longest() < cell.config["port"]["max_seq"]
    assert mix.clients <= cell.config["port"]["max_batch"]
    for m in spec.metrics_for(cell, False) + spec.metrics_for(cell, True):
        assert callable(spec.load_reader(m["name"]).read)


def test_names_units_and_moves():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    names = [c["name"] for c in BENCH["configs"]] + sorted(cells) \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    assert json.dumps(BENCH).encode().__len__() < 64 * 1024
