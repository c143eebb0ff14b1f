"""Find a cell's configuration, traffic mix and metric readers by name.

``BENCHMARK.json`` at the checkout's root names the cells; everything else a
cell needs sits in files under this folder, looked up by the names the
cell gives, so a later change adds a configuration, a mix, a metric or a
cell by adding files and entries only.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# The published keys of a configuration file and the port's ModelConfig
# fields they must equal (a key the file lacks is not compared).
WIDTH_KEYS = {
    "num_hidden_layers": "num_layers",
    "hidden_size": "d_model",
    "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads",
    "head_dim": "head_dim",
    "intermediate_size": "d_ff",
    "vocab_size": "vocab_size",
    "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps",
    "layer_norm_epsilon": "norm_eps",
    "head_size": "rwkv_head_dim",
    "torch_dtype": "dtype",
    "tie_word_embeddings": "tie_embeddings",
}


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with what it names, loaded."""
    name: str
    workload: dict          # the BENCHMARK.json entry
    config: dict            # the configuration file
    traffic: dict           # the traffic file
    root: Path


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json; raises KeyError for
    a name it does not hold."""
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({', '.join(sorted(work))})")
    w = work[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / entry["file"]) as f:
        config = json.load(f)
    return Cell(name=name, workload=w, config=config,
                traffic=load_traffic(w["traffic"], root), root=root)


def load_traffic(name: str, root: Path = ROOT) -> dict:
    with open(root / "perfbench" / "traffic" / f"{name}.json") as f:
        return json.load(f)


def metrics_for(cell: Cell, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: the end-to-end ones
    untraced, the per-layer ones traced; an entry with a ``workloads`` list
    only in the cells it names."""
    bench = load_benchmark(cell.root)
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell.name in m["workloads"]]


def load_reader(name: str, root: Path = ROOT):
    """The reader module ``perfbench/metrics/<name>.py``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_config(config: dict):
    """The port's registered ``ModelConfig`` that the file names
    (``port.config``); raises ValueError where a published key of the
    file differs from it."""
    from repro_torch.configs import get_config
    port = config["port"]
    cfg = get_config(port["config"])
    wrong = {k: (config[k], getattr(cfg, f))
             for k, f in WIDTH_KEYS.items()
             if k in config and config[k] != getattr(cfg, f)}
    if wrong:
        raise ValueError(f"{port['config']}: the file's sizes differ from "
                         f"the port's (file, port): {wrong}")
    return cfg
