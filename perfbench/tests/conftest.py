"""A checkout of the benchmark in a temporary folder with tiny cells added
as new files (a configuration, a mix, a limit, a metric and the cells),
which the harness finds by name and runs on the CPU. The tiny configurations are the
port's fp32 smoke configs: the program then reads a gap of nearly 0
against the fp32 reference, and the float8 control and the planted faults
read far above the tiny cells' limit."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "tiny-dense": {
        "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 128,
        "vocab_size": 256, "rope_theta": 1000000.0, "rms_norm_eps": 1e-05,
        "torch_dtype": "float32", "tie_word_embeddings": False,
        "reference": "dense",
        "port": {"config": "mistral-nemo-12b-smoke",
                 "engine": "ServingEngine", "max_batch": 4, "max_seq": 128}},
    "tiny-rwkv6": {
        "hidden_size": 64, "num_hidden_layers": 2, "head_size": 16,
        "intermediate_size": 128, "vocab_size": 256,
        "layer_norm_epsilon": 1e-05, "torch_dtype": "float32",
        "tie_word_embeddings": False, "reference": "rwkv6",
        "port": {"config": "rwkv6-1.6b-smoke",
                 "engine": "ServingEngine", "max_batch": 4, "max_seq": 256}},
}
MIX = {"loop": "closed", "clients": 4, "sizes_per_client": 3,
       "prompt_len": {"dist": "uniform", "min": 8, "max": 40},
       "max_new": {"dist": "uniform", "min": 4, "max": 12},
       "sizes_seed": 0, "profile_seconds": 1,
       "check": {"min_tokens": 40, "max_requests": 4}}


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


def make_tiny_root(tmp_path: Path) -> Path:
    """A copy of BENCHMARK.json and perfbench/ with cells ``tiny.dense``
    and ``tiny.rwkv6`` and a metric ``tiny_prefills`` (traced runs of those
    cells) added as files and entries only."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, cfg in TINY.items():
        f = f"perfbench/configs/{name}.json"
        (root / f).write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test", "file": f,
                                 "reduced": [], "why": "test"})
    (root / "perfbench/traffic/tiny.json").write_text(json.dumps(MIX))
    for cell, cfg in (("tiny.dense", "tiny-dense"),
                      ("tiny.rwkv6", "tiny-rwkv6")):
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": "tiny", "chips": 1,
                                   "why": "test"})
        (root / f"perfbench/limits/{cell}.json").write_text(json.dumps(
            {"logit_gap": 0.01, "min_checked_tokens": 20}))
    (root / "perfbench/metrics/tiny_prefills.py").write_text(
        "def read(rec):\n    return len(rec.prefills) or None\n")
    bench["per_layer"].append({"name": "tiny_prefills", "unit": "prefills",
                               "better": "higher", "source": "program_span",
                               "layer": "model step",
                               "moves": "output_tokens_per_s",
                               "workloads": ["tiny.dense", "tiny.rwkv6"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
