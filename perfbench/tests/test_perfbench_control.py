"""The control: the reference one precision step below the configuration's
(float8 for bfloat16), put in the program's place, comes out as not
correct, while the program comes out correct. On the CPU at the tiny
cells; on the card (``gpu``, skips without one) at a cell's own size:

    python -m pytest -q -m gpu perfbench/tests/test_perfbench_control.py
"""
import json

import pytest
import torch

from perfbench import control
from perfbench.spec import HERE


@pytest.mark.parametrize("cell", ["tiny.dense", "tiny.rwkv6"])
def test_control_fails_where_the_program_passes(tiny_root, cell):
    limit = json.loads((tiny_root / "perfbench" / "limits" /
                        f"{cell}.json").read_text())["logit_gap"]
    for seed in (1, 2, 3):
        r = control.readings(cell, seed, 1.0, True, device="cpu",
                             root=tiny_root)
        assert r["tokens"] >= 20
        assert r["program_gap"] < limit < r["control_gap"], r


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["nemo.chat", "nemo.rag", "rwkv6.longdoc"])
def test_control_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's size")
    limit = json.loads((HERE / "limits" / f"{cell}.json").read_text())
    r = control.readings(cell, 2**31 + 1, 5.0, True)
    assert r["program_gap"] < limit["logit_gap"] < r["control_gap"], r
