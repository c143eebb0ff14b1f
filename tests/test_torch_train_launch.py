"""The training entry point, ``python -m repro_torch.launch.train``, on the
CPU: it runs, writes checkpoints and logs the JAX driver's lines, and on
relaunch restores the latest checkpoint and says so; driven in-process
through ``main(argv)``, a run restarted from its step-20 checkpoint ends
on the uninterrupted run's parameters and moments bit for bit."""
import os
import pathlib
import shutil
import subprocess
import sys

import torch

from repro_torch.checkpoint.ckpt import _flatten
from repro_torch.launch import train

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
SMOKE = ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu"]


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *args], cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_entry_point_writes_checkpoints_and_restarts(tmp_path):
    args = SMOKE + ["--steps", "20", "--ckpt-dir", "ck", "--ckpt-every",
                    "10", "--log-every", "5"]
    out = _run(args, tmp_path)
    lines = out.splitlines()
    assert lines[0].startswith("[train] qwen2-1.5b-smoke: ")
    steps = [ln for ln in lines if ln.startswith("  step ")]
    assert [int(ln.split()[1]) for ln in steps] == [5, 10, 15, 20]
    assert all("loss=" in ln and "lr=" in ln and "gnorm=" in ln
               for ln in steps)
    assert lines[-1].startswith("[train] done. step latency mean=")
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "ckpt_00000010.rimfs", "ckpt_00000020.rimfs"]

    out = _run(SMOKE + ["--steps", "25", "--ckpt-dir", "ck",
                        "--log-every", "5"], tmp_path)
    assert "[train] restored checkpoint at step 20" in out
    steps = [ln for ln in out.splitlines() if ln.startswith("  step ")]
    assert [int(ln.split()[1]) for ln in steps] == [25]
    assert "ckpt_00000025.rimfs" in os.listdir(tmp_path / "ck")


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_main_restart_from_step_20_is_bit_exact(tmp_path):
    """The chip's ``slice_train`` at the smoke size: 30 steps with a
    checkpoint at 20, then a second run in a directory holding only that
    checkpoint, which restores it and runs steps 21 to 30."""
    args = SMOKE + ["--steps", "30", "--seq-len", "32", "--batch", "8",
                    "--ckpt-every", "20", "--log-every", "10"]
    full = train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    assert full["start"] == 0 and sorted(full["losses"]) == list(
        range(1, 31))
    assert [s["step"] for s in full["saves"]] == [20, 30]
    (tmp_path / "b").mkdir()
    shutil.copy(tmp_path / "a" / "ckpt_00000020.rimfs", tmp_path / "b")
    again = train.main(args + ["--ckpt-dir", str(tmp_path / "b")])
    assert again["start"] == 20 and sorted(again["losses"]) == list(
        range(21, 31))
    assert again["restore_s"] is not None
    for k in range(21, 31):
        assert again["losses"][k] == full["losses"][k], k
    want = _flatten({"params": full["params"], "opt": full["opt"]})
    got = _flatten({"params": again["params"], "opt": again["opt"]})
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(_bits(got[k]), _bits(want[k])), k
