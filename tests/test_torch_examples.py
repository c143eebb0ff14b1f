"""The port's examples on the CPU, each in a subprocess with
``--device cpu``: the quickstart's linked and fused runs agree (``OK``),
and the elastic restart resumes from its checkpoint bit for bit."""
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _run(script, *argv):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                           *argv], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.splitlines()


def test_quickstart_runs_on_the_cpu():
    out = _run("torch_quickstart.py", "--device", "cpu")
    assert "linked == fused: max|diff| = 0.00e+00" in out
    assert out[-1] == "OK — same RCBs drive both execution environments."


def test_elastic_restart_is_bit_exact_on_the_cpu(tmp_path):
    out = _run("torch_elastic_restart.py", "--device", "cpu", "--ckpt-dir",
               str(tmp_path / "ckpt"))
    assert "RTPM verdict: failed=['w2']" in out
    assert "restored step 10; " in out[3]
    assert "max param diff vs uninterrupted run: 0.00e+00" in out
    assert out[-1] == ("OK — failure detected, restart bit-exact, fleet "
                       "shrunk 4 -> 3.")


def test_serve_resnet18_matches_the_local_oracle_on_the_cpu():
    out = _run("torch_serve_resnet18.py", "3", "--device", "cpu")
    assert out[-1] == "responses matching local oracle: 3/3"
