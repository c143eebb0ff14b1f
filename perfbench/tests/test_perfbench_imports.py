"""The import guard: a run of the harness loads neither JAX nor the JAX
package ``repro`` (names compared whole, by the part before the first
dot: the port's name ``repro_torch`` begins with ``repro``), the reference
imports nothing of the program, and without a card the command fails
with no result line."""
import ast
import json
import subprocess
import sys

from perfbench.spec import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

PROBE = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}, {tests!r}]
import pathlib, tempfile
import conftest
from perfbench import harness, control
root = conftest.make_tiny_root(pathlib.Path(tempfile.mkdtemp()))
out = harness.run("tiny.dense", 3, 1.0, True, device="cpu", root=root)
print(json.dumps({{"correct": out["correct"],
                  "tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_a_run_loads_no_jax_and_no_reference_package(tmp_path):
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"),
                        tests=str(HERE / "tests"))
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
           "TMPDIR": str(tmp_path)}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=env, cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert "repro_torch" in got["tops"]
    assert not FORBIDDEN & set(got["tops"]), FORBIDDEN & set(got["tops"])


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").glob("*.py")):
        tops = _imports(path)
        assert not tops & (FORBIDDEN | {"repro_torch"}), (path.name, tops)
    text = (HERE / "reference" / "__init__.py").read_text()
    assert "perfbench.reference." in text and "repro_torch" not in text


def test_no_harness_file_imports_jax():
    for path in sorted(HERE.rglob("*.py")):
        assert not _imports(path) & FORBIDDEN, path


def test_without_a_card_the_command_fails_with_no_result(tmp_path):
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                        "nemo.chat", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=300, cwd=ROOT,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                            "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
