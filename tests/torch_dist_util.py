"""Run a function body on n ``gloo`` ranks (one process each) or the JAX
package with 8 host devices, each in a subprocess with its own time limit,
and hand back what rank 0 (or the JAX script) saved."""
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np

REPO_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")

_SPAWN = '''
import os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def body(rank, n, out):
{body}


def main(rank, n, port, out):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}",
                            rank=rank, world_size=n)
    try:
        body(rank, n, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    n, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    mp.spawn(main, args=(n, port, out), nprocs=n)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(cmd, env, timeout):
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       timeout=timeout)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return r


def run_ranks(body: str, tmp_path, n: int = 8, timeout: int = 120) -> dict:
    """Run ``body`` (the source of ``body(rank, n, out)``, indented by 0)
    on ``n`` gloo ranks of a fresh process group; rank 0 saves arrays with
    ``np.savez(out, ...)``. Returns what it saved."""
    script = tmp_path / "ranks.py"
    script.write_text(_SPAWN.format(body=textwrap.indent(
        textwrap.dedent(body), "    ")))
    out = tmp_path / "ranks.npz"
    env = dict(os.environ, PYTHONPATH=REPO_SRC, OMP_NUM_THREADS="1")
    _run([sys.executable, str(script), str(n), str(_free_port()), str(out)],
         env, timeout)
    return dict(np.load(out))


def run_jax8(script: str, tmp_path, timeout: int = 120) -> dict:
    """Run ``script`` with the JAX package on 8 forced host devices; it
    saves arrays with ``np.savez(OUT, ...)``. Returns what it saved."""
    out = tmp_path / "jax.npz"
    path = tmp_path / "jax8.py"
    path.write_text(f"OUT = {str(out)!r}\n" + textwrap.dedent(script))
    env = dict(os.environ, PYTHONPATH=REPO_SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    _run([sys.executable, str(path)], env, timeout)
    return dict(np.load(out))
