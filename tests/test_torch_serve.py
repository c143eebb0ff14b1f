"""The port's serving entry point (``repro_torch.launch.serve``) on the CPU
against the JAX package: ResNet-18 served over the wire from the JAX
package's program and image bytes (every reply within 1e-5 of the JAX
``Executor.run`` of the same bytes), ``serve_lm``'s greedy tokens against
the JAX ``ServingEngine``'s from the same parameters, ``serve_fleet`` with
no mismatch over the JAX package's GEMM chain bytes, and the CLI in a
subprocess (it runs on the card by default and raises without one)."""
import functools
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.resnet18 import CONFIG as JAX_RESNET
from repro.core import rctc as jax_rctc
from repro.core import rimfs as jax_rimfs
from repro.core.executor import Executor as JaxExecutor
from repro.core.rtpm import Platform as JaxPlatform
from repro.models import resnet as jax_rn
from repro.models import transformer as jax_tf
from repro.models.common import init_params as jax_init_params
from repro.serving import engine as jax_engine
from repro.serving.scheduler import DeadlineScheduler as JaxScheduler
from repro_torch.configs import get_config
from repro_torch.configs.resnet18 import CONFIG as RESNET
from repro_torch.core.rcb import RCBProgram
from repro_torch.launch import serve
from repro_torch.models import transformer as tf

ROOT = pathlib.Path(__file__).resolve().parent.parent
RESNET_TOL = 1e-5                 # test_resnet_rcb.py:31


@functools.lru_cache(maxsize=None)
def _jax_resnet(batch):
    cfg = JAX_RESNET.smoke()
    params = jax_rn.init_resnet(jax.random.PRNGKey(0), cfg)
    prog, image = jax_rctc.compile_resnet18(cfg, jax_rn.fold_bn(params),
                                            batch=batch)
    return prog.encode(), image


def _jax_run(prog_bytes, image, inputs) -> dict:
    plat = JaxPlatform()
    plat.provision(image=image, program_bytes=prog_bytes)
    out = JaxExecutor(rtpm=plat).run(plat.bind(inputs=inputs))
    return {k: np.asarray(v) for k, v in out.items()}


def test_served_resnet18_on_jax_bytes_matches_jax_executor():
    """2 clients, pipeline 2, batch 2: every reply of the port's server,
    provisioned with the JAX package's bytes, within 1e-5 of the JAX
    Executor's run of the same bytes on the same images."""
    program = _jax_resnet(2)
    got = serve.serve_resnet(5, 2, 2, 2, cfg=RESNET.smoke(), program=program,
                             device="cpu", keep_replies=True)
    assert got["requests"] == 5
    assert [len(r) for r in got["replies"]] == [3, 2]
    assert len(got["latencies_s"]) == 5
    for cid, replies in enumerate(got["replies"]):
        rng = np.random.RandomState(cid)
        for inputs, out in replies:
            x = rng.rand(2, 32, 32, 3).astype(np.float32)
            assert np.array_equal(inputs["input"], x)
            want = _jax_run(*program, inputs)
            assert out.keys() == want.keys()
            for k in want:
                assert out[k].shape == want[k].shape
                np.testing.assert_allclose(out[k], want[k], rtol=RESNET_TOL,
                                           atol=RESNET_TOL)
    serving = got["telemetry"]["serving"]
    assert serving["rejected"] == 0 and serving["shed"] == 0


def test_resnet_program_compiles_at_the_batch_asked():
    """The port's own build of the served program (its weights are the
    port's draw, so its bytes are not the JAX package's)."""
    prog_bytes, image = serve.resnet_program(RESNET.smoke(), batch=3,
                                             device="cpu")
    prog = RCBProgram.decode(prog_bytes)
    assert prog.tensors["input"].shape == (3, 32, 32, 3)
    assert len(image) > 0


def test_serve_lm_tokens_equal_jax_engine():
    jcfg, cfg = jax_get_config(serve.LM_CONFIG), get_config(serve.LM_CONFIG)
    jp = jax_init_params(jax.random.PRNGKey(0), jax_tf.model_specs(jcfg))
    params = tf.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                                device="cpu")
    got = serve.serve_lm(6, cfg=cfg, params=params, device="cpu")
    eng = jax_engine.ServingEngine(jcfg, jp, max_batch=4,
                                   max_seq=serve.LM_MAX_SEQ,
                                   scheduler=JaxScheduler())
    reqs = [jax_engine.Request(rid=i, prompt=p, max_new=serve.LM_MAX_NEW)
            for i, p in enumerate(serve.lm_prompts(cfg, 6))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert got["tokens"] == [list(r.out_tokens) for r in reqs]
    assert all(len(t) == serve.LM_MAX_NEW + 1 for t in got["tokens"])
    assert got["shed"] == 0


def test_serve_fleet_no_mismatch_on_jax_chain_bytes():
    """The port's GEMM chain bytes equal the JAX package's; served from
    the JAX package's, the fleet demo scales 2 -> 4 -> 2, swaps and heals
    with no mismatch, and its reference reply is the JAX Executor's within
    1e-5."""
    d, n = serve.CHAIN_DEPTH, serve.CHAIN_N
    want = (jax_rctc.compile_gemm_chain(d, n).encode(),
            jax_rimfs.pack(jax_rctc.gemm_chain_weights(d, n)))
    assert serve.gemm_chain_program() == want
    got = serve.serve_fleet(16, groups=2, peak=4, program=want,
                            device="cpu")
    assert got["mismatched"] == 0 and got["ok"] == 16
    assert [(s["from"], s["to"]) for s in got["scales"]] == [(2, 4), (4, 2)]
    assert got["scales"][1]["cached_mesh"] is True
    assert got["swap"] == "committed"
    assert got["heal"][0] == "replace"
    ref = _jax_run(*want, {"input": got["input"]})
    for k, v in ref.items():
        np.testing.assert_allclose(got["reference"][k], v, rtol=RESNET_TOL,
                                   atol=RESNET_TOL)


def _cli(*argv):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *argv], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)


def test_cli_serves_on_the_cpu_when_asked():
    proc = _cli("--device", "cpu", "--requests", "4", "--batch", "1",
                "--clients", "2", "--pipeline", "2")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[serve] 4 requests x batch 1 over 2 client(s)" in proc.stdout
    assert "rejected=0 shed=0" in proc.stdout


def test_cli_without_a_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    proc = _cli("--requests", "4", "--batch", "1")
    assert proc.returncode != 0
    assert "CUDA requested" in proc.stderr
    with pytest.raises(RuntimeError, match="CUDA requested"):
        serve.main(["--requests", "1"])


def test_cli_takes_the_jax_drivers_flags_and_device_and_seed():
    args = serve.parse_args([
        "--requests", "3", "--batch", "2", "--clients", "2", "--pipeline",
        "1", "--batch-window", "1", "--lm", "--fleet", "--groups", "3",
        "--peak", "5", "--device", "cpu", "--seed", "7"])
    assert vars(args) == {
        "requests": 3, "batch": 2, "clients": 2, "pipeline": 1,
        "batch_window": 1, "lm": True, "fleet": True, "groups": 3,
        "peak": 5, "device": "cpu", "seed": 7}
    assert vars(serve.parse_args([]))["device"] == "cuda"
