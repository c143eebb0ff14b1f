"""The hybrid LM slice through the port's runtime, on hymba-1.5B smoke (fp32,
2 layers, B=2, S=8 and a ragged S=13 under the smoke sliding window of 16)
with the JAX package's weights carried across: the same program and image
bytes from the port's compiler, the same logits from the port's linked and
interpreted executors on the JAX bytes with the port's own GRAPH_EXEC
artifacts attached (atol 5e-4, as tests/test_conformance.py holds the JAX
runtime), the Mamba branch's stages against the JAX package's, and a served
request through the port's InferenceServer."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.core import rbl as jax_rbl
from repro.core import rctc as jax_rctc
from repro.core import rimfs as jax_rimfs
from repro.core.executor import Executor as JaxExecutor
from repro.models import mamba as jax_mamba
from repro.models import transformer as jax_tf
from repro.models.common import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.core import rbl, rctc, rimfs
from repro_torch.core.executor import Executor
from repro_torch.core.rcb import Op, RCBProgram
from repro_torch.core.rtpm import Platform
from repro_torch.kernels.ssm_scan import ops as ss_ops
from repro_torch.models import mamba
from repro_torch.models import transformer as tf
from repro_torch.serving.server import Client, InferenceServer

B = 2
ATOL = 5e-4                                   # tests/test_conformance.py:700
NAME = "hymba-1.5b-smoke"


def _configs(dtype):
    return (dataclasses.replace(jax_get_config(NAME), dtype=dtype),
            dataclasses.replace(get_config(NAME), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _jax_params(dtype):
    jcfg, _ = _configs(dtype)
    return jax_init_params(jax.random.PRNGKey(0), jax_tf.model_specs(jcfg))


@functools.lru_cache(maxsize=None)
def _carry(dtype, seq):
    """JAX program and image, the port's from the same weights, and one
    request's inputs."""
    jcfg, cfg = _configs(dtype)
    jparams = _jax_params(dtype)
    jprog, jimage = jax_rctc.compile_transformer_block(jcfg, jparams, B, seq)
    params = tf.params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                                device="cpu")
    prog, image = rctc.compile_transformer_block(cfg, params, B, seq)
    tokens = np.random.RandomState(seq).randint(0, cfg.vocab_size, (B, seq))
    glob, _ = tf.split_params(params)
    inputs = {"hidden": tf.embed_inputs(cfg, glob, tokens),
              "positions": np.broadcast_to(
                  np.arange(seq, dtype=np.int32)[None], (B, seq)).copy()}
    return dict(cfg=cfg, jprog=jprog, jimage=jimage, prog=prog, image=image,
                params=params, inputs=inputs)


def _bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_specs_and_params_carry_across(dtype):
    jcfg, cfg = _configs(dtype)
    jspecs, specs = jax_tf.model_specs(jcfg), tf.model_specs(cfg)
    assert sorted(specs) == sorted(jspecs)
    for k, s in specs.items():
        assert (s.shape, s.dtype, s.init, s.scale) == \
            (jspecs[k].shape, jspecs[k].dtype, jspecs[k].init,
             jspecs[k].scale), k
    for name, t in _carry(dtype, 8)["params"].items():
        assert _bits(t).tobytes() == \
            np.asarray(_jax_params(dtype)[name]).tobytes(), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq", [8, 13])
def test_compiler_emits_the_jax_program_and_image_bytes(seq, dtype):
    carried = _carry(dtype, seq)
    assert carried["prog"].encode() == carried["jprog"].encode()
    assert carried["prog"].encode(version=1) == \
        carried["jprog"].encode(version=1)
    assert carried["image"] == carried["jimage"]
    # the glue rides as artifacts under the JAX package's ids
    assert sorted(carried["prog"].artifacts) == \
        sorted(carried["jprog"].artifacts) == \
        sorted(f"L{li}.ssm_{s}" for li in range(2) for s in ("pre", "post"))
    kinds = [op.op for blk in carried["prog"].blocks for op in blk.ops]
    assert kinds.count(Op.SSM_SCAN) == kinds.count(Op.ATTENTION) == 2
    assert kinds.count(Op.SCALE_SHIFT) == 2


def _jax_logits(carried):
    fs = jax_rimfs.mount(carried["jimage"])
    ins = {"hidden": carried["inputs"]["hidden"].numpy(),
           "positions": carried["inputs"]["positions"]}
    out = JaxExecutor().run(jax_rbl.bind(carried["jprog"], rimfs=fs,
                                         inputs=ins))["logits"]
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("seq", [8, 13])
def test_port_runs_the_jax_bytes_like_jax(seq):
    carried = _carry("float32", seq)  # bf16 rounds at other places in the two
    prog = RCBProgram.decode(carried["jprog"].encode())
    prog.artifacts.update(carried["prog"].artifacts)
    fs = rimfs.mount(carried["jimage"])
    ex = Executor(device="cpu")
    bound = rbl.bind(prog, rimfs=fs, driver=ex.driver)
    linked = ex.run(bound, inputs=carried["inputs"])["logits"]
    interp = ex.run_interpreted(bound, inputs=carried["inputs"])["logits"]
    assert linked.dtype == torch.float32
    assert tuple(linked.shape) == (B, seq, carried["cfg"].vocab_size)
    assert torch.equal(linked, interp)
    np.testing.assert_allclose(linked.numpy(), _jax_logits(carried),
                               rtol=0, atol=ATOL)


def test_jax_bytes_without_the_artifacts_fail_at_link_time():
    carried = _carry("float32", 8)
    prog = RCBProgram.decode(carried["jprog"].encode())
    ex = Executor(device="cpu")
    bound = rbl.bind(prog, rimfs=rimfs.mount(carried["jimage"]),
                     driver=ex.driver)
    with pytest.raises(KeyError, match="L0.ssm_pre.*not attached"):
        ex.run(bound, inputs=carried["inputs"])


def test_platform_bind_attaches_artifacts_and_plain_kernels_agree():
    """Provision the bytes, attach the artifacts at bind, run: linked,
    interpreted and the program with ``impl="ref"`` on every kernel op
    agree bit for bit on the CPU."""
    carried = _carry("float32", 8)
    plat = Platform(device="cpu")
    plat.provision(image=carried["image"],
                   program_bytes=carried["prog"].encode())
    bound = plat.bind(artifacts=carried["prog"].artifacts)
    ex = Executor(driver=plat.driver)
    out = ex.run(bound, inputs=carried["inputs"])["logits"]
    assert torch.equal(out, ex.run_interpreted(
        bound, inputs=carried["inputs"])["logits"])
    plain = RCBProgram.decode(carried["prog"].encode())
    plain.artifacts.update(carried["prog"].artifacts)
    for blk in plain.blocks:
        for op in blk.ops:
            if op.op in (Op.ATTENTION, Op.SSM_SCAN):
                op.attrs["impl"] = "ref"
    plain_out = ex.run(rbl.bind(plain, rimfs=plat.rimfs, driver=plat.driver),
                       inputs=carried["inputs"])["logits"]
    assert torch.equal(out, plain_out)
    assert torch.isfinite(out).all()


def _layer0(dtype="float32"):
    jpl = {k: v[0] for k, v in _jax_params(dtype).items()
           if k.startswith("m_")}
    pl = {k: torch.from_numpy(np.asarray(v)) for k, v in jpl.items()}
    return jpl, pl


def test_ssm_kernel_inputs_and_ssm_output_match_jax(rng):
    jcfg, cfg = _configs("float32")
    jpl, pl = _layer0()
    x = rng.randn(B, 11, cfg.d_model).astype(np.float32)
    want = jax_mamba.ssm_kernel_inputs(jcfg, jpl, jnp.asarray(x))
    got = mamba.ssm_kernel_inputs(cfg, pl, torch.from_numpy(x))
    assert len(got) == len(want) == 5
    for name, g, w in zip(("da", "bx", "c", "u", "z"), got, want):
        assert tuple(g.shape) == w.shape, name
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5, err_msg=name)
    assert (got[0] <= 0).all()                     # log-decay
    y = rng.randn(B, 11, cfg.d_model).astype(np.float32)
    u, z = np.asarray(want[3]), np.asarray(want[4])
    want_o = jax_mamba.ssm_output(jcfg, jpl, jnp.asarray(y), jnp.asarray(u),
                                  jnp.asarray(z), jnp.float32)
    got_o = mamba.ssm_output(cfg, pl, *(torch.from_numpy(a)
                                        for a in (y, u, z)), torch.float32)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=0,
                               atol=1e-5)


def test_mamba_mix_with_h0_matches_jax_kernel_route(monkeypatch, rng):
    """h0 folded into step 0's input and the closed-form final state, as
    ``AEG_SSM_IMPL=kernel`` routes the JAX package (test_conformance.py
    test_mamba_routes_through_ssm_kernel)."""
    jcfg, cfg = _configs("float32")
    jpl, pl = _layer0()
    x = rng.randn(B, 12, cfg.d_model).astype(np.float32)
    h0 = rng.randn(B, cfg.d_model, cfg.ssm_state).astype(np.float32)
    monkeypatch.setenv("AEG_SSM_IMPL", "kernel")
    y_j, h_j = jax_mamba.mamba_mix(jcfg, jpl, jnp.asarray(x),
                                   jnp.asarray(h0))
    before = ss_ops.ssm_scan.launches
    y, h = mamba.mamba_mix(cfg, pl, torch.from_numpy(x), torch.from_numpy(h0))
    assert ss_ops.ssm_scan.launches == before       # CPU: the plain version
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=0, atol=5e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), rtol=0, atol=5e-5)


def test_uniform_init_kind():
    cfg = get_config(NAME)
    p = tf.init_params(cfg, 0, device="cpu")
    again = tf.init_params(cfg, 0, device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)     # seeded
    a = p["m_alog"]
    assert a.dtype == torch.float32
    assert a.abs().max() <= 1.0 and a.std() > 0.4         # U(-1, 1): 0.577
    assert torch.equal(p["m_d"], torch.ones_like(p["m_d"]))
    assert torch.equal(p["m_dt_b"], torch.zeros_like(p["m_dt_b"]))


def _serve(carried, artifacts, requests):
    server = InferenceServer(device="cpu", artifacts=artifacts)
    client = Client(server.start())
    try:
        assert client.provision(carried["image"], carried["prog"].encode()) \
            == {"status": "ready"}
        return [client.infer(**r)["logits"] for r in requests]
    finally:
        client.close()
        server.stop()


def test_served_hybrid_request_equals_a_local_run():
    carried = _carry("float32", 13)
    got = _serve(carried, carried["prog"].artifacts, [carried["inputs"]])[0]
    plat = Platform(device="cpu")
    plat.provision(image=carried["image"],
                   program_bytes=carried["prog"].encode())
    ex = Executor(driver=plat.driver)
    want = ex.run(plat.bind(artifacts=carried["prog"].artifacts),
                  inputs=carried["inputs"])["logits"]
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert np.array_equal(got, want.numpy())


def test_served_hybrid_request_without_artifacts_is_an_error():
    carried = _carry("float32", 8)
    with pytest.raises(RuntimeError, match="not attached"):
        _serve(carried, None, [carried["inputs"]])
