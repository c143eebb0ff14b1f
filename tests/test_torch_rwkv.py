"""The ssm LM slice (RWKV-6) through the port's runtime, on rwkv6-1.6B smoke
(fp32, 2 layers, d_model 64, 4 heads of 16, B=2, S=8 and a ragged S=13)
with the JAX package's weights carried across: the same program and image
bytes from the port's compiler, the same logits from the port's linked and
interpreted executors on the JAX bytes with the port's own GRAPH_EXEC
artifacts attached (atol 5e-4, as tests/test_conformance.py holds the JAX
runtime), the time and channel mixes against the JAX package's, and a
served request through the port's InferenceServer."""
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
from repro.models import common as jax_common
from repro.models import rwkv6 as jax_rwkv
from repro.models import transformer as jax_tf
from repro.models.common import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.core import rbl, rctc, rimfs
from repro_torch.core.executor import Executor
from repro_torch.core.rcb import Op, RCBProgram
from repro_torch.core.rtpm import Platform
from repro_torch.kernels.wkv6 import ops as wk_ops
from repro_torch.models import common, rwkv6
from repro_torch.models import transformer as tf
from repro_torch.serving.server import Client, InferenceServer

B = 2
ATOL = 5e-4                                   # tests/test_conformance.py:700
GLUE_ATOL = 1e-5
NAME = "rwkv6-1.6b-smoke"


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
    inputs = {"hidden": tf.embed_inputs(cfg, glob, tokens)}
    return dict(cfg=cfg, jprog=jprog, jimage=jimage, prog=prog, image=image,
                params=params, inputs=inputs)


def _bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_specs_and_params_carry_across(dtype):
    jcfg, cfg = _configs(dtype)
    jspecs, specs = jax_tf.model_specs(jcfg), tf.model_specs(cfg)
    assert sorted(specs) == sorted(jspecs)
    for k, s in specs.items():
        assert (s.shape, s.dtype, s.init, s.scale) == \
            (jspecs[k].shape, jspecs[k].dtype, jspecs[k].init,
             jspecs[k].scale), k
    assert not any(k.startswith(("wq", "mlp_")) for k in specs)
    for name, t in _carry(dtype, 8)["params"].items():
        assert _bits(t).tobytes() == \
            np.asarray(_jax_params(dtype)[name]).tobytes(), name


def test_full_config_specs_and_image_size():
    """rwkv6-1.6B: 32 heads of 64, fp32 decay base and bonus in a bf16
    model, and the image's tensor bytes counted from the specs."""
    cfg = get_config("rwkv6-1.6b")
    specs = tf.model_specs(cfg)
    assert specs["tm_u"].shape == (24, 32, 64)
    assert specs["tm_w0"].dtype == specs["tm_u"].dtype == "float32"
    assert specs["tm_wr"].dtype == "bfloat16"
    esize = {"float32": 4, "bfloat16": 2}
    nbytes = {k: int(np.prod(s.shape)) * esize[s.dtype]
              for k, s in specs.items()}
    image = sum(n for k, n in nbytes.items() if k != "embed")
    assert image == 2_899_742_720
    assert nbytes["lm_head"] == 268_435_456


def test_decay_init_kind():
    cfg = get_config(NAME)
    p = tf.init_params(cfg, 0, device="cpu")
    again = tf.init_params(cfg, 0, device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)     # seeded
    w0 = p["tm_w0"]
    assert w0.dtype == torch.float32
    assert w0.min() >= -6.0 and w0.max() <= -1.0           # -6 + 5 U(0, 1)
    assert abs(w0.mean().item() + 3.5) < 0.3 and w0.std() > 1.0
    assert p["tm_u"].dtype == torch.float32
    bf = tf.init_params(dataclasses.replace(cfg, dtype="bfloat16"), 0,
                        device="cpu")
    assert bf["tm_w0"].dtype == bf["tm_u"].dtype == torch.float32
    assert bf["tm_wr"].dtype == torch.bfloat16


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
        sorted(f"L{li}.{s}" for li in range(2)
               for s in ("tm_pre", "tm_post", "cm"))
    kinds = [op.op for blk in carried["prog"].blocks for op in blk.ops]
    assert kinds.count(Op.WKV6) == 2
    assert Op.ATTENTION not in kinds and Op.SSM_SCAN not in kinds
    assert "positions" not in carried["prog"].tensors


def _jax_logits(carried):
    fs = jax_rimfs.mount(carried["jimage"])
    ins = {"hidden": carried["inputs"]["hidden"].numpy()}
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
    with pytest.raises(KeyError, match="L0.tm_pre.*not attached"):
        ex.run(bound, inputs=carried["inputs"])


def test_platform_bind_attaches_artifacts_and_plain_kernels_agree():
    """Provision the bytes, attach the artifacts at bind, run: linked,
    interpreted and the program with ``impl="ref"`` on every WKV6 op agree
    bit for bit on the CPU."""
    carried = _carry("float32", 13)
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
            if op.op == Op.WKV6:
                op.attrs["impl"] = "ref"
    plain_out = ex.run(rbl.bind(plain, rimfs=plat.rimfs, driver=plat.driver),
                       inputs=carried["inputs"])["logits"]
    assert torch.equal(out, plain_out)
    assert torch.isfinite(out).all()


def _layer0(dtype="float32"):
    jpl = {k: v[0] for k, v in _jax_params(dtype).items()
           if k.startswith(("tm_", "cm_"))}
    pl = {k: torch.from_numpy(np.array(v)) for k, v in jpl.items()}
    return jpl, pl


def test_time_mix_pre_matches_jax(rng):
    jcfg, cfg = _configs("float32")
    jpl, pl = _layer0()
    x = rng.randn(B, 11, cfg.d_model).astype(np.float32)
    ts = rng.randn(B, cfg.d_model).astype(np.float32)
    want = jax_rwkv.time_mix_pre(jcfg, jpl, jnp.asarray(x), jnp.asarray(ts))
    got = rwkv6.time_mix_pre(cfg, pl, torch.from_numpy(x),
                             torch.from_numpy(ts))
    assert len(got) == len(want) == 5
    for name, g, w in zip(("r", "k", "v", "lw", "g"), got, want):
        assert tuple(g.shape) == w.shape, name
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=GLUE_ATOL, err_msg=name)
    lw = got[3]
    assert (lw <= -np.exp(-12.0)).all() and (lw >= -np.exp(3.0)).all()


def test_time_mix_post_and_channel_mix_match_jax(rng):
    jcfg, cfg = _configs("float32")
    jpl, pl = _layer0()
    H, K = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    y = rng.randn(B, 11, H, K).astype(np.float32)
    g = rng.randn(B, 11, cfg.d_model).astype(np.float32)
    want = jax_rwkv.time_mix_post(jcfg, jpl, jnp.asarray(y), jnp.asarray(g),
                                  jnp.float32)
    got = rwkv6.time_mix_post(cfg, pl, torch.from_numpy(y),
                              torch.from_numpy(g), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=GLUE_ATOL)
    x = rng.randn(B, 11, cfg.d_model).astype(np.float32)
    ts = rng.randn(B, cfg.d_model).astype(np.float32)
    want_y, want_ts = jax_rwkv.channel_mix(jcfg, jpl, jnp.asarray(x),
                                           jnp.asarray(ts))
    got_y, got_ts = rwkv6.channel_mix(cfg, pl, torch.from_numpy(x),
                                      torch.from_numpy(ts))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0,
                               atol=GLUE_ATOL)
    np.testing.assert_array_equal(got_ts.numpy(), np.asarray(want_ts))


@pytest.mark.parametrize("shift", [0.0, 4.0])
def test_group_norm_matches_jax(shift, rng):
    """The population variance, as ``jnp.var``'s: torch's default (unbiased)
    would differ by T/(T-1). ``shift`` moves the mean off zero."""
    x = (rng.randn(B, 7, 64) + shift).astype(np.float32)
    w = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    b = (0.1 * rng.randn(64)).astype(np.float32)
    want = jax_common.group_norm(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), 4, 1e-5)
    got = common.group_norm(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b), 4, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=GLUE_ATOL)
    bf = common.group_norm(torch.from_numpy(x).bfloat16(),
                           torch.from_numpy(w), torch.from_numpy(b), 4)
    assert bf.dtype == torch.bfloat16


def test_time_mix_with_token_shift_and_state_matches_jax(monkeypatch, rng):
    """A nonzero token shift and entering state s0, folded in after the
    zero-state kernel, against the JAX ``time_mix`` on its chunked-scan
    route and on its kernel route (test_conformance.py
    test_rwkv_routes_through_wkv_kernel): y and the final state."""
    jcfg, cfg = _configs("float32")
    jpl, pl = _layer0()
    H, K = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    x = rng.randn(B, 12, cfg.d_model).astype(np.float32)
    ts = rng.randn(B, cfg.d_model).astype(np.float32)
    s0 = rng.randn(B, H, K, K).astype(np.float32)
    before = wk_ops.wkv6.launches
    y, ts1, s1 = rwkv6.time_mix(cfg, pl, *(torch.from_numpy(a)
                                           for a in (x, ts, s0)))
    assert wk_ops.wkv6.launches == before        # CPU: the plain version
    np.testing.assert_array_equal(ts1.numpy(), x[:, -1])
    for impl in ("jnp", "kernel"):
        monkeypatch.setenv("AEG_WKV_IMPL", impl)
        y_j, _, s_j = jax_rwkv.time_mix(jcfg, jpl, jnp.asarray(x),
                                        jnp.asarray(ts), jnp.asarray(s0))
        np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=0,
                                   atol=ATOL, err_msg=impl)
        np.testing.assert_allclose(s1.numpy(), np.asarray(s_j), rtol=0,
                                   atol=ATOL, err_msg=impl)


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


def test_served_ssm_request_equals_a_local_run():
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


def test_served_ssm_request_without_artifacts_is_an_error():
    carried = _carry("float32", 8)
    with pytest.raises(RuntimeError, match="not attached"):
        _serve(carried, None, [carried["inputs"]])
