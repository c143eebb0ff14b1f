"""The moe family in the port on the CPU against the JAX package, on the same
weights (carried across with ``params_from_jax``): ``moe_ffn`` (dropless,
capacity-dropping and Arctic's dense residual), the whole slice
(``forward_full``'s logits and aux loss, ``forward_decode``, the 2-layer
``compile_transformer_block`` program's bytes and linked run, the engine's
greedy streams, a served request), the vlm and audio programs fed by the
frontend stubs, and ``draw_param``'s slice-by-slice draw."""
import dataclasses
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import rbl as jax_rbl
from repro.core import rctc as jax_rctc
from repro.core import rimfs as jax_rimfs
from repro.core.executor import Executor as JaxExecutor
from repro.models import frontends as jax_frontends
from repro.models import mlp as jax_mlp
from repro.models import transformer as jax_tf
from repro.models.common import init_params as jax_init_params
from repro.serving import engine as jax_engine
from repro_torch.configs import get_config
from repro_torch.core import rbl, rctc, rimfs
from repro_torch.core.executor import Executor
from repro_torch.core.rcb import Op, RCBProgram
from repro_torch.core.rtpm import Platform
from repro_torch.models import common, frontends, mlp
from repro_torch.models import transformer as tf
from repro_torch.serving import engine
from repro_torch.serving.server import Client, InferenceServer

OP_TOL = 1e-5                 # one fp32 op
ATOL = 5e-4                   # a whole fp32 program (test_conformance.py:700)
MOONSHOT = "moonshot-v1-16b-a3b-smoke"
ARCTIC = "arctic-480b-smoke"


def _cfgs(name, **kw):
    return (dataclasses.replace(jax_get_config(name), **kw),
            dataclasses.replace(get_config(name), **kw))


@functools.lru_cache(maxsize=None)
def _jax_params(name, seed=0):
    jcfg, _ = _cfgs(name)
    return jax_init_params(jax.random.PRNGKey(seed), jax_tf.model_specs(jcfg))


def _port_params(name, seed=0):
    return tf.params_from_jax({k: np.asarray(v) for k, v in
                               _jax_params(name, seed).items()},
                              device="cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _layer(params, i=0):
    return {k: v[i] for k, v in params.items()
            if k not in ("embed", "lm_head", "final_norm")}


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,capacity,shape", [
    (MOONSHOT, None, (2, 9)),          # the smoke config is dropless
    (MOONSHOT, 1.25, (6, 8)),          # drops: see the keep assertion
    (ARCTIC, None, (3, 5)),            # the dense residual
])
def test_moe_ffn_matches_jax(name, capacity, shape):
    kw = {} if capacity is None else {"moe_capacity_factor": capacity}
    jcfg, cfg = _cfgs(name, **kw)
    jp = {k: v[0] for k, v in _jax_params(name).items()
          if k not in ("embed", "lm_head", "final_norm")}
    tp = _layer(_port_params(name))
    x = np.random.RandomState(7).randn(*shape, cfg.d_model).astype(
        np.float32)
    jy, jaux = jax_mlp.moe_ffn(jcfg, jp, jnp.asarray(x))
    ty, taux = mlp.moe_ffn(cfg, tp, torch.from_numpy(x))
    assert ty.dtype == torch.float32 and taux.dtype == torch.float32
    _close(ty, jy, OP_TOL)
    _close(taux, jaux, OP_TOL)
    keep = mlp.route(cfg, tp["router"], mlp._group(torch.from_numpy(x),
                                                   1024))["keep"]
    if capacity is None:
        assert bool((keep == 1).all())
    else:
        assert bool((keep == 0).any())           # some slots were dropped
    if cfg.moe_dense_residual:
        assert "dense_wi_gate" in tp


def test_moe_ffn_groups_like_jax_past_one_group():
    """S = 2048: two groups of 1024 tokens, each with its own capacity."""
    jcfg, cfg = _cfgs(MOONSHOT, moe_capacity_factor=1.25)
    jp = {k: v[0] for k, v in _jax_params(MOONSHOT).items()
          if k not in ("embed", "lm_head", "final_norm")}
    tp = _layer(_port_params(MOONSHOT))
    x = np.random.RandomState(3).randn(1, 2048, cfg.d_model).astype(
        np.float32)
    jy, jaux = jax_mlp.moe_ffn(jcfg, jp, jnp.asarray(x))
    ty, taux = mlp.moe_ffn(cfg, tp, torch.from_numpy(x))
    _close(ty, jy, OP_TOL)
    _close(taux, jaux, OP_TOL)


def test_group_refuses_a_ragged_sequence_past_one_group():
    """S > 1024 not a multiple of 1024: the reference's reshape raises, and
    so does the port's (ROADMAP, refusals)."""
    jcfg, cfg = _cfgs(MOONSHOT)
    x = np.zeros((1, 1500, cfg.d_model), np.float32)
    with pytest.raises(TypeError, match="cannot reshape"):
        jax_mlp._group(jnp.asarray(x), 1024)
    with pytest.raises(TypeError, match="cannot reshape"):
        mlp._group(torch.from_numpy(x), 1024)
    assert tuple(mlp._group(torch.zeros(2, 3072, 4), 1024).shape) == \
        (6, 1024, 4)
    assert tuple(mlp._group(torch.zeros(2, 700, 4), 1024).shape) == \
        (2, 700, 4)


def test_top_k_takes_the_lower_index_first_on_a_tie():
    p = np.array([[0.1, 0.3, 0.2, 0.3, 0.1],
                  [0.25, 0.25, 0.25, 0.25, 0.0],
                  [0.0, 0.0, 0.0, 0.0, 1.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(p), 3)
    tv, ti = mlp.top_k(torch.from_numpy(p), 3)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tv.numpy(), np.asarray(jv))


def test_one_hot_is_zero_outside_the_range_as_jax():
    idx = np.array([[0.0, 2.0, 3.0, 7.0]], np.float32)
    want = np.asarray(jax.nn.one_hot(jnp.asarray(idx), 3, dtype=jnp.float32))
    assert np.array_equal(mlp._one_hot(torch.from_numpy(idx), 3).numpy(),
                          want)


# ---------------------------------------------------------------------------
# The slice: specs, forward passes, the program, the engine, the server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [MOONSHOT, ARCTIC])
def test_moe_specs_and_params_carry_across(name):
    jcfg, cfg = _cfgs(name)
    jspecs, specs = jax_tf.model_specs(jcfg), tf.model_specs(cfg)
    assert sorted(specs) == sorted(jspecs)
    for k, s in specs.items():
        assert (s.shape, s.dtype, s.init, s.scale) == \
            (jspecs[k].shape, jspecs[k].dtype, jspecs[k].init,
             jspecs[k].scale), k
    assert specs["router"].dtype == "float32"


@pytest.mark.parametrize("name", [MOONSHOT, ARCTIC])
def test_forward_full_logits_and_aux_match_jax(name):
    jcfg, cfg = _cfgs(name)
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 11))
    jl, jcache, jaux = jax_tf.forward_full(jcfg, _jax_params(name),
                                           jnp.asarray(toks),
                                           want_cache=True)
    params = _port_params(name)
    tl, tcache, taux = tf.forward_full(cfg, params, toks, want_cache=True)
    _close(tl, jl, ATOL)
    _close(taux, jaux, OP_TOL)
    assert float(taux) > 0
    for k in ("k", "v"):
        _close(tcache[k], jcache[k], OP_TOL)
    plain, _, plain_aux = tf.forward_full(cfg, params, toks, impl="ref")
    assert torch.equal(plain, tl) and torch.equal(plain_aux, taux)


def test_forward_full_aux_is_zero_without_experts():
    cfg = get_config("qwen2-1.5b-smoke")
    params = tf.init_params(cfg, 0, device="cpu")
    _, _, aux = tf.forward_full(cfg, params, np.zeros((1, 4), np.int32))
    assert aux.dtype == torch.float32 and float(aux) == 0.0


@pytest.mark.parametrize("name", [MOONSHOT, ARCTIC])
def test_forward_decode_after_prefill_matches_jax(name):
    jcfg, cfg = _cfgs(name)
    B, plen, max_seq = 2, 6, 16
    rng = np.random.RandomState(2)
    toks = rng.randint(0, cfg.vocab_size, (B, plen)).astype(np.int32)
    _, jcache, _ = jax_tf.forward_full(jcfg, _jax_params(name),
                                       jnp.asarray(toks), want_cache=True)
    cache = {k: np.zeros((cfg.num_layers, B, max_seq, cfg.num_kv_heads,
                          cfg.head_dim), np.float32) for k in ("k", "v")}
    for k in cache:
        cache[k][:, :, :plen] = np.asarray(jcache[k])
    nxt = rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.full((B,), plen, np.int32)
    jl, jnew = jax_tf.forward_decode(jcfg, _jax_params(name),
                                     jnp.asarray(nxt), jnp.asarray(pos),
                                     {k: jnp.asarray(v)
                                      for k, v in cache.items()})
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tl, tnew = tf.forward_decode(cfg, _port_params(name), nxt,
                                 torch.from_numpy(pos), tcache)
    _close(tl, jl, ATOL)
    for k in ("k", "v"):
        assert tnew[k] is tcache[k]
        _close(tnew[k], jnew[k], OP_TOL)


@functools.lru_cache(maxsize=None)
def _carry(name, seq, batch=1):
    """The JAX program and image, the port's from the same weights, and one
    request's inputs (the embedded tokens, or the frontend stub's
    embeddings for a vlm or audio config)."""
    jcfg, cfg = _cfgs(name)
    jparams = _jax_params(name)
    jprog, jimage = jax_rctc.compile_transformer_block(jcfg, jparams, batch,
                                                       seq)
    params = _port_params(name)
    prog, image = rctc.compile_transformer_block(cfg, params, batch, seq)
    if cfg.input_kind == "tokens":
        tokens = np.random.RandomState(seq).randint(0, cfg.vocab_size,
                                                    (batch, seq))
        hidden = tf.embed_inputs(cfg, tf.split_params(params)[0],
                                 tokens).numpy()
    else:
        stub = frontends.patch_embed_stub if cfg.family == "vlm" \
            else frontends.frame_embed_stub
        hidden = stub(cfg, batch, seq, seed=seq)
    inputs = {"hidden": hidden,
              "positions": np.broadcast_to(
                  np.arange(seq, dtype=np.int32)[None], (batch, seq)).copy()}
    return dict(cfg=cfg, jprog=jprog, jimage=jimage, prog=prog, image=image,
                params=params, inputs=inputs)


def _jax_logits(carried):
    fs = jax_rimfs.mount(carried["jimage"])
    out = JaxExecutor().run(jax_rbl.bind(carried["jprog"], rimfs=fs,
                                         inputs=carried["inputs"]))["logits"]
    return np.asarray(out, np.float32)


def _port_run(carried, prog_bytes=None):
    """Linked and interpreted runs of the program (the port's bytes unless
    ``prog_bytes``) with the port's artifacts attached."""
    prog = RCBProgram.decode(prog_bytes or carried["prog"].encode())
    prog.artifacts.update(carried["prog"].artifacts)
    ex = Executor(device="cpu")
    bound = rbl.bind(prog, rimfs=rimfs.mount(carried["image"]),
                     driver=ex.driver)
    return (ex.run(bound, inputs=carried["inputs"])["logits"],
            ex.run_interpreted(bound, inputs=carried["inputs"])["logits"])


@pytest.mark.parametrize("name,seq", [(MOONSHOT, 8), (MOONSHOT, 13),
                                      (ARCTIC, 8)])
def test_moe_program_bytes_and_run_match_jax(name, seq):
    carried = _carry(name, seq)
    assert carried["prog"].encode() == carried["jprog"].encode()
    assert carried["prog"].encode(version=1) == \
        carried["jprog"].encode(version=1)
    assert carried["image"] == carried["jimage"]
    assert sorted(carried["prog"].artifacts) == \
        sorted(carried["jprog"].artifacts) == ["L0.moe", "L1.moe"]
    kinds = [op.op for blk in carried["prog"].blocks for op in blk.ops]
    assert kinds.count(Op.GRAPH_EXEC) == kinds.count(Op.ATTENTION) == 2
    linked, interp = _port_run(carried, carried["jprog"].encode())
    assert torch.equal(linked, interp)
    np.testing.assert_allclose(linked.numpy(), _jax_logits(carried),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["pixtral-12b-smoke",
                                  "musicgen-medium-smoke"])
def test_frontend_stub_programs_match_jax(name):
    """The vlm and audio backbones on the program path: the frontend stub's
    embeddings in, the same bytes, logits within 5e-4 of the JAX run."""
    carried = _carry(name, 8, batch=2)
    assert carried["cfg"].input_kind == "embeddings"
    assert "embed" not in carried["params"]
    assert carried["prog"].encode() == carried["jprog"].encode()
    assert carried["image"] == carried["jimage"]
    linked, interp = _port_run(carried)
    assert torch.equal(linked, interp)
    np.testing.assert_allclose(linked.numpy(), _jax_logits(carried),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("stub,kw", [("patch_embed_stub", {}),
                                     ("frame_embed_stub", {"codebooks": 3})])
def test_frontend_stubs_equal_jax_exactly(stub, kw):
    for name in ("pixtral-12b-smoke", "musicgen-medium-smoke"):
        jcfg, cfg = _cfgs(name)
        got = getattr(frontends, stub)(cfg, 2, 5, seed=4, **kw)
        want = getattr(jax_frontends, stub)(jcfg, 2, 5, seed=4, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_moe_program_kernels_and_plain_agree_bit_for_bit():
    carried = _carry(MOONSHOT, 8)
    plain = RCBProgram.decode(carried["prog"].encode())
    for blk in plain.blocks:
        for op in blk.ops:
            if op.op == Op.ATTENTION:
                op.attrs["impl"] = "ref"
    linked, _ = _port_run(carried)
    got, _ = _port_run(carried, plain.encode())
    assert torch.equal(got, linked) and torch.isfinite(got).all()


def test_served_moe_request_equals_a_local_run():
    carried = _carry(MOONSHOT, 13)
    server = InferenceServer(device="cpu",
                             artifacts=carried["prog"].artifacts)
    client = Client(server.start())
    try:
        assert client.provision(carried["image"], carried["prog"].encode()) \
            == {"status": "ready"}
        got = client.infer(**carried["inputs"])["logits"]
    finally:
        client.close()
        server.stop()
    plat = Platform(device="cpu")
    plat.provision(image=carried["image"],
                   program_bytes=carried["prog"].encode())
    want = Executor(driver=plat.driver).run(
        plat.bind(artifacts=carried["prog"].artifacts),
        inputs=carried["inputs"])["logits"]
    assert np.array_equal(got, want.numpy())


def _run(eng_cls, req_cls, cfg, params, prompts, max_batch, max_new=4,
         **kw):
    eng = eng_cls(cfg, params, max_batch=max_batch, max_seq=64, **kw)
    reqs = [req_cls(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done and not r.shed for r in reqs)
    return [r.out_tokens for r in reqs]


@pytest.mark.parametrize("name", [MOONSHOT, ARCTIC])
def test_engine_greedy_streams_equal_jax(name):
    """5 prompts of ragged lengths over 2 slots, 4 new tokens each."""
    jcfg, cfg = _cfgs(name)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 9, 5, 3, 12)]
    want = _run(jax_engine.ServingEngine, jax_engine.Request, jcfg,
                _jax_params(name), prompts, 2)
    got = _run(engine.ServingEngine, engine.Request, cfg,
               _port_params(name), prompts, 2, device="cpu")
    assert got == want
    assert all(len(t) == 5 for t in got)


def test_engine_matches_an_offline_greedy_recompute():
    """Decode routes each token as a group of one (no drop); the stream
    equals ``forward_full`` over the prompt and the tokens so far, at the
    smoke config's capacity, which drops nothing either."""
    cfg = get_config(MOONSHOT)
    params = _port_params(MOONSHOT)
    prompt = np.random.RandomState(6).randint(0, cfg.vocab_size, (8,))
    got = _run(engine.ServingEngine, engine.Request, cfg, params,
               [prompt.astype(np.int32)], 2, device="cpu")[0]
    toks, want = list(prompt), []
    for _ in range(5):
        logits, _, _ = tf.forward_full(cfg, params, np.asarray(toks)[None])
        want.append(int(torch.argmax(logits[0, -1])))
        toks.append(want[-1])
    assert got == want


# ---------------------------------------------------------------------------
# draw_param: slice by slice past the threshold, the same bits below it
# ---------------------------------------------------------------------------

def _digest(params):
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(params[k].contiguous().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


# init_params(cfg, 0, device="cpu") before the slice-by-slice draw existed
_DIGESTS = {
    ("qwen2-1.5b-smoke", "float32"):
        "01e4c637d54df3cc218b4e1d744a04fa3329126473b75c95151160eb379c278a",
    ("hymba-1.5b-smoke", "float32"):
        "ab3a5d3f4ac21fb4ca79bd05a291edf1075f2ea8a92584f5b3f758d8ad84cecd",
    ("qwen2-1.5b-smoke", "bfloat16"):
        "33cf2974a7f07ca08fc399345ee47792588c9ea08dffc3b53b1c3817e6858609",
    ("rwkv6-1.6b-smoke", "float32"):
        "6fa1e52c56ef3ba3a6e5c132b1c4d73abbfda06ad28813750688bc4f848e4df1",
}


@pytest.mark.parametrize("name,dtype", sorted(_DIGESTS))
def test_init_params_keep_their_bits_below_the_slice_threshold(name, dtype):
    cfg = dataclasses.replace(get_config(name), dtype=dtype)
    assert _digest(tf.init_params(cfg, 0, device="cpu")) == \
        _DIGESTS[(name, dtype)]


@pytest.mark.parametrize("init", ["normal", "uniform", "decay", "embed"])
def test_a_spec_past_the_threshold_is_drawn_slice_by_slice(init,
                                                           monkeypatch):
    spec = common.ParamSpec((3, 4, 5, 6), "bfloat16", init, 0.5)
    gen = torch.Generator().manual_seed(11)
    whole = common.draw_param(spec, gen, torch.device("cpu"))
    monkeypatch.setattr(common, "SLICE_DRAW_BYTES", 4 * 4 * 5 * 6)
    gen = torch.Generator().manual_seed(11)
    sliced = common.draw_param(spec, gen, torch.device("cpu"))
    gen = torch.Generator().manual_seed(11)
    want = torch.stack([common._draw(spec, spec.shape[1:], gen,
                                     torch.device("cpu")).to(torch.bfloat16)
                        for _ in range(3)])
    assert sliced.dtype == torch.bfloat16 and sliced.shape == whole.shape
    assert torch.equal(sliced, want)
    if init in ("normal", "embed"):     # fan-in and d from the whole spec
        ref = whole.float()
        assert abs(sliced.float().std() / ref.std() - 1) < 0.2


def test_a_slice_past_the_threshold_is_drawn_along_its_next_axis(
        monkeypatch):
    """A spec whose one-layer slice still passes the threshold (arctic's
    experts at full width) is drawn (layer, expert) by (layer, expert),
    into its own dtype, with the whole spec's fan-in."""
    arctic = tf.model_specs(get_config("arctic-480b"))
    assert common._slices(arctic["we_up"].shape)[:2] == [(0, 0), (0, 1)]
    assert len(common._slices(arctic["we_up"].shape)) == 35 * 128
    spec = common.ParamSpec((2, 3, 4, 5), "bfloat16", "normal", 0.5)
    monkeypatch.setattr(common, "SLICE_DRAW_BYTES", 4 * 4 * 5)
    gen = torch.Generator().manual_seed(12)
    sliced = common.draw_param(spec, gen, torch.device("cpu"))
    gen = torch.Generator().manual_seed(12)
    want = torch.stack([torch.stack([
        common._draw(spec, spec.shape[2:], gen, torch.device("cpu"))
        for _ in range(3)]) for _ in range(2)]).to(torch.bfloat16)
    assert sliced.dtype == torch.bfloat16 and torch.equal(sliced, want)


def test_moonshot_experts_pass_the_threshold_and_qwen2_does_not():
    moon = tf.model_specs(get_config("moonshot-v1-16b-a3b"))
    big = sorted(k for k, s in moon.items()
                 if np.prod(s.shape) * 4 > common.SLICE_DRAW_BYTES)
    assert big == ["we_gate", "we_out", "we_up"]
    qwen = tf.model_specs(get_config("qwen2-1.5b"))
    assert max(np.prod(s.shape) * 4 for s in qwen.values()) < \
        common.SLICE_DRAW_BYTES
