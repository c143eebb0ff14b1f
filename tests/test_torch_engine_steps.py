"""The serving engine's compiled steps on the CPU: RoPE's table built once
a pass, decode's per-step invariants built once a step, the decode step
through its static buffers, and admission one prompt a prefill, against
the forms they replace and the JAX package's engine on the same parameters.
(The CUDA graph itself runs only on the card:
``tests/test_torch_engine_gpu.py``.)"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jax_tf
from repro.models.common import init_params as jax_init_params
from repro.serving import engine as jax_engine
from repro_torch.configs import get_config
from repro_torch.launch.steps import CompiledDecodeStep
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.common import apply_rope, rope_table
from repro_torch.serving import engine

CFG = "qwen2-1.5b-smoke"
OP_TOL = 1e-5
MAX_SEQ = 16


@functools.lru_cache(maxsize=None)
def _params():
    jcfg = jax_get_config(CFG)
    jp = jax_init_params(jax.random.PRNGKey(0), jax_tf.model_specs(jcfg))
    return jcfg, jp, get_config(CFG), {k: np.asarray(v)
                                       for k, v in jp.items()}


def _port_params():
    return tf.params_from_jax(_params()[3], device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 9, 4, 16), (3, 1, 12, 128)])
def test_apply_rope_with_the_table_equals_the_per_call_form(dtype, shape):
    B, S, H, D = shape
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
    pos = torch.from_numpy(rng.randint(0, 40000, (B, S)).astype(np.int32))
    table = rope_table(pos, D, 1e6)
    assert all(t.shape == (B, S, 1, D // 2) for t in table)
    assert torch.equal(apply_rope(x, pos, 1e6, table),
                       apply_rope(x, pos, 1e6))


def _cache(rng, cfg, B):
    shape = (cfg.num_layers, B, MAX_SEQ, cfg.num_kv_heads, cfg.head_dim)
    return {k: rng.randn(*shape).astype(np.float32) for k in ("k", "v")}


def _per_layer_decode(cfg, params, inputs, pos, cache):
    """forward_decode with every layer building its own invariants: the
    form the hoisted step replaces."""
    glob, blocks = tf.split_params(params)
    x = tf.embed_inputs(cfg, glob, inputs)
    for i in range(cfg.num_layers):
        x, _ = tf.block_decode(cfg, tf._slice_layer(blocks, i), x, pos,
                               tf._slice_layer(cache, i))
    return tf.logits_head(cfg, glob, x)


@pytest.mark.parametrize("pos", [(0, MAX_SEQ - 1, 7), (MAX_SEQ - 1, 0, 0),
                                 (3, 9, MAX_SEQ - 1)])
def test_forward_decode_with_hoisted_invariants_matches_jax(pos):
    """fp32 ``qwen2-1.5b-smoke``: the hoisted step against the JAX
    package's ``forward_decode`` at 1e-5, and against the per-layer form
    bit for bit (the same ops on the same inputs)."""
    jcfg, jp, cfg, _ = _params()
    rng = np.random.RandomState(sum(pos))
    B = len(pos)
    cache = _cache(rng, cfg, B)
    toks = rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    p = np.asarray(pos, np.int32)
    jl, jcache = jax_tf.forward_decode(
        jcfg, jp, jnp.asarray(toks), jnp.asarray(p),
        {k: jnp.asarray(v) for k, v in cache.items()})
    params = _port_params()
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tl, out = tf.forward_decode(cfg, params, toks, torch.from_numpy(p),
                                tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=OP_TOL,
                               atol=OP_TOL)
    for k in ("k", "v"):
        assert out[k] is tcache[k]
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jcache[k]),
                                   rtol=OP_TOL, atol=OP_TOL)
    mirror = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    assert torch.equal(_per_layer_decode(cfg, params, toks,
                                         torch.from_numpy(p), mirror), tl)
    for k in ("k", "v"):
        assert torch.equal(mirror[k], tcache[k])


def test_decode_consts_are_the_per_layer_invariants():
    _, _, cfg, _ = _params()
    pos = torch.tensor([0, 5, MAX_SEQ - 1], dtype=torch.int32)
    c = attn.decode_consts(cfg, pos, MAX_SEQ)
    assert c.rows.tolist() == [0, 1, 2] and c.slot.dtype == torch.int64
    assert c.valid.shape == (3, 1, 1, 1, MAX_SEQ)
    assert c.valid.sum(-1).flatten().tolist() == [1, 6, MAX_SEQ]
    assert c.scale.dtype == torch.float32 and c.scale.dim() == 0
    assert c.scale.item() == np.float32(cfg.head_dim ** 0.5)
    assert torch.equal(c.rope[0], rope_table(pos[:, None], cfg.head_dim,
                                             cfg.rope_theta)[0])


PROMPT_LENGTHS = (5, 9, 5, 3, 12, 7, 9)
MAX_NEW = (1, 6, 2, 5, 3, 4, 6)


def _drain(eng, req_cls, prompts):
    reqs = [req_cls(rid=i, prompt=p, max_new=n)
            for i, (p, n) in enumerate(zip(prompts, MAX_NEW))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done and not r.shed for r in reqs)
    return [r.out_tokens for r in reqs]


def test_engine_steps_through_its_static_buffers_and_matches_jax():
    """7 prompts over 3 slots with max_new 1 to 6, so slots free and
    refill mid-run: every decode step goes through the compiled step's
    static buffers, and the greedy streams equal the JAX engine's."""
    jcfg, jp, cfg, _ = _params()
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in PROMPT_LENGTHS]
    want = _drain(jax_engine.ServingEngine(jcfg, jp, max_batch=3,
                                           max_seq=64),
                  jax_engine.Request, prompts)
    eng = engine.ServingEngine(cfg, _port_params(), max_batch=3, max_seq=64,
                               device="cpu")
    step = eng._decode
    assert isinstance(step, CompiledDecodeStep) and step.graph is None
    assert eng.program.artifacts["decode"] is step
    cache = {k: id(v) for k, v in eng._cache.items()}
    seen = []
    inner = step.step

    def watched(params, cache, batch):
        assert batch is step.inputs      # the static buffers, refilled
        seen.append(batch["pos"].clone())
        return inner(params, cache, batch)
    step.step = watched
    got = _drain(eng, engine.Request, prompts)
    assert got == want
    assert [len(t) for t in got] == [n + 1 for n in MAX_NEW]
    assert {k: id(v) for k, v in eng._cache.items()} == cache  # never rebound
    assert len(seen) == eng.telemetry.summary()["n"]   # one a step


def test_decode_step_refuses_another_cache():
    _, _, cfg, _ = _params()
    params = _port_params()
    eng = engine.ServingEngine(cfg, params, max_batch=2, max_seq=16,
                               device="cpu")
    other = {k: v.clone() for k, v in eng._cache.items()}
    batch = {"inputs": torch.zeros((2, 1), dtype=torch.int32),
             "pos": torch.zeros((2,), dtype=torch.int32)}
    with pytest.raises(ValueError, match="compiled for other"):
        eng._decode(params, other, batch)


@pytest.mark.parametrize("lengths", [(6, 6, 6), (6, 4, 6, 4)])
def test_a_group_of_k_prompts_makes_k_single_prompt_prefills(lengths):
    """Prompts admitted together prefill one at a time, at B = 1, in
    admission order, each into its own slot."""
    _, _, cfg, _ = _params()
    eng = engine.ServingEngine(cfg, _port_params(), max_batch=len(lengths),
                               max_seq=16, device="cpu")
    shapes, inner = [], eng._prefill

    def counted(params, batch):
        shapes.append(tuple(batch["inputs"].shape))
        return inner(params, batch)
    eng._prefill = counted
    rng = np.random.RandomState(1)
    reqs = [engine.Request(rid=i, prompt=rng.randint(
        0, cfg.vocab_size, (n,)).astype(np.int32), max_new=2)
        for i, n in enumerate(lengths)]
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert shapes == [(1, n) for n in lengths]
    assert eng._slots == reqs and eng._pos.tolist() == [n + 1
                                                        for n in lengths]
