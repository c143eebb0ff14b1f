"""Every LM architecture of the port on the CPU against the JAX package: the
port's counterpart of ``tests/test_models.py``. Each ``-smoke`` config runs
in fp32 on the JAX package's parameters (carried across with
``params_from_jax``) and numpy inputs from a seed: ``forward_full`` on the
served route (the kernels' plain versions on CPU tensors) and
``forward_decode`` after that prefill against the JAX package's, and the
port's decode against its own full forward over S + 1. The vlm and audio
backbones run on (B, S, d) embeddings, as the reference's steps take them:
``make_prefill_step``/``make_decode_step`` (and ``CompiledDecodeStep``),
``forward_decode_paged`` and ``make_paged_prefill_step`` on pixtral-12b's
smoke config (the serving engines' refusal of embeddings is held in
``tests/test_torch_engine.py``)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import steps as jax_steps
from repro.models import transformer as jax_tf
from repro.models.common import init_params as jax_init_params
from repro_torch.configs import ARCHES, get_config
from repro_torch.launch import steps
from repro_torch.models import transformer as tf

B, S = 2, 32
ATOL = 5e-4            # a whole fp32 program (test_conformance.py:700)
DECODE_TOL = 2e-3      # decode against a full forward (test_models.py:97)
PIXTRAL = "pixtral-12b-smoke"


def _cfgs(name):
    """The JAX package's and the port's config, in fp32."""
    return (dataclasses.replace(jax_get_config(name), dtype="float32"),
            dataclasses.replace(get_config(name), dtype="float32"))


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    jcfg, _ = _cfgs(name)
    return jax_init_params(jax.random.PRNGKey(0), jax_tf.model_specs(jcfg))


def _port_params(name):
    return tf.params_from_jax({k: np.asarray(v) for k, v in
                               _jax_params(name).items()}, device="cpu")


def _inputs(cfg, seed, seq=S, batch=B):
    """Tokens (B, seq), or a vlm or audio config's (B, seq, d) embeddings."""
    rng = np.random.RandomState(seed)
    if cfg.input_kind == "tokens":
        return rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    return rng.randn(batch, seq, cfg.d_model).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _decode_cache(cfg, cache: dict, rows: int) -> dict:
    """A prefill's cache widened from S to ``rows`` KV rows (a sliding
    window's ring holds its last W), recurrent states as they are, as
    ``tests/test_models.py`` builds it; numpy, fp32."""
    out = {}
    for k, spec in jax_tf.cache_specs(cfg, B, rows).items():
        have = np.asarray(cache[k], np.float32)
        if k in ("k", "v"):
            z = np.zeros(spec.shape, np.float32)
            win = z.shape[2]
            have = have[:, :, -win:]
            z[:, :, :have.shape[2]] = have
            have = z
        out[k] = have
    return out


@pytest.mark.parametrize("arch", ARCHES)
def test_forward_full_matches_jax(arch):
    """Logits, every cache tensor and the aux loss of the served route's
    prefill against the JAX package's ``forward_full``."""
    jcfg, cfg = _cfgs(arch + "-smoke")
    x = _inputs(cfg, 1)
    jl, jcache, jaux = jax_tf.forward_full(jcfg, _jax_params(cfg.name),
                                           jnp.asarray(x), want_cache=True)
    tl, tcache, taux = tf.forward_full(cfg, _port_params(cfg.name), x,
                                       want_cache=True)
    assert tuple(tl.shape) == (B, S, cfg.vocab_size)
    _close(tl, jl, ATOL)
    assert sorted(tcache) == sorted(jcache)
    for k in jcache:
        assert tuple(tcache[k].shape) == tuple(jcache[k].shape), k
        _close(tcache[k], jcache[k], ATOL)
    _close(taux, jaux, ATOL)


@pytest.mark.parametrize("arch", ARCHES)
def test_forward_decode_after_prefill_matches_jax(arch):
    """Token S decoded against the JAX prefill's cache, widened to S + 8
    rows: the logits and the updated cache against the JAX package's
    ``forward_decode`` on the same cache."""
    jcfg, cfg = _cfgs(arch + "-smoke")
    x = _inputs(cfg, 2, S + 1)
    _, jcache, _ = jax_tf.forward_full(jcfg, _jax_params(cfg.name),
                                       jnp.asarray(x[:, :S]),
                                       want_cache=True)
    cache = _decode_cache(jcfg, jcache, S + 8)
    pos = np.full((B,), S, np.int32)
    jl, jnew = jax_tf.forward_decode(jcfg, _jax_params(cfg.name),
                                     jnp.asarray(x[:, S:]), jnp.asarray(pos),
                                     {k: jnp.asarray(v)
                                      for k, v in cache.items()})
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tl, tnew = tf.forward_decode(cfg, _port_params(cfg.name), x[:, S:],
                                 torch.from_numpy(pos), tcache)
    assert tuple(tl.shape) == (B, 1, cfg.vocab_size)
    _close(tl, jl, ATOL)
    for k in jnew:
        assert tnew[k] is tcache[k]          # written in place
        _close(tnew[k], jnew[k], ATOL)


@pytest.mark.parametrize("arch", ARCHES)
def test_decode_matches_full_forward(arch):
    """The port alone: prefill S, decode token S into a cache of S + 8
    rows; its logits equal the full forward's over S + 1 at the
    reference's own tolerance (``tests/test_models.py``)."""
    _, cfg = _cfgs(arch + "-smoke")
    params = _port_params(cfg.name)
    x = _inputs(cfg, 3, S + 1)
    full, _, _ = tf.forward_full(cfg, params, x)
    _, cache, _ = tf.forward_full(cfg, params, x[:, :S], want_cache=True)
    wide = {k: torch.from_numpy(v) for k, v in
            _decode_cache(cfg, cache, S + 8).items()}
    dec, _ = tf.forward_decode(cfg, params, x[:, S:],
                               torch.full((B,), S, dtype=torch.int32), wide)
    _close(dec[:, 0], full[:, -1], DECODE_TOL)


def test_prefill_and_decode_steps_on_embeddings_match_jax():
    """pixtral-12b's smoke config through the steps on embeddings: the
    prefill step's last logits and cache, then two decode steps on (B, 1,
    d) embeddings, against the JAX package's steps; the compiled decode
    step (its static (B, 1, d) buffer) equals the eager one bit for
    bit."""
    jcfg, cfg = _cfgs(PIXTRAL)
    jp, params = _jax_params(PIXTRAL), _port_params(PIXTRAL)
    x = _inputs(cfg, 4, S + 2)
    jl, jcache = jax_steps.make_prefill_step(jcfg)(
        jp, {"inputs": jnp.asarray(x[:, :S])})
    tl, tcache = steps.make_prefill_step(cfg)(params, {"inputs": x[:, :S]})
    _close(tl, jl, ATOL)
    for k in jcache:
        _close(tcache[k], jcache[k], ATOL)
    cache = _decode_cache(jcfg, jcache, S + 8)
    jcache = {k: jnp.asarray(v) for k, v in cache.items()}
    eager = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    held = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    compiled = steps.CompiledDecodeStep(cfg, params, held, B)
    assert compiled.inputs["inputs"].shape == (B, 1, cfg.d_model)
    assert compiled.inputs["inputs"].dtype == torch.float32
    jdec = jax_steps.make_decode_step(jcfg)
    tdec = steps.make_decode_step(cfg)
    for t in (S, S + 1):
        pos = np.full((B,), t, np.int32)
        jl, jcache = jdec(jp, jcache, {"inputs": jnp.asarray(x[:, t:t + 1]),
                                       "pos": jnp.asarray(pos)})
        batch = {"inputs": torch.from_numpy(x[:, t:t + 1]),
                 "pos": torch.from_numpy(pos)}
        tl, eager = tdec(params, eager, batch)
        cl, _ = compiled(params, held, batch)
        assert tuple(tl.shape) == (B, cfg.vocab_size)
        _close(tl, jl, ATOL)
        assert torch.equal(cl, tl)
        for k in jcache:
            _close(eager[k], jcache[k], ATOL)
            assert torch.equal(held[k], eager[k])


def test_paged_steps_on_embeddings_match_jax(rng):
    """pixtral-12b's smoke config on a paged pool: the paged prefill step on
    (B, S, d) embeddings writes the pool as the JAX package's does, and
    ``forward_decode_paged`` on (B, 1, d) embeddings through the tables
    gives the JAX package's logits and pool. The paged decode window,
    which feeds sampled tokens back, refuses embeddings (the JAX
    package's fails on them)."""
    jcfg, cfg = _cfgs(PIXTRAL)
    jp, params = _jax_params(PIXTRAL), _port_params(PIXTRAL)
    bs, W, nb, plen = 4, 4, 8, 7
    tables = np.asarray([[5, 0, 2, 7], [3, 6, 1, 4]], np.int32)
    shape = (cfg.num_layers, nb + 1, bs, cfg.num_kv_heads, cfg.head_dim)
    pool = [rng.randn(*shape).astype(np.float32) for _ in range(2)]
    x = _inputs(cfg, 5, plen + 1)
    jl, jk, jv = jax_steps.make_paged_prefill_step(jcfg)(
        jp, jnp.asarray(pool[0]), jnp.asarray(pool[1]),
        {"inputs": jnp.asarray(x[:, :plen]), "tables": jnp.asarray(tables)})
    tk, tv = (torch.from_numpy(p.copy()) for p in pool)
    tl, tk, tv = steps.make_paged_prefill_step(cfg)(
        params, tk, tv, {"inputs": x[:, :plen],
                         "tables": torch.from_numpy(tables)})
    _close(tl, jl, ATOL)
    _close(tk, jk, ATOL)
    _close(tv, jv, ATOL)
    pos = np.full((B,), plen, np.int32)
    jl, jk, jv = jax_tf.forward_decode_paged(
        jcfg, jp, jnp.asarray(x[:, plen:]), jnp.asarray(pos), jk, jv,
        jnp.asarray(tables))
    tl, tk2, tv2 = tf.forward_decode_paged(
        cfg, params, x[:, plen:], torch.from_numpy(pos), tk, tv,
        torch.from_numpy(tables))
    assert tk2 is tk and tv2 is tv            # written in place
    _close(tl, jl, ATOL)
    _close(tk, jk, ATOL)
    _close(tv, jv, ATOL)
    with pytest.raises(NotImplementedError, match="token prompts"):
        steps.make_paged_decode_step(cfg)
    with pytest.raises(ValueError):
        jax_steps.make_paged_decode_step(jcfg)(
            jp, jk, jv, {"tokens": jnp.zeros((B,), jnp.int32),
                         "pos": jnp.asarray(pos + 1),
                         "tables": jnp.asarray(tables)})
