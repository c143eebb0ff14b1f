"""The port's LM serving engine for the recurrent families on the CPU, against
the JAX package's on the same parameters (carried across with
``params_from_jax``), in fp32: hymba-1.5B smoke (hybrid: sliding-window
attention with W = 16, so the KV ring wraps, beside a Mamba branch) and
rwkv6-1.6B smoke (ssm: RWKV-6 time and channel mixes).

Held per module at 1e-5 (sliding-window prefill and decode attention, the
Mamba step, the RWKV-6 time- and channel-mix steps), per forward pass
(logits at 5e-4 as tests/test_conformance.py:700 holds a program; the SSM
state at 5e-5, the WKV state at 5e-4, the token-shift rows at 1e-5; the
K/V rows at 1e-5 in layer 0 and at the program's 5e-4 past it, where the
JAX package's Mamba branch takes its associative-scan route), and
per engine: greedy streams equal the JAX engine's, except for a hymba
prompt longer than W and not a multiple of it, where the JAX engine's
decode reads keys its prefill left out of ring order and the port is held
against an offline ``forward_full`` recompute instead; the decode state
written in place, a reused slot, grouped admission, the service program's
bytes, the weight image, and the server's LM route."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import rctc as jax_rctc
from repro.launch.steps import make_decode_step as jax_decode_step
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.models import attention as jax_attn
from repro.models import mamba as jax_mamba
from repro.models import rwkv6 as jax_rwkv
from repro.models import transformer as jax_tf
from repro.models.common import init_params as jax_init_params
from repro.serving import engine as jax_engine
from repro_torch.configs import get_config
from repro_torch.core import rctc, rhal, rimfs
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import attention as attn
from repro_torch.models import mamba, rwkv6
from repro_torch.models import transformer as tf
from repro_torch.serving import engine
from repro_torch.serving.server import Client, InferenceServer

HYMBA, RWKV = "hymba-1.5b-smoke", "rwkv6-1.6b-smoke"
NAMES = (HYMBA, RWKV)
OP_TOL = 1e-5                 # per op, the KV rows and the token shifts
LOGITS_TOL = 5e-4             # a whole fp32 program (test_conformance.py:700)
STATE_TOL = {"ssm": 5e-5, "wkv": 5e-4, "ts_tm": OP_TOL, "ts_cm": OP_TOL,
             "k": LOGITS_TOL, "v": LOGITS_TOL}
MAX_SEQ = 64
B = 2


@functools.lru_cache(maxsize=None)
def _params(name):
    """The JAX package's parameters and the same values as numpy."""
    jcfg = jax_get_config(name)
    jp = jax_init_params(jax.random.PRNGKey(0), jax_tf.model_specs(jcfg))
    return jcfg, jp, get_config(name), {k: np.asarray(v)
                                        for k, v in jp.items()}


def _port_params(name):
    return tf.params_from_jax(_params(name)[3], device="cpu")


def _layer0(name):
    """Layer 0's block weights, as the JAX package's and the port's."""
    _, jp, _, np_params = _params(name)
    keys = [k for k in jp if k not in ("embed", "lm_head", "final_norm")]
    return ({k: jp[k][0] for k in keys},
            {k: torch.from_numpy(np_params[k][0].copy()) for k in keys})


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _ring(kv, S, W):
    """The JAX package's kept keys (the last W, at rows 0 to W-1) in ring
    order: token t at row t % W."""
    kv = np.asarray(kv)
    return np.roll(kv, S % W, axis=-3) if S >= W else kv


# ------------------------------------------------------------- per module

@pytest.mark.parametrize("S", [9, 16, 21])
def test_sliding_prefill_attention_matches_jax(S, rng, monkeypatch):
    """hymba's window W = 16 at S < W, S = W (both the kernel's function,
    causal) and S = 21 (the windowed route, which no kernel computes): the
    output at 1e-5, and the kept K/V equal to the JAX package's rows rolled
    by S % W."""
    jcfg, _, cfg, _ = _params(HYMBA)
    W = cfg.sliding_window
    jp, tp = _layer0(HYMBA)
    x = rng.randn(B, S, cfg.d_model).astype(np.float32)
    positions = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jy, (jk, jv) = jax_attn.prefill_attention(jcfg, jp, jnp.asarray(x),
                                              jnp.asarray(positions))
    calls = []
    kernel = attn.flash_attention
    monkeypatch.setattr(attn, "flash_attention",
                        lambda *a, **kw: calls.append(1) or kernel(*a, **kw))
    ty, (tk, tv) = attn.prefill_attention(cfg, tp, torch.from_numpy(x),
                                          torch.from_numpy(positions.copy()))
    assert len(calls) == (1 if S <= W else 0)
    _close(ty, jy, OP_TOL)
    assert tk.shape[1] == min(S, W)
    _close(tk, _ring(jk, S, W), OP_TOL)
    _close(tv, _ring(jv, S, W), OP_TOL)


@pytest.mark.parametrize("pos", [(3, 15), (16, 40), (15, 31)])
def test_sliding_decode_attention_matches_jax(pos, rng):
    """Decode against a ring of W = 16 rows, at pos < W (rows above pos
    masked) and pos >= W (slot pos % W, every row valid): the output and
    both caches, written in place, at 1e-5."""
    jcfg, _, cfg, _ = _params(HYMBA)
    jp, tp = _layer0(HYMBA)
    S = cfg.sliding_window
    x = rng.randn(B, 1, cfg.d_model).astype(np.float32)
    kc, vc = (rng.randn(B, S, cfg.num_kv_heads, cfg.head_dim)
              .astype(np.float32) for _ in range(2))
    p = np.asarray(pos, np.int32)
    jy, jk, jv = jax_attn.decode_attention(jcfg, jp, jnp.asarray(x),
                                           jnp.asarray(p), jnp.asarray(kc),
                                           jnp.asarray(vc))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    ty, tk2, tv2 = attn.decode_attention(cfg, tp, torch.from_numpy(x),
                                         torch.from_numpy(p), tk, tv)
    assert tk2 is tk and tv2 is tv
    _close(ty, jy, OP_TOL)
    _close(tk, jk, OP_TOL)
    _close(tv, jv, OP_TOL)
    c = attn.decode_consts(cfg, torch.from_numpy(p), S)
    assert c.slot.tolist() == [q % S for q in pos]
    assert c.valid.sum(-1).flatten().tolist() == [min(q + 1, S) for q in pos]


def test_mamba_step_matches_jax(rng):
    jcfg, _, cfg, _ = _params(HYMBA)
    jp, tp = _layer0(HYMBA)
    x = rng.randn(B, 1, cfg.d_model).astype(np.float32)
    h0 = rng.randn(B, cfg.d_model, cfg.ssm_state).astype(np.float32)
    jy, jh = jax_mamba.mamba_step(jcfg, jp, jnp.asarray(x), jnp.asarray(h0))
    th0 = torch.from_numpy(h0.copy())
    ty, th = mamba.mamba_step(cfg, tp, torch.from_numpy(x), th0)
    assert np.array_equal(th0.numpy(), h0)          # the state is only read
    _close(ty, jy, OP_TOL)
    _close(th, jh, OP_TOL)


def test_time_mix_step_matches_jax(rng):
    jcfg, _, cfg, _ = _params(RWKV)
    jp, tp = _layer0(RWKV)
    H, K = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    x = rng.randn(B, 1, cfg.d_model).astype(np.float32)
    ts = rng.randn(B, cfg.d_model).astype(np.float32)
    s0 = rng.randn(B, H, K, K).astype(np.float32)
    jy, jts, js = jax_rwkv.time_mix_step(jcfg, jp, jnp.asarray(x),
                                         jnp.asarray(ts), jnp.asarray(s0))
    ty, tts, ts1 = rwkv6.time_mix_step(cfg, tp, torch.from_numpy(x),
                                       torch.from_numpy(ts),
                                       torch.from_numpy(s0))
    _close(ty, jy, OP_TOL)
    _close(ts1, js, OP_TOL)
    np.testing.assert_array_equal(tts.numpy(), np.asarray(jts))


def test_channel_mix_step_matches_jax(rng):
    """The channel mix at T = 1 is the decode step's."""
    jcfg, _, cfg, _ = _params(RWKV)
    jp, tp = _layer0(RWKV)
    x = rng.randn(B, 1, cfg.d_model).astype(np.float32)
    ts = rng.randn(B, cfg.d_model).astype(np.float32)
    jy, jts = jax_rwkv.channel_mix_step(jcfg, jp, jnp.asarray(x),
                                        jnp.asarray(ts))
    ty, tts = rwkv6.channel_mix(cfg, tp, torch.from_numpy(x),
                                torch.from_numpy(ts))
    _close(ty, jy, OP_TOL)
    np.testing.assert_array_equal(tts.numpy(), np.asarray(jts))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seq_len", [8, MAX_SEQ])
def test_cache_specs_match_jax(name, seq_len):
    """The decode state's keys, shapes and dtypes: hymba's KV ring of
    min(seq_len, W) rows and SSM state; rwkv6's WKV state and token
    shifts."""
    jcfg, _, cfg, _ = _params(name)
    want = jax_tf.cache_specs(jcfg, 3, seq_len)
    got = tf.cache_specs(cfg, 3, seq_len)
    assert sorted(got) == sorted(want)
    for k, s in got.items():
        assert (s.shape, s.dtype) == (tuple(want[k].shape), want[k].dtype), k


# ----------------------------------------------------------- forward passes

@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("S", [11, 21])
def test_forward_full_logits_and_state_match_jax(name, S, rng):
    """Prefill logits at 5e-4 and every cache entry at its tolerance (the
    kept K/V in ring order, layer 0's at 1e-5); ``impl="ref"`` is the same
    function on the CPU."""
    jcfg, jp, cfg, _ = _params(name)
    toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jcache, _ = jax_tf.forward_full(jcfg, jp, jnp.asarray(toks),
                                        want_cache=True)
    params = _port_params(name)
    tl, tcache, _ = tf.forward_full(cfg, params, toks,
                                     want_cache=True)
    _close(tl, jl, LOGITS_TOL)
    assert sorted(tcache) == sorted(jcache)
    for k, v in tcache.items():
        want = np.asarray(jcache[k])
        if k in ("k", "v"):
            want = _ring(want, S, cfg.sliding_window)
        assert tuple(v.shape) == want.shape, k
        _close(v, want, STATE_TOL[k])
        if k in ("k", "v"):
            _close(v[0], want[0], OP_TOL)
    plain, _, _ = tf.forward_full(cfg, params, toks, impl="ref")
    assert torch.equal(plain, tl)


@pytest.mark.parametrize("name", NAMES)
def test_forward_decode_after_prefill_matches_jax(name, rng):
    """A prefill of 6 tokens spliced into a 16-row cache, then one decode
    step: the logits at 5e-4 and every cache tensor at its tolerance, each
    written in place."""
    jcfg, jp, cfg, _ = _params(name)
    plen, max_seq = 6, 16
    toks = rng.randint(0, cfg.vocab_size, (B, plen)).astype(np.int32)
    _, jpre = jax_prefill_step(jcfg)(jp, {"inputs": jnp.asarray(toks)})
    cache = {k: np.zeros(s.shape, np.float32)
             for k, s in tf.cache_specs(cfg, B, max_seq).items()}
    for k in cache:
        if k in ("k", "v"):
            cache[k][:, :, :plen] = np.asarray(jpre[k])
        else:
            cache[k][:] = np.asarray(jpre[k])
    nxt = rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.full((B,), plen, np.int32)
    jl, jnew = jax_decode_step(jcfg)(
        jp, {k: jnp.asarray(v) for k, v in cache.items()},
        {"inputs": jnp.asarray(nxt), "pos": jnp.asarray(pos)})
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tl, tnew = tf.forward_decode(cfg, _port_params(name), nxt,
                                 torch.from_numpy(pos), tcache)
    _close(tl[:, 0], jl, LOGITS_TOL)
    for k in cache:
        assert tnew[k] is tcache[k], k       # the cache is updated in place
        assert not np.array_equal(tcache[k].numpy(), cache[k]), k
        _close(tnew[k], jnew[k], STATE_TOL[k])


# ------------------------------------------------------------------ engine

def _prompts(rng, lengths, vocab):
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lengths]


def _run(eng_cls, req_cls, cfg, params, prompts, max_batch, max_new=5,
         **kw):
    eng = eng_cls(cfg, params, max_batch=max_batch, max_seq=MAX_SEQ, **kw)
    reqs = [req_cls(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done and not r.shed for r in reqs)
    return [r.out_tokens for r in reqs]


def _port_run(name, prompts, max_batch=2, max_new=5):
    return _run(engine.ServingEngine, engine.Request, _params(name)[2],
                _port_params(name), prompts, max_batch, max_new,
                device="cpu")


def _recompute(cfg, params, prompt, n):
    """Greedy decode by ``forward_full`` over the prompt and the tokens so
    far, one token at a time."""
    toks, out = list(prompt), []
    for _ in range(n):
        logits, _, _ = tf.forward_full(cfg, params,
                                       np.asarray(toks)[None])
        out.append(int(torch.argmax(logits[0, -1])))
        toks.append(out[-1])
    return out


@pytest.mark.parametrize("name", NAMES)
def test_engine_greedy_streams_equal_jax(name, rng):
    """6 prompts over 2 slots, max_new 5, at lengths up to hymba's window
    and at multiples of it (where the JAX engine's ring holds the right
    keys): the token streams equal the JAX engine's."""
    jcfg, jp, cfg, _ = _params(name)
    prompts = _prompts(rng, (5, 9, 16, 3, 12, 32), cfg.vocab_size)
    want = _run(jax_engine.ServingEngine, jax_engine.Request, jcfg, jp,
                prompts, 2)
    got = _port_run(name, prompts)
    assert got == want
    assert all(len(t) == 6 for t in got)


@pytest.mark.parametrize("plen", [21, 35])
def test_hymba_engine_past_the_window_matches_an_offline_recompute(plen,
                                                                   rng):
    """A prompt longer than W = 16 and not a multiple of it, beside a short
    one, decoding 8 tokens: each stream equals an offline greedy
    ``forward_full`` recompute (the JAX engine's decode reads the wrong
    keys here, ROADMAP Queue 3)."""
    _, _, cfg, _ = _params(HYMBA)
    params = _port_params(HYMBA)
    prompts = _prompts(rng, (plen, 7), cfg.vocab_size)
    got = _port_run(HYMBA, prompts, max_new=8)
    assert got == [_recompute(cfg, params, p, 9) for p in prompts]


@pytest.mark.parametrize("name", NAMES)
def test_decode_step_writes_the_engine_state_in_place(name, rng):
    """A decode step changes the engine's own cache tensors, at the same
    addresses: the live lane's KV row at its slot and its recurrent
    states; a free lane's state is left to the next splice."""
    _, _, cfg, _ = _params(name)
    eng = engine.ServingEngine(cfg, _port_params(name), max_batch=2,
                               max_seq=MAX_SEQ, device="cpu")
    r = engine.Request(rid=0, prompt=_prompts(rng, (20,),
                                              cfg.vocab_size)[0], max_new=4)
    eng.submit(r)
    eng.step()                                # admit, then one decode step
    ptrs = {k: v.data_ptr() for k, v in eng._cache.items()}
    before = {k: v.clone() for k, v in eng._cache.items()}
    pos = int(eng._pos[0])
    eng.step()
    for k, v in eng._cache.items():
        assert v.data_ptr() == ptrs[k], k
        lane, was = v[:, 0], before[k][:, 0]
        if k in ("k", "v"):
            slot = pos % v.shape[2]
            lane, was = lane[:, slot], was[:, slot]
        assert not torch.equal(lane, was), k


@pytest.mark.parametrize("name", NAMES)
def test_a_reused_slot_carries_nothing_of_its_last_occupant(name, rng):
    """One slot, two prompts in turn: admitting the second splices its
    prefill's recurrent states whole and its KV rows over [0, len), and
    its tokens equal the same prompt's in a fresh engine."""
    _, _, cfg, _ = _params(name)
    params = _port_params(name)
    first, second = _prompts(rng, (30, 9), cfg.vocab_size)
    eng = engine.ServingEngine(cfg, params, max_batch=1, max_seq=MAX_SEQ,
                               device="cpu")
    eng.submit(engine.Request(rid=0, prompt=first, max_new=6))
    eng.run_until_drained()
    r = engine.Request(rid=1, prompt=second, max_new=6)
    eng.submit(r)
    eng._admit()
    _, pre = make_prefill_step(cfg)(params, {"inputs": torch.from_numpy(
        second[None].copy())})
    for k, v in eng._cache.items():
        want = pre[k][:, 0]
        got = v[:, 0, :want.shape[1]] if k in ("k", "v") else v[:, 0]
        assert torch.equal(got, want), k
    eng.run_until_drained()
    assert r.out_tokens == _port_run(name, [second], 1, 6)[0]


@pytest.mark.parametrize("name", NAMES)
def test_grouped_admission_matches_sequential_admission(name, rng):
    _, _, cfg, _ = _params(name)
    prompts = _prompts(rng, (6, 6, 20), cfg.vocab_size)
    grouped = _port_run(name, prompts, max_batch=3)
    serial = [_port_run(name, [p], max_batch=1)[0] for p in prompts]
    assert grouped == serial


# ---------------------------------------------------------- bytes, routes

@pytest.mark.parametrize("name", NAMES)
def test_compile_lm_service_bytes_equal_jax(name):
    jcfg, _, cfg, _ = _params(name)
    want = jax_rctc.compile_lm_service(jcfg, 4, 640, None, None)
    got = rctc.compile_lm_service(cfg, 4, 640, None, None)
    assert got.encode() == want.encode()
    assert got.encode(version=1) == want.encode(version=1)


@pytest.mark.parametrize("name", NAMES)
def test_params_image_crosses_both_ways(name):
    """The port packs the JAX package's image bytes, and reads the JAX
    package's image back (through a driver's residency) bit for bit."""
    _, jp, cfg, np_params = _params(name)
    image = jax_engine.pack_params_image(jp)
    assert engine.pack_params_image(_port_params(name)) == image
    back = engine.params_from_rimfs(cfg, rimfs.mount(image),
                                    driver=rhal.make_eager_driver("cpu"),
                                    device="cpu")
    assert sorted(back) == sorted(np_params)
    for k, v in np_params.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


@pytest.mark.parametrize("name", NAMES)
def test_server_lm_route_answers_with_the_local_engine_tokens(name, rng):
    _, _, cfg, _ = _params(name)
    prompts = _prompts(rng, (7, 19, 4), cfg.vocab_size)
    eng = engine.ServingEngine(cfg, _port_params(name), max_batch=2,
                               max_seq=MAX_SEQ, device="cpu")
    server = InferenceServer(device="cpu", engine=eng)
    client = Client(server.start())
    try:
        rids = [client.infer_async(prompt=p, max_new=4) for p in prompts]
        got = [client.result(rid, timeout=60)["tokens"] for rid in rids]
    finally:
        client.close()
        server.stop()
    want = [_port_run(name, [p], 1, 4)[0] for p in prompts]
    assert [g.tolist() for g in got] == want
