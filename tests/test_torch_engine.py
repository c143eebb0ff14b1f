"""The port's LM serving engine on the CPU against the JAX package's, on the
same parameters (carried across with ``params_from_jax``): attention's
prefill and decode paths, the forward passes, the weight image and the
service program's bytes, the engine's greedy token streams, admission,
shedding and residency, sampling, and the server's LM route."""
import dataclasses
import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.configs import get_config as jax_get_config
from repro.core import rctc as jax_rctc
from repro.launch.steps import make_decode_step as jax_decode_step
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.models import attention as jax_attn
from repro.models import transformer as jax_tf
from repro.models.common import init_params as jax_init_params
from repro.serving import engine as jax_engine
from repro_torch.configs import get_config
from repro_torch.core import rctc, rhal, rimfs
from repro_torch.launch.steps import sample_tokens
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.serving import engine
from repro_torch.serving.paged_engine import PagedServingEngine
from repro_torch.serving.scheduler import DeadlineScheduler
from repro_torch.serving.server import Client, InferenceServer, ServerBusy

CFG = "qwen2-1.5b-smoke"
OP_TOL = 1e-5                 # per op, and on the KV cache
LOGITS_TOL = 5e-4             # a whole fp32 program (test_conformance.py:700)


@functools.lru_cache(maxsize=None)
def _params():
    """The JAX package's parameters and the same values in the port."""
    jcfg = jax_get_config(CFG)
    jp = jax_init_params(jax.random.PRNGKey(0), jax_tf.model_specs(jcfg))
    np_params = {k: np.asarray(v) for k, v in jp.items()}
    return jcfg, jp, get_config(CFG), np_params


def _port_params():
    return tf.params_from_jax(_params()[3], device="cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _layer(rng, cfg):
    """One attention layer's weights with nonzero qkv biases, as numpy."""
    d, H, Hkv, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"wq": (d, H, D), "wk": (d, Hkv, D), "wv": (d, Hkv, D),
              "wo": (H, D, d), "bq": (H, D), "bk": (Hkv, D), "bv": (Hkv, D)}
    return {k: (rng.randn(*s) * 0.2).astype(np.float32)
            for k, s in shapes.items()}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def test_prefill_attention_matches_jax(rng):
    jcfg, _, cfg, _ = _params()
    assert cfg.qkv_bias
    jp, tp = _both(_layer(rng, cfg))
    x = rng.randn(2, 9, cfg.d_model).astype(np.float32)
    positions = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    jy, (jk, jv) = jax_attn.prefill_attention(jcfg, jp, jnp.asarray(x),
                                              jnp.asarray(positions))
    ty, (tk, tv) = attn.prefill_attention(cfg, tp, torch.from_numpy(x),
                                          torch.from_numpy(positions.copy()))
    _close(ty, jy, OP_TOL)
    _close(tk, jk, OP_TOL)
    _close(tv, jv, OP_TOL)


@pytest.mark.parametrize("pos", [(0, 0), (0, 5), (7, 3), (15, 15)])
def test_decode_attention_matches_jax(pos, rng):
    jcfg, _, cfg, _ = _params()
    jp, tp = _both(_layer(rng, cfg))
    B, S = 2, 16
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
    assert tk2 is tk and tv2 is tv          # written in place
    _close(ty, jy, OP_TOL)
    _close(tk, jk, OP_TOL)
    _close(tv, jv, OP_TOL)


def test_forward_full_logits_and_cache_match_jax(rng):
    jcfg, jp, cfg, _ = _params()
    toks = rng.randint(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    jl, jcache, _ = jax_tf.forward_full(jcfg, jp, jnp.asarray(toks),
                                        want_cache=True)
    params = _port_params()
    tl, tcache, _ = tf.forward_full(cfg, params, toks,
                                     want_cache=True)
    _close(tl, jl, LOGITS_TOL)
    for k in ("k", "v"):
        assert tuple(tcache[k].shape) == jcache[k].shape
        _close(tcache[k], jcache[k], OP_TOL)
    # the plain attention the card's check asks for: on the CPU the same
    # function as the kernel's CPU path
    plain, _, _ = tf.forward_full(cfg, params, toks, impl="ref")
    assert torch.equal(plain, tl)


def test_forward_decode_after_prefill_matches_jax(rng):
    jcfg, jp, cfg, _ = _params()
    B, plen, max_seq = 2, 6, 16
    toks = rng.randint(0, cfg.vocab_size, (B, plen)).astype(np.int32)
    _, jcache = jax_prefill_step(jcfg)(jp, {"inputs": jnp.asarray(toks)})
    cache = {k: np.zeros((cfg.num_layers, B, max_seq, cfg.num_kv_heads,
                          cfg.head_dim), np.float32) for k in ("k", "v")}
    for k in cache:
        cache[k][:, :, :plen] = np.asarray(jcache[k])
    nxt = rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.full((B,), plen, np.int32)
    jl, jnew = jax_decode_step(jcfg)(
        jp, {k: jnp.asarray(v) for k, v in cache.items()},
        {"inputs": jnp.asarray(nxt), "pos": jnp.asarray(pos)})
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tl, tnew = tf.forward_decode(cfg, _port_params(), nxt,
                                 torch.from_numpy(pos), tcache)
    _close(tl[:, 0], jl, LOGITS_TOL)
    for k in ("k", "v"):
        assert tnew[k] is tcache[k]         # the cache is updated in place
        _close(tnew[k], jnew[k], OP_TOL)


def test_engine_path_refuses_the_families_it_lacks():
    """What the engine path still lacks raises: a family the port does not
    have, and in the serving engines input that is not tokens (the vlm and
    audio frontends), as the JAX package's engines refuse it; under them
    ``cache_specs`` and ``forward_full`` compute on embeddings. Experts are
    served (``tests/test_torch_moe.py``)."""
    base = get_config(CFG)
    assert set(tf.cache_specs(dataclasses.replace(base, num_experts=4,
                                                  family="moe"), 1, 8)) \
        == {"k", "v"}
    encoder = dataclasses.replace(base, family="encoder")
    with pytest.raises(NotImplementedError, match="not ported"):
        tf.cache_specs(encoder, 1, 8)
    with pytest.raises(NotImplementedError, match="not ported"):
        tf.forward_full(encoder, {}, np.zeros((1, 4), np.int32))
    emb = dataclasses.replace(base, input_kind="embeddings",
                              tie_embeddings=False)
    assert set(tf.cache_specs(emb, 1, 8)) == {"k", "v"}
    params = tf.init_params(emb, 0, device="cpu")
    x = np.random.RandomState(0).randn(1, 4, emb.d_model).astype(np.float32)
    logits, cache, _ = tf.forward_full(emb, params, x, want_cache=True)
    assert tuple(logits.shape) == (1, 4, emb.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert tuple(cache["k"].shape[:3]) == (emb.num_layers, 1, 4)
    for engine_cls in (engine.ServingEngine, PagedServingEngine):
        with pytest.raises(NotImplementedError, match="token prompts"):
            engine_cls(emb, params, max_batch=1, max_seq=16, device="cpu")


@pytest.mark.parametrize("S", [4, 7])
def test_sliding_window_past_w_takes_the_windowed_route(S, monkeypatch):
    """A sliding window of W = 4: at S = W the prefill is the kernel's
    causal attention; at S > W it takes the windowed stock route, whose
    rows attend to the last W keys only."""
    sliding = dataclasses.replace(get_config(CFG), attention="sliding",
                                  sliding_window=4)
    p = _both(_layer(np.random.RandomState(0), sliding))[1]
    calls = []
    kernel = attn.flash_attention
    monkeypatch.setattr(attn, "flash_attention",
                        lambda *a, **kw: calls.append(1) or kernel(*a, **kw))
    x = torch.from_numpy(np.random.RandomState(1).randn(
        1, S, sliding.d_model).astype(np.float32))
    positions = torch.arange(S, dtype=torch.int32)[None]
    y = attn.full_attention(sliding, p, x, positions)
    assert len(calls) == (1 if S <= 4 else 0)
    full = dataclasses.replace(sliding, attention="full")
    y_full = attn.full_attention(full, p, x, positions)
    _close(y[:, :4], y_full[:, :4], OP_TOL)
    if S > 4:
        assert not torch.allclose(y[:, 4:], y_full[:, 4:], atol=1e-3)


def test_pack_params_image_bytes_equal_jax():
    _, jp, _, _ = _params()
    assert engine.pack_params_image(_port_params()) == \
        jax_engine.pack_params_image(jp)


@pytest.mark.parametrize("with_driver", [False, True])
def test_params_from_rimfs_reads_the_jax_image_bit_for_bit(with_driver):
    jcfg, jp, cfg, np_params = _params()
    fs = rimfs.mount(jax_engine.pack_params_image(jp))
    drv = rhal.make_eager_driver("cpu") if with_driver else None
    back = engine.params_from_rimfs(cfg, fs, driver=drv, device="cpu")
    assert sorted(back) == sorted(np_params)
    for k, v in np_params.items():
        assert back[k].dtype == torch.float32
        np.testing.assert_array_equal(back[k].numpy(), v)


@pytest.mark.parametrize("batch,max_seq", [(2, 64), (4, 640)])
def test_compile_lm_service_bytes_equal_jax(batch, max_seq):
    jcfg, _, cfg, _ = _params()
    want = jax_rctc.compile_lm_service(jcfg, batch, max_seq, None, None)
    got = rctc.compile_lm_service(cfg, batch, max_seq, None, None)
    assert got.encode() == want.encode()
    assert got.encode(version=1) == want.encode(version=1)


def _prompts(rng, lengths, vocab):
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lengths]


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


def test_engine_greedy_streams_equal_jax(rng):
    """5 prompts of ragged lengths over 2 slots, max_new=4: the token
    streams equal the JAX engine's."""
    jcfg, jp, cfg, _ = _params()
    prompts = _prompts(rng, (5, 9, 5, 3, 12), cfg.vocab_size)
    want = _run(jax_engine.ServingEngine, jax_engine.Request, jcfg, jp,
                prompts, 2)
    got = _run(engine.ServingEngine, engine.Request, cfg, _port_params(),
               prompts, 2, device="cpu")
    assert got == want
    assert all(len(t) == 5 for t in got)          # max_new + the prefill's


def test_engine_matches_an_offline_greedy_recompute(rng):
    """Engine tokens equal a straight greedy decode: ``forward_full`` over
    the prompt and the tokens so far, one token at a time."""
    _, _, cfg, _ = _params()
    params = _port_params()
    prompt = rng.randint(0, cfg.vocab_size, (8,)).astype(np.int32)
    got = _run(engine.ServingEngine, engine.Request, cfg, params, [prompt],
               2, device="cpu")[0]
    toks, want = list(prompt), []
    for _ in range(5):
        logits, _, _ = tf.forward_full(cfg, params,
                                       np.asarray(toks)[None])
        want.append(int(torch.argmax(logits[0, -1])))
        toks.append(want[-1])
    assert got == want


def test_grouped_admission_matches_sequential_admission(rng):
    """Prompts admitted together (each prefilled at B = 1, in admission
    order) give the same tokens as the same prompts admitted one at a
    time."""
    _, _, cfg, _ = _params()
    params = _port_params()
    prompts = _prompts(rng, (6, 6, 6), cfg.vocab_size)
    grouped = _run(engine.ServingEngine, engine.Request, cfg, params,
                   prompts, 3, device="cpu")
    serial = [_run(engine.ServingEngine, engine.Request, cfg, params, [p], 1,
                   device="cpu")[0] for p in prompts]
    assert grouped == serial


def test_engine_sheds_through_its_scheduler_and_feeds_the_ewma(rng):
    _, _, cfg, _ = _params()
    sched = DeadlineScheduler(step_latency_estimate=123.0)
    eng = engine.ServingEngine(cfg, _port_params(), max_batch=2, max_seq=64,
                               scheduler=sched, device="cpu")
    prompt = rng.randint(0, cfg.vocab_size, (4,)).astype(np.int32)
    good = engine.Request(rid=0, prompt=prompt, max_new=3)
    bad = engine.Request(rid=1, prompt=prompt, max_new=3,
                         deadline=time.monotonic() - 1.0)   # already past
    eng.submit(good)
    eng.submit(bad)
    assert sched.pending() == 2
    eng.run_until_drained()
    assert bad.done and bad.shed and bad.verdict_kind == "infeasible"
    assert bad.out_tokens == []                 # no compute spent on it
    assert good.done and not good.shed and good.verdict == "admitted"
    assert len(good.out_tokens) == 4 and sched.shed_count == 1
    assert 0.0 < sched.est < 123.0 and sched.observations == 3
    assert eng.telemetry.summary()["n"] == 3    # one latency a decode step


def test_engine_counts_the_kv_rows_its_decode_attends(rng):
    """``decode.rows_attended`` adds each live lane's min(pos + 1, S)
    rows a decode step, and ``decode.rows_held`` every slot's S rows: 3
    prompts over 2 slots, so a slot frees and refills."""
    _, _, cfg, _ = _params()
    eng = engine.ServingEngine(cfg, _port_params(), max_batch=2, max_seq=64,
                               device="cpu")
    inner, attended = eng._decode, []

    def rec(params, cache, batch):
        live = [i for i, r in enumerate(eng._slots) if r is not None]
        attended.append(sorted(int(batch["pos"][i]) + 1 for i in live))
        return inner(params, cache, batch)
    eng._decode = rec
    prompts = _prompts(rng, (5, 9, 3), cfg.vocab_size)
    for i, (p, n) in enumerate(zip(prompts, (3, 6, 2))):
        eng.submit(engine.Request(rid=i, prompt=p, max_new=n))
    eng.run_until_drained()
    assert attended[:4] == [[6, 10], [7, 11], [8, 12], [4, 13]]
    tel = eng.telemetry
    assert tel.counter("decode.rows_attended") == sum(map(sum, attended))
    assert tel.counter("decode.rows_held") == len(attended) * 2 * 64


def test_second_engine_from_rimfs_moves_zero_dma_bytes(rng):
    _, _, cfg, _ = _params()
    fs = rimfs.mount(engine.pack_params_image(_port_params()))
    drv = rhal.make_eager_driver("cpu")
    eng1 = engine.ServingEngine.from_rimfs(cfg, fs, driver=drv, max_batch=2,
                                           max_seq=64, device="cpu")
    assert drv.stats.get("dma_bytes", 0) > 0
    snapshot = dict(drv.stats)
    eng2 = engine.ServingEngine.from_rimfs(cfg, fs, driver=drv, max_batch=2,
                                           max_seq=64, device="cpu")
    for key in ("dma", "dma_async", "dma_bytes"):
        assert drv.stats.get(key, 0) == snapshot.get(key, 0), key
    assert all(eng2.params[k] is v for k, v in eng1.params.items())
    prompt = rng.randint(0, cfg.vocab_size, (6,)).astype(np.int32)
    outs = []
    for eng in (eng1, eng2):
        r = engine.Request(rid=0, prompt=prompt, max_new=3)
        eng.submit(r)
        eng.run_until_drained()
        outs.append(r.out_tokens)
    assert outs[0] == outs[1]


def test_engine_entry_points_refuse_params_elsewhere():
    _, _, cfg, np_params = _params()
    params = {k: torch.empty(v.shape, device="meta")
              for k, v in np_params.items()}
    with pytest.raises(ValueError, match="not on the engine's device"):
        engine.ServingEngine(cfg, params, device="cpu")


def test_sample_tokens_greedy_takes_the_first_maximum():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0],
                           [2.0, 2.0, 2.0, 2.0],
                           [0.0, -1.0, 0.0, 5.0]])
    got = sample_tokens(logits, greedy=True, temperature=1.0)
    assert got.dtype == torch.int32 and got.tolist() == [1, 0, 3]
    want = np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), axis=-1))
    assert got.tolist() == want.tolist()


def test_temperature_sampling_follows_softmax_over_temperature():
    """A seeded torch.Generator draws from softmax(logits / T): a
    chi-square test over 6000 draws (only the distribution, not the
    tokens, can match jax.random's)."""
    rng = np.random.RandomState(3)
    logits = torch.from_numpy(rng.randn(8).astype(np.float32) * 2)
    T, n = 0.7, 6000
    gen = torch.Generator()
    gen.manual_seed(0)
    draws = sample_tokens(logits.expand(n, 8), greedy=False, temperature=T,
                          generator=gen)
    counts = np.bincount(draws.numpy(), minlength=8)
    p = torch.softmax(logits / T, dim=-1).double().numpy()
    chi2 = float(((counts - n * p) ** 2 / (n * p)).sum())
    assert chi2 < stats.chi2.ppf(0.999, df=7), (chi2, counts, n * p)
    again = torch.Generator()
    again.manual_seed(0)
    assert torch.equal(draws, sample_tokens(logits.expand(n, 8), False, T,
                                            again))
    with pytest.raises(ValueError, match="Generator"):
        sample_tokens(logits[None], greedy=False, temperature=T)


# ------------------------------------------------------- the server's route

def _lm_server(max_batch=2, **kw):
    _, _, cfg, _ = _params()
    eng = engine.ServingEngine(cfg, _port_params(), max_batch=max_batch,
                               max_seq=64, device="cpu")
    server = InferenceServer(device="cpu", engine=eng, **kw)
    return server, Client(server.start())


def _hold_engine(server):
    """Keep the dispatcher from stepping the engine (it still parses and
    submits prompts) until the returned event is set."""
    gate = threading.Event()

    def install():
        # on the dispatcher thread: no call of the old hook is under way
        idle = server._loop.on_idle
        server._loop.on_idle = lambda: idle() if gate.is_set() else False

    server.run_on_dispatcher(install)
    return gate


def _wait(cond, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def _local_tokens(cfg, prompts, max_batch=2, max_new=4):
    return _run(engine.ServingEngine, engine.Request, cfg, _port_params(),
                prompts, max_batch, max_new, device="cpu")


def test_served_tokens_equal_the_local_engine(rng):
    _, _, cfg, _ = _params()
    prompts = _prompts(rng, (7, 7, 4), cfg.vocab_size)
    server, client = _lm_server()
    try:
        gate = _hold_engine(server)
        rids = [client.infer_async(prompt=p, max_new=4) for p in prompts]
        _wait(lambda: server.engine.pending() == len(prompts),
              "every prompt in the engine's queue")
        gate.set()
        got = [client.result(rid, timeout=60)["tokens"] for rid in rids]
        tel = client.telemetry()
    finally:
        client.close()
        server.stop()
    want = _local_tokens(cfg, prompts)
    assert [g.tolist() for g in got] == want
    assert all(g.dtype == np.int32 for g in got)
    assert tel["engine"]["n"] >= 2 and tel["serving"]["inflight"] == 0


def test_pipelined_prompts_on_one_connection_return_by_id(rng):
    _, _, cfg, _ = _params()
    prompts = _prompts(rng, (3, 8, 5, 8), cfg.vocab_size)
    server, client = _lm_server()
    try:
        rids = [client.infer_async(prompt=p, max_new=3) for p in prompts]
        got = {rid: client.result(rid, timeout=60)["tokens"]
               for rid in reversed(rids)}
    finally:
        client.close()
        server.stop()
    for rid, p in zip(rids, prompts):
        assert got[rid].tolist() == _local_tokens(cfg, [p], 1, 3)[0]


def test_prompt_plus_max_new_past_max_seq_is_an_error(rng):
    server, client = _lm_server()
    try:
        with pytest.raises(RuntimeError, match="exceeds engine max_seq 64"):
            client.infer(prompt=np.zeros(60, np.int32), max_new=4,
                         timeout=30)
        ok = client.infer(prompt=np.zeros(50, np.int32), max_new=2,
                          timeout=60)["tokens"]
    finally:
        client.close()
        server.stop()
    assert ok.shape == (3,)


def test_in_flight_cap_answers_busy(rng):
    _, _, cfg, _ = _params()
    prompts = _prompts(rng, (5, 5), cfg.vocab_size)
    server, client = _lm_server(max_queue=1)
    gate, started = threading.Event(), threading.Event()

    def install():                      # on the dispatcher thread
        inner = server._loop.handler

        def gated(item):
            started.set()
            gate.wait(30)
            inner(item)

        server._loop.handler = gated

    server.run_on_dispatcher(install)
    try:
        first = client.infer_async(prompt=prompts[0], max_new=4)
        assert started.wait(10)                 # the first prompt, held
        second = client.infer_async(prompt=prompts[1], max_new=4)
        _wait(lambda: server._loop.depth() == 1, "the second prompt queued")
        gate.set()
        with pytest.raises(ServerBusy, match="in-flight") as busy:
            client.result(second, timeout=30)
        assert busy.value.kind == "busy" and busy.value.retryable
        got = client.result(first, timeout=60)["tokens"]
        assert client.telemetry()["serving"]["rejected"] >= 1
    finally:
        gate.set()
        client.close()
        server.stop()
    assert got.tolist() == _local_tokens(cfg, prompts[:1], 1)[0]
