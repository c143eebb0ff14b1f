"""The port's paged-KV serving engine on the CPU against the JAX package's,
on the same parameters (carried across with ``params_from_jax``):
paged decode attention and the paged forward pass on the same pool, tables
and positions, the prefill scatter, the service program's bytes, greedy
streams against the JAX ``PagedServingEngine`` and the port's dense
engine, and the engine's contracts from ``tests/test_paged_engine.py``
(window token counts, block-aware shedding, recycling, residency, the
compiled rungs, sampling, ``max_new``, the server's LM route)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import rctc as jax_rctc
from repro.models import attention as jax_attn
from repro.models import transformer as jax_tf
from repro.models.common import init_params as jax_init_params
from repro.serving import engine as jax_engine
from repro.serving import paged_engine as jax_paged_engine
from repro_torch.configs import get_config
from repro_torch.core import rctc, rhal, rimfs
from repro_torch.launch.steps import make_paged_decode_step
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.serving.engine import (Request, ServingEngine,
                                        pack_params_image)
from repro_torch.serving.paged_engine import (DECODE_WINDOWS,
                                              PagedServingEngine)
from repro_torch.serving.scheduler import DeadlineScheduler
from repro_torch.serving.server import Client, InferenceServer

CFG = "qwen2-1.5b-smoke"
OP_TOL = 1e-5                 # per op, and on the pool's written rows
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


def _pool_and_tables(rng, cfg, layers, B=3, nb=12, bs=4, W=4):
    """A random pool (layers, nb + 1, bs, Hkv, D), B lanes' tables of
    disjoint blocks (lane 2 a pad lane, all null) and positions inside
    each lane's blocks."""
    pool = [rng.randn(layers, nb + 1, bs, cfg.num_kv_heads, cfg.head_dim)
            .astype(np.float32) for _ in range(2)]
    tables = np.full((B, W), nb, np.int32)
    tables[0, :3] = (5, 0, 9)
    tables[1, :2] = (3, 7)
    pos = np.asarray([10, 5, 0][:B], np.int32)
    return pool, tables, pos


def _written_rows(tables, pos, bs, W):
    """(block, offset) each live lane writes."""
    return {(int(tables[b, (p // bs) % W]), int(p % bs))
            for b, p in enumerate(pos) if tables[b, 0] != tables[-1, -1]}


def _check_pool(got, want, written, null):
    """Written rows at OP_TOL; every other row (the null block aside, which
    pad lanes write in an unspecified order) bit for bit."""
    got, want = np.asarray(got), np.asarray(want)
    mask = np.ones(got.shape[:-2], bool)
    mask[..., null, :] = False
    for blk, off in written:
        mask[..., blk, off] = False
        _close(got[..., blk, off, :, :], want[..., blk, off, :, :], OP_TOL)
    np.testing.assert_array_equal(got[mask], want[mask])


def _layer(rng, cfg):
    d, H, Hkv, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"wq": (d, H, D), "wk": (d, Hkv, D), "wv": (d, Hkv, D),
              "wo": (H, D, d), "bq": (H, D), "bk": (Hkv, D), "bv": (Hkv, D)}
    return {k: (rng.randn(*s) * 0.2).astype(np.float32)
            for k, s in shapes.items()}


def test_decode_attention_paged_matches_jax(rng):
    jcfg, _, cfg, _ = _params()
    p = _layer(rng, cfg)
    (pk, pv), tables, pos = _pool_and_tables(rng, cfg, 1)
    pk, pv = pk[0], pv[0]
    x = rng.randn(3, 1, cfg.d_model).astype(np.float32)
    jy, jk, jv = jax_attn.decode_attention_paged(
        jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(pos), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables))
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    ty, tk2, tv2 = attn.decode_attention_paged(
        cfg, {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(x), torch.from_numpy(pos), tk, tv,
        torch.from_numpy(tables))
    assert tk2 is tk and tv2 is tv          # written in place
    _close(ty[:2], jy[:2], OP_TOL)          # lane 2 is a pad lane
    written = _written_rows(tables, pos, 4, 4)
    assert len(written) == 2
    _check_pool(tk, jk, written, 12)
    _check_pool(tv, jv, written, 12)


def test_forward_decode_paged_matches_jax(rng):
    jcfg, jp, cfg, _ = _params()
    (pk, pv), tables, pos = _pool_and_tables(rng, cfg, cfg.num_layers)
    toks = rng.randint(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    jl, jk, jv = jax_tf.forward_decode_paged(
        jcfg, jp, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(pk),
        jnp.asarray(pv), jnp.asarray(tables))
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    tl, tk2, tv2 = tf.forward_decode_paged(
        cfg, _port_params(), toks, torch.from_numpy(pos), tk, tv,
        torch.from_numpy(tables))
    assert tk2 is tk and tv2 is tv
    _close(tl[:2], jl[:2], LOGITS_TOL)
    written = _written_rows(tables, pos, 4, 4)
    _check_pool(tk, jk, written, 12)
    _check_pool(tv, jv, written, 12)


def _pad_lanes(tables, lanes, null):
    """``tables`` with null rows appended up to ``lanes`` rows, as the
    engine hands them to the decode step."""
    out = np.full((lanes, tables.shape[1]), null, np.int32)
    out[:len(tables)] = tables
    return out


def test_decode_attention_paged_lane_padded_tables_match_jax(rng):
    """Tables with null lanes past B, the shape the engine decodes at (its
    max_batch lanes over fewer live ones), against the JAX package's
    function on the B lanes' own tables: the same outputs and pool."""
    jcfg, _, cfg, _ = _params()
    p = _layer(rng, cfg)
    (pk, pv), tables, pos = _pool_and_tables(rng, cfg, 1)
    pk, pv = pk[0], pv[0]
    x = rng.randn(3, 1, cfg.d_model).astype(np.float32)
    jy, jk, jv = jax_attn.decode_attention_paged(
        jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(pos), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables))
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    ty, _, _ = attn.decode_attention_paged(
        cfg, {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(x), torch.from_numpy(pos), tk, tv,
        torch.from_numpy(_pad_lanes(tables, 5, 12)))
    assert tuple(ty.shape) == (3, 1, cfg.d_model)
    _close(ty[:2], jy[:2], OP_TOL)
    written = _written_rows(tables, pos, 4, 4)
    _check_pool(tk, jk, written, 12)
    _check_pool(tv, jv, written, 12)


def test_forward_decode_paged_lane_padded_tables_match_jax(rng):
    jcfg, jp, cfg, _ = _params()
    (pk, pv), tables, pos = _pool_and_tables(rng, cfg, cfg.num_layers)
    toks = rng.randint(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    jl, jk, jv = jax_tf.forward_decode_paged(
        jcfg, jp, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(pk),
        jnp.asarray(pv), jnp.asarray(tables))
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    tl, _, _ = tf.forward_decode_paged(
        cfg, _port_params(), toks, torch.from_numpy(pos), tk, tv,
        torch.from_numpy(_pad_lanes(tables, 4, 12)))
    assert tuple(tl.shape) == (3, 1, cfg.vocab_size)
    _close(tl[:2], jl[:2], LOGITS_TOL)
    written = _written_rows(tables, pos, 4, 4)
    _check_pool(tk, jk, written, 12)
    _check_pool(tv, jv, written, 12)


def test_paged_decode_equals_dense_decode_on_the_same_rows(rng):
    """The paged step over W gathered blocks and the dense step over a
    cache of the same W * block_size rows give the same logits bit for bit
    (the promise the paged engine's streams rest on). Over another number
    of rows the sums may round otherwise, even where the extra rows are
    masked: the card-only tests hold the engine's shapes against the dense
    step's."""
    _, _, cfg, _ = _params()
    params = _port_params()
    bs, W, plen = 4, 3, 9
    pos = torch.tensor([plen, plen - 4], dtype=torch.int32)
    dense = {k: torch.from_numpy(rng.randn(
        cfg.num_layers, 2, W * bs, cfg.num_kv_heads, cfg.head_dim)
        .astype(np.float32)) for k in ("k", "v")}
    tables = torch.tensor([[4, 1, 6], [2, 0, 3]], dtype=torch.int32)
    pool = {k: torch.zeros((cfg.num_layers, 8, bs, cfg.num_kv_heads,
                            cfg.head_dim)) for k in ("k", "v")}
    for b in range(2):
        for t in range(W * bs):
            for k in pool:
                pool[k][:, tables[b, t // bs], t % bs] = dense[k][:, b, t]
    toks = np.asarray([[3], [17]], np.int32)
    dl, _ = tf.forward_decode(cfg, params, toks, pos, dense)
    pl, _, _ = tf.forward_decode_paged(cfg, params, toks, pos, pool["k"],
                                       pool["v"], tables)
    assert torch.equal(dl, pl)
    for b in range(2):
        t = int(pos[b])
        for k in pool:
            assert torch.equal(pool[k][:, tables[b, t // bs], t % bs],
                               dense[k][:, b, t])


def test_scatter_prefill_cache_matches_jax_exactly(rng):
    _, _, cfg, _ = _params()
    L, B, S, nb, bs = 2, 3, 10, 12, 4
    cache = [rng.randn(L, B, S, 2, 8).astype(np.float32) for _ in range(2)]
    pool = [rng.randn(L, nb + 1, bs, 2, 8).astype(np.float32)
            for _ in range(2)]
    tables = np.full((B, 3), nb, np.int32)
    tables[0] = (4, 0, 11)
    tables[1] = (2, 9, 5)                   # lane 2 pads into the null row
    jk, jv = jax_tf.scatter_prefill_cache(*(jnp.asarray(a) for a in pool),
                                          *(jnp.asarray(a) for a in cache),
                                          jnp.asarray(tables))
    tk, tv = (torch.from_numpy(a.copy()) for a in pool)
    out = tf.scatter_prefill_cache(tk, tv, *(torch.from_numpy(a)
                                             for a in cache),
                                   torch.from_numpy(tables))
    assert out[0] is tk and out[1] is tv
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(got[:, :nb].numpy(),
                                      np.asarray(want)[:, :nb])


@pytest.mark.parametrize("greedy,temperature", [(True, 1.0), (False, 0.7)])
@pytest.mark.parametrize("batch,max_seq,bs,nb", [(2, 64, 8, 16),
                                                 (4, 640, 16, 160)])
def test_compile_paged_lm_service_bytes_equal_jax(batch, max_seq, bs, nb,
                                                  greedy, temperature):
    jcfg, _, cfg, _ = _params()
    want = jax_rctc.compile_paged_lm_service(jcfg, batch, max_seq, bs, nb,
                                             None, None, greedy, temperature)
    got = rctc.compile_paged_lm_service(cfg, batch, max_seq, bs, nb, None,
                                        None, greedy, temperature)
    assert got.encode() == want.encode()
    assert got.encode(version=1) == want.encode(version=1)
    assert got.crc() == want.crc()


@pytest.mark.parametrize("bad", [
    {"family": "hybrid"}, {"family": "ssm"},
    {"attention": "sliding", "sliding_window": 8}])
def test_paged_path_refuses_recurrent_and_sliding_families(bad):
    cfg = dataclasses.replace(get_config(CFG), **bad)
    with pytest.raises(NotImplementedError, match="full-attention"):
        tf.forward_decode_paged(cfg, {}, np.zeros((1, 1), np.int32),
                                torch.zeros(1, dtype=torch.int32), None,
                                None, None)
    with pytest.raises(NotImplementedError, match="full-attention"):
        PagedServingEngine(cfg, {}, device="cpu")


# ------------------------------------------------------------ the engine

def _requests(cfg, rng, n, plen=6, max_new=4):
    return [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, (plen,))
                    .astype(np.int32), max_new=max_new) for i in range(n)]


def _drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return [r.out_tokens for r in reqs]


def _paged(params=None, **kw):
    kw = {"max_batch": 2, "max_seq": 64, "block_size": 8, **kw}
    return PagedServingEngine(_params()[2], params or _port_params(),
                              device="cpu", **kw)


@pytest.mark.parametrize("batch", [1, 4])
def test_paged_greedy_streams_equal_jax_and_dense(rng, batch):
    """Greedy decode through the paged windows equals the JAX package's
    paged engine and the port's dense engine, token for token, at batch 1
    and at max_batch: same prompts, same admission order."""
    jcfg, jp, cfg, _ = _params()
    prompts = [rng.randint(0, cfg.vocab_size, (5 + 2 * (i % 3),))
               .astype(np.int32) for i in range(batch)]
    kw = dict(max_batch=batch, max_seq=64)
    want = _drain(jax_paged_engine.PagedServingEngine(jcfg, jp, block_size=8,
                                                      **kw),
                  [jax_engine.Request(rid=i, prompt=p, max_new=6)
                   for i, p in enumerate(prompts)])
    params = _port_params()
    paged = _drain(_paged(params, **kw),
                   [Request(rid=i, prompt=p, max_new=6)
                    for i, p in enumerate(prompts)])
    dense = _drain(ServingEngine(cfg, params, device="cpu", **kw),
                   [Request(rid=i, prompt=p, max_new=6)
                    for i, p in enumerate(prompts)])
    assert paged == want == dense
    assert all(len(t) == 7 for t in paged)


@pytest.mark.parametrize("max_batch", [3, 5])
def test_paged_streams_at_a_max_batch_not_a_power_of_two(rng, max_batch):
    """Every slot live at a max_batch that is not a power of two (the
    bucket capped at max_batch): greedy streams equal the JAX package's
    paged engine and the port's dense engine, token for token."""
    jcfg, jp, cfg, _ = _params()
    prompts = [rng.randint(0, cfg.vocab_size, (4 + 3 * i,))
               .astype(np.int32) for i in range(max_batch + 2)]
    max_new = [5 + (i % 4) for i in range(len(prompts))]
    kw = dict(max_batch=max_batch, max_seq=64)
    want = _drain(jax_paged_engine.PagedServingEngine(jcfg, jp, block_size=8,
                                                      **kw),
                  [jax_engine.Request(rid=i, prompt=p, max_new=n)
                   for i, (p, n) in enumerate(zip(prompts, max_new))])
    params = _port_params()
    paged = _drain(_paged(params, **kw),
                   [Request(rid=i, prompt=p, max_new=n)
                    for i, (p, n) in enumerate(zip(prompts, max_new))])
    dense = _drain(ServingEngine(cfg, params, device="cpu", **kw),
                   [Request(rid=i, prompt=p, max_new=n)
                    for i, (p, n) in enumerate(zip(prompts, max_new))])
    assert paged == want == dense
    assert [len(t) for t in paged] == [n + 1 for n in max_new]


@pytest.mark.parametrize("max_batch,buckets", [(1, [1]), (2, [1, 2]),
                                               (3, [1, 2, 3]),
                                               (4, [1, 2, 4]),
                                               (5, [1, 2, 4, 5])])
def test_dispatches_stay_within_the_compiled_rungs(rng, max_batch, buckets):
    """The engine compiles one window a (bucket, window) rung, buckets the
    powers of two capped at max_batch, and every dispatch of a burst that
    fills and drains the slots lands on one of them, over tables of
    (max_batch, max_seq / block_size); a batch off the rungs raises."""
    cfg = _params()[2]
    eng = _paged(max_batch=max_batch)
    assert eng.buckets == buckets
    assert set(eng._decode.rungs) == {(b, w) for b in buckets
                                      for w in DECODE_WINDOWS}
    seen, inner = [], eng._decode

    def rec(params, pool_k, pool_v, batch, window):
        seen.append((batch["tokens"].shape[0], window,
                     tuple(batch["tables"].shape)))
        return inner(params, pool_k, pool_v, batch, window)
    eng._decode = rec
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, (5,))
                    .astype(np.int32), max_new=3 + 4 * i)
            for i in range(max_batch + 1)]
    _drain(eng, reqs)
    assert {b for b, _, _ in seen} == set(buckets)
    assert all((b, w) in inner.rungs and t == (max_batch, 8)
               for b, w, t in seen)
    one = {"tokens": torch.zeros(1, dtype=torch.int32),
           "pos": torch.zeros(1, dtype=torch.int32),
           "tables": torch.zeros((max_batch, 4), dtype=torch.int32)}
    with pytest.raises(ValueError, match="no decode window"):
        inner(inner.params, inner.pool_k, inner.pool_v, one, 8)


def test_one_window_equals_single_token_windows(rng):
    """A window of 4 (forward, sample, feed back four times in one call)
    leaves the same tokens and pool as four windows of 1."""
    _, _, cfg, _ = _params()
    params = _port_params()
    eng = _paged(params)
    req = _requests(cfg, rng, 1)[0]
    eng.submit(req)
    eng._admit()
    seq = eng._seqs[0]
    tables = torch.from_numpy(eng.cache.table_array([seq], width=2))
    tok = torch.tensor(req.out_tokens[-1:], dtype=torch.int32)
    pos = torch.tensor([int(eng._pos[0])], dtype=torch.int32)
    k0, v0 = eng.cache.k.clone(), eng.cache.v.clone()
    four, _, _ = make_paged_decode_step(cfg, 4)(
        params, eng.cache.k, eng.cache.v,
        {"tokens": tok, "pos": pos, "tables": tables})
    one = make_paged_decode_step(cfg, 1)
    singles = []
    for i in range(4):
        t, _, _ = one(params, k0, v0, {"tokens": tok, "pos": pos + i,
                                       "tables": tables})
        tok = t[:, 0]
        singles.append(t)
    assert four.dtype == torch.int32 and tuple(four.shape) == (1, 4)
    assert torch.equal(four, torch.cat(singles, dim=1))
    assert torch.equal(eng.cache.k, k0) and torch.equal(eng.cache.v, v0)


def test_decode_window_exact_token_count(rng):
    """The multi-token decode window must not overshoot: max_new counts
    decode tokens exactly, whatever the window ladder does."""
    cfg = _params()[2]
    assert DECODE_WINDOWS == (8, 4, 2, 1)
    for max_new in (0, 1, 3, 5, 8, 11):
        reqs = _requests(cfg, rng, 2, max_new=max_new)
        _drain(_paged(), reqs)
        assert all(len(r.out_tokens) == max(max_new, 1) + 1 for r in reqs)


def test_decode_window_stops_at_max_seq(rng):
    """A lane near max_seq gets windows that end at its last row."""
    cfg = _params()[2]
    req = Request(rid=0, prompt=rng.randint(0, cfg.vocab_size, (50,))
                  .astype(np.int32), max_new=40)
    eng = _paged()
    _drain(eng, [req])
    assert len(req.out_tokens) == 64 - 50       # pos reached max_seq - 1
    assert eng.cache.tables == {}


def test_out_of_blocks_is_shed_verdict_not_crash(rng):
    """Pool exhaustion surfaces as a scheduler shed verdict at admission —
    OutOfBlocksError never fires mid-step."""
    cfg = _params()[2]
    sched = DeadlineScheduler()
    # 4 blocks of 8 = 32 tokens; each request reserves 6+6=12 -> 2 blocks
    eng = _paged(max_batch=4, num_blocks=4, scheduler=sched)
    reqs = _requests(cfg, rng, 4, max_new=6)
    _drain(eng, reqs)
    served = [r for r in reqs if not r.shed]
    shed = [r for r in reqs if r.shed]
    assert len(served) == 2 and len(shed) == 2
    assert all(r.done and "out of KV blocks" in r.verdict
               and r.verdict_kind == "out_of_blocks" and r.out_tokens == []
               for r in shed)
    assert all(len(r.out_tokens) == 7 for r in served)
    assert sched.shed_count == 2


def test_fifo_path_sheds_on_block_pressure(rng):
    """Block-aware admission also guards the scheduler-less FIFO path."""
    cfg = _params()[2]
    eng = _paged(max_batch=4, num_blocks=2)
    reqs = _requests(cfg, rng, 3, max_new=6)
    _drain(eng, reqs)
    shed = [r for r in reqs if r.shed]
    assert len(shed) == 2
    assert all("out of KV blocks" in r.verdict and r.out_tokens == []
               for r in shed)
    assert all(r.done for r in reqs)


def test_blocks_recycle_after_completion(rng):
    """Completion releases blocks with no data moved; later waves reuse the
    same physical pool with no leaked table entries, and a prompt on
    recycled blocks gets the tokens it gets on a fresh pool."""
    cfg = _params()[2]
    params = _port_params()
    eng = _paged(params, num_blocks=4)
    total = eng.cache.num_blocks
    for wave in range(3):
        reqs = _requests(cfg, rng, 2, max_new=4)
        got = _drain(eng, reqs)
        assert all(r.done and not r.shed for r in reqs)
        assert eng.cache.tables == {} and eng.cache.lengths == {}
        assert eng.cache.free_blocks() == total
        fresh = _drain(_paged(params, num_blocks=4),
                       [Request(rid=r.rid, prompt=r.prompt, max_new=4)
                        for r in reqs])
        assert got == fresh


def test_pool_registers_with_device_arena(rng):
    """The KV pool's pages are arena-resident, and close() returns the
    ranges."""
    cfg, params = _params()[2], _port_params()
    fs = rimfs.mount(pack_params_image(params))
    drv = rhal.make_eager_driver("cpu")
    base = drv.arena.bytes_in_use
    eng = PagedServingEngine.from_rimfs(cfg, fs, driver=drv, max_batch=2,
                                        max_seq=64, block_size=8,
                                        device="cpu")
    assert eng.driver is drv
    assert drv.arena.bytes_in_use >= base + eng.cache.pool_bytes()
    _drain(eng, _requests(cfg, rng, 2, max_new=3))
    with_pool = drv.arena.bytes_in_use
    eng.close()
    assert drv.arena.bytes_in_use == with_pool - eng.cache.pool_bytes()


def test_same_crc_separate_rungs_each_engine_its_own_pool(rng):
    """Two engines over the same service program share its CRC but not
    their decode windows: each engine's windows are bound to its own pool
    (a CUDA graph bakes the addresses in) and hold the same rungs, and
    each engine decodes into its own pool only."""
    cfg, params = _params()[2], _port_params()
    e1, e2 = _paged(params), _paged(params)
    assert e1.program.crc() == e2.program.crc()
    assert e1._decode is not e2._decode
    assert e1._decode.pool_k is e1.cache.k and e2._decode.pool_k is \
        e2.cache.k
    assert e1._decode.rungs == e2._decode.rungs
    reqs = _requests(cfg, rng, 2, max_new=4)
    got1 = _drain(e1, reqs)
    untouched = e2.cache.k.clone(), e2.cache.v.clone()
    assert not untouched[0].any()
    got2 = _drain(e2, [Request(rid=r.rid, prompt=r.prompt, max_new=4)
                       for r in reqs])
    assert got1 == got2
    assert torch.equal(e1.cache.k, e2.cache.k)
    with pytest.raises(ValueError, match="compiled for other"):
        e1._decode(params, e2.cache.k, e2.cache.v, {}, 1)


def test_sampling_respects_greedy_flag(rng):
    """Temperature sampling diverges from argmax decoding, and is
    deterministic per seed, for the paged and the dense engine."""
    cfg, params = _params()[2], _port_params()
    prompt = rng.randint(0, cfg.vocab_size, (6,)).astype(np.int32)

    def run(make, **kw):
        r = Request(rid=0, prompt=prompt, max_new=8)
        _drain(make(**kw), [r])
        return r.out_tokens

    for make in (lambda **kw: ServingEngine(cfg, params, max_batch=1,
                                            max_seq=64, device="cpu", **kw),
                 lambda **kw: _paged(params, max_batch=1, **kw)):
        greedy = run(make, greedy=True)
        s0 = run(make, greedy=False, temperature=1.0, seed=0)
        s0b = run(make, greedy=False, temperature=1.0, seed=0)
        s1 = run(make, greedy=False, temperature=1.0, seed=1)
        assert s0 == s0b                      # deterministic per seed
        assert s0 != greedy or s1 != greedy   # the flag is live


def test_max_new_counts_decode_tokens(rng):
    """A request yields exactly ``max_new`` decode tokens; the prefill
    token rides along but does not consume the budget."""
    cfg, params = _params()[2], _port_params()
    for make in (lambda: ServingEngine(cfg, params, max_batch=2, max_seq=64,
                                       device="cpu"),
                 lambda: _paged(params)):
        reqs = _requests(cfg, rng, 2, max_new=4)
        _drain(make(), reqs)
        assert all(len(r.out_tokens) == 5 for r in reqs), \
            [len(r.out_tokens) for r in reqs]


def test_server_serves_paged_engine(rng):
    """The server's LM route serves a paged engine over the wire with
    tokens equal to a local run, and its telemetry reports the pool's
    occupancy."""
    cfg, params = _params()[2], _port_params()
    eng = _paged(params)
    server = InferenceServer(device="cpu", engine=eng)
    client = Client(server.start())
    try:
        prompts = [rng.randint(0, cfg.vocab_size, (6,)).astype(np.int32)
                   for _ in range(3)]
        rids = [client.infer_async(prompt=p, max_new=3) for p in prompts]
        outs = [client.result(rid, timeout=60)["tokens"] for rid in rids]
        tel = client.telemetry()
    finally:
        client.close()
        server.stop()
    kv = tel["engine"]["kv"]
    assert kv["num_blocks"] == 16 and kv["free_blocks"] == 16
    assert kv["block_size"] == 8 and kv["pool_bytes"] == \
        eng.cache.pool_bytes()
    refs = [Request(rid=i, prompt=p, max_new=3)
            for i, p in enumerate(prompts)]
    _drain(_paged(params), refs)
    for out, r in zip(outs, refs):
        assert out.tolist() == r.out_tokens
