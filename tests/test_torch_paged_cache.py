"""The port's paged KV cache on the CPU against the JAX package's: the
allocation and lifetime invariants of ``tests/test_paged_cache.py``, and
``gather`` and ``paged_decode_attention`` on the same numpy inputs (the pool
exactly, attention at 1e-5 in fp32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.serving import paged_cache as jax_paged
from repro_torch.serving.paged_cache import (OutOfBlocksError, PagedKVCache,
                                             paged_decode_attention)

OP_TOL = 1e-5


def _cache(blocks=8, bs=4, layers=2, hkv=2, d=8, dtype="float32"):
    return PagedKVCache(num_layers=layers, num_blocks=blocks, block_size=bs,
                        num_kv_heads=hkv, head_dim=d, dtype=dtype,
                        device="cpu")


def _both(blocks, bs, layers, hkv=2, d=8):
    """The port's cache and the JAX package's, same geometry."""
    return (_cache(blocks, bs, layers, hkv, d),
            jax_paged.PagedKVCache(num_layers=layers, num_blocks=blocks,
                                   block_size=bs, num_kv_heads=hkv,
                                   head_dim=d))


def test_allocation_and_release_roundtrip():
    c = _cache()
    c.allocate(1, tokens=10)            # ceil(10/4) = 3 blocks
    assert len(c.blocks_for(1)) == 3
    assert c.free_blocks() == 5
    assert c.release(1) == 3
    assert c.free_blocks() == 8
    assert c.blocks_for(1) == []


def test_pool_exhaustion_raises():
    c = _cache(blocks=2, bs=4)
    c.allocate(1, tokens=8)
    c.allocate(2)
    with pytest.raises(OutOfBlocksError):
        c._grow(2, 1)


def test_append_gather_match_contiguous_and_jax(rng):
    """11 appended tokens cross block boundaries: the gather equals the
    appended rows, and the port's pool and gather equal the JAX package's
    bit for bit (same block ids, same rows)."""
    c, jc = _both(blocks=16, bs=4, layers=3)
    c.allocate(7)
    jc.allocate(7)
    ref_k, ref_v = [], []
    for _ in range(11):
        lk = rng.randn(3, 2, 8).astype(np.float32)
        lv = rng.randn(3, 2, 8).astype(np.float32)
        c.append(7, torch.from_numpy(lk), torch.from_numpy(lv))
        jc.append(7, jnp.asarray(lk), jnp.asarray(lv))
        ref_k.append(lk)
        ref_v.append(lv)
    assert c.blocks_for(7) == jc.blocks_for(7)
    np.testing.assert_array_equal(c.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(c.v.numpy(), np.asarray(jc.v))
    for layer in range(3):
        k, v = c.gather(7, layer)
        jk, jv = jc.gather(7, layer)
        np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(
            k.numpy(), np.stack([r[layer] for r in ref_k]))
        np.testing.assert_array_equal(
            v.numpy(), np.stack([r[layer] for r in ref_v]))


def test_paged_attention_matches_dense_and_jax(rng):
    c, jc = _both(blocks=16, bs=4, layers=1)
    c.allocate(0)
    jc.allocate(0)
    ks, vs = [], []
    for _ in range(9):
        lk = rng.randn(1, 2, 8).astype(np.float32)
        lv = rng.randn(1, 2, 8).astype(np.float32)
        c.append(0, torch.from_numpy(lk), torch.from_numpy(lv))
        jc.append(0, jnp.asarray(lk), jnp.asarray(lv))
        ks.append(lk[0])
        vs.append(lv[0])
    q = rng.randn(4, 8).astype(np.float32)              # H=4, G=2
    o = paged_decode_attention(c, 0, 0, torch.from_numpy(q))
    jo = jax_paged.paged_decode_attention(jc, 0, 0, jnp.asarray(q))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=OP_TOL,
                               atol=OP_TOL)
    # dense reference
    K, V = np.stack(ks), np.stack(vs)
    qg = q.reshape(2, 2, 8)
    s = np.einsum("hgd,nhd->hgn", qg, K) / np.sqrt(8)
    p = np.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    ref = np.einsum("hgn,nhd->hgd", p, V).reshape(4, 8)
    np.testing.assert_allclose(o.numpy(), ref, atol=OP_TOL)


def test_gather_empty_respects_pool_dtype():
    """The zero-length gather returns empties in the pool's dtype:
    downstream concatenation must not silently upcast a bf16 pool."""
    c = _cache(blocks=4, bs=4, layers=1, dtype="bfloat16")
    c.allocate(0)
    k, v = c.gather(0, 0)
    assert tuple(k.shape) == (0, 2, 8) and tuple(v.shape) == (0, 2, 8)
    assert k.dtype == torch.bfloat16 and v.dtype == torch.bfloat16


def test_zero_length_attention_is_defined_error(rng):
    """Attention over zero stored tokens is a ValueError, not NaNs."""
    c = _cache(blocks=4, bs=4, layers=1)
    c.allocate(0)
    q = torch.from_numpy(rng.randn(4, 8).astype(np.float32))
    with pytest.raises(ValueError, match="zero-length"):
        paged_decode_attention(c, 0, 0, q)
    # unallocated sequence ids fail the same way (no KeyError leak)
    with pytest.raises(ValueError, match="zero-length"):
        paged_decode_attention(c, 99, 0, q)


def test_null_block_is_reserved_and_pads_tables():
    """The null row sits past the allocatable range (accounting is
    unchanged) and pads both axes of device table arrays, as the JAX
    package's does."""
    c, jc = _both(blocks=8, bs=4, layers=2)
    assert c.null_block == 8
    assert c.k.shape[1] == 9                 # num_blocks + 1 physical rows
    assert c.free_blocks() == 8              # null row never allocatable
    c.allocate(1, tokens=6)                  # 2 blocks
    jc.allocate(1, tokens=6)
    t = c.table_array([1, 2], width=4, rows=3)
    assert t.shape == (3, 4) and t.dtype == np.int32
    assert list(t[0][:2]) == c.blocks_for(1)
    assert (t[0][2:] == c.null_block).all()  # width padding
    assert (t[1] == c.null_block).all()      # unallocated seq -> all null
    assert (t[2] == c.null_block).all()      # rows padding
    np.testing.assert_array_equal(t, jc.table_array([1, 2], width=4, rows=3))
    assert list(c.lengths_array([1, 2], rows=3)) == [0, 0, 0]


def test_pool_is_zeroed_and_the_null_block_never_allocated():
    """The pool starts as zeros (an unwritten row gathered behind the mask
    gets weight 0, and 0 x NaN would be NaN), and no allocation, however
    the pool is drained and refilled, hands out the null block."""
    c = _cache(blocks=5, bs=2, layers=2)
    for buf in (c.k, c.v):
        assert buf.dtype == torch.float32 and not buf.any()
    assert c.null_block not in c._free
    for round_ in range(3):
        for seq in range(5):
            c.allocate(seq, tokens=2)
        with pytest.raises(OutOfBlocksError):
            c.allocate(99, tokens=1)
        held = [b for t in c.tables.values() for b in t]
        assert sorted(held) == list(range(5)) and c.null_block not in held
        for seq in range(5):
            c.release(seq)
        assert c.null_block not in c._free and c.free_blocks() == 5


def test_failed_reservation_rolls_back():
    """An allocate() that exhausts the pool mid-reservation must not leak
    a half-grown table."""
    c = _cache(blocks=3, bs=4)
    c.allocate(1, tokens=8)                  # 2 blocks
    with pytest.raises(OutOfBlocksError):
        c.allocate(2, tokens=12)             # needs 3, only 1 free
    assert 2 not in c.tables and 2 not in c.lengths
    assert c.free_blocks() == 1              # the partial grow rolled back


def test_engine_exhaustion_lifecycle_chaos(rng):
    """Fill the pool through the engine, observe shed verdicts (never
    OutOfBlocksError), release on completion, and verify freed blocks are
    reused with no leaked table entries across random admit/release
    rounds."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import Request
    from repro_torch.serving.paged_engine import PagedServingEngine
    from repro_torch.serving.scheduler import DeadlineScheduler

    cfg = get_config("qwen2-1.5b-smoke")
    params = tf.init_params(cfg, 0, device="cpu")
    eng = PagedServingEngine(cfg, params, max_batch=2, max_seq=32,
                             block_size=4, num_blocks=6,
                             scheduler=DeadlineScheduler(), device="cpu")
    total = eng.cache.num_blocks
    served = shed = 0
    rid = 0
    for round_ in range(4):
        reqs = []
        for _ in range(int(rng.randint(1, 5))):
            plen = int(rng.randint(2, 9))
            reqs.append(Request(
                rid=rid, prompt=rng.randint(0, cfg.vocab_size, (plen,))
                .astype(np.int32), max_new=int(rng.randint(1, 7))))
            rid += 1
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        for r in reqs:
            assert r.done
            if r.shed:
                shed += 1
                assert "out of KV blocks" in r.verdict
                assert r.verdict_kind == "out_of_blocks"
                assert r.out_tokens == []        # zero compute spent
            else:
                served += 1
                assert len(r.out_tokens) == r.max_new + 1
        # drained => every block released, no leaked table entries
        assert eng.cache.tables == {} and eng.cache.lengths == {}
        assert eng.cache.free_blocks() == total
    assert served > 0        # freed blocks were reused across rounds


@given(st.lists(st.tuples(st.integers(0, 5), st.integers(1, 9)),
                min_size=1, max_size=24))
@settings(max_examples=40, deadline=None)
def test_property_no_block_leaks_or_double_use(ops):
    """Interleaved allocate/grow/release never leaks or double-books a
    physical block, and never hands out the null block."""
    c = _cache(blocks=12, bs=2)
    for seq, tokens in ops:
        try:
            if seq in c.tables:
                c.release(seq)
            else:
                c.allocate(seq, tokens=tokens)
        except OutOfBlocksError:
            pass
        held = [b for t in c.tables.values() for b in t]
        assert len(held) == len(set(held))              # no double-booking
        assert len(held) + c.free_blocks() == 12        # no leaks
        assert set(held).isdisjoint(c._free)
        assert c.null_block not in held
