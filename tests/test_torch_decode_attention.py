"""decode_attention in the port on the CPU: the op's plain version against
the stock ops that decode attention ran on before the op (``_grouped_scores``
then ``_attend_decode``, and paged decode's gather), bit for bit; its
dense and block-table entries against each other; a sliding window's ring
before and after it wraps; the split plan; the FLOP formula; the contract's
``ValueError``s. The CUDA kernel itself runs only on the card
(tests/test_torch_kernels_gpu.py)."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops
from repro_torch.models import attention as attn

# (G, D, dtype, S, Hkv, window, pos): G in {1, 4, 7}, D in {64, 128}; a
# window makes the cache a ring of S rows, positions past S wrapped
CASES = {
    "g1_d64": (1, 64, "float32", 40, 3, None, (0, 39, 17)),
    "g4_d128": (4, 128, "bfloat16", 48, 2, None, (5, 0, 47, 20)),
    "g7_d64": (7, 64, "bfloat16", 33, 2, None, (32, 1)),
    "g7_d128": (7, 128, "float32", 24, 1, None, (23, 0, 9)),
    "g4_d64_f16": (4, 64, "float16", 30, 2, None, (29, 3)),
    "ring_before_wrap": (4, 64, "bfloat16", 16, 2, 16, (0, 7, 15)),
    "ring_after_wrap": (4, 128, "float32", 16, 2, 16, (16, 40, 17, 3)),
}


def _cfg(G, D, Hkv, window):
    base = dataclasses.replace(get_config("qwen2-1.5b-smoke"),
                               num_heads=Hkv * G, num_kv_heads=Hkv,
                               head_dim=D)
    if window is None:
        return base
    return dataclasses.replace(base, attention="sliding",
                               sliding_window=window)


def _inputs(rng, B, S, Hkv, G, D, dtype):
    t = lambda *shape: torch.from_numpy(
        rng.randn(*shape).astype(np.float32)).to(getattr(torch, dtype))
    return t(B, 1, Hkv * G, D), t(B, S, Hkv, D), t(B, S, Hkv, D)


def _stock(cfg, q, k, v, pos):
    """Dense decode attention as the stock ops computed it."""
    c = attn.decode_consts(cfg, pos, k.shape[1])
    scores = attn._grouped_scores(attn._group(q, k.shape[2]), k)
    return attn._attend_decode(cfg, scores, v, c, q.dtype)


def _paged(k, v, bs, rng, lanes=None):
    """The dense cache's rows in a pool of ``bs``-row blocks, shuffled,
    with a null block last, and tables of ``lanes`` rows (null past B)."""
    B, S, Hkv, D = k.shape
    W = S // bs
    order = rng.permutation(B * W)
    null = B * W
    pools = []
    for a in (k, v):
        pool = torch.zeros((null + 1, bs, Hkv, D), dtype=a.dtype)
        pool[torch.from_numpy(order)] = a.reshape(B * W, bs, Hkv, D)
        pools.append(pool)
    tables = torch.full((lanes or B, W), null, dtype=torch.int32)
    tables[:B] = torch.from_numpy(order.reshape(B, W).astype(np.int32))
    return pools[0], pools[1], tables


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_equals_the_stock_ops(name, rng):
    G, D, dtype, S, Hkv, window, pos = CASES[name]
    cfg = _cfg(G, D, Hkv, window)
    q, k, v = _inputs(rng, len(pos), S, Hkv, G, D, dtype)
    p = torch.tensor(pos, dtype=torch.int32)
    got = ops.decode_attention(q, k, v, p)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.equal(got, _stock(cfg, q, k, v, p))


@pytest.mark.parametrize("lanes", [None, 6])
@pytest.mark.parametrize("name", ["g4_d128", "g7_d64", "g1_d64"])
def test_dense_and_block_table_entries_agree(name, lanes, rng):
    """The same rows in a dense cache and behind shuffled block tables
    (16-row blocks; tables of B lanes, or padded with null lanes): the same
    output bit for bit, and the block-table entry equals paged decode's
    stock ops (gather every lane's blocks, q padded with zero lanes)."""
    G, D, dtype, S, Hkv, _, pos = CASES[name]
    S = 16 * -(-S // 16)
    q, k, v = _inputs(rng, len(pos), S, Hkv, G, D, dtype)
    p = torch.tensor(pos, dtype=torch.int32)
    pool_k, pool_v, tables = _paged(k, v, 16, rng, lanes)
    got = ops.decode_attention(q, pool_k, pool_v, p, tables)
    assert torch.equal(got, ops.decode_attention(q, k, v, p))
    B, n = len(pos), tables.shape[0]
    kg = pool_k[tables.long()].reshape(n, S, Hkv, D)
    vg = pool_v[tables[:B].long()].reshape(B, S, Hkv, D)
    qd = torch.cat([q, q.new_zeros((n - B,) + tuple(q.shape[1:]))])
    scores = attn._grouped_scores(attn._group(qd, Hkv), kg)[:B]
    cfg = _cfg(G, D, Hkv, None)
    c = attn.decode_consts(cfg, p, S)
    assert torch.equal(got, attn._attend_decode(cfg, scores, vg, c, q.dtype))


def test_masked_rows_do_not_reach_the_output(rng):
    """Rows past a lane's position, and in a ring nothing: filling them
    with other values leaves the output's bits as they were."""
    q, k, v = _inputs(rng, 3, 24, 2, 4, 64, "bfloat16")
    p = torch.tensor([0, 10, 23], dtype=torch.int32)
    want = ops.decode_attention(q, k, v, p)
    k2, v2 = k.clone(), v.clone()
    for b, t in enumerate(p.tolist()):
        k2[b, t + 1:] = 100.0
        v2[b, t + 1:] = -7.0
    assert torch.equal(ops.decode_attention(q, k2, v2, p), want)


@pytest.mark.parametrize("rows,lanes,hkv,sms", [
    (4096, 32, 8, 132), (640, 4, 2, 132), (16, 4, 2, 132), (64, 3, 1, 132),
    (33024, 64, 8, 132), (100, 1, 1, 1)])
def test_split_plan_covers_the_rows_in_whole_multiples(rows, lanes, hkv,
                                                       sms):
    split_len, n = ops.plan(rows, lanes, hkv, sms)
    assert split_len % ops.SPLIT_ROWS == 0
    assert (n - 1) * split_len < rows <= n * split_len
    assert n == 1 or lanes * hkv * (n - 1) < ops.BLOCKS_PER_SM * sms


def test_flop_formula_counts_the_valid_rows(rng):
    """4 D operations a valid row a query head; on ``meta`` the positions
    have no values and every row counts."""
    q, k, v = _inputs(rng, 3, 40, 2, 4, 64, "float32")
    p = torch.tensor([0, 9, 39], dtype=torch.int32)
    with FlopCounterMode(display=False) as fc:
        ops.decode_attention(q, k, v, p)
    assert fc.get_total_flops() == 4 * 64 * 8 * (1 + 10 + 40)
    meta = [a.to("meta") for a in (q, k, v, p)]
    with FlopCounterMode(display=False) as fc:
        out = ops.decode_attention(*meta)
    assert out.shape == q.shape and out.device.type == "meta"
    assert fc.get_total_flops() == 4 * 64 * 8 * 3 * 40


@pytest.mark.parametrize("case", [
    "q_rank", "two_tokens", "kv_shapes", "head_dim", "grouping", "pos_shape",
    "pos_float", "dense_batch", "tables_lanes", "tables_float",
    "int_cache"])
def test_contract_errors(case):
    q = torch.zeros(2, 1, 8, 16)
    k = v = torch.zeros(2, 12, 2, 16)
    pos = torch.zeros(2, dtype=torch.int32)
    pool = torch.zeros(5, 4, 2, 16)
    args = {
        "q_rank": ((q[:, 0], k, v, pos), "rank-4"),
        "two_tokens": ((torch.zeros(2, 2, 8, 16), k, v, pos), "one token"),
        "kv_shapes": ((q, k, torch.zeros(2, 11, 2, 16), pos), "shapes differ"),
        "head_dim": ((q, torch.zeros(2, 12, 2, 8), torch.zeros(2, 12, 2, 8),
                      pos), "head_dim"),
        "grouping": ((torch.zeros(2, 1, 7, 16), k, v, pos), "GQA grouping"),
        "pos_shape": ((q, k, v, torch.zeros(3, dtype=torch.int32)), "pos"),
        "pos_float": ((q, k, v, torch.zeros(2)), "pos"),
        "dense_batch": ((q, torch.zeros(3, 12, 2, 16),
                         torch.zeros(3, 12, 2, 16), pos), "dense cache"),
        "tables_lanes": ((q, pool, pool, pos,
                          torch.zeros(1, 3, dtype=torch.int32)), "tables"),
        "tables_float": ((q, pool, pool, pos, torch.zeros(2, 3)), "tables"),
        "int_cache": ((q, k.int(), v.int(), pos), "non-floating"),
    }
    call, match = args[case]
    with pytest.raises(ValueError, match=match):
        ops.decode_attention(*call)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_forward_decode_takes_the_plain_version_on_request(dtype, rng):
    """``forward_decode(impl="ref")`` attends on the plain version
    whatever the device (the kernel takes fp32, bf16 and f16 only): on the
    CPU, where the op computes the plain version too, the same logits and
    cache as the default route, in fp32 and fp64; an unknown impl raises."""
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_config("qwen2-1.5b-smoke"), dtype=dtype)
    params = tf.init_params(cfg, 0, device="cpu")
    B, S = 3, 24
    cache = {k: torch.from_numpy(rng.randn(*s.shape).astype(np.float32)).to(
        getattr(torch, dtype)) for k, s in tf.cache_specs(cfg, B, S).items()}
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, 1)).astype(
        np.int32))
    pos = torch.tensor([0, 11, 23], dtype=torch.int32)
    mirror = {k: v.clone() for k, v in cache.items()}
    got, _ = tf.forward_decode(cfg, params, toks, pos, cache, impl="ref")
    want, _ = tf.forward_decode(cfg, params, toks, pos, mirror)
    assert got.dtype == getattr(torch, dtype) and torch.equal(got, want)
    assert all(torch.equal(cache[k], mirror[k]) for k in cache)
    with pytest.raises(ValueError, match="unknown decode attention impl"):
        tf.forward_decode(cfg, params, toks, pos, cache, impl="pallas")
