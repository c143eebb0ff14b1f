"""The paged engine's decode windows on the card: a rung captured while
sequences are live leaves their blocks untouched, every rung a burst
reaches replays as its eager window (tokens and pool bit for bit, blocks
outside the batch untouched), sampled windows draw the same stream
captured and eager, a paged step's logits equal the dense step's bit for
bit at every bucket and live span, and the paged streams equal the dense
engine's, at 4 slots and at 3, with a per-op diagnosis of where other
shapes (a bucket of lanes, a span of gathered blocks) would give other
bits than the dense step's (4 lanes, 640 rows).

These tests need a CUDA device and skip without one: a CUDA graph has no
CPU mode, and which shapes round alike is a question of the card's
libraries. On the machine with the card:

    PYTHONPATH=src python -m pytest -q -s -m gpu tests/test_torch_paged_gpu.py

(``chip_smoke.py`` runs them and keeps the ``PAGED_VS_DENSE`` line the
diagnosis prints.) The file imports torch and the port only, so it runs
where JAX is absent.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.common import apply_rope, rms_norm
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.paged_engine import PagedServingEngine

MAX_SEQ, BLOCK, SLOTS = 640, 16, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph and the card's "
                    "GEMM choices have no CPU mode")
    return torch.device("cuda")


def _full_width(layers=2):
    """qwen2-1.5B's full width, cut to ``layers`` bf16 layers."""
    return dataclasses.replace(get_config("qwen2-1.5b"), num_layers=layers,
                               dtype="bfloat16")


def _prompts(seed, lengths, vocab):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lengths]


def _engine(cfg, params, **kw):
    return PagedServingEngine(cfg, params, max_batch=SLOTS, max_seq=MAX_SEQ,
                              block_size=BLOCK, **kw)


def _serve(eng, prompts, max_new):
    reqs = [Request(rid=i, prompt=p, max_new=n)
            for i, (p, n) in enumerate(zip(prompts, max_new))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done and not r.shed for r in reqs)
    return [r.out_tokens for r in reqs]


def _recorded(eng) -> list:
    """Wrap ``eng._decode`` to record each dispatch's batch and window."""
    calls, inner = [], eng._decode

    def rec(params, pool_k, pool_v, batch, window):
        calls.append(({k: v.clone() for k, v in batch.items()}, window))
        return inner(params, pool_k, pool_v, batch, window)
    eng._decode = rec
    return calls


def _but_null(pool, null):
    return torch.cat([pool[:, :null], pool[:, null + 1:]], dim=1)


@pytest.mark.gpu
def test_capture_while_sequences_are_live_leaves_their_blocks_untouched(
        cuda):
    """Three sequences hold blocks; rungs captured now (their warm-up runs
    write the pool) change no block but the null one, and the streams then
    equal an engine on eager windows."""
    cfg = _full_width()
    params = tf.init_params(cfg, 1)
    prompts = _prompts(2, (300, 17, 120), cfg.vocab_size)
    max_new = (20, 20, 20)
    eng = _engine(cfg, params)
    reqs = [Request(rid=i, prompt=p, max_new=n)
            for i, (p, n) in enumerate(zip(prompts, max_new))]
    for r in reqs:
        eng.submit(r)
    eng.step()                          # prefill all three, one window
    assert len(eng.cache.tables) == 3
    null = eng.cache.null_block
    before = eng.cache.k.clone(), eng.cache.v.clone()
    written = [t[0] for t in eng.cache.tables.values()]
    assert all(before[0][:, b].any() for b in written)
    n0 = len(eng._decode.captured)
    for rung in ((4, 8), (1, 1), (2, 2), (4, 4)):
        eng._decode.capture(*rung)
    assert len(eng._decode.captured) == n0 + 4
    for got, want in zip((eng.cache.k, eng.cache.v), before):
        assert torch.equal(_but_null(got, null), _but_null(want, null))
    eng.run_until_drained()
    ref = _engine(cfg, params)
    ref._decode = ref._decode.eager
    assert [r.out_tokens for r in reqs] == _serve(ref, prompts, max_new)


@pytest.mark.gpu
@pytest.mark.parametrize("greedy", [True, False])
def test_replay_equals_the_eager_window_for_every_rung_reached(cuda, greedy):
    """A burst of 7 prompts over 4 slots with max_new 1 to 25 reaches
    buckets 1, 2 and 4 and windows 8, 4, 2 and 1, each rung captured when
    the engine was built. Its streams equal an engine on eager windows
    (sampled: from the same seed). Then, per rung, one replay from the pool as it stands against
    the eager window on a copy: tokens and pool bit for bit (the null
    block aside), and every block outside the batch untouched."""
    cfg = _full_width()
    params = tf.init_params(cfg, 3)
    prompts = _prompts(4, (40, 17, 100, 5, 64, 33, 250), cfg.vocab_size)
    max_new = (1, 15, 6, 3, 12, 7, 25)
    kw = dict(greedy=greedy, temperature=0.8, seed=5)
    eng = _engine(cfg, params, **kw)
    compiled = eng._decode
    calls = _recorded(eng)
    got = _serve(eng, prompts, max_new)
    ref = _engine(cfg, params, **kw)
    ref._decode = ref._decode.eager
    assert got == _serve(ref, prompts, max_new)
    rungs = {}
    for batch, window in calls:
        rungs.setdefault((batch["tokens"].shape[0], window), batch)
    assert {w for _, w in rungs} == {8, 4, 2, 1}
    assert {b for b, _ in rungs} == {1, 2, 4}
    assert len(compiled.captured) == 12 and set(rungs) <= set(
        compiled.graphs)
    null = eng.cache.null_block
    for (bucket, window), batch in rungs.items():
        before = eng.cache.k.clone(), eng.cache.v.clone()
        mirror = eng.cache.k.clone(), eng.cache.v.clone()
        state = eng._gen.get_state()
        toks = compiled.graphs[bucket, window](batch)["tokens"]
        eng._gen.set_state(state)
        want, _, _ = compiled.eager(params, *mirror, batch, window)
        assert torch.equal(toks, want), (bucket, window)
        for got_pool, want_pool in zip((eng.cache.k, eng.cache.v), mirror):
            assert torch.equal(_but_null(got_pool, null),
                               _but_null(want_pool, null))
        outside = sorted(set(range(null)) - set(
            batch["tables"].flatten().tolist()))
        for got_pool, old in zip((eng.cache.k, eng.cache.v), before):
            assert torch.equal(got_pool[:, outside], old[:, outside])


# the ops of one paged decode layer, each with how it is padded to the dense
# step's shape: "lanes" pads the batch axis to SLOTS lanes, "keys" the
# gathered rows to MAX_SEQ
def _layer_ops(cfg, p, glob, dev):
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = torch.full((), D ** 0.5, dtype=torch.float32, device=dev)
    return [
        ("ln1", "lanes", lambda x: rms_norm(x, p["ln1"], cfg.norm_eps)),
        ("q_proj", "lanes", lambda h: attn._project(h, p["wq"], p.get("bq"))),
        ("k_proj", "lanes", lambda h: attn._project(h, p["wk"], p.get("bk"))),
        ("rope", "lanes", lambda q, pos: apply_rope(
            q, pos[:, None], cfg.rope_theta)),
        ("scores", "keys", lambda qg, kg: attn._grouped_scores(qg, kg)
         / scale),
        ("softmax", "keys", lambda s: torch.softmax(s, dim=-1).to(
            torch.bfloat16)),
        ("pv", "keys", lambda a, vg: torch.einsum(
            "bhgqk,bkhd->bqhgd", a, vg).reshape(a.shape[0], 1, H, D)),
        ("out_proj", "lanes", lambda o: attn._out_proj(o, p["wo"])),
        ("mlp_gate", "lanes", lambda h: h @ p["mlp_wi_gate"]),
        ("mlp_down", "lanes", lambda h: h @ p["mlp_wo"]),
        ("logits", "lanes", lambda x: tf.logits_head(cfg, glob, x)),
    ]


def _pad(t, pad_to, dim, value=0.0):
    shape = list(t.shape)
    shape[dim] = pad_to - shape[dim]
    return torch.cat([t, torch.full(shape, value, dtype=t.dtype,
                                    device=t.device)], dim=dim)


def _diagnose(cfg, params, bucket: int, rows: int, dev) -> dict:
    """Each op of a paged decode layer at the paged shape (``bucket``
    lanes, ``rows`` gathered rows) against the same op on the same inputs
    padded to the dense step's (SLOTS lanes; for the ops over keys also
    MAX_SEQ rows, padded alone, the lanes alone and both): the ops, and
    the paddings, under which the live lanes and rows get other bits."""
    glob, blocks = tf.split_params(params)
    p = {k: v[0] for k, v in blocks.items()}
    gen = torch.Generator(device=dev).manual_seed(bucket * 1000 + rows)
    Hkv, D = cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // Hkv

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    pos = torch.randint(0, rows, (bucket,), generator=gen, device=dev,
                        dtype=torch.int32)
    x = rand(bucket, 1, cfg.d_model)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q = attn._project(h, p["wq"], p.get("bq"))
    qg = apply_rope(q, pos[:, None], cfg.rope_theta).reshape(
        bucket, 1, Hkv, G, D)
    kg, vg = rand(bucket, rows, Hkv, D), rand(bucket, rows, Hkv, D)
    valid = (torch.arange(rows, device=dev)[None, :]
             <= pos[:, None].long())[:, None, None, None, :]
    s = torch.where(valid, attn._grouped_scores(qg, kg) * 0.09, attn.NEG_INF)
    a = torch.softmax(s, dim=-1).to(torch.bfloat16)
    o = rand(bucket, 1, cfg.num_heads, D)
    f = rand(bucket, 1, cfg.d_ff)
    inputs = {"ln1": (x,), "q_proj": (h,), "k_proj": (h,), "rope": (q, pos),
              "scores": (qg, kg), "softmax": (s,), "pv": (a, vg),
              "out_proj": (o,), "mlp_gate": (h,), "mlp_down": (f,),
              "logits": (x,)}
    # the keys axis of each op over keys: kg/vg rows, the scores' and
    # weights' last axis
    keys_dim = {"scores": (None, 1), "softmax": (-1,), "pv": (-1, 1)}
    differ = {}
    for name, how, fn in _layer_ops(cfg, p, glob, dev):
        args = inputs[name]
        got = fn(*args)
        pads = {"lanes": [_pad(t, SLOTS, 0) for t in args]}
        if how == "keys":
            fill = {"softmax": attn.NEG_INF}.get(name, 0.0)

            def rows_of(ts):
                return [t if d is None else _pad(t, MAX_SEQ, d, fill)
                        for t, d in zip(ts, keys_dim[name])]
            pads = {"rows": rows_of(args), "lanes": pads["lanes"],
                    "both": rows_of(pads["lanes"])}
        bad = []
        for which, padded in pads.items():
            want = fn(*padded)[:bucket]
            if name in ("scores", "softmax"):
                want = want[..., :rows]
            if not torch.equal(got, want):
                bad.append(which)
        if bad:
            differ[name] = bad
    return differ


def _same_rows(cfg, bucket, span, gen, dev):
    """A dense cache of SLOTS lanes and MAX_SEQ rows, random, and a pool
    whose lane-b blocks (b * 40 + j, j < span) hold lane b's rows: the same
    keys and values behind either addressing. Returns (cache, pool,
    tables)."""
    Hkv, D, L = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    nb = SLOTS * (MAX_SEQ // BLOCK)
    cache = {k: torch.randn((L, SLOTS, MAX_SEQ, Hkv, D), generator=gen,
                            device=dev).to(torch.bfloat16)
             for k in ("k", "v")}
    pool = {k: torch.randn((L, nb + 1, BLOCK, Hkv, D), generator=gen,
                           device=dev).to(torch.bfloat16)
            for k in ("k", "v")}
    tables = torch.full((bucket, span), nb, dtype=torch.int32, device=dev)
    for b in range(bucket):
        for j in range(span):
            blk = b * (MAX_SEQ // BLOCK) + j
            tables[b, j] = blk
            for k in pool:
                pool[k][:, blk] = cache[k][:, b, j * BLOCK:(j + 1) * BLOCK]
    return cache, pool, tables


@pytest.mark.gpu
@pytest.mark.parametrize("bucket,span", [(1, 1), (2, 8), (2, 16), (4, 16),
                                         (4, 40), (1, 40)])
def test_paged_step_logits_equal_the_dense_step(cuda, bucket, span):
    """One paged decode step over ``bucket`` lanes whose keys fill
    ``span`` blocks, through tables of the dense step's shape (SLOTS lanes
    of MAX_SEQ / BLOCK blocks, null past the live ones) as the engine
    passes them, against the dense step over SLOTS lanes and MAX_SEQ rows
    holding the same keys and values (qwen2-1.5B's full width, 2 bf16
    layers): the live lanes' logits and written K/V bit for bit. Printed:
    whether the logits would differ through tables of (bucket, span)."""
    cfg = _full_width()
    params = tf.init_params(cfg, 8)
    gen = torch.Generator(device=cuda).manual_seed(bucket * 100 + span)
    cache, pool, tables = _same_rows(cfg, bucket, span, gen, cuda)
    pos = torch.zeros(SLOTS, dtype=torch.int32, device=cuda)
    pos[:bucket] = torch.randint(span * BLOCK // 2, span * BLOCK, (bucket,),
                                 generator=gen, device=cuda)
    toks = torch.zeros((SLOTS, 1), dtype=torch.int32, device=cuda)
    toks[:bucket] = torch.randint(0, cfg.vocab_size, (bucket, 1),
                                  generator=gen, device=cuda)
    want, _ = tf.forward_decode(cfg, params, toks, pos, cache)
    padded = torch.full((SLOTS, MAX_SEQ // BLOCK), pool["k"].shape[1] - 1,
                        dtype=torch.int32, device=cuda)
    padded[:bucket, :span] = tables
    own = {k: v.clone() for k, v in pool.items()}
    got, _, _ = tf.forward_decode_paged(cfg, params, toks[:bucket],
                                        pos[:bucket], pool["k"], pool["v"],
                                        padded)
    at_own_shape, _, _ = tf.forward_decode_paged(
        cfg, params, toks[:bucket], pos[:bucket], own["k"], own["v"],
        tables)
    print("PAGED_VS_DENSE " + json.dumps(
        {"bucket": bucket, "span": span,
         "logits_equal": torch.equal(got, want[:bucket]),
         "logits_equal_scores_at_own_shape":
             torch.equal(at_own_shape, want[:bucket])}))
    assert torch.equal(got, want[:bucket])
    for b in range(bucket):
        t = int(pos[b])
        for k in pool:
            assert torch.equal(pool[k][:, tables[b, t // BLOCK], t % BLOCK],
                               cache[k][:, b, t])


@pytest.mark.gpu
def test_paged_streams_equal_dense_and_where_shapes_round_otherwise(cuda):
    """The six prompts of the engine's main path (512, 512, 256, 256, 100,
    37 tokens, 16 new) through the dense engine and the paged engine at
    qwen2-1.5B's full width, 2 bf16 layers: the same streams. Printed
    beside it: for each (bucket, rows) the paged engine dispatches at,
    which ops of a decode layer give other bits at the paged shape than
    at the dense step's, and under which padding."""
    cfg = _full_width()
    params = tf.init_params(cfg, 6)
    prompts = _prompts(7, (512, 512, 256, 256, 100, 37), cfg.vocab_size)
    max_new = (16,) * 6
    dense = ServingEngine(cfg, params, max_batch=SLOTS, max_seq=MAX_SEQ)
    want = _serve(dense, prompts, max_new)
    paged = _engine(cfg, params)
    calls = _recorded(paged)
    got = _serve(paged, prompts, max_new)
    shapes = {(b["tokens"].shape[0], b["tables"].shape[1] * BLOCK)
              for b, _ in calls} | {(2, 256), (4, 128), (1, 16)}
    report = {f"{b}x{r}": _diagnose(cfg, params, b, r, cuda)
              for b, r in sorted(shapes)}
    print("PAGED_VS_DENSE " + json.dumps(
        {"streams_equal": got == want,
         "first_token_differs": [next((t for t, (x, y) in enumerate(
             zip(g, w)) if x != y), None) for g, w in zip(got, want)],
         "ops_that_differ_by_shape": report}))
    assert got == want


@pytest.mark.gpu
def test_paged_streams_equal_dense_at_three_slots(cuda):
    """Seven prompts through three slots, every slot live (bucket 3, the
    capped bucket, then 2 and 1): the paged engine's streams equal the
    dense engine's at 3 slots, qwen2-1.5B's full width, 2 bf16 layers."""
    cfg = _full_width()
    params = tf.init_params(cfg, 9)
    prompts = _prompts(10, (300, 17, 120, 64, 5, 250, 33), cfg.vocab_size)
    max_new = (12, 20, 9, 25, 3, 16, 8)
    dense = ServingEngine(cfg, params, max_batch=3, max_seq=MAX_SEQ)
    want = _serve(dense, prompts, max_new)
    paged = PagedServingEngine(cfg, params, max_batch=3, max_seq=MAX_SEQ,
                               block_size=BLOCK)
    calls = _recorded(paged)
    got = _serve(paged, prompts, max_new)
    assert {b["tokens"].shape[0] for b, _ in calls} == {1, 2, 3}
    assert got == want


@pytest.mark.gpu
def test_paged_moe_streams_equal_dense(cuda):
    """The moe family (moonshot-v1-16b-a3b's full width, 2 bf16 layers, 64
    experts top-6): the six prompts of the engine's main path through the
    dense engine and the paged engine give the same streams, the paged
    windows at buckets 4 and 2 running every op at the tables' 4 lanes
    (``forward_decode_paged``'s pad lanes; at a bucket's own lanes the
    RMSNorm's mean and the router's GEMM may round otherwise)."""
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"),
                              num_layers=2)
    params = tf.init_params(cfg, 11)
    prompts = _prompts(12, (512, 512, 256, 256, 100, 37, 9), cfg.vocab_size)
    max_new = (16, 16, 16, 16, 16, 9, 4)
    dense = ServingEngine(cfg, params, max_batch=SLOTS, max_seq=MAX_SEQ)
    want = _serve(dense, prompts, max_new)
    paged = _engine(cfg, params)
    calls = _recorded(paged)
    got = _serve(paged, prompts, max_new)
    assert {b["tokens"].shape[0] for b, _ in calls} >= {2, 4}
    assert got == want
