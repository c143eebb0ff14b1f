"""The paged-KV engine on the moe family: moonshot-v1-16b-a3b smoke, whose
``block_decode_paged`` routes every lane through ``moe_ffn``. From the same
parameters (``params_from_jax``), the port's ``PagedServingEngine`` gives
greedy streams equal to the JAX package's ``PagedServingEngine`` and to the
port's dense ``ServingEngine``, token for token: at batch 1, and with 3 and
5 slots all live, so that the windows run at buckets 1, 2 and 4 and with a
padded lane (which the router routes too)."""
import functools

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jax_tf
from repro.models.common import init_params as jax_init_params
from repro.serving import engine as jax_engine
from repro.serving import paged_engine as jax_paged_engine
from repro_torch.configs import get_config
from repro_torch.models import transformer as tf
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.paged_engine import PagedServingEngine

MOONSHOT = "moonshot-v1-16b-a3b-smoke"


@functools.lru_cache(maxsize=None)
def _jax_params():
    jcfg = jax_get_config(MOONSHOT)
    return jax_init_params(jax.random.PRNGKey(0), jax_tf.model_specs(jcfg))


def _port_params():
    return tf.params_from_jax({k: np.asarray(v)
                               for k, v in _jax_params().items()},
                              device="cpu")


def _drain(eng, req_cls, prompts, max_new):
    reqs = [req_cls(rid=i, prompt=p, max_new=n)
            for i, (p, n) in enumerate(zip(prompts, max_new))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done and not r.shed for r in reqs)
    return [r.out_tokens for r in reqs]


def _buckets_seen(eng) -> set:
    """Wrap the compiled paged decode so that every window's (bucket, live
    lanes) is recorded."""
    seen = set()
    inner = eng._decode

    def spy(params, k, v, batch, window):
        live = sum(s is not None for s in eng._slots)
        seen.add((int(batch["tokens"].shape[0]), live))
        return inner(params, k, v, batch, window)

    eng._decode = spy
    return seen


@pytest.mark.parametrize("max_batch,n_prompts", [(1, 2), (3, 5), (5, 7)])
def test_paged_moe_streams_equal_jax_and_dense(max_batch, n_prompts):
    jcfg, cfg = jax_get_config(MOONSHOT), get_config(MOONSHOT)
    rng = np.random.RandomState(10 + max_batch)
    prompts = [rng.randint(0, cfg.vocab_size, (3 + 2 * i,)).astype(np.int32)
               for i in range(n_prompts)]
    max_new = [4 + (i % 3) for i in range(n_prompts)]
    kw = dict(max_batch=max_batch, max_seq=64)
    want = _drain(jax_paged_engine.PagedServingEngine(
        jcfg, _jax_params(), block_size=8, **kw), jax_engine.Request,
        prompts, max_new)
    params = _port_params()
    paged_eng = PagedServingEngine(cfg, params, block_size=8, device="cpu",
                                   **kw)
    seen = _buckets_seen(paged_eng)
    paged = _drain(paged_eng, Request, prompts, max_new)
    dense = _drain(ServingEngine(cfg, params, device="cpu", **kw), Request,
                   prompts, max_new)
    assert paged == want
    assert paged == dense
    assert [len(t) for t in paged] == [n + 1 for n in max_new]
    if max_batch == 5:
        assert {1, 2, 4} <= {b for b, _ in seen}
        assert any(b > live for b, live in seen)        # a padded lane


def test_pad_lanes_join_the_step_at_the_tables_lane_count():
    """``forward_decode_paged`` runs the tables' null lanes as pad lanes,
    so every op sees the dense step's row count: the live lanes' logits
    and K/V rows equal those of one step over all the tables' lanes whose
    extra lanes carry other tokens, bit for bit, and the pad lanes write
    only the null block."""
    import torch
    cfg = get_config(MOONSHOT)
    params = _port_params()
    rng = np.random.RandomState(3)
    lanes, W, bs = 4, 4, 8
    nb = lanes * W
    shape = (cfg.num_layers, nb + 1, bs, cfg.num_kv_heads, cfg.head_dim)
    pool = [torch.from_numpy(rng.randn(*shape).astype(np.float32))
            for _ in range(2)]
    tables = torch.full((lanes, W), nb, dtype=torch.int32)
    tables[0] = torch.arange(0, W)
    tables[1] = torch.arange(W, 2 * W)
    pos = torch.tensor([13, 5], dtype=torch.int32)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (lanes, 1))
                            .astype(np.int32))
    live_k, live_v = pool[0].clone(), pool[1].clone()
    got, _, _ = tf.forward_decode_paged(cfg, params, toks[:2], pos, live_k,
                                        live_v, tables)
    all_k, all_v = pool[0].clone(), pool[1].clone()
    want, _, _ = tf.forward_decode_paged(
        cfg, params, toks, torch.cat([pos, pos.new_zeros(2)]), all_k, all_v,
        tables)
    assert got.shape[0] == 2
    assert torch.equal(got, want[:2])
    for new, old in ((live_k, pool[0]), (live_v, pool[1])):
        changed = (new != old).flatten(3).any(-1)          # (L, blocks, bs)
        rows = {(b, r) for _, b, r in changed.nonzero().tolist()}
        # lane 0 at 13: block 1, row 5; lane 1 at 5: block W, row 5; the
        # pad lanes at 0: the null block's row 0
        assert rows == {(1, 5), (W, 5), (nb, 0)}
    assert torch.equal(live_k[:, :nb], all_k[:, :nb])
    assert torch.equal(live_v[:, :nb], all_v[:, :nb])
