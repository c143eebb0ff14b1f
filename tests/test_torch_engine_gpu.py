"""The LM serving engine's compiled steps on the card: grouped admission
against one prompt at a time, per layer, and the decode step's CUDA graph
against the eager step, bit for bit, for the dense family (qwen2) and the
recurrent ones (hymba's KV ring and SSM state, rwkv6's WKV state and
token-shift rows).

These tests need a CUDA device and skip without one: a CUDA graph has no
CPU mode, and the question of what a batch of prompts does to each
prompt's bits is one of the card's libraries. On the machine with the card:

    PYTHONPATH=src python -m pytest -q -s -m gpu tests/test_torch_engine_gpu.py

(``chip_smoke.py`` runs them and keeps the ``GROUPED_PREFILL`` lines that
the per-op diagnosis prints.) The file imports torch and the port only, so
it runs where JAX is absent.
"""
import contextlib
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.dtypes import torch_dtype
from repro_torch.launch.steps import CompiledDecodeStep, make_decode_step
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.serving.engine import Request, ServingEngine

# the functions a prefill calls through module globals, each with the
# positions of its arguments that carry the batch axis
HOOKS = {(tf, "block_full"): (2, 3, 6), (tf, "rms_norm"): (0,),
         (attn, "_project"): (0,), (attn, "apply_rope"): (0, 1, 3),
         (attn, "flash_attention"): (0, 1, 2), (attn, "_out_proj"): (0,),
         (tf, "swiglu"): (1,), (tf, "logits_head"): (2,)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph and the card's "
                    "GEMM choices have no CPU mode")
    return torch.device("cuda")


def _full_width(layers=2, model="qwen2-1.5b"):
    """``model``'s full width, cut to ``layers`` bf16 layers."""
    return dataclasses.replace(get_config(model), num_layers=layers,
                               dtype="bfloat16")


def _smoke(model="qwen2-1.5b"):
    return dataclasses.replace(get_config(model + "-smoke"),
                               dtype="bfloat16")


# the decode graph's configurations: qwen2 smoke and full width, hymba and
# rwkv6 at full width, and hymba smoke, whose window of 16 rows wraps at
# the positions the test feeds
CONFIGS = {"smoke": _smoke, "full_width_2_layers": _full_width,
           "hymba_full_width_2_layers":
               lambda: _full_width(model="hymba-1.5b"),
           "rwkv6_full_width_2_layers":
               lambda: _full_width(model="rwkv6-1.6b"),
           "hymba_smoke_ring": lambda: _smoke("hymba-1.5b")}


def _prompts(seed, lengths, vocab):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lengths]


@contextlib.contextmanager
def _recording(log: list):
    """Record every call of the HOOKS functions: (name, the function, its
    arguments, the batched positions, its output)."""
    saved = []
    for (mod, name), batched in HOOKS.items():
        fn = getattr(mod, name)

        def rec(*args, _fn=fn, _name=name, _batched=batched, **kw):
            out = _fn(*args, **kw)
            log.append((_name, _fn, args, kw, _batched, out))
            return out
        saved.append((mod, name, fn))
        setattr(mod, name, rec)
    try:
        yield log
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _lane(v, j):
    """Lane j of a batched value (tensors, tuples and dicts of them)."""
    if isinstance(v, torch.Tensor):
        return v[j:j + 1]
    if isinstance(v, tuple):
        return tuple(_lane(x, j) for x in v)
    if isinstance(v, dict):
        return {k: _lane(x, j) for k, x in v.items()}
    return v


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, tuple):
        return all(_equal(x, y) for x, y in zip(a, b))
    return all(_equal(a[k], b[k]) for k in a)


def _layer_records(log):
    """block_full's records: (hidden out, k, v) a layer."""
    return [(out[0], out[1]["k"], out[1]["v"])
            for name, _, _, _, _, out in log if name == "block_full"]


def _swiglu_products(p, x, prefix="mlp_"):
    """The MLP's three GEMMs apart (``models/mlp.py``'s arithmetic), each
    at M = B * S against lane j's M = S on the same operands."""
    gate, up = x @ p[prefix + "wi_gate"], x @ p[prefix + "wi_up"]
    h = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    out = []
    for name, a, w in (("swiglu.gate", x, p[prefix + "wi_gate"]),
                       ("swiglu.up", x, p[prefix + "wi_up"]),
                       ("swiglu.down", h, p[prefix + "wo"])):
        full = a @ w
        out.append({"op": name, "lanes_equal": [
            torch.equal(a[j:j + 1] @ w, full[j:j + 1])
            for j in range(a.shape[0])]})
    return out


def _diagnose(prefill, params, prompts) -> dict:
    """One (2, S) forward against each prompt's (1, S) forward. Per layer:
    whether lane j's hidden output, K and V equal the prompt's own B = 1
    run. Per op, in call order: whether the op, called at B = 1 on lane
    j's own inputs from the B = 2 run, gives lane j's output bits (so an op
    that differs is found on its own, not through what it was fed)."""
    grouped, alone = [], [[] for _ in prompts]
    with _recording(grouped):
        g_logits, _ = prefill(params, {"inputs": torch.as_tensor(
            np.stack(prompts), device="cuda")})
    singles = []
    for j, p in enumerate(prompts):
        with _recording(alone[j]):
            singles.append(prefill(params, {"inputs": torch.as_tensor(
                p[None], device="cuda")})[0])
    layers = []
    for i, g in enumerate(_layer_records(grouped)):
        row = {"layer": i}
        for j in range(len(prompts)):
            a = _layer_records(alone[j])[i]
            for name, x, y in zip(("hidden", "k", "v"), g, a):
                row[f"{name}_{j}"] = torch.equal(x[j:j + 1], y)
        layers.append(row)
    ops = []
    for name, fn, args, kw, batched, out in grouped:
        if name == "block_full":
            continue
        same = []
        for j in range(len(prompts)):
            lane_args = tuple(_lane(a, j) if k in batched else a
                              for k, a in enumerate(args))
            same.append(_equal(fn(*lane_args, **kw), _lane(out, j)))
        ops.append({"op": name, "lanes_equal": same})
        if name == "swiglu":
            ops += _swiglu_products(*args)
    first = next((o["op"] for o in ops if o["op"] != "swiglu"   # its parts
                  and not all(o["lanes_equal"])), None)
    return {"layers": layers, "ops": ops, "first_op_that_differs": first,
            "logits_equal": [torch.equal(g_logits[j:j + 1], s)
                             for j, s in enumerate(singles)]}


@pytest.mark.gpu
@pytest.mark.parametrize("seq", [512, 256])
def test_grouped_admission_equals_one_prompt_at_a_time_per_layer(cuda, seq):
    """Two same-length prompts admitted together and each admitted alone:
    every layer's hidden output, K and V, the cache the engine splices and
    the first token are the same bits. Beside it, printed, the per-op
    diagnosis of a (2, S) forward against two (1, S) ones: what a group
    prefilled as one batch would change, and at which op."""
    cfg = _full_width()
    params = tf.init_params(cfg, 0)
    prompts = _prompts(seq, (seq, seq), cfg.vocab_size)
    prefill = make_prefill_step(cfg)
    report = _diagnose(prefill, params, prompts)
    print("GROUPED_PREFILL " + json.dumps({"seq": seq, **report}))

    eng = ServingEngine(cfg, params, max_batch=2, max_seq=seq + 8)
    reqs = [Request(rid=i, prompt=p, max_new=1)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    shapes, inner = [], eng._prefill

    def counted(params, batch):
        shapes.append(tuple(batch["inputs"].shape))
        return inner(params, batch)
    eng._prefill = counted
    together = []
    with _recording(together):
        eng._admit()                 # both prompts, one admission
    assert shapes == [(1, seq), (1, seq)]
    got = _layer_records(together)
    assert len(got) == 2 * cfg.num_layers
    for j, p in enumerate(prompts):
        alone = []
        with _recording(alone):
            logits, cache = prefill(params, {"inputs": torch.as_tensor(
                p[None], device="cuda")})
        for i, (x, y) in enumerate(zip(got[j * cfg.num_layers:],
                                       _layer_records(alone))):
            for name, a, b in zip(("hidden", "k", "v"), x, y):
                assert torch.equal(a, b), (j, i, name)
        for key in ("k", "v"):
            assert torch.equal(eng._cache[key][:, j, :seq], cache[key][:, 0])
        assert reqs[j].out_tokens == [int(torch.argmax(logits[0]))]


def _random_cache(cfg, batch, max_seq, seed):
    """Every tensor of the family's decode state, random, in its dtype."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {k: torch.randn(s.shape, generator=gen, device="cuda").to(
        torch_dtype(s.dtype))
        for k, s in tf.cache_specs(cfg, batch, max_seq).items()}


@pytest.mark.gpu
@pytest.mark.parametrize("which", list(CONFIGS))
def test_decode_graph_replay_equals_the_eager_step(cuda, which):
    """The captured decode step against ``make_decode_step`` from two
    copies of one cache: logits and every cache tensor (KV rows, ring or
    not, and the recurrent states) bit for bit, over three replays whose
    positions take 0, max_seq - 1 and rows between (the static buffers
    refresh on each)."""
    cfg = CONFIGS[which]()
    B, max_seq = 4, 64
    params = tf.init_params(cfg, 1)
    cache = _random_cache(cfg, B, max_seq, 2)
    step = CompiledDecodeStep(cfg, params, cache, B)
    assert step.graph is not None
    assert all(n == 0 for n in step.graph.launches.values())
    mirror = {k: v.clone() for k, v in cache.items()}  # after the warm-up
    eager = make_decode_step(cfg)
    rng = np.random.RandomState(3)
    for pos in ((0, 63, 17, 5), (1, 0, 63, 40), (62, 31, 0, 63)):
        batch = {"inputs": torch.as_tensor(
            rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32),
            device="cuda"),
            "pos": torch.as_tensor(np.asarray(pos, np.int32),
                                   device="cuda")}
        got, out_cache = step(params, cache, batch)
        want, _ = eager(params, mirror, batch)
        assert out_cache is cache
        assert torch.equal(got, want), pos
        for k in cache:
            assert torch.equal(cache[k], mirror[k]), (pos, k)
    with pytest.raises(ValueError, match="compiled for other"):
        step(params, mirror, batch)


def _serve(cfg, params, prompts, max_new, eager, **kw):
    eng = ServingEngine(cfg, params, max_batch=3, max_seq=64, **kw)
    if eager:
        eng._decode = make_decode_step(cfg)
    reqs = [Request(rid=i, prompt=p, max_new=n)
            for i, (p, n) in enumerate(zip(prompts, max_new))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done and not r.shed for r in reqs)
    return [r.out_tokens for r in reqs]


@pytest.mark.gpu
@pytest.mark.parametrize("greedy", [True, False])
@pytest.mark.parametrize("which", ["qwen2_smoke", "hymba_full_width_2_layers",
                                   "rwkv6_full_width_2_layers"])
def test_captured_engine_streams_equal_an_eager_step_engine(cuda, which,
                                                            greedy):
    """7 prompts over 3 slots with max_new 1 to 6, so slots free and
    refill mid-run (a recurrent state is spliced whole into a reused
    slot): the captured engine's tokens equal those of an engine whose
    decode step is the eager one, greedy and sampled from the same seed
    (sampling stays outside the graph, on the engine's generator)."""
    cfg = _smoke() if which == "qwen2_smoke" else CONFIGS[which]()
    params = tf.init_params(cfg, 4)
    prompts = _prompts(5, (5, 9, 5, 3, 12, 7, 9), cfg.vocab_size)
    max_new = (1, 6, 2, 5, 3, 4, 6)
    kw = dict(greedy=greedy, temperature=0.8, seed=11)
    got = _serve(cfg, params, prompts, max_new, eager=False, **kw)
    want = _serve(cfg, params, prompts, max_new, eager=True, **kw)
    assert got == want
    assert [len(t) for t in got] == [n + 1 for n in max_new]
