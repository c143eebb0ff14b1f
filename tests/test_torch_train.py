"""Training in the port on the CPU against the JAX package, on the same
weights (``params_from_jax`` of the JAX ``init_params``) and the same
``SyntheticLM`` batches: one step's loss and every gradient leaf, the loss
curve over 20 steps of ``make_train_step`` for the dense, moe, hybrid and
ssm families, a vlm config on (B, S, d) embeddings, remat's policies
against each other bit for bit, the loss falling over 80 steps, and a
restart from a checkpoint bit for bit. The JAX side is its own default
training route: jnp attention and the chunked scans."""
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
from repro.optim.adamw import adamw_init_specs
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import steps
from repro_torch.models import attention as attn
from repro_torch.models.common import AUTOGRAD
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import adamw_init

LOSS_TOL = 1e-5              # step 1's loss, relative
GRAD_TOL = 1e-4              # each gradient leaf, of its max |gradient|
CURVE_TOL = 1e-3             # every step of the 20-step curve, relative
SEQ, BATCH = 32, 4
FAMILIES = ["qwen2-1.5b-smoke", "moonshot-v1-16b-a3b-smoke",
            "hymba-1.5b-smoke", "rwkv6-1.6b-smoke"]
# The curve is held at a peak lr of 1e-3: at 3e-3 the reference's own
# jitted and eager train steps, the same function, already drift apart by
# 3.6e-3 (qwen2) and 1.5e-3 (moonshot) relative within 20 steps, beyond
# CURVE_TOL (examples/torch_train_numerics.py prints both gaps).
TRAIN_KW = dict(peak_lr=1e-3, warmup=5, total_steps=300)


@functools.lru_cache(maxsize=None)
def _jax_params(name, seed=0):
    return jax_init_params(jax.random.PRNGKey(seed),
                           jax_tf.model_specs(jax_get_config(name)))


def _port_params(name, seed=0):
    return tf.params_from_jax({k: np.asarray(v) for k, v in
                               _jax_params(name, seed).items()},
                              device="cpu")


def _jax_opt(name):
    specs = adamw_init_specs(jax_tf.model_specs(jax_get_config(name)))
    return jax_init_params(jax.random.PRNGKey(1), specs)


def _batches(cfg, n, seq=SEQ, batch=BATCH):
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                     global_batch=batch)
    return [ds.global_batch_at(i) for i in range(n)]


def _embedding_batch(cfg, seed=0):
    """A vlm config's batch: (B, S, d) embeddings from a seed, targets
    drawn over the vocabulary."""
    rng = np.random.RandomState(seed)
    return {"inputs": rng.standard_normal(
                (BATCH, SEQ, cfg.d_model)).astype(np.float32),
            "targets": rng.randint(0, cfg.vocab_size,
                                   (BATCH, SEQ)).astype(np.int32)}


def _port_grads(cfg, params, batch, remat=False, policy="full"):
    loss_fn = steps.make_loss_fn(cfg, remat, policy)
    names = sorted(params)
    leaves = [params[k].detach().clone().requires_grad_(True)
              for k in names]
    total, (loss, aux) = loss_fn(dict(zip(names, leaves)), batch)
    grads = torch.autograd.grad(total, leaves)
    return float(loss.detach()), float(total.detach()), dict(zip(names,
                                                               grads))


def _jax_grads(jcfg, params, batch):
    loss_fn = jax_steps.make_loss_fn(jcfg, unroll=False, remat=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (total, (loss, _)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params, jb)
    return float(loss), float(total), grads


def _check_grads(got, want):
    assert sorted(got) == sorted(want)
    for k in sorted(want):
        w = np.asarray(want[k], np.float32)
        g = got[k].numpy()
        scale = max(np.abs(w).max(), 1e-30)
        err = np.abs(g - w).max()
        assert err <= GRAD_TOL * scale, (k, err, scale)


@pytest.mark.parametrize("name", FAMILIES)
def test_step_one_loss_and_grads_match_jax(name):
    jcfg, cfg = jax_get_config(name), get_config(name)
    batch = _batches(cfg, 1)[0]
    want_loss, want_total, want = _jax_grads(jcfg, _jax_params(name), batch)
    loss, total, got = _port_grads(cfg, _port_params(name), batch)
    assert abs(loss - want_loss) <= LOSS_TOL * abs(want_loss)
    assert abs(total - want_total) <= LOSS_TOL * abs(want_total)
    _check_grads(got, want)


def test_vlm_on_embeddings_matches_jax():
    """pixtral-12b-smoke trains on (B, S, d) embeddings, as the JAX
    ``make_loss_fn`` takes them; the served route's forward takes them
    too and gives the training route's logits (1e-5: two attention
    routes)."""
    name = "pixtral-12b-smoke"
    jcfg, cfg = jax_get_config(name), get_config(name)
    assert cfg.input_kind == "embeddings"
    batch = _embedding_batch(cfg)
    want_loss, _, want = _jax_grads(jcfg, _jax_params(name), batch)
    loss, _, got = _port_grads(cfg, _port_params(name), batch)
    assert abs(loss - want_loss) <= LOSS_TOL * abs(want_loss)
    _check_grads(got, want)
    params = _port_params(name)
    served = tf.forward_full(cfg, params, batch["inputs"])[0]
    trained = tf.forward_full(cfg, params, batch["inputs"],
                              impl=AUTOGRAD)[0]
    np.testing.assert_allclose(served.detach().numpy(),
                               trained.detach().numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_curve_matches_jax_over_20_steps(name):
    jcfg, cfg = jax_get_config(name), get_config(name)
    batches = _batches(cfg, 20)
    jstep = jax.jit(jax_steps.make_train_step(jcfg, **TRAIN_KW))
    jp, jo = _jax_params(name), _jax_opt(name)
    want = []
    for b in batches:
        jp, jo, m = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(m["loss"]))
    step = steps.make_train_step(cfg, **TRAIN_KW)
    params = _port_params(name)
    opt = adamw_init(params)
    got = []
    for b in batches:
        params, opt, m = step(params, opt, b)
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=CURVE_TOL, atol=0)
    assert int(opt.step) == 20 and opt.step.dtype == torch.int32


@pytest.mark.parametrize("name", ["qwen2-1.5b-smoke",
                                  "moonshot-v1-16b-a3b-smoke",
                                  "hymba-1.5b-smoke", "rwkv6-1.6b-smoke",
                                  "pixtral-12b-smoke"])
def test_remat_policies_give_the_same_bits(name):
    """No remat, ``"full"`` and ``"dots"`` recompute the same ops: the loss
    and every gradient are equal bit for bit."""
    cfg = get_config(name)
    batch = (_embedding_batch(cfg) if cfg.input_kind != "tokens"
             else _batches(cfg, 1)[0])
    params = _port_params(name)
    base = _port_grads(cfg, params, batch)
    for remat, policy in ((True, "full"), (True, "dots")):
        loss, total, grads = _port_grads(cfg, params, batch, remat, policy)
        assert (loss, total) == base[:2]
        for k, g in grads.items():
            assert torch.equal(g, base[2][k]), (policy, k)


def test_unknown_remat_policy_and_attention_impl_raise():
    cfg = get_config("qwen2-1.5b-smoke")
    params = _port_params("qwen2-1.5b-smoke")
    batch = _batches(cfg, 1)[0]
    with pytest.raises(ValueError, match="remat policy"):
        steps.make_loss_fn(cfg, True, "offload")(params, batch)
    x = torch.zeros((1, 4, 4, 16))
    k = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="unknown attention impl"):
        attn._attend_full(cfg, {"wo": torch.zeros((4, 16, 64))}, x, k, k,
                          torch.float32, impl="jnp")


def test_layers_are_split_by_one_unbind_on_the_training_route():
    """Each stacked parameter is taken apart with one ``unbind``, whose
    backward is one ``stack``."""
    cfg = get_config("qwen2-1.5b-smoke")
    _, blocks = tf.split_params(_port_params("qwen2-1.5b-smoke"))
    leaf = blocks["wq"].detach().requires_grad_(True)
    parts = tf._layers({"wq": leaf}, cfg.num_layers)
    assert parts[0]["wq"].grad_fn.name().startswith("Unbind")


def test_loss_decreases():
    """``tests/test_train_loop.py::test_loss_decreases`` in the port: 80
    steps of qwen2-1.5b-smoke from the port's own draw, the last 5 losses
    below the first 5 by 0.5."""
    cfg = get_config("qwen2-1.5b-smoke")
    params = tf.init_params(cfg, 0, device="cpu")
    opt = adamw_init(params)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    step = steps.make_train_step(cfg, peak_lr=5e-3, warmup=5,
                                 total_steps=300)
    losses = []
    for i in range(80):
        params, opt, m = step(params, opt, ds.global_batch_at(i))
        losses.append(float(m["loss"]))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert np.isfinite(last)
    assert last < first - 0.5, (first, last)


def _clone(tree):
    return {k: v.clone() for k, v in tree.items()}


def test_checkpoint_restart_bit_exact(tmp_path):
    """Kill and restart at step 10 reproduces the uninterrupted run's
    parameters and moments bit for bit at step 20."""
    cfg = get_config("qwen2-1.5b-smoke")
    params0 = tf.init_params(cfg, 0, device="cpu")
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    step = steps.make_train_step(cfg, peak_lr=5e-3, warmup=5,
                                 total_steps=300)

    p, o = _clone(params0), adamw_init(params0)
    for i in range(20):
        p, o, _ = step(p, o, ds.global_batch_at(i))

    mgr = CheckpointManager(tmp_path, async_save=False)
    p2, o2 = _clone(params0), adamw_init(params0)
    for i in range(10):
        p2, o2, _ = step(p2, o2, ds.global_batch_at(i))
    mgr.save({"params": p2, "opt": o2}, step=10)
    del p2, o2                                       # crash
    like = {"params": _clone(params0), "opt": adamw_init(params0)}
    state, step_no, _ = mgr.restore_latest(like)
    assert step_no == 10
    p3, o3 = state["params"], state["opt"]
    assert int(o3.step) == 10 and o3.step.shape == ()
    for i in range(10, 20):
        p3, o3, _ = step(p3, o3, ds.global_batch_at(i))
    for k in p:
        assert torch.equal(p[k], p3[k]), k
        assert torch.equal(o.m[k], o3.m[k]) and torch.equal(o.v[k], o3.v[k])
    assert int(o.step) == int(o3.step) == 20


def test_bf16_training_step_runs_and_keeps_dtypes():
    """A bf16 config trains: parameters stay bf16, moments fp32, the loss
    finite (the card's dtype; its parity is held in fp32 above)."""
    cfg = dataclasses.replace(get_config("qwen2-1.5b-smoke"),
                              dtype="bfloat16")
    params = tf.init_params(cfg, 0, device="cpu")
    opt = adamw_init(params)
    step = steps.make_train_step(cfg, **TRAIN_KW)
    before = _clone(params)
    params, opt, m = step(params, opt, _batches(cfg, 1)[0])
    assert np.isfinite(float(m["loss"]))
    assert all(v.dtype == torch.bfloat16 for v in params.values())
    assert all(v.dtype == torch.float32 for v in opt.m.values())
    assert any(not torch.equal(before[k], params[k]) for k in params)
