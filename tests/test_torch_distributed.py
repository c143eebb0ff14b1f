"""Multi-rank semantics of the port's distribution (compressed all-reduce,
the GPipe pipeline, the data-parallel step, a train step on DTensor
parameters under the production rules), each on 8 ``gloo`` ranks in a
subprocess, against the JAX package on 8 forced host devices or against
the same computation in one process."""
import numpy as np
import pytest

from torch_dist_util import run_jax8, run_ranks

_JAX_REF = """
import functools
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.distributed.collectives import compressed_psum, shard_map_compat
from repro.distributed.pipeline import pipeline_forward
mesh = Mesh(np.asarray(jax.devices()).reshape(8), ("data",))
g = jnp.asarray(np.random.RandomState(0).randn(8, 64), jnp.float32)
out = {}
for method in ("none", "bf16", "int8_ef"):
    @functools.partial(shard_map_compat, mesh=mesh, in_specs=P("data"),
                       out_specs=(P("data"), P("data")))
    def red(x, method=method):
        r, e = compressed_psum(x[0], "data", method)
        return r[None], (jnp.zeros_like(r) if e is None else e)[None]
    out[method], out[method + "_err"] = map(np.asarray, red(g))
# int8_ef with an entering error, as a second round sees it
e0 = jnp.asarray(np.random.RandomState(2).randn(8, 64) * 0.01, jnp.float32)
@functools.partial(shard_map_compat, mesh=mesh,
                   in_specs=(P("data"), P("data")),
                   out_specs=(P("data"), P("data")))
def red2(x, e):
    r, ne = compressed_psum(x[0], "data", "int8_ef", e[0])
    return r[None], ne[None]
out["int8_ef2"], out["int8_ef2_err"] = map(np.asarray, red2(g, e0))
pmesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("stage",))
rng = np.random.RandomState(0)
ws = jnp.asarray(rng.randn(4, 16, 16) * 0.3, jnp.float32)
mbs = jnp.asarray(rng.randn(6, 8, 16), jnp.float32)
out["pipeline"] = np.asarray(pipeline_forward(
    lambda w, x: jnp.tanh(x @ w), pmesh)(ws, mbs))
np.savez(OUT, **out)
"""

_PORT = """
from repro_torch.distributed.collectives import (compressed_psum,
                                                 make_dp_train_step)
from repro_torch.distributed.pipeline import pipeline_forward
res = {}

def gather(t):
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous())
    return torch.stack(parts).numpy()

g = torch.tensor(np.random.RandomState(0).randn(8, 64), dtype=torch.float32)
for method in ("none", "bf16", "int8_ef"):
    r, e = compressed_psum(g[rank], None, method)
    res[method] = gather(r)
    res[method + "_err"] = gather(torch.zeros_like(r) if e is None else e)
e0 = torch.tensor(np.random.RandomState(2).randn(8, 64) * 0.01,
                  dtype=torch.float32)
r, e = compressed_psum(g[rank], None, "int8_ef", e0[rank])
res["int8_ef2"], res["int8_ef2_err"] = gather(r), gather(e)

# error feedback: repeated rounds of a constant gradient
g1 = torch.tensor(np.random.RandomState(1).randn(8, 32), dtype=torch.float32)
err, acc = None, torch.zeros(32)
for _ in range(12):
    r, err = compressed_psum(g1[rank], None, "int8_ef", err)
    acc = acc + r
res["ef_mean"] = (acc / 12).numpy()
res["ef_one"] = compressed_psum(g1[rank], None, "int8_ef")[0].numpy()

# 4-stage pipeline on ranks 0-3
stages = dist.new_group([0, 1, 2, 3])
rng = np.random.RandomState(0)
ws = torch.tensor(rng.randn(4, 16, 16) * 0.3, dtype=torch.float32)
mbs = torch.tensor(rng.randn(6, 8, 16), dtype=torch.float32)
if rank < 4:
    res["pipeline"] = pipeline_forward(lambda w, x: torch.tanh(x @ w),
                                       stages)(ws, mbs).numpy()

# data-parallel SGD, 2 steps, "none": each rank its 8 rows of 64
rng = np.random.RandomState(3)
params = {"w1": torch.tensor(rng.randn(16, 32) * 0.3, dtype=torch.float32),
          "w2": torch.tensor(rng.randn(32, 4) * 0.3, dtype=torch.float32)}
xs = torch.tensor(rng.randn(64, 16), dtype=torch.float32)
ys = torch.tensor(rng.randn(64, 4), dtype=torch.float32)

def loss_fn(p, batch):
    x, y = batch
    return torch.mean(torch.square(torch.tanh(x @ p["w1"]) @ p["w2"] - y))

def sgd(p, grads):
    return {k: p[k] - 0.1 * grads[k] for k in p}

step = make_dp_train_step(loss_fn, sgd, None, "none")
p, e = dict(params), None
for _ in range(2):
    p, e = step(p, (xs[8 * rank:8 * rank + 8], ys[8 * rank:8 * rank + 8]), e)
res["dp_w1"], res["dp_w2"] = p["w1"].numpy(), p["w2"].numpy()
if rank == 0:
    np.savez(out, **res)
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    return run_ranks(_PORT, tmp), run_jax8(_JAX_REF, tmp)


def test_compressed_psum_matches_reference(results):
    port, ref = results
    g = np.random.RandomState(0).randn(8, 64).astype(np.float32)
    exact = g.mean(0)
    np.testing.assert_allclose(port["none"], ref["none"], rtol=0, atol=1e-6)
    for key in ("int8_ef", "int8_ef_err", "int8_ef2", "int8_ef2_err"):
        np.testing.assert_allclose(port[key], ref[key], rtol=0, atol=1e-6,
                                   err_msg=key)
    assert float(np.abs(port["bf16"] - exact).max()) < 2e-2
    assert float(np.abs(ref["bf16"] - exact).max()) < 2e-2
    assert float(np.abs(port["none"] - exact).max()) < 1e-6
    # every rank holds the same mean; the errors are each rank's own
    assert all(np.array_equal(port["int8_ef"][0], r) for r in port["int8_ef"])
    assert not np.array_equal(port["int8_ef_err"][0], port["int8_ef_err"][1])


def test_int8_error_feedback_converges(results):
    """With error feedback, the mean of repeated compressed reductions of a
    constant gradient converges to the true mean (bias -> 0)."""
    port, _ = results
    exact = np.random.RandomState(1).randn(8, 32).astype(np.float32).mean(0)
    bias = float(np.abs(port["ef_mean"] - exact).max())
    one = float(np.abs(port["ef_one"] - exact).max())
    assert bias < one * 0.6, (bias, one)


def test_pipeline_matches_stacked_forward_and_reference(results):
    port, ref = results
    rng = np.random.RandomState(0)
    ws = rng.randn(4, 16, 16) * 0.3
    x = rng.randn(6, 8, 16)
    for i in range(4):
        x = np.tanh(x @ ws[i])
    np.testing.assert_allclose(port["pipeline"], x, rtol=0, atol=1e-5)
    np.testing.assert_allclose(port["pipeline"], ref["pipeline"], rtol=0,
                               atol=1e-5)


def test_dp_train_step_equals_single_process(results):
    import torch
    port, _ = results
    rng = np.random.RandomState(3)
    p = {"w1": torch.tensor(rng.randn(16, 32) * 0.3, dtype=torch.float32),
         "w2": torch.tensor(rng.randn(32, 4) * 0.3, dtype=torch.float32)}
    xs = torch.tensor(rng.randn(64, 16), dtype=torch.float32)
    ys = torch.tensor(rng.randn(64, 4), dtype=torch.float32)
    for _ in range(2):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        loss = torch.mean(torch.square(
            torch.tanh(xs @ leaves["w1"]) @ leaves["w2"] - ys))
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(
            leaves.values()))))
        p = {k: p[k] - 0.1 * grads[k] for k in p}
    np.testing.assert_allclose(port["dp_w1"], p["w1"].numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(port["dp_w2"], p["w2"].numpy(), rtol=0,
                               atol=1e-5)


_TRAIN = """
import dataclasses
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import (axis_rules, is_dtensor, place,
                                              sharding_for)
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as tf
from repro_torch.models.common import param_shardings, place_params
from repro_torch.optim.adamw import adamw_init, adamw_init_specs

cfg = dataclasses.replace(get_config("qwen2-1.5b-smoke"), **CFG)
params = tf.init_params(cfg, 0, device="cpu")
rng = np.random.RandomState(0)
batch = {"inputs": torch.tensor(rng.randint(0, 512, (4, 32)),
                                dtype=torch.int32),
         "targets": torch.tensor(rng.randint(0, 512, (4, 32)),
                                 dtype=torch.int32)}
step = make_train_step(cfg, **TRAIN_KW)
# the unsharded forward and backward, on copies
p0 = {k: v.clone() for k, v in params.items()}
leaves, total, (loss0, _) = step.forward(p0, batch)
g0 = step.backward(leaves, total)

mesh = make_test_mesh((2, 4))
specs = tf.model_specs(cfg)
with axis_rules(mesh, "train"):
    ps = place_params({k: v.clone() for k, v in params.items()},
                      param_shardings(specs))
    opt = adamw_init(params)
    ospecs = adamw_init_specs(specs)
    opt = opt._replace(m=place_params(opt.m, param_shardings(ospecs.m)),
                       v=place_params(opt.v, param_shardings(ospecs.v)))
    b = {k: place(v, sharding_for(v.shape, ("batch", None)))
         for k, v in batch.items()}
    sharded = sum(any(pl.is_shard() for pl in t.placements)
                  for t in ps.values())
    leaves, total, (loss, _) = step.forward(ps, b)
    g = step.backward(leaves, total)
    all_dtensor = all(is_dtensor(t) for t in g.values())
    grads = {k: t.full_tensor() for k, t in g.items()}
    ps, opt, _ = step.update(ps, opt, g)
    loss = loss.detach().full_tensor()
    full = {k: v.full_tensor() for k, v in ps.items()}
# the same update on plain tensors from the sharded step's own gradients
p1 = {k: v.clone() for k, v in params.items()}
p1, _, _ = step.update(p1, adamw_init(p1), grads)
if rank == 0:
    np.savez(out, loss=np.float32(loss), loss0=np.float32(loss0.detach()),
             sharded=sharded, all_dtensor=all_dtensor,
             inputs=batch["inputs"].numpy(),
             targets=batch["targets"].numpy(),
             **{"p_" + k: v.numpy() for k, v in full.items()},
             **{"q_" + k: v.numpy() for k, v in p1.items()},
             **{"g_" + k: v.numpy() for k, v in grads.items()},
             **{"h_" + k: v.numpy() for k, v in g0.items()},
             **{"i_" + k: v.numpy() for k, v in params.items()})
"""
# The reference test's reduced qwen2 smoke config in fp32, and an lr at
# which one AdamW step moves a parameter by about 1e-2: the update is then
# seen far above the 1e-6 it is held at (at the default schedule's 3e-6 a
# bf16 parameter does not move at all). The update is held against AdamW
# on plain tensors from the same gradients, and the gradients against the
# unsharded step's: AdamW's first step is about lr * sign(g), so an entry
# whose exact gradient is about 0 moves by its rounding noise, which no two
# reduction orders share (the key bias in RoPE's slowest-turning dims,
# which shift every key's score nearly alike over 32 positions).
_TRAIN_CFG = dict(d_model=128, d_ff=256, num_heads=8, num_kv_heads=4,
                  head_dim=16, vocab_size=512, dtype="float32")
_TRAIN_KW = dict(peak_lr=1e-2, warmup=1)
PARAM_TOL = 1e-6             # each updated parameter, absolute
GRAD_TOL = 1e-4              # each gradient leaf, of its max |gradient|


def _jax_grads(out):
    """The JAX package's loss and gradients (its own training loss
    function, remat on) on the port's initial weights and batch."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.launch import steps as jax_steps
    cfg = dataclasses.replace(jax_get_config("qwen2-1.5b-smoke"),
                              **_TRAIN_CFG)
    params = {k[2:]: jnp.asarray(v) for k, v in out.items()
              if k.startswith("i_")}
    batch = {k: jnp.asarray(out[k]) for k in ("inputs", "targets")}
    loss_fn = jax_steps.make_loss_fn(cfg, False, True)
    (_, (loss, _)), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, batch)
    return float(loss), {k: np.asarray(v) for k, v in g.items()}


def test_production_rules_train_step_on_dtensors(tmp_path):
    """The rule engine drives a train step on DTensor parameters over a
    2 x 4 (data x model) gloo mesh under "train": the loss and every
    gradient leaf (a DTensor, read whole) against the same step unsharded
    and against the JAX package's on the same weights and batch; the
    DTensor update against AdamW on plain tensors from the same gradients,
    at an lr that moves the parameters far beyond the tolerance."""
    body = (f"CFG = {_TRAIN_CFG!r}\nTRAIN_KW = {_TRAIN_KW!r}\n"
            + _TRAIN.lstrip("\n"))
    out = run_ranks(body, tmp_path, timeout=180)
    assert int(out["sharded"]) > 0 and bool(out["all_dtensor"])
    assert abs(float(out["loss"]) - float(out["loss0"])) < 1e-5
    names = sorted(k[2:] for k in out if k.startswith("p_"))
    assert names == sorted(k[2:] for k in out if k.startswith("g_"))
    jloss, jg = _jax_grads(out)
    assert abs(jloss - float(out["loss0"])) < 1e-5
    assert sorted(jg) == names
    for k in names:
        got = out["g_" + k]
        for want in (out["h_" + k], jg[k]):
            err = np.max(np.abs(got - want))
            assert err <= GRAD_TOL * np.max(np.abs(want)), (k, err)
        moved = np.mean(np.abs(out["p_" + k] - out["i_" + k]))
        assert moved > 1000 * PARAM_TOL, (k, moved)
        np.testing.assert_allclose(out["p_" + k], out["q_" + k], rtol=0,
                                   atol=PARAM_TOL, err_msg=k)
