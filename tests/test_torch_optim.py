"""The optimizer and schedule in the port against the JAX package on the
same trees (``repro.optim``), and ``tests/test_optim.py``'s cases in the
port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import ParamSpec as JaxParamSpec
from repro.models.common import init_params as jax_init_params
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import adamw_init_specs
from repro.optim.adamw import adamw_update as jax_adamw_update
from repro.optim.schedules import cosine_warmup as jax_cosine_warmup
from repro_torch.optim import (AdamWConfig, AdamWState, adamw_init,
                               adamw_update, cosine_warmup, global_norm)

TOL = 1e-6                    # relative, as the JAX package's
SHAPES = {"w": (8, 8), "b": (8,), "e": (16, 4)}


def _jax_tree():
    specs = {"w": JaxParamSpec((8, 8), "float32", (None, None)),
             "b": JaxParamSpec((8,), "float32", (None,), "zeros"),
             "e": JaxParamSpec((16, 4), "float32", (None, None), "embed")}
    return (jax_init_params(jax.random.PRNGKey(0), specs),
            jax_init_params(jax.random.PRNGKey(1), adamw_init_specs(specs)))


def _port(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _grads(step: int) -> dict:
    """Step 3's gradients are large, so that step clips."""
    rng = np.random.RandomState(100 + step)
    scale = 50.0 if step == 3 else 0.02
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol * max(np.abs(np.asarray(want)).max(),
                                              1e-30))


@pytest.mark.parametrize("cfg_kw", [{}, {"weight_decay": 0.0, "b2": 0.99},
                                    {"clip_norm": 0.5, "eps": 1e-6}])
def test_adamw_matches_jax_over_5_steps(cfg_kw):
    jparams, jopt = _jax_tree()
    params, opt = _port(jparams), adamw_init(_port(jparams))
    jcfg, cfg = JaxAdamWConfig(**cfg_kw), AdamWConfig(**cfg_kw)
    clipped = []
    for step in range(5):
        g = _grads(step)
        lr = float(jax_cosine_warmup(jopt.step, 1e-2, 2, 10))
        jparams, jopt, jm = jax_adamw_update(
            jcfg, {k: jnp.asarray(v) for k, v in g.items()}, jopt, jparams,
            jnp.asarray(lr, jnp.float32))
        params, opt, m = adamw_update(
            cfg, {k: torch.from_numpy(v) for k, v in g.items()}, opt,
            params, torch.tensor(lr, dtype=torch.float32))
        for k in SHAPES:
            _close(params[k], jparams[k])
            _close(opt.m[k], jopt.m[k])
            _close(opt.v[k], jopt.v[k])
        _close(m["grad_norm"], jm["grad_norm"])
        _close(m["clip_scale"], jm["clip_scale"])
        assert int(opt.step) == int(jopt.step) == step + 1
        clipped.append(float(m["clip_scale"]) < 1.0)
    assert clipped[3] and not clipped[0]


def test_adamw_updates_in_place_and_keeps_dtypes():
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16),
              "b": torch.zeros((4,))}
    opt = adamw_init(params)
    assert isinstance(opt, AdamWState) and opt.step.dtype == torch.int32
    assert opt.step.shape == () and int(opt.step) == 0
    assert all(v.dtype == torch.float32 for v in opt.m.values())
    w = params["w"]
    grads = {"w": torch.full((4, 4), 0.5), "b": torch.full((4,), 0.5)}
    out, opt2, _ = adamw_update(AdamWConfig(), grads, opt, params,
                                torch.tensor(0.1))
    assert out["w"] is w and w.dtype == torch.bfloat16
    assert opt2.m is opt.m and int(opt2.step) == 1
    assert not torch.equal(w, torch.ones((4, 4), dtype=torch.bfloat16))


@pytest.mark.parametrize("step", [0, 1, 4, 5, 9, 10, 50, 99, 100, 150])
def test_cosine_warmup_matches_jax(step):
    for peak, warm, total in ((1e-3, 10, 100), (3e-3, 20, 30), (5e-3, 5, 300)):
        want = float(jax_cosine_warmup(jnp.asarray(step, jnp.int32), peak,
                                       warm, total))
        got = cosine_warmup(torch.tensor(step, dtype=torch.int32), peak,
                            warm, total)
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - want) <= TOL * abs(want)


# ---------------------------------------------------------------------------
# tests/test_optim.py's cases
# ---------------------------------------------------------------------------

def _setup():
    jparams, _ = _jax_tree()
    params = {k: _port(jparams)[k] for k in ("w", "b")}
    return params, adamw_init(params)


def test_adamw_minimizes_quadratic():
    params, opt = _setup()
    target = {k: torch.full_like(v, 0.3) for k, v in params.items()}

    def loss_fn(p):
        return sum(torch.sum((p[k] - target[k]) ** 2) for k in sorted(p))

    cfg = AdamWConfig(weight_decay=0.0)
    l0 = float(loss_fn(params))
    for _ in range(200):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        g = dict(zip(leaves, torch.autograd.grad(loss_fn(leaves),
                                                 list(leaves.values()))))
        params, opt, _ = adamw_update(cfg, g, opt, params,
                                      torch.tensor(0.05))
    assert float(loss_fn(params)) < 0.01 * l0


def test_grad_clip_bounds_update():
    params, opt = _setup()
    huge = {k: torch.full_like(v, 1e6) for k, v in params.items()}
    cfg = AdamWConfig(clip_norm=1.0, weight_decay=0.0)
    _, _, m = adamw_update(cfg, huge, opt, params, torch.tensor(1e-3))
    assert float(m["grad_norm"] * m["clip_scale"]) <= 1.0 + 1e-4


def test_global_norm():
    t = {"a": torch.ones((3,)) * 2.0, "b": torch.zeros((4,))}
    assert np.isclose(float(global_norm(t)), np.sqrt(12.0))


def test_cosine_warmup_shape():
    xs = [float(cosine_warmup(torch.tensor(s), 1e-3, 10, 100))
          for s in range(0, 100, 5)]
    assert xs[0] < xs[1]                       # warming up
    assert max(xs) <= 1e-3 + 1e-9
    assert xs[-1] < xs[3]                      # decaying
    assert xs[-1] >= 1e-4 - 1e-9               # min_ratio floor


def test_moments_are_fp32_like_params():
    """``test_moments_sharded_like_params`` without the sharding axes (the
    port runs on one device): fp32 moments of each parameter's shape."""
    params = {"w": torch.zeros((64, 128), dtype=torch.bfloat16)}
    st = adamw_init(params)
    assert st.m["w"].shape == (64, 128) and st.m["w"].dtype == torch.float32
    assert st.v["w"].shape == (64, 128) and st.v["w"].dtype == torch.float32
