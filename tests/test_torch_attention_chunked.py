"""The stock-op attention's query chunks (``_attend_windowed`` from S =
``CHUNKED_FROM`` on) against the JAX package's ``_attend_full``, which
chunks the same way, at the lengths where the chunks begin: B = 1, one
head, D = 16, full causal and a sliding window of 1024. The output after
the projection and the gradients of q, k, v and wo, on the training route
(``impl="autograd"``) and, for the window, the served route's forward."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attn
from repro_torch.configs import get_config
from repro_torch.models import attention as attn
from repro_torch.models.common import AUTOGRAD

OUT_TOL = 1e-5               # the output, of its max |value|
GRAD_TOL = 1e-4              # each gradient, of its max |gradient|
D, WINDOW = 16, 1024


def _cfgs(attention):
    kw = dict(num_heads=1, num_kv_heads=1, head_dim=D, d_model=D,
              attention=attention,
              sliding_window=WINDOW if attention == "sliding" else 0)
    return (dataclasses.replace(get_config("qwen2-1.5b-smoke"), **kw),
            dataclasses.replace(jax_get_config("qwen2-1.5b-smoke"), **kw))


def _inputs(S):
    rng = np.random.RandomState(S)
    q, k, v = (rng.randn(1, S, 1, D).astype(np.float32) for _ in range(3))
    wo = (rng.randn(1, D, D) * 0.25).astype(np.float32)
    ct = rng.randn(1, S, D).astype(np.float32)
    return q, k, v, wo, ct


def _jax(cfg, q, k, v, wo, ct):
    def f(q, k, v, wo):
        y = jax_attn._attend_full(cfg, {"wo": wo}, q, k, v, jnp.float32)
        return jnp.sum(y * ct), y
    (_, y), g = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3),
                                           has_aux=True))(q, k, v, wo)
    return np.asarray(y), [np.asarray(t) for t in g]


def _close(got, want, tol, what):
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * float(np.max(np.abs(want))), (what, err)


@pytest.mark.parametrize("attention,S", [("full", 16384),
                                         ("sliding", 16384),
                                         ("sliding", 32768)])
def test_chunked_attention_matches_reference(attention, S):
    cfg, jcfg = _cfgs(attention)
    assert S >= attn.CHUNKED_FROM
    q, k, v, wo, ct = _inputs(S)
    want, wgrads = _jax(jcfg, q, k, v, wo, ct)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v, wo)]
    y = attn._attend_full(cfg, {"wo": leaves[3]}, *leaves[:3],
                          torch.float32, impl=AUTOGRAD)
    torch.sum(y * torch.tensor(ct)).backward()
    _close(y.detach().numpy(), want, OUT_TOL, "out")
    for name, t, g in zip("qkvw", leaves, wgrads):
        _close(t.grad.numpy(), g, GRAD_TOL, name)
    if attention == "sliding":
        # a window at S > W takes the same route when served
        with torch.no_grad():
            served = attn._attend_full(
                cfg, {"wo": torch.tensor(wo)},
                *(torch.tensor(a) for a in (q, k, v)), torch.float32)
        _close(served.numpy(), want, OUT_TOL, "served")
