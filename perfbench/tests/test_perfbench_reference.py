"""The plain reference against the port's own forward pass, at a tiny
configuration on the CPU in fp32: the same weights, the same logits."""
import dataclasses

import numpy as np
import pytest
import torch

from perfbench import reference, weights
from perfbench.tests.conftest import TINY
from repro_torch.configs import get_config
from repro_torch.models import transformer as tf


def _tiny(name: str):
    return get_config(TINY[name]["port"]["config"]), TINY[name]


@pytest.mark.parametrize("name,length", [("tiny-dense", 37),
                                         ("tiny-rwkv6", 37),
                                         ("tiny-rwkv6", 150)])
def test_reference_matches_port(name, length):
    cfg, config = _tiny(name)
    params = weights.draw(tf.model_specs(cfg), 1234, "cpu")
    ids = np.random.default_rng(5).integers(0, cfg.vocab_size, length)
    port, _, _ = tf.forward_full(cfg, params, torch.as_tensor(ids)[None])
    start = length - 9
    ref = reference.logits(config, params, [ids], [start])[0]
    assert ref.shape == (9, cfg.vocab_size)
    np.testing.assert_allclose(ref.numpy(), port[0, start:].numpy(),
                               atol=2e-4, rtol=0)


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-rwkv6"])
def test_fp8_control_departs_from_fp32(name):
    """The control computes another function: rounding every product's
    operands to float8 moves the logits far more than fp32 rounding."""
    cfg, config = _tiny(name)
    params = weights.draw(tf.model_specs(cfg), 99, "cpu")
    ids = np.random.default_rng(6).integers(0, cfg.vocab_size, 40)
    a = reference.logits(config, params, [ids], [0])[0]
    b = reference.logits(config, params, [ids], [0], precision="fp8")[0]
    assert 1e-2 < float((a - b).abs().max()) < 10.0


def test_reference_leaves_tf32_as_it_was():
    cfg, config = _tiny("tiny-dense")
    params = weights.draw(tf.model_specs(cfg), 3, "cpu")
    before = torch.backends.cuda.matmul.allow_tf32
    reference.logits(config, params, [np.arange(5)], [0])
    assert torch.backends.cuda.matmul.allow_tf32 == before


def test_chunked_wkv_equals_the_recurrence():
    """The reference's chunked WKV against the step-by-step recurrence,
    over a length that is not a whole number of chunks."""
    from perfbench.reference.rwkv6 import wkv
    g = torch.Generator().manual_seed(0)
    T, H, K = 150, 2, 8
    r, k, v = (torch.randn((T, H, K), generator=g) for _ in range(3))
    lw = -torch.exp(torch.randn((T, H, K), generator=g))
    u = torch.randn((H, K), generator=g)
    S = torch.zeros((H, K, K))
    ys = []
    for t in range(T):
        kv = k[t][..., :, None] * v[t][..., None, :]
        ys.append(torch.einsum("hi,hio->ho", r[t], S + u[..., None] * kv))
        S = torch.exp(lw[t])[..., None] * S + kv
    np.testing.assert_allclose(wkv(r, k, v, lw, u).numpy(),
                               torch.stack(ys).numpy(), atol=1e-4, rtol=1e-4)


def test_weights_follow_the_specs_and_the_seed():
    cfg = get_config("rwkv6-1.6b-smoke")
    specs = tf.model_specs(cfg)
    a = weights.draw(specs, 2**31 + 7, "cpu")
    b = weights.draw(specs, 2**31 + 7, "cpu")
    c = weights.draw(specs, 2**31 + 8, "cpu")
    assert sorted(a) == sorted(specs)
    for n, s in specs.items():
        assert tuple(a[n].shape) == tuple(s.shape)
        assert a[n].dtype == getattr(torch, s.dtype)
        assert torch.equal(a[n], b[n])
    assert not torch.equal(a["tm_wr"], c["tm_wr"])
    w0 = a["tm_w0"]
    assert float(w0.min()) >= -6.0 and float(w0.max()) <= -1.0
    assert abs(float(a["tm_wk"].float().std()) * cfg.d_model ** 0.5 - 1) < 0.1
    assert dataclasses.is_dataclass(cfg)
