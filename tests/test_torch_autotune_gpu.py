"""The kernel autotune cache on the card: a sweep of each tunable kernel's
plans (trials > 0, timed by CUDA events), every plan's output against the
default plan's (``int8_matmul`` and ``ssm_scan`` bit for bit, ``wkv6``
within its tolerance), then the table packed into an image, reloaded by a
fresh ``Platform.provision`` (``autotune_loaded``) and a second sweep that
costs zero trials.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_autotune_gpu.py

The file imports torch and the port only, so it runs where JAX is absent.
"""
import json

import pytest
import torch

from repro_torch.core.rtpm import Platform
from repro_torch.kernels import registry as kreg
from repro_torch.kernels.int8_matmul import ops as im_ops
from repro_torch.kernels.ssm_scan import ops as ss_ops
from repro_torch.kernels.wkv6 import ops as wk_ops

WKV_TOL = 5e-4                           # tests/test_kernels.py:60, fp32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    kreg.reset()
    yield torch.device("cuda")
    kreg.reset()


def _sites(dev):
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    x = torch.randint(-127, 128, (49, 4608), generator=g, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (4608, 512), generator=g, device=dev,
                      dtype=torch.int8)
    da = -rnd(1, 256, 64, 16).abs() * 0.1
    lw = -(rnd(1, 128, 4, 64).abs().clamp(0.05, 3.0))
    return {
        "matmul_int8_i32": ((x, w), {}),
        "matmul_int8": ((x, w, rnd(512).abs() + 0.1),
                        {"out_dtype": torch.bfloat16}),
        "ssm_scan": ((da, rnd(1, 256, 64, 16), rnd(1, 256, 16)), {}),
        "wkv6": ((rnd(1, 128, 4, 64), rnd(1, 128, 4, 64),
                  rnd(1, 128, 4, 64), lw, rnd(4, 64)), {}),
    }


@pytest.mark.gpu
def test_sweep_then_reload_costs_zero_trials(cuda):
    sites = _sites(cuda)
    first = {}
    for name, (args, kw) in sites.items():
        default = kreg.call(name, *args, **kw)
        plan, trials = kreg.autotune(name, *args, **kw)
        assert trials == len(kreg.get(name).candidates(*args, **kw)) > 1
        first[name] = plan
        for cand in kreg.get(name).candidates(*args, **kw):
            got = kreg.get(name).kernel(*args, plan=cand, **kw)
            if name == "wkv6":
                torch.testing.assert_close(got, default, atol=WKV_TOL,
                                           rtol=WKV_TOL)
            else:
                assert torch.equal(got, default), (name, cand)
        tuned = kreg.call(name, *args, **kw)  # the winner, through call
        assert kreg.params_for(name, args, kw) == plan
        if name != "wkv6":
            assert torch.equal(tuned, default)
    q = torch.randn(1, 64, 4, 128, device=cuda, dtype=torch.bfloat16)
    assert kreg.autotune("attention", q, q, q, causal=True) == ({}, 0)
    swept = kreg.REGISTRY.sweep_trials
    assert swept > 0
    image = kreg.pack_image()
    kreg.reset()
    plat = Platform(device="cuda")
    seen = []
    plat.events.register("autotune_loaded", seen.append)
    plat.provision(image=image)
    plat.events.process()
    assert seen == [{"entries": len(sites) + 1}]
    for name, (args, kw) in sites.items():
        assert kreg.autotune(name, *args, **kw) == (first[name], 0)
    assert kreg.REGISTRY.sweep_trials == 0
    print("AUTOTUNE_GPU " + json.dumps({"trials_first": swept,
                                        "trials_second": 0,
                                        "winners": first}))


@pytest.mark.gpu
def test_a_plan_where_the_ring_cannot_run_takes_the_rowwise_instance(cuda):
    """An operand off a 16-byte boundary cannot take the ring: a ring plan
    gives the row-wise instance's bits."""
    g = torch.Generator(device=cuda).manual_seed(1)
    buf = -torch.randn(1 + 64 * 16 * 8, generator=g, device=cuda).abs()
    da = buf[1:].reshape(1, 64, 8, 16)            # 4 bytes past a boundary
    bx = torch.randn(1, 64, 8, 16, generator=g, device=cuda)
    c = torch.randn(1, 64, 16, generator=g, device=cuda)
    assert ss_ops.plan_of(da, bx, c, 64).instance == ss_ops.ROWWISE
    want = ss_ops.ssm_scan(da, bx, c, plan={"instance": ss_ops.ROWWISE})
    got = ss_ops.ssm_scan(da, bx, c, plan={"instance": ss_ops.RING, "w": 64})
    assert torch.equal(got, want)
    assert im_ops.normal_splits(4608, 15) == 15
    assert wk_ops.candidates()[0] == {"states": wk_ops.INBLOCK}
