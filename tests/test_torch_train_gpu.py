"""Training and the hand kernels on the card: a backward through a kernel
route raises (no kernel has a backward, in the JAX package either), and a
training step on CUDA launches none of the four kernels, its counters
unchanged over the step.

These tests need a CUDA device and skip without one. On the machine with
the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_gpu.py

The file imports torch and the port only, so it runs where JAX is absent.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels.registry import launch_counters
from repro_torch.launch.steps import make_train_step
from repro_torch.models import mamba, rwkv6
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import adamw_init


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels launch only on "
                    "the card")
    return torch.device("cuda")


def _launches():
    return {name: w.launches for name, w in launch_counters().items()}


def _smoke(name, layers=2):
    """The smoke config at a head size the kernels take (16)."""
    return dataclasses.replace(get_config(name), num_layers=layers)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qwen2-1.5b-smoke", "hymba-1.5b-smoke",
                                  "rwkv6-1.6b-smoke"])
def test_backward_through_the_kernel_route_raises(cuda, name):
    """``forward_full`` on its default route launches the kernels on the
    card; their custom ops carry no autograd formula, so the backward
    raises instead of computing a wrong gradient."""
    cfg = _smoke(name)
    params = {k: v.requires_grad_(True) for k, v in
              tf.init_params(cfg, 0, cuda).items()}
    tokens = torch.randint(0, cfg.vocab_size, (1, 16), device=cuda)
    before = _launches()
    logits, _, _ = tf.forward_full(cfg, params, tokens)
    assert _launches() != before             # a kernel ran
    with pytest.raises(RuntimeError, match="autograd"):
        logits.float().sum().backward()


@pytest.mark.gpu
def test_kernel_scans_raise_in_backward_on_cuda(cuda):
    B, T, di, N = 1, 32, 16, 4
    g = torch.Generator(device=cuda).manual_seed(0)
    u = torch.randn((B, T, di), device=cuda, generator=g).requires_grad_()
    dt = torch.rand((B, T, di), device=cuda, generator=g)
    bc = torch.randn((B, T, N), device=cuda, generator=g)
    A = -torch.rand((di, N), device=cuda, generator=g) - 0.1
    y, _ = mamba.ssm_core(u, dt, bc, bc, A, torch.ones(di, device=cuda),
                          torch.zeros((B, di, N), device=cuda))
    with pytest.raises(RuntimeError, match="autograd"):
        y.sum().backward()
    H, K = 2, 16
    r = torch.randn((B, T, H, K), device=cuda, generator=g).requires_grad_()
    lw = -torch.rand((B, T, H, K), device=cuda, generator=g)
    y, _ = rwkv6.wkv_core(r, r.detach(), r.detach(), lw,
                          torch.zeros((H, K), device=cuda),
                          torch.zeros((B, H, K, K), device=cuda))
    with pytest.raises(RuntimeError, match="autograd"):
        y.sum().backward()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qwen2-1.5b-smoke",
                                  "moonshot-v1-16b-a3b-smoke",
                                  "hymba-1.5b-smoke", "rwkv6-1.6b-smoke"])
def test_a_training_step_launches_no_kernel(cuda, name):
    cfg = _smoke(name)
    params = tf.init_params(cfg, 0, cuda)
    opt = adamw_init(params)
    step = make_train_step(cfg, peak_lr=1e-3, warmup=5, total_steps=100)
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in SyntheticLM(
        cfg.vocab_size, 32, 4).global_batch_at(0).items()}
    before = _launches()
    params, opt, m = step(params, opt, batch)
    torch.cuda.synchronize()
    assert _launches() == before
    assert torch.isfinite(m["loss"]) and int(opt.step) == 1
