"""The training route's chunked scans, ``ssm_chunked`` and ``wkv_chunked``,
against the JAX package's: forward outputs and final states, and the
gradients of a fixed weighted sum of them (``torch.autograd.grad`` against
``jax.grad``), at T a multiple of the chunk and not, from a nonzero
entering state; each also against the kernel's plain version from a zero
state, and the ``impl="autograd"`` routes through ``ssm_core`` and
``wkv_core``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jax_mamba
from repro.models import rwkv6 as jax_rwkv
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.kernels.wkv6.ref import wkv6_ref_bthk
from repro_torch.models import mamba, rwkv6

SSM_TOL = 2e-5                # of each output's scale
WKV_TOL = 5e-4


def _close(got, want, tol):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _ssm_inputs(T, seed, zero_state=False):
    rng = np.random.RandomState(seed)
    B, di, N = 2, 12, 4
    f = np.float32
    return {"u": rng.standard_normal((B, T, di)).astype(f),
            "dt": np.log1p(np.exp(rng.standard_normal((B, T, di)))).astype(f),
            "B_": rng.standard_normal((B, T, N)).astype(f),
            "C_": rng.standard_normal((B, T, N)).astype(f),
            "A": -np.exp(rng.uniform(-1, 1, (di, N))).astype(f),
            "D": rng.standard_normal((di,)).astype(f),
            "h0": (np.zeros((B, di, N)) if zero_state else
                   rng.standard_normal((B, di, N))).astype(f)}


def _wkv_inputs(T, seed, zero_state=False):
    rng = np.random.RandomState(seed)
    B, H, K = 2, 3, 8
    f = np.float32
    x = {n: (rng.standard_normal((B, T, H, K)) * 0.5).astype(f)
         for n in ("r", "k", "v")}
    x["lw"] = -np.exp(rng.uniform(-6, 1, (B, T, H, K))).astype(f)
    x["u"] = rng.uniform(-0.5, 0.5, (H, K)).astype(f)
    x["s0"] = (np.zeros((B, H, K, K)) if zero_state else
               rng.standard_normal((B, H, K, K))).astype(f)
    return x


def _weights(outs, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(np.shape(o)).astype(np.float32)
            for o in outs]


def _check_forward_and_grads(port_fn, jax_fn, inputs, tol, seed):
    names = list(inputs)
    want = jax_fn(*(jnp.asarray(inputs[n]) for n in names))
    ws = _weights(want, seed)

    def jloss(*args):
        outs = jax_fn(*args)
        return sum(jnp.sum(o * w) for o, w in zip(outs, ws))
    jgrads = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(inputs[n]) for n in names))

    leaves = [torch.from_numpy(inputs[n]).requires_grad_(True)
              for n in names]
    got = port_fn(*leaves)
    for g, w in zip(got, want):
        _close(g.detach().numpy(), w, tol)
    loss = sum(torch.sum(o * torch.from_numpy(w)) for o, w in zip(got, ws))
    grads = torch.autograd.grad(loss, leaves)
    for n, g, w in zip(names, grads, jgrads):
        _close(g.numpy(), w, tol)


@pytest.mark.parametrize("T", [64, 50, 130])
def test_ssm_chunked_matches_jax_forward_and_grad(T):
    _check_forward_and_grads(mamba.ssm_chunked, jax_mamba.ssm_chunked,
                             _ssm_inputs(T, T), SSM_TOL, T + 1)


@pytest.mark.parametrize("T", [32, 21, 40])
def test_wkv_chunked_matches_jax_forward_and_grad(T):
    _check_forward_and_grads(rwkv6.wkv_chunked, jax_rwkv.wkv_chunked,
                             _wkv_inputs(T, T), WKV_TOL, T + 1)


@pytest.mark.parametrize("T", [64, 50])
def test_ssm_chunked_matches_the_kernels_plain_version(T):
    x = {n: torch.from_numpy(v) for n, v in
         _ssm_inputs(T, 7, zero_state=True).items()}
    y, _ = mamba.ssm_chunked(**x)
    da = x["dt"][..., None] * x["A"][None, None]
    bx = (x["dt"] * x["u"])[..., None] * x["B_"][:, :, None, :]
    want = ssm_scan_ref(da, bx, x["C_"]) + x["u"] * x["D"]
    _close(y.numpy(), want.numpy(), SSM_TOL)


@pytest.mark.parametrize("T", [32, 21])
def test_wkv_chunked_matches_the_kernels_plain_version(T):
    x = {n: torch.from_numpy(v) for n, v in
         _wkv_inputs(T, 7, zero_state=True).items()}
    y, _ = rwkv6.wkv_chunked(**x)
    want = wkv6_ref_bthk(x["r"], x["k"], x["v"], x["lw"], x["u"])
    _close(y.numpy(), want.numpy(), WKV_TOL)


def test_autograd_routes_take_the_chunked_scans():
    """``impl="autograd"`` routes ``ssm_core`` and ``wkv_core`` through the
    chunked scans (no registry call, so nothing reaches a kernel), and
    their outputs carry gradients."""
    x = {n: torch.from_numpy(v).requires_grad_(True)
         for n, v in _ssm_inputs(40, 3).items()}
    y, h = mamba.ssm_core(**x, impl="autograd")
    y2, h2 = mamba.ssm_chunked(**x)
    assert torch.equal(y, y2) and torch.equal(h, h2) and y.requires_grad
    w = {n: torch.from_numpy(v).requires_grad_(True)
         for n, v in _wkv_inputs(20, 3).items()}
    y, s = rwkv6.wkv_core(**w, impl="autograd")
    y2, s2 = rwkv6.wkv_chunked(**w)
    assert torch.equal(y, y2) and torch.equal(s, s2) and y.requires_grad


def test_strong_decay_keeps_the_wkv_gradient_finite():
    """Decays of -exp(3) a step over a 16-step chunk: the masked pairs are
    -inf before the exp, so no exp overflows and no gradient is NaN."""
    x = _wkv_inputs(32, 5)
    x["lw"] = np.full_like(x["lw"], -np.exp(3.0))
    leaves = {n: torch.from_numpy(v).requires_grad_(True)
              for n, v in x.items()}
    y, s = rwkv6.wkv_chunked(**leaves)
    grads = torch.autograd.grad(y.sum() + s.sum(), list(leaves.values()))
    assert all(torch.isfinite(g).all() for g in grads)
