"""wkv6 in the port: its plain version against the JAX package's Pallas
kernel (interpret mode, as tests/test_kernels.py runs it) and against
``wkv6_ref``; the wrapper's contract, its CPU path and the registry route.
The CUDA kernel itself runs only on the card
(tests/test_torch_kernels_gpu.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.wkv6.ops import check_contract as jax_contract
from repro.kernels.wkv6.ops import wkv6 as jax_wkv6
from repro.kernels.wkv6.ref import wkv6_ref as jax_ref
from repro_torch.kernels import registry
from repro_torch.kernels.wkv6 import ops
from repro_torch.kernels.wkv6.ref import wkv6_ref, wkv6_ref_bthk

TOL = {"float32": 5e-4, "bfloat16": 3e-2}     # test_kernels.py:60, and
                                              # test_conformance.py:572

# (B, T, H, K, JAX chunk, u scale): the four shapes of test_kernels.py, a
# ragged T (37, prime) that no chunk but 37 tiles, and a large bonus u
SHAPES = {
    "k1": (2, 128, 2, 64, 64, 0.5),
    "k2": (1, 64, 4, 32, 16, 0.5),
    "k3": (2, 96, 1, 16, 32, 0.5),
    "k4": (1, 32, 2, 8, 8, 0.5),
    "ragged": (2, 37, 3, 16, 37, 0.5),
    "big_u": (1, 48, 2, 16, 16, 3.0),
}


def _inputs(rng, b, t, h, kk, u_scale=0.5):
    """As test_kernels.py::test_wkv6 draws them."""
    return (rng.randn(b, t, h, kk).astype(np.float32),
            (rng.randn(b, t, h, kk) * 0.3).astype(np.float32),
            rng.randn(b, t, h, kk).astype(np.float32),
            -np.exp(rng.randn(b, t, h, kk)).astype(np.float32),
            (rng.randn(h, kk) * u_scale).astype(np.float32))


def _fold(a):
    b, t, h, kk = a.shape
    return a.transpose(0, 2, 1, 3).reshape(b * h, t, kk)


def _jax_oracle(r, k, v, lw, u):
    """``wkv6_ref`` over the (B,T,H,K) layout, as test_kernels.py folds it."""
    b, t, h, kk = r.shape
    uf = jnp.broadcast_to(u[None], (b, h, kk)).reshape(b * h, kk)
    y = jax_ref(*(_fold(a) for a in (r, k, v, lw)), uf)
    return y.reshape(b, h, t, kk).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_version_matches_jax_kernel_and_ref(name, dtype, rng):
    b, t, h, kk, chunk, u_scale = SHAPES[name]
    arrays = _inputs(rng, b, t, h, kk, u_scale)
    jdt = getattr(jnp, dtype)
    jr, jk, jv, jlw = (jnp.asarray(a, jdt) for a in arrays[:4])
    ju = jnp.asarray(arrays[4])
    want_kernel = np.asarray(jax_wkv6(jr, jk, jv, jlw, ju, chunk=chunk),
                             np.float32)
    want_ref = np.asarray(_jax_oracle(jr, jk, jv, jlw, ju), np.float32)
    dt = getattr(torch, dtype)
    got = wkv6_ref_bthk(*(torch.from_numpy(a).to(dt) for a in arrays[:4]),
                        torch.from_numpy(arrays[4]))
    assert got.dtype == dt and tuple(got.shape) == (b, t, h, kk)
    tol = TOL[dtype]
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=tol)


def test_plain_version_in_the_folded_layout_matches_jax_ref(rng):
    r, k, v, lw, u = _inputs(rng, 2, 20, 3, 8)
    uf = np.broadcast_to(u[None], (2, 3, 8)).reshape(6, 8)
    args = [_fold(a) for a in (r, k, v, lw)] + [uf]
    got = wkv6_ref(*(torch.from_numpy(np.ascontiguousarray(a))
                     for a in args))
    want = np.asarray(jax_ref(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=5e-4)


def test_extreme_decay_stays_finite(rng):
    """lw = -80 (decay ~ 1.8e-35): the per-token form cannot overflow, as
    test_kernels.py::test_wkv6_extreme_decay_no_overflow holds the Pallas
    kernel; with u = 0, y_t = r_t . S_{t-1} and S forgets at once."""
    r, k, v, _, _ = _inputs(rng, 1, 64, 1, 16)
    lw = np.full_like(r, -80.0)
    u = np.zeros((1, 16), np.float32)
    got = ops.wkv6(*(torch.from_numpy(a) for a in (r, k, v, lw, u)))
    assert torch.isfinite(got).all()
    direct = np.zeros_like(r)
    direct[:, 1:] = (np.einsum("bthi,bthi->bth", r[:, 1:], k[:, :-1])[..., None]
                     * v[:, :-1])
    np.testing.assert_allclose(got.numpy(), direct, atol=1e-4, rtol=1e-4)


def test_no_decay_matches_the_jax_oracle_and_a_running_sum(rng):
    """lw = 0 keeps every step: S_t is the running sum of k v^T."""
    r, k, v, _, u = _inputs(rng, 2, 40, 2, 16)
    lw = np.zeros_like(r)
    got = ops.wkv6(*(torch.from_numpy(a) for a in (r, k, v, lw, u)))
    want = np.asarray(_jax_oracle(*(jnp.asarray(a) for a in
                                    (r, k, v, lw, u))))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=5e-4)
    kv = np.einsum("bthi,btho->bthio", k, v)
    s = np.cumsum(kv, axis=1) - kv                       # S_{t-1}
    direct = np.einsum("bthi,bthio->btho", r, s + u[None, None, :, :, None]
                       * kv)
    np.testing.assert_allclose(got.numpy(), direct, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("kk", ops.HEAD_SIZES)
def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing(kk, rng):
    args = [torch.from_numpy(a) for a in _inputs(rng, 2, 19, 3, kk)]
    before = ops.wkv6.launches
    got = ops.wkv6(*args)
    assert torch.equal(got, wkv6_ref_bthk(*args))
    assert got.is_contiguous()
    assert ops.wkv6.launches == before == 0


@pytest.mark.parametrize("impl", [None, "pallas", "ref"])
def test_registry_routes_to_the_wrapper_or_the_plain_version(impl, rng):
    args = [torch.from_numpy(a) for a in _inputs(rng, 1, 9, 2, 8)]
    got = registry.call("wkv6", *args, impl=impl)
    assert torch.equal(got, wkv6_ref_bthk(*args))
    assert registry.get("wkv6").kernel is ops.wkv6
    assert registry.get("wkv6").ref is wkv6_ref_bthk


def _bad_operands():
    z = np.zeros
    ok = z((1, 8, 2, 8))
    return {
        "rank_r": (z((1, 8, 16)), ok, ok, ok, z((2, 8))),
        "rank_lw": (ok, ok, ok, z((1, 8, 2, 8, 1)), z((2, 8))),
        "rank_u": (ok, ok, ok, ok, z((1, 2, 8))),
        "dtype_k": (ok, z((1, 8, 2, 8), np.int32), ok, ok, z((2, 8))),
        "dtype_u": (ok, ok, ok, ok, z((2, 8), np.int32)),
        "shape_v": (ok, ok, z((1, 8, 2, 4)), ok, z((2, 8))),
        "shape_u": (ok, ok, ok, ok, z((3, 8))),
        "zero_t": tuple([z((1, 0, 2, 8))] * 4) + (z((2, 8)),),
        "zero_h": tuple([z((1, 8, 0, 8))] * 4) + (z((0, 8)),),
        "zero_k": tuple([z((1, 8, 2, 0))] * 4) + (z((2, 0)),),
    }


@pytest.mark.parametrize("case", sorted(_bad_operands()))
def test_contract_raises_the_jax_errors(case):
    """The registry's contract (chunk=1, as the JAX registry applies it):
    the same ``ValueError`` text from both packages."""
    arrays = [a if a.dtype == np.int32 else a.astype(np.float32)
              for a in _bad_operands()[case]]
    with pytest.raises(ValueError) as theirs:
        jax_contract(*[jnp.asarray(a) for a in arrays], chunk=1)
    tensors = [torch.from_numpy(a) for a in arrays]
    with pytest.raises(ValueError) as ours:
        ops.wkv6(*tensors)
    # the same text, but a dtype is spelled the torch way ("torch.int32")
    assert str(ours.value).replace("torch.", "") == str(theirs.value)
    with pytest.raises(ValueError):
        registry.call("wkv6", *tensors, impl="ref")


@pytest.mark.parametrize("kk", [4, 12, 128])
def test_head_size_outside_the_kernel_templates_raises(kk, rng):
    args = [torch.from_numpy(a) for a in _inputs(rng, 1, 8, 2, kk)]
    with pytest.raises(ValueError, match=rf"K={kk} not supported.*"
                                         rf"\(8, 16, 32, 64\)"):
        ops.wkv6(*args)
    # the plain version takes any head size
    assert registry.call("wkv6", *args, impl="ref").shape == args[0].shape
