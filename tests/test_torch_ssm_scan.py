"""ssm_scan in the port: its plain version against the JAX package's Pallas
kernel (interpret mode, as tests/test_kernels.py runs it) and against
``ssm_scan_ref``; the wrapper's contract, its CPU path and the registry
route. The CUDA kernel itself runs only on the card
(tests/test_torch_kernels_gpu.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.ssm_scan.ops import check_contract as jax_contract
from repro.kernels.ssm_scan.ops import ssm_scan as jax_ssm_scan
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_ref
from repro_torch.kernels import registry
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}        # tests/test_kernels.py:88

# (B, T, di, N, JAX chunk, JAX d_block): the three shapes of
# test_kernels.py, a ragged T (37, prime) with di not a multiple of 32, and
# N=4 (the smoke configs' state) at a T no JAX tiling pads
SHAPES = {
    "k1": (2, 64, 32, 8, 16, 16),
    "k2": (1, 32, 64, 16, 8, 32),
    "k3": (1, 128, 16, 4, 32, 16),
    "ragged": (1, 37, 20, 16, 37, 20),
    "n4": (2, 24, 12, 4, 8, 12),
}


def _inputs(rng, b, t, di, n):
    da = -np.exp(rng.randn(b, t, di, n)).astype(np.float32)
    return (da, rng.randn(b, t, di, n).astype(np.float32),
            rng.randn(b, t, n).astype(np.float32))


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_version_matches_jax_kernel_and_ref(name, dtype, rng):
    b, t, di, n, chunk, d_block = SHAPES[name]
    arrays = _inputs(rng, b, t, di, n)
    jda, jbx, jc = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrays)
    want_kernel = np.asarray(jax_ssm_scan(jda, jbx, jc, chunk=chunk,
                                          d_block=d_block), np.float32)
    want_ref = np.asarray(jax_ref(jda, jbx, jc), np.float32)
    got = ssm_scan_ref(*(_torch(a, dtype) for a in arrays))
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (b, t, di)
    tol = TOL[dtype]
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("da_value", [0.0, -80.0])
def test_plain_version_at_identity_and_extreme_decay(da_value, rng):
    """da = 0 keeps the whole sum (h is a running sum of bx); da = -80
    forgets at once (y_t = sum_n bx_t c_t) and stays finite."""
    b, t, di, n = 1, 40, 8, 16
    _, bx, c = _inputs(rng, b, t, di, n)
    da = np.full((b, t, di, n), da_value, np.float32)
    got = ssm_scan_ref(*(torch.from_numpy(a) for a in (da, bx, c)))
    assert torch.isfinite(got).all()
    want = np.asarray(jax_ref(jnp.asarray(da), jnp.asarray(bx),
                              jnp.asarray(c)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    if da_value == 0.0:
        direct = np.einsum("btdn,btn->btd", np.cumsum(bx, axis=1), c)
    else:
        direct = np.einsum("btdn,btn->btd", bx, c)
    np.testing.assert_allclose(got.numpy(), direct, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n", ops.STATE_SIZES)
def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing(n, rng):
    da, bx, c = (torch.from_numpy(a) for a in _inputs(rng, 2, 19, 6, n))
    before = ops.ssm_scan.launches
    got = ops.ssm_scan(da, bx, c)
    assert torch.equal(got, ssm_scan_ref(da, bx, c))
    assert ops.ssm_scan.launches == before == 0


@pytest.mark.parametrize("impl", [None, "pallas", "ref"])
def test_registry_routes_to_the_wrapper_or_the_plain_version(impl, rng):
    da, bx, c = (torch.from_numpy(a) for a in _inputs(rng, 1, 9, 5, 4))
    got = registry.call("ssm_scan", da, bx, c, impl=impl)
    assert torch.equal(got, ssm_scan_ref(da, bx, c))
    assert registry.get("ssm_scan").kernel is ops.ssm_scan


def _bad_operands():
    z = np.zeros
    return {
        "rank_da": (z((2, 8, 16)), z((2, 8, 16)), z((2, 8, 4))),
        "rank_c": (z((1, 8, 6, 4)), z((1, 8, 6, 4)), z((1, 8, 4, 1))),
        "dtype": (z((1, 8, 6, 4), np.int32), z((1, 8, 6, 4)), z((1, 8, 4))),
        "bx_shape": (z((1, 8, 6, 4)), z((1, 8, 5, 4)), z((1, 8, 4))),
        "c_shape": (z((1, 8, 6, 4)), z((1, 8, 6, 4)), z((1, 7, 4))),
        "zero_t": (z((1, 0, 6, 4)), z((1, 0, 6, 4)), z((1, 0, 4))),
        "zero_di": (z((1, 8, 0, 4)), z((1, 8, 0, 4)), z((1, 8, 4))),
        "zero_n": (z((1, 8, 6, 0)), z((1, 8, 6, 0)), z((1, 8, 0))),
    }


@pytest.mark.parametrize("case", sorted(_bad_operands()))
def test_contract_raises_the_jax_errors(case):
    """The registry's contract (chunk=1, d_block=1, as the JAX registry
    applies it): the same ``ValueError`` text from both packages."""
    arrays = [a if a.dtype == np.int32 else a.astype(np.float32)
              for a in _bad_operands()[case]]
    with pytest.raises(ValueError) as theirs:
        jax_contract(*[jnp.asarray(a) for a in arrays], chunk=1, d_block=1)
    tensors = [torch.from_numpy(a) for a in arrays]
    with pytest.raises(ValueError) as ours:
        ops.ssm_scan(*tensors)
    # the same text, but a dtype is spelled the torch way ("torch.int32")
    assert str(ours.value).replace("torch.", "") == str(theirs.value)
    with pytest.raises(ValueError):
        registry.call("ssm_scan", *tensors, impl="ref")


@pytest.mark.parametrize("n", [2, 6, 64])
def test_state_size_outside_the_kernel_templates_raises(n, rng):
    da, bx, c = (torch.from_numpy(a) for a in _inputs(rng, 1, 8, 4, n))
    with pytest.raises(ValueError, match=rf"N={n} not supported.*"
                                         rf"\(4, 8, 16, 32\)"):
        ops.ssm_scan(da, bx, c)
