"""flash_attention in the port: its plain version against the JAX package's
Pallas kernel (interpret mode, as tests/test_kernels.py runs it) and against
``attention_ref``; the wrapper's contract and its CPU path. The CUDA kernel
itself runs only on the card (tests/test_torch_kernels_gpu.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention.ops import check_contract as jax_contract
from repro.kernels.flash_attention.ops import flash_attention as jax_fa
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref_bshd

TOL = {"float32": 2e-6, "bfloat16": 2e-2}        # tests/test_kernels.py:35

# (B, S, H, Hkv, D, causal, JAX block): the four shapes of test_kernels.py,
# a ragged S (not a multiple of the CUDA kernel's 32/64 tiles) and two
# non-causal cases
SHAPES = {
    "k1": (1, 128, 2, 2, 32, True, 64),
    "k2": (2, 64, 4, 2, 64, True, 64),
    "k3": (1, 256, 2, 1, 16, True, 64),
    "k4": (2, 128, 6, 3, 8, True, 64),
    "ragged": (1, 72, 4, 2, 16, True, 24),
    "full": (2, 64, 4, 2, 16, False, 32),
    "full_ragged": (1, 40, 4, 1, 64, False, 40),
}


def _inputs(rng, b, s, h, hkv, d):
    return (rng.randn(b, s, h, d).astype(np.float32),
            rng.randn(b, s, hkv, d).astype(np.float32),
            rng.randn(b, s, hkv, d).astype(np.float32))


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _jax_ref_bshd(q, k, v, causal):
    b, s, h, d = q.shape
    hkv = k.shape[2]
    t = lambda a, n: a.transpose(0, 2, 1, 3).reshape(b * n, s, d)
    o = jax_ref(t(q, h), t(k, hkv), t(v, hkv), group=h // hkv, causal=causal)
    return o.reshape(b, h, s, d).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_version_matches_jax_kernel_and_ref(name, dtype, rng):
    b, s, h, hkv, d, causal, block = SHAPES[name]
    q, k, v = _inputs(rng, b, s, h, hkv, d)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    want_kernel = np.asarray(jax_fa(jq, jk, jv, causal=causal, block_q=block,
                                    block_k=block), np.float32)
    want_ref = np.asarray(_jax_ref_bshd(jq, jk, jv, causal), np.float32)
    got = attention_ref_bshd(_torch(q, dtype), _torch(k, dtype),
                             _torch(v, dtype), causal=causal)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (b, s, h, d)
    tol = TOL[dtype]
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", ops.HEAD_DIMS)
def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing(d, causal,
                                                                   rng):
    q, k, v = (torch.from_numpy(a) for a in _inputs(rng, 1, 40, 4, 2, d))
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    assert torch.equal(got, attention_ref_bshd(q, k, v, causal=causal))
    assert ops.flash_attention.launches == before == 0


def _bad_operands():
    z = np.zeros
    return {
        "rank": (z((2, 8, 16)), z((2, 8, 2, 16)), z((2, 8, 2, 16))),
        "dtype": (z((1, 8, 2, 16), np.int32), z((1, 8, 2, 16)),
                  z((1, 8, 2, 16))),
        "kv_shapes": (z((1, 8, 4, 16)), z((1, 8, 2, 16)), z((1, 9, 2, 16))),
        "batch": (z((2, 8, 4, 16)), z((1, 8, 2, 16)), z((1, 8, 2, 16))),
        "head_dim": (z((1, 8, 4, 16)), z((1, 8, 2, 8)), z((1, 8, 2, 8))),
        "gqa": (z((1, 8, 4, 16)), z((1, 8, 3, 16)), z((1, 8, 3, 16))),
        "zero_kv": (z((1, 8, 4, 16)), z((1, 0, 2, 16)), z((1, 0, 2, 16))),
        "zero_q": (z((1, 0, 4, 16)), z((1, 8, 2, 16)), z((1, 8, 2, 16))),
    }


@pytest.mark.parametrize("case", sorted(_bad_operands()))
def test_contract_raises_the_jax_errors(case):
    arrays = _bad_operands()[case]
    with pytest.raises(ValueError) as theirs:
        jax_contract(*[jnp.asarray(a, a.dtype if a.dtype == np.int32
                                   else jnp.float32) for a in arrays])
    tensors = [torch.from_numpy(a.astype(a.dtype if a.dtype == np.int32
                                         else np.float32)) for a in arrays]
    with pytest.raises(ValueError) as ours:
        ops.flash_attention(*tensors)
    # the same text, but a dtype is spelled the torch way ("torch.int32")
    assert str(ours.value).replace("torch.", "") == str(theirs.value)


def test_head_dim_outside_the_kernel_templates_raises(rng):
    q, k, v = (torch.from_numpy(a) for a in _inputs(rng, 1, 8, 2, 2, 32))
    with pytest.raises(ValueError, match="head_dim 32 not supported"):
        ops.flash_attention(q, k, v)


@pytest.mark.parametrize("offset", [0, 1, 8])
def test_alignment_check_of_the_16_bit_kernel(offset):
    """The bf16/f16 kernel loads 16-byte rows: an operand that starts off a
    16-byte boundary (a contiguous view at an odd storage offset) raises
    before any launch."""
    shape = (1, 8, 2, 16)
    buf = torch.zeros(offset + int(np.prod(shape)), dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    q = buf[offset:].view(shape)
    kv = torch.zeros(shape, dtype=torch.bfloat16)
    if offset * buf.element_size() % 16:
        with pytest.raises(ValueError, match="16-byte"):
            ops.check_alignment(q, kv, kv)
    else:
        ops.check_alignment(q, kv, kv)
