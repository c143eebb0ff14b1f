"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and skip without one; the kernel has no CPU
mode. On the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

The file imports torch and the port only, so it runs where JAX is absent.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref_bshd

TOL = {"float32": 2e-6, "bfloat16": 2e-2, "float16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [
    (1, 512, 512, 12, 2, 128), (2, 128, 128, 4, 2, 16),
    (1, 200, 200, 8, 2, 64), (2, 33, 33, 4, 4, 16),
    # keys longer / shorter than the queries: the top-left causal limit
    # kpos <= qpos depends on both lengths
    (1, 100, 300, 12, 2, 128), (1, 300, 100, 12, 2, 128)])
def test_flash_attention_kernel_matches_plain_version(shape, causal, dtype,
                                                      cuda, rng):
    b, s, sk, h, hkv, d = shape
    q, k, v = (torch.from_numpy(rng.randn(*shp).astype(np.float32))
               .to(cuda, getattr(torch, dtype))
               for shp in ((b, s, h, d), (b, sk, hkv, d), (b, sk, hkv, d)))
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    want = attention_ref_bshd(q, k, v, causal=causal)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_flash_attention_kernel_refuses_mixed_dtypes(cuda):
    q = torch.zeros(1, 8, 2, 16, device=cuda)
    kv = torch.zeros(1, 8, 2, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one dtype"):
        ops.flash_attention(q, kv, kv)
