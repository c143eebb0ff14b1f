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
from repro_torch.kernels.int8_matmul import ops as i8_ops
from repro_torch.kernels.int8_matmul.ref import (int8_matmul_i32_ref,
                                                 int8_matmul_ref)
from repro_torch.kernels.ssm_scan import ops as ss_ops
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.kernels.wkv6 import ops as wk_ops
from repro_torch.kernels.wkv6.ref import wkv6_ref_bthk

TOL = {"float32": 2e-6, "bfloat16": 2e-2, "float16": 2e-2}
SSM_TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2e-2}
WKV_TOL = {"float32": 5e-4, "bfloat16": 3e-2, "float16": 3e-2}


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
    (1, 512, 512, 25, 5, 64),               # the hybrid slice (hymba-1.5B)
    # keys longer / shorter than the queries: the top-left causal limit
    # kpos <= qpos depends on both lengths
    (1, 100, 300, 12, 2, 128), (1, 300, 100, 12, 2, 128),
    # S or Sk at the 64-row/64-key tile boundaries and one past them
    (1, 1, 1, 4, 2, 64), (1, 63, 63, 4, 2, 128), (1, 64, 64, 4, 2, 64),
    (1, 65, 65, 4, 2, 16), (1, 127, 129, 4, 2, 128), (1, 129, 127, 4, 2, 64),
    (1, 1, 129, 4, 2, 128), (1, 129, 1, 4, 2, 16), (1, 64, 65, 4, 1, 128),
    # a 7th entry scales q: scores near +-100 drive the running max and
    # the rounding of p to the value dtype
    (1, 512, 512, 12, 2, 128, 30.0), (1, 129, 127, 25, 5, 64, 30.0)])
def test_flash_attention_kernel_matches_plain_version(shape, causal, dtype,
                                                      cuda, rng):
    b, s, sk, h, hkv, d = shape[:6]
    q_scale = shape[6] if len(shape) > 6 else 1.0
    q, k, v = (torch.from_numpy(rng.randn(*shp).astype(np.float32))
               .to(cuda, getattr(torch, dtype))
               for shp in ((b, s, h, d), (b, sk, hkv, d), (b, sk, hkv, d)))
    q = (q.float() * q_scale).to(q.dtype)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    want = attention_ref_bshd(q, k, v, causal=causal)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_attention_kernel_is_deterministic(dtype, cuda, rng):
    """Two launches on the same inputs give the same bits: the served logits
    are held bit for bit against local runs."""
    q, k, v = (torch.from_numpy(rng.randn(*shp).astype(np.float32))
               .to(cuda, getattr(torch, dtype))
               for shp in ((1, 200, 12, 128), (1, 200, 2, 128),
                           (1, 200, 2, 128)))
    first = ops.flash_attention(q, k, v)
    second = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_attention_kernel_on_a_misaligned_view(dtype, cuda, rng):
    """q at a storage offset of one element: the wrapper either computes
    the right answer or raises ValueError; it never misreads."""
    shape = (1, 100, 4, 64)
    buf = torch.from_numpy(rng.randn(1 + int(np.prod(shape)))
                           .astype(np.float32)).to(cuda, getattr(torch, dtype))
    q = buf[1:].view(shape)
    k, v = (torch.from_numpy(rng.randn(1, 100, 2, 64).astype(np.float32))
            .to(cuda, getattr(torch, dtype)) for _ in range(2))
    try:
        got = ops.flash_attention(q, k, v)
    except ValueError as e:
        assert "16-byte" in str(e)
        return
    torch.testing.assert_close(
        got.float(), attention_ref_bshd(q, k, v).float(), atol=TOL[dtype],
        rtol=TOL[dtype])


@pytest.mark.gpu
def test_flash_attention_kernel_refuses_mixed_dtypes(cuda):
    q = torch.zeros(1, 8, 2, 16, device=cuda)
    kv = torch.zeros(1, 8, 2, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one dtype"):
        ops.flash_attention(q, kv, kv)


def _ssm_inputs(rng, shape, dtype, da_value, cuda):
    b, t, di, n = shape
    da = (-np.exp(rng.randn(b, t, di, n)) if da_value is None
          else np.full((b, t, di, n), da_value))
    return [torch.from_numpy(a.astype(np.float32)).to(cuda,
                                                      getattr(torch, dtype))
            for a in (da, rng.randn(b, t, di, n), rng.randn(b, t, n))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", [
    (1, 512, 1600, 16),                     # the hybrid slice (hymba-1.5B)
    (1, 37, 100, 16),                       # ragged T, di not a multiple of 32
    (2, 64, 32, 4), (2, 24, 12, 4),         # N=4 (smoke configs), B=2
    (1, 128, 64, 8), (1, 64, 96, 32)])
def test_ssm_scan_kernel_matches_plain_version(shape, dtype, cuda, rng):
    da, bx, c = _ssm_inputs(rng, shape, dtype, None, cuda)
    before = ss_ops.ssm_scan.launches
    got = ss_ops.ssm_scan(da, bx, c)
    torch.cuda.synchronize()
    assert ss_ops.ssm_scan.launches == before + 1
    assert got.dtype == da.dtype and tuple(got.shape) == shape[:3]
    tol = SSM_TOL[dtype]
    torch.testing.assert_close(got.float(), ssm_scan_ref(da, bx, c).float(),
                               atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("da_value", [0.0, -80.0])
def test_ssm_scan_kernel_at_identity_and_extreme_decay(da_value, cuda, rng):
    da, bx, c = _ssm_inputs(rng, (1, 64, 100, 16), "float32", da_value, cuda)
    got = ss_ops.ssm_scan(da, bx, c)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ssm_scan_ref(da, bx, c), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.gpu
def test_ssm_scan_kernel_refuses_unsupported_state_size_and_mixed_dtypes(
        cuda):
    z = torch.zeros(1, 8, 4, 6, device=cuda)
    with pytest.raises(ValueError, match=r"N=6 not supported"):
        ss_ops.ssm_scan(z, z, torch.zeros(1, 8, 6, device=cuda))
    z = torch.zeros(1, 8, 4, 16, device=cuda)
    with pytest.raises(ValueError, match="one dtype"):
        ss_ops.ssm_scan(z, z, torch.zeros(1, 8, 16, device=cuda,
                                          dtype=torch.bfloat16))


def _wkv6_inputs(rng, shape, dtype, cuda, lw_value=None, u_scale=0.5):
    """r, k, v, lw (B,T,H,K) in ``dtype`` and u (H,K) fp32, drawn as
    tests/test_kernels.py::test_wkv6 draws them."""
    b, t, h, kk = shape
    lw = (-np.exp(rng.randn(b, t, h, kk)) if lw_value is None
          else np.full((b, t, h, kk), lw_value))
    dt = getattr(torch, dtype)
    rkvl = [torch.from_numpy(a.astype(np.float32)).to(cuda, dt)
            for a in (rng.randn(b, t, h, kk), 0.3 * rng.randn(b, t, h, kk),
                      rng.randn(b, t, h, kk), lw)]
    u = torch.from_numpy((u_scale * rng.randn(h, kk)).astype(np.float32))
    return rkvl + [u.to(cuda)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", [
    (1, 512, 32, 64),                       # the ssm slice (rwkv6-1.6B)
    (2, 37, 3, 16),                         # ragged T, H=3, the smoke K
    (1, 64, 4, 8), (1, 64, 4, 32),          # K = 8 and 32
    (2, 128, 2, 64), (2, 13, 2, 16)])
def test_wkv6_kernel_matches_plain_version(shape, dtype, cuda, rng):
    r, k, v, lw, u = _wkv6_inputs(rng, shape, dtype, cuda)
    before = wk_ops.wkv6.launches
    got = wk_ops.wkv6(r, k, v, lw, u)
    torch.cuda.synchronize()
    assert wk_ops.wkv6.launches == before + 1
    assert got.dtype == r.dtype and tuple(got.shape) == shape
    want = wkv6_ref_bthk(r, k, v, lw, u).float()
    # bf16/f16: relative to the output's scale (test_conformance.py:572)
    tol = WKV_TOL[dtype] * (1.0 if dtype == "float32"
                            else want.abs().max().item())
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["no_decay", "extreme_decay", "zero_u"])
def test_wkv6_kernel_at_edge_decays_and_zero_bonus(case, cuda, rng):
    """lw = 0 (S a running sum), lw = -80 (finite: decay 1.8e-35), u = 0."""
    lw_value = {"no_decay": 0.0, "extreme_decay": -80.0}.get(case)
    r, k, v, lw, u = _wkv6_inputs(rng, (1, 64, 4, 16), "float32", cuda,
                                  lw_value, 0.0 if case == "zero_u" else 0.5)
    got = wk_ops.wkv6(r, k, v, lw, u)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, wkv6_ref_bthk(r, k, v, lw, u),
                               atol=5e-4, rtol=5e-4)


@pytest.mark.gpu
def test_wkv6_kernel_refuses_unsupported_head_size_and_mixed_dtypes(cuda):
    z = torch.zeros(1, 8, 2, 12, device=cuda)
    with pytest.raises(ValueError, match=r"K=12 not supported"):
        wk_ops.wkv6(z, z, z, z, torch.zeros(2, 12, device=cuda))
    z = torch.zeros(1, 8, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="one dtype"):
        wk_ops.wkv6(z, z, z.bfloat16(), z, torch.zeros(2, 16, device=cuda))


def _int8(rng, *shape, extreme=None):
    a = (np.full(shape, extreme) if extreme is not None
         else rng.randint(-127, 128, shape))
    return torch.from_numpy(a.astype(np.int8))


# (M, K, N): ResNet-18's CONV2D_I8 GEMMs at B=1 (stem, the stages' 3x3 and
# 1x1/2 convs, the largest K), qwen2-1.5B's MLP at S=512 cut in N, and
# ragged shapes that no tile divides, K = 1 and M = 1
INT8_SHAPES = [(12544, 147, 64), (3136, 576, 64), (784, 1152, 128),
               (196, 128, 256), (49, 4608, 512), (512, 1536, 896),
               (129, 33, 131), (77, 1, 5), (1, 300, 257), (200, 37, 1),
               (17, 4097, 19)]


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", ["int32", "float32", "bfloat16",
                                       "float16"])
@pytest.mark.parametrize("mkn", INT8_SHAPES)
def test_int8_matmul_kernel_equals_plain_version_bit_for_bit(mkn, out_dtype,
                                                             cuda, rng):
    m, k, n = mkn
    x, w = _int8(rng, m, k).to(cuda), _int8(rng, k, n).to(cuda)
    scale = torch.from_numpy(rng.rand(n).astype(np.float32)).to(cuda)
    before = i8_ops.int8_matmul.launches
    if out_dtype == "int32":
        got = i8_ops.int8_matmul_i32(x, w)
        want = int8_matmul_i32_ref(x, w)
    else:
        dt = getattr(torch, out_dtype)
        got = i8_ops.int8_matmul(x, w, scale, dt)
        want = int8_matmul_ref(x, w, scale, dt)
    torch.cuda.synchronize()
    assert i8_ops.int8_matmul.launches == before + 1
    assert got.dtype == want.dtype and tuple(got.shape) == (m, n)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("value", [127, -127, -128])
def test_int8_matmul_kernel_at_extreme_values(value, cuda, rng):
    """All operands at one extreme, K = 4608 (ResNet-18's largest): the
    sums reach 127 * 127 * 4608 = 74,322,432, past fp32's 2^24."""
    x = _int8(rng, 49, 4608, extreme=value).to(cuda)
    w = _int8(rng, 4608, 512, extreme=-127 if value < 0 else 127).to(cuda)
    got = i8_ops.int8_matmul_i32(x, w)
    want = torch.full((49, 512), abs(value) * 127 * 4608, dtype=torch.int32,
                      device=cuda)
    assert torch.equal(got, want)
    scale = torch.full((512,), 0.5, device=cuda)
    assert torch.equal(i8_ops.int8_matmul(x, w, scale),
                       int8_matmul_ref(x, w, scale))


@pytest.mark.gpu
def test_int8_matmul_kernel_on_strided_views(cuda, rng):
    """Non-contiguous operands are copied to contiguous ones first."""
    x = _int8(rng, 64, 96).to(cuda)[:, ::2]
    w = _int8(rng, 96, 48).to(cuda).t()              # (48, 96)
    assert torch.equal(i8_ops.int8_matmul_i32(x, w),
                       int8_matmul_i32_ref(x, w))


@pytest.mark.gpu
def test_int8_matmul_kernel_refuses_mixed_devices_and_dtypes(cuda):
    x = torch.zeros(4, 8, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="several devices"):
        i8_ops.int8_matmul_i32(x, torch.zeros(8, 4, dtype=torch.int8))
    with pytest.raises(ValueError, match="must be int8"):
        i8_ops.int8_matmul_i32(x, torch.zeros(8, 4, device=cuda))
    with pytest.raises(ValueError, match="unsupported out_dtype"):
        i8_ops.int8_matmul(x, x.t().contiguous(),
                           torch.ones(4, device=cuda), torch.int32)
