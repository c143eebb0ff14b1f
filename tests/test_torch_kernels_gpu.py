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
@pytest.mark.parametrize("b,s", [(2, 512), (2, 256), (1, 512), (1, 100),
                                 (1, 37)])
def test_flash_attention_kernel_at_the_engine_prefill_shapes(b, s, cuda,
                                                             rng):
    """The serving engine's prefill groups on qwen2-1.5B (12/2 heads,
    D = 128, bf16, causal): two prompts of one length in one launch, and
    ragged lengths off the kernel's 64-row and 128-key steps."""
    q, k, v = (torch.from_numpy(rng.randn(b, s, h, 128).astype(np.float32))
               .to(cuda, torch.bfloat16) for h in (12, 2, 2))
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = attention_ref_bshd(q, k, v, causal=True)
    tol = TOL["bfloat16"]
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


def _ssm_rowwise(da, bx, c):
    """The row-wise instance on the same operands (the port's first kernel,
    which the ring instance must equal bit for bit)."""
    b, _, di, n = da.shape
    return ss_ops.run_plan(da, bx, c, ss_ops.rowwise_plan(b, di, n))


def _ssm_check(da, bx, c, instance=None):
    """One wrapper call: the instance it took (``instance``, where given),
    the same bits as the row-wise instance, and the plain version within
    the dtype's tolerance. Returns the output."""
    if instance is not None:
        assert ss_ops.plan_of(da, bx, c).instance == instance
    before = ss_ops.ssm_scan.launches
    got = ss_ops.ssm_scan(da, bx, c)
    rowwise = _ssm_rowwise(da, bx, c)
    torch.cuda.synchronize()
    assert ss_ops.ssm_scan.launches == before + 1
    assert got.dtype == da.dtype and tuple(got.shape) == tuple(da.shape[:3])
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, rowwise)
    tol = SSM_TOL[str(da.dtype).removeprefix("torch.")]
    torch.testing.assert_close(got.float(), ssm_scan_ref(da, bx, c).float(),
                               atol=tol, rtol=tol)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", [
    (1, 512, 1600, 16),                     # the hybrid slice (hymba-1.5B)
    (1, 37, 100, 16),                       # ragged T, di not a multiple of 32
    (2, 64, 32, 4), (2, 24, 12, 4),         # N=4 (smoke configs), B=2
    (1, 128, 64, 8), (1, 64, 96, 32)])
def test_ssm_scan_kernel_matches_plain_version(shape, dtype, cuda, rng):
    """The wrapper's instance (the ring, or the row-wise one for bf16/f16
    rows of N = 4) equals the row-wise instance bit for bit and the plain
    version within tolerance."""
    da, bx, c = _ssm_inputs(rng, shape, dtype, None, cuda)
    ring = dtype == "float32" or shape[3] > 4
    _ssm_check(da, bx, c, ss_ops.RING if ring else ss_ops.ROWWISE)


@pytest.mark.gpu
@pytest.mark.parametrize("da_value", [0.0, -80.0])
def test_ssm_scan_kernel_at_identity_and_extreme_decay(da_value, cuda, rng):
    da, bx, c = _ssm_inputs(rng, (1, 64, 100, 16), "float32", da_value, cuda)
    _ssm_check(da, bx, c, ss_ops.RING)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 5, 15, 16, 17, 37, 100, 512, 4096])
def test_ssm_scan_ring_at_stage_edges(t, dtype, cuda, rng):
    """T = 1, below one stage (16 steps), either side of it, not a multiple
    of it, the slice's 512 and 4096 (the ring wraps many times)."""
    da, bx, c = _ssm_inputs(rng, (1, t, 100, 16), dtype, None, cuda)
    _ssm_check(da, bx, c, ss_ops.RING)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("n", ss_ops.STATE_SIZES)
def test_ssm_scan_ring_with_several_batches_and_ragged_lanes(n, dtype, cuda,
                                                             rng):
    """B = 3 and Di * N not a multiple of any ring width (Di = 101): the
    last block's idle channels, and stages that never straddle two
    sequences (T = 37)."""
    da, bx, c = _ssm_inputs(rng, (3, 37, 101, n), dtype, None, cuda)
    ring = dtype == "float32" or n > 4
    _ssm_check(da, bx, c, ss_ops.RING if ring else ss_ops.ROWWISE)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 512, 1600, 16), (2, 37, 101, 8),
                                   (1, 100, 40, 32), (1, 77, 30, 4)])
def test_ssm_scan_ring_plans_equal_the_rowwise_instance(shape, cuda, rng):
    """Every width the plan chooses from, stages of 16 and 32 steps and
    depths of 2 to 4, at fp32: the same bits as the row-wise instance. A
    depth of 3 against 32 stages wraps the ring with T/S not a multiple
    of D; a depth of 2 refills each slot right after it is read."""
    da, bx, c = _ssm_inputs(rng, shape, "float32", None, cuda)
    b, t, di, n = shape
    want = _ssm_rowwise(da, bx, c)
    assert ss_ops.plan_of(da, bx, c).instance == ss_ops.RING
    for w in ss_ops.RING_WIDTHS:
        for s in (max(16, n), 2 * max(16, n)):
            for depth in (2, 3, 4):
                plan = ss_ops.ring_plan(b, di, n, 4, w, s, depth)
                if plan.smem > ss_ops.SMEM_PER_BLOCK:
                    continue                # refused: see the test below
                got = ss_ops.run_plan(da, bx, c, plan)
                torch.cuda.synchronize()
                assert torch.equal(got, want), plan


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_ssm_scan_kernel_on_a_misaligned_view(dtype, cuda, rng):
    """da at a storage offset of one element: contiguous, but off the
    16-byte boundary the bulk copies need, so the row-wise instance runs,
    and matches."""
    shape = (1, 37, 100, 16)
    want_da, bx, c = _ssm_inputs(rng, shape, dtype, None, cuda)
    buf = torch.empty(1 + want_da.numel(), dtype=want_da.dtype, device=cuda)
    da = buf[1:].view(shape).copy_(want_da)
    assert da.is_contiguous() and da.data_ptr() % 16
    _ssm_check(da, bx, c, ss_ops.ROWWISE)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_ssm_scan_kernel_with_half_rows_of_n4_and_odd_di(dtype, cuda, rng):
    """bf16/f16, N = 4, Di odd: rows of 8 bytes, the row-wise instance."""
    da, bx, c = _ssm_inputs(rng, (2, 45, 33, 4), dtype, None, cuda)
    _ssm_check(da, bx, c, ss_ops.ROWWISE)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_kernel_is_deterministic(dtype, cuda, rng):
    """Two calls on the same inputs give the same bits: the served logits
    are held bit for bit against local runs."""
    da, bx, c = _ssm_inputs(rng, (1, 512, 1600, 16), dtype, None, cuda)
    first = ss_ops.ssm_scan(da, bx, c)
    second = ss_ops.ssm_scan(da, bx, c)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


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


@pytest.mark.gpu
def test_ssm_scan_ring_refuses_what_it_cannot_copy(cuda):
    """The C entry point refuses a misaligned base, rows of N = 4 in bf16
    and a plan past 227 KB of shared memory rather than misread."""
    z = torch.zeros(1, 40, 8, 16, device=cuda)
    c = torch.zeros(1, 40, 16, device=cuda)
    plan = ss_ops.ring_plan(1, 8, 16, 4, 64, 16, 2)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ss_ops.run_plan(torch.zeros(1 + z.numel(), device=cuda)[1:]
                        .view(z.shape), z, c, plan)
    too_big = ss_ops.ring_plan(1, 8, 16, 4, 128, 64, 4)
    assert too_big.smem > ss_ops.SMEM_PER_BLOCK
    with pytest.raises(RuntimeError, match="CUDA error"):
        ss_ops.run_plan(z, z, c, too_big)
    h = torch.zeros(1, 40, 8, 4, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ss_ops.run_plan(h, h, torch.zeros(1, 40, 4, device=cuda,
                                          dtype=torch.bfloat16),
                        ss_ops.ring_plan(1, 8, 4, 2, 64, 16, 2))


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


def _wkv6_check(rng, shape, dtype, cuda, lw_value=None):
    """One wrapper call against the plain version, at the tolerance of
    test_wkv6_kernel_matches_plain_version; returns the output."""
    r, k, v, lw, u = _wkv6_inputs(rng, shape, dtype, cuda, lw_value)
    got = wk_ops.wkv6(r, k, v, lw, u)
    torch.cuda.synchronize()
    assert got.dtype == r.dtype and tuple(got.shape) == shape
    assert torch.isfinite(got).all()
    want = wkv6_ref_bthk(r, k, v, lw, u).float()
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=5e-4, rtol=5e-4)
    else:
        tol = WKV_TOL[dtype] * want.abs().max().item()
        torch.testing.assert_close(got.float(), want, atol=tol, rtol=0)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 15, 16, 17, 63, 64, 65, 127, 128, 129,
                               511, 512, 513, 1024, 4096])
def test_wkv6_kernel_at_chunk_and_sub_chunk_edges(t, dtype, cuda, rng):
    """T at each sub-chunk (16) and chunk (64) edge and either side of it;
    T = 4096 (64 chunks) is past the in-block cap, so the carry kernel
    builds the entering states."""
    _wkv6_check(rng, (1, t, 4, 64), dtype, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("kk", wk_ops.HEAD_SIZES)
def test_wkv6_kernel_at_each_head_size(kk, cuda, rng):
    _wkv6_check(rng, (2, 130, 3, kk), "float32", cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("lw_value", [-80.0, 0.0])
def test_wkv6_kernel_at_edge_decays_across_chunks(lw_value, cuda, rng):
    """lw = -80 (finite, every chunk and sub-chunk edge crossed) and lw = 0
    (S the running sum over four chunks)."""
    _wkv6_check(rng, (1, 200, 4, 64), "float32", cuda, lw_value)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_kernel_with_several_batches_and_odd_heads(dtype, cuda, rng):
    _wkv6_check(rng, (3, 150, 5, 64), dtype, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [512, 4096])
def test_wkv6_kernel_is_deterministic_and_counts_calls(t, cuda, rng):
    """The same bits from two calls (no atomics, fixed orders), and
    ``wkv6.launches`` moves by one a call, two or three kernels each."""
    args = _wkv6_inputs(rng, (1, t, 32, 64), "float32", cuda)
    before = wk_ops.wkv6.launches
    first = wk_ops.wkv6(*args)
    assert wk_ops.wkv6.launches == before + 1
    second = wk_ops.wkv6(*args)
    torch.cuda.synchronize()
    assert wk_ops.wkv6.launches == before + 2
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_wkv6_kernel_on_a_misaligned_view(cuda, rng):
    """An operand at a 4-byte offset from a 16-byte boundary is copied
    before the 16-byte cp.async staging; the result is the aligned one's."""
    r, k, v, lw, u = _wkv6_inputs(rng, (1, 100, 2, 16), "float32", cuda)
    buf = torch.empty(r.numel() + 1, device=cuda)
    shifted = buf[1:].view(r.shape)
    shifted.copy_(r)
    assert shifted.data_ptr() % 16 != 0
    want = wk_ops.wkv6(r, k, v, lw, u)
    got = wk_ops.wkv6(shifted, k, v, lw, u)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("operand", ["q", "k", "v"])
def test_flash_attention_kernel_copies_a_misaligned_operand(operand, dtype,
                                                            cuda, rng):
    """An operand at a storage offset of one element is copied into an
    aligned buffer and runs through the same hand kernel (one launch)."""
    dt = getattr(torch, dtype)
    shapes = {"q": (1, 100, 4, 64), "k": (1, 100, 2, 64),
              "v": (1, 100, 2, 64)}
    args = {}
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        buf = torch.from_numpy(rng.randn(1 + n).astype(np.float32)).to(cuda,
                                                                       dt)
        args[name] = (buf[1:].view(shape) if name == operand
                      else buf[:n].view(shape))
    assert args[operand].data_ptr() % 16
    before = ops.flash_attention.launches
    got = ops.flash_attention(args["q"], args["k"], args["v"])
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    torch.testing.assert_close(
        got.float(), attention_ref_bshd(args["q"], args["k"],
                                        args["v"]).float(),
        atol=TOL[dtype], rtol=TOL[dtype])


def _int8_case(rng, cuda, m, k, n, out_dtype):
    """The kernel and the plain version on one random (m, k, n) case."""
    x, w = _int8(rng, m, k).to(cuda), _int8(rng, k, n).to(cuda)
    scale = torch.from_numpy(rng.rand(n).astype(np.float32)).to(cuda)
    if out_dtype == "int32":
        return i8_ops.int8_matmul_i32(x, w), int8_matmul_i32_ref(x, w)
    dt = getattr(torch, out_dtype)
    return (i8_ops.int8_matmul(x, w, scale, dt),
            int8_matmul_ref(x, w, scale, dt))


# the tile and fragment edges: m16/n8/k32 fragments, 64-row and 64-column
# warp and block tiles, 64-deep k steps, and one past each
EDGES = (1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129)
EDGE_BASE = {"m": 65, "k": 97, "n": 33}


@pytest.mark.gpu
@pytest.mark.parametrize("dim,value",
                         [(d, v) for d in ("m", "k", "n") for v in EDGES]
                         + [("k", 147), ("k", 4097)])
def test_int8_matmul_kernel_at_tile_and_fragment_edges(dim, value, cuda,
                                                       rng):
    """One of M, K, N at an edge, the others ragged; every epilogue, bit
    for bit."""
    mkn = {**EDGE_BASE, dim: value}
    for out_dtype in ("int32", "float32", "bfloat16", "float16"):
        got, want = _int8_case(rng, cuda, mkn["m"], mkn["k"], mkn["n"],
                               out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype, out_dtype
        assert torch.equal(got, want), (mkn, out_dtype)


# every CONV2D_I8 GEMM of ResNet-18 at 224 px, B=1, as (M, K, N)
RESNET18_GEMMS = [(12544, 147, 64), (3136, 576, 64), (784, 576, 128),
                  (784, 64, 128), (784, 1152, 128), (196, 1152, 256),
                  (196, 128, 256), (196, 2304, 256), (49, 2304, 512),
                  (49, 256, 512), (49, 4608, 512)]


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", ["int32", "float32", "bfloat16",
                                       "float16"])
@pytest.mark.parametrize("mkn", RESNET18_GEMMS)
def test_int8_matmul_kernel_at_every_resnet18_gemm(mkn, out_dtype, cuda,
                                                   rng):
    got, want = _int8_case(rng, cuda, *mkn, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("value", [127, -127, -128])
def test_int8_matmul_kernel_at_extreme_values_in_16_bit_outputs(
        value, out_dtype, cuda, rng):
    """The extremes at 49 x 4608 x 512 (K split) through the 16-bit
    epilogues, which round the sums past 2^24 once."""
    x = _int8(rng, 49, 4608, extreme=value).to(cuda)
    w = _int8(rng, 4608, 512, extreme=-127 if value < 0 else 127).to(cuda)
    scale = torch.from_numpy(rng.rand(512).astype(np.float32)).to(cuda)
    dt = getattr(torch, out_dtype)
    assert torch.equal(i8_ops.int8_matmul(x, w, scale, dt),
                       int8_matmul_ref(x, w, scale, dt))


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", ["int32", "float32", "bfloat16",
                                       "float16"])
def test_int8_matmul_kernel_on_a_misaligned_x(out_dtype, cuda, rng):
    """x at a storage offset of one byte: the byte-load instance."""
    m, k, n = 196, 1152, 256
    buf = _int8(rng, 1 + m * k).to(cuda)
    x = buf[1:].view(m, k)
    assert x.data_ptr() % 16
    w = _int8(rng, k, n).to(cuda)
    scale = torch.from_numpy(rng.rand(n).astype(np.float32)).to(cuda)
    if out_dtype == "int32":
        got, want = i8_ops.int8_matmul_i32(x, w), int8_matmul_i32_ref(x, w)
    else:
        dt = getattr(torch, out_dtype)
        got = i8_ops.int8_matmul(x, w, scale, dt)
        want = int8_matmul_ref(x, w, scale, dt)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", ["int32", "float32"])
def test_int8_matmul_kernel_split_k_is_deterministic(out_dtype, cuda, rng):
    """A split K (49 x 4608 x 512: the sums meet in int32 atomics) launched
    twice gives the same bits, equal to the plain version."""
    m, k, n = 49, 4608, 512
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert i8_ops.splits_for(m, n, k, sms) > 1
    x, w = _int8(rng, m, k).to(cuda), _int8(rng, k, n).to(cuda)
    scale = torch.from_numpy(rng.rand(n).astype(np.float32)).to(cuda)
    if out_dtype == "int32":
        runs = [i8_ops.int8_matmul_i32(x, w) for _ in range(2)]
        want = int8_matmul_i32_ref(x, w)
    else:
        runs = [i8_ops.int8_matmul(x, w, scale) for _ in range(2)]
        want = int8_matmul_ref(x, w, scale)
    assert torch.equal(runs[0].view(torch.int32), runs[1].view(torch.int32))
    assert torch.equal(runs[0], want)
