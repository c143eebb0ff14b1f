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


# --- the CUDA kernel's plan and its ring, on the CPU ----------------------

PLAN_SHAPES = [(1, 512, 1600, 16), (1, 37, 100, 16), (3, 37, 101, 16),
               (2, 64, 32, 4), (2, 24, 12, 4), (1, 128, 64, 8),
               (1, 64, 96, 32), (1, 1, 100, 16), (1, 4096, 100, 16),
               (64, 512, 1600, 16), (2, 45, 33, 4)]
HALF = (torch.bfloat16, torch.float16)
SMEM_PER_SM = 233472          # an H100 SM's 228 KB of shared memory
SMEM_RESERVED = 1024          # the system's share of each block


@pytest.mark.parametrize("sms", [132, 4])
@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_fits_shared_memory_and_covers_every_lane_once(shape, dtype,
                                                            sms):
    b, t, di, n = shape
    plan = ops.plan_for(b, di, n, dtype, sms)
    if plan.instance == ops.ROWWISE:
        assert dtype in HALF and n == 4
        return
    lanes = di * n
    assert plan.w in ops.RING_WIDTHS and plan.w % n == 0
    assert plan.s >= n and plan.s % n == 0
    assert (plan.s, plan.d) == (ops.STAGE_STEPS, ops.DEPTH)
    assert plan.smem == ops.ring_smem(plan.w, plan.s, plan.d, n,
                                      torch.empty((), dtype=dtype)
                                      .element_size())
    assert plan.smem <= ops.SMEM_PER_BLOCK
    # the blocks of a sequence tile its lanes, each exactly once
    per_b = plan.blocks // b
    assert plan.blocks == b * per_b
    covered = np.zeros(lanes, np.int64)
    for x in range(per_b):
        covered[x * plan.w:min((x + 1) * plan.w, lanes)] += 1
    assert (covered == 1).all() and per_b * plan.w < lanes + plan.w
    # one wave where the widest block still gives every SM two
    per_sm = -(-plan.blocks // sms)
    if per_sm <= ops.MIN_BLOCKS_PER_SM + 1:
        assert per_sm * (plan.smem + SMEM_RESERVED) <= SMEM_PER_SM


def test_plan_at_the_hybrid_slice_shape():
    """hymba-1.5B's Op.SSM_SCAN on an H100 (132 SMs): 400 blocks of 64
    lanes, all four a busy SM holds fitting at once, 2 stages of 32
    steps."""
    plan = ops.plan_for(1, 1600, 16, torch.float32, 132)
    assert plan == ops.Plan(ops.RING, 64, 32, 2, 400, 36864)
    assert 4 * (plan.smem + SMEM_RESERVED) <= SMEM_PER_SM


@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
@pytest.mark.parametrize("n", ops.STATE_SIZES)
def test_plan_picks_the_instance_for_each_alignment_case(n, dtype):
    """The ring needs 16-byte rows of c (N * element size) and 16-byte
    aligned bases; everything else takes the row-wise instance."""
    ring = n * torch.empty((), dtype=dtype).element_size() % 16 == 0
    want = ops.RING if ring else ops.ROWWISE
    for di in (100, 33):                    # even and odd Di
        assert ops.plan_for(1, di, n, dtype, 132).instance == want
        assert ops.plan_for(1, di, n, dtype, 132,
                            aligned=False).instance == ops.ROWWISE
    assert ring == (dtype == torch.float32 or n >= 8)


def test_alignment_of_views():
    """A fresh tensor starts on a 16-byte boundary; a contiguous view at a
    storage offset of one element does not."""
    buf = torch.zeros(1 + 2 * 8 * 4 * 4)
    view = buf[1:].view(2, 8, 4, 4)
    assert view.is_contiguous()
    assert ops.aligned16(buf) and not ops.aligned16(view)
    assert not ops.aligned16(buf, view)
    half = torch.zeros(9, dtype=torch.bfloat16)
    assert ops.aligned16(half[8:]) and not ops.aligned16(half[1:])


def _exp32(a):
    return np.exp(a, dtype=np.float32)


def _butterfly_scan(da, bx, c):
    """The row-wise instance's arithmetic in float32 numpy, over the
    unstaged arrays: per step h = exp(a) * h + b, p = h * c, and the xor
    butterfly over the N lanes of a channel (lane l adds lane l ^ o for o
    = N/2 .. 1); y is lane 0's sum."""
    b, t, di, n = da.shape
    h = np.zeros((b, di, n), np.float32)
    lanes = np.arange(n)
    y = np.empty((b, t, di), np.float32)
    for i in range(t):
        h = _exp32(da[:, i]) * h + bx[:, i]
        p = h * c[:, i, None, :]
        o = n // 2
        while o:
            p = p + p[..., lanes ^ o]
            o //= 2
        y[:, i] = p[..., 0]
    return y


def _ring_scan(da, bx, c, plan):
    """The ring instance's indexing and arithmetic in float32 numpy, one
    block at a time: slots filled row by row from the flat arrays at the
    kernel's offsets, D - 1 stages ahead with one commit group a stage,
    each stage checked to have landed in its slot before it is read and
    each slot's stage to have been read before it is refilled, groups of N
    steps, the transposed xor tree and the y element each lane writes.
    Returns y and how often each y element was written."""
    b_, t, di, n = da.shape
    w, s, depth = plan.w, plan.s, plan.d
    dn = di * n
    flat_a, flat_b, flat_c = da.reshape(-1), bx.reshape(-1), c.reshape(-1)
    y = np.full((b_, t, di), np.nan, np.float32)
    writes = np.zeros((b_, t, di), np.int64)
    nst = -(-t // s)
    tid = np.arange(w)
    lane_n = tid % n
    for b in range(b_):
        for x in range(-(-dn // w)):
            lane0 = x * w
            live = min(w, dn - lane0)
            # NaN stands for memory no copy wrote: idle lanes are zeroed
            ring_a = np.full((depth, s, w), np.nan, np.float32)
            ring_b = np.full((depth, s, w), np.nan, np.float32)
            ring_c = np.full((depth, s, n), np.nan, np.float32)
            ring_a[:, :, live:] = 0
            ring_b[:, :, live:] = 0
            held = [None] * depth                   # the stage in each slot
            groups, consumed = [], set()            # commit groups: stages

            def fill(st):
                slot = st % depth
                assert held[slot] is None or held[slot] in consumed
                row0 = b * t + st * s
                rows = min(s, t - st * s)
                for r in range(rows):
                    off = (row0 + r) * dn + lane0
                    ring_a[slot, r, :live] = flat_a[off:off + live]
                    ring_b[slot, r, :live] = flat_b[off:off + live]
                ring_c[slot, :rows] = flat_c[row0 * n:(row0 + rows) * n] \
                    .reshape(rows, n)
                held[slot] = st

            def commit(st):
                if st < nst:
                    fill(st)
                groups.append(st)

            for k in range(depth - 1):
                commit(k)
            h = np.zeros(w, np.float32)
            for st in range(nst):
                slot = st % depth
                # all but the newest D - 2 groups done: stage st's included
                assert groups[:len(groups) - (depth - 2)][-1] == st
                assert held[slot] == st
                commit(st + depth - 1)      # after the barrier: st - 1 read
                t0 = st * s
                rows = min(s, t - t0)
                for g in range(0, rows, n):
                    v = np.zeros((n, w), np.float32)
                    for j in range(n):
                        r = g + j
                        if r < rows:
                            h = (_exp32(ring_a[slot, r]) * h
                                 + ring_b[slot, r])
                            v[j] = h * ring_c[slot, r, lane_n]
                    o = n // 2
                    while o:
                        up = (lane_n & o) != 0
                        for i in range(o):
                            send = np.where(up, v[i], v[i + o])
                            keep = np.where(up, v[i + o], v[i])
                            v[i] = keep + send[tid ^ o]
                        o //= 2
                    r = g + lane_n
                    d = (lane0 + tid) // n
                    ok = (r < rows) & (d < di)
                    y[b, t0 + r[ok], d[ok]] = v[0][ok]
                    np.add.at(writes, (b, t0 + r[ok], d[ok]), 1)
                consumed.add(st)
    return y, writes


# (shape, W, S, D): T below a stage, T = 1, ragged T with a ring that
# wraps (T/S not a multiple of D), ragged lanes with B = 3, N = 4 and 32,
# y elements past a 32-lane block edge, the plan's S and D
RING_CASES = [((1, 5, 20, 16), 32, 16, 2), ((1, 1, 20, 16), 64, 32, 2),
              ((1, 37, 20, 16), 32, 16, 2), ((1, 100, 12, 16), 64, 16, 3),
              ((3, 37, 101, 16), 64, 32, 2), ((2, 45, 33, 4), 32, 16, 3),
              ((1, 70, 6, 32), 32, 32, 2), ((1, 50, 10, 8), 128, 32, 2),
              ((2, 33, 7, 4), 32, 32, 4), ((1, 200, 20, 16), 64, 32, 2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RING_CASES, ids=str)
def test_ring_emulation_equals_the_unstaged_loop_bit_for_bit(case, dtype,
                                                             rng):
    """The ring's staging and its transposed xor tree change no bit: the
    emulated kernel equals the per-step butterfly over the unstaged arrays,
    every y element is written once, and both agree with the plain
    version within the dtype's tolerance."""
    shape, w, s, depth = case
    b, t, di, n = shape
    tensors = [_torch(a, dtype) for a in _inputs(rng, b, t, di, n)]
    da, bx, c = (a.float().numpy() for a in tensors)   # the kernel's to_f
    esize = tensors[0].element_size()
    plan = ops.ring_plan(b, di, n, esize, w, s, depth)
    got, writes = _ring_scan(da, bx, c, plan)
    want = _butterfly_scan(da, bx, c)
    assert (writes == 1).all()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    ref = ssm_scan_ref(*tensors).float().numpy()
    tol = TOL[dtype]
    np.testing.assert_allclose(want, ref,
                               atol=tol, rtol=tol)
