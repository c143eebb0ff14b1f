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


# ---------------------------------------------------------------------------
# A numpy emulation of the CUDA kernel's chunked scan (csrc/wkv6.cu), step by
# step: chunks of 64 steps, the kernel's cumsum split, cumsums in log2 units
# so that every exponential is an exp2, sub-chunks of 16 with the diagonal
# blocks exact and the others factored through the last step m of the
# earlier sub-chunk, every product as its 3xTF32 mma.sync (hi and lo halves
# truncated to TF32 as the kernel masks them), the entering states built in
# the block or by the carry pass, and a ragged tail of zero (identity)
# steps. The CUDA kernel itself runs only on the card.

CHUNK, SUB, THREADS, WARPS = 64, 16, 256, 8
LOG2E = np.float32(1.4426950408889634)


def _exp2(x):
    """Every exponential the kernel takes: its argument is never above 0."""
    assert np.all(x <= 0), f"exp of a positive number: {x.max()}"
    return np.exp2(x).astype(np.float32)


def _tf32(x):
    """The kernel's split: keep the top 10 mantissa bits (truncation)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _mma3(a, b):
    """a @ b as the kernel's mma.sync m16n8k8: each operand split into
    hi = tf32(x) and lo = tf32(x - hi); hi*hi and lo*hi + hi*lo summed
    apart in fp32, then added."""
    ahi, bhi = _tf32(a), _tf32(b)
    alo, blo = _tf32(a - ahi), _tf32(b - bhi)
    return ((ahi @ bhi).astype(np.float32)
            + (alo @ bhi + ahi @ blo).astype(np.float32))


def _cumsum(lw):
    """The kernel's cumsum over a (64, K) chunk, in log2 units: 256 / K
    threads a column each sum their run of steps, then add the totals
    before theirs, in order, and scale by log2(e)."""
    kk = lw.shape[1]
    parts = THREADS // kk
    local = np.cumsum(lw.reshape(parts, CHUNK // parts, kk), axis=1,
                      dtype=np.float32)
    off, acc = np.zeros((parts, 1, kk), np.float32), np.zeros(kk, np.float32)
    for q in range(1, parts):
        acc = acc + local[q - 1, -1]
        off[q, 0] = acc
    return ((local + off) * LOG2E).reshape(CHUNK, kk)


def _chunk_states(k, v, lw):
    """The states kernel: U_c = (k * exp(p_last - p))^T v, d_c. Its warps
    split the 64 steps into equal runs; their partial sums meet in order."""
    p = _cumsum(lw)
    kd = k * _exp2(p[-1] - p)
    runs = WARPS // max(1, k.shape[1] // 16)
    u_c = np.zeros((k.shape[1], k.shape[1]), np.float32)
    for ts in np.split(np.arange(CHUNK), runs):
        u_c = u_c + _mma3(kd[ts].T, v[ts])
    return u_c, _exp2(p[-1])


def _carry(us, ds):
    """The carry kernel: S_c, the state entering chunk c, for every c."""
    s, out = np.zeros_like(us[0]), []
    for u_c, d_c in zip(us, ds):
        out.append(s)
        s = (d_c[:, None] * s + u_c).astype(np.float32)
    return out


def _in_block(us, ds, c):
    """An output block's own build of S_c from U_0 .. U_{c-1}."""
    s = np.zeros_like(us[0])
    for cc in range(c):
        s = (ds[cc][:, None] * s + us[cc]).astype(np.float32)
    return s


def _chunk_output(r, k, v, lw, u, s):
    """The output kernel: one chunk's y from its entering state s."""
    p = _cumsum(lw)
    pprev = np.vstack([np.zeros((1, p.shape[1]), np.float32), p[:-1]])
    att = np.zeros((CHUNK, CHUNK), np.float32)
    below = np.tri(SUB, k=-1, dtype=bool)                  # j < t
    for a in range(CHUNK // SUB):
        rows = slice(a * SUB, (a + 1) * SUB)
        # the diagonal block, exact: one exp per (t, j < t, i)
        diff = pprev[rows][:, None, :] - p[rows][None, :, :]
        e = _exp2(np.where(below[:, :, None], diff, 0.0)) * below[:, :, None]
        att[rows, rows] = np.einsum("ti,ji,tji->tj", r[rows], k[rows], e)
        for b in range(a):                  # through m, b's last step
            cols, m = slice(b * SUB, (b + 1) * SUB), b * SUB + SUB - 1
            att[rows, cols] = _mma3(r[rows] * _exp2(pprev[rows] - p[m]),
                                    (k[cols] * _exp2(p[m] - p[cols])).T)
    coef = np.sum(r * u * k, axis=1, dtype=np.float32)
    return (_mma3(att, v) + _mma3(r * _exp2(pprev), s)
            + coef[:, None] * v).astype(np.float32)


def _wkv6_chunked(r, k, v, lw, u, inblock_chunks=16):
    """(B, T, H, K) fp32 arrays -> y, as csrc/wkv6.cu computes it."""
    b_, t_, h_, _ = r.shape
    nc = -(-t_ // CHUNK)

    def padded(a):            # steps past T load zeros: identity steps
        return np.pad(a.astype(np.float32),
                      ((0, 0), (0, nc * CHUNK - t_), (0, 0), (0, 0)))

    r, k, v, lw = (padded(a) for a in (r, k, v, lw))
    y = np.zeros_like(r)
    for b in range(b_):
        for h in range(h_):
            def tile(a, c):
                return a[b, c * CHUNK:(c + 1) * CHUNK, h]
            us, ds = zip(*(_chunk_states(tile(k, c), tile(v, c),
                                         tile(lw, c)) for c in range(nc)))
            entering = (_carry(us, ds) if nc > inblock_chunks else
                        [_in_block(us, ds, c) for c in range(nc)])
            for c in range(nc):
                y[b, c * CHUNK:(c + 1) * CHUNK, h] = _chunk_output(
                    tile(r, c), tile(k, c), tile(v, c), tile(lw, c),
                    u[h].astype(np.float32), entering[c])
    return y[:, :t_]


def _plain(arrays):
    return wkv6_ref_bthk(*(torch.from_numpy(a) for a in arrays)).numpy()


@pytest.mark.parametrize("kk", ops.HEAD_SIZES)
@pytest.mark.parametrize("t", [1, 15, 16, 17, 63, 64, 65, 130, 512])
def test_chunked_emulation_matches_plain_version_and_jax_kernel(t, kk, rng):
    """T at and either side of the sub-chunk (16) and chunk (64) edges;
    against the JAX kernel where a chunk of min(64, T) tiles T, as
    ``wkv6_bhtk`` asserts."""
    arrays = _inputs(rng, 1, t, 2, kk)
    got = _wkv6_chunked(*arrays)
    np.testing.assert_allclose(got, _plain(arrays), atol=5e-4, rtol=5e-4)
    chunk = min(CHUNK, t)
    if t % chunk == 0:
        want = np.asarray(jax_wkv6(*(jnp.asarray(a) for a in arrays),
                                   chunk=chunk))
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("kk", [16, 64])
def test_chunked_emulation_at_extreme_decay_across_chunks(kk, rng):
    """lw = -80 over T = 200: four chunks, a ragged tail, every sub-chunk
    edge. With u = 0, y_t = (r_t . k_{t-1}) v_{t-1} up to e^-80."""
    r, k, v, _, _ = _inputs(rng, 1, 200, 2, kk)
    lw = np.full_like(r, -80.0)
    u = np.zeros((2, kk), np.float32)
    got = _wkv6_chunked(r, k, v, lw, u)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _plain((r, k, v, lw, u)), atol=5e-4,
                               rtol=5e-4)
    direct = np.zeros_like(r)
    direct[:, 1:] = (np.einsum("bthi,bthi->bth", r[:, 1:], k[:, :-1])
                     [..., None] * v[:, :-1])
    np.testing.assert_allclose(got, direct, atol=1e-4, rtol=1e-4)


def test_chunked_emulation_without_decay(rng):
    """lw = 0 over T = 512: S is the running sum of k v^T over 8 chunks."""
    r, k, v, _, u = _inputs(rng, 1, 512, 1, 32)
    lw = np.zeros_like(r)
    got = _wkv6_chunked(r, k, v, lw, u)
    np.testing.assert_allclose(got, _plain((r, k, v, lw, u)), atol=5e-4,
                               rtol=5e-4)


def test_chunked_emulation_with_decays_mixed_across_heads(rng):
    """Per head: lw = -80, lw = 0, and lw = -exp(normal); T = 200."""
    r, k, v, lw, u = _inputs(rng, 2, 200, 3, 16)
    lw[:, :, 0] = -80.0
    lw[:, :, 1] = 0.0
    got = _wkv6_chunked(r, k, v, lw, u)
    np.testing.assert_allclose(got, _plain((r, k, v, lw, u)), atol=5e-4,
                               rtol=5e-4)


@pytest.mark.parametrize("t", [300, 1100])
def test_chunked_emulation_builds_entering_states_both_ways(t, rng):
    """The carry pass (above the in-block cap) and the in-block build give
    the same bits: the same recurrence in the same order. T = 1100 is 18
    chunks, past the wrapper's cap of 11."""
    arrays = _inputs(rng, 1, t, 1, 8)
    carried = _wkv6_chunked(*arrays, inblock_chunks=0)
    built = _wkv6_chunked(*arrays, inblock_chunks=1 << 30)
    assert np.array_equal(carried, built)
    np.testing.assert_allclose(_wkv6_chunked(*arrays), _plain(arrays),
                               atol=5e-4, rtol=5e-4)
    assert ops.INBLOCK_CHUNKS == 11
