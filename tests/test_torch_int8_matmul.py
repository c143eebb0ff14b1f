"""int8_matmul in the port: its plain version against the JAX package's
Pallas kernel (interpret mode, as tests/test_kernels.py runs it) and against
``int8_matmul_ref``, bit for bit in fp32 and bf16; the int32 variant against
``lax.dot`` at ResNet-18's largest K with extreme operands; the wrapper's
contract, its CPU path and the registry route; and a JAX-built
``MATMUL_INT8`` program run by the port interpreted, linked and served on
the CPU, bit for bit. The CUDA kernel itself runs only on the card
(tests/test_torch_kernels_gpu.py)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import rbl as jax_rbl
from repro.core.executor import Executor as JaxExecutor
from repro.core.rcb import RCB as JRCB
from repro.core.rcb import Op as JOp
from repro.core.rcb import RCBOp as JRCBOp
from repro.core.rcb import RCBProgram as JRCBProgram
from repro.core.rcb import TensorDesc as JTensorDesc
from repro.kernels import registry as jax_registry
from repro.kernels.int8_matmul.ops import check_contract as jax_contract
from repro.kernels.int8_matmul.ops import int8_matmul as jax_int8_matmul
from repro.kernels.int8_matmul.ref import int8_matmul_ref as jax_ref
from repro_torch.core import rbl, rimfs
from repro_torch.core.executor import Executor
from repro_torch.core.rcb import RCB, Op, RCBOp, RCBProgram, TensorDesc
from repro_torch.kernels import registry
from repro_torch.kernels.int8_matmul import ops
from repro_torch.kernels.int8_matmul.ref import (int8_matmul_i32_ref,
                                                 int8_matmul_ref)
from repro_torch.serving.server import Client, InferenceServer

# every comparison in this file is bit for bit: no float touches the int32
# accumulator, and the epilogue is one multiply and one rounding

# (M, K, N, JAX blocks (bm, bn, bk)): the three shapes of
# tests/test_kernels.py:91-94, and ResNet-18's stem K = 7*7*3 = 147
KERNEL_SHAPES = {
    "t1": (128, 256, 128, (64, 64, 64)),
    "t2": (64, 64, 64, (32, 32, 32)),
    "t3": (256, 128, 64, (128, 64, 128)),
    "stem_k147": (64, 147, 32, (32, 32, 49)),
}
# the registry's ragged shapes (tests/test_conformance.py:590-595): block
# sizes come from the JAX registry's divisor rule
REGISTRY_SHAPES = {"odd_head": (8, 24, 16), "gqa": (16, 32, 8),
                   "ragged": (8, 16, 24), "k147": (12, 147, 20)}


def _operands(rng, m, k, n):
    """As test_kernels.py::test_int8_matmul draws them."""
    return (rng.randint(-127, 128, (m, k)).astype(np.int8),
            rng.randint(-127, 128, (k, n)).astype(np.int8),
            rng.rand(n).astype(np.float32))


def _bits(a) -> np.ndarray:
    """Comparable bits: bf16 (JAX's ml_dtypes or a torch tensor) as uint16."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16).numpy().view(np.uint16)
                if a.dtype == torch.bfloat16 else a.numpy())
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _port(arrays, dtype):
    x, w, s = (torch.from_numpy(a) for a in arrays)
    return int8_matmul_ref(x, w, s, getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(KERNEL_SHAPES))
def test_plain_version_equals_jax_kernel_and_ref(name, dtype, rng):
    m, k, n, (bm, bn, bk) = KERNEL_SHAPES[name]
    arrays = _operands(rng, m, k, n)
    jx, jw, js = (jnp.asarray(a) for a in arrays)
    jdt = getattr(jnp, dtype)
    want_kernel = jax_int8_matmul(jx, jw, js, block_m=bm, block_n=bn,
                                  block_k=bk, out_dtype=jdt)
    want_ref = jax_ref(jx, jw, js, out_dtype=jdt)
    got = _port(arrays, dtype)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(_bits(got), _bits(want_kernel))
    np.testing.assert_array_equal(_bits(got), _bits(want_ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tag", sorted(REGISTRY_SHAPES))
def test_registry_route_equals_jax_registry(tag, dtype, rng):
    """Both registries, kernel and plain routes, on shapes no 128-tile
    divides."""
    m, k, n = REGISTRY_SHAPES[tag]
    arrays = _operands(rng, m, k, n)
    jargs = [jnp.asarray(a) for a in arrays]
    tensors = [torch.from_numpy(a) for a in arrays]
    attrs = {"out_dtype": dtype}
    for impl in ("pallas", "ref"):
        want = jax_registry.call_op("matmul_int8", jargs,
                                    {**attrs, "impl": impl})
        got = registry.call_op("matmul_int8", tensors,
                               {**attrs, "impl": impl})
        np.testing.assert_array_equal(_bits(got), _bits(want))
    # no impl: the hand kernel's wrapper, which on the CPU is the plain one
    assert torch.equal(registry.call_op("matmul_int8", tensors, attrs),
                       _port(arrays, dtype))


@pytest.mark.parametrize("signs", ["all_plus", "all_minus", "mixed"])
def test_int32_variant_is_exact_at_the_largest_k(signs, rng):
    """K = 4608 (ResNet-18's s3 conv2) with all operands at +-127: the sums
    reach 127 * 127 * 4608 = 74,322,432, past fp32's 2^24."""
    m, k, n = 4, 4608, 8
    if signs == "mixed":
        x = np.where(rng.rand(m, k) < 0.5, -127, 127).astype(np.int8)
        w = np.where(rng.rand(k, n) < 0.5, -127, 127).astype(np.int8)
    else:
        v = 127 if signs == "all_plus" else -127
        x = np.full((m, k), v, np.int8)
        w = np.full((k, n), 127, np.int8)
    want = np.asarray(jax.lax.dot(jnp.asarray(x), jnp.asarray(w),
                                  preferred_element_type=jnp.int32))
    got = ops.int8_matmul_i32(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if signs != "mixed":
        assert abs(int(want[0, 0])) == 127 * 127 * 4608 > 2 ** 24


def _bad_operands():
    x, w, s = _operands(np.random.RandomState(0), 8, 16, 4)
    return {
        "x_rank": (x[None], w, s),
        "w_rank": (x, w[0], s),
        "scale_rank": (x, w, s[None]),
        "x_dtype": (x.astype(np.int32), w, s),
        "w_dtype": (x, w.astype(np.float32), s),
        "scale_dtype": (x, w, s.astype(np.int32)),
        "zero_m": (x[:0], w, s),
        "contraction": (x, w[:8], s),
        "scale_length": (x, w, s[:3]),
    }


@pytest.mark.parametrize("case", sorted(_bad_operands()))
def test_contract_raises_the_jax_errors(case):
    """The registry's contract (block sizes 1, as the JAX registry applies
    it): the same ``ValueError`` text from both packages."""
    arrays = _bad_operands()[case]
    with pytest.raises(ValueError) as theirs:
        jax_contract(*[jnp.asarray(a) for a in arrays], block_m=1,
                     block_n=1, block_k=1)
    tensors = [torch.from_numpy(a) for a in arrays]
    with pytest.raises(ValueError) as ours:
        ops.int8_matmul(*tensors)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError):
        registry.call("matmul_int8", *tensors, impl="ref")


def test_int32_variant_contract():
    x = torch.zeros(4, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="must be rank-2"):
        ops.int8_matmul_i32(x[None], x.t())
    with pytest.raises(ValueError, match="operand 'w' must be int8, got "
                                         "float32"):
        ops.int8_matmul_i32(x, x.t().float())
    with pytest.raises(ValueError, match="contraction mismatch"):
        ops.int8_matmul_i32(x, x)
    with pytest.raises(ValueError, match="zero-size"):
        ops.int8_matmul_i32(x[:0], x.t())


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing(rng):
    x, w, s = (torch.from_numpy(a) for a in _operands(rng, 16, 40, 24))
    before = ops.int8_matmul.launches
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        assert torch.equal(ops.int8_matmul(x, w, s, dt),
                           int8_matmul_ref(x, w, s, dt))
    assert torch.equal(ops.int8_matmul_i32(x, w), int8_matmul_i32_ref(x, w))
    assert ops.int8_matmul.launches == before
    with pytest.raises(ValueError, match="unsupported out_dtype"):
        ops.int8_matmul(x, w, s, torch.int32)
    # a bf16 scale is read as fp32, exactly, as the TPU kernel reads it
    assert torch.equal(ops.int8_matmul(x, w, s.bfloat16()),
                       int8_matmul_ref(x, w, s.bfloat16().float()))


@pytest.mark.parametrize("m,k,n,sms,want", [
    (512, 1536, 8960, 132, 1),      # 560 tiles of 128 x 64: no split
    (12544, 147, 64, 132, 1),       # the stem: 196 tiles of 64 x 64
    (49, 4608, 512, 132, 15),       # 8 tiles, 72 steps: 15 splits of 5
    (196, 2304, 256, 132, 9),       # 16 tiles, 36 steps: 9 splits of 4
    (1, 300, 257, 132, 2),          # 5 tiles, 5 steps: 2 splits of 3
    (8, 64, 8, 132, 1)])            # 1 k step: too few to split
def test_split_k_choice(m, k, n, sms, want):
    got = ops.splits_for(m, n, k, sms)
    assert got == want
    steps = -(-k // 64)
    per = -(-steps // got)
    assert per >= 2 or got == 1          # every split takes 2 steps or more
    assert (got - 1) * per < steps       # and none is empty


# every GEMM the served paths give the kernel: MATMUL_INT8 and ResNet-18's
# 20 CONV2D_I8 at 224 px, B=1 (11 distinct shapes), as (M, K, N)
SERVED_GEMMS = [(512, 1536, 8960), (12544, 147, 64), (3136, 576, 64),
                (784, 576, 128), (784, 64, 128), (784, 1152, 128),
                (196, 1152, 256), (196, 128, 256), (196, 2304, 256),
                (49, 2304, 512), (49, 256, 512), (49, 4608, 512)]


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("mkn", SERVED_GEMMS)
def test_tile_plan_of_every_served_shape(mkn, sms):
    """Each served shape gets a tile of the kernel and a split of K that
    leaves no split empty; a split is taken only where the output has
    fewer tiles than SMs, and it never gives more blocks than needed to
    give each SM one."""
    m, k, n = mkn
    tile, splits = ops.plan_for(m, n, k, sms)
    assert 0 <= tile < len(ops.TILES)
    rows, cols = ops.TILES[tile]
    tiles = -(-m // rows) * -(-n // cols)
    steps = -(-k // 64)
    per = -(-steps // splits)
    assert splits >= 1 and (splits - 1) * per < steps
    if splits > 1:
        assert tiles < sms and ops.TILES[tile] == ops.TILES[-1]
        assert per >= 2
        assert tiles * (splits - 1) < sms
    assert ops.splits_for(m, n, k, sms) == splits


def test_tile_plan_is_deterministic_and_covers_every_shape(rng):
    """The plan is a pure function of (M, N, K, SM count): the same answer
    on every call, and a valid one for any shape."""
    shapes = [tuple(int(v) for v in rng.randint(1, 5000, 3))
              for _ in range(300)] + [(1, 1, 1), (1, 4097, 1)]
    for m, k, n in shapes:
        first = ops.plan_for(m, n, k, 132)
        assert all(ops.plan_for(m, n, k, 132) == first for _ in range(3))
        tile, splits = first
        steps = -(-k // 64)
        assert 0 <= tile < len(ops.TILES)
        assert 1 <= splits <= steps
        assert (splits - 1) * -(-steps // splits) < steps
    assert ops.plan_for(512, 8960, 1536, 132) == (0, 1)


def _program(module, m, k, n, dtype):
    """The one-op program tests/test_conformance.py:632-645 builds, with
    ``out_dtype`` set, from either package's RCB classes."""
    desc, op, code = module["TensorDesc"], module["RCBOp"], module["Op"]
    t = {"x": desc("x", (m, k), "int8", "input"),
         "w": desc("w", (k, n), "int8", "input"),
         "scale": desc("scale", (n,), "float32", "input"),
         "out": desc("out", (m, n), dtype, "output")}
    ops_ = (op(code.MATMUL_INT8, ("out",), ("x", "w", "scale"),
               {"out_dtype": dtype}), op(code.FENCE))
    prog = module["RCBProgram"]("k_matmul_int8", t,
                                [module["RCB"](0, "layer", (), ops_)])
    prog.validate()
    return prog


def _jax_program(m, k, n, dtype):
    return _program({"TensorDesc": JTensorDesc, "RCBProgram": JRCBProgram,
                     "RCB": JRCB, "RCBOp": JRCBOp, "Op": JOp}, m, k, n,
                    dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mkn", [(8, 24, 16), (16, 147, 8), (32, 64, 48)])
def test_jax_matmul_int8_program_runs_in_the_port_bit_for_bit(mkn, dtype,
                                                              rng):
    m, k, n = mkn
    arrays = dict(zip(("x", "w", "scale"), _operands(rng, m, k, n)))
    jprog = _jax_program(m, k, n, dtype)
    want = JaxExecutor().run(jax_rbl.bind(jprog, inputs=dict(arrays)))["out"]
    prog = RCBProgram.decode(jprog.encode())
    mine = _program({"TensorDesc": TensorDesc, "RCBProgram": RCBProgram,
                     "RCB": RCB, "RCBOp": RCBOp, "Op": Op}, m, k, n, dtype)
    assert mine.encode() == jprog.encode()
    ex = Executor(device="cpu")
    bound = rbl.bind(prog, inputs=dict(arrays), driver=ex.driver)
    for run in (ex.run, ex.run_interpreted):
        got = run(bound)["out"]
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_served_matmul_int8_program_equals_jax(dtype, rng):
    """Provisioned over protocol v2 (an image with no files) and served by
    the port's InferenceServer on the CPU, twice, one request pipelined."""
    m, k, n = 16, 147, 24
    jprog = _jax_program(m, k, n, dtype)
    requests = [dict(zip(("x", "w", "scale"), _operands(rng, m, k, n)))
                for _ in range(2)]
    server = InferenceServer(device="cpu")
    client = Client(server.start())
    try:
        assert client.provision(rimfs.pack({}), jprog.encode()) == {
            "status": "ready"}
        got = [client.infer(**requests[0])["out"]]
        rid = client.infer_async(**requests[1])
        got.append(client.result(rid)["out"])
    finally:
        client.close()
        server.stop()
    for req, g in zip(requests, got):
        want = JaxExecutor().run(jax_rbl.bind(jprog, inputs=dict(req)))
        np.testing.assert_array_equal(_bits(g), _bits(want["out"]))
