"""Every compute opcode of the JAX package's oplib (the GRAPH_EXEC glue is
in tests/test_torch_hybrid.py and tests/test_torch_rwkv.py): the port's
``oplib.compute`` against the JAX package's on the same numpy inputs (fp32,
atol 1e-5; RESHAPE, PASSTHROUGH, RELU, MAXPOOL and every integer opcode
exact). RMSNORM and ROPE run at the qwen2-1.5B smoke shapes, SSM_SCAN at
hymba-1.5B smoke's state size (N=4), WKV6 at rwkv6-1.6B smoke's heads (H=4,
K=16); the vision and integer opcodes at ResNet-18's kernel sizes and
strides on small images, with the SAME padding cases where ``lax`` pads
asymmetrically (the 7x7/2 stem, a 3x3/2 conv, the 3x3/2 maxpool on even
sizes with negative inputs), and QUANTIZE on exact half-steps and the
floats next to them."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import oplib as jax_oplib
from repro_torch.configs import get_config
from repro_torch.core import oplib
from repro_torch.core.rcb import Op
from repro_torch.core.rhal import make_eager_driver
from repro_torch.kernels import registry

ATOL = 1e-5
CFG = get_config("qwen2-1.5b-smoke")
B, S = 2, 8
D, H, HKV, HD, F = (CFG.d_model, CFG.num_heads, CFG.num_kv_heads,
                    CFG.head_dim, CFG.d_ff)


def _f32(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _ssm_operands(rng, n=4):
    return [-np.exp(_f32(rng, B, S, D, n)), _f32(rng, B, S, D, n),
            _f32(rng, B, S, n)]


def _wkv6_operands(rng, h=4, kk=16):
    return [_f32(rng, B, S, h, kk), 0.3 * _f32(rng, B, S, h, kk),
            _f32(rng, B, S, h, kk), -np.exp(_f32(rng, B, S, h, kk)),
            0.5 * _f32(rng, h, kk)]


def _positions():
    return np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()


# name -> (opcode, srcs from an rng, attrs, exact)
CASES = {
    "gemm": (Op.GEMM, lambda r: [_f32(r, B, S, D), _f32(r, D, H * HD)],
             {}, False),
    "gemm_tb_logits": (Op.GEMM, lambda r: [_f32(r, B, S, D),
                                           _f32(r, CFG.vocab_size, D)],
                       {"tb": True}, False),
    "gemm_ta": (Op.GEMM, lambda r: [_f32(r, D, S), _f32(r, D, F)],
                {"ta": True}, False),
    "gemm_ta_tb": (Op.GEMM, lambda r: [_f32(r, D, S), _f32(r, F, D)],
                   {"ta": True, "tb": True}, False),
    "add": (Op.ADD, lambda r: [_f32(r, B, S, D), _f32(r, B, S, D)], {},
            False),
    "add_bias": (Op.ADD, lambda r: [_f32(r, B, S, HKV * HD),
                                    _f32(r, HKV * HD)], {}, False),
    "reshape": (Op.RESHAPE, lambda r: [_f32(r, B, S, H * HD)],
                {"shape": [B, S, H, HD]}, True),
    "passthrough": (Op.PASSTHROUGH, lambda r: [_f32(r, B, S, D)], {}, True),
    "rmsnorm": (Op.RMSNORM, lambda r: [_f32(r, B, S, D),
                                       1 + 0.1 * _f32(r, D)],
                {"eps": CFG.norm_eps}, False),
    "rmsnorm_heads": (Op.RMSNORM, lambda r: [_f32(r, B, S, H, HD),
                                             _f32(r, HD)],
                      {"eps": 1e-6}, False),
    "rope_q": (Op.ROPE, lambda r: [_f32(r, B, S, H, HD), _positions()],
               {"theta": CFG.rope_theta}, False),
    "rope_k": (Op.ROPE, lambda r: [_f32(r, B, S, HKV, HD), _positions()],
               {"theta": CFG.rope_theta}, False),
    "rope_far_positions": (
        Op.ROPE, lambda r: [_f32(r, B, S, HKV, HD),
                            r.randint(0, 4096, (B, S)).astype(np.int32)],
        {"theta": 10000.0}, False),
    "scale_shift_hybrid_half": (
        Op.SCALE_SHIFT, lambda r: [_f32(r, B, S, D),
                                   np.full((1,), 0.5, np.float32),
                                   np.zeros((1,), np.float32)], {}, False),
    "scale_shift_channels": (Op.SCALE_SHIFT, lambda r: [_f32(r, B, S, D),
                                                        _f32(r, D),
                                                        _f32(r, D)],
                             {}, False),
    "silu_mul": (Op.SILU_MUL, lambda r: [_f32(r, B, S, F), _f32(r, B, S, F)],
                 {}, False),
    "ssm_scan": (Op.SSM_SCAN, lambda r: _ssm_operands(r), {}, False),
    "ssm_scan_plain": (Op.SSM_SCAN, lambda r: _ssm_operands(r),
                       {"impl": "ref"}, False),
    "wkv6": (Op.WKV6, lambda r: _wkv6_operands(r), {}, False),
    "wkv6_plain": (Op.WKV6, lambda r: _wkv6_operands(r), {"impl": "ref"},
                   False),
    "attention": (Op.ATTENTION, lambda r: [_f32(r, B, S, H, HD),
                                           _f32(r, B, S, HKV, HD),
                                           _f32(r, B, S, HKV, HD)],
                  {"causal": True}, False),
    "attention_plain": (Op.ATTENTION, lambda r: [_f32(r, B, S, H, HD),
                                                 _f32(r, B, S, HKV, HD),
                                                 _f32(r, B, S, HKV, HD)],
                        {"causal": True, "impl": "ref"}, False),
    "attention_full": (Op.ATTENTION, lambda r: [_f32(r, B, S, H, HD),
                                                _f32(r, B, S, HKV, HD),
                                                _f32(r, B, S, HKV, HD)],
                       {"causal": False}, False),
}


def _i8(r, *shape):
    return r.randint(-127, 128, shape).astype(np.int8)


def _half_steps(scale):
    """Inputs on the half-steps of ``scale`` (exact: scale is a power of
    two), the float32 neighbours of each, and values past +-127 steps."""
    base = (np.arange(-300, 301, dtype=np.float32) + np.float32(0.5)) \
        * np.float32(scale)
    return np.concatenate([base, np.nextafter(base, np.float32(np.inf)),
                           np.nextafter(base, np.float32(-np.inf))])


def _conv_case(hw, k, stride, cin=3, cout=5, int8=False, padding="SAME"):
    op = Op.CONV2D_I8 if int8 else Op.CONV2D

    def make(r):
        if int8:
            return [_i8(r, 2, hw, hw, cin), _i8(r, k, k, cin, cout)]
        return [_f32(r, 2, hw, hw, cin), _f32(r, k, k, cin, cout)]
    return (op, make, {"stride": [stride, stride], "padding": padding}, int8)


# name -> (opcode, srcs from an rng, attrs, exact): ResNet-18's ops
VISION_CASES = {
    "conv_stem_7x7s2": _conv_case(16, 7, 2),           # SAME pads (2, 3)
    "conv_3x3s1": _conv_case(8, 3, 1, 4, 6),
    "conv_3x3s2_even": _conv_case(8, 3, 2, 4, 6),      # SAME pads (0, 1)
    "conv_3x3s2_odd": _conv_case(9, 3, 2, 4, 6),       # SAME pads (1, 1)
    "conv_1x1s2_proj": _conv_case(8, 1, 2, 4, 6),      # no padding
    "conv_valid": _conv_case(8, 3, 1, padding="VALID"),
    "conv_i8_stem_7x7s2": _conv_case(16, 7, 2, int8=True),
    "conv_i8_3x3s1": _conv_case(8, 3, 1, 4, 6, int8=True),
    "conv_i8_3x3s2_even": _conv_case(8, 3, 2, 4, 6, int8=True),
    "conv_i8_3x3s2_odd": _conv_case(9, 3, 2, 4, 6, int8=True),
    "conv_i8_1x1s2_proj": _conv_case(8, 1, 2, 4, 6, int8=True),
    "conv_i8_extreme": (Op.CONV2D_I8, lambda r: [
        np.full((1, 6, 6, 64), -127, np.int8),
        np.full((3, 3, 64, 4), 127, np.int8)],
        {"stride": [1, 1], "padding": "SAME"}, True),   # K = 576
    "gemm_i8": (Op.GEMM_I8, lambda r: [_i8(r, 7, 147), _i8(r, 147, 9)], {},
                True),
    "matmul_int8": (Op.MATMUL_INT8, lambda r: [
        _i8(r, 8, 24), _i8(r, 24, 16), r.rand(16).astype(np.float32)],
        {"out_dtype": "float32"}, True),
    "maxpool_3x3s2_even": (Op.MAXPOOL, lambda r: [_f32(r, 2, 8, 8, 4) - 3],
                           {"window": [3, 3], "stride": [2, 2],
                            "padding": "SAME"}, True),
    "maxpool_3x3s2_odd": (Op.MAXPOOL, lambda r: [_f32(r, 2, 9, 9, 4) - 3],
                          {"window": [3, 3], "stride": [2, 2],
                           "padding": "SAME"}, True),
    "maxpool_default": (Op.MAXPOOL, lambda r: [_f32(r, 2, 8, 8, 4)], {},
                        True),
    "relu": (Op.RELU, lambda r: [_f32(r, 2, 4, 4, 8)], {}, True),
    "softmax": (Op.SOFTMAX, lambda r: [4 * _f32(r, B, 10)], {}, False),
    "avgpool_global": (Op.AVGPOOL_GLOBAL, lambda r: [_f32(r, 2, 7, 7, 16)],
                       {}, False),
    "dense_bias": (Op.DENSE, lambda r: [_f32(r, B, 16), _f32(r, 16, 10),
                                        _f32(r, 10)], {}, False),
    "dense": (Op.DENSE, lambda r: [_f32(r, B, 16), _f32(r, 16, 10)], {},
              False),
    "scale_shift_relu": (Op.SCALE_SHIFT_RELU, lambda r: [
        _f32(r, 2, 4, 4, 8), _f32(r, 8), _f32(r, 8)], {}, False),
    "scale_shift_requant": (Op.SCALE_SHIFT, lambda r: [
        r.randint(-2 ** 26, 2 ** 26, (2, 4, 4, 8)).astype(np.int32),
        1e-6 * r.rand(8).astype(np.float32), np.zeros(8, np.float32)], {},
        False),
    "add_relu": (Op.ADD_RELU, lambda r: [_f32(r, 2, 4, 4, 8),
                                         _f32(r, 2, 4, 4, 8)], {}, True),
    "quantize_ties": (Op.QUANTIZE, lambda r: [_half_steps(0.125)],
                      {"scale": 0.125}, True),
    "quantize_ties_small": (Op.QUANTIZE, lambda r: [_half_steps(2 ** -10)],
                            {"scale": 2 ** -10}, True),
    "quantize_odd_scale": (Op.QUANTIZE, lambda r: [
        np.concatenate([_half_steps(1 / 127), 3 * _f32(r, 512)])],
        {"scale": 1 / 127}, True),
    "dequant_int8": (Op.DEQUANT, lambda r: [_i8(r, 64)], {"scale": 0.037},
                     True),
    "dequant_int32": (Op.DEQUANT, lambda r: [
        r.randint(-2 ** 24, 2 ** 24, (64,)).astype(np.int32)],
        {"scale": 1 / 127}, True),
}


@pytest.mark.parametrize("name", sorted(VISION_CASES))
def test_vision_and_integer_opcode_matches_jax(name, rng):
    op, make, attrs, exact = VISION_CASES[name]
    srcs = make(rng)
    want = np.asarray(jax_oplib.compute(op, [jnp.asarray(a) for a in srcs],
                                        dict(attrs)))
    got = oplib.compute(op, [torch.from_numpy(a) for a in srcs], dict(attrs))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape
    assert got.numpy().dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", sorted(VISION_CASES))
def test_vision_linked_handler_equals_interpreted_dispatch(name, rng):
    op, make, attrs, _ = VISION_CASES[name]
    srcs = [torch.from_numpy(a) for a in make(rng)]
    drv = make_eager_driver("cpu")
    linked = drv.link_compute(op, dict(attrs))(*srcs)
    assert torch.equal(linked, drv.dispatch_compute(op, srcs, dict(attrs)))


def test_same_padding_puts_the_odd_pixel_at_the_end():
    """``lax.padtype_to_pads`` at ResNet-18's full size (224 px)."""
    assert oplib.same_pads(224, 7, 2) == (2, 3)      # stem
    assert oplib.same_pads(56, 3, 2) == (0, 1)       # 3x3/2 conv
    assert oplib.same_pads(56, 1, 2) == (0, 0)       # 1x1/2 projection
    assert oplib.same_pads(112, 3, 2) == (0, 1)      # 3x3/2 maxpool
    assert oplib.same_pads(7, 3, 1) == (1, 1)


@pytest.mark.parametrize("name", sorted(CASES))
def test_opcode_matches_jax(name, rng):
    op, make, attrs, exact = CASES[name]
    srcs = make(rng)
    want = np.asarray(jax_oplib.compute(op, [jnp.asarray(a) for a in srcs],
                                        dict(attrs)))
    got = oplib.compute(op, [torch.from_numpy(a) for a in srcs], dict(attrs))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    if exact:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_linked_handler_equals_interpreted_dispatch(name, rng):
    """The driver's ``link_compute`` handler and its per-op
    ``dispatch_compute`` run one implementation: bit-identical."""
    op, make, attrs, _ = CASES[name]
    srcs = [torch.from_numpy(a) for a in make(rng)]
    drv = make_eager_driver("cpu")
    linked = drv.link_compute(op, dict(attrs))(*srcs)
    interp = drv.dispatch_compute(op, srcs, dict(attrs))
    assert torch.equal(linked, interp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_rope_cast_back_to_input_dtype(dtype, rng):
    dt = getattr(torch, dtype)
    x = torch.from_numpy(_f32(rng, B, S, H, HD)).to(dt)
    w = torch.ones(HD, dtype=dt)
    pos = torch.from_numpy(_positions())
    assert oplib.compute(Op.RMSNORM, [x, w], {"eps": 1e-5}).dtype == dt
    assert oplib.compute(Op.ROPE, [x, pos], {"theta": 1e6}).dtype == dt


@pytest.mark.parametrize("op", [Op.FENCE, Op.DMA_H2D, Op.GRAPH_EXEC,
                                Op.COLLECTIVE, Op.ALLOC])
def test_unported_opcode_raises_naming_it(op):
    """Every compute opcode is in the table; the executor's own opcodes
    are not, and asking the table for one names it."""
    with pytest.raises(NotImplementedError, match=op.name):
        oplib.compute(op, [torch.zeros(1)], {})
    with pytest.raises(NotImplementedError, match=op.name):
        make_eager_driver("cpu").link_compute(op, {})


@pytest.mark.parametrize("name", ["int8_conv", "layer_norm", "conv2d"])
def test_unported_kernel_raises(name):
    with pytest.raises(NotImplementedError, match=name) as err:
        registry.get(name)
    assert ("ported: ['attention', 'matmul_int8', 'matmul_int8_i32', "
            "'ssm_scan', 'wkv6']" in str(err.value))


def test_unknown_impl_is_rejected(rng):
    q = torch.from_numpy(_f32(rng, B, S, H, HD))
    kv = torch.from_numpy(_f32(rng, B, S, HKV, HD))
    with pytest.raises(ValueError, match="unknown impl"):
        registry.call("attention", q, kv, kv, impl="triton")
