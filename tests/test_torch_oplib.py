"""Every opcode of the dense, hybrid and ssm LM programs but the GRAPH_EXEC
glue (tests/test_torch_hybrid.py, tests/test_torch_rwkv.py): the port's
``oplib.compute`` against the JAX package's on the same numpy inputs (fp32,
atol 1e-5; RESHAPE and PASSTHROUGH exact). RMSNORM and ROPE run at the
qwen2-1.5B smoke shapes, SSM_SCAN at hymba-1.5B smoke's state size (N=4),
WKV6 at rwkv6-1.6B smoke's heads (H=4, K=16)."""
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


@pytest.mark.parametrize("op", [Op.CONV2D, Op.SOFTMAX, Op.MATMUL_INT8,
                                Op.MAXPOOL, Op.AVGPOOL_GLOBAL])
def test_unported_opcode_raises_naming_it(op):
    with pytest.raises(NotImplementedError, match=op.name):
        oplib.compute(op, [torch.zeros(1)], {})
    with pytest.raises(NotImplementedError, match=op.name):
        make_eager_driver("cpu").link_compute(op, {})


@pytest.mark.parametrize("name", ["matmul_int8", "layer_norm", "conv2d"])
def test_unported_kernel_raises(name):
    with pytest.raises(NotImplementedError, match=name) as err:
        registry.get(name)
    assert "ported: ['attention', 'ssm_scan', 'wkv6']" in str(err.value)


def test_unknown_impl_is_rejected(rng):
    q = torch.from_numpy(_f32(rng, B, S, H, HD))
    kv = torch.from_numpy(_f32(rng, B, S, HKV, HD))
    with pytest.raises(ValueError, match="unknown impl"):
        registry.call("attention", q, kv, kv, impl="triton")
