"""The port's compiled dispatch path on the card: ``Executor.fuse`` as a
CUDA graph and ``Executor.run_batched`` on captured batch buckets.

These tests need a CUDA device and skip without one: a CUDA graph has no
CPU mode. On the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_graphs_gpu.py

(``chip_smoke.py`` runs them.) The file imports torch and the port only, so
it runs where JAX is absent. A replay runs the same kernels in the same
order as ``Executor.run``, so every output is held to it bit for bit; a
batched lane of a hand kernel equals its per-lane call bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.func import vmap

from repro_torch.configs import get_config
from repro_torch.configs.resnet18 import CONFIG as RESNET
from repro_torch.core import quant, rbl, rctc, rimfs
from repro_torch.core.executor import Executor
from repro_torch.core.rcb import RCB, Op, RCBOp, RCBProgram, TensorDesc
from repro_torch.kernels import registry
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.int8_matmul import ops as im_ops
from repro_torch.kernels.ssm_scan import ops as ss_ops
from repro_torch.kernels.wkv6 import ops as wk_ops
from repro_torch.models import resnet as rn
from repro_torch.models import transformer as tf

SEQ = 16    # hymba-smoke's sliding window: its program lowers full attention
# each kernel's launches per request, by the program's kernel opcodes
KERNEL_OF = {Op.ATTENTION: "flash_attention", Op.SSM_SCAN: "ssm_scan",
             Op.WKV6: "wkv6", Op.MATMUL_INT8: "int8_matmul",
             Op.GEMM_I8: "int8_matmul", Op.CONV2D_I8: "int8_matmul"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def _bits(t):
    t = torch.as_tensor(t).cpu()
    if t.dtype.is_floating_point:
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        t = t.view(ints[t.element_size()])
    return t


def _launches():
    return {k: w.launches for k, w in registry.launch_counters().items()}


def _per_request(prog) -> dict:
    want = dict.fromkeys(registry.launch_counters(), 0)
    for op in prog.ops():
        if op.op in KERNEL_OF:
            want[KERNEL_OF[op.op]] += 1
    return want


def _lm(name, dtype, ex):
    cfg = dataclasses.replace(get_config(name), dtype=dtype)
    params = tf.init_params(cfg, 0, device="cpu")
    prog, image = rctc.compile_transformer_block(cfg, params, 1, SEQ)
    bound = rbl.bind(prog, rimfs=rimfs.mount(image), driver=ex.driver)
    rng = np.random.RandomState(1)
    req = {"hidden": torch.from_numpy(
        rng.randn(1, SEQ, cfg.d_model).astype(np.float32)).to(
            getattr(torch, dtype))}
    if cfg.family != "ssm":
        req["positions"] = np.arange(SEQ, dtype=np.int32)[None].copy()
    return prog, bound, req


def _matmul_int8(ex, m=64, k=160, n=96):
    t = {"x": TensorDesc("x", (m, k), "int8", "input"),
         "w": TensorDesc("w", (k, n), "int8", "input"),
         "scale": TensorDesc("scale", (n,), "float32", "input"),
         "out": TensorDesc("out", (m, n), "float32", "output")}
    prog = RCBProgram("k_matmul_int8", t, [RCB(0, "layer", (), (
        RCBOp(Op.MATMUL_INT8, ("out",), ("x", "w", "scale"),
              {"out_dtype": "float32"}), RCBOp(Op.FENCE)))])
    prog.validate()

    def request(seed):
        r = np.random.RandomState(seed)
        return {"x": r.randint(-127, 128, (m, k)).astype(np.int8),
                "w": r.randint(-127, 128, (k, n)).astype(np.int8),
                "scale": r.rand(n).astype(np.float32)}
    return prog, rbl.bind(prog, driver=ex.driver), request


def _resnet_int8(ex):
    cfg = RESNET.smoke()
    folded = rn.fold_bn(rn.init_resnet(cfg, 0))
    calib = torch.rand((4, cfg.image_size, cfg.image_size, 3),
                       generator=torch.Generator().manual_seed(2)).cuda()
    pack = quant.quantize_resnet(cfg, folded, calib)
    prog, image = rctc.compile_resnet18(cfg, folded, batch=1, int8=pack)
    bound = rbl.bind(prog, rimfs=rimfs.mount(image), driver=ex.driver)

    def request(seed):
        return {"input": np.random.RandomState(seed).rand(
            1, cfg.image_size, cfg.image_size, 3).astype(np.float32)}
    return prog, bound, request


def _cases(ex):
    rn_prog, rn_bound, rn_req = _resnet_int8(ex)
    mm_prog, mm_bound, mm_req = _matmul_int8(ex)
    cases = {"resnet18_int8": (rn_prog, rn_bound, rn_req(0)),
             "matmul_int8": (mm_prog, mm_bound, mm_req(0))}
    for name, dtype in (("qwen2-1.5b-smoke", "bfloat16"),
                        ("qwen2-1.5b-smoke", "float32"),
                        ("hymba-1.5b-smoke", "float32"),
                        ("rwkv6-1.6b-smoke", "float32")):
        cases[f"{name}-{dtype}"] = _lm(name, dtype, ex)
    return cases


@pytest.mark.gpu
def test_replay_equals_run_bit_for_bit_with_the_launches_of_a_run(cuda):
    ex = Executor(device="cuda")
    for name, (prog, bound, req) in _cases(ex).items():
        want = ex.run(bound, inputs=req)
        fused = ex.fuse(bound)
        weights = ex.weights_from(bound)
        fused(req, weights)                         # captures
        (graph,) = fused.graphs.values()
        assert graph.capture_s > 0
        before = _launches()
        got = fused(req, weights)                   # one replay
        torch.cuda.synchronize()
        per_replay = {k: n - before[k] for k, n in _launches().items()}
        assert per_replay == graph.launches == _per_request(prog), name
        assert sorted(got) == sorted(want), name
        for k in want:
            assert torch.equal(_bits(got[k]), _bits(want[k])), (name, k)
        again = fused(req, weights)
        for k in want:                              # outputs are clones
            assert got[k].data_ptr() != again[k].data_ptr()


@pytest.mark.gpu
def test_other_weight_tensors_capture_anew(cuda):
    ex = Executor(device="cuda")
    prog, bound, req = _lm("qwen2-1.5b-smoke", "float32", ex)
    fused = ex.fuse(bound)
    w = ex.weights_from(bound)
    first = fused(req, w)["logits"]
    other = {k: v * 0.5 if v.is_floating_point() else v.clone()
             for k, v in w.items()}
    second = fused(req, other)["logits"]
    assert len(fused.graphs) == 2
    want = ex.run(rbl.rebind(bound, buffers=other), inputs=req)["logits"]
    assert torch.equal(_bits(second), _bits(want))
    assert not torch.equal(first, second)
    assert torch.equal(_bits(fused(req, w)["logits"]), _bits(first))
    assert len(fused.graphs) == 2                   # replayed, not captured
    with pytest.raises(ValueError, match="is not a tensor on cuda"):
        fused(req, {k: v.cpu() for k, v in w.items()})


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 4, 5])
def test_batched_buckets_are_graphs_exact_for_int8_programs(cuda, n):
    ex = Executor(device="cuda")
    for make in (_matmul_int8, _resnet_int8):
        prog, bound, request = make(ex)
        reqs = [request(10 + i) for i in range(n)]
        outs = ex.run_batched(bound, reqs)
        (bucket,) = ex.batch_stats["buckets"]
        fn = ex._batched_callable(bound, bucket)
        assert isinstance(fn.graph.graph, torch.cuda.CUDAGraph)
        want = _per_request(prog)
        lanes = bucket if prog.name == "k_matmul_int8" else 1
        assert fn.graph.launches == {k: v * lanes for k, v in want.items()}
        for req, got in zip(reqs, outs):
            ref = ex.run(bound, inputs=req)
            out = "out" if "out" in ref else "output"
            if prog.name == "k_matmul_int8":
                assert torch.equal(_bits(got[out]), _bits(ref[out]))
            else:   # the fp32 DENSE after the int8 convs: cuBLAS by M
                np.testing.assert_allclose(got[out], ref[out].cpu().numpy(),
                                           rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_vmap_rules_equal_per_lane_kernel_calls(cuda):
    g = torch.Generator(device="cuda").manual_seed(0)
    lanes = 3

    def per_lane(fn, args, dims):
        return torch.stack([fn(*(a if d is None else a.select(d, j)
                                 for a, d in zip(args, dims)))
                            for j in range(lanes)])

    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn(lanes, 1, 128, 12, 128, generator=g, device="cuda")
        k = torch.randn(lanes, 1, 128, 2, 128, generator=g, device="cuda")
        v = torch.randn(1, 128, 2, 128, generator=g, device="cuda")
        args, dims = (q.to(dt), k.to(dt), v.to(dt)), (0, 0, None)
        assert torch.equal(vmap(fa_ops.flash_attention, in_dims=dims)(*args),
                           per_lane(fa_ops.flash_attention, args, dims))
    da = -torch.rand(lanes, 1, 96, 160, 16, generator=g, device="cuda")
    bx = torch.randn(lanes, 1, 96, 160, 16, generator=g, device="cuda")
    c = torch.randn(lanes, 1, 96, 16, generator=g, device="cuda")
    assert torch.equal(vmap(ss_ops.ssm_scan)(da, bx, c),
                       per_lane(ss_ops.ssm_scan, (da, bx, c), (0, 0, 0)))
    r, kk, vv = (torch.randn(lanes, 1, 200, 4, 64, generator=g,
                             device="cuda") for _ in range(3))
    lw = -torch.rand(lanes, 1, 200, 4, 64, generator=g, device="cuda")
    u = torch.randn(4, 64, generator=g, device="cuda")
    dims = (0, 0, 0, 0, None)
    assert torch.equal(vmap(wk_ops.wkv6, in_dims=dims)(r, kk, vv, lw, u),
                       per_lane(wk_ops.wkv6, (r, kk, vv, lw, u), dims))
    x = torch.randint(-127, 128, (lanes, 64, 147), generator=g,
                      device="cuda").to(torch.int8)
    w = torch.randint(-127, 128, (lanes, 147, 80), generator=g,
                      device="cuda").to(torch.int8)
    s = torch.rand(80, generator=g, device="cuda")
    for dims in ((0, None), (0, 0)):
        ww = w[0] if dims[1] is None else w
        before = _launches()["int8_matmul"]
        got = vmap(im_ops.int8_matmul_i32, in_dims=dims)(x, ww)
        assert _launches()["int8_matmul"] - before == \
            (1 if dims[1] is None else lanes)     # fold into M, or a loop
        assert torch.equal(got, per_lane(im_ops.int8_matmul_i32, (x, ww),
                                         dims))
        got = vmap(lambda a, b: im_ops.int8_matmul(a, b, s),
                   in_dims=dims)(x, ww)
        assert torch.equal(got, per_lane(
            lambda a, b: im_ops.int8_matmul(a, b, s), (x, ww), dims))


@pytest.mark.gpu
def test_capture_raises_when_a_graph_exec_artifact_syncs(cuda):
    """An artifact that reads a value back to the host cannot be captured:
    fuse raises, keeps no graph and leaves the launch counts as they were;
    nothing falls back to an uncaptured run."""
    t = {"x": TensorDesc("x", (4, 4), "float32", "input"),
         "y": TensorDesc("y", (4, 4), "float32", "scratch"),
         "output": TensorDesc("output", (4, 4), "float32", "output")}
    prog = RCBProgram("ge_sync", t, [RCB(0, "layer", (), (
        RCBOp(Op.GRAPH_EXEC, ("y",), ("x",), {"artifact": "scale_by_sum"}),
        RCBOp(Op.RELU, ("output",), ("y",))))],
        {"scale_by_sum": lambda x: x * float(x.sum())})   # host read
    prog.validate()
    ex = Executor(device="cuda")
    bound = rbl.bind(prog, driver=ex.driver)
    x = {"x": np.ones((4, 4), np.float32)}
    np.testing.assert_array_equal(ex.run(bound, inputs=x)["output"].cpu(),
                                  np.full((4, 4), 16.0, np.float32))
    fused = ex.fuse(bound)
    before = _launches()
    with pytest.raises(RuntimeError):
        fused(x, ex.weights_from(bound))
    assert fused.graphs == {} and _launches() == before
    assert ex.run(bound, inputs=x)["output"].sum().item() == 256.0
