"""The port's batched dispatch on the CPU: ``Executor.run_batched`` on the
1/2/4/8/16 bucket ladder over the JAX package's own program bytes, held
against the JAX package's per-request ``Executor.run`` (integer outputs
exactly, 1e-5 per fp32 opcode, 5e-4 for the fp32 LM program), the batch
analysis's verdicts and reasons against the JAX package's on its own
bytes, each kernel op's vmap rule against per-lane calls (exactly), the
bucket cache shared across binds, and the server's coalescing of a
backlog."""
import dataclasses
import functools
import threading
import time

import numpy as np
import pytest
import torch
from torch.func import vmap

import jax

from repro.configs import get_config as jax_get_config
from repro.configs.resnet18 import CONFIG as JAX_RESNET
from repro.core import linker as jax_linker
from repro.core import quant as jax_quant
from repro.core import rbl as jax_rbl
from repro.core import rcb as jax_rcb
from repro.core import rctc as jax_rctc
from repro.core import rimfs as jax_rimfs
from repro.core.executor import Executor as JaxExecutor
from repro.core.rcb import RCB as JRCB
from repro.core.rcb import Op as JOp
from repro.core.rcb import RCBOp as JRCBOp
from repro.core.rcb import RCBProgram as JRCBProgram
from repro.core.rcb import TensorDesc as JTensorDesc
from repro.models import resnet as jax_rn
from repro.models import transformer as jax_tf
from repro.models.common import init_params as jax_init_params
from repro_torch.core import linker, rbl, rcb, rctc, rimfs
from repro_torch.core.executor import Executor
from repro_torch.core.rcb import RCBProgram
from repro_torch.kernels import registry
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.int8_matmul import ops as im_ops
from repro_torch.kernels.ssm_scan import ops as ss_ops
from repro_torch.kernels.wkv6 import ops as wk_ops
from repro_torch.serving.server import Client, InferenceServer

BATCH_NS = (1, 3, 5, 8, 17)    # exact buckets, pad-to-bucket, 16 + 1
# 1e-5 per fp32 opcode, 5e-4 for fp32 LM programs
# (tests/test_conformance.py:700), exact for integer programs
TOL = {"conv_relu_softmax": 1e-5, "resnet18": 1e-5, "resnet18_int8": 1e-5,
       "qwen2_2layer": 5e-4, "matmul_int8": 0.0, "gemm_i8": 0.0}
SEQ = 8


def _one_op(op, m, k, n, out):
    """A one-op program of the JAX package: x (and w, scale) are inputs of
    a request, as in tests/test_conformance.py:632-645."""
    t = {"x": JTensorDesc("x", (m, k), "int8", "input"),
         "w": JTensorDesc("w", (k, n), "int8", "input"),
         "out": JTensorDesc("out", (m, n), out, "output")}
    srcs = ("x", "w")
    attrs = {}
    if op is JOp.MATMUL_INT8:
        t["scale"] = JTensorDesc("scale", (n,), "float32", "input")
        srcs, attrs = ("x", "w", "scale"), {"out_dtype": out}
    prog = JRCBProgram(f"k_{op.name.lower()}", t, [JRCB(0, "layer", (), (
        JRCBOp(op, ("out",), srcs, attrs), JRCBOp(JOp.FENCE)))])
    prog.validate()
    return prog


def _resnet(int8):
    jcfg = JAX_RESNET.smoke()
    jfolded = jax_rn.fold_bn(jax.tree.map(
        np.asarray, jax_rn.init_resnet(jax.random.PRNGKey(0), jcfg)))
    pack = None
    if int8:
        calib = np.random.RandomState(1).rand(
            4, jcfg.image_size, jcfg.image_size, 3).astype(np.float32)
        pack = jax_quant.quantize_resnet(jcfg, jfolded, calib)
    jprog, jimage = jax_rctc.compile_resnet18(jcfg, jfolded, batch=1,
                                              int8=pack)
    size = jcfg.image_size

    def request(rng):
        return {"input": rng.rand(1, size, size, 3).astype(np.float32)}
    return jprog, jimage, request


def _qwen2():
    jcfg = dataclasses.replace(jax_get_config("qwen2-1.5b-smoke"),
                               num_layers=2, dtype="float32")
    jparams = jax_init_params(jax.random.PRNGKey(0), jax_tf.model_specs(jcfg))
    jprog, jimage = jax_rctc.compile_transformer_block(jcfg, jparams, 1, SEQ)
    d = jcfg.d_model

    def request(rng):
        return {"hidden": rng.randn(1, SEQ, d).astype(np.float32),
                "positions": np.arange(SEQ, dtype=np.int32)[None].copy()}
    return jprog, jimage, request


def jax_program(name, rng):
    """(JAX program, JAX image or None, ``request(rng)``) for one of the
    programs of ``TOL`` (tests/test_torch_fuse.py takes them too)."""
    if name == "conv_relu_softmax":
        jimage = jax_rimfs.pack(
            {"w_conv": rng.randn(3, 3, 3, 9).astype(np.float32)})

        def request(r):
            return {"input": r.randn(1, 8, 8, 3).astype(np.float32)}
        return jax_rctc.compile_conv_relu_softmax(), jimage, request
    if name in ("resnet18", "resnet18_int8"):
        return _resnet(name == "resnet18_int8")
    if name == "qwen2_2layer":
        return _qwen2()
    m, k, n = 8, 24, 16
    op = JOp.MATMUL_INT8 if name == "matmul_int8" else JOp.GEMM_I8

    def request(r):
        req = {"x": r.randint(-127, 128, (m, k)).astype(np.int8),
               "w": r.randint(-127, 128, (k, n)).astype(np.int8)}
        if op is JOp.MATMUL_INT8:
            req["scale"] = r.rand(n).astype(np.float32)
        return req
    out = "float32" if op is JOp.MATMUL_INT8 else "int32"
    return _one_op(op, m, k, n, out), None, request


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX program, JAX image or None, 17 requests, the JAX package's
    per-request outputs)."""
    rng = np.random.RandomState(7)
    jprog, jimage, request = jax_program(name, rng)
    reqs = [request(rng) for _ in range(max(BATCH_NS))]
    jfs = jax_rimfs.mount(jimage) if jimage is not None else None
    jex, jbound = JaxExecutor(), jax_rbl.bind(jprog, rimfs=jfs)
    want = [{k: np.asarray(v) for k, v in jex.run(
        jbound, inputs=dict(r), rimfs=jfs).items()} for r in reqs]
    return jprog, jimage, reqs, want


def _port_bound(jprog, jimage, ex):
    prog = RCBProgram.decode(jprog.encode())
    fs = rimfs.mount(jimage) if jimage is not None else None
    return rbl.bind(prog, rimfs=fs, driver=ex.driver)


@pytest.mark.parametrize("n", BATCH_NS)
@pytest.mark.parametrize("name", sorted(TOL))
def test_run_batched_matches_jax_per_request_run(name, n):
    jprog, jimage, reqs, want = _case(name)
    ex = Executor(device="cpu")
    bound = _port_bound(jprog, jimage, ex)
    assert linker.batch_analysis(bound).batchable
    outs = ex.run_batched(bound, reqs[:n])
    st = ex.batch_stats
    assert st["batchable"] and st["requests"] == n and len(outs) == n
    assert sum(st["buckets"]) - st["padded"] == n
    assert st["buckets"] == ([16, 1] if n == 17 else [ex._bucket_for(n)])
    for req, got, ref in zip(reqs, outs, want):
        assert sorted(got) == sorted(ref)
        serial = ex.run(bound, inputs=dict(req))
        for k, v in ref.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape
            if TOL[name] == 0.0:
                np.testing.assert_array_equal(got[k], v)
                np.testing.assert_array_equal(got[k], serial[k].numpy())
            else:
                np.testing.assert_allclose(got[k], v, rtol=0,
                                           atol=TOL[name])


def test_max_bucket_clamps_the_ladder():
    jprog, jimage, reqs, want = _case("matmul_int8")
    ex = Executor(device="cpu")
    bound = _port_bound(jprog, jimage, ex)
    outs = ex.run_batched(bound, reqs[:11], max_bucket=4)
    assert ex.batch_stats["buckets"] == [4, 4, 4]
    assert ex.batch_stats["padded"] == 1
    for got, ref in zip(outs, want):
        np.testing.assert_array_equal(got["out"], ref["out"])


def _graph_exec_program(module):
    """tests/test_conformance.py:335-346's GRAPH_EXEC program."""
    t = {"x": module.TensorDesc("x", (4, 4), "float32", "input"),
         "y": module.TensorDesc("y", (4, 4), "float32", "scratch"),
         "output": module.TensorDesc("output", (4, 4), "float32",
                                     "output")}
    return module.RCBProgram("ge", t, [module.RCB(0, "layer", (), (
        module.RCBOp(module.Op.GRAPH_EXEC, ("y",), ("x",),
                     {"artifact": "double"}),
        module.RCBOp(module.Op.RELU, ("output",), ("y",))))])


def _analysis_cases():
    rng = np.random.RandomState(0)
    n = 16
    hymba = jax_get_config("hymba-1.5b-smoke")
    hparams = jax_init_params(jax.random.PRNGKey(0),
                              jax_tf.model_specs(hymba))
    return {
        "matmul_dma": (jax_rctc.compile_matmul(n, with_dma=True),
                       {"b": rng.randn(n, n).astype(np.float32)}),
        "dma_pipeline": (jax_rctc.compile_dma_pipeline(4, n),
                         {"b": rng.randn(n, n).astype(np.float32)}),
        "transfer_stream": (jax_rctc.compile_transfer_pipeline(4, 256), {}),
        "gemm_chain": (jax_rctc.compile_gemm_chain(5, n),
                       jax_rctc.gemm_chain_weights(5, n)),
        "conv_relu_softmax": (jax_rctc.compile_conv_relu_softmax(),
                              {"w_conv": rng.randn(3, 3, 3, 9)
                               .astype(np.float32)}),
        "graph_exec": (_graph_exec_program(jax_rcb), {}),
        "hybrid": jax_rctc.compile_transformer_block(hymba, hparams, 1, 8),
    }


def test_batch_analysis_verdicts_equal_the_jax_package():
    for name, (jprog, files) in _analysis_cases().items():
        jimage = files if isinstance(files, bytes) else (
            jax_rimfs.pack(files) if files else None)
        jfs = jax_rimfs.mount(jimage) if jimage else None
        want = jax_linker.batch_analysis(jax_rbl.bind(jprog, rimfs=jfs))
        prog = RCBProgram.decode(jprog.encode())
        bound = rbl.bind(prog, rimfs=rimfs.mount(jimage) if jimage else None)
        got = linker.batch_analysis(bound)
        assert (got.batchable, got.reason) == (want.batchable,
                                               want.reason), name
        assert linker.batch_analysis(bound) is got          # cached
    assert not got.batchable and "GRAPH_EXEC" in got.reason   # hybrid


def test_refused_program_runs_serially_and_says_why():
    prog = _graph_exec_program(rcb)
    prog.artifacts["double"] = lambda x: x * 2.0
    ex = Executor(device="cpu")
    bound = rbl.bind(prog)
    rng = np.random.RandomState(0)
    batch = [{"x": rng.randn(4, 4).astype(np.float32)} for _ in range(3)]
    outs = ex.run_batched(bound, batch)
    st = ex.batch_stats
    assert not st["batchable"] and "GRAPH_EXEC" in st["reason"]
    assert st["buckets"] == []                   # nothing staged
    for req, got in zip(batch, outs):
        np.testing.assert_array_equal(np.maximum(req["x"] * 2.0, 0),
                                      got["output"].numpy())


def test_bucket_cache_is_shared_across_binds_and_keyed_by_weights():
    prog = rctc.compile_conv_relu_softmax()
    w = np.random.RandomState(0).randn(3, 3, 3, 9).astype(np.float32)
    fs = rimfs.mount(rimfs.pack({"w_conv": w}))
    ex = Executor(device="cpu")
    b1 = rbl.bind(prog, rimfs=fs, driver=ex.driver)
    b2 = rbl.bind(prog, rimfs=fs, driver=ex.driver)    # same resident image
    f1 = ex._batched_callable(b1, 4)
    assert Executor(driver=ex.driver)._batched_callable(b2, 4) is f1
    assert ex._batched_callable(b1, 2) is not f1       # per-bucket staging
    other = rbl.rebind(b1, buffers={"w_conv": torch.from_numpy(w * 2)})
    assert ex._batched_callable(other, 4) is not f1    # other weights
    x = {"input": np.random.RandomState(1).randn(1, 8, 8, 3)
         .astype(np.float32)}
    np.testing.assert_allclose(
        ex.run_batched(other, [x])[0]["output"],
        ex.run(other, inputs=x)["output"].numpy(), rtol=0, atol=1e-5)
    assert Executor.release_graphs(b1) == 2
    assert ex._batched_callable(b2, 4) is not f1       # staged anew


def test_aot_cache_is_bounded():
    saved = dict(Executor._batch_cache)
    try:
        Executor._batch_cache.clear()
        for i in range(Executor._BATCH_CACHE_CAP + 3):
            Executor.aot_cache_put(("k", i), i)
        assert len(Executor._batch_cache) == Executor._BATCH_CACHE_CAP
        assert Executor.aot_cache_get(("k", 0)) is None      # oldest out
        assert Executor.aot_cache_get(("k", 66)) == 66
    finally:
        Executor._batch_cache.clear()
        Executor._batch_cache.update(saved)


# ---------------------------------------------------------------------------
# The kernel ops' vmap rules, against per-lane calls (CPU: plain versions)
# ---------------------------------------------------------------------------

LANES = 3


def _per_lane(fn, args, dims):
    return torch.stack([fn(*(a if d is None else a.select(d, j)
                             for a, d in zip(args, dims)))
                        for j in range(LANES)])


def _launches():
    return {k: w.launches for k, w in registry.launch_counters().items()}


@pytest.mark.parametrize("dims", [(0, 0, 0), (0, None, None), (1, 0, None)])
def test_attention_vmap_rule_folds_lanes_into_b(dims):
    g = torch.Generator().manual_seed(0)
    shapes = ((2, 10, 4, 16), (2, 12, 2, 16), (2, 12, 2, 16))
    args = []
    for shape, d in zip(shapes, dims):
        t = torch.randn(shape, generator=g)
        if d is not None:
            t = torch.stack([torch.randn(shape, generator=g)
                             for _ in range(LANES)], dim=d)
        args.append(t)
    before = _launches()
    for causal in (True, False):
        def fn(q, k, v):
            return fa_ops.flash_attention(q, k, v, causal=causal)
        got = vmap(fn, in_dims=dims)(*args)
        assert torch.equal(got, _per_lane(fn, args, dims))
    assert _launches() == before               # the CPU launches nothing


def test_ssm_scan_vmap_rule_folds_lanes_into_b():
    g = torch.Generator().manual_seed(1)
    da = -torch.rand(LANES, 2, 9, 6, 4, generator=g)
    bx = torch.randn(LANES, 2, 9, 6, 4, generator=g)
    c = torch.randn(2, 9, 4, generator=g)
    dims = (0, 0, None)
    got = vmap(ss_ops.ssm_scan, in_dims=dims)(da, bx, c)
    assert torch.equal(got, _per_lane(ss_ops.ssm_scan, (da, bx, c), dims))


def test_wkv6_vmap_rule_folds_lanes_into_b_and_refuses_a_lane_u():
    g = torch.Generator().manual_seed(2)
    r, k, v = (torch.randn(LANES, 2, 7, 3, 8, generator=g) for _ in range(3))
    lw = -torch.rand(LANES, 2, 7, 3, 8, generator=g)
    u = torch.randn(3, 8, generator=g)
    dims = (0, 0, 0, 0, None)
    got = vmap(wk_ops.wkv6, in_dims=dims)(r, k, v, lw, u)
    assert torch.equal(got, _per_lane(wk_ops.wkv6, (r, k, v, lw, u), dims))
    with pytest.raises(ValueError, match="cannot fold"):
        vmap(wk_ops.wkv6)(r, k, v, lw, u.expand(LANES, 3, 8))


@pytest.mark.parametrize("dims", [(0, None, None), (0, 0, 0), (None, 0, 0),
                                  (0, 0, None)])
def test_int8_matmul_vmap_rules_fold_into_m_or_loop_lanes(dims):
    g = torch.Generator().manual_seed(3)
    m, k, n = 5, 24, 7
    shapes = ((m, k), (k, n), (n,))
    args = []
    for i, (shape, d) in enumerate(zip(shapes, dims)):
        full = (LANES, *shape) if d is not None else shape
        args.append(torch.rand(full, generator=g) if i == 2 else
                    torch.randint(-127, 128, full, generator=g)
                    .to(torch.int8))
    for out in (torch.float32, torch.bfloat16):
        def scaled(x, w, s):
            return im_ops.int8_matmul(x, w, s, out_dtype=out)
        got = vmap(scaled, in_dims=dims)(*args)
        assert got.dtype == out
        assert torch.equal(got, _per_lane(scaled, args, dims))
    got = vmap(im_ops.int8_matmul_i32, in_dims=dims[:2])(*args[:2])
    assert torch.equal(got, _per_lane(im_ops.int8_matmul_i32, args[:2],
                                      dims[:2]))


# ---------------------------------------------------------------------------
# The server's coalescing (the counterpart of
# tests/test_serving_concurrency.py::test_backlog_coalesces_into_batched_dispatch)
# ---------------------------------------------------------------------------

def _conv_image(seed=0):
    w = np.random.RandomState(seed).randn(3, 3, 3, 9).astype(np.float32)
    return rctc.compile_conv_relu_softmax().encode(), rimfs.pack(
        {"w_conv": w})


def _x(seed):
    return np.random.RandomState(seed).randn(1, 8, 8, 3).astype(np.float32)


def _gate_dispatcher(server):
    """Hold the dispatcher at its next item (and keep the idle hook from
    draining around the gate); returns (gate, started)."""
    gate, started = threading.Event(), threading.Event()

    def install():
        # on the dispatcher thread, between items: no call of the old idle
        # hook is under way, so none can admit a request around the gate
        inner, idle = server._loop.handler, server._loop.on_idle

        def gated(item):
            started.set()
            gate.wait(30)
            inner(item)

        server._loop.handler = gated
        server._loop.on_idle = lambda: idle() if gate.is_set() else False

    server.run_on_dispatcher(install)
    return gate, started


def _burst(server, client, xs, name="input"):
    """Send ``xs`` (as input ``name``) while the dispatcher is held;
    release it once every request is queued; return the replies in
    order."""
    gate, started = _gate_dispatcher(server)
    rids = [client.infer_async(**{name: x}) for x in xs]
    assert started.wait(10)
    deadline = time.monotonic() + 10
    while server.scheduler.pending() < len(xs) and \
            time.monotonic() < deadline:
        time.sleep(0.005)
    assert server.scheduler.pending() == len(xs)
    gate.set()
    return [client.result(rid, timeout=60) for rid in rids]


def _serve(prog_bytes, image, **kw):
    server = InferenceServer(device="cpu", max_queue=32, **kw)
    client = Client(server.start())
    assert client.provision(image, prog_bytes) == {"status": "ready"}
    return server, client


def test_backlog_coalesces_into_one_batched_dispatch():
    prog_bytes, image = _conv_image()
    xs = [_x(40 + i) for i in range(6)]
    server, client = _serve(prog_bytes, image)
    try:
        refs = [client.infer(input=x)["output"] for x in xs]
        assert server.batched_stats["dispatches"] == 0   # solos stay solo
        outs = [r["output"] for r in _burst(server, client, xs)]
        tel = client.telemetry()["serving"]["batched"]
    finally:
        client.close()
        server.stop()
    for out, ref in zip(outs, refs):
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    st = server.batched_stats
    assert st["dispatches"] == 1 and st["requests"] == 6
    assert st["max_batch"] == 6 <= server.batch_window
    assert st["fallbacks"] == 0 and st["seconds"] > 0
    assert tel["dispatches"] == 1 and tel["batchable"]
    assert tel["reason"] == "batchable"


def test_batch_window_of_one_and_a_mixed_signature_split():
    prog_bytes, image = _conv_image()
    server, client = _serve(prog_bytes, image, batch_window=1)
    try:
        _burst(server, client, [_x(1), _x(2), _x(3)])
        assert server.batched_stats["dispatches"] == 0
    finally:
        client.close()
        server.stop()
    sig = InferenceServer._tensor_sig
    a = {"input": _x(1)}
    assert sig(a) == sig({"input": _x(2)})
    assert sig(a) != sig({"input": _x(1).astype(np.float64)})
    assert sig(a) != sig({"input": np.zeros((1, 8, 8, 4), np.float32)})


def test_refused_program_is_served_serially_and_reported():
    prog = _graph_exec_program(rcb)
    xs = [np.random.RandomState(i).randn(4, 4).astype(np.float32)
          for i in range(3)]
    server, client = _serve(prog.encode(), rimfs.pack({}),
                            artifacts={"double": lambda x: x * 2.0})
    try:
        outs = _burst(server, client, xs, name="x")
        tel = client.telemetry()["serving"]["batched"]
    finally:
        client.close()
        server.stop()
    for x, out in zip(xs, outs):
        np.testing.assert_array_equal(out["output"], np.maximum(x * 2, 0))
    assert tel["dispatches"] == 0 and not tel["batchable"]
    assert "GRAPH_EXEC" in tel["reason"]


def test_failed_batched_dispatch_is_retried_counted_and_posted():
    prog_bytes, image = _conv_image()
    xs = [_x(60 + i) for i in range(3)]
    server, client = _serve(prog_bytes, image)
    try:
        def broken(*a, **kw):
            raise RuntimeError("batched dispatch failed on purpose")
        server.executor.run_batched = broken
        outs = [r["output"] for r in _burst(server, client, xs)]
        tel = client.telemetry()
    finally:
        client.close()
        server.stop()
    ex = Executor(device="cpu")
    prog = RCBProgram.decode(prog_bytes)
    bound = rbl.bind(prog, rimfs=rimfs.mount(image), driver=ex.driver)
    for x, out in zip(xs, outs):
        np.testing.assert_array_equal(
            out, ex.run(bound, inputs={"input": x})["output"].numpy())
    assert server.batched_stats["fallbacks"] == 3
    assert server.batched_stats["dispatches"] == 0
    assert tel["serving"]["batched"]["fallbacks"] == 3
    assert tel["counters"]["batched_fallbacks"] == 3


def test_reprovision_drops_the_graphs_of_the_old_weights():
    prog_bytes, image = _conv_image(0)
    server, client = _serve(prog_bytes, image)
    try:
        _burst(server, client, [_x(1), _x(2), _x(3)])
        old = server._bound
        crc = old.program.crc()
        wkey = tuple((k, v.data_ptr()) for k, v in sorted(
            Executor(device="cpu").weights_from(old).items()))

        def held():
            return [k for k in Executor._batch_cache
                    if k[0] == crc and k[3] == wkey]
        assert len(held()) == 1                    # bucket 4
        prog1, image1 = _conv_image(1)
        assert client.provision(image1, prog1) == {"status": "ready"}
        assert held() == []
        outs = _burst(server, client, [_x(4), _x(5)])
    finally:
        client.close()
        server.stop()
    ex = Executor(device="cpu")
    _, image1 = _conv_image(1)
    bound = rbl.bind(RCBProgram.decode(prog_bytes),
                     rimfs=rimfs.mount(image1), driver=ex.driver)
    for x, out in zip((_x(4), _x(5)), outs):
        np.testing.assert_allclose(
            out["output"], ex.run(bound, inputs={"input": x})[
                "output"].numpy(), rtol=0, atol=1e-5)
