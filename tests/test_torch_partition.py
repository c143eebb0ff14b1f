"""Partitioned execution in the port against the JAX package, on the CPU.

The partition is data: over the conformance corpus (the port's
counterparts of tests/test_conformance.py's ``_corpus``) at 1, 2 and 4
tile groups, the cut-edge table (symbol, src, dst, bytes), ``cut_bytes``
and every tile program's ``encode()`` bytes equal the JAX package's
``partition``. ``run_partitioned`` equals the port's own ``Executor.run``
bit for bit, and the JAX package's ``run_partitioned`` within the ground
rules: exact for data movement, 1e-5 for fp32 ops, 5e-4 on fp32 LM
programs (tests/test_conformance.py:700). It holds for the corpus,
ResNet-18 smoke in fp32 and INT8, qwen2-1.5b-smoke at 2 fp32 layers, and
hymba-1.5b-smoke and rwkv6-1.6b-smoke with their GRAPH_EXEC artifacts at
2 groups; and for the reference's regressions (weights reused without an
image, the bounded bind cache, a deterministic cut, ``execute_stream`` in
order and equal to serial). The CPU has no streams, so the stream order is
held by tests/test_torch_partition_gpu.py on the card.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config as jax_get_config
from repro.configs.resnet18 import CONFIG as JAX_RESNET
from repro.core import partition as jax_partition
from repro.core import quant as jax_quant
from repro.core import rbl as jax_rbl
from repro.core import rctc as jax_rctc
from repro.core import rhal as jax_rhal
from repro.core import rimfs as jax_rimfs
from repro.core.executor import Executor as JaxExecutor
from repro.core.rcb import (Op as JOp, RCB as JRCB, RCBOp as JRCBOp,
                            RCBProgram as JRCBProgram,
                            TensorDesc as JTensorDesc)
from repro.models import resnet as jax_rn
from repro.models import transformer as jax_tf
from repro.models.common import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.configs.resnet18 import CONFIG as RESNET
from repro_torch.core import partition, rbl, rctc, rhal, rimfs
from repro_torch.core.executor import Executor
from repro_torch.core.rcb import Op, RCB, RCBOp, RCBProgram, TensorDesc
from repro_torch.models import resnet as rn
from repro_torch.models import transformer as tf

TILE_COUNTS = (1, 2, 4)
OP_ATOL = 1e-5                     # one fp32 op: tests/test_torch_oplib.py
LM_ATOL = 5e-4                     # fp32 LM program: test_conformance.py:700


def _quant_mix(ns):
    """tests/test_conformance.py's QUANTIZE/DEQUANT + ALLOC/FREE + explicit
    DMA program, built from either package's RCB classes ``ns``."""
    Op_, RCB_, RCBOp_, RCBProgram_, TensorDesc_ = ns
    t = {
        "x": TensorDesc_("x", (8, 8), "float32", "input"),
        "w": TensorDesc_("w", (8, 8), "float32", "weight"),
        "xd": TensorDesc_("xd", (8, 8), "float32", "scratch"),
        "g": TensorDesc_("g", (8, 8), "float32", "scratch"),
        "q": TensorDesc_("q", (8, 8), "int8", "scratch"),
        "dq": TensorDesc_("dq", (8, 8), "float32", "scratch"),
        "s": TensorDesc_("s", (8, 8), "float32", "scratch"),
        "a": TensorDesc_("a", (8, 8), "float32", "scratch"),
        "output": TensorDesc_("output", (8, 8), "float32", "output"),
    }
    blocks = [
        RCB_(0, "layer", (), (
            RCBOp_(Op_.DMA_H2D, ("xd",), ("x",)),
            RCBOp_(Op_.GEMM, ("g",), ("xd", "w")),
        )),
        RCB_(1, "layer", (0,), (
            RCBOp_(Op_.QUANTIZE, ("q",), ("g",), {"scale": 0.05}),
            RCBOp_(Op_.DEQUANT, ("dq",), ("q",), {"scale": 0.05}),
        )),
        RCB_(2, "layer", (1,), (
            RCBOp_(Op_.ALLOC, ("s",), (), {"shape": [8, 8],
                                           "dtype": "float32"}),
            RCBOp_(Op_.ADD, ("a",), ("dq", "s")),
            RCBOp_(Op_.FREE, ("s",)),
            RCBOp_(Op_.RELU, ("output",), ("a",)),
            RCBOp_(Op_.FENCE),
        )),
    ]
    prog = RCBProgram_("quant_mix", t, blocks)
    prog.validate()
    return prog


JAX_NS = (JOp, JRCB, JRCBOp, JRCBProgram, JTensorDesc)
PORT_NS = (Op, RCB, RCBOp, RCBProgram, TensorDesc)


@functools.lru_cache(maxsize=None)
def _corpus():
    """name -> (JAX program, port program, weight files, inputs,
    exact): the reference corpus from the same seed."""
    rng = np.random.RandomState(0)
    n, k = 16, 4
    out = {}

    def add(name, jprog, prog, files, inputs, exact=False):
        out[name] = (jprog, prog, files, inputs, exact)

    add("matmul_dma", jax_rctc.compile_matmul(n, with_dma=True),
        rctc.compile_matmul(n, with_dma=True),
        {"b": rng.randn(n, n).astype(np.float32)},
        {"a": rng.randn(n, n).astype(np.float32)})
    add("conv_relu_softmax", jax_rctc.compile_conv_relu_softmax(),
        rctc.compile_conv_relu_softmax(),
        {"w_conv": rng.randn(3, 3, 3, 9).astype(np.float32)},
        {"input": rng.randn(1, 8, 8, 3).astype(np.float32)})
    add("dma_pipeline", jax_rctc.compile_dma_pipeline(k, n),
        rctc.compile_dma_pipeline(k, n),
        {"b": rng.randn(n, n).astype(np.float32)},
        {f"in{i}": rng.randn(n, n).astype(np.float32) for i in range(k)})
    add("transfer_stream", jax_rctc.compile_transfer_pipeline(k, 256),
        rctc.compile_transfer_pipeline(k, 256), {},
        {f"in{i}": rng.randn(256).astype(np.float32) for i in range(k)},
        exact=True)
    add("gemm_chain", jax_rctc.compile_gemm_chain(5, n),
        rctc.compile_gemm_chain(5, n), rctc.gemm_chain_weights(5, n),
        {"input": rng.randn(n, n).astype(np.float32)})
    add("quant_mix", _quant_mix(JAX_NS), _quant_mix(PORT_NS),
        {"w": rng.randn(8, 8).astype(np.float32)},
        {"x": rng.randn(8, 8).astype(np.float32)})
    return out


CORPUS = ("matmul_dma", "conv_relu_softmax", "dma_pipeline",
          "transfer_stream", "gemm_chain", "quant_mix")


def _jax_bound(jprog, files, inputs=None):
    fs = jax_rimfs.mount(jax_rimfs.pack(files)) if files else None
    return jax_rbl.bind(jprog, rimfs=fs, inputs=dict(inputs or {})), fs


def _port_bound(prog, files, inputs=None, driver=None):
    fs = rimfs.mount(rimfs.pack(files)) if files else None
    return rbl.bind(prog, rimfs=fs, inputs=dict(inputs or {}),
                    driver=driver), fs


def _pinned(fs, driver):
    """The image's residency on ``driver``, looked up without pinning
    more (``RIMFS.resident`` with no names would pin every file)."""
    ref, ri = fs._resident[id(driver)]
    assert ref() is driver
    return ri


def _edge_table(part) -> list:
    return [(e.sym, e.src, e.dst, e.nbytes) for e in part.edges]


def _same(ref: dict, got: dict, label: str) -> None:
    assert sorted(got) == sorted(ref), label
    for k in ref:
        assert torch.equal(got[k], ref[k]), f"{label}: {k} differs"


def _close(jax_out: dict, got: dict, atol: float, label: str) -> None:
    assert sorted(got) == sorted(jax_out), label
    for k, v in jax_out.items():
        want = np.asarray(v)
        have = got[k].numpy()
        assert have.shape == want.shape and have.dtype == want.dtype, label
        if atol == 0:
            np.testing.assert_array_equal(have, want, err_msg=label)
        else:
            np.testing.assert_allclose(have, want, rtol=0, atol=atol,
                                       err_msg=f"{label}: {k}")


# ---------------------------------------------------------------------------
# The partition is data: tables and tile bytes equal the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_groups", TILE_COUNTS)
@pytest.mark.parametrize("name", CORPUS)
def test_cut_table_and_tile_bytes_equal_jax(name, n_groups):
    jprog, prog, files, inputs, _ = _corpus()[name]
    assert prog.encode() == jprog.encode()
    jpart = jax_partition.partition(_jax_bound(jprog, files)[0], n_groups)
    part = partition.partition(_port_bound(prog, files)[0], n_groups)
    assert _edge_table(part) == _edge_table(jpart)
    assert part.cut_bytes() == jpart.cut_bytes()
    assert len(part.tiles) == len(jpart.tiles)
    for t, jt in zip(part.tiles, jpart.tiles):
        assert t.program.encode() == jt.program.encode()
        for field in ("gid", "cut_ins", "cut_outs", "input_syms",
                      "output_syms", "weight_syms"):
            assert getattr(t, field) == getattr(jt, field), field
    # the partition crosses both ways: a JAX tile's bytes run in the port
    for jt in jpart.tiles:
        assert RCBProgram.decode(jt.program.encode()).encode() \
            == jt.program.encode()


# ---------------------------------------------------------------------------
# Outputs: the port's run, and the JAX package's run_partitioned
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_groups", TILE_COUNTS)
@pytest.mark.parametrize("name", CORPUS)
def test_corpus_partitioned_equals_run_and_jax(name, n_groups):
    jprog, prog, files, inputs, exact = _corpus()[name]
    ex = Executor(device="cpu")
    bound, fs = _port_bound(prog, files, inputs, driver=ex.driver)
    ref = ex.run(bound)
    mesh = rhal.TileMesh(n_groups, device="cpu")
    got = ex.run_partitioned(bound, rimfs=fs, mesh=mesh)
    _same(ref, got, f"{name}@{n_groups}")
    part = bound._partitions[mesh.n_groups]
    assert mesh.moved_bytes() == part.cut_bytes()
    jbound, jfs = _jax_bound(jprog, files, inputs)
    jout = JaxExecutor().run_partitioned(jbound, rimfs=jfs,
                                         mesh=jax_rhal.TileMesh(n_groups))
    _close(jout, got, 0 if exact else OP_ATOL, f"{name}@{n_groups} vs JAX")


@functools.lru_cache(maxsize=None)
def _resnet():
    jcfg, cfg = JAX_RESNET.smoke(), RESNET.smoke()
    jparams = jax.tree.map(np.asarray,
                           jax_rn.init_resnet(jax.random.PRNGKey(0), jcfg))
    jfolded = jax_rn.fold_bn(jparams)
    x = np.random.RandomState(1).rand(
        1, cfg.image_size, cfg.image_size, 3).astype(np.float32)
    jpack = jax_quant.quantize_resnet(jcfg, jfolded, x)
    folded = rn.fold_bn(rn.params_from_jax(jparams, device="cpu"))
    return jcfg, cfg, jfolded, folded, jpack, x


@pytest.mark.parametrize("n_groups", TILE_COUNTS)
@pytest.mark.parametrize("int8", [False, True])
def test_resnet18_partitioned_equals_run_and_jax(int8, n_groups):
    jcfg, cfg, jfolded, folded, jpack, x = _resnet()
    pack = jpack if int8 else None
    jprog, jimage = jax_rctc.compile_resnet18(jcfg, jfolded, batch=1,
                                              int8=pack)
    prog, image = rctc.compile_resnet18(cfg, folded, batch=1, int8=pack)
    assert prog.encode() == jprog.encode() and image == jimage
    fs = rimfs.mount(image)
    ex = Executor(device="cpu")
    bound = rbl.bind(prog, rimfs=fs, inputs={"input": x}, driver=ex.driver)
    ref = ex.run(bound)
    mesh = rhal.TileMesh(n_groups, device="cpu")
    got = ex.run_partitioned(bound, rimfs=fs, mesh=mesh)
    _same(ref, got, f"resnet18 int8={int8} @{n_groups}")
    part = bound._partitions[n_groups]
    jfs = jax_rimfs.mount(jimage)
    jbound = jax_rbl.bind(jprog, rimfs=jfs, inputs={"input": x})
    jmesh = jax_rhal.TileMesh(n_groups)
    jout = JaxExecutor().run_partitioned(jbound, rimfs=jfs, mesh=jmesh)
    jpart = jbound._partitions[n_groups]
    assert _edge_table(part) == _edge_table(jpart)
    assert mesh.moved_bytes() == part.cut_bytes() == jmesh.moved_bytes()
    np.testing.assert_allclose(got["output"].numpy(),
                               np.asarray(jout["output"]), atol=OP_ATOL,
                               rtol=OP_ATOL)    # tests/test_resnet_rcb.py:31
    # every group that ran holds its own tile's weights, pinned once: the
    # groups' pinned files are the image's, each in one arena
    pinned = [_pinned(fs, mesh.group(t.gid).driver).files()
              for t in part.tiles]
    assert sorted(f for p in pinned for f in p) == sorted(
        n for n, t in prog.tensors.items() if t.kind == "weight")
    plans = [t.residency(mesh.group(t.gid).driver) for t in part.tiles]
    assert all(p is not None for p in plans)


LM_MODELS = {"qwen2-1.5b-smoke": (1, 2, 4), "hymba-1.5b-smoke": (2,),
             "rwkv6-1.6b-smoke": (2,)}
B, S = 1, 8


@functools.lru_cache(maxsize=None)
def _lm(name):
    """JAX and port programs and images of ``name`` at 2 fp32 layers, from
    the JAX package's weights, and one request's inputs."""
    jcfg = dataclasses.replace(jax_get_config(name), num_layers=2,
                               dtype="float32")
    cfg = dataclasses.replace(get_config(name), num_layers=2,
                              dtype="float32")
    jparams = jax_init_params(jax.random.PRNGKey(0),
                              jax_tf.model_specs(jcfg))
    jprog, jimage = jax_rctc.compile_transformer_block(jcfg, jparams, B, S)
    params = tf.params_from_jax({k: np.asarray(v)
                                 for k, v in jparams.items()}, device="cpu")
    prog, image = rctc.compile_transformer_block(cfg, params, B, S)
    tokens = np.random.RandomState(3).randint(0, cfg.vocab_size, (B, S))
    glob, _ = tf.split_params(params)
    inputs = {"hidden": tf.embed_inputs(cfg, glob, tokens).numpy()}
    if cfg.family != "ssm":
        inputs["positions"] = np.arange(S, dtype=np.int32)[None].copy()
    return jprog, jimage, prog, image, inputs


@pytest.mark.parametrize("name,n_groups",
                         [(m, n) for m, ns in LM_MODELS.items() for n in ns])
def test_lm_partitioned_equals_run_and_jax(name, n_groups):
    jprog, jimage, prog, image, inputs = _lm(name)
    assert prog.encode() == jprog.encode() and image == jimage
    fs = rimfs.mount(image)
    ex = Executor(device="cpu")
    bound = rbl.bind(prog, rimfs=fs, driver=ex.driver)
    ref = ex.run(bound, inputs=inputs)
    mesh = rhal.TileMesh(n_groups, device="cpu")
    got = ex.run_partitioned(bound, inputs=inputs, rimfs=fs, mesh=mesh)
    _same(ref, got, f"{name}@{n_groups}")
    part = bound._partitions[n_groups]
    assert mesh.moved_bytes() == part.cut_bytes() > (0 if n_groups > 1
                                                     else -1)
    # the GRAPH_EXEC glue rides on every tile
    assert all(t.program.artifacts.keys() == prog.artifacts.keys()
               for t in part.tiles)
    jfs = jax_rimfs.mount(jimage)
    jbound = jax_rbl.bind(jprog, rimfs=jfs)
    jout = JaxExecutor().run_partitioned(jbound, inputs=dict(inputs),
                                         rimfs=jfs,
                                         mesh=jax_rhal.TileMesh(n_groups))
    assert _edge_table(part) == _edge_table(jbound._partitions[n_groups])
    for t, jt in zip(part.tiles, jbound._partitions[n_groups].tiles):
        assert t.program.encode() == jt.program.encode()
    _close(jout, got, LM_ATOL, f"{name}@{n_groups} vs JAX")


# ---------------------------------------------------------------------------
# The reference's regressions
# ---------------------------------------------------------------------------

def _chain(depth, n=8, seed=0):
    prog = rctc.compile_gemm_chain(depth, n)
    fs = rimfs.mount(rimfs.pack(rctc.gemm_chain_weights(depth, n)))
    x = np.random.RandomState(seed).randn(n, n).astype(np.float32)
    return prog, fs, x


def test_partitioned_reuses_bound_weights_without_rimfs():
    prog, fs, x = _chain(4)
    ex = Executor(device="cpu")
    bound = rbl.bind(prog, rimfs=fs, inputs={"input": x}, driver=ex.driver)
    ref = ex.run(bound)
    mesh = rhal.TileMesh(2, device="cpu")
    got = ex.run_partitioned(bound, mesh=mesh)             # no rimfs=
    _same(ref, got, "bound weights @2")
    # nothing was pinned on the groups: the tiles read the bound buffers
    assert not any(g.driver.stats.get("dma_async", 0) > 1
                   for g in mesh.groups)
    part = bound._partitions[2]
    for t in part.tiles:
        bt = t.bind(mesh.group(t.gid).driver)
        for w in t.weight_syms:
            assert bt.buffers[w] is bound.buffers[w]


def test_tile_bind_cache_stays_bounded():
    prog, fs, x = _chain(3)
    ex = Executor(device="cpu")
    bound = rbl.bind(prog, rimfs=fs, inputs={"input": x}, driver=ex.driver)
    ref = ex.run(bound)
    for _ in range(partition._BIND_CACHE_CAP + 4):
        _same(ref, ex.run_partitioned(
            bound, rimfs=fs, mesh=rhal.TileMesh(2, device="cpu")),
            "fresh-mesh loop")
    assert all(len(t._bound) <= partition._BIND_CACHE_CAP
               for t in bound._partitions[2].tiles)


def test_partition_is_deterministic():
    prog, fs, _ = _chain(6)
    bound = rbl.bind(prog, rimfs=fs)
    p1, p2 = partition.partition(bound, 3), partition.partition(bound, 3)
    assert p1.edges == p2.edges
    assert [t.program.encode() for t in p1.tiles] == \
        [t.program.encode() for t in p2.tiles]
    for a, b in zip(p1.tiles, p2.tiles):
        assert a.cut_ins == b.cut_ins and a.cut_outs == b.cut_outs
    assert partition.ensure_partition(bound, 3) \
        is partition.ensure_partition(bound, 3)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("n_groups", TILE_COUNTS)
def test_stream_matches_serial_in_order(n_groups, fused):
    """execute_stream over 7 inputs yields, in submission order, outputs
    bit-identical to 7 serial runs, at depth 1 and 4."""
    prog, fs, _ = _chain(5)
    rng = np.random.RandomState(2)
    xs = [{"input": rng.randn(8, 8).astype(np.float32)} for _ in range(7)]
    ex = Executor(device="cpu")
    bound = rbl.bind(prog, rimfs=fs, driver=ex.driver)
    refs = [ex.run(bound, inputs=x) for x in xs]
    mesh = rhal.TileMesh(n_groups, device="cpu")
    part = partition.partition(bound, n_groups)
    for depth in (1, 4):
        stats: dict = {}
        got = list(partition.execute_stream(part, mesh, iter(xs), rimfs=fs,
                                            depth=depth, fused=fused,
                                            stats=stats))
        assert len(got) == len(xs) == stats["samples"]
        for i, (ref, out) in enumerate(zip(refs, got)):
            _same(ref, out, f"stream@{n_groups}/depth{depth}/sample{i}")
        assert set(stats["busy"]) == {t.gid for t in part.tiles}


def test_stream_resnet18_int8_matches_serial_and_jax():
    jcfg, cfg, jfolded, folded, jpack, _ = _resnet()
    prog, image = rctc.compile_resnet18(cfg, folded, batch=1, int8=jpack)
    fs = rimfs.mount(image)
    rng = np.random.RandomState(5)
    xs = [{"input": rng.rand(1, cfg.image_size, cfg.image_size, 3)
           .astype(np.float32)} for _ in range(4)]
    ex = Executor(device="cpu")
    bound = rbl.bind(prog, rimfs=fs, driver=ex.driver)
    refs = [ex.run(bound, inputs=x) for x in xs]
    part = partition.partition(bound, 2)
    got = list(partition.execute_stream(part, rhal.TileMesh(2, device="cpu"),
                                        iter(xs), rimfs=fs, depth=4))
    for i, (ref, out) in enumerate(zip(refs, got)):
        _same(ref, out, f"resnet-int8-stream/sample{i}")
    jprog, jimage = jax_rctc.compile_resnet18(jcfg, jfolded, batch=1,
                                              int8=jpack)
    jfs = jax_rimfs.mount(jimage)
    jpart = jax_partition.partition(jax_rbl.bind(jprog, rimfs=jfs), 2)
    jgot = list(jax_partition.execute_stream(jpart, jax_rhal.TileMesh(2),
                                             iter(xs), rimfs=jfs, depth=4))
    for j, out in zip(jgot, got):
        _close(j, out, OP_ATOL, "resnet-int8-stream vs JAX")


def test_stream_without_rimfs_reuses_bound_weights():
    prog, fs, _ = _chain(4)
    rng = np.random.RandomState(3)
    xs = [{"input": rng.randn(8, 8).astype(np.float32)} for _ in range(4)]
    ex = Executor(device="cpu")
    bound = rbl.bind(prog, rimfs=fs, driver=ex.driver)
    refs = [ex.run(bound, inputs=x) for x in xs]
    got = list(partition.execute_stream(
        partition.partition(bound, 2), rhal.TileMesh(2, device="cpu"),
        iter(xs)))
    for ref, out in zip(refs, got):
        _same(ref, out, "stream/no-rimfs")


def test_stream_propagates_tile_failure():
    """No re-queue in stream mode: a dead consumer group surfaces as
    TileFailure, fused stages included (the cut-edge stream into it still
    touches its driver)."""
    prog, fs, x = _chain(4)
    bound = rbl.bind(prog, rimfs=fs)
    mesh = rhal.TileMesh(2, device="cpu")
    part = partition.partition(bound, 2)
    list(partition.execute_stream(part, mesh, iter([{"input": x}]),
                                  rimfs=fs))
    mesh.kill(1)
    with pytest.raises(rhal.TileFailure):
        list(partition.execute_stream(part, mesh, iter([{"input": x}] * 3),
                                      rimfs=fs))


def test_prewarm_pins_each_tile_on_its_group():
    prog, fs, x = _chain(4)
    ex = Executor(device="cpu")
    bound = rbl.bind(prog, rimfs=fs, inputs={"input": x}, driver=ex.driver)
    mesh = rhal.TileMesh(2, device="cpu")
    part = partition.ensure_partition(bound, 2)
    partition.prewarm(part, mesh, rimfs=fs)
    for t in part.tiles:
        drv = mesh.group(t.gid).driver
        assert sorted(_pinned(fs, drv).files()) == sorted(t.weight_syms)
        assert t.residency(drv) is not None
    moved = {g.gid: g.driver.stats.get("dma_bytes", 0) for g in mesh.groups}
    _same(ex.run(bound), ex.run_partitioned(bound, rimfs=fs, mesh=mesh),
          "prewarmed")
    # the run re-pinned nothing: only the cut edge's bytes moved
    assert sum(g.driver.stats.get("dma_bytes", 0) for g in mesh.groups) \
        - sum(moved.values()) == part.cut_bytes()
