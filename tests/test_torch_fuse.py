"""The port's fused path on the CPU: ``Executor.fuse`` (uncaptured on the
CPU: the same staged callable a CUDA graph captures on the card) over the
JAX package's own program bytes, held against the JAX package's
``Executor.fuse`` (1e-5 per fp32 opcode, 5e-4 for the fp32 LM program,
exact for ``MATMUL_INT8``) and against the port's linked ``run`` bit for
bit; the fused callable's cache; ``stage_callable`` over the capture
driver, which syncs nothing and passes FENCE, DMA and GRAPH_EXEC through."""
import numpy as np
import pytest
import torch

from repro.core import rbl as jax_rbl
from repro.core import rctc as jax_rctc
from repro.core import rimfs as jax_rimfs
from repro.core.executor import Executor as JaxExecutor
from repro_torch.configs import get_config
from repro_torch.core import linker, rbl, rctc, rhal, rimfs
from repro_torch.core.executor import Executor, FusedProgram
from repro_torch.core.rcb import RCBProgram
from repro_torch.models import transformer as tf
from test_torch_batched import TOL as BATCHED_TOL
from test_torch_batched import jax_program

SEQ = 8
# the programs of tests/test_torch_batched.py, the one-op MATMUL_INT8 with
# its FENCE among them, at the same tolerances
TOL = {k: BATCHED_TOL[k] for k in ("conv_relu_softmax", "resnet18",
                                   "qwen2_2layer", "matmul_int8")}


@pytest.mark.parametrize("name", sorted(TOL))
def test_fuse_matches_the_jax_package_fuse_and_the_linked_run(name):
    rng = np.random.RandomState(3)
    jprog, jimage, request = jax_program(name, rng)
    req = request(rng)
    jfs = jax_rimfs.mount(jimage) if jimage is not None else None
    jex = JaxExecutor()
    jbound = jax_rbl.bind(jprog, rimfs=jfs)
    want = {k: np.asarray(v) for k, v in jex.fuse(jbound)(
        dict(req), jex.weights_from(jbound)).items()}
    ex = Executor(device="cpu")
    bound = rbl.bind(RCBProgram.decode(jprog.encode()),
                     rimfs=rimfs.mount(jimage) if jimage else None,
                     driver=ex.driver)
    fused = ex.fuse(bound)
    got = fused(dict(req), ex.weights_from(bound))
    linked = ex.run(bound, inputs=dict(req))
    assert sorted(got) == sorted(want) == sorted(linked)
    for k, v in want.items():
        assert torch.equal(got[k], linked[k])
        assert got[k].numpy().dtype == v.dtype
        if TOL[name] == 0.0:
            np.testing.assert_array_equal(got[k].numpy(), v)
        else:
            np.testing.assert_allclose(got[k].numpy(), v, rtol=0,
                                       atol=TOL[name])


@pytest.mark.parametrize("family", ["hymba-1.5b-smoke", "rwkv6-1.6b-smoke"])
def test_fuse_runs_graph_exec_artifacts_like_the_linked_run(family):
    cfg = get_config(family)
    params = tf.init_params(cfg, 0, device="cpu")
    prog, image = rctc.compile_transformer_block(cfg, params, 1, SEQ)
    ex = Executor(device="cpu")
    bound = rbl.bind(prog, rimfs=rimfs.mount(image), driver=ex.driver)
    rng = np.random.RandomState(0)
    req = {"hidden": rng.randn(1, SEQ, cfg.d_model).astype(np.float32)}
    if cfg.family != "ssm":
        req["positions"] = np.arange(SEQ, dtype=np.int32)[None].copy()
    got = ex.fuse(bound)(req, ex.weights_from(bound))
    want = ex.run(bound, inputs=req)
    assert torch.equal(got["logits"], want["logits"])


def _conv(seed=0):
    prog = rctc.compile_conv_relu_softmax()
    w = np.random.RandomState(seed).randn(3, 3, 3, 9).astype(np.float32)
    return prog, rimfs.mount(rimfs.pack({"w_conv": w}))


def test_fuse_is_cached_on_the_bound_program_by_donate_weights():
    prog, fs = _conv()
    ex = Executor(device="cpu")
    bound = rbl.bind(prog, rimfs=fs, driver=ex.driver)
    f1 = ex.fuse(bound)
    assert isinstance(f1, FusedProgram)
    assert ex.fuse(bound) is f1
    assert Executor(driver=ex.driver).fuse(bound) is f1   # rides the bound
    fd = ex.fuse(bound, donate_weights=True)
    assert fd is not f1 and ex.fuse(bound, donate_weights=True) is fd
    bound.program = rctc.compile_conv_relu_softmax()      # swapped out
    assert ex.fuse(bound) is not f1
    Executor.release_graphs(bound)
    assert bound._fused is None


def test_fuse_computes_with_the_weights_it_is_given():
    """A graph belongs to one set of weight tensors: other weights never
    replay a stale one (on the card they capture anew)."""
    prog, fs = _conv()
    ex = Executor(device="cpu")
    bound = rbl.bind(prog, rimfs=fs, driver=ex.driver)
    x = {"input": np.random.RandomState(1).randn(1, 8, 8, 3)
         .astype(np.float32)}
    fused = ex.fuse(bound)
    w = ex.weights_from(bound)
    other = {"w_conv": w["w_conv"] * -1.5}
    a = fused(x, w)["output"]
    b = fused(x, other)["output"]
    want = ex.run(rbl.rebind(bound, buffers=other), inputs=x)["output"]
    assert torch.equal(b, want) and not torch.equal(a, b)
    with pytest.raises(ValueError, match="missing input 'input'"):
        fused({}, w)


def test_capture_driver_syncs_nothing_and_passes_dma_and_fence():
    """The JAX package's DMA pipeline program (split-phase prefetch and
    drain, FENCEs) staged over the capture driver equals the eager linked
    run; the driver counts no sync, no fence and no CRC check."""
    n, stages = 16, 3
    jprog = jax_rctc.compile_dma_pipeline(stages, n=n)
    rng = np.random.RandomState(2)
    image = jax_rimfs.pack({"b": (rng.randn(n, n) / n).astype(np.float32)})
    ins = {f"in{i}": torch.from_numpy(rng.randn(n, n).astype(np.float32))
           for i in range(stages)}
    prog = RCBProgram.decode(jprog.encode())
    ex = Executor(device="cpu")
    bound = rbl.bind(prog, rimfs=rimfs.mount(image), driver=ex.driver)
    want = ex.run(bound, inputs=dict(ins))
    drv = rhal.make_capture_driver("cpu")
    linked = linker.link(bound, drv)
    assert linked.input_slots == {s: linked.slot_of[s] for s in ins}
    assert linked.weight_slots == {"b": linked.slot_of["b"]}
    assert linked.n_slots == len(prog.tensors)
    got = linker.stage_callable(linked)(ins, ex.weights_from(bound))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k])
    assert not {"fence", "dma_wait", "dma_crc_checked"} & set(drv.stats)
    assert drv.arena is None


def test_capture_driver_makes_each_constant_once():
    drv = rhal.make_capture_driver("cpu")
    value = [1.0, 2.0]
    first = drv.bind_const(value)
    assert drv.bind_const(value) is first
    assert torch.equal(first, torch.tensor([1.0, 2.0]))
    assert drv.bind_const([1.0, 2.0]) is not first
    buf = torch.ones(3)
    copy = drv.wait_dma(drv.initiate_dma(buf, "d2h"))
    assert torch.equal(copy, buf) and copy.data_ptr() != buf.data_ptr()
    t = drv.dma_async(buf, "h2d")
    assert drv.dma_wait(t) is t.buf
    with pytest.raises(rhal.DmaError):
        drv.dma_wait(t)                               # redeemed twice
