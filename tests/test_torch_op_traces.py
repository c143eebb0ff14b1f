"""The executor's per-op traces (``Executor.op_traces``, ``OpTrace``) on the
CPU against the JAX package's: on the Table 4 program
(``compile_matmul(64, with_dma=True)``) and on a ResNet-18 smoke program,
both compiled by the JAX package and run from its bytes, the
``(block_id, op)`` sequence of ``run(trace_ops=True)`` and of
``run_interpreted(trace_ops=True)`` equals the JAX Executor's; the traced
outputs equal the untraced ones bit for bit, ``probe=`` still fills, and
the RTPM's per-block events still post."""
import functools

import jax
import numpy as np
import pytest

from repro.configs.resnet18 import CONFIG as JAX_RESNET
from repro.core import rctc as jax_rctc
from repro.core import rimfs as jax_rimfs
from repro.core.executor import Executor as JaxExecutor
from repro.core.rtpm import Platform as JaxPlatform
from repro.models import resnet as jax_rn
from repro_torch.core.executor import Executor, OpTrace
from repro_torch.core.rcb import Op
from repro_torch.core.rtpm import Platform
from repro_torch.dtypes import to_host

RESNET_TOL = 1e-5                 # test_resnet_rcb.py:31


@functools.lru_cache(maxsize=None)
def _programs():
    """name -> (program bytes, image bytes, inputs), all from the JAX
    package."""
    rng = np.random.RandomState(0)
    a = rng.randn(64, 64).astype(np.float32)
    b = rng.randn(64, 64).astype(np.float32)
    mm = jax_rctc.compile_matmul(64, with_dma=True)
    cfg = JAX_RESNET.smoke()
    params = jax_rn.init_resnet(jax.random.PRNGKey(0), cfg)
    rn_prog, rn_image = jax_rctc.compile_resnet18(cfg,
                                                  jax_rn.fold_bn(params))
    x = rng.rand(1, cfg.image_size, cfg.image_size, 3).astype(np.float32)
    return {"matmul": (mm.encode(), jax_rimfs.pack({"b": b}), {"a": a}),
            "resnet18": (rn_prog.encode(), rn_image, {"input": x})}


def _jax_traced(name, mode):
    prog_bytes, image, inputs = _programs()[name]
    plat = JaxPlatform()
    plat.provision(image=image, program_bytes=prog_bytes)
    ex = JaxExecutor(rtpm=plat)
    bound = plat.bind(inputs=inputs)
    run = ex.run if mode == "run" else ex.run_interpreted
    out = run(bound, trace_ops=True)
    return ex.op_traces, {k: np.asarray(v) for k, v in out.items()}


def _port(name):
    prog_bytes, image, inputs = _programs()[name]
    plat = Platform(device="cpu")
    plat.provision(image=image, program_bytes=prog_bytes)
    ex = Executor(driver=plat.driver, rtpm=plat)
    return plat, ex, plat.bind(inputs=inputs)


def _sequence(traces) -> list:
    return [(t.block_id, t.op.name) for t in traces]


@pytest.mark.parametrize("mode", ["run", "run_interpreted"])
@pytest.mark.parametrize("name", ["matmul", "resnet18"])
def test_op_traces_follow_the_jax_executor(name, mode):
    want, jout = _jax_traced(name, mode)
    plat, ex, bound = _port(name)
    assert ex.op_traces == []
    run = ex.run if mode == "run" else ex.run_interpreted
    out = run(bound, trace_ops=True)
    got = ex.op_traces
    assert _sequence(got) == _sequence(want)
    assert all(isinstance(t, OpTrace) and isinstance(t.op, Op)
               and t.seconds >= 0.0 for t in got)
    if name == "matmul":
        assert [t.op for t in got if t.op != Op.HALT][:3] == [
            Op.DMA_H2D, Op.GEMM, Op.DMA_D2H]
    for k, v in jout.items():
        np.testing.assert_allclose(to_host(out[k]), v, rtol=RESNET_TOL,
                                   atol=RESNET_TOL)
    # the list is the caller's to clear; a second run appends again
    run(bound, trace_ops=True)
    assert _sequence(ex.op_traces) == _sequence(want) * 2


@pytest.mark.parametrize("name", ["matmul", "resnet18"])
def test_traced_outputs_equal_untraced_and_probe_fills(name):
    plat, ex, bound = _port(name)
    # a traced run is an interpreted one: its probe is held against the
    # untraced interpreted run's (the linked run probes its own slots)
    want_probe: dict = {}
    want = ex.run_interpreted(bound, probe=want_probe)
    assert want_probe
    for k, v in ex.run(bound).items():
        assert np.array_equal(to_host(v), to_host(want[k]))
    posted = len(plat.telemetry._metrics)
    for mode in ("run", "run_interpreted"):
        probe: dict = {}
        ex.op_traces.clear()
        run = ex.run if mode == "run" else ex.run_interpreted
        got = run(bound, trace_ops=True, probe=probe)
        assert got.keys() == want.keys()
        for k in want:
            assert np.array_equal(to_host(got[k]), to_host(want[k]))
        assert probe.keys() == want_probe.keys()
        for k in want_probe:
            assert probe[k] == want_probe[k]
        assert len(ex.op_traces) == sum(1 for _ in bound.program.ops())
    # every block of each traced run posted its rcb_complete
    blocks = [m["block"] for m in list(plat.telemetry._metrics)[posted:]]
    assert blocks == [b.block_id for b in bound.program.blocks] * 2


def test_untraced_run_records_nothing():
    plat, ex, bound = _port("matmul")
    ex.run(bound)
    ex.run_interpreted(bound)
    assert ex.op_traces == []


def test_the_dma_input_stays_on_the_host_until_its_op():
    """The Table 4 program's input is read by its DMA_H2D only: the
    interpreted run hands the op the host array, so its trace times the
    transfer (the linked run moves it before the walk)."""
    plat, ex, bound = _port("matmul")
    seen = []
    inner = plat.driver.initiate_dma

    def spy(buf, direction):
        seen.append((direction, type(buf).__name__))
        return inner(buf, direction)

    plat.driver.initiate_dma = spy
    ex.run(bound, trace_ops=True)
    assert seen == [("h2d", "ndarray"), ("d2h", "Tensor")]
