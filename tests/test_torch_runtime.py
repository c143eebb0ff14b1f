"""The dense LM slice through the port's runtime, on qwen2-1.5B smoke (fp32,
2 layers, B=2, S=8) with the JAX package's weights carried across: the same
program and image bytes from the port's compiler, the same logits from the
port's linked and interpreted executors on the JAX bytes (atol 5e-4, as
tests/test_conformance.py holds the JAX runtime), provision and bind through
the port's Platform, and the RHAL driver's residency and DMA integrity."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config as jax_get_config
from repro.core import rbl as jax_rbl
from repro.core import rctc as jax_rctc
from repro.core import rimfs as jax_rimfs
from repro.core.executor import Executor as JaxExecutor
from repro.models import transformer as jax_tf
from repro.models.common import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.core import rbl, rctc, rhal, rimfs
from repro_torch.core.executor import Executor
from repro_torch.core.integrity import IntegrityError
from repro_torch.core.rcb import Op, RCBProgram
from repro_torch.core.rtpm import Platform
from repro_torch.models import transformer as tf

B, S = 2, 8
ATOL = 5e-4                                   # tests/test_conformance.py:700


def _configs(dtype):
    return (dataclasses.replace(jax_get_config("qwen2-1.5b-smoke"),
                                dtype=dtype),
            dataclasses.replace(get_config("qwen2-1.5b-smoke"), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _carry(dtype):
    """JAX params, program and image, plus the port's from the same
    weights, and one request's inputs."""
    jcfg, cfg = _configs(dtype)
    jparams = jax_init_params(jax.random.PRNGKey(0), jax_tf.model_specs(jcfg))
    jprog, jimage = jax_rctc.compile_transformer_block(jcfg, jparams, B, S)
    params = tf.params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                                device="cpu")
    prog, image = rctc.compile_transformer_block(cfg, params, B, S)
    tokens = np.random.RandomState(1).randint(0, cfg.vocab_size, (B, S))
    glob, _ = tf.split_params(params)
    inputs = {"hidden": tf.embed_inputs(cfg, glob, tokens),
              "positions": np.broadcast_to(
                  np.arange(S, dtype=np.int32)[None], (B, S)).copy()}
    jglob, _ = jax_tf.split_params(jparams)
    jhidden = np.asarray(jax_tf.embed_inputs(jcfg, jglob, tokens))
    return dict(cfg=cfg, jcfg=jcfg, jprog=jprog, jimage=jimage, prog=prog,
                image=image, params=params, inputs=inputs, jhidden=jhidden)


@pytest.fixture(params=["float32", "bfloat16"])
def carried(request):
    return _carry(request.param)


def test_params_carry_across_bit_for_bit(carried):
    jparams = jax_init_params(jax.random.PRNGKey(0),
                              jax_tf.model_specs(carried["jcfg"]))
    for name, t in carried["params"].items():
        want = np.asarray(jparams[name])
        got = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
        assert got.tobytes() == want.tobytes(), name
    specs = tf.model_specs(carried["cfg"])
    assert sorted(specs) == sorted(carried["params"])
    assert {k: s.shape for k, s in specs.items()} == \
        {k: tuple(v.shape) for k, v in carried["params"].items()}


def test_embedding_matches_jax(carried):
    hidden = carried["inputs"]["hidden"]
    got = hidden.view(torch.int16).numpy() if hidden.dtype == torch.bfloat16 \
        else hidden.numpy()
    assert got.tobytes() == carried["jhidden"].tobytes()


def test_compiler_emits_the_jax_program_and_image_bytes(carried):
    assert carried["prog"].encode() == carried["jprog"].encode()
    assert carried["prog"].encode(version=1) == \
        carried["jprog"].encode(version=1)
    assert carried["image"] == carried["jimage"]


def _jax_logits(carried):
    fs = jax_rimfs.mount(carried["jimage"])
    ins = {"hidden": carried["jhidden"],
           "positions": carried["inputs"]["positions"]}
    out = JaxExecutor().run(jax_rbl.bind(carried["jprog"], rimfs=fs,
                                         inputs=ins))["logits"]
    return np.asarray(out, np.float32)


def test_port_runs_the_jax_bytes_like_jax():
    carried = _carry("float32")     # bf16 rounds at other places in the two
    prog = RCBProgram.decode(carried["jprog"].encode())
    fs = rimfs.mount(carried["jimage"])
    ex = Executor(device="cpu")
    bound = rbl.bind(prog, rimfs=fs, driver=ex.driver)
    linked = ex.run(bound, inputs=carried["inputs"])["logits"]
    interp = ex.run_interpreted(bound, inputs=carried["inputs"])["logits"]
    assert linked.dtype == torch.float32
    assert tuple(linked.shape) == (B, S, carried["cfg"].vocab_size)
    assert torch.equal(linked, interp)
    np.testing.assert_allclose(linked.numpy(), _jax_logits(carried),
                               rtol=0, atol=ATOL)


def test_platform_provisions_and_binds(carried):
    """Provision over the bytes (CRC before parse, every file's CRC), bind
    on the platform's driver, run: linked, interpreted and the program with
    ``impl="ref"`` attention all agree bit for bit on the CPU."""
    plat = Platform(device="cpu")
    plat.provision(image=carried["jimage"],
                   program_bytes=carried["jprog"].encode())
    assert plat.program.encode() == carried["jprog"].encode()
    assert plat.rimfs.fsck()["ok"]
    bound = plat.bind()
    weights = [n for n, t in plat.program.tensors.items()
               if t.kind == "weight"]
    assert set(weights) <= set(bound.buffers)
    assert bound.missing_inputs == ("hidden", "positions")
    ex = Executor(driver=plat.driver)
    out = ex.run(bound, inputs=carried["inputs"])["logits"]
    assert torch.equal(out, ex.run_interpreted(
        bound, inputs=carried["inputs"])["logits"])
    plain = RCBProgram.decode(carried["jprog"].encode())
    for blk in plain.blocks:
        for op in blk.ops:
            if op.op is Op.ATTENTION:
                op.attrs["impl"] = "ref"
    plain_out = ex.run(rbl.bind(plain, rimfs=plat.rimfs, driver=plat.driver),
                       inputs=carried["inputs"])["logits"]
    assert torch.equal(out, plain_out)
    assert out.dtype == getattr(torch, carried["cfg"].dtype)
    assert torch.isfinite(out.float()).all()


def test_bound_weights_are_pinned_once(carried):
    fs = rimfs.mount(carried["image"])
    drv = rhal.make_eager_driver("cpu")
    rbl.bind(carried["prog"], rimfs=fs, driver=drv)
    moved = drv.stats["dma_bytes"]
    payload = sum(fs.stat(n)["nbytes"] for n in fs.files())
    assert moved == payload
    assert drv.arena.bytes_in_use >= payload
    again = rbl.bind(carried["prog"], rimfs=fs, driver=drv)
    assert drv.stats["dma_bytes"] == moved             # zero bytes re-moved
    res = fs.resident(drv)
    assert again.buffers["embed"] is res["embed"]
    assert res.revalidate()


def test_dma_crc_mismatch_is_retried_then_raised():
    drv = rhal.make_eager_driver("cpu")
    src = torch.arange(64, dtype=torch.float32)
    t = drv.dma_async(src, "h2d")
    t.buf = src.clone()
    t.buf[3] = -1.0                                  # corrupt the delivery
    out = drv.dma_wait(t)                             # re-issued from src
    assert torch.equal(out, src) and t.retries == 1
    assert drv.stats["dma_retry_recovered"] == 1

    drv.integrity.dma_retries = 0
    t = drv.dma_async(src, "h2d")
    t.buf = torch.zeros_like(src)
    with pytest.raises(IntegrityError, match="CRC mismatch"):
        drv.dma_wait(t)
    with pytest.raises(rhal.DmaError, match="redeemed twice"):
        drv.dma_wait(t)


def test_arena_holds_offsets_and_refuses_overflow():
    arena = rhal.DeviceArena(1024, debug=True)
    a = arena.alloc(100)
    b = arena.alloc(300)
    assert (a, b) == (0, 128) and arena.bytes_in_use == 512
    arena.free(a)
    with pytest.raises(rhal.ArenaError, match="exhausted"):
        arena.alloc(1024)
    arena.free(b)
    assert arena.alloc(1024) == 0


def test_other_families_are_not_ported():
    cfg = dataclasses.replace(get_config("qwen2-1.5b-smoke"),
                              family="encoder")
    with pytest.raises(NotImplementedError, match="not ported"):
        tf.model_specs(cfg)
    with pytest.raises(NotImplementedError, match="not ported"):
        rctc.compile_transformer_block(cfg, {}, B, S)


def test_init_params_follow_the_jax_init_kinds():
    cfg = get_config("qwen2-1.5b-smoke")
    p = tf.init_params(cfg, 0, device="cpu")
    again = tf.init_params(cfg, 0, device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)     # seeded
    assert torch.equal(p["ln1"], torch.ones_like(p["ln1"]))
    assert torch.equal(p["bq"], torch.zeros_like(p["bq"]))
    # truncated at 3 std, fan-in = shape[-2] as in the JAX package
    assert p["wq"].abs().max() <= 3.0 / cfg.num_heads ** 0.5 + 1e-6
    assert abs(p["embed"].std().item() - cfg.d_model ** -0.5) < 0.02


@pytest.mark.parametrize("program", ["dma_pipeline", "transfer_pipeline"])
def test_dma_programs_run_and_plan_like_jax(program, rng):
    """JAX-built programs with explicit H2D/D2H stages: the port's residency
    plan equals the JAX linker's, and the port's linked run (prologue
    prefetch, epilogue drain) and interpreted run give JAX's outputs."""
    from repro.core import linker as jax_linker
    from repro_torch.core import linker
    n, stages = 16, 3
    if program == "dma_pipeline":
        jprog = jax_rctc.compile_dma_pipeline(stages, n=n)
        files = {"b": (rng.randn(n, n) / n).astype(np.float32)}
        shape = (n, n)
    else:
        jprog = jax_rctc.compile_transfer_pipeline(stages, 40)
        files = {}
        shape = (40,)
    ins = {f"in{i}": rng.randn(*shape).astype(np.float32)
           for i in range(stages)}
    jimage = jax_rimfs.pack(files) if files else None
    jbound = jax_rbl.bind(jprog, rimfs=jax_rimfs.mount(jimage)
                          if files else None, inputs=dict(ins))
    want = JaxExecutor().run(jbound)
    prog = RCBProgram.decode(jprog.encode())
    fs = rimfs.mount(jimage) if files else None
    ex = Executor(device="cpu")
    bound = rbl.bind(prog, rimfs=fs, driver=ex.driver)
    assert dataclasses.asdict(linker.plan_residency(bound)) == \
        dataclasses.asdict(jax_linker.plan_residency(jbound))
    linked = ex.run(bound, inputs=dict(ins))
    interp = ex.run_interpreted(bound, inputs=dict(ins))
    assert sorted(linked) == sorted(interp) == sorted(want)
    for name in want:
        assert torch.equal(linked[name], interp[name])
        np.testing.assert_allclose(linked[name].numpy(),
                                   np.asarray(want[name]), rtol=0, atol=1e-5)
    plan = ex.link(bound).residency
    assert len(plan.prefetch_syms) == len(plan.drain_syms) == stages
    assert ex.driver.stats["dma_crc_checked"] >= stages   # h2d verified


def test_rebind_keeps_the_program_and_swaps_buffers():
    carried = _carry("float32")
    fs = rimfs.mount(carried["image"])
    bound = rbl.bind(carried["prog"], rimfs=fs)
    swapped = torch.zeros_like(bound.buffers["final_norm"])
    again = rbl.rebind(bound, buffers={"final_norm": swapped})
    assert again.program is bound.program
    assert again.buffers["final_norm"] is swapped
    assert again.buffers["embed"] is bound.buffers["embed"]
    assert again.last_use == bound.last_use
    assert again.missing_inputs == bound.missing_inputs
