"""ResNet-18 through the port's runtime, fp32 and INT8, with the JAX
package's weights carried across: the same BN folding, the same program and
image bytes from the port's compiler (optimized and not, with JAX's INT8
pack), the JAX package's bytes run by the port's linked and interpreted
executors to JAX's outputs (atol = rtol = 1e-5, as tests/test_resnet_rcb.py
holds the JAX runtime against its oracle), calibration probes and the INT8
pack against JAX's, the INT8 agreement check of tests/test_resnet_rcb.py on
the port's own weights, and the full-width image sizes counted from the
specs. Two configurations: the smoke one (32 px, no maxpool) and a mid-size
one (64 px: the stem's maxpool and a stride-2 stage)."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.resnet18 import CONFIG as JAX_CONFIG
from repro.core import quant as jax_quant
from repro.core import rbl as jax_rbl
from repro.core import rctc as jax_rctc
from repro.core import rimfs as jax_rimfs
from repro.core.executor import Executor as JaxExecutor
from repro.models import resnet as jax_rn
from repro_torch.configs.resnet18 import CONFIG
from repro_torch.core import quant, rbl, rctc, rimfs
from repro_torch.core.executor import Executor
from repro_torch.core.rcb import Op, RCBProgram
from repro_torch.core.rtpm import Platform
from repro_torch.models import resnet as rn

ATOL = RTOL = 1e-5                            # tests/test_resnet_rcb.py:31
SCALE_RTOL = 1e-5   # activation scales: fp32 convs of XLA and of torch
BATCH = 4

CONFIGS = {"smoke": {}, "mid64": {"image_size": 64}}


def _configs(name):
    kw = CONFIGS[name]
    return (dataclasses.replace(JAX_CONFIG.smoke(), **kw),
            dataclasses.replace(CONFIG.smoke(), **kw))


@functools.lru_cache(maxsize=None)
def _carry(name):
    """JAX params, folded weights and INT8 pack (from 4 calibration
    images), the port's params carried across, and a batch of inputs."""
    jcfg, cfg = _configs(name)
    jparams = jax.tree.map(np.asarray,
                           jax_rn.init_resnet(jax.random.PRNGKey(0), jcfg))
    jfolded = jax_rn.fold_bn(jparams)
    x = np.random.RandomState(1).rand(
        BATCH, cfg.image_size, cfg.image_size, 3).astype(np.float32)
    jpack = jax_quant.quantize_resnet(jcfg, jfolded, x)
    params = rn.params_from_jax(jparams, device="cpu")
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, jfolded=jfolded,
                jpack=jpack, params=params, folded=rn.fold_bn(params), x=x)


def _jax_run(c, int8):
    prog, image = jax_rctc.compile_resnet18(
        c["jcfg"], c["jfolded"], batch=BATCH,
        int8=c["jpack"] if int8 else None)
    bound = jax_rbl.bind(prog, rimfs=jax_rimfs.mount(image),
                         inputs={"input": c["x"]})
    return prog, image, np.asarray(JaxExecutor().run(bound)["output"])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_params_carry_across_and_fold_like_jax(name):
    c = _carry(name)
    specs = rn.resnet_specs(c["cfg"])
    assert set(specs) == set(c["jparams"]) == set(c["params"])
    for k, v in c["jparams"].items():
        if isinstance(v, dict):
            for kk in rn.BN_KEYS:
                assert torch.equal(c["params"][k][kk],
                                   torch.from_numpy(v[kk]))
        else:
            assert torch.equal(c["params"][k], torch.from_numpy(v))
    assert set(c["folded"]) == set(c["jfolded"])
    for k, v in c["jfolded"].items():            # bit for bit
        np.testing.assert_array_equal(c["folded"][k].numpy(), v)


@pytest.mark.parametrize("optimize", [True, False])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_compiler_emits_the_jax_program_and_image_bytes(name, int8,
                                                        optimize):
    """From the same folded weights (and JAX's INT8 pack, plain numpy)."""
    c = _carry(name)
    pack = c["jpack"] if int8 else None
    jprog, jimage = jax_rctc.compile_resnet18(c["jcfg"], c["jfolded"],
                                              batch=BATCH, int8=pack,
                                              optimize=optimize)
    prog, image = rctc.compile_resnet18(c["cfg"], c["folded"], batch=BATCH,
                                        int8=pack, optimize=optimize)
    assert prog.encode() == jprog.encode()
    assert image == jimage
    kinds = {op.op for op in prog.ops()}
    assert (Op.CONV2D_I8 in kinds) == int8 and (Op.CONV2D in kinds) != int8
    assert (Op.MAXPOOL in kinds) == (c["cfg"].image_size >= 64)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_runs_the_jax_bytes_like_jax(name, int8):
    c = _carry(name)
    jprog, jimage, want = _jax_run(c, int8)
    prog = RCBProgram.decode(jprog.encode())
    ex = Executor(device="cpu")
    bound = rbl.bind(prog, rimfs=rimfs.mount(jimage),
                     inputs={"input": c["x"]}, driver=ex.driver)
    linked = ex.run(bound)["output"]
    interp = ex.run_interpreted(bound)["output"]
    assert torch.equal(linked, interp)
    assert linked.dtype == torch.float32 and linked.shape == want.shape
    np.testing.assert_allclose(linked.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_program_matches_the_plain_forward(name):
    """The port's own compile of its own folded weights against its plain
    forward and against the JAX oracle."""
    c = _carry(name)
    prog, image = rctc.compile_resnet18(c["cfg"], c["folded"], batch=BATCH)
    plat = Platform(device="cpu")
    plat.provision(image=image, program_bytes=prog.encode())
    out = Executor(driver=plat.driver).run(
        plat.bind(inputs={"input": c["x"]}))["output"].numpy()
    x = torch.from_numpy(c["x"])
    ref = rn.resnet_forward(c["cfg"], c["params"], x).numpy()
    jref = np.asarray(jax_rn.resnet_forward(c["jcfg"], c["jparams"],
                                            jnp.asarray(c["x"])))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ref, jref, atol=ATOL, rtol=RTOL)
    logits = rn.resnet_forward(c["cfg"], c["params"], x, softmax=False)
    assert logits.shape == (BATCH, c["cfg"].num_classes)


@pytest.mark.parametrize("mode", ["linked", "interpreted"])
def test_probe_matches_jax_calibration(mode):
    """``Executor.run(probe=)`` and ``run_interpreted(probe=)``: the same
    symbols as the JAX package's probe, the same abs-max to SCALE_RTOL."""
    c = _carry("mid64")
    want = jax_quant.calibrate(c["jcfg"], c["jfolded"], c["x"])
    prog, image = rctc.compile_resnet18(c["cfg"], c["folded"], batch=BATCH)
    ex = Executor(device="cpu")
    bound = rbl.bind(prog, rimfs=rimfs.mount(image),
                     inputs={"input": c["x"]}, driver=ex.driver)
    probe: dict = {}
    run = ex.run if mode == "linked" else ex.run_interpreted
    run(bound, probe=probe)
    assert set(probe) == set(want)
    for sym, v in want.items():
        assert probe[sym] == pytest.approx(v, rel=SCALE_RTOL), sym


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_quantize_resnet_matches_the_jax_pack(name):
    """int8 weights exactly (they depend on the weights alone); activation
    scales and requant vectors to SCALE_RTOL (they depend on fp32
    convolutions, which XLA and torch sum in other orders)."""
    c = _carry(name)
    pack = quant.quantize_resnet(c["cfg"], c["folded"], c["x"],
                                 device="cpu")
    jpack = c["jpack"]
    assert set(pack["weights"]) == set(jpack["weights"])
    for k, w in jpack["weights"].items():
        assert pack["weights"][k].dtype == torch.int8
        np.testing.assert_array_equal(pack["weights"][k].numpy(), w)
        np.testing.assert_allclose(pack["requant"][k].numpy(),
                                   jpack["requant"][k], rtol=SCALE_RTOL,
                                   atol=0)
        assert pack["act_scales"][k] == pytest.approx(
            jpack["act_scales"][k], rel=SCALE_RTOL)
    folded = {k: v for k, v in c["folded"].items() if k.endswith("conv1")}
    for k, w in folded.items():
        sw = quant.per_channel_scales(w)
        np.testing.assert_array_equal(
            sw.numpy(), jax_quant.per_channel_scales(w.numpy()))


def test_int8_resnet_agreement():
    """The counterpart of tests/test_resnet_rcb.py::test_int8_resnet_agreement
    on the port's own weights (seed 0): INT8 against the fp32 plain forward,
    argmax agreement >= 0.6 (chance is 0.1) and mean drift < 0.08."""
    cfg = CONFIG.smoke()
    params = rn.init_resnet(cfg, 0, device="cpu")
    folded = rn.fold_bn(params)
    x = np.random.RandomState(0).rand(32, cfg.image_size, cfg.image_size,
                                      3).astype(np.float32)
    pack = quant.quantize_resnet(cfg, folded, x[:4], device="cpu")
    prog, image = rctc.compile_resnet18(cfg, folded, batch=32, int8=pack)
    ex = Executor(device="cpu")
    bound = rbl.bind(prog, rimfs=rimfs.mount(image), inputs={"input": x},
                     driver=ex.driver)
    out_q = ex.run(bound)["output"]
    ref = rn.resnet_forward(cfg, params, torch.from_numpy(x))
    assert torch.isfinite(out_q).all()
    assert quant.top1_agreement(ref, out_q) >= 0.6
    assert float((ref - out_q).abs().mean()) < 0.08


def test_init_resnet_follows_the_jax_init_kinds():
    cfg = CONFIG.smoke()
    params = rn.init_resnet(cfg, 0, device="cpu")
    again = rn.init_resnet(cfg, 0, device="cpu")
    for k in ("stem_conv", "fc_w"):
        assert torch.equal(params[k], again[k])
    w = params["s1b0_conv2"]                     # (3, 3, 16, 16), fan_in 16
    assert w.dtype == torch.float32
    assert float(w.abs().max()) <= 3 * 1.4 / 16 ** 0.5 + 1e-6
    assert 0.9 < float(w.std()) / (1.4 / 16 ** 0.5) < 1.1   # 0.986 drawn
    bn = params["stem_bn"]
    assert torch.equal(bn["scale"], torch.ones(cfg.stem_width))
    assert torch.equal(bn["var"], torch.ones(cfg.stem_width))
    assert not bn["bias"].any() and not bn["mean"].any()
    assert not params["fc_b"].any()


def _image_tensor_bytes(cfg, int8: bool) -> int:
    """The tensors of compile_resnet18's image, counted from the specs: per
    conv its weights (4 bytes each in fp32, 1 in INT8) and the folded BN
    scale and shift (fp32, per output channel), plus in INT8 the requant
    and zero vectors (fp32, per output channel); then fc_w and fc_b."""
    total = 0
    for name, spec in rn.resnet_specs(cfg).items():
        if isinstance(spec, dict) or not name.endswith(("conv", "conv1",
                                                         "conv2", "proj")):
            continue
        cout = spec.shape[-1]
        total += int(np.prod(spec.shape)) * (1 if int8 else 4)
        total += 2 * cout * 4 + (2 * cout * 4 if int8 else 0)
    specs = rn.resnet_specs(cfg)
    return total + 4 * (int(np.prod(specs["fc_w"].shape))
                        + int(np.prod(specs["fc_b"].shape)))


@pytest.mark.parametrize("int8", [False, True])
def test_image_tensor_bytes_at_full_width(int8):
    """46,758,048 bytes fp32 (11,689,512 parameters after BN folding) and
    13,295,712 INT8 (11,166,912 of int8 conv weights) at CONFIG's width,
    counted from the specs; the count holds against a compiled image at
    the smoke size."""
    assert _image_tensor_bytes(CONFIG, int8) == (13_295_712 if int8
                                                 else 46_758_048)
    c = _carry("mid64")
    pack = c["jpack"] if int8 else None
    _, image = rctc.compile_resnet18(c["cfg"], c["folded"], batch=1,
                                     int8=pack)
    fs = rimfs.mount(image)
    assert sum(fs.stat(n)["nbytes"] for n in fs.files()) \
        == _image_tensor_bytes(c["cfg"], int8)


def test_conv_relu_softmax_program_equals_jax():
    jprog = jax_rctc.compile_conv_relu_softmax(n=2, h=8, w=8, cin=3,
                                               cout=9)
    prog = rctc.compile_conv_relu_softmax(n=2, h=8, w=8, cin=3, cout=9)
    assert prog.encode() == jprog.encode()
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 8, 3).astype(np.float32)
    w = rng.randn(3, 3, 3, 9).astype(np.float32)
    want = np.asarray(JaxExecutor().run(jax_rbl.bind(
        jprog, rimfs=jax_rimfs.mount(jax_rimfs.pack({"w_conv": w})),
        inputs={"input": x}))["output"])
    ex = Executor(device="cpu")
    got = ex.run(rbl.bind(prog, rimfs=rimfs.mount(rimfs.pack({"w_conv": w})),
                          inputs={"input": x}, driver=ex.driver))["output"]
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
