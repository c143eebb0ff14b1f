"""The kernel autotune cache in the port against the JAX package's
(``tests/test_conformance.py::test_autotune_cache_reloads_at_provision_with_zero_trials``
is the counterpart): the key's shape, the backend fields that never
collide, winner tables packed by either package loading in the other,
the reload at ``Platform.provision`` (``autotune_loaded``, a second
autotune costing zero trials), the sweep's mechanics on a stand-in timer,
and the plan handed to the kernel wrapper. The card's sweep, with real
trials, is ``tests/test_torch_autotune_gpu.py``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import rimfs as jax_rimfs
from repro.core.rtpm import Platform as JaxPlatform
from repro.kernels import registry as jax_kreg
from repro_torch.core import rimfs
from repro_torch.core.rtpm import Platform
from repro_torch.kernels import registry as kreg
from repro_torch.kernels.int8_matmul import ops as im_ops
from repro_torch.kernels.ssm_scan import ops as ss_ops
from repro_torch.kernels.wkv6 import ops as wk_ops


@pytest.fixture(autouse=True)
def _clean():
    kreg.reset()
    jax_kreg.reset()
    yield
    kreg.reset()
    jax_kreg.reset()


def _ssm_args(rng, b=2, t=13, di=4, n=4):
    da = -np.abs(rng.randn(b, t, di, n)).astype(np.float32)
    return da, rng.randn(b, t, di, n).astype(np.float32), \
        rng.randn(b, t, n).astype(np.float32)


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a.copy()) for a in arrays])


@pytest.mark.parametrize("name,kw", [("ssm_scan", {}),
                                     ("attention", {"causal": True}),
                                     ("matmul_int8",
                                      {"out_dtype": "bfloat16"})])
def test_key_keeps_the_jax_shape_with_a_backend_of_its_own(name, kw, rng):
    if name == "ssm_scan":
        arrays = _ssm_args(rng)
    elif name == "attention":
        arrays = [rng.randn(1, 5, 4, 16).astype(np.float32),
                  rng.randn(1, 5, 2, 16).astype(np.float32),
                  rng.randn(1, 5, 2, 16).astype(np.float32)]
    else:
        arrays = [rng.randint(-127, 128, (8, 16)).astype(np.int8),
                  rng.randint(-127, 128, (16, 24)).astype(np.int8),
                  np.ones(24, np.float32)]
    jargs, targs = _both(arrays)
    jkw = {k: jnp.dtype(v) if k == "out_dtype" else v for k, v in kw.items()}
    tkw = {k: getattr(torch, v) if k == "out_dtype" else v
           for k, v in kw.items()}
    jkey = jax_kreg.REGISTRY.signature(name, jargs, jkw).split("|")
    key = kreg.REGISTRY.signature(name, targs, tkw).split("|")
    assert key[0] == jkey[0] == name
    assert key[2] == jkey[2] and key[3] == jkey[3]
    assert key[1] == "torch-cpu" != jkey[1] == jax.default_backend()


def test_backend_fields_never_collide():
    ours = {kreg.backend(torch.device("cpu"))}
    if torch.cuda.is_available():
        ours.add(kreg.backend(torch.device("cuda", 0)))
    assert all(b.startswith("torch-") for b in ours)
    assert not ours & {"cpu", "gpu", "tpu", "cuda", "rocm",
                       jax.default_backend()}


def test_jax_table_loads_in_the_port_and_matches_no_port_call(rng):
    """The JAX package sweeps ssm_scan (trials > 0 in interpret mode) and
    packs its table: the port loads every entry under the same keys, and
    the same operands in the port find no winner (another backend)."""
    arrays = _ssm_args(rng)
    jargs, targs = _both(arrays)
    jparams, trials = jax_kreg.autotune("ssm_scan", *jargs)
    assert trials > 0
    jimage = jax_kreg.pack_image()
    assert kreg.load_image(jimage) == 1
    assert set(kreg.REGISTRY.winners) == set(jax_kreg.REGISTRY.winners)
    (key, entry), = kreg.REGISTRY.winners.items()
    assert entry["params"] == jparams and entry["source"] == "loaded"
    assert kreg.params_for("ssm_scan", targs) is None
    assert kreg.REGISTRY.stats["params_default"] == 1
    # loading again installs nothing: an existing key wins
    assert kreg.load_image(rimfs.mount(jimage)) == 0
    # a repack of what was loaded is the JAX package's repack, byte for byte
    jax_kreg.reset()
    jax_kreg.load_image(jimage)
    assert kreg.pack_image() == jax_kreg.pack_image()


def test_port_table_loads_in_the_jax_package(rng):
    targs = _both(_ssm_args(rng))[1]
    q = torch.from_numpy(rng.randn(1, 6, 4, 16).astype(np.float32))
    assert kreg.autotune("attention", q, q, q, causal=True) == ({}, 0)
    assert kreg.autotune("ssm_scan", *targs) == ({}, 0)   # a CPU operand
    image = kreg.pack_image()
    assert jax_kreg.load_image(image) == 2
    assert set(jax_kreg.REGISTRY.winners) == set(kreg.REGISTRY.winners)
    for key, entry in jax_kreg.REGISTRY.winners.items():
        assert key.split("|")[1] == "torch-cpu"
        assert entry["params"] == kreg.REGISTRY.winners[key]["params"]
        assert entry["source"] == "loaded"
    # the table's file is where the JAX package reads it
    assert kreg.AUTOTUNE_FILE in jax_rimfs.mount(image).files()


def _fake_sweep(monkeypatch, times):
    """Time candidates by a stand-in clock on CPU operands: the sweep's
    bookkeeping without a card (each plan's 'ms' from ``times``)."""
    calls = []

    def timer(fn):
        fn()
        calls.append(1)
        return times[len(calls) - 1]

    monkeypatch.setattr(kreg, "_on_card", lambda t: True)
    monkeypatch.setattr(kreg, "cuda_launch_ms", timer)
    return calls


def test_reload_at_provision_costs_zero_trials(monkeypatch, rng):
    """Tune, pack the winners into an image, reset, provision a fresh
    Platform with it: ``autotune_loaded`` with the entry count, and a
    second autotune sweeps nothing and returns the same plan."""
    targs = _both(_ssm_args(rng))[1]
    plans = ss_ops.candidates()
    _fake_sweep(monkeypatch, [3.0, 1.0, 2.0, 4.0])
    plan1, trials1 = kreg.autotune("ssm_scan", *targs)
    assert trials1 == len(plans) == 4 and plan1 == plans[1]
    assert [t["ms"] for t in next(iter(kreg.REGISTRY.sweeps.values()))] \
        == [3.0, 1.0, 2.0, 4.0]
    image = kreg.pack_image()
    kreg.reset()
    assert kreg.REGISTRY.sweep_trials == 0
    plat = Platform(device="cpu")
    seen = []
    plat.events.register("autotune_loaded", seen.append)
    plat.provision(image=image)
    plat.events.process()
    assert seen == [{"entries": 1}]
    plan2, trials2 = kreg.autotune("ssm_scan", *targs)
    assert trials2 == 0 and kreg.REGISTRY.sweep_trials == 0
    assert plan2 == plan1
    assert kreg.REGISTRY.stats["autotune_hit"] == 1


def test_jax_platform_reloads_a_port_table(monkeypatch, rng):
    targs = _both(_ssm_args(rng))[1]
    _fake_sweep(monkeypatch, [1.0, 2.0, 3.0, 4.0])
    kreg.autotune("ssm_scan", *targs)
    plat = JaxPlatform()
    seen = []
    plat.events.register("autotune_loaded", seen.append)
    plat.provision(image=kreg.pack_image())
    plat.events.process()
    assert seen == [{"entries": 1}]
    assert set(jax_kreg.REGISTRY.winners) == set(kreg.REGISTRY.winners)


def test_call_hands_the_winner_to_the_wrapper_memoised(monkeypatch, rng):
    targs = _both(_ssm_args(rng))[1]
    _fake_sweep(monkeypatch, [5.0, 5.0, 5.0, 1.0])
    plan, _ = kreg.autotune("ssm_scan", *targs)
    assert plan == {"instance": ss_ops.ROWWISE}
    got = []
    spec = kreg.get("ssm_scan")
    monkeypatch.setitem(kreg.REGISTRY.specs, "ssm_scan", kreg.KernelSpec(
        spec.name, lambda *a, plan=None: got.append(plan) or spec.ref(*a),
        spec.ref, spec.contract, spec.candidates))
    signature = kreg.REGISTRY.signature
    keys = []
    monkeypatch.setattr(kreg.REGISTRY, "signature",
                        lambda *a: keys.append(1) or signature(*a))
    for _ in range(3):
        y = kreg.call("ssm_scan", *targs)
    assert got == [plan] * 3
    assert len(keys) == 1                  # one key string, then the memo
    assert torch.equal(y, spec.ref(*targs))
    kreg.reset()                           # no winner: the default plan
    kreg.call("ssm_scan", *targs)
    assert got[-1] is None


def test_cpu_operands_and_one_plan_kernels_record_the_default(rng):
    targs = _both(_ssm_args(rng))[1]
    assert kreg.autotune("ssm_scan", *targs) == ({}, 0)
    q = torch.from_numpy(rng.randn(1, 6, 4, 16).astype(np.float32))
    assert kreg.autotune("attention", q, q, q, causal=True) == ({}, 0)
    assert all(e == {"params": {}, "us": None, "source": "default"}
               for e in kreg.REGISTRY.winners.values())
    assert kreg.REGISTRY.sweep_trials == 0
    # a default entry hands no plan to the wrapper
    assert kreg.params_for("ssm_scan", targs) is None


def test_candidate_plans_and_their_custom_op_arguments():
    m, n, k = 49, 512, 4608
    plans = im_ops.candidates(m, n, k, 132)
    assert plans[0] == dict(zip(("tile", "splits"),
                                im_ops.plan_for(m, n, k, 132)))
    assert len({(p["tile"], p["splits"]) for p in plans}) == len(plans)
    steps = -(-k // 64)
    for p in plans:
        assert im_ops.normal_splits(k, p["splits"]) == p["splits"]
        per = -(-steps // p["splits"])
        assert (p["splits"] - 1) * per < steps      # no split left empty
    assert im_ops._plan_args(None) == (-1, 0)
    assert ss_ops._ring_w(None) == 0
    assert ss_ops._ring_w({"instance": "rowwise"}) == -1
    assert [ss_ops._ring_w(p) for p in ss_ops.candidates()] == \
        [128, 64, 32, -1]
    assert wk_ops._max_inblock(None) == -1
    assert wk_ops._max_inblock({"states": "carry"}) == 0
    assert wk_ops._max_inblock({"states": "inblock"}) > 1 << 20
    for bad in ({"tile": 5, "splits": 1}, {"tile": 0, "splits": 0}):
        with pytest.raises(ValueError, match="bad plan"):
            im_ops._plan_args(bad)
    with pytest.raises(ValueError, match="bad plan"):
        ss_ops._ring_w({"instance": "ring", "w": 48})


@pytest.mark.parametrize("kernel", ["int8_matmul", "ssm_scan", "wkv6"])
def test_a_plan_on_cpu_operands_changes_nothing(kernel, rng):
    """On the CPU a wrapper computes its plain version whatever the plan."""
    if kernel == "int8_matmul":
        x = torch.from_numpy(rng.randint(-127, 128, (9, 40)).astype(np.int8))
        w = torch.from_numpy(rng.randint(-127, 128, (40, 24)).astype(np.int8))
        s = torch.ones(24)
        base = im_ops.int8_matmul(x, w, s)
        for p in im_ops.candidates(9, 24, 40, 132):
            assert torch.equal(im_ops.int8_matmul(x, w, s, plan=p), base)
            assert torch.equal(im_ops.int8_matmul_i32(x, w, plan=p),
                               im_ops.int8_matmul_i32(x, w))
    elif kernel == "ssm_scan":
        targs = _both(_ssm_args(rng))[1]
        base = ss_ops.ssm_scan(*targs)
        for p in ss_ops.candidates():
            assert torch.equal(ss_ops.ssm_scan(*targs, plan=p), base)
    else:
        r, k, v = (torch.from_numpy(rng.randn(1, 9, 2, 8).astype(np.float32))
                   for _ in range(3))
        lw = -torch.from_numpy(np.abs(rng.randn(1, 9, 2, 8))
                               .astype(np.float32))
        u = torch.from_numpy(rng.randn(2, 8).astype(np.float32))
        base = wk_ops.wkv6(r, k, v, lw, u)
        for p in wk_ops.candidates():
            assert torch.equal(wk_ops.wkv6(r, k, v, lw, u, plan=p), base)
