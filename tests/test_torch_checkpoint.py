"""Checkpoints in the port against the JAX package's: the same training
state saved by both packages gives identical file bytes, each package
loads the other's file, keys are ``jax.tree_util.keystr``'s; and
``tests/test_checkpoint.py``'s cases in the port."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from repro.checkpoint import ckpt as jax_ckpt
from repro.optim.adamw import AdamWState as JaxAdamWState
from repro_torch.checkpoint.ckpt import (CheckpointManager, _flatten,
                                         load_checkpoint, save_checkpoint)
from repro_torch.optim.adamw import AdamWState


def _arrays(seed):
    rng = np.random.RandomState(seed)
    return {"embed": rng.standard_normal((16, 8)).astype(ml_dtypes.bfloat16),
            "a": rng.standard_normal((3, 4)).astype(np.float32),
            "m_embed": rng.standard_normal((16, 8)).astype(np.float32),
            "m_a": rng.standard_normal((3, 4)).astype(np.float32),
            "v_embed": rng.uniform(0, 1, (16, 8)).astype(np.float32),
            "v_a": rng.uniform(0, 1, (3, 4)).astype(np.float32)}


def _jax_train_state(seed=0, step=7):
    x = {k: jnp.asarray(v) for k, v in _arrays(seed).items()}
    return {"params": {"embed": x["embed"], "a": x["a"]},
            "opt": JaxAdamWState(jnp.asarray(step, jnp.int32),
                                 {"embed": x["m_embed"], "a": x["m_a"]},
                                 {"embed": x["v_embed"], "a": x["v_a"]})}


def _port_train_state(seed=0, step=7):
    x = {}
    for k, v in _arrays(seed).items():
        x[k] = (torch.from_numpy(v.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16) if v.dtype == ml_dtypes.bfloat16
            else torch.from_numpy(v))
    return {"params": {"embed": x["embed"], "a": x["a"]},
            "opt": AdamWState(torch.tensor(step, dtype=torch.int32),
                              {"embed": x["m_embed"], "a": x["m_a"]},
                              {"embed": x["v_embed"], "a": x["v_a"]})}


def _bits(t):
    t = torch.as_tensor(t)
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_keys_are_keystr_keys():
    jstate = _jax_train_state()
    want = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(jstate)[0]]
    assert list(_flatten(_port_train_state())) == want
    assert want[:5] == ["['opt'].step", "['opt'].m['a']",
                        "['opt'].m['embed']", "['opt'].v['a']",
                        "['opt'].v['embed']"]
    nested = {"x": [1, (2, None)], "y": {"z": 3}}
    want = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(nested)[0]]
    assert list(_flatten(nested)) == want


def test_both_packages_write_identical_bytes(tmp_path):
    jax_ckpt.save_checkpoint(tmp_path / "jax.rimfs", _jax_train_state(),
                             step=7, extra={"lr": 0.1})
    save_checkpoint(tmp_path / "port.rimfs", _port_train_state(), step=7,
                    extra={"lr": 0.1})
    a = (tmp_path / "jax.rimfs").read_bytes()
    b = (tmp_path / "port.rimfs").read_bytes()
    assert len(a) == len(b) and a == b


def test_each_package_loads_the_others_file(tmp_path):
    save_checkpoint(tmp_path / "port.rimfs", _port_train_state(3), step=3)
    jax_ckpt.save_checkpoint(tmp_path / "jax.rimfs", _jax_train_state(4),
                             step=4)
    back, step, _ = jax_ckpt.load_checkpoint(tmp_path / "port.rimfs",
                                             _jax_train_state(0))
    assert step == 3
    for a, b in zip(jax.tree.leaves(back),
                    jax.tree.leaves(_jax_train_state(3))):
        np.testing.assert_array_equal(np.asarray(a).reshape(-1),
                                      np.asarray(b).reshape(-1))
    back, step, _ = load_checkpoint(tmp_path / "jax.rimfs",
                                    _port_train_state(0))
    assert step == 4
    want = _flatten(_port_train_state(4))
    for k, t in _flatten(back).items():
        assert t.dtype == want[k].dtype and t.shape == want[k].shape, k
        assert torch.equal(_bits(t), _bits(want[k])), k


def test_load_of_part_of_the_tree(tmp_path):
    """A ``like`` holding only the parameters reads only them."""
    save_checkpoint(tmp_path / "c.rimfs", _port_train_state(2), step=2)
    like = {"params": _port_train_state(0)["params"]}
    back, step, _ = load_checkpoint(tmp_path / "c.rimfs", like)
    assert step == 2 and list(back) == ["params"]
    assert torch.equal(back["params"]["a"],
                       _port_train_state(2)["params"]["a"])


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py's cases
# ---------------------------------------------------------------------------

def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((16, 16), generator=g),
                       "b": torch.zeros((16,))},
            "opt": {"m": torch.ones((16, 16)) * 0.5},
            "step": torch.tensor(seed, dtype=torch.int32)}


def test_save_load_roundtrip(tmp_path):
    state = _state(7)
    save_checkpoint(tmp_path / "c.rimfs", state, step=7, extra={"lr": 0.1})
    back, step, extra = load_checkpoint(tmp_path / "c.rimfs", state)
    assert step == 7 and extra == {"lr": 0.1}
    for k, t in _flatten(state).items():
        assert torch.equal(t, _flatten(back)[k]), k


def test_manager_retention_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    for s in (1, 2, 3):
        mgr.save(_state(s), step=s)
    assert mgr.all_steps() == [2, 3]
    back, step, _ = mgr.restore_latest(_state(0))
    assert step == 3
    assert [s["step"] for s in mgr.saves] == [1, 2, 3]
    assert all(s["bytes"] > 0 and s["pack_s"] >= 0 for s in mgr.saves)


def test_corrupt_checkpoint_falls_back(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3, async_save=False)
    mgr.save(_state(1), step=1)
    mgr.save(_state(2), step=2)
    newest = sorted(tmp_path.glob("ckpt_*.rimfs"))[-1]
    raw = bytearray(newest.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    newest.write_bytes(bytes(raw))
    back, step, _ = mgr.restore_latest(_state(0))
    assert step == 1                      # fell back past the corrupt one


def test_torn_checkpoint_falls_back(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3, async_save=False)
    mgr.save(_state(1), step=1)
    mgr.save(_state(2), step=2)
    newest = sorted(tmp_path.glob("ckpt_*.rimfs"))[-1]
    newest.write_bytes(newest.read_bytes()[: newest.stat().st_size // 2])
    _, step, _ = mgr.restore_latest(_state(0))
    assert step == 1


def test_async_save_snapshot_isolated(tmp_path):
    """An async save snapshots the values before the caller updates the
    state in place (the next training step does)."""
    mgr = CheckpointManager(tmp_path, keep=2, async_save=True)
    state = _state(5)
    mgr.save(state, step=5)
    state["params"]["w"].mul_(0.0)           # the next step, in place
    mgr.wait()
    back, step, _ = mgr.restore_latest(_state(0))
    assert step == 5
    assert float(back["params"]["w"].abs().sum()) > 0


def test_restore_empty_dir(tmp_path):
    mgr = CheckpointManager(tmp_path)
    assert mgr.restore_latest(_state(0)) is None
