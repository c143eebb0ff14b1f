"""The port's ``SyntheticLM`` against the JAX package's, bit for bit, and
``tests/test_data.py``'s cases in the port."""
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro_torch.data.pipeline import SyntheticLM, make_batch_specs


@pytest.mark.parametrize("step", [0, 7, 123])
@pytest.mark.parametrize("num_shards", [2, 4])
def test_batches_equal_jax_bit_for_bit(step, num_shards):
    kw = dict(vocab_size=151936, seq_len=24, global_batch=8, seed=99)
    ours, ref = SyntheticLM(**kw), JaxSyntheticLM(**kw)
    a, b = ours.global_batch_at(step), ref.global_batch_at(step)
    for k in ("inputs", "targets"):
        assert a[k].dtype == b[k].dtype == np.int32
        np.testing.assert_array_equal(a[k], b[k])
    for i in range(num_shards):
        sa, sb = ours.shard_at(step, i, num_shards), \
            ref.shard_at(step, i, num_shards)
        for k in ("inputs", "targets"):
            np.testing.assert_array_equal(sa[k], sb[k])


def test_batch_specs_allocate_nothing():
    specs = make_batch_specs(256, 4, 16)
    for k in ("inputs", "targets"):
        assert specs[k].shape == (4, 16) and specs[k].dtype == torch.int32
        assert specs[k].device.type == "meta"


# ---------------------------------------------------------------------------
# tests/test_data.py's cases
# ---------------------------------------------------------------------------

def test_shards_tile_global_batch():
    ds = SyntheticLM(vocab_size=256, seq_len=16, global_batch=8)
    g = ds.global_batch_at(3)
    parts = [ds.shard_at(3, i, 4) for i in range(4)]
    stitched = np.concatenate([p["inputs"] for p in parts], axis=0)
    np.testing.assert_array_equal(g["inputs"], stitched)


def test_deterministic_replay():
    ds = SyntheticLM(vocab_size=512, seq_len=8, global_batch=4)
    a = ds.global_batch_at(11)
    b = ds.global_batch_at(11)
    np.testing.assert_array_equal(a["inputs"], b["inputs"])
    c = ds.global_batch_at(12)
    assert not np.array_equal(a["inputs"], c["inputs"])


def test_elastic_resharding_preserves_stream():
    ds = SyntheticLM(vocab_size=128, seq_len=8, global_batch=8)
    wide = np.concatenate([ds.shard_at(5, i, 8)["inputs"] for i in range(8)])
    narrow = np.concatenate([ds.shard_at(5, i, 2)["inputs"]
                             for i in range(2)])
    np.testing.assert_array_equal(wide, narrow)


def test_targets_are_shifted_inputs():
    ds = SyntheticLM(vocab_size=64, seq_len=12, global_batch=2)
    b = ds.global_batch_at(0)
    np.testing.assert_array_equal(b["inputs"][:, 1:], b["targets"][:, :-1])


def test_learnable_structure():
    ds = SyntheticLM(vocab_size=64, seq_len=256, global_batch=4)
    b = ds.global_batch_at(0)
    x = b["inputs"].reshape(-1)
    y = b["targets"].reshape(-1)
    table = {}
    for xi, yi in zip(x, y):
        table.setdefault(int(xi), {}).setdefault(int(yi), 0)
        table[int(xi)][int(yi)] += 1
    correct = sum(max(c.values()) for c in table.values())
    assert correct / len(x) > 0.25      # >> 1/64 uniform
