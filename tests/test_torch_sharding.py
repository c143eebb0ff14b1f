"""The port's logical-axis resolver against the JAX package's: every case
of tests/test_sharding.py, a seeded sweep of random (shape, axes, rules,
mesh) cases compared entry for entry, the DTensor placements of a spec,
``shard`` as the identity outside a binding, and the binding as each
thread's own."""
import threading

import numpy as np
import pytest
import torch

from jax.sharding import AbstractMesh as JaxAbstractMesh
from repro.distributed.sharding import RULE_SETS as JAX_RULE_SETS
from repro.distributed.sharding import logical_to_pspec as jax_logical_to_pspec
from repro_torch.distributed.sharding import (RULE_SETS, AbstractMesh,
                                              PartitionSpec as P, axis_rules,
                                              carry_binding, current_context,
                                              logical_to_pspec, mesh_sizes,
                                              shard, sharding_for,
                                              to_placements)

MESH1 = AbstractMesh((16, 16), ("data", "model"))
MESH2 = AbstractMesh((2, 16, 16), ("pod", "data", "model"))


def _jax_mesh(sizes, names):
    try:                       # jax >= 0.5: AbstractMesh(sizes, names)
        return JaxAbstractMesh(sizes, names)
    except TypeError:          # jax 0.4.x: AbstractMesh(((name, size), ...))
        return JaxAbstractMesh(tuple(zip(names, sizes)))


def test_rule_sets_are_the_reference_rule_sets():
    assert RULE_SETS == JAX_RULE_SETS


def test_train_batch_uses_pod_and_data():
    spec = logical_to_pspec((256, 4096), ("batch", None),
                            RULE_SETS["train"], MESH2)
    assert spec == P(("pod", "data"))


def test_single_pod_falls_back_to_data():
    spec = logical_to_pspec((256, 4096), ("batch", None),
                            RULE_SETS["train"], MESH1)
    assert spec == P("data")


def test_indivisible_heads_replicate():
    # qwen3: 40 heads % 16 != 0 -> replicated, seq takes model instead
    spec = logical_to_pspec((16, 4096, 40, 128),
                            ("batch", "seq", "heads", None),
                            RULE_SETS["train"], MESH1)
    assert spec == P("data", "model")


def test_positional_priority_seq_before_heads():
    spec = logical_to_pspec((16, 4096, 32, 128),
                            ("batch", "seq", "heads", None),
                            RULE_SETS["train"], MESH1)
    assert spec == P("data", "model")


def test_vocab_32001_replicates():
    spec = logical_to_pspec((32001, 1600), ("vocab", "embed"),
                            RULE_SETS["train"], MESH1)
    assert spec == P()


def test_batch1_decode_seq_grabs_data_model():
    spec = logical_to_pspec((40, 1, 524288, 8, 128),
                            ("layers", "batch", "seq", "kv_heads", None),
                            RULE_SETS["decode"], MESH1)
    assert spec == P(None, None, ("data", "model"))


def test_decode_batch_and_seq():
    spec = logical_to_pspec((40, 128, 32768, 8, 128),
                            ("layers", "batch", "seq", "kv_heads", None),
                            RULE_SETS["decode"], MESH2)
    assert spec == P(None, ("pod", "data"), "model")


_LOGICAL = ["batch", "seq", "embed", "heads", "kv_heads", "mlp", "experts",
            "vocab", "fsdp", "opt_shard", "state", "layers", "head_dim",
            None]
_DIMS = [1, 2, 3, 7, 16, 32, 40, 48, 64, 128, 256, 512, 1536, 4096, 8960,
         32001, 151936]
_MESHES = {"pod256": ((16, 16), ("data", "model")),
           "pod512": ((2, 16, 16), ("pod", "data", "model"))}


def _sweep_cases(rules: str, mesh: str, n: int):
    """``n`` random (shape, axes) cases for one rule set and mesh; the seed
    depends on both, so each pair gets its own cases."""
    rng = np.random.RandomState(
        sorted(RULE_SETS).index(rules) * 10 + sorted(_MESHES).index(mesh))
    for _ in range(n):
        rank = rng.randint(1, 6)
        shape = tuple(int(rng.choice(_DIMS)) if rng.rand() < 0.7
                      else int(rng.randint(1, 5000)) for _ in range(rank))
        axes = tuple(_LOGICAL[rng.randint(len(_LOGICAL))]
                     for _ in range(rank))
        yield shape, axes


@pytest.mark.parametrize("mesh", sorted(_MESHES))
@pytest.mark.parametrize("rules", sorted(RULE_SETS))
def test_seeded_sweep_equals_reference(rules, mesh):
    """64 random cases for each of the 4 rule sets and 2 meshes (512 in
    all): the port's spec equals the JAX package's, entry for entry, and
    every sharded dim divides by its mesh axes, each axis used once."""
    sizes, names = _MESHES[mesh]
    ours, theirs = AbstractMesh(sizes, names), _jax_mesh(sizes, names)
    n_sharded = 0
    for shape, axes in _sweep_cases(rules, mesh, 64):
        got = logical_to_pspec(shape, axes, RULE_SETS[rules], ours)
        want = jax_logical_to_pspec(shape, axes, JAX_RULE_SETS[rules],
                                    theirs)
        assert tuple(got) == tuple(want), (shape, axes, got, want)
        used = []
        for dim, entry in zip(shape, got):
            if entry is None:
                continue
            n_sharded += 1
            group = (entry,) if isinstance(entry, str) else tuple(entry)
            used.extend(group)
            assert dim % int(np.prod([dict(zip(names, sizes))[a]
                                      for a in group])) == 0
        assert len(used) == len(set(used))
    assert n_sharded > 0


def test_to_placements_maps_groups_onto_mesh_dims():
    from torch.distributed.tensor import Replicate, Shard
    assert to_placements(P(("pod", "data"), None, "model"), MESH2) == (
        Shard(0), Shard(0), Shard(2))
    assert to_placements(P(None, "model"), MESH1) == (Replicate(), Shard(1))
    assert to_placements(P(), MESH1) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="not in the mesh's order"):
        to_placements(P(("model", "data")), MESH1)


def test_sharding_for_inside_and_outside_a_binding():
    from torch.distributed.tensor import Replicate, Shard
    assert sharding_for((256, 4096), ("batch", None)) is None
    with axis_rules(MESH2, "train"):
        mesh, placements = sharding_for((256, 4096), ("batch", None))
        assert mesh is MESH2
        assert placements == (Shard(0), Shard(0), Replicate())
    assert sharding_for((256, 4096), ("batch", None)) is None
    assert mesh_sizes(MESH2) == {"pod": 2, "data": 16, "model": 16}


def test_shard_noop_outside_context():
    x = torch.ones((4, 4))
    assert shard(x, "batch", None) is x
    with axis_rules(None, "train"):
        assert shard(x, "batch", None) is x


def test_cumsum_backward_is_the_reverse_cumsum():
    """The DTensor route's cumsum (``sharding.cumsum``: its backward a
    total less a cumsum, no flip) gives autograd's own gradient; on a
    plain tensor the helper is ``torch.cumsum`` itself."""
    from repro_torch.distributed import sharding
    x = torch.randn((3, 16, 5), dtype=torch.float64, requires_grad=True)
    g = torch.randn((3, 16, 5), dtype=torch.float64)
    want = torch.autograd.grad(torch.cumsum(x, 1), x, g)[0]
    y = sharding._autograd().Cumsum.apply(x, 1)
    assert torch.equal(y, torch.cumsum(x, 1))
    torch.testing.assert_close(torch.autograd.grad(y, x, g)[0], want,
                               rtol=1e-12, atol=1e-12)
    assert torch.equal(sharding.cumsum(x, 1), torch.cumsum(x, 1))
    w = torch.ones((4, 6))
    a, b = sharding.low_rank_operands(x, w)
    assert a is x and b is w
    assert sharding.grad_placed_as(x) is x


def _in_thread(fn):
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join()
    return out[0]


def test_binding_is_each_threads_own():
    """While one thread is inside a binding, another (a server's, say)
    sees none: its ``shard`` returns its input object and ``sharding_for``
    None."""
    x = torch.ones((4, 4))

    def other():
        return (current_context(), sharding_for((256, 4096), ("batch", None)),
                shard(x, "batch", None) is x)
    with axis_rules(MESH2, "train"):
        seen = _in_thread(other)
        assert current_context()[0] is MESH2
    assert seen == ((None, None), None, True)


def test_carry_binding_takes_the_callers_binding_to_another_thread():
    """What a rematerialized block's recompute needs: the function runs
    under the binding active where it was wrapped, on whatever thread."""
    from torch.distributed.tensor import Replicate, Shard

    def probe():
        return current_context()[0], sharding_for((256, 4096),
                                                  ("batch", None))
    assert carry_binding(probe) is probe
    with axis_rules(MESH2, "train"):
        fn = carry_binding(probe)
    assert current_context() == (None, None)
    mesh, (pmesh, placements) = _in_thread(fn)
    assert mesh is MESH2 and pmesh is MESH2
    assert placements == (Shard(0), Shard(0), Replicate())
    assert _in_thread(current_context) == (None, None)
