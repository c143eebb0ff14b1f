"""The port's parameter, cache and optimizer specs against the JAX
package's: the logical axes (and shape, dtype, init) of every leaf for
every config, ``param_bytes``/``param_count``, the dry run's
``input_specs``, and ``param_shardings`` under a 16x16 mesh against the
reference resolver, leaf by leaf."""
import pytest

from jax.sharding import AbstractMesh as JaxAbstractMesh
from repro.configs import (SHAPES as JAX_SHAPES, applicable_shapes as
                           jax_applicable_shapes, get_config as jax_config)
from repro.distributed.sharding import RULE_SETS as JAX_RULE_SETS
from repro.distributed.sharding import logical_to_pspec as jax_pspec
from repro.launch import steps as jax_steps
from repro.models import common as jax_common
from repro.models import transformer as jax_tf
from repro.optim.adamw import adamw_init_specs as jax_adamw_init_specs
from repro_torch.configs import ARCHES, SHAPES, applicable_shapes, get_config
from repro_torch.distributed.sharding import (AbstractMesh, axis_rules,
                                              to_placements)
from repro_torch.dtypes import torch_dtype
from repro_torch.launch.steps import input_specs
from repro_torch.models import transformer as tf
from repro_torch.models.common import (param_bytes, param_count,
                                       param_shardings, shape_structs,
                                       spec_leaves)
from repro_torch.optim.adamw import adamw_init_specs

MESH = AbstractMesh((16, 16), ("data", "model"))


def _jax_mesh():
    try:
        return JaxAbstractMesh((16, 16), ("data", "model"))
    except TypeError:
        return JaxAbstractMesh((("data", 16), ("model", 16)))


def _same_specs(ours: dict, theirs: dict):
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        o, t = ours[k], theirs[k]
        assert (tuple(o.shape), o.dtype, o.axes, o.init, o.scale) == \
            (tuple(t.shape), t.dtype, tuple(t.axes), t.init, t.scale), k


@pytest.mark.parametrize("arch", ARCHES)
def test_model_specs_axes_bytes_and_count(arch):
    cfg, ref = get_config(arch), jax_config(arch)
    ours, theirs = tf.model_specs(cfg), jax_tf.model_specs(ref)
    _same_specs(ours, theirs)
    assert param_bytes(ours) == jax_common.param_bytes(theirs)
    assert param_count(ours) == jax_common.param_count(theirs)


@pytest.mark.parametrize("arch", ARCHES)
def test_cache_specs_axes(arch):
    """The decode state's specs at a batch of 4 and 64 rows."""
    cfg, ref = get_config(arch), jax_config(arch)
    _same_specs(tf.cache_specs(cfg, 4, 64), jax_tf.cache_specs(ref, 4, 64))


@pytest.mark.parametrize("arch", ARCHES)
def test_adamw_init_specs_axes(arch):
    ours = adamw_init_specs(tf.model_specs(get_config(arch)))
    theirs = jax_adamw_init_specs(jax_tf.model_specs(jax_config(arch)))
    assert (ours.step.shape, ours.step.dtype, ours.step.axes) == \
        (tuple(theirs.step.shape), theirs.step.dtype, tuple(theirs.step.axes))
    _same_specs(ours.m, theirs.m)
    _same_specs(ours.v, theirs.v)
    assert any("opt_shard" in s.axes for s in spec_leaves(ours.m))
    assert not any("fsdp" in s.axes for s in spec_leaves(ours.v))


@pytest.mark.parametrize("arch", ["qwen3-14b", "rwkv6-1.6b", "pixtral-12b"])
def test_input_specs_match_reference_every_cell(arch):
    cfg, ref = get_config(arch), jax_config(arch)
    assert applicable_shapes(cfg) == jax_applicable_shapes(ref)
    for sname in applicable_shapes(cfg):
        ours = input_specs(cfg, SHAPES[sname])
        theirs = jax_steps.input_specs(ref, JAX_SHAPES[sname])
        assert sorted(ours) == sorted(theirs)
        for k, t in theirs.items():
            o = ours[k]
            assert o.device.type == "meta"
            assert tuple(o.shape) == tuple(t.shape), (sname, k)
            assert o.dtype == torch_dtype(str(t.dtype)), (sname, k)


def test_shape_structs_allocate_nothing():
    specs = tf.model_specs(get_config("qwen2-1.5b"))
    structs = shape_structs(specs)
    assert all(t.device.type == "meta" for t in structs.values())
    assert sum(t.numel() * t.element_size() for t in structs.values()) \
        == param_bytes(specs)


@pytest.mark.parametrize("rules", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-14b",
                                  "moonshot-v1-16b-a3b", "hymba-1.5b",
                                  "rwkv6-1.6b"])
def test_param_shardings_equal_reference_resolver(arch, rules):
    """Under a 16x16 mesh, every leaf's placements are those of the
    reference resolver's spec for the same shape and axes."""
    ref_specs = jax_tf.model_specs(jax_config(arch))
    jmesh = _jax_mesh()
    with axis_rules(MESH, rules):
        got = param_shardings(tf.model_specs(get_config(arch)))
    n_sharded = 0
    for k, s in ref_specs.items():
        mesh, placements = got[k]
        want = jax_pspec(s.shape, s.axes, JAX_RULE_SETS[rules], jmesh)
        assert mesh is MESH
        assert placements == to_placements(tuple(want), MESH), k
        n_sharded += any(p.is_shard() for p in placements)
    assert n_sharded > 0
    assert param_shardings(tf.model_specs(get_config(arch)))["embed"] is None


def test_specs_keep_the_positional_fields():
    """``axes`` is the last field, so positional (shape, dtype, init,
    scale) specs keep their meaning."""
    from repro_torch.models.common import ParamSpec
    s = ParamSpec((2, 3), "float32", "uniform", 0.5)
    assert (s.init, s.scale, s.axes) == ("uniform", 0.5, ())
    assert s._fields == ("shape", "dtype", "init", "scale", "axes")
