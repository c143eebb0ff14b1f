"""The port's configurations against the JAX package's: every registered
architecture's fields, parameter counts, smoke variant and shape cells, the
``SHAPES`` table, and ``model_specs`` at full size (shapes, dtypes and init
kinds only: nothing is drawn)."""
import dataclasses

import pytest

from repro import configs as jax_configs
from repro.models import transformer as jax_tf
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.models import transformer as tf

NAMES = ["arctic-480b", "hymba-1.5b", "mistral-nemo-12b",
         "moonshot-v1-16b-a3b", "musicgen-medium", "phi3-medium-14b",
         "pixtral-12b", "qwen2-1.5b", "qwen3-14b", "rwkv6-1.6b"]


def test_the_same_configs_are_registered():
    assert configs.list_configs() == jax_configs.list_configs() == NAMES
    assert configs.ARCHES == jax_configs.ARCHES


@pytest.mark.parametrize("name", NAMES)
def test_fields_counts_smoke_and_shapes_equal_jax(name):
    cfg, jcfg = configs.get_config(name), jax_configs.get_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert dataclasses.asdict(cfg.smoke()) == \
        dataclasses.asdict(jcfg.smoke())
    assert configs.get_config(name + "-smoke") == cfg.smoke()
    assert configs.applicable_shapes(cfg) == \
        jax_configs.applicable_shapes(jcfg)


def test_shape_table_equals_jax():
    assert sorted(configs.SHAPES) == sorted(jax_configs.SHAPES)
    for k, s in configs.SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(
            jax_configs.SHAPES[k])
        assert dataclasses.asdict(s.smoke()) == dataclasses.asdict(
            jax_configs.SHAPES[k].smoke())
    assert base.ShapeConfig is configs.ShapeConfig


@pytest.mark.parametrize("name", NAMES)
def test_model_specs_at_full_size_equal_jax(name):
    cfg, jcfg = configs.get_config(name), jax_configs.get_config(name)
    specs, jspecs = tf.model_specs(cfg), jax_tf.model_specs(jcfg)
    assert sorted(specs) == sorted(jspecs)
    for k, s in specs.items():
        assert (s.shape, s.dtype, s.init, s.scale) == \
            (jspecs[k].shape, jspecs[k].dtype, jspecs[k].init,
             jspecs[k].scale), k


def test_moonshot_fits_one_card_whole_and_arctic_does_not():
    moon = configs.get_config("moonshot-v1-16b-a3b")
    assert moon.param_count() == 28_057_995_264
    assert moon.param_count() * 2 < 80e9 < \
        configs.get_config("arctic-480b").param_count() * 2
