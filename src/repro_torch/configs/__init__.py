"""Architecture configs (one module per architecture)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeConfig,
    applicable_shapes,
    get_config,
    list_configs,
    register,
)

_ARCH_MODULES = [
    "rwkv6_1p6b",
    "pixtral_12b",
    "moonshot_v1_16b_a3b",
    "arctic_480b",
    "qwen3_14b",
    "qwen2_1p5b",
    "mistral_nemo_12b",
    "phi3_medium_14b",
    "hymba_1p5b",
    "musicgen_medium",
]

_loaded = False


def load_all() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


ARCHES = [m.replace("_", "-").replace("-1p6b", "-1.6b").replace("-1p5b", "-1.5b")
          for m in _ARCH_MODULES]
