"""Architecture configs ported so far (one module per architecture)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    get_config,
    list_configs,
    register,
)

_ARCH_MODULES = ["qwen2_1p5b", "hymba_1p5b", "rwkv6_1p6b"]

_loaded = False


def load_all() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")
