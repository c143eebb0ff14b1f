"""Parameter specs shared by the model modules (the port's counterpart of
``repro.models.common.ParamSpec``, without the sharding axes: the port runs
on one device)."""
from __future__ import annotations

from typing import NamedTuple


class ParamSpec(NamedTuple):
    shape: tuple
    dtype: str
    init: str = "normal"      # normal | zeros | ones | embed | uniform
    scale: float = 1.0
