"""ResNet-18 — the paper's case study (ImageNet-1k classification, INT8).

Standard He et al. (2016) ResNet-18: conv7x7/64 -> 4 stages of 2 basic
blocks (64/128/256/512) -> GAP -> fc(1000). The paper deploys this through
the RCB path with 12.63 MB of (quantized) parameters on a 4x7 AIE grid; here
it is the reference workload for the RCTC -> RCB -> executor pipeline and
the INT8 quantization flow.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet18"
    stage_sizes: tuple = (2, 2, 2, 2)
    stage_widths: tuple = (64, 128, 256, 512)
    num_classes: int = 1000
    image_size: int = 224
    stem_width: int = 64

    def smoke(self) -> "ResNetConfig":
        return dataclasses.replace(
            self, name="resnet18-smoke",
            stage_sizes=(1, 1), stage_widths=(8, 16),
            num_classes=10, image_size=32, stem_width=8)


CONFIG = ResNetConfig()
