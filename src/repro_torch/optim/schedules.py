"""Learning-rate schedules (the port's counterpart of
``repro.optim.schedules``): pure functions of a 0-d int32 step tensor,
computed in fp32 on the step's device."""
from __future__ import annotations

import math

import torch


def cosine_warmup(step: torch.Tensor, peak_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak_lr`` over ``warmup_steps``, then a cosine
    down to ``min_ratio * peak_lr`` at ``total_steps``. ``step`` is a 0-d
    int tensor; returns a 0-d fp32 tensor on its device."""
    s = step.float()
    warm = peak_lr * torch.clamp((s + 1.0) / max(1, warmup_steps), max=1.0)
    t = torch.clamp((s - warmup_steps) / max(1, total_steps - warmup_steps),
                    0.0, 1.0)
    cos = min_ratio + (1.0 - min_ratio) * 0.5 * (1.0 + torch.cos(math.pi * t))
    return torch.where(s < warmup_steps, warm, peak_lr * cos)
