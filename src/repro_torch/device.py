"""Device resolution and numeric policy for the whole port.

fp32 parity with the JAX package is gated at 1e-5 per op and 5e-4 per
program, and TF32 keeps only about three decimal digits, so importing this
module turns TF32 off for cuBLAS matmuls and cuDNN convolutions alike. It
also asks cuDNN for deterministic algorithms only: a served fp32 CONV2D
must equal a local run of the same bytes bit for bit.
"""
from __future__ import annotations

from typing import Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True

DeviceLike = Union[str, torch.device]


def resolve(device: DeviceLike = "cuda") -> torch.device:
    """The torch device an entry point runs on.

    There is no silent fallback: asking for CUDA on a machine without it
    raises, so a run that was meant for the card never lands on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def synchronize(device: torch.device) -> None:
    """Host barrier on the device's queue (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
