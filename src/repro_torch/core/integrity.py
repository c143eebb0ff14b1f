"""Integrity plane primitives — the unified fault taxonomy anchor.

The port's copy of ``repro.core.integrity``:

  * ``IntegrityError`` — the recoverable data-integrity fault class (a DMA
    payload checksum mismatch, a torn RIMFS write). ``rimfs.RIMFSError``
    subclasses it, so recovery narrows to one ``except IntegrityError``.
  * ``payload_crc`` — CRC-32 over a buffer's bytes, shared by RIMFS file
    entries, image trailers and DMA tickets, so a ticket's CRC validates
    against the file it was read from.
  * ``IntegrityConfig`` — per-driver policy: verification on/off and the
    bounded in-place retry budget for corrupted transfers.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch.dtypes import host_bits


class IntegrityError(RuntimeError):
    """Detected data corruption (checksum mismatch, torn write, poisoned
    residency). ``kind`` tags the telemetry counter that increments."""

    def __init__(self, message: str, kind: str = "integrity"):
        super().__init__(message)
        self.kind = kind


@dataclasses.dataclass
class IntegrityConfig:
    """Driver-level integrity policy (one instance per HalDriver)."""
    enabled: bool = True       # stamp + verify DMA payload CRCs
    dma_retries: int = 2       # in-place re-issues before escalating


def payload_crc(buf) -> int:
    """CRC-32 over a buffer's raw bytes. A torch tensor is read as its
    bytes; a CUDA tensor goes through one device-to-host copy first."""
    if isinstance(buf, torch.Tensor):
        a = host_bits(buf)
    else:
        a = np.ascontiguousarray(np.asarray(buf))
    return zlib.crc32(a.reshape(-1).view(np.uint8)) & 0xFFFFFFFF
