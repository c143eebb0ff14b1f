"""Modality frontend stubs for the vlm and audio backbones (the port's copy
of ``repro.models.frontends``).

pixtral-12b and musicgen-medium specify the transformer backbone only; the
modality frontend supplies precomputed embeddings. These helpers draw
deterministic stand-ins with the right shapes and statistics from numpy's
``RandomState``, so they return exactly the JAX package's arrays for the
same arguments.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig


def patch_embed_stub(cfg: ModelConfig, batch: int, seq: int,
                     seed: int = 0) -> np.ndarray:
    """Pixtral: stand-in for ViT patch embeddings, unit-RMS like a real
    post-LN patch encoder output."""
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, seq, cfg.d_model).astype(np.float32)
    return x / np.sqrt((x ** 2).mean(-1, keepdims=True) + 1e-6)


def frame_embed_stub(cfg: ModelConfig, batch: int, seq: int,
                     seed: int = 0, codebooks: int = 4) -> np.ndarray:
    """MusicGen: stand-in for summed EnCodec codebook embeddings (the
    backbone sees the sum of per-codebook embeddings per frame)."""
    rng = np.random.RandomState(seed)
    parts = [rng.randn(batch, seq, cfg.d_model).astype(np.float32)
             * (0.5 ** i) for i in range(codebooks)]
    return np.sum(parts, axis=0) / codebooks
