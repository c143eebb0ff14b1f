"""MusicGen-medium — decoder-only LM over EnCodec audio tokens.

[arXiv:2306.05284] 48L d_model=1536 24H (kv=24, MHA, head_dim=64)
d_ff=6144 vocab=2048. Backbone only; the EnCodec frontend is a stub —
``input_specs()`` provides precomputed frame embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    input_kind="embeddings",     # EnCodec frame-embedding stub
))
