"""Hymba-1.5B — hybrid: parallel attention + Mamba heads per layer.

[arXiv:2411.13676] 32L d_model=1600 25H (GQA kv=5, head_dim=64)
d_ff=5504 vocab=32001 ssm_state=16. Attention is sliding-window (Hymba uses
SWA in all but 3 layers); the Mamba branch gives O(1) decode state, so the
arch is sub-quadratic and runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    attention="sliding",
    sliding_window=1024,
    ssm_state=16,
    subquadratic=True,
))
