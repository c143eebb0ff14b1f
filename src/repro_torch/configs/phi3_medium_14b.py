"""Phi-3-medium 14B — dense, RoPE + SwiGLU + GQA.

[arXiv:2404.14219] 40L d_model=5120 40H (GQA kv=10, head_dim=128)
d_ff=17920 vocab=100352.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100352,
))
