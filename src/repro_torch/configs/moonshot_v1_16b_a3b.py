"""Moonshot (Kimi) Moonlight-16B-A3B — 64-expert top-6 MoE.

[hf:moonshotai/Moonlight-16B-A3B] 48L d_model=2048 16H (kv=16, MHA)
per-expert d_ff=1408 vocab=163840; MoE 64e top-6.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,                   # per-expert
    vocab_size=163840,
    num_experts=64,
    experts_per_token=6,
))
