"""Snowflake Arctic 480B — 128-expert top-2 MoE with dense residual MLP.

[hf:Snowflake/snowflake-arctic-base] 35L d_model=7168 56H (GQA kv=8,
head_dim=128) per-expert d_ff=4864 vocab=32000; MoE 128e top-2 in parallel
with a dense residual MLP (Arctic's dense+MoE hybrid).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,                   # per-expert
    vocab_size=32000,
    num_experts=128,
    experts_per_token=2,
    moe_dense_residual=True,
    d_ff_dense=7168,             # dense residual branch width
))
