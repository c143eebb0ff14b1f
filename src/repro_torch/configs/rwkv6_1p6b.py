"""RWKV-6 "Finch" 1.6B — attention-free, data-dependent decay.

[arXiv:2404.05892] 24L d_model=2048 d_ff=7168 vocab=65536; head size 64.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=0,                 # attention-free
    num_kv_heads=0,
    head_dim=0,
    d_ff=7168,
    vocab_size=65536,
    attention="none",
    use_rope=False,
    rwkv_head_dim=64,            # 32 heads of size 64
    subquadratic=True,           # O(1) decode state -> long_500k runs
))
