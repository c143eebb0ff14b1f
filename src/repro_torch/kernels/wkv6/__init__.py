"""RWKV-6 WKV recurrence: CUDA kernel (csrc/), wrapper (ops.py), plain
version (ref.py)."""
