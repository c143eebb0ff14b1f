"""One-token GQA decode attention over a KV cache: CUDA kernel (csrc/),
wrapper (ops.py), plain version (ref.py)."""
