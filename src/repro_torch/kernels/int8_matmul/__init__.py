"""INT8 GEMM: CUDA kernel (csrc/), wrapper (ops.py), plain version
(ref.py)."""
