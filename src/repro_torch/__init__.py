"""AEG runtime on PyTorch and CUDA: the port of ``src/repro`` to one NVIDIA H100.

The layout mirrors the JAX package (``configs/``, ``core/``, ``kernels/``,
``models/``, ``serving/``) so each module has a counterpart of the same name.
The package imports torch and numpy only. Every entry point takes ``device=``
and defaults to ``"cuda"``; it raises when CUDA is absent unless the caller
asks for ``device="cpu"``. Importing the package switches TF32 off
(``repro_torch.device``).
"""
from repro_torch import device as _device  # noqa: F401  (TF32 off at import)
