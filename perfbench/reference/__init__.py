"""The plain reference that decides ``correct``: the served model's forward
pass in float32 (TF32 off), written from the model's equations in plain
torch, a layer at a time over whole sequences, with no kernel, cache or
batching. It imports nothing of the program: it reads the sizes from the
configuration file and the weights the harness drew (the same tensors the
program was given).

``logits(config, params, seqs, starts)`` returns, for each sequence of
token ids, the logits of positions ``start`` to the end. With
``precision="fp8"`` every product's operands are rounded to float8 e4m3
first (weights by output column, activations by row, each scaled to the
format's range): the control, one precision step below the bfloat16 the
configurations serve in.
"""
from __future__ import annotations

import importlib

import torch


def logits(config: dict, params: dict, seqs: list, starts: list,
           precision: str = "fp32") -> list:
    """[(len(seq) - start, vocab) float32 logits] for each sequence; the
    kind of model is the configuration's ``reference``, the module
    ``perfbench/reference/<kind>.py``."""
    if precision not in ("fp32", "fp8"):
        raise ValueError(f"precision {precision!r}: fp32 or fp8")
    mod = module(config)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return mod.logits(config, params, seqs, starts,
                              precision == "fp8")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def module(config: dict):
    """The reference module that the configuration's ``reference`` names:
    its ``logits`` and the FLOP counts ``prefill_flops`` and
    ``decode_flops`` of the model it writes out."""
    return importlib.import_module(f"perfbench.reference.{config['reference']}")
