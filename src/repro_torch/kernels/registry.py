"""Kernel registry — the seam between RCB kernel opcodes and hand kernels.

The port's counterpart of ``repro.kernels.registry``, with the
``attention``, ``matmul_int8``, ``ssm_scan`` and ``wkv6`` specs. Each spec
holds the hand-kernel wrapper, its plain PyTorch version and the shape
contract. Each wrapper calls a ``torch.library.custom_op`` (namespace
``aeg``) whose CPU implementation is the plain version, whose CUDA
implementation is the hand kernel, and whose vmap rule folds a batch of
lanes into the kernel's own leading axis, as ``pallas_call``'s batching
rule does for the JAX package's ``jax.vmap``. The op attr
``impl`` keeps its meaning for programs written by the JAX package:
``"ref"`` runs the plain version, ``"pallas"`` (or no ``impl``) runs the
hand kernel. The hand kernel's wrapper computes the plain version itself
for CPU tensors; on CUDA tensors it launches the kernel or raises. Block
sizes in an op's ``params`` attr were tuned for the TPU's VMEM and are not
read: each CUDA kernel fixes its own tiles, loops over any sequence
length and masks any M, N or K, so unlike the JAX registry nothing pads a
ragged T and no block size has to divide a dimension. Autotuning is not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.dtypes import torch_dtype
from repro_torch.kernels.flash_attention.ref import attention_ref_bshd
from repro_torch.kernels.int8_matmul import ops as im_ops
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref
from repro_torch.kernels.ssm_scan import ops as ss_ops
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.kernels.wkv6 import ops as wk_ops
from repro_torch.kernels.wkv6.ref import wkv6_ref_bthk


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One kernel: hand-kernel wrapper + plain version + contract."""
    name: str
    kernel: Callable                    # (*args, **kw) -> out
    ref: Callable                       # (*args, **kw) -> out
    contract: Callable                  # (*args) -> None or ValueError


SPECS: dict[str, KernelSpec] = {
    "attention": KernelSpec("attention", fa_ops.flash_attention,
                            attention_ref_bshd, fa_ops.check_contract),
    "matmul_int8": KernelSpec("matmul_int8", im_ops.int8_matmul,
                              int8_matmul_ref, im_ops.check_contract),
    "ssm_scan": KernelSpec("ssm_scan", ss_ops.ssm_scan, ssm_scan_ref,
                           ss_ops.check_contract),
    "wkv6": KernelSpec("wkv6", wk_ops.wkv6, wkv6_ref_bthk,
                       wk_ops.check_contract),
}


def get(name: str) -> KernelSpec:
    spec = SPECS.get(name)
    if spec is None:
        raise NotImplementedError(
            f"kernel {name!r} is not ported to PyTorch yet; ported: "
            f"{sorted(SPECS)}")
    return spec


def call(name: str, *args, impl: Optional[str] = None, **kwargs):
    """Dispatch one kernel: ``impl="ref"`` -> plain version, else the hand
    kernel."""
    spec = get(name)
    spec.contract(*args)
    if impl == "ref":
        return spec.ref(*args, **kwargs)
    if impl not in (None, "pallas"):
        raise ValueError(f"kernel {name!r}: unknown impl {impl!r} "
                         f"(expected 'pallas' or 'ref')")
    return spec.kernel(*args, **kwargs)


def call_op(name: str, srcs, attrs) -> Any:
    """Kernel-op entry used by core/oplib: RCB attrs -> keyword signature."""
    attrs = attrs or {}
    if name == "attention":
        return call("attention", *srcs, impl=attrs.get("impl"),
                    causal=bool(attrs.get("causal", True)))
    if name == "matmul_int8":
        return call("matmul_int8", *srcs, impl=attrs.get("impl"),
                    out_dtype=torch_dtype(attrs.get("out_dtype", "float32")))
    return call(name, *srcs, impl=attrs.get("impl"))


def launch_counters() -> dict:
    """Every kernel wrapper, by the name of its kernel: each holds the
    ``launches`` count of its kernel (``int8_matmul``'s counts both of
    its wrappers)."""
    return {"flash_attention": fa_ops.flash_attention,
            "ssm_scan": ss_ops.ssm_scan, "wkv6": wk_ops.wkv6,
            "int8_matmul": im_ops.int8_matmul}


def linked_handler(name: str, attrs) -> Callable:
    """The positional handler ``fn(*srcs)`` the RHAL ``link_compute`` slot
    hands to the linker for a kernel opcode."""
    get(name)                          # unported kernels fail at link time

    def handler(*srcs):
        return call_op(name, srcs, attrs)
    return handler
