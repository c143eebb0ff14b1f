"""Kernel registry — the seam between RCB kernel opcodes and hand kernels,
with the autotune cache of their plans.

The port's counterpart of ``repro.kernels.registry``, with the
``attention``, ``matmul_int8``, ``matmul_int8_i32``, ``ssm_scan`` and
``wkv6`` specs. Each spec holds the hand-kernel wrapper, its plain PyTorch
version, the shape contract and the kernel's candidate plans. Each wrapper
calls a ``torch.library.custom_op`` (namespace ``aeg``) whose CPU
implementation is the plain version, whose CUDA implementation is the hand
kernel, and whose vmap rule folds a batch of lanes into the kernel's own
leading axis, as ``pallas_call``'s batching rule does for the JAX
package's ``jax.vmap``. The op attr ``impl`` keeps its meaning for
programs written by the JAX package: ``"ref"`` runs the plain version,
``"pallas"`` (or no ``impl``) runs the hand kernel. The hand kernel's
wrapper computes the plain version itself for CPU tensors; on CUDA tensors
it launches the kernel or raises. Block sizes in an op's ``params`` attr
were tuned for the TPU's VMEM and are not read: each CUDA kernel loops over
any sequence length and masks any M, N or K, so unlike the JAX registry
nothing pads a ragged T and no block size has to divide a dimension.

Autotune: ``autotune()`` times a kernel's own plans on the card (CUDA
events, the median of ``TIMED_LAUNCHES`` launches after a warm-up) and
records the winner under the JAX package's key shape,
``name|backend|shapes|extra``. The backend field is the port's own
(``torch-cuda-sm90-132``: compute capability and SM count, which the
default plans depend on; ``torch-cpu``), so no JAX entry ever matches a
call of the port. Winners persist as the JAX package's RIMFS image, one
JSON file at ``kernels/autotune.json`` (``pack_image``/``load_image``);
``Platform.provision`` reloads it, so a re-provisioned process sweeps zero
trials for shapes it has seen. ``call`` looks the winner up for a CUDA
operand (memoised by shapes, dtypes and keywords) and hands it to the
wrapper; without one the wrapper takes its default plan. A kernel with a
single plan (``flash_attention``, its head-dim templates) and every CPU
operand record the default with zero trials.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import rimfs as rimfs_mod
from repro_torch.dtypes import name_of, torch_dtype
from repro_torch.kernels.common import sm_count
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref_bshd
from repro_torch.kernels.int8_matmul import ops as im_ops
from repro_torch.kernels.int8_matmul.ref import (int8_matmul_i32_ref,
                                                 int8_matmul_ref)
from repro_torch.kernels.ssm_scan import ops as ss_ops
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.kernels.wkv6 import ops as wk_ops
from repro_torch.kernels.wkv6.ref import wkv6_ref_bthk

AUTOTUNE_FILE = "kernels/autotune.json"
WARMUP_LAUNCHES = 2
TIMED_LAUNCHES = 10
# the device spins this many cycles (about 25 ms on an H100) ahead of the
# timed launches, so that the host has queued them all before the first runs
HOLD_CYCLES = 50_000_000


def _matmul_candidates(x, w, *rest, **kw):
    return im_ops.candidates(x.shape[0], w.shape[1], x.shape[1],
                             sm_count(x.device.index))


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One kernel: hand-kernel wrapper + plain version + contract + its
    candidate plans (None: the kernel has one plan)."""
    name: str
    kernel: Callable                    # (*args, [plan=], **kw) -> out
    ref: Callable                       # (*args, **kw) -> out
    contract: Callable                  # (*args) -> None or ValueError
    candidates: Optional[Callable] = None   # (*args, **kw) -> [plan dict]


def backend(device: torch.device) -> str:
    """The key's backend field: ``torch-cuda-sm<cc>-<SMs>`` on a card,
    ``torch-cpu`` on the CPU; never one of the JAX package's."""
    if device.type != "cuda":
        return f"torch-{device.type}"
    major, minor = torch.cuda.get_device_capability(device)
    return f"torch-cuda-sm{major}{minor}-{sm_count(device.index)}"


def _extra(kwargs: Optional[dict]) -> str:
    """The key's last field: the keywords as sorted JSON of strings, a
    dtype by its numpy-style name (``"float32"``), as the JAX key has it."""
    return json.dumps({k: name_of(v) if isinstance(v, torch.dtype) else str(v)
                       for k, v in (kwargs or {}).items()}, sort_keys=True)


def _on_card(t: torch.Tensor) -> bool:
    """Plans apply, and are timed, only where the hand kernel runs: on a
    CUDA operand (a CPU operand computes the plain version)."""
    return t.is_cuda


def cuda_launch_ms(fn, warmup: int = WARMUP_LAUNCHES,
                   iters: int = TIMED_LAUNCHES) -> float:
    """Median device time of one ``fn()`` in ms: ``warmup`` calls, then
    ``iters`` calls, each between two CUDA events on the current stream.
    The stream is held busy (``HOLD_CYCLES``) while the host queues them,
    so the device runs them back to back: no host time (the wrapper's
    Python, the launch) falls between an event pair."""
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(HOLD_CYCLES)
    for start, end in events:
        start.record()
        fn()
        end.record()
    events[-1][1].synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


class KernelRegistry:
    """Kernel specs + per-(shape, dtype, backend) autotuned plans."""

    def __init__(self):
        self.specs: dict[str, KernelSpec] = {}
        # signature -> {"params": dict, "us": float|None, "source": str}
        self.winners: dict[str, dict] = {}
        self.sweep_trials = 0           # timed candidate runs, ever
        self.stats: dict[str, int] = {}
        # signature -> [{"params": plan, "ms": median}] of the sweeps run
        self.sweeps: dict[str, list] = {}
        self._memo: dict = {}           # call site -> plan (None: default)

    # ------------------------------------------------------------- plumbing
    def register(self, spec: KernelSpec) -> None:
        self.specs[spec.name] = spec

    def get(self, name: str) -> KernelSpec:
        spec = self.specs.get(name)
        if spec is None:
            raise NotImplementedError(
                f"kernel {name!r} is not ported to PyTorch yet; ported: "
                f"{sorted(self.specs)}")
        return spec

    def _count(self, key: str, n: int = 1) -> None:
        self.stats[key] = self.stats.get(key, 0) + n

    def signature(self, name: str, args, kwargs: Optional[dict] = None) -> str:
        """``name|backend|shapes|extra``, shapes as
        ``(1, 512, 12, 128):bfloat16`` joined by ``;``."""
        shapes = ";".join(f"{tuple(a.shape)}:{name_of(a.dtype)}"
                          for a in args)
        return f"{name}|{backend(args[0].device)}|{shapes}|{_extra(kwargs)}"

    # ------------------------------------------------------------- dispatch
    def params_for(self, name: str, args,
                   kwargs: Optional[dict] = None) -> Optional[dict]:
        """The winning plan for this call site, or None (the wrapper's
        default plan). Memoised on the site's names, shapes, dtypes and
        keywords, so a hit builds no key string."""
        site = (name, args[0].device,
                tuple((a.shape, a.dtype) for a in args),
                tuple(sorted((kwargs or {}).items())))
        try:
            plan = self._memo[site]
        except KeyError:
            hit = self.winners.get(self.signature(name, args, kwargs))
            plan = dict(hit["params"]) if hit and hit["params"] else None
            self._memo[site] = plan
        self._count("params_hit" if plan is not None else "params_default")
        return plan

    def call(self, name: str, *args, impl: Optional[str] = None, **kwargs):
        """Dispatch one kernel: ``impl="ref"`` -> plain version, else the
        hand kernel with the winning plan of a CUDA call site."""
        spec = self.get(name)
        spec.contract(*args)
        if impl == "ref":
            return spec.ref(*args, **kwargs)
        if impl not in (None, "pallas"):
            raise ValueError(f"kernel {name!r}: unknown impl {impl!r} "
                             f"(expected 'pallas' or 'ref')")
        if spec.candidates is not None and _on_card(args[0]):
            plan = self.params_for(name, args, kwargs)
            if plan is not None:
                return spec.kernel(*args, plan=plan, **kwargs)
        return spec.kernel(*args, **kwargs)

    # ------------------------------------------------------------- autotune
    def autotune(self, name: str, *args, **kwargs):
        """Time the spec's candidate plans at this call site; returns
        ``(winning plan, timed trials run)``. A cached winner (including
        one loaded from a RIMFS image) costs zero trials, and so does a
        spec with one plan or a CPU operand (recorded as the default).
        Every candidate gives the same function: the sweep picks by time
        alone. Its launches count in the wrapper's ``launches``."""
        spec = self.get(name)
        spec.contract(*args)
        key = self.signature(name, args, kwargs)
        hit = self.winners.get(key)
        if hit is not None:
            self._count("autotune_hit")
            return dict(hit["params"]), 0
        self._memo.clear()
        if spec.candidates is None or not _on_card(args[0]):
            self.winners[key] = {"params": {}, "us": None,
                                 "source": "default"}
            return {}, 0
        timed = []
        for cand in spec.candidates(*args, **kwargs):
            ms = cuda_launch_ms(lambda c=cand: spec.kernel(*args, plan=c,
                                                           **kwargs))
            timed.append({"params": cand, "ms": ms})
        best = min(timed, key=lambda t: t["ms"])
        self.sweep_trials += len(timed)
        self._count("autotune_sweep")
        self.sweeps[key] = timed
        self.winners[key] = {"params": dict(best["params"]),
                             "us": best["ms"] * 1e3, "source": "sweep"}
        return dict(best["params"]), len(timed)

    # ----------------------------------------------------------- persistence
    def pack_image(self) -> bytes:
        """Serialize the winner table as a RIMFS image (one JSON file), the
        JAX package's bytes for the same table."""
        payload = json.dumps({"version": 1, "winners": self.winners},
                             sort_keys=True).encode()
        return rimfs_mod.pack(
            {AUTOTUNE_FILE: np.frombuffer(payload, np.uint8)})

    def load_image(self, image) -> int:
        """Merge winners from a RIMFS image (bytes or a mounted RIMFS);
        an existing key wins. Returns the number of entries installed."""
        fs = rimfs_mod.mount(image) \
            if isinstance(image, (bytes, bytearray, memoryview)) else image
        data = json.loads(fs.read(AUTOTUNE_FILE).numpy().tobytes().decode())
        if data.get("version") != 1:
            raise ValueError(
                f"autotune image version {data.get('version')!r} != 1")
        n = 0
        for key, entry in data["winners"].items():
            if key not in self.winners:
                self.winners[key] = {"params": dict(entry["params"]),
                                     "us": entry.get("us"),
                                     "source": "loaded"}
                n += 1
        self._memo.clear()
        return n

    def reset(self) -> None:
        """Drop all winners and counters (a fresh provision)."""
        self.winners.clear()
        self.sweeps.clear()
        self._memo.clear()
        self.sweep_trials = 0
        self.stats.clear()


def _build_default_registry() -> KernelRegistry:
    reg = KernelRegistry()
    reg.register(KernelSpec("attention", fa_ops.flash_attention,
                            attention_ref_bshd, fa_ops.check_contract))
    reg.register(KernelSpec("matmul_int8", im_ops.int8_matmul,
                            int8_matmul_ref, im_ops.check_contract,
                            _matmul_candidates))
    reg.register(KernelSpec("matmul_int8_i32", im_ops.int8_matmul_i32,
                            int8_matmul_i32_ref, im_ops.check_contract_i32,
                            _matmul_candidates))
    reg.register(KernelSpec("ssm_scan", ss_ops.ssm_scan, ssm_scan_ref,
                            ss_ops.check_contract,
                            lambda *a, **kw: ss_ops.candidates()))
    reg.register(KernelSpec("wkv6", wk_ops.wkv6, wkv6_ref_bthk,
                            wk_ops.check_contract,
                            lambda *a, **kw: wk_ops.candidates()))
    return reg


REGISTRY = _build_default_registry()


# ---------------------------------------------------------------------------
# Module-level API (the singleton most call sites use)
# ---------------------------------------------------------------------------

def get(name: str) -> KernelSpec:
    return REGISTRY.get(name)


def call(name: str, *args, **kwargs):
    return REGISTRY.call(name, *args, **kwargs)


def autotune(name: str, *args, **kwargs):
    return REGISTRY.autotune(name, *args, **kwargs)


def params_for(name: str, args, kwargs: Optional[dict] = None):
    return REGISTRY.params_for(name, args, kwargs)


def pack_image() -> bytes:
    return REGISTRY.pack_image()


def load_image(image) -> int:
    return REGISTRY.load_image(image)


def reset() -> None:
    REGISTRY.reset()


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
