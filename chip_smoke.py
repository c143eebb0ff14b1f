#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line with its times:

  1. device and build: the card, ``nvidia-smi``'s name and power limit, and
     the nvcc build of every kernel from this checkout's sources;
  2. every kernel against its plain PyTorch version on the card, at the
     served paths' shapes and at the other shapes it takes, with the
     kernel's, the plain version's and the PyTorch library call's times
     (``flash_attention``, also at its tile boundaries and with large
     scores, timed by CUDA events and by ``torch.profiler``'s device time
     beside ``scaled_dot_product_attention``; ``ssm_scan``, ``wkv6``, then
     ``int8_matmul``, bit for bit);
  3. a two-layer full-width fp32 program of each served model (qwen2-1.5B,
     hymba-1.5B, then rwkv6-1.6B): the linked run with the kernels against
     the same program with ``impl="ref"`` on every kernel op;
  4. the served paths, qwen2-1.5B (``slice``), hymba-1.5B
     (``slice_hybrid``) then rwkv6-1.6B (``slice_ssm``), each at full width
     and depth (bf16, random weights
     from ``--seed``) compiled to RCB bytes and a RIMFS image, provisioned
     over protocol v2 into the port's InferenceServer, answering 4 requests
     of B=1, S=512 (two of them pipelined on one connection), with the
     server's peak device memory and each kernel's launches while it
     answered; each response checked bit for bit against a local linked run
     and an interpreted run; then where a request's time goes: one local
     linked run by the host clock and under ``torch.profiler`` (device busy
     time, the top kernels), and the wire's packing and unpacking of one
     response;
  5. the served vision and INT8 paths, each at full width (224 px, 1000
     classes) with random weights from ``--seed``, 4 requests of B=1 (two
     pipelined): a one-op ``MATMUL_INT8`` program at 512 x 1536 x 8960
     (``slice_matmul_int8``, fp32 then bf16 out, each response equal to the
     plain version bit for bit), ResNet-18 fp32 (``slice_resnet18``, held
     to the plain forward at 1e-5) and ResNet-18 INT8
     (``slice_resnet18_int8``, calibrated on the card through the executor's
     probe, held to the same program on the CPU at 1e-5 with the same
     argmax); each provisioned over protocol v2 with each response checked
     bit for bit against a local linked and an interpreted run, with the
     kernels' launches while the server answered, and where a request's
     time goes;
  6. one ``kernels`` line: per kernel its launches on every served path,
     its error against its plain version, its time, its bound and the
     library's.

The last line is ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero; without CUDA the script exits non-zero before any result.
The script imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float16": 989e12,   # tensor cores
                  "float32": 67e12,                  # no TF32: CUDA cores
                  "int8": 1979e12}                   # tensor cores
TOLERANCE = {"float32": 2e-6, "bfloat16": 2e-2,            # test_kernels.py:35
             "float16": 2e-2}
SSM_TOLERANCE = {"float32": 2e-5, "bfloat16": 2e-2}        # test_kernels.py:88
WKV_TOLERANCE = {"float32": 5e-4,                          # test_kernels.py:60
                 "bfloat16": 3e-2}     # of max |y|: test_conformance.py:572
PROGRAM_ATOL = 5e-4                                        # test_conformance.py:700
SEQ = 512                  # tokens per request (B=1)
N_REQUESTS = 4             # the last two pipelined on one connection
RESNET_ATOL = RESNET_RTOL = 1e-5             # test_resnet_rcb.py:31
INT8_AGREEMENT, INT8_DRIFT = 0.6, 0.08       # test_resnet_rcb.py:50-51
MATMUL_INT8_SHAPE = (512, 1536, 8960)        # qwen2-1.5B's MLP up-proj, S=512


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def cuda_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of one call, from CUDA events around ``iters``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled_device_ms(torch, fn, iters: int = 50, warmup: int = 5):
    """Mean device time of one call and the names of what ran: the
    durations of every kernel and copy that ``torch.profiler`` records over
    ``iters`` calls, summed, over ``iters``. Unlike ``cuda_ms`` it leaves
    out the host's time between launches. (None, []) when the profiler
    records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    us = sum(e.time_range.elapsed_us() for e in events)
    return (us / iters / 1e3 if us else None,
            sorted({e.name[:120] for e in events}))


def attention_bound(b, s, sk, h, hkv, d, dtype: str, causal: bool):
    """Least time (ms) for one attention call: q, k, v read once and o
    written once over the memory rate, against the multiply-adds its
    unmasked (q, k) pairs need over the peak rate of the dtype."""
    esize = 4 if dtype == "float32" else 2
    nbytes = (2 * b * s * h * d + 2 * b * sk * hkv * d) * esize
    pairs = sum(min(i + 1, sk) for i in range(s)) if causal else s * sk
    ops = 4 * d * pairs * h * b
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def device_breakdown(torch, fn, top: int = 12) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its host time, the
    device time from CUDA events recorded before and after it on the
    current stream (first to last op, idle gaps included), the device time
    summed over its kernels (the busy share is their ratio), the kernels
    that took the most device time, by name, and the host-side events
    (torch ops, CUDA runtime calls) that took the most host time of their
    own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    elapsed_s = start.elapsed_time(end) / 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    host_top = [{"name": a.key[:90], "calls": a.count,
                 "self_s": a.self_cpu_time_total / 1e6} for a in host[:top]]
    busy_us = sum(us for _, us in by_name.values())
    if not busy_us:
        return {"wall_s": wall_us / 1e6, "device_elapsed_s": elapsed_s,
                "device": "no kernel in the profiler's trace",
                "host_top": host_top}
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"wall_s": wall_us / 1e6, "device_elapsed_s": elapsed_s,
            "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / wall_us,
            "kernels": [{"name": name[:90], "launches": n, "s": us / 1e6}
                        for name, (n, us) in ranked],
            "host_top": host_top}


# the served paths: model name -> (B, S, H, Hkv, D) of its attention
ATTENTION_SHAPES = {"qwen2-1.5b": (1, SEQ, 12, 2, 128),
                    "hymba-1.5b": (1, SEQ, 25, 5, 64)}
SSM_SHAPE = (1, SEQ, 1600, 16)          # hymba-1.5B's SSM_SCAN, fp32
WKV_SHAPE = (1, SEQ, 32, 64)            # rwkv6-1.6B's WKV6 (B, T, H, K), fp32


def phase_attention(torch, seed: int) -> dict:
    """Phase 2a: flash_attention against its plain version on the card."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref_bshd
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def inputs(b, s, sk, h, hkv, d, dtype, q_scale=1.0):
        dt = getattr(torch, dtype)
        q, k, v = [torch.randn(shape, generator=gen, device="cuda")
                   for shape in ((b, s, h, d), (b, sk, hkv, d),
                                 (b, sk, hkv, d))]
        return [(q * q_scale).to(dt), k.to(dt), v.to(dt)]

    # (b, s, sk, h, hkv, d, dtype, causal[, q scale])
    served = ((1, 512, 512, 12, 2, 128), (1, 512, 512, 25, 5, 64))
    cases = [(*shape, "float16", True) for shape in served]
    # S or Sk at the 64-row/64-key tile boundaries and one past them
    for dtype in ("bfloat16", "float16", "float32"):
        for causal in (True, False):
            cases += [(1, n, n, 4, 2, d, dtype, causal)
                      for n, d in ((1, 64), (63, 128), (64, 64), (65, 16),
                                   (127, 128), (129, 64))]
            cases += [(1, 127, 129, 4, 2, 128, dtype, causal),
                      (1, 129, 127, 4, 2, 64, dtype, causal),
                      (1, 1, 129, 4, 2, 128, dtype, causal),
                      (1, 129, 1, 4, 2, 16, dtype, causal)]
    # q scaled by 30: scores near +-100 drive the running max and the
    # rounding of p to the value dtype
    cases += [(*shape, dtype, causal, 30.0) for shape in served
              for dtype in ("bfloat16", "float16") for causal in (True, False)]
    for dtype in ("bfloat16", "float32"):
        cases += [(1, 512, 512, 12, 2, 128, dtype, True),   # the slice
                  (1, 512, 512, 25, 5, 64, dtype, True),    # the hybrid one
                  (2, 128, 128, 4, 2, 16, dtype, True),     # smoke head_dim
                  (1, 256, 256, 8, 2, 64, dtype, True),
                  (1, 200, 200, 12, 2, 128, dtype, True),   # ragged
                  (1, 200, 200, 12, 2, 128, dtype, False),  # ragged, full
                  (1, 512, 512, 12, 2, 128, dtype, False),
                  (1, 100, 300, 12, 2, 128, dtype, True),   # Sk > S
                  (1, 100, 300, 12, 2, 128, dtype, False),
                  (1, 300, 100, 12, 2, 128, dtype, True),   # Sk < S
                  (1, 300, 100, 12, 2, 128, dtype, False)]
    worst = 0.0
    results = []
    for case in cases:
        b, s, sk, h, hkv, d, dtype, causal = case[:8]
        q_scale = case[8] if len(case) > 8 else 1.0
        q, k, v = inputs(b, s, sk, h, hkv, d, dtype, q_scale)
        out = flash_attention(q, k, v, causal=causal).float()
        ref = attention_ref_bshd(q, k, v, causal=causal).float()
        torch.cuda.synchronize()
        tol = TOLERANCE[dtype]
        err = (out - ref).abs().max().item()
        if not torch.allclose(out, ref, atol=tol, rtol=tol):
            raise AssertionError(f"flash_attention {case}: max |err| {err} "
                                 f"beyond atol=rtol={tol}")
        worst = max(worst, err)
        results.append({"shape": [b, s, sk, h, hkv, d], "dtype": dtype,
                        "causal": causal, "q_scale": q_scale,
                        "max_abs_err": err})

    # times at each served path's shape: bf16, causal, Sk = S. "ms" and
    # "library_ms" are CUDA events around 50 calls (host time between
    # launches included); "device_ms" and "library_device_ms" the device
    # time the profiler records over 50 calls (every kernel SDPA launches).
    timed = {}
    for model, (b, s, h, hkv, d) in ATTENTION_SHAPES.items():
        q, k, v = inputs(b, s, s, h, hkv, d, "bfloat16")

        def library():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True)
        bound_ms, bound_by = attention_bound(b, s, s, h, hkv, d, "bfloat16",
                                             True)

        def kernel():
            return flash_attention(q, k, v)
        library_device_ms, library_kernels = profiled_device_ms(torch,
                                                                library)
        timed[model] = {
            "shape": [b, s, s, h, hkv, d], "dtype": "bfloat16",
            "ms": cuda_ms(torch, kernel),
            "device_ms": profiled_device_ms(torch, kernel)[0],
            "plain_ms": cuda_ms(torch, lambda: attention_ref_bshd(q, k, v)),
            "library_ms": cuda_ms(torch, library),
            "library_device_ms": library_device_ms,
            "library_kernels": library_kernels,
            "library_max_abs_err": (
                library().transpose(1, 2).float()
                - attention_ref_bshd(q, k, v).float()).abs().max().item(),
            "bound_ms": bound_ms, "bound_by": bound_by}
    emit("kernels_vs_plain", kernel="flash_attention", cases=results,
         timed=timed)
    first = timed["qwen2-1.5b"]          # the row's numbers: slice 1's shape
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:69",
            "design": "mma.sync bf16/f16, fp32 CUDA cores",
            "max_abs_err": worst, "ms": first["ms"],
            "device_ms": first["device_ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"],
            "library_device_ms": first["library_device_ms"],
            "timed_shape": first["shape"], "by_path": timed}


def ssm_scan_bound(b, t, di, n, dtype: str):
    """Least time (ms) for one selective scan: da, bx and c read once and y
    written once over the memory rate, against about 5 operations per
    (t, d, n) (exp, the recurrence's multiply-add, the product with c and
    its share of the sum over n) over the peak rate of the dtype."""
    esize = 4 if dtype == "float32" else 2
    nbytes = (2 * b * t * di * n + b * t * n + b * t * di) * esize
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 5 * b * t * di * n / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def phase_ssm_scan(torch, seed: int) -> dict:
    """Phase 2b: ssm_scan against its plain version on the card."""
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 3)

    def inputs(b, t, di, n, dtype, da_value=None):
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        dt = getattr(torch, dtype)
        da = (-torch.exp(rand(b, t, di, n)) if da_value is None else
              torch.full((b, t, di, n), da_value, device="cuda"))
        return [a.to(dt) for a in (da, rand(b, t, di, n), rand(b, t, n))]

    cases = [(*SSM_SHAPE, "float32", None),        # the hybrid slice
             (*SSM_SHAPE, "bfloat16", None),
             (1, 37, 100, 16, "float32", None),    # ragged T, di % 32 != 0
             (1, 37, 100, 16, "bfloat16", None),
             (2, 64, 32, 4, "float32", None),      # N=4 (smoke), B=2
             (2, 128, 64, 8, "float32", None),
             (1, 64, 96, 32, "float32", None),
             (1, 64, 100, 16, "float32", 0.0),     # identity decay
             (1, 64, 100, 16, "float32", -80.0)]   # extreme decay
    worst = 0.0
    results = []
    for case in cases:
        b, t, di, n, dtype, da_value = case
        da, bx, c = inputs(b, t, di, n, dtype, da_value)
        out = ssm_scan(da, bx, c).float()
        ref = ssm_scan_ref(da, bx, c).float()
        torch.cuda.synchronize()
        tol = SSM_TOLERANCE[dtype]
        err = (out - ref).abs().max().item()
        if not (torch.isfinite(out).all()
                and torch.allclose(out, ref, atol=tol, rtol=tol)):
            raise AssertionError(f"ssm_scan {case}: max |err| {err} beyond "
                                 f"atol=rtol={tol}")
        worst = max(worst, err)
        results.append({"shape": [b, t, di, n], "dtype": dtype,
                        "da": "-exp(normal)" if da_value is None
                        else da_value, "max_abs_err": err})

    da, bx, c = inputs(*SSM_SHAPE, "float32")
    kernel_ms = cuda_ms(torch, lambda: ssm_scan(da, bx, c))
    plain_ms = cuda_ms(torch, lambda: ssm_scan_ref(da, bx, c), iters=5,
                       warmup=1)
    bound_ms, bound_by, nbytes = ssm_scan_bound(*SSM_SHAPE, "float32")
    note = "no single PyTorch call computes a selective scan"
    emit("kernels_vs_plain", kernel="ssm_scan", cases=results,
         kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=None,
         library_note=note, bound_ms=bound_ms, bound_by=bound_by,
         bound_bytes=nbytes, timed_shape=list(SSM_SHAPE),
         timed_dtype="float32")
    return {"name": "ssm_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan/kernel.py:42",
            "max_abs_err": worst, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "library_note": note, "timed_shape": list(SSM_SHAPE)}


def wkv6_bound(b, t, h, kk, dtype: str):
    """Least time (ms) for one WKV6 call: r, k, v, lw read once, u (fp32)
    read once and y written once over the memory rate, against the kernel's
    operations (k*v and two multiply-adds per (b, t, h, i, o); the exp and
    the bonus term, about 4, per (b, t, h, i)) over the peak rate of the
    dtype."""
    esize = 4 if dtype == "float32" else 2
    nbytes = 5 * b * t * h * kk * esize + h * kk * 4
    ops = 5 * b * t * h * kk * kk + 4 * b * t * h * kk
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes, ops


def phase_wkv6(torch, seed: int) -> dict:
    """Phase 2c: wkv6 against its plain version on the card."""
    from repro_torch.kernels.wkv6.ops import wkv6
    from repro_torch.kernels.wkv6.ref import wkv6_ref_bthk
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 4)

    def inputs(b, t, h, kk, dtype, lw_value=None, u_scale=0.5):
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        dt = getattr(torch, dtype)
        lw = (-torch.exp(rand(b, t, h, kk)) if lw_value is None else
              torch.full((b, t, h, kk), lw_value, device="cuda"))
        return ([a.to(dt) for a in (rand(b, t, h, kk),
                                    0.3 * rand(b, t, h, kk),
                                    rand(b, t, h, kk), lw)]
                + [u_scale * rand(h, kk)])

    cases = [(*WKV_SHAPE, "float32", None, 0.5),       # the ssm slice
             (*WKV_SHAPE, "bfloat16", None, 0.5),
             (2, 37, 3, 16, "float32", None, 0.5),     # ragged T, smoke K
             (2, 37, 3, 16, "bfloat16", None, 0.5),
             (1, 64, 4, 8, "float32", None, 0.5),      # K = 8
             (1, 64, 4, 32, "float32", None, 0.5),     # K = 32
             (1, 64, 4, 16, "float32", 0.0, 0.5),      # no decay
             (1, 64, 4, 16, "float32", -80.0, 0.5),    # extreme decay
             (1, 64, 4, 64, "float32", None, 0.0)]     # u = 0
    worst = 0.0
    results = []
    for case in cases:
        b, t, h, kk, dtype, lw_value, u_scale = case
        args = inputs(b, t, h, kk, dtype, lw_value, u_scale)
        out = wkv6(*args).float()
        ref = wkv6_ref_bthk(*args).float()
        torch.cuda.synchronize()
        tol = WKV_TOLERANCE[dtype]
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        ok = (torch.allclose(out, ref, atol=tol, rtol=tol)
              if dtype == "float32" else err <= tol * scale)
        if not (torch.isfinite(out).all() and ok):
            raise AssertionError(f"wkv6 {case}: max |err| {err} (max |y| "
                                 f"{scale}) beyond tolerance {tol}")
        worst = max(worst, err)
        results.append({"shape": [b, t, h, kk], "dtype": dtype,
                        "lw": "-exp(normal)" if lw_value is None
                        else lw_value, "u_scale": u_scale,
                        "max_abs_err": err, "max_abs_y": scale})

    args = inputs(*WKV_SHAPE, "float32")
    kernel_ms = cuda_ms(torch, lambda: wkv6(*args))
    plain_ms = cuda_ms(torch, lambda: wkv6_ref_bthk(*args), iters=5,
                       warmup=1)
    bound_ms, bound_by, nbytes, ops = wkv6_bound(*WKV_SHAPE, "float32")
    note = "no single PyTorch call computes the WKV recurrence"
    emit("kernels_vs_plain", kernel="wkv6", cases=results,
         kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=None,
         library_note=note, bound_ms=bound_ms, bound_by=bound_by,
         bound_bytes=nbytes, bound_operations=ops,
         timed_shape=list(WKV_SHAPE), timed_dtype="float32")
    return {"name": "wkv6", "route": "cuda",
            "source": "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/wkv6/kernel.py:68",
            "max_abs_err": worst, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "library_note": note, "timed_shape": list(WKV_SHAPE)}


def resnet_conv_gemms(cfg, batch: int = 1) -> dict:
    """Every CONV2D_I8 of ResNet-18 as the GEMM its im2col gives the kernel:
    (M, K, N) -> how many convs of the network have it."""
    from repro_torch.models.resnet import resnet_specs
    specs = resnet_specs(cfg)
    size = cfg.image_size // 2                       # after the 7x7/2 stem
    kh, kw, cin, cout = specs["stem_conv"].shape
    gemms = {(batch * size * size, kh * kw * cin, cout): 1}
    if cfg.image_size >= 64:
        size //= 2                                   # the 3x3/2 maxpool
    for si, n_blocks in enumerate(cfg.stage_sizes):
        for bi in range(n_blocks):
            pre = f"s{si}b{bi}_"
            stride = 2 if (bi == 0 and si > 0) else 1
            out = size // stride
            for name in ("conv1", "conv2", "proj"):
                if pre + name not in specs:
                    continue
                kh, kw, cin, cout = specs[pre + name].shape
                key = (batch * out * out, kh * kw * cin, cout)
                gemms[key] = gemms.get(key, 0) + 1
            size = out
    return gemms


def int8_matmul_bound(m, k, n, out: str):
    """Least time (ms) for one INT8 GEMM: x, w (and a float32 scale when
    the output is scaled) read once and the output written once over the
    memory rate, against its 2 M K N operations over the int8 tensor-core
    rate."""
    esize = {"int32": 4, "float32": 4, "bfloat16": 2, "float16": 2}[out]
    nbytes = m * k + k * n + (0 if out == "int32" else 4 * n) \
        + m * n * esize
    ops = 2 * m * k * n
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S["int8"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes, ops


def int_mm_accepts(m, k, n) -> bool:
    """The shapes ``torch._int_mm`` (cuBLAS, s8 -> s32) takes on CUDA."""
    return m > 16 and k % 8 == 0 and n % 8 == 0


def phase_int8_matmul(torch, seed: int) -> dict:
    """Phase 2d: int8_matmul against its plain version on the card, bit for
    bit in every epilogue."""
    from repro_torch.configs.resnet18 import CONFIG
    from repro_torch.kernels.int8_matmul.ops import (int8_matmul,
                                                     int8_matmul_i32,
                                                     splits_for)
    from repro_torch.kernels.int8_matmul.ref import (int8_matmul_i32_ref,
                                                     int8_matmul_ref)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 5)

    def operands(m, k, n, extreme=None):
        if extreme is None:
            x = torch.randint(-127, 128, (m, k), generator=gen, device="cuda")
            w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda")
        else:
            x = torch.full((m, k), extreme, device="cuda")
            w = torch.full((k, n), -127 if extreme < 0 else 127,
                           device="cuda")
        scale = torch.rand(n, generator=gen, device="cuda")
        return x.to(torch.int8), w.to(torch.int8), scale

    def run(x, w, scale, out):
        if out == "int32":
            return int8_matmul_i32(x, w), int8_matmul_i32_ref(x, w)
        dt = getattr(torch, out)
        return (int8_matmul(x, w, scale, dt),
                int8_matmul_ref(x, w, scale, dt))

    conv_gemms = resnet_conv_gemms(CONFIG)
    cases = [(*MATMUL_INT8_SHAPE, "float32", None),
             (*MATMUL_INT8_SHAPE, "bfloat16", None),
             (*MATMUL_INT8_SHAPE, "float16", None)]
    cases += [(m, k, n, "int32", None) for m, k, n in sorted(conv_gemms)]
    cases += [(129, 33, 131, "int32", None), (129, 33, 131, "bfloat16", None),
              (77, 1, 5, "float32", None), (1, 300, 257, "int32", None),
              (1, 300, 257, "float32", None), (17, 4097, 19, "int32", None),
              (49, 4608, 512, "int32", 127), (49, 4608, 512, "int32", -127),
              (49, 4608, 512, "float32", -128)]
    results = []
    for m, k, n, out, extreme in cases:
        got, want = run(*operands(m, k, n, extreme), out)
        torch.cuda.synchronize()
        if not (got.dtype == want.dtype and torch.equal(got, want)):
            raise AssertionError(f"int8_matmul ({m}, {k}, {n}) {out} "
                                 f"extreme={extreme}: not bit-identical "
                                 f"to the plain version")
        results.append({"mkn": [m, k, n], "out": out, "extreme": extreme,
                        "bit_identical": True})

    # times: the MATMUL_INT8 slice's shape, then ResNet-18's largest-M and
    # largest-K CONV2D_I8 GEMMs (the stem, s3's conv2)
    timed = {}
    big_m = max(conv_gemms)
    big_k = max(conv_gemms, key=lambda g: (g[1], g[0]))
    for label, (m, k, n), out in (("matmul_int8", MATMUL_INT8_SHAPE,
                                   "float32"),
                                  ("resnet_largest_m", big_m, "int32"),
                                  ("resnet_largest_k", big_k, "int32")):
        x, w, scale = operands(m, k, n)
        if out == "int32":
            def kernel():
                return int8_matmul_i32(x, w)

            def plain():
                return int8_matmul_i32_ref(x, w)
        else:
            def kernel():
                return int8_matmul(x, w, scale)

            def plain():
                return int8_matmul_ref(x, w, scale)
        bound_ms, bound_by, nbytes, ops = int8_matmul_bound(m, k, n, out)
        library_ms = library_wt_ms = None
        if int_mm_accepts(m, k, n):
            library_ms = cuda_ms(torch, lambda: torch._int_mm(x, w))
            wt = w.t().contiguous().t()           # the same w, column-major
            library_wt_ms = cuda_ms(torch, lambda: torch._int_mm(x, wt))
        timed[label] = {
            "mkn": [m, k, n], "out": out, "ms": cuda_ms(torch, kernel),
            "plain_ms": cuda_ms(torch, plain, iters=10, warmup=2),
            "library_ms": library_ms,
            "library_ms_column_major_w": library_wt_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_bytes": nbytes,
            "bound_operations": ops,
            "splits": splits_for(m, n, k, torch.cuda.get_device_properties(
                0).multi_processor_count)}
    note = ("torch._int_mm (cuBLAS, s8 -> s32: the int32 sums without the "
            "scaled epilogue) on the kernel's row-major w; it takes M > 16 "
            "and K, N multiples of 8 only. library_ms_column_major_w: the "
            "same call on a column-major copy of w made before the timing")
    emit("kernels_vs_plain", kernel="int8_matmul", cases=results,
         timed=timed, library_note=note)
    first = timed["matmul_int8"]
    return {"name": "int8_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/int8_matmul/csrc/"
                      "int8_matmul.cu",
            "replaces": "src/repro/kernels/int8_matmul/kernel.py:39",
            "max_abs_err": 0.0, "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"],
            "library_note": note, "timed_shape": first["mkn"],
            "by_shape": timed}


def with_plain_kernels(prog):
    """The same program with ``impl="ref"`` on every kernel op (ATTENTION,
    SSM_SCAN, WKV6), its GRAPH_EXEC artifacts attached."""
    from repro_torch.core.oplib import OP_KERNELS
    from repro_torch.core.rcb import RCB, RCBOp, RCBProgram
    blocks = [RCB(blk.block_id, blk.block_type, blk.deps, tuple(
        RCBOp(op.op, op.dsts, op.srcs, {**op.attrs, "impl": "ref"})
        if op.op in OP_KERNELS else op for op in blk.ops))
        for blk in prog.blocks]
    return RCBProgram(prog.name + "_plain_kernels", prog.tensors, blocks,
                      dict(prog.artifacts))


def request_inputs(torch, cfg, glob, gen):
    import numpy as np
    from repro_torch.models.transformer import embed_inputs
    tokens = torch.randint(0, cfg.vocab_size, (1, SEQ), generator=gen,
                           device=gen.device)
    ins = {"hidden": embed_inputs(cfg, glob, tokens).cpu()}
    if cfg.family != "ssm" and cfg.use_rope:
        ins["positions"] = np.arange(SEQ, dtype=np.int32)[None].copy()
    return ins


def phase_two_layer_fp32(torch, cfg, seed: int) -> None:
    """Phase 3: full-width fp32 program, kernels vs their plain versions."""
    from repro_torch.core import rbl
    from repro_torch.core.executor import Executor
    from repro_torch.core.rctc import compile_transformer_block
    from repro_torch.core.rtpm import Platform
    from repro_torch.models.transformer import init_params, split_params
    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    params = init_params(cfg2, seed)
    prog, image = compile_transformer_block(cfg2, params, 1, SEQ)
    glob = split_params(params)[0]       # layer weights go with params
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    ins = request_inputs(torch, cfg2, glob, gen)
    del params, glob
    plat = Platform()
    plat.provision(image=image, program_bytes=prog.encode())
    ex = Executor(driver=plat.driver)
    t1 = time.perf_counter()
    out = ex.run(plat.bind(artifacts=prog.artifacts), inputs=ins)["logits"]
    plain = ex.run(rbl.bind(with_plain_kernels(prog), rimfs=plat.rimfs,
                            driver=plat.driver), inputs=ins)["logits"]
    torch.cuda.synchronize()
    err = (out - plain).abs().max().item()
    if not (torch.isfinite(out).all() and err <= PROGRAM_ATOL):
        raise AssertionError(f"two-layer fp32 {cfg.name} program: kernels "
                             f"vs plain versions max |err| {err} > "
                             f"{PROGRAM_ATOL}")
    emit("two_layer_fp32", model=cfg.name, layers=2, seq=SEQ,
         image_bytes=len(image),
         setup_s=t1 - t0, run_s=time.perf_counter() - t1,
         logits_max_abs_err=err, atol=PROGRAM_ATOL)


def kernel_counters() -> dict:
    """Every kernel wrapper of the port, by the name of its row
    (``int8_matmul`` counts the launches of both of its wrappers)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.int8_matmul.ops import int8_matmul
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    from repro_torch.kernels.wkv6.ops import wkv6
    return {"flash_attention": flash_attention, "ssm_scan": ssm_scan,
            "wkv6": wkv6, "int8_matmul": int8_matmul}


def serve(torch, image: bytes, prog_bytes: bytes, requests: list,
          output: str, artifacts=None) -> dict:
    """Provision ``image`` and ``prog_bytes`` over protocol v2 into the
    port's InferenceServer on the card and send ``requests`` (the first
    N_REQUESTS - 2 one at a time, the last two pipelined on one
    connection). Every kernel's launch count is set to 0 just before and
    read just after: that run is the path's main run. The device memory
    peak is the server's own: reset here, read after the last reply."""
    from repro_torch.serving.server import Client, InferenceServer
    big = (1 << 32) - 1                  # PROVISION and reply frames
    torch.cuda.reset_peak_memory_stats()
    serve_base = torch.cuda.memory_allocated()
    counters = kernel_counters()
    for wrapper in counters.values():    # the main path starts here
        wrapper.launches = 0
    server = InferenceServer(max_frame=big, artifacts=artifacts)
    server.start()
    client = Client(server.address, max_frame=big)
    try:
        t1 = time.perf_counter()
        client.provision(image, prog_bytes)
        t_provision = time.perf_counter() - t1
        t_start = time.perf_counter()
        responses, latencies = [], []
        n_serial = len(requests) - 2
        for req in requests[:n_serial]:
            ts = time.perf_counter()
            responses.append(client.infer(**req)[output])
            latencies.append(time.perf_counter() - ts)
        sent = []
        for req in requests[n_serial:]:          # pipelined on one socket
            sent.append((client.infer_async(**req), time.perf_counter()))
        for rid, ts in sent:
            responses.append(client.result(rid)[output])
            latencies.append(time.perf_counter() - ts)
        t_serve = time.perf_counter() - t_start
        launches = {name: w.launches for name, w in counters.items()}
        serve_peak = torch.cuda.max_memory_allocated()
        telemetry = client.telemetry()
        client.shutdown()
    finally:
        client.close()
        server.stop()
    return {"responses": responses, "latencies": latencies,
            "launches": launches, "provision_s": t_provision,
            "serve_s": t_serve, "telemetry": telemetry,
            "serve_peak": serve_peak, "serve_base": serve_base}


def served_fields(served: dict) -> dict:
    """The fields every slice line prints about its served run."""
    lat = sorted(served["latencies"])
    n = len(lat)
    return {"provision_s": served["provision_s"],
            "latency_p50_s": lat[n // 2], "latency_max_s": lat[-1],
            "latencies_s": served["latencies"], "serve_s": served["serve_s"],
            "requests_per_s": n / served["serve_s"],
            "server_exec": served["telemetry"].get("p50"),
            "launches": served["launches"],
            "launches_per_request": {k: v / n for k, v in
                                     served["launches"].items()},
            "serve_peak_memory_allocated": served["serve_peak"],
            "serve_base_memory_allocated": served["serve_base"]}


def phase_slice(torch, cfg, seed: int, phase: str) -> dict:
    """Phase 4: one served path. Returns each kernel's launches while the
    server answered the requests (the main path's run)."""
    from repro_torch.core.executor import Executor
    from repro_torch.core.rctc import compile_transformer_block
    from repro_torch.core.rtpm import Platform
    from repro_torch.models.transformer import init_params, split_params
    from repro_torch.serving import protocol as proto
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    prog, image = compile_transformer_block(cfg, params, 1, SEQ)
    prog_bytes = prog.encode()
    t_compile = time.perf_counter() - t0 - t_init
    glob = split_params(params)[0]       # layer weights go with params
    del params
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 2)
    requests = [request_inputs(torch, cfg, glob, gen)
                for _ in range(N_REQUESTS)]
    del glob                             # requests hold host tensors only
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    compile_peak = torch.cuda.max_memory_allocated()
    # from here until the last reply nothing else of this process holds
    # device memory beyond ``serve_base``: the peak is the server's own
    served = serve(torch, image, prog_bytes, requests, "logits",
                   artifacts=prog.artifacts)
    launches = served["launches"]
    per_layer = {"flash_attention": int(cfg.family != "ssm"),
                 "ssm_scan": int(cfg.family == "hybrid"),
                 "wkv6": int(cfg.family == "ssm"), "int8_matmul": 0}
    for name, n in launches.items():
        want = per_layer[name] * cfg.num_layers * N_REQUESTS
        if n != want:
            raise AssertionError(f"{name} launched {n} times for "
                                 f"{N_REQUESTS} requests of {cfg.num_layers} "
                                 f"{cfg.family} layers, not {want}")

    # the same bytes, run locally: linked and interpreted, bit for bit
    t2 = time.perf_counter()
    plat = Platform()
    plat.provision(image=image, program_bytes=prog_bytes)
    t_fsck = time.perf_counter() - t2
    t3 = time.perf_counter()
    bound = plat.bind(artifacts=prog.artifacts)
    torch.cuda.synchronize()
    t_bind = time.perf_counter() - t3
    resident = plat.rimfs.resident(plat.driver)
    t4 = time.perf_counter()
    if not resident.revalidate():        # d2h + CRC of every pinned file
        raise AssertionError("resident weights fail their RIMFS CRCs")
    t_crc = time.perf_counter() - t4
    ex = Executor(driver=plat.driver)
    for i, (req, got) in enumerate(zip(requests, served["responses"])):
        want = ex.run(bound, inputs=req)["logits"].cpu()
        interp = ex.run_interpreted(bound, inputs=req)["logits"].cpu()
        if tuple(got.shape) != (1, SEQ, cfg.vocab_size) \
                or got.dtype != torch.bfloat16:
            raise AssertionError(f"request {i}: logits {tuple(got.shape)} "
                                 f"{got.dtype}")
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"request {i}: non-finite logits")
        for label, ref in (("linked", want), ("interpreted", interp)):
            if not same_bits(got, ref):
                raise AssertionError(f"request {i}: served logits differ "
                                     f"from the local {label} run")
    t7 = time.perf_counter()             # one linked run, unprofiled
    ex.run(bound, inputs=requests[0])
    torch.cuda.synchronize()
    t_local = time.perf_counter() - t7
    breakdown = device_breakdown(
        torch, lambda: ex.run(bound, inputs=requests[0]))
    t5 = time.perf_counter()
    payload = proto.pack_tensors({"logits": served["responses"][0]})
    t_pack = time.perf_counter() - t5
    t6 = time.perf_counter()
    proto.unpack_tensors(payload)
    t_unpack = time.perf_counter() - t6
    emit(phase, model=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
         seq=SEQ, requests=N_REQUESTS, image_bytes=len(image),
         program_bytes=len(prog_bytes), init_s=t_init, compile_s=t_compile,
         local_fsck_s=t_fsck,
         local_bind_upload_crc_s=t_bind, resident_crc_verify_s=t_crc,
         tokens_per_s=N_REQUESTS * SEQ / served["serve_s"],
         **served_fields(served),
         compile_peak_memory_allocated=compile_peak,
         peak_memory_allocated_with_local_image=max(
             compile_peak, torch.cuda.max_memory_allocated()),
         bit_identical=True, response_bytes=len(payload),
         wire_pack_s=t_pack, wire_unpack_s=t_unpack,
         local_run_s=t_local, local_run=breakdown)
    return launches


def same_bits(a, b) -> bool:
    """Bit-identical tensors (or numpy arrays) of one dtype and shape."""
    import torch
    a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = a.view(ints[a.element_size()]), b.view(ints[b.element_size()])
    return torch.equal(a, b)


def local_platform(torch, image: bytes, prog_bytes: bytes, device="cuda"):
    """The same bytes provisioned and bound locally: (platform, executor,
    bound program, provision seconds, bind seconds)."""
    from repro_torch.core.executor import Executor
    from repro_torch.core.rtpm import Platform
    t0 = time.perf_counter()
    plat = Platform(device=device)
    plat.provision(image=image, program_bytes=prog_bytes)
    t1 = time.perf_counter()
    bound = plat.bind()
    if device == "cuda":
        torch.cuda.synchronize()
    return plat, Executor(driver=plat.driver), bound, t1 - t0, \
        time.perf_counter() - t1


def check_served(ex, bound, requests, responses, output: str) -> list:
    """Every served response against a local linked and an interpreted run
    of the same bytes, bit for bit; returns the local linked outputs."""
    linked = []
    for i, (req, got) in enumerate(zip(requests, responses)):
        want = ex.run(bound, inputs=req)[output]
        interp = ex.run_interpreted(bound, inputs=req)[output]
        for label, ref in (("linked", want), ("interpreted", interp)):
            if not same_bits(got, ref):
                raise AssertionError(f"request {i}: served {output} differs "
                                     f"from the local {label} run")
        linked.append(want)
    return linked


def check_launches(path: str, launches: dict, want: dict) -> None:
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{path}: {name} launched {n} times for "
                                 f"{N_REQUESTS} requests, not "
                                 f"{want.get(name, 0)}")


def matmul_int8_program(m: int, k: int, n: int, out: str):
    """The one-op program tests/test_conformance.py:632-645 builds, with
    its output dtype: x, w and scale are all inputs of a request."""
    from repro_torch.core.rcb import RCB, Op, RCBOp, RCBProgram, TensorDesc
    t = {"x": TensorDesc("x", (m, k), "int8", "input"),
         "w": TensorDesc("w", (k, n), "int8", "input"),
         "scale": TensorDesc("scale", (n,), "float32", "input"),
         "out": TensorDesc("out", (m, n), out, "output")}
    ops = (RCBOp(Op.MATMUL_INT8, ("out",), ("x", "w", "scale"),
                 {"out_dtype": out}), RCBOp(Op.FENCE))
    prog = RCBProgram("k_matmul_int8", t, [RCB(0, "layer", (), ops)])
    prog.validate()
    return prog


def phase_slice_matmul_int8(torch, seed: int, out: str) -> dict:
    """Phase 5a: a one-op MATMUL_INT8 program served 4 times; each
    response equals a local linked run, an interpreted run and the plain
    version, bit for bit, and the kernel launches once a request."""
    from repro_torch.core import rimfs
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref
    m, k, n = MATMUL_INT8_SHAPE
    prog_bytes = matmul_int8_program(m, k, n, out).encode()
    image = rimfs.pack({})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 6)

    def request():
        x = torch.randint(-127, 128, (m, k), generator=gen, device="cuda")
        w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda")
        s = torch.rand(n, generator=gen, device="cuda")
        return {"x": x.to(torch.int8).cpu().numpy(),
                "w": w.to(torch.int8).cpu().numpy(), "scale": s.cpu().numpy()}
    requests = [request() for _ in range(N_REQUESTS)]
    served = serve(torch, image, prog_bytes, requests, "out")
    check_launches(f"slice_matmul_int8 {out}", served["launches"],
                   {"int8_matmul": N_REQUESTS})
    _, ex, bound, t_fsck, t_bind = local_platform(torch, image, prog_bytes)
    check_served(ex, bound, requests, served["responses"], "out")
    for i, (req, got) in enumerate(zip(requests, served["responses"])):
        x, w, s = (torch.from_numpy(req[a]).cuda() for a in ("x", "w",
                                                             "scale"))
        if not same_bits(got, int8_matmul_ref(x, w, s, getattr(torch, out))):
            raise AssertionError(f"slice_matmul_int8 {out} request {i}: "
                                 f"served out differs from the plain version")
    t0 = time.perf_counter()              # one linked run, unprofiled
    ex.run(bound, inputs=requests[0])
    torch.cuda.synchronize()
    t_local = time.perf_counter() - t0
    emit("slice_matmul_int8", out_dtype=out, mkn=[m, k, n],
         requests=N_REQUESTS, program_bytes=len(prog_bytes),
         local_fsck_s=t_fsck, local_bind_s=t_bind, **served_fields(served),
         bit_identical=True, equals_plain_version=True, local_run_s=t_local,
         local_run=device_breakdown(
             torch, lambda: ex.run(bound, inputs=requests[0])))
    return served["launches"]


RESNET_TENSOR_BYTES = {False: 46_758_048, True: 13_295_712}   # from the specs


def with_logits_output(prog):
    """The same program with the DENSE result (the logits the SOFTMAX
    reads) an output too: at full width, random weights make logits so
    large that the softmax rows are exactly one-hot, so the checks read
    the logits as well. Returns the program and the logits' symbol."""
    from repro_torch.core.rcb import Op, RCBProgram
    name = next(op for op in prog.ops() if op.op == Op.DENSE).dsts[0]
    tensors = dict(prog.tensors)
    tensors[name] = dataclasses.replace(tensors[name], kind="output")
    return RCBProgram(prog.name + "_logits", tensors, prog.blocks), name


def relative_err(a, b) -> float:
    """max |a - b| over max |b|."""
    return ((a - b).abs().max() / b.abs().max()).item()


def phase_slice_resnet(torch, seed: int, int8: bool) -> dict:
    """Phase 5b/5c: ResNet-18 at full width, fp32 or INT8 (calibrated on
    the card on a seeded batch of 4 images), compiled, provisioned and
    served; INT8 launches int8_matmul once per CONV2D_I8, 20 a request."""
    from repro_torch.configs.resnet18 import CONFIG
    from repro_torch.core import quant, rimfs
    from repro_torch.core.rctc import compile_resnet18
    from repro_torch.models.resnet import fold_bn, init_resnet, resnet_forward
    phase = "slice_resnet18_int8" if int8 else "slice_resnet18"
    size = CONFIG.image_size
    t0 = time.perf_counter()
    params = init_resnet(CONFIG, seed)
    folded = fold_bn(params)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 7)
    images = torch.rand((N_REQUESTS, size, size, 3), generator=gen,
                        device="cuda")
    requests = [{"input": images[i:i + 1].cpu().numpy()}
                for i in range(N_REQUESTS)]
    pack, t_calib = None, 0.0
    if int8:
        calib_x = torch.rand((4, size, size, 3), generator=gen, device="cuda")
        t1 = time.perf_counter()
        pack = quant.quantize_resnet(CONFIG, folded, calib_x)
        t_calib = time.perf_counter() - t1
    t2 = time.perf_counter()
    prog, image = compile_resnet18(CONFIG, folded, batch=1, int8=pack)
    prog_bytes = prog.encode()
    t_compile = time.perf_counter() - t2
    fs = rimfs.mount(image)
    tensor_bytes = sum(fs.stat(f)["nbytes"] for f in fs.files())
    if tensor_bytes != RESNET_TENSOR_BYTES[int8]:
        raise AssertionError(f"{phase}: image holds {tensor_bytes} bytes of "
                             f"tensors, not {RESNET_TENSOR_BYTES[int8]}")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    served = serve(torch, image, prog_bytes, requests, "output")
    n_conv = sum(resnet_conv_gemms(CONFIG).values())
    check_launches(phase, served["launches"],
                   {"int8_matmul": n_conv * N_REQUESTS if int8 else 0})
    plat, ex, bound, t_fsck, t_bind = local_platform(torch, image,
                                                     prog_bytes)
    linked = check_served(ex, bound, requests, served["responses"], "output")
    got = torch.cat([torch.as_tensor(r) for r in served["responses"]])
    if tuple(got.shape) != (N_REQUESTS, CONFIG.num_classes) \
            or not torch.isfinite(got).all():
        raise AssertionError(f"{phase}: outputs {tuple(got.shape)}, "
                             f"finite {bool(torch.isfinite(got).all())}")
    # the logits of the same program, linked and interpreted on the card
    from repro_torch.core import rbl
    prog_l, lname = with_logits_output(prog)
    bound_l = rbl.bind(prog_l, rimfs=plat.rimfs, driver=ex.driver)
    logits = torch.cat([ex.run(bound_l, inputs=r)[lname] for r in requests])
    interp = torch.cat([ex.run_interpreted(bound_l, inputs=r)[lname]
                        for r in requests])
    if not same_bits(logits, interp):
        raise AssertionError(f"{phase}: linked and interpreted logits differ")
    fields = {"max_abs_logit": logits.abs().max().item()}
    if int8:
        # the same bytes on the CPU, through the plain versions
        cpu_plat, cpu_ex, cpu_bound, _, _ = local_platform(
            torch, image, prog_bytes, device="cpu")
        cpu = torch.cat([cpu_ex.run(cpu_bound, inputs=r)["output"]
                         for r in requests])
        cpu_bound_l = rbl.bind(prog_l, rimfs=cpu_plat.rimfs,
                               driver=cpu_ex.driver)
        cpu_logits = torch.cat([cpu_ex.run(cpu_bound_l, inputs=r)[lname]
                                for r in requests])
        err = (got - cpu).abs().max().item()
        rel = relative_err(logits.cpu(), cpu_logits)
        if not (torch.allclose(got, cpu, atol=RESNET_ATOL, rtol=RESNET_RTOL)
                and rel <= RESNET_RTOL
                and torch.equal(logits.argmax(-1).cpu(),
                                cpu_logits.argmax(-1))):
            raise AssertionError(f"{phase}: card vs CPU max |err| {err}, "
                                 f"logits relative err {rel}, or argmax "
                                 f"differ")
        # INT8 against the fp32 plain forward, as test_resnet_rcb.py holds
        # it, over 32 seeded images
        many = torch.rand((32, size, size, 3), generator=gen, device="cuda")
        l_fp = resnet_forward(CONFIG, params, many, softmax=False)
        l_q = torch.cat([ex.run(bound_l, inputs={"input": many[i:i + 1]})
                         [lname] for i in range(32)])
        p_fp, p_q = torch.softmax(l_fp, -1), torch.softmax(l_q, -1)
        agree = quant.top1_agreement(l_fp, l_q)
        drift = (p_fp - p_q).abs().mean().item()
        if not (agree >= INT8_AGREEMENT and drift < INT8_DRIFT):
            raise AssertionError(f"{phase}: against fp32, top-1 agreement "
                                 f"{agree} (needs {INT8_AGREEMENT}), mean "
                                 f"drift {drift} (needs < {INT8_DRIFT})")
        fields.update({
            "vs_cpu_max_abs_err": err, "vs_cpu_logits_relative_err": rel,
            "calibrate_s": t_calib,
            "int8_vs_fp32": {
                "images": 32, "top1_agreement": agree,
                "agreement_threshold": INT8_AGREEMENT, "mean_drift": drift,
                "drift_threshold": INT8_DRIFT,
                "logits_mean_relative_drift": (
                    (l_fp - l_q).abs().mean() / l_fp.abs().mean()).item()}})
    else:
        # one image a call, as the program runs it (B=1 convolutions)
        ref = torch.cat([resnet_forward(CONFIG, params, images[i:i + 1])
                         for i in range(N_REQUESTS)])
        ref_logits = torch.cat([resnet_forward(
            CONFIG, params, images[i:i + 1], softmax=False)
            for i in range(N_REQUESTS)])
        err = (torch.cat(linked) - ref).abs().max().item()
        rel = relative_err(logits, ref_logits)
        if not (torch.allclose(torch.cat(linked), ref, atol=RESNET_ATOL,
                               rtol=RESNET_RTOL) and rel <= RESNET_RTOL):
            raise AssertionError(f"{phase}: program vs resnet_forward max "
                                 f"|err| {err}, logits relative err {rel}")
        fields.update({"vs_plain_forward_max_abs_err": err,
                       "vs_plain_forward_logits_relative_err": rel})
    del params, folded
    t3 = time.perf_counter()              # one linked run, unprofiled
    ex.run(bound, inputs=requests[0])
    torch.cuda.synchronize()
    t_local = time.perf_counter() - t3
    emit(phase, model=CONFIG.name, image_size=size, batch=1,
         requests=N_REQUESTS, image_bytes=len(image),
         image_tensor_bytes=tensor_bytes, program_bytes=len(prog_bytes),
         ops=sum(1 for _ in prog.ops()), setup_s=t2 - t0,
         compile_s=t_compile, local_fsck_s=t_fsck, local_bind_s=t_bind,
         images_per_s=N_REQUESTS / served["serve_s"],
         **served_fields(served), bit_identical=True, **fields,
         local_run_s=t_local, local_run=device_breakdown(
             torch, lambda: ex.run(bound, inputs=requests[0])))
    return served["launches"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    # 1. device and build
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    info = build.build()
    emit("device_and_build", device=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         build_s=info["seconds"], built=info["built"],
         ptxas=[ln.strip() for ln in info["ptxas"].splitlines()
                if "registers" in ln or "Compiling" in ln
                or "spill" in ln])

    # 2. kernels against their plain versions
    rows = [phase_attention(torch, args.seed),
            phase_ssm_scan(torch, args.seed),
            phase_wkv6(torch, args.seed),
            phase_int8_matmul(torch, args.seed)]

    # 3. two-layer full-width fp32 programs
    models = {"slice": get_config("qwen2-1.5b"),
              "slice_hybrid": get_config("hymba-1.5b"),
              "slice_ssm": get_config("rwkv6-1.6b")}
    for cfg in models.values():
        phase_two_layer_fp32(torch, cfg, args.seed)

    # 4. the served paths, at full depth; each kernel's launches on each
    by_path = {cfg.name: phase_slice(torch, cfg, args.seed, phase)
               for phase, cfg in models.items()}

    # 5. the served vision and INT8 paths
    for out in ("float32", "bfloat16"):
        by_path[f"matmul_int8-{out}"] = phase_slice_matmul_int8(
            torch, args.seed, out)
    by_path["resnet18"] = phase_slice_resnet(torch, args.seed, int8=False)
    by_path["resnet18-int8"] = phase_slice_resnet(torch, args.seed, int8=True)

    # 6. the kernels line, then the card, then the contract line
    for row in rows:
        row["launches_by_path"] = {model: n[row["name"]]
                                   for model, n in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        row["kernel_ms"] = row["ms"]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
