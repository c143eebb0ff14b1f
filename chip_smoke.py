#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line with its times:

  1. device and build: the card, ``nvidia-smi``'s name and power limit, and
     the nvcc build of every kernel from this checkout's sources;
  2. every kernel against its plain PyTorch version on the card, at the
     served paths' shapes and at the other shapes it takes, with the
     kernel's, the plain version's and the PyTorch library call's times
     (``flash_attention``, ``ssm_scan``, then ``wkv6``);
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
  5. one ``kernels`` line: per kernel its launches on the served paths, its
     error against its plain version, its time, its bound and the library's.

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
                  "float32": 67e12}                        # no TF32: CUDA cores
TOLERANCE = {"float32": 2e-6, "bfloat16": 2e-2}            # test_kernels.py:35
SSM_TOLERANCE = {"float32": 2e-5, "bfloat16": 2e-2}        # test_kernels.py:88
WKV_TOLERANCE = {"float32": 5e-4,                          # test_kernels.py:60
                 "bfloat16": 3e-2}     # of max |y|: test_conformance.py:572
PROGRAM_ATOL = 5e-4                                        # test_conformance.py:700
SEQ = 512                  # tokens per request (B=1)
N_REQUESTS = 4             # the last two pipelined on one connection


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
    """One call of ``fn`` under ``torch.profiler``: its host time, the device
    time summed over its kernels (the busy share is their ratio), the
    kernels that took the most device time, by name, and the host-side
    events (torch ops, CUDA runtime calls) that took the most host time of
    their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
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
        return {"wall_s": wall_us / 1e6, "device": "not measured",
                "host_top": host_top}
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"wall_s": wall_us / 1e6, "device_busy_s": busy_us / 1e6,
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

    def inputs(b, s, sk, h, hkv, d, dtype):
        dt = getattr(torch, dtype)
        return [torch.randn(shape, generator=gen, device="cuda").to(dt)
                for shape in ((b, s, h, d), (b, sk, hkv, d), (b, sk, hkv, d))]

    cases = []                     # (b, s, sk, h, hkv, d, dtype, causal)
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
        b, s, sk, h, hkv, d, dtype, causal = case
        q, k, v = inputs(b, s, sk, h, hkv, d, dtype)
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
                        "causal": causal, "max_abs_err": err})

    # times at each served path's shape: bf16, causal, Sk = S
    timed = {}
    for model, (b, s, h, hkv, d) in ATTENTION_SHAPES.items():
        q, k, v = inputs(b, s, s, h, hkv, d, "bfloat16")

        def library():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True)
        bound_ms, bound_by = attention_bound(b, s, s, h, hkv, d, "bfloat16",
                                             True)
        timed[model] = {
            "shape": [b, s, s, h, hkv, d], "dtype": "bfloat16",
            "ms": cuda_ms(torch, lambda: flash_attention(q, k, v)),
            "plain_ms": cuda_ms(torch, lambda: attention_ref_bshd(q, k, v)),
            "library_ms": cuda_ms(torch, library),
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
            "max_abs_err": worst, "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"],
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
    """Every kernel wrapper of the port, by the name of its row."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    from repro_torch.kernels.wkv6.ops import wkv6
    return {"flash_attention": flash_attention, "ssm_scan": ssm_scan,
            "wkv6": wkv6}


def phase_slice(torch, cfg, seed: int, phase: str) -> dict:
    """Phase 4: one served path. Returns each kernel's launches while the
    server answered the requests (the main path's run)."""
    from repro_torch.core.executor import Executor
    from repro_torch.core.rctc import compile_transformer_block
    from repro_torch.core.rtpm import Platform
    from repro_torch.models.transformer import init_params, split_params
    from repro_torch.serving import protocol as proto
    from repro_torch.serving.server import Client, InferenceServer
    big = (1 << 32) - 1                  # PROVISION and logits frames
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
    # the server's peak: from here until the last reply, nothing else of
    # this process holds device memory beyond ``serve_base``
    torch.cuda.reset_peak_memory_stats()
    serve_base = torch.cuda.memory_allocated()

    counters = kernel_counters()
    for wrapper in counters.values():    # the main path starts here
        wrapper.launches = 0
    server = InferenceServer(max_frame=big, artifacts=prog.artifacts)
    server.start()
    client = Client(server.address, max_frame=big)
    try:
        t1 = time.perf_counter()
        client.provision(image, prog_bytes)
        t_provision = time.perf_counter() - t1

        t_start = time.perf_counter()
        responses, latencies = [], []
        n_serial = N_REQUESTS - 2
        for req in requests[:n_serial]:
            ts = time.perf_counter()
            responses.append(client.infer(**req)["logits"])
            latencies.append(time.perf_counter() - ts)
        sent = []
        for req in requests[n_serial:]:          # pipelined on one socket
            sent.append((client.infer_async(**req), time.perf_counter()))
        for rid, ts in sent:
            responses.append(client.result(rid)["logits"])
            latencies.append(time.perf_counter() - ts)
        t_serve = time.perf_counter() - t_start
        launches = {name: w.launches for name, w in counters.items()}
        serve_peak = torch.cuda.max_memory_allocated()
        telemetry = client.telemetry()
        client.shutdown()
    finally:
        client.close()
        server.stop()
    per_layer = {"flash_attention": int(cfg.family != "ssm"),
                 "ssm_scan": int(cfg.family == "hybrid"),
                 "wkv6": int(cfg.family == "ssm")}
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
    for i, (req, got) in enumerate(zip(requests, responses)):
        want = ex.run(bound, inputs=req)["logits"].cpu()
        interp = ex.run_interpreted(bound, inputs=req)["logits"].cpu()
        if tuple(got.shape) != (1, SEQ, cfg.vocab_size) \
                or got.dtype != torch.bfloat16:
            raise AssertionError(f"request {i}: logits {tuple(got.shape)} "
                                 f"{got.dtype}")
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"request {i}: non-finite logits")
        for label, ref in (("linked", want), ("interpreted", interp)):
            if not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
                raise AssertionError(f"request {i}: served logits differ "
                                     f"from the local {label} run")
    t7 = time.perf_counter()             # one linked run, unprofiled
    ex.run(bound, inputs=requests[0])
    torch.cuda.synchronize()
    t_local = time.perf_counter() - t7
    breakdown = device_breakdown(
        torch, lambda: ex.run(bound, inputs=requests[0]))
    t5 = time.perf_counter()
    payload = proto.pack_tensors({"logits": responses[0]})
    t_pack = time.perf_counter() - t5
    t6 = time.perf_counter()
    proto.unpack_tensors(payload)
    t_unpack = time.perf_counter() - t6
    lat = sorted(latencies)
    emit(phase, model=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
         seq=SEQ, requests=N_REQUESTS, image_bytes=len(image),
         program_bytes=len(prog_bytes), init_s=t_init, compile_s=t_compile,
         provision_s=t_provision, local_fsck_s=t_fsck,
         local_bind_upload_crc_s=t_bind, resident_crc_verify_s=t_crc,
         latency_p50_s=lat[len(lat) // 2], latency_max_s=lat[-1],
         latencies_s=latencies, serve_s=t_serve,
         tokens_per_s=N_REQUESTS * SEQ / t_serve,
         server_exec=telemetry.get("p50"),
         launches=launches,
         launches_per_request={k: n / N_REQUESTS for k, n in launches.items()},
         serve_peak_memory_allocated=serve_peak,
         serve_base_memory_allocated=serve_base,
         compile_peak_memory_allocated=compile_peak,
         peak_memory_allocated_with_local_image=max(
             compile_peak, torch.cuda.max_memory_allocated()),
         bit_identical=True, response_bytes=len(payload),
         wire_pack_s=t_pack, wire_unpack_s=t_unpack,
         local_run_s=t_local, local_run=breakdown)
    return launches


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
                if "registers" in ln or "Compiling" in ln])

    # 2. kernels against their plain versions
    rows = [phase_attention(torch, args.seed),
            phase_ssm_scan(torch, args.seed),
            phase_wkv6(torch, args.seed)]

    # 3. two-layer full-width fp32 programs
    models = {"slice": get_config("qwen2-1.5b"),
              "slice_hybrid": get_config("hymba-1.5b"),
              "slice_ssm": get_config("rwkv6-1.6b")}
    for cfg in models.values():
        phase_two_layer_fp32(torch, cfg, args.seed)

    # 4. the served paths, at full depth; each kernel's launches on each
    by_path = {cfg.name: phase_slice(torch, cfg, args.seed, phase)
               for phase, cfg in models.items()}

    # 5. the kernels line, then the card, then the contract line
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
