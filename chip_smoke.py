#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line with its times:

  1. device and build: the card, ``nvidia-smi``'s name and power limit, and
     the nvcc build of every kernel from this checkout's sources;
  2. every kernel against its plain PyTorch version on the card, at the
     main path's shapes and at the other shapes it takes, with the kernel's,
     the plain version's and the PyTorch library call's times;
  3. a two-layer full-width fp32 qwen2-1.5B program: the linked run with
     the kernel against the same program with the plain attention;
  4. the slice: qwen2-1.5B at full width and depth (bf16, 28 layers, random
     weights from ``--seed``) compiled to RCB bytes and a RIMFS image,
     provisioned over protocol v2 into the port's InferenceServer, answering
     4 requests of B=1, S=512 (two of them pipelined on one connection),
     with the server's peak device memory; each response checked bit for
     bit against a local linked run and an interpreted run; then where a
     request's time goes: one local linked run by the host clock and under
     ``torch.profiler`` (device busy time, the top kernels), and the wire's
     packing and unpacking of one response;
  5. one ``kernels`` line: per kernel its launches on the main path, its
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


def device_breakdown(torch, fn, top: int = 8) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its host time, the device
    time summed over its kernels (the busy share is their ratio), and the
    kernels that took the most device time, by name."""
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
    busy_us = sum(us for _, us in by_name.values())
    if not busy_us:
        return {"wall_s": wall_us / 1e6, "device": "not measured"}
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"wall_s": wall_us / 1e6, "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / wall_us,
            "kernels": [{"name": name[:90], "launches": n, "s": us / 1e6}
                        for name, (n, us) in ranked]}


def phase_kernels(torch, seed: int) -> dict:
    """Phase 2: flash_attention against its plain version on the card."""
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

    # times at the main path's shape: bf16 (1, 512, 12/2, 128), causal
    b, s, sk, h, hkv, d = 1, 512, 512, 12, 2, 128
    q, k, v = inputs(b, s, sk, h, hkv, d, "bfloat16")
    kernel_ms = cuda_ms(torch, lambda: flash_attention(q, k, v))
    plain_ms = cuda_ms(torch, lambda: attention_ref_bshd(q, k, v))

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)
    library_ms = cuda_ms(torch, library)
    lib_err = (library().transpose(1, 2).float()
               - attention_ref_bshd(q, k, v).float()).abs().max().item()
    bound_ms, bound_by = attention_bound(b, s, sk, h, hkv, d, "bfloat16",
                                         True)
    emit("kernels_vs_plain", cases=results, kernel_ms=kernel_ms,
         plain_ms=plain_ms, library_ms=library_ms,
         library_max_abs_err=lib_err, bound_ms=bound_ms, bound_by=bound_by,
         timed_shape=[b, s, sk, h, hkv, d], timed_dtype="bfloat16")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:69",
            "max_abs_err": worst, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def with_plain_attention(prog):
    """The same program with ``impl="ref"`` on every ATTENTION op."""
    from repro_torch.core.rcb import RCB, Op, RCBOp, RCBProgram
    blocks = [RCB(blk.block_id, blk.block_type, blk.deps, tuple(
        RCBOp(op.op, op.dsts, op.srcs, {**op.attrs, "impl": "ref"})
        if op.op is Op.ATTENTION else op for op in blk.ops))
        for blk in prog.blocks]
    return RCBProgram(prog.name + "_plain_attention", prog.tensors, blocks)


def request_inputs(torch, cfg, glob, gen):
    import numpy as np
    from repro_torch.models.transformer import embed_inputs
    tokens = torch.randint(0, cfg.vocab_size, (1, SEQ), generator=gen,
                           device=gen.device)
    hidden = embed_inputs(cfg, glob, tokens).cpu()
    positions = np.arange(SEQ, dtype=np.int32)[None].copy()
    return {"hidden": hidden, "positions": positions}


def phase_two_layer_fp32(torch, cfg, seed: int) -> None:
    """Phase 3: full-width fp32 program, kernel vs plain attention."""
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
    out = ex.run(plat.bind(), inputs=ins)["logits"]
    plain = ex.run(rbl.bind(with_plain_attention(prog), rimfs=plat.rimfs,
                            driver=plat.driver), inputs=ins)["logits"]
    torch.cuda.synchronize()
    err = (out - plain).abs().max().item()
    if not (torch.isfinite(out).all() and err <= PROGRAM_ATOL):
        raise AssertionError(f"two-layer fp32 program: kernel vs plain "
                             f"attention max |err| {err} > {PROGRAM_ATOL}")
    emit("two_layer_fp32", layers=2, seq=SEQ, image_bytes=len(image),
         setup_s=t1 - t0, run_s=time.perf_counter() - t1,
         logits_max_abs_err=err, atol=PROGRAM_ATOL)


def phase_slice(torch, cfg, seed: int) -> int:
    """Phase 4: the served slice. Returns flash_attention's launches while
    the server answered the requests (the main path's run)."""
    from repro_torch.core.executor import Executor
    from repro_torch.core.rctc import compile_transformer_block
    from repro_torch.core.rtpm import Platform
    from repro_torch.kernels.flash_attention.ops import flash_attention
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

    flash_attention.launches = 0         # the main path starts here
    server = InferenceServer(max_frame=big)
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
        launches = flash_attention.launches
        serve_peak = torch.cuda.max_memory_allocated()
        telemetry = client.telemetry()
        client.shutdown()
    finally:
        client.close()
        server.stop()
    per_request = launches / N_REQUESTS
    if launches != cfg.num_layers * N_REQUESTS:
        raise AssertionError(f"flash_attention launched {launches} times "
                             f"for {N_REQUESTS} requests of "
                             f"{cfg.num_layers} layers")

    # the same bytes, run locally: linked and interpreted, bit for bit
    t2 = time.perf_counter()
    plat = Platform()
    plat.provision(image=image, program_bytes=prog_bytes)
    t_fsck = time.perf_counter() - t2
    t3 = time.perf_counter()
    bound = plat.bind()
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
    emit("slice", model=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
         seq=SEQ, requests=N_REQUESTS, image_bytes=len(image),
         program_bytes=len(prog_bytes), init_s=t_init, compile_s=t_compile,
         provision_s=t_provision, local_fsck_s=t_fsck,
         local_bind_upload_crc_s=t_bind, resident_crc_verify_s=t_crc,
         latency_p50_s=lat[len(lat) // 2], latency_max_s=lat[-1],
         latencies_s=latencies, serve_s=t_serve,
         tokens_per_s=N_REQUESTS * SEQ / t_serve,
         server_exec=telemetry.get("p50"),
         launches=launches, launches_per_request=per_request,
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
    fa = phase_kernels(torch, args.seed)

    # 3. two-layer full-width fp32 program
    cfg = get_config("qwen2-1.5b")
    phase_two_layer_fp32(torch, cfg, args.seed)

    # 4. the slice, served at full depth
    fa["launches"] = phase_slice(torch, cfg, args.seed)

    # 5. the kernels line, then the card, then the contract line
    print(json.dumps({"kernels": [fa]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
