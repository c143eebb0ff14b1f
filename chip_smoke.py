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
     beside ``scaled_dot_product_attention``; ``ssm_scan``, its ring
     instance held bit for bit against the row-wise one, with the plan, the
     candidate plans' times, both instances' device times and registers,
     and the CRC-32 of y at the hybrid shape; ``wkv6``, with
     its states and output kernels' device times apart, the scratch and the
     bytes its plan moves beside the bound's, and the in-block build of the
     entering states timed against the carry kernel at T = 512 to 4096;
     then ``int8_matmul``, bit for bit; then ``decode_attention`` at
     mistral-nemo-12b's decode filled as the benchmark's chat and rag mixes
     fill it, full and ragged, through block tables too, and at every
     other config's group, head dim, dtype and window, gated on each
     lane's error over its largest output, with its time and device time
     beside its bytes bound over the valid rows, the plain version's and
     SDPA's, and every split length's time);
  2b. the kernel autotune cache (``autotune``): every tunable kernel swept
     at its served shapes (``int8_matmul`` at 512 x 1536 x 8960 and every
     ResNet-18 INT8 convolution's GEMM, ``ssm_scan`` at hymba's shape,
     ``wkv6`` at rwkv6's in fp32 and bf16; ``flash_attention`` at qwen2's
     and moonshot's, one plan, 0 trials): each candidate plan's ms by CUDA
     events, the winner, the default, the trials, every plan's output
     against the default plan's (bit for bit, ``wkv6`` within its
     tolerance); the table packed into an image and reloaded by a fresh
     ``Platform`` (``autotune_loaded``, a second sweep of 0 trials); then
     ResNet-18 INT8 served with the table in its image, bit for bit against
     the default plans, its linked run's host wall with the table empty
     and loaded; then the table is reset;
  3. a two-layer full-width fp32 program of each served model (qwen2-1.5B,
     hymba-1.5B, then rwkv6-1.6B, then moonshot-v1-16b-a3b, the last as
     ``moe_two_layer_fp32`` with each layer's worst gap between a token's
     6th and 7th router probabilities): the linked run with the kernels
     against the same program with ``impl="ref"`` on every kernel op;
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
  6. with each served path, its compiled dispatch path: a ``batched``
     line (a burst of requests held behind the server's dispatcher, sent
     twice, coalesced into one ``run_batched`` dispatch on a captured
     batch bucket, or served one by one where the batch analysis refuses
     the program, as for hymba's and rwkv6's GRAPH_EXEC glue; every reply
     against its solo reply) and a ``fused`` line (``Executor.fuse``
     captured as a CUDA graph and replayed, bit for bit against
     ``Executor.run``, with the capture's seconds, one replay's launches,
     the host wall of a replay beside a linked run's and the replay's
     device time);
  6b. the tile groups, on the ``slice`` and ``slice_resnet18_int8``
     phases' programs, images and requests: ``slice_partitioned``
     (qwen2-1.5B, 28 bf16 layers, over ``TileMesh(n)`` for n = 1, 2 and
     4, each group an eager driver with its own CUDA stream and arena:
     each request bit for bit against ``Executor.run``, 28
     ``flash_attention`` launches a request and each group's as many as
     its tile's layers, ``moved_bytes() == cut_bytes()``, the groups'
     pinned bytes summing to one driver's; the cut table, ``pin_s``, each
     request's host wall, each group's stage time by CUDA events on its
     stream, the edges' CRC stamp and check, the wall with the groups'
     CRC on and off beside one driver's linked run, and one request's
     streams under ``torch.profiler``), ``slice_partitioned_resnet18_int8``
     (the same at 224 px, 20 ``int8_matmul`` launches a request; then
     ``execute_stream`` over 32 images at depth 4, fused and linked, CRC
     on and off, in order and bit for bit against serial runs: images/s,
     each group's busy seconds, each stream's device time and the share
     of device time with two or more streams running),
     ``partitioned_failover`` (the GEMM chain, 8 fp32 layers of 1024 x
     1024, and ResNet-18 INT8 over 2 and 3 groups: group 1 killed between
     stages, its stage re-queued bit-identical with the counters moved,
     its arena refusing ``alloc``, ``revive`` lifting the quarantine and
     refusing a weight flipped on the card, every group dead raising) and
     ``served_mesh`` (``InferenceServer(mesh=TileMesh(2))`` on ResNet-18
     INT8: replies equal the single-driver server's, a held burst of 3
     not coalesced, a group hung on a DMA redemption killed by the
     watchdog and the answer still bit-identical);
  6c. the fleet and overload control plane (``slice_fleet``): ResNet-18
     INT8 served over ``TileMesh(2)`` under a ``FleetController`` and a
     ``BrownoutController`` while 3 paced clients send 96 requests from a
     pool of 8 images, every reply bit for bit against a local run: the
     mesh scaled 2 -> 4 -> 8 -> 2 (the return to the cached mesh uploading
     nothing), one group killed and replaced in place (the survivors'
     counters still), two killed and healed, a journaled install through a
     fault at each mid-write point on disk, 3 corrupted DMA payloads
     retried, a good hot swap finalized and a bad one rolled back by its
     probe, a good canary promoted and a bad one aborted with none of its
     bytes served, a straggler replaced, a hung redemption preempted; then
     the brown-out ladder walked 0 -> 4 -> 0 by held backlogs (a typed
     ``brownout`` shed at rung 3; the circuit breaker's trip, half-open
     probe and CRC-checked revive at rung 4); memory back after every
     release; and qwen2-1.5B's 3.09 GB image swapped once over
     ``TileMesh(2)`` and finalized, memory and each step's seconds printed;
  6d. the executor's per-op traces (``op_traces``): the paper's Table 4
     program (``compile_matmul(64, with_dma=True)``, 300 traced runs, the
     DMA_H2D, GEMM and DMA_D2H means after the first 10%) and ResNet-18
     INT8 at 224 px (20 traced runs, the time by opcode, 20
     ``int8_matmul`` launches a run), every traced output bit for bit
     against the untraced run;
  6e. the serving entry point (``repro_torch.launch.serve``) at full
     width: ``serve_resnet18`` (fp32 ResNet-18 at 224 px, batch 4, 4
     clients pipelining 4 requests each, 64 requests; with coalescing off
     every reply equal to a local ``Executor.run`` bit for bit, with the
     reference's window of 8 within 1e-5; images/s, the clients' and the
     server's p50, p99 and CV), ``serve_lm`` (qwen2-1.5B at 28 bf16
     layers, 8 prompts of 16 tokens, 8 new: 28 ``flash_attention`` a
     prefill, the tokens equal an eager-step engine's) and
     ``serve_fleet`` (the GEMM chain scaled 2 -> 8 -> 2 groups, swapped,
     a group killed and healed: 0 mismatches, the scale back on the
     cached mesh);
  7. the LM serving engine: first at qwen2-1.5B's full width cut to 2
     layers in bf16 and 1 layer in fp32 (two ``engine_reduced_depth``
     lines: each prefill's last-position logits on the kernels
     against the plain versions, each greedy stream against an offline
     recompute, gated on the fp32 layer), then at full depth
     (``slice_engine``):
     packed into a RIMFS image, pinned by ``ServingEngine.from_rimfs`` (4
     slots of 640 rows, the decode step captured as one CUDA graph) and
     served by the InferenceServer: six greedy prompts of 512, 512, 256,
     256, 100 and 37 tokens with 32 new tokens each, held until all are
     queued, each prompt prefilled alone; the tokens against a local engine
     on the eager decode step fed the same prefills (bit for bit), one
     replay against the eager step (logits and cache bit for bit), the
     same prompts again not held and each admitted alone (the same
     streams), every hand-kernel call of each prefill against its plain
     version on the same operands, 28 ``flash_attention`` launches a
     prefill and one ``decode_attention`` a layer a decode step; the
     capture's seconds, the host wall
     and device time of a replayed and an eager decode step and of each
     prefill shape. Then the recurrent families the same way: hymba-1.5B
     (an ``engine_reduced_depth`` line at 1 fp32 layer with 1280 rows, so
     a ring of W = 1024, and prompts of 1100 tokens, prefilled past the
     window, and 1000, whose decode wraps the ring; then
     ``slice_engine_hybrid``, 32 ``flash_attention`` and 32 ``ssm_scan``
     launches a prefill, the KV ring and the SSM state in the replay's
     check) and rwkv6-1.6B (the same at 1 fp32 layer, then
     ``slice_engine_ssm``, 24 ``wkv6`` launches a prefill, the WKV state
     and token-shift rows in the replay's check). Between qwen2's and
     hymba's, the paged-KV engine: at 1 fp32 layer with a pool of just
     the first four prompts' reservations (the last two land on recycled
     blocks; every token against the offline recompute), and a pool for
     two of four 512-token prompts (two shed ``out_of_blocks``, no launch
     spent on them); then ``slice_engine_paged``: qwen2-1.5B at full depth
     from ``slice_engine``'s pinned image through
     ``PagedServingEngine.from_rimfs`` (4 slots, max_seq 640, blocks of 16
     rows, 160 + 1 blocks), its 12 (bucket, window) rungs captured as CUDA
     graphs when it is built, the six prompts decoded in windows of up to
     8 tokens; the streams against the same engine on eager windows and
     against ``slice_engine``'s dense streams (bit for bit), a rung
     captured anew while four sequences hold blocks (every block but the
     null one untouched), one replay of each rung the burst reached
     against its eager window, 28 ``flash_attention`` launches a prefill
     and none in a window, and the w = 8 window's device time at each
     bucket and through tables of 8 and 16 blocks; ``slice_fleet_lm``, the
     brown-out ladder's LM rungs on that image (at rung 2 a request of 32
     new tokens clamped to 8, equal to the unclamped stream's prefix, at
     rung 3 a priority-2 prompt shed). Then the moe family, moonshot-v1-16b-a3b
     (64 experts, top-6): its 2-layer bf16 program served as the LM
     programs are (``slice_moe``, 2 ``flash_attention`` launches a
     request, fused and batched lines), an ``engine_reduced_depth`` line at
     1 fp32 layer run dropless (every stream against the recompute), and
     ``slice_engine_moe``: all 48 layers with the weights drawn on the
     card (56.1 GB, no image), the six prompts served as ``slice_engine``
     serves them, 48 ``flash_attention`` launches a prefill, the decode
     step's p50 beside its bytes bound; then ``slice_engine_paged_moe``:
     the paged-KV engine over the same 48 layers' tensors, the six prompts
     served (48 ``flash_attention`` a prefill, 48 ``decode_attention`` a
     step of a window), its
     streams equal to the dense engine's bit for bit. Then the card-only tests of the fused and batched graphs
     (``tests/test_torch_graphs_gpu.py``), of the engine's compiled steps
     (``tests/test_torch_engine_gpu.py``, with the per-op diagnosis of a
     grouped prefill) and of the paged windows
     (``tests/test_torch_paged_gpu.py``, with the per-op diagnosis of the
     paged step's shapes against the dense step's), of the tile groups'
     streams (``tests/test_torch_partition_gpu.py``), of the fleet's
     flips and releases (``tests/test_torch_fleet_gpu.py``) and of the
     autotune cache's sweep and reload (``tests/test_torch_autotune_gpu.py``),
     and every kernel's own card tests (``tests/test_torch_kernels_gpu.py``),
     each in a process of its own, and beside them the serving entry
     point's CLI (``serve_cli``: ``python -m repro_torch.launch.serve
     --requests 16 --batch 1 --clients 4 --pipeline 2`` on the card, exit
     code 0);
  7b. training (before the card-only tests): ``train_two_layer_fp32``
     (qwen2-1.5B at full width, 2 fp32 layers: one training step's loss
     and every gradient leaf against the port's CPU path), ``slice_train``
     (``repro_torch.launch.train.main`` at 28 bf16 layers, 30 AdamW steps
     on ``SyntheticLM`` with a 15.44 GB RIMFS checkpoint at step 20; a
     second run restored from it ends bit for bit on the first's
     parameters and moments; no hand kernel launched; step walls,
     tokens/s, peak memory, save and restore seconds, one step's device
     time by part and kernel) and ``serve_trained`` (the step-30
     checkpoint's and the in-memory weights answer the same greedy tokens
     through two ``ServingEngine``s, 28 ``flash_attention`` a prefill),
     and the card-only training test (``tests/test_torch_train_gpu.py``);
  7c. every LM architecture no phase above serves (``slice_arches``; the dry
     run's cells started before the training phases, each ``python -m
     repro_torch.launch.dryrun`` in a process of its own with no card visible:
     qwen2-1.5b x train_4k, prefill_32k and decode_32k over the fake 256-rank
     mesh, moonshot-v1-16b-a3b x train_4k over the 512-rank one, hymba-1.5b x
     long_500k, qwen2-1.5b x train_4k again in ``--mode full``, pixtral-12b x
     prefill_32k, musicgen-medium x decode_32k and rwkv6-1.6b x train_4k):
     qwen3-14b (qk-norm), phi3-medium-14b, mistral-nemo-12b, arctic-480b (128
     experts top-2 beside a dense residual MLP, 2 layers) and the vlm and audio
     backbones pixtral-12b and musicgen-medium on their frontend stubs'
     embeddings, each drawn at full width on the card and freed before the
     next: at 2 fp32 layers (arctic 1) the prefill and the first decode step on
     the kernels against the plain versions (5e-4), and the decode step against
     a full forward over S + 1 (2e-3, in fp64; arctic's in fp32 at a capacity
     that drops nothing); then at the served depth in bf16, the token configs
     through ``ServingEngine`` (the engine cell's six prompts, 4 slots of 640
     rows, the decode step one CUDA graph: the streams equal an eager-step
     engine's bit for bit), pixtral and musicgen through ``make_prefill_step``
     on a (1, 512, d) stub and 32 decode steps, each replay of
     ``CompiledDecodeStep`` equal to the eager step bit for bit; one
     ``flash_attention`` a layer a prefill, every call against its plain
     version; peak memory, a prefill's host wall and device busy, the decode
     step's p50 beside its bytes bound, tokens/s;
  7d. distribution and the dry run (before the card-only tests): on a
     NCCL group of one rank, ``distributed`` (``compressed_psum``'s three
     methods bit for bit against their plain formulas, ``pipeline_forward``
     at one stage against the stacked forward), ``dp_train_step``
     (``make_dp_train_step`` at qwen2-1.5B's full size on ``SyntheticLM``,
     B 16 x S 128, plain SGD: two ``none`` steps bit for bit against the
     same steps without a group, one ``int8_ef`` step's loss and largest
     update difference) and ``sharded_lm_service`` (qwen2-1.5B's LM
     service program on DTensors over a 1 x 1 mesh under the "decode"
     rules: logits and greedy tokens bit for bit against plain tensors,
     28 ``flash_attention`` launches a prefill through its sharding rule);
     then ``roofline_check`` (qwen2-1.5B's prefill at (1, 512): the FLOPs
     counted on the card equal those counted on ``meta``, the device time
     beside the roofline's compute and memory terms) and, last, one
     ``dryrun`` line a cell with its ``roofline.analyze`` row and
     ``dryrun_modes_agree`` (the full trace's totals equal the
     extrapolation's exactly);
  8. one ``kernels`` line: per kernel its launches on every served path
     (and on each one's fused and batched paths), its error against its
     plain version, its time, its bound and the library's.

The last line is ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero; without CUDA the script exits non-zero before any result.
The script imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.launch.roofline import H100_HBM_BW, H100_PEAK_FLOPS  # noqa

HBM_BYTES_PER_S = H100_HBM_BW        # H100 SXM device memory
PEAK_OPS_PER_S = {"bfloat16": H100_PEAK_FLOPS,       # tensor cores
                  "float16": H100_PEAK_FLOPS,
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
# the batched phase's bursts: requests held behind the dispatcher, then
# released into one coalesced dispatch (bucket 4 with 1 pad lane, bucket 8
# with 3, bucket 4 with none), twice: the first captures the bucket's graph
BURST = {"lm": 3, "resnet": 5, "matmul_int8": 4}
BATCH_BF16_TOL = TOLERANCE["bfloat16"]       # of max |logit|, as bf16 is held


T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the script's seconds so far."""
    print(json.dumps({"phase": phase, "at_s": time.perf_counter() - T0,
                      **fields}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def int8_matmul_sass() -> dict:
    """The tensor-core check of the built library: for each instance of the
    int8_matmul kernel (``<warps M, warps N, x in 16-byte rows, w in
    16-byte rows>``), how many ``IMMA`` (integer mma) and ``IDP`` (dp4a)
    instructions its SASS holds, from ``cuobjdump -sass``. Raises unless
    every instance multiplies on the tensor cores only."""
    import re
    from repro_torch.kernels import build
    from repro_torch.kernels.int8_matmul.ops import TILES
    exe = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(exe), "-sass",
                           str(build.BUILD_DIR / build.LIB_NAME)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            args = re.search(
                r"int8_matmul_kernelILi(\d+)ELi(\d+)ELb(\d)ELb(\d)E", fn)
            name = "<%s,%s,%s,%s>" % args.groups() if args else None
            if name:
                counts[name] = {"IMMA": 0, "IDP": 0}
        elif name:
            for op in ("IMMA", "IDP"):
                if re.search(rf"\b{op}\b", line):
                    counts[name][op] += 1
    if len(counts) != 4 * len(TILES) or any(c["IMMA"] == 0 or c["IDP"]
                                            for c in counts.values()):
        raise AssertionError(f"int8_matmul instances not on the tensor "
                             f"cores only: {counts}")
    return counts


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


def device_ms_by_kernel(torch, fn, iters: int = 50, warmup: int = 5):
    """Mean device time of one call of ``fn`` by kernel name: the durations
    ``torch.profiler`` records for each kernel and copy over ``iters``
    calls, summed per name, over ``iters``. A profile that recorded no
    device activity at all (the tracer missed the window) is taken again,
    up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    by_name: dict = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / iters / 1e3)
        if by_name:
            break
    return by_name


def profiled_device_ms(torch, fn, iters: int = 50, warmup: int = 5):
    """Mean device time of one call and the names of what ran: the
    durations of every kernel and copy that ``torch.profiler`` records over
    ``iters`` calls, summed, over ``iters``. Unlike ``cuda_ms`` it leaves
    out the host's time between launches. (None, []) when the profiler
    records no device activity."""
    by_name = device_ms_by_kernel(torch, fn, iters, warmup)
    total = sum(by_name.values())
    return total or None, sorted({name[:120] for name in by_name})


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
    summed over its kernels (the busy share is their ratio), how many
    kernels and copies ran and how many ``cudaLaunchKernel`` calls the host
    made (a graph replay makes none), the kernels that took the most device
    time, by name, and the host-side events (torch ops, CUDA runtime calls)
    that took the most host time of their own."""
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
    averages = prof.key_averages()
    host_launches = sum(a.count for a in averages
                        if a.key.startswith("cudaLaunchKernel"))
    host = sorted(averages, key=lambda a: -a.self_cpu_time_total)
    host_top = [{"name": a.key[:90], "calls": a.count,
                 "self_s": a.self_cpu_time_total / 1e6} for a in host[:top]]
    busy_us = sum(us for _, us in by_name.values())
    n_device = sum(n for n, _ in by_name.values())
    if not busy_us:
        return {"wall_s": wall_us / 1e6, "device_elapsed_s": elapsed_s,
                "device": "no kernel in the profiler's trace",
                "host_top": host_top}
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"wall_s": wall_us / 1e6, "device_elapsed_s": elapsed_s,
            "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / wall_us,
            "device_ops": n_device, "host_kernel_launches": host_launches,
            "kernels": [{"name": name[:90], "launches": n, "s": us / 1e6}
                        for name, (n, us) in ranked],
            "host_top": host_top}


# the served paths: model name -> (B, S, H, Hkv, D) of its attention
ATTENTION_SHAPES = {"qwen2-1.5b": (1, SEQ, 12, 2, 128),
                    "hymba-1.5b": (1, SEQ, 25, 5, 64),
                    "moonshot-v1-16b-a3b": (1, SEQ, 16, 16, 128),
                    # slice_arches' (pixtral-12b's is mistral-nemo's)
                    "qwen3-14b": (1, SEQ, 40, 8, 128),
                    "phi3-medium-14b": (1, SEQ, 40, 10, 128),
                    "mistral-nemo-12b": (1, SEQ, 32, 8, 128),
                    "arctic-480b": (1, SEQ, 56, 8, 128),
                    "musicgen-medium": (1, SEQ, 24, 24, 64)}
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
    served = ((1, 512, 512, 12, 2, 128), (1, 512, 512, 25, 5, 64),
              (1, 512, 512, 16, 16, 128))
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
    # slice_arches' prefill shapes
    cases += [(b, s, s, h, hkv, d, "bfloat16", True)
              for model, (b, s, h, hkv, d) in ATTENTION_SHAPES.items()
              if model in dict(ARCH_MODELS)]
    # the serving engine's prefill shapes (qwen2-1.5B), and B = 2 as a
    # grouped prefill would give them
    cases += [(b, n, n, 12, 2, 128, "bfloat16", True)
              for b, n in ((2, 512), (2, 256), (1, 512), (1, 256), (1, 100),
                           (1, 37))]
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


def ptxas_of(ptxas: str, marker: str) -> list:
    """Registers, spills and stack of each kernel whose mangled name holds
    ``marker``, from the build's ``-Xptxas -v`` report (empty when this run
    found the library built)."""
    import re
    found, cur = [], None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"kernel": m.group(1)} if marker in m.group(1) else None
            if cur:
                found.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                cur.update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    return found


def phase_ssm_scan(torch, seed: int, ptxas: str) -> dict:
    """Phase 2b: ssm_scan against its plain version on the card, and its
    ring instance against the row-wise one bit for bit."""
    import zlib
    from repro_torch.kernels.ssm_scan import ops
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

    def rowwise(da, bx, c):
        b, _, di, n = da.shape
        return ops.run_plan(da, bx, c, ops.rowwise_plan(b, di, n))

    cases = [(*SSM_SHAPE, "float32", None),        # the hybrid slice
             (*SSM_SHAPE, "bfloat16", None),
             (1, 37, 100, 16, "float32", None),    # ragged T, di % 32 != 0
             (1, 37, 100, 16, "bfloat16", None),
             (3, 37, 101, 16, "float32", None),    # B=3, ragged lanes
             (1, 1, 100, 16, "float32", None),     # T=1
             (1, 4096, 100, 16, "float32", None),  # the ring wraps 256 times
             (2, 64, 32, 4, "float32", None),      # N=4 (smoke), B=2
             (2, 64, 32, 4, "bfloat16", None),     # ... the row-wise instance
             (2, 128, 64, 8, "float32", None),
             (1, 64, 96, 32, "float32", None),
             (1, 64, 100, 16, "float32", 0.0),     # identity decay
             (1, 64, 100, 16, "float32", -80.0)]   # extreme decay
    worst = 0.0
    results = []
    for case in cases:
        b, t, di, n, dtype, da_value = case
        da, bx, c = inputs(b, t, di, n, dtype, da_value)
        plan = ops.plan_of(da, bx, c)
        got = ssm_scan(da, bx, c)
        same = torch.equal(got, rowwise(da, bx, c))
        out = got.float()
        ref = ssm_scan_ref(da, bx, c).float()
        torch.cuda.synchronize()
        tol = SSM_TOLERANCE[dtype]
        err = (out - ref).abs().max().item()
        if not (torch.isfinite(out).all()
                and torch.allclose(out, ref, atol=tol, rtol=tol)):
            raise AssertionError(f"ssm_scan {case}: max |err| {err} beyond "
                                 f"atol=rtol={tol}")
        if not same:
            raise AssertionError(f"ssm_scan {case}: the {plan.instance} "
                                 f"instance's bits differ from the row-wise "
                                 f"instance's")
        worst = max(worst, err)
        results.append({"shape": [b, t, di, n], "dtype": dtype,
                        "da": "-exp(normal)" if da_value is None
                        else da_value, "instance": plan.instance,
                        "same_bits_as_rowwise": same, "max_abs_err": err})

    # the timed inputs come from their own generator, so the CRC of y is
    # comparable across commits
    gen.manual_seed(seed + 5)
    da, bx, c = inputs(*SSM_SHAPE, "float32")
    plan = ops.plan_of(da, bx, c)
    y = ssm_scan(da, bx, c)
    same = torch.equal(y, rowwise(da, bx, c))
    if plan.instance != ops.RING or not same:
        raise AssertionError(f"ssm_scan at {SSM_SHAPE}: plan {plan}, same "
                             f"bits as the row-wise instance: {same}")
    crc = zlib.crc32(y.cpu().numpy().tobytes())
    kernel_ms = cuda_ms(torch, lambda: ssm_scan(da, bx, c))
    device_ms = profiled_device_ms(torch, lambda: ssm_scan(da, bx, c))[0]
    rowwise_device_ms = profiled_device_ms(torch,
                                           lambda: rowwise(da, bx, c))[0]
    plain_ms = cuda_ms(torch, lambda: ssm_scan_ref(da, bx, c), iters=5,
                       warmup=1)
    bound_ms, bound_by, nbytes = ssm_scan_bound(*SSM_SHAPE, "float32")
    # the plan's candidates: each width, stages of 16 and 32 steps, depths
    # 2 to 6, by CUDA events around 30 calls of the C entry point
    b, _, di, n = SSM_SHAPE
    candidates = []
    for w in ops.RING_WIDTHS:
        for s in (16, 32):
            for depth in (2, 3, 4, 6):
                cand = ops.ring_plan(b, di, n, 4, w, s, depth)
                ms = cuda_ms(torch, lambda cand=cand: ops.run_plan(
                    da, bx, c, cand), iters=30)
                candidates.append({**cand._asdict(), "ms": ms})
    note = "no single PyTorch call computes a selective scan"
    emit("kernels_vs_plain", kernel="ssm_scan", cases=results,
         plan=plan._asdict(),
         ptxas={"ring": ptxas_of(ptxas, "ssm_scan_ring_kernel"),
                "rowwise": ptxas_of(ptxas, "ssm_scan_rowwise_kernel")},
         kernel_ms=kernel_ms, device_ms=device_ms,
         rowwise_device_ms=rowwise_device_ms,
         bytes_per_s=nbytes / (device_ms / 1e3),
         rowwise_bytes_per_s=nbytes / (rowwise_device_ms / 1e3),
         bound_bytes_per_s=HBM_BYTES_PER_S,
         same_bits_as_rowwise=same, y_crc32=crc,
         candidates=candidates, plain_ms=plain_ms, library_ms=None,
         library_note=note, bound_ms=bound_ms, bound_by=bound_by,
         bound_bytes=nbytes, timed_shape=list(SSM_SHAPE),
         timed_dtype="float32")
    return {"name": "ssm_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan/kernel.py:42",
            "design": "ring of cp.async stages in shared memory",
            "max_abs_err": worst, "ms": kernel_ms, "device_ms": device_ms,
            "rowwise_device_ms": rowwise_device_ms, "plain_ms": plain_ms,
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


def wkv6_plan_bytes(b, t, h, kk, dtype: str, inblock_chunks: int) -> dict:
    """Bytes the chunked scan's kernels move, by kernel (each read and
    write counted once, from L2 or device memory): the states kernel reads
    k, v, lw and writes U_c (K*K fp32) and d_c (K fp32) per chunk and head
    (the scratch); above ``inblock_chunks`` chunks the carry kernel reads
    U_c and d_c and writes S_c in place, else each output block reads the
    U_c and d_c of the chunks before its own; the output kernel reads r, k,
    v, lw, u and its entering state and writes y."""
    esize = 4 if dtype == "float32" else 2
    nc = -(-t // 64)
    stream = b * t * h * kk * esize
    slot = (kk * kk + kk) * 4
    scratch = b * h * nc * slot
    if nc > inblock_chunks:
        carry = b * h * nc * (slot + kk * kk * 4)
        entering = b * h * nc * kk * kk * 4
    else:
        carry = 0
        entering = b * h * nc * (nc - 1) // 2 * slot
    states = 3 * stream + scratch
    output = 5 * stream + h * kk * 4 + entering
    return {"states": states, "carry": carry, "output": output,
            "total": states + carry + output, "scratch": scratch}


def wkv6_entry(torch, args, inblock_chunks: int):
    """A call of the C entry point ``aeg_wkv6`` on ``args`` with the given
    in-block cap (the wrapper passes ``ops.INBLOCK_CHUNKS``), and its
    output, for timing the cap both ways."""
    from repro_torch.kernels import build
    from repro_torch.kernels.common import DTYPE_CODE
    lib = build.library()
    r, k, v, lw, u = args
    b, t, h, kk = r.shape
    y = torch.empty_like(r)
    scratch = torch.empty(lib.aeg_wkv6_scratch_floats(b, t, h, kk),
                          dtype=torch.float32, device=r.device)

    def call():
        build.check(lib, lib.aeg_wkv6(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            u.data_ptr(), y.data_ptr(), scratch.data_ptr(), b, t, h, kk,
            DTYPE_CODE[r.dtype], inblock_chunks,
            torch.cuda.current_stream().cuda_stream), "wkv6")
    return call, y


def phase_wkv6(torch, seed: int) -> dict:
    """Phase 2c: wkv6 against its plain version on the card."""
    from repro_torch.kernels.wkv6.ops import INBLOCK_CHUNKS, wkv6
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
             (1, 200, 4, 64, "float32", -80.0, 0.5),   # ... across chunks
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
    by_name = device_ms_by_kernel(torch, lambda: wkv6(*args))
    device_ms = sum(by_name.values())
    kernel_device_ms = {part: sum(ms for name, ms in by_name.items()
                                  if f"wkv6_{part}_kernel" in name)
                        for part in ("states", "carry", "output")}
    plain_ms = cuda_ms(torch, lambda: wkv6_ref_bthk(*args), iters=5,
                       warmup=1)
    bound_ms, bound_by, nbytes, ops = wkv6_bound(*WKV_SHAPE, "float32")
    plan = wkv6_plan_bytes(*WKV_SHAPE, "float32", INBLOCK_CHUNKS)
    # the in-block cap both ways, through the C entry point: device time
    # of the whole call with every entering state built in the output
    # blocks (cap = 1 << 30) and with the carry kernel (cap = 0); the two
    # give the same bits
    cap_ms = {}
    for t in (512, 704, 768, 1024, 2048, 4096):
        targs = inputs(1, t, WKV_SHAPE[2], WKV_SHAPE[3], "float32")
        ys = {}
        for mode, cap in (("in_block", 1 << 30), ("carry", 0)):
            call, ys[mode] = wkv6_entry(torch, targs, cap)
            cap_ms[f"{t}_{mode}"] = profiled_device_ms(torch, call)[0]
        if not torch.equal(ys["in_block"], ys["carry"]):
            raise AssertionError(f"wkv6 T={t}: the in-block build and the "
                                 f"carry kernel differ")
    note = "no single PyTorch call computes the WKV recurrence"
    emit("kernels_vs_plain", kernel="wkv6", cases=results,
         kernel_ms=kernel_ms, device_ms=device_ms,
         kernel_device_ms=kernel_device_ms, plain_ms=plain_ms,
         library_ms=None,
         library_note=note, bound_ms=bound_ms, bound_by=bound_by,
         bound_bytes=nbytes, bound_operations=ops, plan_bytes=plan,
         scratch_bytes=plan["scratch"], inblock_chunks=INBLOCK_CHUNKS,
         cap_device_ms=cap_ms, timed_shape=list(WKV_SHAPE),
         timed_dtype="float32")
    return {"name": "wkv6", "route": "cuda",
            "source": "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/wkv6/kernel.py:68",
            "design": "chunked scan, states + output kernels, mma.sync "
                      "m16n8k8 3xTF32",
            "max_abs_err": worst, "ms": kernel_ms, "device_ms": device_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "library_note": note, "timed_shape": list(WKV_SHAPE),
            "kernel_device_ms": kernel_device_ms}


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
    from repro_torch.kernels.int8_matmul.ops import (TILES, int8_matmul,
                                                     int8_matmul_i32,
                                                     plan_for)
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
    # x at an odd storage offset (the byte-load instance), and a split K
    # launched twice: the same bits both times
    x, w, _ = operands(784, 1152 + 1, 128)
    x = x.flatten()[1:1 + 784 * 1152].view(784, 1152)
    w = w[1:]
    first = int8_matmul_i32(x, w)
    again = int8_matmul_i32(x, w)
    torch.cuda.synchronize()
    if not (torch.equal(first, int8_matmul_i32_ref(x, w))
            and torch.equal(first, again)):
        raise AssertionError("int8_matmul (784, 1152, 128) at a storage "
                             "offset of 1, split K: not bit-identical")
    results.append({"mkn": [784, 1152, 128], "out": "int32",
                    "x_storage_offset": 1, "launched_twice": True,
                    "bit_identical": True})
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    # every tile of the kernel at the MATMUL_INT8 shape, through the C entry
    # point with the plan's choice overridden (splits 1): each bit for bit
    # and timed by device time, to hold the plan's choice
    from repro_torch.kernels import build
    lib = build.library()
    m, k, n = MATMUL_INT8_SHAPE
    x, w, scale = operands(m, k, n)
    want = int8_matmul_ref(x, w, scale)
    tiles = {}
    for code, (rows, cols) in enumerate(TILES):
        got = torch.empty((m, n), device="cuda")

        def launch(code=code, got=got):
            build.check(lib, lib.aeg_int8_matmul(
                x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                got.data_ptr(), None, m, n, k, code, 1, 0,
                torch.cuda.current_stream().cuda_stream), "int8_matmul")
        launch()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"int8_matmul tile {rows}x{cols} at "
                                 f"{MATMUL_INT8_SHAPE}: not bit-identical")
        tiles[f"{rows}x{cols}"] = profiled_device_ms(torch, launch)[0]

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
        library = {"library_ms": None, "library_device_ms": None,
                   "library_ms_column_major_w": None,
                   "library_device_ms_column_major_w": None}
        if int_mm_accepts(m, k, n):
            wt = w.t().contiguous().t()           # the same w, column-major
            for suffix, ww in (("", w), ("_column_major_w", wt)):
                def lib_call(ww=ww):
                    return torch._int_mm(x, ww)
                library["library_ms" + suffix] = cuda_ms(torch, lib_call)
                library["library_device_ms" + suffix] = profiled_device_ms(
                    torch, lib_call)[0]
        tile, splits = plan_for(m, n, k, sms)
        timed[label] = {
            "mkn": [m, k, n], "out": out, "ms": cuda_ms(torch, kernel),
            "device_ms": profiled_device_ms(torch, kernel)[0],
            "plain_ms": cuda_ms(torch, plain, iters=10, warmup=2),
            **library, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_bytes": nbytes,
            "bound_operations": ops, "tile": list(TILES[tile]),
            "splits": splits}
    note = ("torch._int_mm (cuBLAS, s8 -> s32: the int32 sums without the "
            "scaled epilogue) on the kernel's row-major w; it takes M > 16 "
            "and K, N multiples of 8 only. *_column_major_w: the same call "
            "on a column-major copy of w made before the timing. device_ms: "
            "torch.profiler's device time over 50 calls (a split K's memset "
            "and scale kernel included)")
    emit("kernels_vs_plain", kernel="int8_matmul", cases=results,
         timed=timed, tiles_device_ms=tiles, library_note=note)
    first = timed["matmul_int8"]
    return {"name": "int8_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/int8_matmul/csrc/"
                      "int8_matmul.cu",
            "replaces": "src/repro/kernels/int8_matmul/kernel.py:39",
            "design": "mma.sync m16n8k32 s8, cp.async ring",
            "max_abs_err": 0.0, "ms": first["ms"],
            "device_ms": first["device_ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"],
            "library_device_ms": first["library_device_ms"],
            "library_device_ms_column_major_w": first[
                "library_device_ms_column_major_w"],
            "library_note": note, "timed_shape": first["mkn"],
            "by_shape": timed, "tiles_device_ms": tiles}


# decode_attention: the served decode shapes, (B, S, Hkv, G, D, dtype);
# mistral-nemo-12b's is the benchmark's (32 lanes x 4,096 rows), the others
# slice_arches' and the engines' (4 lanes x 640 rows)
DECODE_NEMO = (32, 4096, 8, 4, 128, "bfloat16")
DECODE_SHAPES = {"qwen2-1.5b": (4, 640, 2, 6, 128, "bfloat16"),
                 "qwen3-14b": (4, 640, 8, 5, 128, "bfloat16"),
                 "phi3-medium-14b": (4, 640, 10, 4, 128, "bfloat16"),
                 "arctic-480b": (4, 640, 8, 7, 128, "bfloat16"),
                 "moonshot-v1-16b-a3b": (4, 640, 16, 1, 128, "bfloat16"),
                 "hymba-1.5b": (4, 640, 5, 5, 64, "bfloat16"),
                 "musicgen-medium": (4, 640, 24, 1, 64, "float16"),
                 "smoke": (4, 64, 2, 2, 16, "bfloat16"),
                 "fp32": (4, 600, 8, 4, 128, "float32"),
                 "fp32-smoke": (3, 64, 2, 2, 16, "float32")}
DECODE_SPLITS = (64, 128, 256, 512, 1024, 2048, 4096)
# the gate: each lane's max |kernel - plain| over that lane's max |plain|.
# Both round the output once to its dtype, from fp32 sums taken in another
# order (and the plain version's weights rounded to the value dtype first),
# so they may differ by an ulp of the output: 2^-7 of its largest value in
# bf16, 2^-10 in f16.
DECODE_REL_TOL = {"bfloat16": 2 ** -7, "float16": 2 ** -10,
                  "float32": 1e-4}


def decode_bound_ms(b, h, hkv, d, rows: int, dtype: str) -> float:
    """Least time (ms) for one decode attention call: q read and o written
    once, and each lane's valid K/V rows (``rows`` in all) read once, over
    the memory rate (a decode call is far below the ridge)."""
    esize = 4 if dtype == "float32" else 2
    return (2 * b * h * d + 2 * rows * hkv * d) * esize / HBM_BYTES_PER_S * 1e3


def decode_fillings(rng, b: int, s: int) -> dict:
    """Each lane's position in mistral-nemo's pool: nemo.chat's mix
    (prompts log-uniform 256 to 3,800 plus up to 138 decoded, a third of
    the pool), nemo.rag's (uniform 1,024 to 3,072 plus up to 64, a half),
    a full cache, and a ragged one with 0, S - 1 and free lanes at 0."""
    import numpy as np
    chat = np.exp(rng.uniform(np.log(256), np.log(3800), b)) + \
        rng.uniform(0, 138, b)
    rag = rng.uniform(1024, 3072, b) + rng.uniform(0, 64, b)
    return {"chat": chat.astype(np.int32), "rag": rag.astype(np.int32),
            "full": np.full(b, s - 1, np.int32),
            "ragged": decode_ragged(rng, b, s)}


def decode_ragged(rng, b: int, s: int):
    """Positions 0, S - 1, 1, S // 3, the last three lanes free (at 0),
    the rest drawn."""
    import numpy as np
    pos = rng.randint(0, s, b)
    special = (0, s - 1, 1, s // 3)[:b]
    pos[:len(special)] = special
    if b >= 8:
        pos[-3:] = 0
    return pos.astype(np.int32)


def decode_lane_err(got, want) -> float:
    """The widest lane's max |got - want| over that lane's max |want|."""
    diff = (got.float() - want.float()).abs().flatten(1).amax(1)
    return (diff / want.float().abs().flatten(1).amax(1)).max().item()


def phase_decode_attention(torch, seed: int) -> dict:
    """Phase 2e: decode_attention against its plain version on the card:
    mistral-nemo's decode (32 lanes x 4,096 rows, 32/8 heads x 128, bf16)
    filled as nemo.chat's and nemo.rag's mixes fill it, full and ragged,
    once with q scaled by 30, once read through block tables of 16-row
    blocks (bit for bit the dense call); every other config's group, head
    dim and dtype; a sliding ring before and after it wraps. Each case is
    gated on ``decode_lane_err`` and reports it with the fp64 truth's
    error of the kernel and of the plain version. Then, at each nemo
    filling, the kernel's time (CUDA events and the profiler's device
    time) beside its bytes bound over the valid rows, the plain version's
    and SDPA's (every row read, masked: the library's yardstick, never on
    the port's path), and the kernel at every split length."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, valid_rows)
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def inputs(b, s, hkv, g, d, dtype, q_scale=1.0):
        dt = getattr(torch, dtype)
        q, k, v = [torch.randn(shape, generator=gen, device="cuda")
                   for shape in ((b, 1, hkv * g, d), (b, s, hkv, d),
                                 (b, s, hkv, d))]
        return (q * q_scale).to(dt), k.to(dt), v.to(dt)

    def paged(k, v, bs=16):
        b, s, hkv, d = k.shape
        w = s // bs
        order = torch.randperm(b * w, generator=gen, device="cuda")
        pools = []
        for a in (k, v):
            pool = torch.zeros((b * w + 1, bs, hkv, d), dtype=a.dtype,
                               device="cuda")
            pool[order] = a.reshape(b * w, bs, hkv, d)
            pools.append(pool)
        return pools[0], pools[1], order.reshape(b, w).int()

    def exact(q, k, v, pos):
        """The dense call in fp64 throughout."""
        bq, _, h, dq = q.shape
        sk, hk = k.shape[1], k.shape[2]
        sc = torch.einsum("bqhgd,bkhd->bhgqk",
                          q.double().reshape(bq, 1, hk, h // hk, dq),
                          k.double()) / dq ** 0.5
        valid = (torch.arange(sk, device="cuda")[None, :]
                 < valid_rows(pos, sk)[:, None])[:, None, None, None, :]
        a = torch.softmax(torch.where(valid, sc, float("-inf")), dim=-1)
        return torch.einsum("bhgqk,bkhd->bqhgd", a, v.double()).reshape(
            bq, 1, h, dq)

    results, worst = [], 0.0

    def check(name, shape, q, k, v, pos, paged_kv=None):
        """One case; ``paged_kv`` = (pool k, pool v, tables) holding k and
        v's rows, read in place of them."""
        nonlocal worst
        dtype = str(q.dtype).split(".")[-1]
        call = (q, k, v, pos) if paged_kv is None else (q, *paged_kv[:2],
                                                        pos, paged_kv[2])
        before = ops.decode_attention.launches
        got = ops.decode_attention(*call)
        torch.cuda.synchronize()
        launched = ops.decode_attention.launches - before
        want = decode_attention_ref(*call)
        truth = exact(q, k, v, pos)
        err = decode_lane_err(got, want)
        case = {"case": name, "shape": list(shape), "dtype": dtype,
                "paged": paged_kv is not None,
                "valid_share": valid_rows(pos, k.shape[1]).sum().item()
                / (pos.shape[0] * k.shape[1]),
                "lane_err": err,
                "max_abs_err": (got.float() - want.float()).abs().max().item(),
                "lane_err_vs_fp64": decode_lane_err(got, truth),
                "plain_lane_err_vs_fp64": decode_lane_err(want, truth)}
        results.append(case)
        if launched != 1 or err > DECODE_REL_TOL[dtype]:
            raise AssertionError(f"decode_attention {case}: {launched} "
                                 f"launches; lane error beyond "
                                 f"{DECODE_REL_TOL[dtype]}")
        worst = max(worst, case["max_abs_err"])
        return got

    b, s, hkv, g, d, dtype = DECODE_NEMO
    q, k, v = inputs(b, s, hkv, g, d, dtype)
    fills = {name: torch.from_numpy(p).cuda()
             for name, p in decode_fillings(rng, b, s).items()}
    for name, pos in fills.items():
        dense = check(f"mistral-nemo-12b {name}", DECODE_NEMO, q, k, v, pos)
        if name == "rag":
            if not torch.equal(check("mistral-nemo-12b rag, paged",
                                     DECODE_NEMO, q, k, v, pos, paged(k, v)),
                               dense):
                raise AssertionError("decode_attention: the paged call is "
                                     "not the dense call's bits")
    q30 = (q.float() * 30).to(q.dtype)
    check("mistral-nemo-12b chat, q x 30", DECODE_NEMO, q30, k, v,
          fills["chat"])
    del q30
    for model, shape in DECODE_SHAPES.items():
        qs, ks, vs = inputs(*shape)
        pos = torch.from_numpy(decode_ragged(rng, shape[0], shape[1])).cuda()
        check(model, shape, qs, ks, vs, pos)
    for ring_dtype in ("bfloat16", "float32"):   # hymba's window of 1,024
        shape = (6, 1024, 5, 5, 64, ring_dtype)
        qs, ks, vs = inputs(*shape)
        pos = torch.tensor([0, 1023, 1024, 5000, 300, 2047],
                           dtype=torch.int32, device="cuda")
        check("ring", shape, qs, ks, vs, pos)

    # times at nemo's fillings: "ms" and "library_ms" CUDA events around
    # 50 calls, "device_ms" and "library_device_ms" the profiler's device
    # time over 50 calls (both of the kernel's launches; every kernel SDPA
    # launches); the plain version over 5 calls
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split_len, n_splits = ops.plan(s, b, hkv, sms)
    qs, ks, vs = (q.transpose(1, 2), k.transpose(1, 2).contiguous(),
                  v.transpose(1, 2).contiguous())      # SDPA's layout
    timed, splits = {}, {}
    for name in ("chat", "rag", "full"):
        pos = fills[name]
        rows = int(valid_rows(pos, s).sum())
        mask = (torch.arange(s, device="cuda")[None, :]
                < valid_rows(pos, s)[:, None])[:, None, None, :]

        def kernel():
            return ops.decode_attention(q, k, v, pos)

        def library():
            return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  enable_gqa=True)
        library_device_ms, library_kernels = profiled_device_ms(torch,
                                                                library)
        timed[name] = {
            "shape": list(DECODE_NEMO), "valid_share": rows / (b * s),
            "split_len": split_len, "n_splits": n_splits,
            "ms": cuda_ms(torch, kernel),
            "device_ms": profiled_device_ms(torch, kernel)[0],
            "plain_ms": cuda_ms(torch, lambda: decode_attention_ref(
                q, k, v, pos), iters=5, warmup=1),
            "library_ms": cuda_ms(torch, library),
            "library_device_ms": library_device_ms,
            "library_kernels": library_kernels,
            "library_lane_err": decode_lane_err(
                library().transpose(1, 2), decode_attention_ref(q, k, v,
                                                                pos)),
            "bound_ms": decode_bound_ms(b, hkv * g, hkv, d, rows, dtype),
            "bound_by": "bytes"}
        timed[name]["bound_share"] = (timed[name]["bound_ms"]
                                      / timed[name]["device_ms"])
        splits[name] = {
            sl: cuda_ms(torch, lambda: ops._decode_attention_op(
                q, k, v, pos, None, sl)) for sl in DECODE_SPLITS}
    emit("kernels_vs_plain", kernel="decode_attention", cases=results,
         timed=timed, split_ms=splits, sms=sms)
    first = timed["chat"]
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/decode_attention/csrc/"
                      "decode_attention.cu",
            "replaces": "none: the JAX package's decode is plain jnp "
                        "(src/repro/models/attention.py decode_attention)",
            "design": "split-KV on the CUDA cores, cp.async ring, fp32 "
                      "softmax and sums, an ordered combine",
            "max_abs_err": worst, "ms": first["ms"],
            "device_ms": first["device_ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"],
            "library_device_ms": first["library_device_ms"],
            "timed_shape": first["shape"], "by_filling": timed}


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
    """Phase 3: full-width fp32 program, kernels vs their plain versions.
    A config with experts prints ``moe_two_layer_fp32``, with each layer's
    worst gap between a token's K-th and (K+1)-th router probabilities in
    either run (a gap near the kernels' rounding would explain a routing
    flip) and the slots its capacity dropped (``router_gaps``)."""
    from repro_torch.core import rbl
    from repro_torch.core.executor import Executor
    from repro_torch.core.rctc import compile_transformer_block
    from repro_torch.core.rtpm import Platform
    from repro_torch.models import mlp
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
    inner, gaps = mlp.moe_ffn, []
    if cfg.num_experts:
        mlp.moe_ffn = router_gaps(torch, gaps)
    try:
        out = ex.run(plat.bind(artifacts=prog.artifacts),
                     inputs=ins)["logits"]
        kernel_gaps = list(gaps)
        plain = ex.run(rbl.bind(with_plain_kernels(prog), rimfs=plat.rimfs,
                                driver=plat.driver), inputs=ins)["logits"]
    finally:
        mlp.moe_ffn = inner
    torch.cuda.synchronize()
    err = (out - plain).abs().max().item()
    moe = {}
    if cfg.num_experts:
        moe = {"experts": cfg.num_experts, "top_k": cfg.experts_per_token,
               "router_by_layer": kernel_gaps,
               "plain_router_by_layer": gaps[len(kernel_gaps):]}
    emit("moe_two_layer_fp32" if cfg.num_experts else "two_layer_fp32",
         model=cfg.name, layers=2, seq=SEQ, image_bytes=len(image),
         setup_s=t1 - t0, run_s=time.perf_counter() - t1,
         logits_max_abs_err=err, atol=PROGRAM_ATOL, **moe)
    if not (torch.isfinite(out).all() and err <= PROGRAM_ATOL):
        raise AssertionError(f"two-layer fp32 {cfg.name} program: kernels "
                             f"vs plain versions max |err| {err} > "
                             f"{PROGRAM_ATOL}")


# ---------------------------------------------------------------------------
# The kernel autotune cache
# ---------------------------------------------------------------------------

def autotune_sites(torch, seed: int) -> list:
    """(label, registry name, operands, keywords) of every tunable kernel
    at the served paths' shapes: ``int8_matmul`` at the ``MATMUL_INT8``
    program's 512 x 1536 x 8960 (fp32 out) and at every ResNet-18 INT8
    convolution's GEMM (int32 out: the stem's 12544 x 147 x 64, 49 x 4608
    x 512 and the rest), ``ssm_scan`` at hymba's shape, ``wkv6`` at
    rwkv6's in fp32 and bf16; then ``flash_attention`` at qwen2's and
    moonshot's (one plan: the default, 0 trials)."""
    from repro_torch.configs.resnet18 import CONFIG
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 11)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    m, k, n = MATMUL_INT8_SHAPE
    sites = [(f"int8_matmul {m}x{k}x{n} float32", "matmul_int8",
              (i8(m, k), i8(k, n), rnd(n).abs() + 0.01),
              {"out_dtype": torch.float32})]
    for m, k, n in resnet_conv_gemms(CONFIG):
        sites.append((f"int8_matmul {m}x{k}x{n} int32", "matmul_int8_i32",
                      (i8(m, k), i8(k, n)), {}))
    b, t, di, n = SSM_SHAPE
    sites.append((f"ssm_scan {b}x{t}x{di}x{n} float32", "ssm_scan",
                  (-rnd(b, t, di, n).abs() * 0.1, rnd(b, t, di, n),
                   rnd(b, t, n)), {}))
    b, t, h, kk = WKV_SHAPE
    for dt in (torch.float32, torch.bfloat16):
        lw = -torch.exp(rnd(b, t, h, kk) * 0.5 - 1.0)
        label = f"wkv6 {b}x{t}x{h}x{kk} {str(dt).removeprefix('torch.')}"
        sites.append((label, "wkv6",
                      tuple(a.to(dt) for a in (rnd(b, t, h, kk),
                                               rnd(b, t, h, kk),
                                               rnd(b, t, h, kk), lw))
                      + (rnd(h, kk),), {}))
    for model in ("qwen2-1.5b", MOE_MODEL):
        b, s, h, hkv, d = ATTENTION_SHAPES[model]
        sites.append((f"flash_attention {model} {b}x{s}x{h}/{hkv}x{d} "
                      f"bfloat16", "attention",
                      (rnd(b, s, h, d, dtype=torch.bfloat16),
                       rnd(b, s, hkv, d, dtype=torch.bfloat16),
                       rnd(b, s, hkv, d, dtype=torch.bfloat16)),
                      {"causal": True}))
    return sites


def default_plan(name: str, args) -> dict:
    """The plan a wrapper takes with no winner."""
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.int8_matmul import ops as im_ops
    from repro_torch.kernels.ssm_scan import ops as ss_ops
    from repro_torch.kernels.wkv6 import ops as wk_ops
    if name.startswith("matmul_int8"):
        x, w = args[0], args[1]
        tile, splits = im_ops.plan_for(x.shape[0], w.shape[1], x.shape[1],
                                       sm_count(x.device.index))
        return {"tile": tile, "splits": splits}
    if name == "ssm_scan":
        plan = ss_ops.plan_of(*args)
        return {"instance": plan.instance, "w": plan.w}
    if name == "wkv6":
        chunks = -(-args[0].shape[1] // 64)
        return {"states": wk_ops.INBLOCK if chunks <= wk_ops.INBLOCK_CHUNKS
                else wk_ops.CARRY}
    return {}


def same_as_default(torch, name: str, got, want) -> tuple:
    """(held, max |err|) of a plan's output against the default plan's:
    bit for bit for ``int8_matmul`` and ``ssm_scan`` (its ring against the
    row-wise instance); ``wkv6`` within WKV_TOLERANCE, fp32 at atol =
    rtol, bf16 of the output's scale (max |y|)."""
    err = (got.float() - want.float()).abs().max().item()
    if name != "wkv6":
        return same_bits(got, want), err
    dt = str(want.dtype).removeprefix("torch.")
    tol = WKV_TOLERANCE[dt]
    if dt == "float32":
        return bool(torch.allclose(got, want, atol=tol, rtol=tol)), err
    return err <= tol * want.float().abs().max().item(), err


def phase_autotune(torch, seed: int) -> dict:
    """Phase 2b: the kernel autotune cache. Every kernel at its served
    shapes (``autotune_sites``) swept from an empty table: each candidate
    plan's ms (CUDA events, the median of 10 launches after a warm-up),
    the winner, the default plan, the trials, and every candidate's output
    against the default plan's (``same_as_default``). The table is packed
    into an image and a fresh ``Platform`` provisioned with it: it must
    post ``autotune_loaded`` with every entry, and a second sweep must
    cost 0 trials and hand back the same winners, whose outputs (through
    ``registry.call``) hold against the defaults again. Then ResNet-18
    INT8 is served once with the table in its image: its replies equal
    the local linked run on an empty table bit for bit, and the linked
    run's host wall is printed with the table empty and loaded, in turns.
    Ends with ``reset()``: the later phases run their default plans.
    Returns the served run's launches (the ``resnet18-int8-autotuned``
    path)."""
    import numpy as np
    from repro_torch.core import rimfs
    from repro_torch.core.rtpm import Platform
    from repro_torch.kernels import registry as kreg
    t0 = time.perf_counter()
    kreg.reset()
    sites = autotune_sites(torch, seed)
    rows, defaults = [], []
    for label, name, args, kw in sites:
        want = kreg.call(name, *args, **kw)       # the default plan
        defaults.append(want)
        plan, trials = kreg.autotune(name, *args, **kw)
        key = kreg.REGISTRY.signature(name, args, kw)
        cands = []
        for c in kreg.REGISTRY.sweeps.get(key, []):
            held, err = same_as_default(
                torch, name, kreg.get(name).kernel(*args, plan=c["params"],
                                                   **kw), want)
            if not held:
                raise AssertionError(f"autotune {label}: plan {c['params']}"
                                     f" differs from the default's by {err}")
            cands.append({"plan": c["params"], "ms": c["ms"],
                          "max_abs_err_vs_default": err})
        rows.append({"site": label, "key": key, "trials": trials,
                     "winner": plan, "default": default_plan(name, args),
                     "winner_is_default": plan in ({}, default_plan(
                         name, args)),
                     "candidates": cands})
    trials_first = kreg.REGISTRY.sweep_trials
    if not trials_first:
        raise AssertionError("autotune: the first sweep ran no trial")
    table = kreg.pack_image()
    winners = {k: dict(v) for k, v in kreg.REGISTRY.winners.items()}
    kreg.reset()
    plat = Platform()
    loaded = []
    plat.events.register("autotune_loaded", loaded.append)
    plat.provision(image=table)
    plat.events.process()
    if loaded != [{"entries": len(winners)}]:
        raise AssertionError(f"autotune: provision posted {loaded}, not "
                             f"{len(winners)} entries loaded")
    second, tuned_checks = 0, []
    for (label, name, args, kw), want, row in zip(sites, defaults, rows):
        plan, trials = kreg.autotune(name, *args, **kw)
        second += trials
        if plan != row["winner"]:
            raise AssertionError(f"autotune {label}: reloaded {plan}, swept "
                                 f"{row['winner']}")
        held, err = same_as_default(torch, name, kreg.call(name, *args, **kw),
                                    want)
        if not held:
            raise AssertionError(f"autotune {label}: the tuned call differs "
                                 f"from the default plan's by {err}")
        tuned_checks.append(err)
    if second or kreg.REGISTRY.sweep_trials:
        raise AssertionError(f"autotune: the reloaded table swept {second} "
                             f"trials")
    del sites, defaults
    t_sweeps = time.perf_counter() - t0

    # ResNet-18 INT8 served with the table in its image
    prog, image = resnet_int8_program(torch, seed)
    prog_bytes = prog.encode()
    fs = rimfs.mount(image)
    files = {name: fs.read(name) for name in fs.files()}
    files[kreg.AUTOTUNE_FILE] = np.frombuffer(
        rimfs.mount(table).read(kreg.AUTOTUNE_FILE).numpy().tobytes(),
        np.uint8)
    tuned_image = rimfs.pack(files)
    size = 224
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 12)
    requests = [{"input": torch.rand((1, size, size, 3), generator=gen,
                                     device="cuda").cpu().numpy()}
                for _ in range(N_REQUESTS)]
    kreg.reset()                                  # an empty table
    _, ex, bound, _, _ = local_platform(torch, image, prog_bytes)
    want = [ex.run(bound, inputs=r)["output"] for r in requests]
    served = serve(torch, tuned_image, prog_bytes, requests, "output")
    n_loaded = len(kreg.REGISTRY.winners)
    if n_loaded != len(winners):
        raise AssertionError(f"autotune: serving the image loaded "
                             f"{n_loaded} entries, not {len(winners)}")
    for i, (got, ref) in enumerate(zip(served["responses"], want)):
        if not same_bits(got, ref.cpu()):
            raise AssertionError(f"autotune: served request {i} on the "
                                 f"tuned plans differs from the default's")
    check_launches("resnet18-int8-autotuned", served["launches"],
                   {"int8_matmul": 20 * N_REQUESTS})
    hits = kreg.REGISTRY.stats.get("params_hit", 0)

    def wall(n=7):
        walls = []
        for _ in range(n):
            t1 = time.perf_counter()
            ex.run(bound, inputs=requests[0])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
        return sorted(walls)[n // 2]
    walls = {"empty": [], "loaded": []}
    for _ in range(3):                            # in turns
        kreg.reset()
        walls["empty"].append(wall())
        kreg.load_image(table)
        walls["loaded"].append(wall())
    tuned = ex.run(bound, inputs=requests[0])["output"]
    if not same_bits(tuned, want[0]):
        raise AssertionError("autotune: the local run on the loaded table "
                             "differs from the empty table's")
    kreg.reset()
    emit("autotune", sites=rows, trials_first=trials_first,
         entries=len(winners), table_bytes=len(table),
         autotune_loaded=loaded, trials_second=second,
         tuned_max_abs_err_vs_default=tuned_checks,
         resnet18_int8={"image_bytes": len(tuned_image),
                        "requests": N_REQUESTS, "bit_identical": True,
                        "params_hits": hits,
                        "launches": served["launches"],
                        "provision_s": served["provision_s"],
                        "linked_wall_s_empty_table": walls["empty"],
                        "linked_wall_s_loaded_table": walls["loaded"]},
         sweeps_s=t_sweeps, seconds=time.perf_counter() - t0)
    del prog, image, tuned_image, ex, bound
    gc.collect()
    torch.cuda.empty_cache()
    return {"resnet18-int8-autotuned": served["launches"]}


# ---------------------------------------------------------------------------
# The moe family
# ---------------------------------------------------------------------------

def router_gaps(torch, log: list):
    """A wrapper of ``mlp.moe_ffn`` that records into ``log``, per call,
    the worst token's gap between its K-th and (K+1)-th router
    probabilities (where a rounding could flip the routing), how many
    (token, choice) slots its capacity dropped and the most slots one
    expert was routed in one group."""
    from repro_torch.models import mlp
    inner = mlp.moe_ffn

    def moe_ffn(cfg_, p, x, group_size=1024):
        r = mlp.route(cfg_, p["router"], mlp._group(x, group_size))
        top = torch.sort(r["probs"], dim=-1, descending=True).values
        k = cfg_.experts_per_token
        gap = top[..., k - 1] - top[..., k]
        log.append({"min_gap": gap.min().item(),
                    "p_k": top[..., k - 1].flatten()[gap.argmin()].item(),
                    "dropped": int((r["keep"] == 0).sum().item()),
                    "max_load": int(r["onehot_e"].sum(dim=(1, 2)).max()
                                    .item()),
                    "slots": r["keep"].numel(), "capacity": r["cap"]})
        return inner(cfg_, p, x, group_size)
    return moe_ffn


def decode_bytes_bound(cfg, params: dict, cache: dict, pos) -> dict:
    """The least bytes one decode step at ``pos`` (B,) must move, and the
    time they take at HBM_BYTES_PER_S: every weight once (the dense MoE
    reads every expert), the embedding's B rows instead of its table (a
    vlm or audio config's B input embeddings), each lane's K and V rows up
    to its position, and the new rows written."""
    weights = sum(v.numel() * v.element_size() for k, v in params.items()
                  if k != "embed")
    rows = cfg.d_model * params["final_norm"].element_size() * len(pos)
    k = cache["k"]
    row_bytes = k.shape[0] * k.shape[3] * k.shape[4] * k.element_size()
    kv = 2 * row_bytes * (sum(int(p) for p in pos) + len(pos))
    total = weights + rows + kv
    return {"bytes": total, "weights_bytes": weights, "kv_bytes": kv,
            "bound_ms": total / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


def kernel_counters() -> dict:
    """Every kernel wrapper of the port, by the name of its row
    (``int8_matmul`` counts the launches of both of its wrappers)."""
    from repro_torch.kernels.registry import launch_counters
    return launch_counters()


def held_burst(torch, server, client, burst: list, output: str) -> dict:
    """Send ``burst`` while the server's dispatcher is held at its next
    item (as tests/test_torch_server.py holds it), release it once every
    request is queued, so the backlog reaches the dispatcher at once, and
    collect the replies. Returns them with the wall from the release to
    the last reply and what the server's ``batched_stats`` gained."""
    gate, started = threading.Event(), threading.Event()
    inner, idle = server._loop.handler, server._loop.on_idle

    def gated(item):
        started.set()
        gate.wait(120)
        inner(item)

    def install():
        # on the dispatcher thread, between items: no call of the old idle
        # hook is under way that could admit a request around the hold
        server._loop.handler = gated
        server._loop.on_idle = lambda: idle() if gate.is_set() else False

    server.run_on_dispatcher(install)
    try:
        rids = [client.infer_async(**req) for req in burst]
        if not started.wait(60):
            raise AssertionError("the dispatcher never reached the burst")
        deadline = time.monotonic() + 60
        while server.scheduler.pending() < len(burst):
            if time.monotonic() > deadline:
                raise AssertionError(f"{server.scheduler.pending()} of "
                                     f"{len(burst)} burst requests queued")
            time.sleep(0.005)
        before = dict(server.batched_stats)
        t0 = time.perf_counter()
        gate.set()
        replies = [client.result(rid, timeout=600)[output] for rid in rids]
        wall = time.perf_counter() - t0
    finally:
        gate.set()
        server._loop.handler, server._loop.on_idle = inner, idle
    gained = {k: server.batched_stats[k] - before[k]
              for k in ("dispatches", "requests", "fallbacks", "seconds")}
    return {"replies": replies, "wall_s": wall, **gained}


def serve(torch, image: bytes, prog_bytes: bytes, requests: list,
          output: str, artifacts=None, burst: list = ()) -> dict:
    """Provision ``image`` and ``prog_bytes`` over protocol v2 into the
    port's InferenceServer on the card and send ``requests`` (the first
    N_REQUESTS - 2 one at a time, the last two pipelined on one
    connection). Every kernel's launch count is set to 0 just before and
    read just after: that run is the path's main run. The device memory
    peak is the server's own: reset here, read after the last reply.

    With a ``burst``, the batched path follows on the same server: the
    burst is sent twice behind the held dispatcher (``held_burst``); the
    first pass stages (and on a batchable program captures) the batch
    bucket, the second is the batched path's run, with the launch counts
    set to 0 just before it and read just after."""
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
    bursts = []
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
        batched_launches = None
        if burst:
            bursts.append(held_burst(torch, server, client, burst, output))
            for wrapper in counters.values():   # the batched path starts
                wrapper.launches = 0
            bursts.append(held_burst(torch, server, client, burst, output))
            batched_launches = {name: w.launches
                                for name, w in counters.items()}
            batched_telemetry = client.telemetry()["serving"]["batched"]
        client.shutdown()
    finally:
        client.close()
        server.stop()
    out = {"responses": responses, "latencies": latencies,
           "launches": launches, "provision_s": t_provision,
           "serve_s": t_serve, "telemetry": telemetry,
           "serve_peak": serve_peak, "serve_base": serve_base}
    if burst:
        out.update(bursts=bursts, batched_launches=batched_launches,
                   batched_telemetry=batched_telemetry)
    return out


def check_batched(torch, path: str, served: dict, want: list,
                  launches: dict, exact: bool, atol: float = 0.0,
                  scale_tol: float = 0.0) -> dict:
    """The batched phase of one served path: each burst's replies against
    ``want`` (the same requests answered solo, or run locally through
    ``Executor.run``): bit for bit where ``exact``, else within ``atol``,
    or within ``scale_tol`` of the largest |value| of the reference. A
    batchable program must have ridden at least one coalesced dispatch on
    each pass and never fallen back to per-request retries; a program the
    batch analysis refuses (GRAPH_EXEC) must be reported so, and served
    one by one. Emits the ``batched`` line; returns the batched path's
    launches (the second pass)."""
    tel = served["batched_telemetry"]
    errs = []
    for b in served["bursts"]:
        if len(b["replies"]) != len(want):
            raise AssertionError(f"batched {path}: {len(b['replies'])} "
                                 f"replies for {len(want)} requests")
        for i, (got, ref) in enumerate(zip(b["replies"], want)):
            got, ref = torch.as_tensor(got).cpu(), torch.as_tensor(ref).cpu()
            if tuple(got.shape) != tuple(ref.shape) or got.dtype != ref.dtype:
                raise AssertionError(f"batched {path} request {i}: "
                                     f"{tuple(got.shape)} {got.dtype}")
            err = (got.float() - ref.float()).abs().max().item()
            errs.append(err)
            scale = ref.float().abs().max().item()
            ok = same_bits(got, ref) if exact or not tel["batchable"] \
                else (err <= atol if atol else err <= scale_tol * scale)
            if not (ok and torch.isfinite(got.float()).all()):
                raise AssertionError(f"batched {path} request {i}: max "
                                     f"|err| {err} against its solo reply")
        if b["fallbacks"]:
            raise AssertionError(f"batched {path}: {b['fallbacks']} "
                                 f"requests fell back to solo retries")
        if tel["batchable"] and b["dispatches"] < 1:
            raise AssertionError(f"batched {path}: no coalesced dispatch")
        if not tel["batchable"] and b["dispatches"]:
            raise AssertionError(f"batched {path}: a refused program "
                                 f"rode a batched dispatch")
    if not tel["batchable"] and "GRAPH_EXEC" not in tel["reason"]:
        raise AssertionError(f"batched {path}: refused for "
                             f"{tel['reason']!r}, not GRAPH_EXEC")
    got_launches = served["batched_launches"]
    launches = {**dict.fromkeys(got_launches, 0), **launches}
    if got_launches != launches:
        raise AssertionError(f"batched {path}: launches {got_launches}, "
                             f"not {launches}")
    n = len(want)
    bucket = next(b for b in (1, 2, 4, 8, 16) if b >= n)
    emit("batched", path=path, requests=n, batchable=tel["batchable"],
         reason=tel["reason"], bucket=bucket if tel["batchable"] else None,
         pad_lanes=bucket - n if tel["batchable"] else None,
         max_abs_err=max(errs), exact=exact or not tel["batchable"],
         atol=atol or None, scale_tol=scale_tol or None,
         launches=got_launches,
         passes=[{"dispatches": b["dispatches"], "requests": b["requests"],
                  "fallbacks": b["fallbacks"],
                  "dispatch_wall_s": b["seconds"],
                  "amortized_s": b["seconds"] / n if b["dispatches"]
                  else None,
                  "release_to_last_reply_s": b["wall_s"]}
                 for b in served["bursts"]],
         note="pass 0 stages the bucket (warm-up run and capture), pass 1 "
              "replays it")
    return got_launches


def phase_fused(torch, path: str, ex, bound, request: dict,
                want: dict) -> dict:
    """The fused path of one served program: ``Executor.fuse`` captured on
    its first call, then replayed. One replay, with the launch counts set
    to 0 just before it and read just after, must launch ``want``, and its
    outputs must equal ``Executor.run``'s bit for bit (the same kernels
    in the same order). Then, in turns (linked, fused, fused, linked), the
    host wall of one call of each, both ending in a sync; the device time
    of one graph replay by CUDA events; and one fused call under
    ``torch.profiler``. Returns the replay's launches."""
    from repro_torch.core.executor import Executor
    fused = ex.fuse(bound)
    weights = ex.weights_from(bound)
    t0 = time.perf_counter()
    fused(request, weights)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    (graph,) = fused.graphs.values()
    counters = kernel_counters()
    for wrapper in counters.values():    # the fused path starts here
        wrapper.launches = 0
    got = fused(request, weights)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in counters.items()}
    want = {**dict.fromkeys(launches, 0), **want}
    if launches != want:
        raise AssertionError(f"fused {path}: one replay launched "
                             f"{launches}, not {want}")
    linked = ex.run(bound, inputs=request)
    if sorted(got) != sorted(linked):
        raise AssertionError(f"fused {path}: outputs {sorted(got)}")
    for k in linked:
        if not same_bits(got[k], linked[k]):
            raise AssertionError(f"fused {path}: {k} differs from the "
                                 f"linked run")

    def wall(fn) -> float:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    def run_linked():
        ex.run(bound, inputs=request)

    def run_fused():
        fused(request, weights)

    linked_s, fused_s = [], []
    for _ in range(3):
        linked_s.append(wall(run_linked))
        fused_s += [wall(run_fused), wall(run_fused)]
        linked_s.append(wall(run_linked))
    replay_ms = cuda_ms(torch, graph.replay, iters=10, warmup=1)
    emit("fused", path=path, capture_s=graph.capture_s,
         first_call_s=first_s, launches_per_replay=launches,
         bit_identical=True,
         replay_wall_s=sorted(fused_s)[len(fused_s) // 2],
         linked_wall_s=sorted(linked_s)[len(linked_s) // 2],
         replay_walls_s=fused_s, linked_walls_s=linked_s,
         graph_replay_device_ms=replay_ms,
         fused_call=device_breakdown(torch, run_fused))
    Executor.release_graphs(bound)
    del fused, graph, got
    gc.collect()
    torch.cuda.empty_cache()
    return launches


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


def phase_slice(torch, cfg, seed: int, phase: str,
                keep: dict = None) -> dict:
    """Phase 4: one served path. Returns each kernel's launches while the
    server answered the requests (the main path's run). ``keep`` gets the
    program, the image and the requests (the partitioned phase reuses
    them)."""
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
    if keep is not None:
        keep.update(cfg=cfg, prog=prog, image=image, requests=requests)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    compile_peak = torch.cuda.max_memory_allocated()
    # from here until the last reply nothing else of this process holds
    # device memory beyond ``serve_base``: the peak is the server's own
    served = serve(torch, image, prog_bytes, requests, "logits",
                   artifacts=prog.artifacts,
                   burst=requests[:BURST["lm"]])
    launches = served["launches"]
    per_layer = {"flash_attention": int(cfg.family != "ssm"),
                 "ssm_scan": int(cfg.family == "hybrid"),
                 "wkv6": int(cfg.family == "ssm"), "int8_matmul": 0,
                 "decode_attention": 0}
    per_request = {k: v * cfg.num_layers for k, v in per_layer.items()}
    for name, n in launches.items():
        want = per_request[name] * N_REQUESTS
        if n != want:
            raise AssertionError(f"{name} launched {n} times for "
                                 f"{N_REQUESTS} requests of {cfg.num_layers} "
                                 f"{cfg.family} layers, not {want}")
    # the burst: one replay of bucket 4 (qwen2); one by one, refused (the
    # GRAPH_EXEC glue of hymba and rwkv6)
    lanes = 1 if cfg.family == "dense" else BURST["lm"]
    batched = check_batched(
        torch, cfg.name, served, served["responses"][:BURST["lm"]],
        {k: v * lanes for k, v in per_request.items()}, exact=False,
        scale_tol=BATCH_BF16_TOL)

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
    fused = phase_fused(torch, cfg.name, ex, bound, requests[0], per_request)
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
    return {cfg.name: launches, f"{cfg.name}-fused": fused,
            f"{cfg.name}-batched": batched}


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
    burst = requests[:BURST["matmul_int8"]] if out == "float32" else ()
    served = serve(torch, image, prog_bytes, requests, "out", burst=burst)
    check_launches(f"slice_matmul_int8 {out}", served["launches"],
                   {"int8_matmul": N_REQUESTS})
    path = f"matmul_int8-{out}"
    paths = {path: served["launches"]}
    if burst:
        # x, w and scale all carry the lane axis: the vmap rule launches
        # the kernel once per lane of bucket 4
        paths[f"{path}-batched"] = check_batched(
            torch, path, served, served["responses"][:len(burst)],
            {"int8_matmul": 4}, exact=True)
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
    paths[f"{path}-fused"] = phase_fused(torch, path, ex, bound, requests[0],
                                         {"int8_matmul": 1})
    return paths


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


def phase_slice_resnet(torch, seed: int, int8: bool,
                       keep: dict = None) -> dict:
    """Phase 5b/5c: ResNet-18 at full width, fp32 or INT8 (calibrated on
    the card on a seeded batch of 4 images), compiled, provisioned and
    served; INT8 launches int8_matmul once per CONV2D_I8, 20 a request.
    ``keep`` gets the program, the image, the requests, the served replies
    and the burst (the partitioned phases reuse them)."""
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
    burst_gen = torch.Generator(device="cuda")
    burst_gen.manual_seed(seed + 8)
    burst = [{"input": torch.rand((1, size, size, 3), generator=burst_gen,
                                  device="cuda").cpu().numpy()}
             for _ in range(BURST["resnet"])]
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
    served = serve(torch, image, prog_bytes, requests, "output", burst=burst)
    n_conv = sum(resnet_conv_gemms(CONFIG).values())
    per_request = {"int8_matmul": n_conv if int8 else 0}
    check_launches(phase, served["launches"],
                   {k: v * N_REQUESTS for k, v in per_request.items()})
    plat, ex, bound, t_fsck, t_bind = local_platform(torch, image,
                                                     prog_bytes)
    linked = check_served(ex, bound, requests, served["responses"], "output")
    if keep is not None:
        keep.update(prog=prog, image=image, requests=requests,
                    responses=served["responses"], burst=burst)
    path = "resnet18-int8" if int8 else "resnet18"
    # bucket 8: the convolutions' lanes fold into M, one launch each
    paths = {path: served["launches"], f"{path}-batched": check_batched(
        torch, path, served, [ex.run(bound, inputs=r)["output"]
                              for r in burst], per_request, exact=False,
        atol=RESNET_ATOL)}
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
    paths[f"{path}-fused"] = phase_fused(torch, path, ex, bound, requests[0],
                                         per_request)
    return paths


# tile groups: the partitioned paths over 1, 2 and 4 groups of one card
GROUPS = (1, 2, 4)
STREAM_IMAGES, STREAM_DEPTH = 32, 4
TURN_ROUNDS = 6            # host walls spread by up to 2x within one call
FAILOVER_GROUPS = (2, 3)
CHAIN_DEPTH, CHAIN_N = 8, 1024          # the failover phase's GEMM chain
KERNEL_OPS = {"ATTENTION": "flash_attention", "SSM_SCAN": "ssm_scan",
              "WKV6": "wkv6", "MATMUL_INT8": "int8_matmul",
              "GEMM_I8": "int8_matmul", "CONV2D_I8": "int8_matmul"}


def kernel_launches_of(prog) -> dict:
    """Each kernel's launches in one run of ``prog``: one a kernel op."""
    out = dict.fromkeys(kernel_counters(), 0)
    for op in prog.ops():
        name = KERNEL_OPS.get(op.op.name)
        if name is not None:
            out[name] += 1
    return out


def launches_now() -> dict:
    return {name: w.launches for name, w in kernel_counters().items()}


def zero_launches() -> None:
    for w in kernel_counters().values():
        w.launches = 0


def resident_bytes(fs, driver) -> int:
    """Bytes of the image pinned on ``driver`` (0 where none is)."""
    entry = fs._resident.get(id(driver))
    return entry[1].nbytes() if entry is not None \
        and entry[0]() is driver else 0


def cut_table(part) -> list:
    """The cut: each stage's blocks (and of them the layers), its kernel
    ops, the bytes of its weights, and the edges it streams."""
    from repro_torch.dtypes import itemsize
    out = []
    for t in part.tiles:
        prog = t.program
        wbytes = sum(itemsize(prog.tensors[w].dtype)
                     * math.prod(prog.tensors[w].shape)
                     for w in t.weight_syms)
        out.append({
            "stage": t.gid, "blocks": [b.block_id for b in prog.blocks],
            "layers": [b.block_id for b in prog.blocks
                       if b.block_type == "layer"],
            "ops": sum(len(b.ops) for b in prog.blocks),
            "kernel_ops": {k: v for k, v in
                           kernel_launches_of(prog).items() if v},
            "weight_bytes": wbytes,
            "edges": [{"sym": e.sym, "to": e.dst, "bytes": e.nbytes}
                      for e in part.edges_from(t.gid)]})
    return out


def release_mesh(torch, part, mesh, fs) -> None:
    """Unpin the groups' weights and drop the tiles' bindings on them."""
    for t in part.tiles:
        t._bound.clear()
    for g in mesh.groups:
        entry = fs._resident.get(id(g.driver))
        if entry is not None:
            entry[1].unpin()
    gc.collect()
    torch.cuda.empty_cache()


def timed_edges(mesh) -> tuple:
    """Wrap every group's d2d issue and redemption with a host clock: the
    seconds inside them, the CRC-32 stamp (which reads the payload back
    after the producer's work) and check included. Returns (seconds,
    undo)."""
    spent = {"issue_s": 0.0, "redeem_s": 0.0, "edges": 0}
    undo = []
    for g in mesh.groups:
        drv = g.driver
        issue, redeem = drv.dma_async, drv.dma_wait

        def timed_issue(buf, direction, prefetched=False, _f=issue):
            t = time.perf_counter()
            try:
                return _f(buf, direction, prefetched=prefetched)
            finally:
                if direction == "d2d":
                    spent["issue_s"] += time.perf_counter() - t
                    spent["edges"] += 1

        def timed_redeem(ticket, _f=redeem):
            t = time.perf_counter()
            try:
                return _f(ticket)
            finally:
                if ticket.direction == "d2d":
                    spent["redeem_s"] += time.perf_counter() - t
        drv.dma_async, drv.dma_wait = timed_issue, timed_redeem
        undo.append((drv, issue, redeem))

    def restore():
        for drv, issue, redeem in undo:
            drv.dma_async, drv.dma_wait = issue, redeem
    return spent, restore


def set_integrity(mesh, on: bool) -> None:
    for g in mesh.groups:
        g.driver.integrity.enabled = on


def partitioned_run(torch, path: str, bound, fs, n: int, requests: list,
                    refs: list, output: str, linked) -> tuple:
    """One program over ``TileMesh(n)``: every tile pinned on its group
    (``pin_s``), then each request through ``partition.execute`` under an
    orchestrating Platform, its output held to ``Executor.run``'s bit for
    bit. The launch counts are set to 0 just before the requests and read
    just after: each kernel launches as often as the program's kernel ops,
    and each stage's launches (read on its ``stage_complete``) match its
    tile's. Each group's stage time on the device comes from CUDA events
    on its stream (from its redemption to its last op: the idle gaps while
    the host enqueues included); the edges' issue and redemption (with the
    CRC stamp and check) by the host clock; then the same requests with
    the groups' integrity on and off and through ``linked`` (one driver's
    ``Executor.run``), in turns (``TURN_ROUNDS`` rounds, the order
    reversed every other round), for what the stamp costs a request
    against the unpartitioned walk; and one request under
    ``torch.profiler``, each stream's busy time and overlap. Returns (the
    row, the path's launches)."""
    from repro_torch.core import partition, rhal
    from repro_torch.core.rtpm import Platform
    part = partition.ensure_partition(bound, n)
    mesh = rhal.TileMesh(n)
    t0 = time.perf_counter()
    partition.prewarm(part, mesh, rimfs=fs)
    for g in mesh.groups:
        g.driver.barrier()
    pin_s = time.perf_counter() - t0
    pinned = [resident_bytes(fs, mesh.group(t.gid).driver)
              for t in part.tiles]
    orch = Platform()
    stage_launches: list = []
    last = {}

    def on_stage(p):
        now = launches_now()
        stage_launches.append((p["group"], {k: now[k] - last[k]
                                            for k in now}))
        last.update(now)
    orch.events.register("stage_complete", on_stage)
    spent, restore = timed_edges(mesh)
    walls, device_ms = [], []
    zero_launches()                          # the path's run starts here
    last.update(launches_now())
    try:
        for i, (req, ref) in enumerate(zip(requests, refs)):
            events: list = []
            t = time.perf_counter()
            out = partition.execute(part, mesh, inputs=req, rimfs=fs,
                                    platform=orch, stage_events=events)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            if not same_bits(out[output], ref):
                raise AssertionError(f"{path}: request {i} differs from "
                                     f"Executor.run")
            per_group = dict.fromkeys((t.gid for t in part.tiles), 0.0)
            for gid, start, end in events:
                per_group[gid] += start.elapsed_time(end)
            device_ms.append(per_group)
        launches = launches_now()
    finally:
        restore()
    want = kernel_launches_of(bound.program)
    if launches != {k: v * len(requests) for k, v in want.items()}:
        raise AssertionError(f"{path}: launched {launches} for "
                             f"{len(requests)} requests of {want}")
    for gid, got in stage_launches:
        tile_want = kernel_launches_of(part.tiles[gid].program)
        if got != tile_want:
            raise AssertionError(f"{path}: group {gid} launched {got}, its "
                                 f"tile holds {tile_want}")
    if mesh.moved_bytes() != len(requests) * part.cut_bytes():
        raise AssertionError(f"{path}: moved {mesh.moved_bytes()} bytes, "
                             f"cut {len(requests)} x {part.cut_bytes()}")
    moved = mesh.moved_bytes()
    turns = {"linked": [], True: [], False: []}
    for r in range(TURN_ROUNDS):
        for mode in ("linked", True, False)[::1 if r % 2 else -1]:
            if mode != "linked":
                set_integrity(mesh, mode)
            for req in requests:
                t = time.perf_counter()
                if mode == "linked":
                    linked(req)
                else:
                    partition.execute(part, mesh, inputs=req, rimfs=fs)
                torch.cuda.synchronize()
                turns[mode].append(time.perf_counter() - t)
    set_integrity(mesh, True)
    profiled = stream_busy(
        torch, lambda: partition.execute(part, mesh, inputs=requests[0],
                                         rimfs=fs), n)

    def p50(xs):
        return sorted(xs)[len(xs) // 2]
    row = {
        "groups": n, "cut": cut_table(part), "cut_bytes": part.cut_bytes(),
        "moved_bytes": moved, "pin_s": pin_s,
        "pinned_bytes_by_group": pinned,
        "request_wall_s": walls,
        "request_wall_p50_s": p50(walls),
        "stream_elapsed_ms_by_group": {gid: sum(d[gid] for d in device_ms)
                                       / len(device_ms)
                                       for gid in device_ms[0]},
        "edge_issue_s_per_request": spent["issue_s"] / len(requests),
        "edge_redeem_s_per_request": spent["redeem_s"] / len(requests),
        "edges_per_request": spent["edges"] / len(requests),
        "wall_crc_on_p50_s": p50(turns[True]),
        "wall_crc_off_p50_s": p50(turns[False]),
        "wall_linked_one_driver_p50_s": p50(turns["linked"]),
        "turns_s": {str(k): v for k, v in turns.items()},
        "profiled_request": profiled,
        "launches": launches,
        "launches_by_group": {gid: got for gid, got in stage_launches[
            :len(part.tiles)]}}
    release_mesh(torch, part, mesh, fs)
    return row, launches


def local_bound(torch, prog, image, artifacts=None):
    """The program and image provisioned and bound on one driver, the
    weights pinned there: (platform, executor, bound)."""
    from repro_torch.core.executor import Executor
    from repro_torch.core.rtpm import Platform
    plat = Platform()
    plat.provision(image=image, program_bytes=prog.encode())
    bound = plat.bind(artifacts=artifacts)
    torch.cuda.synchronize()
    return plat, Executor(driver=plat.driver), bound


def phase_slice_partitioned(torch, keep: dict) -> dict:
    """qwen2-1.5B, 28 bf16 layers, B = 1, S = 512, over ``TileMesh(n)`` for
    n = 1, 2 and 4, 4 requests each (the ``slice`` phase's program, image
    and requests): bit for bit against ``Executor.run`` on one driver, 28
    ``flash_attention`` launches a request summed over the groups, each
    group's as many as its tile's layers, ``moved_bytes() ==
    cut_bytes()``, and the groups' pinned bytes summing to the single
    driver's. Returns each n's launches."""
    cfg, prog, image, requests = (keep[k] for k in
                                  ("cfg", "prog", "image", "requests"))
    t0 = time.perf_counter()
    plat, ex, bound = local_bound(torch, prog, image, prog.artifacts)
    single = resident_bytes(plat.rimfs, plat.driver)
    refs = [ex.run(bound, inputs=r)["logits"] for r in requests]
    torch.cuda.synchronize()
    linked = []
    for _ in range(3):                   # one driver's linked wall, for n
        t = time.perf_counter()
        ex.run(bound, inputs=requests[0])
        torch.cuda.synchronize()
        linked.append(time.perf_counter() - t)
    setup_s = time.perf_counter() - t0
    rows, paths = [], {}
    for n in GROUPS:
        row, launches = partitioned_run(
            torch, f"slice_partitioned/{n}", bound, plat.rimfs, n,
            requests, refs, "logits",
            lambda req: ex.run(bound, inputs=req))
        if sum(row["pinned_bytes_by_group"]) != single:
            raise AssertionError(f"slice_partitioned/{n}: the groups pin "
                                 f"{row['pinned_bytes_by_group']}, one "
                                 f"driver {single}")
        rows.append(row)
        paths[f"{cfg.name}-partitioned-{n}"] = launches
    emit("slice_partitioned", model=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, seq=SEQ, requests=len(requests),
         image_bytes=len(image), single_driver_pinned_bytes=single,
         setup_s=setup_s, linked_wall_s=sorted(linked)[1],
         linked_walls_s=linked, bit_identical=True, by_groups=rows)
    plat.rimfs.unpin_all()
    del plat, ex, bound, refs
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def stream_busy(torch, fn, n_groups: int) -> dict:
    """``fn`` under ``torch.profiler``: each stream's device busy seconds
    (the union of its kernels' and copies' intervals) and the share of the
    device's busy time in which two or more streams ran at once. Stage 0
    runs first, and group g's stream first runs when a sample reaches
    stage g, so the streams, ordered by their first activity, are groups
    0 to ``n_groups - 1``; any other is named ``other<k>``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_stream: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            by_stream.setdefault(e.device_resource_id(), []).append(
                (e.start_ns(), e.end_ns()))
    merged: dict = {}                   # per stream: its intervals' union
    for sid, ivs in by_stream.items():
        out = []
        for a, b in sorted(ivs):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        merged[sid] = out
    order = sorted(merged, key=lambda sid: merged[sid][0][0])
    name = {sid: f"group{i}" if i < n_groups else f"other{i - n_groups}"
            for i, sid in enumerate(order)}
    edges = sorted([(a, 1) for ivs in merged.values() for a, _ in ivs]
                   + [(b, -1) for ivs in merged.values() for _, b in ivs])
    busy_ns = overlap_ns = 0
    active, prev = 0, None
    for t, d in edges:
        if prev is not None:
            if active >= 1:
                busy_ns += t - prev
            if active >= 2:
                overlap_ns += t - prev
        active += d
        prev = t
    return {"busy_s_by_stream": {name[sid]: sum(b - a for a, b in ivs) / 1e9
                                 for sid, ivs in merged.items()},
            "device_busy_s": busy_ns / 1e9,
            "two_or_more_streams_share": overlap_ns / busy_ns
            if busy_ns else None}


def phase_slice_partitioned_resnet(torch, seed: int, keep: dict) -> dict:
    """ResNet-18 INT8 at 224 px (the ``slice_resnet18_int8`` phase's
    program, image and requests) over ``TileMesh(n)`` for n = 1, 2 and 4:
    bit for bit against ``Executor.run``, 20 ``int8_matmul`` launches a
    request. Then ``execute_stream`` over 32 images at depth 4, fused and
    linked, with the groups' CRC stamp on (gated: in order, bit for bit
    against serial runs, 20 launches an image) and off: images/s, each
    group's busy host seconds, each stage's device time on its stream and
    the share of device time with two or more streams running (from
    ``torch.profiler``). Returns each path's launches."""
    from repro_torch.configs.resnet18 import CONFIG
    from repro_torch.core import partition, rhal
    prog, image, requests = keep["prog"], keep["image"], keep["requests"]
    plat, ex, bound = local_bound(torch, prog, image)
    refs = [ex.run(bound, inputs=r)["output"] for r in requests]
    rows, paths = [], {}
    for n in GROUPS:
        row, launches = partitioned_run(
            torch, f"slice_partitioned_resnet18_int8/{n}", bound,
            plat.rimfs, n, requests, refs, "output",
            lambda req: ex.run(bound, inputs=req))
        rows.append(row)
        paths[f"resnet18-int8-partitioned-{n}"] = launches
    size = CONFIG.image_size
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 9)
    images = [{"input": torch.rand((1, size, size, 3), generator=gen,
                                   device="cuda").cpu().numpy()}
              for _ in range(STREAM_IMAGES)]
    serial = [ex.run(bound, inputs=x)["output"] for x in images]
    torch.cuda.synchronize()
    per_image = kernel_launches_of(prog)
    streams = []
    for n in GROUPS:
        part = partition.ensure_partition(bound, n)
        mesh = rhal.TileMesh(n)
        partition.prewarm(part, mesh, rimfs=plat.rimfs)
        for fused in (True, False):
            mode = "fused" if fused else "linked"
            for crc in (True, False):
                set_integrity(mesh, crc)

                def run(stats=None):
                    return list(partition.execute_stream(
                        part, mesh, iter(images), rimfs=plat.rimfs,
                        depth=STREAM_DEPTH, fused=fused, stats=stats))
                list(partition.execute_stream(     # capture / warm
                    part, mesh, iter(images[:STREAM_DEPTH]),
                    rimfs=plat.rimfs, depth=STREAM_DEPTH, fused=fused))
                torch.cuda.synchronize()
                stats: dict = {}
                zero_launches()              # the stream path starts here
                t = time.perf_counter()
                outs = run(stats)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                launches = launches_now()
                label = f"stream/{n}/{mode}/crc={crc}"
                if len(outs) != len(images) or any(
                        not same_bits(o["output"], r)
                        for o, r in zip(outs, serial)):
                    raise AssertionError(f"{label}: outputs out of order or "
                                         f"differ from serial runs")
                if launches != {k: v * len(images)
                                for k, v in per_image.items()}:
                    raise AssertionError(f"{label}: launched {launches}")
                if crc:
                    paths[f"resnet18-int8-stream-{n}-{mode}"] = launches
                streams.append({
                    "groups": n, "mode": mode, "crc": crc,
                    "images": len(images), "depth": STREAM_DEPTH,
                    "wall_s": wall, "images_per_s": len(images) / wall,
                    "busy_host_s_by_group": stats["busy"],
                    "ticks": stats["ticks"], "in_order_bit_identical": True,
                    "profiled": stream_busy(torch, run, n)})
        set_integrity(mesh, True)
        release_mesh(torch, part, mesh, plat.rimfs)
    emit("slice_partitioned_resnet18_int8", model=CONFIG.name,
         image_size=size, requests=len(requests),
         bit_identical=True, by_groups=rows, stream=streams)
    plat.rimfs.unpin_all()
    return paths


def failover_case(torch, name: str, prog, image: bytes, request: dict,
                  output: str, ref, n: int) -> dict:
    """One program over ``TileMesh(n)`` under a Platform with a fake clock:
    group 1 is killed on stage 0's ``stage_complete``; its stage re-queues
    on group 0 with a bit-identical result and the counters move; the
    killed arena refuses ``alloc``; ``revive`` with the image lifts the
    quarantine; after one resident weight is flipped on the card,
    ``revive`` raises ``IntegrityError("residency_crc")``; with every
    group dead the run raises ``TileFailure``."""
    from repro_torch.core import partition, rbl, rhal, rimfs
    from repro_torch.core.integrity import IntegrityError
    from repro_torch.core.rtpm import Platform
    fs = rimfs.mount(image)
    bound = rbl.bind(prog, rimfs=fs)         # host views: the groups pin
    part = partition.ensure_partition(bound, n)
    mesh = rhal.TileMesh(n)
    partition.prewarm(part, mesh, rimfs=fs)
    clock = {"now": 0.0}
    orch = Platform(deadline=5.0, clock=lambda: clock["now"])
    log = []
    for kind in ("tile_failure", "worker_failed", "stage_requeued"):
        orch.events.register(kind, lambda p, k=kind: log.append(k))

    def on_stage(p):
        if p["stage"] == 0 and mesh.alive(1):
            mesh.kill(1)
            clock["now"] += 10.0
    orch.events.register("stage_complete", on_stage)
    t0 = time.perf_counter()
    out = orch.run_partitioned(bound, inputs=request, mesh=mesh, rimfs=fs)
    torch.cuda.synchronize()
    failover_s = time.perf_counter() - t0
    label = f"partitioned_failover/{name}/{n}"
    if not same_bits(out[output], ref):
        raise AssertionError(f"{label}: the re-queued run differs")
    counters = orch.telemetry.counters()
    if counters.get("tile_failures") != 1 or "stage_requeued" not in log \
            or orch.heartbeats.workers["tile1"].alive:
        raise AssertionError(f"{label}: counters {counters}, events {log}")
    arena = mesh.group(1).driver.arena
    try:
        arena.alloc(128)
        raise AssertionError(f"{label}: the killed arena took an alloc")
    except rhal.TileFailure:
        pass
    mesh.revive(1, rimfs=fs)
    if arena.poisoned or not mesh.alive(1):
        raise AssertionError(f"{label}: revive left the arena quarantined")
    again = partition.execute(part, mesh, inputs=request, rimfs=fs)
    if not same_bits(again[output], ref):
        raise AssertionError(f"{label}: the revived mesh's run differs")
    ri = fs._resident[id(mesh.group(1).driver)][1]
    victim = ri.files()[0]
    raw = ri.buffer(victim).view(torch.uint8).view(-1)
    mesh.kill(1)
    raw[0] ^= 1                              # a half-written weight copy
    try:
        mesh.revive(1, rimfs=fs)
        raise AssertionError(f"{label}: revive took a corrupted weight")
    except IntegrityError as e:
        if e.kind != "residency_crc" or not arena.poisoned:
            raise AssertionError(f"{label}: {e.kind}, poisoned "
                                 f"{arena.poisoned}")
    raw[0] ^= 1
    for gid in mesh.gids:
        mesh.kill(gid)
    try:
        partition.execute(part, mesh, inputs=request, rimfs=fs)
        raise AssertionError(f"{label}: a run over dead groups returned")
    except rhal.TileFailure:
        pass
    release_mesh(torch, part, mesh, fs)
    return {"program": name, "groups": n, "killed": 1,
            "events": log, "counters": counters, "failover_wall_s":
            failover_s, "corrupted_weight": victim, "bit_identical": True}


def phase_partitioned_failover(torch, seed: int, keep: dict) -> None:
    """Stage failover on the GEMM chain (8 fp32 layers of 1024 x 1024) and
    on ResNet-18 INT8, each over 2 and 3 groups (``failover_case``)."""
    import numpy as np
    from repro_torch.core import rctc, rimfs
    chain = rctc.compile_gemm_chain(CHAIN_DEPTH, CHAIN_N)
    chain_image = rimfs.pack(rctc.gemm_chain_weights(CHAIN_DEPTH, CHAIN_N,
                                                     seed))
    x = np.random.RandomState(seed).randn(CHAIN_N, CHAIN_N).astype(
        np.float32)
    cases = []
    for name, prog, image, req, output in (
            ("gemm_chain", chain, chain_image, {"input": x}, "output"),
            ("resnet18-int8", keep["prog"], keep["image"],
             keep["requests"][0], "output")):
        plat, ex, bound = local_bound(torch, prog, image)
        ref = ex.run(bound, inputs=req)[output]
        for n in FAILOVER_GROUPS:
            cases.append(failover_case(torch, name, prog, image, req,
                                       output, ref, n))
        plat.rimfs.unpin_all()
    emit("partitioned_failover", cases=cases)


def phase_served_mesh(torch, keep: dict) -> dict:
    """``InferenceServer(mesh=TileMesh(2))`` serves ResNet-18 INT8: the
    requests' replies equal the single-driver server's (the
    ``slice_resnet18_int8`` phase's) bit for bit, with 20 ``int8_matmul``
    launches a request; a held burst of 3 is dispatched one at a time; a
    group that hangs on a DMA redemption is killed by the watchdog and the
    client still gets the bit-identical answer. Returns the path's
    launches."""
    from repro_torch.core import rhal
    from repro_torch.serving.server import Client, InferenceServer
    prog, image = keep["prog"], keep["image"]
    requests, single = keep["requests"], keep["responses"]
    big = (1 << 32) - 1
    plat, ex, bound = local_bound(torch, prog, image)
    burst = keep["burst"][:3]
    burst_refs = [ex.run(bound, inputs=b)["output"].cpu() for b in burst]
    plat.rimfs.unpin_all()
    mesh = rhal.TileMesh(2)
    server = InferenceServer(mesh=mesh, max_frame=big, watchdog_floor=0.5,
                             watchdog_slack=8.0, watchdog_poll=0.01)
    server.start()
    client = Client(server.address, max_frame=big)
    killed = threading.Event()
    kill = mesh.kill

    def kill_and_signal(gid):
        kill(gid)
        killed.set()
    mesh.kill = kill_and_signal
    try:
        client.provision(image, prog.encode())
        zero_launches()                      # the served mesh path
        t0 = time.perf_counter()
        replies = [client.infer(**r)["output"] for r in requests[:2]]
        rids = [client.infer_async(**r) for r in requests[2:]]
        replies += [client.result(rid)["output"] for rid in rids]
        serve_s = time.perf_counter() - t0
        launches = launches_now()
        for i, (got, want) in enumerate(zip(replies, single)):
            if not same_bits(got, want):
                raise AssertionError(f"served_mesh: request {i} differs "
                                     f"from the single-driver server's")
        want = kernel_launches_of(prog)
        if launches != {k: v * len(requests) for k, v in want.items()}:
            raise AssertionError(f"served_mesh: launched {launches}")
        held = held_burst(torch, server, client, burst, "output")
        if held["dispatches"] != 0 or any(
                not same_bits(g, w) for g, w in zip(held["replies"],
                                                    burst_refs)):
            raise AssertionError(f"served_mesh: the burst coalesced "
                                 f"({held['dispatches']}) or differs")
        group = mesh.group(1)
        orig = group.driver.dma_wait
        hung = {"released": None}

        def hang(ticket):
            if hung["released"] is None:     # a wedged endpoint, once
                hung["released"] = killed.wait(120)
            return orig(ticket)
        group.driver.dma_wait = hang
        t1 = time.perf_counter()
        try:
            got = client.infer(timeout=300, **requests[0])["output"]
        finally:
            group.driver.dma_wait = orig
        hang_s = time.perf_counter() - t1
        counters = client.telemetry()["counters"]
        if not (hung["released"] and same_bits(got, single[0])
                and counters.get("watchdog_preemptions", 0) >= 1
                and not mesh.alive(1)
                and group.driver.arena.poisoned):
            raise AssertionError(f"served_mesh: watchdog kill {hung}, "
                                 f"counters {counters}")
        client.shutdown()
    finally:
        client.close()
        server.stop()
    emit("served_mesh", groups=2, requests=len(requests), serve_s=serve_s,
         launches=launches, bit_identical=True,
         burst={"requests": len(burst), "dispatches": held["dispatches"],
                "wall_s": held["wall_s"], "bit_identical": True},
         watchdog={"killed_group": 1, "answer_s": hang_s,
                   "bit_identical": True, "counters": counters})
    return {"resnet18-int8-served-mesh": launches}


# the fleet and overload control plane (core/fleet.py, serving/overload.py)
# over a TileMesh: 3 paced clients, 96 requests from a pool of 8 images
FLEET_REQUESTS, FLEET_CLIENTS, FLEET_PACE_S = 96, 3, 0.02
FLEET_LADDER = (2, 4, 8)
FLEET_MEMORY_TOL = 0.01            # of the image's pinned bytes
QWEN2_PROBATION = 2                # qwen2 requests served in probation
# a stall of each redemption on the slowed group, inside the watchdog's
# 0.5 s floor (a longer one reads as a hang); against the peers' stages of
# 3 to 6 ms on the card (2 groups, as the tile-group phase times them) it
# reaches 50 to 90x their median, and its EWMA passes the straggler ratio
# within two requests; the card's natural imbalance stays under 3x
FLEET_SLOW_S = 0.3
FLEET_STRAGGLER_RATIO = 20.0


def run_lengths(kinds: list) -> list:
    """[[kind, n], ...]: the event kinds in order, repeats folded."""
    out: list = []
    for k in kinds:
        if out and out[-1][0] == k:
            out[-1][1] += 1
        else:
            out.append([k, 1])
    return out


def cuda_memory(torch) -> dict:
    """The caching allocator's bytes once the card is idle: ``allocated``
    (``memory_allocated``, whole blocks) and ``requested`` (the bytes the
    program asked for). A large block taken from a freed one keeps up to
    1 MiB of its slack, so after a release the allocated count moves by
    the history of freed blocks as well as by what is held; the requested
    count moves by what is held alone. A freed block marked for another
    stream (``record_stream``: a cut edge, a handed-back output) stays
    counted until the allocator processes its events, which it does at
    its next allocation: one tiny allocation after the sync settles both."""
    torch.cuda.synchronize()
    torch.empty(1, device="cuda")
    stats = torch.cuda.memory_stats()
    return {"allocated": stats["allocated_bytes.all.current"],
            "requested": stats["requested_bytes.all.current"]}


def resnet_int8_program(torch, seed: int) -> tuple:
    """ResNet-18 INT8 at 224 px with weights from ``seed``, calibrated on
    the card on 4 seeded images as ``phase_slice_resnet`` calibrates:
    (program, image)."""
    from repro_torch.configs.resnet18 import CONFIG
    from repro_torch.core import quant
    from repro_torch.core.rctc import compile_resnet18
    from repro_torch.models.resnet import fold_bn, init_resnet
    folded = fold_bn(init_resnet(CONFIG, seed))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 7)
    size = CONFIG.image_size
    calib_x = torch.rand((4, size, size, 3), generator=gen, device="cuda")
    pack = quant.quantize_resnet(CONFIG, folded, calib_x)
    return compile_resnet18(CONFIG, folded, batch=1, int8=pack)


def check_fleet_memory(memory: dict, pinned: int, tol: int,
                       old_elsewhere: int) -> None:
    """The image was pinned while a swap or canary held two, and every
    release gave its bytes back, read as requested bytes (the allocated
    count also moves by the allocator's block slack): after the finalize,
    less the old image's copies on the cached meshes other than the live
    one (``old_elsewhere``), which go with it; after the probe's
    rollback, the promotion and the abort, what it was before."""
    def moved(a: str, b: str) -> int:
        return memory[b]["requested"] - memory[a]["requested"]

    bad = []
    if abs(moved("before_swap", "after_finalize") + old_elsewhere) > tol:
        bad.append("after_finalize")
    for a, b in (("before_bad_swap", "after_bad_swap"),
                 ("before_canary", "after_promote"),
                 ("before_bad_canary", "after_abort")):
        if abs(moved(a, b)) > tol:
            bad.append(b)
    for a, b in (("before_swap", "swap_probation"),
                 ("before_canary", "canary")):
        if moved(a, b) < pinned - tol:
            bad.append(f"{b} (the new image not pinned)")
    if bad:
        raise AssertionError(f"slice_fleet memory {bad}: {memory}, old "
                             f"image elsewhere {old_elsewhere}")


def hold_dispatcher(server):
    """Park the dispatcher on a control op until the returned gate is set
    (the control op is the fleet's own flip point)."""
    from repro_torch.serving.server import _Work
    gate, entered = threading.Event(), threading.Event()

    def ctl():
        entered.set()
        gate.wait(60)

    if not server._loop.submit(_Work(frame=None, route=None, control=ctl)) \
            or not entered.wait(30):
        raise AssertionError("the dispatcher never took the hold")
    return gate


def phase_slice_fleet(torch, seed: int, keep: dict, qwen2: dict) -> dict:
    """The fleet and overload control plane on the card: ResNet-18 INT8
    (the ``slice_resnet18_int8`` phase's program, image and requests)
    served by ``InferenceServer(mesh=TileMesh(2))`` under a
    ``FleetController`` (ladder 2, 4, 8; the depth autoscaler parked) and a
    ``BrownoutController``, while 3 paced clients send 96 requests from a
    pool of 8 images and a coordinator, seeded from ``seed``, runs the
    schedule: scale 2 -> 4 -> 8; one group killed and replaced in place
    (the survivors' DMA counters still, the replacement uploading its
    stage's weights); two groups killed and healed; back to the cached
    2-mesh (zero bytes uploaded); a journaled install through a fault at
    every mid-write point on disk (2 rolled back, 1 replayed); 3 DMA
    payloads toward group 1 corrupted and retried; the journal-recovered
    image swapped in, through probation, finalized; an image of weights
    from ``seed + 1`` (calibrated) rolled back by the probe; a canary of
    the good image at 0.25 promoted and one of the bad image at 0.5
    aborted; a group slowed and replaced as a straggler; a redemption hung,
    the group killed by the watchdog and replaced. Then the brown-out
    ladder on the same server: four held backlogs walk rungs 0 -> 4 (a
    priority-2 request shed at rung 3, typed and retryable; the worst
    failing group tripped at rung 4, probed half-open with golden inputs
    and revived with its CRC checked), and cool ticks walk back to 0.
    Every reply, the clients' and the coordinator's, is checked bit for
    bit against a local ``Executor.run`` of the same request. The card's
    requested bytes fall back within 1% of the image's pinned bytes after
    the finalize, the probe's rollback, the promotion and the abort, with
    the traffic held for each reading (``cuda_memory``). Last, qwen2-1.5B (the ``slice`` phase's 3.09 GB
    image) over ``TileMesh(2)`` gets one good swap and ``finalize_swap``,
    memory and each step's seconds printed. Returns the launches."""
    import tempfile
    import numpy as np
    from repro_torch.core import rhal
    from repro_torch.core.fleet import (FleetConfig, FleetController,
                                        same_outputs)
    from repro_torch.serving import chaos
    from repro_torch.serving.overload import (BrownoutController,
                                              OverloadConfig)
    from repro_torch.serving.server import Client, InferenceServer, \
        RequestShed
    t_phase = time.perf_counter()
    big = (1 << 32) - 1
    prog, image = keep["prog"], keep["image"]
    pool = keep["requests"][:4] + keep["burst"][:4]
    plat, ex, bound = local_bound(torch, prog, image)
    refs = [{"output": ex.run(bound, inputs=r)["output"].cpu().numpy()}
            for r in pool]
    plat.rimfs.unpin_all()
    del plat, ex, bound
    _, bad_image = resnet_int8_program(torch, seed + 1)
    work = chaos.Workload(prog, image, bad_image, pool, refs,
                          max_frame=big)
    pinned = RESNET_TENSOR_BYTES[True]
    tol = int(pinned * FLEET_MEMORY_TOL)
    per_run = kernel_launches_of(prog)["int8_matmul"]     # 20 at 224 px
    rng = np.random.RandomState(seed)
    gc.collect()
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t_phase

    server = InferenceServer(mesh=rhal.TileMesh(2), max_queue=256,
                             max_frame=big, watchdog_floor=0.5,
                             watchdog_slack=8.0, watchdog_poll=0.01)
    addr = server.start()
    boot = Client(addr, max_frame=big)
    boot.provision(image, prog.encode())
    boot.close()
    fleet = FleetController(server, FleetConfig(
        ladder=FLEET_LADDER, scale_up_depth=10 ** 6, scale_down_depth=-1,
        straggler_ticks=2, stage_straggler_ratio=FLEET_STRAGGLER_RATIO))
    over = BrownoutController(server, OverloadConfig(
        p99_high=0.05, min_window=2, escalate_ticks=1, recover_ticks=2,
        shed_priority=2, breaker_cooldown_ticks=1))
    coord_client = Client(addr, retries=10, backoff=0.02, max_frame=big)
    coord = {"requests": 0, "mismatches": 0}
    steps: dict = {}
    memory: dict = {}

    def require(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"slice_fleet: {what}")

    def drive() -> None:
        """One more checked request from the coordinator."""
        k = coord["requests"] % len(pool)
        out = coord_client.infer(**pool[k])
        coord["requests"] += 1
        coord["mismatches"] += not same_outputs(out, refs[k])

    def drive_until(pred, what: str, tick: bool = True,
                    limit: int = 400) -> None:
        for _ in range(limit):
            if pred():
                return
            drive()
            if tick:
                fleet.tick()
        require(pred(), f"{what} never came")

    def seen(kind: str) -> int:
        return sum(1 for k, _ in fleet.events if k == kind)

    def held_memory() -> int:
        traffic.pause()
        try:
            return cuda_memory(torch)
        finally:
            traffic.resume()

    def wait_frac(frac: float) -> None:
        deadline = time.monotonic() + 120
        while traffic.completed() < int(traffic.total * frac) \
                and time.monotonic() < deadline:
            fleet.tick()
            time.sleep(0.02)

    def dma_bytes(mesh) -> list:
        return [g.driver.stats.get("dma_bytes", 0) for g in mesh.groups]

    scales = []

    def scale(n: int) -> dict:
        traffic.pause()          # the counters then move for the scale only
        try:
            cached = fleet._mesh_cache.get(n)
            before = sum(dma_bytes(cached)) if cached is not None else 0
            rep = fleet.scale_to(n)
            row = {"from": rep["from"], "to": n,
                   "cached_mesh": rep["cached_mesh"],
                   "seconds": rep["seconds"],
                   **{f"{k}_s": v for k, v in
                      fleet.timings["scale"].items()},
                   "h2d_bytes": sum(dma_bytes(server.mesh)) - before,
                   "pinned_bytes_by_cached_mesh": fleet.pinned_bytes(),
                   "memory": cuda_memory(torch)}
        finally:
            traffic.resume()
        scales.append(row)
        return row

    zero_launches()                          # the main path starts here
    traffic = chaos.Traffic(addr, work, FLEET_REQUESTS, FLEET_CLIENTS, seed,
                            pace_s=FLEET_PACE_S).start()
    t_sched = time.perf_counter()
    try:
        # 1. scale up the ladder
        wait_frac(0.04)
        row = scale(4)
        require(row["h2d_bytes"] == pinned, f"2 -> 4 uploaded {row}")
        wait_frac(0.08)
        scale(8)
        # 2. one group lost: replaced in place
        wait_frac(0.12)
        kill_gid = int(rng.randint(1, 8))
        t = time.perf_counter()
        server.mesh.kill(kill_gid)           # in-flight stages fail over
        traffic.pause()
        try:
            mesh = server.mesh
            before = {g: mesh.group(g).driver.stats.get("dma_bytes", 0)
                      for g in mesh.gids if g != kill_gid}
            rep = fleet.tick()
            require(rep["action"] == ("replace", kill_gid, "dead")
                    and "error" not in rep, f"kill: {rep['action']}")
            moved = {g: mesh.group(g).driver.stats.get("dma_bytes", 0) - b
                     for g, b in before.items()}
            tile = server._bound._partitions[8].tiles[kill_gid]
            stage_bytes = sum(server.platform.rimfs.stat(s)["nbytes"]
                              for s in tile.weight_syms)
            fresh = mesh.group(kill_gid).driver.stats["dma_bytes"]
            steps["replace"] = {
                "group": kill_gid, "kill_to_repair_s":
                    time.perf_counter() - t,
                **{f"{k}_s": v for k, v in
                   fleet.timings["reshape"].items()},
                "survivor_bytes_moved": moved,
                "replacement_h2d_bytes": fresh,
                "stage_weight_bytes": stage_bytes}
            require(not any(moved.values()) and fresh == stage_bytes,
                    f"partial reshape moved {steps['replace']}")
        finally:
            traffic.resume()
        # 3. two groups lost: a full heal
        wait_frac(0.20)
        dead = sorted(int(g) for g in rng.choice(np.arange(1, 8), 2,
                                                 replace=False))
        t = time.perf_counter()
        for g in dead:
            server.mesh.kill(g)
        for _ in range(200):
            fleet.tick()
            if seen("heal_complete"):
                break
            time.sleep(0.01)
        require(seen("heal_complete") == 1, "two dead groups never healed")
        steps["heal"] = {"groups": dead,
                         "kill_to_heal_s": time.perf_counter() - t,
                         **{f"{k}_s": v for k, v in
                            fleet.timings["heal"].items()}}
        # back to 2 groups: the original mesh, cached, nothing uploaded
        wait_frac(0.26)
        row = scale(2)
        require(row["cached_mesh"] and row["h2d_bytes"] == 0,
                f"8 -> 2: {row}")
        # 4. a journaled install through a fault at each mid-write point
        with tempfile.TemporaryDirectory() as tmp:
            t = time.perf_counter()
            journal, recovered = chaos.journal_fault_matrix(
                image, Path(tmp) / "resnet18_int8.rimfs")
            journal["seconds"] = time.perf_counter() - t
        require((journal["rolled_back"], journal["replayed"],
                 journal["image_ok"]) == (2, 1, True)
                and recovered == image, f"journal {journal}")
        # 5. DMA payloads toward group 1 corrupted, retried in place
        wait_frac(0.30)
        drv = server.mesh.group(1).driver
        keys = ("dma_crc_mismatch", "dma_retry", "dma_retry_recovered")
        before = {k: drv.stats.get(k, 0) for k in keys}
        undo, cstate = chaos.corrupt_dma_payload(server.mesh, 1, 3)
        try:
            drive_until(lambda: cstate["corrupted"] >= 3,
                        "3 corrupted payloads", tick=False)
        finally:
            undo()
        steps["dma_corruption"] = {k: drv.stats.get(k, 0) - before[k]
                                   for k in keys}
        require(steps["dma_corruption"]["dma_retry_recovered"] >= 3,
                f"corruption {steps['dma_corruption']}")
        # 6. good swap: the journal-recovered image through probation
        wait_frac(0.36)
        traffic.pause()
        memory["before_swap"] = cuda_memory(torch)
        # the old image's copies on the cached meshes other than the live
        # one go with it at the finalize (the new image is pinned on the
        # live mesh only)
        old_elsewhere = sum(
            v for k, v in fleet.pinned_bytes().items()
            if k != server.mesh.n_groups)
        t = time.perf_counter()
        good = fleet.swap_weights(recovered, label="journal-recovered")
        steps["swap_good"] = {"result": good,
                              "seconds": time.perf_counter() - t,
                              **{f"{k}_s": v for k, v in
                                 fleet.timings["swap"].items()}}
        memory["swap_probation"] = cuda_memory(torch)
        traffic.resume()
        require(good == "committed", f"good swap {good}")
        drive_until(lambda: not fleet.summary()["swap_in_probation"],
                    "the swap's finalize")
        memory["after_finalize"] = held_memory()
        # 7. bad swap: weights from seed + 1, caught by the probe
        traffic.pause()
        memory["before_bad_swap"] = cuda_memory(torch)
        t = time.perf_counter()
        bad = fleet.swap_weights(bad_image, label="seed+1")
        steps["swap_bad"] = {"result": bad,
                             "seconds": time.perf_counter() - t,
                             **{f"{k}_s": v for k, v in
                                fleet.timings["swap"].items()}}
        memory["after_bad_swap"] = cuda_memory(torch)
        traffic.resume()
        probed = [p["ok"] for k, p in fleet.events if k == "swap_probed"]
        require(bad == "rolled_back" and probed == [True, False],
                f"bad swap {bad}, probes {probed}")
        # 8. canaries: the good image at 0.25 promotes ...
        wait_frac(0.45)
        memory["before_canary"] = held_memory()
        t = time.perf_counter()
        require(fleet.canary(recovered, fraction=0.25, label="good")
                == "started", "the good canary did not start")
        state = fleet._canary
        memory["canary"] = held_memory()
        # launches of one plain and one dual-run (sampled) request
        traffic.pause()
        per_request = {}
        counter = kernel_counters()["int8_matmul"]
        one = Client(addr, max_frame=big)
        try:
            for rid in range(1, 64):
                kind = "sampled" if state.routes(rid) and \
                    state.samples(rid) else "plain"
                n0 = counter.launches
                out = one.infer(**pool[rid % len(pool)])
                coord["mismatches"] += not same_outputs(
                    out, refs[rid % len(pool)])
                per_request.setdefault(kind, counter.launches - n0)
                if len(per_request) == 2:
                    break
        finally:
            one.close()
            traffic.resume()
        require(per_request == {"plain": per_run, "sampled": 2 * per_run},
                f"int8_matmul launches a request {per_request}")
        drive_until(lambda: state.sprt.verdict() is not None,
                    "the good canary's verdict", tick=False)
        traffic.pause()
        fleet.tick()                         # the verdict acts
        memory["after_promote"] = cuda_memory(torch)
        traffic.resume()
        promoted = [p for k, p in fleet.events if k == "canary_promoted"]
        require(len(promoted) == 1, f"good canary: {state.sprt.summary()}")
        steps["canary_good"] = {"seconds": time.perf_counter() - t,
                                **promoted[0],
                                **{f"{k}_s": v for k, v in
                                   fleet.timings["canary"].items()}}
        # ... and the bad image at 0.5 aborts, serving none of its bytes
        memory["before_bad_canary"] = held_memory()
        t = time.perf_counter()
        require(fleet.canary(bad_image, fraction=0.5, label="bad")
                == "started", "the bad canary did not start")
        state = fleet._canary
        drive_until(lambda: state.sprt.verdict() is not None,
                    "the bad canary's verdict", tick=False)
        traffic.pause()
        fleet.tick()
        memory["after_abort"] = cuda_memory(torch)
        traffic.resume()
        aborted = [p for k, p in fleet.events if k == "canary_aborted"]
        require(len(aborted) == 1
                and aborted[0]["stats"]["served_shadow"] == 0,
                f"bad canary: {state.sprt.summary()} {state.stats}")
        steps["canary_bad"] = {"seconds": time.perf_counter() - t,
                               **aborted[0]}
        # 9. a hung redemption (before the straggler, whose stalls would
        # widen the watchdog's budget): the watchdog kills group 1, failover
        wait_frac(0.60)
        undo, hstate = chaos.hang_until_killed(server.mesh, 1)
        probe: dict = {}
        pt = threading.Thread(target=lambda: probe.update(
            error=chaos.check_probe(addr, work, 0, seed)), daemon=True)
        t = time.perf_counter()
        pt.start()
        try:
            deadline = time.monotonic() + 60
            while not hstate["released"] and time.monotonic() < deadline:
                fleet.tick()
                time.sleep(0.01)
        finally:
            undo()
        pt.join(timeout=60)
        hang_s = time.perf_counter() - t
        for _ in range(100):
            if all(server.mesh.alive(g) for g in server.mesh.gids):
                break
            fleet.tick()
            time.sleep(0.01)
        require(hstate["released"] and "error" in probe
                and probe["error"] is None
                and all(server.mesh.alive(g) for g in server.mesh.gids),
                f"hang {hstate}, probe {probe}")
        steps["hang"] = {"hang_to_answer_s": hang_s,
                         "preemptions": server.platform.telemetry.counter(
                             "watchdog_preemptions")}
        # 10. a straggler: group 1's redemption slowed, replaced in place
        wait_frac(0.70)
        n0 = seen("reshape_complete")
        t = time.perf_counter()
        undo = chaos.slow_group_redeem(server.mesh, 1, FLEET_SLOW_S)
        try:
            drive_until(lambda: seen("reshape_complete") > n0,
                        "the straggler's replacement")
        finally:
            undo()
        last = [p for k, p in fleet.events if k == "reshape_complete"][-1]
        require(last["group"] == 1 and last["reason"] == "straggler",
                f"straggler: {last}")
        steps["straggler"] = {"slow_to_reshape_s": time.perf_counter() - t,
                              "stall_s": FLEET_SLOW_S, **last}
        traffic.join()
        schedule_s = time.perf_counter() - t_sched

        # the brown-out ladder: held backlogs walk rungs 0 -> 4
        t = time.perf_counter()
        brown = Client(addr, max_frame=big)
        try:
            walk, shed = [over.rung], None
            while over.rung < 4:
                gate = hold_dispatcher(server)
                try:
                    rids = [brown.infer_async(priority=0, **pool[i])
                            for i in range(4)]
                    deadline = time.monotonic() + 30
                    while server.scheduler.pending() < 4:
                        require(time.monotonic() < deadline,
                                "the backlog never queued")
                        time.sleep(0.002)
                    time.sleep(0.1)          # the backlog's queue wait
                finally:
                    gate.set()
                for i, rid in enumerate(rids):
                    coord["mismatches"] += not same_outputs(
                        brown.result(rid, timeout=60), refs[i])
                over.tick()
                walk.append(over.rung)
                require(walk[-1] == walk[-2] + 1 and len(walk) <= 5,
                        f"rung walk {walk}")
                if over.rung == 3:
                    try:
                        brown.infer(priority=2, **pool[0])
                    except RequestShed as e:
                        shed = {"kind": e.kind, "retryable": e.retryable,
                                "retry_after_ms": e.retry_after_ms}
                    require(shed is not None and shed["kind"] == "brownout"
                            and shed["retryable"], f"rung 3 shed {shed}")
            rung4 = [p for k, p in over.events if k == "brownout_rung"][-1]
            require(rung4["tripped"] is not None
                    and over.breaker.state == "open",
                    f"rung 4 tripped nothing: {rung4}")
            out = brown.infer(priority=0, **pool[1])   # the survivors serve
            coord["mismatches"] += not same_outputs(out, refs[1])
            for _ in range(200):                       # cool ticks
                over.tick()
                walk.append(over.rung)
                if over.rung == 0 and over.breaker.state == "closed":
                    break
                time.sleep(0.01)
            require(over.rung == 0 and over.breaker.state == "closed"
                    and over.breaker.stats == {"trips": 1, "probes": 1,
                                               "closes": 1},
                    f"recovery: {over.summary()}")
            out = brown.infer(priority=2, **pool[2])   # served again
            coord["mismatches"] += not same_outputs(out, refs[2])
        finally:
            brown.close()
        brownout = {"seconds": time.perf_counter() - t,
                    "rung_walk": [r for i, r in enumerate(walk)
                                  if i == 0 or r != walk[i - 1]],
                    "ticks": len(walk) - 1, "rung3_shed": shed,
                    "tripped_group": rung4["tripped"],
                    "breaker": dict(over.breaker.stats)}
        launches = launches_now()
        coord_client.close()
    finally:
        fleet.stop()
        over.stop()
        server.stop()
    traffic_report = traffic.report()
    fields = dict(
        client_failures=traffic_report["failed"],
        mismatches=traffic_report["mismatches"] + coord["mismatches"],
        client_p50_s=traffic_report["p50_s"],
        client_p99_s=traffic_report["p99_s"],
        coordinator_requests=coord["requests"],
        events=run_lengths([k for k, _ in fleet.events]),
        brownout_events=run_lengths([k for k, _ in over.events]),
        scales=scales, steps=steps, journal=journal, brownout=brownout,
        int8_matmul_launches_per_request=per_request,
        launches=launches, image_pinned_bytes=pinned,
        memory=memory, old_image_elsewhere_bytes=old_elsewhere,
        memory_tolerance_bytes=tol,
        setup_s=setup_s, schedule_s=schedule_s)
    print(json.dumps({"slice_fleet_checked": fields}), file=sys.stderr)
    require(traffic_report["failed"] == 0
            and traffic_report["mismatches"] == 0
            and traffic_report["ok"] == traffic_report["sent"]
            == FLEET_REQUESTS and coord["mismatches"] == 0,
            f"traffic {traffic_report}, coordinator {coord}")
    check_fleet_memory(memory, pinned, tol, old_elsewhere)
    # 20 an execution; a stage killed mid-run re-runs on a survivor, so the
    # total only has a floor
    n = launches["int8_matmul"]
    require(n >= per_run * FLEET_REQUESTS, f"int8_matmul launched {n}")
    qwen2_swap = fleet_qwen2_swap(torch, qwen2)
    emit("slice_fleet", model="resnet18-int8", image_size=224, groups=2,
         ladder=list(FLEET_LADDER), clients=FLEET_CLIENTS,
         requests=FLEET_REQUESTS, pool=len(pool), seed=seed, **fields,
         qwen2_swap=qwen2_swap, seconds=time.perf_counter() - t_phase)
    return {"resnet18-int8-fleet": launches,
            "qwen2-1.5b-fleet-swap": qwen2_swap["launches"]}


def fleet_qwen2_swap(torch, keep: dict) -> dict:
    """qwen2-1.5B (28 bf16 layers, the ``slice`` phase's program, image and
    requests) provisioned over protocol v2 into
    ``InferenceServer(mesh=TileMesh(2))``, then one good ``swap_weights`` of
    the same image: mounted and CRC-checked, bound, probed on a driver of
    its own against the live mesh's answer to the golden inputs (bf16
    hidden states, int32 positions), prewarmed into the mesh beside the old
    image, flipped; two requests served in probation, bit for bit against
    the same request before the swap; ``finalize_swap``. Memory before, in
    probation and after (requested bytes within 1% of the pinned image)."""
    from repro_torch.core import rhal, rimfs
    from repro_torch.core.fleet import FleetConfig, FleetController
    from repro_torch.serving.server import Client, InferenceServer
    prog, image, requests = keep["prog"], keep["image"], keep["requests"]
    big = (1 << 32) - 1
    pinned = sum(e["nbytes"] for e in rimfs.mount(image)._index.values())
    server = InferenceServer(mesh=rhal.TileMesh(2), max_frame=big)
    client = Client(server.start(), max_frame=big)
    out: dict = {"image_bytes": len(image), "image_pinned_bytes": pinned}
    try:
        t = time.perf_counter()
        client.provision(image, prog.encode())
        out["provision_s"] = time.perf_counter() - t
        want = client.infer(**requests[0])["logits"]
        fleet = FleetController(server, FleetConfig(
            probation_requests=QWEN2_PROBATION, probation_ticks=1,
            stage_straggler_ratio=1e9))
        memory = {"before": cuda_memory(torch)}
        per_run = kernel_launches_of(prog)["flash_attention"]    # 28
        zero_launches()
        t = time.perf_counter()
        result = fleet.swap_weights(image, label="qwen2-good")
        out["swap_s"] = time.perf_counter() - t
        out["swap_steps_s"] = dict(fleet.timings["swap"])
        memory["probation"] = cuda_memory(torch)
        same = [same_bits(client.infer(**requests[0])["logits"], want)
                for _ in range(QWEN2_PROBATION)]
        fleet.tick()
        t = time.perf_counter()
        fleet.finalize_swap()            # a no-op once the tick finalized
        memory["after_finalize"] = cuda_memory(torch)
        out["launches"] = launches_now()
        fin = [p for k, p in fleet.events if k == "swap_finalized"]
        client.shutdown()
    finally:
        client.close()
        server.stop()
    tol = int(pinned * FLEET_MEMORY_TOL)
    if not (result == "committed" and all(same) and len(fin) == 1
            and fin[0]["freed_bytes"] == pinned
            and memory["probation"]["requested"]
            - memory["before"]["requested"] >= pinned - tol
            and abs(memory["after_finalize"]["requested"]
                    - memory["before"]["requested"]) <= tol
            and out["launches"]["flash_attention"]
            == per_run * (2 + QWEN2_PROBATION)):
        raise AssertionError(f"slice_fleet qwen2 swap: {result}, same "
                             f"{same}, finalized {fin}, memory {memory}, "
                             f"launches {out['launches']}")
    out.update(result=result, memory=memory,
               events=[k for k, _ in fleet.events],
               probation_requests_bit_identical=same)
    return out


def phase_slice_fleet_lm(torch, seed: int, keep: dict) -> dict:
    """The brown-out ladder's LM rungs on qwen2-1.5B at full width and
    depth (bf16): a ``ServingEngine`` over the ``slice_engine`` phase's
    pinned image (zero bytes moved) behind an ``InferenceServer`` and a
    ``BrownoutController`` (clamp 8). At rung 2 a ``max_new=32`` request of
    the first prompt returns the prefill's token and 8 decoded ones, equal
    to the first 9 of the stream ``slice_engine`` served unclamped, with 28
    ``flash_attention`` launches (one prefill); at rung 3 a priority-2
    admission is shed, typed ``brownout`` and retryable, with no launch;
    back at rung 0 the unclamped stream is served whole."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.overload import (BrownoutController,
                                              OverloadConfig)
    from repro_torch.serving.server import Client, InferenceServer, \
        RequestShed
    cfg = get_config(ENGINE_MODELS["slice_engine"])
    prompts = engine_prompts(seed, cfg.vocab_size)
    full = keep["tokens"][0]
    driver = keep["driver"]
    before = driver.stats.get("dma_bytes", 0)
    eng = ServingEngine.from_rimfs(cfg, keep["fs"], driver=driver,
                                   max_batch=ENGINE_SLOTS,
                                   max_seq=ENGINE_MAX_SEQ)
    server = InferenceServer(engine=eng)
    client = Client(server.start())
    over = BrownoutController(server, OverloadConfig(max_new_clamp=8,
                                                     shed_priority=2))
    try:
        zero_launches()
        over.set_rung(2, reason="clamp")
        t = time.perf_counter()
        clamped = client.infer(prompt=prompts[0],
                               max_new=ENGINE_MAX_NEW)["tokens"].tolist()
        clamped_s = time.perf_counter() - t
        rung2 = launches_now()
        over.set_rung(3, reason="shed")
        shed = None
        try:
            client.infer(prompt=prompts[1], max_new=ENGINE_MAX_NEW,
                         priority=2)
        except RequestShed as e:
            shed = {"kind": e.kind, "retryable": e.retryable,
                    "retry_after_ms": e.retry_after_ms}
        rung3 = launches_now()
        over.set_rung(0, reason="recovered")
        again = client.infer(prompt=prompts[0],
                             max_new=ENGINE_MAX_NEW)["tokens"].tolist()
        launches = launches_now()
        client.shutdown()
    finally:
        client.close()
        server.stop()
    moved = driver.stats.get("dma_bytes", 0) - before
    if not (clamped == full[:9] and again == full
            and rung2["flash_attention"] == cfg.num_layers
            and rung3 == rung2 and shed is not None
            and shed["kind"] == "brownout" and shed["retryable"]
            and moved == 0):
        raise AssertionError(f"slice_fleet_lm: clamped {clamped} vs "
                             f"{full[:9]}, again equal {again == full}, "
                             f"launches {rung2} {rung3}, shed {shed}, "
                             f"moved {moved}")
    emit("slice_fleet_lm", model=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, max_new=ENGINE_MAX_NEW, clamp=8,
         clamped_tokens=len(clamped), clamped_equal_prefix=True,
         clamped_request_s=clamped_s, rung2_launches=rung2,
         rung3_shed=shed, unclamped_equal=True, launches=launches,
         events=[k for k, _ in over.events], bytes_moved=moved)
    del eng
    return {"qwen2-1.5b-engine-rungs": launches}


# the LM serving engine: 4 slots of 640 rows; six prompts, the first four
# fill the slots (each prefilled alone), the last two wait
ENGINE_PROMPTS = (512, 512, 256, 256, 100, 37)
ENGINE_MAX_NEW = 32
ENGINE_SLOTS, ENGINE_MAX_SEQ = 4, 640
ENGINE_TOL = TOLERANCE["bfloat16"]           # of max |logit|, as bf16 is held
# the served engine phases, each at full width and depth
PAGED_BLOCK = 16                # the paged engine's rows a KV block
ENGINE_MODELS = {"slice_engine": "qwen2-1.5b",
                 "slice_engine_hybrid": "hymba-1.5b",
                 "slice_engine_ssm": "rwkv6-1.6b",
                 "slice_engine_moe": "moonshot-v1-16b-a3b"}
# the moe family: moonshot-v1-16b-a3b, 56.1 GB of bf16 weights; its engine
# phase needs them plus the KV cache and the decode graph on the card
MOE_MODEL = "moonshot-v1-16b-a3b"
MOE_MIN_FREE_BYTES = 62e9
# hymba's ring at full width: 1280 rows keep a ring of W = 1024 rows; a
# prompt of 1100 tokens prefills on the windowed route (S > W, not a
# multiple of W) and one of 1000 on flash_attention, its decode crossing W
RING_MAX_SEQ = 1280
RING_PROMPTS = (1100, 1000)


def instrument_engine(torch, eng, keep: bool = False) -> list:
    """Record every prefill and decode step of ``eng`` (dense or paged) as
    it runs: the step, its (B, S) input (a paged decode window: [bucket,
    window], with its batch kept), each hand kernel's launches in it
    and its host wall to a sync; with ``keep``, also the prefill's tokens
    and last-position logits. The engine's own code is not changed: its
    step functions are wrapped."""
    counters = kernel_counters()
    log: list = []

    def wrap(kind, fn):
        def step(*args):
            batch = next(a for a in reversed(args) if isinstance(a, dict))
            n0 = {name: w.launches for name, w in counters.items()}
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            entry = {"step": kind,
                     "launches": {name: w.launches - n0[name]
                                  for name, w in counters.items()},
                     "wall_s": time.perf_counter() - t0}
            if "inputs" in batch:
                entry["shape"] = list(batch["inputs"].shape)
            else:                    # a paged window: (bucket, w)
                entry["shape"] = [batch["tokens"].shape[0], args[-1]]
                entry["batch"] = {k: v.clone() for k, v in batch.items()}
            if keep and kind == "prefill":
                entry.update(tokens=batch["inputs"].clone(),
                             logits=out[0].clone())
            log.append(entry)
            return out
        return step

    eng._prefill = wrap("prefill", eng._prefill)
    eng._decode = wrap("decode", eng._decode)
    return log


def prefill_launches(cfg, seq: int) -> dict:
    """Each hand kernel's launches in one prefill of ``seq`` tokens: one a
    layer of ``flash_attention`` where the model attends and its window
    masks nothing (S <= W), of ``ssm_scan`` in the hybrid family and of
    ``wkv6`` in the ssm family; none of any other."""
    layers = cfg.num_layers
    attends = cfg.family != "ssm" and (cfg.attention != "sliding"
                                       or seq <= cfg.sliding_window)
    return {name: 0 for name in kernel_counters()} | {
        "flash_attention": layers if attends else 0,
        "ssm_scan": layers if cfg.family == "hybrid" else 0,
        "wkv6": layers if cfg.family == "ssm" else 0}


def decode_launches(cfg, steps: int) -> dict:
    """Each hand kernel's launches in ``steps`` decode steps: one
    ``decode_attention`` a layer a step where the model attends; none of
    any other."""
    return {name: 0 for name in kernel_counters()} | {
        "decode_attention": cfg.num_layers * steps
        if cfg.family != "ssm" else 0}


def dispatch_launches(e: dict, cfg) -> dict:
    """What one logged dispatch launches: a prefill ``prefill_launches``,
    a decode step (a paged window: its steps) ``decode_launches``."""
    if e["step"] == "prefill":
        return prefill_launches(cfg, e["shape"][1])
    return decode_launches(cfg, e["shape"][1] if "batch" in e else 1)


def logged_launches(log: list, cfg) -> dict:
    """``dispatch_launches`` summed over a log's dispatches."""
    want = dict.fromkeys(kernel_counters(), 0)
    for e in log:
        for name, n in dispatch_launches(e, cfg).items():
            want[name] += n
    return want


def engine_launch_check(log: list, cfg, what: str) -> None:
    """Each logged dispatch launches ``dispatch_launches``."""
    for e in log:
        want = dispatch_launches(e, cfg)
        if e["launches"] != want:
            raise AssertionError(f"{what}: a {e['step']} of {e['shape']} "
                                 f"launched {e['launches']}, not {want}")


def prefill_groups(log: list) -> list:
    return [e["shape"] for e in log if e["step"] == "prefill"]


def greedy_recompute(torch, cfg, params, prompt, served: list) -> dict:
    """Each served token against ``forward_full`` over the prompt and the
    served tokens before it (the offline recompute of
    tests/test_serving.py:266, fed the served prefix): the token must be
    the recompute's argmax, or a near tie, whose logit lies within
    ``tie`` of the largest (the decode path's rounding may rightly pick
    either there): in fp32 twice the program tolerance PROGRAM_ATOL, in
    bf16 ENGINE_TOL of the largest |logit|. Returns the near ties, the
    first token that is neither (None when none) and how many tokens were
    checked (up to that one)."""
    from repro_torch.models import transformer as tf
    seq = torch.as_tensor(prompt, device="cuda").long()
    ties = []
    for t, tok in enumerate(served):
        logits = tf.forward_full(cfg, params, seq[None])[0][0, -1].float()
        tie = (2 * PROGRAM_ATOL if cfg.dtype == "float32"
               else ENGINE_TOL * logits.abs().max().item())
        best = int(torch.argmax(logits))
        if best != tok:
            gap = (logits[best] - logits[tok]).item()
            if gap > tie:
                return {"mismatch_at": t, "near_ties": ties, "checked": t,
                        "served": tok, "recompute": best, "gap": gap}
            ties.append(t)
        seq = torch.cat([seq, seq.new_tensor([tok])])
    return {"mismatch_at": None, "near_ties": ties, "checked": len(served)}


def prefill_logits_vs_plain(torch, cfg, params, log: list) -> list:
    """Each kept prefill's last-position logits (the engine's, on the
    kernels) against ``forward_full`` on the same tokens with every
    kernel's plain version (``impl="ref"``)."""
    from repro_torch.models import transformer as tf
    out = []
    for e in (e for e in log if e["step"] == "prefill"):
        plain = tf.forward_full(cfg, params, e["tokens"],
                                impl="ref")[0][:, -1].float()
        got = e["logits"].float()
        out.append({"shape": e["shape"],
                    "finite": bool(torch.isfinite(got).all()),
                    "max_abs_err": (got - plain).abs().max().item(),
                    "max_abs_logit": plain.abs().max().item()})
    return out


def kernels_in_model(torch, fn) -> list:
    """Run ``fn`` with every hand-kernel call of the model's forward checked
    in place: the kernel's output against its plain version on the very
    same operands (the kernel's output goes on). ``flash_attention`` holds
    if max |err| is within ENGINE_TOL of max |plain| (bf16 at depth, as
    ``slice_engine`` holds it); ``ssm_scan`` and ``wkv6``
    at atol = rtol = their tests/test_kernels.py tolerance for the
    operands' dtype. Returns, per call, the kernel, its first operand's
    shape, max |err|, max |plain| and whether it held."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention.ref import attention_ref_bshd
    from repro_torch.models import attention as attn_mod
    checks = []

    def record(name, first, out, ref):
        out, ref = out.float(), ref.float()
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        if name == "flash_attention":
            ok = err <= ENGINE_TOL * scale
        else:
            tol = (SSM_TOLERANCE if name == "ssm_scan" else WKV_TOLERANCE)[
                str(first.dtype).removeprefix("torch.")]
            ok = bool(torch.allclose(out, ref, atol=tol, rtol=tol))
        checks.append({"kernel": name, "shape": list(first.shape),
                       "max_abs_err": err, "max_abs_plain": scale,
                       "rel_err": err / scale if scale else 0.0,
                       "ok": ok and bool(torch.isfinite(out).all())})

    specs = registry.REGISTRY.specs
    kernel, saved = attn_mod.flash_attention, dict(specs)

    def attention(q, k, v, causal=True):
        o = kernel(q, k, v, causal=causal)
        record("flash_attention", q, o,
               attention_ref_bshd(q, k, v, causal=causal))
        return o

    def checked(spec):
        def call(*args, plan=None, **kw):
            o = spec.kernel(*args, plan=plan, **kw)
            record(spec.name, args[0], o, spec.ref(*args, **kw))
            return o
        return dataclasses.replace(spec, kernel=call)

    attn_mod.flash_attention = attention
    for name in ("ssm_scan", "wkv6"):
        specs[name] = checked(saved[name])
    try:
        fn()
    finally:
        attn_mod.flash_attention = kernel
        specs.update(saved)
    return checks


def kernel_check_summary(checks: list) -> dict:
    """Per kernel: its calls, the worst max |err| and max |err| over max
    |plain|, and how many held."""
    out: dict = {}
    for c in checks:
        s = out.setdefault(c["kernel"], {"calls": 0, "held": 0,
                                         "worst_max_abs_err": 0.0,
                                         "worst_rel_err": 0.0})
        s["calls"] += 1
        s["held"] += c["ok"]
        s["worst_max_abs_err"] = max(s["worst_max_abs_err"],
                                     c["max_abs_err"])
        s["worst_rel_err"] = max(s["worst_rel_err"], c["rel_err"])
    return out


def phase_engine_reduced_depth(torch, seed: int, model: str, prompts: list,
                               layers: int, dtype: str, gate_recompute: bool,
                               max_seq: int = ENGINE_MAX_SEQ,
                               capacity: float = None) -> None:
    """Phase 7a: a local engine at ``model``'s full width cut to ``layers``
    layers in ``dtype``, over ``prompts`` with ENGINE_SLOTS slots of
    ``max_seq`` rows. Gates: each prefill's hand-kernel launches; each
    prefill's last-position logits on the kernels within ENGINE_TOL of the
    largest |logit| of the same forward on the plain versions; with
    ``gate_recompute``, each greedy stream equal to the offline recompute
    up to its first near tie (otherwise the comparison is only printed).
    The random-weight model is chaotic in depth (``phase_slice_engine``'s
    docstring says why): in bf16 a second layer already lets the decode
    path's roundings move a token past the tolerance, so the recompute is
    gated on one fp32 layer. With a sliding window, each prompt whose
    decode passes W must have its recompute checked past the step that
    first writes a key over the ring's oldest (``ring_wrap_checked``,
    gated with the recompute). ``capacity`` sets an MoE config's capacity
    factor: the recompute holds only where no token is dropped (a prompt's
    last token, routed in one group with the whole prompt, can be; alone
    in a decode step it never is), so the moe line runs dropless, as the
    smoke configs do."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = dataclasses.replace(get_config(model), num_layers=layers,
                              dtype=dtype)
    if capacity is not None:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=capacity)
    eng = ServingEngine(cfg, tf.init_params(cfg, seed),
                        max_batch=ENGINE_SLOTS, max_seq=max_seq)
    log = instrument_engine(torch, eng, keep=True)
    reqs = [Request(rid=i, prompt=p, max_new=ENGINE_MAX_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    what = f"{model} {layers}-layer {dtype} engine"
    engine_launch_check(log, cfg, what)
    logits = prefill_logits_vs_plain(torch, cfg, eng.params, log)
    for c in logits:
        if not (c["finite"]
                and c["max_abs_err"] <= ENGINE_TOL * c["max_abs_logit"]):
            raise AssertionError(f"{what}: prefill {c} beyond {ENGINE_TOL} "
                                 f"of max |logit|")
    recompute = [greedy_recompute(torch, cfg, eng.params, p, r.out_tokens)
                 for p, r in zip(prompts, reqs)]
    for i, rc in enumerate(recompute):
        if gate_recompute and rc["mismatch_at"] is not None:
            raise AssertionError(f"{what}: request {i} {rc}")
    ring = {}
    if cfg.attention == "sliding":
        # out_tokens[j] comes from the decode step at position len + j - 1,
        # which writes its key over the ring's oldest once that is >= W
        W = cfg.sliding_window
        wrapped = {i: max(1, W - len(p) + 1) for i, p in enumerate(prompts)
                   if len(p) + ENGINE_MAX_NEW - 1 >= W}
        checked = {i: recompute[i]["checked"] - j for i, j in wrapped.items()}
        ring = {"ring_rows": eng._cache["k"].shape[2],
                "windowed_prefills": [len(p) for p in prompts if len(p) > W],
                "ring_wrap_checked": {len(prompts[i]): n
                                      for i, n in checked.items()}}
        if gate_recompute and not (checked and all(
                n > 0 for n in checked.values())):
            raise AssertionError(f"{what}: no token checked past the ring's "
                                 f"wrap: {ring}")
    emit("engine_reduced_depth", model=cfg.name, layers=layers,
         dtype=dtype, max_seq=max_seq, prompts=[len(p) for p in prompts],
         moe_capacity_factor=capacity,
         prefill_groups=prefill_groups(log),
         prefill_launches=[e["launches"] for e in log
                           if e["step"] == "prefill"],
         prefill_logits=logits, logits_tol=ENGINE_TOL,
         recompute_gated=gate_recompute, recompute=recompute, **ring)
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def engine_prompts(seed: int, vocab: int, lengths=ENGINE_PROMPTS) -> list:
    import numpy as np
    rng = np.random.RandomState(seed + 3)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lengths]


def engine_burst(server, client, eng, prompts: list, log: list, what: str,
                 held: bool = True) -> dict:
    """Send ``prompts`` to ``server``'s engine through ``client``, each
    asking ENGINE_MAX_NEW new tokens; with ``held`` the dispatcher steps
    nothing until all are queued. Returns the replies' tokens, each
    request's wall from its send, the burst's seconds from the release and
    the entries the burst added to ``log`` (``instrument_engine``'s)."""
    idle = server._loop.on_idle
    gate = threading.Event()
    if held:                             # step nothing until all are queued
        server.run_on_dispatcher(lambda: setattr(
            server._loop, "on_idle",
            lambda: idle() if gate.is_set() else False))
    first = len(log)
    sent = [(client.infer_async(prompt=p, max_new=ENGINE_MAX_NEW),
             time.perf_counter()) for p in prompts]
    deadline = time.monotonic() + 120
    while held and eng.pending() < len(prompts):
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: {eng.pending()} of {len(prompts)} "
                                 f"prompts queued")
        time.sleep(0.005)
    t_release = time.perf_counter()
    gate.set()
    tokens, walls = [], []
    for rid, ts in sent:
        tokens.append(client.result(rid, timeout=600)["tokens"])
        walls.append(time.perf_counter() - ts)
    burst_s = time.perf_counter() - t_release
    server._loop.on_idle = idle
    return {"tokens": tokens, "walls": walls, "burst_s": burst_s,
            "log": log[first:]}


def phase_slice_engine(torch, seed: int, phase: str,
                       keep: dict = None) -> dict:
    """Phase 7b: the LM serving engine. ``ENGINE_MODELS[phase]`` (qwen2-1.5B,
    hymba-1.5B or rwkv6-1.6B) at full width and depth (bf16, random weights
    from ``seed``) packed into a RIMFS image, pinned on the card by
    ``ServingEngine.from_rimfs`` (its decode step captured as one CUDA
    graph) and served by the port's InferenceServer: six greedy prompts,
    sent while the engine is held until all six are queued, answered with
    tokens through continuous batching, each prompt prefilled alone.
    Gates: the served tokens equal those of a local engine on the card
    whose decode step is the eager one, fed the same prefills, bit for
    bit; one replay at 4 live slots equals the eager step from a copy of
    the same cache (logits and every cache tensor, KV rows and recurrent
    states, bit for bit); the six streams are the same held, unheld and
    with each prompt admitted alone; every hand-kernel call of every
    prefill agrees with its plain version on the same operands
    (``kernels_in_model``); each prefill dispatch launches one
    ``flash_attention`` a layer where the model attends (28 qwen2, 32
    hymba), one ``ssm_scan`` a layer in hymba (32), one ``wkv6`` a layer
    in rwkv6 (24), and each decode step one ``decode_attention`` a layer
    where the model attends (none in rwkv6).

    Reported, not gated: each group's last-position logits against the
    same forward on the plain kernels, each stream against a greedy
    recompute, and the plain bf16 forward against its fp32 one. The JAX
    package's init draws wq, wk and wv with std 1/sqrt(heads) (fan-in is
    the heads axis), so q.k reaches hundreds and each softmax is nearly
    one-hot: a bf16 rounding anywhere moves which key wins in some rows,
    and after a few layers any two bf16 orders of arithmetic give
    unrelated logits (``phase_engine_reduced_depth`` holds them at 1 and
    2 layers). Then where a decode step's time goes, replayed and eager,
    and a prefill's. Returns the launches of the held run, the main
    path's. With ``keep``, leaves in it the mounted image (``fs``), the
    driver its weights are pinned on and the held run's streams
    (``tokens``), for the paged engine's phase.

    ``slice_engine_moe`` (moonshot-v1-16b-a3b, 48 layers, 64 experts top-6)
    keeps its 56.1 GB of weights where ``init_params`` drew them, on the
    card: no image is packed (56 GB of host bytes the path does not need),
    both engines are built over the same tensors, and the plain fp32
    forward is not run (its weights would not fit). It needs
    MOE_MIN_FREE_BYTES free when it starts, and adds the decode step's
    bytes bound (``decode_bytes_bound``) beside its p50."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import rhal, rimfs
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import (Request, ServingEngine,
                                            pack_params_image)
    from repro_torch.serving.server import Client, InferenceServer
    cfg = get_config(ENGINE_MODELS[phase])
    from_image = phase != "slice_engine_moe"
    free_before = torch.cuda.mem_get_info()[0]
    if not from_image and free_before < MOE_MIN_FREE_BYTES:
        raise AssertionError(f"{phase}: {free_before} bytes free on the "
                             f"card, not {MOE_MIN_FREE_BYTES}")
    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    image = fs = None
    t_pack = None
    if from_image:
        image = pack_params_image(params)
        t_pack = time.perf_counter() - t0 - t_init
        del params
        gc.collect()
        torch.cuda.empty_cache()
        fs = rimfs.mount(image)

    def engine():
        if from_image:
            return ServingEngine.from_rimfs(cfg, fs, driver=driver,
                                            max_batch=ENGINE_SLOTS,
                                            max_seq=ENGINE_MAX_SEQ)
        return ServingEngine(cfg, params, max_batch=ENGINE_SLOTS,
                             max_seq=ENGINE_MAX_SEQ)
    prompts = engine_prompts(seed, cfg.vocab_size)
    n_req = len(prompts)

    torch.cuda.reset_peak_memory_stats()
    serve_base = torch.cuda.memory_allocated()
    counters = kernel_counters()
    for wrapper in counters.values():    # the main path starts here
        wrapper.launches = 0
    driver = rhal.make_eager_driver()
    t1 = time.perf_counter()
    eng = engine()
    torch.cuda.synchronize()
    pin_s = time.perf_counter() - t1
    for wrapper in counters.values():    # the decode graph's warm-up ran
        wrapper.launches = 0
    served_log = instrument_engine(torch, eng)
    server = InferenceServer(engine=eng)
    server.start()
    client = Client(server.address)
    passes = []
    try:
        for held in (True, False):
            passes.append(engine_burst(server, client, eng, prompts,
                                       served_log, phase, held))
            engine_launch_check(passes[-1]["log"], cfg, f"{phase} served"
                                + (" held" if held else ""))
            if held:
                launches = {name: w.launches for name, w in counters.items()}
                serve_peak = torch.cuda.max_memory_allocated()
                telemetry = client.telemetry()
        client.shutdown()
    finally:
        client.close()
        server.stop()
    held_pass, free_pass = passes
    groups = prefill_groups(held_pass["log"])
    n_prefills = len(groups)
    want = logged_launches(held_pass["log"], cfg)
    if n_prefills != n_req or launches != want:
        raise AssertionError(f"{phase}: the held burst launched {launches}, "
                             f"not {want} ({n_prefills} prefills for "
                             f"{n_req} prompts)")
    for i, tok in enumerate(held_pass["tokens"]):
        if tok.shape != (ENGINE_MAX_NEW + 1,) or tok.dtype != np.int32 \
                or tok.min() < 0 or tok.max() >= cfg.vocab_size:
            raise AssertionError(f"{phase}: request {i} replied {tok}")
    served_step = eng.program.artifacts["decode"]

    # a local engine over the same pinned weights (zero bytes moved), its
    # decode step swapped for the eager one, fed the same prefills: the
    # served tokens bit for bit
    dma_before = dict(driver.stats)
    local = engine()
    if driver.stats.get("dma_bytes", 0) != dma_before.get("dma_bytes", 0):
        raise AssertionError(f"{phase}: a second from_rimfs moved bytes")
    compiled = local.program.artifacts["decode"]     # its captured step
    eager = make_decode_step(cfg)
    local._decode = eager
    local_log = instrument_engine(torch, local, keep=True)
    reqs = [Request(rid=i, prompt=p, max_new=ENGINE_MAX_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        local.submit(r)
    local.run_until_drained()
    if prefill_groups(local_log) != groups:
        raise AssertionError(f"{phase}: local prefill groups "
                             f"{prefill_groups(local_log)}, served {groups}")
    for i, (r, tok) in enumerate(zip(reqs, held_pass["tokens"])):
        if r.out_tokens != tok.tolist():
            raise AssertionError(f"{phase}: request {i} served "
                                 f"{tok.tolist()}, the eager-step engine "
                                 f"{r.out_tokens}")
    engine_launch_check(local_log, cfg, f"{phase} local")

    # the graph against the eager step: one step at 4 live slots from two
    # copies of the cache, the logits and every cache tensor bit for bit
    toks = torch.as_tensor(np.asarray([r.out_tokens[:1] for r in reqs[:4]],
                                      np.int32), device="cuda")
    pos = torch.as_tensor(np.asarray(ENGINE_PROMPTS[:4], np.int32),
                          device="cuda")
    batch = {"inputs": toks, "pos": pos}
    mirror = {k: v.clone() for k, v in local._cache.items()}
    got, _ = compiled(local.params, local._cache, batch)
    ref, _ = eager(local.params, mirror, batch)
    differ = [k for k, v in mirror.items()
              if not torch.equal(local._cache[k], v)]
    if not torch.equal(got, ref) or differ:
        raise AssertionError(f"{phase}: the decode graph's replay differs "
                             f"from the eager step (logits equal "
                             f"{torch.equal(got, ref)}, cache {differ})")
    del mirror, got, ref

    # arrival order: the same six streams held, unheld, and each prompt
    # admitted alone into the local engine, on its own steps again
    step_prefill = local.program.artifacts["prefill"]
    local._prefill, local._decode = step_prefill, compiled
    alone = []
    for i, p in enumerate(prompts):
        r = Request(rid=i, prompt=p, max_new=ENGINE_MAX_NEW)
        local.submit(r)
        local.run_until_drained()
        alone.append(r.out_tokens)
    ungated_same = [a.tolist() == b.tolist()
                    for a, b in zip(held_pass["tokens"], free_pass["tokens"])]
    alone_same = [a.tolist() == b
                  for a, b in zip(held_pass["tokens"], alone)]
    if not (all(ungated_same) and all(alone_same)):
        raise AssertionError(f"{phase}: arrival moved tokens: unheld same "
                             f"{ungated_same}, alone same {alone_same}")

    # every hand-kernel call of each prefill against its plain version on
    # the same operands; then, reported only, the end-to-end numbers a
    # random-weight bf16 model at full depth scrambles (see the docstring)
    checks = []
    for e in (e for e in local_log if e["step"] == "prefill"):
        checks += kernels_in_model(
            torch, lambda e=e: step_prefill(local.params,
                                            {"inputs": e["tokens"]}))
    summary = kernel_check_summary(checks)
    calls = {name: s["calls"] for name, s in summary.items()}
    prefills = [e for e in local_log if e["step"] == "prefill"]
    want_calls = {name: n for name, n in logged_launches(prefills,
                                                          cfg).items()
                  if n and name != "int8_matmul"}
    if calls != want_calls or not all(c["ok"] for c in checks):
        raise AssertionError(f"{phase}: kernels in the model {summary}, "
                             f"calls wanted {want_calls}; failed: "
                             f"{[c for c in checks if not c['ok']][:4]}")
    logits_check = prefill_logits_vs_plain(torch, cfg, local.params,
                                           local_log)
    recompute = [greedy_recompute(torch, cfg, local.params, p, r.out_tokens)
                 for p, r in zip(prompts, reqs)]
    small = next(e for e in reversed(local_log) if e["step"] == "prefill")
    plain_bf16_vs_fp32 = "not run: an fp32 copy of the weights does not " \
        "fit the card"
    if from_image:
        fp32_cfg = dataclasses.replace(cfg, dtype="float32")
        fp32 = tf.forward_full(fp32_cfg, {k: v.float() for k, v in
                                          local.params.items()},
                               small["tokens"], impl="ref")[0][:, -1]
        bf16 = tf.forward_full(cfg, local.params, small["tokens"],
                               impl="ref")[0][:, -1].float()
        plain_bf16_vs_fp32 = {"shape": small["shape"], "rel_err": (
            (bf16 - fp32).abs().max() / fp32.abs().max()).item()}
        del fp32, bf16
    gc.collect()
    torch.cuda.empty_cache()

    # where the time goes: one decode step at 4 live slots, replayed and
    # eager; the replay's host wall to a sync and its device time over 20;
    # one prefill of each served shape
    def replay():
        compiled(local.params, local._cache, batch)
    decode_time = device_breakdown(torch, replay, top=8)
    decode_eager_time = device_breakdown(
        torch, lambda: eager(local.params, local._cache, batch), top=8)
    replay_walls = []
    for _ in range(20):
        t2 = time.perf_counter()
        replay()
        torch.cuda.synchronize()
        replay_walls.append(time.perf_counter() - t2)
    replay_device_ms = cuda_ms(torch, replay, iters=20)
    prefill_time = {}
    for e in (e for e in local_log if e["step"] == "prefill"):
        key = "x".join(map(str, e["shape"]))
        prefill_time[key] = device_breakdown(
            torch, lambda e=e: step_prefill(local.params,
                                            {"inputs": e["tokens"]}), top=6)
    walls = sorted(held_pass["walls"])
    generated = n_req * (ENGINE_MAX_NEW + 1)
    moe = {}
    if not from_image:
        moe = {"free_bytes_before": free_before,
               "weight_bytes": sum(v.numel() * v.element_size()
                                   for v in params.values()),
               "decode_bound_4_slots": decode_bytes_bound(
                   cfg, local.params, local._cache, pos.tolist())}
    emit(phase, model=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, slots=ENGINE_SLOTS, max_seq=ENGINE_MAX_SEQ,
         prompts=list(ENGINE_PROMPTS), max_new=ENGINE_MAX_NEW,
         image_bytes=len(image) if from_image else None, init_s=t_init,
         pack_s=t_pack,
         pin_s=pin_s, decode_capture_s=served_step.graph.capture_s,
         cache_bytes={k: c.numel() * c.element_size()
                      for k, c in eng._cache.items()},
         cache_shapes={k: list(c.shape) for k, c in eng._cache.items()},
         serve_peak_memory_allocated=serve_peak,
         serve_base_memory_allocated=serve_base,
         prefill_groups=groups, launches=launches,
         launches_per_prefill={f"1x{s}": prefill_launches(cfg, s)
                               for s in sorted(set(ENGINE_PROMPTS))},
         launches_per_decode_step=decode_launches(cfg, 1),
         replay_hand_kernel_launches=served_step.graph.launches,
         request_wall_s=held_pass["walls"], latency_p50_s=walls[n_req // 2],
         latency_max_s=walls[-1], burst_s=held_pass["burst_s"],
         tokens_per_s=generated / held_pass["burst_s"],
         decode_steps=sum(e["step"] == "decode" for e in held_pass["log"]),
         engine_decode_step=telemetry.get("engine"),
         served_prefills=[{k: e[k] for k in ("shape", "wall_s")}
                          for e in held_pass["log"]
                          if e["step"] == "prefill"],
         served_decode_wall_s=sorted(e["wall_s"] for e in held_pass["log"]
                                     if e["step"] == "decode"),
         bit_identical_to_eager_step_engine=True,
         graph_equals_eager_step=True,
         kernel_calls_checked=summary, attention_tol=ENGINE_TOL,
         attention_worst_rel_err=summary.get(
             "flash_attention", {}).get("worst_rel_err"),
         reported_prefill_logits_vs_plain=logits_check,
         reported_recompute=recompute,
         reported_plain_bf16_vs_fp32_logits=plain_bf16_vs_fp32,
         ungated_prefill_groups=prefill_groups(free_pass["log"]),
         ungated_tokens_same=ungated_same, alone_tokens_same=alone_same,
         ungated_request_wall_s=free_pass["walls"],
         ungated_burst_s=free_pass["burst_s"],
         decode_replay_wall_s=sorted(replay_walls)[len(replay_walls) // 2],
         decode_replay_device_ms=replay_device_ms,
         decode_step_4_slots=decode_time,
         decode_step_4_slots_eager=decode_eager_time,
         prefill_by_shape=prefill_time, **moe)
    if keep is not None:
        keep.update(fs=fs, driver=driver,
                    tokens=[t.tolist() for t in held_pass["tokens"]],
                    params=None if from_image else params,
                    tokens_per_s=generated / held_pass["burst_s"],
                    decode_step=telemetry.get("engine"))
    del eng, local, compiled, served_step, replay, image, fs, driver
    if not from_image:
        del params
    gc.collect()
    torch.cuda.empty_cache()
    return {phase: launches}


def paged_blocks(plen: int) -> int:
    """KV blocks the paged engine reserves for a prompt of ``plen`` tokens
    and ENGINE_MAX_NEW new ones."""
    return -(-(plen + ENGINE_MAX_NEW) // PAGED_BLOCK)


def but_null(torch, pool, null: int):
    """The pool without its null block (pad lanes write it in an
    unspecified order)."""
    return torch.cat([pool[:, :null], pool[:, null + 1:]], dim=1)


def check_rungs(torch, compiled, pool_k, pool_v, windows: list) -> list:
    """One replay of each rung in ``windows`` (the first recorded batch of
    each) from the pool as it stands, against the eager window on a copy of
    the pool: the tokens and every block but the null one bit for bit, and
    every block outside the batch's tables untouched. Raises on a rung
    that differs; returns one row a rung."""
    rungs: dict = {}
    for e in windows:
        rungs.setdefault(tuple(e["shape"]), e["batch"])
    null = compiled.null_block
    out = []
    for (bucket, window), batch in sorted(rungs.items()):
        before = pool_k.clone(), pool_v.clone()
        mirror = pool_k.clone(), pool_v.clone()
        toks = compiled.graphs[bucket, window](batch)["tokens"]
        want, _, _ = compiled.eager(compiled.params, *mirror, batch, window)
        outside = sorted(set(range(null))
                         - set(batch["tables"].flatten().tolist()))
        row = {"rung": [bucket, window],
               "tokens_same": torch.equal(toks, want),
               "pool_same": all(torch.equal(but_null(torch, a, null),
                                            but_null(torch, b, null))
                                for a, b in zip((pool_k, pool_v), mirror)),
               "outside_blocks": len(outside),
               "outside_untouched": all(
                   torch.equal(a[:, outside], b[:, outside])
                   for a, b in zip((pool_k, pool_v), before))}
        out.append(row)
        del before, mirror
        if not (row["tokens_same"] and row["pool_same"]
                and row["outside_untouched"]):
            raise AssertionError(f"a replay differs from its eager window: "
                                 f"{row}")
    return out


def phase_engine_paged_reduced_depth(torch, seed: int, prompts: list) -> None:
    """Phase 7c: the paged engine at qwen2-1.5B's full width cut to one
    fp32 layer. A pool of just the first four prompts' worst-case
    reservations, so the last two prompts are placed on blocks the first
    four released: each prefill's launches, each prefill's last-position
    logits within ENGINE_TOL of the plain versions', every greedy token
    against the offline recompute (gated), and the last two prompts' blocks
    all recycled. Then a pool that fits two of four 512-token prompts: two
    are served, two shed with an ``out_of_blocks`` verdict at admission,
    with no token and no kernel launch spent on them."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import Request
    from repro_torch.serving.paged_engine import PagedServingEngine
    from repro_torch.serving.scheduler import DeadlineScheduler
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=1,
                              dtype="float32")
    params = tf.init_params(cfg, seed)
    what = "qwen2-1.5b 1-layer float32 paged engine"
    pool = sum(paged_blocks(len(p)) for p in prompts[:ENGINE_SLOTS])
    eng = PagedServingEngine(cfg, params, max_batch=ENGINE_SLOTS,
                             max_seq=ENGINE_MAX_SEQ, block_size=PAGED_BLOCK,
                             num_blocks=pool)
    log = instrument_engine(torch, eng, keep=True)
    blocks_of, allocate = [], eng.cache.allocate

    def recorded_allocate(seq, tokens=0):
        allocate(seq, tokens)
        blocks_of.append(eng.cache.blocks_for(seq))
    eng.cache.allocate = recorded_allocate
    reqs = [Request(rid=i, prompt=p, max_new=ENGINE_MAX_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    engine_launch_check(log, cfg, what)
    first = set().union(*blocks_of[:ENGINE_SLOTS])
    recycled = [sorted(b) for b in blocks_of[ENGINE_SLOTS:]]
    if len(blocks_of) != len(prompts) or not all(
            set(b) <= first for b in recycled):
        raise AssertionError(f"{what}: later prompts' blocks {recycled} "
                             f"not all released by the first four")
    logits = prefill_logits_vs_plain(torch, cfg, eng.params, log)
    for c in logits:
        if not (c["finite"]
                and c["max_abs_err"] <= ENGINE_TOL * c["max_abs_logit"]):
            raise AssertionError(f"{what}: prefill {c} beyond {ENGINE_TOL} "
                                 f"of max |logit|")
    recompute = [greedy_recompute(torch, cfg, eng.params, p, r.out_tokens)
                 for p, r in zip(prompts, reqs)]
    for i, rc in enumerate(recompute):
        if rc["mismatch_at"] is not None or rc["checked"] != \
                ENGINE_MAX_NEW + 1:
            raise AssertionError(f"{what}: request {i} {rc}")
    windows = [e["shape"] for e in log if e["step"] == "decode"]
    rungs = eng.program.artifacts["paged_decode"].captured
    eng.close()

    # a pool for two 512-token prompts' reservations, four such prompts
    short_blocks = 2 * paged_blocks(512)
    short = PagedServingEngine(cfg, params, max_batch=ENGINE_SLOTS,
                               max_seq=ENGINE_MAX_SEQ,
                               block_size=PAGED_BLOCK,
                               num_blocks=short_blocks,
                               scheduler=DeadlineScheduler())
    short_log = instrument_engine(torch, short)
    counters = kernel_counters()
    n0 = {name: w.launches for name, w in counters.items()}
    four = [Request(rid=i, prompt=p, max_new=ENGINE_MAX_NEW) for i, p in
            enumerate(engine_prompts(seed + 1, cfg.vocab_size, (512,) * 4))]
    for r in four:
        short.submit(r)
    short.run_until_drained()
    spent = {name: w.launches - n0[name] for name, w in counters.items()}
    shed = [r for r in four if r.shed]
    served = [r for r in four if not r.shed]
    short_line = {
        "num_blocks": short_blocks, "prompts": [512] * 4,
        "served": len(served), "shed": len(shed),
        "verdicts": [r.verdict for r in shed],
        "shed_tokens": [len(r.out_tokens) for r in shed],
        "prefills": len(prefill_groups(short_log)), "launches": spent,
        "shed_count": short.scheduler.shed_count}
    want = logged_launches(short_log, cfg)
    if not (len(served) == 2 and len(shed) == 2 and spent == want
            and want["flash_attention"] == 2 * cfg.num_layers
            and short_line["prefills"] == 2
            and all("out of KV blocks" in r.verdict
                    and r.verdict_kind == "out_of_blocks"
                    and r.out_tokens == [] for r in shed)
            and all(len(r.out_tokens) == ENGINE_MAX_NEW + 1
                    for r in served)):
        raise AssertionError(f"{what}: the short pool {short_line}")
    short.close()
    emit("engine_reduced_depth", model=cfg.name, engine="paged", layers=1,
         dtype=cfg.dtype, max_seq=ENGINE_MAX_SEQ, block_size=PAGED_BLOCK,
         num_blocks=pool, prompts=[len(p) for p in prompts],
         prefill_groups=prefill_groups(log),
         prefill_launches=[e["launches"] for e in log
                           if e["step"] == "prefill"],
         windows=windows, rungs_captured=rungs,
         recycled_blocks_of_last_two=recycled,
         prefill_logits=logits, logits_tol=ENGINE_TOL,
         recompute_gated=True, recompute=recompute, short_pool=short_line)
    del eng, short, params
    gc.collect()
    torch.cuda.empty_cache()


def phase_slice_engine_paged(torch, seed: int, keep: dict) -> dict:
    """Phase 7d: the paged-KV engine. qwen2-1.5B at full width and depth,
    from the image ``slice_engine`` pinned (``keep``: its mounted image,
    driver and streams), provisioned by ``PagedServingEngine.from_rimfs``
    (4 slots, max_seq 640, blocks of 16 rows, the default pool of 160 + 1
    blocks; its 12 (bucket, window) rungs captured as CUDA graphs when it
    is built) and served by the port's InferenceServer: the six prompts of
    ``slice_engine``, held until all are queued, each prefilled alone on
    ``flash_attention``, decoded in windows of up to 8 tokens.
    Gates: the same engine, its windows then swapped for the eager ones
    and fed the same prompts, gives the same streams bit for bit, through
    the same prefills; a rung captured anew while four of those sequences
    hold blocks leaves every block but the null one untouched; one replay
    of each rung the burst reached equals its eager window (tokens and
    pool, blocks outside the batch untouched); 28 ``flash_attention``
    launches a prefill and none in a window; the six streams equal
    ``slice_engine``'s dense ones. Prints tokens/s, the reply times, the
    per-token decode p50, the w = 8 window at bucket 4 (host wall, device
    time and where it goes), the w = 8 window's device time at each bucket
    and, at bucket 4, through tables of 8 and 16 blocks (what a span
    bucket could save), the rungs captured and their seconds, ``kv_stats``
    and the peak memory. Returns the launches of the served burst, the
    main path's."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.executor import CapturedGraph
    from repro_torch.launch.steps import make_paged_decode_step
    from repro_torch.serving.engine import Request
    from repro_torch.serving.paged_engine import PagedServingEngine
    from repro_torch.serving.server import Client, InferenceServer
    phase = "slice_engine_paged"
    cfg = get_config("qwen2-1.5b")
    fs, driver = keep["fs"], keep["driver"]
    prompts = engine_prompts(seed, cfg.vocab_size)
    n_req = len(prompts)

    torch.cuda.reset_peak_memory_stats()
    serve_base = torch.cuda.memory_allocated()
    counters = kernel_counters()
    for wrapper in counters.values():    # the main path starts here
        wrapper.launches = 0
    t1 = time.perf_counter()
    eng = PagedServingEngine.from_rimfs(cfg, fs, driver=driver,
                                        max_batch=ENGINE_SLOTS,
                                        max_seq=ENGINE_MAX_SEQ,
                                        block_size=PAGED_BLOCK)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    for wrapper in counters.values():    # the rungs' warm-ups ran
        wrapper.launches = 0
    compiled = eng.program.artifacts["paged_decode"]
    rungs_built = list(compiled.captured)
    prefill_step = eng._prefill
    log = instrument_engine(torch, eng)
    server = InferenceServer(engine=eng)
    server.start()
    client = Client(server.address)
    try:
        served = engine_burst(server, client, eng, prompts, log, phase)
        launches = {name: w.launches for name, w in counters.items()}
        serve_peak = torch.cuda.max_memory_allocated()
        telemetry = client.telemetry()
        client.shutdown()
    finally:
        client.close()
        server.stop()
    tokens, walls, burst_s = served["tokens"], served["walls"], \
        served["burst_s"]
    engine_launch_check(log, cfg, f"{phase} served")
    groups = prefill_groups(log)
    want = logged_launches(log, cfg)
    if len(groups) != n_req or launches != want:
        raise AssertionError(f"{phase}: the held burst launched {launches}, "
                             f"not {want} ({len(groups)} prefills for "
                             f"{n_req} prompts)")
    for i, tok in enumerate(tokens):
        if tok.shape != (ENGINE_MAX_NEW + 1,) or tok.dtype != np.int32 \
                or tok.min() < 0 or tok.max() >= cfg.vocab_size:
            raise AssertionError(f"{phase}: request {i} replied {tok}")
    windows = [e for e in log if e["step"] == "decode"]

    # the same engine, its windows eager, fed the same prompts; after its
    # first window (four sequences hold blocks) one rung is captured anew,
    # and may write only the null block
    eng._prefill, eng._decode = prefill_step, compiled.eager
    local_log = instrument_engine(torch, eng)
    reqs = [Request(rid=i, prompt=p, max_new=ENGINE_MAX_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.step()
    live_blocks = sum(len(t) for t in eng.cache.tables.values())
    null = eng.cache.null_block
    before = eng.cache.k.clone(), eng.cache.v.clone()
    recaptured = compiled.capture(ENGINE_SLOTS, 8).capture_s
    capture_untouched = all(
        torch.equal(but_null(torch, a, null), but_null(torch, b, null))
        for a, b in zip((eng.cache.k, eng.cache.v), before))
    del before
    eng.run_until_drained()
    eng._prefill, eng._decode = prefill_step, compiled
    local_same = [r.out_tokens == t.tolist() for r, t in zip(reqs, tokens)]
    if not (capture_untouched and all(local_same)
            and prefill_groups(local_log) == groups):
        raise AssertionError(f"{phase}: capture with {live_blocks} live "
                             f"blocks untouched {capture_untouched}; streams "
                             f"equal to the eager-window engine's "
                             f"{local_same}; prefills "
                             f"{prefill_groups(local_log)} vs {groups}")
    engine_launch_check(local_log, cfg, f"{phase} eager windows")

    # one replay of each rung the burst reached against its eager window
    rung_checks = check_rungs(torch, compiled, eng.cache.k, eng.cache.v,
                              windows)

    # where the time goes: the w = 8 window at bucket 4, replayed
    w8 = next(e["batch"] for e in windows
              if e["shape"] == [ENGINE_SLOTS, 8])
    graph8 = compiled.graphs[ENGINE_SLOTS, 8]

    def replay():
        graph8(w8)
    window_time = device_breakdown(torch, replay, top=8)
    replay_walls = []
    for _ in range(20):
        t3 = time.perf_counter()
        replay()
        torch.cuda.synchronize()
        replay_walls.append(time.perf_counter() - t3)
    window_device_ms = cuda_ms(torch, replay, iters=20)

    # the w = 8 window at each bucket, and at bucket 4 through tables of
    # 8 and 16 blocks (its scores, values and P.V over span * 16 rows: at
    # most what a span bucket could save), from the burst's batch, and
    # over all 40 blocks at pos 100 too (the same work on other data);
    # the runs alternate, twice over (they write the pool, which nothing
    # reads after them)
    step8 = make_paged_decode_step(cfg, 8)

    def window_over(inputs, held=None):
        return {"tokens": step8(eng.params, eng.cache.k, eng.cache.v,
                                inputs)[0]}
    runs = {f"bucket_{b}": (compiled.graphs[b, 8],
                            {"tokens": w8["tokens"][:b],
                             "pos": w8["pos"][:b], "tables": w8["tables"]})
            for b in eng.buckets}
    for span in (8, 16):
        batch = {**w8, "tables": w8["tables"][:, :span].contiguous()}
        runs[f"span_{span}"] = (CapturedGraph(
            window_over, {k: v.clone() for k, v in batch.items()},
            compiled.held, w8["tables"].device), batch)
    runs["span_40_pos_100"] = (graph8, {
        **w8, "pos": torch.full_like(w8["pos"], 100)})
    window_8_ms = {name: [] for name in runs}
    for _ in range(2):
        for name, (graph, batch) in runs.items():
            window_8_ms[name].append(cuda_ms(
                torch, lambda: graph(batch), iters=5, warmup=1))
    del runs

    dense_same = [t.tolist() == d for t, d in zip(tokens, keep["tokens"])]
    sorted_walls = sorted(walls)
    generated = n_req * (ENGINE_MAX_NEW + 1)
    emit(phase, model=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
         slots=ENGINE_SLOTS, max_seq=ENGINE_MAX_SEQ, block_size=PAGED_BLOCK,
         prompts=list(ENGINE_PROMPTS), max_new=ENGINE_MAX_NEW,
         build_s=build_s, kv_stats=telemetry["engine"].get("kv"),
         pool_bytes=eng.cache.pool_bytes(),
         pool_shape=list(eng.cache.k.shape),
         serve_peak_memory_allocated=serve_peak,
         serve_base_memory_allocated=serve_base,
         prefill_groups=groups, launches=launches,
         launches_per_prefill={f"1x{s}": prefill_launches(cfg, s)
                               for s in sorted(set(ENGINE_PROMPTS))},
         launches_per_window_step=decode_launches(cfg, 1),
         windows=[e["shape"] for e in windows],
         window_wall_s=[e["wall_s"] for e in windows],
         served_prefills=[{k: e[k] for k in ("shape", "wall_s")}
                          for e in log if e["step"] == "prefill"],
         rungs_captured=rungs_built,
         rungs_capture_s=sum(c["capture_s"] for c in rungs_built),
         capture_with_live_blocks_s=recaptured,
         live_blocks_at_capture=live_blocks,
         capture_left_live_blocks_untouched=capture_untouched,
         bit_identical_to_eager_window_engine=True,
         rung_replays_equal_eager=rung_checks,
         tokens_equal_dense_engine=dense_same,
         request_wall_s=walls, first_four_replies_s=sorted_walls[3],
         last_two_replies_s=sorted_walls[-1], burst_s=burst_s,
         tokens_per_s=generated / burst_s,
         engine_decode_token=telemetry.get("engine"),
         window_8_bucket_4=window_time,
         window_8_bucket_4_replay_wall_s=sorted(replay_walls)[
             len(replay_walls) // 2],
         window_8_bucket_4_device_ms=window_device_ms,
         window_8_device_ms=window_8_ms)
    eng.close()
    del eng, compiled, graph8, replay
    gc.collect()
    torch.cuda.empty_cache()
    if not all(dense_same):
        raise AssertionError(f"{phase}: the paged streams differ from the "
                             f"dense engine's: {dense_same}")
    return {phase: launches}


# ---------------------------------------------------------------------------
# Training: qwen2-1.5B takes AdamW steps, checkpoints, restarts, serves
# ---------------------------------------------------------------------------

TRAIN_MODEL = "qwen2-1.5b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 128, 30
TRAIN_LR, TRAIN_CKPT_AT = 3e-3, 20
TRAIN_LOSS_TOL = 1e-5        # relative: one step's loss, card against CPU
TRAIN_GRAD_TOL = 1e-4        # of each leaf's max |gradient| (in fp64)
TRAIN_FP32_GRAD_TOL = 1e-2   # of each leaf's max |gradient| (in fp32)
ADAMW_TOL = 1e-6             # of each leaf's max: AdamW, card against CPU
TRAIN_FP32_SHAPE = (2, 64)   # train_two_layer_fp32's (B, S)
TRAINED_PROMPTS = (128, 100, 64)
TRAINED_MAX_NEW = 16


def train_ckpt_root() -> Path:
    """The training phases' checkpoints: under the checkout's ignored
    ``build/``, removed when the phases end (each image is 15.44 GB)."""
    return Path(__file__).resolve().parent / "build" / "train_ckpt"


def train_grads(torch, cfg, params: dict, batch: dict) -> dict:
    """One training step's loss and gradients through ``make_train_step``'s
    own ``forward`` and ``backward`` (remat ``"full"``), and the global
    norm AdamW clips by."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import global_norm
    step = make_train_step(cfg, remat=True, remat_policy="full")
    leaves, total, (loss, _) = step.forward(params, batch)
    grads = step.backward(leaves, total)
    return {"loss": float(loss.detach()), "grads": grads,
            "grad_norm": float(global_norm(grads))}


def fp64_train_grads(torch, cfg, params: dict, batch: dict,
                     device: str) -> dict:
    """``train_grads`` on ``device`` with the parameters in fp64 and every
    fp32 cast of the port's code (``Tensor.float``) taken to fp64 for the
    call. What is built as fp32 stays fp32: on qwen2's path RoPE's inverse
    frequencies (``rope_freqs``, then multiplied by fp64 positions) and
    the zero that the MoE aux loss starts from (0 for a dense model). For
    this check only; the cast is restored after."""
    cast = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        return train_grads(
            torch, cfg, {k: v.to(device, torch.float64)
                         for k, v in params.items()},
            {k: torch.as_tensor(v, device=device) for k, v in batch.items()})
    finally:
        torch.Tensor.float = cast


def grad_errors(torch, got: dict, want: dict) -> dict:
    """Each leaf's max |got - want| over want's max |value|."""
    return {k: ((got[k].cpu().double() - want[k].cpu().double()).abs().max()
                / want[k].abs().max().clamp(min=1e-300)).item()
            for k in want}


def adamw_card_vs_cpu(torch, grads: dict, params: dict, seed: int) -> dict:
    """One ``adamw_update`` on the card and on the CPU from the same fp32
    gradients, parameters and state (each device's copy made from the
    card's tensors): moments drawn from ``seed`` at the
    clipped gradients' scale (so the gradient term moves each parameter
    by about lr) and the step count at 9, lr TRAIN_LR. Returns each leaf's
    max |card - CPU| over the CPU's max, for the parameters, m and v, and
    both updates' grad_norm and clip_scale."""
    from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_update
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(g):
        return torch.randn(g.shape, generator=gen, device="cuda") * 1e-5
    m = {k: draw(g) for k, g in sorted(grads.items())}
    v = {k: torch.square(draw(g)) for k, g in sorted(grads.items())}
    out = {}
    for dev in ("cuda", "cpu"):
        state = AdamWState(torch.tensor(9, dtype=torch.int32, device=dev),
                           {k: t.to(dev, copy=True) for k, t in m.items()},
                           {k: t.to(dev, copy=True) for k, t in v.items()})
        p, state, gm = adamw_update(
            AdamWConfig(), {k: g.to(dev) for k, g in grads.items()}, state,
            {k: t.to(dev, copy=True) for k, t in params.items()},
            torch.tensor(TRAIN_LR, dtype=torch.float32, device=dev))
        out[dev] = ({"params": p, "m": state.m, "v": state.v},
                    {k: float(t) for k, t in gm.items()})
    errs = {part: grad_errors(torch, out["cuda"][0][part],
                              out["cpu"][0][part])
            for part in ("params", "m", "v")}
    return {"errors": errs, "card": out["cuda"][1], "cpu": out["cpu"][1]}


def phase_train_two_layer_fp32(torch, seed: int) -> None:
    """qwen2-1.5B at full width cut to 2 fp32 layers: one training step
    (``make_train_step``'s ``forward`` and ``backward``, remat ``"full"``)
    on the card and through the port's CPU path, on the same weights
    (drawn on the card) and the same ``SyntheticLM`` batch: its loss,
    gradient norm and every gradient leaf; then one AdamW update on both
    (``adamw_card_vs_cpu``). Gates: the fp32 loss within TRAIN_LOSS_TOL
    relative of the CPU's; each fp32 gradient leaf within
    TRAIN_FP32_GRAD_TOL of the leaf's max |gradient|; the same step in
    fp64 (``fp64_train_grads``) on both devices, its loss within
    TRAIN_LOSS_TOL and each leaf within TRAIN_GRAD_TOL; the AdamW update's
    parameters, m and v within ADAMW_TOL of each leaf's max; no hand
    kernel launched. The fp32 limit is wider than the fp64 one because at
    this random init each fp32 path is off the fp64 step by up to 1.2e-3
    (the CPU's) and 5.8e-3 (the card's) of a leaf's max, their roundings
    differing; the same step with the weights in bf16 on the card
    (printed, ungated) shows what the limit keeps out. This is the card's
    hold on autograd, remat, the loss and AdamW (JAX is not on this
    machine; the CPU path is held against it in the tests)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.transformer import init_params
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_MODEL), num_layers=2,
                              dtype="float32")
    B, S = TRAIN_FP32_SHAPE
    batch = SyntheticLM(cfg.vocab_size, S, B, seed=seed).global_batch_at(0)
    on_card = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    params = init_params(cfg, seed)
    before = launches_now()
    card = train_grads(torch, cfg, params, on_card)
    card64 = fp64_train_grads(torch, cfg, params, batch, "cuda")
    bf16 = train_grads(
        torch, dataclasses.replace(cfg, dtype="bfloat16"),
        {k: v.to(torch.bfloat16) if v.is_floating_point() else v
         for k, v in params.items()}, on_card)
    torch.cuda.synchronize()
    launched = {k: n - before[k] for k, n in launches_now().items()}
    t1 = time.perf_counter()
    host = train_grads(torch, cfg, {k: v.cpu() for k, v in params.items()},
                       batch)
    host64 = fp64_train_grads(torch, cfg, params, batch, "cpu")
    t2 = time.perf_counter()
    adamw = adamw_card_vs_cpu(torch, card["grads"], params, seed)
    fp32 = grad_errors(torch, card["grads"], host["grads"])
    fp64 = grad_errors(torch, card64["grads"], host64["grads"])
    bad = [k for k, e in fp64.items() if not e <= TRAIN_GRAD_TOL]
    bad32 = [k for k, e in fp32.items() if not e <= TRAIN_FP32_GRAD_TOL]
    bad_adamw = [f"{part}/{k}" for part, errs in adamw["errors"].items()
                 for k, e in errs.items() if not e <= ADAMW_TOL]
    loss_rel = abs(card["loss"] - host["loss"]) / abs(host["loss"])
    loss_rel64 = abs(card64["loss"] - host64["loss"]) / abs(host64["loss"])
    emit("train_two_layer_fp32", model=cfg.name, layers=2, batch=B, seq=S,
         remat="full", loss=card["loss"], cpu_loss=host["loss"],
         loss_rel_err=loss_rel, fp64_loss=card64["loss"],
         fp64_cpu_loss=host64["loss"], fp64_loss_rel_err=loss_rel64,
         loss_tol=TRAIN_LOSS_TOL, grad_norm=card["grad_norm"],
         cpu_grad_norm=host["grad_norm"], fp64_grad_norm=host64["grad_norm"],
         grad_tol=TRAIN_GRAD_TOL, fp32_grad_tol=TRAIN_FP32_GRAD_TOL,
         fp64_card_vs_cpu=fp64, fp32_card_vs_cpu=fp32,
         fp32_card_vs_cpu_max=max(fp32.values()),
         bf16_card_vs_cpu=grad_errors(torch, bf16["grads"], host["grads"]),
         bf16_card_vs_cpu_max=max(grad_errors(
             torch, bf16["grads"], host["grads"]).values()),
         fp32_card_vs_fp64=grad_errors(torch, card["grads"],
                                       host64["grads"]),
         fp32_cpu_vs_fp64=grad_errors(torch, host["grads"],
                                      host64["grads"]),
         adamw_tol=ADAMW_TOL, adamw_card_vs_cpu=adamw["errors"],
         adamw_card_vs_cpu_max={part: max(errs.values()) for part, errs in
                                adamw["errors"].items()},
         adamw_card=adamw["card"], adamw_cpu=adamw["cpu"],
         kernel_launches=launched, card_s=t1 - t0, cpu_s=t2 - t1,
         adamw_s=time.perf_counter() - t2)
    if not (math.isfinite(card["loss"]) and loss_rel <= TRAIN_LOSS_TOL
            and loss_rel64 <= TRAIN_LOSS_TOL and not bad and not bad32
            and not bad_adamw and not any(launched.values())):
        raise AssertionError(f"train_two_layer_fp32: loss {card['loss']} "
                             f"against {host['loss']} (fp64 "
                             f"{card64['loss']} against {host64['loss']}), "
                             f"fp64 leaves past {TRAIN_GRAD_TOL}: {bad}, "
                             f"fp32 leaves past {TRAIN_FP32_GRAD_TOL}: "
                             f"{bad32}, AdamW past {ADAMW_TOL}: "
                             f"{bad_adamw}, launches {launched}")
    del params, card, host, card64, host64, bf16, adamw
    gc.collect()
    torch.cuda.empty_cache()


def train_argv(ckpt_dir: Path, seed: int) -> list:
    return ["--arch", TRAIN_MODEL, "--batch", str(TRAIN_BATCH),
            "--seq-len", str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS),
            "--lr", str(TRAIN_LR), "--ckpt-every", str(TRAIN_CKPT_AT),
            "--log-every", "10", "--device", "cuda", "--seed", str(seed),
            "--ckpt-dir", str(ckpt_dir)]


def state_bits(torch, summary: dict) -> dict:
    """Every leaf of a run's final parameters and optimizer state by its
    checkpoint key, as integers of its width (bit for bit comparisons)."""
    from repro_torch.checkpoint.ckpt import _flatten
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return {k: t.view(ints[t.element_size()]) for k, t in _flatten(
        {"params": summary["params"], "opt": summary["opt"]}).items()}


def split_step_breakdown(torch, step, params: dict, opt,
                         batch: dict) -> dict:
    """One more step of ``step`` (the ``TrainStep`` the entry point ran)
    taken in its three parts, ``forward``, ``backward`` and ``update``:
    the whole step's device time and each part's by CUDA events, then each
    part again under ``device_breakdown`` (its top 12 kernels by device
    time). Writes the state two steps on."""
    held: dict = {"opt": opt}

    def forward():
        held["leaves"], held["total"], _ = step.forward(params, batch)

    def backward():
        held["grads"] = step.backward(held.pop("leaves"), held.pop("total"))

    def update():
        _, held["opt"], _ = step.update(params, held["opt"],
                                        held.pop("grads"))

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    ev[0].record()
    forward()
    ev[1].record()
    backward()
    ev[2].record()
    update()
    ev[3].record()
    torch.cuda.synchronize()
    parts = ("forward", "backward", "adamw")
    events_ms = {p: ev[i].elapsed_time(ev[i + 1]) for i, p in
                 enumerate(parts)}
    out = {"step_device_ms": ev[0].elapsed_time(ev[3]),
           "by_part_device_ms": events_ms}
    for p, fn in zip(parts, (forward, backward, update)):
        out[p] = device_breakdown(torch, fn, top=12)
    return out


def gradient_term(torch, step, params: dict, opt, batch: dict) -> dict:
    """What the gradient moves at full depth: one more step of ``step``
    from (``params``, ``opt``), its update taken twice from the same
    gradients and state, as the entry point takes it and with weight decay
    0 (the gradient term alone). Returns, over every parameter, how many
    the gradient term moves (in the parameters' dtype), the first-order
    loss change it makes (sum of gradient x move; below 0 when it descends)
    and the norms of its move and of the weight decay's share (the full
    update's move less the gradient term's)."""
    from repro_torch.optim.adamw import AdamWState, adamw_update
    leaves, total, _ = step.forward(params, batch)
    grads = step.backward(leaves, total)
    del leaves, total
    before = {k: v.clone() for k, v in params.items()}
    twin = {k: v.clone() for k, v in params.items()}
    twin_opt = AdamWState(opt.step.clone(),
                          {k: v.clone() for k, v in opt.m.items()},
                          {k: v.clone() for k, v in opt.v.items()})
    _, _, um = step.update(params, opt, grads)
    adamw_update(dataclasses.replace(step.opt, weight_decay=0.0), grads,
                 twin_opt, twin, um["lr"])
    del twin_opt
    moved, descent, g_sq, wd_sq = 0, 0.0, 0.0, 0.0
    for k in sorted(params):
        p0 = before.pop(k).float()
        dg = twin.pop(k).float() - p0
        dw = params[k].float() - p0 - dg
        moved += int(torch.count_nonzero(dg))
        descent += float(torch.sum(grads[k].float() * dg, dtype=torch.float64))
        g_sq += float(torch.sum(dg.double() ** 2))
        wd_sq += float(torch.sum(dw.double() ** 2))
        del p0, dg, dw
    n = sum(v.numel() for v in params.values())
    return {"lr": float(um["lr"]), "grad_norm": float(um["grad_norm"]),
            "clip_scale": float(um["clip_scale"]), "moved": moved,
            "moved_share": moved / n, "first_order_loss_change": descent,
            "gradient_move_norm": math.sqrt(g_sq),
            "weight_decay_move_norm": math.sqrt(wd_sq)}


def phase_slice_train(torch, seed: int, keep: dict) -> dict:
    """qwen2-1.5B at full width and depth (28 layers, bf16, weights drawn
    from ``seed`` on the card) trained through the entry point,
    ``repro_torch.launch.train.main``: TRAIN_STEPS AdamW steps on
    ``SyntheticLM`` at B = TRAIN_BATCH, S = TRAIN_SEQ, peak lr TRAIN_LR,
    warm-up 20, remat ``"full"``, a checkpoint at step TRAIN_CKPT_AT and
    the final one. Then a second run in a directory holding only the
    step-20 checkpoint (a hard link): it restores it into fresh tensors
    and runs steps 21 to 30 again. Gates: the two runs' final parameters,
    moments and step equal bit for bit, and their losses at steps 21 to
    30; every loss finite; the mean of the last 5 losses below the first
    5's; no hand kernel launched in either run. Prints each run's step
    walls (host, to a sync), tokens/s at the p50, the peak memory, the
    saves' seconds (snapshot, pack with the CRCs, write) and bytes, the
    restore's seconds, losses and gradient norms at steps 1, 10, 20 and
    30, then two more steps in their parts (``split_step_breakdown``) and
    one whose update is taken again with weight decay 0 (``gradient_term``:
    gated, the gradient term moves parameters and descends to first
    order; at this init the clip scale is about 1e-15, so the loss curve
    alone could fall by weight decay). Leaves
    in ``keep`` the first run's final parameters (``params``) and the path
    of its step-30 checkpoint (``ckpt``) for ``phase_serve_trained``;
    returns the hand kernels' launches over both runs (none)."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train
    cfg = get_config(TRAIN_MODEL)
    root = train_ckpt_root()
    shutil.rmtree(root, ignore_errors=True)
    first, second = root / "uninterrupted", root / "restarted"
    t0 = time.perf_counter()
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    full = train.main(train_argv(first, seed))
    peak = torch.cuda.max_memory_allocated()
    t1 = time.perf_counter()
    ckpt_name = f"ckpt_{TRAIN_CKPT_AT:08d}.rimfs"
    second.mkdir(parents=True)
    os.link(first / ckpt_name, second / ckpt_name)
    again = train.main(train_argv(second, seed))
    t2 = time.perf_counter()
    launched = launches_now()
    want, got = state_bits(torch, full), state_bits(torch, again)
    differ = [k for k in want if k not in got
              or not torch.equal(want[k], got[k])]
    n_leaves = len(want)
    del want, got
    losses = [full["losses"][i] for i in range(1, TRAIN_STEPS + 1)]
    redo = {i: (full["losses"][i], again["losses"].get(i))
            for i in range(TRAIN_CKPT_AT + 1, TRAIN_STEPS + 1)}

    def walls(summary):
        w = sorted(summary["step_wall_s"].values())
        return {"p50": w[len(w) // 2], "max": w[-1], "n": len(w),
                "first": summary["step_wall_s"][min(summary["step_wall_s"])]}
    w1 = walls(full)
    ds = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in ds.global_batch_at(TRAIN_STEPS).items()}
    keep.update(params=full["params"],
                ckpt=first / f"ckpt_{TRAIN_STEPS:08d}.rimfs")
    del full["opt"]
    gc.collect()
    breakdown = split_step_breakdown(torch, again["step"], again["params"],
                                     again["opt"], batch)
    moves = gradient_term(torch, again["step"], again["params"],
                          again["opt"], batch)
    emit("slice_train", model=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, params=full["param_count"], batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, steps=TRAIN_STEPS, lr=TRAIN_LR, remat="full",
         ckpt_at=TRAIN_CKPT_AT, first_run_s=t1 - t0, second_run_s=t2 - t1,
         step_wall_s=w1, restarted_step_wall_s=walls(again),
         tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / w1["p50"],
         max_memory_allocated=peak,
         saves=full["saves"] + again["saves"],
         ckpt_bytes=full["saves"][0]["bytes"],
         restore_s=again["restore_s"], restored_from=again["start"],
         losses={i: full["losses"][i] for i in (1, 10, 20, 30)},
         grad_norms={i: full["grad_norms"][i] for i in (1, 10, 20, 30)},
         lrs={i: full["lrs"][i] for i in (1, 10, 20, 30)},
         first_5_mean=sum(losses[:5]) / 5, last_5_mean=sum(losses[-5:]) / 5,
         restart_bit_exact=not differ, leaves_compared=n_leaves,
         leaves_differ=differ[:8], restarted_losses_equal=all(
             a == b for a, b in redo.values()),
         gradient_term=moves, kernel_launches=launched, **breakdown)
    if not (moves["moved"] > 0 and moves["first_order_loss_change"] < 0):
        raise AssertionError(f"slice_train: the gradient term does not move "
                             f"the parameters down the gradient: {moves}")
    if differ or any(a != b for a, b in redo.values()):
        raise AssertionError(f"slice_train: the restart from step "
                             f"{TRAIN_CKPT_AT} differs at step "
                             f"{TRAIN_STEPS}: {differ[:8]} {redo}")
    if not all(math.isfinite(x) for x in losses + list(
            again["losses"].values())):
        raise AssertionError(f"slice_train: a loss is not finite: {losses}")
    if not sum(losses[-5:]) < sum(losses[:5]):
        raise AssertionError(f"slice_train: the last 5 losses do not fall "
                             f"below the first 5: {losses}")
    if any(launched.values()):
        raise AssertionError(f"slice_train: training launched hand "
                             f"kernels: {launched}")
    del full, again, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"train": launched}


def structure_hits(tokens: list, vocab: int, structure: int = 97) -> float:
    """The share of generated tokens that follow ``SyntheticLM``'s hidden
    chain from the token before them (state s -> (31 s + 7) mod 97, token
    s * (vocab // 97) + noise in 0..3): what the trained model learned."""
    width = vocab // structure
    pairs = list(zip(tokens, tokens[1:]))
    hits = sum(1 for a, b in pairs
               if b // width == (a // width * 31 + 7) % structure)
    return hits / max(1, len(pairs))


def phase_serve_trained(torch, seed: int, keep: dict) -> dict:
    """The trained weights served: the parameters loaded from the first
    training run's step-30 checkpoint (``load_checkpoint`` of the
    parameters alone, CRC-verified) and the run's in-memory ones, each
    provisioned into a ``ServingEngine``; the same TRAINED_PROMPTS
    (``SyntheticLM`` rows the training never drew) decoded greedily for
    TRAINED_MAX_NEW tokens by each. Gates: the two engines' tokens equal
    bit for bit; each prefill launches 28 ``flash_attention`` and each
    decode step 28 ``decode_attention``. Prints how many generated tokens follow the data's
    hidden chain (``structure_hits``). Removes the checkpoints."""
    import shutil
    import numpy as np
    from repro_torch.checkpoint.ckpt import load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = get_config(TRAIN_MODEL)
    t0 = time.perf_counter()
    like = {"params": keep["params"]}
    loaded, step, _ = load_checkpoint(keep["ckpt"], like)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    rows = SyntheticLM(cfg.vocab_size, max(TRAINED_PROMPTS),
                       len(TRAINED_PROMPTS)).global_batch_at(10_000)
    prompts = [rows["inputs"][i, :n].astype(np.int32)
               for i, n in enumerate(TRAINED_PROMPTS)]
    zero_launches()
    streams, logs = {}, {}
    for name, params in (("checkpoint", loaded["params"]),
                         ("in_memory", keep["params"])):
        eng = ServingEngine(cfg, params, max_batch=ENGINE_SLOTS,
                            max_seq=ENGINE_MAX_SEQ)
        log = instrument_engine(torch, eng)
        reqs = [Request(rid=i, prompt=p, max_new=TRAINED_MAX_NEW)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        engine_launch_check(log, cfg, f"serve_trained {name}")
        streams[name] = [list(map(int, r.out_tokens)) for r in reqs]
        logs[name] = log
        del eng
        gc.collect()
    launched = launches_now()
    same = streams["checkpoint"] == streams["in_memory"]
    emit("serve_trained", model=cfg.name, ckpt_step=step, load_s=load_s,
         prompts=list(TRAINED_PROMPTS), max_new=TRAINED_MAX_NEW,
         tokens_equal=same, tokens=streams["checkpoint"],
         structure_hits=[structure_hits(list(p[-1:]) + s, cfg.vocab_size)
                         for p, s in zip(prompts, streams["checkpoint"])],
         prefill_launches=[e["launches"] for e in logs["checkpoint"]
                           if e["step"] == "prefill"],
         kernel_launches=launched)
    if not same:
        raise AssertionError(f"serve_trained: the checkpoint's weights and "
                             f"the in-memory ones answer differently: "
                             f"{streams}")
    keep.clear()
    del loaded
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(train_ckpt_root(), ignore_errors=True)
    return {"serve-trained": launched}


# ---------------------------------------------------------------------------
# The serving entry point (launch/serve.py), the executor's per-op traces
# and the paged engine on the moe family
# ---------------------------------------------------------------------------

SERVE_REQUESTS, SERVE_BATCH = 64, 4     # 256 images at 224 px
SERVE_CLIENTS, SERVE_PIPELINE = 4, 4
SERVE_LM_PROMPTS = 8
SERVE_FLEET_REQUESTS = 48               # 4 bursts of 12
TRACE_RUNS = 300                        # benchmarks/run.py:163, Table 4
TRACE_RESNET_RUNS = 20
SERVE_CLI = ("--requests", "16", "--batch", "1", "--clients", "4",
             "--pipeline", "2")          # the reference's verify recipe


def percentiles(xs: list) -> dict:
    s = sorted(xs)
    q = lambda p: s[min(len(s) - 1, int(p * len(s)))]
    mean = sum(s) / len(s)
    sd = (sum((x - mean) ** 2 for x in s) / (len(s) - 1)) ** 0.5
    return {"n": len(s), "mean": mean, "p50": q(0.50), "p99": q(0.99),
            "max": s[-1], "cv_percent": 100.0 * sd / mean}


def phase_serve_resnet18(torch, seed: int) -> dict:
    """``launch.serve.serve_resnet`` at full width: fp32 ResNet-18 at 224
    px compiled as the JAX driver compiles it (batch 4), 4 client
    connections each pipelining 4 requests, SERVE_REQUESTS requests in
    all. The main run disables coalescing (``--batch-window 1``): every
    reply equals a local ``Executor.run`` of the same bytes on the same
    images bit for bit. Then the JAX driver's default window of 8, whose
    coalesced dispatches run the batched graph (the lanes' convolutions
    fold into one, so cuDNN may round otherwise): every reply within the
    ResNet-18 tolerance of the local run. Prints images/s, the clients'
    latency (send to reply) and the server's (its execution) p50, p99 and
    CV, and the dispatcher's counters."""
    import numpy as np
    from repro_torch.configs.resnet18 import CONFIG
    from repro_torch.launch import serve as serve_mod
    program = serve_mod.resnet_program(CONFIG, SERVE_BATCH, seed)
    runs, paths = {}, {}
    for window in (1, 8):
        zero_launches()                     # the main path starts here
        got = serve_mod.serve_resnet(
            SERVE_REQUESTS, SERVE_BATCH, SERVE_CLIENTS, SERVE_PIPELINE,
            batch_window=window, cfg=CONFIG, program=program,
            keep_replies=True)
        paths[f"serve-resnet18-window-{window}"] = launches_now()
        runs[window] = got
    plat, ex, bound, _, _ = local_platform(torch, program[1], program[0])
    checked = {}
    for window, got in runs.items():
        worst, n = 0.0, 0
        for replies in got["replies"]:
            for inputs, out in replies:
                want = ex.run(bound, inputs=inputs)["output"].cpu().numpy()
                reply = out["output"]
                if reply.shape != (SERVE_BATCH, CONFIG.num_classes) or \
                        not np.isfinite(reply).all():
                    raise AssertionError(f"serve_resnet18: a reply of "
                                         f"{reply.shape}, finite "
                                         f"{np.isfinite(reply).all()}")
                if window == 1 and not same_bits(reply, want):
                    raise AssertionError("serve_resnet18: a reply differs "
                                         "from the local run's bits")
                if not np.allclose(reply, want, atol=RESNET_ATOL,
                                   rtol=RESNET_RTOL):
                    raise AssertionError(f"serve_resnet18 (window {window}):"
                                         f" a reply off the local run by "
                                         f"{np.abs(reply - want).max()}")
                worst = max(worst, float(np.abs(reply - want).max()))
                n += 1
        if n != SERVE_REQUESTS:
            raise AssertionError(f"serve_resnet18: {n} replies")
        checked[window] = worst
    fields = {}
    for window, got in runs.items():
        tel = got["telemetry"]
        srv = tel["serving"]
        if srv["rejected"] or srv["shed"]:
            raise AssertionError(f"serve_resnet18: rejected "
                                 f"{srv['rejected']}, shed {srv['shed']}")
        fields[f"window_{window}"] = {
            "images_per_s": got["images_per_s"], "seconds": got["seconds"],
            "client_latency_s": percentiles(got["latencies_s"]),
            "server_exec_s": {k: tel.get(k) for k in
                              ("n", "mean", "p50", "p99", "cv_percent")},
            "batched": srv["batched"], "queue_wait_s": srv["queue_wait"],
            "processed": srv["processed"],
            "max_abs_err_vs_local_run": checked[window],
            "bit_identical_to_local_run": window == 1}
    emit("serve_resnet18", model=CONFIG.name, image_size=CONFIG.image_size,
         batch=SERVE_BATCH, clients=SERVE_CLIENTS, pipeline=SERVE_PIPELINE,
         requests=SERVE_REQUESTS, program_bytes=len(program[0]),
         image_bytes=len(program[1]), launches=paths, **fields)
    del runs, plat, ex, bound
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def phase_serve_lm(torch, seed: int) -> dict:
    """``launch.serve.serve_lm`` at full qwen2-1.5B width and depth (bf16,
    random weights from ``seed``): SERVE_LM_PROMPTS prompts of 16 tokens
    through ``ServingEngine`` (4 slots of 128 rows, the decode step one
    CUDA graph) under a ``DeadlineScheduler``, 8 new tokens each. Gates:
    28 ``flash_attention`` launches a prefill and 28 ``decode_attention`` a
    decode step (the decode graph's uncaptured warm-up step included), no
    shed, and the tokens equal a local engine's over the same weights on
    the eager decode step, bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = get_config("qwen2-1.5b")
    params = tf.init_params(cfg, seed)
    torch.cuda.synchronize()
    zero_launches()                         # the main path starts here
    got = serve_mod.serve_lm(SERVE_LM_PROMPTS, cfg=cfg, params=params)
    launches = launches_now()
    # the decode steps the engine took: those its telemetry summarised
    # and the 2 it left out as warm-up; building the engine's decode graph
    # ran one step uncaptured before the capture
    steps = got["decode_step"]["n"] + 2
    want = {name: 0 for name in launches} | {
        "flash_attention": cfg.num_layers * SERVE_LM_PROMPTS,
        "decode_attention": cfg.num_layers * (steps + 1)}
    if launches != want or got["shed"]:
        raise AssertionError(f"serve_lm: launched {launches}, not {want}; "
                             f"shed {got['shed']}")
    local = ServingEngine(cfg, params, max_batch=4,
                          max_seq=serve_mod.LM_MAX_SEQ)
    local._decode = make_decode_step(cfg)
    reqs = [Request(rid=i, prompt=p, max_new=serve_mod.LM_MAX_NEW)
            for i, p in enumerate(serve_mod.lm_prompts(cfg,
                                                       SERVE_LM_PROMPTS))]
    for r in reqs:
        local.submit(r)
    local.run_until_drained()
    same = [r.out_tokens == t for r, t in zip(reqs, got["tokens"])]
    ok_tokens = all(len(t) == serve_mod.LM_MAX_NEW + 1
                    and all(0 <= x < cfg.vocab_size for x in t)
                    for t in got["tokens"])
    if not (all(same) and ok_tokens):
        raise AssertionError(f"serve_lm: tokens equal the eager-step "
                             f"engine's {same}, in range {ok_tokens}")
    emit("serve_lm", model=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
         prompts=SERVE_LM_PROMPTS, prompt_tokens=serve_mod.LM_PROMPT,
         max_new=serve_mod.LM_MAX_NEW, max_seq=serve_mod.LM_MAX_SEQ,
         seconds=got["seconds"], tokens_per_s=got["tokens_per_s"],
         decode_step=got["decode_step"], launches=launches,
         flash_attention_per_prefill=cfg.num_layers,
         tokens_equal_eager_step_engine=True)
    del got, local, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"serve-lm": launches}


def phase_serve_fleet(torch) -> dict:
    """``launch.serve.serve_fleet`` as the JAX driver runs it: the GEMM
    chain of depth 8 and n 24 over ``TileMesh(2)``, scaled to 8 groups,
    hot-swapped, a group killed and healed, scaled back to the cached
    2-group mesh, SERVE_FLEET_REQUESTS requests. Gates: 0 mismatches, the
    scale back reports ``cached_mesh``, the swap commits, the tick
    replaces the dead group, and the reference reply equals a local
    ``Executor.run`` of the same bytes bit for bit."""
    from repro_torch.launch import serve as serve_mod
    zero_launches()                         # the main path starts here
    got = serve_mod.serve_fleet(SERVE_FLEET_REQUESTS, groups=2, peak=8)
    launches = launches_now()
    plat, ex, bound, _, _ = local_platform(torch, got["program"][1],
                                           got["program"][0])
    local = ex.run(bound, inputs={"input": got["input"]})
    same = all(same_bits(got["reference"][k], v.cpu())
               for k, v in local.items())
    scales = [(s["from"], s["to"], s.get("cached_mesh"))
              for s in got["scales"]]
    if not (got["mismatched"] == 0 and got["ok"] == SERVE_FLEET_REQUESTS
            and scales == [(2, 8, False), (8, 2, True)]
            and got["swap"] == "committed" and got["heal"][0] == "replace"
            and same):
        raise AssertionError(f"serve_fleet: ok {got['ok']} mismatched "
                             f"{got['mismatched']}, scales {scales}, swap "
                             f"{got['swap']}, heal {got['heal']}, reference "
                             f"equal to the local run {same}")
    emit("serve_fleet", depth=serve_mod.CHAIN_DEPTH, n=serve_mod.CHAIN_N,
         groups=2, peak=8, ok=got["ok"], mismatched=got["mismatched"],
         bursts=got["bursts"],
         scales=[{k: s.get(k) for k in ("from", "to", "cached_mesh",
                                        "seconds")} for s in got["scales"]],
         swap=got["swap"], heal=list(got["heal"]), events=got["events"],
         reference_equals_local_run=True, launches=launches)
    return {"serve-fleet": launches}


def by_op_ms(traces, skip: int = 0) -> dict:
    """Per opcode: the traced instances after the first ``skip`` of each,
    their mean and total ms."""
    by: dict = {}
    for t in traces:
        by.setdefault(t.op.name, []).append(t.seconds * 1e3)
    return {op: {"n": len(xs[skip:]),
                 "mean_ms": sum(xs[skip:]) / max(1, len(xs[skip:])),
                 "total_ms": sum(xs[skip:])} for op, xs in by.items()}


def phase_op_traces(torch, seed: int, resnet_keep: dict) -> dict:
    """``Executor.run(..., trace_ops=True)``: each op's host wall around
    its dispatch, the eager driver's per-op sync included, so device time
    too. The paper's Table 4 program (``compile_matmul(64,
    with_dma=True)``, benchmarks/run.py:151-170): TRACE_RUNS traced runs,
    the DMA_H2D, GEMM and DMA_D2H means after the first 10%. Then
    ResNet-18 INT8 at 224 px (``slice_resnet18_int8``'s program, image and
    requests): TRACE_RESNET_RUNS traced runs, the time by opcode, 20
    ``int8_matmul`` launches a run from its 20 CONV2D_I8. Gates: every
    traced output equals the untraced linked run's bit for bit, and one
    trace entry an op in program order."""
    import numpy as np
    from repro_torch.core import rbl, rctc, rimfs
    from repro_torch.core.executor import Executor
    rng = np.random.RandomState(seed)
    a = rng.randn(64, 64).astype(np.float32)
    b = rng.randn(64, 64).astype(np.float32)
    prog = rctc.compile_matmul(64, with_dma=True)
    fs = rimfs.mount(rimfs.pack({"b": b}))
    ex = Executor()
    bound = rbl.bind(prog, rimfs=fs, inputs={"a": a}, driver=ex.driver)
    want = ex.run(bound)["output"].cpu()
    ops = [op.op.name for op in prog.ops()]
    paths = {}
    zero_launches()                        # the traced path starts here
    ex.op_traces.clear()
    for _ in range(TRACE_RUNS):
        got = ex.run(bound, trace_ops=True)["output"]
        if not same_bits(got, want):
            raise AssertionError("op_traces: a traced Table 4 run differs "
                                 "from the untraced run")
    paths["op-traces-matmul"] = launches_now()
    if [t.op.name for t in ex.op_traces] != ops * TRACE_RUNS:
        raise AssertionError("op_traces: the Table 4 trace is not one entry "
                             "an op in program order")
    skip = TRACE_RUNS // 10
    table4 = {op: {"mean_us": v["mean_ms"] * 1e3, "n": v["n"]}
              for op, v in by_op_ms(ex.op_traces, skip).items()}

    prog_r, image = resnet_keep["prog"], resnet_keep["image"]
    requests = resnet_keep["requests"]
    plat, ex_r, bound_r, _, _ = local_platform(torch, image, prog_r.encode())
    want_r = [ex_r.run(bound_r, inputs=r)["output"] for r in requests]
    ops_r = [op.op.name for op in prog_r.ops()]
    t0 = time.perf_counter()
    ex_r.run(bound_r, inputs=requests[0])
    torch.cuda.synchronize()
    linked_s = time.perf_counter() - t0
    zero_launches()
    ex_r.op_traces.clear()
    walls = []
    for i in range(TRACE_RESNET_RUNS):
        req = i % len(requests)
        t1 = time.perf_counter()
        got = ex_r.run(bound_r, inputs=requests[req], trace_ops=True)
        walls.append(time.perf_counter() - t1)
        if not same_bits(got["output"], want_r[req]):
            raise AssertionError("op_traces: a traced ResNet-18 INT8 run "
                                 "differs from the untraced run")
    launches = launches_now()
    paths["op-traces-resnet18-int8"] = launches
    n_conv = ops_r.count("CONV2D_I8")
    if launches["int8_matmul"] != n_conv * TRACE_RESNET_RUNS or n_conv != 20 \
            or [t.op.name for t in ex_r.op_traces] != ops_r * \
            TRACE_RESNET_RUNS:
        raise AssertionError(f"op_traces: {launches} over "
                             f"{TRACE_RESNET_RUNS} runs of {n_conv} "
                             f"CONV2D_I8, or the trace is out of order")
    per_run = len(ops_r)
    by_op = by_op_ms(ex_r.op_traces[per_run:])      # the first run warms
    traced_ms = sum(v["total_ms"] for v in by_op.values()) / \
        (TRACE_RESNET_RUNS - 1)
    emit("op_traces", table4_program="compile_matmul(64, with_dma=True)",
         runs=TRACE_RUNS, skipped=skip, table4=table4,
         resnet18_int8={
             "image_size": 224, "runs": TRACE_RESNET_RUNS, "ops": per_run,
             "by_op_per_run": {op: {"n": v["n"] // (TRACE_RESNET_RUNS - 1),
                                    "mean_ms": v["mean_ms"],
                                    "ms_per_run": v["total_ms"]
                                    / (TRACE_RESNET_RUNS - 1)}
                               for op, v in sorted(
                                   by_op.items(),
                                   key=lambda kv: -kv[1]["total_ms"])},
             "traced_ops_ms_per_run": traced_ms,
             "traced_run_wall_s_p50": sorted(walls)[len(walls) // 2],
             "linked_run_wall_s": linked_s},
         bit_identical=True, launches=paths)
    del plat, ex_r, bound_r, ex, bound, fs
    return paths


def phase_slice_engine_paged_moe(torch, seed: int, keep: dict) -> dict:
    """The paged-KV engine on the moe family: moonshot-v1-16b-a3b at 48
    layers over the weights ``slice_engine_moe`` drew on the card
    (``keep``: the tensors and its dense streams), ``PagedServingEngine``
    (4 slots, max_seq 640, blocks of 16, 160 + 1 blocks, its 12 rungs
    captured when it is built) served by the InferenceServer: the six
    prompts, held until all are queued, each prefilled alone, decoded in
    windows of up to 8 tokens (``block_decode_paged`` routes every lane,
    padded ones too, through ``moe_ffn``). Gates: 48 ``flash_attention``
    launches a prefill and none in a window, and the six streams equal the
    dense engine's bit for bit. Prints tokens/s, the reply times, the
    per-token p50 (a window's wall over w), the windows by (bucket, w),
    the build seconds and ``kv_stats``."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.serving.paged_engine import PagedServingEngine
    from repro_torch.serving.server import Client, InferenceServer
    phase = "slice_engine_paged_moe"
    cfg = get_config(MOE_MODEL)
    prompts = engine_prompts(seed, cfg.vocab_size)
    n_req = len(prompts)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()                         # the main path starts here
    t0 = time.perf_counter()
    eng = PagedServingEngine(cfg, keep["params"], max_batch=ENGINE_SLOTS,
                             max_seq=ENGINE_MAX_SEQ, block_size=PAGED_BLOCK)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    zero_launches()                         # the rungs' warm-ups ran
    rungs = list(eng.program.artifacts["paged_decode"].captured)
    log = instrument_engine(torch, eng)
    server = InferenceServer(engine=eng)
    server.start()
    client = Client(server.address)
    try:
        served = engine_burst(server, client, eng, prompts, log, phase)
        launches = launches_now()
        serve_peak = torch.cuda.max_memory_allocated()
        telemetry = client.telemetry()
        client.shutdown()
    finally:
        client.close()
        server.stop()
    engine_launch_check(log, cfg, f"{phase} served")
    groups = prefill_groups(log)
    want = logged_launches(log, cfg)
    if len(groups) != n_req or launches != want:
        raise AssertionError(f"{phase}: the held burst launched {launches}, "
                             f"not {want} ({len(groups)} prefills)")
    tokens = served["tokens"]
    for i, tok in enumerate(tokens):
        if tok.shape != (ENGINE_MAX_NEW + 1,) or tok.dtype != np.int32 \
                or tok.min() < 0 or tok.max() >= cfg.vocab_size:
            raise AssertionError(f"{phase}: request {i} replied {tok}")
    dense_same = [t.tolist() == d for t, d in zip(tokens, keep["tokens"])]
    windows = [e for e in log if e["step"] == "decode"]
    walls = sorted(served["walls"])
    generated = n_req * (ENGINE_MAX_NEW + 1)
    emit(phase, model=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
         slots=ENGINE_SLOTS, max_seq=ENGINE_MAX_SEQ, block_size=PAGED_BLOCK,
         prompts=list(ENGINE_PROMPTS), max_new=ENGINE_MAX_NEW,
         build_s=build_s, rungs_captured=len(rungs),
         rungs_capture_s=sum(c["capture_s"] for c in rungs),
         kv_stats=telemetry["engine"].get("kv"),
         pool_bytes=eng.cache.pool_bytes(),
         serve_peak_memory_allocated=serve_peak, prefill_groups=groups,
         launches=launches, launches_per_window=0,
         windows=[e["shape"] for e in windows],
         window_wall_s=[e["wall_s"] for e in windows],
         served_prefills=[{k: e[k] for k in ("shape", "wall_s")}
                          for e in log if e["step"] == "prefill"],
         request_wall_s=served["walls"], first_four_replies_s=walls[3],
         last_two_replies_s=walls[-1], burst_s=served["burst_s"],
         tokens_per_s=generated / served["burst_s"],
         engine_decode_token=telemetry.get("engine"),
         dense_tokens_per_s=keep["tokens_per_s"],
         dense_engine_decode_step=keep["decode_step"],
         tokens_equal_dense_engine=dense_same)
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    if not all(dense_same):
        raise AssertionError(f"{phase}: the paged streams differ from the "
                             f"dense engine's: {dense_same}")
    return {phase: launches}


# ---------------------------------------------------------------------------
# Every LM architecture on the card: the configs no earlier phase serves, at
# full width, one after another, each drawn from the seed and freed before
# the next
# ---------------------------------------------------------------------------

# (model, layers served in bf16: None for the config's own depth; arctic's
# 957 GB of weights fit no card, its 2 layers 55.56 GB do)
ARCH_MODELS = (("qwen3-14b", None), ("phi3-medium-14b", None),
               ("mistral-nemo-12b", None), ("arctic-480b", 2),
               ("pixtral-12b", None), ("musicgen-medium", None))
ARCH_FP32_LAYERS = {"arctic-480b": 1}       # 56.5 GB in fp32; the rest 2
# the decode consistency check runs in fp64, but in fp32 where the fp64
# copy fits no card
ARCH_FP32_CONSISTENCY = ("arctic-480b",)    # one fp64 layer: 113 GB
ARCH_DECODE_TOL = 2e-3                      # test_models.py:97
ARCH_EMBED_STEPS = 32                       # decode steps on stub embeddings


def arch_inputs(torch, cfg, seed: int, seq: int):
    """(1, seq) prompt tokens, or a vlm or audio config's (1, seq, d)
    frontend stub embeddings (``patch_embed_stub``, ``frame_embed_stub``),
    fp32, on the card."""
    from repro_torch.models import frontends
    if cfg.input_kind == "tokens":
        tokens = engine_prompts(seed, cfg.vocab_size, (seq,))[0]
        return torch.as_tensor(tokens[None], device="cuda")
    stub = frontends.patch_embed_stub if cfg.family == "vlm" \
        else frontends.frame_embed_stub
    return torch.as_tensor(stub(cfg, 1, seq, seed), device="cuda")


def decode_cache(torch, cfg, batch: int, rows: int) -> dict:
    """A zero decode cache (``cache_specs``) of ``rows`` KV rows on the
    card (every config of this phase attends over its whole sequence: K
    and V are its whole decode state)."""
    from repro_torch.dtypes import torch_dtype
    from repro_torch.models import transformer as tf
    return {k: torch.zeros(s.shape, dtype=torch_dtype(s.dtype),
                           device="cuda")
            for k, s in tf.cache_specs(cfg, batch, rows).items()}


def splice(cache: dict, prefill: dict) -> dict:
    """``cache`` with a prefill's cache written into its first rows."""
    for k, c in cache.items():
        c[:, :, :prefill[k].shape[2]] = prefill[k]
    return cache


def spliced_cache(torch, cfg, cache: dict, rows: int) -> dict:
    """A decode cache of ``rows`` KV rows with a prefill's cache in its
    first rows."""
    return splice(decode_cache(torch, cfg, cache["k"].shape[1], rows),
                  cache)


def dropless_capacity(torch, cfg, params: dict, x) -> tuple:
    """A capacity factor under which ``forward_full`` on ``x`` drops no
    (token, choice) slot: the most slots any expert's buffer takes in a
    run at the config's own factor, plus one, over the mean load of a
    group of SEQ tokens. (The reference's dropless factor, the expert
    count, would give every expert a buffer of all the group's slots:
    some 20 GB of fp32 activations beside arctic's 56.5 GB of weights.)
    Returns (the factor, the run's ``router_gaps`` log at it)."""
    from repro_torch.models import transformer as tf

    def routed(c):
        log, inner = [], tf.moe_ffn
        tf.moe_ffn = router_gaps(torch, log)
        try:
            tf.forward_full(c, params, x)
        finally:
            tf.moe_ffn = inner
        return log
    load = max(e["max_load"] for e in routed(cfg))
    factor = (load + 1) * cfg.num_experts / (SEQ * cfg.experts_per_token)
    log = routed(dataclasses.replace(cfg, moe_capacity_factor=factor))
    if any(e["dropped"] for e in log):
        raise AssertionError(f"{cfg.name}: capacity factor {factor} still "
                             f"drops slots: {log}")
    return factor, log


def fp64_decode_and_full(torch, cfg, params: dict, x, pos) -> tuple:
    """The decode step at S after a prefill over S, and the full forward's
    logits at S over S + 1, both on the plain versions with the parameters
    and inputs in fp64 and every fp32 cast of the port's code taken to
    fp64 for the call (``fp64_train_grads``' way; RoPE's inverse
    frequencies stay fp32)."""
    from repro_torch.models import transformer as tf
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    cast = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        p64 = {k: v.double() for k, v in params.items()}
        x64 = x if cfg.input_kind == "tokens" else x.double()
        full = tf.forward_full(cfg64, p64, x64, impl="ref")[0][:, -1]
        _, cache, _ = tf.forward_full(cfg64, p64, x64[:, :SEQ],
                                      want_cache=True, impl="ref")
        step = tf.forward_decode(
            cfg64, p64, x64[:, SEQ:], pos,
            spliced_cache(torch, cfg64, cache, SEQ + 8), impl="ref")[0][:, 0]
    finally:
        torch.Tensor.float = cast
    return step, full


def arch_fp32_checks(torch, seed: int, model: str) -> dict:
    """``model`` at full width cut to 2 fp32 layers (1 for arctic-480b),
    weights from ``seed``, on tokens or the frontend stub's embeddings.
    Gates: ``forward_full`` over S = SEQ on the kernels against the same
    call with ``impl="ref"`` (max |err| of the logits within PROGRAM_ATOL),
    the first decode step after each of the two prefills, on the kernels
    and on their plain versions (the same), and
    the decode step at S against a full forward over S + 1 at the
    reference's own ``tests/test_models.py`` tolerance (rtol = atol =
    ARCH_DECODE_TOL), taken in fp64 (``fp64_decode_and_full``). In fp32
    the two orders of arithmetic cannot be held there at this init: on
    phi3-medium-14b each lies up to 4.3e-3 from its fp64 value on an H100
    (the ``fp32_*_vs_fp64`` fields), so the fp32 distances are printed
    beside it, ungated.
    arctic-480b's one fp64 layer (113 GB) fits no card: its check stays in
    fp32, run at ``dropless_capacity``, since a full forward routes token
    S in one group with the prompt, where the capacity may drop it, and a
    decode step routes it alone, where it never is."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_config(model), dtype="float32",
                              num_layers=ARCH_FP32_LAYERS.get(model, 2))
    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed)
    x = arch_inputs(torch, cfg, seed, SEQ + 1)
    pos = torch.full((1,), SEQ, dtype=torch.int32, device="cuda")
    prompt, nxt = x[:, :SEQ], x[:, SEQ:]
    out = {"layers": cfg.num_layers, "weight_bytes": sum(
        v.numel() * v.element_size() for v in params.values())}

    def prefill_decode(c, impl=None):
        """The prefill's logits over S and the decode step at S after it."""
        logits, cache, _ = tf.forward_full(c, params, prompt,
                                           want_cache=True, impl=impl)
        step, _ = tf.forward_decode(c, params, nxt, pos,
                                    spliced_cache(torch, c, cache, SEQ + 8),
                                    impl=impl)
        return logits, step

    def err(a, b):
        return (a.double() - b.double()).abs().max().item()
    logits, step = prefill_decode(cfg)
    plain, plain_step = prefill_decode(cfg, "ref")
    out["prefill_logits_max_abs_err"] = err(logits, plain)
    out["decode_logits_max_abs_err"] = err(step, plain_step)
    out["max_abs_logit"] = plain.abs().max().item()
    full_cfg, full_step = cfg, step
    if cfg.num_experts:
        factor, log = dropless_capacity(torch, cfg, params, x)
        full_cfg = dataclasses.replace(cfg, moe_capacity_factor=factor)
        full_step = prefill_decode(full_cfg)[1]
        out["consistency_capacity_factor"] = factor
        out["router_by_layer"] = log
    full = tf.forward_full(full_cfg, params, x)[0][:, -1]
    out["fp32_decode_vs_full_max_abs_err"] = err(full_step[:, 0], full)
    finite = all(bool(torch.isfinite(t).all())
                 for t in (logits, step, full_step, full))
    want_step, want_full = full_step[:, 0], full
    if model not in ARCH_FP32_CONSISTENCY:
        want_step, want_full = fp64_decode_and_full(torch, cfg, params, x,
                                                    pos)
        out["fp64_decode_vs_full_max_abs_err"] = err(want_step, want_full)
        out["fp32_decode_vs_fp64_max_abs_err"] = err(step[:, 0], want_step)
        out["fp32_full_vs_fp64_max_abs_err"] = err(full, want_full)
    out["consistency_dtype"] = str(want_step.dtype).removeprefix("torch.")
    consistent = bool(torch.allclose(want_step, want_full,
                                     rtol=ARCH_DECODE_TOL,
                                     atol=ARCH_DECODE_TOL))
    out["seconds"] = time.perf_counter() - t0
    del params, logits, step, plain, plain_step, full_step, full
    del want_step, want_full
    gc.collect()
    torch.cuda.empty_cache()
    if not (finite and out["prefill_logits_max_abs_err"] <= PROGRAM_ATOL
            and out["decode_logits_max_abs_err"] <= PROGRAM_ATOL
            and consistent):
        raise AssertionError(f"{model} at {cfg.num_layers} fp32 layers: "
                             f"{out} (finite {finite}; kernels against "
                             f"plain within {PROGRAM_ATOL}, decode against "
                             f"the full forward within {ARCH_DECODE_TOL})")
    return out


def arch_prefill(torch, cfg, params: dict, inputs) -> dict:
    """One B = 1 prefill of ``inputs`` on the served route: its host wall
    and device busy (``device_breakdown``), and every ``flash_attention``
    call in it against the plain version on the same operands
    (``kernels_in_model``, ENGINE_TOL of max |plain|): one a layer, or
    the phase fails."""
    from repro_torch.launch.steps import make_prefill_step
    prefill = make_prefill_step(cfg)

    def run():
        return prefill(params, {"inputs": inputs})
    checks = kernels_in_model(torch, run)
    summary = kernel_check_summary(checks)
    if [c["kernel"] for c in checks] != ["flash_attention"] * cfg.num_layers \
            or not all(c["ok"] for c in checks):
        raise AssertionError(f"{cfg.name}: the prefill's kernel calls "
                             f"{summary}, not {cfg.num_layers} within "
                             f"{ENGINE_TOL} of the plain version")
    timed = device_breakdown(torch, run, top=6)
    timed.pop("host_top", None)
    return {"kernel_calls_checked": summary, "prefill_1x512": timed}


def arch_serve_tokens(torch, cfg, params: dict, seed: int) -> tuple:
    """A token config through ``ServingEngine`` (ENGINE_SLOTS slots of
    ENGINE_MAX_SEQ rows, the decode step one CUDA graph): the engine
    cell's six prompts, ENGINE_MAX_NEW new tokens each, each prompt
    prefilled alone; then a second engine over the same weights on the
    eager decode step. Gates: the streams equal bit for bit, each prefill
    launches ``flash_attention`` once a layer, each decode step
    ``decode_attention`` once a layer. Returns (the line's fields, the main
    path's launches: the graph engine's run, counted from 0, and the first
    prompt as a (1, S) tensor)."""
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.serving.engine import Request, ServingEngine
    prompts = engine_prompts(seed, cfg.vocab_size)

    def serve(eager: bool):
        eng = ServingEngine(cfg, params, max_batch=ENGINE_SLOTS,
                            max_seq=ENGINE_MAX_SEQ)
        if eager:
            eng._decode = make_decode_step(cfg)
        log = instrument_engine(torch, eng)
        reqs = [Request(rid=i, prompt=p, max_new=ENGINE_MAX_NEW)
                for i, p in enumerate(prompts)]
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        wall = time.perf_counter() - t0
        engine_launch_check(log, cfg, f"{cfg.name} engine"
                            + (" eager" if eager else ""))
        return eng, log, [r.out_tokens for r in reqs], wall

    torch.cuda.reset_peak_memory_stats()
    zero_launches()                         # the main path starts here
    eng, log, tokens, wall = serve(eager=False)
    launches = launches_now()
    peak = torch.cuda.max_memory_allocated()
    pos = [len(p) for p in prompts[:ENGINE_SLOTS]]
    bound = decode_bytes_bound(cfg, params, eng._cache, pos)
    del eng
    _, eager_log, eager_tokens, eager_wall = serve(eager=True)
    same = [a == b for a, b in zip(tokens, eager_tokens)]
    if not all(same) or any(len(t) != ENGINE_MAX_NEW + 1 for t in tokens):
        raise AssertionError(f"{cfg.name}: the graph engine's streams "
                             f"differ from the eager step's: {same}")
    steps = sorted(e["wall_s"] for e in log if e["step"] == "decode")
    eager_steps = sorted(e["wall_s"] for e in eager_log
                         if e["step"] == "decode")
    generated = len(prompts) * (ENGINE_MAX_NEW + 1)
    fields = {
        "route": "ServingEngine", "slots": ENGINE_SLOTS,
        "max_seq": ENGINE_MAX_SEQ, "prompts": list(ENGINE_PROMPTS),
        "max_new": ENGINE_MAX_NEW, "peak_memory_allocated": peak,
        "prefill_groups": prefill_groups(log),
        "prefill_launches": [e["launches"]["flash_attention"] for e in log
                             if e["step"] == "prefill"],
        "served_prefill_wall_s": [e["wall_s"] for e in log
                                  if e["step"] == "prefill"],
        "decode_steps": len(steps), "decode_step_p50_s":
        steps[len(steps) // 2], "decode_step_max_s": steps[-1],
        "eager_decode_step_p50_s": eager_steps[len(eager_steps) // 2],
        "decode_bound_4_slots": bound, "request_wall_s": wall,
        "tokens_per_s": generated / wall,
        "eager_tokens_per_s": generated / eager_wall,
        "tokens_equal_eager_step_engine": same}
    return fields, launches, torch.as_tensor(prompts[0][None],
                                             device="cuda")


def arch_steps_embeddings(torch, cfg, params: dict, seed: int) -> tuple:
    """A vlm or audio config through the steps the reference runs it by:
    ``make_prefill_step`` on a (1, SEQ, d) frontend stub, then
    ARCH_EMBED_STEPS decode steps on the stub's next rows, each through
    ``CompiledDecodeStep`` (one CUDA graph, its static (1, 1, d) buffer
    in the config's dtype) and through the eager ``make_decode_step``
    from a copy of the same cache. Gates: each replay's logits equal the
    eager step's bit for bit, and the caches after the last step; the
    prefill launches ``flash_attention`` once a layer, each step (and the
    capture's warm-up) ``decode_attention`` once a layer.
    Returns (the line's fields, the main path's launches: the prefill and
    the replays, counted from 0, and the prefill's inputs)."""
    from repro_torch.dtypes import torch_dtype
    from repro_torch.launch.steps import (CompiledDecodeStep,
                                          make_decode_step,
                                          make_prefill_step)
    x = arch_inputs(torch, cfg, seed, SEQ + ARCH_EMBED_STEPS).to(
        torch_dtype(cfg.dtype))
    torch.cuda.reset_peak_memory_stats()
    zero_launches()                         # the main path starts here
    t0 = time.perf_counter()
    last, cache = make_prefill_step(cfg)(params, {"inputs": x[:, :SEQ]})
    torch.cuda.synchronize()
    prefill_wall = time.perf_counter() - t0
    prefill_launches_ = launches_now()
    # captured over a free cache, as the engine captures its step: the
    # warm-up run writes row 0; the prefill's rows go in after it
    held = decode_cache(torch, cfg, 1, ENGINE_MAX_SEQ)
    compiled = CompiledDecodeStep(cfg, params, held, 1)
    splice(held, cache)
    mirror = {k: v.clone() for k, v in held.items()}
    del cache
    eager = make_decode_step(cfg)
    walls, eager_walls, differ = [], [], []
    for t in range(ARCH_EMBED_STEPS):
        batch = {"inputs": x[:, SEQ + t:SEQ + t + 1],
                 "pos": torch.full((1,), SEQ + t, dtype=torch.int32,
                                   device="cuda")}
        t1 = time.perf_counter()
        got, _ = compiled(params, held, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        t1 = time.perf_counter()
        ref, _ = eager(params, mirror, batch)
        torch.cuda.synchronize()
        eager_walls.append(time.perf_counter() - t1)
        if not (torch.equal(got, ref) and bool(torch.isfinite(got).all())):
            differ.append(t)
    launches = launches_now()
    peak = torch.cuda.max_memory_allocated()
    cache_differ = [k for k in held if not torch.equal(held[k], mirror[k])]
    want_prefill = dict.fromkeys(launches, 0) | {
        "flash_attention": cfg.num_layers}
    want = want_prefill | {
        "decode_attention": cfg.num_layers * (1 + 2 * ARCH_EMBED_STEPS)}
    if differ or cache_differ or launches != want \
            or prefill_launches_ != want_prefill \
            or not bool(torch.isfinite(last).all()):
        raise AssertionError(f"{cfg.name}: replays differ from the eager "
                             f"step at steps {differ}, cache {cache_differ}; "
                             f"launches {launches} (prefill "
                             f"{prefill_launches_}), not {want}")
    bound = decode_bytes_bound(cfg, params, held, [SEQ])
    del held, mirror, compiled
    walls.sort()
    eager_walls.sort()
    fields = {
        "route": "make_prefill_step, CompiledDecodeStep and "
                 "make_decode_step on frontend stub embeddings",
        "input": [1, SEQ, cfg.d_model], "decode_steps": ARCH_EMBED_STEPS,
        "max_seq": ENGINE_MAX_SEQ, "peak_memory_allocated": peak,
        "prefill_wall_s": prefill_wall,
        "prefill_launches": prefill_launches_["flash_attention"],
        "decode_step_p50_s": walls[len(walls) // 2],
        "decode_step_max_s": walls[-1],
        "eager_decode_step_p50_s": eager_walls[len(eager_walls) // 2],
        "decode_bound_1_slot": bound, "replays_equal_eager_step": True}
    return fields, launches, x[:, :SEQ]


def phase_slice_arches(torch, seed: int) -> dict:
    """Every LM architecture no earlier phase serves, at full width with
    weights drawn on the card from ``seed``, one after another
    (``ARCH_MODELS``): qwen3-14b (qk-norm), phi3-medium-14b,
    mistral-nemo-12b, arctic-480b (128 experts top-2 beside a dense
    residual MLP; 2 layers, the one config no card holds whole), and the
    vlm and audio backbones, pixtral-12b and musicgen-medium, on their
    frontend stubs' embeddings. Each first at 2 fp32 layers (1 for
    arctic: ``arch_fp32_checks``), then at the depth it is served in bf16:
    the token configs through ``ServingEngine`` (``arch_serve_tokens``),
    the embeddings configs through the prefill and decode steps
    (``arch_steps_embeddings``); then one 1 x 512 prefill's time and
    kernel calls (``arch_prefill``). One ``slice_arches`` line a config;
    returns each config's main-path launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    by_path = {}
    for model, layers in ARCH_MODELS:
        free_before = torch.cuda.mem_get_info()[0]
        fp32 = arch_fp32_checks(torch, seed, model)
        cfg = get_config(model)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        t0 = time.perf_counter()
        params = tf.init_params(cfg, seed)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        if cfg.input_kind == "tokens":
            fields, launches, inputs = arch_serve_tokens(torch, cfg, params,
                                                         seed)
        else:
            fields, launches, inputs = arch_steps_embeddings(torch, cfg,
                                                             params, seed)
        fields.update(arch_prefill(torch, cfg, params, inputs))
        emit("slice_arches", model=model, family=cfg.family,
             input_kind=cfg.input_kind, layers=cfg.num_layers,
             config_layers=get_config(model).num_layers, dtype=cfg.dtype,
             attention_shape=[1, SEQ, cfg.num_heads, cfg.num_kv_heads,
                              cfg.head_dim],
             weight_bytes=sum(v.numel() * v.element_size()
                              for v in params.values()),
             free_bytes_before=free_before, init_s=init_s,
             fp32=fp32, launches=launches, **fields)
        by_path[f"slice_arches-{model}"] = launches
        del params, inputs
        gc.collect()
        torch.cuda.empty_cache()
    return by_path


GPU_TESTS = {"graphs_gpu_tests": "tests/test_torch_graphs_gpu.py",
             "engine_gpu_tests": "tests/test_torch_engine_gpu.py",
             "paged_gpu_tests": "tests/test_torch_paged_gpu.py",
             "partition_gpu_tests": "tests/test_torch_partition_gpu.py",
             "fleet_gpu_tests": "tests/test_torch_fleet_gpu.py",
             "autotune_gpu_tests": "tests/test_torch_autotune_gpu.py",
             "train_gpu_tests": "tests/test_torch_train_gpu.py",
             "kernels_gpu_tests": "tests/test_torch_kernels_gpu.py"}


# ---------------------------------------------------------------------------
# Distribution and the dry run: compressed all-reduce and the pipeline on a
# NCCL group of one rank, the data-parallel step at qwen2-1.5B's full size,
# the LM service on DTensors over a 1 x 1 mesh, the dry run's cells over a
# fake 256/512-rank group (in subprocesses beside the card's phases) and
# the FLOP count of a prefill on the card against its count on ``meta``
# ---------------------------------------------------------------------------

DIST_GRAD_SHAPE = (1536, 8960)            # qwen2-1.5B's MLP up-projection
DIST_PIPE = (4, 8, 1536)                  # microbatches (M, mb, d)
DP_STEPS, DP_LR = 2, 0.1
SHARDED_B, SHARDED_S, SHARDED_NEW = 2, SEQ, 8
ROOFLINE_SHAPE = (1, SEQ)                 # qwen2-1.5B's prefill (B, S)
DRYRUN_CELLS = (("qwen2-1.5b", "train_4k", False, "extrapolate"),
                ("qwen2-1.5b", "prefill_32k", False, "extrapolate"),
                ("qwen2-1.5b", "decode_32k", False, "extrapolate"),
                ("moonshot-v1-16b-a3b", "train_4k", True, "extrapolate"),
                ("hymba-1.5b", "long_500k", False, "extrapolate"),
                ("qwen2-1.5b", "train_4k", False, "full"),
                ("pixtral-12b", "prefill_32k", False, "extrapolate"),
                ("musicgen-medium", "decode_32k", False, "extrapolate"),
                ("rwkv6-1.6b", "train_4k", False, "extrapolate"))
DRYRUN_TIMEOUT = 600


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_dryrun() -> dict:
    """Every ``DRYRUN_CELLS`` cell through ``python -m
    repro_torch.launch.dryrun`` in a process of its own, all at once, with
    no card visible (the dry run runs on ``meta`` tensors only)."""
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    procs = {}
    for arch, shape, multipod, mode in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mode", mode, "--force"]
        if multipod:
            cmd.append("--multipod")
        procs[(arch, shape, multipod, mode)] = subprocess.Popen(
            cmd, cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    return procs


def phase_dryrun(procs: dict, t_start: float) -> None:
    """Collect the dry-run processes: each cell's record and its
    ``roofline.analyze`` row; the full-mode cell's totals must equal its
    extrapolated twin's exactly. A failure, or DRYRUN_TIMEOUT passed,
    raises, and no process outlives the phase."""
    from repro_torch.launch.roofline import DRYRUN_RESULTS as RESULTS
    from repro_torch.launch.roofline import analyze
    try:
        recs = {}
        for (arch, shape, multipod, mode), proc in procs.items():
            left = max(1.0, t_start + DRYRUN_TIMEOUT - time.perf_counter())
            try:
                out, err = proc.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"dryrun {arch} x {shape} ran past "
                                     f"{DRYRUN_TIMEOUT} s")
            if proc.returncode != 0:
                raise AssertionError(f"dryrun {arch} x {shape} ({mode}) "
                                     f"failed:\n{out[-3000:]}{err[-3000:]}")
            tag = "pod512" if multipod else "pod256"
            suffix = "__full" if mode == "full" else ""
            rec = json.loads((RESULTS / tag / f"{arch}__{shape}{suffix}.json")
                             .read_text())
            recs[(arch, shape, tag, mode)] = rec
            emit("dryrun", cell=f"{arch} x {shape} x {tag}", mode=mode,
                 record=rec, roofline=analyze(rec),
                 seconds=time.perf_counter() - t_start)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for (arch, shape, tag, mode), full in recs.items():
        if mode != "full":
            continue
        ext = recs[(arch, shape, tag, "extrapolate")]
        keys = ("flops_per_device", "bytes_per_device",
                "collective_bytes_per_device")
        same = {k: ext[k] == full[k] for k in keys}
        emit("dryrun_modes_agree", cell=f"{arch} x {shape} x {tag}",
             **{k: [ext[k], full[k]] for k in keys}, same=same)
        if not all(same.values()):
            raise AssertionError(f"dryrun {arch} x {shape}: the full trace's "
                                 f"totals differ from the extrapolation's "
                                 f"{same}")


def phase_distributed(torch, seed: int) -> None:
    """``compressed_psum`` and ``pipeline_forward`` on CUDA tensors over
    the running NCCL group of one rank: ``none`` gives g bit for bit,
    ``bf16`` g's bf16 round trip, ``int8_ef`` the plain formulas' value and
    error; the pipeline at one stage equals the stacked forward bit for
    bit."""
    from repro_torch.distributed.collectives import compressed_psum
    from repro_torch.distributed.pipeline import pipeline_forward
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(DIST_GRAD_SHAPE, generator=gen, device="cuda")
    t0 = time.perf_counter()
    r_none, _ = compressed_psum(g, None, "none")
    r_bf16, _ = compressed_psum(g, None, "bf16")
    r_int8, e_int8 = compressed_psum(g, None, "int8_ef")
    one, q127 = g.new_tensor(1.0), g.new_tensor(127.0)
    scale = torch.max(torch.abs(g)) + 1e-12
    q = torch.clamp(torch.round(g / scale * 127.0), -127, 127)
    want_int8 = q.to(torch.int32).float() * (scale / q127) / one
    want_err = g - q * (scale / q127)
    checks = {"none": torch.equal(r_none, g),
              "bf16": torch.equal(r_bf16, g.bfloat16().float()),
              "int8_ef": torch.equal(r_int8, want_int8),
              "int8_ef_error": torch.equal(e_int8, want_err)}
    ms = {m: cuda_ms(torch, lambda m=m: compressed_psum(g, None, m), 20, 3)
          for m in ("none", "bf16", "int8_ef")}
    ws = torch.randn((1, DIST_PIPE[2], DIST_PIPE[2]), generator=gen,
                     device="cuda") * DIST_PIPE[2] ** -0.5
    mbs = torch.randn(DIST_PIPE, generator=gen, device="cuda")

    def stage_fn(w, x):
        return torch.tanh(x @ w)
    got = pipeline_forward(stage_fn)(ws, mbs)
    want = torch.stack([stage_fn(ws[0], mb) for mb in mbs])
    checks["pipeline_one_stage"] = torch.equal(got, want)
    emit("distributed", backend="nccl", world=1, grad_shape=DIST_GRAD_SHAPE,
         pipeline_microbatches=DIST_PIPE, bit_for_bit=checks,
         compressed_psum_ms=ms, int8_ef_error_max=float(e_int8.abs().max()),
         seconds=time.perf_counter() - t0)
    if not all(checks.values()):
        raise AssertionError(f"distributed: {checks}")


def phase_dp_train_step(torch, seed: int) -> dict:
    """``make_dp_train_step`` at qwen2-1.5B's full width and 28 bf16 layers
    on ``SyntheticLM`` (B = TRAIN_BATCH, S = TRAIN_SEQ), a plain SGD update
    at DP_LR with the gradient clipped to a global norm of 1 (the
    reference's init gives this model gradients of norm ~1e16 at step 1,
    PERF.md's training findings: unclipped, step 2 is NaN), over the
    running NCCL group of one rank. With ``none``,
    DP_STEPS steps equal, bit for bit, the same loss and update applied
    without a group; with ``int8_ef``, step 1's loss equals the plain
    one's and the update's largest difference is printed."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.collectives import make_dp_train_step
    from repro_torch.launch.steps import make_loss_fn
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import global_norm
    cfg = get_config(TRAIN_MODEL)
    params = tf.init_params(cfg, seed)
    ds = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    batches = [{k: torch.as_tensor(v, device="cuda")
                for k, v in ds.global_batch_at(i).items()}
               for i in range(DP_STEPS)]
    total_fn = make_loss_fn(cfg, remat=True)
    losses: list = []

    def loss_fn(p, batch):
        total, (loss, _) = total_fn(p, batch)
        losses.append(float(loss.detach()))
        return total
    lr = torch.tensor(DP_LR, dtype=torch.float32, device="cuda")

    def sgd(p, grads):
        scale = torch.clamp(1.0 / (global_norm(grads) + 1e-9), max=1.0)
        return {k: (p[k].float() - lr * (grads[k] * scale)).to(p[k].dtype)
                for k in p}

    def plain_step(p, batch):
        leaves = {k: p[k].detach().requires_grad_(True) for k in sorted(p)}
        g = torch.autograd.grad(loss_fn(leaves, batch),
                                list(leaves.values()))
        with torch.no_grad():
            return sgd(p, {k: v.float() for k, v in zip(leaves, g)})
    zero_launches()
    t0 = time.perf_counter()
    p_plain = params
    for b in batches:
        p_plain = plain_step(p_plain, b)
    plain_losses = list(losses)
    t1 = time.perf_counter()
    losses.clear()
    step = make_dp_train_step(loss_fn, sgd, None, "none")
    p_dp, errors = params, None
    for b in batches:
        p_dp, errors = step(p_dp, b, errors)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    dp_losses = list(losses)
    differ = [k for k in p_plain if not torch.equal(p_plain[k], p_dp[k])]
    del p_dp, errors
    losses.clear()
    p_int8, err8 = make_dp_train_step(loss_fn, sgd, None, "int8_ef")(
        params, batches[0], None)
    int8_loss = losses[0]
    losses.clear()
    p1 = plain_step(params, batches[0])
    diff = max(float((p_int8[k].float() - p1[k].float()).abs().max())
               for k in p1)
    moved = max(float((p1[k].float() - params[k].float()).abs().max())
                for k in p1)
    launched = launches_now()
    emit("dp_train_step", model=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=DP_STEPS,
         lr=DP_LR, world=1, plain_losses=plain_losses, dp_losses=dp_losses,
         none_params_differ=differ, n_leaves=len(p_plain),
         int8_ef_step1_loss=int8_loss, plain_step1_loss=plain_losses[0],
         int8_ef_update_max_diff=diff, update_max_move=moved,
         int8_ef_error_max=max(float(e.abs().max()) for e in err8.values()),
         plain_s=t1 - t0, dp_s=t2 - t1, launches=launched)
    if differ or dp_losses != plain_losses or int8_loss != plain_losses[0] \
            or not moved > 0 or not all(map(math.isfinite, dp_losses)):
        raise AssertionError(f"dp_train_step: {len(differ)} leaves differ "
                             f"{differ[:4]}; losses {dp_losses} against "
                             f"{plain_losses}; int8_ef loss {int8_loss}")
    del params, p_plain, p_int8, err8, p1
    gc.collect()
    torch.cuda.empty_cache()
    return {"dp-train-step": launched}


def phase_sharded_lm_service(torch, seed: int) -> dict:
    """qwen2-1.5B at full width and depth (bf16, random weights from
    ``seed``) on a 1 x 1 CUDA ``DeviceMesh`` under ``axis_rules(mesh,
    "decode")``: params placed by ``param_shardings``,
    ``compile_lm_service``, ``resolve_shardings`` giving ``tokens`` a
    placement, and the program's prefill and decode artifacts on DTensors
    (a prefill of B = SHARDED_B prompts of SHARDED_S tokens, then
    SHARDED_NEW greedy decode steps). Gates: logits and tokens equal, bit
    for bit, the same steps on plain tensors (their decode attention on
    the plain version, ``impl="ref"``: a sharded cache attends on those
    stock ops, plain tensors on the ``decode_attention`` kernel); 28
    ``flash_attention`` launches a prefill, through the kernel's sharding
    rule."""
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.core import rctc
    from repro_torch.core.rbl import bind, resolve_shardings
    from repro_torch.distributed.sharding import (axis_rules, place,
                                                  sharding_for)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import param_shardings, place_params
    cfg = get_config("qwen2-1.5b")
    B, S = SHARDED_B, SHARDED_S
    params = tf.init_params(cfg, seed)
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         dtype=torch.int32).cuda()
    cspecs = tf.cache_specs(cfg, B, S + SHARDED_NEW)

    def local(x):
        return x.to_local() if isinstance(x, DTensor) else x

    def serve(p, sharded: bool):
        prog = rctc.compile_lm_service(cfg, B, S, make_prefill_step(cfg),
                                       make_decode_step(cfg))
        sh = resolve_shardings(prog)
        bind(prog, inputs={})
        t = place(toks, sharding_for(toks.shape, ("batch", None)))
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        logits, pc = prog.artifacts["prefill"](p, {"inputs": t})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches = launches_now()
        cache = {k: torch.zeros(s.shape, dtype=local(pc[k]).dtype,
                                device="cuda") for k, s in cspecs.items()}
        for k in cache:
            cache[k][:, :, :S] = local(pc[k])
        if sharded:
            cache = place_params(cache, param_shardings(cspecs))
        steps = [local(logits)]
        tokens = [torch.argmax(local(logits), -1).to(torch.int32)]
        t0 = time.perf_counter()
        for i in range(SHARDED_NEW):
            nxt = tokens[-1][:, None]
            pos = torch.full((B,), S + i, dtype=torch.int32, device="cuda")
            batch = {"inputs": place(nxt, sharding_for(nxt.shape,
                                                       ("batch", None))),
                     "pos": place(pos, sharding_for(pos.shape, ("batch",)))}
            if sharded:
                lg, cache = prog.artifacts["decode"](p, cache, batch)
            else:
                lg, cache = tf.forward_decode(cfg, p, batch["inputs"],
                                              batch["pos"], cache,
                                              impl="ref")
                lg = lg[:, 0]
            steps.append(local(lg))
            tokens.append(torch.argmax(local(lg), -1).to(torch.int32))
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        return {"shardings": sh, "logits": steps, "tokens": tokens,
                "launches": launches, "prefill_s": prefill_s,
                "decode_s": decode_s,
                "dtensor_cache": all(isinstance(v, DTensor)
                                     for v in cache.values())}
    plain = serve(params, False)
    mesh = make_test_mesh((1, 1))
    with axis_rules(mesh, "decode"):
        ps = place_params(params, param_shardings(tf.model_specs(cfg)))
        got = serve(ps, True)
    tokens_sharding = got["shardings"]["tokens"]
    same_logits = [torch.equal(a, b) for a, b in zip(got["logits"],
                                                     plain["logits"])]
    same_tokens = all(torch.equal(a, b) for a, b in zip(got["tokens"],
                                                        plain["tokens"]))
    want = {name: 0 for name in got["launches"]} | {
        "flash_attention": cfg.num_layers}
    emit("sharded_lm_service", model=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, mesh=[1, 1], rules="decode", batch=B, seq=S,
         new_tokens=SHARDED_NEW,
         params_are_dtensors=all(isinstance(v, DTensor)
                                 for v in ps.values()),
         cache_is_dtensor=got["dtensor_cache"],
         tokens_placement=None if tokens_sharding is None
         else [str(pl) for pl in tokens_sharding[1]],
         logits_bit_for_bit=same_logits, tokens_bit_for_bit=same_tokens,
         prefill_launches=got["launches"],
         prefill_s={"dtensor": got["prefill_s"], "plain": plain["prefill_s"]},
         decode_s={"dtensor": got["decode_s"], "plain": plain["decode_s"]})
    if tokens_sharding is None or not all(same_logits) or not same_tokens \
            or got["launches"] != want or plain["launches"] != want:
        raise AssertionError(
            f"sharded_lm_service: tokens placement {tokens_sharding}, "
            f"logits equal {same_logits}, tokens equal {same_tokens}, "
            f"launches {got['launches']} / {plain['launches']} not {want}")
    del params, ps, plain, got
    gc.collect()
    torch.cuda.empty_cache()
    return {"sharded-lm-service": want}


def phase_roofline_check(torch, seed: int) -> dict:
    """qwen2-1.5B's prefill at ROOFLINE_SHAPE on the card under
    ``CostMode``: its FLOP count must equal the same step's on ``meta``;
    the device time by CUDA events beside the roofline's compute and
    memory terms (H100 datasheet rates)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.cost import CostMode
    from repro_torch.launch.roofline import H100_HBM_BW, H100_PEAK_FLOPS
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import shape_structs
    cfg = get_config("qwen2-1.5b")
    B, S = ROOFLINE_SHAPE
    params = tf.init_params(cfg, seed)
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         dtype=torch.int32).cuda()
    step = make_prefill_step(cfg)
    zero_launches()
    with CostMode("cuda") as on_card:
        step(params, {"inputs": toks})
    launched = launches_now()
    with CostMode("meta") as on_meta:
        step(shape_structs(tf.model_specs(cfg)),
             {"inputs": torch.empty((B, S), dtype=torch.int32,
                                    device="meta")})
    card, meta = on_card.record(), on_meta.record()
    ms = cuda_ms(torch, lambda: step(params, {"inputs": toks}), 10, 2)
    compute_ms = card["flops"] / H100_PEAK_FLOPS * 1e3
    memory_ms = card["bytes"] / H100_HBM_BW * 1e3
    emit("roofline_check", model=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, shape=list(ROOFLINE_SHAPE),
         flops_card=card["flops"], flops_meta=meta["flops"],
         bytes_card=card["bytes"], bytes_meta=meta["bytes"],
         temp_bytes_card=card["temp_bytes"], device_ms=ms,
         compute_ms=compute_ms, memory_ms=memory_ms,
         roofline_fraction=max(compute_ms, memory_ms) / ms,
         peak_flops=H100_PEAK_FLOPS, hbm_bytes_per_s=H100_HBM_BW,
         launches=launched)
    if card["flops"] != meta["flops"] or card["flops"] <= 0:
        raise AssertionError(f"roofline_check: {card['flops']} FLOPs on the "
                             f"card, {meta['flops']} on meta")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"roofline-check": launched}


def stop_all(procs) -> None:
    """Kill every process of ``procs`` and reap it."""
    for proc in procs:
        proc.kill()
        proc.communicate()


def phases_distribution(torch, seed: int, procs: dict,
                        t_start: float) -> dict:
    """The distribution and dry-run phases: the card's phases run on a
    NCCL group of one rank that ends with them, then the dry run's cells
    (``procs``, started at ``t_start`` by ``start_dryrun``) are read."""
    import torch.distributed as dist
    by_path: dict = {}
    try:
        dist.init_process_group(
            "nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
            world_size=1, device_id=torch.device("cuda", 0))
        try:
            phase_distributed(torch, seed)
            by_path.update(phase_dp_train_step(torch, seed))
            by_path.update(phase_sharded_lm_service(torch, seed))
        finally:
            dist.destroy_process_group()
        by_path.update(phase_roofline_check(torch, seed))
    except BaseException:
        stop_all(procs.values())
        raise
    phase_dryrun(procs, t_start)
    return by_path


def start_gpu_tests(phase: str):
    """Start one card-only test file (the compiled dispatch path's, the
    engine's compiled steps' or the paged windows') in a process of its
    own; ``-s`` lets the per-op diagnoses print their ``GROUPED_PREFILL``
    and ``PAGED_VS_DENSE`` lines."""
    root = Path(__file__).resolve().parent
    return subprocess.Popen(
        [sys.executable, "-m", "pytest", "-q", "-s", "-m", "gpu",
         "-p", "no:cacheprovider", GPU_TESTS[phase]],
        cwd=root, env={**os.environ, "PYTHONPATH": str(root / "src")},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def start_serve_cli():
    """``python -m repro_torch.launch.serve`` with the reference's verify
    recipe's flags (SERVE_CLI) and no ``--device``: on the card."""
    root = Path(__file__).resolve().parent
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *SERVE_CLI],
        cwd=root, env={**os.environ, "PYTHONPATH": str(root / "src")},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def phase_gpu_tests() -> None:
    """The card-only test files, each in a process of its own, all at
    once (each is small beside the card), and beside them the serving
    entry point's CLI as a user runs it (``serve_cli``: exit code 0, its
    throughput line with nothing rejected or shed); one phase line a
    process, with the ``GROUPED_PREFILL`` and ``PAGED_VS_DENSE`` lines
    kept. A failure, or 600 s passed, raises, and no process outlives the
    phase."""
    t0 = time.perf_counter()
    procs = {phase: start_gpu_tests(phase) for phase in GPU_TESTS}
    cli = start_serve_cli()
    try:
        try:
            out, err = cli.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            raise AssertionError("the serve CLI ran past 600 s")
        lines = [ln for ln in out.splitlines() if ln.startswith("[serve]")]
        emit("serve_cli", argv=list(SERVE_CLI), rc=cli.returncode,
             seconds=time.perf_counter() - t0, lines=lines)
        if cli.returncode != 0 or not any(
                "rejected=0 shed=0" in ln for ln in lines):
            raise AssertionError("the serve CLI failed:\n" + out[-3000:]
                                 + err[-3000:])
        for phase, proc in procs.items():
            left = max(1.0, t0 + 600 - time.perf_counter())
            try:
                out, err = proc.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{GPU_TESTS[phase]} ran past 600 s")
            lines = out.strip().splitlines()
            marked = {}
            for mark in ("GROUPED_PREFILL ", "PAGED_VS_DENSE ",
                         "STREAM_ORDER ", "FREED_EDGE ", "FLIP_ORDER ",
                         "SWAP_MEMORY ", "AUTOTUNE_GPU "):
                # after a test's progress dot, maybe
                found = [json.loads(ln[ln.index(mark) + len(mark):])
                         for ln in lines if mark in ln]
                if found:
                    marked[mark.strip().lower()] = found
            emit(phase, rc=proc.returncode,
                 seconds=time.perf_counter() - t0, summary=lines[-1:],
                 **marked)
            if proc.returncode != 0:
                raise AssertionError(f"{GPU_TESTS[phase]} failed:\n"
                                     + out[-6000:] + err[-3000:])
    finally:
        for proc in [*procs.values(), cli]:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
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
                or "spill" in ln or "smem" in ln],
         int8_matmul_sass=int8_matmul_sass())

    # 2. kernels against their plain versions
    rows = [phase_attention(torch, args.seed),
            phase_ssm_scan(torch, args.seed, info["ptxas"]),
            phase_wkv6(torch, args.seed),
            phase_int8_matmul(torch, args.seed),
            phase_decode_attention(torch, args.seed)]
    # the kernel autotune cache: swept, reloaded at provision, served
    by_path = phase_autotune(torch, args.seed)

    # 3. two-layer full-width fp32 programs
    models = {"slice": get_config("qwen2-1.5b"),
              "slice_hybrid": get_config("hymba-1.5b"),
              "slice_ssm": get_config("rwkv6-1.6b")}
    for cfg in models.values():
        phase_two_layer_fp32(torch, cfg, args.seed)

    phase_two_layer_fp32(torch, get_config(MOE_MODEL), args.seed)

    # 4. the served paths, at full depth; each kernel's launches on each,
    # fused and batched too
    qwen2_keep, resnet_keep = {}, {}
    for phase, cfg in models.items():
        by_path.update(phase_slice(torch, cfg, args.seed, phase,
                                   qwen2_keep if phase == "slice" else None))

    # 5. the served vision and INT8 paths
    for out in ("float32", "bfloat16"):
        by_path.update(phase_slice_matmul_int8(torch, args.seed, out))
    by_path.update(phase_slice_resnet(torch, args.seed, int8=False))
    by_path.update(phase_slice_resnet(torch, args.seed, int8=True,
                                      keep=resnet_keep))

    # 6b. tile groups: qwen2-1.5B and ResNet-18 INT8 over 1, 2 and 4
    # groups, the stream schedule, failover, and the server's mesh route
    by_path.update(phase_slice_partitioned(torch, qwen2_keep))
    by_path.update(phase_slice_partitioned_resnet(torch, args.seed,
                                                  resnet_keep))
    phase_partitioned_failover(torch, args.seed, resnet_keep)
    by_path.update(phase_served_mesh(torch, resnet_keep))
    # 6c. the fleet and overload control plane over the mesh
    by_path.update(phase_slice_fleet(torch, args.seed, resnet_keep,
                                     qwen2_keep))
    # the executor's per-op traces: Table 4's program, ResNet-18 INT8
    by_path.update(phase_op_traces(torch, args.seed, resnet_keep))
    qwen2_keep.clear()
    resnet_keep.clear()
    gc.collect()
    torch.cuda.empty_cache()
    # the serving entry point: ResNet-18 over the wire, the LM engine at
    # full qwen2-1.5B, the fleet demo at 8 groups
    by_path.update(phase_serve_resnet18(torch, args.seed))
    by_path.update(phase_serve_lm(torch, args.seed))
    by_path.update(phase_serve_fleet(torch))

    # 7. the LM serving engine: at reduced depth, then served at full depth
    # (qwen2-1.5B, dense then paged; hymba-1.5B and rwkv6-1.6B, the
    # recurrent families)
    prompts = engine_prompts(args.seed, get_config("qwen2-1.5b").vocab_size)
    phase_engine_reduced_depth(torch, args.seed, "qwen2-1.5b", prompts, 2,
                               "bfloat16", gate_recompute=False)
    phase_engine_reduced_depth(torch, args.seed, "qwen2-1.5b", prompts, 1,
                               "float32", gate_recompute=True)
    keep: dict = {}
    by_path.update(phase_slice_engine(torch, args.seed, "slice_engine", keep))
    # the paged-KV engine: at one fp32 layer, then at full depth over the
    # image slice_engine pinned
    phase_engine_paged_reduced_depth(torch, args.seed, prompts)
    by_path.update(phase_slice_engine_paged(torch, args.seed, keep))
    # the brown-out ladder's LM rungs over slice_engine's pinned image
    by_path.update(phase_slice_fleet_lm(torch, args.seed, keep))
    keep.clear()
    gc.collect()
    torch.cuda.empty_cache()
    hymba_vocab = get_config("hymba-1.5b").vocab_size
    phase_engine_reduced_depth(
        torch, args.seed, "hymba-1.5b",
        engine_prompts(args.seed, hymba_vocab, RING_PROMPTS + ENGINE_PROMPTS),
        1, "float32", gate_recompute=True, max_seq=RING_MAX_SEQ)
    by_path.update(phase_slice_engine(torch, args.seed,
                                      "slice_engine_hybrid"))
    phase_engine_reduced_depth(
        torch, args.seed, "rwkv6-1.6b",
        engine_prompts(args.seed, get_config("rwkv6-1.6b").vocab_size), 1,
        "float32", gate_recompute=True)
    by_path.update(phase_slice_engine(torch, args.seed, "slice_engine_ssm"))
    # the moe family: moonshot's 2-layer program served, its engine at one
    # dropless fp32 layer, then at full depth with its weights on the card
    moe2 = dataclasses.replace(get_config(MOE_MODEL), num_layers=2)
    moe_paths = phase_slice(torch, moe2, args.seed, "slice_moe")
    by_path.update({f"{k}-2-layers": v for k, v in moe_paths.items()})
    moe_cfg = get_config(MOE_MODEL)
    phase_engine_reduced_depth(
        torch, args.seed, MOE_MODEL,
        engine_prompts(args.seed, moe_cfg.vocab_size), 1, "float32",
        gate_recompute=True, capacity=float(moe_cfg.num_experts))
    moe_keep: dict = {}
    by_path.update(phase_slice_engine(torch, args.seed, "slice_engine_moe",
                                      moe_keep))
    # the paged engine over the same 48 layers, against the dense streams
    by_path.update(phase_slice_engine_paged_moe(torch, args.seed, moe_keep))
    moe_keep.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # the dry run's cells start in CPU-only processes beside the card's
    # last phases and are read last. Training: one full-width fp32 step
    # against the CPU, then qwen2-1.5B trained through the entry point,
    # restarted from its step-20 checkpoint, and served from its step-30
    # checkpoint; every LM architecture no phase above serves, at full
    # width; then distribution (compressed all-reduce, the pipeline, the
    # data-parallel step, the LM service on DTensors, the roofline's FLOP
    # count on the card)
    t_dry = time.perf_counter()
    dry = start_dryrun()
    try:
        phase_train_two_layer_fp32(torch, args.seed)
        trained: dict = {}
        by_path.update(phase_slice_train(torch, args.seed, trained))
        by_path.update(phase_serve_trained(torch, args.seed, trained))
        by_path.update(phase_slice_arches(torch, args.seed))
    except BaseException:
        stop_all(dry.values())
        raise
    by_path.update(phases_distribution(torch, args.seed, dry, t_dry))

    # the card-only tests of the fused and batched graphs and of the
    # engine's compiled steps
    phase_gpu_tests()

    # 8. the kernels line, then the card, then the contract line
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
