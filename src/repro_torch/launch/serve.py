"""Serving driver: the network-attached inference service (the paper's
mode), the port's counterpart of ``repro.launch.serve``.

Starts the CRC-framed socket server, provisions the ResNet-18 case study
(or an LM engine with --lm), fires batched client requests at it —
optionally from several concurrent connections, each pipelining v2
request-id frames — and reports latency CV + dispatcher telemetry.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 64
  PYTHONPATH=src python -m repro_torch.launch.serve --requests 64 --clients 4
  PYTHONPATH=src python -m repro_torch.launch.serve --lm --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --fleet --requests 48

--fleet runs the elastic-operations demo: a FleetController scales the
live tile mesh up and back down, hot-swaps the weight image (probe +
atomic flip), and survives a tile-group kill — all under the same
client traffic, with every response checked against the first.

It takes the JAX package's flags plus ``--device`` (default ``cuda``:
without CUDA it raises, unless ``--device cpu`` is asked for) and
``--seed`` (the weights' draw). Each mode is a function that takes its
configuration as a keyword (the JAX driver's by default) and its program
and image bytes, or its parameters, from the caller when given, so the
same traffic runs at full width or over another package's bytes. Each
prints the JAX driver's lines and returns a summary; ``main(argv)``
returns the mode's.
"""
from __future__ import annotations

import argparse
import threading
import time
from typing import Optional

import numpy as np

from repro_torch import device as device_mod
from repro_torch.configs import get_config
from repro_torch.configs.resnet18 import CONFIG as RESNET
from repro_torch.core import rctc, rhal, rimfs
from repro_torch.core.fleet import FleetController
from repro_torch.models import resnet as rn
from repro_torch.models import transformer as tf
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.scheduler import DeadlineScheduler
from repro_torch.serving.server import Client, InferenceServer

LM_CONFIG = "qwen2-1.5b-smoke"
LM_MAX_SEQ, LM_PROMPT, LM_MAX_NEW = 128, 16, 8
CHAIN_DEPTH, CHAIN_N = 8, 24


def resnet_program(cfg=None, batch: int = 4, seed: int = 0,
                   device="cuda") -> tuple:
    """(program bytes, image bytes) of fp32 ResNet-18 at ``batch``: the
    weights drawn from ``seed`` on ``device``, BN folded, compiled."""
    cfg = cfg or RESNET.smoke()
    params = rn.init_resnet(cfg, seed, device)
    prog, image = rctc.compile_resnet18(cfg, rn.fold_bn(params), batch=batch)
    return prog.encode(), image


def _shares(requests: int, clients: int) -> list:
    """--requests spread exactly: the first ``requests % clients``
    connections take one extra."""
    return [requests // clients + (1 if c < requests % clients else 0)
            for c in range(clients)]


def serve_resnet(requests: int, batch: int, clients: int, pipeline: int,
                 batch_window: int = 8, *, cfg=None, program=None,
                 seed: int = 0, device="cuda",
                 keep_replies: bool = False) -> dict:
    """Serve ResNet-18 to ``clients`` connections, each pipelining
    ``pipeline`` requests of ``batch`` images (client c's images from
    ``np.random.RandomState(c)``). ``program`` is a (program bytes, image
    bytes) pair; by default ``resnet_program(cfg, batch, seed, device)``.
    Returns the throughput, each request's client-side latency (send to
    reply), the server's telemetry and, with ``keep_replies``, every
    (inputs, outputs) pair by client."""
    cfg = cfg or RESNET.smoke()
    dev = device_mod.resolve(device)
    prog_bytes, image = program or resnet_program(cfg, batch, seed, dev)
    server = InferenceServer(batch_window=batch_window, device=dev)
    addr = server.start()
    print(f"[serve] listening on {addr}")
    try:
        c0 = Client(addr)
        print("[serve] provision:", c0.provision(image, prog_bytes))
        shares = _shares(requests, clients)
        counts = [0] * clients
        latencies: list = [[] for _ in range(clients)]
        replies: list = [[] for _ in range(clients)]
        errors: list = []

        def run_client(cid: int) -> None:
            client = c0 if cid == 0 else Client(addr)
            rng = np.random.RandomState(cid)
            per_client = shares[cid]
            done = 0
            try:
                for _ in range(0, per_client, pipeline):
                    sent = []
                    for _ in range(min(pipeline, per_client - done)):
                        x = rng.rand(batch, cfg.image_size, cfg.image_size,
                                     3).astype(np.float32)
                        sent.append((x, time.perf_counter(),
                                     client.infer_async(input=x)))
                    for x, t_send, rid in sent:
                        out = client.result(rid)
                        latencies[cid].append(time.perf_counter() - t_send)
                        if keep_replies:
                            replies[cid].append(({"input": x}, out))
                        done += 1
            except BaseException as e:              # re-raised below
                errors.append(e)
            finally:
                counts[cid] = done
                if cid != 0:
                    client.close()

        t0 = time.perf_counter()
        threads = [threading.Thread(target=run_client, args=(cid,))
                   for cid in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0
        if errors:
            raise errors[0]
        n = sum(counts)
        tel = c0.telemetry()
        srv = tel.get("serving", {})
        print(f"[serve] {n} requests x batch {batch} over {clients} "
              f"client(s) (pipeline depth {pipeline}): "
              f"{n*batch/dt:.1f} img/s; "
              f"CV={tel.get('cv_percent', 0):.2f}% "
              f"p99={tel.get('p99', 0)*1e3:.2f}ms; "
              f"dispatcher processed={srv.get('processed')} "
              f"rejected={srv.get('rejected')} shed={srv.get('shed')} "
              f"batched={srv.get('batched', {}).get('requests', 0)}reqs/"
              f"{srv.get('batched', {}).get('dispatches', 0)}dispatches "
              f"queue_wait_p95="
              f"{srv.get('queue_wait', {}).get('p95', 0)*1e3:.2f}ms")
        c0.close()
    finally:
        server.stop()
    return {"requests": n, "batch": batch, "clients": clients,
            "pipeline": pipeline, "seconds": dt, "images_per_s": n * batch / dt,
            "latencies_s": [x for per in latencies for x in per],
            "telemetry": tel, "program": (prog_bytes, image),
            "replies": replies if keep_replies else None}


def gemm_chain_program(depth: int = CHAIN_DEPTH, n: int = CHAIN_N) -> tuple:
    """(program bytes, image bytes) of the fleet demo's GEMM chain."""
    return (rctc.compile_gemm_chain(depth, n).encode(),
            rimfs.pack(rctc.gemm_chain_weights(depth, n)))


def serve_fleet(requests: int, groups: int = 2, peak: int = 8, *,
                depth: int = CHAIN_DEPTH, n: int = CHAIN_N, program=None,
                device="cuda") -> dict:
    """Elastic fleet demo: scale cycle + kill/heal + hot swap under
    sustained traffic, every response bit-compared to the first reply.
    ``program`` is a (program bytes, image bytes) pair of an n x n chain;
    by default ``gemm_chain_program(depth, n)``. Returns the counts, each
    burst's mean latency, the scale reports and the fleet's events."""
    dev = device_mod.resolve(device)
    prog_bytes, image = program or gemm_chain_program(depth, n)
    server = InferenceServer(mesh=rhal.TileMesh(groups, device=dev),
                             max_queue=256, device=dev)
    addr = server.start()
    print(f"[fleet] listening on {addr}, mesh={groups} groups")
    fleet = FleetController(server)
    ok = bad = 0
    bursts, scales = [], []
    try:
        client = Client(addr, retries=10, backoff=0.02, retry_seed=0)
        client.provision(image, prog_bytes)
        x = np.random.RandomState(0).randn(n, n).astype(np.float32)
        ref = client.infer(input=x)

        def burst(count: int, label: str) -> None:
            nonlocal ok, bad
            t0 = time.perf_counter()
            for _ in range(count):
                out = client.infer(input=x)
                if all(np.array_equal(ref[k], out[k]) for k in ref):
                    ok += 1
                else:
                    bad += 1
            mean_s = (time.perf_counter() - t0) / count
            bursts.append({"label": label, "requests": count,
                           "mean_s": mean_s})
            print(f"[fleet] {label}: {count} requests, "
                  f"{mean_s * 1e3:.2f}ms avg, bit_identical={bad == 0}")

        share = max(4, requests // 4)
        burst(share, f"baseline @{groups}")
        rep = fleet.scale_to(peak)
        scales.append(rep)
        print(f"[fleet] scaled {rep['from']} -> {rep['to']} in "
              f"{rep['seconds'] * 1e3:.1f}ms")
        burst(share, f"scaled @{peak}")
        swap = fleet.swap_weights(image, label="repack")
        print(f"[fleet] hot swap: {swap}")
        burst(share, "post-swap")
        server.mesh.kill(peak - 1)
        heal = fleet.tick()
        print(f"[fleet] killed group {peak - 1}; tick -> "
              f"{heal['action']}")
        burst(share, "post-heal")
        rep = fleet.scale_to(groups)
        scales.append(rep)
        print(f"[fleet] scaled back -> {rep['to']} "
              f"(cached_mesh={rep.get('cached_mesh')})")
        events = dict(fleet.summary()["events"])
        print(f"[fleet] done: ok={ok} mismatched={bad} events={events}")
        client.close()
    finally:
        fleet.stop()
        server.stop()
    return {"ok": ok, "mismatched": bad, "reference": ref, "input": x,
            "bursts": bursts, "scales": scales, "swap": swap,
            "heal": heal["action"], "events": events,
            "program": (prog_bytes, image)}


def lm_prompts(cfg, requests: int) -> list:
    """The JAX driver's prompts: ``LM_PROMPT`` tokens each from
    ``np.random.RandomState(0)``."""
    rng = np.random.RandomState(0)
    return [rng.randint(0, cfg.vocab_size, (LM_PROMPT,)).astype(np.int32)
            for _ in range(requests)]


def serve_lm(requests: int, *, cfg=None, params: Optional[dict] = None,
             seed: int = 0, device="cuda") -> dict:
    """Greedy LM serving through ``ServingEngine`` (4 slots of
    ``LM_MAX_SEQ`` rows) under a ``DeadlineScheduler``: ``requests``
    prompts of ``LM_PROMPT`` tokens, ``LM_MAX_NEW`` new tokens each.
    ``cfg`` defaults to qwen2-1.5b-smoke, ``params`` to
    ``tf.init_params(cfg, seed, device)``. Returns each prompt's tokens,
    tokens/s and the decode-step telemetry."""
    cfg = cfg or get_config(LM_CONFIG)
    dev = device_mod.resolve(device)
    if params is None:
        params = tf.init_params(cfg, seed, dev)
    sched = DeadlineScheduler()
    eng = ServingEngine(cfg, params, max_batch=4, max_seq=LM_MAX_SEQ,
                        scheduler=sched, device=dev)
    reqs = [Request(rid=i, prompt=p, max_new=LM_MAX_NEW)
            for i, p in enumerate(lm_prompts(cfg, requests))]
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in reqs)
    s = eng.telemetry.summary(warmup=2)
    print(f"[serve-lm] {requests} prompts, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s); decode-step "
          f"CV={s.get('cv_percent', 0):.2f}%; shed={sched.shed_count}")
    return {"tokens": [list(r.out_tokens) for r in reqs], "seconds": dt,
            "tokens_per_s": toks / dt, "decode_step": s,
            "shed": sched.shed_count}


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--clients", type=int, default=1,
                    help="concurrent client connections")
    ap.add_argument("--pipeline", type=int, default=4,
                    help="in-flight pipelined requests per connection")
    ap.add_argument("--batch-window", type=int, default=8,
                    help="dispatcher coalescing window (1 disables)")
    ap.add_argument("--lm", action="store_true")
    ap.add_argument("--fleet", action="store_true",
                    help="elastic fleet demo: scale cycle, hot swap, "
                         "kill/heal under traffic")
    ap.add_argument("--groups", type=int, default=2,
                    help="--fleet: starting mesh size")
    ap.add_argument("--peak", type=int, default=8,
                    help="--fleet: scale-cycle peak mesh size")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv: Optional[list] = None) -> dict:
    args = parse_args(argv)
    dev = device_mod.resolve(args.device)
    if args.fleet:
        return serve_fleet(args.requests, groups=args.groups,
                           peak=args.peak, device=dev)
    if args.lm:
        return serve_lm(args.requests, seed=args.seed, device=dev)
    return serve_resnet(args.requests, args.batch, args.clients,
                        args.pipeline, batch_window=args.batch_window,
                        seed=args.seed, device=dev)


if __name__ == "__main__":
    main()
