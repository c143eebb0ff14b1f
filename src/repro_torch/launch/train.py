"""Training driver: the end-to-end training entry point (the port's
counterpart of ``repro.launch.train``).

Runs real steps on one device: synthetic shardable data, AdamW,
CRC-checkpointing with async saves, RTPM heartbeats and step telemetry,
restart from the latest good checkpoint on relaunch.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --smoke --steps 200 --d-model 256 --device cpu

It takes the JAX package's flags plus ``--device`` (default ``cuda``:
without CUDA it raises, unless ``--device cpu`` is asked for) and
``--seed`` (the parameters' draw). Each step is timed on the host up to a
device sync. ``main`` returns a summary (``main(argv)`` is how a script
drives the entry point itself): the final parameters and optimizer state,
each step's loss, ``grad_norm``, lr and wall, the saves' and the
restore's seconds, and the ``TrainStep`` it ran.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Optional

from repro_torch import device as device_mod
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.rtpm import Platform
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.dtypes import as_tensor
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import adamw_init

WARMUP = 20


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (e.g. ~100M model: 768)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def config_for(args: argparse.Namespace):
    """The JAX driver's config: the arch (its smoke config with
    ``--smoke``), with ``--d-model`` and ``--layers`` overrides."""
    cfg = get_config(args.arch + ("-smoke" if args.smoke else ""))
    if args.d_model:
        head_dim = max(16, args.d_model // max(1, cfg.num_heads or 12))
        head_dim -= head_dim % 2                      # RoPE needs even dims
        cfg = dataclasses.replace(
            cfg, d_model=args.d_model, d_ff=args.d_model * 4,
            head_dim=head_dim if cfg.num_heads else 0,
            vocab_size=min(cfg.vocab_size, 8192))
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    return cfg


def main(argv: Optional[list] = None) -> dict:
    args = parse_args(argv)
    cfg = config_for(args)
    dev = device_mod.resolve(args.device)
    platform = Platform(device=dev)
    n_params = sum(math.prod(s.shape) for s in tf.model_specs(cfg).values())
    print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, 1 device(s) "
          f"({dev})", flush=True)

    params = tf.init_params(cfg, args.seed, dev)
    opt = adamw_init(params)
    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    start, restore_s = 0, None
    t0 = time.perf_counter()
    restored = mgr.restore_latest({"params": params, "opt": opt})
    if restored is not None:
        state, start, _ = restored
        params, opt = state["params"], state["opt"]
        device_mod.synchronize(dev)
        restore_s = time.perf_counter() - t0
        print(f"[train] restored checkpoint at step {start}", flush=True)

    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                     global_batch=args.batch)
    step_fn = make_train_step(cfg, peak_lr=args.lr, warmup=WARMUP,
                              total_steps=args.steps)

    losses, grad_norms, lrs, walls = {}, {}, {}, {}
    for i in range(start, args.steps):
        t_step = time.perf_counter()
        batch = {k: as_tensor(v, dev)
                 for k, v in ds.global_batch_at(i).items()}
        params, opt, m = step_fn(params, opt, batch)
        device_mod.synchronize(dev)
        wall = time.perf_counter() - t_step
        platform.heartbeats.beat("worker0", step=i)
        platform.telemetry.record_latency(wall)
        losses[i + 1] = float(m["loss"])
        grad_norms[i + 1] = float(m["grad_norm"])
        lrs[i + 1] = float(m["lr"])
        walls[i + 1] = wall
        if (i + 1) % args.log_every == 0:
            print(f"  step {i+1:5d} loss={losses[i + 1]:.4f} "
                  f"lr={lrs[i + 1]:.2e} "
                  f"gnorm={grad_norms[i + 1]:.2f}", flush=True)
        if (i + 1) % args.ckpt_every == 0:
            mgr.save({"params": params, "opt": opt}, step=i + 1)
    mgr.save({"params": params, "opt": opt}, step=args.steps, block=True)
    s = platform.telemetry.summary(warmup=3)
    if s.get("n", 0) > 2:
        print(f"[train] done. step latency mean={s['mean']*1e3:.1f}ms "
              f"CV={s['cv_percent']:.2f}% p99={s['p99']*1e3:.1f}ms",
              flush=True)
    return {"params": params, "opt": opt, "start": start,
            "param_count": n_params,
            "losses": losses, "grad_norms": grad_norms, "lrs": lrs,
            "step_wall_s": walls, "restore_s": restore_s,
            "saves": list(mgr.saves), "step": step_fn}


if __name__ == "__main__":
    main()
