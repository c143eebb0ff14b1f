"""Fault-tolerance walkthrough on the PyTorch port: heartbeat failure ->
checkpoint restart -> elastic re-binding.

Simulates a 4-worker fleet training data-parallel. Worker 2 dies mid-run
(heartbeat deadline); RTPM detects it, training restarts from the latest
CRC-valid checkpoint on the surviving fleet, and the deterministic data
pipeline replays the exact global batches — final params match the
uninterrupted run bit-for-bit. The training step updates its parameters
and moments in place, so each run starts from a copy of the initial state.

    PYTHONPATH=src python examples/torch_elastic_restart.py              # the card
    PYTHONPATH=src python examples/torch_elastic_restart.py --device cpu
"""
import argparse
import pathlib
import shutil

from repro_torch import device as device_mod
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.rtpm import HeartbeatMonitor
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.dtypes import as_tensor
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamWState, adamw_init

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--ckpt-dir", default=str(
    pathlib.Path(__file__).resolve().parent.parent / "build"
    / "torch_elastic"))
args = ap.parse_args()
dev = device_mod.resolve(args.device)

cfg = get_config("qwen2-1.5b-smoke")
params0 = tf.init_params(cfg, 0, dev)
opt0 = adamw_init(params0)
ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
step = make_train_step(cfg, peak_lr=1e-3, warmup=5, total_steps=40)


def fresh():
    """A copy of the initial parameters and optimizer state."""
    return ({k: v.clone() for k, v in params0.items()},
            AdamWState(step=opt0.step.clone(),
                       m={k: v.clone() for k, v in opt0.m.items()},
                       v={k: v.clone() for k, v in opt0.v.items()}))


def batch(i):
    return {k: as_tensor(v, dev) for k, v in ds.global_batch_at(i).items()}


# --- uninterrupted reference run (20 steps) --------------------------------
p, o = fresh()
for i in range(20):
    p, o, _ = step(p, o, batch(i))
ref = p

# --- fleet run with a failure ----------------------------------------------
clock = [0.0]
mon = HeartbeatMonitor(deadline=5.0, clock=lambda: clock[0])
shutil.rmtree(args.ckpt_dir, ignore_errors=True)
mgr = CheckpointManager(args.ckpt_dir, keep=2, async_save=False)
workers = [f"w{i}" for i in range(4)]

p, o = fresh()
for i in range(12):
    clock[0] += 1.0
    for w in workers:
        mon.beat(w, step=i)
    p, o, _ = step(p, o, batch(i))
    if (i + 1) % 5 == 0:
        mgr.save({"params": p, "opt": o}, step=i + 1)

print("step 12: worker w2 stops heartbeating...")
workers.remove("w2")
clock[0] += 6.0
for w in workers:
    mon.beat(w, step=12)
verdict = mon.check()
print(f"RTPM verdict: failed={verdict['failed']}")
assert verdict["failed"] == ["w2"]

print("restarting from latest CRC-valid checkpoint on 3 workers...")
like_p, like_o = fresh()
state, start, _ = mgr.restore_latest({"params": like_p, "opt": like_o})
p, o = state["params"], state["opt"]
print(f"restored step {start}; data pipeline re-shards deterministically "
      f"({ds.global_batch} rows -> 3-worker layout not required: global "
      "batch identity is shard-count independent)")
for i in range(start, 20):
    p, o, _ = step(p, o, batch(i))

diff = max(float((ref[k].float() - p[k].float()).abs().max()) for k in ref)
print(f"max param diff vs uninterrupted run: {diff:.2e}")
assert diff < 1e-6
shutil.rmtree(args.ckpt_dir, ignore_errors=True)
print("OK — failure detected, restart bit-exact, fleet shrunk 4 -> 3.")
