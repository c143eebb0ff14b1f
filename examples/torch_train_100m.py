"""Train a ~100M-parameter qwen2-family model on the synthetic pipeline,
through the PyTorch port's training entry point
(``python -m repro_torch.launch.train``).

Full training substrate: AdamW + cosine schedule, CRC checkpoints with
async save, RTPM telemetry. Shaped for the card (--steps 300 there); on the
CPU use --width 256 --device cpu for a quick functional pass.

    PYTHONPATH=src python examples/torch_train_100m.py [--steps N] [--width D]
    PYTHONPATH=src python examples/torch_train_100m.py --width 256 --steps 4 --device cpu
"""
import argparse
import pathlib
import subprocess
import sys

if __name__ == "__main__":
    root = pathlib.Path(__file__).resolve().parent.parent
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--width", type=int, default=768,
                    help="768 -> ~108M params; 256 for a CPU-speed pass")
    ap.add_argument("--ckpt-dir", default=str(root / "build" / "torch_100m_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--arch", "qwen2-1.5b",
           "--d-model", str(args.width), "--layers", "12",
           "--steps", str(args.steps), "--batch", "8", "--seq-len", "256",
           "--lr", "1e-3", "--ckpt-dir", args.ckpt_dir,
           "--ckpt-every", "20", "--device", args.device]
    sys.exit(subprocess.call(cmd))
