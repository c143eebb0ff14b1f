"""End-to-end driver on the PyTorch port (the paper's kind:
network-attached inference).

Spins up the CRC-framed socket service, provisions ResNet-18 over the wire
(RIMFS image + RCB program — the paper's remote provisioning flow), streams
batched requests, and prints the latency/CV telemetry that Table 3 reports;
every reply is held against the plain forward pass at 1e-5.

    PYTHONPATH=src python examples/torch_serve_resnet18.py [n_requests]
    PYTHONPATH=src python examples/torch_serve_resnet18.py 8 --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch import device as device_mod
from repro_torch.configs.resnet18 import CONFIG
from repro_torch.core import rctc
from repro_torch.dtypes import as_tensor, to_host
from repro_torch.models import resnet as rn
from repro_torch.serving.server import Client, InferenceServer

ap = argparse.ArgumentParser()
ap.add_argument("n_requests", nargs="?", type=int, default=32)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
dev = device_mod.resolve(args.device)
n_requests = args.n_requests
batch = 4

cfg = CONFIG.smoke()
params = rn.init_resnet(cfg, 0, dev)
prog, image = rctc.compile_resnet18(cfg, rn.fold_bn(params), batch=batch)

server = InferenceServer(device=dev)
addr = server.start()
print(f"serving on {addr} ({dev})")
try:
    client = Client(addr)
    print("provision:", client.provision(image, prog.encode()))
    rng = np.random.RandomState(0)
    ref_match = 0
    t0 = time.perf_counter()
    for i in range(n_requests):
        x = rng.rand(batch, cfg.image_size, cfg.image_size, 3) \
            .astype(np.float32)
        out = client.infer(input=x)["output"]
        ref = to_host(rn.resnet_forward(cfg, params, as_tensor(x, dev)))
        ref_match += int(np.allclose(out, ref, atol=1e-5))
    dt = time.perf_counter() - t0
    tel = client.telemetry()
    print(f"{n_requests} requests x batch {batch}: "
          f"{n_requests*batch/dt:.1f} img/s | "
          f"mean={tel['mean']*1e3:.2f} ms  CV={tel['cv_percent']:.2f}%  "
          f"p99={tel['p99']*1e3:.2f} ms")
    print(f"responses matching local oracle: {ref_match}/{n_requests}")
    client.close()
finally:
    server.stop()
