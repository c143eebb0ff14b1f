"""Quickstart on the PyTorch port: the AEG Control-as-Data pipeline.

Builds a small neural pipeline, translates it to Runtime Control Blocks
(RCTC), packs weights into a RIMFS image, serializes the *whole workload to
bytes* (control really is data), then provisions + binds + executes it on
the generic engine in both linked (host-walked) and fused (one CUDA graph
on the card) modes.

    PYTHONPATH=src python examples/torch_quickstart.py              # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np

from repro_torch import device as device_mod
from repro_torch.core import rctc, rimfs
from repro_torch.core.executor import Executor
from repro_torch.core.rtpm import Platform
from repro_torch.dtypes import to_host

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
dev = device_mod.resolve(args.device)

rng = np.random.RandomState(0)

# 1. Offline toolchain: model -> RCB program + weight image -------------
prog = rctc.compile_conv_relu_softmax(n=2, h=16, w=16, cin=3, cout=10)
weights = {"w_conv": rng.randn(3, 3, 3, 10).astype(np.float32) * 0.3}
image = rimfs.pack(weights)

# control-as-data: the workload is plain bytes (CRC-protected)
program_bytes = prog.encode()
print(f"RCB program: {len(program_bytes)} bytes, "
      f"{sum(len(b.ops) for b in prog.blocks)} ops; "
      f"RIMFS image: {len(image)} bytes")

# 2. Provision (RTPM): load RCBs + weights into the in-memory FS ---------
platform = Platform(device=dev)
platform.provision(image=image, program_bytes=program_bytes)
print(f"time-to-service: {platform.time_to_service()*1e3:.2f} ms "
      f"on {dev}")

# 3. Bind (RBL): symbolic IDs -> physical buffers on the device ----------
x = rng.randn(2, 16, 16, 3).astype(np.float32)
bound = platform.bind(inputs={"input": x})

# 4. Dispatch + Sync: the generic fetch-decode-dispatch engine ------------
ex = Executor(driver=platform.driver, rtpm=platform)
out_eager = to_host(ex.run(bound)["output"])
print("linked output:", np.round(out_eager[0], 3))

fused = ex.fuse(platform.bind())        # one CUDA graph for the stream
out_fused = to_host(fused({"input": x}, ex.weights_from(bound))["output"])
print("fused  output:", np.round(out_fused[0], 3))

diff = float(np.max(np.abs(out_eager - out_fused)))
print(f"linked == fused: max|diff| = {diff:.2e}")
assert diff < 1e-6
print("OK — same RCBs drive both execution environments.")
