"""Production mesh construction (the port's counterpart of
``repro.launch.mesh``).

A function, not a module-level constant, so importing this module never
touches a process group. Single-pod: 16x16 = 256 ranks, axes ("data",
"model"). Multi-pod: 2x16x16 = 512 ranks, axes ("pod", "data", "model"):
the "pod" axis composes with "data" for batch sharding (DP across pods; TP
stays inside a pod). Both are ``DeviceMesh``es over the process group
already started: a real one of that size, or the dry run's ``fake`` group
(``launch/dryrun.py``), whose ranks are placeholders.
"""
from __future__ import annotations

import math

CARDS_PER_HOST = 8          # one H100 NVLink node


def _device_type() -> str:
    """The device type a mesh over the running group lives on: the card
    under NCCL, the CPU under gloo, and ``meta`` under the dry run's fake
    group (on a CPU mesh DTensor would stand an all-gather in for every
    all-to-all, as gloo has none)."""
    import torch.distributed as dist
    backend = dist.get_backend()
    if backend == "fake":
        _meta_topology()
        return "meta"
    return "cuda" if backend == "nccl" else "cpu"


def _meta_topology() -> None:
    """DTensor's cost model asks the device type's module how many devices
    a host holds, and ``meta`` has none: the placeholder ranks of a meta
    mesh are ``CARDS_PER_HOST`` H100s a host, as on an NVLink node."""
    from torch.distributed import device_mesh as dm
    res = dm._mesh_resources
    if getattr(res, "_aeg_meta_topology", False):
        return
    per_host = res.num_devices_per_host

    def num_devices_per_host(device_type: str) -> int:
        if device_type == "meta":
            return CARDS_PER_HOST
        return per_host(device_type)
    res.num_devices_per_host = num_devices_per_host
    res._aeg_meta_topology = True


def _mesh(shape: tuple, axes: tuple, what: str):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"{what} {shape} needs a process group of {n} ranks and none is "
            "started — the dry-run entrypoint starts a fake one of 512 "
            "ranks before anything else")
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(
            f"{what} {shape} needs {n} ranks, have {world} — the dry-run "
            "entrypoint must start its fake process group of 512 ranks "
            "before building a mesh")
    ranks = torch.arange(n).reshape(shape)
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, "mesh")


def make_test_mesh(shape=(2, 2), axes=("data", "model")):
    """A small mesh over the first prod(shape) ranks of the running group
    (tests, and one card's 1x1 mesh)."""
    return _mesh(tuple(shape), tuple(axes), "test mesh")
