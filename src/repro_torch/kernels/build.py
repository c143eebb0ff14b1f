"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source under ``kernels/*/csrc/`` compiles to an object file in its own
``nvcc`` process, all started together, then one link makes
``build/kernels/libaeg_kernels.so`` at the repository root. The library
exposes a plain C interface: every pointer and the stream cross as
``c_void_p``. The build runs at first use in a process and is skipped when
a library built from the same sources and flags is already there. An
``flock`` on ``build/kernels/.lock`` covers the whole build, so processes
building at once (pytest workers, a smoke run beside them) take turns.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parent
REPO_ROOT = _PKG.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
LIB_NAME = "libaeg_kernels.so"
SOURCES = (_PKG / "common" / "csrc" / "common.cu",
           _PKG / "flash_attention" / "csrc" / "flash_attention.cu",
           _PKG / "decode_attention" / "csrc" / "decode_attention.cu",
           _PKG / "ssm_scan" / "csrc" / "ssm_scan.cu",
           _PKG / "wkv6" / "csrc" / "wkv6.cu",
           _PKG / "int8_matmul" / "csrc" / "int8_matmul.cu")
HEADERS = (_PKG / "common" / "csrc" / "common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine with the card")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    return h.hexdigest()


@contextlib.contextmanager
def _build_lock():
    """Exclusive across processes and threads: each call opens its own
    file description, and ``flock`` locks conflict between descriptions."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build() -> dict:
    """Compile and link the library if it is missing or stale. Returns
    ``{"seconds", "built", "ptxas"}``; ``ptxas`` holds the register and
    shared-memory report of every kernel that was compiled."""
    t0 = time.perf_counter()
    with _build_lock():
        lib = BUILD_DIR / LIB_NAME
        stamp = BUILD_DIR / (LIB_NAME + ".sha256")
        digest = _digest()
        if lib.exists() and stamp.exists() and stamp.read_text() == digest:
            return {"seconds": time.perf_counter() - t0, "built": False,
                    "ptxas": ""}
        exe = nvcc()
        jobs = []
        for src in SOURCES:
            obj = BUILD_DIR / (src.stem + ".o")
            jobs.append((src, subprocess.Popen(
                [exe, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, proc in jobs:
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = BUILD_DIR / (LIB_NAME + f".tmp{os.getpid()}")
        objs = [str(BUILD_DIR / (src.stem + ".o")) for src in SOURCES]
        link = subprocess.run([exe, "-shared", "-o", str(tmp), *objs],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp, lib)
        stamp.write_text(digest)
        return {"seconds": time.perf_counter() - t0, "built": True,
                "ptxas": "".join(logs)}


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    build()
    lib = ctypes.CDLL(str(BUILD_DIR / LIB_NAME))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.aeg_flash_attention.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32,
                                        i32, i32, i32, ctypes.c_float, i32,
                                        vp]
    lib.aeg_flash_attention.restype = i32
    lib.aeg_decode_attention.argtypes = [vp] * 8 + [i32] * 10 + [vp]
    lib.aeg_decode_attention.restype = i32
    lib.aeg_ssm_scan_ring.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32,
                                      i32, i32, i32, i32, vp]
    lib.aeg_ssm_scan_ring.restype = i32
    lib.aeg_ssm_scan_rowwise.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32,
                                         i32, vp]
    lib.aeg_ssm_scan_rowwise.restype = i32
    lib.aeg_wkv6.argtypes = [vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32,
                             i32, i32, vp]
    lib.aeg_wkv6.restype = i32
    lib.aeg_wkv6_scratch_floats.argtypes = [i32, i32, i32, i32]
    lib.aeg_wkv6_scratch_floats.restype = ctypes.c_longlong
    lib.aeg_int8_matmul.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32,
                                    i32, i32, vp]
    lib.aeg_int8_matmul.restype = i32
    lib.aeg_cuda_error_string.argtypes = [i32]
    lib.aeg_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.aeg_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
