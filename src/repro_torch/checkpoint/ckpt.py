"""Checkpointing on the RIMFS image format: CRC-verified, async,
restartable (the port's counterpart of ``repro.checkpoint.ckpt``).

A checkpoint is a RIMFS image (flat, aligned, per-file CRC-32): the
training state flattens to named tensors keyed as
``jax.tree_util.keystr`` keys them (``_flatten``), packs into one image
with a ``__meta__`` JSON file, and is written atomically (a ``.tmp`` file,
then a rename). The same state saved by either package gives the same
bytes, and each package loads the other's files. ``CheckpointManager``
adds async saves (the state is copied to the host first, then packed and
written on a thread while training goes on), retention, and latest-good
discovery that skips a torn or corrupt file by its CRC.

``flatten`` keys a parameter dict alone, as the engines' weight images
(``serving.engine.pack_params_image``) are keyed.
"""
from __future__ import annotations

import json
import pathlib
import struct
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import rimfs as rimfs_mod


def flatten(params: dict) -> dict:
    """{"['name']": leaf} in the order ``jax.tree_util`` flattens a dict."""
    return _flatten(params)


def _leaves(tree: Any, prefix: str = "") -> list:
    """[(key, leaf)] in ``jax.tree_util.tree_flatten_with_path``'s order,
    each key what ``keystr`` makes of its path: a dict's entries in sorted
    key order as ``[<repr(key)>]``, a NamedTuple's fields in field order
    as ``.<field>``, a list's or tuple's items as ``[<index>]``; None is an
    empty subtree; anything else is a leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaves(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields
                for kv in _leaves(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _leaves(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _flatten(tree: Any, prefix: str = "") -> dict:
    """{keystr key: leaf} of every leaf of ``tree``, in flattening order."""
    return dict(_leaves(tree, prefix))


def _rebuild(like: Any, leaves: iter) -> Any:
    """``like``'s structure with its leaves taken from ``leaves`` in
    flattening order."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def _meta_file(flat: dict, step: int, extra: Optional[dict]) -> np.ndarray:
    meta = {"step": int(step), "keys": sorted(flat), "extra": extra or {}}
    return np.frombuffer(json.dumps(meta).encode(), np.uint8)


def save_checkpoint(path, tree: Any, step: int,
                    extra: Optional[dict] = None,
                    timings: Optional[dict] = None) -> int:
    """Pack ``tree`` (tensors or numpy arrays) into a RIMFS image at
    ``path``, atomically. Returns the image's bytes; ``timings``, when
    given, gets the seconds of packing (with every CRC) and writing."""
    path = pathlib.Path(path)
    flat = _flatten(tree)
    flat["__meta__"] = _meta_file(flat, step, extra)
    t0 = time.perf_counter()
    img = rimfs_mod.pack_buffer(flat)
    t1 = time.perf_counter()
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        f.write(img)
    tmp.replace(path)
    if timings is not None:
        timings.update(pack_s=t1 - t0, write_s=time.perf_counter() - t1)
    return len(img)


def load_checkpoint(path, like: Any) -> tuple:
    """Restore into the structure of ``like`` (tensors): each leaf read by
    its key, CRC-verified (the whole image first), cast to the like
    leaf's dtype and shape on its device. Returns (tree, step, extra). A
    ``like`` that holds part of the saved tree (the parameters alone)
    reads just that part."""
    fs = rimfs_mod.mount_file(path)
    fs.verify()
    meta = json.loads(fs.read("__meta__").numpy().tobytes().decode())
    out = []
    for key, leaf in _leaves(like):
        t = fs.read(key)
        r = t.to(device=leaf.device, dtype=leaf.dtype).reshape(leaf.shape)
        # a CPU leaf of the same dtype would still view the mapped file
        out.append(r.clone() if r.data_ptr() == t.data_ptr() else r)
    return _rebuild(like, iter(out)), meta["step"], meta["extra"]


def host_snapshot(tree: Any) -> Any:
    """A copy of ``tree`` (tensors) in host memory that no later in-place
    update of the tree reaches: a CUDA tensor is copied to the host, a CPU
    tensor cloned (``.cpu()`` of a CPU tensor is the tensor itself)."""
    copies = [t.detach().cpu() if t.is_cuda else t.detach().clone()
              for t in _flatten(tree).values()]
    return _rebuild(tree, iter(copies))


class CheckpointManager:
    """Checkpoints ``ckpt_<step:08d>.rimfs`` in ``directory``, the newest
    ``keep`` kept. ``saves`` holds each finished save's step, seconds
    (snapshot, pack with CRCs, write) and bytes."""

    def __init__(self, directory, keep: int = 3, async_save: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self.saves: list = []

    def _path(self, step: int) -> pathlib.Path:
        return self.dir / f"ckpt_{step:08d}.rimfs"

    def save(self, tree: Any, step: int, extra: Optional[dict] = None,
             block: bool = False) -> None:
        """Snapshot ``tree`` (tensors) to the host now (the next step updates it in
        place), then pack and write it, on a thread unless ``block`` or
        the manager is synchronous. A failed write raises at the next
        ``wait``."""
        self.wait()
        if any(t.is_cuda for t in _flatten(tree).values()):
            torch.cuda.synchronize()     # the snapshot times the copy only
        t0 = time.perf_counter()
        host_tree = host_snapshot(tree)
        timings = {"step": int(step),
                   "snapshot_s": time.perf_counter() - t0}

        def work():
            try:
                timings["bytes"] = save_checkpoint(self._path(step),
                                                   host_tree, step, extra,
                                                   timings)
                self._gc()
                self.saves.append(timings)
            except Exception as e:       # raised again by wait()
                self._error = e

        if self.async_save and not block:
            self._pending = threading.Thread(target=work, daemon=True)
            self._pending.start()
        else:
            work()
            self._raise()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        self._raise()

    def _raise(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        ckpts = sorted(self.dir.glob("ckpt_*.rimfs"))
        for p in ckpts[:-self.keep]:
            p.unlink(missing_ok=True)

    def all_steps(self) -> list:
        return sorted(int(p.stem.split("_")[1])
                      for p in self.dir.glob("ckpt_*.rimfs"))

    def restore_latest(self, like: Any) -> Optional[tuple]:
        """The latest checkpoint that passes its CRCs, as
        ``load_checkpoint`` returns it; a corrupt or torn one is skipped
        (node-failure / torn-write recovery). None when none loads."""
        self.wait()
        for step in reversed(self.all_steps()):
            try:
                return load_checkpoint(self._path(step), like)
            except (ValueError, KeyError, IndexError, OSError,
                    struct.error):   # RIMFSError and JSON errors included
                continue
        return None
