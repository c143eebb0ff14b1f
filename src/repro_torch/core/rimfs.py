"""Runtime In-Memory File System — flat, read-only, zero-copy weight store.

The port's counterpart of ``repro.core.rimfs``; images are byte-identical
both ways. Image layout (all little-endian):

  [0:4]   magic  b"RIMF"
  [4:6]   version
  [6:8]   flags
  [8:12]  n_files
  [12:16] index_bytes
  [16:..] index: per file a json-encoded entry
          {name, offset, nbytes, dtype, shape, crc32}
  [..]    128-byte aligned data region (one aligned blob per file)
  [-4:]   CRC-32 of everything before it

``mount()`` wraps a bytes-like object and serves zero-copy CPU tensor views
of it. A bfloat16 file is tagged ``"bfloat16"`` by name, as the JAX package
tags it; the port reads its bits as uint16 and views them as
``torch.bfloat16``, so no ml_dtypes is needed on either side.
"""
from __future__ import annotations

import itertools
import json
import os
import pathlib
import struct
import weakref
import zlib
from typing import Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.core.integrity import IntegrityError, payload_crc
from repro_torch.dtypes import BF16, from_host_bits, host_bits, nbytes

MAGIC = b"RIMF"
ALIGN = 128          # one DMA lane quantum; matches rhal.ARENA_ALIGN


class RIMFSError(IntegrityError, ValueError):
    """RIMFS-level integrity/format fault (an ``IntegrityError`` for the
    recovery layer, a ``ValueError`` for callers that treat it as format)."""

    def __init__(self, message: str, kind: str = "rimfs"):
        super().__init__(message, kind=kind)


def _align(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


def _host_file(arr) -> tuple:
    """(contiguous bits ndarray, dtype tag) for one file's contents. As in
    the JAX package, ``np.ascontiguousarray`` stores a 0-d file as shape
    ``[1]``."""
    if isinstance(arr, torch.Tensor):
        bits = np.ascontiguousarray(host_bits(arr))
        tag = BF16 if arr.dtype == torch.bfloat16 else bits.dtype.str
        return bits, tag
    arr = np.ascontiguousarray(arr)
    # numpy's ``.str`` collapses extension dtypes (ml_dtypes bfloat16) to an
    # opaque ``|V2``; those are tagged by name, as the JAX package does
    return arr, (arr.dtype.name if arr.dtype.kind == "V" else arr.dtype.str)


def _np_dtype_of(tag: str) -> np.dtype:
    if tag == BF16:
        return np.dtype(np.uint16)
    try:
        return np.dtype(tag)
    except TypeError:
        raise RIMFSError(f"unsupported RIMFS dtype tag {tag!r}") from None


def check_image(data) -> bool:
    """Verify an image's trailer CRC over its raw bytes — nothing of the
    image is parsed first."""
    buf = memoryview(data)
    if len(buf) < 20:
        raise RIMFSError(f"truncated RIMFS image ({len(buf)}B)",
                         kind="image_crc")
    (crc,) = struct.unpack_from("<I", buf, len(buf) - 4)
    if crc != (zlib.crc32(buf[:-4]) & 0xFFFFFFFF):
        raise RIMFSError("image CRC mismatch", kind="image_crc")
    return True


def pack(files: Mapping[str, object], *, version: int = 1) -> bytes:
    """Flatten named tensors (torch or numpy) into one RIMFS image."""
    return bytes(pack_buffer(files, version=version))


def pack_buffer(files: Mapping[str, object], *,
                version: int = 1) -> bytearray:
    """``pack``'s image in the buffer it was built in, without the copy
    into ``bytes`` (a training checkpoint is written straight from it)."""
    metas = []
    for name, arr in files.items():
        bits, tag = _host_file(arr)
        flat = bits.reshape(-1).view(np.uint8)
        metas.append((name, flat, tag, list(bits.shape),
                      zlib.crc32(flat) & 0xFFFFFFFF))

    def build_index(data_start: int):
        out, off = [], data_start
        for name, flat, tag, shape, crc in metas:
            off = _align(off)
            out.append({"name": name, "offset": off, "nbytes": int(flat.size),
                        "dtype": tag, "shape": shape, "crc32": crc})
            off += flat.size
        return out, off

    # the index length moves the data start; iterate to the fixed point
    data_start = 16
    for _ in range(5):
        index, total = build_index(data_start)
        blob = json.dumps(index, separators=(",", ":")).encode()
        new_start = 16 + len(blob)
        if new_start == data_start:
            break
        data_start = new_start
    index, total = build_index(data_start)
    blob = json.dumps(index, separators=(",", ":")).encode()

    buf = bytearray(_align(total) + 4)
    view = memoryview(buf)
    struct.pack_into("<4sHHII", buf, 0, MAGIC, version, 0, len(metas),
                     len(blob))
    buf[16:16 + len(blob)] = blob
    for entry, (_, flat, _, _, _) in zip(index, metas):
        o = entry["offset"]
        view[o:o + flat.size] = flat
    crc = zlib.crc32(view[:-4]) & 0xFFFFFFFF
    struct.pack_into("<I", buf, len(buf) - 4, crc)
    view.release()
    return buf


class RIMFS:
    """A mounted image. Reads are zero-copy CPU tensor views of the backing
    buffer. With ``verify_reads`` on (default) every file's CRC is checked
    the first time it is opened, so a poisoned image is rejected before it
    binds; ``fsck()`` re-verifies everything and resets that memo."""

    def __init__(self, data: Union[bytes, bytearray, memoryview, np.memmap],
                 verify_reads: bool = True):
        self._data = data
        buf = memoryview(data)
        magic, ver, _flags, n, ilen = struct.unpack_from("<4sHHII", buf, 0)
        if bytes(magic) != MAGIC:
            raise RIMFSError(f"bad RIMFS magic: {bytes(magic)!r}")
        self.version = ver
        index = json.loads(bytes(buf[16:16 + ilen]).decode())
        if len(index) != n:
            raise RIMFSError("index length mismatch")
        self._index = {e["name"]: e for e in index}
        # per-driver residency cache: id -> (weakref(driver), ResidentImage)
        self._resident: dict[int, tuple] = {}
        self.verify_reads = verify_reads
        self._verified: set = set()        # files whose CRC already checked

    # ------------------------------------------------------------------ api
    def files(self) -> list:
        return list(self._index)

    def stat(self, name: str) -> dict:
        return dict(self._index[name])

    def _view(self, e: dict) -> np.ndarray:
        dt = _np_dtype_of(e["dtype"])
        count = int(np.prod(e["shape"])) if e["shape"] else 1
        return np.frombuffer(self._data, dtype=dt, count=count,
                             offset=e["offset"]).reshape(e["shape"])

    def _crc_ok(self, e: dict, view: np.ndarray) -> bool:
        return (zlib.crc32(view.reshape(-1).view(np.uint8)) & 0xFFFFFFFF) \
            == e["crc32"]

    def read(self, name: str, verify: Optional[bool] = None) -> torch.Tensor:
        """Zero-copy CPU tensor view of one file (CRC-checked on first
        open unless ``verify=False`` / ``verify_reads`` off)."""
        e = self._index.get(name)
        if e is None:
            raise RIMFSError(f"no such file: {name!r}")
        view = self._view(e)
        check = self.verify_reads if verify is None else verify
        if check and name not in self._verified:
            if not self._crc_ok(e, view):
                raise RIMFSError(f"CRC mismatch in {name!r} (read)",
                                 kind="file_crc")
            self._verified.add(name)
        return from_host_bits(view, e["dtype"])

    def address_of(self, name: str) -> tuple:
        """(offset, nbytes) of one file in the image: its stable host
        address for DMA."""
        e = self._index[name]
        return e["offset"], e["nbytes"]

    def verify(self, name: Optional[str] = None) -> bool:
        for n in ([name] if name else self.files()):
            e = self._index[n]
            if not self._crc_ok(e, self._view(e)):
                raise RIMFSError(f"CRC mismatch in {n!r}", kind="file_crc")
            self._verified.add(n)
        return True

    def verify_image(self) -> bool:
        return check_image(self._data)

    def fsck(self, strict: bool = True) -> dict:
        """Full consistency check: image trailer CRC + every per-file CRC,
        re-verified from scratch (the read memo is reset first). Returns a
        report dict; with ``strict`` (default) corruption raises."""
        self._verified.clear()
        report: dict = {"files": len(self._index), "bad_files": [],
                        "image_crc_ok": True}
        try:
            self.verify_image()
        except RIMFSError:
            report["image_crc_ok"] = False
            if strict:
                raise
        for n, e in self._index.items():
            if not self._crc_ok(e, self._view(e)):
                report["bad_files"].append(n)
                if strict:
                    raise RIMFSError(f"fsck: CRC mismatch in {n!r}",
                                     kind="file_crc")
            else:
                self._verified.add(n)
        report["ok"] = report["image_crc_ok"] and not report["bad_files"]
        return report

    def resident(self, driver, names: Optional[list] = None
                 ) -> "ResidentImage":
        """Device residency: pin files into the driver's arena ONCE and serve
        the device buffers from then on. Later calls for the same driver
        return the cached ``ResidentImage`` (extended with any new names)
        and move zero bytes; entries of collected drivers are pruned."""
        for key, (ref, _) in list(self._resident.items()):
            if ref() is None:                     # driver was collected
                del self._resident[key]
        entry = self._resident.get(id(driver))
        if entry is not None and entry[0]() is driver:
            ri = entry[1]
            ri.extend(names if names is not None else self.files())
            return ri
        ri = ResidentImage(self, driver, names)
        self._resident[id(driver)] = (weakref.ref(driver), ri)
        return ri

    def total_bytes(self) -> int:
        return len(memoryview(self._data))

    def overhead_bytes(self) -> int:
        """Non-payload bytes (header, index, padding, trailer)."""
        payload = sum(e["nbytes"] for e in self._index.values())
        return self.total_bytes() - payload

    def unpin_all(self) -> None:
        """Release this image's residency on every driver it is pinned on
        (the image is being replaced)."""
        for _, ri in list(self._resident.values()):
            ri.unpin()


class ResidentImage:
    """Weight files pinned device-side, offset-registered in the driver's
    arena. Every file's transfer is ISSUED before any is WAITED on (one
    batched descriptor when the driver has it). The driver is held by
    weakref: the cache never outlives the backend it pinned into."""

    def __init__(self, fs: RIMFS, driver, names: Optional[list] = None):
        self.fs = fs
        self._driver_ref = weakref.ref(driver)
        self._host_views: dict[str, torch.Tensor] = {}
        self._offsets: dict[str, int] = {}
        self._bufs: dict[str, torch.Tensor] = {}
        self.extend(names if names is not None else fs.files())

    @property
    def driver(self):
        return self._driver_ref()

    def extend(self, names) -> None:
        """Pin any not-yet-resident files (pinned ones never re-upload)."""
        order = [n for n in names if n not in self._bufs]
        if not order:
            return
        driver = self.driver
        if driver is None:
            raise RIMFSError("resident image's driver was collected")
        for name in order:
            view = self.fs.read(name)          # zero-copy view of the image
            self._host_views[name] = view
            if driver.arena is not None:
                self._offsets[name] = driver.arena.alloc(nbytes(view))
        if driver.dma_async_batch is not None:
            tickets = driver.dma_async_batch(
                [self._host_views[n] for n in order], "h2d")
            for name, t in zip(order, tickets):
                self._bufs[name] = driver.dma_wait(t)
        elif driver.dma_async is not None:
            tickets = {n: driver.dma_async(self._host_views[n], "h2d")
                       for n in order}
            for name, t in tickets.items():    # redeem after ALL issues
                self._bufs[name] = driver.dma_wait(t)
        else:
            for name in order:
                self._bufs[name] = driver.wait_dma(driver.initiate_dma(
                    self._host_views[name], "h2d"))

    # ---------------------------------------------------------------- api
    def files(self) -> list:
        return list(self._bufs)

    def buffer(self, name: str) -> torch.Tensor:
        """The pinned device buffer for one file."""
        return self._bufs[name]

    __getitem__ = buffer

    def __contains__(self, name: str) -> bool:
        return name in self._bufs

    def buffers(self) -> dict:
        return dict(self._bufs)

    def host_view(self, name: str) -> torch.Tensor:
        """The zero-copy host view the upload consumed."""
        return self._host_views[name]

    def offset_of(self, name: str) -> Optional[int]:
        """Arena offset of the pinned range (None without an arena)."""
        return self._offsets.get(name)

    def pinned_ranges(self) -> list:
        """Sorted [(arena_offset, nbytes), ...] of every pinned file."""
        return sorted((off, nbytes(self._host_views[name]))
                      for name, off in self._offsets.items())

    def revalidate(self) -> bool:
        """CRC-compare every pinned DEVICE buffer against its file's CRC
        (the quarantine-lift check of ``TileMesh.revive``)."""
        for name, buf in self._bufs.items():
            if payload_crc(buf) != self.fs._index[name]["crc32"]:
                return False
        return True

    def nbytes(self) -> int:
        return sum(nbytes(v) for v in self._host_views.values())

    def unpin(self) -> None:
        """Release the arena ranges and drop the buffer table."""
        driver = self.driver
        arena = driver.arena if driver is not None else None
        if arena is not None:
            for off in self._offsets.values():
                arena.free(off)
        self._offsets.clear()
        self._bufs.clear()
        if driver is not None:
            self.fs._resident.pop(id(driver), None)


class Journal:
    """Write-ahead intent log for journaled image installs.

    Append-only records, one JSON object a line (``separators=(",",
    ":")``, as the JAX package writes them, so either package recovers the
    other's journal). When file-backed every append is flushed and
    fsync'd BEFORE the caller proceeds. Record kinds:

      intent   {txid, crc, nbytes}  an install is about to stage
      commit   {txid}               staged payload is complete and valid
      applied  {txid}               the visible image was flipped
      rollback {txid}               fsck discarded the staging
    """

    def __init__(self, path: Optional[Union[str, pathlib.Path]] = None):
        self.path = pathlib.Path(path) if path is not None else None
        self._records: list = []
        if self.path is not None and self.path.exists():
            for line in self.path.read_text().splitlines():
                if line.strip():
                    self._records.append(json.loads(line))
        last = max((r["seq"] for r in self._records), default=0)
        self._seq = itertools.count(last + 1)

    def append(self, kind: str, txid: int, **meta) -> dict:
        rec = {"seq": next(self._seq), "kind": kind, "txid": txid, **meta}
        self._records.append(rec)
        if self.path is not None:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
                f.flush()
                os.fsync(f.fileno())
        return rec

    def records(self) -> list:
        return list(self._records)

    def pending(self) -> dict:
        """txid -> {"intent": rec, "committed": bool} for every intent
        without an applied/rollback resolution (the fsck worklist)."""
        state: dict = {}
        for r in self._records:
            if r["kind"] == "intent":
                state[r["txid"]] = {"intent": r, "committed": False}
            elif r["kind"] == "commit" and r["txid"] in state:
                state[r["txid"]]["committed"] = True
            elif r["kind"] in ("applied", "rollback"):
                state.pop(r["txid"], None)
        return state


class ImageStore:
    """Durable home of a serving image with journaled installs.

    Every install is write-ahead journaled: intent record -> stage the new
    bytes (side buffer; a ``.stage<txid>`` file when disk-backed) ->
    commit mark -> atomic flip (``os.replace``) -> applied mark. A fault at
    ANY point leaves the visible image wholly old or wholly new; ``fsck()``
    REPLAYS committed installs whose flip never landed (redo) and ROLLS
    BACK uncommitted staging (undo), then runs the mounted image's own
    per-file-CRC ``fsck``. The files on disk are the JAX package's: either
    package's ``fsck`` recovers a crash of the other's ``install``.

    ``fail_at`` on ``install`` is the fault-injection hook: raise at a named
    step ("after_intent" / "after_stage" / "after_commit") to model a crash
    mid-write; recovery is then exercised by ``fsck()`` on the survivor.
    """

    def __init__(self, image: Optional[bytes] = None,
                 path: Optional[Union[str, pathlib.Path]] = None):
        self.path = pathlib.Path(path) if path is not None else None
        self.journal = Journal(
            f"{self.path}.journal" if self.path is not None else None)
        last_tx = max((r["txid"] for r in self.journal.records()),
                      default=0)
        self._txids = itertools.count(last_tx + 1)
        self._staging: dict[int, bytes] = {}
        self._image: Optional[bytes] = None
        if self.path is not None and self.path.exists():
            self._image = self.path.read_bytes()
        if image is not None:
            self.install(image)

    # ------------------------------------------------------------------ api
    def image(self) -> Optional[bytes]:
        """The committed (fully visible) image bytes."""
        return self._image

    def mount(self) -> RIMFS:
        if self._image is None:
            raise RIMFSError("image store is empty")
        return RIMFS(self._image)

    def _stage_path(self, txid: int) -> pathlib.Path:
        return pathlib.Path(f"{self.path}.stage{txid}")

    def install(self, image_bytes: bytes,
                fail_at: Optional[str] = None) -> int:
        """Journaled install; returns the transaction id."""
        txid = next(self._txids)
        self.journal.append("intent", txid,
                            crc=zlib.crc32(image_bytes) & 0xFFFFFFFF,
                            nbytes=len(image_bytes))
        if fail_at == "after_intent":
            raise IntegrityError(
                f"injected fault: crash after intent (tx {txid})",
                kind="journal_fault")
        self._staging[txid] = bytes(image_bytes)
        if self.path is not None:
            self._stage_path(txid).write_bytes(image_bytes)
        if fail_at == "after_stage":
            raise IntegrityError(
                f"injected fault: crash after stage (tx {txid})",
                kind="journal_fault")
        self.journal.append("commit", txid)
        if fail_at == "after_commit":
            raise IntegrityError(
                f"injected fault: crash after commit (tx {txid})",
                kind="journal_fault")
        self._apply(txid, image_bytes)
        return txid

    def _apply(self, txid: int, image_bytes: bytes) -> None:
        if self.path is not None:
            tmp = pathlib.Path(f"{self.path}.tmp")
            tmp.write_bytes(image_bytes)
            os.replace(tmp, self.path)           # the atomic flip
        self._image = bytes(image_bytes)
        self.journal.append("applied", txid)
        self._staging.pop(txid, None)
        if self.path is not None:
            sp = self._stage_path(txid)
            if sp.exists():
                sp.unlink()

    def fsck(self, strict: bool = True) -> dict:
        """Replay or roll back the journal, then fsck the mounted image.

        Committed transactions whose flip never became visible are
        re-applied from staging (CRC-checked against the intent record
        first); everything else pending is rolled back. The visible image
        is therefore always a fully written, CRC-clean state."""
        report: dict = {"replayed": [], "rolled_back": [], "image": None}
        pend = self.journal.pending()
        for txid in sorted(pend):
            st = pend[txid]
            staged = self._staging.get(txid)
            if staged is None and self.path is not None:
                sp = self._stage_path(txid)
                if sp.exists():
                    staged = sp.read_bytes()
            intact = staged is not None and \
                (zlib.crc32(staged) & 0xFFFFFFFF) == st["intent"]["crc"]
            if st["committed"] and intact:
                self._apply(txid, staged)        # redo
                report["replayed"].append(txid)
            else:                                # undo
                self._staging.pop(txid, None)
                if self.path is not None:
                    sp = self._stage_path(txid)
                    if sp.exists():
                        sp.unlink()
                self.journal.append("rollback", txid)
                report["rolled_back"].append(txid)
        if self._image is not None:
            report["image"] = self.mount().fsck(strict=strict)
        return report


def mount(data: Union[bytes, bytearray, memoryview]) -> RIMFS:
    return RIMFS(data)


def mount_file(path: Union[str, pathlib.Path]) -> RIMFS:
    """mmap-backed mount: zero-copy straight from the page cache."""
    return RIMFS(np.memmap(str(path), dtype=np.uint8, mode="r"))


def save_file(path: Union[str, pathlib.Path],
              files: Mapping[str, object]) -> int:
    img = pack(files)
    pathlib.Path(path).write_bytes(img)
    return len(img)
