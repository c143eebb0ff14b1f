"""Runtime Hardware Abstraction Layer — the ``hal_driver_t`` vtable.

The port's counterpart of ``repro.core.rhal``. The executor only ever calls
vtable slots; the eager driver fills them with PyTorch on one device:

  register ops       -> buffer-table ops (alloc/free/bind_const)
  initiate/wait DMA  -> host<->device copies (``Tensor.to``)
  dispatch           -> one compute op (oplib), a host sync after each
                        on the interpreted path
  link_compute       -> a handler resolved once per (opcode, attrs) site;
                        kernel opcodes resolve through the kernel registry
  poll/fence         -> ``torch.cuda.synchronize`` barriers

``DeviceArena`` keeps the JAX package's offset discipline over a modeled
slab: torch's caching allocator owns physical memory, the arena reproduces
the deterministic offsets, high-water mark and free-list. On CUDA the slab
is sized from the device's free memory at driver creation (a 3 GB weight
image does not fit the JAX package's 1 GiB default); on the CPU it is 1 GiB.

Split-phase DMA: ``dma_async`` returns a ``DmaTicket`` stamped with the
source payload's CRC-32; ``dma_wait`` verifies the delivered buffer against
it (one device-to-host read-back on CUDA) and re-issues a bounded number of
times before raising ``IntegrityError(kind="dma_crc")``.

The capture driver (``make_capture_driver``) fills the same slots with
work a CUDA graph can hold: no sync, no read of the host, no CRC stamp.
``Executor.fuse`` and ``Executor.run_batched`` link against it.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import device as device_mod
from repro_torch.core import oplib
from repro_torch.core.integrity import IntegrityConfig, IntegrityError, payload_crc
from repro_torch.core.rcb import Op
from repro_torch.dtypes import (as_tensor, itemsize, nbytes as tensor_nbytes,
                                torch_dtype)

ARENA_ALIGN = 128                 # matches rimfs.ALIGN: one DMA lane quantum
DEFAULT_ARENA_BYTES = 1 << 30     # modeled slab size on the CPU


class ArenaError(RuntimeError):
    pass


class DmaError(RuntimeError):
    """Split-phase DMA protocol violation (e.g. a ticket redeemed twice)."""


class TileFailure(RuntimeError):
    """The hardware behind a driver went away mid-program."""


class DeviceArena:
    """Offset-based suballocator over one up-front device slab.

    First-fit over a sorted free-list with neighbour coalescing on free;
    every range is aligned to ``align`` (128 B — RIMFS lane width). With
    ``debug=True`` every alloc/free re-verifies the full invariant set.
    """

    def __init__(self, capacity: int = DEFAULT_ARENA_BYTES,
                 align: int = ARENA_ALIGN, debug: bool = False):
        if capacity <= 0 or capacity % align:
            raise ArenaError(f"capacity {capacity} not a multiple of {align}")
        self.capacity = capacity
        self.align = align
        self.debug = debug
        self._free: list[tuple[int, int]] = [(0, capacity)]  # (offset, size)
        self._live: dict[int, int] = {}                      # offset -> size
        self.bytes_in_use = 0
        self.high_water = 0

    # ------------------------------------------------------------------ api
    def _round(self, nbytes: int) -> int:
        nbytes = max(1, int(nbytes))
        return (nbytes + self.align - 1) // self.align * self.align

    def alloc(self, nbytes: int) -> int:
        """Reserve an aligned range; returns its slab offset."""
        size = self._round(nbytes)
        for i, (off, avail) in enumerate(self._free):
            if avail >= size:
                if avail == size:
                    self._free.pop(i)
                else:
                    self._free[i] = (off + size, avail - size)
                self._live[off] = size
                self.bytes_in_use += size
                self.high_water = max(self.high_water, self.bytes_in_use)
                if self.debug:
                    self.check()
                return off
        raise ArenaError(
            f"arena exhausted: need {size}B, in_use={self.bytes_in_use}B "
            f"of {self.capacity}B ({len(self._free)} free ranges)")

    def free(self, offset: int) -> None:
        """Return a range to the free-list (coalescing with neighbours)."""
        size = self._live.pop(offset, None)
        if size is None:
            raise ArenaError(f"free of unallocated offset {offset}")
        self.bytes_in_use -= size
        i = bisect.bisect_left(self._free, (offset, 0))
        if i < len(self._free) and offset + size == self._free[i][0]:
            size += self._free[i][1]
            self._free.pop(i)
        if i > 0 and self._free[i - 1][0] + self._free[i - 1][1] == offset:
            offset, size = (self._free[i - 1][0],
                            self._free[i - 1][1] + size)
            self._free[i - 1] = (offset, size)
        else:
            self._free.insert(i, (offset, size))
        if self.debug:
            self.check()

    def check(self) -> None:
        """Assert the full disjointness/alignment invariant set."""
        ranges = ([(o, s, "live") for o, s in self._live.items()]
                  + [(o, s, "free") for o, s in self._free])
        ranges.sort()
        prev_end, prev_kind = 0, None
        covered = 0
        for off, size, kind in ranges:
            if off % self.align or size % self.align:
                raise ArenaError(f"unaligned {kind} range ({off}, {size})")
            if off < prev_end:
                raise ArenaError(
                    f"{kind} range at {off} overlaps previous "
                    f"{prev_kind} range ending at {prev_end}")
            prev_end, prev_kind = off + size, kind
            covered += size
        if prev_end > self.capacity or covered != self.capacity:
            raise ArenaError("arena ranges do not tile the slab")

    def reset(self) -> None:
        self._free = [(0, self.capacity)]
        self._live.clear()
        self.bytes_in_use = 0


@dataclasses.dataclass
class DmaTicket:
    """Split-phase transfer handle: issued by ``dma_async``, redeemed once
    by ``dma_wait`` (a second redemption raises ``DmaError``). ``crc`` is
    the source payload's CRC-32 stamped at issue; ``src`` keeps the source
    for an in-place re-issue. ``crc is None`` marks an unverified transfer
    (d2h pulls)."""
    buf: Any
    direction: str
    nbytes: int
    prefetched: bool = False
    redeemed: bool = False
    crc: Optional[int] = None
    src: Any = None
    retries: int = 0

    def redeem(self) -> None:
        if self.redeemed:
            raise DmaError(
                f"DmaTicket({self.direction}, {self.nbytes}B) redeemed "
                f"twice — dma_wait already consumed this descriptor")
        self.redeemed = True


@dataclasses.dataclass
class HalDriver:
    """The vtable. Integrating a new backend == filling these slots."""
    name: str
    alloc: Callable[[tuple, str], Any]
    free: Callable[[Any], None]
    bind_const: Callable[[Any], Any]
    initiate_dma: Callable[[Any, str], Any]     # (host_buf, direction) -> buf
    wait_dma: Callable[[Any], Any]
    dispatch_compute: Callable[[Op, list, dict], Any]
    collective: Callable[[str, Any, dict], Any]
    fence: Callable[[list], None]
    poll: Callable[[Any], bool]
    donate: Callable[[Any], Any]
    device: torch.device = torch.device("cpu")
    stats: dict = dataclasses.field(default_factory=dict)
    # resolve one opcode to a positional handler ``fn(*srcs)`` once at link
    # time (core/linker.py); None falls back to per-op dispatch_compute
    link_compute: Optional[Callable[[Op, dict], Callable]] = None
    # split-phase DMA slots; None falls back to initiate_dma/wait_dma
    dma_async: Optional[Callable[[Any, str], DmaTicket]] = None
    dma_wait: Optional[Callable[[DmaTicket], Any]] = None
    dma_async_batch: Optional[Callable[[list, str], list]] = None
    arena: Optional[DeviceArena] = None
    integrity: IntegrityConfig = dataclasses.field(
        default_factory=IntegrityConfig)
    # identical (opcode, attrs) sites across links share one handler
    link_cache: dict = dataclasses.field(default_factory=dict)

    def _count(self, key: str, n: int = 1):
        self.stats[key] = self.stats.get(key, 0) + n


def _nbytes_of(shape, dtype: str) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n * itemsize(dtype)


def _size_of(buf) -> int:
    return tensor_nbytes(buf) if isinstance(buf, torch.Tensor) \
        else int(getattr(buf, "nbytes", 0))


def _arena_capacity(dev: torch.device) -> int:
    """Free device memory at creation on CUDA, 1 GiB on the CPU."""
    if dev.type != "cuda":
        return DEFAULT_ARENA_BYTES
    free, _total = torch.cuda.mem_get_info(dev)
    return max(ARENA_ALIGN, free // ARENA_ALIGN * ARENA_ALIGN)


# ---------------------------------------------------------------------------
# Eager driver: one device queue, a host sync per interpreted op.
# ---------------------------------------------------------------------------

def make_eager_driver(device="cuda", arena_bytes: Optional[int] = None,
                      debug_arena: bool = False) -> HalDriver:
    dev = device_mod.resolve(device)
    arena = DeviceArena(arena_bytes or _arena_capacity(dev),
                        debug=debug_arena)
    # id(buf) -> arena offset for arena-backed allocations (an id is only
    # recorded while its buffer is registered)
    offsets: dict[int, int] = {}

    def to_device(buf) -> torch.Tensor:
        return as_tensor(buf, dev)

    def alloc(shape, dtype):
        d._count("alloc")
        buf = torch.zeros(tuple(shape), dtype=torch_dtype(dtype), device=dev)
        offsets[id(buf)] = arena.alloc(_nbytes_of(shape, dtype))
        return buf

    def free(buf):
        d._count("free")
        off = offsets.pop(id(buf), None)
        if off is not None:
            arena.free(off)         # the offset really returns to the list

    def bind_const(value):
        return torch.as_tensor(value, device=dev)

    def initiate_dma(host_buf, direction):
        d._count("dma")
        d._count("dma_bytes", _size_of(host_buf))
        if direction == "d2h":
            return host_buf.cpu() if isinstance(host_buf, torch.Tensor) \
                else host_buf
        return to_device(host_buf)

    def wait_dma(buf):
        d._count("dma_wait")
        device_mod.synchronize(dev)
        return buf

    def _stamp(ticket, host_buf):
        """Stamp the source payload's CRC-32 at ISSUE time and keep the
        source for in-place retry. d2h is never stamped: its reference
        bytes only exist device-side."""
        if d.integrity.enabled and ticket.direction != "d2h":
            ticket.crc = payload_crc(host_buf)
            ticket.src = host_buf
        return ticket

    def dma_async(host_buf, direction, prefetched=False):
        """Issue half: returns a ticket without a host sync. A d2d whose
        source already lives on this device is zero-copy."""
        n = _size_of(host_buf)
        d._count("dma_async")
        d._count("dma_bytes", n)
        if prefetched:
            d._count("dma_overlapped_bytes", n)
        if direction == "d2h":
            return DmaTicket(host_buf, "d2h", n, prefetched)
        if direction == "d2d" and isinstance(host_buf, torch.Tensor) \
                and host_buf.device == dev:
            return _stamp(DmaTicket(host_buf, direction, n, prefetched),
                          host_buf)
        return _stamp(DmaTicket(to_device(host_buf), direction, n,
                                prefetched), host_buf)

    def dma_wait_(ticket):
        d._count("dma_ticket_wait")
        ticket.redeem()                            # double-wait raises
        if ticket.direction == "d2h":
            buf = ticket.buf
            return buf.cpu() if isinstance(buf, torch.Tensor) else buf
        if ticket.crc is None or not d.integrity.enabled:
            return ticket.buf                      # ordered by the queue
        # endpoint verification: delivered payload vs issue-time CRC, with
        # a bounded in-place re-issue from the retained source
        d._count("dma_crc_checked")
        buf = ticket.buf
        for attempt in range(d.integrity.dma_retries + 1):
            if payload_crc(buf) == ticket.crc:
                if attempt:
                    ticket.retries = attempt
                    d._count("dma_retry_recovered")
                ticket.buf = buf
                return buf
            d._count("dma_crc_mismatch")
            if attempt >= d.integrity.dma_retries:
                break
            d._count("dma_retry")
            buf = to_device(ticket.src)
        raise IntegrityError(
            f"DMA payload CRC mismatch ({ticket.direction}, "
            f"{ticket.nbytes}B) after {d.integrity.dma_retries} "
            f"in-place retries", kind="dma_crc")

    def dma_async_batch(host_bufs, direction, prefetched=False):
        """One engine call for a whole transfer stream."""
        d._count("dma_batch")
        return [dma_async(h, direction, prefetched) for h in host_bufs]

    def dispatch_compute(op, srcs, attrs):
        d._count("dispatch")
        out = oplib.compute(op, srcs, attrs)
        device_mod.synchronize(dev)                # per-op host sync
        return out

    def collective(kind, x, attrs):
        d._count("collective")
        return x                                   # one device: identity

    def fence(bufs):
        d._count("fence")
        device_mod.synchronize(dev)

    def poll(buf):
        d._count("poll")
        return True

    def donate(buf):
        return buf

    def link_compute(op, attrs):
        # kernel opcodes resolve through the registry (hand kernel or its
        # plain version, per the op's ``impl`` attr); the rest are the
        # pre-resolved oplib entries, launched asynchronously on the queue
        if op in oplib.OP_KERNELS:
            from repro_torch.kernels import registry
            return registry.linked_handler(oplib.OP_KERNELS[op], attrs)
        fn = oplib.lookup(op)
        return lambda *srcs: fn(srcs, attrs)

    d = HalDriver(f"eager_{dev.type}", alloc, free, bind_const, initiate_dma,
                  wait_dma, dispatch_compute, collective, fence, poll, donate,
                  device=dev, link_compute=link_compute, dma_async=dma_async,
                  dma_wait=dma_wait_, dma_async_batch=dma_async_batch,
                  arena=arena)
    return d


# ---------------------------------------------------------------------------
# Capture driver: every slot can be recorded into a CUDA graph.
# ---------------------------------------------------------------------------

def make_capture_driver(device="cuda") -> HalDriver:
    """The port's counterpart of the JAX package's ``make_trace_driver``:
    the slots the executor stages the whole RCB program through, for
    ``Executor.fuse`` (one CUDA graph) and ``Executor.run_batched`` (one
    graph per batch bucket, under ``torch.func.vmap``).

    No slot syncs or reads the host, so none of the eager driver's sync
    and host-read points is reached: ``wait_dma``, ``dispatch_compute`` and
    ``fence`` do not synchronize, and no DMA is stamped with (or checked
    against) a CRC of the host copy. ``alloc`` is ``torch.zeros`` on the
    device, ``fence`` and ``poll`` are no-ops, and a DMA in any direction
    is a device copy of a tensor that is already on the device (the caller
    stages inputs first). ``bind_const`` makes its tensor once per value,
    on the first (uncaptured) run, and hands the same tensor to every later
    run, since a host-to-device copy cannot be captured. ``link_compute``
    resolves kernel opcodes through the registry, as the eager driver's
    does."""
    dev = device_mod.resolve(device)
    consts: dict[int, tuple] = {}          # id(value) -> (value, tensor)

    def device_copy(buf) -> torch.Tensor:
        if isinstance(buf, torch.Tensor) and buf.device == dev:
            return buf.clone()
        if dev.type == "cpu":
            return as_tensor(buf, dev).clone()
        raise DmaError(f"capture driver: DMA source is not a tensor on "
                       f"{dev} ({type(buf).__name__}); stage it on the "
                       f"device before the captured run")

    def alloc(shape, dtype):
        return torch.zeros(tuple(shape), dtype=torch_dtype(dtype), device=dev)

    def free(buf):
        return None

    def bind_const(value):
        hit = consts.get(id(value))
        if hit is None or hit[0] is not value:
            hit = consts[id(value)] = (value,
                                       torch.as_tensor(value, device=dev))
        return hit[1]

    def initiate_dma(host_buf, direction):
        return device_copy(host_buf)

    def wait_dma(buf):
        return buf                                 # ordered by the stream

    def dma_async(host_buf, direction, prefetched=False):
        return DmaTicket(device_copy(host_buf), direction, 0, prefetched)

    def dma_wait_(ticket):
        ticket.redeem()                            # double-wait raises
        return ticket.buf

    def dma_async_batch(host_bufs, direction, prefetched=False):
        return [dma_async(h, direction, prefetched) for h in host_bufs]

    def dispatch_compute(op, srcs, attrs):
        d._count("dispatch")
        return oplib.compute(op, srcs, attrs)      # no sync

    def collective(kind, x, attrs):
        return x                                   # one device: identity

    def fence(bufs):
        return None

    def poll(buf):
        return True

    def donate(buf):
        return buf

    def link_compute(op, attrs):
        if op in oplib.OP_KERNELS:
            from repro_torch.kernels import registry
            return registry.linked_handler(oplib.OP_KERNELS[op], attrs)
        fn = oplib.lookup(op)
        return lambda *srcs: fn(srcs, attrs)

    d = HalDriver(f"capture_{dev.type}", alloc, free, bind_const,
                  initiate_dma, wait_dma, dispatch_compute, collective, fence,
                  poll, donate, device=dev, link_compute=link_compute,
                  dma_async=dma_async, dma_wait=dma_wait_,
                  dma_async_batch=dma_async_batch)
    return d
