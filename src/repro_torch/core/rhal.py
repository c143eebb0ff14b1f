"""Runtime Hardware Abstraction Layer — the ``hal_driver_t`` vtable.

The port's counterpart of ``repro.core.rhal``. The executor only ever calls
vtable slots; the eager driver fills them with PyTorch on one device:

  register ops       -> buffer-table ops (alloc/free/bind_const)
  initiate/wait DMA  -> host<->device copies (``Tensor.to``)
  dispatch           -> one compute op (oplib), a host sync after each
                        on the interpreted path
  link_compute       -> a handler resolved once per (opcode, attrs) site;
                        kernel opcodes resolve through the kernel registry
  poll/fence         -> host barriers: on the driver's own CUDA stream when
                        it has one (a tile group's), else device-wide

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

Tile groups (``TileMesh``): on one card a group is a logical partition, an
eager driver with its own ``torch.cuda.Stream``, its own arena (a share of
the card's free memory) and its own DMA counters. Its work is launched on
its stream and its host barriers wait on that stream only, so one group's
barrier does not drain another's queue. A cut edge between two groups is a
split-phase d2d ticket: issued on the producer's stream (an event recorded
there, the payload's CRC stamped), redeemed by the consumer (its stream
waits on the event, the buffer is marked for it with ``record_stream``, the
CRC is checked). The hand-off is zero-copy. On the CPU there are no streams
and the same code runs in order.
"""
from __future__ import annotations

import bisect
import contextlib
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
    """A tile group's hardware went away mid-program (fault injection,
    a watchdog kill). Raised by every vtable slot of a killed
    ``TileGroup`` and by a quarantined arena's ``alloc``."""


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
        self.poisoned = False          # quarantined after a kill

    # ------------------------------------------------------------------ api
    def _round(self, nbytes: int) -> int:
        nbytes = max(1, int(nbytes))
        return (nbytes + self.align - 1) // self.align * self.align

    def quarantine(self) -> None:
        """Poison the arena: a killed owner may have left any live range
        half-written, so no range is handed out again until the pinned
        contents are re-validated against their RIMFS CRCs
        (``TileMesh.revive``); ``alloc`` raises until then."""
        self.poisoned = True

    def clear_quarantine(self) -> None:
        self.poisoned = False

    def alloc(self, nbytes: int) -> int:
        """Reserve an aligned range; returns its slab offset."""
        if self.poisoned:
            # a TileFailure, so the stage re-queue treats a quarantined
            # arena exactly like the dead group that owns it
            raise TileFailure(
                "arena quarantined: owner was preempted as hung — "
                "re-validate resident contents before reuse")
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
    (d2h pulls). ``event`` is the CUDA event a d2d issue records on the
    issuing (producer's) stream; the redeeming driver's stream waits on
    it."""
    buf: Any
    direction: str
    nbytes: int
    prefetched: bool = False
    redeemed: bool = False
    crc: Optional[int] = None
    src: Any = None
    retries: int = 0
    event: Any = None

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
    # the CUDA stream this driver launches on and waits on (a tile
    # group's); None: the current stream, with device-wide barriers
    stream: Any = None

    def _count(self, key: str, n: int = 1):
        self.stats[key] = self.stats.get(key, 0) + n

    def scope(self):
        """A context making the driver's stream current (a no-op without
        one): the executor runs a program inside it."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def barrier(self) -> None:
        """Host barrier: the driver's own stream when it has one, else the
        device's whole queue (a no-op on the CPU)."""
        if self.stream is not None:
            self.stream.synchronize()
        else:
            device_mod.synchronize(self.device)


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
                      debug_arena: bool = False, stream=None) -> HalDriver:
    """The eager driver. ``stream`` (a ``torch.cuda.Stream`` on ``device``)
    gives it a queue of its own: its slots launch there and its barriers
    wait there only. Without one it launches on the current stream and its
    barriers are device-wide."""
    dev = device_mod.resolve(device)
    if stream is not None and (dev.type != "cuda" or stream.device != dev):
        raise ValueError(f"stream on {getattr(stream, 'device', None)}, "
                         f"driver on {dev}")
    arena = DeviceArena(arena_bytes or _arena_capacity(dev),
                        debug=debug_arena)
    # id(buf) -> arena offset for arena-backed allocations (an id is only
    # recorded while its buffer is registered)
    offsets: dict[int, int] = {}

    def to_device(buf) -> torch.Tensor:
        return as_tensor(buf, dev)

    def alloc(shape, dtype):
        d._count("alloc")
        off = arena.alloc(_nbytes_of(shape, dtype))
        with d.scope():
            buf = torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                              device=dev)
        offsets[id(buf)] = off
        return buf

    def free(buf):
        d._count("free")
        off = offsets.pop(id(buf), None)
        if off is not None:
            arena.free(off)         # the offset really returns to the list

    def bind_const(value):
        with d.scope():
            return torch.as_tensor(value, device=dev)

    def initiate_dma(host_buf, direction):
        d._count("dma")
        d._count("dma_bytes", _size_of(host_buf))
        with d.scope():
            if direction == "d2h":
                return host_buf.cpu() if isinstance(host_buf, torch.Tensor) \
                    else host_buf
            return to_device(host_buf)

    def wait_dma(buf):
        d._count("dma_wait")
        d.barrier()
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
        """Issue half: returns a ticket with no host sync but the CRC
        stamp's read-back. A d2d whose source already lives on this
        device is zero-copy: it is issued on the CURRENT stream, the
        producer's (``TileMesh.stream`` makes it current), where the
        stamp reads the payload after the producer's work and the ticket's
        event is recorded."""
        n = _size_of(host_buf)
        d._count("dma_async")
        d._count("dma_bytes", n)
        if prefetched:
            d._count("dma_overlapped_bytes", n)
        if direction == "d2h":
            return DmaTicket(host_buf, "d2h", n, prefetched)
        if direction == "d2d" and isinstance(host_buf, torch.Tensor) \
                and host_buf.device == dev:
            ticket = _stamp(DmaTicket(host_buf, direction, n, prefetched),
                            host_buf)
            if dev.type == "cuda":
                ticket.event = torch.cuda.Event()
                ticket.event.record()
            return ticket
        with d.scope():
            return _stamp(DmaTicket(to_device(host_buf), direction, n,
                                    prefetched), host_buf)

    def dma_wait_(ticket):
        d._count("dma_ticket_wait")
        ticket.redeem()                            # double-wait raises
        if ticket.direction == "d2h":
            buf = ticket.buf
            with d.scope():
                return buf.cpu() if isinstance(buf, torch.Tensor) else buf
        if ticket.event is not None:
            # cross-stream hand-off: this driver's queue waits for the
            # producer's, and the caching allocator may not recycle the
            # buffer until this queue is done with it
            consumer = stream if stream is not None \
                else torch.cuda.current_stream(dev)
            consumer.wait_event(ticket.event)
            ticket.buf.record_stream(consumer)
        if ticket.crc is None or not d.integrity.enabled:
            return ticket.buf                      # ordered by the queue
        # endpoint verification: delivered payload vs issue-time CRC, with
        # a bounded in-place re-issue from the retained source
        d._count("dma_crc_checked")
        buf = ticket.buf
        for attempt in range(d.integrity.dma_retries + 1):
            with d.scope():
                ok = payload_crc(buf) == ticket.crc
            if ok:
                if attempt:
                    ticket.retries = attempt
                    d._count("dma_retry_recovered")
                ticket.buf = buf
                return buf
            d._count("dma_crc_mismatch")
            if attempt >= d.integrity.dma_retries:
                break
            d._count("dma_retry")
            with d.scope():
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
        with d.scope():
            out = oplib.compute(op, srcs, attrs)
        d.barrier()                                # per-op host sync
        return out

    def collective(kind, x, attrs):
        d._count("collective")
        return x                                   # one device: identity

    def fence(bufs):
        d._count("fence")
        d.barrier()

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
                  arena=arena, stream=stream)
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


# ---------------------------------------------------------------------------
# Tile mesh: logical tile groups on one card
# ---------------------------------------------------------------------------

_GUARDED_SLOTS = ("alloc", "free", "bind_const", "initiate_dma", "wait_dma",
                  "dispatch_compute", "collective", "fence", "poll",
                  "dma_async", "dma_wait", "dma_async_batch")


@dataclasses.dataclass
class TileGroup:
    """One tile group: an independent HalDriver (own stream, own arena,
    own stats) plus a liveness flag the mesh's fault model flips."""
    gid: int
    driver: HalDriver
    alive: bool = True


def _guard_group(group: TileGroup) -> None:
    """Wrap every vtable slot of the group's driver, and every handler its
    ``link_compute`` returns, so a killed group raises ``TileFailure`` at
    its next hardware touch. The liveness flag is read at CALL time, so
    programs linked before the failure fail too."""
    driver = group.driver

    def guard(fn):
        def wrapped(*args, **kwargs):
            if not group.alive:
                raise TileFailure(f"tile group {group.gid} is down")
            return fn(*args, **kwargs)
        return wrapped

    for slot in _GUARDED_SLOTS:
        fn = getattr(driver, slot)
        if fn is not None:
            setattr(driver, slot, guard(fn))
    link_compute = driver.link_compute
    if link_compute is not None:
        driver.link_compute = lambda op, attrs: guard(link_compute(op,
                                                                   attrs))


class TileMesh:
    """N tile-group drivers with split-phase cut-edge streams between them.

    The port's counterpart of the JAX package's ``TileMesh``. On one card
    each group is an eager driver with its own CUDA stream and arena (the
    card's free memory at creation split evenly: each group gets
    ``free // n_groups``), so a partitioned program's stages queue on their
    own streams and one group's barrier waits on its own queue only. A cut
    edge moves as a d2d ``DmaTicket`` (``stream``): issued when the
    producer stage completes, redeemed when the consumer stage starts.
    ``edge_stats`` accounts movement bytes per (src, dst) cut edge.

    ``device`` defaults to ``"cuda"`` and raises without it; the CPU has no
    streams, and its groups run in order.
    """

    def __init__(self, n_groups: int, device="cuda"):
        if n_groups < 1:
            raise ValueError(f"need >= 1 tile group, got {n_groups}")
        self.device = device_mod.resolve(device)
        self._share = max(ARENA_ALIGN, _arena_capacity(self.device)
                          // n_groups // ARENA_ALIGN * ARENA_ALIGN)
        self.groups: list[TileGroup] = [self._new_group(gid)
                                        for gid in range(n_groups)]
        # (src_gid, dst_gid) -> {"bytes", "transfers", "syms"}
        self.edge_stats: dict[tuple, dict] = {}
        # gid of the group running a partitioned stage: written by the
        # dispatcher thread (partition.execute), read by the watchdog to
        # target a hung dispatch's group (a single-writer race by design)
        self.active_gid: Optional[int] = None

    def _new_group(self, gid: int) -> TileGroup:
        """A guarded group: an eager driver with its own stream (none on
        the CPU) and the mesh's share of the arena."""
        stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        group = TileGroup(gid, make_eager_driver(
            self.device, arena_bytes=self._share, stream=stream))
        _guard_group(group)
        return group

    # ----------------------------------------------------------------- api
    @property
    def n_groups(self) -> int:
        return len(self.groups)

    @property
    def gids(self) -> range:
        return range(len(self.groups))

    def group(self, gid: int) -> TileGroup:
        return self.groups[gid]

    def alive(self, gid: int) -> bool:
        return self.groups[gid].alive

    def kill(self, gid: int) -> None:
        """Fault injection / watchdog preemption: the group fails at its
        next hardware touch, and its arena is quarantined until
        ``revive`` re-validates the pinned contents."""
        group = self.groups[gid]
        group.alive = False
        if group.driver.arena is not None:
            group.driver.arena.quarantine()

    def revive(self, gid: int, rimfs=None) -> None:
        """Bring a killed group back. With ``rimfs``, every file the
        group's driver holds resident is CRC-compared against the image
        (read back on the group's stream) before the quarantine lifts; a
        corrupted copy raises ``IntegrityError(kind="residency_crc")`` and
        the arena stays quarantined. Without ``rimfs`` the quarantine lifts
        unverified."""
        group = self.groups[gid]
        arena = group.driver.arena
        if arena is not None and arena.poisoned:
            if rimfs is not None:
                entry = rimfs._resident.get(id(group.driver))
                ri = entry[1] if entry is not None \
                    and entry[0]() is group.driver else None
                if ri is not None:
                    with group.driver.scope():
                        ok = ri.revalidate()
                    if not ok:
                        raise IntegrityError(
                            f"tile group {gid}: resident weights fail CRC "
                            f"re-validation — arena stays quarantined",
                            kind="residency_crc")
            arena.clear_quarantine()
        group.alive = True

    def spawn_replacement(self, gid: int) -> TileGroup:
        """Build (but do not install) a fresh guarded group for slot
        ``gid``: the caller pins and links against it, then splices it in
        with ``install_group``."""
        return self._new_group(gid)

    def install_group(self, group: TileGroup) -> TileGroup:
        """Splice a replacement group into its slot, returning the
        incumbent; the other groups are not touched."""
        if not (0 <= group.gid < len(self.groups)):
            raise ValueError(f"group gid {group.gid} outside mesh "
                             f"[0, {len(self.groups)})")
        old = self.groups[group.gid]
        self.groups[group.gid] = group
        return old

    @property
    def primary(self) -> HalDriver:
        """First live group's driver (weight residency / serving anchor)."""
        for g in self.groups:
            if g.alive:
                return g.driver
        raise TileFailure("no live tile group in mesh")

    def stream(self, sym: str, buf, src_gid: int, dst_gid: int):
        """Issue one cut-edge transfer src -> dst, split-phase, on the
        producer's stream: the destination driver's ``dma_async`` stamps
        the payload's CRC there and records the ticket's event there.
        Returns the ticket the consumer redeems (``dma_wait``) when its
        stage starts, or the buffer when the destination has no async
        slots. Bytes are accounted per directed edge."""
        driver = self.groups[dst_gid].driver
        with self.groups[src_gid].driver.scope():
            if driver.dma_async is not None:
                out = driver.dma_async(buf, "d2d", prefetched=True)
            else:
                out = driver.wait_dma(driver.initiate_dma(buf, "d2d"))
        # only issues that went out count (a dead destination raises above)
        st = self.edge_stats.setdefault(
            (src_gid, dst_gid), {"bytes": 0, "transfers": 0, "syms": set()})
        st["bytes"] += _size_of(buf)
        st["transfers"] += 1
        st["syms"].add(sym)
        return out

    def moved_bytes(self) -> int:
        return sum(st["bytes"] for st in self.edge_stats.values())
