"""Paged KV-cache management (vLLM-style block tables) on RBL principles.

The port's counterpart of ``repro.serving.paged_cache``. Physical cache
blocks are one flat pool on the device, allocated once; sequences hold
*symbolic* block tables, and binding a logical token position to a
physical slot is an O(1) table lookup, so sequences grow and free blocks
without ever copying KV data.

The pool carries one extra physical row, the **null block**, that never
enters the free list. Block tables padded with the null-block id are legal
device inputs: the paged prefill and decode steps (launch/steps.py) write
pad lanes into the null row and gather it back behind the mask. The pool is
allocated with ``torch.zeros``: a row no token has written yet (and the
null row) is gathered back behind the mask, where the softmax gives it a
weight of exactly 0, and 0 x NaN in the P.V product would be NaN.
Writes are in-place index writes into the pool (what the JAX package's
donated ``_scatter_token`` buys there); the pool is never rebound, so a
CUDA graph may bake in its address.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.dtypes import as_tensor, torch_dtype


class OutOfBlocksError(RuntimeError):
    """KV block pool exhausted.

    Raised by host-side ``allocate``/``_grow``. On the serving path this
    never escapes a decode step: block-aware admission (PagedServingEngine)
    consults the free blocks *before* placing a request and converts an
    infeasible reservation into a shed verdict.
    """


@dataclasses.dataclass
class PagedKVCache:
    """Physical pool + symbolic block tables.

    Pool layout: k/v tensors (num_layers, num_blocks + 1, block_size, Hkv,
    D) on ``device``. Row ``num_blocks`` is the null block (write target
    for padded lanes; never allocated). A sequence's logical position t
    lives in physical slot (table[t // block_size], t % block_size).
    """
    num_layers: int
    num_blocks: int
    block_size: int
    num_kv_heads: int
    head_dim: int
    dtype: str = "float32"
    device: object = "cuda"

    def __post_init__(self):
        self.device = device_mod.resolve(self.device)
        shape = (self.num_layers, self.num_blocks + 1, self.block_size,
                 self.num_kv_heads, self.head_dim)
        dt = torch_dtype(self.dtype)
        self.k = torch.zeros(shape, dtype=dt, device=self.device)
        self.v = torch.zeros(shape, dtype=dt, device=self.device)
        self._free: list[int] = list(range(self.num_blocks))[::-1]
        self.tables: dict[int, list[int]] = {}     # seq id -> block ids
        self.lengths: dict[int, int] = {}
        self._arena_ranges: list = []              # (arena, offset) pairs

    # ------------------------------------------------------------ accounting
    @property
    def null_block(self) -> int:
        """Physical id of the never-allocated pad/garbage row."""
        return self.num_blocks

    def free_blocks(self) -> int:
        return len(self._free)

    def blocks_for(self, seq: int) -> list:
        return list(self.tables.get(seq, ()))

    def utilization(self) -> float:
        used = self.num_blocks - len(self._free)
        return used / self.num_blocks

    def blocks_needed(self, tokens: int) -> int:
        """Blocks a ``tokens``-long sequence occupies."""
        return (tokens + self.block_size - 1) // self.block_size

    def can_admit(self, tokens: int) -> bool:
        """Would a worst-case reservation for ``tokens`` fit right now?"""
        return self.blocks_needed(tokens) <= self.free_blocks()

    def pool_bytes(self) -> int:
        return (self.k.numel() * self.k.element_size()
                + self.v.numel() * self.v.element_size())

    # ------------------------------------------------------------- lifecycle
    def allocate(self, seq: int, tokens: int = 0) -> None:
        if seq in self.tables:
            raise ValueError(f"seq {seq} already allocated")
        self.tables[seq] = []
        self.lengths[seq] = 0
        if tokens:
            try:
                self._grow(seq, tokens)
            except OutOfBlocksError:
                # failed reservations must not leak a half-grown table
                self.release(seq)
                raise

    def _grow(self, seq: int, new_tokens: int) -> None:
        need = self.blocks_needed(self.lengths[seq] + new_tokens)
        while len(self.tables[seq]) < need:
            if not self._free:
                raise OutOfBlocksError(
                    f"pool exhausted ({self.num_blocks} blocks)")
            self.tables[seq].append(self._free.pop())

    def advance(self, seq: int, n: int = 1) -> None:
        """Mark ``n`` tokens as written by a device-side write (the paged
        prefill and decode steps own the pool writes; the host only tracks
        lifetimes). Grows the table if the reservation did not already
        cover the new length."""
        self._grow(seq, n)
        self.lengths[seq] += n

    def release(self, seq: int) -> int:
        """Free all blocks of a finished sequence (O(1) per block, no data
        movement — the RBL lifetime-management property)."""
        blocks = self.tables.pop(seq, [])
        self.lengths.pop(seq, None)
        self._free.extend(blocks)
        return len(blocks)

    # ------------------------------------------------- device-side addressing
    def table_array(self, seqs: Sequence[int], width: Optional[int] = None,
                    rows: Optional[int] = None) -> np.ndarray:
        """(rows, width) int32 block-table array for a batch of sequences,
        padded with the null block — the device input the paged steps
        address the pool through. ``rows`` pads the batch axis (pad lanes
        write into the null row)."""
        if width is None:
            width = max((len(self.tables.get(s, ())) for s in seqs),
                        default=1) or 1
        rows = len(seqs) if rows is None else rows
        out = np.full((rows, width), self.null_block, np.int32)
        for i, s in enumerate(seqs):
            t = self.tables.get(s, ())
            out[i, :len(t)] = t[:width]
        return out

    def lengths_array(self, seqs: Sequence[int],
                      rows: Optional[int] = None) -> np.ndarray:
        rows = len(seqs) if rows is None else rows
        out = np.zeros((rows,), np.int32)
        for i, s in enumerate(seqs):
            out[i] = self.lengths.get(s, 0)
        return out

    # ------------------------------------------------------ arena residency
    def register_residency(self, driver) -> int:
        """Register the pool's pages with the driver's DeviceArena so the
        residency layer (arena telemetry, later fleet reshapes) sees KV
        memory like any other resident buffer. Returns the bytes registered
        (0 when the driver has no arena)."""
        arena = getattr(driver, "arena", None)
        if arena is None:
            return 0
        for buf in (self.k, self.v):
            self._arena_ranges.append(
                (arena, arena.alloc(buf.numel() * buf.element_size())))
        return self.pool_bytes()

    def unregister_residency(self) -> None:
        """Return the pool's arena ranges (engine close / pool teardown)."""
        ranges, self._arena_ranges = self._arena_ranges, []
        for arena, off in ranges:
            arena.free(off)

    # ------------------------------------------------------------------- io
    def append(self, seq: int, layer_k, layer_v) -> None:
        """Append one token's K/V for ALL layers, written in place.
        layer_k/v: (num_layers, Hkv, D)."""
        self._grow(seq, 1)
        t = self.lengths[seq]
        blk = self.tables[seq][t // self.block_size]
        off = t % self.block_size
        self.k[:, blk, off] = as_tensor(layer_k, self.device).to(self.k.dtype)
        self.v[:, blk, off] = as_tensor(layer_v, self.device).to(self.v.dtype)
        self.lengths[seq] = t + 1

    def gather(self, seq: int, layer: int):
        """Contiguous (len, Hkv, D) copies of one sequence's K/V at a layer
        (gathered over the block axis)."""
        n = self.lengths[seq]
        if n == 0:
            # empties in the pool's dtype: downstream concatenation or
            # attention on a bf16/f16 pool must not silently upcast
            empty = self.k.new_zeros((0, self.num_kv_heads, self.head_dim))
            return empty, empty
        table = torch.as_tensor(self.tables[seq], dtype=torch.long,
                                device=self.device)
        kb = self.k[layer][table]                       # (blocks, bs, H, D)
        vb = self.v[layer][table]
        flat_k = kb.reshape(-1, self.num_kv_heads, self.head_dim)[:n]
        flat_v = vb.reshape(-1, self.num_kv_heads, self.head_dim)[:n]
        return flat_k, flat_v


def paged_decode_attention(cache: PagedKVCache, seq: int, layer: int, q):
    """Single-token attention against a paged sequence.
    q: (H, D) with H = G * Hkv. Returns (H, D).

    Attention over zero stored tokens has no defined value (the softmax
    normalizes an empty axis into NaNs) — that is a caller bug, surfaced
    as ``ValueError`` instead of NaN propagation."""
    if cache.lengths.get(seq, 0) == 0:
        raise ValueError(
            f"attention over zero-length sequence {seq}: prefill (or "
            f"append) must store at least one token first")
    k, v = cache.gather(seq, layer)                     # (n, Hkv, D)
    h, d = q.shape
    g = h // cache.num_kv_heads
    qg = q.reshape(cache.num_kv_heads, g, d).float()
    s = torch.einsum("hgd,nhd->hgn", qg, k.float()) / d ** 0.5
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("hgn,nhd->hgd", p, v.float())
    return o.reshape(h, d).to(q.dtype)
