"""Peephole optimizer over RCB op streams (RCTC's pre-emission pass).

Because control is *data*, optimizing a workload is list surgery on its op
stream — no retracing, no recompilation of model code.  RCTC runs this pass
before emitting a program; the executor and linker are unaware it exists.

Rules (DESIGN.md §5):

  F1  SCALE_SHIFT + RELU  ->  SCALE_SHIFT_RELU   (fused vtable slot)
  F2  ADD + RELU          ->  ADD_RELU           (fused vtable slot)
  E1  DEQUANT(s) + QUANTIZE(s) -> PASSTHROUGH    (exact round-trip elision:
      int8 -> fp32 -> int8 at the same scale reproduces the input bits,
      PROVIDED the int8 source came from an in-program QUANTIZE — those
      clip to [-127, 127]; a raw -128 would be re-clipped by the round
      trip but preserved by PASSTHROUGH, so unknown-provenance sources
      only elide with ``lossy=True``)
  E2  QUANTIZE(s) + DEQUANT(s) -> PASSTHROUGH    (LOSSY — the fp->int8->fp
      trip rounds; only applied with ``lossy=True``)
  C1  adjacent DMA / copy coalescing: a copy chain through a single-use
      scratch collapses to one transfer (H2D+D2D -> H2D, D2D+D2H -> D2H,
      D2D+D2D -> D2D, PASSTHROUGH chains, ...)
  D1  dead scratch / op elimination: side-effect-free ops whose results are
      never read are removed (to fixpoint), along with their scratch
      descriptors.

Every rule except E2 is bit-exact: fused slots execute the identical
primitive sequence, elision/coalescing only remove ops whose outputs are
reproduced exactly.  All rules fire only when the intermediate is a
single-use scratch, so observable buffers (inputs/outputs/weights) are
never touched.
"""
from __future__ import annotations

import collections
from typing import Optional

from repro_torch.core.rcb import Op, RCB, RCBOp, RCBProgram

# compute ops + buffer-table ops with no effect beyond their dst buffer
_PURE = {
    Op.ALLOC, Op.FREE, Op.BIND_CONST, Op.GEMM, Op.CONV2D, Op.DENSE, Op.ADD,
    Op.RELU, Op.SOFTMAX, Op.MAXPOOL, Op.AVGPOOL_GLOBAL, Op.SCALE_SHIFT,
    Op.QUANTIZE, Op.DEQUANT, Op.RESHAPE, Op.GEMM_I8, Op.CONV2D_I8,
    Op.PASSTHROUGH, Op.SCALE_SHIFT_RELU, Op.ADD_RELU,
    # LM-layer ops (per-layer RCTC lowering): side-effect-free computes,
    # eligible for dead-scratch elimination like any other compute slot.
    Op.RMSNORM, Op.ROPE, Op.SILU_MUL,
    Op.ATTENTION, Op.MATMUL_INT8, Op.SSM_SCAN, Op.WKV6,
}

_FUSE_RELU = {Op.SCALE_SHIFT: Op.SCALE_SHIFT_RELU, Op.ADD: Op.ADD_RELU}

# copy-chain coalescing: (first, second) -> coalesced transfer kind
_COALESCE = {
    (Op.DMA_H2D, Op.DMA_D2D): Op.DMA_H2D,
    (Op.DMA_H2D, Op.PASSTHROUGH): Op.DMA_H2D,
    (Op.DMA_D2D, Op.DMA_D2D): Op.DMA_D2D,
    (Op.DMA_D2D, Op.DMA_D2H): Op.DMA_D2H,
    (Op.DMA_D2D, Op.PASSTHROUGH): Op.DMA_D2D,
    (Op.PASSTHROUGH, Op.PASSTHROUGH): Op.PASSTHROUGH,
    (Op.PASSTHROUGH, Op.DMA_D2D): Op.DMA_D2D,
    (Op.PASSTHROUGH, Op.DMA_D2H): Op.DMA_D2H,
}


def op_count(prog: RCBProgram) -> int:
    return sum(len(b.ops) for b in prog.blocks)


def _use_counts(blocks: list) -> tuple:
    """Global read/write counts per symbol across ALL blocks — peephole
    windows are per-block, but safety is whole-program."""
    reads: collections.Counter = collections.Counter()
    writes: collections.Counter = collections.Counter()
    for ops in blocks:
        for op in ops:
            reads.update(op.srcs)
            writes.update(op.dsts)
    return reads, writes


def _single_use_scratch(sym: str, tensors: dict, reads, writes) -> bool:
    t = tensors.get(sym)
    return (t is not None and t.kind == "scratch"
            and reads[sym] == 1 and writes[sym] == 1)


def _pair_pass(blocks: list, tensors: dict, lossy: bool) -> bool:
    """One sweep of the two-op window rules (F1/F2/E1/E2/C1)."""
    reads, writes = _use_counts(blocks)
    # int8 symbols with known clipped range [-127, 127] (E1 exactness)
    quantized = {op.dsts[0] for ops in blocks for op in ops
                 if op.op is Op.QUANTIZE and op.dsts}
    changed = False
    for bi, ops in enumerate(blocks):
        out: list = []
        i = 0
        while i < len(ops):
            a = ops[i]
            b = ops[i + 1] if i + 1 < len(ops) else None
            fused: Optional[RCBOp] = None
            if (b is not None and a.dsts and b.srcs == (a.dsts[0],)
                    and _single_use_scratch(a.dsts[0], tensors, reads,
                                            writes)):
                mid = a.dsts[0]
                if b.op is Op.RELU and a.op in _FUSE_RELU:
                    fused = RCBOp(_FUSE_RELU[a.op], b.dsts, a.srcs, a.attrs)
                elif (a.op is Op.DEQUANT and b.op is Op.QUANTIZE
                      and a.attrs.get("scale") == b.attrs.get("scale")
                      and (lossy or a.srcs[0] in quantized)):
                    fused = RCBOp(Op.PASSTHROUGH, b.dsts, a.srcs)
                elif (lossy and a.op is Op.QUANTIZE and b.op is Op.DEQUANT
                      and a.attrs.get("scale") == b.attrs.get("scale")):
                    fused = RCBOp(Op.PASSTHROUGH, b.dsts, a.srcs)
                elif (a.op, b.op) in _COALESCE:
                    fused = RCBOp(_COALESCE[(a.op, b.op)], b.dsts, a.srcs)
                if fused is not None:
                    # keep counters consistent for later windows this sweep
                    reads[mid] -= 1
                    writes[mid] -= 1
                    reads.update(fused.srcs)
                    for s in a.srcs:
                        reads[s] -= 1
            if fused is not None:
                out.append(fused)
                i += 2
                changed = True
            else:
                out.append(a)
                i += 1
        blocks[bi] = out
    return changed


def _dead_pass(blocks: list, tensors: dict) -> bool:
    """Remove side-effect-free ops whose dsts are never-read scratch."""
    reads, _writes = _use_counts(blocks)
    changed = False
    for bi, ops in enumerate(blocks):
        out = []
        for op in ops:
            if (op.op in _PURE and op.dsts
                    and all(tensors.get(d) is not None
                            and tensors[d].kind == "scratch"
                            and reads[d] == 0 for d in op.dsts)):
                for s in op.srcs:
                    reads[s] -= 1          # may cascade on the next sweep
                changed = True
                continue
            out.append(op)
        blocks[bi] = out
    return changed


def optimize(prog: RCBProgram, lossy: bool = False) -> RCBProgram:
    """Run all peephole rules to fixpoint; returns a new RCBProgram.

    Block boundaries, ids and deps are preserved (an emptied block stays as
    an empty RCB so dependency edges keep resolving).
    """
    blocks = [list(b.ops) for b in prog.blocks]
    for _ in range(64):                        # fixpoint, bounded
        changed = _pair_pass(blocks, prog.tensors, lossy)
        changed |= _dead_pass(blocks, prog.tensors)
        if not changed:
            break
    # drop scratch descriptors no longer referenced by any op
    referenced: set = set()
    for ops in blocks:
        for op in ops:
            referenced.update(op.dsts)
            referenced.update(op.srcs)
    tensors = {n: t for n, t in prog.tensors.items()
               if t.kind != "scratch" or n in referenced}
    new_blocks = [RCB(b.block_id, b.block_type, b.deps, tuple(ops))
                  for b, ops in zip(prog.blocks, blocks)]
    out = RCBProgram(prog.name, tensors, new_blocks, prog.artifacts)
    out.validate()
    return out
