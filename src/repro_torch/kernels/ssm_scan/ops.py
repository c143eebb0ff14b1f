"""Public wrapper for the selective-scan kernel, layout (B, T, di, N).

On a CUDA tensor it launches one of the two hand-written instances of
``csrc/ssm_scan.cu`` on the current stream, or raises: the ring instance
(operands streamed through shared memory by asynchronous 16-byte copies)
where its 16-byte rows allow, else the row-wise instance. ``plan_for``
picks the instance and its launch shape. On a CPU tensor it computes the
plain version (``ref.py``). Nothing falls back from one to the other. The
wrapper reaches either through the custom op ``torch.ops.aeg.ssm_scan``,
whose vmap rule folds the lane axis into B (one launch for every lane).
``ssm_scan.launches`` counts kernel launches. A ``plan`` ({"instance":
"ring", "w": W} or {"instance": "rowwise"}, an autotuned winner from
``kernels/registry.py``) takes the place of ``plan_for``'s where the ring
can run at all; both instances give the same bits.

For the dry run and the sharded paths the op also has a fake (``meta``)
implementation, a FLOP formula (``flops``) and a DTensor sharding rule
(``dtensor_rule``: batch or channels; the time axis stays whole).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.common import (DTYPE_CODE, check_float_dtype,
                                        check_rank, fold_lanes, sm_count,
                                        unfold_lanes)
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

STATE_SIZES = (4, 8, 16, 32)      # the CUDA kernel's template instances

RING, ROWWISE = "ring", "rowwise"
RING_WIDTHS = (128, 64, 32)       # lanes (threads) a ring block, widest first
MIN_BLOCKS_PER_SM = 2             # the widest block that gives each SM this
STAGE_STEPS = 32                  # S: steps a stage
DEPTH = 2                         # D: stages in the ring, one of them loading
SMEM_PER_BLOCK = 232448           # 227 KB: the most a ring block may have
ROWWISE_THREADS, ROWWISE_STEPS = 128, 16      # ssm_scan.cu's NT and CH


class Plan(NamedTuple):
    """One launch: the instance, W lanes a block, S steps a stage, D stages
    in the ring, the grid's blocks and a block's dynamic shared memory in
    bytes. The row-wise instance has 128 lanes a block, holds 16 steps in
    registers and no shared memory."""
    instance: str
    w: int
    s: int
    d: int
    blocks: int
    smem: int


def check_contract(da, bx, c) -> None:
    """The JAX package's shape/dtype contract as its registry applies it
    (chunk=1, d_block=1: any T and di tile), with the same ``ValueError``s."""
    for name, a, rank in (("da", da, 4), ("bx", bx, 4), ("c", c, 3)):
        check_rank("ssm_scan", name, a, rank)
    for name, a in (("da", da), ("bx", bx), ("c", c)):
        check_float_dtype("ssm_scan", name, a)
    b, t, di, n = da.shape
    if tuple(bx.shape) != tuple(da.shape):
        raise ValueError(
            f"ssm_scan: da/bx shapes differ: {tuple(da.shape)} vs "
            f"{tuple(bx.shape)}")
    if tuple(c.shape) != (b, t, n):
        raise ValueError(
            f"ssm_scan: c must be (B,T,N)=({b},{t},{n}), got "
            f"{tuple(c.shape)}")
    if t == 0:
        raise ValueError("ssm_scan: zero-length sequence (t=0)")
    if di == 0 or n == 0:
        raise ValueError(f"ssm_scan: zero-size state (di={di}, n={n})")


def ring_smem(w: int, s: int, d: int, n: int, esize: int) -> int:
    """A ring block's dynamic shared memory (``ring_smem_bytes`` in the
    source): D slots of S x (2W + N) elements."""
    return d * s * (2 * w + n) * esize


def ring_plan(b: int, di: int, n: int, esize: int, w: int, s: int,
              d: int) -> Plan:
    """The ring instance at a given W, S and D."""
    return Plan(RING, w, s, d, b * -(-di * n // w),
                ring_smem(w, s, d, n, esize))


def rowwise_plan(b: int, di: int, n: int) -> Plan:
    return Plan(ROWWISE, ROWWISE_THREADS, ROWWISE_STEPS, 2,
                b * -(-di * n // ROWWISE_THREADS), 0)


@functools.cache
def plan_for(b: int, di: int, n: int, dtype: torch.dtype, sms: int,
             aligned: bool = True) -> Plan:
    """The launch for one shape on a card of ``sms`` SMs, a pure function
    of its arguments. ``aligned``: every operand's base is 16-byte aligned.

    The ring needs rows of 16-byte units (N * element size a multiple of
    16) and aligned bases; else the row-wise instance runs. W is the
    widest of ``RING_WIDTHS`` that still gives every SM
    ``MIN_BLOCKS_PER_SM`` blocks (else the narrowest). S and D are
    ``STAGE_STEPS`` and ``DEPTH`` whatever T, so T does not enter: one
    stage computes while the next one loads, which was the fastest on the
    card at hymba's shape, where deeper rings were slower."""
    esize = torch.empty((), dtype=dtype).element_size()
    if not aligned or (n * esize) % 16:
        return rowwise_plan(b, di, n)
    lanes = di * n
    w = next((w for w in RING_WIDTHS
              if b * -(-lanes // w) >= MIN_BLOCKS_PER_SM * sms),
             RING_WIDTHS[-1])
    return ring_plan(b, di, n, esize, w, STAGE_STEPS, DEPTH)


def aligned16(*tensors) -> bool:
    """Every tensor's first element lies on a 16-byte boundary."""
    return all(a.data_ptr() % 16 == 0 for a in tensors)


def plan_of(da, bx, c, ring_w: int = 0) -> Plan:
    """The plan the wrapper takes for these (contiguous, CUDA) operands:
    ``plan_for``'s (``ring_w`` 0), the row-wise instance (-1) or the ring
    at W = ``ring_w`` lanes. Where the ring cannot run (rows not of 16-byte
    units, an unaligned operand) it is the row-wise instance whatever
    ``ring_w``."""
    b, _, di, n = da.shape
    default = plan_for(b, di, n, da.dtype, sm_count(da.device.index),
                       aligned16(da, bx, c))
    if ring_w == 0 or default.instance == ROWWISE:
        return default
    if ring_w < 0:
        return rowwise_plan(b, di, n)
    return ring_plan(b, di, n, da.element_size(), ring_w, STAGE_STEPS,
                     DEPTH)


def candidates() -> list:
    """The plans an autotune sweep times: the ring at each of
    ``RING_WIDTHS``, then the row-wise instance."""
    return [{"instance": RING, "w": w} for w in RING_WIDTHS] + \
        [{"instance": ROWWISE}]


def _ring_w(plan) -> int:
    """A plan dict as the custom op's int: 0 is ``plan_for``'s plan, -1 the
    row-wise instance, W > 0 the ring at W lanes."""
    if plan is None:
        return 0
    if plan["instance"] == ROWWISE:
        return -1
    if plan["instance"] != RING or int(plan["w"]) not in RING_WIDTHS:
        raise ValueError(f"ssm_scan: bad plan {plan!r}")
    return int(plan["w"])


def run_plan(da, bx, c, plan: Plan) -> torch.Tensor:
    """Launch ``plan``'s instance on contiguous CUDA operands of one dtype
    and return y. It counts nothing: the wrapper counts its launches;
    the card tests and ``chip_smoke.py`` call it to hold one instance or
    plan against another."""
    b, t, di, n = da.shape
    y = torch.empty((b, t, di), dtype=da.dtype, device=da.device)
    lib = build.library()
    code = DTYPE_CODE[da.dtype]
    with torch.cuda.device(da.device):       # launch on the operands' card
        stream = torch.cuda.current_stream(da.device).cuda_stream
        if plan.instance == RING:
            err = lib.aeg_ssm_scan_ring(
                da.data_ptr(), bx.data_ptr(), c.data_ptr(), y.data_ptr(), b,
                t, di, n, code, plan.w, plan.s, plan.d, stream)
        else:
            err = lib.aeg_ssm_scan_rowwise(
                da.data_ptr(), bx.data_ptr(), c.data_ptr(), y.data_ptr(), b,
                t, di, n, code, stream)
    build.check(lib, err, f"ssm_scan ({plan.instance})")
    return y


def ssm_scan(da: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
             plan=None) -> torch.Tensor:
    """da/bx: (B,T,di,N) with da the per-step log-decay (<= 0); c: (B,T,N).
    Returns y (B,T,di) in da's dtype, from a zero initial state."""
    check_contract(da, bx, c)
    if da.shape[-1] not in STATE_SIZES:
        raise ValueError(
            f"ssm_scan: state size N={da.shape[-1]} not supported by the "
            f"kernel; supported: {STATE_SIZES}")
    devices = {da.device, bx.device, c.device}
    if len(devices) != 1:
        raise ValueError(f"ssm_scan: operands on several devices "
                         f"{sorted(map(str, devices))}")
    if da.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"ssm_scan: unsupported device {da.device}")
    return _ssm_scan_op(da, bx, c, _ring_w(plan))


@torch.library.custom_op(
    "aeg::ssm_scan", mutates_args=(), device_types="cpu",
    schema="(Tensor da, Tensor bx, Tensor c, int ring_w) -> Tensor")
def _ssm_scan_op(da, bx, c, ring_w):
    """The op ``ssm_scan`` dispatches to: the plain version on the CPU, the
    hand kernel on CUDA (``_launch``), nothing elsewhere."""
    return ssm_scan_ref(da, bx, c)


@_ssm_scan_op.register_kernel("cuda")
def _launch(da, bx, c, ring_w):
    if bx.dtype != da.dtype or c.dtype != da.dtype:
        raise ValueError(f"ssm_scan: the kernel takes one dtype, got "
                         f"da {da.dtype}, bx {bx.dtype}, c {c.dtype}")
    da, bx, c = da.contiguous(), bx.contiguous(), c.contiguous()
    y = run_plan(da, bx, c, plan_of(da, bx, c, ring_w))
    ssm_scan.launches += 1
    return y


@_ssm_scan_op.register_vmap
def _vmap(info, in_dims, da, bx, c, ring_w):
    """Under ``torch.func.vmap`` the lane axis folds into B: one launch
    covers every lane."""
    n = info.batch_size
    return unfold_lanes(n, _ssm_scan_op(*fold_lanes(n, in_dims[:3],
                                                    (da, bx, c)),
                                        ring_w)), 0


ssm_scan.launches = 0


@_ssm_scan_op.register_fake
def _fake(da, bx, c, ring_w):
    b, t, di, _ = da.shape
    return da.new_empty((b, t, di))


@register_flop_formula(torch.ops.aeg.ssm_scan)
def flops(da_shape, bx_shape, c_shape, ring_w, *, out_shape=None, **kw):
    """About 5 operations a (t, d, n): the exp, the recurrence's
    multiply-add, the product with c and its share of the sum over n."""
    b, t, di, n = da_shape
    return 5 * b * t * di * n


def dtensor_rule(da, bx, c, ring_w):
    """Each mesh dim may split batch (dim 0 of every operand and y) or the
    channels D (dim 2 of da, bx and y; c whole); otherwise every operand
    is replicated."""
    from torch.distributed.tensor import Replicate, Shard
    return [([Replicate()], [Replicate()] * 3 + [None]),
            ([Shard(0)], [Shard(0)] * 3 + [None]),
            ([Shard(2)], [Shard(2), Shard(2), Replicate(), None])]
