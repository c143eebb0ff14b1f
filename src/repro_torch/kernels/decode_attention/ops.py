"""Public wrapper for the one-token decode-attention kernel.

``decode_attention(q, k, v, pos, tables=None)`` attends each lane's new
token q (B, 1, H, D) over its valid cache rows: dense k/v (B, S, Hkv, D),
or a block pool (N, bs, Hkv, D) read through block tables (lanes, W),
lanes >= B, so S = W * bs. Lane b's valid rows are those below min(pos[b]
+ 1, S): in a sliding window's ring every row once pos >= S. It returns
(B, 1, H, D) in q's dtype.

The wrapper checks the contract and calls the custom op
``torch.ops.aeg.decode_attention``. On a CUDA tensor the op launches the
hand-written split-KV kernel (``csrc/decode_attention.cu``) on the current
stream, or raises; on a CPU tensor it computes the plain version
(``ref.py``), the arithmetic the port's decode took on stock ops. Nothing
falls back from one to the other. ``decode_attention.launches`` counts
calls that launched the kernel (each is two launches: the splits, then
their combine).

The kernel cuts each lane's rows into splits of ``split_len`` rows,
``plan(rows, lanes, hkv, sms)`` from the cache's rows, the number of
(lane, kv head) pairs and the card's SM count: the same shapes give the
same splits, and the same splits the same bits, whether the rows sit in a
dense cache or behind block tables. For the dry run the op has a fake
(``meta``) implementation and a FLOP formula over the valid rows.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.common import (DTYPE_CODE, check_float_dtype,
                                        check_rank, sm_count)
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      valid_rows)

HEAD_DIMS = (16, 64, 128)         # the CUDA kernel's template instances
MAX_GROUP = 8                     # query heads a kv head, at most
SPLIT_ROWS = 64                   # a split's length is a multiple of this
# Blocks of (lane, kv head, split) to aim for, per SM: a split that starts
# past its lane's valid rows returns at once, so a ragged batch leaves
# many of them empty.
BLOCKS_PER_SM = 16


def plan(rows: int, lanes: int, hkv: int, sms: int) -> tuple:
    """(split_len, n_splits) for caches of ``rows`` rows over ``lanes``
    lanes of ``hkv`` kv heads on a card of ``sms`` SMs: enough splits that
    a full batch fills the card, each a multiple of ``SPLIT_ROWS`` rows."""
    want = _cdiv(BLOCKS_PER_SM * sms, lanes * hkv)
    n = max(1, min(want, _cdiv(rows, SPLIT_ROWS)))
    split_len = _cdiv(_cdiv(rows, n), SPLIT_ROWS) * SPLIT_ROWS
    return split_len, _cdiv(rows, split_len)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def check_contract(q, k, v, pos, tables=None) -> None:
    """Shapes and dtypes the op takes, on any device (``ValueError``); the
    kernel takes float32, bfloat16 and float16 of these, the plain version
    any floating dtype."""
    for name, a in (("q", q), ("k", k), ("v", v)):
        check_rank("decode_attention", name, a, 4)
        if not a.is_floating_point():
            raise ValueError(f"decode_attention: operand {name!r} has "
                             f"non-floating dtype {a.dtype}")
    b, one, h, d = q.shape
    _, _, hkv, dk = k.shape
    if one != 1:
        raise ValueError(f"decode_attention: q must be (B, 1, H, D), one "
                         f"token a lane, got {tuple(q.shape)}")
    if tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"decode_attention: k/v shapes differ: "
                         f"{tuple(k.shape)} vs {tuple(v.shape)}")
    if dk != d:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree on head_dim")
    if hkv == 0 or h % hkv != 0:
        raise ValueError(f"decode_attention: GQA grouping requires "
                         f"num_heads % num_kv_heads == 0, got h={h}, "
                         f"hkv={hkv}")
    if pos.ndim != 1 or pos.shape[0] != b or pos.is_floating_point():
        raise ValueError(f"decode_attention: pos must be (B,) = ({b},) "
                         f"integers, got {tuple(pos.shape)} {pos.dtype}")
    if tables is None:
        if k.shape[0] != b or k.shape[1] == 0:
            raise ValueError(f"decode_attention: a dense cache is (B, S, "
                             f"Hkv, D) with B = {b} and S > 0, got "
                             f"{tuple(k.shape)}")
    elif (tables.ndim != 2 or tables.shape[0] < b or tables.shape[1] == 0
          or tables.is_floating_point()):
        raise ValueError(f"decode_attention: tables must be (lanes, W) "
                         f"integers with lanes >= B = {b}, got "
                         f"{tuple(tables.shape)} {tables.dtype}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor,
                     tables: torch.Tensor = None) -> torch.Tensor:
    """q (B,1,H,D); k/v dense (B,S,Hkv,D), or a block pool (N,bs,Hkv,D)
    with ``tables`` (lanes, W); pos (B,) ints. Returns (B,1,H,D) in q's
    dtype."""
    check_contract(q, k, v, pos, tables)
    operands = (q, k, v, pos) + ((tables,) if tables is not None else ())
    devices = {a.device for a in operands}
    if len(devices) != 1:
        raise ValueError(f"decode_attention: operands on several devices "
                         f"{sorted(map(str, devices))}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    split_len = 0
    if q.is_cuda:
        rows = k.shape[1] * (tables.shape[1] if tables is not None else 1)
        lanes = tables.shape[0] if tables is not None else q.shape[0]
        split_len, _ = plan(rows, lanes, k.shape[2],
                            sm_count(q.device.index))
    return _decode_attention_op(q, k, v, pos, tables, split_len)


@torch.library.custom_op(
    "aeg::decode_attention", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, Tensor pos, Tensor? tables, "
           "int split_len) -> Tensor")
def _decode_attention_op(q, k, v, pos, tables, split_len):
    """The op ``decode_attention`` dispatches to: the plain version on the
    CPU, the hand kernel on CUDA (``_launch``), nothing elsewhere."""
    return decode_attention_ref(q, k, v, pos, tables)


@_decode_attention_op.register_kernel("cuda")
def _launch(q, k, v, pos, tables, split_len):
    check_float_dtype("decode_attention", "q", q)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention: the kernel takes one dtype, got "
                         f"q {q.dtype}, k {k.dtype}, v {v.dtype}")
    b, _, h, d = q.shape
    hkv = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {d} not supported by "
                         f"the kernel; supported: {HEAD_DIMS}")
    if h // hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: the kernel takes at most "
                         f"{MAX_GROUP} query heads a kv head, got {h // hkv}")
    if pos.dtype != torch.int32 or (tables is not None
                                    and tables.dtype != torch.int32):
        raise ValueError("decode_attention: the kernel takes int32 pos and "
                         "tables")
    for name, a in (("k", k), ("v", v)):
        # the cache is read in place: a copy would cost what the kernel saves
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be contiguous "
                             f"and start on a 16-byte boundary")
    q = q.contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    if split_len <= 0:
        raise ValueError(f"decode_attention: split_len must be positive, got "
                         f"{split_len} (``plan`` gives it)")
    pos = pos.contiguous()
    if tables is not None:
        tables = tables.contiguous()
    bs, W = k.shape[1], tables.shape[1] if tables is not None else 1
    rows = bs * W
    n_splits = _cdiv(rows, split_len)
    G = h // hkv
    part_o = torch.empty((b, hkv, n_splits, G, d), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((b, hkv, n_splits, G, 2), dtype=torch.float32,
                          device=q.device)
    o = torch.empty_like(q)
    lib = build.library()
    with torch.cuda.device(q.device):        # launch on the operands' card
        err = lib.aeg_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            tables.data_ptr() if tables is not None else None,
            part_o.data_ptr(), part_ml.data_ptr(), o.data_ptr(), b, rows,
            hkv, G, d, bs, W, split_len, n_splits, DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "decode_attention")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0


@_decode_attention_op.register_fake
def _fake(q, k, v, pos, tables, split_len):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.aeg.decode_attention, get_raw=True)
def flops(q, k, v, pos, tables, split_len, *, out_val=None, **kw):
    """q.k and p.v over each lane's valid rows: 4 D operations a row a
    query head. On ``meta`` the positions have no values, and every row
    counts."""
    b, _, h, d = q.shape
    rows = k.shape[1] * (tables.shape[1] if tables is not None else 1)
    if pos.device.type == "meta":
        attended = b * rows
    else:
        attended = int(valid_rows(pos, rows).sum())
    return 4 * d * h * attended
