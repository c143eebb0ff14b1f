"""Public wrappers for the INT8 GEMM kernel: x (M, K) int8 times w (K, N)
int8 with an int32 accumulator.

``int8_matmul`` returns ``f32(acc) * scale[n]`` in fp32, bf16 or f16 (the
JAX package's ``int8_matmul``, ``Op.MATMUL_INT8``); ``int8_matmul_i32``
returns the raw int32 sums (``Op.GEMM_I8``, and ``Op.CONV2D_I8`` after an
im2col). Each calls its custom op (``torch.ops.aeg.int8_matmul``,
``torch.ops.aeg.int8_matmul_i32``). On CUDA tensors both launch the
hand-written kernel (``csrc/int8_matmul.cu``) on the current stream, or
raise; on CPU tensors they compute the plain version (``ref.py``). Nothing
falls back from one to the other. Under ``torch.func.vmap`` the lane axis
folds into M when only x carries it, else the kernel launches once per
lane. ``int8_matmul.launches`` counts the kernel's launches through
either wrapper. Each takes a ``plan`` ({"tile": code, "splits": n}, an
autotuned winner from ``kernels/registry.py``); without one the kernel
takes ``plan_for``'s.
"""
from __future__ import annotations

import torch

from repro_torch.dtypes import name_of, torch_dtype
from repro_torch.kernels import build
from repro_torch.kernels.common import (DTYPE_CODE, FLOAT_DTYPES,
                                        check_rank, fold_lanes, lane,
                                        sm_count, unfold_lanes)
from repro_torch.kernels.int8_matmul.ref import (int8_matmul_i32_ref,
                                                 int8_matmul_ref)

# the kernel's block tiles, (rows, columns) of out, by their code at the C
# interface, in the order the plan prefers them
TILES = ((128, 64), (64, 64))
_STEP_K = 64                   # the kernel's k step
_MIN_STEPS_PER_SPLIT = 2       # k steps a split-K block takes at least


def _dtype_name(dt: torch.dtype) -> str:
    try:
        return name_of(dt)
    except ValueError:
        return str(dt)


def _check_operands(x, w) -> None:
    check_rank("int8_matmul", "x", x, 2)
    check_rank("int8_matmul", "w", w, 2)


def _check_int8(x, w) -> None:
    for name, a in (("x", x), ("w", w)):
        if a.dtype != torch.int8:
            raise ValueError(f"int8_matmul: operand {name!r} must be int8, "
                             f"got {_dtype_name(a.dtype)}")


def _check_shapes(x, w) -> tuple:
    m, k = x.shape
    kw, n = w.shape
    if m == 0 or k == 0 or n == 0:
        raise ValueError(
            f"int8_matmul: zero-size operand (m={m}, k={k}, n={n})")
    if kw != k:
        raise ValueError(
            f"int8_matmul: contraction mismatch x {tuple(x.shape)} vs "
            f"w {tuple(w.shape)}")
    return m, k, n


def check_contract(x, w, scale) -> None:
    """The JAX package's shape/dtype contract as its registry applies it
    (block sizes 1: any M, N, K), with the same ``ValueError``s."""
    _check_operands(x, w)
    check_rank("int8_matmul", "scale", scale, 1)
    _check_int8(x, w)
    if not scale.dtype.is_floating_point:
        raise ValueError(f"int8_matmul: scale must be floating, got "
                         f"{_dtype_name(scale.dtype)}")
    _, _, n = _check_shapes(x, w)
    if scale.shape[0] != n:
        raise ValueError(
            f"int8_matmul: scale must be per-out-channel (n={n},), got "
            f"{tuple(scale.shape)}")


def check_contract_i32(x, w) -> None:
    """The int32-out variant's contract: two int8 matrices that contract."""
    _check_operands(x, w)
    _check_int8(x, w)
    _check_shapes(x, w)


def _device_of(*tensors) -> torch.device:
    devices = {a.device for a in tensors}
    if len(devices) != 1:
        raise ValueError(f"int8_matmul: operands on several devices "
                         f"{sorted(map(str, devices))}")
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_matmul: unsupported device {dev}")
    return dev


def _tiles(m: int, n: int, code: int) -> int:
    rows, cols = TILES[code]
    return -(-m // rows) * -(-n // cols)


def plan_for(m: int, n: int, k: int, sms: int) -> tuple:
    """The kernel's tile plan, ``(tile code, K splits)``, a pure function
    of the shape and the card's SM count. The larger tile is taken where it
    still gives every SM a block. Where even the 64 x 64 tile leaves SMs
    without a block, K is split to give every SM one, each split taking at
    least ``_MIN_STEPS_PER_SPLIT`` k steps, and no split left empty."""
    for code in range(len(TILES)):
        if _tiles(m, n, code) >= sms:
            return code, 1
    code = len(TILES) - 1
    tiles = _tiles(m, n, code)
    steps = -(-k // _STEP_K)
    want = min(-(-sms // tiles), steps // _MIN_STEPS_PER_SPLIT)
    if want <= 1:
        return code, 1
    per = -(-steps // want)                  # k steps a split takes
    return code, -(-steps // per)


def splits_for(m: int, n: int, k: int, sms: int) -> int:
    """How many ways the kernel splits K (the plan's second half)."""
    return plan_for(m, n, k, sms)[1]


def normal_splits(k: int, want: int) -> int:
    """``want`` K splits as the kernel takes them: each split the same
    number of k steps, none left empty (``plan_for``'s rule)."""
    steps = -(-k // _STEP_K)
    per = -(-steps // max(1, min(int(want), steps)))
    return -(-steps // per)


def candidates(m: int, n: int, k: int, sms: int) -> list:
    """The plans an autotune sweep times at one shape: every tile, each
    with K unsplit and split 2 to 16 ways where every split keeps
    ``_MIN_STEPS_PER_SPLIT`` k steps; ``plan_for``'s plan first."""
    tile, splits = plan_for(m, n, k, sms)
    out = [{"tile": tile, "splits": splits}]
    steps = -(-k // _STEP_K)
    for code in range(len(TILES)):
        for want in (1, 2, 3, 4, 6, 8, 12, 16):
            if want > 1 and steps // want < _MIN_STEPS_PER_SPLIT:
                continue
            plan = {"tile": code, "splits": normal_splits(k, want)}
            if plan not in out:
                out.append(plan)
    return out


def _plan_args(plan) -> tuple:
    """A plan dict as the custom ops' (tile, splits) ints; (-1, 0) is
    ``plan_for``'s plan."""
    if plan is None:
        return -1, 0
    tile, splits = int(plan["tile"]), int(plan["splits"])
    if not 0 <= tile < len(TILES) or splits < 1:
        raise ValueError(f"int8_matmul: bad plan {plan!r}")
    return tile, splits


def _launch(x, w, scale, out, out_code: int, tile: int = -1,
            splits: int = 0) -> torch.Tensor:
    m, k = x.shape
    n = w.shape[1]
    x, w = x.contiguous(), w.contiguous()
    if tile < 0:
        tile, splits = plan_for(m, n, k, sm_count(x.device.index))
    else:
        splits = normal_splits(k, splits)
    acc = None
    if splits > 1 and out_code >= 0:
        acc = torch.empty((m, n), dtype=torch.int32, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):        # launch on the operands' card
        err = lib.aeg_int8_matmul(
            x.data_ptr(), w.data_ptr(),
            None if scale is None else scale.data_ptr(), out.data_ptr(),
            None if acc is None else acc.data_ptr(), m, n, k, tile, splits,
            out_code, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "int8_matmul")
    int8_matmul.launches += 1
    return out


def int8_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                out_dtype: torch.dtype = torch.float32,
                plan=None) -> torch.Tensor:
    """x: (M, K) int8; w: (K, N) int8; scale: (N,) floating, per output
    channel, already times the activation scale. Returns
    ``f32(x @ w) * scale`` as (M, N) ``out_dtype``. ``plan``: the tile
    and K splits on CUDA (``plan_for``'s when None); every plan gives the
    same bits."""
    check_contract(x, w, scale)
    if out_dtype not in FLOAT_DTYPES:
        raise ValueError(f"int8_matmul: unsupported out_dtype {out_dtype}; "
                         f"supported: float32, bfloat16, float16")
    _device_of(x, w, scale)
    return _scaled_op(x, w, scale, name_of(out_dtype), *_plan_args(plan))


def int8_matmul_i32(x: torch.Tensor, w: torch.Tensor,
                    plan=None) -> torch.Tensor:
    """x: (M, K) int8; w: (K, N) int8. Returns the exact int32 sums."""
    check_contract_i32(x, w)
    _device_of(x, w)
    return _i32_op(x, w, *_plan_args(plan))


@torch.library.custom_op(
    "aeg::int8_matmul", mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor w, Tensor scale, str out_dtype, int tile, "
           "int splits) -> Tensor")
def _scaled_op(x, w, scale, out_dtype, tile, splits):
    """The op ``int8_matmul`` dispatches to: the plain version on the CPU,
    the hand kernel on CUDA, nothing elsewhere."""
    return int8_matmul_ref(x, w, scale, torch_dtype(out_dtype))


@_scaled_op.register_kernel("cuda")
def _scaled_cuda(x, w, scale, out_dtype, tile, splits):
    dt = torch_dtype(out_dtype)
    scale = scale.float().contiguous()   # exact, as the TPU kernel reads it
    out = torch.empty((x.shape[0], w.shape[1]), dtype=dt, device=x.device)
    return _launch(x, w, scale, out, DTYPE_CODE[dt], tile, splits)


@torch.library.custom_op(
    "aeg::int8_matmul_i32", mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor w, int tile, int splits) -> Tensor")
def _i32_op(x, w, tile, splits):
    """The op ``int8_matmul_i32`` dispatches to, as ``_scaled_op``."""
    return int8_matmul_i32_ref(x, w)


@_i32_op.register_kernel("cuda")
def _i32_cuda(x, w, tile, splits):
    out = torch.empty((x.shape[0], w.shape[1]), dtype=torch.int32,
                      device=x.device)
    return _launch(x, w, None, out, -1, tile, splits)


def _lanes(op, info, in_dims, tensors, extra=()):
    """vmap rule of both ops. Where only x carries the lane axis, it folds
    into M: one launch covers every lane. Where w (or scale) carries it,
    as for a ``MATMUL_INT8`` program whose w is a request input, the lanes
    share no operand the kernel could stack along M, so the rule launches
    the kernel once per lane (``info.batch_size`` launches) and stacks the
    outputs."""
    n = info.batch_size
    if all(d is None for d in in_dims[1:len(tensors)]):
        (x,) = fold_lanes(n, in_dims[:1], tensors[:1])
        return unfold_lanes(n, op(x, *tensors[1:], *extra)), 0
    return torch.stack([
        op(*(lane(t, d, j) for t, d in zip(tensors, in_dims)), *extra)
        for j in range(n)]), 0


_scaled_op.register_vmap(
    lambda info, in_dims, x, w, scale, out_dtype, tile, splits: _lanes(
        _scaled_op, info, in_dims, (x, w, scale), (out_dtype, tile, splits)))
_i32_op.register_vmap(
    lambda info, in_dims, x, w, tile, splits: _lanes(
        _i32_op, info, in_dims, (x, w), (tile, splits)))


int8_matmul.launches = 0
