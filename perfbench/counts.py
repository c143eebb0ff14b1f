"""The yardstick's arithmetic: the card's peaks, the least time of a kernel
call from its shapes, and the model FLOPs a served answer needs.

The bounds are frozen copies of ``chip_smoke.py``'s (``attention_bound``,
``wkv6_bound``, ``decode_bytes_bound`` and its peak table), so that the
benchmark keeps its own yardstick whatever later changes make of that
script. They depend on shapes only, never on the kernel that runs.

The model counts (each reference module's ``prefill_flops`` and
``decode_flops``) take only the work the answer needs: the logits of the
last prompt position (the prefill's answer) and of each decoded token,
causal attention over the valid rows (query i of a prompt attends i + 1
keys; a decoded token at position p attends p + 1), and the live lanes of
a decode step. Multiply-adds count 2 FLOPs.
"""
from __future__ import annotations

from perfbench import reference

# NVIDIA H100 SXM data sheet, dense: chip_smoke.py's HBM_BYTES_PER_S and
# PEAK_OPS_PER_S (through repro_torch.launch.roofline's H100_* constants).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12,        # tensor cores
                  "float16": 989e12,
                  "float32": 67e12,          # no TF32: CUDA cores
                  "int8": 1979e12}           # tensor cores
PEAK_BF16 = PEAK_OPS_PER_S["bfloat16"]


def attention_bound(b, s, sk, h, hkv, d, dtype: str, causal: bool):
    """Least time (ms) for one attention call: q, k, v read once and o
    written once over the memory rate, against the multiply-adds its
    unmasked (q, k) pairs need over the peak rate of the dtype.
    (Frozen copy of chip_smoke.py's ``attention_bound``; the sum over
    rows is in closed form, equal to the script's loop.)"""
    esize = 4 if dtype == "float32" else 2
    nbytes = (2 * b * s * h * d + 2 * b * sk * hkv * d) * esize
    pairs = causal_pairs(s, sk) if causal else s * sk
    ops = 4 * d * pairs * h * b
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def causal_pairs(s: int, sk: int) -> int:
    """sum(min(i + 1, sk) for i in range(s)): the (q, k) pairs of a
    top-left aligned causal call."""
    full = min(s, sk)
    return full * (full + 1) // 2 + (s - full) * sk


def wkv6_bound(b, t, h, kk, dtype: str):
    """Least time (ms) for one WKV6 call: r, k, v, lw read once, u (fp32)
    read once and y written once over the memory rate, against the kernel's
    operations (k*v and two multiply-adds per (b, t, h, i, o); the exp and
    the bonus term, about 4, per (b, t, h, i)) over the peak rate of the
    dtype. (Frozen copy of chip_smoke.py's ``wkv6_bound``.)"""
    esize = 4 if dtype == "float32" else 2
    nbytes = 5 * b * t * h * kk * esize + h * kk * 4
    ops = 5 * b * t * h * kk * kk + 4 * b * t * h * kk
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes, ops


def decode_bytes_bound(cfg, params: dict, cache: dict, pos) -> dict:
    """The least bytes one decode step at ``pos`` (B,) must move, and the
    time they take at HBM_BYTES_PER_S: every weight once (the dense MoE
    reads every expert), the embedding's B rows instead of its table (a
    vlm or audio config's B input embeddings), each lane's K and V rows up
    to its position, and the new rows written. (Frozen copy of
    chip_smoke.py's ``decode_bytes_bound``.)"""
    weights = sum(v.numel() * v.element_size() for k, v in params.items()
                  if k != "embed")
    rows = cfg.d_model * params["final_norm"].element_size() * len(pos)
    k = cache["k"]
    row_bytes = k.shape[0] * k.shape[3] * k.shape[4] * k.element_size()
    kv = 2 * row_bytes * (sum(int(p) for p in pos) + len(pos))
    total = weights + rows + kv
    return {"bytes": total, "weights_bytes": weights, "kv_bytes": kv,
            "bound_ms": total / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


# ---------------------------------------------------------------------------
# Model FLOPs an answer needs (the ``mfu`` numerator), counted by the
# reference module that the configuration file's ``reference`` names, so
# that a new family brings its counts as a file of its own
# ---------------------------------------------------------------------------

def prefill_flops(config: dict, s: int) -> int:
    """FLOPs a prompt of s tokens needs: every layer over every token, the
    mixing over the valid positions only (causal attention's (q, k) pairs,
    or the WKV recurrence), and the logits of the last position only."""
    return reference.module(config).prefill_flops(config, s)


def decode_flops(config: dict, positions) -> int:
    """FLOPs one decode step needs over its live lanes, lane b writing
    position positions[b] (and, with attention, attending positions[b] + 1
    rows)."""
    return reference.module(config).decode_flops(config, positions)
