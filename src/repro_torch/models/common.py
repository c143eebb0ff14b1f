"""Parameter specs, norms and RoPE shared by the model modules and the RCB
op library (the port's counterpart of ``repro.models.common``):
``ParamSpec`` with its logical sharding axes, the spec-tree helpers
(``is_spec``, ``spec_tree_map``, ``shape_structs``, ``param_shardings``,
``param_bytes``, ``param_count``), ``draw_param``, ``rms_norm``,
``group_norm``, ``rope_freqs`` and ``apply_rope``, plus ``rope_table``,
RoPE's cos and sin built once a forward pass, and the training loss
``softmax_cross_entropy``.

A spec tree is a dict of specs (or of such trees), or a named tuple of
them (``AdamWState``); ``shape_structs`` makes ``meta`` tensors of it,
which allocate nothing (the counterpart of ``jax.ShapeDtypeStruct``), and
inside an ``axis_rules`` binding DTensors of them, placed by the
resolver."""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.distributed.sharding import is_dtensor, place, sharding_for
from repro_torch.dtypes import torch_dtype


class ParamSpec(NamedTuple):
    shape: tuple
    dtype: str
    init: str = "normal"      # normal | zeros | ones | embed | decay | uniform
    scale: float = 1.0
    axes: tuple = ()          # logical axis names (len == ndim); None ok


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def spec_tree_map(fn, specs):
    """``fn`` applied to every spec of a tree of dicts, lists and (named)
    tuples; the tree's structure is kept."""
    if is_spec(specs):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: spec_tree_map(fn, v) for k, v in specs.items()}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(spec_tree_map(fn, v) for v in specs))
    if isinstance(specs, (list, tuple)):
        return type(specs)(spec_tree_map(fn, v) for v in specs)
    raise TypeError(f"not a spec tree: {type(specs).__name__}")


def spec_leaves(specs) -> list:
    """The specs of a tree, dict keys in sorted order (``jax.tree.leaves``'
    order)."""
    if is_spec(specs):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    return [s for v in specs for s in spec_leaves(v)]


def shape_structs(specs, sharded: bool = True):
    """A tree of ``meta`` tensors of the specs' shapes and dtypes (nothing
    is allocated); with ``sharded`` and inside an ``axis_rules`` binding,
    DTensors placed by ``sharding_for``, each rank's local shard a
    ``meta`` tensor too."""
    def mk(s: ParamSpec):
        t = torch.empty(s.shape, dtype=torch_dtype(s.dtype), device="meta")
        sh = sharding_for(s.shape, s.axes) if sharded else None
        return t if sh is None else place(t, sh)
    return spec_tree_map(mk, specs)


def param_shardings(specs):
    """Each spec's ``(mesh, placements)`` under the active binding (None
    outside one)."""
    return spec_tree_map(lambda s: sharding_for(s.shape, s.axes), specs)


def place_params(params: dict, shardings: dict) -> dict:
    """``place`` of each tensor of ``params`` by ``param_shardings``'
    entry of the same name."""
    return {k: place(v, shardings[k]) for k, v in params.items()}


def param_bytes(specs) -> int:
    return sum(math.prod(s.shape) * torch_dtype(s.dtype).itemsize
               for s in spec_leaves(specs))


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for s in spec_leaves(specs))


# The training route's ``impl``: attention as grouped scores and a softmax,
# the scans as ``ssm_chunked`` and ``wkv_chunked``, all stock ops under
# autograd (the JAX package's default route, which trains). The hand
# kernels have no backward, and the kernels' plain versions (``"ref"``)
# are step-by-step loops.
AUTOGRAD = "autograd"

SLICE_DRAW_BYTES = 4 << 30   # a larger fp32 draw goes slice by slice


def draw_param(s: ParamSpec, gen: torch.Generator,
               dev: torch.device) -> torch.Tensor:
    """One parameter from ``gen`` on ``dev``, following the JAX package's
    init kinds: ones, zeros, uniform (U(-1, 1) * scale), decay (-6 + 5
    U(0, 1), the rwkv decay base), embed (normal, std d^-1/2) and normal
    (normal truncated at +-3, std scale / sqrt(fan_in)). The values differ
    from the JAX package's (another generator); parity tests carry weights
    across instead.

    Each kind draws in fp32 and casts. Where that fp32 draw would pass
    ``SLICE_DRAW_BYTES`` (the experts of moonshot-v1-16b-a3b: 35.4 GB a
    spec), the spec is drawn slice by slice along its leading (layers)
    axis into a tensor of its own dtype, so the fp32 copy never exceeds
    one slice; a slice that still passes it (one layer of arctic-480b's
    experts: 17.8 GB) is drawn along its next axis the same way. Every
    smaller spec is drawn whole, as before."""
    dt = torch_dtype(s.dtype)
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dt, device=dev)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dt, device=dev)
    if len(s.shape) < 2 or math.prod(s.shape) * 4 <= SLICE_DRAW_BYTES:
        return _draw(s, s.shape, gen, dev).to(dt)
    out = torch.empty(s.shape, dtype=dt, device=dev)
    for idx in _slices(s.shape):
        out[idx] = _draw(s, s.shape[len(idx):], gen, dev)
    return out


def _slices(shape: tuple):
    """The leading indices that cut ``shape`` into slices whose fp32 bytes
    are within ``SLICE_DRAW_BYTES``, in order: (i,) along the first axis,
    or (i, j, ...) where a slice along it is still larger."""
    if math.prod(shape[1:]) * 4 <= SLICE_DRAW_BYTES or len(shape) < 3:
        return [(i,) for i in range(shape[0])]
    return [(i, *rest) for i in range(shape[0]) for rest in _slices(shape[1:])]


def _draw(s: ParamSpec, shape: tuple, gen: torch.Generator,
          dev: torch.device) -> torch.Tensor:
    """An fp32 draw of ``shape`` (the spec's, or one slice of it) of the
    spec's init kind; fan-in and scale come from the whole spec."""
    if s.init == "uniform":
        v = torch.rand(shape, generator=gen, device=dev) * 2.0 - 1.0
        return v * s.scale
    if s.init == "decay":
        v = torch.rand(shape, generator=gen, device=dev)
        return -6.0 + 5.0 * v
    if s.init == "embed":
        v = torch.randn(shape, generator=gen, device=dev)
        return v * s.shape[-1] ** -0.5
    fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
    v = torch.empty(shape, device=dev)
    torch.nn.init.trunc_normal_(v, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return v * (s.scale / math.sqrt(max(1, fan_in)))


def group_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the trailing dim (rwkv6 ln_x), fp32 math, cast back to
    x's dtype. The variance is the population one, as ``jnp.var``'s."""
    dt = x.dtype
    *lead, d = x.shape
    x = x.float().reshape(*lead, groups, d // groups)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    x = (x - mu) * torch.rsqrt(var + eps)
    x = x.reshape(*lead, d)
    return (x * w.float() + b.float()).to(dt)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    """fp32 math, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * w.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_table(positions: torch.Tensor, head_dim: int, theta: float):
    """RoPE's (cos, sin) of ``positions`` (..., seq), each (..., seq, 1,
    head_dim/2) fp32: computed once a forward pass and shared by every
    layer's q and k."""
    freqs = rope_freqs(head_dim, theta, positions.device)   # (d/2,)
    ang = positions.float()[..., None] * freqs              # (..., seq, d/2)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               table=None):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int. fp32
    math, rotation by half-split. ``table`` is ``rope_table(positions,
    head_dim, theta)`` when the caller already has it: the same bits."""
    dt = x.dtype
    cos, sin = table if table is not None else \
        rope_table(positions, x.shape[-1], theta)
    x = x.float()
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None):
    """Mean token NLL of ``labels`` (B,S) under ``logits`` (B,S,V), in
    fp32 with a max-shifted log-sum-exp; with ``mask`` (B,S), the sum of
    the masked NLL over max(sum(mask), 1). The label's logit is a
    ``gather`` of one entry a row: its backward writes each row once, so
    it adds nothing in an order the device picks."""
    logits = logits.float()
    m = torch.amax(logits, dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.sum(torch.exp(logits - m), dim=-1))
    if is_dtensor(logits):
        # Vocab-sharded logits: DTensor's gather along the sharded dim
        # fails to reduce its masked partial, so the label's logit is a
        # masked sum, each rank over its own columns (one nonzero term:
        # the same value).
        hit = torch.arange(logits.shape[-1], device=logits.device) \
            == labels.long()[..., None]
        ll = torch.sum(torch.where(hit, logits, 0.0), dim=-1)
    else:
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        mask = mask.float()
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
