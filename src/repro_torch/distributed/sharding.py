"""Logical-axis sharding: the distributed half of the paper's RBL, onto
DTensor (the port's counterpart of ``repro.distributed.sharding``).

In AEG, the Runtime Binding Layer resolves *symbolic* buffer IDs into
*physical* addresses. Across ranks the physical address space of a tensor
is its shard layout, so binding == resolving logical axis names ("batch",
"heads", "mlp", ...) into a mesh ``PartitionSpec``, and from it the
DTensor placements of each mesh dim.

The resolver is the reference's, character for character in logic: a
logical axis maps to an *ordered list of candidate mesh-axis groups*; the
first candidate whose mesh axes are (a) not already used by an earlier dim
of the same tensor and (b) evenly divide the dim size wins, otherwise the
dim is replicated. It takes any mesh that exposes ``{axis name: size}``: a
``DeviceMesh`` (its ``mesh_dim_names`` and ``shape``) or an
``AbstractMesh(sizes, names)``, which needs no process group.

``to_placements`` turns a ``PartitionSpec`` into one ``Shard``/
``Replicate`` per mesh dim: a group such as ("pod", "data") puts one tensor
dim on several mesh dims, which DTensor splits in mesh-dim order (major to
minor), as the reference's group does. Outside an ``axis_rules`` context
``shard`` returns its input object, so every single-device path stays bit
for bit what it was; inside one it redistributes (a plain tensor is first
taken as replicated). The context also enters DTensor's
``implicit_replication``, so plain constants (RoPE tables, masks) mix with
DTensors.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Union

# A candidate is a mesh axis name or tuple of mesh axis names.
Candidate = Union[str, tuple]
# Rules: logical axis name -> ordered candidates.
Rules = dict[str, tuple]


def _norm(c: Candidate) -> tuple:
    return (c,) if isinstance(c, str) else tuple(c)


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of mesh axis names; trailing Nones are trimmed by the resolver,
    as ``jax.sharding.PartitionSpec`` entries are compared."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


class AbstractMesh:
    """Axis names and sizes without devices or a process group (the
    resolver's and the tests' mesh; ``jax.sharding.AbstractMesh``)."""

    def __init__(self, sizes: Sequence[int], names: Sequence[str]):
        if len(sizes) != len(names):
            raise ValueError(f"mesh sizes {tuple(sizes)} and names "
                             f"{tuple(names)} differ in length")
        self.axis_sizes = tuple(int(s) for s in sizes)
        self.axis_names = tuple(names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or an ``AbstractMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


# ---------------------------------------------------------------------------
# Rule sets (mode-keyed). Mesh axes: ("pod",) "data", "model".
# ---------------------------------------------------------------------------

def _rules(**kw) -> Rules:
    return {k: tuple(v) for k, v in kw.items()}


RULE_SETS: dict[str, Rules] = {
    # Training: DP over (pod, data); TP over model on mlp/experts/vocab and,
    # where divisible, heads; sequence falls back onto model for attention
    # tensors whose head count does not divide the model axis. Params carry
    # an "fsdp" logical axis on their largest dim -> ZeRO-3 style sharding.
    "train": _rules(
        batch=(("pod", "data"), "data"),
        seq=("model",),
        embed=(),
        fsdp=(("pod", "data"), "data"),
        opt_shard=(("pod", "data"), "data"),
        heads=("model",),
        kv_heads=("model",),
        head_dim=(),
        mlp=("model",),
        experts=("model",),
        vocab=("model",),
        state=(),
        layers=(),
    ),
    # ZeRO-1 train variant: params replicated over data (they must fit
    # per-device after TP/EP), moments stay data-sharded. Removes the
    # 2x-params fwd/bwd all-gather; gradients still reduce once.
    "train_zero1": _rules(
        batch=(("pod", "data"), "data"),
        seq=("model",),
        embed=(),
        fsdp=(),
        opt_shard=(("pod", "data"), "data"),
        heads=("model",),
        kv_heads=("model",),
        head_dim=(),
        mlp=("model",),
        experts=("model",),
        vocab=("model",),
        state=(),
        layers=(),
    ),
    # Prefill: same as train but no fsdp gathering pressure (params already
    # bound); keep activations batch+TP sharded.
    "prefill": _rules(
        batch=(("pod", "data"), "data"),
        seq=("model",),
        embed=(),
        fsdp=(("pod", "data"), "data"),
        heads=("model",),
        kv_heads=("model",),
        head_dim=(),
        mlp=("model",),
        experts=("model",),
        vocab=("model",),
        state=(),
        layers=(),
    ),
    # Decode: batch over (pod,data); KV-cache sequence over model
    # (flash-decode style SP); at batch=1 (long_500k) batch replicates and
    # seq grabs (data, model). Weights additionally shard their fsdp/embed
    # dims over "data" (inference weight sharding): per-step weight reads
    # drop 16x while the gathered activations are a single token.
    "decode": _rules(
        batch=(("pod", "data"), "data"),
        seq=(("data", "model"), "model", "data"),
        embed=("data",),
        fsdp=("data",),
        heads=("model",),
        kv_heads=("model",),
        head_dim=(),
        mlp=("model",),
        experts=("model",),
        vocab=("model",),
        state=("model",),
        layers=(),
    ),
}


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------

class _Ctx(threading.local):
    """The active binding, one a thread as the reference's: a thread that
    serves plain tensors is not touched by another thread's binding. A
    rematerialized block takes its binding with it (``carry_binding``)."""
    mesh = None
    rules: Optional[Rules] = None


_CTX = _Ctx()


_KERNEL_RULES: list = []


def register_kernel_rules() -> None:
    """Register the hand kernels' DTensor sharding rules (once a process):
    importing DTensor costs more than a second, so nothing does it before
    a binding or a DTensor is made."""
    if _KERNEL_RULES:
        return
    import torch
    from torch.distributed.tensor.experimental import register_sharding

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssm_scan import ops as ssm
    from repro_torch.kernels.wkv6 import ops as wkv
    for op, rule in ((torch.ops.aeg.flash_attention.default,
                      fa.dtensor_rule),
                     (torch.ops.aeg.ssm_scan.default, ssm.dtensor_rule),
                     (torch.ops.aeg.wkv6.default, wkv.dtensor_rule)):
        register_sharding(op)(rule)
        _KERNEL_RULES.append(op)


@contextlib.contextmanager
def axis_rules(mesh, rules: Union[str, Rules, None]):
    """Activate a (mesh, rules) binding context (no-op if mesh is None).
    With a mesh it also enters ``implicit_replication``: a plain tensor
    that meets a DTensor in an op is taken as replicated."""
    if isinstance(rules, str):
        rules = RULE_SETS[rules]
    if mesh is not None:
        register_kernel_rules()
    with _bound(mesh, rules):
        if mesh is None:
            yield
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield


@contextlib.contextmanager
def _bound(mesh, rules):
    """This thread's binding set to (mesh, rules), and nothing else."""
    old = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = old


def carry_binding(fn):
    """``fn`` run under the binding active where this is called, on
    whatever thread runs it: autograd recomputes a rematerialized block on
    its own worker thread, which must place the block's activations as the
    forward did. ``implicit_replication`` is process-wide and stays on
    while the caller is inside ``axis_rules``, so the backward is run
    there."""
    mesh, rules = current_context()
    if mesh is None:
        return fn

    def run(*args, **kwargs):
        with _bound(mesh, rules):
            return fn(*args, **kwargs)
    return run


def current_context():
    return _CTX.mesh, _CTX.rules


# ---------------------------------------------------------------------------
# Resolver
# ---------------------------------------------------------------------------

def logical_to_pspec(shape: Sequence[int],
                     axes: Sequence[Optional[str]],
                     rules: Rules,
                     mesh) -> PartitionSpec:
    """Shape-aware logical->physical resolution (see module docstring)."""
    assert len(shape) == len(axes), (shape, axes)
    used: set[str] = set()
    out: list = []
    sizes = mesh_sizes(mesh)
    for dim, name in zip(shape, axes):
        entry = None
        if name is not None:
            for cand in rules.get(name, ()):
                cand = _norm(cand)
                if any(a not in sizes for a in cand):   # axis absent from mesh
                    continue
                if any(a in used for a in cand):
                    continue
                total = 1
                for a in cand:
                    total *= sizes[a]
                if dim % total != 0 or total == 1:
                    continue
                entry = cand if len(cand) > 1 else cand[0]
                used.update(cand)
                break
        out.append(entry)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def to_placements(pspec: Sequence, mesh) -> tuple:
    """DTensor placements (one per mesh dim) of ``pspec`` on ``mesh``: a
    mesh dim named by the spec's entry for tensor dim i is ``Shard(i)``,
    every other mesh dim ``Replicate()``. A group's axes must follow the
    mesh's own order (DTensor splits a dim over several mesh dims major to
    minor in mesh-dim order)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_sizes(mesh))
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(pspec):
        if entry is None:
            continue
        group = _norm(entry)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"mesh axes {group} of tensor dim {dim} are "
                             f"not in the mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def sharding_for(shape, axes, mesh=None, rules=None):
    """``(mesh, placements)`` of a tensor of ``shape`` with logical
    ``axes`` under the active (or given) binding, None outside one."""
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    if mesh is None or rules is None:
        return None
    if isinstance(rules, str):
        rules = RULE_SETS[rules]
    pspec = logical_to_pspec(tuple(shape), tuple(axes), rules, mesh)
    return mesh, to_placements(pspec, mesh)


def mesh_axis_size(name: str) -> int:
    """Size of a mesh axis in the active binding context (1 if absent)."""
    if _CTX.mesh is None:
        return 1
    return mesh_sizes(_CTX.mesh).get(name, 1)


def is_dtensor(x) -> bool:
    """``x`` is a DTensor (checked by name: nothing imports DTensor for
    a plain tensor)."""
    return type(x).__name__ == "DTensor"


def as_dtensor(x, mesh):
    """``x`` as a DTensor on ``mesh``: a DTensor as it is, a plain tensor
    as every rank's identical copy (``Replicate`` on every mesh dim)."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    register_kernel_rules()
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def shard(x, *axes: Optional[str]):
    """Place an activation by logical axis names: outside an
    ``axis_rules`` context it returns ``x`` itself; inside one it
    redistributes ``x`` to the resolved placements (``redistribute``)."""
    return place(x, sharding_for(x.shape, axes))


def place(t, sharding):
    """``t`` as a DTensor placed by ``sharding`` = ``(mesh, placements)``
    (``redistribute``; a plain tensor is first every rank's identical
    copy, so placing it runs no collective). A ``None`` sharding returns
    ``t``."""
    if sharding is None:
        return t
    mesh, placements = sharding
    t = as_dtensor(t, mesh)
    if tuple(t.placements) == tuple(placements):
        return t
    return redistribute(t, mesh, placements)


def shard_reshape(x, shape, *axes: Optional[str]):
    """``x.reshape(shape)`` placed by the logical ``axes`` of ``shape``.
    Inside a binding ``x`` is first redistributed to the placements
    resolved for ``shape``, whose sharded dims must mean the same in both
    shapes (dims before the one the reshape splits, or that dim's leading
    factor): DTensor may have split a dim anywhere, and a reshape that
    splits it needs whole blocks on each rank."""
    return reshape(place(x, sharding_for(shape, axes)), shape)


def sharded_dims(x) -> set:
    """The tensor dims a DTensor is split along (empty for a plain
    tensor)."""
    if not is_dtensor(x):
        return set()
    return {p.dim for p in x.placements if p.is_shard()}


def low_rank_operands(a, w):
    """The operands of a low-rank up-projection ``a @ w`` (a's last dim a
    rank of 64 or less, w's last dim split along "fsdp"), as they are,
    but where DTensor splits w's last dim over two mesh dims (the 512-rank
    mesh's ("pod", "data")): then both made whole along their last dims
    (both small), since with a's rank split over "model" the product's
    backward asks for strided splits that DTensor cannot redistribute
    into. Plain tensors as they are."""
    if not is_dtensor(w) or sum(p.is_shard() and p.dim == w.ndim - 1
                                for p in w.placements) < 2:
        return a, w
    return replicate_dims(a, (a.ndim - 1,)), replicate_dims(w, (w.ndim - 1,))


def replicate_dims(x, dims):
    """A DTensor made whole along ``dims`` (each mesh dim that split one
    of them replicates); a plain tensor as it is."""
    if not sharded_dims(x) & set(dims):
        return x
    from torch.distributed.tensor import Replicate
    placements = tuple(Replicate() if p.is_shard() and p.dim in dims else p
                       for p in x.placements)
    return redistribute(x, x.device_mesh, placements)


def grad_placed_as(x):
    """``x`` itself, whose gradient, on a DTensor, comes back placed as
    ``x`` is (a plain tensor as it is). torch 2.11's DTensor (the card's)
    cannot fold a split dim that is not a product's first batch dim: an
    output computed whole along some dim may get back a gradient split
    along it, which its product's backward would have to fold."""
    if not is_dtensor(x):
        return x
    return redistribute(x, x.device_mesh, x.placements)


def cumsum(x, dim: int):
    """``torch.cumsum(x, dim)``; on a DTensor its gradient, the reverse
    cumsum of g, is taken as ``sum(g) - cumsum(g) + g``: autograd's own
    backward flips g, and torch 2.11's DTensor (the card's) has no rule
    for ``aten.flip``."""
    if not is_dtensor(x):
        import torch
        return torch.cumsum(x, dim)
    return _autograd().Cumsum.apply(x, dim)


def split_once(x):
    """A DTensor with each dim split over one mesh dim at most (the first
    that splits it; the others replicate); a plain tensor as it is.
    torch 2.11's DTensor (the card's) cannot index with an index split
    over several mesh dims, as ("pod", "data") splits a batch."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    seen, placements = set(), []
    for p in x.placements:
        if p.is_shard() and p.dim in seen:
            placements.append(Replicate())
            continue
        if p.is_shard():
            seen.add(p.dim)
        placements.append(p)
    return place(x, (x.device_mesh, tuple(placements)))


def matmul(x, w):
    """``x @ w`` for x (B, S, K) and a 2-D w. A DTensor x split along
    both B and S goes as a product batched over B: torch 2.11's DTensor
    (the card's) cannot fold two split dims into one product's rows."""
    if x.ndim == 3 and {0, 1} <= sharded_dims(x):
        import torch
        return torch.bmm(x, w.unsqueeze(0).expand(x.shape[0], *w.shape))
    return x @ w


def redistribute(x, mesh, placements):
    """``x.redistribute(mesh, placements)`` whose gradient goes back as
    ``x``'s placements with each ``Partial`` read as ``Replicate``: the
    gradient of a sum of partial values is the whole gradient on every
    rank (Megatron's all-reduce, identity backward). DTensor would hand
    it back as partial sums, and every product upstream would then run
    whole on each rank."""
    return _autograd().Redistribute.apply(x, mesh, tuple(placements))


def reshape(x, shape):
    """``x.reshape(shape)``; on a DTensor its gradient is first placed as
    the forward's output was, so the backward's reshape is the valid
    inverse of the forward's (a gradient may come back in any placement,
    and DTensor cannot split a dim whose shards cut its blocks)."""
    if not is_dtensor(x):
        return x.reshape(shape)
    return _autograd().Reshape.apply(x, tuple(shape))


_FNS: list = []


def _autograd():
    """The autograd functions of ``redistribute`` and ``reshape``, made on
    first use (nothing imports DTensor before a binding)."""
    if _FNS:
        return _FNS[0]
    import types

    import torch
    from torch.distributed.tensor import Replicate

    class Redistribute(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, mesh, placements):
            ctx.mesh = mesh
            ctx.back = tuple(Replicate() if p.is_partial() else p
                             for p in x.placements)
            return x.redistribute(mesh, placements)

        @staticmethod
        def backward(ctx, g):
            return g.redistribute(ctx.mesh, ctx.back), None, None

    class Reshape(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, shape):
            y = x.reshape(shape)
            ctx.in_shape, ctx.placements = tuple(x.shape), y.placements
            return y

        @staticmethod
        def backward(ctx, g):
            g = g.redistribute(g.device_mesh, ctx.placements)
            return g.reshape(ctx.in_shape), None

    class Cumsum(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dim):
            ctx.dim = dim
            return torch.cumsum(x, dim)

        @staticmethod
        def backward(ctx, g):
            return (g.sum(ctx.dim, keepdim=True) - torch.cumsum(g, ctx.dim)
                    + g), None

    _FNS.append(types.SimpleNamespace(Redistribute=Redistribute,
                                      Reshape=Reshape, Cumsum=Cumsum))
    return _FNS[0]
