"""Dense SwiGLU MLP and capacity-based top-k MoE (the port's counterpart of
``repro.models.mlp``).

The MoE keeps the JAX package's Mesh-TensorFlow/Switch formulation: tokens
are grouped, a (group, token, expert, capacity) dispatch tensor routes
tokens to per-expert slots, and the experts run as one batched product over
every expert, so a step reads every expert's weights whatever the routing.
Arctic's dense residual is a parallel SwiGLU added to the routed output.
Nothing here reads the host: the one-hots are comparisons with
``torch.arange`` and top-k is a stable sort, so the decode step that runs
it can be captured as a CUDA graph.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import matmul, shard
from repro_torch.models.common import ParamSpec


# ---------------------------------------------------------------------------
# Dense SwiGLU
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig, d_ff: int | None = None,
              prefix: str = "mlp_") -> dict:
    L, d = cfg.num_layers, cfg.d_model
    f = d_ff or cfg.d_ff
    dt = cfg.dtype
    return {
        prefix + "wi_gate": ParamSpec((L, d, f), dt,
                                     axes=("layers", "fsdp", "mlp")),
        prefix + "wi_up": ParamSpec((L, d, f), dt,
                                   axes=("layers", "fsdp", "mlp")),
        prefix + "wo": ParamSpec((L, f, d), dt,
                                axes=("layers", "mlp", "fsdp")),
    }


def swiglu(p: dict, x: torch.Tensor, prefix: str = "mlp_") -> torch.Tensor:
    """x (B,S,d) -> (B,S,d): ``silu(x Wg) * (x Wu)`` then ``Wo``; the SiLU in
    fp32, cast back to x's dtype before the product."""
    h = x @ p[prefix + "wi_gate"]
    u = x @ p[prefix + "wi_up"]
    h = shard(F.silu(h.float()).to(x.dtype) * u, "batch", "seq", "mlp")
    return matmul(h, p[prefix + "wo"])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def moe_specs(cfg: ModelConfig) -> dict:
    L, d, f, E = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.num_experts
    dt = cfg.dtype
    p = {
        "router": ParamSpec((L, d, E), "float32",
                            axes=("layers", None, "experts")),
        "we_gate": ParamSpec((L, E, d, f), dt,
                             axes=("layers", "experts", "fsdp", "mlp")),
        "we_up": ParamSpec((L, E, d, f), dt,
                           axes=("layers", "experts", "fsdp", "mlp")),
        "we_out": ParamSpec((L, E, f, d), dt,
                            axes=("layers", "experts", "mlp", "fsdp")),
    }
    if cfg.moe_dense_residual:
        p.update(mlp_specs(cfg, cfg.d_ff_dense, prefix="dense_"))
    return p


def _group(x: torch.Tensor, group_size: int) -> torch.Tensor:
    """(B,S,d) -> (B * S/g, g, d) with g = min(group_size, S). A sequence
    longer than a group must be a whole number of groups: the reference's
    reshape refuses it otherwise, and so does this one."""
    B, S, d = x.shape
    g = min(group_size, S)
    if S % g:
        raise TypeError(
            f"cannot reshape array of shape {tuple(x.shape)} (size "
            f"{x.numel()}) into shape {(B * (S // g), g, d)} (size "
            f"{B * (S // g) * g * d})")
    return x.reshape(B * (S // g), g, d)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of ``idx`` (integer or integral float) over ``n``
    classes by comparison with ``torch.arange``: an index outside [0, n)
    gives a row of zeros, as ``jax.nn.one_hot``'s, and nothing is read back
    to the host (``F.one_hot`` checks the range there)."""
    classes = torch.arange(n, dtype=idx.dtype, device=idx.device)
    return (idx[..., None] == classes).float()


def top_k(probs: torch.Tensor, k: int) -> tuple:
    """``jax.lax.top_k`` over the last axis: the k largest, in descending
    order, the lower index first on a tie (a stable sort; ``torch.topk``
    promises no order among ties on CUDA)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg: ModelConfig, router: torch.Tensor, xg: torch.Tensor) -> dict:
    """The router of one grouped input xg (G,T,d): its fp32 probabilities,
    each token's top-k experts and renormalised gates, each (token, choice)
    slot's position in its expert's buffer and whether it is kept.

    The reference multiplies bf16 x by a bf16 router with an fp32
    accumulator; both are upcast to fp32 here, where every product of two
    bf16 values is exact. ``pos`` is the fp32 cumsum over the (T*K) axis
    flattened token-major, choice-minor, the reference's order: which slot
    overflows the capacity depends on it."""
    G, T, _ = xg.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    cap = max(K, int(math.ceil(T * K * cfg.moe_capacity_factor / E)))
    logits = xg.float() @ router.to(xg.dtype).float()          # (G,T,E)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = top_k(probs, K)                               # (G,T,K)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    onehot_e = _one_hot(eidx, E)                               # (G,T,K,E)
    pos = torch.cumsum(onehot_e.reshape(G, T * K, E), dim=1) - 1.0
    pos = torch.sum(pos.reshape(G, T, K, E) * onehot_e, dim=-1)  # (G,T,K)
    keep = (pos < cap).float()
    return {"probs": probs, "gate": gate, "eidx": eidx, "onehot_e": onehot_e,
            "pos": pos, "keep": keep, "cap": cap}


def moe_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor,
            group_size: int = 1024) -> tuple:
    """Top-k capacity-dropped MoE. Returns (output (B,S,d), the Switch
    load-balance aux loss, an fp32 scalar)."""
    B, S, d = x.shape
    E = cfg.num_experts
    xg = shard(_group(x, group_size), "batch", None, None)     # (G,T,d)
    G, T, _ = xg.shape
    r = route(cfg, p["router"], xg)
    cap, onehot_e, gate = r["cap"], r["onehot_e"], r["gate"]

    # load-balance aux loss (Switch): E * sum_e fraction_e * mean_prob_e
    fraction = torch.mean(onehot_e, dim=(1, 2))                # (G,E)
    aux = E * torch.mean(torch.sum(fraction * torch.mean(r["probs"], dim=1),
                                   dim=-1))

    onehot_c = _one_hot(r["pos"], cap) * r["keep"][..., None]  # (G,T,K,C)
    # dispatch (G,T,E,C); combine carries the gate. Each (token, expert)
    # pair has one choice at most, so either sum over k has one term.
    dispatch = torch.einsum("gtke,gtkc->gtec", onehot_e, onehot_c)
    combine = torch.einsum("gtke,gtkc,gtk->gtec", onehot_e, onehot_c, gate)
    dispatch = shard(dispatch.to(x.dtype), "batch", None, "experts",
                     None).reshape(G, T, E * cap)
    combine = shard(combine.to(x.dtype), "batch", None, "experts",
                    None).reshape(G, T, E * cap)

    xe = dispatch.transpose(1, 2) @ xg                         # (G,E*C,d)
    xe = shard(xe.reshape(G, E, cap, d), "batch", "experts", None, None)
    xe = xe.transpose(0, 1).reshape(E, G * cap, d)
    h = xe @ p["we_gate"]                                      # (E,G*C,f)
    u = xe @ p["we_up"]
    h = F.silu(h.float()).to(x.dtype) * u
    ye = h @ p["we_out"]                                       # (E,G*C,d)
    ye = shard(ye.reshape(E, G, cap, d).transpose(0, 1), "batch", "experts",
               None, None).reshape(G, E * cap, d)
    y = (combine @ ye).reshape(B, S, d)
    if cfg.moe_dense_residual:
        y = y + swiglu(p, x, prefix="dense_")
    return y, aux
