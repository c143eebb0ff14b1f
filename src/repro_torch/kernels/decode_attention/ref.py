"""Plain PyTorch version of one-token decode attention: the arithmetic the
port's decode took on stock ops, and the CPU path of the wrapper.

Scores in fp32 from ``q.float()`` and ``k.float()`` over every cache row,
divided by the 0-d fp32 sqrt(D), masked to the valid rows with -1e30,
softmax in fp32, cast to q's dtype before the product with V. A paged
cache's blocks are first gathered into each lane's rows, and its scores
run over every lane of the tables (q padded with zero lanes) and are cut
back to the live ones. ``grouped_scores``, ``decode_weights`` and
``grouped_values`` are the steps; ``models/attention.py`` runs the same
ones on a sharded cache.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def valid_rows(pos: torch.Tensor, rows: int) -> torch.Tensor:
    """Each lane's count of valid rows: min(pos + 1, rows) (a sliding
    window's ring holds every row once pos >= rows)."""
    return torch.clamp(pos.long() + 1, max=rows)


def grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B,Sq,Hkv,G,D), k (B,Skv,Hkv,D) -> fp32 q.k (B,Hkv,G,Sq,Skv)."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())


def decode_weights(scores: torch.Tensor, valid: torch.Tensor,
                   scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The fp32 scores divided by ``scale``, masked to ``valid`` with
    NEG_INF, softmax in fp32, cast to ``dtype``."""
    s_ = torch.where(valid, scores / scale, NEG_INF)
    return torch.softmax(s_, dim=-1).to(dtype)


def grouped_values(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """a (B,Hkv,G,Sq,Skv), v (B,Skv,Hkv,D) -> (B,Sq,Hkv,G,D)."""
    return torch.einsum("bhgqk,bkhd->bqhgd", a, v)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: torch.Tensor,
                         tables: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """q (B,1,H,D); k/v dense (B,S,Hkv,D), or a block pool (N,bs,Hkv,D)
    with tables (lanes, W); pos (B,). Returns (B,1,H,D) in q's dtype."""
    B, _, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, 1, Hkv, H // Hkv, D)
    if tables is None:
        kr, vr = k, v
    else:
        blocks = tables.long()
        lanes, W = blocks.shape
        rows = W * k.shape[1]
        kr = k[blocks].reshape(lanes, rows, Hkv, D)
        vr = v[blocks[:B]].reshape(B, rows, Hkv, D)
        qg = torch.cat([qg, qg.new_zeros((lanes - B,) + tuple(qg.shape[1:]))])
    S = kr.shape[1]
    scores = grouped_scores(qg, kr)[:B]
    valid = torch.arange(S, device=q.device)[None, :] < valid_rows(pos, S)[
        :, None]
    scale = torch.full((), float(D ** 0.5), dtype=torch.float32,
                       device=q.device)
    a = decode_weights(scores, valid[:, None, None, None, :], scale, q.dtype)
    return grouped_values(a, vr).reshape(B, 1, H, D)
