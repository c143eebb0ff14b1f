"""Plain PyTorch version of flash attention (port of ``attention_ref``).

The CPU path of the wrapper and the card-side check of the CUDA kernel both
use it. Causal masking is top-left aligned (``kpos <= qpos``), as in the
JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  group: int = 1, causal: bool = True,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: (BHG, S, D); k/v: (BH, Sk, D). fp32 math, output in q's dtype."""
    bhg, s, d = q.shape
    bh, sk, _ = k.shape
    scale = scale if scale is not None else 1.0 / d ** 0.5
    qg = q.reshape(bh, group, s, d).float()
    kf = k.float()
    vf = v.float()
    scores = torch.einsum("bgqd,bkd->bgqk", qg, kf) * scale
    if causal:
        mask = torch.ones((s, sk), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bgqk,bkd->bgqd", p, vf)
    return o.reshape(bhg, s, d).to(q.dtype)


def attention_ref_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True) -> torch.Tensor:
    """Public layout: q (B,S,H,D), k/v (B,Sk,Hkv,D) -> (B,S,H,D)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qk = q.transpose(1, 2).reshape(b * h, s, d)
    kk = k.transpose(1, 2).reshape(b * hkv, k.shape[1], d)
    vk = v.transpose(1, 2).reshape(b * hkv, v.shape[1], d)
    o = attention_ref(qk, kk, vk, group=h // hkv, causal=causal)
    return o.reshape(b, h, s, d).transpose(1, 2)
