"""Plain PyTorch version of the RWKV-6 WKV recurrence (port of ``wkv6_ref``
and the registry's (B, T, H, K) adapter).

The CPU path of the wrapper, the ``impl="ref"`` route of the registry and
the card-side check of the CUDA kernel all use it.
"""
from __future__ import annotations

import torch


def wkv6_ref(r, k, v, lw, u):
    """r/k/v/lw: (BH, T, K); u: (BH, K). Returns y (BH, T, K) in r's dtype.

    From S = 0, per token, in fp32:
    ``y_t = r_t . (S + (u * k_t) v_t^T)``, ``S = diag(exp(lw_t)) S + k_t v_t^T``.
    """
    bh, t, kk = r.shape
    rf, kf, vf = r.float(), k.float(), v.float()
    w = torch.exp(lw.float())
    uf = u.float()[:, :, None]
    s = torch.zeros((bh, kk, kk), dtype=torch.float32, device=r.device)
    ys = []
    for i in range(t):
        kv = kf[:, i, :, None] * vf[:, i, None, :]              # (BH, K, K)
        ys.append(torch.einsum("bi,bio->bo", rf[:, i], s + uf * kv))
        s = w[:, i, :, None] * s + kv
    return torch.stack(ys, dim=1).to(r.dtype)


def wkv6_ref_bthk(r, k, v, lw, u):
    """r/k/v/lw: (B, T, H, K); u: (H, K). Returns y (B, T, H, K)."""
    b, t, h, kk = r.shape

    def fold(a):
        return a.transpose(1, 2).reshape(b * h, t, kk)

    uf = u[None].expand(b, h, kk).reshape(b * h, kk)
    y = wkv6_ref(fold(r), fold(k), fold(v), fold(lw), uf)
    return y.reshape(b, h, t, kk).transpose(1, 2).contiguous()
