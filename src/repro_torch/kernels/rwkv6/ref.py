"""Plain PyTorch version of the RWKV-6 WKV recurrence (per head):

    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
    o_t = (S_{t-1} + diag(u) k_t v_tᵀ)ᵀ r_t

The port of ``repro.kernels.rwkv6.ref``, step by step.  The model's plain
path uses it for prefill of any length and for the one-token decode step
alike (the reference's chunked ``lax.scan`` and its inline decode update
compute this same loop).
"""
from __future__ import annotations

import torch


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor | None = None):
    """r, k, v, w: (B, T, H, hd); u: (H, hd); s0: (B, H, hd, hd).
    Returns (o (B, T, H, hd) f32, sT (B, H, hd, hd) f32)."""
    b, t, h, hd = r.shape
    s = s0.float() if s0 is not None else \
        torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    uf = u.float()[None, :, :, None]
    outs = []
    for i in range(t):
        rt, kt, vt, wt = (x[:, i].float() for x in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]
        s_eff = s + uf * kv
        outs.append(torch.einsum("bhij,bhi->bhj", s_eff, rt))
        s = wt[..., :, None] * s + kv
    return torch.stack(outs, dim=1), s
