"""Plain PyTorch version of the flash attention kernel (GQA, causal,
windowed): the port of ``repro.kernels.flash_attention.ref``, step by step."""
from __future__ import annotations

import torch

NEG_INF = -2.0e38


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = True, window: int = 0,
            q_offset: int = 0) -> torch.Tensor:
    """q (B, Hq, Tq, hd); k, v (B, Hkv, Tk, hd) -> (B, Hq, Tq, hd).

    GQA: q head h attends to kv head h // (Hq // Hkv).
    """
    b, hq, tq, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, tq, hd).float()
    kf = k.float()
    vf = v.float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, kf) * (hd ** -0.5)
    if causal:
        qi = q_offset + torch.arange(tq, device=q.device)[:, None]
        ki = torch.arange(k.shape[2], device=q.device)[None, :]
        ok = ki <= qi
        if window > 0:
            ok &= ki > qi - window
        s = torch.where(ok[None, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", w, vf)
    return o.reshape(b, hq, tq, hd).to(q.dtype)
