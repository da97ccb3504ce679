"""Public entry for flash attention (counterpart of
``repro.kernels.flash_attention.ops``).

``use_kernel`` is the reference's ``use_pallas`` renamed, and ``interpret``
is gone: it has no meaning here.  With ``use_kernel=True`` a CUDA tensor
goes to the Hopper kernel (K3) or raises, and a CPU tensor to the plain
version; ``use_kernel=False`` asks for the plain version on any device.

It mirrors the reference's public entry and layout.  The model does not
call it: ``models.attention`` hands K3 strided (B, T, H, hd) views with
``bq = Tq`` and ``bk = Tk`` through ``flash_attention`` directly, and makes
its own kernel-or-plain choice there.
"""
from __future__ import annotations

import torch

from .kernel import flash_attention
from .ref import mha_ref


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    use_kernel: bool = True) -> torch.Tensor:
    """(B, Hq, Tq, hd) x (B, Hkv, Tk, hd) -> (B, Hq, Tq, hd)."""
    if use_kernel:
        return flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    return mha_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
