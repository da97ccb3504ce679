"""Public entry for the RG-LRU scan (counterpart of
``repro.kernels.rglru.ops``), and the one kernel-or-plain switch the model
calls.

``use_kernel`` is the reference's ``use_pallas`` renamed, in the same
third positional slot, and ``interpret`` and ``chunk`` are gone: the
Hopper kernel takes any T, so no length falls back to the associative
scan.  So a reference-style ``rglru_scan(a, b, False)`` takes the plain
path, as the reference's does, and a fourth positional argument raises
``TypeError``.  With ``use_kernel=True`` a CUDA tensor goes to K5 or
raises, a meta tensor is counted as K5 (no launch), and a CPU tensor
goes to the plain version; ``use_kernel=False`` asks
for the plain version on any device.  Beyond the reference, the
keyword-only ``h0`` carries a state in (the model's decode step and a
prefill from a cache).  On a CUDA tensor in grad mode (training) the
kernel path runs as ``kernel.RGLRUScanFn``: K5 forward, K5's reverse scan
backward; serving runs under ``torch.no_grad`` and launches K5 alone.
"""
from __future__ import annotations

import torch

from .kernel import rglru_scan_cuda
from .ref import rglru_scan_ref


def rglru_scan(a: torch.Tensor, b: torch.Tensor, use_kernel: bool = True, *,
               h0: torch.Tensor | None = None) -> torch.Tensor:
    """h (B, T, W) of h_t = a_t h_{t-1} + b_t from ``h0`` (zero when None)."""
    if use_kernel:
        return rglru_scan_cuda(a, b, chunk=a.shape[1], h0=h0)
    return rglru_scan_ref(a, b, h0)
