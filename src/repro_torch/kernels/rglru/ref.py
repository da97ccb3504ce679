"""Plain PyTorch version of the RG-LRU linear recurrence
h_t = a_t h_{t-1} + b_t.

The port of ``repro.kernels.rglru.ref``, step by step.  It is the port's
one plain version for any T: the reference's model computes the same
function with an associative scan (short or ragged T), a chunked
``lax.scan`` (long T) or, at decode, one inline update, and its Pallas
kernel with a VMEM carry; each step here is a multiply and an add, each
rounded once, as K5 computes it.
"""
from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: torch.Tensor | None = None) -> torch.Tensor:
    """a, b: (B, T, W); h0 (B, W). Returns h (B, T, W) — plain loop."""
    bt, t, w = a.shape
    h = h0 if h0 is not None else torch.zeros((bt, w), dtype=a.dtype, device=a.device)
    outs = []
    for i in range(t):
        h = a[:, i] * h + b[:, i]
        outs.append(h)
    return torch.stack(outs, dim=1)
