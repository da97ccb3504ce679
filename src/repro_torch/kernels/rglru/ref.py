"""Plain PyTorch version of the RG-LRU linear recurrence
h_t = a_t h_{t-1} + b_t.

The port of ``repro.kernels.rglru.ref``, step by step.  It is the port's
one plain version for any T: the reference's model computes the same
function with an associative scan (short or ragged T), a chunked
``lax.scan`` (long T) or, at decode, one inline update, and its Pallas
kernel with a VMEM carry; each step here is a multiply and an add, each
rounded once, as K5 computes it.  ``rglru_scan_bwd_ref`` is its gradient
written out as a reverse scan, the plain version of K5's backward.
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


def rglru_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
                       h0: torch.Tensor | None = None):
    """The gradient of ``rglru_scan_ref`` as an explicit reverse scan.

    a, h, dh: (B, T, W) (h the scan's result, dh its gradient); h0 (B, W)
    or None.  Returns (da, db, dh0), dh0 None when h0 is None:

        g_t = dh_t + a_{t+1} g_{t+1},  db_t = g_t,  da_t = g_t h_{t-1},
        dh0 = a_0 g_0,

    each product and sum rounded once, the two terms autograd adds at each
    step, so it equals autograd of ``rglru_scan_ref`` bit for bit."""
    bt, t, w = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    g = None
    for i in range(t - 1, -1, -1):
        g = dh[:, i] if g is None else dh[:, i] + a[:, i + 1] * g
        db[:, i] = g
        prev = h[:, i - 1] if i > 0 else (h0 if h0 is not None else torch.zeros_like(g))
        da[:, i] = g * prev
    dh0 = None if h0 is None or g is None else a[:, 0] * g
    return da, db, dh0
