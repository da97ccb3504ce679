"""Public entry for the RWKV-6 WKV recurrence (counterpart of
``repro.kernels.rwkv6.ops``), and the one kernel-or-plain switch the model
calls.

``use_kernel`` is the reference's ``use_pallas`` renamed, in the same
sixth positional slot, and ``interpret`` and ``chunk`` are gone: the
Hopper kernel takes any T, so no length falls back to the plain version.
So a reference-style ``wkv6(r, k, v, w, u, False)`` takes the plain path,
as the reference's does, and a seventh positional argument raises
``TypeError``.  With ``use_kernel=True`` a CUDA tensor goes to K4 or
raises, and a CPU tensor to the plain version; ``use_kernel=False`` asks
for the plain version on any device.  Beyond the reference, the
keyword-only ``s0`` carries a state in, and the final state is written
into it in place (the model's cache update, ROADMAP P8).
"""
from __future__ import annotations

import torch

from .kernel import wkv6_cuda
from .ref import wkv6_ref


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, use_kernel: bool = True, *,
         s0: torch.Tensor | None = None):
    """(o, sT) for the RWKV-6 recurrence from ``s0`` (zero when None);
    ``sT`` is ``s0`` itself, updated in place, when one is given."""
    if use_kernel:
        return wkv6_cuda(r, k, v, w, u, chunk=r.shape[1], s0=s0)
    o, st = wkv6_ref(r, k, v, w, u, s0=s0)
    return o, (st if s0 is None else s0.copy_(st))
