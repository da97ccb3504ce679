"""Public entry points for the Jacobi stencil (counterpart of
``repro.kernels.jacobi.ops``).

``use_kernel`` is the reference's ``use_pallas`` renamed, and
``interpret`` is gone: it has no meaning here.  With ``use_kernel=True`` a
CUDA tensor goes to the Hopper kernels (K1, and K2 for pairs of sweeps in
``jacobi_iterate``) or raises, and a CPU tensor to the plain versions;
``use_kernel=False`` asks for the plain version on any device.
"""
from __future__ import annotations

import torch

from .kernel import jacobi_sweep_cuda
from .ref import jacobi_sweep_ref
from .temporal import jacobi_two_step_cuda


def jacobi_sweep(f: torch.Tensor, c: float = 1.0 / 6.0, di: int = 10,
                 dj: int = 10, use_kernel: bool = True, *,
                 out: torch.Tensor | None = None,
                 rows: tuple[int, int] | None = None) -> torch.Tensor:
    """One Jacobi sweep; the Hopper kernel or the plain version.

    ``rows``/``out`` select output rows and write them in place, as in
    ``jacobi_sweep_cuda``.
    """
    if use_kernel:
        return jacobi_sweep_cuda(f, c, di, dj, out=out, rows=rows)
    res = jacobi_sweep_ref(f, c)
    if rows is not None:
        res = res[rows[0]:rows[1]]
    if out is None:
        return res
    return out.copy_(res)


def jacobi_iterate(f: torch.Tensor, steps: int, c: float = 1.0 / 6.0,
                   use_kernel: bool = True) -> torch.Tensor:
    """``steps`` sweeps, double-buffered (as in the paper): two buffers
    swap roles each pass, and ``f`` itself is never written.

    The reference runs this as a ``lax.scan`` of single sweeps and defaults
    to its jnp path.  Here the default is the kernel path, so a CUDA tensor
    never takes the plain version unless asked to, and that path does the
    sweeps in pairs with the temporal kernel (K2: two sweeps per pass over
    memory, the paper's §4 outlook), plus one K1 sweep when ``steps`` is
    odd.  A pair is exactly two sweeps, so the result is the reference's.
    The kernel path keeps the reference's default (10, 10) blocks, so the
    lattice must divide by them.
    """
    if steps == 0:
        return f.clone()
    src, spare = f, torch.empty_like(f)
    done = 0
    while done < steps:
        dst = spare
        if use_kernel and steps - done >= 2:
            jacobi_two_step_cuda(src, c, out=dst)
            done += 2
        else:
            jacobi_sweep(src, c, use_kernel=use_kernel, out=dst)
            done += 1
        spare = src if src is not f else torch.empty_like(f)
        src = dst
    return src
