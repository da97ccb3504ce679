"""Plain PyTorch version of the blocked 3D six-point Jacobi sweep (paper §1.4).

F_{t+1}(i,j,k) = c * [ F_t(i-1,j,k) + F_t(i+1,j,k)
                     + F_t(i,j-1,k) + F_t(i,j+1,k)
                     + F_t(i,j,k-1) + F_t(i,j,k+1) ]

Dirichlet boundary: sites outside the lattice are zero.  The six
neighbours are summed in the same order as ``repro.kernels.jacobi.ref``,
so the two agree up to reassociation only; the CUDA kernels keep that
order too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def jacobi_sweep_ref(f: torch.Tensor, c: float | torch.Tensor = 1.0 / 6.0) -> torch.Tensor:
    """One whole-lattice Jacobi sweep on a (Ni, Nj, Nk) tensor."""
    p = F.pad(f, (1, 1, 1, 1, 1, 1))
    out = (p[:-2, 1:-1, 1:-1] + p[2:, 1:-1, 1:-1]
           + p[1:-1, :-2, 1:-1] + p[1:-1, 2:, 1:-1]
           + p[1:-1, 1:-1, :-2] + p[1:-1, 1:-1, 2:])
    return (c * out).to(f.dtype)


def jacobi_block_ref(f: torch.Tensor, i0: int, j0: int, di: int, dj: int,
                     c: float = 1.0 / 6.0) -> torch.Tensor:
    """Jacobi update of one (di, dj, Nk) block of the full lattice — the
    paper's ``jacobi_sweep_block()`` — with global boundary conditions."""
    return jacobi_sweep_ref(f, c)[i0:i0 + di, j0:j0 + dj, :]


def jacobi_two_step_ref(f: torch.Tensor, c: float | torch.Tensor = 1.0 / 6.0) -> torch.Tensor:
    """Two sweeps, the second on the first's result (the temporal kernel's
    plain version)."""
    return jacobi_sweep_ref(jacobi_sweep_ref(f, c), c)
