"""K2: two Jacobi sweeps per pass over device memory (the paper's §4
outlook, temporal blocking), a hand-written CUDA kernel for Hopper.

Replaces the Pallas kernel ``_temporal_kernel`` of
``repro/kernels/jacobi/temporal.py`` (reached through
``jacobi_two_step_pallas``).  The kernel is ``jacobi_two_step_kernel`` in
``repro_torch/csrc/jacobi.cu``: each block marches along i over a chunk of
rows, with f arriving by TMA (2-deep halo in j and k, zeros outside the
lattice) in a ring of planes; it computes step 1 on its tile plus a 1-ring
into a second ring of three step-1 planes, forces the step-1 values that
lie outside the lattice to zero (as the TPU kernel re-zeroes its ring),
and writes step 2 one plane behind.  Its bound is one sweep's bytes,
8 B/site, for two sweeps of work.

``di``/``dj`` keep the reference's contract (``ValueError`` on an
indivisible lattice or on ``di < 2 or dj < 2``) but do not set the CUDA
tiling, which is fixed by the kernel.  Each launch is reported to
``roofline.op_cost``'s active counters (``kernel.report``): ``f`` read and
``out`` written once, two sweeps' operations a site.
"""
from __future__ import annotations

import torch

from .. import _build, refuse_grad
from .kernel import _lib, _shares_storage, check_lattice, report
from .ref import jacobi_two_step_ref


def jacobi_two_step_cuda(f: torch.Tensor, c: float = 1.0 / 6.0, di: int = 10,
                         dj: int = 10, *,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """TWO Jacobi sweeps in one pass over a (Ni, Nj, Nk) lattice — the
    counterpart of ``jacobi_two_step_pallas``.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain version
    (``jacobi_two_step_ref``).  ``out`` (contiguous, ``f``'s shape, not
    ``f`` itself) receives the result in place.
    """
    check_lattice(f, "jacobi_two_step_cuda")
    ni, nj, nk = f.shape
    if ni % di or nj % dj:
        raise ValueError(f"lattice {tuple(f.shape)} not divisible by ({di},{dj})")
    if di < 2 or dj < 2:
        raise ValueError("temporal blocking needs di, dj >= 2")
    if out is None:
        out = torch.empty_like(f)
    elif (out.shape != f.shape or out.dtype != f.dtype or out.device != f.device
          or not out.is_contiguous() or _shares_storage(out, f)):
        raise ValueError(f"out must be a contiguous {f.dtype} tensor of shape "
                         f"{tuple(f.shape)} on {f.device}, apart from f")
    if f.device.type == "cpu":
        return out.copy_(jacobi_two_step_ref(f, c))
    refuse_grad("jacobi_two_step_cuda (K2)", "§2, K1 and K2 gradients", f, out)
    if out.numel() == 0:
        return out
    lib = _lib()
    err = lib.jacobi_two_step_launch(
        f.data_ptr(), out.data_ptr(), ni, nj, nk, float(c),
        torch.cuda.current_stream(f.device).cuda_stream)
    _build.check(lib, err, "jacobi_two_step_kernel launch")
    jacobi_two_step_cuda.launches += 1
    report(f, out, two_step=True)
    return out


jacobi_two_step_cuda.launches = 0
