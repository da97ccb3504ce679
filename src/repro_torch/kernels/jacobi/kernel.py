"""K1: one six-point Jacobi sweep, a hand-written CUDA kernel for Hopper.

Replaces the Pallas kernel ``_jacobi_kernel`` of
``repro/kernels/jacobi/kernel.py`` (reached through
``jacobi_sweep_pallas``).  The kernel is ``jacobi_sweep_kernel`` in
``repro_torch/csrc/jacobi.cu``; its note gives the byte bound (8 B/site,
2.06 ms at 2400x600x600 on an H100) and the 2.5-D blocking that replaces
the TPU's whole-k VMEM tiles.

``di``/``dj`` keep the reference's contract — a lattice they do not divide
raises ``ValueError`` — but do not set the CUDA tiling, which is fixed by
the kernel ((8, 32) threads over (j, k), marching 32 rows along i).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import jacobi_sweep_ref


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("jacobi")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.jacobi_sweep_launch.argtypes = [p, p, i, i, i, i, i, ctypes.c_float, p]
    lib.jacobi_sweep_launch.restype = i
    return lib


def check_lattice(f: torch.Tensor, what: str) -> None:
    """Raise unless ``f`` is a 3-D float32 tensor the kernels take: on the
    CPU (plain version) or a contiguous CUDA tensor."""
    if not isinstance(f, torch.Tensor) or f.dim() != 3:
        raise ValueError(f"{what} takes a 3-D (Ni, Nj, Nk) tensor, got "
                         f"{getattr(f, 'shape', type(f))}")
    if f.dtype != torch.float32:
        raise TypeError(f"{what} takes float32, got {f.dtype}")
    if f.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda (or cpu for the plain "
                         f"version), got {f.device}")
    if f.device.type == "cuda" and not f.is_contiguous():
        raise ValueError(f"{what} takes a contiguous tensor")


def _shares_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The kernels read all of ``f`` while writing ``out``: they must not
    share memory."""
    return (a.numel() > 0 and b.numel() > 0 and
            a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr())


def jacobi_sweep_cuda(f: torch.Tensor, c: float = 1.0 / 6.0, di: int = 10,
                      dj: int = 10, *, out: torch.Tensor | None = None,
                      rows: tuple[int, int] | None = None) -> torch.Tensor:
    """One Jacobi sweep over a (Ni, Nj, Nk) lattice — the counterpart of
    ``jacobi_sweep_pallas``.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain version
    (``jacobi_sweep_ref``).  ``rows=(r0, r1)`` computes only output rows
    ``r0:r1`` of the sweep; ``out`` (shape ``(r1 - r0, Nj, Nk)``, contiguous)
    receives them in place.  Together they let the runtime sweep update a
    halo-padded slab straight into its rows of the result, with no crop copy.
    """
    check_lattice(f, "jacobi_sweep_cuda")
    ni, nj, nk = f.shape
    if ni % di or nj % dj:
        raise ValueError(f"lattice {tuple(f.shape)} not divisible by block ({di},{dj})")
    r0, r1 = (0, ni) if rows is None else rows
    if not 0 <= r0 <= r1 <= ni:
        raise ValueError(f"rows {rows} outside the lattice's {ni} rows")
    if out is None:
        out = torch.empty((r1 - r0, nj, nk), dtype=f.dtype, device=f.device)
    elif (out.shape != (r1 - r0, nj, nk) or out.dtype != f.dtype
          or out.device != f.device or not out.is_contiguous()
          or _shares_storage(out, f)):
        raise ValueError(f"out must be a contiguous {f.dtype} tensor of shape "
                         f"{(r1 - r0, nj, nk)} on {f.device}, apart from f")
    if f.device.type == "cpu":
        out.copy_(jacobi_sweep_ref(f, c)[r0:r1])
        return out
    if out.numel() == 0:
        return out
    lib = _lib()
    err = lib.jacobi_sweep_launch(
        f.data_ptr(), out.data_ptr(), ni, nj, nk, r0, r1 - r0, float(c),
        torch.cuda.current_stream(f.device).cuda_stream)
    _build.check(lib, err, "jacobi_sweep_kernel launch")
    jacobi_sweep_cuda.launches += 1
    return out


jacobi_sweep_cuda.launches = 0
