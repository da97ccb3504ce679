"""K1: one six-point Jacobi sweep, a hand-written CUDA kernel for Hopper.

Replaces the Pallas kernel ``_jacobi_kernel`` of
``repro/kernels/jacobi/kernel.py`` (reached through
``jacobi_sweep_pallas``).  The kernel is ``jacobi_sweep_kernel`` in
``repro_torch/csrc/jacobi.cu``; its note gives the byte bound (8 B/site,
2.06 ms at 2400x600x600 on an H100) and the design that replaces the TPU's
whole-k VMEM tiles: a block owns a (j, k) tile and marches along i through
a ring of planes that the Tensor Memory Accelerator fills (4-byte
``cp.async`` copies where ``nk`` is not a multiple of 4).

``di``/``dj`` keep the reference's contract — a lattice they do not divide
raises ``ValueError`` — but do not set the CUDA tiling, which is fixed by
the kernel (``geometry``).  ``launch`` reaches every compiled instance, for
``python -m repro_torch.kernels.jacobi.sweep`` and the tests; the wrappers
launch the default one.
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
    lib.jacobi_two_step_launch.argtypes = [p, p, i, i, i, ctypes.c_float, p]
    lib.jacobi_launch.argtypes = [i, i, i, i, p, p, i, i, i, i, i, ctypes.c_float, p]
    lib.jacobi_variant_info.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    lib.jacobi_encode_ns.argtypes = [p, i, i, i, i, i, ctypes.POINTER(ctypes.c_longlong)]
    for fn in (lib.jacobi_variant_count, lib.jacobi_default_variant,
               lib.jacobi_default_chunk):
        fn.argtypes = [i]
    for fn in (lib.jacobi_sweep_launch, lib.jacobi_two_step_launch, lib.jacobi_launch,
               lib.jacobi_variant_info, lib.jacobi_variant_count,
               lib.jacobi_default_variant, lib.jacobi_default_chunk,
               lib.jacobi_encode_ns):
        fn.restype = i
    return lib


def geometry(two_step: bool = False, variant: int | None = None) -> dict:
    """One compiled instance of K1 (or K2 with ``two_step``), the wrappers'
    by default: its output tile (``tj`` x ``tk``), ring ``stages``,
    ``threads``, dynamic shared memory, resident blocks per SM of the TMA and
    the 4-byte-copy instance, the blocks per SM asked of ptxas
    (``min_blocks``), and the i chunk (``chunk``) the wrappers use.
    Needs the card (occupancy is the device's answer)."""
    lib = _lib()
    v = lib.jacobi_default_variant(int(two_step)) if variant is None else variant
    info = (ctypes.c_int * 8)()
    _build.check(lib, lib.jacobi_variant_info(int(two_step), v, info),
                 f"jacobi_variant_info({int(two_step)}, {v})")
    keys = ("tj", "tk", "stages", "threads", "smem_bytes", "blocks_per_sm",
            "blocks_per_sm_copy", "min_blocks")
    return dict(zip(keys, info), variant=v,
                chunk=lib.jacobi_default_chunk(int(two_step)))


def variants(two_step: bool = False) -> int:
    """How many instances of K1 (or K2) the library holds."""
    return _lib().jacobi_variant_count(int(two_step))


def launch(two_step: bool, variant: int, chunk: int, f: torch.Tensor,
           out: torch.Tensor, rows: tuple[int, int] | None = None,
           c: float = 1.0 / 6.0, tma: bool = True) -> torch.Tensor:
    """Launch instance ``variant`` of K1 (rows ``rows`` of one sweep into
    ``out``) or K2 (two sweeps of all of ``f``) in i chunks of ``chunk``
    rows; ``tma=False`` takes the 4-byte-copy route.  Counts no launch: the
    wrappers' counters count the main path's."""
    check_lattice(f, "launch")
    ni, nj, nk = f.shape
    r0, r1 = (0, ni) if rows is None else rows
    if (f.device.type != "cuda" or not 0 <= r0 < r1 <= ni or out.dtype != f.dtype
            or out.device != f.device or out.shape != (r1 - r0, nj, nk)
            or not out.is_contiguous() or _shares_storage(out, f)):
        raise ValueError(f"launch takes a CUDA lattice and a contiguous out of shape "
                         f"{(r1 - r0, nj, nk)} apart from it, rows within {ni}")
    lib = _lib()
    err = lib.jacobi_launch(int(two_step), variant, chunk, int(tma), f.data_ptr(),
                            out.data_ptr(), ni, nj, nk, r0, r1 - r0, float(c),
                            torch.cuda.current_stream(f.device).cuda_stream)
    _build.check(lib, err, f"jacobi_launch({int(two_step)}, {variant})")
    return out


def encode_ns(f: torch.Tensor, two_step: bool = False, reps: int = 1000) -> int:
    """Mean host ns of one tensor-map encode for ``f`` (what the wrappers
    pay on the host per launch for encoding the map anew)."""
    lib = _lib()
    ns = ctypes.c_longlong()
    _build.check(lib, lib.jacobi_encode_ns(f.data_ptr(), *f.shape, int(two_step), reps,
                                           ctypes.byref(ns)), "cuTensorMapEncodeTiled")
    return ns.value


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
    slab of the whole lattice straight into its rows of the result: the
    kernel reads the slab's halo planes from ``f`` (zeros at the lattice's
    edges), and the plain version sweeps only rows ``r0 - 1 .. r1`` of it.
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
        lo, hi = max(r0 - 1, 0), min(r1 + 1, ni)   # the rows and their halo planes
        out.copy_(jacobi_sweep_ref(f[lo:hi], c)[r0 - lo:r1 - lo])
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
