"""K5: the RG-LRU linear recurrence h_t = a_t h_{t-1} + b_t, a hand-written
CUDA kernel for Hopper.

Replaces the Pallas kernel ``_rglru_kernel`` of
``repro/kernels/rglru/kernel.py`` (reached through ``rglru_scan_pallas``).
The kernel is ``rglru_kernel`` in ``repro_torch/csrc/rglru.cu``; its note
gives the bound (bytes: a and b read once, h written once) and the design:
a pipelined walk, one warp per strip of 32 channels (128 strips at W 4096,
B 1), each channel walking all of time in one thread while ``cp.async``
keeps four stages of a and b (32 steps x 32 channels each) in flight in a
ring of shared memory.  Each step is a multiply and an add, each rounded
once, so it equals ``rglru_scan_ref`` bit for bit.

Beyond the reference's contract, the wrapper takes a carried-in state
``h0`` (parity is held against ``rglru_scan_ref(h0=...)``).  ``chunk``
keeps the reference's contract, T divisible by it or ``ValueError``, but
sets nothing on the card: the kernel takes any T, and callers with ragged
T pass ``chunk=T``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import rglru_scan_ref


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("rglru")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rglru_launch.argtypes = [p, p, p, p, i, i, i, p]
    lib.rglru_launch.restype = i
    lib.rglru_stage_steps.restype = i
    return lib


def stage_steps() -> int:
    """Steps per shared-memory stage of the compiled kernel (needs nvcc)."""
    return _lib().rglru_stage_steps()


def _check(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None) -> None:
    if a.dim() != 3:
        raise ValueError(f"rglru_scan takes (B, T, W) tensors; a is {tuple(a.shape)}")
    if b.shape != a.shape:
        raise ValueError(f"b is {tuple(b.shape)}, a is {tuple(a.shape)}")
    if h0 is not None and h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"h0 is {tuple(h0.shape)}, want (B, W) = "
                         f"{(a.shape[0], a.shape[2])}")
    tensors = [x for x in (a, b, h0) if x is not None]
    if any(x.device != a.device for x in tensors) or \
            a.device.type not in ("cpu", "cuda"):
        raise ValueError("rglru_scan runs on one cuda device (or cpu for the "
                         "plain version)")


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor, chunk: int = 128,
                    h0: torch.Tensor | None = None) -> torch.Tensor:
    """a, b: (B, T, W); h0: (B, W) or None (zero).  Returns h (B, T, W).

    Requires T % chunk == 0, as the reference does.  A CUDA tensor launches
    the kernel; a CPU tensor takes the plain version (``rglru_scan_ref``).
    On the card a, b and h0 are float32 and contiguous.
    """
    _check(a, b, h0)
    bt, t, w = a.shape
    if t % chunk:
        raise ValueError(f"T={t} not divisible by chunk={chunk}")
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    tensors = [x for x in (a, b, h0) if x is not None]
    if any(x.dtype != torch.float32 for x in tensors):
        raise TypeError(f"rglru_scan takes float32 on the card: "
                        f"{[x.dtype for x in tensors]}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("rglru_scan takes contiguous tensors")
    if bt > 65535 or w >= 2 ** 31 or a.numel() >= 2 ** 62:
        raise ValueError(f"shape {tuple(a.shape)} exceeds the kernel's grid")
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    lib = _lib()
    err = lib.rglru_launch(a.data_ptr(), b.data_ptr(),
                           None if h0 is None else h0.data_ptr(), out.data_ptr(),
                           bt, t, w, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, err, "rglru_kernel launch")
    rglru_scan_cuda.launches += 1
    return out


rglru_scan_cuda.launches = 0
