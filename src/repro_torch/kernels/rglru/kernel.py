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

The gradient: when grad mode is on and an input requires grad, the
wrapper runs as :class:`RGLRUScanFn`, whose forward is the launch above
(counted as before) and whose backward is :func:`rglru_scan_backward`,
``rglru_bwd_kernel`` in ``repro_torch/csrc/rglru_bwd.cu``: the reverse
scan g_t = dh_t + a_{t+1} g_{t+1}, da_t = g_t h_{t-1}, db_t = g_t, with
the same design as the forward (one channel a thread, a ring of
``cp.async`` stages walked from the end) and each product and sum rounded
once, so it equals ``rglru_scan_bwd_ref`` and autograd through
``rglru_scan_ref`` bit for bit.

Every launch of either is reported to ``roofline.op_cost``'s active
counters (:func:`_report`): the tensors it reads and writes, each once,
and ``FWD_FLOPS`` or ``BWD_FLOPS`` per element, the counts behind
``chip_smoke.py``'s bounds.

On ``meta`` tensors (``_device.kernel_path``: the dry run, the counted
steps) both walk the CUDA path without launching: they allocate the
results the launch would write, report it as the card does, and never
load the library.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..._device import kernel_path
from ...roofline import op_cost
from .. import _build
from .ref import rglru_scan_bwd_ref, rglru_scan_ref

# f32 operations per (b, t, w): forward a multiply and an add; backward a
# multiply-add for the carried gradient and a multiply for da
FWD_FLOPS, BWD_FLOPS = 2, 3


def _report(name: str, reads, writes, per: int) -> None:
    """One launch to ``roofline.op_cost``'s active counters: ``reads`` and
    ``writes`` (None skipped) once each, ``per`` flops for each element of
    the first read.  Nothing when no counter is open."""
    if op_cost._ACTIVE:
        op_cost.kernel_launch(name, [x for x in reads if x is not None],
                              [x for x in writes if x is not None], per * reads[0].numel())


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("rglru")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rglru_launch.argtypes = [p, p, p, p, i, i, i, p]
    lib.rglru_launch.restype = i
    lib.rglru_stage_steps.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("rglru_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rglru_bwd_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
    lib.rglru_bwd_launch.restype = i
    lib.rglru_bwd_stage_steps.restype = i
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
            a.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError("rglru_scan runs on one cuda device (cpu for the "
                         "plain version, meta to count it)")


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor, chunk: int = 128,
                    h0: torch.Tensor | None = None) -> torch.Tensor:
    """a, b: (B, T, W); h0: (B, W) or None (zero).  Returns h (B, T, W).

    Requires T % chunk == 0, as the reference does.  A CUDA tensor launches
    the kernel, a meta tensor counts it (no launch); a CPU tensor takes the
    plain version (``rglru_scan_ref``).
    On the card a, b and h0 are float32 and contiguous; when grad mode is
    on and one of them requires grad, the call runs as :class:`RGLRUScanFn`
    (the same launch, with K5's backward behind it).
    """
    _check(a, b, h0)
    bt, t, w = a.shape
    if t % chunk:
        raise ValueError(f"T={t} not divisible by chunk={chunk}")
    if not kernel_path(a):
        return rglru_scan_ref(a, b, h0)
    _check_card(a, b, h0)
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad
                                       for x in (a, b, h0)):
        return RGLRUScanFn.apply(a, b, h0)
    return _launch(a, b, h0)


rglru_scan_cuda.launches = 0


def _check_card(*xs) -> None:
    tensors = [x for x in xs if x is not None]
    if any(x.dtype != torch.float32 for x in tensors):
        raise TypeError(f"rglru_scan takes float32 on the card: "
                        f"{[x.dtype for x in tensors]}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("rglru_scan takes contiguous tensors")
    bt, _, w = tensors[0].shape
    if bt > 65535 or w >= 2 ** 31 or tensors[0].numel() >= 2 ** 62:
        raise ValueError(f"shape {tuple(tensors[0].shape)} exceeds the kernel's grid")


def _launch(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None) -> torch.Tensor:
    """One K5 launch on checked CUDA tensors, counted (on meta tensors
    reported, not launched)."""
    bt, t, w = a.shape
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    if not a.is_meta:
        lib = _lib()
        err = lib.rglru_launch(a.data_ptr(), b.data_ptr(),
                               None if h0 is None else h0.data_ptr(), out.data_ptr(),
                               bt, t, w, torch.cuda.current_stream(a.device).cuda_stream)
        _build.check(lib, err, "rglru_kernel launch")
        rglru_scan_cuda.launches += 1
    _report("K5", (a, b, h0), (out,), FWD_FLOPS)
    return out


def rglru_scan_backward(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
                        h0: torch.Tensor | None = None):
    """(da, db, dh0) of ``h = rglru_scan_cuda(a, b, h0=h0)`` for the
    gradient ``dh`` of h (dh0 None when h0 is None).  A CUDA tensor
    launches K5's backward (float32, any contiguous layout of dh is copied
    first), a meta tensor counts it; a CPU tensor takes the plain version,
    ``rglru_scan_bwd_ref``."""
    _check(a, h, h0)
    if dh.shape != a.shape:
        raise ValueError(f"dh is {tuple(dh.shape)}, a is {tuple(a.shape)}")
    if not kernel_path(a):
        return rglru_scan_bwd_ref(a, h, dh, h0)
    dh = dh.float().contiguous()
    _check_card(a, h, dh, h0)
    bt, t, w = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    if a.numel() == 0:
        return da, db, None if dh0 is None else dh0.zero_()
    if not a.is_meta:
        lib = _bwd_lib()
        err = lib.rglru_bwd_launch(
            a.data_ptr(), h.data_ptr(), dh.data_ptr(), None if h0 is None else h0.data_ptr(),
            da.data_ptr(), db.data_ptr(), None if dh0 is None else dh0.data_ptr(), bt, t, w,
            torch.cuda.current_stream(a.device).cuda_stream)
        _build.check(lib, err, "rglru_bwd_kernel launch")
        rglru_scan_backward.launches += 1
    _report("K5 backward", (a, h, dh, h0), (da, db, dh0), BWD_FLOPS)
    return da, db, dh0


rglru_scan_backward.launches = 0


class RGLRUScanFn(torch.autograd.Function):
    """K5 with its gradient: ``RGLRUScanFn.apply(a, b, h0)`` is one K5
    launch forward and one ``rglru_scan_backward`` launch backward."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = _launch(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        da, db, dh0 = rglru_scan_backward(a, h, dh, h0)
        return da, db, dh0
