"""K4: the RWKV-6 WKV recurrence, a hand-written CUDA kernel for Hopper.

Replaces the Pallas kernel ``_wkv_kernel`` of
``repro/kernels/rwkv6/kernel.py`` (reached through ``wkv6_pallas``).  The
kernels are in ``repro_torch/csrc/wkv6.cu``; its note gives the bound
(about balanced between bytes and f32 operations at prefill, the state's
bytes at decode) and the design: a time-chunked scan.  Time is cut into
chunks of ``TIME_CHUNK`` steps; ``wkv6_kernel`` runs every chunk from a
zero state in parallel (each thread 4 rows x 4 columns of the state at hd
64), ``wkv6_carry_kernel`` carries the state across the chunks, and
``wkv6_fix_kernel`` adds each chunk's carried-in state to its outputs.  A
call of at most ``TIME_CHUNK`` steps (every decode step) is one launch of
``wkv6_kernel`` from the given state, with no scratch; a longer one is
three launches and takes B·H·(nc·(hd² + hd) + T·hd) f32 of scratch (nc
chunks), allocated here.

Beyond the reference's contract, the wrapper takes a carried-in state
``s0`` (parity is held against ``wkv6_ref(s0=...)``) and writes the final
state into it in place (the model updates its cache so).  ``chunk`` keeps the reference's contract, T
divisible by it or ``ValueError``, but sets nothing on the card: the kernel
takes any T, and callers with ragged T pass ``chunk=T``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import wkv6_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (8, 16, 32, 64)     # the kernel's compiled head widths
# steps per time chunk: the fastest of 32, 64 and 128 at rwkv6-3b's prefill
# 128 and 1024 on an H100 (``python -m repro_torch.kernels.rwkv6.sweep``)
TIME_CHUNK = 128


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("wkv6")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_launch.argtypes = [i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.wkv6_launch.restype = i
    return lib


def _check(r, k, v, w, u, s0) -> None:
    if r.dim() != 4:
        raise ValueError(f"wkv6 takes (B, T, H, hd) tensors; r is {tuple(r.shape)}")
    b, _, h, hd = r.shape
    for name, x in (("k", k), ("v", v), ("w", w)):
        if x.shape != r.shape:
            raise ValueError(f"{name} is {tuple(x.shape)}, r is {tuple(r.shape)}")
    if u.shape != (h, hd):
        raise ValueError(f"u is {tuple(u.shape)}, want (H, hd) = {(h, hd)}")
    if s0 is not None and s0.shape != (b, h, hd, hd):
        raise ValueError(f"s0 is {tuple(s0.shape)}, want {(b, h, hd, hd)}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k, v must share float32 or bfloat16: {r.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    tensors = [x for x in (r, k, v, w, u, s0) if x is not None]
    if any(x.device != r.device for x in tensors) or \
            r.device.type not in ("cpu", "cuda"):
        raise ValueError("wkv6 runs on one cuda device (or cpu for the plain "
                         "version)")


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, chunk: int = 64,
              s0: torch.Tensor | None = None):
    """r, k, v, w: (B, T, H, hd); u: (H, hd); s0: (B, H, hd, hd).

    Returns (o (B, T, H, hd) f32, sT (B, H, hd, hd) f32); ``sT`` is ``s0``
    itself, updated in place, when one is given.  Requires T % chunk == 0, as the
    reference does.  A CUDA tensor launches the kernel; a CPU tensor takes
    the plain version (``wkv6_ref``).  On the card r, k, v are f32 or bf16
    and w, u, s0 f32, all contiguous, and r, k, v, w start on 16 bytes.
    """
    _check(r, k, v, w, u, s0)
    b, t, h, hd = r.shape
    if t % chunk:
        raise ValueError(f"T={t} not divisible by chunk={chunk}")
    if r.device.type == "cpu":
        o, st = wkv6_ref(r, k, v, w, u, s0=s0)
        return o, (st if s0 is None else s0.copy_(st))
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not compiled; the kernel takes {HEAD_DIMS}")
    f32 = [x for x in (w, u, s0) if x is not None]
    if any(x.dtype != torch.float32 for x in f32):
        raise TypeError("w, u and s0 must be float32 on the card")
    if not all(x.is_contiguous() for x in (r, k, v, *f32)):
        raise ValueError("wkv6 takes contiguous tensors")
    if any(x.data_ptr() % 16 for x in (r, k, v, w)):
        raise ValueError("wkv6 reads r, k, v and w 16 bytes at a time: each must "
                         "start on 16 bytes (copy a view cut at an odd offset)")
    if b * h >= 2 ** 31 or r.numel() >= 2 ** 62 or t > 65535 * 32:   # grid y
        raise ValueError(f"shape {tuple(r.shape)} exceeds the kernel's grid")
    o, st = run(r, k, v, w, u, s0, TIME_CHUNK)
    wkv6_cuda.launches += 1
    return o, st


wkv6_cuda.launches = 0


def run(r, k, v, w, u, s0, chunk: int):
    """Launch K4 on checked CUDA tensors with time chunks of ``chunk`` steps:
    (o, sT).  ``wkv6_cuda`` calls it with ``TIME_CHUNK``; the sweep with
    other chunk sizes."""
    b, t, h, hd = r.shape
    o = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    st = s0 if s0 is not None else \
        torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device)
    scratch = None if t <= chunk else torch.empty(
        b * h * (-(-t // chunk) * (hd * hd + hd) + t * hd), dtype=torch.float32,
        device=r.device)
    lib = _lib()
    err = lib.wkv6_launch(
        _DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), None if s0 is None else s0.data_ptr(), o.data_ptr(),
        st.data_ptr(), None if scratch is None else scratch.data_ptr(), b, t, h, hd,
        chunk, torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, err, "wkv6 kernel launch")
    return o, st
