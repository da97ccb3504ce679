"""K3: flash attention (GQA, causal, sliding window), a hand-written CUDA
kernel for Hopper.

Replaces the Pallas kernel ``_flash_kernel`` of
``repro/kernels/flash_attention/kernel.py`` (reached through
``flash_attention``).  The kernel is ``flash_attention_kernel`` in
``repro_torch/csrc/flash_attention.cu``; its note gives the bounds (prefill
by operations, decode by the K/V bytes up to the query's position) and the
design: group-major blocks that read each K/V tile once per kv head, and a
key range computed per block, so decode reads only the cache's filled part.

``bq``/``bk`` keep the reference's contract — sequence lengths they do not
divide raise ``ValueError`` — but do not set the CUDA tiling, which is
fixed by the kernel (32-key tiles; up to 32 query rows per block).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import mha_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)     # the kernel's compiled head widths
MAX_ROWS = 32                     # (query head, position) rows of one block


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [
        i, p, p, p, p, i, i, i, i, i, i, ctypes.POINTER(ctypes.c_longlong),
        i, i, i, ctypes.c_float, i, p]
    lib.flash_attention_launch.restype = i
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor) or x.dim() != 4:
            raise ValueError(f"flash_attention takes 4-D (B, H, T, hd) tensors; "
                             f"{name} is {getattr(x, 'shape', type(x))}")
        if x.dtype not in _DTYPES:
            raise TypeError(f"flash_attention takes float32 or bfloat16, "
                            f"{name} is {x.dtype}")
        if x.device.type not in ("cpu", "cuda") or x.device != q.device:
            raise ValueError(f"flash_attention runs on one cuda device (or cpu "
                             f"for the plain version); {name} is on {x.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    b, hq, _, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k and v must be (B, Hkv, Tk, hd) = ({b}, Hkv, Tk, "
                         f"{hd}); got {tuple(k.shape)} and {tuple(v.shape)}")
    if k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"{hq} query heads do not split over {k.shape[1]} kv heads")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    bq: int = 256, bk: int = 256) -> torch.Tensor:
    """q (B, Hq, Tq, hd); k, v (B, Hkv, Tk, hd) -> (B, Hq, Tq, hd).

    Requires Tq % bq == 0 and Tk % bk == 0, as the reference does.  A CUDA
    tensor launches the kernel; a CPU tensor takes the plain version
    (``mha_ref``).  On the card the inputs may be any strided views whose
    last dim is contiguous (the model passes transposed (B, T, H, hd)
    projections and cache views), and the result lies in (B, Tq, Hq, hd)
    memory, returned as its (B, Hq, Tq, hd) view, so the model's
    ``transpose(1, 2).reshape(B, Tq, Hq * hd)`` costs no copy.
    """
    _check(q, k, v)
    b, hq, tq, hd = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if tq % bq or tk % bk:
        raise ValueError(f"seq lens ({tq},{tk}) not divisible by blocks ({bq},{bk})")
    if q.device.type == "cpu":
        return mha_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    group = hq // hkv
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not compiled; the kernel takes {HEAD_DIMS}")
    if group > MAX_ROWS:
        raise ValueError(f"{group} query heads per kv head exceed the kernel's "
                         f"{MAX_ROWS} rows per block")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("flash_attention takes tensors whose last dim is contiguous")
    if max(tq, tk, abs(q_offset), window) >= 2 ** 31 or b > 65535 or hkv > 65535:
        raise ValueError(f"shape {tuple(q.shape)} x {tuple(k.shape)} exceeds the "
                         f"kernel's int32 positions or grid")
    out = torch.empty((b, tq, hq, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(x.stride(i) for x in (q, k, v, out)
                                         for i in range(3)))
    qt = max(1, MAX_ROWS // group)
    lib = _lib()
    err = lib.flash_attention_launch(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, hq, hkv, tq, tk, hd, strides, int(causal), int(window), int(q_offset),
        hd ** -0.5, qt, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention_kernel launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
