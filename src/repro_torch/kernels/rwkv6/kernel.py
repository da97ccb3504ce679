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
state into it in place (the model updates its cache so).  ``chunk`` keeps
the reference's contract, T divisible by it or ``ValueError``, but sets
nothing on the card: the kernel takes any T, and callers with ragged T
pass ``chunk=T``.

The gradient: when grad mode is on and an input requires grad, the
wrapper runs as :class:`WKV6Fn`.  Its forward is the launch above,
counted as before, except that a given ``s0`` is left alone and the final
state is a new tensor (autograd needs both; ROADMAP P8 holds for calls
without a gradient, so serving still updates its cache in place).  Its
backward is :func:`wkv6_backward`, ``repro_torch/csrc/wkv6_bwd.cu``: the
forward's time-chunked scan run in reverse.  Time is cut into chunks of
``BWD_CHUNK`` steps; each chunk's carried-in state S_c and end gradient
G^end_c are found by products alone (a local walk of every chunk from
zero, then a carry over the chunks each way), and every chunk is then
walked on its own in parallel: its states recomputed forward from S_c in
sub-chunks (never by dividing by w, which reaches 1e-30 and below), its
gradient walked back from G^end_c.  Sums over a row's columns are kept in
f32 and added in a fixed order, with no float atomics, so a repeat gives
the same bits.  A call of at most ``BWD_CHUNK`` steps is two launches, a
longer one four.  ``ref.wkv6_bwd_chunked_ref`` is the same algebra in
plain PyTorch.

Every launch of either is reported to ``roofline.op_cost``'s active
counters (:func:`_report`): the tensors it reads and writes, each once
(the scratch and the workspace not), and ``FWD_FLOPS`` or ``BWD_FLOPS``
per (b, t, h, i, j), the counts behind ``chip_smoke.py``'s bounds.  One
call is one report, however many kernels it launches.

On ``meta`` tensors (``_device.kernel_path``: the dry run, the counted
steps) both walk the CUDA path without launching: they allocate what the
launch would (results, the forward's chunk scratch, the backward's
workspace, :func:`bwd_workspace_floats` floats) with the same shapes,
dtypes and strides, report the call as the card does, and never load the
library.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..._device import kernel_path
from ...roofline import op_cost
from .. import _build
from .ref import wkv6_bwd_ref, wkv6_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (8, 16, 32, 64)     # the kernel's compiled head widths
# steps per time chunk: the fastest of 32, 64 and 128 at rwkv6-3b's prefill
# 128 and 1024 on an H100 (``python -m repro_torch.kernels.rwkv6.sweep``)
TIME_CHUNK = 128
# steps per time chunk of the backward: the fastest of 32, 64 and 128 at
# rwkv6-3b's training length 1024 on an H100 (the same sweep)
BWD_CHUNK = 64
BWD_CHUNKS = (32, 64, 128)      # the backward's compiled chunk lengths
# f32 operations per (b, t, h, i, j) (the notes of csrc/wkv6.cu and
# wkv6_bwd.cu): forward a multiply-add for o, a multiply and a multiply-add
# for S; backward the state's recompute (3), G's update (3) and a
# multiply-add each for dr, dk, dw and dv (8)
FWD_FLOPS, BWD_FLOPS = 5, 14


def _report(name: str, reads, writes, r: torch.Tensor, per: int) -> None:
    """One launch to ``roofline.op_cost``'s active counters: ``reads`` and
    ``writes`` (None skipped) once each, ``per`` flops for each (b, t, h,
    i, j) of ``r``'s shape.  Nothing when no counter is open."""
    if op_cost._ACTIVE:
        b, t, h, hd = r.shape
        op_cost.kernel_launch(name, [x for x in reads if x is not None],
                              [x for x in writes if x is not None], per * b * t * h * hd * hd)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("wkv6")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_launch.argtypes = [i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.wkv6_launch.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("wkv6_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_bwd_launch.argtypes = [i, p, p, p, p, p, p, p, p, p, p, p, p, p, p, p,
                                    i, i, i, i, i, p]
    lib.wkv6_bwd_launch.restype = i
    lib.wkv6_bwd_workspace_floats.argtypes = [i, i, i, i, i]
    lib.wkv6_bwd_workspace_floats.restype = ctypes.c_longlong
    lib.wkv6_bwd_sub_steps.restype = i
    lib.wkv6_bwd_blocks_per_sm.argtypes = [i]
    lib.wkv6_bwd_blocks_per_sm.restype = i
    return lib


def bwd_workspace_floats(b: int, t: int, h: int, hd: int, chunk: int) -> int:
    """The backward's workspace in floats, ``wkv6_bwd_workspace_floats`` of
    ``csrc/wkv6_bwd.cu`` in Python (chip_smoke.py's phase 9 holds the two
    equal): with more than one chunk each chunk's carried state and end
    gradient and its delta, then dv's per-tile partials and du's per-chunk
    partials."""
    nc, bh = -(-t // chunk), b * h
    tiles = hd // 32 if hd > 32 else 1
    return (bh * nc * hd * (2 * hd + 1) if nc > 1 else 0) + tiles * b * t * h * hd + \
        b * nc * h * hd


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
            r.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError("wkv6 runs on one cuda device (cpu for the plain "
                         "version, meta to count it)")


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, chunk: int = 64,
              s0: torch.Tensor | None = None):
    """r, k, v, w: (B, T, H, hd); u: (H, hd); s0: (B, H, hd, hd).

    Returns (o (B, T, H, hd) f32, sT (B, H, hd, hd) f32); ``sT`` is ``s0``
    itself, updated in place, when one is given and no gradient is asked.
    Requires T % chunk == 0, as the reference does.  A CUDA tensor launches
    the kernel, a meta tensor counts it (no launch); a CPU tensor takes the
    plain version (``wkv6_ref``).  On
    the card r, k, v are f32 or bf16 and w, u, s0 f32, all contiguous, and
    r, k, v, w start on 16 bytes.  In grad mode, with an input that
    requires grad, the call runs as :class:`WKV6Fn` (``sT`` a new tensor).
    """
    _check(r, k, v, w, u, s0)
    b, t, h, hd = r.shape
    if t % chunk:
        raise ValueError(f"T={t} not divisible by chunk={chunk}")
    if not kernel_path(r):
        o, st = wkv6_ref(r, k, v, w, u, s0=s0)
        return o, (st if s0 is None else s0.copy_(st))
    _check_card(r, k, v, w, u, s0)
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad
                                       for x in (r, k, v, w, u, s0)):
        return WKV6Fn.apply(r, k, v, w, u, s0)
    o, st = run(r, k, v, w, u, s0, TIME_CHUNK)
    if not r.is_meta:
        wkv6_cuda.launches += 1
    return o, st


def _check_card(r, k, v, w, u, s0) -> None:
    b, t, h, hd = r.shape
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


wkv6_cuda.launches = 0


def run(r, k, v, w, u, s0, chunk: int, st: torch.Tensor | None = None):
    """Launch K4 on checked CUDA tensors with time chunks of ``chunk`` steps:
    (o, sT), the final state written into ``st`` (default: ``s0``, else a
    new tensor).  ``wkv6_cuda`` calls it with ``TIME_CHUNK``; the sweep
    with other chunk sizes.  On meta tensors nothing is launched."""
    b, t, h, hd = r.shape
    o = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    if st is None:
        st = s0 if s0 is not None else \
            torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device)
    scratch = None if t <= chunk else torch.empty(
        b * h * (-(-t // chunk) * (hd * hd + hd) + t * hd), dtype=torch.float32,
        device=r.device)
    if not r.is_meta:
        lib = _lib()
        err = lib.wkv6_launch(
            _DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(), o.data_ptr(),
            st.data_ptr(), None if scratch is None else scratch.data_ptr(), b, t, h, hd,
            chunk, torch.cuda.current_stream(r.device).cuda_stream)
        _build.check(lib, err, "wkv6 kernel launch")
    _report("K4", (r, k, v, w, u, s0), (o, st), r, FWD_FLOPS)
    return o, st


def wkv6_backward(r, k, v, w, u, s0, do, dsT=None):
    """(dr, dk, dv, dw, du, ds0) of ``wkv6_cuda(r, k, v, w, u, s0=s0)`` for
    the gradients ``do`` of o and ``dsT`` of the final state (None: zero):
    each in its input's dtype, ds0 (B, H, hd, hd) f32 (the gradient of the
    zero state when ``s0`` is None).  A CUDA tensor launches K4's backward
    with chunks of ``BWD_CHUNK`` steps, a meta tensor counts it; a CPU
    tensor takes the plain version, ``wkv6_bwd_ref``."""
    _check(r, k, v, w, u, s0)
    b, t, h, hd = r.shape
    for name, x, shape in (("do", do, r.shape), ("dsT", dsT, (b, h, hd, hd))):
        if x is not None and tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} is {tuple(x.shape)}, want {tuple(shape)}")
    if not kernel_path(r):
        return wkv6_bwd_ref(r, k, v, w, u, s0, do, dsT)
    _check_card(r, k, v, w, u, s0)
    grads = run_backward(r, k, v, w, u, s0, do, dsT, BWD_CHUNK)
    if not r.is_meta:
        wkv6_backward.launches += 1
    return grads


def run_backward(r, k, v, w, u, s0, do, dsT, chunk: int):
    """Launch K4's backward on checked CUDA tensors with time chunks of
    ``chunk`` steps (one of ``BWD_CHUNKS``): what ``wkv6_backward``
    returns.  ``wkv6_backward`` calls it with ``BWD_CHUNK``; the sweep with
    the other chunk lengths."""
    if chunk not in BWD_CHUNKS:
        raise ValueError(f"backward chunk {chunk} not compiled; the kernel takes {BWD_CHUNKS}")
    b, t, h, hd = r.shape
    do = do.float().contiguous()
    if do.data_ptr() % 16:          # the kernel copies do 16 bytes at a time
        do = do.clone()
    dsT = None if dsT is None else dsT.float().contiguous()
    dr, dk, dv = (torch.empty(r.shape, dtype=x.dtype, device=r.device) for x in (r, k, v))
    dw = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    du = torch.empty((h, hd), dtype=torch.float32, device=r.device)
    ds0 = torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device)
    lib = None if r.is_meta else _bwd_lib()
    floats = bwd_workspace_floats(b, t, h, hd, chunk) if lib is None else \
        lib.wkv6_bwd_workspace_floats(b, t, h, hd, chunk)
    ws = torch.empty(floats, dtype=torch.float32, device=r.device)
    if lib is not None:
        err = lib.wkv6_bwd_launch(
            _DTYPES[r.dtype], *(x.data_ptr() for x in (r, k, v, w, u)),
            None if s0 is None else s0.data_ptr(), do.data_ptr(),
            None if dsT is None else dsT.data_ptr(),
            *(x.data_ptr() for x in (dr, dk, dv, dw, du, ds0, ws)), b, t, h, hd, chunk,
            torch.cuda.current_stream(r.device).cuda_stream)
        _build.check(lib, err, "wkv6 backward launch")
    _report("K4 backward", (r, k, v, w, u, s0, do, dsT), (dr, dk, dv, dw, du, ds0), r,
            BWD_FLOPS)
    return dr, dk, dv, dw, du.to(u.dtype), ds0


def bwd_geometry() -> dict:
    """The backward's time chunk, the sub-chunk of steps whose states a
    thread holds in registers, and how many blocks of the walk kernel fit
    one SM at hd 64 in bf16 for each compiled chunk (on the card; builds
    the library on first use)."""
    lib = _bwd_lib()
    return {"chunk": BWD_CHUNK, "sub_steps": lib.wkv6_bwd_sub_steps(),
            "blocks_per_sm": {c: lib.wkv6_bwd_blocks_per_sm(c) for c in BWD_CHUNKS}}


wkv6_backward.launches = 0


class WKV6Fn(torch.autograd.Function):
    """K4 with its gradient: ``WKV6Fn.apply(r, k, v, w, u, s0)`` is one
    counted K4 call forward, from ``s0`` (None: zero) into a new final
    state, and one ``wkv6_backward`` call backward."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        b, t, h, hd = r.shape
        st = torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device)
        o, st = run(r, k, v, w, u, s0, TIME_CHUNK, st=st)
        if not r.is_meta:
            wkv6_cuda.launches += 1
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.set_materialize_grads(False)
        return o, st

    @staticmethod
    def backward(ctx, do, dsT):
        r, k, v, w, u, s0 = ctx.saved_tensors
        if do is None:
            do = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        dr, dk, dv, dw, du, ds0 = wkv6_backward(r, k, v, w, u, s0, do, dsT)
        return dr, dk, dv, dw, du, (None if s0 is None else ds0)
