"""K3: flash attention (GQA, causal, sliding window), a hand-written CUDA
kernel for Hopper.

Replaces the Pallas kernel ``_flash_kernel`` of
``repro/kernels/flash_attention/kernel.py`` (reached through
``flash_attention``).  The kernels are in
``repro_torch/csrc/flash_attention.cu``; its note gives the bounds (prefill
by operations, decode by the K/V bytes up to the query's position) and the
design.  In bf16 (the model's path): group-major rows on tensor-core tiles,
K/V tiles by 16-byte ``cp.async``, P kept at f32 precision through P.V as a
hi/lo pair of bf16, and a key range split over blocks when the grid is too
small to fill the card (:func:`split_plan`).  In f32: exact f32 products on
the SIMT cores, no split.

``bq``/``bk`` keep the reference's contract — sequence lengths they do not
divide raise ``ValueError`` — but do not set the CUDA tiling, which is
fixed by the kernel and :func:`split_plan`.

The gradient: :class:`FlashAttentionFn` is K3 as a
``torch.autograd.Function``.  Its forward is the launch above; in bf16 it
also asks the kernel for each row's log-sum-exp and for o in f32 before
its rounding (:func:`forward_with_stats`; o's bits are the same).  Its
backward is :func:`flash_attention_backward`, three hand-written kernels
in ``repro_torch/csrc/flash_attention_bwd.cu``: in bf16, D = rowsum(dO o
O) from that f32 O, then dQ, then dK and dV on tensor cores (``mma.sync``,
P and dS as bf16 hi + lo pairs); in f32, the SIMT kernels (the log-sum-exp
and D recomputed, then dQ, then dK and dV).  No atomics, so the same bits
on every call.  The model enters the Function only when grad mode is on
and an input requires grad, so serving launches K3 exactly as before.

Each launch on the card is reported to ``roofline.op_cost``'s active
counters (:func:`_report`): its operands read once, its results written
once, and the products' flops of the pairs the mask lets through.

On ``meta`` tensors (``_device.kernel_path``: the dry run, the counted
steps) every entry walks the CUDA path without launching: it allocates
what the launch would (results, statistics, the split's partials and
tickets, the backward's delta) with the same shapes, dtypes and strides,
reports the launch as the card does, and never loads the library.  The
split plan then reads the H100's occupancy from :data:`H100_BLOCKS_PER_SM`
in place of the library's answer.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from ..._device import kernel_path
from ...roofline import op_cost
from .. import _build
from .ref import mha_ref

HEAD_DIMS = (16, 32, 64, 128, 256)     # the compiled head widths (forward and backward)
MAX_ROWS = 32                     # (query head, position) rows of an f32 block
DECODE_ROWS, PREFILL_ROWS = 16, 64     # rows of a bf16 block, by variant
MAX_SPLITS = 64                   # key-range chunks per row tile
# flops per visible (query head, query, key) pair and head dim: forward two
# products (4), backward five (10); the reports and chip_smoke.py's bounds
FWD_FLOPS_PER_PAIR, BWD_FLOPS_PER_PAIR = 4, 10
# the H100's SMs, and the blocks of each bf16 variant (rows, hd) one SM
# holds at once as the compiled library answers
# (``flash_attention_blocks_per_sm``; chip_smoke.py's phase 9 holds this
# table to it): the split plan of a meta call, which loads no library
H100_SMS = 132
H100_BLOCKS_PER_SM = {(16, 16): 4, (16, 32): 4, (16, 64): 4, (16, 128): 3, (16, 256): 1,
                      (64, 16): 4, (64, 32): 3, (64, 64): 3, (64, 128): 2, (64, 256): 2}


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one bf16 call is cut: ``rows`` (query head, position) rows per
    block, ``qt`` query positions per block (``rows // G`` at most), ``bk``
    keys per tile, ``row_tiles`` blocks along the queries, and each row
    tile's visible key range cut into ``splits`` chunks of
    ``tiles_per_chunk`` tiles (one block each)."""
    rows: int
    qt: int
    bk: int
    row_tiles: int
    splits: int
    tiles_per_chunk: int


def key_range(t0: int, t1: int, tk: int, *, causal: bool, window: int,
              q_offset: int) -> tuple[int, int]:
    """[k_begin, k_end): the keys any query position in [t0, t1) can see,
    as the kernel computes them (may be empty)."""
    if not causal:
        return 0, tk
    k_begin = max(0, q_offset + t0 - window + 1) if window > 0 else 0
    return k_begin, min(tk, q_offset + t1)


def visible_pairs(tq: int, tk: int, *, causal: bool, window: int, q_offset: int) -> int:
    """The (query, key) pairs the mask lets through, per query head (in
    numpy, so that a counter open around a launch sees no op of it)."""
    if not causal:
        return tq * tk
    t = np.arange(tq, dtype=np.int64) + q_offset
    hi = np.clip(t + 1, 0, tk)
    lo = np.clip(t - window + 1, 0, tk) if window > 0 else np.zeros_like(t)
    return int(np.clip(hi - lo, 0, None).sum())


def _report(name: str, reads, writes, q, k, *, causal, window, q_offset, per_pair):
    """One launch to ``roofline.op_cost``'s active counters: ``per_pair``
    hd flops for each visible (query head, query, key) triple
    (``FWD_FLOPS_PER_PAIR`` or ``BWD_FLOPS_PER_PAIR``)."""
    if op_cost._ACTIVE:
        b, hq, tq, hd = q.shape
        pairs = visible_pairs(tq, k.shape[2], causal=causal, window=window,
                              q_offset=q_offset)
        op_cost.kernel_launch(name, reads, writes, per_pair * hd * b * hq * pairs)


def _tiles(k_begin: int, k_end: int, bk: int) -> int:
    return -(-(k_end - k_begin) // bk) if k_end > k_begin else 0


def variant(hq: int, hkv: int, tq: int, hd: int) -> tuple[int, int, int]:
    """(rows, qt, bk) of the bf16 kernel's variant for these shapes:
    decode-sized calls (G * Tq <= 16 rows) take 16 rows, 4 warps sharing
    each 64-key tile; the rest 64 rows (qt = 64 // G positions), 64-key
    tiles (32 at hd 256)."""
    group = hq // hkv
    if group * tq <= DECODE_ROWS:
        return DECODE_ROWS, tq, 64
    return PREFILL_ROWS, PREFILL_ROWS // group, 32 if hd > 128 else 64


@functools.lru_cache(maxsize=4096)
def split_plan(batch: int, hq: int, hkv: int, tq: int, tk: int, hd: int, *,
               slots: int, causal: bool = True, window: int = 0,
               q_offset: int = 0) -> Plan:
    """The bf16 kernel's plan, for a card that holds ``slots`` blocks of
    this variant at once (the wrapper passes its SMs times the variant's
    blocks per SM).

    A row tile's key range is cut into S chunks of ``tiles_per_chunk``
    whole tiles, one block each, when the grid leaves room on the card.
    The last block of a row tile then reads every chunk's f32 partial on
    one SM, so the merge grows with S times the rows while the keys a block
    walks shrink with 1 / S: S starts near sqrt(keys / (2 * rows)) and
    falls until all the blocks fit on the card at once (a second wave costs
    more than the split saves).  Short prefills and calls whose grid fills
    the card stay whole.  ``sweep.py`` times every chunk size against this
    choice at qwen2-0.5b's and recurrentgemma-9b's shapes."""
    rows, qt, bk = variant(hq, hkv, tq, hd)
    row_tiles = -(-tq // qt)
    whole = Plan(rows, qt, bk, row_tiles, 1, 1 << 30)
    if row_tiles * hkv * batch >= slots:
        return whole
    ns = [_tiles(*key_range(rt * qt, min(tq, rt * qt + qt), tk, causal=causal,
                            window=window, q_offset=q_offset), bk)
          for rt in range(row_tiles)]
    most = max(ns)
    for want in range(min(most, MAX_SPLITS, math.isqrt(most * bk // (2 * rows))), 1, -1):
        per = -(-most // want)
        if hkv * batch * sum(max(1, -(-n // per)) for n in ns) <= slots:
            return Plan(rows, qt, bk, row_tiles, -(-most // per), per)
    return whole


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    strides = ctypes.POINTER(ctypes.c_longlong)
    lib.flash_attention_launch.argtypes = [
        p, p, p, p, i, i, i, i, i, i, strides, i, i, i, f, i, p]
    lib.flash_attention_launch.restype = i
    lib.flash_attention_bf16_launch.argtypes = [
        p, p, p, p, i, i, i, i, i, i, strides, i, i, i, f, i, i, i, i, i, p, p, p, p, p]
    lib.flash_attention_bf16_launch.restype = i
    lib.flash_attention_smem_bytes.argtypes = [i, i, i]
    lib.flash_attention_smem_bytes.restype = i
    lib.flash_attention_blocks_per_sm.argtypes = [i, i]
    lib.flash_attention_blocks_per_sm.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _slots(index: int, rows: int, hd: int) -> int:
    """Blocks of the bf16 variant (rows, hd) device ``index`` holds at once."""
    with torch.cuda.device(index):
        per_sm = _lib().flash_attention_blocks_per_sm(rows, hd)
    if per_sm <= 0:
        raise RuntimeError(f"flash_attention_kernel ({rows} rows, hd {hd}) fits no SM")
    return per_sm * torch.cuda.get_device_properties(index).multi_processor_count


def _stream(x: torch.Tensor) -> int:
    """The current CUDA stream of ``x``'s device (0 for a meta tensor)."""
    return 0 if x.is_meta else torch.cuda.current_stream(x.device).cuda_stream


# One ticket per row tile of a split call, zero between launches (the
# kernel's last block of each row tile resets its own).  Kept per (device,
# stream) at its largest size and reused: launches on one stream run one
# after another, so no two of them hold a ticket at once.
_TICKETS: dict[tuple[torch.device, int], torch.Tensor] = {}


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    t = _TICKETS.get((device, stream))
    if t is None or t.numel() < n:
        t = _TICKETS[device, stream] = torch.zeros(max(n, 256), dtype=torch.int32,
                                                   device=device)
    return t


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor) or x.dim() != 4:
            raise ValueError(f"flash_attention takes 4-D (B, H, T, hd) tensors; "
                             f"{name} is {getattr(x, 'shape', type(x))}")
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"flash_attention takes float32 or bfloat16, "
                            f"{name} is {x.dtype}")
        if x.device.type not in ("cpu", "cuda", "meta") or x.device != q.device:
            raise ValueError(f"flash_attention runs on one cuda device (cpu for "
                             f"the plain version, meta to count it); {name} is "
                             f"on {x.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    b, hq, _, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k and v must be (B, Hkv, Tk, hd) = ({b}, Hkv, Tk, "
                         f"{hd}); got {tuple(k.shape)} and {tuple(v.shape)}")
    if k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"{hq} query heads do not split over {k.shape[1]} kv heads")


def rows_aligned(x: torch.Tensor) -> bool:
    """Every (b, h, t) row of ``x`` starts on 16 bytes, as the bf16 kernel's
    ``cp.async`` copies need (strides of size-1 dims are never used)."""
    return x.data_ptr() % 16 == 0 and all(
        x.stride(i) * x.element_size() % 16 == 0 for i in range(3) if x.shape[i] > 1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    bq: int = 256, bk: int = 256) -> torch.Tensor:
    """q (B, Hq, Tq, hd); k, v (B, Hkv, Tk, hd) -> (B, Hq, Tq, hd).

    Requires Tq % bq == 0 and Tk % bk == 0, as the reference does.  A CUDA
    tensor launches the kernel, a meta tensor counts it (no launch); a CPU
    tensor takes the plain version (``mha_ref``).  On the card the inputs
    may be any strided views whose last dim is contiguous (the model passes
    transposed (B, T, H, hd)
    projections and cache views); in bf16 every row must also start on 16
    bytes (``ValueError`` otherwise: the kernel copies rows 16 bytes at a
    time and has no slower path).  The result lies in (B, Tq, Hq, hd)
    memory, returned as its (B, Hq, Tq, hd) view, so the model's
    ``transpose(1, 2).reshape(B, Tq, Hq * hd)`` costs no copy.
    """
    _check(q, k, v)
    b, hq, tq, hd = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if tq % bq or tk % bk:
        raise ValueError(f"seq lens ({tq},{tk}) not divisible by blocks ({bq},{bk})")
    if not kernel_path(q):
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
    bf16 = q.dtype == torch.bfloat16
    if bf16 and not all(rows_aligned(x) for x in (q, k, v)):
        raise ValueError("flash_attention in bfloat16 takes rows that start on 16 "
                         "bytes (pointer and b, h, t strides); copy the input first")
    out = torch.empty((b, tq, hq, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    if bf16:
        _run_planned(q, k, v, out, causal=causal, window=window, q_offset=q_offset)
    elif not q.is_meta:
        lib = _lib()
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, tq, tk, hd, _strides(q, k, v, out), int(causal), int(window),
            int(q_offset), hd ** -0.5, max(1, MAX_ROWS // group), _stream(q))
        _build.check(lib, err, "flash_attention_f32_kernel launch")
    if not q.is_meta:
        flash_attention.launches += 1
    _report("K3", (q, k, v), (out,), q, k, causal=causal, window=window,
            q_offset=q_offset, per_pair=FWD_FLOPS_PER_PAIR)
    return out


flash_attention.launches = 0


def _strides(*xs: torch.Tensor):
    return (ctypes.c_longlong * 12)(*(x.stride(i) for x in xs for i in range(3)))


def _run_planned(q, k, v, out, *, causal, window, q_offset, lse=None, o32=None) -> None:
    """The bf16 launch with :func:`split_plan`'s plan (counts nothing)."""
    b, hq, tq, hd = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    rows = variant(hq, hkv, tq, hd)[0]
    slots = H100_SMS * H100_BLOCKS_PER_SM[rows, hd] if q.is_meta else \
        _slots(q.device.index or 0, rows, hd)
    plan = split_plan(b, hq, hkv, tq, tk, hd, slots=slots,
                      causal=bool(causal), window=window, q_offset=q_offset)
    run_bf16(q, k, v, out, plan, causal=causal, window=window, q_offset=q_offset,
             lse=lse, o32=o32)


def forward_with_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: int = 0, q_offset: int = 0):
    """K3's bf16 forward plus what its backward reads: (out, lse, o32), lse
    (B, Hq, Tq) f32 each row's log-sum-exp of its scaled scores (+inf for a
    row that sees no key), o32 the output before its rounding to bf16, in
    f32 (out's layout).  ``out`` has the bits of :func:`flash_attention`'s.
    Counts nothing: :class:`FlashAttentionFn` counts its forward as one K3
    launch, and :func:`flash_attention_backward` calls this when it is not
    handed the statistics."""
    _check(q, k, v)
    if q.dtype != torch.bfloat16 or not kernel_path(q):
        raise TypeError("forward_with_stats takes bfloat16 CUDA (or meta) tensors")
    b, hq, tq, hd = q.shape
    if hd not in HEAD_DIMS or hq // k.shape[1] > MAX_ROWS:
        raise ValueError(f"head dim {hd} or group {hq // k.shape[1]} not compiled")
    if any(x.stride(3) != 1 for x in (q, k, v)) or not all(rows_aligned(x) for x in (q, k, v)):
        raise ValueError("forward_with_stats takes rows that start on 16 bytes with a "
                         "contiguous head dim")
    if max(tq, k.shape[2], abs(q_offset), window) >= 2 ** 31 or b > 65535 or \
            k.shape[1] > 65535:
        raise ValueError(f"shape {tuple(q.shape)} x {tuple(k.shape)} exceeds the "
                         f"kernel's int32 positions or grid")
    out = torch.empty((b, tq, hq, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    o32 = torch.empty((b, tq, hq, hd), dtype=torch.float32, device=q.device).transpose(1, 2)
    lse = torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
    if out.numel():
        _run_planned(q, k, v, out, causal=causal, window=window, q_offset=q_offset,
                     lse=lse, o32=o32)
    return out, lse, o32


def run_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
             plan: Plan, *, causal: bool, window: int, q_offset: int,
             lse: torch.Tensor | None = None, o32: torch.Tensor | None = None) -> None:
    """Launch the bf16 kernel on inputs :func:`flash_attention` has checked,
    cut as ``plan`` says (the wrapper passes :func:`split_plan`'s; the
    chunk-size sweep passes others); ``lse`` and ``o32`` (out's strides)
    receive :func:`forward_with_stats`'s statistics when given.  Counts
    nothing; on meta tensors allocates the split's partials and tickets
    and launches nothing."""
    b, hq, tq, hd = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    stream = _stream(q)
    ws = tickets = None
    if plan.splits > 1:
        tiles = b * hkv * plan.row_tiles
        ws = torch.empty(tiles * plan.splits * plan.rows * (2 + hd),
                         dtype=torch.float32, device=q.device)
        tickets = _tickets(q.device, stream, tiles)
    if q.is_meta:
        return
    lib = _lib()
    err = lib.flash_attention_bf16_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, hq, hkv, tq, tk, hd, _strides(q, k, v, out), int(causal), int(window),
        int(q_offset), hd ** -0.5, plan.rows, plan.bk, plan.qt, plan.splits,
        plan.tiles_per_chunk, None if ws is None else ws.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        None if lse is None else lse.data_ptr(), None if o32 is None else o32.data_ptr(),
        stream)
    _build.check(lib, err, "flash_attention_kernel launch")


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    strides = ctypes.POINTER(ctypes.c_longlong)
    lib.flash_attention_bwd_launch.argtypes = [
        p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, strides, i, i, i, f, i, p]
    lib.flash_attention_bwd_launch.restype = i
    lib.flash_attention_bwd_smem_bytes.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
    lib.flash_attention_bwd_smem_bytes.restype = i
    return lib


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             dout: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             q_offset: int = 0, stats=None
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention(q, k, v, ...)`` for the gradient
    ``dout`` of its result, each in its input's dtype and shape.

    In bf16 the kernels read the forward's (lse, o32) (``stats``, as
    :func:`forward_with_stats` returns them after the output); without
    them this call runs K3's forward once more to make them.  In f32 they
    recompute what they need (each row's log-sum-exp and rowsum(P o dP))
    and ``stats`` is ignored.  A CUDA tensor launches the backward kernels
    (head dims ``HEAD_DIMS``, ``ValueError`` otherwise), a meta tensor
    counts them; a CPU tensor takes the plain version, autograd through
    ``mha_ref``."""
    _check(q, k, v)
    b, hq, tq, hd = q.shape
    if dout.shape != q.shape:
        raise ValueError(f"dout must be q's shape {tuple(q.shape)}; got "
                         f"{tuple(dout.shape)}")
    if not kernel_path(q):
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
            o = mha_ref(*leaves, causal=causal, window=window, q_offset=q_offset)
            return torch.autograd.grad(o, leaves, dout)
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: K3's backward is compiled for {HEAD_DIMS}")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("flash_attention_backward takes tensors whose last dim "
                         "is contiguous")
    if max(k.shape[2], tq, abs(q_offset), window) >= 2 ** 31 or b > 65535 or hq > 65535:
        raise ValueError(f"shape {tuple(q.shape)} x {tuple(k.shape)} exceeds the "
                         f"kernels' int32 positions or grid")
    bf16 = q.dtype == torch.bfloat16
    dout = dout.to(q.dtype)
    if dout.stride(3) != 1 or (bf16 and not rows_aligned(dout)):
        dout = dout.contiguous()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
    if bf16:
        if stats is None:
            stats = forward_with_stats(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset)
            _report("K3", (q, k, v), stats, q, k, causal=causal, window=window,
                    q_offset=q_offset, per_pair=FWD_FLOPS_PER_PAIR)
            stats = stats[1:]
        lse, o32 = stats
    else:
        lse, o32 = torch.empty_like(delta), None
    if not q.is_meta:
        hkv, tk = k.shape[1], k.shape[2]
        xs = (q, k, v, dout, dq, dk, dv)
        strides = (ctypes.c_longlong * 24)(
            *(x.stride(i) for x in xs for i in range(3)),
            *((o32.stride(i) for i in range(3)) if o32 is not None else (0, 0, 0)))
        lib = _bwd_lib()
        err = lib.flash_attention_bwd_launch(
            *(x.data_ptr() for x in xs), lse.data_ptr(), delta.data_ptr(),
            None if o32 is None else o32.data_ptr(),
            b, hq, hkv, tq, tk, hd, strides, int(causal), int(window), int(q_offset),
            hd ** -0.5, int(bf16), _stream(q))
        _build.check(lib, err, "flash_attention backward launch")
        flash_attention_backward.launches += 1
    _report("K3 backward", (q, k, v, dout, lse, o32), (dq, dk, dv, delta), q, k,
            causal=causal, window=window, q_offset=q_offset, per_pair=BWD_FLOPS_PER_PAIR)
    return dq, dk, dv


flash_attention_backward.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """K3 with its gradient: ``FlashAttentionFn.apply(q, k, v, causal,
    window, q_offset)`` is one counted K3 launch forward (in bf16 with the
    statistics the backward reads) and ``flash_attention_backward`` (one
    call, three kernels) backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_offset: int):
        if q.dtype == torch.bfloat16 and kernel_path(q):
            out, lse, o32 = forward_with_stats(q, k, v, causal=causal, window=window,
                                               q_offset=q_offset)
            if not q.is_meta:
                flash_attention.launches += 1
            _report("K3", (q, k, v), (out, lse, o32), q, k, causal=causal,
                    window=window, q_offset=q_offset, per_pair=FWD_FLOPS_PER_PAIR)
            ctx.save_for_backward(q, k, v, lse, o32)
        else:
            out = flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset, bq=q.shape[2], bk=k.shape[2])
            ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, *stats = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        dq, dk, dv = flash_attention_backward(q, k, v, dout, causal=causal,
                                              window=window, q_offset=q_offset,
                                              stats=stats or None)
        return dq, dk, dv, None, None, None
