"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout, on a host with one CUDA card and the CUDA
toolkit (``nvcc``).  TF32 is off for matmuls and cuDNN throughout, so every
f32 product on the card is a full f32 product.  Phases, each fatal on
failure:

1. build every kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once) and print the build time, ``nvcc``'s register,
   shared-memory and spill report, and the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card:
   K1 and K2 at the shapes of the JAX package's kernel tests, at c = 0.25,
   and at the paper's 2400x600x600 f32 lattice (limits: 1e-6 for one
   sweep, 1e-5 for two); K3 (flash attention) against ``mha_ref`` at the
   shapes of ``tests/test_kernels.py`` (MQA, bidirectional, windowed,
   Tk > Tq offset) in f32 and its bf16 case, and at qwen2-0.5b's shapes in
   bf16, as the strided views the model passes: prefill 14 over 2 heads
   at T = 128 and 1024 and at each of the serving drain's 12 prompt
   lengths (ragged in the 64-key tile and the 9-position query block), and
   decode of one query against a 2048-slot cache at q_offset 0, 517, 2047
   and each prompt length.  Limits, per element against ``mha_ref``'s
   value ``r``: 3e-5 in f32, 3e-5 + 2^-7 |r| in bf16.  K4 (the WKV6
   recurrence) against ``wkv6_ref``, output and final state, at the shapes
   of ``tests/test_kernels.py`` in f32 (with the state carried across two
   calls) and at rwkv6-3b's 40 heads of 64 with bf16 r, k, v: prefill
   128 and 1024 and each of the rwkv6-3b drain's 12 prompt lengths, and
   decode (T = 1) from a carried state.  Limit, per element: 1e-5 of the
   shape's largest |ref| (both sum the same f32 products in other orders).
   K5 (the RG-LRU scan) against ``rglru_scan_ref`` bit for bit (limit: 0
   unequal elements; each step is one rounded multiply and one rounded
   add in both), at the shapes of ``tests/test_kernels.py``, at
   recurrentgemma-9b's width 4096 at prefill 128 and 1024 and at each of
   its drain's 12 prompt lengths, and at decode (T = 1) from a carried
   state.  K3 at recurrentgemma-9b's shapes in bf16, 16 query heads over
   one kv head of 256, as the model's strided views: prefill with window
   2048 at 128, 1024 and the drain's lengths, decode over a 2048-slot ring
   at positions 0, 517 and 2047, and over a wrapped ring at 2100 and 4095
   (``window=0``, ``q_offset=pos``) against ``decode_attention(ring=True)``
   on the same values in f32, rounded once to bf16; K3's bf16 design at
   both head shapes: decode on either side of a split boundary and with a
   window, prefill one past the row and key tiles, a split prefill in
   which some rows see none of a chunk's keys; the bf16 limit above.  Then
   the same K3 call, repeated, must give the same bits (decode 2047 and
   prefill 1024, both split);
3. the Jacobi main path, ``run_runtime_sweep`` on the full lattice
   (di = 10, 4 domains x 2 workers = 240 slab tasks), against the plain
   sweep, with the launch counts zeroed before and read after; then
   ``jacobi_iterate`` (K2 for pairs of sweeps, K1 for the odd one) the same
   way;
4. the serving path on full-width qwen2-0.5b in bf16: ``ServingEngine``
   (random weights from ``torch.Generator`` seed 0), 12 requests of
   128-1024 prompt tokens and 32 new tokens each (numpy seed 0, about 2/3
   with a home replica), 3 replicas, ``max_seq`` 2048, under the
   ``locality``, ``round_robin`` and ``single_queue`` policies.  Each drain
   runs with the launch counts zeroed just before it and read just after:
   K3 must launch 12 x 24 layers x (1 prefill + 32 decode steps) = 9504
   times and no other kernel, the tokens must be identical across
   policies, and each policy's ``ServeStats``, wall time, tokens per
   second, prefill ms per request and decode ms per token are printed; one
   more drain under ``torch.profiler`` gives the card's idle share, its
   top device functions and each of the path's kernels' device time per
   call in the drain.  Then the kernel path against the plain path: one
   request, teacher-forced with the tokens the plain path
   (``use_kernel=False``) chose, through both; the prefill's and every
   decode step's logits must agree within the bf16 limit printed beside
   them;
5. the same drains on full-width rwkv6-3b in bf16 (32 layers, d 2560, 40
   heads of 64, 3.09 B parameters), with token ids under its 65536 vocab:
   K4 must launch 12 x 32 x 33 = 12672 times per drain and the plain WKV
   version never; K4 is also held against ``wkv6_ref`` on a decode step
   from the state a real prefill left in the cache (first and last layer).
   Its teacher-forced comparison runs on an f32 build of the same model
   (12.4 GB), whose logits carry no bf16 rounding of the residual stream;
   two planted faults in the plain path (u dropped, the state not carried
   across decode steps) must each exceed the limit;
5b. the same drains on full-width recurrentgemma-9b in bf16 (38 layers:
   26 rglru and 12 local attention with a 2048-token window, d 4096, 16
   q / 1 kv heads of 256, 8.58 B parameters): K5 must launch
   12 x 26 x 33 = 10296 times and K3 12 x 12 x 33 = 4752 times per drain,
   and the plain RG-LRU scan never; K5 is also held against
   ``rglru_scan_ref`` on a decode step from the state a real prefill left
   in the cache (first and last rglru layer).  Its teacher-forced
   comparison runs on an f32 build (34.3 GB, after every earlier model is
   freed; the peak device memory is printed), with two planted faults in
   the plain path (the RG-LRU state not carried across decode steps; the
   conv history not carried) that must each exceed the limit;
6. time each kernel, its plain version and the library's yardstick with
   CUDA events, beside its bound: K1 and K2 at the full lattice (yardstick
   ``conv3d`` with the six-point cross) and the runtime sweep; K3 at the
   serving path's prefill and decode shapes (yardstick
   ``scaled_dot_product_attention``, which the port never calls); K4 at
   rwkv6-3b's prefill 1024 and 128 and decode (no PyTorch call computes
   the WKV recurrence, so it has no yardstick); K5 at recurrentgemma-9b's
   prefill 1024 and 128 and decode (no yardstick either); K3 at
   recurrentgemma-9b's hd-256 prefill and decode shapes beside SDPA;
7. print the ``serving`` and ``kernels`` JSON lines, the card's name and
   power limit, and last the ``{"ok": true, ...}`` line.

Exits non-zero, with no result line, when there is no CUDA device or when
the port's sources are not beside this script.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores
LATTICE = (2400, 600, 600)    # the paper's lattice (repro/core/tasks.py PAPER_GRID)
SWEEP_CASES = [((20, 20, 60), (10, 10)), ((8, 16, 128), (4, 8)),
               ((10, 10, 600), (10, 10)), ((30, 20, 32), (10, 5)),
               ((4, 4, 16), (2, 2))]
TWO_STEP_CASES = [((20, 20, 32), (5, 5)), ((12, 8, 16), (4, 4)),
                  ((10, 10, 600), (10, 10)), ((8, 8, 8), (2, 2))]
K1_ATOL, K2_ATOL = 1e-6, 1e-5
# tests/test_kernels.py's flash cases: b, hq, hkv, tq, tk, hd, causal, window
FLASH_CASES = [(2, 4, 2, 128, 128, 32, True, 0), (1, 8, 1, 256, 256, 64, True, 0),
               (2, 4, 4, 128, 128, 16, False, 0), (1, 4, 2, 256, 256, 32, True, 96),
               (1, 2, 2, 64, 192, 32, True, 0)]
# K3 against mha_ref, per element |got - r| <= atol + rtol * |r|.  f32: the
# online softmax reassociates the sums.  bf16: both compute in f32 from the
# same bf16 values and round the result to bf16 once, so they may land one
# bf16 ulp apart (at most 2^-7 |r|) on top of the f32 difference.  Relative
# to each value, the limit stays below the small outputs of late rows over
# long key ranges, where a lost key tile would show.
K3_F32_TOL = dict(atol=3e-5, rtol=0.0)
K3_BF16_TOL = dict(atol=3e-5, rtol=2.0 ** -7)
# tests/test_kernels.py's WKV6 cases: b, t, h, hd
WKV_CASES = [(2, 64, 2, 16), (1, 128, 4, 32), (2, 32, 1, 8)]
# K4 against wkv6_ref, per element |got - r| <= K4_REL * max |r| over the
# shape: both compute in f32 from the same (bf16-rounded) r, k, v, and sum
# the same products in other orders, so they differ by a few f32 ulps of
# the largest terms; 1e-5 of the largest value is far below the typical
# one (the median |r| is printed beside it), where a lost step or column
# would show
K4_REL = 1e-5
# the serving workloads: 12 requests of 128-1024 prompt tokens, 32 new tokens
N_REQUESTS, REPLICAS, MAX_NEW, MAX_SEQ = 12, 3, 32, 2048
PROMPT_LEN = (128, 1024)
POLICIES = ("locality", "round_robin", "single_queue")
QWEN, RWKV, GRIFFIN = "qwen2-0.5b", "rwkv6-3b", "recurrentgemma-9b"
# K3 at qwen2-0.5b's shapes: (name, Tq, Tk, q_offset)
K3_SHAPES = [("prefill_128", 128, 128, 0), ("prefill_1024", 1024, 1024, 0),
             ("decode_0", 1, 2048, 0), ("decode_517", 1, 2048, 517),
             ("decode_2047", 1, 2048, 2047)]
K3_HEADLINE = "decode_517"    # 97 % of the path's launches are decode steps
# K4 at rwkv6-3b's shapes (name, T), each from a carried state written in
# place, as the model calls it
K4_SHAPES = [("prefill_128", 128), ("prefill_1024", 1024), ("decode", 1)]
K4_HEADLINE = "decode"        # 97 % of the path's launches are decode steps
# tests/test_kernels.py's RG-LRU cases: b, t, w, chunk
RGLRU_CASES = [(2, 128, 64, 32), (1, 256, 128, 128), (3, 64, 32, 64)]
# K5 at recurrentgemma-9b's width (name, T), each from a carried state as the
# model calls it (a prefill's state is its zero cache)
K5_SHAPES = [("prefill_128", 128), ("prefill_1024", 1024), ("decode", 1)]
K5_HEADLINE = "decode"        # 97 % of the path's launches are decode steps
# K3 at recurrentgemma-9b's shapes: (name, Tq, Tk, q_offset, window).  Prefill
# passes the local layers' window; decode reads the 2048-slot ring with no
# window (its slots are not in position order); the drain never wraps the
# ring (1024 + 32 < 2048), so the wrapped positions are checked apart
K3_GRIFFIN_SHAPES = [("prefill_128", 128, 128, 0, 2048),
                     ("prefill_1024", 1024, 1024, 0, 2048),
                     ("decode_0", 1, 2048, 0, 0), ("decode_517", 1, 2048, 517, 0),
                     ("decode_2047", 1, 2048, 2047, 0)]
K3_RING_WRAPPED = (2100, 4095)
# K3's bf16 design: decode (q_offset, window) on either side of a split
# boundary (64-key tiles: 63 fills one tile, 64 starts the second) and a
# windowed decode whose range starts mid-tile; prefill one past the row tile
# and the key tile (577 = 9 * 64 + 1 at qwen2's 9 positions per block, 129 =
# 4 * 32 + 1 at hd 256); a split prefill in which some rows see none of a
# chunk's keys (qwen2 T 513: two chunks, the second from key 320; the row
# tile of positions 315-323 sees keys 320-323 only from it)
K3_SPLIT_DECODE = [(63, 0), (64, 0), (127, 0), (128, 0), (1023, 0), (1024, 0),
                   (2047, 100)]
K3_ONE_PAST = {QWEN: (577, 0), GRIFFIN: (129, 2048)}
K3_MISSED_CHUNK = 513
# kernel path vs plain path, teacher-forced.  qwen2-0.5b, bf16 logits: logits
# of magnitude ~3 have an ulp of 2^-6; attention rounded at other points
# (f32 softmax in K3, bf16 scores and weights in the plain path) moves them
# by a few ulps after 24 layers.  rwkv6-3b, on an f32 build (the bf16 build
# rounds its residual stream and gave gaps of 0.43 at |logits| 5): the two
# paths differ only in the order of K4's f32 sums, and the gap measured on
# the H100 was 0.0458 at |logits| 4.9, against 1.96 with u dropped and 7.50
# with the state not carried across decode steps.  The limit sits 2.7x above
# the sound reading and 15x below the nearer fault; both faults run in every
# call and must exceed it.  recurrentgemma-9b, on an f32 build: K5 equals
# the plain scan bit for bit, so the paths differ only in K3's f32 sums
# (12 local layers).  Measured on the H100: 2.5e-5 at |logits| 26, against
# 5.25 with the RG-LRU state not carried across decode steps and 4.96 with
# the conv history not carried.  The limit sits 40x above the sound reading
# and 5000x below the nearer fault; both faults run in every call
LOGITS_ATOL = {QWEN: 0.25, RWKV: 0.125, GRIFFIN: 1e-3}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def free_device_memory() -> None:
    """Return freed tensors to the card.  A serving engine and its executor
    form a reference cycle (the executor's handler is a bound method of the
    engine) that keeps the model's parameters alive until the cycle
    collector runs, so collect first."""
    gc.collect()
    torch.cuda.empty_cache()


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def max_err(a, b) -> float:
    if a.shape != b.shape:
        fail(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if not bool(a.isfinite().all()):
        fail("non-finite values in a kernel's output")
    return float((a.float() - b.float()).abs().max())


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call.  Each timed call is queued behind a 2 ms
    device sleep, so the events measure the device alone even where the
    kernel is far below launch latency (back-to-back calls would time the
    host)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel: registers, shared memory, spills."""
    out, name = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spills = line.split(",", 1)[1].strip()
        elif "Used" in line and "registers" in line:
            out.append(f"  {name}: {line.split(':', 1)[1].strip()}; {spills}")
    return out


def bound(nbytes: float, flops: float, flops_per_s: float):
    """(least ms, what bounds it): the bytes over HBM or the flops over the
    given peak, whichever takes longer."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / flops_per_s * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def k3_bound(b, hq, hkv, tq, tk, hd, q_offset, elem_bytes=2):
    """Least time for one K3 call on these inputs: the larger of the bytes
    it must move (q, k, v rows it reads once, o written once: the visible
    keys only) over HBM, and its flops (4*hd per visible (head, query, key)
    pair) over the bf16 tensor-core peak."""
    pairs = sum(min(tk, q_offset + t + 1) for t in range(tq))
    visible = min(tk, q_offset + tq)
    nbytes = elem_bytes * hd * (2 * b * hq * tq + 2 * b * hkv * visible)
    return bound(nbytes, 4 * b * hq * hd * pairs, BF16_FLOPS_PER_S)


def k4_bound(b, t, h, hd, elem_bytes=2, state_in=True):
    """Least time for one K4 call: the larger of the bytes it must move (r,
    k, v in their dtype, w and u in f32 read once, o and the final state in
    f32 written once, the carried state read once) over HBM, and its f32
    flops (5 per (b, t, h, i, j): a multiply-add for o, a multiply and a
    multiply-add for S) over the f32 peak."""
    n = b * t * h * hd
    nbytes = 3 * elem_bytes * n + 4 * n + 4 * n + 4 * h * hd \
        + 4 * b * h * hd * hd * (2 if state_in else 1)
    return bound(nbytes, 5 * n * hd, F32_FLOPS_PER_S)


class Timed:
    """Wraps a replica's prefill or decode step: synchronised host time of
    each call, in ms (the engine syncs on every token anyway)."""

    def __init__(self, fn):
        self.fn, self.ms = fn, []

    def __call__(self, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


def leaves(tree) -> list:
    """The tensors of a nested dict/list of parameters."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for sub in items for leaf in leaves(sub)]


def device_spans(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of every kernel, copy and set the profiler
    saw on the card.  Read from the raw records: building the profiler's
    event tree for a whole drain's half a million records takes minutes."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


def busy_ms(spans) -> float:
    """Union of the spans' device intervals, in ms."""
    total, cur_s, cur_e = 0, None, None
    for _, s, e in sorted(spans, key=lambda x: x[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def top_kernels(spans, n: int = 8) -> list[str]:
    """The ``n`` device functions with the most total time."""
    by_name: dict[str, list[float]] = {}
    for name, s, e in spans:
        by_name.setdefault(name, []).append((e - s) / 1e6)
    rows = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:n]
    return [f"  {sum(t):10.3f} ms {len(t):7d} calls {sum(t) / len(t) * 1e3:8.3f} us  "
            f"{name[:90]}" for name, t in rows]


def requests(cfg, request_cls) -> list:
    """The serving workload (numpy seed 0), with token ids under the
    config's vocabulary."""
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(N_REQUESTS):
        plen = int(rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1))
        toks = rng.integers(0, cfg.vocab_size, size=plen)
        home = int(rng.integers(0, REPLICAS)) if rng.random() < 0.67 else -1
        reqs.append(request_cls(uid=i, tokens=toks, max_new=MAX_NEW, home_replica=home))
    return reqs


T_START = time.perf_counter()


def stamp(phase) -> None:
    print(f"[{time.perf_counter() - T_START:.1f} s] phase {phase}", flush=True)


def main() -> None:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"the port's sources (src/repro_torch) are not beside {__file__}")
    sys.path.insert(0, str(ROOT / "src"))
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as k3_kernel
    from repro_torch.kernels.flash_attention.kernel import flash_attention, split_plan
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.kernels.jacobi import ops, ref
    from repro_torch.kernels.jacobi.kernel import jacobi_sweep_cuda
    from repro_torch.kernels.jacobi.temporal import jacobi_two_step_cuda
    from repro_torch.kernels.rglru import kernel as rglru_kernel
    from repro_torch.kernels.rglru import ops as rglru_ops
    from repro_torch.kernels.rglru.kernel import rglru_scan_cuda
    from repro_torch.kernels.rglru.ref import rglru_scan_ref
    from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6.kernel import wkv6_cuda
    from repro_torch.kernels.rwkv6.ref import wkv6_ref
    from repro_torch.models import rglru as rglru_model
    from repro_torch.models.attention import decode_attention
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Replica, Request, ServingEngine
    from repro_torch.stencil.jacobi import run_runtime_sweep

    dev = torch.device("cuda")
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    # the plain WKV version, counted where the port reaches it (the wrapper's
    # CPU branch and ops' use_kernel=False branch); this script's own
    # comparisons call wkv6_ref directly and are not counted
    plain_wkv = {"calls": 0}

    def counted_ref(*args, **kw):
        plain_wkv["calls"] += 1
        return wkv6_ref(*args, **kw)

    wkv_kernel.wkv6_ref = wkv_ops.wkv6_ref = counted_ref
    # the plain RG-LRU scan likewise
    plain_rglru = {"calls": 0}

    def counted_rglru_ref(*args, **kw):
        plain_rglru["calls"] += 1
        return rglru_scan_ref(*args, **kw)

    rglru_kernel.rglru_scan_ref = rglru_ops.rglru_scan_ref = counted_rglru_ref

    def zero_counts():
        jacobi_sweep_cuda.launches = jacobi_two_step_cuda.launches = 0
        flash_attention.launches = wkv6_cuda.launches = plain_wkv["calls"] = 0
        rglru_scan_cuda.launches = plain_rglru["calls"] = 0

    def counts():
        return {"jacobi_sweep": jacobi_sweep_cuda.launches,
                "jacobi_two_step": jacobi_two_step_cuda.launches,
                "flash_attention": flash_attention.launches,
                "wkv6": wkv6_cuda.launches, "wkv6_plain_calls": plain_wkv["calls"],
                "rglru": rglru_scan_cuda.launches,
                "rglru_plain_calls": plain_rglru["calls"]}

    def path_launches(cfg, n_requests):
        """The launches of each kernel that serving ``n_requests`` requests
        of ``cfg`` must make: one per layer of its kind per prefill and per
        decode step."""
        kernel_of = {"full": "flash_attention", "local": "flash_attention",
                     "rwkv": "wkv6", "rglru": "rglru"}
        want: dict[str, int] = {}
        for kind in cfg.layer_kinds():
            name = kernel_of[kind]
            want[name] = want.get(name, 0) + n_requests * (1 + MAX_NEW)
        return want

    def path_ok(launched, want):
        """Every kernel launched exactly as often as ``want`` says (zero for
        the rest) and no plain version called."""
        return all(n == want.get(name, 0) for name, n in launched.items())

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for {_build.sources()}")
    for name, log in logs.items():
        print(f"--- nvcc {name}.cu: registers, shared memory, spills ---")
        print("\n".join(ptxas_summary(log)))
    k3_lib = k3_kernel._lib()
    for label, dtype, rows in (("f32", 0, 0), ("bf16 decode, 16 rows", 1, 16),
                               ("bf16 prefill, 64 rows", 1, 64)):
        print(f"flash_attention {label}: dynamic shared memory per block: " + ", ".join(
            f"hd {hd}: {k3_lib.flash_attention_smem_bytes(dtype, rows, hd)} B"
            + (f" ({k3_lib.flash_attention_blocks_per_sm(rows, hd)} blocks per SM)"
               if dtype else "") for hd in k3_kernel.HEAD_DIMS))

    def k3_plan(heads, tq, tk, qo=0, win=0):
        """K3's split plan on this card for (Hq, Hkv, hd) ``heads``."""
        h, kvh, d = heads
        slots = k3_kernel._slots(0, k3_kernel.variant(h, kvh, tq, d)[0], d)
        return split_plan(1, h, kvh, tq, tk, d, q_offset=qo, window=win, slots=slots)

    # -- 2. kernels against their plain versions --------------------------
    stamp(2)
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"jacobi_sweep": 0.0, "jacobi_two_step": 0.0, "flash_attention": 0.0,
            "wkv6": 0.0, "rglru": 0.0}
    for shape, (di, dj) in SWEEP_CASES:
        for c in (1 / 6, 0.25):
            f = torch.randn(shape, generator=gen, device=dev)
            e = max_err(jacobi_sweep_cuda(f, c, di, dj), ref.jacobi_sweep_ref(f, c))
            errs["jacobi_sweep"] = max(errs["jacobi_sweep"], e)
            print(f"K1 {shape} c={c:.4f}: max_abs_err {e:.3e}")
    for shape, (di, dj) in TWO_STEP_CASES:
        for c in (1 / 6, 0.25):
            f = torch.randn(shape, generator=gen, device=dev)
            e = max_err(jacobi_two_step_cuda(f, c, di, dj),
                        ref.jacobi_two_step_ref(f, c))
            errs["jacobi_two_step"] = max(errs["jacobi_two_step"], e)
            print(f"K2 {shape} c={c:.4f}: max_abs_err {e:.3e}")

    f = torch.randn(LATTICE, generator=gen, device=dev)
    plain = ref.jacobi_sweep_ref(f)
    e = max_err(jacobi_sweep_cuda(f), plain)
    errs["jacobi_sweep"] = max(errs["jacobi_sweep"], e)
    print(f"K1 {LATTICE}: max_abs_err {e:.3e}")
    e = max_err(jacobi_two_step_cuda(f), ref.jacobi_sweep_ref(plain))
    errs["jacobi_two_step"] = max(errs["jacobi_two_step"], e)
    print(f"K2 {LATTICE}: max_abs_err {e:.3e}")
    torch.cuda.synchronize()
    if errs["jacobi_sweep"] > K1_ATOL or errs["jacobi_two_step"] > K2_ATOL:
        fail(f"kernel disagrees with its plain version: {errs}")

    print(f"K3 limits, per element against mha_ref's value r: |err| <= "
          f"{K3_F32_TOL['atol']} in f32 (the online softmax reassociates the "
          f"sums), {K3_BF16_TOL['atol']} + 2^-7 |r| in bf16 (both round an f32 "
          f"result to bf16 once, so may land one bf16 ulp apart)")
    k3_worst = 0.0      # the largest share of its limit any element used

    def k3_check(label, got, want, tol):
        nonlocal k3_worst
        e = max_err(got, want)
        want = want.float()
        share = float(((got.float() - want).abs()
                       / (tol["atol"] + tol["rtol"] * want.abs())).max())
        k3_worst = max(k3_worst, share)
        print(f"K3 {label}: max_abs_err {e:.3e}, |ref| max {float(want.abs().max()):.4f} "
              f"median {float(want.abs().median()):.4f}, worst share of limit {share:.3f}")
        return e

    k3_f32, k3_bf16 = 0.0, 0.0
    for b, hq, hkv, tq, tk, hd, causal, win in FLASH_CASES:
        q = torch.randn((b, hq, tq, hd), generator=gen, device=dev)
        k, v = (torch.randn((b, hkv, tk, hd), generator=gen, device=dev)
                for _ in range(2))
        kw = dict(causal=causal, window=win, q_offset=tk - tq)
        k3_f32 = max(k3_f32, k3_check(
            f"f32 {(b, hq, hkv, tq, tk, hd)} causal={causal} window={win}",
            flash_attention(q, k, v, bq=tq, bk=tk, **kw), mha_ref(q, k, v, **kw),
            K3_F32_TOL))
    q, k, v = (torch.randn((1, 2, 128, 32), generator=gen, device=dev).bfloat16()
               for _ in range(3))
    k3_bf16 = max(k3_bf16, k3_check("bf16 (1, 2, 128, 32)", flash_attention(
        q, k, v, bq=64, bk=64), mha_ref(q, k, v), K3_BF16_TOL))

    cfg, gcfg = get_config(QWEN), get_config(GRIFFIN)
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    # recurrentgemma-9b's local layers: 16 q / 1 kv head of 256
    ghq, ghkv, ghd = gcfg.num_heads, gcfg.num_kv_heads, gcfg.head_dim

    def model_qkv(tq, tk, heads):
        """(B, T, H, hd) tensors for ``heads`` = (Hq, Hkv, hd), passed as
        (B, H, T, hd) views, as the model does."""
        h, kvh, d = heads
        q = torch.randn((1, tq, h, d), generator=gen, device=dev).bfloat16().transpose(1, 2)
        k, v = (torch.randn((1, tk, kvh, d), generator=gen, device=dev).bfloat16()
                .transpose(1, 2) for _ in range(2))
        return q, k, v

    def k3_model(label, tq, tk, qo, heads, win=0):
        """K3 against mha_ref on fresh model-shaped bf16 inputs: (the
        inputs, the error)."""
        q, k, v = model_qkv(tq, tk, heads)
        e = k3_check(f"bf16 {label} q {tuple(q.shape)} kv {tuple(k.shape)} "
                     f"q_offset={qo} window={win}",
                     flash_attention(q, k, v, q_offset=qo, window=win, bq=tq, bk=tk),
                     mha_ref(q, k, v, q_offset=qo, window=win), K3_BF16_TOL)
        return (q, k, v), e

    k3_inputs, k3g_inputs = {}, {}
    for name, tq, tk, qo in K3_SHAPES:
        qkv, e = k3_model(name, tq, tk, qo, (hq, hkv, hd))
        k3_inputs[name], k3_bf16 = (*qkv, qo), max(k3_bf16, e)
    for name, tq, tk, qo, win in K3_GRIFFIN_SHAPES:
        qkv, e = k3_model(f"hd {ghd} {name}", tq, tk, qo, (ghq, ghkv, ghd), win)
        k3g_inputs[name], k3_bf16 = (*qkv, qo, win), max(k3_bf16, e)
    # the drains' own prompts: each prefill (with the local layers' window
    # for recurrentgemma-9b), and the first decode step after it
    for arch_cfg, heads, win in ((cfg, (hq, hkv, hd), 0),
                                 (gcfg, (ghq, ghkv, ghd), gcfg.attn_window)):
        for plen in sorted(len(r.tokens) for r in requests(arch_cfg, Request)):
            for tq, tk, qo, w in ((plen, plen, 0, win), (1, MAX_SEQ, plen, 0)):
                _, e = k3_model(f"{arch_cfg.name} drain "
                                f"{'prefill' if tq > 1 else 'decode'} {plen}",
                                tq, tk, qo, heads, w)
                k3_bf16 = max(k3_bf16, e)
    # a wrapped ring: every slot holds a position, slot p % 2048.  The model's
    # call (window 0, q_offset pos) against the plain ring mask on the same
    # bf16 values in f32, rounded once to bf16 as mha_ref's result is
    for pos in K3_RING_WRAPPED:
        q, k, v = model_qkv(1, MAX_SEQ, (ghq, ghkv, ghd))
        want = decode_attention(*(x.transpose(1, 2).float() for x in (q, k, v)),
                                pos + 1, ring=True)
        want = want.reshape(1, 1, ghq, ghd).transpose(1, 2).bfloat16()
        k3_bf16 = max(k3_bf16, k3_check(
            f"bf16 hd {ghd} wrapped ring decode at pos {pos} (window 0, "
            f"q_offset {pos}) vs decode_attention(ring=True)",
            flash_attention(q, k, v, q_offset=pos, bq=1, bk=MAX_SEQ), want,
            K3_BF16_TOL))
    for heads in ((hq, hkv, hd), (ghq, ghkv, ghd)):
        for qo, win in K3_SPLIT_DECODE:
            plan = k3_plan(heads, 1, MAX_SEQ, qo, win)
            _, e = k3_model(f"hd {heads[2]} split decode ({plan.splits} chunks of "
                            f"{plan.tiles_per_chunk} x {plan.bk} keys)", 1, MAX_SEQ, qo,
                            heads, win)
            k3_bf16 = max(k3_bf16, e)
    for arch_cfg, heads in ((cfg, (hq, hkv, hd)), (gcfg, (ghq, ghkv, ghd))):
        t, win = K3_ONE_PAST[arch_cfg.name]
        _, e = k3_model(f"hd {heads[2]} prefill one past the row and key tiles", t, t, 0,
                        heads, win)
        k3_bf16 = max(k3_bf16, e)
    t = K3_MISSED_CHUNK
    plan = k3_plan((hq, hkv, hd), t, t)
    _, e = k3_model(f"hd {hd} split prefill, rows that miss a chunk ({plan.splits} "
                    f"chunks of {plan.tiles_per_chunk} x {plan.bk} keys)", t, t, 0,
                    (hq, hkv, hd))
    k3_bf16 = max(k3_bf16, e)
    torch.cuda.synchronize()
    if k3_worst > 1.0:
        fail(f"K3 disagrees with mha_ref: an element used {k3_worst:.3f} of its limit")
    # the same call gives the same bits (the split's merge order is fixed)
    for label, (q, k, v, qo, *win) in (("qwen2 decode_2047", k3_inputs["decode_2047"]),
                                       ("qwen2 prefill_1024", k3_inputs["prefill_1024"]),
                                       ("hd 256 decode_2047", k3g_inputs["decode_2047"]),
                                       ("hd 256 prefill_1024", k3g_inputs["prefill_1024"])):
        kw = dict(q_offset=qo, window=win[0] if win else 0, bq=q.shape[2], bk=k.shape[2])
        first = flash_attention(q, k, v, **kw)
        if not all(torch.equal(flash_attention(q, k, v, **kw), first) for _ in range(3)):
            fail(f"K3 {label}: repeated calls differ")
    print("K3 repeat calls bit-identical at qwen2 and hd 256 decode_2047 and prefill_1024")
    errs["flash_attention"] = max(k3_f32, k3_bf16)

    print(f"K4 limit, per element of o and of the final state: |err| <= {K4_REL} "
          f"x the shape's max |ref| (both sum the same f32 products in other orders)")
    k4_worst = 0.0

    def k4_check(label, got, want):
        nonlocal k4_worst
        for part, g, r in zip(("o", "sT"), got, want):
            e = max_err(g, r)
            top = float(r.abs().max())
            share = e / (K4_REL * top)
            k4_worst = max(k4_worst, share)
            errs["wkv6"] = max(errs["wkv6"], e)
            print(f"K4 {label} {part}: max_abs_err {e:.3e}, |ref| max {top:.4f} "
                  f"median {float(r.abs().median()):.4f}, worst share of limit {share:.3f}")

    for b, t, h, hdw in WKV_CASES:
        r, k, v = (torch.randn((b, t, h, hdw), generator=gen, device=dev) * s
                   for s in (1.0, 0.3, 0.3))
        w = 0.8 + 0.199 * torch.rand((b, t, h, hdw), generator=gen, device=dev)
        u = 0.3 * torch.randn((h, hdw), generator=gen, device=dev)
        k4_check(f"f32 {(b, t, h, hdw)}", wkv6_cuda(r, k, v, w, u, chunk=32),
                 wkv6_ref(r, k, v, w, u))
        if (b, t, h, hdw) == (1, 128, 4, 32):     # the state carried across calls
            half = [x[:, :64].contiguous() for x in (r, k, v, w)]
            rest = [x[:, 64:].contiguous() for x in (r, k, v, w)]
            o1, s1 = wkv6_cuda(*half, u, chunk=32)
            o2, s2 = wkv6_cuda(*rest, u, chunk=32, s0=s1)
            k4_check(f"f32 {(b, t, h, hdw)} in two calls",
                     (torch.cat([o1, o2], 1), s2), wkv6_ref(r, k, v, w, u))

    rcfg = get_config(RWKV)
    rh, rhd = rcfg.d_model // rcfg.rwkv_head_dim, rcfg.rwkv_head_dim

    def wkv_model_inputs(t):
        """rwkv6-3b's WKV inputs: bf16 r, k, v; f32 decays exp(-exp(d)) with
        d around the model's -6; f32 u in [0, 0.5) as initialised."""
        r, k, v = (torch.randn((1, t, rh, rhd), generator=gen, device=dev).bfloat16()
                   for _ in range(3))
        decay = -6.0 + torch.randn((1, t, rh, rhd), generator=gen, device=dev)
        u = 0.5 * torch.rand((rh, rhd), generator=gen, device=dev)
        return r, k, v, torch.exp(-torch.exp(decay)), u

    k4_inputs = {}
    for name, t in K4_SHAPES:
        k4_inputs[name] = wkv_model_inputs(t)
    prefill_state = wkv6_ref(*k4_inputs["prefill_1024"])[1]
    for name, t in K4_SHAPES:
        s0 = prefill_state if t == 1 else torch.zeros_like(prefill_state)
        want = wkv6_ref(*k4_inputs[name], s0)
        k4_check(f"bf16 {name} {(1, t, rh, rhd)}" + (" from a prefill's state"
                                                     if t == 1 else ""),
                 wkv6_cuda(*k4_inputs[name], chunk=t, s0=s0.clone()), want)
    for plen in sorted(len(r.tokens) for r in requests(rcfg, Request)):
        x = wkv_model_inputs(plen)
        k4_check(f"bf16 drain prefill {plen}", wkv6_cuda(*x, chunk=plen), wkv6_ref(*x))
    torch.cuda.synchronize()
    if k4_worst > 1.0:
        fail(f"K4 disagrees with wkv6_ref: an error used {k4_worst:.3f} of its limit")

    print("K5 limit: bit for bit, 0 unequal elements (each step is one rounded "
          "multiply and one rounded add in both)")
    k5_unequal = 0

    def k5_check(label, got, want):
        nonlocal k5_unequal
        e = max_err(got, want)
        n = int((got != want).sum())
        k5_unequal += n
        errs["rglru"] = max(errs["rglru"], e)
        print(f"K5 {label}: {n} unequal of {want.numel()}, max_abs_err {e:.3e}, "
              f"|ref| max {float(want.abs().max()):.4f}")

    for b, t, w, chunk in RGLRU_CASES:
        a = 0.5 + 0.499 * torch.rand((b, t, w), generator=gen, device=dev)
        bb = 0.1 * torch.randn((b, t, w), generator=gen, device=dev)
        k5_check(f"f32 {(b, t, w)} chunk={chunk}", rglru_scan_cuda(a, bb, chunk=chunk),
                 rglru_scan_ref(a, bb))
    gw = gcfg.d_model
    softplus_lam = rglru_model._softplus(torch.log(torch.expm1(-torch.log(
        torch.linspace(0.9, 0.999, gw, device=dev)) / rglru_model._C)))

    def rglru_model_inputs(t):
        """recurrentgemma-9b's scan inputs: a = exp(-8 softplus(lam) r) with
        lam as initialised and r a sigmoid gate; bx = sqrt(1 - a^2) i u."""
        r, i = (torch.sigmoid(torch.randn((1, t, gw), generator=gen, device=dev))
                for _ in range(2))
        log_a = -rglru_model._C * softplus_lam * r
        a = torch.exp(log_a)
        bx = torch.sqrt(1 - torch.exp(2 * log_a)) * i * \
            torch.randn((1, t, gw), generator=gen, device=dev)
        return a, bx

    k5_inputs = {name: rglru_model_inputs(t) for name, t in K5_SHAPES}
    zero_h = torch.zeros((1, gw), device=dev)
    carried_h = rglru_scan_ref(*k5_inputs["prefill_1024"])[:, -1].contiguous()
    for name, t in K5_SHAPES:
        h0 = carried_h if t == 1 else zero_h
        k5_check(f"f32 {name} {(1, t, gw)}" + (" from a prefill's state" if t == 1 else ""),
                 rglru_scan_cuda(*k5_inputs[name], chunk=t, h0=h0),
                 rglru_scan_ref(*k5_inputs[name], h0))
        k5_inputs[name] += (h0,)
    for plen in sorted(len(r.tokens) for r in requests(gcfg, Request)):
        a, bx = rglru_model_inputs(plen)
        k5_check(f"f32 drain prefill {plen}", rglru_scan_cuda(a, bx, chunk=plen, h0=zero_h),
                 rglru_scan_ref(a, bx, zero_h))
    torch.cuda.synchronize()
    if k5_unequal:
        fail(f"K5 differs from rglru_scan_ref in {k5_unequal} elements")

    # -- 3. the Jacobi main path, then jacobi_iterate ----------------------
    stamp(3)
    di, domains, wpd = 10, 4, 2
    zero_counts()
    out, stats = run_runtime_sweep(f, di=di, num_domains=domains,
                                   workers_per_domain=wpd)
    torch.cuda.synchronize()
    main_launches = counts()
    e_main = max_err(out, plain)
    print(f"run_runtime_sweep {LATTICE} di={di} domains={domains}x{wpd}: "
          f"max_abs_err {e_main:.3e}, launches {main_launches}")
    print(f"RuntimeStats: {stats}")
    nslabs = LATTICE[0] // di
    if e_main > K1_ATOL or main_launches["jacobi_sweep"] != nslabs \
            or stats.executed != nslabs:
        fail(f"runtime sweep: err {e_main}, launches {main_launches}, "
             f"executed {stats.executed}, want {nslabs} slabs")
    del out

    steps = 3
    zero_counts()
    it = ops.jacobi_iterate(f, steps)
    torch.cuda.synchronize()
    iter_launches = counts()
    want = ref.jacobi_sweep_ref(ref.jacobi_sweep_ref(plain))
    e_iter = max_err(it, want)
    print(f"jacobi_iterate steps={steps}: max_abs_err {e_iter:.3e}, "
          f"launches {iter_launches}")
    if e_iter > K2_ATOL or iter_launches["jacobi_sweep"] != 1 \
            or iter_launches["jacobi_two_step"] != 1:
        fail(f"jacobi_iterate: err {e_iter}, launches {iter_launches}")
    del it, want, plain

    # -- 4-5. the serving paths at full width ------------------------------
    def build(arch, cfg):
        """``arch`` at full width, random weights from seed 0: (model, params)."""
        t0 = time.perf_counter()
        model = build_model(cfg)
        params = model.init_params(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        n_params = sum(leaf.numel() for leaf in leaves(params))
        heads = (f"{cfg.d_model // cfg.rwkv_head_dim} heads of {cfg.rwkv_head_dim}"
                 if "rwkv" in cfg.pattern else
                 f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}")
        print(f"{arch}: {cfg.num_layers} layers, d {cfg.d_model}, {heads}, d_ff "
              f"{cfg.d_ff}, vocab {cfg.vocab_padded()}, {n_params} params counted "
              f"(ModelConfig.num_params() says {cfg.num_params()}) in {model.dtype}, "
              f"built in {time.perf_counter() - t0:.2f} s")
        return model, params

    def serve(arch, cfg):
        """Build ``arch`` at full width, drain the workload under every
        policy (checking that each drain launches each kernel of the path
        once per layer of its kind per prefill and decode step, and no other
        kernel or plain version) and profile one more drain.  Returns
        (model, params, metrics)."""
        model, params = build(arch, cfg)

        def new_engine(policy):
            engine = ServingEngine(model, params, num_replicas=REPLICAS,
                                   max_seq=MAX_SEQ, policy=policy)
            for req in requests(cfg, Request):
                engine.submit(req)
            return engine

        want = path_launches(cfg, N_REQUESTS)
        prompt_tokens = sum(len(r.tokens) for r in requests(cfg, Request))
        print(f"{arch} serving: {N_REQUESTS} requests, {prompt_tokens} prompt tokens, "
              f"{MAX_NEW} new tokens each, {REPLICAS} replicas, max_seq {MAX_SEQ}; "
              f"want launches {want} per drain")
        # warm-up (cuBLAS handles, the caching allocator): one short request,
        # so the first policy's times are not the process's first calls
        warm = requests(cfg, Request)[0]
        warm.max_new = 2
        Replica(model, params, MAX_SEQ).run(warm)
        torch.cuda.synchronize()
        outs, metrics = {}, {}
        for policy in POLICIES:
            engine = new_engine(policy)
            prefill_t, decode_t = Timed(model.prefill), Timed(model.decode_step)
            for rep in engine.replicas:
                rep._prefill, rep._decode = prefill_t, decode_t
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            done = engine.run_until_drained()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = counts()
            outs[policy] = {r.uid: tuple(r.out_tokens) for r in done}
            generated = sum(len(r.out_tokens) for r in done)
            m = {"wall_s": wall, "tokens_per_s": generated / wall,
                 "prefill_ms_per_request": float(np.mean(prefill_t.ms)),
                 "decode_ms_per_token": float(np.mean(decode_t.ms)),
                 "launches": launched, "stats": engine.stats}
            metrics[policy] = m
            print(f"{arch} {policy}: {engine.stats}, locality "
                  f"{engine.stats.locality_fraction:.3f}")
            print(f"{arch} {policy}: wall {wall:.4f} s, {generated} tokens, "
                  f"{m['tokens_per_s']:.2f} tokens/s, prefill "
                  f"{m['prefill_ms_per_request']:.4f} ms per request, decode "
                  f"{m['decode_ms_per_token']:.4f} ms per token, launches {launched}")
            if not path_ok(launched, want):
                fail(f"{arch} {policy}: launches {launched}, want {want} and no "
                     f"other kernel or plain call")
            if len(done) != N_REQUESTS or generated != N_REQUESTS * MAX_NEW or \
                    not all(0 <= t < cfg.vocab_padded() for o in outs[policy].values()
                            for t in o):
                fail(f"{arch} {policy}: served {len(done)} requests, {generated} tokens")
        if not outs["locality"] == outs["round_robin"] == outs["single_queue"]:
            fail(f"{arch}: the policies generated different tokens")
        print(f"{arch}: tokens identical across {POLICIES}; request 0: "
              f"{list(outs['locality'][0])}")

        from torch.profiler import ProfilerActivity, profile
        engine = new_engine("locality")
        torch.cuda.synchronize()
        zero_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.run_until_drained()
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
        prof_launches = counts()
        t0 = time.perf_counter()
        spans = device_spans(prof)
        busy = busy_ms(spans)
        print(f"profiler: {len(spans)} device records read in "
              f"{time.perf_counter() - t0:.1f} s")
        if busy <= 0 or not path_ok(prof_launches, want):
            fail(f"{arch} profiled drain: device busy {busy} ms, launches {prof_launches}")
        idle_share = 1 - busy / prof_wall_ms
        print(f"{arch} profiled drain (locality): wall {prof_wall_ms:.4f} ms, device "
              f"busy {busy:.4f} ms, idle share {idle_share:.4f}")
        print("device time by function over the profiled drain:")
        print("\n".join(top_kernels(spans)))
        in_drain = {}
        for name in want:
            times = [(e - st) / 1e3 for fn, st, e in spans if f"{name}_kernel" in fn]
            in_drain[name] = {"calls": len(times), "total_ms": sum(times) / 1e3,
                              "mean_us": sum(times) / max(len(times), 1)}
            print(f"{arch} profiled drain, {name}_kernel: {len(times)} calls, "
                  f"{sum(times) / 1e3:.3f} ms, {in_drain[name]['mean_us']:.3f} us per call "
                  f"({sum(times) / 1e3 / busy:.1%} of device busy time)")
        del engine, prof, spans
        result = {p: {k: v for k, v in m.items() if k != "stats"}
                  | {"stats": vars(m["stats"])} for p, m in metrics.items()}
        result.update(idle_share=idle_share, kernels_in_drain=in_drain)
        return model, params, result

    def teacher_forced(arch, cfg, model, params, faults=None):
        """The kernel path against the plain path (``use_kernel=False``) on
        request 0, teacher-forced with the plain path's greedy tokens: the
        prefill's and every decode step's logits must agree within
        ``LOGITS_ATOL[arch]``.  Each of ``faults`` (name -> (module,
        attribute, a stand-in with a planted error)) runs the plain path the
        same way with the stand-in in place and must differ from it by more
        than the limit."""
        req = requests(cfg, Request)[0]
        toks = torch.as_tensor(req.tokens, dtype=torch.int64, device=dev)[None]
        plain_model = build_model(cfg, use_kernel=False)

        def run(m, forced=None):
            caches = m.init_cache(1, MAX_SEQ)
            logits, caches = m.prefill(params, {"tokens": toks}, caches)
            steps, chosen, pos = [logits[:, -1].float()], [], toks.shape[1]
            for i in range(MAX_NEW):
                cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
                chosen.append(int(cur[0, 0]))
                if forced is not None:
                    cur = torch.full_like(cur, forced[i])
                logits, caches = m.decode_step(params, cur, pos, caches)
                steps.append(logits[:, -1].float())
                pos += 1
            return torch.cat(steps), chosen

        zero_counts()
        plain_logits, plain_chosen = run(plain_model)
        if any(n for name, n in counts().items() if not name.endswith("_plain_calls")):
            fail(f"the plain path launched a kernel: {counts()}")
        zero_counts()
        kern_logits, kern_chosen = run(model, forced=plain_chosen)
        if not path_ok(counts(), path_launches(cfg, 1)):
            fail(f"the teacher-forced kernel path launched {counts()}")
        diff = (kern_logits - plain_logits).abs().amax(dim=-1)
        agree = sum(a == b for a, b in zip(kern_chosen, plain_chosen))
        limit = LOGITS_ATOL[arch]
        print(f"{arch} teacher-forced logits in {model.dtype}, kernel vs plain path "
              f"({len(req.tokens)} prompt tokens, {1 + MAX_NEW} steps, |logits| up "
              f"to {float(plain_logits.abs().max()):.3f}): max_abs_err "
              f"{float(diff.max()):.6f} (prefill {float(diff[0]):.6f}), limit "
              f"{limit}; greedy choices agree {agree}/{MAX_NEW}")
        fault_gaps = {}
        for name, (module, attr, fn) in (faults or {}).items():
            sound = getattr(module, attr)
            setattr(module, attr, fn)
            try:
                fault_logits, _ = run(plain_model, forced=plain_chosen)
            finally:
                setattr(module, attr, sound)
            fault_gaps[name] = float((fault_logits - plain_logits).abs().max())
            print(f"{arch} planted fault ({name}) vs plain path: max_abs_err "
                  f"{fault_gaps[name]:.6f}, {fault_gaps[name] / limit:.1f}x the limit")
        if not bool(kern_logits.isfinite().all()) or float(diff.max()) > limit:
            fail(f"{arch}: kernel path logits disagree with the plain path: "
                 f"{diff.tolist()}")
        if any(gap <= limit for gap in fault_gaps.values()):
            fail(f"{arch}: the limit {limit} would not see a planted fault: {fault_gaps}")
        del plain_model
        return {"teacher_forced_dtype": str(model.dtype).split(".")[-1],
                "teacher_forced_max_abs_err": float(diff.max()),
                "teacher_forced_limit": limit, "greedy_agree": agree,
                "planted_faults": fault_gaps}

    stamp(4)
    serving = {}
    model, params, serving[QWEN] = serve(QWEN, cfg)
    serving[QWEN].update(teacher_forced(QWEN, cfg, model, params))
    del model, params
    free_device_memory()

    stamp(5)
    model, params, serving[RWKV] = serve(RWKV, rcfg)
    # K4 on a decode step from the state a real prefill left in the cache
    caches = model.init_cache(1, MAX_SEQ)
    toks = torch.as_tensor(requests(rcfg, Request)[0].tokens, device=dev)[None]
    model.prefill(params, {"tokens": toks}, caches)
    for layer in (0, rcfg.num_layers - 1):
        s0 = caches[layer]["s"]
        r, k, v, w, u = wkv_model_inputs(1)
        k4_check(f"bf16 decode from layer {layer}'s prefill state (|s| max "
                 f"{float(s0.abs().max()):.3f})",
                 wkv6_cuda(r, k, v, w, u, chunk=1, s0=s0.clone()),
                 wkv6_ref(r, k, v, w, u, s0))
    torch.cuda.synchronize()
    if k4_worst > 1.0:
        fail(f"K4 disagrees with wkv6_ref: an error used {k4_worst:.3f} of its limit")
    del model, params, caches
    free_device_memory()
    # the teacher-forced comparison on an f32 build, with two planted faults
    f32cfg = dataclasses.replace(rcfg, dtype="float32")
    model, params = build(RWKV, f32cfg)
    faults = {
        "u dropped": (wkv_ops, "wkv6_ref", lambda r, k, v, w, u, s0=None: wkv6_ref(
            r, k, v, w, torch.zeros_like(u), s0)),
        "state not carried": (wkv_ops, "wkv6_ref",
                              lambda r, k, v, w, u, s0=None: wkv6_ref(r, k, v, w, u))}
    serving[RWKV].update(teacher_forced(RWKV, f32cfg, model, params, faults))
    del model, params
    free_device_memory()

    stamp("5b")
    model, params, serving[GRIFFIN] = serve(GRIFFIN, gcfg)
    # K5 on a decode step from the state a real prefill left in the cache
    toks = torch.as_tensor(requests(gcfg, Request)[0].tokens, device=dev)[None]
    _, caches = model.prefill(params, {"tokens": toks}, model.init_cache(1, MAX_SEQ))
    kinds = gcfg.layer_kinds()
    rglru_layers = [i for i, kind in enumerate(kinds) if kind == "rglru"]
    for layer in (rglru_layers[0], rglru_layers[-1]):
        h0 = caches[layer]["h"].float()
        a, bx = rglru_model_inputs(1)
        k5_check(f"f32 decode from layer {layer}'s prefill state (|h| max "
                 f"{float(h0.abs().max()):.3f})",
                 rglru_scan_cuda(a, bx, chunk=1, h0=h0), rglru_scan_ref(a, bx, h0))
    torch.cuda.synchronize()
    if k5_unequal:
        fail(f"K5 differs from rglru_scan_ref in {k5_unequal} elements")
    del model, params, caches
    free_device_memory()
    # the teacher-forced comparison on an f32 build, with two planted faults,
    # once every earlier model is freed
    torch.cuda.reset_peak_memory_stats()
    f32cfg = dataclasses.replace(gcfg, dtype="float32")
    model, params = build(GRIFFIN, f32cfg)
    conv = rglru_model._causal_conv
    faults = {
        "RG-LRU state not carried": (rglru_ops, "rglru_scan_ref",
                                     lambda a, b, h0=None: rglru_scan_ref(a, b)),
        "conv history not carried": (rglru_model, "_causal_conv",
                                     lambda x, w, b, state=None: conv(x, w, b))}
    serving[GRIFFIN].update(teacher_forced(GRIFFIN, f32cfg, model, params, faults))
    peak = torch.cuda.max_memory_allocated()
    print(f"{GRIFFIN} f32 build: peak device memory {peak} B ({peak / 1e9:.2f} GB)")
    serving[GRIFFIN]["f32_peak_bytes"] = peak
    del model, params
    free_device_memory()

    # -- 6. timing ---------------------------------------------------------
    stamp(6)
    sites = f.numel()
    io_bytes = 2 * 4 * sites                     # read f once, write once
    jb = {"jacobi_sweep": bound(io_bytes, 6 * sites, F32_FLOPS_PER_S),    # 5 adds, 1 mul
          "jacobi_two_step": bound(io_bytes, 12 * sites, F32_FLOPS_PER_S)}
    buf = torch.empty_like(f)
    ms = {"jacobi_sweep": time_ms(lambda: jacobi_sweep_cuda(f, out=buf), 20),
          "jacobi_two_step": time_ms(lambda: jacobi_two_step_cuda(f, out=buf), 20)}
    plain_ms = {"jacobi_sweep": time_ms(lambda: ref.jacobi_sweep_ref(f), 5),
                "jacobi_two_step": time_ms(lambda: ref.jacobi_two_step_ref(f), 3)}

    # library yardstick: one cuDNN conv3d with the six-point cross (two for
    # the two-step), TF32 off
    w = torch.zeros((1, 1, 3, 3, 3), device=dev)
    for i, j, k in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0), (1, 1, 2)):
        w[0, 0, i, j, k] = 1 / 6
    x = f.view(1, 1, *LATTICE)
    conv = torch.nn.functional.conv3d
    e_conv = max_err(conv(x, w, padding=1)[0, 0], ref.jacobi_sweep_ref(f))
    library_ms = {"jacobi_sweep": time_ms(lambda: conv(x, w, padding=1), 5),
                  "jacobi_two_step": time_ms(
                      lambda: conv(conv(x, w, padding=1), w, padding=1), 3)}
    print(f"library conv3d (cudnn.allow_tf32=False): max_abs_err vs plain {e_conv:.3e}")

    # the runtime sweep (host-driven, 240 launches): CUDA events around the
    # whole drain, and one padded-slab launch of K1 for the device share
    sweep_ms = time_ms(lambda: run_runtime_sweep(
        f, di=di, num_domains=domains, workers_per_domain=wpd), 3, warmup=1)
    slab = f[di - 1:2 * di + 1]
    slab_ms = time_ms(lambda: jacobi_sweep_cuda(
        slab, di=di + 2, dj=LATTICE[1], out=buf[di:2 * di], rows=(1, di + 1)), 50)

    for name in ("jacobi_sweep", "jacobi_two_step"):
        gbs = io_bytes / (ms[name] * 1e-3) / 1e9
        print(f"{name}: {ms[name]:.4f} ms, {gbs:.1f} GB/s, bound "
              f"{jb[name][0]:.4f} ms ({jb[name][0] / ms[name]:.1%} of bound), "
              f"plain {plain_ms[name]:.4f} ms, library {library_ms[name]:.4f} ms")
    print(f"run_runtime_sweep: {sweep_ms:.4f} ms, "
          f"{io_bytes / (sweep_ms * 1e-3) / 1e9:.1f} GB/s, bound "
          f"{jb['jacobi_sweep'][0]:.4f} ms "
          f"({jb['jacobi_sweep'][0] / sweep_ms:.1%} of bound); one slab launch "
          f"{slab_ms:.4f} ms x {nslabs} = {slab_ms * nslabs:.4f} ms of device time")
    del f, buf, x

    # K3 at the serving path's shapes (yardstick: SDPA, never called by the port)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    k3 = {}
    for name, tq, tk, qo in K3_SHAPES:
        q, k, v, _ = k3_inputs[name]
        visible = min(tk, qo + tq)
        if tq == 1:     # decode: the filled slots are the whole function
            lib_call = lambda: sdpa(q, k[:, :, :visible], v[:, :, :visible],  # noqa: E731
                                    enable_gqa=True)
        else:
            lib_call = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)  # noqa: E731
        e_lib = max_err(lib_call(), mha_ref(q, k, v, q_offset=qo))
        bnd, by = k3_bound(1, hq, hkv, tq, tk, hd, qo)
        k3[name] = {
            "ms": device_ms(lambda: flash_attention(q, k, v, q_offset=qo, bq=tq, bk=tk)),
            "plain_ms": device_ms(lambda: mha_ref(q, k, v, q_offset=qo), 5),
            "bound_ms": bnd, "bound_by": by,
            "library_ms": device_ms(lib_call)}
        r = k3[name]
        plan = dataclasses.asdict(k3_plan((hq, hkv, hd), tq, tk, qo))
        print(f"flash_attention {name} (plan {plan}): {r['ms']:.4f} ms, bound "
              f"{bnd:.6f} ms by {by} "
              f"({bnd / r['ms']:.2%} of bound), plain {r['plain_ms']:.4f} ms, "
              f"library sdpa {r['library_ms']:.4f} ms (max_abs_err vs plain {e_lib:.3e})")

    # K4 at rwkv6-3b's shapes, from a carried state written in place as the
    # model does (no PyTorch call computes the WKV recurrence: no yardstick)
    k4 = {}
    for name, t in K4_SHAPES:
        r, k, v, w, u = k4_inputs[name]
        s0 = prefill_state.clone()
        bnd, by = k4_bound(1, t, rh, rhd)
        k4[name] = {
            "ms": device_ms(lambda: wkv6_cuda(r, k, v, w, u, chunk=t, s0=s0)),
            "plain_ms": device_ms(lambda: wkv6_ref(r, k, v, w, u, s0), 3),
            "bound_ms": bnd, "bound_by": by, "library_ms": None}
        m = k4[name]
        print(f"wkv6 {name} {(1, t, rh, rhd)}: {m['ms']:.4f} ms, bound {bnd:.6f} ms "
              f"by {by} ({bnd / m['ms']:.2%} of bound), plain {m['plain_ms']:.4f} ms, "
              f"library: none (no PyTorch call computes the WKV recurrence)")

    # K5 at recurrentgemma-9b's width, from a carried state as the model calls
    # it (no single PyTorch call computes a linear recurrence: no yardstick).
    # Bound: a and b read once and h written once, 12 B per element, plus the
    # state read, over HBM; 2 f32 flops per element
    k5 = {}
    for name, t in K5_SHAPES:
        a, bx, h0 = k5_inputs[name]
        bnd, by = bound(12 * t * gw + 4 * gw, 2 * t * gw, F32_FLOPS_PER_S)
        k5[name] = {
            "ms": device_ms(lambda: rglru_scan_cuda(a, bx, chunk=t, h0=h0)),
            "plain_ms": device_ms(lambda: rglru_scan_ref(a, bx, h0), 3),
            "bound_ms": bnd, "bound_by": by, "library_ms": None}
        m = k5[name]
        print(f"rglru {name} {(1, t, gw)}: {m['ms']:.4f} ms, bound {bnd:.6f} ms by {by} "
              f"({bnd / m['ms']:.2%} of bound), plain {m['plain_ms']:.4f} ms, "
              f"library: none (no PyTorch call computes the recurrence)")

    # K3 at recurrentgemma-9b's hd-256 shapes (prefill with window 2048, which
    # binds nothing at T <= 2048, so SDPA's causal mask is the same function)
    k3g = {}
    for name, tq, tk, qo, win in K3_GRIFFIN_SHAPES:
        q, k, v, _, _ = k3g_inputs[name]
        visible = min(tk, qo + tq)
        if tq == 1:
            lib_call = lambda: sdpa(q, k[:, :, :visible], v[:, :, :visible],  # noqa: E731
                                    enable_gqa=True)
        else:
            lib_call = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)  # noqa: E731
        e_lib = max_err(lib_call(), mha_ref(q, k, v, q_offset=qo, window=win))
        bnd, by = k3_bound(1, ghq, ghkv, tq, tk, ghd, qo)
        k3g[name] = {
            "ms": device_ms(lambda: flash_attention(q, k, v, q_offset=qo, window=win,
                                                    bq=tq, bk=tk)),
            "plain_ms": device_ms(lambda: mha_ref(q, k, v, q_offset=qo, window=win), 5),
            "bound_ms": bnd, "bound_by": by, "library_ms": device_ms(lib_call)}
        r = k3g[name]
        plan = dataclasses.asdict(k3_plan((ghq, ghkv, ghd), tq, tk, qo, win))
        print(f"flash_attention hd {ghd} {name} (plan {plan}): {r['ms']:.4f} ms, "
              f"bound {bnd:.6f} ms "
              f"by {by} ({bnd / r['ms']:.2%} of bound), plain {r['plain_ms']:.4f} ms, "
              f"library sdpa {r['library_ms']:.4f} ms (max_abs_err vs plain {e_lib:.3e})")

    # -- 7. result lines --------------------------------------------------
    stamp(7)
    kernels = []
    for name, replaces, path, path_launches in (
            ("jacobi_sweep", "src/repro/kernels/jacobi/kernel.py:32",
             "run_runtime_sweep", main_launches),
            ("jacobi_two_step", "src/repro/kernels/jacobi/temporal.py:45",
             "jacobi_iterate", iter_launches)):
        kernels.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/csrc/jacobi.cu",
            "replaces": replaces, "path": path,
            "launches": path_launches[name], "max_abs_err": errs[name],
            "ms": ms[name], "plain_ms": plain_ms[name], "bound_ms": jb[name][0],
            "bound_by": jb[name][1], "library_ms": library_ms[name]})
    for name, source, replaces, arch, worst, shapes, headline in (
            ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:26", QWEN, k3_worst, k3,
             K3_HEADLINE),
            ("wkv6", "src/repro_torch/csrc/wkv6.cu",
             "src/repro/kernels/rwkv6/kernel.py:27", RWKV, k4_worst, k4, K4_HEADLINE),
            ("rglru", "src/repro_torch/csrc/rglru.cu",
             "src/repro/kernels/rglru/kernel.py:23", GRIFFIN, float(k5_unequal), k5,
             K5_HEADLINE)):
        head = shapes[headline]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "path": f"ServingEngine.run_until_drained ({arch}, locality)",
            "launches": serving[arch]["locality"]["launches"][name],
            "max_abs_err": errs[name], "limit_share": worst, "shape": headline,
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shapes": shapes})
    # K3 also carries recurrentgemma-9b's local layers, at head dim 256
    kernels[2].update(launches_by_path={
        arch: serving[arch]["locality"]["launches"]["flash_attention"]
        for arch in (QWEN, GRIFFIN)}, shapes_hd256=k3g)
    print(json.dumps({"serving": serving}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
