"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout, on a host with one CUDA card and the CUDA
toolkit (``nvcc``).  TF32 is off for matmuls and cuDNN throughout, so every
f32 product on the card is a full f32 product.  Phases, each fatal on
failure:

1. build every kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once) and print the build time, ``nvcc``'s register,
   shared-memory and spill report (K4's three kernels and K5 among them,
   every instance of K1 and K2), the tile, ring, occupancy and i chunk of
   the K1 and K2 instances the wrappers launch and the host cost of one
   tensor-map encode, K4's time chunk and K5's stage, and the card's name
   and power limit;
2. hold each kernel against its plain PyTorch version on the card:
   K1 and K2 at the shapes of the JAX package's kernel tests, at c = 0.25,
   and at the paper's 2400x600x600 f32 lattice (limits: 1e-6 for one
   sweep, 1e-5 for two, and 0 unequal elements); then bit for bit (0
   unequal elements) at j and k extents one below, at and one above a tile
   (and 4 either side in k) over one and two tiles, on lattices smaller
   than a tile and with nk not a multiple of 4 (the 4-byte-copy instance),
   at i extents either side of each kernel's i chunk, and at the runtime
   sweep's first and last slab of the paper lattice; K3 (flash attention) against ``mha_ref`` at the
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
   128 and 1024 and each of the rwkv6-3b drain's 12 prompt lengths, at
   C - 1, C and C + 1 (C its time chunk) and at 2 C + 5 and 3 C + 5, from
   zero and from a carried state, and decode (T = 1) from a carried
   state.  Limit, per element: 1e-5 of the shape's largest |ref| (both sum
   the same f32 products in other orders).
   K5 (the RG-LRU scan) against ``rglru_scan_ref`` bit for bit (limit: 0
   unequal elements; each step is one rounded multiply and one rounded
   add in both), at the shapes of ``tests/test_kernels.py``, at
   recurrentgemma-9b's width 4096 at prefill 128 and 1024 and at each of
   its drain's 12 prompt lengths, at decode (T = 1) from a carried state,
   and at widths 4096 and 4097 on either side of its shared-memory stage
   and past its ring's wrap.  K3 at recurrentgemma-9b's shapes in bf16, 16 query heads over
   one kv head of 256, as the model's strided views: prefill with window
   2048 at 128, 1024 and the drain's lengths, decode over a 2048-slot ring
   at positions 0, 517 and 2047, and over a wrapped ring at 2100 and 4095
   (``window=0``, ``q_offset=pos``) against ``decode_attention(ring=True)``
   on the same values in f32, rounded once to bf16; K3's bf16 design at
   both head shapes: decode on either side of a split boundary and with a
   window, prefill one past the row and key tiles, a split prefill in
   which some rows see none of a chunk's keys; the bf16 limit above.  Then
   the same K3 call, repeated, must give the same bits (decode 2047 and
   prefill 1024, both split).  Last, K3 at the new architectures' shapes
   (``K3_NEW_SHAPES``), in bf16 as the model's views and in f32, under the
   same limits: qwen3-moe-30b-a3b's 32 q / 4 kv heads of 128 at prefill
   128 and 1024 and decode 517 and 2047, whisper-base's 8/8 heads of 64
   without a causal mask at 1536 x 1536 (its encoder) and at Tq 128 and 1
   over 1536 frames (its cross-attention), llama-3.2-vision-90b's 64/8
   heads of 128 at Tq 128 and 1 over 1600 image tokens;
3. the Jacobi main path, ``run_runtime_sweep`` on the full lattice
   (di = 10, 4 domains x 2 workers = 240 slab tasks), against the plain
   sweep, with the launch counts zeroed before and read after;
3b. the same sweep built from ``spec.named("paper_cyclic")`` (4 domains)
   and recorded by the port's ``TraceRecorder``: 240 K1 launches and a
   lattice equal to the kwargs path's bit for bit; the trace is written as
   JSONL, read back, replayed from its header alone (the recorded stats
   and event stream) and passed by the port's ``check_trace``;
3c. the SPMD sweeps, ``make_contiguous_sweep`` and ``make_scattered_sweep``
   (4 slabs), as the one rank of an NCCL group on ``tcp://localhost``:
   each equal to the whole-lattice K1 sweep with 0 unequal elements, at 1
   and 4 K1 launches, with the bytes the rank hands to
   ``torch.distributed`` counted; each sweep timed beside the whole-lattice
   K1, its byte bound and the padded copy; the group is destroyed after;
   then ``jacobi_iterate`` (K2 for pairs of sweeps, K1 for the odd one)
   as in phase 3;
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
   more drain under ``torch.profiler`` (behind 64 one-element fills, since
   a session can lose its first 32 device records; run again, at most
   three times in all, if its trace still lacks a prefill marker) gives
   the card's idle share, its
   top device functions and each of the path's kernels' device time per
   call in the drain, split into prefill and decode calls (a one-cycle
   device sleep before and after each prefill marks them in the trace).
   Two more drains (4b): with ``control=ControlLoop.full(batch_cap=4)``,
   and built from ``spec.named("controlled_serving")`` with 3 domains, 3
   replicas and ``max_seq`` 2048; each must launch K3 9504 times and give
   the ``locality`` drain's tokens.  Then the kernel path against the plain path: one
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
5c. the same drains on full-width qwen3-moe-30b-a3b in bf16 (48 layers,
   d 2048, 32 q / 4 kv heads of 128, 128 experts top-8 of width 768,
   30.53 B parameters, 61.09 GB), once every earlier model is freed: K3
   must launch 12 x 48 x 33 = 19008 times per drain and the plain
   attention never; the peak device memory is printed, and the MoE
   block's device time is split into router and top-k, dispatch, expert
   products and combine (one layer's experts, at a decode step and at
   each prompt length, times the drain's calls).  Its teacher-forced
   comparison runs on an f32 build of its first 8 layers (122 GB whole in
   f32), with two planted faults in the MoE block of the plain path (the
   top-k weights not renormalised; the decode's gather reading the next
   expert's weights) that must each exceed the limit, and prints how many
   (token, layer) routing choices differ between the two paths;
5d. the other four new configurations at full width: minicpm3-4b (MLA,
   which runs its plain path on every device) and whisper-base whole,
   phi3.5-moe-42b-a6.6b at 8 of 32 layers and llama-3.2-vision-90b at 5 of
   100 (neither fits on one card whole); each a prefill of 128 tokens
   (whisper with 1536 frames, the VLM with 1600 image tokens and its
   cross-attention gates set to 0.5 and -0.7, from seed 0), then 8
   teacher-forced decode steps, whose logits must equal the full
   forward's (phi3.5-moe at a capacity factor of E / k, where nothing
   drops) and the plain path's at the published capacity factor (with the
   plain path's expert choices forced, for phi3.5-moe) within a bf16
   limit, with K3 launched once per attention call and the plain path
   none;
5e. the plain long prefill on CUDA tensors: ``chunked_attention`` at 4096
   tokens with qwen2-0.5b's heads and ``banded_attention`` at 4096 with
   gemma3-1b's heads and window 512, each on f32 copies of bf16 values and
   rounded once, against K3 per element within the bf16 limit;
6. time each kernel, its plain version and the library's yardstick with
   CUDA events, beside its bound: K1 and K2 at the full lattice (yardstick
   ``conv3d`` with the six-point cross), one K1 slab launch of the runtime
   sweep (10 rows, each call the next of 99 slabs so that none finds its
   rows in L2; device time of 50 launches queued behind a device sleep,
   and back to back as PR 16 timed it), and the
   runtime sweep's wall time beside its device time and idle share under
   ``torch.profiler``, each beside PR 16's number, and the same for the
   spec-built sweep of phase 3b; K3 at the
   serving path's prefill and decode shapes (yardstick
   ``scaled_dot_product_attention``, which the port never calls); K4 at
   rwkv6-3b's prefill 1024 and 128 and decode (no PyTorch call computes
   the WKV recurrence, so it has no yardstick); K5 at recurrentgemma-9b's
   prefill 1024 and 128 and decode (no yardstick either), K4 and K5 beside
   their previous designs' times; K3 at
   recurrentgemma-9b's hd-256 prefill and decode shapes beside SDPA, and
   at the new architectures' shapes beside SDPA (without a mask where K3
   runs without one);
7. print the ``serving`` and ``kernels`` JSON lines, the card's name and
   power limit, and last the ``{"ok": true, ...}`` line.

Exits non-zero, with no result line, when there is no CUDA device or when
the port's sources are not beside this script.
"""
from __future__ import annotations

import dataclasses
import datetime
import gc
import itertools
import json
import pathlib
import socket
import subprocess
import sys
import tempfile
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
# K1 and K2 on either side of a tile: offsets of (nj, nk) from (tiles x TJ,
# TK) at 1 and 2 tiles in j; nk 119 and 121 take the 4-byte-copy instance
TILE_J_OFFSETS, TILE_K_OFFSETS = (-1, 0, 1), (-4, -1, 0, 1, 4)
# lattices smaller than one tile, and nk not a multiple of 4
SMALL_LATTICES = [(3, 2, 8), (2, 2, 4), (2, 3, 5), (6, 10, 30), (5, 9, 13), (3, 7, 1)]
SLAB_ROWS = 10                # the runtime sweep's slab (di) at the paper lattice
SPEC_SWEEP = "paper_cyclic"   # the spec-built runtime sweep's policy: 4 domains
SPMD_BLOCKS_PER_DEV = 4       # the scattered SPMD sweep's slabs per rank
PROFILER_WARMUP = 64          # device records queued ahead of a profiled session
# K1 and K2 before this design (PR 16 run 2, PERF.md §6, H100 80GB HBM3 at
# 700 W): printed beside this run's numbers, kept out of the result lines
JACOBI_BEFORE = {"jacobi_sweep_ms": 5.0611, "slab_us": 29.3,
                 "jacobi_two_step_ms": 6.8504, "runtime_sweep_ms": (8.1639, 11.3333)}
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
QWEN3, PHI, MINICPM, WHISPER, VLM = ("qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b",
                                    "minicpm3-4b", "whisper-base", "llama-3.2-vision-90b")
# K3 at qwen2-0.5b's shapes: (name, Tq, Tk, q_offset)
K3_SHAPES = [("prefill_128", 128, 128, 0), ("prefill_1024", 1024, 1024, 0),
             ("decode_0", 1, 2048, 0), ("decode_517", 1, 2048, 517),
             ("decode_2047", 1, 2048, 2047)]
K3_HEADLINE = "decode_517"    # 97 % of the path's launches are decode steps
# K4 at rwkv6-3b's shapes (name, T), each from a carried state written in
# place, as the model calls it
K4_SHAPES = [("prefill_128", 128), ("prefill_1024", 1024), ("decode", 1)]
K4_HEADLINE = "decode"        # 97 % of the path's launches are decode steps
# K4's time-chunk boundaries (offsets from TIME_CHUNK: one launch up to C,
# three past it) and lengths of several chunks with a ragged last one
K4_CHUNK_OFFSETS = (-1, 0, 1)
K4_MULTI_CHUNK = (2, 3)       # T = m C + 5
# tests/test_kernels.py's RG-LRU cases: b, t, w, chunk
RGLRU_CASES = [(2, 128, 64, 32), (1, 256, 128, 128), (3, 64, 32, 64)]
# K5 at recurrentgemma-9b's width (name, T), each from a carried state as the
# model calls it (a prefill's state is its zero cache)
K5_SHAPES = [("prefill_128", 128), ("prefill_1024", 1024), ("decode", 1)]
K5_HEADLINE = "decode"        # 97 % of the path's launches are decode steps
# K4 and K5 of the previous designs (one thread per state column walking all
# of time; one thread per channel, 16 steps of loads in flight): phase 6's
# ms on an H100 80GB HBM3 at 700 W (PERF.md §6), printed beside this run's
# and kept out of the result lines, which carry only this run's measurements
BEFORE_MS = {"wkv6": {"prefill_128": 0.0673, "prefill_1024": 0.7072, "decode": 0.0073},
             "rglru": {"prefill_128": 0.0104, "prefill_1024": 0.0715, "decode": 0.0060}}
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
# and 5000x below the nearer fault; both faults run in every call.
# qwen3-moe-30b-a3b, on an f32 build of 8 layers: the paths differ in K3's
# f32 sums only, unless a top-8 routing choice flips on them (the script
# counts the choices that differ).  Measured on the H100: 4.6e-6 at |logits|
# 4.5 with no choice differing, against 1.63 with the top-k weights not
# renormalised and 1.84 with the decode's gather reading the next expert's
# weights; the limit sits 200x above the sound reading and 1600x below the
# nearer fault; both faults run in every call
LOGITS_ATOL = {QWEN: 0.25, RWKV: 0.125, GRIFFIN: 1e-3, QWEN3: 1e-3}
# the other four new configurations in bf16: decoded logits against the full
# forward, and the kernel path against the plain path, within qwen2-0.5b's
# bf16 limit (4 bf16 ulps at |logits| 8-16).  Measured on the H100 (PERF.md
# §6): against the forward 0.1016 (minicpm3-4b, 62
# layers), 0.0176 (whisper-base), 0.0703 (phi3.5-moe, 8 layers), 0.0859
# (llama-vision, 5 layers); against the plain path 0 (minicpm3-4b: MLA runs
# plain on both), 0.0195, 0.1484 (llama-vision), and 2.15 for phi3.5-moe
# with 26 top-2 routing choices flipped, hence its forced routing
OTHER_ATOL = {MINICPM: 0.25, WHISPER: 0.25, PHI: 0.25, VLM: 0.25}
# the other architectures (ROADMAP D).  qwen3-moe-30b-a3b is served whole
# (30.53 B parameters, 61.09 GB in bf16); its teacher-forced comparison runs
# on an f32 build of its first QWEN3_F32_LAYERS layers (122 GB whole in
# f32).  The other four run a prefill of OTHER_PREFILL tokens and
# OTHER_DECODE decode steps at full width, phi3.5-moe (83.7 GB whole) and
# llama-3.2-vision-90b (181 GB whole) at the depth given here
QWEN3_F32_LAYERS = 8
OTHER_DEPTH = {MINICPM: None, WHISPER: None, PHI: 8, VLM: 5}
OTHER_PREFILL, OTHER_DECODE = 128, 8
VLM_GATES = (0.5, -0.7)       # gate_x, gate_m: non-zero, so the cross path counts
# K3 at the new architectures' shapes: (name, Hq, Hkv, hd, Tq, Tk, q_offset,
# causal).  qwen3-moe: 32 q / 4 kv heads of 128 (group 8); whisper-base: 8/8
# heads of 64, its encoder's self-attention and its decoder's
# cross-attention without a causal mask over 1536 frames; the VLM: 64/8
# heads of 128, cross-attention over 1600 image tokens
K3_NEW_SHAPES = {
    QWEN3: [("prefill_128", 32, 4, 128, 128, 128, 0, True),
            ("prefill_1024", 32, 4, 128, 1024, 1024, 0, True),
            ("decode_517", 32, 4, 128, 1, 2048, 517, True),
            ("decode_2047", 32, 4, 128, 1, 2048, 2047, True)],
    WHISPER: [("encoder_1536", 8, 8, 64, 1536, 1536, 0, False),
              ("cross_128", 8, 8, 64, 128, 1536, 0, False),
              ("cross_1", 8, 8, 64, 1, 1536, 0, False)],
    VLM: [("cross_128", 64, 8, 128, 128, 1600, 0, False),
          ("cross_1", 64, 8, 128, 1, 1600, 0, False)]}
# the plain long prefill on the card, against K3: (config, T, window)
LONG_PREFILL = [(QWEN, 4096, 0), ("gemma3-1b", 4096, 512)]


def fail(msg: str) -> None:
    """Say why the run failed, on both streams (a caller that keeps only
    the end of standard error still sees it), and exit with code 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
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


def queued_us(fn, n: int = 50) -> float:
    """Device us of one call of ``fn`` where calls follow each other, as the
    runtime sweep's slab launches do: ``n`` calls queued behind a device
    sleep long enough for the host to enqueue them all, timed by events on
    the device (back-to-back calls with the device idle would time the
    host's enqueue)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / n


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


def k3_bound(b, hq, hkv, tq, tk, hd, q_offset, elem_bytes=2, causal=True):
    """Least time for one K3 call on these inputs: the larger of the bytes
    it must move (q, k, v rows it reads once, o written once: the visible
    keys only, all Tk without a causal mask) over HBM, and its flops (4*hd
    per visible (head, query, key) pair) over the bf16 tensor-core peak."""
    if causal:
        pairs = sum(min(tk, q_offset + t + 1) for t in range(tq))
        visible = min(tk, q_offset + tq)
    else:
        pairs, visible = tq * tk, tk
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


def time_k3(label, q, k, v, *, q_offset=0, causal=True, window=0) -> dict:
    """K3's device time on these inputs beside its plain version's, its
    bound and its yardstick: SDPA (which the port never calls) over the
    filled slots at decode, else with a causal mask or none as K3 runs.
    The causal mask is K3's window too wherever the window binds nothing
    (a window of 2048 over at most 2048 keys)."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import mha_ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    tq, tk = q.shape[2], k.shape[2]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if causal and tq == 1:
        visible = min(tk, q_offset + 1)
        lib_call = lambda: sdpa(q, k[:, :, :visible], v[:, :, :visible],  # noqa: E731
                                enable_gqa=True)
    else:
        lib_call = lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True)  # noqa: E731
    e_lib = max_err(lib_call(), mha_ref(q, k, v, **kw))
    bnd, by = k3_bound(q.shape[0], q.shape[1], k.shape[1], tq, tk, q.shape[3], q_offset,
                       causal=causal)
    r = {"ms": device_ms(lambda: flash_attention(q, k, v, bq=tq, bk=tk, **kw)),
         "plain_ms": device_ms(lambda: mha_ref(q, k, v, **kw), 5),
         "bound_ms": bnd, "bound_by": by, "library_ms": device_ms(lib_call)}
    print(f"flash_attention {label}: {r['ms']:.4f} ms, bound {bnd:.6f} ms by {by} "
          f"({bnd / r['ms']:.2%} of bound), plain {r['plain_ms']:.4f} ms, library sdpa "
          f"{r['library_ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}x; max_abs_err vs "
          f"plain {e_lib:.3e})")
    return r


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


def warm_profiler() -> None:
    """Queue one-element fills ahead of the work a profiler session is to
    trace, and wait for them.  On the H100 host a session could lose its
    first 32 device records (the first 32 of a runtime sweep's 240 K1
    launches; a drain's first prefill marker), so the traced work's own
    records come after these; ``drop_warmup`` removes what is left of them."""
    x = torch.zeros(1, device="cuda")
    for _ in range(PROFILER_WARMUP):
        x.fill_(1.0)
    torch.cuda.synchronize()


def drop_warmup(spans) -> list[tuple[str, int, int]]:
    """The spans in start order, less the leading fills of ``warm_profiler``
    (they all end before the traced work starts, which begins with another
    kernel)."""
    spans = sorted(spans, key=lambda sp: sp[1])
    i = 0
    while i < len(spans) and "FillFunctor" in spans[i][0]:
        i += 1
    return spans[i:]


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


def kernel_calls(spans, markers, name) -> list[tuple[bool, float]]:
    """(inside a prefill, device us) of each call of the wrapper ``name``:
    a call starts at its first kernel (``<name>_kernel``) and takes in the
    family's later kernels (``<name>_...``, launched after it) up to the next
    call; its time is first start to last end.  A call lies inside a prefill
    when an odd number of markers started before it."""
    marks = sorted(st for _, st, _ in markers)
    calls, i = [], 0
    for fn, st, e in sorted(spans, key=lambda sp: sp[1]):
        if f"{name}_kernel" in fn:
            while i < len(marks) and marks[i] < st:
                i += 1
            calls.append([i % 2 == 1, st, e])
        elif f"{name}_" in fn and calls:
            calls[-1][2] = max(calls[-1][2], e)
    return [(pre, (e - st) / 1e3) for pre, st, e in calls]


def call_summary(us: list[float]) -> dict:
    return {"calls": len(us), "total_ms": sum(us) / 1e3, "mean_us": sum(us) / max(len(us), 1)}


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


def free_port() -> int:
    """A free TCP port on this host, for the process group's rendezvous."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def events_of(events) -> list[tuple]:
    return [(e.step, e.kind, e.worker, e.domain, e.task_uid) for e in events]


def spec_sweep(f, out_kwargs, di, counts, zero_counts) -> dict:
    """The spec-built runtime sweep (``spec.named(SPEC_SWEEP)``) recorded by
    the port's ``TraceRecorder``: one K1 launch per slab, a lattice equal to
    the kwargs path's ``out_kwargs`` bit for bit; the trace written as JSONL,
    read back, replayed from its header's spec alone with the recorded
    stats and event stream, and passed by the port's model checker."""
    from repro_torch import check, spec, trace
    from repro_torch.stencil.jacobi import run_runtime_sweep

    nslabs = f.shape[0] // di
    rec = trace.TraceRecorder()
    torch.cuda.synchronize()
    zero_counts()
    out, stats = run_runtime_sweep(f, di=di, spec=spec.named(SPEC_SWEEP), trace=rec,
                                   device="cuda")
    torch.cuda.synchronize()
    launched = counts()
    unequal = int((out != out_kwargs).sum())
    del out
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "spec_sweep.trace.jsonl"
        trace.TraceWriter(path).write(rec.finish())
        lines = path.read_text().count("\n")
        back = trace.TraceReader(path).read()
    replayed = trace.replay(back)
    same_events = events_of(replayed.executor.events) == events_of(back.events)
    verdict = check.check_trace(back, path="spec_sweep.trace.jsonl")
    print(f"run_runtime_sweep(spec={SPEC_SWEEP!r}, trace=TraceRecorder()): launches "
          f"{launched}, {unequal} elements unequal to the kwargs path; {stats}")
    print(f"spec-built sweep trace: {lines} JSONL lines, {len(back.events)} events; "
          f"replayed from its header: stats match {replayed.matches_recorded}, event "
          f"stream equal {same_events}; check_trace ok {verdict.ok} "
          f"({len(verdict.violations)} violations)")
    if unequal or stats.executed != nslabs or any(
            n != (nslabs if name == "jacobi_sweep" else 0) for name, n in launched.items()):
        fail(f"spec-built sweep: {unequal} unequal elements, executed {stats.executed}, "
             f"launches {launched}, want {nslabs} K1 launches and nothing else")
    if not (replayed.matches_recorded and same_events and verdict.ok):
        fail(f"spec-built sweep trace: replay mismatches {replayed.mismatches()}, "
             f"events equal {same_events}, violations {verdict.violations}")
    return {"spec": SPEC_SWEEP, "launches": launched["jacobi_sweep"],
            "unequal_elements": unequal, "trace_lines": lines,
            "replay_matches": replayed.matches_recorded, "check_ok": verdict.ok}


def spmd_sweeps(f, counts, zero_counts, backend: str = "nccl") -> dict:
    """Both SPMD sweeps as the one rank of a ``backend`` group (NCCL takes
    one rank per card) at the lattice ``f``: each equal to the whole-lattice
    K1 sweep with 0 unequal elements, K1 launched once (contiguous) and once
    per slab (scattered), and the bytes the rank hands to
    ``torch.distributed``, counted by wrapping its calls.  Then each sweep's
    time (CUDA events around back-to-back calls) beside the whole-lattice
    K1's and the padded copy's.  The group is destroyed on the way out."""
    import torch.distributed as dist
    from repro_torch.kernels.jacobi.kernel import jacobi_sweep_cuda
    from repro_torch.stencil import jacobi as stencil

    dist.init_process_group(backend, init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    handed: dict[str, int] = {}
    batch, gather = dist.batch_isend_irecv, dist.all_gather

    def counted_batch(ops):
        for op in ops:
            key = "p2p_sent" if op.op is dist.isend else "p2p_received"
            handed[key] = handed.get(key, 0) + op.tensor.numel() * op.tensor.element_size()
        return batch(ops)

    def counted_gather(tensor_list, tensor, *args, **kw):
        handed["all_gather_in"] = tensor.numel() * tensor.element_size()
        handed["all_gather_out"] = sum(t.numel() * t.element_size() for t in tensor_list)
        return gather(tensor_list, tensor, *args, **kw)

    dist.batch_isend_irecv, dist.all_gather = counted_batch, counted_gather
    try:
        if dist.get_backend() != backend:
            fail(f"the SPMD sweeps ran on {dist.get_backend()}, not {backend}")
        ni, nj, nk = f.shape
        cfg = stencil.JacobiGridConfig(ni=ni, nj=nj, nk=nk)
        bpd = SPMD_BLOCKS_PER_DEV
        whole = jacobi_sweep_cuda(f, di=ni, dj=nj)
        runs = {"contiguous": (stencil.make_contiguous_sweep(cfg), f, 1),
                "scattered": (stencil.make_scattered_sweep(cfg, bpd),
                              stencil.scatter_lattice(f, 1, bpd).contiguous(), bpd)}
        res = {}
        for name, (sweep, local, want) in runs.items():
            handed.clear()
            torch.cuda.synchronize()
            zero_counts()
            out = sweep(local, 1 / 6)
            torch.cuda.synchronize()
            launched = counts()
            if name == "scattered":
                out = stencil.reassemble_scattered(out, 1, bpd)
            unequal = int((out != whole).sum())
            del out
            res[name] = {"launches": launched["jacobi_sweep"], "unequal_elements": unequal,
                         "bytes_handed": dict(handed)}
            print(f"SPMD {name} sweep, 1 {dist.get_backend()} rank"
                  + (f", {bpd} slabs" if name == "scattered" else "")
                  + f": launches {launched}, {unequal} elements unequal to the "
                  f"whole-lattice K1, bytes handed to torch.distributed {dict(handed)}")
            if unequal or any(n != (want if k == "jacobi_sweep" else 0)
                              for k, n in launched.items()):
                fail(f"SPMD {name} sweep: {unequal} unequal elements, launches "
                     f"{launched}, want {want} K1 launches and nothing else")
        buf = torch.empty_like(f)
        zero = torch.zeros_like(f[0])
        whole_ms = time_ms(lambda: jacobi_sweep_cuda(f, di=ni, dj=nj, out=buf), 10)
        copy_ms = time_ms(lambda: torch.cat([zero[None], f, zero[None]]), 10)
        for name, (sweep, local, _) in runs.items():
            res[name]["ms"] = time_ms(lambda: sweep(local, 1 / 6), 10)
        del whole, buf
        bnd = 8 * f.numel() / HBM_BYTES_PER_S * 1e3
        print(f"SPMD sweeps at {tuple(f.shape)}: contiguous {res['contiguous']['ms']:.4f} "
              f"ms, scattered {res['scattered']['ms']:.4f} ms a sweep; whole-lattice K1 "
              f"{whole_ms:.4f} ms, byte bound {bnd:.4f} ms, padded copy "
              f"(torch.cat of the lattice and two planes) {copy_ms:.4f} ms")
        return res | {"backend": dist.get_backend(), "ranks": dist.get_world_size(),
                      "blocks_per_dev": bpd, "whole_lattice_k1_ms": whole_ms,
                      "padded_copy_ms": copy_ms, "bound_ms": bnd}
    finally:
        dist.batch_isend_irecv, dist.all_gather = batch, gather
        dist.destroy_process_group()


def controlled_drains(model, params, cfg, base_tokens, want, counts, zero_counts) -> dict:
    """Two more drains of the serving workload: one with the control plane
    (``control=ControlLoop.full(batch_cap=4)``) and one built from
    ``spec.named("controlled_serving")`` widened to ``REPLICAS`` domains and
    replicas and ``MAX_SEQ``.  Each must launch ``want`` and generate exactly
    ``base_tokens``, the uncontrolled ``locality`` drain's tokens."""
    from repro_torch import spec
    from repro_torch.control import ControlLoop
    from repro_torch.serving.engine import Request, ServingEngine

    s = spec.named("controlled_serving")
    s = dataclasses.replace(s, num_domains=REPLICAS, serving=dataclasses.replace(
        s.serving, num_replicas=REPLICAS, max_seq=MAX_SEQ))
    engines = {
        "control": lambda: ServingEngine(model, params, num_replicas=REPLICAS,
                                         max_seq=MAX_SEQ, policy="locality",
                                         control=ControlLoop.full(batch_cap=4)),
        "spec": lambda: ServingEngine(model, params, spec=s)}
    res = {}
    for label, make in engines.items():
        engine = make()
        for req in requests(cfg, Request):
            engine.submit(req)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        done = engine.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        tokens = {r.uid: tuple(r.out_tokens) for r in done}
        generated = sum(len(t) for t in tokens.values())
        res[label] = {"wall_s": wall, "tokens_per_s": generated / wall,
                      "launches": launched, "stats": vars(engine.stats),
                      "steps": engine.runtime.step_count,
                      "tokens_identical": tokens == base_tokens}
        print(f"{QWEN} {label}-built drain: {engine.stats}, wall {wall:.4f} s, "
              f"{generated / wall:.2f} tokens/s, {engine.runtime.step_count} scheduling "
              f"rounds, launches {launched}; tokens identical to the locality drain "
              f"{tokens == base_tokens}")
        if any(n != want.get(name, 0) for name, n in launched.items()):
            fail(f"{QWEN} {label}-built drain: launches {launched}, want {want}")
        if tokens != base_tokens:
            fail(f"{QWEN} {label}-built drain generated other tokens than the "
                 f"uncontrolled locality drain")
        del engine
    return res


class RoutingLog:
    """Within ``with``: every MoE block's expert choices, one (tokens, k)
    tensor of sorted expert indices per call, in call order (the port's
    ``moe.route`` wrapped; restored on the way out).  With ``force`` (the
    calls of another log), each call's choices are replaced by the forced
    call's and weighted by this run's own gates: teacher-forced routing."""

    def __init__(self, force: list | None = None):
        self.force = force

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.sound, self.calls = moe, moe.route, []

        def recording(p, xg, cfg):
            gates, topv, topi = self.sound(p, xg, cfg)
            if self.force is not None:
                topi = self.force[len(self.calls)].reshape(topi.shape)
                topv = torch.gather(gates, -1, topi)
                topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
            self.calls.append(topi.reshape(-1, topi.shape[-1]).sort(-1).values)
            return gates, topv, topi

        moe.route = recording
        return self

    def __exit__(self, *exc):
        self.moe.route = self.sound


def routes_differ(a: list, b: list) -> int:
    """(token, layer) pairs whose chosen experts differ between two runs'
    calls, matched call for call."""
    if [x.shape for x in a] != [y.shape for y in b]:
        fail(f"routing logs of different shapes: {len(a)} and {len(b)} calls")
    return sum(int((x != y).any(-1).sum()) for x, y in zip(a, b))


def k3_new_shapes(gen, dev, k3_check) -> tuple[dict, float, float]:
    """K3 against ``mha_ref`` per element at ``K3_NEW_SHAPES``, in bf16 (as
    the model passes them: (B, T, H, hd) projections as (B, H, T, hd)
    views) and in f32.  Returns the bf16 inputs by (arch, name) for phase 6
    and the largest bf16 and f32 errors."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import mha_ref

    inputs, worst = {}, {torch.bfloat16: 0.0, torch.float32: 0.0}
    for arch, shapes in K3_NEW_SHAPES.items():
        for name, hq, hkv, hd, tq, tk, qo, causal in shapes:
            for dtype, tol in ((torch.bfloat16, K3_BF16_TOL), (torch.float32, K3_F32_TOL)):
                q = torch.randn((1, tq, hq, hd), generator=gen, device=dev).to(dtype)
                k, v = (torch.randn((1, tk, hkv, hd), generator=gen, device=dev).to(dtype)
                        for _ in range(2))
                q, k, v = (x.transpose(1, 2) for x in (q, k, v))
                kw = dict(causal=causal, q_offset=qo)
                e = k3_check(f"{str(dtype).split('.')[-1]} {arch} {name} q {tuple(q.shape)} "
                             f"kv {tuple(k.shape)} q_offset={qo} causal={causal}",
                             flash_attention(q, k, v, bq=tq, bk=tk, **kw),
                             mha_ref(q, k, v, **kw), tol)
                worst[dtype] = max(worst[dtype], e)
                if dtype is torch.bfloat16:
                    inputs[arch, name] = (q, k, v, qo, causal)
    return inputs, worst[torch.bfloat16], worst[torch.float32]


def long_prefill(gen, dev, k3_check) -> dict:
    """B8's rest on the card: the plain ``chunked_attention`` (qwen2-0.5b's
    heads) and ``banded_attention`` (gemma3-1b's heads and window) at 4096
    tokens on CUDA tensors, against K3 per element.  The plain forms run on
    f32 copies of the same bf16 values and are rounded once to bf16, as
    ``mha_ref``'s result is; run in bf16 they round the softmax weights to
    bf16 before P.V (as the reference does, and K3 does not), and that
    error is printed beside."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.models import attention

    res = {}
    for arch, t, win in LONG_PREFILL:
        cfg = get_config(arch)
        h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = torch.randn((1, t, h, hd), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((1, t, kvh, hd), generator=gen, device=dev).bfloat16()
                for _ in range(2))
        got = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              window=win, bq=t, bk=t)
        if win:
            name, plain = "banded_attention", lambda *x: attention.banded_attention(*x, 0, win)
        else:
            name, plain = "chunked_attention", lambda *x: attention.chunked_attention(*x, 0)
        want = plain(q.float(), k.float(), v.float()).bfloat16()
        in_bf16 = plain(q, k, v)
        want, in_bf16 = (x.reshape(1, t, h, hd).transpose(1, 2) for x in (want, in_bf16))
        e = k3_check(f"bf16 {name} (plain, on f32 copies) at {arch}'s heads {(h, kvh, hd)}, "
                     f"T {t}, window {win}, vs K3", got, want, K3_BF16_TOL)
        e_bf16 = max_err(got, in_bf16)
        print(f"{name} run in bf16 (softmax weights rounded to bf16 before P.V) vs K3: "
              f"max_abs_err {e_bf16:.3e}")
        res[name] = {"arch": arch, "t": t, "window": win, "max_abs_err": e,
                     "max_abs_err_run_in_bf16": e_bf16}
    return res


def moe_split(params, cfg, dev, prompt_lens, gen) -> dict:
    """Device time of the MoE block's phases (router and top-k, dispatch,
    expert products, combine; the whole block beside them, whose rest is
    the load-balance loss) on layer 0's experts, CUDA events behind a
    device sleep: at a decode step (one token: the gather) and at each of
    the drain's prompt lengths (the batched product).  Per drain: the
    decode time x layers x decode steps, plus the prefills x layers."""
    from repro_torch.models import moe

    p = params["stack"][0]["moe"]
    dtype = p["w_gate"].dtype

    def phases(t, iters):
        x = torch.randn((1, t, cfg.d_model), generator=gen, device=dev).to(dtype)
        xg = moe.group(x, moe.num_groups_for(1, t))
        _, topv, topi = moe.route(p, xg, cfg)
        plan = moe.dispatch(xg, topv, topi, cfg)
        y = moe.expert_products(p, plan)
        return {"route": device_ms(lambda: moe.route(p, xg, cfg), iters),
                "dispatch": device_ms(lambda: moe.dispatch(xg, topv, topi, cfg), iters),
                "expert_products": device_ms(lambda: moe.expert_products(p, plan), iters),
                "combine": device_ms(lambda: moe.combine(plan, y), iters),
                "block": device_ms(lambda: moe.moe_block(p, x, cfg), iters)}

    m = cfg.moe
    decode = phases(1, 20)
    prefill = [phases(t, 5) for t in prompt_lens]
    steps = len(prompt_lens) * MAX_NEW
    per_drain = {name: cfg.num_layers * (decode[name] * steps + sum(pf[name] for pf in prefill))
                 for name in decode}
    chosen = 3 * m.top_k * cfg.d_model * m.d_ff_expert * torch.finfo(dtype).bits // 8
    bnd = bound(chosen, 6 * m.top_k * cfg.d_model * m.d_ff_expert, BF16_FLOPS_PER_S)
    print(f"{cfg.name} MoE block, layer 0, decode (1 token, gather): " + ", ".join(
        f"{k} {v * 1e3:.2f} us" for k, v in decode.items())
        + f"; expert products bound {bnd[0] * 1e3:.2f} us by {bnd[1]} (the {m.top_k} "
        f"chosen experts' weights, {chosen / 1e6:.1f} MB)")
    print(f"{cfg.name} MoE block per drain ({len(prompt_lens)} prefills, {steps} decode "
          f"steps, {cfg.num_layers} layers): " + ", ".join(
              f"{k} {v:.1f} ms" for k, v in per_drain.items()))
    return {"decode_ms": decode, "prefill_ms_by_length": dict(zip(prompt_lens, prefill)),
            "per_drain_ms": per_drain, "decode_expert_products_bound_ms": bnd[0]}


def attention_calls(cfg, frames: bool) -> int:
    """K3 launches of one forward, prefill or decode call of ``cfg``: one
    per attention layer (none for MLA, which runs its plain path), one
    more per "cross" layer, and one per encoder layer when frames are
    encoded."""
    per = sum((cfg.mla is None) + (kind == "cross") for kind in cfg.layer_kinds())
    return per + (cfg.encoder.num_layers if frames and cfg.encoder is not None else 0)


def other_archs(dev, build, counts, zero_counts, limits) -> dict:
    """The four other new configurations at full width (depth cut as
    ``OTHER_DEPTH`` says): a prefill of ``OTHER_PREFILL`` tokens (whisper
    with its frames, the VLM with its image tokens and gates set non-zero,
    all from seed 0), then ``OTHER_DECODE`` teacher-forced decode steps.
    Their logits must equal the full forward's within ``limits[arch]`` (the
    MoE config at a capacity factor of E / k, where nothing can drop) and
    the plain path's (``use_kernel=False``) at the published capacity
    factor; K3 must carry every attention call but MLA's.  For an MoE
    config the kernel path takes the plain path's expert choices
    (``RoutingLog(force=...)``), as the teacher-forced comparisons take its
    tokens: the plain path rounds attention's softmax weights to bf16 and K3
    does not, and a top-k choice flips on such differences.  How many
    choices differ unforced, and that run's gap, are printed."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    res = {}
    n = OTHER_PREFILL + OTHER_DECODE
    for arch, depth in OTHER_DEPTH.items():
        cfg = get_config(arch)
        if depth:
            print(f"{arch}: cut to {depth} of {cfg.num_layers} layers (the whole model "
                  f"does not fit on one card)")
            cfg = dataclasses.replace(cfg, num_layers=depth)
        model, params = build(arch, cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, n),
                               device=dev)[None]
        extras = {}
        if cfg.encoder is not None:
            extras["frames"] = (0.1 * torch.randn(
                (1, cfg.encoder.num_frames, cfg.encoder.d_model), generator=gen,
                device=dev)).to(model.dtype)
        if cfg.vision is not None:
            extras["vision"] = (0.1 * torch.randn(
                (1, cfg.vision.num_image_tokens, cfg.d_model), generator=gen,
                device=dev)).to(model.dtype)
            for layer in params["stack"]:
                if "gate_x" in layer:
                    layer["gate_x"].fill_(VLM_GATES[0])
                    layer["gate_m"].fill_(VLM_GATES[1])
        no_drop = cfg
        if cfg.moe is not None:
            no_drop = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
            print(f"{arch}: forward against decode at capacity factor "
                  f"{no_drop.moe.capacity_factor} (E / k: an expert takes every token; "
                  f"published {cfg.moe.capacity_factor})")
        want_k3 = attention_calls(cfg, True) + OTHER_DECODE * attention_calls(cfg, False)

        def stepwise(m, want):
            """Prefill, then the teacher-forced decode steps: the logits of
            positions OTHER_PREFILL - 1 .. n - 1, f32."""
            torch.cuda.synchronize()
            zero_counts()
            caches = m.init_cache(1, n)
            logits, caches = m.prefill(params, {"tokens": toks[:, :OTHER_PREFILL], **extras},
                                       caches)
            rows = [logits[:, -1]]
            for pos in range(OTHER_PREFILL, n):
                logits, caches = m.decode_step(params, toks[:, pos:pos + 1], pos, caches)
                rows.append(logits[:, -1])
            torch.cuda.synchronize()
            if counts()["flash_attention"] != want:
                fail(f"{arch}: prefill and decode launched {counts()}, want {want} K3")
            return torch.cat(rows).float(), counts()

        kernel_nd = build_model(no_drop, device=dev)
        with RoutingLog() as log:
            zero_counts()
            full = kernel_nd.forward(params, toks, extras=extras)[0][0, OTHER_PREFILL - 1:]
            torch.cuda.synchronize()
            fwd_launches = counts()
            steps_nd, launched_nd = stepwise(kernel_nd, want_k3)
        if fwd_launches["flash_attention"] != attention_calls(cfg, True) or \
                fwd_launches["attention_plain_calls"]:
            fail(f"{arch}: the full forward launched {fwd_launches}")
        gap_forward = float((steps_nd - full.float()).abs().max())
        flips_forward = None
        if cfg.moe is not None:
            layers = cfg.num_layers
            fwd, rest = log.calls[:layers], log.calls[layers:]
            stepped = [torch.cat([rest[i]] + [rest[layers * (1 + s) + i]
                                              for s in range(OTHER_DECODE)])
                       for i in range(layers)]
            flips_forward = routes_differ([x[OTHER_PREFILL - 1:] for x in fwd],
                                          [x[OTHER_PREFILL - 1:] for x in stepped])
        steps_k, launched_k = steps_nd, launched_nd
        with RoutingLog() as log_k:
            if no_drop is not cfg:
                steps_k, launched_k = stepwise(build_model(cfg, device=dev), want_k3)
        with RoutingLog() as log_p:
            steps_p, launched_p = stepwise(build_model(cfg, device=dev, use_kernel=False), 0)
        gap_unforced = float((steps_k - steps_p).abs().max())
        flips_plain, steps_kf = None, steps_k
        if cfg.moe is not None:
            flips_plain = routes_differ(log_k.calls, log_p.calls)
            with RoutingLog(force=log_p.calls):
                steps_kf, _ = stepwise(build_model(cfg, device=dev), want_k3)
        gap_plain = float((steps_kf - steps_p).abs().max())
        limit = limits[arch]
        print(f"{arch}: prefill {OTHER_PREFILL} + {OTHER_DECODE} decode steps "
              f"(|logits| up to {float(full.float().abs().max()):.3f}): max_abs_err vs the "
              f"full forward {gap_forward:.6f}, vs the plain path {gap_plain:.6f}"
              + ("" if cfg.moe is None else " with its expert choices") + f"; limit "
              f"{limit}; K3 launches {launched_k['flash_attention']} (want {want_k3}), plain "
              f"path: {launched_p['attention_plain_calls']} plain attention calls, "
              f"{launched_p['flash_attention']} K3"
              + ("" if cfg.moe is None else f"; (token, layer) routing choices that differ: "
                 f"{flips_forward} forward vs decode, {flips_plain} kernel vs plain path, "
                 f"whose logits differ by {gap_unforced:.6f} unforced"))
        if launched_p["flash_attention"] or not all(
                bool(x.isfinite().all()) for x in (full, steps_nd, steps_k, steps_kf, steps_p)):
            fail(f"{arch}: the plain path launched K3 or logits are not finite")
        if gap_forward > limit or gap_plain > limit:
            fail(f"{arch}: decoded logits differ from the full forward by {gap_forward} "
                 f"and from the plain path by {gap_plain}, limit {limit}")
        res[arch] = {"layers": cfg.num_layers, "cut_from": get_config(arch).num_layers,
                     "params": sum(x.numel() for x in leaves(params)),
                     "max_abs_err_vs_forward": gap_forward, "max_abs_err_vs_plain": gap_plain,
                     "max_abs_err_vs_plain_unforced": gap_unforced, "limit": limit,
                     "k3_launches": launched_k["flash_attention"],
                     "routes_differ_forward": flips_forward, "routes_differ_plain": flips_plain}
        del model, params, kernel_nd
        free_device_memory()
    return res


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
    from repro_torch.kernels.jacobi import kernel as k12_kernel
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
    from repro_torch.models import attention as attn_model
    from repro_torch.models import moe as moe_model
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
    # and the plain attention forms, where the model's attention block
    # reaches them (this script's own comparisons hold their own references)
    plain_attn = {"calls": 0}

    def counted_attention(fn):
        def counted(*args, **kw):
            plain_attn["calls"] += 1
            return fn(*args, **kw)
        return counted

    for fname in ("direct_attention", "decode_attention", "chunked_attention",
                  "banded_attention"):
        setattr(attn_model, fname, counted_attention(getattr(attn_model, fname)))

    def zero_counts():
        jacobi_sweep_cuda.launches = jacobi_two_step_cuda.launches = 0
        flash_attention.launches = wkv6_cuda.launches = plain_wkv["calls"] = 0
        rglru_scan_cuda.launches = plain_rglru["calls"] = plain_attn["calls"] = 0

    def counts():
        return {"jacobi_sweep": jacobi_sweep_cuda.launches,
                "jacobi_two_step": jacobi_two_step_cuda.launches,
                "flash_attention": flash_attention.launches,
                "wkv6": wkv6_cuda.launches, "wkv6_plain_calls": plain_wkv["calls"],
                "rglru": rglru_scan_cuda.launches,
                "rglru_plain_calls": plain_rglru["calls"],
                "attention_plain_calls": plain_attn["calls"]}

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

    for two_step, name in ((False, "jacobi_sweep (K1)"), (True, "jacobi_two_step (K2)")):
        g = k12_kernel.geometry(two_step)
        print(f"{name}: instance {g['variant']} of {k12_kernel.variants(two_step)}, tile "
              f"{g['tj']} x {g['tk']}, {g['stages']} ring stages, {g['threads']} threads, "
              f"{g['smem_bytes']} B dynamic shared memory, {g['blocks_per_sm']} blocks per "
              f"SM ({g['blocks_per_sm_copy']} for the 4-byte-copy instance), i chunks of "
              f"{g['chunk']} rows")
    probe = torch.empty((SLAB_ROWS, *LATTICE[1:]), device=dev)
    print(f"jacobi: one tensor-map encode takes {k12_kernel.encode_ns(probe) / 1e3:.3f} us "
          f"of host time")
    del probe

    print(f"wkv6: time chunks of {wkv_kernel.TIME_CHUNK} steps (a call up to one chunk "
          f"is one launch, a longer one three); rglru: {rglru_kernel.stage_steps()} "
          f"steps a shared-memory stage")

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

    # K1 and K2 bit for bit: unequal elements (limit 0) at every shape below
    unequal = {"jacobi_sweep": 0, "jacobi_two_step": 0}

    def k12_exact(name, got, want, label):
        n = int((got != want).sum())
        unequal[name] += n
        if n:
            print(f"{name} {label}: {n} unequal elements")

    f = torch.randn(LATTICE, generator=gen, device=dev)
    plain = ref.jacobi_sweep_ref(f)
    got = jacobi_sweep_cuda(f)
    e = max_err(got, plain)
    k12_exact("jacobi_sweep", got, plain, LATTICE)
    errs["jacobi_sweep"] = max(errs["jacobi_sweep"], e)
    print(f"K1 {LATTICE}: max_abs_err {e:.3e}, {unequal['jacobi_sweep']} unequal elements")
    want = ref.jacobi_sweep_ref(plain)
    got = jacobi_two_step_cuda(f)
    e = max_err(got, want)
    k12_exact("jacobi_two_step", got, want, LATTICE)
    errs["jacobi_two_step"] = max(errs["jacobi_two_step"], e)
    print(f"K2 {LATTICE}: max_abs_err {e:.3e}, {unequal['jacobi_two_step']} unequal elements")
    del got, want
    # the runtime sweep's first and last slab: the tensor map's zero fill is
    # the missing halo plane
    for rows in ((0, SLAB_ROWS), (LATTICE[0] - SLAB_ROWS, LATTICE[0])):
        k12_exact("jacobi_sweep",
                  jacobi_sweep_cuda(f, di=SLAB_ROWS, dj=LATTICE[1], rows=rows),
                  plain[rows[0]:rows[1]], f"rows {rows}")
    print(f"K1 slabs at both lattice edges: {unequal['jacobi_sweep']} unequal elements so far")
    for two_step, name, kern, plain_fn in (
            (False, "jacobi_sweep", jacobi_sweep_cuda, ref.jacobi_sweep_ref),
            (True, "jacobi_two_step", jacobi_two_step_cuda, ref.jacobi_two_step_ref)):
        g = k12_kernel.geometry(two_step)
        shapes = [(7, tiles * g["tj"] + dj, g["tk"] + dk) for tiles in (1, 2)
                  for dj in TILE_J_OFFSETS for dk in TILE_K_OFFSETS]
        shapes += SMALL_LATTICES
        shapes += [(ni, 9, 124) for ni in (g["chunk"] - 1, g["chunk"], g["chunk"] + 1,
                                           2 * g["chunk"] + 1)]
        for shape in shapes:
            x = torch.randn(shape, generator=gen, device=dev)
            # di, dj: the whole lattice (the wrappers check divisibility only)
            k12_exact(name, kern(x, 0.25, shape[0], shape[1]), plain_fn(x, 0.25), shape)
        print(f"{name}: {len(shapes)} shapes around its {g['tj']} x {g['tk']} tile "
              f"and {g['chunk']}-row i chunk ({sum(1 for sh in shapes if sh[2] % 4)} "
              f"with nk not a multiple of 4, through the 4-byte copies): "
              f"{unequal[name]} unequal elements in all")
    torch.cuda.synchronize()
    if errs["jacobi_sweep"] > K1_ATOL or errs["jacobi_two_step"] > K2_ATOL \
            or any(unequal.values()):
        fail(f"kernel disagrees with its plain version: {errs}, unequal {unequal}")

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
    # the new architectures' shapes: head dim 128 at group 8, attention
    # without a causal mask, cross-attention with Tk != Tq
    k3n_inputs, e_bf16, e_f32 = k3_new_shapes(gen, dev, k3_check)
    k3_bf16, k3_f32 = max(k3_bf16, e_bf16), max(k3_f32, e_f32)
    torch.cuda.synchronize()
    if k3_worst > 1.0:
        fail(f"K3 disagrees with mha_ref: an element used {k3_worst:.3f} of its limit")
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
    # either side of the time chunk's boundary (one launch, then three) and
    # several chunks with a ragged last one, from zero and from a carried state
    c4 = wkv_kernel.TIME_CHUNK
    for t in [c4 + d for d in K4_CHUNK_OFFSETS] + [m * c4 + 5 for m in K4_MULTI_CHUNK]:
        x = wkv_model_inputs(t)
        k4_check(f"bf16 T {t} (time chunk {c4}) from zero", wkv6_cuda(*x, chunk=t),
                 wkv6_ref(*x))
        k4_check(f"bf16 T {t} (time chunk {c4}) from a prefill's state",
                 wkv6_cuda(*x, chunk=t, s0=prefill_state.clone()),
                 wkv6_ref(*x, prefill_state))
    # the three-kernel path at the narrower compiled head widths (the model
    # runs hd 64 only), bf16 from a carried state
    t = K4_MULTI_CHUNK[-1] * c4 + 5
    for hdw in wkv_kernel.HEAD_DIMS[:-1]:
        shape = (2, t, 3, hdw)
        r, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16() for _ in range(3))
        w = torch.exp(-torch.exp(-6.0 + torch.randn(shape, generator=gen, device=dev)))
        u = 0.5 * torch.rand((3, hdw), generator=gen, device=dev)
        s0 = 0.5 * torch.randn((2, 3, hdw, hdw), generator=gen, device=dev)
        k4_check(f"bf16 {shape} (time chunk {c4}) from a state",
                 wkv6_cuda(r, k, v, w, u, chunk=t, s0=s0.clone()),
                 wkv6_ref(r, k, v, w, u, s0))
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
    # either side of a stage and past the ring's wrap, at the model's width
    # (16-byte copies) and one past it (4-byte copies, a partial strip)
    st5 = rglru_kernel.stage_steps()
    for width in (gw, gw + 1):
        for t in (st5 - 1, st5, st5 + 1, 6 * st5 + 1):
            a = 0.5 + 0.499 * torch.rand((1, t, width), generator=gen, device=dev)
            bb = 0.1 * torch.randn((1, t, width), generator=gen, device=dev)
            h0 = torch.randn((1, width), generator=gen, device=dev)
            k5_check(f"f32 {(1, t, width)} across stages", rglru_scan_cuda(a, bb, chunk=t, h0=h0),
                     rglru_scan_ref(a, bb, h0))
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
    stamp("3b")
    spec_main = spec_sweep(f, out, di, counts, zero_counts)
    del out
    stamp("3c")
    spmd = spmd_sweeps(f, counts, zero_counts)
    stamp("3d")

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
        # a device sleep of one cycle before and after each prefill marks the
        # prefill calls' records in the trace
        prefills = []

        def marked_prefill(*args):
            prefills.append(1)
            torch.cuda._sleep(1)
            out = model.prefill(*args)
            torch.cuda._sleep(1)
            return out

        # the prefill/decode split below rests on two markers per prefill and
        # on one prefill call per layer and request of each kernel: a session
        # whose trace lacks any record of these is run again, at most twice
        for attempt in range(3):
            engine = new_engine("locality")
            for rep in engine.replicas:
                rep._prefill = marked_prefill
            prefills.clear()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                warm_profiler()
                zero_counts()
                t0 = time.perf_counter()
                engine.run_until_drained()
                torch.cuda.synchronize()
                prof_wall_ms = (time.perf_counter() - t0) * 1e3
            prof_launches = counts()
            t0 = time.perf_counter()
            spans = drop_warmup(device_spans(prof))
            markers = [sp for sp in spans if sp[0] == marker_name]
            spans = [sp for sp in spans if sp[0] != marker_name]
            busy = busy_ms(spans)
            in_drain = {}
            for name in want:
                calls = kernel_calls(spans, markers, name)
                in_drain[name] = call_summary([us for _, us in calls]) | {
                    kind: call_summary([us for pre, us in calls if pre == (kind == "prefill")])
                    for kind in ("prefill", "decode")}
            prefill_calls = {name: m["prefill"]["calls"] for name, m in in_drain.items()}
            print(f"profiled drain, attempt {attempt + 1}: {len(prefills)} prefills, "
                  f"{len(markers)} prefill markers ({marker_name}), prefill calls "
                  f"{prefill_calls}, reversed records "
                  f"{sum(1 for _, st, e in spans + markers if e < st)}")
            if len(prefills) == N_REQUESTS and len(markers) == 2 * len(prefills) and all(
                    n == want[name] // (1 + MAX_NEW) for name, n in prefill_calls.items()):
                break
        else:
            want_prefill = {name: n // (1 + MAX_NEW) for name, n in want.items()}
            fail(f"{arch} profiled drain: {len(prefills)} prefills, {len(markers)} "
                 f"markers, prefill calls {prefill_calls}; want {N_REQUESTS}, two "
                 f"markers each and {want_prefill}")
        print(f"profiler: {len(spans)} device records read in "
              f"{time.perf_counter() - t0:.1f} s")
        if busy <= 0 or not path_ok(prof_launches, want):
            fail(f"{arch} profiled drain: device busy {busy} ms, launches {prof_launches}")
        idle_share = 1 - busy / prof_wall_ms
        print(f"{arch} profiled drain (locality): wall {prof_wall_ms:.4f} ms, device "
              f"busy {busy:.4f} ms, idle share {idle_share:.4f}")
        print("device time by function over the profiled drain:")
        print("\n".join(top_kernels(spans)))
        for name in want:
            print(f"{arch} profiled drain, {name}: " + "; ".join(
                f"{kind} {m['calls']} calls, {m['total_ms']:.3f} ms, {m['mean_us']:.3f} us per call"
                for kind, m in (("all", in_drain[name]), ("prefill", in_drain[name]["prefill"]),
                                ("decode", in_drain[name]["decode"])))
                + f" ({in_drain[name]['total_ms'] / busy:.1%} of device busy time)")
        del engine, prof, spans
        result = {p: {k: v for k, v in m.items() if k != "stats"}
                  | {"stats": vars(m["stats"])} for p, m in metrics.items()}
        result.update(idle_share=idle_share, kernels_in_drain=in_drain)
        return model, params, result, outs["locality"]

    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            warm_profiler()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        names = [name for name, _, _ in drop_warmup(device_spans(prof))]
        if names:
            break
    else:
        fail("the profiler recorded no device sleep in 3 sessions")
    marker_name = names[-1]                     # the prefill markers' kernel
    print(f"profiler: prefill markers are {marker_name}")

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
    model, params, serving[QWEN], qwen_tokens = serve(QWEN, cfg)
    stamp("4b")
    serving[QWEN]["controlled"] = controlled_drains(
        model, params, cfg, qwen_tokens, path_launches(cfg, N_REQUESTS), counts,
        zero_counts)
    serving[QWEN].update(teacher_forced(QWEN, cfg, model, params))
    del model, params
    free_device_memory()

    stamp(5)
    model, params, serving[RWKV], _ = serve(RWKV, rcfg)
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
    model, params, serving[GRIFFIN], _ = serve(GRIFFIN, gcfg)
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

    stamp("5c")
    # qwen3-moe-30b-a3b whole in bf16, once every earlier model is freed
    qcfg = get_config(QWEN3)
    torch.cuda.reset_peak_memory_stats()
    model, params, serving[QWEN3], _ = serve(QWEN3, qcfg)
    peak = torch.cuda.max_memory_allocated()
    print(f"{QWEN3} bf16, served whole: peak device memory {peak} B ({peak / 1e9:.2f} GB)")
    serving[QWEN3]["peak_bytes"] = peak
    serving[QWEN3]["moe_split"] = moe_split(
        params, qcfg, dev, sorted(len(r.tokens) for r in requests(qcfg, Request)), gen)
    del model, params
    free_device_memory()
    # the teacher-forced comparison on an f32 build of its first layers, with
    # two planted faults in the MoE block of the plain path
    f32cfg = dataclasses.replace(qcfg, dtype="float32", num_layers=QWEN3_F32_LAYERS)
    print(f"{QWEN3} f32 build: cut to {QWEN3_F32_LAYERS} of {qcfg.num_layers} layers "
          f"(122 GB whole in f32)")
    model, params = build(QWEN3, f32cfg)
    route, products = moe_model.route, moe_model.expert_products

    def unnormalised(p, xg, c):
        gates, _, topi = route(p, xg, c)
        return gates, torch.gather(gates, -1, topi), topi

    def next_expert(p, plan):
        if "idx" in plan:
            plan = dict(plan, idx=(plan["idx"] + 1) % f32cfg.moe.num_experts)
        return products(p, plan)

    faults = {"top-k weights not renormalised": (moe_model, "route", unnormalised),
              "decode gathers the next expert's weights": (moe_model, "expert_products",
                                                           next_expert)}
    with RoutingLog() as log:
        serving[QWEN3].update(teacher_forced(QWEN3, f32cfg, model, params, faults))
    calls = QWEN3_F32_LAYERS * (1 + MAX_NEW)
    flips = routes_differ(log.calls[:calls], log.calls[calls:2 * calls])
    print(f"{QWEN3} teacher-forced: (token, layer) routing choices that differ between "
          f"the kernel and the plain path: {flips} of "
          f"{sum(x.shape[0] for x in log.calls[:calls])}")
    serving[QWEN3]["teacher_forced_routes_differ"] = flips
    del model, params
    free_device_memory()

    stamp("5d")
    serving["other_architectures"] = other_archs(dev, build, counts, zero_counts, OTHER_ATOL)

    stamp("5e")
    long_plain = long_prefill(gen, dev, k3_check)
    torch.cuda.synchronize()
    if k3_worst > 1.0:
        fail(f"the plain long prefill disagrees with K3: an element used {k3_worst:.3f} "
             f"of its limit")

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

    # one slab launch of the runtime sweep: 10 rows straight from the
    # lattice into their place.  Each timed call takes the next of slabs 1-
    # 99 (rows 10-1000), so its 17 MB of input do not sit in the 50 MB L2
    # from the call before, as they do not in the runtime sweep.  Bound: the
    # rows read once and written once (8 B a site); yardstick: conv3d over
    # the rows and their halo planes
    slab_sites = SLAB_ROWS * LATTICE[1] * LATTICE[2]
    slab_bound = bound(8 * slab_sites, 6 * slab_sites, F32_FLOPS_PER_S)
    starts = itertools.cycle(range(SLAB_ROWS, 100 * SLAB_ROWS, SLAB_ROWS))

    def halo_of(r):
        return f[r - 1:r + SLAB_ROWS + 1]

    def slab_call():
        r = next(starts)
        jacobi_sweep_cuda(f, di=SLAB_ROWS, dj=LATTICE[1], out=buf[r:r + SLAB_ROWS],
                          rows=(r, r + SLAB_ROWS))

    def slab_conv(r=None):
        h = halo_of(next(starts) if r is None else r)
        return conv(h.view(1, 1, *h.shape), w, padding=(0, 1, 1))

    e_slab = max_err(slab_conv(SLAB_ROWS)[0, 0],
                     ref.jacobi_sweep_ref(halo_of(SLAB_ROWS))[1:-1])
    slab = {"rows": SLAB_ROWS, "ms": queued_us(slab_call) / 1e3,
            "ms_back_to_back": time_ms(slab_call, 50),
            "plain_ms": queued_us(
                lambda: ref.jacobi_sweep_ref(halo_of(next(starts)))[1:-1], 20) / 1e3,
            "bound_ms": slab_bound[0], "bound_by": slab_bound[1],
            "library_ms": queued_us(slab_conv) / 1e3}

    # the runtime sweep (host-driven, 240 launches), from the kwargs and from
    # the spec: CUDA events around the whole drain, then one drain under the
    # profiler for K1's device time and the card's idle share
    from repro_torch import spec as port_spec
    from torch.profiler import ProfilerActivity, profile

    def timed_sweep(label, **kw):
        sweep_ms = time_ms(lambda: run_runtime_sweep(f, di=di, **kw), 3, warmup=1)
        for attempt in range(3):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                warm_profiler()
                t0 = time.perf_counter()
                run_runtime_sweep(f, di=di, **kw)
                torch.cuda.synchronize()
                prof_wall_ms = (time.perf_counter() - t0) * 1e3
            spans = drop_warmup(device_spans(prof))
            k1_spans = [(e - st) / 1e6 for name, st, e in spans
                        if "jacobi_sweep_kernel" in name]
            print(f"profiled {label}, attempt {attempt + 1}: {len(k1_spans)} of "
                  f"{nslabs} K1 launches recorded")
            if len(k1_spans) == nslabs:
                break
        else:
            fail(f"profiled {label}: {len(k1_spans)} K1 records, want {nslabs}")
        busy = busy_ms(spans)
        return {"wall_ms": sweep_ms, "profiled_wall_ms": prof_wall_ms,
                "device_ms": sum(k1_spans), "device_busy_ms": busy,
                "idle_share": 1 - busy / prof_wall_ms, "k1_records": len(k1_spans)}

    runtime = timed_sweep("runtime sweep", num_domains=domains, workers_per_domain=wpd)
    spec_runtime = timed_sweep(f"spec-built runtime sweep ({SPEC_SWEEP})",
                               spec=port_spec.named(SPEC_SWEEP))
    sweep_ms, prof_wall_ms, busy = (runtime["wall_ms"], runtime["profiled_wall_ms"],
                                    runtime["device_busy_ms"])

    before = JACOBI_BEFORE
    for name in ("jacobi_sweep", "jacobi_two_step"):
        gbs = io_bytes / (ms[name] * 1e-3) / 1e9
        print(f"{name} {LATTICE}: {ms[name]:.4f} ms (PR 16: {before[name + '_ms']} ms, "
              f"{before[name + '_ms'] / ms[name]:.2f}x), {gbs:.1f} GB/s, bound "
              f"{jb[name][0]:.4f} ms ({jb[name][0] / ms[name]:.1%} of bound), "
              f"plain {plain_ms[name]:.4f} ms, library {library_ms[name]:.4f} ms")
    print(f"jacobi_sweep slab of {SLAB_ROWS} rows of {LATTICE}: {slab['ms'] * 1e3:.2f} us of "
          f"device time a launch (queued), {slab['ms_back_to_back'] * 1e3:.2f} us back to "
          f"back (PR 16: {before['slab_us']} us, timed back to back), bound "
          f"{slab['bound_ms'] * 1e3:.2f} us ({slab['bound_ms'] / slab['ms']:.1%} of bound), "
          f"plain {slab['plain_ms'] * 1e3:.2f} us, library conv3d "
          f"{slab['library_ms'] * 1e3:.2f} us (max_abs_err vs plain {e_slab:.3e})")
    print(f"run_runtime_sweep: wall {sweep_ms:.4f} ms (PR 16: {before['runtime_sweep_ms'][0]}"
          f"; {before['runtime_sweep_ms'][1]} ms), bound {jb['jacobi_sweep'][0]:.4f} ms "
          f"({jb['jacobi_sweep'][0] / sweep_ms:.1%} of bound); profiled: wall "
          f"{prof_wall_ms:.4f} ms, K1 device time {runtime['device_ms']:.4f} ms in "
          f"{nslabs} launches ({runtime['device_ms'] / nslabs * 1e3:.2f} us each; "
          f"PR 16: 7.03 ms), device busy {busy:.4f} ms, idle share "
          f"{runtime['idle_share']:.4f}")
    print(f"run_runtime_sweep(spec={SPEC_SWEEP!r}): wall {spec_runtime['wall_ms']:.4f} ms "
          f"(kwargs path {sweep_ms:.4f} ms); profiled: wall "
          f"{spec_runtime['profiled_wall_ms']:.4f} ms, K1 device time "
          f"{spec_runtime['device_ms']:.4f} ms in {nslabs} launches, device busy "
          f"{spec_runtime['device_busy_ms']:.4f} ms, idle share "
          f"{spec_runtime['idle_share']:.4f} (kwargs path {runtime['idle_share']:.4f})")
    del f, buf, x

    # K3 at the serving path's shapes
    k3 = {}
    for name, tq, tk, qo in K3_SHAPES:
        plan = dataclasses.asdict(k3_plan((hq, hkv, hd), tq, tk, qo))
        k3[name] = time_k3(f"{name} (plan {plan})", *k3_inputs[name][:3], q_offset=qo)

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
        m, before = k4[name], BEFORE_MS["wkv6"][name]
        print(f"wkv6 {name} {(1, t, rh, rhd)}: {m['ms']:.4f} ms, bound {bnd:.6f} ms "
              f"by {by} ({bnd / m['ms']:.2%} of bound), previous design "
              f"{before:.4f} ms ({before / m['ms']:.2f}x), plain "
              f"{m['plain_ms']:.4f} ms, library: none (no PyTorch call computes the "
              f"WKV recurrence)")

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
        m, before = k5[name], BEFORE_MS["rglru"][name]
        print(f"rglru {name} {(1, t, gw)}: {m['ms']:.4f} ms, bound {bnd:.6f} ms by {by} "
              f"({bnd / m['ms']:.2%} of bound), previous design {before:.4f} ms "
              f"({before / m['ms']:.2f}x), plain {m['plain_ms']:.4f} ms, "
              f"library: none (no PyTorch call computes the recurrence)")

    # K3 at recurrentgemma-9b's hd-256 shapes (prefill with window 2048), and
    # at the new architectures' shapes (without a mask where K3 runs without)
    k3g = {}
    for name, tq, tk, qo, win in K3_GRIFFIN_SHAPES:
        plan = dataclasses.asdict(k3_plan((ghq, ghkv, ghd), tq, tk, qo, win))
        k3g[name] = time_k3(f"hd {ghd} {name} (plan {plan})", *k3g_inputs[name][:3],
                            q_offset=qo, window=win)
    k3n = {}
    for (arch, name), (q, k, v, qo, causal) in k3n_inputs.items():
        k3n[f"{arch} {name}"] = time_k3(
            f"{arch} {name} q {tuple(q.shape)} kv {tuple(k.shape)} causal={causal}",
            q, k, v, q_offset=qo, causal=causal)

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
            "bound_by": jb[name][1], "library_ms": library_ms[name],
            "unequal_elements": unequal[name]})
    # K1's main path launches it on slabs: the slab shape and the whole drain;
    # the spec-built sweep and the SPMD sweeps launch it too
    kernels[0].update(slab=slab, runtime_sweep=runtime,
                      spec_runtime_sweep=spec_main | spec_runtime, spmd=spmd,
                      launches_by_path={
                          "run_runtime_sweep": main_launches["jacobi_sweep"],
                          f"run_runtime_sweep(spec={SPEC_SWEEP})": spec_main["launches"],
                          "make_contiguous_sweep": spmd["contiguous"]["launches"],
                          "make_scattered_sweep": spmd["scattered"]["launches"]})
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
        for arch in (QWEN, GRIFFIN, QWEN3)}, shapes_hd256=k3g, shapes_new=k3n,
        plain_long_prefill_vs_k3=long_plain)
    print(json.dumps({"serving": serving}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
