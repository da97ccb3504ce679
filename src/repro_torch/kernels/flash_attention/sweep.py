"""K3's chunk-size sweep on the card: at the serving path's bf16 shapes, the
device time of every chunk size a split key range could take, beside the
plan :func:`kernel.split_plan` picks.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.sweep

Needs a CUDA card (exits 1 without one).  Each row prints the shape, the
plan picked, the rule's starting chunk count sqrt(keys / (2 * rows)), and
for each chunk size: chunks S, blocks launched, waves on the card (blocks
over the variant's resident blocks), device ms (CUDA events behind a device
sleep), and the worst element's share of K3's bf16 limit against
``mha_ref``.  Exits 1 if any plan breaks the limit.
"""
from __future__ import annotations

import math
import subprocess
import sys

import torch

from . import kernel
from .ref import mha_ref

# (label, (hq, hkv, hd), tq, tk, q_offset, window): qwen2-0.5b's heads and
# recurrentgemma-9b's local layers (window 2048 at prefill, the ring's
# window 0 at decode), prefill at the drains' lengths and decode over a
# 2048-slot cache
SHAPES = [(f"{name} {kind}", heads, tq, tk, qo, win if tq > 1 else 0)
          for name, heads, win in (("qwen2", (14, 2, 64), 0), ("hd 256", (16, 1, 256), 2048))
          for kind, tq, tk, qo in (("prefill 128", 128, 128, 0),
                                   ("prefill 513", 513, 513, 0),
                                   ("prefill 891", 891, 891, 0),
                                   ("prefill 1024", 1024, 1024, 0),
                                   ("decode 517", 1, 2048, 517),
                                   ("decode 2047", 1, 2048, 2047))]
LIMIT = dict(atol=3e-5, rtol=2.0 ** -7)     # K3's bf16 limit per element


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call, each queued behind a 2 ms device sleep so
    the events time the device and not the host's launches."""
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


def main() -> int:
    if not torch.cuda.is_available():
        print("the sweep needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    worst = 0.0
    for label, (hq, hkv, hd), tq, tk, qo, win in SHAPES:
        # the model's strided (B, H, T, hd) views of (B, T, H, hd) tensors
        q, k, v = (torch.randn(1, t, h, hd, generator=gen).bfloat16().to(dev).transpose(1, 2)
                   for t, h in ((tq, hq), (tk, hkv), (tk, hkv)))
        kw = dict(causal=True, window=win, q_offset=qo)
        want = mha_ref(q, k, v, **kw).float()
        rows, qt, bk = kernel.variant(hq, hkv, tq, hd)
        slots = kernel._slots(0, rows, hd)
        picked = kernel.split_plan(1, hq, hkv, tq, tk, hd, slots=slots, **kw)
        ns = [kernel._tiles(*kernel.key_range(rt * qt, min(tq, rt * qt + qt), tk, **kw), bk)
              for rt in range(picked.row_tiles)]
        most = max(ns)
        start = math.isqrt(most * bk // (2 * rows))
        out = torch.empty((1, tq, hq, hd), dtype=torch.bfloat16, device=dev).transpose(1, 2)
        cells = []
        for per in sorted({-(-most // s) for s in range(1, min(most, kernel.MAX_SPLITS) + 1)}):
            plan = kernel.Plan(rows, qt, bk, picked.row_tiles, -(-most // per), per)
            blocks = hkv * sum(max(1, -(-n // per)) for n in ns)
            ms = device_ms(lambda: kernel.run_bf16(q, k, v, out, plan, **kw))
            kernel.run_bf16(q, k, v, out, plan, **kw)
            share = float(((out.float() - want).abs()
                           / (LIMIT["atol"] + LIMIT["rtol"] * want.abs())).max())
            worst = max(worst, share)
            mark = "*" if (plan.splits, per) == (picked.splits, picked.tiles_per_chunk) or \
                (plan.splits == picked.splits == 1) else ""
            cells.append(f"{mark}per {per} S {plan.splits}: {blocks} blocks, "
                         f"{-(-blocks // slots)} wave(s), {ms:.4f} ms ({share:.2f})")
        print(f"{label}: {picked.row_tiles} row tiles of {rows} rows, {most} tiles of {bk} "
              f"keys at most, {slots} blocks fit; picked S {picked.splits} x "
              f"{min(picked.tiles_per_chunk, most)} tiles (rule starts at S {start}) | "
              + "; ".join(cells))
    print(f"worst share of the bf16 limit: {worst:.3f}")
    return 0 if worst <= 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
