"""K4's time-chunk sweep on the card: at rwkv6-3b's WKV shapes (40 heads of
64, bf16 r, k, v, from a carried state written in place, as the model
calls it), the device time of each chunk size beside ``TIME_CHUNK``, and
of one launch over all of T (phase 1 alone, no carry and no correction).

    PYTHONPATH=src python -m repro_torch.kernels.rwkv6.sweep

Needs a CUDA card (exits 1 without one).  Each row prints the length T
and, for each chunk size C: the launches (1 when T <= C, else 3), device
ms (CUDA events behind a device sleep, mean of 20 calls), the worst
element's share of K4's limit against ``wkv6_ref`` (1e-5 of the largest
|ref|, over o and the final state) and, from ``torch.profiler``'s device
records of 5 calls, each kernel's mean us (phases 2 and 3 start while
the phase before them drains, so their spans include waiting).  Then, at
each prompt length of ``chip_smoke.py``'s serving drain, ``TIME_CHUNK``
against one launch, and the device time the chunking saves per rwkv6-3b
drain (each prompt's difference times the model's 32 layers).  Exits 1
if any chunk size breaks the limit.
"""
from __future__ import annotations

import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

from . import kernel
from .ref import wkv6_ref

CHUNKS = (32, 64, 128)
# prefill 128 and 1024, the rwkv6-3b drain's shortest and longest prompts
# (134 and 892, numpy seed 0) and a decode step
LENGTHS = (1, 128, 134, 892, 1024)
# the prompt lengths of chip_smoke.py's drain (``requests``, numpy seed 0)
DRAIN_PROMPTS = (891, 554, 724, 535, 828, 858, 621, 892, 576, 366, 134, 402)
HEADS, HEAD_DIM, LAYERS = 40, 64, 32
K4_REL = 1e-5


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


def kernel_us(fn, calls: int = 5) -> dict[str, float]:
    """Mean device us of each K4 kernel over ``calls`` calls of ``fn``."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            torch.cuda._sleep(1_000_000)
            fn()
        torch.cuda.synchronize()
    per: dict[str, list[float]] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        for name in ("wkv6_kernel", "wkv6_carry_kernel", "wkv6_fix_kernel"):
            if name in e.name():
                per.setdefault(name, []).append((e.end_ns() - e.start_ns()) / 1e3)
    return {name: sum(us) / len(us) for name, us in per.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("the sweep needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; TIME_CHUNK {kernel.TIME_CHUNK} (marked *)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0

    def inputs(t):
        shape = (1, t, HEADS, HEAD_DIM)
        r, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16() for _ in range(3))
        w = torch.exp(-torch.exp(-6.0 + torch.randn(shape, generator=gen, device=dev)))
        u = 0.5 * torch.rand((HEADS, HEAD_DIM), generator=gen, device=dev)
        s0 = 0.5 * torch.randn((1, HEADS, HEAD_DIM, HEAD_DIM), generator=gen, device=dev)
        return (r, k, v, w, u), s0

    def checked_ms(x, s0, chunk, want):
        """(device ms, share of K4's limit) at time chunks of ``chunk``."""
        nonlocal worst
        got = kernel.run(*x, s0.clone(), chunk)
        share = max(float((g - y).abs().max()) / (K4_REL * float(y.abs().max()))
                    for g, y in zip(got, want))
        worst = max(worst, share)
        state = s0.clone()
        return device_ms(lambda: kernel.run(*x, state, chunk)), share

    for t in LENGTHS:
        x, s0 = inputs(t)
        want = wkv6_ref(*x, s0)
        cells = []
        # C = T: one launch of phase 1 over all of T (the same as C = 128 at T <= 128)
        for chunk in CHUNKS + ((t,) if t > max(CHUNKS) else ()):
            ms, share = checked_ms(x, s0, chunk, want)
            state = s0.clone()
            phases = kernel_us(lambda: kernel.run(*x, state, chunk))
            mark = "*" if chunk == kernel.TIME_CHUNK else ""
            label = "one launch" if chunk == t > max(CHUNKS) else f"C {chunk}"
            cells.append(f"{mark}{label}: {1 if t <= chunk else 3} launch(es), "
                         f"{ms:.4f} ms ({share:.3f}) [" + ", ".join(
                             f"{name.removesuffix('_kernel')} {us:.2f} us"
                             for name, us in phases.items()) + "]")
        print(f"T {t}: " + "; ".join(cells), flush=True)

    saved = 0.0
    for t in DRAIN_PROMPTS:
        x, s0 = inputs(t)
        want = wkv6_ref(*x, s0)
        chunked, _ = checked_ms(x, s0, kernel.TIME_CHUNK, want)
        one, _ = checked_ms(x, s0, t, want)
        saved += LAYERS * (one - chunked)
        print(f"drain prompt {t}: C {kernel.TIME_CHUNK} {chunked:.4f} ms, one launch "
              f"{one:.4f} ms ({one / chunked:.2f}x)", flush=True)
    print(f"chunking saves {saved:.4f} ms of K4 device time per rwkv6-3b drain "
          f"({len(DRAIN_PROMPTS)} prompts x {LAYERS} layers)")
    print(f"worst share of K4's limit: {worst:.3f}")
    return 0 if worst <= 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
