"""K1's and K2's instance sweep on the card: every compiled (tile, ring
depth) instance of ``csrc/jacobi.cu`` at several i chunks, at the paper's
2400x600x600 f32 lattice and at the runtime sweep's slab launch (10 rows of
that lattice, ``rows=(10, 20)``).

    PYTHONPATH=src python -m repro_torch.kernels.jacobi.sweep

Needs a CUDA card (exits 1 without one).  For each instance it prints its
tile (TJ x TK), ring stages, threads, shared memory and resident blocks per
SM (the card's occupancy answer), then for each i chunk the whole-lattice
device ms (CUDA events around 10 back-to-back launches of milliseconds
each) and its share of the 2.0633 ms byte bound, and the number of
elements that differ from the plain sweep (must be 0).  The slab column is
the device us of one slab launch: 50 launches queued behind a device sleep
long enough for the host to enqueue them all, so the events time the
device and not the host.  The wrappers' instance and chunk are marked *;
the 4-byte-copy route of that instance is timed beside it.  Last, the host
cost of one tensor-map encode and of one slab launch through the wrapper.
Exits 1 if any instance differs from the plain sweep in any element.
"""
from __future__ import annotations

import subprocess
import sys
import time

import torch

from . import kernel
from .kernel import jacobi_sweep_cuda
from .ref import jacobi_sweep_ref

LATTICE = (2400, 600, 600)
DI = 10                                  # the runtime sweep's slab rows
CHUNKS = (10, 20, 30, 60, 120, 240)
HBM_BYTES_PER_S = 3.35e12                # H100 SXM (NVIDIA data sheet)


def lattice_ms(fn, iters: int = 10) -> float:
    """Device ms of one call, back to back (each call runs for ms)."""
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def queued_us(fn, n: int = 50) -> float:
    """Device us of one call of ``fn``: ``n`` calls queued behind a device
    sleep, timed by events on the device."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)        # ~28 ms at 1.755 GHz, past n host launches
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / n


def main() -> int:
    if not torch.cuda.is_available():
        print("the sweep needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    dev = torch.device("cuda")
    f = torch.randn(LATTICE, generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    want = {False: jacobi_sweep_ref(f)}
    want[True] = jacobi_sweep_ref(want[False])
    out = torch.empty_like(f)
    sites = f.numel()
    bound_ms = 8 * sites / HBM_BYTES_PER_S * 1e3
    slab = (DI, 2 * DI)
    slab_bound_us = 8 * DI * LATTICE[1] * LATTICE[2] / HBM_BYTES_PER_S * 1e6
    print(f"byte bound: lattice {bound_ms:.4f} ms, slab of {DI} rows {slab_bound_us:.2f} us")
    bad = 0

    def unequal(two_step):
        torch.cuda.synchronize()
        return int((out != want[two_step]).sum())

    for two_step, name in ((False, "K1 jacobi_sweep_kernel"),
                           (True, "K2 jacobi_two_step_kernel")):
        default = kernel.geometry(two_step)
        for v in range(kernel.variants(two_step)):
            g = kernel.geometry(two_step, v)
            routes = [True] + ([False] if v == default["variant"] else [])
            for tma in routes:
                mark = "*" if v == default["variant"] and tma else ""
                stage_kb = (g["tj"] + (4 if two_step else 2)) * 512 / 1024
                print(f"{mark}{name} instance {v} ({'TMA' if tma else '4-byte copies'}): "
                      f"tile {g['tj']} x {g['tk']}, {g['stages']} stages of "
                      f"{stage_kb:.1f} KB, {g['threads']} threads (launch bounds "
                      f"{g['min_blocks']} blocks), {g['smem_bytes']} B "
                      f"shared, {g['blocks_per_sm' if tma else 'blocks_per_sm_copy']} "
                      f"blocks per SM", flush=True)
                cells = []
                for chunk in CHUNKS:
                    def run():
                        kernel.launch(two_step, v, chunk, f, out, tma=tma)
                    run()
                    diff = unequal(two_step)
                    bad += diff
                    ms = lattice_ms(run)
                    cm = "*" if mark and chunk == default["chunk"] else ""
                    cells.append(f"{cm}chunk {chunk}: {ms:.4f} ms "
                                 f"({bound_ms / ms:.1%}) {diff} unequal")
                if not two_step:
                    part = out[slab[0]:slab[1]]
                    kernel.launch(False, v, default["chunk"], f, part, rows=slab, tma=tma)
                    torch.cuda.synchronize()
                    diff = int((part != want[False][slab[0]:slab[1]]).sum())
                    bad += diff
                    us = queued_us(lambda: kernel.launch(False, v, default["chunk"], f,
                                                         part, rows=slab, tma=tma))
                    cells.append(f"slab {us:.2f} us ({slab_bound_us / us:.1%}) "
                                 f"{diff} unequal")
                print("  " + "; ".join(cells), flush=True)

    ns = kernel.encode_ns(f, reps=10000)
    part = out[slab[0]:slab[1]]
    torch.cuda._sleep(200_000_000)        # keep the device busy while the host enqueues
    t0 = time.perf_counter()
    for _ in range(100):
        jacobi_sweep_cuda(f, di=DI, dj=LATTICE[1], out=part, rows=slab)
    host_us = (time.perf_counter() - t0) * 1e4
    torch.cuda.synchronize()
    print(f"host: one tensor-map encode {ns / 1e3:.3f} us; one slab launch through "
          f"jacobi_sweep_cuda {host_us:.2f} us (enqueue, device busy)")
    print(f"instances differing from the plain sweep: {bad} elements")
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
