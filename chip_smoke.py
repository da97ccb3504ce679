"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout, on a host with one CUDA card and the CUDA
toolkit (``nvcc``).  Phases, each fatal on failure:

1. build every kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once) and print the build time, ``nvcc``'s register and
   shared-memory report, and the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes of the JAX package's kernel tests, at c = 0.25, and at the
   paper's 2400x600x600 f32 lattice (limits: 1e-6 for one sweep, 1e-5 for
   two);
3. the main path, ``run_runtime_sweep`` on the full lattice (di = 10,
   4 domains x 2 workers = 240 slab tasks), against the plain sweep, with
   the launch counts zeroed before and read after; then ``jacobi_iterate``
   (K2 for pairs of sweeps, K1 for the odd one) the same way;
4. time each kernel, its plain version, the library's yardstick
   (``conv3d`` with the six-point cross, TF32 off) and the runtime sweep
   with CUDA events, beside the byte bound;
5. print the ``kernels`` JSON line, the card's name and power limit, and
   last the ``{"ok": true, ...}`` line.

Exits non-zero, with no result line, when there is no CUDA device or when
the port's sources are not beside this script.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
LATTICE = (2400, 600, 600)    # the paper's lattice (repro/core/tasks.py PAPER_GRID)
SWEEP_CASES = [((20, 20, 60), (10, 10)), ((8, 16, 128), (4, 8)),
               ((10, 10, 600), (10, 10)), ((30, 20, 32), (10, 5)),
               ((4, 4, 16), (2, 2))]
TWO_STEP_CASES = [((20, 20, 32), (5, 5)), ((12, 8, 16), (4, 4)),
                  ((10, 10, 600), (10, 10)), ((8, 8, 8), (2, 2))]
K1_ATOL, K2_ATOL = 1e-6, 1e-5


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def max_err(a, b) -> float:
    if a.shape != b.shape:
        fail(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if not bool(a.isfinite().all()):
        fail("non-finite values in a kernel's output")
    return float((a - b).abs().max())


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


def main() -> None:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"the port's sources (src/repro_torch) are not beside {__file__}")
    sys.path.insert(0, str(ROOT / "src"))
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")

    from repro_torch.kernels import _build
    from repro_torch.kernels.jacobi import ops, ref
    from repro_torch.kernels.jacobi.kernel import jacobi_sweep_cuda
    from repro_torch.kernels.jacobi.temporal import jacobi_two_step_cuda
    from repro_torch.stencil.jacobi import run_runtime_sweep

    dev = torch.device("cuda")
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    print(f"card: {card}")

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for {_build.sources()}")
    for name, log in logs.items():
        print(f"--- nvcc {name}.cu ---\n{log.strip()}")

    # -- 2. kernels against their plain versions --------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"jacobi_sweep": 0.0, "jacobi_two_step": 0.0}
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

    # -- 3. the main path, then jacobi_iterate ----------------------------
    di, domains, wpd = 10, 4, 2
    jacobi_sweep_cuda.launches = jacobi_two_step_cuda.launches = 0
    out, stats = run_runtime_sweep(f, di=di, num_domains=domains,
                                   workers_per_domain=wpd)
    torch.cuda.synchronize()
    main_launches = {"jacobi_sweep": jacobi_sweep_cuda.launches,
                     "jacobi_two_step": jacobi_two_step_cuda.launches}
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
    jacobi_sweep_cuda.launches = jacobi_two_step_cuda.launches = 0
    it = ops.jacobi_iterate(f, steps)
    torch.cuda.synchronize()
    iter_launches = {"jacobi_sweep": jacobi_sweep_cuda.launches,
                     "jacobi_two_step": jacobi_two_step_cuda.launches}
    want = ref.jacobi_sweep_ref(ref.jacobi_sweep_ref(plain))
    e_iter = max_err(it, want)
    print(f"jacobi_iterate steps={steps}: max_abs_err {e_iter:.3e}, "
          f"launches {iter_launches}")
    if e_iter > K2_ATOL or iter_launches != {"jacobi_sweep": 1,
                                             "jacobi_two_step": 1}:
        fail(f"jacobi_iterate: err {e_iter}, launches {iter_launches}")
    del it, want, plain

    # -- 4. timing ---------------------------------------------------------
    sites = f.numel()
    io_bytes = 2 * 4 * sites                     # read f once, write once
    bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = {"jacobi_sweep": 6 * sites / F32_FLOPS_PER_S * 1e3,   # 5 adds, 1 mul
              "jacobi_two_step": 12 * sites / F32_FLOPS_PER_S * 1e3}
    bound = {k: max(bytes_ms, v) for k, v in ops_ms.items()}
    bound_by = {k: "bytes" if bytes_ms >= v else "operations"
                for k, v in ops_ms.items()}
    buf = torch.empty_like(f)
    ms = {"jacobi_sweep": time_ms(lambda: jacobi_sweep_cuda(f, out=buf), 20),
          "jacobi_two_step": time_ms(lambda: jacobi_two_step_cuda(f, out=buf), 20)}
    plain_ms = {"jacobi_sweep": time_ms(lambda: ref.jacobi_sweep_ref(f), 5),
                "jacobi_two_step": time_ms(lambda: ref.jacobi_two_step_ref(f), 3)}

    # library yardstick: one cuDNN conv3d with the six-point cross (two for
    # the two-step); cuDNN would use TF32 by default, so that is turned off
    torch.backends.cudnn.allow_tf32 = False
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
              f"{bound[name]:.4f} ms ({bound[name] / ms[name]:.1%} of bound), "
              f"plain {plain_ms[name]:.4f} ms, library {library_ms[name]:.4f} ms")
    print(f"run_runtime_sweep: {sweep_ms:.4f} ms, "
          f"{io_bytes / (sweep_ms * 1e-3) / 1e9:.1f} GB/s, bound "
          f"{bound['jacobi_sweep']:.4f} ms "
          f"({bound['jacobi_sweep'] / sweep_ms:.1%} of bound); one slab launch "
          f"{slab_ms:.4f} ms x {nslabs} = {slab_ms * nslabs:.4f} ms of device time")

    # -- 5. result lines --------------------------------------------------
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
            "ms": ms[name], "plain_ms": plain_ms[name], "bound_ms": bound[name],
            "bound_by": bound_by[name], "library_ms": library_ms[name]})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
