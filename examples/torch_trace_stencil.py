"""Record → analyze → replay a runtime stencil sweep with the PyTorch/CUDA
port (the twin of ``trace_stencil.py``).

    PYTHONPATH=src python examples/torch_trace_stencil.py --device cpu

The sweep runs on the card unless ``--device cpu`` asks for the CPU: there
each slab task is one launch of K1, the hand-written Hopper Jacobi kernel,
and the result must equal the plain whole-lattice sweep bit for bit.  The
schedule (tasks, rounds, steals, timelines, storms, replay, the governor's
feedback) is the reference example's, whatever the device.

Runs one online Jacobi sweep through the locality runtime with a
``repro.trace.TraceRecorder`` attached, writes the trace to JSONL, renders
the per-worker steal timeline with storm detection, replays the recorded
submission trace and checks the scheduler statistics reproduce exactly,
and finally seeds a ``MeasuredPenalty`` governor from the measured service
times — the whole trace loop on a problem small enough for CI.

Every executor here is built from a declarative ``repro.spec.RuntimeSpec``,
so the recorded trace headers embed the full policy (schema v2) and both
replays run from the trace file alone — no factories.
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch import spec, trace
from repro_torch.kernels.jacobi.ref import jacobi_sweep_ref
from repro_torch.stencil.jacobi import run_runtime_sweep

NUM_DOMAINS = 4


def main(device=None):
    rng = np.random.default_rng(0)
    f = rng.standard_normal((80, 12, 16)).astype(np.float32)

    # -- record: one online sweep, slab tasks homed contiguously ------------
    sweep_spec = spec.RuntimeSpec(num_domains=NUM_DOMAINS)
    rec = trace.TraceRecorder()
    out, stats = run_runtime_sweep(f, di=5, spec=sweep_spec, trace=rec, device=device)
    want = jacobi_sweep_ref(torch.from_numpy(f).to(out.device))
    assert torch.equal(out, want), "physics!"
    t = rec.finish()
    print(f"recorded: {t.n_tasks} slab tasks, {t.total_steps} rounds, "
          f"local={stats.local_fraction:.0%} steal={stats.steal_fraction:.0%}")

    path = os.path.join(tempfile.mkdtemp(prefix="repro-torch-trace-"),
                        "stencil.trace.jsonl")
    trace.TraceWriter(path).write(t)
    t = trace.TraceReader(path).read()
    print(f"trace file: {path} ({os.path.getsize(path)} bytes, "
          f"schema v{trace.SCHEMA_VERSION})")

    # -- analyze: windowed storm detection + per-worker timeline ------------
    print()
    print(trace.render_timeline(t.events, num_workers=NUM_DOMAINS, width=2))
    storms = trace.detect_steal_storms(t.events, width=2)
    bursts = trace.detect_inline_bursts(t.events, width=2)
    print(f"\nsteal-storm windows: {[w.start for w in storms]}  "
          f"inline bursts: {[w.start for w in bursts]}")

    # -- replay: same arrivals, identical stats -----------------------------
    res = trace.replay(t, assert_match=True)
    print(f"replay: stats reproduce recorded run exactly "
          f"(executed={res.stats['executed']:.0f}, "
          f"local_fraction={res.stats['local_fraction']:.3f})")

    # -- storm demo: the contiguous sweep is storm-free by construction, so
    # drive a hot-domain-skewed arrival stream through the runtime to show
    # the detectors firing and the measured θ reacting to real steals.
    wl = trace.hot_skew(trace.poisson(rate=NUM_DOMAINS, steps=24,
                                      num_domains=NUM_DOMAINS, seed=1),
                        hot_domain=0, p_hot=0.85, seed=1)
    storm_spec = spec.RuntimeSpec(
        num_domains=NUM_DOMAINS,
        penalty=spec.PenaltySpec(kind="cost_factor", value=4.0),
        trace=spec.TraceSpec(record=True))
    built = storm_spec.build()
    ex = built.executor
    trace.drive(ex, wl)
    t2 = built.recorder.finish()
    print(f"\nskewed workload {wl.name}: {t2.n_tasks} tasks, "
          f"steal={ex.stats.steal_fraction:.0%}")
    print(trace.render_timeline(t2.events, num_workers=NUM_DOMAINS, width=4))
    storms = trace.detect_steal_storms(t2.events, width=4)
    print(f"steal-storm windows: {[w.start for w in storms]}")
    assert storms, "hot-skew stream should provoke a steal storm"
    trace.replay(t2, assert_match=True)      # rebuilt from the header spec

    # -- feedback: measured service times -> adaptive θ ---------------------
    gov = trace.MeasuredPenalty.from_trace(t2)
    print(f"measured feedback: local_cost≈{gov.local_cost_estimate:.2f}, "
          f"penalty≈{gov.penalty_estimate:.2f} -> θ={gov.threshold} "
          f"(from {gov.observed_local} local / {gov.observed_steals} "
          f"stolen observations)")
    print("\ntrace smoke OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass cpu for the CPU)")
    main(ap.parse_args().device)
