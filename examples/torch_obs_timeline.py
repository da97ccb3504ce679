"""Observe a run end to end with the PyTorch/CUDA port's copy of the
observation stack (the twin of ``obs_timeline.py``): spans -> metrics -> a
Perfetto timeline.

    PYTHONPATH=src python examples/torch_obs_timeline.py [--out out.perfetto-trace]

Nothing here touches a device: ``repro_torch.obs``, ``spec`` and ``trace``
are numpy-only copies of the JAX package's, so the printed schedule and the
exported timeline are the reference example's (only the profiler's ns per
decision, a measurement, differs).

One observed, profiled run over the two-socket topology, then the whole
``repro_torch.obs`` surface on its recorded trace:

  1. build a hierarchical (2x2-socket) policy with ``ObsSpec(enabled=True,
     profile=True)`` — the executor carries the hot-path timers and the
     trace header (schema v4) names the observation;
  2. drive a hot-skew workload (domain 0 overloaded, so the run steals —
     including cross-socket steals the timeline draws as flow arrows);
  3. ``observe()`` the trace: per-task span trees, registry counters and
     log-bucket histograms, exact nearest-rank p50/p95/p99;
  4. print the self-profiled scheduler overhead (ns per decision for
     submit-route / steal-scan / batch-grab / event-append);
  5. ``export_chrome_trace`` -> a ``.perfetto-trace`` JSON: open it at
     https://ui.perfetto.dev (or chrome://tracing) — one process track per
     locality domain, one thread lane per worker, queue-depth counters,
     and steal arrows from victim queue to thief execution slice.

The export is pure post-processing of the recorded trace: running this
example twice produces byte-identical timelines (only the profiler's wall
timings differ — they are measurements, not schedule inputs).  ``--out``
picks the destination; the default lands in ``artifacts/`` (gitignored),
beside the reference example's file, not over it.
"""
import argparse
import os

from repro_torch import obs, spec, trace

DEFAULT_OUT = os.path.join("artifacts", "torch_obs_timeline.perfetto-trace")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help=f"timeline destination (default: {DEFAULT_OUT})")
    out = ap.parse_args().out
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)

    s = spec.RuntimeSpec(
        num_domains=4,
        topology=spec.TopologySpec(kind="grouped", groups=(2, 2),
                                   near=1.0, far=10.0),
        penalty=spec.PenaltySpec(kind="constant", value=4.0),
        batch=spec.BatchSpec(kind="fixed", size=2),
        trace=spec.TraceSpec(record=True),
        obs=spec.ObsSpec(enabled=True, profile=True))
    built = s.build()

    wl = trace.lognormal_costs(
        trace.hot_skew(trace.poisson(rate=4, steps=32, num_domains=4,
                                     seed=7),
                       hot_domain=0, p_hot=0.8, seed=7),
        median=2.0, sigma=0.75, seed=7)
    trace.drive(built.executor, wl)
    t = built.recorder.finish()

    rep = built.obs.report(t)
    m = rep.registry.snapshot()
    print(f"observed {m['tasks_observed']}/{m['tasks_submitted']} tasks "
          f"({m['tasks_unobserved']} outside the event window); "
          f"{m['steals']} steals, {m['remote_steals']} cross-socket")
    for metric in ("wait", "sojourn", "service"):
        p = rep.percentiles[metric]
        print(f"  {metric:8s} p50={p['p50']:g} p95={p['p95']:g} "
              f"p99={p['p99']:g}  (exact nearest-rank, steps)")

    print("self-profiled scheduler overhead (ns/decision):")
    for path, ns in rep.profile["ns_per_call"].items():
        print(f"  {path:13s} {ns:8.0f}  ({rep.profile['calls'][path]} calls)")

    # one task's span tree, for flavor: the deepest sojourn
    worst = max(rep.spans, key=lambda sp: sp.duration)
    print(f"slowest task #{worst.attrs['uid']} "
          f"(home={worst.attrs['home']}, sojourn={worst.duration:g}):")
    for c in worst.children:
        print(f"  {c.name:7s} [{c.start:g} .. {c.end:g}] {dict(c.attrs)}")

    obs.export_chrome_trace(t, out)
    print(f"wrote {out} — open at https://ui.perfetto.dev")


if __name__ == "__main__":
    main()
