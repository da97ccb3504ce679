"""Tying it together: observe a recorded run, or attach to a live build.

``observe(trace)`` is the one-call post-hoc pipeline: span assembly +
metrics registry over any recorded ``repro.trace.Trace`` (v1–v4), producing
an ``ObsReport`` with

  * counters   — tasks submitted/observed/unobserved, steals, remote
                 steals, events dropped by the ring buffer;
  * histograms — wait / sojourn / service / steal-distance, on the
                 registry's fixed log-scale buckets;
  * exact percentiles — nearest-rank p50/p95/p99 of wait, sojourn, and
                 service over the *full* per-task sample (not bucket
                 estimates), the numbers ``BENCH_experiments.json`` exports;
  * the span forest itself, for drill-down and the Perfetto export.

``Observation`` is the live counterpart a spec-built system carries
(``RuntimeSpec.obs.enabled`` → ``Built.obs``): it owns the registry, the
opt-in ``HotPathProfiler`` (``obs.profile``), and a ``report(trace)``
convenience that folds the profiler snapshot into the post-hoc report.
Observation is deliberately *passive* — it changes no scheduling decision,
which is why obs-on and obs-off runs produce bit-identical ``RuntimeStats``
and replays (the invariant ``tests/test_obs.py`` gates per policy).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .metrics import Registry, percentiles
from .profile import HotPathProfiler
from .spans import SpanForest, assemble_spans

PERCENTILE_QS = (50, 95, 99)


@dataclasses.dataclass
class ObsReport:
    """Everything one observation of one run produced (see module doc)."""

    registry: Registry
    spans: SpanForest
    percentiles: dict[str, dict[str, float]]
    profile: Optional[dict] = None

    def snapshot(self) -> dict:
        """One JSON-ready dict: registry metrics + exact percentiles (+ the
        profiler snapshot when the run was profiled)."""
        out = {"metrics": self.registry.snapshot(),
               "percentiles": self.percentiles,
               "tasks_observed": len(self.spans),
               "tasks_unobserved": len(self.spans.missing)}
        if self.profile is not None:
            out["profile"] = self.profile
        return out


def _events_dropped(trace) -> int:
    dropped = getattr(trace, "events_dropped", None)
    if dropped is not None:
        return int(dropped)
    total = sum(trace.event_counts.values()) if trace.event_counts else 0
    return max(total - trace.events_retained, 0)


def observe(trace, *, registry: Optional[Registry] = None,
            topology=None) -> ObsReport:
    """Run the full post-hoc observation pipeline over ``trace``.

    Pass a ``registry`` to accumulate into an existing one (a live
    ``Observation`` does); by default a fresh registry with the standard
    bucket ladder is used.  ``topology`` overrides the header-embedded
    distance matrix for steal level/distance pricing.
    """
    reg = registry if registry is not None else Registry()
    forest = assemble_spans(trace, topology=topology)

    reg.counter("tasks_submitted").inc(len(trace.submissions))
    reg.counter("tasks_observed").inc(len(forest))
    reg.counter("tasks_unobserved").inc(len(forest.missing))
    reg.counter("events_dropped").inc(_events_dropped(trace))

    waits, sojourns, services = [], [], []
    h_wait = reg.histogram("wait")
    h_sojourn = reg.histogram("sojourn")
    h_service = reg.histogram("service")
    h_dist = reg.histogram("steal_distance")
    steals = reg.counter("steals")
    remote = reg.counter("remote_steals")
    for span in forest:
        exec_span = span.children[-1]
        queued = span.children[0]
        wait = queued.duration
        service = exec_span.duration
        waits.append(wait)
        services.append(service)
        sojourns.append(span.duration)
        h_wait.record(wait)
        h_service.record(service)
        h_sojourn.record(span.duration)
        for c in span.children:
            if c.name == "steal":
                steals.inc()
                h_dist.record(c.attrs["distance"])
                if c.attrs["level"] >= 2:
                    remote.inc()

    pct = {}
    if sojourns:
        pct = {"wait": percentiles(waits, PERCENTILE_QS),
               "sojourn": percentiles(sojourns, PERCENTILE_QS),
               "service": percentiles(services, PERCENTILE_QS)}
    return ObsReport(registry=reg, spans=forest, percentiles=pct)


class Observation:
    """The live observation a spec-built system carries (``Built.obs``).

    ``spec`` is the declaring ``repro.spec.ObsSpec`` (any object with
    ``enabled`` / ``profile`` / ``hist_lo`` / ``hist_growth`` /
    ``hist_buckets`` attributes works — the obs package stays import-free
    of the spec layer).  The registry is created up front; the profiler
    only when ``spec.profile`` asks for the timers.
    """

    def __init__(self, spec) -> None:
        self.spec = spec
        self.registry = Registry(hist_lo=spec.hist_lo,
                                 hist_growth=spec.hist_growth,
                                 hist_buckets=spec.hist_buckets)
        self.profiler = HotPathProfiler() if spec.profile else None

    def report(self, trace) -> ObsReport:
        """Post-hoc observation of ``trace`` into this observation's
        registry, with the profiler snapshot attached when profiling."""
        rep = observe(trace, registry=self.registry)
        if self.profiler is not None:
            rep.profile = self.profiler.snapshot()
        return rep
