"""repro.obs — spans, deterministic metrics, timeline export, self-profiling.

The paper's evidence is observational: Fig. 4-style per-thread timelines
and locality counters that show *where* dynamic scheduling breaks page
locality.  Earlier PRs record everything (submission traces, the event
ring buffer, ``RuntimeStats``) but report only aggregates.  This package
is the observability layer over that record — strictly post hoc (or
passively attached), so observation never perturbs the observed schedule:

  paper / ROADMAP concept                obs object
  -------------------------------------  ---------------------------------
  per-task lifecycle (submit → queue →   ``assemble_spans`` → ``Span`` /
  steal → run), Fig. 4 drill-down        ``SpanForest`` — one well-nested
                                         span path per task, steal spans
                                         priced with topology level/distance
  latency distributions, p50/p95/p99     ``Registry`` (counters, gauges,
  as experiment outputs (ROADMAP 3)      fixed-bucket log-scale
                                         ``Histogram``) + exact nearest-rank
                                         ``percentile``/``percentiles``
  interactive Fig. 4 timelines           ``export_chrome_trace`` — Perfetto/
                                         Chrome trace-event JSON with per-
                                         domain tracks and steal flow-arrows
  scheduler cost at production scale     ``HotPathProfiler`` — opt-in
  (ROADMAP 2, ns/decision)               ``perf_counter_ns`` timers around
                                         submit-route / steal-scan /
                                         batch-grab / event-append, fed by
                                         ``Executor(profiler=...)``
  one-call observation                   ``observe(trace)`` → ``ObsReport``;
                                         ``Observation`` is the live form a
                                         spec-built system carries
                                         (``RuntimeSpec.obs`` → ``Built.obs``)
  *why* did time go there — per-task     ``decompose(trace)`` →
  sojourn attribution                    ``BlameReport`` (queue-wait /
                                         steal-transfer / exec, bit-exact)
  "what changed between these runs?"     ``diff_traces(a, b)`` →
                                         ``TraceDiff`` (stats/histogram/
                                         steal-matrix deltas, percentile
                                         shifts with min-effect threshold)
  human-facing regression reports        ``render_blame`` / ``render_diff``
                                         (deterministic markdown; the CI
                                         sentinel's artifact format)

Usage::

    from repro_torch import obs, spec

    built = spec.named("paper_cyclic").build()
    ...                                    # drive built.executor, record
    report = obs.observe(trace)            # spans + histograms + percentiles
    print(report.snapshot()["percentiles"]["sojourn"])
    obs.export_chrome_trace(trace, "run.perfetto-trace")
"""
from .chrome import chrome_trace_events, export_chrome_trace
from .critpath import PHASES, BlameReport, TaskBlame, decompose
from .diff import HistDelta, Shift, TraceDiff, diff_traces
from .metrics import Counter, Gauge, Histogram, Registry, percentile, \
    percentiles
from .observe import ObsReport, Observation, observe
from .profile import PATHS, HotPathProfiler
from .report import markdown_table, render_blame, render_diff
from .spans import Span, SpanForest, assemble_spans, spans_from

__all__ = [
    "chrome_trace_events", "export_chrome_trace",
    "PHASES", "BlameReport", "TaskBlame", "decompose",
    "HistDelta", "Shift", "TraceDiff", "diff_traces",
    "Counter", "Gauge", "Histogram", "Registry", "percentile", "percentiles",
    "ObsReport", "Observation", "observe",
    "PATHS", "HotPathProfiler",
    "markdown_table", "render_blame", "render_diff",
    "Span", "SpanForest", "assemble_spans", "spans_from",
]
