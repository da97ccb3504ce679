"""repro.trace — workloads, trace export, deterministic replay, storm analysis.

PR 1's ``repro.runtime`` executes tasks online but exposes only aggregate
counters; the paper's key evidence is timeline-level (the per-thread
variability behind Fig. 4).  This package closes the loop around the
runtime: generate production-like arrival streams, record a run as a
replayable trace, re-drive the *same* arrival sequence under a different
steal policy, detect steal storms in the event timeline, and feed measured
service times back into the adaptive governor.

Paper-concept map (Wittmann & Hager, 2010), continuing the table in
``repro/runtime/__init__.py``:

  paper concept (§)                      trace object
  -------------------------------------  ---------------------------------
  benchmark task streams (§2.1, §3)      ``workloads``: ``poisson`` /
                                         ``bursty`` (MMPP) / ``diurnal``
                                         arrival processes, ``hot_skew`` /
                                         ``lognormal_costs`` combinators
  identical work, different schedule     ``TraceRecorder`` + ``replay``:
  (the Fig. 3 A/B methodology)           the recorded submission trace is
                                         the controlled variable, the steal
                                         policy the treatment
  per-thread timelines behind Fig. 4     ``storms.render_timeline`` (text
                                         timeline) over ``runtime.Event``
                                         streams
  nonlocal-access storms (§3.1's         ``storms.detect_steal_storms`` /
  degraded dynamic runs)                 ``detect_inline_bursts`` /
                                         ``depth_imbalance`` windowed
                                         detectors
  nonlocal penalty, measured not         ``MeasuredPenalty``: run/steal
  assumed (§1.4 bandwidth ratios)        service-time pairs → θ estimate of
                                         ``runtime.AdaptiveSteal``

Usage::

    from repro_torch import trace
    from repro_torch.runtime import Executor

    wl = trace.hot_skew(trace.poisson(rate=4, steps=64, num_domains=4))
    rec = trace.TraceRecorder()
    ex = rec.attach(Executor(4, steal_penalty=lambda t, w: 4.0))
    trace.drive(ex, wl)
    t = rec.finish()
    trace.TraceWriter("run.jsonl").write(t)

    print(trace.render_timeline(t.events, num_workers=4))
    result = trace.replay(                           # bit-identical stats
        t, lambda tr: trace.executor_from_meta(
            tr, steal_penalty=lambda t, w: 4.0), assert_match=True)
    gov = trace.MeasuredPenalty.from_trace(t)        # measured θ seed
"""
from .feedback import MeasuredPenalty
from .io import TraceReader, TraceWriter, dumps_lines, loads_lines
from .record import TraceRecorder, executor_meta
from .replay import (ReplayComparison, ReplayResult, TaskTiming,
                     compare_replays, executor_from_meta, executor_from_spec,
                     replay, task_times)
from .schema import (SCHEMA_VERSION, ColumnarEvents, SubmissionRecord,
                     Trace, TraceSchemaError, event_stolen)
from .storms import (DroppedEventsError, Window, depth_imbalance,
                     detect_inline_bursts, detect_remote_storms,
                     detect_steal_storms, render_timeline, windows)
from .workloads import (Arrival, Workload, benchmark_waves, bursty, diurnal,
                        drive, hot_skew, lognormal_costs, poisson,
                        standard_scenarios)

__all__ = [
    "MeasuredPenalty",
    "TraceReader", "TraceWriter", "dumps_lines", "loads_lines",
    "TraceRecorder", "executor_meta",
    "ReplayComparison", "ReplayResult", "TaskTiming", "compare_replays",
    "executor_from_meta", "executor_from_spec", "replay", "task_times",
    "SCHEMA_VERSION", "ColumnarEvents", "SubmissionRecord", "Trace",
    "TraceSchemaError", "event_stolen",
    "DroppedEventsError", "Window", "depth_imbalance", "detect_inline_bursts",
    "detect_remote_storms", "detect_steal_storms", "render_timeline",
    "windows",
    "Arrival", "Workload", "benchmark_waves", "bursty", "diurnal", "drive",
    "hot_skew", "lognormal_costs", "poisson", "standard_scenarios",
]
