"""Recording a live ``Executor`` run into a replayable ``Trace``.

``TraceRecorder`` attaches to an executor via its ``submit_hook`` (the only
instrumentation point recording needs: everything else the runtime already
traces in its ``EventLog``), accumulates one ``SubmissionRecord`` per
enqueued task, and on ``finish()`` snapshots the executor's construction
meta, retained events, whole-run event counts, and final ``RuntimeStats``
into a ``Trace``.

Usage::

    rec = TraceRecorder()
    ex = rec.attach(Executor(4, steal_penalty=...))
    ... drive ex (submit/step/run_until_drained) ...
    trace = rec.finish()
    TraceWriter(path).write(trace)           # repro.trace.io

Long-running servers can stream instead of snapshotting: pass a segmented
``TraceWriter`` (``segment_records=N``) as ``stream`` and the recorder
writes the header at ``attach`` time and every submission as it happens;
``finish()`` then only appends the retained events and the footer — no
whole-trace export pause.  A writer configured with ``columnar_events=N``
streams those events as schema-v5 chunk records (one line per N events)
instead of one line each.  When controllers rewire the executor
(``repro.control.ControlLoop`` swaps the governor), attach them *before*
the recorder so the streamed header names the effective governor.
"""
from __future__ import annotations

from typing import Optional, TYPE_CHECKING

from ..runtime import Executor, Task
from .schema import SubmissionRecord, Trace

if TYPE_CHECKING:                                # no import cycle at runtime
    from .io import TraceWriter


def executor_meta(ex: Executor) -> dict:
    """The executor construction parameters a trace header records.

    For executors built from a ``repro.spec.RuntimeSpec`` (``ex.spec`` is
    set), the full serialized spec rides along under ``"spec"`` — the
    schema-v2 guarantee that a trace completely names the system that
    produced it (``replay(trace)`` rebuilds it with no executor argument).
    The flat v1 fields stay alongside for older readers and quick greps.
    """
    meta = {
        "num_domains": ex.num_domains,
        "worker_domains": [w.domain for w in ex.pool],
        "steal_order": ex.queues.steal_order,
        "pool_cap": ex.pool_cap,
        "seed": ex.seed,
        "governor": type(ex.governor).__name__,
    }
    topology = getattr(ex, "topology", None)
    if topology is not None:
        # schema v3: the distance matrix the steal scan walked — replay can
        # rebuild the hierarchical executor from the header alone, spec or
        # no spec.
        meta["topology"] = topology.to_dict()
    spec = getattr(ex, "spec", None)
    if spec is not None:
        meta["spec"] = spec.to_dict()
    obs = getattr(ex, "obs", None)
    if obs is not None:
        # schema v4: name how the run was observed.  Informational only —
        # observation is passive, so replay needs nothing from this block.
        meta["obs"] = obs.spec.to_dict()
    experiment = getattr(ex, "experiment", None)
    if experiment is not None:
        # executors driven by repro.spec.experiments also name the full
        # experiment (policy + workload + run parameters) that produced
        # the trace; replay only needs "spec", but the workload block makes
        # the trace a self-describing experiment artifact.
        meta["experiment"] = experiment.to_dict()
    return meta


class TraceRecorder:
    """Capture an executor run as a replayable submission + event trace."""

    def __init__(self, stream: Optional["TraceWriter"] = None) -> None:
        self.submissions: list[SubmissionRecord] = []
        self.stream = stream
        self._ex: Optional[Executor] = None

    def attach(self, executor: Executor) -> Executor:
        """Hook into ``executor`` and return it (chainable).  The executor
        should record events (``record_events=True``, the default) if storm
        analysis or measured-penalty feedback is wanted; the submission
        trace alone is enough for replay."""
        if self._ex is not None:
            raise RuntimeError("TraceRecorder is already attached; "
                               "use one recorder per run")
        executor.submit_hook = self._on_submit
        self._ex = executor
        if self.stream is not None:
            self.stream.begin(executor_meta(executor))
        return executor

    def _on_submit(self, task: Task, domain: int, step: int) -> None:
        rec = SubmissionRecord(uid=task.uid, step=step, home=task.home,
                               cost=float(task.cost), domain=domain)
        self.submissions.append(rec)
        if self.stream is not None:
            self.stream.add_submission(rec)

    @property
    def executor(self) -> Executor:
        if self._ex is None:
            raise RuntimeError("TraceRecorder is not attached to an executor")
        return self._ex

    def finish(self) -> Trace:
        """Snapshot the attached executor's end-of-run state as a ``Trace``.

        Call after the drive loop (typically after ``run_until_drained``);
        calling mid-run simply yields a trace of the run so far.  With a
        ``stream`` writer attached, also appends the retained events and
        the footer to the stream and closes it.
        """
        ex = self.executor
        events = list(ex.events) if ex.events is not None else []
        counts = ex.events.counts() if ex.events is not None else {}
        trace = Trace(meta=executor_meta(ex),
                      submissions=list(self.submissions),
                      events=events, total_steps=ex.step_count,
                      stats=ex.metrics.snapshot(), event_counts=counts,
                      events_retained=len(events))
        if self.stream is not None:
            self.stream.add_events(events)
            self.stream.end(trace)
            self.stream = None
        return trace
