"""Trace record formats and schema versioning.

A *trace* is everything needed to (a) re-drive an ``Executor`` through the
exact same submit/step interleaving it saw online and (b) analyze what the
scheduler did.  It has four record kinds, serialized one-JSON-object-per-line
(JSONL, see ``repro.trace.io``):

  header      — schema version + the executor's construction parameters
                (``num_domains``, ``worker_domains``, ``steal_order``,
                ``pool_cap``, ``seed``, governor class name) and, for
                executors built from a ``repro.spec.RuntimeSpec`` (schema
                v2), the full serialized spec under ``spec`` — the complete
                name of the system that produced the trace, enough for
                ``replay()`` to reconstruct it with no executor argument
  submission  — one per submitted task: ``(uid, step, home, cost, domain)``
                where ``step`` is the scheduling round at submission time
                (the arrival clock) and ``domain`` the queue it was routed
                to.  This is the *complete* replay input: payloads are
                opaque and deliberately not serialized.
  event       — one per retained ``runtime.Event`` (window semantics: the
                ring buffer keeps the newest ``event_maxlen`` events; the
                header's ``events_total`` counts carry whole-run totals).
  events      — schema v5's columnar alternative to per-``event`` lines: one
                record carries a *chunk* of consecutive events as parallel
                column lists (``{"columns": {"step": [...], "kind": [...],
                ...}, "n": N}``).  Readers decode chunks lazily
                (``ColumnarEvents``), so a million-event trace parses
                without building a million ``Event`` objects up front.
                Writers choose per trace: per-event records (the default,
                maximally greppable) or chunks (compact, fast).
  footer      — end-of-run ground truth: ``total_steps`` plus the full
                ``RuntimeStats`` snapshot, the replay-fidelity oracle.

``SCHEMA_VERSION`` gates the reader: traces written by a future incompatible
format raise instead of silently mis-replaying.  v1 traces (pre-spec
headers) stay readable — their headers simply carry no ``spec``, so replay
falls back to ``executor_from_meta`` / an explicit factory, as before v2.
v2 traces (pre-topology headers) likewise stay readable: no ``topology``
block simply means the flat machine, which is what every v2 executor was.
Schema v3 adds the serialized ``repro.topology.DistanceMatrix`` under
``topology`` when the recorded executor carried one, so a hierarchical
trace replays bit-identically from its header alone.
Schema v4 adds the serialized ``repro.spec.ObsSpec`` under ``obs`` when the
recorded run carried a live observation (``RuntimeSpec.obs.enabled``) — an
informational block naming how the run was observed.  Observation never
perturbs the schedule (the obs layer's gated invariant), so v1–v3 readers
and replays need nothing from it, and v3 traces (no ``obs``) stay readable:
the run simply was not observed.
Schema v5 adds the columnar ``events`` chunk record.  v1–v4 traces (only
per-event records) stay readable unchanged; a v5 trace that sticks to
per-event records is byte-compatible with v4 apart from the header's
version stamp.
"""
from __future__ import annotations

import dataclasses
from bisect import bisect_right
from collections.abc import Sequence as _SequenceABC
from typing import Any, Iterable, Iterator, Sequence

from ..runtime import Event

SCHEMA_VERSION = 5
SUPPORTED_SCHEMAS = (1, 2, 3, 4, SCHEMA_VERSION)
TRACE_KIND = "repro.runtime-trace"

# serialization order of the per-event columns in an ``events`` chunk
EVENT_COLUMNS = ("step", "kind", "worker", "domain", "task_uid",
                 "src_domain", "cost", "penalty")


class TraceSchemaError(ValueError):
    """Raised when a trace's schema/shape doesn't match this reader."""


def _decode_chunk(columns: dict[str, list]) -> list[Event]:
    """Materialize one chunk's column lists into ``Event`` objects."""
    return [Event(step=int(s), kind=str(k), worker=int(w), domain=int(d),
                  task_uid=int(u), src_domain=int(sd), cost=float(c),
                  penalty=float(p))
            for s, k, w, d, u, sd, c, p in zip(*(columns[col]
                                                 for col in EVENT_COLUMNS))]


class ColumnarEvents(_SequenceABC):
    """Lazy event sequence backed by schema-v5 columnar chunks.

    Holds the parsed chunk payloads (plain column lists) and decodes
    ``Event`` objects only when iterated or indexed — ``len`` / slicing /
    elementwise ``==`` against any event sequence all work, so consumers
    written against ``list[Event]`` (storm detection, span assembly,
    ``service_times``) run unchanged.  Parts may interleave chunks with
    already-materialized event runs (a trace mixing per-event and chunk
    records decodes in record order).
    """

    def __init__(self, parts: list[tuple[int, Any]]):
        # parts: (n, payload) in record order; payload is a columns dict
        # (lazy chunk) or a list[Event] (pre-materialized run)
        self._parts = parts
        self._offsets = [0]
        for n, _ in parts:
            self._offsets.append(self._offsets[-1] + n)

    def __len__(self) -> int:
        return self._offsets[-1]

    def __iter__(self) -> Iterator[Event]:
        for _, payload in self._parts:
            if isinstance(payload, dict):
                yield from _decode_chunk(payload)
            else:
                yield from payload

    def __getitem__(self, i):
        if isinstance(i, slice):
            return list(self)[i]
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError("ColumnarEvents index out of range")
        part = bisect_right(self._offsets, i) - 1
        local = i - self._offsets[part]
        payload = self._parts[part][1]
        if isinstance(payload, dict):
            return Event(step=int(payload["step"][local]),
                         kind=str(payload["kind"][local]),
                         worker=int(payload["worker"][local]),
                         domain=int(payload["domain"][local]),
                         task_uid=int(payload["task_uid"][local]),
                         src_domain=int(payload["src_domain"][local]),
                         cost=float(payload["cost"][local]),
                         penalty=float(payload["penalty"][local]))
        return payload[local]

    def __eq__(self, other) -> bool:
        if not isinstance(other, (list, tuple, ColumnarEvents)):
            return NotImplemented
        if len(other) != len(self):
            return False
        return all(a == b for a, b in zip(self, other))

    __hash__ = None   # mutable-ish sequence semantics, like list

    def __repr__(self) -> str:
        return (f"ColumnarEvents(n={len(self)}, "
                f"parts={len(self._parts)})")


def events_chunk_dict(events: Sequence[Event]) -> dict[str, Any]:
    """Serialize a run of consecutive events as one columnar chunk record."""
    return {"record": "events", "n": len(events),
            "columns": {
                "step": [e.step for e in events],
                "kind": [e.kind for e in events],
                "worker": [e.worker for e in events],
                "domain": [e.domain for e in events],
                "task_uid": [e.task_uid for e in events],
                "src_domain": [e.src_domain for e in events],
                "cost": [e.cost for e in events],
                "penalty": [e.penalty for e in events],
            }}


@dataclasses.dataclass(frozen=True)
class SubmissionRecord:
    """One recorded ``Executor.submit``: the replayable arrival."""

    uid: int
    step: int          # executor step count when the task was enqueued
    home: int
    cost: float
    domain: int        # the queue the executor routed it to


@dataclasses.dataclass
class Trace:
    """In-memory form of a recorded run (see module docstring)."""

    meta: dict[str, Any]
    submissions: list[SubmissionRecord]
    # list[Event] for per-event traces, ColumnarEvents for chunked (v5)
    # ones; both are event sequences and compare elementwise
    events: Sequence[Event]
    total_steps: int
    stats: dict[str, float]
    event_counts: dict[str, int] = dataclasses.field(default_factory=dict)
    events_retained: int = 0

    @property
    def num_domains(self) -> int:
        return int(self.meta["num_domains"])

    @property
    def spec_dict(self) -> dict[str, Any] | None:
        """The serialized ``repro.spec.RuntimeSpec`` embedded in the header
        (schema v2, spec-built executors), or None for v1 / raw-kwarg
        traces.  Parse with ``repro.spec.RuntimeSpec.from_dict``."""
        return self.meta.get("spec")

    @property
    def topology_dict(self) -> dict[str, Any] | None:
        """The serialized ``repro.topology.DistanceMatrix`` the recorded
        executor stole across (schema v3, topology-built executors), or
        None for flat machines and v1/v2 traces.  Parse with
        ``repro.topology.DistanceMatrix.from_dict``."""
        return self.meta.get("topology")

    @property
    def obs_dict(self) -> dict[str, Any] | None:
        """The serialized ``repro.spec.ObsSpec`` the recorded run was
        observed under (schema v4, obs-enabled spec-built executors), or
        None for unobserved runs and v1–v3 traces.  Purely informational:
        observation never changes the schedule."""
        return self.meta.get("obs")

    @property
    def events_dropped(self) -> int:
        """Events the recorded run's ring buffer discarded before the trace
        was cut (whole-run totals minus the retained window).  A nonzero
        value means ``events`` is a *window* of the run — window-sensitive
        analyses (``repro.trace.storms``) refuse such traces."""
        total = sum(self.event_counts.values()) if self.event_counts else 0
        return max(total - self.events_retained, 0)

    @property
    def experiment_dict(self) -> dict[str, Any] | None:
        """The serialized ``repro.spec.ExperimentSpec`` embedded in the
        header when the run was driven by ``repro.spec.experiments``
        (policy + workload + run parameters), or None.  Parse with
        ``repro.spec.ExperimentSpec.from_dict``."""
        return self.meta.get("experiment")

    @property
    def n_tasks(self) -> int:
        return len(self.submissions)

    def service_times(self) -> dict[str, list[float]]:
        """Measured per-task service times from the retained execution
        events, keyed by how the task was served (``run``/``steal``/
        ``inline``).  A steal's service is its cost plus the nonlocal
        penalty actually charged — the raw material for
        ``repro.trace.MeasuredPenalty``.  Stolenness is judged by the
        victim queue, not the event kind: a backpressure ``inline``
        execution that took a foreign task counts as ``steal`` (the
        executor labels it ``inline`` but it pays the nonlocal penalty
        all the same)."""
        out: dict[str, list[float]] = {"run": [], "steal": [], "inline": []}
        for e in self.events:
            if e.kind in out:
                key = "steal" if event_stolen(e) else e.kind
                out[key].append(e.service)
        return out


def event_stolen(e: Event) -> bool:
    """True when an execution event took its task from a foreign queue
    (``run``/``steal``/``inline`` alike): the victim queue differs from the
    worker's own domain.  Matches the executor's ``stolen`` accounting,
    which the ``inline`` kind label hides for backpressure steals."""
    return (e.kind in ("run", "steal", "inline")
            and e.src_domain >= 0 and e.src_domain != e.domain)


# -- dict (de)serialization, one record per line -----------------------------

def header_dict(meta: dict[str, Any]) -> dict[str, Any]:
    return {"record": "header", "kind": TRACE_KIND,
            "schema": SCHEMA_VERSION, **meta}


def submission_dict(s: SubmissionRecord) -> dict[str, Any]:
    return {"record": "submission", "uid": s.uid, "step": s.step,
            "home": s.home, "cost": s.cost, "domain": s.domain}


def event_dict(e: Event) -> dict[str, Any]:
    return {"record": "event", "step": e.step, "kind": e.kind,
            "worker": e.worker, "domain": e.domain, "task_uid": e.task_uid,
            "src_domain": e.src_domain, "cost": e.cost, "penalty": e.penalty}


def footer_dict(trace: Trace) -> dict[str, Any]:
    return {"record": "footer", "total_steps": trace.total_steps,
            "stats": trace.stats, "event_counts": trace.event_counts,
            "events_retained": trace.events_retained}


def parse_records(records: Iterable[dict[str, Any]]) -> Trace:
    """Assemble a ``Trace`` from parsed record dicts, validating schema."""
    meta: dict[str, Any] | None = None
    submissions: list[SubmissionRecord] = []
    events: list[Event] = []          # current run of per-event records
    parts: list[tuple[int, Any]] = []  # chunk / event-run parts, in order
    footer: dict[str, Any] = {}

    def flush_events() -> None:
        nonlocal events
        if events:
            parts.append((len(events), events))
            events = []

    for rec in records:
        r = rec.get("record")
        if r == "header":
            if rec.get("kind") != TRACE_KIND:
                raise TraceSchemaError(f"not a runtime trace: {rec.get('kind')!r}")
            if rec.get("schema") not in SUPPORTED_SCHEMAS:
                raise TraceSchemaError(
                    f"trace schema {rec.get('schema')!r} not in "
                    f"supported {SUPPORTED_SCHEMAS}")
            meta = {k: v for k, v in rec.items()
                    if k not in ("record", "kind", "schema")}
        elif r == "submission":
            submissions.append(SubmissionRecord(
                uid=int(rec["uid"]), step=int(rec["step"]),
                home=int(rec["home"]), cost=float(rec["cost"]),
                domain=int(rec["domain"])))
        elif r == "event":
            events.append(Event(
                step=int(rec["step"]), kind=str(rec["kind"]),
                worker=int(rec["worker"]), domain=int(rec["domain"]),
                task_uid=int(rec["task_uid"]),
                src_domain=int(rec.get("src_domain", -1)),
                cost=float(rec.get("cost", 0.0)),
                penalty=float(rec.get("penalty", 0.0))))
        elif r == "events":
            columns = rec.get("columns")
            if not isinstance(columns, dict):
                raise TraceSchemaError("events chunk has no columns dict")
            missing = [c for c in EVENT_COLUMNS if c not in columns]
            if missing:
                raise TraceSchemaError(
                    f"events chunk missing columns {missing}")
            n = int(rec.get("n", len(columns["step"])))
            bad = [c for c in EVENT_COLUMNS if len(columns[c]) != n]
            if bad:
                raise TraceSchemaError(
                    f"events chunk declares n={n} but columns {bad} "
                    "have a different length")
            flush_events()
            parts.append((n, columns))   # decoded lazily (ColumnarEvents)
        elif r == "footer":
            footer = rec
        else:
            raise TraceSchemaError(f"unknown trace record {r!r}")
    if meta is None:
        raise TraceSchemaError("trace has no header record")
    all_events: Sequence[Event]
    if parts:
        flush_events()
        all_events = ColumnarEvents(parts)
    else:
        all_events = events   # per-event-only trace: a plain list, as ever
    return Trace(meta=meta, submissions=submissions, events=all_events,
                 total_steps=int(footer.get("total_steps", 0)),
                 stats=dict(footer.get("stats", {})),
                 event_counts=dict(footer.get("event_counts", {})),
                 events_retained=int(footer.get("events_retained",
                                                len(all_events))))
