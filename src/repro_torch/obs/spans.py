"""Per-task lifecycle spans, reconstructed from the event stream.

The runtime already records everything a per-task timeline needs — the
submission trace carries each arrival (uid, step, home, cost, routed
domain) and the event log carries each execution decision (step, worker,
kind, victim queue, cost, penalty).  This module folds the two into one
*span tree per task*, purely post hoc: nothing here touches the hot path,
and observing a recorded run twice yields identical trees.

Each task's root span covers its whole sojourn and nests a well-ordered
child path::

    task #uid  [submit_step .. exec_step + service]
      queued   [submit_step .. exec_step]        the wait in its routed queue
      steal    [exec_step]                       only when taken from a
                                                 foreign queue: victim,
                                                 thief, topology level,
                                                 link distance, penalty paid
      exec     [exec_step .. exec_step + service] the execution itself
                                                 (``kind`` attr: run /
                                                 steal / inline), with batch
                                                 grouping attached (grab
                                                 size + index within the
                                                 grab)

Well-nestedness (children ordered, non-overlapping, inside the parent) and
one-path-per-task are load-bearing invariants — the hypothesis property
tests in ``tests/test_obs.py`` gate them.

Only tasks whose execution event is still inside the (ring-buffered) event
window get a span; ``assemble_spans`` also returns the uids it could not
reconstruct so a truncated window is never mistaken for an idle scheduler.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping, Optional, Sequence

from ..runtime import Event
from ..trace.schema import event_stolen

EXEC_KINDS = ("run", "steal", "inline")


@dataclasses.dataclass(frozen=True)
class Span:
    """One named interval on the step clock, with attributes and children.

    ``start``/``end`` are in scheduling rounds (the run's only clock);
    instantaneous markers (a steal hand-off) have ``start == end``.
    """

    name: str
    start: float
    end: float
    attrs: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    children: tuple["Span", ...] = ()

    @property
    def duration(self) -> float:
        return self.end - self.start

    def well_nested(self) -> bool:
        """True when every child lies inside this span, children are
        ordered by start and do not overlap, and each child is itself
        well-nested."""
        prev_end = self.start
        for c in self.children:
            if c.start < prev_end or c.end > self.end or c.end < c.start:
                return False
            if not c.well_nested():
                return False
            prev_end = max(prev_end, c.start)
        return True

    def walk(self) -> Iterable["Span"]:
        yield self
        for c in self.children:
            yield from c.walk()


@dataclasses.dataclass(frozen=True)
class SpanForest:
    """All reconstructed task spans of one run.

    ``spans`` maps uid -> root span; ``missing`` lists submitted uids whose
    execution event was not in the event window (dropped by the ring buffer
    or simply never executed before the trace was cut).
    """

    spans: dict[int, Span]
    missing: tuple[int, ...]

    def __len__(self) -> int:
        return len(self.spans)

    def __getitem__(self, uid: int) -> Span:
        return self.spans[uid]

    def __iter__(self) -> Iterable[Span]:
        return iter(self.spans.values())


def _batch_positions(events: Sequence[Event]) -> dict[int, tuple[int, int]]:
    """uid -> (batch_index, batch_size) from execution-event adjacency.

    A batch grab executes its tasks back-to-back on one worker within one
    step, so consecutive execution events sharing ``(step, worker)`` in
    stream order are one grab.  Single-task grabs get (0, 1).
    """
    groups: dict[tuple[int, int], list[int]] = {}
    for e in events:
        if e.kind in EXEC_KINDS and e.task_uid >= 0:
            groups.setdefault((e.step, e.worker), []).append(e.task_uid)
    out: dict[int, tuple[int, int]] = {}
    for uids in groups.values():
        for i, uid in enumerate(uids):
            out[uid] = (i, len(uids))
    return out


def spans_from(submissions, events: Sequence[Event],
               topology=None) -> SpanForest:
    """Assemble the span forest from raw submissions + events.

    ``submissions`` is any iterable of submission records (``uid``,
    ``step``, ``home``, ``cost``, ``domain`` attributes — the trace's
    ``SubmissionRecord``).  ``topology`` (a ``repro.topology
    .DistanceMatrix``) prices each steal's level/distance; without one the
    flat machine's level 1 / distance 1.0 is reported, matching the
    executor's own flat accounting.
    """
    events = list(events)
    submitted = {s.uid: s for s in submissions}
    batch_pos = _batch_positions(events)
    spans: dict[int, Span] = {}
    for e in events:
        if e.kind not in EXEC_KINDS or e.task_uid not in submitted:
            continue
        sub = submitted[e.task_uid]
        start, exec_step = float(sub.step), float(e.step)
        end = exec_step + e.service
        children = [Span("queued", start, exec_step,
                         attrs={"domain": sub.domain})]
        if event_stolen(e):
            if topology is not None:
                level = topology.level(e.domain, e.src_domain)
                distance = topology.distance(e.domain, e.src_domain)
            else:
                level, distance = 1, 1.0
            children.append(Span("steal", exec_step, exec_step, attrs={
                "src_domain": e.src_domain, "domain": e.domain,
                "level": level, "distance": distance,
                "penalty": e.penalty}))
        bi, bs = batch_pos.get(e.task_uid, (0, 1))
        children.append(Span("exec", exec_step, end, attrs={
            "kind": e.kind, "worker": e.worker, "domain": e.domain,
            "cost": e.cost, "penalty": e.penalty, "batch_index": bi,
            "batch_size": bs}))
        spans[e.task_uid] = Span("task", start, end, attrs={
            "uid": e.task_uid, "home": sub.home, "cost": sub.cost,
            "routed": sub.domain}, children=tuple(children))
    missing = tuple(uid for uid in submitted if uid not in spans)
    return SpanForest(spans=spans, missing=missing)


def assemble_spans(trace, topology: Optional[Any] = None) -> SpanForest:
    """Assemble per-task spans from a recorded ``repro.trace.Trace``.

    Uses the distance matrix embedded in a schema-v3+ header (so steal
    spans carry the exact level/distance the executor charged) unless an
    explicit ``topology`` is passed; v1/v2 and flat traces report the flat
    level-1 accounting.
    """
    if topology is None and trace.topology_dict is not None:
        from ..topology import DistanceMatrix     # lazy: keep import light
        topology = DistanceMatrix.from_dict(trace.topology_dict)
    return spans_from(trace.submissions, trace.events, topology=topology)
