"""Steal-storm analysis: windowed detectors over runtime event streams.

The paper's Fig. 4 argument is that aggregate throughput hides what the
scheduler is doing — you need per-thread, per-interval timelines to see the
runs where dynamic scheduling degenerates into a storm of nonlocal accesses.
This module is the online analogue: it folds an event stream (live
``EventLog`` contents or a recorded ``Trace``) into fixed-width step
windows and flags the pathological ones:

  steal storm     — execution in a window dominated by steals: the balance
                    mechanism is bulk-migrating work (paying the nonlocal
                    penalty on most tasks) instead of occasionally topping
                    up an idle domain.
  inline burst    — a burst of submitter-executed tasks: the bounded pool
                    saturated and backpressure kicked in (§2.1), i.e.
                    arrivals outran the worker team.
  depth imbalance — per-domain queue depths diverging inside a window: the
                    leading indicator (deep victim queues) that a storm is
                    about to start.

``render_timeline`` draws the per-worker picture as text — one row per
worker, one column per window, with a marker row underneath flagging storm
windows — the terminal-friendly stand-in for the paper's variability plots.
"""
from __future__ import annotations

import dataclasses
from itertools import islice
from typing import Iterable, Optional, Sequence

from ..runtime import Event
from .schema import event_stolen

EXEC_KINDS = ("run", "steal", "inline")

# streams longer than this are sampled automatically (every k-th event,
# counts scaled by k) unless the caller pins an explicit sample_stride.
# Default ring buffers retain at most 65536 events, so every committed
# analysis stays exact; only deliberately huge streams (streamed segments,
# raised event_maxlen) cross the threshold.
AUTO_SAMPLE_THRESHOLD = 1 << 18


class DroppedEventsError(ValueError):
    """Raised when storm analysis is asked to run over an event window that
    lost events to the ring buffer: a window with holes would silently
    under-count steals/inlines and mis-date every window, so the detectors
    refuse instead of degrading.  Raise ``event_maxlen`` (or analyze
    streamed trace segments) to observe the whole run."""


def _checked_events(events: Iterable[Event]) -> Iterable[Event]:
    """Accept an event iterable, a live ``EventLog``, or a ``Trace``;
    refuse any source that has already dropped events."""
    dropped = getattr(events, "events_dropped", None)    # Trace
    if dropped is None:
        dropped = getattr(events, "dropped", None)       # live EventLog
    if dropped:
        raise DroppedEventsError(
            f"event window lost {dropped} events to the ring buffer; storm "
            "analysis over a holed window would mis-count — raise "
            "event_maxlen or analyze streamed trace segments (pass a plain "
            "event list to override deliberately)")
    inner = getattr(events, "events", None)              # Trace payload
    return inner if inner is not None else events


@dataclasses.dataclass(frozen=True)
class Window:
    """Aggregate of one fixed-width step interval ``[start, start+width)``.

    ``remote_steals`` counts the subset of executed-from-a-foreign-queue
    events whose victim sat at topology level >= 2 from the thief (cross
    socket/pod); it is only populated when ``windows`` is given the
    run's ``DistanceMatrix`` — flat analyses leave it 0.
    """

    start: int
    width: int
    runs: int = 0
    steals: int = 0
    inlines: int = 0
    idles: int = 0
    submits: int = 0
    remote_steals: int = 0

    @property
    def executed(self) -> int:
        return self.runs + self.steals + self.inlines

    @property
    def steal_fraction(self) -> float:
        return self.steals / max(self.executed, 1)

    @property
    def inline_fraction(self) -> float:
        return self.inlines / max(self.executed, 1)

    @property
    def remote_fraction(self) -> float:
        return self.remote_steals / max(self.executed, 1)


def _resolve_stride(events, sample_stride: Optional[int]) -> int:
    """The effective sampling stride for a (possibly sized) event source.

    An explicit ``sample_stride`` wins.  Otherwise sized sources longer
    than ``AUTO_SAMPLE_THRESHOLD`` get the smallest stride that brings the
    sample under the threshold (deterministic — a pure function of the
    length); everything else stays exact (stride 1).
    """
    if sample_stride is not None:
        if sample_stride < 1:
            raise ValueError("sample_stride must be >= 1")
        return sample_stride
    try:
        n = len(events)
    except TypeError:
        return 1
    if n <= AUTO_SAMPLE_THRESHOLD:
        return 1
    return -(-n // AUTO_SAMPLE_THRESHOLD)    # ceil division


def windows(events: Iterable[Event], width: int = 8,
            topology=None, *,
            sample_stride: Optional[int] = None) -> list[Window]:
    """Fold an event stream into consecutive step windows of ``width``.

    With a ``repro.topology.DistanceMatrix`` as ``topology``, each window
    additionally counts its *remote* steals: execution events that took a
    task from a queue at distance level >= 2 (cross socket/pod) — the
    level dimension ``detect_remote_storms`` and the online
    ``control.StormBreaker`` act on.

    ``events`` may be a plain event iterable, a live ``runtime.EventLog``,
    or a recorded ``Trace``.  A log/trace that already *dropped* events to
    its ring buffer is refused with ``DroppedEventsError`` (a holed window
    would silently mis-count); pass ``list(log)`` to analyze the retained
    window deliberately.

    Sampling at large n: folding is per-event, so million-event streams
    (streamed segment traces, raised ``event_maxlen``) would pay a Python
    loop per event.  When the source's length exceeds
    ``AUTO_SAMPLE_THRESHOLD`` (or ``sample_stride=k`` is passed
    explicitly), only every k-th event is folded and each counted
    contribution is weighted by k — window counts become deterministic
    stride-k *estimates* (fractions unbiased, small windows noisier), and
    windows with no sampled events disappear.  ``sample_stride=1`` pins
    the analysis exact regardless of size.  Default-sized ring buffers
    (65536) never auto-sample.
    """
    if width < 1:
        raise ValueError("window width must be >= 1")
    evs = _checked_events(events)
    stride = _resolve_stride(evs, sample_stride)
    source: Iterable[Event] = evs
    if stride > 1:
        source = islice(iter(evs), 0, None, stride)
    acc: dict[int, dict[str, int]] = {}
    for e in source:
        w = acc.setdefault(e.step // width,
                           {"run": 0, "steal": 0, "inline": 0,
                            "idle": 0, "submit": 0, "remote": 0})
        if e.kind in w:
            w[e.kind] += stride
        if (topology is not None and event_stolen(e)
                and topology.level(e.src_domain, e.domain) >= 2):
            w["remote"] += stride
    return [Window(start=k * width, width=width, runs=v["run"],
                   steals=v["steal"], inlines=v["inline"], idles=v["idle"],
                   submits=v["submit"], remote_steals=v["remote"])
            for k, v in sorted(acc.items())]


def detect_steal_storms(events: Iterable[Event], width: int = 8,
                        frac: float = 0.5, min_executed: int = 4, *,
                        sample_stride: Optional[int] = None) -> list[Window]:
    """Windows where at least ``frac`` of executed tasks were steals (and
    enough ran for the fraction to mean anything).  ``sample_stride``
    forwards to ``windows`` (sampled estimates at large n)."""
    return [w for w in windows(events, width, sample_stride=sample_stride)
            if w.executed >= min_executed and w.steal_fraction >= frac]


def detect_remote_storms(events: Iterable[Event], topology, width: int = 8,
                         frac: float = 0.25,
                         min_executed: int = 4, *,
                         sample_stride: Optional[int] = None) -> list[Window]:
    """Windows where cross-tier (topology level >= 2) steals make up at
    least ``frac`` of executed tasks: work is leaving its socket/pod in
    bulk, each migration paying the scaled deep-link penalty.  The evidence
    bar defaults *lower* than ``detect_steal_storms`` — remote steals cost
    more apiece, so fewer justify flagging — matching the online
    ``control.StormBreaker(remote_frac=...)`` detector."""
    return [w for w in windows(events, width, topology=topology,
                               sample_stride=sample_stride)
            if w.executed >= min_executed and w.remote_fraction >= frac]


def detect_inline_bursts(events: Iterable[Event], width: int = 8,
                         frac: float = 0.25, min_executed: int = 4, *,
                         sample_stride: Optional[int] = None) -> list[Window]:
    """Windows where backpressure made the submitter do ≥ ``frac`` of the
    executing — the pool-saturated regime."""
    return [w for w in windows(events, width, sample_stride=sample_stride)
            if w.executed >= min_executed and w.inline_fraction >= frac]


def depth_imbalance(depth_series: Sequence[tuple[int, tuple[int, ...]]],
                    width: int = 8) -> list[tuple[int, float]]:
    """Per-window queue-depth imbalance from ``MetricsRecorder.depth_series``.

    Imbalance of one sample is ``max(depths) - mean(depths)`` (how far the
    deepest queue runs ahead of the average, in tasks); each window reports
    its worst sample.  Returns ``[(window_start, imbalance), ...]``.
    """
    acc: dict[int, float] = {}
    for step, sizes in depth_series:
        if not sizes:
            continue
        imb = max(sizes) - sum(sizes) / len(sizes)
        key = step // width
        acc[key] = max(acc.get(key, 0.0), imb)
    return [(k * width, v) for k, v in sorted(acc.items())]


def _cell(runs: int, steals: int, inlines: int, idles: int) -> str:
    executed = runs + steals + inlines
    if executed == 0:
        return "·" if idles == 0 else "i"
    if steals >= max(runs, inlines):
        return "S"
    if inlines >= max(runs, steals):
        return "I"
    return "r"


def render_timeline(events: Iterable[Event], num_workers: int,
                    width: int = 8, storm_frac: float = 0.5,
                    min_executed: int = 4) -> str:
    """Text timeline: one row per worker, one column per step window.

    Cell legend: ``r`` run-dominated, ``S`` steal-dominated, ``I`` inline-
    dominated (backpressure), ``i`` idle polls only, ``·`` no activity.
    A marker row underneath carries ``^`` beneath detected steal-storm
    windows.  This is the Fig. 4 per-thread variability picture rendered
    for a terminal.
    """
    evs = list(events)
    if not evs:
        return "(no events)"
    n_win = max(e.step for e in evs) // width + 1
    per_worker = [[[0, 0, 0, 0] for _ in range(n_win)]
                  for _ in range(num_workers)]
    for e in evs:
        if 0 <= e.worker < num_workers:
            cell = per_worker[e.worker][e.step // width]
            if e.kind == "run":
                cell[0] += 1
            elif e.kind == "steal":
                cell[1] += 1
            elif e.kind == "inline":
                cell[2] += 1
            elif e.kind == "idle":
                cell[3] += 1
    storm_keys = {w.start // width
                  for w in detect_steal_storms(evs, width, storm_frac,
                                               min_executed)}
    label = max(len(f"w{num_workers - 1}"), 5)
    lines = [f"{'steps':>{label}} 0..{n_win * width} in windows of {width} "
             f"(r=run S=steal I=inline i=idle ·=none)"]
    for wid in range(num_workers):
        row = "".join(_cell(*c) for c in per_worker[wid])
        lines.append(f"{f'w{wid}':>{label}} {row}")
    marker = "".join("^" if k in storm_keys else " " for k in range(n_win))
    lines.append(f"{'storm':>{label}} {marker}".rstrip())
    return "\n".join(lines)
