"""Structured A/B trace comparison: ``diff_traces(a, b)``.

"Controlled vs. uncontrolled" and "flat vs. pods" were, until now, two
JSON files and a pair of eyeballs.  This module makes the comparison one
deterministic function call over any two recorded traces (v1–v4, same or
different system shapes):

  * **stats deltas** — every numeric ``RuntimeStats`` key the two footers
    share, as exact ``(a, b, b−a)`` triples;
  * **per-phase histogram deltas** — the critical-path phases
    (``queue_wait`` / ``steal_transfer`` / ``exec``) plus ``sojourn``
    itself, each accumulated into the registry's *shared fixed log-scale
    buckets* (same ladder on both sides, so a per-bucket count delta is
    meaningful) — where the distribution moved, not just its mean;
  * **steal-matrix deltas** — steal counts by topology level (each trace
    priced by its own header's distance matrix) and by (victim → thief)
    domain pair, as count triples;
  * **exact percentile shifts** — nearest-rank p50/p95/p99 of wait /
    sojourn / service on each side, with a *deterministic min-effect
    threshold*: a shift is flagged ``significant`` only when it clears
    ``max(min_abs, min_rel · |a|)``, so step-quantization noise does not
    read as a regression.

Everything is pure post-processing of the two traces: no randomness, no
wall clock, and ``diff_traces(t, t)`` is all-zero by construction (the
property ``tests/test_analytics.py`` gates per registry policy).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ..trace.schema import event_stolen
from .critpath import decompose
from .metrics import Histogram
from .observe import PERCENTILE_QS, observe

# ``Registry``'s standard ladder — both sides of every phase histogram use
# exactly these buckets, which is what makes per-bucket deltas comparable.
HIST_LO, HIST_GROWTH, HIST_BUCKETS = 0.5, 2.0, 24

DIFF_PHASES = ("queue_wait", "steal_transfer", "exec", "sojourn")
PCT_METRICS = ("wait", "sojourn", "service")

# min-effect defaults: half a scheduling round absolute, 2% relative —
# below both, a percentile shift is reported but not significant.
MIN_ABS = 0.5
MIN_REL = 0.02


@dataclasses.dataclass(frozen=True)
class Shift:
    """One exact before/after pair with its delta and significance."""

    a: float
    b: float
    significant: bool = True

    @property
    def delta(self) -> float:
        return self.b - self.a

    def as_tuple(self) -> tuple[float, float, float]:
        return (self.a, self.b, self.delta)


@dataclasses.dataclass(frozen=True)
class HistDelta:
    """Per-bucket count deltas of one phase, on the shared fixed ladder.

    ``buckets`` lists ``[upper_bound, count_a, count_b, count_b - count_a]``
    for every bucket occupied on either side (ascending bound; the overflow
    bucket reports ``inf``).  ``count_a``/``count_b`` are the sample sizes;
    ``mean_a``/``mean_b`` the exact means.
    """

    buckets: tuple[tuple[float, int, int, int], ...]
    count_a: int
    count_b: int
    mean_a: float
    mean_b: float

    @property
    def is_zero(self) -> bool:
        return all(d == 0 for _, _, _, d in self.buckets) \
            and self.count_a == self.count_b

    @property
    def moved(self) -> int:
        """Total per-bucket movement: half the sum of absolute count deltas
        (each relocated sample leaves one bucket and enters another)."""
        return sum(abs(d) for _, _, _, d in self.buckets) // 2


@dataclasses.dataclass
class TraceDiff:
    """The full structured comparison of two traces (B − A everywhere)."""

    stats: dict[str, Shift]
    phases: dict[str, HistDelta]
    steal_levels: dict[int, Shift]
    steal_matrix: dict[tuple[int, int], Shift]
    percentile_shifts: dict[str, dict[str, Shift]]
    tasks: Shift
    min_abs: float
    min_rel: float

    @property
    def is_zero(self) -> bool:
        """True when *every* recorded delta is exactly zero — the
        self-diff invariant (``diff_traces(t, t).is_zero``)."""
        return (all(s.delta == 0 for s in self.stats.values())
                and all(h.is_zero for h in self.phases.values())
                and all(s.delta == 0 for s in self.steal_levels.values())
                and all(s.delta == 0 for s in self.steal_matrix.values())
                and all(s.delta == 0 for d in self.percentile_shifts.values()
                        for s in d.values())
                and self.tasks.delta == 0)

    def significant_shifts(self) -> dict[str, dict[str, Shift]]:
        """Only the percentile shifts that clear the min-effect threshold,
        metric-keyed — the headline of an A/B report."""
        out: dict[str, dict[str, Shift]] = {}
        for metric, qs in self.percentile_shifts.items():
            kept = {q: s for q, s in qs.items() if s.significant}
            if kept:
                out[metric] = kept
        return out

    def snapshot(self) -> dict[str, Any]:
        """One JSON-ready dict of the whole comparison."""
        return {
            "stats": {k: list(s.as_tuple())
                      for k, s in sorted(self.stats.items())},
            "phases": {p: {"count_a": h.count_a, "count_b": h.count_b,
                           "mean_a": h.mean_a, "mean_b": h.mean_b,
                           "moved": h.moved,
                           "buckets": [list(b) for b in h.buckets]}
                       for p, h in self.phases.items()},
            "steal_levels": {str(lv): list(s.as_tuple())
                             for lv, s in sorted(self.steal_levels.items())},
            "steal_matrix": {f"{src}->{dst}": list(s.as_tuple())
                             for (src, dst), s
                             in sorted(self.steal_matrix.items())},
            "percentiles": {m: {q: {"a": s.a, "b": s.b, "delta": s.delta,
                                    "significant": s.significant}
                                for q, s in qs.items()}
                            for m, qs in self.percentile_shifts.items()},
            "tasks": list(self.tasks.as_tuple()),
            "is_zero": self.is_zero,
        }


def _phase_samples(trace, topology=None) -> dict[str, list[float]]:
    """Per-task phase durations in ascending uid order (critpath exactness
    carries over: the sojourn sample is wait + (cost + penalty))."""
    rep = decompose(trace, topology=topology)
    out: dict[str, list[float]] = {p: [] for p in DIFF_PHASES}
    for uid in sorted(rep.tasks):
        b = rep.tasks[uid]
        out["queue_wait"].append(b.queue_wait)
        out["steal_transfer"].append(b.steal_transfer)
        out["exec"].append(b.exec)
        out["sojourn"].append(b.sojourn)
    return out


def _hist(values) -> Histogram:
    h = Histogram(HIST_LO, HIST_GROWTH, HIST_BUCKETS)
    h.record_many(values)
    return h


def _hist_delta(va: list[float], vb: list[float]) -> HistDelta:
    ha, hb = _hist(va), _hist(vb)
    rows = []
    for i in range(len(ha.counts)):
        ca, cb = ha.counts[i], hb.counts[i]
        if ca or cb:
            ub = ha.bounds[i] if i < len(ha.bounds) else float("inf")
            rows.append((ub, ca, cb, cb - ca))
    return HistDelta(buckets=tuple(rows), count_a=ha.count, count_b=hb.count,
                     mean_a=ha.mean, mean_b=hb.mean)


def _steal_counts(trace) -> tuple[dict[int, int], dict[tuple[int, int], int]]:
    """Steals by topology level and by (victim, thief) domain pair, priced
    by the trace's own header topology (flat traces: all level 1)."""
    topology = None
    if trace.topology_dict is not None:
        from ..topology import DistanceMatrix   # lazy: keep import light
        topology = DistanceMatrix.from_dict(trace.topology_dict)
    levels: dict[int, int] = {}
    matrix: dict[tuple[int, int], int] = {}
    for e in trace.events:
        if event_stolen(e):
            lv = (topology.level(e.domain, e.src_domain)
                  if topology is not None else 1)
            levels[lv] = levels.get(lv, 0) + 1
            key = (e.src_domain, e.domain)
            matrix[key] = matrix.get(key, 0) + 1
    return levels, matrix


def _shift(a: float, b: float, min_abs: float, min_rel: float) -> Shift:
    sig = abs(b - a) >= max(min_abs, min_rel * abs(a))
    return Shift(a=a, b=b, significant=sig)


def diff_traces(a, b, *, min_abs: float = MIN_ABS,
                min_rel: float = MIN_REL,
                topology_a: Optional[Any] = None,
                topology_b: Optional[Any] = None) -> TraceDiff:
    """Structured comparison of two recorded traces (B − A).

    The traces may come from different systems (different policies, domain
    counts, topologies): stats keys are intersected, steal levels/pairs are
    unioned, and each side's steals are priced by its own topology.
    ``min_abs``/``min_rel`` set the deterministic min-effect threshold for
    percentile-shift significance (absolute steps / fraction of the A
    value).  ``topology_a``/``topology_b`` override the header matrices.
    """
    # footer stats: exact numeric deltas on the shared keys
    stats: dict[str, Shift] = {}
    for key in sorted(set(a.stats) & set(b.stats)):
        va, vb = a.stats[key], b.stats[key]
        if isinstance(va, (int, float)) and isinstance(vb, (int, float)):
            stats[key] = Shift(a=float(va), b=float(vb))

    # per-phase histogram deltas on the shared fixed ladder
    pa = _phase_samples(a, topology=topology_a)
    pb = _phase_samples(b, topology=topology_b)
    phases = {p: _hist_delta(pa[p], pb[p]) for p in DIFF_PHASES}

    # steal matrices by level and by (victim -> thief) pair
    la, ma = _steal_counts(a)
    lb, mb = _steal_counts(b)
    steal_levels = {lv: Shift(a=float(la.get(lv, 0)), b=float(lb.get(lv, 0)))
                    for lv in sorted(set(la) | set(lb))}
    steal_matrix = {k: Shift(a=float(ma.get(k, 0)), b=float(mb.get(k, 0)))
                    for k in sorted(set(ma) | set(mb))}

    # exact percentile shifts with the min-effect threshold
    obs_a, obs_b = observe(a, topology=topology_a), \
        observe(b, topology=topology_b)
    shifts: dict[str, dict[str, Shift]] = {}
    for metric in PCT_METRICS:
        qa = obs_a.percentiles.get(metric)
        qb = obs_b.percentiles.get(metric)
        if qa is None or qb is None:
            continue
        shifts[metric] = {q: _shift(qa[q], qb[q], min_abs, min_rel)
                          for q in (f"p{p:g}" for p in PERCENTILE_QS)}

    tasks = Shift(a=float(len(pa["sojourn"])), b=float(len(pb["sojourn"])))
    return TraceDiff(stats=stats, phases=phases, steal_levels=steal_levels,
                     steal_matrix=steal_matrix, percentile_shifts=shifts,
                     tasks=tasks, min_abs=min_abs, min_rel=min_rel)
