"""Deterministic metrics: counters, gauges, fixed-bucket histograms.

Everything here is exact and reproducible — no randomized sketches, no
sampling, no wall-clock dependence — so two observations of the same run
produce byte-identical snapshots (the same property the replay layer
guarantees for ``RuntimeStats``).  Two complementary tools:

  ``Histogram``            — a *fixed-bucket log-scale* histogram: bucket
                             upper bounds form a geometric ladder declared
                             up front (``lo * growth**i``), so memory is
                             bounded (``buckets + 1`` ints) no matter how
                             many values stream in, and the same values
                             always land in the same buckets.  Quantiles
                             from a histogram are *bucket-resolution*
                             estimates: the reported pNN is the upper bound
                             of the bucket holding the nearest-rank sample
                             (conservative — never under-reports), with the
                             observed min/max tightening the first and last
                             buckets.
  ``percentile(s)``        — *exact* nearest-rank percentiles over a full
                             sample list, for the places that retain every
                             value anyway (per-task sojourns in a replay,
                             the simulator's per-trial MLUP/s samples).
                             ``BENCH_experiments.json``'s p50/p95/p99 come
                             from here, not from bucket estimates.

``Registry`` names and owns a flat set of metrics; ``snapshot()`` renders
them as one plain, sorted, JSON-ready dict — the export surface the
benchmarks and ``ObsReport`` serialize.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Exact nearest-rank percentile (``q`` in [0, 100]) of ``values``.

    Nearest-rank (the smallest value with at least ``q``% of the sample at
    or below it) is deterministic, order-independent, and always returns an
    *observed* value — no interpolation between samples, so p99 of integer
    waits is an integer wait.  Raises on an empty sample.
    """
    if not values:
        raise ValueError("percentile of an empty sample")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q={q!r} outside [0, 100]")
    ordered = sorted(values)
    if q == 0.0:
        return ordered[0]
    rank = math.ceil(q / 100.0 * len(ordered))
    return ordered[rank - 1]


def percentiles(values: Sequence[float],
                qs: Iterable[float] = (50, 95, 99)) -> dict[str, float]:
    """Exact nearest-rank percentiles as a ``{"p50": ..., ...}`` dict.

    The standard latency summary exported into ``BENCH_experiments.json``
    and ``ReplayResult.sojourn_percentiles()``.  Keys are ``p`` + the
    percentile with any trailing ``.0`` dropped (``p99.9`` stays ``p99.9``).
    """
    out = {}
    for q in qs:
        label = f"{float(q):g}"
        out[f"p{label}"] = percentile(values, float(q))
    return out


class Counter:
    """A monotone event count."""

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """A point-in-time level (queue depth, current batch size, ...)."""

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed-bucket log-scale histogram (see module docstring).

    ``buckets`` finite buckets with upper bounds ``lo * growth**i`` plus one
    overflow bucket; values ``<= lo`` land in bucket 0.  The default ladder
    (0.5 · 2ⁱ, 24 buckets) spans 0.5 .. ~4·10⁶ — wide enough for step-clock
    waits and cost-unit services at any benchmark scale.
    """

    def __init__(self, lo: float = 0.5, growth: float = 2.0,
                 buckets: int = 24):
        if lo <= 0:
            raise ValueError("histogram lo must be > 0")
        if growth <= 1.0:
            raise ValueError("histogram growth must be > 1")
        if buckets < 1:
            raise ValueError("histogram needs at least one bucket")
        self.bounds = tuple(lo * growth ** i for i in range(buckets))
        self.counts = [0] * (buckets + 1)    # + overflow
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def record(self, value: float) -> None:
        v = float(value)
        # linear scan beats bisect for the short ladders used here and is
        # trivially deterministic; values above every bound overflow.
        idx = len(self.bounds)
        for i, ub in enumerate(self.bounds):
            if v <= ub:
                idx = i
                break
        self.counts[idx] += 1
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    def record_many(self, values: Iterable[float]) -> None:
        for v in values:
            self.record(v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile: the upper bound of the bucket holding
        the nearest-rank sample, clamped to the observed [min, max].  Exact
        when a bucket holds one distinct value; otherwise an upper estimate
        no farther off than one bucket's width."""
        if self.count == 0:
            raise ValueError("quantile of an empty histogram")
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"quantile q={q!r} outside [0, 100]")
        rank = max(math.ceil(q / 100.0 * self.count), 1)
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                if i >= len(self.bounds):       # overflow bucket
                    return self.vmax
                return min(max(self.bounds[i], self.vmin), self.vmax)
        return self.vmax                         # unreachable

    def nonzero_buckets(self) -> list[list[float]]:
        """``[upper_bound, count]`` pairs for occupied buckets only (the
        overflow bucket reports the observed max as its bound) — the compact
        JSON form of the distribution."""
        out = []
        for i, c in enumerate(self.counts):
            if c:
                ub = self.bounds[i] if i < len(self.bounds) else self.vmax
                out.append([float(ub), int(c)])
        return out

    def snapshot(self):
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.vmin,
            "max": self.vmax,
            "p50": self.quantile(50),
            "p95": self.quantile(95),
            "p99": self.quantile(99),
            "buckets": self.nonzero_buckets(),
        }


@dataclasses.dataclass(frozen=True)
class _Slot:
    kind: str
    metric: object


class Registry:
    """A named, flat set of metrics with one JSON-ready snapshot.

    ``counter``/``gauge``/``histogram`` create on first use and return the
    existing instrument afterwards; asking for the same name as a different
    kind is a bug and raises.  Histogram bucket parameters are fixed at
    creation (an ``ObsSpec`` declares them once for the whole registry).
    """

    def __init__(self, *, hist_lo: float = 0.5, hist_growth: float = 2.0,
                 hist_buckets: int = 24):
        self.hist_lo = hist_lo
        self.hist_growth = hist_growth
        self.hist_buckets = hist_buckets
        self._slots: dict[str, _Slot] = {}

    def _get(self, name: str, kind: str, factory):
        slot = self._slots.get(name)
        if slot is None:
            slot = _Slot(kind, factory())
            self._slots[name] = slot
        elif slot.kind != kind:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{slot.kind}, not {kind}")
        return slot.metric

    def counter(self, name: str) -> Counter:
        return self._get(name, "counter", Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, "gauge", Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, "histogram",
                         lambda: Histogram(self.hist_lo, self.hist_growth,
                                           self.hist_buckets))

    def __contains__(self, name: str) -> bool:
        return name in self._slots

    def names(self) -> list[str]:
        return sorted(self._slots)

    def snapshot(self) -> dict:
        """All metrics, sorted by name: ``{name: value-or-dict}`` (counters
        and gauges flatten to their value; histograms to their stat dict)."""
        return {name: self._slots[name].metric.snapshot()
                for name in self.names()}
