"""Self-profiling of the scheduler's own hot paths.

The ROADMAP's production-scale question is not "how fast do tasks run" but
"how much does each *scheduling decision* cost" (cf. Wang et al. on
fine-grained parallelism overheads).  ``HotPathProfiler`` answers it with
opt-in ``perf_counter_ns`` timers around the four decision sites the
``Executor`` exposes:

  ``submit_route``  — choosing a queue for a routed submission
                      (router / home / round-robin, in ``submit``)
  ``steal_scan``    — one dequeue attempt: the local check plus the
                      governed victim scan (``DomainQueues.dequeue``)
  ``batch_grab``    — draining batch-mates from the chosen queue
                      (``DomainQueues.drain``; only fires when the batch
                      limit exceeds 1)
  ``event_append``  — appending one event to the ring-buffer ``EventLog``

The profiler is *passive state plus integer adds*: the executor calls
``add(path, ns)`` with an elapsed time it measured itself, so an attached
profiler perturbs nothing but wall clock (scheduling decisions, stats, and
replay remain bit-identical — the obs invariant the tests gate).  With no
profiler attached (the default) the executor skips the timers entirely.

``benchmarks/scheduler_overhead.py`` aggregates these into
``BENCH_overhead.json``: ns/decision per hot path as task and domain count
scale.
"""
from __future__ import annotations

PATHS = ("submit_route", "steal_scan", "batch_grab", "event_append")


class HotPathProfiler:
    """Accumulates total elapsed ns and call counts per hot path."""

    def __init__(self) -> None:
        self.ns = dict.fromkeys(PATHS, 0)
        self.calls = dict.fromkeys(PATHS, 0)

    def add(self, path: str, ns: int) -> None:
        self.ns[path] += ns
        self.calls[path] += 1

    def ns_per_call(self) -> dict[str, float]:
        """Mean ns per decision for every path (0.0 where a path never
        fired — e.g. ``batch_grab`` under single-task grabs)."""
        return {p: (self.ns[p] / self.calls[p] if self.calls[p] else 0.0)
                for p in PATHS}

    @property
    def total_ns(self) -> int:
        return sum(self.ns.values())

    def merge(self, other: "HotPathProfiler") -> None:
        for p in PATHS:
            self.ns[p] += other.ns[p]
            self.calls[p] += other.calls[p]

    def snapshot(self) -> dict:
        return {"ns": dict(self.ns), "calls": dict(self.calls),
                "ns_per_call": self.ns_per_call()}

    def __repr__(self) -> str:
        per = ", ".join(f"{p}={v:.0f}ns" for p, v in self.ns_per_call().items())
        return f"HotPathProfiler({per})"
