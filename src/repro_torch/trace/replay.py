"""Deterministic replay: re-drive an ``Executor`` from a recorded trace.

The runtime is deterministic by construction (cooperative round-robin
workers, seeded RNG), so a run is fully determined by (a) the executor's
construction parameters and (b) the interleaving of ``submit`` and ``step``
calls.  A trace records exactly that: each submission carries the step-clock
value at which it was enqueued plus the queue it was routed to, and the
footer carries the total step count.  ``replay`` reconstructs the
interleaving:

    for each recorded submission, step the executor until its step clock
    matches, then submit an equivalent task (same uid/home/cost) to the
    recorded queue; finally step out the remaining recorded rounds and
    drain.

Because the routed domain is recorded, replay is *schedule-faithful* on the
submission side regardless of how the original chose queues (home routing,
round-robin, explicit) — and the execution side re-decides under whatever
governor/steal-order the replay executor carries.  That is the point: the
same arrival sequence, different policy ⇒ an honest A/B of steal policies
(``benchmarks/trace_replay.py``).  With a policy-equivalent executor (the
default factory + the recorded governor semantics and the same penalty
function), the replayed ``RuntimeStats`` reproduce the recorded ones
bit-for-bit — asserted by ``ReplayResult.matches_recorded``.

Two counterfactual extensions:

  * ``reroute=True`` keeps the arrival sequence but lets the replay
    executor re-decide the submit domains — the A/B for *routing* policies
    (the recorded-domain default is the A/B for *steal* policies).
  * ``ReplayResult.task_times`` + ``compare_replays`` report per-task
    wait/sojourn and their per-uid deltas between two replays of the same
    trace, so a governor change is judged by which tasks it helped and
    hurt, not only by aggregate stats.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Optional

from ..runtime import (AdaptiveSteal, Event, Executor, GreedySteal, NoSteal,
                       StealGovernor, Task)
from .feedback import MeasuredPenalty
from .schema import Trace

GOVERNORS: dict[str, Callable[[], StealGovernor]] = {
    "GreedySteal": GreedySteal,
    "NoSteal": NoSteal,
    "AdaptiveSteal": AdaptiveSteal,
    "StealGovernor": StealGovernor,
    "MeasuredPenalty": MeasuredPenalty,
}

# stats keys that must agree for a replay to count as exact; results of
# handlers (payload-dependent) are deliberately out of scope.
FIDELITY_KEYS = ("submitted", "executed", "local", "stolen", "inline_runs",
                 "idle_polls", "steal_penalty", "max_pool_depth",
                 "local_fraction", "steal_fraction")
# keys checked only when the recorded footer carries them: v1/v2 traces
# predate remote-steal accounting, and their absence must not fail replays.
OPTIONAL_FIDELITY_KEYS = ("remote_steals",)


def executor_from_spec(trace: Trace) -> Executor:
    """Reconstruct the *exact* recorded system from the spec embedded in a
    schema-v2 trace header: governor (with breaker decoration), router,
    batch policy, penalty rule and all — the configuration is data, so no
    hand-written factory is needed.  Raises ``ValueError`` when the trace
    carries no spec (v1 traces, raw-kwarg executors): pass an explicit
    ``executor_factory`` instead, as before v2.
    """
    sd = trace.spec_dict
    if sd is None:
        raise ValueError(
            "trace header embeds no spec (v1 trace or raw-kwarg executor); "
            "pass an executor_factory, e.g. executor_from_meta")
    from ..spec import RuntimeSpec, TraceSpec   # lazy: spec builds trace objs
    spec = RuntimeSpec.from_dict(sd)
    # Replay re-drives the *scheduler*; re-attaching the recorded run's own
    # recorder would at best waste memory and at worst (streamed segments)
    # demand a trace_path nobody has — recording is the one block a replay
    # deliberately does not reconstruct.  Stats are unaffected.
    return dataclasses.replace(spec, trace=TraceSpec()).build().executor


def executor_from_meta(trace: Trace, *,
                       governor: StealGovernor | None = None,
                       steal_penalty=None, handler=None,
                       steal_order: str | None = None) -> Executor:
    """Build a fresh executor matching the trace header.

    ``governor=None`` reconstructs the recorded governor *class* (default
    construction — governor hyper-parameters are not serialized; pass an
    instance to override).  A recorded governor name this module cannot
    reconstruct (e.g. ``StormBreaker``, which needs its control loop)
    raises instead of silently substituting the default — pass an explicit
    ``governor`` (or a full factory that rebuilds the control plane, as
    ``benchmarks.control_plane`` does).  ``steal_penalty``/``handler``/
    ``steal_order`` override the respective knobs for policy A/B replays.

    Schema-v3 headers carry the recorded ``repro.topology.DistanceMatrix``
    under ``topology``; it is rebuilt and handed to the fresh executor, so
    hierarchical traces replay their nearest-first steal scans exactly.
    """
    meta = trace.meta
    if governor is None:
        name = meta.get("governor")
        if name is not None and name not in GOVERNORS:
            raise ValueError(
                f"trace was recorded under governor {name!r}, which "
                "executor_from_meta cannot reconstruct; pass governor= "
                "explicitly (or a factory that rebuilds it)")
        factory = GOVERNORS.get(str(name))
        governor = factory() if factory is not None else None
    topology = None
    if meta.get("topology") is not None:
        from ..topology import DistanceMatrix   # lazy: keep import light
        topology = DistanceMatrix.from_dict(meta["topology"])
    return Executor(
        int(meta["num_domains"]),
        [int(d) for d in meta["worker_domains"]],
        handler=handler,
        pool_cap=meta.get("pool_cap"),
        steal_order=steal_order or str(meta.get("steal_order", "cyclic")),
        governor=governor,
        steal_penalty=steal_penalty,
        seed=int(meta.get("seed", 0)),
        topology=topology,
    )


@dataclasses.dataclass(frozen=True)
class TaskTiming:
    """Per-task timing of one replayed (or recorded) execution.

    ``wait`` is queueing delay in scheduling rounds (execute step − submit
    step); ``service`` is the executed cost plus any nonlocal penalty paid
    (cost units ≈ rounds at the repo's unit task cost); ``sojourn`` is
    their sum — the discrete analogue of a request's end-to-end latency.
    """

    uid: int
    submit_step: int
    exec_step: int
    service: float

    @property
    def wait(self) -> int:
        return self.exec_step - self.submit_step

    @property
    def sojourn(self) -> float:
        return self.wait + self.service


def task_times(submissions, events: Iterable[Event]) -> dict[int, TaskTiming]:
    """Fold submissions + execution events into per-task timings.

    Works on a recorded ``Trace`` (``task_times(t.submissions, t.events)``)
    or on a replay executor's live log.  Only tasks whose execution event is
    still in the (ring-buffered) event window appear; for small runs that is
    all of them.
    """
    submit_step = {s.uid: s.step for s in submissions}
    out: dict[int, TaskTiming] = {}
    for e in events:
        if e.kind in ("run", "steal", "inline") and e.task_uid in submit_step:
            out[e.task_uid] = TaskTiming(
                uid=e.task_uid, submit_step=submit_step[e.task_uid],
                exec_step=e.step, service=e.service)
    return out


@dataclasses.dataclass
class ReplayResult:
    executor: Executor
    trace: Trace

    @property
    def stats(self) -> dict[str, float]:
        return self.executor.metrics.snapshot()

    @property
    def matches_recorded(self) -> bool:
        """True when the replayed RuntimeStats reproduce the recorded ones
        exactly (the determinism acceptance check)."""
        return not self.mismatches()

    def mismatches(self) -> dict[str, tuple[Any, Any]]:
        rec, got = self.trace.stats, self.stats
        keys = FIDELITY_KEYS + tuple(k for k in OPTIONAL_FIDELITY_KEYS
                                     if k in rec)
        return {k: (rec.get(k), got.get(k)) for k in keys
                if got.get(k) != rec.get(k)}

    def task_times(self) -> dict[int, TaskTiming]:
        """Per-task wait/sojourn of this replay (uid -> ``TaskTiming``),
        from the replay executor's event log — the counterfactual-metrics
        raw material (``compare_replays``)."""
        if self.executor.events is None:
            raise RuntimeError("replay executor recorded no events "
                               "(record_events=False)")
        return task_times(self.trace.submissions, self.executor.events)

    def sojourn_percentiles(self, qs=(50, 95, 99)) -> dict[str, float]:
        """Exact nearest-rank percentiles of this replay's per-task sojourn
        (``{"p50": ..., "p95": ..., "p99": ...}``) — the latency summary
        ``BENCH_experiments.json`` exports per run.  Computed over the full
        retained sample by ``repro.obs.percentiles`` (no bucket estimates).
        """
        from ..obs.metrics import percentiles   # lazy: obs imports trace
        times = self.task_times()
        if not times:
            raise RuntimeError("no retained task timings to summarize")
        return percentiles([t.sojourn for t in times.values()], qs)


@dataclasses.dataclass
class ReplayComparison:
    """Per-task deltas between two replays of the same trace (B − A)."""

    wait_delta: dict[int, int]        # uid -> wait_b - wait_a (rounds)
    sojourn_delta: dict[int, float]   # uid -> sojourn_b - sojourn_a
    mean_wait: tuple[float, float]    # (A, B)
    mean_sojourn: tuple[float, float]

    @property
    def n_tasks(self) -> int:
        return len(self.wait_delta)

    @property
    def improved(self) -> int:
        """Tasks whose sojourn strictly improved under B."""
        return sum(1 for d in self.sojourn_delta.values() if d < 0)

    @property
    def regressed(self) -> int:
        return sum(1 for d in self.sojourn_delta.values() if d > 0)


def compare_replays(a: ReplayResult, b: ReplayResult) -> ReplayComparison:
    """Per-task counterfactual: what did policy B do to each task that
    policy A also served?  Both replays must come from the *same* trace
    (same submission uids/steps); tasks present in both event windows are
    compared, per uid, not just in aggregate.
    """
    ta, tb = a.task_times(), b.task_times()
    shared = sorted(set(ta) & set(tb))
    if not shared:
        raise ValueError("replays share no retained tasks to compare")
    wait = {u: tb[u].wait - ta[u].wait for u in shared}
    sojourn = {u: tb[u].sojourn - ta[u].sojourn for u in shared}
    return ReplayComparison(
        wait_delta=wait, sojourn_delta=sojourn,
        mean_wait=(sum(ta[u].wait for u in shared) / len(shared),
                   sum(tb[u].wait for u in shared) / len(shared)),
        mean_sojourn=(sum(ta[u].sojourn for u in shared) / len(shared),
                      sum(tb[u].sojourn for u in shared) / len(shared)))


def replay(trace: Trace,
           executor_factory: Optional[Callable[[Trace], Executor]] = None,
           *, assert_match: bool = False,
           reroute: bool = False) -> ReplayResult:
    """Re-drive an executor through the trace's recorded arrival sequence.

    ``executor_factory(trace) -> Executor`` supplies the executor.  The
    default reconstructs the recorded configuration: when the header embeds
    a spec (schema v2, spec-built executors) the *exact* system is rebuilt
    from it (``executor_from_spec`` — governor, breaker, router, batch
    policy, penalty rule), so ``replay(trace)`` with no arguments
    reproduces the recorded ``RuntimeStats`` bit-for-bit; v1/spec-less
    traces fall back to ``executor_from_meta`` (flat fields only — pass a
    factory for penalty functions etc., as before v2).  The factory must
    return a *fresh* executor whose step clock is at 0.  With
    ``assert_match=True`` the replayed stats are checked bit-for-bit
    against the recorded footer stats (use only with a policy-equivalent
    factory, including the recorded run's penalty function).

    ``reroute=True`` replays the *arrivals* (uid/home/cost/step) but lets
    the replay executor re-decide each submit domain (router/home/
    round-robin) instead of forcing the recorded queue — the counterfactual
    for submit-side policies (``repro.control.CostRouter`` A/Bs), just as a
    plain replay is the counterfactual for dequeue-side steal policies.
    Incompatible with ``assert_match`` (routing is the treatment).
    """
    if reroute and assert_match:
        raise ValueError("reroute re-decides routing; recorded stats are "
                         "not expected to match")
    if executor_factory is None:
        executor_factory = (executor_from_spec if trace.spec_dict is not None
                            else executor_from_meta)
    ex = executor_factory(trace)
    if ex.step_count != 0:
        raise ValueError("replay needs a fresh executor (step clock at 0)")
    for rec in trace.submissions:
        while ex.step_count < rec.step:
            ex.step()
        ex.submit(Task(uid=rec.uid, payload=None, home=rec.home,
                       cost=rec.cost),
                  domain=None if reroute else rec.domain)
    # replicate any trailing rounds (including idle polls on empty queues —
    # they are part of the recorded stats), then drain whatever is left.
    while ex.step_count < trace.total_steps:
        ex.step()
    ex.run_until_drained()
    result = ReplayResult(executor=ex, trace=trace)
    if assert_match and not result.matches_recorded:
        raise AssertionError(
            f"replay diverged from recorded stats: {result.mismatches()}")
    return result
