"""Build a live, fully wired runtime system from a ``RuntimeSpec``.

``build(spec)`` is the single construction path the spec API promises: it
creates the ``Executor``, installs the declared router / batch policy /
breaker through a ``repro.control.ControlLoop`` (the same splice points a
hand-wired control plane uses), stamps the spec onto the executor
(``Executor.spec`` — what the trace header embeds, making every recorded
run self-describing), and attaches a ``TraceRecorder`` last so a streamed
header names the effective, breaker-wrapped governor.

Build-time overrides carry the values a spec deliberately cannot hold —
callables and live objects:

    handler / batch_handler   task execution callbacks
    steal_penalty             a custom penalty fn (replaces ``PenaltySpec``;
                              the built executor then no longer embeds the
                              spec, since the spec would misname the run)
    governor                  a pre-built governor instance (e.g. a
                              ``MeasuredPenalty`` seeded from a trace) —
                              same embedding caveat
    trace_path                directory for streamed trace segments when
                              ``TraceSpec.segment_records`` is set

Everything a ``Built`` executor does is deterministic for the spec's seed,
so two builds of the same spec driven identically produce bit-identical
``RuntimeStats`` — the property that makes ``replay(trace)`` from an
embedded spec an exact reconstruction.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from ..runtime import (AdaptiveSteal, Executor, GreedySteal, NoSteal,
                       StealGovernor, Task, Worker)
from ..topology import DistanceMatrix, flat as flat_topology
from ..topology import grouped as grouped_topology
from ..topology import pods as pods_topology
from .model import (BatchSpec, GovernorSpec, PenaltySpec, RouterSpec,
                    RuntimeSpec, SpecError, TopologySpec)


@dataclasses.dataclass
class Built:
    """The live system a ``RuntimeSpec`` declares.

    ``executor`` is always present; ``control`` (a wired
    ``repro.control.ControlLoop``) exists when the spec declares a cost
    router, a governed batch, or a breaker; ``recorder`` (an attached
    ``repro.trace.TraceRecorder``) when ``TraceSpec.record`` is set;
    ``obs`` (a live ``repro.obs.Observation`` — registry plus, under
    ``ObsSpec.profile``, the executor's hot-path profiler) when
    ``ObsSpec.enabled`` is set.
    """

    spec: RuntimeSpec
    executor: Executor
    control: Optional[Any] = None      # repro.control.ControlLoop
    recorder: Optional[Any] = None     # repro.trace.TraceRecorder
    obs: Optional[Any] = None          # repro.obs.Observation


def build_penalty(spec: PenaltySpec) -> Optional[Callable[[Task, Worker], float]]:
    """The ``Executor(steal_penalty=...)`` callable a ``PenaltySpec`` names."""
    if spec.kind == "none":
        return None
    value = spec.value
    if spec.kind == "constant":
        return lambda task, worker: value
    if spec.kind == "cost_factor":
        return lambda task, worker: value * task.cost
    # cost_if_homed: only a homed task (a cached prefix somewhere) pays to
    # migrate — the serving engine's re-prefill rule.
    return lambda task, worker: value * task.cost if task.home >= 0 else 0.0


def build_governor(spec: GovernorSpec) -> StealGovernor:
    """The *inner* governor (breaker decoration is applied by ``build``).

    A declared ``GovernorStateSpec`` supersedes the ``penalty_hint``/
    ``task_cost`` priors: the governor starts at the snapshotted learned
    estimates (checkpoint/restore), with the spec's ``ema``/
    ``max_threshold`` hyper-parameters unchanged.
    """
    if spec.kind == "greedy":
        return GreedySteal()
    if spec.kind == "none":
        return NoSteal()
    if spec.kind == "measured":
        from ..trace import MeasuredPenalty      # lazy: trace imports runtime
        cls = MeasuredPenalty
    else:
        cls = AdaptiveSteal
    st = spec.state
    gov = cls(penalty_hint=spec.penalty_hint if st is None
              else st.penalty_estimate,
              task_cost=spec.task_cost if st is None else st.task_cost,
              ema=spec.ema, max_threshold=spec.max_threshold)
    if st is not None and spec.kind == "measured":
        gov.observed_local = st.observed_local
        gov.observed_steals = st.observed_steals
    if st is not None and st.level_penalties is not None:
        gov.seed_level_penalties(dict(st.level_penalties))
    return gov


def build_topology(spec: Optional[TopologySpec],
                   num_domains: int) -> Optional[DistanceMatrix]:
    """The ``DistanceMatrix`` a ``TopologySpec`` names (None when the spec
    declares none — the executor then runs the original flat steal scan)."""
    if spec is None:
        return None
    declared = spec.declared_domains()
    if declared is not None and declared != num_domains:
        raise SpecError(f"topology declares {declared} domains but the "
                        f"runtime has {num_domains}")
    if spec.kind == "flat":
        return flat_topology(num_domains, distance=spec.near)
    if spec.kind == "grouped":
        return grouped_topology(list(spec.groups), near=spec.near,
                                far=spec.far)
    return pods_topology(spec.num_pods, spec.domains_per_pod, near=spec.near)


def checkpoint(executor: Executor) -> RuntimeSpec:
    """Snapshot a running spec-built system back into a ``RuntimeSpec``.

    Returns the executor's own spec with every learned/warm block folded
    back in declaratively — the mid-run checkpoint: serialize it, and
    ``build()`` elsewhere resumes the exact estimators without re-reading
    any trace.  Captured when present:

      * governor θ state (``GovernorStateSpec``, incl. per-level penalty
        EMAs) for adaptive/measured kinds;
      * breaker cool-downs and trip counters (``BreakerStateSpec``) when
        the spec declares a breaker;
      * batch-governor service EMAs — global and per-domain — and current
        size (``BatchStateSpec``) when the batch is governed.

    Requires a spec-built executor (``executor.spec`` set) with at least
    one stateful block; a fully static system (greedy/none governor, fixed
    batch, no breaker) has nothing learned to snapshot and raises.
    """
    from .model import BatchStateSpec, BreakerStateSpec, GovernorStateSpec
    spec = getattr(executor, "spec", None)
    if spec is None:
        raise SpecError(
            "checkpoint needs a spec-built executor (executor.spec is None: "
            "raw-kwarg construction or a build-time override)")
    has_breaker = spec.governor.breaker is not None
    has_batch = spec.batch.kind == "governed"
    if not has_breaker and not has_batch:
        # governor state is the only candidate; let its snapshot raise the
        # canonical "no learned state" error for fully static systems
        state = GovernorStateSpec.from_governor(executor.governor)
        return dataclasses.replace(
            spec, governor=dataclasses.replace(spec.governor, state=state))
    try:
        gov_state = GovernorStateSpec.from_governor(executor.governor)
    except SpecError:
        gov_state = None           # greedy/none inner: nothing learned
    new_gov = spec.governor
    if gov_state is not None:
        new_gov = dataclasses.replace(new_gov, state=gov_state)
    if has_breaker:
        b_state = BreakerStateSpec.from_breaker(executor.governor)
        new_gov = dataclasses.replace(
            new_gov, breaker=dataclasses.replace(new_gov.breaker,
                                                 state=b_state))
    new_batch = spec.batch
    if has_batch:
        new_batch = dataclasses.replace(
            new_batch, state=BatchStateSpec.from_governor(executor.batch))
    return dataclasses.replace(spec, governor=new_gov, batch=new_batch)


def _needs_control(spec: RuntimeSpec) -> bool:
    return (spec.router.kind == "cost"
            or spec.batch.kind == "governed"
            or spec.governor.breaker is not None)


def build(spec: RuntimeSpec, *,
          handler=None, batch_handler=None,
          steal_penalty=None, governor: StealGovernor | None = None,
          trace_path=None, experiment=None) -> Built:
    """Construct the system ``spec`` declares (see module docstring).

    ``experiment`` (an ``ExperimentSpec``, when built through
    ``repro.spec.experiments``) is stamped onto the executor alongside the
    spec, so recorded trace headers name the whole experiment, not just the
    policy.
    """
    overridden = steal_penalty is not None or governor is not None
    if steal_penalty is None:
        steal_penalty = build_penalty(spec.penalty)
    if governor is None:
        governor = build_governor(spec.governor)

    obs = None
    if spec.obs.enabled:
        from ..obs import Observation           # lazy: obs imports runtime
        obs = Observation(spec.obs)

    batch: Any = spec.batch.size if spec.batch.kind == "fixed" else 1
    ex = Executor(
        spec.num_domains,
        None if spec.worker_domains is None else list(spec.worker_domains),
        handler=handler,
        pool_cap=spec.pool_cap,
        steal_order=spec.steal_order,
        governor=governor,
        steal_penalty=steal_penalty,
        seed=spec.seed,
        record_events=spec.record_events,
        event_maxlen=spec.event_maxlen,
        batch=batch,
        batch_handler=batch_handler,
        topology=build_topology(spec.topology, spec.num_domains),
        profiler=None if obs is None else obs.profiler,
    )
    # the live observation rides on the executor so trace headers can name
    # it (schema v4's "obs" block); None for unobserved builds.
    ex.obs = obs

    control = None
    if _needs_control(spec):
        from ..control import (BatchGovernor, ControlLoop, CostRouter,
                               StormBreaker)
        router = None
        if spec.router.kind == "cost":
            router = CostRouter(spill_penalty=spec.router.spill_penalty,
                                measured=spec.router.spill == "measured",
                                breaker_aware=spec.router.breaker_aware)
        batcher = None
        if spec.batch.kind == "governed":
            b = spec.batch
            batcher = BatchGovernor(target_service=b.target_service,
                                    batch_min=b.batch_min,
                                    batch_cap=b.batch_cap, ema=b.ema,
                                    init_size=b.init_size,
                                    per_domain=b.per_domain)
            if b.state is not None:
                batcher.seed_state(
                    service_estimate=b.state.service_estimate,
                    size=b.state.size,
                    domain_estimates=(None if b.state.domain_estimates is None
                                      else dict(b.state.domain_estimates)))
        breaker = None
        if spec.governor.breaker is not None:
            k = spec.governor.breaker
            breaker = StormBreaker(width=k.width, steal_frac=k.steal_frac,
                                   inline_frac=k.inline_frac,
                                   remote_frac=k.remote_frac,
                                   min_executed=k.min_executed,
                                   cooldown=k.cooldown, mode=k.mode,
                                   boost=k.boost)
            if k.state is not None:
                breaker.seed_state(**k.state.to_dict())
        control = ControlLoop(router=router, batcher=batcher, breaker=breaker)
        control.attach(ex)
    if spec.router.kind == "round_robin":
        ex.router = lambda task: ex.next_round_robin()

    # Stamp the spec (and any owning experiment) so trace headers fully
    # name this system — unless a build-time override made the spec an
    # incomplete description.
    ex.spec = None if overridden else spec
    ex.experiment = None if overridden else experiment

    recorder = None
    if spec.trace.record:
        from ..trace import TraceRecorder, TraceWriter   # lazy: avoid cycle
        stream = None
        if spec.trace.segment_records is not None:
            if trace_path is None:
                raise SpecError("trace.segment_records is set: build needs "
                                "trace_path= (segment directory) to stream")
            stream = TraceWriter(trace_path,
                                 segment_records=spec.trace.segment_records)
        recorder = TraceRecorder(stream=stream)
        recorder.attach(ex)          # last: header sees the wired governor

    return Built(spec=spec, executor=ex, control=control, recorder=recorder,
                 obs=obs)
