"""The declarative policy spec: one frozen dataclass tree per system.

A ``RuntimeSpec`` is the *complete*, serializable name of a scheduling
configuration — domains, worker pinning, steal order, pool cap, seed,
governor (with optional breaker decoration), router, batch policy, steal
penalty, trace recording, and (optionally) a serving topology.  Three PRs
of constructor kwargs (``Executor``, ``ControlLoop``, ``TraceRecorder``,
``ServingEngine``) collapse into one value that can be

  * built      — ``spec.build()`` returns a fully wired executor plus any
                 control loop / trace recorder it declares (``build.py``);
  * serialized — ``to_json``/``from_json`` with strict unknown-field and
                 unknown-version errors, so a policy is a reviewable JSON
                 file, not constructor folklore;
  * recorded   — the trace header embeds the spec (schema v2), so
                 ``repro.trace.replay(trace)`` with *no executor argument*
                 reconstructs the exact recorded system;
  * named      — ``repro.spec.named("paper_cyclic")`` etc. (``registry.py``).

Every spec class is frozen and compares by value, so
``from_json(to_json(s)) == s`` holds exactly — the round-trip property the
golden files in ``specs/`` pin down.

Design rule: specs hold only JSON-representable values.  Callables
(handlers, custom governors, live model replicas) are *build-time*
arguments to ``spec.build(...)``; anything that must survive a trace
round-trip belongs in the spec itself (which is why the steal penalty is a
``PenaltySpec``, not a lambda).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

SPEC_VERSION = 1


class SpecError(ValueError):
    """Raised for malformed, unknown-field, or unknown-version specs."""


def _reject_unknown(cls, data: dict, where: str) -> None:
    if not isinstance(data, dict):
        raise SpecError(f"{where}: expected an object, got {type(data).__name__}")
    allowed = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(data) - allowed)
    if unknown:
        raise SpecError(f"{where}: unknown field(s) {unknown} "
                        f"(known: {sorted(allowed)})")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SpecError(msg)


# Scalar field types each spec class declares (annotations are strings under
# ``from __future__ import annotations``); Optional scalars accept null.
_SCALARS = {"int": int, "float": float, "bool": bool, "str": str,
            "Optional[int]": int, "Optional[float]": float}


def _coerce_scalars(cls, data: dict, where: str) -> dict:
    """Type-check (and int→float widen) the scalar fields of ``data``.

    The strictness contract: a wrong-typed JSON value (``"ema": "0.5"``)
    must fail parsing with a ``SpecError`` naming the field, never leak a
    raw ``TypeError`` from a validator or — worse — survive into a built
    system and blow up mid-run.
    """
    kw = dict(data)
    for f in dataclasses.fields(cls):
        want = _SCALARS.get(str(f.type))
        v = kw.get(f.name)
        if want is None or v is None or f.name not in kw:
            continue
        bad = SpecError(f"{where}.{f.name}: expected {want.__name__}, "
                        f"got {type(v).__name__} ({v!r})")
        if want is bool or want is str:
            if not isinstance(v, want):
                raise bad
        elif isinstance(v, bool) or not isinstance(
                v, (int, float) if want is float else int):
            raise bad
        else:
            kw[f.name] = want(v)
    return kw


def _construct(cls, kw: dict, where: str):
    try:
        return cls(**kw)
    except TypeError as e:                       # wrong shapes the coercion
        raise SpecError(f"{where}: {e}") from e  # table doesn't cover


@dataclasses.dataclass(frozen=True)
class PenaltySpec:
    """Serializable steal-penalty rule (``Executor(steal_penalty=...)``).

    kind:
      ``none``          — steals are free (penalty callback is ``None``).
      ``constant``      — every steal costs ``value`` (the benchmarks'
                          fixed re-prefill).
      ``cost_factor``   — penalty = ``value * task.cost``.
      ``cost_if_homed`` — penalty = ``value * task.cost`` for tasks with a
                          home, 0 for homeless ones (the serving engine's
                          re-prefill rule: only a cached prefix costs
                          anything to migrate).
    """

    KINDS = ("none", "constant", "cost_factor", "cost_if_homed")

    kind: str = "none"
    value: float = 0.0

    def __post_init__(self):
        _require(self.kind in self.KINDS,
                 f"penalty.kind {self.kind!r} not in {self.KINDS}")
        _require(self.value >= 0.0, "penalty.value must be >= 0")

    def to_dict(self) -> dict[str, Any]:
        return {"kind": self.kind, "value": self.value}

    @classmethod
    def from_dict(cls, d: dict, where: str = "penalty") -> "PenaltySpec":
        _reject_unknown(cls, d, where)
        return _construct(cls, _coerce_scalars(cls, d, where), where)


def _int_float_pairs(value, where: str):
    """Parse/normalize a ``[[int, float], ...]`` pair list (JSON form of the
    small int-keyed estimate maps the state specs carry); returns a tuple of
    ``(int, float)`` pairs, or None for None/empty."""
    if value is None:
        return None
    if not isinstance(value, (list, tuple)):
        raise SpecError(f"{where}: expected a list of [int, number] pairs, "
                        f"got {type(value).__name__}")
    out = []
    for item in value:
        ok = (isinstance(item, (list, tuple)) and len(item) == 2
              and not isinstance(item[0], bool) and isinstance(item[0], int)
              and not isinstance(item[1], bool)
              and isinstance(item[1], (int, float)))
        if not ok:
            raise SpecError(f"{where}: expected [int, number] pairs, "
                            f"got {item!r}")
        out.append((int(item[0]), float(item[1])))
    return tuple(out) if out else None


@dataclasses.dataclass(frozen=True)
class BreakerStateSpec:
    """Warm ``control.StormBreaker`` state: remaining cooldown windows and
    episode counters, so ``spec.checkpoint()`` restores a breaker
    mid-cooldown instead of silently re-arming it."""

    cooldown_left: int = 0
    remote_cooldown_left: int = 0
    trips: int = 0
    remote_trips: int = 0

    def __post_init__(self):
        for f in dataclasses.fields(self):
            _require(getattr(self, f.name) >= 0,
                     f"breaker.state.{f.name} must be >= 0")

    @classmethod
    def from_breaker(cls, breaker) -> "BreakerStateSpec":
        """Snapshot a live ``control.StormBreaker``'s warm state."""
        state = getattr(breaker, "breaker_state", None)
        if state is None:
            raise SpecError(
                f"{type(breaker).__name__} is no StormBreaker "
                "(no breaker_state to snapshot)")
        return cls(**state())

    def to_dict(self) -> dict[str, Any]:
        return {"cooldown_left": self.cooldown_left,
                "remote_cooldown_left": self.remote_cooldown_left,
                "trips": self.trips, "remote_trips": self.remote_trips}

    @classmethod
    def from_dict(cls, d: dict,
                  where: str = "breaker.state") -> "BreakerStateSpec":
        _reject_unknown(cls, d, where)
        return _construct(cls, _coerce_scalars(cls, d, where), where)


@dataclasses.dataclass(frozen=True)
class BreakerSpec:
    """``repro.control.StormBreaker`` parameters (governor decoration).

    ``remote_frac`` is the cross-tier steal fraction that trips the
    breaker's remote-only state under a hierarchical topology (flat
    machines never produce remote steals, so it is inert there).
    ``state`` restores a checkpointed breaker's cooldowns warm.
    """

    width: int = 8
    steal_frac: float = 0.5
    inline_frac: float = 0.25
    remote_frac: float = 0.25
    min_executed: int = 4
    cooldown: int = 3
    mode: str = "raise"
    boost: int = 8
    state: Optional[BreakerStateSpec] = None

    def __post_init__(self):
        _require(self.width >= 1, "breaker.width must be >= 1")
        _require(self.mode in ("raise", "block"),
                 f"breaker.mode {self.mode!r} not in ('raise', 'block')")
        _require(self.remote_frac > 0, "breaker.remote_frac must be > 0")

    def to_dict(self) -> dict[str, Any]:
        return {"width": self.width, "steal_frac": self.steal_frac,
                "inline_frac": self.inline_frac,
                "remote_frac": self.remote_frac,
                "min_executed": self.min_executed, "cooldown": self.cooldown,
                "mode": self.mode, "boost": self.boost,
                "state": None if self.state is None else self.state.to_dict()}

    @classmethod
    def from_dict(cls, d: dict, where: str = "breaker") -> "BreakerSpec":
        _reject_unknown(cls, d, where)
        kw = _coerce_scalars(cls, d, where)
        st = kw.pop("state", None)
        kw["state"] = (None if st is None
                       else BreakerStateSpec.from_dict(st, f"{where}.state"))
        return _construct(cls, kw, where)


@dataclasses.dataclass(frozen=True)
class GovernorStateSpec:
    """A snapshot of an adaptive governor's *learned* θ inputs.

    ``runtime.AdaptiveSteal`` / ``trace.MeasuredPenalty`` learn the steal
    penalty (θ's numerator) and — for the measured governor — the local
    service time (θ's denominator) while the system runs.  This block
    serializes that learned state, so a mid-run checkpoint rebuilds the
    exact estimator declaratively: ``GovernorSpec(state=...)`` constructs
    the governor at the snapshotted estimates instead of the static priors,
    and no trace has to be re-read (``MeasuredPenalty.from_trace``'s job,
    done once and then persisted as spec data).

    Capture with ``GovernorStateSpec.from_governor(gov)`` (a breaker
    decoration is unwrapped) or ``repro.spec.checkpoint(executor)``.
    Per-worker idle-decay counters are transient scheduling state, not
    estimator state, and are deliberately not snapshotted.
    """

    penalty_estimate: float = 0.0
    task_cost: float = 1.0
    observed_local: int = 0
    observed_steals: int = 0
    level_penalties: Optional[tuple[tuple[int, float], ...]] = None

    def __post_init__(self):
        _require(self.penalty_estimate >= 0.0,
                 "governor.state.penalty_estimate must be >= 0")
        _require(self.task_cost > 0,
                 "governor.state.task_cost must be positive")
        _require(self.observed_local >= 0 and self.observed_steals >= 0,
                 "governor.state observation counts must be >= 0")
        if self.level_penalties is not None:
            lp = _int_float_pairs(self.level_penalties,
                                  "governor.state.level_penalties")
            if lp is not None:
                for lv, est in lp:
                    _require(lv >= 1 and est >= 0.0,
                             "governor.state.level_penalties entries need "
                             "level >= 1 and estimate >= 0")
            object.__setattr__(self, "level_penalties", lp)

    @classmethod
    def from_governor(cls, governor) -> "GovernorStateSpec":
        """Snapshot a live governor's learned estimates (unwrapping a
        ``control.StormBreaker`` decoration to its inner governor),
        including any per-topology-tier penalty EMAs a hierarchical run
        taught it."""
        inner = getattr(governor, "inner", None)
        if inner is not None:
            governor = inner
        if not hasattr(governor, "penalty_estimate"):
            raise SpecError(
                f"governor {type(governor).__name__} carries no learned "
                "state to snapshot (only adaptive/measured governors do)")
        levels = getattr(governor, "level_penalty_estimates", None)
        by_level = sorted(levels().items()) if levels is not None else []
        return cls(penalty_estimate=float(governor.penalty_estimate),
                   task_cost=float(governor.task_cost),
                   observed_local=int(getattr(governor, "observed_local", 0)),
                   observed_steals=int(getattr(governor,
                                               "observed_steals", 0)),
                   level_penalties=tuple(by_level) or None)

    def to_dict(self) -> dict[str, Any]:
        return {"penalty_estimate": self.penalty_estimate,
                "task_cost": self.task_cost,
                "observed_local": self.observed_local,
                "observed_steals": self.observed_steals,
                "level_penalties": (None if self.level_penalties is None
                                    else [list(p)
                                          for p in self.level_penalties])}

    @classmethod
    def from_dict(cls, d: dict,
                  where: str = "governor.state") -> "GovernorStateSpec":
        _reject_unknown(cls, d, where)
        return _construct(cls, _coerce_scalars(cls, d, where), where)


@dataclasses.dataclass(frozen=True)
class GovernorSpec:
    """Steal-governor choice + hyper-parameters, plus breaker decoration.

    kind:
      ``greedy``   — ``runtime.GreedySteal`` (the paper's §2.2 rule).
      ``none``     — ``runtime.NoSteal`` (pure locality).
      ``adaptive`` — ``runtime.AdaptiveSteal(penalty_hint, task_cost, ema,
                      max_threshold)``.
      ``measured`` — ``trace.MeasuredPenalty`` (both θ inputs learned
                      online; same hyper-parameters as ``adaptive``).

    ``breaker`` wraps the built governor in a ``control.StormBreaker``
    (installed via ``ControlLoop``, so the storm detector runs on the
    executor's step hook).

    ``state`` (adaptive/measured only) seeds the governor's learned θ
    inputs from a ``GovernorStateSpec`` snapshot; it supersedes the
    ``penalty_hint``/``task_cost`` priors, which remain purely declarative
    configuration.
    """

    KINDS = ("greedy", "none", "adaptive", "measured")

    kind: str = "greedy"
    penalty_hint: float = 4.0
    task_cost: float = 1.0
    ema: float = 0.2
    max_threshold: int = 64
    breaker: Optional[BreakerSpec] = None
    state: Optional[GovernorStateSpec] = None

    def __post_init__(self):
        _require(self.kind in self.KINDS,
                 f"governor.kind {self.kind!r} not in {self.KINDS}")
        _require(0.0 < self.ema <= 1.0, "governor.ema must be in (0, 1]")
        _require(self.task_cost > 0, "governor.task_cost must be positive")
        _require(self.state is None or self.kind in ("adaptive", "measured"),
                 f"governor.state requires an adaptive/measured kind, "
                 f"not {self.kind!r} (nothing to restore)")

    def to_dict(self) -> dict[str, Any]:
        return {"kind": self.kind, "penalty_hint": self.penalty_hint,
                "task_cost": self.task_cost, "ema": self.ema,
                "max_threshold": self.max_threshold,
                "breaker": None if self.breaker is None
                else self.breaker.to_dict(),
                "state": None if self.state is None
                else self.state.to_dict()}

    @classmethod
    def from_dict(cls, d: dict, where: str = "governor") -> "GovernorSpec":
        _reject_unknown(cls, d, where)
        kw = _coerce_scalars(cls, d, where)
        br = kw.pop("breaker", None)
        kw["breaker"] = (None if br is None
                         else BreakerSpec.from_dict(br, f"{where}.breaker"))
        st = kw.pop("state", None)
        kw["state"] = (None if st is None
                       else GovernorStateSpec.from_dict(st, f"{where}.state"))
        return _construct(cls, kw, where)


@dataclasses.dataclass(frozen=True)
class RouterSpec:
    """Submit-side routing policy (``Executor(router=...)``).

    kind:
      ``none``        — the executor's default: home queue, else
                        round-robin for homeless tasks.
      ``round_robin`` — ignore homes, round-robin every submission (the
                        "plain tasking" arm of the benchmarks).
      ``cost``        — ``control.CostRouter``: least-estimated-backlog
                        routing, home-sticky up to a spill threshold.

    ``spill`` (kind ``cost`` only):
      ``static``   — the threshold is the fixed ``spill_penalty`` hint.
      ``measured`` — the threshold is read live from the governor's
                      ``penalty_estimate`` (``AdaptiveSteal`` /
                      ``MeasuredPenalty``), falling back to
                      ``spill_penalty`` until one exists — the ROADMAP's
                      "price the spill threshold from measurements".

    ``breaker_aware`` (kind ``cost`` only) makes the router consult the
    executor's ``StormBreaker``: while the breaker is tripped, homed tasks
    are never spilled (remote-only trips only suspend cross-tier spills) —
    routing must not re-feed the storm the breaker is quenching.
    """

    KINDS = ("none", "round_robin", "cost")

    kind: str = "none"
    spill_penalty: Optional[float] = 4.0
    spill: str = "static"
    breaker_aware: bool = False

    def __post_init__(self):
        _require(self.kind in self.KINDS,
                 f"router.kind {self.kind!r} not in {self.KINDS}")
        _require(self.spill in ("static", "measured"),
                 f"router.spill {self.spill!r} not in ('static', 'measured')")
        _require(not (self.breaker_aware and self.kind != "cost"),
                 "router.breaker_aware requires kind 'cost'")

    def to_dict(self) -> dict[str, Any]:
        return {"kind": self.kind, "spill_penalty": self.spill_penalty,
                "spill": self.spill, "breaker_aware": self.breaker_aware}

    @classmethod
    def from_dict(cls, d: dict, where: str = "router") -> "RouterSpec":
        _reject_unknown(cls, d, where)
        return _construct(cls, _coerce_scalars(cls, d, where), where)


@dataclasses.dataclass(frozen=True)
class BatchStateSpec:
    """Warm ``control.BatchGovernor`` state: the learned service EMAs (the
    global one and, under ``per_domain``, each queue's own) plus the
    current size, so a checkpointed governor resumes sizing from its
    measurements instead of re-warming from ``init_size``."""

    service_estimate: Optional[float] = None
    size: Optional[int] = None
    domain_estimates: Optional[tuple[tuple[int, float], ...]] = None

    def __post_init__(self):
        _require(self.service_estimate is None or self.service_estimate > 0,
                 "batch.state.service_estimate must be > 0 (or null)")
        _require(self.size is None or self.size >= 1,
                 "batch.state.size must be >= 1 (or null)")
        if self.domain_estimates is not None:
            de = _int_float_pairs(self.domain_estimates,
                                  "batch.state.domain_estimates")
            if de is not None:
                for dom, est in de:
                    _require(dom >= 0 and est > 0,
                             "batch.state.domain_estimates entries need "
                             "domain >= 0 and estimate > 0")
            object.__setattr__(self, "domain_estimates", de)

    @classmethod
    def from_governor(cls, batcher) -> "BatchStateSpec":
        """Snapshot a live ``control.BatchGovernor``'s learned state."""
        if not hasattr(batcher, "service_estimate"):
            raise SpecError(
                f"{type(batcher).__name__} is no BatchGovernor "
                "(no service_estimate to snapshot)")
        domains = sorted(batcher.domain_service_estimates().items())
        return cls(service_estimate=batcher.service_estimate,
                   size=int(batcher.size),
                   domain_estimates=tuple(domains) or None)

    def to_dict(self) -> dict[str, Any]:
        return {"service_estimate": self.service_estimate,
                "size": self.size,
                "domain_estimates": (None if self.domain_estimates is None
                                     else [list(p)
                                           for p in self.domain_estimates])}

    @classmethod
    def from_dict(cls, d: dict,
                  where: str = "batch.state") -> "BatchStateSpec":
        _reject_unknown(cls, d, where)
        return _construct(cls, _coerce_scalars(cls, d, where), where)


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    """Batch-grab policy (``Executor(batch=...)``).

    ``fixed``    — a static grab limit of ``size`` tasks (1 = the paper's
                   one-task grabs).
    ``governed`` — ``control.BatchGovernor(target_service, batch_min,
                   batch_cap, ema, init_size)``: budgeted continuous
                   batching adapted from measured per-batch service.

    ``per_domain`` (governed only) keeps one service EMA per source queue
    under the same global ``target_service`` budget, so each queue's grab
    width tracks its own cost mix.  ``state`` restores a checkpointed
    governor's EMAs warm.
    """

    KINDS = ("fixed", "governed")

    kind: str = "fixed"
    size: int = 1
    target_service: float = 8.0
    batch_min: int = 1
    batch_cap: int = 8
    ema: float = 0.25
    init_size: int = 1
    per_domain: bool = False
    state: Optional[BatchStateSpec] = None

    def __post_init__(self):
        _require(self.kind in self.KINDS,
                 f"batch.kind {self.kind!r} not in {self.KINDS}")
        _require(self.size >= 1, "batch.size must be >= 1")
        _require(self.target_service > 0, "batch.target_service must be > 0")
        _require(1 <= self.batch_min <= self.batch_cap,
                 "need 1 <= batch.batch_min <= batch.batch_cap")
        _require(not (self.per_domain and self.kind != "governed"),
                 "batch.per_domain requires kind 'governed'")
        _require(self.state is None or self.kind == "governed",
                 "batch.state requires kind 'governed' (nothing to restore)")

    def to_dict(self) -> dict[str, Any]:
        return {"kind": self.kind, "size": self.size,
                "target_service": self.target_service,
                "batch_min": self.batch_min, "batch_cap": self.batch_cap,
                "ema": self.ema, "init_size": self.init_size,
                "per_domain": self.per_domain,
                "state": None if self.state is None else self.state.to_dict()}

    @classmethod
    def from_dict(cls, d: dict, where: str = "batch") -> "BatchSpec":
        _reject_unknown(cls, d, where)
        kw = _coerce_scalars(cls, d, where)
        st = kw.pop("state", None)
        kw["state"] = (None if st is None
                       else BatchStateSpec.from_dict(st, f"{where}.state"))
        return _construct(cls, kw, where)


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Trace recording declared in the spec (``trace.TraceRecorder``).

    ``record=True`` attaches a recorder at build time (``Built.recorder``);
    ``segment_records=N`` additionally streams rotating JSONL segments to
    the ``trace_path`` passed to ``build`` (long-running-server export).
    """

    record: bool = False
    segment_records: Optional[int] = None

    def __post_init__(self):
        _require(self.segment_records is None or self.segment_records >= 1,
                 "trace.segment_records must be >= 1 (or null)")

    def to_dict(self) -> dict[str, Any]:
        return {"record": self.record,
                "segment_records": self.segment_records}

    @classmethod
    def from_dict(cls, d: dict, where: str = "trace") -> "TraceSpec":
        _reject_unknown(cls, d, where)
        return _construct(cls, _coerce_scalars(cls, d, where), where)


@dataclasses.dataclass(frozen=True)
class ServingSpec:
    """Serving topology for ``serving.ServingEngine(spec=...)``.

    The runtime half (queues, governor, penalty, batching, control) lives
    in the owning ``RuntimeSpec``; this block only adds what serving
    itself needs: replica count, cache arena length, and the routing
    policy name.  Consistency rule (checked by the engine): ``single_queue``
    needs ``num_domains == 1`` with every worker pinned to domain 0, any
    other policy needs ``num_domains == num_replicas``.
    """

    POLICIES = ("locality", "round_robin", "single_queue")

    num_replicas: int = 2
    max_seq: int = 128
    policy: str = "locality"

    def __post_init__(self):
        _require(self.num_replicas >= 1, "serving.num_replicas must be >= 1")
        _require(self.max_seq >= 1, "serving.max_seq must be >= 1")
        _require(self.policy in self.POLICIES,
                 f"serving.policy {self.policy!r} not in {self.POLICIES}")

    def to_dict(self) -> dict[str, Any]:
        return {"num_replicas": self.num_replicas, "max_seq": self.max_seq,
                "policy": self.policy}

    @classmethod
    def from_dict(cls, d: dict, where: str = "serving") -> "ServingSpec":
        _reject_unknown(cls, d, where)
        return _construct(cls, _coerce_scalars(cls, d, where), where)


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """Locality-domain distance tree (``repro.topology.DistanceMatrix``).

    ``flat``    — every pair of domains one ``near`` hop apart: the seed
                  repo's implicit machine, kept bit-identical (no topology
                  block and a flat block build the same executor).
    ``grouped`` — a two-level socket/domain tree: ``groups`` lists the
                  domain count per socket; intra-socket links cost ``near``,
                  cross-socket links ``far``.
    ``pods``    — ``num_pods`` pods of ``domains_per_pod`` domains with the
                  cross-pod distance derived from
                  ``core.topology.tpu_topology``'s ``remote_factor``
                  (``far = near / remote_factor``); ``far`` is ignored.
    """

    KINDS = ("flat", "grouped", "pods")

    kind: str = "flat"
    groups: Optional[tuple[int, ...]] = None
    num_pods: int = 2
    domains_per_pod: int = 2
    near: float = 1.0
    far: float = 4.0

    def __post_init__(self):
        _require(self.kind in self.KINDS,
                 f"topology.kind {self.kind!r} not in {self.KINDS}")
        _require(self.near > 0, "topology.near must be > 0")
        _require(self.far >= self.near,
                 "topology.far must be >= topology.near")
        _require(self.num_pods >= 1, "topology.num_pods must be >= 1")
        _require(self.domains_per_pod >= 1,
                 "topology.domains_per_pod must be >= 1")
        if self.kind == "grouped":
            gs = self.groups
            if (not isinstance(gs, (list, tuple)) or not gs
                    or any(isinstance(g, bool) or not isinstance(g, int)
                           or g < 1 for g in gs)):
                raise SpecError("topology.groups must be a non-empty list of "
                                f"positive ints for kind 'grouped', got {gs!r}")
            object.__setattr__(self, "groups", tuple(int(g) for g in gs))
        else:
            _require(self.groups is None,
                     f"topology.groups only applies to kind 'grouped'")

    def declared_domains(self) -> Optional[int]:
        """Domain count this topology pins (None for flat, which adapts to
        the owning spec's ``num_domains``)."""
        if self.kind == "grouped":
            return sum(self.groups)
        if self.kind == "pods":
            return self.num_pods * self.domains_per_pod
        return None

    def to_dict(self) -> dict[str, Any]:
        return {"kind": self.kind,
                "groups": None if self.groups is None else list(self.groups),
                "num_pods": self.num_pods,
                "domains_per_pod": self.domains_per_pod,
                "near": self.near, "far": self.far}

    @classmethod
    def from_dict(cls, d: dict, where: str = "topology") -> "TopologySpec":
        _reject_unknown(cls, d, where)
        kw = _coerce_scalars(cls, d, where)
        if kw.get("groups") is not None:
            gs = kw["groups"]
            if not isinstance(gs, (list, tuple)):
                raise SpecError(f"{where}.groups: expected a list of ints, "
                                f"got {gs!r}")
            kw["groups"] = tuple(gs)
        return _construct(cls, kw, where)


@dataclasses.dataclass(frozen=True)
class ObsSpec:
    """Observability declared in the spec (``repro.obs``).

    ``enabled=True`` attaches a live ``repro.obs.Observation`` at build
    time (``Built.obs``): a deterministic metrics registry (sized by the
    ``hist_*`` bucket ladder) plus ``Observation.report(trace)`` for the
    post-hoc span/histogram/percentile pipeline.  ``profile=True``
    additionally hands the executor a ``HotPathProfiler`` — opt-in
    ``perf_counter_ns`` timers around the four scheduling hot paths
    (submit-route, steal-scan, batch-grab, event-append), the substrate of
    ``benchmarks/scheduler_overhead.py``.

    Observation is passive by contract: an obs-enabled build produces
    bit-identical ``RuntimeStats`` and replays to an obs-disabled one
    (gated in ``tests/test_obs.py``).  Trace headers record this block as
    schema v4 so an observed run names how it was observed.
    """

    enabled: bool = False
    profile: bool = False
    hist_lo: float = 0.5
    hist_growth: float = 2.0
    hist_buckets: int = 24

    def __post_init__(self):
        _require(not (self.profile and not self.enabled),
                 "obs.profile requires obs.enabled (timers need a live "
                 "observation to report into)")
        _require(self.hist_lo > 0, "obs.hist_lo must be > 0")
        _require(self.hist_growth > 1.0, "obs.hist_growth must be > 1")
        _require(self.hist_buckets >= 1, "obs.hist_buckets must be >= 1")

    def to_dict(self) -> dict[str, Any]:
        return {"enabled": self.enabled, "profile": self.profile,
                "hist_lo": self.hist_lo, "hist_growth": self.hist_growth,
                "hist_buckets": self.hist_buckets}

    @classmethod
    def from_dict(cls, d: dict, where: str = "obs") -> "ObsSpec":
        _reject_unknown(cls, d, where)
        return _construct(cls, _coerce_scalars(cls, d, where), where)


@dataclasses.dataclass(frozen=True)
class RuntimeSpec:
    """The top of the tree: one value that names a whole runtime system."""

    num_domains: int = 4
    worker_domains: Optional[tuple[int, ...]] = None
    steal_order: str = "cyclic"
    pool_cap: Optional[int] = 256
    seed: int = 0
    record_events: bool = True
    event_maxlen: int = 65536
    penalty: PenaltySpec = PenaltySpec()
    governor: GovernorSpec = GovernorSpec()
    router: RouterSpec = RouterSpec()
    batch: BatchSpec = BatchSpec()
    trace: TraceSpec = TraceSpec()
    obs: ObsSpec = ObsSpec()
    serving: Optional[ServingSpec] = None
    topology: Optional[TopologySpec] = None

    def __post_init__(self):
        _require(self.num_domains >= 1, "num_domains must be >= 1")
        if self.topology is not None:
            declared = self.topology.declared_domains()
            _require(declared is None or declared == self.num_domains,
                     f"topology declares {declared} domains but spec has "
                     f"num_domains={self.num_domains}")
        _require(self.pool_cap is None or self.pool_cap >= 1,
                 "pool_cap must be >= 1 (or null)")
        if self.worker_domains is not None:
            wd = tuple(int(d) for d in self.worker_domains)
            object.__setattr__(self, "worker_domains", wd)
            for d in wd:
                _require(0 <= d < self.num_domains,
                         f"worker domain {d} outside {self.num_domains} "
                         "domains")
        # steal_order is validated against DomainQueues.STEAL_ORDERS at
        # build time; keep the model layer import-free of the runtime.
        _require(isinstance(self.steal_order, str) and bool(self.steal_order),
                 "steal_order must be a non-empty string")

    # -- construction (implemented in repro.spec.build) ----------------------
    def build(self, **overrides):
        """Build the declared system: returns a ``Built`` bundle with the
        wired ``executor`` plus any ``control`` loop / trace ``recorder``.
        See ``repro.spec.build.build`` for the build-time overrides
        (``handler``, ``batch_handler``, ``steal_penalty``, ``governor``,
        ``trace_path``)."""
        from .build import build
        return build(self, **overrides)

    def build_engine(self, model, params, **kwargs):
        """Build the declared ``serving.ServingEngine`` over ``model`` —
        requires a ``serving`` block."""
        from ..serving.engine import ServingEngine
        return ServingEngine(model, params, spec=self, **kwargs)

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        return {
            "spec_version": SPEC_VERSION,
            "num_domains": self.num_domains,
            "worker_domains": (None if self.worker_domains is None
                               else list(self.worker_domains)),
            "steal_order": self.steal_order,
            "pool_cap": self.pool_cap,
            "seed": self.seed,
            "record_events": self.record_events,
            "event_maxlen": self.event_maxlen,
            "penalty": self.penalty.to_dict(),
            "governor": self.governor.to_dict(),
            "router": self.router.to_dict(),
            "batch": self.batch.to_dict(),
            "trace": self.trace.to_dict(),
            "obs": self.obs.to_dict(),
            "serving": (None if self.serving is None
                        else self.serving.to_dict()),
            "topology": (None if self.topology is None
                         else self.topology.to_dict()),
        }

    @classmethod
    def from_dict(cls, d: dict, where: str = "spec") -> "RuntimeSpec":
        if not isinstance(d, dict):
            raise SpecError(f"{where}: expected an object, "
                            f"got {type(d).__name__}")
        d = dict(d)
        version = d.pop("spec_version", SPEC_VERSION)
        if version != SPEC_VERSION:
            raise SpecError(f"{where}: spec_version {version!r} != "
                            f"supported {SPEC_VERSION}")
        _reject_unknown(cls, d, where)
        kw: dict[str, Any] = _coerce_scalars(cls, d, where)
        if kw.get("worker_domains") is not None:
            wd = kw["worker_domains"]
            if (not isinstance(wd, (list, tuple))
                    or any(isinstance(x, bool) or not isinstance(x, int)
                           for x in wd)):
                raise SpecError(f"{where}.worker_domains: expected a list "
                                f"of ints, got {wd!r}")
            kw["worker_domains"] = tuple(int(x) for x in wd)
        for name, sub in (("penalty", PenaltySpec), ("governor", GovernorSpec),
                          ("router", RouterSpec), ("batch", BatchSpec),
                          ("trace", TraceSpec), ("obs", ObsSpec)):
            if name in kw:
                kw[name] = sub.from_dict(kw[name], f"{where}.{name}")
        if kw.get("serving") is not None:
            kw["serving"] = ServingSpec.from_dict(kw["serving"],
                                                  f"{where}.serving")
        if kw.get("topology") is not None:
            kw["topology"] = TopologySpec.from_dict(kw["topology"],
                                                    f"{where}.topology")
        return _construct(cls, kw, where)

    def to_json(self) -> str:
        """Canonical JSON form (stable key order — golden-file friendly)."""
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "RuntimeSpec":
        try:
            data = json.loads(text)
        except json.JSONDecodeError as e:
            raise SpecError(f"spec is not valid JSON: {e}") from e
        return cls.from_dict(data)


def load(path) -> RuntimeSpec:
    """Read a ``RuntimeSpec`` from a JSON file."""
    with open(path, "r", encoding="utf-8") as fh:
        return RuntimeSpec.from_json(fh.read())


def dump(spec: RuntimeSpec, path) -> str:
    """Write ``spec`` to ``path`` in canonical JSON form; returns the path."""
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(spec.to_json())
    return path
