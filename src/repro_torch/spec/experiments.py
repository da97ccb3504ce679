"""Declarative experiments: policy + workload + seeds in one JSON file.

``RuntimeSpec`` (PR 4) made the *policy* declarative, but an experiment —
the unit behind every figure-style run — is policy **and** workload **and**
run parameters, and those were still glued together ad hoc inside each
benchmark script.  ``ExperimentSpec`` closes that gap: a frozen block that
names the arrival process next to the scheduling policy, with the same
strict/exact ``to_json``/``from_json`` contract, so one reviewable JSON
file is a complete, bit-reproducible experiment runnable by
``benchmarks.run --experiment`` alone.

  experiment ingredient                   spec object
  --------------------------------------  --------------------------------
  scheduling policy (who steals, when)    ``RuntimeSpec`` (PR 4)
  arrival process + shape combinators     ``WorkloadSpec`` (+ ``SkewSpec``
  (``trace.workloads`` generators)        / ``CostsSpec``)
  run parameters                          ``repeats`` (seed-shifted
                                          re-runs), ``drain_budget``

``WorkloadSpec.build()`` constructs the ``trace.workloads`` value it names;
``ExperimentSpec.run()`` builds the policy, wires the declared workload
through ``trace.workloads.drive`` while recording, and returns per-repeat
stats + traces.  The recorded trace header embeds the experiment (on top of
schema v2's policy spec), so a trace file names not just the system but the
whole experiment that produced it.

A registry of named experiments (``experiment("replay_hot_skew")`` …)
mirrors ``trace.workloads.standard_scenarios`` and pins the exact workload
constructions the benchmarks historically inlined — the benchmarks are now
thin drivers over these definitions, and ``specs/experiments/*.json``
golden-pins each one.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

from .model import (RuntimeSpec, SpecError, _coerce_scalars, _construct,
                    _reject_unknown, _require)
from .registry import named

EXPERIMENT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class SkewSpec:
    """``trace.workloads.hot_skew`` combinator: re-home a ``p_hot``
    fraction of arrivals onto ``hot_domain`` (the paper's "one socket owns
    the data" pathology)."""

    hot_domain: int = 0
    p_hot: float = 0.8
    seed: int = 0

    def __post_init__(self):
        _require(self.hot_domain >= 0, "skew.hot_domain must be >= 0")
        _require(0.0 <= self.p_hot <= 1.0, "skew.p_hot must be in [0, 1]")

    def to_dict(self) -> dict[str, Any]:
        return {"hot_domain": self.hot_domain, "p_hot": self.p_hot,
                "seed": self.seed}

    @classmethod
    def from_dict(cls, d: dict, where: str = "skew") -> "SkewSpec":
        _reject_unknown(cls, d, where)
        return _construct(cls, _coerce_scalars(cls, d, where), where)


@dataclasses.dataclass(frozen=True)
class CostsSpec:
    """``trace.workloads.lognormal_costs`` combinator: heavy-tailed service
    costs ~ LogNormal(ln ``median``, ``sigma``) (long prefills)."""

    median: float = 1.0
    sigma: float = 0.75
    seed: int = 0

    def __post_init__(self):
        _require(self.median > 0, "costs.median must be positive")
        _require(self.sigma >= 0, "costs.sigma must be >= 0")

    def to_dict(self) -> dict[str, Any]:
        return {"median": self.median, "sigma": self.sigma, "seed": self.seed}

    @classmethod
    def from_dict(cls, d: dict, where: str = "costs") -> "CostsSpec":
        _reject_unknown(cls, d, where)
        return _construct(cls, _coerce_scalars(cls, d, where), where)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """A serializable name for one ``trace.workloads`` arrival stream.

    kind:
      ``poisson``       — steady traffic at ``rate`` arrivals/step.
      ``bursty``        — two-state MMPP (``rate_quiet``/``rate_storm``,
                          ``p_enter``/``p_exit`` sticky transitions).
      ``diurnal``       — sinusoidal day/night profile peaking at ``rate``
                          (``trough_frac``, ``periods``).
      ``uniform_waves`` / ``bursty_waves`` / ``skewed_waves``
                        — the online-runtime benchmark's historical wave
                          scenarios over ``n_tasks`` tasks
                          (``trace.workloads.benchmark_waves``).

    ``skew``/``costs`` apply the ``hot_skew``/``lognormal_costs``
    combinators, in that order (the order every benchmark uses).  Fields
    irrelevant to the chosen kind are ignored by ``build()`` but still
    serialized, so the canonical JSON form is shape-stable across kinds.
    """

    KINDS = ("poisson", "bursty", "diurnal",
             "uniform_waves", "bursty_waves", "skewed_waves")

    kind: str = "poisson"
    num_domains: int = 4
    steps: int = 48
    seed: int = 0
    rate: float = 4.0            # poisson rate / diurnal peak rate
    rate_quiet: float = 1.0      # bursty (MMPP) quiet-state rate
    rate_storm: float = 12.0     # bursty (MMPP) storm-state rate
    p_enter: float = 0.08
    p_exit: float = 0.25
    trough_frac: float = 0.1     # diurnal trough as a fraction of peak
    periods: float = 1.0
    cost: float = 1.0
    n_tasks: int = 400           # *_waves kinds
    skew: Optional[SkewSpec] = None
    costs: Optional[CostsSpec] = None

    def __post_init__(self):
        _require(self.kind in self.KINDS,
                 f"workload.kind {self.kind!r} not in {self.KINDS}")
        _require(self.num_domains >= 1, "workload.num_domains must be >= 1")
        _require(self.steps >= 1, "workload.steps must be >= 1")
        _require(self.n_tasks >= 1, "workload.n_tasks must be >= 1")
        _require(self.rate > 0, "workload.rate must be positive")
        _require(self.rate_quiet > 0 and self.rate_storm > 0,
                 "workload.rate_quiet/rate_storm must be positive")
        _require(0.0 < self.p_enter <= 1.0 and 0.0 < self.p_exit <= 1.0,
                 "workload.p_enter/p_exit must be in (0, 1]")
        _require(0.0 <= self.trough_frac <= 1.0,
                 "workload.trough_frac must be in [0, 1]")
        _require(self.periods > 0, "workload.periods must be positive")
        _require(self.cost > 0, "workload.cost must be positive")
        _require(self.skew is None or self.skew.hot_domain < self.num_domains,
                 f"workload.skew.hot_domain outside {self.num_domains} "
                 "domains")

    def build(self):
        """The ``trace.workloads.Workload`` this spec names."""
        from ..trace import workloads as W  # lazy: trace imports runtime
        k = self.kind
        if k == "poisson":
            wl = W.poisson(rate=self.rate, steps=self.steps,
                           num_domains=self.num_domains, seed=self.seed,
                           cost=self.cost)
        elif k == "bursty":
            wl = W.bursty(rate_quiet=self.rate_quiet,
                          rate_storm=self.rate_storm, steps=self.steps,
                          num_domains=self.num_domains, seed=self.seed,
                          p_enter=self.p_enter, p_exit=self.p_exit,
                          cost=self.cost)
        elif k == "diurnal":
            wl = W.diurnal(peak_rate=self.rate, steps=self.steps,
                           num_domains=self.num_domains, seed=self.seed,
                           trough_frac=self.trough_frac,
                           periods=self.periods, cost=self.cost)
        else:
            wl = W.benchmark_waves(self.n_tasks, self.num_domains,
                                   self.seed)[k[:-len("_waves")]]
        if self.skew is not None:
            wl = W.hot_skew(wl, hot_domain=self.skew.hot_domain,
                            p_hot=self.skew.p_hot, seed=self.skew.seed)
        if self.costs is not None:
            wl = W.lognormal_costs(wl, median=self.costs.median,
                                   sigma=self.costs.sigma,
                                   seed=self.costs.seed)
        return wl

    def to_dict(self) -> dict[str, Any]:
        return {"kind": self.kind, "num_domains": self.num_domains,
                "steps": self.steps, "seed": self.seed, "rate": self.rate,
                "rate_quiet": self.rate_quiet, "rate_storm": self.rate_storm,
                "p_enter": self.p_enter, "p_exit": self.p_exit,
                "trough_frac": self.trough_frac, "periods": self.periods,
                "cost": self.cost, "n_tasks": self.n_tasks,
                "skew": None if self.skew is None else self.skew.to_dict(),
                "costs": None if self.costs is None else self.costs.to_dict()}

    @classmethod
    def from_dict(cls, d: dict, where: str = "workload") -> "WorkloadSpec":
        _reject_unknown(cls, d, where)
        kw = _coerce_scalars(cls, d, where)
        sk = kw.pop("skew", None)
        kw["skew"] = (None if sk is None
                      else SkewSpec.from_dict(sk, f"{where}.skew"))
        co = kw.pop("costs", None)
        kw["costs"] = (None if co is None
                       else CostsSpec.from_dict(co, f"{where}.costs"))
        return _construct(cls, kw, where)


@dataclasses.dataclass
class RunResult:
    """One repeat of an experiment: the live system plus its record."""

    seed: int                    # the policy seed this repeat ran under
    built: Any                   # repro.spec.Built
    trace: Any                   # repro.trace.Trace
    stats: dict[str, float]

    @property
    def executor(self):
        return self.built.executor


AGGREGATE_STATS = ("mean", "min", "max", "stdev")


def aggregate_runs(stats: list[dict]) -> dict[str, dict[str, float]]:
    """Fig. 4-style run-to-run aggregates across seed-shifted repeats.

    For every numeric key shared by all the per-run stats dicts, the exact
    mean / min / max / population stdev over the repeats (stdev 0 for a
    single run — a degenerate ladder is still well-defined).  Booleans are
    excluded (``replay_exact`` is a gate, not a measurement); key order is
    sorted, so the output is deterministic and golden-file friendly.
    """
    if not stats:
        return {}
    keys = set(stats[0])
    for s in stats[1:]:
        keys &= set(s)
    out: dict[str, dict[str, float]] = {}
    for key in sorted(keys):
        vals = [s[key] for s in stats]
        if not all(isinstance(v, (int, float)) and not isinstance(v, bool)
                   for v in vals):
            continue
        n = len(vals)
        mean = sum(vals) / n
        out[key] = {"mean": mean, "min": min(vals), "max": max(vals),
                    "stdev": (sum((v - mean) ** 2 for v in vals) / n) ** 0.5}
    return out


@dataclasses.dataclass
class ExperimentResult:
    """All repeats of one ``ExperimentSpec.run()``."""

    experiment: "ExperimentSpec"
    workload: Any                # the built trace.workloads.Workload
    runs: list[RunResult]

    @property
    def primary(self) -> RunResult:
        """The first (un-shifted-seed) repeat."""
        return self.runs[0]

    def aggregates(self) -> dict[str, dict[str, float]]:
        """``aggregate_runs`` over this result's per-repeat stats — the
        variability ladder the repeated experiments feed into
        ``BENCH_experiments.json`` (and the sentinel's tolerance choices).
        """
        return aggregate_runs([r.stats for r in self.runs])


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """Policy × workload × run parameters: one serializable experiment.

    ``repeats`` re-runs the same workload under seed-shifted copies of the
    policy (repeat *r* uses ``policy.seed + r`` — the run-to-run
    variability axis of the paper's Fig. 4); ``drain_budget`` bounds the
    post-arrival drain (``trace.workloads.drive``), failing loudly when a
    policy cannot drain the declared workload.
    """

    policy: RuntimeSpec
    workload: WorkloadSpec
    repeats: int = 1
    drain_budget: Optional[int] = None

    def __post_init__(self):
        _require(self.repeats >= 1, "experiment.repeats must be >= 1")
        _require(self.drain_budget is None or self.drain_budget >= 1,
                 "experiment.drain_budget must be >= 1 (or null)")
        _require(isinstance(self.policy, RuntimeSpec),
                 "experiment.policy must be a RuntimeSpec")
        _require(isinstance(self.workload, WorkloadSpec),
                 "experiment.workload must be a WorkloadSpec")
        _require(self.policy.num_domains == self.workload.num_domains,
                 f"experiment.workload declares "
                 f"{self.workload.num_domains} domains but the policy "
                 f"declares {self.policy.num_domains}")

    # -- execution -----------------------------------------------------------
    def build(self, repeat: int = 0, **overrides):
        """Build repeat ``repeat``'s system (a ``Built`` bundle; the policy
        seed is shifted by ``repeat``).  The experiment is stamped onto the
        executor so recorded trace headers name it."""
        policy = (self.policy if repeat == 0 else dataclasses.replace(
            self.policy, seed=self.policy.seed + repeat))
        return policy.build(experiment=self, **overrides)

    def run(self, *, trace_path=None, payload=None) -> ExperimentResult:
        """Execute the experiment: build each repeat's declared system,
        drive the declared workload through it (``trace.workloads.drive``)
        while recording, and return per-repeat stats + traces.

        ``trace_path`` is forwarded to ``build`` for policies that stream
        rotating trace segments (repeat *r* streams into
        ``<trace_path>/run-<r>`` when ``repeats > 1``).
        """
        from ..trace import TraceRecorder, drive  # lazy: avoid import cycle
        wl = self.workload.build()
        runs: list[RunResult] = []
        for r in range(self.repeats):
            path = trace_path
            if path is not None and self.repeats > 1:
                path = os.path.join(str(path), f"run-{r}")
            built = self.build(repeat=r, trace_path=path)
            recorder = built.recorder
            if recorder is None:
                recorder = TraceRecorder()
                recorder.attach(built.executor)
            drive(built.executor, wl, payload=payload,
                  drain_budget=self.drain_budget)
            runs.append(RunResult(seed=self.policy.seed + r, built=built,
                                  trace=recorder.finish(),
                                  stats=built.executor.metrics.snapshot()))
        return ExperimentResult(experiment=self, workload=wl, runs=runs)

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        return {"experiment_version": EXPERIMENT_VERSION,
                "policy": self.policy.to_dict(),
                "workload": self.workload.to_dict(),
                "repeats": self.repeats,
                "drain_budget": self.drain_budget}

    @classmethod
    def from_dict(cls, d: dict, where: str = "experiment") -> "ExperimentSpec":
        if not isinstance(d, dict):
            raise SpecError(f"{where}: expected an object, "
                            f"got {type(d).__name__}")
        d = dict(d)
        version = d.pop("experiment_version", EXPERIMENT_VERSION)
        if version != EXPERIMENT_VERSION:
            raise SpecError(f"{where}: experiment_version {version!r} != "
                            f"supported {EXPERIMENT_VERSION}")
        _reject_unknown(cls, d, where)
        kw = _coerce_scalars(cls, d, where)
        if "policy" not in kw or "workload" not in kw:
            raise SpecError(f"{where}: needs both 'policy' and 'workload'")
        kw["policy"] = RuntimeSpec.from_dict(kw["policy"], f"{where}.policy")
        kw["workload"] = WorkloadSpec.from_dict(kw["workload"],
                                                f"{where}.workload")
        return _construct(cls, kw, where)

    def to_json(self) -> str:
        """Canonical JSON form (stable key order — golden-file friendly)."""
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "ExperimentSpec":
        try:
            data = json.loads(text)
        except json.JSONDecodeError as e:
            raise SpecError(f"experiment is not valid JSON: {e}") from e
        return cls.from_dict(data)


def load_experiment(path) -> ExperimentSpec:
    """Read an ``ExperimentSpec`` from a JSON file."""
    with open(path, "r", encoding="utf-8") as fh:
        return ExperimentSpec.from_json(fh.read())


def dump_experiment(exp: ExperimentSpec, path) -> str:
    """Write ``exp`` to ``path`` in canonical JSON form; returns the path."""
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(exp.to_json())
    return path


# -- workload families (the benchmarks' historical constructions) ------------

def standard_workloads(num_domains: int = 4, steps: int = 48,
                       seed: int = 0) -> dict[str, WorkloadSpec]:
    """``trace.workloads.standard_scenarios`` as declarative specs —
    ``standard_workloads(d, s, k)[n].build()`` equals
    ``standard_scenarios(d, s, k)[n]`` arrival-for-arrival."""
    d = num_domains
    return {
        "poisson": WorkloadSpec(kind="poisson", num_domains=d, steps=steps,
                                seed=seed, rate=float(d)),
        "bursty": WorkloadSpec(kind="bursty", num_domains=d, steps=steps,
                               seed=seed + 1, rate_quiet=d * 0.25,
                               rate_storm=d * 3.0),
        "diurnal": WorkloadSpec(kind="diurnal", num_domains=d, steps=steps,
                                seed=seed + 2, rate=d * 2.0),
        "hot_skew": WorkloadSpec(kind="poisson", num_domains=d, steps=steps,
                                 seed=seed + 3, rate=float(d),
                                 skew=SkewSpec(hot_domain=0, p_hot=0.8,
                                               seed=seed + 3)),
    }


def runtime_workloads(n_tasks: int = 400, num_domains: int = 4,
                      seed: int = 0) -> dict[str, WorkloadSpec]:
    """``benchmarks.runtime_throughput``'s wave scenarios as specs."""
    return {scen: WorkloadSpec(kind=f"{scen}_waves", num_domains=num_domains,
                               seed=seed, n_tasks=n_tasks)
            for scen in ("uniform", "bursty", "skewed")}


def replay_workloads(steps: int = 48, seed: int = 0,
                     num_domains: int = 4) -> dict[str, WorkloadSpec]:
    """``benchmarks.trace_replay``'s scenarios: every standard scenario
    with heavy-tailed lognormal costs (median 2), cost seeds by scenario
    position — the exact historical construction."""
    std = standard_workloads(num_domains, steps, seed)
    return {name: dataclasses.replace(
        wl, costs=CostsSpec(median=2.0, sigma=0.75, seed=seed + i))
        for i, (name, wl) in enumerate(std.items())}


def control_workloads(steps: int = 48, seed: int = 0,
                      num_domains: int = 4) -> dict[str, WorkloadSpec]:
    """``benchmarks.control_plane``'s scenarios: the storm-prone subset of
    the standard set, heavy-tailed costs, cost seeds by subset position."""
    std = standard_workloads(num_domains, steps, seed)
    return {name: dataclasses.replace(
        std[name], costs=CostsSpec(median=2.0, sigma=0.75, seed=seed + i))
        for i, name in enumerate(("bursty", "diurnal", "hot_skew"))}


# -- named experiment registry ------------------------------------------------

def runtime_experiments(n_tasks: int = 400,
                        seed: int = 0) -> dict[str, ExperimentSpec]:
    """One experiment per online-runtime wave scenario (the benchmark's
    "locality" arm, ``paper_cyclic``, as the canonical policy)."""
    policy = dataclasses.replace(named("paper_cyclic"), seed=seed)
    return {name: ExperimentSpec(policy=policy, workload=wl)
            for name, wl in runtime_workloads(n_tasks=n_tasks,
                                              seed=seed).items()}


def replay_experiments(steps: int = 48,
                       seed: int = 0) -> dict[str, ExperimentSpec]:
    """One experiment per trace-replay scenario under the shared recording
    baseline (``replay_baseline``: greedy + constant re-prefill penalty +
    trace recording on)."""
    policy = dataclasses.replace(named("replay_baseline"), seed=seed)
    return {name: ExperimentSpec(policy=policy, workload=wl)
            for name, wl in replay_workloads(steps=steps, seed=seed).items()}


def control_experiments(steps: int = 48,
                        seed: int = 0) -> dict[str, ExperimentSpec]:
    """One experiment per control-plane scenario under the full controlled
    policy (``controlled_replay``)."""
    policy = dataclasses.replace(named("controlled_replay"), seed=seed)
    return {name: ExperimentSpec(policy=policy, workload=wl)
            for name, wl in control_workloads(steps=steps, seed=seed).items()}


def topology_workloads(steps: int = 48, seed: int = 0,
                       num_domains: int = 8) -> dict[str, WorkloadSpec]:
    """``benchmarks.topology_locality``'s scenarios: the storm-prone
    hot-skew and bursty arrivals scaled up to the 8-domain two-socket/pod
    machine the topology policies declare."""
    std = standard_workloads(num_domains, steps, seed)
    return {name: std[name] for name in ("hot_skew", "bursty")}


def topology_experiments(steps: int = 48,
                         seed: int = 0) -> dict[str, ExperimentSpec]:
    """The flat-vs-hierarchical matrix: each topology policy (flat
    baseline, two-level sockets, adaptive pods) on each topology workload
    — the declarative arms of ``benchmarks.topology_locality``."""
    reg: dict[str, ExperimentSpec] = {}
    for pol in ("topology_flat", "topology_two_level",
                "topology_pods_adaptive"):
        policy = dataclasses.replace(named(pol), seed=seed)
        for name, wl in topology_workloads(steps=steps, seed=seed).items():
            reg[f"{pol}_{name}"] = ExperimentSpec(policy=policy, workload=wl)
    return reg


def variability_experiments(steps: int = 48, seed: int = 0,
                            repeats: int = 5) -> dict[str, ExperimentSpec]:
    """The run-to-run variability axis (paper Fig. 4): the storm-prone
    hot-skew workload under the canonical locality policy, re-run under
    ``repeats`` seed-shifted copies so ``ExperimentResult.aggregates()``
    yields a real mean/min/max/stdev ladder instead of a single point."""
    policy = dataclasses.replace(named("paper_cyclic"), seed=seed)
    wl = standard_workloads(4, steps, seed)["hot_skew"]
    return {"variability_hot_skew": ExperimentSpec(
        policy=policy, workload=wl, repeats=repeats)}


def _build_registry() -> dict[str, ExperimentSpec]:
    reg: dict[str, ExperimentSpec] = {}
    for name, wl in standard_workloads().items():
        reg[name] = ExperimentSpec(policy=named("paper_cyclic"), workload=wl)
    for name, exp in runtime_experiments().items():
        reg[f"runtime_{name}"] = exp
    for name, exp in replay_experiments().items():
        reg[f"replay_{name}"] = exp
    for name, exp in control_experiments().items():
        reg[f"control_{name}"] = exp
    reg.update(topology_experiments())
    reg.update(variability_experiments())
    return reg


_EXPERIMENTS: dict[str, ExperimentSpec] = _build_registry()


def experiment_names() -> tuple[str, ...]:
    """The registered experiment names, in registration order."""
    return tuple(_EXPERIMENTS)


def experiment(name: str) -> ExperimentSpec:
    """The registered ``ExperimentSpec`` for ``name`` (frozen — use
    ``dataclasses.replace`` to derive variants)."""
    try:
        return _EXPERIMENTS[name]
    except KeyError:
        raise SpecError(f"unknown experiment {name!r} "
                        f"(registered: {list(_EXPERIMENTS)})") from None
