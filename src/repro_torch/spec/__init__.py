"""repro.spec — one declarative, serializable policy spec for the system.

Three PRs grew three construction surfaces: a 14-kwarg ``Executor``,
hand-spliced ``ControlLoop``/``TraceRecorder`` attachment, and a
``ServingEngine`` with its own private executor wiring.  The *policy
configuration* — queue topology, steal order, throttle — is the experiment
(Wittmann & Hager's locality-queue layer is exactly such a policy), so it
deserves a first-class representation.  This package is that
representation: a frozen dataclass tree that fully names a runtime system
and is the single construction API for runtime + trace + control + serving.

  paper concept (§)                      spec object
  -------------------------------------  ---------------------------------
  the experiment = the policy            ``RuntimeSpec``: domains, worker
  (queue topology + steal rule, §2)      map, steal order, pool cap, seed
  steal governor choice (§2.2 vs §3.1)   ``GovernorSpec`` (+ ``BreakerSpec``
                                         decoration)
  nonlocal-access penalty (§1.4)         ``PenaltySpec`` — serializable, so
                                         a trace names its own cost model
  routing / batching policy knobs        ``RouterSpec`` / ``BatchSpec``
  record the run (trace schema v2)       ``TraceSpec``; the trace header
                                         embeds the whole spec, so
                                         ``replay(trace)`` needs no code
  replicas as domains                    ``ServingSpec`` +
                                         ``ServingEngine(spec=...)``

Usage::

    from repro_torch import spec

    s = spec.named("controlled_replay")        # or spec.load("my.json")
    built = s.build()                          # executor + control + recorder
    ...  # drive built.executor; record via built.recorder
    print(s.to_json())                         # the policy as a JSON file

Raw constructor kwargs on ``Executor``/``ServingEngine`` remain as a thin
deprecated path for callables and tests; new configurations should be
specs (a JSON file, not a code change).
"""
from .build import (Built, build, build_governor, build_penalty,
                    build_topology, checkpoint)
from .experiments import (AGGREGATE_STATS, EXPERIMENT_VERSION, CostsSpec,
                          ExperimentResult, ExperimentSpec, RunResult,
                          SkewSpec, WorkloadSpec, aggregate_runs,
                          control_experiments, control_workloads,
                          dump_experiment, experiment, experiment_names,
                          load_experiment, replay_experiments,
                          replay_workloads, runtime_experiments,
                          runtime_workloads, standard_workloads,
                          topology_experiments, topology_workloads,
                          variability_experiments)
from .model import (SPEC_VERSION, BatchSpec, BatchStateSpec, BreakerSpec,
                    BreakerStateSpec, GovernorSpec, GovernorStateSpec,
                    ObsSpec, PenaltySpec, RouterSpec, RuntimeSpec,
                    ServingSpec, SpecError, TopologySpec, TraceSpec, dump,
                    load)
from .registry import named, policy_names

__all__ = [
    "Built", "build", "build_governor", "build_penalty", "build_topology",
    "checkpoint",
    "AGGREGATE_STATS", "EXPERIMENT_VERSION", "CostsSpec", "ExperimentResult",
    "ExperimentSpec", "RunResult", "SkewSpec", "WorkloadSpec",
    "aggregate_runs",
    "control_experiments", "control_workloads", "dump_experiment",
    "experiment", "experiment_names", "load_experiment",
    "replay_experiments", "replay_workloads", "runtime_experiments",
    "runtime_workloads", "standard_workloads",
    "topology_experiments", "topology_workloads", "variability_experiments",
    "SPEC_VERSION", "BatchSpec", "BatchStateSpec", "BreakerSpec",
    "BreakerStateSpec", "GovernorSpec", "GovernorStateSpec", "ObsSpec",
    "PenaltySpec", "RouterSpec", "RuntimeSpec", "ServingSpec", "SpecError",
    "TopologySpec", "TraceSpec", "dump", "load",
    "named", "policy_names",
]
