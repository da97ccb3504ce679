"""Named policy registry: the canonical spec per scheduling experiment.

Every entry is a complete ``RuntimeSpec`` value — ``named("paper_cyclic")``
is the declarative form of the configuration the benchmarks previously
wired by hand, and ``specs/<name>.json`` pins its canonical JSON form as a
golden file (``tests/test_spec.py`` keeps them in lockstep;
``python -m repro.spec.validate specs`` proves each one still parses,
builds, and replays).

  paper_cyclic         the paper's §2.2 layer: home routing, cyclic greedy
                       stealing, one-task grabs (``benchmarks``' "locality")
  static_local         pure locality, never steal (OpenMP
                       ``schedule(static)`` — the "static" arm)
  tasking_round_robin  round-robin routing, greedy stealing (plain OpenMP
                       tasking — the "tasking" arm)
  adaptive_theta       home routing + depth-thresholded stealing with a
                       static penalty hint (the "adaptive" arm)
  measured_theta       ``MeasuredPenalty``: both θ inputs learned from
                       measurements (the "measured" arm)
  replay_baseline      the greedy recording baseline of ``benchmarks/
                       {trace_replay,control_plane}.py``: home routing,
                       cyclic greedy stealing, constant re-prefill
                       penalty, trace recording on — the single
                       definition both benchmarks record under
  controlled_replay    the full control plane of ``benchmarks/
                       control_plane.py``'s controlled arm: cost routing
                       with spill, governed budgeted batching, storm
                       breaker, cost-weighted victim selection
  measured_spill       ``controlled_replay`` with the spill threshold
                       priced from the governor's live penalty estimate
                       instead of the static hint (ROADMAP follow-up)
  controlled_serving   the self-tuning serving configuration of
                       ``examples/control_serving.py``: 2 replicas as
                       locality domains, re-prefill penalty, control plane
                       sized for request streams
  topology_flat        the topology benchmark's baseline arm: 8 domains on
                       an explicit *flat* distance tree (distance 1
                       everywhere) — builds the bit-identical single-level
                       steal scan, proving the flat TopologySpec is a no-op
  topology_two_level   the same runtime on a 4+4 socket pair (near 1,
                       far 4): nearest-first stealing, remote steals pay
                       the scaled link distance
  topology_pods_adaptive
                       the full hierarchical control plane on a 2×4 pod
                       tree (cross-pod distance from
                       ``core.topology.tpu_topology``'s remote factor):
                       adaptive per-level θ, level-aware breaker,
                       breaker-aware cost routing, per-domain governed
                       batching
"""
from __future__ import annotations

from .model import (BatchSpec, BreakerSpec, GovernorSpec, PenaltySpec,
                    RouterSpec, RuntimeSpec, ServingSpec, SpecError,
                    TopologySpec, TraceSpec)

# Benchmark-wide constants these policies share (see benchmarks/
# runtime_throughput.py and benchmarks/control_plane.py).
_RUNTIME_PENALTY = 4.0        # runtime_throughput's abstract steal cost
_REPLAY_PENALTY = 6.0         # trace_replay / control_plane re-prefill cost

_CONTROLLED = RuntimeSpec(
    num_domains=4,
    steal_order="cost_weighted",
    penalty=PenaltySpec(kind="constant", value=_REPLAY_PENALTY),
    governor=GovernorSpec(kind="greedy", breaker=BreakerSpec()),
    router=RouterSpec(kind="cost", spill_penalty=_REPLAY_PENALTY),
    batch=BatchSpec(kind="governed"),
)

_REGISTRY: dict[str, RuntimeSpec] = {
    "paper_cyclic": RuntimeSpec(
        num_domains=4, steal_order="cyclic",
        penalty=PenaltySpec(kind="constant", value=_RUNTIME_PENALTY),
        governor=GovernorSpec(kind="greedy"),
    ),
    "static_local": RuntimeSpec(
        num_domains=4, steal_order="cyclic",
        penalty=PenaltySpec(kind="constant", value=_RUNTIME_PENALTY),
        governor=GovernorSpec(kind="none"),
    ),
    "tasking_round_robin": RuntimeSpec(
        num_domains=4, steal_order="cyclic",
        penalty=PenaltySpec(kind="constant", value=_RUNTIME_PENALTY),
        governor=GovernorSpec(kind="greedy"),
        router=RouterSpec(kind="round_robin"),
    ),
    "adaptive_theta": RuntimeSpec(
        num_domains=4, steal_order="cyclic",
        penalty=PenaltySpec(kind="constant", value=_RUNTIME_PENALTY),
        governor=GovernorSpec(kind="adaptive",
                              penalty_hint=_RUNTIME_PENALTY),
    ),
    "measured_theta": RuntimeSpec(
        num_domains=4, steal_order="cyclic",
        penalty=PenaltySpec(kind="constant", value=_REPLAY_PENALTY),
        governor=GovernorSpec(kind="measured", penalty_hint=1.0),
    ),
    "replay_baseline": RuntimeSpec(
        num_domains=4, steal_order="cyclic",
        penalty=PenaltySpec(kind="constant", value=_REPLAY_PENALTY),
        governor=GovernorSpec(kind="greedy"),
        trace=TraceSpec(record=True),
    ),
    "controlled_replay": _CONTROLLED,
    "measured_spill": RuntimeSpec(
        num_domains=4,
        steal_order="cost_weighted",
        penalty=PenaltySpec(kind="constant", value=_REPLAY_PENALTY),
        governor=GovernorSpec(kind="adaptive", penalty_hint=_REPLAY_PENALTY,
                              breaker=BreakerSpec()),
        router=RouterSpec(kind="cost", spill_penalty=_REPLAY_PENALTY,
                          spill="measured"),
        batch=BatchSpec(kind="governed"),
    ),
    "controlled_serving": RuntimeSpec(
        num_domains=2,
        steal_order="longest",
        penalty=PenaltySpec(kind="cost_if_homed", value=1.0),
        governor=GovernorSpec(
            kind="greedy",
            breaker=BreakerSpec(width=2, min_executed=2, cooldown=2)),
        router=RouterSpec(kind="cost", spill_penalty=8.0),
        batch=BatchSpec(kind="governed", target_service=24.0, batch_cap=4),
        serving=ServingSpec(num_replicas=2, max_seq=64, policy="locality"),
    ),
    "topology_flat": RuntimeSpec(
        num_domains=8, steal_order="cyclic",
        penalty=PenaltySpec(kind="constant", value=_REPLAY_PENALTY),
        governor=GovernorSpec(kind="greedy"),
        trace=TraceSpec(record=True),
        topology=TopologySpec(kind="flat"),
    ),
    "topology_two_level": RuntimeSpec(
        num_domains=8, steal_order="cyclic",
        penalty=PenaltySpec(kind="constant", value=_REPLAY_PENALTY),
        governor=GovernorSpec(kind="greedy"),
        trace=TraceSpec(record=True),
        topology=TopologySpec(kind="grouped", groups=(4, 4), far=4.0),
    ),
    "topology_pods_adaptive": RuntimeSpec(
        num_domains=8, steal_order="cost_weighted",
        penalty=PenaltySpec(kind="constant", value=_REPLAY_PENALTY),
        governor=GovernorSpec(kind="adaptive", penalty_hint=_REPLAY_PENALTY,
                              breaker=BreakerSpec()),
        router=RouterSpec(kind="cost", spill_penalty=_REPLAY_PENALTY,
                          breaker_aware=True),
        batch=BatchSpec(kind="governed", per_domain=True),
        trace=TraceSpec(record=True),
        topology=TopologySpec(kind="pods", num_pods=2, domains_per_pod=4),
    ),
}


def policy_names() -> tuple[str, ...]:
    """The registered policy names, in registration order."""
    return tuple(_REGISTRY)


def named(name: str) -> RuntimeSpec:
    """The registered ``RuntimeSpec`` for ``name`` (frozen — use
    ``dataclasses.replace`` to derive variants, e.g. a different seed)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise SpecError(f"unknown policy {name!r} "
                        f"(registered: {list(_REGISTRY)})") from None
