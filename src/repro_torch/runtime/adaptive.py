"""Steal governors: when is a worker allowed to steal?

The paper's answer is "always" — load balance strictly dominates locality
(§2.2), which is right for its memory-bound stencil where a steal costs a
bounded nonlocal-bandwidth penalty.  Online workloads (the serving engine)
can have much steeper steal penalties (a full prefix re-prefill), so the
runtime makes the decision pluggable:

  ``GreedySteal``   — the paper's behaviour: any nonempty victim is fair game.
  ``NoSteal``       — never steal (models ``schedule(static)`` worksharing:
                      pure locality, no balancing).
  ``AdaptiveSteal`` — queue-depth-driven throttling (beyond the paper, toward
                      the roadmap): steal only from victims whose backlog is
                      at least a threshold θ that tracks the observed steal
                      penalty, and decay θ while a worker idles so balance
                      still wins in the limit — the paper's balance-over-
                      locality ordering is preserved, just delayed until the
                      expected payoff covers the penalty.

Governors see only queue depths and their own steal/idle history, never task
contents — they compose with any ``DomainQueues`` steal order.
"""
from __future__ import annotations

from typing import Optional

from .workers import Worker


class StealGovernor:
    """Base contract: a minimum victim depth per dequeue attempt."""

    def min_victim_depth(self, worker: Worker) -> Optional[int]:
        """Victims need at least this many queued tasks to be stolen from;
        ``None`` forbids stealing entirely for this attempt."""
        return 1

    def min_victim_depth_at(self, worker: Worker,
                            level: int) -> Optional[int]:
        """Per-topology-tier form of ``min_victim_depth`` (level 1 = the
        nearest tier).  The executor consults it only under a hierarchical
        ``repro.topology.DistanceMatrix``; the base contract prices every
        tier at the flat threshold, so level-blind governors behave
        identically on flat and hierarchical machines."""
        return self.min_victim_depth(worker)

    def on_idle(self, worker: Worker) -> None:
        """Called when ``worker`` polled and found nothing it may take."""

    def on_execute(self, worker: Worker, stolen: bool, penalty: float,
                   cost: float = 1.0, level: int = 1) -> None:
        """Called after ``worker`` executed a task.  ``cost`` is the task's
        local execution cost (its measured service time is ``cost+penalty``)
        so governors can learn service times online instead of being
        configured with static hints (``repro.trace.MeasuredPenalty``).
        ``level`` is the topology tier the task was stolen across (1 on
        flat machines, 0 for local executions) so governors can learn
        per-tier penalties."""


class GreedySteal(StealGovernor):
    """The paper's §2.2 policy: steal whenever the local queue is dry."""


class NoSteal(StealGovernor):
    """Pure locality — workers only ever serve their own domain."""

    def min_victim_depth(self, worker: Worker) -> Optional[int]:
        return None


class AdaptiveSteal(StealGovernor):
    """Depth-thresholded stealing with an online penalty estimate.

    θ = clamp(round(penalty_estimate / task_cost), 1, max_threshold): a steal
    is worthwhile when the victim's backlog is deep enough that helping out
    beats the nonlocal penalty.  Each consecutive idle poll lowers a worker's
    effective θ by one (floor 1), so a starved worker always steals
    eventually — progress is guaranteed and the throttle only reorders work.
    The penalty estimate starts at ``penalty_hint`` and follows observed
    steal penalties by an exponential moving average.

    Under a hierarchical topology the governor additionally learns one
    penalty EMA *per steal tier* (steals report their topology ``level``):
    crossing a pod costs more than crossing a socket, so each tier earns its
    own θ (``min_victim_depth_at``), seeded from the flat ``penalty_hint``
    until that tier has been observed.  The flat ``threshold`` /
    ``penalty_estimate`` pair keeps its original all-steals semantics, so
    flat-machine behaviour (every steal is level 1) is unchanged.
    """

    def __init__(self, penalty_hint: float = 4.0, task_cost: float = 1.0,
                 ema: float = 0.2, max_threshold: int = 64):
        if task_cost <= 0:
            raise ValueError("task_cost must be positive")
        if not 0.0 < ema <= 1.0:
            raise ValueError("ema must be in (0, 1]")
        self.task_cost = task_cost
        self.ema = ema
        self.max_threshold = max_threshold
        self._penalty = float(penalty_hint)
        self._level_penalty: dict[int, float] = {}
        # plain dict, read via .get: a defaultdict here would grow on every
        # read (min_victim_depth inserts a zero per probed worker) and its
        # live view leaked through accessors lets callers mutate governor
        # state — the linter's state-view rule now guards this class of bug
        self._idle: dict[int, int] = {}

    @property
    def threshold(self) -> int:
        return min(max(round(self._penalty / self.task_cost), 1),
                   self.max_threshold)

    @property
    def penalty_estimate(self) -> float:
        return self._penalty

    def threshold_at(self, level: int) -> int:
        """Per-tier θ: priced from that tier's own penalty EMA, falling back
        to the flat estimate for tiers never yet stolen across."""
        est = self._level_penalty.get(level, self._penalty)
        return min(max(round(est / self.task_cost), 1), self.max_threshold)

    def level_penalty_estimates(self) -> dict[int, float]:
        """Learned per-tier penalty EMAs (tier -> estimate); empty until a
        hierarchical run reports steal levels.  Snapshot surface for
        ``repro.spec.GovernorStateSpec``."""
        return dict(self._level_penalty)

    def seed_level_penalties(self, estimates: dict[int, float]) -> None:
        """Restore per-tier penalty EMAs from a snapshot (checkpoint/
        restore counterpart of ``level_penalty_estimates``)."""
        self._level_penalty.update(
            {int(lv): float(est) for lv, est in estimates.items()})

    def idle_counts(self) -> dict[int, int]:
        """Consecutive idle polls per worker id — a plain-dict snapshot
        (mutating it never touches the governor)."""
        return dict(self._idle)

    def min_victim_depth(self, worker: Worker) -> Optional[int]:
        return max(self.threshold - self._idle.get(worker.wid, 0), 1)

    def min_victim_depth_at(self, worker: Worker,
                            level: int) -> Optional[int]:
        return max(self.threshold_at(level) - self._idle.get(worker.wid, 0),
                   1)

    def on_idle(self, worker: Worker) -> None:
        self._idle[worker.wid] = self._idle.get(worker.wid, 0) + 1

    def on_execute(self, worker: Worker, stolen: bool, penalty: float,
                   cost: float = 1.0, level: int = 1) -> None:
        self._idle[worker.wid] = 0
        if stolen:
            self._penalty = (1 - self.ema) * self._penalty + self.ema * penalty
            prev = self._level_penalty.get(level)
            self._level_penalty[level] = (
                penalty if prev is None
                else (1 - self.ema) * prev + self.ema * penalty)
