"""Measured-service-time feedback into the adaptive steal governor.

``runtime.AdaptiveSteal`` throttles stealing by θ ≈ penalty / task_cost, but
PR 1 left both inputs static: a hand-picked ``penalty_hint`` and a nominal
``task_cost`` of 1.  ``MeasuredPenalty`` replaces the hints with
measurements (the ROADMAP's "feed measured per-task service times back into
AdaptiveSteal"):

  * online — every executed task reports its cost to the governor
    (``StealGovernor.on_execute(..., cost=...)``); local runs stream into
    an EMA of the *local* service time (the θ denominator), steals stream
    their actually-charged penalty into the inherited penalty EMA (the θ
    numerator).  θ then tracks reality on both axes.

  * offline — ``MeasuredPenalty.from_trace`` seeds both estimates from a
    recorded trace's run/steal event pairs: a run event's service is its
    cost, a steal event's is cost + penalty, and the difference is what a
    steal really costs on this workload.  A replayed A/B can therefore
    start the governor where the previous run ended instead of re-learning
    from a guess.

The resulting θ is dimensionally a queue depth: "how many tasks deep must a
victim be before relieving it pays for the nonlocal access" — the paper's
balance-over-locality rule, priced with measured numbers.
"""
from __future__ import annotations

from ..runtime import AdaptiveSteal, Worker
from .schema import Trace, event_stolen

_MIN_COST = 1e-9


def _mean(xs) -> float | None:
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None


class MeasuredPenalty(AdaptiveSteal):
    """``AdaptiveSteal`` with both θ inputs learned from measurements.

    ``penalty_hint``/``task_cost`` act only as pre-measurement priors; after
    warm-up the estimates are entirely data-driven.  Construct directly for
    pure online learning, or via ``from_trace`` to start from a recorded
    run's observed service times.
    """

    def __init__(self, penalty_hint: float = 1.0, task_cost: float = 1.0,
                 ema: float = 0.2, max_threshold: int = 64):
        super().__init__(penalty_hint=penalty_hint, task_cost=task_cost,
                         ema=ema, max_threshold=max_threshold)
        self.observed_local = 0
        self.observed_steals = 0

    @classmethod
    def from_trace(cls, trace: Trace, ema: float = 0.2,
                   max_threshold: int = 64) -> "MeasuredPenalty":
        """Seed the estimates from a recorded trace's execution events.

        Local service = mean *cost* over executed events (cost is the local
        component of every execution, stolen or not — a stolen/backpressure
        execution's penalty must never inflate the θ denominator); steal
        penalty = mean actually-charged penalty over stolen executions,
        judged by victim queue so backpressure ``inline`` steals count
        (falling back to the steal-vs-local service gap, then to the local
        service itself when the trace recorded no steals — θ starts at 1,
        the greedy limit).
        """
        executed = [e for e in trace.events
                    if e.kind in ("run", "steal", "inline")]
        local = _mean(e.cost for e in executed)
        if local is None or local <= 0:
            local = 1.0
        stolen = [e for e in executed if event_stolen(e)]
        pen = _mean(e.penalty for e in stolen)
        if pen is None:
            steal_service = _mean(trace.service_times()["steal"])
            pen = (steal_service - local) if steal_service is not None else local
        gov = cls(penalty_hint=max(pen, 0.0), task_cost=max(local, _MIN_COST),
                  ema=ema, max_threshold=max_threshold)
        gov.observed_local = len(executed) - len(stolen)
        gov.observed_steals = len(stolen)
        return gov

    @property
    def local_cost_estimate(self) -> float:
        """Current EMA of local service time — θ's denominator."""
        return self.task_cost

    def on_execute(self, worker: Worker, stolen: bool, penalty: float,
                   cost: float = 1.0, level: int = 1) -> None:
        if stolen:
            self.observed_steals += 1
        else:
            self.observed_local += 1
            self.task_cost = max(
                (1 - self.ema) * self.task_cost + self.ema * cost, _MIN_COST)
        super().on_execute(worker, stolen, penalty, cost, level=level)
