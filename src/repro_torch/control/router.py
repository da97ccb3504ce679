"""Cost-aware routing: pick submit domains by estimated backlog time.

The paper routes a task to the domain that owns its data and lets the steal
scan fix imbalance after the fact (§2.2: balance over locality, applied at
*dequeue* time).  Under heavy-tailed task costs that is too late: a queue
that is short in *items* can be the longest in *work*, and round-robin (or
home) routing keeps feeding it.  ``CostRouter`` moves the balance decision
to *submit* time, where it is free — re-routing a task before it is
enqueued migrates no data, while fixing the same imbalance later via a
steal pays the nonlocal penalty.

The estimate is the classic join-shortest-work heuristic: a domain's
backlog time is its queued cost (``DomainQueues.queue_costs``, maintained
O(1) per enqueue/dequeue) divided by the number of workers pinned to it.
Queued cost measures drain *time* exactly when grabs deliver a fixed cost
budget per round — i.e. under ``BatchGovernor``'s budgeted continuous
batching, the configuration ``ControlLoop.full`` wires up.  (Without
batching this executor serves one item per worker-round whatever it costs,
and depth, not cost, is the wait; the two controllers are designed as a
pair, not as independent toggles.)
Homed tasks stay home unless the home's backlog exceeds the best domain's
by more than the spill threshold — i.e. a task is only sent away from its
data when the queueing-delay gap is worth more than the nonlocal access it
will pay (the same θ-style trade the ``AdaptiveSteal`` governor prices on
the dequeue side).  With ``measured=True`` that threshold is not a static
hint but the governor's live ``penalty_estimate`` (``AdaptiveSteal`` /
``trace.MeasuredPenalty``, unwrapped through a ``StormBreaker`` decorator):
the router and the governor then price the *same* nonlocal cost from the
same measurements, submit-side and dequeue-side respectively
(``repro.spec.RouterSpec(spill="measured")``).
"""
from __future__ import annotations

import math
from typing import Optional

from ..runtime import Executor, Task


class CostRouter:
    """Route submissions to the domain with the least estimated backlog time.

    Under a hierarchical topology (the bound executor carries a
    ``repro.topology.DistanceMatrix``), a homed task's spill candidates are
    considered nearest tier first and each tier's threshold is scaled by
    its link distance: spilling within the home socket asks the flat gap,
    spilling across the socket (or pod) must pay proportionally more —
    within-socket relief is exhausted before work leaves the socket, the
    submit-side mirror of the queues' nearest-first steal scan.

    Parameters
    ----------
    spill_penalty:  backlog-time gap (in cost units) a homed task's home
                    queue must exceed before the task is re-routed to the
                    cheapest domain; 0 makes every task join the shortest
                    work queue, ``None`` never spills homed tasks (pure
                    locality routing for homed, cost routing for homeless).
    measured:       price the spill threshold from the bound executor's
                    governor ``penalty_estimate`` instead of the static
                    ``spill_penalty`` hint (which remains the fallback for
                    governors that measure nothing, e.g. ``GreedySteal``).
    breaker_aware:  consult the bound executor's ``StormBreaker`` (when its
                    governor is one): while the full breaker is tripped,
                    homed tasks are never spilled (routing must not re-feed
                    the storm the breaker is quenching); while only the
                    remote state is tripped, spills stay within the home's
                    nearest tier.
    """

    def __init__(self, spill_penalty: Optional[float] = 4.0,
                 measured: bool = False, breaker_aware: bool = False):
        self.spill_penalty = spill_penalty
        self.measured = measured
        self.breaker_aware = breaker_aware
        self._ex: Optional[Executor] = None
        self._workers_per_domain: list[int] = []
        self.routed = 0
        self.spilled = 0         # homed tasks sent away from their home
        self.remote_spills = 0   # spills that crossed a topology tier >= 2

    def bind(self, executor: Executor) -> "CostRouter":
        """Point the router at ``executor``'s queues/worker layout (done by
        ``ControlLoop.attach``; call directly for standalone use)."""
        self._ex = executor
        counts = [0] * executor.num_domains
        for w in executor.pool:
            counts[w.domain] += 1
        self._workers_per_domain = counts
        return self

    def backlog_time(self, domain: int) -> float:
        """Estimated wait a task routed to ``domain`` sees: queued cost over
        pinned workers (inf for domains no worker serves — they only drain
        via steals, so the router never feeds them directly)."""
        if self._ex is None:
            raise RuntimeError("CostRouter is not bound to an executor")
        workers = self._workers_per_domain[domain]
        if workers == 0:
            return math.inf
        return self._ex.queues.cost(domain) / workers

    def spill_threshold(self) -> Optional[float]:
        """The live spill threshold: the governor's measured penalty
        estimate when ``measured`` (unwrapping a ``StormBreaker``'s inner
        governor), else the static ``spill_penalty`` hint."""
        if self.measured and self._ex is not None:
            gov = self._ex.governor
            gov = getattr(gov, "inner", None) or gov    # breaker decoration
            est = getattr(gov, "penalty_estimate", None)
            if est is not None:
                return float(est)
        return self.spill_penalty

    def _breaker_states(self) -> tuple[bool, bool]:
        """(full_tripped, remote_tripped) of the bound executor's breaker
        when ``breaker_aware``; (False, False) otherwise or when the
        governor is no breaker."""
        if not self.breaker_aware or self._ex is None:
            return False, False
        gov = self._ex.governor
        return (bool(getattr(gov, "tripped", False)),
                bool(getattr(gov, "remote_tripped", False)))

    def route(self, task: Task) -> int:
        """Submit domain for ``task``: least-backlog, home-sticky up to
        ``spill_threshold()`` (the ``Executor(router=...)`` callback).

        Hierarchical topologies spill nearest-first with distance-scaled
        thresholds; ``breaker_aware`` suspends spilling while the breaker
        quenches a storm (remote-only trips only suspend cross-tier
        spills).  Homeless tasks always join the least-backlog domain.
        """
        backlogs = [self.backlog_time(d)
                    for d in range(self._ex.num_domains)]
        best = min(range(len(backlogs)), key=lambda d: (backlogs[d], d))
        self.routed += 1
        home = task.home
        if not (0 <= home < len(backlogs) and backlogs[home] < math.inf):
            return best
        tripped, remote_tripped = self._breaker_states()
        if tripped:
            return home
        spill = self.spill_threshold()
        topo = getattr(self._ex, "topology", None)
        if topo is None or not topo.hierarchical:
            if spill is None or backlogs[home] - backlogs[best] <= spill:
                return home
            self.spilled += 1
            return best
        if spill is None:
            return home
        for level in range(1, topo.num_levels + 1):
            if level >= 2 and remote_tripped:
                break
            cands = [d for d in topo.peers(home, level)
                     if backlogs[d] < math.inf]
            if not cands:
                continue
            cand = min(cands, key=lambda d: (backlogs[d], d))
            # the gap must beat the spill threshold scaled by the link the
            # task's data would be accessed across — within-socket relief
            # is exhausted before work leaves the socket
            if (backlogs[home] - backlogs[cand]
                    > spill * topo.distance(home, cand)):
                self.spilled += 1
                if level >= 2:
                    self.remote_spills += 1
                return cand
        return home
