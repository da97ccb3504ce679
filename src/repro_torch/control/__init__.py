"""repro.control — the online control plane over the locality runtime.

PR 1 (``repro.runtime``) built the paper's mechanism — locality queues,
steal scans, governors — and PR 2 (``repro.trace``) the observability —
recorded traces, replay, storm detectors.  Both leave the *cross-domain
policy* static: the steal threshold, the batch size, and the routing rule
are fixed at construction, while production arrival traces change shape
minute-to-minute.  This package closes the loop: controllers watch the
live runtime and adjust those three knobs online.

Paper-concept map (Wittmann & Hager, 2010), continuing the tables in
``repro/runtime/__init__.py`` and ``repro/trace/__init__.py``:

  paper concept (§)                      control object
  -------------------------------------  ---------------------------------
  balance over locality at dequeue       ``CostRouter``: the same balance
  (§2.2 steal scan)                      decision moved to *submit* time,
                                         priced in queued cost — re-routing
                                         before enqueue migrates no data,
                                         stealing after the fact does
  victim = next nonempty queue (§2.2)    ``cost_weighted`` steal order in
                                         ``runtime.DomainQueues``: victim =
                                         most queued *work*, not most items
  one task per grab (§2.1 tasking)       ``BatchGovernor`` + the executor's
                                         batch grabs: one scheduling round
                                         serves a whole same-queue batch,
                                         sized to a service budget
  Fig. 4 degraded dynamic runs           ``StormBreaker``: the trace-layer
  (steal storms)                         storm detector run online, wired
                                         back into the governor as a
                                         circuit-breaker with cool-down
  (composition)                          ``ControlLoop``: splices all three
                                         into an ``Executor``'s hook points

Every controller reads only deterministic executor state (queue costs,
counter deltas, the step clock), so controlled runs record and replay
bit-identically (``benchmarks/control_plane.py`` A/Bs controlled vs
uncontrolled policies on recorded traces).

Usage::

    from repro_torch.control import ControlLoop
    from repro_torch.runtime import Executor

    ex = ControlLoop.full().attach(
        Executor(4, steal_penalty=lambda t, w: 4.0 * t.cost))
    ...  # submit/step/run_until_drained as usual; policy adapts online
"""
from .batching import BatchGovernor
from .breaker import StormBreaker
from .loop import ControlLoop
from .router import CostRouter

__all__ = ["BatchGovernor", "ControlLoop", "CostRouter", "StormBreaker"]
