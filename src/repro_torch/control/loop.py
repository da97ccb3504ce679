"""The control loop: wire routing, batching, and the breaker into a runtime.

``ControlLoop`` is the composition point of the control plane.  It owns up
to three controllers — a ``CostRouter`` (submit side), a ``BatchGovernor``
(grab size), and a ``StormBreaker`` (steal throttle) — and splices them
into an ``Executor``'s existing hook points:

    router   -> Executor.router        (consulted on submit(domain=None))
    batcher  -> Executor.batch         (read per grab, fed per batch)
    breaker  -> Executor.governor      (decorating the previous governor)
    loop     -> Executor.step_hook     (the breaker's detector heartbeat)

Everything the loop reads (queue costs, counter deltas, the step clock) is
deterministic state of the cooperative executor, so a *controlled* run is
exactly as replayable as an uncontrolled one: record it with
``repro.trace.TraceRecorder`` and replay with a factory that attaches a
fresh, identically-configured ``ControlLoop`` — the replayed
``RuntimeStats`` reproduce the recorded ones bit-for-bit.

Attach order matters when recording: attach the control loop *before* the
trace recorder snapshots meta (the breaker replaces the governor object).
"""
from __future__ import annotations

from typing import Optional

from ..runtime import Executor
from .batching import BatchGovernor
from .breaker import StormBreaker
from .router import CostRouter


class ControlLoop:
    """Compose cost routing + continuous batching + the steal breaker."""

    def __init__(self, router: Optional[CostRouter] = None,
                 batcher: Optional[BatchGovernor] = None,
                 breaker: Optional[StormBreaker] = None):
        self.router = router
        self.batcher = batcher
        self.breaker = breaker
        self._ex: Optional[Executor] = None

    @classmethod
    def full(cls, *, spill_penalty: float = 4.0, target_service: float = 8.0,
             batch_cap: int = 8, width: int = 8, cooldown: int = 3,
             mode: str = "raise") -> "ControlLoop":
        """The all-controllers configuration used by the benchmarks."""
        return cls(router=CostRouter(spill_penalty=spill_penalty),
                   batcher=BatchGovernor(target_service=target_service,
                                         batch_cap=batch_cap),
                   breaker=StormBreaker(width=width, cooldown=cooldown,
                                        mode=mode))

    def attach(self, executor: Executor) -> Executor:
        """Splice the controllers into ``executor`` and return it
        (chainable, mirroring ``TraceRecorder.attach``)."""
        if self._ex is not None:
            raise RuntimeError("ControlLoop is already attached; "
                               "use one loop per executor")
        if self.router is not None:
            self.router.bind(executor)
            executor.router = self.router.route
        if self.batcher is not None:
            executor.batch = self.batcher
        if self.breaker is not None:
            if self.breaker.inner is None:
                self.breaker.inner = executor.governor
            executor.governor = self.breaker
        prev_hook = executor.step_hook

        def on_step(ex: Executor, _prev=prev_hook) -> None:
            if self.breaker is not None:
                self.breaker.observe(ex)
            if _prev is not None:
                _prev(ex)

        executor.step_hook = on_step
        self._ex = executor
        return executor

    @property
    def executor(self) -> Executor:
        if self._ex is None:
            raise RuntimeError("ControlLoop is not attached to an executor")
        return self._ex

    def governor_state(self):
        """Export the attached executor's learned governor θ state as a
        serializable ``repro.spec.GovernorStateSpec`` (the breaker
        decoration is unwrapped), or None when the effective governor
        carries no learned state (greedy/none kinds).  The declarative
        checkpoint surface for *controlled* systems — pair with
        ``repro.spec.checkpoint(executor)`` for the full spec."""
        from ..spec import GovernorStateSpec, SpecError  # lazy: spec↔control

        try:
            return GovernorStateSpec.from_governor(self.executor.governor)
        except SpecError:
            return None

    def snapshot(self) -> dict[str, float]:
        """Controller state for logging/benchmark JSON."""
        out: dict[str, float] = {}
        if self.router is not None:
            out["routed"] = self.router.routed
            out["spilled"] = self.router.spilled
            out["remote_spills"] = self.router.remote_spills
        if self.batcher is not None:
            out["batch_size"] = self.batcher.size
            out["batches"] = self.batcher.batches
            if self.batcher.service_estimate is not None:
                out["service_estimate"] = round(
                    self.batcher.service_estimate, 4)
        if self.breaker is not None:
            out["breaker_trips"] = self.breaker.trips
            out["breaker_tripped"] = int(self.breaker.tripped)
            out["breaker_remote_trips"] = self.breaker.remote_trips
        return out
