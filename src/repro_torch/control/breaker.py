"""Storm-triggered steal circuit-breaker.

``repro.trace.storms`` detects steal storms *offline*: windows where the
balance mechanism degenerated into bulk work migration, paying the nonlocal
penalty on most tasks (the paper's Fig. 4 degraded dynamic runs).
``StormBreaker`` runs the same windowed detector *online* — over the live
executor's streaming counters, not a recorded trace — and acts on it: while
a storm (or a backpressure inline burst) is in progress, stealing is
temporarily throttled by raising the inner governor's depth threshold, or
cut entirely, then re-enabled after a cool-down of quiet windows.

This deliberately bends the paper's balance-over-locality rule (§2.2), but
only transiently and only in the regime where the paper's own evidence says
the rule misfires: when *most* executed tasks in a window are steals, the
backlog is structural (a hot domain, not a momentarily idle one) and every
steal pays the nonlocal penalty without fixing the imbalance.  Once the
cool-down lapses, greedy balance wins again in the limit — same contract as
``AdaptiveSteal``'s idle decay.

The breaker is a ``StealGovernor`` decorator: wrap any inner governor and
install the breaker in its place (``ControlLoop.attach`` does both).  Its
detector reads only ``RuntimeStats`` counter deltas, so it works with event
recording disabled and is deterministic under replay.
"""
from __future__ import annotations

from typing import Optional

from ..runtime import Executor, GreedySteal, StealGovernor, Worker

MODES = ("raise", "block")


class StormBreaker(StealGovernor):
    """Windowed steal-storm detector + governor decorator.

    Under a hierarchical topology the detector gains a *level* dimension:
    windows whose steals are dominated by cross-tier ("remote", level >= 2)
    steals trip a remote-only state first — stealing stays allowed inside a
    socket while the deep links are cut — and only a storm that persists
    (or was never remote-dominated) trips the full breaker.  Cross-level
    storms are thereby detected and broken before the blunt instrument
    engages, at a lower evidence bar (``remote_frac`` < ``steal_frac``):
    a remote steal pays the scaled deep-link penalty, so fewer of them
    justify intervention.

    Parameters
    ----------
    inner:         the governor to decorate; ``ControlLoop.attach`` fills in
                   the executor's current governor when None.
    width:         detector window width in scheduling rounds.
    steal_frac:    steal fraction of executed tasks that trips the breaker.
    inline_frac:   inline (backpressure) fraction that trips it.
    remote_frac:   cross-tier steal fraction that trips the remote-only
                   state (never trips on flat machines, where no steal is
                   remote).
    min_executed:  evidence floor per window (tiny windows never trip).
    cooldown:      windows the breaker stays tripped after the last
                   detection; a storm during cool-down re-arms it.
    mode:          "raise" adds ``boost`` to the inner governor's victim
                   depth threshold while tripped; "block" forbids stealing
                   outright.  The remote-only state applies the same mode,
                   restricted to levels >= 2.
    """

    def __init__(self, inner: StealGovernor | None = None, *,
                 width: int = 8, steal_frac: float = 0.5,
                 inline_frac: float = 0.25, remote_frac: float = 0.25,
                 min_executed: int = 4,
                 cooldown: int = 3, mode: str = "raise", boost: int = 8):
        if width < 1:
            raise ValueError("window width must be >= 1")
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r} (want one of {MODES})")
        self.inner = inner
        self.width = width
        self.steal_frac = steal_frac
        self.inline_frac = inline_frac
        self.remote_frac = remote_frac
        self.min_executed = min_executed
        self.cooldown = cooldown
        self.mode = mode
        self.boost = boost
        self.trips = 0               # distinct full storm episodes
        self.remote_trips = 0        # distinct remote-only episodes
        self._cooldown_left = 0      # windows until stealing re-enables
        self._remote_cooldown_left = 0   # windows until deep links re-enable
        self._last_step = 0
        # (executed, stolen, inline, remote_steals) counter snapshot
        self._seen = (0, 0, 0, 0)

    # -- governor face -------------------------------------------------------
    @property
    def _inner(self) -> StealGovernor:
        return self.inner if self.inner is not None else _GREEDY

    @property
    def tripped(self) -> bool:
        return self._cooldown_left > 0

    @property
    def remote_tripped(self) -> bool:
        """True while cross-tier (level >= 2) stealing is cut; near-tier
        stealing stays governed by the inner governor alone."""
        return self._remote_cooldown_left > 0

    def min_victim_depth(self, worker: Worker) -> Optional[int]:
        base = self._inner.min_victim_depth(worker)
        if not self.tripped:
            return base
        if self.mode == "block" or base is None:
            return None
        return base + self.boost

    def min_victim_depth_at(self, worker: Worker,
                            level: int) -> Optional[int]:
        base = self._inner.min_victim_depth_at(worker, level)
        if self.tripped or (level >= 2 and self.remote_tripped):
            if self.mode == "block" or base is None:
                return None
            return base + self.boost
        return base

    def on_idle(self, worker: Worker) -> None:
        self._inner.on_idle(worker)

    def on_execute(self, worker: Worker, stolen: bool, penalty: float,
                   cost: float = 1.0, level: int = 1) -> None:
        self._inner.on_execute(worker, stolen, penalty, cost, level=level)

    # -- detector face -------------------------------------------------------
    def observe(self, executor: Executor) -> None:
        """Fold the counters accumulated since the last window boundary.

        Call every step (``ControlLoop`` does, via the executor's
        ``step_hook``); it only acts once per ``width`` rounds.
        """
        step = executor.step_count
        if step - self._last_step < self.width:
            return
        self._last_step = step
        s = executor.stats
        now = (s.executed, s.stolen, s.inline_runs, s.remote_steals)
        executed, stolen, inline, remote = (a - b
                                            for a, b in zip(now, self._seen))
        self._seen = now
        self.observe_window(executed, stolen, inline, remote)

    def observe_window(self, executed: int, stolen: int, inline: int,
                       remote: int = 0) -> None:
        """One detector window: trip on a steal storm or an inline burst,
        otherwise let the cool-downs tick down.

        ``remote`` counts the window's cross-tier steals.  A remote-dominated
        storm on a quiet breaker trips only the remote state (deep links cut,
        near stealing preserved); the full breaker engages when a storm
        arrives while already throttling, or when the storm was never
        remote-dominated in the first place.
        """
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
        if self._remote_cooldown_left > 0:
            self._remote_cooldown_left -= 1
        if executed < self.min_executed:
            return
        storm = stolen / executed >= self.steal_frac
        burst = inline / executed >= self.inline_frac
        remote_storm = remote > 0 and remote / executed >= self.remote_frac
        throttling = self._cooldown_left > 0 or self._remote_cooldown_left > 0
        if remote_storm:
            if self._remote_cooldown_left == 0:
                self.remote_trips += 1
            self._remote_cooldown_left = self.cooldown
        if burst or (storm and (throttling or not remote_storm)):
            if self._cooldown_left == 0:
                self.trips += 1
            self._cooldown_left = self.cooldown

    # -- checkpoint surface (repro.spec.BreakerStateSpec) --------------------
    def breaker_state(self) -> dict[str, int]:
        """The warm state a checkpoint must carry to resume mid-cooldown:
        remaining cooldown windows plus the episode counters."""
        return {"cooldown_left": self._cooldown_left,
                "remote_cooldown_left": self._remote_cooldown_left,
                "trips": self.trips, "remote_trips": self.remote_trips}

    def seed_state(self, cooldown_left: int = 0, remote_cooldown_left: int = 0,
                   trips: int = 0, remote_trips: int = 0) -> None:
        """Restore ``breaker_state`` output onto a fresh breaker."""
        self._cooldown_left = int(cooldown_left)
        self._remote_cooldown_left = int(remote_cooldown_left)
        self.trips = int(trips)
        self.remote_trips = int(remote_trips)


_GREEDY = GreedySteal()
