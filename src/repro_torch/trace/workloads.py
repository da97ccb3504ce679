"""Composable, reproducible workload generators for the runtime.

A workload is a finite stream of ``Arrival(step, home, cost)`` records —
which task arrives at which scheduling round, homed on which locality
domain, with what abstract service cost.  Everything is derived from an
explicit seed, so the *same* arrival sequence can be driven through
different steal policies (the paper's apples-to-apples policy comparison)
or recorded once and replayed forever.

Arrival processes (production-like shapes, not just the benchmark's
hand-rolled waves):

  ``poisson``   — steady traffic: per-step arrival counts ~ Poisson(rate).
  ``bursty``    — a two-state Markov-modulated Poisson process (MMPP):
                  a hidden quiet/storm state with sticky transitions
                  modulates the rate, giving synchronized bursts separated
                  by lulls (the steal-storm trigger).
  ``diurnal``   — a sinusoidal day/night rate profile over the horizon
                  (capacity is provisioned for the peak; the trough is
                  where locality-oblivious stealing looks free but isn't).

Combinators reshape an existing stream without touching its clock:

  ``hot_skew``       — re-home a fraction of tasks onto one hot domain
                       (the paper's "one socket owns the data" pathology).
  ``lognormal_costs``— heavy-tailed service costs (long prefills).

``standard_scenarios`` bundles the canonical set used by the benchmarks;
``drive`` runs any workload through an executor with one scheduling round
per arrival step (arrivals overlap service, the online regime).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..runtime import Executor


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One task arrival: at scheduling round ``step``, homed on ``home``."""

    step: int
    home: int
    cost: float = 1.0


@dataclasses.dataclass(frozen=True)
class Workload:
    """A named, finite, reproducible arrival stream.

    ``tail_steps`` appends that many arrival-free scheduling rounds after
    the last arrival (the cadence a load generator keeps after its final
    burst); ``drive`` steps through them before draining, so idle-poll
    accounting is part of the workload's definition, not the drive loop's.
    """

    name: str
    num_domains: int
    arrivals: tuple[Arrival, ...]
    tail_steps: int = 0

    @property
    def n_tasks(self) -> int:
        return len(self.arrivals)

    @property
    def horizon(self) -> int:
        """Last arrival step + 1 (the drive loop's minimum round count)."""
        return max((a.step for a in self.arrivals), default=-1) + 1

    def by_step(self) -> dict[int, list[Arrival]]:
        out: dict[int, list[Arrival]] = {}
        for a in self.arrivals:
            out.setdefault(a.step, []).append(a)
        return out


def _homes(rng: np.random.Generator, n: int, num_domains: int) -> np.ndarray:
    return rng.integers(0, num_domains, n)


def _from_counts(name: str, counts: np.ndarray, num_domains: int,
                 rng: np.random.Generator, cost: float) -> Workload:
    arrivals = []
    for step, k in enumerate(int(c) for c in counts):
        for home in _homes(rng, k, num_domains):
            arrivals.append(Arrival(step=step, home=int(home), cost=cost))
    return Workload(name, num_domains, tuple(arrivals))


def poisson(rate: float, steps: int, num_domains: int, seed: int = 0,
            cost: float = 1.0) -> Workload:
    """Steady traffic: arrivals per step ~ Poisson(``rate``), homes uniform."""
    rng = np.random.default_rng(seed)
    return _from_counts(f"poisson(rate={rate:g})",
                        rng.poisson(rate, steps), num_domains, rng, cost)


def bursty(rate_quiet: float, rate_storm: float, steps: int,
           num_domains: int, seed: int = 0, p_enter: float = 0.08,
           p_exit: float = 0.25, cost: float = 1.0) -> Workload:
    """Two-state MMPP: quiet ↔ storm with sticky transitions.

    ``p_enter``/``p_exit`` are the per-step probabilities of switching into/
    out of the storm state, giving geometric burst lengths of mean
    ``1/p_exit`` steps at rate ``rate_storm``.
    """
    rng = np.random.default_rng(seed)
    counts = np.empty(steps, dtype=np.int64)
    storming = False
    for t in range(steps):
        flip = rng.random()
        storming = (flip >= p_exit) if storming else (flip < p_enter)
        counts[t] = rng.poisson(rate_storm if storming else rate_quiet)
    return _from_counts(
        f"bursty(q={rate_quiet:g},s={rate_storm:g})", counts,
        num_domains, rng, cost)


def diurnal(peak_rate: float, steps: int, num_domains: int, seed: int = 0,
            trough_frac: float = 0.1, periods: float = 1.0,
            cost: float = 1.0) -> Workload:
    """Sinusoidal day/night ramp: rate sweeps trough → peak → trough over
    ``periods`` full cycles across the horizon."""
    rng = np.random.default_rng(seed)
    trough = peak_rate * trough_frac
    t = np.arange(steps)
    phase = 2.0 * math.pi * periods * t / max(steps, 1)
    rates = trough + (peak_rate - trough) * 0.5 * (1.0 - np.cos(phase))
    return _from_counts(f"diurnal(peak={peak_rate:g})",
                        rng.poisson(rates), num_domains, rng, cost)


def hot_skew(workload: Workload, hot_domain: int = 0, p_hot: float = 0.8,
             seed: int = 0) -> Workload:
    """Re-home a ``p_hot`` fraction of arrivals onto ``hot_domain``."""
    rng = np.random.default_rng(seed)
    hot = rng.random(workload.n_tasks) < p_hot
    arrivals = tuple(
        dataclasses.replace(a, home=hot_domain) if h else a
        for a, h in zip(workload.arrivals, hot))
    return dataclasses.replace(
        workload, name=f"{workload.name}+hot{hot_domain}@{p_hot:g}",
        arrivals=arrivals)


def lognormal_costs(workload: Workload, median: float = 1.0,
                    sigma: float = 0.75, seed: int = 0) -> Workload:
    """Heavy-tailed service costs: cost ~ LogNormal(ln median, sigma)."""
    rng = np.random.default_rng(seed)
    costs = rng.lognormal(math.log(median), sigma, workload.n_tasks)
    arrivals = tuple(dataclasses.replace(a, cost=float(c))
                     for a, c in zip(workload.arrivals, costs))
    return dataclasses.replace(
        workload, name=f"{workload.name}+lncost", arrivals=arrivals)


def benchmark_waves(n_tasks: int, num_domains: int = 4,
                    seed: int = 0) -> dict[str, Workload]:
    """The online-runtime benchmark's hand-rolled wave scenarios as
    ``Workload`` values (``benchmarks.runtime_throughput``'s historical
    arrival construction, preserved arrival-for-arrival):

      ``uniform`` — homes uniform over domains, 8 arrivals per round.
      ``bursty``  — synchronized 64-task waves separated by 6 idle rounds
                    (``tail_steps`` keeps the trailing idle rounds).
      ``skewed``  — 80% of tasks homed on domain 0, 8 per round.

    All three draw from one shared RNG stream in this order — that coupling
    is part of the recorded benchmark numbers, so it is reproduced here
    rather than cleaned up.
    """
    rng = np.random.default_rng(seed)

    def batched(name: str, homes: np.ndarray, per_round: int) -> Workload:
        arrivals = tuple(Arrival(step=i // per_round, home=int(h))
                         for i, h in enumerate(homes))
        return Workload(name, num_domains, arrivals)

    uniform = batched("uniform_waves", rng.integers(0, num_domains, n_tasks), 8)
    burst_homes = rng.integers(0, num_domains, n_tasks)
    bursts = tuple(Arrival(step=(i // 64) * 7, home=int(h))
                   for i, h in enumerate(burst_homes))
    bursty_wl = Workload("bursty_waves", num_domains, bursts, tail_steps=6)
    hot = rng.random(n_tasks) < 0.8
    skew_homes = np.where(hot, 0, rng.integers(0, num_domains, n_tasks))
    skewed = batched("skewed_waves", skew_homes, 8)
    return {"uniform": uniform, "bursty": bursty_wl, "skewed": skewed}


def standard_scenarios(num_domains: int = 4, steps: int = 48,
                       seed: int = 0) -> dict[str, Workload]:
    """The canonical scenario set the benchmarks compare policies across.

    Rates are scaled so each scenario offers roughly ``num_domains`` tasks
    per scheduling round at its busy points — enough pressure that steal
    decisions matter, not so much that every policy degenerates to a
    saturated queue.
    """
    d = num_domains
    return {
        "poisson": poisson(rate=d, steps=steps, num_domains=d, seed=seed),
        "bursty": bursty(rate_quiet=d * 0.25, rate_storm=d * 3.0,
                         steps=steps, num_domains=d, seed=seed + 1),
        "diurnal": diurnal(peak_rate=d * 2.0, steps=steps, num_domains=d,
                           seed=seed + 2),
        "hot_skew": hot_skew(
            poisson(rate=d, steps=steps, num_domains=d, seed=seed + 3),
            hot_domain=0, p_hot=0.8, seed=seed + 3),
    }


def drive(executor: Executor, workload: Workload,
          payload=None, drain_budget: int | None = None) -> Executor:
    """Run ``workload`` through ``executor``: submit each step's arrivals,
    take one scheduling round, repeat (through any ``tail_steps``); then
    drain.  Returns the executor (stats/events on it).  Arrivals land at
    exactly ``Arrival.step`` on the executor's step clock, so a recorded
    trace of this drive replays on the same clock.

    ``drain_budget`` caps the post-arrival drain at that many extra
    scheduling rounds; exceeding it raises ``RuntimeError`` (the guard a
    declarative experiment wants against a policy that cannot drain its
    workload).  Within the budget the run is bit-identical to the unbounded
    default."""
    by_step = workload.by_step()
    for t in range(workload.horizon + workload.tail_steps):
        for a in by_step.get(t, ()):
            executor.submit(executor.make_task(
                payload=payload, home=a.home, cost=a.cost))
        executor.step()
    if drain_budget is None:
        executor.run_until_drained()
    else:
        for _ in range(drain_budget):
            if not len(executor.queues):
                break
            executor.step()
        if len(executor.queues):
            raise RuntimeError(
                f"workload {workload.name!r} not drained within "
                f"drain_budget={drain_budget} extra rounds "
                f"({len(executor.queues)} tasks still queued)")
        executor.results.clear()       # parity with run_until_drained, whose
        # returned results this drive loop likewise discards
    return executor
