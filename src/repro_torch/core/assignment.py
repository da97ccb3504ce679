"""Locality-constrained static schedule builder for SPMD execution.

This is the paper's locality-queue idea moved to where a TPU system can use
it: XLA's SPMD model fixes the work→device assignment at compile/launch time,
so the "static part between domains / dynamic part within" split (paper §4)
becomes an ahead-of-time assignment problem:

  * start from pure locality: every task goes to its home domain's list
    (= the locality queue);
  * while the load imbalance exceeds a bound, move tasks from the most
    loaded to the least loaded domain (= bounded work stealing), choosing
    the cheapest-to-move tasks first — load balance is given priority over
    strict locality, exactly the paper's §2.2 policy.

The resulting per-domain lists drive: stencil block→device assignment,
host-side data-pipeline shard reading, the serving router's replica lists,
and the elastic re-mesh path (a device loss is just a re-assignment with one
fewer domain).
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np


@dataclasses.dataclass
class Assignment:
    """Per-domain ordered task lists plus quality metrics."""

    lists: list[list[int]]
    loads: np.ndarray            # per-domain total cost
    locality_fraction: float     # fraction of total cost kept in home domain
    imbalance: float             # max_load / mean_load - 1
    moved: int                   # number of tasks stolen from their home

    @property
    def num_domains(self) -> int:
        return len(self.lists)


def build_assignment(home: np.ndarray, cost: np.ndarray, num_domains: int,
                     max_imbalance: float = 0.02,
                     remote_penalty: float = 0.0) -> Assignment:
    """Assign tasks to domains: locality first, bounded stealing for balance.

    Args:
      home: (n,) home domain per task (-1 = no affinity, assign freely).
      cost: (n,) per-task cost (e.g. bytes or FLOPs).
      num_domains: number of locality domains (devices/pods/hosts).
      max_imbalance: stop stealing once max/mean - 1 <= this bound.
      remote_penalty: multiplier added to a task's cost when it executes
        away from home (models the nonlocal-access slowdown); stealing
        accounts for it when picking which task to move.

    Returns an Assignment; every task appears in exactly one list.
    """
    n = len(home)
    home = np.asarray(home, dtype=np.int64)
    cost = np.asarray(cost, dtype=np.float64)
    if len(cost) != n:
        raise ValueError("home and cost must have the same length")
    if (home >= num_domains).any():
        raise ValueError("home domain out of range")

    lists: list[list[int]] = [[] for _ in range(num_domains)]
    loads = np.zeros(num_domains)

    # 1. locality placement (+ greedy least-loaded for unaffiliated tasks)
    free = np.flatnonzero(home < 0)
    for t in np.flatnonzero(home >= 0):
        lists[home[t]].append(int(t))
        loads[home[t]] += cost[t]
    if len(free):
        # largest-first onto least-loaded domain (LPT)
        order = free[np.argsort(-cost[free])]
        heap = [(loads[d], d) for d in range(num_domains)]
        heapq.heapify(heap)
        for t in order:
            load, d = heapq.heappop(heap)
            lists[d].append(int(t))
            loads[d] += cost[t]
            heapq.heappush(heap, (loads[d], d))

    total = float(cost.sum())
    mean = total / num_domains if num_domains else 0.0
    moved = 0

    # 2. bounded stealing: move smallest tasks from max- to min-loaded domain.
    #    Moving small tasks first keeps the locality loss per unit of balance
    #    gained minimal (the steal's remote_penalty is charged to the thief).
    if total > 0:
        # per-domain heaps of (cost, task) for cheap-to-move selection
        heaps = [[(cost[t], t) for t in lst] for lst in lists]
        for h in heaps:
            heapq.heapify(h)
        guard = 0
        while True:
            guard += 1
            if guard > 10 * n + 100:
                break
            src = int(np.argmax(loads))
            dst = int(np.argmin(loads))
            if loads[src] <= mean * (1 + max_imbalance) or src == dst:
                break
            if not heaps[src]:
                break
            c, t = heapq.heappop(heaps[src])
            # don't overshoot: stealing must reduce the max load
            eff = c * (1 + remote_penalty)
            if loads[dst] + eff >= loads[src]:
                heapq.heappush(heaps[src], (c, t))
                break
            lists[src].remove(t)
            lists[dst].append(t)
            loads[src] -= c
            loads[dst] += eff
            heapq.heappush(heaps[dst], (eff, t))
            moved += 1

    kept = sum(cost[t] for d, lst in enumerate(lists) for t in lst
               if home[t] == d or home[t] < 0)
    return Assignment(
        lists=lists,
        loads=loads,
        locality_fraction=min(float(kept / total), 1.0) if total > 0 else 1.0,
        imbalance=float(loads.max() / mean - 1.0) if mean > 0 else 0.0,
        moved=moved,
    )


def round_robin_assignment(n_tasks: int, cost: np.ndarray,
                           num_domains: int) -> Assignment:
    """Locality-oblivious baseline (the paper's dynamic-scheduling stand-in
    for SPMD): task i -> domain i mod D."""
    home = np.arange(n_tasks) % num_domains
    lists = [[int(t) for t in np.flatnonzero(home == d)]
             for d in range(num_domains)]
    loads = np.array([sum(cost[t] for t in lst) for lst in lists])
    mean = loads.mean() if num_domains else 0.0
    return Assignment(lists=lists, loads=loads, locality_fraction=0.0,
                      imbalance=float(loads.max() / mean - 1.0) if mean > 0 else 0.0,
                      moved=0)
