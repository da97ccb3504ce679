"""Scheduling policies of the paper, as pluggable simulator drivers.

The queue and pool machinery (per-LD FIFO queues, the cyclic steal scan,
the bounded submission pool) lives in ``repro.runtime``; these policies
are thin offline drivers that feed those primitives from the
discrete-event simulator.

Every policy answers two questions for the discrete-event simulator:
  * submitter side — does a single thread feed a bounded task pool
    (OpenMP tasking semantics, §2.1), and what does one ``submit_one`` do?
  * consumer side — given an idle thread (and its locality domain), which
    block does it execute next?

Policies implemented (Fig. 3 columns, left to right):
  StaticWorksharing          — OpenMP ``parallel for`` with static chunks
                               (the three reference lines, combined with the
                               placement policies).
  OpenMPTasking              — plain tasking: single submitter, bounded pool
                               (~256 tasks, §2.1), FIFO consumption.
  OpenMPLocalityQueues       — the paper's contribution (§2.2): submitter
                               enqueues blocks into per-LD locality queues and
                               submits one generic pool task per block;
                               consumers serve their own LD's queue first and
                               steal otherwise.
  TBBParallelFor             — TBB baseline: fully dynamic (random-steal)
                               consumption, no pool cap; with
                               ``affinity_partitioner`` each thread replays
                               the ranges it first-touched.
  TBBLocalityQueues          — §3.2: locality queues on top of TBB; block
                               availability is uncontrolled (no submission
                               order), queues are served local-first.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

from ..runtime.queues import DomainQueues, SubmissionPool
from .tasks import BlockGrid
from .topology import MachineTopology


@dataclasses.dataclass
class PopResult:
    block: int
    stolen: bool = False


class Policy:
    """Base class; see module docstring for the contract."""

    uses_submitter: bool = False
    name: str = "policy"

    def reset(self, grid: BlockGrid, homes: np.ndarray, topo: MachineTopology,
              thread_ld: np.ndarray, rng: np.random.Generator) -> None:
        raise NotImplementedError

    # -- submitter side ----------------------------------------------------
    def has_unsubmitted(self) -> bool:
        return False

    def pool_size(self) -> int:
        return 0

    def submit_one(self) -> None:
        raise NotImplementedError

    # -- consumer side -----------------------------------------------------
    def pop(self, thread: int) -> Optional[PopResult]:
        raise NotImplementedError


class StaticWorksharing(Policy):
    """OpenMP ``parallel for schedule(static)`` over the collapsed block loops.

    Thread t executes its contiguous chunk in order; no stealing (OpenMP
    static has no balancing), threads idle at the implicit barrier.
    """

    name = "static_workshare"

    def reset(self, grid, homes, topo, thread_ld, rng):
        seq = grid.submit_order("ijk")
        n, t = grid.num_blocks, topo.num_cores
        base, rem = divmod(n, t)
        self._lists: list[deque[int]] = []
        pos = 0
        for th in range(t):
            size = base + (1 if th < rem else 0)
            self._lists.append(deque(int(b) for b in seq[pos:pos + size]))
            pos += size

    def pop(self, thread):
        if self._lists[thread]:
            return PopResult(self._lists[thread].popleft())
        return None


class OpenMPTasking(Policy):
    """Plain OpenMP tasking: one submitter, bounded FIFO pool (§2.1)."""

    uses_submitter = True

    def __init__(self, submit_order: str = "ijk", pool_cap: int = 256):
        self.submit_order = submit_order
        self.pool_cap = pool_cap
        self.name = f"omp_task_{submit_order}"

    def reset(self, grid, homes, topo, thread_ld, rng):
        self._pending = deque(int(b) for b in grid.submit_order(self.submit_order))
        self._pool = SubmissionPool(self.pool_cap)

    def has_unsubmitted(self):
        return bool(self._pending)

    def pool_size(self):
        return len(self._pool)

    def submit_one(self):
        self._pool.push(self._pending.popleft())

    def pop(self, thread):
        blk = self._pool.pop()
        return None if blk is None else PopResult(blk)


class OpenMPLocalityQueues(Policy):
    """The paper's locality-queue layer on OpenMP tasking (§2.2)."""

    uses_submitter = True

    def __init__(self, submit_order: str = "ijk", pool_cap: int = 256):
        self.submit_order = submit_order
        self.pool_cap = pool_cap
        self.name = f"omp_lq_{submit_order}"

    def reset(self, grid, homes, topo, thread_ld, rng):
        self._pending = deque(int(b) for b in grid.submit_order(self.submit_order))
        self._homes = homes
        self._queues = DomainQueues(topo.num_domains, steal_order="cyclic")
        self._thread_ld = thread_ld

    def has_unsubmitted(self):
        return bool(self._pending)

    def pool_size(self):
        # One generic pool task per enqueued block (a task may run "ahead" of
        # its own submission, which the paper notes is harmless), so the pool
        # occupancy equals the queued-block count.
        return len(self._queues)

    def submit_one(self):
        blk = self._pending.popleft()
        self._queues.enqueue(blk, int(self._homes[blk]))

    def pop(self, thread):
        got = self._queues.dequeue(int(self._thread_ld[thread]))
        if got is None:
            return None
        return PopResult(got.item, stolen=got.stolen)


class TBBParallelFor(Policy):
    """TBB ``parallel_for`` (§3.1).

    Without the affinity partitioner, consumption is modelled as uniform
    random work stealing over the remaining blocks.  With it, each thread
    replays the blocks it first-touched (``replay`` = block→thread map from
    TBB-style dynamic initialization) and steals randomly when it runs dry.
    """

    def __init__(self, affinity: bool, replay: np.ndarray | None = None):
        self.affinity = affinity
        self.replay = replay
        self.name = f"tbb_{'a' if affinity else 'na'}"

    def reset(self, grid, homes, topo, thread_ld, rng):
        self._rng = rng
        n = grid.num_blocks
        if self.affinity:
            if self.replay is None:
                raise ValueError("affinity partitioner needs a replay map")
            self._lists = [deque() for _ in range(topo.num_cores)]
            for blk in range(n):
                self._lists[int(self.replay[blk])].append(blk)
        else:
            order = rng.permutation(n)
            self._shared = deque(int(b) for b in order)

    def pop(self, thread):
        if self.affinity:
            if self._lists[thread]:
                return PopResult(self._lists[thread].popleft())
            victims = [i for i, l in enumerate(self._lists) if l]
            if not victims:
                return None
            v = victims[int(self._rng.integers(len(victims)))]
            return PopResult(self._lists[v].popleft(), stolen=True)
        if self._shared:
            return PopResult(self._shared.popleft())
        return None


class TBBLocalityQueues(Policy):
    """Locality queues on top of TBB (§3.2): no submission-order control —
    all blocks are available from the start, sorted into per-LD queues."""

    name = "tbb_lq"

    def reset(self, grid, homes, topo, thread_ld, rng):
        self._queues = DomainQueues(topo.num_domains, steal_order="cyclic")
        order = rng.permutation(grid.num_blocks)   # uncontrolled availability
        for blk in order:
            self._queues.enqueue(int(blk), int(homes[blk]))
        self._thread_ld = thread_ld

    def pop(self, thread):
        got = self._queues.dequeue(int(self._thread_ld[thread]))
        if got is None:
            return None
        return PopResult(got.item, stolen=got.stolen)


def tbb_first_touch(grid: BlockGrid, topo: MachineTopology,
                    rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """TBB-style dynamic first touch: blocks are initialized by whichever
    thread stole the range — balanced but effectively random (§3.1: "page
    mapping is dynamic").  Returns (ld_home, init_thread)."""
    n, t = grid.num_blocks, topo.num_cores
    threads = np.repeat(np.arange(t), -(-n // t))[:n]
    rng.shuffle(threads)
    homes = np.array([topo.domain_of_core(int(th)) for th in threads])
    return homes, threads
