"""Canonical queue primitives of the locality-queue runtime.

``DomainQueues`` is the single implementation of the paper's §2.2 data
structure in this repo: one FIFO queue per locality domain, local-first
dequeue, and a steal scan over foreign queues when the local queue is dry
(balance deliberately wins over locality).  Both the offline simulator
policies (`repro.core.scheduler`) and the online serving router
(`repro.serving.engine`) route through this class — there is no second
copy of the steal-scan logic anywhere.

Four steal scans are supported:

  ``cyclic``        — the paper's scan: victims visited in domain order
                      starting right after the caller's own domain (§2.2).
  ``longest``       — steal from the deepest foreign queue (the serving
                      router's balance-first variant; ties break on lowest
                      domain id).
  ``random``        — uniform random victim among eligible queues (models
                      TBB's random stealing, §3.1); requires an ``rng``.
  ``cost_weighted`` — steal from the foreign queue holding the most queued
                      *cost* (sum of item ``cost`` attributes, 1.0 when
                      absent; ties break on lowest domain id).  With
                      heavy-tailed service costs a short queue can hide the
                      biggest backlog; this scan relieves the domain with
                      the most queued *work*, not the most queued *items*
                      (the ``repro.control`` cost-aware victim selection).

With a hierarchical ``repro.topology.DistanceMatrix`` attached, every scan
becomes *nearest-first*: victims are sought level by level (same socket,
then cross socket, then cross pod) and the configured order applies only
*within* a level — the paper's dynamic-scheduling-inside-a-domain invariant
is preserved per tier, while a worker never pays a deep-link steal when a
sibling still has eligible work.  ``min_victim`` may then be a per-level
sequence (the adaptive governor's per-level θ; a ``None`` entry forbids
that tier outright).  A flat (or absent) topology takes the original
single-tier code path untouched, RNG draws and all — flat runs are
bit-identical to the pre-topology runtime.

Queued cost is tracked per domain (``cost`` / ``queue_costs``), so
cost-aware routing and victim selection are O(domains) reads, never a
queue walk.  The cost of each item is **snapshotted at enqueue** right
next to the item (each queue slot is an ``(item, cost)`` pair) and that
same snapshot is subtracted at dequeue — mutating a task's ``cost``
attribute while it sits queued (e.g. measured-penalty repricing) can
therefore never drift the account.  An emptied queue's
cost returns to exactly 0.0 whenever the snapshot arithmetic is exact
(integral / dyadic costs — every committed workload); adversarial float
costs can leave a ±ulp residue, which is the accounting being honest, not
drifting.

Victim selection has two implementations, selected by the ``fast`` flag:

  ``fast=True``  (default) — incrementally-maintained eligibility
      structures: a nonempty-domain bitmask (empty↔nonempty transitions
      are one ``|=``/``&=``; the cyclic successor is two's-complement bit
      arithmetic — O(d/64) word ops in C, no Python loop), lazy max-heaps
      keyed on depth / queued cost (``longest`` / ``cost_weighted``
      selection is amortized O(log d)), and per-level nonempty-peer
      counters that let the hierarchical scan skip whole tiers in O(1).
  ``fast=False`` — the pre-rewrite O(domains) linear scans, kept verbatim
      as the executable specification.

The two paths are **bit-identical**: same victim, same visit order, and
the same RNG draw sequence (``random`` draws once over the identical
ascending eligible list, and draws nothing when no victim is eligible).
``benchmarks.scheduler_overhead``'s ``fast_vs_slow`` block and the
hypothesis property in ``tests/test_runtime.py`` hold the paths to that
contract.

``SubmissionPool`` captures the other half of the paper's machinery: the
bounded FIFO pool of submitted-but-unconsumed tasks of OpenMP tasking
(§2.1, "the limit is set to roughly 256 tasks").  The cap is advisory —
callers consult ``full``/``free_slots`` and apply backpressure themselves
(the simulator has its submitter run a task when full; the online
``Executor`` does the same inline).
"""
from __future__ import annotations

from collections import deque
from heapq import heapify, heappop, heappush
from typing import Any, NamedTuple, Optional, Sequence, Union

import numpy as np

MinVictim = Union[int, Sequence[Optional[int]]]


class Popped(NamedTuple):
    """Result of a ``DomainQueues.dequeue``.

    ``level``/``distance`` locate the steal in the topology: 0/0.0 for a
    local pop, the victim's tier and link cost for a steal (1/1.0 when no
    topology is attached — the flat machine's uniform hop).

    A ``NamedTuple`` rather than a frozen dataclass: one ``Popped`` is
    built per executed task, and tuple construction keeps that off the
    scheduler's critical path (``BENCH_overhead.json`` steal_scan).
    """

    item: Any
    domain: int        # queue the item came from
    stolen: bool       # True when it came from a foreign queue
    level: int = 0     # topology tier of the steal (0 = local)
    distance: float = 0.0   # link cost scale of the steal (0.0 = local)


# the local-pop hot path builds Popped through C-level tuple.__new__;
# the generated namedtuple __new__ is a Python frame per executed task
_tuple_new = tuple.__new__


class DomainQueues:
    """Per-domain FIFO queues with a local-first dequeue and a steal scan."""

    STEAL_ORDERS = ("cyclic", "longest", "random", "cost_weighted")

    def __init__(self, num_domains: int, steal_order: str = "cyclic",
                 rng: np.random.Generator | None = None,
                 topology=None, fast: bool = True):
        if num_domains < 1:
            raise ValueError("need at least one domain")
        if steal_order not in self.STEAL_ORDERS:
            raise ValueError(f"unknown steal order {steal_order!r} "
                             f"(want one of {self.STEAL_ORDERS})")
        if steal_order == "random" and rng is None:
            raise ValueError("steal_order='random' needs an rng")
        if topology is not None and topology.num_domains != num_domains:
            raise ValueError(
                f"topology covers {topology.num_domains} domains, "
                f"queues have {num_domains}")
        self.num_domains = num_domains
        self.steal_order = steal_order
        self.topology = topology
        self.fast = fast
        self._rng = rng
        # each slot is an (item, cost) pair: the enqueue-time cost snapshot
        # travels with the item (the drift fix), and the fused layout costs
        # one popleft per pop instead of two on the scheduler's hot path
        self._queues: list[deque[tuple[Any, float]]] = [
            deque() for _ in range(num_domains)]
        self._costs: list[float] = [0.0] * num_domains
        self._size = 0
        # -- fast-path eligibility structures ------------------------------
        # (queue depth itself is never duplicated: ``len(deque)`` is O(1),
        # so a shadow depth array would be pure per-pop maintenance cost)
        self._hier = (fast and topology is not None and topology.hierarchical)
        self._ne_mask = 0                # bit d set <=> domain d nonempty
        # lazy max-heap of (-depth, d) / (-cost, d); entries go stale when
        # the domain's state moves on and are discarded at query time
        self._order_heap: Optional[list[tuple[float, int]]] = None
        if fast and not self._hier and steal_order in ("longest",
                                                       "cost_weighted"):
            self._order_heap = []
        self._heap_limit = max(64, 8 * num_domains)
        # per-level nonempty-peer counters: _lvl_nonempty[a][lv-1] counts
        # nonempty domains at tier lv from a's viewpoint, so the nearest-
        # first scan can skip a whole tier in O(1)
        self._lvl_nonempty: Optional[list[list[int]]] = None
        if self._hier:
            self._lvl_nonempty = [[0] * topology.num_levels
                                  for _ in range(num_domains)]

    @staticmethod
    def _item_cost(item: Any) -> float:
        return float(getattr(item, "cost", 1.0))

    # -- fast-path maintenance ---------------------------------------------
    def _heap_push(self, key: float, domain: int) -> None:
        heap = self._order_heap
        if len(heap) >= self._heap_limit:
            # compaction: rebuild from current state so the heap stays
            # O(domains) even on steal-free runs that never drain it
            self._rebuild_heap()
            heap = self._order_heap
        heappush(heap, (key, domain))

    def _rebuild_heap(self) -> None:
        if self.steal_order == "longest":
            heap = [(-len(self._queues[d]), d) for d in self._mask_domains()]
        else:
            heap = [(-self._costs[d], d) for d in self._mask_domains()]
        heapify(heap)
        self._order_heap = heap

    def _mask_domains(self) -> list[int]:
        """The nonempty-domain bitmask decoded to ascending domain ids."""
        m = self._ne_mask
        out = []
        while m:
            b = m & -m                   # lowest set bit
            out.append(b.bit_length() - 1)
            m ^= b
        return out

    def _lvl_shift(self, domain: int, delta: int) -> None:
        """Shift every peer's nonempty-at-tier counter when ``domain``
        crosses the empty↔nonempty boundary (hierarchical fast path)."""
        lvl = self._lvl_nonempty
        topo = self.topology
        for a in range(self.num_domains):
            if a != domain:
                lvl[a][topo.level(a, domain) - 1] += delta

    # -- producer side -----------------------------------------------------
    def enqueue(self, item: Any, domain: int) -> None:
        cost = float(getattr(item, "cost", 1.0))   # snapshot at enqueue
        q = self._queues[domain]
        q.append((item, cost))
        self._costs[domain] += cost
        self._size += 1
        if self.fast:
            if len(q) == 1:
                self._ne_mask |= 1 << domain
                if self._lvl_nonempty is not None:
                    self._lvl_shift(domain, 1)
            if self._order_heap is not None:
                if self.steal_order == "longest":
                    self._heap_push(-len(q), domain)
                else:
                    self._heap_push(-self._costs[domain], domain)

    # -- consumer side -----------------------------------------------------
    def dequeue(self, domain: int, allow_steal: bool = True,
                min_victim: MinVictim = 1) -> Optional[Popped]:
        """Pop the oldest local item; steal from a foreign queue otherwise.

        ``min_victim`` throttles stealing: only victims holding at least
        that many items are eligible (1 = the paper's greedy behaviour;
        larger values are the adaptive governor's depth threshold).  With a
        hierarchical topology it may be a per-level sequence — entry
        ``level-1`` gates that tier, ``None`` forbids it (the breaker's
        remote cut); a short sequence extends with its last entry.
        """
        q = self._queues[domain]
        if q:
            # local pop, ``_pop`` inlined: the single hottest line in the
            # scheduler (BENCH_overhead.json steal_scan) — one call frame
            # per executed task is worth the duplication
            item, cost = q.popleft()
            self._costs[domain] -= cost
            self._size -= 1
            if self.fast:
                if not q:
                    self._ne_mask &= ~(1 << domain)
                    if self._lvl_nonempty is not None:
                        self._lvl_shift(domain, -1)
                elif self._order_heap is not None:
                    if self.steal_order == "longest":
                        self._heap_push(-len(q), domain)
                    else:
                        self._heap_push(-self._costs[domain], domain)
            # C-level tuple.__new__: the namedtuple's keyword/default
            # __new__ costs ~200ns more per executed task
            return _tuple_new(Popped, (item, domain, False, 0, 0.0))
        if not allow_steal:
            return None
        if self.fast and not self._ne_mask:
            return None     # machine-wide empty: no victim anywhere
        victim = self._pick_victim(domain, min_victim)
        if victim is None:
            return None
        topo = self.topology
        if topo is None:
            level, dist = 1, 1.0
        else:
            level, dist = topo.level(domain, victim), topo.distance(domain,
                                                                    victim)
        return Popped(self._pop(victim), victim, True, level, dist)

    def _pop(self, domain: int) -> Any:
        q = self._queues[domain]
        # subtract the enqueue-time snapshot, never the item's live cost: a
        # queued task whose ``cost`` mutated in the meantime must not drift
        # the account (the old live-cost subtraction needed a re-zero-on-
        # empty mask to hide exactly that drift; both are gone)
        item, cost = q.popleft()
        self._costs[domain] -= cost
        self._size -= 1
        if self.fast:
            if not q:
                self._ne_mask &= ~(1 << domain)
                if self._lvl_nonempty is not None:
                    self._lvl_shift(domain, -1)
            elif self._order_heap is not None:
                if self.steal_order == "longest":
                    self._heap_push(-len(q), domain)
                else:
                    self._heap_push(-self._costs[domain], domain)
        return item

    def drain(self, domain: int, n: int, budget: Optional[float] = None,
              spent: float = 0.0) -> list[Any]:
        """Pop up to ``n`` more items from ``domain``'s queue, FIFO, no steal
        scan — the executor's batch-grab primitive: after a dequeue picked a
        source queue, the rest of the batch is taken from the *same* queue so
        a batch never mixes locality domains.

        ``budget`` bounds the grab by *cost*, not just count: draining stops
        before an item that would push ``spent`` (cost already in the batch)
        past the budget.  The cost consulted is the enqueue-time snapshot —
        the same number the queue's cost account carries — so a drain's
        budget arithmetic always matches ``cost()``/``queue_costs()``.  That
        is the token-budget form of continuous batching — a grab of cheap
        items runs wide, one expensive item fills the whole budget alone —
        and is what makes a queue's total cost an honest estimate of its
        drain *time*.
        """
        out = []
        q = self._queues[domain]
        while n > 0 and q:
            if budget is not None:
                nxt = q[0][1]     # the head item's enqueue-time snapshot
                if spent + nxt > budget:
                    break
                spent += nxt
            out.append(self._pop(domain))
            n -= 1
        return out

    @staticmethod
    def _level_min(min_victim: MinVictim, level: int) -> Optional[int]:
        """The depth threshold gating ``level`` (1-based): scalar thresholds
        apply to every tier; sequences index ``level - 1`` and extend with
        their last entry.  ``None`` forbids the tier."""
        if min_victim is None or isinstance(min_victim, int):
            return min_victim
        if not len(min_victim):
            return None
        return min_victim[min(level - 1, len(min_victim) - 1)]

    def _pick_victim(self, domain: int, min_victim: MinVictim) -> Optional[int]:
        topo = self.topology
        if topo is not None and topo.hierarchical:
            return self._pick_victim_nearest(domain, min_victim, topo)
        mv = self._level_min(min_victim, 1)
        if mv is None:
            return None
        mv = max(mv, 1)
        if self.fast:
            return self._pick_victim_flat_fast(domain, mv)
        return self._pick_victim_flat_reference(domain, mv)

    # -- reference (pre-rewrite) scans --------------------------------------
    def _pick_victim_flat_reference(self, domain: int,
                                    mv: int) -> Optional[int]:
        """The original single-tier O(domains) scan, kept verbatim: the
        executable specification the fast path is equivalence-gated
        against — same visit order and the same RNG draw sequence."""
        if self.steal_order == "cyclic":
            for off in range(1, self.num_domains):
                d = (domain + off) % self.num_domains
                if len(self._queues[d]) >= mv:
                    return d
            return None
        eligible = [d for d in range(self.num_domains)
                    if d != domain and len(self._queues[d]) >= mv]
        if not eligible:
            return None
        return self._pick_eligible(eligible)

    # -- fast flat scans ----------------------------------------------------
    def _pick_victim_flat_fast(self, domain: int, mv: int) -> Optional[int]:
        m = self._ne_mask
        if not m:
            return None
        order = self.steal_order
        if order == "cyclic":
            # first set bit after the caller's, wrapping — exactly the
            # first hit of the reference (domain+1 .. domain-1) visit
            # order, found by two's-complement bit tricks instead of a
            # Python loop (``x & -x`` isolates the lowest set bit)
            m &= ~(1 << domain)          # never self-steal
            higher = m >> (domain + 1)
            if mv == 1:
                if higher:
                    return domain + 1 + (higher & -higher).bit_length() - 1
                if m:
                    return (m & -m).bit_length() - 1
                return None
            qs = self._queues
            base = domain + 1
            while higher:
                b = higher & -higher
                d = base + b.bit_length() - 1
                if len(qs[d]) >= mv:
                    return d
                higher ^= b
            lower = m & ((1 << domain) - 1)
            while lower:
                b = lower & -lower
                d = b.bit_length() - 1
                if len(qs[d]) >= mv:
                    return d
                lower ^= b
            return None
        if order == "random":
            # identical ascending eligible list -> identical single draw
            # (and no draw at all when nothing is eligible)
            qs = self._queues
            if mv == 1:
                eligible = [d for d in self._mask_domains() if d != domain]
            else:
                eligible = [d for d in self._mask_domains()
                            if d != domain and len(qs[d]) >= mv]
            if not eligible:
                return None
            return int(eligible[int(self._rng.integers(len(eligible)))])
        if order == "longest":
            return self._pick_deepest(domain, mv)
        return self._pick_costliest(domain, mv)

    def _pick_deepest(self, domain: int, mv: int) -> Optional[int]:
        """Lazy-heap form of ``max(eligible, key=(depth, -d))``: every depth
        change pushed ``(-depth, d)``, so the shallowest key whose entry
        still matches the live depth is the true maximum (heap order breaks
        depth ties on lowest domain id, same as the reference)."""
        heap = self._order_heap
        qs = self._queues
        shelved: list[tuple[float, int]] = []
        found: Optional[int] = None
        while heap:
            negd, d = heap[0]
            if len(qs[d]) == -negd:
                if d != domain:
                    # top valid foreign entry is the true max depth; if even
                    # it misses the gate, nothing is eligible
                    found = d if -negd >= mv else None
                    break
                shelved.append(heappop(heap))  # caller's own, still valid
            else:
                heappop(heap)   # stale: discard
        for entry in shelved:
            heappush(heap, entry)
        return found

    def _pick_costliest(self, domain: int, mv: int) -> Optional[int]:
        """Lazy-heap form of ``max(eligible, key=(cost, -d))``.  Unlike
        depth, the deepest-cost domain may still fail the ``mv`` depth gate
        while a cheaper one passes, so valid-but-shallow entries are set
        aside and re-pushed after the search."""
        heap = self._order_heap
        qs = self._queues
        costs = self._costs
        shelved: list[tuple[float, int]] = []
        found: Optional[int] = None
        while heap:
            negc, d = heap[0]
            if len(qs[d]) >= 1 and costs[d] == -negc:
                if d != domain and len(qs[d]) >= mv:
                    found = d
                    break
                # valid but ineligible (too shallow, or the caller's own
                # domain): set aside so the heap invariant survives
                shelved.append(heappop(heap))
            else:
                heappop(heap)   # stale: discard
        for entry in shelved:
            heappush(heap, entry)
        return found

    def _pick_victim_nearest(self, domain: int, min_victim: MinVictim,
                             topo) -> Optional[int]:
        """Nearest-first scan: tiers visited in ascending distance order,
        the configured steal order applied only within a tier.  The fast
        path skips tiers whose nonempty-peer counter is zero (no peer could
        pass any depth gate); within a tier the reference selection runs
        unchanged, so visit order and RNG draws are preserved exactly."""
        lvl = self._lvl_nonempty
        for level in range(1, topo.num_levels + 1):
            if lvl is not None and not lvl[domain][level - 1]:
                continue
            mv = self._level_min(min_victim, level)
            if mv is None:
                continue
            mv = max(mv, 1)
            if self.steal_order == "cyclic":
                for d in topo.cyclic_peers(domain, level):
                    if len(self._queues[d]) >= mv:
                        return d
                continue
            eligible = [d for d in topo.peers(domain, level)
                        if len(self._queues[d]) >= mv]
            if eligible:
                return self._pick_eligible(eligible)
        return None

    def _pick_eligible(self, eligible: list[int]) -> int:
        """Resolve a non-cyclic steal order over an eligible-victim list (a
        single tier's, or the whole machine's when flat)."""
        if self.steal_order == "longest":
            return max(eligible, key=lambda d: (len(self._queues[d]), -d))
        if self.steal_order == "cost_weighted":
            return max(eligible, key=lambda d: (self._costs[d], -d))
        return int(eligible[int(self._rng.integers(len(eligible)))])

    # -- introspection -----------------------------------------------------
    def __len__(self) -> int:
        return self._size

    def queue_sizes(self) -> list[int]:
        return [len(q) for q in self._queues]

    def depth(self, domain: int) -> int:
        return len(self._queues[domain])

    def cost(self, domain: int) -> float:
        """Total queued cost in ``domain``'s queue (sum of enqueue-time
        cost snapshots; items without a ``cost`` attribute count 1.0)."""
        return self._costs[domain]

    def queue_costs(self) -> list[float]:
        return list(self._costs)


class SubmissionPool:
    """Bounded FIFO of submitted-but-unconsumed tasks (OpenMP §2.1).

    The cap is advisory: ``push`` never drops, but producers are expected
    to check ``full`` and switch to consuming (the paper's "the submitting
    thread is used for processing tasks for some time").
    """

    def __init__(self, cap: int = 256):
        if cap is None or cap < 1:
            raise ValueError(f"SubmissionPool cap must be >= 1, got {cap!r} "
                             "(cap=0 would make `full` permanently true)")
        self.cap = cap
        self._fifo: deque[Any] = deque()

    def push(self, item: Any) -> None:
        self._fifo.append(item)

    def pop(self) -> Optional[Any]:
        return self._fifo.popleft() if self._fifo else None

    def __len__(self) -> int:
        return len(self._fifo)

    @property
    def full(self) -> bool:
        return len(self._fifo) >= self.cap

    @property
    def free_slots(self) -> int:
        return max(self.cap - len(self._fifo), 0)
