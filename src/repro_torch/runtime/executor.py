"""The online locality-aware task executor.

``Executor`` is the generic, online form of the paper's scheduling layer:
tasks arrive dynamically (``submit``), are sorted into per-domain FIFO
queues by their locality tag, and a team of domain-pinned workers serves
them local-first with a pluggable steal scan and steal governor.  The
bounded submission pool reproduces OpenMP tasking semantics (§2.1): when
the pool is full the submitter executes queued tasks itself before
enqueueing more, so in-flight work never exceeds ``pool_cap``.

Workers are stepped cooperatively in a fixed round-robin order, which makes
every run deterministic for a given seed — the repo-wide discrete stand-in
for parallel threads (ordering, not timing, is what scheduling controls).
"""
from __future__ import annotations

import dataclasses
import itertools
from time import perf_counter_ns
from typing import Any, Callable, Optional, Sequence

import numpy as np

from .adaptive import GreedySteal, StealGovernor
from .events import EventLog, ReferenceEventLog
from .metrics import MetricsRecorder
from .queues import DomainQueues
from .workers import Worker, WorkerPool


@dataclasses.dataclass
class Task:
    """One unit of work: an opaque payload plus its locality tag.

    ``home`` is the domain whose memory holds the task's data (page
    placement in the paper, KV-cache residency in serving); -1 means the
    task has no affinity anywhere yet ("first touch" happens on execution).
    ``cost`` is an abstract local execution cost used by governors and
    benchmarks, not a wall-clock promise.
    """

    uid: int
    payload: Any = None
    home: int = -1
    cost: float = 1.0


Handler = Callable[[Task, Worker], Any]
BatchHandler = Callable[[list, Worker], list]    # (tasks, worker) -> results
PenaltyFn = Callable[[Task, Worker], float]
SubmitHook = Callable[[Task, int, int], None]   # (task, routed_domain, step)
Router = Callable[[Task], int]                  # task -> submit domain
StepHook = Callable[["Executor"], None]         # fired after each step()


def _default_handler(task: Task, worker: Worker) -> Any:
    return task.payload(worker) if callable(task.payload) else task.payload


class Executor:
    """Online multi-worker executor over per-domain locality queues.

    Parameters
    ----------
    num_domains:        number of locality domains (queues).
    worker_domains:     domain of each worker, in wid order; defaults to one
                        worker per domain.  Every domain should be covered
                        by a worker unless stealing can reach it.
    handler:            ``(task, worker) -> result``; non-None results are
                        collected and returned by ``run_until_drained``.
                        Defaults to calling the payload if it is callable.
    pool_cap:           bound on queued-but-unrun tasks (§2.1); ``None``
                        disables backpressure.
    steal_order:        "cyclic" (paper §2.2), "longest", "random", or
                        "cost_weighted" (victim = most queued cost).
    governor:           a ``StealGovernor``; default ``GreedySteal``.
    steal_penalty:      ``(task, worker) -> cost`` charged on steals (e.g.
                        re-prefill tokens); accounted in the metrics.
    seed:               drives the executor's RNG (used by random stealing).
    submit_hook:        optional ``(task, routed_domain, step)`` callback fired
                        as each task is enqueued — the recording surface used
                        by ``repro.trace.TraceRecorder`` to capture a
                        replayable submission trace.
    router:             optional ``task -> domain`` routing policy consulted
                        on ``submit(task, domain=None)`` *before* the default
                        home/round-robin rule (``repro.control.CostRouter``
                        plugs in here).  The router sees ``task.home`` and
                        may keep or override it.
    batch:              batch-grab limit per ``_attempt``: an int (static
                        limit, default 1 = the PR-1 behaviour) or any object
                        with a ``size`` property and an
                        ``on_batch(n_tasks, service)`` method (an adaptive
                        policy, e.g. ``repro.control.BatchGovernor``).  After
                        a worker's dequeue picks a source queue, up to
                        ``batch-1`` more tasks are drained from that same
                        queue and executed in one grab (continuous batching:
                        one scheduling round serves a whole batch).  A policy
                        may also expose a ``budget`` (float): the grab then
                        stops before exceeding that much summed task cost
                        (token-budget batching).  A policy with a true
                        ``per_domain`` attribute is sized per source queue
                        (``size_for(domain)``) and fed with the source
                        domain (``on_batch(n_tasks, service, domain)``).
    batch_handler:      ``(tasks, worker) -> results`` called with each grab's
                        task list (length 1..batch).  When None, ``handler``
                        is called per task.  Results align with tasks;
                        non-None entries are collected.
    step_hook:          optional ``(executor) -> None`` fired at the end of
                        every ``step()`` — the control plane's drive point
                        (``repro.control.ControlLoop`` plugs in here).
    topology:           optional ``repro.topology.DistanceMatrix`` arranging
                        the domains in a distance tree.  Hierarchical
                        matrices make every steal scan nearest-first (the
                        configured ``steal_order`` applies within a tier),
                        scale each steal's penalty by the link distance
                        actually crossed, ask the governor for per-level
                        depth thresholds (``min_victim_depth_at``), and
                        count cross-tier steals as ``remote_steals``.  A
                        flat matrix (or None, the default) reproduces the
                        pre-topology behaviour bit-for-bit.
    profiler:           optional ``repro.obs.HotPathProfiler``.  When
                        attached, the executor wraps its four hot decision
                        sites — submit-route, steal-scan, batch-grab,
                        event-append — in ``perf_counter_ns`` timers and
                        feeds the elapsed time to ``profiler.add``.  The
                        profiler is passive (it observes wall clock, never
                        a decision), so profiled runs keep bit-identical
                        ``RuntimeStats`` and replays; with the default
                        ``None`` the timers are skipped entirely.
    fast:               selects the hot-path implementation.  ``True`` (the
                        default) uses the incremental eligibility structures
                        in ``DomainQueues`` and the columnar ``EventLog``;
                        ``False`` runs the pre-rewrite reference scan and
                        the object-per-event ``ReferenceEventLog``.  The two
                        are bit-identical (same stats, same event sequence,
                        same RNG draws) — the slow arm exists as the
                        executable specification for the
                        ``benchmarks.scheduler_overhead`` fast_vs_slow
                        equivalence gate.
    depth_sample_stride: record the per-domain queue-depth sample every
                        N-th scheduling round (default 1 = every round, the
                        original behaviour).  Depth sampling is O(domains)
                        per round; million-task benchmark drives raise the
                        stride to keep it off the hot path.  Counters in
                        ``RuntimeStats`` are unaffected.
    """

    def __init__(self, num_domains: int,
                 worker_domains: Sequence[int] | None = None, *,
                 handler: Handler | None = None,
                 pool_cap: Optional[int] = 256,
                 steal_order: str = "cyclic",
                 governor: StealGovernor | None = None,
                 steal_penalty: PenaltyFn | None = None,
                 seed: int = 0,
                 record_events: bool = True,
                 event_maxlen: int = 65536,
                 submit_hook: SubmitHook | None = None,
                 router: Router | None = None,
                 batch: Any = 1,
                 batch_handler: BatchHandler | None = None,
                 step_hook: StepHook | None = None,
                 topology: Any = None,
                 profiler: Any = None,
                 fast: bool = True,
                 depth_sample_stride: int = 1):
        self.num_domains = num_domains
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.topology = topology
        self.fast = fast
        # hoisted out of the per-dequeue steal_scan region: tier count when
        # hierarchical (per-level governor thresholds apply), else 0
        self._hier_levels = (topology.num_levels
                            if topology is not None and topology.hierarchical
                            else 0)
        self.queues = DomainQueues(num_domains, steal_order=steal_order,
                                   rng=self.rng, topology=topology,
                                   fast=fast)
        if worker_domains is None:
            worker_domains = list(range(num_domains))
        self.pool = WorkerPool(worker_domains)
        for w in self.pool:
            if not 0 <= w.domain < num_domains:
                raise ValueError(f"{w!r} outside {num_domains} domains")
        self.handler = handler or _default_handler
        self.pool_cap = pool_cap
        self.governor = governor or GreedySteal()
        self.steal_penalty = steal_penalty
        self.metrics = MetricsRecorder(depth_stride=depth_sample_stride)
        log_cls = EventLog if fast else ReferenceEventLog
        self.events = log_cls(event_maxlen) if record_events else None
        self.submit_hook = submit_hook
        self.router = router
        self.batch = batch
        self.batch_handler = batch_handler
        self.step_hook = step_hook
        self.profiler = profiler
        # the declarative configuration this executor was built from, when
        # constructed via repro.spec (``RuntimeSpec.build`` stamps it here);
        # trace headers embed it so a recorded run fully names its system.
        # Raw-kwarg construction (this __init__ called directly) is the thin
        # deprecated path and leaves it None.
        self.spec = None
        self.results: list[Any] = []
        self._uids = itertools.count()
        self._rr = 0
        self._step = 0
        # bound-method alias: ``queues`` is created here and never swapped,
        # so the per-dequeue attribute walk can be paid once
        self._dequeue = self.queues.dequeue

    @property
    def governor(self):
        return self._governor

    @governor.setter
    def governor(self, gov) -> None:
        # governors are swappable mid-run (the control loop attaches its
        # breaker this way), so the hot-path shortcut below is recomputed on
        # every assignment: a governor that inherits the base
        # ``min_victim_depth`` unchanged is the pure constant-1 probe
        # (GreedySteal), and ``_attempt`` may skip the Python call per
        # dequeue without observable difference — the base probe reads no
        # state and mutates none
        self._governor = gov
        self._greedy_probe = (type(gov).min_victim_depth
                              is StealGovernor.min_victim_depth)

    # -- submission side ----------------------------------------------------
    def make_task(self, payload: Any = None, home: int = -1,
                  cost: float = 1.0) -> Task:
        return Task(uid=next(self._uids), payload=payload, home=home, cost=cost)

    def next_round_robin(self) -> int:
        """Next submit domain in round-robin order, skipping hot domains.

        A domain whose queue depth exceeds 2x the mean depth is skipped (its
        turn is forfeited, not deferred), so round-robin routing cannot keep
        force-feeding a backlogged domain while others idle.  At most one
        pass is made: since not every depth can exceed twice the mean, an
        eligible domain always exists, and with balanced queues this
        degenerates to the plain cycle.
        """
        sizes = self.queues.queue_sizes()
        cap = 2.0 * sum(sizes) / len(sizes)
        for _ in range(self.num_domains):
            d = self._rr % self.num_domains
            self._rr += 1
            if sizes[d] <= cap:
                break
        return d

    def submit(self, task: Task, domain: int | None = None) -> None:
        """Route ``task`` into a domain queue, applying backpressure.

        ``domain=None`` asks the ``router`` (when one is attached), else
        routes to the task's home domain, or round-robin for homeless tasks.
        When the pool is full, the submitter executes queued tasks inline
        (greedily, ignoring the governor — the §2.1 "submitting thread is
        used for processing tasks" rule) until a slot frees up, so the pool
        bound is a hard invariant.
        """
        if domain is None:
            # repro: allow[wall-clock] sanctioned profiler site (submit_route): timer around a decision, never an input to it
            t0 = perf_counter_ns() if self.profiler is not None else 0
            if self.router is not None:
                domain = int(self.router(task))
            elif task.home >= 0:
                domain = task.home
            else:
                domain = self.next_round_robin()
            if self.profiler is not None:
                # repro: allow[wall-clock] sanctioned profiler site (submit_route): elapsed-time read feeds only HotPathProfiler
                self.profiler.add("submit_route", perf_counter_ns() - t0)
        if not 0 <= domain < self.num_domains:
            raise ValueError(f"domain {domain} out of range")
        while self.pool_cap is not None and len(self.queues) >= self.pool_cap:
            if not self._attempt(self.pool[0], inline=True):
                break
        self.queues.enqueue(task, domain)
        self.metrics.on_submit(len(self.queues))
        self._emit("submit", worker=-1, domain=domain, task_uid=task.uid,
                   cost=task.cost)
        if self.submit_hook is not None:
            self.submit_hook(task, domain, self._step)

    # -- execution side -----------------------------------------------------
    def step(self) -> int:
        """One scheduling round: every worker attempts one grab (up to
        ``batch`` tasks from a single queue).  Returns the number of tasks
        executed.  Interleave with ``submit`` for online (arrival-driven)
        operation."""
        self._step += 1
        n = sum(self._attempt(w) for w in self.pool)
        if self.metrics.wants_depths(self._step):
            self.metrics.sample_depths(self._step, self.queues.queue_sizes())
        if self.step_hook is not None:
            self.step_hook(self)
        return n

    def run_until_drained(self) -> list[Any]:
        """Step until all queues are empty; returns (and clears) the
        accumulated non-None handler results, in completion order."""
        stalled = 0
        while len(self.queues):
            if self.step() == 0:
                stalled += 1
                if stalled > 10_000:
                    raise RuntimeError(
                        "executor stalled: tasks queued in domains no worker "
                        f"may serve (sizes={self.queues.queue_sizes()}, "
                        f"workers={[w.domain for w in self.pool]})")
            else:
                stalled = 0
        out, self.results = self.results, []
        return out

    @property
    def batch_max(self) -> int:
        """Current effective batch-grab limit (>= 1)."""
        size = getattr(self.batch, "size", self.batch)
        return max(int(size), 1)

    def _batch_limit(self, domain: int) -> int:
        """The grab limit for a batch sourced from ``domain``: a batch
        policy exposing ``size_for(domain)`` (per-queue sizing, e.g.
        ``BatchGovernor(per_domain=True)``) is consulted per source queue;
        anything else falls back to the global ``batch_max``."""
        size_for = getattr(self.batch, "size_for", None)
        if size_for is not None:
            return max(int(size_for(domain)), 1)
        return self.batch_max

    def _attempt(self, worker: Worker, inline: bool = False) -> int:
        """One grab by ``worker``: dequeue (local-first, governed steal),
        then drain up to ``batch_max - 1`` more tasks from the same source
        queue and execute the batch.  Returns the number of tasks executed
        (0 when nothing was eligible).  Inline (backpressure) grabs stay
        single-task: the submitter only helps enough to free one slot."""
        # repro: allow[wall-clock] sanctioned profiler site (steal_scan): timer around the dequeue, never an input to it
        t0 = perf_counter_ns() if self.profiler is not None else 0
        if inline:
            got = self._dequeue(worker.domain)
        elif self._greedy_probe and not self._hier_levels:
            # base-contract governor (GreedySteal): the probe is the pure
            # constant 1, so skip the per-dequeue Python call entirely
            got = self._dequeue(worker.domain, True, 1)
        else:
            mv = self._governor.min_victim_depth(worker)
            if mv is None:
                got = self._dequeue(worker.domain, False)
            else:
                if self._hier_levels:
                    # per-level thresholds: the governor prices each tier
                    # separately (AdaptiveSteal's per-level θ, the breaker's
                    # remote cut); a scalar-only governor repeats its one
                    # threshold at every tier via the base contract.
                    mv = [self._governor.min_victim_depth_at(worker, lv)
                          for lv in range(1, self._hier_levels + 1)]
                got = self._dequeue(worker.domain, True, mv)
        if self.profiler is not None:
            # repro: allow[wall-clock] sanctioned profiler site (steal_scan): elapsed-time read feeds only HotPathProfiler
            self.profiler.add("steal_scan", perf_counter_ns() - t0)
        if got is None:
            worker.stats.idle_polls += 1
            self.metrics.on_idle()
            self._governor.on_idle(worker)
            self._emit("idle", worker=worker.wid, domain=worker.domain,
                       task_uid=-1)
            return 0
        tasks: list[Task] = [got.item]
        if not inline:
            limit = self._batch_limit(got.domain)
            if limit > 1:
                # repro: allow[wall-clock] sanctioned profiler site (batch_grab): timer around the drain, never an input to it
                t0 = perf_counter_ns() if self.profiler is not None else 0
                tasks += self.queues.drain(
                    got.domain, limit - 1,
                    budget=getattr(self.batch, "budget", None),
                    spent=got.item.cost)
                if self.profiler is not None:
                    # repro: allow[wall-clock] sanctioned profiler site (batch_grab): elapsed-time read feeds only HotPathProfiler
                    self.profiler.add("batch_grab", perf_counter_ns() - t0)
        stolen = got.stolen
        # a steal's penalty is scaled by the link distance it crossed
        # (1.0 for flat/no topology — bit-identical to the uniform-hop rule)
        penalties = [float(self.steal_penalty(t, worker)) * got.distance
                     if stolen and self.steal_penalty is not None else 0.0
                     for t in tasks]
        if self.batch_handler is not None:
            results = list(self.batch_handler(tasks, worker))
            if len(results) != len(tasks):
                raise ValueError(
                    f"batch_handler returned {len(results)} results "
                    f"for {len(tasks)} tasks")
        else:
            results = [self.handler(t, worker) for t in tasks]
        kind = "inline" if inline else ("steal" if stolen else "run")
        remote = stolen and got.level >= 2
        for task, penalty, result in zip(tasks, penalties, results):
            local = not stolen and task.home == worker.domain
            worker.stats.executed += 1
            worker.stats.local += int(local)
            worker.stats.stolen += int(stolen)
            self.metrics.on_execute(local, stolen, penalty, inline,
                                    remote=remote)
            self._governor.on_execute(worker, stolen, penalty, task.cost,
                                     level=got.level)
            self._emit(kind, worker=worker.wid, domain=worker.domain,
                       task_uid=task.uid, src_domain=got.domain,
                       cost=task.cost, penalty=penalty)
            if result is not None:
                self.results.append(result)
        on_batch = getattr(self.batch, "on_batch", None)
        if on_batch is not None and not inline:
            service = sum(t.cost for t in tasks) + sum(penalties)
            if getattr(self.batch, "per_domain", False):
                on_batch(len(tasks), service, got.domain)
            else:
                on_batch(len(tasks), service)
        return len(tasks)

    def _emit(self, kind: str, worker: int, domain: int, task_uid: int,
              src_domain: int = -1, cost: float = 0.0,
              penalty: float = 0.0) -> None:
        if self.events is not None:
            if self.profiler is not None:
                # repro: allow[wall-clock] sanctioned profiler site (event_append): timer around the emit, never an input to it
                t0 = perf_counter_ns()
                self.events.emit(self._step, kind, worker, domain, task_uid,
                                 src_domain, cost, penalty)
                # repro: allow[wall-clock] sanctioned profiler site (event_append): elapsed-time read feeds only HotPathProfiler
                self.profiler.add("event_append", perf_counter_ns() - t0)
            else:
                self.events.emit(self._step, kind, worker, domain, task_uid,
                                 src_domain, cost, penalty)

    # -- introspection ------------------------------------------------------
    @property
    def stats(self):
        return self.metrics.stats

    @property
    def step_count(self) -> int:
        """Scheduling rounds run so far — the discrete makespan proxy."""
        return self._step

    def __len__(self) -> int:
        return len(self.queues)
