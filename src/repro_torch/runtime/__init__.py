"""repro_torch.runtime — the online locality-aware task runtime.

A copy of ``repro.runtime`` (pure numpy) kept inside the PyTorch port so
that the port imports nothing of the JAX package.  Only the imports differ:
for the same seed it schedules exactly as the reference does (same
``RuntimeStats``, same event stream), which ``tests/test_torch_runtime.py``
checks.

This package is the paper's contribution lifted out of the offline
discrete-event simulator and made *online*: tasks arrive dynamically, are
sorted into per-locality-domain FIFO queues, and domain-pinned workers
serve them local-first with balance-over-locality stealing.  It is the
single home of the steal-scan logic — both the simulator policies
(`repro.core.scheduler`) and the serving router (`repro.serving.engine`)
are thin layers over these primitives.

Paper-concept map (Wittmann & Hager, 2010):

  paper concept (§)                      runtime object
  -------------------------------------  ---------------------------------
  locality domain, ``ld_ID`` map (§1.3)  domain index; ``WorkerPool`` pinning
  one task = one block (§2.1)            ``Task`` (``home`` = page placement)
  bounded task pool, ~256 (§2.1)         ``Executor(pool_cap=...)`` +
                                         ``SubmissionPool``; full pool makes
                                         the submitter run tasks inline
  locality queues + steal scan (§2.2)    ``DomainQueues`` (``cyclic`` order)
  TBB random stealing (§3.1)             ``DomainQueues`` (``random`` order)
  nonlocal-access penalty (§1.4)         ``steal_penalty`` callback, summed
                                         in ``RuntimeStats.steal_penalty``
  balance over locality (§2.2)           ``GreedySteal`` governor; the
                                         ``AdaptiveSteal`` governor throttles
                                         it by queue depth (beyond the paper)

The table continues in ``repro/trace/__init__.py`` — workload generation,
trace export, deterministic replay, and steal-storm analysis over these
primitives (record a run via ``Executor(submit_hook=...)``) — and in
``repro/control/__init__.py`` — the online control plane that adjusts
routing, batch size, and the steal threshold through the executor's
``router``/``batch``/``governor``/``step_hook`` knobs.

Usage::

    from repro_torch.runtime import AdaptiveSteal, Executor

    ex = Executor(num_domains=4, steal_order="cyclic",
                  handler=lambda task, worker: work(task.payload, worker),
                  steal_penalty=lambda task, worker: task.cost,
                  governor=AdaptiveSteal(penalty_hint=4.0))
    for item, home in arrivals:                 # online submission
        ex.submit(ex.make_task(item, home=home))
        ex.step()                               # overlap arrival + service
    results = ex.run_until_drained()
    print(ex.stats.local_fraction, ex.stats.steal_fraction,
          ex.stats.steal_penalty)
"""
from .adaptive import AdaptiveSteal, GreedySteal, NoSteal, StealGovernor
from .events import Event, EventLog, ReferenceEventLog
from .executor import Executor, Task
from .metrics import MetricsRecorder, RuntimeStats
from .queues import DomainQueues, Popped, SubmissionPool
from .workers import Worker, WorkerPool, WorkerStats

__all__ = [
    "AdaptiveSteal", "GreedySteal", "NoSteal", "StealGovernor",
    "Event", "EventLog", "ReferenceEventLog",
    "Executor", "Task",
    "MetricsRecorder", "RuntimeStats",
    "DomainQueues", "Popped", "SubmissionPool",
    "Worker", "WorkerPool", "WorkerStats",
]
