"""Critical-path blame: where each task's sojourn actually went.

The paper's argument is an *attribution* argument — locality queues win
because remote access and steal churn are charged to the decisions that
caused them, not guessed at from aggregates.  ``observe`` (PR 7) reports
the sojourn distribution; this module explains it, decomposing every
observed task's sojourn into the three phases the runtime can actually
spend time in::

    sojourn  =  queue_wait  +  steal_transfer  +  exec

  queue_wait      scheduling rounds between submission and execution —
                  time spent sitting in the routed queue (charged to the
                  queue's domain);
  steal_transfer  the nonlocal penalty actually paid when the task was
                  taken from a foreign queue (charged to the thief's
                  domain and to the topology level of the link crossed —
                  level 0 means the task ran local and paid nothing);
  exec            the task's own execution cost (charged to the executing
                  domain).

The decomposition is *exact by construction*: it is computed from the very
fields (``wait``, ``Event.cost``, ``Event.penalty``) whose sum defines the
recorded sojourn (``trace.replay.TaskTiming.sojourn = wait + (cost +
penalty)``), in the same operation order, so per task the phases sum
bit-identically to the recorded sojourn — the invariant
``tests/test_analytics.py`` gates over the whole policy × workload matrix.
Aggregation (per-domain and per-level blame tables, top-K dominant
contributors) iterates tasks in ascending uid order, so two decompositions
of the same trace are identical — the same schedule-passivity contract the
rest of ``repro.obs`` keeps.

Works on any v1–v4 trace: steal levels are priced by the header-embedded
``DistanceMatrix`` when one exists (schema v3+), else every steal is the
flat machine's level 1.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ..trace.schema import event_stolen
from .spans import EXEC_KINDS

PHASES = ("queue_wait", "steal_transfer", "exec")


@dataclasses.dataclass(frozen=True)
class TaskBlame:
    """One task's exact sojourn decomposition (see module docstring).

    ``level`` is the topology tier the steal crossed (1 = nearest, 2+ =
    remote), or 0 when the task executed without being stolen.
    """

    uid: int
    home: int
    routed: int          # the queue the submission was routed to
    exec_domain: int     # the domain whose worker executed it
    worker: int
    level: int
    queue_wait: float
    steal_transfer: float
    exec: float

    @property
    def sojourn(self) -> float:
        """Exactly the recorded sojourn: ``wait + (cost + penalty)`` in the
        same float-operation order ``TaskTiming.sojourn`` uses."""
        return self.queue_wait + (self.exec + self.steal_transfer)

    @property
    def phases(self) -> dict[str, float]:
        return {"queue_wait": self.queue_wait,
                "steal_transfer": self.steal_transfer, "exec": self.exec}

    @property
    def dominant(self) -> str:
        """The phase holding the largest share of this task's sojourn (ties
        break by the fixed ``PHASES`` order, so the answer is deterministic).
        """
        ph = self.phases
        return max(PHASES, key=lambda p: (ph[p], -PHASES.index(p)))


def _zero_row() -> dict[str, float]:
    return {"queue_wait": 0.0, "steal_transfer": 0.0, "exec": 0.0,
            "total": 0.0, "tasks": 0}


@dataclasses.dataclass
class BlameReport:
    """The full critical-path attribution of one trace.

    ``by_domain`` charges each phase to the domain that owns it:
    queue-wait to the *routed* queue's domain, steal-transfer and exec to
    the *executing* domain.  ``by_level`` splits steal-transfer blame by
    the topology tier crossed (level 0 rows aggregate local executions:
    zero transfer, all exec).  Both tables carry a ``total`` column and a
    task count; summing any table's ``total`` column reproduces
    ``total_sojourn`` (same floats, fixed iteration order).
    """

    tasks: dict[int, TaskBlame]
    missing: tuple[int, ...]
    by_domain: dict[int, dict[str, float]]
    by_level: dict[int, dict[str, float]]
    totals: dict[str, float]

    def __len__(self) -> int:
        return len(self.tasks)

    @property
    def total_sojourn(self) -> float:
        return self.totals["total"]

    def top(self, k: int = 10) -> list[TaskBlame]:
        """The ``k`` worst tasks by sojourn (ties broken by ascending uid —
        deterministic), each carrying its own phase split."""
        return sorted(self.tasks.values(),
                      key=lambda b: (-b.sojourn, b.uid))[:k]

    def dominant_contributors(self, k: int = 5) -> list[dict[str, Any]]:
        """The top-K (phase, domain) blame cells: which phase on which
        domain holds the largest share of total sojourn.  Each row carries
        the absolute blame and its share of ``total_sojourn``; ordering is
        blame-descending with (phase, domain) tie-breaks."""
        cells = []
        for domain in sorted(self.by_domain):
            row = self.by_domain[domain]
            for phase in PHASES:
                if row[phase] > 0.0:
                    cells.append({"phase": phase, "domain": domain,
                                  "blame": row[phase],
                                  "share": row[phase]
                                  / max(self.total_sojourn, 1e-12)})
        cells.sort(key=lambda c: (-c["blame"], c["phase"], c["domain"]))
        return cells[:k]

    def snapshot(self) -> dict[str, Any]:
        """JSON-ready summary: totals, per-domain and per-level tables, and
        the dominant-contributor ranking (not the per-task detail)."""
        return {
            "tasks": len(self.tasks),
            "missing": len(self.missing),
            "totals": dict(self.totals),
            "by_domain": {str(d): dict(r)
                          for d, r in sorted(self.by_domain.items())},
            "by_level": {str(lv): dict(r)
                         for lv, r in sorted(self.by_level.items())},
            "dominant": self.dominant_contributors(),
        }


def decompose(trace, topology: Optional[Any] = None) -> BlameReport:
    """Decompose every observed task of ``trace`` (v1–v4) into exact
    queue-wait / steal-transfer / exec blame.

    ``topology`` overrides the header-embedded ``DistanceMatrix`` for
    steal-level pricing; without either, every steal is level 1 (the flat
    machine), matching the executor's own flat accounting.  Tasks whose
    execution event fell out of the ring-buffer window are listed in
    ``missing``, never silently skipped.
    """
    if topology is None and trace.topology_dict is not None:
        from ..topology import DistanceMatrix   # lazy: keep import light
        topology = DistanceMatrix.from_dict(trace.topology_dict)

    submitted = {s.uid: s for s in trace.submissions}
    execs = {}
    for e in trace.events:
        if e.kind in EXEC_KINDS and e.task_uid in submitted:
            execs[e.task_uid] = e

    tasks: dict[int, TaskBlame] = {}
    by_domain: dict[int, dict[str, float]] = {}
    by_level: dict[int, dict[str, float]] = {}
    totals = _zero_row()
    for uid in sorted(execs):
        e, sub = execs[uid], submitted[uid]
        wait = e.step - sub.step            # ints, exact
        stolen = event_stolen(e)
        if stolen:
            level = (topology.level(e.domain, e.src_domain)
                     if topology is not None else 1)
        else:
            level = 0
        blame = TaskBlame(uid=uid, home=sub.home, routed=sub.domain,
                          exec_domain=e.domain, worker=e.worker, level=level,
                          queue_wait=wait, steal_transfer=e.penalty,
                          exec=e.cost)
        tasks[uid] = blame
        dr = by_domain.setdefault(sub.domain, _zero_row())
        dr["queue_wait"] += wait
        de = by_domain.setdefault(e.domain, _zero_row())
        de["steal_transfer"] += e.penalty
        de["exec"] += e.cost
        lr = by_level.setdefault(level, _zero_row())
        lr["queue_wait"] += wait
        lr["steal_transfer"] += e.penalty
        lr["exec"] += e.cost
        lr["total"] += blame.sojourn
        lr["tasks"] += 1
        totals["queue_wait"] += wait
        totals["steal_transfer"] += e.penalty
        totals["exec"] += e.cost
        totals["total"] += blame.sojourn
        totals["tasks"] += 1
    # per-domain totals: the three phase columns that domain was blamed for
    for row in by_domain.values():
        row["total"] = row["queue_wait"] + row["steal_transfer"] + row["exec"]
    for uid in sorted(tasks):
        by_domain[tasks[uid].exec_domain]["tasks"] += 1
    missing = tuple(uid for uid in submitted if uid not in execs)
    return BlameReport(tasks=tasks, missing=missing, by_domain=by_domain,
                       by_level=by_level, totals=totals)
