"""Head 2: the trace model checker — a happens-before verifier.

``obs.diff_traces`` judges the hot-path rewrite by *stats equality*; this
module judges it by *structural legality of the schedule itself*.  Given
any recorded v1–v4 trace it replays the event stream against the
executor's invariants, without executing anything:

  fidelity-keys      header carries the six replay-fidelity meta keys,
                     footer totals agree with the retained records, an
                     embedded topology/spec block parses and matches
  submit-unique      every task uid submitted exactly once (submission
                     records and submit events agree)
  exec-unique        every task uid executed at most once
  exec-unsubmitted   every executed uid has a submission record
  step-monotone      event steps are non-decreasing in stream order and
                     per worker (the step counter never runs backwards)
  fifo-order         a per-domain deque simulation of the stream: every
                     execution pops exactly the head of its source queue
  local-first        no worker steals while its own queue held work that
                     predates the attempt
  steal-level        steal edges the header forbids: domains outside the
                     matrix, any steal under NoSteal, and — under
                     GreedySteal on a hierarchical matrix — a tier-L steal
                     while a nearer tier held eligible work (the
                     nearest-first scan invariant)
  span-nesting       ``obs.assemble_spans`` trees are well-nested
  stats-consistency  footer ``RuntimeStats`` equal the event-stream counts

Ring-buffer windows: when ``trace.events_dropped > 0`` the event list is a
suffix of the run, so the stream-simulation checks (fifo-order,
local-first, the nearest-first half of steal-level, stats-consistency, and
submit-event agreement) are *skipped and recorded as notes* rather than
reporting false violations — the same refusal contract as
``trace.storms``.

Same-step interleaving: a handler (or backpressure helping) may submit
tasks *during* a scheduling round, so a submit event can precede, in
stream order, execution events whose dequeue actually happened earlier in
that round.  Occupancy-sensitive checks therefore only count queued tasks
whose submit step strictly predates the executing event's step — a
conservative under-count that cannot produce false positives.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any

from ..trace.schema import Trace, event_stolen
from .rules import Violation

REQUIRED_META = ("num_domains", "worker_domains", "steal_order", "pool_cap",
                 "seed", "governor")
EXEC_KINDS = ("run", "steal", "inline")


@dataclasses.dataclass
class ModelResult:
    """Outcome of model-checking one trace."""

    path: str
    violations: list[Violation]
    notes: list[str]                    # checks skipped (ring-buffer window)

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict[str, Any]:
        return {"path": self.path, "ok": self.ok,
                "violations": [v.to_dict() for v in self.violations],
                "notes": list(self.notes)}


def _topology(trace: Trace):
    if trace.topology_dict is None:
        return None
    from ..topology import DistanceMatrix
    return DistanceMatrix.from_dict(trace.topology_dict)


def check_trace(trace: Trace, path: str = "<trace>") -> ModelResult:
    """Model-check one in-memory ``Trace``; never raises on an illegal
    schedule — every problem is a named ``Violation``."""
    v: list[Violation] = []
    notes: list[str] = []

    def flag(rule: str, line: int, msg: str) -> None:
        v.append(Violation(path, line, rule, msg))

    # -- fidelity-keys -------------------------------------------------------
    for key in REQUIRED_META:
        if key not in trace.meta:
            flag("fidelity-keys", 1, f"header is missing meta key {key!r}")
    nd = int(trace.meta.get("num_domains", 0) or 0)
    if nd < 1:
        flag("fidelity-keys", 1, f"num_domains={nd} is not a machine")
    wd = trace.meta.get("worker_domains") or []
    if not wd:
        flag("fidelity-keys", 1, "worker_domains is empty")
    for w, d in enumerate(wd):
        if not 0 <= int(d) < max(nd, 1):
            flag("fidelity-keys", 1,
                 f"worker {w} pinned to domain {d} outside 0..{nd - 1}")
    if trace.events_retained != len(trace.events):
        flag("fidelity-keys", 1,
             f"footer claims events_retained={trace.events_retained} but "
             f"{len(trace.events)} event records are present")
    topo = None
    if trace.topology_dict is not None:
        try:
            topo = _topology(trace)
            if topo is not None and topo.num_domains != nd:
                flag("fidelity-keys", 1,
                     f"embedded topology spans {topo.num_domains} domains, "
                     f"header says {nd}")
                topo = None
        except Exception as exc:       # TopologyError and shape errors alike
            flag("fidelity-keys", 1, f"embedded topology does not parse: "
                                     f"{exc}")
            topo = None
    if trace.spec_dict is not None:
        try:
            from ..spec import RuntimeSpec
            RuntimeSpec.from_dict(trace.spec_dict)
        except Exception as exc:
            flag("fidelity-keys", 1, f"embedded spec does not parse: {exc}")
    max_step = max((e.step for e in trace.events), default=0)
    max_step = max(max_step, max((s.step for s in trace.submissions),
                                 default=0))
    if trace.total_steps < max_step:
        flag("fidelity-keys", 1,
             f"footer total_steps={trace.total_steps} predates recorded "
             f"step {max_step}")
    kind_counts: dict[str, int] = {}
    for e in trace.events:
        kind_counts[e.kind] = kind_counts.get(e.kind, 0) + 1
    windowed = trace.events_dropped > 0
    if trace.event_counts:
        for kind, n in kind_counts.items():
            total = int(trace.event_counts.get(kind, 0))
            if total < n or (not windowed and total != n):
                flag("fidelity-keys", 1,
                     f"footer event_counts[{kind!r}]={total} vs {n} "
                     "retained events of that kind")

    # -- submit/exec uniqueness ---------------------------------------------
    sub_counts: dict[int, int] = {}
    for s in trace.submissions:
        sub_counts[s.uid] = sub_counts.get(s.uid, 0) + 1
    for uid, n in sub_counts.items():
        if n > 1:
            flag("submit-unique", 1,
                 f"task uid {uid} has {n} submission records")
    ev_submits: dict[int, int] = {}
    exec_counts: dict[int, int] = {}
    for i, e in enumerate(trace.events, start=1):
        if e.kind == "submit":
            ev_submits[e.task_uid] = ev_submits.get(e.task_uid, 0) + 1
        elif e.kind in EXEC_KINDS and e.task_uid >= 0:
            exec_counts[e.task_uid] = exec_counts.get(e.task_uid, 0) + 1
    for uid, n in ev_submits.items():
        if n > 1:
            flag("submit-unique", 1, f"task uid {uid} has {n} submit events")
    if not windowed:
        missing = set(sub_counts) - set(ev_submits)
        extra = set(ev_submits) - set(sub_counts)
        if missing:
            flag("submit-unique", 1,
                 f"{len(missing)} submitted uids have no submit event "
                 f"(e.g. {sorted(missing)[:3]})")
        if extra:
            flag("submit-unique", 1,
                 f"{len(extra)} submit events lack submission records "
                 f"(e.g. {sorted(extra)[:3]})")
    else:
        notes.append("submit-event agreement skipped: "
                     f"{trace.events_dropped} events dropped by the ring "
                     "buffer")
    for uid, n in exec_counts.items():
        if n > 1:
            flag("exec-unique", 1, f"task uid {uid} executed {n} times")
        if uid not in sub_counts:
            flag("exec-unsubmitted", 1,
                 f"executed uid {uid} was never submitted")

    # -- step monotonicity ---------------------------------------------------
    prev = 0
    prev_by_worker: dict[int, int] = {}
    for i, e in enumerate(trace.events, start=1):
        if e.step < prev:
            flag("step-monotone", i,
                 f"event {i} at step {e.step} follows step {prev} — the "
                 "step clock ran backwards")
        prev = max(prev, e.step)
        if e.worker >= 0:
            pw = prev_by_worker.get(e.worker, 0)
            if e.step < pw:
                flag("step-monotone", i,
                     f"worker {e.worker} regressed from step {pw} to "
                     f"{e.step} at event {i}")
            prev_by_worker[e.worker] = max(pw, e.step)

    # -- stream simulation: FIFO, local-first, nearest-first -----------------
    governor = str(trace.meta.get("governor", ""))
    if windowed:
        notes.append("fifo-order/local-first/nearest-first skipped: event "
                     "window is a suffix of the run")
    else:
        queues: dict[int, deque[tuple[int, int]]] = {
            d: deque() for d in range(max(nd, 1))}

        def pre_step_depth(domain: int, step: int) -> int:
            q = queues.get(domain)
            if q is None:
                return 0
            return sum(1 for (_uid, s) in q if s < step)

        for i, e in enumerate(trace.events, start=1):
            if e.kind == "submit":
                if e.domain in queues:
                    queues[e.domain].append((e.task_uid, e.step))
                continue
            if e.kind not in EXEC_KINDS or e.task_uid < 0:
                continue
            src = e.src_domain if e.src_domain >= 0 else e.domain
            q = queues.get(src)
            if q is None:
                continue                 # steal-level flags the bad domain
            if not q:
                flag("fifo-order", i,
                     f"event {i}: uid {e.task_uid} executed from domain "
                     f"{src} whose queue was empty")
                continue
            head_uid, _ = q[0]
            if head_uid != e.task_uid:
                flag("fifo-order", i,
                     f"event {i}: domain {src} served uid {e.task_uid} "
                     f"ahead of queued uid {head_uid}")
                # resync so one swap doesn't cascade down the stream
                try:
                    q.remove(next(p for p in q if p[0] == e.task_uid))
                except StopIteration:
                    q.popleft()
            else:
                q.popleft()
            if event_stolen(e):
                own_depth = pre_step_depth(e.domain, e.step)
                if own_depth > 0:
                    flag("local-first", i,
                         f"event {i}: worker {e.worker} stole uid "
                         f"{e.task_uid} from domain {src} while its own "
                         f"domain {e.domain} held {own_depth} older tasks")
                if (topo is not None and topo.hierarchical
                        and governor == "GreedySteal"
                        and 0 <= e.domain < nd and 0 <= src < nd):
                    lv = topo.level(e.domain, src)
                    for nearer in range(1, lv):
                        busy = [p for p in topo.peers(e.domain, nearer)
                                if pre_step_depth(p, e.step) > 0]
                        if busy:
                            flag("steal-level", i,
                                 f"event {i}: tier-{lv} steal from domain "
                                 f"{src} while tier-{nearer} peers {busy} "
                                 "held older work — nearest-first scan "
                                 "violated")
                            break

    # -- steal legality that needs no occupancy ------------------------------
    for i, e in enumerate(trace.events, start=1):
        if e.kind in EXEC_KINDS and e.task_uid >= 0:
            if not 0 <= e.domain < max(nd, 1):
                flag("steal-level", i,
                     f"event {i}: worker domain {e.domain} outside "
                     f"0..{nd - 1}")
            if e.src_domain >= 0 and not e.src_domain < max(nd, 1):
                flag("steal-level", i,
                     f"event {i}: source domain {e.src_domain} outside "
                     f"0..{nd - 1}")
            if event_stolen(e) and governor == "NoSteal":
                flag("steal-level", i,
                     f"event {i}: uid {e.task_uid} stolen from domain "
                     f"{e.src_domain} under the NoSteal governor")

    # -- span nesting --------------------------------------------------------
    try:
        from ..obs import assemble_spans
        forest = assemble_spans(trace)
        for uid in sorted(forest.spans):
            if not forest.spans[uid].well_nested():
                flag("span-nesting", 1,
                     f"task {uid}'s reconstructed span tree is not "
                     "well-nested")
    except Exception as exc:
        flag("span-nesting", 1, f"span reconstruction failed: {exc}")

    # -- stats consistency ---------------------------------------------------
    if windowed:
        notes.append("stats-consistency skipped: footer counts whole-run "
                     "totals, events are a window")
    elif trace.stats:
        homes = {s.uid: s.home for s in trace.submissions}
        execs = [e for e in trace.events
                 if e.kind in EXEC_KINDS and e.task_uid >= 0]
        stolen = [e for e in execs if event_stolen(e)]
        expect: dict[str, float] = {
            "submitted": len(trace.submissions),
            "executed": len(execs),
            "stolen": len(stolen),
            "inline_runs": sum(1 for e in execs if e.kind == "inline"),
            "idle_polls": kind_counts.get("idle", 0),
            "local": sum(1 for e in execs if not event_stolen(e)
                         and homes.get(e.task_uid) == e.domain),
            "steal_penalty": sum(e.penalty for e in stolen),
        }
        if topo is not None:
            expect["remote_steals"] = sum(
                1 for e in stolen
                if 0 <= e.domain < nd and 0 <= e.src_domain < nd
                and topo.level(e.domain, e.src_domain) >= 2)
        for key, want in expect.items():
            if key not in trace.stats:
                continue
            got = float(trace.stats[key])
            same = (math.isclose(got, want, rel_tol=1e-9, abs_tol=1e-9)
                    if key == "steal_penalty" else got == want)
            if not same:
                flag("stats-consistency", 1,
                     f"footer stats[{key!r}]={got} but the event stream "
                     f"says {want}")

    return ModelResult(path=path, violations=v, notes=notes)


def check_path(path: str) -> ModelResult:
    """Model-check a trace file or segment directory on disk."""
    from ..trace import TraceReader
    return check_trace(TraceReader(path).read(), path=path)
