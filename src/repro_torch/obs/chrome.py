"""Perfetto / Chrome trace-event export of a recorded run.

``export_chrome_trace(trace, path)`` renders any v1–v4 ``repro.trace.Trace``
as a Chrome trace-event JSON file — open it at https://ui.perfetto.dev (or
``chrome://tracing``) for the interactive form of the paper's Fig. 4
timelines:

  * one *process* track per locality domain, holding
      - one *thread* lane per worker pinned to that domain, carrying the
        execution slices (``run`` / ``steal`` / ``inline``), one slice per
        task, sized by its measured service (cost + penalty) and labelled
        with uid, cost, penalty, and batch grouping;
      - one ``queue`` lane marking steal hand-offs out of this domain's
        queue;
      - a ``queue depth`` counter series (submissions in, executions out)
        — the depth-imbalance picture behind the storm detectors.
  * a *flow arrow* per steal, drawn from the victim domain's queue lane to
    the thief worker's execution slice — cross-domain (and with schema v3+
    topology headers, cross-socket) traffic is visible as arrows crossing
    process tracks.

The step clock maps to trace time as 1 scheduling round = ``step_us``
microseconds (default 1000, so Perfetto's "ms" readout counts rounds).
Within one batch grab the member slices are laid out back-to-back from the
grab's step so they stay individually visible; the step clock, not the
laid-out offset, remains the analytical truth (spans/metrics use it).

Everything is derived from the recorded trace, deterministically: the same
trace always exports byte-identical JSON.
"""
from __future__ import annotations

import json

from .spans import EXEC_KINDS
from ..trace.schema import Trace, event_stolen

_QUEUE_TID_BASE = 1_000_000   # queue lanes sit far above real worker tids


def _worker_domains(trace: Trace) -> list[int]:
    return [int(d) for d in trace.meta.get("worker_domains", [])]


def chrome_trace_events(trace: Trace, *, step_us: int = 1000) -> list[dict]:
    """The trace-event list (see module docstring); ``export_chrome_trace``
    wraps it in the JSON envelope."""
    if step_us < 1:
        raise ValueError("step_us must be >= 1")
    wd = _worker_domains(trace)
    out: list[dict] = []

    # -- metadata: name/sort the domain processes and their lanes ------------
    for d in range(trace.num_domains):
        out.append({"ph": "M", "name": "process_name", "pid": d, "tid": 0,
                    "args": {"name": f"domain {d}"}})
        out.append({"ph": "M", "name": "process_sort_index", "pid": d,
                    "tid": 0, "args": {"sort_index": d}})
        out.append({"ph": "M", "name": "thread_name", "pid": d,
                    "tid": _QUEUE_TID_BASE + d, "args": {"name": "queue"}})
    for wid, d in enumerate(wd):
        out.append({"ph": "M", "name": "thread_name", "pid": d, "tid": wid,
                    "args": {"name": f"worker {wid}"}})

    # -- execution slices, steal flows, queue-depth counters -----------------
    depth = [0] * trace.num_domains
    batch_off: dict[tuple[int, int], float] = {}   # (step, worker) -> offset
    flow_id = 0
    for e in trace.events:
        ts = e.step * step_us
        if e.kind == "submit":
            if 0 <= e.domain < len(depth):
                depth[e.domain] += 1
                out.append({"ph": "C", "name": "queue depth", "pid": e.domain,
                            "tid": 0, "ts": ts,
                            "args": {"tasks": depth[e.domain]}})
            continue
        if e.kind not in EXEC_KINDS:
            continue
        src = e.src_domain if e.src_domain >= 0 else e.domain
        if 0 <= src < len(depth) and depth[src] > 0:
            depth[src] -= 1
            out.append({"ph": "C", "name": "queue depth", "pid": src,
                        "tid": 0, "ts": ts, "args": {"tasks": depth[src]}})
        pid = wd[e.worker] if 0 <= e.worker < len(wd) else e.domain
        key = (e.step, e.worker)
        start = ts + batch_off.get(key, 0.0)
        dur = max(e.service * step_us, 1.0)
        batch_off[key] = batch_off.get(key, 0.0) + dur
        out.append({"ph": "X", "name": f"{e.kind} t{e.task_uid}",
                    "cat": e.kind, "pid": pid, "tid": e.worker,
                    "ts": start, "dur": dur,
                    "args": {"uid": e.task_uid, "cost": e.cost,
                             "penalty": e.penalty, "src_domain": e.src_domain}})
        if event_stolen(e):
            flow_id += 1
            qtid = _QUEUE_TID_BASE + e.src_domain
            out.append({"ph": "i", "name": f"stolen t{e.task_uid}",
                        "cat": "steal", "s": "t", "pid": e.src_domain,
                        "tid": qtid, "ts": ts})
            out.append({"ph": "s", "name": "steal", "cat": "steal",
                        "id": flow_id, "pid": e.src_domain, "tid": qtid,
                        "ts": ts})
            out.append({"ph": "f", "bp": "e", "name": "steal", "cat": "steal",
                        "id": flow_id, "pid": pid, "tid": e.worker,
                        "ts": start})
    return out


def export_chrome_trace(trace: Trace, path, *, step_us: int = 1000):
    """Write ``trace`` as a Chrome trace-event JSON file; returns ``path``.

    The output is a complete Perfetto-loadable artifact: drag it into
    https://ui.perfetto.dev.  Conventionally named ``*.perfetto-trace`` or
    ``*.json``.
    """
    envelope = {
        "traceEvents": chrome_trace_events(trace, step_us=step_us),
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "repro.obs.export_chrome_trace",
            "governor": trace.meta.get("governor", ""),
            "num_domains": trace.num_domains,
            "total_steps": trace.total_steps,
            "step_us": step_us,
        },
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(envelope, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return path
