"""Render blame tables and trace diffs as markdown/text reports.

``critpath`` and ``diff`` produce structured data; this module turns them
into the human-facing artifacts the CI sentinel uploads and ``benchmarks/
run.py --compare`` prints.  Rendering is deliberately dumb — fixed column
orders, ``%g`` number formatting, no wall-clock or environment input — so
the same report input always yields the same bytes (the reports diff
cleanly across CI runs, like every other artifact in this repo).
"""
from __future__ import annotations

from typing import Any, Iterable, Sequence

from .critpath import PHASES, BlameReport
from .diff import TraceDiff


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:g}"
    return str(v)


def markdown_table(headers: Sequence[str],
                   rows: Iterable[Sequence[Any]]) -> str:
    """A GitHub-flavored markdown table (no column padding games — plain
    pipes render everywhere and keep the bytes deterministic)."""
    out = ["| " + " | ".join(str(h) for h in headers) + " |",
           "|" + "|".join(" --- " for _ in headers) + "|"]
    for row in rows:
        out.append("| " + " | ".join(_fmt(c) for c in row) + " |")
    return "\n".join(out)


def render_blame(report: BlameReport, k: int = 10,
                 title: str = "Critical-path blame") -> str:
    """Markdown report of one trace's sojourn attribution: phase totals,
    per-domain and per-level blame tables, dominant contributors, and the
    ``k`` worst tasks with their own phase splits."""
    t = report.totals
    lines = [f"## {title}", "",
             f"{int(t['tasks'])} tasks observed"
             + (f" ({len(report.missing)} outside the event window)"
                if report.missing else "")
             + f", total sojourn {t['total']:g} steps:", "",
             markdown_table(
                 ["phase", "blame (steps)", "share"],
                 [[p, t[p], f"{t[p] / max(t['total'], 1e-12):.1%}"]
                  for p in PHASES]),
             "", "### By domain",
             "(queue-wait charged to the routed queue; transfer/exec to "
             "the executing domain)", "",
             markdown_table(
                 ["domain", "queue_wait", "steal_transfer", "exec", "total",
                  "tasks"],
                 [[d, r["queue_wait"], r["steal_transfer"], r["exec"],
                   r["total"], int(r["tasks"])]
                  for d, r in sorted(report.by_domain.items())]),
             "", "### By topology level",
             "(level 0 = executed local; level 2+ crossed a socket/pod)",
             "",
             markdown_table(
                 ["level", "queue_wait", "steal_transfer", "exec", "total",
                  "tasks"],
                 [[lv, r["queue_wait"], r["steal_transfer"], r["exec"],
                   r["total"], int(r["tasks"])]
                  for lv, r in sorted(report.by_level.items())]),
             "", "### Dominant contributors", "",
             markdown_table(
                 ["rank", "phase", "domain", "blame", "share"],
                 [[i + 1, c["phase"], c["domain"], c["blame"],
                   f"{c['share']:.1%}"]
                  for i, c in enumerate(report.dominant_contributors(k))]),
             "", f"### Top {k} tasks by sojourn", "",
             markdown_table(
                 ["uid", "sojourn", "dominant", "queue_wait",
                  "steal_transfer", "exec", "routed", "exec_domain",
                  "level"],
                 [[b.uid, b.sojourn, b.dominant, b.queue_wait,
                   b.steal_transfer, b.exec, b.routed, b.exec_domain,
                   b.level]
                  for b in report.top(k)])]
    return "\n".join(lines) + "\n"


def render_diff(diff: TraceDiff, label_a: str = "A",
                label_b: str = "B",
                title: str = "Trace diff") -> str:
    """Markdown report of a ``diff_traces`` comparison: headline verdict,
    significant percentile shifts, stats deltas, per-phase distribution
    movement, and steal-matrix movement by level."""
    lines = [f"## {title}: {label_a} vs {label_b}", ""]
    if diff.is_zero:
        lines += ["**Identical**: every recorded delta is exactly zero.",
                  ""]
    sig = diff.significant_shifts()
    lines += [f"Tasks observed: {diff.tasks.a:g} -> {diff.tasks.b:g}.",
              "", "### Percentile shifts (exact nearest-rank; significant "
              f"at >= max({diff.min_abs:g} steps, {diff.min_rel:.0%}))", "",
              markdown_table(
                  ["metric", "q", label_a, label_b, "delta", "significant"],
                  [[m, q, s.a, s.b, f"{s.delta:+g}",
                    "yes" if s.significant else "no"]
                   for m, qs in diff.percentile_shifts.items()
                   for q, s in qs.items()])]
    if not diff.percentile_shifts:
        lines.append("(no observed tasks on one side — no percentiles)")
    lines += ["",
              f"{sum(len(v) for v in sig.values())} significant shift(s).",
              "", "### RuntimeStats deltas", "",
              markdown_table(
                  ["stat", label_a, label_b, "delta"],
                  [[k, s.a, s.b, f"{s.delta:+g}"]
                   for k, s in sorted(diff.stats.items())
                   if s.delta != 0] or [["(all equal)", "", "", ""]]),
              "", "### Phase distribution movement (shared fixed buckets)",
              "",
              markdown_table(
                  ["phase", f"n {label_a}", f"n {label_b}",
                   f"mean {label_a}", f"mean {label_b}", "samples moved"],
                  [[p, h.count_a, h.count_b, h.mean_a, h.mean_b, h.moved]
                   for p, h in diff.phases.items()]),
              "", "### Steals by topology level", "",
              markdown_table(
                  ["level", label_a, label_b, "delta"],
                  [[lv, int(s.a), int(s.b), f"{s.delta:+g}"]
                   for lv, s in sorted(diff.steal_levels.items())]
                  or [["(no steals)", "", "", ""]])]
    moved = [((src, dst), s) for (src, dst), s
             in sorted(diff.steal_matrix.items()) if s.delta != 0]
    if moved:
        lines += ["", "### Steal matrix movement (victim -> thief)", "",
                  markdown_table(
                      ["link", label_a, label_b, "delta"],
                      [[f"{src}->{dst}", int(s.a), int(s.b),
                        f"{s.delta:+g}"] for (src, dst), s in moved])]
    return "\n".join(lines) + "\n"
