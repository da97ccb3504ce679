"""JSON + markdown rendering of check results.

One report object carries both heads: the lint findings over the tree
(suppressed ones included, with their reasons — the suppression ledger is
part of the artifact CI uploads) and the model-check results per trace.
``gate()`` is the single pass/fail predicate ``make check`` exits on.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

from .model import ModelResult
from .rules import ALL_RULES, Violation


@dataclasses.dataclass
class CheckReport:
    lint: list[Violation]
    model: list[ModelResult]

    @property
    def active(self) -> list[Violation]:
        """Unsuppressed lint findings — each one fails the gate."""
        return [v for v in self.lint if not v.suppressed]

    @property
    def suppressed(self) -> list[Violation]:
        return [v for v in self.lint if v.suppressed]

    def gate(self) -> bool:
        """True when the tree and every checked trace are clean."""
        return not self.active and all(m.ok for m in self.model)

    def to_dict(self) -> dict[str, Any]:
        return {
            "ok": self.gate(),
            "lint": {
                "active": [v.to_dict() for v in self.active],
                "suppressed": [v.to_dict() for v in self.suppressed],
            },
            "model": [m.to_dict() for m in self.model],
            "rules": {name: r.summary for name, r in sorted(ALL_RULES.items())},
        }


def _write(path: str, text: str) -> None:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(text)


def write_json(report: CheckReport, path: str) -> None:
    _write(path, json.dumps(report.to_dict(), indent=2, sort_keys=True)
           + "\n")


def render_markdown(report: CheckReport) -> str:
    from ..obs.report import markdown_table
    lines = ["# repro.check report", ""]
    verdict = "PASS" if report.gate() else "FAIL"
    lines += [f"**Gate: {verdict}** — {len(report.active)} active lint "
              f"finding(s), {len(report.suppressed)} suppressed, "
              f"{sum(len(m.violations) for m in report.model)} model "
              f"violation(s) over {len(report.model)} trace(s).", ""]
    if report.active:
        lines += ["## Active lint findings", "",
                  markdown_table(
                      ["file", "line", "rule", "message"],
                      [[v.file, v.line, v.rule, v.message]
                       for v in report.active]), ""]
    if report.suppressed:
        lines += ["## Suppressions (the sanctioned-sites ledger)", "",
                  markdown_table(
                      ["file", "line", "rule", "reason"],
                      [[v.file, v.line, v.rule, v.reason or ""]
                       for v in report.suppressed]), ""]
    if report.model:
        lines += ["## Model-checked traces", "",
                  markdown_table(
                      ["trace", "verdict", "violations", "notes"],
                      [[m.path, "ok" if m.ok else "FAIL",
                        len(m.violations), "; ".join(m.notes)]
                       for m in report.model]), ""]
        bad = [(m.path, v) for m in report.model for v in m.violations]
        if bad:
            lines += ["### Model violations", "",
                      markdown_table(
                          ["trace", "record", "rule", "message"],
                          [[p, v.line, v.rule, v.message]
                           for p, v in bad]), ""]
    return "\n".join(lines)


def write_markdown(report: CheckReport, path: str) -> None:
    _write(path, render_markdown(report))
