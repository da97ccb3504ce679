"""repro.check — static guarantees for the record/replay stack.

Everything this reproduction claims — bit-identical replay (the paper's
A/B methodology for locality queues), obs passivity, controller purity —
rests on the *absence* of nondeterminism in ``src/repro/``.  Until now
that was enforced only dynamically, by golden tests that can miss a code
path; with ROADMAP item 2 about to rewrite the scheduler hot path (heap
victim selection, numpy ring buffers, columnar traces), this package adds
the static half of the gate:

  ``check.lint`` + ``check.purity``   the determinism linter: AST rules
      over the tree (wall-clock, unseeded RNG, unordered iteration,
      id()-ordering, environment reads, live state views) plus a
      cross-module call-graph walk proving every registered executor hook
      pure.  ``# repro: allow[rule] reason`` suppressions are the audited
      escape hatch.
  ``check.model``   the trace model checker: a happens-before verifier
      over any recorded v1–v4 trace (submit/exec uniqueness, per-domain
      FIFO legality, steal edges the header's DistanceMatrix permits,
      monotone step clocks, well-nested span trees, footer/stream
      agreement).

Usage::

    from repro_torch import check

    bad = [v for v in check.lint_tree() if not v.suppressed]
    result = check.check_path("run.trace.jsonl")   # ModelResult
    assert result.ok, result.violations

    python -m repro_torch.check all run.trace.jsonl      # the CI gate
"""
from .lint import lint_source, lint_tree, repro_root
from .model import ModelResult, check_path, check_trace
from .purity import check_hook_purity
from .report import (CheckReport, render_markdown, write_json,
                     write_markdown)
from .rules import (ALL_RULES, LINT_RULES, MODEL_RULES, Rule, Suppression,
                    Violation, apply_suppressions, parse_suppressions)

__all__ = [
    "lint_source", "lint_tree", "repro_root",
    "ModelResult", "check_path", "check_trace",
    "check_hook_purity",
    "CheckReport", "render_markdown", "write_json", "write_markdown",
    "ALL_RULES", "LINT_RULES", "MODEL_RULES", "Rule", "Suppression",
    "Violation", "apply_suppressions", "parse_suppressions",
]
