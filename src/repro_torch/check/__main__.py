"""``python -m repro_torch.check`` — the CI gate.

    python -m repro_torch.check                       # lint the tree
    python -m repro_torch.check --json R.json --md R.md
    python -m repro_torch.check model T.jsonl DIR/    # model-check traces
    python -m repro_torch.check all T.jsonl ...       # lint + model in one gate

Exit status 0 when the gate passes (zero unsuppressed lint findings, every
suppression reasoned, every checked trace structurally legal), 1 otherwise.
"""
from __future__ import annotations

import argparse
import sys

from .lint import lint_tree
from .model import ModelResult, check_path
from .report import CheckReport, render_markdown, write_json, write_markdown


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.check",
        description="determinism linter + trace model checker")
    ap.add_argument("mode", nargs="?", default="lint",
                    choices=("lint", "model", "all"),
                    help="lint the tree, model-check traces, or both")
    ap.add_argument("traces", nargs="*",
                    help="trace files / segment directories (model, all)")
    ap.add_argument("--root", default=None,
                    help="lint this package root instead of the installed "
                         "repro tree")
    ap.add_argument("--json", default=None, help="write the JSON report here")
    ap.add_argument("--md", default=None,
                    help="write the markdown report here")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the stdout report")
    args = ap.parse_args(argv)

    if args.mode in ("model", "all") and not args.traces:
        ap.error(f"mode {args.mode!r} needs at least one trace path")
    if args.mode == "lint" and args.traces:
        ap.error("mode 'lint' takes no trace paths (use 'model' or 'all')")

    lint = lint_tree(args.root) if args.mode in ("lint", "all") else []
    model: list[ModelResult] = []
    for path in args.traces:
        try:
            model.append(check_path(path))
        except Exception as exc:       # unreadable/unparseable trace
            from .rules import Violation
            model.append(ModelResult(path, [Violation(
                path, 1, "fidelity-keys", f"trace unreadable: {exc}")], []))

    report = CheckReport(lint=lint, model=model)
    if args.json:
        write_json(report, args.json)
    if args.md:
        write_markdown(report, args.md)
    if not args.quiet:
        print(render_markdown(report))
    return 0 if report.gate() else 1


if __name__ == "__main__":
    sys.exit(main())
