"""Validate checked-in spec files: parse, build, drive, replay.

    PYTHONPATH=src python -m repro_torch.spec.validate specs [specs/experiments ...]

For every ``*.json`` under the given paths (directories are globbed,
files taken as-is) this:

  1. parses it strictly (``RuntimeSpec.from_json`` — unknown fields or an
     unknown ``spec_version`` fail the run);
  2. proves the canonical round-trip: ``from_json(to_json(s)) == s``;
  3. builds the declared system (executor + control loop + recorder);
  4. drives a small seeded hot-skew workload through it while recording;
  5. serializes the trace and replays it *from the embedded header spec
     alone* (``replay(trace)``, no executor argument), asserting the
     replayed ``RuntimeStats`` are bit-identical to the recorded ones;
  6. model-checks the trace (``repro.check``): the recorded schedule must
     be structurally legal — FIFO per domain queue, steal edges the header
     permits, monotone steps, exact-once submit/exec — not just
     stats-identical under replay.

*Experiment* files (``repro.spec.ExperimentSpec``: a ``workload`` block
next to the ``policy``, e.g. ``specs/experiments/*.json``) are detected by
shape and validated end to end instead: parse strictly, round-trip
exactly, then ``run()`` the *declared* workload (all repeats) and assert
every recorded trace replays bit-identically from its own header.

Exit code 0 means every file names a buildable, exactly-reproducible
system — the CI gate behind ``make spec`` / ``make experiments``.
"""
from __future__ import annotations

import glob
import json
import os
import sys

from .experiments import ExperimentSpec
from .model import RuntimeSpec, SpecError


def probe_trace(spec: RuntimeSpec):
    """Build ``spec``'s system, drive the standard seeded hot-skew probe
    workload through it while recording, and return the trace after a
    JSONL round-trip — the shared raw material for header-only replay
    validation here and for model-checking in ``benchmarks.sentinel``."""
    from ..trace import (TraceRecorder, drive, hot_skew, loads_lines,
                         dumps_lines, poisson)

    built = spec.build()
    ex = built.executor
    recorder = built.recorder
    if recorder is None:
        recorder = TraceRecorder()
        recorder.attach(ex)
    wl = hot_skew(poisson(rate=spec.num_domains, steps=12,
                          num_domains=spec.num_domains, seed=spec.seed + 1),
                  hot_domain=0, p_hot=0.75, seed=spec.seed + 1)
    drive(ex, wl)
    return loads_lines(dumps_lines(recorder.finish()))


def model_check(trace, label: str) -> None:
    """Run ``repro.check``'s trace model checker; raise ``SpecError`` on
    any structural-legality violation (named rule included)."""
    from ..check import check_trace

    result = check_trace(trace, path=label)
    if not result.ok:
        raise SpecError(
            "trace model checker found an illegal schedule: "
            + "; ".join(str(v) for v in result.violations[:5]))


def validate_spec(spec: RuntimeSpec) -> dict[str, float]:
    """Round-trip + probe-drive + header-only replay + model check for one
    spec.

    Returns the recorded stats snapshot.  Raises (``SpecError`` /
    ``AssertionError``) on any fidelity failure.
    """
    from ..trace import replay

    if spec.from_json(spec.to_json()) != spec:
        raise SpecError("canonical round-trip changed the spec")

    trace = probe_trace(spec)
    if trace.meta.get("spec") is None:
        raise SpecError("built executor did not embed its spec in the "
                        "trace header")
    replay(trace, assert_match=True)             # header-only reconstruction
    model_check(trace, "<probe>")                # structural legality
    return trace.stats


def validate_experiment(exp: ExperimentSpec) -> dict[str, float]:
    """Round-trip + run + header-only replay for one experiment spec.

    Unlike ``validate_spec`` (which drives a synthetic probe workload),
    this runs the experiment's *declared* workload — the whole point of an
    experiment file — and checks every repeat's trace replays
    bit-identically through the JSONL wire format.  Returns the first
    repeat's recorded stats.
    """
    from ..trace import dumps_lines, loads_lines, replay

    if exp.from_json(exp.to_json()) != exp:
        raise SpecError("canonical round-trip changed the experiment")
    result = exp.run()
    for r, run in enumerate(result.runs):
        trace = loads_lines(dumps_lines(run.trace))
        if trace.meta.get("spec") is None:
            raise SpecError("experiment executor did not embed its spec in "
                            "the trace header")
        if trace.meta.get("experiment") is None:
            raise SpecError("experiment executor did not embed the "
                            "experiment in the trace header")
        replay(trace, assert_match=True)         # header-only reconstruction
        model_check(trace, f"<repeat {r}>")      # structural legality
    return result.primary.trace.stats


def validate_file(path) -> tuple[str, dict[str, float]]:
    """Validate one JSON file, dispatching on shape: a ``workload`` block
    marks an ``ExperimentSpec``, anything else is parsed as a bare policy
    ``RuntimeSpec`` (whose strict parser also reports malformed JSON).
    Returns ``(kind_label, recorded_stats)``."""
    with open(path, "r", encoding="utf-8") as fh:
        text = fh.read()
    try:
        data = json.loads(text)
    except json.JSONDecodeError:
        data = None                    # let the strict spec parser report it
    if isinstance(data, dict) and "workload" in data:
        return "experiment ", validate_experiment(
            ExperimentSpec.from_dict(data))
    return "", validate_spec(RuntimeSpec.from_json(text))


def iter_spec_files(paths) -> list[str]:
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob.glob(os.path.join(p, "*.json"))))
        else:
            out.append(p)
    return out


def main(argv: list[str]) -> int:
    paths = iter_spec_files(argv or ["specs"])
    if not paths:
        print("no spec files found", file=sys.stderr)
        return 1
    failures = 0
    for path in paths:
        try:
            kind, stats = validate_file(path)
            print(f"{path}: {kind}OK (executed={stats['executed']:.0f}, "
                  f"local={stats['local_fraction']:.2f}, "
                  f"steal={stats['steal_fraction']:.2f})")
        except Exception as e:                    # report all files, then fail
            failures += 1
            print(f"{path}: FAIL — {e}", file=sys.stderr)
    if failures:
        print(f"{failures}/{len(paths)} spec file(s) failed", file=sys.stderr)
        return 1
    print(f"all {len(paths)} spec file(s) parse, build, and replay "
          "bit-identically")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
