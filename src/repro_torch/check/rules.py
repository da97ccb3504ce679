"""The rule catalog: names, scopes, and the suppression contract.

Every finding either head of ``repro.check`` produces — the determinism
linter (``check.lint`` + ``check.purity``) and the trace model checker
(``check.model``) — carries a *rule name* from the catalog below, so CI
output, suppression comments, and the mutation tests all speak the same
vocabulary.

Lint rules are *scoped*: each applies only inside the deterministic core of
``src/repro/`` (the record/replay stack), never to the jax/model side of the
tree, which legitimately reads clocks and draws device RNG.  The scope of a
rule is a tuple of top-level package names relative to the ``repro`` root.

Suppressions
------------
A violation is silenced inline with::

    # repro: allow[rule-name] why this site is sanctioned

placed on the flagged line or on the line immediately above it.  The reason
text is mandatory — a bare ``allow[...]`` (or one naming an unknown rule) is
itself a violation (``bad-suppression``), so the shipped tree can never
accumulate unexplained escapes.  Suppressed findings stay in the JSON report
(``suppressed: true`` with the reason) for auditability.
"""
from __future__ import annotations

import dataclasses
import io
import re
import tokenize

# the deterministic core: every package whose behaviour the record/replay
# guarantee depends on.  (models/train/kernels/launch/... are the jax side —
# wall clocks and device RNG are their job, not a hazard.)
CORE_PACKAGES = ("runtime", "trace", "control", "spec", "obs", "topology",
                 "check")
# the subset making scheduling *decisions* (iteration order is schedule order)
SCHEDULING_PACKAGES = ("runtime", "control", "topology", "trace")
# the subset the issue bans environment reads from outright
ENV_PACKAGES = ("runtime", "control", "obs")
# governor/hook state lives here (live-view returns leak governor state)
STATE_PACKAGES = ("runtime", "control", "trace")


@dataclasses.dataclass(frozen=True)
class Rule:
    """One named check: what it flags and where it applies."""

    name: str
    scope: tuple[str, ...]
    summary: str


LINT_RULES: dict[str, Rule] = {r.name: r for r in (
    Rule("wall-clock", CORE_PACKAGES,
         "wall-clock read (time.time/perf_counter*/datetime.now) outside "
         "the sanctioned profiler sites"),
    Rule("unseeded-rng", CORE_PACKAGES,
         "unseeded RNG: stdlib random.*, numpy np.random.* module "
         "functions, or default_rng() without a seed"),
    Rule("unordered-iter", SCHEDULING_PACKAGES,
         "iteration over a set/frozenset (or a dict built from one) in "
         "scheduling code — iteration order is schedule order"),
    Rule("id-order", CORE_PACKAGES,
         "id()-based ordering or keying — object addresses differ across "
         "runs"),
    Rule("env-read", ENV_PACKAGES,
         "os.environ / os.getenv read in runtime/control/obs — "
         "configuration must arrive through specs"),
    Rule("state-view", STATE_PACKAGES,
         "public accessor returns a live mutable container attribute — "
         "callers could mutate governor state through it"),
    Rule("hook-purity", CORE_PACKAGES,
         "function registered as a submit/step/router/batch/governor hook "
         "reaches wall-clock, unseeded RNG, environment, or I/O"),
    Rule("bad-suppression", CORE_PACKAGES,
         "a `# repro: allow[...]` comment without a reason, or naming an "
         "unknown rule"),
)}

MODEL_RULES: dict[str, Rule] = {r.name: r for r in (
    Rule("fidelity-keys", ("trace",),
         "header/footer is missing a replay-fidelity key required by its "
         "schema version, or carries an inconsistent one"),
    Rule("submit-unique", ("trace",),
         "a task uid was submitted more than once (or the submission "
         "records disagree with the submit events)"),
    Rule("exec-unique", ("trace",),
         "a task uid was executed more than once"),
    Rule("exec-unsubmitted", ("trace",),
         "an executed task uid was never submitted"),
    Rule("fifo-order", ("trace",),
         "a domain queue was served out of FIFO order (or popped while "
         "empty)"),
    Rule("steal-level", ("trace",),
         "a steal edge the header's DistanceMatrix/governor forbids: "
         "domain outside the matrix, a steal under NoSteal, or a deep-tier "
         "steal while a nearer tier held eligible work under GreedySteal"),
    Rule("local-first", ("trace",),
         "a worker stole while its own domain queue held work"),
    Rule("step-monotone", ("trace",),
         "event timestamps (scheduling rounds) regressed in stream order "
         "or per worker"),
    Rule("span-nesting", ("trace",),
         "a reconstructed per-task span tree is not well-nested"),
    Rule("stats-consistency", ("trace",),
         "footer RuntimeStats disagree with the recorded event stream"),
)}

ALL_RULES: dict[str, Rule] = {**LINT_RULES, **MODEL_RULES}


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding, from either head.

    ``file``/``line`` locate it (the trace path and record ordinal for
    model findings); ``suppressed`` marks findings silenced by a reasoned
    ``# repro: allow[...]`` comment — they never fail the gate but stay in
    the report.
    """

    file: str
    line: int
    rule: str
    message: str
    suppressed: bool = False
    reason: str | None = None

    def to_dict(self) -> dict:
        return {"file": self.file, "line": self.line, "rule": self.rule,
                "message": self.message, "suppressed": self.suppressed,
                "reason": self.reason}

    def __str__(self) -> str:
        mark = " [suppressed]" if self.suppressed else ""
        return f"{self.file}:{self.line}: {self.rule}: {self.message}{mark}"


@dataclasses.dataclass(frozen=True)
class Suppression:
    """One parsed ``# repro: allow[rule] reason`` comment."""

    line: int
    rule: str
    reason: str


SUPPRESS_RE = re.compile(
    r"#\s*repro:\s*allow\[([^\]]*)\]\s*[-—:]?\s*(.*?)\s*$")


def parse_suppressions(source: str,
                       path: str) -> tuple[list[Suppression],
                                           list[Violation]]:
    """Extract suppression comments and flag malformed ones.

    Returns ``(suppressions, bad_suppression_violations)``.  A suppression
    must name a known rule and carry a non-empty reason; anything else is a
    ``bad-suppression`` finding (which itself cannot be suppressed).
    """
    sups: list[Suppression] = []
    bad: list[Violation] = []
    try:
        comments = [(tok.start[0], tok.string) for tok in
                    tokenize.generate_tokens(io.StringIO(source).readline)
                    if tok.type == tokenize.COMMENT]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        # unparseable source: fall back to raw lines so suppressions in a
        # broken file are still audited
        comments = list(enumerate(source.splitlines(), start=1))
    for lineno, text in comments:
        m = SUPPRESS_RE.search(text)
        if m is None:
            continue
        rule, reason = m.group(1).strip(), m.group(2).strip()
        if rule not in ALL_RULES:
            bad.append(Violation(path, lineno, "bad-suppression",
                                 f"allow[{rule}] names an unknown rule "
                                 f"(known: {sorted(ALL_RULES)})"))
        elif not reason:
            bad.append(Violation(path, lineno, "bad-suppression",
                                 f"allow[{rule}] carries no reason — every "
                                 "suppression must say why the site is "
                                 "sanctioned"))
        else:
            sups.append(Suppression(lineno, rule, reason))
    return sups, bad


def apply_suppressions(violations: list[Violation],
                       suppressions: list[Suppression]) -> list[Violation]:
    """Mark violations covered by a suppression on their own line or the
    line immediately above.  ``bad-suppression`` findings are never
    silenced."""
    by_line: dict[tuple[int, str], Suppression] = {
        (s.line, s.rule): s for s in suppressions}
    out: list[Violation] = []
    for v in violations:
        sup = None
        if v.rule != "bad-suppression":
            sup = (by_line.get((v.line, v.rule))
                   or by_line.get((v.line - 1, v.rule)))
        if sup is None:
            out.append(v)
        else:
            out.append(dataclasses.replace(v, suppressed=True,
                                           reason=sup.reason))
    return out


def package_of(relpath: str) -> str:
    """Top-level package of a path relative to the ``repro`` root
    (``runtime/executor.py`` -> ``runtime``; bare modules -> """")."""
    rel = relpath.replace("\\", "/")
    return rel.split("/", 1)[0] if "/" in rel else ""


def in_scope(rule: str, package: str) -> bool:
    r = ALL_RULES.get(rule)
    return r is not None and package in r.scope
