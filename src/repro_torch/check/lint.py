"""Head 1: the determinism linter — an AST pass over ``src/repro/``.

Determinism in this repo is a *source-level* property: the executor steps
workers in a fixed order, every RNG is a seeded ``default_rng``, and the
only clock any decision may read is the step counter.  The linter proves
the cheap half of that statically, per rule (see ``rules.LINT_RULES``):

  wall-clock      no ``time.time`` / ``perf_counter*`` / ``datetime.now``
                  outside explicitly suppressed profiler sites
  unseeded-rng    no stdlib ``random``, no ``np.random.<fn>`` module calls,
                  no ``default_rng()`` without a seed argument
  unordered-iter  no iteration over set/frozenset values in scheduling code
  id-order        no ``id()`` anywhere in the core (addresses vary per run)
  env-read        no ``os.environ`` / ``os.getenv`` in runtime/control/obs
  state-view      no public method returning a live mutable container
                  attribute (callers could mutate governor state through it)

``hook-purity`` is the expensive half and lives in ``check.purity`` (it
needs a cross-module call graph); both heads share the suppression and
report machinery here.
"""
from __future__ import annotations

import ast
import os
from typing import Iterable

from .rules import (Violation, apply_suppressions, in_scope, package_of,
                    parse_suppressions)

# clock functions per module: reading any of these inside the core makes a
# decision (or a recorded value) depend on wall time
TIME_FUNCS = frozenset({
    "time", "time_ns", "perf_counter", "perf_counter_ns", "monotonic",
    "monotonic_ns", "process_time", "process_time_ns", "clock_gettime",
    "clock_gettime_ns"})
DATETIME_FUNCS = frozenset({"now", "utcnow", "today"})
# np.random module-level functions that draw from the hidden global state;
# constructing generators/seeds is fine — *using* the global stream is not
NP_RANDOM_OK = frozenset({"default_rng", "Generator", "SeedSequence",
                          "PCG64", "Philox", "BitGenerator"})
# constructors whose results are order-unstable across runs when iterated
MUTABLE_CTORS = frozenset({"dict", "list", "set", "defaultdict", "deque",
                           "OrderedDict", "Counter"})


def repro_root() -> str:
    """Absolute path of the ``repro`` package being linted (this tree)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def iter_source_files(root: str | None = None) -> Iterable[tuple[str, str]]:
    """Yield ``(abspath, relpath)`` for every ``.py`` under the repro root,
    sorted so reports and suppression audits are stable."""
    root = root or repro_root()
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                ap = os.path.join(dirpath, fn)
                out.append((ap, os.path.relpath(ap, root)))
    return out


class _Imports(ast.NodeVisitor):
    """Track how time/datetime/random/numpy/os are visible in a module."""

    def __init__(self) -> None:
        self.modules: dict[str, str] = {}   # local name -> module it names
        self.members: dict[str, tuple[str, str]] = {}  # name -> (module, attr)

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self.modules[a.asname or a.name.split(".")[0]] = a.name

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module is None or node.level:
            return                       # relative imports are repro-internal
        for a in node.names:
            self.members[a.asname or a.name] = (node.module, a.name)


def module_imports(tree: ast.AST) -> _Imports:
    imp = _Imports()
    imp.visit(tree)
    return imp


def call_target(node: ast.Call, imp: _Imports) -> tuple[str, str] | None:
    """Resolve a call to ``(module, func)`` when its callee is a plain
    imported module attribute (``time.time()``) or a from-imported name
    (``perf_counter_ns()``).  Dotted module imports (``os.path``) resolve to
    their root module."""
    f = node.func
    if isinstance(f, ast.Name):
        return imp.members.get(f.id)
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        mod = imp.modules.get(f.value.id)
        if mod is not None:
            return (mod, f.attr)
        member = imp.members.get(f.value.id)
        if member is not None:           # e.g. from datetime import datetime
            return (f"{member[0]}.{member[1]}", f.attr)
    return None


def is_wall_clock(node: ast.Call, imp: _Imports) -> bool:
    tgt = call_target(node, imp)
    if tgt is None:
        # np.datetime64('now') style is out of core scope; handle the common
        # datetime.datetime.now() chain explicitly
        f = node.func
        if (isinstance(f, ast.Attribute) and f.attr in DATETIME_FUNCS
                and isinstance(f.value, ast.Attribute)
                and f.value.attr == "datetime"
                and isinstance(f.value.value, ast.Name)
                and imp.modules.get(f.value.value.id) == "datetime"):
            return True
        return False
    mod, fn = tgt
    if mod == "time" and fn in TIME_FUNCS:
        return True
    if mod in ("datetime", "datetime.datetime") and fn in DATETIME_FUNCS:
        return True
    return False


def rng_violation(node: ast.Call, imp: _Imports) -> str | None:
    """Return a message when ``node`` draws nondeterministic randomness."""
    f = node.func
    # stdlib random: module functions and from-imports alike share one
    # hidden, unseeded-by-default global state
    tgt = call_target(node, imp)
    if tgt is not None and tgt[0] == "random":
        return f"stdlib random.{tgt[1]}() draws from hidden global state"
    # np.random.<fn>(...) — the legacy global stream
    if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Attribute)
            and f.value.attr == "random"
            and isinstance(f.value.value, ast.Name)
            and imp.modules.get(f.value.value.id) == "numpy"
            and f.attr not in NP_RANDOM_OK):
        return (f"np.random.{f.attr}() uses the global numpy stream — "
                "use a seeded default_rng Generator")
    # default_rng() with no seed argument
    is_default_rng = (
        (tgt is not None and tgt == ("numpy.random", "default_rng"))
        or (isinstance(f, ast.Attribute) and f.attr == "default_rng"))
    if is_default_rng and not node.args and not node.keywords:
        return "default_rng() without a seed is entropy-seeded"
    return None


def env_violation(node: ast.AST, imp: _Imports) -> str | None:
    if isinstance(node, ast.Attribute) and node.attr == "environ" \
            and isinstance(node.value, ast.Name) \
            and imp.modules.get(node.value.id) == "os":
        return "os.environ read"
    if isinstance(node, ast.Call):
        tgt = call_target(node, imp)
        if tgt in (("os", "getenv"), ("os", "environ")):
            return "os.getenv() read"
        if tgt is not None and tgt == ("os", "getenv"):
            return "os.getenv() read"
    if isinstance(node, ast.Name) and node.id in imp.members \
            and imp.members[node.id] == ("os", "environ"):
        return "os.environ read (from-import)"
    return None


def _is_unordered_expr(node: ast.AST,
                       set_names: set[str]) -> bool:
    """Does ``node`` evaluate to a set (or a dict keyed off one)?"""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    if isinstance(node, ast.Name) and node.id in set_names:
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id == "dict" and node.args \
            and _is_unordered_expr(node.args[0], set_names):
        return True
    return False


class _FileLinter(ast.NodeVisitor):
    def __init__(self, path: str, package: str, imp: _Imports):
        self.path = path
        self.package = package
        self.imp = imp
        self.violations: list[Violation] = []
        self._set_names: list[set[str]] = [set()]   # per-function scopes

    def flag(self, rule: str, node: ast.AST, message: str) -> None:
        if in_scope(rule, self.package):
            self.violations.append(
                Violation(self.path, getattr(node, "lineno", 1), rule,
                          message))

    # -- scope tracking for unordered-iter ----------------------------------
    def _in_function(self, node: ast.AST) -> None:
        self._set_names.append(set())
        self.generic_visit(node)
        self._set_names.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._in_function(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._in_function(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        if _is_unordered_expr(node.value, self._set_names[-1]):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self._set_names[-1].add(t.id)
        else:
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self._set_names[-1].discard(t.id)
        self.generic_visit(node)

    # -- the rules -----------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        if is_wall_clock(node, self.imp):
            self.flag("wall-clock", node,
                      "wall-clock read in the deterministic core")
        msg = rng_violation(node, self.imp)
        if msg is not None:
            self.flag("unseeded-rng", node, msg)
        if isinstance(node.func, ast.Name) and node.func.id == "id" \
                and node.args:
            self.flag("id-order", node,
                      "id() keys/orders by object address, which varies "
                      "across runs")
        env = env_violation(node, self.imp)
        if env is not None:
            self.flag("env-read", node, env)
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        env = env_violation(node, self.imp)
        if env is not None:
            self.flag("env-read", node, env)
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        if _is_unordered_expr(node.iter, self._set_names[-1]):
            self.flag("unordered-iter", node,
                      "iteration over a set — order is hash-seed dependent; "
                      "sort first")
        self.generic_visit(node)

    def visit_comprehension_iter(self, node: ast.expr) -> None:
        if _is_unordered_expr(node, self._set_names[-1]):
            self.flag("unordered-iter", node,
                      "comprehension over a set — order is hash-seed "
                      "dependent; sort first")

    def _visit_comp(self, node) -> None:
        for gen in node.generators:
            self.visit_comprehension_iter(gen.iter)
        self.generic_visit(node)

    visit_ListComp = visit_SetComp = visit_DictComp = _visit_comp
    visit_GeneratorExp = _visit_comp

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._check_state_views(node)
        self.generic_visit(node)

    def _check_state_views(self, cls: ast.ClassDef) -> None:
        """state-view: public methods returning ``self._x`` where ``_x`` was
        initialized to a mutable container in this class."""
        mutable_attrs: set[str] = set()
        for stmt in ast.walk(cls):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                t = stmt.targets[0]
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    v = stmt.value
                    is_mut = isinstance(v, (ast.Dict, ast.List, ast.Set,
                                            ast.ListComp, ast.SetComp,
                                            ast.DictComp))
                    if isinstance(v, ast.Call) \
                            and isinstance(v.func, ast.Name) \
                            and v.func.id in MUTABLE_CTORS:
                        is_mut = True
                    if is_mut:
                        mutable_attrs.add(t.attr)
        if not mutable_attrs:
            return
        for item in cls.body:
            if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if item.name.startswith("_"):
                continue                  # private surface may share views
            for ret in ast.walk(item):
                if isinstance(ret, ast.Return) \
                        and isinstance(ret.value, ast.Attribute) \
                        and isinstance(ret.value.value, ast.Name) \
                        and ret.value.value.id == "self" \
                        and ret.value.attr in mutable_attrs:
                    self.flag("state-view", ret,
                              f"{cls.name}.{item.name} returns the live "
                              f"mutable attribute self.{ret.value.attr} — "
                              "return a copy")


def lint_source(source: str, relpath: str) -> list[Violation]:
    """Lint one module's source; returns suppression-applied violations
    (including ``bad-suppression`` findings)."""
    package = package_of(relpath)
    tree = ast.parse(source, filename=relpath)
    imp = module_imports(tree)
    linter = _FileLinter(relpath, package, imp)
    linter.visit(tree)
    sups, bad = parse_suppressions(source, relpath)
    return apply_suppressions(linter.violations, sups) + bad


def lint_tree(root: str | None = None) -> list[Violation]:
    """Lint every module under the repro root (plus the cross-module
    hook-purity pass); returns all findings, suppressed ones included."""
    from .purity import check_hook_purity     # avoid import cycle
    files = list(iter_source_files(root))
    sources = {rel: open(ap, "r", encoding="utf-8").read()
               for ap, rel in files}
    violations: list[Violation] = []
    for rel, src in sources.items():
        violations += lint_source(src, rel)
    violations += check_hook_purity(sources)
    violations.sort(key=lambda v: (v.file, v.line, v.rule))
    return violations
