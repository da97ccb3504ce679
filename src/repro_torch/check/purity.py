"""Hook purity: the call-graph half of the determinism linter.

The executor exposes five plug points — ``submit_hook``, ``step_hook``,
``router``, ``batch``, ``governor`` — and the whole record/replay guarantee
assumes everything plugged in is a *pure observer of deterministic executor
state*: it may read queue depths, stats, and step counters, but the moment a
hook touches wall clock, hidden RNG, the environment, or I/O, the schedule
(or the recorded trace) can differ between a run and its replay.

This pass finds every hook registration site across ``src/repro/``
(attribute assignments ``x.submit_hook = f`` and constructor keywords
``Executor(..., router=f)``), resolves each registered value to function
roots — a method, a module function, a lambda, or every public method of a
governor/batch class — and walks the static call graph underneath.  Any
reachable *impurity primitive* (clock read, global RNG draw, environment
read, ``open``/``print``/``subprocess``/... I/O) is reported as a
``hook-purity`` violation at the impure call site, naming the hook root it
is reachable from, so a sanctioned site (the streaming trace writer) can be
suppressed exactly where the impurity lives.

Resolution is name-based and deliberately over-approximate: ``self.m()``
binds to the enclosing class's ``m`` when it has one, otherwise (and for
``expr.m()``) to every class method named ``m`` in the tree, minus a
denylist of ubiquitous container/protocol names.  Over-approximation errs
toward false positives, which suppressions-with-reasons then document —
the right default for a determinism gate.
"""
from __future__ import annotations

import ast
import dataclasses

from .lint import (env_violation, is_wall_clock, module_imports,
                   rng_violation, call_target, _Imports)
from .rules import (Violation, apply_suppressions, in_scope, package_of,
                    parse_suppressions)

HOOK_NAMES = ("submit_hook", "step_hook", "router", "batch", "governor")

# method names too generic to resolve globally (every container has them);
# resolving these to all same-named methods would connect the whole tree
METHOD_DENYLIST = frozenset({
    "get", "items", "keys", "values", "append", "appendleft", "pop",
    "popleft", "add", "extend", "update", "clear", "copy", "sort", "remove",
    "discard", "insert", "count", "index", "join", "split", "strip",
    "startswith", "endswith", "format", "encode", "decode", "setdefault",
    "close", "flush", "write", "read", "readline", "get_event_loop",
    "walk", "mean", "sum", "min", "max", "round", "most_common"})

# bare-name calls that perform I/O (print included: hooks run on the hot
# path, and stdout writes there would also skew the self-profiler)
IO_BUILTINS = frozenset({"open", "print", "input", "breakpoint"})
IO_MODULE_CALLS = frozenset({
    ("os", "makedirs"), ("os", "remove"), ("os", "rmdir"), ("os", "system"),
    ("os", "popen"), ("os", "rename"), ("os", "replace"),
    ("shutil", "rmtree"), ("shutil", "copy"), ("shutil", "copytree"),
    ("subprocess", "run"), ("subprocess", "Popen"), ("subprocess", "call"),
    ("subprocess", "check_output"), ("subprocess", "check_call")})


@dataclasses.dataclass
class FuncNode:
    """One function/method/lambda in the cross-module graph."""

    qualname: str              # module:Class.method or module:function
    relpath: str
    node: ast.AST              # FunctionDef / AsyncFunctionDef / Lambda
    cls: str | None            # enclosing class name, if a method
    imports: _Imports          # its module's import table


class _Collector(ast.NodeVisitor):
    """Index every function definition in one module."""

    def __init__(self, relpath: str, imports: _Imports):
        self.relpath = relpath
        self.imports = imports
        self.funcs: dict[str, FuncNode] = {}       # qualname -> node
        self.by_class: dict[tuple[str, str], FuncNode] = {}
        self.module_funcs: dict[str, FuncNode] = {}  # bare name -> node
        self.classes: set[str] = set()
        self._stack: list[str] = []
        self._cls: list[str | None] = [None]

    def _add(self, name: str, node: ast.AST) -> FuncNode:
        qual = f"{self.relpath}:{'.'.join(self._stack + [name])}"
        fn = FuncNode(qual, self.relpath, node, self._cls[-1], self.imports)
        self.funcs[qual] = fn
        if self._cls[-1] is not None and len(self._stack) >= 1 \
                and self._stack[-1] == self._cls[-1]:
            self.by_class[(self._cls[-1], name)] = fn
        if not self._stack:
            self.module_funcs[name] = fn
        return fn

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._add(node.name, node)
        self._stack.append(node.name)
        self._cls.append(self._cls[-1])
        self.generic_visit(node)
        self._cls.pop()
        self._stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.classes.add(node.name)
        self._stack.append(node.name)
        self._cls.append(node.name)
        self.generic_visit(node)
        self._cls.pop()
        self._stack.pop()


class _Graph:
    """The whole-tree index the reachability walk runs over."""

    def __init__(self) -> None:
        self.collectors: dict[str, _Collector] = {}   # relpath -> collector
        self.trees: dict[str, ast.AST] = {}
        # method name -> every (class, node) defining it, across the tree
        self.methods: dict[str, list[FuncNode]] = {}
        # class name -> its collector (classes are uniquely named in repro)
        self.class_home: dict[str, _Collector] = {}

    def add_module(self, relpath: str, source: str) -> None:
        tree = ast.parse(source, filename=relpath)
        col = _Collector(relpath, module_imports(tree))
        col.visit(tree)
        self.collectors[relpath] = col
        self.trees[relpath] = tree
        for (cls, name), fn in col.by_class.items():
            self.methods.setdefault(name, []).append(fn)
        for cls in col.classes:
            self.class_home.setdefault(cls, col)

    # -- call resolution ----------------------------------------------------
    def resolve_call(self, call: ast.Call,
                     ctx: FuncNode) -> list[FuncNode]:
        f = call.func
        col = self.collectors[ctx.relpath]
        if isinstance(f, ast.Name):
            # bare name: module function, or a class -> its __init__
            fn = col.module_funcs.get(f.id)
            if fn is not None:
                return [fn]
            if f.id in col.classes:
                init = col.by_class.get((f.id, "__init__"))
                return [init] if init else []
            member = ctx.imports.members.get(f.id)
            if member is not None:
                # from-import of a repro-internal name resolves nowhere here
                # (relative imports carry module=None); absolute stdlib
                # imports are handled by the impurity primitives instead.
                return []
            return []
        if isinstance(f, ast.Attribute):
            name = f.attr
            if isinstance(f.value, ast.Name) and f.value.id in col.classes:
                fn = col.by_class.get((f.value.id, name))
                return [fn] if fn else []
            if isinstance(f.value, ast.Name) and f.value.id == "self" \
                    and ctx.cls is not None:
                own = col.by_class.get((ctx.cls, name))
                if own is not None:
                    return [own]
            if name in METHOD_DENYLIST:
                return []
            return list(self.methods.get(name, []))
        return []

    def class_roots(self, cls_name: str) -> list[FuncNode]:
        """All public methods of a class — the hook faces a governor/batch
        object exposes.  Private helpers are reached transitively."""
        col = self.class_home.get(cls_name)
        if col is None:
            return []
        return [fn for (c, m), fn in col.by_class.items()
                if c == cls_name and not m.startswith("_")]


def _own_nodes(fn: FuncNode) -> list[ast.AST]:
    """All AST nodes lexically in ``fn``'s body, excluding nested def
    bodies (those only run if called; calls to them are graph edges).
    Lambdas are kept inline — a hook's inline lambda runs when it runs."""
    out: list[ast.AST] = []
    body = fn.node.body if isinstance(fn.node.body, list) else [fn.node.body]
    stack: list[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        out.append(node)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stack.append(child)
    return out


def _impurities(fn: FuncNode) -> list[tuple[int, str]]:
    """Impurity primitives directly inside one function body."""
    out: list[tuple[int, str]] = []
    for node in _own_nodes(fn):
        if isinstance(node, ast.Call):
            if is_wall_clock(node, fn.imports):
                out.append((node.lineno, "wall-clock read"))
            msg = rng_violation(node, fn.imports)
            if msg is not None:
                out.append((node.lineno, msg))
            if isinstance(node.func, ast.Name) \
                    and node.func.id in IO_BUILTINS:
                out.append((node.lineno, f"{node.func.id}() I/O"))
            tgt = call_target(node, fn.imports)
            if tgt in IO_MODULE_CALLS:
                out.append((node.lineno, f"{tgt[0]}.{tgt[1]}() I/O"))
        env = env_violation(node, fn.imports)
        if env is not None:
            out.append((node.lineno, env))
    return out


def _nested_defs(fn: FuncNode, col: _Collector) -> list[FuncNode]:
    """Functions lexically nested in ``fn`` (closures a hook may install)
    are conservatively treated as called: a step-hook closure's helpers run
    when it runs."""
    out = []
    for node in ast.walk(fn.node):
        if node is fn.node:
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for cand in col.funcs.values():
                if cand.node is node:
                    out.append(cand)
    return out


def _hook_roots(graph: _Graph) -> list[tuple[FuncNode, str, str]]:
    """Find hook registrations; return ``(root, hook_name, site)`` triples.

    Registration shapes resolved:
      x.<hook> = self.method          -> that method
      x.<hook> = name                 -> module function named ``name``
      x.<hook> = lambda ...           -> the lambda body
      x.<hook> = Cls(...) / a or Cls()-> every public method of ``Cls``
      x.<hook> = self.attr            -> class of ``self.attr = Cls(...)``
      Cls(..., <hook>=value)          -> same value resolution
    Unresolvable values (plain parameters being stored) are skipped — the
    registration that *supplied* the value is the checked site.
    """
    roots: list[tuple[FuncNode, str, str]] = []

    def resolve_value(value: ast.AST, col: _Collector,
                      cls: str | None) -> list[FuncNode]:
        if isinstance(value, ast.Lambda):
            for cand in col.funcs.values():
                if cand.node is value:
                    return [cand]
            # lambdas aren't collected as defs; wrap ad hoc
            return [FuncNode(f"{col.relpath}:<lambda>", col.relpath,
                             value, cls, col.imports)]
        if isinstance(value, ast.Name):
            fn = col.module_funcs.get(value.id)
            if fn is not None:
                return [fn]
            if value.id in col.classes:
                return graph.class_roots(value.id)
            return []
        if isinstance(value, ast.Attribute) \
                and isinstance(value.value, ast.Name) \
                and value.value.id == "self" and cls is not None:
            m = col.by_class.get((cls, value.attr))
            if m is not None:
                return [m]
            # self.attr holding an object: find ``self.attr = Cls(...)``
            out: list[FuncNode] = []
            for (c, _m), fn in col.by_class.items():
                if c != cls:
                    continue
                for node in ast.walk(fn.node):
                    if isinstance(node, ast.Assign) \
                            and len(node.targets) == 1 \
                            and isinstance(node.targets[0], ast.Attribute) \
                            and isinstance(node.targets[0].value, ast.Name) \
                            and node.targets[0].value.id == "self" \
                            and node.targets[0].attr == value.attr:
                        out += _classes_in(node.value, col)
            return out
        if isinstance(value, (ast.Call, ast.BoolOp, ast.IfExp)):
            return _classes_in(value, col)
        return []

    def _classes_in(value: ast.AST, col: _Collector) -> list[FuncNode]:
        out: list[FuncNode] = []
        for node in ast.walk(value):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Name) \
                    and node.func.id in graph.class_home:
                out += graph.class_roots(node.func.id)
        return out

    for relpath, tree in graph.trees.items():
        col = graph.collectors[relpath]

        # walk with enclosing-class context so self.* resolves
        def walk(node: ast.AST, cls: str | None) -> None:
            for child in ast.iter_child_nodes(node):
                child_cls = child.name if isinstance(child,
                                                     ast.ClassDef) else cls
                if isinstance(child, ast.Assign) \
                        and len(child.targets) == 1 \
                        and isinstance(child.targets[0], ast.Attribute) \
                        and child.targets[0].attr in HOOK_NAMES:
                    tgt = child.targets[0]
                    # ``self.<hook> = <hook>`` parameter stores inside the
                    # registering class itself aren't registrations
                    if not (isinstance(child.value, ast.Name)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"
                            and child.value.id == tgt.attr):
                        site = f"{relpath}:{child.lineno}"
                        for fn in resolve_value(child.value, col, cls):
                            roots.append((fn, tgt.attr, site))
                if isinstance(child, ast.Call):
                    for kw in child.keywords:
                        if kw.arg in HOOK_NAMES:
                            site = f"{relpath}:{child.lineno}"
                            for fn in resolve_value(kw.value, col, cls):
                                roots.append((fn, kw.arg, site))
                walk(child, child_cls)

        walk(tree, None)
    return roots


def check_hook_purity(sources: dict[str, str]) -> list[Violation]:
    """Run the purity pass over ``{relpath: source}``; returns hook-purity
    violations with per-file suppressions already applied (bad-suppression
    findings are the per-file linter's job, not repeated here)."""
    graph = _Graph()
    for rel, src in sources.items():
        graph.add_module(rel, src)

    roots = _hook_roots(graph)
    violations: list[Violation] = []
    seen: set[tuple[str, int, str]] = set()
    for root, hook, site in roots:
        if not in_scope("hook-purity", package_of(root.relpath)):
            continue
        # BFS over the static call graph from this root (AST nodes hash by
        # identity, so the visited set needs no address-based key)
        visited: set[ast.AST] = set()
        frontier = [root]
        while frontier:
            fn = frontier.pop()
            if fn.node in visited:
                continue
            visited.add(fn.node)
            for lineno, what in _impurities(fn):
                key = (fn.relpath, lineno, what)
                if key in seen:
                    continue
                seen.add(key)
                violations.append(Violation(
                    fn.relpath, lineno, "hook-purity",
                    f"{what} reachable from {hook} hook "
                    f"(registered at {site}, via {fn.qualname})"))
            col = graph.collectors[fn.relpath]
            frontier += _nested_defs(fn, col)
            for node in _own_nodes(fn):
                if isinstance(node, ast.Call):
                    frontier += graph.resolve_call(node, fn)

    # apply each file's suppressions to its violations
    out: list[Violation] = []
    by_file: dict[str, list[Violation]] = {}
    for v in violations:
        by_file.setdefault(v.file, []).append(v)
    for rel, vs in by_file.items():
        sups, _bad = parse_suppressions(sources.get(rel, ""), rel)
        out += apply_suppressions(vs, sups)
    return out
