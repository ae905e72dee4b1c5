"""AST extraction shared by the concurrency passes — no execution.

The concurrency x-ray works the way ``hlo/parser.py`` works on compiler
text: parse once, build a typed model, let every pass query it. This
module turns the scanned source set into that model:

- a **function table** keyed by qualname (``rel.py::Class.method``,
  ``rel.py::fn``, nested ``rel.py::fn.<locals>.inner``, module-level
  code as ``rel.py::<module>``), each function carrying its call sites,
  lock acquisitions, shared-state writes/reads, and the lock set held
  at every one of them;
- a **lock table**: every ``threading.Lock/RLock/Condition/Semaphore``
  construction site, identified *statically* — ``rel.py::Class.attr``
  for ``self.X = threading.Lock()``, ``rel.py::NAME`` for module
  globals (one id per definition site, the standard per-class
  approximation: instances share the identity);
- a **root inventory**: every way host code starts running off the main
  thread — ``threading.Thread(target=...)`` / ``Timer``, executor
  ``.submit``, ``signal.signal`` handlers, ``atexit.register`` hooks,
  plus *callback escapes* (an internal function reference handed to a
  deferred-execution call such as ``finalize_async(...)``,
  ``register_*`` listeners, or an internal constructor that stores
  callbacks — the responder's escalation callables, the checkpoint
  finalize closure). Rooted files additionally get one implicit
  **main root** covering their public surface, so "called from the
  training loop while the thread runs" counts as a second root.

Call resolution is best-effort and honest about its limits:
``self.m()`` resolves within the class, bare names through the nested
scope then the module then cross-module ``from apex_tpu_torch... import``
edges, attribute calls only when the method name is unique across the
scan (this repo's ``emit``/``event``/``close`` are deliberately NOT —
see roots.py, which reports every unresolved edge as
``concurrency.unresolved`` info instead of silently dropping it).
Dotted calls into known stdlib/torch modules classify as ``external``.

Everything here is pure AST — importable with no torch, no threads, no
side effects — so the gate cost is parse time (<2s for the package).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

#: threading constructors that define a lock identity when assigned
LOCK_CTORS = frozenset({
    "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore",
})
REENTRANT_CTORS = frozenset({"RLock"})

#: attribute calls that mutate their receiver in place — a write to the
#: receiver's state for the shared-state audit (deque.append & co.)
MUTATING_ATTR_CALLS = frozenset({
    "append", "appendleft", "add", "clear", "pop", "popleft", "update",
    "extend", "remove", "discard", "insert", "setdefault", "set",
})

#: call names whose function-reference arguments run LATER on another
#: thread (the callback-escape set): the checkpoint writer's
#: ``finalize_async``, executor ``submit``, ``add_done_callback``, and
#: any ``register*`` listener API. Internal class constructors are also
#: scanned (a constructor that stores a callable is deferring it —
#: the responder handing ``self._dump``/``self._terminate`` into
#: ``StallWatchdog(escalations=...)``).
DEFERRED_CALL_NAMES = frozenset({
    "finalize_async", "submit", "add_done_callback", "call_later",
    "call_soon", "call_soon_threadsafe",
})

#: keyword names that mark a callable argument handed to an internal
#: CONSTRUCTOR as deferred (stored for later invocation) — plain
#: internal calls are synchronous and never create roots from their
#: arguments (``retry_with_backoff(fn)`` runs fn on the caller's thread)
CALLBACK_KWARGS = frozenset({
    "target", "callback", "escalations", "exit_fn", "hooks", "func",
})

#: method names too universal for the unique-name attribute-resolution
#: fallback: ``self._f.flush()`` must NOT resolve to the one ``flush``
#: method in the scan (it's a file object's). These resolve as
#: ``dynamic`` instead and surface as ``concurrency.unresolved`` info.
_COMMON_METHODS = frozenset({
    "flush", "close", "write", "read", "get", "set", "put", "pop",
    "append", "add", "update", "clear", "copy", "keys", "values",
    "items", "join", "start", "stop", "run", "send", "recv", "open",
    "wait", "emit", "event", "acquire", "release", "submit", "result",
    "cancel", "done", "encode", "decode", "strip", "split", "format",
    "save", "load", "reset", "name", "next", "step", "state",
})

#: stdlib / third-party top-level modules whose dotted calls classify as
#: ``external`` (never ``dynamic``) — their blocking behaviour is table-
#: driven in lockgraph.py, their signal-safety in handlers.py
_KNOWN_EXTERNAL_MODULES = frozenset({
    "os", "sys", "time", "signal", "atexit", "threading", "logging",
    "json", "math", "re", "io", "itertools", "functools", "contextlib",
    "collections", "dataclasses", "subprocess", "shutil", "tempfile",
    "socket", "ctypes", "struct", "random", "warnings", "traceback",
    "inspect", "types", "typing", "pathlib", "glob", "errno", "uuid",
    "hashlib", "copy", "numpy", "np", "torch", "dist", "nn", "F", "gc",
    "pickle", "queue", "weakref", "enum",
    "argparse", "textwrap", "difflib", "unicodedata", "string",
    "heapq", "bisect", "operator", "abc", "platform", "importlib",
    "statistics",
})

_SAFE_BUILTINS = frozenset({
    "len", "str", "int", "float", "bool", "repr", "id", "type", "abs",
    "min", "max", "sum", "round", "sorted", "list", "dict", "set",
    "tuple", "frozenset", "range", "enumerate", "zip", "map", "filter",
    "isinstance", "issubclass", "getattr", "setattr", "hasattr",
    "callable", "iter", "next", "vars", "format", "any", "all",
    "divmod", "ord", "chr", "reversed", "bytes", "hash", "print",
    "super", "object", "delattr", "globals", "locals", "dir", "slice",
    "memoryview", "bytearray", "staticmethod", "classmethod",
    "property", "exec", "eval", "compile", "open", "input",
    "ValueError", "TypeError", "KeyError", "RuntimeError", "OSError",
    "Exception", "BaseException", "StopIteration", "AttributeError",
    "IndexError", "NotImplementedError", "KeyboardInterrupt",
    "FileNotFoundError", "ZeroDivisionError", "OverflowError",
})


@dataclasses.dataclass(frozen=True)
class LockDef:
    """A statically-identified lock: one id per construction site."""
    id: str                      # "rel.py::Class.attr" | "rel.py::NAME"
    reentrant: bool
    site: str                    # "rel.py:NN"


@dataclasses.dataclass
class CallSite:
    """One call expression inside a function body."""
    text: str                    # rendered callee, e.g. "self.router.event"
    lineno: int
    locks: FrozenSet[str]        # lock ids locally held at the call
    kind: str                    # "internal" | "external" | "dynamic"
    resolved: Optional[str] = None   # qualname when kind == "internal"
    attr: Optional[str] = None       # terminal attribute name, if any
    recv_text: str = ""              # receiver expression text, if any
    dotted: Optional[str] = None     # normalized "mod.fn" for externals
    nargs: int = 0                   # positional + keyword arg count
    inline_event: bool = False       # receiver is `threading.Event()`


@dataclasses.dataclass
class StateWrite:
    state: str                   # "rel.py::Class.attr" | "rel.py::NAME"
    lineno: int
    locks: FrozenSet[str]
    in_init: bool                # own-class ctor store (happens-before)


@dataclasses.dataclass
class StateRead:
    state: str
    lineno: int


@dataclasses.dataclass
class ImportUnder:
    lineno: int
    locks: FrozenSet[str]
    module: str


@dataclasses.dataclass
class FuncInfo:
    qualname: str
    rel: str
    name: str
    lineno: int
    cls: Optional[str] = None    # immediate class name for methods
    calls: List[CallSite] = dataclasses.field(default_factory=list)
    #: (lock id, lineno, locks already held locally at the acquisition)
    acquires: List[Tuple[str, int, FrozenSet[str]]] = (
        dataclasses.field(default_factory=list))
    writes: List[StateWrite] = dataclasses.field(default_factory=list)
    reads: List[StateRead] = dataclasses.field(default_factory=list)
    imports_under_lock: List[ImportUnder] = (
        dataclasses.field(default_factory=list))


@dataclasses.dataclass(frozen=True)
class Root:
    """One concurrency root: an entry point onto a non-main context —
    or the implicit main root of a rooted file (kind ``main``)."""
    kind: str                    # thread|timer|executor|signal|atexit|
    #                              callback|main
    site: str                    # "rel.py:NN" ("rel.py" for main)
    targets: Tuple[str, ...]     # resolved entry qualnames (may be ())
    label: str                   # stable display id, e.g. "thread:f.py:10"


@dataclasses.dataclass
class Model:
    files: Dict[str, str]
    functions: Dict[str, FuncInfo]
    locks: Dict[str, LockDef]
    roots: List[Root]
    #: method name -> sorted qualnames across the scan (for unique-name
    #: attribute resolution; ambiguous names resolve to nothing)
    method_index: Dict[str, List[str]]
    #: registration sites whose handler expression could not be resolved
    #: (e.g. restoring a saved handler variable) — reported by roots.py
    unresolved_roots: List[Tuple[str, int, str]]  # (rel, lineno, text)

    def rooted_files(self) -> List[str]:
        rels = {r.site.split(":")[0] for r in self.roots
                if r.kind != "main"}
        return sorted(rels)


def _dotted_text(node: ast.AST) -> str:
    """Best-effort render of a callee/receiver expression."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return f"{_dotted_text(node.value)}.{node.attr}"
    if isinstance(node, ast.Call):
        return f"{_dotted_text(node.func)}(...)"
    if isinstance(node, ast.Subscript):
        return f"{_dotted_text(node.value)}[...]"
    if isinstance(node, ast.Constant):
        return repr(node.value)
    return "<expr>"


def _module_to_rel(dotted: str, files: Dict[str, str]) -> Optional[str]:
    """``apex_tpu_torch.monitor.router`` ->
    ``apex_tpu_torch/monitor/router.py`` when that file is in the scan
    set (or its package ``__init__.py``); the dotted name maps whole
    components to a path, so a package is never a prefix of another."""
    base = dotted.replace(".", "/")
    for cand in (base + ".py", base + "/__init__.py"):
        if cand in files:
            return cand
    return None


class _Scope:
    """Per-file name environment built in pass 1."""

    def __init__(self, rel: str):
        self.rel = rel
        #: alias -> real top-level module dotted path ("_signal"->"signal")
        self.module_aliases: Dict[str, str] = {}
        #: from-imported name -> ("func", qualname) | ("class", rel, cls)
        #:                      | ("ext", dotted)
        self.imported: Dict[str, Tuple] = {}
        #: class name -> {method name -> qualname}
        self.classes: Dict[str, Dict[str, str]] = {}
        #: module-level function name -> qualname
        self.module_funcs: Dict[str, str] = {}
        #: module-level assigned names (globals the shared audit tracks)
        self.module_globals: Set[str] = set()


class ModelBuilder:
    def __init__(self, files: Dict[str, str]):
        self.files = files
        self.functions: Dict[str, FuncInfo] = {}
        self.locks: Dict[str, LockDef] = {}
        self.roots: List[Root] = []
        self.method_index: Dict[str, Set[str]] = {}
        self.unresolved_roots: List[Tuple[str, int, str]] = []
        self.scopes: Dict[str, _Scope] = {}
        self.trees: Dict[str, ast.Module] = {}
        #: qualname -> (scope, class name or None, parent func qualname,
        #:              ast node or None for <module>, local name set)
        self._fmeta: Dict[str, Tuple] = {}

    # ---------------------------------------------------------------- pass 1

    def collect(self) -> None:
        for rel in sorted(self.files):
            try:
                tree = ast.parse(self.files[rel])
            except SyntaxError:
                continue        # lint owns the unparseable-file finding
            self.trees[rel] = tree
            scope = _Scope(rel)
            self.scopes[rel] = scope
            self._collect_imports(rel, tree, scope)
            self._collect_defs(rel, tree, scope)
            self._collect_locks(rel, tree, scope)
        # resolve cross-module from-imports now every file is indexed
        for rel, scope in self.scopes.items():
            for name, entry in list(scope.imported.items()):
                if entry[0] != "pending":
                    continue
                mod_rel, leaf = entry[1], entry[2]
                other = self.scopes.get(mod_rel)
                if other is None:
                    scope.imported[name] = ("ext", leaf)
                elif leaf in other.module_funcs:
                    scope.imported[name] = (
                        "func", other.module_funcs[leaf])
                elif leaf in other.classes:
                    scope.imported[name] = ("class", mod_rel, leaf)
                else:
                    scope.imported[name] = ("ext", leaf)

    def _collect_imports(self, rel, tree, scope) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    top = a.name.split(".")[0]
                    scope.module_aliases[a.asname or top] = (
                        a.name if a.asname else top)
            elif isinstance(node, ast.ImportFrom) and node.module:
                mod_rel = _module_to_rel(node.module, self.files)
                for a in node.names:
                    bound = a.asname or a.name
                    if mod_rel is not None:
                        scope.imported[bound] = (
                            "pending", mod_rel, a.name)
                    else:
                        scope.imported[bound] = (
                            "ext", f"{node.module}.{a.name}")

    def _collect_defs(self, rel, tree, scope) -> None:
        def walk_nested(node, parent_qual, cls):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    q = f"{parent_qual}.<locals>.{child.name}"
                    # closures inherit the enclosing method's class:
                    # `self` inside them is the same instance
                    self._register_func(rel, q, child, cls, parent_qual,
                                        scope)
                    walk_nested(child, q, cls)

        for child in ast.iter_child_nodes(tree):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{rel}::{child.name}"
                scope.module_funcs[child.name] = qual
                self._register_func(rel, qual, child, None, None, scope)
                walk_nested(child, qual, None)
            elif isinstance(child, ast.ClassDef):
                methods: Dict[str, str] = {}
                scope.classes[child.name] = methods
                for sub in ast.iter_child_nodes(child):
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        q = f"{rel}::{child.name}.{sub.name}"
                        methods[sub.name] = q
                        self._register_func(rel, q, sub, child.name,
                                            None, scope)
                        self.method_index.setdefault(
                            sub.name, set()).add(q)
                        walk_nested(sub, q, child.name)
        # module-level pseudo-function for top-level statements
        mod_q = f"{rel}::<module>"
        self.functions[mod_q] = FuncInfo(
            qualname=mod_q, rel=rel, name="<module>", lineno=1)
        self._fmeta[mod_q] = (scope, None, None, tree, set())
        # module-level assigned names (the globals the shared audit
        # tracks)
        for child in ast.iter_child_nodes(tree):
            for tgt in _assign_targets(child):
                if isinstance(tgt, ast.Name):
                    scope.module_globals.add(tgt.id)

    def _register_func(self, rel, qual, node, cls, parent, scope) -> None:
        if qual in self.functions:
            return
        self.functions[qual] = FuncInfo(
            qualname=qual, rel=rel, name=node.name,
            lineno=node.lineno, cls=cls)
        locals_: Set[str] = set()
        args = node.args
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)):
            locals_.add(a.arg)
        if args.vararg:
            locals_.add(args.vararg.arg)
        if args.kwarg:
            locals_.add(args.kwarg.arg)
        declared_global: Set[str] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Global):
                declared_global.update(sub.names)
            elif isinstance(sub, ast.Name) and isinstance(
                    sub.ctx, (ast.Store, ast.Del)):
                locals_.add(sub.id)
            elif isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and sub is not node:
                locals_.add(sub.name)
        locals_ -= declared_global
        self._fmeta[qual] = (scope, cls, parent, node, locals_)

    def _collect_locks(self, rel, tree, scope) -> None:
        """Every ``<target> = threading.Lock()``-shaped assignment, at any
        nesting depth, defines a lock id."""
        class_stack: List[str] = []

        def visit(node):
            if isinstance(node, ast.ClassDef):
                class_stack.append(node.name)
                for c in ast.iter_child_nodes(node):
                    visit(c)
                class_stack.pop()
                return
            if isinstance(node, ast.Assign):
                ctor = _lock_ctor_name(node.value, scope)
                if ctor:
                    for tgt in node.targets:
                        lock_id = self._lock_target_id(
                            rel, tgt, class_stack)
                        if lock_id:
                            self.locks.setdefault(lock_id, LockDef(
                                id=lock_id,
                                reentrant=ctor in REENTRANT_CTORS,
                                site=f"{rel}:{node.lineno}"))
            for c in ast.iter_child_nodes(node):
                visit(c)

        visit(tree)

    def _lock_target_id(self, rel, tgt, class_stack) -> Optional[str]:
        if isinstance(tgt, ast.Attribute) and isinstance(
                tgt.value, ast.Name) and tgt.value.id == "self":
            if class_stack:
                return f"{rel}::{class_stack[-1]}.{tgt.attr}"
            return None
        if isinstance(tgt, ast.Name):
            if class_stack:
                return f"{rel}::{class_stack[-1]}.{tgt.id}"
            return f"{rel}::{tgt.id}"
        return None

    # ---------------------------------------------------------------- pass 2

    def extract(self) -> None:
        for qual in sorted(self.functions):
            scope, cls, parent, node, locals_ = self._fmeta[qual]
            fi = self.functions[qual]
            walker = _BodyWalker(self, fi, scope, cls, parent, locals_)
            if node is None:
                continue
            if isinstance(node, ast.Module):
                walker.walk_module(node)
            else:
                walker.walk_func(node)
        self._add_main_roots()
        # drop duplicate roots (a Thread ctor matched both the special
        # case and a callback kwarg scan)
        seen: Set[Tuple] = set()
        uniq: List[Root] = []
        for r in sorted(self.roots,
                        key=lambda r: (r.site, r.kind, r.targets)):
            key = (r.site, r.targets)
            if key in seen:
                continue
            seen.add(key)
            uniq.append(r)
        self.roots = uniq

    def _add_main_roots(self) -> None:
        """Every file that OWNS a root also has a main-thread surface:
        its public module functions and public/lifecycle methods run on
        the caller's thread while the root runs concurrently."""
        rooted = {r.site.split(":")[0] for r in self.roots}
        lifecycle = {"__init__", "__call__", "__enter__", "__exit__"}
        for rel in sorted(rooted):
            scope = self.scopes.get(rel)
            if scope is None:
                continue
            targets: List[str] = [f"{rel}::<module>"]
            for name, q in sorted(scope.module_funcs.items()):
                if not name.startswith("_"):
                    targets.append(q)
            for cname, methods in sorted(scope.classes.items()):
                for mname, q in sorted(methods.items()):
                    if not mname.startswith("_") or mname in lifecycle:
                        targets.append(q)
            self.roots.append(Root(
                kind="main", site=rel, targets=tuple(targets),
                label=f"main:{rel}"))

    # ------------------------------------------------------------- finalize

    def build(self) -> Model:
        self.collect()
        self.extract()
        return Model(
            files=self.files,
            functions=self.functions,
            locks=self.locks,
            roots=self.roots,
            method_index={k: sorted(v)
                          for k, v in self.method_index.items()},
            unresolved_roots=self.unresolved_roots,
        )


def _assign_targets(node: ast.AST) -> List[ast.AST]:
    if isinstance(node, ast.Assign):
        return list(node.targets)
    if isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        return [node.target]
    return []


def _lock_ctor_name(value: ast.AST, scope: _Scope) -> Optional[str]:
    """``threading.Lock()`` / aliased / ``from threading import RLock``
    constructor name, else None."""
    if not isinstance(value, ast.Call):
        return None
    fn = value.func
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
        mod = scope.module_aliases.get(fn.value.id, fn.value.id)
        if mod == "threading" and fn.attr in LOCK_CTORS:
            return fn.attr
    if isinstance(fn, ast.Name):
        entry = scope.imported.get(fn.id)
        if entry and entry[0] == "ext" and entry[1] in {
                f"threading.{c}" for c in LOCK_CTORS}:
            return entry[1].split(".")[-1]
    return None


class _BodyWalker:
    """Walks one function body tracking the locally-held lock set."""

    def __init__(self, builder: ModelBuilder, fi: FuncInfo, scope: _Scope,
                 cls: Optional[str], parent: Optional[str],
                 locals_: Set[str]):
        self.b = builder
        self.fi = fi
        self.scope = scope
        self.cls = cls
        self.parent = parent
        self.locals = locals_
        self.in_init = (fi.name == "__init__")

    # -- entry points ------------------------------------------------------

    def walk_func(self, node) -> None:
        self._block(node.body, frozenset())

    def walk_module(self, tree: ast.Module) -> None:
        body = [s for s in tree.body
                if not isinstance(s, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.ClassDef))]
        self._block(body, frozenset())

    # -- statement walk ----------------------------------------------------

    def _block(self, stmts: Sequence[ast.stmt],
               held: FrozenSet[str]) -> None:
        for stmt in stmts:
            self._stmt(stmt, held)

    def _stmt(self, stmt: ast.stmt, held: FrozenSet[str]) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return                      # walked as its own function
        if isinstance(stmt, (ast.Import, ast.ImportFrom)):
            if held:
                mod = (stmt.module if isinstance(stmt, ast.ImportFrom)
                       else stmt.names[0].name) or ""
                self.fi.imports_under_lock.append(
                    ImportUnder(stmt.lineno, held, mod))
            return
        if isinstance(stmt, ast.With):
            new_held = set(held)
            for item in stmt.items:
                lock_id = self._lock_expr_id(item.context_expr)
                if lock_id:
                    self.fi.acquires.append(
                        (lock_id, item.context_expr.lineno,
                         frozenset(new_held)))
                    new_held.add(lock_id)
                else:
                    self._expr(item.context_expr, held)
            self._block(stmt.body, frozenset(new_held))
            return
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            for tgt in _assign_targets(stmt):
                self._store(tgt, stmt.lineno, held,
                            aug=isinstance(stmt, ast.AugAssign))
            if getattr(stmt, "value", None) is not None:
                self._expr(stmt.value, held)
            return
        if isinstance(stmt, ast.Expr):
            self._expr(stmt.value, held)
            return
        if isinstance(stmt, (ast.Return, ast.Raise)):
            val = stmt.value if isinstance(stmt, ast.Return) else stmt.exc
            if val is not None:
                self._expr(val, held)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._expr(stmt.test, held)
            self._block(stmt.body, held)
            self._block(stmt.orelse, held)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._expr(stmt.iter, held)
            self._block(stmt.body, held)
            self._block(stmt.orelse, held)
            return
        if isinstance(stmt, ast.Try):
            self._block(stmt.body, held)
            for h in stmt.handlers:
                self._block(h.body, held)
            self._block(stmt.orelse, held)
            self._block(stmt.finalbody, held)
            return
        if isinstance(stmt, (ast.Delete, ast.Assert)):
            for v in ast.iter_child_nodes(stmt):
                if isinstance(v, ast.expr):
                    self._expr(v, held)
            return
        # anything else: walk child expressions conservatively
        for v in ast.iter_child_nodes(stmt):
            if isinstance(v, ast.expr):
                self._expr(v, held)
            elif isinstance(v, ast.stmt):
                self._stmt(v, held)

    # -- state access ------------------------------------------------------

    def _state_id(self, node: ast.AST) -> Optional[str]:
        """Shared-state identity for an attribute/global reference."""
        if isinstance(node, ast.Attribute) and isinstance(
                node.value, ast.Name) and node.value.id == "self" \
                and self.cls:
            return f"{self.fi.rel}::{self.cls}.{node.attr}"
        if isinstance(node, ast.Name):
            if node.id in self.locals:
                return None
            if node.id in self.scope.module_globals:
                return f"{self.fi.rel}::{node.id}"
        return None

    def _store(self, tgt: ast.AST, lineno: int, held: FrozenSet[str],
               aug: bool = False) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._store(el, lineno, held, aug=aug)
            return
        base = tgt
        if isinstance(tgt, ast.Subscript):
            base = tgt.value
            self._expr(tgt.slice, held)
        state = self._state_id(base)
        if state is None:
            return
        if state in self.b.locks:
            return                       # lock construction, not state
        self.fi.writes.append(StateWrite(
            state=state, lineno=lineno, locks=held,
            # construction happens-before: a plain ``self.x = ...`` in
            # __init__ precedes any thread start, and module-level
            # initializers run under the import lock. Aug/subscript
            # stores in __init__ still count (they read-modify-write
            # possibly shared containers).
            in_init=((self.in_init and not aug
                      and not isinstance(tgt, ast.Subscript)
                      and isinstance(base, ast.Attribute))
                     or self.fi.name == "<module>"),
        ))
        if aug:
            self.fi.reads.append(StateRead(state, lineno))

    # -- lock expressions --------------------------------------------------

    def _lock_expr_id(self, expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Attribute) and isinstance(
                expr.value, ast.Name):
            if expr.value.id == "self" and self.cls:
                lid = f"{self.fi.rel}::{self.cls}.{expr.attr}"
                if lid in self.b.locks:
                    return lid
            mod = self.scope.module_aliases.get(expr.value.id)
            if mod:
                mod_rel = _module_to_rel(mod, self.b.files)
                if mod_rel:
                    lid = f"{mod_rel}::{expr.attr}"
                    if lid in self.b.locks:
                        return lid
        if isinstance(expr, ast.Name):
            lid = f"{self.fi.rel}::{expr.id}"
            if lid in self.b.locks:
                return lid
        return None

    # -- expression walk ---------------------------------------------------

    def _expr(self, expr: ast.AST, held: FrozenSet[str]) -> None:
        for node in _walk_exprs(expr):
            if isinstance(node, ast.Call):
                self._call(node, held)
            elif isinstance(node, ast.Attribute) and isinstance(
                    node.ctx, ast.Load):
                state = self._state_id(node)
                if state and state not in self.b.locks:
                    self.fi.reads.append(StateRead(state, node.lineno))
            elif isinstance(node, ast.Name) and isinstance(
                    node.ctx, ast.Load):
                state = self._state_id(node)
                if state and state not in self.b.locks:
                    self.fi.reads.append(StateRead(state, node.lineno))

    # -- call handling -----------------------------------------------------

    def _call(self, node: ast.Call, held: FrozenSet[str]) -> None:
        fn = node.func
        text = _dotted_text(fn)
        nargs = len(node.args) + len(node.keywords)
        site = CallSite(text=text, lineno=node.lineno, locks=held,
                        kind="dynamic", nargs=nargs)

        # `.acquire()` on a recognized lock: approximate as "held for
        # the rest of the function" is unsound across blocks; we record
        # the acquisition edge (for the lock graph) without extending
        # the held set — the repo idiom is `with lock:` throughout.
        if isinstance(fn, ast.Attribute) and fn.attr == "acquire":
            lid = self._lock_expr_id(fn.value)
            if lid:
                self.fi.acquires.append((lid, node.lineno, held))
                return

        # in-place mutation of shared state via method call
        # (deque.append, set.add, Event.set, dict.update, ...)
        if isinstance(fn, ast.Attribute) and \
                fn.attr in MUTATING_ATTR_CALLS:
            state = self._state_id(fn.value)
            if state and state not in self.b.locks:
                self.fi.writes.append(StateWrite(
                    state=state, lineno=node.lineno, locks=held,
                    in_init=(self.in_init
                             and isinstance(fn.value, ast.Attribute)),
                ))

        self._resolve(fn, node, site)
        self.fi.calls.append(site)
        self._detect_roots(fn, node, site)

    def _resolve(self, fn: ast.AST, node: ast.Call,
                 site: CallSite) -> None:
        scope = self.scope
        if isinstance(fn, ast.Name):
            name = fn.id
            q = self._lookup_bare(name)
            if q:
                site.kind, site.resolved = "internal", q
                return
            entry = scope.imported.get(name)
            if entry:
                if entry[0] == "func":
                    site.kind, site.resolved = "internal", entry[1]
                    return
                if entry[0] == "class":
                    ctor = f"{entry[1]}::{entry[2]}.__init__"
                    site.kind = "internal"
                    site.resolved = (ctor if ctor in self.b.functions
                                     else None)
                    site.recv_text = f"{entry[1]}::{entry[2]}"
                    if site.resolved is None:
                        site.kind = "external"
                        site.dotted = f"{entry[1]}::{entry[2]}"
                    return
                site.kind = "external"
                site.dotted = entry[1]
                return
            if name in scope.classes:
                ctor = f"{self.fi.rel}::{name}.__init__"
                if ctor in self.b.functions:
                    site.kind, site.resolved = "internal", ctor
                    site.recv_text = f"{self.fi.rel}::{name}"
                else:
                    site.kind, site.dotted = "external", name
                return
            if name in _SAFE_BUILTINS or name == "open":
                site.kind, site.dotted = "external", name
                return
            if name in self.locals:
                site.kind = "dynamic"    # fn()/cb() on a local callable
                return
            site.kind, site.dotted = "external", name
            return
        if isinstance(fn, ast.Attribute):
            site.attr = fn.attr
            site.recv_text = _dotted_text(fn.value)
            site.inline_event = _is_inline_event(fn.value, scope)
            # self.m() -> own class method
            if isinstance(fn.value, ast.Name) and fn.value.id == "self" \
                    and self.cls:
                methods = scope.classes.get(self.cls, {})
                if fn.attr in methods:
                    site.kind, site.resolved = "internal", methods[fn.attr]
                    return
                site.kind = "dynamic"
                return
            # mod.f() through a module alias
            if isinstance(fn.value, ast.Name):
                mod = scope.module_aliases.get(fn.value.id)
                if mod:
                    mod_rel = _module_to_rel(mod, self.b.files)
                    if mod_rel:
                        other = self.b.scopes.get(mod_rel)
                        if other and fn.attr in other.module_funcs:
                            site.kind = "internal"
                            site.resolved = other.module_funcs[fn.attr]
                            return
                    site.kind = "external"
                    site.dotted = f"{mod.split('.')[0]}.{fn.attr}"
                    return
                entry = scope.imported.get(fn.value.id)
                if entry and entry[0] == "ext":
                    site.kind = "external"
                    site.dotted = f"{entry[1]}.{fn.attr}"
                    return
            # deep external chains: os.path.join, torch.profiler.profile
            root_name = _expr_root_name(fn.value)
            if root_name and self.scope.module_aliases.get(
                    root_name, root_name) in _KNOWN_EXTERNAL_MODULES \
                    and not _mentions_self(fn.value):
                site.kind = "external"
                site.dotted = f"{_dotted_text(fn.value)}.{fn.attr}"
                return
            # unique-method-name fallback across the scan — but never
            # for universal method names (file .flush(), dict .get()):
            # those belong to objects outside the scan far more often
            # than to the one in-scan definition
            if fn.attr not in _COMMON_METHODS:
                cands = self.b.method_index.get(fn.attr, set())
                if len(cands) == 1:
                    site.kind = "internal"
                    site.resolved = next(iter(cands))
                    return
            site.kind = "dynamic"
            return
        site.kind = "dynamic"

    def _lookup_bare(self, name: str) -> Optional[str]:
        """Nested-scope chain: own/enclosing nested defs, then module
        functions."""
        q = self.fi.qualname
        while q:
            cand = f"{q}.<locals>.{name}"
            if cand in self.b.functions:
                return cand
            meta = self.b._fmeta.get(q)
            q = meta[2] if meta else None
        return self.scope.module_funcs.get(name)

    # -- root detection ----------------------------------------------------

    def _detect_roots(self, fn: ast.AST, node: ast.Call,
                      site: CallSite) -> None:
        rel, lineno = self.fi.rel, node.lineno
        loc = f"{rel}:{lineno}"
        # threading.Thread(target=...) / threading.Timer(interval, fn)
        ctor = self._threading_ctor(fn)
        if ctor in ("Thread", "Timer"):
            kind = "thread" if ctor == "Thread" else "timer"
            tgt = None
            for kw in node.keywords:
                if kw.arg in ("target", "function"):
                    tgt = self._func_ref(kw.value)
            if ctor == "Timer" and tgt is None and len(node.args) >= 2:
                tgt = self._func_ref(node.args[1])
            if tgt:
                self.b.roots.append(Root(
                    kind=kind, site=loc, targets=(tgt,),
                    label=f"{kind}:{loc}"))
            else:
                self.b.unresolved_roots.append(
                    (rel, lineno, f"{ctor} target {_args_text(node)}"))
            return
        # signal.signal(sig, handler) / atexit.register(fn)
        mod_call = self._stdlib_call(fn)
        if mod_call == "signal.signal" and len(node.args) >= 2:
            handler = node.args[1]
            if _is_sig_constant(handler):
                return                   # SIG_DFL / SIG_IGN restore
            tgt = self._func_ref(handler)
            if tgt:
                self.b.roots.append(Root(
                    kind="signal", site=loc, targets=(tgt,),
                    label=f"signal:{loc}"))
            else:
                self.b.unresolved_roots.append(
                    (rel, lineno, f"signal handler {_dotted_text(handler)}"))
            return
        if mod_call == "atexit.register" and node.args:
            tgt = self._func_ref(node.args[0])
            if tgt:
                self.b.roots.append(Root(
                    kind="atexit", site=loc, targets=(tgt,),
                    label=f"atexit:{loc}"))
            else:
                self.b.unresolved_roots.append(
                    (rel, lineno,
                     f"atexit hook {_dotted_text(node.args[0])}"))
            return
        # generic callback escapes: deferred-call names, register* APIs,
        # internal constructors, known callback kwargs
        terminal = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else "")
        is_ctor = (site.kind == "internal" and site.resolved
                   and site.resolved.endswith(".__init__"))
        deferred = (terminal in DEFERRED_CALL_NAMES
                    or "register" in terminal)
        if not deferred and not is_ctor:
            return          # plain calls run their args synchronously
        kind = "executor" if terminal == "submit" else "callback"
        for val, kw_name in _arg_exprs(node):
            if not deferred and not _callbackish_kwarg(kw_name):
                continue    # ctors: only callback-shaped keywords defer
            for ref in _callable_refs(val):
                tgt = self._func_ref(ref)
                if tgt:
                    self.b.roots.append(Root(
                        kind=kind, site=loc, targets=(tgt,),
                        label=f"{kind}:{loc}"))

    def _threading_ctor(self, fn: ast.AST) -> Optional[str]:
        if isinstance(fn, ast.Attribute) and isinstance(
                fn.value, ast.Name):
            mod = self.scope.module_aliases.get(fn.value.id, fn.value.id)
            if mod == "threading":
                return fn.attr
        if isinstance(fn, ast.Name):
            entry = self.scope.imported.get(fn.id)
            if entry and entry[0] == "ext" and \
                    entry[1] in ("threading.Thread", "threading.Timer"):
                return entry[1].split(".")[-1]
        return None

    def _stdlib_call(self, fn: ast.AST) -> Optional[str]:
        if isinstance(fn, ast.Attribute) and isinstance(
                fn.value, ast.Name):
            mod = self.scope.module_aliases.get(fn.value.id, fn.value.id)
            if mod in ("signal", "atexit"):
                return f"{mod}.{fn.attr}"
        if isinstance(fn, ast.Name):
            entry = self.scope.imported.get(fn.id)
            if entry and entry[0] == "ext" and entry[1] in (
                    "signal.signal", "atexit.register"):
                return entry[1]
        return None

    def _func_ref(self, expr: ast.AST) -> Optional[str]:
        """Resolve a function REFERENCE (not call) to a qualname."""
        if isinstance(expr, ast.Name):
            q = self._lookup_bare(expr.id)
            if q:
                return q
            entry = self.scope.imported.get(expr.id)
            if entry and entry[0] == "func":
                return entry[1]
            return None
        if isinstance(expr, ast.Attribute) and isinstance(
                expr.value, ast.Name):
            if expr.value.id == "self" and self.cls:
                return self.scope.classes.get(self.cls, {}).get(expr.attr)
            # c._on_event where the method name is unique in the scan
            if expr.attr not in _COMMON_METHODS:
                cands = self.b.method_index.get(expr.attr, set())
                if len(cands) == 1:
                    return next(iter(cands))
        return None


def _callbackish_kwarg(name: Optional[str]) -> bool:
    """Constructor keywords that plausibly store a callable for later."""
    if not name:
        return False
    return (name in CALLBACK_KWARGS or name.startswith("on_")
            or "hook" in name or "callback" in name
            or "escalation" in name or name.endswith("_fn"))


def _is_inline_event(expr: ast.AST, scope: _Scope) -> bool:
    """``threading.Event().wait(...)`` — an event nobody else can set."""
    if not isinstance(expr, ast.Call):
        return False
    fn = expr.func
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
        mod = scope.module_aliases.get(fn.value.id, fn.value.id)
        return mod == "threading" and fn.attr == "Event"
    if isinstance(fn, ast.Name):
        entry = scope.imported.get(fn.id)
        return bool(entry and entry[0] == "ext"
                    and entry[1] == "threading.Event")
    return False


def _is_sig_constant(expr: ast.AST) -> bool:
    return (isinstance(expr, ast.Attribute)
            and expr.attr in ("SIG_DFL", "SIG_IGN"))


def _expr_root_name(expr: ast.AST) -> Optional[str]:
    while isinstance(expr, (ast.Attribute, ast.Subscript, ast.Call)):
        expr = getattr(expr, "value", None) or getattr(expr, "func", None)
        if expr is None:
            return None
    return expr.id if isinstance(expr, ast.Name) else None


def _mentions_self(expr: ast.AST) -> bool:
    return any(isinstance(n, ast.Name) and n.id == "self"
               for n in ast.walk(expr))


def _arg_exprs(node: ast.Call):
    for a in node.args:
        yield a, None
    for kw in node.keywords:
        yield kw.value, kw.arg


def _callable_refs(expr: ast.AST):
    """Name/self-attribute references inside an argument expression —
    including through ``functools.partial(...)``, tuples, and lists."""
    if isinstance(expr, (ast.Name, ast.Attribute)):
        yield expr
        return
    if isinstance(expr, (ast.Tuple, ast.List)):
        for el in expr.elts:
            yield from _callable_refs(el)
        return
    if isinstance(expr, ast.Call):
        for a in expr.args:
            yield from _callable_refs(a)
        for kw in expr.keywords:
            yield from _callable_refs(kw.value)


def _walk_exprs(expr: ast.AST):
    """All expression nodes, NOT descending into nested lambdas/
    comprehension function scopes (close enough for host code)."""
    yield expr
    for child in ast.iter_child_nodes(expr):
        if isinstance(child, (ast.Lambda,)):
            continue
        if isinstance(child, ast.expr):
            yield from _walk_exprs(child)
        elif isinstance(child, (ast.keyword, ast.comprehension)):
            for sub in ast.iter_child_nodes(child):
                if isinstance(sub, ast.expr):
                    yield from _walk_exprs(sub)


def _args_text(node: ast.Call) -> str:
    parts = [_dotted_text(a) for a in node.args]
    parts += [f"{kw.arg}={_dotted_text(kw.value)}" for kw in node.keywords]
    return "(" + ", ".join(parts) + ")"


def build_model(files: Dict[str, str]) -> Model:
    """Parse ``files`` (repo-relative path -> source) into a Model."""
    return ModelBuilder(files).build()
