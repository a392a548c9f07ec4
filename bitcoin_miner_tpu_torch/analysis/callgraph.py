"""Whole-program layer for miner-lint: repo-wide symbol table, call
graph, and execution-context propagation.

Counterpart of ``bitcoin_miner_tpu/analysis/callgraph.py``; module names
are anchored on this package (and ``tests``), and a root script such as
``chip_smoke.py`` is a module of its own name.

The per-file rules pin bug classes that are visible inside one function
body plus at most one resolved call. The reference's later postmortems
were CROSS-function concurrency bugs: the mesh ring's launch-lock
collective deadlock (two locks acquired in opposite order three calls
apart), the pool frontend's sync-dispatch invariant ("no suspension
point = no swallow" — an async helper slipped two hops below
`_dispatch` would reintroduce the class), the shard child's spawn
pickle failure. This module gives the rules the program-level facts
those classes need:

- **symbol table**: every function/method under a module-qualified name
  (``pkg.mod.Class.method``), classes with their bases, per-module
  import-alias maps with relative imports resolved to absolute names.
- **call graph**: each function's call sites resolved through import
  aliases, module-level names, nested defs, and ``self.``/``cls.``
  method dispatch (walking program-resolvable base classes). Unresolved
  receivers stay as raw dotted strings — rules still match them against
  blocking-call tables, they just don't become edges.
- **execution contexts**: a fixed-point pass tags every function with
  the contexts it is reachable from — ``async`` (event loop), ``signal``
  (handler), ``thread`` (Thread/executor target), ``spawn`` (spawn-
  context Process child) — with a sample call chain per tag so findings
  can say WHY a function is considered on-loop. Thread/executor/spawn/
  signal registrations are context BOUNDARIES: they seed the new
  context for the target instead of leaking the caller's.
- **held-lock propagation**: calls made lexically inside ``with <lock>``
  blocks propagate the held lock into the callee (transitively; into
  async callees only when the call is awaited, because an un-awaited
  coroutine does not run under the caller's lock). The resulting
  static lock-acquisition graph, plus cycle detection over it, is what
  the ``lock-order-cycle`` rule reports.
- **hot-path marks**: ``# miner-lint: sync-hot-path`` comments attach
  to the ``def`` on the same or next line; the ``sync-hot-path-await``
  rule walks the call graph from each mark.

Everything expensive is computed lazily and memoized: a single-file
lint builds a single-module program and pays ~nothing; the repo-wide
CI run builds the program once and shares it across every file's rules
(the engine owns that wiring — see engine.run_lint).
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterator, List, Optional, Set, Tuple

# ----------------------------------------------------------- AST utilities
# (shared with rules.py, which re-exports them: rules must not be
# imported from here or registration becomes circular.)

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a pure Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


_LOCKISH_RE = re.compile(r"(?:^|_)(?:lock|mutex|mtx)", re.IGNORECASE)
_LOCK_CTORS = {"Lock", "RLock", "Semaphore", "BoundedSemaphore",
               "Condition"}


def _is_lockish(expr: ast.AST) -> bool:
    name = dotted(expr)
    if name is not None:
        return bool(_LOCKISH_RE.search(name.rsplit(".", 1)[-1]))
    if isinstance(expr, ast.Call):
        func = dotted(expr.func)
        if func is not None:
            return func.rsplit(".", 1)[-1] in _LOCK_CTORS
    return False


def import_map(tree: ast.Module) -> Dict[str, str]:
    """Local alias → dotted origin for every import in the file
    (``import time as t`` → ``t: time``; ``from time import sleep`` →
    ``sleep: time.sleep``; relative imports keep their leading dots —
    :class:`Program` resolves those against the importing module)."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    out[alias.asname] = alias.name
                else:
                    # `import urllib.request` binds `urllib`; resolving
                    # the head through itself keeps dotted uses intact.
                    head = alias.name.split(".")[0]
                    out[head] = head
        elif isinstance(node, ast.ImportFrom):
            module = ("." * node.level) + (node.module or "")
            for alias in node.names:
                out[alias.asname or alias.name] = f"{module}.{alias.name}"
    return out


#: path components that anchor a module name: a file under one of these
#: gets the full dotted path from the anchor down, so imports between
#: repo packages resolve no matter what directory the lint runs from.
_PACKAGE_ANCHORS = ("bitcoin_miner_tpu_torch", "tests")


def module_name_for_path(path: str) -> str:
    """Best-effort dotted module name for a file path.

    ``bitcoin_miner_tpu_torch/miner/dispatcher.py`` →
    ``bitcoin_miner_tpu_torch.miner.dispatcher``; a package ``__init__.py``
    names the package; anything outside a known anchor (a fixture, a
    scratch script) is its own single-segment module — which is exactly
    right for single-file lints: bare names resolve within the file and
    absolute imports still canonicalize through the alias map.
    """
    norm = os.path.normpath(path).replace("\\", "/")
    parts = [p for p in norm.split("/") if p and p != "."]
    if parts and parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    if parts and parts[-1] == "__init__":
        parts.pop()
    if not parts:
        return "<unknown>"
    for anchor in _PACKAGE_ANCHORS:
        if anchor in parts:
            i = len(parts) - 1 - parts[::-1].index(anchor)  # last occurrence
            return ".".join(parts[i:])
    return parts[-1]


# ------------------------------------------------------------- data model
#: execution-context tags (values appear in findings and tests).
CTX_ASYNC = "async"
CTX_SIGNAL = "signal"
CTX_THREAD = "thread"
CTX_SPAWN = "spawn"


@dataclass
class CallSite:
    """One resolved-or-not call inside a function body."""

    node: ast.Call
    line: int
    raw: Optional[str]        # dotted name as written (None: computed)
    canonical: Optional[str]  # import-alias-resolved dotted name
    target: Optional[str]     # qualname of the resolved FunctionInfo
    held: FrozenSet[str]      # lock ids lexically held at the site
    awaited: bool             # the call is directly `await`-ed
    deferred: bool            # arg to create_task/ensure_future: runs
    #                           later on the loop, NOT under the
    #                           caller's locks/contexts


@dataclass
class Acquisition:
    """A lock acquisition (``with <lock>:`` item or bare ``.acquire()``)."""

    lock: str
    node: ast.AST
    line: int
    held: FrozenSet[str]      # lock ids lexically held when acquiring


@dataclass
class FunctionInfo:
    qualname: str
    module: str
    path: str
    node: ast.AST             # def node (or the module for <module>)
    is_async: bool
    cls: Optional[str]        # enclosing class qualname (self binding)
    synthetic: bool = False   # the <module> pseudo-function
    calls: List[CallSite] = field(default_factory=list)
    acquisitions: List[Acquisition] = field(default_factory=list)


@dataclass
class ClassInfo:
    qualname: str
    module: str
    bases: List[str]                       # canonicalized dotted names
    methods: Dict[str, str] = field(default_factory=dict)  # name → qual
    #: instance-attribute types inferred from `self.X = SomeClass(...)`
    #: in any method: attr name → class qualname. Lets `self.X.m()`
    #: resolve one composition hop deep (the `self._ring.flush()`
    #: shape every manager class here uses). Conflicting assignments
    #: drop the attr — an ambiguous edge is worse than none.
    attr_types: Dict[str, str] = field(default_factory=dict)


@dataclass
class ModuleInfo:
    name: str
    path: str
    source: str
    tree: ast.Module
    imports: Dict[str, str] = field(default_factory=dict)  # absolute
    package: str = ""
    globals: Set[str] = field(default_factory=set)
    spawn_ctxs: Set[str] = field(default_factory=set)  # dotted chains
    #   assigned from multiprocessing.get_context("spawn"/"forkserver")


@dataclass
class LockCycle:
    """A strongly-connected component of ≥2 locks in the acquisition
    graph: some execution orders acquire them in conflicting order."""

    locks: Tuple[str, ...]                  # sorted, for stable output
    #: (held_lock, acquired_lock, path, line, function qualname) — one
    #: representative edge per direction, sorted by (path, line).
    edges: List[Tuple[str, str, str, int, str]]

    @property
    def anchor(self) -> Tuple[str, int]:
        return (self.edges[0][2], self.edges[0][3])


#: registration calls that run their target in a NEW context (and are
#: therefore propagation boundaries). Matching is deliberately narrow —
#: an unresolved exotic registration produces no claim either way.
_THREAD_SEEDS_KW = {"threading.Thread"}                  # target= kwarg
_EXECUTOR_ATTRS = {"run_in_executor"}                    # args[1]
_EXECUTOR_SUBMIT_ATTRS = {"submit"}                      # args[0]
_TO_THREAD = {"asyncio.to_thread"}                       # args[0]
_SIGNAL_INSTALLS = {"signal.signal"}                     # args[1]
_DEFER_CALLS = {"asyncio.create_task", "asyncio.ensure_future"}
_DEFER_ATTRS = {"create_task", "ensure_future"}

#: anchored at the comment's start so prose that merely MENTIONS the
#: marker (this file's own docs) can't mark anything.
_HOT_PATH_RE = re.compile(r"\A#[#:\s]*miner-lint:\s*sync-hot-path\b")


class Program:
    """The whole-program index. Build once per lint run (or once per
    file for single-file lints); every query is memoized."""

    def __init__(self) -> None:
        self.modules: Dict[str, ModuleInfo] = {}
        self.modules_by_path: Dict[str, ModuleInfo] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        self._by_node: Dict[int, FunctionInfo] = {}
        #: (context, target_qual, installer FunctionInfo, call node) —
        #: filled during pass 2, consumed by the propagation pass.
        self._seed_edges: List[
            Tuple[str, str, FunctionInfo, ast.Call]] = []
        #: qualnames carrying a `# miner-lint: sync-hot-path` mark.
        self.hot_paths: Dict[str, int] = {}     # qual → marker line
        #: markers that attached to no def (reported by the rule).
        self.dangling_hot_marks: List[Tuple[str, int]] = []
        # lazy results
        self._contexts: Optional[Dict[str, Set[str]]] = None
        self._ctx_prov: Dict[Tuple[str, str],
                             Optional[Tuple[str, int]]] = {}
        self._entry_locks: Optional[Dict[str, Set[str]]] = None
        self._lock_prov: Dict[Tuple[str, str], Tuple[str, int]] = {}
        self._cycles: Optional[List[LockCycle]] = None

    # ------------------------------------------------------ construction
    @classmethod
    def from_sources(cls, sources: Dict[str, str]) -> "Program":
        """Build from ``{path: source}``. Unparseable files are skipped
        (the engine reports parse errors separately, per file)."""
        prog = cls()
        for path, source in sources.items():
            try:
                tree = ast.parse(source, filename=path)
            except SyntaxError:
                continue
            name = module_name_for_path(path)
            n, suffix = name, 1
            while n in prog.modules:   # same-stem files outside packages
                n = f"{name}@{suffix}"
                suffix += 1
            mod = ModuleInfo(name=n, path=path, source=source, tree=tree)
            prog.modules[n] = mod
            prog.modules_by_path[path] = mod
        for mod in prog.modules.values():
            prog._index_module(mod)
        for mod in prog.modules.values():
            prog._infer_attr_types(mod)
        for mod in prog.modules.values():
            prog._analyze_module(mod)
        for mod in prog.modules.values():
            prog._attach_hot_marks(mod)
        return prog

    @classmethod
    def from_paths(cls, paths: List[str]) -> "Program":
        sources: Dict[str, str] = {}
        for path in paths:
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    sources[path] = fh.read()
            except (OSError, UnicodeDecodeError):
                continue
        return cls.from_sources(sources)

    # -------------------------------------------------- pass 1: symbols
    def _index_module(self, mod: ModuleInfo) -> None:
        is_pkg = os.path.basename(mod.path) == "__init__.py"
        mod.package = mod.name if is_pkg else mod.name.rpartition(".")[0]
        raw = import_map(mod.tree)
        mod.imports = {
            alias: self._resolve_relative(mod, origin)
            for alias, origin in raw.items()
        }
        for node in mod.tree.body:
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = list(node.targets)
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                targets = [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    mod.globals.add(t.id)

        def visit(nodes: List[ast.AST], prefix: str,
                  cls_qual: Optional[str], in_class: bool) -> None:
            for node in nodes:
                if isinstance(node, ast.ClassDef):
                    q = f"{prefix}.{node.name}"
                    bases = []
                    for b in node.bases:
                        d = dotted(b)
                        if d is not None:
                            bases.append(self._canon(mod, d))
                    self.classes[q] = ClassInfo(
                        qualname=q, module=mod.name, bases=bases)
                    visit(list(node.body), q, q, True)
                elif isinstance(node, _FUNC_DEFS):
                    q = f"{prefix}.{node.name}"
                    fi = FunctionInfo(
                        qualname=q, module=mod.name, path=mod.path,
                        node=node,
                        is_async=isinstance(node, ast.AsyncFunctionDef),
                        cls=cls_qual,
                    )
                    self.functions[q] = fi
                    self._by_node[id(node)] = fi
                    if in_class and cls_qual is not None:
                        self.classes[cls_qual].methods[node.name] = q
                    # cls_qual persists into nested defs: a closure
                    # inside a method still binds the method's `self`.
                    visit(list(node.body), q, cls_qual, False)
                else:
                    visit(list(ast.iter_child_nodes(node)), prefix,
                          cls_qual, in_class)

        visit(list(mod.tree.body), mod.name, None, False)

    def _resolve_relative(self, mod: ModuleInfo, origin: str) -> str:
        """``..backends.base.Hasher`` (leading dots from import_map) →
        absolute dotted name, resolved against the importing module."""
        level = 0
        while level < len(origin) and origin[level] == ".":
            level += 1
        if level == 0:
            return origin
        pkg = mod.package.split(".") if mod.package else []
        if level > 1:
            pkg = pkg[: len(pkg) - (level - 1)] if level - 1 <= len(pkg) \
                else []
        rest = origin[level:]
        return ".".join(pkg + ([rest] if rest else [])) or rest

    def _canon(self, mod: ModuleInfo, name: Optional[str]) -> Optional[str]:
        """Rewrite a dotted name's first segment through the module's
        (absolute) import map."""
        if name is None:
            return None
        head, _, rest = name.partition(".")
        origin = mod.imports.get(head)
        if origin is None:
            return name
        return f"{origin}.{rest}" if rest else origin

    # ---------------------------------------- pass 1.5: attribute types
    def _infer_attr_types(self, mod: ModuleInfo) -> None:
        """`self.X = SomeClass(...)` anywhere in a class's methods types
        the attribute (needs the full symbol table, so it runs after
        every module's pass 1)."""
        ambiguous: Set[Tuple[str, str]] = set()
        for fi in self.functions.values():
            if fi.module != mod.name or fi.cls is None:
                continue
            info = self.classes.get(fi.cls)
            if info is None:
                continue
            for node in ast.walk(fi.node):
                if not (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Call)):
                    continue
                ctor = self._class_of_ctor(mod, dotted(node.value.func))
                if ctor is None:
                    continue
                for t in node.targets:
                    chain = dotted(t)
                    if (chain is None or not chain.startswith("self.")
                            or chain.count(".") != 1):
                        continue
                    attr = chain.split(".", 1)[1]
                    key = (fi.cls, attr)
                    if key in ambiguous:
                        continue
                    prev = info.attr_types.get(attr)
                    if prev is not None and prev != ctor:
                        ambiguous.add(key)
                        del info.attr_types[attr]
                        continue
                    info.attr_types[attr] = ctor

    def _class_of_ctor(self, mod: ModuleInfo,
                       name: Optional[str]) -> Optional[str]:
        """Class qualname a constructor-looking call resolves to."""
        if name is None:
            return None
        parts = name.split(".")
        if len(parts) == 1:
            q = f"{mod.name}.{name}"
            if q in self.classes:
                return q
            origin = mod.imports.get(name)
            return origin if origin in self.classes else None
        origin = mod.imports.get(parts[0])
        full = ".".join([origin] + parts[1:]) if origin else name
        if full in self.classes:
            return full
        q = f"{mod.name}.{name}"
        return q if q in self.classes else None

    # ----------------------------------------------- pass 2: call sites
    def _analyze_module(self, mod: ModuleInfo) -> None:
        # spawn-context names first: `X = multiprocessing.get_context(
        # "spawn")` anywhere in the file (typically __init__ assigning
        # self._ctx, used from another method).
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            canon = self._canon(mod, dotted(node.value.func))
            if canon is None or not canon.endswith("get_context"):
                continue
            args = node.value.args
            if (args and isinstance(args[0], ast.Constant)
                    and args[0].value in ("spawn", "forkserver")):
                for t in node.targets:
                    chain = dotted(t)
                    if chain is not None:
                        mod.spawn_ctxs.add(chain)

        # the module body is a pseudo-function: signal handlers and
        # locks can be registered/taken at import time too.
        top = FunctionInfo(
            qualname=f"{mod.name}.<module>", module=mod.name,
            path=mod.path, node=mod.tree, is_async=False, cls=None,
            synthetic=True,
        )
        self.functions[top.qualname] = top
        self._scan_function(mod, top, mod.tree.body, env={})

        def nested_env(fi: FunctionInfo) -> Dict[str, str]:
            """Names of defs declared directly in ``fi``'s body."""
            out: Dict[str, str] = {}
            for child in ast.walk(fi.node):  # includes nested-in-if defs
                if isinstance(child, _FUNC_DEFS) and child is not fi.node:
                    sub = self._by_node.get(id(child))
                    if sub is not None and sub.qualname == \
                            f"{fi.qualname}.{child.name}":
                        out[child.name] = sub.qualname
            return out

        def recurse(fi: FunctionInfo, env: Dict[str, str]) -> None:
            env2 = dict(env)
            env2.update(nested_env(fi))
            self._scan_function(mod, fi, fi.node.body, env2)
            for child in ast.iter_child_nodes(fi.node):
                for sub in self._direct_defs(child):
                    recurse(sub, env2)

        for node in mod.tree.body:
            for fi in self._direct_defs(node):
                recurse(fi, {})

    def _direct_defs(self, node: ast.AST) -> Iterator[FunctionInfo]:
        """FunctionInfos for defs at ``node`` or nested in its non-def
        children (stops at function boundaries so each def is visited
        exactly once by ``recurse``)."""
        if isinstance(node, _FUNC_DEFS):
            fi = self._by_node.get(id(node))
            if fi is not None:
                yield fi
            return
        for child in ast.iter_child_nodes(node):
            yield from self._direct_defs(child)

    def _scan_function(self, mod: ModuleInfo, fi: FunctionInfo,
                       body: List[ast.AST], env: Dict[str, str]) -> None:
        # ids of Call nodes passed to create_task/ensure_future: those
        # coroutines run later on the loop, not at this site.
        deferred_ids: Set[int] = set()
        awaited_ids: Set[int] = set()
        stack: List[ast.AST] = list(body)
        while stack:
            node = stack.pop()
            if isinstance(node, _FUNC_DEFS):
                continue
            if isinstance(node, ast.Await):
                awaited_ids.add(id(node.value))
            if isinstance(node, ast.Call):
                canon = self._canon(mod, dotted(node.func))
                is_defer = canon in _DEFER_CALLS or (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in _DEFER_ATTRS
                )
                if is_defer:
                    for arg in node.args:
                        if isinstance(arg, ast.Call):
                            deferred_ids.add(id(arg))
            stack.extend(ast.iter_child_nodes(node))

        def scan(node: ast.AST, held: FrozenSet[str]) -> None:
            if isinstance(node, _FUNC_DEFS):
                return  # nested defs scanned as their own functions
            if isinstance(node, (ast.With, ast.AsyncWith)):
                locks: List[str] = []
                for item in node.items:
                    scan(item.context_expr, held)
                    if isinstance(node, ast.With) \
                            and _is_lockish(item.context_expr):
                        lock_id = self._lock_id(mod, fi,
                                                item.context_expr)
                        if lock_id is not None:
                            locks.append(lock_id)
                            fi.acquisitions.append(Acquisition(
                                lock=lock_id, node=node,
                                line=node.lineno, held=held))
                inner = held | frozenset(locks)
                for stmt in node.body:
                    scan(stmt, inner)
                return
            if isinstance(node, ast.Call):
                self._record_call(mod, fi, node, held,
                                  awaited=id(node) in awaited_ids,
                                  deferred=id(node) in deferred_ids,
                                  env=env)
            for child in ast.iter_child_nodes(node):
                scan(child, held)

        for stmt in body:
            scan(stmt, frozenset())

    def _record_call(self, mod: ModuleInfo, fi: FunctionInfo,
                     node: ast.Call, held: FrozenSet[str],
                     awaited: bool, deferred: bool,
                     env: Dict[str, str]) -> None:
        raw = dotted(node.func)
        canon = self._canon(mod, raw)
        target = self._resolve(mod, fi, env, raw)
        fi.calls.append(CallSite(
            node=node, line=node.lineno, raw=raw, canonical=canon,
            target=target, held=held, awaited=awaited, deferred=deferred,
        ))
        # bare `.acquire()` on a lock-like receiver: an acquisition
        # event (the holding REGION is unknowable statically, so no
        # held-set change — but the edge into the lock graph is real).
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr == "acquire"
                and _is_lockish(node.func.value)):
            lock_id = self._lock_id(mod, fi, node.func.value)
            if lock_id is not None:
                fi.acquisitions.append(Acquisition(
                    lock=lock_id, node=node, line=node.lineno,
                    held=held))

        def ref(expr: Optional[ast.AST]) -> Optional[str]:
            if expr is None:
                return None
            return self._resolve(mod, fi, env, dotted(expr))

        kwargs = {kw.arg: kw.value for kw in node.keywords if kw.arg}
        # thread / executor / spawn / signal registrations: context
        # seeds, recorded as special call kinds for the propagation pass.
        if canon in _THREAD_SEEDS_KW:
            tgt = ref(kwargs.get("target"))
            if tgt is not None:
                self._seed_edges.append((CTX_THREAD, tgt, fi, node))
        elif canon in _TO_THREAD and node.args:
            tgt = ref(node.args[0])
            if tgt is not None:
                self._seed_edges.append((CTX_THREAD, tgt, fi, node))
        elif (isinstance(node.func, ast.Attribute)
              and node.func.attr in _EXECUTOR_ATTRS
              and len(node.args) >= 2):
            tgt = ref(node.args[1])
            if tgt is not None:
                self._seed_edges.append((CTX_THREAD, tgt, fi, node))
        elif (isinstance(node.func, ast.Attribute)
              and node.func.attr in _EXECUTOR_SUBMIT_ATTRS
              and node.args):
            tgt = ref(node.args[0])
            if tgt is not None:
                self._seed_edges.append((CTX_THREAD, tgt, fi, node))
        elif (isinstance(node.func, ast.Attribute)
              and node.func.attr == "Process"):
            recv = dotted(node.func.value)
            is_spawn = (recv in mod.spawn_ctxs) or (
                isinstance(node.func.value, ast.Call)
                and (self._canon(mod, dotted(node.func.value.func))
                     or "").endswith("get_context")
            )
            if is_spawn:
                tgt = ref(kwargs.get("target"))
                if tgt is not None:
                    self._seed_edges.append((CTX_SPAWN, tgt, fi, node))
        elif ((canon in _SIGNAL_INSTALLS
               or (isinstance(node.func, ast.Attribute)
                   and node.func.attr == "add_signal_handler"))
              and len(node.args) >= 2):
            tgt = ref(node.args[1])
            if tgt is not None:
                self._seed_edges.append((CTX_SIGNAL, tgt, fi, node))

    # ---------------------------------------------------- name resolution
    def resolve_in(self, fi: FunctionInfo,
                   name: Optional[str]) -> Optional[str]:
        """Public resolution seam for rules/tests: a dotted name as
        written inside ``fi`` (``self.X``, an alias, a bare module
        function) → target qualname, or None. Nested-def names are not
        visible here (they were resolved during the build pass, which
        carried the lexical environment)."""
        mod = self.modules.get(fi.module)
        if mod is None:
            return None
        return self._resolve(mod, fi, {}, name)

    def _resolve(self, mod: ModuleInfo, fi: FunctionInfo,
                 env: Dict[str, str],
                 name: Optional[str]) -> Optional[str]:
        """Dotted name as written inside ``fi`` → target qualname."""
        if name is None:
            return None
        parts = name.split(".")
        head = parts[0]
        if head in ("self", "cls"):
            if fi.cls is None:
                return None
            if len(parts) == 2:
                return self.resolve_method(fi.cls, parts[1])
            if len(parts) == 3:
                # `self.attr.m()` through the inferred attribute type
                # (one composition hop; deeper chains stay unresolved).
                attr_cls = self._attr_type(fi.cls, parts[1])
                if attr_cls is not None:
                    return self.resolve_method(attr_cls, parts[2])
            return None
        if len(parts) == 1:
            if name in env:
                return env[name]
            q = f"{mod.name}.{name}"
            if q in self.functions:
                return q
            if q in self.classes:
                return self.resolve_method(q, "__init__")
            origin = mod.imports.get(name)
            return self._lookup(origin) if origin else None
        origin = mod.imports.get(head)
        full = ".".join([origin] + parts[1:]) if origin else name
        hit = self._lookup(full)
        if hit is not None:
            return hit
        # `Cls.method` / `helper().x` style via module globals:
        # `mod.globals` only names module-level bindings, so a dotted
        # chain headed by one resolves inside this module.
        if head in mod.globals or f"{mod.name}.{head}" in self.classes:
            return self._lookup(f"{mod.name}.{name}")
        return None

    def _lookup(self, name: Optional[str]) -> Optional[str]:
        if name is None:
            return None
        if name in self.functions:
            return name
        if name in self.classes:
            return self.resolve_method(name, "__init__")
        head, _, last = name.rpartition(".")
        if head in self.classes:
            return self.resolve_method(head, last)
        return None

    def resolve_method(self, cls_qual: str, method: str,
                       _seen: Optional[Set[str]] = None) -> Optional[str]:
        """Method lookup through program-resolvable bases (BFS in base
        order — close enough to MRO for a lint)."""
        seen = _seen if _seen is not None else set()
        if cls_qual in seen:
            return None
        seen.add(cls_qual)
        info = self.classes.get(cls_qual)
        if info is None:
            return None
        if method in info.methods:
            return info.methods[method]
        for base in info.bases:
            # A bare base defined in the same module canonicalizes to
            # itself — qualify it through the owning module's namespace.
            base_cls = base if base in self.classes \
                else self._class_lookup(f"{info.module}.{base}")
            if base_cls is None:
                continue
            hit = self.resolve_method(base_cls, method, seen)
            if hit is not None:
                return hit
        return None

    def _class_lookup(self, name: str) -> Optional[str]:
        return name if name in self.classes else None

    def _attr_type(self, cls_qual: str, attr: str,
                   _seen: Optional[Set[str]] = None) -> Optional[str]:
        """Inferred type of ``self.<attr>`` for a class (checking
        program-resolvable bases too)."""
        seen = _seen if _seen is not None else set()
        if cls_qual in seen:
            return None
        seen.add(cls_qual)
        info = self.classes.get(cls_qual)
        if info is None:
            return None
        if attr in info.attr_types:
            return info.attr_types[attr]
        for base in info.bases:
            base_cls = base if base in self.classes \
                else self._class_lookup(f"{info.module}.{base}")
            if base_cls is None:
                continue
            hit = self._attr_type(base_cls, attr, seen)
            if hit is not None:
                return hit
        return None

    # ------------------------------------------------------- lock identity
    def _lock_id(self, mod: ModuleInfo, fi: FunctionInfo,
                 expr: ast.AST) -> Optional[str]:
        """Stable program-wide id for a lock expression. ``self._lock``
        in class C of module m → ``m.C._lock`` (every instance of C
        shares the ORDER even though each has its own lock object — and
        lock-order cycles are about order, not identity)."""
        d = dotted(expr)
        if d is None:
            if isinstance(expr, ast.Call):  # `with threading.Lock():`
                return f"{fi.qualname}.<anon:L{expr.lineno}>"
            return None
        head, _, rest = d.partition(".")
        if head in ("self", "cls"):
            if fi.cls is None:
                return None
            return f"{fi.cls}.{rest}" if rest else None
        if head in mod.imports:
            canon = self._canon(mod, d)
            return canon
        if head in mod.globals:
            return f"{mod.name}.{d}"
        return f"{fi.qualname}:{d}"  # function-local lock

    # ------------------------------------------------ context propagation
    def contexts(self, qualname: str) -> FrozenSet[str]:
        self._ensure_contexts()
        assert self._contexts is not None
        return frozenset(self._contexts.get(qualname, ()))

    def context_chain(self, qualname: str,
                      ctx: str) -> List[Tuple[str, Optional[int]]]:
        """Seed-first chain of (qualname, call line) explaining why
        ``qualname`` carries ``ctx``. The seed's line is the install/
        registration site (None for an `async def` seed)."""
        self._ensure_contexts()
        missing = object()
        chain: List[Tuple[str, Optional[int]]] = []
        cur = qualname
        for _ in range(64):  # cycle guard
            prov = self._ctx_prov.get((cur, ctx), missing)
            if prov is missing or prov is None:
                # seed (async def / registration target), or an
                # installer that doesn't carry the context itself.
                chain.append((cur, None))
                break
            chain.append((cur, prov[1]))
            cur = prov[0]
        chain.reverse()
        return chain

    def _ensure_contexts(self) -> None:
        if self._contexts is not None:
            return
        ctxs: Dict[str, Set[str]] = {}
        prov = self._ctx_prov
        work: List[Tuple[str, str]] = []

        def add(qual: str, ctx: str,
                origin: Optional[Tuple[str, int]]) -> None:
            have = ctxs.setdefault(qual, set())
            if ctx in have:
                return
            have.add(ctx)
            prov[(qual, ctx)] = origin
            work.append((qual, ctx))

        for fi in self.functions.values():
            if fi.is_async:
                add(fi.qualname, CTX_ASYNC, None)
        for ctx, target, installer, node in self._seed_edges:
            if target in self.functions:
                add(target, ctx, (installer.qualname, node.lineno))

        while work:
            qual, ctx = work.pop()
            fi = self.functions.get(qual)
            if fi is None:
                continue
            for site in fi.calls:
                if site.target is None or site.deferred:
                    continue
                callee = self.functions.get(site.target)
                if callee is None or callee.is_async:
                    # an async callee's running context is the event
                    # loop (its own ASYNC seed) — the caller's context
                    # describes where the COROUTINE OBJECT is built,
                    # not where its body runs.
                    continue
                add(site.target, ctx, (qual, site.line))
        self._contexts = ctxs

    # ------------------------------------------------ held-lock propagation
    def entry_locks(self, qualname: str) -> FrozenSet[str]:
        """Lock ids some caller chain can hold when entering the
        function (beyond what the function takes itself)."""
        self._ensure_locks()
        assert self._entry_locks is not None
        return frozenset(self._entry_locks.get(qualname, ()))

    def lock_chain(self, qualname: str,
                   lock: str) -> List[Tuple[str, Optional[int]]]:
        """Holder-first chain of (qualname, call line) explaining how
        ``qualname`` is reached with ``lock`` held."""
        self._ensure_locks()
        chain: List[Tuple[str, Optional[int]]] = []
        cur = qualname
        guard = 0
        while guard < 64:
            guard += 1
            prov = self._lock_prov.get((cur, lock))
            if prov is None:
                chain.append((cur, None))
                break
            chain.append((cur, prov[1]))
            cur = prov[0]
        chain.reverse()
        return chain

    def _ensure_locks(self) -> None:
        if self._entry_locks is not None:
            return
        entry: Dict[str, Set[str]] = {}
        work: List[str] = []

        def flow(caller: str, site: CallSite,
                 locks: FrozenSet[str]) -> None:
            if site.target is None or site.deferred or not locks:
                return
            callee = self.functions.get(site.target)
            if callee is None:
                return
            if callee.is_async and not site.awaited:
                # un-awaited coroutine: its body does not run under
                # the caller's lock.
                return
            have = entry.setdefault(site.target, set())
            new = locks - have
            if not new:
                return
            have |= new
            for lock in new:
                self._lock_prov.setdefault(
                    (site.target, lock), (caller, site.line))
            work.append(site.target)

        for fi in self.functions.values():
            for site in fi.calls:
                flow(fi.qualname, site, site.held)
        while work:
            qual = work.pop()
            fi = self.functions.get(qual)
            if fi is None:
                continue
            inherited = frozenset(entry.get(qual, ()))
            for site in fi.calls:
                flow(qual, site, site.held | inherited)
        self._entry_locks = entry

    # --------------------------------------------------------- lock graph
    def lock_edges(self) -> Dict[Tuple[str, str],
                                 Tuple[str, int, str]]:
        """(held, acquired) → first (path, line, function) evidence."""
        self._ensure_locks()
        assert self._entry_locks is not None
        edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
        for fi in sorted(self.functions.values(),
                         key=lambda f: (f.path, f.qualname)):
            inherited = frozenset(self._entry_locks.get(fi.qualname, ()))
            for acq in fi.acquisitions:
                for held in sorted(acq.held | inherited):
                    if held == acq.lock:
                        continue  # re-entry: RLock territory, not order
                    key = (held, acq.lock)
                    ev = (fi.path, acq.line, fi.qualname)
                    if key not in edges or ev < edges[key]:
                        edges[key] = ev
        return edges

    def lock_cycles(self) -> List[LockCycle]:
        """Strongly-connected components (≥2 locks) of the acquisition
        graph — each is a set of locks some pair of execution paths
        acquires in conflicting order (the launch-lock deadlock shape)."""
        if self._cycles is not None:
            return self._cycles
        edges = self.lock_edges()
        adj: Dict[str, List[str]] = {}
        for (a, b) in edges:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, [])
        # iterative Tarjan SCC
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on_stack: Set[str] = set()
        stack: List[str] = []
        sccs: List[List[str]] = []
        counter = [0]

        def strongconnect(root: str) -> None:
            call: List[Tuple[str, int]] = [(root, 0)]
            while call:
                v, pi = call[-1]
                if pi == 0:
                    index[v] = low[v] = counter[0]
                    counter[0] += 1
                    stack.append(v)
                    on_stack.add(v)
                recursed = False
                succs = adj.get(v, [])
                while pi < len(succs):
                    w = succs[pi]
                    pi += 1
                    if w not in index:
                        call[-1] = (v, pi)
                        call.append((w, 0))
                        recursed = True
                        break
                    if w in on_stack:
                        low[v] = min(low[v], index[w])
                if recursed:
                    continue
                call.pop()
                if low[v] == index[v]:
                    comp: List[str] = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.append(w)
                        if w == v:
                            break
                    if len(comp) > 1:
                        sccs.append(comp)
                if call:
                    parent = call[-1][0]
                    low[parent] = min(low[parent], low[v])

        for v in sorted(adj):
            if v not in index:
                strongconnect(v)

        cycles: List[LockCycle] = []
        for comp in sccs:
            comp_set = set(comp)
            cyc_edges = sorted(
                (a, b, ev[0], ev[1], ev[2])
                for (a, b), ev in edges.items()
                if a in comp_set and b in comp_set
            )
            cyc_edges.sort(key=lambda e: (e[2], e[3], e[0], e[1]))
            cycles.append(LockCycle(
                locks=tuple(sorted(comp_set)), edges=cyc_edges))
        cycles.sort(key=lambda c: c.anchor)
        self._cycles = cycles
        return cycles

    # ------------------------------------------------------ hot-path marks
    def _attach_hot_marks(self, mod: ModuleInfo) -> None:
        marks: List[int] = []
        # engine._comment_tokens tokenizes so a STRING mentioning the
        # marker can't mark anything; import here to avoid a cycle at
        # module load (engine does not import callgraph at top level).
        from .engine import _comment_tokens

        for lineno, _col, text in _comment_tokens(mod.source):
            if _HOT_PATH_RE.match(text):
                marks.append(lineno)
        if not marks:
            return
        by_line: Dict[int, str] = {}
        for fi in self.functions.values():
            if fi.module == mod.name and not fi.synthetic:
                by_line[fi.node.lineno] = fi.qualname
        for line in marks:
            qual = by_line.get(line) or by_line.get(line + 1)
            if qual is not None:
                self.hot_paths[qual] = line
            else:
                self.dangling_hot_marks.append((mod.path, line))

    # ---------------------------------------------------------- reachability
    def reachable(self, root: str) -> Dict[str, List[Tuple[str, int]]]:
        """BFS over direct (non-deferred) call edges from ``root``:
        target qualname → call chain [(caller, line), …] root-first."""
        out: Dict[str, List[Tuple[str, int]]] = {}
        fi = self.functions.get(root)
        if fi is None:
            return out
        queue: List[str] = [root]
        while queue:
            qual = queue.pop(0)
            cur = self.functions.get(qual)
            if cur is None:
                continue
            base = out.get(qual, [])
            for site in cur.calls:
                if site.target is None or site.deferred:
                    continue
                if site.target in out or site.target == root:
                    continue
                out[site.target] = base + [(qual, site.line)]
                queue.append(site.target)
        return out

    # -------------------------------------------------------- file helpers
    def module_for_path(self, path: str) -> Optional[ModuleInfo]:
        return self.modules_by_path.get(path)

    def function_for_node(self, node: ast.AST) -> Optional[FunctionInfo]:
        """FunctionInfo for a def node FROM THIS PROGRAM'S TREES (the
        engine hands rules the program's tree so identities line up)."""
        return self._by_node.get(id(node))


def format_chain(chain: List[Tuple[str, Optional[int]]]) -> str:
    """`a.b (line 12) → c.d (line 40) → e.f` for findings."""
    parts = []
    for qual, line in chain:
        parts.append(f"{qual}:{line}" if line is not None else qual)
    return " -> ".join(parts)
