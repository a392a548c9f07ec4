"""The miner-lint rule set: the bug classes the reference shipped,
root-caused, and paid for — pinned by AST and by the whole-program call
graph (analysis/callgraph.py): ``blocking-in-async``,
``lock-across-await`` and ``signal-handler-safety`` fire through
arbitrary helper depth, and three rules pin the cross-function
postmortems (``lock-order-cycle``: the mesh ring's launch lock;
``sync-hot-path-await``: the pool frontend's synchronous dispatch;
``spawn-unpicklable``: the shard children).

Counterpart of ``bitcoin_miner_tpu/analysis/rules.py``, with the same
15 rules, anchored on this package: its ``telemetry/`` is the one home
of metric declarations, and ``device-claiming-import`` also holds the
port's boundary (no ``jax`` and no ``bitcoin_miner_tpu`` anywhere in the
package or its root scripts; no ``torch`` in an import-safe module).

Each rule documents the postmortem it came from (``origin``). Rules are
HEURISTIC and deliberately strict: a true hazard must never pass, and an
intentional instance is suppressed in place
with ``# miner-lint: disable=<rule> -- <why this is safe>`` — the
justification string doubles as the comment the code should have had
anyway. Engine/suppression semantics live in engine.py; the findings
ratchet (analysis/lint_baseline.json) lets a deepened rule land while
its surfaced pre-existing findings are burned down.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .callgraph import (  # shared AST utils live with the call graph
    CTX_ASYNC,
    FunctionInfo,
    Program,
    _is_lockish,
    _LOCK_CTORS,   # noqa: F401 — re-export (tests import from rules)
    _LOCKISH_RE,   # noqa: F401 — re-export
    dotted,
    format_chain,
    import_map,
)
from .engine import FileContext, Finding, Rule, register

# --------------------------------------------------------------- AST utils
_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
_SCOPE_NODES = _FUNC_NODES + (ast.ClassDef,)


def scope_walk(nodes) -> Iterator[ast.AST]:
    """Walk statements/expressions WITHOUT crossing into nested function
    or class scopes (a nested def has its own control flow; findings
    about the enclosing function must not read through it)."""
    stack = list(nodes) if isinstance(nodes, (list, tuple)) else [nodes]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _SCOPE_NODES):
                continue
            stack.append(child)


def iter_functions(tree: ast.Module) -> Iterator[Tuple[ast.AST, bool,
                                                       Optional[ast.ClassDef]]]:
    """Every function in the module as (node, is_async, enclosing class)."""
    stack: List[Tuple[ast.AST, Optional[ast.ClassDef]]] = [(tree, None)]
    while stack:
        node, cls = stack.pop()
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                stack.append((child, child))
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield child, isinstance(child, ast.AsyncFunctionDef), cls
                stack.append((child, None))
            else:
                stack.append((child, cls))


def canonical(name: Optional[str], imports: Dict[str, str]) -> Optional[str]:
    """Rewrite a dotted name's first segment through the import map."""
    if name is None:
        return None
    head, _, rest = name.partition(".")
    origin = imports.get(head)
    if origin is None:
        return name
    return f"{origin}.{rest}" if rest else origin


def _is_const_true(test: ast.AST) -> bool:
    return isinstance(test, ast.Constant) and bool(test.value) is True


def _function_info(ctx: FileContext,
                   func: ast.AST) -> Optional[FunctionInfo]:
    """The whole-program FunctionInfo for a def node of ``ctx.tree``
    (None when the engine handed the rule a tree the program doesn't
    own — single-file fallback paths keep working, just one-hop)."""
    program = ctx.program
    if not isinstance(program, Program):
        return None
    return program.function_for_node(func)


def _awaited_values(func_body) -> Set[int]:
    """ids of expressions that are directly ``await``-ed."""
    return {
        id(node.value) for node in scope_walk(func_body)
        if isinstance(node, ast.Await)
    }


# ------------------------------------------------------- 1 swallowed-cancel
_BROAD_CATCHES = {"Exception", "BaseException", "CancelledError",
                  "asyncio.CancelledError"}


def _catches_broad(handler_type: Optional[ast.AST]) -> bool:
    if handler_type is None:  # bare except
        return True
    if isinstance(handler_type, ast.Tuple):
        return any(_catches_broad(e) for e in handler_type.elts)
    name = dotted(handler_type)
    return name in _BROAD_CATCHES


@register
class SwallowedCancelRule(Rule):
    name = "swallowed-cancel"
    summary = ("broad except inside an async `while True` that neither "
               "re-raises nor breaks — a swallowed CancelledError parks "
               "the loop forever")
    origin = "dispatcher worker teardown hang (e2e stratum flake)"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for func, is_async, _cls in iter_functions(ctx.tree):
            if not is_async:
                continue
            for loop in scope_walk(func.body):
                if not (isinstance(loop, ast.While)
                        and _is_const_true(loop.test)):
                    continue
                for node in scope_walk(loop.body):
                    if not isinstance(node, ast.Try):
                        continue
                    has_await = any(
                        isinstance(n, ast.Await)
                        for n in scope_walk(node.body)
                    )
                    if not has_await:
                        continue
                    def _reraises_cancel(h: ast.ExceptHandler) -> bool:
                        return (
                            h.type is not None
                            and (dotted(h.type) or "").endswith(
                                "CancelledError")
                            and any(isinstance(n, ast.Raise)
                                    for n in scope_walk(h.body))
                        )

                    for idx, handler in enumerate(node.handlers):
                        if not _catches_broad(handler.type):
                            continue
                        # An `except CancelledError: raise` EARLIER in
                        # the handler list shows cancellation is handled
                        # deliberately — this broad handler only sees
                        # real errors. A later one is dead code (the
                        # broad handler wins at runtime), so it earns no
                        # credit.
                        if any(_reraises_cancel(h)
                               for h in node.handlers[:idx]):
                            continue
                        exits = any(
                            isinstance(n, (ast.Raise, ast.Break,
                                           ast.Return))
                            for n in scope_walk(handler.body)
                        )
                        if exits:
                            continue
                        yield ctx.finding(
                            self.name, handler,
                            "broad `except` swallows a teardown "
                            "CancelledError inside `while True` — the "
                            "loop's one cancellation gets spent and the "
                            "task parks forever on the next await (the "
                            "dispatcher teardown hang). Re-raise "
                            "CancelledError / break, or loop on a stop "
                            "flag (`while not self._stopping`)",
                        )


# ------------------------------------------------------ 2 blocking-in-async
_BLOCKING_CALLS = {
    "time.sleep": "use `await asyncio.sleep(...)`",
    "subprocess.run": "use asyncio.create_subprocess_exec or an executor",
    "subprocess.call": "use asyncio.create_subprocess_exec or an executor",
    "subprocess.check_call": "use asyncio subprocess or an executor",
    "subprocess.check_output": "use asyncio subprocess or an executor",
    "subprocess.Popen": "use asyncio.create_subprocess_exec",
    "os.system": "use asyncio subprocess or an executor",
    "os.popen": "use asyncio subprocess or an executor",
    "socket.create_connection": "use asyncio.open_connection or "
                                "run_in_executor (the blocking-probe "
                                "class)",
    "socket.getaddrinfo": "use loop.getaddrinfo",
    "socket.gethostbyname": "use loop.getaddrinfo",
    "urllib.request.urlopen": "use run_in_executor (or the asyncio HTTP "
                              "client the repo already has)",
    "requests.get": "use run_in_executor",
    "requests.post": "use run_in_executor",
    "requests.request": "use run_in_executor",
}


@register
class BlockingInAsyncRule(Rule):
    name = "blocking-in-async"
    summary = ("blocking call (time.sleep / socket / urllib / subprocess "
               "/ Lock.acquire) inside an `async def` body, or — via the "
               "call graph — in any sync helper reachable from one")
    origin = ("a blocking TCP probe nearly run on the event loop; "
              "transitive through the call graph")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        imports = import_map(ctx.tree)
        for func, is_async, _cls in iter_functions(ctx.tree):
            if is_async:
                awaited = _awaited_values(func.body)
                for node in scope_walk(func.body):
                    if not isinstance(node, ast.Call):
                        continue
                    name = canonical(dotted(node.func), imports)
                    if name in _BLOCKING_CALLS:
                        yield ctx.finding(
                            self.name, node,
                            f"`{name}` blocks the event loop inside an "
                            f"async function — {_BLOCKING_CALLS[name]}",
                        )
                        continue
                    # thread-Lock acquire not awaited: asyncio
                    # primitives' acquire() is awaited; a bare
                    # .acquire() on a lock-like receiver parks the
                    # whole loop.
                    if (isinstance(node.func, ast.Attribute)
                            and node.func.attr == "acquire"
                            and id(node) not in awaited
                            and _is_lockish(node.func.value)):
                        recv = dotted(node.func.value) or "<lock>"
                        yield ctx.finding(
                            self.name, node,
                            f"`{recv}.acquire()` (not awaited) can block "
                            "the event loop — take the lock in an "
                            "executor, or use an asyncio primitive",
                        )
                continue
            # Transitive arm: a SYNC function the call graph
            # proves reachable from an `async def` (through any helper
            # depth) runs ON the loop — a blocking call here stalls it
            # exactly as if it were written in the coroutine. Thread/
            # executor/spawn registrations are boundaries (the program
            # seeds those contexts instead of propagating async), so a
            # helper only run via run_in_executor never fires.
            fi = _function_info(ctx, func)
            if fi is None:
                continue
            program: Program = ctx.program
            if CTX_ASYNC not in program.contexts(fi.qualname):
                continue
            chain = format_chain(
                program.context_chain(fi.qualname, CTX_ASYNC))
            for node in scope_walk(func.body):
                if not isinstance(node, ast.Call):
                    continue
                name = canonical(dotted(node.func), imports)
                if name in _BLOCKING_CALLS:
                    yield ctx.finding(
                        self.name, node,
                        f"`{name}` blocks the event loop: this sync "
                        f"function is reachable from async code "
                        f"({chain}) — {_BLOCKING_CALLS[name]}, or move "
                        "the whole caller chain off the loop "
                        "(run_in_executor / asyncio.to_thread)",
                    )


# ------------------------------------------------------ 3 lock-across-await
@register
class LockAcrossAwaitRule(Rule):
    name = "lock-across-await"
    summary = ("`await` lexically inside a `with <lock>` block, or — "
               "via the call graph — in an async helper some caller "
               "chain enters with a threading lock held")
    origin = ("distilled from the lock-discipline postmortems; "
              "transitive through the call graph")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for func, is_async, _cls in iter_functions(ctx.tree):
            if not is_async:
                continue
            lexical_awaits: Set[int] = set()
            for node in scope_walk(func.body):
                if not isinstance(node, ast.With):
                    continue
                if not any(_is_lockish(item.context_expr)
                           for item in node.items):
                    continue
                for inner in scope_walk(node.body):
                    if isinstance(inner, ast.Await):
                        lexical_awaits.add(id(inner))
                        yield ctx.finding(
                            self.name, inner,
                            "await while holding a threading lock: every "
                            "other thread blocks for the whole "
                            "suspension (and a re-entry deadlocks). "
                            "Snapshot under the lock, await outside — "
                            "or use asyncio.Lock with `async with`",
                        )
            # Transitive arm: held locks propagate through
            # the call graph (a call made inside `with <lock>` enters
            # the callee with the lock held; awaited async callees
            # inherit it). An async function entered that way suspends
            # under the caller's lock — same hazard, helper depth away.
            fi = _function_info(ctx, func)
            if fi is None:
                continue
            program: Program = ctx.program
            held = sorted(program.entry_locks(fi.qualname))
            if not held:
                continue
            candidates = [
                n for n in scope_walk(func.body)
                if isinstance(n, ast.Await)
                and id(n) not in lexical_awaits
            ]
            if not candidates:
                continue
            first_await = min(
                candidates, key=lambda n: (n.lineno, n.col_offset))
            lock = held[0]
            chain = format_chain(program.lock_chain(fi.qualname, lock))
            yield ctx.finding(
                self.name, first_await,
                f"this async function can be entered with threading "
                f"lock `{lock}` held ({chain}); its awaits then "
                "suspend while every other thread blocks on the lock. "
                "Release before calling in, or restructure so the "
                "await happens outside the locked region",
            )


# -------------------------------------------------- 4 signal-handler-safety
_IO_CALLS = {"open", "os.write", "os.fsync", "print", "json.dump"}


def _unsafe_in_body(body, imports: Dict[str, str]) -> Optional[str]:
    """Reason string for the first async-signal-unsafe operation
    LEXICALLY in a body (no call following — the program BFS does
    that)."""
    for node in scope_walk(body):
        if isinstance(node, ast.With):
            if any(_is_lockish(item.context_expr) for item in node.items):
                return "takes a lock (`with <lock>`)"
        if not isinstance(node, ast.Call):
            continue
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr == "acquire"):
            return "acquires a lock"
        name = canonical(dotted(node.func), imports)
        if name in _IO_CALLS:
            return f"does I/O (`{name}`)"
    return None


def _unsafe_in_function(program: Program,
                        fi: FunctionInfo) -> Optional[str]:
    mod = program.modules.get(fi.module)
    imports = mod.imports if mod is not None else {}
    body = fi.node.body if hasattr(fi.node, "body") else []
    return _unsafe_in_body(body, imports)


@register
class SignalHandlerSafetyRule(Rule):
    name = "signal-handler-safety"
    summary = ("signal handler takes a lock or does I/O on the main "
               "thread — anywhere in its call graph — a signal landing "
               "inside the same lock self-deadlocks the process")
    origin = ("SIGUSR2 flight-recorder dump deadlock; whole-"
              "program (the original bug hid behind "
              "`self.record()` — now any depth is followed)")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        program = ctx.program
        if not isinstance(program, Program):
            return
        mod = program.module_for_path(ctx.path)
        imports = import_map(ctx.tree)
        # Scan every scope a handler can be installed from: the module
        # body itself plus every function (the enclosing FunctionInfo
        # carries the class binding `self.X` resolves through).
        scopes: List[Tuple[List[ast.AST], Optional[FunctionInfo]]] = [
            (list(ctx.tree.body),
             program.functions.get(f"{mod.name}.<module>")
             if mod is not None else None)
        ] + [
            (func.body, _function_info(ctx, func))
            for func, _is_async, _cls in iter_functions(ctx.tree)
        ]
        for scope_body, scope_fi in scopes:
            for node in scope_walk(scope_body):
                if not isinstance(node, ast.Call) or len(node.args) < 2:
                    continue
                name = canonical(dotted(node.func), imports)
                is_install = (
                    (name is not None and (name == "signal.signal"
                                           or name.endswith(".signal")
                                           and name.startswith("signal")))
                    or (isinstance(node.func, ast.Attribute)
                        and node.func.attr == "add_signal_handler")
                )
                if not is_install:
                    continue
                handler = node.args[1]
                if isinstance(handler, ast.Lambda):
                    reason = _unsafe_in_body([handler.body], imports)
                    if reason is not None:
                        yield self._finding(ctx, node, reason)
                    continue
                if scope_fi is None:
                    continue
                qual = program.resolve_in(scope_fi, dotted(handler))
                if qual is None:
                    continue  # unresolvable handler: no claim either way
                target = program.functions.get(qual)
                if target is None:
                    continue
                reason = _unsafe_in_function(program, target)
                if reason is None:
                    # Whole-program depth: the SIGUSR2 bug hid
                    # one call down; real handlers hide arbitrary
                    # layers down. Walk everything the handler reaches.
                    for reached, chain in sorted(
                            program.reachable(qual).items()):
                        rfi = program.functions.get(reached)
                        if rfi is None:
                            continue
                        hit = _unsafe_in_function(program, rfi)
                        if hit is not None:
                            via = format_chain(
                                [(q, ln) for q, ln in chain]
                                + [(reached, None)])
                            reason = f"reaches `{reached}` (via {via}), " \
                                     f"which {hit}"
                            break
                if reason is not None:
                    yield self._finding(ctx, node, reason)

    def _finding(self, ctx: FileContext, node: ast.AST,
                 reason: str) -> Finding:
        return ctx.finding(
            self.name, node,
            f"signal handler {reason} — CPython runs it between "
            "bytecodes ON the main thread, so a signal landing while "
            "that thread holds the same lock (or mid-I/O) deadlocks/"
            "corrupts (the SIGUSR2 recorder class). Hand the work to a "
            "helper thread instead",
        )


# ----------------------------------------------- 5 device-claiming-import
#: files that must stay import-safe: importing torch there costs the
#: host tooling that only wanted to read a ledger, serve a pool or parse
#: args seconds of start-up (and the CUDA runtime, once touched); jax has
#: no business anywhere in this package.
_IMPORT_SAFE_PATHS = (
    # ALL of telemetry/ — not just perfledger: the linter itself imports
    # telemetry.vocabulary → telemetry.pipeline → flightrec/metrics/
    # tracing at lint time, so the whole package must hold the contract
    # or `lint` becomes the process that loads torch (and the
    # observability layer is host-side by design anyway).
    "/bitcoin_miner_tpu_torch/telemetry/",
    "/bitcoin_miner_tpu_torch/perf_cli.py",
    "/bitcoin_miner_tpu_torch/protocol/",
    "/bitcoin_miner_tpu_torch/utils/",
    "/bitcoin_miner_tpu_torch/analysis/",
)
_IMPORT_SAFE_MARKER = "miner-lint: import-safe"

#: where the port's boundary holds: every file of the package, and the
#: root scripts that drive it on the card.
_PORT_DIR = "/bitcoin_miner_tpu_torch/"
_PORT_ROOT_SCRIPTS = ("chip_smoke.py", "sweep_pairs.py")

#: top-level packages an import-safe module must not import at runtime.
_DEVICE_PACKAGES = ("torch", "jax", "jaxlib")
#: top-level packages the port must not import at all: jax, and the JAX
#: package it was ported from (the port keeps its own copy of each
#: module it needs).
_BOUNDARY_PACKAGES = ("jax", "jaxlib", "bitcoin_miner_tpu")


def _abspath(ctx: FileContext) -> str:
    # Absolute path so the checks are cwd-independent (the lint may be
    # pointed at a file from anywhere; the contract is about where the
    # file LIVES).
    return os.path.abspath(ctx.path).replace("\\", "/")


def _is_import_safe_file(ctx: FileContext) -> bool:
    path = _abspath(ctx)
    if any(part in path for part in _IMPORT_SAFE_PATHS):
        return True
    # Anywhere in the file: docstrings in this repo routinely run past
    # any fixed head window, and the marker can only WIDEN enforcement.
    return _IMPORT_SAFE_MARKER in ctx.source


def _is_port_file(ctx: FileContext) -> bool:
    path = _abspath(ctx)
    return _PORT_DIR in path or path.rsplit("/", 1)[-1] in _PORT_ROOT_SCRIPTS


def _in_type_checking(tree: ast.Module) -> Set[int]:
    """ids of import nodes guarded by ``if TYPE_CHECKING:`` (those never
    execute at runtime and are fine anywhere)."""
    guarded: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.If):
            test = dotted(node.test)
            if test and test.rsplit(".", 1)[-1] == "TYPE_CHECKING":
                for child in ast.walk(node):
                    if isinstance(child, (ast.Import, ast.ImportFrom)):
                        guarded.add(id(child))
    return guarded


def _imported_modules(node: ast.AST) -> List[str]:
    """Absolute module names an import statement loads (a relative
    ``from . import x`` stays inside its package and loads none)."""
    if isinstance(node, ast.Import):
        return [alias.name for alias in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
        return [node.module]
    return []


@register
class DeviceClaimingImportRule(Rule):
    name = "device-claiming-import"
    summary = ("`import torch`/`import jax` in a file that must stay "
               "import-safe (telemetry/, perf_cli, protocol/, utils/, "
               "analysis/, or any file carrying the `miner-lint: "
               "import-safe` marker), or any import of jax or of the JAX "
               "package `bitcoin_miner_tpu` in the port or its root "
               "scripts")
    origin = ("the reference's never-import-jax rule for host tooling, "
              "widened to the port's boundary: no jax and no "
              "bitcoin_miner_tpu")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        import_safe = _is_import_safe_file(ctx)
        in_port = _is_port_file(ctx)
        if not (import_safe or in_port):
            return
        guarded = _in_type_checking(ctx.tree)
        for node in ast.walk(ctx.tree):
            if id(node) in guarded:
                continue
            for module in _imported_modules(node):
                top = module.split(".", 1)[0]
                if in_port and top in _BOUNDARY_PACKAGES:
                    yield ctx.finding(
                        self.name, node,
                        f"`import {module}` crosses the port's boundary: "
                        "the PyTorch/CUDA package and its root scripts "
                        "import neither jax nor the JAX package "
                        "`bitcoin_miner_tpu`, which the port is held "
                        "against, never built on. Keep a copy of what "
                        "this needs in bitcoin_miner_tpu_torch/",
                    )
                    break
                if import_safe and top in _DEVICE_PACKAGES:
                    yield ctx.finding(
                        self.name, node,
                        f"`import {module}` in an import-safe module: "
                        f"loading {top} costs seconds and claims the "
                        "device once touched — this file is read by host "
                        "tooling (the lint, the perf ledger, the pool "
                        "frontend) that must run with no card and no "
                        "device library. Read versions via "
                        "importlib.metadata, or move the use behind the "
                        "backend seam",
                    )
                    break


# ----------------------------------------------- 6 await-state-snapshot
@register
class AwaitStateSnapshotRule(Rule):
    name = "await-state-snapshot"
    summary = ("shared mutable state (`self.x.y`) read on both sides of "
               "an await without a local snapshot — the two reads can "
               "disagree")
    origin = "mid-flight difficulty-retarget share weighting"

    _MIN_HOPS = 2  # self.a.b — self.x alone is usually a cheap flag read

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for func, is_async, _cls in iter_functions(ctx.tree):
            if not is_async:
                continue
            nodes = list(scope_walk(func.body))
            call_funcs = {
                id(n.func) for n in nodes if isinstance(n, ast.Call)
            }
            attr_parents = {
                id(n.value) for n in nodes
                if isinstance(n, ast.Attribute)
                and isinstance(n.value, ast.Attribute)
            }
            awaits = sorted(
                (n.lineno, n.col_offset) for n in nodes
                if isinstance(n, ast.Await)
            )
            if not awaits:
                continue
            reads: Dict[str, List[Tuple[int, int, ast.AST]]] = {}
            written: Set[str] = set()
            snapshotted_at: Dict[str, Tuple[int, int]] = {}
            for n in nodes:
                if isinstance(n, ast.Assign) and isinstance(
                    n.value, ast.Attribute
                ):
                    chain = dotted(n.value)
                    if chain and all(
                        isinstance(t, ast.Name) for t in n.targets
                    ):
                        pos = (n.lineno, n.col_offset)
                        if chain not in snapshotted_at \
                                or pos < snapshotted_at[chain]:
                            snapshotted_at[chain] = pos
                if not isinstance(n, ast.Attribute):
                    continue
                if id(n) in attr_parents:  # not the maximal chain
                    continue
                chain = dotted(n)
                if chain is None or not chain.startswith("self."):
                    continue
                if chain.count(".") < self._MIN_HOPS:
                    continue
                if isinstance(n.ctx, (ast.Store, ast.Del)):
                    written.add(chain)
                    continue
                if id(n) in call_funcs:  # method fetch, not a state read
                    continue
                reads.setdefault(chain, []).append(
                    (n.lineno, n.col_offset, n)
                )
            for chain, occurrences in reads.items():
                if chain in written:
                    continue  # the function owns this state; re-reads
                    # are its business
                occurrences.sort(key=lambda t: (t[0], t[1]))
                first = (occurrences[0][0], occurrences[0][1])
                last = (occurrences[-1][0], occurrences[-1][1])
                split = next(
                    (a for a in awaits if first < a < last), None
                )
                if split is None:
                    continue
                snap = snapshotted_at.get(chain)
                if snap is not None and snap <= split:
                    continue  # a local snapshot exists before the await
                after = next(
                    n for line, col, n in occurrences if (line, col) > split
                )
                yield ctx.finding(
                    self.name, after,
                    f"`{chain}` is read before AND after an await with "
                    "no local snapshot — shared state can change during "
                    "the suspension (a mid-flight retarget re-weighed "
                    "a share by 16x). Snapshot it into a local "
                    "before the await, or suppress with the reason a "
                    "fresh read is intended",
                )


# ------------------------------------------------- 7 metric-vocabulary
@register
class MetricVocabularyRule(Rule):
    name = "metric-vocabulary"
    summary = ("Counter/Gauge/Histogram constructed outside telemetry/ "
               "with a name not in the declared vocabulary "
               "(telemetry/vocabulary.py)")
    origin = "probe vs /metrics vs ARCHITECTURE.md name drift"

    _CTORS = {"counter", "gauge", "histogram"}

    def _vocabulary(self) -> Optional[frozenset]:
        try:
            from ..telemetry.vocabulary import all_metric_names
        except Exception:  # pragma: no cover — vocabulary itself broken
            return None
        return all_metric_names()

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        # Resolved location, not as-spelled: `lint pipeline.py` from
        # inside telemetry/ must still recognize the exemption. The
        # PACKAGE-anchored component pair — not a bare "telemetry/"
        # substring — so a checkout that merely lives under some
        # directory named telemetry/ (or the reference's own
        # telemetry/) cannot silently disable the rule for a file.
        if "/bitcoin_miner_tpu_torch/telemetry/" in _abspath(ctx):
            return  # the vocabulary's own home declares, not consumes
        vocab = self._vocabulary()
        if vocab is None:
            return
        imports = import_map(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in self._CTORS
                    and node.args):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                if not arg.value.startswith("tpu_miner_"):
                    continue  # not one of ours (a re-exporter, a test
                    # double) — out of this vocabulary's scope
                if arg.value not in vocab:
                    yield ctx.finding(
                        self.name, arg,
                        f"metric name {arg.value!r} is not in the "
                        "declared vocabulary — add it to "
                        "telemetry/vocabulary.py (and ARCHITECTURE.md's "
                        "observability table) or use an existing "
                        "METRIC_* constant",
                    )
                continue
            name = canonical(dotted(arg), imports)
            if name is None:
                yield ctx.finding(
                    self.name, arg,
                    "dynamically-built metric name outside telemetry/ — "
                    "/metrics, the docs and the health rules can't know "
                    "this series; use a METRIC_* constant from the "
                    "telemetry vocabulary",
                )
            elif "telemetry" not in name:
                yield ctx.finding(
                    self.name, arg,
                    f"metric name `{name}` does not come from the "
                    "telemetry vocabulary — import the METRIC_* "
                    "constant instead of re-declaring the string",
                )


# ------------------------------------- 8 unbounded-per-connection-task
_SERVER_FACTORIES = {"asyncio.start_server", "asyncio.start_unix_server"}
_TRACKING_SINKS = {"add", "append", "add_done_callback", "discard"}


def _is_create_task(node: ast.Call, imports: Dict[str, str]) -> bool:
    name = canonical(dotted(node.func), imports)
    if name in ("asyncio.create_task", "asyncio.ensure_future"):
        return True
    return (isinstance(node.func, ast.Attribute)
            and node.func.attr in ("create_task", "ensure_future"))


@register
class UnboundedPerConnectionTaskRule(Rule):
    name = "unbounded-per-connection-task"
    summary = ("asyncio connection handler spawns a task it never "
               "tracks or cancels — every client disconnect leaks the "
               "task (and its work keeps running against a dead "
               "session)")
    origin = ("poolserver per-session accept-hook tasks — "
              "pool-side serving multiplies any per-connection leak by "
              "the fleet size")

    def _handler_bodies(
        self, ctx: FileContext, imports: Dict[str, str]
    ) -> List[ast.AST]:
        """Function nodes passed as the connection handler to
        asyncio.start_server / start_unix_server (bare names and
        ``self.X`` resolved within the file)."""
        module_funcs = {
            n.name: n for n in ctx.tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        methods_by_class: Dict[ast.ClassDef, Dict[str, ast.AST]] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                methods_by_class[node] = {
                    n.name: n for n in node.body
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                }
        handlers: List[ast.AST] = []
        scopes = [(ctx.tree.body, None)] + [
            (func.body, cls)
            for func, _is_async, cls in iter_functions(ctx.tree)
        ]
        for scope_body, cls in scopes:
            methods = methods_by_class.get(cls, {})
            for node in scope_walk(scope_body):
                if not (isinstance(node, ast.Call) and node.args):
                    continue
                name = canonical(dotted(node.func), imports)
                is_factory = (
                    name in _SERVER_FACTORIES
                    or (isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("start_server",
                                               "start_unix_server"))
                )
                if not is_factory:
                    continue
                handler = node.args[0]
                target = None
                if isinstance(handler, ast.Name):
                    target = module_funcs.get(handler.id)
                elif (isinstance(handler, ast.Attribute)
                      and isinstance(handler.value, ast.Name)
                      and handler.value.id == "self"):
                    target = methods.get(handler.attr)
                if target is not None:
                    handlers.append(target)
        return handlers

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        imports = import_map(ctx.tree)
        for handler in self._handler_bodies(ctx, imports):
            nodes = list(scope_walk(handler.body))
            # Names/attribute chains that reach a tracking sink
            # (`tasks.add(t)`, `t.add_done_callback(...)`), a
            # `.cancel()` anywhere in the handler (teardown loops —
            # `for t in tasks: t.cancel()` — credit `t`; so does
            # `self._task.cancel()`), or a direct `await t` (an
            # awaited task is bounded by the handler's own lifetime).
            tracked_names: Set[str] = set()
            for n in nodes:
                if isinstance(n, ast.Await):
                    chain = dotted(n.value)
                    if chain is not None:
                        tracked_names.add(chain)
                if not isinstance(n, ast.Call):
                    continue
                if isinstance(n.func, ast.Attribute):
                    if n.func.attr in _TRACKING_SINKS:
                        for arg in n.args:
                            chain = dotted(arg)
                            if chain is not None:
                                tracked_names.add(chain)
                        recv = dotted(n.func.value)
                        if (n.func.attr == "add_done_callback"
                                and recv is not None):
                            tracked_names.add(recv)
                    elif n.func.attr == "cancel":
                        recv = dotted(n.func.value)
                        if recv is not None:
                            tracked_names.add(recv)
            # Direct forms needing no name: tasks.add(create_task(...))
            # and `await create_task(...)`.
            sunk_calls = {
                id(arg)
                for n in nodes
                if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr in _TRACKING_SINKS
                for arg in n.args
            }
            awaited = _awaited_values(handler.body)
            assigned_to: Dict[int, List[str]] = {}
            for n in nodes:
                if isinstance(n, ast.Assign):
                    chains = [dotted(t) for t in n.targets]
                    assigned_to[id(n.value)] = [
                        c for c in chains if c is not None
                    ]
            for n in nodes:
                if not (isinstance(n, ast.Call)
                        and _is_create_task(n, imports)):
                    continue
                if id(n) in sunk_calls or id(n) in awaited:
                    continue
                names = assigned_to.get(id(n), [])
                if names and any(nm in tracked_names for nm in names):
                    continue
                yield ctx.finding(
                    self.name, n,
                    "connection handler spawns a task that is never "
                    "tracked or cancelled: when this client "
                    "disconnects, the task keeps running against a "
                    "dead session — and a serving fleet multiplies the "
                    "leak per connection. Keep it in a per-session set "
                    "(add + add_done_callback(discard)) and cancel the "
                    "set on disconnect",
                )


# ---------------------------------------------- 9 unjittered-retry-loop
#: calls that make a while-loop a CONNECT/FETCH retry loop when they
#: appear in it (resolved last segment). Deliberately NOT bare `open`:
#: a while-loop retrying a local file open is overwhelmingly not the
#: fleet-lockstep network class this rule pins.
_CONNECTISH = {"open_connection", "create_connection",
               "open_unix_connection", "urlopen", "connect"}


def _is_connectish(name: Optional[str]) -> bool:
    if name is None:
        return False
    seg = name.rsplit(".", 1)[-1]
    return (seg in _CONNECTISH
            or seg.startswith("fetch")
            or seg.startswith("connect")
            or seg.startswith("reconnect"))


def _loop_assigned_chains(loop_body) -> Set[str]:
    """Dotted chains stored anywhere in the loop body — a sleep arg
    assigned in the loop is a growing/backoff term, not a constant."""
    out: Set[str] = set()
    for n in scope_walk(loop_body):
        targets: List[ast.AST] = []
        if isinstance(n, ast.Assign):
            targets = list(n.targets)
        elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
            targets = [n.target]
        elif isinstance(n, ast.For):
            targets = [n.target]
        for t in targets:
            chain = dotted(t)
            if chain is not None:
                out.add(chain)
    return out


@register
class UnjitteredRetryLoopRule(Rule):
    name = "unjittered-retry-loop"
    summary = ("connect/fetch retry loop whose failure handler sleeps a "
               "CONSTANT interval — no jitter, no backoff: a fleet "
               "retries a shared outage in lockstep and hammers a dead "
               "endpoint forever")
    origin = ("the getwork/GBT poll loops retried a dead node "
              "at fixed cadence; utils/backoff.py is the fix")

    _SLEEPS = {"time.sleep", "asyncio.sleep"}

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        imports = import_map(ctx.tree)
        for func, _is_async, _cls in iter_functions(ctx.tree):
            for loop in scope_walk(func.body):
                if not isinstance(loop, ast.While):
                    continue
                has_connect = any(
                    isinstance(n, ast.Call)
                    and _is_connectish(canonical(dotted(n.func), imports))
                    for n in scope_walk(loop.body)
                )
                if not has_connect:
                    continue
                assigned = _loop_assigned_chains(loop.body)
                for node in scope_walk(loop.body):
                    if not isinstance(node, ast.Try):
                        continue
                    for handler in node.handlers:
                        for call in scope_walk(handler.body):
                            if not (isinstance(call, ast.Call)
                                    and canonical(dotted(call.func),
                                                  imports) in self._SLEEPS
                                    and call.args):
                                continue
                            arg = call.args[0]
                            if isinstance(arg, ast.Constant):
                                fixed = True
                            else:
                                chain = dotted(arg)
                                # A Name/Attribute never stored in the
                                # loop is constant FOR the loop; any
                                # computed form (BinOp, min(), a
                                # backoff.next() call) is a backoff
                                # term and passes.
                                fixed = (chain is not None
                                         and chain not in assigned)
                            if fixed:
                                yield ctx.finding(
                                    self.name, call,
                                    "retry sleep with a loop-constant "
                                    "interval in a connect/fetch retry "
                                    "loop: every process retries a "
                                    "shared outage in lockstep and a "
                                    "dead endpoint is hammered at full "
                                    "cadence forever. Use jittered "
                                    "exponential backoff "
                                    "(utils/backoff.py "
                                    "DecorrelatedJitterBackoff: sleep("
                                    "backoff.next()), reset() on "
                                    "success)",
                                )


# ------------------------------------------------ 10 thread-discipline
@register
class ThreadDisciplineRule(Rule):
    name = "thread-discipline"
    summary = ("threading.Thread() without both `name=` and `daemon=` — "
               "flight-recorder lanes and shutdown semantics depend on "
               "them")
    origin = "flightrec thread lanes, watchdog teardown"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        imports = import_map(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = canonical(dotted(node.func), imports)
            if name != "threading.Thread":
                continue
            kwargs = {kw.arg for kw in node.keywords}
            if None in kwargs:
                continue  # **splat: can't see inside; no claim
            missing = [k for k in ("name", "daemon") if k not in kwargs]
            if missing:
                yield ctx.finding(
                    self.name, node,
                    f"threading.Thread without {' and '.join(missing)}: "
                    "unnamed threads make flight-recorder/trace lanes "
                    "unreadable (`Thread-3` means nothing in a "
                    "post-mortem), and an implicit non-daemon thread "
                    "blocks interpreter shutdown",
                )


# ------------------------------------------------ 11 first-error-wins
@register
class FirstErrorWinsRule(Rule):
    name = "first-error-wins"
    summary = ("parallel collect loop appends N errors but re-raises "
               "only one of them (`raise errors[0]`) — N-1 concurrent "
               "failures vanish from the report")
    origin = ("fanout.py's per-chip scan raised errors[0] of "
              "its sibling collect — three dead chips (one power event) "
              "debugged as a single-device problem")

    @staticmethod
    def _error_lists(func: ast.AST) -> Set[str]:
        """Names appended to inside an except handler ANYWHERE under
        ``func`` (the collect shape lives in a nested thread-target def,
        so this deliberately crosses scopes — the nested-def-only view
        sees appends with no raise, the outer view the whole pattern)."""
        out: Set[str] = set()
        for n in ast.walk(func):
            if not isinstance(n, ast.ExceptHandler):
                continue
            for call in ast.walk(n):
                if (isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Attribute)
                        and call.func.attr == "append"
                        and isinstance(call.func.value, ast.Name)):
                    out.add(call.func.value.id)
        return out

    @staticmethod
    def _references_whole_list(raise_node: ast.Raise, name: str) -> bool:
        """True when the raise uses the list as a WHOLE (an aggregate:
        ``raise MultiChildError(errors)``, a join over it, …) rather
        than only a constant-index pick."""
        picked: Set[int] = set()
        for sub in ast.walk(raise_node):
            if (isinstance(sub, ast.Subscript)
                    and isinstance(sub.value, ast.Name)
                    and sub.value.id == name
                    and isinstance(sub.slice, ast.Constant)):
                picked.add(id(sub.value))
        return any(
            isinstance(sub, ast.Name) and sub.id == name
            and id(sub) not in picked
            for sub in ast.walk(raise_node)
        )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for func, _is_async, _cls in iter_functions(ctx.tree):
            lists = self._error_lists(func)
            if not lists:
                continue
            raises = [n for n in ast.walk(func) if isinstance(n, ast.Raise)]
            aggregated = {
                name for name in lists
                if any(self._references_whole_list(r, name) for r in raises)
            }
            for r in raises:
                exc = r.exc
                if not (isinstance(exc, ast.Subscript)
                        and isinstance(exc.value, ast.Name)
                        and exc.value.id in lists
                        and isinstance(exc.slice, ast.Constant)):
                    continue
                if exc.value.id in aggregated:
                    # A sibling raise reports the WHOLE list — the
                    # constant-index pick is the deliberate single-error
                    # passthrough of an aggregating error path.
                    continue
                yield ctx.finding(
                    self.name, r,
                    f"`raise {exc.value.id}[…]` re-raises ONE of the "
                    "errors a parallel collect gathered — every sibling "
                    "failure is silently dropped, so N concurrent chip/"
                    "worker deaths read as a single-device bug. "
                    "Aggregate them (raise an exception carrying the "
                    "full labeled list, e.g. parallel/fanout.py's "
                    "MultiChildError) or report each before raising",
                )


# ------------------------------------------- 12 unbounded-metric-labels
#: identifier tokens that name per-request/per-peer runtime values — a
#: metric child keyed by one of these grows without bound (every job,
#: session, nonce or peer mints a fresh series on /metrics, and the
#: registry never forgets a child). Matching is on the LAST dotted
#: segment, lowercased; names merely ending in ``_id`` are flagged too.
_UNBOUNDED_LABEL_TOKENS = frozenset({
    "job_id", "jobid", "conn_id", "session_id", "client_id",
    "request_id", "trace_id", "row_id", "peer", "peername", "addr",
    "address", "nonce", "extranonce", "extranonce1", "extranonce2",
    "share_key", "uuid", "username", "user",
})

#: ``*_id`` names that ARE bounded (hardware enumeration, not request
#: traffic) — the rule's explicit allowlist.
_BOUNDED_ID_ALLOWLIST = frozenset({
    "chip_id", "device_id", "worker_id", "slot_id", "host_id",
})


@register
class UnboundedMetricLabelsRule(Rule):
    name = "unbounded-metric-labels"
    summary = ("metric .labels() keyed by an unbounded runtime value "
               "(job id, session id, nonce, peer address) — every "
               "occurrence mints a fresh /metrics series forever")
    origin = ("the lifecycle ledger deliberately keeps "
              "per-share identity OUT of the registry — label "
              "cardinality is the classic way a long-lived miner's "
              "scrape surface grows without bound")

    @classmethod
    def _suspicious(cls, expr: ast.AST) -> Optional[str]:
        """The unbounded token an expression carries, or None. Looks
        through str()/hex()/format() wrappers and f-string pieces."""
        name = dotted(expr)
        if name is not None:
            last = name.rsplit(".", 1)[-1].lower()
            if last in _BOUNDED_ID_ALLOWLIST:
                return None
            if last in _UNBOUNDED_LABEL_TOKENS or last.endswith("_id"):
                return last
            return None
        if isinstance(expr, ast.JoinedStr):
            for piece in expr.values:
                if isinstance(piece, ast.FormattedValue):
                    hit = cls._suspicious(piece.value)
                    if hit is not None:
                        return hit
            return None
        if isinstance(expr, ast.Call):
            func = dotted(expr.func)
            if func in ("str", "hex", "repr", "format"):
                for arg in expr.args:
                    hit = cls._suspicious(arg)
                    if hit is not None:
                        return hit
            if (isinstance(expr.func, ast.Attribute)
                    and expr.func.attr in ("format", "hex")):
                hit = cls._suspicious(expr.func.value)
                if hit is not None:
                    return hit
                for arg in expr.args:
                    hit = cls._suspicious(arg)
                    if hit is not None:
                        return hit
            return None
        if isinstance(expr, ast.BinOp):
            # "prefix" + job_id / "j%s" % job_id shapes.
            for side in (expr.left, expr.right):
                hit = cls._suspicious(side)
                if hit is not None:
                    return hit
        return None

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "labels"):
                continue
            values = list(node.args) + [kw.value for kw in node.keywords]
            for value in values:
                token = self._suspicious(value)
                if token is None:
                    continue
                yield ctx.finding(
                    self.name, value,
                    f"metric label keyed by `{token}` — an unbounded "
                    "runtime value mints a fresh series per occurrence "
                    "and the registry never forgets a child. Use a "
                    "bounded label (state, result, a stable pool/chip "
                    "label), or put the identity in the share-lifecycle "
                    "ledger / flight recorder instead; a genuinely "
                    "bounded value belongs in the rule's allowlist or "
                    "under a justified suppression",
                )


# --------------------------------------------------- 13 lock-order-cycle
@register
class LockOrderCycleRule(Rule):
    name = "lock-order-cycle"
    summary = ("two+ locks acquired in conflicting order on different "
               "call paths (cross-module, via the call graph) — a "
               "static deadlock waiting for the right interleaving")
    origin = ("meshring launch-lock vs per-device queue — two "
              "pump threads interleaving serialized enqueues deadlocked "
              "the collective rendezvous")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        program = ctx.program
        if not isinstance(program, Program):
            return
        for cycle in program.lock_cycles():
            # One finding per cycle, anchored at its first edge's
            # acquisition site — per-file anchoring makes repo-wide
            # dedup automatic (every other file sees the cycle too,
            # but only the anchor file reports it).
            if cycle.anchor[0] != ctx.path:
                continue
            locks = ", ".join(f"`{lk}`" for lk in cycle.locks)
            edges = "; ".join(
                f"`{a}` held while acquiring `{b}` at {p}:{ln} "
                f"(in {fn})"
                for a, b, p, ln, fn in cycle.edges[:4]
            )
            more = len(cycle.edges) - 4
            if more > 0:
                edges += f"; +{more} more edge(s)"
            yield Finding(
                rule=self.name, path=ctx.path, line=cycle.anchor[1],
                col=1,
                message=f"lock-order cycle between {locks}: {edges}. "
                        "Two threads interleaving these paths block on "
                        "each other's lock forever (the mesh ring's "
                        "launch-lock hang). Impose one global "
                        "acquisition order, or collapse to a single "
                        "lock",
            )


# ------------------------------------------------- 14 sync-hot-path-await
@register
class SyncHotPathAwaitRule(Rule):
    name = "sync-hot-path-await"
    summary = ("function marked `# miner-lint: sync-hot-path` is — or "
               "transitively calls — an `async def`: the no-suspension-"
               "point invariant breaks helper-deep")
    origin = ("poolserver _dispatch/broadcast rebuilt "
              "synchronous ('no suspension point = no swallow'); the "
              "marker pins the invariant against future refactors")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        program = ctx.program
        if not isinstance(program, Program):
            return
        for path, line in program.dangling_hot_marks:
            if path == ctx.path:
                yield Finding(
                    rule=self.name, path=ctx.path, line=line, col=1,
                    message="`# miner-lint: sync-hot-path` attaches to "
                            "no function — put it on the `def` line or "
                            "the line directly above it",
                )
        for qual in sorted(program.hot_paths):
            fi = program.functions.get(qual)
            if fi is None or fi.path != ctx.path:
                continue
            if fi.is_async:
                yield Finding(
                    rule=self.name, path=ctx.path,
                    line=fi.node.lineno, col=1,
                    message=f"`{qual}` is marked sync-hot-path but is "
                            "an `async def` — the marker asserts NO "
                            "suspension point on this path (the pool "
                            "frontend's "
                            "'no suspension point = no swallow' "
                            "invariant). Make it sync or drop the "
                            "marker with a review",
                )
                continue
            for target, chain in sorted(program.reachable(qual).items()):
                tfi = program.functions.get(target)
                if tfi is None or not tfi.is_async:
                    continue
                via = format_chain(
                    [(q, ln) for q, ln in chain] + [(target, None)])
                yield Finding(
                    rule=self.name, path=ctx.path,
                    line=fi.node.lineno, col=1,
                    message=f"sync-hot-path `{qual}` transitively "
                            f"calls `async def {target}` ({via}) — a "
                            "sync call builds an un-awaited coroutine "
                            "(silent no-op), and awaiting it would put "
                            "a suspension point on the hot path where "
                            "an exception can be swallowed mid-"
                            "broadcast (the frontend dispatch class). "
                            "Keep the "
                            "whole path synchronous; hand async work "
                            "to the writer task via its queue",
                )
                break  # one finding per marked function


# -------------------------------------------------- 15 spawn-unpicklable
@register
class SpawnUnpicklableRule(Rule):
    name = "spawn-unpicklable"
    summary = ("lambda / closure / bound-instance callable passed as a "
               "spawn-context Process target (or lambda/closure in "
               "args) — the child dies unpickling at start")
    origin = ("poolserver shard children — spawn requires "
              "module-level targets and picklable config "
              "(poolserver/shard.py's _shard_main discipline)")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        program = ctx.program
        if not isinstance(program, Program):
            return
        mod = program.module_for_path(ctx.path)
        spawn_ctxs = mod.spawn_ctxs if mod is not None else set()

        scopes: List[Tuple[List[ast.AST], Optional[ast.AST]]] = \
            [(list(ctx.tree.body), None)] + [
                (func.body, func)
                for func, _is_async, _cls in iter_functions(ctx.tree)
            ]
        for body, func in scopes:
            closure_defs: Set[str] = set()
            local_names: Set[str] = set()
            if func is not None:
                closure_defs = {
                    n.name for n in ast.walk(func)
                    if isinstance(n, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))
                    and n is not func
                }
                for n in scope_walk(func.body):
                    targets: List[ast.AST] = []
                    if isinstance(n, ast.Assign):
                        targets = list(n.targets)
                    elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                        targets = [n.target]
                    elif isinstance(n, ast.For):
                        targets = [n.target]
                    for t in targets:
                        if isinstance(t, ast.Name):
                            local_names.add(t.id)
            for node in scope_walk(body):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "Process"):
                    continue
                recv = dotted(node.func.value)
                is_spawn = recv in spawn_ctxs or (
                    isinstance(node.func.value, ast.Call)
                    and (dotted(node.func.value.func) or "").endswith(
                        "get_context")
                )
                if not is_spawn:
                    continue
                kwargs = {kw.arg: kw.value for kw in node.keywords
                          if kw.arg}
                target = kwargs.get("target")
                if target is not None:
                    hit = self._bad_target(target, closure_defs,
                                           local_names)
                    if hit is not None:
                        yield ctx.finding(
                            self.name, target,
                            f"spawn-context Process target is {hit} — "
                            "the child re-imports the module and "
                            "unpickles the target; anything not "
                            "importable at module level dies in the "
                            "child's bootstrap (the shard-child "
                            "class). Use a module-level function and "
                            "pass state through picklable args "
                            "(poolserver/shard.py's _shard_main shape)",
                        )
                args_kw = kwargs.get("args")
                if isinstance(args_kw, (ast.Tuple, ast.List)):
                    for elt in args_kw.elts:
                        hit = self._bad_arg(elt, closure_defs)
                        if hit is not None:
                            yield ctx.finding(
                                self.name, elt,
                                f"spawn-context Process arg is {hit} — "
                                "args cross the process boundary by "
                                "pickle; closures and lambdas don't. "
                                "Pass picklable data (config "
                                "dataclasses, fds via the ctx) and "
                                "rebuild behavior in the child",
                            )

    @staticmethod
    def _bad_target(expr: ast.AST, closure_defs: Set[str],
                    local_names: Set[str]) -> Optional[str]:
        if isinstance(expr, ast.Lambda):
            return "a lambda"
        if isinstance(expr, ast.Name) and expr.id in closure_defs:
            return f"the closure `{expr.id}` (defined inside the " \
                   "enclosing function)"
        chain = dotted(expr)
        if chain is not None and "." in chain:
            head = chain.split(".", 1)[0]
            if head == "self":
                return f"the bound method `{chain}` — pickling it " \
                       "drags the whole instance (sockets, locks, " \
                       "device handles) into the child"
            if head in local_names:
                return f"a bound method of local `{head}`"
        return None

    @staticmethod
    def _bad_arg(expr: ast.AST,
                 closure_defs: Set[str]) -> Optional[str]:
        if isinstance(expr, ast.Lambda):
            return "a lambda"
        if isinstance(expr, ast.Name) and expr.id in closure_defs:
            return f"the closure `{expr.id}`"
        return None
