"""miner-lint engine: rule registry, suppression, output, exit-code
contract.

Counterpart of ``bitcoin_miner_tpu/analysis/engine.py``, with the same
registry, suppression syntax, JSON and baseline schemas and exit codes;
it lints this package and its root scripts, and its baseline lives in
the package (``analysis/lint_baseline.json``).

Every hard bug the reference shipped and then root-caused was a
concurrency or invariant violation no generic tool flags — the
swallowed-``CancelledError`` dispatcher hang, the SIGUSR2 recorder-lock
self-deadlock, the mid-flight retarget share-weighting race, a blocking
probe nearly run on the event loop. This engine turns those postmortems
into AST rules (analysis/rules.py) and runs them as a gate, so the next
instance of each class is caught by a machine instead of a person
replaying a three-hang flake.

Contract:

- **rules** register via :func:`register` (per-file AST rules) or
  :func:`register_project` (whole-repo rules, e.g. the doc-drift
  checker); ``tpu-miner lint --list-rules`` prints the table.
- **suppression** is per-line: ``# miner-lint: disable=<rule>[,<rule>]
  -- <justification>`` on the finding's line. A whole file opts out of
  one rule with ``# miner-lint: disable-file=<rule> -- <justification>``
  on any line. The justification is MANDATORY — a disable without one is
  itself reported (``unjustified-suppression``), because "why this is
  safe" is exactly what the next reader of a suppressed hazard needs.
- **output**: human ``path:line:col: rule: message`` lines, or
  ``--json`` (schema ``tpu-miner-lint/1``).
- **exit codes**: 0 clean, 1 findings, 2 usage/internal error — the CI
  contract (a hard-fail step needs "dirty" and "broken" distinguishable).
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import re
import sys
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, Iterator, List,
                    Optional, Set, Tuple)

SCHEMA = "tpu-miner-lint/1"
BASELINE_SCHEMA = "tpu-miner-lint-baseline/1"

#: roots linted when no paths are given (relative to the cwd — the lint
#: is a repo tool, run from a checkout): this package and the root
#: scripts that drive it on the card. tests/ is deliberately absent:
#: test code stubs, monkeypatches and fixture files (tests/fixtures/
#: reproduces bugs ON PURPOSE) would drown the signal.
DEFAULT_ROOTS = ("bitcoin_miner_tpu_torch", "chip_smoke.py", "sweep_pairs.py")

_SUPPRESS_RE = re.compile(
    r"#\s*miner-lint:\s*(disable|disable-file)\s*=\s*"
    r"(?P<rules>[a-z0-9_,\s-]+?)\s*(?:--\s*(?P<why>.*\S))?\s*$"
)


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: " \
               f"{self.message}"


@dataclass
class FileContext:
    """Everything a per-file rule gets to look at."""

    path: str          # as given / discovered (repo-relative in CI)
    source: str
    tree: ast.Module
    lines: List[str]
    #: the whole-program index. Repo-wide runs share ONE
    #: program across every file; a single-file lint gets a single-
    #: module program — so transitive rules always have a (possibly
    #: partial) call graph and never need a None check beyond this
    #: field's default.
    program: Any = None

    def finding(
        self, rule: str, node: ast.AST, message: str
    ) -> Finding:
        return Finding(
            rule=rule, path=self.path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0) + 1,
            message=message,
        )


class Rule:
    """One per-file AST rule. Subclasses set the class attributes and
    implement :meth:`check`; :func:`register` puts them in the table."""

    #: rule id, the token suppression comments use (kebab-case).
    name: str = ""
    #: one line: the bug class this rule pins.
    summary: str = ""
    #: where the class was paid for (postmortem provenance).
    origin: str = ""

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        raise NotImplementedError


RULES: Dict[str, Rule] = {}
#: project rules: name → callable(root) -> findings (run once per lint,
#: not once per file — e.g. the ARCHITECTURE.md doc-drift check).
PROJECT_RULES: Dict[str, Callable[[str], List[Finding]]] = {}
PROJECT_RULE_DOCS: Dict[str, tuple] = {}


def register(cls: type) -> type:
    rule = cls()
    if not rule.name:
        raise ValueError(f"{cls.__name__} has no rule name")
    if rule.name in RULES or rule.name in PROJECT_RULES:
        raise ValueError(f"duplicate rule {rule.name!r}")
    RULES[rule.name] = rule
    return cls


def register_project(
    name: str, summary: str, origin: str = ""
) -> Callable:
    def deco(fn: Callable[[str], List[Finding]]) -> Callable:
        if name in RULES or name in PROJECT_RULES:
            raise ValueError(f"duplicate rule {name!r}")
        PROJECT_RULES[name] = fn
        PROJECT_RULE_DOCS[name] = (summary, origin)
        return fn

    return deco


# ------------------------------------------------------------ suppression
@dataclass
class Suppressions:
    #: line number → set of rule names disabled on that line.
    by_line: Dict[int, Set[str]]
    #: rule names disabled for the whole file.
    whole_file: Set[str]
    #: findings for disables missing the mandatory justification.
    violations: List[Finding]


def _comment_tokens(source: str) -> List[tuple]:
    """(lineno, col, text) for every REAL comment token. Tokenizing —
    rather than regexing raw lines — is what stops a string literal
    that merely CONTAINS a suppression directive (an error message, a
    doc generator's template) from silently disabling rules on its
    line."""
    import io
    import tokenize

    out: List[tuple] = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.start[1], tok.string))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass  # unparseable tail: the comments seen so far still count
    return out


def parse_suppressions(path: str, source: str) -> Suppressions:
    by_line: Dict[int, Set[str]] = {}
    whole_file: Set[str] = set()
    violations: List[Finding] = []
    known = set(RULES) | set(PROJECT_RULES)
    for lineno, col, text in _comment_tokens(source):
        if "miner-lint" not in text:
            continue
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        names = {r.strip() for r in m.group("rules").split(",") if r.strip()}
        anchor = Finding(
            rule="unjustified-suppression", path=path, line=lineno,
            col=col + 1, message="",
        )
        if not m.group("why"):
            violations.append(dataclasses.replace(
                anchor,
                message="suppression without a justification — write "
                        "`# miner-lint: disable=<rule> -- <why this is "
                        "safe>`",
            ))
            continue
        unknown = names - known
        if unknown:
            violations.append(dataclasses.replace(
                anchor,
                message=f"suppression names unknown rule(s) "
                        f"{sorted(unknown)} (known: "
                        f"{sorted(known)})",
            ))
            names &= known
        if m.group(1) == "disable-file":
            whole_file |= names
        else:
            by_line.setdefault(lineno, set()).update(names)
    return Suppressions(by_line, whole_file, violations)


def _ensure_rules() -> None:
    """Idempotently import the rule modules (registration side effect)
    so library callers of :func:`lint_source`/:func:`run_lint` get the
    full table without knowing the module layout."""
    from . import docdrift, rules  # noqa: F401


# -------------------------------------------------------------- run one file
def lint_source(
    source: str, path: str = "<string>",
    select: Optional[Set[str]] = None,
    program: Any = None,
) -> List[Finding]:
    """Lint one source blob; the engine seam the tests drive directly.

    ``program`` is the whole-program index (callgraph.Program). When
    absent a single-module program is built from this source, so the
    transitive rules work identically on fixtures and single files —
    they just can't see across files they weren't given.
    """
    _ensure_rules()
    from .callgraph import Program

    if program is None:
        program = Program.from_sources({path: source})
    mod = program.module_for_path(path)
    if mod is not None and mod.source == source:
        # reuse the program's tree: rules map def nodes to FunctionInfo
        # by identity (program.function_for_node).
        tree = mod.tree
    else:
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            return [Finding(
                rule="parse-error", path=path, line=e.lineno or 1,
                col=(e.offset or 0) + 1, message=f"cannot parse: {e.msg}",
            )]
    lines = source.splitlines()
    ctx = FileContext(path=path, source=source, tree=tree, lines=lines,
                      program=program)
    sup = parse_suppressions(path, source)
    findings: List[Finding] = list(sup.violations)
    seen: Set[Finding] = set(findings)
    for name, rule in sorted(RULES.items()):
        if select is not None and name not in select:
            continue
        if name in sup.whole_file:
            continue
        for f in rule.check(ctx):
            if f.rule in sup.by_line.get(f.line, ()):
                continue
            if f in seen:
                # A rule visiting overlapping scopes (a try under two
                # nested `while True` loops) may re-emit the identical
                # finding; counts in --json/CI must not inflate.
                continue
            seen.add(f)
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def lint_file(path: str, select: Optional[Set[str]] = None,
              program: Any = None) -> List[Finding]:
    try:
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
    except (OSError, UnicodeDecodeError) as e:
        return [Finding(
            rule="parse-error", path=path, line=1, col=1,
            message=f"cannot read: {e}",
        )]
    return lint_source(source, path=path, select=select, program=program)


# ------------------------------------------------------------- discovery
def iter_python_files(paths: Iterable[str]) -> Iterator[str]:
    for path in paths:
        if os.path.isfile(path):
            yield path
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = sorted(
                d for d in dirnames
                if d != "__pycache__" and not d.startswith(".")
            )
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def run_lint(
    paths: Iterable[str], select: Optional[Set[str]] = None,
    project_root: Optional[str] = None,
    include_project_rules: bool = True,
) -> tuple:
    """(findings, files_scanned) over ``paths`` + the project rules
    (run against ``project_root``, default cwd; skipped under
    ``select`` unless named, or entirely with
    ``include_project_rules=False`` — a single-file lint must not mix
    in the cwd's repo-wide doc state)."""
    _ensure_rules()
    from .callgraph import Program

    findings: List[Finding] = []
    files = list(iter_python_files(paths))
    # ONE whole-program index shared by every file's rules: the
    # transitive rules (blocking-in-async through helpers, lock-order
    # cycles across modules) see the full call graph exactly once.
    program = Program.from_paths(files)
    n = 0
    for path in files:
        n += 1
        findings.extend(lint_file(path, select=select, program=program))
    if include_project_rules:
        root = project_root if project_root is not None else os.getcwd()
        for name, fn in sorted(PROJECT_RULES.items()):
            if select is not None and name not in select:
                continue
            findings.extend(fn(root))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, n


# ---------------------------------------------------------------- baseline
# The findings ratchet: transitive rules can land even when
# depth surfaces real pre-existing findings. Known findings live in
# analysis/lint_baseline.json keyed by (rule, path) COUNT — counts
# survive unrelated line drift, which is what made per-line baselines
# churn in every tool that tried them. The contract CI enforces:
#
# - a finding beyond the baselined count for its (rule, path) is NEW →
#   exit 1 (hard fail; fix it or suppress it with a justification);
# - a baselined count higher than reality is STALE → exit 1 (the file
#   must shrink to match: regenerate with --write-baseline, keeping the
#   ratchet monotone);
# - findings within the baseline are TRACKED: reported, not fatal.
#
# The file also carries a human changelog: one line per fixed finding,
# appended when an entry shrinks (see analysis/lint_baseline.json).


@dataclass
class BaselineResult:
    path: str
    tracked: int = 0
    new: List[Finding] = field(default_factory=list)
    #: (key, baselined count, current count) for entries > reality.
    stale: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def failed(self) -> bool:
        return bool(self.new or self.stale)


def baseline_key(f: Finding) -> str:
    # Normalized separators so a baseline written on one OS matches a
    # run on another.
    return f"{f.rule}::{f.path.replace(os.sep, '/')}"


def load_baseline(path: str) -> Dict[str, int]:
    """entries map from a baseline file; raises ValueError on a bad
    schema (main() maps that to exit 2 — a broken baseline must not
    read as 'clean')."""
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    if data.get("schema") != BASELINE_SCHEMA:
        raise ValueError(
            f"baseline schema {data.get('schema')!r} != {BASELINE_SCHEMA!r}")
    entries = data.get("entries", {})
    if not isinstance(entries, dict) or not all(
        isinstance(k, str) and isinstance(v, int) and v > 0
        for k, v in entries.items()
    ):
        raise ValueError("baseline entries must map 'rule::path' to a "
                         "positive count")
    return dict(entries)


def apply_baseline(
    findings: List[Finding], entries: Dict[str, int], path: str,
) -> BaselineResult:
    result = BaselineResult(path=path)
    counts = Counter(baseline_key(f) for f in findings)
    for key, cur in sorted(counts.items()):
        base = entries.get(key, 0)
        if cur > base:
            # Counts can't attribute WHICH site is the new one, so every
            # finding under an over-budget key is surfaced — the human
            # output says how many are beyond budget.
            result.new.extend(
                f for f in findings if baseline_key(f) == key)
        else:
            result.tracked += cur
            if cur < base:
                result.stale.append((key, base, cur))
    for key, base in sorted(entries.items()):
        if key not in counts:
            result.stale.append((key, base, 0))
    result.stale.sort()
    return result


def write_baseline(path: str, findings: List[Finding]) -> None:
    """Serialize current findings as the new baseline, preserving an
    existing file's changelog (the fixed-findings history is the
    point of the ratchet, not a cache to overwrite)."""
    changelog: List[str] = []
    try:
        with open(path, "r", encoding="utf-8") as fh:
            old = json.load(fh)
        if isinstance(old.get("changelog"), list):
            changelog = old["changelog"]
    except (OSError, ValueError):
        pass
    entries = Counter(baseline_key(f) for f in findings)
    data = {
        "schema": BASELINE_SCHEMA,
        "entries": {k: entries[k] for k in sorted(entries)},
        "changelog": changelog,
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=2, sort_keys=False)
        fh.write("\n")


# -------------------------------------------------------------------- CLI
def _rule_table() -> str:
    rows = [
        (name, rule.summary, rule.origin)
        for name, rule in sorted(RULES.items())
    ] + [
        (name, summary, origin)
        for name, (summary, origin) in sorted(PROJECT_RULE_DOCS.items())
    ]
    width = max(len(r[0]) for r in rows)
    out = []
    for name, summary, origin in rows:
        suffix = f"  [{origin}]" if origin else ""
        out.append(f"  {name:<{width}}  {summary}{suffix}")
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tpu-miner lint",
        description="Project-specific concurrency & invariant analyzer: "
                    "AST rules distilled from this repo's own shipped "
                    "bugs (see ARCHITECTURE.md 'Static analysis').",
    )
    parser.add_argument(
        "paths", nargs="*",
        help=f"files/directories to lint (default: "
             f"{' '.join(DEFAULT_ROOTS)}, those that exist)",
    )
    parser.add_argument("--json", action="store_true",
                        help="machine-readable output "
                             "(schema tpu-miner-lint/1)")
    parser.add_argument("--select", default=None,
                        help="comma-separated rule names to run "
                             "(default: all)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule table and exit")
    parser.add_argument("--baseline", default=None, metavar="PATH",
                        help="findings ratchet: exit 1 only on findings "
                             "BEYOND this baseline (or on stale entries "
                             "the baseline must shrink to match)")
    parser.add_argument("--write-baseline", default=None, metavar="PATH",
                        help="serialize current findings as the new "
                             "baseline (preserves the file's changelog) "
                             "and exit 0")
    args = parser.parse_args(argv)

    _ensure_rules()

    if args.list_rules:
        print(_rule_table())
        return 0

    select: Optional[Set[str]] = None
    if args.select:
        select = {s.strip() for s in args.select.split(",") if s.strip()}
        unknown = select - set(RULES) - set(PROJECT_RULES)
        if unknown:
            print(f"unknown rule(s): {sorted(unknown)}", file=sys.stderr)
            return 2
    paths = args.paths or [p for p in DEFAULT_ROOTS if os.path.exists(p)]
    if not paths:
        print("nothing to lint: no paths given and none of "
              f"{DEFAULT_ROOTS} exist under {os.getcwd()}", file=sys.stderr)
        return 2
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"no such path(s): {missing}", file=sys.stderr)
        return 2

    # Project rules (doc drift) describe THE REPO, not a file: they run
    # on default-root invocations (the CI/checklist shape), not when
    # someone points the lint at specific files — unless a project rule
    # was asked for by name.
    include_project = not args.paths or (
        select is not None and bool(select & set(PROJECT_RULES))
    )
    entries: Optional[Dict[str, int]] = None
    if args.baseline is not None:
        try:
            entries = load_baseline(args.baseline)
        except (OSError, ValueError) as e:
            print(f"miner-lint: cannot load baseline {args.baseline}: "
                  f"{e}", file=sys.stderr)
            return 2
    started = time.monotonic()
    try:
        findings, n_files = run_lint(
            paths, select=select, include_project_rules=include_project,
        )
    except Exception as e:  # noqa: BLE001 — the exit-code contract:
        # a BROKEN linter must exit 2, never masquerade as "findings"
        # (the CI hard-fail step needs dirty and broken distinguishable).
        print(f"miner-lint internal error: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2
    duration = time.monotonic() - started

    if args.write_baseline is not None:
        try:
            write_baseline(args.write_baseline, findings)
        except OSError as e:
            print(f"miner-lint: cannot write baseline "
                  f"{args.write_baseline}: {e}", file=sys.stderr)
            return 2
        print(f"miner-lint: wrote baseline ({len(findings)} finding(s) "
              f"across {n_files} file(s)) to {args.write_baseline}")
        return 0

    baseline_result: Optional[BaselineResult] = None
    if entries is not None:
        baseline_result = apply_baseline(findings, entries, args.baseline)

    if args.json:
        payload: Dict[str, Any] = {
            "schema": SCHEMA,
            "files_scanned": n_files,
            "duration_s": round(duration, 3),
            "clean": not findings,
            "findings": [dataclasses.asdict(f) for f in findings],
        }
        if baseline_result is not None:
            payload["baseline"] = {
                "path": baseline_result.path,
                "tracked": baseline_result.tracked,
                "new": len(baseline_result.new),
                "stale": [
                    {"key": k, "baseline": b, "current": c}
                    for k, b, c in baseline_result.stale
                ],
            }
        print(json.dumps(payload, indent=2))
    else:
        shown = findings if baseline_result is None else \
            baseline_result.new
        for f in shown:
            print(f.render())
        if baseline_result is None:
            print(f"miner-lint: {len(findings)} finding(s) in {n_files} "
                  f"file(s) scanned")
        else:
            for key, base, cur in baseline_result.stale:
                print(f"stale baseline entry {key}: baselined {base}, "
                      f"found {cur} — shrink the baseline "
                      f"(--write-baseline) and log the fix")
            print(f"miner-lint: {len(findings)} finding(s) in {n_files} "
                  f"file(s) scanned; baseline: "
                  f"{baseline_result.tracked} tracked, "
                  f"{len(baseline_result.new)} new, "
                  f"{len(baseline_result.stale)} stale")
    if baseline_result is not None:
        return 1 if baseline_result.failed else 0
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
