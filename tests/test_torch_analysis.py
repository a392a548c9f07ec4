"""miner-lint of the PyTorch/CUDA package (``bitcoin_miner_tpu_torch/
analysis/``), held to its spec, the reference's ``tests/test_analysis.py``,
class by class: the registry, every rule over its fixture pair, the
regression fixtures, suppression, the engine's contract (JSON schema, exit
codes), the call graph, transitive findings, the baseline ratchet, the
port's tree linting clean, the vocabulary and doc drift.

Then the port against the reference on the same inputs: the same
``(rule, line, col)`` on every fixture of ``tests/fixtures/lint/`` (but
for ``device-claiming-import``, whose scope differs on purpose), the same
vocabulary tables and the same rule table. And the divergences (ROADMAP,
Queue 3): ``device-claiming-import`` holds the port's boundary (no jax,
no ``bitcoin_miner_tpu``; no torch in an import-safe module; fixtures in
``tests/fixtures/lint_torch/``), the anchors are the port's, the baseline
lives in the package, and ``lint`` runs in a process that loads neither
torch nor jax.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest

from bitcoin_miner_tpu.analysis import engine as ref_engine
from bitcoin_miner_tpu_torch.analysis import callgraph, engine, rules
from bitcoin_miner_tpu_torch.analysis.callgraph import (
    CTX_ASYNC,
    CTX_SIGNAL,
    CTX_SPAWN,
    CTX_THREAD,
    Program,
)
from bitcoin_miner_tpu_torch.analysis.docdrift import check_doc_drift
from bitcoin_miner_tpu_torch.analysis.engine import (
    PROJECT_RULES,
    RULES,
    _ensure_rules,
    lint_file,
    lint_source,
    run_lint,
    write_baseline,
)

_ensure_rules()
ref_engine._ensure_rules()

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO_ROOT, "tests", "fixtures", "lint")
PORT_FIXTURES = os.path.join(REPO_ROOT, "tests", "fixtures", "lint_torch")
PACKAGE = os.path.join(REPO_ROOT, "bitcoin_miner_tpu_torch")
#: the port's findings ratchet, relative to the checkout's root.
BASELINE = "bitcoin_miner_tpu_torch/analysis/lint_baseline.json"

ALL_RULES = (
    "swallowed-cancel",
    "blocking-in-async",
    "lock-across-await",
    "signal-handler-safety",
    "device-claiming-import",
    "await-state-snapshot",
    "metric-vocabulary",
    "thread-discipline",
    "unbounded-per-connection-task",
    "unjittered-retry-loop",
    "first-error-wins",
    "unbounded-metric-labels",
    "lock-order-cycle",
    "sync-hot-path-await",
    "spawn-unpicklable",
)

#: The reference's regression fixtures, by the postmortem their names end
#: in, and the rule distilled from it.
REGRESSIONS = {
    "swallowed_cancel": "swallowed-cancel",
    "signal_handler": "signal-handler-safety",
    "retarget": "await-state-snapshot",
    "launch_lock": "lock-order-cycle",
    "async_dispatch": "sync-hot-path-await",
    "spawn_closure": "spawn-unpicklable",
}


def rules_hit(path: str) -> set:
    return {f.rule for f in lint_file(path)}


def _regression_fixture(postmortem: str) -> str:
    (path,) = [p for p in glob.glob(os.path.join(FIXTURES, "regression_*.py"))
               if re.fullmatch(r"regression_pr\d+_" + postmortem + r"\.py",
                               os.path.basename(p))]
    return path


# ------------------------------------------------------------- registry
class TestRegistry:
    def test_all_shipped_rules_registered(self):
        for name in ALL_RULES:
            assert name in RULES, name

    def test_doc_drift_is_a_project_rule(self):
        assert "metric-doc-drift" in PROJECT_RULES

    def test_every_rule_documents_itself(self):
        for rule in RULES.values():
            assert rule.summary, rule.name
            assert rule.origin, rule.name

    def test_duplicate_registration_rejected(self):
        with pytest.raises(ValueError, match="duplicate"):
            engine.register(type(
                "Dup", (engine.Rule,),
                {"name": "swallowed-cancel", "check": lambda self, c: []},
            ))


# ------------------------------------------------------- fixture pairs
class TestFixturePairs:
    @pytest.mark.parametrize("rule", ALL_RULES)
    def test_true_positive_fires(self, rule):
        path = os.path.join(FIXTURES, rule.replace("-", "_") + "_tp.py")
        findings = [f for f in lint_file(path) if f.rule == rule]
        assert findings, f"{rule} missed its true-positive fixture"
        for f in findings:
            assert f.path == path
            assert f.line > 0 and f.col > 0
            assert f.message

    @pytest.mark.parametrize("rule", ALL_RULES)
    def test_true_negative_quiet(self, rule):
        path = os.path.join(FIXTURES, rule.replace("-", "_") + "_tn.py")
        findings = [f for f in lint_file(path) if f.rule == rule]
        assert not findings, (
            f"{rule} false-positived on its true-negative fixture: "
            f"{[f.render() for f in findings]}"
        )

    @pytest.mark.parametrize("rule", ALL_RULES)
    def test_true_negative_clean_of_everything(self, rule):
        path = os.path.join(FIXTURES, rule.replace("-", "_") + "_tn.py")
        assert rules_hit(path) == set()


# -------------------------------------------------- regression fixtures
class TestRegressionFixtures:
    """The reconstructed pre-fix bugs of the reference are detected by the
    rules distilled from their postmortems."""

    @pytest.mark.parametrize("postmortem", sorted(REGRESSIONS))
    def test_regression_detected(self, postmortem):
        path = _regression_fixture(postmortem)
        assert REGRESSIONS[postmortem] in rules_hit(path)

    def test_fixed_head_shapes_pass(self):
        # The port's counterparts of the code the fixtures were
        # reconstructed from pass alone, without suppressions.
        for rel in ("miner/dispatcher.py", "telemetry/flightrec.py",
                    "miner/runner.py", "parallel/meshring.py",
                    "poolserver/server.py", "poolserver/shard.py"):
            path = os.path.join(PACKAGE, rel)
            assert lint_file(path) == [], rel


# ---------------------------------------------------------- suppression
class TestSuppression:
    SRC = (
        "import threading\n"
        "t = threading.Thread(target=print)"
    )

    def test_finding_without_suppression(self):
        findings = lint_source(self.SRC)
        assert [f.rule for f in findings] == ["thread-discipline"]

    def test_line_suppression_with_justification(self):
        src = self.SRC + (
            "  # miner-lint: disable=thread-discipline -- "
            "fixture thread, never started"
        )
        assert lint_source(src) == []

    def test_suppression_without_justification_is_a_finding(self):
        src = self.SRC + "  # miner-lint: disable=thread-discipline"
        rules_seen = [f.rule for f in lint_source(src)]
        assert "unjustified-suppression" in rules_seen
        assert "thread-discipline" in rules_seen

    def test_unknown_rule_in_suppression_is_a_finding(self):
        src = self.SRC + "  # miner-lint: disable=no-such-rule -- why"
        rules_seen = [f.rule for f in lint_source(src)]
        assert "unjustified-suppression" in rules_seen
        assert "thread-discipline" in rules_seen

    def test_file_level_suppression(self):
        src = (
            "# miner-lint: disable-file=thread-discipline -- "
            "probe harness: threads are join()ed inline\n" + self.SRC
        )
        assert lint_source(src) == []

    def test_directive_inside_string_literal_does_not_suppress(self):
        src = (
            "import threading\n"
            "t = threading.Thread(target=print); "
            "s = '# miner-lint: disable=thread-discipline -- x'\n"
        )
        assert [f.rule for f in lint_source(src)] == ["thread-discipline"]

    def test_nested_while_true_finding_not_duplicated(self):
        src = (
            "async def f(q):\n"
            "    while True:\n"
            "        while True:\n"
            "            try:\n"
            "                await q.get()\n"
            "            except Exception:\n"
            "                pass\n"
        )
        assert [f.rule for f in lint_source(src)] == ["swallowed-cancel"]

    def test_other_rules_survive_targeted_suppression(self):
        src = (
            "import time\n"
            "import threading\n"
            "async def f():\n"
            "    time.sleep(1)\n"
            "    t = threading.Thread(target=print)"
            "  # miner-lint: disable=thread-discipline -- test double\n"
        )
        assert [f.rule for f in lint_source(src)] == ["blocking-in-async"]


# ------------------------------------------------------- engine contract
class TestEngineContract:
    def test_parse_error_is_a_finding(self):
        assert [f.rule for f in lint_source("def broken(:\n")] == [
            "parse-error"]

    def test_broken_rule_exits_2(self, tmp_path, capsys, monkeypatch):
        class Exploder(engine.Rule):
            name = "exploder"
            summary = origin = "test double"

            def check(self, ctx):
                raise RuntimeError("rule bug")

        monkeypatch.setitem(RULES, "exploder", Exploder())
        target = tmp_path / "x.py"
        target.write_text("x = 1\n")
        assert engine.main([str(target)]) == 2
        assert "internal error" in capsys.readouterr().err

    def test_handler_order_no_dead_reraise_credit(self):
        src = (
            "import asyncio\n"
            "async def f(q):\n"
            "    while True:\n"
            "        try:\n"
            "            await q.get()\n"
            "        except BaseException:\n"
            "            pass\n"
            "        except asyncio.CancelledError:\n"
            "            raise\n"
        )
        assert [f.rule for f in lint_source(src)] == ["swallowed-cancel"]
        ordered = src.replace(
            "        except BaseException:\n            pass\n"
            "        except asyncio.CancelledError:\n            raise\n",
            "        except asyncio.CancelledError:\n            raise\n"
            "        except BaseException:\n            pass\n",
        )
        assert lint_source(ordered) == []

    def test_exit_codes(self, tmp_path, capsys):
        clean = tmp_path / "clean.py"
        clean.write_text("x = 1\n")
        dirty = tmp_path / "dirty.py"
        dirty.write_text(
            "import threading\nt = threading.Thread(target=print)\n"
        )
        assert engine.main([str(clean)]) == 0
        assert engine.main([str(dirty)]) == 1
        assert engine.main([str(tmp_path / "missing.py")]) == 2
        assert engine.main(["--select", "no-such-rule", str(clean)]) == 2
        capsys.readouterr()

    def test_json_schema(self, tmp_path, capsys):
        dirty = tmp_path / "dirty.py"
        dirty.write_text(
            "import threading\nt = threading.Thread(target=print)\n"
        )
        rc = engine.main(["--json", str(dirty)])
        doc = json.loads(capsys.readouterr().out)
        assert rc == 1
        assert doc["schema"] == "tpu-miner-lint/1"
        assert doc["clean"] is False
        assert doc["files_scanned"] == 1
        (finding,) = doc["findings"]
        assert set(finding) == {"rule", "path", "line", "col", "message"}
        assert finding["rule"] == "thread-discipline"
        assert finding["line"] == 2

    def test_select_runs_only_named_rules(self, tmp_path, capsys):
        dirty = tmp_path / "dirty.py"
        dirty.write_text(
            "import time, threading\n"
            "async def f():\n"
            "    time.sleep(1)\n"
            "t = threading.Thread(target=print)\n"
        )
        rc = engine.main(
            ["--json", "--select", "blocking-in-async", str(dirty)]
        )
        doc = json.loads(capsys.readouterr().out)
        assert rc == 1
        assert [f["rule"] for f in doc["findings"]] == ["blocking-in-async"]

    def test_fixture_dir_discovery(self):
        findings, n = run_lint([FIXTURES], project_root=str(FIXTURES))
        assert n >= 25
        assert {f.rule for f in findings} >= set(ALL_RULES)

    def test_explicit_paths_skip_project_rules(self, tmp_path, capsys,
                                               monkeypatch):
        (tmp_path / "ARCHITECTURE.md").write_text(
            "| `tpu_miner_totally_bogus` | stale | gone |\n"
        )
        clean = tmp_path / "clean.py"
        clean.write_text("x = 1\n")
        monkeypatch.chdir(tmp_path)
        assert engine.main([str(clean)]) == 0
        capsys.readouterr()
        rc = engine.main(["--select", "metric-doc-drift", str(clean)])
        assert rc == 1
        capsys.readouterr()

    def test_list_rules(self, capsys):
        assert engine.main(["--list-rules"]) == 0
        out = capsys.readouterr().out
        for rule in ALL_RULES + ("metric-doc-drift",):
            assert rule in out

    def test_cli_dispatch(self):
        # `python -m bitcoin_miner_tpu_torch lint` reaches the engine.
        proc = subprocess.run(
            [sys.executable, "-m", "bitcoin_miner_tpu_torch", "lint",
             "--list-rules"],
            capture_output=True, text=True, timeout=120, cwd=REPO_ROOT,
        )
        assert proc.returncode == 0, proc.stderr
        assert "swallowed-cancel" in proc.stdout

    def test_cli_main_dispatch(self, capsys):
        # ...and so does the command line's own main, in process.
        from bitcoin_miner_tpu_torch import cli

        assert cli.main(["lint", "--list-rules"]) == 0
        assert "swallowed-cancel" in capsys.readouterr().out


# ------------------------------------------------ the call graph itself
class TestCallGraph:
    def test_import_alias_resolution(self):
        p = Program.from_sources({
            "alpha.py": ("import beta as b\n"
                         "from beta import helper as h\n"
                         "def f():\n"
                         "    b.g()\n"
                         "    h()\n"),
            "beta.py": ("def g():\n    pass\n"
                        "def helper():\n    pass\n"),
        })
        targets = {c.target for c in p.functions["alpha.f"].calls}
        assert targets == {"beta.g", "beta.helper"}

    def test_method_dispatch_through_base(self):
        p = Program.from_sources({"ring.py": (
            "class Base:\n"
            "    def flush(self):\n        pass\n"
            "class Ring(Base):\n"
            "    def push(self):\n"
            "        self.flush()\n"
        )})
        (call,) = p.functions["ring.Ring.push"].calls
        assert call.target == "ring.Base.flush"

    def test_attr_type_inference_one_hop(self):
        p = Program.from_sources({"host.py": (
            "class Ring:\n"
            "    def flush(self):\n        pass\n"
            "class Host:\n"
            "    def __init__(self):\n"
            "        self._ring = Ring()\n"
            "    def push(self):\n"
            "        self._ring.flush()\n"
        )})
        (call,) = p.functions["host.Host.push"].calls
        assert call.target == "host.Ring.flush"

    def test_context_propagates_three_hops(self):
        p = Program.from_sources({"deep.py": (
            "async def top():\n    a()\n"
            "def a():\n    b()\n"
            "def b():\n    c()\n"
            "def c():\n    pass\n"
        )})
        assert CTX_ASYNC in p.contexts("deep.c")
        chain = p.context_chain("deep.c", CTX_ASYNC)
        assert [q for q, _line in chain] == \
            ["deep.top", "deep.a", "deep.b", "deep.c"]

    def test_thread_and_signal_and_spawn_seeds(self):
        p = Program.from_sources({"seeds.py": (
            "import signal\n"
            "import threading\n"
            "import multiprocessing as mp\n"
            "def worker():\n    tick()\n"
            "def handler(signum, frame):\n    tick()\n"
            "def child():\n    tick()\n"
            "def tick():\n    pass\n"
            "def arm():\n"
            "    threading.Thread(target=worker, name='w').start()\n"
            "    signal.signal(signal.SIGUSR1, handler)\n"
            "    mp.get_context('spawn').Process(target=child)\n"
        )})
        assert CTX_THREAD in p.contexts("seeds.worker")
        assert CTX_SIGNAL in p.contexts("seeds.handler")
        assert CTX_SPAWN in p.contexts("seeds.child")
        assert {CTX_THREAD, CTX_SIGNAL, CTX_SPAWN} \
            <= p.contexts("seeds.tick")

    def test_deferred_call_does_not_propagate(self):
        p = Program.from_sources({"defer.py": (
            "import asyncio\n"
            "import threading\n"
            "_lock = threading.Lock()\n"
            "async def outer():\n"
            "    with _lock:\n"
            "        asyncio.create_task(later())\n"
            "async def later():\n    pass\n"
        )})
        assert p.entry_locks("defer.later") == frozenset()

    def test_cross_module_lock_cycle(self):
        p = Program.from_sources({
            "front.py": ("import threading\n"
                         "import back\n"
                         "_dispatch_lock = threading.Lock()\n"
                         "def submit():\n"
                         "    with _dispatch_lock:\n"
                         "        back.commit()\n"),
            "back.py": ("import threading\n"
                        "import front\n"
                        "_state_lock = threading.Lock()\n"
                        "def commit():\n"
                        "    with _state_lock:\n        pass\n"
                        "def rollback():\n"
                        "    with _state_lock:\n"
                        "        front.submit()\n"),
        })
        (cycle,) = p.lock_cycles()
        assert set(cycle.locks) == \
            {"front._dispatch_lock", "back._state_lock"}

    def test_consistent_order_no_cycle(self):
        p = Program.from_sources({"ok.py": (
            "import threading\n"
            "_a_lock = threading.Lock()\n"
            "_b_lock = threading.Lock()\n"
            "def one():\n"
            "    with _a_lock:\n"
            "        with _b_lock:\n            pass\n"
            "def two():\n"
            "    with _a_lock:\n"
            "        with _b_lock:\n            pass\n"
        )})
        assert p.lock_edges()
        assert p.lock_cycles() == []


# ----------------------------------------- transitive findings (pins)
class TestTransitiveFindings:
    def test_blocking_two_hops_below_async(self):
        src = (
            "import time\n"
            "async def top():\n"
            "    helper_a()\n"
            "def helper_a():\n"
            "    helper_b()\n"
            "def helper_b():\n"
            "    time.sleep(1)\n"
        )
        findings = [f for f in lint_source(src)
                    if f.rule == "blocking-in-async"]
        assert len(findings) == 1
        assert findings[0].line == 7
        assert "top" in findings[0].message

    def test_lock_across_await_in_awaited_callee(self):
        src = (
            "import threading\n"
            "_flush_lock = threading.Lock()\n"
            "async def outer(sink):\n"
            "    with _flush_lock:\n"
            "        await inner(sink)\n"
            "async def inner(sink):\n"
            "    await sink.drain()\n"
        )
        lines = {f.line for f in lint_source(src)
                 if f.rule == "lock-across-await"}
        assert lines == {5, 7}

    def test_signal_handler_hazard_two_hops_down(self):
        src = (
            "import signal\n"
            "import threading\n"
            "_lock = threading.Lock()\n"
            "def handler(signum, frame):\n"
            "    flush()\n"
            "def flush():\n"
            "    persist()\n"
            "def persist():\n"
            "    with _lock:\n"
            "        pass\n"
            "signal.signal(signal.SIGUSR1, handler)\n"
        )
        findings = [f for f in lint_source(src)
                    if f.rule == "signal-handler-safety"]
        assert findings, "lock 2 hops below the handler was missed"
        assert "persist" in findings[0].message

    def test_one_hop_shapes_still_fire(self):
        src = (
            "import time\n"
            "async def f():\n"
            "    time.sleep(1)\n"
        )
        assert [f.rule for f in lint_source(src)] == ["blocking-in-async"]

    def test_process_started_through_to_thread_is_off_the_loop(self):
        # The smoke's frontend phases build their Popen-owning Frontend
        # with asyncio.to_thread: a thread boundary, so no finding; built
        # in the coroutine itself, its __init__ runs on the loop.
        cls = (
            "import asyncio\n"
            "import subprocess\n"
            "class Frontend:\n"
            "    def __init__(self, argv):\n"
            "        self.proc = subprocess.Popen(argv)\n"
        )
        off = cls + ("async def phase():\n"
                     "    fe = await asyncio.to_thread(Frontend, ['x'])\n")
        on = cls + "async def phase():\n    fe = Frontend(['x'])\n"
        assert lint_source(off, path="smoke.py") == []
        (finding,) = lint_source(on, path="smoke.py")
        assert (finding.rule, finding.line) == ("blocking-in-async", 5)


# ------------------------------------------------------ baseline ratchet
class TestBaselineRatchet:
    DIRTY = "import threading\nt = threading.Thread(target=print)\n"

    def _baseline(self, tmp_path, entries, changelog=()):
        bl = tmp_path / "baseline.json"
        bl.write_text(json.dumps({
            "schema": "tpu-miner-lint-baseline/1",
            "entries": entries,
            "changelog": list(changelog),
        }))
        return str(bl)

    def test_new_finding_fails_against_empty_baseline(self, tmp_path,
                                                      capsys):
        dirty = tmp_path / "dirty.py"
        dirty.write_text(self.DIRTY)
        bl = self._baseline(tmp_path, {})
        rc = engine.main(["--json", "--baseline", bl, str(dirty)])
        doc = json.loads(capsys.readouterr().out)
        assert rc == 1
        assert doc["baseline"]["new"] == 1
        assert doc["baseline"]["tracked"] == 0

    def test_tracked_finding_passes(self, tmp_path, capsys):
        dirty = tmp_path / "dirty.py"
        dirty.write_text(self.DIRTY)
        key = "thread-discipline::" + str(dirty).replace(os.sep, "/")
        bl = self._baseline(tmp_path, {key: 1})
        rc = engine.main(["--json", "--baseline", bl, str(dirty)])
        doc = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert doc["baseline"]["tracked"] == 1
        assert doc["baseline"]["new"] == 0

    def test_stale_entry_fails(self, tmp_path, capsys):
        clean = tmp_path / "clean.py"
        clean.write_text("x = 1\n")
        key = "thread-discipline::" + str(clean).replace(os.sep, "/")
        bl = self._baseline(tmp_path, {key: 2})
        rc = engine.main(["--json", "--baseline", bl, str(clean)])
        doc = json.loads(capsys.readouterr().out)
        assert rc == 1
        assert doc["baseline"]["stale"] == [
            {"key": key, "baseline": 2, "current": 0}
        ]

    def test_growth_within_tracked_file_is_new(self, tmp_path, capsys):
        dirty = tmp_path / "dirty.py"
        dirty.write_text(self.DIRTY + self.DIRTY.replace("t =", "u ="))
        key = "thread-discipline::" + str(dirty).replace(os.sep, "/")
        bl = self._baseline(tmp_path, {key: 1})
        rc = engine.main(["--json", "--baseline", bl, str(dirty)])
        doc = json.loads(capsys.readouterr().out)
        assert rc == 1
        assert doc["baseline"]["new"] == 2

    def test_bad_baseline_schema_exits_2(self, tmp_path, capsys):
        clean = tmp_path / "clean.py"
        clean.write_text("x = 1\n")
        bl = tmp_path / "baseline.json"
        bl.write_text(json.dumps({"schema": "nope/9", "entries": {}}))
        assert engine.main(["--baseline", str(bl), str(clean)]) == 2
        assert "baseline" in capsys.readouterr().err

    def test_write_baseline_preserves_changelog(self, tmp_path, capsys):
        dirty = tmp_path / "dirty.py"
        dirty.write_text(self.DIRTY)
        bl = self._baseline(tmp_path, {}, changelog=["2026-08-07 seeded"])
        rc = engine.main(["--write-baseline", bl, str(dirty)])
        capsys.readouterr()
        assert rc == 0
        doc = json.loads(open(bl).read())
        assert doc["schema"] == "tpu-miner-lint-baseline/1"
        assert doc["changelog"] == ["2026-08-07 seeded"]
        (key,) = doc["entries"]
        assert key.startswith("thread-discipline::")
        assert engine.main(["--baseline", bl, str(dirty)]) == 0
        capsys.readouterr()

    def test_write_baseline_round_trips(self, tmp_path):
        dirty = tmp_path / "dirty.py"
        dirty.write_text(self.DIRTY)
        bl = str(tmp_path / "written.json")
        write_baseline(bl, lint_file(str(dirty)))
        assert engine.load_baseline(bl) == {
            "thread-discipline::" + str(dirty).replace(os.sep, "/"): 1}

    def test_repo_baseline_is_empty_and_passes(self, capsys, monkeypatch):
        # Divergence: the port's ratchet lives in its package, not in
        # benchmarks/. It ships empty, with the audit's changelog, and the
        # default roots (the package and its root scripts) pass it.
        doc = json.loads(open(os.path.join(REPO_ROOT, BASELINE)).read())
        assert doc["schema"] == "tpu-miner-lint-baseline/1"
        assert doc["entries"] == {}
        assert doc["changelog"]
        monkeypatch.chdir(REPO_ROOT)
        rc = engine.main(["--json", "--baseline", BASELINE])
        out = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert out["files_scanned"] > 50
        assert out["baseline"] == {"path": BASELINE,
                                   "tracked": 0, "new": 0, "stale": []}


# --------------------------------------------------- the gate itself
class TestHeadClean:
    def test_lint_exits_zero_on_head(self):
        """The port's tree lints clean over its default roots (every
        hazard fixed or suppressed WITH a justification)."""
        roots = [os.path.join(REPO_ROOT, r) for r in engine.DEFAULT_ROOTS]
        assert engine.DEFAULT_ROOTS == (
            "bitcoin_miner_tpu_torch", "chip_smoke.py", "sweep_pairs.py")
        findings, n = run_lint(roots, project_root=REPO_ROOT)
        assert n > 50
        assert findings == [], "\n".join(f.render() for f in findings)

    def test_restored_markers_hold(self):
        # The reference's markers, restored in the port's counterparts:
        # import-safe on the six pool frontend modules, sync-hot-path on
        # the frontend's _push and _dispatch, which stay synchronous all
        # the way down (no sync-hot-path-await finding on HEAD).
        marked = sorted(
            os.path.relpath(p, PACKAGE)
            for p in glob.glob(os.path.join(PACKAGE, "**", "*.py"),
                               recursive=True)
            if "# miner-lint: import-safe" in open(p).read())
        assert marked == [os.path.join("poolserver", f) for f in (
            "__init__.py", "jobs.py", "runner.py", "server.py",
            "shard.py", "space.py")]
        server = os.path.join(PACKAGE, "poolserver", "server.py")
        program = Program.from_paths([server])
        qual = "bitcoin_miner_tpu_torch.poolserver.server.StratumPoolServer"
        assert set(program.hot_paths) == {f"{qual}._push",
                                          f"{qual}._dispatch"}
        assert program.dangling_hot_marks == []
        for name in ("_push", "_dispatch"):
            assert not any(program.functions[t].is_async for t in
                           program.reachable(f"{qual}.{name}")), name


# ----------------------------------------------- vocabulary consistency
class TestVocabulary:
    def test_vocabulary_matches_live_registry(self):
        from bitcoin_miner_tpu_torch.telemetry.pipeline import (
            METRIC_DEVICE_BUSY,
            PipelineTelemetry,
        )
        from bitcoin_miner_tpu_torch.telemetry.vocabulary import (
            REGISTRY_FAMILIES,
        )

        tel = PipelineTelemetry()
        live = {fam.name: fam.kind for fam in tel.registry.families()}
        declared = dict(REGISTRY_FAMILIES)
        assert declared.pop(METRIC_DEVICE_BUSY) == "gauge"
        normalized = {
            name[:-len("_total")] if name.endswith("_total") else name:
                kind
            for name, kind in declared.items()
        }
        assert live == normalized

    def test_linter_import_chain_is_covered(self):
        # The linter imports telemetry.vocabulary → pipeline → flightrec/
        # metrics/tracing at lint time: torch anywhere in telemetry/
        # would make the lint load it, so the whole package is in the
        # import-safe set.
        for src in ("import torch\n", "import jax\n"):
            for rel in ("bitcoin_miner_tpu_torch/telemetry/pipeline.py",
                        "bitcoin_miner_tpu_torch/telemetry/vocabulary.py",
                        "bitcoin_miner_tpu_torch/analysis/rules.py"):
                findings = lint_source(src, path=f"/ws/repo/{rel}")
                assert [f.rule for f in findings] \
                    == ["device-claiming-import"], (src, rel)

    def test_import_safe_marker_anywhere_in_file(self):
        src = (
            '"""' + "docstring line\n" * 20 + '"""\n'
            "# miner-lint: import-safe — host tooling reads this\n"
            "import torch\n"
        )
        findings = lint_source(src, path="/ws/elsewhere/tool.py")
        assert [f.rule for f in findings] == ["device-claiming-import"]

    def test_metric_rule_exemption_is_package_anchored(self):
        # Exempt ONLY the port's telemetry/ dir: neither a checkout under
        # some directory named telemetry/ nor the reference's own
        # telemetry/ disables the rule.
        src = "reg.counter('tpu_miner_made_up_series', 'x')\n"
        for stray in ("/home/ops/telemetry/repo/probe.py",
                      "/ws/repo/bitcoin_miner_tpu/telemetry/pipeline.py"):
            assert [f.rule for f in lint_source(src, path=stray)] \
                == ["metric-vocabulary"], stray
        home = "/ws/repo/bitcoin_miner_tpu_torch/telemetry/pipeline.py"
        assert lint_source(src, path=home) == []

    def test_all_names_cover_rendered_forms(self):
        from bitcoin_miner_tpu_torch.telemetry.vocabulary import (
            all_metric_names,
        )

        names = all_metric_names()
        assert "tpu_miner_pool_acks" in names
        assert "tpu_miner_pool_acks_total" in names
        assert "tpu_miner_hashes_total" in names
        assert "tpu_miner_hashrate_mhs" in names


# ------------------------------------------------------------ doc drift
class TestDocDrift:
    def _doc(self, extra_rows=(), drop=None) -> str:
        from bitcoin_miner_tpu_torch.telemetry.vocabulary import (
            documented_names,
        )

        names = sorted(documented_names())
        if drop is not None:
            names.remove(drop)
        rows = [f"| `{n}` | meaning | layer |" for n in names]
        rows.append("| `tpu_miner_<stat>_total` | legacy counters | "
                    "status |")
        rows.extend(extra_rows)
        return "# doc\n\n| metric | meaning | layer |\n|---|---|---|\n" \
            + "\n".join(rows) + "\n"

    def test_clean_doc_passes(self, tmp_path):
        (tmp_path / "ARCHITECTURE.md").write_text(self._doc())
        assert check_doc_drift(str(tmp_path)) == []

    def test_unknown_documented_metric_flagged(self, tmp_path):
        (tmp_path / "ARCHITECTURE.md").write_text(self._doc(
            extra_rows=["| `tpu_miner_bogus_series` | stale | gone |"],
        ))
        findings = check_doc_drift(str(tmp_path))
        assert len(findings) == 1
        assert "tpu_miner_bogus_series" in findings[0].message

    def test_undocumented_vocabulary_metric_flagged(self, tmp_path):
        (tmp_path / "ARCHITECTURE.md").write_text(
            self._doc(drop="tpu_miner_health")
        )
        findings = check_doc_drift(str(tmp_path))
        assert len(findings) == 1
        assert "tpu_miner_health" in findings[0].message

    def test_prose_mentions_ignored(self, tmp_path):
        (tmp_path / "ARCHITECTURE.md").write_text(
            self._doc() + "\nProse naming tpu_miner_never_exported is "
                          "narrative, not contract.\n"
        )
        assert check_doc_drift(str(tmp_path)) == []

    def test_fenced_code_ignored(self, tmp_path):
        (tmp_path / "ARCHITECTURE.md").write_text(
            self._doc()
            + "\n## Static analysis\n\n```bash\n"
              "# a comment, not a heading\n"
              "| tpu_miner_fenced_example | out | put |\n"
              "```\n\n"
              "| rule | with the `tpu_miner_<stat>_total` placeholder "
              "named as a concept |\n"
        )
        assert check_doc_drift(str(tmp_path)) == []

    def test_placeholder_row_removal_detected(self, tmp_path):
        doc = self._doc().replace(
            "| `tpu_miner_<stat>_total` | legacy counters | "
            "status |",
            "",
        ) + (
            "\n## Static analysis\n\n"
            "| rule | names `tpu_miner_<stat>_total` as a concept |\n"
        )
        (tmp_path / "ARCHITECTURE.md").write_text(doc)
        findings = check_doc_drift(str(tmp_path))
        assert len(findings) == 1
        assert "no longer documented" in findings[0].message

    def test_subheading_stays_inside_excluded_section(self, tmp_path):
        doc = self._doc().replace(
            "| `tpu_miner_<stat>_total` | legacy counters | "
            "status |",
            "",
        ) + (
            "\n## Static analysis\n\n### Suppression policy\n\n"
            "| rule | names `tpu_miner_<stat>_total` as a concept |\n"
            "\n## After the section\n\nprose only\n"
        )
        (tmp_path / "ARCHITECTURE.md").write_text(doc)
        findings = check_doc_drift(str(tmp_path))
        assert len(findings) == 1
        assert "no longer documented" in findings[0].message

    def test_missing_doc_skips(self, tmp_path):
        assert check_doc_drift(str(tmp_path)) == []

    def test_real_architecture_md_in_sync(self):
        # The repo's ARCHITECTURE.md, read only: the port's families are
        # the reference's, name for name.
        assert check_doc_drift(REPO_ROOT) == []


# ------------------------------------- the port against the reference
def _positions(lint, path):
    return sorted((f.rule, f.line, f.col) for f in lint(path)
                  if f.rule != "device-claiming-import")


class TestParityWithReference:
    @pytest.mark.parametrize(
        "name", sorted(os.path.basename(p)
                       for p in glob.glob(os.path.join(FIXTURES, "*.py"))))
    def test_same_findings_on_every_fixture(self, name):
        path = os.path.join(FIXTURES, name)
        port = _positions(lint_file, path)
        assert port == _positions(ref_engine.lint_file, path)
        if name.endswith("_tp.py"):
            assert port or name.startswith("device_claiming_import")

    @pytest.mark.parametrize("table", [
        "REGISTRY_FAMILIES", "STATUS_SNAPSHOT_COUNTERS",
        "STATUS_SNAPSHOT_GAUGES", "all_metric_names", "documented_names",
        "store_derived_series"])
    def test_same_vocabulary(self, table):
        from bitcoin_miner_tpu.telemetry import vocabulary as ref_vocab
        from bitcoin_miner_tpu_torch.telemetry import vocabulary

        port, ref = getattr(vocabulary, table), getattr(ref_vocab, table)
        if callable(port):
            port, ref = port(), ref()
        assert port == ref
        assert port

    def test_same_rule_table(self, capsys):
        def names(main):
            assert main(["--list-rules"]) == 0
            return [line.split()[0]
                    for line in capsys.readouterr().out.splitlines()]

        port = names(engine.main)
        assert port == names(ref_engine.main)
        assert sorted(port) == sorted(ALL_RULES + ("metric-doc-drift",))

    def test_same_schemas_and_suppression_syntax(self):
        assert (engine.SCHEMA, engine.BASELINE_SCHEMA) == (
            ref_engine.SCHEMA, ref_engine.BASELINE_SCHEMA)
        assert engine._SUPPRESS_RE.pattern == ref_engine._SUPPRESS_RE.pattern


# ------------------------------------------------ the port's boundary
def _port_fixtures(kind):
    return sorted(os.path.relpath(p, PORT_FIXTURES) for p in glob.glob(
        os.path.join(PORT_FIXTURES, "**", f"*_{kind}.py"), recursive=True))


class TestPortBoundary:
    """Divergence: the port's ``device-claiming-import`` covers torch in
    import-safe modules and the port's boundary (no jax, no
    ``bitcoin_miner_tpu``) in every file of the package and its root
    scripts."""

    @pytest.mark.parametrize("rel", _port_fixtures("tp"))
    def test_true_positive_flags_each_marked_line(self, rel):
        path = os.path.join(PORT_FIXTURES, rel)
        with open(path) as f:
            want = [i for i, line in enumerate(f, 1)
                    if line.rstrip().endswith("# expect")]
        findings = lint_file(path)
        assert want
        assert [(f.rule, f.line) for f in findings] == [
            ("device-claiming-import", n) for n in want]

    @pytest.mark.parametrize("rel", _port_fixtures("tn"))
    def test_true_negative_clean_of_everything(self, rel):
        assert lint_file(os.path.join(PORT_FIXTURES, rel)) == []

    @pytest.mark.parametrize("src", [
        "import jax\n",
        "import jax.numpy as jnp\n",
        "import jaxlib\n",
        "from jax import numpy\n",
        "import bitcoin_miner_tpu.cli\n",
        "from bitcoin_miner_tpu.core import header\n",
        "from bitcoin_miner_tpu import cli\n",
        "def f():\n    import jax\n",
        "def f():\n    from bitcoin_miner_tpu.ops import sha256_jax\n",
        "class C:\n    def m(self):\n        import bitcoin_miner_tpu.x\n",
    ])
    @pytest.mark.parametrize("rel", [
        "bitcoin_miner_tpu_torch/ops/sha256_torch.py",
        "bitcoin_miner_tpu_torch/backends/cuda.py",
        "bitcoin_miner_tpu_torch/telemetry/pipeline.py",
        "chip_smoke.py", "sweep_pairs.py"])
    def test_planted_boundary_import_is_flagged(self, src, rel):
        findings = lint_source(src, path=f"/ws/repo/{rel}")
        assert [f.rule for f in findings] == ["device-claiming-import"]
        assert "boundary" in findings[0].message

    @pytest.mark.parametrize("src", [
        "import bitcoin_miner_tpu_torch.ops\n",
        "from bitcoin_miner_tpu_torch.core import header\n",
        "from . import header\n",
        "from ..core import header\n",
        "from typing import TYPE_CHECKING\n"
        "if TYPE_CHECKING:\n    import jax\n",
    ])
    def test_the_ports_own_imports_pass(self, src):
        path = "/ws/repo/bitcoin_miner_tpu_torch/telemetry/pipeline.py"
        assert lint_source(src, path=path) == []

    @pytest.mark.parametrize("rel,flagged", [
        ("bitcoin_miner_tpu_torch/telemetry/perfledger.py", True),
        ("bitcoin_miner_tpu_torch/perf_cli.py", True),
        ("bitcoin_miner_tpu_torch/protocol/stratum.py", True),
        ("bitcoin_miner_tpu_torch/utils/status.py", True),
        ("bitcoin_miner_tpu_torch/analysis/engine.py", True),
        ("bitcoin_miner_tpu_torch/ops/sha256_torch.py", False),
        ("bitcoin_miner_tpu_torch/backends/cuda.py", False),
        ("bitcoin_miner_tpu_torch/poolserver/server.py", False),
        ("chip_smoke.py", False),
        ("bitcoin_miner_tpu/telemetry/perfledger.py", False),
    ])
    def test_torch_only_in_import_safe_modules(self, rel, flagged):
        for src in ("import torch\n",
                    "def f():\n    from torch.profiler import profile\n"):
            findings = lint_source(src, path=f"/ws/repo/{rel}")
            assert bool(findings) is flagged, (rel, src)

    def test_outside_the_port_the_reference_may_be_imported(self):
        # Tests and the reference import both packages.
        src = "import jax\nimport bitcoin_miner_tpu.cli\n"
        for rel in ("tests/test_x.py", "bitcoin_miner_tpu/cli.py",
                    "benchmarks/run.py"):
            assert lint_source(src, path=f"/ws/repo/{rel}") == [], rel

    def test_anchors_are_the_ports(self):
        # Divergence: module names anchor on the port's package (and
        # tests); the reference's package and a root script are modules
        # of their own names.
        name = callgraph.module_name_for_path
        assert name("/ws/repo/bitcoin_miner_tpu_torch/miner/dispatcher.py") \
            == "bitcoin_miner_tpu_torch.miner.dispatcher"
        assert name("/ws/repo/bitcoin_miner_tpu_torch/poolserver/"
                    "__init__.py") == "bitcoin_miner_tpu_torch.poolserver"
        assert name("/ws/repo/tests/test_x.py") == "tests.test_x"
        assert name("/ws/repo/chip_smoke.py") == "chip_smoke"
        assert name("/ws/repo/bitcoin_miner_tpu/miner/dispatcher.py") \
            == "dispatcher"
        assert all(p.startswith("/bitcoin_miner_tpu_torch/")
                   for p in rules._IMPORT_SAFE_PATHS)

    def test_lint_process_loads_neither_torch_nor_jax(self):
        # Divergence: `lint` is dispatched in __main__ before the command
        # line's imports load torch.
        code = (
            "import json, runpy, sys\n"
            "sys.argv = ['bitcoin_miner_tpu_torch', 'lint', "
            "'--list-rules']\n"
            "rc = None\n"
            "try:\n"
            "    runpy.run_module('bitcoin_miner_tpu_torch', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "print(json.dumps({'rc': rc, 'torch': 'torch' in sys.modules, "
            "'jax': 'jax' in sys.modules}))\n"
        )
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        lines = proc.stdout.splitlines()
        assert "swallowed-cancel" in proc.stdout
        assert json.loads(lines[-1]) == {"rc": 0, "torch": False,
                                         "jax": False}


# ------------------------------------------- the smoke's miner_lint phase
def test_chip_smoke_miner_lint_phase_runs_on_the_cpu():
    """``chip_smoke.py``'s host-only phase, as the card's machine runs it:
    the gate and the module check in two children, and the rule table."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_lint", os.path.join(REPO_ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.LINT_BASELINE == BASELINE
    assert sorted(smoke.LINT_RULES) == sorted(
        ALL_RULES + ("metric-doc-drift",))
    out = smoke.miner_lint()
    assert out["findings"] == 0 and out["rules"] == 16
    assert out["files_scanned"] > 50
    assert not out["torch_loaded"] and not out["jax_loaded"]
