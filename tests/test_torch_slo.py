"""The PyTorch package's SLO engine, incident capture, ``slo`` command and
the health model's ``slo`` and ``share_loss`` rules against the JAX
package's ``telemetry/slo.py`` and ``telemetry/health.py``: the same
seeded snapshot sequences on a fake clock give the same reports, burn
gauges and transitions (timestamps left out); the same objective files
parse to the same objectives or raise the same errors; the same reports
render the same and exit the same. The objectives' descriptions are left
out of the comparison: the port's ``frontend-validate`` description
drops the reference's history note."""

import json
import os

import numpy as np
import pytest

from bitcoin_miner_tpu.telemetry import health as ref_health
from bitcoin_miner_tpu.telemetry import pipeline as ref_pipeline
from bitcoin_miner_tpu.telemetry import slo as ref_slo
from bitcoin_miner_tpu_torch import cli
from bitcoin_miner_tpu_torch.miner.dispatcher import MinerStats
from bitcoin_miner_tpu_torch.telemetry import health as port_health
from bitcoin_miner_tpu_torch.telemetry import perfledger as port_perfledger
from bitcoin_miner_tpu_torch.telemetry import pipeline as port_pipeline
from bitcoin_miner_tpu_torch.telemetry import slo as port_slo
from bitcoin_miner_tpu_torch.utils import status as port_status

SEED = 1300
PAIRS = ((ref_slo, ref_pipeline), (port_slo, port_pipeline))


def _strip(report):
    """A report without its wall-clock stamp and the descriptions."""
    out = {k: v for k, v in report.items() if k != "generated_ts"}
    out["objectives"] = [{k: v for k, v in s.items() if k != "description"}
                         for s in report["objectives"]]
    return out


def _engines(objectives=None, **kw):
    """(reference, port) engines, each with its own bundle, on one fake
    clock, counting on_breach calls."""
    now = [0.0]
    fired = [[], []]
    out = []
    for i, (slo, pipeline) in enumerate(PAIRS):
        kw_i = dict(kw)
        if objectives is not None:
            kw_i["objectives"] = slo.parse_objectives(objectives)
        out.append(slo.SloEngine(
            pipeline.PipelineTelemetry(), clock=lambda: now[0],
            on_breach=fired[i].append, **kw_i))
    return out, now, fired


def _snapshots(n: int = 60):
    """A seeded snapshot sequence that walks every recipe: histogram
    counts of submit_rtt (the reference's buckets) with slow phases,
    pool verdicts with a reject burst, fleet children going quarantined,
    share efficiency across the confidence floor, lost shares, a
    fabric's slot rates and a frontend's claimed work."""
    rng = np.random.default_rng(SEED)
    bounds = tuple(ref_pipeline.PipelineTelemetry().submit_rtt.bounds)
    counts = [0] * (len(bounds) + 1)
    acks = {"accepted": 0.0, "rejected": 0.0}
    lost = claimed = submits = 0.0
    snaps = []
    for i in range(n):
        slow = 20 <= i < 35
        for _ in range(int(rng.integers(0, 8))):
            v = float(rng.exponential(4.0 if slow else 0.01))
            idx = int(np.searchsorted(bounds, v, side="left"))
            for j in range(idx, len(counts)):
                counts[j] += 1
        reject = 30 <= i < 45
        acks["accepted"] += 0 if reject else float(rng.integers(1, 6))
        acks["rejected"] += float(rng.integers(3, 9)) if reject else float(
            rng.integers(0, 2))
        lost += float(rng.integers(0, 3)) if 40 <= i < 50 else 0.0
        claimed += 0.0 if i > 50 else float(rng.exponential(1e-6))
        submits += 1.0
        fleet = {"a:1": 0.0, "b:2": 3.0 if 25 <= i < 40 else 0.0,
                 "c:3": float(rng.choice([0.0, 1.0, 2.0]))}
        snap = {
            "share_efficiency": float(rng.uniform(0.0, 1.2)),
            "share_expected": float(i * 1.5),
            "share_lost": lost,
            "submit_rtt": (bounds, list(counts)),
            "job_broadcast": ((), []),
            "frontend_validate": ((), []),
            "pool_acks": dict(acks),
            "fleet_children": fleet if i >= 5 else {},
        }
        if i % 3 == 0:
            snap["slot_accept"] = {"pool-a": float(rng.uniform(0.5, 1.0)),
                                   "pool-b": None if i < 10 else float(
                                       rng.uniform(0.0, 1.0))}
        snap["frontend_work"] = {"t": float(i), "claimed_work": claimed,
                                 "submits": submits,
                                 "sessions": 2.0 if i > 3 else 0.0}
        snaps.append(snap)
    return snaps


def _transitions(engine):
    return [(e["objective"], e["state"], e["previous"], e["burn_fast"],
             e["burn_slow"])
            for e in engine.telemetry.flightrec.snapshot()
            if e["kind"] == "slo"]


WORK_FLOOR = {"objectives": [
    {"name": "claimed", "kind": "work_floor", "target": 0.5,
     "floor": 1e-7, "signal": "poolserver.claimed_work"},
    {"name": "accept", "kind": "accept_rate", "target": 0.9},
    {"name": "rtt", "kind": "latency", "target": 0.95, "threshold_s": 0.1,
     "signal": "tpu_miner_submit_rtt_seconds"},
]}


@pytest.mark.parametrize("objectives", [None, WORK_FLOOR],
                         ids=["default", "file"])
def test_the_same_snapshots_give_the_same_reports(objectives):
    (ref, port), now, fired = _engines(objectives, fast_window_s=4.0,
                                       slow_window_s=12.0, min_events=3)
    assert _strip(ref.report_dict()) == _strip(port.report_dict())
    for i, snap in enumerate(_snapshots()):
        now[0] = float(i)
        a, b = ref.evaluate(snap), port.evaluate(snap)
        assert _strip(a) == _strip(b), i
        assert ref.states() == port.states()
        assert ref.summary() == port.summary()
    assert _transitions(ref) == _transitions(port)
    states = {t[1] for t in _transitions(port)}
    assert {"ok", "fast_burn", "breach"} <= states
    assert len(fired[0]) == len(fired[1]) > 0
    burns = [{k: c.value for k, c in e.telemetry.slo_burn.children()}
             for e in (ref, port)]
    slots = [{k: c.value for k, c in e.telemetry.slo_slot_burn.children()}
             for e in (ref, port)]
    assert burns[0] == burns[1] and slots[0] == slots[1]
    assert ref.series_history() == port.series_history()
    assert ref.series_history(window_s=3.0) == port.series_history(
        window_s=3.0)


def test_work_floor_reads_no_data_without_a_frontend():
    """An objective file that names the frontend's claimed work parses
    the same, and reads no_data in both without a frontend."""
    (ref, port), now, _ = _engines(WORK_FLOOR, fast_window_s=4.0,
                                   slow_window_s=12.0)
    for t in range(6):
        now[0] = float(t)
        reports = [e.evaluate() for e in (ref, port)]
    assert _strip(reports[0]) == _strip(reports[1])
    state = {s["name"]: s["state"] for s in reports[1]["objectives"]}
    assert state["claimed"] == "no_data"


def test_live_samples_match_on_the_same_bundle_moves():
    """``evaluate()`` sampling each package's own bundle, moved alike."""
    (ref, port), now, _ = _engines(fast_window_s=2.0, slow_window_s=6.0,
                                   min_events=2)
    rng = np.random.default_rng(SEED)
    for t in range(12):
        now[0] = float(t)
        kind = "accepted" if t < 6 else "rejected"
        n = int(rng.integers(1, 4))
        rtt = float(rng.exponential(0.5))
        for e in (ref, port):
            e.telemetry.pool_acks.labels(result=kind).inc(n)
            e.telemetry.submit_rtt.observe(rtt)
            e.telemetry.fleet_child_state.labels(child="w").set(
                3.0 if t > 8 else 0.0)
        assert _strip(ref.evaluate()) == _strip(port.evaluate())
    assert _transitions(ref) == _transitions(port)


def test_burn_rate_matches():
    for sli in (None, 0.0, 0.05, 0.5, 0.9, 0.99, 1.0, 1.2, -0.1):
        for target in (0.5, 0.9, 0.99, 1.0):
            assert ref_slo.burn_rate(sli, target) == \
                port_slo.burn_rate(sli, target)


def test_default_objectives_match_but_for_descriptions():
    def key(o):
        return (o.name, o.kind, o.target, o.threshold_s, o.signal, o.floor)

    assert [key(o) for o in ref_slo.DEFAULT_OBJECTIVES] == [
        key(o) for o in port_slo.DEFAULT_OBJECTIVES]
    assert port_slo.LATENCY_SIGNALS == ref_slo.LATENCY_SIGNALS
    assert port_slo.OBJECTIVE_KINDS == ref_slo.OBJECTIVE_KINDS


BAD_OBJECTIVES = [
    [], {"schema": "tpu-miner-slo-objectives/2", "objectives": []},
    {"objectives": []}, {"objectives": ["x"]},
    {"objectives": [{"name": "a", "kind": "latency", "treshold_s": 1}]},
    {"objectives": [{"name": "", "kind": "latency"}]},
    {"objectives": [{"name": "a", "kind": "ratio_floor", "target": 0.5},
                    {"name": "a", "kind": "ratio_floor", "target": 0.5}]},
    {"objectives": [{"name": "a", "kind": "p99"}]},
    {"objectives": [{"name": "a", "kind": "accept_rate", "target": 1.5}]},
    {"objectives": [{"name": "a", "kind": "accept_rate", "target": True}]},
    {"objectives": [{"name": "a", "kind": "accept_rate", "target": 0.9,
                     "threshold_s": -1}]},
    {"objectives": [{"name": "a", "kind": "accept_rate", "target": 0.9,
                     "floor": "x"}]},
    {"objectives": [{"name": "a", "kind": "accept_rate", "target": 0.9,
                     "signal": 3}]},
    {"objectives": [{"name": "a", "kind": "accept_rate", "target": 0.9,
                     "description": 3}]},
    {"objectives": [{"name": "a", "kind": "latency", "target": 0.9}]},
    {"objectives": [{"name": "a", "kind": "latency", "target": 0.9,
                     "threshold_s": 1.0, "signal": "submit_rtt"}]},
    {"objectives": [{"name": "a", "kind": "work_floor", "target": 0.9}]},
]


@pytest.mark.parametrize("payload", BAD_OBJECTIVES)
def test_bad_objective_files_raise_the_same_errors(payload, tmp_path):
    path = tmp_path / "objectives.json"
    path.write_text(json.dumps(payload))
    with pytest.raises(ref_slo.SloConfigError) as ref:
        ref_slo.load_objectives(str(path))
    with pytest.raises(port_slo.SloConfigError) as port:
        port_slo.load_objectives(str(path))
    assert str(ref.value) == str(port.value)


def test_unreadable_objective_files_raise_the_same_errors(tmp_path):
    for path, text in ((tmp_path / "missing.json", None),
                       (tmp_path / "bad.json", "{not json")):
        if text is not None:
            path.write_text(text)
        errors = []
        for slo in (ref_slo, port_slo):
            with pytest.raises(slo.SloConfigError) as e:
                slo.load_objectives(str(path))
            errors.append(str(e.value))
        assert errors[0] == errors[1]
    good = tmp_path / "good.json"
    good.write_text(json.dumps(WORK_FLOOR))
    assert ref_slo.load_objectives(str(good)) == tuple(
        ref_slo.SloObjective(**o.__dict__)
        for o in port_slo.load_objectives(str(good)))


def test_engine_refuses_the_same_windows():
    for kw in ({"fast_window_s": 0.0}, {"fast_window_s": 10.0,
                                        "slow_window_s": 5.0}):
        errors = []
        for slo, pipeline in PAIRS:
            with pytest.raises(ValueError) as e:
                slo.SloEngine(pipeline.PipelineTelemetry(), **kw)
            errors.append(str(e.value))
        assert errors[0] == errors[1]


# ---------------------------------------------------------------- health
@pytest.mark.parametrize("slo_states,share_loss", [
    (None, None),
    ([{"name": "a", "state": "no_data", "burn_fast": None}], None),
    ([{"name": "a", "state": "ok", "burn_fast": 0.2},
      {"name": "b", "state": "no_data", "burn_fast": None}], None),
    ([{"name": "a", "state": "fast_burn", "burn_fast": 3.5},
      {"name": "b", "state": "breach", "burn_fast": 12.0},
      {"name": "c", "state": "ok", "burn_fast": 0.0}], None),
    (None, {"fast_lost": 2.0, "fast_rate": 1.0, "base_rate": 0.0}),
    (None, {"fast_lost": 5.0, "fast_rate": 1.0, "base_rate": 0.1}),
    (None, {"fast_lost": 5.0, "fast_rate": 1.0, "base_rate": 0.5}),
    ([{"name": "a", "state": "ok", "burn_fast": 0.0}],
     {"fast_lost": 0.0, "fast_rate": 0.0, "base_rate": 0.0}),
])
def test_slo_and_share_loss_rules_match(slo_states, share_loss):
    ref_tel = ref_pipeline.PipelineTelemetry()
    port_tel = port_pipeline.PipelineTelemetry()
    ref_model = ref_health.HealthModel(ref_tel, relay_probe=lambda: False)
    port_model = port_health.HealthModel(port_tel)
    reports = []
    for model in (ref_model, port_model):
        snap = model.sample()
        snap["slo"] = slo_states
        snap["share_loss"] = share_loss
        reports.append(model.evaluate(snap, now=100.0))
    for component in ("slo", "share_loss"):
        got = [r.get(component) for r in reports]
        assert (got[0] is None) == (got[1] is None), component
        if got[0] is not None:
            assert (got[0].state, got[0].reason) == (got[1].state,
                                                     got[1].reason)
    assert port_model.healthz(reports[1])[0] == 200  # burn never stalls


def test_health_sample_ticks_the_engine_and_feeds_share_loss():
    """With an engine the watchdog's sample evaluates it and derives the
    lost-share burst from the engine's store, as the reference's does."""
    now = [0.0]
    models = []
    for slo, pipeline, health, extra in (
            (ref_slo, ref_pipeline, ref_health,
             {"relay_probe": lambda: False}),
            (port_slo, port_pipeline, port_health, {})):
        tel = pipeline.PipelineTelemetry()
        engine = slo.SloEngine(tel, fast_window_s=4.0, slow_window_s=24.0,
                               clock=lambda: now[0])
        models.append(health.HealthModel(tel, slo=engine,
                                         clock=lambda: now[0], **extra))
    seen = set()
    for t in range(16):
        now[0] = float(t)
        for m in models:
            if 8 <= t < 12:
                m.telemetry.share_lost.inc(2)
        snaps = [m.sample() for m in models]
        assert snaps[0]["slo"] == snaps[1]["slo"]
        assert snaps[0]["share_loss"] == snaps[1]["share_loss"]
        reports = [m.evaluate(s, now=now[0]) for m, s in zip(models, snaps)]
        got = [(r["share_loss"].state, r["share_loss"].reason)
               if "share_loss" in r else None for r in reports]
        assert got[0] == got[1]
        seen.add(got[1][0] if got[1] else None)
    assert {"ok", "degraded"} <= seen
    assert any(e["kind"] == "slo"
               for e in models[1].telemetry.flightrec.snapshot())


# -------------------------------------------------------------- incidents
def _breach_report():
    (ref, port), now, _ = _engines(fast_window_s=4.0, slow_window_s=12.0,
                                   min_events=3)
    for i, snap in enumerate(_snapshots()):
        now[0] = float(i)
        report = port.evaluate(snap)
        if (report["worst"] or {}).get("state") == "breach":
            return port, report
    raise AssertionError("the snapshots never breach")


def test_incident_bundle_matches_the_reference_layout(tmp_path):
    """A capture of each package over the same breach: the same manifest
    keys and artifact names, a clean manifest, and a keyed row in the
    ledger inside the bundle root; a second capture within the interval
    is suppressed."""
    engine, report = _breach_report()
    stats = MinerStats(hashes=1 << 20)
    manifests = []
    for name, slo, pipeline, extra in (
            ("ref", ref_slo, ref_pipeline, {}),
            ("port", port_slo, port_pipeline, {"slo": engine})):
        tel = pipeline.PipelineTelemetry()
        tel.enable_tracing()
        with tel.span("x"):
            pass
        capture = slo.IncidentCapture(tel, str(tmp_path / name), **extra,
                                      stats=stats if name == "port" else None)
        if name == "ref":
            capture.slo = ref_slo.SloEngine(tel)
        path = capture.capture("slo-breach", slo_report=report)
        assert capture.capture("slo-breach") is None
        assert capture.suppressed == 1 and capture.captured == 1
        manifest = json.loads(open(path).read())
        manifests.append(manifest)
        ledger = tmp_path / name / "incident_ledger.jsonl"
        assert manifest["ledger"] == str(ledger)
        rows = [json.loads(x) for x in ledger.read_text().splitlines()]
        assert [r["id"] for r in rows] == [manifest["ledger_id"]]
        assert rows[0]["metric"] == "incident" and rows[0]["objective"] \
            == report["worst"]["name"]
        assert {k: c.value for k, c in tel.incidents.children()} == {
            (report["worst"]["name"],): 1.0}
    ref_m, port_m = manifests
    assert sorted(ref_m) == sorted(port_m)
    assert sorted(ref_m["artifacts"]) == sorted(port_m["artifacts"])
    assert port_m["schema"] == "tpu-miner-incident/1"
    assert port_m["errors"] == []
    series = json.loads(open(port_m["artifacts"]["series"]).read())
    assert series == engine.series_history()
    metrics = open(port_m["artifacts"]["metrics"]).read()
    assert metrics.startswith("# HELP tpu_miner_hashes_total")
    port_perfledger.load_rows(port_m["ledger"])


def test_incident_capture_never_raises(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    capture = port_slo.IncidentCapture(port_pipeline.PipelineTelemetry(),
                                       str(blocker / "under"))
    assert capture.capture("manual") is None and capture.captured == 0


# -------------------------------------------------------------------- cli
def _run_main(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("argv", [
    [], ["--objectives", "GOOD"], ["--objectives", "BAD"],
    ["--from", "REPORT"], ["--from", "REPORT", "--json"],
    ["--from", "OK"], ["--from", "MISSING"]])
def test_slo_command_renders_like_the_reference(argv, tmp_path, capsys):
    _, report = _breach_report()
    files = {"GOOD": WORK_FLOOR, "BAD": BAD_OBJECTIVES[8],
             "REPORT": report, "OK": port_slo.SloEngine().report_dict()}
    argv = [a if a not in files and a != "MISSING"
            else str(tmp_path / a) for a in argv]
    for name, payload in files.items():
        (tmp_path / name).write_text(json.dumps(payload))
    ref = _run_main(ref_slo.main, argv, capsys)
    port = _run_main(cli.main, ["slo", *argv], capsys)
    if not argv:  # the table: the frontend-validate line's text differs
        ref = (ref[0], [x for x in ref[1].splitlines()
                        if "frontend-validate" not in x], ref[2])
        port = (port[0], [x for x in port[1].splitlines()
                          if "frontend-validate" not in x], port[2])
    assert ref == port
    if "REPORT" in "".join(argv) or "BAD" in "".join(argv):
        assert port[0] in (1, 2)


def test_slo_status_url_reads_the_live_report(capsys):
    engine, report = _breach_report()
    server = port_status.StatusServer(MinerStats(), 0, slo=engine)
    stop = port_status.serve_status_in_thread(server)
    try:
        url = f"http://127.0.0.1:{server.port}"
        rc, out, _ = _run_main(cli.main, ["slo", "--status-url", url],
                               capsys)
        assert rc == 1 and "[   breach]" in out
        rc, out, _ = _run_main(ref_slo.main, ["--status-url", url], capsys)
        assert rc == 1
    finally:
        stop()
    rc, _, err = _run_main(cli.main, ["slo", "--status-url", url], capsys)
    assert rc == 2 and "cannot fetch /slo" in err


def test_make_health_refuses_bad_objectives_and_windows(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(BAD_OBJECTIVES[4]))
    base = ["--pool", "stratum+tcp://127.0.0.1:1", "--health-interval", "0",
            "--incident-dir", str(tmp_path / "inc")]
    tel = port_pipeline.PipelineTelemetry()
    for extra, message in ((["--slo-objectives", str(bad)],
                            "bad --slo-objectives file: "),
                           (["--slo-fast-window", "10", "--slo-slow-window",
                             "5"], "--slo-slow-window >= it")):
        args = cli.build_parser().parse_args(base + extra)
        with pytest.raises(SystemExit, match=message):
            cli.make_health(args, tel, MinerStats())
    good = tmp_path / "good.json"
    good.write_text(json.dumps(WORK_FLOOR))
    args = cli.build_parser().parse_args(
        base + ["--slo-objectives", str(good), "--slo-fast-window", "4",
                "--slo-slow-window", "12"])
    model, watchdog, slo = cli.make_health(args, tel, MinerStats())
    assert watchdog is None and model.slo is slo
    assert [o.name for o in slo.objectives] == ["claimed", "accept", "rtt"]
    assert (slo.fast_window_s, slo.slow_window_s) == (4.0, 12.0)
    assert slo.store.interval_s == 0.5 and slo.store.retention_s == 900.0
    assert slo.on_breach is not None
    os.makedirs(tmp_path / "inc", exist_ok=True)
    args = cli.build_parser().parse_args(
        base[:4] + ["--incident-dir", ""])
    _, _, slo = cli.make_health(args, tel, MinerStats())
    assert slo.on_breach is None
