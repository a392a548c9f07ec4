"""The PyTorch package's telemetry core against the JAX package's: the
metric registry's exposition text and snapshot, the tracer's events and
trace merge, the flight recorder's dumps, the share-lifecycle ledger, the
share accountant, the health model's verdicts, the busy clock and the
scheduler's telemetry, on the same seeded inputs (numpy) and at exact
equality; then the port's own instrumentation of the dispatch ring, the
fan-out and the mesh-native ring on the CPU."""

import json
import signal
import sys
import threading

import numpy as np
import pytest
import torch

from bitcoin_miner_tpu.miner import dispatcher as ref_dispatcher
from bitcoin_miner_tpu.miner import scheduler as ref_scheduler
from bitcoin_miner_tpu.telemetry import flightrec as ref_flightrec
from bitcoin_miner_tpu.telemetry import health as ref_health
from bitcoin_miner_tpu.telemetry import lifecycle as ref_lifecycle
from bitcoin_miner_tpu.telemetry import metrics as ref_metrics
from bitcoin_miner_tpu.telemetry import pipeline as ref_pipeline
from bitcoin_miner_tpu.telemetry import shareacct as ref_shareacct
from bitcoin_miner_tpu.telemetry import tracing as ref_tracing
from bitcoin_miner_tpu_torch.backends.base import (
    STREAM_FLUSH,
    ScanRequest,
    get_hasher,
    iter_scan_stream,
)
from bitcoin_miner_tpu_torch.backends.cuda import CudaHasher, TileCudaHasher
from bitcoin_miner_tpu_torch.core.header import GENESIS_HEADER_HEX
from bitcoin_miner_tpu_torch.core.target import difficulty_to_target
from bitcoin_miner_tpu_torch.miner import dispatcher as port_dispatcher
from bitcoin_miner_tpu_torch.miner import scheduler as port_scheduler
from bitcoin_miner_tpu_torch.parallel.fanout import FanoutHasher
from bitcoin_miner_tpu_torch.parallel.meshring import MeshCudaHasher
from bitcoin_miner_tpu_torch.telemetry import flightrec as port_flightrec
from bitcoin_miner_tpu_torch.telemetry import health as port_health
from bitcoin_miner_tpu_torch.telemetry import lifecycle as port_lifecycle
from bitcoin_miner_tpu_torch.telemetry import metrics as port_metrics
from bitcoin_miner_tpu_torch.telemetry import pipeline as port_pipeline
from bitcoin_miner_tpu_torch.telemetry import shareacct as port_shareacct
from bitcoin_miner_tpu_torch.telemetry import tracing as port_tracing
from tests.test_telemetry import parse_prometheus, validate_chrome_trace


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SEEDS = [0, 1, 2, 3, 4, 5]
HEADER = bytes.fromhex(GENESIS_HEADER_HEX)[:76]
EASY = difficulty_to_target(1 / (1 << 24))  # ~1 hit per 256 nonces
#: label values, one with every character the exposition escapes.
LABELS = ["hit", "miss", 'a"b', "back\\slash", "new\nline", "0"]


class FakeClock:
    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


# ------------------------------------------------------------------ registry
def _registry_ops(seed):
    """A seeded sequence of family declarations and metric operations."""
    rng = np.random.default_rng(seed)
    bounds = sorted(set(float(b) for b in rng.uniform(0, 5, 6).round(3)))
    decl = [
        ("counter", "tm_plain_total", (), None),
        ("counter", "tm_labeled", ("result",), None),
        ("gauge", "tm_gauge", (), None),
        ("gauge", "tm_gauge_labeled", ("chip",), None),
        ("histogram", "tm_hist_seconds", (), None),
        ("histogram", "tm_hist_labeled", ("stage",), tuple(bounds)),
    ]
    ops = []
    for _ in range(300):
        kind, name, labelnames, _b = decl[int(rng.integers(len(decl)))]
        label = LABELS[int(rng.integers(len(LABELS)))] if labelnames else None
        if kind == "counter":
            amount = (float(rng.integers(0, 5)) if rng.random() < 0.5
                      else float(rng.uniform(0, 3)))
            ops.append((name, label, "inc", amount))
        elif kind == "gauge":
            op = ["set", "inc", "dec"][int(rng.integers(3))]
            ops.append((name, label, op, float(rng.normal(0, 10))))
        else:
            if rng.random() < 0.2:  # exactly on a bucket bound
                pick = bounds if labelnames else list(
                    ref_metrics.DEFAULT_LATENCY_BUCKETS)
                value = pick[int(rng.integers(len(pick)))]
            else:
                value = float(rng.lognormal(-5, 3))
            ops.append((name, label, "observe", value))
    return decl, ops


def _apply_registry(module, decl, ops):
    reg = module.MetricRegistry()
    fams = {}
    for kind, name, labelnames, bounds in decl:
        kw = {"buckets": bounds} if bounds else {}
        fams[name] = getattr(reg, kind)(name, f"help {name}",
                                        labelnames=labelnames, **kw)
        if name.endswith("_total"):
            fams[name[:-len("_total")]] = fams[name]
    for name, label, op, value in ops:
        fam = fams[name]
        target = fam.labels(label) if label is not None else fam
        getattr(target, op)(value)
    return reg


@pytest.mark.parametrize("seed", SEEDS)
def test_registry_exposition_and_snapshot_match_reference(seed):
    decl, ops = _registry_ops(seed)
    ref = _apply_registry(ref_metrics, decl, ops)
    port = _apply_registry(port_metrics, decl, ops)
    assert port.render() == ref.render()
    assert (json.dumps(port.snapshot(), sort_keys=True)
            == json.dumps(ref.snapshot(), sort_keys=True))
    parse_prometheus(port.render())


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 0.99, 1.0])
def test_histogram_quantiles_match_reference(q):
    rng = np.random.default_rng(7)
    values = rng.lognormal(-6, 2, 500)
    hists = []
    for module in (ref_metrics, port_metrics):
        h = module.MetricRegistry().histogram("tm_q_seconds")
        for v in values:
            h.observe(float(v))
        hists.append(h)
    assert hists[1].quantile(q) == hists[0].quantile(q)
    assert (hists[1].count, hists[1].sum, hists[1].min, hists[1].max) == (
        hists[0].count, hists[0].sum, hists[0].min, hists[0].max)


@pytest.mark.parametrize("bad", [
    ("counter", "1bad", ()), ("gauge", "ok", ("__reserved",)),
    ("histogram", "ok", ("le",))])
def test_registry_refuses_what_the_reference_refuses(bad):
    kind, name, labels = bad
    for module in (ref_metrics, port_metrics):
        with pytest.raises(ValueError):
            getattr(module.MetricRegistry(), kind)(name, labelnames=labels)


def test_registry_refuses_a_changed_geometry():
    reg = port_metrics.MetricRegistry()
    reg.histogram("tm_h", buckets=(1.0, 2.0))
    with pytest.raises(ValueError):
        reg.histogram("tm_h", buckets=(1.0, 3.0))
    with pytest.raises(ValueError):
        reg.gauge("tm_h")


# ------------------------------------------------------------ pipeline bundle
def test_bundle_families_are_the_references():
    """The port registers every family of the reference's bundle and no
    other, each with the reference's name, kind, help, label names and
    buckets, so its exposition lines are the reference's too."""
    ref = ref_pipeline.PipelineTelemetry()
    port = port_pipeline.PipelineTelemetry()
    ref_fams = {f.name: f for f in ref.registry.families()}
    port_fams = port.registry.families()
    assert len(port_fams) == len(port_pipeline.BUNDLE_METRICS)
    assert sorted(f.name for f in port_fams) == sorted(ref_fams)
    for fam in port_fams:
        other = ref_fams[fam.name]
        assert (fam.kind, fam.help, fam.labelnames, fam._child_kwargs) == (
            other.kind, other.help, other.labelnames, other._child_kwargs)
        assert fam.render() == other.render()
    for attr in port_pipeline.BUNDLE_METRICS:
        assert getattr(port, attr).name == getattr(ref, attr).name
    for const in dir(port_pipeline):
        if const.startswith("METRIC_"):
            assert getattr(port_pipeline, const) == getattr(ref_pipeline,
                                                            const)


def test_null_telemetry_is_inert():
    tel = port_pipeline.NullTelemetry()
    for attr in port_pipeline.BUNDLE_METRICS:
        metric = getattr(tel, attr)
        metric.labels(x="y").inc()
        metric.observe(1.0)
        metric.set(3)
        assert metric.value == 0.0 and metric.count == 0
    tel.flightrec.record("x", a=1)
    tel.lifecycle.hop("k", "hit")
    tel.enable_tracing("/nonexistent/path.json")
    assert tel.registry.render() == ""
    assert tel.dump_trace() is None
    assert tel.flightrec.dump_dict()["events"] == []
    assert tel.lifecycle.dump_dict()["records"] == []


@pytest.mark.parametrize("value,disabled", [
    ("0", True), ("off", True), ("false", True), ("no", True),
    ("1", False), ("", False)])
def test_environment_switch_matches_reference(monkeypatch, value, disabled):
    monkeypatch.setenv("TPU_MINER_TELEMETRY", value)
    assert port_pipeline.telemetry_disabled_by_env() is disabled
    assert ref_pipeline.telemetry_disabled_by_env() is disabled
    previous = port_pipeline.set_telemetry(None)
    try:
        tel = port_pipeline.get_telemetry()
        assert isinstance(tel, port_pipeline.NullTelemetry) is disabled
        assert port_pipeline.get_telemetry() is tel
    finally:
        port_pipeline.set_telemetry(previous)


def test_telemetry_bound_resolves_the_default_when_read():
    class Bound(port_pipeline.TelemetryBound):
        pass

    obj = Bound()
    previous = port_pipeline.get_telemetry()
    swapped = port_pipeline.PipelineTelemetry()
    port_pipeline.set_telemetry(swapped)
    try:
        assert obj.telemetry is swapped
        own = port_pipeline.PipelineTelemetry()
        obj.telemetry = own
        assert obj.telemetry is own
    finally:
        port_pipeline.set_telemetry(previous)


# -------------------------------------------------------------------- tracer
def _trace_ops(tracer, seed):
    rng = np.random.default_rng(seed)
    t0 = tracer.now_ns()
    for i in range(40):
        which = int(rng.integers(4))
        if which == 0:
            start = t0 + int(rng.integers(0, 10**6))
            tracer.complete("device_dispatch", start,
                            start + int(rng.integers(0, 10**6)),
                            cat="device", nonce_start=i, count=1 << 24)
        elif which == 1:
            tracer.instant("pool_ack", cat="share", result="accepted")
        elif which == 2:
            with tracer.span("cpu_verify", cat="share", nonce=f"{i:#010x}"):
                pass
        else:
            with tracer.context(f"remote{i % 3}"):
                tracer.instant("job_notify", cat="job", job_id=str(i))


def _shape(events, trace_id):
    """Events without their clocks and thread ids; the tracer's own id
    as "self"."""
    out = []
    for e in events:
        e = {k: v for k, v in e.items() if k not in ("ts", "dur", "pid",
                                                     "tid")}
        if e.get("ph") == "M":
            e["args"] = {}
        elif "args" in e and e["args"].get("trace") == trace_id:
            e["args"] = dict(e["args"], trace="self")
        out.append(e)
    return out


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_tracer_events_match_reference(seed):
    ref = ref_tracing.Tracer(enabled=True)
    port = port_tracing.Tracer(enabled=True)
    _trace_ops(ref, seed)
    _trace_ops(port, seed)
    assert _shape(port.events(), port.trace_id) == _shape(ref.events(),
                                                          ref.trace_id)
    validate_chrome_trace(port.trace_dict())


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_tracer_drain_matches_reference(seed):
    """``drain`` (what ``CollectTrace`` serves): the buffer so far, its
    dropped count, then an empty buffer whose next events start afresh
    (thread metadata again), as the reference's does."""
    drained = []
    for module in (ref_tracing, port_tracing):
        t = module.Tracer(enabled=True, max_events=30)
        _trace_ops(t, seed)
        first = t.drain()
        empty = t.drain()
        t.instant("after", cat="job")
        second = t.drain()
        drained.append([
            (_shape(d["traceEvents"], t.trace_id),
             {k: v for k, v in d["otherData"].items()
              if k not in ("trace_id", "epoch_unix_s", "pid")})
            for d in (first, empty, second)])
        assert t.events() == [] and t.dropped_events == 0
    assert drained[1] == drained[0]
    assert drained[1][0][1]["dropped_events"] > 0


def test_tracer_bound_and_disabled_match_reference():
    for module in (ref_tracing, port_tracing):
        t = module.Tracer(enabled=True, max_events=5)
        for _ in range(10):
            t.instant("x")
        assert len(t.events()) == 5 and t.dropped_events == 6
        off = module.Tracer(enabled=False)
        with off.span("x"):
            off.instant("y")
        assert off.events() == []


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_merge_traces_matches_reference(seed):
    rng = np.random.default_rng(seed)

    def trace(pid, epoch):
        events = [{"name": f"e{i}", "ph": "X", "ts": float(rng.uniform(0, 1e6)),
                   "dur": 1.0, "pid": pid, "tid": 7, "args": {}}
                  for i in range(5)]
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"trace_id": f"t{pid}", "epoch_unix_s": epoch}}

    base = trace(100, 1000.0)
    remote = trace(100 if seed % 2 else 200, 1000.5 + seed)
    want = ref_tracing.merge_traces(json.loads(json.dumps(base)),
                                    json.loads(json.dumps(remote)), "w")
    got = port_tracing.merge_traces(json.loads(json.dumps(base)),
                                    json.loads(json.dumps(remote)), "w")
    assert got == want


def test_tracer_dump_is_chrome_trace(tmp_path):
    t = port_tracing.Tracer(enabled=True)
    ref = ref_tracing.Tracer(enabled=True)
    _trace_ops(t, 0)
    _trace_ops(ref, 0)
    path = tmp_path / "t.json"
    t.dump(str(path))
    obj = json.loads(path.read_text())
    validate_chrome_trace(obj)
    want = ref.trace_dict()
    assert obj["otherData"]["trace_id"] == t.trace_id
    assert set(obj["otherData"]) == set(want["otherData"])
    assert obj["displayTimeUnit"] == want["displayTimeUnit"]


# ------------------------------------------------------------ flight recorder
def _flightrec_ops(rec, seed):
    rng = np.random.default_rng(seed)
    kinds = ["job_switch", "share", "stale_drop", "sched_resize", "health"]
    for i in range(int(rng.integers(5, 40))):
        rec.record(kinds[int(rng.integers(len(kinds)))], n=i,
                   value=float(rng.normal()), label=str(rng.integers(9)))


def _normalized(dump):
    dump = dict(dump, dumped_at=0)
    dump["events"] = [{k: v for k, v in e.items()
                       if k not in ("ts", "mono", "thread")}
                      for e in dump["events"]]
    return dump


@pytest.mark.parametrize("seed", SEEDS)
def test_flightrec_dump_matches_reference(seed):
    ref = ref_flightrec.FlightRecorder(capacity=16)
    port = port_flightrec.FlightRecorder(capacity=16)
    _flightrec_ops(ref, seed)
    _flightrec_ops(port, seed)
    assert _normalized(port.dump_dict("request")) == _normalized(
        ref.dump_dict("request"))
    assert port.dropped == ref.dropped


def test_flightrec_crash_dump_matches_reference(tmp_path):
    dumps = []
    for module, name in ((ref_flightrec, "ref"), (port_flightrec, "port")):
        rec = module.FlightRecorder()
        rec.record("job_switch", job_id="j")
        rec._dump_path = str(tmp_path / f"{name}.json")
        rec._prev_threading_excepthook = None
        args = threading.ExceptHookArgs(
            (RuntimeError, RuntimeError("boom"), None,
             threading.current_thread()))
        rec._on_thread_crash(args)
        dumps.append(json.loads((tmp_path / f"{name}.json").read_text()))
    assert _normalized(dumps[1]) == _normalized(dumps[0])
    assert dumps[1]["reason"] == "crash"


def test_flightrec_disarm_restores_every_hook(tmp_path):
    """A process that runs several sessions arms and disarms in turn: the
    excepthooks and the SIGUSR2 handler come back as they were."""
    before = (sys.excepthook, threading.excepthook,
              signal.getsignal(signal.SIGUSR2))
    rec = port_flightrec.FlightRecorder()
    rec.arm(str(tmp_path / "fr.json"))
    try:
        assert sys.excepthook == rec._on_crash
        assert signal.getsignal(signal.SIGUSR2) == rec._on_signal
    finally:
        rec.disarm()
    assert (sys.excepthook, threading.excepthook,
            signal.getsignal(signal.SIGUSR2)) == before
    assert not (tmp_path / "fr.json").exists()


# ---------------------------------------------------------------- lifecycle
def _lifecycle_ops(module, ledger, clock, seed):
    rng = np.random.default_rng(seed)
    keys = []
    for i in range(60):
        clock.t += float(rng.uniform(0, 5))
        which = int(rng.integers(6))
        if which == 0:
            ledger.note_job(f"p{i % 2}/job{i % 3}", generation=i, clean=True)
        elif which in (1, 2):
            e2 = rng.integers(0, 256, 4, dtype=np.uint8).tobytes()
            nonce = (i << 10) + int(rng.integers(1 << 10))
            key = module.share_key(f"p0/job{i % 3}", e2, nonce)
            keys.append(key)
            ledger.found(key, job_id=f"job{i % 3}", nonce=nonce,
                         trace="t", generation=i)
        elif which == 3 and keys:
            ledger.hop(keys[int(rng.integers(len(keys)))], "submit",
                       result="accepted", rtt_s=0.01)
        elif which == 4:
            ledger.exemplar("tpu_miner_submit_rtt_seconds",
                            float(rng.uniform()), trace="t",
                            key=keys[-1] if keys else None)
        else:
            ledger.scan_losses()


def _lifecycle_normalized(dump):
    def strip(d):
        return {k: v for k, v in d.items()
                if k not in ("ts", "born_ts", "dumped_at")}

    dump = strip(dump)
    dump["records"] = [dict(strip(r), hops=[strip(h) for h in r["hops"]])
                       for r in dump["records"]]
    dump["exemplars"] = {m: [strip(e) for e in es]
                         for m, es in dump["exemplars"].items()}
    return dump


@pytest.mark.parametrize("seed", SEEDS)
def test_lifecycle_ledger_matches_reference(seed):
    dumps = []
    for module in (ref_lifecycle, port_lifecycle):
        clock = FakeClock()
        ledger = module.ShareLifecycleLedger(capacity=16, loss_deadline_s=20,
                                             clock=clock)
        _lifecycle_ops(module, ledger, clock, seed)
        lost = ledger.scan_losses(now=clock.t + 100)
        dumps.append((_lifecycle_normalized(ledger.dump_dict()),
                      [r["key"] for r in lost]))
    assert dumps[1] == dumps[0]


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_share_key_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        job = f"p{rng.integers(4)}/{rng.integers(10**6):x}"
        e2 = rng.integers(0, 256, int(rng.integers(0, 9)),
                          dtype=np.uint8).tobytes()
        nonce = int(rng.integers(0, 1 << 40))
        assert port_lifecycle.share_key(job, e2, nonce) == \
            ref_lifecycle.share_key(job, e2, nonce)


# --------------------------------------------------------- share accounting
class _Stats:
    def __init__(self):
        self.hashes = 0

    def device_hashrate(self):
        return self.hashes / 10.0


@pytest.mark.parametrize("seed", SEEDS)
def test_share_accountant_matches_reference(seed):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(80):
        which = int(rng.integers(3))
        if which == 0:
            ops.append(("hashes", int(rng.integers(0, 1 << 34))))
        elif which == 1:
            ops.append(("difficulty", [None, 0.0, 1 / 256, 1.0, 64.0][
                int(rng.integers(5))]))
        else:
            ops.append(("result", (["accepted"] * 3 + ["rejected", "stale",
                                                        "lost"])[
                int(rng.integers(6))], [None, 1 / 256, 1.0][
                int(rng.integers(3))]))
    out = []
    for pipeline, shareacct in ((ref_pipeline, ref_shareacct),
                                (port_pipeline, port_shareacct)):
        tel = pipeline.PipelineTelemetry()
        stats = _Stats()
        acct = shareacct.ShareAccountant(stats, telemetry=tel)
        readings = []
        for op in ops:
            if op[0] == "hashes":
                stats.hashes += op[1]
            elif op[0] == "difficulty":
                acct.set_difficulty(op[1])
            else:
                acct.on_result(op[1], op[2])
            readings.append((acct.snapshot(), acct.tick(),
                             tel.share_efficiency.value,
                             tel.share_expected.value))
        out.append(readings)
    assert out[1] == out[0]


# -------------------------------------------------------------------- health
def _health_snapshots(seed):
    rng = np.random.default_rng(seed)
    snap = {"batches": 0, "active_scans": 0, "gap_count": 0, "gap_sum": 0.0,
            "ring_occupancy": 0.0, "ring_collects": 0, "stream_window": 0.0,
            "rpc_responses": 0.0, "rpc_errors": 0.0,
            "submits_inflight": 0.0, "pool_acks": {}, "chips": {},
            "share_expected": 0.0, "share_efficiency": 0.0}
    now = 0.0
    out = []
    for _ in range(80):
        snap = json.loads(json.dumps(snap))
        now += float(rng.choice([0.5, 1.0, 3.0, 6.0, 12.0]))
        r = rng.random(12)
        if r[0] < 0.6:
            snap["batches"] += int(rng.integers(0, 3))
        snap["active_scans"] = int(rng.integers(0, 3))
        snap["ring_occupancy"] = float(rng.integers(0, 3))
        if r[1] < 0.6:
            snap["ring_collects"] += int(rng.integers(0, 3))
        if r[2] < 0.5:
            n = int(rng.integers(1, 4))
            snap["gap_count"] += n
            snap["gap_sum"] += float(rng.uniform(0, 3 * n))
        snap["stream_window"] = float(rng.integers(0, 2))
        if r[3] < 0.5:
            snap["rpc_responses"] += 1
        if r[4] < 0.2:
            snap["rpc_errors"] += 1
        snap["submits_inflight"] = float(rng.integers(0, 2))
        if r[5] < 0.5:
            result = ["accepted", "rejected", "stale"][int(rng.integers(3))]
            snap["pool_acks"][result] = snap["pool_acks"].get(result, 0) + 1
        for chip in ("0", "1"):
            if r[6] < 0.7:
                c = snap["chips"].setdefault(chip, {"inflight": 0.0,
                                                    "dispatches": 0.0})
                c["inflight"] = float(rng.integers(0, 2))
                if rng.random() < 0.5:
                    c["dispatches"] += 1
        snap["share_expected"] = float(rng.uniform(0, 40))
        snap["share_efficiency"] = float(rng.uniform(0, 1.5))
        out.append((now, snap))
    return out


def _no_relay():
    """The reference's relay probe, failing: its stalled-pool reason then
    carries no relay fragment, as the port's (no relay) never does."""
    raise OSError("no relay")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("stall_after_s", [10.0, 4.0])
def test_health_verdicts_match_reference(seed, stall_after_s):
    """The same synthetic snapshots under a fake clock give the same
    component verdicts, reasons, /healthz payloads, gauges and transition
    events."""
    results = []
    for pipeline, health, kw in (
            (ref_pipeline, ref_health, {"relay_probe": _no_relay}),
            (port_pipeline, port_health, {})):
        tel = pipeline.PipelineTelemetry()
        model = health.HealthModel(tel, stall_after_s=stall_after_s, **kw)
        trail = []
        for now, snap in _health_snapshots(seed):
            report = model.evaluate(snap, now=now)
            model.publish(report)
            trail.append(([(c.component, c.state, c.reason)
                           for c in report.values()],
                          model.healthz(report), model.summary()))
        gauges = {k[0]: c.value for k, c in tel.health.children()}
        events = _normalized(tel.flightrec.dump_dict())["events"]
        results.append((trail, gauges, events))
    assert results[1] == results[0]


def test_health_sample_matches_reference():
    """The live sample reads the same signals from the same metrics."""
    samples = []
    for pipeline, health, dispatcher, kw in (
            (ref_pipeline, ref_health, ref_dispatcher,
             {"relay_probe": _no_relay}),
            (port_pipeline, port_health, port_dispatcher, {})):
        tel = pipeline.PipelineTelemetry()
        stats = dispatcher.MinerStats(telemetry=tel)
        stats.batches = 7
        tel.dispatch_gap.observe(0.25)
        tel.ring_occupancy.inc(2)
        tel.ring_collect.observe(0.002)
        tel.rpc_errors.labels(kind="retry").inc()
        tel.submits_inflight.inc()
        tel.pool_acks.labels(result="accepted").inc(3)
        tel.chip_inflight.labels(chip="1").inc()
        tel.chip_dispatches.labels(chip="0").inc(4)
        tel.share_expected.set(12.5)
        tel.share_efficiency.set(0.9)
        model = health.HealthModel(tel, stats=stats, **kw)
        samples.append(model.sample())
    assert samples[1] == samples[0]


def test_pool_fabric_families_are_the_references():
    """The fabric's two families sit in the bundle where the reference
    registers them (just before the fleet's), with its slot levels, and
    the same operations render the same exposition lines."""
    assert port_pipeline.POOL_SLOT_LEVELS == ref_pipeline.POOL_SLOT_LEVELS
    names = port_pipeline.BUNDLE_METRICS
    i = names.index("pool_slot_state")
    assert names[i:i + 3] == ("pool_slot_state", "pool_failover",
                              "fleet_child_state")
    rendered = []
    for pipeline in (ref_pipeline, port_pipeline):
        tel = pipeline.PipelineTelemetry()
        for pool, state in (("a:1", "active"), ("b:2", "dead"),
                            ("a:1", "degraded")):
            tel.pool_slot_state.labels(pool=pool).set(
                pipeline.POOL_SLOT_LEVELS[state])
        for reason in ("disconnect", "stalled", "disconnect"):
            tel.pool_failover.labels(reason=reason).inc()
        rendered.append((tel.pool_slot_state.render(),
                         tel.pool_failover.render()))
    assert rendered[1] == rendered[0]
    assert 'tpu_miner_pool_failover_total{reason="disconnect"} 2' in \
        rendered[1][1]


def test_frontend_shard_family_is_the_references():
    """The sharded frontend's gauge sits in the bundle just after the
    fleet's, with the reference's levels, and the same operations render
    the same lines and the same health sample."""
    assert port_pipeline.FRONTEND_SHARD_LEVELS == \
        ref_pipeline.FRONTEND_SHARD_LEVELS
    names = port_pipeline.BUNDLE_METRICS
    i = names.index("fleet_reclaims")
    assert names[i + 1] == "frontend_shard_state"
    out = []
    for pipeline, health, kw in (
            (ref_pipeline, ref_health, {"relay_probe": _no_relay}),
            (port_pipeline, port_health, {})):
        tel = pipeline.PipelineTelemetry()
        for shard, state in (("0", "serving"), ("1", "down"),
                             ("1", "starting"), ("2", "degraded")):
            tel.frontend_shard_state.labels(shard=shard).set(
                pipeline.FRONTEND_SHARD_LEVELS[state])
        sample = health.HealthModel(tel, **kw).sample()
        out.append((tel.frontend_shard_state.render(),
                    sample["frontend_shards"]))
    assert out[1] == out[0]
    assert out[1][1] == {"0": 1.0, "1": 0.0, "2": 2.0}


def _pools_snapshot(slots):
    return {"batches": 0, "active_scans": 0, "gap_count": 0, "gap_sum": 0.0,
            "ring_occupancy": 0.0, "ring_collects": 0, "stream_window": 0.0,
            "rpc_responses": 0.0, "rpc_errors": 0.0,
            "submits_inflight": 0.0, "pool_acks": {}, "chips": {},
            "share_expected": 0.0, "share_efficiency": 0.0,
            "pool_slots": slots}


@pytest.mark.parametrize("slots,state", [
    ({}, None),
    ({"a:1": 2.0, "b:2": 2.0}, "ok"),
    ({"a:1": 0.0, "b:2": 1.0}, "ok"),
    ({"a:1": 2.0, "b:2": 3.0}, "degraded"),
    ({"a:1": 4.0, "b:2": 2.0, "c:3": 3.0}, "degraded"),
    ({"a:1": 4.0}, "stalled"),
    ({"a:1": 4.0, "b:2": 4.0}, "stalled"),
], ids=["no-fabric", "all-active", "connecting-syncing", "one-degraded",
        "dead-and-degraded", "one-dead", "all-dead"])
def test_pools_rule_matches_reference(slots, state):
    """The ``pools`` rule reads the same verdict and reason from the same
    slot gauges as the reference's; no slots is no component."""
    out = []
    for pipeline, health, kw in (
            (ref_pipeline, ref_health, {"relay_probe": _no_relay}),
            (port_pipeline, port_health, {})):
        model = health.HealthModel(pipeline.PipelineTelemetry(), **kw)
        report = model.evaluate(_pools_snapshot(slots), now=1.0)
        pools = report.get("pools")
        out.append(None if pools is None else (pools.state, pools.reason))
        model.publish(report)
        out.append(model.healthz(report))
    assert out[2:] == out[:2]
    assert (out[2] and out[2][0]) == state


def _frontend_snapshots(seed):
    """A seeded run of the pool frontend's two signals: the session
    gauge (0 at times) and verdict counters that grow, some windows with
    accepts, some invalid-only, some idle."""
    rng = np.random.default_rng(700 + seed)
    shares, out = {}, []
    for _ in range(40):
        kind = int(rng.integers(4))
        if kind == 0:
            shares["accepted"] = shares.get("accepted", 0.0) + 1
        if kind in (1, 2):
            label = ["low_difficulty", "stale", "duplicate", "malformed",
                     "bad_extranonce2", "version_bits"][int(rng.integers(6))]
            shares[label] = shares.get(label, 0.0) + float(rng.integers(1, 4))
        out.append(dict(_pools_snapshot({}),
                        frontend_sessions=float(rng.integers(0, 3)),
                        frontend_shares=dict(shares)))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_frontend_rule_matches_reference(seed):
    """The ``frontend`` rule reads the same verdicts and reasons from the
    same synthetic snapshots as the reference's, and no frontend signal
    is no component."""
    out = []
    for pipeline, health, kw in (
            (ref_pipeline, ref_health, {"relay_probe": _no_relay}),
            (port_pipeline, port_health, {})):
        model = health.HealthModel(pipeline.PipelineTelemetry(), **kw)
        trail = [("frontend" in model.evaluate(_pools_snapshot({}),
                                               now=0.0),)]
        for i, snap in enumerate(_frontend_snapshots(seed)):
            report = model.evaluate(snap, now=1.0 + i)
            fe = report.get("frontend")
            trail.append(None if fe is None else (fe.state, fe.reason))
            model.publish(report)
            trail.append(model.healthz(report))
        out.append(trail)
    assert out[1] == out[0]
    assert out[1][0] == (False,)
    states = {t[0] for t in out[1][1::2] if t}
    assert states == {"ok", "degraded"}


def test_health_sample_reads_the_frontend_families():
    samples = []
    for pipeline, health, kw in (
            (ref_pipeline, ref_health, {"relay_probe": _no_relay}),
            (port_pipeline, port_health, {})):
        tel = pipeline.PipelineTelemetry()
        tel.frontend_sessions.set(3)
        tel.frontend_shares.labels(result="accepted").inc(5)
        tel.frontend_shares.labels(result="stale").inc()
        sample = health.HealthModel(tel, **kw).sample()
        samples.append((sample["frontend_sessions"],
                        sample["frontend_shares"]))
    assert samples[1] == samples[0] == (3.0, {"accepted": 5.0, "stale": 1.0})


def test_health_sample_reads_the_pool_slot_gauges():
    samples = []
    for pipeline, health, kw in (
            (ref_pipeline, ref_health, {"relay_probe": _no_relay}),
            (port_pipeline, port_health, {})):
        tel = pipeline.PipelineTelemetry()
        tel.pool_slot_state.labels(pool="a:1").set(2.0)
        tel.pool_slot_state.labels(pool="b:2").set(4.0)
        samples.append(health.HealthModel(tel, **kw).sample()["pool_slots"])
    assert samples[1] == samples[0] == {"a:1": 2.0, "b:2": 4.0}


def test_health_watchdog_publishes_and_stops():
    tel = port_pipeline.PipelineTelemetry()
    model = port_health.HealthModel(tel)
    dog = port_health.HealthWatchdog(model, interval=0.05).start()
    try:
        assert model.driven
        for _ in range(200):
            if model.last_report:
                break
            threading.Event().wait(0.01)
        status, payload = model.healthz()
        assert status == 200 and payload["components"]["device"]["state"] \
            == "ok"
        assert {k[0] for k, _ in tel.health.children()} >= {
            "device", "ring", "rpc", "pool"}
    finally:
        dog.stop()
    assert not model.driven and dog._thread is None


# ---------------------------------------------------------------- busy clock
@pytest.mark.parametrize("seed", SEEDS)
def test_busy_clock_matches_reference(seed, monkeypatch):
    """scan_seconds, the gap series (listener and dispatch_gap) and, at
    idle points, device_hashrate under a fake clock."""
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    monkeypatch.setattr("time.monotonic", clock)
    ops = []
    active = 0
    for _ in range(200):
        dt = float(rng.exponential(0.01))
        if active and (rng.random() < 0.5 or active >= 4):
            ops.append((dt, "finish", int(rng.integers(1, 1 << 24))))
            active -= 1
        else:
            ops.append((dt, "start", 0))
            active += 1
    ops += [(0.001, "finish", 1)] * active
    out = []
    for pipeline, dispatcher in ((ref_pipeline, ref_dispatcher),
                                 (port_pipeline, port_dispatcher)):
        clock.t = 1000.0
        tel = pipeline.PipelineTelemetry()
        gaps = []
        stats = dispatcher.MinerStats(telemetry=tel, gap_listener=gaps.append)
        idle_rates = []
        for dt, op, hashes in ops:
            clock.t += dt
            if op == "start":
                stats.scan_started()
            else:
                stats.hashes += hashes
                stats.scan_finished()
                if stats._active_scans == 0:
                    idle_rates.append(stats.device_hashrate())
        out.append((stats.scan_seconds, gaps, idle_rates,
                    tel.dispatch_gap.snapshot()))
    assert out[1] == out[0]


def test_device_hashrate_counts_the_open_busy_interval(monkeypatch):
    """A pipeline that never runs dry has one busy interval, open for the
    whole session: the port's device rate counts it (the reference's
    reads 0 until the clock first goes idle)."""
    clock = FakeClock()
    monkeypatch.setattr("time.monotonic", clock)
    stats = port_dispatcher.MinerStats()
    stats.scan_started()
    clock.t += 2.0
    stats.hashes = 4_000_000
    assert stats.scan_seconds == 0.0
    assert stats.busy_seconds() == 2.0
    assert stats.device_hashrate() == 2_000_000.0
    stats.scan_finished()
    clock.t += 5.0
    assert stats.busy_seconds() == stats.scan_seconds == 2.0


# ----------------------------------------------------------------- scheduler
@pytest.mark.parametrize("seed", SEEDS)
def test_scheduler_telemetry_matches_reference(seed):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(120):
        which = int(rng.integers(4))
        if which == 0:
            ops.append(("result", int(rng.choice([1 << 20, 1 << 24]))))
        elif which == 1:
            ops.append(("gap", float(rng.choice([0.0001, 0.01, 1.5]))))
        elif which == 2:
            ops.append(("switch", 0))
        else:
            ops.append(("next", 0))
    out = []
    for pipeline, scheduler in ((ref_pipeline, ref_scheduler),
                                (port_pipeline, port_scheduler)):
        clock = FakeClock()
        tel = pipeline.PipelineTelemetry()
        sched = scheduler.AdaptiveBatchScheduler(
            granularity=1 << 16, telemetry=tel, clock=clock)
        counts = []
        for op, v in ops:
            clock.t += 0.05
            if op == "result":
                sched.record_result(v)
            elif op == "gap":
                sched.record_gap(v)
            elif op == "switch":
                sched.on_job_switch()
            else:
                counts.append(sched.next_count())
        out.append((counts, tel.batch_nonces.value,
                    {k[0]: c.value for k, c in tel.sched_resizes.children()},
                    _normalized(tel.flightrec.dump_dict())["events"]))
    assert out[1] == out[0]


# --------------------------------------------------------- the dispatch ring
def _requests(n, count=1 << 12, stride=1 << 12):
    return [ScanRequest(header76=HEADER, nonce_start=i * stride, count=count,
                        target=EASY, tag=i) for i in range(n)]


def _ring_telemetry(hasher, requests):
    tel = port_pipeline.PipelineTelemetry(
        tracer=port_tracing.Tracer(enabled=True))
    hasher.telemetry = tel
    results = list(iter_scan_stream(hasher, iter(requests)))
    return tel, results


@pytest.mark.parametrize("make", [
    lambda: TileCudaHasher(batch_size=1 << 12, device="cpu"),
    lambda: CudaHasher(batch_size=1 << 12, inner_size=1 << 10,
                       device="cpu")], ids=["cuda-tile", "cuda"])
def test_ring_metrics_and_spans_match_the_reference_ring(make):
    """The reference's TPU ring reports, for four one-dispatch requests of
    one job, 4 collects, 4 batches, one constants miss then 3 hits: so
    does each CUDA ring, with one device_dispatch and one ring_collect
    span per dispatch, each carrying its range."""
    tel, results = _ring_telemetry(make(), _requests(4))
    assert len(results) == 4
    assert tel.ring_collect.count == tel.scan_batch.count == 4
    assert tel.consts_cache.labels(result="miss").value == 1
    assert tel.consts_cache.labels(result="hit").value == 3
    assert tel.ring_occupancy.value == 0
    spans = [e for e in tel.tracer.events() if e["ph"] == "X"]
    for name in ("device_dispatch", "ring_collect"):
        mine = [e for e in spans if e["name"] == name]
        assert sorted(e["args"]["nonce_start"] for e in mine) == [
            i << 12 for i in range(4)]
        assert all(e["args"]["count"] == 1 << 12 and e["cat"] == "device"
                   and "chip" not in e["args"] for e in mine)
    validate_chrome_trace(tel.tracer.trace_dict())


def test_ring_counts_one_span_per_dispatch_of_a_long_request():
    tel, results = _ring_telemetry(
        TileCudaHasher(batch_size=1 << 11, device="cpu"),
        [ScanRequest(HEADER, 0, 5 << 11, EASY), STREAM_FLUSH,
         ScanRequest(HEADER, 5 << 11, 0, EASY)])
    assert [r.request.count for r in results] == [5 << 11, 0]
    names = [e["name"] for e in tel.tracer.events() if e["ph"] == "X"]
    assert names.count("device_dispatch") == names.count("ring_collect") == 5
    assert tel.ring_collect.count == 5


def test_abandoned_stream_gives_back_its_occupancy():
    hasher = TileCudaHasher(batch_size=1 << 12, device="cpu")
    tel = port_pipeline.PipelineTelemetry()
    hasher.telemetry = tel
    stream = hasher.scan_stream(iter(_requests(6)))
    next(stream)  # the ring holds 2 more dispatches
    assert tel.ring_occupancy.value == 2
    stream.close()
    assert tel.ring_occupancy.value == 0
    assert hasher.dispatches_abandoned == 2
    assert tel.ring_collect.count == 1


def test_null_telemetry_ring_records_nothing():
    hasher = TileCudaHasher(batch_size=1 << 12, device="cpu")
    hasher.telemetry = port_pipeline.NullTelemetry()
    results = list(iter_scan_stream(hasher, iter(_requests(3))))
    assert len(results) == 3 and hasher.dispatches_abandoned == 0


# ------------------------------------------------------------------- fan-out
def _fanout(n=2):
    children = []
    for i in range(n):
        child = TileCudaHasher(batch_size=1 << 11, device="cpu")
        child.chip_label = f"c{i}"
        children.append(child)
    return FanoutHasher(children)


def test_fanout_counts_per_card_and_inherits_the_trace():
    fan = _fanout()
    tel = port_pipeline.PipelineTelemetry(
        tracer=port_tracing.Tracer(enabled=True))
    port_pipeline.set_telemetry(tel)
    try:
        with tel.tracer.context("caller-trace"):
            results = list(fan.scan_stream(iter(_requests(6, 1 << 11,
                                                          1 << 11))))
    finally:
        port_pipeline.set_telemetry(None)
    assert [r.request.tag for r in results] == list(range(6))
    assert {k[0]: c.value for k, c in tel.chip_dispatches.children()} == {
        "c0": 3, "c1": 3}
    assert {k[0]: c.value for k, c in tel.chip_inflight.children()} == {
        "c0": 0, "c1": 0}
    spans = [e for e in tel.tracer.events() if e.get("name") ==
             "device_dispatch"]
    assert len(spans) == 6
    assert {e["args"]["chip"] for e in spans} == {"c0", "c1"}
    assert {e["args"]["trace"] for e in spans} == {"caller-trace"}
    # The pumps' spans lie on their own threads.
    assert len({e["tid"] for e in spans}) == 2


def test_fanout_child_error_is_recorded_and_gives_back_inflight():
    class Broken:
        chip_label = "bad"

        def scan(self, *a, **k):
            raise RuntimeError("chip wedged")

    fan = FanoutHasher([get_hasher("cpu"), Broken()])
    tel = port_pipeline.PipelineTelemetry()
    fan.telemetry = tel
    with pytest.raises(RuntimeError, match="chip wedged"):
        list(iter_scan_stream(fan, iter(_requests(4, 256, 256))))
    events = tel.flightrec.snapshot()
    assert [e["chip"] for e in events if e["kind"] == "chip_error"] == [
        "bad"]
    assert all(c.value == 0 for _, c in tel.chip_inflight.children())
    with pytest.raises(RuntimeError):
        fan.scan(HEADER, 0, 512, EASY)
    assert len([e for e in tel.flightrec.snapshot()
                if e["kind"] == "chip_error"]) == 2


# --------------------------------------------------------- mesh-native ring
def test_mesh_native_counts_shards_and_ladder_steps():
    tel = port_pipeline.PipelineTelemetry()
    port_pipeline.set_telemetry(tel)
    try:
        h = MeshCudaHasher(devices=["cpu"] * 2, kernel="cuda-tile",
                           batch_per_device=1 << 10, sublanes=8,
                           inner_tiles=1)
        assert tel.mesh_devices.value == 2
        results = list(iter_scan_stream(h, iter(_requests(3, 1 << 11,
                                                          1 << 11))))
        assert len(results) == 3
        assert {k[0]: c.value for k, c in tel.chip_dispatches.children()} \
            == {"0": 3, "1": 3}
        h.quarantine_device("1")
        assert tel.mesh_devices.value == 1
        h.rebuild()
        h.restore_device("1")
        assert tel.mesh_devices.value == 2
        assert {k[0]: c.value for k, c in tel.mesh_rebuilds.children()} == {
            "quarantine": 1, "rebuild": 1, "restore": 1}
    finally:
        port_pipeline.set_telemetry(None)
