"""The PyTorch package's time-series store, exposition reader, scrape
federator, registry sampler and observatory against the JAX package's
``telemetry/tsdb.py``: the same seeded ingests (numpy, a fixed seed) give
the same ``/query`` payloads, rates, windowed increases, staleness and
downsampled points; the same ``/metrics`` text gives the same
``parse_exposition`` output; the same bad payloads give the same
``QueryError``s. Times are a fake clock; the wall clock the store stamps
staleness with is patched where staleness is compared."""

import json
import threading
import time

import numpy as np
import pytest

from bitcoin_miner_tpu.telemetry import pipeline as ref_pipeline
from bitcoin_miner_tpu.telemetry import tsdb as ref_tsdb
from bitcoin_miner_tpu_torch.miner.dispatcher import MinerStats
from bitcoin_miner_tpu_torch.telemetry import pipeline as port_pipeline
from bitcoin_miner_tpu_torch.telemetry import tsdb as port_tsdb
from bitcoin_miner_tpu_torch.utils import status as port_status

SEED = 20261017
NAMES = ("tpu_miner_hashes_total", "tpu_miner_pool_acks_total",
         "tpu_miner_ring_occupancy")
KINDS = {"tpu_miner_hashes_total": "counter",
         "tpu_miner_pool_acks_total": "counter",
         "tpu_miner_ring_occupancy": "gauge"}


def _ingests(n: int = 400):
    """A seeded ingest stream: (name, value, t, labels, kind) with
    counter resets, NaNs, ingests closer than half an interval, a series
    that appears mid-stream and one that is only ingested early."""
    rng = np.random.default_rng(SEED)
    out = []
    totals = {}
    t = 1000.0
    for i in range(n):
        t += float(rng.choice([0.2, 0.5, 1.0, 1.0, 2.5]))
        name = NAMES[int(rng.integers(len(NAMES)))]
        labels = {"process": "parent"}
        if name == "tpu_miner_pool_acks_total":
            labels["result"] = str(rng.choice(["accepted", "rejected"]))
        if i > n // 2 and rng.random() < 0.2:
            labels["process"] = "worker-1"
        kind = KINDS[name]
        key = (name, tuple(sorted(labels.items())))
        if kind == "counter":
            if rng.random() < 0.03:
                totals[key] = 0.0  # a process restart: the counter resets
            totals[key] = totals.get(key, 0.0) + float(rng.integers(0, 50))
            value = totals[key]
        else:
            value = float(rng.normal(2.0, 1.0))
        if rng.random() < 0.02:
            value = float("nan")
        out.append((name, value, t, labels, kind))
    return out


def _stores(**kw):
    kw.setdefault("interval_s", 1.0)
    kw.setdefault("retention_s", 60.0)
    kw.setdefault("coarse_interval_s", 10.0)
    kw.setdefault("coarse_retention_s", 200.0)
    return ref_tsdb.TimeSeriesStore(**kw), port_tsdb.TimeSeriesStore(**kw)


def _feed(stores, ingests):
    for name, value, t, labels, kind in ingests:
        got = [s.ingest(name, value, t=t, labels=labels, kind=kind)
               for s in stores]
        assert got[0] == got[1]


@pytest.fixture
def wall(monkeypatch):
    """A fake wall clock for both modules' staleness stamps."""
    now = [5.0e8]
    monkeypatch.setattr(time, "time", lambda: now[0])
    return now


def test_same_ingests_give_the_same_queries(wall):
    ingests = _ingests()
    stores = _stores(max_series=64)
    _feed(stores, ingests)
    end = ingests[-1][2]
    for kw in ({}, {"window_s": 30.0}, {"tier": "coarse"},
               {"name": "tpu_miner_pool_acks_total"},
               {"prefix": "tpu_miner_r"},
               {"labels": {"process": "worker-1"}},
               {"labels": {"result": "accepted"}, "window_s": 120.0},
               {"tier": "coarse", "window_s": 100.0}):
        ref, port = (s.query(now=end, **kw) for s in stores)
        assert ref == port, kw
        assert port_tsdb.parse_query_payload(port) is port
    assert stores[1].series_count() == stores[0].series_count() > 3


def test_rates_increases_and_reference_lookups_match():
    ingests = _ingests()
    stores = _stores()
    _feed(stores, ingests)
    end = ingests[-1][2]
    keys = sorted({(n, tuple(sorted(lab.items())))
                   for n, _, _, lab, _ in ingests})
    for name, labels in keys:
        labels = dict(labels)
        for window in (1.0, 5.0, 17.5, 59.0):
            for probe in (end, end - 3.3, end - 40.0):
                calls = (
                    ("rate", (name, labels, window, probe)),
                    ("windowed_increase",
                     (name, labels, probe - window, probe)),
                    ("oldest_point_time",
                     (name, labels, probe - window, probe)),
                    ("value_at", (name, labels, probe)),
                )
                for method, args in calls:
                    ref, port = (getattr(s, method)(*args) for s in stores)
                    assert ref == port, (method, args)
        assert stores[0].latest(name, labels) == \
            stores[1].latest(name, labels)


def test_counter_resets_count_from_the_post_reset_value():
    stores = _stores()
    points = [(0.0, 5.0), (1.0, 9.0), (2.0, 3.0), (3.0, 10.0)]
    for s in stores:
        for t, v in points:
            s.ingest("c_total", v, t=t, kind="counter")
    for s in stores:
        # 9-5 = 4, reset: +3, then +7.
        assert s.windowed_increase("c_total", None, 0.0, 3.0) == (14.0, 3)
        assert s.rate("c_total", None, 3.0, 3.0) == pytest.approx(14 / 3)


def test_staleness_follows_the_wall_clock(wall):
    stores = _stores(stale_after_s=15.0)
    for s in stores:
        s.ingest("g", 1.0, t=1.0, labels={"process": "p"})
    assert [s.is_stale("g", {"process": "p"}) for s in stores] == [False] * 2
    assert [s.is_stale("nope") for s in stores] == [True] * 2
    wall[0] += 20.0
    assert [s.is_stale("g", {"process": "p"}) for s in stores] == [True] * 2
    ref, port = (s.query(now=2.0) for s in stores)
    assert ref == port and port["series"][0]["stale"] is True


def test_downsampling_keeps_counter_last_and_gauge_mean(wall):
    stores = _stores()
    for s in stores:
        for i in range(35):
            s.ingest("g", float(i), t=float(i))
            s.ingest("c_total", float(i * 2), t=float(i), kind="counter")
    ref, port = (s.query(tier="coarse", now=40.0) for s in stores)
    assert ref == port
    by_name = {x["name"]: x["points"] for x in port["series"]}
    assert by_name["g"] == [[10.0, 4.5], [20.0, 14.5], [30.0, 24.5]]
    assert by_name["c_total"] == [[10.0, 18.0], [20.0, 38.0], [30.0, 58.0]]


def test_max_series_drops_and_counts_the_same(wall):
    stores = _stores(max_series=3)
    _feed(stores, _ingests(120))
    assert stores[0].dropped_series == stores[1].dropped_series > 0
    assert stores[0].query(now=2000.0) == stores[1].query(now=2000.0)


def test_recording_rules_write_the_same_derived_series(wall):
    stores = _stores()
    rule_kw = dict(record="tpu_miner_pool_acks_per_s",
                   source="tpu_miner_pool_acks_total", window_s=10.0)
    stores[0].add_rule(ref_tsdb.RecordingRule(**rule_kw))
    stores[1].add_rule(port_tsdb.RecordingRule(**rule_kw))
    ingests = _ingests()
    for start in range(0, len(ingests), 40):
        _feed(stores, ingests[start:start + 40])
        now = ingests[min(start + 39, len(ingests) - 1)][2]
        assert stores[0].evaluate_rules(now) == stores[1].evaluate_rules(now)
    ref, port = (s.query(name="tpu_miner_pool_acks_per_s", now=now)
                 for s in stores)
    assert ref == port and port["series"]


def test_the_store_refuses_the_same_geometries():
    for kw in ({"interval_s": 0}, {"interval_s": 5, "retention_s": 5},
               {"coarse_interval_s": 0}):
        with pytest.raises(ValueError) as ref:
            ref_tsdb.TimeSeriesStore(**kw)
        with pytest.raises(ValueError) as port:
            port_tsdb.TimeSeriesStore(**kw)
        assert str(ref.value) == str(port.value)
    for mod in (ref_tsdb, port_tsdb):
        with pytest.raises(ValueError, match="unknown series kind"):
            mod.TimeSeriesStore().ingest("x", 1.0, t=0.0, kind="summary")
        with pytest.raises(ValueError, match="unknown tier"):
            mod.TimeSeriesStore().query(tier="medium")


# ------------------------------------------------------------- exposition
def _exposition_text():
    """The port's own /metrics text for a registry that saw every family
    kind, plus junk lines, a NaN, an escaped label and an untyped
    sample."""
    tel = port_pipeline.PipelineTelemetry()
    rng = np.random.default_rng(SEED)
    for v in rng.exponential(0.01, 50):
        tel.dispatch_gap.observe(float(v))
        tel.submit_rtt.observe(float(v) * 10)
    tel.pool_acks.labels(result="accepted").inc(7)
    tel.pool_acks.labels(result="rejected").inc(2)
    tel.ring_occupancy.set(3)
    tel.fleet_child_state.labels(child="127.0.0.1:5").set(2.0)
    stats = MinerStats(hashes=1 << 20, batches=4)
    text = port_status.prometheus_text(stats, tel.registry)
    return text + (
        "garbage line here\n"
        "tpu_miner_weird{a=\"x\\\"y\\\\z\",b=\"n\\nl\"} 4\n"
        "tpu_miner_nan NaN\n"
        "tpu_miner_bad_value{a=\"1\"} abc\n"
        "untyped_thing 12.5\n")


def test_parse_exposition_and_sample_key_match():
    text = _exposition_text()
    ref = ref_tsdb.parse_exposition(text)
    port = port_tsdb.parse_exposition(text)
    assert ref == port
    kinds = {name: kind for name, _, _, kind in port}
    assert kinds["tpu_miner_hashes_total"] == "counter"
    assert kinds["tpu_miner_dispatch_gap_seconds_count"] == "counter"
    assert "tpu_miner_dispatch_gap_seconds_bucket" not in kinds
    assert kinds["tpu_miner_ring_occupancy"] == "gauge"
    assert "tpu_miner_nan" not in kinds
    for line in text.splitlines() + ["", "# HELP x y", "x{a=\"1\"} 2"]:
        assert ref_tsdb.sample_key(line) == port_tsdb.sample_key(line)


@pytest.mark.parametrize("payload", [
    [], {"schema": "nope"},
    {"schema": "tpu-miner-query/1", "now": "x", "interval_s": 1.0},
    {"schema": "tpu-miner-query/1", "now": 1.0, "interval_s": True},
    {"schema": "tpu-miner-query/1", "now": 1.0, "interval_s": 1.0,
     "tier": "warm"},
    {"schema": "tpu-miner-query/1", "now": 1.0, "interval_s": 1.0,
     "tier": "fine", "series": {}},
    {"schema": "tpu-miner-query/1", "now": 1.0, "interval_s": 1.0,
     "tier": "fine", "series": [{"name": ""}]},
    {"schema": "tpu-miner-query/1", "now": 1.0, "interval_s": 1.0,
     "tier": "fine", "series": [{"name": "a", "labels": {"x": 1}}]},
    {"schema": "tpu-miner-query/1", "now": 1.0, "interval_s": 1.0,
     "tier": "fine", "series": [{"name": "a", "labels": {}, "kind": "h"}]},
    {"schema": "tpu-miner-query/1", "now": 1.0, "interval_s": 1.0,
     "tier": "fine", "series": [{"name": "a", "labels": {},
                                 "kind": "gauge", "stale": 0}]},
    {"schema": "tpu-miner-query/1", "now": 1.0, "interval_s": 1.0,
     "tier": "fine", "series": [{"name": "a", "labels": {},
                                 "kind": "gauge", "stale": False,
                                 "points": []}]},
    {"schema": "tpu-miner-query/1", "now": 1.0, "interval_s": 1.0,
     "tier": "fine", "series": [{"name": "a", "labels": {},
                                 "kind": "gauge", "stale": False,
                                 "points": [[1.0, 2.0, 3.0]]}]},
    {"schema": "tpu-miner-query/1", "now": 1.0, "interval_s": 1.0,
     "tier": "fine", "series": [{"name": "a", "labels": {},
                                 "kind": "gauge", "stale": False,
                                 "points": [[2.0, 1.0], [1.0, 1.0]]}]},
])
def test_bad_query_payloads_raise_the_same_errors(payload):
    with pytest.raises(ref_tsdb.QueryError) as ref:
        ref_tsdb.parse_query_payload(payload, source="src")
    with pytest.raises(port_tsdb.QueryError) as port:
        port_tsdb.parse_query_payload(payload, source="src")
    assert str(ref.value) == str(port.value)


# -------------------------------------------------------------- collectors
def test_registry_sampler_matches_on_the_same_registry_state(wall):
    """Each package's sampler over its own bundle, moved the same way:
    the same series and values."""
    bundles = (ref_pipeline.PipelineTelemetry(),
               port_pipeline.PipelineTelemetry())
    for tel in bundles:
        tel.pool_acks.labels(result="accepted").inc(3)
        tel.submit_rtt.observe(0.004)
        tel.ring_occupancy.set(2)
        tel.fleet_child_state.labels(child="a:1").set(1.0)
    stores = _stores()
    ref_tsdb.RegistrySampler(stores[0], bundles[0].registry).sample(10.0)
    port_tsdb.RegistrySampler(stores[1], bundles[1].registry).sample(10.0)
    wanted = ("tpu_miner_pool_acks_total", "tpu_miner_submit_rtt_seconds",
              "tpu_miner_ring_occupancy", "tpu_miner_fleet_child_state")
    ref, port = (s.query(now=10.0) for s in stores)
    pick = (lambda q: [x for x in q["series"]
                       if x["name"].startswith(wanted)])
    assert pick(ref) == pick(port) and len(pick(port)) == 5


def test_federation_relabels_and_counts_like_the_reference(wall):
    """Both federators scrape the port's own status server (and a dead
    target): the same ingested series, the same scrape counters."""
    tel = port_pipeline.PipelineTelemetry()
    tel.pool_acks.labels(result="accepted").inc(5)
    server = port_status.StatusServer(MinerStats(hashes=1 << 16), 0,
                                      registry=tel.registry)
    stop = port_status.serve_status_in_thread(server)
    bundles = (ref_pipeline.PipelineTelemetry(),
               port_pipeline.PipelineTelemetry())
    stores = _stores()
    try:
        feds = (ref_tsdb.ScrapeFederator(stores[0], bundles[0]),
                port_tsdb.ScrapeFederator(stores[1], bundles[1]))
        for mod, fed in zip((ref_tsdb, port_tsdb), feds):
            fed.add_target(mod.ScrapeTarget.make(
                "worker-w", f"http://127.0.0.1:{server.port}/metrics",
                {"worker": "w"}))
            fed.add_source(lambda mod=mod: [mod.ScrapeTarget.make(
                "dead", "http://127.0.0.1:9/metrics")])
            fed.add_source(lambda: 1 / 0)  # a broken discovery source
        counts = [fed.scrape(now=7.0) for fed in feds]
    finally:
        stop()
    assert counts[0] == counts[1] > 10
    # The two scrapes are moments apart: the clock-derived gauges differ.
    clocked = {"tpu_miner_uptime_s", "tpu_miner_hashrate_mhs"}
    ref, port = ([x for x in s.query(now=7.0)["series"]
                  if x["name"] not in clocked] for s in stores)
    assert ref == port
    acks = [x for x in port if x["name"] == "tpu_miner_pool_acks_total"]
    assert acks[0]["labels"] == {"process": "worker-w", "result": "accepted",
                                 "worker": "w"}
    for tel in bundles:
        scrapes = {k: c.value for k, c in tel.federate_scrapes.children()}
        assert scrapes == {("worker-w", "ok"): 1.0, ("dead", "error"): 1.0}


def test_observatory_collects_and_stops(wall):
    """One collect cycle of each package's observatory over its own bundle
    (the same moves): the same local series, the series gauge set, the
    default rules installed; the port's thread starts and stops."""
    bundles = (ref_pipeline.PipelineTelemetry(),
               port_pipeline.PipelineTelemetry())
    stores = _stores()
    obs = (ref_tsdb.Observatory(stores[0], bundles[0], interval_s=0.05),
           port_tsdb.Observatory(stores[1], bundles[1], interval_s=0.05))
    for tel in bundles:
        tel.pool_acks.labels(result="accepted").inc(4)
    for o in obs:
        o.collect(now=3.0)
    for tel in bundles:
        tel.pool_acks.labels(result="accepted").inc(4)
    for o in obs:
        o.collect(now=5.0)
    pick = (lambda s: [x for x in s.query(now=5.0)["series"]
                       if "pool_acks" in x["name"]])
    assert pick(stores[0]) == pick(stores[1])
    assert [x["name"] for x in pick(stores[1])] == [
        "tpu_miner_pool_acks_per_s", "tpu_miner_pool_acks_total"]
    assert bundles[1].tsdb_series.value == stores[1].series_count()
    assert obs[1].summary() == f"tsdb {stores[1].series_count()} series"
    assert port_tsdb.Observatory(port_tsdb.TimeSeriesStore()).summary() \
        is None
    obs[1].start()
    assert any(t.name == "observatory" for t in threading.enumerate())
    obs[1].stop()
    assert not any(t.name == "observatory" and t.is_alive()
                   for t in threading.enumerate())


def test_query_payload_round_trips_through_json(wall):
    stores = _stores()
    _feed(stores, _ingests(60))
    payload = json.loads(json.dumps(stores[1].query(now=1100.0)))
    assert port_tsdb.parse_query_payload(payload) == \
        ref_tsdb.parse_query_payload(payload)
