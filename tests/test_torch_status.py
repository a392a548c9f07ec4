"""The PyTorch package's status server, stats reporter and telemetry
flags, against the JAX package's where both have the surface: the same
exposition text and snapshot for the same session counters, the same
reporter line, every route, the oversized request line the reference's
server answers with a reset (this one closes in order), the command
line's flags, and a Stratum session on the CPU of each package with the
same span names and metric families."""

import asyncio
import json
import socket
import threading

import numpy as np
import pytest
import torch

# The miner package first: importing the protocol package first is circular.
from bitcoin_miner_tpu.miner import dispatcher as ref_dispatcher
from bitcoin_miner_tpu.miner import runner as ref_runner
from bitcoin_miner_tpu.telemetry import health as ref_health
from bitcoin_miner_tpu.telemetry import pipeline as ref_pipeline
from bitcoin_miner_tpu.telemetry import shareacct as ref_shareacct
from bitcoin_miner_tpu.testing import mock_pool as ref_pool
from bitcoin_miner_tpu.utils import reporting as ref_reporting
from bitcoin_miner_tpu.utils import status as ref_status
from bitcoin_miner_tpu_torch import cli
from bitcoin_miner_tpu_torch.core.sha256 import sha256d
from bitcoin_miner_tpu_torch.miner import dispatcher as port_dispatcher
from bitcoin_miner_tpu_torch.telemetry import health as port_health
from bitcoin_miner_tpu_torch.telemetry import pipeline as port_pipeline
from bitcoin_miner_tpu_torch.telemetry import shareacct as port_shareacct
from bitcoin_miner_tpu_torch.testing import mock_pool as port_pool
from bitcoin_miner_tpu_torch.utils import reporting as port_reporting
from bitcoin_miner_tpu_torch.utils import status as port_status
from tests.test_telemetry import parse_prometheus, validate_chrome_trace


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def fresh_default():
    """A fresh process-default bundle for the test, dropped after it (with
    its flight recorder's hooks undone): the next reader builds its own,
    so no test's spans or counts reach a later test of the worker."""
    port_pipeline.set_telemetry(port_pipeline.PipelineTelemetry())
    yield
    port_pipeline.get_telemetry().flightrec.disarm()
    port_pipeline.set_telemetry(None)


class FakeClock:
    def __init__(self, t: float = 5000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


EASY_DIFF = 1 / (1 << 24)  # ~2^-8 per nonce


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


async def scrape(port, path="/metrics", request=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(request if request is not None
                 else f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), 10)
    writer.close()
    return raw


def split(raw):
    head, _, body = raw.partition(b"\r\n\r\n")
    return head.splitlines()[0].decode(), body


def _session_state(seed, pipeline, dispatcher, shareacct):
    """A session's counters and telemetry from seeded numbers."""
    rng = np.random.default_rng(seed)
    tel = pipeline.PipelineTelemetry()
    stats = dispatcher.MinerStats(telemetry=tel)
    for key in ("hashes", "batches", "shares_found", "shares_accepted",
                "shares_rejected", "shares_stale", "blocks_found",
                "hw_errors", "reconnects"):
        setattr(stats, key, int(rng.integers(0, 1 << 20)))
    stats.scan_seconds = float(rng.uniform(1, 50))
    stats.started_at = 5000.0 - float(rng.uniform(60, 600))
    for _ in range(40):
        tel.dispatch_gap.observe(float(rng.lognormal(-6, 2)))
        tel.submit_rtt.observe(float(rng.lognormal(-4, 1)))
        tel.ring_collect.observe(float(rng.lognormal(-6, 1)))
        tel.pool_acks.labels(result=str(rng.choice(
            ["accepted", "rejected", "stale"]))).inc()
    tel.consts_cache.labels(result="hit").inc(int(rng.integers(1, 99)))
    acct = shareacct.ShareAccountant(stats, telemetry=tel)
    acct.set_difficulty(1 / 256)
    for _ in range(30):
        acct.on_result("accepted", 1 / 256)
    return tel, stats, acct


# ------------------------------------------------------ exposition, reporter
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_prometheus_text_and_snapshot_match_reference(seed, monkeypatch):
    monkeypatch.setattr("time.monotonic", FakeClock())
    ref_tel, ref_stats, _ = _session_state(seed, ref_pipeline,
                                           ref_dispatcher, ref_shareacct)
    tel, stats, _ = _session_state(seed, port_pipeline, port_dispatcher,
                                   port_shareacct)
    assert port_status.stats_snapshot(stats) == ref_status.stats_snapshot(
        ref_stats)
    text = port_status.prometheus_text(stats, tel.registry)
    ref_text = ref_status.prometheus_text(ref_stats, ref_tel.registry)
    ref_families = parse_prometheus(ref_text)
    families = parse_prometheus(text)
    # The port registers a subset of the reference's families; those it
    # has render the same lines.
    assert set(families) <= set(ref_families)
    for name, family in families.items():
        assert family == ref_families[name], name
    assert port_status.prometheus_text(stats).splitlines() == \
        ref_status.prometheus_text(ref_stats).splitlines()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_health", [False, True])
def test_reporter_line_matches_reference(seed, with_health, monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr("time.monotonic", clock)
    lines = []
    for pipeline, dispatcher, shareacct, reporting, health in (
            (ref_pipeline, ref_dispatcher, ref_shareacct, ref_reporting,
             ref_health),
            (port_pipeline, port_dispatcher, port_shareacct,
             port_reporting, port_health)):
        clock.t = 5000.0
        tel, stats, acct = _session_state(seed, pipeline, dispatcher,
                                          shareacct)
        model = None
        if with_health:
            model = health.HealthModel(tel, stats=stats)
            model.publish()
        reporter = reporting.StatsReporter(stats, 10.0, telemetry=tel,
                                           health=model, accounting=acct)
        clock.t += 10.0
        stats.hashes += 1 << 30
        lines.append(reporter.tick())
    assert lines[1] == lines[0]
    assert "gap ms p50/p95/p99" in lines[1] and "share eff" in lines[1]


# ------------------------------------------------------------- status server
def _server(**kw):
    tel = port_pipeline.PipelineTelemetry(
        tracer=port_pipeline.Tracer(enabled=True))
    stats = port_dispatcher.MinerStats(telemetry=tel)
    return port_status.StatusServer(stats, port=0, registry=tel.registry,
                                    telemetry=tel, **kw), tel, stats


def test_every_route_answers():
    async def main():
        server, tel, stats = _server(
            health=port_health.HealthModel())
        server.health._telemetry = tel
        tel.consts_cache.labels(result="hit").inc(3)
        tel.tracer.instant("job_notify", cat="job", job_id="j")
        tel.flightrec.record("job_switch", job_id="j")
        tel.lifecycle.hop("k", "hit", job_id="j")
        stats.hashes = 1234
        await server.start()
        try:
            status, body = split(await scrape(server.port, "/metrics"))
            families = parse_prometheus(body.decode())
            assert status == "HTTP/1.1 200 OK"
            assert families["tpu_miner_hashes_total"]["samples"][0][2] == 1234
            assert families["tpu_miner_consts_cache_lookups_total"][
                "samples"][0] == ("tpu_miner_consts_cache_lookups_total",
                                  {"result": "hit"}, 3.0)
            status, body = split(await scrape(server.port, "/telemetry"))
            assert json.loads(body)["tpu_miner_consts_cache_lookups"][
                "kind"] == "counter"
            status, body = split(await scrape(server.port, "/healthz"))
            assert status == "HTTP/1.1 200 OK"
            assert json.loads(body)["status"] == "ok"
            status, body = split(await scrape(server.port, "/trace"))
            trace = json.loads(body)
            validate_chrome_trace(trace)
            assert [e["name"] for e in trace["traceEvents"]
                    if e["ph"] == "i"] == ["job_notify"]
            status, body = split(await scrape(server.port, "/flightrec"))
            dump = json.loads(body)
            assert dump["schema"] == "tpu-miner-flightrec/1"
            assert dump["reason"] == "request"
            assert [e["kind"] for e in dump["events"]] == ["job_switch"]
            status, body = split(await scrape(server.port, "/lifecycle"))
            assert json.loads(body)["records"][0]["key"] == "k"
            status, body = split(await scrape(server.port, "/anything?x=1"))
            assert json.loads(body)["hashes"] == 1234
        finally:
            await server.stop()

    run(main())


def test_healthz_answers_503_when_a_component_stalls():
    async def main():
        clock = FakeClock()
        server, tel, stats = _server()
        server.health = port_health.HealthModel(tel, stats=stats,
                                                clock=clock)
        tel.submits_inflight.inc()
        await server.start()
        try:
            assert split(await scrape(server.port, "/healthz"))[0] == \
                "HTTP/1.1 200 OK"
            clock.t += 30
            status, body = split(await scrape(server.port, "/healthz"))
            assert status == "HTTP/1.1 503 Service Unavailable"
            payload = json.loads(body)
            assert payload["components"]["pool"]["state"] == "stalled"
            assert payload["reasons"][0].startswith("pool: 1 submits")
        finally:
            await server.stop()

    run(main())


def _fabric_pair():
    """(reference, port) two-slot fabrics, the second slot dead."""
    from bitcoin_miner_tpu.miner import multipool as ref_mp
    from bitcoin_miner_tpu_torch.miner import multipool as port_mp

    out = []
    for mp, pipeline in ((ref_mp, ref_pipeline), (port_mp, port_pipeline)):
        fabric = mp.PoolFabric(
            [mp.parse_pool_spec("stratum+tcp://127.0.0.1:1#w=2"),
             mp.parse_pool_spec("stratum+tcp://127.0.0.1:2")],
            telemetry=pipeline.PipelineTelemetry())
        fabric.slots[1].state = mp.DEAD
        out.append(fabric)
    return out


def test_telemetry_carries_the_fabric_snapshot():
    """``/telemetry`` holds ``pool_fabric``: the port's snapshot, equal to
    the reference's server's on the same fabric state."""
    async def main(status_mod, pipeline, dispatcher, fabric):
        tel = pipeline.PipelineTelemetry()
        server = status_mod.StatusServer(
            dispatcher.MinerStats(), port=0, registry=tel.registry,
            telemetry=tel, fabric=fabric)
        await server.start()
        try:
            return json.loads(split(await scrape(server.port,
                                                 "/telemetry"))[1])
        finally:
            await server.stop()

    ref_fabric, port_fabric = _fabric_pair()
    ref = run(main(ref_status, ref_pipeline, ref_dispatcher, ref_fabric))
    port = run(main(port_status, port_pipeline, port_dispatcher,
                    port_fabric))
    snap = port["pool_fabric"]
    assert snap == ref["pool_fabric"]
    assert snap["active"] is None
    assert [s["state"] for s in snap["slots"]] == ["connecting", "dead"]
    assert snap["weights"] == {"127.0.0.1:1": 0.0, "127.0.0.1:2": 0.0}


def test_telemetry_without_a_fabric_has_no_fabric_key():
    async def main():
        server, tel, stats = _server()
        await server.start()
        try:
            return json.loads(split(await scrape(server.port,
                                                 "/telemetry"))[1])
        finally:
            await server.stop()

    payload = run(main())
    assert "pool_fabric" not in payload
    assert "tpu_miner_pool_slot_state" in payload


class _Shards:
    """A sharded frontend's supervisor as the status server sees it: a
    snapshot, and the children's relabelled samples (slow with
    ``delay``)."""

    def __init__(self, delay: float = 0.0) -> None:
        self.delay = delay
        self.scrapes = 0

    def snapshot(self) -> dict:
        return {"n_shards": 2, "host": "127.0.0.1", "port": 3999,
                "shards": [{"shard": i, "pid": 4100 + i, "state": "serving",
                            "restarts": i, "prefix_range": [32768 * i,
                                                            32768 * (i + 1)],
                            "status_port": 9101 + i} for i in range(2)]}

    def metrics_text(self) -> str:
        self.scrapes += 1
        if self.delay:
            threading.Event().wait(self.delay)
        return ('# aggregated from shard /metrics (shard label added by '
                'the supervisor)\n'
                'tpu_miner_frontend_sessions{shard="0"} 3\n'
                'tpu_miner_frontend_shares_total{result="accepted",'
                'shard="1"} 7\n')


def test_telemetry_and_metrics_carry_the_shards_like_the_reference():
    """``/telemetry`` holds the supervisor's snapshot under
    ``frontend_shards`` and ``/metrics`` ends with its children's
    samples, in the port's server as in the reference's."""
    async def main(status_mod, pipeline, dispatcher):
        tel = pipeline.PipelineTelemetry()
        tel.frontend_shard_state.labels(shard="0").set(1)
        server = status_mod.StatusServer(
            dispatcher.MinerStats(), port=0, registry=tel.registry,
            telemetry=tel, shards=_Shards())
        await server.start()
        try:
            telemetry = json.loads(split(await scrape(server.port,
                                                      "/telemetry"))[1])
            metrics = split(await scrape(server.port, "/metrics"))[1]
            return telemetry, metrics.decode()
        finally:
            await server.stop()

    ref = run(main(ref_status, ref_pipeline, ref_dispatcher))
    port = run(main(port_status, port_pipeline, port_dispatcher))
    assert port[0]["frontend_shards"] == ref[0]["frontend_shards"] == \
        _Shards().snapshot()
    assert port[1].endswith(_Shards().metrics_text())
    assert ref[1].endswith(_Shards().metrics_text())
    body = port[1].split("# aggregated from shard")[0]
    assert 'tpu_miner_frontend_shard_state{shard="0"} 1' in body
    families = parse_prometheus(body)
    assert "tpu_miner_frontend_shard_state" in families


def test_unsharded_telemetry_has_no_shards_key():
    async def main():
        server, _, _ = _server()
        await server.start()
        try:
            return json.loads(split(await scrape(server.port,
                                                 "/telemetry"))[1])
        finally:
            await server.stop()

    assert "frontend_shards" not in run(main())


def test_shard_scrape_runs_off_the_event_loop():
    """The children's scrape (here 0.5 s) runs in the executor: a request
    made while it is in flight is answered first."""
    async def main():
        shards = _Shards(delay=0.5)
        server, _, _ = _server(shards=shards)
        await server.start()
        try:
            order = []

            async def get(path):
                raw = await scrape(server.port, path)
                order.append(path)
                return raw

            slow = asyncio.create_task(get("/metrics"))
            while not shards.scrapes:
                await asyncio.sleep(0.01)
            await get("/anything")
            await slow
            return order
        finally:
            await server.stop()

    assert run(main()) == ["/anything", "/metrics"]


@pytest.mark.parametrize("oversized", [
    b"A" * (128 * 1024),
    b"GET /metrics HTTP/1.1\r\nX-Long: " + b"B" * (128 * 1024)
    + b"\r\n\r\n"], ids=["request_line", "header"])
def test_oversized_request_closes_in_order_with_shards(oversized):
    """The shard routes ride the port's handler: an oversized request to
    a sharded frontend's server is still half-closed and drained, never
    reset, and the server serves ``/metrics`` with the shards after."""
    async def main():
        server, _, _ = _server(shards=_Shards())
        await server.start()
        try:
            assert await scrape(server.port, request=oversized) == b""
            status, body = split(await scrape(server.port, "/metrics"))
            assert status == "HTTP/1.1 200 OK"
            assert b'shard="1"' in body
        finally:
            await server.stop()

    run(main())


def test_routes_without_telemetry_answer_the_snapshot():
    async def main():
        stats = port_dispatcher.MinerStats()
        server = port_status.StatusServer(stats, port=0)
        await server.start()
        try:
            for path in ("/healthz", "/trace", "/flightrec", "/lifecycle",
                         "/telemetry"):
                assert "hashes" in json.loads(
                    split(await scrape(server.port, path))[1])
        finally:
            await server.stop()

    run(main())


@pytest.mark.parametrize("oversized", [
    b"A" * (128 * 1024),
    b"GET / HTTP/1.1\r\nX-Long: " + b"B" * (128 * 1024) + b"\r\n\r\n"],
    ids=["request_line", "header"])
def test_oversized_request_line_closes_in_order(oversized):
    """The reference's ``test_malformed_request_lines`` case
    (tests/test_utils_cli.py), which fails there: its server drops a
    128 KiB request line by closing with unread bytes, and the kernel
    answers with a reset. This server half-closes and drains first: the
    client reads an empty response, no ConnectionResetError, and the
    server still serves."""
    async def main():
        server, _, _ = _server()
        await server.start()
        try:
            status, body = split(await scrape(server.port,
                                              request=b"GARBAGE\r\n\r\n"))
            assert status == "HTTP/1.1 200 OK"
            json.loads(body)
            assert await scrape(server.port, request=oversized) == b""
            status, _ = split(await scrape(server.port, "/"))
            assert status == "HTTP/1.1 200 OK"
        finally:
            await server.stop()

    run(main())


def test_stalled_client_hits_the_deadline(monkeypatch):
    monkeypatch.setattr(port_status.StatusServer, "request_timeout", 0.3)

    async def main():
        server, _, _ = _server()
        await server.start()
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           server.port)
            writer.write(b"GET /metrics HTTP/1.1\r\n")  # never finishes
            await writer.drain()
            assert await asyncio.wait_for(reader.read(), 5) == b""
            writer.close()
            assert split(await scrape(server.port, "/"))[0] == \
                "HTTP/1.1 200 OK"
        finally:
            await server.stop()

    run(main())


def test_serve_status_in_thread():
    server, _, stats = _server()
    stats.batches = 9
    stop = port_status.serve_status_in_thread(server)
    try:
        raw = asyncio.run(scrape(server.port, "/"))
        assert json.loads(split(raw)[1])["batches"] == 9
    finally:
        stop()
    assert not any(t.name == "status-server" and t.is_alive()
                   for t in threading.enumerate())
    taken = port_status.StatusServer(stats, port=server.port)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        sock.listen()
        taken.port = sock.getsockname()[1]
        with pytest.raises(OSError):
            port_status.serve_status_in_thread(taken)


# ------------------------------------------------------------ command line
def test_help_lists_the_telemetry_flags(capsys):
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--help"])
    out = capsys.readouterr().out
    for flag in ("--status-port", "--trace-out", "--flightrec-out",
                 "--health-interval", "--slo-fast-window",
                 "--slo-slow-window", "--slo-objectives", "--incident-dir",
                 "--federate"):
        assert flag in out
    assert "not ported" not in out


@pytest.mark.parametrize("argv", [
    ["--bench", "--status-port", "1"], ["--bench", "--health-interval", "1"]])
def test_bench_refuses_the_live_flags(argv):
    with pytest.raises(SystemExit, match="applies only to"):
        cli.bench(cli.build_parser().parse_args(argv + ["--device", "cpu"]))


def test_setup_telemetry_arms_and_traces(tmp_path, fresh_default):
    args = cli.build_parser().parse_args(
        ["--bench", "--trace-out", str(tmp_path / "t.json"),
         "--flightrec-out", str(tmp_path / "fr.json")])
    tel = cli.setup_telemetry(args)
    assert tel is port_pipeline.get_telemetry()
    assert tel.tracer.enabled and tel.trace_path == str(tmp_path / "t.json")
    assert tel.flightrec._armed
    assert tel.flightrec._dump_path == str(tmp_path / "fr.json")


def test_trace_out_overrides_the_environment_switch(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_MINER_TELEMETRY", "0")
    previous = port_pipeline.set_telemetry(None)
    try:
        args = cli.build_parser().parse_args(
            ["--bench", "--flightrec-out", str(tmp_path / "fr.json")])
        assert not cli.setup_telemetry(args).enabled
        args.trace_out = str(tmp_path / "t.json")
        tel = cli.setup_telemetry(args)
        assert tel.enabled and tel.tracer.enabled
        assert port_pipeline.get_telemetry() is tel
        tel.flightrec.disarm()
    finally:
        port_pipeline.set_telemetry(previous)


def test_bench_writes_its_trace(tmp_path, fresh_default):
    args = cli.build_parser().parse_args(
        ["--bench", "--device", "cpu", "--batch-bits", "12",
         "--bench-nonces", "8192", "--trace-out", str(tmp_path / "t.json"),
         "--flightrec-out", str(tmp_path / "fr.json")])
    out = cli.bench(args)
    assert out["verified"]
    trace = json.loads((tmp_path / "t.json").read_text())
    validate_chrome_trace(trace)
    names = [e["name"] for e in trace["traceEvents"] if e["ph"] == "X"]
    assert names.count("device_dispatch") == names.count("ring_collect") \
        == out["dispatches"] == 2
    assert not (tmp_path / "fr.json").exists()  # written on a crash only


@pytest.mark.parametrize("interval,threaded", [(None, True), (0.0, False),
                                               (0.2, True)])
def test_make_health_starts_the_watchdog(interval, threaded):
    args = cli.build_parser().parse_args(["--getwork", "http://x:1"])
    args.health_interval = interval
    tel = port_pipeline.PipelineTelemetry()
    model, watchdog, slo = cli.make_health(args, tel,
                                           port_dispatcher.MinerStats())
    try:
        assert (watchdog is not None) is threaded
        if interval is None:
            assert watchdog.interval == cli.DEFAULT_HEALTH_INTERVAL
    finally:
        if watchdog is not None:
            watchdog.stop()
    assert model.telemetry is tel and model.slo is slo


# ------------------------------------------------------------ end to end
def _pool_job(pool_module):
    return pool_module.PoolJob(
        job_id="j1", prevhash_internal=sha256d(b"status prev"),
        coinb1=bytes.fromhex("01000000") + b"\x11" * 30,
        coinb2=b"\x22" * 30 + bytes.fromhex("00000000"),
        merkle_branch=[sha256d(b"tx1")], version=0x20000000,
        nbits=0x1D00FFFF, ntime=0x655F2B2C)


def _families(registry):
    """The families a session moved: a labeled family with a child, an
    unlabeled one with a count or a nonzero value. Two are left out as
    timing: the dispatch gap (whether the busy clock of a session this
    short ever goes idle) and the submits in flight at the stop (a submit
    the stop cuts leaves the reference's gauge raised)."""
    out = set()
    for name, fam in registry.snapshot().items():
        for sample in fam["samples"]:
            if sample["labels"] or sample.get("count") or sample.get("value"):
                out.add(name)
    return out - {"tpu_miner_dispatch_gap_seconds",
                  "tpu_miner_submits_inflight"}


async def _until(task, done, seconds=120):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + seconds
    while not done():
        assert not task.done(), task
        assert loop.time() < deadline, "timed out"
        await asyncio.sleep(0.05)


def _reference_session(tmp_path):
    """The JAX package's Stratum session on its TPU ring (the XLA scan on
    JAX's CPU), its telemetry, health watchdog, SLO engine and
    observatory as its CLI builds them (no incident capture)."""
    from bitcoin_miner_tpu.backends.tpu import TpuHasher
    from bitcoin_miner_tpu.telemetry.slo import SloEngine
    from bitcoin_miner_tpu.telemetry.tsdb import Observatory, TimeSeriesStore

    tel = ref_pipeline.set_telemetry(ref_pipeline.PipelineTelemetry(
        trace_path=str(tmp_path / "ref.json")))

    async def main():
        pool = ref_pool.MockStratumPool(difficulty=EASY_DIFF)
        await pool.start()
        await pool.announce_job(_pool_job(ref_pool))
        miner = ref_runner.StratumMiner(
            "127.0.0.1", pool.port, "w",
            hasher=TpuHasher(batch_size=1 << 12, inner_size=1 << 10),
            n_workers=2, batch_size=1 << 12)
        slo = SloEngine(tel, store=TimeSeriesStore(
            interval_s=1.0, retention_s=900.0, stale_after_s=15.0))
        model = ref_health.HealthModel(tel, stats=miner.dispatcher.stats,
                                       relay_probe=lambda: False, slo=slo)
        dog = ref_health.HealthWatchdog(model, interval=0.2).start()
        observatory = Observatory(slo.store, tel, interval_s=0.2).start()
        task = asyncio.create_task(miner.run())
        try:
            await _until(task, lambda: miner.dispatcher.stats.shares_accepted
                         >= 3)
            await asyncio.sleep(0.5)
        finally:
            miner.stop()
            await asyncio.gather(task, return_exceptions=True)
            observatory.stop()
            dog.stop()
            await pool.stop()

    try:
        run(main(), timeout=240)
        tel.dump_trace()
    finally:
        ref_pipeline.set_telemetry(None)
    return tel, json.loads((tmp_path / "ref.json").read_text())


def test_cpu_session_matches_the_reference(tmp_path, fresh_default):
    """A Stratum session of each package on the CPU, the port's through
    its command line: the same span names and metric families. The port's
    trace holds one device_dispatch and one ring_collect per dispatch, one
    cpu_verify per verified hit, and one submit and one pool_ack per
    verdict; /metrics, /healthz, /trace and /flightrec answer mid-session
    and the flight recorder holds the job switch."""
    port = free_port()
    trace_path = tmp_path / "port.json"
    args = cli.build_parser().parse_args(
        ["--pool", "stratum+tcp://127.0.0.1:1", "--device", "cpu",
         "--batch-bits", "12", "--workers", "2", "--status-port", str(port),
         "--trace-out", str(trace_path),
         "--flightrec-out", str(tmp_path / "fr.json"),
         "--incident-dir", str(tmp_path / "incidents"),
         "--health-interval", "0.2", "--report-interval", "0.5"])
    scraped = {}

    async def main():
        pool = port_pool.MockStratumPool(difficulty=EASY_DIFF)
        await pool.start()
        await pool.announce_job(_pool_job(port_pool))
        args.pool = [f"stratum+tcp://127.0.0.1:{pool.port}"]
        miner = cli.make_miner(args)
        hasher = miner.dispatcher.hasher
        dispatches = [0]
        scan_fn = hasher._scan_fn

        def counted(*a):
            dispatches[0] += 1
            return scan_fn(*a)

        hasher._scan_fn = counted
        task = asyncio.create_task(cli.run_session(miner, args))
        stats = miner.dispatcher.stats
        try:
            await _until(task, lambda: stats.shares_accepted >= 3)
            await asyncio.sleep(0.5)
            for path in ("/metrics", "/healthz", "/trace", "/flightrec"):
                scraped[path] = split(await scrape(port, path))
        finally:
            miner.stop()
            await asyncio.gather(task, return_exceptions=True)
            await pool.stop()
        task.result()
        return miner, dispatches[0], pool

    miner, dispatches, pool = run(main())
    tel = miner.dispatcher.telemetry
    stats = miner.dispatcher.stats
    assert tel is port_pipeline.get_telemetry()

    metrics = parse_prometheus(scraped["/metrics"][1].decode())
    acks = {s[1]["result"]: s[2] for s in metrics[
        "tpu_miner_pool_acks_total"]["samples"]}
    assert acks["accepted"] >= 3
    assert scraped["/healthz"][0] == "HTTP/1.1 200 OK"
    health = json.loads(scraped["/healthz"][1])
    assert {health["components"][c]["state"] for c in ("device", "ring")} \
        == {"ok"}
    validate_chrome_trace(json.loads(scraped["/trace"][1]))
    assert "job_switch" in [e["kind"] for e in json.loads(
        scraped["/flightrec"][1])["events"]]
    assert not (tmp_path / "fr.json").exists()

    trace = json.loads(trace_path.read_text())
    validate_chrome_trace(trace)
    events = trace["traceEvents"]

    def count(name, **args):
        return sum(1 for e in events if e["name"] == name and all(
            e["args"].get(k) == v for k, v in args.items()))

    assert count("device_dispatch") == count("ring_collect") == dispatches
    assert dispatches == tel.ring_collect.count > 0
    assert count("cpu_verify") == stats.shares_found + stats.hw_errors
    verdicts = sum(c.value for _, c in tel.pool_acks.children())
    assert count("submit") == count("pool_ack") == verdicts
    assert count("pool_ack", result="accepted") == stats.shares_accepted
    assert len({e["args"]["trace"] for e in events if e["ph"] != "M"}) == 1
    assert tel.submits_inflight.value == 0

    ref_tel, ref_trace = _reference_session(tmp_path)
    names = {e["name"] for e in events}
    assert names == {e["name"] for e in ref_trace["traceEvents"]}
    assert {"job_notify", "feeder_slice", "device_dispatch", "ring_collect",
            "cpu_verify", "submit", "pool_ack"} <= names
    assert _families(tel.registry) == _families(ref_tel.registry)
