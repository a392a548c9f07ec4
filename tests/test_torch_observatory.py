"""The observatory on the PyTorch package's surfaces, on the CPU: the
status server's ``/slo`` and ``/query`` routes (bad parameters, label
selectors, an oversized request closed in order), ``make_observatory``
with ``--federate`` and a fleet's ``--worker HOST:PORT@STATUSPORT``
targets, the ``top`` dashboard against the reference's renderer, a
Stratum session whose 1 µs latency objective must breach (``/slo``,
``/healthz``, ``/query``, ``top --once``, ``slo --status-url``, the
incident bundle and its ledger row), a served worker whose ``/query`` a
parent session federates, and no observatory or watchdog thread left
after a session or a served worker stops. Every output path is in
``tmp_path``."""

import asyncio
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
import torch

from bitcoin_miner_tpu.telemetry import dashboard as ref_dashboard
from bitcoin_miner_tpu_torch import cli
from bitcoin_miner_tpu_torch.core.sha256 import sha256d
from bitcoin_miner_tpu_torch.miner.dispatcher import MinerStats
from bitcoin_miner_tpu_torch.telemetry import dashboard as port_dashboard
from bitcoin_miner_tpu_torch.telemetry import perfledger as port_ledger
from bitcoin_miner_tpu_torch.telemetry import pipeline as port_pipeline
from bitcoin_miner_tpu_torch.telemetry import slo as port_slo
from bitcoin_miner_tpu_torch.telemetry import tsdb as port_tsdb
from bitcoin_miner_tpu_torch.testing import mock_pool as port_pool
from bitcoin_miner_tpu_torch.utils import status as port_status

EASY_DIFF = 1 / (1 << 24)  # ~2^-8 per nonce
THREADS = ("observatory", "health-watchdog")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def fresh_default():
    port_pipeline.set_telemetry(port_pipeline.PipelineTelemetry())
    yield
    port_pipeline.get_telemetry().flightrec.disarm()
    port_pipeline.set_telemetry(None)  # the next reader builds its own


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def get(port, path, timeout=10.0):
    """(status, body) of one GET; an HTTP error status is an answer."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _threads_left():
    return [t.name for t in threading.enumerate()
            if t.name in THREADS and t.is_alive()]


# ------------------------------------------------------------------ routes
@pytest.fixture
def served_store():
    """A status server over an SLO engine and its store, holding a few
    seeded series; the store's clock is the points' clock."""
    now = [100.0]
    store = port_tsdb.TimeSeriesStore(interval_s=1.0, retention_s=60.0,
                                      coarse_interval_s=10.0,
                                      clock=lambda: now[0])
    for t in range(30):
        for proc in ("parent", "worker-a:1"):
            store.ingest("tpu_miner_hashes_total", 1000.0 * t, t=70.0 + t,
                         labels={"process": proc}, kind="counter")
        store.ingest("tpu_miner_ring_occupancy", t % 3, t=70.0 + t,
                     labels={"process": "parent"})
    slo = port_slo.SloEngine(port_pipeline.PipelineTelemetry(), store=store,
                             clock=lambda: now[0])
    server = port_status.StatusServer(MinerStats(), 0, slo=slo, tsdb=store)
    stop = port_status.serve_status_in_thread(server)
    yield server, store, slo
    stop()


def test_query_route_answers_the_store(served_store):
    server, store, _ = served_store
    code, body = get(server.port, "/query")
    payload = port_tsdb.parse_query_payload(json.loads(body))
    assert code == 200 and payload == json.loads(json.dumps(store.query()))
    code, body = get(server.port, "/query?name=tpu_miner_hashes_total"
                     "&process=worker-a:1&window_s=5")
    series = json.loads(body)["series"]
    assert [s["labels"] for s in series] == [{"process": "worker-a:1"}]
    assert len(series[0]["points"]) == 5  # t >= 100 - 5
    code, body = get(server.port, "/query?prefix=tpu_miner_ring&tier=coarse")
    assert code == 200 and json.loads(body)["tier"] == "coarse"
    for bad, message in (("window_s=abc", "window_s must be a number"),
                         ("window_s=-1", "window_s must be > 0"),
                         ("tier=warm", "unknown tier")):
        code, body = get(server.port, f"/query?{bad}")
        assert code == 400 and message in json.loads(body)["error"]


def test_slo_route_serves_the_cached_report(served_store):
    server, _, slo = served_store
    code, body = get(server.port, "/slo")
    before = json.loads(body)
    assert code == 200 and before["schema"] == "tpu-miner-slo/1"
    assert before["objectives"] == []
    report = slo.evaluate()
    code, body = get(server.port, "/slo")
    assert json.loads(body) == json.loads(json.dumps(report))


@pytest.mark.parametrize("path", ["/query", "/slo"])
def test_routes_survive_an_oversized_request(served_store, path):
    server, _, _ = served_store

    async def main():
        reader, writer = await asyncio.open_connection("127.0.0.1",
                                                       server.port)
        writer.write(b"GET " + path.encode() + b"?" + b"A" * (128 * 1024)
                     + b" HTTP/1.1\r\n\r\n")
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(), 10)
        writer.close()
        return raw

    assert asyncio.run(main()) == b""  # closed in order, no reset
    assert get(server.port, path)[0] == 200


def test_routes_without_an_engine_answer_the_snapshot():
    server = port_status.StatusServer(MinerStats(hashes=7), 0)
    stop = port_status.serve_status_in_thread(server)
    try:
        for path in ("/slo", "/query?name=x"):
            code, body = get(server.port, path)
            assert code == 200 and json.loads(body)["hashes"] == 7
    finally:
        stop()


# ----------------------------------------------------------- observatory
def _args(*argv):
    return cli.build_parser().parse_args(list(argv))


def test_worker_statusport_feeds_the_federator(tmp_path):
    pytest.importorskip("grpc")
    fleet = cli.make_hasher(_args("--bench", "--worker",
                                  "127.0.0.1:1@18000", "--worker",
                                  "127.0.0.1:2"))
    try:
        assert fleet.chip_labels == ["127.0.0.1:1", "127.0.0.1:2"]
        assert fleet.scrape_targets() == [
            ("127.0.0.1:1", "http://127.0.0.1:18000/metrics")]
        args = _args("--pool", "stratum+tcp://127.0.0.1:1",
                     "--health-interval", "30", "--federate",
                     "extra=http://127.0.0.1:9/metrics")
        slo = port_slo.SloEngine(port_pipeline.PipelineTelemetry())
        observatory = cli.make_observatory(args, slo.telemetry, slo,
                                           hasher=fleet)
        try:
            assert [(t.process, t.url, t.labels)
                    for t in observatory.federator.targets()] == [
                ("extra", "http://127.0.0.1:9/metrics", ()),
                ("worker-127.0.0.1:1", "http://127.0.0.1:18000/metrics",
                 (("worker", "127.0.0.1:1"),))]
            assert observatory.interval_s == 30.0
        finally:
            observatory.stop()
    finally:
        fleet.close()
    assert not _threads_left()


@pytest.mark.parametrize("spec", ["noequals", "=http://x", "name="])
def test_bad_federate_specs_are_refused(spec):
    args = _args("--pool", "stratum+tcp://127.0.0.1:1", "--federate", spec)
    slo = port_slo.SloEngine(port_pipeline.PipelineTelemetry())
    with pytest.raises(SystemExit, match="want NAME=URL"):
        cli.make_observatory(args, slo.telemetry, slo)


def test_no_observatory_at_interval_zero():
    args = _args("--pool", "stratum+tcp://127.0.0.1:1", "--health-interval",
                 "0")
    slo = port_slo.SloEngine(port_pipeline.PipelineTelemetry())
    assert cli.make_observatory(args, slo.telemetry, slo) is None


@pytest.mark.parametrize("flag", [
    ["--slo-fast-window", "4"], ["--slo-slow-window", "8"],
    ["--slo-objectives", "x.json"], ["--incident-dir", "d"],
    ["--federate", "a=http://b"]])
def test_bench_refuses_the_observatory_flags(flag):
    with pytest.raises(SystemExit, match="applies only to"):
        cli.bench(_args("--bench", "--device", "cpu", *flag))


# ---------------------------------------------------------------- dashboard
def _dashboard_payload():
    """A query payload with every panel's series: sessions and shares/s
    per process, fleet children at every level, slot burns and accept
    rates, acks/s, a stale series and a dropped count."""
    store = port_tsdb.TimeSeriesStore(interval_s=1.0, retention_s=60.0)
    for t in range(12):
        for proc in ("parent", "shard-0"):
            store.ingest("tpu_miner_frontend_sessions", 3 + t % 2, t=t,
                         labels={"process": proc})
            store.ingest("tpu_miner_frontend_shares_per_s", t * 0.5, t=t,
                         labels={"process": proc})
        for child, level in (("a:1", 0.0), ("b:2", 1.0), ("c:3", 2.0),
                             ("d:4", 3.0)):
            store.ingest("tpu_miner_fleet_child_state", level, t=t,
                         labels={"child": child, "process": "parent"})
            store.ingest("tpu_miner_hashes_total", 1e6 * t, t=t,
                         labels={"process": child}, kind="counter")
        store.ingest("tpu_miner_slo_slot_burn", t / 4, t=t,
                     labels={"objective": "pool-accept-rate",
                             "pool": "p1"})
        store.ingest("slo.slot_accept", 1 - t / 20, t=t,
                     labels={"pool": "p2"})
        store.ingest("tpu_miner_pool_acks_per_s", t, t=t,
                     labels={"process": "parent", "result": "accepted"})
    payload = json.loads(json.dumps(store.query(now=12.0)))
    payload["series"][0]["stale"] = True
    payload["dropped_series"] = 2
    return payload


def test_top_renders_like_the_reference_but_for_fleet_states():
    payload = _dashboard_payload()
    port = port_dashboard.render_top(payload, width=8)
    ref = ref_dashboard.render_top(payload, width=8)
    # The reference's table swaps probing (2) and quarantined (3).
    swap = {"quarantined ": "probing     ", "probing     ": "quarantined "}
    fixed = "\n".join(
        "".join(swap.get(line[i:i + 12], line[i:i + 12]) if i == 23
                else line[i] for i in range(len(line))
                if i == 23 or not 23 < i < 35)
        if line.startswith("  c:3") or line.startswith("  d:4") else line
        for line in ref.split("\n"))
    assert port == fixed
    assert "c:3                  probing" in port
    assert "d:4                  quarantined" in port
    assert port.startswith("tpu-miner top — ")
    assert "[2 dropped at the store bound]" in port
    assert port_dashboard.render_top(
        {"series": []}) == ref_dashboard.render_top({"series": []})
    for values in ([], [1.0], [1.0, 1.0], [0.0, 1.0, 5.0, 2.0]):
        assert port_dashboard.sparkline(values) == \
            ref_dashboard.sparkline(values)


def test_top_once_against_a_status_server(served_store, capsys):
    server, _, _ = served_store
    url = f"http://127.0.0.1:{server.port}"
    rc = cli.main(["top", "--status-url", url, "--once", "--window", "20"])
    out = capsys.readouterr().out
    assert rc == 0 and out.startswith("tpu-miner top — 3 series")
    assert port_dashboard.fetch_query(url, 5.0)["window_s"] == 5.0
    rc = cli.main(["top", "--status-url", "http://127.0.0.1:9", "--once"])
    assert rc == 2 and "cannot fetch /query" in capsys.readouterr().err


# ------------------------------------------------------------- end to end
def _pool_job(job_id="obs"):
    return port_pool.PoolJob(
        job_id=job_id, prevhash_internal=sha256d(b"observatory prev"),
        coinb1=bytes.fromhex("01000000") + b"\x11" * 30,
        coinb2=b"\x22" * 30 + bytes.fromhex("00000000"),
        merkle_branch=[sha256d(b"tx1")], version=0x20000000,
        nbits=0x1D00FFFF, ntime=0x655F2B2C)


def _breach_objectives(tmp_path):
    path = tmp_path / "objectives.json"
    path.write_text(json.dumps({
        "schema": "tpu-miner-slo-objectives/1",
        "objectives": [{"name": "submit-rtt-1us", "kind": "latency",
                        "target": 0.99, "threshold_s": 1e-6,
                        "signal": "tpu_miner_submit_rtt_seconds"}]}))
    return str(path)


async def _until(task, done, seconds=90):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + seconds
    while not done():
        assert not task.done(), task
        assert loop.time() < deadline, "timed out"
        await asyncio.sleep(0.05)


def test_session_breaches_its_objective_and_captures(tmp_path, capsys,
                                                     fresh_default):
    port = free_port()
    incidents = tmp_path / "incidents"
    args = _args(
        "--pool", "stratum+tcp://127.0.0.1:1", "--device", "cpu",
        "--batch-bits", "12", "--workers", "2", "--status-port", str(port),
        "--flightrec-out", str(tmp_path / "fr.json"),
        "--health-interval", "0.25", "--slo-fast-window", "2",
        "--slo-slow-window", "6", "--slo-objectives",
        _breach_objectives(tmp_path), "--incident-dir", str(incidents),
        "--report-interval", "0.5")
    seen = {}

    async def main():
        pool = port_pool.MockStratumPool(difficulty=EASY_DIFF)
        await pool.start()
        await pool.announce_job(_pool_job())
        args.pool = [f"stratum+tcp://127.0.0.1:{pool.port}"]
        miner = cli.make_miner(args)
        task = asyncio.create_task(cli.run_session(miner, args))
        loop = asyncio.get_running_loop()

        def slo_state():
            code, body = get(port, "/slo")
            report = json.loads(body)
            seen["slo"] = report
            return [s["state"] for s in report["objectives"]]

        try:
            await _until(task, lambda: _threads_left() == list(THREADS)
                         or sorted(_threads_left()) == sorted(THREADS))
            deadline = loop.time() + 90
            while "breach" not in await loop.run_in_executor(None,
                                                             slo_state):
                assert not task.done() and loop.time() < deadline, seen
                await asyncio.sleep(0.25)
            await asyncio.sleep(0.6)  # a watchdog tick after the breach
            seen["healthz"] = await loop.run_in_executor(
                None, get, port, "/healthz")
            seen["query"] = await loop.run_in_executor(
                None, get, port, "/query?name=tpu_miner_scan_batch_seconds"
                "_count&process=parent")
            seen["top"] = await loop.run_in_executor(
                None, cli.main, ["top", "--status-url",
                                 f"http://127.0.0.1:{port}", "--once"])
            seen["top_out"] = capsys.readouterr().out
            seen["slo_rc"] = await loop.run_in_executor(
                None, cli.main, ["slo", "--status-url",
                                 f"http://127.0.0.1:{port}"])
        finally:
            miner.stop()
            await asyncio.gather(task, return_exceptions=True)
            await pool.stop()
        task.result()
        return miner

    miner = asyncio.run(asyncio.wait_for(main(), 180))
    assert not _threads_left()
    objective = seen["slo"]["objectives"][0]
    assert objective["name"] == "submit-rtt-1us"
    assert objective["state"] == "breach" and objective["burn_fast"] >= 10
    code, body = seen["healthz"]
    health = json.loads(body)
    assert code == 200 and health["components"]["slo"]["state"] == \
        "degraded"
    series = json.loads(seen["query"][1])["series"]
    assert len(series) == 1 and len(series[0]["points"]) >= 3
    assert seen["top"] == 0 and seen["top_out"].startswith("tpu-miner top")
    assert seen["slo_rc"] == 1
    bundles = [d for d in os.listdir(incidents) if d.startswith("pl-")]
    assert len(bundles) == 1
    manifest = json.loads((incidents / bundles[0] / "incident.json")
                          .read_text())
    assert manifest["schema"] == "tpu-miner-incident/1"
    assert manifest["errors"] == []
    rows = port_ledger.load_rows(str(incidents / "incident_ledger.jsonl"))
    assert [r.row_id for r in rows] == [manifest["ledger_id"]]
    assert rows[0].raw["objective"] == "submit-rtt-1us"
    for name in ("slo", "series", "flightrec", "lifecycle", "telemetry",
                 "healthz", "metrics"):
        assert os.path.exists(manifest["artifacts"][name]), name
    tel = miner.dispatcher.telemetry
    assert not tel.flightrec._armed
    assert {k: c.value for k, c in tel.incidents.children()} == {
        ("submit-rtt-1us",): 1.0}
    assert tel.tsdb_series.value > 10


def _serve_worker_in_thread(monkeypatch, argv):
    """``cmd_serve_hasher`` on a thread, its gRPC server captured so the
    test can stop it as SIGTERM would."""
    from bitcoin_miner_tpu_torch.rpc import hasher_service

    served = []
    real = hasher_service.serve

    def serve(*a, **kw):
        server, port = real(*a, **kw)
        served.append((server, port))
        return server, port

    monkeypatch.setattr(hasher_service, "serve", serve)
    result = []
    thread = threading.Thread(
        target=lambda: result.append(cli.cmd_serve_hasher(_args(*argv))),
        name="served-worker", daemon=True)
    thread.start()
    deadline = time.monotonic() + 60
    while not served:
        assert thread.is_alive() and time.monotonic() < deadline
        time.sleep(0.05)
    return served[0], thread, result


def test_served_worker_stops_its_observatory(tmp_path, monkeypatch,
                                            fresh_default):
    pytest.importorskip("grpc")
    status = free_port()
    (server, _), thread, result = _serve_worker_in_thread(monkeypatch, [
        "--serve-hasher", "127.0.0.1:0", "--device", "cpu", "--batch-bits",
        "12", "--status-port", str(status), "--health-interval", "0.1",
        "--incident-dir", str(tmp_path / "inc"), "--flightrec-out",
        str(tmp_path / "fr.json")])
    try:
        deadline = time.monotonic() + 30
        while sorted(_threads_left()) != sorted(THREADS):
            assert time.monotonic() < deadline, _threads_left()
            time.sleep(0.05)
        deadline = time.monotonic() + 30
        while True:
            try:
                code, body = get(status, "/query?process=parent")
                if code == 200 and json.loads(body)["series"]:
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline
            time.sleep(0.1)
        code, body = get(status, "/slo")
        assert code == 200 and json.loads(body)["schema"] == \
            "tpu-miner-slo/1"
    finally:
        server.stop(grace=0)
        thread.join(timeout=30)
    assert not thread.is_alive() and result == [0]
    assert not _threads_left()
    assert not port_pipeline.get_telemetry().flightrec._armed


def test_bench_disarms_its_flight_recorder(tmp_path, fresh_default):
    """A command disarms the recorder it armed: a later crash in the same
    process does not dump into the command's ``--flightrec-out``."""
    hooks = (sys.excepthook, threading.excepthook)
    out = cli.bench(_args("--bench", "--device", "cpu", "--batch-bits", "12",
                          "--bench-nonces", "4096", "--flightrec-out",
                          str(tmp_path / "fr.json")))
    assert out["hashes"] == 4096
    assert (sys.excepthook, threading.excepthook) == hooks
    assert not port_pipeline.get_telemetry().flightrec._armed


def test_parent_federates_a_served_workers_series(tmp_path, fresh_default):
    """A served worker process with ``--status-port`` and a parent
    session with ``--worker HOST:PORT@STATUSPORT``: the parent's
    ``/query`` holds the worker's series under ``worker=HOST:PORT``."""
    pytest.importorskip("grpc")
    grpc_port, status, parent_status = free_port(), free_port(), free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "bitcoin_miner_tpu_torch", "--serve-hasher",
         f"127.0.0.1:{grpc_port}", "--device", "cpu", "--batch-bits", "12",
         "--status-port", str(status), "--health-interval", "0.5",
         "--incident-dir", str(tmp_path / "worker-inc"),
         "--flightrec-out", str(tmp_path / "worker-fr.json")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    label = f"127.0.0.1:{grpc_port}"
    args = _args(
        "--pool", "stratum+tcp://127.0.0.1:1", "--worker",
        f"{label}@{status}", "--workers", "2", "--batch-bits", "12",
        "--status-port", str(parent_status), "--health-interval", "0.5",
        "--incident-dir", str(tmp_path / "inc"),
        "--flightrec-out", str(tmp_path / "fr.json"))
    found = {}

    async def main():
        pool = port_pool.MockStratumPool(difficulty=EASY_DIFF)
        await pool.start()
        await pool.announce_job(_pool_job("fed"))
        args.pool = [f"stratum+tcp://127.0.0.1:{pool.port}"]
        miner = cli.make_miner(args)
        task = asyncio.create_task(cli.run_session(miner, args))
        loop = asyncio.get_running_loop()

        def worker_series():
            code, body = get(parent_status, f"/query?worker={label}")
            names = {s["name"] for s in json.loads(body)["series"]}
            found["names"] = names
            return "tpu_miner_scan_batch_seconds_count" in names

        try:
            await _until(task, lambda: miner.dispatcher.stats
                         .shares_accepted >= 1, 120)
            deadline = loop.time() + 60
            while not await loop.run_in_executor(None, worker_series):
                assert loop.time() < deadline, found
                await asyncio.sleep(0.25)
            found["worker_query"] = await loop.run_in_executor(
                None, get, status, "/query?process=parent")
        finally:
            miner.stop()
            await asyncio.gather(task, return_exceptions=True)
            await pool.stop()
            miner.dispatcher.hasher.close()

    try:
        asyncio.run(asyncio.wait_for(main(), 240))
    finally:
        proc.terminate()
        output = proc.communicate(timeout=60)[0]
    assert proc.returncode == 0, output
    assert "tpu_miner_federate_scrapes_total" not in found["names"]
    series = json.loads(found["worker_query"][1])["series"]
    assert {s["labels"]["process"] for s in series} == {"parent"}
    assert not _threads_left()
