"""The reader of the card's trace (``probes/trace_report.py``), which stands
in place of the reference's xplane reader (``benchmarks/trace_report.py``,
spec ``tests/test_trace_report.py``), and ``perf capture``, the
counterpart of the reference's ``perf_cli.run_capture``.

The reader runs on Chrome traces written here in ``torch.profiler``'s
shape (nested self time, kernel families from mangled and demangled
names, the busy share of the profiler's window over two streams, gaps
labelled by the host range that overlaps them, else a runtime call, else
nothing) and on a real CPU-only ``torch.profiler`` trace of the plain
scan; a missing directory is a structured error with rc 1. The profiler's
host ranges open only while a profile is armed. ``perf capture`` runs a
2^12-nonce bench on the CPU (its manifest, its ledger row under the
manifest's id, its rc the bench's, also when the bench fails). Every file
is in ``tmp_path``."""

import json
import os
import subprocess
import sys

import pytest

from bitcoin_miner_tpu_torch import cli, perf_cli
from bitcoin_miner_tpu_torch.backends.cuda import TileCudaHasher
from bitcoin_miner_tpu_torch.probes import trace_report
from bitcoin_miner_tpu_torch.telemetry import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TILE = ("void (anonymous namespace)::scan_tile_kernel<1, 1, 1, true>("
        "unsigned int const*, int*, unsigned int*, unsigned int, "
        "(anonymous namespace)::LaunchMin)")
RESCAN = ("(anonymous namespace)::rescan_steps_kernel(unsigned int const*, "
          "int, int const*, unsigned int, int, int, int, unsigned int*)")
HITBUF = "void (anonymous namespace)::scan_hitbuf_kernel<2, true>(int)"


def _event(name, ts, dur, cat="kernel", pid=0, tid=7, **extra):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, **extra}


def _write(tmp_path, events, props=True, name="bench.1.pt.trace.json"):
    trace = {"schemaVersion": 1, "traceEvents": events}
    if props:
        trace["deviceProperties"] = [{"id": 0, "name": "NVIDIA H100 test"}]
    path = tmp_path / name
    path.write_text(json.dumps(trace))
    return str(path)


class TestSelfTime:
    def test_nested_events_subtract_children(self, tmp_path):
        """outer[0..100] { childA[10..40], childB[50..90] }, flat[120..150]
        on one line: self times 30, 30, 40, 30."""
        _write(tmp_path, [
            _event(TILE, 0, 100), _event(RESCAN, 10, 30),
            _event(HITBUF, 50, 40),
            _event("Memcpy HtoD (Pinned -> Device)", 120, 30,
                   cat="gpu_memcpy")])
        rc, rec = trace_report.run(str(tmp_path))
        assert rc == 0
        fams = rec["device"]["families"]
        assert {f: v["ms"] * 1e3 for f, v in fams.items()} == pytest.approx(
            {"scan_tile": 30, "rescan_steps": 30, "scan_hitbuf": 40,
             "memcpy": 30})
        assert all(v["launches"] == 1 for v in fams.values())
        assert rec["device"]["busy_ms"] * 1e3 == pytest.approx(130)

    def test_self_times_of_one_line(self):
        events = [_event("a", 0, 100), _event("b", 10, 30),
                  _event("c", 15, 5), _event("d", 200, 10)]
        got = {ev["name"]: t for ev, t in trace_report.self_times(events)}
        assert got == {"a": 70, "b": 25, "c": 5, "d": 10}

    def test_find_traces_recurses(self, tmp_path):
        sub = tmp_path / "plugins" / "profile" / "x"
        sub.mkdir(parents=True)
        (sub / "w.1.pt.trace.json").write_text("{}")
        (sub / "other.json").write_text("{}")
        assert trace_report.find_traces(str(tmp_path)) == [
            str(sub / "w.1.pt.trace.json")]


class TestFamilies:
    @pytest.mark.parametrize("name,family", [
        (TILE, "scan_tile"),
        ("_ZN12_GLOBAL__N_116scan_tile_kernelILi1ELi1ELi1ELb1EEEvPKjPiPjjNS"
         "_9LaunchMinE", "scan_tile"),
        ("void (anonymous namespace)::scan_tile_staged_kernel<2, 1, 2, "
         "false>(unsigned int const*)", "scan_tile"),
        ("scan_tile_param_kernel<true>", "scan_tile"),
        (RESCAN, "rescan_steps"),
        ("_ZN12_GLOBAL__N_119rescan_steps_kernelEPKjiPKijiiiPj",
         "rescan_steps"),
        (HITBUF, "scan_hitbuf"),
        ("void int_probe_kernel<16>(int*, int, int)", "int_probe"),
        ("void at::native::vectorized_elementwise_kernel<4, "
         "at::native::FillFunctor<int>>(int)", "other"),
    ])
    def test_kernel_names(self, name, family):
        assert trace_report.family({"cat": "kernel", "name": name}) == family

    def test_copies_and_sets(self):
        assert trace_report.family({"cat": "gpu_memcpy",
                                    "name": "scan_tile?"}) == "memcpy"
        assert trace_report.family({"cat": "gpu_memset",
                                    "name": "Memset"}) == "memset"


class TestWindowAndGaps:
    def _trace(self, tmp_path, host):
        """The profiler's window 0..1000 µs; stream 7: tile 100..300,
        tile 310..500, rescan on stream 14 at 450..480, tile 800..900:
        gaps 500..800 (300 µs) and 300..310 (10 µs)."""
        return _write(tmp_path, [
            _event("PyTorch Profiler (0)", 0, 1000, cat="Trace",
                   pid="Spans", tid="PyTorch Profiler"),
            _event(TILE, 100, 200), _event(TILE, 310, 190),
            _event(RESCAN, 450, 30, tid=14), _event(TILE, 800, 100),
            _event("aten::empty", 0, 1000, cat="cpu_op", pid=9, tid=9),
            *host])

    def test_busy_share_over_streams_and_window(self, tmp_path):
        self._trace(tmp_path, [])
        rc, rec = trace_report.run(str(tmp_path))
        dev = rec["device"]
        assert rc == 0 and rec["window_ms"] == 1.0
        assert dev["busy_ms"] == pytest.approx(0.49)  # the rescan overlaps
        assert dev["busy_share"] == pytest.approx(0.49)
        assert dev["span_ms"] == pytest.approx(0.8)
        assert dev["families"]["scan_tile"] == {
            "launches": 3, "ms": 0.49, "mean_ms": pytest.approx(0.16333, 1e-3),
            "share": 0.49}
        assert rec["device_name"] == "NVIDIA H100 test"

    def test_gaps_labelled_by_annotation_then_runtime_then_nothing(
            self, tmp_path):
        self._trace(tmp_path, [
            _event("ring_collect", 490, 100, cat="user_annotation", pid=9,
                   tid=9),
            _event("device_dispatch", 600, 150, cat="user_annotation",
                   pid=9, tid=9),
            _event("cudaEventSynchronize", 500, 290, cat="cuda_runtime",
                   pid=9, tid=9),
            _event("cudaLaunchKernel", 301, 5, cat="cuda_runtime", pid=9,
                   tid=9)])
        rc, rec = trace_report.run(str(tmp_path))
        gaps = rec["device"]["gaps"]
        assert [g["ms"] for g in gaps] == [0.3, 0.01]
        assert gaps[0]["host"] == "device_dispatch"  # 150 µs of 300
        assert gaps[0]["host_source"] == "user_annotation"
        assert (gaps[0]["after"], gaps[0]["before"]) == ("scan_tile",
                                                         "scan_tile")
        assert gaps[0]["at_ms"] == pytest.approx(0.4)
        assert gaps[1]["host"] == "cudaLaunchKernel"
        assert gaps[1]["host_source"] == "cuda_runtime"
        assert rec["host_annotations"] == {
            "device_dispatch": {"count": 1, "ms": 0.15},
            "ring_collect": {"count": 1, "ms": 0.1}}

    def test_gap_without_host_event(self, tmp_path):
        self._trace(tmp_path, [])
        gaps = trace_report.run(str(tmp_path))[1]["device"]["gaps"]
        assert [(g["ms"], g["host"], g["host_source"]) for g in gaps] == [
            (0.3, trace_report.NO_HOST_EVENT, None),
            (0.01, trace_report.NO_HOST_EVENT, None)]

    def test_markdown_and_evidence(self, tmp_path):
        self._trace(tmp_path, [])
        md, evidence = tmp_path / "r.md", tmp_path / "e.jsonl"
        rc, rec = trace_report.run(str(tmp_path), md_out=str(md),
                                   evidence=str(evidence))
        text = md.read_text()
        assert "| scan_tile | 3 | 0.49 |" in text and "NVIDIA H100" in text
        row = json.loads(evidence.read_text())
        assert row["device"] == rec["device"] and "measured" in row


class TestCli:
    def test_missing_dir_is_structured_error_rc1(self, tmp_path):
        proc = subprocess.run(
            [sys.executable, "-m", "bitcoin_miner_tpu_torch.probes."
             "trace_report", str(tmp_path / "nope")],
            capture_output=True, text=True, cwd=REPO)
        assert proc.returncode == 1
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        assert "error" in out and out["metric"] == "trace_report"

    def test_unreadable_and_empty_traces(self, tmp_path):
        (tmp_path / "a.pt.trace.json").write_text("{not json")
        rc, rec = trace_report.run(str(tmp_path))
        assert rc == 1 and "error" in rec and rec["traces"]
        (tmp_path / "a.pt.trace.json").write_text('{"traceEvents": []}')
        rc, rec = trace_report.run(str(tmp_path))
        assert rc == 1 and rec["error"] == "traces parsed but empty"

    def test_main_prints_one_line_and_markdown(self, tmp_path, capsys):
        _write(tmp_path, [_event(TILE, 0, 10)])
        assert trace_report.main([str(tmp_path), "--md"]) == 0
        out = capsys.readouterr().out
        assert json.loads(out.splitlines()[0])["n_traces"] == 1
        assert "### Card trace" in out


def test_real_cpu_profile_of_the_plain_scan(tmp_path):
    """A CPU-only torch.profiler trace: it parses, the device section is
    present and empty, and the ring's host ranges are in it."""
    hasher = TileCudaHasher(batch_size=1 << 10, device="cpu")
    with tracing.profile_pipeline(cuda=False) as prof:
        out = cli.run_bench(hasher, 1 << 11, batch_size=1 << 10)
    prof.export_chrome_trace(str(tmp_path / "cpu.1.pt.trace.json"))
    rc, rec = trace_report.run(str(tmp_path))
    assert rc == 0 and out["verified"]
    assert rec["device"] == {
        "events": 0, "busy_ms": 0.0, "busy_share": 0.0, "span_ms": 0.0,
        "busy_share_of_span": None, "families": {}, "top_kernels": [],
        "gaps": []}
    assert rec["device_name"] is None and rec["window_ms"] > 0
    assert rec["host_annotations"]["device_dispatch"]["count"] == 2
    assert rec["host_annotations"]["ring_collect"]["count"] == 2


def _job():
    """A Stratum job at an easy share difficulty (~2^-8 per nonce)."""
    from bitcoin_miner_tpu_torch.core.target import difficulty_to_target
    from bitcoin_miner_tpu_torch.miner.job import Job

    return Job(
        job_id="p1", prevhash_internal=bytes(range(32)),
        coinb1=bytes.fromhex("01000000") + b"\x11" * 30,
        coinb2=b"\x22" * 30 + bytes.fromhex("00000000"),
        merkle_branch=[], version=0x20000000, nbits=0x1D00FFFF,
        ntime=0x655F2B2C, extranonce1=b"\x00\x00\x00\x01",
        extranonce2_size=1,
        share_target=difficulty_to_target(1 / (1 << 24)), clean=True)


def test_session_host_ranges_in_a_cpu_profile(tmp_path):
    """A dispatcher session on the plain tile scan under the profiler,
    its shares through a handler wrapped as the miners' are: the
    pipeline's five host ranges are in the trace."""
    import asyncio

    from bitcoin_miner_tpu_torch.miner import multipool, runner
    from bitcoin_miner_tpu_torch.miner.dispatcher import Dispatcher

    for miner in (runner.StratumMiner, runner.GbtMiner, runner.GetworkMiner,
                  multipool.MultipoolMiner):
        assert miner._on_share.__wrapped__  # each miner's submit is a range
    got = []

    @runner._submit_range
    async def on_share(self, share):
        await asyncio.sleep(0)
        got.append(share)

    async def session():
        d = Dispatcher(TileCudaHasher(batch_size=1 << 10, device="cpu"),
                       n_workers=1, batch_size=1 << 10)
        run = asyncio.create_task(d.run(lambda share: on_share(None, share)))
        d.set_job(_job())
        try:
            deadline = asyncio.get_running_loop().time() + 60
            while len(got) < 2:
                assert asyncio.get_running_loop().time() < deadline
                await asyncio.sleep(0.05)
        finally:
            d.stop()
            await asyncio.gather(run, return_exceptions=True)

    with tracing.profile_pipeline(cuda=False) as prof:
        asyncio.run(session())
    prof.export_chrome_trace(str(tmp_path / "s.1.pt.trace.json"))
    notes = trace_report.run(str(tmp_path))[1]["host_annotations"]
    assert {"feeder_slice", "device_dispatch", "ring_collect", "cpu_verify",
            "submit"} <= set(notes), notes
    assert notes["submit"]["count"] >= 2


def test_host_ranges_open_only_while_profiling():
    assert tracing.host_range("device_dispatch") is tracing._NULL_SPAN
    with tracing.profile_pipeline(cuda=False):
        rng = tracing.host_range("device_dispatch")
        assert rng is not tracing._NULL_SPAN and rng.name == "device_dispatch"
    assert tracing.host_range("submit") is tracing._NULL_SPAN


# ----------------------------------------------------------- perf capture
BENCH = ["--device", "cpu", "--sweep-bits", "12", "--batch-bits", "10"]


def _capture(tmp_path, capsys, bench_args, extra=()):
    ledger = tmp_path / "ledger.jsonl"
    rc = cli.main(["perf", "capture", "--out", str(tmp_path / "cap"),
                   "--ledger", str(ledger), *extra, "--", *bench_args])
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1])
    with open(summary["manifest"]) as f:
        manifest = json.load(f)
    rows = ([json.loads(r) for r in ledger.read_text().splitlines()]
            if ledger.exists() else [])
    return rc, summary, manifest, rows


def test_capture_of_a_small_bench(tmp_path, capsys):
    evidence = tmp_path / "evidence.jsonl"
    rc, summary, manifest, rows = _capture(
        tmp_path, capsys, BENCH, ["--evidence", str(evidence)])
    assert rc == 0 and summary["metric"] == "window_capture"
    assert summary["ok"] is True and summary["errors"] == []
    assert manifest["schema"] == "tpu-miner-capture/1"
    assert manifest["errors"] == [] and manifest["bench_rc"] == 0
    assert summary["ledger_id"] == manifest["ledger_id"]
    assert [r["id"] for r in rows] == [manifest["ledger_id"]]
    assert rows[0]["rc"] == 0 and rows[0]["fingerprint"]["platform"] == "cpu"
    outdir = os.path.dirname(summary["manifest"])
    assert os.path.basename(outdir) == manifest["ledger_id"]
    assert rows[0]["artifacts"] == manifest["artifacts"] == {
        "dir": outdir, "trace": os.path.join(outdir, "trace.json"),
        "profile": os.path.join(outdir, "profile"),
        "trace_report_md": os.path.join(outdir, "trace_report.md")}
    bench_line = manifest["bench"]
    assert bench_line["metric"] == "sha256d_scan" and bench_line["value"] > 0
    report = manifest["trace_report"]
    assert report["device"]["events"] == 0
    assert report["host_annotations"]["device_dispatch"]["count"] == (
        bench_line["dispatches"])
    kinds = [json.loads(r)["metric"] for r in evidence.read_text().split(
        "\n") if r]
    assert sorted(kinds) == ["sha256d_scan", "trace_report"]


def test_capture_rc_mirrors_a_failed_bench(tmp_path, capsys):
    rc, summary, manifest, rows = _capture(
        tmp_path, capsys, [*BENCH, "--variant", "nope"])
    assert rc == 1 and manifest["bench_rc"] == 1 and summary["ok"] is False
    assert manifest["bench"]["value"] == 0
    assert "profile" not in manifest["artifacts"]
    assert [r["id"] for r in rows] == [manifest["ledger_id"]]
    assert rows[0]["rc"] == 1


@pytest.mark.parametrize("stdout,bench_rc,rc,note", [
    ('{"metric": "sha256d_scan", "value": 0.0, "error": "genesis"}\n', 2, 2,
     None),
    ("Traceback: something\n", 1, 1, "bench printed no JSON line"),
    ("", -9, 1, "bench printed no JSON line"),
])
def test_capture_rc_is_the_benchs(tmp_path, capsys, monkeypatch, stdout,
                                  bench_rc, rc, note):
    seen = []

    def fake_run(cmd, **kw):
        seen.append(cmd)
        return subprocess.CompletedProcess(cmd, bench_rc, stdout, "boom")

    monkeypatch.setattr(perf_cli.subprocess, "run", fake_run)
    got, summary, manifest, rows = _capture(tmp_path, capsys, ["--vshare",
                                                               "2"])
    assert got == rc and summary["ok"] is False
    assert seen[0][:3] == [sys.executable, "-m",
                           "bitcoin_miner_tpu_torch.bench"]
    assert seen[0][-2:] == ["--vshare", "2"] and "--profile" in seen[0]
    if note:
        assert any(e.startswith(note) for e in manifest["errors"])
        assert rows == []
    else:
        assert manifest["errors"] == [] and rows[0]["rc"] == 2


def test_capture_snapshots_a_status_surface(tmp_path, capsys, monkeypatch):
    def fake_run(cmd, **kw):
        return subprocess.CompletedProcess(
            cmd, 0, '{"metric": "sha256d_scan", "value": 1.0}\n', "")

    def fake_fetch(url, path, timeout=5.0):
        route = url.rsplit("/", 1)[1]
        if route == "healthz":
            return False
        body = ({"exemplars": {"submit_rtt": [
            {"value": v, "ts": 1, "trace": "t", "key": f"k{v}", "x": 0}
            for v in (0.1, 0.5, 0.3, 0.2)]}} if route == "lifecycle"
            else {})
        with open(path, "w") as f:
            json.dump(body, f)
        return True

    monkeypatch.setattr(perf_cli.subprocess, "run", fake_run)
    monkeypatch.setattr(perf_cli, "_fetch_url", fake_fetch)
    rc, summary, manifest, rows = _capture(
        tmp_path, capsys, [], ["--status-url", "http://127.0.0.1:1/"])
    assert rc == 0 and manifest["errors"] == ["snapshot of /healthz failed"]
    assert {"metrics", "flightrec", "telemetry", "lifecycle"} <= set(
        manifest["artifacts"])
    assert [x["value"] for x in manifest["exemplars"]["submit_rtt"]] == [
        0.5, 0.3, 0.2]
    assert manifest["exemplars"]["submit_rtt"][0] == {
        "value": 0.5, "ts": 1, "trace": "t", "key": "k0.5"}


def test_capture_snapshots_a_live_status_server(tmp_path, capsys,
                                                 monkeypatch):
    """The port's status server on a loop of its own thread: every route
    of the capture is fetched over HTTP, and the lifecycle's exemplars,
    highest first, are lifted into the manifest."""
    import asyncio
    import threading

    from bitcoin_miner_tpu_torch.miner.dispatcher import MinerStats
    from bitcoin_miner_tpu_torch.telemetry import (
        HealthModel,
        PipelineTelemetry,
    )
    from bitcoin_miner_tpu_torch.utils.status import StatusServer

    tel = PipelineTelemetry()
    for i, rtt in enumerate((0.002, 0.009, 0.004, 0.001)):
        tel.lifecycle.exemplar("tpu_miner_submit_rtt_seconds", rtt,
                               trace="t1", key=f"k{i}")
    stats = MinerStats(telemetry=tel)
    server = StatusServer(stats, port=0, registry=tel.registry,
                          telemetry=tel, health=HealthModel(tel, stats=stats))
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    asyncio.run_coroutine_threadsafe(server.start(), loop).result(30)
    monkeypatch.setattr(perf_cli.subprocess, "run", lambda cmd, **kw: (
        subprocess.CompletedProcess(
            cmd, 0, '{"metric": "sha256d_scan", "value": 1.0}\n', "")))
    try:
        rc, summary, manifest, rows = _capture(
            tmp_path, capsys, [],
            ["--status-url", f"http://127.0.0.1:{server.port}/"])
    finally:
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)
        loop.close()
    assert rc == 0 and manifest["errors"] == [], manifest["errors"]
    arts = manifest["artifacts"]
    assert set(perf_cli.CAPTURE_ROUTES) <= set(arts)
    assert "tpu_miner_" in open(arts["metrics"]).read()
    assert json.load(open(arts["healthz"]))["status"] == "ok"
    assert json.load(open(arts["flightrec"]))["schema"] == (
        "tpu-miner-flightrec/1")
    assert [x["key"] for x in manifest["exemplars"][
        "tpu_miner_submit_rtt_seconds"]] == ["k1", "k2", "k0"]
    assert rows[0]["artifacts"] == arts


def test_capture_defaults_under_build():
    rel = os.path.relpath(perf_cli.DEFAULT_CAPTURES, REPO)
    assert rel == os.path.join("build", "captures")
    assert perf_cli.build_parser().parse_args(["capture"]).out == (
        perf_cli.DEFAULT_CAPTURES)
