"""The PyTorch package's bench (``python -m bitcoin_miner_tpu_torch.bench``)
against the reference's root ``bench.py``: the same line extraction, the
reference's line keys without its TPU ones and with ``device``, the rc
contract (0 measured, 2 the parity gate, never retried or masked, 1
anything else with ``value`` 0, and no fallback to another backend), and
an in-process run on the CPU with the same hits as the reference's sweep
on its ``cpu`` hasher. No test starts a bench child or a compiler: the
supervisor's attempts are monkeypatched, and in-process runs use
``--device cpu`` or a host backend. Every file the runs write is in
``tmp_path``; the flight recorder is armed only where a test names a path
there."""

import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench as ref_bench  # noqa: E402
from bitcoin_miner_tpu.backends.base import get_hasher as ref_get  # noqa: E402
from bitcoin_miner_tpu.miner.scheduler import (  # noqa: E402
    stream_sweep as ref_stream_sweep,
)
from bitcoin_miner_tpu_torch import bench, cli  # noqa: E402
from bitcoin_miner_tpu_torch.core.header import (  # noqa: E402
    GENESIS_HEADER_HEX,
    GENESIS_NBITS,
    GENESIS_NONCE,
)
from bitcoin_miner_tpu_torch.core.target import nbits_to_target  # noqa: E402
from bitcoin_miner_tpu_torch.probes import trace_report  # noqa: E402
from bitcoin_miner_tpu_torch.telemetry import get_telemetry  # noqa: E402
from bitcoin_miner_tpu_torch.telemetry import (  # noqa: E402
    pipeline as port_pipeline,
)

#: a small in-process bench of the tile hasher's plain version.
CPU_ARGV = ["--device", "cpu", "--sweep-bits", "12", "--batch-bits", "10"]
TPU_ONLY_KEYS = {"vs_baseline", "pool", "best_measured_tpu"}


def _args(argv):
    args = bench.build_parser().parse_args(argv)
    if args.scheduler is None:
        args.scheduler = "fixed" if args.batch_bits is not None else "adaptive"
    return args


def _line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


# ------------------------------------------------------------ the line
@pytest.mark.parametrize("stdout", [
    "\n".join([json.dumps({"metric": "sha256d_scan", "value": 1.0}), "noise",
               json.dumps({"metric": "sha256d_scan", "value": 2.0})]),
    "\n".join([json.dumps({"metric": "sha256d_scan", "value": 3.0}),
               json.dumps({"other": 1}), "{broken"]),
    b"", b'{"metric": "m", "value": 1}', None, "no json at all",
    '{"value": 5}\n  {"metric": "x", "value": 6}  \n',
])
def test_extract_json_is_the_references(stdout):
    assert bench._extract_json(stdout) == ref_bench._extract_json(stdout)


def test_line_keys_are_the_references_less_the_tpu_ones(capsys):
    ref_keys = set(ref_bench.result_json(250.0, "tpu"))
    assert bench.main(CPU_ARGV) == 0
    line = _line(capsys)
    assert (ref_keys - TPU_ONLY_KEYS) | {"device"} <= set(line)
    assert not TPU_ONLY_KEYS & set(line)
    assert line["metric"] == "sha256d_scan" and line["unit"] == "MH/s"
    assert line["backend"] == "cuda-tile" and line["device"] == "cpu"
    assert line["verified"] is True and line["value"] > 0
    for key in ("scheduler", "dispatches", "batch_nonces_min",
                "batch_nonces_max", "pipeline", "launches"):
        assert key in line
    assert line["scheduler"] == "fixed" and line["dispatches"] == 4
    assert line["batch_nonces_min"] == line["batch_nonces_max"] == 1 << 10
    assert line["launches"] == {}  # the plain versions launch nothing
    assert "error" not in line["pipeline"], line["pipeline"]
    # The geometry read back from the hasher: the clamped step.
    assert (line["sublanes"], line["inner_tiles"], line["vshare"]) == (8, 1, 1)
    assert not set(ref_bench.result_json(0.0, "x", error="e")) - {
        "vs_baseline"} - set(bench.result_json(0.0, "x", error="e"))


def test_value_counts_every_chain(capsys):
    assert bench.main([*CPU_ARGV, "--vshare", "2"]) == 0
    line = _line(capsys)
    assert line["vshare"] == 2 and line["nonces"] == 1 << 12
    assert line["value"] == pytest.approx(
        2 * line["nonces"] / line["seconds"] / 1e6, rel=1e-3)


def test_same_hits_as_the_references_sweep(capsys):
    """2^12 nonces around the genesis nonce: the port's plain tile scan in
    the bench, the reference's ``cpu`` hasher in its ``stream_sweep``."""
    assert bench.main(CPU_ARGV) == 0
    line = _line(capsys)
    header76 = bytes.fromhex(GENESIS_HEADER_HEX)[:76]
    count = 1 << 12
    ref = ref_stream_sweep(ref_get("cpu"), header76,
                           GENESIS_NONCE - count // 2, count,
                           nbits_to_target(GENESIS_NBITS),
                           batch_size=1 << 10)
    assert line["hits"] == sorted(ref.nonces) and GENESIS_NONCE in ref.nonces
    assert line["dispatches"] == ref.dispatches
    assert (line["batch_nonces_min"], line["batch_nonces_max"]) == (
        ref.min_count, ref.max_count)


def test_native_backend_runs_in_process_under_its_own_name(capsys,
                                                           monkeypatch):
    monkeypatch.setattr(bench, "supervise", lambda *a: pytest.fail(
        "a host backend needs no child"))
    assert bench.main(["--backend", "native", "--sweep-bits", "16"]) == 0
    line = _line(capsys)
    assert line["backend"] == "native" and line["device"] == "cpu"
    assert GENESIS_NONCE in line["hits"]


# ---------------------------------------------------------- rc contract
class TestSuperviseRcContract:
    @pytest.fixture(autouse=True)
    def _no_backoff(self, monkeypatch):
        monkeypatch.setattr(bench.time, "sleep", lambda s: None)

    def _attempts(self, monkeypatch, *results):
        calls = []

        def fake_attempt(cmd, timeout, env=None):
            calls.append(cmd)
            return results[min(len(calls), len(results)) - 1]

        monkeypatch.setattr(bench, "_run_attempt", fake_attempt)
        return calls

    def test_good_measurement_is_rc0(self, monkeypatch, capsys):
        self._attempts(monkeypatch, ({
            "metric": "sha256d_scan", "value": 6800.0, "unit": "MH/s",
            "backend": "cuda-tile", "device": "NVIDIA H100"}, "", 0))
        assert bench.main([]) == 0
        assert _line(capsys)["value"] == 6800.0

    def test_parity_failure_is_rc2_never_retried_or_masked(self, monkeypatch,
                                                           capsys):
        calls = self._attempts(monkeypatch, ({
            "metric": "sha256d_scan", "value": 0.0,
            "error": "genesis nonce missed — kernel broken"}, "missed", 2))
        assert bench.main(["--attempts", "3"]) == 2
        assert len(calls) == 1
        assert "genesis" in _line(capsys)["error"]

    def test_device_failure_is_rc1_value0_and_no_fallback(self, monkeypatch,
                                                          capsys):
        """The worker's own error line (no card, a failed build or
        launch) is final: one child, of the requested backend."""
        calls = self._attempts(monkeypatch, (
            bench._error_line(_args([]), "RuntimeError: no CUDA device"),
            "RuntimeError: no CUDA device", 1))
        assert bench.main(["--attempts", "3"]) == 1
        line = _line(capsys)
        assert line["value"] == 0 and line["backend"] == "cuda-tile"
        assert "no CUDA device" in line["error"]
        assert len(calls) == 1
        assert calls[0][:4] == [sys.executable, "-m",
                                "bitcoin_miner_tpu_torch.bench", "--worker"]
        assert calls[0][4:] == ["--attempts", "3"]

    def test_hung_children_are_retried_then_rc1(self, monkeypatch, capsys):
        calls = self._attempts(monkeypatch,
                               (None, "attempt timed out after 600s", -1))
        assert bench.main(["--attempts", "2", "--vshare", "2"]) == 1
        line = _line(capsys)
        assert line["value"] == 0 and "timed out" in line["error"]
        assert len(calls) == 2 and calls[0] == calls[1]
        assert not any("native" in " ".join(c) for c in calls)

    def test_a_retry_after_a_hang_can_measure(self, monkeypatch, capsys):
        calls = self._attempts(
            monkeypatch, (None, "worker exited rc=-9 with no JSON: ", -9),
            ({"metric": "sha256d_scan", "value": 1.5}, "", 0))
        assert bench.main([]) == 0
        assert len(calls) == 2 and _line(capsys)["value"] == 1.5

    def test_salvaged_line_of_a_child_killed_after_printing(self,
                                                            monkeypatch):
        import subprocess

        def timeout(*a, **kw):
            raise subprocess.TimeoutExpired(
                "x", 1, output=b'{"metric": "sha256d_scan", "value": 9.0}\n')

        monkeypatch.setattr(bench.subprocess, "run", timeout)
        parsed, err, rc = bench._run_attempt(["x"], 1)
        assert (parsed["value"], rc) == (9.0, 0)


def test_card_failure_in_process_is_rc1_json(monkeypatch, capsys):
    """A worker that cannot reach a card prints an error line, never a
    traceback, and never a host backend's number."""
    monkeypatch.setattr(bench, "in_process", lambda args: False)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert bench.main(["--worker"]) == 1
    line = _line(capsys)
    assert line["value"] == 0 and line["backend"] == "cuda-tile"
    assert "no CUDA device" in line["error"]


@pytest.mark.parametrize("found,verified,error", [
    (False, False, "genesis nonce missed"),
    (True, False, "oracle verification failed")])
def test_parity_gate_in_the_worker(monkeypatch, capsys, found, verified,
                                   error):
    real = cli.run_bench

    def broken(*a, **kw):
        return dict(real(*a, **kw), found=found, verified=verified)

    monkeypatch.setattr(cli, "run_bench", broken)
    assert bench.main(CPU_ARGV) == 2
    line = _line(capsys)
    assert line["value"] == 0 and error in line["error"]


def test_bad_options_are_an_rc1_line(capsys):
    assert bench.main([*CPU_ARGV, "--variant", "nope"]) == 1
    line = _line(capsys)
    assert line["value"] == 0 and "SystemExit" in line["error"]
    assert bench.main([*CPU_ARGV, "--backend", "native", "--vshare", "2"]
                      ) == 1
    assert "--vshare" in _line(capsys)["error"]


def test_defaults_are_the_command_lines_and_no_tpu_options():
    """No tuned geometry, relay probe or fallback: the defaults are the
    command line's, and the reference's TPU-only options do not exist."""
    args = _args([])
    assert (args.backend, args.device, args.sweep_bits, args.vshare) == (
        "cuda-tile", "cuda", 32, 1)
    assert args.scheduler == "adaptive" and args.flightrec_out is None
    for flag in ("batch_bits", "variant", "sublanes", "inner_tiles",
                 "interleave", "unroll", "inner_bits", "cgroup"):
        assert getattr(args, flag) is None
    assert args.backend == cli.build_parser().parse_args(["--bench"]).backend
    for flag in ("--no-fallback", "--no-probe", "--quick"):
        with pytest.raises(SystemExit):
            bench.build_parser().parse_args([flag])
    assert not hasattr(bench, "resolve_tuned_defaults")
    assert not hasattr(bench, "_last_tpu_measurement")


def test_sweep_bits_are_bounded():
    with pytest.raises(SystemExit):
        bench.main(["--sweep-bits", "33"])


# ------------------------------------- telemetry, profile and the ledger
def test_flight_recorder_armed_only_at_a_given_path(tmp_path, capsys,
                                                    monkeypatch):
    recorder = get_telemetry().flightrec
    armed = []
    real_arm = type(recorder).arm

    def arm(self, path, **kw):
        armed.append(path)
        return real_arm(self, path, **kw)

    monkeypatch.setattr(type(recorder), "arm", arm)
    assert bench.main(CPU_ARGV) == 0
    assert armed == [] and not get_telemetry().flightrec._armed
    path = str(tmp_path / "fr.json")
    assert bench.main([*CPU_ARGV, "--flightrec-out", path]) == 0
    assert armed == [path] and not get_telemetry().flightrec._armed
    capsys.readouterr()


def test_ledger_row_names_the_platform_it_ran_on(tmp_path, capsys):
    ledger = tmp_path / "l.jsonl"
    assert bench.main([*CPU_ARGV, "--ledger", str(ledger),
                       "--ledger-id", "pl-test"]) == 0
    line = _line(capsys)
    rows = [json.loads(r) for r in ledger.read_text().splitlines()]
    assert len(rows) == 1 and rows[0]["id"] == "pl-test"
    assert rows[0]["rc"] == 0 and rows[0]["value"] == line["value"]
    fp = rows[0]["fingerprint"]
    assert fp["platform"] == "cpu" and "torch" in fp
    assert not {"jax", "jaxlib", "libtpu"} & set(fp)


def test_profile_and_trace_of_the_timed_sweep(tmp_path, capsys):
    profile = tmp_path / "profile"
    trace = tmp_path / "trace.json"
    # --trace-out writes every span of the process default bundle: the run
    # gets a bundle of its own, so that no earlier test's spans (in the same
    # worker process) are counted with the bench's.
    port_pipeline.set_telemetry(None)
    try:
        assert bench.main([*CPU_ARGV, "--profile", str(profile),
                           "--trace-out", str(trace)]) == 0
    finally:
        port_pipeline.set_telemetry(None)
    line = _line(capsys)
    assert [os.path.basename(p) for p in trace_report.find_traces(
        str(profile))] == [f"bench.{os.getpid()}.pt.trace.json"]
    rc, rec = trace_report.run(str(profile))
    assert rc == 0 and rec["device"]["events"] == 0
    notes = rec["host_annotations"]
    assert notes["device_dispatch"]["count"] == line["dispatches"]
    assert notes["ring_collect"]["count"] == line["dispatches"]
    names = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]]
    assert names.count("device_dispatch") == line["dispatches"]
