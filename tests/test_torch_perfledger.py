"""The PyTorch package's perf ledger and ``perf`` command against the JAX
package's ``telemetry/perfledger.py`` and ``perf_cli.py``: the same rows
validate the same or raise the same ``LedgerError``s; the reference's
``benchmarks/perf_ledger.jsonl`` and ``perf_baseline.jsonl``, opened
read-only, load through both loaders to the same rows, keys and
trajectories; the same seeded rows give the same gate verdicts and
reports; a row either package appends loads in the other. The port's
fingerprint names torch and the card, never JAX; ``perf capture`` refuses,
with its reason, a bench option it sets itself (``test_torch_trace_report.py``
runs it); every ledger of these tests is in ``tmp_path``."""

import hashlib
import io
import json
import os

import numpy as np
import pytest

from bitcoin_miner_tpu import perf_cli as ref_perf_cli
from bitcoin_miner_tpu.telemetry import perfledger as ref_ledger
from bitcoin_miner_tpu_torch import cli
from bitcoin_miner_tpu_torch import perf_cli as port_perf_cli
from bitcoin_miner_tpu_torch.telemetry import perfledger as port_ledger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVIDENCE = [os.path.join(REPO, "benchmarks", name)
            for name in ("perf_ledger.jsonl", "perf_baseline.jsonl")]
SEED = 7


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("path", EVIDENCE, ids=os.path.basename)
def test_the_reference_evidence_loads_the_same(path):
    before = _digest(path)
    ref = ref_ledger.load_rows(path)
    port = port_ledger.load_rows(path)
    assert [r.raw for r in ref] == [r.raw for r in port] and port
    assert [r.key() for r in ref] == [r.key() for r in port]
    assert [r.higher_better for r in ref] == [r.higher_better for r in port]
    assert ref_ledger.trajectory(ref) == port_ledger.trajectory(port)
    for a, b in zip(ref, port):
        assert ref_ledger.content_key(a.raw) == port_ledger.content_key(b.raw)
    assert _digest(path) == before


def test_the_evidence_gates_the_same_against_itself():
    cur = port_ledger.load_rows(EVIDENCE[0])
    base = port_ledger.load_rows(EVIDENCE[1])
    ref = ref_ledger.gate_report(ref_ledger.gate_rows(
        ref_ledger.load_rows(EVIDENCE[0]), ref_ledger.load_rows(EVIDENCE[1])))
    port = port_ledger.gate_report(port_ledger.gate_rows(cur, base))
    assert ref == port and port["checked"] > 0


BAD_ROWS = [
    [1, 2], "row", {"value": 1.0}, {"metric": ""},
    {"metric": "m", "value": "fast"}, {"metric": "m", "value": True},
    {"metric": "m", "unit": 3}, {"metric": "m", "backend": ["x"]},
    {"metric": "m", "schema": "tpu-miner-perfledger/9"},
    {"metric": "m", "fingerprint": "host"}, {"metric": "m", "config": 1},
    {"metric": "m", "id": 12},
]


@pytest.mark.parametrize("raw", BAD_ROWS)
def test_bad_rows_raise_the_same_errors(raw):
    with pytest.raises(ref_ledger.LedgerError) as ref:
        ref_ledger.validate_row(raw)
    with pytest.raises(port_ledger.LedgerError) as port:
        port_ledger.validate_row(raw)
    assert str(ref.value) == str(port.value)


@pytest.mark.parametrize("text", [
    '{"metric": "m", "value": 1}\n\nnot json\n',
    '{"metric": "m"}\n{"metric": "m", "value": "x"}\n',
])
def test_bad_files_raise_the_same_errors(text, tmp_path):
    path = tmp_path / "bad.jsonl"
    path.write_text(text)
    errors = []
    for mod in (ref_ledger, port_ledger):
        with pytest.raises(mod.LedgerError) as e:
            mod.load_rows(str(path))
        errors.append(str(e.value))
        stream = io.StringIO(text)
        stream.name = "stdin"
        with pytest.raises(mod.LedgerError) as e:
            mod.load_rows(stream)
        errors.append(str(e.value))
    assert errors[0] == errors[2] and errors[1] == errors[3]


def _seeded_rows(rng, n, scale=1.0):
    """Rows of several experiments: MH/s sweeps per backend and vshare,
    seconds of proxy benches, an error row, a valueless row and a row of
    an ungateable unit."""
    rows = []
    for i in range(n):
        kind = int(rng.integers(4))
        if kind == 0:
            rows.append({"metric": "sha256d_scan", "unit": "MH/s",
                         "backend": str(rng.choice(["cuda-tile", "cuda"])),
                         "vshare": int(rng.choice([1, 2])),
                         "value": float(rng.normal(6800, 60)) * scale,
                         "measured": f"2026-10-{10 + i % 9:02d}T00:00Z"})
        elif kind == 1:
            rows.append({"metric": "proxy_microbench", "unit": "s",
                         "backend": "cpu",
                         "bench": str(rng.choice(["a", "b"])),
                         "value": float(rng.exponential(0.5)) / scale})
        elif kind == 2:
            rows.append({"metric": "sha256d_scan", "unit": "MH/s",
                         "backend": "cuda-tile", "value": 0.0,
                         "error": "no card"})
        else:
            rows.append({"metric": "fusions", "unit": "count",
                         "value": float(i)})
    rows.append({"metric": "smoke", "value": None})
    return rows


@pytest.mark.parametrize("scale", [1.0, 0.9, 0.5])
def test_the_same_rows_give_the_same_verdicts(scale):
    rng = np.random.default_rng(SEED)
    base_raw = _seeded_rows(rng, 40)
    cur_raw = _seeded_rows(rng, 20, scale=scale)
    reports = []
    for mod in (ref_ledger, port_ledger):
        base = [mod.validate_row(r) for r in base_raw]
        cur = [mod.validate_row(r) for r in cur_raw]
        for kw in ({}, {"rel_floor": 0.01, "mad_k": 2.0}):
            reports.append(mod.gate_report(mod.gate_rows(cur, base, **kw)))
        reports.append(mod.trajectory(base + cur))
        out = io.StringIO()
        mod.format_report(mod.trajectory(base + cur), file=out)
        reports.append(out.getvalue())
    half = len(reports) // 2
    assert reports[:half] == reports[half:]
    if scale == 0.5:
        assert reports[half]["status"] == "fail"


def test_the_statistics_match():
    rng = np.random.default_rng(SEED)
    for n in (1, 2, 5, 12):
        vals = [float(v) for v in rng.normal(10, 2, n)]
        assert ref_ledger.median(vals) == port_ledger.median(vals)
        assert ref_ledger.mad(vals) == port_ledger.mad(vals)
        assert ref_ledger.noise_band(vals) == port_ledger.noise_band(vals)
    assert port_ledger.noise_band([0.0, 0.0]) == 0.05
    with pytest.raises(ValueError):
        port_ledger.median([])


def test_a_row_appended_by_either_loads_in_the_other(tmp_path):
    path = str(tmp_path / "ledger.jsonl")
    ref_ledger.PerfLedger(path).append(
        {"metric": "m", "value": 1.0, "unit": "s"},
        fingerprint={"host": "h"}, artifacts={"trace": "t.json"},
        row_id="pl-x")
    port_ledger.PerfLedger(path).append_many(
        [{"metric": "m", "value": 2.0, "unit": "s"}],
        fingerprint=port_ledger.env_fingerprint())
    ref = ref_ledger.PerfLedger(path).load()
    port = port_ledger.PerfLedger(path).load()
    assert [r.raw for r in ref] == [r.raw for r in port]
    assert port[0].row_id == "pl-x" and port[0].artifacts == {
        "trace": "t.json"}
    assert port[1].raw["schema"] == port_ledger.SCHEMA
    assert port[1].row_id.startswith("pl-")
    assert port_ledger.PerfLedger(str(tmp_path / "none")).load() == []


def test_the_fingerprint_names_torch_never_jax():
    import torch

    fp = port_ledger.env_fingerprint()
    assert fp["torch"] == torch.__version__
    assert fp["platform"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert not {"jax", "jaxlib", "libtpu", "pool_up"} & set(fp)
    assert port_ledger.env_fingerprint(platform="gpu")["platform"] == "gpu"


def test_the_fingerprint_loads_no_torch():
    """A host tool that stamps a row (``perf record``, the load probe)
    reads torch's version and CUDA build without importing torch: the
    same facts as a process that loaded it."""
    import subprocess
    import sys

    import torch

    code = (
        "import json, sys\n"
        "from bitcoin_miner_tpu_torch.telemetry.perfledger import "
        "env_fingerprint\n"
        "print(json.dumps([env_fingerprint(), 'torch' in sys.modules]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    fp, loaded = json.loads(out.stdout)
    assert not loaded
    assert fp["torch"] == torch.__version__
    assert fp.get("cuda") == torch.version.cuda
    assert fp["platform"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert {k: v for k, v in port_ledger.env_fingerprint().items()
            if k not in ("card",)} == {k: v for k, v in fp.items()
                                       if k not in ("card",)}


def test_the_fingerprint_carries_the_card(monkeypatch):
    """Where ``nvidia-smi`` answers, its name and power limit go in."""
    import subprocess

    class Done:
        returncode = 0
        stdout = "NVIDIA H100 80GB HBM3, 700.00 W\n"

    real = subprocess.run
    monkeypatch.setattr(
        subprocess, "run",
        lambda cmd, **kw: Done() if cmd[0] == "nvidia-smi" else real(cmd,
                                                                      **kw))
    assert port_ledger.env_fingerprint()["card"] == \
        "NVIDIA H100 80GB HBM3, 700.00 W"


# -------------------------------------------------------------------- cli
def _perf(argv, capsys):
    rc = cli.main(["perf", *argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_default_ledger_is_ignored_by_git():
    rel = os.path.relpath(port_perf_cli.DEFAULT_LEDGER, REPO)
    assert rel == os.path.join("build", "perf_ledger.jsonl")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "build/" in f.read().split()


def test_record_report_compare_and_gate(tmp_path, capsys):
    ledger = str(tmp_path / "run.jsonl")
    evidence = tmp_path / "evidence.jsonl"
    rng = np.random.default_rng(SEED)
    # Rows as a battery writes them, dated: the ledger stamps an undated
    # row with the time of the append.
    rows = [dict(r, measured=r.get("measured", "2026-10-17T00:00Z"))
            for r in _seeded_rows(rng, 12)]
    evidence.write_text("".join(json.dumps(r) + "\n" for r in rows))
    unique = len({port_ledger.content_key(r) for r in rows})
    rc, out, _ = _perf(["record", "--ledger", ledger, "--from",
                        str(evidence), "--platform", "cuda"], capsys)
    assert rc == 0 and f"recorded {unique} row(s)" in out
    rc, out, _ = _perf(["record", "--ledger", ledger, "--from",
                        str(evidence)], capsys)
    assert f"recorded 0 row(s) into {ledger} ({len(rows)} duplicate" in out
    loaded = port_ledger.load_rows(ledger)
    assert all(r.fingerprint["platform"] == "cuda" for r in loaded)
    for argv in (["report", "--ledger", ledger],
                 ["report", "--ledger", ledger, "--json"],
                 ["report", "--ledger", ledger, "--metric", "sha256d_scan"],
                 ["gate", "--ledger", ledger, "--baseline", ledger],
                 ["compare", "--ledger", ledger, "--baseline",
                  EVIDENCE[1], "--json"]):
        rc, out, err = _perf(argv, capsys)
        ref_rc = ref_perf_cli.main(list(argv))
        ref_out = capsys.readouterr().out
        assert (rc, out) == (ref_rc, ref_out), argv
    # A 2x slowdown of the current run fails the gate, unless warn-only.
    slow = tmp_path / "slow.jsonl"
    base = [dict(r, id=f"b{i}") for i, r in enumerate(rows)]
    slow.write_text("".join(
        json.dumps(dict(r, value=r["value"] * (0.5 if r["unit"] == "MH/s"
                                                else 2.0), id=f"s{i}"))
        + "\n" for i, r in enumerate(rows)
        if isinstance(r.get("value"), float) and not r.get("error")
        and r["unit"] in ("MH/s", "s")))
    basefile = tmp_path / "base.jsonl"
    basefile.write_text("".join(json.dumps(r) + "\n" for r in base))
    rc, out, _ = _perf(["gate", "--ledger", str(slow), "--baseline",
                        str(basefile)], capsys)
    assert rc == 1 and "gate: fail" in out
    rc, out, _ = _perf(["gate", "--ledger", str(slow), "--baseline",
                        str(basefile), "--warn-only"], capsys)
    assert rc == 0 and "gate: fail" in out
    rc, out, _ = _perf(["compare", "--ledger", str(slow), "--baseline",
                        str(basefile)], capsys)
    assert rc == 0
    with pytest.raises(SystemExit, match="not JSON"):
        bad = tmp_path / "bad.jsonl"
        bad.write_text("nope\n")
        _perf(["gate", "--ledger", ledger, "--baseline", str(bad)], capsys)


def test_proxy_appends_gateable_rows(tmp_path, capsys):
    ledger = str(tmp_path / "proxy.jsonl")
    rc, out, _ = _perf(["proxy", "--ledger", ledger, "--repeats", "2",
                        "--bench", "dispatcher_sweep", "--bench",
                        "dispatcher_sweep_notel", "--bench",
                        "share_accounting"], capsys)
    assert rc == 0 and "observatory overhead" in out
    rows = port_ledger.load_rows(ledger)
    assert [r.raw["bench"] for r in rows] == [
        "dispatcher_sweep", "dispatcher_sweep_notel",
        "share_accounting"] * 2
    assert all(r.unit == "s" and r.value > 0 and r.backend == "cpu"
               and r.fingerprint["platform"] == "cpu" for r in rows)
    rc, out, _ = _perf(["gate", "--ledger", ledger, "--baseline", ledger],
                       capsys)
    assert rc == 0 and "gate: ok (0 failed / 3 checked" in out
    rc, out, _ = _perf(["proxy", "--ledger", ledger, "--repeats", "1",
                        "--bench", "scheduler_loop", "--json"], capsys)
    assert json.loads(out[:out.rindex("appended")])["best"].keys() == {
        "scheduler_loop"}
    with pytest.raises(SystemExit, match="unknown proxy bench"):
        _perf(["proxy", "--ledger", ledger, "--bench", "nope"], capsys)


def test_the_proxy_sweep_verifies_its_hits():
    """The proxy's sweep is the reference's: the same job and range give
    the same shares through each package's dispatcher on its oracle."""
    from bitcoin_miner_tpu.backends.base import get_hasher as ref_get
    from bitcoin_miner_tpu.miner.dispatcher import Dispatcher as RefDispatcher
    from bitcoin_miner_tpu.telemetry import NullTelemetry as RefNull
    from bitcoin_miner_tpu_torch.backends.base import get_hasher
    from bitcoin_miner_tpu_torch.miner.dispatcher import Dispatcher
    from bitcoin_miner_tpu_torch.telemetry import NullTelemetry

    n = port_perf_cli.PROXY_SWEEP_NONCES
    ref = RefDispatcher(ref_get("cpu"), n_workers=1,
                        batch_size=port_perf_cli.PROXY_SWEEP_BATCH,
                        telemetry=RefNull()).sweep(
        ref_perf_cli._proxy_job(), nonce_start=0, nonce_count=n)
    d = Dispatcher(get_hasher("cpu"), n_workers=1,
                   batch_size=port_perf_cli.PROXY_SWEEP_BATCH,
                   telemetry=NullTelemetry())
    port = d.sweep(port_perf_cli._proxy_job(), nonce_start=0, nonce_count=n)
    assert [(s.nonce, s.hash_int) for s in ref] == [
        (s.nonce, s.hash_int) for s in port] and port
    assert d.stats.hashes == n and d.stats.batches == n // (
        port_perf_cli.PROXY_SWEEP_BATCH)


@pytest.mark.parametrize("argv", [
    ["capture", "--out", "{x}", "--", "--profile", "{x}"],
    ["capture", "--out", "{x}", "--", "--sweep-bits", "12", "--ledger={x}"]])
def test_capture_is_refused_with_its_reason(argv, tmp_path, capsys):
    x = os.path.join(str(tmp_path), "x")
    rc, out, err = _perf([a.replace("{x}", x) for a in argv], capsys)
    assert rc == 2 and not out
    assert "perf capture sets --profile, --trace-out, --ledger" in err
    flag = next(a.split("=")[0] for a in argv
                if a.split("=")[0] in port_perf_cli.CAPTURE_SETS)
    assert "refused: " + flag in err
    assert not os.path.exists(x)


def test_perf_needs_a_subcommand(capsys):
    with pytest.raises(SystemExit):
        cli.main(["perf"])
    with pytest.raises(SystemExit, match="2"):
        cli.main(["perf", "report", "--bogus"])
