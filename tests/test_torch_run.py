"""The BASELINE matrix runner (``bitcoin_miner_tpu_torch.probes.run``) on
the CPU against the reference's ``benchmarks/run.py`` (loaded by path).

- The reference's five configurations with ``--quick`` on its ``native``
  backend; the port's five with ``--device cpu --quick`` on ``cuda-tile``
  and on ``cuda --inner-bits 14`` (the plain PyTorch versions): the same
  ``pass``, ``name`` and count fields per configuration.
- Configurations 2 and 3's scans: the port's hashers at the runner's
  geometry against the reference's native hasher, hit for hit.
- Requests below the 2^20-nonce grid (configurations 3 to 5 make them):
  no hit past a request's count.
- A planted fault (a hasher that drops one hit) fails configurations 2
  and 3 with rc 1; the refusals (an unknown configuration, ``--inner-bits``
  on the tile kernel, no card without ``--device cpu``) exit 2 before
  any scan.

On the card ``tests/test_torch_cuda.py`` runs ``--quick`` (``gpu``)."""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import pytest
import torch

import bitcoin_miner_tpu.miner.runner  # noqa: F401 — before its protocol
from bitcoin_miner_tpu.backends.base import get_hasher as ref_get_hasher
from bitcoin_miner_tpu_torch.backends.base import ScanResult, get_hasher
from bitcoin_miner_tpu_torch.core.target import (
    difficulty_to_target,
    nbits_to_target,
)
from bitcoin_miner_tpu_torch.probes import run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: The port's two configurations: the tile kernel at its defaults, and the
#: reference's geometry on the hit-buffer kernel.
PORT_RUNS = {"cuda-tile": [], "cuda": ["--inner-bits", "14"]}
#: The count fields each configuration's line carries.
COUNT_FIELDS = {4: ("blocks_accepted",),
                5: ("shares_accepted", "shares_rejected",
                    "version_bits_on_all_submits")}


def _reference():
    spec = importlib.util.spec_from_file_location(
        "run_reference", os.path.join(REPO, "benchmarks", "run.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


#: Intra-op threads of the runs here and of the child below: the suite runs
#: in parallel worker processes and configuration 4 runs 8 pump threads. A
#: child at torch's default (a thread per core) on a busy machine spins:
#: configuration 2 at --quick took 54 s instead of 1.4 s.
TORCH_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def reference_lines():
    ref = _reference()
    argv = sys.argv
    sys.argv = ["run.py", "--backend", "native", "--quick"]
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = ref.main()
    finally:
        sys.argv = argv
    return rc, {r["config"]: r for r in _json_lines(out.getvalue())}


@pytest.fixture(scope="module")
def port_lines():
    """Each backend's run: (rc, its lines by configuration, its output)."""
    runs = {}
    for backend, extra in PORT_RUNS.items():
        seen = []
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = run.main(["--backend", backend, "--device", "cpu",
                           "--quick", *extra], after_config=seen.append)
        runs[backend] = (rc, {r["config"]: r for r in seen}, out.getvalue())
    return runs


def test_reference_passes_on_native(reference_lines):
    rc, lines = reference_lines
    assert rc == 0 and sorted(lines) == [1, 2, 3, 4, 5]


@pytest.mark.parametrize("backend", list(PORT_RUNS))
def test_port_prints_five_lines_and_the_table(port_lines, backend):
    rc, lines, text = port_lines[backend]
    assert rc == 0 and sorted(lines) == [1, 2, 3, 4, 5]
    assert _json_lines(text) == [lines[c] for c in range(1, 6)]
    table = text.split("\n\n", 1)[1].strip().splitlines()
    assert table[:2] == ["| # | scenario | pass | metric |",
                         "|---|---|---|---|"]
    assert [row.split(" | ")[2] for row in table[2:]] == ["PASS"] * 5
    assert lines[3]["oracle"] == "native"


@pytest.mark.parametrize("config", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("backend", list(PORT_RUNS))
def test_config_matches_reference(reference_lines, port_lines, backend,
                                  config):
    want = reference_lines[1][config]
    got = port_lines[backend][1][config]
    assert (got["config"], got["name"], got["pass"]) == (
        want["config"], want["name"], want["pass"]) == (
        config, want["name"], True)
    # The pass conditions' counts: a block or three shares at least (a
    # session may land one more before it stops), none rejected, version
    # bits on every submit.
    for field in COUNT_FIELDS.get(config, ()):
        floor = {"blocks_accepted": 1, "shares_accepted": 3}.get(field)
        if floor is None:
            assert got[field] == want[field], field
        else:
            assert got[field] >= floor and want[field] >= floor, field


def _port_hasher(backend, batch_bits=20):
    args = run.build_parser().parse_args(
        ["--backend", backend, "--device", "cpu",
         "--batch-bits", str(batch_bits), *PORT_RUNS[backend]])
    return run.make_hasher(args)


def _config_scan(config, quick=True):
    """(header76, nonce_start, count, target) of configuration 2 or 3."""
    from bitcoin_miner_tpu_torch.core.header import GENESIS_NONCE

    if config == 2:
        n = 1 << (17 if quick else 20)
        return (run._header76(), GENESIS_NONCE - n // 2, n,
                nbits_to_target(0x1D00FFFF))
    return (run._header76(), 10_000, 1 << (14 if quick else 18),
            difficulty_to_target(1 / (1 << 24)))


@pytest.mark.parametrize("config", [2, 3])
@pytest.mark.parametrize("backend", list(PORT_RUNS))
def test_config_scans_match_reference_native(backend, config):
    args = _config_scan(config)
    got = _port_hasher(backend).scan(*args)
    want = ref_get_hasher("native").scan(*args)
    assert (got.nonces, got.total_hits) == (want.nonces, want.total_hits)
    assert got.total_hits >= 1


@pytest.mark.parametrize("count", [1, 1000, 1 << 10, 8192 + 5])
@pytest.mark.parametrize("backend", list(PORT_RUNS))
def test_requests_below_the_grid_report_no_hit_past_their_count(backend,
                                                               count):
    """A request of fewer nonces than the 2^20 grid launches the whole
    grid: its hits stop at its count. At regtest's target about every
    other nonce is a hit, so one past the count would show in the
    uncapped total."""
    hasher = _port_hasher(backend)
    header = bytes(range(76))
    for target in (nbits_to_target(0x207FFFFF),
                   difficulty_to_target(1 / (1 << 24))):
        got = hasher.scan(header, 77, count, target)
        want = get_hasher("native").scan(header, 77, count, target)
        assert (got.nonces, got.total_hits) == (want.nonces,
                                                want.total_hits)
        assert all(77 <= n < 77 + count for n in got.nonces)


class _DropsOneHit:
    """A hasher whose every scan loses its first hit."""

    def __init__(self, inner):
        self.inner = inner
        self.name = inner.name

    def sha256d(self, data):
        return self.inner.sha256d(data)

    def scan(self, *args, **kwargs):
        res = self.inner.scan(*args, **kwargs)
        return ScanResult(nonces=res.nonces[1:],
                          total_hits=max(0, res.total_hits - 1),
                          hashes_done=res.hashes_done)


@pytest.mark.parametrize("backend", list(PORT_RUNS))
def test_a_dropped_hit_fails_configs_2_and_3(backend, monkeypatch, capsys):
    faulty = _DropsOneHit(_port_hasher(backend))
    monkeypatch.setattr(run, "make_hasher", lambda args: faulty)
    rc = run.main(["--backend", backend, "--device", "cpu", "--quick",
                   "--configs", "1,2,3", *PORT_RUNS[backend]])
    lines = _json_lines(capsys.readouterr().out)
    assert rc == 1
    assert [(r["config"], r["pass"]) for r in lines] == [
        (1, True), (2, False), (3, False)]


def _never_builds(args):
    raise AssertionError("a refused run built a hasher")


@pytest.mark.parametrize("configs", ["6", "1,x", "0", ","])
def test_unknown_config_is_refused(configs, monkeypatch, capsys):
    monkeypatch.setattr(run, "make_hasher", _never_builds)
    assert run.main(["--device", "cpu", "--configs", configs]) == 2
    err = capsys.readouterr()
    assert "valid: [1, 2, 3, 4, 5]" in err.err or "names none" in err.err
    assert not err.out


def test_inner_bits_on_the_tile_kernel_is_refused(capsys):
    assert run.main(["--backend", "cuda-tile", "--device", "cpu",
                     "--inner-bits", "14"]) == 2
    err = capsys.readouterr()
    assert "--inner-bits" in err.err and not err.out


def test_no_card_without_device_cpu_is_refused(monkeypatch, capsys):
    """Without ``--device cpu`` the runner needs a card: with none it
    exits 2 before it builds a hasher, so nothing scans on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(run, "make_hasher", _never_builds)
    for backend in PORT_RUNS:
        assert run.main(["--backend", backend, "--quick"]) == 2
    err = capsys.readouterr()
    assert "no CUDA device" in err.err and not err.out


def test_module_entry_point_without_a_card_exits_2():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "bitcoin_miner_tpu_torch.probes.run",
         "--quick", "--configs", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2, proc.stderr
    assert "no CUDA device" in proc.stderr and not proc.stdout


def test_module_entry_point_on_the_cpu():
    env = dict(os.environ, OMP_NUM_THREADS=str(TORCH_THREADS))
    proc = subprocess.run(
        [sys.executable, "-m", "bitcoin_miner_tpu_torch.probes.run",
         "--device", "cpu", "--quick", "--configs", "1,2,3"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = _json_lines(proc.stdout)
    assert [(r["config"], r["pass"]) for r in lines] == [
        (1, True), (2, True), (3, True)]
    assert proc.stdout.rstrip().endswith(
        "| 3 | midstate batch 16384 nonces, full parity | PASS | "
        f"{lines[2]['mhs']} MH/s |")


def test_sizes_are_the_references():
    """The reference's sizes and conditions, read from its source."""
    ref = open(os.path.join(REPO, "benchmarks", "run.py")).read()
    assert "n = 1 << (17 if quick else 20)" in ref
    assert "n = 1 << (14 if quick else 18)" in ref
    assert "difficulty_to_target(1 / (1 << 24))" in ref
    assert "n_workers=8" in ref and "n_workers=4" in ref
    assert ref.count("batch_size=1 << 10") == 2
    assert 'p.add_argument("--batch-bits", type=int, default=20)' in ref
    assert run.build_parser().parse_args([]).batch_bits == 20
