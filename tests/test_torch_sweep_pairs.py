"""``sweep_pairs.py --layouts``, on the CPU: its arguments, the refusals
that come before any build, and its one JSON line. The timing itself
needs the card (CUDA events behind queued scans); here the measured
numbers are stand-ins, and the line is checked around them."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import sweep_pairs  # noqa: E402
from bitcoin_miner_tpu_torch.ops import sha256_tile  # noqa: E402


@pytest.mark.parametrize("specs, want", [
    (["8:regchain"], [(8, "regchain", 0, 1)]),
    (["8:vroll-db", "2:vroll-db:0:2"],
     [(8, "vroll-db", 0, 1), (2, "vroll-db", 0, 2)]),
    (["4:wsplit:2"], [(4, "wsplit", 2, 1)]),
    (["1:baseline:1:1"], [(1, "baseline", 1, 1)]),
])
def test_parse_layouts(specs, want):
    assert sweep_pairs.parse_layouts(specs) == want


@pytest.mark.parametrize("specs", [
    [], ["8"], ["regchain:8"], ["8:regchain:x"], ["8:regchain:0:1:2"],
    ["8::0:1"], ["2:vroll-db:0:two"], ["8:regchain", "bad"],
])
def test_parse_layouts_refuses(specs):
    with pytest.raises(ValueError, match="layout"):
        sweep_pairs.parse_layouts(specs)


def test_a_bad_layout_exits_2_before_anything_loads():
    proc = subprocess.run(
        [sys.executable, "sweep_pairs.py", ".", "--layouts", "8:regchain:x"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and proc.stdout == ""
    assert "want K:VARIANT[:CGROUP[:INTERLEAVE]]" in proc.stderr


@pytest.mark.parametrize("layout, match", [
    ((2, "vroll-db", 0, 3), "interleave must divide"),
    ((8, "nope", 0, 1), "unknown kernel variant"),
    ((2, "regchain", 3, 1), "cgroup must be between"),
])
def test_layouts_checks_each_layout_before_building(layout, match,
                                                    monkeypatch):
    from bitcoin_miner_tpu_torch.ops import csrc

    monkeypatch.setattr(csrc, "build", lambda names: pytest.fail(
        f"built {names} for a refused layout"))
    with pytest.raises(ValueError, match=match):
        sweep_pairs.layouts(REPO, [layout])


def _occupancy(threads, smem, blocks):
    shape = {"threads": threads, "dynamic_smem": smem,
             "blocks_per_sm": blocks}
    return {"word7": dict(shape), "exact": dict(shape)}


def test_layout_row():
    layout = (2, "vroll-db", 0, 2)
    row = sweep_pairs.layout_row(
        layout, 5.0, 5.5, 3.351,
        {"word7": {"registers": 120, "spill_stores": 0},
         "exact": {"registers": 124, "spill_stores": 0}},
        _occupancy(128, sha256_tile.plane_bytes("vroll-db", 2), 4))
    assert row == {
        "vshare": 2, "variant": "vroll-db", "cgroup": 0, "interleave": 2,
        "ms": 5.0, "ms_exact": 5.5, "bound_ms": 3.351,
        "of_bound": pytest.approx(3.351 / 5.0),
        "registers_word7": 120, "spill_bytes_word7": 0,
        "blocks_per_sm_word7": 4, "registers_exact": 124,
        "spill_bytes_exact": 0, "blocks_per_sm_exact": 4, "threads": 128,
        "dynamic_smem": 55296, "warps_per_sm": 16}


def test_layouts_mode_prints_one_json_line(monkeypatch, capsys):
    """``ROOT --layouts ...`` hands the parsed layouts and ROOT to
    :func:`sweep_pairs.layouts` and prints its line alone."""
    seen = []

    def fake(root, specs):
        seen.append((root, specs))
        return {"root": root, "card": "a card", "nonces": 1 << 24,
                "layouts": {sha256_tile.tile_library(*l): sweep_pairs.
                            layout_row(l, 27.0, 28.0, 12.49, {},
                                       _occupancy(256, 0, 2))
                            for l in specs}}

    monkeypatch.setattr(sweep_pairs, "layouts", fake)
    monkeypatch.setattr(sys, "argv", ["sweep_pairs.py", REPO, "--layouts",
                                      "8:regchain", "8:vroll-db"])
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.chdir(REPO)
    assert sweep_pairs.main() == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert seen == [(REPO, [(8, "regchain", 0, 1), (8, "vroll-db", 0, 1)])]
    assert list(line["layouts"]) == ["scan_tile_regchain_k8_g8_i1",
                                     "scan_tile_vroll_db_k8_g1_i1"]
    row = line["layouts"]["scan_tile_regchain_k8_g8_i1"]
    assert row["warps_per_sm"] == 16 and row["registers_word7"] is None
    assert row["of_bound"] == pytest.approx(12.49 / 27.0)
