"""The layout tuner (``bitcoin_miner_tpu_torch.probes.tune``): the cases of
the reference's ``tests/test_tune.py`` for the port's backends (``cuda``,
``cuda-tile``), the worker on the CPU, and the watchdog killing a hung
child. No test starts a child on the card."""

import json
import os
import subprocess
import sys
import time

import pytest

from bitcoin_miner_tpu_torch.probes import tune
from bitcoin_miner_tpu_torch.probes.tune import (
    CONFIG_KEYS,
    _key,
    grid,
    merge_prior_ok,
    neighborhood,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestNeighborhood:
    def test_tile_center_excluded_and_single_knob(self):
        center = {"backend": "cuda-tile", "sublanes": 8, "inner_tiles": 8,
                  "batch_bits": 24, "unroll": 64, "mhs": 7000.0}
        configs = neighborhood(center)
        assert configs
        keys = {_key(c) for c in configs}
        assert _key(center) not in keys
        assert len(keys) == len(configs)
        for c in configs:
            def get(cfg, k):
                default = 1 if k in ("interleave", "vshare") else None
                return cfg.get(k, default)

            diffs = [k for k in ("sublanes", "inner_tiles", "batch_bits",
                                 "interleave", "vshare")
                     if get(c, k) != get(center, k)]
            assert len(diffs) == 1, (c, diffs)

    def test_hitbuf_center_inner_bits_never_exceed_batch(self):
        center = {"backend": "cuda", "inner_bits": 18, "batch_bits": 18,
                  "unroll": 64}
        for c in neighborhood(center):
            assert c["inner_bits"] <= c["batch_bits"], c

    def test_sublanes_floor_is_one_tile(self):
        center = {"backend": "cuda-tile", "sublanes": 8, "inner_tiles": 1,
                  "batch_bits": 24, "unroll": 64}
        for c in neighborhood(center):
            assert c["sublanes"] >= 8, c

    def test_vshare_halving_clamps_explicit_cgroup(self):
        center = {"backend": "cuda-tile", "sublanes": 8, "inner_tiles": 8,
                  "batch_bits": 24, "unroll": 64, "vshare": 4,
                  "variant": "wsplit", "cgroup": 4}
        configs = neighborhood(center)
        assert [c for c in configs if c.get("vshare") == 2]
        for c in configs:
            assert (c.get("cgroup") or 0) <= c.get("vshare", 1), c

    def test_spec_flag_carried_through(self):
        center = {"backend": "cuda", "inner_bits": 18, "batch_bits": 24,
                  "unroll": 64, "spec": False}
        configs = neighborhood(center)
        assert configs
        for c in configs:
            assert c["spec"] is False, c
            # The k-chain hit-buffer scan has only spec forms.
            assert c.get("vshare", 1) == 1, c

    def test_neighbours_are_configurations_the_kernels_take(self):
        """Every neighbour of every grid row builds a hasher on the CPU or
        is refused by the kernel's own checks, never by this module."""
        from bitcoin_miner_tpu_torch.ops.sha256_tile import check_layout

        for backend in tune.BACKENDS:
            for row in grid(backend, quick=False)[:3]:
                for c in neighborhood(row):
                    if backend == "cuda-tile":
                        check_layout(c.get("vshare", 1),
                                     c.get("variant", "baseline"),
                                     c.get("cgroup", 0) or 0,
                                     c.get("interleave", 1),
                                     c.get("inner_tiles", 8))
                    assert set(c) <= set(CONFIG_KEYS), c


class TestGrid:
    def test_grids_are_fastest_first_by_the_measured_times(self):
        """Ordered by PERF.md §6's card times per hash: the K=4 rows lead
        (wsplit 8.606 ms, the hit buffer 8.673 ms per 4 × 2^24 hashes)."""
        tile = grid("cuda-tile", quick=False)
        assert (tile[0]["vshare"], tile[0]["variant"]) == (4, "wsplit")
        hitbuf = grid("cuda", quick=False)
        assert hitbuf[0]["vshare"] == 4 and hitbuf[0]["unroll"] == 64
        assert grid("cuda", quick=False)[2] == {
            "backend": "cuda", "inner_bits": 18, "batch_bits": 24,
            "unroll": 64}

    def test_grid_configs_have_unique_keys(self):
        for backend in tune.BACKENDS:
            configs = grid(backend, quick=False)
            assert len({_key(c) for c in configs}) == len(configs)

    def test_config_keys_cover_grid_knobs(self):
        for backend in tune.BACKENDS:
            for c in grid(backend, quick=False) + grid(backend, quick=True):
                assert set(c) <= set(CONFIG_KEYS), c

    def test_grid_rows_are_layouts_the_kernel_takes(self):
        from bitcoin_miner_tpu_torch.ops.sha256_tile import check_layout

        for c in grid("cuda-tile", quick=False):
            check_layout(c["vshare"], c.get("variant", "baseline"),
                         c.get("cgroup", 0), c.get("interleave", 1),
                         c["inner_tiles"])


class TestMergePriorOk:
    def test_prior_ok_kept_failures_dropped_rerun_wins(self, tmp_path):
        out = tmp_path / "tune.json"
        prior = [
            {"backend": "cuda", "inner_bits": 18, "unroll": 64,
             "batch_bits": 24, "mhs": 6900.0, "ok": True},
            {"backend": "cuda", "inner_bits": 20, "unroll": 64,
             "batch_bits": 24, "mhs": 6800.0, "ok": True},
            {"backend": "cuda", "inner_bits": 16, "unroll": 64,
             "batch_bits": 24, "mhs": 0.0, "ok": False},
        ]
        out.write_text(json.dumps({"results": prior}))
        this_run = [
            {"backend": "cuda", "inner_bits": 18, "unroll": 64,
             "batch_bits": 24, "mhs": 6000.0, "ok": True},
            {"backend": "cuda", "inner_bits": 16, "unroll": 64,
             "batch_bits": 24, "mhs": 0.0, "ok": False},
        ]
        merged = merge_prior_ok(this_run, str(out))
        by = {(r["inner_bits"], r["mhs"]) for r in merged}
        assert (18, 6000.0) in by and (18, 6900.0) not in by
        assert (20, 6800.0) in by and (16, 0.0) in by
        assert len(merged) == 3

    def test_schema_drift_does_not_split_one_geometry(self, tmp_path):
        out = tmp_path / "tune.json"
        out.write_text(json.dumps({"results": [
            {"backend": "cuda-tile", "batch_bits": 24, "mhs": 6900.0,
             "ok": True}]}))
        this_run = [{"backend": "cuda-tile", "sublanes": 8, "unroll": 64,
                     "batch_bits": 24, "inner_tiles": 8, "interleave": 1,
                     "vshare": 1, "spec": True, "mhs": 6800.0, "ok": True}]
        merged = merge_prior_ok(this_run, str(out))
        assert len(merged) == 1 and merged[0]["mhs"] == 6800.0

    def test_key_normalizes_absent_and_explicit_defaults(self):
        old = {"backend": "cuda-tile", "batch_bits": 24}
        new = dict(old, sublanes=8, inner_tiles=8, interleave=1, vshare=1,
                   spec=True, unroll=64, variant="baseline")
        assert _key(old) == _key(new)
        assert _key(dict(old, vshare=4)) != _key(new)
        assert _key(dict(old, inner_tiles=1)) != _key(new)
        # The hit-buffer backend has no tile knobs to split a key.
        assert _key({"backend": "cuda", "inner_bits": 18}) == _key(
            {"backend": "cuda", "inner_bits": 18, "sublanes": 16})

    def test_key_cgroup_default_is_variant_derived(self):
        wsplit = {"backend": "cuda-tile", "batch_bits": 24, "vshare": 4,
                  "variant": "wsplit"}
        assert _key(wsplit) == _key(dict(wsplit, cgroup=1))
        assert _key(wsplit) != _key(dict(wsplit, cgroup=2))
        base = {"backend": "cuda-tile", "batch_bits": 24, "vshare": 4}
        assert _key(base) == _key(dict(base, cgroup=4))
        assert _key(base) != _key(dict(base, cgroup=1))
        for variant in ("wstage", "vroll", "vroll-db"):
            staged = dict(wsplit, variant=variant)
            assert _key(staged) == _key(dict(staged, cgroup=1))

    def test_skip_measured_prunes_by_normalized_key(self):
        configs = grid("cuda", quick=False)
        first = dict(configs[0], mhs=7700.0, ok=True)
        second = {k: v for k, v in configs[1].items() if k != "unroll"}
        second.update(mhs=7500.0, ok=True)
        measured = {_key(r) for r in (first, second)}
        kept = [c for c in configs if _key(c) not in measured]
        assert len(kept) == len(configs) - 2

    def test_skip_measured_fully_pruned_run_exits_zero(self, tmp_path):
        out = tmp_path / "tune.json"
        out.write_text(json.dumps({"results": [
            dict(grid("cuda", quick=True)[0], mhs=0.2, ok=True)]}))
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "bitcoin_miner_tpu_torch.probes.tune",
             "--quick", "--backends", "cuda", "--device", "cpu",
             "--skip-measured", "--out", str(out)],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert time.time() - t0 < 30, "the configuration was measured"
        assert "--worker-config" not in proc.stdout
        kept = json.loads(out.read_text())["results"]
        assert kept and kept[0]["mhs"] == 0.2

    def test_missing_or_bad_out_file_is_empty_prior(self, tmp_path):
        this_run = [{"backend": "cuda", "inner_bits": 18, "mhs": 1.0,
                     "ok": True}]
        assert merge_prior_ok(this_run, str(tmp_path / "nope.json")) \
            == this_run
        bad = tmp_path / "bad.json"
        bad.write_text("{not json")
        assert merge_prior_ok(this_run, str(bad)) == this_run


class TestWorker:
    def test_worker_times_a_cpu_configuration(self, capsys):
        config = dict(grid("cuda-tile", quick=True)[0], sweep_bits=15,
                      device="cpu")
        assert tune.run_worker(config) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["ok"] and line["mhs"] > 0 and line["error"] is None
        assert line["hashes"] == 1 << 15

    @pytest.mark.parametrize("knobs,error", [
        ({"vshare": 4, "cgroup": 5}, "cgroup must be between"),
        ({"variant": "bogus"}, "unknown kernel variant"),
        ({"interleave": 3}, "not measured under another configuration"),
    ])
    def test_refused_configuration_is_a_failed_row(self, knobs, error,
                                                    capsys):
        """The kernel's own refusal, with its message, and a geometry the
        hasher would clamp: failed rows, nothing measured in their place."""
        config = {"backend": "cuda-tile", "batch_bits": 15, "sublanes": 8,
                  "inner_tiles": 8, "sweep_bits": 15, "device": "cpu",
                  **knobs}
        assert tune.run_worker(config) == 1
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert not line["ok"] and line["mhs"] == 0.0
        assert {k: line[k] for k in knobs} == knobs
        assert error in line["error"]

    def test_no_card_is_a_failed_row_not_a_cpu_run(self, capsys):
        config = dict(grid("cuda", quick=True)[0], sweep_bits=15,
                      device="cuda")
        assert tune.run_worker(config) == 1
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert not line["ok"] and "no CUDA device" in line["error"]


class TestSupervisor:
    def test_quick_cpu_sweep_writes_out_and_adopt(self, tmp_path, capsys):
        out, adopt = tmp_path / "tune.json", tmp_path / "tuned.json"
        evidence = tmp_path / "evidence.jsonl"
        rc = tune.main(["--quick", "--device", "cpu", "--out", str(out),
                        "--adopt", str(adopt), "--evidence", str(evidence)])
        assert rc == 0
        results = json.loads(out.read_text())["results"]
        assert {r["backend"] for r in results} == set(tune.BACKENDS)
        assert all(r["ok"] for r in results)
        tuned = json.loads(adopt.read_text())
        assert tuned["mhs"] > 0 and tuned["backend"] in tune.BACKENDS
        assert "device" not in tuned
        rows = [json.loads(l) for l in evidence.read_text().splitlines()]
        assert len(rows) == 2 and {r["device"] for r in rows} == {"cpu"}
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
            "best"]["ok"]

    def test_defaults_write_under_build(self):
        args = tune.build_parser().parse_args([])
        assert args.out == os.path.join(REPO, "build", "tune", "tune.json")
        assert args.adopt is None and args.device == "cuda"
        assert "benchmarks" not in args.out
        assert not any(a.dest in ("no_probe",)
                       for a in tune.build_parser()._actions)

    def test_limit_takes_the_head_of_the_grid(self, monkeypatch, tmp_path):
        seen = []

        def fake_stream(cmd, timeout, deadline):
            configs = json.loads(cmd[cmd.index("--worker-config") + 1])
            seen.append(configs)
            return {_key(c): dict(c, mhs=1.0, ok=True) for c in configs}, \
                False

        monkeypatch.setattr(tune, "stream_batch", fake_stream)
        rc = tune.main(["--limit", "2", "--out", str(tmp_path / "t.json")])
        assert rc == 0
        assert [len(b) for b in seen] == [2, 2]
        assert [_key(c) for c in seen[1]] == [
            _key(dict(c, sweep_bits=26, device="cuda"))
            for c in grid("cuda-tile", quick=False)[:2]]


class TestWatchdog:
    def test_hung_child_is_killed_and_its_lines_kept(self):
        """A child that prints one result, then hangs: the inactivity
        watchdog kills it and keeps the line."""
        code = ("import json, time; print(json.dumps({'backend': 'cuda', "
                "'inner_bits': 18, 'mhs': 1.0, 'ok': True}), flush=True); "
                "time.sleep(60)")
        t0 = time.monotonic()
        got, aborted = tune.stream_batch([sys.executable, "-c", code], 2.0,
                                         None)
        assert aborted and time.monotonic() - t0 < 30
        assert list(got.values()) == [{"backend": "cuda", "inner_bits": 18,
                                       "mhs": 1.0, "ok": True}]

    def test_two_hung_children_abort_the_sweep(self, monkeypatch, tmp_path):
        monkeypatch.setattr(tune, "worker_command", lambda configs: [
            sys.executable, "-c", "import time; time.sleep(60)"])
        t0 = time.monotonic()
        rc = tune.main(["--backends", "cuda", "--attempt-timeout", "1",
                        "--out", str(tmp_path / "t.json")])
        assert rc == 1 and time.monotonic() - t0 < 30
        rows = json.loads((tmp_path / "t.json").read_text())["results"]
        n = len(grid("cuda", quick=False))
        assert len(rows) == n and not any(r["ok"] for r in rows)
        assert [r["error"] for r in rows[:2]] == ["inactivity timeout 1s"] * 2
        assert {r["error"] for r in rows[2:]} == {
            "sweep aborted: two workers in a row hung"}

    def test_dead_child_costs_its_configuration(self, monkeypatch, tmp_path):
        monkeypatch.setattr(tune, "worker_command", lambda configs: [
            sys.executable, "-c", "raise SystemExit(3)"])
        rc = tune.main(["--backends", "cuda", "--limit", "2", "--out",
                        str(tmp_path / "t.json")])
        assert rc == 1
        rows = json.loads((tmp_path / "t.json").read_text())["results"]
        assert [r["error"] for r in rows] == ["worker died on this config"] * 2


@pytest.mark.parametrize("arg", ["--around"])
def test_around_refuses_a_results_file(tmp_path, arg, capsys):
    bad = tmp_path / "results.json"
    bad.write_text(json.dumps({"results": []}))
    assert tune.main([arg, str(bad), "--out", str(tmp_path / "t.json")]) == 1
    assert "does not hold a tuned" in capsys.readouterr().out
