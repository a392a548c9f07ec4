"""The layout ranker (``bitcoin_miner_tpu_torch.probes.frontier``, the
``frontier`` subcommand): the classes of the reference's
``tests/test_frontier.py`` for the port — the scoring model, enumeration,
ranking, the stub path, resume by the library's digest, the battery
contract, the variants in sync with ``ops/sha256_tile.VARIANTS`` and the
``--variant`` choices, and the command line's dispatch — and the scorer
fed ptxas logs and reads recorded from the card
(``tests/fixtures/ptxas/``, which names the card and its power limit)."""

import json
import os
import subprocess
import sys

import pytest

from bitcoin_miner_tpu_torch.ops import csrc
from bitcoin_miner_tpu_torch.ops.sha256_tile import VARIANTS
from bitcoin_miner_tpu_torch.probes import frontier, ptxas

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)  # chip_smoke.py
FIXTURE = os.path.join(REPO, "tests", "fixtures", "ptxas",
                       "h100_sxm_700w.json")


def _static(alu=1600, all_=2100, local=0, blocks=4, threads=256,
            n_blocks=2048, per_iter=1):
    return {"ok": True, "loop": {"alu": alu, "all": all_, "LDL": local,
                                 "STL": 0},
            "blocks_per_sm": blocks, "threads": threads,
            "n_blocks": n_blocks, "nonces_per_iter": per_iter}


def _cfg(**kw):
    cfg = frontier.enumerate_candidates()[0]["cfg"]
    return dict(cfg, **kw)


class TestScoringModel:
    def test_efficiency_round_trip(self):
        """A loop whose SASS bound is ``b`` at full occupancy and a whole
        last wave is predicted at b / EFFICIENCY."""
        score = frontier.score(_static(n_blocks=132 * 4 * 4), _cfg())
        assert score["occupancy_factor"] == 1.0
        assert score["tail_factor"] == 1.0
        assert score["predicted_ms"] == pytest.approx(
            score["bound_ms"] / frontier.EFFICIENCY, rel=1e-4)
        assert score["bound_source"] == "sass"

    def test_sass_bound_is_the_pipe_bound(self):
        from bitcoin_miner_tpu_torch.ops.sha256_torch import pipe_bound_ms

        card = frontier.CARD
        score = frontier.score(_static(), _cfg())
        assert score["bound_ms"] == pytest.approx(pipe_bound_ms(
            (1 << 24) * 1600, (1 << 24) * 2100, card["sms"],
            card["sm_clock_mhz"] * 1e6), rel=1e-4)

    def test_spills_never_score_better(self):
        preds = [frontier.score(_static(local=n), _cfg(), spill_slots=4)[
            "predicted_ms"] for n in (0, 10, 40, 160)]
        assert preds == sorted(preds)
        assert preds[-1] > preds[0]

    def test_fewer_warps_never_score_better(self):
        preds = [frontier.score(_static(blocks=b), _cfg(),
                                warps_to_hide=24)["predicted_ms"]
                 for b in (4, 3, 2, 1)]
        assert preds == sorted(preds)
        assert preds[-1] > preds[0]

    def test_a_ragged_last_wave_costs(self):
        whole = frontier.score(_static(blocks=4, n_blocks=528), _cfg())
        ragged = frontier.score(_static(blocks=4, n_blocks=529), _cfg())
        assert ragged["tail_factor"] < whole["tail_factor"] == 1.0
        assert ragged["predicted_ms"] > whole["predicted_ms"]

    def test_interleave_counts_nonces_per_iteration(self):
        one = frontier.score(_static(), _cfg())
        two = frontier.score(_static(alu=3200, all_=4200, per_iter=2),
                             _cfg(interleave=2))
        assert two["bound_ms"] == pytest.approx(one["bound_ms"])

    def test_rolled_form_takes_its_operation_bound(self):
        from bitcoin_miner_tpu_torch.ops.sha256_torch import bound_ms

        card = frontier.CARD
        score = frontier.score(_static(), _cfg(unroll=8))
        assert score["bound_source"] == "operations"
        assert score["bound_ms"] == pytest.approx(bound_ms(
            1 << 24, True, card["sms"], card["sm_clock_mhz"] * 1e6,
            spec=False) * frontier.SASS_OVER_OPS, rel=1e-4)

    def test_unscoreable_read_is_none(self):
        assert frontier.score({}, _cfg())["predicted_mhs"] is None
        assert frontier.score(_static(blocks=0), _cfg())[
            "predicted_mhs"] is None

    def test_hashes_count_every_chain(self):
        one = frontier.score(_static(), _cfg())
        four = frontier.score(_static(), _cfg(vshare=4))
        assert four["predicted_mhs"] == pytest.approx(
            4 * one["predicted_mhs"], rel=1e-3)

    def test_blocks_from_registers(self):
        assert frontier.blocks_from_registers(64, 256) == 4
        assert frontier.blocks_from_registers(128, 256) == 2
        assert frontier.blocks_from_registers(255, 256) == 1
        assert frontier.blocks_from_registers(254, 128) == 2
        assert frontier.blocks_from_registers(32, 128) == 16
        # The staged plane: 2 slots x 24 KB fit 4 blocks of 128 threads.
        assert frontier.blocks_from_registers(
            64, 128, 2 * 48 * 4 * 128) == 4

    def test_fit_recovers_the_constants_it_scores_with(self):
        rows = []
        for blocks, local in ((1, 0), (2, 0), (4, 0), (1, 30), (2, 60)):
            static = _static(blocks=blocks, local=local)
            ms = frontier.score(static, _cfg(), warps_to_hide=16,
                                spill_slots=8)["predicted_ms"]
            rows.append({"static": static, "config": _cfg(), "ms": ms})
        best = frontier.fit(rows)
        assert (best["warps_to_hide"], best["spill_slots"]) == (16, 8)
        assert best["mse_log"] == pytest.approx(0.0, abs=1e-9)

    def test_rank_correlation(self):
        rho = frontier.rank_correlation
        assert rho([1, 2, 3, 4], [2, 4, 6, 8]) == 1.0
        assert rho([1, 2, 3, 4], [8, 6, 4, 2]) == -1.0
        assert rho([1, 2], [1, 2]) is None
        assert rho([1, 1, 1], [1, 2, 3]) is None
        assert -1 < rho([1, 2, 3, 4, 5], [2, 1, 4, 3, 5]) < 1


_LISTING = """
\tcode for sm_90a
\t\tFunction : _ZN4_GLOBAL__16scan_tile_kernelILi1ELi1ELi1ELb1EEEvPKjPiPjjNS_9LaunchMinE
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_1:
        /*0010*/                   IADD3 R1, R1, 0x1, RZ ;
        /*0020*/                   LOP3.LUT R2, R1, R2, RZ, 0x3c, !PT ;
        /*0030*/                   LDL R3, [R1] ;
        /*0040*/                   LDS R4, [R1] ;
        /*0050*/                   BRA `(.L_x_1) ;
\t\tFunction : _ZN4_GLOBAL__16scan_tile_kernelILi1ELi1ELi1ELb0EEEvPKjPiPjjNS_9LaunchMinE
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_2:
        /*0010*/                   IADD3 R1, R1, 0x1, RZ ;
        /*0020*/                   BRA `(.L_x_2) ;
"""
_LOG = ("ptxas info    : Compiling entry function '_ZN4_GLOBAL__16scan_tile_"
        "kernelILi1ELi1ELi1ELb0EEEvPKjPiPjjNS_9LaunchMinE' for 'sm_90a'\n"
        "ptxas info    : Used 50 registers, 64 bytes smem\n"
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL__16scan_tile_"
        "kernelILi1ELi1ELi1ELb1EEEvPKjPiPjjNS_9LaunchMinE' for 'sm_90a'\n"
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 40 registers, 64 bytes smem\n")


_NESTED = """
\tcode for sm_90a
\t\tFunction : _ZN4_GLOBAL__23scan_tile_staged_kernelILi8ELi1ELi1ELb1ELNS_7VariantE5EEEvNS_8JobWordsIXT_EEEPiPjjNS_9LaunchMinE
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_1:
        /*0010*/                   STS [R1], R2 ;
        /*0020*/                   IADD3 R1, R1, 0x1, RZ ;
.L_x_2:
        /*0030*/                   LDS R4, [R1] ;
        /*0040*/                   LOP3.LUT R2, R1, R4, RZ, 0x3c, !PT ;
        /*0050*/               @P0 BRA `(.L_x_2) ;
        /*0060*/                   IADD3 R3, R3, 0x1, RZ ;
        /*0070*/                   BRA `(.L_x_1) ;
"""
_NESTED_LOG = ("ptxas info    : Compiling entry function '_ZN4_GLOBAL__23scan_"
               "tile_staged_kernelILi8ELi1ELi1ELb1ELNS_7VariantE5EEEvNS_8Job"
               "WordsIXT_EEEPiPjjNS_9LaunchMinE' for 'sm_90a'\n"
               "ptxas info    : Used 128 registers, 512 bytes smem\n")


class TestRead:
    def test_reads_the_word7_kernel_only(self):
        read = frontier.read_kernel("scan_tile_kernel", _LOG, _LISTING)
        assert read == {"ok": True, "spill_stores": 8, "spill_loads": 8,
                        "registers": 40, "static_smem": 64,
                        "loop": {"alu": 2, "fma": 0, "other": 3, "all": 5,
                                 "LDL": 1, "STL": 0, "LDS": 1, "STS": 0,
                                 "LDG": 0}}

    def test_a_rolled_inner_loop_counts_once_a_run(self):
        """The nonce loop (.L_x_1) holds a rolled loop (.L_x_2) that runs
        twice an iteration: its 3 instructions count twice."""
        once = frontier.read_kernel("scan_tile_staged_kernel", _NESTED_LOG,
                                    _NESTED)
        twice = frontier.read_kernel("scan_tile_staged_kernel", _NESTED_LOG,
                                     _NESTED, inner_trips=2)
        assert once["loop"] == {"alu": 3, "fma": 0, "other": 4, "all": 7,
                                "LDL": 0, "STL": 0, "LDS": 1, "STS": 1,
                                "LDG": 0}
        assert twice["loop"] == {"alu": 4, "fma": 0, "other": 6, "all": 10,
                                 "LDL": 0, "STL": 0, "LDS": 2, "STS": 1,
                                 "LDG": 0}
        cfg = _cfg(vshare=8, variant="vroll-db")
        assert frontier._inner_trips(cfg) == 2
        assert frontier.read_library(cfg, _NESTED_LOG, _NESTED) == (
            frontier.with_launch(twice, cfg))
        assert frontier._inner_trips(_cfg(vshare=4, variant="vroll-db")) == 1

    def test_a_missing_kernel_is_a_failed_read(self):
        read = frontier.read_library(_cfg(variant="wstage"), _LOG, _LISTING)
        assert not read["ok"] and "scan_tile_staged_kernel" in read["error"]

    def test_launch_shape_per_candidate(self):
        read = frontier.read_kernel("scan_tile_kernel", _LOG, _LISTING)
        one = frontier.with_launch(read, _cfg())
        wide = frontier.with_launch(read, _cfg(sublanes=16), 3)
        assert (one["threads"], one["n_blocks"], one["blocks_per_sm"],
                one["blocks_per_sm_source"]) == (256, 2048, 6, "registers")
        assert (wide["n_blocks"], wide["blocks_per_sm"],
                wide["blocks_per_sm_source"]) == (1024, 3,
                                                  "scan_tile_occupancy")
        staged = frontier.with_launch(read, _cfg(variant="vroll-db",
                                                 interleave=2))
        assert (staged["threads"], staged["nonces_per_iter"]) == (128, 4)


class TestEnumeration:
    def test_at_least_20_candidates(self):
        assert len(frontier.enumerate_candidates()) >= 20

    def test_names_unique_and_configs_valid(self):
        from bitcoin_miner_tpu_torch.ops.sha256_tile import check_layout

        cands = frontier.enumerate_candidates()
        names = [c["name"] for c in cands]
        assert len(names) == len(set(names))
        for cand in cands:
            cfg = cand["cfg"]
            assert cfg["kernel"] in ("tile", "hitbuf")
            assert 1 <= cfg["vshare"] <= 8
            if cfg["kernel"] == "tile":
                assert cfg["variant"] in VARIANTS
                check_layout(cfg["vshare"], cfg["variant"], cfg["cgroup"],
                             cfg["interleave"], cfg["inner_tiles"])
                assert (1 << 24) % (cfg["sublanes"] * 128
                                    * cfg["inner_tiles"]) == 0

    def test_every_smoke_library_of_the_scans_is_a_candidate(self):
        """The ranker reads the libraries the smoke builds: each layout at
        its K, the baselines at K = 1, 2, 4, 8, the forms, the hit buffer's
        anchor rows, and none beyond the smoke's."""
        import chip_smoke
        from bitcoin_miner_tpu_torch.ops import sha256_tile
        from bitcoin_miner_tpu_torch.ops.sha256_torch import hitbuf_library

        libs = {frontier.library_of(c["cfg"])
                for c in frontier.enumerate_candidates()}
        smoke = {sha256_tile.tile_library(*l)
                 for l in chip_smoke.tile_layouts(sha256_tile)}
        smoke |= {sha256_tile.tile_library(k, unroll=u, spec=sp)
                  for k in (1, 2) for u, sp in chip_smoke.FORMS}
        smoke |= {hitbuf_library(1, u, sp) for u, sp in chip_smoke.FORMS}
        smoke |= {sha256_tile.tile_library(k) for k in (1, 2, 4, 8)}
        assert smoke <= libs
        assert libs <= set(csrc.SOURCES) | smoke

    def test_anchor_mesh_and_geometry_rows(self):
        cands = {c["name"]: c["cfg"] for c in frontier.enumerate_candidates()}
        assert cands["hitbuf_k1"]["kernel"] == "hitbuf"
        for n in (2, 4):
            assert cands[f"mesh1x{n}_tile_k1"]["topology"] == f"1x{n}"
            assert cands[f"mesh1x{n}_hitbuf_k1"]["topology"] == f"1x{n}"
        geometries = {(c["sublanes"], c["inner_tiles"])
                      for c in cands.values() if c["kernel"] == "tile"}
        assert len(geometries) >= 3
        ks = {c["vshare"] for c in cands.values() if c["kernel"] == "tile"}
        assert ks == {1, 2, 4, 8}
        assert {c["cgroup"] for c in cands.values()
                if c["kernel"] == "tile"} >= {0, 2}
        assert {c["interleave"] for c in cands.values()
                if c["kernel"] == "tile"} == {1, 2}


class TestRanking:
    def test_rank_is_deterministic_and_sorted(self):
        entries = [
            {"name": "b", "ok": True, "static": {"spill_stores": 10},
             "score": {"predicted_mhs": 80.0}},
            {"name": "a", "ok": True, "static": {"spill_stores": 5},
             "score": {"predicted_mhs": 80.0}},
            {"name": "c", "ok": True, "static": {"spill_stores": 0},
             "score": {"predicted_mhs": 90.0}},
            {"name": "d", "ok": True, "static": {},
             "score": {"predicted_mhs": None}},
        ]
        ranked = frontier.rank_entries(list(entries))
        assert [e["name"] for e in ranked] == ["c", "a", "b", "d"]
        assert [e["rank"] for e in ranked] == [1, 2, 3, 4]
        again = frontier.rank_entries(list(ranked))
        assert [e["name"] for e in again] == ["c", "a", "b", "d"]


class TestStubCompilerPath:
    @pytest.fixture(scope="class")
    def run_dir(self, tmp_path_factory):
        d = tmp_path_factory.mktemp("frontier")
        rc = frontier.main(["--stub-compiler", "--out",
                            str(d / "frontier.json"), "--ledger",
                            str(d / "ledger.jsonl")])
        assert rc == 0
        return d

    def test_frontier_json_ranked(self, run_dir):
        doc = json.load(open(run_dir / "frontier.json"))
        assert doc["schema"] == "tpu-miner-frontier/1"
        assert doc["compiler"] == "stub"
        assert doc["n_candidates"] >= 20
        ranks = [e["rank"] for e in doc["ranking"]]
        assert ranks == list(range(1, len(ranks) + 1))
        preds = [e["score"]["predicted_mhs"] for e in doc["ranking"]]
        assert None not in preds and preds == sorted(preds, reverse=True)
        for e in doc["ranking"]:
            assert e["compiler"] == "stub" and e["ok"]
            assert e["digest"] == frontier.library_digest(e["config"])
            assert e["library"] == frontier.library_of(e["config"])

    def test_ledger_rows_validate_and_key_per_candidate(self, run_dir):
        from bitcoin_miner_tpu_torch.telemetry.perfledger import load_rows

        rows = load_rows(str(run_dir / "ledger.jsonl"))
        assert rows
        keys = set()
        for row in rows:
            assert row.metric == "frontier" and row.unit == "MH/s"
            assert row.raw["compiler"] == "stub"
            keys.add(row.key())
        assert len(keys) == len(rows)

    def test_rerun_is_idempotent(self, run_dir):
        before = open(run_dir / "ledger.jsonl").read().splitlines()
        rc = frontier.main(["--stub-compiler", "--out",
                            str(run_dir / "frontier.json"), "--ledger",
                            str(run_dir / "ledger.jsonl")])
        assert rc == 0
        after = open(run_dir / "ledger.jsonl").read().splitlines()
        assert len(after) == len(before)

    def test_battery_refuses_stub_ranking(self, run_dir, capsys):
        rc = frontier.main(["--battery", "4", "--out",
                            str(run_dir / "frontier.json")])
        assert rc == 0
        assert capsys.readouterr().out.strip() == ""

    def test_limit_and_filter(self, tmp_path):
        rc = frontier.main(["--stub-compiler", "--filter", "tile_k4_",
                            "--out", str(tmp_path / "f.json"),
                            "--ledger", ""])
        assert rc == 0
        names = {e["name"] for e in json.load(open(tmp_path / "f.json"))[
            "ranking"]}
        assert names and all("tile_k4_" in n for n in names)
        rc = frontier.main(["--stub-compiler", "--limit", "3", "--out",
                            str(tmp_path / "g.json"), "--ledger", ""])
        assert rc == 0
        assert json.load(open(tmp_path / "g.json"))["n_candidates"] == 3

    def test_top_restricts_to_current_ranking(self, run_dir, capsys):
        before = json.load(open(run_dir / "frontier.json"))
        rc = frontier.main(["--stub-compiler", "--top", "3", "--out",
                            str(run_dir / "frontier.json"), "--ledger", ""])
        assert rc == 0
        out = capsys.readouterr().out
        assert "[3/3]" in out and "[4/4]" not in out
        after = json.load(open(run_dir / "frontier.json"))
        assert after["n_candidates"] == before["n_candidates"]

    def test_top_without_prior_document_fails(self, tmp_path):
        assert frontier.main(["--stub-compiler", "--top", "3", "--out",
                              str(tmp_path / "absent.json"),
                              "--ledger", ""]) == 1

    def test_no_candidates_fail(self, tmp_path):
        assert frontier.main(["--stub-compiler", "--filter", "nothing",
                              "--out", str(tmp_path / "f.json"),
                              "--ledger", ""]) == 1

    def test_defaults_stay_under_build(self):
        args = frontier.build_parser().parse_args(["--stub-compiler"])
        out, ledger = frontier.resolve_paths(args)
        assert out == frontier.STUB_OUT != frontier.DEFAULT_OUT
        assert ledger is None
        out, ledger = frontier.resolve_paths(
            frontier.build_parser().parse_args([]))
        for path in (out, ledger, frontier.STUB_OUT):
            assert path.startswith(os.path.join(REPO, "build") + os.sep)
            assert "benchmarks" not in path


class TestResumeByDigest:
    def _seed(self, tmp_path, capsys):
        out = tmp_path / "f.json"
        assert frontier.main(["--stub-compiler", "--filter", "tile_k1",
                              "--out", str(out), "--ledger", ""]) == 0
        capsys.readouterr()
        return out

    def test_current_digest_resumes_silently(self, tmp_path, capsys):
        out = self._seed(tmp_path, capsys)
        assert frontier.main(["--stub-compiler", "--filter", "tile_k1",
                              "--out", str(out), "--ledger", ""]) == 0
        captured = capsys.readouterr()
        assert "reusing prior" in captured.out
        assert "resume cache invalidated" not in captured.err

    def test_a_changed_source_invalidates_the_cached_read(self, tmp_path,
                                                          capsys):
        """An entry whose library digest is not today's (an edited .cu) is
        read again, and the log says so."""
        out = self._seed(tmp_path, capsys)
        doc = json.load(open(out))
        stale = doc["ranking"][0]
        stale["digest"] = "0" * 12
        out.write_text(json.dumps(doc))
        assert [s["name"] for s in frontier.resume_invalidated(
            str(out), "stub")] == [stale["name"]]
        assert _key(stale) not in frontier._prior_entries(str(out), "stub")
        assert frontier.main(["--stub-compiler", "--filter", "tile_k1",
                              "--out", str(out), "--ledger", ""]) == 0
        captured = capsys.readouterr()
        assert "resume cache invalidated 1 prior entry" in captured.err
        assert f"{stale['name']}: stub model" in captured.out
        after = json.load(open(out))
        assert all(e["digest"] == frontier.library_digest(e["config"])
                   for e in after["ranking"])

    def test_recompile_reads_everything_again(self, tmp_path, capsys):
        out = self._seed(tmp_path, capsys)
        assert frontier.main(["--stub-compiler", "--filter", "tile_k1",
                              "--recompile", "--out", str(out),
                              "--ledger", ""]) == 0
        assert "reusing prior" not in capsys.readouterr().out

    def test_digest_follows_the_sources_and_flags(self):
        cfg = frontier.enumerate_candidates()[0]["cfg"]
        digest = frontier.library_digest(cfg)
        assert len(digest) == 12
        assert csrc.library_path(frontier.library_of(cfg)).name.endswith(
            f"-{digest}.so")
        other = dict(cfg, vshare=2)
        assert frontier.library_digest(other) != digest


def _key(entry):
    return frontier._config_key(entry["config"])


class TestBatteryContract:
    def _doc(self, tmp_path, entries):
        path = tmp_path / "frontier.json"
        path.write_text(json.dumps({"schema": "tpu-miner-frontier/1",
                                    "compiler": "nvcc",
                                    "ranking": entries}))
        return str(path)

    @staticmethod
    def _entry(rank, name, pred=8000.0, **cfg):
        return {"rank": rank, "name": name, "ok": True, "compiler": "nvcc",
                "config": _cfg(**cfg), "score": {"predicted_mhs": pred},
                "static": {}}

    def test_top_n_benchable_lines(self, tmp_path, capsys):
        entries = [
            self._entry(1, "tile_k4_wsplit", vshare=4, variant="wsplit"),
            self._entry(2, "unscored", pred=None),
            self._entry(3, "hitbuf_k1", kernel="hitbuf", inner_bits=18),
        ]
        rc = frontier.main(["--battery", "2", "--out",
                            self._doc(tmp_path, entries)])
        assert rc == 0
        assert capsys.readouterr().out.strip().splitlines() == [
            "tile_k4_wsplit|--backend cuda-tile --sublanes 8 --inner-tiles "
            "8 --variant wsplit --vshare 4",
            "hitbuf_k1|--backend cuda --inner-bits 18 --vshare 1",
        ]

    def test_battery_flags_are_valid_bench_flags(self, tmp_path, capsys):
        """Every line parses under the bench's parser and builds the
        configuration through the command line's ``make_hasher`` on the
        CPU: the battery never emits a stage that dies on its options."""
        from bitcoin_miner_tpu_torch import bench, cli

        entries = [
            self._entry(1, "a", vshare=2, variant="regchain", interleave=2),
            self._entry(2, "b", vshare=8, variant="wstage", cgroup=2),
            self._entry(3, "c", vshare=4, variant="vroll", sublanes=16),
            self._entry(4, "d", unroll=8),
            self._entry(5, "e", kernel="hitbuf", inner_bits=18, spec=False),
            self._entry(6, "f", topology="1x2"),
            self._entry(7, "g", kernel="hitbuf", topology="1x4"),
            self._entry(8, "h", sublanes=24),
        ]
        rc = frontier.main(["--battery", "8", "--out",
                            self._doc(tmp_path, entries)])
        assert rc == 0
        lines = capsys.readouterr().out.strip().splitlines()
        assert len(lines) == 8
        for line, entry in zip(lines, entries):
            flags = line.split("|", 1)[1].split()
            args = bench.build_parser().parse_args(flags)
            cfg = entry["config"]
            assert args.backend == frontier.backend_of(cfg)
            assert args.vshare == cfg["vshare"]
            if cfg["kernel"] == "tile":
                assert args.sublanes == cfg["sublanes"]
                assert args.variant in (None, cfg["variant"])
                assert args.batch_3x == (cfg["sublanes"] == 24)
            if cfg.get("topology"):
                assert args.mesh_devices == int(cfg["topology"][-1])
                continue
            argv = ["--bench", *flags, "--device", "cpu"]
            if "--batch-3x" in flags:
                argv += ["--batch-bits", "13"]
            hasher = cli.make_hasher(cli.build_parser().parse_args(argv))
            assert hasher.name == frontier.backend_of(cfg)

    def test_unbenchable_heights_are_left_out(self):
        assert frontier.config_bench_flags(_cfg(sublanes=20)) is None
        assert frontier.bench_flags({"compiler": "stub",
                                     "config": _cfg()}) is None

    def test_missing_or_foreign_document_fails(self, tmp_path):
        assert frontier.main(["--battery", "2", "--out",
                              str(tmp_path / "absent.json")]) == 1
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps({"schema": "something-else/1"}))
        assert frontier.main(["--battery", "2", "--out", str(bad)]) == 1


def test_variant_choices_stay_in_sync():
    """``ops/sha256_tile.VARIANTS`` is the vocabulary; the command line's
    ``--variant`` choices repeat it; the ranker's layouts and the staged
    family draw from it."""
    from bitcoin_miner_tpu_torch import cli
    from bitcoin_miner_tpu_torch.ops import sha256_tile

    choices = next(a.choices for a in cli.build_parser()._actions
                   if "--variant" in a.option_strings)
    assert tuple(choices) == VARIANTS
    used = {c["cfg"]["variant"] for c in frontier.enumerate_candidates()
            if c["cfg"]["kernel"] == "tile"}
    assert used == set(VARIANTS)
    assert frontier.STAGED == sha256_tile.STAGED_VARIANTS


class TestCliDispatch:
    def test_frontier_subcommand_dispatches(self, tmp_path):
        out = tmp_path / "f.json"
        proc = subprocess.run(
            [sys.executable, "-m", "bitcoin_miner_tpu_torch", "frontier",
             "--stub-compiler", "--limit", "2", "--out", str(out),
             "--ledger", ""],
            capture_output=True, text=True, timeout=120, cwd=REPO)
        assert proc.returncode == 0, proc.stderr[-500:]
        assert json.load(open(out))["n_candidates"] == 2

    def test_subcommand_table(self):
        from bitcoin_miner_tpu_torch import cli

        assert cli.SUBCOMMANDS["frontier"] == ("probes.frontier", "main")


class TestRecordedOnTheCard:
    """ptxas logs and reads of the card (``tests/fixtures/ptxas/``): the
    package's parser reads the logs as the card's run read them, and the
    model scores the recorded reads near the times measured with them."""

    @pytest.fixture(scope="class")
    def fixture(self):
        with open(FIXTURE) as fh:
            return json.load(fh)

    def test_fixture_names_the_card_and_its_limit(self, fixture):
        assert fixture["card"].startswith("NVIDIA H100")
        assert fixture["card"].endswith(" W")
        assert fixture["logs"] and fixture["reads"]

    def test_logs_parse_to_the_recorded_reads(self, fixture):
        for name, read in fixture["reads"].items():
            library = read["library"]
            rows = ptxas.ptxas_table({library: fixture["logs"][library]})
            kernel = frontier._kernel_name(read["config"])
            row = next(r for r in rows
                       if (r["kernel"], r["mode"]) == (kernel, "word7"))
            for key in ("registers", "spill_stores", "static_smem"):
                assert row.get(key, 0) == read["static"].get(key, 0), (
                    name, key)

    def test_scores_of_the_recorded_reads_are_near_their_times(self,
                                                               fixture):
        """Within the fixture's tolerance (25%) of every recorded time."""
        card = fixture["card_model"]
        for name, read in fixture["reads"].items():
            got = frontier.score(read["static"], read["config"], card)
            assert got["predicted_ms"] == pytest.approx(
                read["measured_ms"], rel=fixture["tolerance"]), name

    def test_the_default_kernel_is_calibrated(self, fixture):
        read = fixture["reads"]["tile_k1"]
        base = fixture["scan_tile"]
        assert read["measured_ms"] == base["ms"]
        got = frontier.score(read["static"], read["config"],
                             fixture["card_model"])
        assert got["predicted_ms"] == pytest.approx(base["ms"], rel=2e-3)
        assert frontier.SASS_OVER_OPS == pytest.approx(
            base["sass_bound_ms"] / base["bound_ms"], abs=1e-4)

    def test_refit_gives_the_modules_constants(self, fixture):
        rows = [{"static": r["static"], "config": r["config"],
                 "ms": r["measured_ms"]} for r in fixture["reads"].values()]
        best = frontier.fit(rows, fixture["card_model"])
        assert (best["warps_to_hide"], best["spill_slots"],
                best["shared_slots"]) == (frontier.WARPS_TO_HIDE,
                                          frontier.SPILL_SLOTS,
                                          frontier.SHARED_SLOTS)

    def test_predicted_order_follows_the_measured_one(self, fixture):
        """Spearman's rho of predicted against measured times per K, as
        recorded: 0.44, 0.74, 0.91, 0.93 at K = 1, 2, 4, 8."""
        card = fixture["card_model"]
        for k, floor in ((1, 0.4), (2, 0.7), (4, 0.9), (8, 0.9)):
            at = [r for r in fixture["reads"].values()
                  if r["config"]["vshare"] == k]
            rho = frontier.rank_correlation(
                [frontier.score(r["static"], r["config"], card)[
                    "predicted_ms"] for r in at],
                [r["measured_ms"] for r in at])
            assert rho >= floor, (k, rho)


class TestRedesignedGeometry:
    """The ranker's model of blocks per SM for the launch shapes of the
    builds whose launch bounds ask for a minimum of blocks
    (``sha256_tile.min_blocks``): at the registers those bounds allow and
    the plane they stage, 16 warps per SM; at the parent's registers and
    full plane, recorded on the card in the fixture, 8."""

    REDESIGNED = {"tile_k8_regchain": (8, "regchain", 0, 1),
                  "tile_k8_vroll_db": (8, "vroll-db", 0, 1),
                  "tile_k2_vroll_db_i2": (2, "vroll-db", 0, 2)}

    @pytest.mark.parametrize("read", sorted(REDESIGNED))
    def test_sixteen_warps_at_the_new_registers_and_plane(self, read):
        from bitcoin_miner_tpu_torch.ops import sha256_tile

        k, variant, cgroup, interleave = self.REDESIGNED[read]
        cfg = _cfg(vshare=k, variant=variant, cgroup=cgroup,
                   interleave=interleave)
        threads, _, _ = frontier._launch_shape(cfg)
        assert threads == sha256_tile.launch_threads(variant, interleave,
                                                     8192)
        blocks = sha256_tile.min_blocks(k, variant, interleave)
        cap = frontier.REGS_PER_SM // (blocks * threads)
        assert cap == 128
        smem = sha256_tile.plane_bytes(variant, interleave)
        assert frontier.blocks_from_registers(cap, threads, smem) == blocks
        assert blocks * threads // 32 == 16
        # The stub compiler keeps to the same bounds.
        stub = frontier.stub_read(cfg)
        assert stub["registers"] <= cap
        assert stub["blocks_per_sm"] * threads // 32 >= 16

    @pytest.mark.parametrize("read", sorted(REDESIGNED))
    def test_eight_warps_at_the_parents_reads(self, read):
        with open(FIXTURE) as fh:
            static = json.load(fh)["reads"][read]["static"]
        # vroll-db stages one full slot per nonce of an iteration.
        full = static["nonces_per_iter"] * 48 * 4 * 128 if (
            "vroll" in read) else 0
        blocks = frontier.blocks_from_registers(
            static["registers"], static["threads"], full)
        assert blocks == static["blocks_per_sm"]
        assert blocks * static["threads"] // 32 == 8

    def test_the_partial_plane(self):
        """vroll-db at two nonces in flight stages W[18..44]: four slots of
        27 words fit a quarter of the SM beside three other blocks, the
        full 48 words would not; its rolled forms keep the full plane."""
        from bitcoin_miner_tpu_torch.ops import sha256_tile

        assert sha256_tile.plane_words("vroll-db", 2) == (18, 27)
        assert sha256_tile.plane_bytes("vroll-db", 2) == 4 * 27 * 4 * 128
        quarter = frontier.SMEM_PER_SM // 4 - frontier.SMEM_RESERVED
        assert sha256_tile.plane_bytes("vroll-db", 2) <= quarter - 512
        assert 4 * 28 * 4 * 128 > quarter - 512
        assert sha256_tile.plane_words("vroll-db", 2, unroll=8) == (16, 48)
        for variant, interleave in (("vroll-db", 1), ("vroll-db", 4),
                                    ("vroll", 2), ("wstage", 2)):
            assert sha256_tile.plane_words(variant, interleave) == (16, 48)

    def test_vroll_db_past_4_chains_rolls_its_groups(self):
        """vroll-db at K=8 runs its groups' passes in a rolled loop; no
        other layout, and no vroll-db at K <= 4, does."""
        from bitcoin_miner_tpu_torch.ops import sha256_tile

        assert sha256_tile.rolled_groups(8, "vroll-db")
        for k in (1, 2, 4):
            assert not sha256_tile.rolled_groups(k, "vroll-db")
        for variant in ("wstage", "vroll", "regchain", "baseline"):
            assert not sha256_tile.rolled_groups(8, variant)

    def test_only_the_redesigned_driven_builds_ask_for_blocks(self):
        """Among the layouts the smoke, the gate and the ranker drive, the
        three redesigned builds alone change their launch bounds; every
        other library keeps the thread count alone."""
        from bitcoin_miner_tpu_torch.ops import sha256_tile

        asked = [l for l in sha256_tile.driven_layouts()
                 if sha256_tile.min_blocks(l[0], l[1], l[3])]
        assert sorted(asked) == sorted(self.REDESIGNED.values())
