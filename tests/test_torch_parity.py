"""The bulk parity gate (``bitcoin_miner_tpu_torch.probes.parity``) on the
CPU: each leg with ``--device cpu`` at 2^13–2^14 hashes, the same hit sets
as the reference's ``TpuHasher`` (``benchmarks/parity_tpu.py``, loaded by
path) on the gate's seeded headers, leg C's slots against the reference's
Pallas kernel in interpret mode, a planted fault that the gate catches,
and a CPU-sized, unmarked counterpart of ``tests/test_parity_bulk.py``.
On the card ``tests/test_torch_cuda.py`` runs each leg (``gpu``)."""

import dataclasses
import importlib.util
import json
import os
import random

import numpy as np
import pytest
import torch

from bitcoin_miner_tpu_torch.backends import native
from bitcoin_miner_tpu_torch.backends.cuda import (
    CudaHasher,
    TileCudaHasher,
    sibling_version_patterns,
)
from bitcoin_miner_tpu_torch.ops.sha256_tile import (
    driven_layouts,
    job_block_from_header,
    scan_tile,
)
from bitcoin_miner_tpu_torch.probes import parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference():
    spec = importlib.util.spec_from_file_location(
        "parity_tpu_reference", os.path.join(REPO, "benchmarks",
                                             "parity_tpu.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


class TestLegs:
    def test_core_legs_on_the_cpu(self, capsys):
        rc = parity.main(["--device", "cpu", "--bits", "14", "--legs",
                          "core"])
        lines = _lines(capsys)
        assert rc == 0, [r for r in lines if not r.get("ok")]
        summary = lines[-1]
        assert summary["metric"] == "parity_bulk_summary" and summary["ok"]
        legs = [r for r in lines[:-1]]
        assert {r["leg"] for r in legs} == {"scan_exact", "word7_digest",
                                            "tile_word7"}
        scan = [r for r in legs if r["leg"] == "scan_exact"]
        # cuda: the default and 4 forms; cuda-tile: the baseline, the 5
        # layouts at K=1 and 4 forms.
        assert len(scan) == 5 + 10
        for r in scan:
            assert r["hashes"] == 1 << 14 and r["mismatched_headers"] == 0
            assert r["hits"] > (r["hashes"] >> 8) // 2
        assert {tuple(r["libraries"]) for r in scan
                if r["backend"] == "cuda-tile"} >= {
            ("scan_tile", "rescan_steps"),
            ("scan_tile_vroll_db_k1_g1_i1", "rescan_steps"),
            ("scan_tile_u8", "rescan_steps_u8")}
        for r in legs:
            assert r["seconds"] >= 0 and "config" in r
        assert summary["configurations"] == len(legs) == 15 + 5 + 10

    def test_vshare_leg_on_the_cpu(self, capsys):
        rc = parity.main(["--device", "cpu", "--bits", "13", "--legs",
                          "vshare", "--vshare-ks", "2"])
        lines = _lines(capsys)
        assert rc == 0, [r for r in lines if not r.get("ok")]
        legs = lines[:-1]
        # cuda at K=2; cuda-tile: the baseline, the layouts driven at K=2
        # and the 4 forms built at K=2.
        layouts = [l for l in driven_layouts() if l[0] == 2]
        assert len(legs) == 1 + 1 + len(layouts) + 4
        for r in legs:
            assert r["leg"] == "vshare_siblings" and r["vshare"] == 2
            assert r["reserved_bits"] == 1 and r["sibling_hits"] > 0
            assert r["hashes"] == (1 << 13) * 2

    def test_unknown_backend_is_refused(self, capsys):
        assert parity.main(["--device", "cpu", "--backends", "tpu"]) == 2

    def test_evidence_appends_every_line(self, tmp_path, capsys):
        path = tmp_path / "evidence.jsonl"
        rc = parity.main(["--device", "cpu", "--bits", "13", "--legs",
                          "core", "--backends", "cuda", "--evidence",
                          str(path)])
        assert rc == 0
        rows = [json.loads(l) for l in path.read_text().splitlines()]
        assert rows[-1]["metric"] == "parity_bulk_summary"
        assert all("measured" in r for r in rows)
        assert len(rows) == len(_lines(capsys))


class TestAgainstTheReference:
    def test_same_hit_sets_as_the_references_tpu_hasher(self):
        """The gate's seeded headers through the reference's own leg-A
        hasher and the port's two hashers: the same hits and totals."""
        ref = _reference()
        per_header = 1024
        headers = parity._headers(random.Random(parity.SEED), 4, per_header)
        tpu = ref._make_hasher("tpu", per_header)
        ports = [parity.make_hasher({"backend": b, "vshare": 1}, per_header,
                                    "cpu") for b in parity.BACKENDS]
        total = 0
        for header76, start in headers:
            want = tpu.scan(header76, start, per_header, parity.TARGET_EXACT,
                            max_hits=4096)
            for hasher in ports:
                got = hasher.scan(header76, start, per_header,
                                  parity.TARGET_EXACT, max_hits=4096)
                assert (got.nonces, got.total_hits) == (want.nonces,
                                                        want.total_hits)
            total += want.total_hits
        assert total > 0

    def test_seed_and_constants_are_the_references(self):
        ref = open(os.path.join(REPO, "benchmarks", "parity_tpu.py")).read()
        assert "random.Random(0x7A17)" in ref and parity.SEED == 0x7A17
        assert "mask = 0x1FFFE000" in ref and parity.VSHARE_MASK == 0x1FFFE000
        assert "t0 = 0x00FFFFFF" in ref and parity.WORD7_T0 == 0x00FFFFFF
        assert "target = 1 << 248" in ref
        assert parity.TARGET_EXACT == 1 << 248

    def test_word7_expectation_is_the_references(self):
        ref = _reference()
        header76 = bytes(range(76))
        nonces = list(range(1000, 1300))
        assert parity.cpu_word7(header76, nonces) == ref._cpu_word7(
            header76, nonces)

    def test_tile_word7_slots_against_the_pallas_kernel(self):
        """Leg C's raw slots at one small batch: the port's tile scan (its
        plain version here), the gate's hashlib expectation and the
        reference's Pallas kernel in interpret mode (rolled, unroll 8, to
        keep its compile short; every form computes the same function)."""
        from bitcoin_miner_tpu.ops.sha256_pallas import make_pallas_scan_fn

        batch, tile = 2048, 1024
        rng = random.Random(parity.SEED)
        header76 = rng.randbytes(76)
        start = rng.randrange((1 << 32) - batch)
        job = job_block_from_header(header76, parity.WORD7_T0 << 224, start,
                                    batch)
        scan, step = make_pallas_scan_fn(
            batch_size=batch, sublanes=8, interpret=True, unroll=8,
            word7=True, inner_tiles=1, spec=False)
        assert step == tile
        want_counts, want_mins = (np.asarray(x) for x in scan(job.numpy()))
        counts, mins = scan_tile(job, n_steps=batch // tile, block=tile,
                                 word7=True)
        assert counts.tolist() == want_counts.tolist()
        assert mins.to(torch.int64).tolist() == [
            int(m) for m in want_mins]
        cand = parity.word7_candidates(header76, start, batch)
        for t in range(batch // tile):
            hits = [start + t * tile + i for i in range(tile)
                    if cand[t * tile + i]]
            assert int(want_counts[t]) == len(hits)
            assert int(want_mins[t]) == (min(hits) if hits else 0xFFFFFFFF)


class DropsOneHit:
    """A hasher whose first scan with hits loses its last one."""

    def __init__(self, hasher):
        self.hasher = hasher
        self.dropped = False

    def __getattr__(self, name):
        return getattr(self.hasher, name)

    def scan(self, *args, **kwargs):
        res = self.hasher.scan(*args, **kwargs)
        if not self.dropped and res.nonces:
            self.dropped = True
            res = dataclasses.replace(res, nonces=res.nonces[:-1],
                                      total_hits=res.total_hits - 1)
        return res


class TestPlantedFault:
    def test_a_lost_hit_fails_the_gate_with_rc_2(self, monkeypatch, capsys):
        make = parity.make_hasher
        monkeypatch.setattr(parity, "make_hasher",
                            lambda *a: DropsOneHit(make(*a)))
        rc = parity.main(["--device", "cpu", "--bits", "13", "--legs",
                          "core", "--backends", "cuda"])
        lines = _lines(capsys)
        assert rc == 2
        scan = [r for r in lines if r.get("leg") == "scan_exact"]
        # Each configuration's hasher loses one hit of its first header.
        assert scan and all(r["mismatched_headers"] == 1 and not r["ok"]
                            for r in scan)
        assert lines[-1] == {**lines[-1], "metric": "parity_bulk_summary",
                             "ok": False}

    def test_a_lost_sibling_hit_fails_leg_d(self, capsys):
        def factory(config, per_header, device):
            hasher = parity.make_hasher(config, per_header, device)
            scan = hasher.scan

            def lossy(*args, **kwargs):
                res = scan(*args, **kwargs)
                return dataclasses.replace(
                    res, version_hits=res.version_hits[1:])
            hasher.scan = lossy
            return hasher

        records = list(parity.leg_vshare_siblings(
            13, random.Random(1), ["cuda"], "cpu", parity.Oracle(), (2,),
            hasher_factory=factory))
        assert len(records) == 1 and not records[0]["ok"]
        assert records[0]["mismatched_headers"] >= 1

    def test_a_raising_configuration_is_a_failed_line(self, capsys):
        records, ok = parity.run_gate(
            bits=13, backends=["cuda"], legs="core", device="cpu",
            emit=lambda r: None,
            hasher_factory=lambda *a: (_ for _ in ()).throw(
                RuntimeError("no card")))
        assert not ok
        assert "RuntimeError: no card" in records[0]["error"]


class TestBulkRandomHeaderParity:
    """The CPU-sized counterpart of the slow-marked
    ``tests/test_parity_bulk.py``: random headers at a target that gives
    hundreds of hits, the port's hashers (their plain versions) against
    the native oracle, and enough hits to show the compare ran."""

    N_HEADERS = 16
    PER_HEADER = 1024

    @pytest.mark.parametrize("backend", ["cuda", "cuda-tile"])
    def test_bulk_random_header_parity(self, backend):
        rng = random.Random(0xB17C01)
        hasher = (CudaHasher(batch_size=self.PER_HEADER,
                             inner_size=self.PER_HEADER, max_hits=4096,
                             device="cpu") if backend == "cuda" else
                  TileCudaHasher(batch_size=parity.MIN_TILE_BATCH,
                                 max_hits=4096, device="cpu"))
        target = 1 << 248
        total_hits = 0
        for i in range(self.N_HEADERS):
            header76 = rng.randbytes(76)
            start = rng.randrange((1 << 32) - self.PER_HEADER)
            a = hasher.scan(header76, start, self.PER_HEADER, target,
                            max_hits=4096)
            nonces, total = native.scan(header76, start, self.PER_HEADER,
                                        target, 4096)
            assert a.nonces == nonces, f"hit mismatch on header {i}"
            assert a.total_hits == total, f"count mismatch on header {i}"
            total_hits += a.total_hits
        expected = (self.N_HEADERS * self.PER_HEADER) >> 8
        assert total_hits > expected // 2


def test_configurations_cover_the_smokes_libraries():
    """Every K=1 layout and form the smoke builds is in leg A; leg D at K
    has every layout built at K."""
    tile = parity.configs("cuda-tile")
    assert len(tile) == 1 + 5 + 4
    for k in (2, 4, 8):
        got = {(c.get("variant", "baseline"), c.get("cgroup", 0),
                c.get("interleave", 1)) for c in parity.configs("cuda-tile",
                                                                k)}
        for kk, v, g, i in driven_layouts():
            if kk == k:
                assert (v, g, i) in got
    assert parity.configs("cuda", 4) == [{"backend": "cuda", "vshare": 4}]
    assert sibling_version_patterns(parity.VSHARE_MASK, 8)
