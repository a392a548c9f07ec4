#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA miner on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit and builds the kernels from
   ``bitcoin_miner_tpu_torch/ops/csrc`` (one nvcc per source and number of
   version-rolled chains K = 1..8, all at once), printing ptxas' registers
   and spills for every kernel and K;
2. holds every kernel against its plain PyTorch version on the card at the
   main path's shapes (2^24-nonce dispatches, the genesis job, a limit
   that cuts a step, a base near 2^32, a hit-buffer overflow), the tile
   scan at K = 1, 2, 3, 4, 8 and the hit-buffer scan at K = 1, 2, 4 —
   exact equality, since every output is an integer;
3. sweeps the genesis header's whole 2^32 nonce space at the difficulty-1
   target as ``--bench`` does with the command line's defaults
   (``TileCudaHasher`` in word7 mode, 2^24-nonce dispatches, the adaptive
   scheduler sizing requests) and must find and verify nonce 2083236893;
4. mines a Stratum session built as ``--pool URL --workers 4`` builds it
   (4 workers sharing one hasher, the adaptive scheduler) against the
   package's validating mock pool at difficulty 1/256; it needs ≥3
   accepted shares, then mines on for a fixed window whose rate is the
   tile kernel's launches × nonces per launch over the window, and needs
   none rejected and no hardware errors;
5. sweeps the genesis nonce space again as ``--bench --vshare 2`` does
   (two chains per nonce through the K=2 tile kernel: 2^33 hashes) and
   must find and verify the solve on chain 0, and verifies any sibling
   hit on the CPU; runs the ``cuda`` backend the same way at ``--vshare
   2`` over 2^26 nonces (the K=2 hit-buffer kernels);
6. mines a Stratum session as ``--pool URL --workers 4 --vshare 2``
   against a mock pool that grants the mask 0x1FFFE000: it needs ≥3
   accepted sibling shares (version bits other than the job's own) and ≥3
   of chain 0, then mines a fixed window whose rate counts K=2 launches ×
   2^24 × 2 hashes; and the same miner against a pool that grants no mask,
   which must degrade to chain 0 and launch only K=1 kernels;
7. times each kernel with CUDA events beside its plain version and its
   bound, the tile scan at K = 1, 2, 4 (and K = 3, 8 alone).

Phases 3 to 6 are the main path: the launch counts are set to 0 just
before each and read just after, and each kernel must have launched.
Every phase prints a JSON line; the kernel table and the card follow, and
the last line is ``{"ok": true, "device": {...}}``. Without a card, without
the package beside it, or when any phase fails, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import asyncio
import json
import re
import subprocess
import sys
import time
import traceback

GENESIS_NONCE = 2083236893
DISPATCH = 1 << 24
SESSION_WINDOW_S = 5.0  # the Stratum sessions' measured window
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
SWEEP_MHS_PR2 = 6823.0  # one-chain genesis sweep, H100 80GB HBM3 at 700 W
VERSION_MASK = 0x1FFFE000  # the full BIP 310 mask the vshare pool grants


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def launched(counts: dict) -> dict:
    """The launch counts of the kernels that launched."""
    return {name: n for name, n in counts.items() if n}


def ptxas_table(logs: dict) -> list:
    """Registers and spill bytes of every kernel in ptxas' ``-v`` logs,
    one row per library and entry function."""
    rows = []
    for lib, log in logs.items():
        row = None
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:
                mangled = entry.group(1)
                kernel = next(k for k in ("scan_tile", "scan_hitbuf",
                                          "hitbuf_compact")
                              if f"{k}_kernel" in mangled)
                mode = re.search(r"kernelILi\d+ELb([01])E", mangled)
                row = {"library": lib, "kernel": kernel,
                       "mode": ("word7" if mode.group(1) == "1" else "exact")
                       if mode else None}
                rows.append(row)
                continue
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
            regs = re.search(r"Used (\d+) registers", line)
            if row is not None and spill:
                row["spill_stores"] = int(spill.group(1))
                row["spill_loads"] = int(spill.group(2))
            if row is not None and regs:
                row["registers"] = int(regs.group(1))
    return rows


def nvidia_smi(query: str, units: bool = True) -> str:
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


class Smoke:
    def __init__(self, torch, pkg) -> None:
        self.torch = torch
        self.pkg = pkg
        self.dev = torch.device("cuda", 0)
        self.failed: list = []
        self.launches = {c.name: 0 for c in pkg.counters}
        self.kernels: dict = {}

    # -------------------------------------------------------------- helpers
    def phase(self, name, fn) -> None:
        t0 = time.perf_counter()
        try:
            out = fn() or {}
            emit({"phase": name, "ok": True,
                  "seconds": round(time.perf_counter() - t0, 3), **out})
        except Exception as e:  # noqa: BLE001 — reported, and fails the run
            self.failed.append(name)
            emit({"phase": name, "ok": False, "error": repr(e),
                  "trace": traceback.format_exc().splitlines()[-6:]})

    def reset_counts(self) -> None:
        for c in self.pkg.counters:
            c.reset()

    def read_counts(self) -> dict:
        counts = {c.name: c.value for c in self.pkg.counters}
        for name, n in counts.items():
            self.launches[name] += n
        return counts

    def job(self, header76, target, base, limit, k=1):
        """The job block of ``k`` chains: the header's own version and
        k-1 siblings inside VERSION_MASK."""
        version = int.from_bytes(header76[:4], "little")
        versions = [version] + [
            version ^ p
            for p in self.pkg.sibling_version_patterns(VERSION_MASK, k)]
        return self.pkg.job_block_from_header(
            header76, target, base, limit, versions=versions).to(self.dev)

    @staticmethod
    def hitbuf_parts(job, k=1):
        """(midstates, tail3, limbs, base, limit) of a job block of k
        chains; the midstate is (8,) at k=1 and (k, 8) otherwise."""
        mids = job[0:8] if k == 1 else job[0:8 * k].view(k, 8)
        t = 16 * k
        return mids, job[t:t + 3], job[t + 3:t + 11], job[t + 11], job[t + 12]

    def compare(self, name, got, want) -> int:
        """Max |kernel − plain| over all outputs; raises unless 0."""
        err = 0
        for g, w in zip(got, want):
            g = g.cpu().to(self.torch.int64)
            w = w.cpu().to(self.torch.int64)
            if g.shape != w.shape:
                raise AssertionError(f"{name}: shape {g.shape} != {w.shape}")
            err = max(err, int((g - w).abs().max()) if g.numel() else 0)
        if err:
            raise AssertionError(f"{name}: kernel differs from plain "
                                 f"version, max_abs_err={err}")
        self.kernels.setdefault(name, {"max_abs_err": 0})
        return err

    def time_ms(self, fn, reps: int) -> float:
        """Mean device time of ``fn``'s launches with CUDA events. A 2^24
        tile scan queued first keeps the card busy while the host queues
        the timed launches, so small kernels run back to back."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        blocker = self.job(bytes(76), 0, 0, DISPATCH)
        self.pkg.scan_tile(blocker, n_steps=DISPATCH // 8192, block=8192)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def plain_ms(self, fn) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3


def run(torch, pkg) -> int:
    s = Smoke(torch, pkg)
    name_power = nvidia_smi("name,power.limit")
    sm_clock_mhz = float(nvidia_smi("clocks.max.sm", units=False))
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def bound(nonces, word7, k=1):
        return pkg.bound_ms(nonces, word7, sms, sm_clock_mhz * 1e6, vshare=k)
    genesis76 = bytes.fromhex(pkg.GENESIS_HEADER_HEX)[:76]
    genesis_version = int.from_bytes(genesis76[:4], "little")
    diff1 = pkg.nbits_to_target(0x1D00FFFF)
    easy = pkg.difficulty_to_target(1 / (1 << 20))  # ~2^-12 per nonce
    header = bytes(range(76))
    top_base = (1 << 32) - DISPATCH + 777  # the range wraps past 2^32
    cut = DISPATCH - 3 * 8192 - 1234  # cuts a step; 3 steps wholly past

    def device_and_build():
        t0 = time.perf_counter()
        logs = pkg.csrc.build()
        return {"card": name_power, "sm_clock_max_mhz": sm_clock_mhz,
                "sms": sms, "torch": torch.__version__,
                "cuda": torch.version.cuda,
                "build_seconds": round(time.perf_counter() - t0, 3),
                "libraries": len(logs), "ptxas": ptxas_table(logs)}

    def kernels_vs_plain():
        checks = []
        tile_cases = [
            ("genesis_word7", genesis76, diff1, GENESIS_NONCE - (1 << 23),
             DISPATCH, True),
            ("genesis_exact", genesis76, diff1, GENESIS_NONCE - (1 << 23),
             DISPATCH, False),
            ("easy_cut_top_exact", header, easy, top_base, cut, False),
            ("easy_cut_top_word7", header, easy, top_base, cut, True),
        ]
        for label, h, t, base, limit, word7 in tile_cases:
            job = s.job(h, t, base, limit)
            kw = dict(n_steps=DISPATCH // 8192, block=8192, word7=word7)
            got = pkg.scan_tile(job, **kw)
            want = pkg.scan_tile_plain(job, **kw)
            torch.cuda.synchronize()
            s.compare("scan_tile", got, want)
            checks.append({"kernel": "scan_tile", "case": label,
                           "steps_with_hits": int((want[0] > 0).sum()),
                           "hits": int(want[0].sum())})
            if label == "genesis_word7":
                step = (GENESIS_NONCE - base) // 8192
                assert int(got[1][step]) == GENESIS_NONCE, "genesis missing"
        hitbuf_cases = [
            ("genesis_word7", genesis76, diff1, GENESIS_NONCE - (1 << 23),
             DISPATCH, True, DISPATCH, 1 << 18),
            ("easy_overflow_cut_top", header, easy, top_base, cut, False,
             DISPATCH, 1 << 18),
            ("easy_overflow_word7", header, easy, 12345, DISPATCH, True,
             DISPATCH, 1 << 18),
            ("rescan_genesis_tile", genesis76, diff1,
             GENESIS_NONCE - 4000, 8192, False, 8192, 1024),
        ]
        for label, h, t, base, limit, word7, cap, inner in hitbuf_cases:
            parts = s.hitbuf_parts(s.job(h, t, base, limit))
            kw = dict(inner_size=inner, n_steps=cap // inner, max_hits=64,
                      word7=word7)
            got = pkg.scan_batch(*parts, **kw)
            want = pkg.scan_batch_plain(*parts, **kw)
            torch.cuda.synchronize()
            s.compare("scan_hitbuf", got, want)
            s.compare("hitbuf_compact", got, want)
            count = int(want[1])
            if label.startswith("easy_overflow"):
                assert count > 64, f"{label}: no overflow ({count} hits)"
            if "genesis" in label:
                assert GENESIS_NONCE in got[0].cpu().tolist(), label
            checks.append({"kernel": "scan_hitbuf", "case": label,
                           "count": count})
        # K version-rolled chains: slot step*K + c of the tile scan, and
        # per-chain hit buffers with an overflow in every chain.
        for k in (2, 3, 4, 8):
            for label, h, t, base, limit, word7 in tile_cases:
                job = s.job(h, t, base, limit, k)
                kw = dict(n_steps=DISPATCH // 8192, block=8192, word7=word7,
                          vshare=k)
                got = pkg.scan_tile(job, **kw)
                want = pkg.scan_tile_plain(job, **kw)
                torch.cuda.synchronize()
                s.compare(f"scan_tile_k{k}", got, want)
                per_chain = want[0].view(-1, k)
                checks.append({"kernel": f"scan_tile_k{k}", "case": label,
                               "hits_per_chain": per_chain.sum(0).tolist()})
                if label == "genesis_word7":
                    step = (GENESIS_NONCE - base) // 8192
                    assert int(got[1][step * k]) == GENESIS_NONCE, label
        for k in (2, 4):
            for label, h, t, base, limit, word7, cap, inner in hitbuf_cases[:3]:
                parts = s.hitbuf_parts(s.job(h, t, base, limit, k), k)
                kw = dict(inner_size=inner, n_steps=cap // inner, max_hits=64,
                          word7=word7)
                got = pkg.scan_batch_vshare(*parts, **kw)
                want = pkg.scan_batch_vshare_plain(*parts, **kw)
                torch.cuda.synchronize()
                s.compare(f"scan_hitbuf_k{k}", got, want)
                s.compare(f"hitbuf_compact_k{k}", got, want)
                counts = want[1].tolist()
                if label.startswith("easy_overflow"):
                    assert min(counts) > 64, f"{label}: no overflow {counts}"
                if "genesis" in label:
                    assert GENESIS_NONCE in got[0][0].cpu().tolist(), label
                checks.append({"kernel": f"scan_hitbuf_k{k}", "case": label,
                               "counts": counts})
        return {"checks": checks, "tolerance": "exact (integers)"}

    def genesis_sweep():
        args = pkg.cli.build_parser().parse_args(
            ["--bench", "--bench-nonces", str(1 << 32)])
        s.reset_counts()
        out = pkg.cli.bench(args)
        counts = s.read_counts()
        assert out["verified"], f"genesis nonce not found: {out['nonces']}"
        assert out["hashes"] == 1 << 32 and out["nonce_start"] == 0
        for name, n in counts.items():
            if name in ("scan_tile", "scan_hitbuf", "hitbuf_compact"):
                assert n > 0, f"{name} never launched in the genesis sweep"
            else:
                assert n == 0, f"{name} launched in the one-chain sweep"
        assert counts["scan_tile"] == (1 << 32) // DISPATCH, counts
        return {"mhs": out["mhs"], "requests": out["dispatches"],
                "sweep_seconds": out["seconds"], "hits": out["nonces"],
                "mhs_vs_pr2": out["mhs"] / SWEEP_MHS_PR2,
                "launches": launched(counts)}

    def genesis_sweep_vshare():
        args = pkg.cli.build_parser().parse_args(
            ["--bench", "--vshare", "2", "--bench-nonces", str(1 << 32)])
        s.reset_counts()
        out = pkg.cli.bench(args)
        counts = s.read_counts()
        assert out["verified"], f"genesis nonce not found: {out['nonces']}"
        assert out["hashes"] == 1 << 33 and out["nonce_start"] == 0, out
        assert counts["scan_tile_k2"] == (1 << 32) // DISPATCH, counts
        assert not any(n for name, n in counts.items() if name.startswith(
            ("scan_tile", "scan_hitbuf_k", "hitbuf_compact_k"))
            and name != "scan_tile_k2"), counts
        siblings = []
        for version, nonce in out["version_hits"]:
            header80 = (version.to_bytes(4, "little") + genesis76[4:]
                        + nonce.to_bytes(4, "little"))
            ok = int.from_bytes(pkg.sha256d(header80), "little") <= diff1
            assert ok and version & ~VERSION_MASK == genesis_version & ~VERSION_MASK
            siblings.append({"version": f"{version:#010x}",
                             "nonce": nonce, "verified": ok})
        return {"mhs": out["mhs"], "hashes": out["hashes"],
                "requests": out["dispatches"],
                "sweep_seconds": out["seconds"], "hits": out["nonces"],
                "sibling_hits": siblings, "launches": launched(counts)}

    def cuda_backend_window_vshare():
        args = pkg.cli.build_parser().parse_args(
            ["--bench", "--backend", "cuda", "--vshare", "2", "--batch-bits",
             "24", "--bench-nonces", str(1 << 26)])
        s.reset_counts()
        out = pkg.cli.bench(args)
        counts = s.read_counts()
        assert out["verified"] and out["hashes"] == 1 << 27, out
        assert counts["scan_hitbuf_k2"] == 4, counts
        assert counts["hitbuf_compact_k2"] == 4, counts
        return {"backend": "cuda", "vshare": 2, "mhs": out["mhs"],
                "dispatches": out["dispatches"], "hits": out["nonces"],
                "sibling_hits": out["version_hits"],
                "launches": launched(counts)}

    def cuda_backend_window():
        hasher = pkg.CudaHasher(device="cuda")
        out = pkg.cli.run_bench(hasher, 1 << 26, batch_size=DISPATCH)
        assert out["verified"], out["nonces"]
        return {"backend": "cuda", "mhs": out["mhs"],
                "dispatches": out["dispatches"], "hits": out["nonces"]}

    def stratum_session():
        s.reset_counts()
        result = asyncio.run(asyncio.wait_for(stratum(pkg), 300))
        counts = s.read_counts()
        assert counts["scan_tile"] > 0, "scan_tile never launched"
        assert not any(n for name, n in counts.items() if "_k" in name), (
            f"a K>1 kernel launched in the one-chain session: {counts}")
        return {**result, "launches": launched(counts)}

    def stratum_session_vshare():
        s.reset_counts()
        result = asyncio.run(asyncio.wait_for(
            stratum(pkg, vshare=2, pool_mask=VERSION_MASK), 300))
        counts = s.read_counts()
        assert counts["scan_tile_k2"] > 0, "scan_tile_k2 never launched"
        assert counts["scan_tile"] == 0, counts
        assert result["sibling_accepted"] >= 3, result
        assert result["chain0_accepted"] >= 3, result
        return {**result, "launches": launched(counts)}

    def stratum_session_degraded():
        s.reset_counts()
        result = asyncio.run(asyncio.wait_for(
            stratum(pkg, vshare=2, pool_mask=0, window_s=1.0), 300))
        counts = s.read_counts()
        assert counts["scan_tile"] > 0, counts
        assert not any(n for name, n in counts.items() if "_k" in name), (
            f"a K>1 kernel launched in degraded mode: {counts}")
        assert result["sibling_accepted"] == 0, result
        return {**result, "launches": launched(counts)}

    def timings():
        rows = {}
        g_job = s.job(genesis76, diff1, GENESIS_NONCE - (1 << 23), DISPATCH)
        tile_kw = dict(n_steps=DISPATCH // 8192, block=8192)
        rows["scan_tile"] = {
            "ms": s.time_ms(lambda: pkg.scan_tile(g_job, word7=True,
                                                  **tile_kw), 20),
            "ms_exact": s.time_ms(lambda: pkg.scan_tile(g_job, **tile_kw), 20),
            "plain_ms": s.plain_ms(lambda: pkg.scan_tile_plain(
                g_job, word7=True, **tile_kw)),
            "bound_ms": bound(DISPATCH, True),
            "bound_ms_exact": bound(DISPATCH, False),
            "nonces": DISPATCH, "mode": "word7 (genesis sweep)",
        }
        tile_parts = s.hitbuf_parts(s.job(genesis76, diff1,
                                          GENESIS_NONCE - 4000, 8192))
        small = dict(inner_size=1024, n_steps=8, max_hits=64)
        big_parts = s.hitbuf_parts(g_job)
        big = dict(inner_size=1 << 18, n_steps=64, max_hits=64)
        rows["scan_hitbuf"] = {
            "ms": s.time_ms(lambda: pkg.scan_batch(*tile_parts, **small), 200),
            "plain_ms": s.plain_ms(lambda: pkg.scan_batch_plain(*tile_parts,
                                                                **small)),
            "bound_ms": bound(8192, False),
            "nonces": 8192, "mode": "exact, one 8192-nonce step (rescan)",
            "ms_2p24_word7": s.time_ms(
                lambda: pkg.scan_batch(*big_parts, word7=True, **big), 20),
            "plain_ms_2p24_word7": s.plain_ms(
                lambda: pkg.scan_batch_plain(*big_parts, word7=True, **big)),
            "bound_ms_2p24_word7": bound(DISPATCH, True),
        }
        # The compaction alone, on the rescan's 32 block slots.
        iters, n_blocks = pkg.hitbuf_geometry(8192)
        blk_counts = torch.zeros(n_blocks, dtype=torch.int32, device=s.dev)
        blk_counts[n_blocks // 2] = 1
        blk_hits = torch.full((n_blocks * 64,), GENESIS_NONCE,
                              dtype=torch.int64).to(torch.uint32).to(s.dev)

        def compact():
            return pkg.hitbuf_compact(blk_hits, blk_counts, 64)

        def compact_plain():
            return pkg.hitbuf_compact_plain(blk_hits, blk_counts, 64)

        s.compare("hitbuf_compact", compact(), compact_plain())
        rows["hitbuf_compact"] = {
            "ms": s.time_ms(compact, 200),
            "plain_ms": s.plain_ms(compact_plain),
            # n_blocks counts read, one stored hit read, 64 slots and the
            # count written.
            "bound_ms": (n_blocks * 4 + 4 + 64 * 4 + 4) / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "blocks": n_blocks,
        }
        # K chains: the tile scan of the --vshare main path (word7 in the
        # bench, exact in the Stratum session) at K = 2 and 4, hashes per
        # second counting K hashes per nonce; K = 3 and 8 timed alone.
        for k in (2, 4):
            job_k = s.job(genesis76, diff1, GENESIS_NONCE - (1 << 23),
                          DISPATCH, k)
            kw = dict(vshare=k, **tile_kw)
            ms = s.time_ms(lambda: pkg.scan_tile(job_k, word7=True, **kw), 20)
            ms_exact = s.time_ms(lambda: pkg.scan_tile(job_k, **kw), 20)
            rows[f"scan_tile_k{k}"] = {
                "ms": ms, "ms_exact": ms_exact,
                "plain_ms": s.plain_ms(lambda: pkg.scan_tile_plain(
                    job_k, word7=True, **kw)),
                "bound_ms": bound(DISPATCH, True, k),
                "bound_ms_exact": bound(DISPATCH, False, k),
                "hashes_per_s": DISPATCH * k / ms * 1e3,
                "hashes_per_s_exact": DISPATCH * k / ms_exact * 1e3,
                "nonces": DISPATCH, "mode": "word7 (genesis sweep)",
            }
        for k in (3, 8):
            job_k = s.job(genesis76, diff1, GENESIS_NONCE - (1 << 23),
                          DISPATCH, k)
            ms = s.time_ms(lambda: pkg.scan_tile(job_k, word7=True, vshare=k,
                                                 **tile_kw), 20)
            rows[f"scan_tile_k{k}_alone"] = {
                "ms": ms, "bound_ms": bound(DISPATCH, True, k),
                "hashes_per_s": DISPATCH * k / ms * 1e3}
        rows["scan_tile"]["hashes_per_s"] = DISPATCH / rows["scan_tile"]["ms"] * 1e3
        rows["scan_tile"]["hashes_per_s_exact"] = (
            DISPATCH / rows["scan_tile"]["ms_exact"] * 1e3)
        # The K=2 hit-buffer scan at the cuda backend's 2^24 dispatch.
        parts2 = s.hitbuf_parts(s.job(genesis76, diff1,
                                      GENESIS_NONCE - (1 << 23), DISPATCH, 2), 2)
        ms = s.time_ms(lambda: pkg.scan_batch_vshare(*parts2, word7=True,
                                                     **big), 20)
        rows["scan_hitbuf_k2"] = {
            "ms": ms,
            "plain_ms": s.plain_ms(lambda: pkg.scan_batch_vshare_plain(
                *parts2, word7=True, **big)),
            "bound_ms": bound(DISPATCH, True, 2),
            "hashes_per_s": DISPATCH * 2 / ms * 1e3,
            "nonces": DISPATCH, "mode": "word7, 2^24 (cuda backend)",
        }
        # Its compaction alone, on the 2 x 2048 block slots of that shape.
        iters2, n_blocks2 = pkg.hitbuf_geometry(DISPATCH)
        counts2 = torch.zeros((2, n_blocks2), dtype=torch.int32, device=s.dev)
        counts2[:, n_blocks2 // 2] = 1
        hits2 = torch.full((2 * n_blocks2 * 64,), GENESIS_NONCE,
                           dtype=torch.int64).to(torch.uint32).to(s.dev)

        def compact2():
            return pkg.hitbuf_compact(hits2, counts2, 64)

        def compact2_plain():
            return pkg.hitbuf_compact_plain(hits2, counts2, 64)

        s.compare("hitbuf_compact_k2", compact2(), compact2_plain())
        rows["hitbuf_compact_k2"] = {
            "ms": s.time_ms(compact2, 200),
            "plain_ms": s.plain_ms(compact2_plain),
            # per chain: n_blocks counts read, one stored hit read, 64
            # slots and the count written.
            "bound_ms": 2 * (n_blocks2 * 4 + 4 + 64 * 4 + 4)
            / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "blocks": n_blocks2, "chains": 2,
        }
        for row in rows.values():
            for k, v in list(row.items()):
                if isinstance(v, float):
                    row[k] = float(f"{v:.6g}")
        return {"card": name_power, "rows": rows}

    s.phase("device_and_build", device_and_build)
    if s.failed:
        return 1
    s.phase("kernels_vs_plain", kernels_vs_plain)
    s.phase("genesis_sweep", genesis_sweep)
    s.phase("stratum_session", stratum_session)
    s.phase("cuda_backend_window", cuda_backend_window)
    s.phase("genesis_sweep_vshare", genesis_sweep_vshare)
    s.phase("cuda_backend_window_vshare", cuda_backend_window_vshare)
    s.phase("stratum_session_vshare", stratum_session_vshare)
    s.phase("stratum_session_degraded", stratum_session_degraded)
    timing = {}

    def timing_phase():
        out = timings()
        timing.update(out["rows"])
        return out

    s.phase("timings", timing_phase)
    if s.failed:
        emit({"failed_phases": s.failed})
        return 1

    sources = {
        "scan_tile": ("bitcoin_miner_tpu_torch/ops/csrc/scan_tile.cu",
                      "bitcoin_miner_tpu/ops/sha256_pallas.py:115"),
        "scan_hitbuf": ("bitcoin_miner_tpu_torch/ops/csrc/scan_hitbuf.cu",
                        "bitcoin_miner_tpu/ops/sha256_jax.py:780"),
        "hitbuf_compact": ("bitcoin_miner_tpu_torch/ops/csrc/scan_hitbuf.cu",
                           "bitcoin_miner_tpu/ops/sha256_jax.py:826"),
        "scan_tile_k2": ("bitcoin_miner_tpu_torch/ops/csrc/scan_tile.cu",
                         "bitcoin_miner_tpu/ops/sha256_pallas.py:115"),
        "scan_hitbuf_k2": ("bitcoin_miner_tpu_torch/ops/csrc/scan_hitbuf.cu",
                           "bitcoin_miner_tpu/ops/sha256_jax.py:857"),
        "hitbuf_compact_k2": ("bitcoin_miner_tpu_torch/ops/csrc/scan_hitbuf.cu",
                              "bitcoin_miner_tpu/ops/sha256_jax.py:896"),
    }
    unlaunched = [name for name in sources if not s.launches[name]]
    if unlaunched:
        emit({"failed_phases": [], "never_launched_on_main_path": unlaunched})
        return 1
    table = []
    for name, (source, replaces) in sources.items():
        row = timing[name]
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": s.launches[name],
            "max_abs_err": s.kernels[name]["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row.get("bound_by", "operations"),
            "library_ms": None,
            **{k: v for k, v in row.items()
               if k not in ("ms", "plain_ms", "bound_ms", "bound_by")},
        })
    emit({"kernels": table})
    print(name_power, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


async def stratum(pkg, vshare: int = 1, pool_mask: int = 0,
                  window_s: float = SESSION_WINDOW_S) -> dict:
    """A Stratum session as ``python -m bitcoin_miner_tpu_torch --pool URL
    --workers 4 [--vshare k]`` builds it (the tile kernel on the card
    behind its ring, the adaptive scheduler), against the package's
    validating mock pool, which grants the BIP 310 mask ``pool_mask``.
    Once 3 shares are accepted — with ``vshare`` > 1 and a mask, 3 of
    chain 0 and 3 of the sibling chains — it mines on for ``window_s``;
    the rate over that window counts the tile kernels' launches, each of
    the hasher's ``batch_size`` nonces × K chains, so the dispatches still
    in flight at either end (at most 4 workers × a ring of 2, ~20 ms of
    work) are the error, not whole finished requests of up to 2^30
    nonces."""
    pool = pkg.MockStratumPool(difficulty=1 / 256, version_mask=pool_mask)
    await pool.start()
    await pool.announce_job(pkg.PoolJob(
        job_id="smoke",
        prevhash_internal=pkg.sha256d(b"chip smoke prev"),
        coinb1=bytes.fromhex("01000000") + b"\x11" * 30,
        coinb2=b"\x22" * 30 + bytes.fromhex("00000000"),
        merkle_branch=[pkg.sha256d(b"tx1"), pkg.sha256d(b"tx2")],
        version=0x20000000, nbits=0x1D00FFFF, ntime=0x655F2B2C,
    ))
    args = pkg.cli.build_parser().parse_args(
        ["--pool", f"stratum+tcp://127.0.0.1:{pool.port}", "--user", "smoke",
         "--workers", "4", "--vshare", str(vshare)])
    miner = pkg.cli.make_miner(args)
    dispatcher = miner.dispatcher
    hasher = dispatcher.hasher
    assert isinstance(hasher, pkg.TileCudaHasher), hasher
    assert hasher.device.type == "cuda" and dispatcher.scheduler is not None
    stats = dispatcher.stats
    task = asyncio.create_task(miner.run())

    async def until(done, what: str, seconds: float) -> None:
        deadline = time.perf_counter() + seconds
        while not done():
            if task.done():
                raise RuntimeError(f"miner stopped: {task!r}")
            if time.perf_counter() > deadline:
                raise TimeoutError(f"{what}: {stats.summary()}")
            await asyncio.sleep(0.05)

    def mark() -> tuple:
        hashes = sum(c.value * k for k, c in pkg.scan_tile_k.items())
        return (time.perf_counter(), hashes * hasher.batch_size,
                stats.hashes, stats.shares_accepted,
                sum(c.value for c in pkg.scan_tile_k.values()))

    own_bits = 0x20000000 & pool_mask if pool_mask else None

    def accepted(sibling: bool) -> int:
        return sum(1 for sh in pool.shares
                   if sh.accepted and (sh.version_bits != own_bits) == sibling)

    def enough() -> bool:
        if vshare > 1 and pool_mask:
            return accepted(True) >= 3 and accepted(False) >= 3
        return stats.shares_accepted >= 3

    t0 = time.perf_counter()
    try:
        await until(enough, "3 accepted shares per chain kind", 240)
        a = mark()
        await until(lambda: time.perf_counter() - a[0] >= window_s,
                    "window", window_s + 60)
        b = mark()
    finally:
        miner.stop()
        await asyncio.gather(task, return_exceptions=True)
        await pool.stop()
    rejected = [s.reason for s in pool.shares if not s.accepted]
    assert not rejected and stats.shares_rejected == 0, rejected
    assert stats.hw_errors == 0, stats.summary()
    assert all(sh.version_bits is None or sh.version_bits & ~pool_mask == 0
               for sh in pool.shares), "version bits outside the mask"
    window = b[0] - a[0]
    return {"accepted": stats.shares_accepted,
            "pool_validated": sum(s.accepted for s in pool.shares),
            "sibling_accepted": accepted(True),
            "chain0_accepted": accepted(False),
            "sibling_version_bits": sorted({
                f"{sh.version_bits:#010x}" for sh in pool.shares
                if sh.version_bits != own_bits}),
            "vshare": vshare, "pool_mask": f"{pool_mask:#010x}",
            "rejected": stats.shares_rejected, "hw_errors": stats.hw_errors,
            "workers": dispatcher.n_workers,
            "stream_depth": dispatcher.stream_depth,
            "warmup_seconds": a[0] - t0, "window_seconds": window,
            "window_launches": b[4] - a[4],
            "mhs": (b[1] - a[1]) / window / 1e6,
            "mhs_finished_requests": (b[2] - a[2]) / window / 1e6,
            "window_shares_per_s": (b[3] - a[3]) / window}


class _Package:
    """The names the smoke test drives, from the package beside it."""

    def __init__(self) -> None:
        from bitcoin_miner_tpu_torch.backends.cuda import (
            CudaHasher,
            TileCudaHasher,
            sibling_version_patterns,
        )
        from bitcoin_miner_tpu_torch import cli
        from bitcoin_miner_tpu_torch.core.header import GENESIS_HEADER_HEX
        from bitcoin_miner_tpu_torch.core.sha256 import sha256d
        from bitcoin_miner_tpu_torch.core.target import (
            difficulty_to_target,
            nbits_to_target,
        )
        from bitcoin_miner_tpu_torch.ops import csrc, sha256_tile, sha256_torch
        from bitcoin_miner_tpu_torch.testing.mock_pool import (
            MockStratumPool,
            PoolJob,
        )

        self.CudaHasher, self.TileCudaHasher = CudaHasher, TileCudaHasher
        self.cli = cli
        self.GENESIS_HEADER_HEX = GENESIS_HEADER_HEX
        self.sha256d = sha256d
        self.difficulty_to_target = difficulty_to_target
        self.nbits_to_target = nbits_to_target
        self.MockStratumPool, self.PoolJob = MockStratumPool, PoolJob
        self.csrc = csrc
        self.sibling_version_patterns = sibling_version_patterns
        self.job_block_from_header = sha256_tile.job_block_from_header
        self.scan_tile = sha256_tile.scan_tile
        self.scan_tile_plain = sha256_tile.scan_tile_plain
        self.scan_batch = sha256_torch.scan_batch
        self.scan_batch_plain = sha256_torch.scan_batch_plain
        self.scan_batch_vshare = sha256_torch.scan_batch_vshare
        self.scan_batch_vshare_plain = sha256_torch.scan_batch_vshare_plain
        self.hitbuf_compact = sha256_torch.hitbuf_compact
        self.hitbuf_compact_plain = sha256_torch.hitbuf_compact_plain
        self.hitbuf_geometry = sha256_torch.hitbuf_geometry
        self.bound_ms = sha256_torch.bound_ms
        self.scan_tile_k = sha256_tile.SCAN_TILE_K
        self.counters = tuple(
            c for counters in (sha256_tile.SCAN_TILE_K,
                               sha256_torch.SCAN_HITBUF_K,
                               sha256_torch.HITBUF_COMPACT_K)
            for c in counters.values())


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to smoke-test",
              file=sys.stderr)
        return 2
    try:
        pkg = _Package()
    except ImportError as e:
        print(f"chip_smoke: run it from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    return run(torch, pkg)


if __name__ == "__main__":
    sys.exit(main())
