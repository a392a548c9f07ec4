#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA miner on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit and builds the kernels from
   ``bitcoin_miner_tpu_torch/ops/csrc`` (one nvcc per source, all at once),
   printing ptxas' register and spill lines;
2. holds every kernel against its plain PyTorch version on the card at the
   main path's shapes (2^24-nonce dispatches, the genesis job, a limit
   that cuts a step, a base near 2^32, a hit-buffer overflow) — exact
   equality, since every output is an integer;
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
5. times each kernel with CUDA events beside its plain version and its
   bound.

Phases 3 and 4 are the main path: the launch counts are set to 0 just
before each and read just after, and each kernel must have launched.
Every phase prints a JSON line; the kernel table and the card follow, and
the last line is ``{"ok": true, "device": {...}}``. Without a card, without
the package beside it, or when any phase fails, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import asyncio
import json
import subprocess
import sys
import time
import traceback

GENESIS_NONCE = 2083236893
DISPATCH = 1 << 24
SESSION_WINDOW_S = 5.0  # the Stratum session's measured window
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


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

    def job(self, header76, target, base, limit):
        return self.pkg.job_block_from_header(header76, target, base,
                                              limit).to(self.dev)

    @staticmethod
    def hitbuf_parts(job):
        return job[0:8], job[16:19], job[19:27], job[27], job[28]

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

    def bound(nonces, word7):
        return pkg.bound_ms(nonces, word7, sms, sm_clock_mhz * 1e6)
    genesis76 = bytes.fromhex(pkg.GENESIS_HEADER_HEX)[:76]
    diff1 = pkg.nbits_to_target(0x1D00FFFF)
    easy = pkg.difficulty_to_target(1 / (1 << 20))  # ~2^-12 per nonce
    header = bytes(range(76))
    top_base = (1 << 32) - DISPATCH + 777  # the range wraps past 2^32
    cut = DISPATCH - 3 * 8192 - 1234  # cuts a step; 3 steps wholly past

    def device_and_build():
        t0 = time.perf_counter()
        logs = pkg.csrc.build()
        ptxas = [line.strip() for log in logs.values()
                 for line in log.splitlines()
                 if "registers" in line or "spill" in line
                 or "Compiling entry" in line]
        return {"card": name_power, "sm_clock_max_mhz": sm_clock_mhz,
                "sms": sms, "torch": torch.__version__,
                "cuda": torch.version.cuda,
                "build_seconds": round(time.perf_counter() - t0, 3),
                "ptxas": ptxas}

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
            assert n > 0, f"{name} never launched in the genesis sweep"
        assert counts["scan_tile"] == (1 << 32) // DISPATCH, counts
        return {"mhs": out["mhs"], "requests": out["dispatches"],
                "sweep_seconds": out["seconds"], "hits": out["nonces"],
                "launches": counts}

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
        return {**result, "launches": counts}

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
    }
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


async def stratum(pkg) -> dict:
    """A Stratum session as ``python -m bitcoin_miner_tpu_torch --pool URL
    --workers 4`` builds it (the tile kernel on the card behind its ring,
    the adaptive scheduler), against the package's validating mock pool.
    After 3 accepted shares it mines on for ``SESSION_WINDOW_S``; the rate
    over that window counts the tile kernel's launches, each of the
    hasher's ``batch_size`` nonces, so the dispatches still in flight at
    either end (at most 4 workers × a ring of 2, ~20 ms of work) are the
    error, not whole finished requests of up to 2^30 nonces."""
    pool = pkg.MockStratumPool(difficulty=1 / 256)
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
         "--workers", "4"])
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
        return (time.perf_counter(), pkg.scan_tile_launches.value,
                stats.hashes, stats.shares_accepted)

    t0 = time.perf_counter()
    try:
        await until(lambda: stats.shares_accepted >= 3, "3 accepted shares",
                    240)
        a = mark()
        await until(lambda: time.perf_counter() - a[0] >= SESSION_WINDOW_S,
                    "window", SESSION_WINDOW_S + 60)
        b = mark()
    finally:
        miner.stop()
        await asyncio.gather(task, return_exceptions=True)
        await pool.stop()
    rejected = [s.reason for s in pool.shares if not s.accepted]
    assert not rejected and stats.shares_rejected == 0, rejected
    assert stats.hw_errors == 0, stats.summary()
    window = b[0] - a[0]
    return {"accepted": stats.shares_accepted,
            "pool_validated": sum(s.accepted for s in pool.shares),
            "rejected": stats.shares_rejected, "hw_errors": stats.hw_errors,
            "workers": dispatcher.n_workers,
            "stream_depth": dispatcher.stream_depth,
            "warmup_seconds": a[0] - t0, "window_seconds": window,
            "window_launches": b[1] - a[1],
            "mhs": (b[1] - a[1]) * hasher.batch_size / window / 1e6,
            "mhs_finished_requests": (b[2] - a[2]) / window / 1e6,
            "window_shares_per_s": (b[3] - a[3]) / window}


class _Package:
    """The names the smoke test drives, from the package beside it."""

    def __init__(self) -> None:
        from bitcoin_miner_tpu_torch.backends.cuda import (
            CudaHasher,
            TileCudaHasher,
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
        self.job_block_from_header = sha256_tile.job_block_from_header
        self.scan_tile = sha256_tile.scan_tile
        self.scan_tile_plain = sha256_tile.scan_tile_plain
        self.scan_batch = sha256_torch.scan_batch
        self.scan_batch_plain = sha256_torch.scan_batch_plain
        self.hitbuf_compact = sha256_torch.hitbuf_compact
        self.hitbuf_compact_plain = sha256_torch.hitbuf_compact_plain
        self.hitbuf_geometry = sha256_torch.hitbuf_geometry
        self.bound_ms = sha256_torch.bound_ms
        self.scan_tile_launches = sha256_tile.SCAN_TILE
        self.counters = (sha256_tile.SCAN_TILE, sha256_torch.SCAN_HITBUF,
                         sha256_torch.HITBUF_COMPACT)


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
