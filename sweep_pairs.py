#!/usr/bin/env python3
"""Genesis sweeps of one checkout, repeated in one process, for comparing
two commits on one card.

``python3 sweep_pairs.py ROOT [VARIANT ...]`` imports the package of the
checkout at ``ROOT``, builds its one-chain kernels (and the one-chain
library of each ``VARIANT``, a layout of the tile kernel), then sweeps the
genesis header's whole 2^32 nonce space through ``cli.bench`` three
times (the first includes the process's warm-up), and after each
baseline sweep one sweep per ``--variant`` named. It prints one JSON line
of MH/s per layout.

``python3 sweep_pairs.py ROOT --easy`` instead times ``TileCudaHasher.
scan`` over 2^26 nonces at targets where most 8192-nonce steps hold
several hits (difficulty 2^-20, about 2^-12 per nonce, and regtest's
nbits 0x207fffff), three scans each after a warm-up one, as
``chip_smoke.py``'s ``easy_target_scan`` phase does: one JSON line of MH/s
and hits per target.

``python3 sweep_pairs.py ROOT --fused`` times, with the card's CUDA events
as ``chip_smoke.py`` does, the 2^24-nonce scans with and without the
sharded scans' per-shard minimum (``scan_tile`` at K = 1, 2; the
hit-buffer scan at K = 1, 2, 4, and at 2^32 nonces with a limit of 0), as
the checkout computes it: ``shard_min`` after the scan where the checkout
has it, else the scan's own ``lowest``; the host's enqueue time of each
dispatch of a 4-shard ``cuda-tile-mesh`` genesis sweep on one card
(``ShardedScan.__call__``); and the rates of the genesis sweeps (K = 1, 2,
on one card and on that mesh), the ``cuda`` backend, ``easy_target_scan``
and a Stratum session. One JSON line.

``python3 sweep_pairs.py ROOT --ptxas`` builds every library that the
checkout's ``chip_smoke.py`` builds and prints ptxas' registers, spills
and shared memory per kernel (read by the checkout's
``probes/ptxas.py``, or by its smoke's own parser where it has no such
module), and the SASS per pipe of each scan library's nonce loop (the
hit-buffer and the tile kernels, per library, kernel and mode). One JSON
line.

``python3 sweep_pairs.py ROOT --layouts K:VARIANT[:CGROUP[:INTERLEAVE]]
...`` builds those layouts' tile libraries of the checkout (and its
one-chain ``scan_tile``, whose queued scans keep the card busy) and times
each as ``chip_smoke.py``'s ``timings`` phase does: the mean of 20
2^24-nonce launches of the genesis job, word7 and exact, with CUDA events
behind queued 2^24 scans. One JSON line: per library the two times, the
operation bound at its K (``bound_ms``) and the share of it, ptxas'
registers and spills, and the launch shape ``scan_tile_occupancy``
reports (threads, dynamic shared bytes, blocks and warps per SM).

``python3 sweep_pairs.py ROOT --telemetry N`` (a checkout with the
telemetry package) sweeps the genesis nonces through ``cli.bench`` with
telemetry off (A, ``TPU_MINER_TELEMETRY=0``), metrics on (B, the
default) and tracing (C, ``--trace-out``), in N rounds whose leg order
rotates (A B C, B C A, C A B, ...) after one warm-up sweep. One JSON
line: every rate, and per leg the median and quartiles.

To compare a commit with its parent, unpack the parent beside the
checkout and run parent, change, change, parent in one call.
"""

import asyncio
import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import time


def easy_scans(root: str) -> dict:
    """MH/s of three 2^26-nonce tile-hasher scans per target, after a
    warm-up scan."""
    from bitcoin_miner_tpu_torch.backends.cuda import TileCudaHasher
    from bitcoin_miner_tpu_torch.core.target import (
        difficulty_to_target,
        nbits_to_target,
    )

    header = bytes(range(76))
    n = 1 << 26
    hasher = TileCudaHasher(device="cuda")
    out = {"root": root, "nonces": n}
    for label, target in (("easy", difficulty_to_target(1 / (1 << 20))),
                          ("regtest", nbits_to_target(0x207FFFFF))):
        hasher.scan(header, 0, n, target)
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            result = hasher.scan(header, 1000, n, target)
            rates.append(round(n / (time.perf_counter() - t0) / 1e6, 1))
        out[label] = rates
        out[f"{label}_total_hits"] = result.total_hits
    return out


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def fused(root: str) -> dict:
    """Kernel times with and without the per-shard minimum, the host's
    enqueue time per 4-shard dispatch, and end-to-end rates."""
    import torch

    import chip_smoke  # the checkout's
    from bitcoin_miner_tpu_torch.ops import csrc

    pkg = chip_smoke._Package()
    csrc.build([*csrc.BASELINE])
    s = chip_smoke.Smoke(torch, pkg)
    dispatch = chip_smoke.DISPATCH
    genesis76 = bytes.fromhex(pkg.GENESIS_HEADER_HEX)[:76]
    diff1 = pkg.nbits_to_target(0x1D00FFFF)
    base = chip_smoke.GENESIS_NONCE - (1 << 23)
    # The parent's per-shard minimum is a launch of its own.
    shard_min = getattr(pkg, "shard_min", None)

    def with_min(scan, out_of, **kw):
        if shard_min is None:
            return lambda: scan(lowest=True, **kw)
        return lambda: shard_min(scan(**kw)[out_of])

    ms = {}

    def pair(name, plain, lowest):
        """Without, with, with, without the minimum, 20 launches each."""
        t = [s.time_ms(fn, 20) for fn in (plain, lowest, lowest, plain)]
        ms[name] = (t[0] + t[3]) / 2
        ms[name + "_lowest"] = (t[1] + t[2]) / 2

    for k in (1, 2):
        job = s.job(genesis76, diff1, base, dispatch, k)

        def tile(job=job, k=k, **kw):
            return pkg.scan_tile(job, n_steps=dispatch // 8192, block=8192,
                                 word7=True, vshare=k, **kw)

        pair(f"scan_tile_k{k}", tile, with_min(tile, 1))
    big = dict(inner_size=1 << 18, n_steps=dispatch >> 18, max_hits=64)
    for k in (1, 2, 4):
        parts = s.hitbuf_parts(s.job(genesis76, diff1, base, dispatch, k), k)
        scan = pkg.scan_batch if k == 1 else pkg.scan_batch_vshare

        def hitbuf(parts=parts, scan=scan, **kw):
            return scan(*parts, word7=True, **big, **kw)

        pair(f"scan_hitbuf_k{k}", hitbuf, with_min(hitbuf, 0))
    empty = s.hitbuf_parts(s.job(genesis76, diff1, 0, 0))
    ms["scan_hitbuf_2p32_limit_0"] = s.time_ms(lambda: pkg.scan_batch(
        *empty, inner_size=1 << 18, n_steps=1 << 14, max_hits=64), 20)

    # The host's enqueue time of each dispatch of a 4-shard sweep.
    enqueue = []
    call = pkg.mesh.ShardedScan.__call__

    def timed(self, words):
        t0 = time.perf_counter()
        out = call(self, words)
        enqueue.append(time.perf_counter() - t0)
        return out

    def sweep(hasher) -> float:
        out = pkg.cli.run_bench(hasher, 1 << 32,
                                scheduler=pkg.scheduler_for(hasher))
        if not out["verified"]:
            raise SystemExit(f"genesis nonce not found: {out}")
        return out["mhs"]

    mesh = [s.dev] * chip_smoke.SHARDS_ON_ONE_CARD
    mhs = {}
    for k in (1, 2):
        mhs[f"genesis_k{k}"] = sweep(pkg.TileCudaHasher(device="cuda",
                                                        vshare=k))
        pkg.mesh.ShardedScan.__call__ = timed
        try:
            hasher = pkg.ShardedTileCudaHasher(batch_per_device=dispatch,
                                               vshare=k, devices=mesh)
            sweep(hasher)  # warm-up
            enqueue.clear()
            mhs[f"mesh_k{k}"] = sweep(hasher)
        finally:
            pkg.mesh.ShardedScan.__call__ = call
        if k == 1:
            us = sorted(t * 1e6 for t in enqueue)
            enqueue_us = {"median": statistics.median(us), "min": us[0],
                          "p90": us[int(0.9 * len(us))],
                          "dispatches": len(us)}
    for k in (1, 2):
        mhs[f"cuda_k{k}"] = pkg.cli.run_bench(
            pkg.CudaHasher(device="cuda", vshare=k), 1 << 28,
            batch_size=dispatch)["mhs"]
    session = asyncio.run(asyncio.wait_for(chip_smoke.stratum(pkg), 300))
    return {"root": root, "card": card(), "ms": ms, "mhs": mhs,
            "enqueue_us": enqueue_us, "session_mhs": session["mhs"],
            "session_accepted": session["accepted"],
            "easy": easy_scans(root)}


#: The nonce-loop kernels whose SASS ``--ptxas`` reads per pipe.
SCAN_KERNELS = ("scan_hitbuf_kernel", "scan_tile_kernel",
                "scan_tile_param_kernel", "scan_tile_staged_kernel")


def ptxas(root: str) -> dict:
    """Registers, spills and shared memory of every library the checkout's
    smoke test builds, and its hit-buffer loops' SASS per pipe."""
    import chip_smoke  # the checkout's
    from bitcoin_miner_tpu_torch.ops import csrc, int_probe, sha256_tile
    from bitcoin_miner_tpu_torch.ops.sha256_torch import hitbuf_library
    from bitcoin_miner_tpu_torch.probes import sass

    names = [*csrc.BASELINE,
             *(sha256_tile.tile_library(*l)
               for l in chip_smoke.tile_layouts(sha256_tile)),
             *(sha256_tile.tile_library(k, unroll=u, spec=sp)
               for k in (1, 2) for u, sp in chip_smoke.FORMS),
             *(hitbuf_library(1, u, sp) for u, sp in chip_smoke.FORMS),
             int_probe.LIBRARY]
    t0 = time.perf_counter()
    logs = csrc.build(names)
    seconds = time.perf_counter() - t0
    try:  # the package's parser; an older checkout's smoke kept its own
        from bitcoin_miner_tpu_torch.probes.ptxas import ptxas_table
    except ImportError:
        ptxas_table = chip_smoke.ptxas_table
    scans = [n for n in names if n.startswith(("scan_hitbuf", "scan_tile"))]
    with concurrent.futures.ThreadPoolExecutor(16) as pool:
        listings = dict(zip(scans, pool.map(
            lambda n: sass.listing(csrc.library_path(n)), scans)))
    loops = {}
    for name in scans:
        for fn, insns in sass.functions(listings[name]).items():
            kernel = next((k for k in SCAN_KERNELS if k in fn), None)
            if kernel is not None:
                mode = "word7" if "Lb1E" in fn else "exact"
                loops[f"{name}/{kernel}/{mode}"] = sass.pipe_counts(
                    sass.loop_body(insns))
    return {"root": root, "card": card(), "libraries": len(names),
            "build_seconds": seconds,
            "ptxas": ptxas_table(logs),
            "hitbuf_loops": {k: v for k, v in loops.items()
                             if "scan_hitbuf_kernel" in k},
            "tile_loops": {k: v for k, v in loops.items()
                           if k.startswith("scan_tile")}}


#: A ``--layouts`` argument: K:VARIANT[:CGROUP[:INTERLEAVE]].
LAYOUT_FORM = "K:VARIANT[:CGROUP[:INTERLEAVE]]"
#: Nonces per launch and per step of the ``--layouts`` timings, and
#: launches per timing: the smoke's.
LAYOUT_NONCES, LAYOUT_BLOCK, LAYOUT_REPS = 1 << 24, 8192, 20


def parse_layouts(specs: list) -> list:
    """(K, variant, cgroup, interleave) of each :data:`LAYOUT_FORM`
    argument: cgroup 0 (the variant's default) and interleave 1 unless
    given. Raises ValueError on a malformed or missing one; the layout
    itself is checked by the checkout's ``sha256_tile.check_layout``."""
    if not specs:
        raise ValueError(f"--layouts needs at least one {LAYOUT_FORM}")
    out = []
    for spec in specs:
        parts = spec.split(":")
        try:
            if not 2 <= len(parts) <= 4 or not parts[1]:
                raise ValueError
            k = int(parts[0])
            cgroup = int(parts[2]) if len(parts) > 2 else 0
            interleave = int(parts[3]) if len(parts) > 3 else 1
        except ValueError:
            raise ValueError(f"bad layout {spec!r}: want {LAYOUT_FORM}, "
                             "e.g. 8:regchain or 2:vroll-db:0:2") from None
        out.append((k, parts[1], cgroup, interleave))
    return out


def layout_row(layout: tuple, ms: float, ms_exact: float, bound_ms: float,
               ptxas: dict, occupancy: dict) -> dict:
    """One library's entry of the ``--layouts`` line: its times, its
    operation bound and the share of it, ptxas' registers and spills per
    mode (``ptxas``: mode → its row) and its launch shape (``occupancy``:
    ``chip_smoke.tile_occupancy``)."""
    k, variant, cgroup, interleave = layout
    row = {"vshare": k, "variant": variant, "cgroup": cgroup,
           "interleave": interleave, "ms": ms, "ms_exact": ms_exact,
           "bound_ms": bound_ms, "of_bound": bound_ms / ms}
    for mode in ("word7", "exact"):
        row[f"registers_{mode}"] = ptxas.get(mode, {}).get("registers")
        row[f"spill_bytes_{mode}"] = ptxas.get(mode, {}).get("spill_stores")
        row[f"blocks_per_sm_{mode}"] = occupancy[mode]["blocks_per_sm"]
    row["threads"] = occupancy["word7"]["threads"]
    row["dynamic_smem"] = occupancy["word7"]["dynamic_smem"]
    row["warps_per_sm"] = row["blocks_per_sm_word7"] * row["threads"] // 32
    return row


def layouts(root: str, specs: list) -> dict:
    """The ``--layouts`` line of the checkout at ``root`` (see the module's
    docstring)."""
    import torch

    import chip_smoke  # the checkout's
    from bitcoin_miner_tpu_torch.ops import csrc, sha256_tile

    for k, variant, cgroup, interleave in specs:
        sha256_tile.check_layout(k, variant, cgroup, interleave,
                                 LAYOUT_BLOCK // sha256_tile.LANES)
    names = [sha256_tile.tile_library(*l) for l in specs]
    logs = csrc.build(["scan_tile", *names])
    pkg = chip_smoke._Package()
    rows_of = {(r["library"], r["mode"]): r
               for r in pkg.ptxas.ptxas_table(logs)}
    s = chip_smoke.Smoke(torch, pkg)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    hz = float(chip_smoke.nvidia_smi("clocks.max.sm", units=False)) * 1e6
    genesis76 = bytes.fromhex(pkg.GENESIS_HEADER_HEX)[:76]
    diff1 = pkg.nbits_to_target(0x1D00FFFF)
    base = chip_smoke.GENESIS_NONCE - LAYOUT_NONCES // 2
    out = {}
    for layout, name in zip(specs, names):
        k, variant, cgroup, interleave = layout
        job = s.job(genesis76, diff1, base, LAYOUT_NONCES, k)
        host = s.job(genesis76, diff1, base, LAYOUT_NONCES, k, host=True)
        kw = dict(n_steps=LAYOUT_NONCES // LAYOUT_BLOCK, block=LAYOUT_BLOCK,
                  vshare=k, variant=variant, cgroup=cgroup,
                  interleave=interleave, host_words=host)
        ms = s.time_ms(lambda: pkg.scan_tile(job, word7=True, **kw),
                       LAYOUT_REPS)
        ms_exact = s.time_ms(lambda: pkg.scan_tile(job, **kw), LAYOUT_REPS)
        out[name] = layout_row(
            layout, ms, ms_exact,
            pkg.bound_ms(LAYOUT_NONCES, True, sms, hz, vshare=k),
            {mode: rows_of.get((name, mode), {})
             for mode in ("word7", "exact")},
            chip_smoke.tile_occupancy(csrc, name))
    return {"root": root, "card": card(), "nonces": LAYOUT_NONCES,
            "layouts": out}


def telemetry_legs(root: str, rounds: int) -> dict:
    """Genesis sweep rates with telemetry off, on and tracing, in
    rotating order; the trace and the flight recorder's dump path in a
    temporary directory."""
    import tempfile

    from bitcoin_miner_tpu_torch import cli
    from bitcoin_miner_tpu_torch.telemetry import pipeline

    out = tempfile.mkdtemp(prefix="sweep_pairs_")
    base = ["--bench", "--bench-nonces", str(1 << 32), "--flightrec-out",
            os.path.join(out, "flightrec.json")]
    legs = {"A": [], "B": [],
            "C": ["--trace-out", os.path.join(out, "trace.json")]}

    def sweep(leg: str) -> float:
        if leg == "A":
            os.environ["TPU_MINER_TELEMETRY"] = "0"
        else:
            os.environ.pop("TPU_MINER_TELEMETRY", None)
        pipeline.set_telemetry(None)
        result = cli.bench(cli.build_parser().parse_args(base + legs[leg]))
        pipeline.get_telemetry().flightrec.disarm()
        if not result["verified"]:
            raise SystemExit(f"genesis nonce not found: {result}")
        return round(result["mhs"], 1)

    rates: dict = {leg: [] for leg in legs}
    try:
        sweep("B")  # warm-up
        for r in range(rounds):
            for leg in "ABC"[r % 3:] + "ABC"[:r % 3]:
                rates[leg].append(sweep(leg))
    finally:
        os.environ.pop("TPU_MINER_TELEMETRY", None)
        pipeline.set_telemetry(None)
    median = {leg: statistics.median(v) for leg, v in rates.items()}
    return {"root": root, "card": card(), "rounds": rounds, "mhs": rates,
            "median": median,
            "quartiles": {leg: statistics.quantiles(v, n=4)
                          for leg, v in rates.items()},
            "b_over_a": median["B"] / median["A"],
            "c_over_a": median["C"] / median["A"]}


def main() -> int:
    specs = None
    if sys.argv[2:3] == ["--layouts"]:
        try:
            specs = parse_layouts(sys.argv[3:])
        except ValueError as e:
            print(f"sweep_pairs: {e}", file=sys.stderr)
            return 2
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    os.chdir(root)
    from bitcoin_miner_tpu_torch import cli
    from bitcoin_miner_tpu_torch.ops import csrc

    if specs is not None:
        print(json.dumps(layouts(sys.argv[1], specs)), flush=True)
        return 0
    if sys.argv[2:] == ["--easy"]:
        csrc.build(["scan_tile", "scan_hitbuf"])
        print(json.dumps(easy_scans(sys.argv[1])), flush=True)
        return 0
    if sys.argv[2:3] == ["--telemetry"]:
        csrc.build(["scan_tile", "scan_hitbuf"])
        print(json.dumps(telemetry_legs(sys.argv[1], int(sys.argv[3]))),
              flush=True)
        return 0
    if sys.argv[2:] in (["--fused"], ["--ptxas"]):
        run = fused if sys.argv[2] == "--fused" else ptxas
        print(json.dumps(run(sys.argv[1])), flush=True)
        return 0

    libraries = ["scan_tile", "scan_hitbuf"]
    if sys.argv[2:]:
        from bitcoin_miner_tpu_torch.ops.sha256_tile import tile_library
        libraries += [tile_library(1, v) for v in sys.argv[2:]]
    csrc.build(libraries)
    out = {"root": sys.argv[1], "baseline": []}
    for _ in range(3):
        for variant in (None, *sys.argv[2:]):
            argv = ["--bench", "--bench-nonces", str(1 << 32)]
            if variant:
                argv += ["--variant", variant]
            result = cli.bench(cli.build_parser().parse_args(argv))
            if not result["verified"]:
                raise SystemExit(f"genesis nonce not found: {result}")
            out.setdefault(variant or "baseline", []).append(
                round(result["mhs"], 1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
