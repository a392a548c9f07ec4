"""The BASELINE matrix runner: the five acceptance scenarios of
BASELINE.md on one hasher.

Counterpart of ``benchmarks/run.py``, run as ``python -m
bitcoin_miner_tpu_torch.probes.run``. The hasher is the command line's
(``cli.make_hasher`` over ``cli.build_parser``'s namespace, so it is
built exactly as a mining session builds it): the tile kernel
(``cuda-tile``) on the card by default, ``--backend cuda --inner-bits 14``
for the reference's geometry on the hit-buffer kernel, and the plain
PyTorch versions on the CPU with ``--device cpu``. Without ``--device
cpu`` and without a card the run exits 2 before it builds anything:
there is no CPU fallback. The configurations, with the reference's names,
sizes and ``pass`` conditions:

1. ``hasher.sha256d`` of the genesis header against its known digest.
2. One ``scan`` of 2^20 nonces centred on the genesis nonce at the
   difficulty-1 target (2^17 with ``--quick``): exactly that nonce.
3. One ``scan`` of 2^18 nonces (2^14 with ``--quick``) from nonce 10000
   at difficulty 2^-24: its ``nonces`` and ``total_hits`` equal the
   oracle's over the whole range. The oracle is the package's native
   library (``backends/native.py``), or hashlib (``cpu``) when the
   hasher under test is ``native``. A native library that fails to build
   fails this configuration with the build's message (the reference
   falls back to hashlib). At the default 2^20-nonce grid both scans
   are partial dispatches, so they also hold the kernels' ``limit``: no
   hit past a request's count.
4. ``GbtMiner`` with 8 workers on the package's ``FakeNode`` at regtest
   with a witness commitment: at least one block accepted, no hardware
   error.
5. ``StratumMiner`` with 4 workers on the package's ``MockStratumPool``
   (difficulty 2^-24, extranonce2 of 4 bytes, version mask 0x1FFFE000):
   3 accepted shares, none rejected, version bits on every submit.

Configurations 4 and 5 ask for 2^10-nonce requests, as the reference
does; a request below the hasher's grid (``dispatch_granularity``)
still launches the whole grid, so on the card each request costs one
launch. ``mhs`` in configurations 2 and 3 is the rate of one scan of
2^20 or 2^18 nonces: launch latency and the host's hit collection
dominate it, so it is not the card's hash rate.

Output: one JSON line per configuration, then the Markdown table; rc 0
when every configuration passes, 1 otherwise, 2 on a refused option (an
unknown configuration, an option the backend does not take, no card).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from typing import Callable, Dict, List, Optional

def _header76() -> bytes:
    from ..core.header import GENESIS_HEADER_HEX

    return bytes.fromhex(GENESIS_HEADER_HEX)[:76]


def config1_genesis_kat(hasher, quick: bool) -> dict:
    """sha256d of the genesis header (its known nonce) on the hasher."""
    from ..core.header import GENESIS_HASH_HEX, GENESIS_HEADER_HEX

    t0 = time.perf_counter()
    digest = hasher.sha256d(bytes.fromhex(GENESIS_HEADER_HEX))
    dt = time.perf_counter() - t0
    return {"config": 1, "name": "genesis known-answer",
            "pass": digest[::-1].hex() == GENESIS_HASH_HEX,
            "seconds": round(dt, 6)}


def config2_linear_sweep(hasher, quick: bool) -> dict:
    """One difficulty-1 sweep crossing the genesis solve."""
    from ..core.header import GENESIS_NBITS, GENESIS_NONCE
    from ..core.target import nbits_to_target

    n = 1 << (17 if quick else 20)
    t0 = time.perf_counter()
    res = hasher.scan(_header76(), GENESIS_NONCE - n // 2, n,
                      nbits_to_target(GENESIS_NBITS))
    dt = time.perf_counter() - t0
    return {"config": 2, "name": f"linear sweep {n} nonces",
            "pass": res.nonces == [GENESIS_NONCE],
            "mhs": round(n / dt / 1e6, 3), "seconds": round(dt, 3)}


def config3_midstate_batch(hasher, quick: bool) -> dict:
    """The hasher against the oracle over the whole range: every nonce,
    no sampling."""
    from ..backends.base import get_hasher
    from ..core.target import difficulty_to_target

    n = 1 << (14 if quick else 18)
    name = f"midstate batch {n} nonces, full parity"
    target = difficulty_to_target(1 / (1 << 24))
    t0 = time.perf_counter()
    got = hasher.scan(_header76(), 10_000, n, target)
    dt = time.perf_counter() - t0
    out = {"config": 3, "name": name, "mhs": round(n / dt / 1e6, 3),
           "seconds": round(dt, 3)}
    try:  # the native hasher itself is held against hashlib
        oracle = get_hasher("cpu" if hasher.name == "native" else "native")
    except OSError as e:  # the native library failed to build
        return {**out, "pass": False, "error": f"oracle: {e}"}
    want = oracle.scan(_header76(), 10_000, n, target)
    return {**out, "pass": (got.nonces == want.nonces
                            and got.total_hits == want.total_hits),
            "oracle": oracle.name}


def config4_gbt_8way(hasher, quick: bool) -> dict:
    """An 8-way dispatcher split on a regtest getblocktemplate job."""
    from ..miner.runner import GbtMiner
    from ..testing.fake_node import REGTEST_NBITS, FakeNode

    async def main() -> dict:
        node = FakeNode(nbits=REGTEST_NBITS, witness_commitment=True)
        await node.start()
        miner = GbtMiner(node.url, hasher=hasher, n_workers=8,
                         batch_size=1 << 10, poll_interval=0.1)
        t0 = time.perf_counter()
        task = asyncio.create_task(miner.run())
        try:
            await asyncio.wait_for(node.block_seen.wait(), 120)
            for _ in range(200):
                if miner.blocks_accepted:
                    break
                await asyncio.sleep(0.05)
            dt = time.perf_counter() - t0
        finally:
            miner.stop()
            await asyncio.gather(task, return_exceptions=True)
            await node.stop()
        accepted = sum(1 for b in node.blocks if b.accepted)
        return {"config": 4, "name": "regtest GBT, 8-way split",
                "pass": (accepted >= 1
                         and miner.dispatcher.stats.hw_errors == 0),
                "blocks_accepted": accepted, "seconds": round(dt, 3)}

    return asyncio.run(main())


def config5_stratum_session(hasher, quick: bool) -> dict:
    """A Stratum session rolling extranonce2 and BIP 310 version bits,
    every share validated by the pool (hashlib)."""
    from ..core.sha256 import sha256d
    from ..miner.runner import StratumMiner
    from ..testing.mock_pool import MockStratumPool, PoolJob

    async def main() -> dict:
        pool = MockStratumPool(difficulty=1 / (1 << 24), extranonce2_size=4,
                               version_mask=0x1FFFE000)
        await pool.start()
        await pool.announce_job(PoolJob(
            job_id="bench", prevhash_internal=sha256d(b"bench-prev"),
            coinb1=bytes.fromhex("01000000") + b"\x11" * 30,
            coinb2=b"\x22" * 30 + bytes.fromhex("00000000"),
            merkle_branch=[sha256d(b"tx1")],
            version=0x20000000, nbits=0x1D00FFFF, ntime=0x655F2B2C,
        ))
        miner = StratumMiner("127.0.0.1", pool.port, "bench-worker",
                             hasher=hasher, n_workers=4, batch_size=1 << 10)
        t0 = time.perf_counter()
        task = asyncio.create_task(miner.run())
        want = 3
        try:
            while len(pool.shares) < want:
                pool.share_seen.clear()
                await asyncio.wait_for(pool.share_seen.wait(), 120)
            dt = time.perf_counter() - t0
        finally:
            miner.stop()
            await asyncio.gather(task, return_exceptions=True)
            await pool.stop()
        accepted = sum(1 for s in pool.shares if s.accepted)
        rejected = len(pool.shares) - accepted
        vbits_ok = all(s.version_bits is not None for s in pool.shares)
        return {"config": 5, "name": "stratum session, e2 + version rolling",
                "pass": accepted >= want and rejected == 0 and vbits_ok,
                "shares_accepted": accepted, "shares_rejected": rejected,
                "version_bits_on_all_submits": vbits_ok,
                "seconds": round(dt, 3)}

    return asyncio.run(main())


RUNNERS: Dict[int, Callable[..., dict]] = {
    1: config1_genesis_kat, 2: config2_linear_sweep,
    3: config3_midstate_batch, 4: config4_gbt_8way,
    5: config5_stratum_session,
}


def table(results: List[dict]) -> str:
    """The Markdown table of ``results`` (the reference's columns)."""
    lines = ["| # | scenario | pass | metric |", "|---|---|---|---|"]
    for r in results:
        if "mhs" in r:
            metric = f"{r['mhs']} MH/s"
        elif "blocks_accepted" in r:
            metric = f"{r['blocks_accepted']} blocks accepted"
        elif "shares_accepted" in r:
            metric = f"{r['shares_accepted']} shares accepted"
        else:
            metric = f"{r['seconds']}s"
        lines.append(f"| {r['config']} | {r['name']} | "
                     f"{'PASS' if r['pass'] else 'FAIL'} | {metric} |")
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m bitcoin_miner_tpu_torch.probes.run",
        description=__doc__.splitlines()[0])
    p.add_argument("--backend", default="cuda-tile",
                   help="any --backend of the command line (default "
                        "cuda-tile, the tile kernel)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the card, or the plain PyTorch versions on the CPU")
    p.add_argument("--batch-bits", type=int, default=20,
                   help="log2 nonces per dispatch (default 20)")
    p.add_argument("--inner-bits", type=int, default=None,
                   help="the hit-buffer kernel's log2 inner step (--backend "
                        "cuda; the reference's geometry is 14)")
    p.add_argument("--quick", action="store_true",
                   help="configurations 2 and 3 at 2^17 and 2^14 nonces")
    p.add_argument("--configs", default=",".join(map(str, RUNNERS)),
                   help="comma-separated subset to run")
    return p


def parse_configs(text: str) -> List[int]:
    """``--configs``' numbers, in order; ValueError names an unknown one."""
    picked = []
    for item in (x.strip() for x in text.split(",")):
        if not item:
            continue
        if not item.isdigit() or int(item) not in RUNNERS:
            raise ValueError(f"unknown config {item!r}; valid: "
                             f"{list(RUNNERS)}")
        picked.append(int(item))
    if not picked:
        raise ValueError(f"--configs names none of {list(RUNNERS)}")
    return picked


def make_hasher(args: argparse.Namespace):
    """The command line's hasher for ``args``. ``--inner-bits`` is passed
    only when given, since the command line refuses it on the tile
    kernel. Raises SystemExit on an option the backend refuses."""
    from .. import cli

    argv = ["--bench", "--backend", args.backend, "--device", args.device,
            "--batch-bits", str(args.batch_bits)]
    if args.inner_bits is not None:
        argv += ["--inner-bits", str(args.inner_bits)]
    return cli.make_hasher(cli.build_parser().parse_args(argv))


def main(argv: Optional[List[str]] = None,
         after_config: Optional[Callable[[dict], None]] = None) -> int:
    """Run the matrix; ``after_config`` sees each configuration's result
    as soon as it is printed (a caller in the same process reads the
    launch counters there)."""
    args = build_parser().parse_args(argv)
    try:
        picked = parse_configs(args.configs)
    except ValueError as e:
        print(f"run: {e}", file=sys.stderr)
        return 2
    from .. import cli

    if args.device == "cuda" and args.backend not in cli.HOST_BACKENDS:
        import torch

        if not torch.cuda.is_available():
            print("run: no CUDA device; --device cpu runs the plain "
                  "PyTorch versions", file=sys.stderr)
            return 2
    try:
        hasher = make_hasher(args)
    except SystemExit as e:
        print(f"run: {e}", file=sys.stderr)
        return 2
    results = []
    for c in picked:
        results.append(RUNNERS[c](hasher, args.quick))
        print(json.dumps(results[-1]), flush=True)
        if after_config is not None:
            after_config(results[-1])
    print()
    print(table(results), flush=True)
    return 0 if all(r["pass"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
