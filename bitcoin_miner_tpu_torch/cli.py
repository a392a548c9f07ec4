"""Command line: ``python -m bitcoin_miner_tpu_torch``.

Modes:
  --pool stratum+tcp://HOST:PORT   Stratum v1 pool mining
  --bench                          offline sweep of the genesis header

Backends: ``cuda-tile`` (default; the tile kernel), ``cuda`` (the
hit-buffer kernel), their sharded forms over several cards ``cuda-tile-mesh``
and ``cuda-mesh``, ``cuda-mesh-native`` (the sharded scan behind one
dispatch ring, ``--mesh-kernel cuda|cuda-tile``), ``cuda-fanout`` (whole
requests to one hasher per card, ``--fanout-kernel cuda|cuda-tile``) and
``cpu`` (the hashlib oracle). ``--mesh-devices N`` takes the first N
cards for the multi-device backends (default: all). ``--device cpu``
runs the CUDA backends' plain PyTorch versions instead of the kernels,
on one device; without it they need a card. ``--vshare k`` hashes every
nonce against k version-rolled sibling headers (overt AsicBoost) on the
CUDA backends. ``--variant``, ``--cgroup``, ``--interleave``,
``--sublanes`` and ``--inner-tiles`` choose the tile kernel's layout and
step wherever the tile kernel runs; the other backends refuse them.
``--unroll`` and ``--no-spec`` choose the kernels' compile form. The
miner writes no files.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import sys
import time
from typing import TYPE_CHECKING, Optional
from urllib.parse import urlparse

from .backends.base import (
    Hasher,
    dispatch_granularity,
    get_hasher,
)
from .ops.sha256_tile import VARIANTS
from .parallel.meshring import MESH_KERNELS
from .core.header import GENESIS_HEADER_HEX, GENESIS_NBITS, GENESIS_NONCE
from .core.target import nbits_to_target
from .miner.scheduler import (
    AdaptiveBatchScheduler,
    SweepReport,
    scheduler_for,
    stream_sweep,
)

if TYPE_CHECKING:
    from .miner.runner import StratumMiner

logger = logging.getLogger("tpu_miner_torch")

#: log2 of the nonces per device dispatch when ``--batch-bits`` is not given.
DEFAULT_BATCH_BITS = 24

#: ``--backend`` choices, the default first.
BACKENDS = ("cuda-tile", "cuda", "cuda-tile-mesh", "cuda-mesh",
            "cuda-mesh-native", "cuda-fanout", "cpu")



def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m bitcoin_miner_tpu_torch",
        description="Bitcoin miner with hand-written CUDA sha256d kernels",
    )
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--pool", help="stratum+tcp://host:port pool URL")
    mode.add_argument("--bench", action="store_true",
                      help="offline sweep around the genesis nonce at the "
                           "difficulty-1 target")
    p.add_argument("--user", default="tpu-miner", help="pool username")
    p.add_argument("--password", default="x", help="pool password")
    p.add_argument("--backend", default="cuda-tile", choices=BACKENDS,
                   help="hasher backend (default: %(default)s)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the cuda backends run: the card, or their "
                        "plain PyTorch versions on the CPU (one device)")
    p.add_argument("--mesh-devices", type=int, default=None,
                   help="multi-device backends (cuda-mesh, cuda-tile-mesh, "
                        "cuda-mesh-native, cuda-fanout): the first N cards "
                        "(default: every card)")
    p.add_argument("--mesh-kernel", default=None, choices=MESH_KERNELS,
                   help="cuda-mesh-native: the per-shard kernel, the "
                        "hit-buffer scan (cuda) or the tile scan "
                        "(cuda-tile, which takes the layout options); "
                        "default cuda")
    p.add_argument("--fanout-kernel", default=None, choices=MESH_KERNELS,
                   help="cuda-fanout: the per-card hasher's kernel, as "
                        "--mesh-kernel; default cuda")
    p.add_argument("--unroll", type=int, default=None,
                   help="cuda backends: SHA-256 rounds per iteration of "
                        "the kernels' round loops (64, the default, "
                        "unrolls them fully; below 64 they stay rolled)")
    p.add_argument("--no-spec", action="store_true",
                   help="cuda backends: build the kernels without the "
                        "partial evaluation of the padding, length and IV "
                        "words (applies at --unroll 64); with --vshare > 1 "
                        "the hit-buffer kernel refuses it")
    p.add_argument("--vshare", type=int, default=1,
                   help="cuda backends: k version-rolled midstate chains "
                        "sharing one chunk-2 schedule per nonce (overt "
                        "AsicBoost, 1 <= k <= 8). Sibling shares carry BIP "
                        "310 version bits from the pool's negotiated mask; "
                        "a pool that grants no (or too narrow a) mask "
                        "degrades the miner to chain 0 and it says so. "
                        "Default %(default)s")
    p.add_argument("--variant", default=None, choices=VARIANTS,
                   help="tile kernel: layout of the tile kernel, the same "
                        "hashes on another schedule: baseline (job words "
                        "read from the card where used), regchain (job "
                        "words as launch parameters), wsplit (regchain in "
                        "chain passes of one), wstage (the 64-word "
                        "schedule expanded once per nonce into shared "
                        "memory, read back by each chain pass), vroll "
                        "(wstage version-major: each pass over all nonces "
                        "in flight) or vroll-db (vroll over two staged "
                        "groups of nonces). Default baseline")
    p.add_argument("--cgroup", type=int, default=None,
                   help="tile kernel: chains per pass over the rounds, 1 <= g "
                        "<= --vshare; default from --variant (1 for "
                        "wsplit/wstage/vroll/vroll-db, k otherwise)")
    p.add_argument("--interleave", type=int, default=None,
                   help="tile kernel: nonces in flight per thread (ILP for "
                        "the serial round chain); clamped down to a "
                        "divisor of the effective --inner-tiles (logged "
                        "when it changes), default 1")
    p.add_argument("--sublanes", type=int, default=None,
                   help="tile kernel: 128-nonce rows per tile, default 8")
    p.add_argument("--inner-tiles", type=int, default=None,
                   help="tile kernel: tiles per step (a step of sublanes x "
                        "128 x inner-tiles nonces is one (count, min) slot "
                        "per chain), clamped down to fit the batch, "
                        "default 8")
    p.add_argument("--batch-bits", type=int, default=None,
                   help="log2 of nonces per device dispatch (a sharded "
                        "dispatch covers that many on every device), fixed; "
                        "default: the adaptive scheduler sizes requests "
                        "online over a dispatch grid of "
                        f"2^{DEFAULT_BATCH_BITS} nonces per device")
    p.add_argument("--workers", type=int, default=8,
                   help="dispatcher workers (nonce-range split ways)")
    p.add_argument("--stream-depth", type=int, default=2,
                   help="requests each worker keeps in flight ahead of "
                        "verification (0 = blocking scan-then-verify loop)")
    p.add_argument("--bench-nonces", type=int, default=1 << 26,
                   help="nonces for --bench, centred on the genesis nonce "
                        "(2^32 sweeps the whole nonce space)")
    p.add_argument("--report-interval", type=float, default=10.0,
                   help="seconds between stats lines")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


#: The tile kernel's layout options and the value each takes when not given.
TILE_OPTIONS = (("variant", "baseline"), ("cgroup", 0), ("interleave", 1),
                ("sublanes", 8), ("inner_tiles", 8))

#: The backends that run on several devices.
MULTI_DEVICE_BACKENDS = ("cuda-mesh", "cuda-tile-mesh", "cuda-mesh-native",
                         "cuda-fanout")

#: The hit-buffer kernel's largest inner step (``CudaHasher``'s default).
INNER_BITS = 18


def _kernel_of(args: argparse.Namespace) -> str:
    """The scan kernel the options run: ``cuda-tile`` (the tile kernel),
    ``cuda`` (the hit-buffer kernel) or ``cpu``."""
    if args.backend == "cuda-mesh-native":
        return args.mesh_kernel or "cuda"
    if args.backend == "cuda-fanout":
        return args.fanout_kernel or "cuda"
    return {"cuda-tile-mesh": "cuda-tile", "cuda-mesh": "cuda"}.get(
        args.backend, args.backend)


def _refuse(flag: str, val, where: str, backend: str) -> None:
    raise SystemExit(f"--{flag.replace('_', '-')} {val} applies only to "
                     f"{where}; --backend {backend} ignores it")


def make_hasher(args: argparse.Namespace) -> Hasher:
    # A run must not be labelled with a geometry that never ran: options
    # of a kernel or backend that does not run are refused (an explicit
    # interleave of 1 describes what runs, and passes).
    kernel = _kernel_of(args)
    if kernel != "cuda-tile":
        for flag, default in TILE_OPTIONS:
            val = getattr(args, flag)
            if val is not None and (flag, val) != ("interleave", 1):
                _refuse(flag, val, "the tile kernel (--backend cuda-tile, "
                        "cuda-tile-mesh, or --mesh-kernel/--fanout-kernel "
                        "cuda-tile)", args.backend)
    for flag, backend in (("mesh_kernel", "cuda-mesh-native"),
                          ("fanout_kernel", "cuda-fanout")):
        val = getattr(args, flag)
        if val is not None and args.backend != backend:
            _refuse(flag, val, f"--backend {backend}", args.backend)
    if args.mesh_devices is not None and (
            args.backend not in MULTI_DEVICE_BACKENDS):
        _refuse("mesh_devices", args.mesh_devices,
                "the multi-device backends", args.backend)
    if args.backend == "cpu":
        for flag, val, default in (("vshare", args.vshare, 1),
                                   ("unroll", args.unroll, None),
                                   ("no_spec", args.no_spec, False)):
            if val != default:
                _refuse(flag, "" if val is True else val, "the cuda backends",
                        "cpu")
        return get_hasher("cpu")
    unroll = 64 if args.unroll is None else args.unroll
    spec = not args.no_spec
    if unroll < 1:
        raise SystemExit("--unroll must be >= 1")
    if kernel == "cuda" and args.vshare > 1 and not spec:
        raise SystemExit(
            f"--vshare > 1 on the hit-buffer kernel (--backend "
            f"{args.backend}) requires the spec kernel form (drop --no-spec)")
    bits = DEFAULT_BATCH_BITS if args.batch_bits is None else args.batch_bits
    kwargs = dict(vshare=args.vshare, unroll=unroll, spec=spec)
    if kernel == "cuda-tile":
        kwargs.update({flag: default if getattr(args, flag) is None
                       else getattr(args, flag)
                       for flag, default in TILE_OPTIONS})
        if min(kwargs["sublanes"], kwargs["inner_tiles"],
               kwargs["interleave"], args.vshare) < 1:
            raise SystemExit("--sublanes, --inner-tiles, --interleave and "
                             "--vshare must be >= 1")
        if not 0 <= kwargs["cgroup"] <= args.vshare:
            raise SystemExit(
                f"--cgroup must be between 1 and --vshare ({args.vshare})")
    else:
        kwargs["inner_size"] = 1 << min(bits, INNER_BITS)
    if args.backend not in MULTI_DEVICE_BACKENDS:
        return get_hasher(args.backend, batch_size=1 << bits,
                          device=args.device, **kwargs)
    if args.device == "cpu":
        # One shard on the CPU: the command line never names a device
        # twice.
        if args.mesh_devices not in (None, 1):
            raise SystemExit("--device cpu runs one device; --mesh-devices "
                             f"{args.mesh_devices} needs as many cards")
        kwargs["devices"] = ["cpu"]
    else:
        kwargs["n_devices"] = args.mesh_devices
    if args.backend in ("cuda-mesh-native", "cuda-fanout"):
        kwargs["kernel"] = kernel
    return get_hasher(args.backend, batch_per_device=1 << bits, **kwargs)


def make_scheduler(args: argparse.Namespace, hasher: Hasher
                   ) -> Optional[AdaptiveBatchScheduler]:
    """The adaptive scheduler, or None when ``--batch-bits`` fixed the
    dispatch size."""
    return None if args.batch_bits is not None else scheduler_for(hasher)


def run_bench(hasher: Hasher, count: int,
              scheduler: Optional[AdaptiveBatchScheduler] = None,
              batch_size: Optional[int] = None) -> dict:
    """Sweep ``count`` nonces of the genesis header centred on its nonce
    at the difficulty-1 target, through the hasher's streaming path, and
    verify the solve on the CPU oracle. ``hashes`` counts every chain's
    hashes (nonces × vshare); ``version_hits`` are the sibling chains'
    hits as (version, nonce) pairs."""
    header76 = bytes.fromhex(GENESIS_HEADER_HEX)[:76]
    target = nbits_to_target(GENESIS_NBITS)
    start = max(0, GENESIS_NONCE - count // 2)
    count = min(count, (1 << 32) - start)
    t0 = time.perf_counter()
    report: SweepReport = stream_sweep(hasher, header76, start, count, target,
                                       scheduler=scheduler,
                                       batch_size=batch_size)
    seconds = time.perf_counter() - t0
    found = GENESIS_NONCE in report.nonces
    verified = found and get_hasher("cpu").verify(
        header76 + GENESIS_NONCE.to_bytes(4, "little"), target)
    return {
        "nonce_start": start, "hashes": report.hashes_done,
        "dispatches": report.dispatches, "seconds": seconds,
        "mhs": report.hashes_done / seconds / 1e6, "nonces": report.nonces,
        "version_hits": report.version_hits, "found": found,
        "verified": verified,
    }


def bench(args: argparse.Namespace) -> dict:
    """``--bench``: :func:`run_bench` through the hasher and scheduler the
    options select."""
    hasher = make_hasher(args)
    return run_bench(hasher, args.bench_nonces,
                     scheduler=make_scheduler(args, hasher))


def cmd_bench(args: argparse.Namespace) -> int:
    out = bench(args)
    siblings = "".join(f", sibling hit version={v:#010x} nonce={n:#010x}"
                       for v, n in out["version_hits"])
    print(
        f"{out['mhs']:.2f} MH/s over {out['hashes']} hashes in "
        f"{out['seconds']:.2f}s ({out['dispatches']} dispatches, backend "
        f"{args.backend} on {args.device}, vshare {args.vshare}"
        f"{', variant ' + args.variant if args.variant else ''}); genesis "
        f"nonce {'FOUND+VERIFIED' if out['verified'] else 'MISSED'}"
        f"{siblings}"
    )
    return 0 if out["verified"] else 2


async def _run_with_reporter(miner, interval: float) -> None:
    async def report() -> None:
        while True:
            await asyncio.sleep(interval)
            logger.info("%s", miner.dispatcher.stats.summary())

    reporter = asyncio.create_task(report())
    try:
        await miner.run()
    finally:
        reporter.cancel()
        await asyncio.gather(reporter, return_exceptions=True)
        logger.info("stopped; final: %s", miner.dispatcher.stats.summary())


def make_miner(args: argparse.Namespace) -> "StratumMiner":
    """The ``--pool`` session the options select."""
    from .miner.runner import StratumMiner

    url = args.pool if "//" in args.pool else f"stratum+tcp://{args.pool}"
    parsed = urlparse(url)
    if parsed.scheme != "stratum+tcp":
        raise SystemExit(f"--pool must be a stratum+tcp:// URL, got {url!r}")
    try:
        host, port = parsed.hostname or "127.0.0.1", parsed.port or 3333
    except ValueError as e:
        raise SystemExit(f"bad --pool URL: {e}")
    hasher = make_hasher(args)
    return StratumMiner(
        host, port, args.user, args.password, hasher=hasher,
        n_workers=args.workers,
        batch_size=dispatch_granularity(hasher, 1 << DEFAULT_BATCH_BITS),
        stream_depth=args.stream_depth,
        scheduler=make_scheduler(args, hasher),
    )


def cmd_pool(args: argparse.Namespace) -> int:
    miner = make_miner(args)
    try:
        asyncio.run(_run_with_reporter(miner, args.report_interval))
    except KeyboardInterrupt:
        logger.info("interrupted; final: %s", miner.dispatcher.stats.summary())
    return 0


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
        datefmt="%H:%M:%S",
    )
    if args.bench:
        return cmd_bench(args)
    return cmd_pool(args)
