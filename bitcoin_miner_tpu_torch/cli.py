"""Command line: ``python -m bitcoin_miner_tpu_torch``.

Modes:
  --pool stratum+tcp://HOST:PORT   Stratum v1 pool mining (stratum+ssl://
                                   for TLS; comma-listed backups for
                                   failover); repeated, or with a
                                   getwork+http:// or gbt+http:// URL, the
                                   multi-pool fabric (``#w=N`` weights)
  --gbt  http://HOST:PORT          solo mining via getblocktemplate
  --getwork http://HOST:PORT       getwork polling
  --bench                          offline sweep of the genesis header
  --serve-hasher HOST:PORT         serve the backend as a gRPC hasher
                                   worker (``rpc/hasher_service.py``)
  --serve-pool HOST:PORT           serve a Stratum v1 pool frontend to
                                   downstream miners (``poolserver/``):
                                   jobs from a local template stream or
                                   ``--upstream`` pools (one, or several
                                   through the multi-pool fabric);
                                   ``--internal-worker`` mines the
                                   frontend's own slice with ``--backend``

Backends: ``cuda-tile`` (default; the tile kernel), ``cuda`` (the
hit-buffer kernel), their sharded forms over several cards ``cuda-tile-mesh``
and ``cuda-mesh``, ``cuda-mesh-native`` (the sharded scan behind one
dispatch ring, ``--mesh-kernel cuda|cuda-tile``), ``cuda-fanout`` (whole
requests to one hasher per card, ``--fanout-kernel cuda|cuda-tile``),
``cuda-fleet`` (one hit-buffer hasher per card under the fleet supervisor:
a dead card is quarantined and its requests reclaimed), ``grpc`` (a served
worker, ``--grpc-target HOST:PORT``), ``cpu`` (the hashlib oracle) and
``native`` (the C++ hasher on the host CPU, ``backends/native.py``).
``--worker HOST:PORT``, repeated, mines on a supervised fleet of served
workers. The gRPC paths need ``grpcio``. ``--mesh-devices N`` takes the
first N cards for the multi-device backends (default: all). ``--device cpu``
runs the CUDA backends' plain PyTorch versions instead of the kernels,
on one device; without it they need a card. ``--vshare k`` hashes every
nonce against k version-rolled sibling headers (overt AsicBoost) on the
CUDA backends. ``--variant``, ``--cgroup``, ``--interleave``,
``--sublanes`` and ``--inner-tiles`` choose the tile kernel's layout and
step wherever the tile kernel runs; the other backends refuse them.
``--unroll`` and ``--no-spec`` choose the kernels' compile form;
``--inner-bits`` the hit-buffer kernel's step.
``--batch-3x`` makes the dispatch 3·2^batch-bits nonces, which tile
heights such as ``--sublanes 24`` divide.

Telemetry (``telemetry/``): metrics are on unless
``TPU_MINER_TELEMETRY=0``; ``--status-port`` serves them with the health
verdict, the span buffer, the flight recorder, the share lifecycles, the
SLO report and range queries over the time-series store
(``utils/status.py``); ``--trace-out PATH`` records spans and writes
them at exit; ``--health-interval`` paces the health watchdog, which
also ticks the SLO engine (``--slo-fast-window``, ``--slo-slow-window``,
``--slo-objectives``), and the observatory's collector, which samples
the registry into the store and scrapes ``--federate`` members and the
``--worker HOST:PORT@STATUSPORT`` workers. The miner writes no other
files than ``--checkpoint PATH`` (``--pool``, ``--gbt``), ``--trace-out``,
on a crash or SIGUSR2 only ``--flightrec-out``, and on an SLO breach an
incident bundle under ``--incident-dir``.

Subcommands, given first: ``perf`` (the perf ledger, ``perf_cli.py``),
``slo`` (the objective table, or a live ``/slo`` report) and ``top``
(the dashboard over ``/query``).
"""

from __future__ import annotations

import argparse
import asyncio
import importlib.util
import logging
import signal
import sys
import time
from typing import TYPE_CHECKING, List, Optional, Tuple, Union
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
from .telemetry import (
    DEFAULT_OBJECTIVES,
    HealthModel,
    HealthWatchdog,
    IncidentCapture,
    Observatory,
    PipelineTelemetry,
    ScrapeFederator,
    ScrapeTarget,
    SloConfigError,
    SloEngine,
    TimeSeriesStore,
    get_telemetry,
    load_objectives,
    set_telemetry,
)

if TYPE_CHECKING:
    from .miner.multipool import MultipoolMiner
    from .miner.runner import GbtMiner, GetworkMiner, StratumMiner
    from .poolserver import PoolFrontend

logger = logging.getLogger("tpu_miner_torch")

#: log2 of the nonces per device dispatch when ``--batch-bits`` is not given.
DEFAULT_BATCH_BITS = 24

#: log2 of the hit-buffer kernel's inner step when ``--inner-bits`` is not
#: given (``CudaHasher``'s default step).
DEFAULT_INNER_BITS = 18

#: seconds between health-watchdog evaluations when not given.
DEFAULT_HEALTH_INTERVAL = 5.0

#: the SLO engine's fast and slow burn windows (seconds) and the incident
#: bundles' root when not given (the reference's defaults).
DEFAULT_SLO_FAST_WINDOW = 60.0
DEFAULT_SLO_SLOW_WINDOW = 300.0
DEFAULT_INCIDENT_DIR = "tpu-miner-incidents"

#: ``--backend`` choices, the default first.
BACKENDS = ("cuda-tile", "cuda", "cuda-tile-mesh", "cuda-mesh",
            "cuda-mesh-native", "cuda-fanout", "cuda-fleet", "grpc", "cpu",
            "native")

#: The hashers that run on the host CPU whatever ``--device`` says.
HOST_BACKENDS = ("cpu", "native")

#: The ``--serve-pool`` options, each with its value when not given (the
#: parser leaves them None, so another mode can refuse them).
SERVE_DEFAULTS = {
    "serve_difficulty": 1.0,
    "serve_extranonce2_size": 4,
    "serve_prefix_bytes": 2,
    "serve_job_interval": 30.0,
    "serve_shards": 0,
    "serve_vardiff_interval": 30.0,
}



def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m bitcoin_miner_tpu_torch",
        description="Bitcoin miner with hand-written CUDA sha256d kernels",
    )
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--pool", action="append",
                      help="stratum+tcp://host:port (or stratum+ssl:// for "
                           "TLS) pool URL; comma-separate backups for cold "
                           "failover, all of one scheme. REPEATABLE: more "
                           "than one --pool runs the multi-pool fabric, "
                           "concurrent upstream sessions (stratum and "
                           "getwork+http:// or gbt+http:// mixed) with "
                           "capacity routing and instant failover; append "
                           "#w=N for a dispatch weight (default 1)")
    mode.add_argument("--gbt", help="http://host:port bitcoind RPC "
                                    "(getblocktemplate)")
    mode.add_argument("--getwork", help="http://host:port getwork endpoint")
    mode.add_argument("--bench", action="store_true",
                      help="offline sweep around the genesis nonce at the "
                           "difficulty-1 target")
    mode.add_argument("--serve-hasher", metavar="HOST:PORT",
                      help="serve --backend as a gRPC hasher worker, which "
                           "a miner drives with --backend grpc "
                           "--grpc-target or --worker; records spans for "
                           "the miner's --trace-out (needs grpcio)")
    mode.add_argument("--serve-pool", metavar="HOST:PORT",
                      help="serve a Stratum v1 pool frontend to downstream "
                           "miners (poolserver/): per-session extranonce "
                           "space partitioning, CPU share validation, jobs "
                           "from --upstream (proxy mode) or a local "
                           "template stream; --internal-worker mines the "
                           "frontend's own slice with --backend")
    p.add_argument("--user", default="tpu-miner", help="pool/RPC username")
    p.add_argument("--password", default="x", help="pool/RPC password")
    p.add_argument("--backend", default="cuda-tile", choices=BACKENDS,
                   help="hasher backend (default: %(default)s)")
    p.add_argument("--grpc-target", default=None, metavar="HOST:PORT",
                   help="--backend grpc: the served worker")
    p.add_argument("--worker", action="append", default=None,
                   metavar="HOST:PORT[@STATUSPORT]",
                   help="repeatable: a served worker (--serve-hasher); any "
                        "--worker mines on the supervised fleet of them "
                        "(parallel/supervisor.py): a worker unavailable "
                        "for 10 s is quarantined, its requests reclaimed "
                        "by the others with no nonce lost or duplicated, "
                        "and half-open probed back in. --backend stays at "
                        "its default or grpc. @STATUSPORT names the "
                        "worker's --status-port: the observatory scrapes "
                        "its /metrics into this process's /query under "
                        "worker=HOST:PORT")
    serve = p.add_argument_group(
        "serve-pool", "pool-frontend options (--serve-pool mode)")
    serve.add_argument("--upstream", action="append", default=None,
                       help="stratum+tcp://host:port upstream pool: proxy "
                            "mode, the upstream session fanned out to every "
                            "downstream client (authenticated with --user/"
                            "--password); omitted: a local template job "
                            "stream. REPEATABLE: more than one --upstream "
                            "rides the multi-pool fabric (concurrent "
                            "sessions, instant failover: the frontend "
                            "survives upstream death); append #w=N for a "
                            "dispatch weight")
    serve.add_argument("--serve-difficulty", type=float, default=None,
                       help="downstream share difficulty (local-template "
                            "mode; proxy mode tracks the upstream "
                            "difficulty once it arrives); default "
                            f"{SERVE_DEFAULTS['serve_difficulty']:g}")
    serve.add_argument("--serve-extranonce2-size", type=int, default=None,
                       help="total extranonce2 bytes the frontend owns "
                            "(local mode; proxy mode adopts the "
                            "upstream's); default "
                            f"{SERVE_DEFAULTS['serve_extranonce2_size']}")
    serve.add_argument("--serve-prefix-bytes", type=int, default=None,
                       help="extranonce bytes carved per session: 256^N "
                            "concurrent disjoint client slices; default "
                            f"{SERVE_DEFAULTS['serve_prefix_bytes']}")
    serve.add_argument("--serve-job-interval", type=float, default=None,
                       help="seconds between local-template job "
                            "announcements (local mode only); default "
                            f"{SERVE_DEFAULTS['serve_job_interval']:g}")
    serve.add_argument("--internal-worker", action="store_true",
                       help="mine the frontend's own slice with --backend "
                            "through the standard dispatcher (the server "
                            "becomes its own biggest miner); on the card "
                            "unless --device cpu. Composes with --worker "
                            "HOST:PORT (the supervised gRPC fleet) or "
                            "--backend grpc --grpc-target")
    serve.add_argument("--serve-shards", type=int, default=None,
                       metavar="N",
                       help="shard the frontend across N acceptor "
                            "processes; not ported yet: N > 1 is refused")
    serve.add_argument("--serve-vardiff", type=float, default=None,
                       metavar="SHARES_PER_MIN",
                       help="per-session vardiff: retarget each session "
                            "from its own claimed-work rate toward this "
                            "share rate (bounded step, floored at the "
                            "operator difficulty) instead of honouring "
                            "mining.suggest_difficulty verbatim; off by "
                            "default")
    serve.add_argument("--serve-vardiff-interval", type=float, default=None,
                       help="seconds between per-session vardiff retargets "
                            "(with --serve-vardiff); default "
                            f"{SERVE_DEFAULTS['serve_vardiff_interval']:g}")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the cuda backends run: the card, or their "
                        "plain PyTorch versions on the CPU (one device)")
    p.add_argument("--mesh-devices", type=int, default=None,
                   help="multi-device backends (cuda-mesh, cuda-tile-mesh, "
                        "cuda-mesh-native, cuda-fanout, cuda-fleet): the "
                        "first N cards (default: every card)")
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
    p.add_argument("--inner-bits", type=int, default=None,
                   help="hit-buffer kernel (--backend cuda, cuda-mesh, "
                        "cuda-fleet, --mesh-kernel/--fanout-kernel cuda): "
                        "log2 of the nonces per inner step, capped at "
                        f"--batch-bits; default {DEFAULT_INNER_BITS}")
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
    p.add_argument("--batch-3x", action="store_true",
                   help="dispatch 3·2^batch-bits nonces instead of "
                        "2^batch-bits: a size that tile heights such as "
                        "--sublanes 24 divide")
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
    p.add_argument("--checkpoint", default=None,
                   help="--pool, --gbt: file that keeps each job's sweep "
                        "position, so a restarted miner resumes")
    p.add_argument("--ntime-roll", type=int, default=None,
                   help="--pool, --getwork: seconds of ntime rolling once "
                        "the extranonce2 x nonce space is exhausted "
                        "(default: 600 for --getwork, 0 for --pool)")
    p.add_argument("--host-index", type=int, default=None,
                   help="--pool: this host's index for the extranonce2 "
                        "partition (default 0)")
    p.add_argument("--n-hosts", type=int, default=None,
                   help="--pool: hosts sharing the extranonce2 space "
                        "(default 1)")
    p.add_argument("--suggest-difficulty", type=float, default=None,
                   help="--pool: ask the pool for this share difficulty "
                        "after subscribing (mining.suggest_difficulty; "
                        "pools may ignore it)")
    p.add_argument("--tls-no-verify", action="store_true",
                   help="stratum+ssl:// pools: skip certificate "
                        "verification (self-signed certificates); "
                        "verification is on by default")
    p.add_argument("--allow-redirect", action="store_true",
                   help="--pool: honour client.reconnect to a different "
                        "host (off: a cross-host redirect over the "
                        "plaintext link is a hijack vector)")
    p.add_argument("--status-port", type=int, default=None,
                   help="session modes: serve live stats on "
                        "http://127.0.0.1:PORT/ as JSON; /metrics answers "
                        "in Prometheus exposition format, /telemetry dumps "
                        "the metric registry as JSON, /healthz answers "
                        "200/503 from the health model, /trace serves the "
                        "span buffer, /flightrec the flight recorder, "
                        "/lifecycle the share lifecycles, /slo the SLO "
                        "report, /query?name=&prefix=&window_s=&tier= "
                        "(other parameters match labels) the time-series "
                        "store")
    p.add_argument("--trace-out", metavar="PATH", default=None,
                   help="record the share pipeline (job notify, feeder "
                        "slices, device dispatches, ring collects, CPU "
                        "verifies, submits, pool acks) and write it as "
                        "Chrome trace-event JSON here on exit; opens in "
                        "Perfetto")
    p.add_argument("--flightrec-out", metavar="PATH",
                   default="tpu-miner-flightrec.json",
                   help="where the flight recorder (the structured-event "
                        "black box) dumps on a crash or SIGUSR2; also "
                        "served at /flightrec on --status-port (default: "
                        "%(default)s)")
    p.add_argument("--health-interval", type=float, default=None,
                   help="session modes: seconds between "
                        "health-watchdog evaluations (the /healthz rule "
                        "engine; 0 runs no watchdog and /healthz "
                        "evaluates per request); default "
                        f"{DEFAULT_HEALTH_INTERVAL:g}. The watchdog also "
                        "ticks the SLO engine and the lost-share sweep, "
                        "and the observatory collects at the same pace "
                        "(none at 0)")
    p.add_argument("--slo-fast-window", type=float, default=None,
                   metavar="SECONDS",
                   help="the SLO engine's fast burn window, which the "
                        "breach trigger reads (telemetry/slo.py); default "
                        f"{DEFAULT_SLO_FAST_WINDOW:g}")
    p.add_argument("--slo-slow-window", type=float, default=None,
                   metavar="SECONDS",
                   help="the SLO engine's slow (confirming) burn window, "
                        ">= the fast one; default "
                        f"{DEFAULT_SLO_SLOW_WINDOW:g}")
    p.add_argument("--slo-objectives", metavar="FILE", default=None,
                   help="objectives (tpu-miner-slo-objectives/1 JSON) in "
                        "place of the built-in DEFAULT_OBJECTIVES, "
                        "validated at start; `slo --objectives FILE` "
                        "prints the same file's table")
    p.add_argument("--incident-dir", metavar="DIR", default=None,
                   help="root of the incident bundles an SLO breach "
                        "captures (flight recorder, trace, metrics, "
                        "telemetry, lifecycles, the SLO report and its "
                        "history under one tpu-miner-incident/1 manifest "
                        "keyed to a row of DIR/incident_ledger.jsonl); "
                        "an empty string captures none; default "
                        f"{DEFAULT_INCIDENT_DIR}")
    p.add_argument("--federate", action="append", default=None,
                   metavar="NAME=URL",
                   help="repeatable: a /metrics endpoint the observatory "
                        "scrapes into the time-series store under process "
                        "label NAME (e.g. worker-1=http://127.0.0.1:18988/"
                        "metrics); --worker HOST:PORT@STATUSPORT workers "
                        "are found without it")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


#: The tile kernel's layout options and the value each takes when not given.
TILE_OPTIONS = (("variant", "baseline"), ("cgroup", 0), ("interleave", 1),
                ("sublanes", 8), ("inner_tiles", 8))

#: The backends that run on several devices.
MULTI_DEVICE_BACKENDS = ("cuda-mesh", "cuda-tile-mesh", "cuda-mesh-native",
                         "cuda-fanout", "cuda-fleet")

#: The options of a local device, each with its value when not given:
#: a served worker's own options govern what it runs, so ``--backend
#: grpc`` and ``--worker`` refuse them.
LOCAL_DEVICE_OPTIONS = (*((flag, None) for flag, _ in TILE_OPTIONS),
                        ("mesh_kernel", None),
                        ("fanout_kernel", None), ("mesh_devices", None),
                        ("unroll", None), ("no_spec", False),
                        ("inner_bits", None), ("vshare", 1),
                        ("device", "cuda"))


def _kernel_of(args: argparse.Namespace) -> str:
    """The scan kernel the options run: ``cuda-tile`` (the tile kernel),
    ``cuda`` (the hit-buffer kernel), ``cpu``, or ``grpc`` (none here)."""
    if args.backend == "cuda-mesh-native":
        return args.mesh_kernel or "cuda"
    if args.backend == "cuda-fanout":
        return args.fanout_kernel or "cuda"
    return {"cuda-tile-mesh": "cuda-tile", "cuda-mesh": "cuda",
            "cuda-fleet": "cuda"}.get(args.backend, args.backend)


def _refuse(flag: str, val, where: str, backend: str) -> None:
    raise SystemExit(f"--{flag.replace('_', '-')} {val} applies only to "
                     f"{where}; --backend {backend} ignores it")


def _hasher_service():
    """``rpc/hasher_service``, imported only by the gRPC paths."""
    if importlib.util.find_spec("grpc") is None:
        raise SystemExit("grpcio is not installed: --serve-hasher, "
                         "--backend grpc and --worker need it")
    from .rpc import hasher_service

    return hasher_service


def _remote_hasher(args: argparse.Namespace) -> Hasher:
    """``--backend grpc`` or ``--worker``: a served worker's own options
    govern what it runs, so every local-device option is refused."""
    workers = [w.strip() for w in args.worker or () if w.strip()]
    if workers:
        if args.backend not in ("cuda-tile", "grpc"):
            raise SystemExit(f"--worker builds a supervised gRPC fleet; it "
                             f"cannot combine with --backend {args.backend}")
        if args.grpc_target:
            raise SystemExit(
                "--grpc-target is the single-worker (unsupervised) path; "
                "with --worker, list every worker as its own --worker flag")
    for flag, default in LOCAL_DEVICE_OPTIONS:
        val = getattr(args, flag)
        if val != default:
            _refuse(flag, val, "a local hasher (a served worker's own "
                    "options govern it)", "grpc")
    service = _hasher_service()
    if workers:
        from .parallel.supervisor import make_grpc_fleet

        try:
            return make_grpc_fleet(workers)
        except ValueError as e:
            raise SystemExit(str(e))
    if not args.grpc_target:
        raise SystemExit("--backend grpc requires --grpc-target HOST:PORT")
    return service.GrpcHasher(args.grpc_target)


def make_hasher(args: argparse.Namespace) -> Hasher:
    # A run must not be labelled with a geometry that never ran: options
    # of a kernel or backend that does not run are refused (an explicit
    # interleave of 1 describes what runs, and passes).
    if args.worker or args.backend == "grpc":
        return _remote_hasher(args)
    if args.grpc_target:
        _refuse("grpc_target", args.grpc_target, "--backend grpc",
                args.backend)
    kernel = _kernel_of(args)
    if args.inner_bits is not None and kernel != "cuda":
        _refuse("inner_bits", args.inner_bits, "the hit-buffer kernel "
                "(--backend cuda, cuda-mesh, cuda-fleet, or --mesh-kernel/"
                "--fanout-kernel cuda)", args.backend)
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
    if args.backend in HOST_BACKENDS:
        for flag, val, default in (("vshare", args.vshare, 1),
                                   ("unroll", args.unroll, None),
                                   ("no_spec", args.no_spec, False)):
            if val != default:
                _refuse(flag, "" if val is True else val, "the cuda backends",
                        args.backend)
        try:
            return get_hasher(args.backend)
        except OSError as e:  # the native library could not be built
            raise SystemExit(str(e))
    unroll = 64 if args.unroll is None else args.unroll
    spec = not args.no_spec
    if unroll < 1:
        raise SystemExit("--unroll must be >= 1")
    if kernel == "cuda" and args.vshare > 1 and not spec:
        raise SystemExit(
            f"--vshare > 1 on the hit-buffer kernel (--backend "
            f"{args.backend}) requires the spec kernel form (drop --no-spec)")
    bits = DEFAULT_BATCH_BITS if args.batch_bits is None else args.batch_bits
    batch = batch_size_for(args)
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
        inner_bits = (DEFAULT_INNER_BITS if args.inner_bits is None
                      else args.inner_bits)
        if inner_bits < 0:
            raise SystemExit("--inner-bits must be >= 0")
        kwargs["inner_size"] = 1 << min(bits, inner_bits)
    if args.backend not in MULTI_DEVICE_BACKENDS:
        return get_hasher(args.backend, batch_size=batch,
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
    return get_hasher(args.backend, batch_per_device=batch, **kwargs)


def batch_size_for(args: argparse.Namespace) -> int:
    """Nonces per device dispatch: 2^batch-bits, or 3·2^batch-bits with
    ``--batch-3x``."""
    bits = DEFAULT_BATCH_BITS if args.batch_bits is None else args.batch_bits
    return (3 if args.batch_3x else 1) << bits


def dispatch_size(hasher: Hasher, args: argparse.Namespace) -> int:
    """The dispatcher's fixed request size: the hasher's dispatch grid
    (every shard of a sharded dispatch), else the batch."""
    return dispatch_granularity(hasher, batch_size_for(args))


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
    options select, with the telemetry they ask for (the trace is written
    after the sweep)."""
    _refuse_session_flags(args, "--bench", ())
    telemetry = setup_telemetry(args)
    try:
        hasher = make_hasher(args)
        out = run_bench(hasher, args.bench_nonces,
                        scheduler=make_scheduler(args, hasher))
        _dump_trace(telemetry, hasher)
    finally:
        telemetry.flightrec.disarm()
    return out


def cmd_bench(args: argparse.Namespace) -> int:
    out = bench(args)
    siblings = "".join(f", sibling hit version={v:#010x} nonce={n:#010x}"
                       for v, n in out["version_hits"])
    print(
        f"{out['mhs']:.2f} MH/s over {out['hashes']} hashes in "
        f"{out['seconds']:.2f}s ({out['dispatches']} dispatches, backend "
        f"{args.backend} on "
        f"{'the host CPU' if args.backend in HOST_BACKENDS else args.device}"
        f", vshare {args.vshare}"
        f"{', variant ' + args.variant if args.variant else ''}); genesis "
        f"nonce {'FOUND+VERIFIED' if out['verified'] else 'MISSED'}"
        f"{siblings}"
    )
    return 0 if out["verified"] else 2


def setup_telemetry(args: argparse.Namespace,
                    arm: bool = True) -> PipelineTelemetry:
    """The process default telemetry bundle, tracing on with
    ``--trace-out`` (which also overrides ``TPU_MINER_TELEMETRY=0``: the
    flag is the stronger signal), and with ``arm`` the flight recorder
    armed to dump to ``--flightrec-out`` on a crash or SIGUSR2 until the
    command that armed it ends. Runs before the hasher and the dispatcher
    are built, since the dispatcher keeps the bundle it finds. A session's
    builder passes ``arm=False``: :func:`run_session` arms the recorder
    for as long as the session runs, so a miner that is built and never
    run leaves no interpreter-global hook behind."""
    telemetry = get_telemetry()
    if args.trace_out:
        if not telemetry.enabled:
            telemetry = set_telemetry(
                PipelineTelemetry(trace_path=args.trace_out))
        else:
            telemetry.enable_tracing(args.trace_out)
    if arm and args.flightrec_out:
        telemetry.flightrec.arm(args.flightrec_out)
    return telemetry


def _health_interval(args: argparse.Namespace) -> float:
    return (DEFAULT_HEALTH_INTERVAL if args.health_interval is None
            else args.health_interval)


def make_health(args: argparse.Namespace, telemetry: PipelineTelemetry,
                stats, fabric=None, frontend=None
                ) -> Tuple[HealthModel, Optional[HealthWatchdog], SloEngine]:
    """The health model over ``telemetry`` and ``stats``, its watchdog
    thread, started, every ``--health-interval`` seconds (none at 0), and
    the SLO engine the watchdog ticks. The engine and the observatory
    share one time-series store, sized as the reference sizes it: SLO
    ticks land in distinct slots, both burn windows stay resolvable, and
    a series goes stale after three collections. An SLO breach captures
    an incident bundle under ``--incident-dir`` (none with ""). With a
    multi-pool ``fabric`` the engine reads each live slot's accept rate
    (``slo_slot_burn{objective,pool}``) and a bundle holds its snapshot;
    with a pool ``frontend`` (a ``StratumPoolServer``) it reads the
    claimed work of its sessions (``frontend-claimed-work``)."""
    interval = _health_interval(args)
    fast = (DEFAULT_SLO_FAST_WINDOW if args.slo_fast_window is None
            else args.slo_fast_window)
    slow = (DEFAULT_SLO_SLOW_WINDOW if args.slo_slow_window is None
            else args.slo_slow_window)
    objectives = DEFAULT_OBJECTIVES
    if args.slo_objectives:
        try:
            objectives = load_objectives(args.slo_objectives)
        except SloConfigError as e:
            raise SystemExit(f"bad --slo-objectives file: {e}")
    if fast <= 0 or slow < fast:
        raise SystemExit("--slo-fast-window must be > 0 and "
                         "--slo-slow-window >= it "
                         f"(got {fast:g}/{slow:g})")
    store = TimeSeriesStore(
        interval_s=min(1.0, fast / 8.0),
        retention_s=max(900.0, slow + fast),
        stale_after_s=max(15.0, 3.0 * interval) if interval else 15.0,
    )
    slo = SloEngine(telemetry, objectives, fast_window_s=fast,
                    slow_window_s=slow, fabric=fabric, frontend=frontend,
                    store=store)
    model = HealthModel(telemetry, stats=stats, slo=slo)
    incident_dir = (DEFAULT_INCIDENT_DIR if args.incident_dir is None
                    else args.incident_dir)
    if incident_dir:
        slo.on_breach = IncidentCapture(
            telemetry, incident_dir, stats=stats, health=model,
            fabric=fabric, slo=slo,
        ).on_breach
    watchdog = (HealthWatchdog(model, interval=interval).start()
                if interval > 0 else None)
    return model, watchdog, slo


def make_observatory(args: argparse.Namespace,
                     telemetry: PipelineTelemetry, slo: SloEngine,
                     hasher: Optional[Hasher] = None, fabric=None,
                     ) -> Optional[Observatory]:
    """The observatory's collector, started, over the SLO engine's store:
    every ``--health-interval`` seconds it samples this process's
    registry, scrapes the ``--federate`` members and, where ``hasher`` is
    a fleet, each ``--worker HOST:PORT@STATUSPORT`` worker (labels
    ``process=worker-HOST:PORT``, ``worker=HOST:PORT``), and evaluates the
    recording rules; with a multi-pool ``fabric`` it samples each slot's
    accept rate (``fabric.slot_accept_rate{pool}``). None at an interval of
    0, which runs no thread. (The reference also discovers the sharded
    pool frontend's children, which this package does not have yet.)"""
    interval = _health_interval(args)
    if interval <= 0:
        return None
    federator = ScrapeFederator(slo.store, telemetry=telemetry)
    for spec in args.federate or ():
        name, sep, url = spec.partition("=")
        if not sep or not name or not url:
            raise SystemExit(
                f"bad --federate {spec!r}: want NAME=URL "
                "(e.g. worker-1=http://127.0.0.1:18988/metrics)")
        federator.add_target(ScrapeTarget.make(name, url))
    fleet_targets = getattr(hasher, "scrape_targets", None)
    if callable(fleet_targets):
        def workers(get=fleet_targets):
            return [ScrapeTarget.make(f"worker-{label}", url,
                                      {"worker": label})
                    for label, url in get()]
        federator.add_source(workers)
    return Observatory(slo.store, telemetry, federator=federator,
                       fabric=fabric, interval_s=interval).start()


def _dump_trace(telemetry: PipelineTelemetry,
                hasher: Optional[Hasher] = None) -> None:
    """Write the ``--trace-out`` file, if tracing was asked for. With a
    served worker as the hasher, its span buffer (``CollectTrace``) is
    merged in first, so the file shows both sides of the wire under one
    trace id."""
    collect = getattr(hasher, "collect_trace", None)
    if telemetry.trace_path is not None and collect is not None:
        remote = collect()
        if remote is not None and remote.get("traceEvents"):
            from .telemetry import merge_traces
            from .telemetry.tracing import atomic_json_dump

            target = getattr(hasher, "target", "remote")
            atomic_json_dump(
                merge_traces(telemetry.tracer.trace_dict(), remote,
                             label=f"remote-hasher {target}"),
                telemetry.trace_path)
            logger.info("pipeline trace written to %s (merged %d remote "
                        "events from %s; open in Perfetto)",
                        telemetry.trace_path, len(remote["traceEvents"]),
                        target)
            return
    path = telemetry.dump_trace()
    if path is not None:
        logger.info("pipeline trace written to %s (open in Perfetto)", path)


def session_parts(miner) -> tuple:
    """``(telemetry, stats, hasher)`` of a session: its dispatcher's, or
    a pool frontend's (its internal worker's stats and hasher, or idle
    stats and None without one)."""
    dispatcher = getattr(miner, "dispatcher", None)
    if dispatcher is not None:
        return dispatcher.telemetry, dispatcher.stats, dispatcher.hasher
    return miner.server.telemetry, miner.stats, miner.hasher


async def run_session(miner, args: argparse.Namespace) -> None:
    """Run a session until it stops, with its reporter line, its health
    watchdog (which ticks the SLO engine), the observatory's collector,
    the ``--status-port`` server, the flight recorder armed to
    ``--flightrec-out`` and SIGTERM stopping it as Ctrl-C does; at the end
    the threads are stopped, the ``--trace-out`` file is written and the
    flight recorder is disarmed. A multi-pool fabric (a session's, or a
    pool frontend's upstreams') feeds the SLO engine, the incident
    bundles, the observatory, the reporter line and ``/telemetry``; a pool
    frontend's server feeds the SLO engine its claimed work."""
    telemetry, stats, hasher = session_parts(miner)
    fabric = getattr(miner, "fabric", None)
    from .utils.reporting import StatsReporter
    from .utils.status import StatusServer

    health, watchdog, slo = make_health(
        args, telemetry, stats, fabric=fabric,
        frontend=getattr(miner, "server", None))
    observatory = None
    report_task = None
    status_server = None
    loop = asyncio.get_running_loop()
    if args.flightrec_out:
        telemetry.flightrec.arm(args.flightrec_out)
    try:
        observatory = make_observatory(args, telemetry, slo, hasher=hasher,
                                       fabric=fabric)
        # The line shows health and the SLO summary only while the
        # watchdog keeps them fresh; /healthz evaluates per request
        # without one.
        reporter = StatsReporter(
            stats, args.report_interval, telemetry=telemetry,
            health=health if watchdog is not None else None,
            accounting=getattr(miner, "accounting", None),
            slo=slo if watchdog is not None else None,
            observatory=observatory, fabric=fabric)
        report_task = asyncio.create_task(reporter.run())
        if args.status_port is not None:
            status_server = StatusServer(
                stats, args.status_port, registry=telemetry.registry,
                telemetry=telemetry, health=health, slo=slo,
                tsdb=slo.store, fabric=fabric)
            try:
                await status_server.start()
            except (OSError, OverflowError, ValueError) as e:
                status_server = None
                raise SystemExit(
                    f"cannot serve --status-port {args.status_port}: {e}")
            logger.info("status endpoint on http://127.0.0.1:%d/",
                        status_server.port)
        try:
            loop.add_signal_handler(signal.SIGTERM, miner.stop)
        except (NotImplementedError, RuntimeError):  # not the main thread
            pass
        await miner.run()
    finally:
        try:
            loop.remove_signal_handler(signal.SIGTERM)
        except (NotImplementedError, RuntimeError, ValueError):
            pass
        if report_task is not None:
            report_task.cancel()
            await asyncio.gather(report_task, return_exceptions=True)
        if status_server is not None:
            await status_server.stop()
        if observatory is not None:
            observatory.stop()
        if watchdog is not None:
            watchdog.stop()
        logger.info("stopped; final: %s", stats.summary())
        _dump_trace(telemetry, hasher)
        telemetry.flightrec.disarm()


#: The options every session mode takes: the status server, the health
#: watchdog and the observatory.
LIVE_FLAGS = ("status_port", "health_interval", "slo_fast_window",
              "slo_slow_window", "slo_objectives", "incident_dir",
              "federate")

#: The session options, each with the modes that take it.
SESSION_FLAGS = (("checkpoint", ("--pool", "--gbt")),
                 ("ntime_roll", ("--pool", "--getwork")),
                 ("host_index", ("--pool",)), ("n_hosts", ("--pool",)),
                 ("suggest_difficulty", ("--pool",)),
                 ("tls_no_verify", ("--pool", "--serve-pool")),
                 ("allow_redirect", ("--pool",)),
                 *((flag, ("--pool", "--gbt", "--getwork", "--serve-hasher",
                           "--serve-pool"))
                   for flag in LIVE_FLAGS),
                 *((flag, ("--serve-pool",))
                   for flag in ("upstream", "internal_worker", "serve_vardiff",
                                *SERVE_DEFAULTS)))


def _flags_of(mode: str) -> Tuple[str, ...]:
    """The session options ``mode`` takes."""
    return tuple(flag for flag, modes in SESSION_FLAGS if mode in modes)


def _refuse_session_flags(args: argparse.Namespace, mode: str,
                          takes: Tuple[str, ...]) -> None:
    """Refuse a session option that ``mode`` would ignore."""
    for flag, modes in SESSION_FLAGS:
        val = getattr(args, flag)
        if val not in (None, False) and flag not in takes:
            raise SystemExit(
                f"--{flag.replace('_', '-')} applies only to "
                f"{', '.join(modes)}; {mode} ignores it")


def normalize_url(url: str, default_scheme: str) -> str:
    """A bare ``host:port`` with the default scheme."""
    return url if "//" in url else f"{default_scheme}://{url}"


def parse_hostport(url: str, scheme: str, default_port: int
                   ) -> Tuple[str, int]:
    parsed = urlparse(normalize_url(url, scheme))
    return parsed.hostname or "127.0.0.1", parsed.port or default_port


def _pool_args(pools: List[str]) -> List[str]:
    """The non-blank ``--pool`` values."""
    pool_args = [u.strip() for u in pools if u.strip()]
    if not pool_args:
        raise SystemExit("--pool needs at least one URL")
    return pool_args


def _is_pool_fabric(pools: List[str]) -> bool:
    """A repeated ``--pool``, or one whose first URL is not Stratum
    (``getwork+http://``, ``gbt+http://``): the multi-pool fabric."""
    pool_args = _pool_args(pools)
    first = normalize_url(pool_args[0].split(",")[0].strip(), "stratum+tcp")
    return len(pool_args) > 1 or urlparse(first).scheme not in (
        "stratum+tcp", "stratum+ssl")


def _pool_endpoints(pools: List[str]) -> Tuple[List[Tuple[str, int]], bool]:
    """The one-pool ``--pool`` endpoints, primary first, and whether they
    use TLS."""
    pool_args = _pool_args(pools)
    urls = [u.strip() for u in pool_args[0].split(",") if u.strip()]
    schemes = {urlparse(normalize_url(u, "stratum+tcp")).scheme for u in urls}
    if not schemes <= {"stratum+tcp", "stratum+ssl"}:
        raise SystemExit(f"--pool URLs must be stratum+tcp:// or "
                         f"stratum+ssl://, got {sorted(schemes)}")
    if len(schemes) > 1:
        raise SystemExit("--pool failover URLs must all share one scheme "
                         "(stratum+tcp or stratum+ssl)")
    try:
        endpoints = [parse_hostport(u, "stratum+tcp", 3333) for u in urls]
    except ValueError as e:
        raise SystemExit(f"bad --pool URL: {e}")
    return endpoints, schemes == {"stratum+ssl"}


def _checkpoint(args: argparse.Namespace):
    if not args.checkpoint:
        return None
    from .utils.checkpoint import SweepCheckpoint

    return SweepCheckpoint(args.checkpoint)


def make_miner(args: argparse.Namespace
               ) -> "Union[StratumMiner, MultipoolMiner]":
    """The ``--pool`` session the options select: one pool's
    ``StratumMiner``, or the multi-pool fabric's ``MultipoolMiner``
    (:func:`make_fabric_miner`)."""
    from .miner.runner import StratumMiner
    from .parallel.ranges import partition_extranonce2_space

    if _is_pool_fabric(args.pool):
        return make_fabric_miner(args)
    _refuse_session_flags(args, "--pool", _flags_of("--pool"))
    endpoints, use_tls = _pool_endpoints(args.pool)
    host_index = 0 if args.host_index is None else args.host_index
    n_hosts = 1 if args.n_hosts is None else args.n_hosts
    try:
        e2_start, _space, e2_step = partition_extranonce2_space(
            4, host_index, n_hosts)
    except ValueError as e:
        raise SystemExit(str(e))
    if args.suggest_difficulty is not None and args.suggest_difficulty <= 0:
        raise SystemExit("--suggest-difficulty must be > 0")
    setup_telemetry(args, arm=False)
    hasher = make_hasher(args)
    (host, port), failover = endpoints[0], endpoints[1:]
    miner = StratumMiner(
        host, port, args.user, args.password, hasher=hasher,
        n_workers=args.workers,
        batch_size=dispatch_size(hasher, args),
        extranonce2_start=e2_start,
        extranonce2_step=e2_step,
        allow_redirect=args.allow_redirect,
        ntime_roll=args.ntime_roll or 0,
        suggest_difficulty=args.suggest_difficulty,
        failover=failover,
        use_tls=use_tls,
        tls_verify=not args.tls_no_verify,
        stream_depth=args.stream_depth,
        scheduler=make_scheduler(args, hasher),
    )
    miner.dispatcher.checkpoint = _checkpoint(args)
    return miner


def make_fabric_miner(args: argparse.Namespace) -> "MultipoolMiner":
    """The multi-pool fabric the ``--pool`` URLs select (one per flag,
    ``#w=N`` weights): one dispatcher on the options' hasher, with the
    one-pool session's dispatcher options, its pools' sessions routed by
    the fabric's defaults (10 s quanta, 10 s stall bound, 10 s request
    timeout). ``--checkpoint`` is refused (sweep identity is per pool),
    and so is ``--allow-redirect``, which the fabric's sessions would
    ignore."""
    from .miner.multipool import MultipoolMiner, parse_pool_spec
    from .parallel.ranges import partition_extranonce2_space

    specs = []
    for url in _pool_args(args.pool):
        if "," in url:
            raise SystemExit(
                "with repeatable --pool, give one URL per flag (commas "
                "are the single-pool cold-failover syntax)")
        try:
            specs.append(parse_pool_spec(url))
        except ValueError as e:
            raise SystemExit(f"bad --pool URL: {e}")
    if args.suggest_difficulty is not None and args.suggest_difficulty <= 0:
        raise SystemExit("--suggest-difficulty must be > 0")
    if args.checkpoint:
        raise SystemExit(
            "--checkpoint is not supported with the multi-pool fabric "
            "(sweep identity is per-pool; in-memory resume still applies)")
    _refuse_session_flags(args, "the multi-pool fabric",
                          tuple(f for f in _flags_of("--pool")
                                if f != "allow_redirect"))
    host_index = 0 if args.host_index is None else args.host_index
    n_hosts = 1 if args.n_hosts is None else args.n_hosts
    try:
        e2_start, _space, e2_step = partition_extranonce2_space(
            4, host_index, n_hosts)
    except ValueError as e:
        raise SystemExit(str(e))
    setup_telemetry(args, arm=False)
    hasher = make_hasher(args)
    return MultipoolMiner(
        specs, username=args.user, password=args.password, hasher=hasher,
        n_workers=args.workers,
        batch_size=dispatch_size(hasher, args),
        scheduler=make_scheduler(args, hasher),
        stream_depth=args.stream_depth,
        extranonce2_start=e2_start,
        extranonce2_step=e2_step,
        ntime_roll=args.ntime_roll or 0,
        suggest_difficulty=args.suggest_difficulty,
        tls_verify=not args.tls_no_verify,
    )


def make_gbt_miner(args: argparse.Namespace) -> "GbtMiner":
    """The ``--gbt`` session the options select."""
    from .miner.runner import GbtMiner

    _refuse_session_flags(args, "--gbt", ("checkpoint", *LIVE_FLAGS))
    setup_telemetry(args, arm=False)
    hasher = make_hasher(args)
    miner = GbtMiner(
        args.gbt, args.user, args.password, hasher=hasher,
        n_workers=args.workers,
        batch_size=dispatch_size(hasher, args),
        stream_depth=args.stream_depth,
        scheduler=make_scheduler(args, hasher),
    )
    miner.dispatcher.checkpoint = _checkpoint(args)
    return miner


def make_getwork_miner(args: argparse.Namespace) -> "GetworkMiner":
    """The ``--getwork`` session the options select: ntime rolls 600 s
    unless ``--ntime-roll`` says otherwise."""
    from .miner.runner import GetworkMiner

    _refuse_session_flags(args, "--getwork", ("ntime_roll", *LIVE_FLAGS))
    setup_telemetry(args, arm=False)
    hasher = make_hasher(args)
    return GetworkMiner(
        args.getwork, args.user, args.password, hasher=hasher,
        n_workers=args.workers,
        batch_size=dispatch_size(hasher, args),
        ntime_roll=600 if args.ntime_roll is None else args.ntime_roll,
        stream_depth=args.stream_depth,
        scheduler=make_scheduler(args, hasher),
    )


def cmd_serve_hasher(args: argparse.Namespace) -> int:
    """``--serve-hasher HOST:PORT``: serve ``make_hasher(args)`` until
    SIGTERM or Ctrl-C. The worker records spans by default (a bounded
    buffer that each ``CollectTrace`` drains), so a miner's ``--trace-out``
    takes them without a flag here; ``TPU_MINER_TELEMETRY=0`` still
    compiles them out. ``--status-port`` serves the worker's ``/healthz``,
    ``/metrics``, ``/trace``, ``/flightrec``, ``/slo`` and ``/query`` from
    its own thread (the gRPC server is synchronous), with a local
    observatory: a leaf whose ``/query`` serves the worker's own history
    and whose ``/metrics`` a miner's federator scrapes when it names the
    port as ``--worker HOST:PORT@STATUSPORT``. Its threads stop, and its
    flight recorder is disarmed, with the server."""
    _refuse_session_flags(args, "--serve-hasher", LIVE_FLAGS)
    service = _hasher_service()
    telemetry = setup_telemetry(args)
    telemetry.enable_tracing()
    server, port = service.serve(make_hasher(args), args.serve_hasher)
    if not port:
        server.stop(grace=0)
        raise SystemExit(f"cannot serve --serve-hasher {args.serve_hasher}")
    logger.info("hasher service listening on %d (ctrl-c to stop)", port)
    stop_status = watchdog = observatory = None
    try:
        if args.status_port is not None:
            from .miner.dispatcher import MinerStats
            from .utils.status import StatusServer, serve_status_in_thread

            stats = MinerStats(telemetry=telemetry)
            health, watchdog, slo = make_health(args, telemetry, stats)
            observatory = make_observatory(args, telemetry, slo)
            status_server = StatusServer(
                stats, args.status_port, registry=telemetry.registry,
                telemetry=telemetry, health=health, slo=slo,
                tsdb=slo.store)
            try:
                stop_status = serve_status_in_thread(status_server)
            except (OSError, OverflowError, ValueError) as e:
                raise SystemExit(
                    f"cannot serve --status-port {args.status_port}: {e}")
            logger.info("status endpoint on http://127.0.0.1:%d/",
                        status_server.port)
        # SIGTERM stops the server as Ctrl-C does, and the trace is
        # written.
        try:
            signal.signal(signal.SIGTERM, lambda *_: server.stop(grace=1.0))
        except (ValueError, OSError):  # not the main thread
            pass
        try:
            server.wait_for_termination()
        except KeyboardInterrupt:
            pass
    finally:
        server.stop(grace=1.0)
        if observatory is not None:
            observatory.stop()
        if watchdog is not None:
            watchdog.stop()
        if stop_status is not None:
            stop_status()
        telemetry.flightrec.disarm()
    _dump_trace(telemetry)
    return 0


def _serve_option(args: argparse.Namespace, flag: str):
    val = getattr(args, flag)
    return SERVE_DEFAULTS[flag] if val is None else val


def make_frontend(args: argparse.Namespace) -> "PoolFrontend":
    """The ``--serve-pool`` frontend the options select: a
    ``StratumPoolServer`` (the native validator when the library builds,
    else the hashlib oracle), its job source (local templates, one
    ``--upstream``'s ``UpstreamProxy``, or several through the multi-pool
    fabric's ``FabricUpstreamProxy``) and, with ``--internal-worker``, an
    ``InternalWorker`` on ``make_hasher(args)``: on the card unless
    ``--device cpu`` (or a host backend) says otherwise."""
    from .poolserver import (
        FabricUpstreamProxy,
        InternalWorker,
        LocalTemplateSource,
        PoolFrontend,
        StratumPoolServer,
        UpstreamProxy,
    )

    _refuse_session_flags(args, "--serve-pool", _flags_of("--serve-pool"))
    if _serve_option(args, "serve_shards") > 1:
        raise SystemExit("--serve-shards: the sharded pool frontend is not "
                         "ported yet; run one process (omit the flag)")
    try:
        # Port 0 binds an ephemeral port (the log and server.port say
        # which); no port is 3334.
        parsed = urlparse(normalize_url(args.serve_pool, "stratum+tcp"))
        host = parsed.hostname or "127.0.0.1"
        port = 3334 if parsed.port is None else parsed.port
    except ValueError as e:
        raise SystemExit(f"bad --serve-pool address: {e}")
    difficulty = _serve_option(args, "serve_difficulty")
    if difficulty <= 0:
        raise SystemExit("--serve-difficulty must be > 0")
    if args.serve_vardiff is not None and args.serve_vardiff <= 0:
        raise SystemExit("--serve-vardiff must be > 0 shares/minute")
    telemetry = setup_telemetry(args, arm=False)
    # The hasher first: without a card (and without --device cpu) the
    # frontend must fail before it binds anything.
    hasher = make_hasher(args) if args.internal_worker else None
    try:
        server = StratumPoolServer(
            extranonce2_size=_serve_option(args, "serve_extranonce2_size"),
            prefix_bytes=_serve_option(args, "serve_prefix_bytes"),
            difficulty=difficulty,
            telemetry=telemetry,
            vardiff_interval_s=(
                _serve_option(args, "serve_vardiff_interval")
                if args.serve_vardiff is not None else 0.0),
            vardiff_target_spm=args.serve_vardiff or 6.0,
        )
    except ValueError as e:
        raise SystemExit(str(e))
    proxy = None
    local_source = None
    upstreams = [u.strip() for u in args.upstream or () if u.strip()]
    if len(upstreams) > 1:
        from .miner.multipool import PoolFabric, parse_pool_spec

        specs = []
        for url in upstreams:
            try:
                spec = parse_pool_spec(url)
            except ValueError as e:
                raise SystemExit(f"bad --upstream URL: {e}")
            if spec.kind != "stratum":
                raise SystemExit(
                    "multi-upstream proxy mode needs stratum+tcp:// or "
                    f"stratum+ssl:// URLs, got {url!r}")
            specs.append(spec)
        fabric = PoolFabric(
            specs, username=args.user, password=args.password,
            telemetry=telemetry, tls_verify=not args.tls_no_verify,
        )
        proxy = FabricUpstreamProxy(server, fabric)
    elif upstreams:
        from .protocol.stratum import StratumClient

        scheme = urlparse(normalize_url(upstreams[0], "stratum+tcp")).scheme
        if scheme not in ("stratum+tcp", "stratum+ssl"):
            raise SystemExit(f"--upstream must be stratum+tcp:// or "
                             f"stratum+ssl://, got {scheme}")
        try:
            up_host, up_port = parse_hostport(upstreams[0], "stratum+tcp",
                                              3333)
        except ValueError as e:
            raise SystemExit(f"bad --upstream URL: {e}")
        proxy = UpstreamProxy(server, StratumClient(
            up_host, up_port, args.user, args.password,
            use_tls=scheme == "stratum+ssl",
            tls_verify=not args.tls_no_verify,
        ))
    else:
        local_source = LocalTemplateSource()
    internal = None
    if hasher is not None:
        internal = InternalWorker(
            server, hasher,
            n_workers=args.workers,
            stream_depth=args.stream_depth,
            scheduler=make_scheduler(args, hasher),
            batch_size=dispatch_size(hasher, args),
        )
    return PoolFrontend(
        server, host, port,
        proxy=proxy,
        local_source=local_source,
        job_interval_s=_serve_option(args, "serve_job_interval"),
        internal_worker=internal,
    )


def cmd_session(miner, args: argparse.Namespace) -> int:
    try:
        asyncio.run(run_session(miner, args))
    except KeyboardInterrupt:
        logger.info("interrupted; final: %s",
                    session_parts(miner)[1].summary())
    return 0


#: Subcommands, given as the first argument: each operates on evidence
#: files or a status surface, not a backend, so no mining flag applies.
SUBCOMMANDS = {
    "perf": ("perf_cli", "main"),
    "slo": ("telemetry.slo", "main"),
    "top": ("telemetry.dashboard", "top_main"),
}


def main(argv: Optional[list] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in SUBCOMMANDS:
        import importlib

        module, func = SUBCOMMANDS[argv[0]]
        return getattr(importlib.import_module(f".{module}", __package__),
                       func)(argv[1:])
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
        datefmt="%H:%M:%S",
    )
    if args.bench:
        return cmd_bench(args)
    if args.serve_hasher:
        return cmd_serve_hasher(args)
    if args.gbt:
        return cmd_session(make_gbt_miner(args), args)
    if args.getwork:
        return cmd_session(make_getwork_miner(args), args)
    if args.serve_pool:
        return cmd_session(make_frontend(args), args)
    return cmd_session(make_miner(args), args)
