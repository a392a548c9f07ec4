#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA miner on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit and builds the kernels from
   ``bitcoin_miner_tpu_torch/ops/csrc`` (one nvcc per library, all at
   once: each source per number of version-rolled chains K = 1..8, and the
   tile kernel's layouts it drives), printing ptxas' registers, spills and
   shared memory, the SASS shared-memory stores and loads, and the blocks
   per SM of every tile library;
1b. runs miner-lint as a gate runs it, ``python -m bitcoin_miner_tpu_torch
   lint --json --baseline bitcoin_miner_tpu_torch/analysis/
   lint_baseline.json`` in a child from the checkout's root (host work
   only; ``miner_lint``): rc 0, no finding beyond the empty baseline,
   more than 50 files scanned, the 16 rules of ``--list-rules``, and, in
   a second child running the same lint, neither torch nor jax loaded
   (the lint's own ``device-claiming-import`` holds the port's boundary:
   no file of the package or of these scripts imports jax or the JAX
   package);
2. holds every kernel against its plain PyTorch version on the card at the
   main path's shapes (2^24-nonce dispatches, the genesis job, a limit
   that cuts a step, a base near 2^32, a hit-buffer overflow), the tile
   scan at K = 1, 2, 3, 4, 8, the hit-buffer scan at K = 1, 2, 4 and the
   tile hasher's batched rescan ``rescan_steps`` at 1 slot (the genesis
   step), the ~1200 candidate steps of an easy 2^24 dispatch (K = 1, 2)
   and the 2048 of a regtest one — exact equality, since every output is
   an integer (the hit-buffer scan merges its block slots in its own last
   block: its outputs are the merged buffers); then the tile kernel's
   layouts (regchain, wsplit, wstage,
   vroll, vroll-db at K = 1, 2, 4, 8; chain passes of 2 at K = 4; two
   nonces in flight at K = 2; steps of 128 and 256 nonces) against the
   same plain version;
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
   2`` over 2^26 nonces (the K=2 hit-buffer kernels), and at K=1;
6. mines a Stratum session as ``--pool URL --workers 4 --vshare 2``
   against a mock pool that grants the mask 0x1FFFE000: it needs ≥3
   accepted sibling shares (version bits other than the job's own) and ≥3
   of chain 0, then mines a fixed window whose rate counts K=2 launches ×
   2^24 × 2 hashes; and the same miner against a pool that grants no mask,
   which must degrade to chain 0 and launch only K=1 kernels;
7. sweeps the genesis nonce space with each layout (``--variant``) at K=1
   and at ``--vshare 2``, each finding and verifying 2083236893 and, at
   K=2, the sibling hit the baseline finds; mines the ``--vshare 2
   --variant vroll`` session and its degraded twin as in 6; scans 2^26
   nonces through ``TileCudaHasher`` at an easy target (~2^-12 per nonce)
   and at regtest's (``easy_target_scan``): the rate, ``rescan_steps``
   launches per dispatch, and the same hits as ``CudaHasher``'s; mines a
   getblocktemplate session as ``--gbt URL --workers 8`` against the
   package's fake node at regtest's nbits, which takes each accepted block
   as its new tip (≥3 blocks on 3 tips, none rejected; ``gbt_session``),
   a getwork session as ``--getwork URL --workers 4`` at difficulty 1 (3
   solves accepted, 2 at a rolled ntime; ``getwork_session``), a Stratum
   session as ``--pool DEAD,LIVE --host-index 1 --n-hosts 2
   --suggest-difficulty 0.00390625 --checkpoint PATH`` (the rotation, odd
   extranonce2 only, the suggested difficulty, a resume from the file;
   ``stratum_session_failover``), and the genesis sweep as ``--bench
   --batch-3x --sublanes 24`` (86 dispatches of 3·2^24 nonces, the last
   cut by its limit; ``genesis_sweep_batch3x``); the GBT session serves
   ``/healthz``, which must answer 200 after the first block;
7b. mines a Stratum session with its telemetry on, built by
   ``cli.make_miner`` and run by ``cli.run_session`` as ``--pool URL
   --workers 4 --status-port P --trace-out T --flightrec-out F
   --health-interval 1`` (``stratum_session_telemetry``): ``/trace``,
   ``/flightrec`` (with the job switch), ``/healthz`` (200, device and
   ring ok) and ``/metrics`` (the busy clock's gap after the job ran out,
   ring collects, constants-cache hits, ≥ 3 accepted verdicts) answer
   mid-session, and the trace written at the stop holds one
   ``device_dispatch`` and one ``ring_collect`` span per dispatch
   collected, one ``submit`` span and ``pool_ack`` instant per verdict and
   one ``cpu_verify`` span per verified hit; then sweeps the genesis nonce
   space with telemetry off, on and tracing, twice each
   (``telemetry_overhead``, rates recorded, not gated);
7c. the observatory: ``Dispatcher.sweep`` on ``cuda-tile`` and ``cuda``
   over 2^28 genesis nonces in 2^24-nonce requests (exactly the genesis
   share, 16 scan launches, the busy clock closed and the ring given back
   after a ``max_shares=1`` cut; ``dispatcher_sweep``); the telemetry
   session with ``--slo-fast-window 4 --slo-slow-window 12
   --slo-objectives F --incident-dir D``, F holding a latency objective
   no submit meets: ``/slo`` breached, ``/healthz`` ``slo`` degraded,
   ``/query``'s ``scan_batch`` series, ``top --once``, ``slo
   --status-url`` exiting 1, one incident bundle and its ledger row
   (``stratum_session_observatory``); the ``perf`` subcommand's proxy,
   record (the card in the fingerprint), report, gate and a capture
   refusing an option it sets itself (``perf_cli_roundtrip``); the bench
   as a user runs it, ``python -m bitcoin_miner_tpu_torch.bench`` in a
   child: one JSON line with rc 0 on the card (``cuda-tile``, the card's
   name, the genesis nonce verified, 256 tile launches, a pipeline block)
   and, at the same time, with the card hidden: rc 1 and ``value`` 0, no
   host backend's number (``bench_json``); ``perf capture`` of the default
   bench: a manifest without errors keyed to its ledger row, and the
   trace report of ``torch.profiler``'s trace counting the bench's
   ``scan_tile`` and ``rescan_steps`` launches, with the card's busy share
   and its longest gaps labelled with what the host did (``perf_capture``);
   and, with grpcio, a served worker with
   ``--status-port`` mined through by a parent session naming it
   ``--worker HOST:PORT@STATUSPORT``, whose ``/query`` must hold the
   worker's series (``served_worker_federation``);
7d. the multi-pool fabric, built by ``cli.make_miner`` and run by
   ``cli.run_session`` as ``--pool stratum+tcp://A#w=3 --pool
   stratum+tcp://B --pool gbt+http://N --workers 4 --status-port P
   --health-interval 1`` with the routing defaults (10 s quanta, stall
   bound and request timeout): two chaos pools at difficulty 1 and the
   fake node at regtest's nbits; after 5 s A goes mute (a half-open
   socket) wherever the dispatcher is and the session mines 10 s more,
   printing what that leads to (A's state, failovers, seconds without a
   launch); then a second session in which A goes mute once it owns the
   dispatcher with its shares flowing and keeps it for the next quantum.
   Every share each pool's validator saw is valid, no block is refused
   but for a stale tip, the second mute ends in a ``pool_failover`` and
   A degraded, ``/healthz`` and ``/telemetry`` show the fabric; it prints
   the seconds from each mute to the next slot's generation, the card's
   rate before and after each mute, its seconds without a launch, and
   the share of requests dropped as stale (``fabric_session``). Then two
   pools with ``--vshare 2``: A grants 0x1FFFE000, B no mask, so each
   route switch moves the hasher between the K=2 tile kernel and its
   degraded K=1 build (``fabric_session_vshare``);
7e. the native CPU oracle and the pool frontend (``native_oracle``): the
   package's C++ library built with g++ on the card's host (seconds,
   SHA-NI or scalar), ``NativeCpuHasher.scan`` over 4096 nonces around
   the genesis nonce equal to the ``cpu`` hasher's, 2^24 nonces with the
   genesis nonce found (the host CPU's rate, not the card's), and 2000
   seeded submits with the same verdicts from the frontend's hashlib and
   native validators; then ``--serve-pool 127.0.0.1:0 --internal-worker
   --serve-difficulty 0.00390625 --serve-job-interval 5 --workers 4
   --status-port P`` through ``cli.run_session`` (local templates, the
   tile kernel on the card): ≥ 100 shares accepted by its own frontend
   over a 10 s window, none invalid, no hardware error, the native
   validator in force; its rate against ``stratum_session_telemetry``'s,
   the validation quantiles, ``/healthz``'s ``frontend`` component and
   the three frontend objectives of ``/slo``; then 256 downstream
   sessions each submitting a junk share a second for 10 s: the job
   broadcast's p99 and the internal rate under that load
   (``frontend_internal_worker``); the mock pool ← ``--upstream``
   frontend with its internal worker ← a downstream ``StratumMiner`` on
   the same card, 5 s: every share valid at the pool, its accepted
   count equal to the proxy's forwards and upstream accepts, the two
   prefixes disjoint, both rates and their sum against the single
   session's (``frontend_proxy_session``); two mock pools behind the
   fabric proxy (``--upstream A --upstream B``) with the internal worker:
   every share reaches the pool that announced its job, each pool gets a
   valid share (``frontend_fabric_proxy``);
7f. the sharded pool frontend, started as a user starts it, ``python -m
   bitcoin_miner_tpu_torch --serve-pool 127.0.0.1:PORT --serve-shards 2
   --serve-difficulty 0.00390625 --status-port S`` (two acceptor
   processes on one ``SO_REUSEPORT`` port, local templates, each child
   probing the native validator), mined by one ``cuda-tile`` miner as
   ``--pool stratum+tcp://127.0.0.1:PORT --workers 4`` builds it, for
   5 s: its rate against ``stratum_session_telemetry``'s, the verdicts
   of each shard (accepted equal to the miner's with its submits held
   until none is in flight, none invalid or duplicate), its extranonce1 inside its shard's prefix range,
   ``/healthz``'s ``frontend_shard`` ok, the parent's ``/metrics`` with
   both shards' samples and no series twice, and each child's validator
   (native wherever this process loads the library;
   ``frontend_shards_session``); in the same session the shard holding
   the miner is SIGKILLed: its gauge ``down`` within a liveness tick,
   ``/healthz`` DEGRADED and never 503, the respawn at the identical
   prefix range with a new pid and ``restarts`` 1, the seconds from the
   kill to the miner's next accepted share (a new session, in its
   shard's range) and the card's idle seconds in them, no share accepted
   twice (no header twice among the accepted, no verdict but accepted or
   stale, and the frontend's accepts since the kill the miner's but for
   the submits in flight at it; ``frontend_shard_kill``); then the load probe (``python -m
   bitcoin_miner_tpu_torch.probes.load_probe --connect``, 4 processes,
   512 sessions, 15 submits each at difficulty 1e-12) against one
   process and against 4 shards: validated shares a second (all
   the probes' shares over the union of their submit windows), the
   sessions per shard, every extranonce1 unique and no share invalid,
   and the CPU share of the probes and of each acceptor beside
   ``os.cpu_count()`` (``frontend_shards_load``);
8. holds the scans' fused ``lowest`` output (the sharded scans' minimum,
   folded into the scan's last block) against the plain scan and
   ``shard_min_plain``: the tile scan at K = 1, 2, 4, 8 in the baseline and
   vroll, the hit-buffer scan at K = 1, 2, 4, at 2^24 nonces, over the
   cases of 2 and a limit of 0; and each compile form (``--unroll`` 8, 16,
   32 and ``--no-spec``) of the tile kernel at K = 1, 2, of the hit-buffer
   kernel at K = 1 and of ``rescan_steps`` against the plain versions of 2;
   sweeps 2^28 genesis nonces through ``cli.bench`` in each form;
9. shards: over every card when there are two or more, else over the one
   card named four times (printed first). A 4-shard ``ShardedScan`` (tile
   at K = 1, 2; hit buffer) against one device's scan of the same 2^26
   range, whole and ending inside shard 1; the genesis sweep of all 2^32
   nonces through ``cuda-tile-mesh`` at 2^24 nonces per shard, K = 1 and
   ``--vshare 2`` (the solve and the sibling hit), and through
   ``cuda-fanout``; a Stratum session on ``cuda-mesh-native --mesh-kernel
   cuda-tile --workers 4``; the mesh-native degradation ladder
   (quarantine → fan-out → rebuild → restore) with parity at each rung;
10. holds the int32 throughput probe (``ops/int_probe.py``) at ILP 1, 2,
   4, 8, 16 against its plain version at the reference's size (4096 steps
   of 4096 groups; every step's tile exact), then runs it as ``python -m
   bitcoin_miner_tpu_torch.probes.int_probe`` does (``probes.int_probe.
   main``): CUDA-event times, the SM clock sampled meanwhile, the SASS of
   its group loop per pipe and the measured lanes per SM and clock;
11. times each kernel with CUDA events beside its plain version and its
   bound: the tile scan in every layout, form and K it drives (at K = 1,
   2 also with ``lowest``), the hit-buffer scan (with ``lowest``, and its
   last block's merge over the 2^19 block slots of a 2^32-nonce scan),
   ``rescan_steps`` at the sizes of 2; beside the scan
   kernels' operation bound, their SASS per nonce per pipe (the nonce loop
   of ``scan_tile``, ``scan_tile_k2`` and ``scan_hitbuf``, against
   ``ops_per_nonce``) and the bound of those instructions at the same peak
   rates (``sass_bound_ms``).

12. runs the bulk parity gate (``probes.parity.run_gate``) in this
   process at 2^20 hashes a leg: the ``scan`` hit sets of ``CudaHasher``
   and ``TileCudaHasher`` (every layout and compile form at K=1) against
   the native oracle at target 2^248, the hit-buffer kernel's and the tile
   kernel's word7 candidates against hashlib, and the sibling chains at K
   = 2, 4, 8 in every layout built there; zero mismatches, every library
   it names launched (``bulk_parity``); ranks the layouts with ``python
   -m bitcoin_miner_tpu_torch frontier`` on the card (≥ 20 candidates,
   nvcc's ptxas and SASS, the top 10), times its top 3 through the
   tuner's worker over 2^28 genesis nonces, each finding the nonce, and
   prints the rank correlation of its predictions with ``timings``' times
   at K = 1, 2, 4, 8 and the model's constants fitted to them
   (``layout_frontier``); runs ``python -m bitcoin_miner_tpu_torch.
   probes.tune --limit 4`` at 2^26 nonces in its child processes, every
   row ok (``tune_sweep``). The gate's and the ranker's launches check
   kernels: they are not the main path's and are not counted there.
13. runs the BASELINE matrix runner (``probes.run.main``, the counterpart
   of ``benchmarks/run.py``) in this process at full size, twice: on
   ``cuda-tile`` and on ``cuda --inner-bits 14``. Each run passes all
   five configurations (the genesis digest, a 2^20-nonce sweep finding
   the genesis nonce, a 2^18-nonce scan equal to the native oracle's, a
   regtest GBT session with an accepted block, a Stratum session with 3
   accepted version-rolled shares) with a scan kernel launched in each of
   configurations 2 to 5, and prints each configuration's seconds and
   launches (``baseline_matrix``).

With ``--mesh-only`` it builds the baseline libraries and runs the
single-device sweeps of 3 and 5 and the multi-device phases of 9 alone
(on a machine with several cards, where the shards are the cards).
With ``--phases NAME[,NAME...]`` it runs ``device_and_build`` and the
named phases (:data:`PHASES`) in the smoke's order, with every phase
they need (:data:`PHASE_NEEDS`: ``timings`` the phases whose plain
versions it times, ``layout_frontier`` ``timings``), the same checks and
the same last line; the main path's never-launched check and the kernel
table need every phase and are left out. An unknown name exits 2 with
the list of phases. Before its last lines every run prints its seconds
against its 1200 s budget and its five longest phases
(``smoke_seconds``, ``budget_s``, ``longest``).

Phases 3 to 7f (but for the load probe, host work with no kernel), 9's
sweeps, session and ladder, 10's probe run and 13's matrix are the main
path (the
sharded frontend's kill is counted in its session's phase): the launch counts are set to 0 just before each and read just
after, and each kernel must have launched. The bench's children count
their own launches over the timed sweep and print them (``launches``),
which ``bench_json`` checks and the trace report of ``perf_capture``
confirms; the kernel table does not add them. No tile hasher launches the
hit-buffer kernel there: its rescans are ``rescan_steps``. Each dispatch
is one scan launch per shard (per dispatch on one card), with no launch
after it: the scans' last blocks merge the hit buffers and take each
shard's minimum, and no kernel of :data:`REMOVED_KERNELS` may be built or
counted.
Every phase's flight-recorder dump path (written on a crash or SIGUSR2
only) and traces are in a temporary directory (``TMPDIR`` chooses where;
the telemetry phases print it), never the command line's default dump
path, a file the checkout tracks; so are every session's incident bundles
and every perf ledger. Every phase prints a JSON line; the kernel table and the card
follow, and
the last line is ``{"ok": true, "device": {...}}``. Without a card, without
the package beside it, or when any phase fails, it exits non-zero and
prints no result; each failed phase, with its error, is then also the
last thing on standard error.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import ctypes
import functools
import importlib.util
import io
import json
import os
import re
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

GENESIS_NONCE = 2083236893
DISPATCH = 1 << 24
#: 2^24-nonce scans queued ahead of every 20 timed launches (~2.4 ms each,
#: so ~1 ms of card work per launch the host has to queue meanwhile).
BLOCKER_SCANS = 8
SESSION_WINDOW_S = 5.0  # the Stratum sessions' measured window
SWEEP_MHS_PR2 = 6823.0  # one-chain genesis sweep, H100 80GB HBM3 at 700 W
VERSION_MASK = 0x1FFFE000  # the full BIP 310 mask the vshare pool grants
SIBLING_HIT = (0x00002001, 2209238384)  # the genesis sibling at --vshare 2
SMEM_BYTES_PER_CLOCK = 128  # shared memory per SM and clock: 32 banks x 4 B
#: The compile forms driven: (unroll, spec); below 64 spec does not apply.
FORMS = ((8, True), (16, True), (32, True), (64, False))
SHARDS_ON_ONE_CARD = 4
#: fleet_sweep_reclaim: children on the one card, nonces per dispatch (the
#: CLI's default) and nonces swept (64 requests: room for a death, a probe
#: and a rejoin).
FLEET_CHILDREN = 3
FLEET_DISPATCH = DISPATCH
FLEET_SWEEP = 1 << 30
#: dispatcher_sweep: nonces per ``Dispatcher.sweep`` (16 requests), and
#: the warm sweeps per backend after the first: one ~40 ms sweep is too
#: short to read alone, so the rate is their median, with their spread.
OBS_SWEEP = 1 << 28
OBS_SWEEP_WARM = 7
#: stratum_session_observatory: the SLO engine's windows (seconds) and the
#: objective the session must breach: 99% of submit round trips within
#: 1 µs (the first bucket bound at or above it, 10 µs, counts as good; a
#: local round trip takes milliseconds).
OBS_FAST_WINDOW, OBS_SLOW_WINDOW = 4, 12
#: fabric_session: the chaos pools' share difficulty (~1.5 shares a second
#: at the card's rate, a share or none per request, so a worker parked on
#: the muted pool holds one), seconds mined after pool A's first accepted
#: share before A goes mute (a first quantum of the GBT slot can outlast
#: these seconds, and a mute of A before A served measures nothing), the
#: most seconds to wait after that (in the session that is held to a
#: failover) for a moment A's shares flow and A keeps the dispatcher for
#: the next 10 s quantum (so that A still owns it when the 10 s stall
#: bound passes: a stall is a failover only for the slot that owns the
#: dispatcher, and after a GBT quantum at regtest A's shares take ~20 s
#: to flow), and seconds mined after the mute (at least: the session held
#: to a failover mines on until it happens, ~17 s after the mute);
#: fabric_session_vshare's seconds (at least: it mines on until each slot
#: has owned the dispatcher). These fixed windows were 25 s, 30 s and 20 s
#: until the smoke took the bulk parity gate, the ranker and the tuner
#: into its time limit.
FABRIC_DIFFICULTY = 1.0
FABRIC_PRE_MUTE_S = 5.0
FABRIC_WAIT_ACTIVE_S = 120.0
FABRIC_POST_MUTE_S = 10.0
FABRIC_VSHARE_S = 10.0
OBS_OBJECTIVES = {"schema": "tpu-miner-slo-objectives/1", "objectives": [
    {"name": "submit-rtt-1us", "kind": "latency", "target": 0.99,
     "threshold_s": 1e-6, "signal": "tpu_miner_submit_rtt_seconds",
     "description": "a bound no round trip meets"}]}
PROBE_STEPS = PROBE_GROUPS = 4096  # the int32 probe's reference size
#: Kernels folded into the scans' last blocks: none may be built or counted.
REMOVED_KERNELS = ("shard_min", "hitbuf_compact")
#: The pool frontend's phases: the share difficulty (~390 shares a second
#: at the card's rate), the internal worker's measured window, the
#: downstream sessions that load the event loop and for how long, the
#: proxy sessions' window, and the seeded submits held against both
#: validators. The two windows were 20 s and 10 s until the smoke took
#: the bulk parity gate, the ranker and the tuner into its time limit.
FRONTEND_DIFFICULTY = 1 / 256
FRONTEND_WINDOW_S = 10.0
FRONTEND_CLIENTS = 256
FRONTEND_LOAD_S = 10
FRONTEND_PROXY_S = 5.0
NATIVE_SUBMITS = 2000
#: The sharded frontend's phases: the shards of the card-mined session and
#: its measured window; the load probe's shard counts, its sessions split
#: over its processes, each session's submits (enough that every process
#: submits for seconds, so that the processes' rates overlap and sum) at
#: a difficulty every hash meets. The window was 10 s, and 25 submits a
#: session, until the smoke took the bulk parity gate, the ranker and the
#: tuner into its time limit (fewer submits weigh the sessions' set-up
#: more: the shares a second read lower).
SHARDS = 2
SHARD_WINDOW_S = 5.0
SHARD_LOAD_COUNTS = (1, 4)
SHARD_LOAD_SESSIONS = 512
SHARD_LOAD_PROBES = 4
SHARD_LOAD_SHARES = 15
SHARD_LOAD_DIFFICULTY = 1e-12
#: ntime passes of the telemetry session's job: (NTIME_ROLL + 1) × 2^32
#: nonces, ~10 s at the session's rate, outlast the 3 shares and the
#: window; the job then runs out and the pool's next one comes
#: JOB_PAUSE_S later, a real gap of the busy clock.
NTIME_ROLL = 15
JOB_PAUSE_S = 0.25
#: seconds a bench child may take (its libraries are built by then).
BENCH_TIMEOUT_S = 300
#: miner_lint: the repo's findings ratchet and the lint's rules (the 15
#: per-file rules and the project rule ``metric-doc-drift``).
LINT_BASELINE = "bitcoin_miner_tpu_torch/analysis/lint_baseline.json"
LINT_RULES = (
    "await-state-snapshot", "blocking-in-async", "device-claiming-import",
    "first-error-wins", "lock-across-await", "lock-order-cycle",
    "metric-doc-drift", "metric-vocabulary", "signal-handler-safety",
    "spawn-unpicklable", "swallowed-cancel", "sync-hot-path-await",
    "thread-discipline", "unbounded-metric-labels",
    "unbounded-per-connection-task", "unjittered-retry-loop")
#: miner_lint's second child: the same lint in a process that then says
#: which of torch and jax it loaded.
LINT_MODULES_CODE = """\
import json, runpy, sys
sys.argv = ["bitcoin_miner_tpu_torch", "lint", "--baseline", sys.argv[1]]
rc = None
try:
    runpy.run_module("bitcoin_miner_tpu_torch", run_name="__main__")
except SystemExit as e:
    rc = e.code
print(json.dumps({"rc": rc, "torch": "torch" in sys.modules,
                  "jax": "jax" in sys.modules}))
"""


#: bulk_parity: log2 hashes a leg (the gate's default, ~10^6) and leg D's
#: chain counts.
PARITY_BITS = 20
PARITY_KS = (2, 4, 8)
#: tune_sweep: configurations of each backend's grid, and log2 nonces
#: timed per configuration.
TUNE_CONFIGS = 4
TUNE_BITS = 26
#: baseline_matrix: the runner's two configurations (``probes.run``
#: options), the tile kernel at its defaults and the reference's geometry
#: on the hit-buffer kernel.
MATRIX_RUNS = (("cuda-tile", ("--backend", "cuda-tile")),
               ("cuda", ("--backend", "cuda", "--inner-bits", "14")))
#: The smoke's seconds: the time limit it runs under with no option.
BUDGET_S = 1200
#: Every phase, in the order the smoke runs them. ``device_and_build``
#: runs first in every run; ``--phases`` picks the others
#: (:func:`phase_closure`).
PHASES = (
    "device_and_build", "miner_lint", "kernels_vs_plain",
    "variants_vs_plain", "genesis_sweep", "stratum_session",
    "cuda_backend_window", "genesis_sweep_vshare",
    "cuda_backend_window_vshare", "stratum_session_vshare",
    "stratum_session_degraded", "genesis_sweep_variants",
    "stratum_session_variant", "easy_target_scan", "gbt_session",
    "getwork_session", "stratum_session_failover",
    "stratum_session_telemetry", "genesis_sweep_batch3x",
    "telemetry_overhead", "dispatcher_sweep", "stratum_session_observatory",
    "perf_cli_roundtrip", "bench_json", "perf_capture", "fabric_session",
    "fabric_session_vshare", "native_oracle", "frontend_internal_worker",
    "frontend_proxy_session", "frontend_fabric_proxy",
    "frontend_shards_session", "frontend_shard_kill",
    "frontend_shards_load", "fleet_sweep_reclaim", "served_hasher_session",
    "grpc_fleet_session", "served_worker_federation", "lowest_vs_plain",
    "forms_vs_plain", "genesis_sweep_forms", "int_probe_vs_plain",
    "int_probe", "mesh_vs_single", "genesis_sweep_mesh",
    "genesis_sweep_fanout", "stratum_session_mesh_native",
    "mesh_native_ladder", "timings", "bulk_parity", "layout_frontier",
    "tune_sweep", "baseline_matrix",
)
#: Phases that read what other phases left behind (the plain versions'
#: outputs, a rate to compare with, a session's rows), and those phases.
PHASE_NEEDS = {
    "variants_vs_plain": ("kernels_vs_plain",),
    "forms_vs_plain": ("kernels_vs_plain",),
    "fleet_sweep_reclaim": ("genesis_sweep", "cuda_backend_window"),
    "served_hasher_session": ("stratum_session",),
    "dispatcher_sweep": ("genesis_sweep",),
    "perf_cli_roundtrip": ("dispatcher_sweep",),
    "bench_json": ("genesis_sweep",),
    "perf_capture": ("bench_json",),
    "stratum_session_observatory": ("stratum_session_telemetry",),
    "fabric_session": ("stratum_session_telemetry",),
    "frontend_shard_kill": ("frontend_shards_session",),
    "genesis_sweep_mesh": ("genesis_sweep", "genesis_sweep_vshare"),
    "genesis_sweep_fanout": ("genesis_sweep",),
    "timings": ("kernels_vs_plain", "int_probe_vs_plain", "int_probe"),
    "layout_frontier": ("timings",),
}
#: Phases that serve a worker over gRPC: they run where grpcio is
#: installed, and are reported as not run elsewhere.
GRPC_PHASES = ("served_hasher_session", "grpc_fleet_session",
               "served_worker_federation")
#: The multi-device phases (printed after the shards they run over).
MESH_PHASES = ("mesh_vs_single", "genesis_sweep_mesh",
               "genesis_sweep_fanout", "stratum_session_mesh_native",
               "mesh_native_ladder")


def phase_closure(names) -> list:
    """The phases a run of ``names`` runs, in the smoke's order:
    ``device_and_build``, the named phases and every phase they need
    (:data:`PHASE_NEEDS`), transitively. Raises ValueError naming the
    unknown names and listing :data:`PHASES`."""
    names = list(names)
    unknown = [n for n in names if n not in PHASES]
    if unknown:
        raise ValueError(f"unknown phase(s) {', '.join(unknown)}; the "
                         f"phases are: {', '.join(PHASES)}")
    want = {"device_and_build"}
    todo = list(names)
    while todo:
        name = todo.pop()
        if name not in want:
            want.add(name)
            todo.extend(PHASE_NEEDS.get(name, ()))
    return [name for name in PHASES if name in want]


def parse_options(argv: list) -> dict:
    """``--mesh-only``, ``--phases NAME[,NAME...]``: the phases to run
    (None: all of them). Raises ValueError on an unknown option or phase,
    or on both options together."""
    out = {"mesh_only": False, "phases": None}
    args = list(argv)
    while args:
        arg = args.pop(0)
        if arg == "--mesh-only":
            out["mesh_only"] = True
        elif arg == "--phases" or arg.startswith("--phases="):
            value = arg.partition("=")[2] if "=" in arg else (
                args.pop(0) if args else "")
            names = [n.strip() for n in value.split(",") if n.strip()]
            if not names:
                raise ValueError("--phases needs NAME[,NAME...]; the phases "
                                 f"are: {', '.join(PHASES)}")
            out["phases"] = phase_closure(names)
        else:
            raise ValueError(f"unknown option {arg!r}; use --phases "
                             "NAME[,NAME...] or --mesh-only")
    if out["mesh_only"] and out["phases"] is not None:
        raise ValueError("--mesh-only and --phases do not combine")
    return out


def budget_line(seconds: dict, smoke_seconds: float) -> dict:
    """The run's seconds against :data:`BUDGET_S`: in all, in its phases,
    and its five longest phases."""
    longest = sorted(seconds.items(), key=lambda kv: -kv[1])[:5]
    return {"smoke_seconds": round(smoke_seconds, 1), "budget_s": BUDGET_S,
            "phases_seconds": round(sum(seconds.values()), 1),
            "longest": [[name, round(t, 1)] for name, t in longest]}


@functools.cache
def out_dir() -> str:
    """The smoke's telemetry files: traces, and the flight recorder's dump
    path of every phase (written on a crash or SIGUSR2 only)."""
    return tempfile.mkdtemp(prefix="chip_smoke_")


#: The command line's modes that run a session (and its observatory).
SESSION_MODES = ("--pool", "--gbt", "--getwork", "--serve-hasher",
                 "--serve-pool")


def cli_args(pkg, argv, flightrec_out: str = None):
    """The command line's options for ``argv``, the flight recorder's
    dump path in :func:`out_dir` (its default is a file the checkout
    tracks) and, for a session, the incident bundles' root there too
    unless ``argv`` names one (its default is a directory in the
    checkout)."""
    path = flightrec_out or os.path.join(out_dir(), "flightrec.json")
    extra = []
    if any(mode in argv for mode in SESSION_MODES) and (
            "--incident-dir" not in argv):
        extra = ["--incident-dir", os.path.join(out_dir(), "incidents")]
    return pkg.cli.build_parser().parse_args(
        [*argv, "--flightrec-out", path, *extra])


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


async def http_get(port: int, path: str) -> tuple:
    """(status code, body) of one GET to the status server."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: smoke\r\n\r\n".encode())
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), 30)
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body


def prom_samples(text: str) -> dict:
    """Prometheus exposition text → {(name, ((label, value), ...)): value}."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        series, _, value = line.rpartition(" ")
        name, _, labels = series.partition("{")
        pairs = tuple(sorted(re.findall(r'(\w+)="([^"]*)"', labels)))
        out[(name, pairs)] = float(value)
    return out


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def launched(counts: dict) -> dict:
    """The launch counts of the kernels that launched."""
    return {name: n for name, n in counts.items() if n}


def no_hitbuf_pair(counts: dict) -> None:
    """A tile hasher's phase launches no hit-buffer scan: its rescans are
    ``rescan_steps``."""
    pair = {name: n for name, n in counts.items()
            if n and name.startswith("scan_hitbuf")}
    assert not pair, f"a tile hasher launched the hit-buffer scan: {pair}"


def tile_chains(name: str) -> int:
    """K of a tile library's name (``scan_tile`` 1, ``scan_tile_k2`` and
    ``scan_tile_vroll_k2_g1_i1`` 2)."""
    k = re.search(r"_k(\d+)", name)
    return int(k.group(1)) if k else 1


#: SASS opcodes counted per kernel: shared-memory stores and loads (the
#: staged plane), global, local (spill) and constant loads.
SASS_OPS = ("STS", "LDS", "LDG", "STL", "LDL", "LDC", "ULDC")


def sass_listings(pkg, libraries: dict) -> dict:
    """Per library (name → path), the ``cuobjdump -sass`` listing's kernels
    (``probes.sass.functions``) by ``kernel/mode``
    (``probes.ptxas.kernel_of``); one process per library, 16 at once
    (``probes.sass.listing``, which keeps each listing for the ranker)."""
    sass = pkg.sass
    with concurrent.futures.ThreadPoolExecutor(16) as pool:
        texts = dict(zip(libraries, pool.map(sass.listing,
                                             libraries.values())))
    return {name: {"/".join(map(str, pkg.ptxas.kernel_of(fn))): insns
                   for fn, insns in sass.functions(text).items()}
            for name, text in texts.items()}


def count_ops(kernels: dict) -> dict:
    """Per kernel (``kernel/mode`` → its SASS), how many of its
    instructions are each of :data:`SASS_OPS`."""
    out = {}
    for kernel, insns in kernels.items():
        ops = out[kernel] = dict.fromkeys(SASS_OPS, 0)
        for insn in insns:
            if insn.base in ops:
                ops[insn.base] += 1
    return out


def tile_layouts(tile) -> list:
    """The tile kernel's layouts the smoke test drives, as (K, variant,
    cgroup, interleave) (``tile`` is ``ops.sha256_tile``:
    ``driven_layouts``)."""
    return tile.driven_layouts()


def tile_occupancy(csrc, name: str) -> dict:
    """Per mode, a tile library's launch shape at the default geometry
    (threads per block, dynamic shared bytes) and the blocks of it that
    fit on one SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    lib = csrc.load(name)
    out = {}
    for mode, word7 in (("word7", 1), ("exact", 0)):
        vals = [ctypes.c_int() for _ in range(3)]
        csrc.check(lib.scan_tile_occupancy(
            word7, *(ctypes.addressof(v) for v in vals)), name)
        out[mode] = dict(zip(("threads", "dynamic_smem", "blocks_per_sm"),
                             (v.value for v in vals)))
    return out


def nvidia_smi(query: str, units: bool = True) -> str:
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def miner_lint() -> dict:
    """Phase 1b: the port's miner-lint over its default roots, in two
    children started together from the checkout's root (see the module's
    docstring), and ``--list-rules``. Host work only: it needs no card,
    and runs the same on a machine without one."""
    root = os.path.dirname(os.path.abspath(__file__))
    lint = [sys.executable, "-m", "bitcoin_miner_tpu_torch", "lint"]
    t0 = time.perf_counter()
    gate = subprocess.Popen(lint + ["--json", "--baseline", LINT_BASELINE],
                            cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    loaded = subprocess.Popen(
        [sys.executable, "-c", LINT_MODULES_CODE, LINT_BASELINE], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        table = subprocess.run(lint + ["--list-rules"], cwd=root,
                               capture_output=True, text=True, timeout=120)
        out, err = gate.communicate(timeout=120)
        mods_out, mods_err = loaded.communicate(timeout=120)
    finally:
        for proc in (gate, loaded):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    seconds = time.perf_counter() - t0
    assert gate.returncode == 0, (gate.returncode, out[-2000:], err[-2000:])
    doc = json.loads(out)
    assert doc["schema"] == "tpu-miner-lint/1", doc["schema"]
    assert doc["baseline"]["new"] == 0 and not doc["baseline"]["stale"], (
        doc["baseline"], doc["findings"][:5])
    assert doc["files_scanned"] > 50, doc["files_scanned"]
    assert table.returncode == 0, table.stderr[-2000:]
    rules = sorted(line.split()[0] for line in table.stdout.splitlines()
                   if line.strip())
    assert rules == sorted(LINT_RULES), rules
    assert loaded.returncode == 0, (loaded.returncode, mods_err[-2000:])
    modules = json.loads(mods_out.strip().splitlines()[-1])
    assert modules == {"rc": 0, "torch": False, "jax": False}, modules
    return {"lint_seconds": round(seconds, 3),
            "duration_s": doc["duration_s"],
            "files_scanned": doc["files_scanned"],
            "findings": len(doc["findings"]),
            "tracked": doc["baseline"]["tracked"], "rules": len(rules),
            "torch_loaded": modules["torch"], "jax_loaded": modules["jax"]}


class Smoke:
    def __init__(self, torch, pkg) -> None:
        self.torch = torch
        self.pkg = pkg
        self.dev = torch.device("cuda", 0)
        self.failed: list = []
        self.errors: dict = {}  # failed phase -> its error and trace tail
        self.launches: dict = {}  # on the main path
        self.seen: set = set()  # kernels launched in any phase
        self.kernels: dict = {}
        self.plain: dict = {}  # (k, case) -> the plain tile scan's outputs
        self.plain_hitbuf: dict = {}  # (k, case) -> the plain hit buffers
        #: case -> (job, slots, the plain rescan's outputs, its nonces)
        self.rescans: dict = {}
        self.sweep_mhs: dict = {}  # phase -> its sweep rate
        self.sweep_rows: list = []  # dispatcher_sweep's ledger rows
        self.seconds: dict = {}  # phase -> its seconds
        self.t0 = time.perf_counter()
        n = torch.cuda.device_count()
        #: the shards of the multi-device phases: every card, or one card
        #: named SHARDS_ON_ONE_CARD times.
        self.shards = tuple(torch.device("cuda", i) for i in range(n)) if (
            n >= 2) else (self.dev,) * SHARDS_ON_ONE_CARD

    # -------------------------------------------------------------- helpers
    def phase(self, name, fn) -> None:
        t0 = time.perf_counter()
        try:
            out = fn() or {}
            self.seconds[name] = time.perf_counter() - t0
            emit({"phase": name, "ok": True,
                  "seconds": round(self.seconds[name], 3), **out})
        except Exception as e:  # noqa: BLE001 — reported, and fails the run
            self.seconds[name] = time.perf_counter() - t0
            self.failed.append(name)
            self.errors[name] = {"error": repr(e),
                                 "trace": traceback.format_exc()
                                 .splitlines()[-6:]}
            emit({"phase": name, "ok": False, **self.errors[name]})
            print(f"chip_smoke: phase {name} failed: {e!r}", file=sys.stderr,
                  flush=True)

    def budget(self) -> None:
        """Print :func:`budget_line` of the run so far."""
        emit(budget_line(self.seconds, time.perf_counter() - self.t0))

    def report_failures(self) -> int:
        """The failed phases, on standard output and, last, on standard
        error (where a caller that keeps only the end of that stream still
        sees which phase failed and why, past the later phases' logs).
        Returns the exit code, 1."""
        self.budget()
        emit({"failed_phases": self.failed})
        for name in self.failed:
            print(f"chip_smoke: FAILED {name}: "
                  f"{json.dumps(self.errors[name])}", file=sys.stderr,
                  flush=True)
        return 1

    def note_launches(self) -> None:
        self.seen.update(c.name for c in self.pkg.csrc.counters() if c.value)

    def reset_counts(self) -> None:
        self.note_launches()
        for c in self.pkg.csrc.counters():
            c.reset()

    def side_counts(self) -> dict:
        """Every kernel's launches since :meth:`reset_counts`, by a phase
        whose launches hold kernels against an oracle or time them: read
        and set to 0, never added to the main path's counts or to the
        kernels seen."""
        counts = {c.name: c.value for c in self.pkg.csrc.counters()}
        for c in self.pkg.csrc.counters():
            c.reset()
        return counts

    def read_counts(self) -> dict:
        """Every kernel's launches since :meth:`reset_counts`, added to the
        main path's."""
        self.note_launches()
        return self.add_counts(
            {c.name: c.value for c in self.pkg.csrc.counters()})

    def add_counts(self, counts: dict) -> dict:
        """Add ``counts`` (kernel → launches: this process's, or a served
        worker's from :meth:`Worker.launch_counts`) to the main path's. No
        counter of a removed kernel may exist."""
        gone = [name for name in counts if name.startswith(REMOVED_KERNELS)]
        assert not gone, f"counters of removed kernels: {gone}"
        self.seen.update(name for name, n in counts.items() if n)
        for name, n in counts.items():
            self.launches[name] = self.launches.get(name, 0) + n
        return counts

    def job(self, header76, target, base, limit, k=1, host=False):
        """The job block of ``k`` chains: the header's own version and
        k-1 siblings inside VERSION_MASK; on the card, or with ``host`` its
        words in host memory (the launch parameters of the layouts)."""
        version = int.from_bytes(header76[:4], "little")
        versions = [version] + [
            version ^ p
            for p in self.pkg.sibling_version_patterns(VERSION_MASK, k)]
        job = self.pkg.job_block_from_header(header76, target, base, limit,
                                             versions=versions)
        return job.numpy() if host else job.to(self.dev)

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
        """Mean device time of ``fn``'s launches run back to back, with
        CUDA events. 2^24 tile scans queued first (:data:`BLOCKER_SCANS`
        for every 20 launches) keep the card busy while the host queues the
        timed launches; unless they are still running when the last launch
        is queued, the events would time the host's enqueue rate, and the
        run fails."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        blocker = self.job(bytes(76), 0, 0, DISPATCH)
        for _ in range(BLOCKER_SCANS * max(1, reps // 20)):
            self.pkg.scan_tile(blocker, n_steps=DISPATCH // 8192, block=8192)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        if start.query():
            raise AssertionError(
                f"the card finished the blocking scans before the host had "
                f"queued {reps} timed launches: no device time")
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def plain_ms(self, fn, warm: bool = True) -> float:
        """Host time of one run of a plain version, after a run to warm up
        unless ``warm`` is False (the same call at the same shapes ran
        already)."""
        torch = self.torch
        if warm:
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3


def run(torch, pkg, mesh_only: bool = False, phases: list = None) -> int:
    s = Smoke(torch, pkg)
    name_power = nvidia_smi("name,power.limit")
    sm_clock_mhz = float(nvidia_smi("clocks.max.sm", units=False))
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    tile = pkg.sha256_tile
    layouts = tile_layouts(tile)
    ptxas_of: dict = {}  # (library, mode) -> its ptxas row
    ptxas_of_rows: list = []  # every ptxas row
    occupancy_of: dict = {}  # library -> mode -> launch shape
    #: library -> mode -> SASS instructions per pipe in the nonce loop (one
    #: nonce an iteration), beside ops_per_nonce
    sass_per_nonce: dict = {}
    probe_lines: dict = {}  # ILP -> probes.int_probe's JSON line
    probe_plain_ms: dict = {}  # ILP -> the plain version's time

    def bound(nonces, word7, k=1, passes=1, spec=True):
        return pkg.bound_ms(nonces, word7, sms, sm_clock_mhz * 1e6, vshare=k,
                            passes=passes, spec=spec)

    def sass_bound(iterations, counts):
        """The least time of ``iterations`` runs of a loop body of
        ``counts`` SASS instructions per pipe (one per lane) at the card's
        peak rates (``pipe_bound_ms``): the ALU instructions on the integer
        pipe, all of them through dispatch."""
        return pkg.pipe_bound_ms(iterations * counts["alu"],
                                 iterations * counts["all"], sms,
                                 sm_clock_mhz * 1e6)

    def form_spec(unroll, spec):
        """Whether a form partially evaluates: only unrolled (64) ones."""
        return spec and unroll >= 64

    form_tiles = {(k, u, sp): tile.tile_library(k, unroll=u, spec=sp)
                  for k in (1, 2) for u, sp in FORMS}
    form_hitbufs = {(u, sp): pkg.hitbuf_library(1, u, sp) for u, sp in FORMS}
    genesis76 = bytes.fromhex(pkg.GENESIS_HEADER_HEX)[:76]
    genesis_version = int.from_bytes(genesis76[:4], "little")
    diff1 = pkg.nbits_to_target(0x1D00FFFF)
    easy = pkg.difficulty_to_target(1 / (1 << 20))  # ~2^-12 per nonce
    regtest = pkg.nbits_to_target(0x207FFFFF)  # about half of all hashes
    header = bytes(range(76))
    top_base = (1 << 32) - DISPATCH + 777  # the range wraps past 2^32
    cut = DISPATCH - 3 * 8192 - 1234  # cuts a step; 3 steps wholly past

    def device_and_build():
        t0 = time.perf_counter()
        if mesh_only:
            logs = pkg.csrc.build(list(pkg.csrc.BASELINE))
            return {"card": name_power, "cards": torch.cuda.device_count(),
                    "build_seconds": round(time.perf_counter() - t0, 3),
                    "libraries": len(logs),
                    "ptxas": pkg.ptxas.ptxas_table(logs)}
        names = [*pkg.csrc.BASELINE, *(tile.tile_library(*l) for l in layouts),
                 *form_tiles.values(), *form_hitbufs.values(),
                 pkg.int_probe.LIBRARY]
        gone = [n for n in pkg.csrc.SOURCES if n.startswith(REMOVED_KERNELS)]
        assert not gone, f"libraries of removed kernels: {gone}"
        logs = pkg.csrc.build(names)
        build_seconds = time.perf_counter() - t0
        rows = pkg.ptxas.ptxas_table(logs)
        ptxas_of.update(((r["library"], r["mode"]), r) for r in rows
                        if r["kernel"] != "rescan_steps_kernel")
        ptxas_of_rows.extend(rows)
        for name in names:
            if name.startswith("scan_tile"):
                occupancy_of[name] = tile_occupancy(pkg.csrc, name)
        # SASS of the staged libraries, of the K=2 baseline and regchain
        # (job words loaded from the card against kernel parameters), and
        # of the main path's scan libraries per pipe.
        listings = sass_listings(pkg, {
            name: pkg.csrc.library_path(name)
            for name in ("scan_tile", "scan_tile_k2", "scan_hitbuf",
                         tile.tile_library(2, "regchain"),
                         *(tile.tile_library(*l) for l in layouts
                           if l[1] in tile.STAGED_VARIANTS))})
        sass = {name: count_ops(kernels) for name, kernels in listings.items()
                if name not in ("scan_tile", "scan_hitbuf")}
        for name in ("scan_tile", "scan_tile_k2", "scan_hitbuf"):
            k = tile_chains(name)
            kernel = "scan_hitbuf_kernel" if "hitbuf" in name else (
                "scan_tile_kernel")
            sass_per_nonce[name] = {
                mode: {**pkg.sass.pipe_counts(pkg.sass.loop_body(
                    listings[name][f"{kernel}/{mode}"])),
                       "ops_per_nonce": pkg.ops_per_nonce(
                           mode == "word7", k)._asdict()}
                for mode in ("word7", "exact")}
        # Each staged library must read its plane back from shared memory:
        # a load per word of the plane (48, or the partial plane's) per slot
        # and chain pass, not words forwarded in registers.
        staged = {}
        for k, variant, cgroup, interleave in layouts:
            if variant not in tile.STAGED_VARIANTS:
                continue
            name = tile.tile_library(k, variant, cgroup, interleave)
            first, words = tile.plane_words(variant, interleave)
            slots = interleave * (2 if variant == "vroll-db" else 1)
            # A rolled group loop holds one group's passes, run twice.
            read = interleave if tile.rolled_groups(k, variant) else slots
            passes = len(tile._chain_groups(
                k, tile._cgroup_size(cgroup, variant, k)))
            for fn, ops in sass[name].items():
                assert ops["STS"] >= words * slots, (name, fn, ops)
                assert ops["LDS"] >= words * read * passes, (name, fn, ops)
            staged[name] = {"slots": slots, "passes": passes,
                            "plane": [first, first + words],
                            "rolled_groups": read < slots,
                            "plane_loads_expected": words * read * passes}
        # scan_tile_occupancy reports the shape launch() gives the smoke's
        # 8192-nonce steps, and a build whose launch bounds ask for a
        # minimum of blocks per SM gets them.
        for k, variant, cgroup, interleave in layouts:
            name = tile.tile_library(k, variant, cgroup, interleave)
            for mode, occ in occupancy_of[name].items():
                want = (tile.launch_threads(variant, interleave, 8192),
                        tile.plane_bytes(variant, interleave))
                assert (occ["threads"], occ["dynamic_smem"]) == want, (
                    name, mode, occ, want)
                assert occ["blocks_per_sm"] >= tile.min_blocks(
                    k, variant, interleave), (name, mode, occ)
        return {"card": name_power, "sm_clock_max_mhz": sm_clock_mhz,
                "sms": sms, "torch": torch.__version__,
                "cuda": torch.version.cuda,
                "build_seconds": round(build_seconds, 3),
                "libraries": len(logs), "ptxas": rows, "sass": sass,
                "sass_per_nonce": sass_per_nonce,
                "occupancy": occupancy_of, "staged": staged}

    tile_cases = [
        ("genesis_word7", genesis76, diff1, GENESIS_NONCE - (1 << 23),
         DISPATCH, True),
        ("genesis_exact", genesis76, diff1, GENESIS_NONCE - (1 << 23),
         DISPATCH, False),
        ("easy_cut_top_exact", header, easy, top_base, cut, False),
        ("easy_cut_top_word7", header, easy, top_base, cut, True),
    ]

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

    def rescan_nonces(slots, k, limit, tile=8192):
        """The nonces a rescan of ``slots`` hashes: each step's range
        below ``limit``."""
        steps = slots.cpu().to(torch.int64) // k
        return int((limit - steps * tile).clamp(0, tile).sum())

    def rescan_inputs():
        """(label, k, job, slots, limit) of the batched rescan's cases: the
        genesis step (word7's one candidate), the multi-hit steps of the
        easy exact dispatch at K = 1, 2, and every step of a regtest
        dispatch (each holds about 4096 hits)."""
        base = GENESIS_NONCE - (1 << 23)
        yield ("genesis_s1", 1, s.job(genesis76, diff1, base, DISPATCH),
               [(GENESIS_NONCE - base) // 8192], DISPATCH)
        for k in (1, 2):
            counts = s.plain[k, "easy_cut_top_exact"][0].cpu()
            yield (f"easy_k{k}", k, s.job(header, easy, top_base, cut, k),
                   torch.nonzero(counts > 1).flatten().tolist(), cut)
        yield ("regtest", 1, s.job(header, regtest, 12345, DISPATCH),
               list(range(DISPATCH // 8192)), DISPATCH)

    def kernels_vs_plain():
        checks = []
        for label, h, t, base, limit, word7 in tile_cases:
            job = s.job(h, t, base, limit)
            kw = dict(n_steps=DISPATCH // 8192, block=8192, word7=word7)
            got = pkg.scan_tile(job, **kw)
            want = s.plain[1, label] = pkg.scan_tile_plain(job, **kw)
            torch.cuda.synchronize()
            s.compare("scan_tile", got, want)
            checks.append({"kernel": "scan_tile", "case": label,
                           "steps_with_hits": int((want[0] > 0).sum()),
                           "hits": int(want[0].sum())})
            if label == "genesis_word7":
                step = (GENESIS_NONCE - base) // 8192
                assert int(got[1][step]) == GENESIS_NONCE, "genesis missing"
        for label, h, t, base, limit, word7, cap, inner in hitbuf_cases:
            parts = s.hitbuf_parts(s.job(h, t, base, limit))
            kw = dict(inner_size=inner, n_steps=cap // inner, max_hits=64,
                      word7=word7)
            got = pkg.scan_batch(*parts, **kw)
            want = s.plain_hitbuf[1, label] = pkg.scan_batch_plain(*parts,
                                                                   **kw)
            torch.cuda.synchronize()
            s.compare("scan_hitbuf", got, want)
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
                want = s.plain[k, label] = pkg.scan_tile_plain(job, **kw)
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
                want = s.plain_hitbuf[k, label] = pkg.scan_batch_vshare_plain(
                    *parts, **kw)
                torch.cuda.synchronize()
                s.compare(f"scan_hitbuf_k{k}", got, want)
                counts = want[1].tolist()
                if label.startswith("easy_overflow"):
                    assert min(counts) > 64, f"{label}: no overflow {counts}"
                if "genesis" in label:
                    assert GENESIS_NONCE in got[0][0].cpu().tolist(), label
                checks.append({"kernel": f"scan_hitbuf_k{k}", "case": label,
                               "counts": counts})
        # The tile hasher's batched rescan, on the job blocks above.
        for label, k, job, slots, limit in rescan_inputs():
            slots = torch.tensor(slots, dtype=torch.int32, device=s.dev)
            kw = dict(k=k, tile=8192, max_hits=64)
            got = pkg.rescan_steps(job, slots, **kw)
            want = pkg.rescan_steps_plain(job, slots, **kw)
            torch.cuda.synchronize()
            s.compare("rescan_steps", got, want)
            nonces = rescan_nonces(slots, k, limit)
            s.rescans[label] = (job, slots, want, k, nonces)
            checks.append({"kernel": "rescan_steps", "case": label, "k": k,
                           "slots": len(slots), "nonces": nonces,
                           "geometry": pkg.rescan_geometry(len(slots), 8192),
                           "hits": int(want[1].sum()),
                           "slots_over_max_hits": int((want[1] > 64).sum())})
        assert 1000 < len(s.rescans["easy_k1"][1]) < 1400, "easy dispatch"
        assert int(s.rescans["regtest"][2][1].min()) > 64, "regtest"
        return {"checks": checks, "tolerance": "exact (integers)"}

    def variants_vs_plain():
        """Every layout the smoke test drives against the plain scan of
        kernels_vs_plain, on the same cases and job blocks."""
        checks = []

        def check(layout, h, t, base, limit, word7, block, n, want, case):
            k, variant, cgroup, interleave = layout
            name = tile.tile_library(*layout)
            kw = dict(n_steps=n // block, block=block, word7=word7, vshare=k)
            job = s.job(h, t, base, limit, k)
            if want is None:
                want = pkg.scan_tile_plain(job, **kw)
            got = pkg.scan_tile(job, variant=variant, cgroup=cgroup,
                                interleave=interleave,
                                host_words=s.job(h, t, base, limit, k,
                                                 host=True), **kw)
            torch.cuda.synchronize()
            s.compare(name, got, want)
            checks.append((name, case))

        for label, h, t, base, limit, word7 in tile_cases:
            for layout in layouts:
                check(layout, h, t, base, limit, word7, 8192, DISPATCH,
                      s.plain[layout[0], label], label)
        # Steps of 128 and 256 nonces, over 2^20 nonces.
        n = 1 << 20
        for label, h, t, base, limit, word7 in (
                ("genesis_word7", genesis76, diff1, GENESIS_NONCE - n // 2,
                 n, True),
                ("easy_cut_wraps_exact", header, easy, (1 << 32) - n // 2,
                 n - 3 * 256 - 77, False)):
            for layout, block in (((1, "baseline", 0, 1), 128),
                                  ((1, "wstage", 0, 1), 128),
                                  ((2, "vroll-db", 0, 1), 256)):
                check(layout, h, t, base, limit, word7, block, n, None,
                      f"{label}_step{block}")
        # A staged plane too large for a block is refused, never launched.
        before = {c.name: c.value for c in pkg.csrc.counters()}
        try:
            pkg.scan_tile(s.job(header, easy, 0, 2048, 2), n_steps=1,
                          block=2048, vshare=2, variant="vroll-db",
                          interleave=8,
                          host_words=s.job(header, easy, 0, 2048, 2,
                                           host=True))
        except ValueError as e:
            refused = str(e)
        else:
            raise AssertionError("vroll-db at interleave 8 launched")
        assert before == {c.name: c.value for c in pkg.csrc.counters()}
        return {"checks": len(checks),
                "libraries": sorted({name for name, _ in checks}),
                "cases": sorted({case for _, case in checks}),
                "tolerance": "exact (integers)", "refused": refused}

    def genesis_sweep():
        args = cli_args(pkg,
            ["--bench", "--bench-nonces", str(1 << 32)])
        s.reset_counts()
        out = pkg.cli.bench(args)
        counts = s.read_counts()
        assert out["verified"], f"genesis nonce not found: {out['nonces']}"
        assert out["hashes"] == 1 << 32 and out["nonce_start"] == 0
        for name, n in counts.items():
            if name in ("scan_tile", "rescan_steps"):
                assert n > 0, f"{name} never launched in the genesis sweep"
            else:
                assert n == 0, f"{name} launched in the one-chain sweep"
        assert counts["scan_tile"] == (1 << 32) // DISPATCH, counts
        # At most one rescan launch per dispatch (one card).
        assert counts["rescan_steps"] <= counts["scan_tile"], counts
        s.sweep_mhs[1] = out["mhs"]
        return {"mhs": out["mhs"], "requests": out["dispatches"],
                "sweep_seconds": out["seconds"], "hits": out["nonces"],
                "mhs_vs_pr2": out["mhs"] / SWEEP_MHS_PR2,
                "launches": launched(counts)}

    def genesis_sweep_vshare():
        args = cli_args(pkg,
            ["--bench", "--vshare", "2", "--bench-nonces", str(1 << 32)])
        s.reset_counts()
        out = pkg.cli.bench(args)
        counts = s.read_counts()
        assert out["verified"], f"genesis nonce not found: {out['nonces']}"
        assert out["hashes"] == 1 << 33 and out["nonce_start"] == 0, out
        assert counts["scan_tile_k2"] == (1 << 32) // DISPATCH, counts
        assert not any(n for name, n in counts.items() if name.startswith(
            ("scan_tile", "scan_hitbuf_k")) and name != "scan_tile_k2"), counts
        no_hitbuf_pair(counts)
        assert 0 < counts["rescan_steps"] <= counts["scan_tile_k2"], counts
        siblings = []
        for version, nonce in out["version_hits"]:
            header80 = (version.to_bytes(4, "little") + genesis76[4:]
                        + nonce.to_bytes(4, "little"))
            ok = int.from_bytes(pkg.sha256d(header80), "little") <= diff1
            assert ok and version & ~VERSION_MASK == genesis_version & ~VERSION_MASK
            siblings.append({"version": f"{version:#010x}",
                             "nonce": nonce, "verified": ok})
        s.sweep_mhs[2] = out["mhs"]
        return {"mhs": out["mhs"], "hashes": out["hashes"],
                "requests": out["dispatches"],
                "sweep_seconds": out["seconds"], "hits": out["nonces"],
                "sibling_hits": siblings, "launches": launched(counts)}

    def cuda_backend_window_vshare():
        args = cli_args(pkg,
            ["--bench", "--backend", "cuda", "--vshare", "2", "--batch-bits",
             "24", "--bench-nonces", str(1 << 26)])
        s.reset_counts()
        out = pkg.cli.bench(args)
        counts = s.read_counts()
        assert out["verified"] and out["hashes"] == 1 << 27, out
        # One launch per dispatch, and nothing after it.
        assert launched(counts) == {"scan_hitbuf_k2": 4}, counts
        return {"backend": "cuda", "vshare": 2, "mhs": out["mhs"],
                "dispatches": out["dispatches"], "hits": out["nonces"],
                "sibling_hits": out["version_hits"],
                "launches": launched(counts)}

    def cuda_backend_window():
        hasher = pkg.CudaHasher(device="cuda")
        s.reset_counts()
        out = pkg.cli.run_bench(hasher, 1 << 26, batch_size=DISPATCH)
        counts = s.read_counts()
        assert out["verified"], out["nonces"]
        # One launch per dispatch, and nothing after it.
        assert launched(counts) == {"scan_hitbuf": (1 << 26) // DISPATCH}, (
            counts)
        s.sweep_mhs["cuda_backend_window"] = out["mhs"]
        return {"backend": "cuda", "mhs": out["mhs"],
                "dispatches": out["dispatches"], "hits": out["nonces"],
                "launches": launched(counts)}

    def stratum_session():
        s.reset_counts()
        result = asyncio.run(asyncio.wait_for(stratum(pkg), 300))
        s.sweep_mhs["stratum_session"] = result["mhs"]
        counts = s.read_counts()
        assert counts["scan_tile"] > 0, "scan_tile never launched"
        assert not any(n for name, n in counts.items() if "_k" in name), (
            f"a K>1 kernel launched in the one-chain session: {counts}")
        no_hitbuf_pair(counts)
        return {**result, "launches": launched(counts)}

    def stratum_session_vshare():
        s.reset_counts()
        result = asyncio.run(asyncio.wait_for(
            stratum(pkg, vshare=2, pool_mask=VERSION_MASK), 300))
        counts = s.read_counts()
        assert counts["scan_tile_k2"] > 0, "scan_tile_k2 never launched"
        assert counts["scan_tile"] == 0, counts
        no_hitbuf_pair(counts)
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
        no_hitbuf_pair(counts)
        assert result["sibling_accepted"] == 0, result
        return {**result, "launches": launched(counts)}

    def genesis_sweep_variants():
        """The whole genesis sweep through ``cli.bench`` with each layout,
        at K=1 and at ``--vshare 2``."""
        runs = []
        for variant in tile.VARIANTS[1:]:
            for k in (1, 2):
                name = tile.tile_library(k, variant)
                args = cli_args(pkg,
                    ["--bench", "--bench-nonces", str(1 << 32), "--variant",
                     variant, "--vshare", str(k)])
                s.reset_counts()
                out = pkg.cli.bench(args)
                counts = s.read_counts()
                assert out["verified"], f"{name}: genesis not found {out}"
                assert out["hashes"] == k << 32 and out["nonce_start"] == 0
                tiles = {n: c for n, c in counts.items()
                         if n.startswith("scan_tile") and c}
                assert tiles == {name: (1 << 32) // DISPATCH}, counts
                assert counts["rescan_steps"] > 0, counts  # the rescans
                no_hitbuf_pair(counts)
                siblings = [tuple(v) for v in out["version_hits"]]
                if k == 2:
                    assert SIBLING_HIT in siblings, (name, siblings)
                    version, nonce = SIBLING_HIT
                    header80 = (version.to_bytes(4, "little") + genesis76[4:]
                                + nonce.to_bytes(4, "little"))
                    assert int.from_bytes(pkg.sha256d(header80),
                                          "little") <= diff1
                runs.append({"library": name, "mhs": out["mhs"],
                             "hashes": out["hashes"],
                             "sweep_seconds": out["seconds"],
                             "hits": out["nonces"],
                             "sibling_hits": siblings,
                             "launches": launched(counts)})
        return {"runs": runs}

    def stratum_session_variant():
        """The --vshare 2 session with --variant vroll, then its degraded
        twin against a pool that grants no mask."""
        out = {}
        for label, mask, k, window in (("vroll", VERSION_MASK, 2, 2.0),
                                       ("degraded", 0, 1, 1.0)):
            s.reset_counts()
            result = asyncio.run(asyncio.wait_for(
                stratum(pkg, vshare=2, pool_mask=mask, window_s=window,
                        variant="vroll"), 300))
            counts = s.read_counts()
            tiles = {n for n, c in counts.items()
                     if n.startswith("scan_tile") and c}
            assert tiles == {tile.tile_library(k, "vroll")}, counts
            no_hitbuf_pair(counts)
            if mask:
                assert result["sibling_accepted"] >= 3, result
                assert result["chain0_accepted"] >= 3, result
            else:
                assert result["sibling_accepted"] == 0, result
            out[label] = {**result, "launches": launched(counts)}
        return out

    def easy_target_scan():
        """``TileCudaHasher.scan`` over 2^26 nonces at the easy target and
        at regtest's, where most or all 8192-nonce steps hold several hits:
        three timed scans each after a warm-up one, ``rescan_steps``
        launches per dispatch, and the same hits as ``CudaHasher`` (the
        hit-buffer kernel at 2^24) over the same range."""
        n = 1 << 26
        dispatches = n // DISPATCH
        hasher = pkg.TileCudaHasher(device="cuda")
        runs = []
        for label, target in (("easy", easy), ("regtest", regtest)):
            hasher.scan(header, 0, n, target)  # warm-up
            s.reset_counts()
            seconds = []
            for _ in range(3):
                t0 = time.perf_counter()
                got = hasher.scan(header, 1000, n, target)
                seconds.append(time.perf_counter() - t0)
            counts = s.read_counts()
            want = pkg.CudaHasher(device="cuda").scan(header, 1000, n, target)
            assert (got.nonces, got.total_hits, got.hashes_done) == (
                want.nonces, want.total_hits, want.hashes_done), label
            assert counts["scan_tile"] == 3 * dispatches, counts
            assert 0 < counts["rescan_steps"] <= counts["scan_tile"], counts
            no_hitbuf_pair(counts)
            runs.append({"target": label, "nonces": n, "dispatches": dispatches,
                         "mhs": [n / t / 1e6 for t in seconds],
                         "seconds": seconds, "total_hits": got.total_hits,
                         "rescan_launches_per_dispatch":
                             counts["rescan_steps"] / counts["scan_tile"],
                         "launches": launched(counts)})
        return {"runs": runs}

    def gbt_session():
        s.reset_counts()
        result = asyncio.run(asyncio.wait_for(gbt(pkg), 300))
        counts = s.read_counts()
        assert counts["scan_tile"] > 0 and counts["rescan_steps"] > 0, counts
        assert not any(n for name, n in counts.items() if "_k" in name), (
            f"a K>1 kernel launched in the one-chain session: {counts}")
        no_hitbuf_pair(counts)
        return {**result, "launches": launched(counts)}

    def getwork_session():
        s.reset_counts()
        result = asyncio.run(asyncio.wait_for(getwork(pkg), 300))
        counts = s.read_counts()
        assert counts["scan_tile"] > 0, counts
        assert not any(n for name, n in counts.items() if "_k" in name), (
            f"a K>1 kernel launched in the one-chain session: {counts}")
        no_hitbuf_pair(counts)
        return {**result, "launches": launched(counts)}

    def stratum_session_failover():
        s.reset_counts()
        result = asyncio.run(asyncio.wait_for(failover(pkg), 300))
        counts = s.read_counts()
        assert counts["scan_tile"] > 0, counts
        assert not any(n for name, n in counts.items() if "_k" in name), (
            f"a K>1 kernel launched in the one-chain session: {counts}")
        no_hitbuf_pair(counts)
        return {**result, "launches": launched(counts)}

    def stratum_session_telemetry():
        """The Stratum session with its telemetry surfaces on
        (:func:`stratum_telemetry`): one device_dispatch and one
        ring_collect span per dispatch collected (the tile kernel's
        launches less those abandoned at the stop), and the card's idle
        share two ways: from the busy clock, and from the window's
        launches × the exact tile kernel's time, measured here."""
        s.reset_counts()
        result = asyncio.run(asyncio.wait_for(stratum_telemetry(pkg), 300))
        counts = s.read_counts()
        assert counts["scan_tile"] > 0 and not any(
            n for name, n in counts.items() if "_k" in name), counts
        no_hitbuf_pair(counts)
        abandoned = result["dispatches_abandoned"]
        collected = counts["scan_tile"] - abandoned
        spans = result["spans"]
        assert spans["device_dispatch"] == spans["ring_collect"] == \
            collected, (spans, counts["scan_tile"], abandoned)
        exact = s.job(header, pkg.difficulty_to_target(1 / 256), 0, DISPATCH)
        ms = s.time_ms(lambda: pkg.scan_tile(exact, n_steps=DISPATCH // 8192,
                                             block=8192), 20)
        busy = result["window_launches"] * ms / 1e3
        s.sweep_mhs["stratum_session_telemetry"] = result["mhs"]
        return {**result, "scan_tile_launches": counts["scan_tile"],
                "dispatches_collected": collected,
                "scan_tile_exact_ms": ms,
                "idle_share_launches": 1 - busy / result["window_seconds"],
                "launches": launched(counts)}

    def fleet_sweep_reclaim():
        """``cuda-fleet`` (``make_cuda_fleet``) over the one card named
        :data:`FLEET_CHILDREN` times, hit-buffer children of 2^24-nonce
        dispatches, sweeps 2^30 nonces around the genesis nonce. Child 1
        is wrapped in ``ChaosHasher`` and dies after its first scan; once
        it is quarantined it is revived, and the request source waits out
        its cooldown (that pause is left out of the rate), so the next
        assignment probes it back in. Every range must come back once,
        the hashes must equal the range, the genesis nonce must be found
        once, and the child must walk quarantined → probing → degraded.
        The card's idle share is estimated as the stratum sessions' is:
        the launches × one child's scan time, measured here, against the
        sweep's time less the probe pause."""
        fleet = pkg.make_cuda_fleet(devices=[s.dev] * FLEET_CHILDREN,
                                    batch_per_device=FLEET_DISPATCH,
                                    quarantine_base_s=0.05,
                                    quarantine_cap_s=0.2)
        chaos = pkg.ChaosHasher(fleet.children[1],
                                label=fleet.chip_labels[1])
        fleet.children[1] = chaos
        chaos.die_after_scans = 1
        st = fleet.states[1]
        start = GENESIS_NONCE - FLEET_SWEEP // 2
        n_requests = FLEET_SWEEP // FLEET_DISPATCH
        paused = [0.0]
        revived = []

        def requests():
            for i in range(n_requests):
                if not revived and st.state == "quarantined":
                    chaos.revive()
                    revived.append(chaos.scans_done)
                    t = time.perf_counter()
                    time.sleep(max(0.0, st.rejoin_at - time.monotonic()))
                    paused[0] += time.perf_counter() - t
                yield pkg.ScanRequest(
                    header76=genesis76,
                    nonce_start=start + i * FLEET_DISPATCH,
                    count=FLEET_DISPATCH, target=diff1, tag=i)

        s.reset_counts()
        t0 = time.perf_counter()
        out = list(fleet.scan_stream(requests()))
        seconds = time.perf_counter() - t0
        counts = s.read_counts()
        assert [r.request.tag for r in out] == list(range(n_requests)), (
            "results out of order")
        hashes = sum(r.result.hashes_done for r in out)
        assert hashes == FLEET_SWEEP, hashes
        hits = sorted(n for r in out for n in r.result.nonces)
        assert hits.count(GENESIS_NONCE) == 1, hits
        for n in hits:
            assert int.from_bytes(pkg.sha256d(
                genesis76 + n.to_bytes(4, "little")), "little") <= diff1
        trail = [e["state"] for e in fleet.telemetry.flightrec.snapshot()
                 if e["kind"] == "fleet_child" and e["child"] == st.label]
        walk = ["quarantined", "probing", "degraded"]
        assert [x for x in trail if x in walk][:3] == walk, trail
        assert revived and chaos.scans_done > revived[0], (
            "the revived child scanned nothing", trail)
        assert fleet.reclaims > 0, fleet.snapshot()
        assert set(launched(counts)) == {"scan_hitbuf"}, counts
        mined = seconds - paused[0]
        mhs = hashes / mined / 1e6
        child = fleet.children[0]
        parts = s.hitbuf_parts(s.job(genesis76, diff1, start,
                                     FLEET_DISPATCH))
        ms = s.time_ms(lambda: pkg.scan_batch(
            *parts, word7=True, inner_size=child.inner_size,
            n_steps=FLEET_DISPATCH // child.inner_size,
            max_hits=child.max_hits), 20)
        return {"children": FLEET_CHILDREN, "dispatch": FLEET_DISPATCH,
                "nonces": FLEET_SWEEP, "hashes": hashes, "hits": hits,
                "reclaims": fleet.reclaims, "child_trail": trail,
                "child_scans_after_revive": chaos.scans_done - revived[0],
                "fleet": fleet.snapshot(), "sweep_seconds": seconds,
                "probe_pause_seconds": paused[0], "mhs": mhs,
                "mhs_vs_genesis_sweep": mhs / s.sweep_mhs[1],
                "mhs_vs_cuda_backend_window":
                    mhs / s.sweep_mhs["cuda_backend_window"],
                "scan_hitbuf_ms": ms,
                "idle_share_launches":
                    1 - counts["scan_hitbuf"] * ms / 1e3 / mined,
                "launches": launched(counts)}

    def served_hasher_session():
        """:func:`served_stratum` on a worker serving the default
        ``cuda-tile`` backend (``--status-port``): the shares, the
        negotiated ring depth and dispatch grid against the served
        hasher's, the merged trace, and the rate against
        ``stratum_session``'s."""
        service = pkg.hasher_service()
        status_port = free_port()
        worker = Worker("--status-port", str(status_port),
                        "--health-interval", "1")
        try:
            worker.wait_ready()
            handshake = worker.handshake(service)
            s.reset_counts()
            result = asyncio.run(asyncio.wait_for(
                served_stratum(pkg, worker, status_port), 300))
            local = s.read_counts()
        finally:
            rc = worker.stop()
        assert rc == 0, (rc, worker.log_tail())
        counts = s.add_counts(worker.launch_counts())
        assert not launched(local), f"the client launched {local}"
        assert counts.get("scan_tile", 0) > 0 and not any(
            n for name, n in counts.items() if "_k" in name), counts
        no_hitbuf_pair(counts)
        served = {"ring_depth": pkg.TileCudaHasher.stream_depth,
                  "dispatch_size": DISPATCH}
        assert handshake == served, (handshake, served)
        assert result["client_dispatch_size"] == DISPATCH, result
        assert result["scheduler_granularity"] == DISPATCH, result
        assert result["client_stream_window"] > handshake["ring_depth"]
        assert result["feeder_depth"] >= handshake["ring_depth"], result
        return {**result, "handshake": handshake, "worker_exit": rc,
                "worker_launches": launched(counts),
                "mhs_vs_stratum_session":
                    result["mhs"] / s.sweep_mhs["stratum_session"]}

    def grpc_fleet_session():
        """:func:`fleet_stratum` over two served workers on the card; the
        survivor is stopped with SIGTERM after it and must exit 0, having
        launched the tile kernel and no hit-buffer scan. The killed
        worker's launches are lost with it."""
        pkg.hasher_service()
        workers = [Worker(), Worker()]
        try:
            for w in workers:
                w.wait_ready()
            s.reset_counts()
            result = asyncio.run(asyncio.wait_for(
                fleet_stratum(pkg, workers, free_port()), 300))
            local = s.read_counts()
        finally:
            rcs = [w.stop() for w in workers]
        assert rcs[0] == 0, (rcs, workers[0].log_tail())
        counts = s.add_counts(workers[0].launch_counts())
        assert not launched(local), f"the client launched {local}"
        assert counts.get("scan_tile", 0) > 0, counts
        no_hitbuf_pair(counts)
        return {**result, "workers": [w.target for w in workers],
                "worker_exits": rcs,
                "survivor_launches": launched(counts)}

    def telemetry_overhead():
        """The K=1 genesis sweep through ``cli.bench`` with telemetry off
        (A: ``TPU_MINER_TELEMETRY=0``), as it comes (B: metrics on) and
        tracing (C: ``--trace-out``), each twice in the order A B C A B C.
        Rates are printed, not gated: sweeps spread ~2% between runs."""
        trace = os.path.join(out_dir(), "telemetry_overhead_trace.json")
        legs = {"A": ([], False), "B": ([], True),
                "C": (["--trace-out", trace], True)}
        runs = []
        try:
            for leg in "ABCABC":
                extra, enabled = legs[leg]
                if enabled:
                    os.environ.pop("TPU_MINER_TELEMETRY", None)
                else:
                    os.environ["TPU_MINER_TELEMETRY"] = "0"
                pkg.pipeline.set_telemetry(None)
                args = cli_args(pkg, ["--bench", "--bench-nonces",
                                      str(1 << 32), *extra])
                s.reset_counts()
                out = pkg.cli.bench(args)
                counts = s.read_counts()
                tel = pkg.pipeline.get_telemetry()
                tel.flightrec.disarm()
                assert out["verified"], out["nonces"]
                assert counts["scan_tile"] == (1 << 32) // DISPATCH, counts
                assert tel.enabled is enabled, leg
                assert tel.ring_collect.count == (256 if enabled else 0)
                if leg == "C":
                    with open(trace) as f:
                        names = [e["name"] for e in json.load(f)[
                            "traceEvents"]]
                    assert names.count("device_dispatch") == 256, len(names)
                runs.append({"leg": leg, "mhs": out["mhs"],
                             "sweep_seconds": out["seconds"]})
        finally:
            os.environ.pop("TPU_MINER_TELEMETRY", None)
            pkg.pipeline.set_telemetry(None)

        def mean(leg):
            rates = [r["mhs"] for r in runs if r["leg"] == leg]
            return sum(rates) / len(rates)

        return {"runs": runs, "mhs_a": mean("A"), "mhs_b": mean("B"),
                "mhs_c": mean("C"), "b_over_a": mean("B") / mean("A"),
                "c_over_a": mean("C") / mean("A")}

    def dispatcher_sweep():
        """``Dispatcher.sweep``, the synchronous path the perf proxy runs,
        on ``cuda-tile`` and ``cuda``: :data:`OBS_SWEEP` genesis nonces
        around 2083236893 at the difficulty-1 target in 2^24-nonce
        requests through the ring, once to warm the hasher and then
        :data:`OBS_SWEEP_WARM` times; exactly the genesis share, the
        range's hashes and one scan launch per request in every sweep.
        Then a sweep cut by ``max_shares=1``: the busy interval closes and
        the ring keeps no dispatch. The warm sweeps' median rate, and
        their least and greatest, against ``genesis_sweep``'s."""
        job = pkg.job_from_template_fields(
            job_id="genesis", prevhash_display_hex="00" * 32,
            merkle_root_internal=genesis76[36:68], version=genesis_version,
            nbits=0x1D00FFFF,
            ntime=int.from_bytes(genesis76[68:72], "little"),
            share_target=diff1)
        assert job.header76(b"") == genesis76
        start = GENESIS_NONCE - OBS_SWEEP // 2
        out = {}
        for backend, make, kernel in (
                ("cuda-tile", pkg.TileCudaHasher, "scan_tile"),
                ("cuda", pkg.CudaHasher, "scan_hitbuf")):
            hasher = make(device="cuda")
            runs = []
            for _ in range(1 + OBS_SWEEP_WARM):
                d = pkg.Dispatcher(hasher, n_workers=1, batch_size=DISPATCH)
                s.reset_counts()
                t0 = time.perf_counter()
                shares = d.sweep(job, nonce_start=start, nonce_count=OBS_SWEEP)
                seconds = time.perf_counter() - t0
                counts = s.read_counts()
                assert [sh.nonce for sh in shares] == [GENESIS_NONCE], shares
                assert (d.stats.hashes, d.stats.batches) == (
                    OBS_SWEEP, OBS_SWEEP // DISPATCH), d.stats
                assert counts[kernel] == OBS_SWEEP // DISPATCH, counts
                assert launched(counts).keys() <= {kernel, "rescan_steps"}, (
                    counts)
                assert d.stats._active_scans == 0
                runs.append({"seconds": seconds,
                             "mhs": OBS_SWEEP / seconds / 1e6,
                             "launches": launched(counts)})
            d = pkg.Dispatcher(hasher, n_workers=1, batch_size=DISPATCH)
            abandoned = hasher.dispatches_abandoned
            s.reset_counts()
            shares = d.sweep(job, nonce_start=start, nonce_count=OBS_SWEEP,
                             max_shares=1)
            cut = s.read_counts()
            assert [sh.nonce for sh in shares] == [GENESIS_NONCE], shares
            assert d.stats._active_scans == 0, "the busy interval stayed open"
            assert d.telemetry.ring_occupancy.value == 0, "the ring kept work"
            left = hasher.dispatches_abandoned - abandoned
            assert 0 < left <= hasher.stream_depth, left
            warm = sorted(r["mhs"] for r in runs[1:])
            mhs = statistics.median(warm)
            out[backend] = {
                "runs": runs, "mhs": mhs, "mhs_least": warm[0],
                "mhs_greatest": warm[-1],
                "mhs_vs_genesis_sweep": mhs / s.sweep_mhs[1],
                "range_vs_genesis_sweep": [warm[0] / s.sweep_mhs[1],
                                           warm[-1] / s.sweep_mhs[1]],
                "cut": {"batches": d.stats.batches,
                        "hashes": d.stats.hashes,
                        "busy_seconds": d.stats.scan_seconds,
                        "dispatches_given_back": left,
                        "launches": launched(cut)}}
        s.sweep_rows = [
            {"metric": "dispatcher_sweep", "backend": backend,
             "value": round(row["mhs"], 3), "unit": "MH/s",
             "nonces": OBS_SWEEP, "batch_bits": 24,
             "measured": time.strftime("%Y-%m-%dT%H:%MZ", time.gmtime())}
            for backend, row in out.items()]
        return {"nonces": OBS_SWEEP, "dispatch": DISPATCH,
                "genesis_sweep_mhs": s.sweep_mhs[1], **out}

    def stratum_session_observatory():
        """:func:`observatory_stratum`: the telemetry session with the
        observatory's flags and an objective it must breach; its rate
        against ``stratum_session_telemetry``'s."""
        s.reset_counts()
        result = asyncio.run(asyncio.wait_for(observatory_stratum(pkg), 300))
        counts = s.read_counts()
        assert counts["scan_tile"] > 0 and not any(
            n for name, n in counts.items() if "_k" in name), counts
        no_hitbuf_pair(counts)
        return {**result, "mhs_vs_stratum_session_telemetry":
                result["mhs"] / s.sweep_mhs["stratum_session_telemetry"],
                "launches": launched(counts)}

    def served_worker_federation():
        """:func:`federated_stratum`: a served worker with
        ``--status-port`` mined through by a parent session that names
        it ``--worker HOST:PORT@STATUSPORT``. The worker's launches come
        from its counts file: the tile kernel, no hit-buffer scan; the
        parent launches nothing."""
        pkg.hasher_service()
        status_port = free_port()
        worker = Worker("--status-port", str(status_port),
                        "--health-interval", "1")
        try:
            worker.wait_ready()
            s.reset_counts()
            result = asyncio.run(asyncio.wait_for(
                federated_stratum(pkg, worker, status_port), 300))
            local = s.read_counts()
        finally:
            rc = worker.stop()
        assert rc == 0, (rc, worker.log_tail())
        counts = s.add_counts(worker.launch_counts())
        assert not launched(local), f"the parent launched {local}"
        assert counts.get("scan_tile", 0) > 0, counts
        no_hitbuf_pair(counts)
        return {**result, "worker_exit": rc,
                "worker_launches": launched(counts)}

    def fabric_session():
        """:func:`fabric_stratum` twice: the three-slot fabric with pool A
        muted at a fixed time (``fixed_time_mute``), then at the moment a
        stall becomes a failover, on the one-chain tile kernel; the
        rates beside ``stratum_session_telemetry``'s."""
        s.reset_counts()
        fixed = asyncio.run(asyncio.wait_for(
            fabric_stratum(pkg, fixed_mute=True), 300))
        result = asyncio.run(asyncio.wait_for(
            fabric_stratum(pkg, fixed_mute=False), 300))
        counts = s.read_counts()
        assert counts["scan_tile"] > 0, counts
        assert not any(n for name, n in counts.items() if "_k" in name), (
            f"a K>1 kernel launched in the one-chain fabric: {counts}")
        no_hitbuf_pair(counts)
        ref = s.sweep_mhs["stratum_session_telemetry"]
        fixed.pop("routing")
        return {**result, "fixed_time_mute": fixed,
                "stratum_session_telemetry_mhs": ref,
                "mhs_before_vs_telemetry_session":
                    result["mhs_before_mute"] / ref,
                "mhs_after_vs_telemetry_session":
                    result["mhs_after_mute"] / ref,
                "launches": launched(counts)}

    def fabric_session_vshare():
        """:func:`fabric_vshare`: K=2 on pool A's jobs, the degraded K=1
        build on pool B's."""
        s.reset_counts()
        result = asyncio.run(asyncio.wait_for(fabric_vshare(pkg), 300))
        counts = s.read_counts()
        assert counts["scan_tile_k2"] > 0 and counts["scan_tile"] > 0, counts
        assert not any(n for name, n in counts.items()
                       if "_k" in name and name != "scan_tile_k2"), counts
        no_hitbuf_pair(counts)
        return {**result, "launches": launched(counts)}

    def native_oracle():
        """The package's C++ library built on the card's host and held
        against the hashlib oracle: a scan, a 2^24-nonce sweep (the host
        CPU's rate) and :data:`NATIVE_SUBMITS` seeded submits through
        both of the frontend's validators."""
        native = pkg.native
        t0 = time.perf_counter()
        library = native.build()
        build_s = time.perf_counter() - t0
        hasher = pkg.NativeCpuHasher()
        header76 = bytes.fromhex(pkg.GENESIS_HEADER_HEX)[:76]
        target = pkg.nbits_to_target(0x1D00FFFF)
        start = GENESIS_NONCE - 2048
        got = hasher.scan(header76, start, 4096, target)
        want = pkg.get_hasher("cpu").scan(header76, start, 4096, target)
        assert (got.nonces, got.total_hits) == (
            want.nonces, want.total_hits) == ([GENESIS_NONCE], 1), (got, want)
        t0 = time.perf_counter()
        sweep = hasher.scan(header76, GENESIS_NONCE - (1 << 23), 1 << 24,
                            target)
        sweep_s = time.perf_counter() - t0
        assert sweep.nonces == [GENESIS_NONCE], sweep
        return {"library": str(library.relative_to(
                    os.path.dirname(os.path.abspath(__file__)))),
                "build_seconds": build_s, "backend": native.backend_name(),
                "scan_4096_matches_cpu": True,
                "sweep_nonces": 1 << 24, "sweep_seconds": sweep_s,
                "host_cpu_mhs": (1 << 24) / sweep_s / 1e6,
                "validators": validator_parity(pkg, NATIVE_SUBMITS)}

    def frontend_internal_worker():
        """:func:`frontend_internal`: the frontend mining its own slice
        on the one-chain tile kernel, then under 256 junk sessions; its
        rates against ``stratum_session_telemetry``'s."""
        s.reset_counts()
        result = asyncio.run(asyncio.wait_for(frontend_internal(pkg), 300))
        counts = s.read_counts()
        assert counts["scan_tile"] > 0 and not any(
            n for name, n in counts.items() if "_k" in name), counts
        no_hitbuf_pair(counts)
        ref = s.sweep_mhs.get("stratum_session_telemetry")
        if ref:
            result.update({
                "stratum_session_telemetry_mhs": ref,
                "internal_vs_telemetry_session":
                    result["mhs_dispatcher_hashes"] / ref,
                "internal_launches_vs_telemetry_session":
                    result["mhs"] / ref,
                "under_load_vs_telemetry_session":
                    result["load"]["mhs_dispatcher_hashes"] / ref})
        return {**result, "launches": launched(counts)}

    def frontend_proxy_session():
        """:func:`frontend_proxy`: the internal worker and a downstream
        miner on one card behind an ``--upstream`` frontend."""
        s.reset_counts()
        result = asyncio.run(asyncio.wait_for(frontend_proxy(pkg), 300))
        counts = s.read_counts()
        assert counts["scan_tile"] > 0 and not any(
            n for name, n in counts.items() if "_k" in name), counts
        no_hitbuf_pair(counts)
        ref = s.sweep_mhs.get("stratum_session_telemetry")
        if ref:
            result.update({
                "stratum_session_telemetry_mhs": ref,
                "sum_vs_telemetry_session": result["mhs_sum"] / ref,
                "launches_vs_telemetry_session": result["mhs"] / ref})
        return {**result, "launches": launched(counts)}

    def frontend_fabric_proxy():
        """:func:`frontend_fabric`: two upstream pools behind the fabric
        proxy, the internal worker on the card."""
        s.reset_counts()
        result = asyncio.run(asyncio.wait_for(frontend_fabric(pkg), 300))
        counts = s.read_counts()
        assert counts["scan_tile"] > 0, counts
        no_hitbuf_pair(counts)
        return {**result, "launches": launched(counts)}

    shard_kill_result: list = []

    def frontend_shards_session():
        """:func:`frontend_shards`: a miner on the card behind two
        acceptor processes; its rate against
        ``stratum_session_telemetry``'s. The kill that follows in the
        same session is the next phase's."""
        exact = s.job(header, pkg.difficulty_to_target(1 / 256), 0, DISPATCH)
        tile_ms = s.time_ms(lambda: pkg.scan_tile(
            exact, n_steps=DISPATCH // 8192, block=8192), 20)
        s.reset_counts()
        result, kill = asyncio.run(asyncio.wait_for(
            frontend_shards(pkg, tile_ms), 420))
        counts = s.read_counts()
        shard_kill_result.append(kill)
        assert counts["scan_tile"] > 0 and not any(
            n for name, n in counts.items() if "_k" in name), counts
        no_hitbuf_pair(counts)
        ref = s.sweep_mhs.get("stratum_session_telemetry")
        if ref:
            result.update({"stratum_session_telemetry_mhs": ref,
                           "mhs_vs_telemetry_session": result["mhs"] / ref})
        return {**result, "scan_tile_exact_ms": tile_ms,
                "launches": launched(counts)}

    def frontend_shard_kill():
        """:func:`shard_kill`, run inside the previous phase's session
        (its launches are counted there)."""
        assert shard_kill_result, "frontend_shards_session did not run"
        kill = shard_kill_result[0]
        if isinstance(kill, BaseException):
            raise kill
        return kill

    def frontend_shards_load():
        """:func:`shard_load`: the load probe against one process and
        against 4 shards (host work: no kernel)."""
        return asyncio.run(asyncio.wait_for(shard_load(pkg), 420))

    def perf_cli_roundtrip():
        """:func:`perf_roundtrip` on ``dispatcher_sweep``'s rows: their
        fingerprint must name this card and its power limit."""
        return perf_roundtrip(pkg, s.sweep_rows, name_power)

    bench_lines: list = []

    def bench_json_phase():
        """:func:`bench_json`: the bench's children launch on the card in
        their own processes; their launches are not counted here."""
        out = bench_json(torch.cuda.get_device_name(0), s.sweep_mhs.get(1))
        bench_lines.append(out["line"])
        return out

    def perf_capture_phase():
        """:func:`perf_capture`, its rate against ``bench_json``'s."""
        return perf_capture(pkg, bench_lines[0] if bench_lines else None)

    def genesis_sweep_batch3x():
        """The whole genesis sweep as ``--bench --batch-3x --sublanes 24``
        runs it: 3·2^24-nonce dispatches of 24576-nonce steps (24 rows of
        128 nonces × 8 tiles), the last one cut by its limit."""
        args = cli_args(pkg,
            ["--bench", "--batch-3x", "--sublanes", "24", "--bench-nonces",
             str(1 << 32)])
        hasher = pkg.cli.make_hasher(args)
        assert (hasher.batch_size, hasher.tile) == (3 * DISPATCH, 24576), (
            hasher.batch_size, hasher.tile)
        s.reset_counts()
        out = pkg.cli.run_bench(hasher, 1 << 32,
                                scheduler=pkg.cli.make_scheduler(args, hasher))
        counts = s.read_counts()
        assert out["verified"], f"genesis nonce not found: {out['nonces']}"
        assert out["hashes"] == 1 << 32 and out["nonce_start"] == 0, out
        dispatches = -(-(1 << 32) // (3 * DISPATCH))
        assert counts["scan_tile"] == dispatches, (counts, dispatches)
        assert counts["rescan_steps"] <= counts["scan_tile"], counts
        assert launched(counts).keys() <= {"scan_tile", "rescan_steps"}, (
            counts)
        return {"mhs": out["mhs"], "requests": out["dispatches"],
                "dispatch_nonces": hasher.batch_size, "step": hasher.tile,
                "sweep_seconds": out["seconds"], "hits": out["nonces"],
                "mhs_vs_k1_sweep": out["mhs"] / s.sweep_mhs[1]
                if 1 in s.sweep_mhs else None,
                "launches": launched(counts)}

    def verify_sibling(version_hits) -> list:
        """The sweep's sibling hits, each verified on the CPU; the genesis
        sibling at --vshare 2 must be among them."""
        siblings = [tuple(v) for v in version_hits]
        assert SIBLING_HIT in siblings, siblings
        for version, nonce in siblings:
            header80 = (version.to_bytes(4, "little") + genesis76[4:]
                        + nonce.to_bytes(4, "little"))
            assert int.from_bytes(pkg.sha256d(header80), "little") <= diff1
        return siblings

    def lowest_vs_plain():
        """The scans' fused ``lowest`` at 2^24 nonces against the plain
        scan and ``shard_min_plain`` of its outputs: the tile scan at K =
        1, 2, 4, 8 in the baseline and vroll (staged), the hit-buffer scan
        at K = 1, 2, 4, each over the cases of kernels_vs_plain (a limit
        that cuts a step, a base near 2^32 whose range wraps, a hit-buffer
        overflow) and a limit of 0. The launches run back to back on one
        stream: each also checks that the one before it left the stream's
        ticket words at 0."""
        checks = []
        limit_0 = ("limit_0", header, easy, top_base, 0)
        for k in (1, 2, 4, 8):
            for label, h, t, base, limit, word7 in [*tile_cases,
                                                    (*limit_0, False)]:
                kw = dict(n_steps=DISPATCH // 8192, block=8192, word7=word7,
                          vshare=k)
                job = s.job(h, t, base, limit, k)
                want = s.plain.get((k, label))
                if want is None:
                    want = pkg.scan_tile_plain(job, **kw)
                want = (*want, pkg.shard_min_plain(want[1]))
                for variant in ("baseline", "vroll"):
                    got = pkg.scan_tile(job, variant=variant, lowest=True,
                                        host_words=s.job(h, t, base, limit, k,
                                                         host=True), **kw)
                    torch.cuda.synchronize()
                    s.compare(tile.tile_library(k, variant), got, want)
                least = int(want[2].to(torch.int64))
                if label == "limit_0":
                    assert least == 0xFFFFFFFF, least
                checks.append({"scan": f"tile k{k}", "case": label,
                               "lowest": least})
        for k in (1, 2, 4):
            scan = pkg.scan_batch if k == 1 else pkg.scan_batch_vshare
            plain = (pkg.scan_batch_plain if k == 1
                     else pkg.scan_batch_vshare_plain)
            for label, h, t, base, limit, word7, cap, inner in [
                    *hitbuf_cases[:3],
                    (*limit_0, False, DISPATCH, 1 << 18)]:
                parts = s.hitbuf_parts(s.job(h, t, base, limit, k), k)
                kw = dict(inner_size=inner, n_steps=cap // inner, max_hits=64,
                          word7=word7)
                want = s.plain_hitbuf.get((k, label))
                if want is None:
                    want = plain(*parts, **kw)
                want = (*want, pkg.shard_min_plain(want[0]))
                got = scan(*parts, lowest=True, **kw)
                torch.cuda.synchronize()
                s.compare(pkg.csrc.kernel_name("scan_hitbuf", k), got, want)
                least = int(want[2].to(torch.int64))
                if label == "limit_0":
                    assert least == 0xFFFFFFFF, least
                checks.append({"scan": f"hitbuf k{k}", "case": label,
                               "lowest": least,
                               "count": want[1].reshape(-1).tolist()})
        return {"checks": checks, "tolerance": "exact (integers)"}

    def forms_vs_plain():
        """Each compile form against the plain scans of kernels_vs_plain,
        on the same cases: the tile kernel at K = 1, 2, the hit buffer at
        K = 1."""
        checks = []
        for (k, unroll, spec), name in form_tiles.items():
            for label, h, t, base, limit, word7 in tile_cases:
                got = pkg.scan_tile(s.job(h, t, base, limit, k),
                                    n_steps=DISPATCH // 8192, block=8192,
                                    word7=word7, vshare=k, unroll=unroll,
                                    spec=spec)
                torch.cuda.synchronize()
                s.compare(name, got, s.plain[k, label])
                checks.append((name, label))
        for (unroll, spec), name in form_hitbufs.items():
            for label, h, t, base, limit, word7, cap, inner in hitbuf_cases:
                parts = s.hitbuf_parts(s.job(h, t, base, limit))
                got = pkg.scan_batch(*parts, inner_size=inner,
                                     n_steps=cap // inner, max_hits=64,
                                     word7=word7, unroll=unroll, spec=spec)
                torch.cuda.synchronize()
                s.compare(name, got, s.plain_hitbuf[1, label])
                checks.append((name, label))
            # The rescans launch from the same library, in the same form.
            for label in ("genesis_s1", "easy_k1", "easy_k2"):
                job, slots, want, k, _ = s.rescans[label]
                got = pkg.rescan_steps(job, slots, k=k, tile=8192,
                                       max_hits=64, unroll=unroll, spec=spec)
                torch.cuda.synchronize()
                s.compare(pkg.rescan_counter(unroll, spec), got, want)
                checks.append((pkg.rescan_counter(unroll, spec), label))
        return {"checks": len(checks),
                "libraries": sorted({name for name, _ in checks}),
                "tolerance": "exact (integers)"}

    def genesis_sweep_forms():
        """2^28 genesis nonces through ``cli.bench`` in each form: the tile
        kernel at K = 1 and --vshare 2 (its rescans in the same form), the
        hit-buffer kernel (``--backend cuda``) at K = 1."""
        runs = []
        n = 1 << 28
        for (k, unroll, spec), name in [*form_tiles.items(),
                                        *(((1, u, sp), lib) for (u, sp), lib
                                          in form_hitbufs.items())]:
            hitbuf = name in form_hitbufs.values()
            argv = ["--bench", "--bench-nonces", str(n), "--unroll",
                    str(unroll), "--vshare", str(k),
                    *([] if spec else ["--no-spec"]),
                    *(["--backend", "cuda"] if hitbuf else [])]
            s.reset_counts()
            out = pkg.cli.bench(cli_args(pkg, argv))
            counts = s.read_counts()
            assert out["verified"] and out["hashes"] == k * n, (name, out)
            kernels = {c: v for c, v in counts.items() if v and c.startswith(
                ("scan_tile", "scan_hitbuf", "rescan_steps"))}
            if hitbuf:
                assert kernels == {name: n // DISPATCH}, (name, counts)
            else:
                assert kernels.pop(name) == n // DISPATCH, (name, counts)
                # The rescans, if any, run in the same form.
                assert set(kernels) <= {pkg.rescan_counter(unroll, spec)}, (
                    counts)
                no_hitbuf_pair(counts)
            if k == 2:
                verify_sibling(out["version_hits"])
            runs.append({"library": name, "argv": argv[3:], "mhs": out["mhs"],
                         "hashes": out["hashes"],
                         "sweep_seconds": out["seconds"],
                         "launches": launched(counts)})
        return {"runs": runs}

    def int_probe_vs_plain():
        """Every step's tile of the probe at the reference's size, each ILP,
        against one tile of the plain version (every step computes the same
        function of the seed), on the same seed on the card."""
        probe = pkg.int_probe
        seed = pkg.probe_cli.seed_tile(s.dev)
        checks = []
        for ilp in probe.ILPS:
            name = f"int_probe_ilp{ilp}"
            tiles = probe.probe_tiles(seed, PROBE_GROUPS, ilp, PROBE_STEPS)
            want = probe.probe_plain(seed, PROBE_GROUPS, ilp)
            torch.cuda.synchronize()
            s.compare(name, [tiles], [want.expand_as(tiles)])
            probe_plain_ms[ilp] = s.plain_ms(
                lambda: probe.probe_plain(seed, PROBE_GROUPS, ilp))
            checks.append({"kernel": name, "steps": PROBE_STEPS,
                           "groups": PROBE_GROUPS, "max_abs_err": 0,
                           "plain_ms": probe_plain_ms[ilp]})
        return {"checks": checks, "tolerance": "exact (integers)"}

    def int_probe_run():
        """``python -m bitcoin_miner_tpu_torch.probes.int_probe`` with its
        defaults: one JSON line per ILP, exit code 0."""
        out = io.StringIO()
        s.reset_counts()
        with contextlib.redirect_stdout(out):
            rc = pkg.probe_cli.main([])
        counts = s.read_counts()
        lines = [json.loads(line) for line in out.getvalue().splitlines()]
        assert rc == 0, lines
        assert [line["ilp"] for line in lines] == list(pkg.int_probe.ILPS)
        for line in lines:
            assert (line["steps"], line["groups"]) == (PROBE_STEPS,
                                                       PROBE_GROUPS), line
            probe_lines[line["ilp"]] = line
        assert launched(counts).keys() == {
            f"int_probe_ilp{ilp}" for ilp in pkg.int_probe.ILPS}, counts
        return {"lines": lines, "launches": launched(counts)}

    def mesh_vs_single():
        """A ShardedScan over the shards against one device's scan of the
        same range, 2^24 nonces per shard: whole, and ending inside shard
        1 (the shards after it launch with limit 0)."""
        n = len(s.shards)
        checks = []
        for label, limit in (("whole", n * DISPATCH),
                             ("ends_in_shard_1", DISPATCH + 54321)):
            for k in (1, 2):
                words = s.job(header, easy, 12345, limit, k, host=True)
                scan, step = pkg.mesh.make_sharded_tile_scan_fn(
                    s.shards, DISPATCH, vshare=k)
                shards = scan(words)
                one = pkg.scan_tile(torch.from_numpy(words).to(s.dev),
                                    n_steps=n * DISPATCH // step, block=step,
                                    vshare=k)
                torch.cuda.synchronize()
                flat = [torch.cat([o[i].cpu() for o in shards])
                        for i in (0, 1)]
                s.compare("mesh_tile", flat, one)
                first = pkg.mesh.first_hit(shards)
                assert first == int(one[1].cpu().to(torch.int64).min()), label
                checks.append({"scan": f"tile k{k}", "case": label,
                               "first_hit": first,
                               "hits": int(one[0].sum())})
            words = s.job(header, easy, 12345, limit, host=True)
            inner = 1 << 18
            shards = pkg.mesh.make_sharded_scan_fn(
                s.shards, DISPATCH, inner, 64)(words)
            one = pkg.scan_batch(
                *s.hitbuf_parts(torch.from_numpy(words).to(s.dev)),
                inner_size=inner, n_steps=n * DISPATCH // inner, max_hits=64)
            torch.cuda.synchronize()
            bufs = torch.stack([o[0].cpu().to(torch.int64) for o in shards])
            counts = torch.stack([o[1].cpu().to(torch.int64) for o in shards])
            hits, total = pkg.mesh.merge_device_hits(bufs.numpy(),
                                                     counts.numpy(), 64)
            one_buf = one[0].cpu().to(torch.int64)
            assert total == int(one[1]) > 64, (label, total, int(one[1]))
            assert hits == one_buf[:64].tolist(), label
            first = pkg.mesh.first_hit(shards)
            assert first == int(one_buf.min()), label
            checks.append({"scan": "hitbuf", "case": label, "count": total,
                           "first_hit": first})
        return {"shards": [str(d) for d in s.shards], "checks": checks,
                "tolerance": "exact (integers)"}

    def mesh_sweep(make, k):
        """The genesis sweep of all 2^32 nonces through ``make()``'s hasher
        as ``--bench`` drives it (``cli.run_bench`` with the hasher's
        adaptive scheduler)."""
        hasher = make()
        s.reset_counts()
        out = pkg.cli.run_bench(hasher, 1 << 32,
                                scheduler=pkg.scheduler_for(hasher))
        counts = s.read_counts()
        assert out["verified"], f"genesis nonce not found: {out['nonces']}"
        assert out["hashes"] == k << 32 and out["nonce_start"] == 0, out
        return hasher, out, counts

    def genesis_sweep_mesh():
        runs = []
        for k in (1, 2):
            hasher, out, counts = mesh_sweep(
                lambda: pkg.ShardedTileCudaHasher(batch_per_device=DISPATCH,
                                                  vshare=k,
                                                  devices=s.shards), k)
            name = tile.tile_library(k)
            # One launch per shard and dispatch, whatever the shard count,
            # and nothing after it but the rescans of the collection.
            dispatches = (1 << 32) // hasher.dispatch_size
            assert counts[name] == len(s.shards) * dispatches, counts
            assert set(launched(counts)) <= {name, "rescan_steps"}, counts
            siblings = verify_sibling(out["version_hits"]) if k == 2 else []
            runs.append({"vshare": k, "mhs": out["mhs"],
                         "mhs_vs_single_device": out["mhs"] / s.sweep_mhs[k],
                         "hashes": out["hashes"],
                         "requests": out["dispatches"],
                         "dispatch_size": hasher.dispatch_size,
                         "sweep_seconds": out["seconds"],
                         "hits": out["nonces"], "sibling_hits": siblings,
                         "launches": launched(counts)})
        return {"shards": len(s.shards), "runs": runs}

    def genesis_sweep_fanout():
        tel = pkg.pipeline.set_telemetry(pkg.pipeline.PipelineTelemetry())
        try:
            hasher, out, counts = mesh_sweep(
                lambda: pkg.make_cuda_fanout(batch_per_device=DISPATCH,
                                             kernel="cuda-tile",
                                             devices=s.shards), 1)
        finally:
            pkg.pipeline.set_telemetry(None)
        assert counts["scan_tile"] == (1 << 32) // DISPATCH, counts
        assert set(launched(counts)) <= {"scan_tile", "rescan_steps"}, counts
        # Each request goes whole to one card: the per-card counts sum to
        # the requests, and nothing stays in flight.
        per_chip = {k[0]: c.value for k, c in tel.chip_dispatches.children()}
        inflight = {k[0]: c.value for k, c in tel.chip_inflight.children()}
        assert sum(per_chip.values()) == out["dispatches"], (per_chip, out)
        assert set(per_chip) == set(hasher.chip_labels), per_chip
        assert not any(inflight.values()), inflight
        return {"children": hasher.n_children,
                "chip_dispatches": per_chip, "chip_inflight": inflight,
                "stream_depth": hasher.stream_depth, "mhs": out["mhs"],
                "mhs_vs_single_device": out["mhs"] / s.sweep_mhs[1],
                "requests": out["dispatches"],
                "sweep_seconds": out["seconds"], "hits": out["nonces"],
                "launches": launched(counts)}

    def stratum_session_mesh_native():
        """Over several cards the command line builds the mesh
        (``--mesh-devices N``); over one card named several times, which
        the command line never builds, the smoke test hands the session a
        mesh over its shards."""
        s.reset_counts()
        backend = ["--backend", "cuda-mesh-native", "--mesh-kernel",
                   "cuda-tile"]
        hasher = None
        if len(set(s.shards)) > 1:
            backend += ["--mesh-devices", str(len(s.shards))]
        else:
            hasher = pkg.MeshCudaHasher(kernel="cuda-tile",
                                        batch_per_device=DISPATCH,
                                        devices=s.shards)
        result = asyncio.run(asyncio.wait_for(stratum(
            pkg, backend=backend, hasher=hasher), 300))
        assert result["topology"] == f"1x{len(s.shards)}", result
        counts = s.read_counts()
        # Every dispatch launches each shard once, and nothing after it
        # but the rescans of the collection.
        assert counts["scan_tile"] > 0, counts
        assert counts["scan_tile"] % len(s.shards) == 0, counts
        assert set(launched(counts)) <= {"scan_tile", "rescan_steps"}, counts
        return {**result, "launches": launched(counts),
                "dispatches": counts["scan_tile"] // len(s.shards)}

    def mesh_native_ladder():
        """quarantine → per-device fan-out → rebuild → restore, each rung
        against one device's TileCudaHasher on the same ranges: the genesis
        solve in word7 mode and an easy target with thousands of hits."""
        single = pkg.TileCudaHasher(device="cuda")
        cases = [(genesis76, GENESIS_NONCE - (1 << 26), 1 << 27, diff1),
                 (header, 777, DISPATCH + 4321, easy)]
        want = [single.scan(*c) for c in cases]
        assert GENESIS_NONCE in want[0].nonces
        assert want[1].total_hits > 64
        h = pkg.MeshCudaHasher(kernel="cuda-tile", batch_per_device=DISPATCH,
                               devices=s.shards)
        rungs = []
        s.reset_counts()

        def rung(name):
            for case, w in zip(cases, want):
                got = h.scan(*case)
                assert (got.nonces, got.total_hits, got.hashes_done) == (
                    w.nonces, w.total_hits, w.hashes_done), (name, case[1:3])
            rungs.append({"rung": name, "topology": h.topology,
                          "labels": list(h.shard_labels),
                          "dispatch_size": h.dispatch_size})

        rung("mesh")
        h.quarantine_device("1")
        assert h.degraded
        rung("quarantined")
        h.rebuild()
        assert not h.degraded and h.topology == f"1x{len(s.shards) - 1}"
        rung("rebuilt")
        h.restore_device("1")
        assert h.topology == f"1x{len(s.shards)}"
        rung("restored")
        counts = s.read_counts()
        assert counts["scan_tile"] > 0, counts
        assert counts["rescan_steps"] > 0, counts  # the easy scans
        assert set(launched(counts)) == {"scan_tile", "rescan_steps"}, counts
        return {"rungs": rungs, "libraries": h.compile_count,
                "launches": launched(counts)}

    def emit_shards():
        emit({"shards": [str(d) for d in s.shards],
              "over": ("every card" if len(set(s.shards)) > 1 else
                       f"one card named {len(s.shards)} times")})

    def run_mesh_phases() -> int:
        """--mesh-only: the single-device sweeps they are held against,
        after a warm-up sweep (the process's first launches), then the
        multi-device phases; no kernel table."""
        s.phase("warm_up", lambda: {"mhs": pkg.cli.run_bench(
            pkg.TileCudaHasher(device="cuda"), 1 << 28)["mhs"]})
        s.phase("genesis_sweep", genesis_sweep)
        s.phase("genesis_sweep_vshare", genesis_sweep_vshare)
        emit_shards()
        for name in MESH_PHASES:
            s.phase(name, functions[name])
        if s.failed:
            return s.report_failures()
        s.budget()
        print(name_power, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    def timings():
        rows = {}

        def plain_ms(fn):
            # kernels_vs_plain ran each plain version timed here, at the
            # same shapes: no run to warm up.
            return s.plain_ms(fn, warm=False)

        tile_kw = dict(n_steps=DISPATCH // 8192, block=8192)
        jobs = {k: (s.job(genesis76, diff1, GENESIS_NONCE - (1 << 23),
                          DISPATCH, k),
                    s.job(genesis76, diff1, GENESIS_NONCE - (1 << 23),
                          DISPATCH, k, host=True))
                for k in (1, 2, 3, 4, 8)}
        g_job = jobs[1][0]
        # The plain tile scan is the same function for every layout: timed
        # once per K.
        plain = {k: plain_ms(lambda: pkg.scan_tile_plain(
            jobs[k][0], word7=True, vshare=k, **tile_kw)) for k in jobs}

        def tile_row(k, variant="baseline", cgroup=0, interleave=1):
            """The tile scan of one layout per 2^24-nonce dispatch of the
            genesis job (word7, as the sweep; exact, as the session),
            beside the baseline's bound at K (the same work) and the
            layout's own operations and shared-memory traffic."""
            name = tile.tile_library(k, variant, cgroup, interleave)
            job, host = jobs[k]
            kw = dict(vshare=k, variant=variant, cgroup=cgroup,
                      interleave=interleave, host_words=host, **tile_kw)
            ms = s.time_ms(lambda: pkg.scan_tile(job, word7=True, **kw), 20)
            ms_exact = s.time_ms(lambda: pkg.scan_tile(job, **kw), 20)
            passes = len(tile._chain_groups(
                k, tile._cgroup_size(cgroup, variant, k)))
            staged = variant in tile.STAGED_VARIANTS
            own = 1 if staged else passes  # schedule expansions per nonce
            words = tile.plane_words(variant, interleave)[1]
            smem_bytes = 4 * words * (1 + passes) if staged else 0
            smem_ms = (DISPATCH * smem_bytes / (SMEM_BYTES_PER_CLOCK * sms
                                                * sm_clock_mhz * 1e6) * 1e3)
            own_bound = bound(DISPATCH, True, k, own)
            row = {
                "ms": ms, "ms_exact": ms_exact, "plain_ms": plain[k],
                "bound_ms": bound(DISPATCH, True, k),
                "bound_ms_exact": bound(DISPATCH, False, k),
                "hashes_per_s": DISPATCH * k / ms * 1e3,
                "hashes_per_s_exact": DISPATCH * k / ms_exact * 1e3,
                "vshare": k, "variant": variant, "passes": passes,
                "interleave": interleave,
                "ops_per_nonce": pkg.ops_per_nonce(True, k, own).total,
                "own_bound_ms": own_bound,
                "smem_bytes_per_nonce": smem_bytes, "smem_ms": smem_ms,
                "larger_bound": ("operations" if own_bound >= smem_ms
                                 else "shared memory"),
                "nonces": DISPATCH, "mode": "word7 (genesis sweep)",
            }
            for mode in ("word7", "exact"):
                ptx = ptxas_of.get((name, mode), {})
                row[f"registers_{mode}"] = ptx.get("registers")
                row[f"spill_bytes_{mode}"] = ptx.get("spill_stores")
                row[f"blocks_per_sm_{mode}"] = (
                    occupancy_of[name][mode]["blocks_per_sm"])
            row["threads"] = occupancy_of[name]["word7"]["threads"]
            row["dynamic_smem"] = occupancy_of[name]["word7"]["dynamic_smem"]
            row["warps_per_sm"] = (row["blocks_per_sm_word7"]
                                   * row["threads"] // 32)
            rows[name] = row

        for k in (1, 2, 3, 4, 8):
            tile_row(k)
        # The baseline's launch with ``lowest`` (the sharded scans') against
        # the same launch without it, in turns: without, with, with,
        # without.
        for k in (1, 2):
            job, _ = jobs[k]
            row = rows[tile.tile_library(k)]
            times = [s.time_ms(lambda: pkg.scan_tile(
                job, word7=True, vshare=k, lowest=lowest, **tile_kw), 20)
                for lowest in (False, True, True, False)]
            row["ms_without_lowest"] = (times[0] + times[3]) / 2
            row["ms_lowest"] = (times[1] + times[2]) / 2
            row["lowest_vs_without"] = (row["ms_lowest"]
                                        / row["ms_without_lowest"])
        for layout in layouts:
            tile_row(*layout)
        # The compile forms: the baseline layout's rows, held against the
        # function's bound (every form computes the same hashes); the
        # operations the form itself does (without partial evaluation the
        # job words count per nonce) stand beside it.
        for (k, unroll, spec), name in form_tiles.items():
            job, _ = jobs[k]
            kw = dict(vshare=k, unroll=unroll, spec=spec, **tile_kw)
            ms = s.time_ms(lambda: pkg.scan_tile(job, word7=True, **kw), 20)
            ms_exact = s.time_ms(lambda: pkg.scan_tile(job, **kw), 20)
            sp = form_spec(unroll, spec)
            rows[name] = {
                "ms": ms, "ms_exact": ms_exact, "plain_ms": plain[k],
                "bound_ms": bound(DISPATCH, True, k),
                "bound_ms_exact": bound(DISPATCH, False, k),
                "hashes_per_s": DISPATCH * k / ms * 1e3,
                "ms_vs_default_form": ms / rows[tile.tile_library(k)]["ms"],
                "vshare": k, "unroll": unroll, "spec": sp,
                "ops_per_nonce": pkg.ops_per_nonce(True, k).total,
                "ops_per_nonce_form": pkg.ops_per_nonce(True, k,
                                                        spec=sp).total,
                "form_bound_ms": bound(DISPATCH, True, k, spec=sp),
                "nonces": DISPATCH, "mode": "word7 (genesis sweep)",
                **{f"registers_{m}": ptxas_of.get((name, m), {}).get(
                    "registers") for m in ("word7", "exact")},
                **{f"spill_bytes_{m}": ptxas_of.get((name, m), {}).get(
                    "spill_stores") for m in ("word7", "exact")},
                "blocks_per_sm_word7":
                    occupancy_of[name]["word7"]["blocks_per_sm"],
            }
        tile_parts = s.hitbuf_parts(s.job(genesis76, diff1,
                                          GENESIS_NONCE - 4000, 8192))
        small = dict(inner_size=1024, n_steps=8, max_hits=64)
        big_parts = s.hitbuf_parts(g_job)
        big = dict(inner_size=1 << 18, n_steps=64, max_hits=64)
        # The hit-buffer scan, its merge in its last block, at the cuda
        # backend's 2^24 dispatch (with ``lowest`` too, as the sharded
        # cuda-mesh scan launches it), and at the one 8192-nonce step that
        # the tile hasher rescanned with it before rescan_steps. At 2^32
        # nonces the last block merges 2^19 block slots per chain: with a
        # limit of 0 the launch is little more than that merge.
        empty_parts = s.hitbuf_parts(s.job(genesis76, diff1, 0, 0))
        whole = dict(inner_size=1 << 18, n_steps=1 << 14, max_hits=64)
        rows["scan_hitbuf"] = {
            "ms": s.time_ms(
                lambda: pkg.scan_batch(*big_parts, word7=True, **big), 20),
            "ms_lowest": s.time_ms(lambda: pkg.scan_batch(
                *big_parts, word7=True, lowest=True, **big), 20),
            "plain_ms": plain_ms(
                lambda: pkg.scan_batch_plain(*big_parts, word7=True, **big)),
            "bound_ms": bound(DISPATCH, True),
            "nonces": DISPATCH, "mode": "word7, 2^24 (cuda backend)",
            "ms_8192_exact": s.time_ms(
                lambda: pkg.scan_batch(*tile_parts, **small), 200),
            "plain_ms_8192_exact": plain_ms(
                lambda: pkg.scan_batch_plain(*tile_parts, **small)),
            "bound_ms_8192_exact": bound(8192, False),
            "ms_2p32_limit_0": s.time_ms(
                lambda: pkg.scan_batch(*empty_parts, **whole), 20),
            "merge_block_slots_2p32": pkg.hitbuf_geometry(1 << 32)[1],
        }
        for (unroll, spec), name in form_hitbufs.items():
            ms = s.time_ms(lambda: pkg.scan_batch(
                *big_parts, word7=True, unroll=unroll, spec=spec, **big), 20)
            sp = form_spec(unroll, spec)
            rows[name] = {
                "ms": ms,
                "plain_ms": rows["scan_hitbuf"]["plain_ms"],
                "bound_ms": bound(DISPATCH, True),
                "ms_vs_default_form": ms / rows["scan_hitbuf"]["ms"],
                "unroll": unroll, "spec": sp,
                "ops_per_nonce": pkg.ops_per_nonce(True, 1).total,
                "ops_per_nonce_form": pkg.ops_per_nonce(True, 1,
                                                        spec=sp).total,
                "form_bound_ms": bound(DISPATCH, True, spec=sp),
                "nonces": DISPATCH, "mode": "word7, 2^24 (cuda backend)",
                **{f"registers_{m}": ptxas_of.get((name, m), {}).get(
                    "registers") for m in ("word7", "exact")},
            }
        # The batched rescan: its headline at the ~1200 multi-hit steps of
        # an easy 2^24 dispatch (the mesh ladder's and easy_target_scan's
        # case), beside the genesis step alone (the per-step pair it
        # replaced is scan_hitbuf's ms_8192_exact), the K=2 easy dispatch
        # and a regtest dispatch; each bound over the nonces its steps hold.
        rescan_ptxas = [r for r in ptxas_of_rows
                        if r["kernel"] == "rescan_steps_kernel"
                        and r["library"] == "scan_hitbuf"]
        for label, reps in (("easy_k1", 20), ("genesis_s1", 200),
                            ("easy_k2", 20), ("regtest", 20)):
            job, slots, _, k, nonces = s.rescans[label]
            kw = dict(k=k, tile=8192, max_hits=64)
            ms = s.time_ms(lambda: pkg.rescan_steps(job, slots, **kw), reps)
            part = {"ms": ms, "plain_ms": plain_ms(
                        lambda: pkg.rescan_steps_plain(job, slots, **kw)),
                    "bound_ms": bound(nonces, False), "slots": len(slots),
                    "nonces": nonces, "k": k,
                    "geometry": pkg.rescan_geometry(len(slots), 8192)}
            if label == "easy_k1":
                rows["rescan_steps"] = {
                    **part, "bound_by": "operations",
                    "mode": "exact, the multi-hit steps of an easy 2^24 "
                            "dispatch",
                    "registers": rescan_ptxas[0].get("registers"),
                    "spill_bytes": rescan_ptxas[0].get("spill_stores")}
            else:
                rows["rescan_steps"].update(
                    {f"{key}_{label}": v for key, v in part.items()})
        for (unroll, spec), _ in form_hitbufs.items():
            job, slots, _, k, nonces = s.rescans["easy_k1"]
            ms = s.time_ms(lambda: pkg.rescan_steps(
                job, slots, k=k, tile=8192, max_hits=64, unroll=unroll,
                spec=spec), 20)
            rows[pkg.rescan_counter(unroll, spec)] = {
                "ms": ms, "plain_ms": rows["rescan_steps"]["plain_ms"],
                "bound_ms": bound(nonces, False),
                "ms_vs_default_form": ms / rows["rescan_steps"]["ms"],
                "unroll": unroll, "spec": form_spec(unroll, spec),
                "slots": len(slots), "nonces": nonces,
                "mode": "exact, the multi-hit steps of an easy 2^24 "
                        "dispatch"}
        # The K-chain hit-buffer scan at the cuda backend's 2^24 dispatch.
        for k in (2, 4):
            parts = s.hitbuf_parts(jobs[k][0], k)
            ms = s.time_ms(lambda: pkg.scan_batch_vshare(*parts, word7=True,
                                                         **big), 20)
            rows[f"scan_hitbuf_k{k}"] = {
                "ms": ms,
                "ms_lowest": s.time_ms(lambda: pkg.scan_batch_vshare(
                    *parts, word7=True, lowest=True, **big), 20),
                "plain_ms": plain_ms(lambda: pkg.scan_batch_vshare_plain(
                    *parts, word7=True, **big)),
                "bound_ms": bound(DISPATCH, True, k),
                "hashes_per_s": DISPATCH * k / ms * 1e3,
                "nonces": DISPATCH, "mode": "word7, 2^24 (cuda backend)",
            }
        # The scan kernels' SASS per nonce, and the bound of those
        # instructions at the card's peak rates, as bound_ms.
        for name, modes in sass_per_nonce.items():
            row = rows[name]
            for mode, counts in modes.items():
                row[f"sass_per_nonce_{mode}"] = counts
            if name == "scan_hitbuf":
                row["sass_bound_ms"] = sass_bound(DISPATCH, modes["word7"])
                row["sass_bound_ms_8192_exact"] = sass_bound(8192,
                                                             modes["exact"])
            else:
                row["sass_bound_ms"] = sass_bound(DISPATCH, modes["word7"])
                row["sass_bound_ms_exact"] = sass_bound(DISPATCH,
                                                        modes["exact"])
        # The int32 probe, from the lines of its main-path run.
        for ilp, line in probe_lines.items():
            loop = line["sass"]["loop"]
            lanes = line["steps"] * pkg.int_probe.SUBLANES * pkg.int_probe.LANES
            rows[f"int_probe_ilp{ilp}"] = {
                "ms": line["seconds"] * 1e3, "plain_ms": probe_plain_ms[ilp],
                "bound_ms": line["bound_ms"], "bound_by": "operations",
                "sass_bound_ms": sass_bound(
                    lanes * (line["groups"] // pkg.int_probe.UNROLL), loop),
                "ilp": ilp, "steps": line["steps"], "groups": line["groups"],
                "tops_int32": line["tops_int32"], "binds": line["binds"],
                "ms_windows": [w * 1e3 for w in line["seconds_windows"]],
                "sm_clock_mhz": line["sm_clock_mhz"],
                "lanes_per_sm_clock": line["lanes_per_sm_clock"],
                "registers": line["registers"],
                "sass_per_chain_group": line["sass"]["per_chain_group"],
                "sass_loop": loop,
                "loop_overhead_per_iteration":
                    line["loop_overhead"]["all"]["per_iteration"],
            }
        for row in rows.values():
            for key, v in list(row.items()):
                if isinstance(v, float):
                    row[key] = float(f"{v:.6g}")
        return {"card": name_power, "rows": rows}

    def bulk_parity():
        """The bulk parity gate (``probes.parity.run_gate``) in this
        process at 2^20 hashes a leg, leg D at K = 2, 4, 8: every
        configuration with zero mismatches, and every library the gate
        names launched. Its launches hold the kernels against the native
        oracle and hashlib: they are not the main path's."""
        s.reset_counts()
        records, ok = pkg.parity.run_gate(bits=PARITY_BITS, ks=PARITY_KS,
                                          device="cuda", emit=lambda r: None)
        counts = s.side_counts()
        legs = records[:-1]
        failed = [r for r in legs if not r.get("ok")]
        assert ok and not failed, failed[:5]
        named = sorted({lib for r in legs for lib in r["libraries"]})
        silent = [lib for lib in named if not counts.get(lib)]
        assert not silent, f"named but never launched: {silent}"
        per_leg = {}
        for r in legs:
            leg = per_leg.setdefault(r["leg"], {"configurations": 0,
                                                "hashes": 0, "hits": 0,
                                                "seconds": 0.0})
            leg["configurations"] += 1
            leg["hashes"] += r["hashes"]
            leg["hits"] += r.get("hits", r.get("candidates", 0)) + r.get(
                "chain0_hits", 0) + r.get("sibling_hits", 0)
            leg["seconds"] += r["seconds"]
        return {"bits": PARITY_BITS, "vshare_ks": PARITY_KS,
                "summary": records[-1], "legs": per_leg,
                "configurations": [
                    {k: r.get(k) for k in (
                        "leg", "config", "hashes", "hits", "candidates",
                        "chain0_hits", "sibling_hits", "seconds")
                     if r.get(k) is not None} for r in legs],
                "libraries": len(named),
                "launches": {lib: counts[lib] for lib in named}}

    def layout_frontier():
        """``python -m bitcoin_miner_tpu_torch frontier`` on the card
        (nvcc, ptxas, SASS, occupancy), in this process: ≥ 20 candidates,
        each read; its top 10; the top 3 single-card candidates timed
        through the tuner's worker over 2^28 genesis nonces, each finding
        the nonce; and, a finding and no gate, the rank correlation of its
        predicted times with ``timings``' measured ones at K = 1, 2, 4, 8,
        and the model's constants fitted to those times."""
        frontier = pkg.frontier
        path = os.path.join(out_dir(), "frontier.json")
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = frontier.main(["--out", path, "--ledger", os.path.join(
                out_dir(), "frontier_ledger.jsonl")])
        assert rc == 0, text.getvalue()[-2000:]
        with open(path) as fh:
            doc = json.load(fh)
        ranking = doc["ranking"]
        assert doc["compiler"] == "nvcc" and len(ranking) >= 20, (
            doc["compiler"], len(ranking))
        bad = [e["name"] for e in ranking
               if not e["ok"] or e["score"]["predicted_mhs"] is None]
        assert not bad, f"candidates without a read or a score: {bad}"
        top = [{"rank": e["rank"], "name": e["name"],
                "library": e["library"], **e["score"],
                **{k: e["static"].get(k) for k in (
                    "registers", "spill_stores", "blocks_per_sm")}}
               for e in ranking[:10]]
        s.reset_counts()
        timed = []
        for e in [e for e in ranking if not e["config"].get("topology")][:3]:
            cfg = e["config"]
            config = {"backend": frontier.backend_of(cfg),
                      "batch_bits": cfg["batch_bits"],
                      "vshare": cfg["vshare"], "unroll": cfg["unroll"],
                      "spec": cfg["spec"], "sweep_bits": 28,
                      "device": "cuda"}
            if cfg["kernel"] == "tile":
                config.update({k: cfg[k] for k in (
                    "sublanes", "inner_tiles", "interleave", "variant",
                    "cgroup")})
            else:
                config["inner_bits"] = cfg["inner_bits"]
            line = io.StringIO()
            with contextlib.redirect_stdout(line):
                pkg.tune.run_worker(config)
            res = json.loads(line.getvalue().strip().splitlines()[-1])
            assert res["ok"], res
            timed.append({"name": e["name"], "mhs": res["mhs"],
                          "predicted_mhs": e["score"]["predicted_mhs"],
                          "measured_over_predicted":
                              res["mhs"] / e["score"]["predicted_mhs"],
                          "seconds": res["seconds"]})
        counts = s.side_counts()
        # The driven single-card tile rows at the default geometry against
        # timings' word7 times of the same libraries.
        measured = []
        for e in ranking:
            cfg = e["config"]
            row = timing.get(e["library"])
            if (row is None or cfg["kernel"] != "tile"
                    or cfg.get("topology")
                    or (cfg["sublanes"], cfg["inner_tiles"]) != (8, 8)):
                continue
            measured.append({"name": e["name"], "config": cfg,
                             "static": e["static"], "ms": row["ms"],
                             "predicted_ms": e["score"]["predicted_ms"]})
        correlation = {}
        for k in (1, 2, 4, 8):
            at_k = [m for m in measured if m["config"]["vshare"] == k]
            correlation[f"k{k}"] = {
                "candidates": len(at_k),
                "spearman": frontier.rank_correlation(
                    [m["predicted_ms"] for m in at_k],
                    [m["ms"] for m in at_k])}
        base = timing["scan_tile"]
        return {"card": doc["card"], "candidates": len(ranking),
                "top10": top, "timed_top3": timed,
                "launches": launched(counts),
                "rank_correlation": correlation,
                "measured_vs_predicted": [
                    {k: m[k] for k in ("name", "ms", "predicted_ms")}
                    for m in measured],
                "fit": frontier.fit(measured, doc["card"]),
                "efficiency": base["sass_bound_ms"] / base["ms"],
                "sass_over_ops": base["sass_bound_ms"] / base["bound_ms"],
                "scan_tile_ms": base["ms"],
                "scan_tile_sass_bound_ms": base["sass_bound_ms"]}

    def tune_sweep():
        """``python -m bitcoin_miner_tpu_torch.probes.tune --limit 4``: the
        first 4 configurations of each backend's grid at 2^26 nonces, in
        its child processes, the outputs in :func:`out_dir`: rc 0, every
        row ok (the genesis nonce found)."""
        root = os.path.dirname(os.path.abspath(__file__))
        paths = {name: os.path.join(out_dir(), name)
                 for name in ("tune.json", "tuned.json", "tune_evidence.jsonl")}
        proc = subprocess.run(
            [sys.executable, "-m", "bitcoin_miner_tpu_torch.probes.tune",
             "--limit", str(TUNE_CONFIGS), "--sweep-bits", str(TUNE_BITS),
             "--attempt-timeout", "300", "--out", paths["tune.json"],
             "--adopt", paths["tuned.json"],
             "--evidence", paths["tune_evidence.jsonl"]],
            cwd=root, capture_output=True, text=True, timeout=900)
        assert proc.returncode == 0, (proc.returncode, proc.stdout[-2000:],
                                      proc.stderr[-2000:])
        with open(paths["tune.json"]) as fh:
            rows = json.load(fh)["results"]
        assert len(rows) == 2 * TUNE_CONFIGS, rows
        failed = [r for r in rows if not r["ok"]]
        assert not failed, failed
        with open(paths["tuned.json"]) as fh:
            tuned = json.load(fh)
        return {"rows": [{k: r.get(k) for k in (
                    "backend", "vshare", "variant", "cgroup", "interleave",
                    "unroll", "spec", "mhs", "seconds", "compile_s")}
                    for r in rows], "adopted": tuned}

    def baseline_matrix():
        """``probes.run.main`` (the BASELINE matrix runner) in this process
        at full size, on each of :data:`MATRIX_RUNS`: rc 0, five passing
        configurations, its lines and table, and a scan kernel launched
        in each of configurations 2 to 5 (each configuration's launches
        are the counters' growth while it ran). The runner's launches are
        the main path's."""
        out = {}
        for label, argv in MATRIX_RUNS:
            s.reset_counts()
            rows = []
            before: dict = {}

            def after(result: dict) -> None:
                now = {c.name: c.value for c in pkg.csrc.counters()}
                grew = {k: v - before.get(k, 0) for k, v in now.items()
                        if v > before.get(k, 0)}
                before.update(now)
                rows.append({**result, "launches": grew})

            text = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                rc = pkg.matrix.main(list(argv), after_config=after)
            seconds = time.perf_counter() - t0
            counts = s.read_counts()
            lines = [json.loads(line) for line in text.getvalue().splitlines()
                     if line.startswith("{")]
            assert rc == 0, (label, rc, rows)
            assert [r["config"] for r in rows] == [1, 2, 3, 4, 5], rows
            assert all(r["pass"] for r in rows), rows
            assert lines == [{k: v for k, v in r.items() if k != "launches"}
                             for r in rows], lines
            assert text.getvalue().rstrip().splitlines()[-7:-5] == [
                "| # | scenario | pass | metric |", "|---|---|---|---|"]
            for r in rows[1:]:
                scans = sum(n for name, n in r["launches"].items()
                            if name.startswith(("scan_tile", "scan_hitbuf")))
                assert scans >= 1, (label, r)
            out[label] = {
                "argv": list(argv), "seconds": seconds,
                "configs": [{k: r[k] for k in (
                    "config", "name", "pass", "seconds", "mhs",
                    "blocks_accepted", "shares_accepted", "shares_rejected",
                    "launches") if k in r} for r in rows],
                "launches": launched(counts)}
        return out

    timing = {}

    def timing_phase():
        out = timings()
        timing.update(out["rows"])
        return out

    functions = {
        "device_and_build": device_and_build, "miner_lint": miner_lint,
        "kernels_vs_plain": kernels_vs_plain,
        "variants_vs_plain": variants_vs_plain,
        "genesis_sweep": genesis_sweep, "stratum_session": stratum_session,
        "cuda_backend_window": cuda_backend_window,
        "genesis_sweep_vshare": genesis_sweep_vshare,
        "cuda_backend_window_vshare": cuda_backend_window_vshare,
        "stratum_session_vshare": stratum_session_vshare,
        "stratum_session_degraded": stratum_session_degraded,
        "genesis_sweep_variants": genesis_sweep_variants,
        "stratum_session_variant": stratum_session_variant,
        "easy_target_scan": easy_target_scan, "gbt_session": gbt_session,
        "getwork_session": getwork_session,
        "stratum_session_failover": stratum_session_failover,
        "stratum_session_telemetry": stratum_session_telemetry,
        "genesis_sweep_batch3x": genesis_sweep_batch3x,
        "telemetry_overhead": telemetry_overhead,
        "dispatcher_sweep": dispatcher_sweep,
        "stratum_session_observatory": stratum_session_observatory,
        "perf_cli_roundtrip": perf_cli_roundtrip,
        "bench_json": bench_json_phase, "perf_capture": perf_capture_phase,
        "fabric_session": fabric_session,
        "fabric_session_vshare": fabric_session_vshare,
        "native_oracle": native_oracle,
        "frontend_internal_worker": frontend_internal_worker,
        "frontend_proxy_session": frontend_proxy_session,
        "frontend_fabric_proxy": frontend_fabric_proxy,
        "frontend_shards_session": frontend_shards_session,
        "frontend_shard_kill": frontend_shard_kill,
        "frontend_shards_load": frontend_shards_load,
        "fleet_sweep_reclaim": fleet_sweep_reclaim,
        "served_hasher_session": served_hasher_session,
        "grpc_fleet_session": grpc_fleet_session,
        "served_worker_federation": served_worker_federation,
        "lowest_vs_plain": lowest_vs_plain, "forms_vs_plain": forms_vs_plain,
        "genesis_sweep_forms": genesis_sweep_forms,
        "int_probe_vs_plain": int_probe_vs_plain, "int_probe": int_probe_run,
        "mesh_vs_single": mesh_vs_single,
        "genesis_sweep_mesh": genesis_sweep_mesh,
        "genesis_sweep_fanout": genesis_sweep_fanout,
        "stratum_session_mesh_native": stratum_session_mesh_native,
        "mesh_native_ladder": mesh_native_ladder, "timings": timing_phase,
        "bulk_parity": bulk_parity, "layout_frontier": layout_frontier,
        "tune_sweep": tune_sweep, "baseline_matrix": baseline_matrix,
    }
    assert tuple(functions) == PHASES, "PHASES and the phase functions"
    selected = list(PHASES) if phases is None else phases
    s.phase("device_and_build", device_and_build)
    if "miner_lint" in selected:
        s.phase("miner_lint", miner_lint)
    if s.failed:
        return s.report_failures()
    if mesh_only:
        return run_mesh_phases()
    for name in selected[1:]:
        if name == "miner_lint":
            continue
        if name in MESH_PHASES and not any(n in s.seconds
                                           for n in MESH_PHASES):
            emit_shards()
        if name in GRPC_PHASES and importlib.util.find_spec("grpc") is None:
            emit({"phase": name, "ran": False,
                  "why": "grpcio is not installed"})
            continue
        s.phase(name, functions[name])
    if s.failed:
        return s.report_failures()
    if phases is not None:
        # The main path's never-launched check and the kernel table need
        # every phase: a run of some phases stands on their own checks.
        s.budget()
        print(name_power, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    hitbuf_src = "bitcoin_miner_tpu_torch/ops/csrc/scan_hitbuf.cu"

    def source_of(name: str) -> tuple:
        """(source, the TPU kernel or XLA program it replaces)."""
        if name.startswith("scan_tile"):
            return ("bitcoin_miner_tpu_torch/ops/csrc/scan_tile.cu",
                    "bitcoin_miner_tpu/ops/sha256_pallas.py:115")
        if name.startswith("int_probe"):
            return ("bitcoin_miner_tpu_torch/ops/csrc/int_probe.cu",
                    "benchmarks/vpu_probe.py:35")
        if name.startswith("rescan_steps"):
            # _rescan_tile: _scan_batch (sha256_jax.py:780) once per step.
            return hitbuf_src, "bitcoin_miner_tpu/backends/tpu.py:1102"
        return hitbuf_src, ("bitcoin_miner_tpu/ops/sha256_jax.py:"
                            + ("780" if tile_chains(name) == 1 else "857"))

    main_path = ["scan_tile", "rescan_steps", "scan_hitbuf", "scan_tile_k2",
                 "scan_hitbuf_k2",
                 *(tile.tile_library(k, v) for v in tile.VARIANTS[1:]
                   for k in (1, 2)),
                 *form_tiles.values(), *form_hitbufs.values(),
                 *(f"int_probe_ilp{ilp}" for ilp in pkg.int_probe.ILPS)]
    unlaunched = [name for name in main_path if not s.launches.get(name)]
    if unlaunched:
        emit({"failed_phases": [], "never_launched_on_main_path": unlaunched})
        print(f"chip_smoke: never launched on the main path: {unlaunched}",
              file=sys.stderr, flush=True)
        return 1
    s.note_launches()
    table = []
    for name in sorted(s.seen, key=lambda n: (n.split("_k")[0], len(n), n)):
        source, replaces = source_of(name)
        row = timing[name]
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": s.launches.get(name, 0),
            "max_abs_err": s.kernels[name]["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row.get("bound_by", "operations"),
            "library_ms": row.get("library_ms"),
            **{k: v for k, v in row.items()
               if k not in ("ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms")},
        })
    s.budget()
    emit({"kernels": table})
    print(name_power, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


async def stratum(pkg, vshare: int = 1, pool_mask: int = 0,
                  window_s: float = SESSION_WINDOW_S,
                  variant: str = None, backend: tuple = (),
                  hasher=None) -> dict:
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
    nonces. ``backend`` adds command-line options. Without ``hasher``,
    ``cli.make_miner`` builds the session; with one (a mesh over a device
    list the command line cannot name), the session is built as
    ``make_miner`` builds it, on that hasher."""
    pool = await smoke_pool(pkg, pool_mask)
    args = cli_args(pkg,
        ["--pool", f"stratum+tcp://127.0.0.1:{pool.port}", "--user", "smoke",
         "--workers", "4", "--vshare", str(vshare),
         *(["--variant", variant] if variant else []), *backend])
    if hasher is None:
        miner = pkg.cli.make_miner(args)
    else:
        miner = pkg.StratumMiner(
            "127.0.0.1", pool.port, args.user, args.password, hasher=hasher,
            n_workers=args.workers,
            batch_size=pkg.dispatch_granularity(
                hasher, 1 << pkg.cli.DEFAULT_BATCH_BITS),
            stream_depth=args.stream_depth,
            scheduler=pkg.cli.make_scheduler(args, hasher))
    dispatcher = miner.dispatcher
    hasher = dispatcher.hasher
    assert isinstance(hasher, pkg.TileCudaHasher), hasher
    assert hasher.device.type == "cuda" and dispatcher.scheduler is not None
    stats = dispatcher.stats
    task = asyncio.create_task(miner.run())

    def mark() -> tuple:
        tiles = [c for c in pkg.csrc.counters()
                 if c.name.startswith("scan_tile")]
        hashes = sum(c.value * tile_chains(c.name) for c in tiles)
        # One launch scans one device's share of a dispatch.
        per_launch = getattr(hasher, "batch_per_device", hasher.batch_size)
        return (time.perf_counter(), hashes * per_launch,
                stats.hashes, stats.shares_accepted,
                sum(c.value for c in tiles))

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
        await until(task, enough, "3 accepted shares per chain kind",
                    stats.summary, 240)
        a = mark()
        await until(task, lambda: time.perf_counter() - a[0] >= window_s,
                    "window", stats.summary, window_s + 60)
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
            "backend": hasher.name,
            "topology": getattr(hasher, "topology", None),
            "stream_depth": dispatcher.stream_depth,
            "warmup_seconds": a[0] - t0, "window_seconds": window,
            "window_launches": b[4] - a[4],
            "mhs": (b[1] - a[1]) / window / 1e6,
            "mhs_finished_requests": (b[2] - a[2]) / window / 1e6,
            "window_shares_per_s": (b[3] - a[3]) / window}


async def smoke_pool(pkg, pool_mask: int = 0):
    """The package's validating mock pool at difficulty 1/256, granting
    ``pool_mask``, with the smoke's job announced."""
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
    return pool


class Worker:
    """A served hasher worker, ``python -m bitcoin_miner_tpu_torch
    --serve-hasher 127.0.0.1:PORT [options]``, in a process of its own on
    the card, started through :func:`serve_worker` so that its kernel
    launches are counted; its log, launch counts and flight-recorder dump
    path in :func:`out_dir`."""

    def __init__(self, *options: str) -> None:
        self.port = free_port()
        self.target = f"127.0.0.1:{self.port}"
        self.log_path = os.path.join(out_dir(), f"worker-{self.port}.log")
        self.counts_path = os.path.join(out_dir(),
                                        f"worker-{self.port}-launches.json")
        with open(self.log_path, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--serve-worker",
                 self.counts_path,
                 "--serve-hasher", self.target, "--flightrec-out",
                 os.path.join(out_dir(), f"worker-{self.port}-fr.json"),
                 "--incident-dir",
                 os.path.join(out_dir(), f"worker-{self.port}-incidents"),
                 *options],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                stdout=log, stderr=subprocess.STDOUT)

    def log_tail(self) -> str:
        with open(self.log_path) as log:
            return "".join(log.readlines()[-12:])

    def wait_ready(self, seconds: float = 120.0) -> None:
        """Until the worker accepts a connection (it binds once its hasher
        is built on the card)."""
        import grpc

        deadline = time.perf_counter() + seconds
        with grpc.insecure_channel(self.target) as channel:
            ready = grpc.channel_ready_future(channel)
            while True:
                if self.proc.poll() is not None:
                    raise RuntimeError(f"worker {self.target} exited "
                                       f"{self.proc.returncode}: "
                                       f"{self.log_tail()}")
                try:
                    ready.result(timeout=1.0)
                    return
                except grpc.FutureTimeoutError:
                    if time.perf_counter() > deadline:
                        raise TimeoutError(f"worker {self.target} not ready")

    def handshake(self, service) -> dict:
        """The ring depth and dispatch grid the worker advertises in a
        ScanStream's initial metadata (a stream that sends no request)."""
        import grpc

        with grpc.insecure_channel(self.target) as channel:
            call = channel.stream_stream(f"/{service.SERVICE}/ScanStream")(
                iter(()))
            metadata = dict(call.initial_metadata())
            call.cancel()
        return {"ring_depth": int(metadata[service.RING_DEPTH_METADATA_KEY]),
                "dispatch_size": int(
                    metadata[service.DISPATCH_SIZE_METADATA_KEY])}

    def launch_counts(self) -> dict:
        """The worker's launches per kernel, written at its clean stop."""
        with open(self.counts_path) as f:
            return json.load(f)

    def stop(self, sig=None) -> int:
        """SIGTERM (its clean stop) or ``sig``; the exit code."""
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM if sig is None else sig)
        try:
            return self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            return self.proc.wait(timeout=30)


async def served_stratum(pkg, worker: Worker, status_port: int) -> dict:
    """A Stratum session as ``--pool URL --workers 4 --backend grpc
    --grpc-target WORKER --trace-out T`` builds it and ``cli.run_session``
    runs it, against the mock pool at difficulty 1/256, on a served worker
    (``--status-port status_port``). After 3 accepted shares it mines a
    :data:`SESSION_WINDOW_S` window whose rate counts the worker's
    collected dispatches (its ``scan_batch`` count, scraped from its
    ``/metrics``) × 2^24. At the stop the trace file is written with the
    worker's spans merged in (``CollectTrace``)."""
    pool = await smoke_pool(pkg)
    trace_path = os.path.join(out_dir(), "served_session_trace.json")
    args = cli_args(pkg,
        ["--pool", f"stratum+tcp://127.0.0.1:{pool.port}", "--user", "smoke",
         "--workers", "4", "--backend", "grpc", "--grpc-target",
         worker.target, "--trace-out", trace_path])
    pkg.pipeline.set_telemetry(None)  # a fresh bundle: this session's spans
    miner = pkg.cli.make_miner(args)
    dispatcher = miner.dispatcher
    hasher = dispatcher.hasher
    assert hasher.name == "grpc" and dispatcher.scheduler is not None
    stats = dispatcher.stats
    task = asyncio.create_task(pkg.cli.run_session(miner, args))

    async def mark() -> tuple:
        code, body = await http_get(status_port, "/metrics")
        assert code == 200, body[:200]
        batches = prom_samples(body.decode())[
            ("tpu_miner_scan_batch_seconds_count", ())]
        return time.perf_counter(), batches, stats.hashes

    t0 = time.perf_counter()
    try:
        await until(task, lambda: stats.shares_accepted >= 3,
                    "3 accepted shares", stats.summary, 240)
        a = await mark()
        await asyncio.sleep(SESSION_WINDOW_S)
        b = await mark()
    finally:
        miner.stop()
        await asyncio.gather(task, return_exceptions=True)
        await pool.stop()
    rejected = [sh.reason for sh in pool.shares if not sh.accepted]
    assert not rejected and stats.shares_rejected == 0, rejected
    assert stats.hw_errors == 0, stats.summary()
    with open(trace_path) as fh:
        trace = json.load(fh)
    client_id = dispatcher.telemetry.tracer.trace_id
    spans: dict = {}
    for e in trace["traceEvents"]:
        if e.get("ph") in ("X", "i"):
            assert e["args"]["trace"] == client_id, e
            spans[e["name"]] = spans.get(e["name"], 0) + 1
    assert spans.get("serve_scan") and spans.get("device_dispatch"), spans
    window = b[0] - a[0]
    return {"accepted": stats.shares_accepted,
            "pool_validated": sum(sh.accepted for sh in pool.shares),
            "rejected": stats.shares_rejected, "hw_errors": stats.hw_errors,
            "warmup_seconds": a[0] - t0, "window_seconds": window,
            "window_dispatches": b[1] - a[1],
            "mhs": (b[1] - a[1]) * DISPATCH / window / 1e6,
            "mhs_finished_requests": (b[2] - a[2]) / window / 1e6,
            "client_stream_depth": hasher.stream_depth,
            "client_stream_window": hasher.stream_window,
            "client_dispatch_size": getattr(hasher, "dispatch_size", None),
            "scheduler_granularity": dispatcher.scheduler.granularity,
            "feeder_depth": dispatcher.stream_depth,
            "trace_id": client_id, "trace_spans": spans,
            "merged": trace["otherData"].get("merged")}


async def fleet_stratum(pkg, workers: list, status_port: int) -> dict:
    """A Stratum session as ``--pool URL --workers 4 --worker A --worker B
    --status-port P --health-interval 1`` builds it and
    ``cli.run_session`` runs it, against the mock pool at difficulty
    1/256. After 3 accepted shares worker B is killed (SIGKILL): its
    requests are reclaimed by A once B has been unreachable for the
    fleet's 10 s, and the session mines 3 more shares on A alone. Then
    ``/healthz`` must read the ``fleet`` component degraded, with the
    status 200 (no component stalled)."""
    import signal

    pool = await smoke_pool(pkg)
    args = cli_args(pkg,
        ["--pool", f"stratum+tcp://127.0.0.1:{pool.port}", "--user", "smoke",
         "--workers", "4", "--status-port", str(status_port),
         "--health-interval", "1",
         *(opt for w in workers for opt in ("--worker", w.target))])
    pkg.pipeline.set_telemetry(None)
    miner = pkg.cli.make_miner(args)
    dispatcher = miner.dispatcher
    fleet = dispatcher.hasher
    assert fleet.name == "grpc-fleet" and fleet.n_children == len(workers)
    stats = dispatcher.stats
    task = asyncio.create_task(pkg.cli.run_session(miner, args))
    survivor, dead = fleet.states
    health = code = None
    t0 = time.perf_counter()
    try:
        await until(task, lambda: stats.shares_accepted >= 3,
                    "3 accepted shares", stats.summary, 240)
        before = (stats.shares_accepted, stats.batches)
        t_kill = time.perf_counter()
        workers[1].stop(signal.SIGKILL)
        await until(task, lambda: dead.state == "quarantined"
                    and fleet.reclaims > 0, "the dead worker's reclaim",
                    stats.summary, 60)
        t_reclaim = time.perf_counter()
        await until(task, lambda: stats.shares_accepted >= before[0] + 3,
                    "3 shares after the kill", stats.summary, 120)
        deadline = time.perf_counter() + 60
        while True:
            code, body = await http_get(status_port, "/healthz")
            health = json.loads(body)
            fleet_health = health["components"].get("fleet", {})
            if code == 200 and fleet_health.get("state") == "degraded":
                break
            assert time.perf_counter() < deadline, (code, health)
            await asyncio.sleep(0.5)
        after = (stats.shares_accepted, stats.batches)
    finally:
        miner.stop()
        await asyncio.gather(task, return_exceptions=True)
        await pool.stop()
    rejected = [sh.reason for sh in pool.shares if not sh.accepted]
    assert not rejected and stats.shares_rejected == 0, rejected
    assert stats.hw_errors == 0, stats.summary()
    # The survivor's stream never broke: it was never quarantined, and
    # nothing it held was reclaimed.
    assert survivor.quarantines == 0 and survivor.reclaimed_from == 0, (
        fleet.snapshot())
    return {"accepted": stats.shares_accepted,
            "pool_validated": sum(sh.accepted for sh in pool.shares),
            "rejected": stats.shares_rejected, "hw_errors": stats.hw_errors,
            "accepted_after_kill": after[0] - before[0],
            "batches_after_kill": after[1] - before[1],
            "seconds_to_first_shares": t_kill - t0,
            "seconds_kill_to_reclaim": t_reclaim - t_kill,
            "reclaims": fleet.reclaims, "fleet": fleet.snapshot(),
            "healthz_code": code, "healthz_fleet": health["components"]["fleet"],
            "healthz_status": health["status"]}


async def gbt(pkg) -> dict:
    """A getblocktemplate session as ``--gbt URL --workers 8`` builds it,
    against the package's fake node at regtest's nbits, which advances its
    tip on every accepted block (the block's hash is the next template's
    prevhash, at height + 1) as a regtest node does. It needs 3 blocks
    accepted on 3 distinct tips. The window runs from the first accepted
    block to the third tip: its rate counts the tile kernel's launches ×
    the batch, ``hashes_mhs`` the finished requests, and it holds two job
    switches. No block may be rejected for a reason other than a stale
    tip, and there may be no hardware error. The session runs as the
    command line runs it (``cli.run_session``, ``--status-port P
    --health-interval 1``), and ``/healthz`` must answer 200 once polled
    after the first block."""
    node = pkg.FakeNode(nbits=pkg.REGTEST_NBITS, advance_tip=True)
    await node.start()
    port = free_port()
    args = cli_args(pkg,
        ["--gbt", node.url, "--workers", "8", "--status-port", str(port),
         "--health-interval", "1"])
    miner = pkg.cli.make_gbt_miner(args)
    dispatcher = miner.dispatcher
    hasher = dispatcher.hasher
    assert isinstance(hasher, pkg.TileCudaHasher), hasher
    assert hasher.device.type == "cuda" and dispatcher.n_workers == 8
    stats = dispatcher.stats
    task = asyncio.create_task(pkg.cli.run_session(miner, args))

    def mark() -> tuple:
        launches = sum(c.value for c in pkg.csrc.counters()
                       if c.name == "scan_tile")
        return (time.perf_counter(), launches, stats.hashes,
                miner.blocks_accepted)

    t0 = time.perf_counter()
    try:
        await until(task, lambda: miner.blocks_accepted >= 1, "a block",
                    stats.summary, 60)
        a = mark()
        code, body = await http_get(port, "/healthz")
        health = json.loads(body)
        assert code == 200, health
        await until(task, lambda: miner.blocks_accepted >= 3
                    and len(node.tips) >= 3, "3 blocks on 3 tips",
                    stats.summary, 120)
        b = mark()
    finally:
        miner.stop()
        t_stop = time.perf_counter()
        await asyncio.gather(task, return_exceptions=True)
        stop_seconds = time.perf_counter() - t_stop
        await node.stop()
    node_rejects = [blk.reason for blk in node.blocks if not blk.accepted]
    assert miner.blocks_rejected == 0, dict(miner.reject_reasons)
    assert all(r == "inconclusive-not-best-prevblk" for r in node_rejects), (
        node_rejects)
    assert stats.hw_errors == 0, stats.summary()
    window = b[0] - a[0]
    return {"blocks_accepted": miner.blocks_accepted,
            "blocks_stale": miner.blocks_stale,
            "blocks_rejected": miner.blocks_rejected,
            "reject_reasons": dict(miner.reject_reasons),
            "blocks_submitted": miner.blocks_submitted,
            "node_accepted": sum(blk.accepted for blk in node.blocks),
            "node_stale_tip": len(node_rejects), "tips": len(node.tips),
            "height": node.template["height"],
            "hw_errors": stats.hw_errors, "hashes": stats.hashes,
            "workers": dispatcher.n_workers, "backend": hasher.name,
            "first_block_seconds": a[0] - t0, "window_seconds": window,
            "window_launches": b[1] - a[1],
            "seconds_per_tip": window / (b[3] - a[3]),
            "stop_seconds": stop_seconds,
            "mhs": (b[1] - a[1]) * hasher.batch_size / window / 1e6,
            "hashes_mhs": (b[2] - a[2]) / window / 1e6,
            "healthz": health}


async def getwork(pkg) -> dict:
    """A getwork session as ``--getwork URL --workers 4`` builds it (ntime
    rolls 600 s), against the package's fake node at difficulty 1 (one
    solve per 2^32 nonces), which takes a solve at an ntime up to 600 s
    past the one it served. It needs 3 accepted solves, 2 of them at a
    rolled ntime; none rejected, no hardware error. The rate counts the
    tile kernel's launches × the batch from the first job to the third
    solve."""
    node = pkg.FakeNode(nbits=0x1D00FFFF, getwork_ntime_roll=600)
    await node.start()
    args = cli_args(pkg,
        ["--getwork", node.url, "--workers", "4"])
    miner = pkg.cli.make_getwork_miner(args)
    dispatcher = miner.dispatcher
    hasher = dispatcher.hasher
    assert isinstance(hasher, pkg.TileCudaHasher), hasher
    assert hasher.device.type == "cuda" and dispatcher.ntime_roll == 600
    stats = dispatcher.stats

    def rolled() -> list:
        return [w for w in node.getwork_submits if w.accepted and int.from_bytes(
            w.header80[68:72], "little") != w.served_ntime]

    def mark() -> tuple:
        launches = sum(c.value for c in pkg.csrc.counters()
                       if c.name == "scan_tile")
        return time.perf_counter(), launches, stats.hashes

    task = asyncio.create_task(miner.run())
    try:
        await until(task, lambda: dispatcher.current_generation >= 1,
                    "a job", stats.summary, 60)
        a = mark()
        await until(task, lambda: miner.solves_accepted >= 3
                    and len(rolled()) >= 2, "3 solves, 2 at a rolled ntime",
                    stats.summary, 120)
        b = mark()
    finally:
        miner.stop()
        await asyncio.gather(task, return_exceptions=True)
        await node.stop()
    rejected = [w for w in node.getwork_submits if not w.accepted]
    assert not rejected and stats.shares_rejected == 0, rejected
    assert stats.hw_errors == 0, stats.summary()
    return {"solves_accepted": miner.solves_accepted,
            "solves_submitted": miner.solves_submitted,
            "node_accepted": sum(w.accepted for w in node.getwork_submits),
            "rolled_ntime_accepted": [
                int.from_bytes(w.header80[68:72], "little") - w.served_ntime
                for w in rolled()],
            "stale": stats.shares_stale, "rejected": stats.shares_rejected,
            "hw_errors": stats.hw_errors, "hashes": stats.hashes,
            "workers": dispatcher.n_workers, "window_seconds": b[0] - a[0],
            "window_launches": b[1] - a[1],
            "mhs": (b[1] - a[1]) * hasher.batch_size / (b[0] - a[0]) / 1e6,
            "hashes_mhs": (b[2] - a[2]) / (b[0] - a[0]) / 1e6}


async def failover(pkg, suggest: float = 0.00390625) -> dict:
    """A Stratum session as ``--pool stratum+tcp://127.0.0.1:DEAD,
    stratum+tcp://127.0.0.1:LIVE --host-index 1 --n-hosts 2
    --suggest-difficulty S --checkpoint PATH`` builds it, against the mock
    pool at difficulty 1 on LIVE (nothing listens on DEAD). The client's
    reconnect delays are cut to 0.05-0.2 s so that its three failed
    attempts take a fraction of a second. It needs the rotation to LIVE,
    the pool's difficulty at the suggestion, 3 accepted shares, each of an
    odd extranonce2 (host 1 of 2), and a resume index ≥ 1 in the
    checkpoint file; a second miner built on that file must then resume
    the job at that index, past the partition's start."""
    import socket
    import tempfile

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        dead = sock.getsockname()[1]
    pool = pkg.MockStratumPool(difficulty=1.0)
    await pool.start()
    pool_job = pkg.PoolJob(
        job_id="failover",
        prevhash_internal=pkg.sha256d(b"chip smoke failover prev"),
        coinb1=bytes.fromhex("01000000") + b"\x11" * 30,
        coinb2=b"\x22" * 30 + bytes.fromhex("00000000"),
        merkle_branch=[pkg.sha256d(b"tx1")],
        version=0x20000000, nbits=0x1D00FFFF, ntime=0x655F2B2C,
    )
    await pool.announce_job(pool_job)
    tmp = tempfile.TemporaryDirectory()
    path = f"{tmp.name}/sweep.json"
    argv = ["--pool", f"stratum+tcp://127.0.0.1:{dead},"
            f"stratum+tcp://127.0.0.1:{pool.port}", "--host-index", "1",
            "--n-hosts", "2", "--suggest-difficulty", str(suggest),
            "--checkpoint", path]
    args = cli_args(pkg, argv)
    miner = pkg.cli.make_miner(args)
    miner.client._backoff = pkg.DecorrelatedJitterBackoff(0.05, 0.2)
    dispatcher = miner.dispatcher
    hasher = dispatcher.hasher
    assert isinstance(hasher, pkg.TileCudaHasher), hasher
    assert (dispatcher.extranonce2_start, dispatcher.extranonce2_step) == (
        1, 2)
    assert (miner.client.host, miner.client.port) == ("127.0.0.1", dead)
    stats = dispatcher.stats
    job = pkg.Job.from_stratum(
        pkg.StratumJobParams.from_notify(pool_job.notify_params()),
        extranonce1=pool.extranonce1,
        extranonce2_size=pool.extranonce2_size, difficulty=suggest)

    def saved() -> int:
        index = dispatcher.checkpoint.get_resume_index(job.sweep_key)
        return -1 if index is None else index

    task = asyncio.create_task(miner.run())
    t0 = time.perf_counter()
    try:
        await until(task, lambda: miner.client.connected.is_set(),
                    "the rotation to the live pool", stats.summary, 60)
        rotated = time.perf_counter() - t0
        await until(task, lambda: stats.shares_accepted >= 3 and saved() >= 1,
                    "3 shares and a checkpoint", stats.summary, 120)
    finally:
        miner.stop()
        await asyncio.gather(task, return_exceptions=True)
        await pool.stop()
    seconds = time.perf_counter() - t0
    with open(path) as f:
        on_disk = json.load(f)
    index = on_disk["jobs"][job.sweep_key]
    # A restarted miner on the same file resumes there.
    resumed = pkg.cli.make_miner(args).dispatcher
    assert resumed.checkpoint.get_resume_index(job.sweep_key) == index
    first = next(resumed._iter_items(resumed.set_job(job)))
    first_e2 = int.from_bytes(first.extranonce2, "little")
    tmp.cleanup()
    assert first_e2 == 1 + 2 * index and first_e2 > 1, (first_e2, index)
    rejected = [sh.reason for sh in pool.shares if not sh.accepted]
    assert not rejected and stats.shares_rejected == 0, rejected
    assert stats.hw_errors == 0, stats.summary()
    e2s = sorted({int.from_bytes(sh.extranonce2, "little")
                  for sh in pool.shares})
    assert e2s and all(e2 % 2 == 1 for e2 in e2s), e2s
    assert (miner.client.host, miner.client.port) == ("127.0.0.1", pool.port)
    assert pool.difficulty == suggest == miner.client.difficulty, (
        pool.difficulty, miner.client.difficulty)
    return {"rotated_to_live_after_s": rotated,
            "failed_attempts": miner.client.reconnects,
            "pool_difficulty": pool.difficulty,
            "accepted": stats.shares_accepted,
            "pool_validated": sum(sh.accepted for sh in pool.shares),
            "extranonce2_accepted": e2s[:16],
            "shares_per_host_residue": {
                str(r): sum(1 for sh in pool.shares if sh.accepted and
                            int.from_bytes(sh.extranonce2, "little") % 2 == r)
                for r in (0, 1)},
            "checkpoint_index": index, "resumed_at_extranonce2": first_e2,
            "rejected": stats.shares_rejected, "hw_errors": stats.hw_errors,
            "hashes": stats.hashes, "seconds": seconds,
            "hashes_mhs": stats.hashes / seconds / 1e6}


async def stratum_telemetry(pkg, window_s: float = SESSION_WINDOW_S) -> dict:
    """A Stratum session as ``--pool URL --workers 4 --status-port P
    --trace-out T --flightrec-out F --health-interval 1 --ntime-roll 15``
    builds it (``cli.make_miner``, run by ``cli.run_session`` with its
    reporter, health watchdog and status server), against the mock pool
    at difficulty 1/256 with an extranonce2 of 0 bytes, on a fresh
    telemetry bundle. After 3 accepted shares it scrapes ``/trace`` and
    ``/flightrec`` (which must hold the job switch), mines a window of
    ``window_s`` (rate, device rate and idle share from the busy clock,
    ``/healthz`` 200 with device and ring ok), lets the job's 16 ntime
    passes run out, and has the pool send the next job ``JOB_PAUSE_S``
    after the miner went idle: the busy clock's gap. Then ``/metrics``
    must show the gap, ring collects, constants-cache hits and ≥ 3
    accepted verdicts. The trace file written at the stop is returned
    counted by span name; the caller holds those against the launches."""
    pool = pkg.MockStratumPool(difficulty=1 / 256, extranonce2_size=0)
    await pool.start()

    def pool_job(job_id: str):
        return pkg.PoolJob(
            job_id=job_id,
            prevhash_internal=pkg.sha256d(b"chip smoke prev " +
                                          job_id.encode()),
            coinb1=bytes.fromhex("01000000") + b"\x11" * 30,
            coinb2=b"\x22" * 30 + bytes.fromhex("00000000"),
            merkle_branch=[pkg.sha256d(b"tx1")],
            version=0x20000000, nbits=0x1D00FFFF, ntime=0x655F2B2C)

    await pool.announce_job(pool_job("telemetry-a"))
    port = free_port()
    trace_path = os.path.join(out_dir(),
                              "stratum_session_telemetry_trace.json")
    args = cli_args(pkg, [
        "--pool", f"stratum+tcp://127.0.0.1:{pool.port}", "--user", "smoke",
        "--workers", "4", "--ntime-roll", str(NTIME_ROLL),
        "--status-port", str(port), "--trace-out", trace_path,
        "--health-interval", "1"],
        flightrec_out=os.path.join(
            out_dir(), "stratum_session_telemetry_flightrec.json"))
    tel = pkg.pipeline.set_telemetry(pkg.pipeline.PipelineTelemetry())
    miner = pkg.cli.make_miner(args)
    dispatcher = miner.dispatcher
    hasher = dispatcher.hasher
    assert isinstance(hasher, pkg.TileCudaHasher), hasher
    assert hasher.device.type == "cuda" and dispatcher.telemetry is tel
    stats = dispatcher.stats
    task = asyncio.create_task(pkg.cli.run_session(miner, args))

    def mark() -> tuple:
        launches = sum(c.value for c in pkg.csrc.counters()
                       if c.name == "scan_tile")
        return (time.perf_counter(), launches, stats.hashes,
                stats.busy_seconds())

    out = {}
    try:
        await until(task, lambda: stats.shares_accepted >= 3,
                    "3 accepted shares", stats.summary, 240)
        a = mark()
        code, body = await http_get(port, "/trace")
        assert code == 200 and "traceEvents" in json.loads(body)
        code, body = await http_get(port, "/flightrec")
        flightrec = json.loads(body)
        assert code == 200, code
        kinds = [e["kind"] for e in flightrec["events"]]
        assert "job_switch" in kinds, kinds[:20]
        await until(task, lambda: time.perf_counter() - a[0] >= window_s / 2,
                    "half the window", stats.summary, window_s + 60)
        code, body = await http_get(port, "/healthz")
        health = json.loads(body)
        assert code == 200, health
        assert {health["components"][c]["state"]
                for c in ("device", "ring")} == {"ok"}, health
        await until(task, lambda: time.perf_counter() - a[0] >= window_s,
                    "window", stats.summary, window_s + 60)
        b = mark()
        # The job's (NTIME_ROLL + 1) × 2^32 nonces run out: the busy clock
        # goes idle, and the pool's next job ends the gap.
        await until(task, lambda: stats._active_scans == 0,
                    "the job to run out", stats.summary, 120)
        idle_at = time.perf_counter()
        await asyncio.sleep(JOB_PAUSE_S)
        await pool.announce_job(pool_job("telemetry-b"))
        await until(task, lambda: tel.dispatch_gap.count >= 1,
                    "the busy clock's gap", stats.summary, 60)
        gap_seen = time.perf_counter() - idle_at
        await asyncio.sleep(1.0)
        code, body = await http_get(port, "/metrics")
        assert code == 200, code
        samples = prom_samples(body.decode())
        checks = {
            "tpu_miner_dispatch_gap_seconds_count": samples[
                ("tpu_miner_dispatch_gap_seconds_count", ())],
            "tpu_miner_ring_collect_seconds_count": samples[
                ("tpu_miner_ring_collect_seconds_count", ())],
            "consts_cache_hit": samples[(
                "tpu_miner_consts_cache_lookups_total",
                (("result", "hit"),))],
            "pool_acks_accepted": samples[(
                "tpu_miner_pool_acks_total", (("result", "accepted"),))],
        }
        assert checks["tpu_miner_dispatch_gap_seconds_count"] > 0, checks
        assert checks["tpu_miner_ring_collect_seconds_count"] > 0, checks
        assert checks["consts_cache_hit"] > 0, checks
        assert checks["pool_acks_accepted"] >= 3, checks
        out["scraped"] = checks
    finally:
        miner.stop()
        await asyncio.gather(task, return_exceptions=True)
        await pool.stop()
        tel.flightrec.disarm()
    task.result()
    rejected = [sh.reason for sh in pool.shares if not sh.accepted]
    assert not rejected and stats.shares_rejected == 0, rejected
    assert stats.hw_errors == 0, stats.summary()
    with open(trace_path) as f:
        trace = json.load(f)
    assert trace["traceEvents"] and all(
        e["ph"] in ("X", "i", "C", "M") for e in trace["traceEvents"])
    spans: dict = {}
    for e in trace["traceEvents"]:
        key = e["name"]
        if e["name"] == "pool_ack" and e["args"].get("result") == "accepted":
            spans["pool_ack_accepted"] = spans.get("pool_ack_accepted", 0) + 1
        spans[key] = spans.get(key, 0) + 1
    verdicts = sum(c.value for _, c in tel.pool_acks.children())
    assert spans["submit"] == spans["pool_ack"] == verdicts, (spans, verdicts)
    assert spans["pool_ack_accepted"] == stats.shares_accepted, spans
    assert spans["cpu_verify"] == stats.shares_found + stats.hw_errors, spans
    window = b[0] - a[0]
    busy = b[3] - a[3]
    return {**out,
            "accepted": stats.shares_accepted,
            "pool_validated": sum(sh.accepted for sh in pool.shares),
            "rejected": stats.shares_rejected, "hw_errors": stats.hw_errors,
            "verdicts": verdicts, "spans": spans,
            "dispatches_abandoned": hasher.dispatches_abandoned,
            "window_seconds": window, "window_launches": b[1] - a[1],
            "mhs": (b[1] - a[1]) * hasher.batch_size / window / 1e6,
            "device_mhs_busy_clock": (b[2] - a[2]) / busy / 1e6,
            "idle_share_busy_clock": 1 - busy / window,
            "gap_seconds_after_idle": gap_seen,
            "dispatch_gap_count": tel.dispatch_gap.count,
            "dispatch_gap_max_s": tel.dispatch_gap.max,
            "ring_collect_ms": {
                "count": tel.ring_collect.count,
                "mean": tel.ring_collect.mean * 1e3,
                "p50": tel.ring_collect.quantile(0.5) * 1e3,
                "p99": tel.ring_collect.quantile(0.99) * 1e3},
            "scan_batch_ms_p50": tel.scan_batch.quantile(0.5) * 1e3,
            "submit_rtt_ms_p50": tel.submit_rtt.quantile(0.5) * 1e3,
            "submit_rtt_ms_p99": tel.submit_rtt.quantile(0.99) * 1e3,
            "trace": trace_path, "trace_events": len(trace["traceEvents"]),
            "trace_dropped": trace["otherData"].get("dropped_events", 0)}


async def cli_run(*argv: str) -> tuple:
    """(exit code, stdout) of ``python -m bitcoin_miner_tpu_torch ARGV``
    in a process of its own, from the checkout's root."""
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "bitcoin_miner_tpu_torch", *argv,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    out, _ = await asyncio.wait_for(proc.communicate(), 120)
    return proc.returncode, out.decode()


async def observatory_stratum(pkg) -> dict:
    """A Stratum session as ``--pool URL --workers 4 --status-port P
    --health-interval 1 --slo-fast-window 4 --slo-slow-window 12
    --slo-objectives F --incident-dir D`` builds it and
    ``cli.run_session`` runs it, against the mock pool at difficulty
    1/256; F holds one objective no submit meets (:data:`OBS_OBJECTIVES`).
    After 3 accepted shares it mines a :data:`SESSION_WINDOW_S` window
    (the rate counts the tile kernel's launches), and meanwhile ``/slo``
    must read the objective breached, ``/healthz`` (200) the ``slo``
    component degraded, ``/query`` the ``scan_batch`` series with several
    points, ``top --once`` render a frame and ``slo --status-url`` exit 1.
    At the stop D must hold one ``tpu-miner-incident/1`` bundle and its
    row in ``incident_ledger.jsonl``, and no observatory or watchdog
    thread may be left."""
    import threading

    pool = await smoke_pool(pkg)
    port = free_port()
    objectives = os.path.join(out_dir(), "observatory_objectives.json")
    with open(objectives, "w") as f:
        json.dump(OBS_OBJECTIVES, f)
    incidents = os.path.join(out_dir(), "observatory_incidents")
    args = cli_args(pkg, [
        "--pool", f"stratum+tcp://127.0.0.1:{pool.port}", "--user", "smoke",
        "--workers", "4", "--status-port", str(port),
        "--health-interval", "1", "--slo-fast-window", str(OBS_FAST_WINDOW),
        "--slo-slow-window", str(OBS_SLOW_WINDOW), "--slo-objectives",
        objectives, "--incident-dir", incidents])
    tel = pkg.pipeline.set_telemetry(pkg.pipeline.PipelineTelemetry())
    miner = pkg.cli.make_miner(args)
    dispatcher = miner.dispatcher
    hasher = dispatcher.hasher
    assert isinstance(hasher, pkg.TileCudaHasher), hasher
    assert hasher.device.type == "cuda" and dispatcher.telemetry is tel
    stats = dispatcher.stats
    task = asyncio.create_task(pkg.cli.run_session(miner, args))
    url = f"http://127.0.0.1:{port}"

    def launches() -> int:
        return sum(c.value for c in pkg.csrc.counters()
                   if c.name == "scan_tile")

    out = {}
    t0 = time.perf_counter()
    try:
        await until(task, lambda: stats.shares_accepted >= 3,
                    "3 accepted shares", stats.summary, 240)
        a = (time.perf_counter(), launches())
        deadline = time.perf_counter() + 60
        while True:
            code, body = await http_get(port, "/slo")
            report = json.loads(body)
            states = {o["name"]: o["state"] for o in report["objectives"]}
            if states.get("submit-rtt-1us") == "breach":
                break
            assert time.perf_counter() < deadline, report
            await asyncio.sleep(0.25)
        out["seconds_to_breach"] = time.perf_counter() - t0
        out["slo"] = report["objectives"][0]
        await asyncio.sleep(1.5)  # a watchdog tick after the breach
        code, body = await http_get(port, "/healthz")
        health = json.loads(body)
        assert code == 200 and health["components"]["slo"]["state"] == \
            "degraded", health
        out["healthz_slo"] = health["components"]["slo"]
        code, body = await http_get(
            port, "/query?name=tpu_miner_scan_batch_seconds_count"
            "&process=parent")
        series = json.loads(body)["series"]
        assert code == 200 and len(series) == 1 and len(
            series[0]["points"]) >= 3, series
        out["scan_batch_points"] = len(series[0]["points"])
        (top_rc, top), (slo_rc, slo) = await asyncio.gather(
            cli_run("top", "--status-url", url, "--once"),
            cli_run("slo", "--status-url", url))
        assert top_rc == 0 and top.startswith("tpu-miner top"), top
        assert slo_rc == 1 and "breach" in slo, (slo_rc, slo)
        out["top_frame"] = top.splitlines()
        out["slo_command"] = slo.splitlines()
        await until(task, lambda: time.perf_counter() - a[0]
                    >= SESSION_WINDOW_S, "window", stats.summary,
                    SESSION_WINDOW_S + 60)
        b = (time.perf_counter(), launches())
    finally:
        miner.stop()
        await asyncio.gather(task, return_exceptions=True)
        await pool.stop()
        tel.flightrec.disarm()
    task.result()
    left = [t.name for t in threading.enumerate() if t.is_alive()
            and t.name in ("observatory", "health-watchdog")]
    assert not left, f"threads outlived the session: {left}"
    rejected = [sh.reason for sh in pool.shares if not sh.accepted]
    assert not rejected and stats.shares_rejected == 0, rejected
    assert stats.hw_errors == 0, stats.summary()
    bundles = [d for d in os.listdir(incidents) if d.startswith("pl-")]
    assert len(bundles) == 1, bundles
    with open(os.path.join(incidents, bundles[0], "incident.json")) as f:
        manifest = json.load(f)
    assert manifest["schema"] == "tpu-miner-incident/1", manifest
    with open(os.path.join(incidents, "incident_ledger.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["id"] for r in rows] == [manifest["ledger_id"]], rows
    window = b[0] - a[0]
    return {**out, "accepted": stats.shares_accepted,
            "rejected": stats.shares_rejected, "hw_errors": stats.hw_errors,
            "incident": {"manifest": manifest["ledger_id"],
                         "artifacts": sorted(manifest["artifacts"]),
                         "errors": manifest["errors"],
                         "ledger_row": {k: rows[0].get(k) for k in (
                             "metric", "objective", "value", "unit")}},
            "tsdb_series": tel.tsdb_series.value,
            "window_seconds": window, "window_launches": b[1] - a[1],
            "mhs": (b[1] - a[1]) * hasher.batch_size / window / 1e6}


def fabric_pool_job(pkg, job_id: str):
    return pkg.PoolJob(
        job_id=job_id,
        prevhash_internal=pkg.sha256d(b"chip smoke fabric " +
                                      job_id.encode()),
        coinb1=bytes.fromhex("01000000") + b"\x11" * 30,
        coinb2=b"\x22" * 30 + bytes.fromhex("00000000"),
        merkle_branch=[pkg.sha256d(b"tx1"), pkg.sha256d(b"tx2")],
        version=0x20000000, nbits=0x1D00FFFF, ntime=0x655F2B2C)


async def fabric_pools(pkg, mask_a: int = 0, mask_b: int = 0) -> tuple:
    """Chaos pools A and B at :data:`FABRIC_DIFFICULTY`, each with its own
    extranonce1, job and BIP 310 mask."""
    pools = []
    for name, e1, mask in (("fabric-a", "deadbeef", mask_a),
                           ("fabric-b", "beadfeed", mask_b)):
        pool = pkg.ChaosStratumPool(difficulty=FABRIC_DIFFICULTY,
                                    extranonce1=bytes.fromhex(e1),
                                    version_mask=mask)
        await pool.start()
        await pool.announce_job(fabric_pool_job(pkg, name))
        pools.append(pool)
    return tuple(pools)


def tile_launches(pkg) -> int:
    return sum(c.value for c in pkg.csrc.counters()
               if c.name.startswith("scan_tile"))


async def fabric_stratum(pkg, fixed_mute: bool) -> dict:
    """The multi-pool fabric as ``--pool stratum+tcp://A#w=3 --pool
    stratum+tcp://B --pool gbt+http://N --workers 4 --status-port P
    --health-interval 1`` builds it (``cli.make_miner``) and
    ``cli.run_session`` runs it, with the command line's routing defaults,
    on a fresh telemetry bundle: A and B chaos pools at
    :data:`FABRIC_DIFFICULTY`, N the fake node at regtest's nbits taking
    each accepted block as its next tip. :data:`FABRIC_PRE_MUTE_S` after
    A's first accepted share A goes mute (reads every request, answers
    none): with
    ``fixed_mute`` at once, wherever the dispatcher is, and the session
    mines :data:`FABRIC_POST_MUTE_S` more (a stall is a failover only for
    the slot owning the dispatcher at a routing tick, so this mute is
    measured, not held to one); else at the first moment A owns the
    dispatcher, its shares flow and the stride scheduler's next pick is A
    again, and the session mines :data:`FABRIC_POST_MUTE_S` more, until
    the stall rule has degraded A and a failover moved the dispatcher. A
    sampler records the tile kernel's launches every 0.1 s: the card's
    rate over all nonces before and after the mute (launches × 2^24) and
    the seconds after it with no launch (workers parked on submits to the
    muted pool until the request timeout)."""
    a, b = await fabric_pools(pkg)
    node = pkg.FakeNode(nbits=pkg.REGTEST_NBITS, advance_tip=True)
    await node.start()
    port = free_port()
    args = cli_args(pkg, [
        "--pool", f"stratum+tcp://127.0.0.1:{a.port}#w=3",
        "--pool", f"stratum+tcp://127.0.0.1:{b.port}",
        "--pool", f"gbt+http://127.0.0.1:{node.port}", "--user", "smoke",
        "--workers", "4", "--status-port", str(port),
        "--health-interval", "1"])
    tel = pkg.pipeline.set_telemetry(pkg.pipeline.PipelineTelemetry())
    miner = pkg.cli.make_miner(args)
    assert isinstance(miner, pkg.MultipoolMiner), miner
    dispatcher, fabric = miner.dispatcher, miner.fabric
    hasher = dispatcher.hasher
    assert isinstance(hasher, pkg.TileCudaHasher), hasher
    assert hasher.device.type == "cuda" and dispatcher.telemetry is tel
    assert (fabric.route_interval_s, fabric.stall_after_s,
            fabric.request_timeout) == (10.0, 10.0, 10.0)
    slot_a = fabric.slots[0]
    stats = dispatcher.stats
    task = asyncio.create_task(pkg.cli.run_session(miner, args))
    timeline = []  # (seconds, tile launches)
    #: (seconds from the start, the owning slot, each slot's state), at
    #: every change the sampler sees.
    routing = []
    #: when the sampler last saw a stride pass move (a routing pick).
    last_pick = [float("-inf")]
    passes = [None]

    def route_state() -> tuple:
        active = fabric.active
        return (None if active is None else active.index,
                tuple(slot.state for slot in fabric.slots))

    async def sample() -> None:
        while True:
            now = time.perf_counter()
            timeline.append((now, tile_launches(pkg)))
            state = route_state()
            if not routing or routing[-1][1:] != state:
                routing.append((round(now - t0, 2), *state))
            moved = tuple(sl._pass for sl in fabric.slots)
            if moved != passes[0]:
                passes[0], last_pick[0] = moved, now
            await asyncio.sleep(0.1)

    def where() -> str:
        """The session's line with the fabric's routing state."""
        return (f"{stats.summary()} | failovers {fabric.failovers} | "
                f"dispatch_log {fabric.dispatch_log[-12:]} | slots "
                f"{[(sl.state, sl.inflight, sl._pass) for sl in fabric.slots]}"
                f" | routing {routing[-12:]}")

    sampler = asyncio.create_task(sample())

    async def mute_a(must_fail_over: bool) -> dict:
        """Mute A and mine :data:`FABRIC_POST_MUTE_S`; with
        ``must_fail_over``, on until the stall rule has degraded A, a
        failover moved the dispatcher and a watchdog tick has seen it."""
        n0 = len(fabric.dispatch_log)
        switch = []

        def switched() -> bool:
            if not switch and any(i != slot_a.index
                                  for _g, i in fabric.dispatch_log[n0:]):
                switch.append(time.perf_counter())
            return bool(switch)

        failovers0 = fabric.failovers
        out = {"mute_at_s": round(time.perf_counter() - t0, 2),
               "a_owned_dispatcher_at_mute": fabric.active is slot_a,
               "accepted_on_A_before_mute": sum(sh.accepted
                                                for sh in a.shares)}
        a.mute = True
        t_mute = time.perf_counter()

        def done() -> bool:
            now = time.perf_counter()
            moved = switched()
            if now - t_mute < FABRIC_POST_MUTE_S:
                return False
            return not must_fail_over or (
                moved and now - switch[0] >= 2.0
                and slot_a.state == "degraded"
                and fabric.failovers > failovers0)

        await until(task, done, "the failover after the mute"
                    if must_fail_over else "the mute's window", where,
                    FABRIC_POST_MUTE_S + 45)
        t_end = time.perf_counter()
        return {**out, "t_mute": t_mute, "t_end": t_end,
                "slot_a_state": slot_a.state,
                "failovers": fabric.failovers - failovers0,
                "seconds_mute_to_other_slot":
                    switch[0] - t_mute if switch else None,
                "dispatch_log_slots": [i for _g, i
                                       in fabric.dispatch_log[n0:]]}

    out = {}
    t0 = time.perf_counter()
    try:
        await until(task, lambda: any(sh.accepted for sh in a.shares),
                    "a first share accepted by pool A", where, 120)
        t_first = time.perf_counter()
        await until(task, lambda: time.perf_counter() - t_first
                    >= FABRIC_PRE_MUTE_S, "pre-mute window", where,
                    FABRIC_PRE_MUTE_S + 60)
        def a_keeps_the_dispatcher() -> bool:
            """A owns the dispatcher, its pool answered a submit in the
            last 2 s (A's shares flow: the previous owner's requests have
            drained), the last routing pick was at most 6 s ago, and the
            next one falls to A too (the live slot with the lowest stride
            pass, ties to the lower index). Muted now, A leaves a submit
            unanswered within ~2 s, and the quantum after next finds it
            past the 10 s stall bound while A still owns the dispatcher."""
            live = [sl for sl in fabric.slots if sl.live]
            if fabric.active is not slot_a or not live:
                return False
            nxt = min(live, key=lambda sl: (sl._pass, sl.index))
            answered = slot_a.last_verdict_t
            return (nxt is slot_a and answered is not None
                    and time.monotonic() - answered <= 2.0
                    and time.perf_counter() - last_pick[0] <= 6.0)

        if not fixed_mute:
            await until(task, a_keeps_the_dispatcher,
                        "pool A owning the dispatcher for the next quantum"
                        " too", where, FABRIC_WAIT_ACTIVE_S)
        muted = await mute_a(must_fail_over=not fixed_mute)
        code, body = await http_get(port, "/healthz")
        health = json.loads(body)
        # 503 when a component reads stalled: a muted pool's pending
        # submits can make the session's `pool` rule read so.
        assert code == (503 if health["status"] == "stalled" else 200), (
            code, health)
        assert "pools" in health["components"], health
        out["healthz_status"] = health["status"]
        out["healthz_pools"] = health["components"]["pools"]
        code, body = await http_get(port, "/telemetry")
        out["telemetry_pool_fabric_active"] = json.loads(
            body)["pool_fabric"]["active"]
        out["fabric_snapshot"] = fabric.snapshot()
    finally:
        sampler.cancel()
        await asyncio.gather(sampler, return_exceptions=True)
        miner.stop()
        await asyncio.gather(task, return_exceptions=True)
        for server in (a, b, node):
            await server.stop()
        tel.flightrec.disarm()
    task.result()

    def rate(t_from: float, t_to: float) -> float:
        pts = [(t, n) for t, n in timeline if t_from <= t <= t_to]
        return (pts[-1][1] - pts[0][1]) * hasher.batch_size / (
            pts[-1][0] - pts[0][0]) / 1e6

    def idle(t_from: float, t_to: float) -> float:
        """Seconds between two samples with no launch between."""
        return sum(t_b - t_a for (t_a, n_a), (t_b, n_b)
                   in zip(timeline, timeline[1:])
                   if t_from <= t_a and t_b <= t_to and n_b == n_a)

    def window(mute: dict) -> dict:
        t_mute, t_end = mute.pop("t_mute"), mute.pop("t_end")
        quiet = idle(t_mute, t_end)
        return {**mute, "mhs_after_mute": rate(t_mute, t_end),
                "seconds_after_mute": t_end - t_mute,
                "seconds_without_launch_after_mute": quiet,
                "idle_share_after_mute": quiet / (t_end - t_mute)}

    t_mute = muted["t_mute"]
    muted = window(muted)
    assert a.shares, "pool A saw no share before the mute"
    for pool in (a, b):
        assert all(sh.accepted for sh in pool.shares), [
            sh.reason for sh in pool.shares if not sh.accepted]
        assert all(sh.job_id in pool.jobs for sh in pool.shares)
    node_rejects = {blk.reason for blk in node.blocks if not blk.accepted}
    assert node_rejects <= {"inconclusive-not-best-prevblk"}, node_rejects
    assert stats.hw_errors == 0 and stats.shares_rejected == 0, (
        stats.summary())
    if not fixed_mute:
        assert slot_a.state == "degraded" and muted["failovers"] >= 1
    failover = {k[0]: c.value for k, c in tel.pool_failover.children()}
    drops = {k[0]: c.value for k, c in tel.stale_drops.children()}
    slots = {s["label"]: s for s in out.pop("fabric_snapshot")["slots"]}
    return {**out, **muted,
            "accepted_per_pool": {"A": sum(sh.accepted for sh in a.shares),
                                  "B": sum(sh.accepted for sh in b.shares)},
            "validator_accepted_share": {
                name: sum(sh.accepted for sh in pool.shares)
                / len(pool.shares) if pool.shares else None
                for name, pool in (("A", a), ("B", b))},
            "blocks_accepted_by_node": sum(blk.accepted
                                           for blk in node.blocks),
            "blocks_stale_tip": len(node.blocks) - sum(
                blk.accepted for blk in node.blocks),
            "pool_failover": failover,
            "routing": routing,
            "slot_states": {label: slot["state"]
                            for label, slot in slots.items()},
            "slot_windows": {label: slot["window"]
                             for label, slot in slots.items()},
            "mhs_before_mute": rate(t_first, t_mute),
            "seconds_before_mute": t_mute - t_first,
            "stale_drops": drops, "requests": stats.batches,
            "mean_request_nonces": stats.hashes / max(1, stats.batches),
            "stale_request_share": drops.get("result", 0.0)
                / max(1, stats.batches),
            "shares_stale": stats.shares_stale,
            "stale_unroutable": fabric.stale_unroutable,
            "hw_errors": stats.hw_errors,
            "phase_seconds": time.perf_counter() - t0}


async def fabric_vshare(pkg) -> dict:
    """Two pools as ``--pool stratum+tcp://A --pool stratum+tcp://B
    --workers 4 --vshare 2`` builds them (``cli.make_miner``), the routing
    defaults: A grants :data:`VERSION_MASK`, B no mask, so A's jobs run the
    K=2 tile kernel and B's its degraded K=1 build, switched by
    ``Dispatcher.set_job`` → ``set_version_mask`` at each route change. It
    mines :data:`FABRIC_VSHARE_S` and until each slot has owned the
    dispatcher and A has accepted sibling shares; the launches are
    attributed to the slot owning the dispatcher when they are read
    (every 0.05 s)."""
    a, b = await fabric_pools(pkg, mask_a=VERSION_MASK)
    args = cli_args(pkg, [
        "--pool", f"stratum+tcp://127.0.0.1:{a.port}",
        "--pool", f"stratum+tcp://127.0.0.1:{b.port}", "--user", "smoke",
        "--workers", "4", "--vshare", "2"])
    miner = pkg.cli.make_miner(args)
    assert isinstance(miner, pkg.MultipoolMiner), miner
    fabric = miner.fabric
    stats = miner.dispatcher.stats
    task = asyncio.create_task(miner.run())
    per_slot = {0: {"k1": 0, "k2": 0}, 1: {"k1": 0, "k2": 0}}
    last = [0, 0]

    def counts() -> tuple:
        k = {c.name: c.value for c in pkg.csrc.counters()}
        return k.get("scan_tile", 0), k.get("scan_tile_k2", 0)

    def attribute() -> None:
        k1, k2 = counts()
        active = fabric.active
        if active is not None:
            per_slot[active.index]["k1"] += k1 - last[0]
            per_slot[active.index]["k2"] += k2 - last[1]
        last[:] = [k1, k2]

    def siblings(pool) -> int:
        return sum(1 for sh in pool.shares
                   if sh.accepted and sh.version_bits)

    def done() -> bool:
        attribute()
        return (time.perf_counter() - t0 >= FABRIC_VSHARE_S
                and {i for _g, i in fabric.dispatch_log} == {0, 1}
                and siblings(a) >= 1 and sum(sh.accepted for sh in b.shares))

    t0 = time.perf_counter()
    try:
        await until(task, done, "both slots served, siblings on A",
                    stats.summary, FABRIC_VSHARE_S + 60)
    finally:
        miner.stop()
        await asyncio.gather(task, return_exceptions=True)
        await a.stop()
        await b.stop()
    task.result()
    for pool, mask in ((a, VERSION_MASK), (b, 0)):
        assert pool.shares and all(sh.accepted for sh in pool.shares), [
            sh.reason for sh in pool.shares if not sh.accepted]
        assert all(sh.version_bits is None if not mask else
                   sh.version_bits & ~mask == 0 for sh in pool.shares)
    assert per_slot[0]["k2"] > 0 and per_slot[1]["k1"] > 0, per_slot
    assert stats.hw_errors == 0, stats.summary()
    return {"accepted_per_pool": {"A": sum(sh.accepted for sh in a.shares),
                                  "B": sum(sh.accepted for sh in b.shares)},
            "sibling_accepted_A": siblings(a),
            "chain0_accepted_A": sum(1 for sh in a.shares
                                     if sh.accepted and not sh.version_bits),
            "sibling_version_bits_A": sorted({
                f"{sh.version_bits:#010x}" for sh in a.shares
                if sh.version_bits}),
            "version_bits_B": sorted({str(sh.version_bits)
                                      for sh in b.shares}),
            "launches_by_active_slot": {"A": per_slot[0], "B": per_slot[1]},
            "dispatch_log_slots": [i for _g, i in fabric.dispatch_log],
            "hw_errors": stats.hw_errors,
            "seconds": time.perf_counter() - t0}


async def federated_stratum(pkg, worker: "Worker", worker_status: int
                            ) -> dict:
    """A Stratum session as ``--pool URL --workers 4 --worker
    HOST:PORT@STATUSPORT --status-port P --health-interval 1`` builds it
    and ``cli.run_session`` runs it, on the served ``worker``, against
    the mock pool at difficulty 1/256. After 3 accepted shares the
    parent's ``/query`` must hold the worker's series (its ``scan_batch``
    count) under ``worker=HOST:PORT``, and the worker's own ``/query``
    and ``/slo`` must answer."""
    pool = await smoke_pool(pkg)
    port = free_port()
    args = cli_args(pkg, [
        "--pool", f"stratum+tcp://127.0.0.1:{pool.port}", "--user", "smoke",
        "--workers", "4", "--worker", f"{worker.target}@{worker_status}",
        "--status-port", str(port), "--health-interval", "1"])
    pkg.pipeline.set_telemetry(None)
    miner = pkg.cli.make_miner(args)
    dispatcher = miner.dispatcher
    fleet = dispatcher.hasher
    assert fleet.scrape_targets() == [
        (worker.target, f"http://127.0.0.1:{worker_status}/metrics")]
    stats = dispatcher.stats
    task = asyncio.create_task(pkg.cli.run_session(miner, args))
    out = {}
    try:
        await until(task, lambda: stats.shares_accepted >= 3,
                    "3 accepted shares", stats.summary, 240)
        deadline = time.perf_counter() + 60
        while True:
            code, body = await http_get(port, f"/query?worker={worker.target}")
            series = json.loads(body)["series"]
            names = sorted({x["name"] for x in series})
            if "tpu_miner_scan_batch_seconds_count" in names:
                break
            assert time.perf_counter() < deadline, names
            await asyncio.sleep(0.5)
        processes = {x["labels"]["process"] for x in series}
        assert processes == {f"worker-{worker.target}"}, processes
        out["parent_worker_series"] = len(series)
        code, body = await http_get(worker_status, "/query?process=parent")
        own = json.loads(body)
        assert code == 200 and own["series"], own
        out["worker_own_series"] = len(own["series"])
        code, body = await http_get(worker_status, "/slo")
        assert code == 200 and json.loads(body)["schema"] == \
            "tpu-miner-slo/1", body[:200]
        code, body = await http_get(port, "/metrics")
        scrapes = {k: v for k, v in prom_samples(body.decode()).items()
                   if k[0] == "tpu_miner_federate_scrapes_total"}
        assert scrapes.get(("tpu_miner_federate_scrapes_total", (
            ("result", "ok"), ("target", f"worker-{worker.target}")))), (
            scrapes)
        out["federate_scrapes"] = {"/".join(v for _, v in k[1]): n
                                   for k, n in scrapes.items()}
    finally:
        miner.stop()
        await asyncio.gather(task, return_exceptions=True)
        await pool.stop()
        fleet.close()
    rejected = [sh.reason for sh in pool.shares if not sh.accepted]
    assert not rejected and stats.shares_rejected == 0, rejected
    assert stats.hw_errors == 0, stats.summary()
    return {**out, "accepted": stats.shares_accepted}


def perf_roundtrip(pkg, rows: list, card) -> dict:
    """The ``perf`` subcommand through ``cli.main``, every ledger in
    :func:`out_dir`: ``proxy``; ``record`` of ``rows``, whose fingerprint
    must name ``card`` (``nvidia-smi``'s name and power limit); ``report``;
    ``gate`` of each ledger against itself (passes); ``capture`` refusing
    a bench option it sets itself (``--profile``), with its reason (the
    ``perf_capture`` phase runs it)."""
    proxy = os.path.join(out_dir(), "perf_proxy.jsonl")
    ledger = os.path.join(out_dir(), "perf_run.jsonl")
    evidence = os.path.join(out_dir(), "dispatcher_sweep.jsonl")
    with open(evidence, "w") as f:
        f.writelines(json.dumps(row) + "\n" for row in rows)

    def perf(*argv):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = pkg.cli.main(["perf", *argv])
        return rc, out.getvalue(), err.getvalue()

    rc, proxy_out, _ = perf("proxy", "--repeats", "2", "--json",
                            "--ledger", proxy)
    assert rc == 0, proxy_out
    best = json.loads(proxy_out[:proxy_out.rindex("appended")])["best"]
    rc, out, _ = perf("record", "--from", evidence, "--ledger", ledger,
                      "--platform", "cuda")
    assert rc == 0 and f"recorded {len(rows)} row(s)" in out, out
    with open(ledger) as f:
        recorded = [json.loads(line) for line in f]
    cards = {row["fingerprint"].get("card") for row in recorded}
    assert rows and cards == {card}, (cards, card)
    assert {row["fingerprint"]["platform"] for row in recorded} == {"cuda"}
    assert not {"jax", "jaxlib", "libtpu"} & set(recorded[0]["fingerprint"])
    rc, report, _ = perf("report", "--ledger", ledger)
    assert rc == 0 and report.count(rows[0]["metric"]) == len(rows), report
    gates = {}
    for name, path in (("sweep", ledger), ("proxy", proxy)):
        rc, gate, _ = perf("gate", "--ledger", path, "--baseline", path)
        assert rc == 0 and "gate: ok" in gate, gate
        gates[name] = gate.strip().splitlines()[-1]
    capture_root = os.path.join(out_dir(), "capture_refused")
    rc, _, err = perf("capture", "--out", capture_root, "--", "--profile",
                      capture_root)
    assert rc == 2 and "--profile" in err, (rc, err)
    assert not os.path.exists(capture_root), capture_root
    return {"proxy_best_s": best,
            "proxy_sweep_telemetry_on_vs_off":
                best["dispatcher_sweep"] / best["dispatcher_sweep_notel"],
            "recorded": [{"backend": row["backend"], "value": row["value"],
                          "unit": row["unit"],
                          "card": row["fingerprint"].get("card")}
                         for row in recorded],
            "report": report.strip().splitlines(), "gates": gates,
            "capture_rc": rc, "capture_refusal": err.strip()}


def run_bench_child(env: dict = None) -> tuple:
    """``python -m bitcoin_miner_tpu_torch.bench`` with its defaults as a
    child of the checkout (the supervisor, whose own child sweeps on the
    card): (rc, its standard output's lines, the end of its standard
    error)."""
    proc = subprocess.run(
        [sys.executable, "-m", "bitcoin_miner_tpu_torch.bench"],
        capture_output=True, text=True, timeout=BENCH_TIMEOUT_S,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, **(env or {})))
    return (proc.returncode, proc.stdout.strip().splitlines(),
            proc.stderr[-2000:])


def one_json_line(rc: int, lines: list, err: str) -> dict:
    """The one line of a bench's standard output, as JSON."""
    assert len(lines) == 1, (rc, lines, err)
    return json.loads(lines[0])


def bench_json(card: str, sweep_mhs: float) -> dict:
    """The bench as a user runs it, twice at once: on the card, where it
    must print one line (rc 0, ``cuda-tile``, ``device`` the card's name,
    the genesis nonce verified, one ``scan_tile`` launch per 2^24 nonces
    and a rescan at most per dispatch, a ``pipeline`` block without
    ``error``), and with the card hidden (``CUDA_VISIBLE_DEVICES=""``),
    where it must print one line with ``value`` 0 and rc 1, never a host
    backend's number. ``value`` against the same call's ``genesis_sweep``
    rate (``sweep_mhs``), the same measurement: printed, not gated."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        card_run = pool.submit(run_bench_child)
        hidden_run = pool.submit(run_bench_child,
                                 {"CUDA_VISIBLE_DEVICES": ""})
        rc, lines, err = card_run.result()
        hidden = hidden_run.result()
    line = one_json_line(rc, lines, err)
    assert rc == 0 and line["value"] > 0, (rc, line, err)
    assert line["backend"] == "cuda-tile" and line["device"] == card, line
    assert line["verified"] is True and "error" not in line, line
    assert "error" not in line["pipeline"], line["pipeline"]
    launches = line["launches"]
    assert launches["scan_tile"] == (1 << 32) // DISPATCH, launches
    assert 0 < launches.get("rescan_steps", 0) <= launches["scan_tile"], (
        launches)
    assert launches.keys() <= {"scan_tile", "rescan_steps"}, launches
    for key in ("vs_baseline", "best_measured_tpu", "pool"):
        assert key not in line, line
    no_card = one_json_line(*hidden)
    assert hidden[0] == 1 and no_card["value"] == 0, hidden
    assert "native" not in no_card["backend"] and "error" in no_card, hidden
    return {"line": line, "value_vs_genesis_sweep": line["value"] / sweep_mhs
            if sweep_mhs else None, "genesis_sweep_mhs": sweep_mhs,
            "hidden_card": {"rc": hidden[0], "line": no_card}}


def perf_capture(pkg, bench_line: dict) -> dict:
    """``perf capture --out D --ledger L`` with the default bench, through
    ``cli.main``, D and L in :func:`out_dir`: rc 0 and ``ok``, the
    manifest without errors and keyed to the ledger's one row, the trace
    report's ``scan_tile`` launches the bench's (one per 2^24 nonces: the
    profiler sees kernels launched through ``ctypes``) and its
    ``rescan_steps`` launches the bench's too. Prints the kernel families,
    the card's busy share, the five longest gaps with what the host did,
    and the rate under the profiler against ``bench_json``'s
    (``bench_line``)."""
    root = os.path.join(out_dir(), "capture")
    ledger = os.path.join(root, "ledger.jsonl")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = pkg.cli.main(["perf", "capture", "--out", root, "--ledger",
                           ledger, "--bench-timeout", str(BENCH_TIMEOUT_S)])
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and summary["metric"] == "window_capture" and summary[
        "ok"], (rc, summary)
    with open(summary["manifest"]) as f:
        manifest = json.load(f)
    assert manifest["schema"] == "tpu-miner-capture/1", manifest
    assert manifest["errors"] == [], manifest["errors"]
    with open(ledger) as f:
        rows = [json.loads(line) for line in f]
    assert [row["id"] for row in rows] == [manifest["ledger_id"]], rows
    assert rows[0]["fingerprint"]["platform"] == "cuda", rows[0]
    bench, report = manifest["bench"], manifest["trace_report"]
    families = report["device"]["families"]
    launches = bench["launches"]
    assert families["scan_tile"]["launches"] == launches["scan_tile"] == (
        1 << 32) // DISPATCH, (families, launches)
    assert families["rescan_steps"]["launches"] == launches[
        "rescan_steps"], (families, launches)
    assert report["device_name"] == bench["device"], report
    return {"ledger_id": manifest["ledger_id"],
            "artifacts": sorted(manifest["artifacts"]),
            "mhs": bench["value"],
            "mhs_vs_bench_json": bench["value"] / bench_line["value"]
            if bench_line else None,
            "window_ms": report["window_ms"],
            "busy_share": report["device"]["busy_share"],
            "busy_share_of_span": report["device"]["busy_share_of_span"],
            "families": families, "gaps": report["device"]["gaps"],
            "host_annotations": report["host_annotations"]}


def validator_parity(pkg, n: int) -> dict:
    """``n`` seeded submits, every verdict class among them, through the
    frontend's hashlib validator and its native one: the same verdict and
    hash each time. Returns the verdict counts."""
    import random

    ps = pkg.poolserver
    server = ps.StratumPoolServer(
        difficulty=2.0 ** -31, native_validation=True,
        telemetry=pkg.pipeline.PipelineTelemetry())
    assert server.native_active
    session = ps.ClientSession(next(server._ids), "smoke", writer=None)
    assert not server._handle_subscribe(session, 0).get("error")
    session.username, session.difficulty = "smoke", server.difficulty
    job = ps.LocalTemplateSource().next_job()
    asyncio.run(server.set_job(job))
    rng = random.Random(15)
    counts: dict = {}
    for _ in range(n):
        kind = rng.randrange(10)
        job_id = "gone" if kind == 0 else job.job_id
        size = session.extranonce2_size + (kind == 1)
        e2 = rng.getrandbits(8 * size).to_bytes(size, "little")
        nonce = rng.getrandbits(32)
        bits = 0x2000 if kind == 2 else None
        if kind == 3:
            session.seen_shares.add((job_id, e2, job.ntime, nonce, None))
        args = (session, job_id, e2, job.ntime, nonce, bits)
        want, got = server._validate(*args), server._validate_native(*args)
        assert got[:2] == want[:2], (args[1:], want, got)
        counts[want[0]] = counts.get(want[0], 0) + 1
    assert set(counts) == {"accepted", "low_difficulty", "stale",
                           "bad_extranonce2", "version_bits",
                           "duplicate"}, counts
    return counts


def window_quantile(hist, before: list, q: float):
    """The upper bound of the bucket holding quantile ``q`` of what
    ``hist`` observed since its cumulative counts were ``before``; None
    when it observed nothing."""
    delta = [a - b for a, b in zip(hist.cumulative_counts(), before)]
    if not delta or not delta[-1]:
        return None
    for bound, c in zip((*hist.bounds, float("inf")), delta):
        if c >= q * delta[-1]:
            return bound
    return None


async def downstream_session(port: int, user: str, on_reply=None):
    """A downstream session that subscribes, authorizes and reads every
    line the frontend sends (``on_reply`` sees each reply to a request
    id of 100 or more). Returns its writer and its reading task."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    for msg in ({"id": 1, "method": "mining.subscribe", "params": []},
                {"id": 2, "method": "mining.authorize",
                 "params": [user, "x"]}):
        writer.write((json.dumps(msg) + "\n").encode())

    async def read():
        while True:
            line = await reader.readline()
            if not line:
                return
            msg = json.loads(line)
            if (on_reply is not None and isinstance(msg.get("id"), int)
                    and msg["id"] >= 100):
                on_reply(msg)

    return writer, asyncio.create_task(read())


async def close_sessions(sessions) -> None:
    for writer, reading in sessions:
        writer.close()
        reading.cancel()
    await asyncio.gather(*(r for _, r in sessions), return_exceptions=True)


async def junk_fleet(server, n: int, seconds: int, at_end) -> dict:
    """``n`` downstream sessions on ``server``: each subscribes,
    authorizes, then submits one junk share (a random nonce of the
    current job) a second for ``seconds`` s, reading every line the
    frontend sends. ``at_end`` is awaited while they are still connected.
    Returns the replies they read."""
    import random

    rng = random.Random(256)
    replies = {"accepted": 0, "rejected": 0}

    def on_reply(msg) -> None:
        replies["accepted" if msg.get("result") else "rejected"] += 1

    async def client(i: int):
        await asyncio.sleep(i / n)  # spread over the first second
        writer, reading = await downstream_session(server.port, f"junk{i}",
                                                   on_reply)
        for k in range(seconds):
            job = server.current_job
            e2 = ((i << 8) + k).to_bytes(server.session_extranonce2_size,
                                         "little")
            writer.write((json.dumps({
                "id": 100 + k, "method": "mining.submit", "params": [
                    f"junk{i}", job.job_id, e2.hex(), f"{job.ntime:08x}",
                    f"{rng.getrandbits(32):08x}"]}) + "\n").encode())
            await asyncio.sleep(1.0)
        return writer, reading

    clients = await asyncio.gather(*(client(i) for i in range(n)))
    out = await at_end()
    await close_sessions(clients)
    return {**out, "replies": replies}


async def frontend_internal(pkg) -> dict:
    """``--serve-pool 127.0.0.1:0 --internal-worker --workers 4
    --serve-difficulty 0.00390625 --serve-job-interval 5 --status-port P
    --health-interval 1 --slo-fast-window 20 --slo-slow-window 40``, built
    by ``cli.make_frontend`` and run by ``cli.run_session``, on a fresh
    telemetry bundle: local templates, the tile hasher on the card behind
    the frontend's native validator. One idle downstream session stays
    connected throughout (``frontend-claimed-work`` reads the claimed work
    per connected session; the 20 s fast window holds the 4 job broadcasts
    ``job-broadcast`` needs). After the first share it mines a
    :data:`FRONTEND_WINDOW_S` window (the rate from its dispatcher's
    hashes and from the tile launches, the validation quantiles,
    ``/healthz``), then :func:`junk_fleet` loads the event loop with
    :data:`FRONTEND_CLIENTS` sessions for :data:`FRONTEND_LOAD_S` s (the
    broadcast's p99 and the internal rate meanwhile, ``/healthz`` and the
    frontend objectives of ``/slo`` before they leave)."""
    status = free_port()
    args = cli_args(pkg, [
        "--serve-pool", "127.0.0.1:0", "--internal-worker", "--workers", "4",
        "--serve-difficulty", str(FRONTEND_DIFFICULTY),
        "--serve-job-interval", "5", "--status-port", str(status),
        "--health-interval", "1", "--slo-fast-window", "20",
        "--slo-slow-window", "40"],
        flightrec_out=os.path.join(out_dir(),
                                   "frontend_internal_flightrec.json"))
    tel = pkg.pipeline.set_telemetry(pkg.pipeline.PipelineTelemetry())
    frontend = pkg.cli.make_frontend(args)
    server, iw, hasher = (frontend.server, frontend.internal_worker,
                          frontend.hasher)
    assert isinstance(hasher, pkg.TileCudaHasher), hasher
    assert hasher.device.type == "cuda" and server.telemetry is tel
    assert server.native_active, "the native validator is not in force"
    stats = frontend.stats
    task = asyncio.create_task(pkg.cli.run_session(frontend, args))
    idle = []

    def mark() -> tuple:
        return (time.perf_counter(), stats.hashes, tile_launches(pkg),
                iw.session.accepted, stats.batches,
                {k[0]: c.value for k, c in tel.stale_drops.children()},
                tel.frontend_job_broadcast.count)

    def rates(a, b) -> dict:
        """The window's rates. The dispatcher's hashes include the
        results a job switch made stale, so the useful rate is the
        accepted shares against the ``expected_per_s`` those hashes find
        at the session's difficulty. A result dropped at a switch was a
        request in flight at the scheduler's steady size (its last
        ``request_nonces``): ``stale_hash_share`` estimates the hashes
        lost so."""
        window = b[0] - a[0]
        hashes = b[1] - a[1]
        expected = hashes / window / (2 ** 32 * FRONTEND_DIFFICULTY)
        drops = {k: v - a[5].get(k, 0) for k, v in b[5].items()}
        request = tel.batch_nonces.value
        return {"window_seconds": window, "window_launches": b[2] - a[2],
                "mhs_dispatcher_hashes": hashes / window / 1e6,
                "mhs": (b[2] - a[2]) * hasher.batch_size / window / 1e6,
                "accepted_per_s": (b[3] - a[3]) / window,
                "expected_per_s": expected,
                "accepted_vs_expected": (b[3] - a[3]) / window / expected,
                "job_switches": b[6] - a[6], "results": b[4] - a[4],
                "stale_drops": drops, "request_nonces": request,
                "stale_hash_share": drops.get("result", 0) * request
                / max(hashes, 1)}

    async def surfaces() -> dict:
        code, body = await http_get(status, "/healthz")
        health = json.loads(body)
        code_slo, body_slo = await http_get(status, "/slo")
        objectives = {o["name"]: o["state"]
                      for o in json.loads(body_slo)["objectives"]}
        return {"healthz_code": code,
                "healthz_frontend": health["components"].get("frontend"),
                "slo": {name: objectives[name] for name in (
                    "job-broadcast", "frontend-validate",
                    "frontend-claimed-work")}}

    try:
        await until(task, lambda: server.port, "the listener", stats.summary,
                    60)
        idle.append(await downstream_session(server.port, "idle"))
        await until(task, lambda: iw.session.accepted >= 1, "the first share",
                    stats.summary, 240)
        a = mark()
        await until(task, lambda: time.perf_counter() - a[0]
                    >= FRONTEND_WINDOW_S, "window", stats.summary,
                    FRONTEND_WINDOW_S + 60)
        b = mark()
        out = {**rates(a, b), "accepted_in_window": b[3] - a[3],
               "validate_ms": {
                   "p50": tel.frontend_validate.quantile(0.5) * 1e3,
                   "p99": tel.frontend_validate.quantile(0.99) * 1e3},
               **await surfaces()}
        broadcast_before = tel.frontend_job_broadcast.cumulative_counts()
        verdicts_before = {k[0]: c.value
                           for k, c in tel.frontend_shares.children()}
        c = mark()

        async def at_end():
            return {**rates(c, mark()), **await surfaces()}

        load = await junk_fleet(server, FRONTEND_CLIENTS, FRONTEND_LOAD_S,
                                at_end)
        p99 = window_quantile(tel.frontend_job_broadcast, broadcast_before,
                              0.99)
        load.update({
            "sessions": FRONTEND_CLIENTS,
            "broadcasts": tel.frontend_job_broadcast.cumulative_counts()[-1]
            - broadcast_before[-1],
            "job_broadcast_p99_bucket_ms": None if p99 is None else p99 * 1e3,
            "job_broadcast_max_ms": tel.frontend_job_broadcast.max * 1e3,
            "verdicts": {k[0]: c.value - verdicts_before.get(k[0], 0)
                         for k, c in tel.frontend_shares.children()}})
        out["load"] = load
    finally:
        await close_sessions(idle)
        frontend.stop()
        await asyncio.gather(task, return_exceptions=True)
        tel.flightrec.disarm()
    task.result()
    assert iw.session.accepted >= 100, iw.session.accepted
    assert iw.session.invalid == 0 and stats.shares_rejected == 0, (
        iw.session.invalid, stats.summary())
    assert stats.hw_errors == 0, stats.summary()
    return {**out, "accepted": iw.session.accepted,
            "invalid": iw.session.invalid, "hw_errors": stats.hw_errors,
            "native_validation": server.native_active,
            "validate_count": tel.frontend_validate.count,
            "validate_ms_p99_run": tel.frontend_validate.quantile(0.99) * 1e3}


async def frontend_proxy(pkg) -> dict:
    """The port's validating mock pool at difficulty 1/256 ← ``--serve-pool
    127.0.0.1:0 --upstream stratum+tcp://POOL --internal-worker --workers
    4`` ← a downstream ``StratumMiner`` as ``--pool stratum+tcp://FRONTEND
    --workers 4`` builds it: two tile hashers on one card. After both have
    shares they mine :data:`FRONTEND_PROXY_S` s; then the internal worker
    stops and the miner's submits are held (:class:`AcceptedWork`), and
    once every forward is answered the pool's accepted count must equal
    the proxy's forwards and upstream accepts. Every share valid at the
    pool, in one of the two sessions' disjoint slices, none twice."""
    pool = pkg.MockStratumPool(difficulty=FRONTEND_DIFFICULTY)
    await pool.start()
    await pool.announce_job(fabric_pool_job(pkg, "proxy-1"))
    args = cli_args(pkg, [
        "--serve-pool", "127.0.0.1:0", "--upstream",
        f"stratum+tcp://127.0.0.1:{pool.port}", "--internal-worker",
        "--workers", "4", "--status-port", str(free_port()),
        "--health-interval", "1"],
        flightrec_out=os.path.join(out_dir(), "frontend_proxy_flightrec.json"))
    tel = pkg.pipeline.set_telemetry(pkg.pipeline.PipelineTelemetry())
    frontend = pkg.cli.make_frontend(args)
    server, proxy, iw = frontend.server, frontend.proxy, \
        frontend.internal_worker
    istats = frontend.stats
    ftask = asyncio.create_task(pkg.cli.run_session(frontend, args))
    miner = mtask = None

    def pool_accepted() -> int:
        return sum(1 for sh in pool.shares if sh.accepted)

    try:
        await until(ftask, lambda: server.port and server.current_job,
                    "the upstream job", istats.summary, 60)
        miner = pkg.cli.make_miner(cli_args(pkg, [
            "--pool", f"stratum+tcp://127.0.0.1:{server.port}", "--user",
            "downstream", "--workers", "4"],
            flightrec_out=os.path.join(out_dir(),
                                       "frontend_proxy_miner_flightrec.json")))
        assert miner.dispatcher.hasher.device.type == "cuda"
        mstats = miner.dispatcher.stats
        work = AcceptedWork(miner.client)
        mtask = asyncio.create_task(miner.run())
        await until(ftask, lambda: mstats.shares_accepted >= 3
                    and iw.session.accepted >= 3, "3 shares from each",
                    lambda: (istats.summary(), mstats.summary()), 240)

        def mark():
            return (time.perf_counter(), istats.hashes, mstats.hashes,
                    tile_launches(pkg))

        a = mark()
        await until(ftask, lambda: time.perf_counter() - a[0]
                    >= FRONTEND_PROXY_S, "window", istats.summary,
                    FRONTEND_PROXY_S + 60)
        b = mark()
        prefixes = {
            "internal": iw.session.extranonce1[len(pool.extranonce1):],
            "downstream": next(
                s for s in server.sessions.values()
                if not s.internal).extranonce1[len(pool.extranonce1):]}

        async def answered() -> dict:
            await until(ftask, lambda: proxy.forwarded
                        == proxy.upstream_accepted + proxy.upstream_rejected
                        == pool_accepted() + sum(
                            1 for sh in pool.shares if not sh.accepted),
                        "every forward answered",
                        lambda: (proxy.forwarded, proxy.upstream_accepted,
                                 len(pool.shares)), 30)
            return {"pool_accepted": pool_accepted(),
                    "pool_rejected": len(pool.shares) - pool_accepted(),
                    "forwarded": proxy.forwarded,
                    "upstream_accepted": proxy.upstream_accepted,
                    "upstream_rejected": proxy.upstream_rejected}

        # The internal worker stops and the downstream miner's new submits
        # are held, both sessions open, while the counts are read: at
        # hundreds of shares a second a moment with no forward in flight
        # may not come while both mine.
        iw.dispatcher.stop()
        counts = await work.settled(answered)
    finally:
        if miner is not None:
            miner.stop()
            await asyncio.gather(mtask, return_exceptions=True)
        frontend.stop()
        await asyncio.gather(ftask, return_exceptions=True)
        await pool.stop()
        tel.flightrec.disarm()
    ftask.result()
    assert counts["pool_rejected"] == counts["upstream_rejected"] == 0, counts
    assert counts["pool_accepted"] == counts["upstream_accepted"] == \
        counts["forwarded"], counts
    assert prefixes["internal"] != prefixes["downstream"], prefixes
    by_prefix = {name: sum(1 for sh in pool.shares
                           if sh.extranonce2.startswith(p))
                 for name, p in prefixes.items()}
    assert all(by_prefix.values()) and sum(by_prefix.values()) == len(
        pool.shares), by_prefix
    keys = [(sh.job_id, sh.extranonce2, sh.ntime, sh.nonce)
            for sh in pool.shares]
    assert len(set(keys)) == len(keys), "a share reached the pool twice"
    assert istats.hw_errors == mstats.hw_errors == 0
    assert mstats.shares_rejected == 0 and iw.session.invalid == 0
    window = b[0] - a[0]
    internal = (b[1] - a[1]) / window / 1e6
    downstream = (b[2] - a[2]) / window / 1e6
    return {**counts, "shares_by_prefix": by_prefix,
            "prefixes": {k: v.hex() for k, v in prefixes.items()},
            "window_seconds": window,
            "mhs_internal": internal, "mhs_downstream": downstream,
            "mhs_sum": internal + downstream,
            "mhs": (b[3] - a[3]) * (1 << 24) / window / 1e6,
            "downstream_accepted": mstats.shares_accepted,
            "internal_accepted": iw.session.accepted}


async def frontend_fabric(pkg) -> dict:
    """Two mock pools (extranonce1 deadbeef and beadfeed, difficulty
    1/256) behind ``--serve-pool 127.0.0.1:0 --upstream A --upstream B
    --internal-worker --workers 4`` (the fabric proxy with its routing
    defaults): it mines until :data:`FRONTEND_PROXY_S` s have passed and
    each pool holds a valid share. Every share reaches the pool that
    announced its job and is valid there."""
    pools = []
    for name, e1 in (("fabric-a", "deadbeef"), ("fabric-b", "beadfeed")):
        pool = pkg.MockStratumPool(difficulty=FRONTEND_DIFFICULTY,
                                   extranonce1=bytes.fromhex(e1))
        await pool.start()
        await pool.announce_job(fabric_pool_job(pkg, name))
        pools.append(pool)
    args = cli_args(pkg, [
        "--serve-pool", "127.0.0.1:0",
        *(f for pool in pools for f in (
            "--upstream", f"stratum+tcp://127.0.0.1:{pool.port}")),
        "--internal-worker", "--workers", "4", "--health-interval", "1"],
        flightrec_out=os.path.join(out_dir(), "frontend_fabric_flightrec.json"))
    tel = pkg.pipeline.set_telemetry(pkg.pipeline.PipelineTelemetry())
    frontend = pkg.cli.make_frontend(args)
    proxy, iw, stats = frontend.proxy, frontend.internal_worker, \
        frontend.stats
    assert frontend.fabric is proxy.fabric
    task = asyncio.create_task(pkg.cli.run_session(frontend, args))
    t0 = time.perf_counter()

    def accepted(pool) -> int:
        return sum(1 for sh in pool.shares if sh.accepted)

    try:
        await until(task, lambda: time.perf_counter() - t0 >= FRONTEND_PROXY_S
                    and all(accepted(p) for p in pools),
                    "a valid share at each pool",
                    lambda: ([accepted(p) for p in pools], stats.summary()),
                    FRONTEND_PROXY_S + 90)
        seconds = time.perf_counter() - t0
        fabric = proxy.fabric.snapshot()
        log = list(proxy.fabric.dispatch_log)
    finally:
        frontend.stop()
        await asyncio.gather(task, return_exceptions=True)
        for pool in pools:
            await pool.stop()
        tel.flightrec.disarm()
    task.result()
    for pool in pools:
        assert all(sh.accepted for sh in pool.shares), [
            sh.reason for sh in pool.shares if not sh.accepted]
        assert all(sh.job_id in pool.jobs for sh in pool.shares)
    assert stats.hw_errors == 0 and iw.session.invalid == 0
    return {"seconds": seconds,
            "pool_accepted": [accepted(p) for p in pools],
            "forwarded": proxy.forwarded,
            "upstream_accepted": proxy.upstream_accepted,
            "upstream_rejected": proxy.upstream_rejected,
            "dropped_cross_upstream": proxy.dropped_cross_upstream,
            "internal_accepted": iw.session.accepted,
            "installs": len(log),
            "slot_switches": sum(1 for x, y in zip(log, log[1:])
                                 if x[1] != y[1]),
            "failovers": fabric["failovers"], "active": fabric["active"]}


def free_port_block(n: int) -> int:
    """The first of ``n`` consecutive free ports: a sharded frontend's
    status port and its children's (``status_port + 1 + i``)."""
    for _ in range(100):
        base = free_port()
        if base + n > 65536:
            continue
        socks = []
        try:
            for p in range(base, base + n):
                sock = socket.socket()
                socks.append(sock)
                sock.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for sock in socks:
                sock.close()
    raise RuntimeError(f"no block of {n} free ports")


def pid_alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie is gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rpartition(")")[2].split()[0] != "Z"
    except OSError:
        return False


def cpu_seconds(pid: int) -> tuple:
    """(user, system) CPU seconds of a live process, from /proc."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rpartition(")")[2].split()
    tick = os.sysconf("SC_CLK_TCK")
    return int(fields[11]) / tick, int(fields[12]) / tick


class Frontend:
    """``python -m bitcoin_miner_tpu_torch --serve-pool 127.0.0.1:PORT
    --serve-difficulty D --status-port S --health-interval 0.5
    [--serve-shards N]`` as a user runs it, in a process of its own (its
    shards are spawned children of that process), its log in
    :func:`out_dir`. The smoke never builds the supervisor in its own
    process: ``spawn`` would run this script again in every child. The
    phases build it with ``asyncio.to_thread``: ``Popen`` blocks."""

    def __init__(self, pkg, shards: int, difficulty: float) -> None:
        self.pkg = pkg
        self.shards = shards
        self.port = free_port()
        self.status = free_port_block(shards + 1)
        name = f"frontend_{shards}_shards_{self.port}"
        self.log_path = os.path.join(out_dir(), name + ".log")
        argv = [sys.executable, "-m", "bitcoin_miner_tpu_torch",
                "--serve-pool", f"127.0.0.1:{self.port}",
                "--serve-difficulty", repr(difficulty),
                "--status-port", str(self.status),
                "--health-interval", "0.5", "--report-interval", "5",
                "--flightrec-out",
                os.path.join(out_dir(), name + "_flightrec.json"),
                "--incident-dir", os.path.join(out_dir(), "incidents")]
        if shards > 1:
            argv += ["--serve-shards", str(shards)]
        self.pids: set = set()
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            argv, stdout=self._log, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)))

    def log_tail(self) -> str:
        with open(self.log_path) as f:
            return f.read()[-3000:]

    async def shard_view(self) -> list:
        """``/telemetry``'s ``frontend_shards``: each shard's pid, state,
        restarts and prefix range."""
        _code, body = await http_get(self.status, "/telemetry")
        view = json.loads(body)["frontend_shards"]["shards"]
        self.pids.update(s["pid"] for s in view)
        return view

    async def ready(self, seconds: float = 90.0):
        """Wait until every shard serves (one process: until the port
        accepts); returns the shard view (None for one process)."""
        deadline = time.perf_counter() + seconds
        while True:
            if self.proc.poll() is not None:
                raise RuntimeError(f"frontend exited rc {self.proc.returncode}"
                                   f": {self.log_tail()}")
            try:
                if self.shards > 1:
                    view = await self.shard_view()
                    if all(s["state"] == "serving" for s in view):
                        return view
                else:
                    _r, writer = await asyncio.open_connection(
                        "127.0.0.1", self.port)
                    writer.close()
                    code, _ = await http_get(self.status, "/healthz")
                    if code == 200:
                        return None
            except (OSError, ValueError, KeyError):
                pass
            if time.perf_counter() > deadline:
                raise TimeoutError(f"frontend not serving: {self.log_tail()}")
            await asyncio.sleep(0.1)

    async def metrics(self) -> dict:
        """The frontend's ``/metrics`` as ``{"verdicts": {shard: {result:
        n}}, "sessions": {shard: n}, "duplicate_series": [...]}`` (shard
        None for one process): no series may appear twice."""
        _code, body = await http_get(self.status, "/metrics")
        seen, dups = set(), []
        verdicts: dict = {}
        sessions: dict = {}
        for line in body.decode().splitlines():
            key = self.pkg.sample_key(line)
            if key is None:
                continue
            if key in seen:
                dups.append(line)
            seen.add(key)
            name, labels = key[0], dict(key[1])
            value = float(line.rpartition(" ")[2])
            shard = labels.get("shard")
            if self.shards > 1 and shard is None:
                continue  # the parent's own (idle) families
            if name == "tpu_miner_frontend_shares_total":
                verdicts.setdefault(shard, {})[labels["result"]] = value
            elif name == "tpu_miner_frontend_sessions":
                sessions[shard] = value
        return {"verdicts": verdicts, "sessions": sessions,
                "duplicate_series": dups}

    def validators(self) -> dict:
        """Each acceptor's share validator, from its log lines: native
        (with its backend) or the hashlib oracle."""
        out: dict = {}
        with open(self.log_path) as f:
            for line in f:
                if "native share validation" not in line:
                    continue
                shard = re.search(r" shard(\d+) ", line)
                backend = re.search(r"active \(backend: (\w+)\)", line)
                out.setdefault(shard.group(1) if shard else "frontend",
                               []).append(f"native:{backend.group(1)}"
                                          if backend else "hashlib")
        return out

    def stop(self) -> dict:
        """SIGTERM the frontend and wait for it; none of its children may
        outlive it (any left is killed, and reported)."""
        if self.proc.poll() is None:
            self.proc.terminate()
        try:
            rc = self.proc.wait(30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait(10)
        left = sorted(pid for pid in self.pids if pid_alive(pid))
        for pid in left:
            os.kill(pid, signal.SIGKILL)
        self._log.close()
        return {"rc": rc, "children_left": left}


class LaunchSampler:
    """The tile kernel's launch count sampled every 5 ms on the event
    loop: when the card was last handed work."""

    def __init__(self, pkg) -> None:
        self.pkg = pkg
        self.samples: list = []
        self._task = asyncio.create_task(self._run())

    async def _run(self) -> None:
        while True:
            self.samples.append((time.perf_counter(),
                                 tile_launches(self.pkg)))
            await asyncio.sleep(0.005)

    async def stop(self) -> None:
        self._task.cancel()
        await asyncio.gather(self._task, return_exceptions=True)

    def between(self, t0: float, t1: float) -> tuple:
        """(launches in [t0, t1], the longest stretch in it with none)."""
        inside = [(t, n) for t, n in self.samples if t0 <= t <= t1]
        if not inside:
            return 0, t1 - t0
        launches = inside[-1][1] - inside[0][1]
        longest, last_t, last_n = 0.0, t0, inside[0][1]
        for t, n in inside:
            if n != last_n:
                last_t, last_n = t, n
            longest = max(longest, t - last_t)
        return launches, max(longest, t1 - last_t)


def non_accepted(verdicts: dict) -> dict:
    """The verdicts other than accepted, summed over the shards."""
    out: dict = {}
    for by_result in verdicts.values():
        for result, n in by_result.items():
            if result != "accepted" and n:
                out[result] = out.get(result, 0) + n
    return out


class AcceptedWork:
    """Every share the pool accepted from one miner, by the header it was
    mined over: a header twice is work paid twice, whichever acceptor
    (or incarnation of one) accepted it. It wraps the miner's client's
    ``submit_share``, which the session calls for every share, and counts
    the submits awaiting their verdict (``inflight``). :meth:`settled`
    holds new submits back until none is in flight: the moment at which
    the pool's counts and the miner's must agree."""

    def __init__(self, client) -> None:
        self.headers: dict = {}
        self.inflight = 0
        self.held: list = []  # seconds each settle held the submits back
        self._open = asyncio.Event()
        self._open.set()
        submit = client.submit_share

        async def counted(share):
            await self._open.wait()
            self.inflight += 1
            try:
                ok = await submit(share)
            finally:
                # The session counts the verdict in this same step.
                self.inflight -= 1
            if ok:
                self.headers[share.header80] = self.headers.get(
                    share.header80, 0) + 1
            return ok

        client.submit_share = counted

    def twice(self) -> list:
        return [h.hex() for h, n in self.headers.items() if n > 1]

    async def settled(self, read, seconds: float = 60.0):
        """``await read()`` with the miner's new submits held back and
        every earlier one answered (a submit waits for its verdict at most
        the client's request timeout); then the submits go on."""
        self._open.clear()
        t0 = time.perf_counter()
        try:
            while self.inflight:
                assert time.perf_counter() < t0 + seconds, (
                    f"{self.inflight} submits still in flight")
                await asyncio.sleep(0.005)
            return await read()
        finally:
            self._open.set()
            self.held.append(time.perf_counter() - t0)


async def frontend_shards(pkg, tile_ms: float) -> tuple:
    """``--serve-pool 127.0.0.1:PORT --serve-shards 2 --serve-difficulty
    0.00390625 --status-port S --health-interval 0.5`` in its own process
    (local templates, each child probing the native validator), and one
    downstream miner on the card as ``--pool stratum+tcp://127.0.0.1:PORT
    --workers 4`` builds it. ``SO_REUSEPORT`` puts its one session on one
    shard, which ``_shard_of`` names from its extranonce1. After 3 shares
    it mines :data:`SHARD_WINDOW_S` s: its rate, the frontend's verdicts
    per shard with the miner's submits held until none is in flight
    (:meth:`AcceptedWork.settled`), the session's prefix
    inside its shard's range, ``/healthz``'s ``frontend_shard``, the
    parent's ``/metrics`` (both shards' samples, no series twice) and
    each child's validator. Then it SIGKILLs that shard
    (:func:`shard_kill`). Returns (session, kill); kill is the exception
    that failed it, if one did."""
    frontend = await asyncio.to_thread(
        Frontend, pkg, SHARDS, FRONTEND_DIFFICULTY)
    tel = pkg.pipeline.set_telemetry(pkg.pipeline.PipelineTelemetry())
    miner = task = None
    try:
        view = await frontend.ready()
        miner = pkg.cli.make_miner(cli_args(pkg, [
            "--pool", f"stratum+tcp://127.0.0.1:{frontend.port}", "--user",
            "shards", "--workers", "4"],
            flightrec_out=os.path.join(out_dir(),
                                       "frontend_shards_flightrec.json")))
        hasher = miner.dispatcher.hasher
        assert isinstance(hasher, pkg.TileCudaHasher), hasher
        assert hasher.device.type == "cuda", hasher.device
        stats = miner.dispatcher.stats
        work = AcceptedWork(miner.client)
        task = asyncio.create_task(miner.run())
        await until(task, lambda: stats.shares_accepted >= 3,
                    "3 accepted shares", stats.summary, 240)

        def mark():
            return time.perf_counter(), tile_launches(pkg), stats.hashes

        a = mark()
        await until(task, lambda: time.perf_counter() - a[0]
                    >= SHARD_WINDOW_S, "window", stats.summary,
                    SHARD_WINDOW_S + 60)
        b = mark()
        e1 = miner.client.extranonce1
        shard = pkg.load_probe._shard_of(e1, 2, SHARDS)
        prefix = int.from_bytes(e1[-2:], "big")
        lo, hi = view[shard]["prefix_range"]
        assert lo <= prefix < hi, (e1.hex(), view)
        # With no submit in flight, the shard's accepted count is the
        # miner's.
        m = await work.settled(frontend.metrics)
        assert m["verdicts"].get(str(shard), {}).get(
            "accepted") == stats.shares_accepted, (
            m["verdicts"], stats.summary())
        assert not m["duplicate_series"], m["duplicate_series"][:5]
        assert set(m["sessions"]) == {"0", "1"}, m["sessions"]
        other = str(1 - shard)
        assert not m["verdicts"].get(other, {}).get("accepted"), m
        bad = non_accepted(m["verdicts"])
        assert not {k: n for k, n in bad.items() if k != "stale"}, bad
        code, body = await http_get(frontend.status, "/healthz")
        health = json.loads(body)
        assert code == 200 and health["components"]["frontend_shard"][
            "state"] == "ok", health
        validators = frontend.validators()
        assert set(validators) == {"0", "1"}, validators
        if pkg.native.native_available():
            assert all(v == [f"native:{pkg.native.backend_name()}"]
                       for v in validators.values()), validators
        assert stats.hw_errors == 0 and stats.shares_rejected == 0, (
            stats.summary())
        assert not work.twice(), work.twice()[:5]
        window = b[0] - a[0]
        session = {
            "window_seconds": window,
            "mhs": (b[1] - a[1]) * DISPATCH / window / 1e6,
            "mhs_dispatcher_hashes": (b[2] - a[2]) / window / 1e6,
            "accepted": stats.shares_accepted,
            "rejected": stats.shares_rejected,
            "stale": stats.shares_stale,
            "frontend_verdicts": m["verdicts"],
            "invalid": sum(n for k, n in bad.items() if k != "stale"),
            "duplicate": bad.get("duplicate", 0),
            "extranonce1": e1.hex(), "session_shard": shard,
            "prefix": prefix, "prefix_range": [lo, hi],
            "shards": view, "validators": validators,
            "healthz_frontend_shard": health["components"][
                "frontend_shard"]["state"],
            "metrics_shard_sessions": m["sessions"],
            "duplicate_series": len(m["duplicate_series"]),
            "shares_accepted_twice": len(work.twice()),
            "submits_held_s": work.held[-1]}
        try:
            kill = await shard_kill(pkg, frontend, miner, task, shard,
                                    work, tile_ms)
        except Exception as e:  # noqa: BLE001 — the next phase reports it
            kill = e
        return session, kill
    finally:
        if miner is not None:
            miner.stop()
            await asyncio.gather(task, return_exceptions=True)
        stopped = frontend.stop()
        tel.flightrec.disarm()
        assert stopped["rc"] == 0 and not stopped["children_left"], (
            stopped, frontend.log_tail())


async def shard_kill(pkg, frontend, miner, task, victim: int, work,
                     tile_ms: float) -> dict:
    """SIGKILL the shard that holds the miner's session: its gauge reads
    ``down`` within one liveness tick (1 s), ``/healthz`` reads the
    ``frontend_shard`` component DEGRADED and never answers 503, the next
    tick respawns it at the identical prefix range with a new pid and
    ``restarts`` 1, and the miner reconnects (to whichever shard the
    kernel picks; the respawned one hands out its first extranonce1
    again) and gets a share accepted in a new session, inside that
    shard's range. Prints the seconds from the kill to that share and the
    card's idle seconds in them. No share is accepted twice: no header
    twice among the accepted (``work``, an :class:`AcceptedWork`), no
    verdict but accepted or stale on any shard and none rejected at the
    miner, and the frontend's accepts since the kill are the miner's
    give or take only the submits in flight at the kill, whose answers
    the dying shard may or may not have sent."""
    stats = miner.dispatcher.stats
    client = miner.client
    old = (await frontend.shard_view())[victim]
    pre = (await frontend.metrics())["verdicts"]
    other_base = pre.get(str(1 - victim), {}).get("accepted", 0)
    sampler = LaunchSampler(pkg)
    try:
        # Read in one step of the event loop with the kill: no answer of
        # the session's lands in between.
        at_kill = {"accepted": stats.shares_accepted,
                   "rejected": stats.shares_rejected,
                   "stale": stats.shares_stale,
                   "reconnects": client.reconnects,
                   "inflight": work.inflight}
        t_kill = time.perf_counter()
        os.kill(old["pid"], signal.SIGKILL)
        down_after = degraded = None
        codes = set()
        deadline = t_kill + 60
        while True:
            view = await frontend.shard_view()
            entry = view[victim]
            if entry["state"] == "down" and down_after is None:
                down_after = time.perf_counter() - t_kill
            code, body = await http_get(frontend.status, "/healthz")
            codes.add(code)
            component = json.loads(body)["components"].get(
                "frontend_shard", {})
            if component.get("state") == "degraded" and degraded is None:
                degraded = {"after_s": time.perf_counter() - t_kill,
                            "reason": component.get("reason")}
            if entry["restarts"] == 1 and entry["state"] == "serving":
                break
            assert time.perf_counter() < deadline, (view, codes)
            await asyncio.sleep(0.05)
        respawned_after = time.perf_counter() - t_kill
        await until(task, lambda: client.reconnects > at_kill["reconnects"]
                    and client.connected.is_set(), "a new session",
                    stats.summary, 60)
        accepted_new = stats.shares_accepted
        await until(task, lambda: stats.shares_accepted > accepted_new,
                    "a share in the new session", stats.summary, 120)
        t_next = time.perf_counter()
    finally:
        await sampler.stop()
    gap = t_next - t_kill
    launches, longest = sampler.between(t_kill, t_next)
    new_e1 = client.extranonce1
    new_shard = pkg.load_probe._shard_of(new_e1, 2, SHARDS)
    view = await frontend.shard_view()
    lo, hi = view[new_shard]["prefix_range"]
    prefix = int.from_bytes(new_e1[-2:], "big")
    assert down_after is not None and down_after <= 1.6, down_after
    assert degraded is not None and 503 not in codes, (degraded, codes)
    assert (entry["prefix_range"], entry["restarts"]) == (
        old["prefix_range"], 1) and entry["pid"] != old["pid"], (old, entry)
    assert lo <= prefix < hi, (new_e1.hex(), view)
    # With no submit in flight, the frontend's accepts since the kill (all
    # of the surviving shard's past its count before, all of the respawned
    # one's) and the miner's differ by no more than the answers the dead
    # shard sent for the submits in flight at the kill.
    after = await work.settled(frontend.metrics)
    frontend_new = sum(v.get("accepted", 0) for v in
                       after["verdicts"].values()) - other_base
    miner_new = stats.shares_accepted - at_kill["accepted"]
    assert 0 <= miner_new - frontend_new <= at_kill["inflight"], (
        frontend_new, miner_new, at_kill, after["verdicts"])
    assert after["verdicts"].get(str(new_shard), {}).get("accepted"), after
    for verdicts in (pre, after["verdicts"]):
        bad = non_accepted(verdicts)
        assert not {k: n for k, n in bad.items() if k != "stale"}, verdicts
    assert stats.shares_rejected == at_kill["rejected"], stats.summary()
    assert not work.twice(), work.twice()[:5]
    assert not after["duplicate_series"], after["duplicate_series"][:5]
    assert stats.hw_errors == 0
    return {"victim": victim, "victim_pid": old["pid"],
            "respawned_pid": entry["pid"], "restarts": entry["restarts"],
            "prefix_range": entry["prefix_range"],
            "down_after_s": down_after, "healthz_degraded": degraded,
            "healthz_codes": sorted(codes),
            "respawned_serving_after_s": respawned_after,
            "next_share_after_s": gap, "new_session_shard": new_shard,
            "new_extranonce1": new_e1.hex(),
            "launches_in_gap": launches,
            "idle_seconds": max(0.0, gap - launches * tile_ms / 1e3),
            "longest_without_launch_s": longest,
            "submits_in_flight_at_kill": at_kill["inflight"],
            "submits_held_s": work.held[-1],
            "frontend_accepted_since_kill": frontend_new,
            "miner_accepted_since_kill": miner_new,
            # lost on the dead connection, or mined for it and not
            # submitted on the next
            "miner_stale_since_kill": stats.shares_stale - at_kill["stale"],
            "shares_accepted_twice": len(work.twice()),
            "accepted_headers": len(work.headers),
            "frontend_verdicts_before": pre,
            "frontend_verdicts_after": after["verdicts"]}


def run_probes(port: int, shards: int) -> dict:
    """:data:`SHARD_LOAD_PROBES` processes of ``python -m
    bitcoin_miner_tpu_torch.probes.load_probe --connect 127.0.0.1:PORT
    --shards N --assert-unique-e1 --assert-no-invalid``, all at once,
    :data:`SHARD_LOAD_SESSIONS` sessions between them: their lines, and
    each process's CPU seconds (and of them, in the kernel), alone and
    over its wall time (``wait4``)."""
    per = SHARD_LOAD_SESSIONS // SHARD_LOAD_PROBES
    procs = []
    for _ in range(SHARD_LOAD_PROBES):
        procs.append((time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "bitcoin_miner_tpu_torch.probes.load_probe",
             "--connect", f"127.0.0.1:{port}", "--clients", str(per),
             "--shares", str(SHARD_LOAD_SHARES), "--shards", str(shards),
             "--assert-unique-e1", "--assert-no-invalid"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))))
    # Reaped as they end, in any order (a probe writes a line or two: its
    # pipes do not fill meanwhile).
    ended: dict = {}
    deadline = time.perf_counter() + 180
    while len(ended) < len(procs):
        for i, (t0, proc) in enumerate(procs):
            if i in ended:
                continue
            pid, status, usage = os.wait4(proc.pid, os.WNOHANG)
            if pid:
                ended[i] = (time.perf_counter() - t0, status, usage)
        if time.perf_counter() > deadline:
            for _t0, proc in procs:
                proc.kill()
            raise TimeoutError("a load probe did not finish")
        time.sleep(0.02)
    lines, cpu_share, cpu_s, sys_s = [], [], [], []
    for i, (_t0, proc) in enumerate(procs):
        wall, status, usage = ended[i]
        proc.returncode = os.waitstatus_to_exitcode(status)
        out, err = proc.communicate()
        assert proc.returncode == 0, (proc.returncode, err[-2000:])
        lines.append(json.loads(out.strip().splitlines()[-1]))
        cpu_s.append(usage.ru_utime + usage.ru_stime)
        sys_s.append(usage.ru_stime)
        cpu_share.append(cpu_s[-1] / wall)
    return {"lines": lines, "cpu_share": cpu_share, "cpu_seconds": cpu_s,
            "system_seconds": sys_s}


async def sample_cpu(pids: list, samples: list) -> None:
    """Append (epoch seconds, each process's CPU seconds) to ``samples``
    every 20 ms until cancelled: a process's CPU share inside a window
    that other processes report on the host's clock."""
    while True:
        samples.append((time.time(), [sum(cpu_seconds(pid))
                                      for pid in pids]))
        await asyncio.sleep(0.02)


async def shard_load(pkg) -> dict:
    """For N in :data:`SHARD_LOAD_COUNTS`: ``--serve-pool 127.0.0.1:PORT
    --serve-difficulty 1e-12`` (N = 1) or with ``--serve-shards N``, in
    its own process, driven by :func:`run_probes` (honest miners whose
    every hash meets the difficulty: the validator's throughput). Per N:
    validated shares/s (every probe's accepted shares over the union of
    their submit windows, from the first start to the last end; the
    windows, relative to that start, and the span all of them share
    beside it), sessions per shard, the frontend's accepted count
    against the probes', CPU seconds per wall second of the probes and
    of each acceptor (over the probes' wall time, and sampled over the
    union of the submit windows), and the CPU (and of it, in the kernel) each
    side spent per validated share."""
    rows = {}
    for n in SHARD_LOAD_COUNTS:
        frontend = await asyncio.to_thread(
            Frontend, pkg, n, SHARD_LOAD_DIFFICULTY)
        try:
            view = await frontend.ready()
            acceptors = ([s["pid"] for s in view] if view
                         else [frontend.proc.pid])
            cpu0 = [cpu_seconds(pid) for pid in acceptors]
            samples: list = []
            sampler = asyncio.create_task(sample_cpu(acceptors, samples))
            t0 = time.perf_counter()
            try:
                probes = await asyncio.get_running_loop().run_in_executor(
                    None, run_probes, frontend.port, n)
            finally:
                sampler.cancel()
                await asyncio.gather(sampler, return_exceptions=True)
            wall = time.perf_counter() - t0
            cpu1 = [cpu_seconds(pid) for pid in acceptors]
            m = await frontend.metrics()
            validators = frontend.validators()
        finally:
            stopped = frontend.stop()
        assert stopped["rc"] == 0 and not stopped["children_left"], stopped
        if pkg.native.native_available():
            assert validators and all(
                v == [f"native:{pkg.native.backend_name()}"]
                for v in validators.values()), validators
        lines = probes["lines"]
        per = SHARD_LOAD_SESSIONS // SHARD_LOAD_PROBES
        spread: dict = {}
        for line in lines:
            assert line["accepted"] == per * SHARD_LOAD_SHARES, line
            assert line["invalid"] == 0, line
            assert line["unique_extranonce1"] == per, line
            for shard, k in line.get("sessions_per_shard", {}).items():
                spread[shard] = spread.get(shard, 0) + k
        assert "unattributed" not in spread, spread
        accepted = sum(line["accepted"] for line in lines)
        first = min(line["submit_window"][0] for line in lines)
        last = max(line["submit_window"][1] for line in lines)
        union = last - first
        acceptor_cpu = [sum(b) - sum(a) for a, b in zip(cpu0, cpu1)]
        # The samples that bracket the union (20 ms wider at most).
        ta, ca = ([x for x in samples if x[0] <= first] or samples[:1])[-1]
        tb, cb = ([x for x in samples if x[0] >= last] or samples[-1:])[0]
        frontend_accepted = sum(v.get("accepted", 0)
                                for v in m["verdicts"].values())
        assert frontend_accepted == accepted, (frontend_accepted, accepted)
        assert not non_accepted(m["verdicts"]), m["verdicts"]
        assert not m["duplicate_series"], m["duplicate_series"][:5]
        rows[str(n)] = {
            "shares_per_s": accepted / union,
            "submit_windows_s": [[line["submit_window"][0] - first,
                                  line["submit_window"][1] - first]
                                 for line in lines],
            "submit_union_s": union,
            "submit_overlap_s": max(0.0, min(
                line["submit_window"][1] for line in lines) - max(
                line["submit_window"][0] for line in lines)),
            "shares_per_s_by_probe": [line["value"] for line in lines],
            "accepted": accepted, "invalid": 0,
            "sessions": SHARD_LOAD_SESSIONS,
            "sessions_per_shard": spread,
            "probe_cpu_share": probes["cpu_share"],
            "probe_cpu_us_per_share": sum(probes["cpu_seconds"])
            / accepted * 1e6,
            "probe_system_us_per_share": sum(probes["system_seconds"])
            / accepted * 1e6,
            "acceptor_cpu_share": [c / wall for c in acceptor_cpu],
            "acceptor_cpu_share_in_union": [(b - a) / (tb - ta)
                                            for a, b in zip(ca, cb)],
            "acceptor_cpu_us_per_share": sum(acceptor_cpu) / accepted * 1e6,
            "acceptor_system_us_per_share": sum(
                b[1] - a[1] for a, b in zip(cpu0, cpu1)) / accepted * 1e6,
            "probes_wall_s": wall, "validators": validators}
    return {"shards": rows, "cpu_count": os.cpu_count(),
            "probes": SHARD_LOAD_PROBES,
            "shares_per_session": SHARD_LOAD_SHARES,
            "difficulty": SHARD_LOAD_DIFFICULTY}


async def until(task, done, what: str, summary, seconds: float) -> None:
    """Wait for ``done()``; fail if the session's task ends first or
    ``seconds`` pass."""
    deadline = time.perf_counter() + seconds
    while not done():
        if task.done():
            raise RuntimeError(f"miner stopped: {task!r}")
        if time.perf_counter() > deadline:
            raise TimeoutError(f"{what}: {summary()}")
        await asyncio.sleep(0.05)


class _Package:
    """The names the smoke test drives, from the package beside it."""

    def __init__(self) -> None:
        from bitcoin_miner_tpu_torch.backends.cuda import (
            CudaHasher,
            ShardedTileCudaHasher,
            TileCudaHasher,
            sibling_version_patterns,
        )
        from bitcoin_miner_tpu_torch import cli, poolserver
        from bitcoin_miner_tpu_torch.backends import native
        from bitcoin_miner_tpu_torch.backends.base import get_hasher
        from bitcoin_miner_tpu_torch.backends.cpu import NativeCpuHasher
        from bitcoin_miner_tpu_torch.core.header import GENESIS_HEADER_HEX
        from bitcoin_miner_tpu_torch.core.sha256 import sha256d
        from bitcoin_miner_tpu_torch.core.target import (
            difficulty_to_target,
            nbits_to_target,
        )
        from bitcoin_miner_tpu_torch.backends.base import (
            ScanRequest,
            dispatch_granularity,
        )
        from bitcoin_miner_tpu_torch.miner.dispatcher import Dispatcher
        from bitcoin_miner_tpu_torch.miner.multipool import MultipoolMiner
        from bitcoin_miner_tpu_torch.miner.job import (
            Job,
            StratumJobParams,
            job_from_template_fields,
        )
        from bitcoin_miner_tpu_torch.miner.runner import StratumMiner
        from bitcoin_miner_tpu_torch.miner.scheduler import scheduler_for
        from bitcoin_miner_tpu_torch.ops import (
            csrc,
            int_probe,
            sha256_tile,
            sha256_torch,
        )
        from bitcoin_miner_tpu_torch.parallel import mesh
        from bitcoin_miner_tpu_torch.parallel.fanout import make_cuda_fanout
        from bitcoin_miner_tpu_torch.parallel.meshring import MeshCudaHasher
        from bitcoin_miner_tpu_torch.parallel.supervisor import (
            make_cuda_fleet,
        )
        from bitcoin_miner_tpu_torch.testing.chaos_hasher import ChaosHasher
        from bitcoin_miner_tpu_torch.probes import int_probe as probe_cli
        from bitcoin_miner_tpu_torch.probes import load_probe
        from bitcoin_miner_tpu_torch.probes import run as matrix
        from bitcoin_miner_tpu_torch.probes import (
            frontier,
            parity,
            ptxas,
            sass,
            tune,
        )
        from bitcoin_miner_tpu_torch.telemetry import pipeline
        from bitcoin_miner_tpu_torch.telemetry.tsdb import sample_key
        from bitcoin_miner_tpu_torch.testing.fake_node import (
            REGTEST_NBITS,
            FakeNode,
        )
        from bitcoin_miner_tpu_torch.testing.chaos_pool import (
            ChaosStratumPool,
        )
        from bitcoin_miner_tpu_torch.testing.mock_pool import (
            MockStratumPool,
            PoolJob,
        )
        from bitcoin_miner_tpu_torch.utils.backoff import (
            DecorrelatedJitterBackoff,
        )

        self.CudaHasher, self.TileCudaHasher = CudaHasher, TileCudaHasher
        self.cli = cli
        self.GENESIS_HEADER_HEX = GENESIS_HEADER_HEX
        self.sha256d = sha256d
        self.difficulty_to_target = difficulty_to_target
        self.nbits_to_target = nbits_to_target
        self.MockStratumPool, self.PoolJob = MockStratumPool, PoolJob
        self.ChaosStratumPool, self.MultipoolMiner = (ChaosStratumPool,
                                                      MultipoolMiner)
        self.FakeNode, self.REGTEST_NBITS = FakeNode, REGTEST_NBITS
        self.Job, self.StratumJobParams = Job, StratumJobParams
        self.Dispatcher = Dispatcher
        self.job_from_template_fields = job_from_template_fields
        self.DecorrelatedJitterBackoff = DecorrelatedJitterBackoff
        self.csrc = csrc
        self.sibling_version_patterns = sibling_version_patterns
        self.job_block_from_header = sha256_tile.job_block_from_header
        self.scan_tile = sha256_tile.scan_tile
        self.scan_tile_plain = sha256_tile.scan_tile_plain
        self.scan_batch = sha256_torch.scan_batch
        self.scan_batch_plain = sha256_torch.scan_batch_plain
        self.scan_batch_vshare = sha256_torch.scan_batch_vshare
        self.scan_batch_vshare_plain = sha256_torch.scan_batch_vshare_plain
        self.hitbuf_geometry = sha256_torch.hitbuf_geometry
        self.bound_ms = sha256_torch.bound_ms
        self.ops_per_nonce = sha256_torch.ops_per_nonce
        self.sha256_tile = sha256_tile
        self.hitbuf_library = sha256_torch.hitbuf_library
        self.rescan_steps = sha256_torch.rescan_steps
        self.rescan_steps_plain = sha256_torch.rescan_steps_plain
        self.rescan_counter = sha256_torch.rescan_counter
        self.rescan_geometry = sha256_torch.rescan_geometry
        self.shard_min_plain = sha256_torch.shard_min_plain
        self.mesh = mesh
        self.scheduler_for = scheduler_for
        self.StratumMiner = StratumMiner
        self.dispatch_granularity = dispatch_granularity
        self.ShardedTileCudaHasher = ShardedTileCudaHasher
        self.MeshCudaHasher = MeshCudaHasher
        self.make_cuda_fanout = make_cuda_fanout
        self.int_probe, self.probe_cli, self.sass = int_probe, probe_cli, sass
        self.ptxas = ptxas
        self.parity, self.frontier, self.tune = parity, frontier, tune
        self.pipe_bound_ms = sha256_torch.pipe_bound_ms
        self.pipeline = pipeline
        self.ScanRequest = ScanRequest
        self.make_cuda_fleet, self.ChaosHasher = make_cuda_fleet, ChaosHasher
        self.native, self.NativeCpuHasher = native, NativeCpuHasher
        self.get_hasher, self.poolserver = get_hasher, poolserver
        self.load_probe, self.sample_key = load_probe, sample_key
        self.matrix = matrix

    @staticmethod
    def hasher_service():
        """``rpc.hasher_service``, which needs grpcio: imported only by
        the phases that serve a worker."""
        from bitcoin_miner_tpu_torch.rpc import hasher_service

        return hasher_service


def serve_worker(pkg, counts_path: str, argv: list) -> int:
    """``chip_smoke.py --serve-worker COUNTS ARGS``: the process that a
    :class:`Worker` runs. It is ``python -m bitcoin_miner_tpu_torch ARGS``
    (``cli.main``) with every launch counter at 0; once SIGTERM has stopped
    the server, it writes the launches it made to COUNTS as one JSON
    object. A served worker's kernels launch in its own process, where the
    smoke's counters do not see them."""
    for c in pkg.csrc.counters():
        c.reset()
    rc = pkg.cli.main(argv)
    with open(counts_path, "w") as f:
        json.dump({c.name: c.value for c in pkg.csrc.counters()}, f)
    return rc


def main() -> int:
    if sys.argv[1:2] != ["--serve-worker"]:
        try:
            options = parse_options(sys.argv[1:])
        except ValueError as e:
            print(f"chip_smoke: {e}", file=sys.stderr)
            return 2
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
    if sys.argv[1:2] == ["--serve-worker"]:
        return serve_worker(pkg, sys.argv[2], sys.argv[3:])
    return run(torch, pkg, **options)


if __name__ == "__main__":
    sys.exit(main())
