"""Headline benchmark: the genesis sweep's rate on one card, as one JSON
line.

Counterpart of the reference's root ``bench.py``. ``python -m
bitcoin_miner_tpu_torch.bench`` sweeps the genesis header's nonces, all
2^32 by default and always around nonce 2083236893, at the difficulty-1
target, through the hasher and scheduler that the command line builds
(``cli.make_hasher``: the tile kernel on the card, 2^24-nonce dispatches,
the adaptive scheduler unless ``--batch-bits`` or ``--scheduler fixed``
fixes the request size), and prints exactly one JSON line in every
outcome::

    {"metric": "sha256d_scan", "value": <MH/s>, "unit": "MH/s",
     "backend": "cuda-tile", "device": "<the card's name>",
     "verified": true, <geometry>,
     "scheduler": ..., "dispatches": <requests>, "batch_nonces_min": ...,
     "batch_nonces_max": ..., "nonces": ..., "seconds": ...,
     "hits": [<the header's hits>],
     "launches": {<kernel>: <launches in the timed sweep>},
     "pipeline": {<the pipeline probe's block>}}

``value`` counts every chain's hashes (k a nonce under ``--vshare k``).
Before any number is printed the genesis nonce must be among the sweep's
hits and pass the CPU oracle (the parity gate). The first use of a kernel
builds its library with nvcc; a warm-up over the genesis nonce's dispatch
(which also runs its rescan) does that outside the timed window.

Return codes: 0, a measurement on the requested backend; 2, the parity
gate failed (never retried, never masked); 1, any other failure, printed
with ``value`` 0 and the error. There is no CPU fallback: a card that
cannot be reached, or a kernel that fails to build or launch, is rc 1.

The measurement runs in a child process under a watchdog: ``--attempts``
tries of ``--attempt-timeout`` seconds each (enough for the first nvcc
build), with a backoff between them. A child that hangs or dies without a
JSON line is tried again; a child's own error line is its verdict, which a
retry would repeat. The host backends (``native``, ``cpu``) and
``--device cpu`` run in this process.

``--profile DIR`` wraps the timed sweep in ``torch.profiler.profile`` (the
CPU, and the card where it runs) with the pipeline's host ranges on
(``telemetry.tracing.profile_pipeline``) and writes its Chrome trace to
``DIR/bench.<pid>.pt.trace.json``, which ``probes.trace_report`` reads.
``--trace-out`` writes the pipeline's span trace; ``--flightrec-out`` arms
the flight recorder at that path for the run (it is not armed otherwise);
``--ledger`` appends the line to a perf ledger with the environment's
fingerprint, under ``--ledger-id`` when given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import threading
import time
from typing import List, Optional, Tuple

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The hashers that run on the host CPU (``cli.HOST_BACKENDS``).
HOST_BACKENDS = ("cpu", "native")

#: Seconds the pipeline probe may take before the line goes out without it.
PIPELINE_TIMEOUT_S = 60.0

#: The geometry the line is labelled with, read back from the hasher (the
#: values after any clamp): (key, the hasher's attribute).
GEOMETRY = (("sublanes", "sublanes"), ("inner_tiles", "inner_tiles"),
            ("interleave", "interleave"), ("vshare", "_vshare"),
            ("unroll", "unroll"), ("spec", "spec"), ("variant", "variant"),
            ("cgroup", "cgroup"), ("topology", "topology"))

#: The hasher options passed to the command line's parser as they are.
HASHER_OPTIONS = ("backend", "device", "vshare", "batch_bits", "inner_bits",
                  "variant", "cgroup", "interleave", "sublanes",
                  "inner_tiles", "unroll", "mesh_kernel", "fanout_kernel",
                  "mesh_devices")


def build_parser() -> argparse.ArgumentParser:
    # No option here needs torch: the supervisor stays light, and the
    # worker's command line refuses what does not apply.
    p = argparse.ArgumentParser(prog="python -m bitcoin_miner_tpu_torch.bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("--backend", default="cuda-tile",
                   help="the command line's --backend (default %(default)s)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the card, or the plain PyTorch versions of the "
                        "kernels on the CPU (run in this process)")
    p.add_argument("--sweep-bits", type=int, default=32,
                   help="log2 of the nonces swept around the genesis nonce "
                        "(default %(default)s: the whole nonce space)")
    p.add_argument("--batch-bits", type=int, default=None,
                   help="log2 nonces per device dispatch (default 24); "
                        "given, it also fixes the request size")
    p.add_argument("--batch-3x", action="store_true",
                   help="dispatches of 3·2^batch-bits nonces")
    p.add_argument("--scheduler", choices=("adaptive", "fixed"), default=None,
                   help="how requests are sized: the adaptive scheduler, or "
                        "one dispatch each (default: adaptive unless "
                        "--batch-bits is given)")
    for flag, kind in (("--inner-bits", int), ("--variant", str),
                       ("--cgroup", int), ("--interleave", int),
                       ("--sublanes", int), ("--inner-tiles", int),
                       ("--unroll", int), ("--mesh-kernel", str),
                       ("--fanout-kernel", str), ("--mesh-devices", int)):
        p.add_argument(flag, type=kind, default=None,
                       help=f"the command line's {flag}")
    p.add_argument("--vshare", type=int, default=1,
                   help="the command line's --vshare (default %(default)s)")
    p.add_argument("--no-spec", action="store_true",
                   help="the command line's --no-spec")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="profile the timed sweep with torch.profiler and "
                        "write its Chrome trace into DIR")
    p.add_argument("--trace-out", metavar="PATH", default=None,
                   help="write the sweep's pipeline spans as Chrome "
                        "trace-event JSON")
    p.add_argument("--flightrec-out", metavar="PATH", default=None,
                   help="arm the flight recorder to dump here on a crash "
                        "(not armed without it)")
    p.add_argument("--ledger", metavar="PATH", default=None,
                   help="append the line to this perf ledger with the "
                        "environment's fingerprint (never fatal)")
    p.add_argument("--ledger-id", metavar="ID", default=None,
                   help="the ledger row's id")
    p.add_argument("--attempts", type=int, default=2,
                   help="child attempts (default %(default)s)")
    p.add_argument("--attempt-timeout", type=float, default=600.0,
                   help="seconds before an attempt's child is killed, the "
                        "first nvcc build included (default %(default)s)")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    return p


def result_json(mhs: float, backend: str, **extra) -> dict:
    out = {"metric": "sha256d_scan", "value": round(mhs, 6), "unit": "MH/s",
           "backend": backend}
    out.update(extra)
    return out


def _error_line(args, error: str) -> dict:
    return result_json(0.0, args.backend, error=error[:500],
                       scheduler=args.scheduler)


def in_process(args) -> bool:
    """Whether the worker runs in this process: nothing of it can hang
    on a card."""
    return args.backend in HOST_BACKENDS or args.device == "cpu"


# ---------------------------------------------------------------- worker
def _cli_args(args):
    """The command line's options for the bench's hasher."""
    from . import cli

    argv = ["--bench"]
    for flag in HASHER_OPTIONS:
        val = getattr(args, flag)
        if val is not None:
            argv += [f"--{flag.replace('_', '-')}", str(val)]
    argv += [flag for flag, on in (("--batch-3x", args.batch_3x),
                                   ("--no-spec", args.no_spec)) if on]
    if args.trace_out:
        argv += ["--trace-out", args.trace_out]
    cargs = cli.build_parser().parse_args(argv)
    cargs.flightrec_out = args.flightrec_out
    return cargs


def _launch_counts() -> dict:
    from .ops import csrc

    return {c.name: c.value for c in csrc.counters()}


def _pipeline_metrics(hasher, header76: bytes, target: int,
                      batch_size: int, batches: int = 6) -> dict:
    """The pipeline block: the gap and busy statistics of a short
    blocking-against-streaming run of ``batches`` requests of
    ``batch_size`` nonces (``probes.pipeline_probe``) on the measured
    hasher. Never fatal, and bounded by :data:`PIPELINE_TIMEOUT_S` on a
    thread of its own: a hung probe must not cost the measurement."""

    def run_probe() -> dict:
        from .probes import pipeline_probe

        out = pipeline_probe.probe(hasher, header76, target, batches=batches,
                                   batch_size=batch_size)
        stream = out["streaming"]
        return {
            "overlap": out["overlap"],
            "verify_ms": out["verify_ms"],
            "batch_nonces": batch_size,
            "device_busy_fraction": stream["busy_fraction"],
            "gap_ms_mean": stream["gap_ms_mean"],
            "gap_ms_max": stream["gap_ms_max"],
            "gap_ms_p50": stream["gap_ms_p50"],
            "gap_ms_p95": stream["gap_ms_p95"],
            "gap_ms_p99": stream["gap_ms_p99"],
            "batch_ms_mean": stream["batch_ms_mean"],
            "blocking_gap_ms_mean": out["blocking"]["gap_ms_mean"],
            "blocking_busy_fraction": out["blocking"]["busy_fraction"],
        }

    result: dict = {}

    def work() -> None:
        try:
            result["block"] = run_probe()
        except Exception as e:  # noqa: BLE001 — diagnostic, never fatal
            result["block"] = {"error": f"{type(e).__name__}: {e}"[:200]}

    thread = threading.Thread(target=work, name="bench-probe", daemon=True)
    thread.start()
    thread.join(timeout=PIPELINE_TIMEOUT_S)
    return result.get("block") or {
        "error": f"pipeline probe timed out after {PIPELINE_TIMEOUT_S:g} s"}


def run_worker(args) -> Tuple[int, dict]:
    """The measurement: (rc, its line)."""
    try:
        from . import cli
        from .backends.base import dispatch_granularity
        from .core.header import (
            GENESIS_HEADER_HEX,
            GENESIS_NBITS,
            GENESIS_NONCE,
        )
        from .core.target import nbits_to_target
        from .miner.scheduler import scheduler_for
        from .telemetry.tracing import profile_pipeline

        cargs = _cli_args(args)
        telemetry = cli.setup_telemetry(cargs, arm=bool(args.flightrec_out))
        try:
            hasher = cli.make_hasher(cargs)
            on_card = not in_process(args)
            header76 = bytes.fromhex(GENESIS_HEADER_HEX)[:76]
            target = nbits_to_target(GENESIS_NBITS)
            grid = dispatch_granularity(hasher, cli.batch_size_for(cargs))
            if on_card:
                # The genesis nonce's dispatch: its hit slot is rescanned,
                # so every library of the path is built and loaded here.
                hasher.scan(header76, GENESIS_NONCE - GENESIS_NONCE % grid,
                            grid, target)
            adaptive = args.scheduler == "adaptive"
            profiling = (profile_pipeline(cuda=on_card) if args.profile
                         else contextlib.nullcontext())
            before = _launch_counts()
            with profiling as prof:
                out = cli.run_bench(
                    hasher, 1 << args.sweep_bits,
                    scheduler=scheduler_for(hasher) if adaptive else None,
                    batch_size=None if adaptive else grid)
            after = _launch_counts()
            if prof is not None:
                os.makedirs(args.profile, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    args.profile, f"bench.{os.getpid()}.pt.trace.json"))
            if args.trace_out:
                # Written before the parity gate: a kernel that misses
                # the genesis nonce still leaves its timeline behind.
                cli._dump_trace(telemetry, hasher)
        finally:
            if args.flightrec_out:
                telemetry.flightrec.disarm()
        device = "cpu"
        if on_card:
            import torch

            device = torch.cuda.get_device_name(
                getattr(hasher, "device", None))
    except (Exception, SystemExit) as e:  # a JSON line, not a traceback
        return 1, _error_line(args, f"{type(e).__name__}: {e}")

    if not out["found"]:
        return 2, _error_line(args, "genesis nonce missed — kernel broken")
    if not out["verified"]:
        return 2, _error_line(args, "oracle verification failed")
    payload = result_json(out["mhs"], args.backend, device=device,
                          verified=True)
    for key, attr in GEOMETRY:
        val = getattr(hasher, attr, None)
        if val is not None:
            payload[key] = val
    payload.update({
        "scheduler": args.scheduler,
        "dispatches": out["dispatches"],
        "batch_nonces_min": out["batch_nonces_min"],
        "batch_nonces_max": out["batch_nonces_max"],
        "nonces": out["hashes"] // max(1, getattr(hasher, "_vshare", 1)),
        "seconds": round(out["seconds"], 6),
        "hits": out["nonces"],
        "launches": {name: n - before.get(name, 0)
                     for name, n in after.items() if n > before.get(name, 0)},
    })
    payload["pipeline"] = _pipeline_metrics(
        hasher, header76, target, 1 << 10 if in_process(args) else grid)
    return 0, payload


# ------------------------------------------------------------ supervisor
def _extract_json(stdout) -> Optional[dict]:
    """The last line of ``stdout`` that is a JSON object with a metric."""
    if isinstance(stdout, bytes):
        stdout = stdout.decode("utf-8", "replace")
    for line in reversed((stdout or "").splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                parsed = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(parsed, dict) and parsed.get("metric"):
                return parsed
    return None


def _run_attempt(cmd: list, timeout: float, env=None):
    """One child attempt: (its line or None, error, rc). A child killed at
    its timeout after printing its line (a hang in teardown) keeps it."""
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, env=env)
    except subprocess.TimeoutExpired as e:
        parsed = _extract_json(e.stdout)
        if parsed is not None:
            return parsed, parsed.get("error", ""), 0
        return None, f"attempt timed out after {timeout:.0f}s", -1
    except OSError as e:
        return None, f"failed to spawn worker: {e}", -1
    parsed = _extract_json(proc.stdout)
    if parsed is not None:
        return parsed, parsed.get("error", ""), proc.returncode
    tail = (proc.stderr or proc.stdout or "").strip().splitlines()[-3:]
    return None, (f"worker exited rc={proc.returncode} with no JSON: "
                  + " | ".join(tail))[:500], proc.returncode


def supervise(args, argv: List[str]) -> Tuple[int, dict]:
    """The worker in a child, under the watchdog: (rc, the line)."""
    cmd = [sys.executable, "-m", "bitcoin_miner_tpu_torch.bench", "--worker",
           *argv]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO_ROOT, os.environ.get("PYTHONPATH")) if p))
    errors = []
    for attempt in range(max(1, args.attempts)):
        if attempt:
            time.sleep(min(10.0 * attempt, 30.0))
        parsed, err, rc = _run_attempt(cmd, args.attempt_timeout, env=env)
        if parsed is not None and rc == 0 and parsed.get("value", 0) > 0:
            return 0, parsed
        if rc == 2:
            # The parity gate: the kernel ran and is wrong. A retry, or
            # any other number, would hide it.
            return 2, parsed if parsed is not None else _error_line(args, err)
        if parsed is not None:
            return 1, dict(parsed, value=0.0)
        errors.append(err or "unknown failure")
    return 1, _error_line(args, "; ".join(errors))


def _record_ledger(args, line: dict, rc: int) -> None:
    """Append the line to ``--ledger`` with the fingerprint of the
    platform it ran on and pointers to the run's profile and trace. Never
    fatal: the ledger is downstream of the measurement."""
    try:
        from .telemetry.perfledger import PerfLedger, env_fingerprint

        artifacts = {key: path for key, path in (("profile", args.profile),
                                                 ("trace", args.trace_out))
                     if path}
        PerfLedger(args.ledger).append(
            dict(line, rc=rc),
            fingerprint=env_fingerprint(
                platform="cpu" if in_process(args) else "cuda"),
            artifacts=artifacts or None, row_id=args.ledger_id)
    except Exception as e:  # noqa: BLE001 — the line is already out
        print(f"bench: ledger append failed: {e}", file=sys.stderr)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if not 0 <= args.sweep_bits <= 32:
        raise SystemExit("--sweep-bits must be between 0 and 32")
    if args.scheduler is None:
        args.scheduler = "fixed" if args.batch_bits is not None else "adaptive"
    if args.worker or in_process(args):
        rc, line = run_worker(args)
    else:
        rc, line = supervise(args, argv)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    if args.ledger and not args.worker:
        _record_ledger(args, line, rc)
    return rc


if __name__ == "__main__":
    sys.exit(main())
