"""The ``perf`` subcommand: the perf ledger's command line.

Counterpart of ``bitcoin_miner_tpu/perf_cli.py``. Subcommands, on the
append-only ledger of :mod:`.telemetry.perfledger` (schema
``tpu-miner-perfledger/1``):

- ``record``: ingest evidence JSONL through the validating loader,
  stamping schema, id and fingerprint onto rows that lack them (rows
  already in the ledger with the same content are skipped);
- ``report``: per like-for-like experiment key, count, best, median and
  latest with their dates;
- ``compare``: an informational gate run (exit 0 whatever it finds);
- ``gate``: the regression gate, current rows against a baseline ledger,
  best-of-N against the baseline's MAD noise band; exit 1 on a
  regression (``--warn-only``: 0);
- ``proxy``: the deterministic CPU proxy microbench, the host costs a
  dispatch pays (a ``Dispatcher.sweep`` on the ``cpu`` backend, the
  scheduler's decision loop, the metric hot path, the share accountant),
  with the sweep's telemetry-off control leg;
- ``capture`` is refused: the reference's runs ``bench.py`` under the JAX
  profiler and ``benchmarks/trace_report.py`` over the profile, and this
  package has neither counterpart yet.

The default ledger is ``build/perf_ledger.jsonl`` in the checkout, a
directory git ignores, so no run writes into a tracked file unasked.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

from .telemetry.perfledger import (
    LedgerError,
    PerfLedger,
    content_key,
    env_fingerprint,
    format_report,
    gate_report,
    gate_rows,
    load_rows,
    trajectory,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the default ledger: under ``build/``, which git ignores.
DEFAULT_LEDGER = os.path.join(REPO_ROOT, "build", "perf_ledger.jsonl")

#: why ``perf capture`` is refused.
CAPTURE_REFUSED = (
    "perf capture is not available in this package: the reference's "
    "capture runs bench.py under the JAX profiler and "
    "benchmarks/trace_report.py over the profile, and neither has a "
    "counterpart here yet. Record a measured row with `perf record`.")

# ---------------------------------------------------------------- proxy
#: fixed shapes: the proxy's workload is the same every run, so the
#: spread between runs is the machine's, which the MAD band is sized from.
PROXY_SWEEP_NONCES = 1 << 10
PROXY_SWEEP_BATCH = 1 << 7
PROXY_LOOP_ITERS = 20_000


def _proxy_job():
    """A fixed job for the dispatcher sweep, easy enough (p ≈ 2^-8 per
    nonce) that hit verification runs a few times per sweep."""
    from .core.target import difficulty_to_target
    from .miner.job import job_from_template_fields

    return job_from_template_fields(
        job_id="proxy",
        prevhash_display_hex="00" * 32,
        merkle_root_internal=b"\x00" * 32,
        version=0x20000000,
        nbits=0x1D00FFFF,
        ntime=0x5F5E100,
        share_target=difficulty_to_target(1.0 / (1 << 24)),
    )


def _bench_dispatcher_sweep(telemetry) -> float:
    """One ``Dispatcher.sweep`` over the hashlib oracle: request slicing,
    busy-clock accounting, hit re-verification."""
    from .backends.base import get_hasher
    from .miner.dispatcher import Dispatcher

    d = Dispatcher(
        get_hasher("cpu"), n_workers=1, batch_size=PROXY_SWEEP_BATCH,
        telemetry=telemetry,
    )
    t0 = time.perf_counter()
    d.sweep(_proxy_job(), nonce_start=0, nonce_count=PROXY_SWEEP_NONCES)
    return time.perf_counter() - t0


def _bench_scheduler_loop(telemetry) -> float:
    """The adaptive scheduler's decision loop on a fake clock: one
    next_count, record_result and record_gap per synthetic dispatch, the
    same decisions every run."""
    from .miner.scheduler import AdaptiveBatchScheduler

    fake_now = [0.0]

    def clock() -> float:
        return fake_now[0]

    sched = AdaptiveBatchScheduler(
        min_bits=10, max_bits=24, telemetry=telemetry, clock=clock,
    )
    t0 = time.perf_counter()
    for i in range(PROXY_LOOP_ITERS):
        n = sched.next_count()
        fake_now[0] += 0.01
        sched.record_result(n)
        sched.record_gap(0.0001 if i % 7 else 0.02)
        if i % 1024 == 1023:
            sched.on_job_switch()
    return time.perf_counter() - t0


def _bench_telemetry_overhead(telemetry) -> float:
    """The metric hot path: a histogram observe, a labeled counter inc
    and a gauge set per iteration."""
    t0 = time.perf_counter()
    for i in range(PROXY_LOOP_ITERS):
        telemetry.dispatch_gap.observe(0.0001 * (i % 13))
        telemetry.stale_drops.labels(stage="item").inc()
        telemetry.ring_occupancy.set(i & 3)
    return time.perf_counter() - t0


def _bench_share_accounting(telemetry) -> float:
    """The share accountant's cost: one weighted verdict and gauge
    refresh per iteration (it sits on the submit path)."""
    from .miner.dispatcher import MinerStats
    from .telemetry.shareacct import ShareAccountant

    stats = MinerStats()
    acct = ShareAccountant(stats, telemetry=telemetry)
    t0 = time.perf_counter()
    for i in range(PROXY_LOOP_ITERS):
        stats.hashes += 4096
        acct.on_result("accepted" if i % 3 else "rejected", 0.001)
    return time.perf_counter() - t0


def _proxy_benches() -> Dict[str, tuple]:
    """bench name → (callable(telemetry) -> seconds, telemetry class).
    ``dispatcher_sweep_notel`` is the control leg: the same sweep with
    telemetry compiled out."""
    from .telemetry import NullTelemetry, PipelineTelemetry

    return {
        "dispatcher_sweep": (_bench_dispatcher_sweep, PipelineTelemetry),
        "dispatcher_sweep_notel": (_bench_dispatcher_sweep, NullTelemetry),
        "scheduler_loop": (_bench_scheduler_loop, PipelineTelemetry),
        "telemetry_overhead": (_bench_telemetry_overhead, PipelineTelemetry),
        "share_accounting": (_bench_share_accounting, PipelineTelemetry),
    }


def run_proxy_microbench(
    repeats: int = 3, benches: Optional[List[str]] = None,
) -> List[Dict]:
    """Run the proxy battery: one ledger row per bench and repeat (the
    gate takes best-of-N and the band from the repeats). Repeats are the
    outer loop, so the telemetry on and off legs run side by side in time
    and slow drift of the machine's load cancels out of their ratio."""
    rows: List[Dict] = []
    table = _proxy_benches()
    names = benches if benches else list(table)
    for name in names:
        if name not in table:
            raise SystemExit(f"unknown proxy bench {name!r}; "
                             f"have {sorted(table)}")
    for repeat in range(repeats):
        for name in names:
            fn, tel_cls = table[name]
            seconds = fn(tel_cls())
            rows.append({
                "metric": "proxy_microbench",
                "bench": name,
                "value": round(seconds, 6),
                "unit": "s",
                "backend": "cpu",
                "repeat": repeat,
            })
    return rows


# ------------------------------------------------------------------ cli
def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m bitcoin_miner_tpu_torch perf",
        description="perf ledger: evidence rows, regression gates, the "
                    "CPU proxy microbench",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_ledger(sp):
        sp.add_argument("--ledger", default=DEFAULT_LEDGER,
                        help="perf ledger JSONL path (default: %(default)s)")

    rec = sub.add_parser("record", help="ingest evidence JSONL rows")
    add_ledger(rec)
    rec.add_argument("--from", dest="src", required=True, metavar="FILE",
                     help="evidence JSONL to ingest ('-' = stdin)")
    rec.add_argument("--platform", default=None,
                     help="platform label for the stamped fingerprint "
                          "(default: cuda where torch sees a card, else "
                          "cpu)")

    rep = sub.add_parser("report", help="bench trajectory per experiment")
    add_ledger(rep)
    rep.add_argument("--metric", default=None,
                     help="only rows with this metric")
    rep.add_argument("--json", action="store_true")

    for name, help_text in (
        ("compare", "informational baseline comparison (always exit 0)"),
        ("gate", "regression gate (exit 1 on regression)"),
    ):
        g = sub.add_parser(name, help=help_text)
        add_ledger(g)
        g.add_argument("--baseline", required=True,
                       help="baseline ledger JSONL to gate against")
        g.add_argument("--metric", default=None,
                       help="only gate rows with this metric")
        g.add_argument("--rel-floor", type=float, default=0.05,
                       help="minimum relative regression tolerance "
                            "(default: %(default)s)")
        g.add_argument("--mad-k", type=float, default=4.0,
                       help="noise-band width in baseline MADs "
                            "(default: %(default)s)")
        g.add_argument("--json", action="store_true",
                       help="print the machine-readable gate report")
        if name == "gate":
            g.add_argument("--warn-only", action="store_true",
                           help="report regressions but exit 0")

    px = sub.add_parser("proxy", help="run the CPU proxy microbench")
    add_ledger(px)
    px.add_argument("--repeats", type=int, default=3,
                    help="repeats per bench (default: %(default)s; the "
                         "gate uses best-of-N and the repeats' spread)")
    px.add_argument("--bench", action="append", default=None,
                    metavar="NAME",
                    help="run only this proxy bench (repeatable)")
    px.add_argument("--json", action="store_true")

    sub.add_parser("capture", help="refused in this package: "
                   + CAPTURE_REFUSED)
    return p


def _filter_metric(rows, metric: Optional[str]):
    return [r for r in rows if metric is None or r.metric == metric]


def cmd_record(args) -> int:
    try:
        rows = load_rows(sys.stdin if args.src == "-" else args.src)
    except (OSError, LedgerError) as e:
        raise SystemExit(str(e))
    ledger = PerfLedger(args.ledger)
    # The same measurement must not enter the ledger twice under a fresh
    # id (it would inflate best-of-N counts and skew the noise bands), so
    # an ingest can be run again.
    seen = {content_key(r.raw) for r in ledger.load()}
    raws = []
    for row in rows:
        key = content_key(row.raw)
        if key in seen:
            continue
        seen.add(key)
        raws.append(row.raw)
    appended = ledger.append_many(
        raws, fingerprint=env_fingerprint(platform=args.platform))
    skipped = len(rows) - len(appended)
    print(f"recorded {len(appended)} row(s) into {args.ledger}"
          + (f" ({skipped} duplicate(s) skipped)" if skipped else ""))
    return 0


def cmd_report(args) -> int:
    try:
        rows = _filter_metric(PerfLedger(args.ledger).load(), args.metric)
    except LedgerError as e:
        raise SystemExit(str(e))
    summary = trajectory(rows)
    if args.json:
        print(json.dumps(summary, indent=1))
    else:
        format_report(summary)
    return 0


def cmd_gate(args, informational: bool) -> int:
    try:
        current = _filter_metric(PerfLedger(args.ledger).load(), args.metric)
        baseline = _filter_metric(load_rows(args.baseline), args.metric)
    except (OSError, LedgerError) as e:
        raise SystemExit(str(e))
    checks = gate_rows(current, baseline,
                       rel_floor=args.rel_floor, mad_k=args.mad_k)
    report = gate_report(checks)
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        for c in checks:
            key = json.loads(c.key)
            knobs = {k: v for k, v in key.items()
                     if k not in ("metric", "unit") and v is not None}
            line = (f"[{c.status:>11}] {key['metric']} {knobs} "
                    f"current={c.current_best:g}")
            if c.baseline_best is not None:
                line += (f" baseline={c.baseline_best:g} "
                         f"regression={c.regression:+.1%} "
                         f"band={c.band:.1%}")
            print(line)
        print(f"gate: {report['status']} "
              f"({report['failed']} failed / {report['checked']} checked, "
              f"{report['no_baseline']} without baseline)")
    if report["status"] == "fail" and not informational \
            and not getattr(args, "warn_only", False):
        return 1
    return 0


def cmd_proxy(args) -> int:
    rows = run_proxy_microbench(repeats=args.repeats, benches=args.bench)
    PerfLedger(args.ledger).append_many(
        rows, fingerprint=env_fingerprint(platform="cpu"))
    best: Dict[str, float] = {}
    for row in rows:
        name = row["bench"]
        best[name] = min(best.get(name, float("inf")), row["value"])
    if args.json:
        print(json.dumps({"rows": rows, "best": best}, indent=1))
    else:
        for name, seconds in best.items():
            print(f"{name:>24}: best-of-{args.repeats} {seconds:.4f}s")
        if {"dispatcher_sweep", "dispatcher_sweep_notel"} <= best.keys():
            on, off = best["dispatcher_sweep"], best["dispatcher_sweep_notel"]
            if off > 0:
                print(f"{'observatory overhead':>24}: "
                      f"{(on - off) / off:+.2%} (telemetry on vs off)")
    print(f"appended {len(rows)} row(s) to {args.ledger}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["capture"]:
        # Refused whatever its options: they are bench.py's.
        print(CAPTURE_REFUSED, file=sys.stderr)
        return 2
    args = build_parser().parse_args(argv)
    if args.cmd == "record":
        return cmd_record(args)
    if args.cmd == "report":
        return cmd_report(args)
    if args.cmd in ("compare", "gate"):
        return cmd_gate(args, informational=args.cmd == "compare")
    return cmd_proxy(args)


if __name__ == "__main__":
    sys.exit(main())
