"""The internal worker's accepted shares against the rate its hashes
should find, with and without job switches, for the reference package
and the port, on the native CPU hasher.

A job switch makes the results of the requests in flight stale: the
dispatcher counts their hashes but drops their hits. With the adaptive
scheduler a request grows towards one second of work at the whole
dispatcher's rate, so every worker holds seconds of it in flight; with a
fixed ``--batch-bits`` size it holds milliseconds. Both packages share
that design, so both lose the same share of their shares at a switch.

    JAX_PLATFORMS=cpu python tests/internal_worker_job_loss.py
    JAX_PLATFORMS=cpu python tests/internal_worker_job_loss.py \\
        --batch-bits 16

prints one JSON line per package and job interval: the hash rate, the
accepted and expected shares a second, their ratio and the stale drops
by stage. Needs g++ for the native hashers.
"""

import argparse
import asyncio
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# The miner package first: importing the protocol package first is circular.
import bitcoin_miner_tpu.miner.runner  # noqa: E402,F401

PACKAGES = {"reference": "bitcoin_miner_tpu", "port": "bitcoin_miner_tpu_torch"}


async def measure(root: str, interval: float, seconds: float,
                  difficulty: float, workers: int, batch_bits) -> dict:
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    server_mod, jobs, runner = (mod("poolserver.server"),
                                mod("poolserver.jobs"),
                                mod("poolserver.runner"))
    tel = mod("telemetry.pipeline").PipelineTelemetry()
    hasher = mod("backends.cpu").NativeCpuHasher()
    server = server_mod.StratumPoolServer(difficulty=difficulty,
                                          telemetry=tel)
    scheduler = (None if batch_bits is not None
                 else mod("miner.scheduler").scheduler_for(hasher))
    iw = server_mod.InternalWorker(
        server, hasher, n_workers=workers, scheduler=scheduler,
        batch_size=1 << (batch_bits or 16))
    frontend = runner.PoolFrontend(
        server, "127.0.0.1", 0, local_source=jobs.LocalTemplateSource(),
        job_interval_s=interval, internal_worker=iw)
    task = asyncio.create_task(frontend.run())
    stats = iw.dispatcher.stats

    def mark():
        return (time.perf_counter(), stats.hashes, iw.session.accepted,
                {k[0]: c.value for k, c in tel.stale_drops.children()})

    try:
        while iw.session.accepted < 1:
            await asyncio.sleep(0.01)
        a = mark()
        await asyncio.sleep(seconds)
        b = mark()
    finally:
        frontend.stop()
        await task
    window = b[0] - a[0]
    expected = (b[1] - a[1]) / window / (2 ** 32 * difficulty)
    accepted = (b[2] - a[2]) / window
    return {"package": root, "job_interval_s": interval,
            "sizing": ("adaptive" if batch_bits is None
                       else f"batch_bits {batch_bits}"),
            "window_seconds": window,
            "mhs_host_cpu": (b[1] - a[1]) / window / 1e6,
            "accepted_per_s": accepted, "expected_per_s": expected,
            "accepted_vs_expected": accepted / expected,
            "stale_drops": {k: v - a[3].get(k, 0) for k, v in b[3].items()}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--intervals", type=float, nargs="+",
                    default=[5.0, 1000.0],
                    help="job intervals in seconds (1000: no switch)")
    ap.add_argument("--difficulty", type=float, default=2.0 ** -11,
                    help="share difficulty; the default keeps a request's "
                         "hits under the 64-hit cap")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--batch-bits", type=int, default=None,
                    help="fixed request size; default the adaptive "
                         "scheduler, as the command line without "
                         "--batch-bits")
    args = ap.parse_args()
    for interval in args.intervals:
        for root in PACKAGES.values():
            print(json.dumps(asyncio.run(measure(
                root, interval, args.seconds, args.difficulty, args.workers,
                args.batch_bits))), flush=True)


if __name__ == "__main__":
    main()
