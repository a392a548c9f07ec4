"""The card's int32 throughput on the op mix of a SHA-256 round.

Counterpart of ``benchmarks/vpu_probe.py`` (``run_config``, ``main``) and
of ``benchmarks/llo_probe.py --kernel vpu``'s static count. The kernel
(``ops/int_probe.py``, ``ops/csrc/int_probe.cu``) runs ``steps`` (8, 128)
tiles of ``ilp`` dependent chains, each ``groups`` groups of 5 algorithmic
operations; ``tops_int32`` counts those 5 per group, chain and lane over
the time of one launch.

On the card each line also carries the SASS of the kernel's group loop per
pipe (``probes/sass.py``) and, from it, the time and the SM clock sampled
while the launches ran, the **measured lanes per SM and clock** of the
integer (ALU) pipe and of all issued instructions, beside the card's peak
rates (64 and 128) that the bound of every scan kernel
(``sha256_torch.bound_ms``) takes.

Usage (from the root of a checkout)::

    python -m bitcoin_miner_tpu_torch.probes.int_probe        # on the card
    python -m bitcoin_miner_tpu_torch.probes.int_probe --cpu  # plain version

It prints one JSON line per ILP 1, 2, 4, 8, 16 at steps 4096 and groups
4096 (``--cpu``: steps 4 and groups 16, the reference's ``--interpret``
size). One difference from the reference, which prints an ``error`` line
for a failed ILP and still exits 0: this exits 1 when any ILP failed.
Nothing falls back to the plain version: without ``--cpu`` a missing card,
a failed build or a failed launch is that ILP's error.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

import torch

from ..ops import csrc
from ..ops.int_probe import (
    ILPS,
    LANES,
    LIBRARY,
    SUBLANES,
    UNROLL,
    probe,
    probe_bound_ms,
    probe_ops,
    probe_tiles,
)
from ..ops.sha256_torch import DISPATCH_LANES_PER_SM, INT_LANES_PER_SM
from . import sass

STEPS = GROUPS = 4096  # the reference's defaults
CPU_STEPS, CPU_GROUPS = 4, 16  # the reference's --interpret size
#: Device time of one timed window of launches, of the launches queued
#: ahead of it (so that the events time the card, not the host's enqueue),
#: and the windows per configuration.
WINDOW_MS = 500.0
QUEUED_MS = 20.0
WINDOWS = 3


def seed_tile(device) -> torch.Tensor:
    """The reference's seed, ``arange(1024)`` as an (8, 128) uint32 tile."""
    tile = torch.arange(SUBLANES * LANES, dtype=torch.int64)
    return tile.reshape(SUBLANES, LANES).to(torch.uint32).to(device)


def nvidia_smi(query: str, index: int = 0, units: bool = True) -> str:
    """One field set of ``nvidia-smi --query-gpu`` for card ``index``."""
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}", "-i",
         str(index)], capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def _time_on_card(seed: torch.Tensor, groups: int, ilp: int,
                  steps: int) -> tuple:
    """(mean ms of a launch per window, SM clocks in MHz sampled while the
    card ran the windows, launches per window). Each window's launches are
    queued behind launches already queued (~QUEUED_MS, and at least ~1 ms
    of card work per timed launch); it fails unless those still run when
    the window's last launch is queued."""
    device = seed.device
    index = device.index or 0

    def launch():
        probe_tiles(seed, groups, ilp, steps)

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    launch()  # builds and loads the library
    torch.cuda.synchronize(device)
    start.record()
    launch()
    end.record()
    end.synchronize()
    one = max(start.elapsed_time(end), 1e-3)
    reps = max(3, math.ceil(WINDOW_MS / one))
    queued = math.ceil(max(QUEUED_MS, reps * 1.0) / one)
    windows: List[float] = []
    clocks: List[float] = []
    for _ in range(WINDOWS):
        for _ in range(queued):
            launch()
        start.record()
        for _ in range(reps):
            launch()
        end.record()
        if start.query():
            raise RuntimeError(
                f"the card finished the queued launches before the host had "
                f"queued {reps} timed ones: the window would time the host")
        while not end.query():
            mhz = float(nvidia_smi("clocks.sm", index, units=False))
            if not end.query():  # the card was busy for the whole sample
                clocks.append(mhz)
        end.synchronize()
        windows.append(start.elapsed_time(end) / reps)
    if not clocks:
        raise RuntimeError("no SM clock sample fell inside a timed window")
    return windows, clocks, reps


def run_config(groups: int, ilp: int, steps: int, device="cuda") -> dict:
    """One configuration: the reference's keys ``groups``, ``ilp``,
    ``steps``, ``seconds`` (of one launch) and ``tops_int32``, and the
    device it ran on. On the card ``seconds`` is the median over
    :data:`WINDOWS` windows of the CUDA-event mean of a launch, with the
    windows' means, the launches per window and the SM clock sampled
    during them (``sm_clock_mhz``, the median); on the CPU, one host-timed
    run of the plain version after a warm-up, as the reference times its
    interpreted kernel."""
    device = torch.device(device)
    seed = seed_tile(device)
    total_ops = probe_ops(groups, ilp, steps)
    res = {"groups": groups, "ilp": ilp, "steps": steps}
    if device.type == "cpu":
        probe(seed, groups, ilp, steps)
        t0 = time.perf_counter()
        probe(seed, groups, ilp, steps)
        seconds = time.perf_counter() - t0
        return {**res, "seconds": seconds,
                "tops_int32": total_ops / seconds / 1e12, "device": "cpu"}
    with torch.cuda.device(device):
        windows, clocks, reps = _time_on_card(seed, groups, ilp, steps)
    seconds = statistics.median(windows) / 1e3
    return {**res, "seconds": seconds,
            "tops_int32": total_ops / seconds / 1e12,
            "device": torch.cuda.get_device_name(device),
            "card": nvidia_smi("name,power.limit", device.index or 0),
            "seconds_windows": [w / 1e3 for w in windows],
            "launches_per_window": reps,
            "sm_clock_mhz": statistics.median(clocks),
            "sm_clock_samples": clocks}


def loop_counts(listing: str) -> Dict[int, dict]:
    """Per ILP, the SASS of ``int_probe_kernel<ilp>``'s group loop in a
    ``cuobjdump -sass`` listing of the library: instructions per pipe in
    one iteration (``loop``, :data:`UNROLL` groups of every chain), the
    same per group and chain (``per_chain_group``) and per opcode."""
    out = {}
    for name, insns in sass.functions(listing).items():
        m = re.search(r"int_probe_kernelILi(\d+)E", name)
        if not m:
            continue
        ilp = int(m.group(1))
        body = sass.loop_body(insns)
        counts = sass.pipe_counts(body)
        out[ilp] = {"groups_per_iteration": UNROLL, "loop": counts,
                    "per_chain_group": {p: n / (UNROLL * ilp)
                                        for p, n in counts.items()},
                    "opcodes": sass.opcode_counts(body)}
    return out


def loop_overhead(static: Dict[int, dict]) -> Dict[str, dict]:
    """Per pipe, the least-squares line of one iteration's instructions
    against ILP: the intercept is the loop's own overhead per iteration
    (counter, compare, branch), the slope over :data:`UNROLL` the
    instructions of one group of one chain."""
    ilps = sorted(static)
    mean_x = statistics.fmean(ilps)
    out = {}
    for pipe in (*sass.PIPES, "all"):
        ys = [static[i]["loop"][pipe] for i in ilps]
        mean_y = statistics.fmean(ys)
        sxx = sum((x - mean_x) ** 2 for x in ilps)
        slope = (sum((x - mean_x) * (y - mean_y) for x, y in zip(ilps, ys))
                 / sxx) if sxx else 0.0
        out[pipe] = {"per_iteration": mean_y - slope * mean_x,
                     "per_chain_group": slope / UNROLL}
    return out


def lanes_per_sm_clock(res: dict, loop: Dict[str, int], sms: int) -> dict:
    """Measured lanes per SM and clock of a card run ``res``: the loop's
    instructions of each pipe (``loop``, one iteration) times the
    iterations every lane ran, over the SM clocks of one launch at the
    sampled clock; ``ops``, the algorithmic operations the same way."""
    iterations = res["groups"] // UNROLL
    lanes = res["steps"] * SUBLANES * LANES
    sm_clocks = res["seconds"] * res["sm_clock_mhz"] * 1e6 * sms
    out = {p: loop[p] * iterations * lanes / sm_clocks
           for p in ("alu", "fma")}
    out["issued"] = loop["all"] * iterations * lanes / sm_clocks
    out["ops"] = probe_ops(res["groups"], res["ilp"],
                           res["steps"]) / sm_clocks
    return out


def binding_pipe(loop: Dict[str, int]) -> str:
    """Which of the card's peak rates a loop of ``loop`` instructions per
    pipe meets first: the integer pipe's (ALU) or dispatch's. Only a run
    bound by dispatch measures dispatch; at the other pipe's limit the
    issued rate is the ALU rate scaled by the mix."""
    return ("alu" if loop["alu"] * DISPATCH_LANES_PER_SM
            > loop["all"] * INT_LANES_PER_SM else "dispatch")


def card_details(res: dict, static: Dict[int, dict], registers: Dict[int, int],
                 device) -> dict:
    """What a card line adds to :func:`run_config`'s: registers, the
    static count (and the loop's overhead, fitted over every ILP), the
    measured lanes per SM and clock, the pipe the loop's mix binds, and the
    bound at the card's maximum SM clock."""
    device = torch.device(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    max_mhz = float(nvidia_smi("clocks.max.sm", device.index or 0,
                               units=False))
    ilp = res["ilp"]
    loop = static[ilp]["loop"]
    return {"registers": registers.get(ilp), "sms": sms,
            "sm_clock_max_mhz": max_mhz, "sass": static[ilp],
            "loop_overhead": loop_overhead(static),
            "lanes_per_sm_clock": lanes_per_sm_clock(res, loop, sms),
            "binds": binding_pipe(loop),
            "bound_ms": probe_bound_ms(res["groups"], ilp, res["steps"], sms,
                                       max_mhz * 1e6)}


def library_static() -> tuple:
    """(:func:`loop_counts`, ptxas' registers per ILP) of the built
    library."""
    path = csrc.library_path(LIBRARY)
    registers = {}
    for name, n in sass.ptxas_registers(
            path.with_suffix(".log").read_text()).items():
        m = re.search(r"int_probe_kernelILi(\d+)E", name)
        if m:
            registers[int(m.group(1))] = n
    return loop_counts(sass.listing(path)), registers


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m bitcoin_miner_tpu_torch.probes.int_probe",
        description="int32 throughput of the card at ILP 1, 2, 4, 8, 16")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain version on the CPU at steps 4, "
                        "groups 16")
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--groups", type=int, default=GROUPS)
    args = p.parse_args(argv)
    if args.cpu:
        args.steps, args.groups = CPU_STEPS, CPU_GROUPS
    device = "cpu" if args.cpu else "cuda"
    static = None
    failed = False
    for ilp in ILPS:
        try:
            res = run_config(args.groups, ilp, args.steps, device)
            if not args.cpu:
                if static is None:
                    static = library_static()
                res.update(card_details(res, *static, device))
        except Exception as e:  # noqa: BLE001 — reported, and fails the run
            res = {"ilp": ilp, "error": f"{type(e).__name__}: {e}"[:300]}
            failed = True
        print(json.dumps(res), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
