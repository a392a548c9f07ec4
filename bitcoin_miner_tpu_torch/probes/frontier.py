"""Layout ranker: enumerate the scan kernels' configurations, build them,
read what the compiler made of each, score, rank and emit.

Counterpart of ``benchmarks/frontier.py``, run as ``python -m
bitcoin_miner_tpu_torch frontier`` (or ``python -m
bitcoin_miner_tpu_torch.probes.frontier``). The pipeline:

1. **Enumerate** the candidates (:func:`enumerate_candidates`): the tile
   kernel at K = 1, 2, 4, 8, in each layout the smoke drives
   (``ops.sha256_tile.driven_layouts``), each compile form and a few step
   geometries; the hit-buffer kernel as the anchor (the reference's
   ``_xla``); the sharded rows over N cards (``cuda-tile-mesh``,
   ``cuda-mesh``), whose per-card kernel is a single-card row's.
2. **Build** each candidate's library through ``ops/csrc.build`` (nvcc,
   all at once; a library already built under its digest is reused).
3. **Read** ptxas' registers, spills and static shared memory
   (``probes/ptxas.py``), the blocks per SM (``scan_tile_occupancy``; for
   the hit-buffer kernel, from its registers) and the nonce loop's SASS
   per pipe (``probes/sass.py``), with its local-memory instructions.
4. **Score** (:func:`score`): the nonce loop's SASS at the card's peak
   rates (``pipe_bound_ms``: logic on the 64-lane integer pipe, every
   instruction through 128 lanes of dispatch), each local load or store
   in the loop charged :data:`SPILL_SLOTS` times the loop's average
   instruction; a rolled compile form
   (whose nonce loop holds round loops SASS shows once) takes its
   operation bound scaled as the default form's SASS is. Divided by the
   efficiency :data:`EFFICIENCY` that the default kernel reaches of its
   own SASS bound, by an occupancy factor (warps per SM against
   :data:`WARPS_TO_HIDE`) and by the fill of the busiest SM's share of
   the 2^24-nonce dispatch's blocks.
5. **Rank** by predicted hashes per second and **emit** a
   ``tpu-miner-frontier/1`` document and ``tpu-miner-perfledger/1`` rows
   labelled ``compiler: nvcc``; ``--battery N`` prints the bench flags of
   the top N.

``--stub-compiler`` replaces steps 2-3 with a deterministic model, labelled
``compiler: stub`` in every row, so that the path runs on a CPU without
nvcc; its default output is away from the canonical one, and it feeds no
ledger by default. Stub numbers are structural stand-ins, never evidence.
A cached entry is reused while its library's digest (sources and flags,
``csrc.library_path``) is unchanged: an edited ``.cu`` invalidates it.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

SCHEMA = "tpu-miner-frontier/1"
ROOT = Path(__file__).resolve().parents[2]
DEFAULT_OUT = str(ROOT / "build" / "frontier" / "frontier.json")
#: A stub ranking's default home: never the canonical document.
STUB_OUT = str(ROOT / "build" / "frontier" / "frontier_stub.json")
DEFAULT_LEDGER = str(ROOT / "build" / "perf_ledger.jsonl")
#: Nonces per dispatch the predictions are for: the command line's.
DISPATCH = 1 << 24

# ------------------------------------------------------------- the model
#: The card the model's constants were measured on, and its peak: an
#: NVIDIA H100 80GB HBM3 at a 700.00 W power limit, 132 SMs, 1980 MHz
#: (the stub's card too).
CARD = {"name": "NVIDIA H100 80GB HBM3, 700.00 W", "sms": 132,
        "sm_clock_mhz": 1980.0}
#: The model's constants, from ``chip_smoke.py``'s ``timings`` and
#: ``layout_frontier`` phases on the card above: the reads and word7 times
#: of every driven tile library are in
#: ``tests/fixtures/ptxas/h100_sxm_700w.json``, which
#: ``tests/test_torch_frontier.py`` refits. What the default tile kernel
#: (``scan_tile``, K=1, word7) reaches of its own SASS bound, the spread of
#: its 2048 blocks over the SMs aside: 2.2738 ms against 2.40468 ms per
#: 2^24 nonces, whose busiest SMs run 16 blocks for an average of 15.52.
EFFICIENCY = 0.9751
#: Its SASS bound over its operation bound (``bound_ms``, 1.82847 ms): how
#: much more than the operations the compiled loop issues. A rolled
#: form's bound is its operation bound times this.
SASS_OVER_OPS = 1.2436
#: Warps per SM below which the card's latencies show, fitted by
#: :func:`fit`: the layouts at 8 warps per SM (one block of 256 threads,
#: or two of 128) ran at 0.56–0.65 of their SASS bound, those at 16 or
#: more at 0.83–0.95.
WARPS_TO_HIDE = 12
#: What one local-memory instruction in the loop costs, in the loop's
#: average instructions, fitted by :func:`fit` with the others. One
#: library spills (``scan_tile_wsplit_k8_g1_i1``: 16 local loads in a
#: 17302-instruction loop), so this one number decides it, at the top of
#: the fit's grid: no measured cost of a spill.
SPILL_SLOTS = 32
#: What one shared-memory load or store in the loop costs (the staged
#: layouts' plane), likewise fitted.
SHARED_SLOTS = 8
#: Registers per SM, warps per SM and blocks per SM on the card.
REGS_PER_SM, MAX_WARPS, MAX_BLOCKS = 65536, 64, 32
#: Shared memory per SM a kernel may use, and reserved per block.
SMEM_PER_SM, SMEM_RESERVED = 233472, 1024

STAGED = ("wstage", "vroll", "vroll-db")
LOCAL_OPS = ("LDL", "STL")
SHARED_OPS = ("LDS", "STS")


def blocks_from_registers(registers: int, threads: int,
                          smem: int = 0) -> int:
    """Blocks of ``threads`` threads at ``registers`` per thread (and
    ``smem`` bytes of shared memory) that fit on one SM: registers are
    allocated per warp in units of 256, at most 64 warps and 32 blocks."""
    warps = -(-threads // 32)
    per_warp = -(-max(registers, 1) * 32 // 256) * 256
    blocks = min(MAX_BLOCKS, MAX_WARPS // warps,
                 REGS_PER_SM // (per_warp * warps))
    if smem:
        blocks = min(blocks, SMEM_PER_SM // (smem + SMEM_RESERVED))
    return max(0, blocks)


def _terms(static: Dict, cfg: Dict, card: Dict) -> Optional[Tuple]:
    """What a score needs of one read, whatever the model's constants:
    (bound ms, bound source, local and shared accesses per loop
    instruction, warps per SM, the busiest SM's fill); None when the read
    has no loop to score."""
    loop = static.get("loop")
    blocks = static.get("blocks_per_sm")
    if not loop or not loop.get("all") or not blocks:
        return None
    from ..ops.sha256_torch import bound_ms, pipe_bound_ms

    sms, hz = card["sms"], card["sm_clock_mhz"] * 1e6
    if cfg.get("unroll", 64) < 64:
        # Rolled round loops: the nonce loop's SASS holds each round loop
        # once. The form's operations, scaled as the default form's are.
        ms = bound_ms(DISPATCH, True, sms, hz, vshare=cfg["vshare"],
                      passes=_own_passes(cfg), spec=False) * SASS_OVER_OPS
        source = "operations"
    else:
        iters = DISPATCH / static["nonces_per_iter"]
        ms = pipe_bound_ms(iters * loop["alu"], iters * loop["all"], sms, hz)
        source = "sass"
    local = sum(loop.get(op, 0) for op in LOCAL_OPS) / loop["all"]
    shared = sum(loop.get(op, 0) for op in SHARED_OPS) / loop["all"]
    warps = blocks * static["threads"] / 32
    # The busiest SM runs ceil(blocks / SMs) of the dispatch's blocks.
    per_sm = static["n_blocks"] / sms
    return ms, source, local, shared, warps, per_sm / math.ceil(per_sm)


def _predicted_ms(terms: Tuple, warps_to_hide: float, spill_slots: float,
                  shared_slots: float, efficiency: float) -> Tuple:
    """(bound ms, occupancy factor, predicted ms) of :func:`_terms`."""
    ms, _, local, shared, warps, tail = terms
    # A local or shared-memory access in the loop waits on memory: each
    # costs SPILL_SLOTS or SHARED_SLOTS of the loop's average instruction.
    ms *= 1 + spill_slots * local + shared_slots * shared
    occupancy = min(1.0, warps / warps_to_hide)
    return ms, occupancy, ms / (efficiency * occupancy * tail)


def score(static: Dict, cfg: Dict, card: Dict = CARD,
          warps_to_hide: float = None, spill_slots: float = None,
          shared_slots: float = None, efficiency: float = None) -> Dict:
    """The prediction for one candidate's ``static`` read (see the
    module's docstring): its bound, the factors and the predicted ms per
    2^24-nonce dispatch and hashes per second. ``predicted_mhs`` is None
    when the read has no loop to score."""
    terms = _terms(static, cfg, card)
    if terms is None:
        return {"bound_ms": None, "bound_source": None,
                "occupancy_factor": None, "tail_factor": None,
                "predicted_ms": None, "predicted_mhs": None}
    ms, occupancy, predicted = _predicted_ms(
        terms, WARPS_TO_HIDE if warps_to_hide is None else warps_to_hide,
        SPILL_SLOTS if spill_slots is None else spill_slots,
        SHARED_SLOTS if shared_slots is None else shared_slots,
        EFFICIENCY if efficiency is None else efficiency)
    return {"bound_ms": round(ms, 5), "bound_source": terms[1],
            "occupancy_factor": round(occupancy, 4),
            "tail_factor": round(terms[5], 4),
            "predicted_ms": round(predicted, 5),
            "predicted_mhs": round(DISPATCH * cfg["vshare"] / predicted
                                   / 1e3, 1)}


#: The grid :func:`fit` searches.
FIT_WARPS = (4, 6, 8, 10, 11, 12, 13, 14, 15, 16, 18, 20, 24, 32)
FIT_SLOTS = (0, 0.5, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32)


def fit(rows: List[Dict], card: Dict = CARD) -> Dict:
    """The (warps to hide, spill slots, shared slots) whose scores come
    nearest the measured ``ms`` of ``rows`` (entries with ``static``,
    ``config`` and ``ms``) in mean squared log error, on a grid; with the
    error."""
    terms = [(_terms(row["static"], row["config"], card), row["ms"])
             for row in rows]
    best = None
    for warps in FIT_WARPS:
        for spill in FIT_SLOTS:
            for shared in FIT_SLOTS:
                err = sum(math.log(round(_predicted_ms(
                    t, warps, spill, shared, EFFICIENCY)[2], 5) / ms) ** 2
                    for t, ms in terms) / max(1, len(terms))
                if best is None or err < best["mse_log"] - 1e-12:
                    best = {"warps_to_hide": warps, "spill_slots": spill,
                            "shared_slots": shared, "mse_log": err}
    return best


def _ranks(values: List[float]) -> List[float]:
    order = sorted(range(len(values)), key=lambda i: values[i])
    ranks = [0.0] * len(values)
    i = 0
    while i < len(order):
        j = i
        while j + 1 < len(order) and values[order[j + 1]] == values[order[i]]:
            j += 1
        for n in range(i, j + 1):
            ranks[order[n]] = (i + j) / 2 + 1  # ties share their mean rank
        i = j + 1
    return ranks


def rank_correlation(xs: List[float], ys: List[float]) -> Optional[float]:
    """Spearman's rank correlation of two equal-length series (ties at
    their mean rank); None with fewer than 3 pairs or a constant series."""
    if len(xs) != len(ys) or len(xs) < 3:
        return None
    rx, ry = _ranks(list(xs)), _ranks(list(ys))
    mx, my = sum(rx) / len(rx), sum(ry) / len(ry)
    cov = sum((a - mx) * (b - my) for a, b in zip(rx, ry))
    vx = sum((a - mx) ** 2 for a in rx)
    vy = sum((b - my) ** 2 for b in ry)
    if not vx or not vy:
        return None
    return round(cov / math.sqrt(vx * vy), 4)


# --------------------------------------------------------- enumeration
def _tile(name: str, **kw) -> Dict:
    cfg = {"kernel": "tile", "vshare": 1, "variant": "baseline",
           "cgroup": 0, "interleave": 1, "unroll": 64, "spec": True,
           "sublanes": 8, "inner_tiles": 8, "word7": True,
           "batch_bits": 24}
    cfg.update(kw)
    return {"name": name, "cfg": cfg}


def _hitbuf(name: str, **kw) -> Dict:
    cfg = {"kernel": "hitbuf", "vshare": 1, "unroll": 64, "spec": True,
           "inner_bits": 18, "word7": True, "batch_bits": 24}
    cfg.update(kw)
    return {"name": name, "cfg": cfg}


def _form_suffix(unroll: int, spec: bool) -> str:
    return f"_u{unroll}" if unroll < 64 else ("" if spec else "_nospec")


def enumerate_candidates() -> List[Dict]:
    """The candidates, each a name and a configuration: every library the
    smoke builds for the two scan kernels, a few step geometries and the
    sharded rows."""
    from ..ops.sha256_tile import driven_layouts

    forms = ((8, True), (16, True), (32, True), (64, False))
    cands = [_tile(f"tile_k{k}", vshare=k) for k in (1, 2, 4, 8)]
    for k, v, g, i in driven_layouts():
        name = (f"tile_k{k}_{v.replace('-', '_')}" + (f"_g{g}" if g else "")
                + (f"_i{i}" if i > 1 else ""))
        cands.append(_tile(name, vshare=k, variant=v, cgroup=g,
                           interleave=i))
    for k in (1, 2):
        for u, sp in forms:
            cands.append(_tile(f"tile_k{k}{_form_suffix(u, sp)}", vshare=k,
                               unroll=u, spec=sp))
    # Step geometries: the step (sublanes × 128 × inner tiles nonces) sets
    # the grid's blocks, so the busiest SM's share of them, never the loop.
    for k, v in ((1, "baseline"), (2, "regchain"), (4, "wsplit")):
        for s, t in ((8, 4), (16, 8), (32, 8)):
            stem = f"tile_k{k}" + ("" if v == "baseline" else f"_{v}")
            cands.append(_tile(f"{stem}_s{s}_t{t}", vshare=k, variant=v,
                               sublanes=s, inner_tiles=t))
    cands += [_hitbuf(f"hitbuf_k{k}", vshare=k) for k in (1, 2, 4)]
    cands += [_hitbuf(f"hitbuf_k1{_form_suffix(u, sp)}", unroll=u, spec=sp)
              for u, sp in forms]
    for n in (2, 4):
        for base in (_tile(f"mesh1x{n}_tile_k1"),
                     _hitbuf(f"mesh1x{n}_hitbuf_k1")):
            base["cfg"]["topology"] = f"1x{n}"
            cands.append(base)
    return cands


def library_of(cfg: Dict) -> str:
    """The library (and launch counter) of a configuration."""
    from ..ops.sha256_tile import tile_library
    from ..ops.sha256_torch import hitbuf_library

    if cfg["kernel"] == "tile":
        return tile_library(cfg["vshare"], cfg["variant"], cfg["cgroup"],
                            cfg["interleave"], cfg["unroll"], cfg["spec"])
    return hitbuf_library(cfg["vshare"], cfg["unroll"], cfg["spec"])


def library_digest(cfg: Dict) -> str:
    """The digest of the library's sources and flags: a cached read is
    reused only under the same one."""
    from ..ops import csrc

    return csrc.library_path(library_of(cfg)).stem.rsplit("-", 1)[1]


def _own_passes(cfg: Dict) -> int:
    """Schedule expansions per nonce: once for a staged layout, once per
    chain pass for the others."""
    from ..ops.sha256_tile import _cgroup_size, _chain_groups

    if cfg["kernel"] != "tile" or cfg["variant"] in STAGED:
        return 1
    k = cfg["vshare"]
    return len(_chain_groups(k, _cgroup_size(cfg["cgroup"], cfg["variant"],
                                             k)))


def _launch_shape(cfg: Dict) -> Tuple[int, int, int]:
    """(threads per block, blocks per 2^24-nonce dispatch, nonces per
    loop iteration of a thread)."""
    from ..ops.sha256_tile import launch_threads
    from ..ops.sha256_torch import hitbuf_geometry

    if cfg["kernel"] == "hitbuf":
        return 256, hitbuf_geometry(DISPATCH)[1], 1
    block = cfg["sublanes"] * 128 * cfg["inner_tiles"]
    i, variant = cfg["interleave"], cfg["variant"]
    per_iter = i * (2 if variant == "vroll-db" else 1)
    return launch_threads(variant, i, block), DISPATCH // block, per_iter


def _kernel_name(cfg: Dict) -> str:
    if cfg["kernel"] == "hitbuf":
        return "scan_hitbuf_kernel"
    if cfg["variant"] in STAGED:
        return "scan_tile_staged_kernel"
    return ("scan_tile_kernel" if cfg["variant"] == "baseline"
            else "scan_tile_param_kernel")


# ------------------------------------------------------------ reading
def stub_read(cfg: Dict) -> Dict:
    """A deterministic read for the CPU smoke — NOT evidence: the loop's
    instructions from the operation count (with the staged plane's
    shared-memory traffic), registers growing with the chains in flight,
    spills past 255 registers or past the cap of a build's launch bounds
    (``sha256_tile.min_blocks``), blocks per SM from the registers and the
    plane (``sha256_tile.plane_bytes``)."""
    from ..ops.sha256_tile import min_blocks, plane_bytes, plane_words
    from ..ops.sha256_torch import ops_per_nonce

    k, staged = cfg["vshare"], cfg.get("variant") in STAGED
    threads, n_blocks, per_iter = _launch_shape(cfg)
    ops = ops_per_nonce(True, k, _own_passes(cfg),
                        cfg["spec"] and cfg["unroll"] >= 64)
    passes = _own_passes(cfg) if not staged else k
    g = k if cfg["kernel"] == "hitbuf" else -(-k // passes)
    smem = words = 0
    if staged:
        i, unroll = cfg["interleave"], cfg["unroll"]
        words = plane_words(cfg["variant"], i, unroll)[1]
        smem = plane_bytes(cfg["variant"], i, unroll)
    shared = words * (1 + passes)
    alu = int(ops.logic * 1.08) * per_iter
    other = (shared + 40) * per_iter
    fma = int(ops.adds * 0.42) * per_iter
    want = 40 + 22 * g * per_iter + (0 if staged else 8 * (k - g))
    cap = 255
    if cfg["kernel"] == "tile":
        blocks = min_blocks(k, cfg["variant"], cfg["interleave"])
        if blocks:
            cap = min(cap, REGS_PER_SM // (blocks * threads))
    registers = min(cap, want)
    spill = max(0, want - cap) * 4
    local = spill // 4
    return {"ok": True, "registers": registers, "spill_stores": spill,
            "spill_loads": spill, "static_smem": 8 * k * 4,
            "threads": threads, "n_blocks": n_blocks,
            "nonces_per_iter": per_iter,
            "blocks_per_sm": blocks_from_registers(registers, threads, smem),
            "loop": {"alu": alu, "fma": fma, "other": other + 2 * local,
                     "all": alu + fma + other + 2 * local, "LDL": local,
                     "STL": local, "LDS": shared * per_iter if staged else 0}}


def _is_word7(mangled: str, kernel: str) -> bool:
    from . import ptxas

    try:
        return ptxas.kernel_of(mangled) == (kernel, "word7")
    except AttributeError:  # not a scan kernel of the library
        return False


def read_kernel(kernel: str, log: str, listing: str,
                inner_trips: int = 1) -> Dict:
    """What one library's word7 ``kernel`` compiled to: its ptxas ``-v``
    registers, spills and static shared memory, and its nonce loop's
    instructions per pipe with its local, shared and global memory ones,
    from the ``cuobjdump -sass`` listing (only that kernel's part of it
    is parsed). A loop inside the nonce loop that runs ``inner_trips``
    times an iteration (``sha256_tile.rolled_groups``: twice) counts that
    many times."""
    from . import ptxas, sass

    fields = next((f for name, f in ptxas.entries(log).items()
                   if _is_word7(name, kernel)), None)
    part = next((chunk for chunk in listing.split("Function : ")[1:]
                 if _is_word7(chunk.split(None, 1)[0], kernel)), None)
    if fields is None or part is None:
        return {"ok": False, "error": f"no word7 {kernel} in the library"}
    (insns,) = sass.functions("Function : " + part).values()
    body = sass.loop_body(insns)
    runs = [body] + [sass.inner_loop(insns, body)] * (inner_trips - 1)
    loop = dict.fromkeys((*sass.PIPES, "all"), 0)
    for op in (*LOCAL_OPS, *SHARED_OPS, "LDG"):
        loop[op] = 0
    for run in runs:
        for key, n in sass.pipe_counts(run).items():
            loop[key] += n
        for op in (*LOCAL_OPS, *SHARED_OPS, "LDG"):
            loop[op] += sum(1 for insn in run if insn.base == op)
    return {"ok": True, **fields, "loop": loop}


def with_launch(read: Dict, cfg: Dict,
                blocks_per_sm: Optional[int] = None) -> Dict:
    """A kernel's read (:func:`read_kernel`) for one candidate: its launch
    shape and the blocks per SM (``blocks_per_sm`` where measured, else
    from the registers)."""
    if not read.get("ok"):
        return dict(read)
    threads, n_blocks, per_iter = _launch_shape(cfg)
    if blocks_per_sm is None:
        blocks_per_sm = blocks_from_registers(read.get("registers", 255),
                                              threads)
        source = "registers"
    else:
        source = "scan_tile_occupancy"
    return {**read, "threads": threads, "n_blocks": n_blocks,
            "nonces_per_iter": per_iter, "blocks_per_sm": blocks_per_sm,
            "blocks_per_sm_source": source}


def _inner_trips(cfg: Dict) -> int:
    """Runs of the loop inside a candidate's nonce loop per iteration: 2
    for a layout whose staged groups run in a rolled loop, else 1."""
    from ..ops.sha256_tile import rolled_groups

    return 2 if cfg["kernel"] == "tile" and rolled_groups(
        cfg["vshare"], cfg["variant"]) else 1


def read_library(cfg: Dict, log: str, listing: str,
                 blocks_per_sm: Optional[int] = None) -> Dict:
    """The static read of one candidate from its library's ptxas log and
    SASS listing (:func:`read_kernel`, :func:`with_launch`)."""
    return with_launch(read_kernel(_kernel_name(cfg), log, listing,
                                   _inner_trips(cfg)), cfg, blocks_per_sm)


def card_of_this_machine() -> Dict:
    """The card's name and power limit, SMs and maximum SM clock."""
    import torch

    def smi(query: str, units: bool = True) -> str:
        fmt = "csv,noheader" if units else "csv,noheader,nounits"
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
            capture_output=True, text=True, timeout=60,
            check=True).stdout.strip().splitlines()[0].strip()

    return {"name": smi("name,power.limit"),
            "sms": torch.cuda.get_device_properties(0).multi_processor_count,
            "sm_clock_mhz": float(smi("clocks.max.sm", units=False))}


def nvcc_reads(cfgs: List[Dict], log=print) -> List[Dict]:
    """Build every configuration's library (all at once), then read each:
    ptxas from the build logs, SASS through ``cuobjdump`` (one process per
    library, all at once), blocks per SM of the tile libraries on the
    card."""
    import ctypes

    from ..ops import csrc
    from . import sass

    names = sorted({library_of(c) for c in cfgs})
    t0 = time.perf_counter()
    logs = csrc.build(names)
    log(f"built or reused {len(names)} libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    with concurrent.futures.ThreadPoolExecutor(16) as pool:
        listings = dict(zip(names, pool.map(
            lambda n: sass.listing(csrc.library_path(n)), names)))
    occupancy = {}
    for name in names:
        if name.startswith("scan_tile"):
            vals = [ctypes.c_int() for _ in range(3)]
            csrc.check(csrc.load(name).scan_tile_occupancy(
                1, *(ctypes.addressof(v) for v in vals)), name)
            occupancy[name] = vals[2].value
    # One read per library: several candidates (step geometries, sharded
    # rows) share one.
    kernels = {}
    for c in cfgs:
        name = library_of(c)
        if name not in kernels:
            kernels[name] = read_kernel(_kernel_name(c), logs[name],
                                        listings[name], _inner_trips(c))
    return [with_launch(kernels[library_of(c)], c,
                        occupancy.get(library_of(c))) for c in cfgs]


# ------------------------------------------------------------ pipeline
def _config_key(config: Dict) -> str:
    return json.dumps(config, sort_keys=True)


def _prior_ranking(out_path: str, compiler: str) -> Dict[str, Dict]:
    """Every same-compiler entry of an existing document, by config."""
    try:
        with open(out_path, encoding="utf-8") as fh:
            doc = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return {}
    if doc.get("schema") != SCHEMA:
        return {}
    return {_config_key(e["config"]): e for e in doc.get("ranking", [])
            if e.get("compiler") == compiler and e.get("config")}


def _prior_entries(out_path: str, compiler: str,
                   prior: Optional[Dict[str, Dict]] = None
                   ) -> Dict[str, Dict]:
    """The resume cache: prior entries with a read whose library digest
    is today's."""
    if prior is None:
        prior = _prior_ranking(out_path, compiler)
    return {key: e for key, e in prior.items()
            if e.get("static", {}).get("ok")
            and e.get("digest") == library_digest(e["config"])}


def resume_invalidated(out_path: str, compiler: str,
                       prior: Optional[Dict[str, Dict]] = None
                       ) -> List[Dict]:
    """Prior entries with a read that the resume cache refuses because
    their library's digest changed (an edited source or flags): they are
    read again when a run enumerates them."""
    if prior is None:
        prior = _prior_ranking(out_path, compiler)
    return [{"name": e.get("name"), "key": key,
             "digest": e.get("digest"), "now": library_digest(e["config"])}
            for key, e in prior.items()
            if e.get("static", {}).get("ok")
            and e.get("digest") != library_digest(e["config"])]


def evaluate_candidates(cands: List[Dict], stub: bool,
                        prior: Optional[Dict[str, Dict]] = None,
                        card: Dict = CARD, log=print) -> List[Dict]:
    """Read (or model) and score every candidate: UNRANKED entries."""
    compiler = "stub" if stub else "nvcc"
    prior = prior or {}
    todo = [c for c in cands if _config_key(c["cfg"]) not in prior]
    reads = {}
    if todo:
        cfgs = [c["cfg"] for c in todo]
        got = ([stub_read(c) for c in cfgs] if stub
               else nvcc_reads(cfgs, log))
        reads = {_config_key(c): r for c, r in zip(cfgs, got)}
    entries = []
    for i, cand in enumerate(cands):
        cfg = cand["cfg"]
        key = _config_key(cfg)
        reused = prior.get(key)
        if reused is not None:
            log(f"[{i + 1}/{len(cands)}] {cand['name']}: reusing prior "
                f"{compiler} read")
            static = reused["static"]
        else:
            log(f"[{i + 1}/{len(cands)}] {cand['name']}: "
                + ("stub model" if stub else "nvcc read"))
            static = reads[key]
        entries.append({
            "name": cand["name"], "config": cfg, "compiler": compiler,
            "library": library_of(cfg), "digest": library_digest(cfg),
            "ok": bool(static.get("ok")), "error": static.get("error"),
            "static": static,
            "score": score(static, cfg, card) if static.get("ok") else
            score({}, cfg, card),
        })
    return entries


def rank_entries(entries: List[Dict]) -> List[Dict]:
    """By predicted hashes per second, highest first; unscored entries
    last; ties on fewer spill bytes, then the name."""
    def sort_key(e):
        pred = e.get("score", {}).get("predicted_mhs")
        spills = e.get("static", {}).get("spill_stores")
        return (0 if pred is not None else 1, -(pred or 0.0),
                spills if spills is not None else 1 << 30,
                e.get("name", ""))

    ranked = sorted(entries, key=sort_key)
    for rank, entry in enumerate(ranked, 1):
        entry["rank"] = rank
    return ranked


def backend_of(config: Dict) -> str:
    mesh = "-mesh" if config.get("topology") else ""
    return ("cuda-tile" + mesh if config["kernel"] == "tile"
            else "cuda" + mesh)


def ledger_rows(entries: List[Dict]) -> List[Dict]:
    """``tpu-miner-perfledger/1`` rows: metric ``frontier`` (a model's
    output, kept apart from measured ``sha256d_scan`` rows), the predicted
    MH/s as the value, the geometry at the top level."""
    rows = []
    for entry in entries:
        pred = entry.get("score", {}).get("predicted_mhs")
        if not entry.get("ok") or pred is None:
            continue
        config, static = entry["config"], entry["static"]
        rows.append({
            "metric": "frontier", "value": pred, "unit": "MH/s",
            "backend": backend_of(config), "name": entry["name"],
            "compiler": entry["compiler"], "rank": entry.get("rank"),
            **{k: config.get(k) for k in (
                "kernel", "sublanes", "inner_tiles", "interleave", "vshare",
                "variant", "cgroup", "inner_bits", "unroll", "word7", "spec",
                "topology", "batch_bits")},
            **{f"static_{k}": static.get(k) for k in (
                "registers", "spill_stores", "static_smem", "blocks_per_sm")},
            "static_loop_all": static["loop"]["all"],
            "predicted_ms": entry["score"]["predicted_ms"],
            "digest": entry["digest"],
        })
    return rows


def bench_flags(entry: Dict) -> Optional[str]:
    """The ``python -m bitcoin_miner_tpu_torch.bench`` flags that measure
    this candidate on the card; None for a stub entry (a model's ranking
    is never a plan)."""
    if entry.get("compiler") == "stub":
        return None
    return config_bench_flags(entry.get("config", {}))


def config_bench_flags(config: Dict) -> Optional[str]:
    """The bench flags of a configuration, whoever produced its entry."""
    if config.get("kernel") not in ("tile", "hitbuf"):
        return None
    flags = ["--backend", backend_of(config)]
    if config["kernel"] == "tile":
        sub = config.get("sublanes", 8)
        if sub & (sub - 1):
            # 3·2^n heights run in --batch-3x dispatches; others cannot.
            if sub % 3 or (sub // 3) & (sub // 3 - 1):
                return None
            flags.append("--batch-3x")
        flags += ["--sublanes", str(sub),
                  "--inner-tiles", str(config.get("inner_tiles", 8))]
        if config.get("interleave", 1) != 1:
            flags += ["--interleave", str(config["interleave"])]
        if config.get("variant", "baseline") != "baseline":
            flags += ["--variant", config["variant"]]
        if config.get("cgroup"):
            flags += ["--cgroup", str(config["cgroup"])]
    elif not config.get("topology"):
        flags += ["--inner-bits", str(config.get("inner_bits", 18))]
    flags += ["--vshare", str(config.get("vshare", 1))]
    if config.get("unroll", 64) != 64:
        flags += ["--unroll", str(config["unroll"])]
    if not config.get("spec", True):
        flags.append("--no-spec")
    if config.get("topology"):
        flags += ["--mesh-devices",
                  str(config["topology"]).rsplit("x", 1)[1]]
    return " ".join(flags)


def battery_lines(doc: Dict, top: int) -> List[str]:
    """``name|flags`` of the top ``top`` benchable candidates."""
    lines = []
    for entry in doc.get("ranking", []):
        if len(lines) >= top:
            break
        flags = bench_flags(entry)
        if flags is None or not entry.get("ok"):
            continue
        if entry.get("score", {}).get("predicted_mhs") is None:
            continue
        lines.append(f"{entry['name']}|{flags}")
    return lines


# ----------------------------------------------------------------- cli
def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m bitcoin_miner_tpu_torch frontier",
        description="layout ranker: enumerate the scan kernels' "
                    "configurations, build them with nvcc, read ptxas and "
                    "SASS, rank by the model")
    p.add_argument("--out", default=None,
                   help=f"the ranked document (default {DEFAULT_OUT}; "
                        f"--stub-compiler: {STUB_OUT})")
    p.add_argument("--ledger", default=None,
                   help=f"perf ledger for the rows (default {DEFAULT_LEDGER}"
                        "; none for --stub-compiler; '' disables)")
    p.add_argument("--evidence", default=None, metavar="FILE",
                   help="also append each nvcc entry to this JSONL file")
    p.add_argument("--stub-compiler", action="store_true",
                   help="the deterministic model instead of nvcc: a smoke "
                        "of enumerate→score→rank, rows labelled "
                        "compiler=stub and left out of --battery")
    p.add_argument("--limit", type=int, default=None,
                   help="only the first N candidates")
    p.add_argument("--filter", default=None, metavar="SUBSTR",
                   help="only candidates whose name contains SUBSTR")
    p.add_argument("--recompile", action="store_true",
                   help="read every candidate again, cached or not")
    p.add_argument("--top", type=int, default=None, metavar="N",
                   help="only the candidates in --out's benchable top N")
    p.add_argument("--battery", type=int, default=None, metavar="N",
                   help="print 'name|bench-flags' of the top N benchable "
                        "candidates of --out and exit")
    p.add_argument("--json", action="store_true",
                   help="print the whole document to stdout")
    return p


def resolve_paths(args) -> Tuple[str, Optional[str]]:
    """(out, ledger): explicit flags win; the defaults keep a stub run
    away from the canonical document and from any ledger."""
    out = args.out if args.out is not None else (
        STUB_OUT if args.stub_compiler else DEFAULT_OUT)
    if args.ledger is not None:
        ledger = args.ledger or None
    else:
        ledger = None if args.stub_compiler else DEFAULT_LEDGER
    return out, ledger


def _load_doc(path: str) -> Dict:
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("schema") != SCHEMA:
        raise ValueError(f"{path} is not a {SCHEMA} document")
    return doc


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    out, ledger_path = resolve_paths(args)

    if args.battery is not None:
        try:
            doc = _load_doc(out)
        except (OSError, json.JSONDecodeError, ValueError) as e:
            print(f"frontier: cannot read {out}: {e}", file=sys.stderr)
            return 1
        for line in battery_lines(doc, args.battery):
            print(line)
        return 0

    cands = enumerate_candidates()
    partial = bool(args.filter) or args.limit is not None or (
        args.top is not None)
    if args.top is not None:
        try:
            doc = _load_doc(out)
        except (OSError, json.JSONDecodeError, ValueError) as e:
            print(f"frontier: --top needs an existing ranking at {out}: {e}",
                  file=sys.stderr)
            return 1
        top_names = set()
        for e in sorted(doc.get("ranking", []),
                        key=lambda e: e.get("rank") or (1 << 30)):
            if len(top_names) >= args.top:
                break
            if (config_bench_flags(e.get("config", {})) is None
                    or not e.get("ok")
                    or e.get("score", {}).get("predicted_mhs") is None):
                continue
            top_names.add(e.get("name"))
        cands = [c for c in cands if c["name"] in top_names]
    if args.filter:
        cands = [c for c in cands if args.filter in c["name"]]
    if args.limit is not None:
        cands = cands[:args.limit]
    if not cands:
        print("frontier: no candidates match", file=sys.stderr)
        return 1

    compiler = "stub" if args.stub_compiler else "nvcc"
    card = CARD if args.stub_compiler else card_of_this_machine()
    prior_all = _prior_ranking(out, compiler)
    reuse = {} if args.recompile else _prior_entries(out, compiler,
                                                     prior=prior_all)
    if not args.recompile:
        stale = resume_invalidated(out, compiler, prior=prior_all)
        if stale:
            run_keys = {_config_key(c["cfg"]) for c in cands}
            now = sum(1 for s in stale if s["key"] in run_keys)
            print(f"frontier: resume cache invalidated {len(stale)} prior "
                  f"entr{'y' if len(stale) == 1 else 'ies'} whose library "
                  f"digest changed; {now} read again in this run, "
                  f"{len(stale) - now} carried forward until a run "
                  "enumerates them", file=sys.stderr)
    log = (lambda *a, **k: None) if args.json else print
    entries = evaluate_candidates(cands, args.stub_compiler, reuse, card,
                                  log)
    if partial:
        # A partial run updates its candidates and carries the rest of the
        # document forward, rescored under today's model.
        evaluated = {_config_key(e["config"]) for e in entries}
        for key, prior in prior_all.items():
            if key not in evaluated:
                prior = dict(prior)
                prior["score"] = (score(prior["static"], prior["config"],
                                        card) if prior.get("ok")
                                  else score({}, prior["config"], card))
                entries.append(prior)
    ranked = rank_entries(entries)
    doc = {"schema": SCHEMA,
           "generated": time.strftime("%Y-%m-%dT%H:%MZ", time.gmtime()),
           "compiler": compiler, "card": card,
           "model": {"efficiency": EFFICIENCY, "sass_over_ops": SASS_OVER_OPS,
                     "warps_to_hide": WARPS_TO_HIDE,
                     "spill_slots": SPILL_SLOTS,
                     "shared_slots": SHARED_SLOTS,
                     "calibrated_on": CARD["name"]},
           "n_candidates": len(ranked), "ranking": ranked}
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    tmp = out + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")
    os.replace(tmp, out)

    rows = ledger_rows(ranked)
    if ledger_path and rows:
        from ..telemetry.perfledger import (
            PerfLedger,
            content_key,
            env_fingerprint,
        )

        ledger = PerfLedger(ledger_path)

        def dedup_key(raw: Dict) -> str:
            # A row is its config, read and score, not its append minute
            # or its rank (another candidate shifts every rank below it).
            return content_key({k: v for k, v in raw.items()
                                if k not in ("measured", "rank")})

        seen = {dedup_key(r.raw) for r in ledger.load()}
        fresh = []
        for row in rows:
            key = dedup_key(row)
            if key not in seen:
                seen.add(key)
                fresh.append(row)
        ledger.append_many(fresh, fingerprint=env_fingerprint())
        log(f"ledger: {len(fresh)} new row(s) -> {ledger_path} "
            f"({len(rows) - len(fresh)} already present)")
    if args.evidence and compiler == "nvcc":
        ts = time.strftime("%Y-%m-%dT%H:%MZ", time.gmtime())
        with open(args.evidence, "a", encoding="utf-8") as fh:
            for entry in ranked:
                if entry.get("ok"):
                    fh.write(json.dumps({
                        "metric": "frontier", "measured": ts,
                        "name": entry["name"], "rank": entry["rank"],
                        "card": card["name"], **entry["config"],
                        **{k: v for k, v in entry["score"].items()
                           if v is not None}}) + "\n")

    if args.json:
        print(json.dumps(doc, indent=1))
    else:
        print(f"\nfrontier ({compiler}): {len(ranked)} candidates on "
              f"{card['name']}")
        print("| rank | candidate | registers | spill bytes | blocks/SM "
              "| bound ms | predicted ms | predicted MH/s |")
        print("|---|---|---|---|---|---|---|---|")
        for entry in ranked:
            st, sc = entry.get("static", {}), entry.get("score", {})
            print(f"| {entry['rank']} | {entry['name']} "
                  f"| {st.get('registers', '—')} "
                  f"| {st.get('spill_stores', '—')} "
                  f"| {st.get('blocks_per_sm', '—')} "
                  f"| {sc.get('bound_ms', '—')} "
                  f"| {sc.get('predicted_ms', '—')} "
                  f"| {sc.get('predicted_mhs', '—')} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
