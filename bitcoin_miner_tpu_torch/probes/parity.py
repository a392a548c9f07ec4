"""Bulk parity gate: the CUDA kernels against the native CPU oracle and
hashlib at volume (about 10^6 hashes a leg).

Counterpart of ``benchmarks/parity_tpu.py``, run as ``python -m
bitcoin_miner_tpu_torch.probes.parity``. Every configuration runs on the
card unless ``--device cpu`` asks for the plain PyTorch versions; there is
no fallback. The legs:

- A, ``scan_exact``: 16 random headers at target 2^248 (a nonzero top
  limb: exact kernels, about 2^-8 hits per nonce); each hasher's
  ``scan`` hit set and total against the native oracle's
  (``backends/native.py``). ``CudaHasher`` (``cuda``) in its default form
  and each compile form; ``TileCudaHasher`` (``cuda-tile``, 8 sublanes × 8
  inner tiles) in the baseline, each layout the smoke drives at K=1
  (``ops.sha256_tile.driven_layouts``) and each compile form. At this hit
  rate every 8192-nonce step holds about 32 hits, so every step goes
  through ``rescan_steps``. The hits must exceed half the expected number.
- B, ``word7_digest``: the reference jits ``sha256d_midstate_word7`` alone;
  here that code runs inside the hit-buffer kernel, so its word7 mode is
  held at the scan level: 4 random headers at a top target limb of
  0x00FFFFFF (candidates at about 2^-8), the buffered candidates (first
  ``max_hits`` in nonce order) and their uncapped count against a
  hashlib-derived expectation (``bswap32(d7) <= t0``), in the default form
  and each compile form.
- C, ``tile_word7``: the raw ``scan_tile(..., word7=True)`` per-step
  (count, min) slots over ``min(2^bits, 2^19)`` nonces at that limb, step
  by step against the same expectation; the baseline, each layout at K=1
  and each compile form.
- D, ``vshare_siblings``: mask 0x1FFFE000, 8 random headers, both backends
  at each ``--vshare-ks`` K (the tile kernel also in each layout and
  compile form built at that K): chain 0 against the oracle, each
  sibling's ``version_hits`` against an oracle scan of that sibling's own
  header, and no hit under a version outside ``sibling_version_patterns``.

Each oracle answer is computed once per seeded header set and reused by
every configuration held against it. One JSON line per leg and
configuration (the reference's keys, with ``config`` and the kernel
``libraries`` it launches), then a ``parity_bulk_summary`` line; rc 0 only
if every configuration ran with zero mismatches, else 2. ``--evidence``
appends each line to a JSONL file.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import random
import sys
import time
from datetime import datetime, timezone
from typing import Callable, Dict, Iterator, List, Optional, Tuple

#: The reference's seed (``parity_tpu.py``).
SEED = 0x7A17
#: Leg A and D's target: top limb 0x01000000, exact kernels, ~2^-8 hits.
TARGET_EXACT = 1 << 248
#: Legs B and C's top target limb: word7 candidates at ~2^-8.
WORD7_T0 = 0x00FFFFFF
VSHARE_MASK = 0x1FFFE000
MAX_HITS = 4096
#: The tile hasher's geometry in every leg (``_make_hasher``'s), and its
#: least dispatch: two steps of it, so that every layout runs as
#: configured (vroll-db pipelines two tile groups) also where a header's
#: range is smaller (a CPU run); a dispatch's limit cuts the range.
SUBLANES = INNER_TILES = 8
MIN_TILE_BATCH = 2 * SUBLANES * 128 * INNER_TILES
#: The compile forms beside the default: (unroll, spec), as the smoke
#: builds them (the tile kernel at K = 1, 2, the hit buffer at K = 1).
FORMS = ((8, True), (16, True), (32, True), (64, False))
FORM_KS = {"cuda-tile": (1, 2), "cuda": (1,)}
BACKENDS = ("cuda", "cuda-tile")
#: Leg C's most nonces (the reference's ``min(bits, 19)``).
WORD7_TILE_NONCES = 1 << 19


def _evidence(path: Optional[str], rec: dict) -> None:
    if not path:
        return
    rec = dict(rec)
    rec["measured"] = datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%MZ")
    with open(path, "a", encoding="utf-8") as fh:
        fh.write(json.dumps(rec) + "\n")


def cpu_word7(header76: bytes, nonces) -> List[int]:
    """hashlib-derived digest word 7 (big-endian word order) per nonce:
    the reference's ``_cpu_word7``, with chunk 1 hashed once."""
    chunk1 = hashlib.sha256(header76[:64])
    tail = header76[64:76]
    out = []
    for n in nonces:
        h = chunk1.copy()
        h.update(tail + int(n).to_bytes(4, "little"))
        out.append(int.from_bytes(hashlib.sha256(h.digest()).digest()[28:32],
                                  "big"))
    return out


def word7_candidates(header76: bytes, start: int, count: int,
                     t0: int = WORD7_T0) -> List[bool]:
    """Per nonce of ``[start, start + count)``: is it a word7 candidate,
    ``bswap32(d7) <= t0`` (the kernels' test)?"""
    nonces = [(start + i) & 0xFFFFFFFF for i in range(count)]
    return [int.from_bytes(d.to_bytes(4, "big"), "little") <= t0
            for d in cpu_word7(header76, nonces)]


class Oracle:
    """The native CPU oracle's scans, each computed once."""

    def __init__(self) -> None:
        from ..backends import native

        self._scan = native.scan
        self._cache: Dict[tuple, Tuple[List[int], int]] = {}

    def scan(self, header76: bytes, start: int, count: int,
             target: int = TARGET_EXACT) -> Tuple[List[int], int]:
        key = (header76, start, count, target)
        if key not in self._cache:
            self._cache[key] = self._scan(header76, start, count, target,
                                          MAX_HITS)
        return self._cache[key]


def _form(unroll: int, spec: bool) -> dict:
    return {} if (unroll, spec) == (64, True) else {"unroll": unroll,
                                                    "spec": spec}


def configs(backend: str, k: int = 1) -> List[dict]:
    """The configurations of ``backend`` held at K = ``k`` chains: the
    default; for ``cuda-tile`` each layout the smoke drives at K; each
    compile form the smoke builds at K."""
    from ..ops.sha256_tile import driven_layouts

    out = [{"backend": backend, "vshare": k}]
    if backend == "cuda-tile":
        out += [{"backend": backend, "vshare": k, "variant": v,
                 **({"cgroup": g} if g else {}),
                 **({"interleave": i} if i > 1 else {})}
                for kk, v, g, i in driven_layouts() if kk == k]
    if k in FORM_KS[backend]:
        out += [{"backend": backend, "vshare": k, **_form(u, sp)}
                for u, sp in FORMS]
    return out


def make_hasher(config: dict, per_header: int, device: str):
    """The hasher of one configuration, sized as the reference's
    ``_make_hasher``: one dispatch per header's range (the tile hasher's
    at least :data:`MIN_TILE_BATCH` nonces)."""
    from ..backends.cuda import CudaHasher, TileCudaHasher

    form = {key: config[key] for key in ("unroll", "spec") if key in config}
    if config["backend"] == "cuda-tile":
        return TileCudaHasher(
            batch_size=max(per_header, MIN_TILE_BATCH), sublanes=SUBLANES, inner_tiles=INNER_TILES,
            interleave=config.get("interleave", 1), max_hits=MAX_HITS,
            vshare=config["vshare"], variant=config.get("variant",
                                                        "baseline"),
            cgroup=config.get("cgroup", 0), device=device, **form)
    return CudaHasher(batch_size=per_header,
                      inner_size=min(per_header, 1 << 14), max_hits=MAX_HITS,
                      vshare=config["vshare"], device=device, **form)


def config_libraries(config: dict) -> List[str]:
    """The kernel libraries (launch counters) a hasher of ``config``
    launches at this leg's hit rates: the tile layout's scan and the
    form's ``rescan_steps``, or the hit-buffer scan."""
    from ..ops.sha256_tile import tile_library
    from ..ops.sha256_torch import hitbuf_library, rescan_counter

    unroll, spec = config.get("unroll", 64), config.get("spec", True)
    if config["backend"] == "cuda-tile":
        return [tile_library(config["vshare"], config.get("variant",
                                                          "baseline"),
                             config.get("cgroup", 0),
                             config.get("interleave", 1), unroll, spec),
                rescan_counter(unroll, spec)]
    return [hitbuf_library(config["vshare"], unroll, spec)]


def _headers(rng: random.Random, n: int, per_header: int
             ) -> List[Tuple[bytes, int]]:
    """``n`` random headers, each with a start whose range never wraps
    (a wrapped range has unspecified oracle behaviour)."""
    out = []
    for _ in range(n):
        header76 = rng.randbytes(76)
        out.append((header76, rng.randrange((1 << 32) - per_header)))
    return out


def leg_scan_exact(bits: int, rng: random.Random, backends, device: str,
                   oracle: Oracle, hasher_factory=None) -> Iterator[dict]:
    """Leg A, one record per configuration."""
    n_headers = 16
    per_header = (1 << bits) // n_headers
    headers = _headers(rng, n_headers, per_header)
    factory = hasher_factory or make_hasher
    for backend in backends:
        for config in configs(backend):
            def run(config=config):
                hasher = factory(config, per_header, device)
                mismatches = hits = 0
                for header76, start in headers:
                    got = hasher.scan(header76, start, per_header,
                                      TARGET_EXACT, max_hits=MAX_HITS)
                    want, total = oracle.scan(header76, start, per_header)
                    if got.nonces != want or got.total_hits != total:
                        mismatches += 1
                    hits += got.total_hits
                hashes = n_headers * per_header
                rec = {"metric": "parity_bulk", "leg": "scan_exact",
                       "backend": backend, "hashes": hashes, "hits": hits,
                       "mismatched_headers": mismatches,
                       "ok": mismatches == 0}
                if hits <= (hashes >> 8) // 2:
                    rec.update(ok=False, error=f"too few hits ({hits}): "
                               "the target plumbing is broken")
                return rec
            yield _timed("scan_exact", run, config)


def _job_parts(job, device):
    """(midstate, tail3, limbs, base, limit) of a one-chain job block."""
    job = job.to(device)
    return job[0:8], job[16:19], job[19:27], job[27], job[28]


def leg_word7_digest(bits: int, rng: random.Random, device: str
                     ) -> Iterator[dict]:
    """Leg B, one record per compile form of the hit-buffer kernel."""
    import torch

    from ..ops.sha256_tile import job_block_from_header
    from ..ops.sha256_torch import scan_batch

    n_headers = 4
    per_header = (1 << bits) // n_headers
    inner = min(per_header, 1 << 14)
    target = WORD7_T0 << 224
    cases = []
    for header76, start in _headers(rng, n_headers, per_header):
        cand = word7_candidates(header76, start, per_header)
        want = [(start + i) & 0xFFFFFFFF for i, c in enumerate(cand) if c]
        cases.append((header76, start, want))
    for form in [{}] + [_form(u, sp) for u, sp in FORMS]:
        config = {"backend": "cuda", "vshare": 1, **form}

        def run(form=form):
            mismatches = candidates = 0
            for header76, start, want in cases:
                parts = _job_parts(job_block_from_header(
                    header76, target, start, per_header), device)
                buf, count = scan_batch(*parts, inner_size=inner,
                                        n_steps=per_header // inner,
                                        max_hits=MAX_HITS, word7=True,
                                        **form)
                got = buf.cpu().to(torch.int64).tolist()[:min(
                    int(count), MAX_HITS)]
                mismatches += sum(a != b for a, b in zip(got, want))
                mismatches += abs(len(got) - min(len(want), MAX_HITS))
                mismatches += int(count) != len(want)
                candidates += len(want)
            return {"metric": "parity_bulk", "leg": "word7_digest",
                    "backend": "cuda", "hashes": n_headers * per_header,
                    "candidates": candidates, "mismatches": mismatches,
                    "ok": mismatches == 0}
        yield _timed("word7_digest", run, config)


def leg_tile_word7(bits: int, rng: random.Random, device: str
                   ) -> Iterator[dict]:
    """Leg C, one record per layout and compile form at K=1."""
    import torch

    from ..ops.sha256_tile import job_block_from_header, scan_tile

    batch = min(1 << bits, WORD7_TILE_NONCES)
    tile = SUBLANES * 128 * INNER_TILES
    tile = min(tile, batch)
    header76 = rng.randbytes(76)
    start = rng.randrange((1 << 32) - batch)
    cand = word7_candidates(header76, start, batch)
    want = []
    for t in range(batch // tile):
        hit = [start + t * tile + i for i in range(tile) if cand[t * tile + i]]
        want.append((len(hit), min(hit) if hit else 0xFFFFFFFF))
    job = job_block_from_header(header76, WORD7_T0 << 224, start, batch)
    for config in configs("cuda-tile"):
        def run(config=config):
            counts, mins = scan_tile(
                job.to(device), n_steps=batch // tile, block=tile, word7=True,
                variant=config.get("variant", "baseline"),
                cgroup=config.get("cgroup", 0),
                interleave=config.get("interleave", 1),
                host_words=job.numpy(), unroll=config.get("unroll", 64),
                spec=config.get("spec", True))
            got = list(zip(counts.cpu().tolist(),
                           mins.cpu().to(torch.int64).tolist()))
            mismatched = sum(a != b for a, b in zip(got, want)) + abs(
                len(got) - len(want))
            return {"metric": "parity_bulk", "leg": "tile_word7",
                    "backend": "cuda-tile", "hashes": batch,
                    "candidates": sum(cand), "mismatched_tiles": mismatched,
                    "ok": mismatched == 0}
        yield _timed("tile_word7", run, config,
                     libraries=config_libraries(config)[:1])


def leg_vshare_siblings(bits: int, rng: random.Random, backends, device: str,
                        oracle: Oracle, ks=(4,), hasher_factory=None
                        ) -> Iterator[dict]:
    """Leg D, one record per configuration and K."""
    from ..backends.cuda import sibling_version_patterns

    n_headers = 8
    per_header = (1 << bits) // n_headers
    headers = _headers(rng, n_headers, per_header)
    factory = hasher_factory or make_hasher
    for k in ks:
        patterns = sibling_version_patterns(VSHARE_MASK, k)
        for backend in backends:
            for config in configs(backend, k):
                def run(config=config, k=k, patterns=patterns):
                    hasher = factory(config, per_header, device)
                    reserved = hasher.set_version_mask(VSHARE_MASK)
                    mismatches = chain0 = siblings = 0
                    for header76, start in headers:
                        res = hasher.scan(header76, start, per_header,
                                          TARGET_EXACT, max_hits=MAX_HITS)
                        want, total = oracle.scan(header76, start, per_header)
                        if res.nonces != want or res.total_hits != total:
                            mismatches += 1
                        chain0 += res.total_hits
                        version = int.from_bytes(header76[0:4], "little")
                        got_by_version: Dict[int, List[int]] = {}
                        for v, n in res.version_hits:
                            got_by_version.setdefault(int(v), []).append(
                                int(n))
                        for pat in patterns:
                            sib = version ^ pat
                            sib_header = sib.to_bytes(4, "little") + (
                                header76[4:])
                            want_sib, _ = oracle.scan(sib_header, start,
                                                      per_header)
                            got = sorted(got_by_version.pop(sib, []))
                            if got != sorted(want_sib):
                                mismatches += 1
                            siblings += len(got)
                        if got_by_version:  # versions outside the patterns
                            mismatches += 1
                    return {"metric": "parity_bulk",
                            "leg": "vshare_siblings", "backend": backend,
                            "vshare": k, "reserved_bits": reserved,
                            "hashes": n_headers * per_header * k,
                            "chain0_hits": chain0, "sibling_hits": siblings,
                            "mismatched_headers": mismatches,
                            "ok": mismatches == 0}
                yield _timed("vshare_siblings", run, config)


def _timed(leg: str, run: Callable[[], dict], config: dict,
           libraries: Optional[List[str]] = None) -> dict:
    """``run()``'s record with its configuration, its libraries and its
    seconds; an exception is a failed record, never a traceback."""
    t0 = time.perf_counter()
    try:
        rec = run()
    except Exception as e:  # noqa: BLE001 — evidence, not a traceback
        rec = {"metric": "parity_bulk", "leg": leg,
               "backend": config["backend"], "ok": False,
               "error": f"{type(e).__name__}: {e}"[:400]}
    rec["config"] = config
    rec["libraries"] = (libraries if libraries is not None
                        else config_libraries(config))
    rec["seconds"] = round(time.perf_counter() - t0, 3)
    return rec


def run_gate(bits: int = 20, backends=BACKENDS, legs: str = "all",
             device: str = "cuda", ks=(4,), evidence: Optional[str] = None,
             emit: Callable[[dict], None] = None,
             hasher_factory=None) -> Tuple[List[dict], bool]:
    """Every leg of ``legs`` (all, core = A-C, vshare = D) on ``device``:
    the records, each passed to ``emit`` as it lands, and whether every
    one is ok. The summary record ends the list."""
    rng = random.Random(SEED)
    oracle = Oracle()
    emit = emit or (lambda rec: print(json.dumps(rec), flush=True))
    backends = [b for b in backends if b]
    unknown = [b for b in backends if b not in BACKENDS]
    if unknown:
        raise ValueError(f"unknown backend(s) {unknown}; have {BACKENDS}")
    gens = []
    if legs in ("all", "core"):
        gens.append(lambda: leg_scan_exact(bits, rng, backends, device,
                                           oracle, hasher_factory))
        if "cuda" in backends:
            gens.append(lambda: leg_word7_digest(bits, rng, device))
        if "cuda-tile" in backends:
            gens.append(lambda: leg_tile_word7(bits, rng, device))
    if legs in ("all", "vshare"):
        gens.append(lambda: leg_vshare_siblings(bits, rng, backends, device,
                                                oracle, ks, hasher_factory))
    records = []
    t0 = time.perf_counter()
    for gen in gens:
        for rec in gen():
            records.append(rec)
            emit(rec)
            _evidence(evidence, rec)
    ok = bool(records) and all(r.get("ok") for r in records)
    summary = {"metric": "parity_bulk_summary", "ok": ok,
               "configurations": len(records),
               "failed": sum(not r.get("ok") for r in records),
               "hashes": sum(r.get("hashes", 0) for r in records),
               "device": device, "bits": bits,
               "seconds": round(time.perf_counter() - t0, 3)}
    records.append(summary)
    emit(summary)
    _evidence(evidence, summary)
    return records, ok


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m bitcoin_miner_tpu_torch.probes.parity",
        description=__doc__.splitlines()[0])
    p.add_argument("--bits", type=int, default=20,
                   help="log2 hashes per leg (default 2^20, about 10^6)")
    p.add_argument("--backends", default=",".join(BACKENDS),
                   help="comma-separated: cuda | cuda-tile")
    p.add_argument("--legs", default="all", choices=("all", "core", "vshare"),
                   help="core = legs A-C; vshare = leg D only")
    p.add_argument("--vshare-ks", default="4",
                   help="leg D's chain counts, comma-separated (default 4, "
                        "the reference's)")
    p.add_argument("--evidence", default=None, metavar="PATH",
                   help="append every line to this JSONL file")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the card, or the plain PyTorch versions on the CPU")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    ks = tuple(int(k) for k in args.vshare_ks.split(",") if k.strip())
    backends = [b.strip() for b in args.backends.split(",")]
    try:
        _, ok = run_gate(args.bits, backends, args.legs, args.device, ks,
                         args.evidence)
    except ValueError as e:
        print(f"parity: {e}", file=sys.stderr)
        return 2
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
