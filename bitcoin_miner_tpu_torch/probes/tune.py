"""Layout tuner: times kernel configurations of the two CUDA backends on
the genesis sweep, best first.

Counterpart of ``benchmarks/tune.py``, run as ``python -m
bitcoin_miner_tpu_torch.probes.tune``. The supervisor/worker split is the
reference's: the configurations of each backend run in one child process
(one card context and one set of built libraries for the batch), and the
supervisor streams the child's JSON lines with a per-configuration
inactivity watchdog: a configuration that hangs costs itself, not the
sweep, and two consecutive kills abort the rest. A configuration the
kernel refuses (``check_layout``, a form the backend lacks) is a row with
``ok: false`` and its error; it is never replaced by another one (a
geometry the hasher would clamp is refused too).

The worker builds the port's hasher (``cuda``: ``CudaHasher``;
``cuda-tile``: ``TileCudaHasher``), scans one dispatch over the genesis
nonce to warm up (the nvcc builds and library loads stay out of the
timing), then times ``scan`` over ``2^sweep_bits`` nonces around the
genesis nonce, which it must find. Every run is on the card unless
``--device cpu`` asks for the plain PyTorch versions.

Dropped from the reference: the TPU pool probe (``--no-probe``) and the
read-back of ``--adopt``'s file as the bench's or the command line's
defaults: ``--adopt`` writes the winner, and nothing reads it by default.
Outputs default under ``build/tune/``.
"""

from __future__ import annotations

import argparse
import json
import os
import select
import subprocess
import sys
import time
from datetime import datetime, timezone
from pathlib import Path
from typing import Dict, List, Optional, Tuple

# One derived-cgroup rule with the perf ledger (import-safe: the ledger
# module imports no torch): the variants whose default chain pass is 1.
from ..telemetry.perfledger import PER_CHAIN_PASS_VARIANTS

ROOT = Path(__file__).resolve().parents[2]
DEFAULT_OUT = str(ROOT / "build" / "tune" / "tune.json")
BACKENDS = ("cuda", "cuda-tile")
CONFIG_KEYS = ("backend", "sublanes", "unroll", "batch_bits", "inner_bits",
               "inner_tiles", "interleave", "vshare", "spec", "variant",
               "cgroup", "topology")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m bitcoin_miner_tpu_torch.probes.tune",
        description=__doc__.splitlines()[0])
    p.add_argument("--backends", default=",".join(BACKENDS),
                   help="comma-separated: cuda | cuda-tile")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the card, or the plain PyTorch versions on the CPU")
    p.add_argument("--sweep-bits", type=int, default=26,
                   help="log2 nonces timed per configuration")
    p.add_argument("--attempt-timeout", type=float, default=420.0,
                   help="seconds of child inactivity before it is killed")
    p.add_argument("--budget", type=float, default=None,
                   help="overall wall-clock budget (s); no new child starts "
                        "past it and a running child is cut off at it")
    p.add_argument("--quick", action="store_true",
                   help="tiny shapes, CPU-sized (a smoke of the rig)")
    p.add_argument("--limit", type=int, default=None, metavar="N",
                   help="only the first N configurations of each backend's "
                        "grid")
    p.add_argument("--out", default=DEFAULT_OUT,
                   help="the results JSON (default %(default)s)")
    p.add_argument("--evidence", default=None,
                   help="append each ok measurement to this JSONL file as "
                        "it lands")
    p.add_argument("--adopt", default=None, metavar="TUNED_JSON",
                   help="write the best configuration here (nothing reads "
                        "it back by default)")
    p.add_argument("--skip-measured", action="store_true",
                   help="drop grid configurations whose normalised key "
                        "already has an ok row in --out")
    p.add_argument("--around", default=None, metavar="TUNED_JSON",
                   help="sweep a neighbourhood of the configuration in "
                        "this file (an --adopt file) instead of the grid")
    p.add_argument("--worker-config", default=None, help=argparse.SUPPRESS)
    return p


def neighborhood(center: dict) -> list:
    """Single-knob steps around a measured winner, the centre excluded
    (already measured): a regression is attributable to one knob."""
    backend = center.get("backend", "cuda")
    out, seen = [], set()

    def push(**kv):
        cfg = {k: center.get(k) for k in CONFIG_KEYS
               if center.get(k) is not None}
        cfg.update(kv)
        cfg["backend"] = backend
        key = _key(cfg)
        if key not in seen and key != _key(center):
            seen.add(key)
            out.append(cfg)

    if backend == "cuda-tile":
        s = center.get("sublanes", 8)
        t = center.get("inner_tiles", 8)
        b = center.get("batch_bits", 24)
        v = center.get("interleave", 1)
        for s2 in (max(8, s // 2), s * 2):
            push(sublanes=s2)
        for t2 in (max(1, t // 2), t * 2, t * 4):
            if t2 % v == 0:
                push(inner_tiles=t2)
        for v2 in (max(1, v // 2), v * 2):
            if v2 != v and t % v2 == 0:
                push(interleave=v2)
        ks = center.get("vshare", 1)
        for k2 in (max(1, ks // 2), ks * 2):
            if k2 != ks and k2 <= 8:
                cg = center.get("cgroup")
                if cg and cg > k2:
                    # g <= k: a halved vshare clamps an explicit chain pass.
                    push(vshare=k2, cgroup=k2)
                else:
                    push(vshare=k2)
        if ks > 1:
            g = center.get("cgroup") or (
                1 if center.get("variant") in PER_CHAIN_PASS_VARIANTS
                else ks)
            for g2 in (max(1, g // 2), min(ks, g * 2)):
                if g2 != g:
                    push(cgroup=g2)
        for b2 in (b - 1, b + 1):
            if 14 <= b2 <= 27:
                push(batch_bits=b2)
    else:
        i = center.get("inner_bits", 18)
        b = center.get("batch_bits", 24)
        for i2 in (i - 2, i - 1, i + 1, i + 2):
            if 10 <= i2 <= b:
                push(inner_bits=i2)
        for b2 in (b - 1, b + 1):
            if 14 <= b2 <= 27:
                push(batch_bits=b2, inner_bits=min(i, b2))
        ks = center.get("vshare", 1)
        for k2 in (max(1, ks // 2), ks * 2):
            # The k-chain hit-buffer scan has only spec forms.
            if (k2 != ks and k2 <= 8 and center.get("spec", True)
                    and center.get("unroll", 64) >= 64):
                push(vshare=k2)
    return out


def grid(backend: str, quick: bool) -> List[dict]:
    """The sweep grid, fastest first by the card times per hash of PERF.md
    §6 (``chip_smoke.py``'s ``timings``, NVIDIA H100 80GB HBM3, 700.00 W;
    ms per 2^24-nonce launch ÷ K): a short budget still measures the
    likely winners. The geometry is the command line's (8 sublanes × 8
    inner tiles, 2^24-nonce dispatches), where those times were taken."""
    if quick:
        if backend == "cuda-tile":
            return [dict(backend=backend, batch_bits=15, sublanes=8,
                         inner_tiles=8, unroll=64)]
        return [dict(backend=backend, batch_bits=15, inner_bits=13,
                     unroll=64)]
    if backend == "cuda-tile":
        rows = (
            # (K, variant, cgroup, interleave, unroll, spec): ms per K
            (4, "wsplit", 0, 1, 64, True),      # 8.606 / 4 = 2.152
            (4, "regchain", 0, 1, 64, True),    # 8.683 / 4 = 2.171
            (2, "regchain", 0, 2, 64, True),    # 4.527 / 2 = 2.264
            (2, "regchain", 0, 1, 64, True),    # 4.563 / 2 = 2.282
            (2, "baseline", 0, 1, 64, True),    # 4.597 / 2 = 2.299
            (8, "baseline", 0, 1, 64, True),    # 18.44 / 8 = 2.305
            (2, "wsplit", 0, 1, 64, True),      # 4.620 / 2 = 2.310
            (8, "wsplit", 0, 1, 64, True),      # 18.65 / 8 = 2.331
            (4, "baseline", 0, 1, 64, True),    # 9.331 / 4 = 2.333
            (1, "regchain", 0, 1, 64, True),    # 2.399
            (1, "baseline", 0, 1, 64, True),    # 2.410, the default
            (1, "wstage", 0, 1, 64, True),      # 2.484
            (1, "vroll", 0, 1, 64, True),       # 2.495
            (1, "baseline", 0, 1, 64, False),   # 2.593, the spec control
            (1, "vroll-db", 0, 1, 64, True),    # 2.756
            (1, "baseline", 0, 1, 16, True),    # 2.920, a rolled form
        )
        return [dict(backend=backend, sublanes=8, inner_tiles=8,
                     batch_bits=24, unroll=u, vshare=k,
                     **({"variant": v} if v != "baseline" else {}),
                     **({"cgroup": g} if g else {}),
                     **({"interleave": i} if i > 1 else {}),
                     **({} if sp else {"spec": False}))
                for k, v, g, i, u, sp in rows]
    rows = (
        # (K, unroll, spec): ms per K
        (4, 64, True),    # 8.673 / 4 = 2.168
        (2, 64, True),    # 4.4587 / 2 = 2.229
        (1, 64, True),    # 2.4126, the default
        (1, 64, False),   # 2.524, the spec control
        (1, 16, True),    # 3.000
        (1, 8, True),     # 3.023
        (1, 32, True),    # 3.035
    )
    return [dict(backend=backend, inner_bits=18, batch_bits=24, unroll=u,
                 **({"vshare": k} if k > 1 else {}),
                 **({} if sp else {"spec": False}))
            for k, u, sp in rows]


# --------------------------------------------------------------------- worker
def run_worker_batch(configs: list) -> int:
    """Time a list of configurations in one process: one card context and
    one set of loaded libraries for the batch. A configuration that raises
    is reported and the next one runs; only a hang or a crash loses the
    rest (the supervisor keeps every line already printed)."""
    rc = 0
    for config in configs:
        if run_worker(config):
            rc = 1
    return rc


def make_hasher(config: dict):
    """The hasher of one configuration, on ``config["device"]``."""
    from ..backends.cuda import CudaHasher, TileCudaHasher

    batch = 1 << config["batch_bits"]
    common = dict(vshare=config.get("vshare", 1),
                  device=config.get("device", "cuda"),
                  unroll=config.get("unroll", 64),
                  spec=config.get("spec", True))
    if config["backend"] == "cuda-tile":
        return TileCudaHasher(batch_size=batch,
                              sublanes=config.get("sublanes", 8),
                              inner_tiles=config.get("inner_tiles", 8),
                              interleave=config.get("interleave", 1),
                              variant=config.get("variant", "baseline"),
                              cgroup=config.get("cgroup", 0) or 0, **common)
    if config["backend"] == "cuda":
        return CudaHasher(batch_size=batch,
                          inner_size=1 << config.get("inner_bits", 18),
                          **common)
    raise ValueError(f"unknown backend {config['backend']!r}; have "
                     f"{BACKENDS}")


def run_worker(config: dict) -> int:
    """Time one configuration; print one JSON line. Child process only
    (or a caller that wants the measurement in its own process)."""
    out = dict(config)
    try:
        from ..core.header import GENESIS_HEADER_HEX, GENESIS_NONCE
        from ..core.target import nbits_to_target

        header76 = bytes.fromhex(GENESIS_HEADER_HEX)[:76]
        target = nbits_to_target(0x1D00FFFF)
        hasher = make_hasher(config)
        if config["backend"] == "cuda-tile":
            ran = (hasher.inner_tiles, hasher.interleave)
            asked = (config.get("inner_tiles", 8),
                     config.get("interleave", 1))
            if ran != asked:
                raise ValueError(
                    f"the hasher clamps inner_tiles/interleave {asked} to "
                    f"{ran}: not measured under another configuration")
        batch = hasher.batch_size
        t0 = time.perf_counter()
        hasher.scan(header76, GENESIS_NONCE - batch // 2, batch, target)
        compile_s = time.perf_counter() - t0
        count = 1 << config["sweep_bits"]
        start = max(0, GENESIS_NONCE - count // 2)
        count = min(count, (1 << 32) - start)
        t0 = time.perf_counter()
        result = hasher.scan(header76, start, count, target)
        dt = time.perf_counter() - t0
        ok = GENESIS_NONCE in result.nonces
        out.update(mhs=round(result.hashes_done / dt / 1e6, 2) if ok else 0.0,
                   hashes=result.hashes_done, seconds=round(dt, 4),
                   compile_s=round(compile_s, 1), ok=ok,
                   error=None if ok else "genesis nonce missed")
    except Exception as e:  # noqa: BLE001 — one bad config != dead sweep
        out.update(mhs=0.0, ok=False, error=f"{type(e).__name__}: {e}"[:300])
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


# ----------------------------------------------------------------- supervisor
#: Knobs whose absence means the default :func:`make_hasher` applies (the
#: command line's), so that a row written without a knob keys like one
#: that spells its default out.
_KEY_DEFAULTS = {"sublanes": 8, "inner_tiles": 8, "interleave": 1,
                 "vshare": 1, "spec": True, "variant": "baseline",
                 "unroll": 64}


def _key(config: dict) -> str:
    norm = {k: config.get(k) for k in CONFIG_KEYS}
    for k, default in _KEY_DEFAULTS.items():
        if norm[k] is None:
            norm[k] = default
    if norm["backend"] != "cuda-tile":
        # The hit-buffer backend has no tile geometry or layout.
        for k in ("sublanes", "inner_tiles", "interleave", "variant",
                  "cgroup"):
            norm[k] = None
    elif not norm.get("cgroup"):
        # The default chain pass is variant-derived (one rule with the
        # perf ledger): absent or 0 keys as the size that ran.
        norm["cgroup"] = (1 if norm["variant"] in PER_CHAIN_PASS_VARIANTS
                          else norm["vshare"])
    return json.dumps(norm)


def merge_prior_ok(results: list, out_path: str) -> list:
    """This run's results, and the prior ok rows of an existing ``--out``
    file whose configurations this run did not measure again: a failed
    re-run never clobbers an earlier measurement."""
    try:
        prior = json.load(open(out_path)).get("results", [])
    except (OSError, json.JSONDecodeError, AttributeError):
        prior = []
    run_keys = {_key(r) for r in results}
    return results + [r for r in prior
                      if r.get("ok") and _key(r) not in run_keys]


def _append_evidence(path: str, res: dict) -> None:
    ts = datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%MZ")
    knobs = {k: v for k, v in res.items()
             if k in CONFIG_KEYS[1:] and v is not None}
    line = {"metric": "sha256d_scan", "value": res["mhs"], "unit": "MH/s",
            "backend": res["backend"], "device": res.get("device", "cuda"),
            "measured": ts, "note": f"tune sweep config {knobs}"}
    with open(path, "a", encoding="utf-8") as fh:
        fh.write(json.dumps(line) + "\n")


def worker_command(configs: list) -> list:
    """The child that times ``configs``: this module with
    ``--worker-config``."""
    return [sys.executable, "-m", "bitcoin_miner_tpu_torch.probes.tune",
            "--worker-config",
            json.dumps(configs)]


def stream_batch(cmd: list, inactivity_timeout: float,
                 deadline: Optional[float]) -> Tuple[Dict[str, dict], bool]:
    """Run one worker batch, harvesting its result lines as they appear.

    Returns (results by key, aborted): the child is killed when no new
    result line lands within ``inactivity_timeout`` or past ``deadline``;
    every line printed before that is kept."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, cwd=str(ROOT))
    got: Dict[str, dict] = {}
    aborted = False
    buf = b""
    fd = proc.stdout.fileno()
    os.set_blocking(fd, False)
    last_line = time.monotonic()

    def harvest(lines) -> None:
        nonlocal last_line
        for line in lines:
            line = line.strip()
            if not line.startswith(b"{"):
                continue
            try:
                res = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "backend" in res:
                got[_key(res)] = res
                last_line = time.monotonic()

    try:
        while True:
            if proc.poll() is not None:
                try:
                    buf += proc.stdout.read() or b""
                except OSError:
                    pass
                break
            now = time.monotonic()
            if now - last_line > inactivity_timeout or (
                    deadline is not None and now > deadline):
                aborted = True
                proc.kill()
                proc.wait()
                # A line racing the kill is a real measurement.
                try:
                    while True:
                        chunk = os.read(fd, 65536)
                        if not chunk:
                            break
                        buf += chunk
                except (BlockingIOError, OSError):
                    pass
                break
            ready, _, _ = select.select([fd], [], [],
                                        min(1.0, inactivity_timeout))
            if not ready:
                continue
            try:
                chunk = os.read(fd, 65536)
            except BlockingIOError:
                continue
            if not chunk:  # EOF: the child is exiting
                proc.wait()
                break
            buf += chunk
            *lines, buf = buf.split(b"\n")
            harvest(lines)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
    harvest(buf.splitlines())
    return got, aborted


def _load_around(path: str) -> dict:
    around = json.load(open(path))
    if not isinstance(around, dict) or not (
            {"inner_bits", "sublanes"} & set(around)):
        raise ValueError(f"--around {path} does not hold a tuned "
                         "configuration (expected an --adopt file)")
    return around


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.worker_config:
        parsed = json.loads(args.worker_config)
        if isinstance(parsed, list):
            return run_worker_batch(parsed)
        return run_worker(parsed)

    t_start = time.monotonic()
    deadline = t_start + args.budget if args.budget else None
    around = None
    if args.around:
        try:
            around = _load_around(args.around)
        except (OSError, json.JSONDecodeError, ValueError) as e:
            print(json.dumps({"best": None,
                              "error": f"--around: {e}"[:200]}))
            return 1

    measured_keys: set = set()
    if args.skip_measured and args.out:
        try:
            measured_keys = {_key(r) for r in
                             json.load(open(args.out)).get("results", [])
                             if r.get("ok")}
        except (OSError, json.JSONDecodeError):
            measured_keys = set()

    results = []
    pruned = 0
    consec_aborts = 0
    backends = ([around.get("backend", "cuda")] if around
                else [b.strip() for b in args.backends.split(",")])
    for backend in backends:
        if backend not in BACKENDS:
            print(json.dumps({"best": None, "error": f"unknown backend "
                              f"{backend!r}; have {list(BACKENDS)}"}))
            return 2
        configs = neighborhood(around) if around else grid(backend,
                                                           args.quick)
        if args.limit is not None:
            configs = configs[:args.limit]
        if measured_keys:
            kept = [c for c in configs if _key(c) not in measured_keys]
            pruned += len(configs) - len(kept)
            configs = kept
        for config in configs:
            config["sweep_bits"] = 16 if args.quick else args.sweep_bits
            config["device"] = args.device
        pending = list(configs)
        while pending:
            if deadline is not None and time.monotonic() > deadline:
                results += [dict(c, mhs=0.0, ok=False,
                                 error="sweep budget exhausted")
                            for c in pending]
                break
            if consec_aborts >= 2:
                # Two consecutive inactivity kills: stop; partial results
                # stand.
                results += [dict(c, mhs=0.0, ok=False,
                                 error="sweep aborted: two workers in a "
                                       "row hung")
                            for c in pending]
                break
            got, aborted = stream_batch(worker_command(pending),
                                        args.attempt_timeout, deadline)
            done, still = [], []
            for config in pending:
                res = got.get(_key(config))
                if res is not None:
                    results.append(res)
                    print(json.dumps(res), flush=True)
                    if res.get("ok") and args.evidence:
                        _append_evidence(args.evidence, res)
                    done.append(config)
                else:
                    still.append(config)
            if not aborted:
                # The child exited on its own; a configuration without a
                # line crashed it.
                if still:
                    bad, still = still[0], still[1:]
                    results.append(dict(bad, mhs=0.0, ok=False,
                                        error="worker died on this config"))
                consec_aborts = 0
            else:
                # The configuration after the last reported one hung.
                consec_aborts = 0 if done else consec_aborts + 1
                if still:
                    hung, still = still[0], still[1:]
                    results.append(dict(hung, mhs=0.0, ok=False,
                                        error=f"inactivity timeout "
                                              f"{args.attempt_timeout:.0f}s"))
            pending = still

    # rc is this run's verdict; a grid that --skip-measured pruned whole
    # is done, not failed.
    ran_ok = any(r.get("ok") for r in results) or (
        pruned > 0 and not results)
    if args.out:
        results = merge_prior_ok(results, args.out)

    ranked = sorted(results, key=lambda r: -r["mhs"])
    print("\n| backend | config | MH/s | compile | ok |")
    print("|---|---|---|---|---|")
    for r in ranked:
        knobs = {k: v for k, v in r.items() if k in CONFIG_KEYS[1:]}
        print(f"| {r['backend']} | {knobs} | {r['mhs']} | "
              f"{r.get('compile_s', '-')}s | "
              f"{'Y' if r['ok'] else (r.get('error') or '')[:60]} |")
    best = ranked[0] if ranked else None
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"results": results, "best": best}, indent=1))
    if args.adopt and best and best.get("ok") and best["mhs"] > 0:
        tuned = {k: best[k] for k in CONFIG_KEYS if best.get(k) is not None}
        tuned["mhs"] = best["mhs"]
        tuned["measured"] = datetime.now(timezone.utc).strftime(
            "%Y-%m-%dT%H:%MZ")
        Path(args.adopt).parent.mkdir(parents=True, exist_ok=True)
        Path(args.adopt).write_text(json.dumps(tuned, indent=1))
    print(json.dumps({"best": best}))
    return 0 if ran_ok else 1


if __name__ == "__main__":
    sys.exit(main())
