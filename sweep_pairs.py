#!/usr/bin/env python3
"""Genesis sweeps of one checkout, repeated in one process, for comparing
two commits on one card.

``python3 sweep_pairs.py ROOT [VARIANT ...]`` imports the package of the
checkout at ``ROOT``, builds its one-chain kernels (and the one-chain
library of each ``VARIANT``, a layout of the tile kernel), then sweeps the
genesis header's whole 2^32 nonce space through ``cli.bench`` three
times (the first includes the process's warm-up), and after each
baseline sweep one sweep per ``--variant`` named. It prints one JSON line
of MH/s per layout.

``python3 sweep_pairs.py ROOT --easy`` instead times ``TileCudaHasher.
scan`` over 2^26 nonces at targets where most 8192-nonce steps hold
several hits (difficulty 2^-20, about 2^-12 per nonce, and regtest's
nbits 0x207fffff), three scans each after a warm-up one, as
``chip_smoke.py``'s ``easy_target_scan`` phase does: one JSON line of MH/s
and hits per target.

To compare a commit with its parent, unpack the parent beside the
checkout and run parent, change, change, parent in one call.
"""

import json
import os
import sys
import time


def easy_scans(root: str) -> dict:
    """MH/s of three 2^26-nonce tile-hasher scans per target, after a
    warm-up scan."""
    from bitcoin_miner_tpu_torch.backends.cuda import TileCudaHasher
    from bitcoin_miner_tpu_torch.core.target import (
        difficulty_to_target,
        nbits_to_target,
    )

    header = bytes(range(76))
    n = 1 << 26
    hasher = TileCudaHasher(device="cuda")
    out = {"root": root, "nonces": n}
    for label, target in (("easy", difficulty_to_target(1 / (1 << 20))),
                          ("regtest", nbits_to_target(0x207FFFFF))):
        hasher.scan(header, 0, n, target)
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            result = hasher.scan(header, 1000, n, target)
            rates.append(round(n / (time.perf_counter() - t0) / 1e6, 1))
        out[label] = rates
        out[f"{label}_total_hits"] = result.total_hits
    return out


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    os.chdir(root)
    from bitcoin_miner_tpu_torch import cli
    from bitcoin_miner_tpu_torch.ops import csrc

    if sys.argv[2:] == ["--easy"]:
        csrc.build(["scan_tile", "scan_hitbuf"])
        print(json.dumps(easy_scans(sys.argv[1])), flush=True)
        return 0

    libraries = ["scan_tile", "scan_hitbuf"]
    if sys.argv[2:]:
        from bitcoin_miner_tpu_torch.ops.sha256_tile import tile_library
        libraries += [tile_library(1, v) for v in sys.argv[2:]]
    csrc.build(libraries)
    out = {"root": sys.argv[1], "baseline": []}
    for _ in range(3):
        for variant in (None, *sys.argv[2:]):
            argv = ["--bench", "--bench-nonces", str(1 << 32)]
            if variant:
                argv += ["--variant", variant]
            result = cli.bench(cli.build_parser().parse_args(argv))
            if not result["verified"]:
                raise SystemExit(f"genesis nonce not found: {result}")
            out.setdefault(variant or "baseline", []).append(
                round(result["mhs"], 1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
