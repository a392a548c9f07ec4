#!/usr/bin/env python3
"""Genesis sweeps of one checkout, repeated in one process, for comparing
two commits on one card.

``python3 sweep_pairs.py ROOT [VARIANT ...]`` imports the package of the
checkout at ``ROOT``, builds its one-chain kernels (and the one-chain
library of each ``VARIANT``, a layout of the tile kernel), then sweeps the
genesis header's whole 2^32 nonce space through ``cli.bench`` three
times (the first includes the process's warm-up), and after each
baseline sweep one sweep per ``--variant`` named. It prints one JSON line
of MH/s per layout. To compare a commit with its parent, unpack the parent
beside the checkout and run parent, change, change, parent in one call.
"""

import json
import os
import sys


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    os.chdir(root)
    from bitcoin_miner_tpu_torch import cli
    from bitcoin_miner_tpu_torch.ops import csrc

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
