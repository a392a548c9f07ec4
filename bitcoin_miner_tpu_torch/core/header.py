"""Block-header assembly: merkle roots from Stratum branches, genesis vectors.

All header integer fields are little-endian; prevhash and merkle root are
in internal byte order (the reverse of the display hex).
"""

from __future__ import annotations

from .sha256 import sha256d

# Bitcoin's genesis block — the known answer the offline bench must find.
GENESIS_NBITS = 0x1D00FFFF
GENESIS_NONCE = 2083236893
GENESIS_HASH_HEX = (
    "000000000019d6689c085ae165831e934ff763ae46a2a6c172b3f1b60a8ce26f"
)
GENESIS_HEADER_HEX = (
    "01000000" + "00" * 32
    + "3ba3edfd7a7b12b27ac72c3e67768f617fc81bc3888a51323a9fb8aa4b1e5e4a"
    + "29ab5f49" + "ffff001d" + "1dac2b7c"
)


def merkle_root_from_branch(coinbase_txid: bytes, branch: list[bytes]) -> bytes:
    """Merkle root (internal byte order) from a Stratum merkle branch: fold
    ``root = sha256d(root ‖ branch_i)``. Branch hashes are internal-order
    bytes, used as sent."""
    root = coinbase_txid
    for h in branch:
        root = sha256d(root + h)
    return root


def build_coinbase(
    coinb1: bytes, extranonce1: bytes, extranonce2: bytes, coinb2: bytes
) -> bytes:
    """Assemble the coinbase transaction from Stratum job parts."""
    return coinb1 + extranonce1 + extranonce2 + coinb2
