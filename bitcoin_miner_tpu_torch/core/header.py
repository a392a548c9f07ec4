"""Block-header assembly: 80-byte unpacking, merkle roots, genesis vectors.

All header integer fields are little-endian; prevhash and merkle root are
in internal byte order (the reverse of the display hex).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from .sha256 import sha256d

HEADER_LEN = 80

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


@dataclass(frozen=True)
class BlockHeader:
    """A decoded 80-byte header; ``prevhash`` and ``merkle_root`` are
    display-order hex (big-endian, as explorers show them)."""

    version: int
    prevhash: str
    merkle_root: str
    ntime: int
    nbits: int
    nonce: int


def unpack_header(raw: bytes) -> BlockHeader:
    if len(raw) != HEADER_LEN:
        raise ValueError(f"header must be {HEADER_LEN} bytes, got {len(raw)}")
    version = struct.unpack_from("<I", raw, 0)[0]
    ntime, nbits, nonce = struct.unpack_from("<III", raw, 68)
    return BlockHeader(version, raw[4:36][::-1].hex(),
                       raw[36:68][::-1].hex(), ntime, nbits, nonce)


def merkle_root_from_branch(coinbase_txid: bytes, branch: list[bytes]) -> bytes:
    """Merkle root (internal byte order) from a Stratum merkle branch: fold
    ``root = sha256d(root ‖ branch_i)``. Branch hashes are internal-order
    bytes, used as sent."""
    root = coinbase_txid
    for h in branch:
        root = sha256d(root + h)
    return root


def merkle_root_from_txids(txids_internal: list[bytes]) -> bytes:
    """The merkle root over a whole block's txids (internal order): odd
    levels duplicate their last element."""
    if not txids_internal:
        raise ValueError("need at least the coinbase txid")
    level = list(txids_internal)
    while len(level) > 1:
        if len(level) % 2:
            level.append(level[-1])
        level = [sha256d(level[i] + level[i + 1])
                 for i in range(0, len(level), 2)]
    return level[0]


def merkle_branch_for_coinbase(txids_internal: list[bytes]) -> list[bytes]:
    """The branch that recomputes the root when only the coinbase (leaf 0)
    changes, as a Stratum notify carries it; ``txids_internal`` excludes
    the coinbase."""
    branch: list[bytes] = []
    level = list(txids_internal)
    while level:
        branch.append(level[0])
        if len(level) % 2 == 0:
            level.append(level[-1])  # so that the pairing below is exact
        rest = level[1:]
        if len(rest) % 2:
            rest.append(rest[-1])
        level = [sha256d(rest[i] + rest[i + 1])
                 for i in range(0, len(rest), 2)]
    return branch


def build_coinbase(
    coinb1: bytes, extranonce1: bytes, extranonce2: bytes, coinb2: bytes
) -> bytes:
    """Assemble the coinbase transaction from Stratum job parts."""
    return coinb1 + extranonce1 + extranonce2 + coinb2
