"""Transaction and block serialization for getblocktemplate mining.

Only what a solo miner needs: varints, the BIP34 height push, a coinbase
transaction with an extranonce slot in its scriptSig, and full-block
serialization. The coinbase is built as (coinb1, coinb2) halves around the
extranonce, so a template becomes the same ``Job`` a Stratum notify does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from .sha256 import sha256d

#: An anyone-can-spend output script (OP_TRUE), for regtest runs; real
#: deployments pass their own scriptPubKey.
OP_TRUE_SCRIPT = b"\x51"

#: BIP141: the coinbase's witness is one 32-byte reserved value of zeros,
#: serialized as n_stack_items=1, item_len=32, zeros.
WITNESS_RESERVED = b"\x01\x20" + b"\x00" * 32


def varint(n: int) -> bytes:
    """Bitcoin CompactSize."""
    if n < 0:
        raise ValueError("varint must be non-negative")
    if n < 0xFD:
        return n.to_bytes(1, "little")
    if n <= 0xFFFF:
        return b"\xfd" + n.to_bytes(2, "little")
    if n <= 0xFFFFFFFF:
        return b"\xfe" + n.to_bytes(4, "little")
    return b"\xff" + n.to_bytes(8, "little")


def decode_varint(data: bytes, offset: int = 0) -> Tuple[int, int]:
    """(value, bytes consumed) of the CompactSize at ``offset``."""
    first = data[offset]
    if first < 0xFD:
        return first, 1
    if first == 0xFD:
        return int.from_bytes(data[offset + 1:offset + 3], "little"), 3
    if first == 0xFE:
        return int.from_bytes(data[offset + 1:offset + 5], "little"), 5
    return int.from_bytes(data[offset + 1:offset + 9], "little"), 9


def script_push(data: bytes) -> bytes:
    """A direct push (lengths below the OP_PUSHDATA1 threshold)."""
    if not 0 < len(data) < 0x4C:
        raise ValueError("push length out of direct-push range")
    return len(data).to_bytes(1, "little") + data


def bip34_height_push(height: int) -> bytes:
    """BIP34: the coinbase scriptSig starts with the block height as a
    minimal little-endian CScriptNum (an extra 0x00 when the top bit is
    set)."""
    if height < 0:
        raise ValueError("height must be non-negative")
    if height == 0:
        return b"\x00"  # OP_0
    raw = height.to_bytes((height.bit_length() + 7) // 8, "little")
    if raw[-1] & 0x80:
        raw += b"\x00"
    return script_push(raw)


@dataclass(frozen=True)
class CoinbaseSplit:
    """A coinbase transaction in two halves around the extranonce slot:
    tx = coinb1 ‖ extranonce ‖ coinb2. The halves are the legacy
    serialization, over which the txid (and so the merkle root) is always
    computed; with ``has_witness`` (the template carried a witness
    commitment) the block holds the BIP141 form of
    :meth:`serialize_for_block`."""

    coinb1: bytes
    coinb2: bytes
    extranonce_size: int
    has_witness: bool = False

    def serialize(self, extranonce: bytes) -> bytes:
        """The legacy (txid) serialization."""
        if len(extranonce) != self.extranonce_size:
            raise ValueError(
                f"extranonce must be {self.extranonce_size} bytes")
        return self.coinb1 + extranonce + self.coinb2

    def serialize_for_block(self, extranonce: bytes) -> bytes:
        """What the block holds: with a witness commitment, the marker and
        flag after the version and the reserved witness before the
        locktime; else the legacy form."""
        legacy = self.serialize(extranonce)
        if not self.has_witness:
            return legacy
        return (legacy[:4] + b"\x00\x01" + legacy[4:-4] + WITNESS_RESERVED
                + legacy[-4:])

    def txid(self, extranonce: bytes) -> bytes:
        """Internal-order txid, over the legacy serialization."""
        return sha256d(self.serialize(extranonce))


def build_coinbase_split(
    height: int,
    value_sats: int,
    extranonce_size: int = 4,
    script_pubkey: bytes = OP_TRUE_SCRIPT,
    tag: bytes = b"tpu-miner",
    witness_commitment: Optional[bytes] = None,
) -> CoinbaseSplit:
    """The coinbase of a template: BIP34 height, tag and extranonce in the
    scriptSig, one output of ``value_sats`` to ``script_pubkey`` and, when
    the template has one, the 0-value witness-commitment output (without
    it a block holding a segwit transaction is invalid)."""
    sig_prefix = bip34_height_push(height) + script_push(tag)
    script_len = len(sig_prefix) + 1 + extranonce_size  # +1: push opcode
    if script_len > 100:
        raise ValueError("coinbase scriptSig exceeds 100-byte consensus limit")
    coinb1 = (
        (1).to_bytes(4, "little")  # version
        + varint(1)  # input count
        + b"\x00" * 32  # null prevout hash
        + b"\xff\xff\xff\xff"  # prevout index
        + varint(script_len)
        + sig_prefix
        + extranonce_size.to_bytes(1, "little")  # push opcode for extranonce
    )
    outputs = (value_sats.to_bytes(8, "little") + varint(len(script_pubkey))
               + script_pubkey)
    n_outputs = 1
    if witness_commitment is not None:
        outputs += ((0).to_bytes(8, "little")
                    + varint(len(witness_commitment)) + witness_commitment)
        n_outputs += 1
    coinb2 = (
        b"\xff\xff\xff\xff"  # sequence
        + varint(n_outputs)
        + outputs
        + b"\x00" * 4  # locktime
    )
    return CoinbaseSplit(coinb1, coinb2, extranonce_size,
                         has_witness=witness_commitment is not None)


def serialize_block(header80: bytes, tx_blobs: List[bytes]) -> bytes:
    """header ‖ varint(n_tx) ‖ raw txs, coinbase first."""
    if len(header80) != 80:
        raise ValueError("header must be 80 bytes")
    return header80 + varint(len(tx_blobs)) + b"".join(tx_blobs)
