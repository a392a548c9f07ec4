"""Work units: protocol job params → 80-byte header templates.

A ``mining.notify`` or a getblocktemplate response becomes a ``Job``, a
getwork header a ``FixedMerkleJob``; for each extranonce2 value the job
yields the 76 fixed header bytes (version‖prevhash‖merkle_root‖ntime‖
nbits) whose midstate the backend caches, leaving the 4-byte nonce to
sweep.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass
from functools import cached_property
from typing import List, Optional

from ..core.header import build_coinbase, merkle_root_from_branch
from ..core.sha256 import sha256d
from ..core.target import difficulty_to_target, nbits_to_target


def swap32_words(data: bytes) -> bytes:
    """Byte-swap every 4-byte word (an involution): Stratum v1 sends
    ``prevhash`` with each word byte-swapped relative to the header's
    internal byte order."""
    if len(data) % 4:
        raise ValueError("length must be a multiple of 4")
    return b"".join(data[i : i + 4][::-1] for i in range(0, len(data), 4))


@dataclass(frozen=True)
class StratumJobParams:
    """Raw ``mining.notify`` params, hex-encoded as received."""

    job_id: str
    prevhash: str  # 64 hex chars, stratum word-swapped order
    coinb1: str
    coinb2: str
    merkle_branch: List[str]  # internal-order hex, used as-is
    version: str  # 8 hex chars, big-endian
    nbits: str  # 8 hex chars, big-endian
    ntime: str  # 8 hex chars, big-endian
    clean_jobs: bool

    @classmethod
    def from_notify(cls, params: list) -> "StratumJobParams":
        if len(params) < 9:
            raise ValueError(f"mining.notify expects 9 params, got {len(params)}")
        return cls(
            job_id=str(params[0]),
            prevhash=str(params[1]),
            coinb1=str(params[2]),
            coinb2=str(params[3]),
            merkle_branch=[str(h) for h in params[4]],
            version=str(params[5]),
            nbits=str(params[6]),
            ntime=str(params[7]),
            clean_jobs=bool(params[8]),
        )


@dataclass(frozen=True)
class Job:
    """A resolved work unit. ``share_target`` comes from the pool
    difficulty and ``block_target`` from nbits: a share may also be a
    block, so hits are checked against both."""

    job_id: str
    prevhash_internal: bytes
    coinb1: bytes
    coinb2: bytes
    extranonce1: bytes
    extranonce2_size: int
    merkle_branch: List[bytes]
    version: int
    nbits: int
    ntime: int
    share_target: int
    clean: bool = False
    #: generation assigned by the dispatcher; results of older
    #: generations are stale and dropped.
    generation: int = 0
    #: BIP 310 version-rolling mask from ``mining.configure`` (0 = none):
    #: bits inside it are an extra host-side search axis, and the rolled
    #: bits ride the share into ``mining.submit``'s 6th parameter.
    version_mask: int = 0
    #: how many of the mask's lowest set bit positions the hasher's sibling
    #: chains (vshare) roll in the kernel: the host axis uses only the
    #: positions above them, so the two axes never mine — and submit — the
    #: same header. Set by the dispatcher from the hasher.
    reserved_version_bits: int = 0

    @property
    def block_target(self) -> int:
        return nbits_to_target(self.nbits)

    @cached_property
    def _mask_bit_positions(self) -> List[int]:
        return [i for i in range(32) if (self.version_mask >> i) & 1]

    @cached_property
    def _roll_bit_positions(self) -> List[int]:
        """Mask bit positions the host axis rolls (the kernel's excluded)."""
        return self._mask_bit_positions[self.reserved_version_bits:]

    @property
    def version_variants(self) -> int:
        """How many rolled versions the host axis sweeps (1 = none)."""
        return 1 << len(self._roll_bit_positions)

    def rolled_version(self, variant: int) -> int:
        """The header version for roll ``variant`` ∈ [0, version_variants):
        the variant's bits spread onto the host-rollable mask positions.
        Variant 0 keeps the job's own version."""
        if variant == 0:
            return self.version
        mask = 0
        bits = 0
        for k, pos in enumerate(self._roll_bit_positions):
            mask |= 1 << pos
            if (variant >> k) & 1:
                bits |= 1 << pos
        return (self.version & ~mask) | (bits ^ (self.version & mask))

    @cached_property
    def sweep_key(self) -> str:
        """Identity for sweep-resume bookkeeping. The bare ``job_id`` is not
        enough: Stratum job ids are per-connection and often tiny counters,
        so the key digests the whole work identity, including the
        per-session extranonce1. The mask, and the kernel's reserved bit
        count (which reshapes the host roll axis and with it every resume
        index), fold in only when nonzero — the reference's key format."""
        ident = hashlib.sha256(
            b"|".join(
                [
                    self.job_id.encode(),
                    self.extranonce1,
                    self.prevhash_internal,
                    self.coinb1,
                    self.coinb2,
                    *self.merkle_branch,
                    struct.pack("<III", self.version, self.nbits,
                                self.extranonce2_size)
                    + (struct.pack("<I", self.version_mask)
                       if self.version_mask else b"")
                    + (struct.pack("<I", self.reserved_version_bits)
                       if self.reserved_version_bits else b""),
                ]
            )
        ).hexdigest()[:16]
        return f"{self.job_id}:{ident}"

    @classmethod
    def from_stratum(
        cls,
        params: StratumJobParams,
        extranonce1: bytes,
        extranonce2_size: int,
        difficulty: float,
        generation: int = 0,
        version_mask: int = 0,
    ) -> "Job":
        return cls(
            version_mask=version_mask,
            job_id=params.job_id,
            prevhash_internal=swap32_words(bytes.fromhex(params.prevhash)),
            coinb1=bytes.fromhex(params.coinb1),
            coinb2=bytes.fromhex(params.coinb2),
            extranonce1=extranonce1,
            extranonce2_size=extranonce2_size,
            merkle_branch=[bytes.fromhex(h) for h in params.merkle_branch],
            version=int(params.version, 16),
            nbits=int(params.nbits, 16),
            ntime=int(params.ntime, 16),
            share_target=difficulty_to_target(difficulty),
            clean=params.clean_jobs,
            generation=generation,
        )

    def merkle_root_internal(self, extranonce2: bytes) -> bytes:
        """Coinbase txid + branch fold → merkle root, internal byte order."""
        if len(extranonce2) != self.extranonce2_size:
            raise ValueError(
                f"extranonce2 must be {self.extranonce2_size} bytes, "
                f"got {len(extranonce2)}"
            )
        coinbase = build_coinbase(
            self.coinb1, self.extranonce1, extranonce2, self.coinb2
        )
        return merkle_root_from_branch(sha256d(coinbase), self.merkle_branch)

    def header76(
        self,
        extranonce2: bytes,
        ntime: Optional[int] = None,
        version: Optional[int] = None,
    ) -> bytes:
        """The fixed 76 header bytes for this extranonce2 (nonce omitted);
        ``ntime``/``version`` override the job's own for the rolled axes."""
        hdr = struct.pack("<I", version if version is not None else self.version)
        hdr += self.prevhash_internal
        hdr += self.merkle_root_internal(extranonce2)
        hdr += struct.pack("<II", ntime if ntime is not None else self.ntime,
                           self.nbits)
        return hdr


def job_from_template_fields(
    job_id: str,
    prevhash_display_hex: str,
    merkle_root_internal: bytes,
    version: int,
    nbits: int,
    ntime: int,
    share_target: Optional[int] = None,
    generation: int = 0,
) -> "FixedMerkleJob":
    """A job for sources that give a final merkle root (getwork): no
    extranonce2 axis. The share target defaults to the block target."""
    return FixedMerkleJob(
        job_id=job_id,
        prevhash_internal=bytes.fromhex(prevhash_display_hex)[::-1],
        coinb1=b"",
        coinb2=b"",
        extranonce1=b"",
        extranonce2_size=0,
        merkle_branch=[],
        version=version,
        nbits=nbits,
        ntime=ntime,
        share_target=(share_target if share_target is not None
                      else nbits_to_target(nbits)),
        generation=generation,
        _merkle=merkle_root_internal,
    )


@dataclass(frozen=True)
class FixedMerkleJob(Job):
    """A job whose merkle root is already final: extranonce2 has size 0 and
    the single empty value."""

    _merkle: bytes = b""

    def merkle_root_internal(self, extranonce2: bytes) -> bytes:
        if extranonce2 != b"":
            raise ValueError("fixed-merkle jobs have no extranonce2 axis")
        return self._merkle
