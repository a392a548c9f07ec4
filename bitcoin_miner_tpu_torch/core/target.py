"""Target and difficulty math.

Proof of work: read sha256d(header) as a 256-bit little-endian integer and
require it ≤ target, where the target comes from the compact ``nbits``
field or from a pool difficulty (share target = DIFF1 / difficulty).
"""

from __future__ import annotations

# Difficulty-1 target (nbits 0x1d00ffff) — the Stratum share-difficulty unit.
DIFF1_TARGET = 0x00000000FFFF0000000000000000000000000000000000000000000000000000


def nbits_to_target(nbits: int) -> int:
    """Decode the compact form: mantissa · 256^(exponent-3). Negative and
    overflowing encodings raise."""
    exponent = nbits >> 24
    mantissa = nbits & 0x007FFFFF
    if nbits & 0x00800000:
        raise ValueError(f"negative compact target: {nbits:#010x}")
    if exponent <= 3:
        target = mantissa >> (8 * (3 - exponent))
    else:
        target = mantissa << (8 * (exponent - 3))
    if target >> 256:
        raise ValueError(f"compact target overflows 256 bits: {nbits:#010x}")
    return target


def difficulty_to_target(difficulty: float) -> int:
    """Share target for a ``mining.set_difficulty`` value (fractional
    difficulties below 1 are honored)."""
    if difficulty <= 0:
        raise ValueError("difficulty must be positive")
    return int(DIFF1_TARGET / difficulty)


def target_to_difficulty(target: int) -> float:
    """The difficulty a share target stands for (the inverse of
    :func:`difficulty_to_target`)."""
    if target <= 0:
        raise ValueError("target must be positive")
    return DIFF1_TARGET / target


def hash_to_int(digest: bytes) -> int:
    """sha256d digest → the 256-bit integer consensus compares (LE)."""
    return int.from_bytes(digest, "little")


def hash_meets_target(digest: bytes, target: int) -> bool:
    return hash_to_int(digest) <= target


def target_to_limbs(target: int) -> tuple[int, ...]:
    """The target as 8 big-endian uint32 limbs, most significant first: the
    kernels compare the byte-reversed digest against them limb by limb
    instead of doing 256-bit arithmetic."""
    return tuple((target >> (32 * i)) & 0xFFFFFFFF for i in range(7, -1, -1))
