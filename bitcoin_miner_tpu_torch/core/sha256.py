"""Pure-Python SHA-256 with an exposed compression function and midstate.

``hashlib`` does not expose the internal state, and the miner's hot loop
rests on midstate caching: the SHA-256 state after the first 64 header
bytes is computed once per job, so each nonce costs one compression of
chunk 2 plus one hash of the 32-byte digest. This module is the slow,
obvious specification that the plain PyTorch round math and the CUDA
kernels are checked against. All states are tuples of 8 big-endian words.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Sequence, Tuple

MASK32 = 0xFFFFFFFF

# FIPS 180-4 H(0): fractional parts of the square roots of the first 8 primes.
SHA256_IV: Tuple[int, ...] = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

# Round constants: fractional parts of the cube roots of the first 64 primes.
SHA256_K: Tuple[int, ...] = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & MASK32


def _round(state: Sequence[int], i: int, wi: int) -> Tuple[int, ...]:
    a, b, c, d, e, f, g, h = state
    s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
    ch = (e & f) ^ (~e & g)
    t1 = (h + s1 + ch + SHA256_K[i] + wi) & MASK32
    s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
    maj = (a & b) ^ (a & c) ^ (b & c)
    t2 = (s0 + maj) & MASK32
    return ((t1 + t2) & MASK32, a, b, c, (d + t1) & MASK32, e, f, g)


def sha256_compress(state: Sequence[int], block: bytes) -> Tuple[int, ...]:
    """One SHA-256 compression of a 64-byte block into an 8-word state."""
    if len(block) != 64:
        raise ValueError(f"block must be 64 bytes, got {len(block)}")
    w = list(struct.unpack(">16I", block))
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & MASK32)
    regs = tuple(state)
    for i in range(64):
        regs = _round(regs, i, w[i])
    return tuple((s + v) & MASK32 for s, v in zip(state, regs))


def sha256_midstate(first_chunk: bytes) -> Tuple[int, ...]:
    """SHA-256 state after absorbing header[0:64] — the per-job precompute."""
    if len(first_chunk) != 64:
        raise ValueError("midstate needs exactly the first 64 bytes")
    return sha256_compress(SHA256_IV, first_chunk)


def sha256_rounds(
    state: Sequence[int], words: Sequence[int], n_rounds: int
) -> Tuple[int, ...]:
    """Registers (a..h) after the first ``n_rounds`` rounds of a compression
    from ``state`` over ``words[0:n_rounds]`` (``n_rounds`` ≤ 16, so no
    schedule expansion). The scan kernels resume chunk 2 at round 3 from
    this state: rounds 0-2 consume only header[64:76], a job constant."""
    if not (0 <= n_rounds <= 16):
        raise ValueError("n_rounds must be in [0, 16] (pre-expansion rounds)")
    regs = tuple(state)
    for i in range(n_rounds):
        regs = _round(regs, i, words[i])
    return regs


def _sha256_pad(msg_len: int) -> bytes:
    """Padding for a message of ``msg_len`` bytes (appended after the data)."""
    pad = b"\x80" + b"\x00" * ((55 - msg_len) % 64)
    return pad + struct.pack(">Q", msg_len * 8)


def sha256d(data: bytes) -> bytes:
    """Double SHA-256 — Bitcoin's hash function — through hashlib."""
    return hashlib.sha256(hashlib.sha256(data).digest()).digest()


def sha256d_from_midstate(
    midstate: Sequence[int], tail12: bytes, nonce: int
) -> bytes:
    """sha256d of an 80-byte header from its chunk-1 midstate. ``tail12`` is
    header[64:76]; ``nonce`` goes little-endian into header[76:80]."""
    if len(tail12) != 12:
        raise ValueError("tail12 must be header[64:76], 12 bytes")
    chunk2 = tail12 + struct.pack("<I", nonce) + _sha256_pad(80)
    digest1 = struct.pack(">8I", *sha256_compress(midstate, chunk2))
    block = digest1 + _sha256_pad(32)
    return struct.pack(">8I", *sha256_compress(SHA256_IV, block))
