"""The CPU hashers: the hashlib specification oracle, which re-verifies
every device hit before it becomes a share and which every backend is
tested against, and its compiled C++ twin (``native``)."""

from __future__ import annotations

import logging

from ..core.sha256 import sha256d, sha256_midstate, sha256d_from_midstate
from ..core.target import hash_meets_target
from . import native as _native
from .base import Hasher, ScanResult, register_hasher


class CpuHasher(Hasher):
    """Pure-Python/hashlib backend. Slow; exists for correctness."""

    name = "cpu"

    #: The pure-Python sweep holds the GIL for its whole duration, so the
    #: dispatcher drives it with the blocking loop, not a pump thread.
    scan_releases_gil = False

    def sha256d(self, data: bytes) -> bytes:
        return sha256d(data)

    def scan(
        self,
        header76: bytes,
        nonce_start: int,
        count: int,
        target: int,
        max_hits: int = 64,
    ) -> ScanResult:
        self._check_range(header76, nonce_start, count)
        mid = sha256_midstate(header76[:64])
        tail12 = header76[64:76]
        hits: list[int] = []
        total = 0
        for nonce in range(nonce_start, nonce_start + count):
            digest = sha256d_from_midstate(mid, tail12, nonce)
            if hash_meets_target(digest, target):
                total += 1
                if len(hits) < max_hits:
                    hits.append(nonce)
        return ScanResult(nonces=hits, total_hits=total, hashes_done=count)


class NativeCpuHasher(Hasher):
    """The C++ hasher (``native/sha256d.cpp``) through ctypes: the CPU
    benchmark path. It runs on the host whatever ``--device`` says."""

    name = "native"

    def __init__(self) -> None:
        _native.load()  # raises OSError when the library cannot be built
        # The SHA-NI and scalar paths differ ~3x in rate: say which runs.
        logging.getLogger(__name__).info(
            "native sha256d backend: %s", _native.backend_name())

    def sha256d(self, data: bytes) -> bytes:
        return _native.sha256d(data)

    def scan(
        self,
        header76: bytes,
        nonce_start: int,
        count: int,
        target: int,
        max_hits: int = 64,
    ) -> ScanResult:
        self._check_range(header76, nonce_start, count)
        hits, total = _native.scan(header76, nonce_start, count, target,
                                   max_hits)
        return ScanResult(nonces=hits, total_hits=total, hashes_done=count)


register_hasher("cpu", CpuHasher)
register_hasher("native", NativeCpuHasher)
