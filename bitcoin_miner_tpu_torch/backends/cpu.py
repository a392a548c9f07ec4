"""The hashlib specification oracle: every device hit is re-verified here
before it becomes a share, and every backend is tested against it."""

from __future__ import annotations

from ..core.sha256 import sha256d, sha256_midstate, sha256d_from_midstate
from ..core.target import hash_meets_target
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


register_hasher("cpu", CpuHasher)
