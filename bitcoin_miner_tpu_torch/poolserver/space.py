"""Extranonce space partition of the pool frontend.

Counterpart of ``bitcoin_miner_tpu/poolserver/space.py``. The server
gives every downstream session, and its internal worker, a slice of the
extranonce space by appending a unique fixed-width prefix to the base
extranonce1 it owns: session ``extranonce1 = base ‖ prefix`` and session
``extranonce2_size = total − prefix_bytes``. Two prefixes build two
coinbases, two merkle roots, two disjoint header spaces: no nonce is
mined twice across clients, with no coordination per share.

:class:`PrefixAllocator` hands out prefixes lowest first and takes a
disconnected session's back, so N churning clients never hold more than
N prefixes. It is used from the event loop alone and takes no lock.
:meth:`PrefixAllocator.partition` carves the range into N disjoint
static sub-ranges, a pure function of ``(range, n, i)``, for acceptor
processes that share one listen port.
"""

# miner-lint: import-safe

from __future__ import annotations

import heapq
from typing import List, Optional, Set, Tuple


class SpaceExhausted(RuntimeError):
    """Every prefix is in use: the server is at capacity."""


class PrefixAllocator:
    """Unique prefixes in ``[start, stop)`` ⊆ ``[0, 256^prefix_bytes)``.

    :meth:`allocate` returns the lowest free value; :meth:`release`
    returns one, and releasing a prefix that is not in use raises (a
    double release is the aliasing fault this class exists to rule
    out)."""

    def __init__(
        self,
        prefix_bytes: int,
        *,
        start: int = 0,
        stop: Optional[int] = None,
    ) -> None:
        if prefix_bytes < 1:
            raise ValueError("prefix_bytes must be >= 1")
        self.prefix_bytes = prefix_bytes
        #: the whole space the width encodes, whatever range this
        #: instance allocates from.
        self.space = 256 ** prefix_bytes
        stop = self.space if stop is None else stop
        if not 0 <= start < stop <= self.space:
            raise ValueError(
                f"need 0 <= start < stop <= {self.space} "
                f"(got [{start}, {stop}))"
            )
        self.start = start
        self.stop = stop
        self._next = start
        self._freed: List[int] = []  # min-heap of released prefixes
        self._in_use: Set[int] = set()

    @property
    def in_use(self) -> int:
        return len(self._in_use)

    @property
    def capacity(self) -> int:
        return self.stop - self.start

    @property
    def prefix_range(self) -> Tuple[int, int]:
        """The half-open ``[start, stop)`` range this instance owns."""
        return self.start, self.stop

    def allocate(self) -> int:
        if self._freed:
            prefix = heapq.heappop(self._freed)
        elif self._next < self.stop:
            prefix = self._next
            self._next += 1
        else:
            raise SpaceExhausted(
                f"all {self.capacity} extranonce prefixes in "
                f"[{self.start}, {self.stop}) in use"
            )
        self._in_use.add(prefix)
        return prefix

    def release(self, prefix: int) -> None:
        if prefix not in self._in_use:
            raise ValueError(f"prefix {prefix} is not allocated")
        self._in_use.remove(prefix)
        heapq.heappush(self._freed, prefix)

    def encode(self, prefix: int) -> bytes:
        """The prefix as the big-endian bytes appended to extranonce1."""
        return prefix.to_bytes(self.prefix_bytes, "big")

    def partition(self, n: int, i: int) -> "PrefixAllocator":
        """The ``i``-th of ``n`` disjoint static sub-ranges of this range,
        as a fresh allocator: their union is the range, the remainder
        spread over the leading ones, so a process rebuilt from its index
        alone gets its exact range back. Raises when a sub-range would be
        empty (more parts than prefixes)."""
        if n < 1:
            raise ValueError(f"need n >= 1 shards (got {n})")
        if not 0 <= i < n:
            raise ValueError(f"shard index {i} outside [0, {n})")
        width = self.stop - self.start
        lo = self.start + (width * i) // n
        hi = self.start + (width * (i + 1)) // n
        if hi <= lo:
            raise ValueError(
                f"partition {i}/{n} of [{self.start}, {self.stop}) is "
                f"empty — more shards than prefixes"
            )
        return PrefixAllocator(self.prefix_bytes, start=lo, stop=hi)
