"""Pure nonce-range and extranonce2 arithmetic: the dispatcher splits the
2^32 nonce space into disjoint, exhaustive per-worker ranges and rolls
extranonce2 for a fresh nonce space once one is exhausted; hosts sharing
one pool account split the extranonce2 space between them."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Tuple

NONCE_SPACE = 1 << 32


def split_range(start: int, count: int, n_workers: int) -> List[Tuple[int, int]]:
    """Split ``[start, start+count)`` into ``n_workers`` disjoint, exhaustive
    (start, count) sub-ranges; earlier workers take the remainder, so sizes
    differ by at most 1."""
    if n_workers <= 0:
        raise ValueError("n_workers must be positive")
    if count < 0 or start < 0 or start + count > NONCE_SPACE:
        raise ValueError(f"range [{start}, {start + count}) invalid for 2^32 space")
    base, rem = divmod(count, n_workers)
    out: List[Tuple[int, int]] = []
    cursor = start
    for i in range(n_workers):
        size = base + (1 if i < rem else 0)
        out.append((cursor, size))
        cursor += size
    return out


def partition_extranonce2_space(
    extranonce2_size: int, host_index: int, n_hosts: int
) -> Tuple[int, int, int]:
    """The host-level axis: this host's strided slice ``(start, stop,
    step)`` of the extranonce2 counter space ``[0, 256^size)``. Strides
    (host_index, host_index + n_hosts, …) keep every host busy even when
    the space is barely larger than n_hosts, and need no coordination."""
    if extranonce2_size < 1:
        raise ValueError("extranonce2_size must be >= 1")
    if not (0 <= host_index < n_hosts):
        raise ValueError(f"host_index {host_index} not in [0, {n_hosts})")
    return host_index, 256**extranonce2_size, n_hosts


@dataclass
class ExtranonceCounter:
    """Rolls extranonce2 values as fixed-width little-endian byte strings,
    from ``start`` in steps of ``step`` (a host's partition from
    :func:`partition_extranonce2_space`)."""

    size: int
    start: int = 0
    step: int = 1

    def __post_init__(self) -> None:
        if self.size < 1:
            raise ValueError("extranonce2 size must be >= 1")
        self._next = self.start

    @property
    def space(self) -> int:
        return 256**self.size

    def __iter__(self) -> Iterator[bytes]:
        return self

    def __next__(self) -> bytes:
        if self._next >= self.space:
            raise StopIteration
        value = self._next.to_bytes(self.size, "little")
        self._next += self.step
        return value

    def reset(self) -> None:
        self._next = self.start
