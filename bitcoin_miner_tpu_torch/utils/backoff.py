"""Jittered retry backoff for the Stratum reconnect loop.

A constant retry interval has every miner of a fleet reconnecting in
lockstep after a pool restart. Decorrelated-jitter exponential backoff
draws each delay uniformly from ``[base, 3 * previous]``, capped, so
retries both grow and decorrelate across processes; success resets it.
"""

from __future__ import annotations

import random
from typing import Callable, Optional


class DecorrelatedJitterBackoff:
    """``next()`` yields the seconds to sleep before the next retry;
    ``reset()`` re-arms the ladder after a success. A seeded ``rng`` makes
    tests deterministic."""

    def __init__(
        self,
        base: float,
        cap: float,
        rng: Optional[random.Random] = None,
    ) -> None:
        if base <= 0:
            raise ValueError("base delay must be > 0")
        self.base = base
        self.cap = max(cap, base)
        self._rng: Callable[[float, float], float] = (
            rng or random.Random()
        ).uniform
        self._last: float = 0.0

    def next(self) -> float:
        prev = self._last if self._last > 0 else self.base
        self._last = min(self.cap, self._rng(self.base, prev * 3.0))
        return self._last

    def reset(self) -> None:
        self._last = 0.0
