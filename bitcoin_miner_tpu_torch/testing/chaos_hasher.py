"""Scripted faults around any ``Hasher``: the child failures the fleet
supervisor must survive, behind the unchanged seam.

Counterpart of ``bitcoin_miner_tpu/testing/chaos_hasher.py``. Every
fault is scripted, not random, so tests are deterministic:

==================  ===================================================
knob / method        the fault
==================  ===================================================
``kill()``           the card dies: every scan raises ``ChaosError``
                     until ``revive()`` (a stream's pump dies with
                     requests in flight)
``revive()``         the card comes back (the half-open probe succeeds;
                     a hung scan is released)
``die_after_scans``  die after N successful scans: a death at an exact
                     request boundary
``hang = True``      scans block (the GIL released) until ``revive()``:
                     only the supervisor's hang detector sees it, and a
                     revived scan still returns, a late result the
                     supervisor must drop
``delay_s``          every scan sleeps first (a slow card, whose share
                     the capacity weights shrink)
``error_every_n``    every Nth scan raises once (a transient error)
==================  ===================================================

The knobs are plain attributes, so a test scripts exact sequences.
``mask_calls`` records every ``set_version_mask``, so the re-broadcast of
the session mask on rejoin can be checked.
"""

from __future__ import annotations

import time
from typing import List, Optional

from ..backends.base import Hasher, ScanResult

__all__ = ["ChaosError", "ChaosHasher"]


class ChaosError(RuntimeError):
    """The scripted failure of a chaotic child."""


class ChaosHasher(Hasher):
    name = "chaos"
    scan_releases_gil = True  # a hang sleeps, the GIL released

    def __init__(self, inner: Hasher, label: Optional[str] = None) -> None:
        self.inner = inner
        if label is not None:
            self.chip_label = label
        #: every scan raises until ``revive()``.
        self.dead = False
        #: die after this many successful scans (None: never).
        self.die_after_scans: Optional[int] = None
        #: scans block until ``revive()``.
        self.hang = False
        #: seconds each scan sleeps before it runs.
        self.delay_s = 0.0
        #: raise once every Nth scan (0: never).
        self.error_every_n = 0
        #: successful scans.
        self.scans_done = 0
        #: scan attempts, failed ones included.
        self.scan_calls = 0
        #: every mask delivered by ``set_version_mask``, in order.
        self.mask_calls: List[int] = []

    def _label(self) -> str:
        return getattr(self, "chip_label", "?")

    # ------------------------------------------------------------ scripting
    def kill(self) -> None:
        """The card dies: every scan from now raises ``ChaosError``."""
        self.dead = True

    def revive(self) -> None:
        """The card comes back: clears ``dead``, ``hang`` and
        ``die_after_scans``, and releases a scan blocked on the hang,
        which then completes (a late result)."""
        self.dead = False
        self.hang = False
        self.die_after_scans = None

    # ------------------------------------------------------------- the seam
    def sha256d(self, data: bytes) -> bytes:
        if self.dead:
            raise ChaosError(f"chip {self._label()} dead")
        return self.inner.sha256d(data)

    def set_version_mask(self, mask: int) -> int:
        if self.dead:
            raise ChaosError(f"chip {self._label()} dead")
        self.mask_calls.append(mask)
        setter = getattr(self.inner, "set_version_mask", None)
        return setter(mask) if setter is not None else 0

    def scan(
        self,
        header76: bytes,
        nonce_start: int,
        count: int,
        target: int,
        max_hits: int = 64,
    ) -> ScanResult:
        self.scan_calls += 1
        if self.dead:
            raise ChaosError(f"chip {self._label()} dead")
        if (self.die_after_scans is not None
                and self.scans_done >= self.die_after_scans):
            self.dead = True
            raise ChaosError(f"chip {self._label()} died mid-stream after "
                             f"{self.scans_done} scans")
        if self.error_every_n and self.scan_calls % self.error_every_n == 0:
            raise ChaosError(f"chip {self._label()} transient error on scan "
                             f"{self.scan_calls}")
        while self.hang:  # the wedge, polled until revive()
            time.sleep(0.01)
        if self.delay_s > 0:
            time.sleep(self.delay_s)
        result = self.inner.scan(header76, nonce_start, count, target,
                                 max_hits)
        self.scans_done += 1
        return result

    def close(self) -> None:
        self.inner.close()
