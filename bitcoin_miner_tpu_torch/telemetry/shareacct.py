"""Expected-vs-observed share accounting.

Counterpart of ``bitcoin_miner_tpu/telemetry/shareacct.py``. A hash
meets a share target of difficulty ``d`` with probability
``1 / (d · 2^32)``, so every accepted share at difficulty ``d`` stands
for ``d · 2^32`` hashes of work. Summed over accepted shares and divided
by the hashes the busy clock swept:

    efficiency = Σ (d_i · 2^32) / hashes_done      (expectation: 1.0)

Persistently below 1, the pipeline hashes work that never becomes
credited shares (hardware errors, a stale path, a skimming pool). The
health model turns that drift into a ``degraded`` verdict once enough
expected shares exist for the ratio to mean something.

Exported as the ``tpu_miner_share_efficiency`` and
``tpu_miner_share_expected`` gauges, the reporter's ``share eff``
fragment and the ``shares`` component of ``/healthz``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from .pipeline import TelemetryBound

#: hashes-of-work one difficulty-1 share represents.
WORK_PER_DIFF1 = float(1 << 32)

#: expected-share confidence floor below which the drift verdicts stay
#: silent, and the drift bound itself — ONE definition shared with the
#: health model's ``shares`` rule (telemetry/health.py reads these as
#: its defaults, so the estimator and the rule cannot disagree about
#: when the evidence is real). The floor is sized for the RULE, not
#: just for "any share at all": degraded fires at efficiency < 0.5,
#: i.e. at most floor/2 accepted — for a healthy miner that is
#: P(Poisson(20) ≤ 10) ≈ 0.5%, vs ~12.5% had the floor been 5.
MIN_EXPECTED_SHARES = 20.0
DRIFT_DEGRADED_BELOW = 0.5


class ShareAccountant(TelemetryBound):
    """Difficulty-weighted accepted-share work vs hashes swept.

    Fed by the miner front-ends (one :meth:`on_result` per pool verdict,
    with the difficulty the share was mined at) and ticked by the
    reporter so the gauges stay fresh even through a shareless stretch.
    Thread-safe: results arrive on the event loop, the health watchdog
    reads gauges from its own thread."""

    def __init__(
        self,
        stats,
        telemetry=None,
        min_expected: float = MIN_EXPECTED_SHARES,
    ) -> None:
        #: MinerStats whose ``hashes`` counter (the busy clock's own
        #: accumulator) is the expected-work denominator.
        self.stats = stats
        #: expected shares below which :meth:`efficiency` stays None —
        #: the Poisson-noise floor (see MIN_EXPECTED_SHARES).
        self.min_expected = min_expected
        self._lock = threading.Lock()
        self._observed_work = 0.0  # Σ accepted_i · d_i · 2^32
        self._accepted = 0
        self._unaccounted = 0  # rejected/stale/lost/timeout/error verdicts
        self._last_difficulty: Optional[float] = None
        if telemetry is not None:
            self.telemetry = telemetry

    # ---------------------------------------------------------------- feed
    def set_difficulty(self, difficulty: Optional[float]) -> None:
        """Seed/refresh the session difficulty from the protocol layer
        (``mining.set_difficulty`` / job install). Without this a run
        that never submits a single share — the broken-kernel case
        where every hit fails oracle verification — would never learn a
        difficulty, expected_shares would sit at 0 forever, and the
        drift rule could not arm on precisely the failure it exists to
        catch."""
        if difficulty is not None and difficulty > 0:
            with self._lock:
                self._last_difficulty = float(difficulty)
            self.update()

    def on_result(self, result: str, difficulty: Optional[float]) -> None:
        """One pool verdict for a share mined at ``difficulty``. Every
        verdict updates the accumulator (non-accepts are the loss being
        measured); a missing/invalid difficulty still counts the verdict
        but adds no observed work (conservative: efficiency can only
        read lower, never higher, on bad inputs)."""
        with self._lock:
            if difficulty is not None and difficulty > 0:
                self._last_difficulty = float(difficulty)
                if result == "accepted":
                    self._observed_work += difficulty * WORK_PER_DIFF1
            if result == "accepted":
                self._accepted += 1
            else:
                self._unaccounted += 1
        self.update()

    # ------------------------------------------------------------- derive
    def expected_shares(self) -> float:
        """Shares the swept hashes should have produced at the current
        difficulty — the confidence denominator. Uses the latest
        difficulty for the whole history (exact integration would need a
        difficulty-change log; for a confidence floor the approximation
        only shifts WHEN the rule arms, never whether drift is real)."""
        with self._lock:
            d = self._last_difficulty
        if not d:
            return 0.0
        return self.stats.hashes / (d * WORK_PER_DIFF1)

    def efficiency(self) -> Optional[float]:
        """Observed/expected work ratio, or None below the confidence
        floor (not enough hashes swept for the ratio to be evidence)."""
        hashes = self.stats.hashes
        if hashes <= 0 or self.expected_shares() < self.min_expected:
            return None
        with self._lock:
            return self._observed_work / hashes

    def snapshot(self) -> Dict:
        """All the accounting numbers in one dict (tests, /telemetry)."""
        with self._lock:
            observed = self._observed_work
            accepted = self._accepted
            unaccounted = self._unaccounted
            d = self._last_difficulty
        hashes = self.stats.hashes
        return {
            "hashes": hashes,
            "accepted": accepted,
            "unaccounted": unaccounted,
            "difficulty": d,
            "observed_work": observed,
            "expected_shares": self.expected_shares(),
            "efficiency": self.efficiency(),
            "expected_share_rate_hz": (
                self.stats.device_hashrate() / (d * WORK_PER_DIFF1)
                if d else 0.0
            ),
        }

    # ------------------------------------------------------------- export
    def update(self) -> None:
        """Refresh the gauges from the accumulator. Called on every
        verdict and on each reporter tick, so a run that stops finding
        shares still shows its expected count growing (which is itself
        the signal). The efficiency gauge carries the RAW ratio as soon
        as any work exists — confidence gating is the CONSUMERS' job
        (the reporter via :meth:`efficiency`, the health rule via the
        ``share_expected`` floor), so a caller-tuned ``min_expected``
        can never desynchronize the gauge from the rule that reads
        it."""
        tel = self.telemetry
        expected = self.expected_shares()
        tel.share_expected.set(expected)
        hashes = self.stats.hashes
        if hashes > 0:
            with self._lock:
                observed = self._observed_work
            tel.share_efficiency.set(observed / hashes)

    def tick(self) -> Optional[float]:
        """Reporter hook: refresh gauges, return the confident efficiency
        (or None, in which case the line omits the fragment)."""
        self.update()
        return self.efficiency()
