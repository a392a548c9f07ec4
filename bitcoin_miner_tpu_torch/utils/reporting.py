"""The periodic stats line (``--report-interval``).

Counterpart of ``bitcoin_miner_tpu/utils/reporting.py``: a windowed MH/s
(hashes since the last line over the interval, not the lifetime mean),
the busy clock's device rate and the share counters; with a telemetry
bundle the dispatch-gap p50/p95/p99 and submit-RTT p95 from the
histograms ``/metrics`` exports; the share accountant's confident
efficiency; with a multi-pool fabric, its live slots (``pools L/N
live``); the SLO engine's worst burning objective (``slo ok`` when
none burns); the time-series store's ``tsdb N series``; and the health
model's cached verdict.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Optional

from ..miner.dispatcher import MinerStats

logger = logging.getLogger("tpu_miner_torch.stats")


class StatsReporter:
    """Logs a stats line every ``interval`` seconds while running."""

    def __init__(
        self, stats: MinerStats, interval: float = 10.0,
        telemetry: Optional[Any] = None, health: Optional[Any] = None,
        accounting: Optional[Any] = None, slo: Optional[Any] = None,
        observatory: Optional[Any] = None, fabric: Optional[Any] = None,
    ) -> None:
        self.stats = stats
        self.interval = interval
        self.telemetry = telemetry
        #: health model: the line carries its cached verdict, so a log
        #: shows when a component went bad.
        self.health = health
        #: share accountant: ticking it keeps its gauges fresh through a
        #: shareless stretch; the line shows the ratio once confident.
        self.accounting = accounting
        #: SLO engine: the line carries its cached summary, so a log shows
        #: the budget burning before any health transition.
        self.slo = slo
        #: the observatory: its store's series count shows the collection
        #: plane is alive, and how wide a fleet it sees.
        self.observatory = observatory
        #: the multi-pool fabric: the line counts its live slots, read
        #: from the same slot states as ``/telemetry``'s ``pool_fabric``.
        self.fabric = fabric
        self._last_hashes = 0
        self._last_t = time.monotonic()

    def tick(self) -> str:
        """One report line."""
        now = time.monotonic()
        dt = now - self._last_t
        window = self.stats.hashes - self._last_hashes
        rate = window / dt if dt > 0 else 0.0
        self._last_hashes = self.stats.hashes
        self._last_t = now
        s = self.stats
        line = (
            f"{rate / 1e6:8.2f} MH/s (dev {s.device_hashrate() / 1e6:.2f}) | "
            f"shares {s.shares_accepted}/{s.shares_found} acc "
            f"({s.shares_rejected} rej, {s.shares_stale} stale) | "
            f"blocks {s.blocks_found} | hw_err {s.hw_errors} | "
            f"batches {s.batches}"
        )
        if s.reconnects:
            line += f" | reconnects {s.reconnects}"
        tel = self.telemetry
        if tel is not None and tel.enabled:
            gap = tel.dispatch_gap
            if gap.count:
                line += (
                    " | gap ms p50/p95/p99 "
                    f"{gap.quantile(0.5) * 1e3:.2f}/"
                    f"{gap.quantile(0.95) * 1e3:.2f}/"
                    f"{gap.quantile(0.99) * 1e3:.2f}"
                )
            rtt = tel.submit_rtt
            if rtt.count:
                line += f" | submit ms p95 {rtt.quantile(0.95) * 1e3:.1f}"
        if self.accounting is not None:
            eff = self.accounting.tick()
            if eff is not None:
                line += f" | share eff {eff:.2f}"
        if self.fabric is not None:
            slots = self.fabric.slots
            live = sum(1 for slot in slots if slot.live)
            line += f" | pools {live}/{len(slots)} live"
        for source in (self.slo, self.observatory):
            # Cached reads only: the watchdog and the observatory's thread
            # are the ones that evaluate and collect.
            fragment = source.summary() if source is not None else None
            if fragment is not None:
                line += f" | {fragment}"
        if self.health is not None:
            # The watchdog's cached report: the reporter never evaluates.
            line += f" | health {self.health.summary()}"
        return line

    async def run(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            logger.info(self.tick())
