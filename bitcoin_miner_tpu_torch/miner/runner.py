"""The Stratum mining session: protocol client ↔ dispatcher glue.

Pool notifications become dispatcher jobs; dispatcher shares become
``mining.submit`` calls; accept, reject and stale verdicts land in the
stats the periodic reporter prints.
"""

from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING, Optional

from ..backends.base import Hasher
from ..protocol.stratum import StratumClient, StratumError
from .dispatcher import Dispatcher, Share
from .job import Job, StratumJobParams

if TYPE_CHECKING:
    from .scheduler import AdaptiveBatchScheduler

logger = logging.getLogger(__name__)


def _is_stale_error(e: StratumError) -> bool:
    """Pools say "stale" as code 21, as a string, or only in the message.
    A misclassification skews the stale/rejected stats only."""
    try:
        if int(e.code) == 21:
            return True
    except (TypeError, ValueError):
        pass
    msg = (e.message or "").lower()
    return "stale" in msg or "job not found" in msg or "job-not-found" in msg


class StratumMiner:
    """Mine against a Stratum v1 pool until stopped. The default hasher is
    the tile kernel on the card (``cuda-tile``)."""

    def __init__(
        self,
        host: str,
        port: int,
        username: str,
        password: str = "x",
        hasher: Optional[Hasher] = None,
        oracle: Optional[Hasher] = None,
        n_workers: int = 8,
        batch_size: int = 1 << 24,
        stream_depth: int = 2,
        scheduler: Optional["AdaptiveBatchScheduler"] = None,
    ) -> None:
        if hasher is None:
            from ..backends.base import get_hasher

            hasher = get_hasher("cuda-tile")
        self.dispatcher = Dispatcher(
            hasher,
            oracle=oracle,
            n_workers=n_workers,
            batch_size=batch_size,
            stream_depth=stream_depth,
            scheduler=scheduler,
        )
        #: the client's reconnects already folded into the stats.
        self._client_reconnects_seen = 0
        #: the last notify's params and the difficulty they were installed
        #: under; cleared on disconnect (a dead session's job must never be
        #: replayed).
        self._last_params: Optional[StratumJobParams] = None
        self._last_difficulty: Optional[float] = None
        self.client = StratumClient(
            host, port, username, password,
            on_job=self._on_job, on_difficulty=self._on_difficulty,
            on_disconnect=self._on_disconnect,
            on_extranonce=self._on_extranonce,
            on_version_mask=self._on_version_mask,
        )

    # --------------------------------------------------------- client → jobs
    async def _on_job(self, params: StratumJobParams) -> None:
        self._last_params = params
        self._last_difficulty = self.client.difficulty
        job = Job.from_stratum(
            params,
            extranonce1=self.client.extranonce1,
            extranonce2_size=self.client.extranonce2_size,
            difficulty=self.client.difficulty,
            version_mask=self.client.version_mask,
        )
        self.dispatcher.set_job(job)

    async def _on_version_mask(self) -> None:
        """BIP 310 mask change: re-install the job under the new mask."""
        if self._last_params is not None:
            await self._on_job(self._last_params)

    async def _on_difficulty(self, difficulty: float) -> None:
        logger.info("difficulty -> %g", difficulty)
        # A mid-job change must retarget the job being mined, or every
        # later share is judged against the old target. Skipped when the
        # difficulty is unchanged, e.g. a reconnect greeting, where
        # replaying the previous connection's job would mine a dead id.
        params = self._last_params
        if params is not None and difficulty != self._last_difficulty:
            await self._on_job(params)

    async def _on_disconnect(self) -> None:
        # Job ids and extranonce1 are per-connection.
        self._last_params = None
        self._last_difficulty = None
        self.dispatcher.reset_sweep_positions()
        self._sync_reconnects()

    def _sync_reconnects(self) -> None:
        """Fold the client's reconnect count into the stats."""
        delta = self.client.reconnects - self._client_reconnects_seen
        if delta > 0:
            self.dispatcher.stats.reconnects += delta
            self._client_reconnects_seen = self.client.reconnects

    async def _on_extranonce(self) -> None:
        # The current job's coinbase embeds the old extranonce1: rebuild it
        # and restart its extranonce2 axis.
        self.dispatcher.reset_sweep_positions()
        if self._last_params is not None:
            await self._on_job(self._last_params)

    # --------------------------------------------------------- shares → pool
    async def _on_share(self, share: Share) -> None:
        stats = self.dispatcher.stats
        try:
            ok = await self.client.submit_share(share)
        except StratumError as e:
            if _is_stale_error(e):
                stats.shares_stale += 1
                logger.info("stale share for job %s", share.job_id)
            else:
                stats.shares_rejected += 1
                logger.warning("share rejected: %s", e)
            return
        except (ConnectionError, asyncio.TimeoutError) as e:
            stats.shares_stale += 1
            logger.warning("share lost (job %s): %r", share.job_id, e)
            return
        if ok:
            stats.shares_accepted += 1
        else:
            stats.shares_rejected += 1

    # -------------------------------------------------------------- lifecycle
    async def run(self) -> None:
        client_task = asyncio.create_task(self.client.run(), name="stratum")
        try:
            await self.dispatcher.run(self._on_share)
        finally:
            self._sync_reconnects()
            self.client.stop()
            client_task.cancel()
            await asyncio.gather(client_task, return_exceptions=True)

    def stop(self) -> None:
        self.dispatcher.stop()
        self.client.stop()
