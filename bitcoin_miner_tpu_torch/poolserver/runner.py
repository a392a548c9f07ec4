"""One ``--serve-pool`` run: the listener, the job source and the
optional internal worker.

Counterpart of ``bitcoin_miner_tpu/poolserver/runner.py``, with the
``run()`` / ``stop()`` / ``stats`` surface that ``cli.run_session``
drives for every session mode.
"""

from __future__ import annotations

import asyncio
import logging
from typing import List, Optional, Union

from ..miner.dispatcher import MinerStats
from .jobs import FabricUpstreamProxy, LocalTemplateSource, UpstreamProxy
from .server import InternalWorker, StratumPoolServer

logger = logging.getLogger(__name__)


class PoolFrontend:
    """One serve-pool run: listener + job source (+ internal worker)."""

    def __init__(
        self,
        server: StratumPoolServer,
        host: str,
        port: int,
        *,
        proxy: Optional[Union[UpstreamProxy, FabricUpstreamProxy]] = None,
        local_source: Optional[LocalTemplateSource] = None,
        job_interval_s: float = 30.0,
        internal_worker: Optional[InternalWorker] = None,
    ) -> None:
        if (proxy is None) == (local_source is None):
            raise ValueError(
                "exactly one job source: an upstream proxy OR a local "
                "template stream"
            )
        self.server = server
        self.host = host
        self.port = port
        self.proxy = proxy
        self.local_source = local_source
        self.job_interval_s = job_interval_s
        self.internal_worker = internal_worker
        self._stats: Optional[MinerStats] = None
        self._stop_event: Optional[asyncio.Event] = None
        self._stopping = False

    @property
    def stats(self) -> MinerStats:
        """The reporter's counters: the internal worker's dispatcher's
        when the frontend mines its own slice, else an idle
        ``MinerStats`` (the line still shows uptime and health)."""
        if self.internal_worker is not None:
            return self.internal_worker.dispatcher.stats
        if self._stats is None:
            self._stats = MinerStats(telemetry=self.server.telemetry)
        return self._stats

    @property
    def hasher(self):
        """The internal worker's hasher, or None."""
        if self.internal_worker is None:
            return None
        return self.internal_worker.dispatcher.hasher

    @property
    def fabric(self):
        """The multi-pool fabric behind a ``FabricUpstreamProxy``, or
        None."""
        return getattr(self.proxy, "fabric", None)

    async def _template_loop(self) -> None:
        assert self.local_source is not None
        while not self._stopping:
            await self.server.set_job(self.local_source.next_job())
            await asyncio.sleep(self.job_interval_s)

    async def run(self) -> None:
        self._stop_event = asyncio.Event()
        if self._stopping:
            self._stop_event.set()
        await self.server.start(self.host, self.port)
        tasks: List[asyncio.Task] = []
        if self.proxy is not None:
            tasks.append(asyncio.create_task(
                self.proxy.run(), name="poolserver-upstream"
            ))
        else:
            tasks.append(asyncio.create_task(
                self._template_loop(), name="poolserver-template"
            ))
        if self.internal_worker is not None:
            tasks.append(asyncio.create_task(
                self.internal_worker.run(), name="poolserver-internal"
            ))
        stop_wait = asyncio.create_task(self._stop_event.wait())
        pending = {stop_wait, *tasks}
        try:
            # A task that fails (the internal worker's dispatcher on a
            # device error, the upstream proxy) ends the run with its
            # exception instead of leaving a listener that mines nothing.
            while not stop_wait.done():
                done, pending = await asyncio.wait(
                    pending, return_when=asyncio.FIRST_COMPLETED
                )
                for t in done:
                    if t is stop_wait or t.cancelled():
                        continue
                    exc = t.exception()
                    if exc is not None:
                        logger.error("pool frontend: %s failed: %r; "
                                     "stopping", t.get_name(), exc)
                        raise exc
        finally:
            stop_wait.cancel()
            if self.proxy is not None:
                self.proxy.stop()
            if self.internal_worker is not None:
                self.internal_worker.stop()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            await self.server.stop()

    def stop(self) -> None:
        self._stopping = True
        if self._stop_event is not None:
            self._stop_event.set()
