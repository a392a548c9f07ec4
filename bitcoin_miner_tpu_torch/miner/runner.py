"""Mining sessions: protocol client ↔ dispatcher glue.

- :class:`StratumMiner`: pool notifications become dispatcher jobs,
  shares become ``mining.submit`` calls;
- :class:`GetworkMiner`: polled getwork headers become fixed-merkle jobs,
  solves go back through ``getwork``;
- :class:`GbtMiner`: getblocktemplate templates (BIP22 long polling where
  the node offers it) become jobs whose coinbase carries the extranonce2
  slot, and block-target hits go back as whole blocks via
  ``submitblock``.

Accept, reject and stale verdicts land in the stats the periodic reporter
prints, and every verdict passes ``_record_submit``: the ``pool_acks``
counter, the ``submits_inflight`` gauge, ``submit_rtt``, the ``submit``
span and ``pool_ack`` instant, a flight-recorder event, the share's
lifecycle hop and the session's :class:`ShareAccountant`. Every session's
default hasher is the tile kernel on the card (``cuda-tile``).
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import Counter
from typing import TYPE_CHECKING, Any, List, Optional, Tuple

from ..backends.base import Hasher
from ..core.target import target_to_difficulty
from ..protocol.stratum import StratumClient, StratumError
from ..telemetry import ShareAccountant, share_key
from ..utils.backoff import DecorrelatedJitterBackoff
from .dispatcher import Dispatcher, Share
from .job import Job, StratumJobParams

if TYPE_CHECKING:
    from ..protocol.getwork import GbtJob
    from .scheduler import AdaptiveBatchScheduler

logger = logging.getLogger(__name__)


def _submit_started(telemetry: Any) -> int:
    """Mark one share as awaiting a verdict (``submits_inflight``, the
    health model's pool signal); returns the round trip's start."""
    telemetry.submits_inflight.inc()
    return time.perf_counter_ns()


def _record_submit(
    telemetry: Any, t0_ns: int, share: Share, result: str,
    accounting: Optional[ShareAccountant] = None,
    difficulty: Optional[float] = None,
    pool: Optional[str] = None, lifecycle_key: Optional[str] = None,
) -> None:
    """One verdict's telemetry, the same for all three sessions and the
    multi-pool fabric: the ``pool_acks{result}`` counter and the in-flight
    gauge the health model watches, the accountant weighing the verdict by
    the difficulty the share was mined at, a flight-recorder event, and
    with telemetry on the ``submit_rtt`` sample, the share's ``submit``
    lifecycle hop with an exemplar, the ``submit`` span and the
    ``pool_ack`` instant. Every outcome lands here, so each
    :func:`_submit_started` is paired. ``pool`` names the fabric slot that
    judged the share on its ``submit`` hop; ``lifecycle_key`` replaces the
    key derived from the share, for a caller that remapped the share's
    identity on its way here."""
    telemetry.submits_inflight.dec()
    telemetry.pool_acks.labels(result=result).inc()
    if accounting is not None:
        accounting.on_result(result, difficulty)
    telemetry.flightrec.record(
        "share", result=result, job_id=share.job_id,
        nonce=f"{share.nonce:#010x}", block=share.is_block,
    )
    if not telemetry.enabled:
        return
    rtt_s = (time.perf_counter_ns() - t0_ns) / 1e9
    telemetry.submit_rtt.observe(rtt_s)
    lc = telemetry.lifecycle
    if lc.enabled:
        key = lifecycle_key or share_key(share.job_id, share.extranonce2,
                                         share.nonce)
        trace = telemetry.tracer.current_trace()
        hop_fields = {"result": result, "rtt_s": round(rtt_s, 6)}
        if pool is not None:
            hop_fields["pool"] = pool
        lc.hop(key, "submit", trace=trace, **hop_fields)
        lc.exemplar(telemetry.submit_rtt.name, rtt_s, trace=trace, key=key,
                    result=result)
    telemetry.tracer.complete(
        "submit", t0_ns, cat="share", job_id=share.job_id,
        nonce=f"{share.nonce:#010x}", result=result,
    )
    telemetry.tracer.instant(
        "pool_ack", cat="share", job_id=share.job_id, result=result
    )


def _submit_cancelled(telemetry: Any) -> None:
    """A submit cut by the session's stop: no verdict, but it no longer
    awaits one (the reference leaves ``submits_inflight`` raised)."""
    telemetry.submits_inflight.dec()


def _job_difficulty(dispatcher: Dispatcher) -> Optional[float]:
    """The current job's share difficulty: what an accepted share of a
    solo mode, which has no ``mining.set_difficulty``, is weighed by."""
    job: Optional[Job] = getattr(dispatcher, "_job", None)
    if job is None:
        return None
    return target_to_difficulty(job.share_target)


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


def _is_stale_reason(reason: str) -> bool:
    """A ``submitblock`` verdict that the block was built on a tip that is
    no longer the best (BIP22's "inconclusive" family, "duplicate", or a
    "stale" reason): a block that came too late, not an invalid one."""
    r = reason.lower()
    return r.startswith(("inconclusive", "duplicate")) or "stale" in r


def _default_hasher(hasher: Optional[Hasher]) -> Hasher:
    if hasher is not None:
        return hasher
    from ..backends.base import get_hasher

    return get_hasher("cuda-tile")


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
        extranonce2_start: int = 0,
        extranonce2_step: int = 1,
        allow_redirect: bool = False,
        ntime_roll: int = 0,
        suggest_difficulty: Optional[float] = None,
        failover: Optional[List[Tuple[str, int]]] = None,
        use_tls: bool = False,
        tls_verify: bool = True,
        stream_depth: int = 2,
        scheduler: Optional["AdaptiveBatchScheduler"] = None,
    ) -> None:
        self.dispatcher = Dispatcher(
            _default_hasher(hasher),
            oracle=oracle,
            n_workers=n_workers,
            batch_size=batch_size,
            extranonce2_start=extranonce2_start,
            extranonce2_step=extranonce2_step,
            ntime_roll=ntime_roll,
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
        #: every pool verdict, weighed by the difficulty in force; the
        #: reporter ticks it and the health model reads its gauges.
        self.accounting = ShareAccountant(self.dispatcher.stats)
        self.client = StratumClient(
            host, port, username, password,
            on_job=self._on_job, on_difficulty=self._on_difficulty,
            on_disconnect=self._on_disconnect,
            on_extranonce=self._on_extranonce,
            on_version_mask=self._on_version_mask,
            allow_redirect=allow_redirect,
            suggest_difficulty=suggest_difficulty,
            failover=failover,
            use_tls=use_tls,
            tls_verify=tls_verify,
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
        # Seeded before any share: a session whose hits all fail
        # verification must still grow its expected shares.
        self.accounting.set_difficulty(self.client.difficulty)

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
        if self.client.reconnects < self._client_reconnects_seen:
            self._client_reconnects_seen = 0  # a new client counts from 0
        delta = self.client.reconnects - self._client_reconnects_seen
        if delta > 0:
            self.dispatcher.stats.reconnects += delta
            self._client_reconnects_seen = self.client.reconnects
            self.dispatcher.telemetry.flightrec.record(
                "reconnect", total=self.dispatcher.stats.reconnects,
            )

    async def _on_extranonce(self) -> None:
        # The current job's coinbase embeds the old extranonce1: rebuild it
        # and restart its extranonce2 axis.
        self.dispatcher.reset_sweep_positions()
        if self._last_params is not None:
            await self._on_job(self._last_params)

    # --------------------------------------------------------- shares → pool
    async def _on_share(self, share: Share) -> None:
        stats = self.dispatcher.stats
        telemetry = self.dispatcher.telemetry
        t0 = _submit_started(telemetry)
        # The pool judges the share at the difficulty in force now; a
        # retarget landing while the verdict is in flight must not reweigh
        # it.
        difficulty = self.client.difficulty

        def record(result: str) -> None:
            _record_submit(telemetry, t0, share, result,
                           accounting=self.accounting, difficulty=difficulty)

        try:
            ok = await self.client.submit_share(share)
        except StratumError as e:
            if _is_stale_error(e):
                stats.shares_stale += 1
                record("stale")
                logger.info("stale share for job %s", share.job_id)
            else:
                stats.shares_rejected += 1
                record("rejected")
                logger.warning("share rejected: %s", e)
            return
        except ConnectionError as e:
            stats.shares_stale += 1
            record("lost")
            logger.warning("share lost (job %s): %r", share.job_id, e)
            return
        except asyncio.TimeoutError:
            # The pool kept the verdict past the request timeout.
            stats.shares_stale += 1
            record("timeout")
            logger.warning("share submit timed out (job %s)", share.job_id)
            return
        except asyncio.CancelledError:
            _submit_cancelled(telemetry)
            raise
        if ok:
            stats.shares_accepted += 1
            record("accepted")
        else:
            stats.shares_rejected += 1
            record("rejected")

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


class GetworkMiner:
    """getwork polling through the dispatcher: each fetched header is a
    fixed-merkle job (no extranonce2 axis), so new work supersedes the old
    sweep by generation instead of waiting behind a 2^32 scan, and the
    ntime axis (``ntime_roll``, 600 s by default) keeps the card busy
    between polls."""

    def __init__(
        self,
        url: str,
        username: str = "",
        password: str = "",
        hasher: Optional[Hasher] = None,
        oracle: Optional[Hasher] = None,
        n_workers: int = 8,
        batch_size: int = 1 << 24,
        poll_interval: float = 5.0,
        ntime_roll: int = 600,
        stream_depth: int = 2,
        scheduler: Optional["AdaptiveBatchScheduler"] = None,
    ) -> None:
        from ..protocol.getwork import GetworkClient

        self.client = GetworkClient(url, username, password)
        self.dispatcher = Dispatcher(
            _default_hasher(hasher), oracle=oracle, n_workers=n_workers,
            batch_size=batch_size, ntime_roll=ntime_roll,
            stream_depth=stream_depth, scheduler=scheduler,
        )
        self.poll_interval = poll_interval
        self.solves_submitted = 0
        self.solves_accepted = 0
        self._stopping = False
        self._current_job_id: Optional[str] = None
        self.accounting = ShareAccountant(self.dispatcher.stats)
        #: retry delays after a failed fetch, so a dead node is not polled
        #: at full cadence; a success resets them.
        self._poll_backoff = DecorrelatedJitterBackoff(
            poll_interval, max(poll_interval * 2, 60.0))

    async def _poll_loop(self) -> None:
        last_work: Optional[bytes] = None
        while not self._stopping:
            try:
                job, header76 = await self.client.fetch_work()
            except Exception as e:  # noqa: BLE001 — a dead node is retried
                logger.warning("getwork fetch failed: %s; retrying", e)
                await asyncio.sleep(self._poll_backoff.next())
                continue
            self._poll_backoff.reset()
            # The ntime bytes (68-72) are left out: servers bump ntime on
            # every request, and taking that for new work would restart the
            # sweep at nonce 0 each poll, never reaching the ntime axis. The
            # dispatcher mines and submits its own job's ntimes.
            work_identity = header76[:68] + header76[72:76]
            if work_identity != last_work:
                last_work = work_identity
                self._current_job_id = job.job_id
                self.dispatcher.set_job(job)
            await asyncio.sleep(self.poll_interval)

    async def _on_share(self, share: Share) -> None:
        stats = self.dispatcher.stats
        if share.job_id != self._current_job_id:
            stats.shares_stale += 1
            return
        self.solves_submitted += 1
        telemetry = self.dispatcher.telemetry
        t0 = _submit_started(telemetry)
        difficulty = _job_difficulty(self.dispatcher)

        def record(result: str) -> None:
            _record_submit(telemetry, t0, share, result,
                           accounting=self.accounting, difficulty=difficulty)

        try:
            ok = await self.client.submit(share.header80)
        except asyncio.CancelledError:
            _submit_cancelled(telemetry)
            raise
        except Exception as e:  # noqa: BLE001 — logged; the session goes on
            record("error")
            logger.error("getwork submit failed: %s", e)
            return
        if ok:
            self.solves_accepted += 1
            stats.shares_accepted += 1
            record("accepted")
        else:
            stats.shares_rejected += 1
            record("rejected")

    async def run(self) -> None:
        poll_task = asyncio.create_task(self._poll_loop(), name="getwork-poll")
        try:
            await self.dispatcher.run(self._on_share)
        finally:
            self._stopping = True
            poll_task.cancel()
            await asyncio.gather(poll_task, return_exceptions=True)

    def stop(self) -> None:
        self._stopping = True
        self.dispatcher.stop()


class GbtMiner:
    """Solo mining against a node's getblocktemplate: templates become
    jobs (the coinbase carries the extranonce2 slot), and every hit that
    meets the block target goes back as a whole block through
    ``submitblock``.

    Besides the dispatcher's stats it counts blocks submitted, accepted,
    stale (built on a template the node has moved past: the miner's job
    changed before the submit, or the node said so) and rejected, with
    the node's reasons in :attr:`reject_reasons`."""

    def __init__(
        self,
        url: str,
        username: str = "",
        password: str = "",
        hasher: Optional[Hasher] = None,
        oracle: Optional[Hasher] = None,
        n_workers: int = 8,
        batch_size: int = 1 << 24,
        poll_interval: float = 5.0,
        extranonce2_size: int = 4,
        script_pubkey: Optional[bytes] = None,
        stream_depth: int = 2,
        scheduler: Optional["AdaptiveBatchScheduler"] = None,
    ) -> None:
        from ..core.tx import OP_TRUE_SCRIPT
        from ..protocol.getwork import GbtClient

        self.client = GbtClient(
            url, username, password, extranonce2_size=extranonce2_size,
            script_pubkey=script_pubkey or OP_TRUE_SCRIPT)
        self.dispatcher = Dispatcher(
            _default_hasher(hasher), oracle=oracle, n_workers=n_workers,
            batch_size=batch_size, submit_blocks_only=True,
            stream_depth=stream_depth, scheduler=scheduler,
        )
        self.poll_interval = poll_interval
        self.blocks_submitted = 0
        self.blocks_accepted = 0
        self.blocks_stale = 0
        self.blocks_rejected = 0
        self.reject_reasons: "Counter[str]" = Counter()
        self._current: Optional["GbtJob"] = None
        self._stopping = False
        #: accepted blocks weighed by the block target's difficulty: far
        #: below the confidence floor on any real run, so the drift rule
        #: stays silent.
        self.accounting = ShareAccountant(self.dispatcher.stats)
        self._poll_backoff = DecorrelatedJitterBackoff(
            poll_interval, max(poll_interval * 2, 60.0))

    @staticmethod
    def _template_identity(template: "dict[str, Any]") -> "tuple[Any, ...]":
        """What makes a template new work: the tip it builds on, the
        reward and the transaction set. A fee-bumped template at the same
        height must supersede the running job."""
        return (
            template.get("previousblockhash"),
            template.get("coinbasevalue"),
            tuple(t.get("txid") or t.get("hash")
                  for t in template.get("transactions", [])),
        )

    async def _poll_loop(self) -> None:
        last_identity = None
        while not self._stopping:
            # After the first fetch, BIP22 long polling where the node
            # offers it: the request waits on the node and returns when the
            # template changes. Otherwise interval polling.
            longpoll = self.client.last_longpollid is not None
            try:
                gbt = await self.client.fetch_job(longpoll=longpoll)
            except asyncio.TimeoutError:
                if longpoll:
                    continue  # a quiet template outlived the wait: re-park
                logger.warning("getblocktemplate timed out; retrying")
                await asyncio.sleep(self._poll_backoff.next())
                continue
            except Exception as e:  # noqa: BLE001 — a dead node is retried
                logger.warning("getblocktemplate failed: %s; retrying", e)
                # A restarted node may refuse the remembered longpollid:
                # the next attempt is a plain request.
                self.client.last_longpollid = None
                await asyncio.sleep(self._poll_backoff.next())
                continue
            self._poll_backoff.reset()
            identity = self._template_identity(gbt.template)
            changed = identity != last_identity
            if changed:
                if last_identity is not None:
                    logger.info("template changed (%s); switching jobs",
                                "new tip" if identity[0] != last_identity[0]
                                else "tx set / fees")
                last_identity = identity
                self._current = gbt
                self.dispatcher.set_job(gbt.job)
            if self.client.last_longpollid is None:
                await asyncio.sleep(self.poll_interval)
            elif not changed:
                # A long poll that returned the same work: a short pause,
                # so a server that does not park cannot spin us.
                await asyncio.sleep(min(1.0, self.poll_interval))

    async def _on_share(self, share: Share) -> None:
        stats = self.dispatcher.stats
        gbt = self._current
        if gbt is None or share.job_id != gbt.job.job_id:
            stats.shares_stale += 1
            self.blocks_stale += share.is_block
            return
        if not share.is_block:
            return  # solo mining: only block-target hits count
        self.blocks_submitted += 1
        telemetry = self.dispatcher.telemetry
        t0 = _submit_started(telemetry)
        difficulty = _job_difficulty(self.dispatcher)

        def record(result: str) -> None:
            _record_submit(telemetry, t0, share, result,
                           accounting=self.accounting, difficulty=difficulty)

        try:
            reason = await self.client.submit_block(gbt, share.extranonce2,
                                                    share.header80)
        except asyncio.CancelledError:
            _submit_cancelled(telemetry)
            raise
        except Exception as e:  # noqa: BLE001 — logged; the session goes on
            record("error")
            logger.error("submitblock failed: %s", e)
            return
        if reason is None:
            self.blocks_accepted += 1
            stats.shares_accepted += 1
            record("accepted")
            logger.warning("block ACCEPTED (job %s)", share.job_id)
        elif _is_stale_reason(str(reason)):
            self.blocks_stale += 1
            stats.shares_stale += 1
            record("stale")
            logger.info("block stale (job %s): %s", share.job_id, reason)
        else:
            self.blocks_rejected += 1
            self.reject_reasons[str(reason)] += 1
            stats.shares_rejected += 1
            record("rejected")
            logger.error("block rejected: %s", reason)

    async def run(self) -> None:
        poll_task = asyncio.create_task(self._poll_loop(), name="gbt-poll")
        try:
            await self.dispatcher.run(self._on_share)
        finally:
            self._stopping = True
            poll_task.cancel()
            await asyncio.gather(poll_task, return_exceptions=True)

    def stop(self) -> None:
        self._stopping = True
        self.dispatcher.stop()
