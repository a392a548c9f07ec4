"""The multi-pool fabric: several upstream sessions behind one dispatcher.

Counterpart of ``bitcoin_miner_tpu/miner/multipool.py``. Every pool gets a
:class:`PoolSlot` running its own protocol state machine (the
``StratumClient`` connect/subscribe/authorize/reconnect loop, or a
getwork/getblocktemplate poll loop), walking one FSM::

    connecting ──handshake──▶ syncing ──first job──▶ active
         ▲                                        │      │
         │◀─────────── jittered backoff ──────────┘      ▼
       dead ◀─── circuit breaker (repeated refused      degraded
                 handshakes; half-open probe after a    (stalled acks)
                 cooldown)

- **Capacity routing**: each slot keeps a sliding window of its submit
  verdicts; its weight is ``configured weight × difficulty-weighted
  accept rate × a submit-p99 latency factor`` (× ``DEGRADED_FACTOR``
  while degraded), and the dispatcher's ownership is stride-scheduled
  across the live slots in proportion to those weights, re-evaluated
  every routing quantum: capacity follows where shares are credited.
- **Instant failover**: the slots that do not own the dispatcher keep
  live sessions and current jobs, so when the active pool goes down
  (disconnect, stalled acks, breaker) the next dispatch generation
  targets a survivor at once. In-flight results of the old generation
  are dropped by the dispatcher's generation tag, and job ids are
  namespaced ``p<slot>/<id>`` at install, so a share goes back only to
  the pool that announced its job (``stale_unroutable`` counts the rest).

Sweep positions are not reset when one slot reconnects: ``Job.sweep_key``
digests the whole work identity, so a resume cannot be ambiguous, and
clearing the shared dispatcher's positions would re-mine a healthy
survivor's covered space.

Deliberate differences from the reference: a ``gbt+http`` slot counts a
``submitblock`` answer of ``inconclusive*``, ``duplicate*`` or ``stale``
as stale, as :class:`~.runner.GbtMiner` does (the reference counts every
non-null reason as rejected); a submit cut by the session's stop lowers
``submits_inflight`` and the slot's own ``inflight`` (the reference
leaves both raised); and only an answer from the pool restarts or stops
a slot's stall clock (the reference restarts it on a local timeout too
and stops it once nothing is pending, so a muted pool whose submits time
out at the stall bound never degrades).
The slot windows take a lock: the SLO engine and the observatory read
them from their own threads.
"""

from __future__ import annotations

import asyncio
import dataclasses
import inspect
import logging
import math
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Awaitable, Callable, Deque, Dict, List, Optional, Tuple
from urllib.parse import urlparse

from ..backends.base import Hasher
from ..core.target import target_to_difficulty
from ..protocol.getwork import GbtClient, GbtJob, GetworkClient
from ..protocol.stratum import StratumClient, StratumError
from ..telemetry import get_telemetry
from ..telemetry.pipeline import POOL_SLOT_LEVELS
from ..telemetry.shareacct import WORK_PER_DIFF1, ShareAccountant
from ..utils.backoff import DecorrelatedJitterBackoff
from .dispatcher import Dispatcher, Share
from .job import Job, StratumJobParams
from .runner import (
    GbtMiner,
    _default_hasher,
    _is_stale_error,
    _is_stale_reason,
    _record_submit,
    _submit_cancelled,
    _submit_started,
)

logger = logging.getLogger(__name__)

# Slot FSM states; their gauge levels are telemetry.pipeline's
# POOL_SLOT_LEVELS, which the health model classifies from.
CONNECTING = "connecting"
SYNCING = "syncing"
ACTIVE = "active"
DEGRADED = "degraded"
DEAD = "dead"

#: The verdicts a pool gave itself; ``timeout``, ``lost`` and ``error``
#: are the session's own.
_POOL_ANSWERS = ("accepted", "rejected", "stale")


# ----------------------------------------------------------------- specs
@dataclass(frozen=True)
class PoolSpec:
    """One upstream pool, parsed from a ``--pool`` URL."""

    kind: str  # "stratum" | "getwork" | "gbt"
    host: str
    port: int
    use_tls: bool = False
    #: the configured weight (the URL's ``#w=`` fragment); the measured
    #: accept-rate and latency factors multiply it.
    weight: float = 1.0
    #: the HTTP path of the getwork and gbt kinds.
    path: str = "/"
    label: str = ""

    @property
    def http_url(self) -> str:
        return f"http://{self.host}:{self.port}{self.path}"


def parse_pool_spec(url: str, default_port: int = 3333) -> PoolSpec:
    """``stratum+tcp://host:port#w=2`` (or ``stratum+ssl``,
    ``getwork+http``, ``gbt+http``) → :class:`PoolSpec`. The fragment
    carries the optional dispatch weight (``#w=2``, ``#weight=2`` or a
    bare ``#2``); a bare ``host:port`` is Stratum over TCP."""
    raw = url.strip()
    if "//" not in raw:
        raw = f"stratum+tcp://{raw}"
    parsed = urlparse(raw)
    scheme = parsed.scheme
    kinds = {
        "stratum+tcp": ("stratum", False),
        "stratum+ssl": ("stratum", True),
        "getwork+http": ("getwork", False),
        "gbt+http": ("gbt", False),
    }
    if scheme not in kinds:
        raise ValueError(
            f"unsupported pool scheme {scheme!r} in {url!r} (use "
            "stratum+tcp://, stratum+ssl://, getwork+http:// or "
            "gbt+http://)"
        )
    kind, use_tls = kinds[scheme]
    weight = 1.0
    if parsed.fragment:
        frag = parsed.fragment
        for prefix in ("weight=", "w="):
            if frag.startswith(prefix):
                frag = frag[len(prefix):]
                break
        try:
            weight = float(frag)
        except ValueError:
            raise ValueError(f"bad pool weight fragment in {url!r}")
        if weight <= 0:
            raise ValueError(f"pool weight must be > 0 in {url!r}")
    host = parsed.hostname or "127.0.0.1"
    port = parsed.port or (default_port if kind == "stratum" else 8332)
    return PoolSpec(
        kind=kind, host=host, port=port, use_tls=use_tls, weight=weight,
        path=parsed.path or "/", label=f"{host}:{port}",
    )


# ------------------------------------------------------- sliding window
class SlotWindow:
    """The sliding window of one slot's submit verdicts: the measured half
    of its routing weight (difficulty-weighted accept rate and submit
    p99). Time comes from an injectable clock, so tests script it."""

    def __init__(
        self,
        window_s: float = 120.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.window_s = window_s
        self._clock = clock
        #: (t, result, claimed work, round trip in seconds)
        self._events: Deque[Tuple[float, str, float, float]] = deque()
        self._lock = threading.Lock()

    def record(
        self, result: str, difficulty: Optional[float], rtt_s: float
    ) -> None:
        work = (
            difficulty * WORK_PER_DIFF1
            if difficulty is not None and difficulty > 0 else 0.0
        )
        with self._lock:
            self._events.append((self._clock(), result, work, rtt_s))
            self._prune()

    def _prune(self) -> None:
        horizon = self._clock() - self.window_s
        while self._events and self._events[0][0] < horizon:
            self._events.popleft()

    def prune(self) -> None:
        with self._lock:
            self._prune()

    def accept_rate(self) -> Optional[float]:
        """Accepted over claimed work in the window (None: no evidence
        yet, which callers read as a neutral 1.0)."""
        with self._lock:
            self._prune()
            claimed = sum(e[2] for e in self._events)
            if claimed <= 0:
                return None
            accepted = sum(e[2] for e in self._events if e[1] == "accepted")
        return accepted / claimed

    def submit_p99(self) -> Optional[float]:
        with self._lock:
            self._prune()
            rtts = sorted(e[3] for e in self._events)
        if not rtts:
            return None
        return rtts[min(len(rtts) - 1,
                        max(0, math.ceil(0.99 * len(rtts)) - 1))]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            self._prune()
            events = len(self._events)
        return {
            "events": events,
            "accept_rate": self.accept_rate(),
            "submit_p99_s": self.submit_p99(),
        }


def capacity_weight(
    base: float,
    accept_rate: Optional[float],
    submit_p99: Optional[float],
    latency_ref_s: float = 1.0,
) -> float:
    """One pool's dispatch weight from its window. No evidence reads as
    neutral (a fresh pool starts at its configured weight); a collapsing
    accept rate drags the weight toward 0, and latency costs."""
    eff = 1.0 if accept_rate is None else max(0.0, min(accept_rate, 1.0))
    lat = (
        1.0 if submit_p99 is None
        else 1.0 / (1.0 + max(0.0, submit_p99) / latency_ref_s)
    )
    return base * eff * lat


async def _maybe_await(value: Any) -> Any:
    if inspect.isawaitable(value):
        return await value
    return value


# ------------------------------------------------------------- the slot
class PoolSlot:
    """One upstream pool's session, FSM and measured window."""

    kind = "?"
    #: whether a local verdict (a timeout, a lost connection, an error)
    #: leaves the stall clock running; else every verdict restarts it and
    #: it stops once nothing is pending, as in the reference.
    local_verdicts_stall = False

    def __init__(self, index: int, spec: PoolSpec, fabric: "PoolFabric") -> None:
        self.index = index
        self.spec = spec
        self.fabric = fabric
        self.label = spec.label
        self.state = CONNECTING
        self.state_since = fabric._clock()
        self.window = SlotWindow(fabric.window_s, fabric._clock)
        #: submits awaiting this pool's verdict: the slot's share of the
        #: ``submits_inflight`` gauge, and the stall rule's input.
        self.inflight = 0
        #: since when the pool has left submits unanswered, pending or
        #: timed out (None: it answered every submit sent to it).
        self._oldest_inflight_t: Optional[float] = None
        #: when the pool last answered a submit.
        self.last_verdict_t: Optional[float] = None
        self.reconnects = 0
        self.breaker_open_count = 0
        self._handshake_failures = 0
        self._breaker_cooldown = DecorrelatedJitterBackoff(
            fabric.breaker_cooldown_s, fabric.breaker_cooldown_s * 8,
        )
        self._job: Optional[Job] = None
        self._tasks: List[asyncio.Task] = []
        self._stopping = False
        #: the stride scheduler's pass value (see PoolFabric._pick).
        self._pass = 0.0

    # ------------------------------------------------------------- FSM
    def set_state(self, state: str, reason: str = "") -> None:
        if state == self.state:
            return
        old, self.state = self.state, state
        self.state_since = self.fabric._clock()
        self.fabric._on_slot_state(self, old, state, reason)

    @property
    def live(self) -> bool:
        """Routable: a session and a current job. A degraded slot stays
        routable, at a lower weight: it serves, badly."""
        return self.state in (ACTIVE, DEGRADED) and self._job is not None

    def current_job(self) -> Optional[Job]:
        return self._job

    # ------------------------------------------------------- lifecycle
    def start(self) -> None:
        raise NotImplementedError

    async def stop(self) -> None:
        self._stopping = True
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()

    def _spawn(self, coro: Awaitable[None], name: str) -> asyncio.Task:
        task = asyncio.get_running_loop().create_task(coro, name=name)
        self._tasks.append(task)
        task.add_done_callback(
            lambda t: self._tasks.remove(t) if t in self._tasks else None
        )
        return task

    # --------------------------------------------------------- verdicts
    def _submit_opened(self) -> int:
        t0 = _submit_started(self.fabric.telemetry)
        self.inflight += 1
        if self._oldest_inflight_t is None:
            self._oldest_inflight_t = self.fabric._clock()
        return t0

    def _submit_cancelled(self) -> None:
        """A submit cut by the session's stop: it no longer awaits a
        verdict, in the gauge or in the slot's count."""
        _submit_cancelled(self.fabric.telemetry)
        self.inflight = max(0, self.inflight - 1)
        if self.inflight == 0:
            self._oldest_inflight_t = None

    def _verdict(
        self, result: str, difficulty: Optional[float],
        share: Share, t0_ns: int,
        lifecycle_key: Optional[str] = None,
    ) -> None:
        """One pool verdict: the session accounting every single-pool
        runner does (``_record_submit``) and this slot's window. Any
        verdict the pool gave is progress, so a stall-degraded slot that
        answers again recovers here."""
        _record_submit(
            self.fabric.telemetry, t0_ns, share, result,
            accounting=self.fabric.accounting, difficulty=difficulty,
            pool=self.label, lifecycle_key=lifecycle_key,
        )
        rtt_s = (time.perf_counter_ns() - t0_ns) / 1e9
        self.window.record(result, difficulty, rtt_s)
        self.inflight = max(0, self.inflight - 1)
        answered = result in _POOL_ANSWERS
        if answered or not self.local_verdicts_stall:
            now = self.fabric._clock()
            self.last_verdict_t = now
            self._oldest_inflight_t = None if self.inflight == 0 else now
        stats = self.fabric.stats
        if stats is not None:
            if result == "accepted":
                stats.shares_accepted += 1
            elif result in ("stale", "lost", "timeout"):
                stats.shares_stale += 1
            else:
                stats.shares_rejected += 1
        if self.state == DEGRADED and self._job is not None and answered:
            # Only an answer from the pool is recovery: a local timeout or
            # a lost connection is the absence of progress.
            self.set_state(ACTIVE, "verdicts resumed")

    def stalled_inflight(self, now: float) -> bool:
        """Submits left unanswered by the pool for the stall bound,
        pending or (where local verdicts stall) timed out: the half-open
        socket's shape."""
        anchor = self._oldest_inflight_t
        if anchor is None:
            return False
        if self.last_verdict_t is not None:
            anchor = max(anchor, self.last_verdict_t)
        return (now - anchor) >= self.fabric.stall_after_s

    async def submit(
        self, share: Share, lifecycle_key: Optional[str] = None,
    ) -> Optional[str]:
        """Submit one share to this pool; the verdict (``accepted``,
        ``rejected``, …), or None when the share was dropped without
        touching the wire (stale for this slot). Every submit comes
        through here: the in-flight count and the window it keeps are
        what the stall rule and the weights read. ``lifecycle_key`` keys
        the ledger's submit hop when the caller remapped the share."""
        raise NotImplementedError

    def snapshot(self) -> Dict[str, Any]:
        return {
            "label": self.label,
            "kind": self.kind,
            "state": self.state,
            "weight": self.fabric.weight_of(self),
            "base_weight": self.spec.weight,
            "inflight": self.inflight,
            "reconnects": self.reconnects,
            "breaker_opens": self.breaker_open_count,
            "window": self.window.snapshot(),
            "job_id": self._job.job_id if self._job is not None else None,
        }


class StratumSlot(PoolSlot):
    """A Stratum upstream: the ``StratumClient`` state machine under the
    slot FSM, with a circuit breaker on consecutive attempts that never
    complete a handshake (refused connections and refused authorizations
    alike: hammering a refused login gets a worker banned)."""

    kind = "stratum"
    #: A submit to a silent socket ends in a local timeout, which is the
    #: stall itself: only the pool's own answer restarts the clock. (With
    #: the reference's clock and the request timeout at the stall bound,
    #: the command line's defaults, a muted pool's timeouts keep it from
    #: ever reading as stalled.)
    local_verdicts_stall = True

    def __init__(self, index: int, spec: PoolSpec, fabric: "PoolFabric") -> None:
        super().__init__(index, spec, fabric)
        self._last_params: Optional[StratumJobParams] = None
        self._last_difficulty: Optional[float] = None
        self.client = self._make_client()

    def _make_client(self) -> StratumClient:
        f = self.fabric
        return StratumClient(
            self.spec.host, self.spec.port, f.username, f.password,
            on_job=self._on_job,
            on_difficulty=self._on_difficulty,
            on_disconnect=self._on_disconnect,
            on_extranonce=self._on_extranonce,
            on_version_mask=self._on_version_mask,
            on_connect=self._on_connect,
            request_timeout=f.request_timeout,
            reconnect_base_delay=f.reconnect_base_delay,
            reconnect_max_delay=f.reconnect_max_delay,
            use_tls=self.spec.use_tls,
            tls_verify=f.tls_verify,
            suggest_difficulty=f.suggest_difficulty,
        )

    def start(self) -> None:
        self._spawn(self.client.run(), name=f"pool-{self.label}-client")

    async def stop(self) -> None:
        self._stopping = True
        self.client.stop()
        await super().stop()

    # ------------------------------------------------------- callbacks
    async def _on_connect(self) -> None:
        self._handshake_failures = 0
        self._breaker_cooldown.reset()
        if self.inflight == 0:
            # The submits the last session lost are not this one's stall.
            self._oldest_inflight_t = None
        # A pool greets with set_difficulty and notify during the
        # handshake, so the first job can beat this callback: a slot
        # already serving stays where it is.
        if self._job is None:
            self.set_state(SYNCING, "session established")

    async def _on_job(self, params: StratumJobParams) -> None:
        self._last_params = params
        self._last_difficulty = self.client.difficulty
        self._job = Job.from_stratum(
            params,
            extranonce1=self.client.extranonce1,
            extranonce2_size=self.client.extranonce2_size,
            difficulty=self.client.difficulty,
            version_mask=self.client.version_mask,
        )
        if self.state in (CONNECTING, SYNCING):
            self.set_state(ACTIVE, "job stream started")
        await self.fabric.on_slot_job(self)

    async def _rebuild_job(self) -> None:
        if self._last_params is not None:
            await self._on_job(self._last_params)

    async def _on_difficulty(self, difficulty: float) -> None:
        # As StratumMiner: a retarget re-targets the job being mined; an
        # unchanged greeting does not replay a dead job.
        if self._last_params is not None and difficulty != self._last_difficulty:
            await self._rebuild_job()

    async def _on_extranonce(self) -> None:
        await self._rebuild_job()

    async def _on_version_mask(self) -> None:
        await self._rebuild_job()

    async def _on_disconnect(self) -> None:
        established = self.client.session_established
        self._last_params = None
        self._last_difficulty = None
        self._job = None
        was_routable = self.state in (SYNCING, ACTIVE, DEGRADED)
        if established:
            self.reconnects += 1
            stats = self.fabric.stats
            if stats is not None:
                stats.reconnects += 1
        else:
            self._handshake_failures += 1
        reason = "disconnect"
        if (not self._stopping
                and self._handshake_failures >= self.fabric.breaker_threshold):
            self._open_breaker()
            reason = "breaker"
        elif self.state != DEAD:
            self.set_state(CONNECTING, "connection lost")
        if was_routable:
            await self.fabric.on_slot_down(self, reason)

    # -------------------------------------------------- circuit breaker
    def _open_breaker(self) -> None:
        self.breaker_open_count += 1
        cooldown = self._breaker_cooldown.next()
        self.set_state(
            DEAD,
            f"circuit breaker open after {self._handshake_failures} "
            f"handshake failures (half-open in {cooldown:.1f}s)",
        )
        # This client's retry loop would go on hammering the handshake:
        # stop it, and build a fresh one for the half-open probe.
        self.client.stop()
        self._spawn(
            self._half_open_after(cooldown),
            name=f"pool-{self.label}-halfopen",
        )

    async def _half_open_after(self, cooldown: float) -> None:
        await asyncio.sleep(cooldown)
        if self._stopping or self.state != DEAD:
            return
        # One failure in half-open opens the breaker again at once; a
        # completed handshake (_on_connect) closes it.
        self._handshake_failures = self.fabric.breaker_threshold - 1
        self.set_state(CONNECTING, "half-open probe")
        self.client = self._make_client()
        self._spawn(self.client.run(), name=f"pool-{self.label}-client")

    # ----------------------------------------------------------- submit
    async def submit(
        self, share: Share, lifecycle_key: Optional[str] = None,
    ) -> Optional[str]:
        t0 = self._submit_opened()
        # The pool judges at the difficulty in force now: read it before
        # the await, so a retarget in flight does not reweigh the share.
        difficulty = self.client.difficulty
        try:
            ok = await self.client.submit_share(share)
        except StratumError as e:
            result = "stale" if _is_stale_error(e) else "rejected"
        except ConnectionError:
            result = "lost"
        except asyncio.TimeoutError:
            result = "timeout"
        except asyncio.CancelledError:
            self._submit_cancelled()
            raise
        else:
            result = "accepted" if ok else "rejected"
        self._verdict(result, difficulty, share, t0,
                      lifecycle_key=lifecycle_key)
        return result


class GetworkSlot(PoolSlot):
    """A getwork upstream under the slot FSM: ``GetworkMiner``'s poll loop
    (the work identity without its ntime, jittered retries) feeding the
    fabric instead of a dispatcher of its own."""

    kind = "getwork"

    def __init__(self, index: int, spec: PoolSpec, fabric: "PoolFabric") -> None:
        super().__init__(index, spec, fabric)
        self.client = GetworkClient(
            spec.http_url, fabric.username, fabric.password
        )
        self._last_work: Optional[bytes] = None
        self._consec_failures = 0

    def start(self) -> None:
        self._spawn(self._poll_loop(), name=f"pool-{self.label}-poll")

    async def _poll_loop(self) -> None:
        interval = self.fabric.poll_interval
        backoff = DecorrelatedJitterBackoff(interval, max(interval * 2, 60.0))
        while not self._stopping:
            try:
                job, header76 = await self._fetch()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — a dead node is retried
                logger.warning(
                    "pool %s fetch failed: %s; retrying", self.label, e
                )
                await self._on_fetch_failure()
                await asyncio.sleep(backoff.next())
                continue
            backoff.reset()
            self._consec_failures = 0
            await self._on_fetched(job, header76)
            await asyncio.sleep(interval)

    async def _fetch(self) -> Tuple[Job, bytes]:
        return await self.client.fetch_work()

    def _poll_recovers(self) -> bool:
        """A successful poll brings the slot back: out of connecting,
        syncing or dead, and out of a stall once nothing sent to the node
        is pending (a solo slot may not submit again for hours)."""
        return self.state in (CONNECTING, SYNCING, DEAD) or (
            self.state == DEGRADED and self.inflight == 0)

    async def _on_fetched(self, job: Job, header76: bytes) -> None:
        # The identity leaves the ntime out, as GetworkMiner's does: a node
        # bumping ntime per request serves the same work.
        identity = header76[:68] + header76[72:76]
        if identity != self._last_work:
            self._last_work = identity
            self._job = job
            if self._poll_recovers():
                self.set_state(ACTIVE, "work stream started")
            await self.fabric.on_slot_job(self)
        elif self._poll_recovers():
            self.set_state(ACTIVE, "node answering")

    def _clear_work(self) -> None:
        """Drop the current work and its change detection: a recovered
        node serving the same work again must re-install it, or the slot
        would read active with no job until the work changes."""
        self._job = None
        self._last_work = None

    async def _on_fetch_failure(self) -> None:
        self._consec_failures += 1
        was_routable = self.state in (ACTIVE, DEGRADED)
        if self._consec_failures >= self.fabric.breaker_threshold:
            self._clear_work()
            self.breaker_open_count += 1 if self.state != DEAD else 0
            self.set_state(
                DEAD,
                f"{self._consec_failures} consecutive fetch failures",
            )
        elif self._consec_failures >= 2 and self.state != DEAD:
            # One failed poll is routine; two in a row, the node is not
            # answering: stop routing capacity at it.
            self._clear_work()
            self.set_state(CONNECTING, "node not answering")
        if was_routable and self._job is None:
            await self.fabric.on_slot_down(self, "disconnect")

    async def submit(
        self, share: Share, lifecycle_key: Optional[str] = None,
    ) -> Optional[str]:
        job = self._job
        if job is None or share.job_id != job.job_id:
            stats = self.fabric.stats
            if stats is not None:
                stats.shares_stale += 1
            return None
        t0 = self._submit_opened()
        difficulty = target_to_difficulty(job.share_target)
        try:
            ok = await self.client.submit(share.header80)
        except asyncio.CancelledError:
            self._submit_cancelled()
            raise
        except Exception as e:  # noqa: BLE001 — logged; the session goes on
            logger.error("pool %s submit failed: %s", self.label, e)
            self._verdict("error", difficulty, share, t0,
                          lifecycle_key=lifecycle_key)
            return "error"
        result = "accepted" if ok else "rejected"
        self._verdict(result, difficulty, share, t0,
                      lifecycle_key=lifecycle_key)
        return result


class GbtSlot(GetworkSlot):
    """A solo getblocktemplate upstream: the getwork slot's poll-loop FSM,
    change detection by ``GbtMiner``'s template identity, block-target
    hits submitted as whole blocks."""

    kind = "gbt"

    def __init__(self, index: int, spec: PoolSpec, fabric: "PoolFabric") -> None:
        PoolSlot.__init__(self, index, spec, fabric)
        self.client = GbtClient(
            spec.http_url, fabric.username, fabric.password
        )
        self._last_identity: Optional[Tuple[Any, ...]] = None
        self._current_gbt: Optional[GbtJob] = None
        self._last_work = None
        self._consec_failures = 0

    def _clear_work(self) -> None:
        super()._clear_work()
        self._last_identity = None
        self._current_gbt = None

    async def _poll_loop(self) -> None:
        interval = self.fabric.poll_interval
        backoff = DecorrelatedJitterBackoff(interval, max(interval * 2, 60.0))
        while not self._stopping:
            try:
                gbt = await self.client.fetch_job(longpoll=False)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — a dead node is retried
                logger.warning(
                    "pool %s getblocktemplate failed: %s; retrying",
                    self.label, e,
                )
                self.client.last_longpollid = None
                await self._on_fetch_failure()
                await asyncio.sleep(backoff.next())
                continue
            backoff.reset()
            self._consec_failures = 0
            identity = GbtMiner._template_identity(gbt.template)
            if identity != self._last_identity:
                self._last_identity = identity
                self._current_gbt = gbt
                self._job = gbt.job
                if self._poll_recovers():
                    self.set_state(ACTIVE, "template stream started")
                await self.fabric.on_slot_job(self)
            elif self._poll_recovers():
                self.set_state(ACTIVE, "node answering")
            await asyncio.sleep(interval)

    async def submit(
        self, share: Share, lifecycle_key: Optional[str] = None,
    ) -> Optional[str]:
        gbt = self._current_gbt
        if gbt is None or share.job_id != gbt.job.job_id:
            stats = self.fabric.stats
            if stats is not None:
                stats.shares_stale += 1
            return None
        if not share.is_block:
            return None  # solo mining: only block-target hits are submitted
        t0 = self._submit_opened()
        difficulty = target_to_difficulty(gbt.job.share_target)
        try:
            reason = await self.client.submit_block(
                gbt, share.extranonce2, share.header80
            )
        except asyncio.CancelledError:
            self._submit_cancelled()
            raise
        except Exception as e:  # noqa: BLE001 — logged; the session goes on
            logger.error("pool %s submitblock failed: %s", self.label, e)
            self._verdict("error", difficulty, share, t0,
                          lifecycle_key=lifecycle_key)
            return "error"
        # As GbtMiner: a block built on a tip the node has left is stale.
        if reason is None:
            result = "accepted"
        elif _is_stale_reason(str(reason)):
            result = "stale"
        else:
            result = "rejected"
        self._verdict(result, difficulty, share, t0,
                      lifecycle_key=lifecycle_key)
        return result


_SLOT_KINDS = {
    "stratum": StratumSlot,
    "getwork": GetworkSlot,
    "gbt": GbtSlot,
}


# ------------------------------------------------------------ the fabric
class PoolFabric:
    """Several concurrent upstream sessions behind one dispatch sink.

    The fabric owns the slots, the routing and the failover; what is
    dispatched is the sink's business: :class:`MultipoolMiner` wires
    :attr:`on_active_job` to ``Dispatcher.set_job``. Shares come back
    through :meth:`submit`, which routes each to the slot that owns its
    job: job ids are namespaced ``p<slot>/<id>`` at install, so a share
    of a dead pool's job is dropped (``stale_unroutable``), never sent to
    a pool that did not announce it."""

    #: weight multiplier of a degraded slot: still routable (it may be the
    #: only pool left), but a slot whose acks stalled has no window
    #: evidence against it, so the state itself costs.
    DEGRADED_FACTOR = 0.25

    def __init__(
        self,
        specs: List[PoolSpec],
        *,
        username: str = "tpu-miner",
        password: str = "x",
        telemetry: Optional[Any] = None,
        stats: Optional[Any] = None,
        accounting: Optional[ShareAccountant] = None,
        route_interval_s: float = 10.0,
        window_s: float = 120.0,
        latency_ref_s: float = 1.0,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 30.0,
        stall_after_s: float = 10.0,
        request_timeout: float = 10.0,
        reconnect_base_delay: float = 0.5,
        reconnect_max_delay: float = 30.0,
        poll_interval: float = 5.0,
        suggest_difficulty: Optional[float] = None,
        tls_verify: bool = True,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if not specs:
            raise ValueError("PoolFabric needs at least one PoolSpec")
        self.username = username
        self.password = password
        self.telemetry = telemetry if telemetry is not None else get_telemetry()
        #: the MinerStats the verdicts land in (None: none).
        self.stats = stats
        #: the session's one accountant, fed by every slot's verdicts: the
        #: ``shares`` health rule and the reporter read it as they do for
        #: one pool.
        self.accounting = accounting
        self.route_interval_s = route_interval_s
        self.window_s = window_s
        self.latency_ref_s = latency_ref_s
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        self.stall_after_s = stall_after_s
        self.request_timeout = request_timeout
        self.reconnect_base_delay = reconnect_base_delay
        self.reconnect_max_delay = reconnect_max_delay
        self.poll_interval = poll_interval
        self.suggest_difficulty = suggest_difficulty
        self.tls_verify = tls_verify
        self._clock = clock
        # Duplicate labels get a /<index> suffix, so the per-pool gauge
        # children stay distinct.
        seen: Dict[str, int] = {}
        self.slots: List[PoolSlot] = []
        for i, spec in enumerate(specs):
            label = spec.label or f"pool{i}"
            if label in seen:
                label = f"{label}/{i}"
            seen[label] = i
            spec = dataclasses.replace(spec, label=label)
            self.slots.append(_SLOT_KINDS[spec.kind](i, spec, self))
        #: the sink, called with (slot, namespaced job) on every install,
        #: sync or async; an int it returns is recorded as the dispatch
        #: generation in :attr:`dispatch_log`.
        self.on_active_job: Optional[Callable[..., Any]] = None
        self.active: Optional[PoolSlot] = None
        #: (dispatch generation, slot index) per install.
        self.dispatch_log: List[Tuple[int, int]] = []
        self.failovers = 0
        #: shares whose job no slot owns (dropped, never submitted to
        #: another pool).
        self.stale_unroutable = 0
        self._pending_failover: Optional[str] = None
        self._job_owner: "OrderedDict[str, PoolSlot]" = OrderedDict()
        self._job_owner_cap = 64
        self._route_task: Optional[asyncio.Task] = None
        self._stopping = False

    # ------------------------------------------------------- lifecycle
    async def start(self) -> None:
        for slot in self.slots:
            self._publish_state(slot)
            slot.start()
        self._route_task = asyncio.get_running_loop().create_task(
            self._route_loop(), name="pool-fabric-route"
        )

    async def stop(self) -> None:
        self._stopping = True
        if self._route_task is not None:
            self._route_task.cancel()
            await asyncio.gather(self._route_task, return_exceptions=True)
            self._route_task = None
        for slot in self.slots:
            await slot.stop()

    # ------------------------------------------------------- telemetry
    def _publish_state(self, slot: PoolSlot) -> None:
        self.telemetry.pool_slot_state.labels(pool=slot.label).set(
            POOL_SLOT_LEVELS[slot.state]
        )

    def _on_slot_state(
        self, slot: PoolSlot, old: str, new: str, reason: str
    ) -> None:
        self._publish_state(slot)
        self.telemetry.flightrec.record(
            "pool_slot", pool=slot.label, state=new, previous=old,
            reason=reason,
        )
        logger.info(
            "pool %s: %s -> %s%s", slot.label, old, new,
            f" ({reason})" if reason else "",
        )
        if new in (ACTIVE, DEGRADED) and old not in (ACTIVE, DEGRADED):
            # A slot (re)joining the live set starts at the live set's
            # stride position: a returning pool must not burn a backlog
            # of owed quanta holding the dispatcher.
            live_passes = [
                s._pass for s in self.slots if s.live and s is not slot
            ]
            if live_passes:
                slot._pass = max(slot._pass, min(live_passes))

    # --------------------------------------------------------- routing
    def weight_of(self, slot: PoolSlot) -> float:
        w = capacity_weight(
            slot.spec.weight,
            slot.window.accept_rate(),
            slot.window.submit_p99(),
            self.latency_ref_s,
        )
        if slot.state == DEGRADED:
            w *= self.DEGRADED_FACTOR
        return w

    def weights(self) -> Dict[str, float]:
        """The per-pool dispatch weights (0.0: not routable)."""
        return {
            slot.label: (self.weight_of(slot) if slot.live else 0.0)
            for slot in self.slots
        }

    def _pick(self, avoid: Optional[PoolSlot] = None) -> Optional[PoolSlot]:
        """Stride-schedule the next dispatcher owner across the live slots
        in proportion to their weights. ``avoid`` leaves out the slot
        being failed away from, unless it is the only one left."""
        live = [s for s in self.slots if s.live and s is not avoid]
        if not live:
            live = [s for s in self.slots if s.live]
        if not live:
            return None
        weighted = [(s, self.weight_of(s)) for s in live]
        usable = [(s, w) for s, w in weighted if w > 0]
        if not usable:
            # Every live pool's measured weight collapsed (all rejecting):
            # the configured weights decide; mining something beats
            # mining nothing.
            usable = [(s, s.spec.weight) for s in live]
        slot, weight = min(usable, key=lambda sw: (sw[0]._pass, sw[0].index))
        slot._pass += 1.0 / weight
        return slot

    async def _route_loop(self) -> None:
        while not self._stopping:
            await asyncio.sleep(self.route_interval_s)
            try:
                await self._tick()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — the next quantum retries
                logger.exception("pool fabric routing tick failed")

    async def _tick(self) -> None:
        """One routing quantum: the stall rule, then a rebalance."""
        now = self._clock()
        for slot in self.slots:
            if slot.stalled_inflight(now) and slot.state in (ACTIVE, SYNCING):
                slot.set_state(
                    DEGRADED,
                    f"{slot.inflight} submits unacked for "
                    f">{self.stall_after_s:.0f}s",
                )
                if slot is self.active:
                    await self.on_slot_down(slot, "stalled")
        await self._route("rebalance")

    async def _route(
        self, reason: str, avoid: Optional[PoolSlot] = None
    ) -> None:
        slot = self._pick(avoid)
        if slot is None:
            return
        if slot is self.active and reason == "rebalance":
            return
        await self._install(slot, reason)

    async def _install(self, slot: PoolSlot, reason: str) -> None:
        job = slot.current_job()
        if job is None:
            return
        nsid = f"p{slot.index}/{job.job_id}"
        njob = dataclasses.replace(job, job_id=nsid)
        self._job_owner[nsid] = slot
        self._job_owner.move_to_end(nsid)
        while len(self._job_owner) > self._job_owner_cap:
            self._job_owner.popitem(last=False)
        prev = self.active
        self.active = slot
        generation: Optional[int] = None
        if self.on_active_job is not None:
            result = await _maybe_await(self.on_active_job(slot, njob))
            if isinstance(result, int):
                generation = result
        if generation is not None:
            self.dispatch_log.append((generation, slot.index))
        if self._pending_failover is not None and slot is prev:
            # The slot that went down recovered before a survivor took
            # over: no failover happened, and a later rebalance must not
            # count as one.
            self._pending_failover = None
        if self._pending_failover is not None and slot is not prev:
            fo_reason, self._pending_failover = self._pending_failover, None
            self.failovers += 1
            self.telemetry.pool_failover.labels(reason=fo_reason).inc()
            self.telemetry.flightrec.record(
                "pool_failover", reason=fo_reason,
                from_pool=prev.label if prev is not None else None,
                to_pool=slot.label, generation=generation,
            )
            logger.warning(
                "pool failover (%s): %s -> %s", fo_reason,
                prev.label if prev is not None else "<none>", slot.label,
            )

    # ---------------------------------------------------------- events
    async def on_slot_job(self, slot: PoolSlot) -> None:
        """A slot produced (or rebuilt) its current job."""
        if self._stopping:
            return
        if slot is self.active:
            await self._install(slot, "job-update")
        elif self.active is None or not self.active.live:
            # Nothing live owns the dispatcher: this job ends the gap, and
            # completes a pending failover.
            await self._route("failover" if self._pending_failover else "initial")

    async def on_slot_down(self, slot: PoolSlot, reason: str) -> None:
        """A slot lost its session or its liveness. If it owned the
        dispatcher, the next generation targets a survivor, within this
        call when a live slot holds a job."""
        if self._stopping or slot is not self.active:
            return
        self._pending_failover = reason
        await self._route("failover", avoid=slot)

    def owner_of(self, namespaced_job_id: str) -> Optional[PoolSlot]:
        """The slot that announced this namespaced job (None: unknown or
        aged out)."""
        return self._job_owner.get(namespaced_job_id)

    # ---------------------------------------------------------- shares
    async def submit(self, share: Share) -> Optional[str]:
        """Route one dispatcher share back to the pool that owns its job
        and return that slot's verdict. A share no slot owns (its owner
        aged out, or a foreign job id) is dropped, never submitted to
        another pool."""
        owner = self._job_owner.get(share.job_id)
        _prefix, sep, orig = share.job_id.partition("/")
        if owner is None or not sep:
            self.stale_unroutable += 1
            if self.stats is not None:
                self.stats.shares_stale += 1
            self.telemetry.flightrec.record(
                "stale_drop", stage="fabric", job_id=share.job_id,
            )
            return None
        return await owner.submit(dataclasses.replace(share, job_id=orig))

    # -------------------------------------------------------- insights
    def snapshot(self) -> Dict[str, Any]:
        return {
            "active": self.active.label if self.active is not None else None,
            "failovers": self.failovers,
            "stale_unroutable": self.stale_unroutable,
            "weights": self.weights(),
            "slots": [slot.snapshot() for slot in self.slots],
        }


# ------------------------------------------------------------- the miner
class MultipoolMiner:
    """The command line's fabric session: one
    :class:`~.dispatcher.Dispatcher` hashing for a :class:`PoolFabric`,
    with the ``run``/``stop``/``dispatcher``/``accounting`` surface the
    single-pool runners have. The default hasher is the tile kernel on
    the card (``cuda-tile``)."""

    def __init__(
        self,
        specs: List[PoolSpec],
        username: str = "tpu-miner",
        password: str = "x",
        hasher: Optional[Hasher] = None,
        oracle: Optional[Hasher] = None,
        n_workers: int = 8,
        batch_size: int = 1 << 24,
        stream_depth: int = 2,
        scheduler: Optional[Any] = None,
        extranonce2_start: int = 0,
        extranonce2_step: int = 1,
        ntime_roll: int = 0,
        telemetry: Optional[Any] = None,
        **fabric_kwargs: Any,
    ) -> None:
        self.dispatcher = Dispatcher(
            _default_hasher(hasher),
            oracle=oracle,
            n_workers=n_workers,
            batch_size=batch_size,
            stream_depth=stream_depth,
            scheduler=scheduler,
            extranonce2_start=extranonce2_start,
            extranonce2_step=extranonce2_step,
            ntime_roll=ntime_roll,
            telemetry=telemetry,
        )
        self.accounting = ShareAccountant(self.dispatcher.stats)
        self.fabric = PoolFabric(
            specs,
            username=username,
            password=password,
            telemetry=self.dispatcher.telemetry,
            stats=self.dispatcher.stats,
            accounting=self.accounting,
            **fabric_kwargs,
        )
        self.fabric.on_active_job = self._install_job

    def _install_job(self, slot: PoolSlot, job: Job) -> int:
        installed = self.dispatcher.set_job(job)
        # Seeded as StratumMiner seeds it: a session that never produces a
        # share must still grow its expected shares.
        self.accounting.set_difficulty(target_to_difficulty(job.share_target))
        return installed.generation

    async def _on_share(self, share: Share) -> None:
        await self.fabric.submit(share)

    async def run(self) -> None:
        await self.fabric.start()
        try:
            await self.dispatcher.run(self._on_share)
        finally:
            await self.fabric.stop()

    def stop(self) -> None:
        self.fabric._stopping = True
        self.dispatcher.stop()
