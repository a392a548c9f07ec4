"""Stratum v1 client — asyncio TCP line-JSON.

- ``mining.configure``  → BIP 310 version-rolling negotiation (mask)
- ``mining.subscribe``  → extranonce1 + extranonce2_size
- ``mining.authorize``  → worker credentials
- ``mining.suggest_difficulty`` → an optional share difficulty, sent once
  the session is authorized (the pool may answer with
  ``mining.set_difficulty`` or ignore it)
- ``mining.notify``     → new job (clean_jobs ⇒ stale-work flush upstream)
- ``mining.set_difficulty`` → share target for the following jobs
- ``mining.set_extranonce`` / ``mining.set_version_mask`` → mid-session
  changes that rebuild the current job
- ``mining.submit``     → share submission, with the rolled version bits as
  a 6th param when rolling was negotiated
- ``client.reconnect`` / EOF / errors → reconnect with jittered backoff;
  a cross-host ``client.reconnect`` only with ``allow_redirect``
- failover: after ``failover_threshold`` attempts in a row that never
  complete a handshake, the next endpoint of ``failover`` (wrapping back
  to the primary); ``use_tls`` wraps each connection in TLS
  (``stratum+ssl``), verifying the certificate unless ``tls_verify`` is
  off

Requests carry ``id``/``method``/``params``; notifications have ``id:
null``. Responses are matched to requests by id. The client owns no
mining logic: it hands ``StratumJobParams`` and difficulties to callbacks
and submits ``Share``s.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
from typing import (
    TYPE_CHECKING,
    Any,
    Awaitable,
    Callable,
    Dict,
    List,
    Optional,
    Tuple,
)

from ..miner.dispatcher import Share
from ..miner.job import StratumJobParams
from ..utils.backoff import DecorrelatedJitterBackoff

if TYPE_CHECKING:
    import ssl

logger = logging.getLogger(__name__)

OnJob = Callable[[StratumJobParams], Awaitable[None]]
OnDifficulty = Callable[[float], Awaitable[None]]
OnEvent = Callable[[], Awaitable[None]]


class StratumError(Exception):
    """The pool returned an error object for one of our requests."""

    def __init__(self, code: Any, message: str, data: Any = None) -> None:
        super().__init__(f"stratum error {code}: {message}")
        self.code = code
        self.message = message
        self.data = data


def parse_version_mask(value: Any) -> int:
    """BIP 310 masks are hex strings on the wire; some pools send JSON
    numbers, taken verbatim. Anything else disables rolling (mask 0)."""
    if isinstance(value, bool):
        return 0
    if isinstance(value, int):
        return value & 0xFFFFFFFF
    if isinstance(value, str):
        try:
            return int(value, 16) & 0xFFFFFFFF
        except ValueError:
            return 0
    return 0


class StratumClient:
    """One pool connection. ``run`` manages connect/subscribe/authorize and
    the read loop; the owner supplies callbacks and calls
    :meth:`submit_share`."""

    def __init__(
        self,
        host: str,
        port: int,
        username: str,
        password: str = "x",
        on_job: Optional[OnJob] = None,
        on_difficulty: Optional[OnDifficulty] = None,
        on_disconnect: Optional[OnEvent] = None,
        on_extranonce: Optional[OnEvent] = None,
        on_version_mask: Optional[OnEvent] = None,
        on_connect: Optional[OnEvent] = None,
        user_agent: str = "tpu-miner-torch/0.1",
        request_timeout: float = 30.0,
        reconnect_base_delay: float = 1.0,
        reconnect_max_delay: float = 60.0,
        allow_redirect: bool = False,
        suggest_difficulty: Optional[float] = None,
        failover: Optional[List[Tuple[str, int]]] = None,
        failover_threshold: int = 3,
        use_tls: bool = False,
        tls_verify: bool = True,
    ) -> None:
        self.host = host
        self.port = port
        #: the primary, then the backups in order. A pool that connects and
        #: then drops resets the failure count: failover is for dead
        #: endpoints, not flaky sessions.
        self._endpoints: List[Tuple[str, int]] = (
            [(host, port)] + list(failover or []))
        self._endpoint_idx = 0
        self.failover_threshold = failover_threshold
        self._consec_conn_failures = 0
        #: stratum+ssl. Verification is on by default: a man in the middle
        #: of the pool link could redirect the hashrate; ``tls_verify=False``
        #: is the opt-out for self-signed pool certificates.
        self.use_tls = use_tls
        self.tls_verify = tls_verify
        self._tls_ctx: Optional["ssl.SSLContext"] = None
        #: honour a ``client.reconnect`` to another host (off: over a
        #: plaintext link that is the classic hashrate hijack).
        self.allow_redirect = allow_redirect
        #: the difficulty suggested after each authorize (None: none).
        self.suggest_difficulty = suggest_difficulty
        self.on_connect = on_connect
        self.username = username
        self.password = password
        self.on_job = on_job
        self.on_difficulty = on_difficulty
        self.on_disconnect = on_disconnect
        self.on_extranonce = on_extranonce
        self.on_version_mask = on_version_mask
        self.user_agent = user_agent
        self.request_timeout = request_timeout

        self.extranonce1: bytes = b""
        self.extranonce2_size: int = 4
        self.difficulty: float = 1.0
        #: BIP 310 mask negotiated via mining.configure (0 = none).
        self.version_mask: int = 0
        #: the mask asked for: the BIP 320 general-purpose bits 13-28.
        self.version_mask_request: int = 0x1FFFE000
        self.reconnects = 0
        #: set while a session is established (handshake done).
        self.connected = asyncio.Event()

        self._ids = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        self._writer: Optional[asyncio.StreamWriter] = None
        self._stopping = False
        self._session_established = False
        self._backoff = DecorrelatedJitterBackoff(
            reconnect_base_delay, reconnect_max_delay
        )

    @property
    def session_established(self) -> bool:
        """True iff the latest connection attempt completed its handshake
        (subscribe and authorize). The multi-pool fabric's circuit breaker
        reads it in ``on_disconnect`` to tell a refused handshake from an
        ordinary drop."""
        return self._session_established

    # --------------------------------------------------------------- wiring
    async def run(self) -> None:
        """Connect and read until :meth:`stop`, reconnecting with jittered
        backoff."""
        while not self._stopping:
            try:
                await self._connect_and_read()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                if self._stopping:
                    break
                logger.warning(
                    "stratum connection to %s:%d failed (%s); retrying",
                    self.host, self.port, e,
                )
            if self._session_established:
                self._consec_conn_failures = 0
                self._backoff.reset()
            else:
                self._consec_conn_failures += 1
                if (self._consec_conn_failures >= self.failover_threshold
                        and len(self._endpoints) > 1 and not self._stopping):
                    self._endpoint_idx = ((self._endpoint_idx + 1)
                                          % len(self._endpoints))
                    self.host, self.port = self._endpoints[self._endpoint_idx]
                    self._consec_conn_failures = 0
                    # The backoff carries across the rotation: reset per
                    # endpoint, a full outage would retry hot forever.
                    logger.warning("failing over to stratum pool %s:%d",
                                   self.host, self.port)
            self.connected.clear()
            self._fail_pending(ConnectionError("connection lost"))
            if not self._stopping:
                self.reconnects += 1
            if self.on_disconnect is not None:
                await self.on_disconnect()
            if self._stopping:
                break
            await asyncio.sleep(self._backoff.next())

    def stop(self) -> None:
        self._stopping = True
        if self._writer is not None:
            self._writer.close()

    def _ssl_context(self) -> Optional["ssl.SSLContext"]:
        """Built once: the default context reads the CA bundle from disk,
        which the reconnect loop must not repeat."""
        if not self.use_tls:
            return None
        if self._tls_ctx is None:
            import ssl

            ctx = ssl.create_default_context()
            if not self.tls_verify:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            self._tls_ctx = ctx
        return self._tls_ctx

    async def _connect_and_read(self) -> None:
        self._session_established = False
        ctx = self._ssl_context()
        kwargs: Dict[str, Any] = {}
        if ctx is not None:
            # A plaintext endpoint behind a stratum+ssl URL stalls the
            # handshake: bound it by the request timeout, not asyncio's 60 s,
            # or failover waits minutes.
            kwargs = dict(ssl=ctx, ssl_handshake_timeout=min(
                30.0, self.request_timeout))
        reader, writer = await asyncio.open_connection(self.host, self.port,
                                                       **kwargs)
        self._writer = writer
        logger.info("connected to stratum pool %s:%d", self.host, self.port)
        # The read loop runs during the handshake: subscribe and authorize
        # wait on responses it delivers.
        read_task = asyncio.create_task(self._read_loop(reader))
        try:
            await self._handshake()
            self._session_established = True
            self.connected.set()
            if self.on_connect is not None:
                await self.on_connect()
            await read_task  # raises ConnectionError on EOF
        finally:
            read_task.cancel()
            await asyncio.gather(read_task, return_exceptions=True)
            self.connected.clear()
            writer.close()
            self._writer = None

    async def _read_loop(self, reader: asyncio.StreamReader) -> None:
        while True:
            line = await reader.readline()
            if not line:
                raise ConnectionError("pool closed connection")
            await self._handle_line(line)

    async def _handshake(self) -> None:
        # BIP 310: mining.configure must be the session's first request.
        # Pools without it answer with an error or nothing; both leave the
        # mask at 0. A short timeout keeps silent pools from stalling.
        self.version_mask = 0
        try:
            conf = await self._request(
                "mining.configure",
                [
                    ["version-rolling"],
                    {
                        "version-rolling.mask":
                            f"{self.version_mask_request:08x}",
                        "version-rolling.min-bit-count": 2,
                    },
                ],
                timeout=min(5.0, self.request_timeout),
            )
            if isinstance(conf, dict) and conf.get("version-rolling"):
                self.version_mask = (
                    parse_version_mask(conf.get("version-rolling.mask", 0))
                    & self.version_mask_request
                )
        except (asyncio.TimeoutError, StratumError) as e:
            logger.debug("mining.configure not supported: %s", e)
        if self.version_mask:
            logger.info("version rolling negotiated: mask=%08x",
                        self.version_mask)
        sub = await self._request("mining.subscribe", [self.user_agent])
        # Result: [subscriptions, extranonce1_hex, extranonce2_size]
        try:
            self.extranonce1 = bytes.fromhex(sub[1])
            self.extranonce2_size = int(sub[2])
        except (IndexError, TypeError, ValueError) as e:
            raise StratumError(None, f"malformed subscribe result: {sub!r}") from e
        authed = await self._request(
            "mining.authorize", [self.username, self.password]
        )
        if not authed:
            raise StratumError(None, f"authorization rejected for {self.username}")
        logger.info(
            "subscribed: extranonce1=%s extranonce2_size=%d; authorized as %s",
            self.extranonce1.hex(), self.extranonce2_size, self.username,
        )
        if self.suggest_difficulty is not None:
            await self._send_fire_and_forget("mining.suggest_difficulty",
                                             [self.suggest_difficulty])

    async def _send_fire_and_forget(self, method: str, params: list) -> None:
        """Send a request without waiting for its reply: pools answer an
        optional extension with an error, a push, or nothing, and waiting
        would stall every (re)connect on the silent ones. A reply lands in
        the unknown-id path."""
        if self._writer is None:
            raise ConnectionError("not connected")
        self._writer.write((json.dumps(
            {"id": next(self._ids), "method": method, "params": params}
        ) + "\n").encode())
        await self._writer.drain()

    # ------------------------------------------------------------ requests
    async def _request(
        self, method: str, params: list, timeout: Optional[float] = None
    ) -> Any:
        if self._writer is None:
            raise ConnectionError("not connected")
        req_id = next(self._ids)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        payload = json.dumps(
            {"id": req_id, "method": method, "params": params}
        ) + "\n"
        self._writer.write(payload.encode())
        await self._writer.drain()
        try:
            return await asyncio.wait_for(
                fut, timeout if timeout is not None else self.request_timeout
            )
        finally:
            self._pending.pop(req_id, None)

    def _fail_pending(self, exc: Exception) -> None:
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(exc)
        self._pending.clear()

    # ------------------------------------------------------------ read path
    async def _handle_line(self, line: bytes) -> None:
        try:
            msg = json.loads(line)
        except json.JSONDecodeError:
            logger.warning("dropping malformed stratum line: %r", line[:200])
            return
        if not isinstance(msg, dict):
            logger.warning("dropping non-object stratum line: %r", line[:200])
            return
        if msg.get("method"):
            await self._handle_notification(msg)
            return
        fut = self._pending.get(msg.get("id"))
        if fut is None or fut.done():
            logger.debug("response for unknown id: %r", msg)
            return
        err = msg.get("error")
        if err:
            if isinstance(err, list):  # classic [code, message, data]
                code, message, data = (list(err) + [None] * 3)[:3]
            else:
                code, message, data = None, str(err), None
            fut.set_exception(StratumError(code, str(message), data))
        else:
            fut.set_result(msg.get("result"))

    async def _handle_notification(self, msg: dict) -> None:
        method = msg["method"]
        params = msg.get("params") or []
        if method == "mining.notify":
            try:
                job = StratumJobParams.from_notify(params)
            except ValueError as e:
                logger.warning("bad mining.notify: %s", e)
                return
            if self.on_job is not None:
                await self.on_job(job)
        elif method == "mining.set_difficulty":
            try:
                difficulty = float(params[0])
            except (IndexError, TypeError, ValueError):
                logger.warning("bad mining.set_difficulty: %r", params)
                return
            if difficulty <= 0:
                logger.warning("bad mining.set_difficulty: %r", params)
                return
            self.difficulty = difficulty
            if self.on_difficulty is not None:
                await self.on_difficulty(self.difficulty)
        elif method == "mining.set_extranonce":
            try:
                # Parse both fields before assigning either.
                extranonce1 = bytes.fromhex(params[0])
                extranonce2_size = int(params[1])
            except (IndexError, TypeError, ValueError):
                logger.warning("bad mining.set_extranonce: %r", params)
                return
            self.extranonce1 = extranonce1
            self.extranonce2_size = extranonce2_size
            if self.on_extranonce is not None:
                await self.on_extranonce()
        elif method == "mining.set_version_mask":
            try:
                mask = parse_version_mask(params[0])
            except (IndexError, TypeError):
                logger.warning("bad mining.set_version_mask: %r", params)
                return
            self.version_mask = mask & self.version_mask_request
            if self.on_version_mask is not None:
                await self.on_version_mask()
        elif method == "client.reconnect":
            # Same-host moves are routine load shedding; a move to another
            # host over the plaintext link is the classic hashrate hijack,
            # honoured only with ``allow_redirect``.
            host = params[0] if len(params) > 0 and params[0] else self.host
            port = params[1] if len(params) > 1 and params[1] else self.port
            if host != self.host and not self.allow_redirect:
                logger.warning("ignoring client.reconnect to foreign host "
                               "%s:%s (allow_redirect is off)", host, port)
                return
            try:
                port = int(port)
            except (TypeError, ValueError):
                logger.warning("bad client.reconnect: %r", params)
                return
            logger.info("pool requested reconnect to %s:%d", host, port)
            self.host, self.port = host, port
            if self._writer is not None:
                self._writer.close()  # the read loop exits; run() reconnects
        else:
            logger.debug("unhandled stratum notification %s %r", method, params)

    # -------------------------------------------------------------- submit
    async def submit_share(self, share: Share) -> bool:
        """``mining.submit``: True iff the pool accepted. Raises
        :class:`StratumError` for protocol-level rejects (e.g. stale)."""
        params = [
            self.username,
            share.job_id,
            share.extranonce2.hex(),
            f"{share.ntime:08x}",
            f"{share.nonce:08x}",
        ]
        if share.version_bits is not None:
            params.append(f"{share.version_bits:08x}")
        return bool(await self._request("mining.submit", params))
