"""Stratum v1 client — asyncio TCP line-JSON.

- ``mining.configure``  → BIP 310 version-rolling negotiation (mask)
- ``mining.subscribe``  → extranonce1 + extranonce2_size
- ``mining.authorize``  → worker credentials
- ``mining.notify``     → new job (clean_jobs ⇒ stale-work flush upstream)
- ``mining.set_difficulty`` → share target for the following jobs
- ``mining.set_extranonce`` / ``mining.set_version_mask`` → mid-session
  changes that rebuild the current job
- ``mining.submit``     → share submission, with the rolled version bits as
  a 6th param when rolling was negotiated
- ``client.reconnect`` / EOF / errors → reconnect with jittered backoff

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
from typing import Any, Awaitable, Callable, Dict, Optional

from ..miner.dispatcher import Share
from ..miner.job import StratumJobParams
from ..utils.backoff import DecorrelatedJitterBackoff

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
        user_agent: str = "tpu-miner-torch/0.1",
        request_timeout: float = 30.0,
        reconnect_base_delay: float = 1.0,
        reconnect_max_delay: float = 60.0,
    ) -> None:
        self.host = host
        self.port = port
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

        self._ids = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        self._writer: Optional[asyncio.StreamWriter] = None
        self._stopping = False
        self._session_established = False
        self._backoff = DecorrelatedJitterBackoff(
            reconnect_base_delay, reconnect_max_delay
        )

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
                self._backoff.reset()
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

    async def _connect_and_read(self) -> None:
        self._session_established = False
        reader, writer = await asyncio.open_connection(self.host, self.port)
        self._writer = writer
        logger.info("connected to stratum pool %s:%d", self.host, self.port)
        # The read loop runs during the handshake: subscribe and authorize
        # wait on responses it delivers.
        read_task = asyncio.create_task(self._read_loop(reader))
        try:
            await self._handshake()
            self._session_established = True
            await read_task  # raises ConnectionError on EOF
        finally:
            read_task.cancel()
            await asyncio.gather(read_task, return_exceptions=True)
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
            # Same-host moves only: a redirect to another host over the
            # plaintext link is the classic hashrate-hijack vector.
            host = params[0] if len(params) > 0 and params[0] else self.host
            port = params[1] if len(params) > 1 and params[1] else self.port
            if host != self.host:
                logger.warning("ignoring client.reconnect to foreign host "
                               "%s:%s", host, port)
                return
            try:
                self.port = int(port)
            except (TypeError, ValueError):
                logger.warning("bad client.reconnect: %r", params)
                return
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
