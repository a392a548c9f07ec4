"""In-process Stratum v1 pool that validates every share.

It speaks the line-JSON protocol, hands out jobs, and checks each
``mining.submit`` independently: it rebuilds coinbase, merkle root and
header from its own copy of the job and compares sha256d(header) with the
share target through plain ``hashlib``. It shares no code with the
miner's hot path beyond the consensus helpers, so an encoding bug on
either side shows as a reject.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..core.header import merkle_root_from_branch
from ..core.sha256 import sha256d
from ..core.target import difficulty_to_target
from ..miner.job import swap32_words


@dataclass
class PoolJob:
    """The pool's own record of a job it announced."""

    job_id: str
    prevhash_internal: bytes
    coinb1: bytes
    coinb2: bytes
    merkle_branch: List[bytes]
    version: int
    nbits: int
    ntime: int
    clean: bool = True

    def notify_params(self) -> list:
        return [
            self.job_id,
            swap32_words(self.prevhash_internal).hex(),
            self.coinb1.hex(),
            self.coinb2.hex(),
            [h.hex() for h in self.merkle_branch],
            f"{self.version:08x}",
            f"{self.nbits:08x}",
            f"{self.ntime:08x}",
            self.clean,
        ]


@dataclass
class SubmittedShare:
    username: str
    job_id: str
    extranonce2: bytes
    ntime: int
    nonce: int
    accepted: bool
    reason: Optional[str] = None
    #: BIP 310 6th submit param (in-mask version bits), None if absent.
    version_bits: Optional[int] = None


class MockStratumPool:
    """Scripted pool: start(), push jobs and difficulty, inspect shares."""

    def __init__(
        self,
        extranonce1: bytes = bytes.fromhex("deadbeef"),
        extranonce2_size: int = 4,
        difficulty: float = 1.0,
        version_mask: int = 0,
        *,
        authorized_users: Optional[List[str]] = None,
    ) -> None:
        self.extranonce1 = extranonce1
        self.extranonce2_size = extranonce2_size
        self.difficulty = difficulty
        #: BIP 310 mask offered via mining.configure (0 = unsupported).
        self.version_mask = version_mask
        #: the users ``mining.authorize`` accepts (None: everyone).
        self.authorized_users = authorized_users
        self.jobs: Dict[str, PoolJob] = {}
        self.current_job: Optional[PoolJob] = None
        self.shares: List[SubmittedShare] = []
        self.share_seen = asyncio.Event()
        self._server: Optional[asyncio.AbstractServer] = None
        self._clients: List[asyncio.StreamWriter] = []
        self.port: int = 0

    # ------------------------------------------------------------ lifecycle
    async def start(self, host: str = "127.0.0.1", port: int = 0,
                    ssl=None) -> Tuple[str, int]:
        """``ssl``: an ``ssl.SSLContext`` to serve stratum+ssl sessions."""
        self._server = await asyncio.start_server(self._serve, host, port,
                                                  ssl=ssl)
        self.port = self._server.sockets[0].getsockname()[1]
        return host, self.port

    async def stop(self) -> None:
        for w in self._clients:
            w.close()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # ------------------------------------------------------------- scripting
    async def announce_job(self, job: PoolJob) -> None:
        """Record and broadcast a ``mining.notify``."""
        self.jobs[job.job_id] = job
        self.current_job = job
        await self._broadcast("mining.notify", job.notify_params())

    async def set_difficulty(self, difficulty: float) -> None:
        self.difficulty = difficulty
        await self._broadcast("mining.set_difficulty", [difficulty])

    async def _broadcast(self, method: str, params: list) -> None:
        line = json.dumps({"id": None, "method": method, "params": params}) + "\n"
        for w in list(self._clients):
            try:
                w.write(line.encode())
                await w.drain()
            except ConnectionError:
                self._clients.remove(w)

    # ------------------------------------------------------------ per-client
    async def _serve(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        if not await self._accept(writer):
            writer.close()
            return
        self._clients.append(writer)
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError:
                    continue
                reply = self._dispatch(msg)
                if reply is not None:
                    await self._send_reply(writer, reply)
                # Greet a fresh session the way real pools do: difficulty,
                # then the current job, right after authorize.
                if msg.get("method") == "mining.authorize" and self.current_job:
                    await self._broadcast(
                        "mining.set_difficulty", [self.difficulty]
                    )
                    await self._broadcast(
                        "mining.notify", self.current_job.notify_params()
                    )
                if msg.get("method") == "mining.suggest_difficulty":
                    # This pool honours a positive suggestion: it adopts it
                    # and pushes it back, as real pools acknowledge.
                    params = msg.get("params") or []
                    try:
                        suggested = float(params[0])
                    except (IndexError, TypeError, ValueError):
                        suggested = 0.0
                    if suggested > 0:
                        await self.set_difficulty(suggested)
        except ConnectionError:
            pass
        finally:
            if writer in self._clients:
                self._clients.remove(writer)
            writer.close()

    # The seams the fault injector (``testing/chaos_pool.py``) overrides:
    # whether a fresh connection is served, and how (whether) a reply
    # reaches the wire. The base pool always serves and answers.
    async def _accept(self, writer: asyncio.StreamWriter) -> bool:
        return True

    async def _send_reply(self, writer: asyncio.StreamWriter,
                          reply: dict) -> None:
        writer.write((json.dumps(reply) + "\n").encode())
        await writer.drain()

    def _dispatch(self, msg: dict) -> dict:
        method = msg.get("method")
        req_id = msg.get("id")
        params = msg.get("params") or []
        if method == "mining.configure":
            extensions = params[0] if params else []
            if "version-rolling" in extensions and self.version_mask:
                return {"id": req_id, "result": {
                    "version-rolling": True,
                    "version-rolling.mask": f"{self.version_mask:08x}",
                }, "error": None}
            return {"id": req_id, "result": {"version-rolling": False},
                    "error": None}
        if method == "mining.subscribe":
            result = [
                [["mining.set_difficulty", "s1"], ["mining.notify", "s2"]],
                self.extranonce1.hex(),
                self.extranonce2_size,
            ]
            return {"id": req_id, "result": result, "error": None}
        if method == "mining.authorize":
            user = params[0] if params else ""
            ok = self.authorized_users is None or user in self.authorized_users
            return {"id": req_id, "result": ok, "error": None}
        if method == "mining.suggest_difficulty":
            return {"id": req_id, "result": True, "error": None}
        if method == "mining.submit":
            return self._handle_submit(req_id, params)
        return {"id": req_id, "result": None, "error": [20, "unknown method", None]}

    # ------------------------------------------------------------ validation
    def _handle_submit(self, req_id, params: list) -> dict:
        try:
            username, job_id, e2_hex, ntime_hex, nonce_hex = params[:5]
            extranonce2 = bytes.fromhex(e2_hex)
            ntime = int(ntime_hex, 16)
            nonce = int(nonce_hex, 16)
            version_bits = int(params[5], 16) if len(params) > 5 else None
        except (ValueError, TypeError) as e:
            return {"id": req_id, "result": None,
                    "error": [20, f"malformed: {e}", None]}
        accepted, reason = self._validate(
            job_id, extranonce2, ntime, nonce, version_bits
        )
        self.shares.append(
            SubmittedShare(username, job_id, extranonce2, ntime, nonce,
                           accepted, reason, version_bits=version_bits)
        )
        self.share_seen.set()
        if accepted:
            return {"id": req_id, "result": True, "error": None}
        code = 21 if reason == "stale job" else 23
        return {"id": req_id, "result": None, "error": [code, reason, None]}

    def _validate(
        self,
        job_id: str,
        extranonce2: bytes,
        ntime: int,
        nonce: int,
        version_bits: Optional[int] = None,
    ) -> Tuple[bool, Optional[str]]:
        job = self.jobs.get(job_id)
        if job is None:
            return False, "stale job"
        if len(extranonce2) != self.extranonce2_size:
            return False, "bad extranonce2 size"
        version = job.version
        if version_bits is not None:
            if not self.version_mask or version_bits & ~self.version_mask:
                return False, "version bits outside mask"
            version = (job.version & ~self.version_mask) | version_bits
        coinbase = job.coinb1 + self.extranonce1 + extranonce2 + job.coinb2
        merkle = merkle_root_from_branch(sha256d(coinbase), job.merkle_branch)
        header = (
            version.to_bytes(4, "little")
            + job.prevhash_internal
            + merkle
            + ntime.to_bytes(4, "little")
            + job.nbits.to_bytes(4, "little")
            + nonce.to_bytes(4, "little")
        )
        h = int.from_bytes(sha256d(header), "little")
        if h > difficulty_to_target(self.difficulty):
            return False, "low difficulty share"
        return True, None
