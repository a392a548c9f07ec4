"""The Stratum v1 server of the pool frontend.

Counterpart of ``bitcoin_miner_tpu/poolserver/server.py``: an asyncio
line-JSON listener serving downstream miners as ``testing/mock_pool.py``
(the method handling) and ``protocol/stratum.py`` (the framing) define
the protocol — ``mining.subscribe`` / ``authorize`` / ``submit``
requests, ``set_difficulty`` / ``notify`` pushes — with what serving
for real needs:

- **space partition**: each session's ``extranonce1`` is the server's
  base plus a unique prefix (``space.py``), taken back on disconnect, so
  client spaces are disjoint; the internal worker takes its slice from
  the same allocator;
- **independent validation**: every ``mining.submit`` is rebuilt
  coinbase → merkle → header and held against the session target on the
  CPU, by the hashlib oracle or the native library's one-call validator
  (the same verdicts), sharing no code with a device backend, so a
  kernel fault shows as a reject;
- **per-client metering**: malformed frames, junk and duplicate shares
  and slow handshakes are counted per session, degrade the ``frontend``
  health component and disconnect past their budgets;
- **observability**: session churn and invalid shares go to the flight
  recorder, sessions, verdicts, broadcast and validation times to the
  metric families, and each session's difficulty-weighted accounting to
  a :class:`~..telemetry.shareacct.ShareAccountant`.

Sessions walk one state machine::

    connected ──subscribe──▶ subscribed ──authorize──▶ active ──▶ closed
        │  (pre-auth deadline: reach `active` or be dropped)       ▲
        └────────── malformed/oversized-line budget ───────────────┘

The listener never waits on a slow client: pushes are synchronous
transport writes bounded by each session's unread backlog (a wedged
socket is dropped, not drained), and work spawned off a read loop is
tracked and cancelled on disconnect.
"""

# miner-lint: import-safe

from __future__ import annotations

import asyncio
import itertools
import json
import logging
import time
from typing import Awaitable, Callable, Dict, List, Optional, Set, Tuple

from ..core.header import merkle_root_from_branch
from ..core.target import difficulty_to_target
from ..telemetry import get_telemetry
from ..telemetry.lifecycle import share_key as _share_key
from ..telemetry.shareacct import WORK_PER_DIFF1, ShareAccountant
from .jobs import FrontendJob, encode_line as _encode_line
from .space import PrefixAllocator, SpaceExhausted

logger = logging.getLogger(__name__)

#: A tiny difficulty gives a target above 2^256 − 1, which the native
#: validator's 32-byte target cannot hold. Clamping keeps every verdict:
#: each digest h is < 2^256, so h ≤ min(target, 2^256 − 1) ⟺ h ≤ target.
_MAX_TARGET256 = (1 << 256) - 1

#: Stratum error codes, the dialect the client parses: 20 other, 21
#: stale, 22 duplicate, 23 low difficulty, 24 unauthorized, 25 not
#: subscribed.
E_OTHER, E_STALE, E_DUP, E_LOWDIFF, E_UNAUTH, E_NOSUB = 20, 21, 22, 23, 24, 25

#: verdict → the error code of its reject.
_REJECT_CODES = {
    "stale": E_STALE,
    "duplicate": E_DUP,
    "low_difficulty": E_LOWDIFF,
    "malformed": E_OTHER,
    "version_bits": E_OTHER,
    "bad_extranonce2": E_OTHER,
}

#: Pre-encoded submit replies: the submit path answers with one
#: ``bytes % int``, byte for byte what ``_encode_line`` gives for the same
#: reply. Only submits with a plain int id take them; the internal worker
#: reads its replies as dicts.
_ACCEPT_TMPL = b'{"id":%d,"result":true,"error":null}\n'
_REJECT_TMPLS = {
    verdict: b'{"id":%%d,"result":null,"error":[%d,"%s",null]}\n'
    % (code, verdict.replace("_", " ").encode())
    for verdict, code in _REJECT_CODES.items()
}

#: The sessions' accountants share one no-op bundle: each does its math
#: without writing the process-wide efficiency gauge (the frontend
#: exports aggregate series itself).
_session_null_telemetry = None


def _null_telemetry():
    global _session_null_telemetry
    if _session_null_telemetry is None:
        from ..telemetry.pipeline import NullTelemetry

        _session_null_telemetry = NullTelemetry()
    return _session_null_telemetry


class _ClaimedWork:
    """The stats behind a session's :class:`ShareAccountant`: its hashes
    are the work the session's submits claim (a share at difficulty d
    claims d·2^32), so the accountant's efficiency reads as the
    difficulty-weighted accepted fraction: ~1 for an honest miner, < 1
    for a junk-share fleet."""

    def __init__(self) -> None:
        self.hashes = 0.0

    def claim(self, difficulty: float) -> None:
        self.hashes += difficulty * WORK_PER_DIFF1

    def device_hashrate(self) -> float:
        return 0.0


class ClientSession:
    """One downstream connection's state (the internal worker's has
    ``writer=None``)."""

    def __init__(
        self,
        conn_id: int,
        peer: str,
        writer: Optional[asyncio.StreamWriter],
    ) -> None:
        self.conn_id = conn_id
        self.peer = peer
        self.writer = writer
        self.subscribed = False
        self.username: Optional[str] = None  # set on authorize
        self.prefix: Optional[int] = None
        self.extranonce1: bytes = b""
        self.extranonce2_size: int = 0
        self.difficulty: float = 1.0
        self.connected_at = time.monotonic()
        #: vardiff window anchor: (monotonic t, claimed work at t); None
        #: until the first submit starts the clock.
        self.vardiff_anchor: Optional[Tuple[float, float]] = None
        self.accepted = 0
        self.invalid = 0  # every verdict but accepted
        self.consecutive_invalid = 0
        self.malformed = 0
        #: (job_id, extranonce2, ntime, nonce, version_bits) accepted so
        #: far, against duplicates; cleared on every clean job (older
        #: entries can only verdict stale).
        self.seen_shares: Set[Tuple] = set()
        #: tasks of this connection (accept-hook forwards), cancelled on
        #: disconnect.
        self.tasks: Set[asyncio.Task] = set()
        #: native validation constants, job_id → (extranonce1, mid8,
        #: absorbed, coinbase-prefix remainder, merkle branch blob, branch
        #: count, header prefix36). The midstate covers ``coinb1 ‖
        #: extranonce1``, fixed per (session, job); entry[0] pins the
        #: extranonce1 it was folded over, so a re-based session rebuilds
        #: it. Pruned against the server's job window on insert.
        self.fastpath: Dict[str, tuple] = {}
        #: (difficulty, int target, 32-byte clamped big-endian target),
        #: rebuilt when the session difficulty moves.
        self.target_cache: Optional[Tuple[float, int, bytes]] = None
        self.work = _ClaimedWork()
        self.accounting = ShareAccountant(
            self.work, telemetry=_null_telemetry()
        )

    @property
    def active(self) -> bool:
        return self.subscribed and self.username is not None

    @property
    def internal(self) -> bool:
        return self.writer is None

    def spawn(self, coro: "Awaitable[None]", name: str) -> asyncio.Task:
        task = asyncio.get_running_loop().create_task(coro, name=name)
        self.tasks.add(task)
        task.add_done_callback(self.tasks.discard)
        return task

    def snapshot(self) -> Dict:
        acct = self.accounting.snapshot()
        return {
            "conn_id": self.conn_id,
            "peer": self.peer,
            "internal": self.internal,
            "username": self.username,
            "extranonce1": self.extranonce1.hex(),
            "extranonce2_size": self.extranonce2_size,
            "difficulty": self.difficulty,
            "accepted": self.accepted,
            "invalid": self.invalid,
            "malformed": self.malformed,
            "claimed_work": acct["hashes"],
            "efficiency": acct["efficiency"],
        }


OnShareAccepted = Callable[..., Awaitable[None]]


class StratumPoolServer:
    """The downstream-facing Stratum v1 server."""

    def __init__(
        self,
        *,
        extranonce1_base: bytes = bytes.fromhex("f00d"),
        extranonce2_size: int = 4,
        prefix_bytes: int = 2,
        difficulty: float = 1.0,
        min_difficulty: Optional[float] = None,
        telemetry=None,
        pre_auth_timeout_s: float = 10.0,
        max_line_bytes: int = 16 * 1024,
        malformed_budget: int = 5,
        invalid_share_budget: int = 50,
        jobs_kept: int = 4,
        max_push_backlog: int = 256 * 1024,
        vardiff_interval_s: float = 0.0,
        vardiff_target_spm: float = 6.0,
        vardiff_max_step: float = 4.0,
        allocator: Optional[PrefixAllocator] = None,
        native_validation: Optional[bool] = None,
    ) -> None:
        """``extranonce1_base`` and ``extranonce2_size`` describe the
        whole space the server owns (proxy mode re-bases them from the
        upstream, :meth:`rebase_extranonce`); each session gets
        ``prefix_bytes`` of the extranonce2 side. An explicit
        ``allocator`` (of the same ``prefix_bytes``) serves a sub-range
        of the prefix space (``PrefixAllocator.partition``).

        ``native_validation`` chooses the submit validator: None probes
        (the native library's one-call validator when it loads or
        builds, else the hashlib oracle), False forces the oracle, True
        requires the native one and raises ``OSError`` when the library
        cannot be built. Both give the same verdicts; the native one only
        makes a submit cheaper. Which is in force is logged."""
        if extranonce2_size - prefix_bytes < 1:
            raise ValueError(
                "extranonce2_size must leave >= 1 byte after the "
                f"per-session prefix ({prefix_bytes} bytes)"
            )
        if allocator is not None and allocator.prefix_bytes != prefix_bytes:
            raise ValueError(
                f"allocator prefix_bytes {allocator.prefix_bytes} != "
                f"server prefix_bytes {prefix_bytes}"
            )
        from ..backends.cpu import CpuHasher

        #: the hashlib validator's hasher.
        self.oracle = CpuHasher()
        self.extranonce1_base = extranonce1_base
        self.total_extranonce2_size = extranonce2_size
        self.allocator = (
            allocator if allocator is not None
            else PrefixAllocator(prefix_bytes)
        )
        self.difficulty = difficulty
        #: floor of client-suggested difficulties. A suggestion below the
        #: difficulty in force would give a client a target where junk
        #: submits validate, so the floor tracks the server difficulty
        #: (upstream retargets included, :meth:`set_difficulty`):
        #: suggestions only make shares harder. ``min_difficulty`` pins it.
        self._min_difficulty_pinned = min_difficulty is not None
        self.min_difficulty = (
            min_difficulty if min_difficulty is not None else difficulty
        )
        self.telemetry = telemetry if telemetry is not None else get_telemetry()
        self.pre_auth_timeout_s = pre_auth_timeout_s
        self.max_line_bytes = max_line_bytes
        self.malformed_budget = malformed_budget
        self.invalid_share_budget = invalid_share_budget
        self.jobs_kept = jobs_kept
        #: unread push bytes a session may pile up before it is dropped as
        #: wedged (:meth:`_push`).
        self.max_push_backlog = max_push_backlog
        #: per-session vardiff, off at 0: each session is retargeted every
        #: ``vardiff_interval_s`` from its own claimed-work rate (its
        #: hashrate × the target share interval 60/``vardiff_target_spm``
        #: ÷ 2^32), by at most ×/÷ ``vardiff_max_step`` a retarget and
        #: never below ``min_difficulty``. A suggested difficulty is then
        #: only the session's starting point.
        self.vardiff_interval_s = vardiff_interval_s
        self.vardiff_target_spm = vardiff_target_spm
        self.vardiff_max_step = max(1.0 + 1e-9, vardiff_max_step)
        #: difficulty-weighted work the downstream fleet claimed and the
        #: work its accepted shares carried, over all sessions, as plain
        #: floats (the submit path pays no labeled lookup for them); the
        #: SLO engine's ``frontend-claimed-work`` objective reads them.
        self.claimed_work = 0.0
        self.accepted_work = 0.0
        self.submits = 0
        #: verdict → its counter child, resolved once per verdict.
        self._verdict_counters: Dict[str, object] = {}
        #: recent jobs by id, newest last (bounded: a submit of an evicted
        #: job is stale, as with a real pool's short memory).
        self.jobs: "Dict[str, FrontendJob]" = {}
        self.current_job: Optional[FrontendJob] = None
        self.sessions: Dict[int, ClientSession] = {}
        #: sessions that are not internal, kept as a count (a sum over
        #: ``sessions`` per read made the connect ramp quadratic).
        self._downstream = 0
        #: the current ``mining.set_difficulty`` push, encoded once per
        #: retarget.
        self._difficulty_line: bytes = _encode_line({
            "id": None, "method": "mining.set_difficulty",
            "params": [difficulty],
        })
        self.native_validation = native_validation
        self._native_mod = None
        self._native_validate: Optional[object] = None
        self._native_digest: Optional[object] = None
        self._validate_impl = self._validate
        if native_validation is not False:
            try:
                from ..backends import native as _native

                self._native_validate, self._native_digest = (
                    _native.validator_handles()
                )
                self._native_mod = _native
                self._validate_impl = self._validate_native
                logger.info(
                    "native share validation active (backend: %s)",
                    _native.backend_name(),
                )
            except OSError as e:
                if native_validation:
                    raise OSError(
                        f"native_validation=True but {e}"
                    ) from e
                logger.info(
                    "native share validation unavailable (%s); "
                    "using hashlib oracle", e,
                )
        #: proxy hook, awaited as a tracked session task for every
        #: accepted share with (session, job, extranonce2, ntime, nonce,
        #: version_bits, hash_int).
        self.on_share_accepted: Optional[OnShareAccepted] = None
        #: called on every installed job (the internal worker re-targets
        #: its dispatcher here).
        self.job_listeners: List[Callable[[FrontendJob], None]] = []
        self._ids = itertools.count(1)
        self._server: Optional[asyncio.AbstractServer] = None
        self.port: int = 0
        self._stopping = False

    @property
    def native_active(self) -> bool:
        """Whether the native validator is in force."""
        return self._validate_impl == self._validate_native

    # ------------------------------------------------------------ lifecycle
    async def start(
        self, host: str = "127.0.0.1", port: int = 0,
        reuse_port: bool = False,
    ) -> Tuple[str, int]:
        """Bind and serve. ``reuse_port`` sets ``SO_REUSEPORT``, so that
        several acceptor processes bind the same port and the kernel
        spreads incoming connections over them (the sharded frontend,
        ``shard.py``; Linux semantics)."""
        self._server = await asyncio.start_server(
            self._serve, host, port, limit=self.max_line_bytes,
            reuse_port=reuse_port or None,
        )
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("pool frontend listening on %s:%d", host, self.port)
        return host, self.port

    async def stop(self) -> None:
        self._stopping = True
        for session in list(self.sessions.values()):
            for task in list(session.tasks):
                task.cancel()
            if session.writer is not None:
                session.writer.close()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def rebase_extranonce(
        self, extranonce1: bytes, extranonce2_size: int
    ) -> None:
        """Proxy mode: adopt the upstream session's extranonce geometry
        and re-carve every live session onto it (prefixes kept, the base
        under them changed). Without it, sessions subscribed before the
        upstream (re)connected, the internal worker always among them,
        would mine the dead base and have their shares forwarded
        mis-sliced. Downstream sessions learn it by a
        ``mining.set_extranonce`` push; the job listeners re-fire on the
        ``set_job`` that follows in proxy mode."""
        if (extranonce1 == self.extranonce1_base
                and extranonce2_size == self.total_extranonce2_size):
            return
        if extranonce2_size - self.allocator.prefix_bytes < 1:
            raise ValueError(
                f"upstream extranonce2_size {extranonce2_size} too small "
                f"for a {self.allocator.prefix_bytes}-byte session prefix"
            )
        logger.info(
            "rebasing extranonce space: e1=%s e2_size=%d",
            extranonce1.hex(), extranonce2_size,
        )
        self.extranonce1_base = extranonce1
        self.total_extranonce2_size = extranonce2_size
        for session in list(self.sessions.values()):
            if session.prefix is None:
                continue
            session.extranonce1 = (
                extranonce1 + self.allocator.encode(session.prefix)
            )
            session.extranonce2_size = self.session_extranonce2_size
            # Shares of the old space can only be stale or invalid now,
            # and every cached midstate was folded over the old
            # extranonce1.
            session.seen_shares.clear()
            session.fastpath.clear()
            if session.active and session.writer is not None:
                self._send(session, {
                    "id": None, "method": "mining.set_extranonce",
                    "params": [session.extranonce1.hex(),
                               session.extranonce2_size],
                })

    @property
    def session_extranonce2_size(self) -> int:
        return self.total_extranonce2_size - self.allocator.prefix_bytes

    @property
    def downstream_sessions(self) -> int:
        return self._downstream

    # ------------------------------------------------------------ job feed
    async def set_job(self, job: FrontendJob) -> None:
        """Install and broadcast a job. A clean job clears the sessions'
        duplicate memory; evicted jobs are dropped."""
        self.jobs[job.job_id] = job
        while len(self.jobs) > self.jobs_kept:
            self.jobs.pop(next(iter(self.jobs)))
        self.current_job = job
        if job.clean:
            for session in self.sessions.values():
                session.seen_shares.clear()
        self.telemetry.lifecycle.note_job(
            job.job_id, clean=bool(job.clean),
            sessions=self.downstream_sessions,
        )
        self.telemetry.flightrec.record(
            "frontend_job", job_id=job.job_id, clean=bool(job.clean),
            sessions=self.downstream_sessions,
        )
        for listener in self.job_listeners:
            listener(job)
        # The notify line is encoded once per job (cached on it), never
        # per session.
        if "notify_line" not in job.__dict__:
            self.telemetry.frontend_broadcast_encodes.inc()
        await self._broadcast_line(job.notify_line, timed=True)

    async def set_difficulty(self, difficulty: float) -> None:
        if difficulty <= 0:
            raise ValueError("difficulty must be positive")
        self.difficulty = difficulty
        if not self._min_difficulty_pinned:
            self.min_difficulty = difficulty
        for session in self.sessions.values():
            session.difficulty = difficulty
            session.accounting.set_difficulty(difficulty)
        if self.current_job is not None:
            # The internal worker's share target comes from its session's
            # difficulty: re-install the current job so it follows (its
            # dispatcher resumes the sweep position).
            for listener in self.job_listeners:
                listener(self.current_job)
        self._difficulty_line = _encode_line({
            "id": None, "method": "mining.set_difficulty",
            "params": [difficulty],
        })
        self.telemetry.frontend_broadcast_encodes.inc()
        await self._broadcast_line(self._difficulty_line)

    async def _broadcast(
        self, method: str, params: list, timed: bool = False
    ) -> None:
        """Encode and fan out any push (the job and difficulty pushes go
        through their cached lines)."""
        self.telemetry.frontend_broadcast_encodes.inc()
        await self._broadcast_line(
            _encode_line({"id": None, "method": method, "params": params}),
            timed=timed,
        )

    async def _broadcast_line(
        self, line: bytes, timed: bool = False
    ) -> None:
        t0 = time.perf_counter()
        # The same bytes to every transport, written without waiting on
        # any client (_push), so one stuck socket delays no one else.
        for session in list(self.sessions.values()):
            if session.active:
                self._push(session, line)
        if timed:
            self.telemetry.frontend_job_broadcast.observe(
                time.perf_counter() - t0
            )

    # miner-lint: sync-hot-path
    def _push(self, session: ClientSession, line: bytes) -> None:
        """Write one line to a session without awaiting: the transport
        buffers it, and a session whose unread backlog passes
        ``max_push_backlog`` is dropped as wedged. No ``drain()``: awaiting
        each client's drain would serialize the fan-out behind the
        slowest socket, and a ``wait_for(drain)`` swallows a cancellation
        landing as the drain completes."""
        writer = session.writer
        if writer is None:
            return
        try:
            writer.write(line)
            if (writer.transport.get_write_buffer_size()
                    > self.max_push_backlog):
                logger.info(
                    "dropping wedged session %s (%d B of unread pushes)",
                    session.peer,
                    writer.transport.get_write_buffer_size(),
                )
                writer.close()
        except (ConnectionError, RuntimeError):
            writer.close()

    def _greet(self, session: ClientSession) -> None:
        """The pushes after authorize: the difficulty in force, then the
        current job, from their cached lines."""
        session.difficulty = self.difficulty
        session.accounting.set_difficulty(self.difficulty)
        self._push(session, self._difficulty_line)
        job = self.current_job
        if job is not None:
            if "notify_line" not in job.__dict__:
                self.telemetry.frontend_broadcast_encodes.inc()
            self._push(session, job.notify_line)

    # ------------------------------------------------------------ sessions
    async def _serve(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        peername = writer.get_extra_info("peername")
        peer = (f"{peername[0]}:{peername[1]}"
                if isinstance(peername, tuple) else str(peername))
        session = ClientSession(next(self._ids), peer, writer)
        if self._stopping:
            writer.close()
            return
        self.sessions[session.conn_id] = session
        self._downstream += 1
        self.telemetry.frontend_sessions.set(self._downstream)
        self.telemetry.flightrec.record(
            "frontend_session", action="open", peer=peer,
            conn_id=session.conn_id, sessions=self.downstream_sessions,
        )
        loop = asyncio.get_running_loop()
        # A connection must reach `active` before the deadline or be
        # dropped: idle pre-auth sockets are the cheapest way to exhaust
        # a listener.
        deadline = loop.call_later(
            self.pre_auth_timeout_s,
            lambda: None if session.active else writer.close(),
        )
        # Reply coalescing: a pipelined burst arrives as one segment of
        # several lines. Replies gather in `out` while the reader holds
        # another whole line, and go out as one write before the loop
        # would block (readline on an empty buffer, the only await here),
        # so a session's replies never interleave with a broadcast.
        rbuf = getattr(reader, "_buffer", None)  # CPython streams detail
        out: List[bytes] = []
        try:
            while True:
                if out and not (rbuf is not None and b"\n" in rbuf):
                    self._push(session, out[0] if len(out) == 1
                               else b"".join(out))
                    out.clear()
                try:
                    line = await reader.readline()
                except ValueError:
                    # A line past the reader's limit: the rest of the
                    # buffer is the same frame, so the session ends.
                    self._count_malformed(session, "oversized line")
                    break
                if not line:
                    break
                if not line.strip():
                    continue
                try:
                    msg = json.loads(line)
                    if not isinstance(msg, dict):
                        raise ValueError("not an object")
                except (json.JSONDecodeError, ValueError):
                    if not self._count_malformed(session, "bad json"):
                        break
                    continue
                reply = self._dispatch(session, msg)
                if reply is not None:
                    out.append(reply if type(reply) is bytes
                               else _encode_line(reply))
                if (msg.get("method") == "mining.authorize"
                        and session.active):
                    # The authorize result goes out before the greet.
                    if out:
                        self._push(session, b"".join(out))
                        out.clear()
                    self._greet(session)
                if session.malformed > self.malformed_budget or (
                    session.consecutive_invalid
                    > self.invalid_share_budget
                ):
                    logger.info(
                        "dropping session %s: over budget "
                        "(malformed=%d consecutive_invalid=%d)",
                        peer, session.malformed,
                        session.consecutive_invalid,
                    )
                    break
        except ConnectionError:
            pass
        finally:
            if out:  # replies gathered before the line that ended it
                self._push(session, b"".join(out))
            deadline.cancel()
            self._close_session(session)

    def _close_session(self, session: ClientSession) -> None:
        for task in list(session.tasks):
            task.cancel()
        if session.prefix is not None:
            self.allocator.release(session.prefix)
            session.prefix = None
        # Idempotent: the serve loop's finally and a stop can both call it.
        if (self.sessions.pop(session.conn_id, None) is not None
                and not session.internal):
            self._downstream -= 1
        if session.writer is not None:
            session.writer.close()
        self.telemetry.frontend_sessions.set(self._downstream)
        self.telemetry.flightrec.record(
            "frontend_session", action="close", peer=session.peer,
            conn_id=session.conn_id, accepted=session.accepted,
            invalid=session.invalid, sessions=self.downstream_sessions,
        )

    def _count_malformed(self, session: ClientSession, why: str) -> bool:
        """Count one malformed frame; False when the session is now over
        its budget (the caller disconnects it)."""
        session.malformed += 1
        self.telemetry.frontend_shares.labels(result="malformed").inc()
        self.telemetry.flightrec.record(
            "frontend_invalid_share", reason=f"malformed: {why}",
            peer=session.peer, conn_id=session.conn_id,
        )
        return session.malformed <= self.malformed_budget

    def _send(self, session: ClientSession, obj) -> None:
        """``obj``: a reply dict, or already-encoded bytes."""
        self._push(
            session, obj if type(obj) is bytes else _encode_line(obj)
        )

    # ------------------------------------------------------------ dispatch
    # miner-lint: sync-hot-path
    def _dispatch(
        self, session: ClientSession, msg: dict
    ):
        """A reply dict, pre-encoded bytes (a submit) or None. No handler
        suspends, so ``_serve`` takes a whole pipelined burst in one task
        step."""
        method = msg.get("method")
        req_id = msg.get("id")
        params = msg.get("params") or []
        if not isinstance(params, list):
            params = []
        if method == "mining.configure":
            # Version rolling is not granted downstream (BIP 310: a
            # decline is not an error).
            return {"id": req_id, "result": {"version-rolling": False},
                    "error": None}
        if method == "mining.subscribe":
            return self._handle_subscribe(session, req_id)
        if method == "mining.authorize":
            user = str(params[0]) if params else ""
            ok = session.subscribed
            if ok:
                session.username = user
            err = None if ok else [E_NOSUB, "subscribe first", None]
            return {"id": req_id, "result": ok, "error": err}
        if method == "mining.suggest_difficulty":
            # Honoured per session, clamped to min_difficulty: an easy
            # suggestion would give a target where every junk submit
            # validates, around the invalid-share budget.
            try:
                suggested = float(params[0])
            except (IndexError, TypeError, ValueError):
                suggested = 0.0
            if suggested > 0:
                suggested = max(suggested, self.min_difficulty)
                session.difficulty = suggested
                session.accounting.set_difficulty(suggested)
                self._send(session, {
                    "id": None, "method": "mining.set_difficulty",
                    "params": [session.difficulty],
                })
            return {"id": req_id, "result": True, "error": None}
        if method == "mining.extranonce.subscribe":
            return {"id": req_id, "result": True, "error": None}
        if method == "mining.submit":
            return self._handle_submit(session, req_id, params)
        return {"id": req_id, "result": None,
                "error": [E_OTHER, "unknown method", None]}

    def _handle_subscribe(
        self, session: ClientSession, req_id
    ) -> dict:
        if session.prefix is None:
            try:
                session.prefix = self.allocator.allocate()
            except SpaceExhausted:
                return {"id": req_id, "result": None,
                        "error": [E_OTHER, "server full", None]}
        session.extranonce1 = (
            self.extranonce1_base
            + self.allocator.encode(session.prefix)
        )
        session.extranonce2_size = self.session_extranonce2_size
        session.subscribed = True
        result = [
            [["mining.set_difficulty", f"d{session.conn_id}"],
             ["mining.notify", f"n{session.conn_id}"]],
            session.extranonce1.hex(),
            session.extranonce2_size,
        ]
        return {"id": req_id, "result": result, "error": None}

    # ----------------------------------------------------------- validation
    def _handle_submit(
        self, session: ClientSession, req_id, params: list
    ):
        """The verdict: pre-encoded bytes for a connected session with an
        int request id, else a dict (the internal worker reads one)."""
        if not session.active:
            return {"id": req_id, "result": None,
                    "error": [E_UNAUTH, "unauthorized", None]}
        try:
            _user, job_id, e2_hex, ntime_hex, nonce_hex = [
                str(p) for p in params[:5]
            ]
            extranonce2 = bytes.fromhex(e2_hex)
            ntime = int(ntime_hex, 16)
            nonce = int(nonce_hex, 16)
            version_bits = (int(str(params[5]), 16)
                            if len(params) > 5 else None)
        except (ValueError, TypeError):
            self._record_verdict(session, "malformed", None, None)
            return {"id": req_id, "result": None,
                    "error": [E_OTHER, "malformed submit", None]}

        lc = self.telemetry.lifecycle
        if lc.enabled:
            # For a connected miner this opens the share's record; for the
            # internal worker it extends the one its dispatcher's verify
            # gate opened (the same key).
            lc_key = _share_key(job_id, extranonce2, nonce)
            lc.hop(
                lc_key, "downstream_submit",
                trace=self.telemetry.tracer.current_trace(),
                conn_id=session.conn_id, internal=session.internal,
                terminal=False,
            )
        t0 = time.perf_counter()
        verdict, hash_int, job = self._validate_impl(
            session, job_id, extranonce2, ntime, nonce, version_bits
        )
        self.telemetry.frontend_validate.observe(
            time.perf_counter() - t0
        )
        if lc.enabled:
            # Terminal, unless a proxy forward re-opens the record.
            lc.hop(lc_key, "frontend_validate", verdict=verdict)
        self._record_verdict(
            session, verdict, session.difficulty, job_id
        )
        self._maybe_vardiff(session)
        fast_reply = type(req_id) is int and session.writer is not None
        if verdict != "accepted":
            if fast_reply:
                return _REJECT_TMPLS[verdict] % req_id
            code = _REJECT_CODES.get(verdict, E_OTHER)
            return {"id": req_id, "result": None,
                    "error": [code, verdict.replace("_", " "), None]}
        session.seen_shares.add(
            (job_id, extranonce2, ntime, nonce, version_bits)
        )
        hook = self.on_share_accepted
        if hook is not None:
            session.spawn(
                hook(session, job, extranonce2, ntime, nonce,
                     version_bits, hash_int),
                name=f"frontend-accept-{session.conn_id}",
            )
        if fast_reply:
            return _ACCEPT_TMPL % req_id
        return {"id": req_id, "result": True, "error": None}

    def _precheck(
        self,
        session: ClientSession,
        job_id: str,
        extranonce2: bytes,
        ntime: int,
        nonce: int,
        version_bits: Optional[int],
    ) -> Tuple[Optional[str], Optional[FrontendJob]]:
        """The verdicts that need no hash, in the order both validators
        take them: ``(verdict or None, job)``."""
        job = self.jobs.get(job_id)
        if job is None:
            return "stale", None
        if len(extranonce2) != session.extranonce2_size:
            return "bad_extranonce2", job
        if version_bits is not None:
            # No version mask was granted: rolled bits would make the
            # header validated differ from the one hashed.
            return "version_bits", job
        if (job_id, extranonce2, ntime, nonce, version_bits) \
                in session.seen_shares:
            return "duplicate", job
        return None, job

    def _validate(
        self,
        session: ClientSession,
        job_id: str,
        extranonce2: bytes,
        ntime: int,
        nonce: int,
        version_bits: Optional[int],
    ) -> Tuple[str, int, Optional[FrontendJob]]:
        """``(verdict, hash_int, job)`` from the hashlib oracle: the
        share's header rebuilt from the session's own space, independent
        of every device path."""
        verdict, job = self._precheck(session, job_id, extranonce2, ntime,
                                      nonce, version_bits)
        if verdict is not None:
            return verdict, 0, job
        coinbase = (job.coinb1 + session.extranonce1 + extranonce2
                    + job.coinb2)
        merkle = merkle_root_from_branch(
            self.oracle.sha256d(coinbase), job.merkle_branch
        )
        header = (
            job.version.to_bytes(4, "little")
            + job.prevhash_internal
            + merkle
            + ntime.to_bytes(4, "little")
            + job.nbits.to_bytes(4, "little")
            + nonce.to_bytes(4, "little")
        )
        h = int.from_bytes(self.oracle.sha256d(header), "little")
        if h > difficulty_to_target(session.difficulty):
            return "low_difficulty", h, job
        return "accepted", h, job

    def _validate_native(
        self,
        session: ClientSession,
        job_id: str,
        extranonce2: bytes,
        ntime: int,
        nonce: int,
        version_bits: Optional[int],
    ) -> Tuple[str, int, Optional[FrontendJob]]:
        """The same verdicts as :meth:`_validate`, the hash chain in one
        call into the native library: the coinbase resumed from the
        cached ``coinb1 ‖ extranonce1`` midstate, the merkle branch
        folded, the header hashed and held against the session target.
        What the oracle derives per submit is cached per (session, job)
        and per difficulty."""
        verdict, job = self._precheck(session, job_id, extranonce2, ntime,
                                      nonce, version_bits)
        if verdict is not None:
            return verdict, 0, job
        entry = session.fastpath.get(job_id)
        if entry is None or entry[0] != session.extranonce1:
            entry = self._fastpath_entry(session, job)
        tc = session.target_cache
        if tc is None or tc[0] != session.difficulty:
            target = difficulty_to_target(session.difficulty)
            tc = (
                session.difficulty, target,
                min(target, _MAX_TARGET256).to_bytes(32, "big"),
            )
            session.target_cache = tc
        tail = entry[3] + extranonce2 + job.coinb2
        digest = self._native_digest
        ok = self._native_validate(  # type: ignore[operator]
            entry[1], entry[2], tail, len(tail), entry[4], entry[5],
            entry[6], ntime, job.nbits, nonce, tc[2], digest,
        )
        h = int.from_bytes(digest, "little")  # type: ignore[arg-type]
        if not ok:
            return "low_difficulty", h, job
        return "accepted", h, job

    def _fastpath_entry(
        self, session: ClientSession, job: FrontendJob
    ) -> tuple:
        """Build and cache a (session, job)'s validation constants: the
        SHA-256 midstate over the whole 64-byte blocks of ``coinb1 ‖
        extranonce1``, the remainder a submit's tail is prepended with,
        the merkle branch as one blob, and the header's fixed 36 bytes
        (version ‖ prevhash)."""
        if len(session.fastpath) >= self.jobs_kept:
            for jid in [j for j in session.fastpath
                        if j not in self.jobs]:
                del session.fastpath[jid]
        mid8, absorbed, rem = self._native_mod.prefix_midstate(
            job.coinb1 + session.extranonce1
        )
        entry = (
            session.extranonce1, mid8, absorbed, rem,
            b"".join(job.merkle_branch), len(job.merkle_branch),
            job.version.to_bytes(4, "little") + job.prevhash_internal,
        )
        session.fastpath[job.job_id] = entry
        return entry

    def _record_verdict(
        self,
        session: ClientSession,
        verdict: str,
        difficulty: Optional[float],
        job_id: Optional[str],
    ) -> None:
        counter = self._verdict_counters.get(verdict)
        if counter is None:
            counter = self.telemetry.frontend_shares.labels(result=verdict)
            self._verdict_counters[verdict] = counter
        counter.inc()  # type: ignore[attr-defined]
        # The accountant weighs accepted work against claimed work.
        if difficulty is not None:
            session.work.claim(difficulty)
            work = difficulty * WORK_PER_DIFF1
            self.claimed_work += work
            self.submits += 1
            if verdict == "accepted":
                self.accepted_work += work
        session.accounting.on_result(
            "accepted" if verdict == "accepted" else "rejected",
            difficulty,
        )
        if verdict == "accepted":
            session.accepted += 1
            session.consecutive_invalid = 0
            return
        session.invalid += 1
        session.consecutive_invalid += 1
        self.telemetry.flightrec.record(
            "frontend_invalid_share", reason=verdict, job_id=job_id,
            peer=session.peer, conn_id=session.conn_id,
        )

    # -------------------------------------------------------------- vardiff
    def _maybe_vardiff(self, session: ClientSession) -> None:
        """Retarget a session from its own claimed-work rate: the ideal
        difficulty is its hashrate × the target share interval ÷ 2^32,
        stepped at most ×/÷ ``vardiff_max_step`` a window and never below
        ``min_difficulty``. Driven by submits: a silent session is
        retargeted at its next submit, over a longer window."""
        if self.vardiff_interval_s <= 0 or session.internal:
            # The internal worker mines the target its dispatcher was
            # given; retargeting it here would validate against another.
            return
        now = time.monotonic()
        claimed = session.work.hashes
        if session.vardiff_anchor is None:
            session.vardiff_anchor = (now, claimed)
            return
        anchor_t, anchor_work = session.vardiff_anchor
        elapsed = now - anchor_t
        if elapsed < self.vardiff_interval_s:
            return
        session.vardiff_anchor = (now, claimed)
        window_work = claimed - anchor_work
        if window_work <= 0:
            return
        hashrate = window_work / elapsed
        ideal = hashrate * (60.0 / self.vardiff_target_spm) / WORK_PER_DIFF1
        step = self.vardiff_max_step
        new = min(max(ideal, session.difficulty / step),
                  session.difficulty * step)
        new = max(new, self.min_difficulty)
        if abs(new - session.difficulty) / session.difficulty < 0.05:
            return  # within the deadband: not worth a push
        logger.info(
            "vardiff: session %s %g -> %g (claimed %.0f MH/s over %.1fs)",
            session.peer, session.difficulty, new, hashrate / 1e6, elapsed,
        )
        session.difficulty = new
        session.accounting.set_difficulty(new)
        self._send(session, {
            "id": None, "method": "mining.set_difficulty",
            "params": [session.difficulty],
        })

    # ------------------------------------------------------------ insights
    def snapshot(self) -> Dict:
        """The frontend's state, over every session."""
        return {
            "sessions": self.downstream_sessions,
            "internal_workers": sum(
                1 for s in self.sessions.values() if s.internal
            ),
            "prefixes_in_use": self.allocator.in_use,
            "prefix_range": list(self.allocator.prefix_range),
            "claimed_work": self.claimed_work,
            "accepted_work": self.accepted_work,
            "jobs": list(self.jobs),
            "difficulty": self.difficulty,
            "per_session": [
                s.snapshot() for s in self.sessions.values()
            ],
        }


class InternalWorker:
    """The local hasher as a consumer of the frontend.

    It takes a prefix from the allocator downstream sessions use (so the
    server is its own biggest miner in a disjoint slice), runs a
    ``Dispatcher`` over that slice on any ``Hasher`` (on the card, the
    CUDA backends), and submits the dispatcher's verified shares through
    the validator a remote client's submits take (``_handle_submit``),
    metered, accounted and proxied the same way. The frontend grants no
    version mask, so a hasher with sibling chains degrades to chain 0."""

    def __init__(
        self,
        server: StratumPoolServer,
        hasher,
        n_workers: int = 2,
        stream_depth: int = 2,
        scheduler=None,
        batch_size: int = 1 << 16,
        username: str = "internal",
    ) -> None:
        from ..miner.dispatcher import Dispatcher

        self.server = server
        self.username = username
        self.session = ClientSession(
            next(server._ids), "internal", writer=None
        )
        # The slice is claimed as a remote subscribe/authorize claims it.
        reply = server._handle_subscribe(self.session, req_id=0)
        if reply.get("error"):
            raise SpaceExhausted(str(reply["error"]))
        self.session.username = username
        self.session.difficulty = server.difficulty
        self.session.accounting.set_difficulty(server.difficulty)
        server.sessions[self.session.conn_id] = self.session
        self.dispatcher = Dispatcher(
            hasher,
            n_workers=n_workers,
            batch_size=batch_size,
            stream_depth=stream_depth,
            scheduler=scheduler,
            telemetry=server.telemetry,
        )
        server.job_listeners.append(self.on_job)
        if server.current_job is not None:
            self.on_job(server.current_job)

    def on_job(self, fjob: FrontendJob) -> None:
        """Install a frontend job in the dispatcher as this worker's
        slice: its own extranonce1, its session's target."""
        from ..miner.job import Job

        self.dispatcher.set_job(Job(
            job_id=fjob.job_id,
            prevhash_internal=fjob.prevhash_internal,
            coinb1=fjob.coinb1,
            coinb2=fjob.coinb2,
            extranonce1=self.session.extranonce1,
            extranonce2_size=self.session.extranonce2_size,
            merkle_branch=list(fjob.merkle_branch),
            version=fjob.version,
            nbits=fjob.nbits,
            ntime=fjob.ntime,
            share_target=difficulty_to_target(self.session.difficulty),
            clean=fjob.clean,
        ))

    async def _on_share(self, share) -> None:
        reply = self.server._handle_submit(
            self.session, req_id=0, params=[
                self.username, share.job_id, share.extranonce2.hex(),
                f"{share.ntime:08x}", f"{share.nonce:08x}",
            ],
        )
        # The verdict lands in the dispatcher's stats, which the reporter
        # line and the status server read.
        stats = self.dispatcher.stats
        if reply.get("error"):
            stats.shares_rejected += 1
            logger.warning(
                "internal share rejected by own frontend: %s "
                "(job %s nonce %#010x)",
                reply["error"], share.job_id, share.nonce,
            )
        else:
            stats.shares_accepted += 1

    async def run(self) -> None:
        await self.dispatcher.run(self._on_share)

    def stop(self) -> None:
        if self.on_job in self.server.job_listeners:
            self.server.job_listeners.remove(self.on_job)
        self.dispatcher.stop()
        self.server._close_session(self.session)
