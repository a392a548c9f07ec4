"""The package's pool frontend (``poolserver/``) on the CPU: the
reference's own battery (``tests/test_poolserver.py``) mirrored on the
port — the allocator, the session lifecycle, the space partition,
validation against the mock pool, the native fast path against the
hashlib oracle, adversarial clients, proxy mode over one upstream and
over the multi-pool fabric, vardiff, the internal worker and the
``frontend`` health rule — and the port held against the reference: the
same seeded submit stream, under a scripted clock, into the reference's
``StratumPoolServer`` and the port's gives the same reply bytes,
pushes, verdict counts, claimed and accepted work and vardiff retargets,
with the hashlib validator and with the native one. Then the internal
worker on ``TileCudaHasher(device="cpu")`` behind ``UpstreamProxy``
(its shares accepted by the port's validating mock pool), ``--vshare
2`` on it running chain 0 alone, and the command line."""

import asyncio
import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

# The miner package first: importing the protocol package first is circular.
import bitcoin_miner_tpu.miner.runner  # noqa: F401
from bitcoin_miner_tpu.poolserver import jobs as ref_jobs
from bitcoin_miner_tpu.poolserver import server as ref_server
from bitcoin_miner_tpu.telemetry import pipeline as ref_pipeline
from bitcoin_miner_tpu_torch import cli
from bitcoin_miner_tpu_torch.backends import native
from bitcoin_miner_tpu_torch.backends.cpu import CpuHasher
from bitcoin_miner_tpu_torch.backends.cuda import TileCudaHasher
from bitcoin_miner_tpu_torch.core.header import merkle_root_from_branch
from bitcoin_miner_tpu_torch.core.sha256 import sha256d
from bitcoin_miner_tpu_torch.core.target import difficulty_to_target
from bitcoin_miner_tpu_torch.miner.multipool import PoolFabric, parse_pool_spec
from bitcoin_miner_tpu_torch.poolserver import (
    ClientSession,
    FabricUpstreamProxy,
    InternalWorker,
    LocalTemplateSource,
    PoolFrontend,
    PrefixAllocator,
    ShardSupervisor,
    SpaceExhausted,
    StratumPoolServer,
    UpstreamProxy,
)
from bitcoin_miner_tpu_torch.poolserver import jobs as port_jobs
from bitcoin_miner_tpu_torch.poolserver import server as port_server
from bitcoin_miner_tpu_torch.protocol.stratum import StratumClient
from bitcoin_miner_tpu_torch.telemetry import pipeline as port_pipeline
from bitcoin_miner_tpu_torch.telemetry.health import (
    DEGRADED,
    OK,
    HealthModel,
)
from bitcoin_miner_tpu_torch.telemetry.pipeline import PipelineTelemetry
from bitcoin_miner_tpu_torch.testing.chaos_hasher import ChaosError, ChaosHasher
from bitcoin_miner_tpu_torch.testing.chaos_pool import ChaosStratumPool
from bitcoin_miner_tpu_torch.testing.mock_pool import MockStratumPool, PoolJob

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: brute-forceable share difficulty: ~256 hashes per share.
EASY = 1 / (1 << 24)
#: a share target above the whole hash range: every submit validates.
TRIVIAL = 1e-12
#: the native library is built when g++ is here; a failed build then
#: fails the tests that need it instead of skipping them.
HAVE_GXX = shutil.which("g++") is not None
NATIVE = pytest.mark.skipif(not HAVE_GXX,
                            reason="no g++ to build the native hasher")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def make_server(**kw) -> StratumPoolServer:
    kw.setdefault("difficulty", EASY)
    kw.setdefault("telemetry", PipelineTelemetry())
    return StratumPoolServer(**kw)


def make_fjob(job_id: str = "j1", clean: bool = True, jobs=port_jobs):
    return jobs.FrontendJob(
        job_id=job_id,
        prevhash_internal=sha256d(b"prev " + job_id.encode()),
        coinb1=bytes.fromhex("01000000") + b"\x11" * 30,
        coinb2=b"\x22" * 30 + bytes.fromhex("00000000"),
        merkle_branch=[sha256d(b"tx1"), sha256d(b"tx2")],
        version=0x20000000,
        nbits=0x1D00FFFF,
        ntime=0x655F2B2C,
        clean=clean,
    )


def make_pool_job(job_id: str = "j1") -> PoolJob:
    fj = make_fjob(job_id)
    return PoolJob(job_id=fj.job_id, prevhash_internal=fj.prevhash_internal,
                   coinb1=fj.coinb1, coinb2=fj.coinb2,
                   merkle_branch=list(fj.merkle_branch), version=fj.version,
                   nbits=fj.nbits, ntime=fj.ntime)


def find_nonce(job, extranonce1: bytes, extranonce2: bytes,
               difficulty: float, want_valid: bool = True,
               start: int = 0) -> int:
    """A nonce whose share is (in)valid at ``difficulty``, by the same
    independent rebuild both validators make."""
    coinbase = job.coinb1 + extranonce1 + extranonce2 + job.coinb2
    merkle = merkle_root_from_branch(sha256d(coinbase), job.merkle_branch)
    header76 = (
        job.version.to_bytes(4, "little") + job.prevhash_internal + merkle
        + job.ntime.to_bytes(4, "little") + job.nbits.to_bytes(4, "little")
    )
    target = difficulty_to_target(difficulty)
    for nonce in range(start, start + (1 << 22)):
        h = int.from_bytes(
            sha256d(header76 + nonce.to_bytes(4, "little")), "little")
        if (h <= target) == want_valid:
            return nonce
    raise AssertionError("no suitable nonce found")


async def wait_until(pred, what: str, seconds: float = 30.0) -> None:
    deadline = asyncio.get_running_loop().time() + seconds
    while not pred():
        assert asyncio.get_running_loop().time() < deadline, what
        await asyncio.sleep(0.02)


class MiniClient:
    """A raw line-JSON client: each wire exchange spelled out."""

    def __init__(self, port: int) -> None:
        self.port = port
        self.reader = None
        self.writer = None

    async def connect(self) -> "MiniClient":
        self.reader, self.writer = await asyncio.open_connection(
            "127.0.0.1", self.port)
        return self

    async def send(self, obj: dict) -> None:
        self.writer.write((json.dumps(obj) + "\n").encode())
        await self.writer.drain()

    async def send_raw(self, data: bytes) -> None:
        self.writer.write(data)
        await self.writer.drain()

    async def recv(self, timeout: float = 10.0) -> dict:
        line = await asyncio.wait_for(self.reader.readline(), timeout)
        assert line, "connection closed"
        return json.loads(line)

    async def handshake(self, user: str = "worker") -> tuple:
        """subscribe + authorize + the greet's difficulty push; returns
        (extranonce1, extranonce2_size)."""
        await self.send({"id": 1, "method": "mining.subscribe",
                         "params": ["mini"]})
        sub = await self.recv()
        assert sub["error"] is None
        e1 = bytes.fromhex(sub["result"][1])
        e2size = int(sub["result"][2])
        await self.send({"id": 2, "method": "mining.authorize",
                         "params": [user, "x"]})
        auth = await self.recv()
        assert auth["result"] is True
        diff = await self.recv()
        assert diff["method"] == "mining.set_difficulty"
        return e1, e2size

    async def submit(self, job_id: str, e2: bytes, ntime: int,
                     nonce: int) -> dict:
        await self.send({"id": 9, "method": "mining.submit", "params": [
            "worker", job_id, e2.hex(), f"{ntime:08x}", f"{nonce:08x}",
        ]})
        while True:
            msg = await self.recv()
            if msg.get("id") == 9:
                return msg

    async def eof(self, timeout: float = 10.0) -> bool:
        line = await asyncio.wait_for(self.reader.readline(), timeout)
        return line == b""

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


class ScriptedTime:
    """A stand-in for a server module's ``time``: both clocks read ``t``,
    which the test advances."""

    def __init__(self) -> None:
        self.t = 1000.0

    def monotonic(self) -> float:
        return self.t

    def perf_counter(self) -> float:
        return self.t


def internal_session(server, difficulty=None):
    """A writerless session claimed and authorized on ``server``."""
    session = ClientSession(next(server._ids), "test", writer=None)
    assert not server._handle_subscribe(session, req_id=0).get("error")
    session.username = "worker"
    session.difficulty = server.difficulty if difficulty is None \
        else difficulty
    session.accounting.set_difficulty(session.difficulty)
    server.sessions[session.conn_id] = session
    server._downstream += 1
    return session


def verdicts(telemetry) -> dict:
    return {k[0]: child.value
            for k, child in telemetry.frontend_shares.children()}


# ------------------------------------------------------------ allocator
class TestPrefixAllocator:
    def test_unique_then_exhausted(self):
        alloc = PrefixAllocator(1)
        got = [alloc.allocate() for _ in range(256)]
        assert sorted(got) == list(range(256))
        with pytest.raises(SpaceExhausted):
            alloc.allocate()

    def test_reclaim_lowest_first(self):
        alloc = PrefixAllocator(2)
        a, b, c = alloc.allocate(), alloc.allocate(), alloc.allocate()
        assert (a, b, c) == (0, 1, 2)
        alloc.release(b)
        alloc.release(a)
        assert alloc.allocate() == 0
        assert alloc.allocate() == 1
        assert alloc.allocate() == 3

    def test_double_release_rejected(self):
        alloc = PrefixAllocator(1)
        p = alloc.allocate()
        alloc.release(p)
        with pytest.raises(ValueError):
            alloc.release(p)

    def test_encode_width(self):
        alloc = PrefixAllocator(2)
        assert alloc.encode(alloc.allocate()) == b"\x00\x00"

    @pytest.mark.parametrize("width,n", [(1, 1), (1, 3), (1, 7), (2, 5),
                                         (1, 256)])
    def test_partition_matches_reference(self, width, n):
        from bitcoin_miner_tpu.poolserver.space import (
            PrefixAllocator as RefAllocator,
        )

        port, ref = PrefixAllocator(width), RefAllocator(width)
        got = [port.partition(n, i).prefix_range for i in range(n)]
        assert got == [ref.partition(n, i).prefix_range for i in range(n)]
        assert got[0][0] == 0 and got[-1][1] == 256 ** width
        assert all(a[1] == b[0] for a, b in zip(got, got[1:]))

    def test_partition_refuses_what_the_reference_refuses(self):
        alloc = PrefixAllocator(1)
        for n, i in ((0, 0), (2, 2), (257, 0)):
            with pytest.raises(ValueError):
                alloc.partition(n, i)


# ------------------------------------------------------ session lifecycle
class TestSessionLifecycle:
    def test_subscribe_authorize_greet(self):
        async def main():
            server = make_server()
            await server.start()
            await server.set_job(make_fjob())
            c = await MiniClient(server.port).connect()
            e1, e2size = await c.handshake()
            assert e1 == server.extranonce1_base + b"\x00\x00"
            assert e2size == server.total_extranonce2_size - 2
            notify = await c.recv()
            assert notify["method"] == "mining.notify"
            assert notify["params"][0] == "j1"
            assert server.downstream_sessions == 1
            assert server.telemetry.frontend_sessions.value == 1
            c.close()
            await server.stop()

        run(main())

    def test_submit_before_authorize_rejected(self):
        async def main():
            server = make_server()
            await server.start()
            await server.set_job(make_fjob())
            c = await MiniClient(server.port).connect()
            reply = await c.submit("j1", b"\x00\x00", 0x655F2B2C, 1)
            assert reply["result"] is None
            assert reply["error"][0] == 24
            c.close()
            await server.stop()

        run(main())

    def test_authorize_requires_subscribe(self):
        async def main():
            server = make_server()
            await server.start()
            c = await MiniClient(server.port).connect()
            await c.send({"id": 1, "method": "mining.authorize",
                          "params": ["u", "x"]})
            reply = await c.recv()
            assert reply["result"] is False
            assert reply["error"][0] == 25
            c.close()
            await server.stop()

        run(main())

    def test_unknown_method_errors(self):
        async def main():
            server = make_server()
            await server.start()
            c = await MiniClient(server.port).connect()
            await c.send({"id": 5, "method": "mining.wat", "params": []})
            reply = await c.recv()
            assert reply["error"][0] == 20
            c.close()
            await server.stop()

        run(main())

    def test_retarget_reinstalls_job_for_internal_listeners(self):
        async def main():
            server = make_server()
            await server.start()
            seen = []
            server.job_listeners.append(
                lambda j: seen.append((j.job_id, server.difficulty)))
            await server.set_job(make_fjob())
            await server.set_difficulty(EASY * 2)
            assert seen == [("j1", EASY), ("j1", EASY * 2)]
            await server.stop()

        run(main())

    def test_suggest_difficulty_clamped_to_floor(self):
        async def main():
            server = make_server(difficulty=EASY)
            await server.start()
            await server.set_job(make_fjob())
            c = await MiniClient(server.port).connect()
            await c.handshake()
            assert (await c.recv())["method"] == "mining.notify"
            await c.send({"id": 7, "method": "mining.suggest_difficulty",
                          "params": [1e-12]})
            push = await c.recv()
            assert push["method"] == "mining.set_difficulty"
            assert push["params"][0] == EASY
            reply = await c.recv()
            assert reply["id"] == 7 and reply["result"] is True
            session = next(iter(server.sessions.values()))
            assert session.difficulty == EASY
            job = server.current_job
            e2 = (0).to_bytes(session.extranonce2_size, "little")
            nonce = find_nonce(job, session.extranonce1, e2, EASY,
                               want_valid=False)
            bad = await c.submit("j1", e2, job.ntime, nonce)
            assert bad["error"][0] == 23
            await c.send({"id": 8, "method": "mining.suggest_difficulty",
                          "params": [EASY * 4]})
            push = await c.recv()
            assert push["params"][0] == EASY * 4
            c.close()
            await server.stop()

        run(main())

    def test_suggest_floor_tracks_retargets(self):
        async def main():
            server = make_server(difficulty=EASY)
            await server.start()
            await server.set_difficulty(EASY * 64)
            c = await MiniClient(server.port).connect()
            await c.handshake()
            await c.send({"id": 7, "method": "mining.suggest_difficulty",
                          "params": [EASY]})
            push = await c.recv()
            assert push["method"] == "mining.set_difficulty"
            assert push["params"][0] == EASY * 64
            c.close()
            await server.stop()
            pinned = make_server(difficulty=EASY, min_difficulty=EASY / 4)
            await pinned.set_difficulty(EASY * 64)
            assert pinned.min_difficulty == EASY / 4

        run(main())

    def test_rebase_recarves_live_sessions_and_pushes_set_extranonce(self):
        async def main():
            server = make_server()
            await server.start()
            iw = InternalWorker(server, CpuHasher(), n_workers=1,
                                batch_size=1 << 8)
            c = await MiniClient(server.port).connect()
            e1_before, _ = await c.handshake()
            new_base = bytes.fromhex("deadbeefcafe")
            await server.rebase_extranonce(new_base, 6)
            push = await c.recv()
            assert push["method"] == "mining.set_extranonce"
            new_e1 = bytes.fromhex(push["params"][0])
            assert new_e1.startswith(new_base)
            assert new_e1[len(new_base):] == e1_before[-2:]
            assert push["params"][1] == 4
            assert iw.session.extranonce1.startswith(new_base)
            assert iw.session.extranonce2_size == 4
            with pytest.raises(ValueError):
                await server.rebase_extranonce(new_base, 2)
            iw.stop()
            c.close()
            await server.stop()

        run(main())

    def test_abandoned_teardown_terminates(self):
        """A caller that raises with a push in flight and no
        ``server.stop()`` (a failing test) still terminates: the handler
        never parks on a cancelled drain. In a subprocess, so a hang
        fails here instead of wedging the suite."""
        code = (
            "import asyncio, sys\n"
            "sys.path.insert(0, 'tests')\n"
            "from test_torch_poolserver import (MiniClient, make_server,\n"
            "                                   make_fjob, EASY)\n"
            "async def main():\n"
            "    server = make_server(difficulty=EASY)\n"
            "    await server.start()\n"
            "    await server.set_job(make_fjob())\n"
            "    c = await MiniClient(server.port).connect()\n"
            "    await c.handshake()\n"
            "    await c.send({'id': 7,\n"
            "                  'method': 'mining.suggest_difficulty',\n"
            "                  'params': [1e-12]})\n"
            "    await c.recv()\n"
            "    raise AssertionError('simulated failure')\n"
            "try:\n"
            "    asyncio.run(main())\n"
            "except AssertionError:\n"
            "    print('CLEAN-EXIT')\n"
        )
        proc = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO,
            capture_output=True, text=True, timeout=60,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
        assert "CLEAN-EXIT" in proc.stdout, (proc.stdout, proc.stderr)

    def test_session_churn_recorded_in_flightrec(self):
        async def main():
            server = make_server()
            await server.start()
            c = await MiniClient(server.port).connect()
            await c.handshake()
            c.close()
            await wait_until(lambda: not server.downstream_sessions,
                             "session not closed")
            actions = [e.get("action") for e in
                       server.telemetry.flightrec.snapshot()
                       if e["kind"] == "frontend_session"]
            assert actions == ["open", "close"]
            await server.stop()

        run(main())

    def test_configure_declines_version_rolling(self):
        server = make_server()
        session = internal_session(server)
        reply = server._dispatch(session, {"id": 3,
                                           "method": "mining.configure",
                                           "params": [["version-rolling"]]})
        assert reply == {"id": 3, "result": {"version-rolling": False},
                         "error": None}


# ------------------------------------------------------- space partition
class TestSpacePartition:
    def test_unique_extranonce1_across_fleet(self):
        async def main():
            server = make_server()
            await server.start()
            fleet = [await MiniClient(server.port).connect()
                     for _ in range(20)]
            e1s = set()
            for c in fleet:
                e1, e2size = await c.handshake()
                assert e2size >= 1
                e1s.add(e1)
            assert len(e1s) == 20
            assert server.allocator.in_use == 20
            for c in fleet:
                c.close()
            await server.stop()

        run(main())

    def test_disconnect_reclaims_prefix_collision_free(self):
        async def main():
            server = make_server()
            await server.start()
            clients = {n: await MiniClient(server.port).connect()
                       for n in "abc"}
            e1s = {n: (await c.handshake())[0] for n, c in clients.items()}
            clients["b"].close()
            await wait_until(lambda: server.allocator.in_use == 2,
                             "prefix not released")
            d = await MiniClient(server.port).connect()
            e1_d, _ = await d.handshake()
            assert e1_d == e1s["b"]
            assert len({e1s["a"], e1s["c"], e1_d}) == 3
            for c in (clients["a"], clients["c"], d):
                c.close()
            await server.stop()

        run(main())

    def test_internal_worker_shares_the_allocator(self):
        async def main():
            server = make_server()
            await server.start()
            iw = InternalWorker(server, CpuHasher(), n_workers=1,
                                batch_size=1 << 8)
            c = await MiniClient(server.port).connect()
            e1, _ = await c.handshake()
            assert e1 != iw.session.extranonce1
            assert server.allocator.in_use == 2
            iw.stop()
            assert server.allocator.in_use == 1
            c.close()
            await server.stop()

        run(main())

    def test_full_server_refuses_subscribe(self):
        server = make_server(prefix_bytes=1, extranonce2_size=2,
                             allocator=PrefixAllocator(1, start=0, stop=1))
        internal_session(server)
        late = ClientSession(next(server._ids), "late", writer=None)
        reply = server._handle_subscribe(late, req_id=4)
        assert reply["error"] == [20, "server full", None]
        with pytest.raises(SpaceExhausted):
            InternalWorker(server, CpuHasher(), n_workers=1)


# ----------------------------------------------------- validation parity
class TestValidationParity:
    """The mock pool (hashlib, independent code) is the spec of record:
    the frontend and the mock pool agree on every verdict."""

    def _mock_for_session(self, e1: bytes, e2size: int) -> MockStratumPool:
        pool = MockStratumPool(extranonce1=e1, extranonce2_size=e2size,
                               difficulty=EASY)
        pool.jobs["j1"] = make_pool_job()
        return pool

    def test_accept_and_reject_parity(self):
        async def main():
            server = make_server()
            await server.start()
            job = make_fjob()
            await server.set_job(job)
            c = await MiniClient(server.port).connect()
            e1, e2size = await c.handshake()
            pool = self._mock_for_session(e1, e2size)
            e2 = (7).to_bytes(e2size, "little")
            cases = [
                ("valid", "j1", e2, find_nonce(job, e1, e2, EASY)),
                ("low-diff", "j1", e2,
                 find_nonce(job, e1, e2, EASY, want_valid=False)),
                ("stale", "nope", e2, 1),
                ("bad-e2", "j1", b"\x01" * (e2size + 1), 1),
            ]
            for label, job_id, e2_case, nonce in cases:
                reply = await c.submit(job_id, e2_case, job.ntime, nonce)
                mock_accepts, reason = pool._validate(job_id, e2_case,
                                                      job.ntime, nonce)
                assert (reply["result"] is True) == mock_accepts, (
                    f"{label}: frontend={reply} mock={reason}")
            c.close()
            await server.stop()

        run(main())

    def test_stale_after_job_eviction(self):
        async def main():
            server = make_server(jobs_kept=2)
            await server.start()
            first = make_fjob("old")
            await server.set_job(first)
            c = await MiniClient(server.port).connect()
            e1, e2size = await c.handshake()
            for i in range(3):
                await server.set_job(make_fjob(f"new{i}", clean=False))
            e2 = (0).to_bytes(e2size, "little")
            nonce = find_nonce(first, e1, e2, EASY)
            reply = await c.submit("old", e2, first.ntime, nonce)
            assert reply["error"][0] == 21
            c.close()
            await server.stop()

        run(main())

    def test_duplicate_share_rejected(self):
        async def main():
            server = make_server(difficulty=TRIVIAL)
            await server.start()
            job = make_fjob()
            await server.set_job(job)
            c = await MiniClient(server.port).connect()
            _e1, e2size = await c.handshake()
            e2 = (1).to_bytes(e2size, "little")
            first = await c.submit("j1", e2, job.ntime, 42)
            assert first["result"] is True
            dup = await c.submit("j1", e2, job.ntime, 42)
            assert dup["error"][0] == 22
            c.close()
            await server.stop()

        run(main())


# ------------------------------------------------ native fast-path parity
@NATIVE
class TestFastPathParity:
    """The native validator against the hashlib oracle on every verdict
    class (verdict, hash_int, job), and its per-(session, job) midstate
    cache across job switches and an extranonce rebase."""

    VERDICTS = ["valid", "stale", "duplicate", "low_difficulty",
                "bad_extranonce2", "version_bits"]

    def _server_session(self, **kw):
        server = make_server(native_validation=True, **kw)
        assert server.native_active
        return server, internal_session(server)

    def _both(self, server, session, *args):
        want = server._validate(session, *args)
        got = server._validate_native(session, *args)
        assert got[0] == want[0], f"verdict diverged: {got} vs {want}"
        assert got[1] == want[1], "hash_int not bit-exact"
        assert got[2] is want[2]
        return want

    @pytest.mark.parametrize("case", VERDICTS)
    def test_verdict_battery_bit_exact(self, case):
        async def main():
            server, session = self._server_session()
            job = make_fjob()
            await server.set_job(job)
            e1 = session.extranonce1
            e2size = session.extranonce2_size
            e2 = (1).to_bytes(e2size, "little")
            if case in ("valid", "duplicate"):
                nonce = find_nonce(job, e1, e2, EASY)
                if case == "duplicate":
                    session.seen_shares.add(("j1", e2, job.ntime, nonce,
                                             None))
                args = ("j1", e2, job.ntime, nonce, None)
            elif case == "stale":
                args = ("gone", e2, job.ntime, 1, None)
            elif case == "low_difficulty":
                nonce = find_nonce(job, e1, e2, EASY, want_valid=False)
                args = ("j1", e2, job.ntime, nonce, None)
            elif case == "bad_extranonce2":
                args = ("j1", b"\x01" * (e2size + 1), job.ntime, 1, None)
            else:
                args = ("j1", e2, job.ntime, 1, 0x00200000)
            verdict, h, _job = self._both(server, session, *args)
            assert verdict == {"valid": "accepted"}.get(case, case)
            if case in ("valid", "low_difficulty"):
                coinbase = job.coinb1 + e1 + e2 + job.coinb2
                merkle = merkle_root_from_branch(sha256d(coinbase),
                                                 job.merkle_branch)
                header = (job.version.to_bytes(4, "little")
                          + job.prevhash_internal + merkle
                          + job.ntime.to_bytes(4, "little")
                          + job.nbits.to_bytes(4, "little")
                          + args[3].to_bytes(4, "little"))
                assert h == int.from_bytes(sha256d(header), "little")
            await server.stop()

        run(main())

    def test_midstate_cache_invalidates_across_job_switch(self):
        async def main():
            server, session = self._server_session(jobs_kept=2)
            e1 = session.extranonce1
            e2 = (3).to_bytes(session.extranonce2_size, "little")
            j1 = make_fjob("j1")
            await server.set_job(j1)
            self._both(server, session, "j1", e2, j1.ntime,
                       find_nonce(j1, e1, e2, EASY), None)
            entry1 = session.fastpath["j1"]
            j2 = make_fjob("j2", clean=False)
            await server.set_job(j2)
            verdict, _h, _ = self._both(server, session, "j2", e2, j2.ntime,
                                        find_nonce(j2, e1, e2, EASY), None)
            assert verdict == "accepted"
            assert "j2" in session.fastpath
            assert session.fastpath["j1"] is entry1
            await server.set_job(make_fjob("j3", clean=False))
            assert "j1" not in server.jobs
            self._both(server, session, "j2", e2, j2.ntime,
                       find_nonce(j2, e1, e2, EASY, want_valid=False), None)
            await server.set_job(make_fjob("j4", clean=False))
            j4 = server.jobs["j4"]
            self._both(server, session, "j4", e2, j4.ntime,
                       find_nonce(j4, e1, e2, EASY), None)
            assert "j1" not in session.fastpath
            await server.stop()

        run(main())

    def test_midstate_cache_invalidates_across_extranonce_rebase(self):
        async def main():
            server, session = self._server_session()
            job = make_fjob()
            await server.set_job(job)
            old_e1 = session.extranonce1
            e2 = (5).to_bytes(session.extranonce2_size, "little")
            self._both(server, session, "j1", e2, job.ntime,
                       find_nonce(job, old_e1, e2, EASY), None)
            old_entry = session.fastpath["j1"]
            assert old_entry[0] == old_e1
            await server.rebase_extranonce(b"\xAB\xCD", 6)
            assert session.fastpath == {}
            new_e1 = session.extranonce1
            assert new_e1 != old_e1
            e2n = (5).to_bytes(session.extranonce2_size, "little")
            verdict, _h, _ = self._both(
                server, session, "j1", e2n, job.ntime,
                find_nonce(job, new_e1, e2n, EASY), None)
            assert verdict == "accepted"
            assert session.fastpath["j1"][0] == new_e1
            assert session.fastpath["j1"] is not old_entry
            await server.stop()

        run(main())

    def test_validator_choice_is_logged_and_forced(self, caplog,
                                                   monkeypatch):
        with caplog.at_level("INFO", logger=port_server.logger.name):
            assert make_server().native_active
        assert any("native share validation active" in r.getMessage()
                   for r in caplog.records)
        assert not make_server(native_validation=False).native_active

        def broken():
            raise OSError("no compiler")

        monkeypatch.setattr(native, "validator_handles", broken)
        caplog.clear()
        with caplog.at_level("INFO", logger=port_server.logger.name):
            assert not make_server().native_active
        assert any("using hashlib oracle" in r.getMessage()
                   for r in caplog.records)
        with pytest.raises(OSError, match="native_validation=True"):
            make_server(native_validation=True)


# -------------------------------------------------- adversarial metering
class TestAdversarialClients:
    def test_malformed_lines_disconnect_past_budget(self):
        async def main():
            server = make_server(malformed_budget=2)
            await server.start()
            c = await MiniClient(server.port).connect()
            for _ in range(3):
                await c.send_raw(b"not json at all\n")
            assert await c.eof()
            tel = server.telemetry
            assert verdicts(tel).get("malformed", 0) == 3
            reasons = [e.get("reason") for e in tel.flightrec.snapshot()
                       if e["kind"] == "frontend_invalid_share"]
            assert any("malformed" in (r or "") for r in reasons)
            await server.stop()

        run(main())

    def test_oversized_line_disconnects(self):
        async def main():
            server = make_server(max_line_bytes=1024)
            await server.start()
            c = await MiniClient(server.port).connect()
            await c.send_raw(b"x" * 4096 + b"\n")
            assert await c.eof()
            await server.stop()

        run(main())

    def test_slow_loris_dropped_at_pre_auth_deadline(self):
        async def main():
            server = make_server(pre_auth_timeout_s=0.3)
            await server.start()
            c = await MiniClient(server.port).connect()
            assert await c.eof(timeout=10)
            await wait_until(lambda: server.downstream_sessions == 0,
                             "session not closed")
            await server.stop()

        run(main())

    def test_junk_share_fleet_disconnected_past_budget(self):
        async def main():
            server = make_server(invalid_share_budget=3)
            await server.start()
            await server.set_job(make_fjob())
            c = await MiniClient(server.port).connect()
            _e1, e2size = await c.handshake()
            e2 = (0).to_bytes(e2size, "little")
            for i in range(4):
                reply = await c.submit("no-such-job", e2, 0, i)
                assert reply["result"] is None
            assert await c.eof()
            await server.stop()

        run(main())

    def test_session_accounting_flags_junk(self):
        async def main():
            server = make_server(difficulty=TRIVIAL,
                                 invalid_share_budget=100)
            await server.start()
            job = make_fjob()
            await server.set_job(job)
            c = await MiniClient(server.port).connect()
            _e1, e2size = await c.handshake()
            for i in range(4):
                await c.submit("j1", i.to_bytes(e2size, "little"),
                               job.ntime, i)
            for i in range(4):
                await c.submit("bad-job", i.to_bytes(e2size, "little"),
                               job.ntime, i)
            snap = [s for s in server.snapshot()["per_session"]
                    if not s["internal"]][0]
            assert snap["accepted"] == 4 and snap["invalid"] == 4
            session = next(iter(server.sessions.values()))
            observed = session.accounting.snapshot()
            assert observed["observed_work"] == pytest.approx(
                observed["hashes"] / 2)
            c.close()
            await server.stop()

        run(main())

    def test_pipelined_burst_replies_in_order(self):
        """A burst of submits in one segment: every reply, in request
        order (they are coalesced into one write)."""
        async def main():
            server = make_server(difficulty=TRIVIAL)
            await server.start()
            job = make_fjob()
            await server.set_job(job)
            c = await MiniClient(server.port).connect()
            _e1, e2size = await c.handshake()
            assert (await c.recv())["method"] == "mining.notify"
            burst = b"".join(
                (json.dumps({"id": 100 + i, "method": "mining.submit",
                             "params": ["w", "j1",
                                        i.to_bytes(e2size, "little").hex(),
                                        f"{job.ntime:08x}", f"{i:08x}"]})
                 + "\n").encode() for i in range(20))
            await c.send_raw(burst)
            ids = [(await c.recv())["id"] for _ in range(20)]
            assert ids == list(range(100, 120))
            c.close()
            await server.stop()

        run(main())


# ------------------------------------------------------------ proxy mode
class TestProxyMode:
    def test_downstream_share_forwarded_upstream_and_accepted(self):
        """downstream e1 = upstream_e1 ‖ prefix, upstream e2 = prefix ‖
        downstream e2: the mock pool rebuilds the coinbase with its own
        extranonce1 and must accept the forwarded share."""

        async def main():
            pool = MockStratumPool(difficulty=EASY)
            await pool.start()
            await pool.announce_job(make_pool_job())
            server = make_server()
            proxy = UpstreamProxy(server, StratumClient(
                "127.0.0.1", pool.port, "proxyuser"))
            await server.start()
            up_task = asyncio.create_task(proxy.run())
            try:
                await wait_until(lambda: server.current_job is not None,
                                 "no upstream job")
                assert server.extranonce1_base == pool.extranonce1
                assert server.total_extranonce2_size == pool.extranonce2_size
                c = await MiniClient(server.port).connect()
                e1, e2size = await c.handshake()
                assert e1.startswith(pool.extranonce1)
                assert e2size == pool.extranonce2_size - 2
                job = server.current_job
                e2 = (3).to_bytes(e2size, "little")
                reply = await c.submit(job.job_id, e2, job.ntime,
                                       find_nonce(job, e1, e2, EASY))
                assert reply["result"] is True
                await asyncio.wait_for(pool.share_seen.wait(), 15)
                share = pool.shares[0]
                assert share.accepted, share.reason
                assert share.extranonce2 == e1[len(pool.extranonce1):] + e2
                await wait_until(lambda: proxy.upstream_accepted >= 1,
                                 "no upstream verdict")
                assert proxy.forwarded == 1
                c.close()
            finally:
                proxy.stop()
                up_task.cancel()
                await asyncio.gather(up_task, return_exceptions=True)
                await server.stop()
                await pool.stop()

        run(main())


class TestFabricProxyMode:
    def test_frontend_survives_upstream_death(self):
        """Kill the active upstream: the downstream fleet is re-based onto
        the survivor (new carve, new namespaced job), and shares go to the
        pool that announced their job, before and after."""

        async def main():
            pool1 = ChaosStratumPool(difficulty=EASY)
            await pool1.start()
            await pool1.announce_job(make_pool_job("a1"))
            pool2 = ChaosStratumPool(difficulty=EASY,
                                     extranonce1=bytes.fromhex("beadfeed"))
            await pool2.start()
            await pool2.announce_job(make_pool_job("b1"))
            server = make_server()
            fabric = PoolFabric(
                [parse_pool_spec(f"stratum+tcp://127.0.0.1:{pool1.port}#w=8"),
                 parse_pool_spec(f"stratum+tcp://127.0.0.1:{pool2.port}")],
                username="proxyuser", telemetry=server.telemetry,
                route_interval_s=0.5, stall_after_s=2.0,
                reconnect_base_delay=0.05, reconnect_max_delay=0.2,
                request_timeout=3.0,
            )
            proxy = FabricUpstreamProxy(server, fabric)
            await server.start()
            up_task = asyncio.create_task(proxy.run())
            try:
                await wait_until(
                    lambda: server.current_job is not None
                    and server.extranonce1_base == pool1.extranonce1,
                    "no job from pool 1")
                assert server.current_job.job_id == "p0/a1"
                c = await MiniClient(server.port).connect()
                e1, e2size = await c.handshake()
                assert e1.startswith(pool1.extranonce1)
                job = server.current_job
                e2 = (3).to_bytes(e2size, "little")
                reply = await c.submit(job.job_id, e2, job.ntime,
                                       find_nonce(job, e1, e2, EASY))
                assert reply["result"] is True
                await wait_until(lambda: proxy.upstream_accepted >= 1,
                                 "no verdict from pool 1")
                assert pool1.shares and pool1.shares[0].accepted
                # The forward went through the slot: its window and
                # in-flight count saw the verdict.
                slot0 = fabric.slots[0]
                assert slot0.window.snapshot()["events"] >= 1
                assert slot0.inflight == 0
                pool1.kill()
                await wait_until(
                    lambda: server.extranonce1_base == pool2.extranonce1
                    and server.current_job is not None
                    and server.current_job.job_id.startswith("p1/"),
                    "no failover to pool 2")
                assert fabric.failovers >= 1
                session = next(s for s in server.sessions.values()
                               if not s.internal)
                job2 = server.current_job
                e2b = (5).to_bytes(session.extranonce2_size, "little")
                reply = await c.submit(
                    job2.job_id, e2b, job2.ntime,
                    find_nonce(job2, session.extranonce1, e2b, EASY))
                assert reply["result"] is True
                await wait_until(lambda: proxy.upstream_accepted >= 2,
                                 "no verdict from pool 2")
                assert pool2.shares and pool2.shares[-1].accepted
                assert all(s.job_id in pool1.jobs for s in pool1.shares)
                assert all(s.job_id in pool2.jobs for s in pool2.shares)
                # A share of the superseded upstream's job is dropped.
                before = proxy.dropped_cross_upstream
                await proxy._on_downstream_accept(session, job, e2, job.ntime,
                                                  1, None, 0)
                assert proxy.dropped_cross_upstream == before + 1
                c.close()
            finally:
                proxy.stop()
                up_task.cancel()
                await asyncio.gather(up_task, return_exceptions=True)
                await server.stop()
                await pool1.stop()
                await pool2.stop()

        run(main())


# --------------------------------------------------------------- vardiff
class TestVardiff:
    """Retargets under a scripted clock (the server module's ``time``),
    so no test waits out a window."""

    def test_off_by_default(self):
        assert make_server().vardiff_interval_s == 0.0

    def _client(self, server, clock, monkeypatch):
        monkeypatch.setattr(port_server, "time", clock)
        return internal_session_with_writer(server)

    def test_fast_claimer_retargeted_up_bounded(self, monkeypatch):
        clock = ScriptedTime()
        server = make_server(difficulty=TRIVIAL, vardiff_interval_s=1.0,
                             vardiff_target_spm=60.0, vardiff_max_step=4.0)
        session, writer = self._client(server, clock, monkeypatch)
        asyncio.run(server.set_job(make_fjob()))
        writer.out.clear()
        for i in range(30):
            reply = server._dispatch(session, _submit_msg(session, i, i))
            assert reply == b'{"id":9,"result":true,"error":null}\n'
            clock.t += 0.01
        clock.t += 1.1
        server._dispatch(session, _submit_msg(session, 40, 40))
        assert session.difficulty == pytest.approx(4.0 * TRIVIAL)
        pushes = [json.loads(line) for line in writer.out]
        assert pushes[-1]["method"] == "mining.set_difficulty"
        assert pushes[-1]["params"][0] == pytest.approx(4.0 * TRIVIAL)

    def test_slow_claimer_stepped_down_not_freefall(self, monkeypatch):
        clock = ScriptedTime()
        server = make_server(difficulty=TRIVIAL, min_difficulty=TRIVIAL,
                             vardiff_interval_s=0.3,
                             vardiff_target_spm=6000.0, vardiff_max_step=4.0)
        session, writer = self._client(server, clock, monkeypatch)
        asyncio.run(server.set_job(make_fjob()))
        server._dispatch(session, {"id": 5,
                                   "method": "mining.suggest_difficulty",
                                   "params": [64.0 * TRIVIAL]})
        assert session.difficulty == pytest.approx(64.0 * TRIVIAL)
        server._dispatch(session, _submit_msg(session, 1, 1))
        clock.t += 0.35
        server._dispatch(session, _submit_msg(session, 2, 2))
        assert session.difficulty == pytest.approx(16.0 * TRIVIAL)
        assert session.difficulty >= server.min_difficulty

    def test_internal_sessions_are_never_retargeted(self, monkeypatch):
        clock = ScriptedTime()
        monkeypatch.setattr(port_server, "time", clock)
        server = make_server(difficulty=TRIVIAL, vardiff_interval_s=0.1,
                             vardiff_target_spm=6000.0)
        session = internal_session(server)
        asyncio.run(server.set_job(make_fjob()))
        for i in range(5):
            server._dispatch(session, _submit_msg(session, i, i))
            clock.t += 1.0
        assert session.difficulty == TRIVIAL
        assert session.vardiff_anchor is None


class FakeWriter:
    """A transport stand-in: records each write."""

    def __init__(self) -> None:
        self.out = []
        self.closed = False
        self.transport = SimpleNamespace(get_write_buffer_size=lambda: 0)

    def write(self, data: bytes) -> None:
        self.out.append(bytes(data))

    def close(self) -> None:
        self.closed = True


def internal_session_with_writer(server, peer="peer"):
    """A subscribed and authorized session on a :class:`FakeWriter`, as
    ``_serve`` makes one (greeted)."""
    writer = FakeWriter()
    mod = sys.modules[type(server).__module__]
    session = mod.ClientSession(next(server._ids), peer, writer)
    server.sessions[session.conn_id] = session
    server._downstream += 1
    server._dispatch(session, {"id": 1, "method": "mining.subscribe",
                               "params": []})
    server._dispatch(session, {"id": 2, "method": "mining.authorize",
                               "params": ["w", "x"]})
    server._greet(session)
    return session, writer


def _submit_msg(session, e2: int, nonce: int, job_id="j1", ntime=0x655F2B2C,
                req_id=9, extra=()):
    return {"id": req_id, "method": "mining.submit", "params": [
        "w", job_id, e2.to_bytes(session.extranonce2_size, "little").hex(),
        f"{ntime:08x}", f"{nonce:08x}", *extra]}


# ------------------------------------------------ the port vs the reference
def _stream(seed: int):
    """The seeded steps of the parity stream, ``(kind, seconds the clock
    advances first, a seeded int)``: every kind once, the rest drawn with
    valid shares the most common, in a seeded order."""
    rng = np.random.default_rng(1500 + seed)
    others = ["low", "stale", "bad_e2", "vbits", "dup", "malformed",
              "str_id", "suggest", "unknown", "newjob", "retarget",
              "notjson"]
    pool = ["valid"] * 8 + others
    kinds = ["valid", *others,
             *(pool[int(i)] for i in rng.integers(len(pool), size=57))]
    rng.shuffle(kinds)
    return [(kind, float(rng.choice([0.05, 0.5, 2.0, 9.0])),
             int(rng.integers(1 << 30))) for kind in kinds]


def _drive(mod, pipeline, jobs, native_validation, steps, monkeypatch):
    """Feed ``steps`` to one package's server; returns everything it
    said and counted. The messages are built from this server's own
    state, which both packages must share step for step."""
    clock = ScriptedTime()
    monkeypatch.setattr(mod, "time", clock)
    tel = pipeline.PipelineTelemetry()
    server = mod.StratumPoolServer(
        difficulty=EASY, telemetry=tel, native_validation=native_validation,
        vardiff_interval_s=5.0, vardiff_target_spm=20.0,
        invalid_share_budget=10 ** 6, malformed_budget=10 ** 6)
    session, writer = internal_session_with_writer(server)
    asyncio.run(server.set_job(make_fjob("j1", jobs=jobs)))
    trail = [writer.out[:]]
    writer.out.clear()
    accepted = []
    jobs_made = 1
    for i, (kind, advance, r) in enumerate(steps):
        clock.t += advance
        job = server.current_job
        e2 = 1000 + i
        e2b = e2.to_bytes(session.extranonce2_size, "little")
        reply = None
        if kind in ("valid", "str_id", "low"):
            nonce = find_nonce(job, session.extranonce1, e2b,
                               session.difficulty,
                               want_valid=kind != "low", start=r)
            msg = _submit_msg(session, e2, nonce, job.job_id, job.ntime,
                              req_id="s%d" % i if kind == "str_id" else i)
            reply = server._dispatch(session, msg)
            if kind != "low":
                accepted.append(msg)
        elif kind == "dup" and accepted:
            reply = server._dispatch(session, accepted[r % len(accepted)])
        elif kind == "stale":
            reply = server._dispatch(session, _submit_msg(
                session, e2, r, "gone", job.ntime, i))
        elif kind == "bad_e2":
            msg = _submit_msg(session, e2, r, job.job_id, job.ntime, i)
            msg["params"][2] += "00"
            reply = server._dispatch(session, msg)
        elif kind == "vbits":
            reply = server._dispatch(session, _submit_msg(
                session, e2, r, job.job_id, job.ntime, i,
                extra=("00200000",)))
        elif kind == "malformed":
            reply = server._dispatch(session, {
                "id": i, "method": "mining.submit",
                "params": ["w", job.job_id, "zz", "x", "y"]})
        elif kind == "suggest":
            reply = server._dispatch(session, {
                "id": i, "method": "mining.suggest_difficulty",
                "params": [EASY * (0.25, 1.0, 2.0)[r % 3]]})
        elif kind == "unknown":
            reply = server._dispatch(session, {"id": i,
                                               "method": "mining.wat"})
        elif kind == "newjob":
            jobs_made += 1
            asyncio.run(server.set_job(make_fjob(
                f"j{jobs_made}", clean=bool(r % 2), jobs=jobs)))
        elif kind == "retarget":
            asyncio.run(server.set_difficulty(EASY * (1.0, 2.0)[r % 2]))
        elif kind == "notjson":
            server._count_malformed(session, "bad json")
        if reply is not None and type(reply) is not bytes:
            reply = jobs.encode_line(reply)
        trail.append((kind, reply, writer.out[:], session.difficulty))
        writer.out.clear()
    return {
        "trail": trail,
        "verdicts": verdicts(tel),
        "work": (server.claimed_work, server.accepted_work, server.submits),
        "session": (session.accepted, session.invalid, session.malformed,
                    session.consecutive_invalid),
        "accounting": session.accounting.snapshot(),
        "validations": tel.frontend_validate.count,
        "encodes": tel.frontend_broadcast_encodes.value,
        "snapshot": server.snapshot(),
    }


class TestReferenceParity:
    """One seeded submit stream — every verdict class, duplicates,
    malformed frames, suggestions, job switches and retargets, with the
    scripted clock driving vardiff — into the reference's server and the
    port's, each with the hashlib validator and with the native one."""

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_stream_matches_reference(self, seed, monkeypatch):
        steps = _stream(seed)
        modes = [False, True] if HAVE_GXX else [False]
        runs = {}
        for nv in modes:
            runs[("port", nv)] = _drive(port_server, port_pipeline,
                                        port_jobs, nv, steps, monkeypatch)
            runs[("ref", nv)] = _drive(ref_server, ref_pipeline, ref_jobs,
                                       nv, steps, monkeypatch)
        want = runs[("ref", False)]
        for key, got in runs.items():
            for field in want:
                assert got[field] == want[field], (key, field)
        # The stream is worth comparing: retargets happened both ways,
        # and every verdict class was seen.
        pushed = [json.loads(line)["params"][0]
                  for _kind, _r, out, _d in want["trail"][1:] for line in out
                  if b"set_difficulty" in line]
        assert any(d > EASY for d in pushed)
        assert set(want["verdicts"]) >= {"accepted", "low_difficulty",
                                         "stale", "bad_extranonce2",
                                         "version_bits", "malformed"}


# ------------------------------------------------------- internal worker
class TestInternalWorker:
    def test_internal_shares_validated_and_accounted(self):
        async def main():
            server = make_server(difficulty=EASY)
            await server.start()
            iw = InternalWorker(server, CpuHasher(), n_workers=1,
                                batch_size=1 << 10)
            await server.set_job(make_fjob())
            run_task = asyncio.create_task(iw.run())
            try:
                await wait_until(lambda: iw.session.accepted >= 1,
                                 "internal worker found no share", 60)
            finally:
                iw.stop()
                run_task.cancel()
                await asyncio.gather(run_task, return_exceptions=True)
                await server.stop()
            assert verdicts(server.telemetry).get("accepted", 0) >= 1
            assert iw.session.invalid == 0
            stats = iw.dispatcher.stats
            assert stats.hw_errors == 0
            assert stats.shares_accepted == iw.session.accepted
            assert stats.shares_rejected == 0

        run(main())

    def test_lifecycle_joins_the_dispatcher_and_frontend_hops(self):
        async def main():
            server = make_server(difficulty=EASY)
            iw = InternalWorker(server, CpuHasher(), n_workers=1,
                                batch_size=1 << 10)
            await server.set_job(make_fjob())
            run_task = asyncio.create_task(iw.run())
            try:
                await wait_until(lambda: iw.session.accepted >= 1,
                                 "internal worker found no share", 60)
            finally:
                iw.stop()
                run_task.cancel()
                await asyncio.gather(run_task, return_exceptions=True)
            records = server.telemetry.lifecycle.dump_dict()["records"]
            hops = [[h["hop"] for h in rec["hops"]] for rec in records]
            assert any(h[-2:] == ["downstream_submit", "frontend_validate"]
                       and len(h) > 2 for h in hops), hops

        run(main())

    def test_tile_hasher_behind_upstream_proxy(self):
        """The internal worker on ``TileCudaHasher(device="cpu")`` behind
        ``UpstreamProxy``: the port's validating mock pool accepts every
        forwarded share, each in the internal worker's slice."""

        async def main():
            pool = MockStratumPool(difficulty=1 / (1 << 20))
            await pool.start()
            await pool.announce_job(make_pool_job())
            server = make_server()
            proxy = UpstreamProxy(server, StratumClient(
                "127.0.0.1", pool.port, "proxyuser"))
            hasher = TileCudaHasher(batch_size=1 << 12, device="cpu")
            iw = InternalWorker(server, hasher, n_workers=1,
                                batch_size=1 << 12)
            frontend = PoolFrontend(server, "127.0.0.1", 0, proxy=proxy,
                                    internal_worker=iw)
            task = asyncio.create_task(frontend.run())
            try:
                await wait_until(lambda: proxy.upstream_accepted >= 3,
                                 "no forwarded share accepted", 60)
            finally:
                frontend.stop()
                await task
            assert pool.shares and all(s.accepted for s in pool.shares)
            prefix = iw.session.extranonce1[len(pool.extranonce1):]
            assert iw.session.extranonce1.startswith(pool.extranonce1)
            assert all(s.extranonce2.startswith(prefix) for s in pool.shares)
            assert proxy.upstream_rejected == 0
            assert iw.dispatcher.stats.hw_errors == 0
            assert frontend.stats is iw.dispatcher.stats
            assert frontend.hasher is hasher and frontend.fabric is None

        run(main())

    def test_dead_card_is_logged_and_mining_resumes(self, caplog):
        """A scan that raises (the card dies) is logged at ERROR with its
        exception and the dispatcher restarts its pipeline, as in every
        session mode; the frontend keeps serving, and once the card is
        back the internal worker's shares are accepted again."""

        async def main():
            server = make_server()
            chaos = ChaosHasher(CpuHasher(), label="c0")
            iw = InternalWorker(server, chaos, n_workers=1,
                                batch_size=1 << 10)
            frontend = PoolFrontend(server, "127.0.0.1", 0,
                                    local_source=LocalTemplateSource(),
                                    job_interval_s=30.0, internal_worker=iw)
            task = asyncio.create_task(frontend.run())
            try:
                await wait_until(lambda: server.current_job is not None,
                                 "no job installed", 60)
                chaos.kill()
                await wait_until(lambda: any(
                    r.exc_info and isinstance(r.exc_info[1], ChaosError)
                    for r in caplog.records),
                    "the dead card's error was not logged", 60)
                assert not task.done()
                chaos.revive()
                accepted = iw.session.accepted
                await wait_until(lambda: iw.session.accepted > accepted,
                                 "no share after the card came back", 60)
            finally:
                frontend.stop()
                await task

        with caplog.at_level("ERROR", logger="bitcoin_miner_tpu_torch"):
            run(main())

    def test_failed_internal_worker_ends_the_run(self, caplog):
        """An internal worker whose run fails ends ``PoolFrontend.run``
        with that exception, logged, and the listener closed: the
        frontend does not go on serving a slice that nothing mines."""

        async def main():
            server = make_server()
            iw = InternalWorker(server, ChaosHasher(CpuHasher()),
                                n_workers=1, batch_size=1 << 10)

            async def dispatcher_dies(on_share):
                await asyncio.sleep(0.05)
                raise ChaosError("chip c0 dead")

            iw.dispatcher.run = dispatcher_dies
            frontend = PoolFrontend(server, "127.0.0.1", 0,
                                    local_source=LocalTemplateSource(),
                                    job_interval_s=30.0, internal_worker=iw)
            with pytest.raises(ChaosError, match="chip c0 dead"):
                await frontend.run()
            assert server._stopping

        with caplog.at_level("ERROR", logger="bitcoin_miner_tpu_torch"):
            run(main())
        assert any("poolserver-internal failed" in r.getMessage()
                   for r in caplog.records)

    def test_dead_card_at_a_job_switch_ends_the_run(self, caplog):
        """A card that is dead when a job arrives fails the job's
        install (the hasher's version mask): the template loop's
        exception ends ``PoolFrontend.run`` instead of leaving a
        listener whose job stream has stopped."""

        async def main():
            server = make_server()
            chaos = ChaosHasher(CpuHasher(), label="c0")
            chaos.kill()
            iw = InternalWorker(server, chaos, n_workers=1,
                                batch_size=1 << 10)
            frontend = PoolFrontend(server, "127.0.0.1", 0,
                                    local_source=LocalTemplateSource(),
                                    job_interval_s=30.0, internal_worker=iw)
            with pytest.raises(ChaosError, match="chip c0 dead"):
                await frontend.run()
            assert server._stopping

        with caplog.at_level("ERROR", logger="bitcoin_miner_tpu_torch"):
            run(main())
        assert any("poolserver-template failed" in r.getMessage()
                   for r in caplog.records)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _serve_args(tmp_path, *extra):
    return cli.build_parser().parse_args([
        "--serve-pool", "127.0.0.1:0", "--flightrec-out",
        str(tmp_path / "fr.json"), "--incident-dir", str(tmp_path / "inc"),
        *extra])


class TestCommandLine:
    def test_defaults_are_the_references(self, tmp_path):
        from bitcoin_miner_tpu.cli import build_parser as ref_parser

        ref = ref_parser().parse_args(["--serve-pool", "127.0.0.1:0"])
        frontend = cli.make_frontend(_serve_args(tmp_path))
        server = frontend.server
        assert server.difficulty == ref.serve_difficulty
        assert server.total_extranonce2_size == ref.serve_extranonce2_size
        assert server.allocator.prefix_bytes == ref.serve_prefix_bytes
        assert frontend.job_interval_s == ref.serve_job_interval
        assert server.vardiff_interval_s == 0.0
        assert cli.SERVE_DEFAULTS["serve_vardiff_interval"] == \
            ref.serve_vardiff_interval
        assert isinstance(frontend.local_source, LocalTemplateSource)
        assert frontend.internal_worker is None and frontend.port == 0
        args = _serve_args(tmp_path)
        assert cli._serve_option(args, "serve_shards") == \
            ref.serve_shards == 0

    def test_flags_reach_the_server(self, tmp_path):
        frontend = cli.make_frontend(_serve_args(
            tmp_path, "--serve-difficulty", "0.5",
            "--serve-extranonce2-size", "6", "--serve-prefix-bytes", "3",
            "--serve-job-interval", "5", "--serve-vardiff", "12",
            "--serve-vardiff-interval", "7"))
        server = frontend.server
        assert (server.difficulty, server.total_extranonce2_size,
                server.allocator.prefix_bytes, frontend.job_interval_s,
                server.vardiff_interval_s, server.vardiff_target_spm) == (
                    0.5, 6, 3, 5.0, 7.0, 12.0)

    def test_upstreams_pick_the_proxy(self, tmp_path):
        one = cli.make_frontend(_serve_args(
            tmp_path, "--upstream", "stratum+tcp://127.0.0.1:3999"))
        assert isinstance(one.proxy, UpstreamProxy)
        assert (one.proxy.client.host, one.proxy.client.port) == (
            "127.0.0.1", 3999)
        two = cli.make_frontend(_serve_args(
            tmp_path, "--upstream", "stratum+tcp://127.0.0.1:3999#w=2",
            "--upstream", "stratum+tcp://127.0.0.1:4000"))
        assert isinstance(two.proxy, FabricUpstreamProxy)
        assert two.fabric is two.proxy.fabric
        assert [s.spec.weight for s in two.fabric.slots] == [2.0, 1.0]

    @pytest.mark.parametrize("argv,match", [
        (["--serve-shards", "2"], "needs an explicit port"),
        (["--serve-difficulty", "0"], "must be > 0"),
        (["--serve-vardiff", "-1"], "must be > 0"),
        (["--serve-prefix-bytes", "4"], "extranonce2_size"),
        (["--upstream", "http://127.0.0.1:1"], "stratum"),
        (["--upstream", "getwork+http://a:1", "--upstream", "stratum+tcp://b:2"],
         "multi-upstream"),
        (["--checkpoint", "x"], "--checkpoint applies only"),
        (["--suggest-difficulty", "2"], "applies only to --pool"),
    ])
    def test_refusals(self, tmp_path, argv, match):
        with pytest.raises(SystemExit, match=match):
            cli.make_frontend(_serve_args(tmp_path, *argv))

    @pytest.mark.parametrize("argv", [
        ["--pool", "stratum+tcp://a:1", "--upstream", "stratum+tcp://b:2"],
        ["--pool", "stratum+tcp://a:1", "--internal-worker"],
        ["--gbt", "http://a:1", "--serve-difficulty", "2"],
        ["--bench", "--serve-vardiff", "6"],
    ])
    def test_other_modes_refuse_the_serve_flags(self, argv):
        args = cli.build_parser().parse_args(argv)
        with pytest.raises(SystemExit, match="applies only to --serve-pool"):
            if args.pool:
                cli.make_miner(args)
            elif args.gbt:
                cli.make_gbt_miner(args)
            else:
                cli.bench(args)

    @pytest.mark.skipif(torch.cuda.is_available(), reason="a card is here")
    def test_internal_worker_needs_a_card_or_device_cpu(self, tmp_path):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.make_frontend(_serve_args(tmp_path, "--internal-worker"))

    @NATIVE
    def test_native_backend_runs_on_the_host(self, tmp_path):
        frontend = cli.make_frontend(_serve_args(
            tmp_path, "--internal-worker", "--backend", "native",
            "--batch-bits", "12"))
        assert frontend.hasher.name == "native"

    def test_vshare_internal_worker_runs_chain_zero(self, tmp_path, caplog):
        """The frontend grants no version mask, so ``--vshare 2`` on the
        internal worker degrades to chain 0 (the K=1 build on the card),
        and its shares carry no version bits: all accepted."""
        frontend = cli.make_frontend(_serve_args(
            tmp_path, "--internal-worker", "--device", "cpu", "--vshare",
            "2", "--batch-bits", "12", "--workers", "1",
            "--serve-difficulty", str(EASY)))
        hasher = frontend.hasher
        assert isinstance(hasher, TileCudaHasher) and hasher._vshare == 2
        iw = frontend.internal_worker

        async def main():
            task = asyncio.create_task(frontend.run())
            try:
                await wait_until(lambda: iw.session.accepted >= 3,
                                 "no internal share accepted", 60)
            finally:
                frontend.stop()
                await task

        with caplog.at_level("ERROR"):
            run(main())
        assert any("cannot carry vshare=2" in r.getMessage()
                   for r in caplog.records)
        assert hasher.version_roll_bits == 0
        job = iw.dispatcher._job
        header76 = job.header76(b"\x00" * job.extranonce2_size)
        assert hasher._job_constants(header76, job.share_target).chains == 1
        assert iw.session.invalid == 0

    def test_cli_session_accepts_its_own_shares(self, tmp_path):
        """``--serve-pool 127.0.0.1:0 --internal-worker --device cpu``
        through ``run_session``: its shares accepted by its own frontend,
        ``/healthz`` with a ``frontend`` component, the frontend families
        on ``/metrics``, and the frontend objectives reading data."""
        status = _free_port()
        args = _serve_args(
            tmp_path, "--internal-worker", "--device", "cpu",
            "--batch-bits", "12", "--workers", "2",
            "--serve-difficulty", "0.0000000596", "--status-port",
            str(status), "--health-interval", "0.2", "--report-interval",
            "1")
        frontend = cli.make_frontend(args)

        async def get(path):
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           status)
            writer.write(f"GET {path} HTTP/1.1\r\n\r\n".encode())
            await writer.drain()
            raw = await asyncio.wait_for(reader.read(), 10)
            writer.close()
            return raw.partition(b"\r\n\r\n")[2]

        async def main():
            task = asyncio.create_task(cli.run_session(frontend, args))
            iw = frontend.internal_worker
            try:
                await wait_until(lambda: iw.session.accepted >= 20,
                                 "no internal share accepted", 60)
                for _ in range(300):
                    slo = json.loads(await get("/slo"))
                    states = {o["name"]: o["state"]
                              for o in slo["objectives"]}
                    if states["frontend-validate"] != "no_data":
                        break
                    await asyncio.sleep(0.05)
                health = json.loads(await get("/healthz"))
                metrics = (await get("/metrics")).decode()
            finally:
                frontend.stop()
                await task
            return states, health, metrics

        states, health, metrics = run(main())
        assert states["frontend-validate"] != "no_data"
        assert health["components"]["frontend"]["state"] == "ok"
        assert 'tpu_miner_frontend_shares_total{result="accepted"}' in metrics
        assert "tpu_miner_frontend_validate_seconds_count" in metrics
        assert frontend.server.port != 0
        stats = frontend.stats
        assert stats.shares_accepted == frontend.internal_worker.session.accepted
        assert stats.hw_errors == 0 and stats.shares_rejected == 0


def _sharded_args(tmp_path, *extra, address="127.0.0.1:3999"):
    return cli.build_parser().parse_args([
        "--serve-pool", address, "--serve-shards", "3",
        "--flightrec-out", str(tmp_path / "fr.json"), "--incident-dir",
        str(tmp_path / "inc"), *extra])


class TestShardedCommandLine:
    """``--serve-shards N``: the supervisor and its refusals, as the
    reference's ``_cmd_serve_pool_sharded`` builds and refuses them."""

    def test_shards_build_the_supervisor(self, tmp_path):
        sup = cli.make_frontend(_sharded_args(
            tmp_path, "--status-port", "9100", "--serve-difficulty", "0.5",
            "--serve-extranonce2-size", "6", "--serve-prefix-bytes", "3",
            "--serve-job-interval", "5", "--serve-vardiff", "12",
            "--upstream", "stratum+ssl://pool.example:4000", "--user", "u",
            "--tls-no-verify", "--health-interval", "2"))
        assert isinstance(sup, ShardSupervisor) and sup.shard_supervisor \
            is sup
        cfgs = sup.configs
        assert [(c.index, c.n_shards, c.status_port) for c in cfgs] == [
            (0, 3, 9101), (1, 3, 9102), (2, 3, 9103)]
        c = cfgs[0]
        assert (c.host, c.port, c.difficulty, c.extranonce2_size,
                c.prefix_bytes, c.job_interval_s, c.health_interval_s,
                c.vardiff_target_spm, c.vardiff_interval_s) == (
                    "127.0.0.1", 3999, 0.5, 6, 3, 5.0, 2.0, 12.0, 30.0)
        assert (c.upstream_host, c.upstream_port, c.upstream_tls,
                c.upstream_tls_verify, c.username) == (
                    "pool.example", 4000, True, False, "u")
        assert c.slo_objectives_path is None

    @pytest.mark.parametrize("available,expected", [(True, True),
                                                    (False, None)])
    def test_children_load_the_parents_validator(self, tmp_path,
                                                 monkeypatch, available,
                                                 expected):
        """Where the parent loads the native validator every child must
        load it (a divergence: the reference's children fall back to
        hashlib unseen); without it each child probes, as the
        reference's do."""
        from bitcoin_miner_tpu_torch.backends import native

        monkeypatch.setattr(native, "native_available", lambda: available)
        sup = cli.make_frontend(_sharded_args(tmp_path))
        assert [c.native_validation for c in sup.configs] == [expected] * 3

    @pytest.mark.parametrize("n", ["0", "1"])
    def test_one_shard_is_one_process(self, tmp_path, n):
        frontend = cli.make_frontend(_serve_args(tmp_path, "--serve-shards",
                                                 n))
        assert isinstance(frontend, PoolFrontend)

    def test_port_zero_is_refused(self, tmp_path):
        """The port binds ``HOST:0`` as an ephemeral port (a divergence);
        every shard must bind one address, so shards refuse it. (The
        reference reads ``HOST:0`` as its default port 3334.)"""
        with pytest.raises(SystemExit, match="needs an explicit port"):
            cli.make_frontend(_sharded_args(tmp_path,
                                            address="127.0.0.1:0"))

    @pytest.mark.parametrize("argv,match", [
        (["--upstream", "stratum+tcp://a:1", "--upstream",
          "stratum+tcp://b:2"], "multiple --upstream"),
        (["--internal-worker"], "--internal-worker"),
        (["--upstream", "http://a:1"], "stratum"),
    ], ids=["several-upstreams", "internal-worker", "scheme"])
    def test_refusals_are_the_references(self, tmp_path, argv, match):
        from bitcoin_miner_tpu.cli import main as ref_main

        with pytest.raises(SystemExit, match=match):
            cli.make_frontend(_sharded_args(tmp_path, *argv))
        with pytest.raises(SystemExit, match=match):
            ref_main(["--serve-pool", "127.0.0.1:3999", "--serve-shards",
                      "3", "--flightrec-out", str(tmp_path / "ref.json"),
                      *argv])

    def test_more_shards_than_prefixes_fails_at_the_cli(self, tmp_path):
        with pytest.raises(SystemExit, match="empty"):
            cli.make_frontend(_sharded_args(
                tmp_path, "--serve-prefix-bytes", "1", "--serve-shards",
                "300"))

    def test_run_session_picks_up_the_shard_supervisor(self, tmp_path,
                                                       capsys):
        """``run_session`` over a supervisor whose children are local
        HTTP stubs (no process spawned): ``/telemetry`` carries
        ``frontend_shards``, ``/metrics`` the children's samples labelled
        ``shard``, ``/healthz`` the ``frontend_shard`` component, the
        observatory scrapes each child as ``shard-<i>``, and ``top``
        renders its per-shard panel from those series as the reference's
        dashboard does."""
        from bitcoin_miner_tpu.telemetry import dashboard as ref_dashboard
        from bitcoin_miner_tpu_torch.telemetry import dashboard
        from tests.test_torch_shard import FakeCtx, _StubChild

        children = [_StubChild(
            f"tpu_miner_frontend_sessions {i + 2}\n"
            f'tpu_miner_frontend_shares_total{{result="accepted"}} {7 * i}\n')
            for i in range(2)]
        status = _free_port()
        args = cli.build_parser().parse_args([
            "--serve-pool", "127.0.0.1:3999", "--serve-shards", "2",
            "--status-port", str(status), "--health-interval", "0.2",
            "--report-interval", "1", "--flightrec-out",
            str(tmp_path / "fr.json"), "--incident-dir",
            str(tmp_path / "inc")])
        sup = cli.make_frontend(args)
        sup.configs = [dataclasses.replace(c, status_port=child.port)
                       for c, child in zip(sup.configs, children)]
        sup._ctx = FakeCtx()
        sup.liveness_interval_s = 0.1

        async def get(path):
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           status)
            writer.write(f"GET {path} HTTP/1.1\r\n\r\n".encode())
            await writer.drain()
            raw = await asyncio.wait_for(reader.read(), 10)
            writer.close()
            return raw.partition(b"\r\n\r\n")[2]

        async def main():
            task = asyncio.create_task(cli.run_session(sup, args))
            try:
                await wait_until(
                    lambda: {s.state for s in sup._shards.values()}
                    == {"serving"}, "shards serving", 20)
                for _ in range(200):
                    query = json.loads(await get(
                        "/query?name=tpu_miner_frontend_sessions"))
                    procs = {s["labels"].get("process")
                             for s in query["series"]}
                    if {"shard-0", "shard-1"} <= procs:
                        break
                    await asyncio.sleep(0.05)
                for _ in range(100):
                    health = json.loads(await get("/healthz"))
                    if "frontend_shard" in health["components"]:
                        break
                    await asyncio.sleep(0.05)
                telemetry = json.loads(await get("/telemetry"))
                metrics = (await get("/metrics")).decode()
                query = json.loads(await get("/query?window_s=60"))
                loop = asyncio.get_running_loop()
                rc = await loop.run_in_executor(None, cli.main, [
                    "top", "--status-url", f"http://127.0.0.1:{status}",
                    "--once", "--window", "60"])
            finally:
                sup.stop()
                await asyncio.wait_for(task, 30)
            return telemetry, metrics, health, query, rc

        try:
            telemetry, metrics, health, query, rc = run(main())
        finally:
            for child in children:
                child.close()
        shards = telemetry["frontend_shards"]
        assert shards["n_shards"] == 2 and shards["port"] == 3999
        assert [s["prefix_range"] for s in shards["shards"]] == [
            [0, 32768], [32768, 65536]]
        assert 'tpu_miner_frontend_sessions{shard="1"} 3' in metrics
        assert 'tpu_miner_frontend_shard_state{shard="0"} 1' in metrics
        assert health["components"]["frontend_shard"]["state"] == "ok"
        top = capsys.readouterr().out
        assert rc == 0 and "frontend (per process):" in top
        assert "shard-0" in top and "shard-1" in top
        assert dashboard.render_top(query) == \
            ref_dashboard.render_top(query)
        assert {s.state for s in sup._shards.values()} == {"down"}


# ----------------------------------------------------- health component
class TestFrontendHealth:
    def test_invalid_only_window_degrades(self):
        model = HealthModel(PipelineTelemetry(), clock=lambda: 0.0)
        base = {
            "batches": 0, "active_scans": 0, "gap_count": 0,
            "gap_sum": 0.0, "ring_occupancy": 0, "ring_collects": 0,
            "stream_window": 0, "rpc_responses": 0, "rpc_errors": 0,
            "submits_inflight": 0, "pool_acks": {}, "chips": {},
        }
        assert "frontend" not in model.evaluate(dict(base), now=0.0)
        snap = dict(base, frontend_sessions=3,
                    frontend_shares={"accepted": 5.0})
        assert model.evaluate(snap, now=1.0)["frontend"].state == OK
        snap = dict(base, frontend_sessions=3,
                    frontend_shares={"accepted": 5.0, "low_difficulty": 9.0})
        report = model.evaluate(snap, now=2.0)
        assert report["frontend"].state == DEGRADED
        assert "invalid" in report["frontend"].reason
        snap = dict(base, frontend_sessions=3,
                    frontend_shares={"accepted": 8.0, "low_difficulty": 10.0})
        assert model.evaluate(snap, now=3.0)["frontend"].state == OK

    def test_live_server_reports_frontend_ok(self):
        async def main():
            server = make_server(difficulty=TRIVIAL)
            await server.start()
            job = make_fjob()
            await server.set_job(job)
            model = HealthModel(server.telemetry)
            c = await MiniClient(server.port).connect()
            _e1, e2size = await c.handshake()
            await c.submit("j1", (1).to_bytes(e2size, "little"),
                           job.ntime, 7)
            assert model.evaluate()["frontend"].state == "ok"
            c.close()
            await server.stop()

        run(main())
