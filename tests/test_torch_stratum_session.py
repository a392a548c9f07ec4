"""The rest of the Stratum session on the CPU, against the JAX package's
validating mock pool and the PyTorch package's: failover with rotation
that wraps, stratum+ssl with and without certificate checks, a suggested
difficulty, cross-host redirects, the host partition of the extranonce2
space, and the command line's new modes and flags with their defaults and
refusals."""

import asyncio
import json
import ssl
import subprocess

import numpy as np
import pytest
import torch

# The miner package first: importing the protocol package first is circular.
from bitcoin_miner_tpu.miner import runner as _ref_runner  # noqa: F401
from bitcoin_miner_tpu.parallel import ranges as ref_ranges
from bitcoin_miner_tpu.protocol.stratum import StratumClient as RefClient
from bitcoin_miner_tpu.testing import mock_pool as ref_pool
from bitcoin_miner_tpu_torch import cli
from bitcoin_miner_tpu_torch.backends.cpu import CpuHasher
from bitcoin_miner_tpu_torch.backends.cuda import TileCudaHasher
from bitcoin_miner_tpu_torch.core.sha256 import sha256d
from bitcoin_miner_tpu_torch.miner.dispatcher import Share
from bitcoin_miner_tpu_torch.miner.job import StratumJobParams
from bitcoin_miner_tpu_torch.miner.runner import (
    GbtMiner,
    GetworkMiner,
    StratumMiner,
)
from bitcoin_miner_tpu_torch.parallel import ranges as port_ranges
from bitcoin_miner_tpu_torch.protocol.stratum import StratumClient
from bitcoin_miner_tpu_torch.telemetry import pipeline as port_pipeline
from bitcoin_miner_tpu_torch.testing import mock_pool as port_pool
from bitcoin_miner_tpu_torch.utils.checkpoint import SweepCheckpoint


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


EASY_DIFF = 1 / (1 << 24)  # ~2^-8 per nonce
POOLS = [ref_pool, port_pool]
POOL_IDS = ["reference_pool", "own_pool"]


def run(coro, timeout=90):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _pool_job(pool_module, job_id="j1"):
    rng = np.random.default_rng(sum(job_id.encode()))
    return pool_module.PoolJob(
        job_id=job_id,
        prevhash_internal=rng.integers(0, 256, 32, dtype=np.uint8).tobytes(),
        coinb1=bytes.fromhex("01000000") + b"\x11" * 30,
        coinb2=b"\x22" * 30 + bytes.fromhex("00000000"),
        merkle_branch=[sha256d(b"tx1"), sha256d(b"tx2")],
        version=0x20000000,
        nbits=0x1D00FFFF,
        ntime=0x655F2B2C,
    )


async def _stop(client, task):
    client.stop()
    task.cancel()
    await asyncio.gather(task, return_exceptions=True)


def _fast(**kw):
    return dict(reconnect_base_delay=0.05, reconnect_max_delay=0.05, **kw)


class TestFailover:
    @pytest.mark.parametrize("pool_module", POOLS, ids=POOL_IDS)
    def test_dead_primary_rotates_to_backup(self, pool_module):
        async def main():
            backup = pool_module.MockStratumPool(difficulty=EASY_DIFF)
            await backup.start()
            sessions = []

            async def on_connect():
                sessions.append((client.host, client.port))

            client = StratumClient(
                "127.0.0.1", 1, "w", failover=[("127.0.0.1", backup.port)],
                failover_threshold=2, on_connect=on_connect, **_fast())
            task = asyncio.create_task(client.run())
            await asyncio.wait_for(client.connected.wait(), 10)
            assert (client.host, client.port) == ("127.0.0.1", backup.port)
            assert client.extranonce1 == backup.extranonce1
            assert client.reconnects == 2
            assert sessions == [("127.0.0.1", backup.port)]
            await _stop(client, task)
            await backup.stop()

        run(main())

    @pytest.mark.parametrize("client_cls", [StratumClient, RefClient],
                             ids=["own_client", "reference_client"])
    def test_rotation_wraps_back_to_primary(self, client_cls):
        """Over two dead endpoints both packages rotate from one to the
        other and back: three changes of port between two endpoints."""
        async def main():
            client = client_cls("127.0.0.1", 1, "w",
                                failover=[("127.0.0.1", 2)],
                                failover_threshold=1,
                                reconnect_base_delay=0.01,
                                reconnect_max_delay=0.01)
            task = asyncio.create_task(client.run())
            seen = []
            for _ in range(400):
                await asyncio.sleep(0.005)
                if not seen or seen[-1] != client.port:
                    seen.append(client.port)
                if len(seen) >= 4:
                    break
            await _stop(client, task)
            return seen

        seen = run(main())
        assert len(seen) >= 4 and set(seen) == {1, 2}, seen

    def test_established_session_resets_the_count(self):
        """A pool that drops an established session is flaky, not dead:
        the client reconnects to it rather than failing over."""
        async def main():
            primary = port_pool.MockStratumPool(difficulty=EASY_DIFF)
            await primary.start()
            client = StratumClient(
                "127.0.0.1", primary.port, "w",
                failover=[("127.0.0.1", 1)], failover_threshold=1, **_fast())
            task = asyncio.create_task(client.run())
            for _ in range(3):
                await asyncio.wait_for(client.connected.wait(), 10)
                for w in list(primary._clients):
                    w.close()
                await asyncio.sleep(0.1)
            await asyncio.wait_for(client.connected.wait(), 10)
            assert client.port == primary.port
            await _stop(client, task)
            await primary.stop()

        run(main())


def _server_ctx(tmp_path):
    key, crt = str(tmp_path / "k.pem"), str(tmp_path / "c.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", crt, "-days", "1", "-subj", "/CN=127.0.0.1"],
        check=True, capture_output=True)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(crt, key)
    return ctx


class TestTls:
    @pytest.mark.parametrize("pool_module", POOLS, ids=POOL_IDS)
    def test_session_with_verification_off(self, tmp_path, pool_module):
        async def main():
            pool = pool_module.MockStratumPool(difficulty=EASY_DIFF)
            await pool.start(ssl=_server_ctx(tmp_path))
            client = StratumClient("127.0.0.1", pool.port, "w",
                                   use_tls=True, tls_verify=False)
            task = asyncio.create_task(client.run())
            await asyncio.wait_for(client.connected.wait(), 15)
            assert client.extranonce1 == pool.extranonce1
            await _stop(client, task)
            await pool.stop()

        run(main())

    @pytest.mark.parametrize("pool_module", POOLS, ids=POOL_IDS)
    def test_self_signed_certificate_refused_by_default(self, tmp_path,
                                                        pool_module):
        async def main():
            pool = pool_module.MockStratumPool(difficulty=EASY_DIFF)
            await pool.start(ssl=_server_ctx(tmp_path))
            client = StratumClient("127.0.0.1", pool.port, "w", use_tls=True,
                                   reconnect_base_delay=0.1,
                                   reconnect_max_delay=0.1)
            task = asyncio.create_task(client.run())
            with pytest.raises(asyncio.TimeoutError):
                await asyncio.wait_for(client.connected.wait(), 1.5)
            assert client.reconnects >= 1
            await _stop(client, task)
            await pool.stop()

        run(main())

    def test_tls_stratum_session_mines_shares(self, tmp_path):
        """A whole mining session over stratum+ssl, built by the command
        line, with shares the reference's pool validates."""
        async def main():
            pool = ref_pool.MockStratumPool(difficulty=EASY_DIFF)
            await pool.start(ssl=_server_ctx(tmp_path))
            await pool.announce_job(_pool_job(ref_pool))
            args = cli.build_parser().parse_args(
                ["--pool", f"stratum+ssl://127.0.0.1:{pool.port}",
                 "--tls-no-verify", "--device", "cpu", "--backend", "cpu",
                 "--workers", "2", "--batch-bits", "9"])
            miner = cli.make_miner(args)
            assert miner.client.use_tls and not miner.client.tls_verify
            task = asyncio.create_task(miner.run())
            try:
                for _ in range(600):
                    if miner.dispatcher.stats.shares_accepted >= 2:
                        break
                    await asyncio.sleep(0.05)
            finally:
                miner.stop()
                await asyncio.gather(task, return_exceptions=True)
                await pool.stop()
            assert miner.dispatcher.stats.shares_accepted >= 2
            assert all(s.accepted for s in pool.shares)

        run(main(), 120)


class TestSuggestDifficulty:
    @pytest.mark.parametrize("pool_module", POOLS, ids=POOL_IDS)
    def test_suggestion_adopted(self, pool_module):
        async def main():
            pool = pool_module.MockStratumPool(difficulty=1.0)
            await pool.start()
            await pool.announce_job(_pool_job(pool_module))
            client = StratumClient("127.0.0.1", pool.port, "w",
                                   suggest_difficulty=EASY_DIFF)
            task = asyncio.create_task(client.run())
            await asyncio.wait_for(client.connected.wait(), 10)
            for _ in range(100):
                if client.difficulty == EASY_DIFF:
                    break
                await asyncio.sleep(0.05)
            assert client.difficulty == pool.difficulty == EASY_DIFF
            await _stop(client, task)
            await pool.stop()

        run(main())

    def test_no_suggestion_by_default(self):
        async def main():
            pool = port_pool.MockStratumPool(difficulty=1.0)
            await pool.start()
            await pool.announce_job(_pool_job(port_pool))
            client = StratumClient("127.0.0.1", pool.port, "w")
            task = asyncio.create_task(client.run())
            await asyncio.wait_for(client.connected.wait(), 10)
            await asyncio.sleep(0.2)
            assert client.difficulty == pool.difficulty == 1.0
            await _stop(client, task)
            await pool.stop()

        run(main())


class TestRedirect:
    @pytest.mark.parametrize("pool_module", POOLS, ids=POOL_IDS)
    def test_cross_host_ignored_by_default(self, pool_module):
        async def main():
            pool = pool_module.MockStratumPool()
            await pool.start()
            client = StratumClient("127.0.0.1", pool.port, "w")
            task = asyncio.create_task(client.run())
            await asyncio.wait_for(client.connected.wait(), 10)
            await pool._broadcast("client.reconnect", ["evil.example", 3333])
            await asyncio.sleep(0.2)
            assert (client.host, client.port) == ("127.0.0.1", pool.port)
            assert client.connected.is_set()
            await _stop(client, task)
            await pool.stop()

        run(main())

    @pytest.mark.parametrize("pool_module", POOLS, ids=POOL_IDS)
    def test_cross_host_honoured_with_allow_redirect(self, pool_module):
        async def main():
            pool = pool_module.MockStratumPool()
            await pool.start()
            client = StratumClient("127.0.0.1", pool.port, "w",
                                   allow_redirect=True, **_fast())
            task = asyncio.create_task(client.run())
            await asyncio.wait_for(client.connected.wait(), 10)
            await pool._broadcast("client.reconnect", ["10.0.0.1", 3333])
            await asyncio.sleep(0.2)
            assert (client.host, client.port) == ("10.0.0.1", 3333)
            await _stop(client, task)
            await pool.stop()

        run(main())

    def test_same_host_move_honoured(self):
        async def main():
            pool = port_pool.MockStratumPool()
            await pool.start()
            pool2 = port_pool.MockStratumPool()
            await pool2.start()
            client = StratumClient("127.0.0.1", pool.port, "w", **_fast())
            task = asyncio.create_task(client.run())
            await asyncio.wait_for(client.connected.wait(), 10)
            await pool._broadcast("client.reconnect", ["127.0.0.1",
                                                       pool2.port])
            await asyncio.sleep(0.2)
            await asyncio.wait_for(client.connected.wait(), 10)
            assert client.port == pool2.port
            await _stop(client, task)
            await pool.stop()
            await pool2.stop()

        run(main())


class TestHostPartition:
    def test_partition_matches_the_reference(self):
        rng = np.random.default_rng(5)
        for _ in range(50):
            size = int(rng.integers(1, 9))
            n = int(rng.integers(1, 64))
            i = int(rng.integers(0, n))
            assert port_ranges.partition_extranonce2_space(size, i, n) == \
                ref_ranges.partition_extranonce2_space(size, i, n)
        for args in ((0, 0, 1), (4, 2, 2), (4, -1, 2)):
            for mod in (port_ranges, ref_ranges):
                with pytest.raises(ValueError):
                    mod.partition_extranonce2_space(*args)

    def test_counter_reset(self):
        port = port_ranges.ExtranonceCounter(size=1, start=3, step=5)
        ref = ref_ranges.ExtranonceCounter(size=1, start=3, step=5)
        assert [next(port) for _ in range(4)] == [next(ref) for _ in range(4)]
        port.reset()
        ref.reset()
        assert list(port) == list(ref)

    @pytest.mark.parametrize("pool_module", POOLS, ids=POOL_IDS)
    def test_two_hosts_submit_disjoint_extranonce2(self, pool_module):
        """Miners built as ``--host-index 0/1 --n-hosts 2`` submit shares of
        even and odd extranonce2 counters, all accepted."""
        async def main():
            pool = pool_module.MockStratumPool(difficulty=EASY_DIFF)
            await pool.start()
            await pool.announce_job(_pool_job(pool_module, "mh"))
            miners, tasks = [], []
            for host in (0, 1):
                args = cli.build_parser().parse_args(
                    ["--pool", f"127.0.0.1:{pool.port}", "--user",
                     f"host{host}", "--host-index", str(host), "--n-hosts",
                     "2", "--backend", "cpu", "--workers", "2",
                     "--batch-bits", "9"])
                miner = cli.make_miner(args)
                miners.append(miner)
                tasks.append(asyncio.create_task(miner.run()))
            try:
                for _ in range(1200):
                    users = {s.username for s in pool.shares if s.accepted}
                    if users == {"host0", "host1"}:
                        break
                    await asyncio.sleep(0.05)
            finally:
                for miner in miners:
                    miner.stop()
                await asyncio.gather(*tasks, return_exceptions=True)
                await pool.stop()
            by_host = {"host0": set(), "host1": set()}
            for s in pool.shares:
                assert s.accepted, s
                by_host[s.username].add(int.from_bytes(s.extranonce2,
                                                       "little"))
            assert by_host["host0"] and by_host["host1"]
            assert all(v % 2 == 0 for v in by_host["host0"])
            assert all(v % 2 == 1 for v in by_host["host1"])

        run(main(), 240)


class TestCommandLine:
    def _args(self, *argv):
        return cli.build_parser().parse_args([*argv, "--device", "cpu"])

    def test_defaults(self):
        getwork = cli.make_getwork_miner(self._args("--getwork",
                                                    "http://127.0.0.1:1"))
        assert isinstance(getwork, GetworkMiner)
        assert getwork.dispatcher.ntime_roll == 600
        assert isinstance(getwork.dispatcher.hasher, TileCudaHasher)
        gbt = cli.make_gbt_miner(self._args("--gbt", "http://127.0.0.1:1"))
        assert isinstance(gbt, GbtMiner)
        assert gbt.dispatcher.submit_blocks_only
        assert gbt.dispatcher.ntime_roll == 0
        assert gbt.dispatcher.checkpoint is None
        assert isinstance(gbt.dispatcher.hasher, TileCudaHasher)
        pool = cli.make_miner(self._args("--pool", "127.0.0.1:3333"))
        d, c = pool.dispatcher, pool.client
        assert (d.ntime_roll, d.extranonce2_start, d.extranonce2_step) == (
            0, 0, 1)
        assert d.checkpoint is None and not d.submit_blocks_only
        assert not c.use_tls and c.tls_verify and not c.allow_redirect
        assert c.suggest_difficulty is None
        assert c._endpoints == [("127.0.0.1", 3333)]
        assert cli.make_getwork_miner(self._args(
            "--getwork", "http://127.0.0.1:1", "--ntime-roll", "0")
        ).dispatcher.ntime_roll == 0

    def test_pool_options_reach_the_session(self, tmp_path):
        path = str(tmp_path / "c.json")
        miner = cli.make_miner(self._args(
            "--pool", "stratum+ssl://a.example:1,stratum+ssl://b.example",
            "--host-index", "2", "--n-hosts", "3", "--ntime-roll", "30",
            "--suggest-difficulty", "0.5", "--tls-no-verify",
            "--allow-redirect", "--checkpoint", path))
        d, c = miner.dispatcher, miner.client
        assert (d.extranonce2_start, d.extranonce2_step, d.ntime_roll) == (
            2, 3, 30)
        assert isinstance(d.checkpoint, SweepCheckpoint)
        assert d.checkpoint.path == path
        assert c._endpoints == [("a.example", 1), ("b.example", 3333)]
        assert c.use_tls and not c.tls_verify and c.allow_redirect
        assert c.suggest_difficulty == 0.5
        gbt = cli.make_gbt_miner(self._args("--gbt", "http://127.0.0.1:1",
                                            "--checkpoint", path))
        assert gbt.dispatcher.checkpoint.path == path

    @pytest.mark.parametrize("argv,message", [
        (["--pool", "a:1", "--pool", "b:2", "--checkpoint", "x"],
         "multi-pool fabric"),
        (["--pool", "gbt+http://a:1", "--allow-redirect"],
         "multi-pool fabric"),
        (["--pool", "getwork+http://a:1", "--checkpoint", "x"],
         "multi-pool fabric"),
        (["--pool", "stratum+tcp://a:1,stratum+ssl://b:2"], "one scheme"),
        (["--pool", "stratum+tcp://a:1,http://b:2"], "must be stratum"),
        (["--pool", " "], "at least one URL"),
        (["--pool", "a:1", "--suggest-difficulty", "0"], "must be > 0"),
        (["--pool", "a:1", "--host-index", "2", "--n-hosts", "2"],
         "not in"),
        (["--pool", "a:1", "--n-hosts", "0"], "not in"),
        (["--gbt", "http://a:1", "--ntime-roll", "5"], "--gbt ignores"),
        (["--gbt", "http://a:1", "--host-index", "1"], "--gbt ignores"),
        (["--getwork", "http://a:1", "--checkpoint", "x"],
         "--getwork ignores"),
        (["--getwork", "http://a:1", "--allow-redirect"],
         "--getwork ignores"),
        (["--getwork", "http://a:1", "--suggest-difficulty", "1"],
         "--getwork ignores"),
        (["--bench", "--checkpoint", "x"], "--bench ignores"),
        (["--bench", "--n-hosts", "2"], "--bench ignores"),
        (["--gbt", "http://a:1", "--tls-no-verify"], "--gbt ignores"),
    ])
    def test_refusals(self, argv, message):
        args = self._args(*argv)
        make = (cli.make_gbt_miner if args.gbt else cli.make_getwork_miner
                if args.getwork else cli.bench if args.bench
                else cli.make_miner)
        with pytest.raises(SystemExit, match=message):
            make(args)

    def test_modes_are_exclusive(self, capsys):
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args(["--gbt", "http://a:1",
                                           "--getwork", "http://b:2"])
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args([])

    @pytest.mark.parametrize("bits", [10, 13])
    def test_batch_3x(self, bits):
        args = self._args("--pool", "127.0.0.1:1", "--batch-3x",
                          "--sublanes", "24", "--batch-bits", str(bits))
        assert cli.batch_size_for(args) == 3 << bits
        miner = cli.make_miner(args)
        hasher = miner.dispatcher.hasher
        assert hasher.batch_size == miner.dispatcher.batch_size == 3 << bits
        assert hasher.tile % 3072 == 0 and hasher.batch_size % hasher.tile == 0
        adaptive = cli.make_miner(self._args("--pool", "127.0.0.1:1",
                                             "--batch-3x"))
        assert adaptive.dispatcher.scheduler.granularity == 3 << 24
        assert cli.batch_size_for(self._args("--bench")) == 1 << 24

    def test_batch_3x_bench_sweeps_past_the_last_partial_dispatch(self):
        """The genesis bench at 3·2^10-nonce dispatches of 3072-nonce steps
        (``--sublanes 24``), over a count that ends inside a dispatch."""
        args = self._args("--bench", "--batch-3x", "--sublanes", "24",
                          "--batch-bits", "10", "--bench-nonces", "10000")
        out = cli.bench(args)
        assert out["verified"] and out["hashes"] == 10000
        assert out["dispatches"] == 4

    def test_main_routes_each_mode(self, monkeypatch):
        seen = []
        monkeypatch.setattr(cli, "cmd_session",
                            lambda miner, args: seen.append(
                                type(miner).__name__) or 0)
        for argv in (["--gbt", "http://a:1"], ["--getwork", "http://a:1"],
                     ["--pool", "a:1"]):
            assert cli.main([*argv, "--device", "cpu"]) == 0
        assert seen == ["GbtMiner", "GetworkMiner", "StratumMiner"]


def test_stratum_miner_passes_its_options_on(tmp_path):
    miner = StratumMiner(
        "127.0.0.1", 1, "w", hasher=CpuHasher(), extranonce2_start=1,
        extranonce2_step=4, allow_redirect=True, ntime_roll=7,
        suggest_difficulty=2.0, failover=[("h", 2)], use_tls=True,
        tls_verify=False)
    d, c = miner.dispatcher, miner.client
    assert (d.extranonce2_start, d.extranonce2_step, d.ntime_roll) == (1, 4, 7)
    assert c._endpoints == [("127.0.0.1", 1), ("h", 2)]
    assert (c.allow_redirect, c.suggest_difficulty, c.use_tls,
            c.tls_verify) == (True, 2.0, True, False)


def test_checkpoint_cleared_on_disconnect(tmp_path):
    """A disconnect clears the checkpoint: a new session's job ids and
    extranonce1 are not the dead session's."""
    async def main():
        path = str(tmp_path / "c.json")
        pool = port_pool.MockStratumPool(difficulty=EASY_DIFF)
        await pool.start()
        await pool.announce_job(_pool_job(port_pool))
        miner = StratumMiner("127.0.0.1", pool.port, "w", hasher=CpuHasher(),
                             n_workers=1, batch_size=1 << 8)
        miner.dispatcher.checkpoint = SweepCheckpoint(path)
        miner.dispatcher.checkpoint.set_progress("old:key", 5)
        miner.dispatcher.checkpoint.save()
        task = asyncio.create_task(miner.run())
        for _ in range(200):
            if miner.client.connected.is_set():
                break
            await asyncio.sleep(0.05)
        for w in list(pool._clients):
            w.close()
        for _ in range(200):
            if miner.client.reconnects:
                break
            await asyncio.sleep(0.05)
        miner.stop()
        await asyncio.gather(task, return_exceptions=True)
        await pool.stop()
        assert "old:key" not in json.load(open(path))["jobs"]

    run(main())


def test_shares_of_a_dropped_connection_are_not_submitted():
    """A share mined on a job installed before a disconnect carries the
    dropped connection's extranonce1. A pool whose sessions all announce
    the same job ids (the sharded frontend's local templates) would judge
    it against the new session's extranonce1: it is counted stale (lost)
    and never submitted. A share of the new connection's job, under the
    same job id, is submitted. (The reference submits both.)"""
    async def main():
        miner = StratumMiner("127.0.0.1", 1, "w", hasher=CpuHasher())
        submitted = []

        async def submit(share):
            submitted.append(share)
            return True

        client, stats = miner.client, miner.dispatcher.stats
        client.submit_share = submit
        client.extranonce2_size = 4
        params = StratumJobParams.from_notify(
            ["t1", "00" * 32, "01000000", "00000000", [], "20000000",
             "1d00ffff", "66000001", True])

        def share(nonce):
            return Share(job_id="t1", extranonce2=b"\0" * 4,
                         ntime=0x66000001, nonce=nonce, header80=b"",
                         hash_int=0, is_block=False)

        client.extranonce1 = bytes.fromhex("f00d0000")
        await miner._on_job(params)
        old = share(1)
        await miner._on_share(old)
        await miner._on_disconnect()
        client.extranonce1 = bytes.fromhex("f00d8000")
        await miner._on_share(share(2))  # the new job not yet installed
        await miner._on_share(old)
        await miner._on_job(params)
        new = share(3)
        await miner._on_share(new)
        assert [s.nonce for s in submitted] == [1, 3]
        assert (stats.shares_accepted, stats.shares_stale) == (2, 2)
        tel = miner.dispatcher.telemetry
        assert tel.pool_acks.labels(result="lost").value == 2
        assert tel.submits_inflight.value == 0

    # The counts are the session's: a bundle of its own, not the process
    # default that earlier tests of the worker may have counted into.
    port_pipeline.set_telemetry(port_pipeline.PipelineTelemetry())
    try:
        run(main())
    finally:
        port_pipeline.set_telemetry(None)
