"""The PyTorch package's multi-pool fabric against the JAX package's
``miner/multipool.py`` and ``testing/chaos_pool.py``.

- Routing math, exact: ``parse_pool_spec`` (with its error text),
  ``SlotWindow`` under a scripted clock, ``capacity_weight`` and the slot
  sequence ``_pick`` returns, on the same seeded inputs (numpy) in both
  packages.
- The FSM and failover: the port's ``MultipoolMiner`` on a hasher that
  releases the GIL (``CudaHasher(device="cpu")``, 2^12-nonce batches)
  against the port's chaos pools and fake node, under a clock the test
  drives: the routing quanta are ``await fabric._tick()`` calls, never
  sleeps, and every wait is on a condition with a deadline.
- Wire parity both ways: the port's fabric mines for the reference's
  chaos pools, the reference's fabric (on its own hasher) for the port's.
- The fabric's readers: the observatory, the SLO engine, incident
  bundles, the reporter line and the command line.
- The deliberate differences from the reference (a ``submitblock``
  answer of the stale family counts stale; a submit cut by the stop
  lowers the in-flight counts; only the pool's answers restart the stall
  clock; the observatory reads a slot's window rate), each pinned against
  the reference's behaviour on the same input.
"""

import asyncio
import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import bitcoin_miner_tpu.miner.runner  # noqa: F401 — before its protocol
from bitcoin_miner_tpu.backends.base import get_hasher as ref_get_hasher
from bitcoin_miner_tpu.miner import multipool as ref_mp
from bitcoin_miner_tpu.protocol import getwork as ref_getwork
from bitcoin_miner_tpu.telemetry import pipeline as ref_pipeline
from bitcoin_miner_tpu.telemetry import slo as ref_slo
from bitcoin_miner_tpu.telemetry import tsdb as ref_tsdb
from bitcoin_miner_tpu.testing import chaos_pool as ref_chaos
from bitcoin_miner_tpu.testing import mock_pool as ref_mock
from bitcoin_miner_tpu_torch import cli
from bitcoin_miner_tpu_torch.backends.cuda import CudaHasher
from bitcoin_miner_tpu_torch.core.sha256 import sha256d
from bitcoin_miner_tpu_torch.miner import multipool as port_mp
from bitcoin_miner_tpu_torch.miner.dispatcher import MinerStats, Share
from bitcoin_miner_tpu_torch.miner.runner import StratumMiner
from bitcoin_miner_tpu_torch.protocol import getwork as port_getwork
from bitcoin_miner_tpu_torch.telemetry import pipeline as port_pipeline
from bitcoin_miner_tpu_torch.telemetry import slo as port_slo
from bitcoin_miner_tpu_torch.telemetry import tsdb as port_tsdb
from bitcoin_miner_tpu_torch.testing import chaos_pool as port_chaos
from bitcoin_miner_tpu_torch.testing import mock_pool as port_mock
from bitcoin_miner_tpu_torch.testing.fake_node import FakeNode
from bitcoin_miner_tpu_torch.utils.reporting import StatsReporter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: share difficulty of the port's pools: a hit per ~2^12 nonces, about one
#: per batch, so a worker parked on a muted pool holds one or two shares.
DIFF = 1 / (1 << 20)
#: nbits of the same target, for the fake nodes' getwork and GBT work.
DIFF_NBITS = 0x1F0FFFF0
#: the reference's hasher is pure Python (~1 ms a nonce): its pools get a
#: hit per ~256 nonces.
EASY = 1 / (1 << 24)
BATCH = 1 << 12
#: a routing quantum the test never waits out: it calls ``_tick``.
NEVER = 3600.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def wait_for(predicate, timeout_s=45.0, interval_s=0.05, step=None):
    """Wait until ``predicate()``; ``step`` (a coroutine function) runs
    between checks."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout_s
    while not predicate():
        assert loop.time() < deadline, "condition not reached in time"
        if step is not None:
            await step()
        await asyncio.sleep(interval_s)


def pool_job(mock, job_id):
    """The same job in either package's pool type."""
    return mock.PoolJob(
        job_id=job_id,
        prevhash_internal=sha256d(b"prev block " + job_id.encode()),
        coinb1=bytes.fromhex("01000000") + b"\x11" * 30,
        coinb2=b"\x22" * 30 + bytes.fromhex("00000000"),
        merkle_branch=[sha256d(b"tx1")],
        version=0x20000000, nbits=0x1D00FFFF, ntime=0x655F2B2C,
    )


async def start_two_pools(chaos=port_chaos, mock=port_mock, difficulty=DIFF):
    a = chaos.ChaosStratumPool(difficulty=difficulty)
    await a.start()
    await a.announce_job(pool_job(mock, "a1"))
    b = chaos.ChaosStratumPool(difficulty=difficulty,
                               extranonce1=bytes.fromhex("beadfeed"))
    await b.start()
    await b.announce_job(pool_job(mock, "b1"))
    return a, b


def accepted(pool):
    return sum(1 for s in pool.shares if s.accepted)


def spec(port, weight=None, scheme="stratum+tcp"):
    frag = f"#w={weight}" if weight is not None else ""
    return port_mp.parse_pool_spec(f"{scheme}://127.0.0.1:{port}{frag}")


def make_miner(specs, clock, **kw):
    """The port's fabric on the CPU, routed only by the test's ticks."""
    kw.setdefault("route_interval_s", NEVER)
    kw.setdefault("stall_after_s", 2.0)
    kw.setdefault("window_s", 20.0)
    kw.setdefault("reconnect_base_delay", 0.05)
    kw.setdefault("reconnect_max_delay", 0.2)
    kw.setdefault("request_timeout", 3.0)
    kw.setdefault("breaker_cooldown_s", 0.3)
    return port_mp.MultipoolMiner(
        specs,
        hasher=CudaHasher(batch_size=BATCH, inner_size=1 << 10,
                          device="cpu"),
        n_workers=2, batch_size=BATCH, stream_depth=0,
        telemetry=port_pipeline.PipelineTelemetry(),
        clock=lambda: clock[0], **kw)


async def tick_until(fabric, slot, timeout_s=30.0):
    """Routing quanta until ``slot`` owns the dispatcher."""
    await wait_for(lambda: slot.live, timeout_s)
    await wait_for(lambda: fabric.active is slot, timeout_s,
                   step=fabric._tick)


async def stop(miner, task, *servers):
    miner.stop()
    await asyncio.wait_for(task, 30)
    for s in servers:
        await s.stop()


# ------------------------------------------------------ routing math, exact
SPEC_URLS = [
    "stratum+tcp://pool.example:3333#w=2.5", "stratum+ssl://pool.example:4444#3",
    "getwork+http://127.0.0.1:8332/wk", "gbt+http://127.0.0.1:8332",
    "gbt+http://node", "10.0.0.1:3333", "pool.example", "stratum+tcp://x",
    "stratum+tcp://x:1#weight=0.5", " stratum+tcp://x:9#w=1e3 ",
    "ftp://x:1", "http://x:1", "stratum+tcp://x:1#w=0",
    "stratum+tcp://x:1#w=nope", "stratum+tcp://x:1#w=-1",
]


@pytest.mark.parametrize("url", SPEC_URLS)
def test_parse_pool_spec_matches_reference(url):
    outs = []
    for mp in (ref_mp, port_mp):
        try:
            outs.append(dataclasses.asdict(mp.parse_pool_spec(url)))
        except ValueError as e:
            outs.append(("ValueError", str(e)))
    assert outs[1] == outs[0]
    port_spec = outs[1]
    if isinstance(port_spec, dict):
        assert port_mp.PoolSpec(**port_spec).http_url == \
            ref_mp.PoolSpec(**outs[0]).http_url


@pytest.mark.parametrize("seed", range(6))
def test_slot_window_matches_reference(seed):
    rng = np.random.default_rng(seed)
    now = [0.0]
    wins = [mp.SlotWindow(window_s=float(rng.choice([5.0, 20.0, 120.0])),
                          clock=lambda: now[0]) for mp in (ref_mp, port_mp)]
    for w in wins[1:]:
        w.window_s = wins[0].window_s
    trail = [[], []]
    for _ in range(120):
        op = rng.random()
        if op < 0.6:
            result = str(rng.choice(["accepted", "rejected", "stale",
                                     "timeout", "lost", "error"]))
            diff = [None, 0.0, float(rng.choice([1.0, 4.0, 1 / 256])),
                    float(rng.uniform(0.01, 8.0))][int(rng.integers(4))]
            rtt = float(rng.exponential(0.3))
            for w in wins:
                w.record(result, diff, rtt)
        else:
            now[0] += float(rng.exponential(3.0))
        for i, w in enumerate(wins):
            trail[i].append((w.accept_rate(), w.submit_p99(), w.snapshot()))
    assert trail[1] == trail[0]


@pytest.mark.parametrize("seed", range(4))
def test_capacity_weight_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        base = float(rng.uniform(0.1, 10.0))
        rate = None if rng.random() < 0.2 else float(rng.uniform(-0.5, 1.5))
        p99 = None if rng.random() < 0.2 else float(rng.exponential(2.0))
        ref_ms = float(rng.choice([0.5, 1.0, 3.0]))
        assert port_mp.capacity_weight(base, rate, p99, ref_ms) == \
            ref_mp.capacity_weight(base, rate, p99, ref_ms)


def _fabrics(urls, now):
    return [mp.PoolFabric([mp.parse_pool_spec(u) for u in urls],
                          telemetry=pl.PipelineTelemetry(), window_s=30.0,
                          clock=lambda: now[0])
            for mp, pl in ((ref_mp, ref_pipeline), (port_mp, port_pipeline))]


@pytest.mark.parametrize("seed", range(6))
def test_pick_sequence_matches_reference(seed):
    """200 stride picks over seeded weights, FSM states and window
    verdicts, changed every 20 picks: the same slots in the same order,
    the same weights and the same slot-state gauges."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 6))
    urls = [f"stratum+tcp://127.0.0.1:{i + 1}#w={float(rng.uniform(0.5, 8)):.3f}"
            for i in range(n)]
    now = [0.0]
    fabrics = _fabrics(urls, now)
    picks = [[], []]
    states = ["connecting", "syncing", "active", "degraded", "dead"]
    for step in range(200):
        if step % 20 == 0:
            live_state = [str(rng.choice(states, p=[.1, .1, .5, .2, .1]))
                          for _ in range(n)]
            has_job = [bool(rng.random() < 0.9) for _ in range(n)]
            verdicts = [[(str(rng.choice(["accepted", "rejected", "stale",
                                           "timeout"], p=[.7, .1, .1, .1])),
                          float(rng.choice([1.0, 2.0])),
                          float(rng.exponential(0.5)))
                         for _ in range(int(rng.integers(0, 8)))]
                        for _ in range(n)]
            now[0] += float(rng.uniform(0, 10))
            for fabric in fabrics:
                for i, slot in enumerate(fabric.slots):
                    slot._job = object() if has_job[i] else None
                    slot.set_state(live_state[i])
                    for v in verdicts[i]:
                        slot.window.record(*v)
        avoid_idx = int(rng.integers(-1, n))
        for k, fabric in enumerate(fabrics):
            avoid = fabric.slots[avoid_idx] if avoid_idx >= 0 else None
            slot = fabric._pick(avoid)
            picks[k].append((None if slot is None else slot.index,
                             fabric.weights()))
    assert picks[1] == picks[0]
    assert any(p[0] is not None for p in picks[1])
    gauges = [{k: c.value for k, c in f.telemetry.pool_slot_state.children()}
              for f in fabrics]
    assert gauges[1] == gauges[0]


def test_slot_window_is_safe_across_threads():
    """The event loop records verdicts while the health watchdog and the
    observatory read the window from their own threads: with more threads
    than cores and a short switch interval, every verdict is counted and
    no reader sees the deque change under it."""
    import threading

    window = port_mp.SlotWindow(window_s=1e9)
    n_writers, per_writer = 4, 1000
    errors = []

    def write():
        for i in range(per_writer):
            window.record("accepted" if i % 2 else "rejected", 1.0, 0.001)

    def read(stop):
        try:
            while not stop.is_set():
                window.accept_rate()
                window.submit_p99()
                window.snapshot()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    stop = threading.Event()
    readers = [threading.Thread(target=read, args=(stop,))
               for _ in range(os.cpu_count() or 1)]
    writers = [threading.Thread(target=write) for _ in range(n_writers)]
    try:
        for t in readers + writers:
            t.start()
        for t in writers:
            t.join(timeout=60)
        stop.set()
        for t in readers:
            t.join(timeout=60)
    finally:
        stop.set()
        sys.setswitchinterval(before)
    assert not any(t.is_alive() for t in readers + writers)
    assert errors == []
    snap = window.snapshot()
    assert snap["events"] == n_writers * per_writer
    assert snap["accept_rate"] == 0.5


def test_fabric_reweights_on_collapse():
    now = [0.0]
    fabric = port_mp.PoolFabric(
        [port_mp.parse_pool_spec("stratum+tcp://127.0.0.1:1#w=4"),
         port_mp.parse_pool_spec("stratum+tcp://127.0.0.1:2")],
        telemetry=port_pipeline.PipelineTelemetry(), window_s=30.0,
        clock=lambda: now[0])
    a, b = fabric.slots
    for s in (a, b):
        s.state = port_mp.ACTIVE
        s._job = object()
    for _ in range(10):
        a.window.record("accepted", 1.0, 0.01)
        b.window.record("accepted", 1.0, 0.01)
    assert fabric.weights()[a.label] > fabric.weights()[b.label]
    for _ in range(150):
        a.window.record("rejected", 1.0, 0.01)
    assert fabric.weights()[a.label] < fabric.weights()[b.label]
    picks = [fabric._pick().label for _ in range(10)]
    assert picks.count(b.label) > picks.count(a.label)


def test_dead_slots_unroutable():
    fabric = port_mp.PoolFabric(
        [port_mp.parse_pool_spec("stratum+tcp://127.0.0.1:1"),
         port_mp.parse_pool_spec("stratum+tcp://127.0.0.1:2")],
        telemetry=port_pipeline.PipelineTelemetry())
    a, b = fabric.slots
    a.state, b.state = port_mp.DEAD, port_mp.CONNECTING
    assert fabric._pick() is None
    assert set(fabric.weights().values()) == {0.0}


def test_public_names_are_the_references():
    for ref_mod, port_mod in ((ref_mp, port_mp), (ref_chaos, port_chaos)):
        public = {n for n, v in vars(ref_mod).items()
                  if not n.startswith("_") and (
                      getattr(v, "__module__", None) == ref_mod.__name__
                      or isinstance(v, str) and n.isupper())}
        assert public and public <= set(vars(port_mod)), (
            public - set(vars(port_mod)))
        for name in public:
            if isinstance(getattr(ref_mod, name), str):
                assert getattr(port_mod, name) == getattr(ref_mod, name)
    for cls in ("PoolSlot", "StratumSlot", "GetworkSlot", "GbtSlot",
                "PoolFabric", "MultipoolMiner", "SlotWindow"):
        ref_names = {n for n in vars(getattr(ref_mp, cls))
                     if not n.startswith("__")}
        assert ref_names <= set(dir(getattr(port_mp, cls))), cls


# -------------------------------------------------------- FSM and failover
def test_kill_mid_job_fails_over_with_zero_idle_generations():
    async def main():
        now = [0.0]
        a, b = await start_two_pools()
        miner = make_miner([spec(a.port, 8), spec(b.port)], now)
        fabric = miner.fabric
        slot_a = fabric.slots[0]
        task = asyncio.create_task(miner.run())
        await tick_until(fabric, slot_a)
        await wait_for(lambda: accepted(a) >= 3)
        gen_at_kill = len(fabric.dispatch_log)
        a.kill()
        before_b = accepted(b)
        await wait_for(lambda: accepted(b) >= before_b + 3)
        assert fabric.failovers >= 1
        tel = fabric.telemetry
        text = tel.registry.render()
        assert 'tpu_miner_pool_failover_total{reason="disconnect"}' in text
        assert "tpu_miner_pool_slot_state" in text
        # Every generation after the kill belongs to a slot, and the first
        # targets the survivor.
        after = fabric.dispatch_log[gen_at_kill:]
        assert after and after[0][1] == 1
        gens = [g for g, _slot in fabric.dispatch_log]
        assert gens == sorted(gens)
        # No share crossed pools.
        assert all(s.job_id in a.jobs for s in a.shares)
        assert all(s.job_id in b.jobs for s in b.shares)
        await stop(miner, task, a, b)
        assert tel.submits_inflight.value == 0

    run(main())


def test_unroutable_share_dropped_not_cross_submitted():
    async def main():
        fabric = port_mp.PoolFabric(
            [port_mp.parse_pool_spec("stratum+tcp://127.0.0.1:1")],
            telemetry=port_pipeline.PipelineTelemetry(), stats=MinerStats())
        share = Share(job_id="p9/ghost", extranonce2=b"\x00" * 4, ntime=0,
                      nonce=1, header80=b"\x00" * 80, hash_int=1,
                      is_block=False)
        assert await fabric.submit(share) is None
        assert await fabric.submit(dataclasses.replace(
            share, job_id="nonamespace")) is None
        assert fabric.stale_unroutable == 2 == fabric.stats.shares_stale
        events = fabric.telemetry.flightrec.snapshot()
        assert [e["stage"] for e in events if e["kind"] == "stale_drop"] \
            == ["fabric", "fabric"]

    run(main())


def test_half_open_socket_degrades_and_fails_over():
    async def main():
        now = [0.0]
        a, b = await start_two_pools()
        miner = make_miner([spec(a.port, 8), spec(b.port)], now,
                           stall_after_s=1.0, request_timeout=3.0)
        fabric = miner.fabric
        slot_a, slot_b = fabric.slots
        task = asyncio.create_task(miner.run())
        await tick_until(fabric, slot_a)
        await wait_for(lambda: accepted(a) >= 2)
        # Half-open: pool a keeps the sockets and answers nothing.
        a.mute = True
        await wait_for(lambda: slot_a.inflight >= 1)
        gen_at_stall = len(fabric.dispatch_log)
        before_b = accepted(b)
        now[0] += fabric.stall_after_s + 1.0
        await fabric._tick()
        assert slot_a.state == port_mp.DEGRADED
        assert fabric.failovers >= 1
        assert fabric.dispatch_log[gen_at_stall][1] == 1
        text = fabric.telemetry.registry.render()
        assert 'tpu_miner_pool_failover_total{reason="stalled"} 1' in text
        # The degraded slot stays routable at a quarter of its weight, so
        # the stride may hand it a quantum back: further quanta move on.
        await wait_for(lambda: accepted(b) >= before_b + 2,
                       step=lambda: (fabric._tick() if fabric.active
                                     is not slot_b else asyncio.sleep(0)))
        assert slot_a.state == port_mp.DEGRADED
        await stop(miner, task, a, b)
        assert fabric.telemetry.submits_inflight.value == 0
        assert slot_a.inflight == 0

    run(main())


def test_capacity_tracks_forced_accept_collapse():
    async def main():
        now = [0.0]
        a, b = await start_two_pools()
        miner = make_miner([spec(a.port, 4), spec(b.port)], now)
        fabric = miner.fabric
        slot_a, slot_b = fabric.slots
        task = asyncio.create_task(miner.run())
        await tick_until(fabric, slot_a)
        await wait_for(lambda: accepted(a) >= 2)
        a.reject_submits = True
        await wait_for(lambda: fabric.weights()[slot_a.label]
                       < fabric.weights()[slot_b.label])
        await tick_until(fabric, slot_b)
        await wait_for(lambda: accepted(b) >= 1)
        assert fabric.stats.shares_rejected >= 1
        await stop(miner, task, a, b)

    run(main())


def test_breaker_open_half_open_close():
    async def main():
        pool = port_chaos.ChaosStratumPool(difficulty=DIFF,
                                           authorized_users=["alice"])
        await pool.start()
        await pool.announce_job(pool_job(port_mock, "j1"))
        fabric = port_mp.PoolFabric(
            [spec(pool.port)], username="mallory",
            telemetry=port_pipeline.PipelineTelemetry(),
            breaker_threshold=2, breaker_cooldown_s=0.3,
            reconnect_base_delay=0.05, reconnect_max_delay=0.1,
            route_interval_s=NEVER)
        await fabric.start()
        slot = fabric.slots[0]
        await wait_for(lambda: slot.state == port_mp.DEAD, 30.0)
        assert slot.breaker_open_count >= 1
        # The open breaker stopped the client's retry loop.
        assert slot.client._stopping
        pool.authorized_users = None
        await wait_for(lambda: slot.state == port_mp.ACTIVE, 30.0)
        states = [e["state"] for e in fabric.telemetry.flightrec.snapshot()
                  if e["kind"] == "pool_slot"]
        assert "dead" in states and states[-1] == "active"
        assert "connecting" in states[states.index("dead"):]
        await fabric.stop()
        await pool.stop()

    run(main())


def test_flapping_difficulty_keeps_serving():
    async def main():
        now = [0.0]
        a = port_chaos.ChaosStratumPool(difficulty=DIFF)
        await a.start()
        await a.announce_job(pool_job(port_mock, "a1"))
        miner = make_miner([spec(a.port)], now)
        task = asyncio.create_task(miner.run())
        await wait_for(lambda: accepted(a) >= 1)
        gens = len(miner.fabric.dispatch_log)
        await a.flap_difficulty(DIFF, DIFF * 2, flips=6, period_s=0.05)
        before = accepted(a)
        await wait_for(lambda: accepted(a) >= before + 1)
        assert miner.fabric.slots[0].state == port_mp.ACTIVE
        # Each retarget re-installed the job.
        assert len(miner.fabric.dispatch_log) > gens
        await stop(miner, task, a)
        rejected = [s.reason for s in a.shares if not s.accepted]
        assert set(rejected) <= {"low difficulty share"}

    run(main())


def test_gbt_failure_clears_template_identity():
    async def main():
        fabric = port_mp.PoolFabric(
            [port_mp.parse_pool_spec("gbt+http://127.0.0.1:1")],
            telemetry=port_pipeline.PipelineTelemetry())
        slot = fabric.slots[0]
        slot.state = port_mp.ACTIVE
        slot._job = object()
        slot._current_gbt = object()
        slot._last_identity = ("tip", 1, ())
        await slot._on_fetch_failure()
        assert slot.state == port_mp.ACTIVE  # one failed poll is routine
        await slot._on_fetch_failure()
        assert slot._job is None and slot._last_identity is None
        assert slot._current_gbt is None
        assert slot.state == port_mp.CONNECTING
        await slot._on_fetch_failure()
        assert slot.state == port_mp.DEAD and slot.breaker_open_count == 1

    run(main())


def test_miner_plumbs_ntime_roll():
    miner = make_miner([spec(1)], [0.0], ntime_roll=600)
    assert miner.dispatcher.ntime_roll == 600
    assert miner.fabric.telemetry is miner.dispatcher.telemetry
    assert miner.fabric.stats is miner.dispatcher.stats


def test_getwork_slot_joins_the_fabric():
    async def main():
        node = FakeNode()
        await node.start()
        fabric = port_mp.PoolFabric(
            [spec(node.port, scheme="getwork+http")],
            telemetry=port_pipeline.PipelineTelemetry(), poll_interval=0.2,
            route_interval_s=NEVER)
        installs = []
        fabric.on_active_job = lambda slot, job: installs.append(
            (slot.kind, job.job_id)) or len(installs)
        await fabric.start()
        await wait_for(lambda: fabric.slots[0].state == port_mp.ACTIVE
                       and installs, 30.0)
        kind, job_id = installs[0]
        assert kind == "getwork" and job_id.startswith("p0/getwork-")
        assert fabric.dispatch_log[0] == (1, 0)
        await fabric.stop()
        await node.stop()

    run(main())


def test_mixed_stratum_getwork_gbt_slots_each_submit_to_their_own():
    """A Stratum pool, a getwork node and a GBT node in one fabric: the
    stride hands each a quantum in turn, and each gets its own accepted
    submissions and nothing else."""
    async def main():
        now = [0.0]
        pool = port_chaos.ChaosStratumPool(difficulty=DIFF)
        await pool.start()
        await pool.announce_job(pool_job(port_mock, "s1"))
        gw = FakeNode(nbits=DIFF_NBITS)
        await gw.start()
        gbt = FakeNode(nbits=DIFF_NBITS)
        await gbt.start()
        miner = make_miner([spec(pool.port),
                            spec(gw.port, scheme="getwork+http"),
                            spec(gbt.port, scheme="gbt+http")], now,
                           poll_interval=0.2)
        fabric = miner.fabric
        task = asyncio.create_task(miner.run())
        await wait_for(lambda: all(s.live for s in fabric.slots))

        def served():
            return (accepted(pool) >= 1
                    and any(w.accepted for w in gw.getwork_submits)
                    and any(blk.accepted for blk in gbt.blocks))

        async def quantum():
            await fabric._tick()
            await asyncio.sleep(0.3)

        await wait_for(served, 60.0, step=quantum)
        await stop(miner, task, pool, gw, gbt)
        assert {s for _g, s in fabric.dispatch_log} == {0, 1, 2}
        assert all(s.accepted for s in pool.shares)
        assert all(w.accepted for w in gw.getwork_submits)
        assert all(blk.accepted for blk in gbt.blocks)
        kinds = {s.label: (s.kind, s.window.snapshot()["events"])
                 for s in fabric.slots}
        assert [k for k, _n in kinds.values()] == ["stratum", "getwork",
                                                   "gbt"]
        assert all(n >= 1 for _k, n in kinds.values())
        assert miner.dispatcher.stats.shares_rejected == 0

    run(main())


def test_abandoned_teardown_terminates():
    """A caller that raises with the fabric live must still end: bounded
    in a subprocess, so a regression fails instead of hanging."""
    code = (
        "import asyncio\n"
        "from tests.test_torch_multipool import (make_miner, pool_job,\n"
        "    spec, DIFF)\n"
        "from bitcoin_miner_tpu_torch.testing import mock_pool\n"
        "from bitcoin_miner_tpu_torch.testing.chaos_pool import (\n"
        "    ChaosStratumPool)\n"
        "async def main():\n"
        "    a = ChaosStratumPool(difficulty=DIFF)\n"
        "    await a.start()\n"
        "    await a.announce_job(pool_job(mock_pool, 'j1'))\n"
        "    miner = make_miner([spec(a.port)], [0.0])\n"
        "    task = asyncio.create_task(miner.run())\n"
        "    while not a.shares:\n"
        "        await asyncio.sleep(0.05)\n"
        "    a.kill()\n"
        "    raise AssertionError('simulated caller failure')\n"
        "try:\n"
        "    asyncio.run(main())\n"
        "except AssertionError:\n"
        "    print('CLEAN-EXIT')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert "CLEAN-EXIT" in proc.stdout, (proc.stdout, proc.stderr[-2000:])


# ------------------------------------------------------------ wire parity
async def _both_pools_served(fabric, a, b, shares=2, timeout_s=90.0):
    """Routing quanta until each pool accepted ``shares``: a quantum ends
    once the active slot's pool has its count."""
    pools = {fabric.slots[0].label: a, fabric.slots[1].label: b}

    async def quantum():
        active = fabric.active
        if active is not None and accepted(pools[active.label]) >= shares:
            await fabric._tick()

    await wait_for(lambda: all(accepted(p) >= shares for p in (a, b)),
                   timeout_s, interval_s=0.1, step=quantum)


def test_port_fabric_mines_for_reference_pools():
    async def main():
        now = [0.0]
        a, b = await start_two_pools(ref_chaos, ref_mock)
        miner = make_miner([spec(a.port), spec(b.port)], now)
        task = asyncio.create_task(miner.run())
        await _both_pools_served(miner.fabric, a, b)
        await stop(miner, task, a, b)
        for pool in (a, b):
            assert pool.shares and all(s.accepted for s in pool.shares)
            assert all(s.job_id in pool.jobs for s in pool.shares)
        assert miner.dispatcher.stats.hw_errors == 0

    run(main())


def test_reference_fabric_mines_for_port_pools():
    async def main():
        now = [0.0]
        a, b = await start_two_pools(difficulty=EASY)
        miner = ref_mp.MultipoolMiner(
            [ref_mp.parse_pool_spec(f"stratum+tcp://127.0.0.1:{p.port}")
             for p in (a, b)],
            hasher=ref_get_hasher("cpu"), n_workers=2, batch_size=1 << 9,
            stream_depth=0, route_interval_s=NEVER,
            clock=lambda: now[0])
        task = asyncio.create_task(miner.run())
        await _both_pools_served(miner.fabric, a, b, timeout_s=120.0)
        await stop(miner, task, a, b)
        for pool in (a, b):
            assert pool.shares and all(s.accepted for s in pool.shares)
            assert all(s.job_id in pool.jobs for s in pool.shares)

    run(main(), timeout=180)


# -------------------------------------------------- the two divergences
class _GbtClient:
    def __init__(self, reason):
        self.reason = reason

    async def submit_block(self, gbt, extranonce2, header80):
        return self.reason


def _gbt_slot(mp, pipeline, reason):
    fabric = mp.PoolFabric([mp.parse_pool_spec("gbt+http://127.0.0.1:1")],
                           telemetry=pipeline.PipelineTelemetry(),
                           stats=SimpleNamespace(shares_accepted=0,
                                                 shares_rejected=0,
                                                 shares_stale=0))
    slot = fabric.slots[0]
    slot.client = _GbtClient(reason)
    slot._current_gbt = SimpleNamespace(job=SimpleNamespace(
        job_id="gbt-1-1", share_target=1 << 255))
    return fabric, slot


STALE_FAMILY = ["inconclusive-not-best-prevblk", "inconclusive", "duplicate",
                "duplicate-invalid", "stale-prevblk"]


@pytest.mark.parametrize("reason", [None, *STALE_FAMILY, "high-hash",
                                    "bad-txnmrklroot", "rejected"])
def test_gbt_slot_counts_a_stale_block_as_the_port_gbt_miner_does(reason):
    """The port's GbtSlot reads a submitblock answer as GbtMiner does:
    the stale family is stale. The reference's fabric counts every
    non-null answer as rejected."""
    share = Share(job_id="gbt-1-1", extranonce2=b"\x00" * 4, ntime=0,
                  nonce=7, header80=b"\x00" * 80, hash_int=1, is_block=True)
    results = {}
    for name, mp, pipeline in (("ref", ref_mp, ref_pipeline),
                               ("port", port_mp, port_pipeline)):
        fabric, slot = _gbt_slot(mp, pipeline, reason)
        verdict = asyncio.run(slot.submit(share))
        acks = {k[0]: c.value
                for k, c in fabric.telemetry.pool_acks.children()}
        results[name] = (verdict, acks, vars(fabric.stats))
    if reason is None:
        assert results["port"] == results["ref"]
        assert results["port"][0] == "accepted"
    elif reason in STALE_FAMILY:
        assert results["ref"][0] == "rejected"
        assert results["port"] == ("stale", {"stale": 1.0}, {
            "shares_accepted": 0, "shares_rejected": 0, "shares_stale": 1})
    else:
        assert results["port"] == results["ref"]
        assert results["port"][0] == "rejected"


class _Hangs:
    """A client whose every submit waits for ever (a muted pool)."""

    difficulty = 1.0

    async def _wait(self, *args):
        await asyncio.Event().wait()

    submit_share = submit = submit_block = _wait


def _hung_slot(mp, pipeline, kind):
    url = {"stratum": "stratum+tcp", "getwork": "getwork+http",
           "gbt": "gbt+http"}[kind]
    fabric = mp.PoolFabric([mp.parse_pool_spec(f"{url}://127.0.0.1:1")],
                           telemetry=pipeline.PipelineTelemetry())
    slot = fabric.slots[0]
    slot.client = _Hangs()
    job = SimpleNamespace(job_id="j", share_target=1 << 255)
    slot._job = job
    slot._current_gbt = SimpleNamespace(job=job)
    return fabric, slot


@pytest.mark.parametrize("kind", ["stratum", "getwork", "gbt"])
def test_cancelled_submit_lowers_the_in_flight_counts(kind):
    """A submit cut by the session's stop: the port lowers
    ``submits_inflight`` and the slot's ``inflight``; the reference
    leaves both raised."""
    share = Share(job_id="j", extranonce2=b"\x00" * 4, ntime=0, nonce=7,
                  header80=b"\x00" * 80, hash_int=1, is_block=True)

    async def cut(mp, pipeline):
        fabric, slot = _hung_slot(mp, pipeline, kind)
        task = asyncio.create_task(slot.submit(share))
        await wait_for(lambda: slot.inflight == 1, 10.0, interval_s=0.01)
        assert fabric.telemetry.submits_inflight.value == 1
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        return fabric.telemetry.submits_inflight.value, slot.inflight, \
            slot._oldest_inflight_t

    assert run(cut(ref_mp, ref_pipeline))[:2] == (1, 1)
    assert run(cut(port_mp, port_pipeline)) == (0, 0, None)


def test_local_timeouts_do_not_restart_the_stall_clock():
    """Submits to a muted pool time out one after another: the port's
    stall clock runs from the first submit the pool left unanswered,
    pending or timed out, so the slot degrades once the bound passes; the
    reference's restarts at every timeout, stops when nothing is pending,
    and never degrades. An answer from the pool restarts it in both."""
    share = Share(job_id="j", extranonce2=b"\x00" * 4, ntime=0, nonce=7,
                  header80=b"\x00" * 80, hash_int=1, is_block=False)
    out = {}
    for name, mp, pipeline in (("ref", ref_mp, ref_pipeline),
                               ("port", port_mp, port_pipeline)):
        now = [0.0]
        fabric = mp.PoolFabric(
            [mp.parse_pool_spec("stratum+tcp://127.0.0.1:1")],
            telemetry=pipeline.PipelineTelemetry(), stall_after_s=10.0,
            clock=lambda: now[0])
        slot = fabric.slots[0]
        slot.state = mp.ACTIVE
        trail = []
        t_a = slot._submit_opened()
        now[0] = 3.0
        t_b = slot._submit_opened()
        now[0] = 10.0
        slot._verdict("timeout", 1.0, share, t_a)
        now[0] = 11.0
        t_c = slot._submit_opened()
        now[0] = 13.0
        slot._verdict("timeout", 1.0, share, t_b)
        now[0] = 15.0
        trail.append((slot.inflight, slot.stalled_inflight(now[0])))
        asyncio.run(fabric._tick())
        trail.append(slot.state)
        now[0] = 16.0
        slot._verdict("accepted", 1.0, share, t_c)
        t_d = slot._submit_opened()
        now[0] = 20.0
        trail.append((slot.inflight, slot.stalled_inflight(now[0])))
        # Every pending submit times out: nothing is pending, and the pool
        # has still answered none of them.
        now[0] = 22.0
        slot._verdict("timeout", 1.0, share, t_d)
        trail.append((slot.inflight, slot.stalled_inflight(22.0),
                      slot.stalled_inflight(40.0)))
        out[name] = trail
    assert out["ref"] == [(1, False), "active", (1, False),
                          (0, False, False)]
    assert out["port"] == [(1, True), "degraded", (1, False),
                           (0, False, True)]


@dataclasses.dataclass
class _HttpJob:
    job_id: str
    share_target: int = 1 << 255


class _Node:
    """An HTTP slot's client: ``submit``/``submit_block`` raise the
    package's ``JsonRpcError`` (the node's error reply); one poll serves
    ``job`` and ends the slot's poll loop."""

    def __init__(self, slot, getwork, job):
        self.slot = slot
        self.getwork = getwork
        self.job = job

    async def submit(self, *args):
        raise self.getwork.JsonRpcError(-25, "bad-txns-inputs-missingorspent")

    submit_block = submit

    async def _served(self, value):
        self.slot._stopping = True
        return value

    def fetch_work(self):
        return self._served((self.job, bytes(76)))

    def fetch_job(self, longpoll=False):
        template = {"previousblockhash": "00" * 32, "coinbasevalue": 1,
                    "transactions": []}
        return self._served(SimpleNamespace(template=template, job=self.job))


def _http_slot(mp, pipeline, getwork, kind, now):
    url = {"getwork": "getwork+http", "gbt": "gbt+http"}[kind]
    fabric = mp.PoolFabric(
        [mp.parse_pool_spec(f"{url}://127.0.0.1:1")],
        telemetry=pipeline.PipelineTelemetry(), stall_after_s=10.0,
        poll_interval=0.001, clock=lambda: now[0])
    slot = fabric.slots[0]
    job = _HttpJob("j")
    slot.client = _Node(slot, getwork, job)
    slot._job = job
    slot._current_gbt = SimpleNamespace(job=job)
    slot.state = mp.ACTIVE
    return fabric, slot


_HTTP_SHARE = Share(job_id="j", extranonce2=b"\x00" * 4, ntime=0, nonce=7,
                    header80=b"\x00" * 80, hash_int=1, is_block=True)
_PACKAGES = (("ref", ref_mp, ref_pipeline, ref_getwork),
             ("port", port_mp, port_pipeline, port_getwork))


@pytest.mark.parametrize("kind", ["getwork", "gbt"])
def test_http_slot_error_stops_the_stall_clock(kind):
    """A node's error reply to a submit leaves nothing pending: the stall
    clock stops, and later routing quanta leave the slot active, in the
    port as in the reference. (Only a Stratum slot's clock outlives a
    local verdict.)"""
    out = {}
    for name, mp, pipeline, getwork in _PACKAGES:
        now = [0.0]
        fabric, slot = _http_slot(mp, pipeline, getwork, kind, now)

        async def drive():
            result = await slot.submit(_HTTP_SHARE)
            now[0] = 30.0
            stalled = slot.stalled_inflight(now[0])
            await fabric._tick()
            return result, slot.inflight, stalled, slot.state

        out[name] = run(drive())
    assert out["ref"] == ("error", 0, False, "active")
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("kind", ["getwork", "gbt"])
def test_http_slot_leaves_a_stall_at_a_successful_poll(kind):
    """A submit pending past the stall bound degrades an HTTP slot in
    both packages. Once it ended (here in an error) and the node serves a
    poll, the port's slot is active again; the reference's stays degraded
    until the node answers a later submit, which a solo slot sends only
    at a block."""
    out = {}
    for name, mp, pipeline, getwork in _PACKAGES:
        now = [0.0]
        fabric, slot = _http_slot(mp, pipeline, getwork, kind, now)

        async def drive():
            t0 = slot._submit_opened()
            now[0] = 12.0
            await fabric._tick()
            trail = [slot.state]
            now[0] = 15.0
            slot._verdict("error", 1.0, _HTTP_SHARE, t0)
            await slot._poll_loop()
            now[0] = 40.0
            await fabric._tick()
            return trail + [slot.inflight, slot.stalled_inflight(now[0]),
                            slot.state]

        out[name] = run(drive())
    assert out["ref"] == ["degraded", 0, False, "degraded"]
    assert out["port"] == ["degraded", 0, False, "active"]


# ------------------------------------------------- the fabric's readers
def _live_fabrics(now, rates):
    """(reference, port) fabrics of ``len(rates)`` live slots, each slot's
    window fed the same verdicts for the given accept rate (None: no
    verdict yet)."""
    urls = [f"stratum+tcp://127.0.0.1:{i + 1}" for i in range(len(rates))]
    fabrics = _fabrics(urls, now)
    for fabric in fabrics:
        for slot, rate in zip(fabric.slots, rates):
            slot._job = SimpleNamespace(job_id=f"job-{slot.index}")
            slot.set_state("active")
            if rate is None:
                continue
            for i in range(20):
                slot.window.record("accepted" if i < rate * 20
                                   else "rejected", 1.0, 0.01)
    return fabrics


def test_observatory_samples_the_slot_accept_rates():
    """The port's observatory writes ``fabric.slot_accept_rate{pool}``
    from a live fabric. The reference's reads the rate at the slot
    snapshot's top level, where its own fabric does not put it, so with
    its fabric it writes none."""
    now = [0.0]
    ref_fabric, port_fabric = _live_fabrics(now, [0.9, 0.25, None])
    stores = []
    for tsdb, pipeline, fabric in ((ref_tsdb, ref_pipeline, ref_fabric),
                                   (port_tsdb, port_pipeline, port_fabric)):
        store = tsdb.TimeSeriesStore()
        tsdb.Observatory(store, pipeline.PipelineTelemetry(), fabric=fabric,
                         interval_s=NEVER).collect(now=100.0)
        stores.append(store)
    for slot, rate in zip(port_fabric.slots, (0.9, 0.25, None)):
        labels = {"pool": slot.label, "process": "parent"}
        got = stores[1].latest("fabric.slot_accept_rate", labels)
        assert (got is None) if rate is None else got[1] == rate
        assert stores[0].latest("fabric.slot_accept_rate", labels) is None


def test_slo_engine_burns_per_slot_as_the_reference():
    """With a fabric attached, the pool-accept-rate objective reads the
    worst live slot and exports ``slo_slot_burn{objective,pool}`` per
    live slot, as the reference's engine does on the same windows."""
    now = [0.0]
    fabrics = _live_fabrics(now, [1.0, 0.5, None])
    engines = [slo.SloEngine(pipeline.PipelineTelemetry(), fabric=fabric,
                             fast_window_s=4.0, slow_window_s=12.0,
                             min_events=1, clock=lambda: now[0])
               for (slo, pipeline), fabric in zip(
                   ((ref_slo, ref_pipeline), (port_slo, port_pipeline)),
                   fabrics)]
    reports = []
    for t in range(6):
        now[0] = float(t)
        reports.append([e.evaluate() for e in engines])
    strip = [[{k: v for k, v in r.items() if k != "generated_ts"}
              for r in pair] for pair in reports]
    for ref_r, port_r in strip:
        for r in (ref_r, port_r):
            for o in r["objectives"]:
                o.pop("description")
        assert port_r == ref_r
    accept = next(o for o in reports[-1][1]["objectives"]
                  if o["name"] == "pool-accept-rate")
    assert accept["sli_fast"] == 0.5
    assert set(accept["slots"]) == {"127.0.0.1:1", "127.0.0.1:2"}
    gauges = [{k: c.value for k, c in e.telemetry.slo_slot_burn.children()}
              for e in engines]
    assert gauges[1] == gauges[0]
    assert set(gauges[1]) == {("pool-accept-rate", "127.0.0.1:1"),
                              ("pool-accept-rate", "127.0.0.1:2")}
    assert gauges[1][("pool-accept-rate", "127.0.0.1:2")] > 0


def test_incident_bundle_holds_the_fabric_snapshot(tmp_path):
    now = [0.0]
    _ref, fabric = _live_fabrics(now, [1.0, 0.5])
    tel = port_pipeline.PipelineTelemetry()
    capture = port_slo.IncidentCapture(tel, str(tmp_path / "inc"),
                                       fabric=fabric)
    manifest_path = capture.capture("manual")
    assert manifest_path is not None
    with open(manifest_path) as f:
        manifest = json.load(f)
    assert manifest["errors"] == []
    with open(os.path.join(os.path.dirname(manifest_path),
                           "telemetry.json")) as f:
        payload = json.load(f)
    assert payload["pool_fabric"] == json.loads(json.dumps(
        fabric.snapshot()))
    assert [s["label"] for s in payload["pool_fabric"]["slots"]] == [
        "127.0.0.1:1", "127.0.0.1:2"]


def _surface_fabric():
    return port_mp.PoolFabric(
        [port_mp.parse_pool_spec("stratum+tcp://127.0.0.1:1#w=2"),
         port_mp.parse_pool_spec("stratum+tcp://127.0.0.1:2")],
        telemetry=port_pipeline.PipelineTelemetry())


def test_reporter_pools_fragment():
    fabric = _surface_fabric()
    reporter = StatsReporter(MinerStats(), interval=1, fabric=fabric)
    assert reporter.tick().endswith(" | pools 0/2 live")
    fabric.slots[0].state = port_mp.ACTIVE
    fabric.slots[0]._job = object()
    assert reporter.tick().endswith(" | pools 1/2 live")


def test_reporter_without_fabric_unchanged():
    assert "pools" not in StatsReporter(MinerStats(), interval=1).tick()


def test_snapshot_matches_reference():
    """The snapshot ``/telemetry`` and incident bundles carry has the
    reference's keys and values on the same state (rates and weights are
    exact; the windows hold the same verdicts)."""
    now = [0.0]
    snaps = [f.snapshot() for f in _live_fabrics(now, [1.0, 0.25, None])]
    assert snaps[1] == snaps[0]


# ------------------------------------------------------------ command line
def _args(*argv, tmp_path=None):
    extra = []
    if tmp_path is not None:
        extra = ["--flightrec-out", str(tmp_path / "fr.json"),
                 "--incident-dir", str(tmp_path / "inc")]
    return cli.build_parser().parse_args([*argv, "--device", "cpu",
                                          "--batch-bits", "12", *extra])


def test_cli_builds_the_fabric_and_keeps_the_one_pool_session():
    one = cli.make_miner(_args("--pool", "stratum+tcp://127.0.0.1:1"))
    assert isinstance(one, StratumMiner)
    assert not hasattr(one, "fabric")
    miner = cli.make_miner(_args(
        "--pool", "stratum+tcp://127.0.0.1:1#w=3",
        "--pool", "stratum+ssl://127.0.0.1:2", "--pool",
        "gbt+http://127.0.0.1:3/rpc", "--host-index", "1", "--n-hosts", "2",
        "--ntime-roll", "30", "--suggest-difficulty", "0.5",
        "--tls-no-verify", "--stream-depth", "0", "--workers", "3",
        "--batch-3x", "--sublanes", "24"))
    assert isinstance(miner, port_mp.MultipoolMiner)
    d, f = miner.dispatcher, miner.fabric
    assert [(s.kind, s.spec.weight, s.spec.use_tls) for s in f.slots] == [
        ("stratum", 3.0, False), ("stratum", 1.0, True), ("gbt", 1.0, False)]
    assert f.slots[2].spec.http_url == "http://127.0.0.1:3/rpc"
    assert (d.extranonce2_start, d.extranonce2_step, d.ntime_roll) == (
        1, 2, 30)
    assert (d.stream_depth, d.n_workers, d.batch_size) == (0, 3, 3 << 12)
    assert f.suggest_difficulty == 0.5 and f.tls_verify is False
    assert f.slots[0].client.suggest_difficulty == 0.5
    assert (f.route_interval_s, f.stall_after_s, f.request_timeout) == (
        10.0, 10.0, 10.0)
    single = cli.make_miner(_args("--pool", "getwork+http://127.0.0.1:4"))
    assert isinstance(single, port_mp.MultipoolMiner)
    assert [s.kind for s in single.fabric.slots] == ["getwork"]


@pytest.mark.parametrize("argv,message", [
    (["--pool", "a:1,b:2", "--pool", "c:3"], "one URL per flag"),
    (["--pool", "a:1", "--pool", "b:2", "--checkpoint", "x"],
     "--checkpoint is not supported with the multi-pool fabric"),
    (["--pool", "a:1", "--pool", "b:2", "--allow-redirect"],
     "--allow-redirect applies only to --pool; the multi-pool fabric"),
    (["--pool", "a:1", "--pool", "ftp://b:2"], "unsupported pool scheme"),
    (["--pool", "a:1#w=0", "--pool", "b:2"], "weight must be > 0"),
    (["--pool", "a:1#w=x", "--pool", "b:2"], "bad pool weight"),
    (["--pool", "gbt+http://a:1", "--suggest-difficulty", "0"],
     "must be > 0"),
    (["--pool", "a:1", "--pool", "b:2", "--n-hosts", "0"], "not in"),
])
def test_cli_fabric_refusals(argv, message):
    with pytest.raises(SystemExit, match=message):
        cli.make_miner(_args(*argv))


def test_cli_fabric_session_serves_its_snapshot(tmp_path):
    """``--pool A#w=3 --pool B --device cpu --status-port P`` through
    ``cli.run_session``: both pools' shares accepted, ``/telemetry``
    carries ``pool_fabric``, ``/healthz`` the ``pools`` component, and
    the run leaves no file of the checkout changed."""
    async def main():
        a, b = await start_two_pools()
        port = cli_port()
        args = _args("--pool", f"stratum+tcp://127.0.0.1:{a.port}#w=3",
                     "--pool", f"stratum+tcp://127.0.0.1:{b.port}",
                     "--workers", "2", "--stream-depth", "0",
                     "--status-port", str(port), "--health-interval", "0.2",
                     tmp_path=tmp_path)
        previous = port_pipeline.set_telemetry(
            port_pipeline.PipelineTelemetry())
        try:
            miner = cli.make_miner(args)
            task = asyncio.create_task(cli.run_session(miner, args))
            await wait_for(lambda: accepted(a) + accepted(b) >= 2)
            tele = json.loads((await _get(port, "/telemetry"))[1])
            status, body = await _get(port, "/healthz")
            miner.stop()
            await asyncio.wait_for(task, 30)
        finally:
            port_pipeline.set_telemetry(previous)
            await a.stop()
            await b.stop()
        snap = tele["pool_fabric"]
        assert [s["label"] for s in snap["slots"]] == [
            f"127.0.0.1:{a.port}", f"127.0.0.1:{b.port}"]
        assert [s["base_weight"] for s in snap["slots"]] == [3.0, 1.0]
        assert snap["active"] in (snap["slots"][0]["label"],
                                  snap["slots"][1]["label"])
        health = json.loads(body)
        assert status == 200 and health["components"]["pools"]["state"] \
            == "ok"

    run(main())


def cli_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


async def _get(port, path):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), 10)
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body
