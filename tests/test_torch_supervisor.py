"""The PyTorch package's fleet supervisor on the CPU: children are the
port's hit-buffer hasher (its plain version) under ``ChaosHasher``, and
every range they answer is held against the port's hashlib oracle, so a
lost or duplicated nonce shows. Reclaim, quarantine → probe → rejoin,
hang detection with the late result dropped and capacity weights, as the
JAX package's ``tests/test_supervisor.py`` checks them; ``cuda-fleet`` and
``--worker`` through the command line; the fleet's metric families, its
health rule and the lifecycle's dispatch attribution at exact parity with
the reference on the same inputs; and a Stratum session on a fleet of two
served workers, one stopped mid-session, whose shares the port's
validating pool accepts."""

import asyncio
import json
import queue
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from bitcoin_miner_tpu.telemetry import health as ref_health
from bitcoin_miner_tpu.telemetry import lifecycle as ref_lifecycle
from bitcoin_miner_tpu.telemetry import pipeline as ref_pipeline
from bitcoin_miner_tpu_torch import cli
from bitcoin_miner_tpu_torch.backends.base import (
    STREAM_FLUSH,
    ScanRequest,
    ScanResult,
)
from bitcoin_miner_tpu_torch.backends.cuda import CudaHasher
from bitcoin_miner_tpu_torch.core.header import GENESIS_HEADER_HEX, GENESIS_NONCE
from bitcoin_miner_tpu_torch.core.sha256 import sha256d
from bitcoin_miner_tpu_torch.core.target import difficulty_to_target, nbits_to_target
from bitcoin_miner_tpu_torch.miner.scheduler import (
    AdaptiveBatchScheduler,
    stream_sweep,
)
from bitcoin_miner_tpu_torch.parallel.fanout import MultiChildError
from bitcoin_miner_tpu_torch.parallel.supervisor import (
    ACTIVE,
    DEGRADED,
    QUARANTINED,
    FleetSupervisor,
    make_cuda_mesh_fleet,
)
from bitcoin_miner_tpu_torch.telemetry import (
    HealthModel,
    NullTelemetry,
    PipelineTelemetry,
)
from bitcoin_miner_tpu_torch.telemetry import health as port_health
from bitcoin_miner_tpu_torch.telemetry import lifecycle as port_lifecycle
from bitcoin_miner_tpu_torch.telemetry import pipeline as port_pipeline
from bitcoin_miner_tpu_torch.testing.chaos_hasher import ChaosHasher
from tests.test_torch_grpc import RingBackend as RingChild


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


HEADER = bytes.fromhex(GENESIS_HEADER_HEX)[:76]
EASY = difficulty_to_target(1 / (1 << 24))  # ~2^-8 per nonce
DIFF1 = nbits_to_target(0x1D00FFFF)
#: nonces per request: one dispatch of a child.
N = 256
SEEDS = [0, 1, 2, 3, 4, 5]

def oracle_scan(start, count, max_hits=64):
    """The specification over one range: the port's ``sha256d`` (hashlib)
    of each header against the target, as ``ScanResult`` counts it."""
    hits = [n for n in range(start, start + count)
            if int.from_bytes(sha256d(HEADER + n.to_bytes(4, "little")),
                              "little") <= EASY]
    return ScanResult(nonces=hits[:max_hits], total_hits=len(hits),
                      hashes_done=count)


def child(label=None):
    return ChaosHasher(CudaHasher(batch_size=N, inner_size=N, device="cpu"),
                       label=label)


def make_fleet(n=3, stall=30.0, base=0.1, cap=0.3, telemetry=None):
    chaos = [child(str(i)) for i in range(n)]
    fleet = FleetSupervisor(chaos, stall_after_s=stall, quarantine_base_s=base,
                            quarantine_cap_s=cap, telemetry=telemetry)
    return chaos, fleet


def requests(k, count=N):
    return [ScanRequest(header76=HEADER, nonce_start=i * count, count=count,
                        target=EASY, tag=i) for i in range(k)]


def assert_oracle_exact(results, count=N, k=None):
    """Every request answered once, in order, each with the oracle's hits
    and hashes: nothing lost, nothing duplicated."""
    k = len(results) if k is None else k
    assert [r.request.tag for r in results] == list(range(k))
    assert sorted((r.request.nonce_start, r.request.count)
                  for r in results) == [(i * count, count) for i in range(k)]
    for res in results:
        want = oracle_scan(res.request.nonce_start, res.request.count)
        assert res.result.nonces == want.nonces
        assert res.result.total_hits == want.total_hits
        assert res.result.hashes_done == want.hashes_done


class TestHealthyFleet:
    def test_stream_order_and_parity(self):
        _chaos, fleet = make_fleet(3)
        assert_oracle_exact(list(fleet.scan_stream(iter(requests(9)))))
        assert fleet.reclaims == 0

    def test_scan_finds_genesis(self):
        _chaos, fleet = make_fleet(2)
        got = fleet.scan(HEADER, GENESIS_NONCE - 64, 192, DIFF1)
        assert got.nonces == [GENESIS_NONCE]

    def test_flush_is_transparent(self):
        _chaos, fleet = make_fleet(2)
        reqs = requests(5)
        fed = [reqs[0], STREAM_FLUSH, *reqs[1:3], STREAM_FLUSH, *reqs[3:]]
        assert_oracle_exact(list(fleet.scan_stream(iter(fed))))

    def test_needs_children(self):
        with pytest.raises(ValueError):
            FleetSupervisor([])

    def test_stream_depth_and_dispatch_size(self):
        fleet = FleetSupervisor([CudaHasher(batch_size=1 << 12,
                                            inner_size=1 << 10,
                                            device="cpu")
                                 for _ in range(3)])
        assert fleet.stream_depth == 3 * (2 + 1) - 1
        assert fleet.dispatch_size == 1 << 12


class TestReclaim:
    def test_stream_sweep_with_mid_sweep_kill_stays_exact(self):
        """The bench's path (``stream_sweep``, adaptive sizes) over the
        fleet, a child dying mid-sweep: the hits and the hashes are the
        oracle's, exactly."""
        chaos, fleet = make_fleet(3)
        chaos[1].die_after_scans = 2
        sched = AdaptiveBatchScheduler(min_bits=5, max_bits=8,
                                       telemetry=NullTelemetry())
        report = stream_sweep(fleet, HEADER, 0, 16 * N, EASY,
                              scheduler=sched)
        assert report.nonces == sorted(oracle_scan(0, 16 * N).nonces)
        assert report.hashes_done == 16 * N
        assert fleet.reclaims >= 1

    def test_kill_mid_stream_no_gap_no_duplicate(self):
        chaos, fleet = make_fleet(3)
        chaos[1].die_after_scans = 2
        assert_oracle_exact(list(fleet.scan_stream(iter(requests(24)))))
        assert fleet.reclaims >= 1
        assert fleet.states[1].state in (QUARANTINED, "probing", DEGRADED)

    def test_survivors_keep_producing_same_stream(self):
        chaos, fleet = make_fleet(3)
        out = []
        for i, res in enumerate(fleet.scan_stream(iter(requests(24)))):
            out.append(res)
            if i == 5:
                chaos[0].kill()
        assert_oracle_exact(out)  # one stream, no restart
        assert chaos[1].scans_done > 0 and chaos[2].scans_done > 0

    def test_hang_reclaimed_and_late_result_dropped(self):
        """A hung child's requests are reclaimed after ``stall_after_s``;
        its hung scan, released later, completes, and that late result is
        dropped by the epoch check, never yielded twice."""
        chaos, fleet = make_fleet(3, stall=1.0)
        out = []
        for i, res in enumerate(fleet.scan_stream(iter(requests(18)))):
            out.append(res)
            if i == 2:
                chaos[2].hang = True
            if i == 11:
                chaos[2].revive()
        assert_oracle_exact(out)
        assert fleet.reclaims >= 1 and fleet.states[2].quarantines >= 1

    def test_all_children_dead_raises_aggregate(self):
        chaos, fleet = make_fleet(3)
        for c in chaos:
            c.kill()
        with pytest.raises(MultiChildError) as ei:
            list(fleet.scan_stream(iter(requests(3))))
        for label in ("0", "1", "2"):
            assert f"chip {label}" in str(ei.value)

    def test_blocking_scan_fails_over_whole_range(self):
        chaos, fleet = make_fleet(2)
        for c in chaos:
            c.kill()
        with pytest.raises(MultiChildError):
            fleet.scan(HEADER, 0, N, EASY)
        chaos[1].revive()
        want = oracle_scan(0, 4 * N)
        got = fleet.scan(HEADER, 0, 4 * N, EASY)
        assert (got.nonces, got.hashes_done) == (want.nonces,
                                                 want.hashes_done)


class TestQuarantineRejoin:
    def test_fsm_walks_quarantine_probe_probation_active(self):
        chaos, fleet = make_fleet(3, base=0.05, cap=0.15)
        # A full share on probation, so that the 8 clean results come
        # sooner; the shrunken share has a test of its own below.
        fleet.DEGRADED_FACTOR = 1.0
        chaos[1].kill()
        list(fleet.scan_stream(iter(requests(6))))
        assert fleet.states[1].state == QUARANTINED
        chaos[1].revive()
        deadline = time.monotonic() + 30.0
        while (fleet.states[1].state != ACTIVE
               and time.monotonic() < deadline):
            assert_oracle_exact(list(fleet.scan_stream(iter(requests(9)))))
            time.sleep(0.05)
        assert fleet.states[1].state == ACTIVE
        assert chaos[1].scans_done > 0

    def test_probe_failure_regrows_cooldown(self):
        chaos, fleet = make_fleet(2, base=0.05, cap=0.2)
        chaos[0].kill()
        list(fleet.scan_stream(iter(requests(4))))
        q0 = fleet.states[0].quarantines
        time.sleep(0.25)  # past the cooldown: the next stream probes
        list(fleet.scan_stream(iter(requests(4))))
        assert fleet.states[0].quarantines > q0
        assert fleet.states[0].state == QUARANTINED

    def test_version_mask_rebroadcast_on_rejoin(self):
        chaos, fleet = make_fleet(2, base=0.05, cap=0.15)
        assert fleet.set_version_mask(0x1FFFE000) == 0
        assert chaos[0].mask_calls == [0x1FFFE000]
        chaos[0].kill()
        list(fleet.scan_stream(iter(requests(4))))
        chaos[0].revive()
        deadline = time.monotonic() + 30.0
        while (fleet.states[0].state == QUARANTINED
               and time.monotonic() < deadline):
            time.sleep(0.05)
            list(fleet.scan_stream(iter(requests(4))))
        assert chaos[0].mask_calls.count(0x1FFFE000) >= 2

    def test_mask_error_quarantines_not_aborts(self):
        chaos, fleet = make_fleet(2)
        chaos[1].kill()
        assert fleet.set_version_mask(0x1FFFE000) == 0
        assert [s.state for s in fleet.states] == [ACTIVE, QUARANTINED]

    def test_rejoined_child_does_not_monopolize_assignment(self):
        """A rejoined child's stride pass is resynced to the live set's:
        its probation share stays smaller than each survivor's."""
        chaos, fleet = make_fleet(3, base=0.05, cap=0.15)
        chaos[1].kill()
        list(fleet.scan_stream(iter(requests(60, count=32))))
        chaos[1].revive()
        deadline = time.monotonic() + 30.0
        while (fleet.states[1].state == QUARANTINED
               and time.monotonic() < deadline):
            time.sleep(0.05)
            list(fleet.scan_stream(iter(requests(3))))
        assert fleet.states[1].state == DEGRADED
        before = [c.scans_done for c in chaos]
        assert_oracle_exact(list(fleet.scan_stream(iter(requests(16)))))
        delta = [c.scans_done - b for c, b in zip(chaos, before)]
        assert delta[1] < delta[0] and delta[1] < delta[2]

    def test_transient_error_quarantines_then_recovers(self):
        chaos, fleet = make_fleet(2, base=0.05, cap=0.15)
        chaos[0].error_every_n = 5
        assert_oracle_exact(list(fleet.scan_stream(iter(requests(16)))))
        assert fleet.states[0].quarantines >= 1


class TestRingChildren:
    def test_ring_children_stream_completes(self):
        fleet = FleetSupervisor([RingChild(2) for _ in range(3)],
                                stall_after_s=5.0)
        assert_oracle_exact(list(fleet.scan_stream(iter(requests(20)))))
        assert all(s.state == ACTIVE for s in fleet.states)

    def test_low_weight_ring_child_not_falsely_hung(self):
        """A low-share child below its ring's emit threshold holding the
        next result is flushed, not taken for hung."""
        fleet = FleetSupervisor([RingChild(2) for _ in range(3)],
                                stall_after_s=2.0)
        fleet.states[0].state = DEGRADED
        fleet.states[0].latencies.extend([1.0] * 8)
        for st in fleet.states[1:]:
            st.latencies.extend([0.01] * 8)
        assert_oracle_exact(list(fleet.scan_stream(iter(requests(30)))))
        assert all(s.quarantines == 0 for s in fleet.states)


    @pytest.mark.parametrize("depth", [1, 2])
    def test_reclaimed_requests_are_flushed_out_of_a_survivor_ring(
            self, depth):
        """A dead worker's requests, and each failed half-open probe's, go
        to the survivor, whose ring holds them below its emit threshold
        while the dispatcher, its window full, sends nothing newer. The
        reclaim flushes them out; the reference's (and this package's
        before) left them there until the hang detector quarantined the
        survivor too (depth 1), or the whole fleet (depth 2)."""
        survivor = RingChild(depth)
        dead = GoneRingChild(depth, answered=2, surfaces_after_s=0.3)
        fleet = FleetSupervisor([survivor, dead], stall_after_s=2.0,
                                quarantine_base_s=0.05, quarantine_cap_s=0.2)
        out = windowed_stream(fleet, requests(40), fleet.stream_depth + 1)
        assert_oracle_exact(out)
        assert fleet.states[0].quarantines == 0
        assert fleet.states[1].quarantines >= 2  # its probes failed too


class GoneRingChild(RingChild):
    """A ring child that answers ``answered`` requests of its first stream
    and is then gone: each stream fails ``surfaces_after_s`` after its
    next request, as a killed worker's stream (and each probe of it)
    surfaces once the client's unavailability deadline passes."""

    def __init__(self, depth, answered, surfaces_after_s):
        super().__init__(depth)
        self.budget = answered
        self.surfaces_after_s = surfaces_after_s

    def scan_stream(self, reqs):
        budget, self.budget = self.budget, 0

        def until_gone():
            n = 0
            for req in reqs:
                if req is not STREAM_FLUSH:
                    n += 1
                    if n > budget:
                        time.sleep(self.surfaces_after_s)
                        raise ConnectionError("worker unavailable")
                yield req

        yield from super().scan_stream(until_gone())


def windowed_stream(fleet, reqs, window):
    """``fleet.scan_stream`` fed as the dispatcher feeds it: from another
    thread, at most ``window`` requests ahead of the results consumed."""
    fed: "queue.SimpleQueue" = queue.SimpleQueue()
    slots = threading.Semaphore(window)

    def feeder():
        for req in reqs:
            slots.acquire()
            fed.put(req)
        fed.put(None)

    def source():
        while (req := fed.get()) is not None:
            yield req

    thread = threading.Thread(target=feeder, name="test-feeder", daemon=True)
    thread.start()
    out = []
    for res in fleet.scan_stream(source()):
        out.append(res)
        slots.release()
    thread.join(timeout=10)
    assert not thread.is_alive()
    return out


class TestCapacityWeights:
    def test_slow_child_share_shrinks_not_skipped(self):
        chaos, fleet = make_fleet(3, stall=60.0)
        chaos[0].delay_s = 0.5
        assert_oracle_exact(list(fleet.scan_stream(iter(requests(36)))))
        done = [c.scans_done for c in chaos]
        assert 1 <= done[0] < min(done[1], done[2])
        assert fleet.states[0].state == DEGRADED
        assert fleet.weight_of(fleet.states[0]) < fleet.weight_of(
            fleet.states[1])


class TestTelemetry:
    def test_child_state_gauge_and_reclaim_counter(self):
        tel = PipelineTelemetry()
        chaos, fleet = make_fleet(3, telemetry=tel)
        chaos[2].die_after_scans = 1
        list(fleet.scan_stream(iter(requests(12))))
        rendered = tel.registry.render()
        assert 'tpu_miner_fleet_child_state{child="2"}' in rendered
        assert "tpu_miner_fleet_reclaims_total" in rendered
        states = {k[0]: c.value for k, c in tel.fleet_child_state.children()}
        assert set(states) == {"0", "1", "2"} and states["2"] > 0

    def test_flightrec_carries_transitions_and_reclaims(self):
        tel = PipelineTelemetry()
        chaos, fleet = make_fleet(2, telemetry=tel)
        chaos[0].die_after_scans = 1
        list(fleet.scan_stream(iter(requests(8))))
        kinds = {e["kind"] for e in tel.flightrec.snapshot()}
        assert {"fleet_child", "fleet_reclaim"} <= kinds

    def test_health_model_fleet_component_live(self):
        tel = PipelineTelemetry()
        chaos, fleet = make_fleet(2, telemetry=tel)
        model = HealthModel(tel)
        assert model.evaluate()["fleet"].state == "ok"
        chaos[1].kill()
        list(fleet.scan_stream(iter(requests(4))))
        assert model.evaluate()["fleet"].state == "degraded"

    def test_duplicate_labels_get_distinct_gauge_children(self):
        tel = PipelineTelemetry()
        chaos = [child("w") for _ in range(2)]
        fleet = FleetSupervisor(chaos, telemetry=tel, quarantine_base_s=5.0,
                                quarantine_cap_s=10.0)
        assert fleet.chip_labels == ["w", "w/1"]
        chaos[1].kill()
        list(fleet.scan_stream(iter(requests(4))))
        states = {k[0]: c.value for k, c in tel.fleet_child_state.children()}
        assert states["w"] == 0.0 and states["w/1"] > 0.0
        assert HealthModel(tel).evaluate()["fleet"].state == "degraded"

    def test_snapshot_shape(self):
        chaos, fleet = make_fleet(2)
        chaos[1].kill()
        list(fleet.scan_stream(iter(requests(4))))
        snap = fleet.snapshot()
        assert snap["reclaims"] == fleet.reclaims
        assert [c["label"] for c in snap["children"]] == ["0", "1"]
        assert snap["children"][1]["state"] == QUARANTINED
        assert snap["children"][1]["last_error"]

    def test_pump_threads_inherit_trace_context(self):
        tel = PipelineTelemetry()
        tel.tracer.enabled = True

        class Spanning:
            """A child that leaves one span per scan on the thread that
            drives it (its pump)."""

            inner = CudaHasher(batch_size=N, inner_size=N, device="cpu")

            def scan(self, *a, **k):
                tel.tracer.instant("fleet_span", cat="device")
                return self.inner.scan(*a, **k)

        fleet = FleetSupervisor([Spanning(), Spanning()], telemetry=tel)
        with tel.tracer.context("feedfeedfeedfeed"):
            list(fleet.scan_stream(iter(requests(6, count=32))))
        spans = [e for e in tel.tracer.events() if e["name"] == "fleet_span"]
        assert spans and {e["args"]["trace"] for e in spans} == {
            "feedfeedfeedfeed"}

    def test_lifecycle_dispatch_attribution(self):
        tel = PipelineTelemetry()
        _chaos, fleet = make_fleet(2, telemetry=tel)
        list(fleet.scan_stream(iter(requests(6))))
        for i in range(6):
            hit = tel.lifecycle._attribution(i * N + 3)
            assert hit is not None and hit["child"] in ("0", "1")
        fleet.scan(HEADER, 10_000, 64, EASY)
        hit = tel.lifecycle._attribution(10_031)
        assert hit is not None and hit["count"] == 64


_TEARDOWN_SCRIPT = r"""
import sys
from bitcoin_miner_tpu_torch.backends.base import ScanRequest, get_hasher
from bitcoin_miner_tpu_torch.core.header import GENESIS_HEADER_HEX
from bitcoin_miner_tpu_torch.core.target import difficulty_to_target
from bitcoin_miner_tpu_torch.parallel.supervisor import FleetSupervisor
from bitcoin_miner_tpu_torch.testing.chaos_hasher import ChaosHasher

HEADER = bytes.fromhex(GENESIS_HEADER_HEX)[:76]
EASY = difficulty_to_target(1 / (1 << 24))
chaos = [ChaosHasher(get_hasher("cpu"), label=str(i)) for i in range(3)]
fleet = FleetSupervisor(chaos, stall_after_s=30.0, quarantine_base_s=0.05,
                        quarantine_cap_s=0.2)
chaos[1].hang = True  # wedged for ever, never revived
stream = fleet.scan_stream(iter(
    ScanRequest(header76=HEADER, nonce_start=i * 128, count=128,
                target=EASY, tag=i) for i in range(6)))
next(stream)
stream.close()  # abandoned with a hung child holding work
print("closed-ok")
sys.exit(0)
"""


def test_abandoned_stream_with_hung_child_exits():
    """Abandoning a stream while a child is wedged (its daemon pump parked
    in a hung scan) must not hang the interpreter's exit. The children are
    the hashlib oracle: a process that exits while a thread is inside a
    torch call aborts, whatever the supervisor does."""
    proc = subprocess.run([sys.executable, "-c", _TEARDOWN_SCRIPT],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "closed-ok" in proc.stdout


def test_mesh_fleet_groups_of_mesh_native_hashers():
    """``make_cuda_mesh_fleet``: two mesh groups of two shards on the CPU,
    each a mesh-native hasher, supervised; a dead group is reclaimed."""
    fleet = make_cuda_mesh_fleet(groups=2, devices=["cpu"] * 4,
                                 batch_per_device=N, inner_size=N,
                                 stall_after_s=5.0, quarantine_base_s=1.0)
    assert fleet.chip_labels == ["mesh0", "mesh1"]
    assert [c.n_devices for c in fleet.children] == [2, 2]
    assert fleet.dispatch_size == 2 * N
    fleet.children[1] = ChaosHasher(fleet.children[1], label="mesh1")
    fleet.children[1].die_after_scans = 1
    assert_oracle_exact(list(fleet.scan_stream(iter(requests(8, 2 * N)))),
                        count=2 * N)
    assert fleet.reclaims >= 1
    with pytest.raises(ValueError, match="equal mesh groups"):
        make_cuda_mesh_fleet(groups=3, devices=["cpu"] * 4)


# ------------------------------------------------- parity with the reference
def test_fleet_levels_and_families_match_reference():
    assert port_pipeline.FLEET_CHILD_LEVELS == ref_pipeline.FLEET_CHILD_LEVELS
    rendered = []
    for pipeline in (ref_pipeline, port_pipeline):
        tel = pipeline.PipelineTelemetry()
        for label, state in (("0", "active"), ("w/1", "quarantined"),
                             ("127.0.0.1:5", "probing")):
            tel.fleet_child_state.labels(child=label).set(
                pipeline.FLEET_CHILD_LEVELS[state])
        tel.fleet_reclaims.labels(reason="error").inc(3)
        tel.fleet_reclaims.labels(reason="hang").inc()
        rendered.append([tel.fleet_child_state.render(),
                         tel.fleet_reclaims.render()])
    assert rendered[1] == rendered[0]


def _fleet_snapshots(seed):
    """Synthetic snapshots whose fleet gauges walk every level, with the
    other signals quiet."""
    rng = np.random.default_rng(seed)
    levels = list(port_pipeline.FLEET_CHILD_LEVELS.values())
    snap = {"batches": 0, "active_scans": 0, "gap_count": 0, "gap_sum": 0.0,
            "ring_occupancy": 0.0, "ring_collects": 0, "stream_window": 0.0,
            "rpc_responses": 0.0, "rpc_errors": 0.0,
            "submits_inflight": 0.0, "pool_acks": {}, "chips": {},
            "share_expected": 0.0, "share_efficiency": 0.0}
    out = []
    for step in range(40):
        snap = json.loads(json.dumps(snap))
        n = int(rng.integers(0, 4))
        snap["fleet_children"] = {
            f"w{i}": float(levels[int(rng.integers(len(levels)))])
            for i in range(n)}
        if step % 7 == 0:
            snap.pop("fleet_children")
        out.append((float(step), snap))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_fleet_health_verdicts_match_reference(seed):
    """The ``fleet`` rule on the same snapshots: the same verdicts,
    reasons, ``/healthz`` payloads, gauges and transition events."""
    results = []
    for pipeline, health, kw in (
            (ref_pipeline, ref_health, {"relay_probe": lambda: False}),
            (port_pipeline, port_health, {})):
        tel = pipeline.PipelineTelemetry()
        model = health.HealthModel(tel, **kw)
        trail = []
        for now, snap in _fleet_snapshots(seed):
            report = model.evaluate(snap, now=now)
            model.publish(report)
            trail.append(([(c.component, c.state, c.reason)
                           for c in report.values()], model.healthz(report)))
        events = [{k: v for k, v in e.items()
                   if k not in ("ts", "mono", "thread")}
                  for e in tel.flightrec.snapshot()]
        results.append((trail, events))
    assert results[1] == results[0]
    assert any("fleet" in dict((c, s) for c, s, _ in t[0])
               for t in results[1][0])


def test_health_sample_reads_the_fleet_gauges_as_the_reference():
    samples = []
    for pipeline, health, kw in (
            (ref_pipeline, ref_health, {"relay_probe": lambda: False}),
            (port_pipeline, port_health, {})):
        tel = pipeline.PipelineTelemetry()
        tel.fleet_child_state.labels(child="a").set(3.0)
        tel.fleet_child_state.labels(child="b").set(0.0)
        samples.append(health.HealthModel(tel, **kw).sample()[
            "fleet_children"])
    assert samples[0] == samples[1] == {"a": 3.0, "b": 0.0}


@pytest.mark.parametrize("seed", SEEDS)
def test_lifecycle_attribution_matches_reference(seed):
    """Seeded dispatch notes and hits: the same attribution (newest match
    wins, job ids must agree where both carry one) and the same records."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(200):
        start = int(rng.integers(0, 1 << 12))
        job = [None, "j1", "j2"][int(rng.integers(3))]
        if rng.random() < 0.6:
            ops.append(("dispatch", start, int(rng.integers(1, 512)),
                        f"c{int(rng.integers(4))}", job))
        else:
            ops.append(("found", start, job or "j1"))
    out = []
    for lifecycle in (ref_lifecycle, port_lifecycle):
        ledger = lifecycle.ShareLifecycleLedger(capacity=64,
                                                attribution_window=16,
                                                clock=lambda: 5.0)
        seen = []
        for op in ops:
            if op[0] == "dispatch":
                kw = {"job_id": op[4]} if op[4] else {}
                ledger.note_dispatch(nonce_start=op[1], count=op[2],
                                     child=op[3], **kw)
            else:
                seen.append(ledger._attribution(op[1], job_id=op[2]))
                ledger.found(f"{op[2]}|{op[1]}", job_id=op[2], nonce=op[1])
        records = [{k: v for k, v in r.items()
                    if k not in ("born_ts", "last_t", "born_t")}
                   for r in ledger.dump_dict()["records"]]
        for r in records:
            for hop in r["hops"]:
                hop.pop("ts"), hop.pop("t")
        out.append((seen, records))
    assert out[1] == out[0]
    assert any(s is not None for s in out[1][0])


# ----------------------------------------------------------- command line
def _args(*argv):
    return cli.build_parser().parse_args(
        [*argv, "--flightrec-out", "/dev/null"])


def test_cuda_fleet_through_the_command_line():
    """``--backend cuda-fleet --device cpu``: one supervised hit-buffer
    child on the CPU, its step from ``--inner-bits``; the bench finds the
    genesis nonce through it."""
    fleet = cli.make_hasher(_args("--bench", "--backend", "cuda-fleet",
                                  "--device", "cpu", "--batch-bits", "12",
                                  "--inner-bits", "10"))
    assert isinstance(fleet, FleetSupervisor) and fleet.name == "cuda-fleet"
    assert fleet.n_children == 1 and fleet.dispatch_size == 1 << 12
    assert fleet.children[0].inner_size == 1 << 10
    assert fleet.children[0].device.type == "cpu"
    out = cli.bench(_args("--bench", "--backend", "cuda-fleet", "--device",
                          "cpu", "--batch-bits", "12", "--bench-nonces",
                          str(1 << 13)))
    assert out["verified"] and out["hashes"] == 1 << 13
    with pytest.raises(SystemExit, match="--mesh-devices 2"):
        cli.make_hasher(_args("--bench", "--backend", "cuda-fleet",
                              "--device", "cpu", "--mesh-devices", "2"))
    with pytest.raises(SystemExit, match="--variant"):
        cli.make_hasher(_args("--bench", "--backend", "cuda-fleet",
                              "--device", "cpu", "--variant", "wstage"))


@pytest.mark.parametrize("argv,message", [
    (["--worker", "127.0.0.1:1", "--backend", "cuda"],
     "cannot combine with --backend cuda"),
    (["--worker", "127.0.0.1:1", "--backend", "grpc", "--grpc-target",
      "127.0.0.1:2"], "single-worker"),
    (["--worker", "127.0.0.1:1", "--vshare", "2"], "--vshare 2 applies only to a local hasher"),
    (["--worker", "127.0.0.1:1", "--variant", "vroll"],
     "--variant vroll applies only to a local hasher"),
    (["--worker", "127.0.0.1:1", "--device", "cpu"],
     "--device cpu applies only to a local hasher"),
    (["--worker", "127.0.0.1:1", "--inner-bits", "10"],
     "--inner-bits 10 applies only to a local hasher"),
    (["--worker", "127.0.0.1:1@x"], r"want HOST:PORT\[@STATUSPORT\]"),
    (["--backend", "grpc"], "requires --grpc-target"),
    (["--backend", "grpc", "--grpc-target", "127.0.0.1:1", "--no-spec"],
     "--no-spec True applies only to a local hasher"),
    (["--grpc-target", "127.0.0.1:1", "--device", "cpu"],
     "--grpc-target 127.0.0.1:1 applies only to --backend grpc"),
])
def test_remote_backend_refusals(argv, message):
    with pytest.raises(SystemExit, match=message):
        cli.make_hasher(_args("--bench", *argv))


def test_worker_flags_build_a_supervised_grpc_fleet():
    fleet = cli.make_hasher(_args("--bench", "--worker", "127.0.0.1:1",
                                  "--worker", " 127.0.0.1:2 ", "--backend",
                                  "grpc"))
    try:
        assert fleet.name == "grpc-fleet"
        assert fleet.chip_labels == ["127.0.0.1:1", "127.0.0.1:2"]
        assert all(c.max_unavailable_s == 10.0 for c in fleet.children)
        assert fleet.negotiates_stream_depth
        assert fleet.stream_depth == 2 * (4 + 1) - 1
    finally:
        fleet.close()


# --------------------------------------------------------------- end to end
def test_stratum_session_on_a_grpc_fleet_survives_a_stopped_worker():
    """Two served workers (the port's hit-buffer hasher on the CPU) behind
    the supervisor; one is stopped after the first shares. Its requests
    are reclaimed by the survivor once it has been unreachable past the
    fleet's deadline, the session mines on, and the port's validating
    pool accepts every share: a duplicated nonce range would resubmit a
    share, which the pool rejects."""
    from bitcoin_miner_tpu_torch.miner.runner import StratumMiner
    from bitcoin_miner_tpu_torch.parallel.supervisor import make_grpc_fleet
    from bitcoin_miner_tpu_torch.rpc.hasher_service import serve
    from bitcoin_miner_tpu_torch.testing.mock_pool import (
        MockStratumPool,
        PoolJob,
    )

    servers = [serve(CudaHasher(batch_size=1 << 12, inner_size=1 << 10,
                                device="cpu"), telemetry=PipelineTelemetry())
               for _ in range(2)]
    tel = PipelineTelemetry()
    fleet = make_grpc_fleet([f"127.0.0.1:{port}" for _, port in servers],
                            max_unavailable_s=1.0, quarantine_base_s=30.0,
                            telemetry=tel)

    async def main():
        pool = MockStratumPool(difficulty=1 / (1 << 24))
        await pool.start()
        await pool.announce_job(PoolJob(
            job_id="f1", prevhash_internal=sha256d(b"fleet prev"),
            coinb1=bytes.fromhex("01000000") + b"\x11" * 30,
            coinb2=b"\x22" * 30 + bytes.fromhex("00000000"),
            merkle_branch=[sha256d(b"tx1")], version=0x20000000,
            nbits=0x1D00FFFF, ntime=0x655F2B2C))
        miner = StratumMiner("127.0.0.1", pool.port, "w", hasher=fleet,
                             n_workers=2, batch_size=1 << 12)
        stats = miner.dispatcher.stats
        task = asyncio.create_task(miner.run())

        async def until(done, seconds):
            deadline = asyncio.get_running_loop().time() + seconds
            while not done():
                assert asyncio.get_running_loop().time() < deadline, (
                    stats.summary(), fleet.snapshot())
                assert not task.done(), task
                await asyncio.sleep(0.05)

        try:
            await until(lambda: stats.shares_accepted >= 3, 60)
            servers[1][0].stop(grace=0)
            await until(lambda: fleet.reclaims > 0, 60)
            after = stats.shares_accepted
            await until(lambda: stats.shares_accepted >= after + 3, 60)
        finally:
            miner.stop()
            await asyncio.gather(task, return_exceptions=True)
            await pool.stop()
        assert pool.shares and all(s.accepted for s in pool.shares), [
            s.reason for s in pool.shares if not s.accepted]
        assert stats.hw_errors == 0 and stats.shares_rejected == 0
        assert fleet.states[1].state == QUARANTINED
        assert fleet.states[0].quarantines == 0
        assert HealthModel(tel).evaluate()["fleet"].state == "degraded"

    try:
        asyncio.run(asyncio.wait_for(main(), 180))
    finally:
        fleet.close()
        for server, _ in servers:
            server.stop(grace=0)


@pytest.mark.parametrize("argv", [
    ["--bench", "--backend", "grpc", "--grpc-target", "127.0.0.1:1"],
    ["--bench", "--worker", "127.0.0.1:1"],
    ["--serve-hasher", "127.0.0.1:0", "--device", "cpu"],
])
def test_grpc_paths_say_grpcio_is_missing(monkeypatch, argv):
    """Without grpcio the gRPC paths exit with the reason; nothing else
    of the command line looks for it."""
    real = cli.importlib.util.find_spec
    monkeypatch.setattr(cli.importlib.util, "find_spec",
                        lambda name, *a: None if name == "grpc"
                        else real(name, *a))
    args = _args(*argv)
    with pytest.raises(SystemExit, match="grpcio is not installed"):
        if args.serve_hasher:
            cli.cmd_serve_hasher(args)
        else:
            cli.make_hasher(args)
    assert cli.make_hasher(_args("--bench", "--device", "cpu"))


def test_serve_hasher_refuses_session_flags():
    with pytest.raises(SystemExit, match="--serve-hasher ignores"):
        cli.cmd_serve_hasher(_args("--serve-hasher", "127.0.0.1:0",
                                   "--device", "cpu", "--checkpoint", "x"))


def test_served_worker_process_answers_and_stops_on_sigterm(tmp_path):
    """``python -m bitcoin_miner_tpu_torch --serve-hasher`` as a process
    (the plain versions): a client's scan and stream through it, its
    ``/healthz``, and SIGTERM ending it with 0 after writing its trace."""
    import signal
    import socket
    import urllib.request

    from bitcoin_miner_tpu_torch.rpc.hasher_service import GrpcHasher

    def free_port():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    port, status = free_port(), free_port()
    trace = tmp_path / "worker.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "bitcoin_miner_tpu_torch", "--serve-hasher",
         f"127.0.0.1:{port}", "--device", "cpu", "--batch-bits", "12",
         "--status-port", str(status), "--health-interval", "1",
         "--trace-out", str(trace), "--flightrec-out",
         str(tmp_path / "fr.json")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    client = GrpcHasher(f"127.0.0.1:{port}", timeout=60.0)
    try:
        got = client.scan(HEADER, GENESIS_NONCE - 100, 200, DIFF1)
        assert got.nonces == [GENESIS_NONCE]
        out = list(client.scan_stream(iter(requests(3, count=512))))
        assert [r.request.tag for r in out] == [0, 1, 2]
        assert client.dispatch_size == 1 << 12
        with urllib.request.urlopen(
                f"http://127.0.0.1:{status}/healthz", timeout=10) as resp:
            assert resp.status == 200
    finally:
        client.close()
        proc.send_signal(signal.SIGTERM)
        output = proc.communicate(timeout=60)[0]
    assert proc.returncode == 0, output
    spans = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"serve_scan", "device_dispatch"} <= spans
