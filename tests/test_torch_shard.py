"""The package's sharded pool frontend (``poolserver/shard.py``) and its
load probe (``probes/load_probe.py``) on the CPU: the reference's own
battery (``tests/test_shard.py``) mirrored on the port — partition
arithmetic, configs (pickled for spawn), relabelling, the supervisor's
state machine over fake processes, ``metrics_text``'s dedupe, two real
acceptor processes on one ``SO_REUSEPORT`` port (kill, DEGRADED, respawn
at the same range, bounded teardown) and the probe's scale mode — and
the port held against the reference on the same seeded inputs:
``make_shard_configs`` and ``partition`` over a grid, ``_relabel_sample``
and ``_shard_of`` over a corpus, ``metrics_text`` over the same child
bodies served by local HTTP stubs, the ``frontend_shard`` rule over the
same gauges, and the reference's ``drive_external`` against the port's
two-shard frontend. A fresh interpreter that imports ``poolserver.shard``
loads no ``torch``: the spawned children stay light and free of CUDA."""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import os
import pickle
import random
import signal
import socket
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

import bitcoin_miner_tpu.miner.runner  # noqa: F401  (import order)
from bitcoin_miner_tpu.poolserver import shard as ref_shard
from bitcoin_miner_tpu.poolserver import space as ref_space
from bitcoin_miner_tpu.telemetry import health as ref_health
from bitcoin_miner_tpu.telemetry import pipeline as ref_pipeline
from bitcoin_miner_tpu_torch.poolserver import (
    PrefixAllocator,
    ShardSupervisor,
    SpaceExhausted,
)
from bitcoin_miner_tpu_torch.poolserver import shard as port_shard
from bitcoin_miner_tpu_torch.probes import load_probe
from bitcoin_miner_tpu_torch.telemetry import health as port_health
from bitcoin_miner_tpu_torch.telemetry import pipeline as port_pipeline
from bitcoin_miner_tpu_torch.telemetry.health import (
    DEGRADED,
    STALLED,
    HealthModel,
)
from bitcoin_miner_tpu_torch.telemetry.pipeline import (
    FRONTEND_SHARD_LEVELS,
    PipelineTelemetry,
)
from bitcoin_miner_tpu_torch.telemetry.tsdb import (
    parse_exposition,
    sample_key,
)
from tests.test_telemetry import parse_prometheus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "benchmarks"))

import load_probe as ref_probe  # noqa: E402

EASY = 1 / (1 << 24)
SEEDS = (0, 1, 2)


def make_configs(n=2, port=0, status_port=None, module=None, **kw):
    kw.setdefault("prefix_bytes", 2)
    kw.setdefault("extranonce2_size", 8)
    kw.setdefault("difficulty", EASY)
    kw.setdefault("job_interval_s", 30.0)
    make = (module or port_shard).make_shard_configs
    return make(n, "127.0.0.1", port, status_port=status_port, **kw)


def _no_relay():
    raise OSError("no relay")


@contextlib.contextmanager
def time_limit(seconds: float):
    """Fail the enclosed block with TimeoutError after ``seconds`` (the
    test's own limit: a wedged child must not hold the suite)."""
    def expire(signum, frame):
        raise TimeoutError(f"over the test's {seconds:g} s limit")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


# ------------------------------------------------------ partition math
class TestPartitionArithmetic:
    def test_union_is_exact_and_pairwise_disjoint(self):
        space = PrefixAllocator(2)
        for n in (1, 2, 3, 5, 7, 16):
            ranges = [space.partition(n, i).prefix_range for i in range(n)]
            assert ranges[0][0] == 0
            assert ranges[-1][1] == 256 ** 2
            for (_, hi), (lo, _) in zip(ranges, ranges[1:]):
                assert hi == lo
            assert all(lo < hi for lo, hi in ranges)

    def test_respawn_recomputes_identical_range(self):
        for i in range(5):
            assert (PrefixAllocator(2).partition(5, i).prefix_range
                    == PrefixAllocator(2).partition(5, i).prefix_range)

    def test_exhaustion_is_local_to_the_partition(self):
        part = PrefixAllocator(1).partition(2, 0)
        got = [part.allocate() for _ in range(part.capacity)]
        assert got == list(range(*part.prefix_range))
        with pytest.raises(SpaceExhausted):
            part.allocate()
        other = PrefixAllocator(1).partition(2, 1)
        assert other.allocate() == other.prefix_range[0]

    def test_reclaim_lowest_first_within_partition(self):
        part = PrefixAllocator(1).partition(4, 2)
        lo, _hi = part.prefix_range
        a, b, c = part.allocate(), part.allocate(), part.allocate()
        part.release(b)
        part.release(a)
        assert part.allocate() == a
        assert part.allocate() == b
        assert (a, c) == (lo, lo + 2)

    def test_more_shards_than_prefixes_raises(self):
        with pytest.raises(ValueError, match="empty"):
            PrefixAllocator(1).partition(300, 0)

    def test_probe_attribution_matches_partition(self):
        for n in (2, 3, 8):
            for i in range(n):
                part = PrefixAllocator(2).partition(n, i)
                lo, hi = part.prefix_range
                for prefix in (lo, hi - 1):
                    e1 = b"\xaa\xbb" + part.encode(prefix)
                    assert load_probe._shard_of(e1, 2, n) == i

    def test_shard_of_degenerate_inputs(self):
        assert load_probe._shard_of(b"\x00\x01", 2, 1) is None
        assert load_probe._shard_of(b"\x00", 2, 4) is None

    @pytest.mark.parametrize("prefix_bytes", [1, 2, 3])
    @pytest.mark.parametrize("n", [1, 2, 3, 7, 16, 255])
    def test_partition_matches_reference(self, prefix_bytes, n):
        """Every slice of the grid has the reference's range, capacity
        and first prefixes, a sub-range as parent included; where the
        reference refuses a slice (empty), the port refuses it too."""
        for start, stop in ((0, None), (5, 256 ** prefix_bytes - 3)):
            port = PrefixAllocator(prefix_bytes, start=start, stop=stop)
            ref = ref_space.PrefixAllocator(prefix_bytes, start=start,
                                            stop=stop)
            for i in range(n):
                try:
                    r = ref.partition(n, i)
                except ValueError as e:
                    with pytest.raises(ValueError) as got:
                        port.partition(n, i)
                    assert str(got.value) == str(e)
                    continue
                p = port.partition(n, i)
                assert (p.prefix_range, p.capacity, p.space) == (
                    r.prefix_range, r.capacity, r.space)
                assert [p.allocate() for _ in range(min(3, p.capacity))] \
                    == [r.allocate() for _ in range(min(3, r.capacity))]


# ------------------------------------------------------- config carving
class TestMakeShardConfigs:
    def test_child_status_ports_carved_from_parent(self):
        cfgs = make_configs(3, port=3333, status_port=9100)
        assert [c.status_port for c in cfgs] == [9101, 9102, 9103]
        assert [c.index for c in cfgs] == [0, 1, 2]
        assert all(c.n_shards == 3 and c.port == 3333 for c in cfgs)

    def test_no_parent_status_port_means_no_child_ports(self):
        assert [c.status_port for c in make_configs(2)] == [None, None]

    def test_bad_n_shards_fails_at_the_cli_seam(self):
        with pytest.raises(ValueError, match="n_shards"):
            make_configs(0)
        with pytest.raises(ValueError, match="empty"):
            make_configs(300, prefix_bytes=1)

    def test_configs_pickle_for_spawn(self):
        cfgs = make_configs(2, status_port=9100)
        assert pickle.loads(pickle.dumps(cfgs[1])) == cfgs[1]

    @pytest.mark.parametrize("n,status_port,extra", [
        (1, None, {}),
        (2, 9100, {}),
        (5, 18000, {"upstream_host": "pool.example", "upstream_port": 3999,
                    "upstream_tls": True, "username": "u",
                    "vardiff_target_spm": 12.0, "vardiff_interval_s": 7.0,
                    "slo_objectives_path": "/x.json",
                    "native_validation": False}),
        (16, 20000, {"prefix_bytes": 1, "health_interval_s": 0.5}),
    ])
    def test_configs_match_reference(self, n, status_port, extra):
        port = make_configs(n, port=3333, status_port=status_port, **extra)
        ref = make_configs(n, port=3333, status_port=status_port,
                           module=ref_shard, **extra)
        assert [dataclasses.asdict(c) for c in port] == \
            [dataclasses.asdict(c) for c in ref]

    @pytest.mark.parametrize("n,prefix_bytes", [(0, 2), (-1, 2), (257, 1)])
    def test_refuses_what_the_reference_refuses(self, n, prefix_bytes):
        for module in (port_shard, ref_shard):
            with pytest.raises(ValueError):
                make_configs(n, prefix_bytes=prefix_bytes, module=module)


# --------------------------------------------------------- relabeling
def _corpus(seed: int) -> list:
    """Exposition lines: labelled and unlabelled samples, comments,
    blanks, garbage, values with exponents."""
    rng = random.Random(seed)
    names = ["tpu_miner_frontend_sessions", "tpu_miner_pool_acks_total",
             "tpu_miner_frontend_shares_total", "tpu_miner_x_bucket"]
    out = []
    for _ in range(60):
        kind = rng.randrange(6)
        name = rng.choice(names)
        value = rng.choice(["0", "3", "1.5e-05", "+Inf", "42"])
        if kind == 0:
            out.append(f"{name} {value}")
        elif kind in (1, 2):
            labels = ",".join(f'{k}="{rng.choice(["a", "b", "0.25"])}"'
                              for k in rng.sample(["result", "le", "x"],
                                                  rng.randrange(1, 3)))
            out.append(f"{name}{{{labels}}} {value}")
        elif kind == 3:
            out.append(f"# HELP {name} help")
        elif kind == 4:
            out.append("")
        else:
            out.append(rng.choice(["garbage", "a b c", "x{"]))
    return out


class TestRelabelSample:
    def test_labeled_sample_grows_shard_label(self):
        assert port_shard._relabel_sample(
            'tpu_miner_pool_acks_total{result="accepted"} 5', 2
        ) == 'tpu_miner_pool_acks_total{result="accepted",shard="2"} 5'

    def test_unlabeled_sample_gains_label_set(self):
        assert port_shard._relabel_sample(
            "tpu_miner_frontend_sessions 3", 0) == \
            'tpu_miner_frontend_sessions{shard="0"} 3'

    def test_unsplittable_line_passes_through(self):
        assert port_shard._relabel_sample("garbage", 1) == "garbage"

    @pytest.mark.parametrize("seed", SEEDS)
    def test_relabel_matches_reference(self, seed):
        for i, line in enumerate(_corpus(seed)):
            assert port_shard._relabel_sample(line, i % 5) == \
                ref_shard._relabel_sample(line, i % 5)

    @pytest.mark.parametrize("seed", SEEDS)
    def test_shard_of_matches_reference(self, seed):
        rng = np.random.default_rng(seed)
        for _ in range(300):
            prefix_bytes = int(rng.integers(1, 4))
            shards = int(rng.integers(0, 9))
            e1 = bytes(rng.integers(0, 256, int(rng.integers(0, 7)),
                                    dtype=np.uint8))
            assert load_probe._shard_of(e1, prefix_bytes, shards) == \
                ref_probe._shard_of(e1, prefix_bytes, shards)


# ---------------------------------------------------- supervisor (FSM)
class FakeProc:
    """The process surface the parent reads: alive until killed."""

    def __init__(self, pid: int):
        self.alive = True
        self.pid = pid
        self.terminated = False

    def start(self):
        pass

    def is_alive(self):
        return self.alive

    def terminate(self):
        self.terminated = True
        self.alive = False

    def kill(self):
        self.alive = False

    def join(self, timeout=None):
        pass


class FakeCtx:
    """The spawn context's stand-in: records what it spawned, with pids
    from its own counter (two supervisors get the same pids)."""

    def __init__(self, first_pid: int = 41000):
        self.spawned = []
        self._pids = iter(range(first_pid, first_pid + 1000))

    def Process(self, target=None, args=(), name="", daemon=None):
        assert daemon is True  # a child must not outlive its parent
        proc = FakeProc(next(self._pids))
        self.spawned.append((args[0], proc))
        return proc


def make_supervisor(n=2, respawn=True, status_port=None, module=None,
                    pipeline=port_pipeline):
    module = module or port_shard
    tel = pipeline.PipelineTelemetry()
    sup = module.ShardSupervisor(
        make_configs(n, port=3333, status_port=status_port, module=module),
        telemetry=tel, liveness_interval_s=3600.0, respawn=respawn,
    )
    sup._ctx = FakeCtx()
    return tel, sup


def states(sup):
    return {i: s.state for i, s in sorted(sup._shards.items())}


class TestSupervisorFsm:
    def test_start_then_tick_reaches_serving(self):
        tel, sup = make_supervisor()
        try:
            sup.start()
            assert states(sup) == {0: "starting", 1: "starting"}
            sup.tick()
            assert states(sup) == {0: "serving", 1: "serving"}
            assert HealthModel(tel).evaluate(now=0.0)[
                "frontend_shard"].state == "ok"
        finally:
            sup.shutdown(timeout_s=2.0)

    def test_death_is_detected_before_respawn(self):
        tel, sup = make_supervisor()
        try:
            sup.start()
            sup.tick()
            dead = sup._shards[0].process
            dead.alive = False
            sup.tick()
            assert states(sup)[0] == "down"
            assert sup._shards[0].process is dead
            report = HealthModel(tel).evaluate(now=0.0)
            assert report["frontend_shard"].state == DEGRADED
            assert "0" in report["frontend_shard"].reason
            sup.tick()
            shard = sup._shards[0]
            assert shard.process is not dead
            assert shard.restarts == 1 and shard.state == "starting"
            assert sup._ctx.spawned[-1][0] == sup.configs[0]
            sup.tick()
            assert states(sup) == {0: "serving", 1: "serving"}
        finally:
            sup.shutdown(timeout_s=2.0)

    def test_respawn_disabled_stays_down(self):
        _tel, sup = make_supervisor(respawn=False)
        try:
            sup.start()
            sup.tick()
            sup._shards[1].process.alive = False
            for _ in range(3):
                sup.tick()
            assert states(sup)[1] == "down"
            assert sup._shards[1].restarts == 0
        finally:
            sup.shutdown(timeout_s=2.0)

    def test_all_shards_down_is_a_stall(self):
        tel, sup = make_supervisor(respawn=False)
        try:
            sup.start()
            sup.tick()
            for s in sup._shards.values():
                s.process.alive = False
            sup.tick()
            report = HealthModel(tel).evaluate(now=0.0)
            assert report["frontend_shard"].state == STALLED
            assert "all 2" in report["frontend_shard"].reason
        finally:
            sup.shutdown(timeout_s=2.0)

    def test_shutdown_terminates_and_marks_down(self):
        _tel, sup = make_supervisor()
        sup.start()
        sup.tick()
        procs = [s.process for s in sup._shards.values()]
        sup.shutdown(timeout_s=2.0)
        assert all(p.terminated for p in procs)
        assert states(sup) == {0: "down", 1: "down"}
        sup.tick()  # inert after the shutdown: no respawn
        assert states(sup) == {0: "down", 1: "down"}

    def test_snapshot_reports_disjoint_ranges_and_pids(self):
        _tel, sup = make_supervisor()
        try:
            sup.start()
            snap = sup.snapshot()
            assert snap["n_shards"] == 2 and snap["port"] == 3333
            r0, r1 = (s["prefix_range"] for s in snap["shards"])
            assert r0 == [0, 32768] and r1 == [32768, 65536]
            assert all(isinstance(s["pid"], int) for s in snap["shards"])
        finally:
            sup.shutdown(timeout_s=2.0)

    def test_metrics_text_empty_without_child_ports(self):
        _tel, sup = make_supervisor()
        try:
            sup.start()
            assert sup.metrics_text() == ""
            assert sup.scrape_targets() == []
        finally:
            sup.shutdown(timeout_s=2.0)

    def test_empty_config_list_rejected(self):
        with pytest.raises(ValueError):
            ShardSupervisor([], telemetry=PipelineTelemetry())

    def test_run_and_stop_drive_start_and_shutdown(self):
        tel, sup = make_supervisor()

        async def main():
            task = asyncio.create_task(sup.run())
            while not sup._shards:
                await asyncio.sleep(0.01)
            sup.stop()
            await asyncio.wait_for(task, 10)

        asyncio.run(main())
        assert states(sup) == {0: "down", 1: "down"}
        assert sup.stats.hashes == 0 and sup.shard_supervisor is sup

    def test_fsm_matches_reference(self):
        """The same script of deaths and ticks gives the same states,
        restarts, gauge lines, snapshots and ``frontend_shard`` verdicts
        as the reference's supervisor."""
        trails = []
        for module, pipeline, health, kw in (
                (ref_shard, ref_pipeline, ref_health,
                 {"relay_probe": _no_relay}),
                (port_shard, port_pipeline, port_health, {})):
            tel, sup = make_supervisor(3, module=module, pipeline=pipeline)
            model = health.HealthModel(tel, **kw)
            trail = []

            def note():
                fs = model.evaluate(now=float(len(trail))).get(
                    "frontend_shard")
                trail.append((states(sup), sup.snapshot(),
                              tel.frontend_shard_state.render(),
                              fs and (fs.state, fs.reason)))

            try:
                sup.start()
                note()
                for step in ("tick", 0, "tick", "tick", "tick", (1, 2),
                             "tick", "tick", 0, "tick"):
                    if step == "tick":
                        sup.tick()
                    else:
                        for i in (step if isinstance(step, tuple)
                                  else (step,)):
                            sup._shards[i].process.alive = False
                    note()
            finally:
                sup.shutdown(timeout_s=2.0)
            note()
            trails.append(trail)
        assert trails[1] == trails[0]
        assert {t[3][0] for t in trails[1] if t[3]} == {
            "ok", "degraded", "stalled"}


class TestChildTemplateSource:
    def test_a_respawned_child_mines_other_headers(self):
        """A respawned child hands out its range's first extranonce1 and
        its first job id again. Its ``ntime`` counts from its own start,
        so a miner that reconnects to it does not mine the dead child's
        headers again (a divergence: the reference's children all start
        from one fixed ``ntime``)."""
        assert PrefixAllocator(2).partition(2, 1).allocate() == \
            PrefixAllocator(2).partition(2, 1).allocate()
        t0 = int(time.time())
        job = port_shard.child_template_source().next_job()
        from bitcoin_miner_tpu.poolserver.jobs import LocalTemplateSource

        fixed = LocalTemplateSource().next_job()
        assert job.job_id == fixed.job_id == "t1"
        assert t0 + 1 <= job.ntime <= int(time.time()) + 1
        assert job.ntime != fixed.ntime


class _StubChild:
    """A local HTTP server answering ``/metrics`` with a fixed body (a
    child's exposition) and ``/healthz`` with 200."""

    def __init__(self, body: str):
        outer = self
        self.body = body

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                data = outer.body.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.server = HTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.server.server_port
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def _child_body(seed: int, index: int) -> str:
    """A seeded child exposition: HELP/TYPE comments, labelled and
    unlabelled samples, repeats within the body, and an unlabelled
    ``frontend_shard_state`` that relabels onto the parent's own
    series."""
    rng = random.Random(100 * seed + index)
    lines = ["# HELP tpu_miner_frontend_sessions sessions",
             "# TYPE tpu_miner_frontend_sessions gauge",
             f"tpu_miner_frontend_sessions {rng.randrange(9)}",
             "tpu_miner_frontend_shard_state 2"]
    for _ in range(20):
        result = rng.choice(["accepted", "stale", "duplicate"])
        lines.append(f'tpu_miner_frontend_shares_total{{result="{result}"}}'
                     f" {rng.randrange(100)}")
    lines.append(lines[2])
    return "\n".join(lines) + "\n"


class TestMetricsText:
    def test_metrics_text_dedupes_reemitted_families(self):
        """A child that re-emits a family the parent renders (the
        unlabelled form relabels onto the supervisor's own
        ``frontend_shard_state{shard="0"}``), or repeats a sample within
        its scrape, surfaces once in the aggregated exposition, through
        the validating parser."""
        child = _StubChild("tpu_miner_frontend_shard_state 2\n"
                           "tpu_miner_frontend_sessions 3\n"
                           "tpu_miner_frontend_sessions 3\n")
        tel = PipelineTelemetry()
        sup = ShardSupervisor(
            make_configs(1, port=3333, status_port=child.port - 1),
            telemetry=tel, liveness_interval_s=3600.0)
        sup._ctx = FakeCtx()
        try:
            sup.start()
            aggregated = tel.registry.render() + sup.metrics_text()
            seen = set()
            for line in aggregated.splitlines():
                key = sample_key(line)
                assert key is None or key not in seen, line
                if key is not None:
                    seen.add(key)
            families = parse_prometheus(aggregated)
            assert [s for s in
                    families["tpu_miner_frontend_sessions"]["samples"]
                    if s[1].get("shard") == "0"] == [
                ("tpu_miner_frontend_sessions", {"shard": "0"}, 3.0)]
            assert [s for s in
                    families["tpu_miner_frontend_shard_state"]["samples"]
                    if s[1].get("shard") == "0"] == [
                ("tpu_miner_frontend_shard_state", {"shard": "0"},
                 FRONTEND_SHARD_LEVELS["starting"])]
            assert sup.scrape_targets() == [(0, child.port)]
        finally:
            sup.shutdown(timeout_s=2.0)
            child.close()

    @pytest.mark.parametrize("seed", SEEDS)
    def test_metrics_text_matches_reference(self, seed):
        """Three children's bodies served by local stubs give the same
        aggregated text through the reference's supervisor and the
        port's."""
        children = [_StubChild(_child_body(seed, i)) for i in range(3)]
        texts = []
        try:
            for module, pipeline in ((ref_shard, ref_pipeline),
                                     (port_shard, port_pipeline)):
                configs = [dataclasses.replace(c, status_port=child.port)
                           for c, child in zip(make_configs(
                               3, port=3333, module=module), children)]
                tel = pipeline.PipelineTelemetry()
                sup = module.ShardSupervisor(configs, telemetry=tel,
                                             liveness_interval_s=3600.0)
                sup._ctx = FakeCtx()
                try:
                    sup.start()
                    sup.tick()  # each stub answers /healthz: serving
                    texts.append((sup.metrics_text(), sup.scrape_targets(),
                                  states(sup)))
                finally:
                    sup.shutdown(timeout_s=2.0)
        finally:
            for child in children:
                child.close()
        assert texts[1] == texts[0]
        assert texts[1][2] == {0: "serving", 1: "serving", 2: "serving"}
        assert 'shard="2"' in texts[1][0]


# --------------------------------------------------- the health rule
def _shards_snapshot(shards):
    return {"batches": 0, "active_scans": 0, "gap_count": 0, "gap_sum": 0.0,
            "ring_occupancy": 0.0, "ring_collects": 0, "stream_window": 0.0,
            "rpc_responses": 0.0, "rpc_errors": 0.0,
            "submits_inflight": 0.0, "pool_acks": {}, "chips": {},
            "share_expected": 0.0, "share_efficiency": 0.0,
            "frontend_shards": shards}


@pytest.mark.parametrize("shards,state", [
    ({}, None),
    ({"0": 1.0, "1": 1.0}, "ok"),
    ({"0": 0.0, "1": 1.0}, "ok"),
    ({"0": 2.0, "1": 1.0}, "degraded"),
    ({"0": 3.0, "1": 1.0, "2": 2.0}, "degraded"),
    ({"0": 3.0}, "stalled"),
    ({"0": 3.0, "1": 3.0}, "stalled"),
], ids=["unsharded", "all-serving", "starting-serving", "one-degraded",
        "down-and-degraded", "one-down", "all-down"])
def test_frontend_shard_rule_matches_reference(shards, state):
    """The ``frontend_shard`` rule reads the same verdict and reason, and
    ``/healthz`` the same status and body, from the same gauges as the
    reference's; no shards is no component."""
    out = []
    for pipeline, health, kw in (
            (ref_pipeline, ref_health, {"relay_probe": _no_relay}),
            (port_pipeline, port_health, {})):
        model = health.HealthModel(pipeline.PipelineTelemetry(), **kw)
        report = model.evaluate(_shards_snapshot(shards), now=1.0)
        fs = report.get("frontend_shard")
        out.append(None if fs is None else (fs.state, fs.reason))
        model.publish(report)
        out.append(model.healthz(report))
    assert out[2:] == out[:2]
    assert (out[2] and out[2][0]) == state
    assert out[3][0] == (503 if state == "stalled" else 200)


def test_shard_module_loads_no_torch():
    """A spawned child imports ``poolserver.shard`` in a fresh
    interpreter: nothing on that path may load torch (or CUDA)."""
    code = ("import sys; import bitcoin_miner_tpu_torch.poolserver.shard; "
            "from bitcoin_miner_tpu_torch.probes import load_probe; "
            "print(sorted(m for m in ('torch', 'jax', 'bitcoin_miner_tpu') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ------------------------------------------------------------- live e2e
def free_port_block(n: int) -> int:
    """The first of ``n`` consecutive free ports (a parent status port and
    its children's)."""
    for _ in range(50):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            base = sock.getsockname()[1]
        if base + n > 65535:
            continue
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no block of {n} free ports")


def _tick_until(sup, predicate, deadline_s=60.0, interval_s=0.25):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        sup.tick()
        if predicate():
            return
        time.sleep(interval_s)
    raise AssertionError(f"supervisor never got there: {states(sup)}")


def _live_pair(port: int, status_port: int):
    tel = PipelineTelemetry()
    sup = ShardSupervisor(
        make_configs(2, port=port, status_port=status_port,
                     job_interval_s=30.0, health_interval_s=0.2),
        telemetry=tel, liveness_interval_s=3600.0)
    return tel, sup


def _serving(sup):
    return lambda: set(states(sup).values()) == {"serving"}


class TestShardE2E:
    def test_two_shards_share_port_survive_kill_and_respawn(self):
        """Two acceptor processes on one SO_REUSEPORT port, disjoint
        ranges, no extranonce1 twice under a real fleet; a SIGKILLed
        acceptor is DEGRADED while the survivor serves, then respawned at
        its identical range; the teardown is bounded and leaves no
        child."""
        port, status_port = free_port_block(1), free_port_block(3)
        tel, sup = _live_pair(port, status_port)
        with time_limit(150):
            try:
                sup.start()
                _tick_until(sup, _serving(sup))
                t0 = time.time()
                payload = asyncio.run(asyncio.wait_for(
                    load_probe.drive_external(
                        "127.0.0.1", port, clients=10, shares_per_client=2,
                        shards=2, prefix_bytes=2), 60))
                start, end = payload["submit_window"]
                assert t0 <= start <= end <= time.time()
                assert payload["unique_extranonce1"] == 10
                assert payload["accepted"] == 20 and payload["invalid"] == 0
                assert "unattributed" not in payload["sessions_per_shard"]
                assert sum(payload["sessions_per_shard"].values()) == 10
                metrics = sup.metrics_text()
                assert "# aggregated from shard /metrics" in metrics
                shares = {labels["shard"]: value for name, labels, value, _
                          in parse_exposition(metrics)
                          if name == "tpu_miner_frontend_shares_total"
                          and labels.get("result") == "accepted"}
                assert {k: int(v) for k, v in shares.items()} == {
                    k: 2 * n for k, n in
                    payload["sessions_per_shard"].items()}

                victim = sup.snapshot()["shards"][0]
                os.kill(victim["pid"], signal.SIGKILL)
                sup._shards[0].process.join(timeout=10.0)
                sup.tick()
                assert states(sup)[0] == "down"
                report = HealthModel(tel).evaluate(now=0.0)
                assert report["frontend_shard"].state == DEGRADED
                # The survivor keeps serving alone meanwhile.
                payload = asyncio.run(asyncio.wait_for(
                    load_probe.drive_external(
                        "127.0.0.1", port, clients=4, shares_per_client=1,
                        shards=2, prefix_bytes=2), 60))
                assert payload["sessions_per_shard"] == {"1": 4}
                assert payload["invalid"] == 0

                sup.tick()
                shard = sup.snapshot()["shards"][0]
                assert shard["restarts"] == 1
                assert shard["prefix_range"] == victim["prefix_range"]
                assert shard["pid"] != victim["pid"]
                _tick_until(sup, _serving(sup))
                payload = asyncio.run(asyncio.wait_for(
                    load_probe.drive_external(
                        "127.0.0.1", port, clients=6, shares_per_client=1,
                        shards=2, prefix_bytes=2), 60))
                assert payload["unique_extranonce1"] == 6
                assert payload["invalid"] == 0
            finally:
                t0 = time.monotonic()
                sup.shutdown(timeout_s=10.0)
                assert time.monotonic() - t0 < 30.0
        assert all(not s.process.is_alive() for s in sup._shards.values())

    def test_reference_probe_against_the_port_frontend(self):
        """The reference's ``drive_external`` mines real shares with its
        own hashlib against the port's two shards: every share accepted,
        every extranonce1 unique and every session attributed to the
        partition that issued it."""
        port, status_port = free_port_block(1), free_port_block(3)
        _tel, sup = _live_pair(port, status_port)
        with time_limit(120):
            try:
                sup.start()
                _tick_until(sup, _serving(sup))
                payload = asyncio.run(asyncio.wait_for(
                    ref_probe.drive_external(
                        "127.0.0.1", port, clients=12, shares_per_client=2,
                        shards=2, prefix_bytes=2), 60))
            finally:
                sup.shutdown(timeout_s=10.0)
        assert payload["unique_extranonce1"] == 12
        assert payload["accepted"] == 24 and payload["invalid"] == 0
        assert "unattributed" not in payload["sessions_per_shard"]
        assert sum(payload["sessions_per_shard"].values()) == 12


# ------------------------------------------------- load_probe sweep mode
class TestLoadProbeScaleMode:
    def test_parse_scales(self):
        assert load_probe._parse_scales("100,1000") == [100, 1000]
        assert load_probe._parse_scales(" 5 , 7 ") == [5, 7]
        for bad in ("a,b", "0", "", "10,-1"):
            with pytest.raises(SystemExit):
                load_probe._parse_scales(bad)

    @pytest.mark.parametrize("text", ["100,1000", " 5 , 7 ", "a,b", "0",
                                      "", "10,-1", "3,,4"])
    def test_parse_scales_matches_reference(self, text):
        out = []
        for module in (ref_probe, load_probe):
            try:
                out.append(module._parse_scales(text))
            except SystemExit as e:
                out.append(("exit", str(e)))
        assert out[1] == out[0]

    def test_sweep_emits_one_row_per_scale(self, tmp_path, capsys):
        from bitcoin_miner_tpu_torch.telemetry.perfledger import PerfLedger

        ledger = tmp_path / "ledger.jsonl"
        rc = load_probe.main([
            "--scales", "4,6", "--jobs", "1", "--shares", "1",
            "--assert-no-invalid", "--assert-unique-e1",
            "--ledger", str(ledger), "--ledger-id", "probe",
        ])
        assert rc == 0
        lines = [json.loads(line) for line in
                 capsys.readouterr().out.strip().splitlines()]
        assert [p["sessions"] for p in lines] == [4, 6]
        assert all(p["metric"] == "frontend_load" for p in lines)
        assert all(p["invalid"] == 0 for p in lines)
        rows = PerfLedger(str(ledger)).load()
        assert [r.raw["id"] for r in rows] == ["probe-0", "probe-1"]
        assert [r.raw["sessions"] for r in rows] == [4, 6]
        assert len({r.key() for r in rows}) == 2

    def test_single_run_keeps_plain_ledger_id(self, tmp_path, capsys):
        from bitcoin_miner_tpu_torch.telemetry.perfledger import PerfLedger

        ledger = tmp_path / "ledger.jsonl"
        rc = load_probe.main([
            "--clients", "3", "--jobs", "1", "--shares", "1",
            "--ledger", str(ledger), "--ledger-id", "solo",
        ])
        assert rc == 0
        capsys.readouterr()
        rows = PerfLedger(str(ledger)).load()
        assert [r.raw["id"] for r in rows] == ["solo"]

    def test_p99_assert_names_the_scale(self, capsys):
        rc = load_probe.main([
            "--scales", "3", "--jobs", "1", "--shares", "1",
            "--assert-p99-ms", "0.000001",
        ])
        assert rc == 1
        assert "3 sessions" in capsys.readouterr().err

    def test_invalid_every_counts_rejects(self, capsys):
        rc = load_probe.main([
            "--clients", "4", "--jobs", "2", "--shares", "2",
            "--invalid-every", "2", "--assert-no-invalid",
        ])
        assert rc == 1
        payload = json.loads(capsys.readouterr().out)
        assert (payload["accepted"], payload["invalid"]) == (8, 8)

    def test_scales_clamp_to_fd_budget_loudly(self, monkeypatch, capsys):
        monkeypatch.setattr(load_probe, "_raise_fd_limit", lambda n: 4)
        rc = load_probe.main([
            "--scales", "3,50,50000", "--jobs", "1", "--shares", "1",
        ])
        assert rc == 0
        out, err = capsys.readouterr()
        lines = [json.loads(line) for line in out.strip().splitlines()]
        assert [p["sessions"] for p in lines] == [3, 4]
        assert err.count("clamping") == 2
        assert "RLIMIT_NOFILE" in err

    def test_run_probe_payload_keys_match_reference(self):
        """The in-process measurement's line has the reference's keys and
        the same verdict counts at the same size."""
        payloads = [asyncio.run(asyncio.wait_for(module.run_probe(
            clients=5, jobs=2, shares_per_client=2, invalid_every=2), 60))
            for module in (ref_probe, load_probe)]
        assert set(payloads[1]) == set(payloads[0])
        for key in ("metric", "unit", "backend", "bench", "sessions", "jobs",
                    "accepted", "invalid", "prefixes_in_use"):
            assert payloads[1][key] == payloads[0][key], key
