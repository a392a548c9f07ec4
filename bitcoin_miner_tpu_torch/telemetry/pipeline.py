"""The pipeline's metric vocabulary and the telemetry bundle.

Counterpart of ``bitcoin_miner_tpu/telemetry/pipeline.py``: the same
metric names, help strings, label sets and buckets, which dashboards and
the reference's surfaces read. Only the families that this package emits
(the dispatcher, the dispatch ring, the scheduler, the runners, the
fan-out and the mesh-native ring, the fleet supervisor, the health model,
the share accountant, the SLO engine, the incident capture, the
time-series store, the multi-pool fabric and the one-process pool
frontend) and those of the gRPC seam are registered; the sharded
frontend's ``frontend_shard_state`` comes with its module.

``PipelineTelemetry`` bundles a :class:`MetricRegistry`, a
:class:`Tracer`, a :class:`FlightRecorder` and a
:class:`ShareLifecycleLedger`, with the families as attributes, so a
call site reads ``tel.dispatch_gap.observe(dt)``. ``NullTelemetry`` is
the compiled-out form, the same attributes with every operation a no-op,
selected by ``TPU_MINER_TELEMETRY=0``: the control of the overhead
measurement. Metrics are on by default; tracing only with a trace path.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Tuple

from .flightrec import FlightRecorder, NullFlightRecorder
from .lifecycle import NullShareLifecycleLedger, ShareLifecycleLedger
from .metrics import DEFAULT_LATENCY_BUCKETS, MetricRegistry
from .tracing import Tracer

# ----------------------------------------------------------- metric names
#: Device idle time between dispatches (the busy clock's idle intervals):
#: ~0 while the ring stays full, a verify + submit leg when the pipeline
#: serializes.
METRIC_DISPATCH_GAP = "tpu_miner_dispatch_gap_seconds"
#: One device scan batch, enqueue (or entry) to result in hand.
METRIC_SCAN_BATCH = "tpu_miner_scan_batch_seconds"
#: The ring's blocking wait for its oldest dispatch (on the tile path it
#: includes the dispatch's ``rescan_steps`` launch and its wait).
METRIC_RING_COLLECT = "tpu_miner_ring_collect_seconds"
#: Share submit round trip (``mining.submit`` → pool ack), all verdicts.
METRIC_SUBMIT_RTT = "tpu_miner_submit_rtt_seconds"
#: Dispatches in flight in the dispatch rings.
METRIC_RING_OCCUPANCY = "tpu_miner_ring_occupancy"
#: Requests in flight on a ScanStream RPC (the gRPC seam's wire window).
METRIC_STREAM_WINDOW = "tpu_miner_stream_window_inflight"
#: Per-job constants LRU lookups, labeled result=hit|miss.
METRIC_CONSTS_CACHE = "tpu_miner_consts_cache_lookups"
#: Work dropped by a generation bump, labeled stage=item|result.
METRIC_STALE_DROPS = "tpu_miner_stale_drops"
#: The adaptive scheduler's current per-dispatch nonce count.
METRIC_BATCH_NONCES = "tpu_miner_adaptive_batch_nonces"
#: Scheduler shrinks, labeled reason=job_switch|stall.
METRIC_SCHED_RESIZES = "tpu_miner_sched_resizes"
#: Pool verdicts, labeled result=accepted|rejected|stale|lost|timeout|
#: error: the health model's pool-progress signal.
METRIC_POOL_ACKS = "tpu_miner_pool_acks"
#: Shares awaiting a pool verdict.
METRIC_SUBMITS_INFLIGHT = "tpu_miner_submits_inflight"
#: gRPC scan responses received (the gRPC seam's progress signal).
METRIC_RPC_RESPONSES = "tpu_miner_rpc_responses"
#: gRPC failures, labeled kind=retry|stream_broken|unimplemented|mask_sync.
METRIC_RPC_ERRORS = "tpu_miner_rpc_errors"
#: Completed dispatches per card of a fan-out (and per shard of the
#: mesh-native ring), labeled chip=...
METRIC_CHIP_DISPATCHES = "tpu_miner_chip_dispatches"
#: Requests assigned to a fan-out card and not yet collected, labeled
#: chip=... Nonzero with chip_dispatches still = that card's ring stalled.
METRIC_CHIP_INFLIGHT = "tpu_miner_chip_inflight"
#: Health verdict per component, labeled component=device|ring|rpc|pool|
#: shares|chip:<label>: 0 ok, 1 degraded, 2 stalled.
METRIC_HEALTH = "tpu_miner_health"
#: Difficulty-weighted accepted-share work / hashes swept (expectation 1).
METRIC_SHARE_EFFICIENCY = "tpu_miner_share_efficiency"
#: Shares the swept hashes should have produced at the current difficulty.
METRIC_SHARE_EXPECTED = "tpu_miner_share_expected"
#: Verified shares whose lifecycle record got no verdict within the loss
#: deadline (swept by the health watchdog).
METRIC_SHARE_LOST = "tpu_miner_share_lost"
#: Devices in the mesh-native hasher's active topology.
METRIC_MESH_DEVICES = "tpu_miner_mesh_devices"
#: Mesh-native topology transitions, labeled reason=quarantine|rebuild|
#: restore.
METRIC_MESH_REBUILDS = "tpu_miner_mesh_rebuilds"

#: Downstream Stratum sessions connected to the pool frontend
#: (``poolserver/``): the ``frontend`` health rule's traffic signal.
METRIC_FRONTEND_SESSIONS = "tpu_miner_frontend_sessions"
#: The frontend validator's share verdicts, labeled result=accepted|stale|
#: low_difficulty|duplicate|malformed|bad_extranonce2|version_bits: the
#: ``frontend`` rule's quality signal (an invalid-only window degrades it).
METRIC_FRONTEND_SHARES = "tpu_miner_frontend_shares"
#: One job broadcast to every downstream session (one encode, then a
#: transport write per session): the ``job-broadcast`` objective's signal.
METRIC_FRONTEND_JOB_BROADCAST = "tpu_miner_frontend_job_broadcast_seconds"
#: One ``mining.submit`` validation, native or hashlib, whichever is in
#: force: the ``frontend-validate`` objective's signal, and what a junk
#: submit costs the event loop.
METRIC_FRONTEND_VALIDATE = "tpu_miner_frontend_validate_seconds"
#: Broadcast payload encodes: once per job generation or retarget, never
#: per session.
METRIC_FRONTEND_BROADCAST_ENCODES = "tpu_miner_frontend_broadcast_encodes"

#: Per-upstream-pool slot state of the multi-pool fabric
#: (``miner/multipool.py``), labeled pool=<label>, valued by
#: :data:`POOL_SLOT_LEVELS` (connecting 0 … dead 4). The health model's
#: ``pools`` component reads the children: any slot degraded or dead
#: degrades it, all dead stalls it (no upstream left).
METRIC_POOL_SLOT_STATE = "tpu_miner_pool_slot_state"
#: Upstream failovers (the active pool lost liveness and the next dispatch
#: generation targeted another slot), labeled
#: reason=disconnect|stalled|breaker|dead.
METRIC_POOL_FAILOVER = "tpu_miner_pool_failover"

#: Per-child state of the fleet supervisor's health machine
#: (``parallel/supervisor.py``), labeled child=<label>, valued by
#: :data:`FLEET_CHILD_LEVELS` (active 0 … quarantined 3). The health
#: model's ``fleet`` component reads the children: any child off active
#: degrades it, all quarantined stalls it.
METRIC_FLEET_CHILD_STATE = "tpu_miner_fleet_child_state"
#: In-flight requests reclaimed from a failed or hung child and sent whole
#: to a survivor in the same generation, labeled
#: reason=error|hang|probe_failed.
METRIC_FLEET_RECLAIMS = "tpu_miner_fleet_reclaims"

#: Fast-window error-budget burn per SLO objective (``telemetry/slo.py``),
#: labeled objective=<name>: 1.0 burns exactly at the sustainable rate,
#: the engine's breach_burn (the slow window confirming) is the incident
#: trigger.
METRIC_SLO_BURN = "tpu_miner_slo_burn"
#: Per-pool-slot burn of slot-scoped objectives, labeled (objective,
#: pool); only a multi-pool fabric has slots.
METRIC_SLO_SLOT_BURN = "tpu_miner_slo_slot_burn"
#: Incident bundles captured, labeled objective=<breaching objective or
#: "manual">.
METRIC_INCIDENTS = "tpu_miner_incidents"
#: Labeled series held by the embedded time-series store
#: (``telemetry/tsdb.py``): local samples and what the federator ingests.
#: A plateau at the store's max_series bound means series are dropped.
METRIC_TSDB_SERIES = "tpu_miner_tsdb_series"
#: Federation scrapes of fleet members, labeled (target=<process label>,
#: result=ok|error): an error streak is a dead member, whose series go
#: stale.
METRIC_FEDERATE_SCRAPES = "tpu_miner_federate_scrapes"

#: A slot's state → the ``pool_slot_state`` gauge value: one definition
#: for the fabric, which sets the gauge, and the health model, which
#: classifies from it.
POOL_SLOT_LEVELS = {
    "connecting": 0.0,
    "syncing": 1.0,
    "active": 2.0,
    "degraded": 3.0,
    "dead": 4.0,
}

#: A child's state → the ``fleet_child_state`` gauge value: one definition
#: for the supervisor, which sets the gauge, and the health model, which
#: classifies from it.
FLEET_CHILD_LEVELS = {
    "active": 0.0,
    "degraded": 1.0,
    "probing": 2.0,
    "quarantined": 3.0,
}

#: Gaps run from ~10 µs (a full ring) to seconds (a slow pool): the
#: default latency ladder covers that span.
GAP_BUCKETS: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS

#: The bundle's metric attributes, in registration order.
BUNDLE_METRICS = (
    "dispatch_gap", "scan_batch", "ring_collect", "submit_rtt",
    "ring_occupancy", "stream_window", "consts_cache", "stale_drops",
    "batch_nonces", "sched_resizes", "pool_acks", "submits_inflight",
    "rpc_responses", "rpc_errors", "chip_dispatches", "chip_inflight",
    "mesh_devices", "mesh_rebuilds", "frontend_sessions", "frontend_shares",
    "frontend_job_broadcast", "frontend_validate",
    "frontend_broadcast_encodes", "pool_slot_state", "pool_failover",
    "fleet_child_state", "fleet_reclaims",
    "health", "share_efficiency", "share_expected", "share_lost",
    "slo_burn", "slo_slot_burn", "incidents", "tsdb_series",
    "federate_scrapes",
)


class _NullMetric:
    """No-op stand-in for every metric kind; ``labels`` returns itself so
    labeled call sites need no branches."""

    __slots__ = ()

    def labels(self, *a, **k) -> "_NullMetric":
        return self

    def inc(self, amount: float = 1.0) -> None:
        pass

    def dec(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    count = 0
    sum = 0.0
    mean = 0.0
    min = 0.0
    max = 0.0
    value = 0.0

    def quantile(self, q: float) -> float:
        return 0.0


_NULL_METRIC = _NullMetric()


class PipelineTelemetry:
    """Registry + tracer + flight recorder + lifecycle ledger, with the
    pipeline's families registered as attributes."""

    enabled = True

    def __init__(
        self,
        registry: Optional[MetricRegistry] = None,
        tracer: Optional[Tracer] = None,
        trace_path: Optional[str] = None,
    ) -> None:
        self.registry = registry if registry is not None else MetricRegistry()
        self.tracer = tracer if tracer is not None else Tracer(
            enabled=trace_path is not None
        )
        self.trace_path = trace_path
        if trace_path is not None:
            self.tracer.enabled = True
        r = self.registry
        self.dispatch_gap = r.histogram(
            METRIC_DISPATCH_GAP,
            "Device idle time between dispatches (s)",
            buckets=GAP_BUCKETS,
        )
        self.scan_batch = r.histogram(
            METRIC_SCAN_BATCH, "One device scan batch, wall seconds",
            buckets=GAP_BUCKETS,
        )
        self.ring_collect = r.histogram(
            METRIC_RING_COLLECT,
            "Blocking readback of the ring's oldest dispatch (s)",
            buckets=GAP_BUCKETS,
        )
        self.submit_rtt = r.histogram(
            METRIC_SUBMIT_RTT, "Share submit round-trip to the pool (s)",
            buckets=GAP_BUCKETS,
        )
        self.ring_occupancy = r.gauge(
            METRIC_RING_OCCUPANCY, "Dispatches in flight in the device ring"
        )
        self.stream_window = r.gauge(
            METRIC_STREAM_WINDOW, "Requests in flight on the ScanStream RPC"
        )
        self.consts_cache = r.counter(
            METRIC_CONSTS_CACHE,
            "Per-job device-constant cache lookups",
            labelnames=("result",),
        )
        self.stale_drops = r.counter(
            METRIC_STALE_DROPS,
            "Work discarded because a newer job superseded it",
            labelnames=("stage",),
        )
        self.batch_nonces = r.gauge(
            METRIC_BATCH_NONCES,
            "Per-dispatch nonce range chosen by the scan scheduler",
        )
        self.sched_resizes = r.counter(
            METRIC_SCHED_RESIZES,
            "Adaptive-scheduler shrink events",
            labelnames=("reason",),
        )
        self.pool_acks = r.counter(
            METRIC_POOL_ACKS,
            "Pool submit verdicts",
            labelnames=("result",),
        )
        self.submits_inflight = r.gauge(
            METRIC_SUBMITS_INFLIGHT,
            "Shares currently awaiting a pool response",
        )
        self.rpc_responses = r.counter(
            METRIC_RPC_RESPONSES,
            "gRPC scan responses received (unary + stream)",
        )
        self.rpc_errors = r.counter(
            METRIC_RPC_ERRORS,
            "gRPC failures (retries, broken streams, fallbacks)",
            labelnames=("kind",),
        )
        self.chip_dispatches = r.counter(
            METRIC_CHIP_DISPATCHES,
            "Completed dispatches per fan-out chip",
            labelnames=("chip",),
        )
        self.chip_inflight = r.gauge(
            METRIC_CHIP_INFLIGHT,
            "Requests assigned but not yet collected, per fan-out chip",
            labelnames=("chip",),
        )
        self.mesh_devices = r.gauge(
            METRIC_MESH_DEVICES,
            "Devices in the mesh-native hasher's active topology",
        )
        self.mesh_rebuilds = r.counter(
            METRIC_MESH_REBUILDS,
            "Mesh-native topology transitions (quarantine degradation, "
            "mesh rebuild, device restore)",
            labelnames=("reason",),
        )
        self.frontend_sessions = r.gauge(
            METRIC_FRONTEND_SESSIONS,
            "Downstream Stratum sessions connected to the pool frontend",
        )
        self.frontend_shares = r.counter(
            METRIC_FRONTEND_SHARES,
            "Downstream share verdicts from the frontend validator",
            labelnames=("result",),
        )
        self.frontend_job_broadcast = r.histogram(
            METRIC_FRONTEND_JOB_BROADCAST,
            "One job broadcast to every downstream session (s)",
            buckets=GAP_BUCKETS,
        )
        self.frontend_validate = r.histogram(
            METRIC_FRONTEND_VALIDATE,
            "One mining.submit validation, native or oracle (s)",
            buckets=GAP_BUCKETS,
        )
        self.frontend_broadcast_encodes = r.counter(
            METRIC_FRONTEND_BROADCAST_ENCODES,
            "Broadcast payload serializations (once per job generation "
            "or retarget, never per session)",
        )
        self.pool_slot_state = r.gauge(
            METRIC_POOL_SLOT_STATE,
            "Upstream pool slot FSM state (0 connecting … 4 dead)",
            labelnames=("pool",),
        )
        self.pool_failover = r.counter(
            METRIC_POOL_FAILOVER,
            "Upstream failovers (active pool replaced mid-run)",
            labelnames=("reason",),
        )
        self.fleet_child_state = r.gauge(
            METRIC_FLEET_CHILD_STATE,
            "Fleet-supervisor child FSM state "
            "(0 active, 1 degraded, 2 probing, 3 quarantined)",
            labelnames=("child",),
        )
        self.fleet_reclaims = r.counter(
            METRIC_FLEET_RECLAIMS,
            "In-flight requests reclaimed from a failed child and "
            "re-dispatched to a survivor",
            labelnames=("reason",),
        )
        self.health = r.gauge(
            METRIC_HEALTH,
            "Component health verdict (0 ok, 1 degraded, 2 stalled)",
            labelnames=("component",),
        )
        self.share_efficiency = r.gauge(
            METRIC_SHARE_EFFICIENCY,
            "Difficulty-weighted accepted-share work / hashes swept "
            "(expectation 1.0)",
        )
        self.share_expected = r.gauge(
            METRIC_SHARE_EXPECTED,
            "Shares the swept hashes should have produced at the "
            "current difficulty",
        )
        self.share_lost = r.counter(
            METRIC_SHARE_LOST,
            "Shares whose lifecycle record never reached a terminal "
            "verdict within the loss deadline",
        )
        self.slo_burn = r.gauge(
            METRIC_SLO_BURN,
            "Fast-window error-budget burn rate per SLO objective",
            labelnames=("objective",),
        )
        self.slo_slot_burn = r.gauge(
            METRIC_SLO_SLOT_BURN,
            "Per-pool-slot error-budget burn for slot-scoped SLO "
            "objectives",
            labelnames=("objective", "pool"),
        )
        self.incidents = r.counter(
            METRIC_INCIDENTS,
            "Incident bundles auto-captured on an SLO breach",
            labelnames=("objective",),
        )
        self.tsdb_series = r.gauge(
            METRIC_TSDB_SERIES,
            "Labeled series held by the embedded time-series store",
        )
        self.federate_scrapes = r.counter(
            METRIC_FEDERATE_SCRAPES,
            "Federation scrape attempts against fleet members",
            labelnames=("target", "result"),
        )
        #: the black box every layer's events land in: always recording,
        #: dumped on SIGUSR2, on a crash and at ``/flightrec``.
        self.flightrec = FlightRecorder()
        #: per-share causal records, served at ``/lifecycle`` and swept
        #: for lost shares by the health watchdog.
        self.lifecycle = ShareLifecycleLedger()

    def span(self, name: str, cat: str = "pipeline", **args):
        return self.tracer.span(name, cat=cat, **args)

    def enable_tracing(self, path: Optional[str] = None) -> None:
        self.tracer.enabled = True
        if path is not None:
            self.trace_path = path

    def dump_trace(self, path: Optional[str] = None) -> Optional[str]:
        """Write the trace to ``path`` (default: the configured
        ``trace_path``); returns the path written, or None if neither was
        set."""
        path = path or self.trace_path
        if path is None:
            return None
        self.tracer.dump(path)
        return path


class NullTelemetry(PipelineTelemetry):
    """Telemetry compiled out: the same attributes, no work per call."""

    enabled = False

    def __init__(self) -> None:  # deliberately no super().__init__
        self.registry = MetricRegistry()  # empty; renders to nothing
        self.tracer = Tracer(enabled=False)
        self.trace_path = None
        self.flightrec = NullFlightRecorder()
        self.lifecycle = NullShareLifecycleLedger()
        for attr in BUNDLE_METRICS:
            setattr(self, attr, _NULL_METRIC)

    def enable_tracing(self, path: Optional[str] = None) -> None:
        pass  # compiled out stays out; build a PipelineTelemetry instead

    def dump_trace(self, path: Optional[str] = None) -> Optional[str]:
        return None


class TelemetryBound:
    """Mixin: ``self.telemetry`` is the process default bundle at the
    moment it is read, unless a bundle was installed on the object. So a
    hasher built before ``cli.setup_telemetry`` swapped the default still
    reports into the new one."""

    _telemetry_override = None

    @property
    def telemetry(self) -> "PipelineTelemetry":
        return self._telemetry_override or get_telemetry()

    @telemetry.setter
    def telemetry(self, value) -> None:
        self._telemetry_override = value


_default_lock = threading.Lock()
_default: Optional[PipelineTelemetry] = None


def telemetry_disabled_by_env() -> bool:
    return os.environ.get("TPU_MINER_TELEMETRY", "1").lower() in (
        "0", "off", "false", "no",
    )


def get_telemetry() -> PipelineTelemetry:
    """The process default bundle, shared by the dispatcher, the rings and
    the status server, so one ``/metrics`` scrape sees every layer. Built
    on first use: ``NullTelemetry`` under ``TPU_MINER_TELEMETRY=0``."""
    global _default
    with _default_lock:
        if _default is None:
            _default = (
                NullTelemetry() if telemetry_disabled_by_env()
                else PipelineTelemetry()
            )
        return _default


def set_telemetry(
    telemetry: Optional[PipelineTelemetry],
) -> Optional[PipelineTelemetry]:
    """Install a default bundle (``--trace-out``, tests). None drops it:
    the next :func:`get_telemetry` builds one from the environment."""
    global _default
    with _default_lock:
        _default = telemetry
        return telemetry
