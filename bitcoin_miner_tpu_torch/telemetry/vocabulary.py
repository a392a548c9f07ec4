"""The declared metric vocabulary: every metric name this package may
construct, with its kind and where it is emitted.

Counterpart of ``bitcoin_miner_tpu/telemetry/vocabulary.py``, with the
same tables. Three consumers keep each other honest:

- the ``metric-vocabulary`` lint rule (``analysis/rules.py``): a
  ``Counter``/``Gauge``/``Histogram`` family constructed outside this
  package's ``telemetry/`` must use a name declared here (or a
  ``METRIC_*`` constant imported from telemetry), so probes and benches
  can never invent a series that ``/metrics``, ARCHITECTURE.md and the
  health rules don't know about;
- the ``metric-doc-drift`` project rule (``analysis/docdrift.py``):
  every metric named in ARCHITECTURE.md's observability tables must
  exist here, and every registry family here must be documented there;
- ``tests/test_torch_analysis.py`` pins this table against the families
  a real :class:`~.pipeline.PipelineTelemetry` registers, and against
  the reference's tables.

The names are imported from ``pipeline.py``: this module declares no new
strings for the pre-registered families, it only attaches the kind
metadata the checkers need. It imports neither torch nor jax, so the
lint that reads it never loads either.
"""

from __future__ import annotations

from typing import Dict, FrozenSet

from .pipeline import (
    METRIC_BATCH_NONCES,
    METRIC_CHIP_DISPATCHES,
    METRIC_CHIP_INFLIGHT,
    METRIC_CONSTS_CACHE,
    METRIC_DEVICE_BUSY,
    METRIC_DISPATCH_GAP,
    METRIC_FLEET_CHILD_STATE,
    METRIC_FLEET_RECLAIMS,
    METRIC_FRONTEND_BROADCAST_ENCODES,
    METRIC_FRONTEND_JOB_BROADCAST,
    METRIC_FEDERATE_SCRAPES,
    METRIC_FRONTEND_SESSIONS,
    METRIC_FRONTEND_SHARD_STATE,
    METRIC_FRONTEND_SHARES,
    METRIC_FRONTEND_VALIDATE,
    METRIC_HEALTH,
    METRIC_INCIDENTS,
    METRIC_MESH_DEVICES,
    METRIC_MESH_REBUILDS,
    METRIC_POOL_ACKS,
    METRIC_POOL_FAILOVER,
    METRIC_POOL_SLOT_STATE,
    METRIC_RING_COLLECT,
    METRIC_RING_OCCUPANCY,
    METRIC_RPC_ERRORS,
    METRIC_RPC_RESPONSES,
    METRIC_SCAN_BATCH,
    METRIC_SCHED_RESIZES,
    METRIC_SHARE_EFFICIENCY,
    METRIC_SHARE_EXPECTED,
    METRIC_SHARE_LOST,
    METRIC_SLO_BURN,
    METRIC_SLO_SLOT_BURN,
    METRIC_STALE_DROPS,
    METRIC_STREAM_WINDOW,
    METRIC_SUBMIT_RTT,
    METRIC_SUBMITS_INFLIGHT,
    METRIC_TSDB_SERIES,
)

#: Canonical registry-family name → kind. Counters are stored UNsuffixed
#: (the ``_total`` belongs to the exposition format — MetricRegistry
#: strips it on registration and re-adds it on render).
REGISTRY_FAMILIES: Dict[str, str] = {
    METRIC_DISPATCH_GAP: "histogram",
    METRIC_SCAN_BATCH: "histogram",
    METRIC_RING_COLLECT: "histogram",
    METRIC_SUBMIT_RTT: "histogram",
    METRIC_RING_OCCUPANCY: "gauge",
    METRIC_STREAM_WINDOW: "gauge",
    METRIC_CONSTS_CACHE: "counter",
    METRIC_STALE_DROPS: "counter",
    METRIC_BATCH_NONCES: "gauge",
    METRIC_SCHED_RESIZES: "counter",
    METRIC_POOL_ACKS: "counter",
    METRIC_SUBMITS_INFLIGHT: "gauge",
    METRIC_RPC_RESPONSES: "counter",
    METRIC_RPC_ERRORS: "counter",
    METRIC_CHIP_DISPATCHES: "counter",
    METRIC_CHIP_INFLIGHT: "gauge",
    METRIC_MESH_DEVICES: "gauge",
    METRIC_MESH_REBUILDS: "counter",
    METRIC_HEALTH: "gauge",
    METRIC_SHARE_EFFICIENCY: "gauge",
    METRIC_SHARE_EXPECTED: "gauge",
    METRIC_FRONTEND_SESSIONS: "gauge",
    METRIC_FRONTEND_SHARES: "counter",
    METRIC_FRONTEND_JOB_BROADCAST: "histogram",
    METRIC_FRONTEND_VALIDATE: "histogram",
    METRIC_FRONTEND_BROADCAST_ENCODES: "counter",
    METRIC_FRONTEND_SHARD_STATE: "gauge",
    METRIC_POOL_SLOT_STATE: "gauge",
    METRIC_POOL_FAILOVER: "counter",
    METRIC_FLEET_CHILD_STATE: "gauge",
    METRIC_FLEET_RECLAIMS: "counter",
    METRIC_SHARE_LOST: "counter",
    METRIC_SLO_BURN: "gauge",
    METRIC_SLO_SLOT_BURN: "gauge",
    METRIC_INCIDENTS: "counter",
    METRIC_TSDB_SERIES: "gauge",
    METRIC_FEDERATE_SCRAPES: "counter",
    #: probe/bench only — deliberately not pre-registered in
    #: PipelineTelemetry (a live miner has no bounded wall window), but
    #: still part of the ONE vocabulary so the probe cannot drift.
    METRIC_DEVICE_BUSY: "gauge",
}

#: ``MinerStats`` snapshot keys ``utils/status.py`` renders as
#: ``tpu_miner_<stat>_total`` counters — documented in ARCHITECTURE.md
#: via that one placeholder row, expanded by the doc-drift checker.
STATUS_SNAPSHOT_COUNTERS: FrozenSet[str] = frozenset({
    "hashes", "batches", "shares_found", "shares_accepted",
    "shares_rejected", "shares_stale", "blocks_found", "hw_errors",
    "reconnects",
})

#: ``MinerStats`` snapshot gauges (``tpu_miner_<stat>``) — derived
#: values the JSON status endpoint also serves; not registry families.
STATUS_SNAPSHOT_GAUGES: FrozenSet[str] = frozenset({
    "hashrate_mhs", "device_hashrate_mhs", "uptime_s",
})


def store_derived_series() -> FrozenSet[str]:
    """Series names the observatory's recording rules WRITE into the
    embedded store — never registry families, but part of
    the one vocabulary so ARCHITECTURE.md's recording-rule table and
    `/query` consumers can't name a rule the code doesn't evaluate.
    Imported lazily: tsdb.py is import-light but this module must stay
    the bottom of the telemetry import graph."""
    from .tsdb import DEFAULT_RECORDING_RULES

    return frozenset(rule.record for rule in DEFAULT_RECORDING_RULES)


def rendered_name(name: str, kind: str) -> str:
    """The exposition-format sample name for a canonical family name."""
    if kind == "counter" and not name.endswith("_total"):
        return name + "_total"
    return name


def all_metric_names() -> FrozenSet[str]:
    """Every name a metric construction site may legally use: canonical
    registry names, their rendered (``_total``) forms, and the status
    snapshot families."""
    names = set()
    for name, kind in REGISTRY_FAMILIES.items():
        names.add(name)
        names.add(rendered_name(name, kind))
    for stat in STATUS_SNAPSHOT_COUNTERS:
        names.add(f"tpu_miner_{stat}")
        names.add(f"tpu_miner_{stat}_total")
    for stat in STATUS_SNAPSHOT_GAUGES:
        names.add(f"tpu_miner_{stat}")
    names.update(store_derived_series())
    return frozenset(names)


def documented_names() -> FrozenSet[str]:
    """The rendered names ARCHITECTURE.md's observability tables must
    each contain — the vocabulary→docs direction of the drift check."""
    return frozenset(
        rendered_name(name, kind)
        for name, kind in REGISTRY_FAMILIES.items()
    )
