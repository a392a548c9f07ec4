"""Pipeline telemetry: metrics, spans, the flight recorder, share
lifecycles, share accounting and health.

Counterpart of ``bitcoin_miner_tpu/telemetry``, with the same metric
names, label sets, buckets, span names and dump schemas:

- :mod:`.metrics`: thread-safe labeled Counter/Gauge/Histogram families,
  rendered in Prometheus exposition format;
- :mod:`.tracing`: Chrome trace-event spans (``--trace-out``);
- :mod:`.flightrec`: the bounded structured-event ring (``/flightrec``,
  SIGUSR2, crashes);
- :mod:`.lifecycle`: per-share causal records and latency exemplars
  (``/lifecycle``);
- :mod:`.pipeline`: the metric vocabulary and the :class:`PipelineTelemetry`
  bundle every layer reports into;
- :mod:`.shareacct`: expected-vs-observed share accounting;
- :mod:`.health`: the rule engine behind ``/healthz``;
- :mod:`.tsdb`: the embedded time-series store, the scrape federator and
  the observatory's collector (``/query``);
- :mod:`.slo`: the SLO engine (``/slo``) and breach-triggered incident
  bundles;
- :mod:`.perfledger`: the append-only perf ledger and its gates;
- :mod:`.dashboard`: the ``top`` dashboard over ``/query``.
"""

from .flightrec import FlightRecorder, NullFlightRecorder  # noqa: F401
from .health import ComponentHealth, HealthModel, HealthWatchdog  # noqa: F401
from .lifecycle import (  # noqa: F401
    NullShareLifecycleLedger,
    ShareLifecycleLedger,
    share_key,
)
from .metrics import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
)
from .pipeline import (  # noqa: F401
    FLEET_CHILD_LEVELS,
    FRONTEND_SHARD_LEVELS,
    GAP_BUCKETS,
    METRIC_BATCH_NONCES,
    METRIC_CHIP_DISPATCHES,
    METRIC_CHIP_INFLIGHT,
    METRIC_CONSTS_CACHE,
    METRIC_DEVICE_BUSY,
    METRIC_DISPATCH_GAP,
    METRIC_FEDERATE_SCRAPES,
    METRIC_FLEET_CHILD_STATE,
    METRIC_FLEET_RECLAIMS,
    METRIC_FRONTEND_SHARD_STATE,
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
    POOL_SLOT_LEVELS,
    NullTelemetry,
    PipelineTelemetry,
    TelemetryBound,
    get_telemetry,
    set_telemetry,
    telemetry_disabled_by_env,
)
from .shareacct import ShareAccountant  # noqa: F401
from .slo import (  # noqa: F401
    DEFAULT_OBJECTIVES,
    IncidentCapture,
    SloConfigError,
    SloEngine,
    SloObjective,
    load_objectives,
    parse_objectives,
)
from .tracing import Tracer, merge_traces  # noqa: F401
from .tsdb import (  # noqa: F401
    Observatory,
    RecordingRule,
    RegistrySampler,
    ScrapeFederator,
    ScrapeTarget,
    TimeSeriesStore,
    parse_exposition,
    parse_query_payload,
)
