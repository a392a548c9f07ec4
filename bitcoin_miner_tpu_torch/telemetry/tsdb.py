"""Embedded time-series store, scrape federation and the collector.

Counterpart of ``bitcoin_miner_tpu/telemetry/tsdb.py``, the same code on
the host (no tensor is involved): rate *history* as an object of its own,
bounded and dependency-free:

- :class:`TimeSeriesStore`: fixed-interval ring buffers per labeled
  series with counter→rate conversion (reset-aware), staleness markers,
  a downsampled coarse retention tier, and declarative
  :class:`RecordingRule` evaluation on each ingest cycle;
- :func:`parse_exposition`: a small validating reader of the Prometheus
  text format :class:`~.metrics.MetricRegistry` renders (the federation
  wire format);
- :class:`ScrapeFederator`: polls every discoverable fleet member (the
  ``--worker HOST:PORT@STATUSPORT`` status ports, ``--federate``
  endpoints, anything a registered discovery source yields) and ingests
  its samples relabeled with ``process`` (plus per-target labels such as
  ``worker``). A dead target bumps
  ``tpu_miner_federate_scrapes_total{target,result="error"}`` and its
  series go stale; it never raises into the collector thread;
- :class:`RegistrySampler`: the local collector over the registry
  (counters under their rendered ``_total`` names, histograms as
  ``_count``/``_sum`` counters, so local and federated series share one
  naming scheme);
- :class:`Observatory`: the daemon collector thread gluing them together
  (the ``HealthWatchdog`` loop), exporting ``tpu_miner_tsdb_series`` and
  the reporter's ``tsdb N series`` fragment. With a multi-pool fabric
  (``miner/multipool.py``) it samples each slot's window accept rate as
  ``fabric.slot_accept_rate{pool}``;
- the ``tpu-miner-query/1`` schema: :meth:`TimeSeriesStore.query`
  renders it (the ``/query`` body), :func:`parse_query_payload`
  validates it (``top`` and the tests load it).

Timebases: collectors stamp points with the store's wall clock; the SLO
engine ingests its ``slo.*`` namespace with its own (monotonic) clock.
Points within ONE series are always monotone; timestamps of two
namespaces are not comparable, which is why staleness is judged from the
wall-clock *receive* time of the last ingest, never from point
timestamps.
"""

from __future__ import annotations

import logging
import re
import threading
import time
import urllib.request
from collections import deque
from dataclasses import dataclass
from typing import (
    Any,
    Callable,
    Deque,
    Dict,
    Iterable,
    List,
    Mapping,
    Optional,
    Tuple,
)

logger = logging.getLogger(__name__)

QUERY_SCHEMA = "tpu-miner-query/1"

#: canonical (sorted) label-items form — the dict-order-free series key.
LabelItems = Tuple[Tuple[str, str], ...]


def _labelset(labels: Optional[Mapping[str, str]]) -> LabelItems:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


# ------------------------------------------------------ recording rules
@dataclass(frozen=True)
class RecordingRule:
    """One derived series, declaratively: for every source series
    matching ``source`` (any label set), write ``record`` with the SAME
    labels holding the reset-aware rate over the trailing window."""

    record: str
    source: str
    window_s: float = 30.0


#: rules every Observatory installs by default: the fleet-wide
#: shares/s views the dashboard and the observatory probe read.
DEFAULT_RECORDING_RULES: Tuple[RecordingRule, ...] = (
    RecordingRule(record="tpu_miner_frontend_shares_per_s",
                  source="tpu_miner_frontend_shares_total"),
    RecordingRule(record="tpu_miner_pool_acks_per_s",
                  source="tpu_miner_pool_acks_total"),
)


class _Series:
    """One labeled series: the fine ring + the coarse downsample tier.

    ``points`` holds (t, value) at fixed-interval granularity (ingests
    closer than half the store interval overwrite the last point's
    value instead of appending). The coarse tier accumulates each
    ``coarse_interval_s`` bucket and flushes its representative value
    (mean for gauges, last for counters — a counter's mean is
    meaningless) when the bucket boundary is crossed."""

    __slots__ = (
        "name", "labels", "kind", "points", "coarse", "last_wall",
        "_bucket", "_bucket_sum", "_bucket_n", "_bucket_last",
    )

    def __init__(
        self, name: str, labels: LabelItems, kind: str,
        coarse_capacity: int,
    ) -> None:
        self.name = name
        self.labels = labels
        self.kind = kind
        self.points: Deque[Tuple[float, float]] = deque()
        self.coarse: Deque[Tuple[float, float]] = deque(
            maxlen=coarse_capacity
        )
        #: wall-clock receive time of the last ingest — the staleness
        #: basis (point timestamps may ride a different timebase).
        self.last_wall = 0.0
        self._bucket: Optional[int] = None
        self._bucket_sum = 0.0
        self._bucket_n = 0
        self._bucket_last = 0.0


class TimeSeriesStore:
    """Bounded embedded TSDB over labeled series.

    All mutation and reads take one re-entrant lock — collectors are
    threads, the SLO engine ticks under the health watchdog, and
    ``/query`` reads from the status server's executor."""

    def __init__(
        self,
        *,
        interval_s: float = 1.0,
        retention_s: float = 900.0,
        coarse_interval_s: float = 60.0,
        coarse_retention_s: float = 14400.0,
        stale_after_s: float = 15.0,
        max_series: int = 4096,
        clock: Callable[[], float] = time.time,
    ) -> None:
        if interval_s <= 0 or retention_s <= interval_s:
            raise ValueError(
                "need 0 < interval_s < retention_s "
                f"(got {interval_s}/{retention_s})"
            )
        if coarse_interval_s <= 0:
            raise ValueError("coarse_interval_s must be > 0")
        self.interval_s = interval_s
        self.retention_s = retention_s
        self.coarse_interval_s = coarse_interval_s
        self.coarse_capacity = max(
            2, int(coarse_retention_s / coarse_interval_s)
        )
        self.stale_after_s = stale_after_s
        self.max_series = max_series
        self.clock = clock
        self._lock = threading.RLock()
        self._series: Dict[Tuple[str, LabelItems], _Series] = {}
        self._rules: List[RecordingRule] = []
        #: series refused because max_series was hit — surfaced in the
        #: query payload so truncation is never silent.
        self.dropped_series = 0

    # --------------------------------------------------------- ingest
    def ingest(
        self,
        name: str,
        value: float,
        *,
        t: float,
        labels: Optional[Mapping[str, str]] = None,
        kind: str = "gauge",
    ) -> bool:
        """Record one point. Returns False (and counts the drop) when
        the series would exceed ``max_series``; points closer than half
        the store interval to the last one update it in place (fixed-
        interval ring semantics)."""
        if kind not in ("gauge", "counter"):
            raise ValueError(f"unknown series kind {kind!r}")
        key = (name, _labelset(labels))
        v = float(value)
        if v != v:  # NaN: Prometheus's own staleness marker — skip
            return False
        t = float(t)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                if len(self._series) >= self.max_series:
                    if self.dropped_series == 0:
                        logger.warning(
                            "tsdb at max_series=%d; dropping new series "
                            "(first: %s%r)", self.max_series, name, key[1],
                        )
                    self.dropped_series += 1
                    return False
                series = _Series(
                    name, key[1], kind, self.coarse_capacity
                )
                self._series[key] = series
            series.last_wall = time.time()
            pts = series.points
            if pts and t - pts[-1][0] < self.interval_s * 0.5:
                # Same interval slot (or time went backwards): keep the
                # slot's timestamp, take the freshest value.
                pts[-1] = (pts[-1][0], v)
            else:
                pts.append((t, v))
                while pts and pts[-1][0] - pts[0][0] > self.retention_s:
                    pts.popleft()
            self._downsample(series, t, v)
            return True

    def _downsample(self, series: _Series, t: float, v: float) -> None:
        bucket = int(t // self.coarse_interval_s)
        if series._bucket is not None and bucket > series._bucket:
            if series.kind == "counter":
                rep = series._bucket_last
            else:
                rep = (
                    series._bucket_sum / series._bucket_n
                    if series._bucket_n else series._bucket_last
                )
            series.coarse.append(
                ((series._bucket + 1) * self.coarse_interval_s, rep)
            )
            series._bucket_sum = 0.0
            series._bucket_n = 0
        if series._bucket is None or bucket > series._bucket:
            series._bucket = bucket
        series._bucket_sum += v
        series._bucket_n += 1
        series._bucket_last = v

    # ---------------------------------------------------------- reads
    def series_count(self) -> int:
        with self._lock:
            return len(self._series)

    def _get(
        self, name: str, labels: Optional[Mapping[str, str]]
    ) -> Optional[_Series]:
        return self._series.get((name, _labelset(labels)))

    def _match(
        self,
        name: Optional[str] = None,
        prefix: Optional[str] = None,
        labels: Optional[Mapping[str, str]] = None,
    ) -> List[_Series]:
        want = _labelset(labels)
        out = []
        for (sname, slabels), series in sorted(self._series.items()):
            if name is not None and sname != name:
                continue
            if prefix is not None and not sname.startswith(prefix):
                continue
            if want and not set(want) <= set(slabels):
                continue
            out.append(series)
        return out

    def latest(
        self, name: str, labels: Optional[Mapping[str, str]] = None
    ) -> Optional[Tuple[float, float]]:
        with self._lock:
            series = self._get(name, labels)
            if series is None or not series.points:
                return None
            return series.points[-1]

    def value_at(
        self, name: str,
        labels: Optional[Mapping[str, str]], t: float,
    ) -> Optional[float]:
        """The series value as of time ``t`` (latest point at or before
        it); None when the series has no point that old."""
        with self._lock:
            series = self._get(name, labels)
            if series is None:
                return None
            for pt, pv in reversed(series.points):
                if pt <= t:
                    return pv
            return None

    def oldest_point_time(
        self, name: str, labels: Optional[Mapping[str, str]],
        start_t: float, end_t: float,
    ) -> Optional[float]:
        """The oldest point time in ``[start_t, end_t)`` — the window-
        reference lookup the SLO engine's delta machinery runs on."""
        with self._lock:
            series = self._get(name, labels)
            if series is None:
                return None
            for pt, _ in series.points:
                if pt >= end_t:
                    return None
                if pt >= start_t:
                    return pt
            return None

    def windowed_increase(
        self, name: str, labels: Optional[Mapping[str, str]],
        start_t: float, end_t: float,
    ) -> Tuple[Optional[float], int]:
        """Reset-aware counter increase over ``(start_t, end_t]`` plus
        the number of window points. A drop between consecutive points
        is a counter reset (process restart): the post-reset value IS
        the increase since the reset. A series that only appeared
        mid-window counts from zero (the federation semantics: a new
        fleet member's counters are new work)."""
        with self._lock:
            series = self._get(name, labels)
            if series is None:
                return None, 0
            base: Optional[float] = None
            for pt, pv in reversed(series.points):
                if pt <= start_t:
                    base = pv
                    break
            window = [
                pv for pt, pv in series.points if start_t < pt <= end_t
            ]
        if base is None and not window:
            return None, 0
        prev = base if base is not None else 0.0
        inc = 0.0
        for v in window:
            inc += (v - prev) if v >= prev else v
            prev = v
        return inc, len(window)

    def rate(
        self, name: str, labels: Optional[Mapping[str, str]],
        window_s: float, now: float,
    ) -> Optional[float]:
        """Windowed counter rate (per second); None without evidence."""
        if window_s <= 0:
            return None
        inc, _n = self.windowed_increase(
            name, labels, now - window_s, now
        )
        if inc is None:
            return None
        return inc / window_s

    def is_stale(
        self, name: str, labels: Optional[Mapping[str, str]] = None
    ) -> bool:
        with self._lock:
            series = self._get(name, labels)
            if series is None:
                return True
            return time.time() - series.last_wall > self.stale_after_s

    # ---------------------------------------------------------- rules
    def add_rule(self, rule: RecordingRule) -> None:
        with self._lock:
            if rule not in self._rules:
                self._rules.append(rule)

    def evaluate_rules(self, now: float) -> int:
        """Evaluate every recording rule against the current window;
        called at the end of each ingest cycle (Observatory.collect)."""
        written = 0
        with self._lock:
            rules = list(self._rules)
            for rule in rules:
                for series in self._match(name=rule.source):
                    value = self.rate(
                        rule.source, dict(series.labels),
                        rule.window_s, now,
                    )
                    if value is None:
                        continue
                    if self.ingest(
                        rule.record, value, t=now,
                        labels=dict(series.labels), kind="gauge",
                    ):
                        written += 1
        return written

    # ---------------------------------------------------------- query
    def query(
        self,
        *,
        name: Optional[str] = None,
        prefix: Optional[str] = None,
        labels: Optional[Mapping[str, str]] = None,
        window_s: Optional[float] = None,
        tier: str = "fine",
        now: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Range query rendered as a ``tpu-miner-query/1`` document
        (the ``/query`` endpoint body)."""
        if tier not in ("fine", "coarse"):
            raise ValueError(f"unknown tier {tier!r}")
        now = self.clock() if now is None else float(now)
        wall = time.time()
        out: List[Dict[str, Any]] = []
        with self._lock:
            for series in self._match(
                name=name, prefix=prefix, labels=labels
            ):
                pts = (
                    series.points if tier == "fine" else series.coarse
                )
                if window_s is not None:
                    cutoff = now - window_s
                    points = [
                        [round(t, 6), v] for t, v in pts if t >= cutoff
                    ]
                else:
                    points = [[round(t, 6), v] for t, v in pts]
                if not points:
                    continue
                out.append({
                    "name": series.name,
                    "labels": dict(series.labels),
                    "kind": series.kind,
                    "stale": (
                        wall - series.last_wall > self.stale_after_s
                    ),
                    "points": points,
                })
            dropped = self.dropped_series
        return {
            "schema": QUERY_SCHEMA,
            "now": round(now, 6),
            "interval_s": self.interval_s,
            "tier": tier,
            "window_s": window_s,
            "dropped_series": dropped,
            "series": out,
        }


# ------------------------------------------------- query schema loader
class QueryError(ValueError):
    """A ``tpu-miner-query/1`` document failed validation — the message
    names the offending series/field (the parse_objectives pattern)."""


def parse_query_payload(
    payload: Any, source: str = "<query>"
) -> Dict[str, Any]:
    """Validate a decoded ``/query`` response. Returns the payload;
    raises :class:`QueryError` naming the first violation."""
    def fail(msg: str) -> QueryError:
        return QueryError(f"{source}: {msg}")

    if not isinstance(payload, dict):
        raise fail("top level must be a JSON object")
    if payload.get("schema") != QUERY_SCHEMA:
        raise fail(
            f"unsupported schema {payload.get('schema')!r} "
            f"(want {QUERY_SCHEMA})"
        )
    for field_name in ("now", "interval_s"):
        v = payload.get(field_name)
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            raise fail(f"{field_name!r} must be a number (got {v!r})")
    if payload.get("tier") not in ("fine", "coarse"):
        raise fail(f"'tier' must be fine|coarse (got {payload.get('tier')!r})")
    series = payload.get("series")
    if not isinstance(series, list):
        raise fail("'series' must be an array")
    for i, entry in enumerate(series):
        where = f"series[{i}]"
        if not isinstance(entry, dict):
            raise fail(f"{where} must be an object")
        name = entry.get("name")
        if not isinstance(name, str) or not name:
            raise fail(f"{where}: 'name' must be a non-empty string")
        where = f"series[{i}] ({name})"
        labels = entry.get("labels")
        if not isinstance(labels, dict) or not all(
            isinstance(k, str) and isinstance(v, str)
            for k, v in labels.items()
        ):
            raise fail(f"{where}: 'labels' must map strings to strings")
        if entry.get("kind") not in ("gauge", "counter"):
            raise fail(f"{where}: 'kind' must be gauge|counter")
        if not isinstance(entry.get("stale"), bool):
            raise fail(f"{where}: 'stale' must be a boolean")
        points = entry.get("points")
        if not isinstance(points, list) or not points:
            raise fail(f"{where}: 'points' must be a non-empty array")
        prev_t: Optional[float] = None
        for j, point in enumerate(points):
            if (
                not isinstance(point, (list, tuple))
                or len(point) != 2
                or not all(
                    isinstance(x, (int, float))
                    and not isinstance(x, bool) for x in point
                )
            ):
                raise fail(
                    f"{where}: points[{j}] must be a [t, value] pair"
                )
            if prev_t is not None and point[0] < prev_t:
                raise fail(
                    f"{where}: points[{j}] timestamp goes backwards"
                )
            prev_t = float(point[0])
    return payload


# ------------------------------------------------- exposition parsing
_TYPE_RE = re.compile(
    r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) "
    r"(counter|gauge|histogram|summary|untyped)\s*$"
)
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$"
)
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"'
)
_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def sample_key(line: str) -> Optional[Tuple[str, LabelItems]]:
    """The (name, sorted labels) identity of one exposition sample
    line; None for comments/blanks/garbage. This is the dedupe key a
    federated ``/metrics`` must never repeat (a shard supervisor drops
    any child sample that would re-emit a series the parent already
    owns)."""
    m = _SAMPLE_RE.match(line.strip())
    if m is None:
        return None
    blob = m.group(2)
    labels: LabelItems = (
        tuple(sorted(_LABEL_PAIR_RE.findall(blob))) if blob else ()
    )
    return m.group(1), labels


def _unescape(value: str) -> str:
    return (
        value.replace(r"\"", '"').replace(r"\n", "\n")
        .replace("\\\\", "\\")
    )


def parse_exposition(
    text: str,
) -> List[Tuple[str, Dict[str, str], float, str]]:
    """Prometheus-text samples as (name, labels, value, store kind).

    The federation ingestion policy lives here: counters keep their
    rendered ``_total`` names, histogram ``_sum``/``_count`` samples
    become counters, histogram ``_bucket`` samples are skipped (per-
    bucket series would multiply federation cardinality for data the
    store's rate machinery never reads), NaN values are skipped, and
    unparseable lines are ignored (the wire is another process)."""
    kinds: Dict[str, str] = {}
    out: List[Tuple[str, Dict[str, str], float, str]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            m = _TYPE_RE.match(line)
            if m:
                kinds[m.group(1)] = m.group(2)
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name, blob, raw = m.group(1), m.group(2), m.group(3)
        try:
            value = float(raw)
        except ValueError:
            continue
        if value != value:  # NaN staleness marker
            continue
        kind = kinds.get(name)
        if kind is None:
            for suffix in _HIST_SUFFIXES:
                if name.endswith(suffix) and kinds.get(
                    name[: -len(suffix)]
                ) == "histogram":
                    kind = "histogram"
                    break
        if kind == "histogram":
            if name.endswith("_bucket"):
                continue
            store_kind = "counter"
        elif kind == "counter":
            store_kind = "counter"
        else:
            store_kind = "gauge"
        labels = (
            {
                k: _unescape(v)
                for k, v in _LABEL_PAIR_RE.findall(blob)
            }
            if blob else {}
        )
        out.append((name, labels, value, store_kind))
    return out


# ----------------------------------------------------------- collectors
@dataclass(frozen=True)
class ScrapeTarget:
    """One federated ``/metrics`` endpoint: the ``process`` label its
    samples are relabeled with, plus any extra labels (``shard``/
    ``worker``) the discovery source attaches."""

    process: str
    url: str
    labels: LabelItems = ()

    @staticmethod
    def make(
        process: str, url: str,
        labels: Optional[Mapping[str, str]] = None,
    ) -> "ScrapeTarget":
        return ScrapeTarget(process, url, _labelset(labels))


class ScrapeFederator:
    """Polls every discoverable fleet member and ingests its samples.

    Targets come from static registration and from *sources* —
    callables returning the current target list (shard supervisors and
    fleet supervisors re-discover per scrape, so a respawned child or
    a reconfigured worker set needs no re-wiring). Scrape failures are
    counted (``result="error"``) and skipped — the member's series go
    stale in the store; nothing propagates to the collector thread."""

    def __init__(
        self,
        store: TimeSeriesStore,
        telemetry: Optional[Any] = None,
        *,
        timeout_s: float = 1.0,
    ) -> None:
        self.store = store
        self._telemetry = telemetry
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._static: List[ScrapeTarget] = []
        self._sources: List[Callable[[], Iterable[ScrapeTarget]]] = []

    @property
    def telemetry(self) -> Any:
        if self._telemetry is not None:
            return self._telemetry
        from .pipeline import get_telemetry

        return get_telemetry()

    def add_target(self, target: ScrapeTarget) -> None:
        with self._lock:
            self._static.append(target)

    def add_source(
        self, source: Callable[[], Iterable[ScrapeTarget]]
    ) -> None:
        with self._lock:
            self._sources.append(source)

    def targets(self) -> List[ScrapeTarget]:
        with self._lock:
            static = list(self._static)
            sources = list(self._sources)
        out = list(static)
        for source in sources:
            try:
                out.extend(source())
            except Exception:  # noqa: BLE001 — discovery must not
                # break the scrape of the members it DID find
                logger.exception("federation discovery source failed")
        return out

    def scrape(self, now: Optional[float] = None) -> int:
        """One federation pass; returns samples ingested."""
        now = self.store.clock() if now is None else now
        tel = self.telemetry
        ingested = 0
        for target in self.targets():
            try:
                with urllib.request.urlopen(
                    target.url, timeout=self.timeout_s
                ) as resp:
                    text = resp.read().decode("utf-8", "replace")
            except Exception:  # noqa: BLE001 — a dead fleet member's
                # series must go stale, never raise into the collector
                tel.federate_scrapes.labels(
                    target=target.process, result="error"
                ).inc()
                continue
            for name, labels, value, kind in parse_exposition(text):
                merged = dict(labels)
                merged.update(dict(target.labels))
                merged["process"] = target.process
                if self.store.ingest(
                    name, value, t=now, labels=merged, kind=kind
                ):
                    ingested += 1
            tel.federate_scrapes.labels(
                target=target.process, result="ok"
            ).inc()
        return ingested


class RegistrySampler:
    """The local collector: one pass over the in-process registry.

    Counters land under their rendered ``_total`` names and histograms
    as ``_count``/``_sum`` counter pairs — exactly what
    :func:`parse_exposition` produces for a federated member, so local
    and remote series share one naming scheme (only the ``process``
    label differs)."""

    def __init__(
        self,
        store: TimeSeriesStore,
        registry: Any,
        *,
        process: str = "parent",
    ) -> None:
        self.store = store
        self.registry = registry
        self.process = process

    def sample(self, now: Optional[float] = None) -> int:
        now = self.store.clock() if now is None else now
        ingested = 0
        for fam in self.registry.families():
            for key, child in fam.children():
                labels = dict(zip(fam.labelnames, key))
                labels["process"] = self.process
                if fam.kind == "counter":
                    todo = ((fam.name + "_total", child.value, "counter"),)
                elif fam.kind == "gauge":
                    todo = ((fam.name, child.value, "gauge"),)
                else:
                    todo = (
                        (fam.name + "_count", float(child.count),
                         "counter"),
                        (fam.name + "_sum", child.sum, "counter"),
                    )
                for name, value, kind in todo:
                    if self.store.ingest(
                        name, value, t=now, labels=labels, kind=kind
                    ):
                        ingested += 1
        return ingested


class Observatory:
    """The collection plane's loop: local sample + federation scrape
    + fabric-slot snapshot + recording rules, on a daemon thread (the
    HealthWatchdog loop idiom — collect immediately, then every
    ``interval_s``; a failing stage is logged, never raised)."""

    def __init__(
        self,
        store: TimeSeriesStore,
        telemetry: Optional[Any] = None,
        *,
        federator: Optional[ScrapeFederator] = None,
        fabric: Optional[Any] = None,
        interval_s: float = 5.0,
        process: str = "parent",
        rules: Tuple[RecordingRule, ...] = DEFAULT_RECORDING_RULES,
    ) -> None:
        self.store = store
        self._telemetry = telemetry
        self.federator = federator
        self.fabric = fabric
        self.interval_s = interval_s
        self.process = process
        for rule in rules:
            store.add_rule(rule)
        self._sampler: Optional[RegistrySampler] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def telemetry(self) -> Any:
        if self._telemetry is not None:
            return self._telemetry
        from .pipeline import get_telemetry

        return get_telemetry()

    def collect(self, now: Optional[float] = None) -> None:
        """One collection cycle (the probe/test seam — the thread just
        calls this on a timer). Each stage is independently shielded:
        a dead scrape target or a fabric snapshot bug costs that stage
        one cycle, not the collector."""
        now = self.store.clock() if now is None else now
        tel = self.telemetry
        if self._sampler is None:
            self._sampler = RegistrySampler(
                self.store, tel.registry, process=self.process
            )
        try:
            self._sampler.sample(now)
        except Exception:  # noqa: BLE001 — shielded stage
            logger.exception("observatory local sample failed")
        if self.federator is not None:
            try:
                self.federator.scrape(now)
            except Exception:  # noqa: BLE001 — shielded stage
                logger.exception("observatory federation scrape failed")
        if self.fabric is not None:
            try:
                self._sample_fabric(now)
            except Exception:  # noqa: BLE001 — shielded stage
                logger.exception("observatory fabric sample failed")
        self.store.evaluate_rules(now)
        tel.tsdb_series.set(float(self.store.series_count()))

    def _sample_fabric(self, now: float) -> None:
        """Per-slot accept-window rates from the fabric snapshot — the
        one fleet surface with no status port of its own. A slot's rate is
        in its ``window`` (``PoolSlot.snapshot``); the reference reads the
        slot's top level, so with a real fabric it samples nothing."""
        snap = self.fabric.snapshot()
        for slot in snap.get("slots", ()):
            label = slot.get("label")
            rate = (slot.get("window") or {}).get("accept_rate")
            if label is None or rate is None:
                continue
            self.store.ingest(
                "fabric.slot_accept_rate", float(rate), t=now,
                labels={"pool": str(label), "process": self.process},
                kind="gauge",
            )

    def summary(self) -> Optional[str]:
        """Reporter fragment: ``tsdb N series``; None before the store
        holds anything (the line then omits the fragment entirely)."""
        n = self.store.series_count()
        if n <= 0:
            return None
        return f"tsdb {n} series"

    def start(self) -> "Observatory":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, name="observatory", daemon=True
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while True:
            try:
                self.collect()
            except Exception:  # noqa: BLE001 — the collector thread
                # must survive any single cycle's failure
                logger.exception("observatory collect cycle failed")
            if self._stop.wait(self.interval_s):
                return

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None
