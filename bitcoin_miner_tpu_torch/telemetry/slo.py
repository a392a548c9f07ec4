"""SLO engine and breach-triggered incident capture.

Counterpart of ``bitcoin_miner_tpu/telemetry/slo.py``, the same code on
the host. The health model answers *stalled or not*; this module answers
*how close to the edge*: it evaluates a declarative objective set over
multi-window **error-budget burn rates**, computed from the metrics the
registry already holds:

=========================  =============================================
objective                  SLI / error budget
=========================  =============================================
``share-efficiency``       the expected-vs-observed work ratio
                           (``share_efficiency``) above the floor, gated
                           on the share accountant's confidence floor
``submit-rtt``             fraction of submit round trips under the
                           bound, from windowed ``submit_rtt`` buckets
``job-broadcast``,         the pool frontend's latency histograms
``frontend-validate``      (``frontend_job_broadcast``,
                           ``frontend_validate``); no_data until a
                           frontend broadcasts or validates
``fleet-availability``     fraction of supervised children not
                           quarantined (``fleet_child_state``)
``pool-accept-rate``       accepted fraction of windowed ``pool_acks``
                           verdicts (with a multi-pool fabric attached,
                           the worst live slot's window rate)
``frontend-claimed-work``  the frontend's claimed-work rate per session
                           (``frontend=``, the ``StratumPoolServer``);
                           no_data without a frontend
=========================  =============================================

Burn rate = (1 − SLI) / (1 − target): 1.0 burns the error budget exactly
at its sustainable rate; a fast-window burn ≥ ``breach_burn`` with the
slow window confirming means the objective will be blown long before a
human reads a dashboard. Each tick exports ``tpu_miner_slo_burn
{objective}`` (and, with a fabric, ``tpu_miner_slo_slot_burn
{objective,pool}``), feeds the health model's ``slo`` component (a
sustained fast burn degrades it before an outage stalls anything), logs
transitions to the flight recorder, and renders ``/slo`` (schema
``tpu-miner-slo/1``) and the reporter's ``slo …`` fragment.

A transition into breach fires :class:`IncidentCapture`: the flight
recorder, the drained trace, ``/metrics``, ``/telemetry``, ``/lifecycle``,
the SLO report and the ``slo.*`` history bundled under one
``tpu-miner-incident/1`` manifest keyed to a perf-ledger row. Captures
are rate-limited and never raise into the watchdog that drives them.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from bisect import bisect_left
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from .tsdb import TimeSeriesStore

logger = logging.getLogger(__name__)

SCHEMA = "tpu-miner-slo/1"
INCIDENT_SCHEMA = "tpu-miner-incident/1"

OK = "ok"
NO_DATA = "no_data"
FAST_BURN = "fast_burn"
BREACH = "breach"


@dataclass(frozen=True)
class SloObjective:
    """One declarative objective. ``kind`` picks the SLI recipe:

    - ``ratio_floor``: a level gauge that must stay above ``target``
      (share efficiency) — both windows read the current level;
    - ``latency``: good-events fraction — observations ≤
      ``threshold_s`` over windowed histogram bucket deltas must stay
      above ``target``;
    - ``availability``: fraction of fleet children below the
      quarantined gauge level must stay above ``target``;
    - ``accept_rate``: accepted fraction of windowed verdict deltas
      (or the worst fabric slot's window rate) above ``target``;
    - ``work_floor``: windowed per-session claimed-work rate (the
      frontend's difficulty-weighted submit metering) —
      SLI = min(1, rate / ``floor``); sessions that stopped claiming
      work read as a collapse, not as silence.
    """

    name: str
    description: str
    kind: str
    target: float
    threshold_s: float = 0.0
    signal: str = ""
    #: ``work_floor`` only: the claimed-work rate (difficulty-1 units
    #: per session per second) at which the SLI reads 1.0.
    floor: float = 0.0


#: latency-kind objectives declare WHICH histogram via ``signal`` —
#: this maps the declared registry family to the engine's sample key
#: (the config loader validates against it, so a typo'd signal is a
#: load error, not a silent no_data).
LATENCY_SIGNALS: Dict[str, str] = {
    "tpu_miner_submit_rtt_seconds": "submit_rtt",
    "tpu_miner_frontend_job_broadcast_seconds": "job_broadcast",
    "tpu_miner_frontend_validate_seconds": "frontend_validate",
}

#: the declarative vocabulary the config loader accepts.
OBJECTIVE_KINDS = (
    "ratio_floor", "latency", "availability", "accept_rate",
    "work_floor",
)


DEFAULT_OBJECTIVES: Tuple[SloObjective, ...] = (
    SloObjective(
        "share-efficiency",
        "difficulty-weighted accepted work / hashes swept stays above "
        "the floor (silent work loss burns this budget). Target sized "
        "so a full collapse (efficiency ~0) reaches the breach burn — "
        "a lower floor could cap the burn below the incident trigger",
        "ratio_floor", target=0.90, signal="tpu_miner_share_efficiency",
    ),
    SloObjective(
        "submit-rtt",
        "share submit round-trips complete under the latency bound",
        "latency", target=0.99, threshold_s=2.5,
        signal="tpu_miner_submit_rtt_seconds",
    ),
    SloObjective(
        "job-broadcast",
        "frontend job broadcasts fan out under the latency bound",
        "latency", target=0.99, threshold_s=0.25,
        signal="tpu_miner_frontend_job_broadcast_seconds",
    ),
    SloObjective(
        "frontend-validate",
        "mining.submit validations complete under the latency bound "
        "(a junk submit must stay cheap; a window of slow validations "
        "means the frontend's reject cost is drifting up)",
        "latency", target=0.99, threshold_s=0.001,
        signal="tpu_miner_frontend_validate_seconds",
    ),
    SloObjective(
        "fleet-availability",
        "supervised fleet capacity not quarantined",
        "availability", target=0.95,
        signal="tpu_miner_fleet_child_state",
    ),
    SloObjective(
        "pool-accept-rate",
        "pool verdicts accept the submitted shares (per-slot when the "
        "multi-pool fabric is attached)",
        "accept_rate", target=0.90, signal="tpu_miner_pool_acks",
    ),
    SloObjective(
        "frontend-claimed-work",
        "connected downstream sessions keep claiming work (frontend "
        "difficulty-weighted submit metering; a connected fleet that "
        "stopped submitting is a collapse, not quiet). Target sized "
        "so a full collapse caps at the warn burn — the degraded "
        "signal — because an idle-but-connected fleet is an operator "
        "condition, not an incident; raise it via --slo-objectives "
        "where sessions are known to hash continuously",
        "work_floor", target=0.50, floor=1e-9,
        signal="poolserver.claimed_work",
    ),
)


class SloConfigError(ValueError):
    """An operator objective file failed schema validation — the
    message says which entry and which field, so a bad spec dies at
    startup with a fix-it error, never as a silently-inert objective."""


#: objective-spec fields the loader accepts (anything else is a typo —
#: rejected, because a misspelled ``treshold_s`` silently defaulting to
#: 0 is exactly the failure mode schema validation exists to prevent).
_OBJECTIVE_FIELDS = frozenset(
    {"name", "description", "kind", "target", "threshold_s", "signal",
     "floor"}
)


def parse_objectives(payload: Any, source: str = "<objectives>",
                     ) -> Tuple[SloObjective, ...]:
    """Validate a decoded objectives document into the engine's tuple.

    Schema (``tpu-miner-slo-objectives/1``): a JSON object with an
    ``objectives`` array; each entry needs ``name``/``kind``/``target``,
    latency kinds need ``threshold_s`` and a ``signal`` from
    :data:`LATENCY_SIGNALS`, work_floor kinds need ``floor``. Raises
    :class:`SloConfigError` naming the offending entry and field."""
    def fail(msg: str) -> "SloConfigError":
        return SloConfigError(f"{source}: {msg}")

    if not isinstance(payload, dict):
        raise fail("top level must be a JSON object with an "
                   "'objectives' array")
    schema = payload.get("schema", "tpu-miner-slo-objectives/1")
    if schema != "tpu-miner-slo-objectives/1":
        raise fail(f"unsupported schema {schema!r} (want "
                   "tpu-miner-slo-objectives/1)")
    entries = payload.get("objectives")
    if not isinstance(entries, list) or not entries:
        raise fail("'objectives' must be a non-empty array")
    out: List[SloObjective] = []
    seen: Set[str] = set()
    for i, entry in enumerate(entries):
        where = f"objectives[{i}]"
        if not isinstance(entry, dict):
            raise fail(f"{where} must be an object")
        unknown = sorted(set(entry) - _OBJECTIVE_FIELDS)
        if unknown:
            raise fail(f"{where}: unknown field(s) {', '.join(unknown)} "
                       f"(allowed: {', '.join(sorted(_OBJECTIVE_FIELDS))})")
        name = entry.get("name")
        if not isinstance(name, str) or not name:
            raise fail(f"{where}: 'name' must be a non-empty string")
        where = f"objectives[{i}] ({name})"
        if name in seen:
            raise fail(f"{where}: duplicate objective name")
        seen.add(name)
        kind = entry.get("kind")
        if kind not in OBJECTIVE_KINDS:
            raise fail(f"{where}: 'kind' must be one of "
                       f"{', '.join(OBJECTIVE_KINDS)} (got {kind!r})")
        target = entry.get("target")
        if not isinstance(target, (int, float)) \
                or isinstance(target, bool) or not 0.0 < target <= 1.0:
            raise fail(f"{where}: 'target' must be a number in (0, 1] "
                       f"(got {target!r})")
        threshold_s = entry.get("threshold_s", 0.0)
        if not isinstance(threshold_s, (int, float)) \
                or isinstance(threshold_s, bool) or threshold_s < 0:
            raise fail(f"{where}: 'threshold_s' must be a number >= 0")
        floor = entry.get("floor", 0.0)
        if not isinstance(floor, (int, float)) \
                or isinstance(floor, bool) or floor < 0:
            raise fail(f"{where}: 'floor' must be a number >= 0")
        signal = entry.get("signal", "")
        if not isinstance(signal, str):
            raise fail(f"{where}: 'signal' must be a string")
        description = entry.get("description", "")
        if not isinstance(description, str):
            raise fail(f"{where}: 'description' must be a string")
        if kind == "latency":
            if threshold_s <= 0:
                raise fail(f"{where}: latency objectives need "
                           "'threshold_s' > 0")
            if signal not in LATENCY_SIGNALS:
                raise fail(
                    f"{where}: latency 'signal' must be one of "
                    f"{', '.join(sorted(LATENCY_SIGNALS))} "
                    f"(got {signal!r})"
                )
        if kind == "work_floor" and floor <= 0:
            raise fail(f"{where}: work_floor objectives need "
                       "'floor' > 0")
        out.append(SloObjective(
            name=name, description=description, kind=kind,
            target=float(target), threshold_s=float(threshold_s),
            signal=signal, floor=float(floor),
        ))
    return tuple(out)


def load_objectives(path: str) -> Tuple[SloObjective, ...]:
    """Read + validate an operator objectives file (``slo --objectives
    FILE``, ``--slo-objectives FILE``)."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            payload = json.load(fh)
    except OSError as e:
        raise SloConfigError(f"cannot read {path}: {e}")
    except json.JSONDecodeError as e:
        raise SloConfigError(f"{path} is not valid JSON: {e}")
    return parse_objectives(payload, source=path)


def _histogram_state(hist: Any) -> Tuple[Tuple[float, ...], List[int]]:
    """(bounds, cumulative counts incl. +Inf) for a registry histogram;
    empty for Null metrics."""
    bounds = tuple(getattr(hist, "bounds", ()) or ())
    if not bounds:
        return (), []
    return bounds, list(hist.cumulative_counts())


def _good_fraction(
    bounds: Tuple[float, ...],
    old: List[int],
    new: List[int],
    threshold_s: float,
) -> Tuple[Optional[float], int]:
    """(fraction of window observations ≤ threshold, window count) from
    two cumulative-count snapshots. The threshold maps to the nearest
    bucket bound at or above it — the default objective thresholds are
    exact bucket bounds, so no rounding happens in practice."""
    if not bounds or len(old) != len(new):
        return None, 0
    total = new[-1] - old[-1]
    if total <= 0:
        return None, 0
    idx = bisect_left(bounds, threshold_s)
    if idx >= len(bounds):
        # Threshold past the last finite bucket: everything below +Inf
        # is indistinguishable — count all finite-bucket observations.
        idx = len(bounds) - 1
    good = (new[idx] - old[idx])
    return max(0.0, min(1.0, good / total)), total


def burn_rate(sli: Optional[float], target: float) -> Optional[float]:
    """Error-budget burn: (1 − SLI) / (1 − target). None in = None out;
    a target of 1.0 makes any error an infinite burn (capped)."""
    if sli is None:
        return None
    budget = 1.0 - target
    err = max(0.0, 1.0 - sli)
    if budget <= 0:
        return 0.0 if err == 0 else 1000.0
    return min(1000.0, err / budget)


class SloEngine:
    """Evaluates the objective set over store-held signal history
    (the windowed-delta machinery runs on
    :class:`~.tsdb.TimeSeriesStore` range queries — ONE delta
    implementation, no private per-objective sample caches); one caller
    (the health watchdog via ``HealthModel.sample``, or a test with a
    fake clock) ticks it."""

    def __init__(
        self,
        telemetry: Optional[Any] = None,
        objectives: Tuple[SloObjective, ...] = DEFAULT_OBJECTIVES,
        *,
        fast_window_s: float = 60.0,
        slow_window_s: float = 300.0,
        breach_burn: float = 10.0,
        warn_burn: float = 2.0,
        min_events: int = 4,
        fabric: Optional[Any] = None,
        frontend: Optional[Any] = None,
        store: Optional[TimeSeriesStore] = None,
        clock: Callable[[], float] = time.monotonic,
        on_breach: Optional[Callable[[Dict[str, Any]], None]] = None,
    ) -> None:
        if fast_window_s <= 0 or slow_window_s < fast_window_s:
            raise ValueError(
                "need 0 < fast_window_s <= slow_window_s "
                f"(got {fast_window_s}/{slow_window_s})"
            )
        self._telemetry = telemetry
        self.objectives = tuple(objectives)
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        #: fast-window burn at/above which (slow window confirming) an
        #: objective is in BREACH — the incident trigger.
        self.breach_burn = breach_burn
        #: fast-window burn at/above which the objective reads
        #: fast_burn (degrades health, no incident yet).
        self.warn_burn = warn_burn
        #: minimum windowed events for a rate SLI to count as evidence.
        self.min_events = min_events
        #: optional PoolFabric: per-slot accept windows refine the
        #: pool-accept-rate objective beyond the global counters.
        self.fabric = fabric
        #: optional StratumPoolServer: its claimed-work aggregates feed
        #: the ``work_floor`` objectives (absent = those read no_data).
        self.frontend = frontend
        self._clock = clock
        #: called on any objective's transition INTO breach with the
        #: full report (IncidentCapture.on_breach).
        self.on_breach = on_breach
        #: the TSDB every windowed delta reads from. A shared store
        #: (the cli wires the Observatory's) puts the ``slo.*`` series
        #: on the same ``/query`` plane as the federated fleet series;
        #: standalone engines get a private one sized to the windows.
        #: The store interval must resolve sub-window tick spacing —
        #: an eighth of the fast window keeps probe-speed windows
        #: (seconds) and production windows (minutes) both workable.
        if store is None:
            interval = min(1.0, fast_window_s / 8.0)
            store = TimeSeriesStore(
                interval_s=interval,
                retention_s=slow_window_s + max(10.0, fast_window_s),
            )
        self.store = store
        self._lock = threading.Lock()
        self._states: Dict[str, str] = {}
        #: slot labels exported per objective on the previous tick — a
        #: slot that drops out of the live set (dead, removed from the
        #: --pool config) must have its gauge zeroed, not freeze at its
        #: last burn forever.
        self._exported_slots: Dict[str, Set[str]] = {}
        self.last_report: Optional[Dict[str, Any]] = None

    @property
    def telemetry(self) -> Any:
        if self._telemetry is not None:
            return self._telemetry
        from .pipeline import get_telemetry

        return get_telemetry()

    # ---------------------------------------------------------- sample
    def sample(self) -> Dict[str, Any]:
        """One raw-signal snapshot (the synthetic seam tests drive):
        cumulative histogram states + counter/gauge values, never
        windowed — the window math happens against the history."""
        tel = self.telemetry
        acks: Dict[str, float] = {}
        children = getattr(tel.pool_acks, "children", None)
        if children is not None:
            acks = {key[0]: child.value for key, child in children() if key}
        fleet: Dict[str, float] = {}
        children = getattr(tel.fleet_child_state, "children", None)
        if children is not None:
            fleet = {key[0]: child.value for key, child in children() if key}
        submit_bounds, submit_counts = _histogram_state(tel.submit_rtt)
        bc_bounds, bc_counts = _histogram_state(tel.frontend_job_broadcast)
        fv_bounds, fv_counts = _histogram_state(tel.frontend_validate)
        snap: Dict[str, Any] = {
            "share_efficiency": getattr(tel.share_efficiency, "value", 0.0),
            "share_expected": getattr(tel.share_expected, "value", 0.0),
            "share_lost": getattr(tel.share_lost, "value", 0.0),
            "submit_rtt": (submit_bounds, submit_counts),
            "job_broadcast": (bc_bounds, bc_counts),
            "frontend_validate": (fv_bounds, fv_counts),
            "pool_acks": acks,
            "fleet_children": fleet,
        }
        if self.fabric is not None:
            slot_rates: Dict[str, Optional[float]] = {}
            for slot in getattr(self.fabric, "slots", ()):
                if getattr(slot, "live", False):
                    slot_rates[slot.label] = slot.window.accept_rate()
            snap["slot_accept"] = slot_rates
        if self.frontend is not None:
            # Cumulative aggregates + a timestamp: the work_floor SLI
            # needs the window DURATION, which the reference snapshot
            # alone can't provide.
            snap["frontend_work"] = {
                "t": self._clock(),
                "claimed_work": float(
                    getattr(self.frontend, "claimed_work", 0.0)
                ),
                "submits": float(
                    getattr(self.frontend, "submits", 0)
                ),
                "sessions": float(getattr(
                    getattr(tel, "frontend_sessions", None), "value", 0.0
                )),
            }
        return snap

    # -------------------------------------------------------- evaluate
    def evaluate(
        self,
        snapshot: Optional[Dict[str, Any]] = None,
        now: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Ingest one sample into the store, evaluate every objective
        over the fast and slow windows via store range queries, export
        gauges/events, and — on a transition into breach — fire
        ``on_breach``. Returns the report dict (also cached as
        :attr:`last_report` for ``/slo``)."""
        now = self._clock() if now is None else now
        snap = self.sample() if snapshot is None else snapshot
        with self._lock:
            self._ingest(snap, now)
            fast_ref = self._reference_snapshot(
                snap, now, self.fast_window_s
            )
            slow_ref = self._reference_snapshot(
                snap, now, self.slow_window_s
            )
        statuses = [
            self._evaluate_objective(obj, snap, fast_ref, slow_ref)
            for obj in self.objectives
        ]
        report = {
            "schema": SCHEMA,
            "generated_ts": round(time.time(), 6),
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "breach_burn": self.breach_burn,
            "warn_burn": self.warn_burn,
            "worst": self._worst(statuses),
            "objectives": statuses,
        }
        self._publish(report, statuses)
        return report

    def _ingest(self, snap: Dict[str, Any], now: float) -> None:
        """Write one sample into the store under the ``slo.*``
        namespace (called under the lock). ``slo.tick`` marks every
        evaluation — its oldest in-window point is the delta baseline
        time all reference lookups share."""
        ing = self.store.ingest
        ing("slo.tick", 1.0, t=now)
        for scalar in ("share_efficiency", "share_expected"):
            ing(f"slo.{scalar}",
                float(snap.get(scalar, 0.0) or 0.0), t=now)
        ing("slo.share_lost",
            float(snap.get("share_lost", 0.0) or 0.0), t=now,
            kind="counter")
        for sig in LATENCY_SIGNALS.values():
            bounds, counts = snap.get(sig) or ((), [])
            for i, count in enumerate(counts):
                # Per-bucket-index cumulative counts: bounds are static
                # for a process lifetime, so the index IS the bucket.
                ing(f"slo.{sig}", float(count), t=now,
                    labels={"le": str(i)}, kind="counter")
        for key, value in (snap.get("pool_acks") or {}).items():
            ing("slo.pool_acks", float(value), t=now,
                labels={"result": str(key)}, kind="counter")
        for child, level in (snap.get("fleet_children") or {}).items():
            ing("slo.fleet_child_state", float(level), t=now,
                labels={"child": str(child)})
        for label, rate in (snap.get("slot_accept") or {}).items():
            if rate is not None:
                ing("slo.slot_accept", float(rate), t=now,
                    labels={"pool": str(label)})
        work: Dict[str, float] = snap.get("frontend_work") or {}
        if work:
            ing("slo.frontend_work_t",
                float(work.get("t", 0.0)), t=now)
            ing("slo.claimed_work",
                float(work.get("claimed_work", 0.0)), t=now,
                kind="counter")
            ing("slo.frontend_submits",
                float(work.get("submits", 0.0)), t=now, kind="counter")
            ing("slo.frontend_sessions",
                float(work.get("sessions", 0.0)), t=now)

    def _reference_snapshot(
        self, snap: Dict[str, Any], now: float, window_s: float
    ) -> Optional[Dict[str, Any]]:
        """The signal values as of the OLDEST evaluation tick inside
        the window — the delta baseline, reconstructed from store range
        queries (called under the lock). None when the window holds no
        earlier tick (single data point: rates are unknowable)."""
        ref_t = self.store.oldest_point_time(
            "slo.tick", None, now - window_s, now
        )
        if ref_t is None:
            return None
        at = self.store.value_at
        ref: Dict[str, Any] = {}
        for sig in LATENCY_SIGNALS.values():
            bounds, counts = snap.get(sig) or ((), [])
            ref_counts: List[int] = []
            for i in range(len(counts)):
                value = at(f"slo.{sig}", {"le": str(i)}, ref_t)
                if value is None:
                    # Histogram not yet present at the baseline: no
                    # comparable counts — the SLI reads no evidence.
                    ref_counts = []
                    bounds = ()
                    break
                ref_counts.append(int(value))
            ref[sig] = (tuple(bounds), ref_counts)
        ref_acks: Dict[str, float] = {}
        for key in (snap.get("pool_acks") or {}):
            value = at("slo.pool_acks", {"result": str(key)}, ref_t)
            if value is not None:
                ref_acks[key] = value
        ref["pool_acks"] = ref_acks
        if snap.get("frontend_work"):
            work_t = at("slo.frontend_work_t", None, ref_t)
            claimed = at("slo.claimed_work", None, ref_t)
            sessions = at("slo.frontend_sessions", None, ref_t)
            if (work_t is not None and claimed is not None
                    and sessions is not None):
                ref["frontend_work"] = {
                    "t": work_t,
                    "claimed_work": claimed,
                    "submits": at(
                        "slo.frontend_submits", None, ref_t
                    ) or 0.0,
                    "sessions": sessions,
                }
        return ref

    def _evaluate_objective(
        self,
        obj: SloObjective,
        snap: Dict[str, Any],
        fast_ref: Optional[Dict[str, Any]],
        slow_ref: Optional[Dict[str, Any]],
    ) -> Dict[str, Any]:
        fast_sli, fast_n = self._sli(obj, snap, fast_ref)
        slow_sli, slow_n = self._sli(obj, snap, slow_ref)
        fast = burn_rate(fast_sli, obj.target)
        slow = burn_rate(slow_sli, obj.target)
        # Tolerant comparisons: a collapse computed as error/budget can
        # land a float ulp under the threshold it conceptually equals
        # (0.5/0.05 < 10.0 in binary), and "9.999999x is not a breach"
        # is not a distinction anyone meant to draw.
        eps = 1e-9
        if fast is None:
            state = NO_DATA
        elif (fast >= self.breach_burn * (1 - eps)
              and (slow is None or slow >= 1.0 - eps)):
            state = BREACH
        elif fast >= self.warn_burn * (1 - eps):
            state = FAST_BURN
        else:
            state = OK
        status: Dict[str, Any] = {
            "name": obj.name,
            "description": obj.description,
            "kind": obj.kind,
            "target": obj.target,
            "threshold_s": obj.threshold_s or None,
            "sli_fast": fast_sli,
            "sli_slow": slow_sli,
            "burn_fast": fast,
            "burn_slow": slow,
            "events_fast": fast_n,
            "state": state,
        }
        if obj.kind == "accept_rate":
            # Per-slot view: the headline SLI
            # above reads the WORST live slot — this breaks the same
            # window rates out per slot so ``tpu_miner_slo_slot_burn``
            # (and ``/slo`` readers) can tell one misrouting upstream
            # from a fleet-wide collapse. Empty without a fabric.
            slot_rates: Dict[str, Optional[float]] = \
                snap.get("slot_accept") or {}
            status["slots"] = {
                label: burn_rate(max(0.0, min(1.0, rate)), obj.target)
                for label, rate in slot_rates.items()
                if rate is not None
            }
        return status

    def _sli(
        self,
        obj: SloObjective,
        snap: Dict[str, Any],
        ref: Optional[Dict[str, Any]],
    ) -> Tuple[Optional[float], int]:
        """(SLI, events-in-window). Level objectives (ratio_floor,
        availability) read the current sample; rate objectives need a
        window reference for deltas."""
        if obj.kind == "ratio_floor":
            expected = float(snap.get("share_expected", 0.0) or 0.0)
            if expected <= 0:
                return None, 0
            # Below the shareacct confidence floor the ratio is Poisson
            # noise — the same gate the health drift rule applies.
            from .shareacct import MIN_EXPECTED_SHARES

            if expected < MIN_EXPECTED_SHARES:
                return None, 0
            eff = float(snap.get("share_efficiency", 0.0) or 0.0)
            return max(0.0, min(1.0, eff)), int(expected)
        if obj.kind == "availability":
            fleet: Dict[str, float] = snap.get("fleet_children") or {}
            if not fleet:
                return None, 0
            from .pipeline import FLEET_CHILD_LEVELS

            gone = sum(
                1 for v in fleet.values()
                if v >= FLEET_CHILD_LEVELS["quarantined"]
            )
            return 1.0 - gone / len(fleet), len(fleet)
        if obj.kind == "latency":
            # The objective DECLARES its histogram (the config loader
            # validates the name); an unmapped signal is no evidence,
            # never a silent fallback to the wrong histogram.
            signal = LATENCY_SIGNALS.get(obj.signal, "")
            if not signal:
                return None, 0
            bounds, counts = snap.get(signal) or ((), [])
            if ref is None:
                return None, 0
            _ref_bounds, ref_counts = ref.get(signal) or ((), [])
            sli, n = _good_fraction(
                tuple(bounds), list(ref_counts), list(counts),
                obj.threshold_s,
            )
            if sli is None or n < self.min_events:
                return None, n
            return sli, n
        if obj.kind == "accept_rate":
            slot_rates: Dict[str, Optional[float]] = \
                snap.get("slot_accept") or {}
            measured = [r for r in slot_rates.values() if r is not None]
            if measured:
                # Per-slot (hop-aware) view: the WORST live slot is the
                # one misrouting capacity — exactly what 2008.08184
                # says to watch.
                return max(0.0, min(1.0, min(measured))), len(measured)
            if ref is None:
                return None, 0
            acks: Dict[str, float] = snap.get("pool_acks") or {}
            ref_acks: Dict[str, float] = ref.get("pool_acks") or {}
            total = sum(acks.values()) - sum(ref_acks.values())
            if total < self.min_events:
                return None, int(max(0, total))
            accepted = (
                acks.get("accepted", 0.0) - ref_acks.get("accepted", 0.0)
            )
            return max(0.0, min(1.0, accepted / total)), int(total)
        if obj.kind == "work_floor":
            work: Dict[str, float] = snap.get("frontend_work") or {}
            if not work or ref is None:
                return None, 0
            ref_work: Dict[str, float] = ref.get("frontend_work") or {}
            if not ref_work:
                return None, 0
            dt = work.get("t", 0.0) - ref_work.get("t", 0.0)
            # Sessions must be present across the WHOLE window: a fleet
            # that just connected hasn't had time to claim anything, and
            # an empty listener claims nothing by definition — neither
            # is evidence of collapse.
            sessions = min(
                work.get("sessions", 0.0), ref_work.get("sessions", 0.0)
            )
            if dt <= 0 or sessions < 1 or obj.floor <= 0:
                return None, 0
            claimed = (
                work.get("claimed_work", 0.0)
                - ref_work.get("claimed_work", 0.0)
            )
            rate = max(0.0, claimed) / dt / sessions
            return min(1.0, rate / obj.floor), int(sessions)
        return None, 0

    @staticmethod
    def _worst(statuses: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
        burning = [
            s for s in statuses
            if s["state"] in (FAST_BURN, BREACH) and s["burn_fast"]
        ]
        if not burning:
            return None
        worst = max(burning, key=lambda s: s["burn_fast"])
        return {"name": worst["name"], "burn_fast": worst["burn_fast"],
                "state": worst["state"]}

    # --------------------------------------------------------- publish
    def _publish(
        self, report: Dict[str, Any], statuses: List[Dict[str, Any]]
    ) -> None:
        tel = self.telemetry
        breached_now: List[Dict[str, Any]] = []
        for status in statuses:
            burn = status["burn_fast"]
            tel.slo_burn.labels(objective=status["name"]).set(
                burn if burn is not None else 0.0
            )
            slots = status.get("slots")
            if slots is not None:
                for slot, slot_burn in slots.items():
                    tel.slo_slot_burn.labels(
                        objective=status["name"], pool=slot,
                    ).set(slot_burn if slot_burn is not None else 0.0)
                # Zero (don't freeze) slots that left the live set —
                # a dead upstream must stop reading as actively
                # burning the moment its window rate disappears.
                seen = self._exported_slots.setdefault(
                    status["name"], set())
                for gone in seen - set(slots):
                    tel.slo_slot_burn.labels(
                        objective=status["name"], pool=gone,
                    ).set(0.0)
                seen.clear()
                seen.update(slots)
            prev = self._states.get(status["name"])
            if prev != status["state"]:
                self._states[status["name"]] = status["state"]
                tel.flightrec.record(
                    "slo", objective=status["name"],
                    state=status["state"], previous=prev or "unknown",
                    burn_fast=burn, burn_slow=status["burn_slow"],
                )
                if status["state"] == BREACH:
                    breached_now.append(status)
        self.last_report = report
        if breached_now and self.on_breach is not None:
            try:
                self.on_breach(report)
            except Exception:  # noqa: BLE001 — a capture bug must not
                # take down the watchdog driving the evaluation
                logger.exception("SLO breach capture failed")

    # ------------------------------------------------------------ read
    def states(self) -> List[Dict[str, Any]]:
        """The compact per-objective view the health model's snapshot
        carries (name/state/burn only)."""
        report = self.last_report
        if report is None:
            return []
        return [
            {"name": s["name"], "state": s["state"],
             "burn_fast": s["burn_fast"]}
            for s in report["objectives"]
        ]

    def report_dict(self) -> Dict[str, Any]:
        """The ``/slo`` payload: the cached report, or an empty-but-
        valid document before the first tick."""
        if self.last_report is not None:
            return self.last_report
        return {
            "schema": SCHEMA,
            "generated_ts": round(time.time(), 6),
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "breach_burn": self.breach_burn,
            "warn_burn": self.warn_burn,
            "worst": None,
            "objectives": [],
        }

    def summary(self) -> Optional[str]:
        """Reporter fragment: ``slo ok`` when every evaluated objective
        is ok, the worst burner otherwise, None with no evidence yet
        (the line then omits the fragment entirely)."""
        report = self.last_report
        if report is None:
            return None
        evaluated = [
            s for s in report["objectives"] if s["state"] != NO_DATA
        ]
        if not evaluated:
            return None
        worst = report.get("worst")
        if worst is None:
            return "slo ok"
        return (
            f"slo {worst['name']} {worst['burn_fast']:.1f}x"
            + ("!" if worst["state"] == BREACH else "")
        )

    def series_history(
        self,
        window_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Dict[str, Any]:
        """The ``slo.*`` signal history as a ``tpu-miner-query/1``
        range query — at breach time, exactly the pre-breach window
        the incident bundle's ``series.json`` must answer for. The
        default window spans the slow window plus one fast window of
        lead-in (timestamps ride the engine clock)."""
        now = self._clock() if now is None else now
        if window_s is None:
            window_s = self.slow_window_s + self.fast_window_s
        return self.store.query(
            prefix="slo.", window_s=window_s, now=now
        )


# ----------------------------------------------------------- incidents
class IncidentCapture:
    """Breach-triggered forensic bundle writer.

    One capture = one directory under ``out_dir`` named by a fresh
    perf-ledger row id, holding flightrec/trace/metrics/telemetry/
    lifecycle/slo snapshots plus the ``tpu-miner-incident/1`` manifest,
    with a ledger row (metric ``incident``, non-gateable unit) keying
    the bundle into the same evidence trail ``perf capture`` feeds.
    Captures never raise (the caller is the health watchdog) and are
    rate-limited per process."""

    def __init__(
        self,
        telemetry: Optional[Any] = None,
        out_dir: str = "tpu-miner-incidents",
        *,
        ledger_path: Optional[str] = None,
        stats: Optional[Any] = None,
        health: Optional[Any] = None,
        fabric: Optional[Any] = None,
        slo: Optional[SloEngine] = None,
        min_interval_s: float = 120.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._telemetry = telemetry
        self.out_dir = out_dir
        #: default: a ledger INSIDE the bundle root, so a live miner
        #: never writes into the repo's bench ledger uninvited.
        self.ledger_path = ledger_path or os.path.join(
            out_dir, "incident_ledger.jsonl"
        )
        self.stats = stats
        self.health = health
        self.fabric = fabric
        #: optional SloEngine: bundles gain ``series.json`` — the
        #: breached objective's pre-breach signal history from the
        #: engine's store (a bundle answers "what was it doing for the
        #: five minutes before").
        self.slo = slo
        self.min_interval_s = min_interval_s
        self._clock = clock
        self._lock = threading.Lock()
        self._last_capture_t: Optional[float] = None
        self.captured = 0
        self.suppressed = 0
        self.last_manifest_path: Optional[str] = None

    @property
    def telemetry(self) -> Any:
        if self._telemetry is not None:
            return self._telemetry
        from .pipeline import get_telemetry

        return get_telemetry()

    def on_breach(self, slo_report: Dict[str, Any]) -> None:
        """The ``SloEngine.on_breach`` hook."""
        self.capture("slo-breach", slo_report=slo_report)

    def capture(
        self, trigger: str, slo_report: Optional[Dict[str, Any]] = None,
    ) -> Optional[str]:
        """Write one bundle; returns the manifest path, or None when
        rate-limited or irrecoverably failed."""
        now = self._clock()
        with self._lock:
            if (self._last_capture_t is not None
                    and now - self._last_capture_t < self.min_interval_s):
                self.suppressed += 1
                return None
            self._last_capture_t = now
        try:
            return self._capture_locked_out(trigger, slo_report)
        except Exception:  # noqa: BLE001 — the black box must not crash
            # the watchdog thread that tripped it
            logger.exception("incident capture failed (trigger=%s)", trigger)
            return None

    def _capture_locked_out(
        self, trigger: str, slo_report: Optional[Dict[str, Any]],
    ) -> str:
        from .perfledger import LedgerError, PerfLedger, new_row_id
        from .tracing import atomic_json_dump

        tel = self.telemetry
        row_id = new_row_id()
        outdir = os.path.join(self.out_dir, row_id)
        os.makedirs(outdir, exist_ok=True)
        manifest: Dict[str, Any] = {
            "schema": INCIDENT_SCHEMA,
            "ledger_id": row_id,
            "ledger": self.ledger_path,
            "trigger": trigger,
            "captured_ts": round(time.time(), 6),
            "errors": [],
        }
        artifacts: Dict[str, str] = {"dir": outdir}

        def write_json(name: str, payload: Dict[str, Any]) -> None:
            path = os.path.join(outdir, f"{name}.json")
            try:
                atomic_json_dump(payload, path)
                artifacts[name] = path
            except (OSError, TypeError, ValueError) as e:
                manifest["errors"].append(f"{name} snapshot failed: {e}")

        objective: Optional[str] = None
        burn: Optional[float] = None
        if slo_report is not None:
            write_json("slo", slo_report)
            worst = slo_report.get("worst") or {}
            objective = worst.get("name")
            burn = worst.get("burn_fast")
        if self.slo is not None:
            try:
                write_json("series", self.slo.series_history())
            except Exception as e:  # noqa: BLE001 — optional extra
                manifest["errors"].append(
                    f"series snapshot failed: {e}"
                )
        write_json("flightrec", tel.flightrec.dump_dict(reason="incident"))
        write_json("lifecycle", tel.lifecycle.dump_dict())
        telemetry_payload: Dict[str, Any] = dict(tel.registry.snapshot())
        if self.fabric is not None:
            try:
                telemetry_payload["pool_fabric"] = self.fabric.snapshot()
            except Exception as e:  # noqa: BLE001 — optional extra
                manifest["errors"].append(f"fabric snapshot failed: {e}")
        write_json("telemetry", telemetry_payload)
        if self.health is not None:
            try:
                # CACHED report only, never a fresh evaluate(): the
                # breach that triggered this capture fired from INSIDE
                # HealthModel.evaluate() (sample() ticks the SLO
                # engine while holding the model's non-reentrant lock)
                # — healthz() without a report would re-enter evaluate
                # on the same thread and deadlock the watchdog.
                cached = self.health.last_report
                if cached:
                    _status, payload = self.health.healthz(cached)
                    write_json("healthz", payload)
                else:
                    manifest["errors"].append(
                        "healthz snapshot skipped: no cached report yet"
                    )
            except Exception as e:  # noqa: BLE001 — optional extra
                manifest["errors"].append(f"healthz snapshot failed: {e}")
        # Tracer DRAIN, not copy: the span buffer is bounded, and the
        # spans of the breach window belong to this bundle — the next
        # incident gets the next window (the CollectTrace semantic).
        if getattr(tel.tracer, "enabled", False):
            write_json("trace", tel.tracer.drain())
        try:
            metrics_path = os.path.join(outdir, "metrics.txt")
            if self.stats is not None:
                from ..utils.status import prometheus_text

                text = prometheus_text(self.stats, tel.registry)
            else:
                text = tel.registry.render()
            with open(metrics_path, "w", encoding="utf-8") as fh:
                fh.write(text)
            artifacts["metrics"] = metrics_path
        except (OSError, ValueError) as e:
            manifest["errors"].append(f"metrics snapshot failed: {e}")

        manifest["artifacts"] = artifacts
        manifest_path = os.path.join(outdir, "incident.json")
        atomic_json_dump(manifest, manifest_path)
        try:
            PerfLedger(self.ledger_path).append(
                {
                    "metric": "incident",
                    "value": float(burn) if burn is not None else None,
                    "unit": "burn",
                    "trigger": trigger,
                    "objective": objective,
                },
                artifacts=dict(artifacts),
                row_id=row_id,
            )
        except (LedgerError, OSError) as e:
            logger.warning("incident ledger append failed: %s", e)
        self.captured += 1
        self.last_manifest_path = manifest_path
        tel.incidents.labels(objective=objective or "manual").inc()
        tel.flightrec.record(
            "incident", trigger=trigger, objective=objective,
            burn_fast=burn, manifest=manifest_path,
        )
        logger.warning(
            "incident captured (%s%s): %s", trigger,
            f", objective {objective}" if objective else "", manifest_path,
        )
        return manifest_path


# ----------------------------------------------------------------- cli
def _fetch_json(url: str, timeout: float = 5.0) -> Dict[str, Any]:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        payload = json.loads(resp.read().decode("utf-8"))
    if not isinstance(payload, dict):
        raise ValueError(f"{url} did not return a JSON object")
    return payload


def _render_report(report: Dict[str, Any]) -> int:
    """Human table; exit code 1 when anything is breaching."""
    worst_state = OK
    print(f"SLO report (fast {report.get('fast_window_s')}s / "
          f"slow {report.get('slow_window_s')}s windows, breach at "
          f"{report.get('breach_burn')}x fast burn):")
    objectives = report.get("objectives") or []
    if not objectives:
        print("  (no evaluations yet)")
    for s in objectives:
        fast = s.get("burn_fast")
        slow = s.get("burn_slow")
        sli = s.get("sli_fast")
        print(
            f"  [{s.get('state', '?'):>9}] {s.get('name'):<20} "
            f"target {s.get('target'):g}"
            + (f"  sli {sli:.4f}" if sli is not None else "  sli -")
            + (f"  burn {fast:.2f}x" if fast is not None else "  burn -")
            + (f"/{slow:.2f}x" if slow is not None else "")
        )
        if s.get("state") == BREACH:
            worst_state = BREACH
    return 1 if worst_state == BREACH else 0


def main(argv: Optional[List[str]] = None) -> int:
    """The ``slo`` subcommand: print the declarative objective table, or
    fetch and render a live ``/slo`` report (exit 1 on breach)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m bitcoin_miner_tpu_torch slo",
        description="fleet SLO engine: declarative objectives, "
                    "multi-window burn rates, breach-triggered "
                    "incident bundles (telemetry/slo.py)",
    )
    parser.add_argument("--status-url", default=None,
                        help="a live --status-port base URL — fetch "
                             "/slo and render it (exit 1 on breach)")
    parser.add_argument("--from", dest="src", default=None, metavar="FILE",
                        help="render a saved /slo (or incident bundle "
                             "slo.json) report instead of fetching")
    parser.add_argument("--json", action="store_true",
                        help="print the raw report JSON")
    parser.add_argument("--objectives", default=None, metavar="FILE",
                        help="operator objectives file "
                             "(tpu-miner-slo-objectives/1 JSON) — "
                             "validate it and print ITS table instead "
                             "of the built-in DEFAULT_OBJECTIVES; the "
                             "same file the mining modes take via "
                             "--slo-objectives")
    args = parser.parse_args(argv)
    if args.status_url and args.src:
        parser.error("--status-url and --from are mutually exclusive")
    import sys

    objectives = DEFAULT_OBJECTIVES
    source = "telemetry/slo.py DEFAULT_OBJECTIVES"
    if args.objectives:
        try:
            objectives = load_objectives(args.objectives)
        except SloConfigError as e:
            print(f"bad --objectives file: {e}", file=sys.stderr)
            return 2
        source = args.objectives
    if args.status_url:
        try:
            report = _fetch_json(args.status_url.rstrip("/") + "/slo")
        except Exception as e:  # noqa: BLE001 — CLI surface
            print(f"cannot fetch /slo: {e}", file=sys.stderr)
            return 2
    elif args.src:
        try:
            with open(args.src, "r", encoding="utf-8") as fh:
                report = json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            print(f"cannot read {args.src}: {e}", file=sys.stderr)
            return 2
    else:
        print(f"Declared objectives ({source}):")
        for obj in objectives:
            bound = f" <= {obj.threshold_s:g}s" if obj.threshold_s else ""
            if obj.kind == "work_floor" and obj.floor:
                bound = f" >= {obj.floor:g}/session/s"
            print(f"  {obj.name:<20} [{obj.kind}] target "
                  f"{obj.target:g}{bound}  — {obj.description}")
        print("\nrun with --status-url http://127.0.0.1:<status-port> "
              "to evaluate a live miner")
        return 0
    if args.json:
        print(json.dumps(report, indent=1))
        objectives = report.get("objectives") or []
        return 1 if any(s.get("state") == BREACH for s in objectives) else 0
    return _render_report(report)
