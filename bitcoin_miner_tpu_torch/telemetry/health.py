"""Self-monitoring health model (``/healthz``).

Counterpart of ``bitcoin_miner_tpu/telemetry/health.py``, with the rules
of the components this package has: a small rule engine over the metrics
the pipeline already emits that classifies each component ``ok`` /
``degraded`` / ``stalled`` with a machine-readable reason:

==================  =====================================================
component           signals
==================  =====================================================
``device``          completed batches (``MinerStats.batches`` or the
                    ``scan_batch`` count) against work in flight (the busy
                    clock, ``ring_occupancy``); the recent ``dispatch_gap``
                    mean
``ring``            ``ring_occupancy`` > 0 with ``ring_collect`` still
``rpc``             ``stream_window`` > 0 with ``rpc_responses`` still;
                    ``rpc_errors`` growth
``pool``            ``submits_inflight`` > 0 with ``pool_acks`` still;
                    reject-only ack windows
``shares``          ``share_efficiency`` below the drift bound once
                    ``share_expected`` clears the confidence floor
``frontend``        the pool frontend's downstream side (``poolserver/``):
                    ``frontend_sessions`` is the traffic signal; a window of
                    invalid ``frontend_shares`` verdicts with none accepted
                    degrades it (junk shares, or mis-built jobs)
``pools``           the multi-pool fabric's ``pool_slot_state`` gauges: any
                    slot degraded or dead degrades it, all slots dead stall
                    it (no upstream left to mine for)
``fleet``           the fleet supervisor's ``fleet_child_state`` gauges: any
                    child degraded, probing or quarantined degrades it, all
                    children quarantined stall it (nothing left to hash with)
``frontend_shard``  the sharded frontend's ``frontend_shard_state``
                    gauges: any shard off serving degrades it, all shards
                    down stall it (no process left accepting)
``slo``             the SLO engine's objective states (``telemetry/slo.py``):
                    any objective at fast burn or in breach degrades it;
                    burn never stalls (503 stays the stall rules')
``share_loss``      the lost-share burst: the fast window's loss rate over
                    the slow window's base rate, from ``slo.share_lost`` in
                    the engine's store, which :meth:`HealthModel.sample`'s
                    loss sweep fills
``chip:<n>``        a fan-out card's ``chip_inflight`` > 0 with its
                    ``chip_dispatches`` still
==================  =====================================================

An absent input is no component, as in the reference: no ``frontend``
without a frontend, no ``pools`` without a fabric, no
``frontend_shard`` without shards. The ``slo`` and ``share_loss``
components exist only with an SLO engine (``slo=``).

The stall rules share one shape: work is pending but the component's
progress counter stopped. A slow component keeps making progress (ok or
degraded); a wedged one holds work forever (stalled). Verdicts go out as
``/healthz`` (200, or 503 when anything is stalled), the
``tpu_miner_health{component}`` gauges, the reporter line and a
flight-recorder event per transition. :class:`HealthWatchdog` drives the
model from its own thread, so a wedged event loop is still diagnosed.
Rules read a plain snapshot dict (:meth:`HealthModel.sample` builds it
from the live registry), so tests drive them with synthetic snapshots and
a fake clock.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

from .pipeline import (
    FLEET_CHILD_LEVELS,
    FRONTEND_SHARD_LEVELS,
    POOL_SLOT_LEVELS,
)
from .shareacct import DRIFT_DEGRADED_BELOW, MIN_EXPECTED_SHARES

logger = logging.getLogger(__name__)

OK = "ok"
DEGRADED = "degraded"
STALLED = "stalled"
_LEVEL = {OK: 0, DEGRADED: 1, STALLED: 2}


@dataclass(frozen=True)
class ComponentHealth:
    component: str
    state: str
    reason: str = ""


class HealthModel:
    """Rule engine over the pipeline's metric registry."""

    #: True while a HealthWatchdog drives evaluations. The model keeps
    #: windowed deltas and progress stamps, so one caller evaluates: with
    #: the watchdog on, ``healthz`` answers from its cached report, or a
    #: fast poller would consume the deltas between ticks and hide every
    #: degraded verdict.
    driven = False

    def __init__(
        self,
        telemetry: Optional[Any] = None,
        stats: Optional[Any] = None,
        *,
        stall_after_s: float = 10.0,
        degraded_gap_s: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
        slo: Optional[Any] = None,
    ) -> None:
        self._telemetry = telemetry
        self.stats = stats
        #: optional SLO engine (``telemetry/slo.py``). The watchdog that
        #: drives this model also ticks the engine: every live sample
        #: evaluates the objectives, and their states ride the snapshot
        #: into the ``slo`` rule.
        self.slo = slo
        #: seconds a component may hold work without progress before it
        #: is stalled.
        self.stall_after_s = stall_after_s
        #: a recent mean inter-dispatch gap above this degrades the device.
        self.degraded_gap_s = degraded_gap_s
        #: expected-share floor below which the drift rule is silent, and
        #: the confident efficiency below which it degrades: one
        #: definition, beside the estimator.
        self.share_min_expected = MIN_EXPECTED_SHARES
        self.share_eff_low = DRIFT_DEGRADED_BELOW
        #: the lost-share burst rule: a fast-window loss rate above this
        #: multiple of the slow window's base rate degrades ...
        self.loss_rate_multiple = 3.0
        #: ... once the fast window lost at least this many shares.
        self.loss_min_events = 3.0
        self._clock = clock
        self._lock = threading.Lock()
        #: per-signal (value, time of last change).
        self._progress: Dict[str, Tuple[Any, float]] = {}
        #: previous (count, sum) of the gap histogram: the recent mean.
        self._gap_seen = (0, 0.0)
        self._err_seen = 0.0
        self._ack_seen: Dict[str, float] = {}
        self._frontend_seen: Dict[str, float] = {}
        #: last published state per component (transition detection).
        self._published: Dict[str, str] = {}
        self.last_report: Dict[str, ComponentHealth] = {}

    @property
    def telemetry(self) -> Any:
        if self._telemetry is not None:
            return self._telemetry
        from .pipeline import get_telemetry

        return get_telemetry()

    # ----------------------------------------------------------- sample
    @staticmethod
    def _children_sum(family: Any) -> float:
        children = getattr(family, "children", None)
        if children is None:
            return 0.0
        return sum(child.value for _key, child in children())

    @staticmethod
    def _children_by_label(family: Any) -> Dict[str, float]:
        children = getattr(family, "children", None)
        if children is None:
            return {}
        return {key[0]: child.value for key, child in children() if key}

    def sample(self) -> Dict[str, Any]:
        """One snapshot of every signal the rules read, as a plain dict."""
        tel = self.telemetry
        stats = self.stats
        chips: Dict[str, dict] = {}
        for label, value in self._children_by_label(tel.chip_inflight).items():
            chips.setdefault(label, {})["inflight"] = value
        for label, value in (
            self._children_by_label(tel.chip_dispatches).items()
        ):
            chips.setdefault(label, {}).setdefault("inflight", 0.0)
            chips[label]["dispatches"] = value
        for chip in chips.values():
            chip.setdefault("dispatches", 0.0)
        # The lifecycle loss sweep rides the sample (the watchdog is the
        # periodic caller that survives a wedged event loop): each newly
        # lost share is counted and left in the flight recorder with its
        # hops.
        for record in tel.lifecycle.scan_losses():
            tel.share_lost.inc()
            tel.flightrec.record(
                "share_lost", key=record["key"],
                trace=record.get("trace"),
                hops=[h["hop"] for h in record["hops"]],
                age_s=round(
                    self._clock() - record.get("last_t", record["born_t"]),
                    3,
                ),
            )
        slo_states = None
        share_loss = None
        if self.slo is not None:
            try:
                self.slo.evaluate()
            except Exception:  # noqa: BLE001 — a burn-math bug must not
                # blind the stall rules that share this watchdog
                logger.exception("SLO evaluation failed")
            slo_states = self.slo.states()
            # The loss sweep above fed slo.share_lost into the engine's
            # store: its reset-aware windowed increases, anchored to the
            # latest evaluation tick, give the burst rule its rates.
            store = self.slo.store
            latest = store.latest("slo.tick")
            if latest is not None:
                tick_t = latest[0]
                fast_s = self.slo.fast_window_s
                slow_s = self.slo.slow_window_s
                fast_inc, _ = store.windowed_increase(
                    "slo.share_lost", None, tick_t - fast_s, tick_t)
                slow_inc, _ = store.windowed_increase(
                    "slo.share_lost", None, tick_t - slow_s, tick_t)
                share_loss = {
                    "fast_lost": fast_inc or 0.0,
                    "fast_rate": (fast_inc or 0.0) / fast_s,
                    "base_rate": (slow_inc or 0.0) / slow_s,
                }
        return {
            "slo": slo_states,
            "share_loss": share_loss,
            "batches": (
                stats.batches if stats is not None
                else getattr(tel.scan_batch, "count", 0)
            ),
            "active_scans": (
                getattr(stats, "_active_scans", 0) if stats is not None else 0
            ),
            "gap_count": getattr(tel.dispatch_gap, "count", 0),
            "gap_sum": getattr(tel.dispatch_gap, "sum", 0.0),
            "ring_occupancy": getattr(tel.ring_occupancy, "value", 0.0),
            "ring_collects": getattr(tel.ring_collect, "count", 0),
            "stream_window": getattr(tel.stream_window, "value", 0.0),
            "rpc_responses": getattr(tel.rpc_responses, "value", 0.0),
            "rpc_errors": self._children_sum(tel.rpc_errors),
            "submits_inflight": getattr(tel.submits_inflight, "value", 0.0),
            "pool_acks": self._children_by_label(tel.pool_acks),
            "chips": chips,
            "share_expected": getattr(tel.share_expected, "value", 0.0),
            "share_efficiency": getattr(
                tel.share_efficiency, "value", 0.0
            ),
            "frontend_sessions": getattr(tel.frontend_sessions, "value",
                                         0.0),
            "frontend_shares": self._children_by_label(tel.frontend_shares),
            "pool_slots": self._children_by_label(tel.pool_slot_state),
            "fleet_children": self._children_by_label(
                tel.fleet_child_state
            ),
            "frontend_shards": self._children_by_label(
                tel.frontend_shard_state
            ),
        }

    # --------------------------------------------------------- evaluate
    def _age(self, key: str, value: Any, now: float) -> float:
        """Seconds since this signal last changed (0.0 = changed now)."""
        prev = self._progress.get(key)
        if prev is None or value != prev[0]:
            self._progress[key] = (value, now)
            return 0.0
        return now - prev[1]

    def evaluate(
        self,
        snapshot: Optional[Dict[str, Any]] = None,
        now: Optional[float] = None,
    ) -> Dict[str, ComponentHealth]:
        """Classify every component from ``snapshot`` (default: a live
        :meth:`sample`). Stateful across calls, so one caller evaluates."""
        with self._lock:
            return self._evaluate_locked(
                self.sample() if snapshot is None else snapshot,
                self._clock() if now is None else now,
            )

    def _evaluate_locked(
        self, snap: Dict[str, Any], now: float
    ) -> Dict[str, ComponentHealth]:
        report: Dict[str, ComponentHealth] = {}
        stall = self.stall_after_s

        # device: progress = completed batches; pending = the busy clock
        # or the ring holds work. A recent mean gap above the bound
        # degrades (slow, not dead).
        batches_age = self._age("device", snap["batches"], now)
        pending = (
            snap["active_scans"] > 0 or snap["ring_occupancy"] > 0
        )
        gap_count, gap_sum = snap["gap_count"], snap["gap_sum"]
        seen_count, seen_sum = self._gap_seen
        self._gap_seen = (gap_count, gap_sum)
        recent_gap = (
            (gap_sum - seen_sum) / (gap_count - seen_count)
            if gap_count > seen_count else 0.0
        )
        if pending and batches_age >= stall:
            report["device"] = ComponentHealth(
                "device", STALLED,
                f"work in flight but no batch completed in "
                f"{batches_age:.0f}s",
            )
        elif recent_gap > self.degraded_gap_s:
            report["device"] = ComponentHealth(
                "device", DEGRADED,
                f"mean inter-dispatch gap {recent_gap:.2f}s",
            )
        elif snap["batches"] == 0:
            report["device"] = ComponentHealth("device", OK, "no traffic yet")
        else:
            report["device"] = ComponentHealth(
                "device", OK, "idle" if batches_age >= stall else "",
            )

        # ring: dispatches held but the collect side stopped draining.
        collect_age = self._age("ring", snap["ring_collects"], now)
        if snap["ring_occupancy"] > 0 and collect_age >= stall:
            report["ring"] = ComponentHealth(
                "ring", STALLED,
                f"{snap['ring_occupancy']:.0f} dispatches in the ring, "
                f"none collected in {collect_age:.0f}s",
            )
        else:
            report["ring"] = ComponentHealth("ring", OK)

        # rpc: wire window occupied but responses stopped; recent errors
        # degrade even while progress continues.
        resp_age = self._age("rpc", snap["rpc_responses"], now)
        err_delta = snap["rpc_errors"] - self._err_seen
        self._err_seen = snap["rpc_errors"]
        if snap["stream_window"] > 0 and resp_age >= stall:
            report["rpc"] = ComponentHealth(
                "rpc", STALLED,
                f"{snap['stream_window']:.0f} requests on the wire, no "
                f"response in {resp_age:.0f}s",
            )
        elif err_delta > 0:
            report["rpc"] = ComponentHealth(
                "rpc", DEGRADED, f"{err_delta:.0f} rpc errors since last "
                "check",
            )
        else:
            report["rpc"] = ComponentHealth("rpc", OK)

        # pool: submits awaiting a verdict with the ack counter still =
        # the pool stopped acking; an all-reject window degrades. (The
        # reference refines a stall with a reachability probe of its TPU
        # relay, which this package has no counterpart of.)
        acks: Dict[str, float] = snap["pool_acks"]
        total_acks = sum(acks.values())
        ack_age = self._age("pool", total_acks, now)
        accept_delta = acks.get("accepted", 0.0) - self._ack_seen.get(
            "accepted", 0.0
        )
        reject_delta = acks.get("rejected", 0.0) - self._ack_seen.get(
            "rejected", 0.0
        )
        self._ack_seen = dict(acks)
        if snap["submits_inflight"] > 0 and ack_age >= stall:
            report["pool"] = ComponentHealth(
                "pool", STALLED,
                f"{snap['submits_inflight']:.0f} submits awaiting a pool "
                f"response, none acked in {ack_age:.0f}s",
            )
        elif reject_delta > 0 and accept_delta == 0:
            report["pool"] = ComponentHealth(
                "pool", DEGRADED,
                f"{reject_delta:.0f} rejects, 0 accepts since last check",
            )
        else:
            report["pool"] = ComponentHealth("pool", OK)

        # shares: expected-vs-observed drift, which every rule above is
        # blind to (hits failing verification, shares lost stale). Absent
        # keys = no accounting = no component.
        expected = snap.get("share_expected", 0.0)
        if expected >= self.share_min_expected:
            eff = snap.get("share_efficiency", 0.0)
            if eff < self.share_eff_low:
                report["shares"] = ComponentHealth(
                    "shares", DEGRADED,
                    f"share efficiency {eff:.2f} over ~{expected:.0f} "
                    f"expected shares — hashes are not becoming credited "
                    f"shares (hw_error/stale/pool loss?)",
                )
            else:
                report["shares"] = ComponentHealth("shares", OK)

        # frontend: the pool frontend's downstream side. Sessions are the
        # traffic signal, the verdict counters the quality signal: a
        # window in which every downstream submit failed validation and
        # none passed means mis-built jobs or an adversarial fleet. Both
        # degrade, never stall: the listener still answers. Absent keys
        # (no frontend) = no component.
        fe_shares: Dict[str, float] = snap.get("frontend_shares", {})
        fe_sessions = snap.get("frontend_sessions", 0.0)
        if fe_sessions > 0 or fe_shares:
            fe_accept_delta = (fe_shares.get("accepted", 0.0)
                               - self._frontend_seen.get("accepted", 0.0))
            fe_invalid_delta = sum(
                v for k, v in fe_shares.items() if k != "accepted"
            ) - sum(
                v for k, v in self._frontend_seen.items() if k != "accepted"
            )
            self._frontend_seen = dict(fe_shares)
            if fe_invalid_delta > 0 and fe_accept_delta == 0:
                report["frontend"] = ComponentHealth(
                    "frontend", DEGRADED,
                    f"{fe_invalid_delta:.0f} invalid downstream shares, "
                    f"0 accepted since last check "
                    f"({fe_sessions:.0f} sessions)",
                )
            else:
                report["frontend"] = ComponentHealth("frontend", OK)

        # pools: the multi-pool fabric's slot gauges (absent or empty: no
        # fabric, no component, so a one-pool session is unaffected). The
        # fabric fails over within a dispatch generation; this is the
        # operator's view: a slot parked degraded or dead costs
        # redundancy, and all dead leaves no upstream to mine for.
        slots: Dict[str, float] = snap.get("pool_slots", {})
        if slots:
            dead = sorted(k for k, v in slots.items()
                          if v >= POOL_SLOT_LEVELS["dead"])
            bad = sorted(k for k, v in slots.items()
                         if v >= POOL_SLOT_LEVELS["degraded"])
            if len(dead) == len(slots):
                report["pools"] = ComponentHealth(
                    "pools", STALLED,
                    f"all {len(slots)} upstream pool slots dead",
                )
            elif bad:
                report["pools"] = ComponentHealth(
                    "pools", DEGRADED,
                    f"pool slots not serving: {', '.join(bad)} "
                    f"({len(slots) - len(bad)} live)",
                )
            else:
                report["pools"] = ComponentHealth("pools", OK)

        # fleet: the supervisor's per-child gauges (absent or empty: no
        # supervisor, no component). The supervisor reclaims and rejoins
        # within a tick; this is the operator's view: any child off active
        # costs capacity, and all quarantined leaves nothing to hash with.
        fleet: Dict[str, float] = snap.get("fleet_children", {})
        if fleet:
            gone = sorted(
                k for k, v in fleet.items()
                if v >= FLEET_CHILD_LEVELS["quarantined"]
            )
            impaired = sorted(
                k for k, v in fleet.items()
                if v >= FLEET_CHILD_LEVELS["degraded"]
            )
            if len(gone) == len(fleet):
                report["fleet"] = ComponentHealth(
                    "fleet", STALLED,
                    f"all {len(fleet)} fleet children quarantined",
                )
            elif impaired:
                report["fleet"] = ComponentHealth(
                    "fleet", DEGRADED,
                    f"fleet children impaired: {', '.join(impaired)} "
                    f"({len(fleet) - len(impaired)} active)",
                )
            else:
                report["fleet"] = ComponentHealth("fleet", OK)

        # frontend_shard: the sharded frontend's per-acceptor gauges
        # (absent or empty: unsharded, no component). The supervisor
        # respawns a dead shard within a liveness tick; this is the
        # operator's view: a shard off serving costs accept capacity (the
        # survivors' disjoint prefix ranges keep validating), and all down
        # leaves no process accepting connections.
        shards: Dict[str, float] = snap.get("frontend_shards", {})
        if shards:
            down = sorted(k for k, v in shards.items()
                          if v >= FRONTEND_SHARD_LEVELS["down"])
            off = sorted(k for k, v in shards.items()
                         if v >= FRONTEND_SHARD_LEVELS["degraded"])
            if len(down) == len(shards):
                report["frontend_shard"] = ComponentHealth(
                    "frontend_shard", STALLED,
                    f"all {len(shards)} frontend shards down",
                )
            elif off:
                report["frontend_shard"] = ComponentHealth(
                    "frontend_shard", DEGRADED,
                    f"frontend shards not serving: {', '.join(off)} "
                    f"({len(shards) - len(off)} serving)",
                )
            else:
                report["frontend_shard"] = ComponentHealth(
                    "frontend_shard", OK)

        # slo: the objective states (absent or None: no engine, no
        # component; all no_data: no evidence yet, no component). Burn
        # degrades by design: the engine predicts budget exhaustion, it
        # never proves a wedge, so 503 stays the stall rules'.
        slo_states = snap.get("slo")
        if slo_states:
            evaluated = [
                s for s in slo_states if s.get("state") != "no_data"
            ]
            burning = sorted(
                s["name"] for s in slo_states
                if s.get("state") in ("fast_burn", "breach")
            )
            if burning:
                worst = max(
                    (s.get("burn_fast") or 0.0) for s in slo_states
                    if s["name"] in burning
                )
                report["slo"] = ComponentHealth(
                    "slo", DEGRADED,
                    f"error budget burning: {', '.join(burning)} "
                    f"(fast burn up to {worst:.1f}x)",
                )
            elif evaluated:
                report["slo"] = ComponentHealth("slo", OK)

        # share_loss: the fast window's loss rate against the slow
        # window's base rate. A steady trickle is what the shares rule
        # prices in; several times the base rate is a submit path losing
        # work now. Absent (no engine, no tick yet): no component.
        loss: Dict[str, float] = snap.get("share_loss") or {}
        if loss:
            fast_lost = loss.get("fast_lost", 0.0)
            fast_rate = loss.get("fast_rate", 0.0)
            base_rate = loss.get("base_rate", 0.0)
            if (fast_lost >= self.loss_min_events
                    and fast_rate > self.loss_rate_multiple * base_rate):
                report["share_loss"] = ComponentHealth(
                    "share_loss", DEGRADED,
                    f"{fast_lost:.0f} shares lost in the fast window "
                    f"({fast_rate:.3g}/s vs {base_rate:.3g}/s base "
                    f"rate)",
                )
            else:
                report["share_loss"] = ComponentHealth("share_loss", OK)

        # per fan-out card: a child ring holding requests without
        # completing any is a wedged card; the others keep mining.
        for label in sorted(snap["chips"]):
            chip = snap["chips"][label]
            name = f"chip:{label}"
            age = self._age(name, chip["dispatches"], now)
            if chip["inflight"] > 0 and age >= stall:
                report[name] = ComponentHealth(
                    name, STALLED,
                    f"{chip['inflight']:.0f} requests assigned, none "
                    f"completed in {age:.0f}s",
                )
            else:
                report[name] = ComponentHealth(name, OK)

        self.last_report = report
        return report

    # ---------------------------------------------------------- publish
    @staticmethod
    def worst(report: Dict[str, ComponentHealth]) -> str:
        return max(
            (c.state for c in report.values()),
            key=_LEVEL.__getitem__, default=OK,
        )

    def healthz(
        self, report: Optional[Dict[str, ComponentHealth]] = None
    ) -> Tuple[int, Dict[str, Any]]:
        """(http_status, payload) for ``/healthz``: 503 iff a component is
        stalled, every non-ok reason in the body. With a watchdog driving
        it answers from its cache (at most one period old); without one
        it evaluates live."""
        if report is None:
            report = (
                self.last_report if (self.driven and self.last_report)
                else self.evaluate()
            )
        status = self.worst(report)
        payload = {
            "status": status,
            "components": {
                c.component: (
                    {"state": c.state, "reason": c.reason} if c.reason
                    else {"state": c.state}
                )
                for c in report.values()
            },
            "reasons": [
                f"{c.component}: {c.reason or c.state}"
                for c in report.values() if c.state != OK
            ],
        }
        return (503 if status == STALLED else 200), payload

    def publish(
        self, report: Optional[Dict[str, ComponentHealth]] = None
    ) -> Dict[str, ComponentHealth]:
        """Evaluate (unless given a report) and export the
        ``tpu_miner_health{component}`` gauges, plus one flight-recorder
        event per state transition."""
        if report is None:
            report = self.evaluate()
        tel = self.telemetry
        for c in report.values():
            tel.health.labels(component=c.component).set(_LEVEL[c.state])
            prev = self._published.get(c.component)
            if prev != c.state:
                self._published[c.component] = c.state
                tel.flightrec.record(
                    "health", component=c.component,
                    state=c.state, previous=prev or "unknown",
                    reason=c.reason,
                )
        return report

    def summary(
        self, report: Optional[Dict[str, ComponentHealth]] = None
    ) -> str:
        """The reporter line's fragment: ``ok``, or the non-ok components
        with their states, from the cached report only (never evaluated on
        the event loop); ``pending`` before the first evaluation."""
        if report is None:
            report = self.last_report
        if not report:
            return "pending"
        bad = [c for c in report.values() if c.state != OK]
        if not bad:
            return "ok"
        return ",".join(f"{c.component}={c.state}" for c in bad)


class HealthWatchdog:
    """Drives a :class:`HealthModel` from its own daemon thread, so a
    wedged event loop is still diagnosed: the gauges, the flight recorder
    and ``/healthz``'s cached report stay current."""

    def __init__(self, model: HealthModel, interval: float = 5.0) -> None:
        self.model = model
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HealthWatchdog":
        if self._thread is None:
            self.model.driven = True
            self._thread = threading.Thread(
                target=self._run, name="health-watchdog", daemon=True
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        # Publish at once, then every interval: the first tick creates the
        # health gauges' children, which a scrape right after start reads.
        while True:
            try:
                self.model.publish()
            except Exception:  # noqa: BLE001 — the watchdog outlives bugs
                logger.exception("health watchdog evaluation failed")
            if self._stop.wait(self.interval):
                return

    def stop(self) -> None:
        self._stop.set()
        self.model.driven = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
