"""Share-lifecycle ledger: one causal record per share.

Counterpart of ``bitcoin_miner_tpu/telemetry/lifecycle.py``. A bounded
LRU of per-share records keyed by the share's work identity
(:func:`share_key`), each stamped with the trace id in force when it was
born, holding its hops::

    hit (job, generation, scheduler sizing) → submit (verdict, rtt)

fed by the dispatcher's verify gate and the runners' ``_record_submit``,
the one point every pool verdict passes. A record whose last hop is not
terminal past ``loss_deadline_s`` is a lost share: found and verified
but never answered. The health watchdog sweeps for these
(:meth:`scan_losses`), counts ``tpu_miner_share_lost_total`` and leaves
each in the flight recorder.

The ledger also keeps sampled exemplars of the latency histograms
(``submit_rtt``, ``dispatch_gap``): (value, trace id, share key), to go
from a histogram tail to the record and trace behind it. Served at
``/lifecycle`` (schema ``tpu-miner-lifecycle/1``). Keys strip a
``p<slot>/`` job-id namespace, as the reference's do.
``NullShareLifecycleLedger`` compiles it out under
``TPU_MINER_TELEMETRY=0``.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Deque, Dict, List, Optional

SCHEMA = "tpu-miner-lifecycle/1"

#: hop names that end a share's life (no further hop is owed). A later
#: hop may re-open the record (``upstream_forward`` after an accepted
#: ``frontend_validate`` — the share's life continues upstream).
TERMINAL_HOPS = frozenset({
    "submit", "frontend_validate", "upstream_ack", "upstream_drop",
})


def share_key(job_id: str, extranonce2: bytes, nonce: int) -> str:
    """A share's ledger identity. The fabric namespaces job ids
    (``p<slot>/<id>``) between the dispatcher (which mines the
    namespaced job) and the slot (which submits the original id) —
    stripping the namespace here is what makes the hit-side and
    verdict-side hops land on one record."""
    jid = job_id.rpartition("/")[2] if "/" in job_id else job_id
    return f"{jid}|{extranonce2.hex()}|{nonce & 0xFFFFFFFF:08x}"


class ShareLifecycleLedger:
    """Bounded, thread-safe per-share causal records + exemplars."""

    enabled = True

    def __init__(
        self,
        capacity: int = 256,
        loss_deadline_s: float = 60.0,
        exemplars_per_metric: int = 8,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        #: seconds a record may sit with a non-terminal last hop before
        #: the sweep declares the share lost.
        self.loss_deadline_s = loss_deadline_s
        self._clock = clock
        self._lock = threading.Lock()
        #: key → record dict (LRU: touched records move to the end).
        self._records: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self.dropped = 0
        self.lost_total = 0
        #: recent jobs (bounded): job_id → announce info, folded into
        #: records at creation so each share carries its job-broadcast
        #: anchor without a per-share broadcast hop.
        self._jobs: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._jobs_cap = 16
        #: metric name → bounded deque of exemplar dicts.
        self._exemplars: Dict[str, Deque[Dict[str, Any]]] = {}
        self._exemplars_cap = exemplars_per_metric
        #: hops one record may hold — a client looping duplicate
        #: submits on one share identity must not grow its record (and
        #: every /lifecycle payload + incident bundle) without bound.
        self._hops_cap = 32

    # ------------------------------------------------------------ feed
    def note_job(self, job_id: str, **fields: Any) -> None:
        """One job announcement (dispatcher ``set_job`` / frontend
        broadcast) — the broadcast anchor later records fold in."""
        with self._lock:
            self._jobs[job_id] = {
                "t": self._clock(), "ts": time.time(), **fields,
            }
            self._jobs.move_to_end(job_id)
            while len(self._jobs) > self._jobs_cap:
                self._jobs.popitem(last=False)

    def found(
        self, key: str, *, job_id: str, nonce: int,
        trace: Optional[str] = None, **fields: Any,
    ) -> None:
        """Open a record for a verified hit (the dispatcher's oracle
        gate), with the job-broadcast anchor folded in. (The reference
        also names the fleet child that scanned the nonce; that comes
        with the fleet supervisor.)"""
        hop: Dict[str, Any] = {"job_id": job_id, **fields}
        with self._lock:
            job = self._jobs.get(job_id)
            if job is not None:
                hop["job_age_s"] = round(self._clock() - job["t"], 6)
        self.hop(key, "hit", trace=trace, **hop)

    def hop(
        self, key: str, hop: str, *, trace: Optional[str] = None,
        terminal: Optional[bool] = None, **fields: Any,
    ) -> None:
        """Append one hop to ``key``'s record (creating it if absent —
        a downstream client's share starts life at its submit hop).
        ``terminal`` overrides the :data:`TERMINAL_HOPS` default: a
        forward hop re-opens a record the validate hop had closed."""
        done = terminal if terminal is not None else hop in TERMINAL_HOPS
        now = self._clock()
        entry = {"hop": hop, "t": round(now, 6),
                 "ts": round(time.time(), 6), **fields}
        with self._lock:
            record = self._records.get(key)
            if record is None:
                record = {
                    "key": key, "born_t": round(now, 6),
                    "born_ts": round(time.time(), 6),
                    "trace": trace, "hops": [], "done": False,
                    "lost": False,
                }
                self._records[key] = record
                while len(self._records) > self.capacity:
                    self._records.popitem(last=False)
                    self.dropped += 1
            elif trace and not record.get("trace"):
                record["trace"] = trace
            if len(record["hops"]) < self._hops_cap:
                record["hops"].append(entry)
            else:
                # State still advances (done/last_t below) — only the
                # per-hop detail is shed past the cap.
                record["hops_dropped"] = record.get("hops_dropped", 0) + 1
            record["done"] = done
            record["last_t"] = entry["t"]
            if not done:
                record["lost"] = False
            self._records.move_to_end(key)

    def exemplar(
        self, metric: str, value: float, *,
        trace: Optional[str] = None, key: Optional[str] = None,
        **fields: Any,
    ) -> None:
        """One sampled exemplar for a histogram series: enough identity
        (trace id, share key) to jump from a latency tail to the exact
        record/trace that produced it."""
        entry: Dict[str, Any] = {
            "value": round(float(value), 9), "ts": round(time.time(), 6),
        }
        if trace:
            entry["trace"] = trace
        if key:
            entry["key"] = key
        if fields:
            entry.update(fields)
        with self._lock:
            bucket = self._exemplars.get(metric)
            if bucket is None:
                bucket = deque(maxlen=self._exemplars_cap)
                self._exemplars[metric] = bucket
            bucket.append(entry)

    # ------------------------------------------------------------ scan
    def scan_losses(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Records whose last hop is non-terminal and older than the
        deadline: the share was found (or accepted downstream) and then
        nothing ever answered. Each is returned ONCE (marked ``lost``)
        so the caller can alarm without re-alarming every sweep."""
        now = self._clock() if now is None else now
        lost: List[Dict[str, Any]] = []
        with self._lock:
            for record in self._records.values():
                if record["done"] or record["lost"]:
                    continue
                last = record.get("last_t", record["born_t"])
                if now - last >= self.loss_deadline_s:
                    record["lost"] = True
                    lost.append(dict(record, hops=list(record["hops"])))
            self.lost_total += len(lost)
        return lost

    # ------------------------------------------------------------ read
    def dump_dict(self) -> Dict[str, Any]:
        """The ``/lifecycle`` payload / incident-bundle snapshot."""
        with self._lock:
            records = [
                dict(r, hops=list(r["hops"]))
                for r in self._records.values()
            ]
            exemplars = {m: list(d) for m, d in self._exemplars.items()}
            return {
                "schema": SCHEMA,
                "dumped_at": round(time.time(), 6),
                "capacity": self.capacity,
                "loss_deadline_s": self.loss_deadline_s,
                "dropped": self.dropped,
                "lost_total": self.lost_total,
                "records": records,
                "exemplars": exemplars,
            }

class NullShareLifecycleLedger(ShareLifecycleLedger):
    """Compiled-out ledger (``NullTelemetry``): every feed path is a
    no-op; reads return an empty-but-valid document."""

    enabled = False

    def __init__(self) -> None:
        super().__init__(capacity=1)

    def note_job(self, job_id: str, **fields: Any) -> None:
        pass

    def found(self, key: str, **fields: Any) -> None:  # type: ignore[override]
        pass

    def hop(self, key: str, hop: str, **fields: Any) -> None:  # type: ignore[override]
        pass

    def exemplar(self, metric: str, value: float, **fields: Any) -> None:  # type: ignore[override]
        pass
