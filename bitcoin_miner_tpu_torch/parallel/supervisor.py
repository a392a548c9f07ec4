"""The fleet supervisor: the loss of a card or a worker is a degradation,
not an outage.

Counterpart of ``bitcoin_miner_tpu/parallel/supervisor.py``. The fan-out
(``parallel/fanout.py``) fails fast: one dead child ends every sibling's
stream and the dispatcher restarts the session. :class:`FleetSupervisor`
wraps N child ``Hasher``s (one ``CudaHasher`` per card, or ``GrpcHasher``
workers, ``--worker`` repeated) behind the same seam, with:

- **a health machine per child** (``tpu_miner_fleet_child_state{child}``)::

      active ◀──────▶ degraded (slow against the fleet, or on probation
        ▲               │       after a rejoin)
        │ probation     │ pump error / hang / unavailable past deadline
        │ clears        ▼
      probing ◀── quarantined ── jittered cooldown (utils/backoff.py:
      (one half-open      ▲      the fleet must not probe a shared
       probe request)─fails┘      outage in lockstep)

- **reclaim of work in flight**: each request a dead or hung child held
  goes whole to a survivor, in the same generation (the request travels
  intact, tag included, so stale-work dropping still works), and results
  come back in request order. No nonce is lost (the range is scanned
  again) and none is duplicated (a late result of a superseded pump is
  dropped);

- **capacity-weighted assignment**: stride scheduling by each child's
  weight; a degraded child's share shrinks (``DEGRADED_FACTOR``, and its
  measured rate against the fastest sibling's) instead of being skipped;

- **hot rejoin**: a quarantined child whose cooldown has passed gets one
  half-open probe request; success readmits it on probation (degraded),
  the session's version mask is sent to it before any request, and
  ``STREAM_FLUSH`` reaches every live pump, the rejoined one included.

Only when every child is quarantined does ``scan_stream`` raise, a
:class:`~.fanout.MultiChildError` with each child's last error and label;
the dispatcher's session restart takes over, and the health model's
``fleet`` component reads the state gauges (any child off active degrades
it, all quarantined stall it).

:func:`make_cuda_fleet` (``--backend cuda-fleet``) builds one hit-buffer
``CudaHasher`` per card, each built and driven under
``torch.cuda.device(dev)``; :func:`make_grpc_fleet` one ``GrpcHasher`` per
``--worker``; :func:`make_cuda_mesh_fleet` groups of ``MeshCudaHasher``.
"""

from __future__ import annotations

import contextlib
import inspect
import logging
import queue as thread_queue
import threading
import time
from collections import deque
from functools import partial
from typing import (
    Any,
    Callable,
    ContextManager,
    Deque,
    Dict,
    Iterable,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
)

import torch

from ..backends.base import (
    Hasher,
    STREAM_FLUSH,
    ScanRequest,
    ScanResult,
    StreamResult,
    iter_scan_stream,
)
from ..telemetry import TelemetryBound
from ..telemetry.pipeline import FLEET_CHILD_LEVELS
from ..utils.backoff import DecorrelatedJitterBackoff
from .fanout import MultiChildError

logger = logging.getLogger(__name__)

ACTIVE = "active"
DEGRADED = "degraded"
PROBING = "probing"
QUARANTINED = "quarantined"


class ChildState:
    """One child's supervision state. It outlives stream sessions (a child
    quarantined in one session stays so in the next, its cooldown intact);
    the pumps, queues and epochs of a session live in
    :class:`_StreamSession`."""

    def __init__(
        self,
        index: int,
        label: str,
        backoff: DecorrelatedJitterBackoff,
        clock: Callable[[], float],
        configured_weight: float = 1.0,
    ) -> None:
        self.index = index
        self.label = label
        self.state = ACTIVE
        self._clock = clock
        self.state_since = clock()
        #: the quarantine cooldowns; reset by a successful probe.
        self.backoff = backoff
        #: when a quarantined child may probe (monotonic seconds).
        self.rejoin_at: Optional[float] = None
        #: the last error, for the aggregate error and the events.
        self.last_error: Optional[str] = None
        #: clean results since the rejoin (probation).
        self.clean_results = 0
        #: recent completion latencies (s): the slow-against-the-fleet
        #: rule, and the weight's speed signal until :attr:`work` fills.
        self.latencies: Deque[float] = deque(maxlen=16)
        #: recent (completion time, nonces) pairs: the measured rate the
        #: weight prefers (latency mixes speed with request size).
        self.work: Deque[Tuple[float, int]] = deque(maxlen=16)
        #: the operator's capacity prior; multiplies the measured factor.
        self.configured_weight = configured_weight
        #: stride scheduling's pass (the least pass takes the next request).
        self._pass = 0.0
        self.quarantines = 0
        self.reclaimed_from = 0

    @property
    def assignable(self) -> bool:
        """May receive regular (non-probe) requests."""
        return self.state in (ACTIVE, DEGRADED)

    def mean_latency(self) -> Optional[float]:
        if len(self.latencies) < 4:
            return None
        return sum(self.latencies) / len(self.latencies)

    def nonce_rate(self) -> Optional[float]:
        """Nonces per second over the work window, once it holds 4
        completions over real time; the first entry anchors the window and
        its nonces are left out."""
        if len(self.work) < 4:
            return None
        span = self.work[-1][0] - self.work[0][0]
        if span <= 0:
            return None
        return sum(n for _, n in list(self.work)[1:]) / span

    def probe_due(self, now: float) -> bool:
        return (self.state == QUARANTINED and self.rejoin_at is not None
                and now >= self.rejoin_at)


class FleetSupervisor(TelemetryBound, Hasher):
    """N child hashers behind one ``Hasher`` seam, with quarantine, reclaim,
    capacity-weighted assignment and hot rejoin. Children are any hashers
    (the tests drive CPU hashers under ``testing/chaos_hasher.py``);
    ``contexts`` are per-child context-manager factories entered around
    every call to the child (``torch.cuda.device(dev)``)."""

    name = "fleet"
    scan_releases_gil = True

    #: weight factor of a degraded child: its share shrinks, but it keeps
    #: one (it may be the last child, and a slow card still mines).
    DEGRADED_FACTOR = 0.25
    #: clean results a rejoined child needs to leave probation.
    PROBATION_RESULTS = 8
    #: a child whose mean completion latency exceeds this many times the
    #: median of its siblings' is degraded as slow.
    DEGRADE_LATENCY_FACTOR = 4.0

    def __init__(
        self,
        children: Sequence[Hasher],
        contexts: Optional[
            Sequence[Optional[Callable[[], ContextManager[Any]]]]] = None,
        *,
        stall_after_s: float = 10.0,
        quarantine_base_s: float = 0.5,
        quarantine_cap_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        telemetry: Optional[Any] = None,
        weights: Optional[Sequence[float]] = None,
    ) -> None:
        if not children:
            raise ValueError("fleet supervisor needs at least one child")
        if weights is not None and len(weights) != len(children):
            raise ValueError("weights must match children 1:1")
        if weights is not None and any(w <= 0 for w in weights):
            raise ValueError("configured weights must be positive")
        if telemetry is not None:
            # Before the first publish below: a test's bundle owns the
            # gauges from construction on.
            self.telemetry = telemetry
        self.children: List[Hasher] = list(children)
        self._contexts = (list(contexts) if contexts is not None
                          else [None] * len(self.children))
        if len(self._contexts) != len(self.children):
            raise ValueError("contexts must match children 1:1")
        self.n_children = len(self.children)
        #: seconds a child may hold requests without completing any before
        #: it is declared hung and its work reclaimed.
        self.stall_after_s = stall_after_s
        self._clock = clock
        # A repeated label gets a /<index> suffix: two children on one
        # gauge child would overwrite each other's state.
        seen: Dict[str, int] = {}
        self.chip_labels: List[str] = []
        for i, child in enumerate(self.children):
            label = str(getattr(child, "chip_label", None) or i)
            if label in seen:
                label = f"{label}/{i}"
            seen[label] = i
            self.chip_labels.append(label)
        self.states: List[ChildState] = [
            ChildState(
                i, self.chip_labels[i],
                DecorrelatedJitterBackoff(quarantine_base_s,
                                          quarantine_cap_s),
                clock,
                configured_weight=(float(weights[i]) if weights is not None
                                   else 1.0))
            for i in range(self.n_children)
        ]
        #: the session's version mask, sent again to a rejoining child.
        self._mask: Optional[int] = None
        self._reserved = 0
        #: requests reclaimed, in all.
        self.reclaims = 0
        #: ``GrpcHasher`` children grow their depth and grid with the
        #: handshake; the fleet's are recomputed from the children, and
        #: the dispatcher must re-read them as for one such child.
        self.negotiates_stream_depth = any(
            getattr(c, "negotiates_stream_depth", False)
            for c in self.children)
        for st in self.states:
            self._publish(st)

    @property
    def stream_depth(self) -> int:
        """The fan-out's window arithmetic (a child ring yields its first
        result once child_depth + 1 requests reach it), recomputed live:
        a ``GrpcHasher`` child's depth grows with its handshake."""
        child_depth = max(int(getattr(c, "stream_depth", 0) or 0)
                          for c in self.children)
        return self.n_children * (child_depth + 1) - 1

    @property
    def dispatch_size(self) -> int:
        """One child's dispatch grid (the scheduler's granularity),
        recomputed live. Raises AttributeError for children without one
        (CPU oracles), so that ``getattr(..., default)`` falls through."""
        best = max(int(getattr(c, "dispatch_size", None)
                       or getattr(c, "batch_size", 0) or 0)
                   for c in self.children)
        if not best:
            raise AttributeError("dispatch_size")
        return best

    # -------------------------------------------------------------- FSM
    def _publish(self, st: ChildState) -> None:
        self.telemetry.fleet_child_state.labels(child=st.label).set(
            FLEET_CHILD_LEVELS[st.state])

    def _set_state(self, st: ChildState, state: str, reason: str) -> None:
        if state == st.state:
            return
        old, st.state = st.state, state
        st.state_since = self._clock()
        self._publish(st)
        self.telemetry.flightrec.record(
            "fleet_child", child=st.label, state=state, previous=old,
            reason=reason)
        log = logger.warning if state == QUARANTINED else logger.info
        log("fleet child %s: %s -> %s (%s)", st.label, old, state, reason)

    def _quarantine(self, st: ChildState, reason: str,
                    error: Optional[BaseException]) -> None:
        if error is not None:
            st.last_error = f"{type(error).__name__}: {error}"[:200]
        st.quarantines += 1
        st.clean_results = 0
        st.latencies.clear()
        # A rejoined child earns its measured rate again.
        st.work.clear()
        cooldown = st.backoff.next()
        st.rejoin_at = self._clock() + cooldown
        self._set_state(
            st, QUARANTINED,
            f"{reason}: {st.last_error or 'no error captured'} "
            f"(half-open probe in {cooldown:.1f}s)")

    def _note_result(self, st: ChildState, latency_s: float,
                     nonces: int = 0) -> None:
        st.latencies.append(latency_s)
        st.work.append((self._clock(), max(0, nonces)))
        if st.state == PROBING:
            # The probe answered: back on probation.
            st.backoff.reset()
            st.rejoin_at = None
            st.clean_results = 0
            self._set_state(st, DEGRADED, "probe succeeded — probation")
            # Rejoin at the live set's stride position: a pass frozen low
            # during the quarantine would win every pick.
            self._sync_pass(st)
            self.telemetry.flightrec.record("fleet_rejoin", child=st.label)
            return
        if st.state == DEGRADED:
            st.clean_results += 1
            if (st.clean_results >= self.PROBATION_RESULTS
                    and not self._is_slow(st)):
                self._set_state(st, ACTIVE, "probation cleared")
        elif st.state == ACTIVE and self._is_slow(st):
            self._set_state(
                st, DEGRADED,
                f"mean completion {st.mean_latency():.3f}s vs fleet — "
                "share shrunk")

    def _is_slow(self, st: ChildState) -> bool:
        """This child's mean latency exceeds ``DEGRADE_LATENCY_FACTOR``
        times the median of its siblings' means (its own left out), with
        4 samples on both sides."""
        own = st.mean_latency()
        if own is None:
            return False
        others = sorted(m for s in self.states
                        if s is not st and (m := s.mean_latency()) is not None)
        if not others:
            return False
        median = others[len(others) // 2]
        return median > 0 and own > self.DEGRADE_LATENCY_FACTOR * median

    # ---------------------------------------------------------- weights
    def weight_of(self, st: ChildState) -> float:
        """Capacity weight: the configured prior × the state's factor × the
        measured speed against the fastest assignable sibling (the nonce
        rate where measured, else the latency). A quarantined child gets
        nothing: its way back is the probe."""
        if not st.assignable:
            return 0.0
        w = st.configured_weight * (1.0 if st.state == ACTIVE
                                    else self.DEGRADED_FACTOR)
        own_rate = st.nonce_rate()
        if own_rate is not None:
            best = max((r for s in self.states if s.assignable
                        and (r := s.nonce_rate()) is not None), default=None)
            if best and best > 0:
                w *= max(0.1, min(1.0, own_rate / best))
            return w
        own = st.mean_latency()
        if own and own > 0:
            fastest = min((m for s in self.states if s.assignable
                           and (m := s.mean_latency()) is not None),
                          default=None)
            if fastest and fastest > 0:
                w *= max(0.1, min(1.0, fastest / own))
        return w

    def _pick(self) -> Optional[ChildState]:
        """The next assignment, stride-scheduled over the assignable
        children by their weights."""
        live = [s for s in self.states if s.assignable]
        if not live:
            return None
        weighted = [(s, self.weight_of(s)) for s in live]
        usable = ([(s, w) for s, w in weighted if w > 0]
                  or [(s, 1.0) for s in live])
        st, weight = min(usable, key=lambda sw: (sw[0]._pass, sw[0].index))
        st._pass += 1.0 / weight
        return st

    def _sync_pass(self, st: ChildState) -> None:
        live_passes = [s._pass for s in self.states
                       if s.assignable and s is not st]
        if live_passes:
            st._pass = max(st._pass, min(live_passes))

    # ------------------------------------------------------------- cold
    def _ctx(self, i: int) -> ContextManager[Any]:
        cm = self._contexts[i]
        return cm() if cm is not None else contextlib.nullcontext()

    def _first_live(self) -> ChildState:
        for st in self.states:
            if st.assignable:
                return st
        raise MultiChildError(self._all_errors())

    def _all_errors(self) -> List[Tuple[str, BaseException]]:
        return [(st.label, RuntimeError(
                    st.last_error or f"child {st.label} quarantined"))
                for st in self.states]

    def sha256d(self, data: bytes) -> bytes:
        while True:
            st = self._first_live()
            try:
                with self._ctx(st.index):
                    return self.children[st.index].sha256d(data)
            except Exception as e:  # noqa: BLE001 — quarantine, fail over
                self._quarantine(st, "error", e)

    def set_version_mask(self, mask: int) -> int:
        """Keep the session mask and send it to every child not
        quarantined; a quarantined child gets it on rejoin, before its
        first request."""
        self._mask = mask
        reserved = self._reserved
        for st in self.states:
            if st.state == QUARANTINED:
                continue
            setter = getattr(self.children[st.index], "set_version_mask",
                             None)
            if setter is None:
                continue
            try:
                with self._ctx(st.index):
                    reserved = setter(mask)
            except Exception as e:  # noqa: BLE001 — quarantine, not abort
                self._quarantine(st, "error", e)
        self._reserved = reserved
        return reserved

    @property
    def version_roll_bits(self) -> int:
        return int(getattr(self.children[0], "version_roll_bits", 0))

    # ------------------------------------------------------------- scan
    def scan(
        self,
        header76: bytes,
        nonce_start: int,
        count: int,
        target: int,
        max_hits: int = 64,
    ) -> ScanResult:
        """A blocking scan with failover: the whole range goes to one live
        child, and if it fails the child is quarantined and the same range
        goes to a survivor (never a partial merge). With every child
        quarantined the call waits for the earliest cooldown and probes;
        each child is probed at most once a call, so a dead fleet raises
        :class:`MultiChildError` instead of retrying forever."""
        self._check_range(header76, nonce_start, count)
        probed: set = set()
        while True:
            st = self._probe_candidate(probed)
            probing = st is not None
            if st is not None:
                probed.add(st.index)
                self._set_state(st, PROBING, "half-open probe")
                self._apply_cached_mask(st)
            else:
                st = self._pick()
            if st is None:
                raise MultiChildError(self._all_errors())
            t0 = self._clock()
            try:
                with self._ctx(st.index):
                    result = self.children[st.index].scan(
                        header76, nonce_start, count, target, max_hits)
            except Exception as e:  # noqa: BLE001 — quarantine, reclaim
                reason = "probe_failed" if probing else "error"
                self._quarantine(st, reason, e)
                self._count_reclaims(reason, 1)
                continue
            self._note_result(st, self._clock() - t0, nonces=count)
            # A hit of this range can now name the child that scanned it.
            self.telemetry.lifecycle.note_dispatch(
                nonce_start=nonce_start, count=count, child=st.label)
            return result

    def _probe_candidate(self, probed: set) -> Optional[ChildState]:
        """A quarantined child due for its one probe this call, or, when no
        child is live, the earliest one, after waiting out its cooldown.
        None: no probe now."""
        now = self._clock()
        for st in self.states:
            if st.index not in probed and st.probe_due(now):
                return st
        if any(s.assignable for s in self.states):
            return None
        waitable = [s for s in self.states
                    if s.index not in probed and s.state == QUARANTINED
                    and s.rejoin_at is not None]
        if not waitable:
            return None
        st = min(waitable, key=lambda s: s.rejoin_at or 0.0)
        delay = max(0.0, (st.rejoin_at or 0.0) - now)
        if delay:
            time.sleep(delay)
        return st

    def _apply_cached_mask(self, st: ChildState) -> None:
        """Send the session mask to a rejoining child; a failure shows on
        the probe itself."""
        if self._mask is None:
            return
        setter = getattr(self.children[st.index], "set_version_mask", None)
        if setter is None:
            return
        try:
            with self._ctx(st.index):
                setter(self._mask)
        except Exception:  # noqa: BLE001 — the probe scan will report
            logger.debug("mask re-broadcast to %s failed", st.label,
                         exc_info=True)

    def _count_reclaims(self, reason: str, n: int) -> None:
        self.reclaims += n
        if n:
            self.telemetry.fleet_reclaims.labels(reason=reason).inc(n)

    # -------------------------------------------------------- streaming
    def scan_stream(self, requests: Iterable) -> Iterator[StreamResult]:
        return _StreamSession(self).run(requests)

    def close(self) -> None:
        for child in self.children:
            child.close()

    def scrape_targets(self) -> List[Tuple[str, str]]:
        """(child label, ``/metrics`` URL) of every child that declared
        a status port (``--worker HOST:PORT@STATUSPORT``): the discovery
        source the observatory's scrape federator polls. Local children
        have no status port; their metrics are in this process's
        registry already."""
        out: List[Tuple[str, str]] = []
        for i, child in enumerate(self.children):
            port = getattr(child, "status_port", None)
            if not port:
                continue
            label = self.chip_labels[i]
            host = label.rsplit(":", 1)[0] or "127.0.0.1"
            out.append((label, f"http://{host}:{port}/metrics"))
        return out

    def snapshot(self) -> Dict[str, Any]:
        """Each child's state and counters (status, debugging)."""
        return {
            "reclaims": self.reclaims,
            "children": [
                {
                    "label": st.label,
                    "state": st.state,
                    "weight": self.weight_of(st),
                    "quarantines": st.quarantines,
                    "reclaimed_from": st.reclaimed_from,
                    "last_error": st.last_error,
                    "mean_latency_s": st.mean_latency(),
                }
                for st in self.states
            ],
        }


class _StreamSession:
    """The engine of one ``scan_stream`` call: a pump thread per child,
    the reorder buffer, reclaim, hang detection and the probe path, apart
    from the supervisor's state that outlives the session."""

    #: seconds between event waits: the hang detector's resolution.
    TICK_S = 0.05

    def __init__(self, sup: FleetSupervisor) -> None:
        self.sup = sup
        #: every pump's events: ("res"|"err"|"end", child, epoch, payload).
        self.ev_q: "thread_queue.SimpleQueue" = thread_queue.SimpleQueue()
        #: each child's pump epoch: events of a superseded pump (a
        #: quarantined child's late result) are dropped, which keeps the
        #: reclaim free of duplicates.
        self.epoch = [0] * sup.n_children
        self.req_q: List[Optional[thread_queue.SimpleQueue]] = (
            [None] * sup.n_children)
        #: each child's assigned sequence numbers, in order (a child
        #: answers in request order).
        self.assigned: List[Deque[int]] = [
            deque() for _ in range(sup.n_children)]
        #: when each child's oldest assignment started waiting: latency
        #: and the hang detector.
        self.busy_since: List[Optional[float]] = [None] * sup.n_children
        #: seq → request of everything not completed: what reclaim reads.
        self.pending: Dict[int, ScanRequest] = {}
        self.completed: Dict[int, StreamResult] = {}
        self.next_seq = 0
        self.next_yield = 0
        self.source_ended = False
        #: a flush or end drain is waiting for ``pending`` to empty: an
        #: assignment landing now missed the broadcast flush and must
        #: carry its own, or it would sit in a ring child until the hang
        #: detector misfired.
        self.draining = False

    # ------------------------------------------------------------ pumps
    def _start_pump(self, i: int) -> None:
        sup = self.sup
        self.epoch[i] += 1
        epoch = self.epoch[i]
        q: "thread_queue.SimpleQueue" = thread_queue.SimpleQueue()
        self.req_q[i] = q
        self.busy_since[i] = None
        child = sup.children[i]
        mask = sup._mask
        # The trace id is thread-local: the pump re-enters the caller's.
        inherited_trace = sup.telemetry.tracer.current_trace()

        def feed() -> Iterator[Any]:
            while True:
                req = q.get()
                if req is None:
                    return
                yield req

        def pump() -> None:
            try:
                with sup.telemetry.tracer.context(inherited_trace), \
                        sup._ctx(i):
                    # A restarted worker or card scans under the session
                    # mask from its first request.
                    if mask is not None:
                        setter = getattr(child, "set_version_mask", None)
                        if setter is not None:
                            setter(mask)
                    for sres in iter_scan_stream(child, feed()):
                        self.ev_q.put(("res", i, epoch, sres))
            except BaseException as e:  # noqa: BLE001 — supervised
                self.ev_q.put(("err", i, epoch, e))
            self.ev_q.put(("end", i, epoch, None))

        threading.Thread(target=pump,
                         name=f"fleet-pump-{sup.chip_labels[i]}",
                         daemon=True).start()

    def _stop_pump(self, i: int) -> None:
        q = self.req_q[i]
        if q is not None:
            q.put(None)
        self.req_q[i] = None

    # ------------------------------------------------------- assignment
    def _assign(self, seq: int) -> int:
        """Request ``seq`` to a child: a quarantined child due for its
        probe takes it as the probe, else the stride pick. With no child
        left the fleet is dead: raise the aggregate. Returns the child's
        index."""
        sup = self.sup
        now = sup._clock()
        st: Optional[ChildState] = None
        for cand in sup.states:
            if cand.probe_due(now):
                sup._set_state(cand, PROBING, "half-open probe")
                self._start_pump(cand.index)
                st = cand
                break
        if st is None:
            st = sup._pick()
        if st is None:
            raise MultiChildError(sup._all_errors())
        i = st.index
        if self.req_q[i] is None:
            self._start_pump(i)
        self.assigned[i].append(seq)
        if self.busy_since[i] is None:
            self.busy_since[i] = now
        q = self.req_q[i]
        assert q is not None
        q.put(self.pending[seq])
        if st.state == PROBING or self.source_ended or self.draining:
            # The probe is one request (a ring child would hold it until
            # depth + 1 arrive), and an assignment during a drain missed
            # the broadcast flush: either way the ring must give it back.
            q.put(STREAM_FLUSH)
        return i

    def _reclaim(self, i: int, reason: str) -> None:
        """Everything child ``i`` held, assigned but unanswered, to the
        survivors, in sequence order."""
        sup = self.sup
        seqs = list(self.assigned[i])
        self.assigned[i].clear()
        self.busy_since[i] = None
        self._stop_pump(i)
        if not seqs:
            return
        sup.states[i].reclaimed_from += len(seqs)
        sup._count_reclaims(reason, len(seqs))
        sup.telemetry.flightrec.record(
            "fleet_reclaim", child=sup.chip_labels[i], reason=reason,
            requests=len(seqs),
            nonce_starts=[self.pending[s].nonce_start for s in seqs[:8]])
        takers = {self._assign(seq) for seq in seqs}
        # The reclaimed requests are the oldest outstanding, so the
        # reorder buffer waits on them: a ring child that took them below
        # its emit threshold would hold them, while no newer request
        # comes, until the hang detector took it for hung. Flush them out.
        for j in takers:
            q = self.req_q[j]
            if q is not None:
                q.put(STREAM_FLUSH)

    def _fail_child(self, i: int, reason: str,
                    error: Optional[BaseException]) -> None:
        sup = self.sup
        st = sup.states[i]
        if st.state == PROBING:
            # The probe itself failed: back to quarantine, longer cooldown.
            reason = "probe_failed"
        sup._quarantine(st, reason, error)
        self._reclaim(i, reason)

    # ------------------------------------------------------- collection
    def _handle_event(self, ev: Tuple[str, int, int, Any]) -> None:
        kind, i, epoch, payload = ev
        if epoch != self.epoch[i]:
            return  # a superseded pump's late event
        sup = self.sup
        if kind == "res":
            if not self.assigned[i]:
                return  # nothing owed
            seq = self.assigned[i].popleft()
            now = sup._clock()
            started = self.busy_since[i]
            self.busy_since[i] = now if self.assigned[i] else None
            self.pending.pop(seq, None)
            self.completed[seq] = payload
            request = getattr(payload, "request", None)
            sup._note_result(
                sup.states[i],
                max(0.0, now - started) if started is not None else 0.0,
                nonces=int(getattr(request, "count", 0) or 0))
            # Noted before the result is yielded, so the dispatcher's
            # verify gate finds the child when it opens a hit's record;
            # the tag's job id tells overlapping ranges of two jobs apart.
            if request is not None:
                sup.telemetry.lifecycle.note_dispatch(
                    nonce_start=request.nonce_start, count=request.count,
                    child=sup.chip_labels[i],
                    job_id=getattr(getattr(getattr(request, "tag", None),
                                           "job", None), "job_id", None))
        elif kind == "err":
            self._fail_child(i, "error", payload)
        elif self.assigned[i]:  # "end" with requests owed
            self._fail_child(i, "error",
                             RuntimeError("child ended its stream early"))
        else:
            self._stop_pump(i)

    def _check_hangs(self) -> None:
        """A child holding requests without completing any for
        ``stall_after_s`` is hung: quarantine it and reclaim. Its pump is
        abandoned (a daemon), and its late result dropped by the epoch."""
        sup = self.sup
        now = sup._clock()
        for i, since in enumerate(self.busy_since):
            if since is None or not self.assigned[i]:
                continue
            if sup.states[i].state == QUARANTINED:
                continue
            if now - since >= sup.stall_after_s:
                self._fail_child(i, "hang", TimeoutError(
                    f"no completion in {now - since:.1f}s with "
                    f"{len(self.assigned[i])} requests assigned"))

    def _collect_until(self, predicate: Callable[[], bool]) -> None:
        while not predicate():
            try:
                ev = self.ev_q.get(timeout=self.TICK_S)
            except thread_queue.Empty:
                self._check_hangs()
                continue
            self._handle_event(ev)

    def _pop_ready(self) -> Iterator[StreamResult]:
        while self.next_yield in self.completed:
            yield self.completed.pop(self.next_yield)
            self.next_yield += 1

    # -------------------------------------------------------------- run
    def run(self, requests: Iterable) -> Iterator[StreamResult]:
        sup = self.sup
        # A child left probing by a session that died mid-probe has no
        # pump: back to quarantine.
        for st in sup.states:
            if st.state == PROBING:
                sup._set_state(st, QUARANTINED, "session restart")
        try:
            for req in requests:
                if req is STREAM_FLUSH:
                    self._broadcast_flush()
                    self.draining = True
                    try:
                        self._collect_until(lambda: not self.pending)
                    finally:
                        self.draining = False
                    yield from self._pop_ready()
                    continue
                seq = self.next_seq
                self.next_seq += 1
                self.pending[seq] = req
                self._assign(seq)
                yield from self._pop_ready()
                while self.next_seq - self.next_yield > sup.stream_depth:
                    # Weighted assignment can leave a low-share child's
                    # ring below its emit threshold while it holds the
                    # next result: flush it before waiting.
                    self._nudge_owner(self.next_yield)
                    self._collect_until(
                        lambda: self.next_yield in self.completed)
                    yield from self._pop_ready()
            self.source_ended = True
            # Drain by flush, not end of stream: the queues stay open for
            # reclaimed requests.
            self._broadcast_flush()
            self.draining = True
            self._collect_until(lambda: not self.pending)
            yield from self._pop_ready()
        finally:
            for i in range(sup.n_children):
                self._stop_pump(i)

    def _broadcast_flush(self) -> None:
        for q in self.req_q:
            if q is not None:
                q.put(STREAM_FLUSH)

    def _nudge_owner(self, seq: int) -> None:
        """Flush the child holding ``seq`` if it holds fewer requests than
        its ring needs to emit (depth + 1)."""
        for i, fifo in enumerate(self.assigned):
            if seq not in fifo:
                continue
            cap = int(getattr(self.sup.children[i], "stream_depth", 0)
                      or 0) + 1
            if len(fifo) < cap:
                q = self.req_q[i]
                if q is not None:
                    q.put(STREAM_FLUSH)
            return


# --------------------------------------------------------------- factories
def make_grpc_fleet(
    targets: Sequence[str],
    *,
    max_unavailable_s: float = 10.0,
    stall_after_s: float = 30.0,
    **kwargs: Any,
) -> FleetSupervisor:
    """A supervised fleet of served workers, one ``GrpcHasher`` per
    ``--worker HOST:PORT[@STATUSPORT]``; the suffix names the worker's
    ``--status-port``, which :meth:`FleetSupervisor.scrape_targets` hands
    the observatory's federator (the channel sees HOST:PORT only). Each
    child gets ``max_unavailable_s``, so a worker unavailable past it is
    quarantined (and later probed) instead of retried forever. The
    transport deadline is shorter than the hang
    bound: a dead connection is cheap to detect, and each second holds
    back the dead child's requests, while a connected but wedged worker
    deserves patience."""
    from ..rpc.hasher_service import GrpcHasher

    if not targets:
        raise ValueError("make_grpc_fleet needs at least one target")
    parsed: List[Tuple[str, int]] = []
    for spec in targets:
        target, _, status = spec.partition("@")
        try:
            parsed.append((target, int(status) if status else 0))
        except ValueError:
            raise ValueError(
                f"bad --worker target {spec!r}: status port {status!r} is "
                "not an integer (want HOST:PORT[@STATUSPORT])") from None
    children: List[Hasher] = []
    for target, status_port in parsed:
        child = GrpcHasher(target)
        child.max_unavailable_s = max_unavailable_s
        child.chip_label = target  # type: ignore[attr-defined]
        if status_port:
            child.status_port = status_port  # type: ignore[attr-defined]
        children.append(child)
    fleet = FleetSupervisor(children, stall_after_s=stall_after_s, **kwargs)
    fleet.name = "grpc-fleet"
    logger.info("grpc fleet: %d supervised workers (%s)", len(children),
                ", ".join(targets))
    return fleet


def make_cuda_fleet(
    n_devices: Optional[int] = None,
    batch_per_device: int = 1 << 24,
    inner_size: int = 1 << 18,
    max_hits: int = 64,
    unroll: int = 64,
    spec: bool = True,
    vshare: int = 1,
    devices: Optional[Sequence] = None,
    **kwargs: Any,
) -> FleetSupervisor:
    """The supervised per-card fleet (``cuda-fleet``): one hit-buffer
    ``CudaHasher`` per card, built and driven under
    ``torch.cuda.device(dev)`` as the fan-out's children are, so one dead
    card is quarantined instead of ending the session. ``devices`` is an
    explicit device list, else the first ``n_devices`` cards; ``kwargs``
    go to :class:`FleetSupervisor`. The children are hit-buffer hashers
    only, as the JAX package's per-chip fleet is XLA only (the fan-out
    runs the tile kernel per card)."""
    from ..backends.cuda import CudaHasher
    from .mesh import make_mesh

    children: List[Hasher] = []
    contexts: List[Optional[Callable[[], ContextManager[Any]]]] = []
    for i, dev in enumerate(make_mesh(n_devices, devices)):
        context = (partial(torch.cuda.device, dev) if dev.type == "cuda"
                   else None)
        with context() if context is not None else contextlib.nullcontext():
            child = CudaHasher(batch_size=batch_per_device,
                               inner_size=inner_size, max_hits=max_hits,
                               vshare=vshare, device=dev, unroll=unroll,
                               spec=spec)
        child.chip_label = str(i)
        children.append(child)
        contexts.append(context)
    fleet = FleetSupervisor(children, contexts, **kwargs)
    fleet.name = "cuda-fleet"
    logger.info("cuda-fleet: %d supervised per-device dispatch rings "
                "(batch_per_device=%d)", len(children), batch_per_device)
    return fleet


def make_cuda_mesh_fleet(
    n_devices: Optional[int] = None,
    groups: int = 1,
    kernel: str = "cuda",
    devices: Optional[Sequence] = None,
    **kw: Any,
) -> FleetSupervisor:
    """The supervisor above the mesh: ``groups`` mesh-native hashers over
    disjoint contiguous slices of the devices, each one sharded dispatch
    ring, under the fleet supervisor. A child that fails is quarantined
    whole and its ranges reclaimed, while each mesh child also degrades
    inside itself (``quarantine_device``, a fan-out over its survivors).
    A helper, not a registered backend: ``cuda-mesh-native`` is one mesh
    over every card; this composes several fault domains. ``kw`` are the
    supervisor's options and the children's geometry."""
    from .mesh import make_mesh
    from .meshring import MeshCudaHasher

    chosen = list(make_mesh(n_devices, devices))
    if groups < 1:
        raise ValueError(f"groups must be >= 1, got {groups}")
    if len(chosen) % groups:
        raise ValueError(f"{len(chosen)} devices do not split into {groups} "
                         "equal mesh groups")
    per = len(chosen) // groups
    sup_kw = kw_supervisor_only(kw)
    hasher_kw = {k: v for k, v in kw.items() if k not in sup_kw}
    children: List[Hasher] = []
    for g in range(groups):
        child = MeshCudaHasher(kernel=kernel,
                               devices=chosen[g * per:(g + 1) * per],
                               **hasher_kw)
        child.chip_label = f"mesh{g}"
        children.append(child)
    fleet = FleetSupervisor(children, **sup_kw)
    fleet.name = "cuda-mesh-fleet"
    logger.info("cuda-mesh-fleet: %d supervised mesh groups x %d devices",
                groups, per)
    return fleet


def kw_supervisor_only(kw: Dict[str, Any]) -> Dict[str, Any]:
    """The options of ``kw`` that :class:`FleetSupervisor` takes."""
    allowed = set(inspect.signature(FleetSupervisor.__init__).parameters
                  ) - {"self", "children", "contexts"}
    return {k: v for k, v in kw.items() if k in allowed}
