"""Span tracer → Chrome trace-event JSON (``--trace-out``, ``/trace``).

Counterpart of ``bitcoin_miner_tpu/telemetry/tracing.py``. It records
the share pipeline — job notify → feeder slice → device dispatch → ring
collect → CPU verify → submit → pool ack — as events that open unmodified
in Perfetto, in three shapes:

- ``span(name)``: a context manager emitting one complete event
  (``ph: "X"``) around synchronous work (a CPU verify);
- ``complete(name, start_ns)``: the same event emitted after the fact,
  for work whose start and end are seen in different frames or threads (a
  ring dispatch: enqueued now, collected later);
- ``instant(name)``: a zero-length marker (``ph: "i"``): job notify,
  pool ack.

Every event carries its thread id, so the event loop, the dispatcher's
pump threads and the fan-out's per-card pumps are separate tracks. A
disabled tracer costs one predicate per call. The buffer is bounded; past
the bound new events are dropped and counted (``dropped_events``).

While ``torch.profiler`` records the process (:func:`profile_pipeline`),
:func:`host_range` also opens a ``record_function`` range under a span's
name around the host work of a dispatch, a collect, a feeder slice, a CPU
verify and a submit, so that a reader of the card's trace can say what the
host did between two kernels on the profiler's own clock. Otherwise it is
a shared no-op.

Every tracer owns a process ``trace_id``; each event is stamped with the
id in force on its thread (``args["trace"]``), and a thread adopts
another id for a block with :meth:`Tracer.context` (the fan-out's pump
threads take their caller's). :func:`merge_traces` folds another
process's buffer into this one's timeline, re-anchored on each side's
wall-clock epoch.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional


class _NullSpan:
    """Shared no-op context manager for disabled tracers."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN = _NullSpan()

#: Whether :func:`profile_pipeline` is in force: only then does
#: :func:`host_range` open a profiler range. Process-wide, as the
#: profiler it serves is.
_profiling = False


@contextlib.contextmanager
def profile_pipeline(cuda: bool):
    """``torch.profiler.profile`` of the CPU, and of the card with
    ``cuda``, for the block, with :func:`host_range` opening its ranges.
    Every thread's host work is recorded where the torch build can
    (``profile_all_threads``): the dispatcher's pump threads drive the
    ring. Yields the profiler, whose trace the caller exports."""
    from torch._C._profiler import _ExperimentalConfig  # miner-lint: disable=device-claiming-import -- called only by a bench process that already runs torch
    from torch.profiler import ProfilerActivity, profile  # miner-lint: disable=device-claiming-import -- called only by a bench process that already runs torch

    global _profiling
    try:
        config = _ExperimentalConfig(profile_all_threads=True)
    except TypeError:  # an older build: the calling thread's ranges only
        config = None
    activities = [ProfilerActivity.CPU,
                  *([ProfilerActivity.CUDA] if cuda else [])]
    with profile(activities=activities, experimental_config=config) as prof:
        _profiling = True
        try:
            yield prof
        finally:
            _profiling = False


def host_range(name: str):
    """A context manager over host work named as its span: a
    ``torch.profiler.record_function(name)`` range while
    :func:`profile_pipeline` is in force, else the shared no-op. Work whose
    start and end are seen in different frames calls ``__enter__`` and
    ``__exit__(None, None, None)`` itself."""
    if not _profiling:
        return _NULL_SPAN
    from torch.profiler import record_function  # miner-lint: disable=device-claiming-import -- reached only under profile_pipeline, which loaded torch

    return record_function(name)


def atomic_json_dump(obj: Any, path: str) -> str:
    """Write ``obj`` as JSON via tmp-file + rename, so a crash mid-write
    never leaves truncated JSON where a reader expects a document. The
    ONE implementation behind trace dumps, flight-recorder dumps, and
    the CLI's merged-trace epilogue (pid-suffixed tmp name: two
    processes dumping to one path must not clobber each other's tmp)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(obj, fh)
    os.replace(tmp, path)
    return path


class _Span:
    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[Dict[str, Any]]) -> None:
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self._tracer.complete(
            self._name, self._t0, cat=self._cat, **(self._args or {})
        )


class Tracer:
    """Bounded, thread-safe Chrome trace-event recorder."""

    def __init__(self, enabled: bool = False,
                 max_events: int = 1 << 18) -> None:
        self.enabled = enabled
        self.max_events = max_events
        self.dropped_events = 0
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._seen_tids: set = set()
        #: all timestamps are relative to this epoch (perf_counter_ns is
        #: monotonic but arbitrary; a stable zero keeps traces readable).
        self._epoch_ns = time.perf_counter_ns()
        #: wall-clock moment of the epoch, recorded so a REMOTE trace's
        #: timestamps can be re-anchored onto this tracer's timeline when
        #: the two buffers are merged (see :func:`merge_traces`).
        self._epoch_unix_s = time.time()
        #: this process's trace id — the default identity every event is
        #: stamped with when no inherited context is active on the
        #: emitting thread. One mining session = one trace.
        self.trace_id = uuid.uuid4().hex[:16]
        self._ctx = threading.local()

    # ---------------------------------------------------------- context
    def current_trace(self) -> str:
        """The trace id in force on the calling thread: an inherited
        remote caller's id inside a :meth:`context` block, else this
        tracer's own."""
        return getattr(self._ctx, "trace_id", None) or self.trace_id

    @contextlib.contextmanager
    def context(self, trace_id: Optional[str]):
        """Adopt ``trace_id`` for events emitted by this thread inside
        the block — how a served RPC's spans join the calling client's
        trace. A None/empty id is a no-op (legacy caller sent nothing)."""
        if not trace_id:
            yield self
            return
        prev = getattr(self._ctx, "trace_id", None)
        self._ctx.trace_id = trace_id
        try:
            yield self
        finally:
            self._ctx.trace_id = prev

    # ----------------------------------------------------------- record
    def span(self, name: str, cat: str = "pipeline", **args):
        """Context manager: one complete event around the ``with`` body."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args or None)

    def complete(self, name: str, start_ns: int, end_ns: Optional[int] = None,
                 cat: str = "pipeline", **args) -> None:
        """A complete (``ph: X``) event from explicit timestamps — the
        async-span primitive (start observed in one frame, end in
        another, possibly on different threads)."""
        if not self.enabled:
            return
        if end_ns is None:
            end_ns = time.perf_counter_ns()
        event = {
            "name": name, "cat": cat, "ph": "X",
            "ts": (start_ns - self._epoch_ns) / 1e3,
            "dur": max(0.0, (end_ns - start_ns) / 1e3),
            "pid": os.getpid(), "tid": threading.get_ident(),
        }
        args = dict(args) if args else {}
        args["trace"] = self.current_trace()
        event["args"] = args
        self._append(event)

    def instant(self, name: str, cat: str = "pipeline", **args) -> None:
        if not self.enabled:
            return
        event = {
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": (time.perf_counter_ns() - self._epoch_ns) / 1e3,
            "pid": os.getpid(), "tid": threading.get_ident(),
        }
        args = dict(args) if args else {}
        args["trace"] = self.current_trace()
        event["args"] = args
        self._append(event)

    def _append(self, event: dict) -> None:
        tid = event["tid"]
        with self._lock:
            # Cap FIRST — metadata counts against the bound too, or a
            # full buffer would still grow by one metadata dict per new
            # thread (gRPC sender threads across reconnects) forever.
            if len(self._events) >= self.max_events:
                self.dropped_events += 1
                return
            if tid not in self._seen_tids:
                self._seen_tids.add(tid)
                name = threading.current_thread().name
                self._events.append({
                    "name": "thread_name", "ph": "M", "pid": event["pid"],
                    "tid": tid, "args": {"name": name},
                })
            self._events.append(event)

    # ------------------------------------------------------------- read
    def now_ns(self) -> int:
        """The clock async spans should sample for :meth:`complete`."""
        return time.perf_counter_ns()

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def trace_dict(self) -> dict:
        """The Chrome trace-event JSON object (Perfetto-loadable).
        ``otherData`` carries the trace id and the wall-clock epoch, the
        anchors :func:`merge_traces` needs."""
        with self._lock:
            events = list(self._events)
            dropped = self.dropped_events
        return self._envelope(events, dropped)

    def drain(self) -> dict:
        """:meth:`trace_dict` with an atomic take-and-reset of the buffer:
        what ``CollectTrace`` serves. A long-lived served worker keeps
        recording into its bounded buffer, and each collect hands over the
        spans so far and frees the bound for the next window: no event is
        lost between the copy and the reset, and none is served twice."""
        with self._lock:
            events = self._events
            self._events = []
            self._seen_tids.clear()
            dropped = self.dropped_events
            self.dropped_events = 0
        return self._envelope(events, dropped)

    def _envelope(self, events: List[dict], dropped: int) -> dict:
        other = {
            "trace_id": self.trace_id,
            "epoch_unix_s": self._epoch_unix_s,
            "pid": os.getpid(),
        }
        if dropped:
            other["dropped_events"] = dropped
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": other,
        }

    def dump(self, path: str) -> None:
        """Write the trace; atomic rename so a crash mid-write never
        leaves a truncated file where a trace viewer expects JSON."""
        atomic_json_dump(self.trace_dict(), path)


def merge_traces(base: dict, remote: dict, label: str = "remote-hasher",
                 ) -> dict:
    """Fold ``remote`` (another process's :meth:`Tracer.trace_dict`) into
    ``base``, returning one Perfetto-loadable dict.

    - Remote timestamps are re-anchored via each side's recorded
      wall-clock epoch (``otherData.epoch_unix_s``), so the two
      processes' spans line up on one timeline to within clock skew.
    - Remote events keep their own ``pid`` — Perfetto renders them as a
      separate process group — remapped to a collision-free value when
      the two sides report the same pid (in-process tests, pid reuse).
    - A ``process_name`` metadata row labels the remote lane.

    The remote events are modified as copies; neither input is mutated.
    A remote dict without anchors (legacy server) merges un-shifted."""
    base_other = base.get("otherData", {}) or {}
    remote_other = remote.get("otherData", {}) or {}
    base_events = list(base.get("traceEvents", ()))
    shift_us = 0.0
    if ("epoch_unix_s" in base_other and "epoch_unix_s" in remote_other):
        shift_us = (
            remote_other["epoch_unix_s"] - base_other["epoch_unix_s"]
        ) * 1e6
    local_pids = {e.get("pid") for e in base_events}
    pid_map: Dict[Any, Any] = {}

    def remap(pid):
        if pid not in pid_map:
            pid_map[pid] = (pid + (1 << 20)) if pid in local_pids else pid
        return pid_map[pid]

    merged_events = base_events
    for event in remote.get("traceEvents", ()):
        event = dict(event)
        event["pid"] = remap(event.get("pid"))
        if "ts" in event:
            event["ts"] = event["ts"] + shift_us
        merged_events.append(event)
    for pid in sorted(set(pid_map.values())):
        merged_events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": label},
        })
    other = dict(base_other)
    other["merged"] = list(base_other.get("merged", ())) + [{
        "label": label,
        "trace_id": remote_other.get("trace_id"),
        "events": len(remote.get("traceEvents", ())),
        "shift_us": round(shift_us, 3),
    }]
    return {
        "traceEvents": merged_events,
        "displayTimeUnit": base.get("displayTimeUnit", "ms"),
        "otherData": other,
    }
