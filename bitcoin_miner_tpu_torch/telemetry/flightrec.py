"""Flight recorder: the pipeline's black box.

Counterpart of ``bitcoin_miner_tpu/telemetry/flightrec.py``. A bounded
ring of structured events — job switches, scheduler resizes, reconnects,
stale drops, share verdicts, chip errors, health transitions — fed by
the layers that emit metrics. Metrics say how much; the recorder says
what happened in what order.

The ring is dumped as JSON:

- on demand (``/flightrec`` on the status server, or :meth:`dump`);
- on ``SIGUSR2``, from outside a live or wedged process;
- on crash: an uncaught exception on any thread (``sys.excepthook`` and
  ``threading.excepthook`` chains installed by :meth:`arm`).

Dump schema (``tpu-miner-flightrec/1``)::

    {"schema": "tpu-miner-flightrec/1",
     "dumped_at": <unix seconds>,
     "reason": "signal" | "crash" | "request",
     "dropped": <events lost to the ring bound>,
     "events": [{"ts": <unix s>, "mono": <monotonic s>, "kind": str,
                 "thread": str, ...event fields}, ...]}

``record`` copies its keyword fields verbatim, so every value must be
JSON-serializable. Recording is a lock and a deque append.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

SCHEMA = "tpu-miner-flightrec/1"


class FlightRecorder:
    """Bounded, thread-safe structured-event ring."""

    def __init__(self, capacity: int = 2048) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._events: "deque[Dict[str, Any]]" = deque(maxlen=capacity)
        self._recorded = 0
        #: path crash/signal dumps go to; set by :meth:`arm`.
        self._dump_path: Optional[str] = None
        self._armed = False
        self._crash_dumped = False
        self._prev_excepthook = None
        self._prev_threading_excepthook = None
        self._prev_signal_handler = None

    # ----------------------------------------------------------- record
    def record(self, kind: str, **fields: Any) -> None:
        """Append one event. ``kind`` names the event class (job_switch,
        sched_resize, reconnect, stale_drop, rpc_error, share, health,
        ...); keyword fields ride along verbatim."""
        event = dict(fields)
        event["kind"] = kind
        event["ts"] = round(time.time(), 6)
        event["mono"] = round(time.monotonic(), 6)
        event["thread"] = threading.current_thread().name
        with self._lock:
            self._events.append(event)
            self._recorded += 1

    # ------------------------------------------------------------- read
    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    @property
    def dropped(self) -> int:
        """Events pushed out of the ring by the capacity bound."""
        with self._lock:
            return max(0, self._recorded - len(self._events))

    def dump_dict(self, reason: str = "request") -> dict:
        with self._lock:
            events = list(self._events)
            dropped = max(0, self._recorded - len(events))
        return {
            "schema": SCHEMA,
            "dumped_at": round(time.time(), 6),
            "reason": reason,
            "dropped": dropped,
            "events": events,
        }

    def dump(self, path: str, reason: str = "request") -> str:
        """Write the ring as JSON; atomic rename so a crash mid-write
        never leaves truncated JSON where a post-mortem expects it."""
        from .tracing import atomic_json_dump

        return atomic_json_dump(self.dump_dict(reason=reason), path)

    # ------------------------------------------------------------ hooks
    def arm(self, path: str, *, signals: bool = True) -> None:
        """Install the black-box dump hooks: ``SIGUSR2`` → dump to
        ``path``; an uncaught exception on any thread → record a
        ``crash`` event and dump. Idempotent per recorder; safe to call
        from non-main threads (the signal handler is then skipped —
        CPython only allows signal installation from the main thread)."""
        self._dump_path = path
        if self._armed:
            return
        self._armed = True
        if signals:
            try:
                import signal as _signal

                if hasattr(_signal, "SIGUSR2"):
                    self._prev_signal_handler = _signal.signal(
                        _signal.SIGUSR2, self._on_signal)
            except (ValueError, OSError):  # non-main thread / platform
                pass
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._on_crash
        self._prev_threading_excepthook = threading.excepthook
        threading.excepthook = self._on_thread_crash
        import atexit

        atexit.register(self._on_exit)

    def disarm(self) -> None:
        """Undo :meth:`arm`'s interpreter-global hooks: the excepthooks
        and the ``SIGUSR2`` handler it replaced (tests, and a process that
        runs several sessions in turn)."""
        if not self._armed:
            return
        self._armed = False
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
        if self._prev_threading_excepthook is not None:
            threading.excepthook = self._prev_threading_excepthook
        import atexit

        atexit.unregister(self._on_exit)
        if self._prev_signal_handler is not None:
            import signal as _signal

            try:
                _signal.signal(_signal.SIGUSR2, self._prev_signal_handler)
            except (ValueError, OSError):  # non-main thread
                pass
            self._prev_signal_handler = None

    def _safe_dump(self, reason: str) -> None:
        if self._dump_path is None:
            return
        try:
            self.dump(self._dump_path, reason=reason)
        except OSError:  # the black box must never take the plane down
            pass

    def _on_signal(self, signum, frame) -> None:  # pragma: no cover — SIGUSR2
        # Dump from a helper thread, never inline: a CPython signal
        # handler runs between bytecodes ON the main thread, and both
        # record() and dump() take the recorder's non-reentrant lock —
        # a SIGUSR2 landing while the main thread is inside record()
        # would deadlock the whole process it was sent to inspect.
        threading.Thread(
            target=self._signal_dump, args=(int(signum),),
            name="flightrec-dump", daemon=True,
        ).start()

    def _signal_dump(self, signum: int) -> None:
        self.record("signal_dump", signum=signum)
        self._safe_dump("signal")

    def _on_crash(self, exc_type, exc, tb) -> None:
        self.record(
            "crash", exc_type=getattr(exc_type, "__name__", str(exc_type)),
            message=str(exc)[:500],
        )
        self._crash_dumped = True
        self._safe_dump("crash")
        if self._prev_excepthook is not None:
            self._prev_excepthook(exc_type, exc, tb)

    def _on_thread_crash(self, args) -> None:
        # SystemExit on a worker thread is a normal shutdown, not a crash.
        if args.exc_type is not SystemExit:
            self.record(
                "crash",
                exc_type=getattr(args.exc_type, "__name__",
                                 str(args.exc_type)),
                message=str(args.exc_value)[:500],
                thread_name=getattr(args.thread, "name", "?"),
            )
            self._crash_dumped = True
            self._safe_dump("crash")
        if self._prev_threading_excepthook is not None:
            self._prev_threading_excepthook(args)

    def _on_exit(self) -> None:
        # Belt and braces: a crash that somehow skipped the excepthook
        # dump (hook chain replaced later, dump raced shutdown) still
        # leaves a black box behind; clean exits write nothing.
        if self._crash_dumped:
            self._safe_dump("crash")


class NullFlightRecorder(FlightRecorder):
    """Compiled-out recorder (``NullTelemetry``): records nothing, dumps
    an empty-but-valid document, installs no hooks."""

    def __init__(self) -> None:
        super().__init__(capacity=1)

    def record(self, kind: str, **fields: Any) -> None:
        pass

    def arm(self, path: str, *, signals: bool = True) -> None:
        pass
