"""Adaptive dispatch sizing, and the streaming sweep the bench runs.

Right after a job switch dispatches must be small: every nonce in flight
when the next job lands is wasted. At steady state they should be large,
so per-dispatch host cost is amortized. The scheduler sizes each request
from the measured inter-dispatch gap and throughput: it shrinks to the
``stale_latency_s`` bound on a job switch or a stall and grows
geometrically toward the ``steady_latency_s`` bound. Device backends split
any request into their compiled dispatch size, so a resize never changes
what is launched. Each decision sets the ``adaptive_batch_nonces`` gauge;
each shrink counts ``sched_resizes{reason}`` and leaves a flight-recorder
event.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from ..backends.base import ScanRequest, dispatch_granularity, iter_scan_stream
from ..telemetry import TelemetryBound


class AdaptiveBatchScheduler(TelemetryBound):
    """Gap-driven per-dispatch nonce-range sizing. Sizes are powers of two
    between ``min_bits`` and ``max_bits``, rounded to a multiple of
    ``granularity`` (a device backend's dispatch size). Thread-safe: one
    lock covers all state."""

    def __init__(
        self,
        min_bits: int = 14,
        max_bits: int = 30,
        granularity: int = 1,
        stale_latency_s: float = 0.05,
        steady_latency_s: float = 1.0,
        gap_fraction: float = 0.02,
        growth_bits: float = 1.0,
        stall_gap_s: float = 1.0,
        telemetry: Optional[Any] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if not (0 < min_bits <= max_bits <= 32):
            raise ValueError(
                f"need 0 < min_bits <= max_bits <= 32, got "
                f"{min_bits}/{max_bits}"
            )
        if granularity < 1:
            raise ValueError("granularity must be >= 1")
        self.min_bits = min_bits
        self.max_bits = max_bits
        self.granularity = granularity
        self.stale_latency_s = stale_latency_s
        self.steady_latency_s = steady_latency_s
        #: a gap larger than this fraction of one dispatch's estimated
        #: time means per-dispatch overhead is not amortized: grow faster.
        self.gap_fraction = gap_fraction
        self.growth_bits = growth_bits
        self.stall_gap_s = stall_gap_s
        self._clock = clock
        self._lock = threading.Lock()
        self._bits = float(min_bits)
        #: (completion time, nonce count) of recent dispatches: the
        #: throughput estimate's window.
        self._completions: "deque" = deque(maxlen=32)
        self._gap_ewma: Optional[float] = None
        if telemetry is not None:
            self.telemetry = telemetry

    def record_gap(self, gap_s: float) -> None:
        """One inter-dispatch gap from the dispatcher's busy clock."""
        with self._lock:
            self._gap_ewma = (
                gap_s if self._gap_ewma is None
                else 0.7 * self._gap_ewma + 0.3 * gap_s
            )
            if gap_s >= self.stall_gap_s:
                # The source starved: work resuming after a stall is the
                # work most likely to be superseded moments later.
                self._shrink_locked("stall")

    def record_result(self, count: int, now: Optional[float] = None) -> None:
        """One completed dispatch of ``count`` nonces."""
        if count <= 0:
            return
        with self._lock:
            self._completions.append(
                (self._clock() if now is None else now, count)
            )

    def on_job_switch(self) -> None:
        """A new job superseded the old one: shrink to the stale bound."""
        with self._lock:
            self._shrink_locked("job_switch")

    def next_count(self) -> int:
        """The nonce count the next dispatch should carry."""
        with self._lock:
            upper = self._clamp_bits(
                self._bits_for_time(self.steady_latency_s)
            )
            step = self.growth_bits
            rate = self._rate_locked()
            if self._gap_ewma is not None and rate:
                est_batch_s = (2.0 ** self._bits) / rate
                if self._gap_ewma > self.gap_fraction * est_batch_s:
                    step = self.growth_bits * 2
            if self._bits < upper:
                self._bits = min(self._bits + step, upper)
            elif self._bits > upper:
                self._bits = max(self._bits - step, upper)
            count = self._quantize_locked()
            tel = self.telemetry
            if tel.enabled:
                tel.batch_nonces.set(count)
            return count

    def set_granularity(self, granularity: int) -> None:
        """Move the quantization grid after construction: a ``GrpcHasher``
        learns the served worker's dispatch size only from the ScanStream
        handshake, after the scheduler was built, and a request below that
        grid would compute the whole remote dispatch but count only its
        own nonces."""
        if granularity < 1:
            raise ValueError("granularity must be >= 1")
        with self._lock:
            self.granularity = granularity

    def _rate_locked(self) -> Optional[float]:
        """Estimated nonces/s over the completion window; None until two
        completions exist."""
        if len(self._completions) < 2:
            return None
        t0, _ = self._completions[0]
        t1, _ = self._completions[-1]
        if t1 <= t0:
            return None
        # The first entry's count was hashed before the window opened.
        total = sum(c for _, c in list(self._completions)[1:])
        return total / (t1 - t0)

    def _bits_for_time(self, seconds: float) -> float:
        rate = self._rate_locked()
        if rate is None or rate <= 0:
            return float(self.min_bits)
        return math.log2(max(1.0, rate * seconds))

    def _clamp_bits(self, bits: float) -> float:
        return max(float(self.min_bits), min(bits, float(self.max_bits)))

    def _shrink_locked(self, reason: str) -> None:
        target = self._clamp_bits(self._bits_for_time(self.stale_latency_s))
        if target < self._bits:
            self._bits = target
            tel = self.telemetry
            if tel.enabled:
                tel.sched_resizes.labels(reason=reason).inc()
            tel.flightrec.record(
                "sched_resize", reason=reason, bits=round(target, 2),
            )

    def _quantize_locked(self) -> int:
        # A granularity above the bound wins: the device cannot dispatch
        # less than its grid.
        count = 1 << int(round(self._clamp_bits(self._bits)))
        if self.granularity > 1:
            count = max(self.granularity,
                        (count // self.granularity) * self.granularity)
        return count


def scheduler_for(hasher: Any, **overrides: Any) -> AdaptiveBatchScheduler:
    """A scheduler whose granularity is ``hasher``'s dispatch size."""
    kwargs: Dict[str, Any] = dict(granularity=dispatch_granularity(hasher))
    kwargs.update(overrides)
    return AdaptiveBatchScheduler(**kwargs)


@dataclass
class SweepReport:
    """Outcome of one :func:`stream_sweep`: the header's own hits, the
    sibling chains' hits as (version, nonce) pairs, the hashes computed
    (nonces × chains), the requests made and the least and most nonces a
    request held."""

    nonces: List[int]
    hashes_done: int
    dispatches: int
    version_hits: List[Tuple[int, int]]
    min_count: int = 0
    max_count: int = 0


def stream_sweep(
    hasher: Any,
    header76: bytes,
    nonce_start: int,
    count: int,
    target: int,
    scheduler: Optional[AdaptiveBatchScheduler] = None,
    batch_size: Optional[int] = None,
    max_hits: int = 64,
) -> SweepReport:
    """Sweep ``[nonce_start, nonce_start + count)`` through the hasher's
    streaming path, so a pipelining backend keeps its ring full across
    the whole range — the bench's inner loop. Request sizes come from
    ``scheduler`` or are fixed at ``batch_size``."""
    if scheduler is None and batch_size is None:
        batch_size = dispatch_granularity(hasher, default=1 << 24)
    dispatches = [0]
    sizes: List[int] = []

    def requests() -> Iterator[ScanRequest]:
        off = 0
        while off < count:
            n = (scheduler.next_count() if scheduler is not None
                 else batch_size)
            n = min(n, count - off)
            dispatches[0] += 1
            sizes.append(n)
            yield ScanRequest(
                header76=header76, nonce_start=nonce_start + off,
                count=n, target=target, max_hits=max_hits,
            )
            off += n

    nonces: List[int] = []
    version_hits: List[Tuple[int, int]] = []
    hashes = 0
    for sres in iter_scan_stream(hasher, requests()):
        if scheduler is not None:
            scheduler.record_result(sres.request.count)
        nonces.extend(sres.result.nonces)
        version_hits.extend(sres.result.version_hits)
        hashes += sres.result.hashes_done
    return SweepReport(
        nonces=sorted(nonces), hashes_done=hashes, dispatches=dispatches[0],
        version_hits=version_hits, min_count=min(sizes, default=0),
        max_count=max(sizes, default=0))
