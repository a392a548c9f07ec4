"""Streaming pipeline probe: does the pipeline keep the card busy across
dispatch boundaries?

Counterpart of the reference's ``benchmarks/pipeline_probe.py``. The
blocking path serializes ``scan -> verify/submit -> scan``: the card idles
for the whole host leg between dispatches. The streaming path (a pump
thread drives ``scan_stream`` while the caller verifies) runs the host leg
while the next dispatch runs, so the gap between one scan's end and the
next one's start collapses toward zero.

The probe times every dispatch through a wrapper hasher and drives the
same requests both ways:

  blocking : scan batch k, then the verify leg, then scan batch k+1
  streaming: a pump thread scans batches while the caller runs the
             verify leg on each result as it arrives

Per mode it reports wall time, scan time, the busy fraction (scan time
over wall) and the gap statistics, through the telemetry histograms under
the metric names the live miner exports; the two modes' hit sets must be
equal. ``probe_adaptive`` drives the adaptive scheduler the same way,
through a simulated job switch.

The bench (``python -m bitcoin_miner_tpu_torch.bench``) runs :func:`probe`
on the measured hasher for its ``pipeline`` block.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional

from ..backends.base import ScanRequest, dispatch_granularity, iter_scan_stream
from ..telemetry import (
    GAP_BUCKETS,
    METRIC_DEVICE_BUSY,
    METRIC_DISPATCH_GAP,
    METRIC_SCAN_BATCH,
    MetricRegistry,
    get_telemetry,
)


class TimingHasher:
    """Wraps a hasher, recording the (start, end) wall time of every
    ``scan``.

    It has no ``scan_stream``, so ``iter_scan_stream`` drives it through
    the sequential adapter and every dispatch runs through the timed
    ``scan``: the probe sees each dispatch boundary even where the
    backend's own ring would hide it. With tracing armed, each timed scan
    is also a ``device_dispatch`` span."""

    def __init__(self, inner) -> None:
        self._inner = inner
        self.name = getattr(inner, "name", "?")
        self.spans: List[tuple] = []

    def scan(self, header76, nonce_start, count, target, max_hits=64):
        t0_ns = time.perf_counter_ns()
        res = self._inner.scan(header76, nonce_start, count, target, max_hits)
        end_ns = time.perf_counter_ns()
        self.spans.append((t0_ns / 1e9, end_ns / 1e9))
        tel = get_telemetry()
        if tel.tracer.enabled:
            tel.tracer.complete(
                "device_dispatch", t0_ns, end_ns, cat="device",
                nonce_start=nonce_start, count=count,
            )
        return res


def _gap_stats(spans: List[tuple], registry: Optional[MetricRegistry] = None,
               ) -> dict:
    """Gap and busy statistics of one mode's dispatch spans, through the
    telemetry histogram and gauge types under the metric names and
    buckets the live miner exports on ``/metrics``. Means and maxima are
    the histograms' exact sums and maxima; percentiles are bucket
    estimates, as ``histogram_quantile`` over the live series gives them.

    ``registry`` is get-or-create: passing one registry to two calls
    accumulates both span sets into one family. By default each call has
    a registry of its own."""
    reg = registry if registry is not None else MetricRegistry()
    gap_h = reg.histogram(
        METRIC_DISPATCH_GAP, "Device idle time between dispatches (s)",
        buckets=GAP_BUCKETS,
    )
    batch_h = reg.histogram(
        METRIC_SCAN_BATCH, "One device scan batch, wall seconds",
        buckets=GAP_BUCKETS,
    )
    busy_g = reg.gauge(
        METRIC_DEVICE_BUSY,
        "Fraction of wall time with >= 1 dispatch in flight",
    )
    for start, end in spans:
        batch_h.observe(end - start)
    for (_a0, a1), (b0, _b1) in zip(spans, spans[1:]):
        gap_h.observe(b0 - a1)
    wall = spans[-1][1] - spans[0][0] if spans else 0.0
    busy_g.set(batch_h.sum / wall if wall else 0.0)
    return {
        "batches": batch_h.count,
        "batch_ms_mean": round(1e3 * batch_h.mean, 3),
        "scan_s_total": round(batch_h.sum, 4),
        "gap_ms_mean": round(1e3 * gap_h.mean, 3),
        "gap_ms_max": round(1e3 * gap_h.max, 3),
        "gap_ms_p50": round(1e3 * gap_h.quantile(0.5), 3),
        "gap_ms_p95": round(1e3 * gap_h.quantile(0.95), 3),
        "gap_ms_p99": round(1e3 * gap_h.quantile(0.99), 3),
        "busy_fraction": round(busy_g.value, 4),
    }


def _pump(timing: TimingHasher, requests, on_result=None):
    """Yield the stream's results from a pump thread, as the dispatcher's
    pump does: the caller's work on one result overlaps the next scan."""
    results: "queue.SimpleQueue" = queue.SimpleQueue()
    end = object()

    def pump() -> None:
        try:
            for sres in iter_scan_stream(timing, requests):
                if on_result is not None:
                    on_result(sres)
                results.put(sres)
        finally:
            results.put(end)

    thread = threading.Thread(target=pump, name="probe-pump", daemon=True)
    thread.start()
    while True:
        sres = results.get()
        if sres is end:
            break
        yield sres
    thread.join()


def measure_pipeline(
    hasher,
    requests: List[ScanRequest],
    consume: Optional[Callable] = None,
    mode: str = "stream",
) -> dict:
    """Run ``requests`` through ``hasher`` in the given mode, applying
    ``consume(result)`` (the verify/submit stand-in) to each result.
    Returns the gap and busy statistics and the hit sets (for parity)."""
    timing = TimingHasher(hasher)
    hits: List[tuple] = []
    t_start = time.perf_counter()
    if mode == "blocking":
        stream = (next(iter_scan_stream(timing, iter([req])))
                  for req in requests)
    else:
        stream = _pump(timing, iter(requests))
    for sres in stream:
        if consume is not None:
            consume(sres.result)
        hits.append((sres.request.nonce_start, tuple(sres.result.nonces)))
    wall = time.perf_counter() - t_start
    out = _gap_stats(timing.spans)
    out["wall_s"] = round(wall, 4)
    out["hits"] = hits
    return out


def probe(
    hasher,
    header76: bytes,
    target: int,
    batches: int = 8,
    batch_size: int = 1 << 14,
    verify_seconds: Optional[float] = None,
    nonce_start: int = 0,
) -> dict:
    """Blocking against streaming on one hasher; returns the JSON payload.
    ``verify_seconds`` is the simulated host leg per batch (verify and
    submit); by default half a measured batch's scan time, enough that
    serializing it stalls the card visibly and that a full pipeline hides
    it."""
    requests = [
        ScanRequest(
            header76=header76,
            nonce_start=(nonce_start + i * batch_size) & 0xFFFFFFFF,
            count=batch_size,
            target=target,
        )
        for i in range(batches)
    ]
    if verify_seconds is None:
        t0 = time.perf_counter()
        hasher.scan(header76, nonce_start, batch_size, target)
        verify_seconds = (time.perf_counter() - t0) / 2

    def consume(_result) -> None:
        # A sleep, not a spin: the real host leg is mostly the pool's
        # round trip (an await that yields the CPU), and a spin holding
        # the interpreter lock would measure contention with the pump.
        time.sleep(verify_seconds)

    blocking = measure_pipeline(hasher, requests, consume, mode="blocking")
    streaming = measure_pipeline(hasher, requests, consume, mode="stream")
    if blocking.pop("hits") != streaming.pop("hits"):
        raise AssertionError(
            "streaming hit sets diverge from blocking scan — parity broken"
        )
    return {
        "metric": "pipeline_probe",
        "backend": getattr(hasher, "name", "?"),
        "verify_ms": round(1e3 * verify_seconds, 3),
        "blocking": blocking,
        "streaming": streaming,
        # The bar: with the pipeline on, the gap must undercut both the
        # serialized gap and one batch's scan time.
        "overlap": (
            streaming["gap_ms_mean"] < blocking["gap_ms_mean"]
            and streaming["gap_ms_mean"] < streaming["batch_ms_mean"]
        ),
    }


def probe_adaptive(
    hasher,
    header76: bytes,
    target: int,
    nonce_budget: int = 1 << 13,
    min_bits: int = 5,
    max_bits: int = 10,
    stale_latency_s: Optional[float] = None,
    steady_latency_s: Optional[float] = None,
    verify_seconds: float = 0.0,
    switch_fraction: float = 0.6,
    nonce_start: int = 0,
) -> dict:
    """Drive the adaptive scheduler (``miner/scheduler.py``) through the
    streaming path and measure what it does: the busy fraction and gaps
    with sizes chosen online, the growth from the stale bound toward the
    amortization bound, and a simulated job switch after
    ``switch_fraction`` of the budget, whose first dispatch must be
    smaller and faster than a steady one.

    The latency bounds default to calibrated values: one ``2^min_bits``
    scan sets the cost per nonce, the stale bound sits one bit above the
    floor and the amortization bound at ``max_bits``, so the same
    schedule runs on the hashlib oracle and on the card. The bit span is
    lifted onto the hasher's dispatch grid where that is coarser."""
    from ..miner.scheduler import AdaptiveBatchScheduler

    granularity = dispatch_granularity(hasher)
    if granularity > 1:
        gbits = (granularity - 1).bit_length()
        if gbits > min_bits:
            min_bits = gbits
        if max_bits < min_bits + 3:
            max_bits = min(30, min_bits + 3)
    if stale_latency_s is None or steady_latency_s is None:
        t0 = time.perf_counter()
        hasher.scan(header76, nonce_start, 1 << min_bits, target)
        per_nonce = (time.perf_counter() - t0) / (1 << min_bits)
        if stale_latency_s is None:
            stale_latency_s = per_nonce * (1 << (min_bits + 1))
        if steady_latency_s is None:
            steady_latency_s = per_nonce * (1 << max_bits)
    sched = AdaptiveBatchScheduler(
        min_bits=min_bits, max_bits=max_bits,
        granularity=granularity,
        stale_latency_s=stale_latency_s,
        steady_latency_s=steady_latency_s,
    )
    timing = TimingHasher(hasher)
    counts: List[int] = []
    switch_at = int(nonce_budget * switch_fraction)
    switch_index: List[Optional[int]] = [None]

    def requests():
        off = 0
        while off < nonce_budget:
            if switch_index[0] is None and off >= switch_at:
                # The simulated mining.notify: the scheduler shrinks to
                # the stale bound.
                sched.on_job_switch()
                switch_index[0] = len(counts)
                get_telemetry().flightrec.record(
                    "job_switch", simulated=True, at_dispatch=len(counts),
                )
            n = min(sched.next_count(), nonce_budget - off)
            counts.append(n)
            yield ScanRequest(
                header76=header76,
                nonce_start=(nonce_start + off) & 0xFFFFFFFF,
                count=n, target=target,
            )
            off += n

    for _sres in _pump(timing, requests(),
                       lambda sres: sched.record_result(sres.request.count)):
        if verify_seconds:
            time.sleep(verify_seconds)

    out = _gap_stats(timing.spans)
    durations = [1e3 * (end - start) for start, end in timing.spans]
    si = switch_index[0]
    # A switch at index 0 has no steady state before it: ``pre`` is empty.
    pre = counts if si is None else counts[:si]
    out.update({
        "scheduler": "adaptive",
        "batch_nonces_min": min(counts) if counts else 0,
        "batch_nonces_max": max(counts) if counts else 0,
        "steady_batch_nonces": max(pre) if pre else 0,
        "steady_batch_ms": round(max(durations[:si]), 3)
        if si is not None and si > 0 else None,
        "switch_batch_nonces": counts[si]
        if si is not None and si < len(counts) else None,
        "first_dispatch_ms_after_switch": round(durations[si], 3)
        if si is not None and si < len(durations) else None,
    })
    # Adapted: it grew past its floor at steady state, and cut the first
    # dispatch after the switch below a steady one.
    out["adapted"] = bool(
        out["steady_batch_nonces"] > (1 << min_bits)
        and out["switch_batch_nonces"] is not None
        and out["switch_batch_nonces"] < out["steady_batch_nonces"]
        and out["first_dispatch_ms_after_switch"] is not None
        and out["first_dispatch_ms_after_switch"] < out["steady_batch_ms"]
    )
    return out
