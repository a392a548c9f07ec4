"""The ``Hasher`` seam over gRPC: a served worker owns the card, and a
miner elsewhere drives it as its backend.

Counterpart of ``bitcoin_miner_tpu/rpc/hasher_service.py``, on the same
wire: the service name, the methods, the metadata keys and the binary
codec are the reference's byte for byte, so this package's client talks
to the reference's server and the reverse. grpcio carries the calls over
generic method handlers (no protoc code); the messages are fixed binary
records, documented beside each pack/unpack pair.

Service ``tpu_miner.Hasher``: ``Scan``, ``ScanStream``, ``Sha256d``,
``SetVersionMask`` and ``CollectTrace``.

- Every ``Scan``/``ScanStream`` call carries the client tracer's trace id
  in its metadata (``tpu-miner-trace-id``); the server adopts it for the
  spans the call produces (``serve_scan``, and the ring's
  ``device_dispatch``/``ring_collect``, which run on the handler thread).
  ``CollectTrace`` (request empty; response the server tracer's buffer as
  Chrome-trace JSON, UTF-8) drains the server's buffer, which the client
  merges into its ``--trace-out`` file: one timeline across the seam.
- ``ScanStream`` (bidirectional): each request message is one Scan
  request, each response one Scan response, in request order. The server
  sends its backend ring's depth and dispatch grid in the stream's
  initial metadata at handler entry (``tpu-miner-ring-depth``,
  ``tpu-miner-dispatch-size``), so the client's wire window and the
  dispatcher's feeder window never undershoot the served ring. An empty
  request message is a flush: the server's ring drains what it holds, and
  the message has no response of its own. A client facing a server
  without ``ScanStream`` (UNIMPLEMENTED) falls back to unary scans for the
  session.

Scan request (little-endian): u32 nonce_start ‖ u32 count_lo ‖ u32 count_hi
  ‖ u32 max_hits ‖ 32-byte target (LE int) ‖ 76-byte header prefix
  ‖ OPTIONAL u32 mask_present ‖ u32 version_mask.
  The optional tail pins the BIP 310 mask the scan runs under: the server
  applies it to its backend first whenever it differs from what the
  backend holds, so a restarted worker learns the session mask from the
  first scan it serves. Without the tail (an older client) the backend's
  mask is left alone.
Scan response: u64 total_hits ‖ u64 hashes_done ‖ u32 n ‖ n × u32 nonces
  ‖ u64 version_total_hits ‖ u32 m ‖ m × (u32 version ‖ u32 nonce)
  ‖ OPTIONAL u32 reserved_present ‖ u32 reserved_roll_bits.
  The version tail carries a vshare backend's sibling hits (absent from
  an older server: empty); the reserved tail echoes the roll bits in
  force for the scan, so the client's cached mask → reserved mapping
  follows a worker restarted with another ``--vshare`` (absent: None).

A client whose tail-ful request a pre-tail server rejects (its strict
unpack fails, which gRPC reports as UNKNOWN) delivers the mask with
``SetVersionMask`` and scans without the tail, re-probing the tail every
``_TAIL_REPROBE_SCANS`` scans. Sha256d: raw bytes in, 32-byte digest out.
SetVersionMask: u32 mask in, u32 reserved roll bits out (0 where the
backend rolls no versions).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import queue as thread_queue
import struct
import threading
import time
from collections import deque
from concurrent import futures
from typing import Iterable, Iterator, List, Optional, Tuple

import grpc

from ..backends.base import (
    Hasher,
    STREAM_FLUSH,
    ScanRequest,
    ScanResult,
    StreamResult,
    dispatch_granularity,
    iter_scan_stream,
    register_hasher,
)
from ..telemetry import TelemetryBound

logger = logging.getLogger(__name__)

SERVICE = "tpu_miner.Hasher"
_SCAN_REQ = struct.Struct("<IIII32s76s")
_SCAN_REQ_MASK_TAIL = struct.Struct("<II")  # (mask_present, version_mask)
_SCAN_RESP_HEAD = struct.Struct("<QQI")
_SCAN_RESP_VTAIL = struct.Struct("<QI")
_SCAN_RESP_RTAIL = struct.Struct("<II")  # (reserved_present, reserved_bits)

#: The served ring's depth, in the stream's initial metadata. A feeder
#: window smaller than the served ring deadlocks the pipeline: the ring
#: yields its first result only once depth + 1 requests have arrived,
#: while the feeder waits for a result before it sends more.
RING_DEPTH_METADATA_KEY = "tpu-miner-ring-depth"

#: The served backend's dispatch grid (``dispatch_size``/``batch_size``;
#: 0 for a backend without one), which the adaptive scheduler quantizes
#: to: a smaller request still computes the whole remote grid.
DISPATCH_SIZE_METADATA_KEY = "tpu-miner-dispatch-size"

#: The caller's trace id in call metadata; absent from an older client,
#: whose calls the server then stamps with its own id.
TRACE_ID_METADATA_KEY = "tpu-miner-trace-id"


def _metadata_trace_id(context) -> Optional[str]:
    """The caller's trace id from a server context, if it sent one."""
    try:
        for key, value in context.invocation_metadata() or ():
            if key == TRACE_ID_METADATA_KEY:
                return value
    except Exception:  # noqa: BLE001 — tracing is advisory
        pass
    return None


def pack_scan_request(
    header76: bytes,
    nonce_start: int,
    count: int,
    target: int,
    max_hits: int,
    version_mask: Optional[int] = None,
) -> bytes:
    raw = _SCAN_REQ.pack(nonce_start, count & 0xFFFFFFFF, count >> 32,
                         max_hits, target.to_bytes(32, "little"), header76)
    if version_mask is not None:
        raw += _SCAN_REQ_MASK_TAIL.pack(1, version_mask)
    return raw


def unpack_scan_request(
    raw: bytes,
) -> Tuple[bytes, int, int, int, int, Optional[int]]:
    """(header76, nonce_start, count, target, max_hits, pinned mask or
    None)."""
    ns, clo, chi, mh, tgt, hdr = _SCAN_REQ.unpack_from(raw, 0)
    mask: Optional[int] = None
    if len(raw) >= _SCAN_REQ.size + _SCAN_REQ_MASK_TAIL.size:
        present, m = _SCAN_REQ_MASK_TAIL.unpack_from(raw, _SCAN_REQ.size)
        if present:
            mask = m
    return hdr, ns, (chi << 32) | clo, int.from_bytes(tgt, "little"), mh, mask


def pack_scan_response(result: ScanResult) -> bytes:
    nonces = result.nonces
    vhits = result.version_hits
    raw = (
        _SCAN_RESP_HEAD.pack(result.total_hits, result.hashes_done,
                             len(nonces))
        + struct.pack(f"<{len(nonces)}I", *nonces)
        + _SCAN_RESP_VTAIL.pack(result.version_total_hits, len(vhits))
        + b"".join(struct.pack("<II", v, n) for v, n in vhits)
    )
    if result.reserved_version_bits is not None:
        raw += _SCAN_RESP_RTAIL.pack(1, result.reserved_version_bits)
    return raw


def unpack_scan_response(raw: bytes) -> ScanResult:
    total, done, n = _SCAN_RESP_HEAD.unpack_from(raw, 0)
    off = _SCAN_RESP_HEAD.size
    nonces = list(struct.unpack_from(f"<{n}I", raw, off))
    off += 4 * n
    version_hits: List[Tuple[int, int]] = []
    version_total = 0
    reserved: Optional[int] = None
    if len(raw) >= off + _SCAN_RESP_VTAIL.size:  # absent: pre-vshare server
        version_total, m = _SCAN_RESP_VTAIL.unpack_from(raw, off)
        off += _SCAN_RESP_VTAIL.size
        version_hits = [
            (int(v), int(nn))
            for v, nn in (struct.unpack_from("<II", raw, off + 8 * i)
                          for i in range(m))
        ]
        off += 8 * m
        if len(raw) >= off + _SCAN_RESP_RTAIL.size:  # absent: older server
            present, r = _SCAN_RESP_RTAIL.unpack_from(raw, off)
            if present:
                reserved = r
    return ScanResult(nonces=nonces, total_hits=total, hashes_done=done,
                      version_hits=version_hits,
                      version_total_hits=version_total,
                      reserved_version_bits=reserved)


class HasherService(TelemetryBound):
    """The server side: any local ``Hasher`` behind the service."""

    def __init__(self, backend: Hasher, telemetry=None) -> None:
        self.backend = backend
        if telemetry is not None:
            self.telemetry = telemetry
        self._applied_mask: Optional[int] = None
        self._reserved: Optional[int] = None
        self._apply_lock = threading.Lock()

    def _apply_mask_locked(self, mask: int) -> None:
        """Apply a pinned mask to the backend where it differs from what
        the backend holds. The caller holds ``_apply_lock``: the unary path
        across apply and scan, the streaming path around the apply only."""
        if mask != self._applied_mask:
            setter = getattr(self.backend, "set_version_mask", None)
            self._reserved = setter(mask) if setter is not None else 0
            self._applied_mask = mask

    def scan(self, request: bytes, context) -> bytes:
        # The caller's trace id for everything this call emits: serve_scan
        # here and the ring's spans, on this same thread.
        with self.telemetry.tracer.context(_metadata_trace_id(context)):
            return self._scan_traced(request)

    def _scan_traced(self, request: bytes) -> bytes:
        header76, nonce_start, count, target, max_hits, mask = (
            unpack_scan_request(request))
        # Apply and scan under one lock: two scans pinning different masks
        # (a mid-session change racing work in flight) must not run one
        # under the other's mask, whose sibling hits would carry version
        # bits outside the job's mask. Scans of one card serialize anyway.
        # A request without a mask still scans under the lock, so that a
        # concurrent pinned scan cannot change the mask under it.
        with self._apply_lock:
            if mask is not None:
                self._apply_mask_locked(mask)
            with self.telemetry.span("serve_scan", cat="rpc", count=count):
                result = self.backend.scan(header76, nonce_start, count,
                                           target, max_hits)
            if mask is not None and result.reserved_version_bits is None:
                result = dataclasses.replace(
                    result, reserved_version_bits=self._reserved)
        return pack_scan_response(result)

    def scan_stream(self, request_iterator, context) -> Iterator[bytes]:
        """The streaming scan: requests are unpacked as they arrive and
        driven through the backend's own ``scan_stream`` (a card's dispatch
        ring pipelines across them), responses streamed back in order.

        A request pinning a new mask applies it under the lock, but the
        lock is not held across the scan: a stream lives for the session,
        and would block every other caller. A mid-session mask change
        bumps the job generation, so a batch racing it is dropped on the
        client's side as stale. The whole session runs under the caller's
        trace id (the sync server pins one thread to the stream)."""
        trace_id = _metadata_trace_id(context)
        # The handshake goes out before the first request is pulled, so a
        # client can read it without feeding the stream (feeding first
        # against a deeper ring is the deadlock it exists to prevent).
        try:
            context.send_initial_metadata((
                (RING_DEPTH_METADATA_KEY,
                 str(int(getattr(self.backend, "stream_depth", 0) or 0))),
                (DISPATCH_SIZE_METADATA_KEY,
                 str(dispatch_granularity(self.backend, default=0))),
            ))
        except Exception:  # noqa: BLE001 — the handshake is advisory
            logger.debug("ring-depth handshake metadata failed",
                         exc_info=True)

        tracer = self.telemetry.tracer
        #: arrival time of each request, in order: serve_scan runs from a
        #: request's arrival to its response, not from ``next()``, which
        #: waits on the client's pacing.
        arrivals: "deque[int]" = deque()

        def requests() -> Iterator[ScanRequest]:
            for raw in request_iterator:
                if not raw:
                    yield STREAM_FLUSH  # the client is about to idle
                    continue
                header76, ns, count, target, mh, mask = unpack_scan_request(
                    raw)
                if mask is not None:
                    with self._apply_lock:
                        self._apply_mask_locked(mask)
                arrivals.append(tracer.now_ns() if tracer.enabled else 0)
                yield ScanRequest(header76=header76, nonce_start=ns,
                                  count=count, target=target, max_hits=mh)

        with tracer.context(trace_id):
            # A serve_scan span per response as well: a backend without a
            # ring (the CPU oracle) leaves no other span for CollectTrace.
            for sres in iter_scan_stream(self.backend, requests()):
                result = sres.result
                t0 = arrivals.popleft() if arrivals else 0
                if t0:
                    tracer.complete("serve_scan", t0, cat="rpc",
                                    count=sres.request.count)
                if result.reserved_version_bits is None:
                    with self._apply_lock:
                        reserved = self._reserved
                    if reserved is not None:
                        result = dataclasses.replace(
                            result, reserved_version_bits=reserved)
                yield pack_scan_response(result)

    def sha256d(self, request: bytes, context) -> bytes:
        return self.backend.sha256d(request)

    def collect_trace(self, request: bytes, context) -> bytes:
        """The server tracer's buffer as Chrome-trace JSON (UTF-8), with
        the epoch and trace-id anchors ``merge_traces`` needs. Collecting
        drains the buffer, so a long-lived worker never outgrows its bound
        between collects, and concurrent collectors split the spans: one
        tracing client per worker. The request payload is ignored."""
        return json.dumps(self.telemetry.tracer.drain()).encode("utf-8")

    def set_version_mask(self, request: bytes, context) -> bytes:
        (mask,) = struct.unpack("<I", request)
        with self._apply_lock:
            setter = getattr(self.backend, "set_version_mask", None)
            reserved = setter(mask) if setter is not None else 0
            self._applied_mask = mask
            self._reserved = reserved
        return struct.pack("<I", reserved)

    def handler(self) -> grpc.GenericRpcHandler:
        rpcs = {
            "Scan": grpc.unary_unary_rpc_method_handler(self.scan),
            "ScanStream": grpc.stream_stream_rpc_method_handler(
                self.scan_stream),
            "Sha256d": grpc.unary_unary_rpc_method_handler(self.sha256d),
            "SetVersionMask": grpc.unary_unary_rpc_method_handler(
                self.set_version_mask),
            "CollectTrace": grpc.unary_unary_rpc_method_handler(
                self.collect_trace),
        }

        class _Handler(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                name = handler_call_details.method
                if name.startswith(f"/{SERVICE}/"):
                    return rpcs.get(name.rsplit("/", 1)[1])
                return None

        return _Handler()


def serve(
    backend: Hasher,
    address: str = "127.0.0.1:0",
    max_workers: int = 16,
    telemetry=None,
) -> Tuple[grpc.Server, int]:
    """Start a hasher server on ``address``; returns (server, bound port).

    ``max_workers`` sizes the server's thread pool: each ScanStream pins a
    thread for its life, and the miner runs 8 dispatcher workers by
    default, so 16 leaves room for every stream and the unary control
    calls beside them. ``telemetry`` pins the service to a bundle (an
    in-process client and server must not share one tracer); by default
    it reports into the process bundle."""
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers(
        (HasherService(backend, telemetry=telemetry).handler(),))
    port = server.add_insecure_port(address)
    server.start()
    logger.info("hasher service (%s backend) on port %d", backend.name, port)
    return server, port


#: Failures worth retrying: a worker restarting (UNAVAILABLE; the channel
#: reconnects by itself) or a deadline missed while it was wedged.
_RETRYABLE = (grpc.StatusCode.UNAVAILABLE, grpc.StatusCode.DEADLINE_EXCEEDED)


class WorkerUnavailableError(ConnectionError):
    """The served worker stayed unreachable past the client's
    ``max_unavailable_s``. Raised only where that is set (the fleet
    supervisor sets it on its children, so a dead worker is quarantined
    and its requests reclaimed); a bare ``GrpcHasher``, the only hasher
    of its process, keeps retrying."""


class GrpcHasher(TelemetryBound, Hasher):
    """The client side: a ``Hasher`` whose scans run across the wire.

    Calls wait for the channel to be ready and are retried with
    exponential backoff on UNAVAILABLE and DEADLINE_EXCEEDED, so a worker
    restart is a stall of the sweep, not an error of the dispatcher."""

    name = "grpc"
    #: the ScanStream handshake grows ``stream_depth``/``dispatch_size``
    #: after construction: the dispatcher re-reads them.
    negotiates_stream_depth = True

    #: requests in flight on the wire per stream: the served ring's depth
    #: plus one, at least (grown by the handshake).
    stream_window = 4

    #: the depth the dispatcher's feeder window covers. 4 covers a worker
    #: at twice the default ring until the handshake replaces it with the
    #: served ring's depth (grow-only).
    stream_depth = 4

    #: seconds the first stream open waits for the handshake; an older
    #: server sends its metadata only with its first response.
    _DEPTH_HANDSHAKE_TIMEOUT = 5.0

    #: caps on the advertised depth and grid: any worker the client
    #: connects to sets them, and the feeder window and the scheduler's
    #: floor scale with them.
    _MAX_ADVERTISED_RING_DEPTH = 256
    _MAX_ADVERTISED_DISPATCH_SIZE = 1 << 28

    #: scans without the mask tail between re-probes of the tail, once a
    #: pre-tail worker was found.
    _TAIL_REPROBE_SCANS = 64

    def __init__(
        self,
        target: str,
        timeout: float = 600.0,
        retries: int = 5,
        retry_backoff: float = 1.0,
    ) -> None:
        self.target = target
        self.timeout = timeout
        self.retries = retries
        self.retry_backoff = retry_backoff
        self._channel = grpc.insecure_channel(target)
        self._scan = self._channel.unary_unary(f"/{SERVICE}/Scan")
        self._scan_stream_rpc = self._channel.stream_stream(
            f"/{SERVICE}/ScanStream")
        self._sha256d = self._channel.unary_unary(f"/{SERVICE}/Sha256d")
        self._set_version_mask = self._channel.unary_unary(
            f"/{SERVICE}/SetVersionMask")
        self._collect_trace_rpc = self._channel.unary_unary(
            f"/{SERVICE}/CollectTrace")
        #: the session mask every scan pins in its tail (None before any
        #: ``set_version_mask``), so a restarted worker heals on the first
        #: scan it serves; the SetVersionMask call is left as the
        #: synchronous reserved-bits answer ``set_job`` needs. Written on
        #: the event loop, read by pump threads: under ``_mask_lock``.
        self._mask_lock = threading.Lock()
        self._target_mask: Optional[int] = None
        self._delivered_mask: Optional[int] = None
        self._reserved_bits = 0
        #: a pre-tail worker was found: scans go without the tail, except
        #: every ``_TAIL_REPROBE_SCANS``-th, which probes it again (an
        #: upgraded or replaced worker gets per-scan pinning back).
        self._tail_unsupported = False
        self._tail_scans_since_probe = 0
        #: a worker without ScanStream answered UNIMPLEMENTED: unary scans
        #: for the session, with the same results.
        self._stream_unsupported = False
        #: the first stream open waited for the handshake.
        self._depth_handshake_done = False
        #: the served ring's advertised depth (None: not advertised, an
        #: older server).
        self._served_depth: Optional[int] = None
        #: seconds the worker may stay unavailable before calls raise
        #: :class:`WorkerUnavailableError`; None retries forever. Set, it
        #: also drops ``wait_for_ready``, so a refused connection counts
        #: against the deadline instead of parking inside gRPC.
        self.max_unavailable_s: Optional[float] = None
        self._unavailable_since: Optional[float] = None

    def _trace_metadata(self) -> Tuple[Tuple[str, str], ...]:
        """This thread's trace id for the served worker's spans."""
        return ((TRACE_ID_METADATA_KEY,
                 self.telemetry.tracer.current_trace()),)

    def _wait_for_ready(self) -> bool:
        return self.max_unavailable_s is None

    def _note_available(self) -> None:
        self._unavailable_since = None

    def _note_unavailable(self, what: str) -> None:
        """Count one availability failure; raise
        :class:`WorkerUnavailableError` once the worker has been
        unavailable for ``max_unavailable_s``."""
        if self.max_unavailable_s is None:
            return
        now = time.monotonic()
        if self._unavailable_since is None:
            self._unavailable_since = now
            return
        down_s = now - self._unavailable_since
        if down_s >= self.max_unavailable_s:
            self.telemetry.flightrec.record(
                "rpc_error", what=what, target=self.target,
                code="unavailable_deadline", down_s=round(down_s, 1))
            raise WorkerUnavailableError(
                f"worker {self.target} unavailable for {down_s:.1f}s "
                f"(deadline {self.max_unavailable_s:.1f}s) — surfacing for "
                f"supervision instead of retrying forever")

    def _call(self, rpc, payload: bytes, what: str) -> bytes:
        delay = self.retry_backoff
        metadata = self._trace_metadata()
        for attempt in range(self.retries + 1):
            try:
                raw = rpc(payload, timeout=self.timeout,
                          wait_for_ready=self._wait_for_ready(),
                          metadata=metadata)
            except grpc.RpcError as e:
                code = e.code() if hasattr(e, "code") else None
                if code not in _RETRYABLE or attempt == self.retries:
                    raise
                # Past its deadline a supervised worker surfaces here,
                # before another backoff of dead air.
                self._note_unavailable(what)
                tel = self.telemetry
                tel.rpc_errors.labels(kind="retry").inc()
                tel.flightrec.record("rpc_error", what=what,
                                     target=self.target, code=str(code),
                                     attempt=attempt + 1)
                logger.warning(
                    "hasher %s rpc to %s failed (%s), attempt %d/%d; "
                    "retrying in %.1fs", what, self.target, code,
                    attempt + 1, self.retries, delay)
                time.sleep(delay)
                delay = min(delay * 2, 30.0)
            else:
                self._note_available()
                return raw
        raise AssertionError("unreachable")  # pragma: no cover

    def sha256d(self, data: bytes) -> bytes:
        return self._call(self._sha256d, data, "sha256d")

    def set_version_mask(self, mask: int) -> int:
        """Send the session's BIP 310 mask to the worker; returns its
        reserved roll-bit count. ``Dispatcher.set_job`` calls this on the
        event loop at every notify, so it never enters the retry loop: the
        call is skipped while the mask is the one the worker last
        acknowledged, else one attempt with a 2 s deadline. Scans never
        depend on it (each pins the mask in its tail); a failed attempt
        costs only the reserved count's freshness, and returns the last
        one known."""
        mask = mask or 0
        with self._mask_lock:
            self._target_mask = mask
            # Without the scan tail this call is the only delivery, and a
            # restarted pre-tail worker must learn the mask within a job:
            # send it at every notify.
            if self._delivered_mask == mask and not self._tail_unsupported:
                return self._reserved_bits
            fallback = self._reserved_bits
        try:
            raw = self._set_version_mask(struct.pack("<I", mask),
                                         timeout=2.0)
        except grpc.RpcError as e:
            code = e.code() if hasattr(e, "code") else None
            with self._mask_lock:
                if self._target_mask == mask:
                    self._delivered_mask = None  # the next notify retries
            logger.warning(
                "set_version_mask to %s failed (%s); scans still pin the "
                "mask, next notify retries the reserved-bits sync",
                self.target, code)
            return fallback
        (reserved,) = struct.unpack("<I", raw)
        with self._mask_lock:
            # Only the call whose mask is still the target may commit: a
            # late one must not cache a superseded (mask, reserved) pair.
            if self._target_mask == mask:
                self._delivered_mask = mask
                self._reserved_bits = reserved
            return self._reserved_bits

    def scan(
        self,
        header76: bytes,
        nonce_start: int,
        count: int,
        target: int,
        max_hits: int = 64,
    ) -> ScanResult:
        self._check_range(header76, nonce_start, count)
        # The session mask rides in the tail, and every retry re-sends it:
        # even a restart between retries is healed.
        mask, send_tail = self._tail_policy()
        try:
            with self.telemetry.span("rpc_scan", cat="rpc",
                                     target=self.target, count=count):
                raw = self._call(
                    self._scan,
                    pack_scan_request(header76, nonce_start, count, target,
                                      max_hits,
                                      version_mask=mask if send_tail
                                      else None),
                    "scan")
        except grpc.RpcError as e:
            code = e.code() if hasattr(e, "code") else None
            # A pre-tail server choking on the longer request fails its
            # strict unpack, which gRPC reports as UNKNOWN; every other
            # non-retryable code is a real server-side failure and must
            # not switch the session to scans without the tail.
            if not send_tail or code != grpc.StatusCode.UNKNOWN:
                raise
            # Tell the two apart with the older protocol, once: the mask
            # by SetVersionMask (one short attempt: a worker that died
            # after the error must not hold this thread for minutes), then
            # the scan without the tail. Success means an older worker;
            # failure re-raises the original error, and the next scan
            # tries the tail again.
            try:
                legacy = self._set_version_mask(
                    struct.pack("<I", mask), timeout=5.0,
                    wait_for_ready=True)
                raw = self._call(
                    self._scan,
                    pack_scan_request(header76, nonce_start, count, target,
                                      max_hits),
                    "scan")
            except grpc.RpcError:
                raise e
            (reserved,) = struct.unpack("<I", legacy)
            with self._mask_lock:
                self._tail_unsupported = True
                self._tail_scans_since_probe = 0
                if self._target_mask == mask:
                    self._delivered_mask = mask
                    self._reserved_bits = reserved
            logger.warning(
                "worker at %s predates the scan mask tail (%s); falling "
                "back to SetVersionMask delivery + tail-less scans "
                "(re-probing after %d scans — upgrade the worker)",
                self.target, code, self._TAIL_REPROBE_SCANS)
        result = unpack_scan_response(raw)
        self.telemetry.rpc_responses.inc()
        self._note_scan_response(result, mask)
        return result

    def collect_trace(self) -> Optional[dict]:
        """The served worker's span buffer (``CollectTrace``) as a
        Chrome-trace dict; None from a worker without the call or out of
        reach, since merging traces must never fail a shutdown."""
        try:
            raw = self._collect_trace_rpc(b"", timeout=10.0)
            return json.loads(raw.decode("utf-8"))
        except (grpc.RpcError, ValueError, UnicodeDecodeError) as e:
            logger.debug("collect_trace from %s failed: %s", self.target, e)
            return None

    def _tail_policy(self) -> Tuple[Optional[int], bool]:
        """(the mask to pin, whether to send the tail) for one request:
        without the tail against a pre-tail worker, except every
        ``_TAIL_REPROBE_SCANS``-th request, which probes it again."""
        with self._mask_lock:
            mask = self._target_mask
            send_tail = mask is not None
            if send_tail and self._tail_unsupported:
                self._tail_scans_since_probe += 1
                if self._tail_scans_since_probe >= self._TAIL_REPROBE_SCANS:
                    self._tail_scans_since_probe = 0
                    self._tail_unsupported = False
                else:
                    send_tail = False
        return mask, send_tail

    def _note_scan_response(
        self, result: ScanResult, mask: Optional[int]
    ) -> None:
        """A response proves what the worker reserved under the pinned
        mask: refresh the cache ``set_version_mask`` answers from, which
        follows a worker restarted with another configuration."""
        if result.reserved_version_bits is None or mask is None:
            return
        with self._mask_lock:
            if self._target_mask == mask:
                self._delivered_mask = mask
                self._reserved_bits = result.reserved_version_bits

    def _note_ring_depth(self, depth: int) -> None:
        """Fold an advertised ring depth into the windows, grow-only: a
        shrinking window could strand requests in flight, and a large one
        costs only memory, up to the cap."""
        if depth > self._MAX_ADVERTISED_RING_DEPTH:
            logger.warning(
                "worker at %s advertises implausible ring depth %d; "
                "capping at %d", self.target, depth,
                self._MAX_ADVERTISED_RING_DEPTH)
            depth = self._MAX_ADVERTISED_RING_DEPTH
        if depth > self.stream_depth:
            logger.info("worker at %s advertises ring depth %d (assumed "
                        "%d); widening stream window", self.target, depth,
                        self.stream_depth)
            self.stream_depth = depth
        if depth + 1 > self.stream_window:
            self.stream_window = depth + 1
        self._served_depth = depth

    def _note_dispatch_size(self, size: int) -> None:
        """Record the served dispatch grid, grow-only like the depth: the
        scheduler re-reads it per session, and a shrinking grid would only
        flap its sizing."""
        if size <= 0:
            return
        if size > self._MAX_ADVERTISED_DISPATCH_SIZE:
            logger.warning(
                "worker at %s advertises implausible dispatch grid %d; "
                "capping at %d", self.target, size,
                self._MAX_ADVERTISED_DISPATCH_SIZE)
            size = self._MAX_ADVERTISED_DISPATCH_SIZE
        if size > getattr(self, "dispatch_size", 0):
            logger.info("worker at %s advertises dispatch grid %d; adaptive "
                        "sizing will quantize to it", self.target, size)
            self.dispatch_size = size

    def _learn_ring_depth(self, call) -> None:
        """Read the handshake off one stream's initial metadata, on a side
        thread: a current server sends it at handler entry, an older one
        only with its first response. Only the first open waits for it,
        bounded; later opens record whatever arrives."""
        def read() -> None:
            try:
                metadata = call.initial_metadata()
            except grpc.RpcError:
                return
            for key, value in metadata or ():
                note = {RING_DEPTH_METADATA_KEY: self._note_ring_depth,
                        DISPATCH_SIZE_METADATA_KEY: self._note_dispatch_size,
                        }.get(key)
                if note is not None:
                    try:
                        note(int(value))
                    except (TypeError, ValueError):
                        pass

        thread = threading.Thread(target=read, name="grpc-ring-depth",
                                  daemon=True)
        thread.start()
        if not self._depth_handshake_done:
            thread.join(timeout=self._DEPTH_HANDSHAKE_TIMEOUT)
            self._depth_handshake_done = True

    def scan_stream(
        self, requests: Iterable[ScanRequest]
    ) -> Iterator[StreamResult]:
        """Scans over one ScanStream call with up to :attr:`stream_window`
        requests in flight, so the worker's ring never waits on a unary
        round trip; results in request order.

        A broken stream (a worker restart, a deadline) re-scans its
        unanswered requests through the unary ``scan``, which owns the
        retries, then opens a new stream; a server without ScanStream
        gets unary scans for the session. The results are the same either
        way.

        One puller thread iterates ``requests`` for the life of the call
        (a caller's generator is never pulled from two threads, even
        across re-opens) into a small buffer, and the loop fills the wire
        window from that buffer without blocking while responses are in
        flight: a caller that paces its requests on the results (the
        dispatcher's feeder) cannot deadlock the window."""
        it = iter(requests)
        buf: "thread_queue.Queue" = thread_queue.Queue(maxsize=2)
        closed = threading.Event()  # this generator exited, any way
        src_ended = threading.Event()

        def puller() -> None:
            try:
                for req in it:
                    # Poll ``closed`` while the buffer is full: once this
                    # generator is gone nobody drains it, and a parked
                    # thread per stream restart would leak.
                    while not closed.is_set():
                        try:
                            buf.put(req, timeout=0.5)
                            break
                        except thread_queue.Full:
                            continue
                    if closed.is_set():
                        return
            finally:
                src_ended.set()

        threading.Thread(target=puller, name="grpc-scan-stream-src",
                         daemon=True).start()
        src_done = False

        def pull(block: bool):
            nonlocal src_done
            if src_done:
                return None
            while True:
                try:
                    got = buf.get(block=block, timeout=0.5 if block else None)
                except thread_queue.Empty:
                    if src_ended.is_set() and buf.empty():
                        src_done = True
                        return None
                    if not block:
                        return None
                    continue
                return got

        try:
            yield from self._scan_stream_loop(pull, lambda: src_done)
        finally:
            closed.set()

    def _scan_stream_loop(self, pull, source_done) -> Iterator[StreamResult]:
        while True:
            if self._stream_unsupported:
                while True:
                    req = pull(block=True)
                    if req is None:
                        return
                    if req is STREAM_FLUSH:
                        continue  # unary scans hold nothing in flight
                    yield StreamResult(req, self.scan(
                        req.header76, req.nonce_start, req.count,
                        req.target, req.max_hits))
            # A request joins ``inflight`` before its bytes are queued for
            # gRPC's sender thread, so whatever may be on the wire can be
            # salvaged.
            feed_q: "thread_queue.SimpleQueue" = thread_queue.SimpleQueue()

            def sender(q=feed_q):
                while True:
                    raw = q.get()
                    if raw is None:
                        return
                    yield raw

            # No deadline: a session's stream lives for hours. A worker
            # that dies surfaces as UNAVAILABLE (salvaged, re-opened); one
            # that wedges while connected is a stall, as on the unary path.
            call = self._scan_stream_rpc(
                sender(), wait_for_ready=self._wait_for_ready(),
                metadata=self._trace_metadata())
            self._learn_ring_depth(call)
            tel = self.telemetry
            # (request, pinned mask, send time ns) per message in flight.
            inflight: "deque[Tuple[ScanRequest, Optional[int], int]]" = deque()
            half_closed = False
            #: a flush went out after the last request: the server's ring
            #: answers everything it holds.
            flushed = False
            end = object()
            try:
                while True:
                    # Top up the window. A served ring answers once it
                    # holds its depth + 1 requests (or a flush): with fewer
                    # in flight, wait for the next request, which a caller
                    # whose window covers the ring will send; waiting for a
                    # response would wait for ever. Otherwise take only what
                    # is buffered.
                    while len(inflight) < self.stream_window:
                        emits = min(self.stream_window,
                                    (self._served_depth or 0) + 1)
                        req = pull(block=not inflight or (
                            not flushed and len(inflight) < emits))
                        if req is None:
                            break
                        if req is STREAM_FLUSH:
                            feed_q.put(b"")  # the server's ring drains
                            flushed = True
                            continue
                        flushed = False
                        self._check_range(req.header76, req.nonce_start,
                                          req.count)
                        mask, send_tail = self._tail_policy()
                        pinned = mask if send_tail else None
                        inflight.append((
                            req, pinned,
                            time.perf_counter_ns() if tel.enabled else 0))
                        feed_q.put(pack_scan_request(
                            req.header76, req.nonce_start, req.count,
                            req.target, req.max_hits, version_mask=pinned))
                        # Deltas: every worker's stream shares the gauge.
                        tel.stream_window.inc()
                    if source_done() and not half_closed:
                        half_closed = True
                        feed_q.put(None)  # half-close: the server drains
                    if source_done() and not inflight:
                        return
                    raw = next(call, end)
                    if raw is end:
                        if source_done() and not inflight:
                            return
                        # The server ended the stream with requests
                        # unanswered: salvage and re-open, as on a break.
                        raise grpc.RpcError()
                    req, mask, sent_ns = inflight.popleft()
                    tel.stream_window.dec()
                    if sent_ns:
                        tel.tracer.complete(
                            "rpc_scan_stream", sent_ns, cat="rpc",
                            target=self.target, nonce_start=req.nonce_start)
                    result = unpack_scan_response(raw)
                    tel.rpc_responses.inc()
                    self._note_available()
                    self._note_scan_response(result, mask)
                    yield StreamResult(req, result)
            except grpc.RpcError as e:
                code = e.code() if hasattr(e, "code") else None
                if code == grpc.StatusCode.UNIMPLEMENTED:
                    logger.warning(
                        "worker at %s has no ScanStream; falling back to "
                        "unary scans for this session (upgrade the worker)",
                        self.target)
                    tel.rpc_errors.labels(kind="unimplemented").inc()
                    self._stream_unsupported = True
                elif code is not None and code not in _RETRYABLE:
                    raise
                else:
                    # Streams breaking with no response between them count
                    # against the unavailability deadline, which the unary
                    # salvage below shares through ``_call``.
                    self._note_unavailable("scan_stream")
                    tel.rpc_errors.labels(kind="stream_broken").inc()
                tel.flightrec.record(
                    "rpc_error", what="scan_stream", target=self.target,
                    code=str(code), salvaged=len(inflight))
                # The unanswered requests go through the unary path and
                # its retries (a batch the server may have finished is
                # computed again: results replace, they do not add up).
                while inflight:
                    req, _mask, _sent = inflight.popleft()
                    tel.stream_window.dec()
                    yield StreamResult(req, self.scan(
                        req.header76, req.nonce_start, req.count,
                        req.target, req.max_hits))
                if source_done():
                    return
            finally:
                feed_q.put(None)  # stops gRPC's sender thread
                if inflight:
                    # Left unanswered and unsalvaged (a non-retryable
                    # status re-raised): give the shared gauge back.
                    tel.stream_window.dec(len(inflight))
                    inflight.clear()

    def close(self) -> None:
        self._channel.close()


def _grpc_local() -> GrpcHasher:
    """Registry entry for a worker on this host, at
    ``TPU_MINER_GRPC_TARGET`` (``--grpc-target`` names it on the command
    line)."""
    return GrpcHasher(os.environ.get("TPU_MINER_GRPC_TARGET",
                                     "127.0.0.1:50051"))


register_hasher("grpc-local", _grpc_local)
