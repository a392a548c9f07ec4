"""The PyTorch package's gRPC hasher service against the JAX package's, on
the CPU: the codecs byte for byte on seeded messages; the port's client
on the reference's server and the reference's client on the port's
server, each giving the reference ``TpuHasher``'s ``ScanResult`` (with the
sibling chains' hits at ``--vshare 2``); the ring-depth and dispatch-grid
handshake reaching the port's dispatcher; a restarted worker learning the
mask from the scan tail; the tail fallback's gating; and ``CollectTrace``
draining the worker's spans. Servers bind port 0."""

import asyncio
import struct
from collections import deque
from concurrent import futures

import grpc
import numpy as np
import pytest
import torch

from bitcoin_miner_tpu.backends import base as ref_base
from bitcoin_miner_tpu.backends.tpu import TpuHasher
from bitcoin_miner_tpu.rpc import hasher_service as ref_service
from bitcoin_miner_tpu.telemetry import pipeline as ref_pipeline
from bitcoin_miner_tpu_torch.backends import base as port_base
from bitcoin_miner_tpu_torch.backends.base import (
    STREAM_FLUSH,
    ScanRequest,
    ScanResult,
    StreamResult,
    get_hasher,
)
from bitcoin_miner_tpu_torch.backends.cuda import CudaHasher, TileCudaHasher
from bitcoin_miner_tpu_torch.core.header import GENESIS_HEADER_HEX, GENESIS_NONCE
from bitcoin_miner_tpu_torch.core.target import difficulty_to_target, nbits_to_target
from bitcoin_miner_tpu_torch.miner.dispatcher import Dispatcher
from bitcoin_miner_tpu_torch.miner.job import Job
from bitcoin_miner_tpu_torch.miner.scheduler import scheduler_for
from bitcoin_miner_tpu_torch.rpc import hasher_service as port_service
from bitcoin_miner_tpu_torch.telemetry import PipelineTelemetry


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SEEDS = [0, 1, 2, 3, 4, 5]
HEADER = bytes.fromhex(GENESIS_HEADER_HEX)[:76]
DIFF1 = nbits_to_target(0x1D00FFFF)
EASY = difficulty_to_target(1 / (1 << 22))  # ~2^-10 per nonce and chain
VERY_EASY = difficulty_to_target(1 / (1 << 24))  # ~2^-8
MASK = 0x1FFFE000
BATCH = 1 << 12
#: the range every cross-package scan covers: three dispatches, the last
#: one cut by the limit.
START, COUNT = 5000, 3 * BATCH - 700


def _fields(result):
    return (result.nonces, result.total_hits, result.hashes_done,
            [tuple(v) for v in result.version_hits],
            result.version_total_hits)


def _request(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, 76, dtype=np.uint8).tobytes(),
            int(rng.integers(0, 1 << 32)), int(rng.integers(0, 1 << 33)),
            int.from_bytes(rng.integers(0, 256, 32, dtype=np.uint8)
                           .tobytes(), "little"),
            int(rng.integers(1, 1 << 16)))


def _result_fields(seed):
    rng = np.random.default_rng(seed)
    nonces = sorted(int(n) for n in rng.integers(0, 1 << 32,
                                                 int(rng.integers(0, 40))))
    vhits = [(int(v), int(n)) for v, n in rng.integers(
        0, 1 << 32, (int(rng.integers(0, 12)), 2))]
    return dict(nonces=nonces, total_hits=len(nonces) + int(rng.integers(3)),
                hashes_done=int(rng.integers(0, 1 << 40)),
                version_hits=vhits,
                version_total_hits=len(vhits) + int(rng.integers(3)))


# --------------------------------------------------------------------- codec
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mask", [None, 0, MASK])
def test_scan_request_codec_matches_reference(seed, mask):
    args = _request(seed)
    raw = port_service.pack_scan_request(*args, version_mask=mask)
    assert raw == ref_service.pack_scan_request(*args, version_mask=mask)
    header, start, count, target, max_hits = args
    assert port_service.unpack_scan_request(raw) == (
        header, start, count, target, max_hits, mask)
    assert port_service.unpack_scan_request(raw) == \
        ref_service.unpack_scan_request(raw)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("reserved", [None, 0, 3])
def test_scan_response_codec_matches_reference(seed, reserved):
    fields = _result_fields(seed)
    port = ScanResult(**fields, reserved_version_bits=reserved)
    ref = ref_base.ScanResult(**fields, reserved_version_bits=reserved)
    raw = port_service.pack_scan_response(port)
    assert raw == ref_service.pack_scan_response(ref)
    assert port_service.unpack_scan_response(raw) == port
    got = ref_service.unpack_scan_response(raw)
    assert _fields(got) == _fields(port)
    assert got.reserved_version_bits == reserved


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_responses_without_the_tails_unpack_as_the_reference_does(seed):
    """A pre-vshare server's response (no version tail) and a pre-reserved
    one (no reserved tail) unpack as empty and as None."""
    fields = _result_fields(seed)
    full = port_service.pack_scan_response(ScanResult(**fields))
    head = 16 + 4 + 4 * len(fields["nonces"])
    for raw in (full[:head], full):
        got = port_service.unpack_scan_response(raw)
        want = ref_service.unpack_scan_response(raw)
        assert _fields(got) == _fields(want)
        assert got.reserved_version_bits is want.reserved_version_bits is None


# ------------------------------------------------------ across the packages
@pytest.fixture(scope="module")
def ref_tpu():
    """The reference's XLA hasher at K = 1 and 2 under the full mask."""
    out = {}
    for k in (1, 2):
        h = TpuHasher(batch_size=BATCH, inner_size=1 << 9, unroll=8,
                      vshare=k)
        h.set_version_mask(MASK)
        out[k] = h
    return out


def _want(ref_tpu, k):
    return _fields(ref_tpu[k].scan(HEADER, START, COUNT, EASY))


def _stream(client, count=COUNT, target=EASY, n=3, base=port_base):
    """The range as ``n`` consecutive requests, a flush after the first
    (the request class and flush of the client's package, ``base``)."""
    step = count // n
    reqs = [base.ScanRequest(header76=HEADER, nonce_start=START + i * step,
                             count=step if i < n - 1 else count - i * step,
                             target=target, tag=i) for i in range(n)]
    return list(client.scan_stream(iter([reqs[0], base.STREAM_FLUSH,
                                         *reqs[1:]])))


def _merge(results):
    """The stream's results as one range's (hit lists concatenated)."""
    res = [r.result for r in results]
    return ([n for r in res for n in r.nonces],
            sum(r.total_hits for r in res), sum(r.hashes_done for r in res),
            [tuple(v) for r in res for v in r.version_hits],
            sum(r.version_total_hits for r in res))


@pytest.mark.parametrize("k", [1, 2])
def test_port_client_on_reference_server(ref_tpu, k):
    """The reference's ``serve`` (its hashlib oracle at K=1, over a short
    range at an easier target since it hashes in Python; its XLA hasher at
    K=2) driven by the port's ``GrpcHasher``: unary and streamed scans
    give the reference ``TpuHasher``'s result."""
    if k == 1:
        backend, count, target = ref_base.get_hasher("cpu"), 1536, VERY_EASY
    else:
        backend = TpuHasher(batch_size=BATCH, inner_size=1 << 9, unroll=8,
                            vshare=2)
        count, target = COUNT, EASY
    want = _fields(ref_tpu[k].scan(HEADER, START, count, target))
    assert want[0]
    server, port = ref_service.serve(backend,
                                     telemetry=ref_pipeline.PipelineTelemetry())
    client = port_service.GrpcHasher(f"127.0.0.1:{port}")
    try:
        assert client.set_version_mask(MASK) == (0 if k == 1 else 1)
        assert _fields(client.scan(HEADER, START, count, target)) == want
        got = _stream(client, count=count, target=target)
        assert [r.request.tag for r in got] == [0, 1, 2]
        assert _merge(got) == want
        if k == 2:
            assert got[0].result.reserved_version_bits == 1
    finally:
        client.close()
        server.stop(grace=None)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cls", [CudaHasher, TileCudaHasher])
def test_reference_client_on_port_server(ref_tpu, cls, k):
    """The port's ``serve`` over its hit-buffer and tile hashers (their
    plain versions) driven by the reference's ``GrpcHasher``."""
    kw = dict(inner_size=1 << 9) if cls is CudaHasher else {}
    backend = cls(batch_size=BATCH, vshare=k, device="cpu", **kw)
    server, port = port_service.serve(backend, telemetry=PipelineTelemetry())
    client = ref_service.GrpcHasher(f"127.0.0.1:{port}")
    try:
        assert client.set_version_mask(MASK) == k - 1
        assert _fields(client.scan(HEADER, START, COUNT, EASY)) == \
            _want(ref_tpu, k)
        assert _merge(_stream(client, base=ref_base)) == _want(ref_tpu, k)
        got = client.scan(HEADER, GENESIS_NONCE - 100, 200, DIFF1)
        assert got.nonces == [GENESIS_NONCE]
    finally:
        client.close()
        server.stop(grace=None)


# ---------------------------------------------------- ring-depth handshake
class RingBackend:
    """A backend with a ring of ``depth``: a result is held until depth + 1
    requests are queued or a flush comes, as a card's ring and a served
    worker hold it (the fleet's tests drive it as a child too)."""

    name = "ring"
    scan_releases_gil = True

    def __init__(self, depth, batch_size=None):
        self.stream_depth = depth
        if batch_size is not None:
            self.batch_size = batch_size
        self.inner = CudaHasher(batch_size=BATCH, inner_size=1 << 9,
                                device="cpu")

    def sha256d(self, data):
        return self.inner.sha256d(data)

    def scan(self, header76, nonce_start, count, target, max_hits=64):
        return self.inner.scan(header76, nonce_start, count, target,
                               max_hits)

    def scan_stream(self, reqs):
        held = deque()
        for req in reqs:
            if req is STREAM_FLUSH:
                while held:
                    yield held.popleft()
                continue
            held.append(StreamResult(req, self.scan(
                req.header76, req.nonce_start, req.count, req.target,
                req.max_hits)))
            while len(held) > self.stream_depth:
                yield held.popleft()
        while held:
            yield held.popleft()


def _pair(backend):
    server, port = port_service.serve(backend, telemetry=PipelineTelemetry())
    return server, port_service.GrpcHasher(f"127.0.0.1:{port}")


def _stream_once(client):
    req = ScanRequest(header76=HEADER, nonce_start=0, count=64, target=EASY)
    return list(client.scan_stream(iter([req])))


class TestRingDepthNegotiation:
    def test_deeper_served_ring_widens_client_window(self):
        server, client = _pair(RingBackend(7))
        try:
            assert client.stream_depth == 4  # before the handshake
            assert len(_stream_once(client)) == 1
            assert client.stream_depth == 7 and client.stream_window >= 8
        finally:
            client.close()
            server.stop(grace=None)

    def test_shallower_served_ring_never_shrinks(self):
        server, client = _pair(RingBackend(1))
        try:
            _stream_once(client)
            assert client.stream_depth == 4
        finally:
            client.close()
            server.stop(grace=None)

    def test_dispatcher_refreshes_feeder_window_from_handshake(self):
        server, client = _pair(RingBackend(9))
        try:
            d = Dispatcher(client, n_workers=1, stream_depth=2)
            _stream_once(client)
            assert d._refresh_stream_depth() == 9 and d.stream_depth == 9
        finally:
            client.close()
            server.stop(grace=None)

    def test_dispatch_grid_learned_and_quantizes_scheduler(self):
        server, client = _pair(RingBackend(2, batch_size=1 << 16))
        try:
            sched = scheduler_for(client)
            assert sched.granularity == 1  # nothing learned yet
            d = Dispatcher(client, n_workers=1, stream_depth=2,
                           scheduler=sched)
            _stream_once(client)
            assert client.dispatch_size == 1 << 16
            d._refresh_stream_depth()
            assert sched.granularity == 1 << 16
            assert sched.next_count() % (1 << 16) == 0
        finally:
            client.close()
            server.stop(grace=None)

    def test_implausible_dispatch_grid_capped(self):
        server, client = _pair(RingBackend(2, batch_size=1 << 40))
        try:
            _stream_once(client)
            assert client.dispatch_size == \
                port_service.GrpcHasher._MAX_ADVERTISED_DISPATCH_SIZE
        finally:
            client.close()
            server.stop(grace=None)


def _job(extranonce2_size=1):
    """A Stratum job at an easy share difficulty (~2^-8 per nonce)."""
    return Job(
        job_id="g1", prevhash_internal=bytes(range(32)),
        coinb1=bytes.fromhex("01000000") + b"\x11" * 30,
        coinb2=b"\x22" * 30 + bytes.fromhex("00000000"),
        merkle_branch=[], version=0x20000000, nbits=0x1D00FFFF,
        ntime=0x655F2B2C, extranonce1=b"\x00\x00\x00\x01",
        extranonce2_size=extranonce2_size,
        share_target=difficulty_to_target(1 / (1 << 24)), clean=True)


async def _first_shares(d, n=2, seconds=60):
    got = []

    async def on_share(share):
        got.append(share)

    run = asyncio.create_task(d.run(on_share))
    d.set_job(_job())
    try:
        deadline = asyncio.get_running_loop().time() + seconds
        while len(got) < n:
            assert asyncio.get_running_loop().time() < deadline, (
                d.stats.summary())
            assert not run.done(), run
            await asyncio.sleep(0.05)
    finally:
        d.stop()
        await asyncio.gather(run, return_exceptions=True)
    return got


class TestDispatcherStreamsOverGrpc:
    def test_shares_flow_through_streamed_rpc(self):
        """The dispatcher's pump feeds ``GrpcHasher.scan_stream`` over the
        port's served hit-buffer hasher; its hits verify on the local
        oracle."""
        server, client = _pair(CudaHasher(batch_size=BATCH,
                                          inner_size=1 << 9, device="cpu"))
        try:
            d = Dispatcher(client, n_workers=1, batch_size=BATCH)
            got = asyncio.run(_first_shares(d))
            assert all(s.hash_int <= _job().share_target for s in got)
            assert d.stats.hw_errors == 0
        finally:
            client.close()
            server.stop(grace=None)

    def test_first_session_widens_to_a_deeper_served_ring(self):
        """Against a served ring of 9 the first session's feeder window
        (4 + 1, sized before the handshake) would hold 5 requests while
        the ring waits for 10: the widener must grow the live window when
        the handshake lands, or no result ever comes back."""
        server, client = _pair(RingBackend(9))
        try:
            d = Dispatcher(client, n_workers=1, batch_size=1 << 10)
            got = asyncio.run(_first_shares(d))
            assert got and d.stream_depth == 9
            assert client.stream_window == 10
        finally:
            client.close()
            server.stop(grace=None)


# ------------------------------------------------------ mask and restarts
def _serve_on(backend, port):
    server, bound = port_service.serve(backend, f"127.0.0.1:{port}",
                                       telemetry=PipelineTelemetry())
    assert bound == port
    return server


def test_worker_restart_relearns_the_mask_from_the_scan_tail(ref_tpu):
    """A restarted worker holds no mask, and the client cannot see the
    restart; the first scan's tail teaches the new process the session
    mask, so the sibling chains come back, equal to the reference's."""
    backend = CudaHasher(batch_size=BATCH, inner_size=1 << 9, vshare=2,
                         device="cpu")
    server, port = port_service.serve(backend, telemetry=PipelineTelemetry())
    client = port_service.GrpcHasher(f"127.0.0.1:{port}", retries=8,
                                     retry_backoff=0.2)
    try:
        assert client.set_version_mask(MASK) == 1
        server.stop(grace=0).wait()
        fresh = CudaHasher(batch_size=BATCH, inner_size=1 << 9, vshare=2,
                           device="cpu")
        fresh.set_version_mask(0)  # a worker that mines chain 0 only
        server = _serve_on(fresh, port)
        got = client.scan(HEADER, START, COUNT, EASY)
        assert fresh.version_mask == MASK
        assert got.version_hits and _fields(got) == _want(ref_tpu, 2)
        assert got.reserved_version_bits == 1
        assert client.set_version_mask(MASK) == 1  # the cache still holds
    finally:
        client.close()
        server.stop(grace=0)


class TestTailFallbackGating:
    """The fallback to SetVersionMask and scans without the tail: only on
    the UNKNOWN a pre-tail server's strict unpack produces, never on
    another code, and with the tail probed again after N scans."""

    def _serve_raw(self, scan_fn):
        backend = CudaHasher(batch_size=BATCH, inner_size=1 << 9, vshare=2,
                             device="cpu")

        def set_version_mask(request, context):
            (mask,) = struct.unpack("<I", request)
            return struct.pack("<I", backend.set_version_mask(mask))

        rpcs = {
            "Scan": grpc.unary_unary_rpc_method_handler(
                lambda req, ctx: scan_fn(backend, req, ctx)),
            "SetVersionMask": grpc.unary_unary_rpc_method_handler(
                set_version_mask),
        }

        class Handler(grpc.GenericRpcHandler):
            def service(self, details):
                if details.method.startswith(f"/{port_service.SERVICE}/"):
                    return rpcs.get(details.method.rsplit("/", 1)[1])
                return None

        server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
        server.add_generic_rpc_handlers((Handler(),))
        port = server.add_insecure_port("127.0.0.1:0")
        server.start()
        return server, port, backend

    @staticmethod
    def _legacy_scan(backend, request, context):
        ns, clo, chi, mh, tgt, hdr = struct.unpack(
            port_service._SCAN_REQ.format, request)  # a tail: struct.error
        return port_service.pack_scan_response(backend.scan(
            hdr, ns, (chi << 32) | clo, int.from_bytes(tgt, "little"), mh))

    def test_unknown_from_pre_tail_server_triggers_fallback(self):
        server, port, backend = self._serve_raw(self._legacy_scan)
        client = port_service.GrpcHasher(f"127.0.0.1:{port}")
        try:
            client.set_version_mask(MASK)
            res = client.scan(HEADER, 0, 2048, EASY)
            assert client._tail_unsupported is True and res.nonces
            assert backend.version_mask == MASK
            # Without the tail the mask call is the only delivery: it is
            # made at every notify.
            calls = []
            real = client._set_version_mask
            client._set_version_mask = lambda *a, **k: (
                calls.append(a) or real(*a, **k))
            client.set_version_mask(MASK)
            client.set_version_mask(MASK)
            assert len(calls) == 2
        finally:
            client.close()
            server.stop(grace=None)

    def test_other_nonretryable_codes_reraise_without_latching(self):
        def exhausted(backend, request, context):
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                          "transient server-side failure")

        server, port, _ = self._serve_raw(exhausted)
        client = port_service.GrpcHasher(f"127.0.0.1:{port}")
        try:
            client.set_version_mask(MASK)
            with pytest.raises(grpc.RpcError) as ei:
                client.scan(HEADER, 0, 1000, 1 << 255)
            assert ei.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
            assert client._tail_unsupported is False
        finally:
            client.close()
            server.stop(grace=None)

    def test_tail_reprobed_after_n_scans(self):
        server, port, backend = self._serve_raw(self._legacy_scan)
        client = port_service.GrpcHasher(f"127.0.0.1:{port}")
        client._TAIL_REPROBE_SCANS = 3
        try:
            client.set_version_mask(MASK)
            client.scan(HEADER, 0, 1000, EASY)
            assert client._tail_unsupported is True
            server.stop(grace=0).wait()
            server = _serve_on(backend, port)  # the upgraded worker
            for _ in range(client._TAIL_REPROBE_SCANS):
                res = client.scan(HEADER, 0, 1000, EASY)
            assert client._tail_unsupported is False
            assert res.reserved_version_bits == 1
        finally:
            client.close()
            server.stop(grace=0)


# ------------------------------------------------------------------ tracing
def test_collect_trace_drains_and_serves_no_event_twice():
    """Each ``CollectTrace`` hands over the spans recorded since the last
    one, under the client's trace id, and never one of them again."""
    server_tel = PipelineTelemetry()
    server_tel.tracer.enabled = True
    client_tel = PipelineTelemetry()
    client_tel.tracer.enabled = True
    server, port = port_service.serve(
        CudaHasher(batch_size=BATCH, inner_size=1 << 9, device="cpu"),
        telemetry=server_tel)
    client = port_service.GrpcHasher(f"127.0.0.1:{port}")
    client.telemetry = client_tel
    try:
        client.scan(HEADER, 0, 2048, EASY)
        first = client.collect_trace()
        spans = [e for e in first["traceEvents"] if e.get("ph") == "X"]
        assert [e["name"] for e in spans] == ["serve_scan"]
        assert spans[0]["args"]["trace"] == client_tel.tracer.trace_id
        assert first["otherData"]["trace_id"] == server_tel.tracer.trace_id
        assert client.collect_trace()["traceEvents"] == []
        list(client.scan_stream(iter([ScanRequest(
            header76=HEADER, nonce_start=i * 512, count=512, target=EASY)
            for i in range(3)])))
        third = [e for e in client.collect_trace()["traceEvents"]
                 if e.get("ph") == "X"]
        assert [e["name"] for e in third].count("serve_scan") == 3
        assert {e["ts"] for e in third}.isdisjoint(
            {e["ts"] for e in spans})
        assert server_tel.tracer.events() == []
    finally:
        client.close()
        server.stop(grace=None)


def test_collect_trace_absent_on_legacy_server_is_none():
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    client = port_service.GrpcHasher(f"127.0.0.1:{port}")
    try:
        assert client.collect_trace() is None
    finally:
        client.close()
        server.stop(grace=None)


def test_pre_stream_server_falls_back_to_unary(ref_tpu):
    """UNIMPLEMENTED for ScanStream: unary scans for the session, with the
    same results."""
    full = port_service.HasherService(
        get_hasher("cpu"), telemetry=PipelineTelemetry()).handler()

    class PreStream(grpc.GenericRpcHandler):
        def service(self, details):
            if details.method.endswith("/ScanStream"):
                return None
            return full.service(details)

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    server.add_generic_rpc_handlers((PreStream(),))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    client = port_service.GrpcHasher(f"127.0.0.1:{port}")
    try:
        got = list(client.scan_stream(iter([ScanRequest(
            header76=HEADER, nonce_start=GENESIS_NONCE - 50, count=100,
            target=DIFF1)])))
        assert client._stream_unsupported is True
        assert got[0].result.nonces == [GENESIS_NONCE]
    finally:
        client.close()
        server.stop(grace=None)


def test_worker_unavailable_surfaces_past_deadline():
    """With an unavailability deadline the client raises
    ``WorkerUnavailableError`` against a dead endpoint instead of retrying
    forever (what the fleet supervisor quarantines on)."""
    client = port_service.GrpcHasher("127.0.0.1:1", timeout=2.0, retries=50,
                                     retry_backoff=0.05)
    client.max_unavailable_s = 0.5
    try:
        with pytest.raises(port_service.WorkerUnavailableError):
            client.scan(HEADER, 0, 64, EASY)
    finally:
        client.close()
