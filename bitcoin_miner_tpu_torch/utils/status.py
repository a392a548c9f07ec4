"""Local HTTP status endpoint (``--status-port``).

Counterpart of ``bitcoin_miner_tpu/utils/status.py``: a small asyncio
HTTP server with one request per connection ("Connection: close"):

- ``/metrics``: the session counters and the telemetry registry in
  Prometheus exposition format (``# HELP``/``# TYPE``, counters
  ``_total``);
- ``/telemetry``: the registry's JSON snapshot, histograms with p50/p95/
  p99, and with a multi-pool fabric its snapshot under ``pool_fabric``
  (the active slot, weights, failovers, each slot's state and window);
- ``/healthz``: the health model's verdict, 200, or 503 with the reasons
  when a component is stalled;
- ``/trace``: the span buffer as Chrome trace-event JSON;
- ``/flightrec``: the flight recorder's dump;
- ``/lifecycle``: the share-lifecycle ledger;
- ``/slo``: the SLO engine's cached report (``tpu-miner-slo/1``);
- ``/query``: a range query over the time-series store
  (``tpu-miner-query/1``): ``name``, ``prefix``, ``window_s`` and ``tier``
  select, every other parameter is a label to match; a bad parameter is
  a 400 naming it;
- any other path: :func:`stats_snapshot` as JSON.

The reference's shard payload comes with the sharded pool frontend. A
request line or header over the
reader's 64 KiB limit gets no answer and an orderly close: the server
half-closes, then reads and drops what the client sent (bounded in bytes
and time) before closing, so the client reads an empty response, not a
connection reset. Bound to 127.0.0.1 unless a host is given.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
import urllib.parse
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..miner.dispatcher import MinerStats

#: snapshot keys that are monotonic counters (rendered ``_total``); the
#: rest are gauges.
_COUNTER_KEYS = frozenset({
    "hashes", "batches", "shares_found", "shares_accepted",
    "shares_rejected", "shares_stale", "blocks_found", "hw_errors",
    "reconnects",
})

_HELP = {
    "hashes": "Nonces hashed since start",
    "batches": "Device scan batches completed",
    "hashrate_mhs": "Mean hashrate since start (MH/s)",
    "device_hashrate_mhs":
        "Hashrate while a scan was in flight (MH/s, device-side)",
    "shares_found": "Device hits that passed CPU re-verification",
    "shares_accepted": "Shares the pool accepted",
    "shares_rejected": "Shares the pool rejected",
    "shares_stale": "Shares stale at the pool or lost to a disconnect",
    "blocks_found": "Hits that also met the block target",
    "hw_errors": "Device hits that FAILED CPU re-verification",
    "reconnects": "Pool reconnects (monotonic, survives failover)",
    "uptime_s": "Seconds since miner start",
}

_REASONS = {
    200: b"OK",
    400: b"Bad Request",
    503: b"Service Unavailable",
}

#: ``/query`` parameters that are not label selectors.
_QUERY_PARAMS = frozenset({"name", "prefix", "window_s", "tier"})


def prometheus_text(stats: MinerStats, registry: Optional[Any] = None,
                    ) -> str:
    """The snapshot in Prometheus exposition format, then (``registry``
    given) the telemetry registry's families."""
    snap = stats_snapshot(stats)
    lines: List[str] = []
    for key, value in snap.items():
        base = f"tpu_miner_{key}"
        if key in _COUNTER_KEYS:
            name, kind = f"{base}_total", "counter"
        else:
            name, kind = base, "gauge"
        lines.append(f"# HELP {name} {_HELP.get(key, key)}")
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name} {value}")
    text = "\n".join(lines) + "\n"
    if registry is not None:
        rendered = registry.render()
        if rendered:
            text += rendered
    return text


def stats_snapshot(stats: MinerStats) -> Dict[str, Any]:
    return {
        "hashes": stats.hashes,
        "batches": stats.batches,
        "hashrate_mhs": round(stats.hashrate() / 1e6, 3),
        "device_hashrate_mhs": round(stats.device_hashrate() / 1e6, 3),
        "shares_found": stats.shares_found,
        "shares_accepted": stats.shares_accepted,
        "shares_rejected": stats.shares_rejected,
        "shares_stale": stats.shares_stale,
        "blocks_found": stats.blocks_found,
        "hw_errors": stats.hw_errors,
        "reconnects": stats.reconnects,
        "uptime_s": round(time.monotonic() - stats.started_at, 1),
    }


class StatusServer:
    """Serves the routes above; ``/telemetry`` needs a registry,
    ``/healthz`` a health model, ``/trace``, ``/flightrec`` and
    ``/lifecycle`` a telemetry bundle, ``/slo`` an SLO engine and
    ``/query`` a time-series store (without one, the path answers the
    snapshot)."""

    #: seconds a client gets to deliver its request line and headers
    #: before the connection is dropped (tests shrink it).
    request_timeout = 10.0
    #: bytes of an oversized request read and dropped before the close.
    discard_limit = 1 << 20

    def __init__(
        self, stats: MinerStats, port: int, host: str = "127.0.0.1",
        registry: Optional[Any] = None, telemetry: Optional[Any] = None,
        health: Optional[Any] = None, slo: Optional[Any] = None,
        tsdb: Optional[Any] = None, fabric: Optional[Any] = None,
    ) -> None:
        self.stats = stats
        self.host = host
        self.port = port
        self.registry = registry
        self.telemetry = telemetry
        self.health = health
        self.slo = slo
        self.tsdb = tsdb
        #: the multi-pool fabric whose snapshot ``/telemetry`` carries.
        self.fabric = fabric
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        if self.port == 0:  # an ephemeral port
            self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _read_request(self, reader: asyncio.StreamReader) -> bytes:
        """The request line (it routes) after reading the headers; b"" if
        the client sent nothing. Raises ValueError past readline's limit."""
        line = await reader.readline()
        if not line:
            return b""
        while True:
            header = await reader.readline()
            if header in (b"\r\n", b"\n", b""):
                return line

    async def _discard(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        """Refuse an oversized request with an orderly close: half-close
        (the client reads EOF), then read and drop what the client sent,
        up to :attr:`discard_limit` bytes and :attr:`request_timeout`
        seconds, until it closes. Closing with its bytes unread would
        make the kernel answer with a reset."""
        if writer.can_write_eof():
            writer.write_eof()
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.request_timeout
        left = self.discard_limit
        while left > 0:
            chunk = await asyncio.wait_for(
                reader.read(min(left, 1 << 16)),
                timeout=max(0.0, deadline - loop.time()))
            if not chunk:
                return
            left -= len(chunk)

    def _query_payload(self, query_string: str) -> Tuple[int, bytes]:
        """(status, body) of a ``/query`` request against the store. It
        runs in the executor: the store takes a lock, and the payload can
        be large. A bad parameter gets a 400 body naming it."""
        params = urllib.parse.parse_qs(query_string)

        def one(key: str) -> Optional[str]:
            values = params.get(key)
            return values[-1] if values else None

        window_s: Optional[float] = None
        raw_window = one("window_s")
        if raw_window is not None:
            try:
                window_s = float(raw_window)
            except ValueError:
                return 400, json.dumps(
                    {"error": f"window_s must be a number "
                              f"(got {raw_window!r})"}).encode()
            if window_s <= 0:
                return 400, json.dumps(
                    {"error": "window_s must be > 0"}).encode()
        labels = {key: values[-1] for key, values in params.items()
                  if key not in _QUERY_PARAMS and values}
        try:
            payload = self.tsdb.query(
                name=one("name"), prefix=one("prefix"),
                labels=labels or None, window_s=window_s,
                tier=one("tier") or "fine")
        except ValueError as e:
            return 400, json.dumps({"error": str(e)}).encode()
        return 200, json.dumps(payload).encode()

    def _route(self, path: str) -> Optional[bytes]:
        """The JSON body of a telemetry route, or None for the snapshot."""
        tel = self.telemetry
        if path == "/slo" and self.slo is not None:
            return json.dumps(self.slo.report_dict(), default=str).encode()
        if path == "/telemetry" and self.registry is not None:
            payload = dict(self.registry.snapshot())
            if self.fabric is not None:
                # What the gauges cannot carry: each slot's window, the
                # measured weights, the active slot, the failovers.
                payload["pool_fabric"] = self.fabric.snapshot()
            return json.dumps(payload, default=str).encode()
        if tel is None:
            return None
        if path == "/trace":
            return json.dumps(tel.tracer.trace_dict()).encode()
        if path == "/flightrec":
            return json.dumps(tel.flightrec.dump_dict(reason="request")
                              ).encode()
        if path == "/lifecycle":
            return json.dumps(tel.lifecycle.dump_dict(), default=str
                              ).encode()
        return None

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            try:
                request_line = await asyncio.wait_for(
                    self._read_request(reader), timeout=self.request_timeout)
            except ValueError:  # over readline's limit
                await self._discard(reader, writer)
                return
            if not request_line:
                return
            parts = request_line.split()
            raw_path = parts[1].decode("ascii", "replace") \
                if len(parts) > 1 else "/"
            path, _, query_string = raw_path.partition("?")
            status = 200
            ctype = b"application/json"
            if path == "/query" and self.tsdb is not None:
                status, body = await asyncio.get_running_loop()\
                    .run_in_executor(None, self._query_payload, query_string)
            elif path == "/metrics":
                body = prometheus_text(self.stats, self.registry).encode()
                ctype = b"text/plain; version=0.0.4"
            elif path == "/healthz" and self.health is not None:
                # Off the loop: the rule engine takes a lock, and a scrape
                # must never stall the miner's event loop.
                status, payload = await asyncio.get_running_loop()\
                    .run_in_executor(None, self.health.healthz)
                body = json.dumps(payload).encode()
            else:
                body = self._route(path)
                if body is None:
                    body = json.dumps(stats_snapshot(self.stats)).encode()
            reason = _REASONS.get(status, b"Error")
            writer.write(
                b"HTTP/1.1 " + str(status).encode() + b" " + reason
                + b"\r\n"
                b"Content-Type: " + ctype + b"\r\n"
                + f"Content-Length: {len(body)}\r\n".encode()
                + b"Connection: close\r\n\r\n"
                + body
            )
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.TimeoutError):
            pass
        finally:
            writer.close()


def serve_status_in_thread(server: StatusServer) -> Callable[[], None]:
    """Run a :class:`StatusServer` on its own event-loop thread (for a
    caller with no event loop of its own) and return a stop callable.
    Raises whatever ``start`` raised (port busy, bad host) in the caller."""
    loop = asyncio.new_event_loop()
    started = threading.Event()
    error: List[BaseException] = []

    def run() -> None:
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(server.start())
        except BaseException as e:  # noqa: BLE001 — re-raised in caller
            error.append(e)
            started.set()
            return
        started.set()
        loop.run_forever()

    thread = threading.Thread(target=run, name="status-server", daemon=True)
    thread.start()
    started.wait(timeout=10.0)
    if error:
        raise error[0]

    def stop() -> None:
        try:
            asyncio.run_coroutine_threadsafe(server.stop(), loop).result(2.0)
        except Exception:  # noqa: BLE001 — best-effort shutdown
            pass
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=2.0)
        if not thread.is_alive():
            loop.close()

    return stop
