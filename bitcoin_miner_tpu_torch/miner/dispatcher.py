"""Worker pool and job dispatch.

A single-threaded event loop owns all bookkeeping:

- a producer turns the current job into work items: for each extranonce2
  value of this host's stride the 2^32 nonce space is split into
  ``n_workers`` disjoint ranges; once that space is exhausted the BIP 310
  version bits roll, then ntime (``ntime_roll``);
- each worker feeds its items, as dispatch-sized ``ScanRequest``s, to the
  backend's ``scan_stream`` running on a pump thread, and verifies and
  submits the results as they stream back — CPU re-verification and share
  submission overlap device compute;
- a generation counter cancels stale work: ``set_job`` bumps it, and any
  result of an older generation is dropped, including dispatches already
  in flight;
- every device hit is re-verified on the CPU oracle before it becomes a
  ``Share`` (the parity gate): a mismatch counts as a hardware error and is
  never submitted;
- the resume position of each job, one linear index over (ntime offset,
  version variant, extranonce2 stride), is kept in memory and, with a
  ``checkpoint``, on disk;
- :meth:`Dispatcher.sweep` is the synchronous path (no event loop): one
  range through the same ring, re-verified the same way (the perf proxy
  battery's inner loop);
- it reports into a telemetry bundle (``telemetry/pipeline.py``; the
  process default unless one is given): the busy clock's
  ``dispatch_gap``, stale drops, the ``job_notify``, ``feeder_slice``,
  ``device_dispatch`` (blocking path) and ``cpu_verify`` spans, flight
  recorder events and each verified share's lifecycle record.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import queue as thread_queue
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Awaitable, Callable, Iterator, List, Optional

from ..backends.base import (
    Hasher,
    STREAM_FLUSH,
    ScanRequest,
    ScanResult,
    dispatch_granularity,
    iter_scan_stream,
)
from ..core.target import hash_to_int
from ..parallel.ranges import ExtranonceCounter, NONCE_SPACE, split_range
from ..telemetry import PipelineTelemetry, get_telemetry, share_key
from ..telemetry.tracing import host_range
from .job import Job

if TYPE_CHECKING:
    from ..utils.checkpoint import SweepCheckpoint
    from .scheduler import AdaptiveBatchScheduler

logger = logging.getLogger(__name__)

OnShare = Callable[["Share"], Awaitable[None]]

#: How long a stopping worker waits for its scan pump thread to drain.
_PUMP_JOIN_S = 30.0


@dataclass(frozen=True)
class Share:
    """A verified hit, ready for ``mining.submit``."""

    job_id: str
    extranonce2: bytes
    ntime: int
    nonce: int
    header80: bytes
    hash_int: int
    is_block: bool  # also meets the nbits block target
    #: BIP 310: the in-mask version bits of this share's header, submitted
    #: as mining.submit's 6th param; None without version rolling.
    version_bits: Optional[int] = None


@dataclass
class MinerStats:
    """Counters of one mining session."""

    hashes: int = 0
    batches: int = 0
    #: wall time of the closed busy intervals (at least one scan in
    #: flight): overlapping scans of several workers count once.
    scan_seconds: float = 0.0
    shares_found: int = 0
    shares_accepted: int = 0
    shares_rejected: int = 0
    shares_stale: int = 0
    blocks_found: int = 0
    hw_errors: int = 0  # device hit that failed CPU re-verification
    reconnects: int = 0
    started_at: float = field(default_factory=time.monotonic)
    #: the bundle whose ``dispatch_gap`` histogram the busy clock feeds
    #: (with a sampled exemplar); None = none.
    telemetry: Optional[PipelineTelemetry] = field(
        default=None, repr=False, compare=False
    )
    #: fed every inter-dispatch gap (seconds): the adaptive scheduler's
    #: input, the same series as ``dispatch_gap``.
    gap_listener: Optional[Callable[[float], None]] = field(
        default=None, repr=False, compare=False
    )

    def hashrate(self) -> float:
        """Mean hashes/second since start."""
        dt = time.monotonic() - self.started_at
        return self.hashes / dt if dt > 0 else 0.0

    def busy_seconds(self) -> float:
        """:attr:`scan_seconds` and the busy interval still open: a
        pipeline that never runs dry has one interval, open for the whole
        session."""
        busy = self.scan_seconds
        if self._active_scans > 0:
            busy += time.monotonic() - self._busy_since
        return busy

    def device_hashrate(self) -> float:
        """Hashes/second while a scan was in flight: the device's own
        rate, without the protocol's and verification's time. It counts
        the open busy interval (the reference's reads 0 until the busy
        clock first goes idle)."""
        busy = self.busy_seconds()
        return self.hashes / busy if busy else 0.0

    # The busy clock, called from the event loop only.
    _active_scans: int = 0
    _busy_since: float = 0.0
    _idle_since: float = 0.0  # end of the last busy interval; 0 = never busy

    def scan_started(self) -> None:
        if self._active_scans == 0:
            now = time.monotonic()
            self._busy_since = now
            # The idle interval of the busy clock is the inter-dispatch gap.
            if self._idle_since:
                gap = max(0.0, now - self._idle_since)
                tel = self.telemetry
                if tel is not None and tel.enabled:
                    tel.dispatch_gap.observe(gap)
                    # The gap's trace id leads from a histogram tail to
                    # the timeline around it (a bounded sample).
                    tel.lifecycle.exemplar(
                        tel.dispatch_gap.name, gap,
                        trace=tel.tracer.current_trace(),
                    )
                if self.gap_listener is not None:
                    self.gap_listener(gap)
        self._active_scans += 1

    def scan_finished(self) -> None:
        self._active_scans -= 1
        if self._active_scans == 0:
            now = time.monotonic()
            self.scan_seconds += now - self._busy_since
            self._idle_since = now

    def summary(self) -> str:
        line = (
            f"{self.hashrate() / 1e6:.2f} MH/s | hashes {self.hashes} | "
            f"shares {self.shares_accepted}/{self.shares_found} accepted "
            f"({self.shares_rejected} rejected, {self.shares_stale} stale) | "
            f"blocks {self.blocks_found} | hw_err {self.hw_errors}"
        )
        if self.reconnects:
            line += f" | reconnects {self.reconnects}"
        return line


@dataclass(frozen=True)
class WorkItem:
    generation: int
    job: Job
    extranonce2: bytes
    header76: bytes
    nonce_start: int
    nonce_count: int
    #: the ntime and (possibly rolled) version this item's header76 was
    #: built with — submitted with the share.
    ntime: int
    version: Optional[int] = None


class Dispatcher:
    """Owns the worker pool and the current job; bridges protocol ↔ device."""

    def __init__(
        self,
        hasher: Hasher,
        oracle: Optional[Hasher] = None,
        n_workers: int = 8,
        batch_size: int = 1 << 24,
        extranonce2_start: int = 0,
        extranonce2_step: int = 1,
        queue_depth: Optional[int] = None,
        checkpoint: Optional["SweepCheckpoint"] = None,
        ntime_roll: int = 0,
        submit_blocks_only: bool = False,
        stream_depth: int = 2,
        scheduler: Optional["AdaptiveBatchScheduler"] = None,
        telemetry: Optional[PipelineTelemetry] = None,
    ) -> None:
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        if oracle is None:
            from ..backends.cpu import CpuHasher

            oracle = CpuHasher()
        self.hasher = hasher
        self.oracle = oracle
        self.n_workers = n_workers
        self.batch_size = batch_size
        #: this host's extranonce2 stride (``partition_extranonce2_space``).
        self.extranonce2_start = extranonce2_start
        self.extranonce2_step = extranonce2_step
        #: resume positions on disk, beside the in-memory ones.
        self.checkpoint = checkpoint
        #: solo mining submits block-target hits only: easier hits are
        #: neither counted as found nor handed on.
        self.submit_blocks_only = submit_blocks_only
        #: seconds of ntime rolling once the extranonce2 × version × nonce
        #: space is exhausted: each pass sweeps it again at ntime + 1 s, up
        #: to this many. A fixed-merkle (getwork) job holds 2^32 nonces and
        #: would idle without it.
        self.ntime_roll = max(0, ntime_roll)
        #: requests a worker keeps in flight ahead of verification. 0 runs
        #: the blocking scan-then-verify loop. A dispatch ring yields its
        #: first result only once ring_depth+1 requests are queued, so the
        #: window is at least the ring's depth — smaller would deadlock.
        ring_depth = getattr(hasher, "stream_depth", 2)
        self.stream_depth = (
            0 if stream_depth <= 0 else max(ring_depth, stream_depth)
        )
        #: the bundle this dispatcher reports into: the process default
        #: unless one is given (tests pass their own).
        self.telemetry = (
            telemetry if telemetry is not None else get_telemetry()
        )
        self.stats = MinerStats(telemetry=self.telemetry)
        #: sizes every dispatch when present; else ``batch_size`` is fixed.
        self.scheduler = scheduler
        if scheduler is not None:
            self.stats.gap_listener = scheduler.record_gap
            if scheduler._telemetry_override is None:
                scheduler.telemetry = self.telemetry
        self._generation = 0
        self._job: Optional[Job] = None
        #: next extranonce2 position per job (bounded LRU), so re-installing
        #: a job (retarget, or a pool re-announcing it) resumes instead of
        #: re-mining and re-submitting the space already covered.
        self._sweep_pos: "OrderedDict[str, int]" = OrderedDict()
        self._sweep_pos_capacity = 8
        self._queue: Optional[asyncio.Queue] = None
        self._queue_depth = queue_depth or n_workers * 2
        # The resume point lags the enqueued position by enough strides to
        # cover every queued or in-flight item a generation bump can drop:
        # bounded duplicate work on resume, never a coverage hole.
        stream_extra = (self.stream_depth + 1) if self.stream_depth else 0
        self._resume_lag_strides = -(
            -(self._queue_depth + n_workers * (1 + stream_extra))
            // n_workers
        )
        self._job_event = asyncio.Event()
        self._stop_event: Optional[asyncio.Event] = None
        self._stopping = False

    # ------------------------------------------------------------- job feed
    def set_job(self, job: Job) -> Job:
        """Install a new job. Bumps the generation so in-flight work for the
        old job is dropped; ``clean`` jobs also flush queued items. A hasher
        with sibling chains gets the job's mask and reserves its low bits
        out of the host's version axis; scans racing the change carry the
        old generation and are dropped."""
        self._generation += 1
        set_mask = getattr(self.hasher, "set_version_mask", None)
        if set_mask is not None:
            reserved = set_mask(job.version_mask)
            if reserved != job.reserved_version_bits:
                job = dataclasses.replace(job,
                                          reserved_version_bits=reserved)
        job = _with_generation(job, self._generation)
        self._job = job
        if self.scheduler is not None:
            self.scheduler.on_job_switch()
        if job.sweep_key in self._sweep_pos:
            self._sweep_pos.move_to_end(job.sweep_key)
        if job.clean and self._queue is not None:
            while not self._queue.empty():
                self._queue.get_nowait()
                self._queue.task_done()
        self._job_event.set()
        tel = self.telemetry
        tel.lifecycle.note_job(
            job.job_id, generation=job.generation, clean=bool(job.clean),
        )
        tel.tracer.instant(
            "job_notify", cat="job", job_id=job.job_id,
            generation=job.generation, clean=bool(job.clean),
        )
        tel.flightrec.record(
            "job_switch", job_id=job.job_id, generation=job.generation,
            clean=bool(job.clean),
        )
        logger.info(
            "new job %s gen=%d clean=%s", job.job_id, job.generation, job.clean
        )
        return job

    @property
    def current_generation(self) -> int:
        return self._generation

    def reset_sweep_positions(self) -> None:
        """Forget all resume positions, in memory and on disk: job ids and
        extranonce1 are per-connection, so after a disconnect or an
        extranonce migration the old positions describe other headers, and
        resuming a new session's job from them would skip space never
        mined."""
        self._sweep_pos.clear()
        if self.checkpoint is not None:
            self.checkpoint.clear_all()
            self.checkpoint.save()

    def stop(self) -> None:
        self._stopping = True
        self._job_event.set()
        if self._stop_event is not None:
            self._stop_event.set()

    def _next_dispatch_count(self) -> int:
        if self.scheduler is not None:
            return self.scheduler.next_count()
        return self.batch_size

    def _refresh_stream_depth(self) -> int:
        """The feeder window of one streaming session. It re-reads
        ``hasher.stream_depth``, which a ``GrpcHasher`` grows when the
        ScanStream handshake reveals a deeper served ring: a window sized
        from the older value would deadlock against it. A deeper window
        leaves more work outstanding, so the resume lag is re-derived
        (grow-only: a shorter lag could skip space). The same handshake
        carries the served dispatch grid, which the adaptive scheduler's
        quantization follows."""
        if self.scheduler is not None:
            grid = dispatch_granularity(self.hasher)
            if grid > 1 and grid != self.scheduler.granularity:
                self.scheduler.set_granularity(grid)
        depth = max(self.stream_depth,
                    getattr(self.hasher, "stream_depth", 2))
        if depth != self.stream_depth:
            self.stream_depth = depth
            lag = -(-(self._queue_depth + self.n_workers * (2 + depth))
                    // self.n_workers)
            self._resume_lag_strides = max(self._resume_lag_strides, lag)
        return depth

    # ------------------------------------------------------------ main loop
    async def run(self, on_share: OnShare) -> None:
        """Run the producer and N workers until :meth:`stop`; they are
        cancelled on stop, since they may be blocked on a queue."""
        self._queue = asyncio.Queue(maxsize=self._queue_depth)
        self._stop_event = asyncio.Event()
        if self._stopping:
            self._stop_event.set()
        workers = [
            asyncio.create_task(self._worker(w, on_share), name=f"worker-{w}")
            for w in range(self.n_workers)
        ]
        producer = asyncio.create_task(self._producer(), name="producer")
        try:
            await self._stop_event.wait()
        finally:
            for t in [producer, *workers]:
                t.cancel()
            await asyncio.gather(producer, *workers, return_exceptions=True)

    async def _producer(self) -> None:
        """Turns the current job into queued WorkItems, extranonce2-major."""
        queue = self._queue
        assert queue is not None  # run() builds it before spawning us
        while not self._stopping:
            await self._job_event.wait()
            self._job_event.clear()
            job = self._job
            if job is None or self._stopping:
                continue
            gen = job.generation
            try:
                for item in self._iter_items(job):
                    if self._stopping or self._generation != gen:
                        break  # a newer job arrived
                    await queue.put(item)
            except Exception:
                logger.exception("producer failed for job %s", job.job_id)

    def _iter_items(self, job: Job) -> Iterator[WorkItem]:
        """extranonce2-major work items over two bounded outer axes: pass 0
        sweeps the job's own (ntime, version) over this host's extranonce2
        × nonce space; once that is exhausted (a fixed-merkle job after
        2^32 nonces) the BIP 310 version bits roll, then ntime +1 s up to
        ``ntime_roll``. Resume positions are one linear index over
        (ntime offset, version variant, extranonce2 stride), so a
        re-installed or checkpointed job resumes mid-roll too."""
        positions = self._stride_positions(job)
        vcount = job.version_variants
        resume_lin = self._sweep_pos.get(job.sweep_key, -1)
        if self.checkpoint is not None:
            saved = self.checkpoint.get_resume_index(job.sweep_key)
            if saved is not None and saved > resume_lin:
                resume_lin = saved
        if resume_lin < 0:
            start_off = start_v = start_idx = 0
        else:
            outer, start_idx = divmod(resume_lin, positions)
            start_off, start_v = divmod(outer, vcount)
        for ntime_off in range(start_off, self.ntime_roll + 1):
            if ntime_off > start_off:
                logger.info("job %s: search space exhausted, rolling ntime "
                            "to +%ds", job.job_id, ntime_off)
            ntime = job.ntime + ntime_off
            first_v = start_v if ntime_off == start_off else 0
            for v_idx in range(first_v, vcount):
                version = job.rolled_version(v_idx)
                first_idx = (start_idx if (ntime_off, v_idx) == (start_off,
                                                                 first_v)
                             else 0)
                for e2 in self._iter_extranonce2(job, first_idx):
                    if positions > 1 or self.ntime_roll or vcount > 1:
                        self._record_resume(job, e2,
                                            ntime_off * vcount + v_idx,
                                            positions)
                    header76 = job.header76(e2, ntime=ntime, version=version)
                    for start, count in split_range(0, NONCE_SPACE,
                                                    self.n_workers):
                        if count:
                            yield WorkItem(
                                job.generation, job, e2, header76, start,
                                count, ntime=ntime, version=version,
                            )

    def _stride_positions(self, job: Job) -> int:
        """How many extranonce2 values this host sweeps per pass."""
        if job.extranonce2_size == 0:
            return 1
        span = (1 << (8 * job.extranonce2_size)) - self.extranonce2_start
        return max(1, -(-span // self.extranonce2_step))

    def _iter_extranonce2(self, job: Job, first_idx: int) -> Iterator[bytes]:
        """This host's extranonce2 stride from ``first_idx`` positions in;
        a fixed-merkle job's single empty value."""
        if job.extranonce2_size == 0:
            return iter([b""])
        return iter(ExtranonceCounter(
            size=job.extranonce2_size,
            start=self.extranonce2_start + first_idx * self.extranonce2_step,
            step=self.extranonce2_step))

    def _record_resume(self, job: Job, e2: bytes, outer: int,
                       positions: int) -> None:
        """Move the job's resume point to ``e2`` of pass ``outer`` (ntime
        offset × version variants + variant), lagged as
        ``_resume_lag_strides`` says; near a pass boundary the lag reaches
        back into the previous pass. The checkpoint follows."""
        idx = ((int.from_bytes(e2, "little") - self.extranonce2_start)
               // self.extranonce2_step)
        lin = outer * positions + idx - self._resume_lag_strides
        if lin > self._sweep_pos.get(job.sweep_key, -1):
            self._sweep_pos[job.sweep_key] = lin
            self._sweep_pos.move_to_end(job.sweep_key)
            while len(self._sweep_pos) > self._sweep_pos_capacity:
                self._sweep_pos.popitem(last=False)
            if self.checkpoint is not None:
                prev = self.checkpoint.get_resume_index(job.sweep_key)
                if lin > (prev if prev is not None else -1):
                    self.checkpoint.set_progress(job.sweep_key, lin)
                    self.checkpoint.save()

    async def _worker(self, wid: int, on_share: OnShare) -> None:
        if self.stream_depth == 0 or not getattr(
            self.hasher, "scan_releases_gil", True
        ):
            # A pump thread that holds the GIL while hashing would starve
            # the event loop instead of overlapping with it.
            await self._worker_blocking(wid, on_share)
            return
        while not self._stopping:
            if not await self._stream_session(wid, on_share):
                return
            # The pump died on a hasher error: start a fresh session after
            # a pause, so an instantly failing backend cannot spin.
            await asyncio.sleep(0.5)

    async def _worker_blocking(self, wid: int, on_share: OnShare) -> None:
        """Scan, then verify and submit, one dispatch at a time. The loop
        re-checks ``_stopping``: a submit's ``wait_for`` can swallow the
        one cancellation ``run`` sends."""
        loop = asyncio.get_running_loop()
        queue = self._queue
        assert queue is not None  # run() builds it before spawning us
        while not self._stopping:
            item: WorkItem = await queue.get()
            try:
                await self._mine_item(loop, item, on_share)
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("worker %d failed on job %s", wid,
                                 item.job.job_id)
            finally:
                queue.task_done()

    async def _stream_session(self, wid: int, on_share: OnShare) -> bool:
        """One life of a worker's streaming pipeline: a feeder coroutine
        slices queued items into requests, at most ``stream_depth + 1``
        ahead of verification (the depth re-read per session, and widened
        live for a backend that negotiates it); a pump thread drives
        ``scan_stream`` over them; the consumer verifies and submits
        results as they return. Returns True when the pump died on a
        backend error."""
        loop = asyncio.get_running_loop()
        queue = self._queue
        assert queue is not None  # run() builds it before spawning us
        req_q: "thread_queue.SimpleQueue" = thread_queue.SimpleQueue()
        res_q: asyncio.Queue = asyncio.Queue()
        session_depth = self._refresh_stream_depth()
        slots = asyncio.Semaphore(session_depth + 1)
        # In-flight requests, so teardown can rebalance the busy clock.
        outstanding = [0]
        pump_error: List[BaseException] = []
        end = object()

        def pump() -> None:
            def requests() -> Iterator[Any]:
                while True:
                    req = req_q.get()
                    if req is None:
                        return
                    yield req

            try:
                for sres in iter_scan_stream(self.hasher, requests()):
                    try:
                        loop.call_soon_threadsafe(res_q.put_nowait, sres)
                    except RuntimeError:
                        return  # loop closed mid-shutdown
            except BaseException as e:  # noqa: BLE001 — reported below
                pump_error.append(e)
            try:
                loop.call_soon_threadsafe(res_q.put_nowait, end)
            except RuntimeError:
                pass

        thread = threading.Thread(target=pump, name=f"scan-pump-{wid}",
                                  daemon=True)
        thread.start()
        tel = self.telemetry

        async def feed() -> None:
            while True:
                if queue.empty():
                    # About to idle: have the ring finish what it holds, so
                    # its hits reach verification before a new job makes
                    # them stale.
                    req_q.put(STREAM_FLUSH)
                item: WorkItem = await queue.get()
                slice_t0 = tel.tracer.now_ns() if tel.tracer.enabled else 0
                slice_range = host_range("feeder_slice")
                slice_range.__enter__()
                try:
                    off = 0
                    while off < item.nonce_count:
                        if (self._stopping
                                or item.generation != self._generation):
                            if not self._stopping:
                                self._stale_drop("item", item)
                            break  # stale: a new job superseded this item
                        count = min(self._next_dispatch_count(),
                                    item.nonce_count - off)
                        await slots.acquire()
                        self.stats.scan_started()
                        outstanding[0] += 1
                        req_q.put(ScanRequest(
                            header76=item.header76,
                            nonce_start=item.nonce_start + off,
                            count=count, target=item.job.share_target,
                            tag=item,
                        ))
                        off += count
                finally:
                    slice_range.__exit__(None, None, None)
                    if slice_t0:
                        tel.tracer.complete(
                            "feeder_slice", slice_t0, cat="pipeline",
                            job_id=item.job.job_id,
                            nonce_start=item.nonce_start,
                        )
                    queue.task_done()

        async def widen() -> None:
            # The ring-depth handshake lands once the pump has opened the
            # stream, after the semaphore was sized: against a deeper
            # served ring the feeder would park with session_depth + 1
            # requests out while the ring holds its first result until
            # served_depth + 1 arrive. Poll for the whole session (with
            # wait_for_ready the worker may connect minutes in), fast
            # while the handshake is expected, then slowly, and widen
            # the live semaphore when the depth grows.
            seen = session_depth
            interval, elapsed = 0.25, 0.0
            while True:
                await asyncio.sleep(interval)
                elapsed += interval
                if elapsed > 6.0:
                    interval = 2.0
                new = self._refresh_stream_depth()
                if new > seen:
                    for _ in range(new - seen):
                        slots.release()
                    seen = new

        feeder = asyncio.create_task(feed(), name=f"stream-feed-{wid}")
        # Only a negotiating backend (GrpcHasher, a fleet of them) grows
        # its depth after construction; for a local card the widener
        # would poll for nothing.
        widener = (
            asyncio.create_task(widen(), name=f"stream-widen-{wid}")
            if getattr(self.hasher, "negotiates_stream_depth", False)
            else None)
        try:
            while not self._stopping:
                sres = await res_q.get()
                if sres is end:
                    break
                slots.release()
                self.stats.scan_finished()
                outstanding[0] -= 1
                item: WorkItem = sres.request.tag
                result: ScanResult = sres.result
                # The hashes were computed, so they count even when stale;
                # only the hits of a superseded job are dropped.
                self.stats.hashes += result.hashes_done
                self.stats.batches += 1
                if self.scheduler is not None:
                    # nonces, not hashes_done (× vshare): the scheduler
                    # sizes requests in nonces.
                    self.scheduler.record_result(sres.request.count)
                if self._stopping or item.generation != self._generation:
                    if not self._stopping:
                        self._stale_drop("result", item)
                    continue
                try:
                    for share in self._shares_from_result(item, result):
                        await on_share(share)
                except asyncio.CancelledError:
                    raise
                except Exception:
                    logger.exception("worker %d failed on job %s", wid,
                                     item.job.job_id)
        finally:
            feeder.cancel()
            if widener is not None:
                widener.cancel()
            req_q.put(None)  # stop the pump; it drains and exits
            await asyncio.gather(
                *[t for t in (feeder, widener) if t is not None],
                return_exceptions=True)
            for _ in range(outstanding[0]):
                self.stats.scan_finished()
            # Wait for the pump to finish the dispatches its ring holds: a
            # process that exits while a pump thread is inside a torch
            # call aborts ("terminate called without an active exception").
            await loop.run_in_executor(None, thread.join, _PUMP_JOIN_S)
            if thread.is_alive():
                logger.warning("worker %d scan pump still running after "
                               "%.0f s", wid, _PUMP_JOIN_S)
        if pump_error:
            logger.error("worker %d scan stream failed: %s — restarting "
                         "pipeline", wid, pump_error[0],
                         exc_info=pump_error[0])
            return True
        return False

    async def _mine_item(
        self, loop: asyncio.AbstractEventLoop, item: WorkItem,
        on_share: OnShare,
    ) -> None:
        """Sweep one nonce range in blocking dispatches; verify and report
        hits. Each scan is one ``device_dispatch`` span and one
        ``scan_batch`` sample."""
        tel = self.telemetry
        off = 0
        while off < item.nonce_count:
            if self._stopping or item.generation != self._generation:
                if not self._stopping:
                    self._stale_drop("item", item)
                return  # stale: a new job superseded this item
            count = min(self._next_dispatch_count(), item.nonce_count - off)
            start = item.nonce_start + off
            self.stats.scan_started()
            t0 = time.perf_counter_ns()
            try:
                result: ScanResult = await loop.run_in_executor(
                    None, self.hasher.scan, item.header76, start, count,
                    item.job.share_target,
                )
            finally:
                self.stats.scan_finished()
                if tel.enabled:
                    end = time.perf_counter_ns()
                    tel.scan_batch.observe((end - t0) / 1e9)
                    tel.tracer.complete(
                        "device_dispatch", t0, end, cat="device",
                        job_id=item.job.job_id, nonce_start=start,
                        count=count,
                    )
            self.stats.hashes += result.hashes_done
            self.stats.batches += 1
            if self.scheduler is not None:
                self.scheduler.record_result(count)
            if item.generation != self._generation:
                self._stale_drop("result", item)
                return
            for share in self._shares_from_result(item, result):
                await on_share(share)
            off += count

    def _shares_from_result(
        self, item: WorkItem, result: ScanResult
    ) -> Iterator[Share]:
        """Verified shares from one scan result: chain 0's nonces, then the
        sibling chains' hits, each through the same parity gate against its
        own sibling header (the hasher yields these only while its versions
        fit the session mask, so every such share is in the mask)."""
        for nonce in result.nonces:
            share = self._verify_hit(item, nonce)
            if share is not None:
                yield share
        for version, nonce in result.version_hits:
            share = self._verify_hit(_sibling_item(item, version), nonce)
            if share is not None:
                yield share
        if result.version_truncated:
            logger.warning(
                "sibling version hits truncated (%d stored of %d) — only "
                "plausible at absurdly easy targets",
                len(result.version_hits), result.version_total_hits)

    def _stale_drop(self, stage: str, item: WorkItem) -> None:
        """Count work a newer job superseded: an ``item`` left unsliced or a
        ``result`` whose hits are dropped."""
        self.telemetry.stale_drops.labels(stage=stage).inc()
        self.telemetry.flightrec.record(
            "stale_drop", stage=stage, job_id=item.job.job_id,
        )

    def _verify_hit(self, item: WorkItem, nonce: int) -> Optional[Share]:
        """The parity gate: full CPU sha256d against the share and block
        targets. A hit the oracle disagrees with is never submitted; a
        verified one opens the share's lifecycle record."""
        header80 = item.header76 + nonce.to_bytes(4, "little")
        tel = self.telemetry
        with tel.span("cpu_verify", cat="share", job_id=item.job.job_id,
                      nonce=f"{nonce:#010x}"), host_range("cpu_verify"):
            h = hash_to_int(self.oracle.sha256d(header80))
        if h > item.job.share_target:
            self.stats.hw_errors += 1
            logger.error(
                "backend hit FAILED CPU verification: job=%s nonce=%#010x "
                "hash=%064x target=%064x — dropping",
                item.job.job_id, nonce, h, item.job.share_target,
            )
            return None
        is_block = h <= item.job.block_target
        if self.submit_blocks_only and not is_block:
            return None  # a real hit, but this mode never submits it
        self.stats.shares_found += 1
        if is_block:
            self.stats.blocks_found += 1
            logger.warning("BLOCK FOUND: job=%s nonce=%#010x",
                           item.job.job_id, nonce)
        if tel.lifecycle.enabled:
            tel.lifecycle.found(
                share_key(item.job.job_id, item.extranonce2, nonce),
                job_id=item.job.job_id, nonce=nonce,
                trace=tel.tracer.current_trace(),
                generation=item.generation, is_block=is_block,
                sched_nonces=int(
                    getattr(tel.batch_nonces, "value", 0) or 0
                ),
            )
        version = item.version if item.version is not None else item.job.version
        return Share(
            job_id=item.job.job_id,
            extranonce2=item.extranonce2,
            ntime=item.ntime,
            nonce=nonce,
            header80=header80,
            hash_int=h,
            is_block=is_block,
            version_bits=(
                version & item.job.version_mask
                if item.job.version_mask else None
            ),
        )

    # ----------------------------------------------------- synchronous path
    def sweep(
        self,
        job: Job,
        extranonce2: bytes = b"",
        nonce_start: int = 0,
        nonce_count: int = NONCE_SPACE,
        max_shares: Optional[int] = None,
    ) -> List[Share]:
        """Scan one range without an event loop, verify its hits and
        return the shares (at most ``max_shares``). The range is sliced
        into requests of the scheduler's size (else ``batch_size``) and
        driven through the hasher's ``scan_stream``, so a ring stays full
        across the sweep. A request is busy from the moment the ring pulls
        it until its result returns, so overlapped dispatches keep one
        busy interval; a sweep cut by ``max_shares`` closes the stream
        (the ring gives back what it held) and the busy interval of every
        dispatch still outstanding."""
        job = _with_generation(job, self._generation)
        header76 = job.header76(extranonce2)
        shares: List[Share] = []
        item_gen = self._generation
        outstanding = [0]

        def requests() -> Iterator[ScanRequest]:
            off = 0
            while off < nonce_count:
                count = min(self._next_dispatch_count(), nonce_count - off)
                self.stats.scan_started()
                outstanding[0] += 1
                yield ScanRequest(
                    header76=header76, nonce_start=nonce_start + off,
                    count=count, target=job.share_target)
                off += count

        stream = iter_scan_stream(self.hasher, requests())
        try:
            for sres in stream:
                self.stats.scan_finished()
                outstanding[0] -= 1
                result = sres.result
                self.stats.hashes += result.hashes_done
                self.stats.batches += 1
                if self.scheduler is not None:
                    # nonces, not hashes_done (× vshare)
                    self.scheduler.record_result(sres.request.count)
                item = WorkItem(
                    item_gen, job, extranonce2, header76,
                    sres.request.nonce_start, sres.request.count,
                    ntime=job.ntime)
                # Every hit of the result is verified before a cut, so
                # shares_found and hw_errors count the whole result.
                shares.extend(self._shares_from_result(item, result))
                if max_shares is not None and len(shares) >= max_shares:
                    return shares[:max_shares]
        finally:
            stream.close()
            for _ in range(outstanding[0]):
                self.stats.scan_finished()
        return shares


def _with_generation(job: Job, generation: int) -> Job:
    if job.generation == generation:
        return job
    return dataclasses.replace(job, generation=generation)


def _sibling_item(item: WorkItem, version: int) -> WorkItem:
    """The work item as a sibling chain saw it: the same job and range,
    the header with the sibling's version in bytes 0-3 (little-endian), so
    that ``_verify_hit`` derives hash, targets and version bits from the
    sibling header as it does for chain 0."""
    return dataclasses.replace(
        item, header76=version.to_bytes(4, "little") + item.header76[4:],
        version=version)
