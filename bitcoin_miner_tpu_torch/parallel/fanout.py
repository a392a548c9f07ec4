"""Per-device dispatch fan-out: whole requests round-robined to per-device
hashers, instead of every dispatch sharded over the devices.

Counterpart of ``bitcoin_miner_tpu/parallel/fanout.py``. The sharded
backends (``parallel/mesh.py``) split every dispatch over all devices and
wait for all of them; the fan-out sends each :class:`ScanRequest` whole to
one device's own dispatch ring, so the devices run independently: a slow
or wedged device delays only its own requests, and a request's hits come
from one device, with nothing to merge across devices. The sharded scan
finishes one large range soonest; the fan-out suits the miner's
request-parallel pipeline.

:class:`FanoutHasher` takes any list of ``Hasher`` children (the tests
drive it with CPU oracles); :func:`make_cuda_fanout` builds one
``CudaHasher`` or ``TileCudaHasher`` per device, each built and driven
under ``torch.cuda.device(dev)``.

Per-card telemetry, at the fan-out seam so any child gets the same
labels: each request assigned counts ``chip_inflight{chip}`` up, each
result collected counts it down and ``chip_dispatches{chip}`` up (the
health model's per-card stall rule reads that pair), and a child's error
leaves a ``chip_error`` flight-recorder event. The pump threads adopt
the caller's trace id, so a card's ring spans join the caller's trace.
"""

from __future__ import annotations

import contextlib
import logging
import queue as thread_queue
import threading
from collections import deque
from functools import partial
from typing import (
    Any,
    Callable,
    ContextManager,
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
    ScanResult,
    StreamResult,
    iter_scan_stream,
)
from ..telemetry import TelemetryBound
from .ranges import split_range

logger = logging.getLogger(__name__)


class MultiChildError(RuntimeError):
    """Several children of one parallel scan failed: every error, each
    with its child's label, in one exception (``errors``), so that a
    failure of several devices at once is not reported as one."""

    def __init__(self, errors: Sequence[Tuple[str, BaseException]]) -> None:
        self.errors = list(errors)
        detail = "; ".join(f"chip {label}: {type(e).__name__}: {e}"
                           for label, e in self.errors)
        super().__init__(
            f"{len(self.errors)} fan-out children failed: {detail}")


class FanoutHasher(TelemetryBound, Hasher):
    """Round-robins whole scan requests across N child hashers.

    ``scan`` splits one range into N contiguous slices swept concurrently,
    one thread per child, merged on the host. ``scan_stream`` is the hot
    path: requests are dealt round-robin to per-child pump threads, each
    driving its child's own ``scan_stream``, and results are yielded
    strictly in request order (the seam's contract)."""

    name = "fanout"
    scan_releases_gil = True

    def __init__(
        self,
        children: Sequence[Hasher],
        contexts: Optional[
            Sequence[Optional[Callable[[], ContextManager[Any]]]]] = None,
    ) -> None:
        if not children:
            raise ValueError("fan-out needs at least one child hasher")
        self.children: List[Hasher] = list(children)
        #: per-child context-manager factory entered around every device
        #: interaction (``torch.cuda.device(dev)`` makes a child's device
        #: the current one); None entries need none.
        self._contexts = (list(contexts) if contexts is not None
                          else [None] * len(self.children))
        if len(self._contexts) != len(self.children):
            raise ValueError("contexts must match children 1:1")
        self.n_children = len(self.children)
        #: each child's label for errors and thread names: its own
        #: ``chip_label`` (set by :func:`make_cuda_fanout`), else its index.
        self.chip_labels: List[str] = [
            str(getattr(c, "chip_label", None) or i)
            for i, c in enumerate(self.children)]
        # A child ring yields its first result once child_depth+1 requests
        # reach it, which takes n_children * child_depth + 1 fan-out
        # requests: advertise the depth that keeps every ring full.
        child_depth = max(int(getattr(c, "stream_depth", 0) or 0)
                          for c in self.children)
        self.stream_depth = self.n_children * (child_depth + 1) - 1
        #: scheduler granularity: one child's dispatch (requests go whole
        #: to one device, so no n_devices multiplier).
        sizes = [int(getattr(c, "dispatch_size", None)
                     or getattr(c, "batch_size", 0) or 0)
                 for c in self.children]
        if max(sizes):
            self.dispatch_size = max(sizes)

    def _ctx(self, i: int) -> ContextManager[Any]:
        cm = self._contexts[i]
        return cm() if cm is not None else contextlib.nullcontext()

    # ------------------------------------------------------------------ cold
    def sha256d(self, data: bytes) -> bytes:
        with self._ctx(0):
            return self.children[0].sha256d(data)

    # ------------------------------------------------------- vshare plumbing
    def set_version_mask(self, mask: int) -> int:
        """Forward the session mask to every child; they share one
        configuration, so every reserved count agrees: return it."""
        reserved = 0
        for i, child in enumerate(self.children):
            setter = getattr(child, "set_version_mask", None)
            if setter is not None:
                with self._ctx(i):
                    reserved = setter(mask)
        return reserved

    @property
    def version_roll_bits(self) -> int:
        return int(getattr(self.children[0], "version_roll_bits", 0))

    # ------------------------------------------------------------------- hot
    def scan(
        self,
        header76: bytes,
        nonce_start: int,
        count: int,
        target: int,
        max_hits: int = 64,
    ) -> ScanResult:
        """One blocking range, split into contiguous per-child slices swept
        concurrently (one thread each: device work releases the GIL); the
        merge is a host-side sort of the children's hit lists. Every
        child's error is reported, with its label."""
        self._check_range(header76, nonce_start, count)
        slices = [(i, start, n) for i, (start, n) in enumerate(
            split_range(nonce_start, count, self.n_children)) if n]
        results: List[Optional[ScanResult]] = [None] * len(slices)
        errors: List[Tuple[str, BaseException]] = []

        def run(slot: int, child_i: int, start: int, n: int) -> None:
            try:
                with self._ctx(child_i):
                    results[slot] = self.children[child_i].scan(
                        header76, start, n, target, max_hits)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append((self.chip_labels[child_i], e))

        if len(slices) == 1:
            run(0, *slices[0])
        else:
            threads = [
                threading.Thread(target=run, args=(slot, i, start, n),
                                 name=f"fanout-scan-{self.chip_labels[i]}",
                                 daemon=True)
                for slot, (i, start, n) in enumerate(slices)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if errors:
            for label, e in errors:
                self.telemetry.flightrec.record(
                    "chip_error", chip=label,
                    error=f"{type(e).__name__}: {e}"[:200])
            if len(errors) == 1:
                raise errors[0][1]
            raise MultiChildError(errors)
        merged = [r for r in results if r is not None]
        return ScanResult(
            nonces=sorted(n for r in merged for n in r.nonces)[:max_hits],
            total_hits=sum(r.total_hits for r in merged),
            hashes_done=sum(r.hashes_done for r in merged),
            version_hits=[vh for r in merged for vh in r.version_hits],
            version_total_hits=sum(r.version_total_hits for r in merged))

    # ------------------------------------------------------------ streaming
    def scan_stream(self, requests: Iterable[Any]) -> Iterator[StreamResult]:
        """The fan-out hot path: request k goes whole to child k mod N.

        One pump thread per child drives that child's ``scan_stream`` off
        a per-child queue; results come back in global request order by
        walking the assignment FIFO, since each child answers in its own
        request order. A ``STREAM_FLUSH`` goes to every child, and the
        whole FIFO is drained before the next request is pulled: nothing
        may wait completed but unyielded while the source idles. A child's
        error is raised at its request's position."""
        req_qs: List[thread_queue.SimpleQueue] = [
            thread_queue.SimpleQueue() for _ in range(self.n_children)]
        res_qs: List[thread_queue.SimpleQueue] = [
            thread_queue.SimpleQueue() for _ in range(self.n_children)]
        end = object()
        tel = self.telemetry
        chip_inflight = [tel.chip_inflight.labels(chip=label)
                         for label in self.chip_labels]
        chip_dispatches = [tel.chip_dispatches.labels(chip=label)
                           for label in self.chip_labels]
        # The trace id is thread-local: each pump re-enters the caller's.
        inherited_trace = tel.tracer.current_trace()

        def pump(i: int) -> None:
            def feed() -> Iterator[Any]:
                while True:
                    req = req_qs[i].get()
                    if req is None:
                        return
                    yield req

            try:
                with tel.tracer.context(inherited_trace), self._ctx(i):
                    for sres in iter_scan_stream(self.children[i], feed()):
                        res_qs[i].put(sres)
            except BaseException as e:  # noqa: BLE001 — reported in order
                res_qs[i].put(e)
            res_qs[i].put(end)

        threads = [
            threading.Thread(target=pump, args=(i,),
                             name=f"fanout-pump-{self.chip_labels[i]}",
                             daemon=True)
            for i in range(self.n_children)]
        for t in threads:
            t.start()

        fifo: deque = deque()
        next_child = 0

        def collect_oldest() -> StreamResult:
            child = fifo.popleft()
            got = res_qs[child].get()
            chip_inflight[child].dec()
            if got is end or isinstance(got, BaseException):
                error = (f"{type(got).__name__}: {got}"[:200]
                         if got is not end else "stream ended early")
                tel.flightrec.record("chip_error",
                                     chip=self.chip_labels[child],
                                     error=error)
                if got is end:
                    raise RuntimeError(
                        f"fan-out child {child} ended its stream early")
                raise got
            chip_dispatches[child].inc()
            return got

        try:
            for req in requests:
                if req is STREAM_FLUSH:
                    for q in req_qs:
                        q.put(STREAM_FLUSH)
                    while fifo:
                        yield collect_oldest()
                    continue
                req_qs[next_child].put(req)
                fifo.append(next_child)
                chip_inflight[next_child].inc()
                next_child = (next_child + 1) % self.n_children
                while len(fifo) > self.stream_depth:
                    yield collect_oldest()
            for q in req_qs:
                q.put(None)  # end of stream: children drain their rings
            while fifo:
                yield collect_oldest()
        finally:
            for q in req_qs:
                q.put(None)  # idempotent stop for abandoned streams
            # Requests assigned and never collected give their in-flight
            # count back.
            while fifo:
                chip_inflight[fifo.popleft()].dec()

    def close(self) -> None:
        for child in self.children:
            close = getattr(child, "close", None)
            if close is not None:
                close()


def make_cuda_fanout(
    n_devices: Optional[int] = None,
    batch_per_device: int = 1 << 24,
    inner_size: int = 1 << 18,
    max_hits: int = 64,
    unroll: int = 64,
    spec: bool = True,
    vshare: int = 1,
    kernel: str = "cuda",
    sublanes: int = 8,
    inner_tiles: int = 8,
    interleave: int = 1,
    variant: str = "baseline",
    cgroup: int = 0,
    devices: Optional[Sequence] = None,
    labels: Optional[Sequence[str]] = None,
) -> FanoutHasher:
    """One single-device hasher per device, each built and driven under
    ``torch.cuda.device(dev)``: no sharding, nothing across devices.
    ``kernel`` picks the child: ``"cuda"`` (``CudaHasher``, the hit-buffer
    kernel) or ``"cuda-tile"`` (``TileCudaHasher`` with the layout and
    geometry options). ``devices`` is an explicit device list (the
    mesh-native ladder hands the survivors of a quarantine here), else the
    first ``n_devices`` cards (``parallel.mesh.make_mesh``); ``labels``
    name the children (default: their positions in the list)."""
    from ..backends.cuda import CudaHasher, TileCudaHasher
    from .mesh import make_mesh

    if kernel not in ("cuda", "cuda-tile"):
        raise ValueError(f"unknown fanout kernel {kernel!r}")
    chosen = make_mesh(n_devices, devices)
    if labels is None:
        labels = [str(i) for i in range(len(chosen))]
    if len(labels) != len(chosen):
        raise ValueError("labels must match devices 1:1")
    children: List[Hasher] = []
    contexts: List[Optional[Callable[[], ContextManager[Any]]]] = []
    for dev, label in zip(chosen, labels):
        context = (partial(torch.cuda.device, dev) if dev.type == "cuda"
                   else None)
        with context() if context is not None else contextlib.nullcontext():
            if kernel == "cuda-tile":
                child: Hasher = TileCudaHasher(
                    batch_size=batch_per_device, sublanes=sublanes,
                    inner_tiles=inner_tiles, interleave=interleave,
                    max_hits=max_hits, vshare=vshare, variant=variant,
                    cgroup=cgroup, device=dev, unroll=unroll, spec=spec)
            else:
                child = CudaHasher(
                    batch_size=batch_per_device, inner_size=inner_size,
                    max_hits=max_hits, vshare=vshare, device=dev,
                    unroll=unroll, spec=spec)
        child.chip_label = label  # type: ignore[attr-defined]
        children.append(child)
        contexts.append(context)
    fanout = FanoutHasher(children, contexts)
    fanout.name = "cuda-fanout"
    logger.info("cuda-fanout: %d per-device dispatch rings (%s children, "
                "batch_per_device=%d)", len(children), kernel,
                batch_per_device)
    return fanout
