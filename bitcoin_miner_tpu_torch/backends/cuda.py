"""CUDA hasher backends — the device side of the ``Hasher`` seam.

Counterpart of ``bitcoin_miner_tpu/backends/tpu.py``. The host packs the
per-job constants once (midstate, round-3 state, header tail, target
limbs; LRU-cached), then streams fixed-size dispatches to the card; each
returns a few hundred bytes.

Async dispatch does not come free as it does under JAX: a ``.cpu()``
readback waits for everything queued on the stream, including dispatches
queued after the one being read. So each dispatch uploads its job words
from pinned memory without blocking, launches its kernels on the current
stream, copies its outputs into pinned host memory without blocking and
records a CUDA event; collecting it waits on that event alone. The ring
in :meth:`CudaHasher.scan_stream` therefore keeps dispatch k+1 (and up to
``stream_depth``) queued while the host reads and verifies dispatch k.

Several dispatcher pump threads share one hasher: launches from all of
them go to the current stream in the order they are made, each collect
waits on its own event, and the per-job constants cache has a lock.

``device="cpu"`` runs every kernel's plain PyTorch version synchronously
— the tests' path. With no card and no such request the hashers raise.
"""

from __future__ import annotations

import logging
import struct
import threading
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.sha256 import (
    SHA256_IV,
    _sha256_pad,
    sha256_midstate,
    sha256_rounds,
    sha256d_from_midstate,
)
from ..core.target import target_to_limbs
from ..ops.sha256_tile import scan_tile
from ..ops.sha256_torch import compress, scan_batch
from .base import (
    Hasher,
    STREAM_FLUSH,
    ScanRequest,
    ScanResult,
    StreamResult,
    register_hasher,
)

logger = logging.getLogger(__name__)

_LATER_SLICE = "is not ported yet; it waits for a later slice of the port"


def resolve_device(device: Optional[str]) -> torch.device:
    """The device a hasher runs on: the card unless the caller asks for
    the CPU. Asking for a card that is not there raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


@dataclass(frozen=True)
class JobConstants:
    """One job's device constants, as host words."""

    midstate: np.ndarray  # (8,) chunk-1 midstate
    state3: np.ndarray    # (8,) registers after chunk-2 rounds 0-2
    tail3: np.ndarray     # (3,) header[64:76], big-endian words
    limbs: np.ndarray     # (8,) target limbs, most significant first

    @property
    def word7(self) -> bool:
        """Early reject pays only when candidates are almost never: a top
        target limb of 0 (any share difficulty ≥ 1) makes them ≤ 2^-32 per
        nonce, so re-verifying them exactly is free."""
        return int(self.limbs[0]) == 0


class _Dispatch:
    """One queued dispatch: its outputs on their way to host memory,
    behind an event. On the CPU the outputs are already there."""

    def __init__(self, outputs: Sequence[torch.Tensor]) -> None:
        device = outputs[0].device
        if device.type == "cuda":
            self._host = [t.to("cpu", non_blocking=True) for t in outputs]
            # A blocking event: pump threads sleep in the wait instead of
            # spinning on the host cores the event loop needs.
            self._event: Optional[torch.cuda.Event] = torch.cuda.Event(
                blocking=True)
            self._event.record(torch.cuda.current_stream(device))
        else:
            self._host = list(outputs)
            self._event = None

    def result(self) -> List[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [t.numpy() for t in self._host]


def _upload(words: Sequence[int], device: torch.device) -> torch.Tensor:
    """uint32 words on ``device``: from pinned memory without blocking on
    the card (the caching host allocator keeps the pinned block until the
    copy has run)."""
    host = torch.from_numpy(np.asarray(words, dtype=np.uint32))
    if device.type == "cpu":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def _verify_candidates(candidates: List[int], jc: JobConstants
                       ) -> Tuple[List[int], int]:
    """Exact CPU re-check of word7 candidates (about one per 2^32 nonces
    at difficulty ≥ 1), so the ScanResult stays exact at every target."""
    mid = tuple(int(x) for x in jc.midstate)
    tail12 = struct.pack(">3I", *(int(x) for x in jc.tail3))
    target = 0
    for limb in jc.limbs:
        target = (target << 32) | int(limb)
    hits = [
        nonce for nonce in candidates
        if int.from_bytes(sha256d_from_midstate(mid, tail12, nonce),
                          "little") <= target
    ]
    return hits, len(hits)


class CudaHasher(Hasher):
    """The hit-buffer kernel behind the dispatch ring (``--backend cuda``).

    Each dispatch of ``batch_size`` nonces returns the first ``max_hits``
    hits and the uncapped count; at a target whose top limb is 0 the
    kernel runs in word7 mode and its candidates are re-verified on the
    CPU."""

    name = "cuda"
    scan_releases_gil = True

    #: dispatches ``scan_stream`` holds in flight before collecting the
    #: oldest: the card computes dispatch k+1 while the host reads k.
    stream_depth = 2

    #: per-job constants kept (LRU): a session alternates between at most
    #: a few live (header, target) pairs.
    _CONSTS_CAPACITY = 8

    def __init__(
        self,
        batch_size: int = 1 << 24,
        inner_size: int = 1 << 18,
        max_hits: int = 64,
        vshare: int = 1,
        device: Optional[str] = None,
    ) -> None:
        if vshare != 1:
            raise NotImplementedError(
                f"vshare={vshare} (version-rolled sibling chains) {_LATER_SLICE}")
        if batch_size % inner_size:
            raise ValueError("batch_size must be a multiple of inner_size")
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.inner_size = inner_size
        self.max_hits = max_hits
        self.version_mask = 0
        self._consts_cache: "OrderedDict[tuple, JobConstants]" = OrderedDict()
        self._consts_lock = threading.Lock()

    # ------------------------------------------------------------------ cold
    def sha256d(self, data: bytes) -> bytes:
        """Double SHA-256 of arbitrary bytes through the plain compression
        on the hasher's device (cold path)."""

        def sha256(msg: bytes) -> bytes:
            padded = msg + _sha256_pad(len(msg))
            words = torch.tensor(struct.unpack(f">{len(padded) // 4}I", padded),
                                 dtype=torch.int64, device=self.device)
            state = tuple(SHA256_IV)
            for off in range(0, words.numel(), 16):
                state = compress(state, list(words[off:off + 16]))
            return struct.pack(">8I", *(int(s) for s in state))

        return sha256(sha256(data))

    # ------------------------------------------------------------------- hot
    def scan(
        self,
        header76: bytes,
        nonce_start: int,
        count: int,
        target: int,
        max_hits: int = 64,
    ) -> ScanResult:
        """One request through the dispatch ring (:meth:`scan_stream`): the
        card runs dispatch k+1 while the host reads dispatch k."""
        req = ScanRequest(header76, nonce_start, count, target, max_hits)
        (res,) = self.scan_stream([req])
        return res.result

    def _job_constants(self, header76: bytes, target: int) -> JobConstants:
        """Per-job constants, computed once per (header76, target) and
        LRU-cached across scan and stream calls, so a dispatch's own host
        work is two words."""
        key = (header76, target)
        with self._consts_lock:
            entry = self._consts_cache.get(key)
            if entry is not None:
                self._consts_cache.move_to_end(key)
                return entry
        mid = sha256_midstate(header76[:64])
        tail = struct.unpack(">3I", header76[64:76])
        entry = JobConstants(
            midstate=np.asarray(mid, dtype=np.uint32),
            state3=np.asarray(sha256_rounds(mid, tail, 3), dtype=np.uint32),
            tail3=np.asarray(tail, dtype=np.uint32),
            limbs=np.asarray(target_to_limbs(target), dtype=np.uint32),
        )
        with self._consts_lock:
            self._consts_cache[key] = entry
            self._consts_cache.move_to_end(key)
            while len(self._consts_cache) > self._CONSTS_CAPACITY:
                self._consts_cache.popitem(last=False)
        return entry

    def _hitbuf(self, jc: JobConstants, base: int, limit: int,
                capacity: int, inner_size: int, word7: bool) -> _Dispatch:
        """Queue one hit-buffer scan of ``[base, base + limit)``."""
        words = _upload(
            [*jc.midstate, *jc.tail3, *jc.limbs, base & 0xFFFFFFFF, limit],
            self.device)
        out = scan_batch(words[0:8], words[8:11], words[11:19], words[19],
                         words[20], inner_size=inner_size,
                         n_steps=capacity // inner_size,
                         max_hits=self.max_hits, word7=word7)
        return _Dispatch(out)

    def _scan_fn(self, jc: JobConstants, base: int, limit: int) -> _Dispatch:
        return self._hitbuf(jc, base, limit, self.batch_size,
                            self.inner_size, jc.word7)

    def _warn_overflow(self, n: int) -> None:
        if n > self.max_hits:
            # Unreachable at difficulty ≥ 1 (candidates ~2^-32 per nonce):
            # a flood here means the target plumbing is wrong.
            logger.warning(
                "word7 candidate overflow: %d candidates > max_hits=%d "
                "(dropped %d)", n, self.max_hits, n - self.max_hits)

    def _collect(self, out: _Dispatch, jc: JobConstants, base: int,
                 limit: int) -> Tuple[List[int], int]:
        buf, n = out.result()
        n = int(n)
        got = [int(x) for x in buf[:min(n, self.max_hits)]]
        if not jc.word7:
            return got, n
        self._warn_overflow(n)
        return _verify_candidates(got, jc)

    # ------------------------------------------------------------ streaming
    def scan_stream(
        self, requests: Iterable[ScanRequest]
    ) -> Iterator[StreamResult]:
        """The dispatch ring: queue dispatch k+1 (up to ``stream_depth``
        ahead) before collecting dispatch k, across request, work-item and
        job boundaries. Results are those of :meth:`scan` per request, in
        request order."""
        pending: deque = deque()

        def collect_oldest() -> Optional[StreamResult]:
            out, base, limit, st = pending.popleft()
            if out is not None:
                got, n = self._collect(out, st["jc"], base, limit)
                st["hits"].extend(got)
                st["total"] += n
            st["left"] -= 1
            if st["left"] == 0:
                req = st["req"]
                hits = sorted(st["hits"])
                return StreamResult(req, ScanResult(
                    nonces=hits[:min(req.max_hits, self.max_hits)],
                    total_hits=st["total"], hashes_done=req.count))
            return None

        def drain(depth: int) -> Iterator[StreamResult]:
            while len(pending) > depth:
                res = collect_oldest()
                if res is not None:
                    yield res

        for req in requests:
            if req is STREAM_FLUSH:
                # The caller is about to idle: finish everything in flight
                # now, so no hit waits in the ring and goes stale.
                yield from drain(0)
                continue
            self._check_range(req.header76, req.nonce_start, req.count)
            st = {"req": req, "hits": [], "total": 0,
                  "left": max(1, -(-req.count // self.batch_size))}
            if req.count == 0:
                # An empty range still owes its result in order: it rides
                # the FIFO as an entry without a dispatch.
                pending.append((None, req.nonce_start, 0, st))
                yield from drain(self.stream_depth)
                continue
            st["jc"] = self._job_constants(req.header76, req.target)
            off = 0
            while off < req.count:
                limit = min(self.batch_size, req.count - off)
                base = req.nonce_start + off
                pending.append((self._scan_fn(st["jc"], base, limit), base,
                                limit, st))
                off += limit
                yield from drain(self.stream_depth)
        yield from drain(0)

    @property
    def version_roll_bits(self) -> int:
        """Mask bits the kernel rolls itself: none while vshare is 1."""
        return 0

    def set_version_mask(self, mask: int) -> int:
        """Adopt the session's negotiated BIP 310 mask; returns
        :attr:`version_roll_bits`, which stays 0 at vshare 1, so the host
        keeps every mask bit for its own version-roll axis."""
        self.version_mask = mask
        return self.version_roll_bits


class TileCudaHasher(CudaHasher):
    """The tile kernel behind the dispatch ring (``--backend cuda-tile``,
    the default).

    Each dispatch returns one (count, lowest nonce) pair per step of
    ``block`` nonces. At real share difficulties a step almost never holds
    two hits, so the mins are the hits; a step reporting more than one
    hit, or a word7 candidate, is re-enumerated exactly by the hit-buffer
    kernel over that step alone."""

    name = "cuda-tile"

    def __init__(
        self,
        batch_size: int = 1 << 24,
        block: int = 8192,
        max_hits: int = 64,
        vshare: int = 1,
        variant: str = "baseline",
        device: Optional[str] = None,
    ) -> None:
        if variant != "baseline":
            raise NotImplementedError(
                f"kernel variant {variant!r} {_LATER_SLICE}")
        block = min(block, batch_size)
        if block % 256 or batch_size % block:
            raise ValueError(
                f"block={block} must be a multiple of 256 dividing "
                f"batch_size={batch_size}")
        rescan_inner = min(block, 1 << 10)
        super().__init__(batch_size=batch_size, inner_size=rescan_inner,
                         max_hits=max_hits, vshare=vshare, device=device)
        #: nonces per step: the re-enumeration granularity.
        self.tile = block

    def _scan_fn(self, jc: JobConstants, base: int, limit: int) -> _Dispatch:
        job = _upload([*jc.midstate, *jc.state3, *jc.tail3, *jc.limbs,
                       base & 0xFFFFFFFF, limit], self.device)
        return _Dispatch(scan_tile(job, n_steps=self.batch_size // self.tile,
                                   block=self.tile, word7=jc.word7))

    def _collect(self, out: _Dispatch, jc: JobConstants, base: int,
                 limit: int) -> Tuple[List[int], int]:
        counts, mins = out.result()
        hits: List[int] = []
        total = 0
        for step in np.nonzero(counts)[0]:
            step = int(step)
            if not jc.word7 and int(counts[step]) == 1:
                got, n = [int(mins[step])], 1  # a single hit IS the min
            else:
                got, n = self._rescan_tile(
                    jc, base + step * self.tile,
                    min(self.tile, limit - step * self.tile))
            hits.extend(got)
            total += n
        return hits, total

    def _rescan_tile(self, jc: JobConstants, tile_base: int,
                     tile_limit: int) -> Tuple[List[int], int]:
        """Exact (hits, uncapped count) of one step's range, through the
        hit-buffer kernel at the step's size."""
        buf, n = self._hitbuf(jc, tile_base, tile_limit, self.tile,
                              self.inner_size, word7=False).result()
        n = int(n)
        return [int(x) for x in buf[:min(n, self.max_hits)]], n


register_hasher("cuda", CudaHasher)
register_hasher("cuda-tile", TileCudaHasher)
