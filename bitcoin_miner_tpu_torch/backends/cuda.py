"""CUDA hasher backends — the device side of the ``Hasher`` seam.

Counterpart of ``bitcoin_miner_tpu/backends/tpu.py``. The host packs the
per-job constants once (midstate, round-3 state, header tail, target
limbs; LRU-cached), then streams fixed-size dispatches to the card; each
returns a few hundred bytes.

With ``vshare`` = k > 1 (overt AsicBoost) every nonce is hashed against k
version-rolled sibling headers, whose versions xor the job's own with
patterns inside the session's BIP 310 mask (:func:`sibling_version_patterns`):
the kernels share one chunk-2 message schedule across the k chains, chain
0 is the caller's header, and the siblings' hits come back as
``ScanResult.version_hits``. A mask too narrow for k chains (mask 0: the
pool granted no rolling) degrades the hasher to chain 0 alone, through the
one-chain kernels.

Async dispatch does not come free as it does under JAX: a ``.cpu()``
readback waits for everything queued on the stream, including dispatches
queued after the one being read. So each dispatch uploads its job words
from pinned memory without blocking, launches its kernels on the current
stream, copies its outputs into pinned host memory without blocking and
records a CUDA event on each device it ran on; collecting it waits on
those events alone. The ring in :meth:`CudaHasher.scan_stream` therefore
keeps dispatch k+1 (and up to ``stream_depth``) queued while the host
reads and verifies dispatch k.

:class:`ShardedCudaHasher` (``cuda-mesh``) and :class:`ShardedTileCudaHasher`
(``cuda-tile-mesh``) ride the same ring with dispatches sharded over
several devices (``parallel/mesh.py``): one dispatch is
``batch_per_device × n_devices`` nonces (``dispatch_size``), each shard's
job words go to its own device, and the shards' outputs merge on the host.

Several dispatcher pump threads share one hasher: launches from all of
them go to the current stream in the order they are made, each collect
waits on its own event, and the per-job constants cache has a lock.

The ring reports into the process telemetry bundle (``TelemetryBound``):
``consts_cache{result}`` per lookup, ``ring_occupancy`` as deltas (every
pump's ring shares the one gauge), and per dispatch collected the
``ring_collect`` histogram and span (the blocking wait, on the tile path
the dispatch's rescans included), the ``scan_batch`` histogram and the
``device_dispatch`` span (host enqueue to collect end), the spans with
``nonce_start``, ``count`` and, on a fan-out child, ``chip``. The host
clock is read around the event wait that is there anyway: no telemetry
call waits on the card.

``device="cpu"`` runs every kernel's plain PyTorch version synchronously
— the tests' path. With no card and no such request the hashers raise.
"""

from __future__ import annotations

import logging
import struct
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.sha256 import SHA256_IV, _sha256_pad, sha256d_from_midstate
from ..ops.csrc import MAX_VSHARE, form_defines
from ..ops.sha256_tile import (
    LANES,
    check_layout,
    check_plane,
    job_words,
    scan_tile,
)
from ..ops.sha256_torch import (
    HITBUF_SPEC_ONLY,
    compress,
    rescan_steps,
    scan_batch_vshare,
    upload_words,
)
from ..parallel.mesh import (
    ShardedScan,
    make_mesh,
    make_sharded_scan_fn,
    make_sharded_scan_fn_vshare,
    make_sharded_tile_scan_fn,
    merge_device_hits,
)
from ..telemetry import TelemetryBound
from .base import (
    Hasher,
    STREAM_FLUSH,
    ScanRequest,
    ScanResult,
    StreamResult,
    register_hasher,
)

logger = logging.getLogger(__name__)

#: The standard full BIP 310 version-rolling mask (bits 13-28): the bench's
#: mask; a mining session replaces it with the pool's through
#: :meth:`CudaHasher.set_version_mask`.
DEFAULT_VERSION_MASK = 0x1FFFE000


def sibling_version_patterns(mask: int, k: int) -> List[int]:
    """k-1 distinct nonzero version-xor patterns inside ``mask``: sibling
    chain c's pattern is c's binary digits spread onto the mask's lowest
    set bit positions, so every sibling version stays inside the
    negotiated mask (on the default mask, ``c << 13``). Raises ValueError
    when the mask has too few bits for k distinct chains."""
    bits = [i for i in range(32) if (mask >> i) & 1]
    need = max(1, (k - 1).bit_length())
    if len(bits) < need:
        raise ValueError(
            f"version mask {mask:#010x} has {len(bits)} rollable bits; "
            f"vshare={k} needs {need}")
    return [sum(1 << bits[i] for i in range(need) if (c >> i) & 1)
            for c in range(1, k)]


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
    """One job's device constants, as host words, for the chains a hasher
    mines: row c of ``midstates``/``state3s`` is chain c, the header with
    version ``versions[c]`` (row 0 the header's own). One row when the
    hasher runs one chain, or when the mask cannot carry its siblings."""

    midstates: np.ndarray  # (k, 8) chunk-1 midstates
    state3s: np.ndarray    # (k, 8) registers after chunk-2 rounds 0-2
    tail3: np.ndarray      # (3,) header[64:76], big-endian words
    limbs: np.ndarray      # (8,) target limbs, most significant first
    versions: Tuple[int, ...]

    @classmethod
    def build(cls, header76: bytes, target: int,
              versions: Sequence[int]) -> "JobConstants":
        k = len(versions)
        words = job_words(header76, target, versions)
        return cls(midstates=words[:8 * k].reshape(k, 8),
                   state3s=words[8 * k:16 * k].reshape(k, 8),
                   tail3=words[16 * k:16 * k + 3],
                   limbs=words[16 * k + 3:], versions=tuple(versions))

    @property
    def chains(self) -> int:
        """Chains hashed per nonce: the hashes each nonce counts for."""
        return len(self.versions)

    def block(self, base: int, limit: int) -> np.ndarray:
        """The tile kernel's job block of these chains for the dispatch
        ``[base, base + limit)``."""
        return np.concatenate([
            self.midstates.ravel(), self.state3s.ravel(), self.tail3,
            self.limbs,
            np.asarray([base & 0xFFFFFFFF, limit], dtype=np.uint32)])

    @property
    def word7(self) -> bool:
        """Early reject pays only when candidates are almost never: a top
        target limb of 0 (any share difficulty ≥ 1) makes them ≤ 2^-32 per
        nonce, so re-verifying them exactly is free."""
        return int(self.limbs[0]) == 0


@dataclass
class _Found:
    """The hits of one request, summed over its dispatches: chain 0's (the
    request's own header) and the sibling chains' as (version, nonce)."""

    hits: List[int] = field(default_factory=list)
    total: int = 0
    version_hits: List[Tuple[int, int]] = field(default_factory=list)
    version_total: int = 0

    def add(self, jc: JobConstants, chain: int, got: List[int],
            n: int) -> None:
        """Record chain ``chain``'s verified hits ``got`` and its uncapped
        count ``n``."""
        if chain == 0:
            self.hits.extend(got)
            self.total += n
        else:
            self.version_hits.extend((jc.versions[chain], g) for g in got)
            self.version_total += n


class _Dispatch:
    """One queued dispatch: its outputs on their way to host memory,
    behind one event per card they lie on (a sharded dispatch spans
    several). Outputs on the CPU are already there. ``mesh`` is the tuple
    of devices a sharded dispatch was launched on, in shard order: the
    hasher's mesh may be rebuilt before the dispatch is collected. ``job``
    is the job block its kernels read, kept on its device for the
    dispatch's rescans (None where each shard had its own)."""

    def __init__(self, outputs: Sequence[torch.Tensor],
                 mesh: Tuple[torch.device, ...] = (),
                 job: Optional[torch.Tensor] = None) -> None:
        self.mesh = mesh
        self.job = job
        self._host = []
        devices: List[torch.device] = []
        for t in outputs:
            if t.device.type == "cuda":
                # On the current stream of the tensor's card.
                self._host.append(t.to("cpu", non_blocking=True))
                if t.device not in devices:
                    devices.append(t.device)
            else:
                self._host.append(t)
        self._events: Dict[torch.device, torch.cuda.Event] = {}
        for device in devices:
            # A blocking event: pump threads sleep in the wait instead of
            # spinning on the host cores the event loop needs.
            event = self._events[device] = torch.cuda.Event(blocking=True)
            event.record(torch.cuda.current_stream(device))

    def event(self, device: torch.device) -> Optional[torch.cuda.Event]:
        """The event behind the dispatch's work on ``device``, if any."""
        return self._events.get(device)

    def result(self) -> List[np.ndarray]:
        for event in self._events.values():
            event.synchronize()
        return [t.numpy() for t in self._host]


def _verify_candidates(candidates: List[int], jc: JobConstants, chain: int
                       ) -> Tuple[List[int], int]:
    """Exact CPU re-check of chain ``chain``'s word7 candidates (about one
    per 2^32 nonces at difficulty ≥ 1), against its own midstate, so the
    ScanResult stays exact at every target."""
    mid = tuple(int(x) for x in jc.midstates[chain])
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


class CudaHasher(TelemetryBound, Hasher):
    """The hit-buffer kernel behind the dispatch ring (``--backend cuda``).

    Each dispatch of ``batch_size`` nonces returns, per chain, the first
    ``max_hits`` hits and the uncapped count; at a target whose top limb
    is 0 the kernel runs in word7 mode and its candidates are re-verified
    on the CPU against their chain's own midstate. ``unroll`` and ``spec``
    choose the kernels' compile form (``csrc.form_defines``); at vshare > 1
    the hit-buffer scan has only spec forms."""

    name = "cuda"
    scan_releases_gil = True

    #: Whether dispatches scan through the hit-buffer kernel, whose k-chain
    #: forms all partially evaluate (the tile hasher's rescans are one
    #: chain each, in any form).
    hitbuf_scan = True

    #: dispatches ``scan_stream`` holds in flight before collecting the
    #: oldest: the card computes dispatch k+1 while the host reads k.
    stream_depth = 2

    #: per-job constants kept (LRU): a session alternates between at most
    #: a few live (header, target, mask) triples.
    _CONSTS_CAPACITY = 8

    #: the card's label on a fan-out child (``make_cuda_fanout``): the
    #: ring's spans carry it as ``chip``. None on a standalone hasher.
    chip_label: Optional[str] = None

    def __init__(
        self,
        batch_size: int = 1 << 24,
        inner_size: int = 1 << 18,
        max_hits: int = 64,
        vshare: int = 1,
        device: Optional[str] = None,
        unroll: int = 64,
        spec: bool = True,
    ) -> None:
        if batch_size % inner_size:
            raise ValueError("batch_size must be a multiple of inner_size")
        self._vshare = max(1, vshare)
        if self._vshare > MAX_VSHARE:
            raise ValueError(f"vshare={vshare}: the kernels are built for at "
                             f"most {MAX_VSHARE} chains")
        form_defines(unroll, spec)  # checks unroll
        if self.hitbuf_scan and self._vshare > 1 and not spec:
            raise ValueError(HITBUF_SPEC_ONLY)
        self.unroll = unroll
        self.spec = spec
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.inner_size = inner_size
        self.max_hits = max_hits
        self.version_mask = DEFAULT_VERSION_MASK
        self._siblings_ok = True
        self._consts_cache: "OrderedDict[tuple, JobConstants]" = OrderedDict()
        self._consts_lock = threading.Lock()
        #: dispatches launched but never collected, because their stream was
        #: abandoned (its consumer went away, or the ring raised).
        self.dispatches_abandoned = 0

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
        """Per-job constants, computed once per (header76, target, mask)
        and LRU-cached across scan and stream calls, so a dispatch's own
        host work is two words. The mask is read once: a scan racing
        :meth:`set_version_mask` builds every chain from that one reading,
        and its entry is not cached unless the mask still holds."""
        mask = self.version_mask
        key = self._consts_key(header76, target, mask)
        with self._consts_lock:
            entry = self._consts_cache.get(key)
            if entry is not None:
                self._consts_cache.move_to_end(key)
                self.telemetry.consts_cache.labels(result="hit").inc()
                return entry
        self.telemetry.consts_cache.labels(result="miss").inc()
        version = int.from_bytes(header76[:4], "little")
        entry = JobConstants.build(header76, target,
                                   self._chain_versions(version, mask))
        if self.version_mask == mask:
            with self._consts_lock:
                self._consts_cache[key] = entry
                self._consts_cache.move_to_end(key)
                while len(self._consts_cache) > self._CONSTS_CAPACITY:
                    self._consts_cache.popitem(last=False)
        return entry

    def _consts_key(self, header76: bytes, target: int, mask: int) -> tuple:
        return (header76, target, mask)

    def _chain_versions(self, version: int, mask: int) -> Tuple[int, ...]:
        """The versions of the chains mined under ``mask``: the header's
        own, then ``vshare - 1`` siblings inside the mask — or the header's
        own alone when the mask cannot carry them (degraded)."""
        if self._vshare == 1:
            return (version,)
        try:
            patterns = sibling_version_patterns(mask or 0, self._vshare)
        except ValueError:
            return (version,)
        return (version, *(version ^ p for p in patterns))

    def _scan_fn(self, jc: JobConstants, base: int, limit: int) -> _Dispatch:
        """Queue the hit-buffer scan of ``[base, base + limit)`` for every
        chain of ``jc``."""
        k = jc.chains
        words = upload_words([*jc.midstates.ravel(), *jc.tail3, *jc.limbs,
                              base & 0xFFFFFFFF, limit], self.device)
        return _Dispatch(scan_batch_vshare(
            words[:8 * k].view(k, 8), words[8 * k:8 * k + 3],
            words[8 * k + 3:8 * k + 11], words[8 * k + 11],
            words[8 * k + 12], inner_size=self.inner_size,
            n_steps=self.batch_size // self.inner_size,
            max_hits=self.max_hits, word7=jc.word7, unroll=self.unroll,
            spec=self.spec))

    def _warn_overflow(self, n: int) -> None:
        if n > self.max_hits:
            # Unreachable at difficulty ≥ 1 (candidates ~2^-32 per nonce):
            # a flood here means the target plumbing is wrong.
            logger.warning(
                "word7 candidate overflow: %d candidates > max_hits=%d "
                "(dropped %d)", n, self.max_hits, n - self.max_hits)

    def _collect(self, out: _Dispatch, jc: JobConstants, base: int,
                 limit: int, found: _Found) -> None:
        bufs, counts = out.result()
        for chain in range(jc.chains):
            n = int(counts[chain])
            got = [int(x) for x in bufs[chain, :min(n, self.max_hits)]]
            if jc.word7:
                self._warn_overflow(n)
                got, n = _verify_candidates(got, jc, chain)
            found.add(jc, chain, got, n)

    # ------------------------------------------------------------ streaming
    def scan_stream(
        self, requests: Iterable[ScanRequest]
    ) -> Iterator[StreamResult]:
        """The dispatch ring: queue dispatch k+1 (up to ``stream_depth``
        ahead) before collecting dispatch k, across request, work-item and
        job boundaries. Results are those of :meth:`scan` per request, in
        request order."""
        tel = self.telemetry
        pending: deque = deque()
        # This stream's dispatches in the ring: the shared occupancy gauge
        # moves by deltas, and gets them back if the stream is abandoned.
        live = [0]

        def collect_oldest() -> Optional[StreamResult]:
            out, base, limit, st, enq_ns = pending.popleft()
            if out is not None:
                live[0] -= 1
                tel.ring_occupancy.dec()
                c0 = time.perf_counter_ns() if tel.enabled else 0
                self._collect(out, st["jc"], base, limit, st["found"])
                if tel.enabled:
                    end = time.perf_counter_ns()
                    tel.ring_collect.observe((end - c0) / 1e9)
                    tel.scan_batch.observe((end - enq_ns) / 1e9)
                    span_args = {"nonce_start": base, "count": limit}
                    if self.chip_label is not None:
                        span_args["chip"] = self.chip_label
                    tel.tracer.complete("ring_collect", c0, end,
                                        cat="device", **span_args)
                    tel.tracer.complete("device_dispatch", enq_ns, end,
                                        cat="device", **span_args)
            st["left"] -= 1
            if st["left"] == 0:
                req, found = st["req"], st["found"]
                return StreamResult(req, ScanResult(
                    nonces=sorted(found.hits)[:min(req.max_hits,
                                                   self.max_hits)],
                    total_hits=found.total,
                    hashes_done=req.count * st["chains"],
                    version_hits=found.version_hits,
                    version_total_hits=found.version_total))
            return None

        def drain(depth: int) -> Iterator[StreamResult]:
            while len(pending) > depth:
                res = collect_oldest()
                if res is not None:
                    yield res

        try:
            for req in requests:
                if req is STREAM_FLUSH:
                    # The caller is about to idle: finish everything in
                    # flight now, so no hit waits in the ring and goes
                    # stale.
                    yield from drain(0)
                    continue
                self._check_range(req.header76, req.nonce_start, req.count)
                st = {"req": req, "found": _Found(), "chains": 1,
                      "left": max(1, -(-req.count // self.batch_size))}
                if req.count == 0:
                    # An empty range still owes its result in order: it
                    # rides the FIFO as an entry without a dispatch.
                    pending.append((None, req.nonce_start, 0, st, 0))
                    yield from drain(self.stream_depth)
                    continue
                # Every dispatch of a request reads the constants built
                # here from one reading of the mask, so its hashes_done and
                # its sibling versions agree with what the kernels hashed.
                st["jc"] = self._job_constants(req.header76, req.target)
                st["chains"] = st["jc"].chains
                off = 0
                while off < req.count:
                    limit = min(self.batch_size, req.count - off)
                    base = req.nonce_start + off
                    enq_ns = time.perf_counter_ns() if tel.enabled else 0
                    pending.append((self._scan_fn(st["jc"], base, limit),
                                    base, limit, st, enq_ns))
                    live[0] += 1
                    tel.ring_occupancy.inc()
                    off += limit
                    yield from drain(self.stream_depth)
            yield from drain(0)
        finally:
            if live[0]:
                tel.ring_occupancy.dec(live[0])
                with self._consts_lock:
                    self.dispatches_abandoned += live[0]
                live[0] = 0

    @property
    def version_roll_bits(self) -> int:
        """How many of the mask's lowest set bit positions the sibling
        chains occupy: the dispatcher keeps its host-side version axis off
        them, so the two axes never mine the same header."""
        if self._vshare == 1 or not self._siblings_ok:
            return 0
        return (self._vshare - 1).bit_length()

    def set_version_mask(self, mask: int) -> int:
        """Adopt the session's negotiated BIP 310 mask; returns
        :attr:`version_roll_bits` under it. A mask that cannot carry
        ``vshare`` distinct chains (mask 0: the pool granted no rolling)
        degrades the hasher to chain 0 alone, so every share stays in the
        mask; the change is logged once."""
        ok = True
        try:
            sibling_version_patterns(mask or 0, self._vshare)
        except ValueError:
            ok = self._vshare == 1
        if (mask, ok) != (self.version_mask, self._siblings_ok):
            if not ok:
                logger.error(
                    "version mask %#010x cannot carry vshare=%d sibling "
                    "chains — mining chain 0 only (restart with "
                    "--vshare 1)", mask or 0, self._vshare)
            elif self._vshare > 1:
                logger.info("vshare=%d sibling chains rolling within mask "
                            "%#010x", self._vshare, mask)
        self.version_mask = mask
        self._siblings_ok = ok
        return self.version_roll_bits


def tile_geometry(batch_size: int, sublanes: int, inner_tiles: int,
                  interleave: int, variant: str) -> Tuple[int, int]:
    """The (inner_tiles, interleave) a tile hasher runs, as
    ``PallasTpuHasher`` clamps them: inner_tiles down to a divisor of the
    batch's ``sublanes``×128-nonce tiles, interleave down to a divisor of
    inner_tiles, and for vroll-db, whose loop body covers two interleave
    groups, until inner_tiles holds an even number of them (interleave
    first). Values that fit are never changed; a changed geometry is
    logged, since a measurement must not be credited to a geometry that
    never ran."""
    requested = (inner_tiles, interleave)
    n_tiles = max(1, batch_size // (sublanes * LANES))
    inner_tiles = max(1, min(inner_tiles, n_tiles))
    while n_tiles % inner_tiles:
        inner_tiles -= 1
    interleave = max(1, min(interleave, inner_tiles))
    while inner_tiles % interleave:
        interleave -= 1
    if variant == "vroll-db":
        # A batch too small for two tile groups cannot double-buffer at
        # all: the layout check then raises.
        while inner_tiles % (2 * interleave):
            if interleave > 1:
                interleave -= 1
                while inner_tiles % interleave:
                    interleave -= 1
            elif inner_tiles > 1:
                inner_tiles -= 1
                while n_tiles % inner_tiles:
                    inner_tiles -= 1
            else:
                break
    if (inner_tiles, interleave) != requested:
        logger.warning(
            "tile geometry clamped: inner_tiles=%d interleave=%d "
            "(requested %d/%d) for batch_size=%d sublanes=%d",
            inner_tiles, interleave, *requested, batch_size, sublanes)
    return inner_tiles, interleave


class TileCudaHasher(CudaHasher):
    """The tile kernel behind the dispatch ring (``--backend cuda-tile``,
    the default).

    Each dispatch returns one (count, lowest nonce) pair per step of
    ``sublanes``×128×``inner_tiles`` nonces (the Pallas kernel's grid step,
    so the outputs compare with it slot by slot) and per chain. At real
    share difficulties a step almost never holds two hits, so the mins are
    the hits; every step reporting more than one hit, or a word7
    candidate, is re-enumerated exactly, each against its chain's own
    midstate, by one ``rescan_steps`` launch per card and dispatch. It runs
    on a high-priority side stream of the card that waits on the
    dispatch's own event, so it does not queue behind the dispatches the
    ring keeps in flight, and its blocks take SMs as the running tile
    kernel's retire. A failed launch raises: there is no other rescan.

    ``variant``, ``cgroup`` and ``interleave`` choose the tile kernel's
    layout (``ops.sha256_tile``); the geometry is clamped as
    :func:`tile_geometry` says, and checked as the Pallas hasher checks it.
    In degraded mode (one chain) the same layout runs built for one chain,
    its chain pass clamped to that chain. ``unroll`` and ``spec`` choose
    the compile form of the tile kernel and of the rescans."""

    name = "cuda-tile"
    hitbuf_scan = False

    def __init__(
        self,
        batch_size: int = 1 << 24,
        sublanes: int = 8,
        inner_tiles: int = 8,
        interleave: int = 1,
        max_hits: int = 64,
        vshare: int = 1,
        variant: str = "baseline",
        cgroup: int = 0,
        device: Optional[str] = None,
        unroll: int = 64,
        spec: bool = True,
    ) -> None:
        inner_tiles, interleave = tile_geometry(batch_size, sublanes,
                                                inner_tiles, interleave,
                                                variant)
        check_layout(max(1, vshare), variant, cgroup, interleave, inner_tiles)
        tile = sublanes * LANES * inner_tiles
        if batch_size % tile:
            raise ValueError(f"batch_size must be a multiple of {tile}")
        # No hit-buffer scan: a dispatch is whole steps.
        super().__init__(batch_size=batch_size, inner_size=tile,
                         max_hits=max_hits, vshare=vshare, device=device,
                         unroll=unroll, spec=spec)
        if self.device.type == "cuda":
            check_plane(variant, interleave)
        self.sublanes = sublanes
        self.inner_tiles = inner_tiles
        self.interleave = interleave
        self.variant = variant
        self.cgroup = cgroup
        #: nonces per step: the re-enumeration granularity.
        self.tile = tile
        #: the rescans' high-priority stream on each card.
        self._side_streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._side_lock = threading.Lock()
        if self.device.type == "cuda":
            # Made here, not in the first scan: a process's first priority
            # stream on a card sets up the pool of such streams.
            self._side_stream(self.device)

    def _scan_fn(self, jc: JobConstants, base: int, limit: int) -> _Dispatch:
        words = jc.block(base, limit)
        job = upload_words(words, self.device)
        return _Dispatch(scan_tile(
            job, n_steps=self.batch_size // self.tile, block=self.tile,
            word7=jc.word7, vshare=jc.chains, variant=self.variant,
            cgroup=min(self.cgroup, jc.chains), interleave=self.interleave,
            host_words=words, unroll=self.unroll, spec=self.spec), job=job)

    def _collect(self, out: _Dispatch, jc: JobConstants, base: int,
                 limit: int, found: _Found) -> None:
        counts, mins = out.result()
        self._collect_slots(counts, mins, jc, base, limit, found, out)

    def _collect_slots(self, counts: np.ndarray, mins: np.ndarray,
                       jc: JobConstants, base: int, limit: int,
                       found: _Found, out: _Dispatch) -> None:
        """The hits of dispatch ``out`` from its (count, min) slots, slot
        ``step·k + c`` for chain c of step ``step`` from ``base``. A slot
        holding one hit in exact mode holds it as its min; every other slot
        with a hit is rescanned, through one :meth:`_rescan` per card of
        the dispatch's launch mesh, whose devices scanned equal runs of
        steps in order: a step's rescan runs on the card that scanned it.
        Each chain's hits are added in slot order."""
        k = jc.chains
        mesh = out.mesh or (self.device,)
        steps_per_device = len(counts) // (k * len(mesh))
        hit = np.nonzero(counts)[0]
        if not len(hit):
            return
        chosen = hit if jc.word7 else hit[counts[hit] > 1]
        by_device: Dict[torch.device, List[int]] = {}
        for slot in chosen.tolist():
            device = mesh[slot // k // steps_per_device]
            by_device.setdefault(device, []).append(slot)
        rescans = [(slots, self._rescan(jc, base, limit, out, device, slots))
                   for device, slots in by_device.items()]
        # Row r: hit slot r's hits (its min alone, until a rescan's row
        # replaces it) and their uncapped count.
        rows = np.zeros((len(hit), self.max_hits), dtype=np.int64)
        rows[:, 0] = mins[hit]
        totals = np.ones(len(hit), dtype=np.int64)
        for slots, rescan in rescans:
            at = np.searchsorted(hit, slots)
            rows[at], totals[at] = rescan.result()
        stored = np.arange(self.max_hits) < np.minimum(
            totals, self.max_hits)[:, None]
        chains = hit % k
        for chain in range(k):
            mine = chains == chain
            if mine.any():
                found.add(jc, chain, rows[mine][stored[mine]].tolist(),
                          int(totals[mine].sum()))

    def _side_stream(self, device: torch.device) -> torch.cuda.Stream:
        with self._side_lock:
            stream = self._side_streams.get(device)
            if stream is None:
                stream = self._side_streams[device] = torch.cuda.Stream(
                    device, priority=-1)
            return stream

    def _rescan(self, jc: JobConstants, base: int, limit: int,
                out: _Dispatch, device: torch.device, slots: List[int]
                ) -> _Dispatch:
        """Queue the exact rescan of dispatch ``out``'s ``slots`` on
        ``device``: one ``rescan_steps`` call over the dispatch's job block
        (the dispatch's own where it lies on ``device``, else uploaded
        there once). On a card it runs on the hasher's side stream, behind
        the dispatch's own event."""
        kw = dict(k=jc.chains, tile=self.tile, max_hits=self.max_hits,
                  unroll=self.unroll, spec=self.spec)
        slot_words = torch.from_numpy(np.asarray(slots, dtype=np.int32))
        job = out.job
        if device.type == "cpu":
            if job is None:
                job = upload_words(jc.block(base, limit), device)
            return _Dispatch(rescan_steps(job, slot_words, **kw))
        stream = self._side_stream(device)
        with torch.cuda.stream(stream):
            event = out.event(device)
            if event is not None:
                stream.wait_event(event)
            if job is None or job.device != device:
                job = upload_words(jc.block(base, limit), device)
            # Kept from the allocator until the side stream is past it.
            job.record_stream(stream)
            return _Dispatch(rescan_steps(
                job, slot_words.pin_memory().to(device, non_blocking=True),
                **kw))


class _Sharded:
    """What the two sharded hashers share: the mesh, one sharded scan per
    (chains, word7 mode) built on first use, and the dispatch that launches
    it. :attr:`compile_count` counts the scan-kernel libraries those scans
    load (the counterpart of the JAX mesh hashers' traced executables):
    one per geometry, whatever the number of dispatches."""

    mesh: Tuple[torch.device, ...]
    batch_per_device: int

    def _init_mesh(self, mesh: Tuple[torch.device, ...],
                   batch_per_device: int) -> None:
        self.mesh = mesh
        self.n_devices = len(mesh)
        self.batch_per_device = batch_per_device
        #: the scheduler's grid: one dispatch covers every shard.
        self.dispatch_size = self.batch_size = batch_per_device * len(mesh)
        self._libraries: set = set()
        self._scans: dict = {}
        self._scans_lock = threading.Lock()

    @property
    def compile_count(self) -> int:
        return len(self._libraries)

    def _build_scan(self, chains: int, word7: bool) -> ShardedScan:
        raise NotImplementedError

    def _sharded(self, chains: int, word7: bool) -> ShardedScan:
        with self._scans_lock:
            scan = self._scans.get((chains, word7))
            if scan is None:
                scan = self._scans[chains, word7] = self._build_scan(chains,
                                                                     word7)
                self._libraries.add(scan.library)
            return scan

    def _scan_fn(self, jc: JobConstants, base: int, limit: int) -> _Dispatch:
        scan = self._sharded(jc.chains, jc.word7)
        shards = scan(jc.block(base, limit))
        return _Dispatch([t for outputs in shards for t in outputs],
                         mesh=scan.mesh)


class ShardedCudaHasher(_Sharded, CudaHasher):
    """The hit-buffer scan sharded over several devices (``--backend
    cuda-mesh``), the counterpart of ``ShardedTpuHasher``: each dispatch
    hands every device a disjoint ``batch_per_device`` slice, each chain's
    per-device hit buffers merge on the host (``merge_device_hits``), and
    a word7 overflow is judged on the worst device's count, since each
    device buffer holds at most ``max_hits`` candidates. ``devices`` may
    name one device more than once (``parallel.mesh.make_mesh``)."""

    name = "cuda-mesh"

    def __init__(
        self,
        n_devices: Optional[int] = None,
        batch_per_device: int = 1 << 22,
        inner_size: int = 1 << 18,
        max_hits: int = 64,
        vshare: int = 1,
        unroll: int = 64,
        spec: bool = True,
        devices: Optional[Sequence] = None,
    ) -> None:
        if batch_per_device % inner_size:
            raise ValueError("batch_per_device must be a multiple of "
                             "inner_size")
        mesh = make_mesh(n_devices, devices)
        super().__init__(batch_size=batch_per_device, inner_size=inner_size,
                         max_hits=max_hits, vshare=vshare, device=mesh[0],
                         unroll=unroll, spec=spec)
        self._init_mesh(mesh, batch_per_device)

    def _build_scan(self, chains: int, word7: bool) -> ShardedScan:
        kw = dict(batch_per_device=self.batch_per_device,
                  inner_size=self.inner_size, max_hits=self.max_hits,
                  unroll=self.unroll, word7=word7)
        if chains == 1:
            return make_sharded_scan_fn(self.mesh, spec=self.spec, **kw)
        return make_sharded_scan_fn_vshare(self.mesh, vshare=chains, **kw)

    def _collect(self, out: _Dispatch, jc: JobConstants, base: int,
                 limit: int, found: _Found) -> None:
        res = out.result()
        n, k = len(res) // 3, jc.chains
        bufs = np.stack(res[0::3]).reshape(n, k, -1)
        counts = np.stack(res[1::3]).reshape(n, k)
        for chain in range(k):
            got, total = merge_device_hits(bufs[:, chain], counts[:, chain],
                                           self.max_hits)
            if jc.word7:
                self._warn_overflow(int(counts[:, chain].max()))
                got, total = _verify_candidates(got, jc, chain)
            found.add(jc, chain, got, total)


class ShardedTileCudaHasher(_Sharded, TileCudaHasher):
    """The tile scan sharded over several devices (``--backend
    cuda-tile-mesh``), the counterpart of ``ShardedPallasTpuHasher``: each
    device sweeps a disjoint ``batch_per_device`` slice in the tile
    hasher's layout, step geometry (clamped to one device's slice) and
    form. The shards' (count, min) slots flatten to the global slot
    ``d·n_steps·k + t·k + c``, i.e. step ``d·n_steps + t`` from the
    dispatch's base, since the slices are contiguous; so the tile hasher's
    collection works unchanged: the rescans of the steps a card owns in
    the mesh the dispatch was launched on run on that card, in one
    launch over the dispatch's job block, uploaded there."""

    name = "cuda-tile-mesh"

    def __init__(
        self,
        n_devices: Optional[int] = None,
        batch_per_device: int = 1 << 24,
        sublanes: int = 8,
        inner_tiles: int = 8,
        interleave: int = 1,
        max_hits: int = 64,
        vshare: int = 1,
        variant: str = "baseline",
        cgroup: int = 0,
        unroll: int = 64,
        spec: bool = True,
        devices: Optional[Sequence] = None,
    ) -> None:
        mesh = make_mesh(n_devices, devices)
        super().__init__(batch_size=batch_per_device, sublanes=sublanes,
                         inner_tiles=inner_tiles, interleave=interleave,
                         max_hits=max_hits, vshare=vshare, variant=variant,
                         cgroup=cgroup, device=mesh[0], unroll=unroll,
                         spec=spec)
        self._init_mesh(mesh, batch_per_device)

    def _build_scan(self, chains: int, word7: bool) -> ShardedScan:
        scan, _ = make_sharded_tile_scan_fn(
            self.mesh, self.batch_per_device, self.sublanes, self.unroll,
            word7=word7, inner_tiles=self.inner_tiles, spec=self.spec,
            interleave=self.interleave, vshare=chains, variant=self.variant,
            cgroup=min(self.cgroup, chains))
        return scan

    def _collect(self, out: _Dispatch, jc: JobConstants, base: int,
                 limit: int, found: _Found) -> None:
        res = out.result()
        self._collect_slots(np.concatenate(res[0::3]),
                            np.concatenate(res[1::3]), jc, base, limit, found,
                            out)


def _make_fanout(**kwargs) -> Hasher:
    """Registry entry for the per-device fan-out (``parallel/fanout.py``;
    every card by default): ``kwargs`` go to ``make_cuda_fanout``."""
    from ..parallel.fanout import make_cuda_fanout

    return make_cuda_fanout(**kwargs)


def _make_mesh_native(**kwargs) -> Hasher:
    """Registry entry for the mesh-native streaming backend
    (``parallel/meshring.py``; every card by default): ``kwargs`` go to
    ``MeshCudaHasher``."""
    from ..parallel.meshring import MeshCudaHasher

    return MeshCudaHasher(**kwargs)


register_hasher("cuda", CudaHasher)
register_hasher("cuda-tile", TileCudaHasher)
register_hasher("cuda-mesh", ShardedCudaHasher)
register_hasher("cuda-tile-mesh", ShardedTileCudaHasher)
register_hasher("cuda-fanout", _make_fanout)
register_hasher("cuda-mesh-native", _make_mesh_native)
