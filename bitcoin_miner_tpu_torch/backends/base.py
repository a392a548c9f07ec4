"""The ``Hasher`` seam: one hot-path method, ``scan``, behind which any
backend plugs in, and its streaming form ``scan_stream``.

Backends register by name:

    cpu              — hashlib oracle (always available; the specification)
    native           — the C++ hasher through ctypes (``backends/native.py``;
                       the CPU benchmark path)
    cuda             — the hit-buffer scan kernel (``ops/sha256_torch.py``)
    cuda-tile        — the per-step (count, min) tile kernel
                       (``ops/sha256_tile.py``)
    cuda-mesh        — the hit-buffer scan sharded over several devices
    cuda-tile-mesh   — the tile scan sharded over several devices
    cuda-fanout      — whole requests round-robined to per-device hashers
                       (``parallel/fanout.py``)
    cuda-mesh-native — the sharded scan behind one ring, with a degradation
                       ladder (``parallel/meshring.py``)
    cuda-fleet       — one hit-buffer hasher per device under the fleet
                       supervisor (``parallel/supervisor.py``)
    grpc-local       — a served worker over gRPC (``rpc/hasher_service.py``)

The dispatcher re-verifies every device hit on a CPU hasher before it
becomes a share.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Tuple)

MAX_NONCE = 1 << 32


@dataclass(frozen=True)
class ScanResult:
    """Result of one ``scan``: the hits (hash ≤ target) in ascending order,
    possibly capped at the backend's hit capacity; the uncapped count, so a
    caller can detect truncation; and the hashes computed (nonces tried ×
    the chains that hashed each).

    ``version_hits``: hits on version-rolled sibling headers found by a
    backend that shares the chunk-2 schedule across chains (vshare > 1),
    as (version, nonce) pairs. They stay out of ``nonces``/``total_hits``,
    which describe the caller's own header: a consumer that has not opted
    into version rolling must never submit one against it. Empty for every
    one-chain backend. ``version_total_hits`` is their uncapped count.

    ``reserved_version_bits``: the roll bits the backend reserved for this
    scan's sibling chains, where it says (the gRPC seam echoes it, so a
    client's cached mask → reserved mapping follows a worker restarted
    with another configuration); None otherwise."""

    nonces: List[int] = field(default_factory=list)
    total_hits: int = 0
    hashes_done: int = 0
    version_hits: List[Tuple[int, int]] = field(default_factory=list)
    version_total_hits: int = 0
    reserved_version_bits: Optional[int] = None

    @property
    def truncated(self) -> bool:
        return self.total_hits > len(self.nonces)

    @property
    def version_truncated(self) -> bool:
        return self.version_total_hits > len(self.version_hits)


@dataclass(frozen=True)
class ScanRequest:
    """One unit of streaming scan work. Each request carries its own job
    context, so one stream may cross work-item and job boundaries; ``tag``
    rides through to the result untouched."""

    header76: bytes
    nonce_start: int
    count: int
    target: int
    max_hits: int = 64
    tag: Any = None


@dataclass(frozen=True)
class StreamResult:
    """One streamed completion: the request plus its result, in request
    order."""

    request: ScanRequest
    result: ScanResult


#: Sentinel a streaming caller puts into the request iterator when it is
#: about to idle: a pipelining backend must collect and yield everything in
#: flight before it pulls the next request, or those hits would wait in the
#: ring until the next job made them stale. Yields no result of its own.
STREAM_FLUSH: Any = object()


def blocking_scan_stream(
    hasher: Any, requests: Iterable[ScanRequest]
) -> Iterator[StreamResult]:
    """The sequential adapter: one blocking ``scan`` per request."""
    for req in requests:
        if req is STREAM_FLUSH:
            continue  # nothing is ever in flight here
        yield StreamResult(
            req,
            hasher.scan(
                req.header76, req.nonce_start, req.count, req.target,
                req.max_hits,
            ),
        )


def iter_scan_stream(
    hasher: Any, requests: Iterable[ScanRequest]
) -> Iterator[StreamResult]:
    """Drive ``requests`` through the hasher's own ``scan_stream`` when it
    has one, else through the blocking adapter (duck-typed test stubs)."""
    method = getattr(hasher, "scan_stream", None)
    if method is not None:
        yield from method(requests)
        return
    yield from blocking_scan_stream(hasher, requests)


def dispatch_granularity(hasher: Any, default: int = 1) -> int:
    """The backend's per-dispatch grid in nonces, which request counts
    should be multiples of (a partial dispatch still launches the whole
    grid): ``dispatch_size`` where a backend has one (the sharded backends:
    ``batch_per_device × n_devices``; the fan-out: one child's dispatch,
    since requests go whole to one device), else ``batch_size`` (one
    device), else ``default`` for the oracle, whose cost is linear in the
    count."""
    return int(getattr(hasher, "dispatch_size", None)
               or getattr(hasher, "batch_size", None) or default)


class Hasher(ABC):
    """Pluggable sha256d backend — the hot-loop seam."""

    #: registry name; subclasses override.
    name: str = "abstract"

    #: True when ``scan`` spends its time outside the GIL (device compute,
    #: native code). Only then does the dispatcher's pump thread overlap
    #: with the event loop's verify/submit work; a backend that holds the
    #: GIL is driven by the blocking loop instead.
    scan_releases_gil: bool = True

    @abstractmethod
    def sha256d(self, data: bytes) -> bytes:
        """Full double SHA-256 (cold path)."""

    @abstractmethod
    def scan(
        self,
        header76: bytes,
        nonce_start: int,
        count: int,
        target: int,
        max_hits: int = 64,
    ) -> ScanResult:
        """Sweep nonces [nonce_start, nonce_start+count) over the fixed 76
        header bytes and return those whose sha256d meets ``target``. The
        range must stay within the 32-bit nonce space."""

    def scan_stream(
        self, requests: Iterable[ScanRequest]
    ) -> Iterator[StreamResult]:
        """Streaming scan: one :class:`StreamResult` per request, in order.
        The default serves each request with a blocking :meth:`scan`;
        device backends override it with a dispatch ring."""
        yield from blocking_scan_stream(self, requests)

    def verify(self, header80: bytes, target: int) -> bool:
        """Full-hash target check on a complete header."""
        digest = self.sha256d(header80)
        return int.from_bytes(digest, "little") <= target

    def close(self) -> None:
        """Release what the backend holds (a channel); nothing by default."""

    def _check_range(self, header76: bytes, nonce_start: int, count: int) -> None:
        if len(header76) != 76:
            raise ValueError(f"header76 must be 76 bytes, got {len(header76)}")
        if not (0 <= nonce_start < MAX_NONCE):
            raise ValueError(f"nonce_start out of range: {nonce_start}")
        if count < 0 or nonce_start + count > MAX_NONCE:
            raise ValueError(
                f"scan range [{nonce_start}, {nonce_start + count}) exceeds 2^32"
            )


_REGISTRY: Dict[str, Callable[..., Hasher]] = {}

#: The backends ``backends/cuda.py`` registers.
CUDA_BACKENDS = ("cuda", "cuda-tile", "cuda-mesh", "cuda-tile-mesh",
                 "cuda-fanout", "cuda-mesh-native", "cuda-fleet")


def register_hasher(name: str, factory: Callable[..., Hasher]) -> None:
    _REGISTRY[name] = factory


def available_hashers() -> List[str]:
    return sorted(_REGISTRY)


def get_hasher(name: str, **kwargs: Any) -> Hasher:
    """Instantiate a backend by registry name; ``kwargs`` go to its
    constructor (``device=`` for the CUDA backends)."""
    if name not in _REGISTRY:
        if name in ("cpu", "native"):
            from . import cpu  # noqa: F401
        elif name in CUDA_BACKENDS:
            from . import cuda  # noqa: F401
        elif name == "grpc-local":
            from ..rpc import hasher_service  # noqa: F401
    try:
        factory = _REGISTRY[name]
    except KeyError:
        known = sorted(set(available_hashers())
                       | {"cpu", "native", "grpc-local", *CUDA_BACKENDS})
        raise ValueError(
            f"unknown hasher {name!r}; available: {known}"
        ) from None
    return factory(**kwargs)
