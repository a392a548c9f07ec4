"""Mesh-native sharded dispatch: the sharded scan behind the single-device
dispatch ring, with a degradation ladder.

Counterpart of ``bitcoin_miner_tpu/parallel/meshring.py``. The two other
multi-device points each give something up: the sharded hashers
(``cuda-mesh``, ``cuda-tile-mesh``) split every dispatch over the devices,
the fan-out (``cuda-fanout``) sends whole requests to per-device rings and
pays a pump thread and a ring per device. :class:`MeshCudaHasher` drives
the sharded scan (``parallel/mesh.py``) through the same ``scan_stream``
ring the single-device hashers use: dispatches of ``batch_per_device ×
n_devices`` nonces (``dispatch_size``), per-job constants LRU-cached on
(header76, target, mask, topology).

The kernel is chosen by the class: ``MeshCudaHasher(kernel="cuda")``
builds a :class:`_MeshNativeCuda` (this class over ``ShardedCudaHasher``,
the hit-buffer scan) and ``kernel="cuda-tile"`` a :class:`_MeshNativeTile`
(over ``ShardedTileCudaHasher``, the tile scan with its layout options).
The sharded hashers contribute the dispatch and the collection; this
module contributes the topology, the library count and the ladder.

The ladder: a quarantined device drops out and the hasher serves through
a per-device fan-out over the survivors (:meth:`MeshCudaHasher.
quarantine_device`); :meth:`rebuild` shards over the survivors again, and
:meth:`restore_device` brings the device back into the full mesh. A shard
is labelled by its position in the device list the hasher was built
over, so a list that names one device twice still has distinct shards.
Streams already open keep the path they started on.

Telemetry: ``mesh_devices`` is the active topology's device count,
``mesh_rebuilds{reason}`` counts the ladder's steps (quarantine, rebuild,
restore), and every dispatch collected on the mesh counts
``chip_dispatches{chip}`` once per shard, the series the fan-out emits.
"""

from __future__ import annotations

import logging
from typing import Any, Iterable, Iterator, List, Optional, Sequence, Set

from ..backends.base import ScanResult, StreamResult
from ..backends.cuda import (
    CudaHasher,
    ShardedCudaHasher,
    ShardedTileCudaHasher,
)

logger = logging.getLogger(__name__)

#: The per-shard kernels: the hit-buffer scan and the tile scan.
MESH_KERNELS = ("cuda", "cuda-tile")


class MeshCudaHasher(CudaHasher):
    """The mesh-native streaming backend (``cuda-mesh-native``).

    Constructing this class returns the kernel's subclass (``kernel`` is
    ``"cuda"`` or ``"cuda-tile"``); every public behaviour lives here.
    :attr:`compile_count` is the number of scan-kernel libraries the
    hasher's sharded scans load: one per geometry, however many
    dispatches and topologies use it. ``topology`` (``"1xN"`` sharded,
    ``"fanout-N"`` degraded) keys the constants cache."""

    name = "cuda-mesh-native"

    def __new__(cls, *args: Any, **kwargs: Any) -> "MeshCudaHasher":
        if cls is MeshCudaHasher:
            # kernel is the 8th __init__ parameter; accept it positionally
            # too, so that the subclass chosen matches the arguments.
            kernel = kwargs.get("kernel", args[7] if len(args) > 7 else "cuda")
            if kernel not in MESH_KERNELS:
                raise ValueError(f"unknown mesh kernel {kernel!r}")
            impl = _MeshNativeTile if kernel == "cuda-tile" else _MeshNativeCuda
            return super().__new__(impl)
        return super().__new__(cls)

    def __init__(
        self,
        n_devices: Optional[int] = None,
        batch_per_device: int = 1 << 22,
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
        devices: Optional[Sequence[Any]] = None,
    ) -> None:
        # Everything a rebuild needs: the ladder rebuilds kernels from
        # this, never from state a degradation changed.
        self._mesh_native_kw = dict(
            n_devices=n_devices, batch_per_device=batch_per_device,
            inner_size=inner_size, max_hits=max_hits, unroll=unroll,
            spec=spec, vshare=vshare, kernel=kernel, sublanes=sublanes,
            inner_tiles=inner_tiles, interleave=interleave,
            variant=variant, cgroup=cgroup,
        )
        self._failed_labels: Set[str] = set()
        self._delegate: Optional[Any] = None
        self._all_devices: List[Any] = []
        self.topology = ""
        self._build(list(devices) if devices is not None else None, None)
        logger.info(
            "cuda-mesh-native: %s kernel over topology %s (dispatch grid "
            "%d nonces)", kernel, self.topology, self.dispatch_size)

    # ------------------------------------------------------------ build
    def _init_kernel(self, devices: Optional[Sequence[Any]]) -> None:
        raise NotImplementedError  # _MeshNativeCuda / _MeshNativeTile

    def _build(self, devices: Optional[List[Any]],
               labels: Optional[List[str]]) -> None:
        """(Re)build the sharded hasher over ``devices`` (None: the
        configured ones), their shards labelled ``labels`` (None: their
        positions), and re-derive every field that depends on the
        topology. Safe on a live instance: the constants cache is keyed on
        the topology, so entries of the old mesh never serve the new."""
        mask = getattr(self, "version_mask", None)
        libraries = getattr(self, "_libraries", set())
        self._delegate = None
        # A degradation set the delegate's ring depth on the instance; the
        # class default serves the mesh again.
        self.__dict__.pop("stream_depth", None)
        self._init_kernel(devices)
        self._libraries = libraries
        if not self._all_devices:
            self._all_devices = list(self.mesh)
        self.shard_labels: List[str] = (
            list(labels) if labels is not None
            else [str(i) for i in range(self.n_devices)])
        self.topology = f"1x{self.n_devices}"
        if mask is not None:
            # Re-adopt the session's mask: the kernel's __init__ reset it.
            self.set_version_mask(mask)
        self.telemetry.mesh_devices.set(self.n_devices)

    # ------------------------------------------------- constants cache
    def _consts_key(self, header76: bytes, target: int, mask: int) -> tuple:
        # The topology joins the key: constants built for one mesh never
        # serve another after a rebuild.
        return (header76, target, mask, self.topology)

    # --------------------------------------------------------- telemetry
    def _collect(self, out, jc, base, limit, found) -> None:
        super()._collect(out, jc, base, limit, found)
        # A dispatch collected: every shard swept its slice.
        chip_dispatches = self.telemetry.chip_dispatches
        for label in self.shard_labels:
            chip_dispatches.labels(chip=label).inc()

    # ------------------------------------------------ degradation ladder
    def _survivors(self) -> List[str]:
        """The labels of the devices not quarantined, in list order."""
        return [str(i) for i in range(len(self._all_devices))
                if str(i) not in self._failed_labels]

    def quarantine_device(self, label: str) -> None:
        """Degrade: drop shard ``label`` and serve through a per-device
        fan-out over the survivors until :meth:`rebuild` shards over them
        again. New streams take the fan-out at once; streams already open
        finish on the mesh."""
        label = str(label)
        known = {str(i) for i in range(len(self._all_devices))}
        if label not in known:
            raise ValueError(f"unknown device label {label!r}; mesh "
                             f"devices: {sorted(known)}")
        if label in self._failed_labels:
            return
        self._failed_labels.add(label)
        survivors = self._survivors()
        if not survivors:
            self._failed_labels.discard(label)
            raise RuntimeError("cannot quarantine the last device in the mesh")
        from .fanout import make_cuda_fanout

        kw = dict(self._mesh_native_kw)
        del kw["n_devices"]
        delegate = make_cuda_fanout(
            devices=[self._all_devices[int(s)] for s in survivors],
            labels=survivors, **kw)
        delegate.set_version_mask(self.version_mask)
        self._delegate = delegate
        self.shard_labels = list(delegate.chip_labels)
        self.topology = f"fanout-{len(survivors)}"
        # The scheduler's grid is one device's dispatch now, and the
        # feeder's window grows to keep every survivor's ring full.
        self.dispatch_size = delegate.dispatch_size
        self.stream_depth = delegate.stream_depth
        tel = self.telemetry
        tel.mesh_rebuilds.labels(reason="quarantine").inc()
        tel.mesh_devices.set(len(survivors))
        logger.warning(
            "cuda-mesh-native: device %s quarantined; per-device fan-out "
            "over %d survivors (topology %s)", label, len(survivors),
            self.topology)

    def rebuild(self, reason: str = "rebuild") -> None:
        """Shard over the current survivors again: the shrunken mesh.
        ``reason`` labels the ``mesh_rebuilds`` count."""
        survivors = self._survivors()
        self._build([self._all_devices[int(s)] for s in survivors], survivors)
        self.telemetry.mesh_rebuilds.labels(reason=reason).inc()
        logger.info("cuda-mesh-native: mesh rebuilt over topology %s",
                    self.topology)

    def restore_device(self, label: str) -> None:
        """Bring a quarantined device back and rebuild the mesh over the
        (perhaps again full) device list."""
        label = str(label)
        if label not in self._failed_labels:
            return
        self._failed_labels.discard(label)
        self.rebuild(reason="restore")
        logger.info("cuda-mesh-native: device %s restored; topology %s",
                    label, self.topology)

    @property
    def degraded(self) -> bool:
        """True while the fan-out, not the mesh, serves."""
        return self._delegate is not None

    # ----------------------------------------------------------- routing
    def scan(self, header76: bytes, nonce_start: int, count: int,
             target: int, max_hits: int = 64) -> ScanResult:
        if self._delegate is not None:
            return self._delegate.scan(header76, nonce_start, count, target,
                                       max_hits)
        return super().scan(header76, nonce_start, count, target, max_hits)

    def scan_stream(self, requests: Iterable[Any]) -> Iterator[StreamResult]:
        # Routed when the stream opens, not per request: a stream opened on
        # the mesh finishes there (its sharded scans stay alive), and one
        # opened degraded runs wholly on the fan-out, whose ordering and
        # flush contract are then the stream's.
        if self._delegate is not None:
            return self._delegate.scan_stream(requests)
        return super().scan_stream(requests)

    # No launch lock: the JAX executable holds a pmin rendezvous that two
    # threads' launches could enqueue on the devices in different orders,
    # but here a dispatch is one launch per shard on that device's current
    # stream and nothing waits across devices; each collect waits on its
    # own per-device events. Concurrent streams interleave launches on
    # each stream, and every dispatch still reads only its own outputs.

    def sha256d(self, data: bytes) -> bytes:
        if self._delegate is not None:
            return self._delegate.sha256d(data)
        return super().sha256d(data)

    def set_version_mask(self, mask: int) -> int:
        if self._delegate is not None:
            reserved = int(self._delegate.set_version_mask(mask))
            # Keep this object's mask in step, so that a rebuild re-adopts
            # it and version_roll_bits agrees with the delegate.
            super().set_version_mask(mask)
            return reserved
        return super().set_version_mask(mask)

    def close(self) -> None:
        if self._delegate is not None:
            self._delegate.close()
            self._delegate = None


class _MeshNativeCuda(MeshCudaHasher, ShardedCudaHasher):
    """kernel="cuda": the sharded hit-buffer scan and its per-device
    buffer merge (``ShardedCudaHasher``)."""

    def _init_kernel(self, devices: Optional[Sequence[Any]]) -> None:
        kw = self._mesh_native_kw
        ShardedCudaHasher.__init__(
            self, n_devices=None if devices is not None else kw["n_devices"],
            batch_per_device=kw["batch_per_device"],
            inner_size=kw["inner_size"], max_hits=kw["max_hits"],
            vshare=kw["vshare"], unroll=kw["unroll"], spec=kw["spec"],
            devices=devices)


class _MeshNativeTile(MeshCudaHasher, ShardedTileCudaHasher):
    """kernel="cuda-tile": the sharded tile scan in its layout and its
    per-step collection (``ShardedTileCudaHasher``)."""

    def _init_kernel(self, devices: Optional[Sequence[Any]]) -> None:
        kw = self._mesh_native_kw
        ShardedTileCudaHasher.__init__(
            self, n_devices=None if devices is not None else kw["n_devices"],
            batch_per_device=kw["batch_per_device"],
            sublanes=kw["sublanes"], inner_tiles=kw["inner_tiles"],
            interleave=kw["interleave"], max_hits=kw["max_hits"],
            vshare=kw["vshare"], variant=kw["variant"], cgroup=kw["cgroup"],
            unroll=kw["unroll"], spec=kw["spec"], devices=devices)
