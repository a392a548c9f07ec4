"""Nonce sharding over several devices: one launch per device, and a
minimum over the devices on the host.

Counterpart of ``bitcoin_miner_tpu/parallel/mesh.py``, whose ``shard_map``
bodies run one program over a device mesh: each device scans its own
``batch_per_device`` slice, and the only traffic between devices is a
``pmin`` of the lowest hit nonce. Here a :class:`ShardedScan` launches the
same body once per shard, on the shard's device and that device's current
stream: shard d scans from ``nonce_base + d·batch_per_device`` (modulo
2^32) with the saturating limit ``clamp(limit − d·batch_per_device, 0,
batch_per_device)`` through the ported kernels, in one launch that also
reduces its outputs to its lowest nonce (the scans' ``lowest`` option);
:func:`first_hit` takes the minimum over the shards on the host. Every
shard is launched, one whose limit is 0 included, as SPMD launches every
device; its outputs are zeros and 0xFFFFFFFF. There is no collective, so
launches from several threads need no order between devices.

A mesh is a tuple of devices. An explicit device list may name a device
more than once: several shards on one card, or on the CPU, where every
kernel runs as its plain version. The command line never builds such a
list.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.sha256_tile import (
    LANES,
    check_layout,
    job_block_words,
    scan_tile,
    tile_library,
)
from ..ops.sha256_torch import (
    MASK32,
    hitbuf_library,
    scan_batch,
    scan_batch_vshare,
    upload_words,
)

Mesh = Tuple[torch.device, ...]

#: One shard's scan: (its job words, its device) → its outputs, the last of
#: them its lowest output nonce as a 0-d uint32 tensor.
ShardBody = Callable[[np.ndarray, torch.device], Tuple[torch.Tensor, ...]]


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """The first ``n_devices`` CUDA devices (all by default), or an
    explicit ``devices`` sequence (the degradation ladder hands the
    survivors of a quarantine here). Asking for more cards than there are
    raises, as the JAX package does."""
    from ..backends.cuda import resolve_device

    if devices is not None:
        chosen = [resolve_device(d) for d in devices]
        if not chosen:
            raise ValueError("explicit device list must be non-empty")
        if n_devices is not None and n_devices != len(chosen):
            raise ValueError(
                f"n_devices={n_devices} contradicts {len(chosen)} explicit "
                "devices")
        return tuple(chosen)
    resolve_device(None)  # raises without a card
    present = torch.cuda.device_count()
    if n_devices is None:
        n_devices = present
    if not 1 <= n_devices <= present:
        raise ValueError(
            f"requested {n_devices} devices, only {present} present")
    return tuple(torch.device("cuda", i) for i in range(n_devices))


def shard_ranges(n_shards: int, batch_per_device: int, nonce_base: int,
                 limit: int) -> List[Tuple[int, int]]:
    """(nonce_base, limit) of each shard of a dispatch: shard d starts
    ``d·batch_per_device`` nonces on, modulo 2^32, and counts what is left
    of ``limit`` there, at most ``batch_per_device``."""
    return [((nonce_base + d * batch_per_device) & MASK32,
             max(0, min(limit - d * batch_per_device, batch_per_device)))
            for d in range(n_shards)]


class ShardedScan:
    """A scan sharded over a mesh. ``scan(words)`` takes the job block of
    the tile kernel (16k+13 uint32 words: midstates, round-3 states, tail,
    limbs, nonce_base, limit) with ``limit`` counted over the whole mesh,
    runs :data:`ShardBody` once per shard with that shard's nonce_base and
    limit, and returns each shard's outputs, on its device, without
    synchronising. ``library`` names the scan kernel's library, which
    every shard launches."""

    def __init__(self, mesh: Mesh, batch_per_device: int, vshare: int,
                 body: ShardBody, library: str) -> None:
        self.mesh = mesh
        self.batch_per_device = batch_per_device
        self.vshare = vshare
        self.library = library
        self._body = body

    def __call__(self, words) -> List[Tuple[torch.Tensor, ...]]:
        words = np.asarray(words, dtype=np.uint32)
        at = job_block_words(self.vshare) - 2  # nonce_base, then limit
        if words.shape != (at + 2,):
            raise ValueError(f"expected {at + 2} job words, got {words.shape}")
        limit = int(words[at + 1])
        if limit > len(self.mesh) * self.batch_per_device:
            raise ValueError(f"limit {limit} exceeds the mesh's "
                             f"{len(self.mesh)} x {self.batch_per_device}")
        outputs = []
        for device, shard in zip(self.mesh, shard_ranges(
                len(self.mesh), self.batch_per_device, int(words[at]),
                limit)):
            shard_words = words.copy()
            shard_words[at:] = shard
            outputs.append(self._body(shard_words, device))
        return outputs


def _hitbuf_words(words: np.ndarray, k: int) -> np.ndarray:
    """The hit-buffer scan's words of a job block of k chains: midstates,
    tail, limbs, nonce_base, limit (the round-3 states left out)."""
    return np.concatenate([words[:8 * k], words[16 * k:]])


def make_sharded_scan_fn(mesh: Mesh, batch_per_device: int = 1 << 24,
                         inner_size: int = 1 << 18, max_hits: int = 64,
                         unroll: int = 64, word7: bool = False,
                         spec: bool = True) -> ShardedScan:
    """The hit-buffer scan sharded over ``mesh``, one chain. Each shard's
    outputs, from one launch: ``(buf[max_hits], count, lowest)``, the
    first hits of its slice in order, their uncapped count and the lowest
    word of ``buf``."""
    if batch_per_device % inner_size:
        raise ValueError("batch_per_device must be a multiple of inner_size")

    def body(words: np.ndarray, device: torch.device):
        t = upload_words(_hitbuf_words(words, 1), device)
        return scan_batch(
            t[0:8], t[8:11], t[11:19], t[19], t[20], inner_size=inner_size,
            n_steps=batch_per_device // inner_size, max_hits=max_hits,
            word7=word7, unroll=unroll, spec=spec, lowest=True)

    return ShardedScan(mesh, batch_per_device, 1, body,
                       hitbuf_library(1, unroll, spec))


def make_sharded_scan_fn_vshare(mesh: Mesh, batch_per_device: int = 1 << 24,
                                inner_size: int = 1 << 18, max_hits: int = 64,
                                unroll: int = 64, word7: bool = False,
                                vshare: int = 2) -> ShardedScan:
    """The k-chain hit-buffer scan sharded over ``mesh`` (``vshare`` = k).
    Each shard's outputs, from one launch: ``(bufs[k, max_hits],
    counts[k], lowest)``, the lowest over every chain's buffer."""
    if batch_per_device % inner_size:
        raise ValueError("batch_per_device must be a multiple of inner_size")
    k = vshare

    def body(words: np.ndarray, device: torch.device):
        t = upload_words(_hitbuf_words(words, k), device)
        at = 8 * k
        return scan_batch_vshare(
            t[:at].view(k, 8), t[at:at + 3], t[at + 3:at + 11], t[at + 11],
            t[at + 12], inner_size=inner_size,
            n_steps=batch_per_device // inner_size, max_hits=max_hits,
            word7=word7, unroll=unroll, lowest=True)

    return ShardedScan(mesh, batch_per_device, k, body,
                       hitbuf_library(k, unroll))


def make_sharded_tile_scan_fn(
    mesh: Mesh,
    batch_per_device: int = 1 << 24,
    sublanes: int = 8,
    unroll: int = 64,
    word7: bool = False,
    inner_tiles: int = 8,
    spec: bool = True,
    interleave: int = 1,
    vshare: int = 1,
    variant: str = "baseline",
    cgroup: int = 0,
) -> Tuple[ShardedScan, int]:
    """The tile scan sharded over ``mesh``, the counterpart of
    ``make_sharded_pallas_scan_fn``: ``(scan, tile)``, where each shard's
    outputs, from one launch, are ``(counts[n_steps·k], mins[n_steps·k],
    lowest)`` for its steps of ``tile`` = sublanes·128·inner_tiles
    nonces."""
    check_layout(vshare, variant, cgroup, interleave, inner_tiles)
    tile = sublanes * LANES * inner_tiles
    if batch_per_device % tile:
        raise ValueError(f"batch_size must be a multiple of {tile}")

    def body(words: np.ndarray, device: torch.device):
        return scan_tile(
            upload_words(words, device), n_steps=batch_per_device // tile,
            block=tile, word7=word7, vshare=vshare, variant=variant,
            cgroup=cgroup, interleave=interleave, host_words=words,
            unroll=unroll, spec=spec, lowest=True)

    library = tile_library(vshare, variant, cgroup, interleave, unroll, spec)
    return ShardedScan(mesh, batch_per_device, vshare, body, library), tile


def first_hit(outputs: Sequence[Tuple[torch.Tensor, ...]]) -> int:
    """The lowest output nonce over the shards, 0xFFFFFFFF when none hit:
    the JAX bodies' ``pmin``, on the host (it waits for the shards)."""
    return min(int(out[-1].cpu().to(torch.int64)) for out in outputs)


def merge_device_hits(bufs, counts, max_hits: int) -> Tuple[List[int], int]:
    """Host-side merge of per-device hit buffers into a sorted hit list and
    uncapped total (device→host payload is n_dev × (max_hits+1) words — O(1)
    in the batch size)."""
    bufs_np = np.asarray(bufs)
    counts_np = np.asarray(counts)
    hits: List[int] = []
    for d in range(bufs_np.shape[0]):
        stored = min(int(counts_np[d]), bufs_np.shape[1])
        hits.extend(int(x) for x in bufs_np[d, :stored])
    hits.sort()
    return hits[:max_hits], int(counts_np.sum())
