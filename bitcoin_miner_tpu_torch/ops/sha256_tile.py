"""The tile scan: one (hit count, lowest hit nonce) pair per step of
``block`` nonces and per version-rolled chain, and the job block it reads.

Counterpart of ``bitcoin_miner_tpu/ops/sha256_pallas.py`` (the
``baseline`` layout, vshare = k chains). :func:`scan_tile` runs the plain
version (:func:`scan_tile_plain`) for a CPU job block and the CUDA kernel
of ``csrc/scan_tile.cu`` for a CUDA one.
"""

from __future__ import annotations

import struct
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.sha256 import sha256_midstate, sha256_rounds
from ..core.target import target_to_limbs
from . import csrc
from .sha256_torch import MASK32, _chunk_size, _meets, _u32, _words


def job_block_words(vshare: int) -> int:
    """Words of the job block of ``vshare`` chains: midstate(8)×k ‖
    round3_state(8)×k ‖ tail3(3) ‖ limbs(8) ‖ nonce_base ‖ limit — 29 at
    k=1."""
    return 16 * vshare + 13


#: Words of the one-chain job block.
JOB_BLOCK_WORDS = job_block_words(1)


def job_words(header76: bytes, target: int,
              versions: Optional[Sequence[int]] = None) -> np.ndarray:
    """The 16k+11 per-job words of the job block (everything but
    nonce_base and limit) for the chains of ``versions`` (default: the
    header's own version alone, k=1): each chain's chunk-1 midstate over
    header76 with its version in bytes 0-3, then each chain's register
    state after rounds 0-2 of chunk 2 (they consume only header[64:76]),
    header[64:76] as 3 big-endian words and the target's 8 big-endian
    limbs. Chunk 2 is the same for every version."""
    if len(header76) != 76:
        raise ValueError(f"header76 must be 76 bytes, got {len(header76)}")
    if versions is None:
        versions = [int.from_bytes(header76[:4], "little")]
    tail = struct.unpack(">3I", header76[64:76])
    mids = [sha256_midstate(v.to_bytes(4, "little") + header76[4:64])
            for v in versions]
    s3s = [sha256_rounds(mid, tail, 3) for mid in mids]
    return np.asarray([w for mid in mids for w in mid]
                      + [w for s3 in s3s for w in s3]
                      + list(tail) + list(target_to_limbs(target)),
                      dtype=np.uint32)


def job_block_from_header(header76: bytes, target: int, nonce_base: int,
                          limit: int,
                          versions: Optional[Sequence[int]] = None
                          ) -> torch.Tensor:
    """The tile kernel's uint32 job block (16k+13 words for the k chains of
    ``versions``), on the CPU — word for word what
    ``PallasTpuHasher._pack_scalars`` packs from the same job."""
    words = np.concatenate([
        job_words(header76, target, versions),
        np.asarray([nonce_base & MASK32, limit & MASK32], dtype=np.uint32),
    ])
    return torch.from_numpy(words)


def scan_tile_plain(job_block: torch.Tensor, *, n_steps: int, block: int,
                    word7: bool = False, vshare: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step ``s`` covers offsets ``s·block + [0, block)`` from the block's
    nonce_base; only offsets < limit count, and nonces wrap modulo 2^32.
    Returns ``(counts, mins)``, slot ``s·k + c`` for chain ``c`` of the
    ``vshare`` = k chains: int32 hit counts and the lowest hit nonce as
    uint32 (0xFFFFFFFF when the step has none) — so a step wholly past
    ``limit`` reads (0, 0xFFFFFFFF). With ``word7`` both describe
    candidates (bswap32(h2[7]) ≤ limbs[0]), a superset of the hits."""
    device = job_block.device
    k = vshare
    w = _words(job_block, job_block_words(k))
    mids = [w[8 * c:8 * c + 8] for c in range(k)]
    s3s = [w[8 * (k + c):8 * (k + c) + 8] for c in range(k)]
    tail, limbs = w[16 * k:16 * k + 3], w[16 * k + 3:16 * k + 11]
    base, limit = w[16 * k + 11], w[16 * k + 12]
    counts = torch.zeros(n_steps, k, dtype=torch.int64, device=device)
    mins = torch.full((n_steps, k), MASK32, dtype=torch.int64, device=device)
    active = min(n_steps, -(-limit // block))
    per_pass = max(1, _chunk_size(device) // block)
    for s0 in range(0, active, per_pass):
        s1 = min(active, s0 + per_pass)
        offs = torch.arange(s0 * block, s1 * block, dtype=torch.int64,
                            device=device)
        nonces = (offs + base) & MASK32
        chains = _meets(mids, s3s, tail, limbs, nonces, word7)
        for c, meets in enumerate(chains):
            meets = (meets & (offs < limit)).view(s1 - s0, block)
            counts[s0:s1, c] = meets.sum(1)
            mins[s0:s1, c] = torch.where(meets, nonces.view(s1 - s0, block),
                                         MASK32).min(1).values
    return counts.view(-1).to(torch.int32), _u32(mins.view(-1), device)


#: Launches of ``csrc/scan_tile.cu::scan_tile_kernel``, by number of
#: chains; the one-chain counter also stands alone.
SCAN_TILE_K = csrc.launch_counters("scan_tile")
SCAN_TILE = SCAN_TILE_K[1]

_THREADS = 256  # threads per block of scan_tile_kernel


def scan_tile(job_block: torch.Tensor, *, n_steps: int, block: int,
              word7: bool = False, vshare: int = 1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tile scan (:func:`scan_tile_plain`'s contract) on the job
    block's device. A CPU block takes the plain version; a CUDA block
    (uint32, 16k+13 words for ``vshare`` = k chains, 1 ≤ k ≤ 8) launches
    ``scan_tile_kernel`` built for k chains on the current stream with one
    thread block per step, without synchronising.

    Replaces the Pallas kernel ``bitcoin_miner_tpu/ops/sha256_pallas.py::
    _scan_tile_kernel``. Bound: 32-bit integer operations
    (``sha256_torch.bound_ms`` with ``vshare=k`` over the nonces below
    ``limit``); the outputs are 8k bytes per step. Design in
    ``csrc/scan_tile.cu``."""
    device = job_block.device
    if device.type == "cpu":
        return scan_tile_plain(job_block, n_steps=n_steps, block=block,
                               word7=word7, vshare=vshare)
    name = csrc.kernel_name("scan_tile", vshare)  # checks 1 <= k <= 8
    csrc.check_tensor(job_block, device, torch.uint32,
                      (job_block_words(vshare),))
    if block <= 0 or block % _THREADS:
        raise ValueError(f"block must be a positive multiple of {_THREADS}")
    if not 0 < n_steps * block <= 1 << 32:
        raise ValueError("n_steps * block must be in [1, 2^32]")
    counts = torch.empty(n_steps * vshare, dtype=torch.int32, device=device)
    mins = torch.empty(n_steps * vshare, dtype=torch.uint32, device=device)
    lib = csrc.load(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        csrc.check(lib.scan_tile_launch(
            job_block.data_ptr(), counts.data_ptr(), mins.data_ptr(),
            n_steps, block, int(word7), stream), name)
        SCAN_TILE_K[vshare].add()
    return counts, mins
