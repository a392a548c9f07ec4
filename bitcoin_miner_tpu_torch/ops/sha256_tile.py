"""The tile scan: one (hit count, lowest hit nonce) pair per step of
``block`` nonces, and the 29-word job block it reads.

Counterpart of ``bitcoin_miner_tpu/ops/sha256_pallas.py`` (the
``baseline`` layout at vshare=1). :func:`scan_tile` runs the plain version
(:func:`scan_tile_plain`) for a CPU job block and the CUDA kernel of
``csrc/scan_tile.cu`` for a CUDA one.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np
import torch

from ..core.sha256 import sha256_midstate, sha256_rounds
from ..core.target import target_to_limbs
from . import csrc
from .sha256_torch import MASK32, _chunk_size, _meets, _u32, _words

#: Words of the job block: midstate(8) ‖ round3_state(8) ‖ tail3(3) ‖
#: limbs(8) ‖ nonce_base ‖ limit.
JOB_BLOCK_WORDS = 29


def job_words(header76: bytes, target: int) -> np.ndarray:
    """The 27 per-job words of the job block (everything but nonce_base and
    limit): the chunk-1 midstate, the register state after rounds 0-2 of
    chunk 2 (they consume only header[64:76]), header[64:76] as 3
    big-endian words and the target's 8 big-endian limbs."""
    if len(header76) != 76:
        raise ValueError(f"header76 must be 76 bytes, got {len(header76)}")
    mid = sha256_midstate(header76[:64])
    tail = struct.unpack(">3I", header76[64:76])
    s3 = sha256_rounds(mid, tail, 3)
    return np.asarray(mid + s3 + tail + target_to_limbs(target),
                      dtype=np.uint32)


def job_block_from_header(header76: bytes, target: int, nonce_base: int,
                          limit: int) -> torch.Tensor:
    """The tile kernel's 29-word uint32 job block, on the CPU — word for
    word what ``PallasTpuHasher._pack_scalars`` packs from the same
    (header76, target) pair."""
    words = np.concatenate([
        job_words(header76, target),
        np.asarray([nonce_base & MASK32, limit & MASK32], dtype=np.uint32),
    ])
    return torch.from_numpy(words)


def scan_tile_plain(job_block: torch.Tensor, *, n_steps: int, block: int,
                    word7: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step ``s`` covers offsets ``s·block + [0, block)`` from the block's
    nonce_base; only offsets < limit count, and nonces wrap modulo 2^32.
    Returns ``(counts, mins)``: int32 hit counts and the lowest hit nonce
    of each step as uint32 (0xFFFFFFFF when it has none) — so a step wholly
    past ``limit`` reads (0, 0xFFFFFFFF). With ``word7`` both describe
    candidates (bswap32(h2[7]) ≤ limbs[0]), a superset of the hits."""
    device = job_block.device
    w = _words(job_block, JOB_BLOCK_WORDS)
    mid, s3, tail, limbs = w[0:8], w[8:16], w[16:19], w[19:27]
    base, limit = w[27], w[28]
    counts = torch.zeros(n_steps, dtype=torch.int64, device=device)
    mins = torch.full((n_steps,), MASK32, dtype=torch.int64, device=device)
    active = min(n_steps, -(-limit // block))
    per_pass = max(1, _chunk_size(device) // block)
    for s0 in range(0, active, per_pass):
        s1 = min(active, s0 + per_pass)
        offs = torch.arange(s0 * block, s1 * block, dtype=torch.int64,
                            device=device)
        nonces = (offs + base) & MASK32
        meets = _meets(mid, s3, tail, limbs, nonces, word7) & (offs < limit)
        meets = meets.view(s1 - s0, block)
        counts[s0:s1] = meets.sum(1)
        mins[s0:s1] = torch.where(meets, nonces.view(s1 - s0, block),
                                  MASK32).min(1).values
    return counts.to(torch.int32), _u32(mins, device)


#: Launches of ``csrc/scan_tile.cu::scan_tile_kernel``.
SCAN_TILE = csrc.LaunchCounter("scan_tile")

_THREADS = 256  # threads per block of scan_tile_kernel


def scan_tile(job_block: torch.Tensor, *, n_steps: int, block: int,
              word7: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tile scan (:func:`scan_tile_plain`'s contract) on the job
    block's device. A CPU block takes the plain version; a CUDA block
    (uint32, 29 words) launches ``scan_tile_kernel`` on the current stream
    with one thread block per step, without synchronising.

    Replaces the Pallas kernel ``bitcoin_miner_tpu/ops/sha256_pallas.py::
    _scan_tile_kernel``. Bound: 32-bit integer operations
    (``sha256_torch.bound_ms`` over the nonces below ``limit``); the
    outputs are 8 bytes per step. Design in ``csrc/scan_tile.cu``."""
    device = job_block.device
    if device.type == "cpu":
        return scan_tile_plain(job_block, n_steps=n_steps, block=block,
                               word7=word7)
    csrc.check_tensor(job_block, device, torch.uint32, (JOB_BLOCK_WORDS,))
    if block <= 0 or block % _THREADS:
        raise ValueError(f"block must be a positive multiple of {_THREADS}")
    if not 0 < n_steps * block <= 1 << 32:
        raise ValueError("n_steps * block must be in [1, 2^32]")
    counts = torch.empty(n_steps, dtype=torch.int32, device=device)
    mins = torch.empty(n_steps, dtype=torch.uint32, device=device)
    lib = csrc.load("scan_tile")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        csrc.check(lib.scan_tile_launch(
            job_block.data_ptr(), counts.data_ptr(), mins.data_ptr(),
            n_steps, block, int(word7), stream), "scan_tile_kernel")
        SCAN_TILE.add()
    return counts, mins
