"""The tile scan: one (hit count, lowest hit nonce) pair per step of
``block`` nonces and per version-rolled chain, and the job block it reads.

Counterpart of ``bitcoin_miner_tpu/ops/sha256_pallas.py`` in each of its
layouts (:data:`VARIANTS`, the chain-pass size ``cgroup`` and
``interleave``), vshare = k chains. Every layout computes the same
function, so :func:`scan_tile_plain` is the plain version of all of them.
:func:`scan_tile` runs it for a CPU job block and the layout's CUDA kernel
of ``csrc/scan_tile.cu`` for a CUDA one.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.sha256 import sha256_midstate, sha256_rounds
from ..core.target import target_to_limbs
from . import csrc
from .sha256_torch import (
    MASK32,
    RESCAN_TICKETS,
    TILE_TICKET,
    _chunk_size,
    _meets,
    _u32,
    _words,
    shard_min_plain,
    ticket_words,
)


def job_block_words(vshare: int) -> int:
    """Words of the job block of ``vshare`` chains: midstate(8)×k ‖
    round3_state(8)×k ‖ tail3(3) ‖ limbs(8) ‖ nonce_base ‖ limit — 29 at
    k=1."""
    return 16 * vshare + 13


#: Words of the one-chain job block.
JOB_BLOCK_WORDS = job_block_words(1)

#: Nonces per row of a tile (the TPU's lane width): a step is a whole
#: number of rows.
LANES = 128

#: The layouts of the tile kernel (``sha256_pallas.VARIANTS``, in the order
#: of ``csrc/scan_tile.cu``'s ``Variant``): the same function on other
#: schedules.
VARIANTS = ("baseline", "regchain", "wsplit", "wstage", "vroll",
            "vroll-db")

#: Layouts that expand the chunk-2 schedule once per nonce into a plane in
#: shared memory, read back by every chain pass; the others re-expand it
#: in registers in each pass.
STAGED_VARIANTS = ("wstage", "vroll", "vroll-db")

#: Layouts whose default chain-pass size is 1.
_PER_CHAIN_PASS_VARIANTS = ("wsplit",) + STAGED_VARIANTS


def _chain_groups(k: int, g: int) -> List[Tuple[int, ...]]:
    """Chain indices 0..k-1 in passes of (at most) g: each pass's chains
    share one schedule expansion (or one plane read), passes run one after
    another, so the live set across the rounds scales with g, not k."""
    return [tuple(range(k))[i:i + g] for i in range(0, k, g)]


def _cgroup_size(cgroup: int, variant: str, k: int) -> int:
    """The chain-pass size: ``cgroup`` when given; else 1 for wsplit and
    the staged layouts, k (one pass) for the others."""
    if cgroup:
        return cgroup
    return 1 if variant in _PER_CHAIN_PASS_VARIANTS else k


def check_layout(vshare: int, variant: str, cgroup: int, interleave: int,
                 inner_tiles: int) -> None:
    """``make_pallas_scan_fn``'s checks of a layout, with its messages:
    ``inner_tiles`` tiles per step, ``interleave`` of them in flight."""
    if interleave < 1 or inner_tiles % interleave:
        raise ValueError("interleave must divide inner_tiles")
    if vshare < 1:
        raise ValueError("vshare must be >= 1")
    if variant not in VARIANTS:
        raise ValueError(f"unknown kernel variant {variant!r}; "
                         f"have {VARIANTS}")
    if variant == "vroll-db" and inner_tiles % (2 * interleave):
        raise ValueError(
            "vroll-db needs inner_tiles to be a multiple of "
            f"2*interleave (got inner_tiles={inner_tiles}, "
            f"interleave={interleave}): each loop body pipelines two "
            "interleave groups through the double-buffered scratch")
    if cgroup < 0 or cgroup > vshare:
        raise ValueError(
            f"cgroup must be between 1 and vshare={vshare} "
            "(0 = variant default)")


#: Threads per block of the staged kernels, and the words of a nonce's
#: schedule they stage (W[16..63]).
STAGED_THREADS = 128
PLANE_WORDS = 48
#: Shared memory one thread block may use on an H100, less the kernels'
#: own reduction arrays at 8 chains.
MAX_PLANE_BYTES = 232448 - 2 * 8 * 8 * 4


def plane_bytes(variant: str, interleave: int) -> int:
    """Dynamic shared memory of a staged kernel's block: one plane slot
    per nonce in flight (2·interleave for vroll-db), 0 for the others."""
    if variant not in STAGED_VARIANTS:
        return 0
    slots = interleave * (2 if variant == "vroll-db" else 1)
    return slots * PLANE_WORDS * 4 * STAGED_THREADS


def check_plane(variant: str, interleave: int) -> None:
    """Refuse a staged layout whose plane does not fit one thread block's
    shared memory on the card (vroll-db beyond interleave 4, wstage and
    vroll beyond 9)."""
    if plane_bytes(variant, interleave) > MAX_PLANE_BYTES:
        raise ValueError(
            f"{variant} at interleave={interleave} needs "
            f"{plane_bytes(variant, interleave)} bytes of shared memory per "
            f"block of {STAGED_THREADS} threads; an H100 block has "
            f"{MAX_PLANE_BYTES} for the plane")


def tile_library(vshare: int, variant: str = "baseline", cgroup: int = 0,
                 interleave: int = 1, unroll: int = 64,
                 spec: bool = True) -> str:
    """The name of the library (and launch counter) of a layout at k =
    ``vshare`` chains in a compile form (``csrc.form_defines``), registered
    with its defines: ``scan_tile``, ``scan_tile_k2``, … for the baseline's
    one pass and one nonce in flight, else e.g.
    ``scan_tile_vroll_k2_g1_i1``; a form other than the default adds
    ``_u8``, … or ``_nospec``."""
    base = csrc.kernel_name("scan_tile", vshare)  # checks 1 <= k <= 8
    g = _cgroup_size(cgroup, variant, vshare)
    form = csrc.form_defines(unroll, spec)
    suffix = csrc.form_suffix(unroll, spec)
    if variant == "baseline" and g == vshare and interleave == 1:
        if not form:
            return base
        return csrc.register(base + suffix, "scan_tile.cu", VSHARE=vshare,
                             **form)
    name = (f"scan_tile_{variant.replace('-', '_')}_k{vshare}_g{g}"
            f"_i{interleave}{suffix}")
    return csrc.register(name, "scan_tile.cu", VSHARE=vshare,
                         VARIANT=VARIANTS.index(variant), CGROUP=g,
                         INTERLEAVE=interleave, **form)


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
                    word7: bool = False, vshare: int = 1,
                    lowest: bool = False) -> Tuple[torch.Tensor, ...]:
    """Step ``s`` covers offsets ``s·block + [0, block)`` from the block's
    nonce_base; only offsets < limit count, and nonces wrap modulo 2^32.
    Returns ``(counts, mins)``, slot ``s·k + c`` for chain ``c`` of the
    ``vshare`` = k chains: int32 hit counts and the lowest hit nonce as
    uint32 (0xFFFFFFFF when the step has none) — so a step wholly past
    ``limit`` reads (0, 0xFFFFFFFF). With ``word7`` both describe
    candidates (bswap32(h2[7]) ≤ limbs[0]), a superset of the hits. With
    ``lowest``, a third output: the least of ``mins`` as a 0-d uint32
    (:func:`~.sha256_torch.shard_min_plain`), the sharded scan's
    ``jnp.min(mins)``."""
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
    out = (counts.view(-1).to(torch.int32), _u32(mins.view(-1), device))
    return (*out, shard_min_plain(out[1])) if lowest else out


#: Launches of the baseline ``csrc/scan_tile.cu`` libraries, by number of
#: chains; the one-chain counter also stands alone. Each layout's library
#: has its own counter (``csrc.launch_counter(tile_library(...))``).
SCAN_TILE_K = csrc.launch_counters("scan_tile")
SCAN_TILE = SCAN_TILE_K[1]


def scan_tile(job_block: torch.Tensor, *, n_steps: int, block: int,
              word7: bool = False, vshare: int = 1,
              variant: str = "baseline", cgroup: int = 0,
              interleave: int = 1,
              host_words: Optional[np.ndarray] = None,
              unroll: int = 64, spec: bool = True, lowest: bool = False
              ) -> Tuple[torch.Tensor, ...]:
    """The tile scan (:func:`scan_tile_plain`'s contract, ``lowest``
    included) on the job block's device, in the layout ``variant`` with
    chain passes of ``cgroup`` (0: the variant's default) and
    ``interleave`` nonces in flight per thread, in the compile form
    ``unroll``/``spec``
    (``make_pallas_scan_fn``'s: rolled round loops below 64, spec only at
    64; every form computes the same function). ``block`` is a multiple of
    128 (128-nonce rows);
    the layout is checked as ``make_pallas_scan_fn`` checks it, with
    ``block / 128`` rows as its tiles. A CPU block takes the plain version;
    a CUDA block (uint32, 16k+13 words for ``vshare`` = k chains, 1 ≤ k ≤
    8) launches the layout's kernel built for k chains on the current
    stream with one thread block per step, without synchronising; with
    ``lowest`` every block folds its steps' least min into the launch's
    in the same launch, through the stream's ticket words. Every layout
    but the baseline takes the job block as launch parameters:
    ``host_words`` holds the same words in host memory, so that the launch
    never reads them back from the card.

    Replaces the Pallas kernel ``bitcoin_miner_tpu/ops/sha256_pallas.py::
    _scan_tile_kernel`` and, with ``lowest``, the ``jnp.min(mins)`` of
    ``make_sharded_pallas_scan_fn``'s shard body. Bound: 32-bit integer
    operations (``sha256_torch.bound_ms`` with ``vshare=k`` and the form's
    ``spec`` over the nonces below ``limit``); the outputs are 8k bytes
    per step.
    Design in ``csrc/scan_tile.cu``."""
    if block <= 0 or block % LANES:
        raise ValueError(f"block must be a positive multiple of {LANES}")
    check_layout(vshare, variant, cgroup, interleave, block // LANES)
    csrc.form_defines(unroll, spec)  # checks unroll
    device = job_block.device
    if device.type == "cpu":
        return scan_tile_plain(job_block, n_steps=n_steps, block=block,
                               word7=word7, vshare=vshare, lowest=lowest)
    name = tile_library(vshare, variant, cgroup, interleave, unroll, spec)
    n_words = job_block_words(vshare)
    csrc.check_tensor(job_block, device, torch.uint32, (n_words,))
    if not 0 < n_steps * block <= 1 << 32:
        raise ValueError("n_steps * block must be in [1, 2^32]")
    host = None
    if variant != "baseline":
        if host_words is not None:
            host = np.ascontiguousarray(host_words, dtype=np.uint32)
        if host is None or host.shape != (n_words,):
            raise ValueError(
                f"variant {variant!r} takes the job block as launch "
                f"parameters: pass its {n_words} words in host memory as "
                "host_words")
    check_plane(variant, interleave)
    slots = n_steps * vshare
    counts = torch.empty(slots, dtype=torch.int32, device=device)
    # The least min, where asked for, in the mins' own allocation.
    words = torch.empty(slots + lowest, dtype=torch.uint32, device=device)
    mins = words[:slots]
    lib = csrc.load(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        least = scratch = None
        if lowest:
            least = words[-1].data_ptr()
            scratch = (ticket_words(device, stream, RESCAN_TICKETS).data_ptr()
                       + 4 * TILE_TICKET)
        csrc.check(lib.scan_tile_launch(
            job_block.data_ptr(), None if host is None else host.ctypes.data,
            counts.data_ptr(), mins.data_ptr(), least, scratch, n_steps,
            block, int(word7), stream.cuda_stream), name)
        csrc.launch_counter(name).add()
    return (counts, mins, words[-1]) if lowest else (counts, mins)
