"""SHA-256d round math in plain PyTorch, and the hit-buffer scan.

Counterpart of ``bitcoin_miner_tpu/ops/sha256_jax.py``. Words are int64
tensors holding 32-bit values, masked after every add: this torch's uint32
tensors have no ``+``, shifts, ``<=`` or ``min`` on the CPU, and an int32
``>>`` shifts arithmetically, which would corrupt every σ/Σ of a word with
bit 31 set.

Every helper also takes plain Python ints and folds them: job constants
(midstate, round-3 state, header tail, target limbs) enter as ints, so
only arithmetic touched by the nonce becomes tensor work — the partial
evaluation the JAX reference does with its polymorphic helpers.
:func:`ops_per_nonce` counts the 32-bit operations that depend on the
nonce, from which :func:`bound_ms` gives the kernels' bound.

With ``vshare`` = k version-rolled chains (overt AsicBoost) the k headers
differ only in chunk 1, so their chunk-2 compressions share one message
schedule (:func:`compress_multi`).

:func:`scan_batch` and :func:`scan_batch_vshare` are the hit-buffer scans
of one and of k chains: the plain versions (:func:`scan_batch_plain`,
:func:`scan_batch_vshare_plain`, the semantics of
``sha256_jax._scan_batch`` and ``_scan_batch_vshare``) for CPU tensors,
the CUDA kernel of ``csrc/scan_hitbuf.cu`` for CUDA tensors. With
``lowest`` each also returns the least word of its hit buffer
(:func:`shard_min_plain`), which the sharded scans need.
:func:`rescan_steps` re-enumerates many steps of a tile dispatch, each
with one chain, in one launch: the tile hasher's rescans.
"""

from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.sha256 import SHA256_IV, SHA256_K
from . import csrc

MASK32 = 0xFFFFFFFF
_W2_TAIL = [0x80000000, 0, 0, 0, 0, 0, 0, 256]  # padding of a 32-byte message
_CHUNK2_PAD = [0x80000000] + [0] * 10 + [640]  # words 4-15 of an 80-byte header


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & MASK32


def _big_sigma0(x):
    return _rotr(x, 2) ^ _rotr(x, 13) ^ _rotr(x, 22)


def _big_sigma1(x):
    return _rotr(x, 6) ^ _rotr(x, 11) ^ _rotr(x, 25)


def _small_sigma0(x):
    return _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> 3)


def _small_sigma1(x):
    return _rotr(x, 17) ^ _rotr(x, 19) ^ (x >> 10)


def _ch(e, f, g):
    return g ^ (e & (f ^ g))


def _maj(a, b, c):
    return b ^ ((a ^ b) & (b ^ c))


def _bswap32(x):
    return (
        ((x & 0x000000FF) << 24)
        | ((x & 0x0000FF00) << 8)
        | ((x >> 8) & 0x0000FF00)
        | ((x >> 24) & 0x000000FF)
    )


def _add(*xs):
    """Wrapping 32-bit sum; int terms fold into one literal."""
    const = 0
    rest = []
    for x in xs:
        if isinstance(x, int):
            const += x
        else:
            rest.append(x)
    const &= MASK32
    if not rest:
        return const
    acc = rest[0]
    for x in rest[1:]:
        acc = acc + x
    return (acc + const) & MASK32 if const else acc & MASK32


def _schedule_word(w: List, i: int):
    return _add(w[i % 16], _small_sigma0(w[(i - 15) % 16]), w[(i - 7) % 16],
                _small_sigma1(w[(i - 2) % 16]))


def _round(regs: Sequence, i: int, wi) -> Tuple:
    a, b, c, d, e, f, g, h = regs
    t1 = _add(h, _big_sigma1(e), _ch(e, f, g), SHA256_K[i], wi)
    return (_add(t1, _big_sigma0(a), _maj(a, b, c)), a, b, c, _add(d, t1),
            e, f, g)


def expand_schedule(w: Sequence) -> List:
    """The full 64-entry message schedule from a 16-word window."""
    ws = list(w)
    out = list(w)
    for i in range(16, 64):
        wi = _schedule_word(ws, i)
        ws[i % 16] = wi
        out.append(wi)
    return out


def compress_multi(states: Sequence[Sequence], w: Sequence, start: int = 0,
                   feedforwards: Optional[Sequence[Sequence]] = None
                   ) -> List[Tuple]:
    """k SHA-256 compressions of one message from k chaining states, the
    rolling schedule window expanded once and shared by all k (the
    overt-AsicBoost pattern of ``sha256_jax.compress_multi``).

    ``start``/``feedforwards`` implement the fixed-prefix precompute: when
    the first ``start`` message words are job constants, the host runs
    rounds ``0..start-1`` once (``core.sha256.sha256_rounds``) and each
    compression resumes from its register state, with its feedforward
    holding the chaining value for the final add (default the state)."""
    w = list(w)
    ffs = states if feedforwards is None else feedforwards
    regs = [tuple(s) for s in states]
    for i in range(start, 64):
        if i >= 16:
            w[i % 16] = _schedule_word(w, i)
        regs = [_round(r, i, w[i % 16]) for r in regs]
    return [tuple(_add(s, r) for s, r in zip(ff, rr))
            for ff, rr in zip(ffs, regs)]


def compress(state: Sequence, w: Sequence, start: int = 0,
             feedforward: Sequence = None) -> Tuple:
    """One SHA-256 compression (:func:`compress_multi` with one state)."""
    ff = None if feedforward is None else [feedforward]
    return compress_multi([state], w, start, ff)[0]


def compress_word7(state: Sequence, w: Sequence, start: int = 0,
                   feedforward: Sequence = None):
    """Word 7 of one compression, nothing else: the word the target check
    at any share difficulty ≥ 1 reads first. The e-value made at round 60
    only shifts e→f→g→h through rounds 61-63, so h[7] = ff[7] + d + t1(60):
    rounds 61-63, the round-60 t2, three schedule words and seven
    feedforward adds are skipped."""
    w = list(w)
    ff = state if feedforward is None else feedforward
    regs = tuple(state)
    for i in range(start, 60):
        if i >= 16:
            w[i % 16] = _schedule_word(w, i)
        regs = _round(regs, i, w[i % 16])
    a, b, c, d, e, f, g, h = regs
    t1 = _add(h, _big_sigma1(e), _ch(e, f, g), SHA256_K[60],
              _schedule_word(w, 60))
    return _add(ff[7], d, t1)


def _words(x, n: Optional[int]) -> Tuple[int, ...]:
    """``n`` (or any number of, for None) 32-bit words as Python ints from
    a tensor, array or sequence."""
    if isinstance(x, torch.Tensor):
        vals = x.reshape(-1).tolist()
    else:
        vals = np.asarray(x).reshape(-1).tolist()
    if n is not None and len(vals) != n:
        raise ValueError(f"expected {n} words, got {len(vals)}")
    return tuple(int(v) & MASK32 for v in vals)


def _rows(midstates) -> List[Tuple[int, ...]]:
    """The chains' midstates, from a (k, 8) or (8,) tensor or array."""
    words = _words(midstates, None)
    if not words or len(words) % 8:
        raise ValueError(f"expected k x 8 midstate words, got {len(words)}")
    return [words[i:i + 8] for i in range(0, len(words), 8)]


def _chunk2_state3(midstate, tail3) -> Tuple[int, ...]:
    """Registers after rounds 0-2 of the chunk-2 compression: those rounds
    consume only header[64:76], so they run once per job."""
    regs = _words(midstate, 8)
    tail = _words(tail3, 3)
    for i in range(3):
        regs = _round(regs, i, tail[i])
    return regs


def _as_nonces(nonces) -> torch.Tensor:
    if not isinstance(nonces, torch.Tensor):
        nonces = torch.from_numpy(np.asarray(nonces).astype(np.int64))
    return nonces.to(torch.int64) & MASK32


def _second_inputs(mids, s3s, tail, nonces) -> List[List]:
    """Each chain's second message: its chunk-2 digest (the k chunk-2
    compressions sharing one schedule) and the 32-byte padding."""
    w1 = [tail[0], tail[1], tail[2], _bswap32(nonces)] + _CHUNK2_PAD
    h1s = compress_multi(s3s, w1, start=3, feedforwards=mids)
    return [list(h1) + _W2_TAIL for h1 in h1s]


def sha256d_midstate_multi(midstates, tail3, nonces,
                           word7: bool = False) -> List:
    """sha256d of k version-rolled sibling headers ``header_c[0:76] ‖
    nonce`` from their chunk-1 midstates ((k, 8), row 0 the caller's own
    header) and the shared header[64:76] as 3 big-endian words: the k
    chunk-2 compressions share one message schedule. Returns k digests (8
    words each, SHA-256 big-endian word order) or, with ``word7``, k digest
    words 7 — each word shaped like ``nonces``."""
    mids = _rows(midstates)
    tail = _words(tail3, 3)
    w2s = _second_inputs(mids, [_chunk2_state3(m, tail) for m in mids],
                         tail, _as_nonces(nonces))
    second = compress_word7 if word7 else compress
    return [second(SHA256_IV, w2) for w2 in w2s]


def sha256d_midstate_digests(midstate, tail3, nonces) -> Tuple:
    """The 8 sha256d digest words (SHA-256 big-endian word order) of the
    headers ``header[0:76] ‖ nonce``, from the chunk-1 midstate (8 words)
    and header[64:76] as 3 big-endian words. Each word is shaped like
    ``nonces``."""
    return sha256d_midstate_multi(midstate, tail3, nonces)[0]


def sha256d_midstate_word7(midstate, tail3, nonces):
    """Digest word 7 only — the early-reject path (:func:`compress_word7`)."""
    return sha256d_midstate_multi(midstate, tail3, nonces, word7=True)[0]


def meets_target_words(h2: Sequence, target_limbs):
    """hash ≤ target without 256-bit integers: byte-reverse the digest and
    compare its 8 big-endian limbs lexicographically against the target's
    (``core.target.target_to_limbs``), from the least significant up."""
    limbs = _words(target_limbs, 8)
    le = None
    for k in range(8):
        d = _bswap32(h2[k])
        t = limbs[7 - k]
        le = d <= t if le is None else (d < t) | ((d == t) & le)
    return le


def _meets(mids, s3s, tail, limbs, nonces: torch.Tensor,
           word7: bool) -> List[torch.Tensor]:
    """Per-nonce verdicts of each chain from a job's constants (Python
    ints; ``mids`` and ``s3s`` one 8-tuple per chain): hash ≤ target, or
    with ``word7`` the candidate test bswap32(h2[7]) ≤ limbs[0], a superset
    of the hits that callers re-verify exactly."""
    verdicts = []
    for w2 in _second_inputs(mids, s3s, tail, nonces):
        if word7:
            verdicts.append(_bswap32(compress_word7(SHA256_IV, w2))
                            <= limbs[0])
        else:
            verdicts.append(meets_target_words(compress(SHA256_IV, w2), limbs))
    return verdicts


class OpCount(NamedTuple):
    """Nonce-dependent 32-bit operations per nonce, by the pipe that can
    run them on Hopper: ``logic`` (funnel shifts, LOP3, byte permutes,
    compares) only on the 64-lane integer pipe; ``adds`` (IADD3) there or,
    as IMAD, on the FMA pipe."""

    logic: int
    adds: int

    @property
    def total(self) -> int:
        return self.logic + self.adds


#: Word kinds of the operation count; an int is a known constant.
UNIFORM = "uniform"  # one value per job
VARYING = "varying"  # depends on the nonce


class OpTally:
    """Counts the 32-bit operations on nonce-dependent words, walking the
    round and schedule structure of :func:`compress`. Counting rule: a
    rotate or shift is one funnel shift and a 3-input logic function one
    LOP3, so each Σ/σ costs 4 logic operations and Ch, Maj or a byte swap
    one; in a sum, the constant and uniform terms fold into one, and the
    n terms left cost ceil((n-1)/2) 3-input adds (IADD3). Work on
    constants and uniform words alone is free (it folds, or is hoisted per
    job)."""

    def __init__(self) -> None:
        self.logic = 0
        self.adds = 0

    def fn(self, cost: int, plain, *xs):
        """A logic function of ``cost`` operations; ``plain`` folds it
        when every operand is a constant."""
        if VARYING in xs:
            self.logic += cost
            return VARYING
        return UNIFORM if UNIFORM in xs else plain(*xs)

    def add(self, *xs):
        const = sum(x for x in xs if isinstance(x, int)) & MASK32
        varying = xs.count(VARYING)
        if not varying:
            return UNIFORM if UNIFORM in xs else const
        self.adds += (varying + (bool(const) or UNIFORM in xs)) // 2
        return VARYING

    def schedule_word(self, w: List, i: int):
        return self.add(w[i % 16], self.fn(4, _small_sigma0, w[(i - 15) % 16]),
                        w[(i - 7) % 16],
                        self.fn(4, _small_sigma1, w[(i - 2) % 16]))

    def t1(self, regs: Sequence, i: int, wi):
        e, f, g, h = regs[4:]
        return self.add(h, self.fn(4, _big_sigma1, e), self.fn(1, _ch, e, f, g),
                        SHA256_K[i], wi)

    def round(self, regs: Sequence, i: int, wi) -> Tuple:
        a, b, c, d = regs[:4]
        t1 = self.t1(regs, i, wi)
        return (self.add(t1, self.fn(4, _big_sigma0, a),
                         self.fn(1, _maj, a, b, c)),
                a, b, c, self.add(d, t1), *regs[4:7])

    def rounds(self, state: Sequence, w: Sequence, start: int, stop: int):
        """Registers and schedule window after rounds ``start..stop-1``."""
        (regs,), w = self.rounds_shared([state], w, start, stop)
        return regs, w

    def rounds_shared(self, states: Sequence[Sequence], w: Sequence,
                      start: int, stop: int):
        """:meth:`rounds` of compressions of one message from several
        states: each schedule word counted once, each round per state."""
        w = list(w)
        regs = [tuple(s) for s in states]
        for i in range(start, stop):
            if i >= 16:
                w[i % 16] = self.schedule_word(w, i)
            regs = [self.round(r, i, w[i % 16]) for r in regs]
        return regs, w


def ops_per_nonce(word7: bool, vshare: int = 1, passes: int = 1,
                  spec: bool = True) -> OpCount:
    """The operations each nonce needs after the round 0-2 precompute
    (:class:`OpTally`'s rule), for the path of :func:`_meets` over
    ``vshare`` chains: the nonce's byte swap once, the chunk-2 schedule
    once per pass over the chains (``passes``, 1 ≤ passes ≤ vshare: the
    windowed layouts' chain passes each expand it anew), each chain's
    chunk-2 rounds, feedforward, second compression and compare once per
    chain. The target compare adds, per digest limb read, a byte swap and
    two compare-and-combine operations: one limb in word7 mode, eight
    otherwise. With ``spec`` False (a form without partial evaluation)
    nothing folds: the job words, padding, length and IV count as words
    of the nonce, so every operation on them is counted per nonce."""
    if not 1 <= passes <= vshare:
        raise ValueError(f"passes must be in [1, vshare={vshare}]")
    job = UNIFORM if spec else VARYING

    def words(consts: Sequence[int]) -> List:
        return list(consts) if spec else [VARYING] * len(consts)

    tally = OpTally()
    nonce = tally.fn(1, _bswap32, VARYING)
    w1 = [job] * 3 + [nonce] + words(_CHUNK2_PAD)
    iv = words(SHA256_IV)
    chains = []
    for size in [vshare - passes + 1] + [1] * (passes - 1):
        regs, _ = tally.rounds_shared([(job,) * 8] * size, w1, 3, 64)
        chains += regs
    compare = 0
    for regs in chains:
        w2 = [tally.add(job, r) for r in regs] + words(_W2_TAIL)  # feedforward
        if word7:
            regs, w = tally.rounds(iv, w2, 0, 60)
            tally.add(iv[7], regs[3],
                      tally.t1(regs, 60, tally.schedule_word(w, 60)))
            compare += 3
        else:
            regs, _ = tally.rounds(iv, w2, 0, 64)
            for s, r in zip(iv, regs):
                tally.add(s, r)
            compare += 8 * 3
    return OpCount(tally.logic + compare, tally.adds)


#: 32-bit lanes per SM and clock of Hopper's integer pipe (logic, shifts,
#: IADD3) and of instruction dispatch (4 schedulers × 32 lanes; IMAD and
#: VIADD adds on the FMA pipe fill the difference): the card's peak. The
#: int32 probe (``python -m bitcoin_miner_tpu_torch.probes.int_probe``)
#: reaches 98% of the first and 95% of the second on an NVIDIA H100 80GB
#: HBM3 at a 700 W power limit.
INT_LANES_PER_SM = 64
DISPATCH_LANES_PER_SM = 128


def pipe_bound_ms(logic: float, total: float, sms: int,
                  sm_clock_hz: float) -> float:
    """The least time of ``total`` 32-bit instructions or operations per
    lane, ``logic`` of them on the integer pipe, spread over ``sms`` SMs at
    ``sm_clock_hz``: ``logic / INT_LANES_PER_SM`` clocks on the integer
    pipe or ``total / DISPATCH_LANES_PER_SM`` clocks of dispatch,
    whichever is larger."""
    clocks = max(logic / INT_LANES_PER_SM, total / DISPATCH_LANES_PER_SM)
    return clocks / (sms * sm_clock_hz) * 1e3


def bound_ms(nonces: int, word7: bool, sms: int, sm_clock_hz: float,
             vshare: int = 1, passes: int = 1, spec: bool = True) -> float:
    """The least time a card with ``sms`` SMs at ``sm_clock_hz`` could take
    to hash ``nonces`` nonces over ``vshare`` chains (``nonces × vshare``
    hashes), expanding the schedule once per pass over the chains
    (``passes``; 1 is the least work), with the operations of the form
    ``spec`` (:func:`ops_per_nonce`) under :func:`pipe_bound_ms`: the logic
    operations on the integer pipe, all of them through dispatch."""
    ops = ops_per_nonce(word7, vshare, passes, spec)
    return pipe_bound_ms(nonces * ops.logic, nonces * ops.total, sms,
                         sm_clock_hz)


def _chunk_size(device: torch.device) -> int:
    # Nonces per tensor pass of the plain versions: large enough that the
    # host's launch overhead does not dominate on a card (a few thousand
    # tensor operations per pass; at 8 chains a pass holds ~3 GB of int64
    # temporaries there), small enough for the CPU.
    return 1 << 22 if device.type == "cuda" else 1 << 16


def _device_of(x) -> torch.device:
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def _u32(values: torch.Tensor, device: torch.device) -> torch.Tensor:
    # int64 → uint32 on the CPU, where this torch supports the conversion.
    return values.cpu().to(torch.uint32).to(device)


def upload_words(words: Sequence[int], device: torch.device) -> torch.Tensor:
    """uint32 words on ``device``: from pinned memory without blocking on
    the card (the caching host allocator keeps the pinned block until the
    copy has run), on the device's current stream."""
    host = torch.from_numpy(np.asarray(words, dtype=np.uint32))
    if device.type == "cpu":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def shard_min_plain(x: torch.Tensor) -> torch.Tensor:
    """The least word of a uint32 tensor, as a 0-d uint32 tensor on its
    device; 0xFFFFFFFF for an empty one: ``jnp.min`` of a shard's outputs
    in the ``shard_map`` bodies of ``bitcoin_miner_tpu/parallel/mesh.py``
    (``:164``, ``:220``, ``:291``). The minimum is taken in int64: this
    torch's CPU uint32 has no ``min``."""
    words = x.reshape(-1).cpu().to(torch.int64)
    least = int(words.min()) if words.numel() else MASK32
    return torch.tensor(least, dtype=torch.int64).to(torch.uint32).to(x.device)


def scan_batch_vshare_plain(midstates, tail3, target_limbs, nonce_base, limit,
                            *, inner_size: int, n_steps: int, max_hits: int,
                            word7: bool = False, lowest: bool = False
                            ) -> Tuple[torch.Tensor, ...]:
    """Scan ``n_steps × inner_size`` nonces from ``nonce_base`` against k
    version-rolled sibling headers, given by their midstates ((k, 8), row
    0 the caller's own header); only offsets < ``limit`` count. Returns
    ``(bufs, counts)``: per chain the first ``max_hits`` hit nonces in
    ascending offset order as uint32 (k, max_hits), unused slots
    0xFFFFFFFF, and the uncapped hit counts as int32 (k,) — the contract
    of ``bitcoin_miner_tpu/ops/sha256_jax.py::_scan_batch_vshare``. Nonces
    wrap modulo 2^32. With ``word7`` the buffers hold candidates. With
    ``lowest``, a third output: the least word of ``bufs``
    (:func:`shard_min_plain`), i.e. of the buffered hits, not of all of
    them, as the reference's shard bodies take it."""
    device = _device_of(midstates)
    mids = _rows(midstates)
    tail = _words(tail3, 3)
    limbs = _words(target_limbs, 8)
    s3s = [_chunk2_state3(m, tail) for m in mids]
    base = _words(nonce_base, 1)[0]
    n = min(_words(limit, 1)[0], n_steps * inner_size)
    chunk = _chunk_size(device)
    hits: List[List[int]] = [[] for _ in mids]
    counts = [0] * len(mids)
    for off in range(0, n, chunk):
        offs = torch.arange(off, min(off + chunk, n), dtype=torch.int64,
                            device=device)
        nonces = (offs + base) & MASK32
        for c, meets in enumerate(_meets(mids, s3s, tail, limbs, nonces,
                                         word7)):
            counts[c] += int(meets.sum())
            if len(hits[c]) < max_hits:
                idx = torch.nonzero(meets).flatten()[: max_hits - len(hits[c])]
                hits[c].extend(nonces[idx].tolist())
    bufs = torch.full((len(mids), max_hits), MASK32, dtype=torch.int64)
    for c, row in enumerate(hits):
        bufs[c, : len(row)] = torch.tensor(row, dtype=torch.int64)
    out = (_u32(bufs, device),
           torch.tensor(counts, dtype=torch.int32, device=device))
    return (*out, shard_min_plain(out[0])) if lowest else out


def scan_batch_plain(midstate, tail3, target_limbs, nonce_base, limit, *,
                     inner_size: int, n_steps: int, max_hits: int,
                     word7: bool = False, lowest: bool = False
                     ) -> Tuple[torch.Tensor, ...]:
    """:func:`scan_batch_vshare_plain` of one chain: ``(hits, count)``, the
    first ``max_hits`` hit nonces (uint32) and the uncapped count as a 0-d
    int32 — the contract of ``bitcoin_miner_tpu/ops/sha256_jax.py::
    _scan_batch`` — and with ``lowest`` the least word of ``hits``."""
    _words(midstate, 8)
    bufs, counts, *least = scan_batch_vshare_plain(
        midstate, tail3, target_limbs, nonce_base, limit,
        inner_size=inner_size, n_steps=n_steps, max_hits=max_hits,
        word7=word7, lowest=lowest)
    return (bufs[0], counts[0], *least)


#: Launches of ``csrc/scan_hitbuf.cu::scan_hitbuf_kernel`` in its default
#: form (made by :func:`scan_batch_vshare` and :func:`scan_batch`), by
#: number of chains; the one-chain counter also stands alone. Another
#: compile form counts under its library's name (:func:`hitbuf_library`).
SCAN_HITBUF_K = csrc.launch_counters("scan_hitbuf")
SCAN_HITBUF = SCAN_HITBUF_K[1]

#: Each stream's zeroed words (:func:`ticket_words`), by owner: the tile
#: scan's ticket and the complement of its least min so far
#: (``sha256_tile.scan_tile`` with ``lowest``), the hit-buffer scan's
#: ticket, then one ticket per slot of a rescan. Kernels on one stream run
#: one after another, and each sets the words it drew back to 0.
TILE_TICKET, HITBUF_TICKET, RESCAN_TICKETS = 0, 2, 3

_tickets: Dict[Tuple[torch.device, int], torch.Tensor] = {}
_tickets_lock = threading.Lock()


def ticket_words(device: torch.device, stream, n: int) -> torch.Tensor:
    """At least ``n`` zeroed words for the launches on ``stream`` (laid
    out as :data:`TILE_TICKET` says): zeroed once, on that stream, when
    made; each launch sets the words it used back to 0, and launches on
    one stream never overlap, so no launch needs a memset."""
    key = (device, stream.cuda_stream)
    with _tickets_lock:
        t = _tickets.get(key)
        if t is None or t.numel() < n:
            size = max(n, 2 * t.numel() if t is not None else 1024)
            t = _tickets[key] = torch.zeros(size, dtype=torch.int32,
                                            device=device)
        return t


#: ``ShardedTpuHasher``'s refusal, for the same reason: the reference's
#: k-chain scan always partially evaluates its shared window.
HITBUF_SPEC_ONLY = ("vshare > 1 on the hit-buffer kernel requires the "
                    "partial-evaluating (spec) kernel form")


def _check_hitbuf_form(vshare: int, unroll: int, spec: bool) -> None:
    csrc.form_defines(unroll, spec)  # checks unroll
    if vshare > 1 and not spec:
        raise ValueError(HITBUF_SPEC_ONLY)


def hitbuf_library(vshare: int, unroll: int = 64, spec: bool = True) -> str:
    """The library (and launch counter) of the hit-buffer scan of
    ``vshare`` = k chains in a compile form: ``scan_hitbuf``,
    ``scan_hitbuf_k2``, …, with ``_u8``, … or ``_nospec`` for another form
    (``csrc.form_defines``). At k > 1 only spec forms exist."""
    base = csrc.kernel_name("scan_hitbuf", vshare)  # checks 1 <= k <= 8
    _check_hitbuf_form(vshare, unroll, spec)
    form = csrc.form_defines(unroll, spec)
    if not form:
        return base
    return csrc.register(base + csrc.form_suffix(unroll, spec),
                         "scan_hitbuf.cu", VSHARE=vshare, **form)

_THREADS = 256  # threads per block of scan_hitbuf_kernel
_WAVE_BLOCKS = 528  # four blocks of 256 threads on each of 132 SMs


def hitbuf_geometry(capacity: int) -> Tuple[int, int]:
    """(iters, n_blocks) of the hit-buffer kernel for ``capacity`` nonces:
    each block owns ``256·iters`` consecutive nonces, with ``iters`` up to
    32, shrunk for small scans so that their grid still fills the card."""
    iters = max(1, min(32, capacity // (_THREADS * _WAVE_BLOCKS)))
    span = _THREADS * iters
    return iters, -(-capacity // span)


def scan_batch_vshare(midstates, tail3, target_limbs, nonce_base, limit, *,
                      inner_size: int, n_steps: int, max_hits: int,
                      word7: bool = False, unroll: int = 64,
                      spec: bool = True, lowest: bool = False
                      ) -> Tuple[torch.Tensor, ...]:
    """The k-chain hit-buffer scan (:func:`scan_batch_vshare_plain`'s
    contract, ``lowest`` included) on the tensors' device. CPU tensors
    take the plain version; CUDA tensors (uint32: midstates (k, 8) with
    1 ≤ k ≤ 8, tail3 (3,), limbs (8,), 0-d base and limit) launch
    ``scan_hitbuf_kernel`` built for k chains in the compile form
    ``unroll``/``spec`` (:func:`hitbuf_library`; every form computes the
    same function) once, on the current stream, without synchronising:
    its last block merges the block slots and takes the least word.

    Replaces the XLA scans ``bitcoin_miner_tpu/ops/sha256_jax.py::
    _scan_batch_vshare`` (and ``_scan_batch`` at k=1; no Pallas source),
    their ordered appends and, with ``lowest``, the shard bodies'
    ``jnp.min`` of the buffer. Bound: 32-bit integer operations
    (:func:`bound_ms` with ``vshare=k`` over the nonces below
    ``min(limit, capacity)``); the outputs are a few hundred bytes per
    chain. Design in ``csrc/scan_hitbuf.cu``."""
    device = _device_of(midstates)
    if device.type == "cpu":
        _check_hitbuf_form(len(_rows(midstates)), unroll, spec)
        return scan_batch_vshare_plain(
            midstates, tail3, target_limbs, nonce_base, limit,
            inner_size=inner_size, n_steps=n_steps, max_hits=max_hits,
            word7=word7, lowest=lowest)
    k = midstates.shape[0] if midstates.dim() == 2 else 0
    args = (midstates, tail3, target_limbs, nonce_base, limit)
    for t, shape in zip(args, ((k, 8), (3,), (8,), (), ())):
        csrc.check_tensor(t, device, torch.uint32, shape)
    name = hitbuf_library(k, unroll, spec)
    if not 0 < max_hits <= 1 << 16:
        raise ValueError(f"max_hits must be in [1, 65536], got {max_hits}")
    capacity = n_steps * inner_size
    if not 0 < capacity <= 1 << 32:
        raise ValueError(f"capacity {capacity} must be in [1, 2^32]")
    iters, n_blocks = hitbuf_geometry(capacity)
    blk_hits = torch.empty(k * n_blocks * max_hits, dtype=torch.uint32,
                           device=device)
    blk_counts = torch.empty(k * n_blocks, dtype=torch.int32, device=device)
    # The least word, where asked for, in the hits' own allocation.
    words = torch.empty(k * max_hits + lowest, dtype=torch.uint32,
                        device=device)
    hits = words[:k * max_hits].view(k, max_hits)
    count = torch.empty(k, dtype=torch.int32, device=device)
    lib = csrc.load(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        ticket = (ticket_words(device, stream, RESCAN_TICKETS).data_ptr()
                  + 4 * HITBUF_TICKET)
        csrc.check(lib.scan_hitbuf_launch(
            *(t.data_ptr() for t in args), blk_hits.data_ptr(),
            blk_counts.data_ptr(), ticket, hits.data_ptr(), count.data_ptr(),
            words[-1].data_ptr() if lowest else None, capacity, max_hits,
            iters, n_blocks, int(word7), stream.cuda_stream), name)
        csrc.launch_counter(name).add()
    return (hits, count, words[-1]) if lowest else (hits, count)


def scan_batch(midstate, tail3, target_limbs, nonce_base, limit, *,
               inner_size: int, n_steps: int, max_hits: int,
               word7: bool = False, unroll: int = 64,
               spec: bool = True, lowest: bool = False
               ) -> Tuple[torch.Tensor, ...]:
    """The one-chain hit-buffer scan (:func:`scan_batch_plain`'s contract,
    ``lowest`` included) on the tensors' device: CPU tensors take the
    plain version, CUDA tensors (midstate (8,)) :func:`scan_batch_vshare`'s
    kernel at k=1, in the compile form ``unroll``/``spec``.

    Replaces the XLA scan ``bitcoin_miner_tpu/ops/sha256_jax.py::
    _scan_batch``."""
    if _device_of(midstate).type == "cpu":
        _check_hitbuf_form(1, unroll, spec)
        return scan_batch_plain(
            midstate, tail3, target_limbs, nonce_base, limit,
            inner_size=inner_size, n_steps=n_steps, max_hits=max_hits,
            word7=word7, lowest=lowest)
    csrc.check_tensor(midstate, midstate.device, torch.uint32, (8,))
    bufs, counts, *least = scan_batch_vshare(
        midstate.view(1, 8), tail3, target_limbs, nonce_base, limit,
        inner_size=inner_size, n_steps=n_steps, max_hits=max_hits,
        word7=word7, unroll=unroll, spec=spec, lowest=lowest)
    return (bufs[0], counts[0], *least)


def _check_rescan(k: int, tile: int, max_hits: int) -> None:
    if not 1 <= k <= csrc.MAX_VSHARE:
        raise ValueError(f"k must be in [1, {csrc.MAX_VSHARE}], got {k}")
    if not 0 < tile <= 1 << 31:
        raise ValueError(f"tile must be in [1, 2^31], got {tile}")
    if not 0 < max_hits <= 1 << 16:
        raise ValueError(f"max_hits must be in [1, 65536], got {max_hits}")


def rescan_steps_plain(job, slots, *, k: int, tile: int, max_hits: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-enumerate steps of a tile dispatch exactly, one chain each.

    ``job`` is the dispatch's job block of k chains (16k+13 words:
    midstates, round-3 states, tail3, limbs, nonce_base, limit); slot ``s``
    of ``slots`` is ``step·k + c``. Returns ``(hits, count)``: per slot,
    chain c's first ``max_hits`` hit nonces in ascending offset order over
    ``[base + step·tile, base + step·tile + min(tile, limit − step·tile))``
    modulo 2^32, as uint32 (S, max_hits) with unused slots 0xFFFFFFFF, and
    the uncapped counts as int32 (S,): row s is :func:`scan_batch_plain`
    of that range (exact mode), with chain c's midstate. Each chain's
    slots are scanned together, whole steps at a time."""
    _check_rescan(k, tile, max_hits)
    device = _device_of(job)
    words = _words(job, 16 * k + 13)
    slot_list = list(_words(slots, None))
    if any(s >= 1 << 31 for s in slot_list):
        raise ValueError("slots must be non-negative int32")
    tail = words[16 * k:16 * k + 3]
    limbs = words[16 * k + 3:16 * k + 11]
    base, limit = words[16 * k + 11], words[16 * k + 12]
    hits = torch.full((len(slot_list), max_hits), MASK32, dtype=torch.int64,
                      device=device)
    counts = torch.zeros(len(slot_list), dtype=torch.int64, device=device)
    per_pass = max(1, _chunk_size(device) // tile)  # steps per tensor pass
    lanes = torch.arange(tile, dtype=torch.int64, device=device)
    for c in range(k):
        rows = [i for i, s in enumerate(slot_list) if s % k == c]
        mid = words[8 * c:8 * c + 8]
        s3 = words[8 * (k + c):8 * (k + c) + 8]
        for at in range(0, len(rows), per_pass):
            idx = torch.tensor(rows[at:at + per_pass], dtype=torch.int64,
                               device=device)
            steps = torch.tensor(
                [slot_list[r] // k for r in rows[at:at + per_pass]],
                dtype=torch.int64, device=device)
            offs = steps[:, None] * tile + lanes  # (steps, tile)
            nonces = (offs + base) & MASK32
            (meets,) = _meets([mid], [s3], tail, limbs, nonces, word7=False)
            meets = meets & (offs < limit)
            counts[idx] = meets.sum(1)
            rank = meets.cumsum(1) - 1
            row, col = torch.nonzero(meets & (rank < max_hits), as_tuple=True)
            hits[idx[row], rank[row, col]] = nonces[row, col]
    return _u32(hits, device), counts.to(torch.int32)


#: Launches of ``csrc/scan_hitbuf.cu::rescan_steps_kernel`` in its default
#: form; another compile form counts under its own name
#: (:func:`rescan_counter`).
RESCAN_STEPS = csrc.launch_counter("rescan_steps")
RESCAN_THREADS = 128  # threads per block of rescan_steps_kernel
#: About eight blocks of 128 threads on each of the card's 132 SMs.
_RESCAN_WAVE = 1056


def rescan_counter(unroll: int = 64, spec: bool = True) -> str:
    """The launch counter of the rescans in a compile form:
    ``rescan_steps``, ``rescan_steps_u8``, …, ``rescan_steps_nospec``.
    They launch from the one-chain hit-buffer library of that form
    (:func:`hitbuf_library`)."""
    return "rescan_steps" + csrc.form_suffix(unroll, spec)


def rescan_geometry(n_slots: int, tile: int) -> Tuple[int, int]:
    """(iters, blocks per slot) of ``rescan_steps_kernel`` for ``n_slots``
    steps of ``tile`` nonces: each block walks 128·``iters`` consecutive
    offsets of its step, one nonce per thread per iteration, with
    ``iters`` up to 32 (the per-thread work of the hit-buffer scan at
    2^24), fewer while the grid would not fill the card: one 8192-nonce
    step spreads over 64 blocks, one nonce a thread."""
    per_slot = -(-tile // RESCAN_THREADS)  # blocks a slot at one nonce each
    iters = max(1, min(32, n_slots * per_slot // _RESCAN_WAVE))
    return iters, -(-tile // (RESCAN_THREADS * iters))


def rescan_steps(job, slots, *, k: int, tile: int, max_hits: int,
                 unroll: int = 64, spec: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`rescan_steps_plain`'s contract on the tensors' device. CPU
    tensors take the plain version; CUDA tensors (job uint32 (16k+13,),
    slots int32 (S,)) launch ``rescan_steps_kernel`` once, from the
    one-chain hit-buffer library in the compile form ``unroll``/``spec``
    (every form computes the same function), on the current stream,
    without synchronising. An empty slot list launches nothing.

    Replaces the tile hasher's per-step ``scan_batch`` calls, i.e. the
    reference's ``_tile_rescan`` (``bitcoin_miner_tpu/
    backends/tpu.py``: ``make_scan_fn`` over one step, ``sha256_jax.py::
    _scan_batch`` and its ordered append) once per candidate step. Bound:
    32-bit integer operations (:func:`bound_ms` in exact mode over the
    slots' nonces). Design in ``csrc/scan_hitbuf.cu``."""
    device = _device_of(job)
    if device.type == "cpu":
        _check_hitbuf_form(1, unroll, spec)
        return rescan_steps_plain(job, slots, k=k, tile=tile,
                                  max_hits=max_hits)
    _check_rescan(k, tile, max_hits)
    csrc.check_tensor(job, device, torch.uint32, (16 * k + 13,))
    n_slots = slots.shape[0] if slots.dim() == 1 else -1
    csrc.check_tensor(slots, device, torch.int32, (n_slots,))
    library = hitbuf_library(1, unroll, spec)
    name = rescan_counter(unroll, spec)
    hits = torch.empty((n_slots, max_hits), dtype=torch.uint32, device=device)
    count = torch.empty((n_slots,), dtype=torch.int32, device=device)
    if n_slots == 0:
        return hits, count
    iters, bps = rescan_geometry(n_slots, tile)
    if n_slots * bps >= 1 << 31:
        raise ValueError(f"{n_slots} slots of {tile} nonces exceed one grid")
    lib = csrc.load(library)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        scratch = [0, 0, 0]  # block slots, their counts, tickets
        if bps > 1:
            blk_hits = torch.empty(n_slots * bps * max_hits,
                                   dtype=torch.uint32, device=device)
            blk_counts = torch.empty(n_slots * bps, dtype=torch.int32,
                                     device=device)
            tickets = ticket_words(device, stream, RESCAN_TICKETS + n_slots)
            scratch = [blk_hits.data_ptr(), blk_counts.data_ptr(),
                       tickets.data_ptr() + 4 * RESCAN_TICKETS]
        csrc.check(lib.rescan_steps_launch(
            job.data_ptr(), k, slots.data_ptr(), n_slots, tile, max_hits,
            iters, bps, *scratch, hits.data_ptr(), count.data_ptr(),
            stream.cuda_stream), name)
        csrc.launch_counter(name).add()
    return hits, count


def hitbuf_compact_plain(blk_hits: torch.Tensor, blk_counts: torch.Tensor,
                         max_hits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hit-buffer scan's second stage, which ``scan_hitbuf_kernel``
    runs in its last block: the ordered append of ``bitcoin_miner_tpu/
    ops/sha256_jax.py::_scan_batch`` and ``_scan_batch_vshare``
    (``jnp.nonzero`` and the scatter into the hit buffer).

    Merge per-block hit slots in block order, per chain: ``blk_counts``
    is (n_blocks,) for one chain or (k, n_blocks), and block ``b`` of chain
    ``c`` stored its first ``min(blk_counts[c, b], max_hits)`` hits at
    ``blk_hits[(c·n_blocks + b)·max_hits:]``. Returns each chain's first
    ``max_hits`` hits overall (unused slots 0xFFFFFFFF) and its uncapped
    total as int32: shapes (max_hits,) and () for one chain, (k, max_hits)
    and (k,) for k."""
    device = blk_hits.device
    counts = blk_counts.cpu().to(torch.int64).reshape(-1, blk_counts.shape[-1])
    k, n_blocks = counts.shape
    slots = blk_hits.cpu().to(torch.int64).view(k, n_blocks, max_hits)
    bufs = torch.full((k, max_hits), MASK32, dtype=torch.int64)
    for c in range(k):
        hits: List[int] = []
        for b, n in enumerate(counts[c].tolist()):
            if len(hits) < max_hits and n:
                hits.extend(slots[c, b, :min(n, max_hits - len(hits))].tolist())
        bufs[c, : len(hits)] = torch.tensor(hits, dtype=torch.int64)
    shape = tuple(blk_counts.shape[:-1])
    return (_u32(bufs.view(*shape, max_hits), device),
            counts.sum(1).to(torch.int32).view(shape).to(device))
