"""The scans' ``lowest`` output against the JAX reference's per-shard
``jnp.min``, on the CPU.

The reference's ``shard_map`` bodies (``make_sharded_scan_fn``,
``make_sharded_scan_fn_vshare``, ``make_sharded_pallas_scan_fn`` in
interpret mode) reduce each shard's outputs with ``jnp.min`` before their
``pmin``; here that minimum is taken with numpy from each shard's outputs,
on the conftest's 8 virtual CPU devices. The port computes it in the scan
itself (``lowest=True``); on the CPU every scan is its plain version. The
hit buffer's lowest is the least word of the buffer, i.e. of the first
``max_hits`` hits in offset order: with a range that wraps past 2^32 and
more hits than slots it is not the lowest hit, which the tile scan's is.
Exact equality."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitcoin_miner_tpu.core.header import GENESIS_HEADER_HEX
from bitcoin_miner_tpu.core.target import difficulty_to_target
from bitcoin_miner_tpu.parallel import mesh as jax_mesh
from bitcoin_miner_tpu_torch.ops import sha256_tile, sha256_torch
from bitcoin_miner_tpu_torch.ops.sha256_tile import (
    job_block_from_header,
    scan_tile,
    scan_tile_plain,
)
from bitcoin_miner_tpu_torch.ops.sha256_torch import (
    MASK32,
    scan_batch,
    scan_batch_plain,
    scan_batch_vshare,
    scan_batch_vshare_plain,
    shard_min_plain,
)
from bitcoin_miner_tpu_torch.parallel import mesh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


HEADER = bytes.fromhex(GENESIS_HEADER_HEX)[:76]
#: ~2^-4 per nonce: about 64 hits per shard, four times its buffer.
DENSE = difficulty_to_target(1 / (1 << 28))
N_DEV = 8
BPD = 1 << 10  # nonces per device
INNER = 1 << 8
MAX_HITS = 16
TILE = 1024  # sublanes 8 × 128 lanes × 1 inner tile: one step per shard
CPU8 = ["cpu"] * N_DEV

#: (case, base, limit): every shard's buffer overflows; the limit ends
#: inside shard 2, so shards 3..7 scan nothing (limit 0); the range wraps
#: past 2^32 inside shard 3, whose first max_hits hits lie below 2^32.
CASES = [
    ("overflow", 4_321, N_DEV * BPD),
    ("limit_0_after_shard_2", 77, 2 * BPD + 301),
    ("wraps", (1 << 32) - 3 * BPD - 600, N_DEV * BPD - 700),
]
IDS = [c[0] for c in CASES]


def _versions(k):
    version = int.from_bytes(HEADER[:4], "little")
    return [version, version ^ (1 << 13)][:k]


def _words(base, limit, k):
    return job_block_from_header(HEADER, DENSE, base, limit,
                                 versions=_versions(k)).numpy()


def _shard_words(words, k):
    """Each shard's job block, with its own nonce_base and limit."""
    at = 16 * k + 11
    out = []
    for shard in mesh.shard_ranges(N_DEV, BPD, int(words[at]),
                                   int(words[at + 1])):
        w = words.copy()
        w[at:] = shard
        out.append(w)
    return out


def _hitbuf_parts(words, k):
    """(midstate(s), tail3, limbs, base, limit) of a job block of k
    chains, as numpy arrays."""
    t = 16 * k
    mids = words[0:8] if k == 1 else words[0:8 * k].reshape(k, 8)
    return (mids, words[t:t + 3], words[t + 3:t + 11], words[t + 11],
            words[t + 12])


@functools.lru_cache(maxsize=None)
def _jmesh():
    return jax_mesh.make_mesh(N_DEV)


@functools.lru_cache(maxsize=None)
def _reference_lowest(kind, case, k):
    """The reference's per-shard jnp.min of its scan's first output, as a
    list of ints, and that output per shard (numpy)."""
    _, base, limit = next(c for c in CASES if c[0] == case)
    words = _words(base, limit, k)
    if kind == "tile":
        scan, tile = jax_mesh.make_sharded_pallas_scan_fn(
            _jmesh(), BPD, sublanes=8, interpret=True, unroll=8,
            inner_tiles=1, vshare=k)
        assert tile == TILE
        out = np.asarray(scan(jnp.asarray(words))[1])  # mins
    else:
        args = [jnp.asarray(a) for a in _hitbuf_parts(words, k)]
        if k == 1:
            ref = jax_mesh.make_sharded_scan_fn(_jmesh(), BPD, INNER,
                                                MAX_HITS, unroll=8)(*args)
        else:
            ref = jax_mesh.make_sharded_scan_fn_vshare(
                _jmesh(), BPD, INNER, MAX_HITS, unroll=8, vshare=k)(*args)
        out = np.asarray(ref[0])  # buffers
    per_shard = out.reshape(N_DEV, -1)
    return [int(row.min()) for row in per_shard], per_shard


def _tile_lowest(words, k):
    return [int(scan_tile_plain(torch.from_numpy(w), n_steps=BPD // TILE,
                                block=TILE, vshare=k, lowest=True)[2])
            for w in _shard_words(words, k)]


def _hitbuf_lowest(words, k):
    out = []
    for w in _shard_words(words, k):
        parts = [torch.from_numpy(np.asarray(a)) for a in _hitbuf_parts(w, k)]
        kw = dict(inner_size=INNER, n_steps=BPD // INNER, max_hits=MAX_HITS,
                  lowest=True)
        if k == 1:
            got = scan_batch_plain(*parts, **kw)
        else:
            got = scan_batch_vshare_plain(*parts, **kw)
        assert got[2].shape == () and got[2].dtype == torch.uint32
        out.append(int(got[2]))
    return out


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("case, base, limit", CASES, ids=IDS)
def test_tile_lowest_is_the_pallas_shards_min(case, base, limit, k):
    want, _ = _reference_lowest("tile", case, k)
    assert _tile_lowest(_words(base, limit, k), k) == want
    if case == "limit_0_after_shard_2":
        assert want[3:] == [MASK32] * (N_DEV - 3)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("case, base, limit", CASES, ids=IDS)
def test_hitbuf_lowest_is_the_xla_shards_min(case, base, limit, k):
    want, bufs = _reference_lowest("hitbuf", case, k)
    assert _hitbuf_lowest(_words(base, limit, k), k) == want
    if case == "overflow":
        # Every chain's buffer is full: the count ran past max_hits.
        assert (bufs != MASK32).all()
    if case == "limit_0_after_shard_2":
        assert want[3:] == [MASK32] * (N_DEV - 3)


@pytest.mark.parametrize("k", [1, 2])
def test_buffer_min_is_not_the_lowest_hit_after_a_wrap(k):
    """Shard 3 wraps past 2^32 after 600 nonces, about 37 hits, more than
    max_hits: its buffer holds only nonces just below 2^32, while the tile
    scan's lowest is the shard's least hit, a nonce past the wrap."""
    words = _words(*CASES[2][1:], k)
    hitbuf = _hitbuf_lowest(words, k)
    tile = _tile_lowest(words, k)
    assert hitbuf[3] > (1 << 32) - BPD > tile[3]
    assert hitbuf[3] == _reference_lowest("hitbuf", "wraps", k)[0][3]
    assert tile[3] == _reference_lowest("tile", "wraps", k)[0][3]


@pytest.mark.parametrize("kind", ["hitbuf", "tile"])
@pytest.mark.parametrize("k", [1, 2])
def test_sharded_scans_return_the_scans_lowest(kind, k):
    """The mesh bodies' last output is their scan's own ``lowest``: the
    reference's per-shard minimum, shard for shard."""
    words = _words(*CASES[2][1:], k)
    cpu8 = mesh.make_mesh(devices=CPU8)
    if kind == "tile":
        scan, _ = mesh.make_sharded_tile_scan_fn(cpu8, BPD, sublanes=8,
                                                 inner_tiles=1, vshare=k)
    elif k == 1:
        scan = mesh.make_sharded_scan_fn(cpu8, BPD, INNER, MAX_HITS)
    else:
        scan = mesh.make_sharded_scan_fn_vshare(cpu8, BPD, INNER, MAX_HITS,
                                                vshare=k)
    got = [int(out[-1]) for out in scan(words)]
    assert got == _reference_lowest(kind, "wraps", k)[0]


def test_wrappers_on_cpu_are_plain_and_launch_nothing():
    words = _words(*CASES[0][1:], 2)
    w = _shard_words(words, 2)[0]
    counters = (sha256_tile.SCAN_TILE_K[2], sha256_torch.SCAN_HITBUF_K[2],
                sha256_torch.SCAN_HITBUF)
    before = [c.value for c in counters]
    kw = dict(n_steps=BPD // TILE, block=TILE, vshare=2, lowest=True)
    got = scan_tile(torch.from_numpy(w), **kw)
    want = scan_tile_plain(torch.from_numpy(w), **kw)
    assert len(got) == 3 and all(torch.equal(a, b) for a, b in zip(got, want))
    parts = [torch.from_numpy(np.asarray(a)) for a in _hitbuf_parts(w, 2)]
    kw = dict(inner_size=INNER, n_steps=BPD // INNER, max_hits=MAX_HITS,
              lowest=True)
    got = scan_batch_vshare(*parts, **kw)
    want = scan_batch_vshare_plain(*parts, **kw)
    assert len(got) == 3 and all(torch.equal(a, b) for a, b in zip(got, want))
    one = [torch.from_numpy(np.asarray(a)) for a in _hitbuf_parts(
        _shard_words(_words(*CASES[0][1:], 1), 1)[0], 1)]
    got = scan_batch(*one, **kw)
    want = scan_batch_plain(*one, **kw)
    assert len(got) == 3 and all(torch.equal(a, b) for a, b in zip(got, want))
    assert [c.value for c in counters] == before


@pytest.mark.parametrize("words, least", [
    ([], MASK32), ([MASK32] * 5, MASK32), ([7, MASK32, 3, 9], 3),
    ([MASK32 - 1], MASK32 - 1),
])
def test_shard_min_plain(words, least):
    x = torch.tensor(words, dtype=torch.int64).to(torch.uint32)
    got = shard_min_plain(x)
    assert got.shape == () and got.dtype == torch.uint32
    assert int(got) == least
