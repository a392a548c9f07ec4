"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
without one. On a machine with a card:
``python -m pytest --noconftest -m gpu tests/test_torch_cuda.py``
(the conftest imports JAX, which that machine need not have)."""

import json

import pytest
import torch

from bitcoin_miner_tpu_torch.backends.cuda import (
    DEFAULT_VERSION_MASK,
    CudaHasher,
    ShardedTileCudaHasher,
    TileCudaHasher,
    sibling_version_patterns,
)
from bitcoin_miner_tpu_torch.core.header import GENESIS_HEADER_HEX, GENESIS_NONCE
from bitcoin_miner_tpu_torch.core.target import difficulty_to_target, nbits_to_target
from bitcoin_miner_tpu_torch.ops import csrc, sha256_tile, sha256_torch
from bitcoin_miner_tpu_torch.ops import int_probe
from bitcoin_miner_tpu_torch.parallel import mesh
from bitcoin_miner_tpu_torch.ops.sha256_tile import (
    VARIANTS,
    job_block_from_header,
    scan_tile,
    scan_tile_plain,
    tile_library,
)
from bitcoin_miner_tpu_torch.ops.sha256_torch import (
    hitbuf_geometry,
    hitbuf_library,
    rescan_counter,
    rescan_steps,
    rescan_steps_plain,
    scan_batch,
    scan_batch_plain,
    scan_batch_vshare,
    scan_batch_vshare_plain,
    shard_min_plain,
    ticket_words,
)

pytestmark = pytest.mark.gpu

GENESIS76 = bytes.fromhex(GENESIS_HEADER_HEX)[:76]
DIFF1 = nbits_to_target(0x1D00FFFF)
EASY = difficulty_to_target(1 / (1 << 22))  # ~2^-10 per nonce
N = 1 << 20


# The tile kernel's layouts held against the plain scan: (K, variant,
# cgroup, interleave). Each new variant at its default chain passes; chain
# passes of 2 at K=4; two nonces in flight at K=2.
LAYOUTS = ([(k, v, 0, 1) for v in VARIANTS[1:] for k in (1, 2, 4, 8)]
           + [(4, v, 2, 1) for v in ("baseline", "wsplit", "wstage", "vroll")]
           + [(2, v, 0, 2) for v in ("regchain", "wstage", "vroll",
                                     "vroll-db")])
# The compile forms held against the plain scans: (unroll, spec); the tile
# kernel's at K = 1 and 2, the hit buffer's at K = 1 (at K > 1 it has only
# spec forms).
FORMS = [(8, True), (16, True), (32, True), (64, False)]
# Steps smaller than a block of threads: (layout, nonces per step).
SMALL_STEPS = [((1, "baseline", 0, 1), 128), ((1, "wstage", 0, 1), 128),
               ((2, "vroll-db", 0, 1), 256), ((1, "regchain", 0, 2), 256)]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # Every library of this module, built at once (one nvcc each).
    csrc.build([*csrc.BASELINE,
                *(tile_library(*l) for l in LAYOUTS),
                *(tile_library(*l) for l, _ in SMALL_STEPS),
                *(tile_library(k, unroll=u, spec=sp) for k in (1, 2)
                  for u, sp in FORMS),
                *(hitbuf_library(1, u, sp) for u, sp in FORMS),
                int_probe.LIBRARY])
    return torch.device("cuda", 0)


def _equal(got, want):
    return all(torch.equal(g.cpu().to(torch.int64), w.cpu().to(torch.int64))
               for g, w in zip(got, want))


CASES = [
    ("genesis", GENESIS76, DIFF1, GENESIS_NONCE - (N // 2), N),
    ("easy_cut", bytes(range(76)), EASY, 99, N - 3 * 8192 - 77),
    ("easy_wraps", bytes(76), EASY, (1 << 32) - N // 2, N),
]


@pytest.mark.parametrize("word7", [False, True])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_scan_tile_matches_plain(cuda, case, word7):
    _, header76, target, base, limit = case
    job = job_block_from_header(header76, target, base, limit).to(cuda)
    kw = dict(n_steps=N // 8192, block=8192, word7=word7)
    before = sha256_tile.SCAN_TILE.value
    got = scan_tile(job, **kw)
    assert sha256_tile.SCAN_TILE.value == before + 1
    assert _equal(got, scan_tile_plain(job, **kw))


@pytest.mark.parametrize("word7", [False, True])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_scan_batch_matches_plain(cuda, case, word7):
    _, header76, target, base, limit = case
    job = job_block_from_header(header76, target, base, limit).to(cuda)
    parts = (job[0:8], job[16:19], job[19:27], job[27], job[28])
    kw = dict(inner_size=1 << 16, n_steps=N >> 16, max_hits=32, word7=word7)
    got = scan_batch(*parts, **kw)
    assert _equal(got, scan_batch_plain(*parts, **kw))


def test_hitbuf_compact_matches_plain(cuda):
    """The scan's merge of its block slots, in its last block, over more
    block slots than one pass of that block takes (4096 at 2^25 nonces),
    with hits in blocks on both sides of the pass boundary: one launch."""
    n = 1 << 25
    assert hitbuf_geometry(n)[1] == 4096
    job = job_block_from_header(bytes(range(76)),
                                difficulty_to_target(1 / (1 << 18)),
                                (1 << 32) - n // 3, n - 5000).to(cuda)
    parts = (job[0:8], job[16:19], job[19:27], job[27], job[28])
    kw = dict(inner_size=1 << 18, n_steps=n >> 18, max_hits=4096)
    counters = {c.name: c.value for c in csrc.counters()}
    got = scan_batch(*parts, **kw)
    assert {c.name: c.value - counters.get(c.name, 0)
            for c in csrc.counters() if c.value != counters.get(c.name, 0)
            } == {"scan_hitbuf": 1}
    want = scan_batch_plain(*parts, **kw)
    assert _equal(got, want)
    assert 1024 < int(want[1]) < 4096  # about 2048, all in the buffer


@pytest.mark.parametrize("cls", [TileCudaHasher, CudaHasher])
def test_hasher_on_card_matches_plain_hasher(cuda, cls):
    card = cls(batch_size=1 << 20, device="cuda")
    plain = cls(batch_size=1 << 20, device="cpu")
    got = card.scan(GENESIS76, GENESIS_NONCE - 3_000_000, 1 << 22, DIFF1)
    assert got.nonces == [GENESIS_NONCE]
    easy = card.scan(bytes(76), 5, (1 << 20) + 4096, EASY)
    assert easy == plain.scan(bytes(76), 5, (1 << 20) + 4096, EASY)


def _k_job(case, k, cuda, host=False):
    """The job block of k chains on the card, or with ``host`` its words in
    host memory."""
    _, header76, target, base, limit = case
    version = int.from_bytes(header76[:4], "little")
    versions = [version] + [version ^ p for p in
                            sibling_version_patterns(DEFAULT_VERSION_MASK, k)]
    job = job_block_from_header(header76, target, base, limit,
                                versions=versions)
    return job.numpy() if host else job.to(cuda)


@pytest.mark.parametrize("k", [2, 3, 4, 8])
@pytest.mark.parametrize("word7", [False, True])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_scan_tile_vshare_matches_plain(cuda, case, word7, k):
    job = _k_job(case, k, cuda)
    kw = dict(n_steps=N // 8192, block=8192, word7=word7, vshare=k)
    before = sha256_tile.SCAN_TILE_K[k].value
    got = scan_tile(job, **kw)
    assert sha256_tile.SCAN_TILE_K[k].value == before + 1
    assert got[0].shape == (N // 8192 * k,)
    assert _equal(got, scan_tile_plain(job, **kw))


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("word7", [False, True])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_scan_batch_vshare_matches_plain(cuda, case, word7, k):
    """Per-chain hit buffers, with overflow in every chain at the easy
    target (~2^-10 per nonce over 2^20 nonces, 32 slots)."""
    job = _k_job(case, k, cuda)
    t = 16 * k
    parts = (job[:8 * k].view(k, 8), job[t:t + 3], job[t + 3:t + 11],
             job[t + 11], job[t + 12])
    kw = dict(inner_size=1 << 16, n_steps=N >> 16, max_hits=32, word7=word7)
    counters = {c.name: c.value for c in csrc.counters()}
    got = scan_batch_vshare(*parts, **kw)
    # One launch, and nothing after it: the merge runs in its last block.
    assert {c.name: c.value - counters.get(c.name, 0)
            for c in csrc.counters() if c.value != counters.get(c.name, 0)
            } == {f"scan_hitbuf_k{k}": 1}
    want = scan_batch_vshare_plain(*parts, **kw)
    assert _equal(got, want)
    if case[0] != "genesis":
        assert int(want[1].min()) > 32


@pytest.mark.parametrize("cls", [TileCudaHasher, CudaHasher])
def test_vshare_hasher_on_card_matches_plain_hasher(cuda, cls):
    card = cls(batch_size=1 << 20, device="cuda", vshare=2)
    plain = cls(batch_size=1 << 20, device="cpu", vshare=2)
    got = card.scan(GENESIS76, GENESIS_NONCE - 3_000_000, 1 << 22, DIFF1)
    assert got.nonces == [GENESIS_NONCE] and got.hashes_done == 1 << 23
    easy = card.scan(bytes(76), 5, (1 << 20) + 4096, EASY)
    assert easy == plain.scan(bytes(76), 5, (1 << 20) + 4096, EASY)
    assert easy.version_hits
    for mask in (0, 1 << 20):
        card.set_version_mask(mask)
        plain.set_version_mask(mask)
        assert card.scan(bytes(76), 5, 1 << 20, EASY) == plain.scan(
            bytes(76), 5, 1 << 20, EASY)


def _layout_matches_plain(cuda, case, word7, layout, block=8192):
    k, variant, cgroup, interleave = layout
    job = _k_job(case, k, cuda)
    kw = dict(n_steps=N // block, block=block, word7=word7, vshare=k)
    counter = csrc.launch_counter(tile_library(*layout))
    before = counter.value
    got = scan_tile(job, variant=variant, cgroup=cgroup,
                    interleave=interleave,
                    host_words=_k_job(case, k, cuda, host=True), **kw)
    assert counter.value == before + 1
    assert got[0].shape == (N // block * k,)
    assert _equal(got, scan_tile_plain(job, **kw))


@pytest.mark.parametrize("layout", LAYOUTS,
                         ids=lambda l: "-".join(map(str, l)))
@pytest.mark.parametrize("word7", [False, True])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_scan_tile_layout_matches_plain(cuda, case, word7, layout):
    _layout_matches_plain(cuda, case, word7, layout)


@pytest.mark.parametrize("layout, block", SMALL_STEPS,
                         ids=lambda x: "-".join(map(str, x))
                         if isinstance(x, tuple) else str(x))
@pytest.mark.parametrize("word7", [False, True])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_scan_tile_small_steps_match_plain(cuda, case, word7, layout, block):
    """Steps of 128 and 256 nonces: fewer threads than a block holds."""
    _layout_matches_plain(cuda, case, word7, layout, block)


def test_staged_plane_too_large_raises(cuda):
    """vroll-db at interleave 8 needs 384 KB of shared memory per block:
    refused before any launch, by the wrapper and by the hasher."""
    case = CASES[1]
    before = {c.name: c.value for c in csrc.counters()}
    with pytest.raises(ValueError, match="shared memory"):
        scan_tile(_k_job(case, 2, cuda), n_steps=1, block=2048, vshare=2,
                  variant="vroll-db", interleave=8,
                  host_words=_k_job(case, 2, cuda, host=True))
    with pytest.raises(ValueError, match="shared memory"):
        TileCudaHasher(batch_size=1 << 20, inner_tiles=16, interleave=16,
                       variant="wstage", device="cuda")
    assert {c.name: c.value for c in csrc.counters()} == before


def test_layouts_need_the_host_words(cuda):
    job = _k_job(CASES[0], 1, cuda)
    with pytest.raises(ValueError, match="host_words"):
        scan_tile(job, n_steps=N // 8192, block=8192, variant="regchain")


@pytest.mark.parametrize("variant", ["regchain", "wsplit", "vroll"])
def test_layout_hasher_on_card_matches_plain_hasher(cuda, variant):
    card = TileCudaHasher(batch_size=1 << 20, device="cuda", vshare=2,
                          variant=variant)
    plain = TileCudaHasher(batch_size=1 << 20, device="cpu", vshare=2,
                           variant=variant)
    got = card.scan(GENESIS76, GENESIS_NONCE - 3_000_000, 1 << 22, DIFF1)
    assert got.nonces == [GENESIS_NONCE] and got.hashes_done == 1 << 23
    easy = card.scan(bytes(76), 5, (1 << 20) + 4096, EASY)
    assert easy == plain.scan(bytes(76), 5, (1 << 20) + 4096, EASY)
    assert easy.version_hits
    card.set_version_mask(0)  # degraded: the layout's K=1 build
    plain.set_version_mask(0)
    counter = csrc.launch_counter(tile_library(1, variant))
    before = counter.value
    assert card.scan(bytes(76), 5, 1 << 20, EASY) == plain.scan(
        bytes(76), 5, 1 << 20, EASY)
    assert counter.value == before + 1


@pytest.mark.parametrize("n", [0, 1, 5, 1023, 1025, 4096, (1 << 20) + 3])
def test_shard_min_matches_plain(cuda, n):
    """The shard minimum, folded into the tile scan: ``lowest`` over 16384
    steps of 128 nonces (one block each, each drawing a ticket) whose
    range wraps past 2^32, cut at limit ``n``; 0xFFFFFFFF when no step
    hits (limit 0). One launch."""
    job = job_block_from_header(bytes(range(76)), EASY, (1 << 32) - N // 2,
                                n).to(cuda)
    kw = dict(n_steps=2 * N // 128, block=128)
    before = sha256_tile.SCAN_TILE.value
    got = scan_tile(job, lowest=True, **kw)
    assert sha256_tile.SCAN_TILE.value == before + 1
    assert got[2].device == cuda and got[2].shape == ()
    counts, mins = scan_tile_plain(job, **kw)
    assert _equal(got, (counts, mins, shard_min_plain(mins)))
    if n == 0:
        assert int(got[2].cpu().to(torch.int64)) == 0xFFFFFFFF


@pytest.mark.parametrize("form", FORMS, ids=lambda f: f"u{f[0]}-spec{f[1]}")
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("word7", [False, True])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_scan_tile_form_matches_plain(cuda, case, word7, k, form):
    unroll, spec = form
    job = _k_job(case, k, cuda)
    kw = dict(n_steps=N // 8192, block=8192, word7=word7, vshare=k)
    counter = csrc.launch_counter(tile_library(k, unroll=unroll, spec=spec))
    before = counter.value
    got = scan_tile(job, unroll=unroll, spec=spec, **kw)
    assert counter.value == before + 1
    assert _equal(got, scan_tile_plain(job, **kw))


@pytest.mark.parametrize("form", FORMS, ids=lambda f: f"u{f[0]}-spec{f[1]}")
@pytest.mark.parametrize("word7", [False, True])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_scan_batch_form_matches_plain(cuda, case, word7, form):
    unroll, spec = form
    job = _k_job(case, 1, cuda)
    parts = (job[0:8], job[16:19], job[19:27], job[27], job[28])
    kw = dict(inner_size=1 << 16, n_steps=N >> 16, max_hits=32, word7=word7)
    counter = csrc.launch_counter(hitbuf_library(1, unroll, spec))
    before = counter.value
    got = scan_batch(*parts, unroll=unroll, spec=spec, **kw)
    assert counter.value == before + 1
    assert _equal(got, scan_batch_plain(*parts, **kw))


@pytest.mark.parametrize("k", [1, 2])
def test_sharded_scan_on_one_card_matches_one_scan(cuda, k):
    """Two shards on one card against one scan of the same range, a
    partial dispatch that ends inside shard 1."""
    bpd = N // 2
    job = _k_job(("easy", bytes(range(76)), EASY, 12345, bpd + 999), k, cuda,
                 host=True)
    scan, tile = mesh.make_sharded_tile_scan_fn((cuda, cuda), bpd, vshare=k)
    counters = {c.name: c.value for c in csrc.counters()}
    shards = scan(job)
    # One scan launch per shard, and nothing after it.
    assert {c.name: c.value - counters.get(c.name, 0)
            for c in csrc.counters() if c.value != counters.get(c.name, 0)
            } == {tile_library(k): 2}
    one = scan_tile(torch.from_numpy(job).to(cuda), n_steps=N // tile,
                    block=tile, vshare=k)
    flat = [torch.cat([s[i].cpu().to(torch.int64) for s in shards])
            for i in (0, 1)]
    assert _equal(flat, one)
    assert mesh.first_hit(shards) == int(one[1].cpu().to(torch.int64).min())


def test_sharded_hasher_on_one_card_matches_plain_hasher(cuda):
    card = ShardedTileCudaHasher(batch_per_device=1 << 19, vshare=2,
                                 devices=[cuda, cuda])
    plain = ShardedTileCudaHasher(batch_per_device=1 << 19, vshare=2,
                                  devices=["cpu", "cpu"])
    got = card.scan(GENESIS76, GENESIS_NONCE - 3_000_000, 1 << 22, DIFF1)
    assert got.nonces == [GENESIS_NONCE] and got.hashes_done == 1 << 23
    easy = card.scan(bytes(76), 5, (1 << 20) + 4096, EASY)
    assert easy == plain.scan(bytes(76), 5, (1 << 20) + 4096, EASY)
    assert easy.version_hits and card.compile_count == 1


@pytest.mark.parametrize("groups, steps", [(0, 1), (13, 3), (512, 64)])
@pytest.mark.parametrize("ilp", int_probe.ILPS)
def test_int_probe_matches_plain(cuda, ilp, groups, steps):
    """Every step's tile of the int32 probe equals the plain tile, with a
    group count that leaves the unrolled loop a remainder (13) or none."""
    seed = torch.randint(0, 1 << 32, (8, 128), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(ilp))
    seed = seed.to(torch.uint32)
    counter = int_probe.LAUNCHES[ilp]
    before = counter.value
    tiles = int_probe.probe_tiles(seed.to(cuda), groups, ilp, steps)
    assert counter.value == before + 1
    assert tiles.device == cuda and tuple(tiles.shape) == (steps, 8, 128)
    want = int_probe.probe_plain(seed, groups, ilp)
    assert _equal(list(tiles.cpu()), [want] * steps)


# The batched rescan: (S, tile) with tile 8192 (several blocks a slot,
# merged by the last) and 3072 (one block a slot at S = 2048), over a
# dispatch of 2048 steps whose range wraps past 2^32 and whose limit cuts
# the last step; with several slots, one step lies wholly past the limit.
# At the regtest target every other slot overflows max_hits.
RESCAN_SIZES = [(1, 8192), (3, 8192), (2048, 8192), (1, 3072), (3, 3072),
                (2048, 3072)]
REGTEST = nbits_to_target(0x207FFFFF)


def _rescan_case(cuda, k, n_slots, tile, target):
    n_steps = 2048
    limit = n_steps * tile - 1234
    job = _k_job(("", bytes(range(76)), target, (1 << 32) - 12345, limit),
                 k, cuda)
    rng = torch.Generator().manual_seed(n_slots * tile + k)
    slots = torch.randperm(n_steps * k, generator=rng)[:n_slots]
    slots[-1] = n_steps * k - 1  # the cut step's last chain
    if n_slots > 1:
        slots[0] = n_steps * k  # a step past the limit: no hits
    return job, slots.to(torch.int32).to(cuda)


@pytest.mark.parametrize("target, max_hits", [(EASY, 4), (REGTEST, 64)],
                         ids=["easy", "regtest"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("n_slots, tile", RESCAN_SIZES,
                         ids=[f"s{s}-t{t}" for s, t in RESCAN_SIZES])
def test_rescan_steps_matches_plain(cuda, n_slots, tile, k, target, max_hits):
    job, slots = _rescan_case(cuda, k, n_slots, tile, target)
    kw = dict(k=k, tile=tile, max_hits=max_hits)
    counter = csrc.launch_counter("rescan_steps")
    before = counter.value
    got = rescan_steps(job, slots, **kw)
    assert counter.value == before + 1
    want = rescan_steps_plain(job, slots, **kw)
    assert _equal(got, want)
    inside = want[1][1:] if n_slots > 1 else want[1]
    if n_slots > 1:
        assert int(want[1][0]) == 0
    if target is REGTEST:
        assert int(inside.min()) > max_hits
    # Launched again on the same stream: the slots' tickets were reset.
    assert _equal(rescan_steps(job, slots, **kw), want)


@pytest.mark.parametrize("n_slots, tile", [(1, 8192), (2048, 8192),
                                           (3, 3072)])
def test_rescan_steps_rolled_form_matches_plain(cuda, n_slots, tile):
    job, slots = _rescan_case(cuda, 1, n_slots, tile, REGTEST)
    kw = dict(k=1, tile=tile, max_hits=64)
    counter = csrc.launch_counter(rescan_counter(8, True))
    before = counter.value
    got = rescan_steps(job, slots, unroll=8, **kw)
    assert counter.value == before + 1
    assert _equal(got, rescan_steps_plain(job, slots, **kw))


def test_rescan_steps_on_a_side_stream(cuda):
    """On another stream than the job block was made on, as the tile
    hasher launches it: the same result, and no launch for no slots."""
    job, slots = _rescan_case(cuda, 2, 3, 8192, EASY)
    side = torch.cuda.Stream(cuda, priority=-1)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        got = rescan_steps(job, slots, k=2, tile=8192, max_hits=8)
        none = rescan_steps(job, slots[:0], k=2, tile=8192, max_hits=8)
    side.synchronize()
    assert none[0].shape == (0, 8)
    assert _equal(got, rescan_steps_plain(job, slots, k=2, tile=8192,
                                          max_hits=8))


# The fused ``lowest`` against the plain scan and ``shard_min_plain``:
# the tile scan in the baseline and a staged layout, the hit buffer.
@pytest.mark.parametrize("variant", ["baseline", "vroll"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_scan_tile_lowest_matches_plain(cuda, case, k, variant):
    job = _k_job(case, k, cuda)
    kw = dict(n_steps=N // 8192, block=8192, vshare=k)
    got = scan_tile(job, variant=variant, lowest=True,
                    host_words=_k_job(case, k, cuda, host=True), **kw)
    counts, mins = scan_tile_plain(job, **kw)
    assert _equal(got, (counts, mins, shard_min_plain(mins)))


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_scan_batch_lowest_matches_plain(cuda, case, k):
    """With 32 slots at the easy target every buffer overflows: the
    lowest is that of the buffer, not of every hit."""
    job = _k_job(case, k, cuda)
    t = 16 * k
    parts = (job[:8 * k].view(k, 8), job[t:t + 3], job[t + 3:t + 11],
             job[t + 11], job[t + 12])
    kw = dict(inner_size=1 << 16, n_steps=N >> 16, max_hits=32)
    got = scan_batch_vshare(*parts, lowest=True, **kw)
    bufs, counts = scan_batch_vshare_plain(*parts, **kw)
    assert _equal(got, (bufs, counts, shard_min_plain(bufs)))
    if k == 1:
        one = scan_batch(parts[0][0], *parts[1:], lowest=True, **kw)
        assert _equal(one, (bufs[0], counts[0], shard_min_plain(bufs)))


def test_lowest_ticket_words_are_reused(cuda):
    """The scans' ticket words, one set per stream: launches back to back
    on one stream, each leaving the words at 0 for the next, and launches
    on two streams of the card at once, each on its own words."""
    cases = [(_k_job(case, 2, cuda), case) for case in CASES]
    want = [scan_tile_plain(job, n_steps=N // 8192, block=8192, vshare=2)
            for job, _ in cases]
    want = [(*w, shard_min_plain(w[1])) for w in want]
    kw = dict(n_steps=N // 8192, block=8192, vshare=2, lowest=True)
    main = torch.cuda.current_stream(cuda)
    got = [scan_tile(job, **kw) for _ in range(4) for job, _ in cases]
    main.synchronize()
    for i, g in enumerate(got):
        assert _equal(g, want[i % len(cases)])
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    for st in streams:
        st.wait_stream(main)
    got = {0: [], 1: []}
    for _ in range(4):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                got[i] += [scan_tile(job, **kw) for job, _ in cases]
    for st in streams:
        st.synchronize()
    words = [ticket_words(cuda, st, 3) for st in [main, *streams]]
    assert len({w.data_ptr() for w in words}) == 3
    for w in words:
        assert not w[:3].cpu().any()  # every launch left them at 0
    for i in (0, 1):
        for j, g in enumerate(got[i]):
            assert _equal(g, want[j % len(cases)])


def test_cuda_fleet_sweep_with_a_killed_child_matches_plain(cuda):
    """``cuda-fleet`` over the card named three times, child 1 (wrapped in
    ``ChaosHasher``) dying after its first scan: its requests are
    reclaimed, and every request's result equals the plain hit-buffer
    hasher's over the same range."""
    from bitcoin_miner_tpu_torch.backends.base import ScanRequest
    from bitcoin_miner_tpu_torch.parallel.supervisor import make_cuda_fleet
    from bitcoin_miner_tpu_torch.testing.chaos_hasher import ChaosHasher

    n = 1 << 16
    fleet = make_cuda_fleet(devices=[cuda] * 3, batch_per_device=n,
                            inner_size=n, quarantine_base_s=0.05,
                            quarantine_cap_s=0.2)
    fleet.children[1] = ChaosHasher(fleet.children[1], label="1")
    fleet.children[1].die_after_scans = 1
    reqs = [ScanRequest(header76=bytes(76), nonce_start=5 + i * n, count=n,
                        target=EASY, tag=i) for i in range(16)]
    out = list(fleet.scan_stream(iter(reqs)))
    assert [r.request.tag for r in out] == list(range(16))
    assert fleet.reclaims >= 1
    plain = CudaHasher(batch_size=n, inner_size=n, device="cpu")
    for r in out:
        assert r.result == plain.scan(bytes(76), r.request.nonce_start, n,
                                      EASY)


def test_served_tile_hasher_matches_the_local_one(cuda):
    """A ``TileCudaHasher`` on the card served over loopback gRPC gives
    the local hasher's ``ScanResult``, unary and streamed."""
    import importlib.util

    if importlib.util.find_spec("grpc") is None:
        pytest.skip("grpcio is not installed")
    from bitcoin_miner_tpu_torch.backends.base import ScanRequest
    from bitcoin_miner_tpu_torch.rpc.hasher_service import GrpcHasher, serve

    local = TileCudaHasher(batch_size=1 << 20, device="cuda")
    server, port = serve(TileCudaHasher(batch_size=1 << 20, device="cuda"))
    client = GrpcHasher(f"127.0.0.1:{port}")
    try:
        cases = [(GENESIS76, GENESIS_NONCE - 3_000_000, 1 << 22, DIFF1),
                 (bytes(76), 5, (1 << 20) + 4096, EASY)]
        for case in cases:
            assert client.scan(*case) == local.scan(*case)
        got = list(client.scan_stream(iter(
            [ScanRequest(*case, tag=i) for i, case in enumerate(cases)])))
        assert [r.request.tag for r in got] == [0, 1]
        for r, case in zip(got, cases):
            assert r.result == local.scan(*case)
    finally:
        client.close()
        server.stop(grace=None)


@pytest.mark.parametrize("legs,ks", [("core", (4,)), ("vshare", (2, 4, 8))])
def test_bulk_parity_gate_on_the_card(cuda, legs, ks):
    """Each leg of ``probes.parity`` at 2^14 hashes on the card: every
    configuration without a mismatch, every library it names launched."""
    from bitcoin_miner_tpu_torch.probes import parity

    before = {c.name: c.value for c in csrc.counters()}
    records, ok = parity.run_gate(bits=14, legs=legs, device="cuda", ks=ks,
                                  emit=lambda r: None)
    assert ok, [r for r in records if not r.get("ok")]
    after = {c.name: c.value for c in csrc.counters()}
    for r in records[:-1]:
        for lib in r["libraries"]:
            assert after.get(lib, 0) > before.get(lib, 0), (lib, r)


@pytest.mark.parametrize("argv", [["--backend", "cuda-tile"],
                                  ["--backend", "cuda", "--inner-bits", "14"]],
                         ids=["cuda-tile", "cuda"])
def test_baseline_matrix_quick_on_the_card(cuda, argv, capsys):
    """``probes.run --quick`` on the card: rc 0, five passing lines, and a
    scan kernel launched by configurations 2 to 5."""
    from bitcoin_miner_tpu_torch.probes import run

    scans = []

    def after(result):
        scans.append(sum(c.value for c in csrc.counters()
                         if c.name.startswith(("scan_tile", "scan_hitbuf"))))

    assert run.main([*argv, "--quick"], after_config=after) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [(r["config"], r["pass"]) for r in lines] == [
        (c, True) for c in range(1, 6)]
    assert all(b > a for a, b in zip(scans[:-1], scans[1:])), scans


# The layouts redesigned for the card's register file and shared memory:
# their launch bounds ask for the blocks that make 16 warps per SM
# (``sha256_tile.min_blocks``), and vroll-db at two nonces in flight stages
# a partial plane (``sha256_tile.plane_words``).
REDESIGNED = [(8, "regchain", 0, 1), (8, "vroll-db", 0, 1),
              (2, "vroll-db", 0, 2)]


@pytest.mark.parametrize("layout", REDESIGNED,
                         ids=lambda l: "-".join(map(str, l)))
@pytest.mark.parametrize("word7", [False, True])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_redesigned_layout_with_lowest_matches_plain(cuda, case, word7,
                                                     layout):
    """Counts, mins and the fused ``lowest``, word7 and exact; the
    ``easy_cut`` case's limit is not a multiple of the step."""
    k, variant, cgroup, interleave = layout
    job = _k_job(case, k, cuda)
    kw = dict(n_steps=N // 8192, block=8192, word7=word7, vshare=k)
    counter = csrc.launch_counter(tile_library(*layout))
    before = counter.value
    got = scan_tile(job, variant=variant, cgroup=cgroup,
                    interleave=interleave, lowest=True,
                    host_words=_k_job(case, k, cuda, host=True), **kw)
    assert counter.value == before + 1
    counts, mins = scan_tile_plain(job, **kw)
    assert _equal(got, (counts, mins, shard_min_plain(mins)))


@pytest.mark.parametrize("layout", REDESIGNED,
                         ids=lambda l: "-".join(map(str, l)))
def test_redesigned_layout_occupancy(cuda, layout):
    """``scan_tile_occupancy`` reports the shape ``launch`` gives an
    8192-nonce step (threads, the plane's dynamic shared bytes), ptxas
    kept the registers under the launch bounds' cap, and the blocks per
    SM make at least 16 warps."""
    import ctypes

    from bitcoin_miner_tpu_torch.probes import ptxas

    k, variant, cgroup, interleave = layout
    name = tile_library(*layout)
    threads = sha256_tile.launch_threads(variant, interleave, 8192)
    blocks = sha256_tile.min_blocks(k, variant, interleave)
    assert blocks * threads // 32 == 16
    rows = [r for r in ptxas.ptxas_table(csrc.build([name]))
            if r["library"] == name and r["mode"] in ("word7", "exact")]
    assert {r["mode"] for r in rows} == {"word7", "exact"}
    for row in rows:
        assert row["registers"] <= 65536 // (blocks * threads), row
    lib = csrc.load(name)
    for word7 in (1, 0):
        vals = [ctypes.c_int() for _ in range(3)]
        csrc.check(lib.scan_tile_occupancy(
            word7, *(ctypes.addressof(v) for v in vals)), name)
        got_threads, smem, per_sm = (v.value for v in vals)
        assert (got_threads, smem) == (
            threads, sha256_tile.plane_bytes(variant, interleave))
        assert per_sm >= blocks and per_sm * threads // 32 >= 16
