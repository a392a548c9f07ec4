"""The vshare path (overt AsicBoost: k version-rolled sibling chains that
share one chunk-2 message schedule) of the PyTorch package against the
JAX reference, on the CPU: the plain k-chain tile scan against the Pallas
kernel in interpret mode, the plain k-chain hit-buffer scan against the
XLA ``_scan_batch_vshare``, both hashers' ``ScanResult``s against the
reference hashers', the host's version axis and resume key against the
reference ``Job``, sibling shares through the dispatcher, and a Stratum
session against the package's validating mock pool. Every output is an
integer, so every comparison is exact."""

import asyncio
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitcoin_miner_tpu.backends import tpu as ref_tpu
from bitcoin_miner_tpu.backends.tpu import PallasTpuHasher, TpuHasher
from bitcoin_miner_tpu.core.header import GENESIS_HEADER_HEX, GENESIS_NONCE
from bitcoin_miner_tpu.core.sha256 import sha256d
from bitcoin_miner_tpu.core.target import difficulty_to_target, nbits_to_target
from bitcoin_miner_tpu.miner.job import Job as RefJob
from bitcoin_miner_tpu.ops import sha256_jax as ref_ops
from bitcoin_miner_tpu.ops.sha256_jax import make_scan_fn_vshare
from bitcoin_miner_tpu.ops.sha256_pallas import make_pallas_scan_fn
from bitcoin_miner_tpu_torch import cli
from bitcoin_miner_tpu_torch.backends import cuda as port_cuda
from bitcoin_miner_tpu_torch.backends.base import ScanResult
from bitcoin_miner_tpu_torch.backends.cuda import (
    DEFAULT_VERSION_MASK,
    CudaHasher,
    TileCudaHasher,
    sibling_version_patterns,
)
from bitcoin_miner_tpu_torch.miner.dispatcher import (
    Dispatcher,
    WorkItem,
    _sibling_item,
)
from bitcoin_miner_tpu_torch.miner.job import Job
from bitcoin_miner_tpu_torch.miner.runner import StratumMiner
from bitcoin_miner_tpu_torch.ops import sha256_tile, sha256_torch
from bitcoin_miner_tpu_torch.ops.sha256_tile import (
    job_block_from_header,
    scan_tile,
    scan_tile_plain,
)
from bitcoin_miner_tpu_torch.ops.sha256_torch import (
    bound_ms,
    hitbuf_compact_plain,
    ops_per_nonce,
    scan_batch_vshare,
    scan_batch_vshare_plain,
)
from bitcoin_miner_tpu_torch.testing import mock_pool as port_pool


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes,
    and a thread pool per worker would oversubscribe the cores that the
    timing-sensitive tests of other files share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


GENESIS76 = bytes.fromhex(GENESIS_HEADER_HEX)[:76]
DIFF1 = nbits_to_target(0x1D00FFFF)
EASY = difficulty_to_target(1 / (1 << 26))  # ~2^-6 per nonce
EVERYTHING = (1 << 256) - 1

TILE_BATCH = 4096  # 4 steps of 1024 nonces: the step·k + c order shows
HITBUF_BATCH, HITBUF_INNER, HITBUF_MAX = 4096, 1024, 8


def _header(seed):
    return np.random.default_rng(seed).integers(0, 256, 76, dtype=np.uint8).tobytes()


def _versions(header76, k, mask=DEFAULT_VERSION_MASK):
    version = int.from_bytes(header76[:4], "little")
    return [version] + [version ^ p for p in sibling_version_patterns(mask, k)]


# (header, target, nonce_base, limit): a limit that cuts the third step
# (and leaves the fourth wholly past it) on a range wrapping past 2^32; an
# all-hit target under the same cut; the genesis solve.
CASES = {
    "easy_cut_wraps": (_header(41), EASY, (1 << 32) - 1500, 2500),
    "all_hits_cut": (_header(42), EVERYTHING, 77, 2100),
    "genesis": (GENESIS76, DIFF1, GENESIS_NONCE - 2000, 1 << 30),
}


@pytest.fixture(scope="module")
def pallas_fns():
    cache = {}

    def get(k, word7):
        if (k, word7) not in cache:
            cache[k, word7] = make_pallas_scan_fn(
                batch_size=TILE_BATCH, sublanes=8, inner_tiles=1,
                interpret=True, unroll=8, vshare=k, word7=word7)
        return cache[k, word7]

    return get


class TestRoundMath:
    @pytest.mark.parametrize("word7", [False, True])
    @pytest.mark.parametrize("k", [2, 3])
    def test_sha256d_midstate_multi_matches_reference(self, k, word7):
        header76 = _header(48)
        job = job_block_from_header(header76, EASY, 0, 1,
                                    versions=_versions(header76, k)).numpy()
        mids, tail = job[:8 * k].reshape(k, 8), job[16 * k:16 * k + 3]
        nonces = np.random.default_rng(k).integers(0, 1 << 32, 512,
                                                   dtype=np.uint64)
        ref = ref_ops.sha256d_midstate_multi(
            jnp.asarray(mids), jnp.asarray(tail),
            jnp.asarray(nonces.astype(np.uint32)), unroll=8, word7=word7)
        got = sha256_torch.sha256d_midstate_multi(
            mids, tail, torch.from_numpy(nonces.astype(np.int64)), word7=word7)
        assert len(got) == len(ref) == k
        for g, r in zip(got, ref):
            g = np.stack([x.numpy() for x in (g if not word7 else [g])])
            r = np.stack([np.asarray(x) for x in (r if not word7 else [r])])
            np.testing.assert_array_equal(g, r.astype(np.int64))

    def test_compress_multi_matches_reference(self):
        rng = np.random.default_rng(49)
        states = rng.integers(0, 1 << 32, (3, 8), dtype=np.uint64)
        w = rng.integers(0, 1 << 32, 16, dtype=np.uint64)
        ref = ref_ops.compress_multi(
            [tuple(jnp.uint32(int(x)) for x in s) for s in states],
            [jnp.uint32(int(x)) for x in w])
        got = sha256_torch.compress_multi(
            [tuple(int(x) for x in s) for s in states], [int(x) for x in w])
        assert got == [tuple(int(x) for x in r) for r in ref]
        assert got[1] == sha256_torch.compress(
            tuple(int(x) for x in states[1]), [int(x) for x in w])


class TestTileScanVShare:
    @pytest.mark.parametrize("case", sorted(CASES))
    @pytest.mark.parametrize("word7", [False, True])
    @pytest.mark.parametrize("k", [2, 3, 4])
    def test_matches_pallas_kernel(self, pallas_fns, k, word7, case):
        header76, target, base, limit = CASES[case]
        job = job_block_from_header(header76, target, base,
                                    min(limit, TILE_BATCH),
                                    versions=_versions(header76, k))
        assert job.shape == (16 * k + 13,)
        scan, block = pallas_fns(k, word7)
        ref_counts, ref_mins = scan(jnp.asarray(job.numpy()))
        counts, mins = scan_tile_plain(job, n_steps=TILE_BATCH // block,
                                       block=block, word7=word7, vshare=k)
        assert counts.dtype == torch.int32 and mins.dtype == torch.uint32
        assert counts.shape == (TILE_BATCH // block * k,)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
        np.testing.assert_array_equal(mins.numpy(), np.asarray(ref_mins))

    @pytest.mark.parametrize("k", [1, 2, 4])
    def test_job_block_matches_pack_scalars(self, k):
        header76 = _header(43)
        target = difficulty_to_target(1 / 256)
        ref = PallasTpuHasher(batch_size=TILE_BATCH, interpret=True, unroll=8,
                              vshare=k)
        midstate, tail3, limbs, ctx = ref._job_constants(header76, target)
        packed = ref._pack_scalars(midstate, tail3, limbs, jnp.uint32(99),
                                   jnp.uint32(4000), ctx)
        got = job_block_from_header(header76, target, 99, 4000,
                                    versions=_versions(header76, k))
        np.testing.assert_array_equal(got.numpy(), np.asarray(packed))

    def test_one_version_is_the_one_chain_block(self):
        header76 = _header(44)
        np.testing.assert_array_equal(
            job_block_from_header(header76, EASY, 5, 6).numpy(),
            job_block_from_header(header76, EASY, 5, 6,
                                  versions=_versions(header76, 1)).numpy())

    def test_block_length_must_match_vshare(self):
        job = job_block_from_header(_header(45), EASY, 0, 1024)
        with pytest.raises(ValueError, match="expected 45 words"):
            scan_tile_plain(job, n_steps=1, block=1024, vshare=2)


class TestHitBufferVShare:
    @pytest.mark.parametrize("case", sorted(CASES))
    @pytest.mark.parametrize("word7", [False, True])
    @pytest.mark.parametrize("k", [2, 4])
    def test_matches_xla_scan(self, k, word7, case):
        """Includes per-chain overflow (far more than 8 hits per chain at
        the easy and all-hit targets), a cut limit and a wrap past 2^32."""
        header76, target, base, limit = CASES[case]
        job = job_block_from_header(header76, target, base,
                                    min(limit, 0xFFFFFFFF),
                                    versions=_versions(header76, k)).numpy()
        mids = job[:8 * k].reshape(k, 8)
        args = (mids, job[16 * k:16 * k + 3], job[16 * k + 3:16 * k + 11],
                job[16 * k + 11], job[16 * k + 12])
        ref_fn = make_scan_fn_vshare(HITBUF_BATCH, HITBUF_INNER, HITBUF_MAX,
                                     unroll=8, word7=word7, vshare=k)
        ref_bufs, ref_counts = ref_fn(*(jnp.asarray(a) for a in args))
        bufs, counts = scan_batch_vshare_plain(
            *(torch.from_numpy(np.asarray(a)) for a in args),
            inner_size=HITBUF_INNER, n_steps=HITBUF_BATCH // HITBUF_INNER,
            max_hits=HITBUF_MAX, word7=word7)
        assert bufs.dtype == torch.uint32 and counts.dtype == torch.int32
        assert bufs.shape == (k, HITBUF_MAX) and counts.shape == (k,)
        np.testing.assert_array_equal(bufs.numpy(), np.asarray(ref_bufs))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
        if case != "genesis":
            assert (counts.numpy() > HITBUF_MAX).all()


class TestWrappersOnCpu:
    """On CPU tensors the k-chain wrappers are the plain versions and
    launch nothing."""

    def test_scan_tile_vshare_is_plain(self):
        header76 = _header(46)
        job = job_block_from_header(header76, EASY, 3, 4096,
                                    versions=_versions(header76, 3))
        before = sha256_tile.SCAN_TILE_K[3].value
        got = scan_tile(job, n_steps=4, block=1024, vshare=3)
        want = scan_tile_plain(job, n_steps=4, block=1024, vshare=3)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert sha256_tile.SCAN_TILE_K[3].value == before

    def test_scan_batch_vshare_is_plain(self):
        header76 = _header(47)
        job = job_block_from_header(header76, EASY, 3, 4096,
                                    versions=_versions(header76, 2))
        parts = (job[:16].view(2, 8), job[32:35], job[35:43], job[43], job[44])
        kw = dict(inner_size=1024, n_steps=4, max_hits=16)
        before = sha256_torch.SCAN_HITBUF_K[2].value
        got = scan_batch_vshare(*parts, **kw)
        want = scan_batch_vshare_plain(*parts, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert sha256_torch.SCAN_HITBUF_K[2].value == before

    def test_hitbuf_compact_merges_each_chain_in_block_order(self):
        counts = torch.tensor([[0, 3, 100, 0, 2], [1, 0, 0, 9, 0]],
                              dtype=torch.int32)
        slots = torch.arange(40, dtype=torch.int64).to(torch.uint32)
        hits, count = hitbuf_compact_plain(slots, counts, 4)
        assert hits.tolist() == [[4, 5, 6, 8], [20, 32, 33, 34]]
        assert count.tolist() == [105, 10]


class TestOpCount:
    def test_one_chain_counts_are_unchanged(self):
        assert ops_per_nonce(True, 1).total == ops_per_nonce(True).total == 2466
        assert ops_per_nonce(False, 1).total == ops_per_nonce(False).total == 2573

    @pytest.mark.parametrize("word7", [False, True])
    def test_shared_schedule_is_counted_once(self, word7):
        """Each further chain adds the same cost: its chunk-2 rounds,
        feedforward, second compression and compare — not the schedule."""
        totals = [ops_per_nonce(word7, k).total for k in range(1, 9)]
        per_chain = totals[1] - totals[0]
        assert all(b - a == per_chain for a, b in zip(totals, totals[1:]))
        # What is left of one chain's count is the nonce's byte swap and
        # the expansion of chunk 2's schedule words 16-63, counted alone.
        tally = sha256_torch.OpTally()
        w = ([sha256_torch.UNIFORM] * 3 + [sha256_torch.VARYING]
             + sha256_torch._CHUNK2_PAD)
        for i in range(16, 64):
            w[i % 16] = tally.schedule_word(w, i)
        assert totals[0] - per_chain == 1 + tally.logic + tally.adds == 381
        assert ops_per_nonce(True, 2).total == 4551
        assert ops_per_nonce(False, 2).total == 4765

    def test_bound_is_per_dispatch_of_nonces(self):
        one = bound_ms(1 << 24, True, 132, 1.98e9)
        assert one == bound_ms(1 << 24, True, 132, 1.98e9, vshare=1)
        two = bound_ms(1 << 24, True, 132, 1.98e9, vshare=2)
        assert 1.8 < two / one < 2.0  # 2 hashes per nonce, one schedule


class TestSiblingVersionPatterns:
    @pytest.mark.parametrize("seed", [51, 52, 53, 54])
    def test_matches_reference(self, seed):
        rng = np.random.default_rng(seed)
        for _ in range(20):
            mask = int(rng.integers(0, 1 << 32)) & int(rng.integers(0, 1 << 32))
            for k in range(1, 9):
                try:
                    want = ref_tpu.sibling_version_patterns(mask, k)
                except ValueError:
                    with pytest.raises(ValueError):
                        sibling_version_patterns(mask, k)
                    continue
                got = sibling_version_patterns(mask, k)
                assert got == want
                assert all(p and p & ~mask == 0 for p in got)
                assert len(set(got)) == k - 1

    @pytest.mark.parametrize("mask, k", [(0, 2), (1 << 13, 3), (0b11, 5)])
    def test_too_narrow_masks_raise(self, mask, k):
        with pytest.raises(ValueError, match="rollable bits"):
            sibling_version_patterns(mask, k)
        with pytest.raises(ValueError):
            ref_tpu.sibling_version_patterns(mask, k)

    def test_default_mask_is_the_historical_shift(self):
        assert sibling_version_patterns(DEFAULT_VERSION_MASK, 4) == [
            1 << 13, 2 << 13, 3 << 13]


# ----------------------------------------------------------- hasher seam
BATCH = 1 << 11

# (label, mask, header, target, start, count)
SEAM_CASES = [
    ("default_mask", DEFAULT_VERSION_MASK, _header(61), EASY, 1000, 5000),
    ("narrow_mask", 1 << 20, _header(62), EASY, (1 << 32) - 4000, 4000),
    ("degraded_mask0", 0, _header(63), EASY, 0, 3000),
    ("genesis_word7", DEFAULT_VERSION_MASK, GENESIS76, DIFF1,
     GENESIS_NONCE - 1500, 3000),
    ("truncated_every_nonce", DEFAULT_VERSION_MASK, _header(64), EVERYTHING,
     0, 3000),
]


def _seam_fields(result):
    return (result.nonces, result.total_hits, result.hashes_done,
            [tuple(v) for v in result.version_hits], result.version_total_hits)


@pytest.fixture(scope="module")
def seam_pair(request):
    """(port hasher, reference hasher) for "cuda-tile" (against the Pallas
    hasher in interpret mode) and "cuda" (against the XLA hasher)."""
    cache = {}

    def get(backend):
        if backend not in cache:
            if backend == "cuda-tile":
                cache[backend] = (
                    TileCudaHasher(batch_size=BATCH, device="cpu", vshare=2),
                    PallasTpuHasher(batch_size=BATCH, sublanes=8,
                                    interpret=True, unroll=8, vshare=2))
            else:
                cache[backend] = (
                    CudaHasher(batch_size=BATCH, inner_size=1 << 9,
                               device="cpu", vshare=2),
                    TpuHasher(batch_size=BATCH, inner_size=1 << 9, unroll=8,
                              vshare=2))
        return cache[backend]

    return get


class TestHasherSeam:
    @pytest.mark.parametrize("case", SEAM_CASES, ids=[c[0] for c in SEAM_CASES])
    @pytest.mark.parametrize("backend", ["cuda-tile", "cuda"])
    def test_scan_result_matches_reference(self, seam_pair, backend, case):
        label, mask, header76, target, start, count = case
        port, ref = seam_pair(backend)
        assert port.set_version_mask(mask) == ref.set_version_mask(mask)
        got = port.scan(header76, start, count, target)
        want = ref.scan(header76, start, count, target)
        assert _seam_fields(got) == _seam_fields(want)
        assert got.hashes_done == count * (1 if mask == 0 else 2)
        if label == "degraded_mask0":
            assert got.version_hits == [] and got.version_total_hits == 0
        elif label == "truncated_every_nonce":
            assert got.version_truncated and got.truncated
        elif label == "genesis_word7":
            assert got.nonces == [GENESIS_NONCE]
        else:
            assert got.version_hits, "an easy target gives sibling hits"
            version = int.from_bytes(header76[:4], "little")
            pattern = sibling_version_patterns(mask, 2)[0]
            assert {v for v, _ in got.version_hits} == {version ^ pattern}

    def test_degraded_mode_logs_once_and_launches_one_chain(self, caplog):
        h = TileCudaHasher(batch_size=BATCH, device="cpu", vshare=2)
        with caplog.at_level("ERROR", logger=port_cuda.logger.name):
            assert h.set_version_mask(0) == 0
            assert h.set_version_mask(0) == 0
        assert len([r for r in caplog.records
                    if "cannot carry" in r.getMessage()]) == 1
        assert h._job_constants(_header(65), EASY).chains == 1
        assert h.set_version_mask(DEFAULT_VERSION_MASK) == 1
        assert h._job_constants(_header(65), EASY).chains == 2

    def test_constants_are_keyed_on_the_mask(self):
        h = CudaHasher(batch_size=BATCH, inner_size=1 << 9, device="cpu",
                       vshare=4)
        wide = h._job_constants(_header(66), EASY)
        h.set_version_mask(1 << 20 | 1 << 5)
        narrow = h._job_constants(_header(66), EASY)
        version = int.from_bytes(_header(66)[:4], "little")
        assert wide.versions == tuple(_versions(_header(66), 4))
        assert narrow.versions == (version, version ^ 1 << 5,
                                   version ^ 1 << 20, version ^ (1 << 20 | 1 << 5))
        assert h._job_constants(_header(66), EASY) is narrow

    def test_mask_change_during_build_is_not_cached(self, monkeypatch):
        """A scan racing set_version_mask builds every chain from one
        reading of the mask and leaves no torn entry in the cache."""
        h = CudaHasher(batch_size=BATCH, inner_size=1 << 9, device="cpu",
                       vshare=2)
        build = port_cuda.JobConstants.build

        def racing_build(*args):
            entry = build(*args)
            h.set_version_mask(1 << 20)
            return entry

        monkeypatch.setattr(port_cuda.JobConstants, "build", racing_build)
        entry = h._job_constants(_header(67), EASY)
        version = int.from_bytes(_header(67)[:4], "little")
        assert entry.versions == (version, version ^ 1 << 13)
        assert not h._consts_cache


# ------------------------------------------------------- host version axis
def _job_fields(**overrides):
    fields = dict(
        job_id="vs", prevhash_internal=sha256d(b"prev"),
        coinb1=bytes.fromhex("01000000") + b"\x11" * 30,
        coinb2=b"\x22" * 30 + bytes.fromhex("00000000"),
        extranonce1=b"\xaa\xbb\xcc\xdd", extranonce2_size=4,
        merkle_branch=[sha256d(b"tx1")], version=0x20000000, nbits=0x1D00FFFF,
        ntime=0x655F2B2C, share_target=difficulty_to_target(1 / (1 << 24)),
        version_mask=DEFAULT_VERSION_MASK)
    fields.update(overrides)
    return fields


class TestJobVersionAxis:
    @pytest.mark.parametrize("mask, reserved", [
        (DEFAULT_VERSION_MASK, 0), (DEFAULT_VERSION_MASK, 1),
        (DEFAULT_VERSION_MASK, 3), (0x00F0F000, 2), (0, 0)])
    def test_rolled_version_and_resume_key_match_reference(self, mask,
                                                           reserved):
        kw = _job_fields(version_mask=mask, reserved_version_bits=reserved)
        port, ref = Job(**kw), RefJob(**kw)
        assert port.version_variants == ref.version_variants
        for v in list(range(64)) + [port.version_variants - 1]:
            assert port.rolled_version(v) == ref.rolled_version(v)
        assert port.sweep_key == ref.sweep_key

    def test_reserved_bits_fold_into_resume_key_only_when_set(self):
        a = Job(**_job_fields())
        assert a.sweep_key != dataclasses.replace(
            a, reserved_version_bits=2).sweep_key
        assert a.sweep_key == Job(**_job_fields(reserved_version_bits=0)).sweep_key


class TestVShareMining:
    """Ports of the reference's ``tests/test_dispatcher.py::
    TestVShareMining`` onto the package's dispatcher and hashers."""

    def test_set_job_wires_mask_and_reserves_kernel_bits(self):
        h = TileCudaHasher(batch_size=1 << 12, device="cpu", vshare=4)
        job = Dispatcher(h, n_workers=1).set_job(Job(**_job_fields()))
        assert job.reserved_version_bits == 2  # k=4 -> 2 low mask bits
        assert job.version_variants == 1 << 14  # 16 mask bits - 2
        kernel_bits = (1 << 13) | (1 << 14)
        for v in range(64):
            assert (job.rolled_version(v) ^ job.version) & kernel_bits == 0

    def test_sibling_hits_become_in_mask_shares(self):
        h = TileCudaHasher(batch_size=1 << 12, device="cpu", vshare=2)
        d = Dispatcher(h, n_workers=1)
        job = d.set_job(Job(**_job_fields()))
        header76 = job.header76(b"\0" * 4)
        item = WorkItem(job.generation, job, b"\0" * 4, header76, 0, 6000,
                        ntime=job.ntime, version=job.version)
        result = h.scan(header76, 0, 6000, job.share_target)
        shares = list(d._shares_from_result(item, result))
        own = job.version.to_bytes(4, "little")
        sibling = job.version ^ (1 << 13)
        sib_shares = [s for s in shares if s.header80[:4] != own]
        assert sib_shares and len(sib_shares) == len(result.version_hits)
        assert len(shares) - len(sib_shares) == len(result.nonces) > 0
        for s in sib_shares:
            assert s.header80[:4] == sibling.to_bytes(4, "little")
            assert s.version_bits == sibling & DEFAULT_VERSION_MASK
            assert s.hash_int <= job.share_target
        assert d.stats.hw_errors == 0

    def test_bogus_sibling_hit_is_dropped_as_hw_error(self):
        d = Dispatcher(TileCudaHasher(batch_size=1 << 12, device="cpu",
                                      vshare=2), n_workers=1)
        job = d.set_job(Job(**_job_fields()))
        item = WorkItem(job.generation, job, b"", job.header76(b"\0" * 4), 0,
                        1 << 12, ntime=job.ntime)
        sib = _sibling_item(item, job.version ^ (1 << 13))
        assert sib.header76[4:] == item.header76[4:]
        assert d._verify_hit(sib, 12345) is None  # ~surely not a hit
        assert d.stats.hw_errors == 1
        # A truncated sibling list still yields what was stored.
        bogus = ScanResult(version_hits=[(job.version ^ 1 << 13, 12345)],
                           version_total_hits=5)
        assert bogus.version_truncated
        assert list(d._shares_from_result(item, bogus)) == []
        assert d.stats.hw_errors == 2

    def test_no_mask_job_degrades_to_chain0(self):
        h = TileCudaHasher(batch_size=1 << 12, device="cpu", vshare=2)
        d = Dispatcher(h, n_workers=1)
        job = d.set_job(Job(**_job_fields(version_mask=0)))
        assert job.reserved_version_bits == 0 and job.version_variants == 1
        result = h.scan(job.header76(b"\0" * 4), 0, 4000, job.share_target)
        assert result.nonces and result.version_hits == []
        assert result.hashes_done == 4000


def test_stratum_session_mines_sibling_shares():
    """The package's StratumMiner with four chains on the CPU against its
    own validating pool: sibling shares with in-mask version bits are
    accepted beside chain-0 shares, none rejected."""
    async def main():
        pool = port_pool.MockStratumPool(difficulty=1 / (1 << 24),
                                         version_mask=DEFAULT_VERSION_MASK)
        await pool.start()
        await pool.announce_job(port_pool.PoolJob(
            job_id="v4", prevhash_internal=sha256d(b"prev v4"),
            coinb1=bytes.fromhex("01000000") + b"\x11" * 30,
            coinb2=b"\x22" * 30 + bytes.fromhex("00000000"),
            merkle_branch=[sha256d(b"tx1")], version=0x20000000,
            nbits=0x1D00FFFF, ntime=0x655F2B2C))
        miner = StratumMiner(
            "127.0.0.1", pool.port, "w",
            hasher=TileCudaHasher(batch_size=1 << 12, device="cpu", vshare=4),
            n_workers=2, batch_size=1 << 12)
        run_task = asyncio.create_task(miner.run())
        stats = miner.dispatcher.stats

        def siblings():
            return [s for s in pool.shares
                    if s.accepted and s.version_bits != 0x20000000 & DEFAULT_VERSION_MASK]

        try:
            deadline = asyncio.get_running_loop().time() + 120
            while len(siblings()) < 3 or stats.shares_accepted < 6:
                assert asyncio.get_running_loop().time() < deadline, (
                    f"{stats.summary()} pool={pool.shares[:5]}")
                assert not run_task.done(), run_task
                await asyncio.sleep(0.05)
        finally:
            miner.stop()
            await asyncio.gather(run_task, return_exceptions=True)
            await pool.stop()
        assert all(s.accepted for s in pool.shares), [
            s.reason for s in pool.shares if not s.accepted]
        assert stats.hw_errors == 0 and stats.shares_rejected == 0
        assert all(s.version_bits & ~DEFAULT_VERSION_MASK == 0
                   for s in pool.shares)
        # Sibling bits are the two lowest mask bits, the host axis above.
        assert {s.version_bits & (3 << 13) for s in siblings()} - {0}

    asyncio.run(asyncio.wait_for(main(), 180))


class TestCommandLine:
    def test_bench_vshare_finds_genesis_and_counts_every_chain(self, capsys):
        rc = cli.main(["--bench", "--device", "cpu", "--batch-bits", "13",
                       "--bench-nonces", str(1 << 14), "--vshare", "2"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "FOUND+VERIFIED" in out and f"over {1 << 15} hashes" in out

    def test_vshare_and_cgroup_checks(self):
        parse = cli.build_parser().parse_args
        with pytest.raises(SystemExit, match="--vshare 2"):
            cli.make_hasher(parse(["--bench", "--backend", "cpu",
                                   "--vshare", "2"]))
        with pytest.raises(SystemExit, match="--cgroup"):
            cli.make_hasher(parse(["--bench", "--backend", "cuda",
                                   "--device", "cpu", "--cgroup", "2"]))
        for cgroup in range(5):  # every chain-pass size in 0..k
            h = cli.make_hasher(parse(["--bench", "--device", "cpu",
                                       "--vshare", "4", "--cgroup",
                                       str(cgroup)]))
            assert isinstance(h, TileCudaHasher) and h.version_roll_bits == 2
            assert h.cgroup == cgroup
        with pytest.raises(SystemExit, match=r"between 1 and --vshare \(4\)"):
            cli.make_hasher(parse(["--bench", "--device", "cpu",
                                   "--vshare", "4", "--cgroup", "5"]))

    def test_vshare_needs_a_card_unless_asked_for_the_cpu(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.make_hasher(cli.build_parser().parse_args(
                ["--bench", "--vshare", "2"]))
