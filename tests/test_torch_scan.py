"""Kernel-level parity: the plain tile scan and the plain hit-buffer scan
of the PyTorch package against the JAX reference's Pallas kernel (in
interpret mode) and XLA scan, on the same job blocks. Exact equality."""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitcoin_miner_tpu.backends.tpu import PallasTpuHasher
from bitcoin_miner_tpu.core.header import GENESIS_HEADER_HEX, GENESIS_NONCE
from bitcoin_miner_tpu.core.sha256 import sha256_midstate
from bitcoin_miner_tpu.core.target import (
    difficulty_to_target,
    nbits_to_target,
    target_to_limbs,
)
from bitcoin_miner_tpu.ops.sha256_jax import make_scan_fn
from bitcoin_miner_tpu.ops.sha256_pallas import make_pallas_scan_fn
from bitcoin_miner_tpu_torch.ops import sha256_tile, sha256_torch
from bitcoin_miner_tpu_torch.ops.sha256_tile import (
    job_block_from_header,
    scan_tile,
    scan_tile_plain,
)
from bitcoin_miner_tpu_torch.ops.sha256_torch import (
    hitbuf_geometry,
    scan_batch,
    scan_batch_plain,
)


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

TILE_BATCH = 1 << 11
HITBUF_BATCH, HITBUF_INNER, HITBUF_MAX = 1 << 12, 1 << 10, 16


def _header(seed):
    return np.random.default_rng(seed).integers(0, 256, 76, dtype=np.uint8).tobytes()


# (header, target, nonce_base, limit): full dispatches, limits that cut a
# step or leave whole steps past it, a base whose range wraps past 2^32,
# an all-hit target (every step's min tests the unsigned order), genesis.
CASES = {
    "easy_full": (_header(1), EASY, 123_456, 1 << 30),
    "easy_cut_mid_step": (_header(2), EASY, 77, 1500),
    "steps_past_limit": (_header(3), EASY, 9, 700),
    "wraps_past_2_32": (_header(4), EASY, (1 << 32) - 1000, 1 << 30),
    "all_hits_wrapping": (_header(5), EVERYTHING, (1 << 32) - 300, 1900),
    "genesis_diff1": (GENESIS76, DIFF1, GENESIS_NONCE - 1000, 1 << 30),
}


@pytest.fixture(scope="module")
def pallas_fns():
    """The reference Pallas scans, built once per (inner_tiles, word7)."""
    cache = {}

    def get(inner_tiles, word7):
        key = (inner_tiles, word7)
        if key not in cache:
            cache[key] = make_pallas_scan_fn(
                TILE_BATCH, 8, interpret=True, unroll=8, word7=word7,
                inner_tiles=inner_tiles)
        return cache[key]

    return get


@pytest.fixture(scope="module")
def xla_fns():
    cache = {}

    def get(word7):
        if word7 not in cache:
            cache[word7] = make_scan_fn(HITBUF_BATCH, HITBUF_INNER, HITBUF_MAX,
                                        unroll=8, word7=word7)
        return cache[word7]

    return get


class TestTileScanParity:
    @pytest.mark.parametrize("inner_tiles", [1, 2])
    @pytest.mark.parametrize("word7", [False, True])
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_matches_pallas_kernel(self, pallas_fns, case, word7, inner_tiles):
        header76, target, base, limit = CASES[case]
        limit = min(limit, TILE_BATCH)
        job = job_block_from_header(header76, target, base, limit)
        scan, block = pallas_fns(inner_tiles, word7)
        ref_counts, ref_mins = scan(jnp.asarray(job.numpy()))
        counts, mins = scan_tile_plain(job, n_steps=TILE_BATCH // block,
                                       block=block, word7=word7)
        assert counts.dtype == torch.int32 and mins.dtype == torch.uint32
        np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
        np.testing.assert_array_equal(mins.numpy(), np.asarray(ref_mins))

    def test_genesis_step_holds_the_solve(self):
        job = job_block_from_header(GENESIS76, DIFF1, GENESIS_NONCE - 5000,
                                    8192)
        counts, mins = scan_tile_plain(job, n_steps=4, block=2048, word7=True)
        assert counts.tolist() == [0, 0, 1, 0]
        assert int(mins[2]) == GENESIS_NONCE


class TestJobBlock:
    @pytest.mark.parametrize("seed", [11, 12, 13])
    def test_matches_pack_scalars(self, seed):
        rng = np.random.default_rng(seed)
        header76 = rng.integers(0, 256, 76, dtype=np.uint8).tobytes()
        target = difficulty_to_target(float(rng.choice([1.0, 1 / 256, 64.0])))
        base = int(rng.integers(0, 1 << 32))
        limit = int(rng.integers(1, 1 << 24))
        ref = PallasTpuHasher(batch_size=TILE_BATCH, interpret=True, unroll=8)
        packed = ref._pack_scalars(
            jnp.asarray(np.asarray(sha256_midstate(header76[:64]),
                                   dtype=np.uint32)),
            jnp.asarray(np.asarray(struct.unpack(">3I", header76[64:76]),
                                   dtype=np.uint32)),
            jnp.asarray(np.asarray(target_to_limbs(target), dtype=np.uint32)),
            jnp.uint32(base), jnp.uint32(limit))
        got = job_block_from_header(header76, target, base, limit)
        assert got.dtype == torch.uint32 and got.shape == (29,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(packed))


class TestHitBufferParity:
    @pytest.mark.parametrize("word7", [False, True])
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_matches_xla_scan(self, xla_fns, case, word7):
        """Includes overflow (count > max_hits at the easy and all-hit
        targets), limits that cut the range, wrap past 2^32 and word7."""
        header76, target, base, limit = CASES[case]
        job = job_block_from_header(header76, target, base,
                                    min(limit, 0xFFFFFFFF)).numpy()
        args = (job[0:8], job[16:19], job[19:27], job[27], job[28])
        ref_hits, ref_count = xla_fns(word7)(*(jnp.asarray(a) for a in args))
        hits, count = scan_batch_plain(
            *(torch.from_numpy(np.asarray(a)) for a in args),
            inner_size=HITBUF_INNER, n_steps=HITBUF_BATCH // HITBUF_INNER,
            max_hits=HITBUF_MAX, word7=word7)
        assert hits.dtype == torch.uint32 and count.dtype == torch.int32
        np.testing.assert_array_equal(hits.numpy(), np.asarray(ref_hits))
        assert int(count) == int(ref_count)

    def test_overflow_keeps_first_hits_and_uncapped_count(self):
        header76, target, base, _ = CASES["all_hits_wrapping"]
        job = job_block_from_header(header76, target, base, 3000).numpy()
        hits, count = scan_batch_plain(
            job[0:8], job[16:19], job[19:27], job[27], job[28],
            inner_size=1024, n_steps=4, max_hits=8)
        assert int(count) == 3000
        assert hits.tolist() == [(base + i) & 0xFFFFFFFF for i in range(8)]


class TestWrappers:
    """On CPU tensors the wrappers are the plain versions and launch
    nothing."""

    def test_scan_tile_on_cpu_is_plain(self):
        job = job_block_from_header(*CASES["easy_full"][:3], 4096)
        before = sha256_tile.SCAN_TILE.value
        got = scan_tile(job, n_steps=4, block=1024)
        want = scan_tile_plain(job, n_steps=4, block=1024)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert sha256_tile.SCAN_TILE.value == before

    def test_scan_batch_on_cpu_is_plain(self):
        job = job_block_from_header(*CASES["easy_full"][:3], 4096)
        parts = (job[0:8], job[16:19], job[19:27], job[27], job[28])
        before = sha256_torch.SCAN_HITBUF.value
        kw = dict(inner_size=1024, n_steps=4, max_hits=16)
        got = scan_batch(*parts, **kw)
        want = scan_batch_plain(*parts, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert sha256_torch.SCAN_HITBUF.value == before

    def test_hitbuf_compact_merges_blocks_in_order(self):
        """The plain merge of the fused scan's second stage: block slots
        in block order, capped at max_hits, the count uncapped."""
        counts = torch.tensor([0, 3, 100, 0, 2], dtype=torch.int32)
        slots = torch.arange(20, dtype=torch.int64).to(torch.uint32)
        before = sha256_torch.SCAN_HITBUF.value
        hits, count = sha256_torch.hitbuf_compact_plain(slots, counts, 4)
        assert hits.tolist() == [4, 5, 6, 8] and int(count) == 105
        hits, count = sha256_torch.hitbuf_compact_plain(slots[:8],
                                                        counts[:2], 4)
        assert hits.tolist() == [4, 5, 6, 0xFFFFFFFF] and int(count) == 3
        assert sha256_torch.SCAN_HITBUF.value == before

    @pytest.mark.parametrize("capacity, iters, blocks", [
        (8192, 1, 32), (1 << 24, 32, 2048), (1 << 32, 32, 1 << 19),
    ])
    def test_hitbuf_geometry(self, capacity, iters, blocks):
        assert hitbuf_geometry(capacity) == (iters, blocks)
