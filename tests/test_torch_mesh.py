"""Nonce sharding in the PyTorch package against the JAX reference on the
CPU: the three ``ShardedScan`` factories of ``parallel/mesh.py`` against
``make_sharded_scan_fn``, ``make_sharded_scan_fn_vshare`` and
``make_sharded_pallas_scan_fn`` (interpret mode) on the conftest's 8
virtual CPU devices, shard for shard; then the ``cuda-mesh`` and
``cuda-tile-mesh`` hashers against ``tpu-mesh`` and ``tpu-pallas-mesh``,
``ScanResult`` for ``ScanResult``, including a partial final dispatch and
K = 2 sibling hits. The port's mesh names the CPU 8 times: on the CPU every
shard runs its kernels' plain versions (the card's kernels are held against
those in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitcoin_miner_tpu.backends.tpu import ShardedPallasTpuHasher, ShardedTpuHasher
from bitcoin_miner_tpu.core.header import GENESIS_HEADER_HEX, GENESIS_NONCE
from bitcoin_miner_tpu.core.target import difficulty_to_target, nbits_to_target
from bitcoin_miner_tpu.parallel import mesh as jax_mesh
from bitcoin_miner_tpu_torch.backends.base import dispatch_granularity, get_hasher
from bitcoin_miner_tpu_torch.backends.cuda import (
    ShardedCudaHasher,
    ShardedTileCudaHasher,
)
from bitcoin_miner_tpu_torch.ops.sha256_tile import job_block_from_header
from bitcoin_miner_tpu_torch.ops.sha256_torch import MASK32
from bitcoin_miner_tpu_torch.parallel import mesh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


HEADER = bytes.fromhex(GENESIS_HEADER_HEX)[:76]
DIFF1 = nbits_to_target(0x1D00FFFF)
EASY = difficulty_to_target(1 / (1 << 22))  # ~2^-10 per nonce
N_DEV = 8
BPD = 1 << 10  # nonces per device
INNER = 1 << 8
MAX_HITS = 16
CPU8 = ["cpu"] * N_DEV


def _versions(k):
    version = int.from_bytes(HEADER[:4], "little")
    return [version, version ^ (1 << 13)][:k]


def _job(target, base, limit, k=1):
    return job_block_from_header(HEADER, target, base, limit,
                                 versions=_versions(k)).numpy()


def _hitbuf_args(words, k):
    """The reference's (midstate(s), tail3, limbs, base, limit) of a job
    block of k chains."""
    t = 16 * k
    mids = words[0:8] if k == 1 else words[0:8 * k].reshape(k, 8)
    return [jnp.asarray(a) for a in
            (mids, words[t:t + 3], words[t + 3:t + 11], words[t + 11],
             words[t + 12])]


def _stacked(outputs, i):
    return np.stack([o[i].numpy() for o in outputs])


#: (case, target, base, limit): a dispatch over every shard; one whose
#: limit ends inside shard 2 (the shards after it launch with limit 0); one
#: that wraps past 2^32.
DISPATCHES = [
    ("full", EASY, 4_321, N_DEV * BPD),
    ("ends_in_shard_2", EASY, 77, 2 * BPD + 301),
    ("wraps", EASY, (1 << 32) - 3 * BPD - 5, N_DEV * BPD - 700),
]


def _ids(cases):
    return [c[0] for c in cases]


def test_first_devices_and_repeats():
    assert jax.device_count() == N_DEV
    assert mesh.make_mesh(devices=CPU8) == (torch.device("cpu"),) * N_DEV
    with pytest.raises(ValueError, match="contradicts"):
        mesh.make_mesh(2, devices=["cpu"])
    with pytest.raises(ValueError, match="non-empty"):
        mesh.make_mesh(devices=[])


def test_shard_ranges_saturate():
    assert mesh.shard_ranges(4, 100, MASK32 - 150, 250) == [
        (MASK32 - 150, 100), (MASK32 - 50, 100), (49, 50), (149, 0)]


class TestFactories:
    @pytest.fixture(scope="class")
    def jmesh(self):
        return jax_mesh.make_mesh(N_DEV)

    @pytest.mark.parametrize("case, target, base, limit", DISPATCHES,
                             ids=_ids(DISPATCHES))
    def test_hitbuf_scan_matches_shard_map(self, jmesh, case, target, base,
                                           limit):
        words = _job(target, base, limit)
        ref = jax_mesh.make_sharded_scan_fn(
            jmesh, BPD, INNER, MAX_HITS, unroll=8)(*_hitbuf_args(words, 1))
        got = mesh.make_sharded_scan_fn(mesh.make_mesh(devices=CPU8), BPD,
                                        INNER, MAX_HITS)(words)
        assert len(got) == N_DEV
        np.testing.assert_array_equal(_stacked(got, 0), np.asarray(ref[0]))
        np.testing.assert_array_equal(_stacked(got, 1), np.asarray(ref[1]))
        assert mesh.first_hit(got) == int(ref[2])
        if case == "ends_in_shard_2":
            for buf, count, lowest in got[3:]:
                assert int(count) == 0 and int(lowest) == MASK32
                assert (buf.to(torch.int64) == MASK32).all()

    @pytest.mark.parametrize("word7", [False])
    def test_vshare_scan_matches_shard_map(self, jmesh, word7):
        words = _job(EASY, 9_000, 5 * BPD + 17, 2)
        ref = jax_mesh.make_sharded_scan_fn_vshare(
            jmesh, BPD, INNER, MAX_HITS, unroll=8, word7=word7,
            vshare=2)(*_hitbuf_args(words, 2))
        got = mesh.make_sharded_scan_fn_vshare(
            mesh.make_mesh(devices=CPU8), BPD, INNER, MAX_HITS, word7=word7,
            vshare=2)(words)
        np.testing.assert_array_equal(_stacked(got, 0), np.asarray(ref[0]))
        np.testing.assert_array_equal(_stacked(got, 1), np.asarray(ref[1]))
        assert mesh.first_hit(got) == int(ref[2])

    @pytest.mark.parametrize("case, k", [("full", 1), ("ends_in_shard_2", 1),
                                         ("wraps", 1), ("ends_in_shard_2", 2)])
    def test_tile_scan_matches_sharded_pallas(self, jmesh, case, k):
        _, target, base, limit = next(d for d in DISPATCHES if d[0] == case)
        words = _job(target, base, limit, k)
        ref_scan, ref_tile = jax_mesh.make_sharded_pallas_scan_fn(
            jmesh, BPD, sublanes=8, interpret=True, unroll=8, inner_tiles=1,
            vshare=k)
        scan, tile = mesh.make_sharded_tile_scan_fn(
            mesh.make_mesh(devices=CPU8), BPD, sublanes=8, inner_tiles=1,
            vshare=k)
        assert tile == ref_tile == 1024
        ref = ref_scan(jnp.asarray(words))
        got = scan(words)
        np.testing.assert_array_equal(_stacked(got, 0), np.asarray(ref[0]))
        np.testing.assert_array_equal(_stacked(got, 1), np.asarray(ref[1]))
        assert mesh.first_hit(got) == int(ref[2])

    def test_genesis_first_hit(self):
        scan, _ = mesh.make_sharded_tile_scan_fn(
            mesh.make_mesh(devices=CPU8), BPD, sublanes=8, inner_tiles=1,
            word7=True)
        got = scan(_job(DIFF1, GENESIS_NONCE - 5 * BPD - 3, N_DEV * BPD))
        assert mesh.first_hit(got) == GENESIS_NONCE
        assert int(got[5][1].to(torch.int64).min()) == GENESIS_NONCE

    def test_limit_over_the_mesh_is_refused(self):
        scan = mesh.make_sharded_scan_fn(mesh.make_mesh(devices=CPU8), BPD,
                                         INNER)
        with pytest.raises(ValueError, match="exceeds"):
            scan(_job(EASY, 0, N_DEV * BPD + 1))

    def test_merge_device_hits_is_the_reference(self):
        rng = np.random.default_rng(5)
        bufs = rng.integers(0, 1 << 32, (N_DEV, MAX_HITS), dtype=np.uint64)
        counts = rng.integers(0, 2 * MAX_HITS, N_DEV)
        assert mesh.merge_device_hits(bufs, counts, MAX_HITS) == (
            jax_mesh.merge_device_hits(bufs, counts, MAX_HITS))


def _assert_same(got, want):
    assert got.nonces == want.nonces
    assert got.total_hits == want.total_hits
    assert got.hashes_done == want.hashes_done
    assert sorted(got.version_hits) == sorted(want.version_hits)
    assert got.version_total_hits == want.version_total_hits


class TestHashers:
    @pytest.fixture(scope="class")
    def xla_mesh(self):
        return ShardedTpuHasher(batch_per_device=BPD, inner_size=INNER,
                                unroll=8)

    @pytest.fixture(scope="class")
    def pallas_mesh(self):
        return ShardedPallasTpuHasher(batch_per_device=BPD, sublanes=8,
                                      inner_tiles=1, interpret=True, unroll=8)

    def test_dispatch_size(self):
        h = ShardedTileCudaHasher(batch_per_device=BPD, sublanes=8,
                                  inner_tiles=1, devices=CPU8)
        assert (h.n_devices, h.dispatch_size) == (N_DEV, N_DEV * BPD)
        assert dispatch_granularity(h) == N_DEV * BPD
        assert h.compile_count == 0

    #: (start, count): several dispatches; a partial final one.
    RANGES = [(5_000, 3 * N_DEV * BPD), (0, 12_345)]

    @pytest.mark.parametrize("start, count", RANGES)
    def test_cuda_mesh_matches_tpu_mesh(self, xla_mesh, start, count):
        h = ShardedCudaHasher(batch_per_device=BPD, inner_size=INNER,
                              devices=CPU8)
        _assert_same(h.scan(HEADER, start, count, EASY),
                     xla_mesh.scan(HEADER, start, count, EASY))
        assert h.compile_count == 1

    def test_cuda_tile_mesh_matches_tpu_pallas_mesh(self, pallas_mesh):
        """A partial dispatch against the reference's sharded hasher; three
        whole dispatches against the hashlib oracle."""
        h = ShardedTileCudaHasher(batch_per_device=BPD, sublanes=8,
                                  inner_tiles=1, devices=CPU8)
        count = N_DEV * BPD - 1_851
        _assert_same(h.scan(HEADER, 7, count, EASY),
                     pallas_mesh.scan(HEADER, 7, count, EASY))
        start, count = self.RANGES[0]
        _assert_same(h.scan(HEADER, start, count, EASY),
                     get_hasher("cpu").scan(HEADER, start, count, EASY))
        assert h.compile_count == 1

    def test_genesis_word7_across_shards(self, pallas_mesh):
        h = ShardedTileCudaHasher(batch_per_device=BPD, sublanes=8,
                                  inner_tiles=1, devices=CPU8)
        start = GENESIS_NONCE - h.dispatch_size // 2
        got = h.scan(HEADER, start, h.dispatch_size, DIFF1)
        assert got.nonces == [GENESIS_NONCE]
        _assert_same(got, pallas_mesh.scan(HEADER, start, h.dispatch_size,
                                           DIFF1))

    @pytest.mark.parametrize("kind", ["cuda-mesh", "cuda-tile-mesh"])
    def test_sibling_hits_match(self, kind):
        """K = 2 over all 8 shards: chain 0 and the sibling chain against
        the reference's sharded hashers, hits from several shards."""
        count = N_DEV * BPD - 999
        if kind == "cuda-mesh":
            ref = ShardedTpuHasher(batch_per_device=BPD, inner_size=INNER,
                                   unroll=8, vshare=2)
            port = ShardedCudaHasher(batch_per_device=BPD, inner_size=INNER,
                                     vshare=2, devices=CPU8)
        else:
            ref = ShardedPallasTpuHasher(batch_per_device=BPD, sublanes=8,
                                         inner_tiles=1, interpret=True,
                                         unroll=8, vshare=2)
            port = ShardedTileCudaHasher(batch_per_device=BPD, sublanes=8,
                                         inner_tiles=1, vshare=2,
                                         devices=CPU8)
        got = port.scan(HEADER, 0, count, EASY)
        _assert_same(got, ref.scan(HEADER, 0, count, EASY))
        assert got.hashes_done == 2 * count
        assert got.version_hits
        assert len({n // BPD for _, n in got.version_hits}) > 1

    def test_word7_overflow_uses_the_worst_shard(self):
        """Each shard's buffer holds at most max_hits candidates: the
        overflow check reads the worst shard's count (3 and 5 → 5), not
        their sum (8), as ``ShardedTpuHasher`` does."""
        h = ShardedCudaHasher(batch_per_device=BPD, inner_size=INNER,
                              max_hits=4, devices=["cpu"] * 2)
        seen = []
        h._warn_overflow = seen.append
        jc = h._job_constants(HEADER, DIFF1)
        assert jc.word7

        class Shards:
            def result(self):
                buf = np.full(4, MASK32, dtype=np.uint32)
                return [buf, np.uint32(3), buf[0], buf, np.uint32(5), buf[0]]

        found = type("Found", (), {"add": lambda *a: None})()
        h._collect(Shards(), jc, 0, 2 * BPD, found)
        assert seen == [5]
