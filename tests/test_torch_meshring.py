"""Mesh-native sharded dispatch of the PyTorch package
(``parallel/meshring.py``, ``cuda-mesh-native``) on the CPU, against the
JAX package's ``MeshTpuHasher`` on the conftest's virtual devices and the
hashlib oracle: the parity matrix at 1, 2 and 4 shards × the hit-buffer
and tile kernels × 1 and 2 chains with one kernel library per geometry;
the degradation ladder (quarantine → per-device fan-out → rebuild →
restore) with parity at every rung; concurrent streams on one hasher; the
constants cache keyed on the topology. Shards are positions in a device
list that names the CPU several times."""

import threading

import pytest
import torch

from bitcoin_miner_tpu.parallel.meshring import MeshTpuHasher
from bitcoin_miner_tpu_torch import cli
from bitcoin_miner_tpu_torch.backends.base import (
    ScanRequest,
    dispatch_granularity,
    get_hasher,
)
from bitcoin_miner_tpu_torch.backends.cuda import (
    ShardedCudaHasher,
    ShardedTileCudaHasher,
)
from bitcoin_miner_tpu_torch.core.header import (
    GENESIS_HEADER_HEX,
    GENESIS_NBITS,
    GENESIS_NONCE,
)
from bitcoin_miner_tpu_torch.core.target import (
    difficulty_to_target,
    nbits_to_target,
)
from bitcoin_miner_tpu_torch.parallel.fanout import FanoutHasher
from bitcoin_miner_tpu_torch.parallel.meshring import MeshCudaHasher


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


HEADER = bytes.fromhex(GENESIS_HEADER_HEX)[:76]
#: ~1 hit per 256 nonces, so small windows carry hits through every merge.
EASY = difficulty_to_target(1 / (1 << 24))
BPD = 1 << 10
INNER = 1 << 8
COUNT = 1 << 12
SIBLING = int.from_bytes(HEADER[:4], "little") ^ (1 << 13)


def _mesh(n=4, **kw):
    kw.setdefault("batch_per_device", BPD)
    kw.setdefault("inner_size", INNER)
    kw.setdefault("sublanes", 8)
    kw.setdefault("inner_tiles", 1)
    return MeshCudaHasher(devices=["cpu"] * n, **kw)


@pytest.fixture(scope="module")
def oracle():
    """The hashlib oracle's scan of [0, COUNT) of the header and of its
    first sibling (the version with bit 13 flipped)."""
    cpu = get_hasher("cpu")
    sibling76 = SIBLING.to_bytes(4, "little") + HEADER[4:]
    return cpu.scan(HEADER, 0, COUNT, EASY), cpu.scan(sibling76, 0, COUNT,
                                                      EASY)


class TestParityMatrix:
    @pytest.mark.parametrize("n", [1, 2, 4])
    @pytest.mark.parametrize("kernel", ["cuda", "cuda-tile"])
    @pytest.mark.parametrize("vshare", [1, 2])
    def test_bit_exact_one_library(self, oracle, n, kernel, vshare):
        h = _mesh(n, kernel=kernel, vshare=vshare)
        try:
            assert isinstance(h, MeshCudaHasher)
            assert isinstance(h, ShardedTileCudaHasher if kernel == "cuda-tile"
                              else ShardedCudaHasher)
            assert h.topology == f"1x{n}"
            assert h.dispatch_size == n * BPD == dispatch_granularity(h)
            got = h.scan(HEADER, 0, COUNT, EASY)
            want, sibling = oracle
            assert got.nonces == want.nonces
            assert got.total_hits == want.total_hits
            assert got.hashes_done == vshare * COUNT
            if vshare == 2:
                assert sorted(got.version_hits) == [
                    (SIBLING, x) for x in sibling.nonces]
            # One kernel library per geometry, over COUNT / (n·BPD)
            # dispatches.
            assert h.compile_count == 1
        finally:
            h.close()

    @pytest.mark.parametrize("kernel, ref_kernel, vshare",
                             [("cuda", "xla", 2), ("cuda-tile", "pallas", 1)])
    def test_matches_mesh_tpu_hasher(self, kernel, ref_kernel, vshare):
        ref = MeshTpuHasher(n_devices=4, batch_per_device=BPD,
                            inner_size=INNER, kernel=ref_kernel,
                            vshare=vshare, unroll=8, inner_tiles=1)
        h = _mesh(4, kernel=kernel, vshare=vshare)
        try:
            assert (h.topology, h.dispatch_size) == (ref.topology,
                                                     ref.dispatch_size)
            count = 2 * h.dispatch_size + 1_234  # a partial last dispatch
            got = h.scan(HEADER, 50, count, EASY)
            want = ref.scan(HEADER, 50, count, EASY)
            assert (got.nonces, got.total_hits, got.hashes_done) == (
                want.nonces, want.total_hits, want.hashes_done)
            assert sorted(got.version_hits) == sorted(want.version_hits)
        finally:
            h.close()
            ref.close()

    def test_kernel_chosen_positionally_too(self):
        h = MeshCudaHasher(None, BPD, INNER, 64, 64, True, 1, "cuda-tile",
                           8, 1, devices=["cpu"] * 2)
        assert isinstance(h, ShardedTileCudaHasher)
        with pytest.raises(ValueError, match="mesh kernel"):
            _mesh(2, kernel="pallas")


def _requests(count, n_req, base=0):
    return [ScanRequest(header76=HEADER, nonce_start=base + i * count,
                        count=count, target=EASY, tag=i)
            for i in range(n_req)]


class TestRingDispatch:
    def test_stream_fifo_and_parity(self, oracle):
        h = _mesh(4, kernel="cuda-tile")
        try:
            count = COUNT // 4  # a quarter of a dispatch
            assert 4 * count == h.dispatch_size
            out = list(h.scan_stream(iter(_requests(count, 4))))
            assert [r.request.tag for r in out] == [0, 1, 2, 3]
            want = oracle[0].nonces
            assert sorted(n for r in out for n in r.result.nonces) == want
            assert h.compile_count == 1
        finally:
            h.close()

    def test_concurrent_streams(self, oracle):
        """Two pump threads share one hasher, as two dispatcher workers
        do: there is no collective to order across devices, so both
        streams finish, in order, bit-exact, without a launch lock."""
        h = _mesh(4)
        try:
            count = COUNT // 4
            out: dict = {}

            def stream(wid):
                reqs = _requests(count // 2, 4, base=wid * count * 2)
                out[wid] = list(h.scan_stream(iter(reqs)))

            threads = [threading.Thread(target=stream, args=(w,), daemon=True)
                       for w in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=180)
            assert not any(t.is_alive() for t in threads)
            got = []
            for wid in range(2):
                assert [r.request.tag for r in out[wid]] == [0, 1, 2, 3]
                got += [n for r in out[wid] for n in r.result.nonces]
            assert sorted(got) == oracle[0].nonces
        finally:
            h.close()

    def test_rebuild_between_launch_and_collection(self):
        """A dispatch launched on the 1x4 mesh and collected after a
        rebuild shrank it to 1x3 rescans its word7 candidate on the mesh
        it was launched on: the genesis solve, in the last shard."""
        h = _mesh(4, kernel="cuda-tile")
        try:
            target = nbits_to_target(GENESIS_NBITS)  # word7 mode
            start = GENESIS_NONCE - 3 * BPD - 5
            rebuilt = []

            def requests():
                yield ScanRequest(HEADER, start, h.dispatch_size, target,
                                  tag=0)
                # Dispatch 0 is in flight (the ring holds 2): shrink the
                # mesh under it.
                h.quarantine_device("1")
                h.rebuild()
                rebuilt.append(h.topology)
                yield ScanRequest(HEADER, start + 4 * BPD, 3 * BPD, target,
                                  tag=1)

            out = list(h.scan_stream(requests()))
            assert rebuilt == ["1x3"]
            assert [r.request.tag for r in out] == [0, 1]
            assert out[0].result.nonces == [GENESIS_NONCE]
            assert out[0].result.total_hits == 1
            assert out[1].result.nonces == []
            assert out[1].result.hashes_done == 3 * BPD
        finally:
            h.close()

    def test_consts_cache_keyed_on_topology(self):
        h = _mesh(4)
        try:
            key_full = h._consts_key(HEADER, EASY, 0)
            label = h.shard_labels[0]
            h.quarantine_device(label)
            assert h._consts_key(HEADER, EASY, 0) != key_full
            h.rebuild()
            key_3 = h._consts_key(HEADER, EASY, 0)
            assert key_3 != key_full and key_3[-1] == "1x3"
            h.restore_device(label)
            assert h._consts_key(HEADER, EASY, 0) == key_full
        finally:
            h.close()


class TestDegradationWalk:
    @pytest.mark.parametrize("kernel", ["cuda", "cuda-tile"])
    def test_quarantine_fanout_rebuild_restore(self, oracle, kernel):
        h = _mesh(4, kernel=kernel)
        try:
            assert h.topology == "1x4" and not h.degraded
            want = oracle[0]

            def check():
                got = h.scan(HEADER, 0, COUNT, EASY)
                assert got.nonces == want.nonces
                assert got.total_hits == want.total_hits

            check()
            label = h.shard_labels[1]
            h.quarantine_device(label)
            assert h.degraded and h.topology == "fanout-3"
            assert h.shard_labels == ["0", "2", "3"]
            assert isinstance(h._delegate, FanoutHasher)
            assert h.dispatch_size == BPD  # one survivor's dispatch
            assert h.stream_depth == 3 * (2 + 1) - 1
            check()
            out = list(h.scan_stream(iter(_requests(BPD, 3))))
            assert [r.request.tag for r in out] == [0, 1, 2]
            h.rebuild()
            assert not h.degraded and h.topology == "1x3"
            assert h.shard_labels == ["0", "2", "3"]
            assert h.dispatch_size == 3 * BPD
            assert h.stream_depth == type(h).stream_depth
            check()
            h.restore_device(label)
            assert h.topology == "1x4"
            assert h.shard_labels == ["0", "1", "2", "3"]
            check()
            # One library per geometry, whatever the topology.
            assert h.compile_count == 1
        finally:
            h.close()

    def test_version_mask_survives_the_ladder(self):
        h = _mesh(2, kernel="cuda-tile", vshare=2)
        try:
            assert h.set_version_mask(0) == 0  # degraded to chain 0
            h.quarantine_device("0")
            assert h.set_version_mask(0x1FFFE000) == 1
            assert h.version_roll_bits == 1
            h.rebuild()
            assert h.version_roll_bits == 1
            got = h.scan(HEADER, 0, 1024, EASY)
            assert got.hashes_done == 2048
        finally:
            h.close()

    def test_quarantine_unknown_label_rejected(self):
        h = _mesh(2)
        with pytest.raises(ValueError):
            h.quarantine_device("no-such-chip")

    def test_quarantine_all_devices_rejected(self):
        h = _mesh(2)
        h.quarantine_device(h.shard_labels[0])
        with pytest.raises(RuntimeError):
            h.quarantine_device(h.shard_labels[0])
        assert h.degraded and h.topology == "fanout-1"


class TestCli:
    def test_bench_through_mesh_native(self, capsys):
        rc = cli.main(["--bench", "--backend", "cuda-mesh-native",
                       "--mesh-kernel", "cuda-tile", "--device", "cpu",
                       "--batch-bits", "13", "--bench-nonces", "16384"])
        assert rc == 0
        assert "FOUND+VERIFIED" in capsys.readouterr().out

    @pytest.mark.parametrize("argv, match", [
        (("--backend", "cuda-tile-mesh", "--mesh-kernel", "cuda"),
         "--mesh-kernel cuda applies only to --backend cuda-mesh-native"),
        (("--backend", "cuda-mesh-native", "--fanout-kernel", "cuda"),
         "--fanout-kernel"),
        (("--backend", "cuda", "--mesh-devices", "2"), "--mesh-devices"),
        (("--backend", "cuda-mesh-native", "--variant", "vroll"),
         "--variant vroll applies only to the tile kernel"),
        (("--backend", "cuda-fanout", "--fanout-kernel", "cuda",
          "--vshare", "2", "--no-spec"), "spec kernel"),
        (("--backend", "cuda-tile-mesh", "--mesh-devices", "2"),
         "--device cpu runs one device"),
    ])
    def test_refusals(self, argv, match):
        args = cli.build_parser().parse_args(
            ["--bench", "--device", "cpu", "--batch-bits", "11", *argv])
        with pytest.raises(SystemExit, match=match):
            cli.make_hasher(args)

    @pytest.mark.parametrize("argv, kind", [
        (("--backend", "cuda-mesh-native", "--mesh-kernel", "cuda-tile",
          "--variant", "vroll", "--vshare", "2"), ShardedTileCudaHasher),
        (("--backend", "cuda-fanout", "--fanout-kernel", "cuda-tile",
          "--variant", "regchain", "--unroll", "8"), FanoutHasher),
        (("--backend", "cuda-mesh", "--vshare", "2"), ShardedCudaHasher),
        (("--backend", "cuda-tile-mesh", "--no-spec"), ShardedTileCudaHasher),
    ])
    def test_options_reach_the_hasher(self, argv, kind):
        args = cli.build_parser().parse_args(
            ["--bench", "--device", "cpu", "--batch-bits", "11", *argv])
        h = cli.make_hasher(args)
        assert isinstance(h, kind)
        assert dispatch_granularity(h) == 1 << 11
        child = h.children[0] if isinstance(h, FanoutHasher) else h
        assert child.unroll == (8 if "--unroll" in argv else 64)
        assert child.spec == ("--no-spec" not in argv)
        if "--variant" in argv:
            assert child.variant == argv[argv.index("--variant") + 1]
