"""The per-device fan-out of the PyTorch package (``parallel/fanout.py``):
the contracts of the JAX package's ``FanoutHasher``, checked as its own
tests check them, and the port's ``make_cuda_fanout`` against the JAX
``make_tpu_fanout`` on the conftest's virtual CPU devices, ``ScanResult``
for ``ScanResult``. Children are the hashlib oracle, or CUDA hashers on the
CPU (their kernels' plain versions)."""

import threading

import numpy as np
import pytest
import torch

from bitcoin_miner_tpu.parallel.fanout import FanoutHasher as JaxFanout
from bitcoin_miner_tpu.parallel.fanout import make_tpu_fanout
from bitcoin_miner_tpu_torch.backends.base import (
    STREAM_FLUSH,
    ScanRequest,
    dispatch_granularity,
    get_hasher,
    iter_scan_stream,
)
from bitcoin_miner_tpu_torch.backends.cuda import CudaHasher, TileCudaHasher
from bitcoin_miner_tpu_torch.core.header import GENESIS_HEADER_HEX, GENESIS_NONCE
from bitcoin_miner_tpu_torch.core.target import difficulty_to_target, nbits_to_target
from bitcoin_miner_tpu_torch.miner.scheduler import (
    AdaptiveBatchScheduler,
    stream_sweep,
)
from bitcoin_miner_tpu_torch.parallel.fanout import (
    FanoutHasher,
    MultiChildError,
    make_cuda_fanout,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


HEADER = bytes.fromhex(GENESIS_HEADER_HEX)[:76]
#: frequent-hit target so small windows exercise the merge paths
EASY = difficulty_to_target(1 / (1 << 24))
DIFF1 = nbits_to_target(0x1D00FFFF)


def make_fanout(n: int = 3) -> FanoutHasher:
    return FanoutHasher([get_hasher("cpu") for _ in range(n)])


def _same(got, want):
    assert got.nonces == want.nonces
    assert got.total_hits == want.total_hits
    assert got.hashes_done == want.hashes_done
    assert sorted(got.version_hits) == sorted(want.version_hits)


class TestScan:
    def test_scan_parity_with_single_cpu(self):
        want = get_hasher("cpu").scan(HEADER, 1000, 2048, EASY)
        got = make_fanout(3).scan(HEADER, 1000, 2048, EASY)
        assert got.nonces == sorted(want.nonces)
        assert got.total_hits == want.total_hits
        assert got.hashes_done == want.hashes_done == 2048

    def test_genesis_found_across_slices(self):
        got = make_fanout(3).scan(HEADER, GENESIS_NONCE - 100, 300, DIFF1)
        assert GENESIS_NONCE in got.nonces

    def test_more_children_than_nonces(self):
        want = get_hasher("cpu").scan(HEADER, 0, 2, EASY)
        got = make_fanout(5).scan(HEADER, 0, 2, EASY)
        assert got.nonces == sorted(want.nonces)
        assert got.hashes_done == 2

    def test_needs_children(self):
        with pytest.raises(ValueError):
            FanoutHasher([])

    def test_every_failed_child_is_reported(self):
        class Broken:
            def __init__(self, label):
                self.chip_label = label

            def scan(self, *a, **k):
                raise RuntimeError(f"chip {self.chip_label} wedged")

        fan = FanoutHasher([Broken("a"), get_hasher("cpu"), Broken("c")])
        with pytest.raises(MultiChildError) as err:
            fan.scan(HEADER, 0, 300, EASY)
        assert sorted(label for label, _ in err.value.errors) == ["a", "c"]
        with pytest.raises(RuntimeError, match="chip a wedged"):
            FanoutHasher([Broken("a"), get_hasher("cpu")]).scan(
                HEADER, 0, 300, EASY)


class TestScanStream:
    RANGES = [
        (1000, 1024),
        (0, 512),
        (6000, 0),          # empty range mid-stream
        (1 << 20, 1024),
        (2000, 256),
        (1 << 21, 512),     # > n_children requests: round-robin wraps
    ]

    def _requests(self):
        return [ScanRequest(header76=HEADER, nonce_start=s, count=c,
                            target=EASY, tag=i)
                for i, (s, c) in enumerate(self.RANGES)]

    def test_order_and_parity(self):
        oracle = get_hasher("cpu")
        got = list(make_fanout(3).scan_stream(iter(self._requests())))
        assert [g.request.tag for g in got] == list(range(len(self.RANGES)))
        for sres, (s, c) in zip(got, self.RANGES):
            want = oracle.scan(HEADER, s, c, EASY)
            assert sres.result.nonces == want.nonces
            assert sres.result.hashes_done == want.hashes_done

    def test_flush_is_transparent(self):
        reqs = self._requests()
        fed = [reqs[0], STREAM_FLUSH, *reqs[1:3], STREAM_FLUSH, *reqs[3:]]
        got = list(make_fanout(2).scan_stream(iter(fed)))
        assert [g.request.tag for g in got] == list(range(len(self.RANGES)))

    def test_stream_sweep_through_fanout(self):
        window = 1 << 11
        want = get_hasher("cpu").scan(HEADER, 0, window, EASY)
        sched = AdaptiveBatchScheduler(min_bits=4, max_bits=8)
        report = stream_sweep(make_fanout(3), HEADER, 0, window, EASY,
                              scheduler=sched)
        assert report.nonces == sorted(want.nonces)
        assert report.hashes_done == window
        assert report.dispatches > 3

    def test_child_error_surfaces_in_request_order(self):
        class Broken:
            def scan(self, *a, **k):
                raise RuntimeError("chip wedged")

        fan = FanoutHasher([get_hasher("cpu"), Broken()])
        it = iter_scan_stream(fan, iter(self._requests()[:2]))
        assert next(it).request.tag == 0
        with pytest.raises(RuntimeError, match="chip wedged"):
            list(it)

    def test_abandoned_stream_stops_its_pumps(self):
        fan = make_fanout(2)
        before = {t.name for t in threading.enumerate()}

        def reqs():
            for i in range(6):
                yield ScanRequest(header76=HEADER, nonce_start=i * 128,
                                  count=128, target=EASY)

        stream = fan.scan_stream(reqs())
        next(stream)
        stream.close()
        for t in threading.enumerate():
            if t.name.startswith("fanout-pump") and t.name not in before:
                t.join(timeout=30)
                assert not t.is_alive()


class TestPlumbing:
    def test_stream_depth_from_children(self):
        assert make_fanout(3).stream_depth == 2  # ringless children

        class Ring:
            stream_depth = 2

            def scan(self, *a, **k):
                raise NotImplementedError

        assert FanoutHasher([Ring(), Ring(), Ring()]).stream_depth == 8
        assert JaxFanout([Ring(), Ring(), Ring()]).stream_depth == 8

    def test_dispatch_size_from_children(self):
        """One child's dispatch: requests go whole to one device, so the
        mesh's n_devices multiplier does not apply."""

        class Chip:
            batch_size = 1 << 16

            def scan(self, *a, **k):
                raise NotImplementedError

        fan = FanoutHasher([Chip(), Chip()])
        assert fan.dispatch_size == 1 << 16 == JaxFanout(
            [Chip(), Chip()]).dispatch_size
        assert dispatch_granularity(fan) == 1 << 16
        assert not hasattr(make_fanout(2), "dispatch_size")  # sizeless

    def test_version_mask_forwarded_to_every_child(self):
        calls = []

        class Child:
            def scan(self, *a, **k):
                raise NotImplementedError

            def set_version_mask(self, mask):
                calls.append(mask)
                return 4

        fan = FanoutHasher([Child(), Child(), Child()])
        assert fan.set_version_mask(0x1FFFE000) == 4
        assert calls == [0x1FFFE000] * 3

    def test_chip_labels_prefer_child_identity(self):
        children = [get_hasher("cpu") for _ in range(2)]
        children[0].chip_label = "7"
        assert FanoutHasher(children).chip_labels == ["7", "1"]

    def test_contexts_wrap_every_child_call(self):
        entered = []

        class Ctx:
            def __init__(self, i):
                self.i = i

            def __enter__(self):
                entered.append(self.i)

            def __exit__(self, *exc):
                return False

        fan = FanoutHasher([get_hasher("cpu") for _ in range(2)],
                           contexts=[lambda: Ctx(0), lambda: Ctx(1)])
        fan.scan(HEADER, 0, 64, EASY)
        assert sorted(entered) == [0, 1]
        with pytest.raises(ValueError, match="1:1"):
            FanoutHasher([get_hasher("cpu")], contexts=[None, None])


class TestCudaFanout:
    """``make_cuda_fanout`` on the CPU: one CUDA hasher per listed device,
    against the JAX package's ``make_tpu_fanout`` on its virtual devices."""

    BPD = 1 << 10

    def test_children_and_labels(self):
        fan = make_cuda_fanout(batch_per_device=self.BPD, inner_size=1 << 8,
                               devices=["cpu"] * 3)
        assert fan.name == "cuda-fanout"
        assert [type(c) for c in fan.children] == [CudaHasher] * 3
        assert fan.chip_labels == ["0", "1", "2"]
        assert fan.dispatch_size == self.BPD == dispatch_granularity(fan)
        assert fan.stream_depth == 3 * (2 + 1) - 1
        fan = make_cuda_fanout(batch_per_device=self.BPD, devices=["cpu"] * 2,
                               labels=["5", "6"], kernel="cuda-tile")
        assert fan.chip_labels == ["5", "6"]

    def test_matches_tpu_fanout(self):
        ref = make_tpu_fanout(n_devices=2, batch_per_device=self.BPD,
                              inner_size=1 << 8, unroll=8)
        port = make_cuda_fanout(batch_per_device=self.BPD, inner_size=1 << 8,
                                devices=["cpu"] * 2)
        _same(port.scan(HEADER, 77, 3000, EASY),
              ref.scan(HEADER, 77, 3000, EASY))
        reqs = [ScanRequest(header76=HEADER, nonce_start=s, count=c,
                            target=EASY, tag=i)
                for i, (s, c) in enumerate([(0, 1024), (5000, 700),
                                            (9000, 1024)])]
        got = list(port.scan_stream(iter(reqs)))
        want = list(ref.scan_stream(iter(reqs)))
        assert [g.request.tag for g in got] == [0, 1, 2]
        for g, w in zip(got, want):
            _same(g.result, w.result)

    def test_tile_children_carry_knobs_and_stay_exact(self):
        fan = make_cuda_fanout(batch_per_device=1 << 11, kernel="cuda-tile",
                               sublanes=8, inner_tiles=2, vshare=2,
                               variant="wstage", cgroup=2, unroll=16,
                               spec=False, devices=["cpu"] * 2)
        for child in fan.children:
            assert isinstance(child, TileCudaHasher)
            assert (child.variant, child.cgroup, child._vshare) == (
                "wstage", 2, 2)
            assert (child.unroll, child.spec) == (16, False)
        got = fan.scan(HEADER, 0, 2_000, EASY)
        want = get_hasher("cpu").scan(HEADER, 0, 2_000, EASY)
        assert got.nonces == want.nonces
        assert got.total_hits == want.total_hits
        assert got.hashes_done == 4_000
        assert fan.set_version_mask(0x1FFFE000) == 1
        assert fan.version_roll_bits == 1

    def test_genesis_through_the_cli(self, capsys):
        from bitcoin_miner_tpu_torch import cli

        args = cli.build_parser().parse_args(
            ["--bench", "--backend", "cuda-fanout", "--device", "cpu",
             "--batch-bits", "12", "--bench-nonces", "8192"])
        out = cli.bench(args)
        assert out["verified"] and out["hashes"] == 8192

    def test_unknown_kernel_rejected(self):
        with pytest.raises(ValueError, match="kernel"):
            make_cuda_fanout(kernel="xla", devices=["cpu"])
        with pytest.raises(ValueError, match="1:1"):
            make_cuda_fanout(devices=["cpu"], labels=["a", "b"])

    def test_results_of_the_children_merge_in_order(self):
        rng = np.random.default_rng(3)
        port = make_cuda_fanout(batch_per_device=self.BPD, inner_size=1 << 8,
                                devices=["cpu"] * 3)
        oracle = get_hasher("cpu")
        starts = sorted(int(x) for x in rng.integers(0, 1 << 31, 5))
        reqs = [ScanRequest(header76=HEADER, nonce_start=s, count=600,
                            target=EASY, tag=s) for s in starts]
        got = list(port.scan_stream(iter(reqs)))
        assert [g.request.tag for g in got] == starts
        for g in got:
            _same(g.result, oracle.scan(HEADER, g.request.tag, 600, EASY))
