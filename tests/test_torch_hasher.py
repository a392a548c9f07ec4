"""The ``Hasher`` seam of the PyTorch package on ``device="cpu"`` (the
kernels' plain versions) against the reference's Pallas hasher in
interpret mode and the hashlib oracle: same ``ScanResult``."""

import numpy as np
import pytest
import torch

from bitcoin_miner_tpu.backends.tpu import PallasTpuHasher
from bitcoin_miner_tpu.core.header import GENESIS_HEADER_HEX, GENESIS_NONCE
from bitcoin_miner_tpu.core.target import difficulty_to_target, nbits_to_target
from bitcoin_miner_tpu_torch.backends import cuda as port_cuda
from bitcoin_miner_tpu_torch.backends.base import (
    STREAM_FLUSH,
    ScanRequest,
    get_hasher,
)
from bitcoin_miner_tpu_torch.backends.cuda import CudaHasher, TileCudaHasher
from bitcoin_miner_tpu_torch.core.sha256 import sha256d
from bitcoin_miner_tpu_torch.ops.sha256_tile import VARIANTS


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
EASY = difficulty_to_target(1 / (1 << 26))
EVERYTHING = (1 << 256) - 1
BATCH = 1 << 11


@pytest.fixture(scope="module")
def reference():
    return PallasTpuHasher(batch_size=BATCH, sublanes=8, interpret=True,
                           unroll=8)


@pytest.fixture(scope="module")
def oracle():
    return get_hasher("cpu")


@pytest.fixture(scope="module", params=["cuda-tile", "cuda"])
def port(request):
    if request.param == "cuda-tile":
        return TileCudaHasher(batch_size=BATCH, device="cpu")
    return CudaHasher(batch_size=BATCH, inner_size=1 << 9, max_hits=64,
                      device="cpu")


def _fields(result):
    return (result.nonces, result.total_hits, result.hashes_done)


def _header(seed):
    return np.random.default_rng(seed).integers(0, 256, 76, dtype=np.uint8).tobytes()


class TestScanParity:
    def test_genesis_word7(self, port, reference):
        got = port.scan(GENESIS76, GENESIS_NONCE - 1500, 3000, DIFF1)
        want = reference.scan(GENESIS76, GENESIS_NONCE - 1500, 3000, DIFF1)
        assert _fields(got) == _fields(want)
        assert got.nonces == [GENESIS_NONCE] and got.hashes_done == 3000

    @pytest.mark.parametrize("seed", [21, 22])
    def test_easy_target_matches_reference_and_oracle(self, port, reference,
                                                      oracle, seed):
        """Multi-hit steps: the tile path re-enumerates them."""
        header76 = _header(seed)
        start = int(np.random.default_rng(seed).integers(0, 1 << 31))
        got = port.scan(header76, start, 5000, EASY)
        assert _fields(got) == _fields(reference.scan(header76, start, 5000,
                                                      EASY))
        want = oracle.scan(header76, start, 5000, EASY)
        assert (got.nonces, got.total_hits) == (want.nonces, want.total_hits)

    def test_partial_dispatch_limit_mask(self, port, oracle):
        header76 = bytes(76)
        got = port.scan(header76, 100, 7, EVERYTHING)
        assert got.nonces == list(range(100, 107)) and got.total_hits == 7
        got = port.scan(header76, 0, 2500, EASY)
        want = oracle.scan(header76, 0, 2500, EASY)
        assert (got.nonces, got.total_hits) == (want.nonces, want.total_hits)

    def test_multi_dispatch_uncapped_count(self, port):
        count = BATCH * 2 + 123
        got = port.scan(bytes(76), 0, count, EVERYTHING)
        assert got.total_hits == count and got.hashes_done == count
        assert got.nonces == list(range(64))

    def test_nonce_space_upper_edge(self, port, reference, oracle):
        header76 = _header(23)
        start = (1 << 32) - 3000
        target = difficulty_to_target(1 / (1 << 21))
        got = port.scan(header76, start, 3000, target)
        assert _fields(got) == _fields(reference.scan(header76, start, 3000,
                                                      target))
        assert got.nonces == oracle.scan(header76, start, 3000, target).nonces

    def test_range_checks(self, port):
        with pytest.raises(ValueError):
            port.scan(bytes(76), (1 << 32) - 10, 11, EASY)
        with pytest.raises(ValueError):
            port.scan(bytes(75), 0, 10, EASY)

    def test_cold_path_sha256d(self, port):
        for data in (b"", b"abc", bytes.fromhex(GENESIS_HEADER_HEX), bytes(200)):
            assert port.sha256d(data) == sha256d(data)


class TestScanStream:
    def test_stream_matches_scan_in_order_with_flush(self, port):
        header_a, header_b = _header(31), _header(32)
        reqs = [
            ScanRequest(header_a, 0, 3000, EASY, tag="a0"),
            ScanRequest(header_b, 5000, 1000, EASY, tag="b"),
            STREAM_FLUSH,
            ScanRequest(header_a, 3000, 0, EASY, tag="empty"),
            ScanRequest(GENESIS76, GENESIS_NONCE - 100, 200, DIFF1, tag="g"),
            ScanRequest(header_a, 3000, 2048, EASY, max_hits=4, tag="a1"),
        ]
        out = list(port.scan_stream(iter(reqs)))
        real = [r for r in reqs if r is not STREAM_FLUSH]
        assert [o.request.tag for o in out] == [r.tag for r in real]
        for o, r in zip(out, real):
            assert o.result == port.scan(r.header76, r.nonce_start, r.count,
                                         r.target, r.max_hits)
        assert out[3].result.nonces == [GENESIS_NONCE]
        assert len(out[4].result.nonces) == 4 and out[4].result.truncated

    def test_flush_yields_everything_in_flight(self, port):
        """A flush must complete what the ring holds before the stream
        pulls the next request."""
        seen = []

        def requests():
            yield ScanRequest(bytes(76), 0, 100, EVERYTHING, tag=1)
            yield ScanRequest(bytes(76), 100, 100, EVERYTHING, tag=2)
            yield STREAM_FLUSH
            seen.append(len(results))
            yield ScanRequest(bytes(76), 200, 100, EVERYTHING, tag=3)

        results = []
        for res in port.scan_stream(requests()):
            results.append(res.request.tag)
        assert results == [1, 2, 3] and seen == [2]


class TestConstruction:
    def test_later_slice_options_raise(self):
        """Every layout variant and every chain-pass size in 0..k now
        constructs (test_torch_variants* hold them against the reference);
        bad values raise the reference hasher's ValueErrors."""
        for variant in VARIANTS:
            for cgroup in range(5):
                assert TileCudaHasher(batch_size=BATCH, vshare=4,
                                      variant=variant, cgroup=cgroup,
                                      device="cpu").version_roll_bits == 2
        for bad in (dict(variant="nope"), dict(vshare=2, cgroup=3),
                    dict(vshare=2, cgroup=-1)):
            with pytest.raises(ValueError) as ref:
                PallasTpuHasher(batch_size=BATCH, interpret=True, unroll=8,
                                **bad)
            with pytest.raises(ValueError) as port:
                TileCudaHasher(batch_size=BATCH, device="cpu", **bad)
            assert str(port.value) == str(ref.value)
        with pytest.raises(ValueError, match="at most 8"):
            CudaHasher(batch_size=BATCH, inner_size=BATCH, vshare=9,
                       device="cpu")

    def test_geometry_checks(self):
        with pytest.raises(ValueError, match="multiple of 2048"):
            TileCudaHasher(batch_size=3 << 10, sublanes=16, device="cpu")
        with pytest.raises(ValueError):
            CudaHasher(batch_size=BATCH, inner_size=3 << 8, device="cpu")
        assert TileCudaHasher(batch_size=BATCH, device="cpu").tile == BATCH

    def test_no_card_fails_loudly(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TileCudaHasher()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_hasher("cuda")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_hasher("cuda-fleet")

    def test_version_mask_keeps_every_bit_for_the_host(self, port):
        assert port.set_version_mask(0x1FFFE000) == 0
        assert port.version_roll_bits == 0

    def test_job_constants_lru(self):
        h = TileCudaHasher(batch_size=BATCH, device="cpu")
        for i in range(port_cuda.CudaHasher._CONSTS_CAPACITY + 3):
            h._job_constants(_header(i), EASY)
        assert len(h._consts_cache) == port_cuda.CudaHasher._CONSTS_CAPACITY
        first = h._job_constants(_header(40), DIFF1)
        assert h._job_constants(_header(40), DIFF1) is first
        assert first.word7 and not h._job_constants(_header(40), EASY).word7


class TestInnerBits:
    """``--inner-bits``: the hit-buffer kernel's step, as the reference's
    command line sets its XLA backends' (``inner = 1 << min(batch bits,
    inner bits)``)."""

    @staticmethod
    def _args(*argv):
        from bitcoin_miner_tpu_torch import cli

        return cli, cli.build_parser().parse_args(
            ["--bench", "--device", "cpu", "--batch-bits", "12", *argv])

    @pytest.mark.parametrize("bits", [9, 11])
    def test_scan_result_matches_the_reference_at_the_same_inner_size(
            self, bits):
        from bitcoin_miner_tpu.backends.tpu import TpuHasher

        cli, args = self._args("--backend", "cuda", "--inner-bits", str(bits))
        port = cli.make_hasher(args)
        assert isinstance(port, CudaHasher) and port.inner_size == 1 << bits
        ref = TpuHasher(batch_size=1 << 12, inner_size=1 << bits, unroll=8)
        # ~2^-6 per nonce (capped: which hits are kept), then ~2^-10.
        for target, capped in ((EASY, True),
                               (difficulty_to_target(1 / (1 << 22)), False)):
            got = port.scan(GENESIS76, 777, 3 * 4096 - 100, target)
            want = ref.scan(GENESIS76, 777, 3 * 4096 - 100, target)
            assert _fields(got) == _fields(want)
            assert want.truncated is capped and want.nonces

    def test_default_and_cap(self):
        cli, args = self._args("--backend", "cuda")
        assert cli.make_hasher(args).inner_size == 1 << 12  # capped
        cli, args = self._args("--backend", "cuda", "--batch-bits", "20")
        assert cli.make_hasher(args).inner_size == 1 << cli.DEFAULT_INNER_BITS
        cli, args = self._args("--backend", "cuda-mesh", "--inner-bits", "10")
        assert cli.make_hasher(args).inner_size == 1 << 10

    @pytest.mark.parametrize("argv", [
        ["--inner-bits", "10"],  # the default cuda-tile
        ["--backend", "cuda-tile-mesh", "--inner-bits", "10"],
        ["--backend", "cuda-fanout", "--fanout-kernel", "cuda-tile",
         "--inner-bits", "10"],
        ["--backend", "cpu", "--inner-bits", "10"],
    ])
    def test_refused_where_the_hit_buffer_kernel_does_not_run(self, argv):
        cli, args = self._args(*argv)
        with pytest.raises(SystemExit, match="--inner-bits 10 applies only "
                                             "to the hit-buffer kernel"):
            cli.make_hasher(args)

    def test_negative_refused(self):
        cli, args = self._args("--backend", "cuda", "--inner-bits", "-1")
        with pytest.raises(SystemExit, match=">= 0"):
            cli.make_hasher(args)
