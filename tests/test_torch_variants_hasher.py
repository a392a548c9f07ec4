"""The tile hasher's layouts and step geometry in the PyTorch package
against the JAX reference on the CPU: ``TileCudaHasher``'s geometry clamp,
warnings and validation errors against ``PallasTpuHasher``'s; the
``ScanResult`` of both hashers in three layouts at vshare=2; the command
line's layout options. Every output is an integer, so every comparison is
exact. The reference hashers are built once per layout and shared by the
file's tests. (``test_torch_variants.py`` holds the kernel's outputs.)"""

import logging

import numpy as np
import pytest
import torch

from bitcoin_miner_tpu.backends.tpu import PallasTpuHasher
from bitcoin_miner_tpu.core.header import GENESIS_HEADER_HEX, GENESIS_NONCE
from bitcoin_miner_tpu.core.target import difficulty_to_target, nbits_to_target
from bitcoin_miner_tpu_torch import cli
from bitcoin_miner_tpu_torch.backends import cuda as port_cuda
from bitcoin_miner_tpu_torch.backends.cuda import (
    DEFAULT_VERSION_MASK,
    TileCudaHasher,
)
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
EASY = difficulty_to_target(1 / (1 << 26))  # ~2^-6 per nonce


def _header(seed):
    return np.random.default_rng(seed).integers(0, 256, 76, dtype=np.uint8).tobytes()


# ----------------------------------------------------------------- geometry
# (batch, sublanes, inner_tiles, interleave, variant)
GEOMETRIES = [
    (1 << 14, 8, 8, 1, "baseline"),
    (1 << 12, 8, 8, 1, "baseline"),     # inner_tiles 8 -> 4
    (1 << 14, 8, 8, 3, "wstage"),       # interleave 3 -> 2
    (3 << 10, 1, 8, 2, "vroll"),
    (3 << 10, 3, 8, 2, "regchain"),
    (1 << 11, 8, 8, 2, "vroll-db"),     # interleave 2 -> 1
    (3 << 11, 2, 8, 3, "vroll-db"),     # interleave 3 -> 2
    (1 << 13, 2, 5, 1, "wsplit"),       # inner_tiles 5 -> 4
    (1 << 12, 1, 1, 1, "baseline"),     # a 128-nonce step
    (1 << 12, 1, 2, 2, "vroll-db"),     # interleave 2 -> 1
]
# ... and the ones both hashers refuse.
BAD_GEOMETRIES = [
    (1 << 10, 8, 8, 1, "vroll-db"),     # one tile: no two groups
    (3 << 10, 16, 8, 1, "baseline"),    # batch not a multiple of the tile
    (1 << 12, 8, 8, 1, "nope"),
]


def _geometry_pair(geometry, **kw):
    batch, sublanes, inner_tiles, interleave, variant = geometry
    ref = PallasTpuHasher(batch_size=batch, sublanes=sublanes,
                          inner_tiles=inner_tiles, interleave=interleave,
                          variant=variant, interpret=True, unroll=8, **kw)
    port = TileCudaHasher(batch_size=batch, sublanes=sublanes,
                          inner_tiles=inner_tiles, interleave=interleave,
                          variant=variant, device="cpu", **kw)
    return ref, port


class TestGeometry:
    @pytest.mark.parametrize("geometry", GEOMETRIES,
                             ids=lambda g: "-".join(map(str, g)))
    def test_clamps_as_the_pallas_hasher(self, geometry, caplog):
        with caplog.at_level(logging.WARNING):
            ref, port = _geometry_pair(geometry)
        assert (port.inner_tiles, port.interleave, port.tile) == (
            ref._inner_tiles, ref._interleave, ref.tile)
        assert port.tile == port.sublanes * 128 * port.inner_tiles
        warned = {r.name for r in caplog.records
                  if "clamped" in r.getMessage()}
        clamped = (port.inner_tiles, port.interleave) != geometry[2:4]
        assert warned == ({"bitcoin_miner_tpu.backends.tpu",
                           port_cuda.logger.name} if clamped else set())

    @pytest.mark.parametrize("geometry", BAD_GEOMETRIES,
                             ids=lambda g: "-".join(map(str, g)))
    def test_refuses_as_the_pallas_hasher(self, geometry):
        batch, sublanes, inner_tiles, interleave, variant = geometry
        with pytest.raises(ValueError) as ref:
            PallasTpuHasher(batch_size=batch, sublanes=sublanes,
                            inner_tiles=inner_tiles, interleave=interleave,
                            variant=variant, interpret=True, unroll=8)
        with pytest.raises(ValueError) as port:
            TileCudaHasher(batch_size=batch, sublanes=sublanes,
                           inner_tiles=inner_tiles, interleave=interleave,
                           variant=variant, device="cpu")
        assert str(port.value) == str(ref.value)

    def test_every_variant_and_chain_pass_constructs(self):
        for variant in VARIANTS:
            for cgroup in range(5):
                h = TileCudaHasher(batch_size=1 << 14, vshare=4,
                                   variant=variant, cgroup=cgroup,
                                   device="cpu")
                assert (h.variant, h.cgroup, h.tile) == (variant, cgroup, 8192)
        with pytest.raises(ValueError, match="cgroup must be between"):
            TileCudaHasher(batch_size=1 << 14, vshare=4, cgroup=5,
                           device="cpu")


# -------------------------------------------------------------- hasher seam
SEAM_BATCH = 1 << 11
# (variant, cgroup, interleave, sublanes): vshare = 2 each.
SEAM_LAYOUTS = [("vroll", 0, 1, 8), ("wsplit", 1, 1, 8), ("wstage", 0, 2, 1)]
_SEAM = {}


def _seam_pair(layout):
    if layout not in _SEAM:
        variant, cgroup, interleave, sublanes = layout
        kw = dict(batch_size=SEAM_BATCH, sublanes=sublanes, inner_tiles=8,
                  interleave=interleave, vshare=2, variant=variant,
                  cgroup=cgroup)
        _SEAM[layout] = (TileCudaHasher(device="cpu", **kw),
                         PallasTpuHasher(interpret=True, unroll=8, **kw))
    return _SEAM[layout]


def _seam_fields(result):
    return (result.nonces, result.total_hits, result.hashes_done,
            [tuple(v) for v in result.version_hits], result.version_total_hits)


class TestHasherSeam:
    @pytest.mark.parametrize("layout", SEAM_LAYOUTS,
                             ids=lambda l: "-".join(map(str, l)))
    def test_scan_result_matches_reference(self, layout):
        port, ref = _seam_pair(layout)
        assert (port.tile, port.interleave) == (ref.tile, ref._interleave)
        header76 = _header(74)
        got = port.scan(header76, 1000, 5000, EASY)
        want = ref.scan(header76, 1000, 5000, EASY)
        assert _seam_fields(got) == _seam_fields(want)
        assert got.version_hits and got.nonces and got.hashes_done == 10000
        version = int.from_bytes(header76[:4], "little")
        assert {v for v, _ in got.version_hits} == {version ^ (1 << 13)}

    def test_genesis_word7_and_degraded_mode(self):
        port, ref = _seam_pair(SEAM_LAYOUTS[0])
        got = port.scan(GENESIS76, GENESIS_NONCE - 1500, 3000, DIFF1)
        want = ref.scan(GENESIS76, GENESIS_NONCE - 1500, 3000, DIFF1)
        assert _seam_fields(got) == _seam_fields(want)
        assert got.nonces == [GENESIS_NONCE]
        try:
            assert port.set_version_mask(0) == ref.set_version_mask(0) == 0
            header76 = _header(75)
            got = port.scan(header76, 0, 3000, EASY)
            assert _seam_fields(got) == _seam_fields(
                ref.scan(header76, 0, 3000, EASY))
            assert got.version_hits == [] and got.hashes_done == 3000
        finally:
            port.set_version_mask(DEFAULT_VERSION_MASK)
            ref.set_version_mask(DEFAULT_VERSION_MASK)


# -------------------------------------------------------------- the CLI
class TestCommandLine:
    def test_bench_vroll_finds_genesis(self, capsys):
        rc = cli.main(["--bench", "--device", "cpu", "--variant", "vroll",
                       "--vshare", "2", "--batch-bits", "13",
                       "--bench-nonces", str(1 << 14)])
        assert rc == 0
        out = capsys.readouterr().out
        assert "FOUND+VERIFIED" in out and "variant vroll" in out
        assert f"over {1 << 15} hashes" in out

    def test_layout_options_reach_the_hasher(self):
        h = cli.make_hasher(cli.build_parser().parse_args(
            ["--bench", "--device", "cpu", "--vshare", "4", "--variant",
             "wsplit", "--cgroup", "2", "--interleave", "2", "--sublanes",
             "4", "--inner-tiles", "4", "--batch-bits", "16"]))
        assert isinstance(h, TileCudaHasher)
        assert (h.variant, h.cgroup, h.interleave, h.sublanes,
                h.inner_tiles, h.tile) == ("wsplit", 2, 2, 4, 4, 2048)

    @pytest.mark.parametrize("backend", ["cuda", "cpu"])
    @pytest.mark.parametrize("flag, value", [
        ("--variant", "vroll"), ("--variant", "baseline"),
        ("--interleave", "2"), ("--sublanes", "8"), ("--inner-tiles", "8"),
        ("--cgroup", "0")])
    def test_other_backends_refuse_layout_options(self, backend, flag, value):
        args = cli.build_parser().parse_args(
            ["--bench", "--device", "cpu", "--backend", backend, flag, value])
        with pytest.raises(SystemExit, match=f"{flag} {value} applies only"):
            cli.make_hasher(args)

    def test_interleave_one_is_what_runs_everywhere(self):
        for backend in ("cuda", "cpu"):
            cli.make_hasher(cli.build_parser().parse_args(
                ["--bench", "--device", "cpu", "--backend", backend,
                 "--interleave", "1", "--batch-bits", "18"]))

    @pytest.mark.parametrize("argv, match", [
        (["--interleave", "0"], ">= 1"),
        (["--sublanes", "0"], ">= 1"),
        (["--vshare", "2", "--cgroup", "3"], "between 1 and --vshare"),
    ])
    def test_bad_values_are_refused(self, argv, match):
        args = cli.build_parser().parse_args(
            ["--bench", "--device", "cpu", *argv])
        with pytest.raises(SystemExit, match=match):
            cli.make_hasher(args)
