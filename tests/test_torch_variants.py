"""The tile kernel's layouts (``variant``, ``cgroup``, ``interleave``) in
the PyTorch package against the JAX reference on the CPU: the port's
``scan_tile`` in each layout against the Pallas kernel in interpret mode,
slot for slot, and its validation errors against ``make_pallas_scan_fn``'s;
the layouts' libraries and operation counts. Every output is an integer,
so every comparison is exact. The JAX scan functions are built once per
configuration and shared by the file's tests.
(``test_torch_variants_hasher.py`` holds the hasher and the CLI.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitcoin_miner_tpu.core.header import GENESIS_HEADER_HEX, GENESIS_NONCE
from bitcoin_miner_tpu.core.target import difficulty_to_target, nbits_to_target
from bitcoin_miner_tpu.ops import sha256_pallas as ref_pallas
from bitcoin_miner_tpu.ops.sha256_pallas import make_pallas_scan_fn
from bitcoin_miner_tpu_torch.backends.cuda import (
    DEFAULT_VERSION_MASK,
    sibling_version_patterns,
)
from bitcoin_miner_tpu_torch.ops import csrc, sha256_tile
from bitcoin_miner_tpu_torch.ops.sha256_tile import (
    VARIANTS,
    job_block_from_header,
    scan_tile,
    scan_tile_plain,
)
from bitcoin_miner_tpu_torch.ops.sha256_torch import ops_per_nonce


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
N_STEPS = 4


def _header(seed):
    return np.random.default_rng(seed).integers(0, 256, 76, dtype=np.uint8).tobytes()


def _versions(header76, k):
    version = int.from_bytes(header76[:4], "little")
    return [version] + [version ^ p for p in
                        sibling_version_patterns(DEFAULT_VERSION_MASK, k)]


# (variant, k, word7, cgroup, interleave, sublanes, inner_tiles): every
# variant in both modes, k = 1, 2, 3, chain passes smaller than k, two
# nonces in flight, steps of 128 to 512 nonces.
CONFIGS = [
    ("baseline", 1, True, 0, 1, 1, 2),
    ("baseline", 3, False, 1, 1, 1, 2),
    ("regchain", 2, False, 0, 1, 1, 2),
    ("regchain", 1, True, 0, 2, 1, 2),
    ("wsplit", 3, True, 0, 1, 1, 2),
    ("wsplit", 3, False, 2, 1, 2, 1),
    ("wstage", 1, False, 0, 2, 1, 2),
    ("wstage", 2, True, 0, 1, 1, 1),
    ("vroll", 2, False, 0, 1, 1, 2),
    ("vroll", 3, True, 2, 1, 1, 2),
    ("vroll-db", 1, True, 0, 1, 1, 2),
    ("vroll-db", 2, False, 0, 2, 1, 4),
]


def _config_id(config):
    variant, k, word7, cgroup, interleave, sublanes, inner_tiles = config
    return (f"{variant}-k{k}-{'word7' if word7 else 'exact'}-g{cgroup}"
            f"-i{interleave}-s{sublanes}x{inner_tiles}")


def _cases(step):
    """(header, target, nonce_base, limit) over N_STEPS steps of ``step``
    nonces: the genesis solve in the second step; an easy target (several
    hits per step) on a range that wraps past 2^32 with a limit that cuts
    the third step and leaves the fourth wholly past it."""
    return {
        "genesis": (GENESIS76, DIFF1, GENESIS_NONCE - step - 5,
                    N_STEPS * step),
        "easy_cut_wraps": (_header(71), EASY, (1 << 32) - step - 37,
                           2 * step + step // 2 + 3),
    }


_SCAN_FNS = {}


def _pallas_scan(config):
    """The Pallas kernel of ``config`` in interpret mode, built once."""
    if config not in _SCAN_FNS:
        variant, k, word7, cgroup, interleave, sublanes, inner_tiles = config
        _SCAN_FNS[config] = make_pallas_scan_fn(
            batch_size=N_STEPS * sublanes * 128 * inner_tiles,
            sublanes=sublanes, inner_tiles=inner_tiles, interpret=True,
            unroll=8, word7=word7, interleave=interleave, vshare=k,
            variant=variant, cgroup=cgroup)
    return _SCAN_FNS[config]


class TestOutputs:
    @pytest.mark.parametrize("case", ["genesis", "easy_cut_wraps"])
    @pytest.mark.parametrize("config", CONFIGS, ids=_config_id)
    def test_matches_pallas_kernel(self, config, case):
        variant, k, word7, cgroup, interleave, sublanes, inner_tiles = config
        header76, target, base, limit = _cases(
            sublanes * 128 * inner_tiles)[case]
        job = job_block_from_header(header76, target, base, limit,
                                    versions=_versions(header76, k))
        scan, step = _pallas_scan(config)
        assert step == sublanes * 128 * inner_tiles
        ref_counts, ref_mins = scan(jnp.asarray(job.numpy()))
        counts, mins = scan_tile(job, n_steps=N_STEPS, block=step,
                                 word7=word7, vshare=k, variant=variant,
                                 cgroup=cgroup, interleave=interleave)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
        np.testing.assert_array_equal(mins.numpy(), np.asarray(ref_mins))
        if case == "genesis":
            assert int(mins[k]) == GENESIS_NONCE  # step 1, chain 0
        else:
            assert int(counts.max()) > 1  # multi-hit steps
            assert int(counts[3 * k]) == 0  # the step wholly past the limit

    @pytest.mark.parametrize("variant", VARIANTS)
    def test_every_layout_is_the_plain_scan_on_the_cpu(self, variant):
        header76 = _header(72)
        job = job_block_from_header(header76, EASY, 11, 3000,
                                    versions=_versions(header76, 3))
        want = scan_tile_plain(job, n_steps=4, block=1024, vshare=3)
        for cgroup in range(4):
            got = scan_tile(job, n_steps=4, block=1024, vshare=3,
                            variant=variant, cgroup=cgroup, interleave=2)
            assert all(torch.equal(a, b) for a, b in zip(got, want))


class TestValidation:
    # (variant, vshare, cgroup, interleave, inner_tiles) that
    # make_pallas_scan_fn refuses.
    BAD = [
        ("wstage", 1, 0, 3, 4),   # interleave does not divide inner_tiles
        ("nope", 1, 0, 1, 2),     # unknown variant
        ("vroll-db", 2, 0, 2, 2),  # two interleave groups do not fit
        ("vroll-db", 1, 0, 1, 1),
        ("wsplit", 2, 3, 1, 2),   # cgroup above vshare
        ("baseline", 2, -1, 1, 2),
    ]

    @pytest.mark.parametrize("bad", BAD, ids=lambda b: "-".join(map(str, b)))
    def test_scan_tile_refuses_as_make_pallas_scan_fn(self, bad):
        variant, k, cgroup, interleave, inner_tiles = bad
        with pytest.raises(ValueError) as ref:
            make_pallas_scan_fn(batch_size=128 * inner_tiles, sublanes=1,
                                inner_tiles=inner_tiles, interpret=True,
                                interleave=interleave, vshare=k,
                                variant=variant, cgroup=cgroup)
        job = job_block_from_header(bytes(76), EASY, 0, 128 * inner_tiles,
                                    versions=_versions(bytes(76), k))
        with pytest.raises(ValueError) as port:
            scan_tile(job, n_steps=1, block=128 * inner_tiles, vshare=k,
                      variant=variant, cgroup=cgroup, interleave=interleave)
        assert str(port.value) == str(ref.value)

    def test_block_is_whole_rows(self):
        job = job_block_from_header(bytes(76), EASY, 0, 64)
        with pytest.raises(ValueError, match="multiple of 128"):
            scan_tile(job, n_steps=1, block=64)

    def test_copies_match_the_reference(self):
        assert sha256_tile.VARIANTS == ref_pallas.VARIANTS
        assert sha256_tile.STAGED_VARIANTS == ref_pallas.STAGED_VARIANTS
        for k in range(1, 9):
            for g in range(1, k + 1):
                assert (sha256_tile._chain_groups(k, g)
                        == ref_pallas._chain_groups(k, g))
            for variant in VARIANTS:
                for cgroup in range(k + 1):
                    assert (sha256_tile._cgroup_size(cgroup, variant, k)
                            == ref_pallas._cgroup_size(cgroup, variant, k))

    def test_staged_planes_beyond_a_block_are_refused(self):
        """At 128 threads a slot takes 24 KB: 9 fit in an H100 block."""
        sha256_tile.check_plane("vroll", 9)
        sha256_tile.check_plane("vroll-db", 4)
        sha256_tile.check_plane("regchain", 64)
        for variant, interleave in (("wstage", 10), ("vroll-db", 5)):
            with pytest.raises(ValueError, match="shared memory"):
                sha256_tile.check_plane(variant, interleave)


class TestLibraries:
    def test_baseline_keeps_its_libraries(self):
        assert sha256_tile.tile_library(1) == "scan_tile"
        assert sha256_tile.tile_library(4, cgroup=4) == "scan_tile_k4"
        assert csrc.SOURCES["scan_tile_k4"] == ("scan_tile.cu",
                                                (("VSHARE", 4),))

    @pytest.mark.parametrize("args, name, defines", [
        ((2, "vroll"), "scan_tile_vroll_k2_g1_i1",
         dict(VSHARE=2, VARIANT=4, CGROUP=1, INTERLEAVE=1)),
        ((4, "baseline", 2), "scan_tile_baseline_k4_g2_i1",
         dict(VSHARE=4, VARIANT=0, CGROUP=2, INTERLEAVE=1)),
        ((3, "regchain", 0, 2), "scan_tile_regchain_k3_g3_i2",
         dict(VSHARE=3, VARIANT=1, CGROUP=3, INTERLEAVE=2)),
        ((1, "vroll-db"), "scan_tile_vroll_db_k1_g1_i1",
         dict(VSHARE=1, VARIANT=5, CGROUP=1, INTERLEAVE=1)),
    ])
    def test_layout_library_is_keyed_by_its_defines(self, args, name, defines):
        assert sha256_tile.tile_library(*args) == name
        assert csrc.SOURCES[name] == ("scan_tile.cu", tuple(defines.items()))
        flags = csrc._flags(name)
        assert all(f"-D{d}={v}" in flags for d, v in defines.items())
        assert csrc.library_path(name) != csrc.library_path("scan_tile")
        assert csrc.launch_counter(name) is csrc.launch_counter(name)

    def test_a_name_keeps_its_spec(self):
        csrc.register("scan_tile_test_spec", "scan_tile.cu", VSHARE=1)
        with pytest.raises(ValueError, match="already"):
            csrc.register("scan_tile_test_spec", "scan_tile.cu", VSHARE=2)

    def test_wrappers_on_cpu_launch_nothing(self):
        header76 = _header(73)
        job = job_block_from_header(header76, EASY, 3, 2048,
                                    versions=_versions(header76, 2))
        before = {c.name: c.value for c in csrc.counters()}
        scan_tile(job, n_steps=2, block=1024, vshare=2, variant="vroll")
        assert {c.name: c.value for c in csrc.counters()
                if c.name in before} == before


class TestOpCount:
    @pytest.mark.parametrize("word7", [False, True])
    def test_each_pass_expands_the_schedule_again(self, word7):
        for k in range(1, 9):
            one = ops_per_nonce(word7, k)
            assert ops_per_nonce(word7, k, passes=1) == one
            for passes in range(2, k + 1):
                more = ops_per_nonce(word7, k, passes=passes)
                assert more.total - one.total == 380 * (passes - 1)
        with pytest.raises(ValueError, match="passes"):
            ops_per_nonce(word7, 2, passes=3)
