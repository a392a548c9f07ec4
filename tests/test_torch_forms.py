"""The compile forms of the scan kernels (``unroll`` and ``spec``) in the
PyTorch package against the JAX reference on the CPU: the port's
``scan_tile``, ``scan_batch`` and ``scan_batch_vshare`` in each form
against ``make_pallas_scan_fn`` (interpret mode), ``_scan_batch`` and
``_scan_batch_vshare`` in their rolled form (unroll 8, spec off), slot for
slot: every form computes the same function, and the reference's
unrolled forms take minutes to compile on the CPU. Also the operation
count without partial evaluation; each form's library name and defines;
the hashers' and the command line's form options. On the CPU every form
is its kernel's plain version; the forms exist to be built and timed on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitcoin_miner_tpu.backends.tpu import TpuHasher
from bitcoin_miner_tpu.core.header import GENESIS_HEADER_HEX, GENESIS_NONCE
from bitcoin_miner_tpu.core.target import difficulty_to_target, nbits_to_target
from bitcoin_miner_tpu.ops.sha256_jax import _scan_batch, _scan_batch_vshare
from bitcoin_miner_tpu.ops.sha256_pallas import make_pallas_scan_fn
from bitcoin_miner_tpu_torch import cli
from bitcoin_miner_tpu_torch.backends.cuda import (
    DEFAULT_VERSION_MASK,
    CudaHasher,
    TileCudaHasher,
    sibling_version_patterns,
)
from bitcoin_miner_tpu_torch.ops import csrc
from bitcoin_miner_tpu_torch.ops.sha256_tile import (
    job_block_from_header,
    scan_tile,
    tile_library,
)
from bitcoin_miner_tpu_torch.ops.sha256_torch import (
    HITBUF_SPEC_ONLY,
    hitbuf_library,
    ops_per_nonce,
    scan_batch,
    scan_batch_vshare,
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
STEP, N_STEPS = 1024, 4
HITBUF_INNER, HITBUF_MAX = 512, 16


def _header(seed):
    return np.random.default_rng(seed).integers(0, 256, 76, dtype=np.uint8).tobytes()


def _versions(header76, k):
    version = int.from_bytes(header76[:4], "little")
    return [version] + [version ^ p for p in
                        sibling_version_patterns(DEFAULT_VERSION_MASK, k)]


#: (header, target, nonce_base, limit): the genesis solve in the second
#: step; an easy target on a range that wraps past 2^32 with a limit that
#: cuts the third step and leaves the fourth past it.
CASES = {
    "genesis": (GENESIS76, DIFF1, GENESIS_NONCE - STEP - 5, N_STEPS * STEP),
    "easy_cut_wraps": (_header(81), EASY, (1 << 32) - STEP - 37,
                       2 * STEP + STEP // 2 + 3),
}

#: The port's (unroll, spec, k, word7): rolled forms (spec does not apply
#: below 64) and the unrolled form without partial evaluation, one and two
#: chains.
TILE_FORMS = [(8, True, 1, True), (16, False, 2, False), (32, True, 1, False),
              (64, False, 1, True), (64, False, 2, False)]


def _form_id(form):
    return "-".join(str(x) for x in form)


_PALLAS = {}


def _pallas_scan(k, word7):
    """The Pallas kernel in interpret mode, rolled and without spec."""
    if (k, word7) not in _PALLAS:
        _PALLAS[k, word7] = make_pallas_scan_fn(
            batch_size=N_STEPS * STEP, sublanes=8, inner_tiles=1,
            interpret=True, unroll=8, word7=word7, spec=False, vshare=k)
    return _PALLAS[k, word7]


class TestTileForms:
    @pytest.mark.parametrize("case", sorted(CASES))
    @pytest.mark.parametrize("form", TILE_FORMS, ids=_form_id)
    def test_matches_pallas_kernel(self, form, case):
        unroll, spec, k, word7 = form
        header76, target, base, limit = CASES[case]
        job = job_block_from_header(header76, target, base, limit,
                                    versions=_versions(header76, k))
        scan, block = _pallas_scan(k, word7)
        assert block == STEP
        ref_counts, ref_mins = scan(jnp.asarray(job.numpy()))
        counts, mins = scan_tile(job, n_steps=N_STEPS, block=STEP,
                                 word7=word7, vshare=k, unroll=unroll,
                                 spec=spec)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
        np.testing.assert_array_equal(mins.numpy(), np.asarray(ref_mins))
        if case == "genesis":
            assert int(mins[k]) == GENESIS_NONCE

    def test_bad_unroll_is_refused(self):
        job = job_block_from_header(bytes(76), EASY, 0, STEP)
        for bad in (0, -8, 8.0):
            with pytest.raises(ValueError, match="unroll"):
                scan_tile(job, n_steps=1, block=STEP, unroll=bad)


def _hitbuf_args(header76, target, base, limit, k):
    job = job_block_from_header(header76, target, base, limit,
                                versions=_versions(header76, k)).numpy()
    t = 16 * k
    mids = job[0:8] if k == 1 else job[0:8 * k].reshape(k, 8)
    return (mids, job[t:t + 3], job[t + 3:t + 11], job[t + 11], job[t + 12])


class TestHitBufferForms:
    @pytest.mark.parametrize("case", sorted(CASES))
    @pytest.mark.parametrize("unroll, spec, word7", [
        (8, False, False), (16, True, True), (64, False, True)])
    def test_matches_scan_batch(self, unroll, spec, word7, case):
        args = _hitbuf_args(*CASES[case], 1)
        kw = dict(inner_size=HITBUF_INNER, n_steps=N_STEPS * STEP // HITBUF_INNER,
                  max_hits=HITBUF_MAX, word7=word7)
        ref_hits, ref_count = _scan_batch(*(jnp.asarray(a) for a in args),
                                          unroll=8, spec=False, **kw)
        hits, count = scan_batch(*(torch.from_numpy(np.asarray(a))
                                   for a in args), unroll=unroll, spec=spec,
                                 **kw)
        np.testing.assert_array_equal(hits.numpy(), np.asarray(ref_hits))
        assert int(count) == int(ref_count)

    @pytest.mark.parametrize("unroll, word7", [(8, False), (16, True)])
    def test_k_chains_match_scan_batch_vshare(self, unroll, word7):
        args = _hitbuf_args(*CASES["easy_cut_wraps"], 2)
        kw = dict(inner_size=HITBUF_INNER, n_steps=N_STEPS * STEP // HITBUF_INNER,
                  max_hits=HITBUF_MAX, word7=word7)
        ref_bufs, ref_counts = _scan_batch_vshare(
            *(jnp.asarray(a) for a in args), vshare=2, unroll=8, **kw)
        bufs, counts = scan_batch_vshare(
            *(torch.from_numpy(np.asarray(a)) for a in args), unroll=unroll,
            **kw)
        np.testing.assert_array_equal(bufs.numpy(), np.asarray(ref_bufs))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
        assert int(counts.min()) > HITBUF_MAX  # every chain overflows

    def test_k_chains_have_only_spec_forms(self):
        """The reference's k-chain scan always partially evaluates."""
        args = [torch.from_numpy(np.asarray(a)) for a in
                _hitbuf_args(*CASES["genesis"], 2)]
        with pytest.raises(ValueError, match="spec"):
            scan_batch_vshare(*args, inner_size=HITBUF_INNER, n_steps=1,
                              max_hits=HITBUF_MAX, spec=False)
        for unroll in (64, 8):
            with pytest.raises(ValueError, match="spec"):
                hitbuf_library(2, unroll, False)


class TestOpCount:
    @pytest.mark.parametrize("word7", [False, True])
    def test_without_spec_job_words_count_per_nonce(self, word7):
        for k in (1, 2, 4, 8):
            for passes in (1, k):
                spec = ops_per_nonce(word7, k, passes)
                nospec = ops_per_nonce(word7, k, passes, spec=False)
                assert nospec.logic > spec.logic and nospec.adds > spec.adds
        assert ops_per_nonce(word7, 1) == ops_per_nonce(word7, 1, spec=True)

    def test_pinned_counts(self):
        """The nonce-dependent operations of the one-chain forms: with spec
        the padding, length, IV and job words fold into the constants."""
        assert ops_per_nonce(True, 1).total == 2466
        assert ops_per_nonce(True, 1, spec=False).total == 2644
        assert ops_per_nonce(False, 1, spec=False).total == 2751


class TestLibraries:
    @pytest.mark.parametrize("args, name, defines", [
        ((1, "baseline", 0, 1, 8, True), "scan_tile_u8",
         dict(VSHARE=1, UNROLL=8)),
        ((2, "baseline", 0, 1, 16, False), "scan_tile_k2_u16",
         dict(VSHARE=2, UNROLL=16)),
        ((1, "baseline", 0, 1, 64, False), "scan_tile_nospec",
         dict(VSHARE=1, SPEC=0)),
        ((2, "vroll", 0, 1, 32, True), "scan_tile_vroll_k2_g1_i1_u32",
         dict(VSHARE=2, VARIANT=4, CGROUP=1, INTERLEAVE=1, UNROLL=32)),
        ((1, "regchain", 0, 1, 64, False), "scan_tile_regchain_k1_g1_i1_nospec",
         dict(VSHARE=1, VARIANT=1, CGROUP=1, INTERLEAVE=1, SPEC=0)),
    ])
    def test_tile_form_library_is_keyed_by_its_defines(self, args, name,
                                                        defines):
        assert tile_library(*args) == name
        assert csrc.SOURCES[name] == ("scan_tile.cu", tuple(defines.items()))
        flags = csrc._flags(name)
        assert all(f"-D{d}={v}" in flags for d, v in defines.items())
        assert csrc.library_path(name) != csrc.library_path("scan_tile")

    def test_default_form_keeps_the_baseline_libraries(self):
        assert tile_library(1, unroll=64, spec=True) == "scan_tile"
        assert tile_library(3) == "scan_tile_k3"
        assert hitbuf_library(1) == "scan_hitbuf"
        assert hitbuf_library(4, 64) == "scan_hitbuf_k4"

    @pytest.mark.parametrize("args, name, defines", [
        ((1, 8, False), "scan_hitbuf_u8", dict(VSHARE=1, UNROLL=8)),
        ((1, 64, False), "scan_hitbuf_nospec", dict(VSHARE=1, SPEC=0)),
        ((2, 16, True), "scan_hitbuf_k2_u16", dict(VSHARE=2, UNROLL=16)),
    ])
    def test_hitbuf_form_library(self, args, name, defines):
        assert hitbuf_library(*args) == name
        assert csrc.SOURCES[name] == ("scan_hitbuf.cu",
                                      tuple(defines.items()))
        assert csrc.launch_counter(name) is csrc.launch_counter(name)

    def test_forms(self):
        assert csrc.form_defines(64, True) == {}
        assert csrc.form_defines(64, False) == {"SPEC": 0}
        assert csrc.form_defines(200, False) == {"SPEC": 0}
        assert csrc.form_defines(8, False) == {"UNROLL": 8}
        assert csrc.form_suffix(1, True) == "_u1"
        assert csrc.form_suffix(64, False) == "_nospec"


class TestHashers:
    BATCH = 1 << 11

    @pytest.mark.parametrize("unroll, spec", [(8, False), (64, False)])
    def test_cuda_hasher_form_matches_tpu_hasher(self, unroll, spec):
        header76, start = _header(82), 12_345
        ref = TpuHasher(batch_size=self.BATCH, inner_size=1 << 9, unroll=8,
                        spec=False)
        port = CudaHasher(batch_size=self.BATCH, inner_size=1 << 9,
                          device="cpu", unroll=unroll, spec=spec)
        for target in (EASY, DIFF1):
            got = port.scan(header76, start, 3000, target)
            want = ref.scan(header76, start, 3000, target)
            assert (got.nonces, got.total_hits, got.hashes_done) == (
                want.nonces, want.total_hits, want.hashes_done)

    def test_forms_reach_the_kernels(self):
        h = TileCudaHasher(batch_size=self.BATCH, device="cpu", unroll=16,
                           spec=False, vshare=2)
        assert (h.unroll, h.spec) == (16, False)
        got = h.scan(GENESIS76, GENESIS_NONCE - 1000, 2000, DIFF1)
        assert got.nonces == [GENESIS_NONCE]

    def test_vshare_without_spec_on_the_hit_buffer_is_refused(self):
        with pytest.raises(ValueError) as ref:
            TpuHasher(batch_size=self.BATCH, inner_size=1 << 9, unroll=8,
                      spec=False, vshare=2)
        with pytest.raises(ValueError) as port:
            CudaHasher(batch_size=self.BATCH, inner_size=1 << 9,
                       device="cpu", spec=False, vshare=2)
        assert "spec" in str(ref.value)
        assert str(port.value) == HITBUF_SPEC_ONLY
        # The tile kernel shares its schedule in either form.
        TileCudaHasher(batch_size=self.BATCH, device="cpu", spec=False,
                       vshare=2)
        with pytest.raises(ValueError, match="unroll"):
            CudaHasher(batch_size=self.BATCH, inner_size=1 << 9,
                       device="cpu", unroll=0)


class TestCli:
    def _args(self, *argv):
        return cli.build_parser().parse_args(
            ["--bench", "--device", "cpu", "--batch-bits", "11", *argv])

    def test_form_flags_reach_the_hasher(self):
        h = cli.make_hasher(self._args("--unroll", "8", "--no-spec"))
        assert isinstance(h, TileCudaHasher) and (h.unroll, h.spec) == (8,
                                                                      False)
        h = cli.make_hasher(self._args("--backend", "cuda", "--unroll", "32"))
        assert (h.unroll, h.spec, h.inner_size) == (32, True, 1 << 11)
        h = cli.make_hasher(self._args())
        assert (h.unroll, h.spec) == (64, True)

    @pytest.mark.parametrize("argv, match", [
        (("--backend", "cpu", "--unroll", "8"), "--unroll 8 applies only"),
        (("--backend", "cpu", "--no-spec"), "--no-spec"),
        (("--backend", "cuda", "--vshare", "2", "--no-spec"), "spec kernel"),
        (("--backend", "cuda-mesh", "--vshare", "2", "--no-spec"),
         "spec kernel"),
        (("--unroll", "0"), "--unroll must be"),
    ])
    def test_refusals(self, argv, match):
        with pytest.raises(SystemExit, match=match):
            cli.make_hasher(self._args(*argv))

    def test_bench_with_a_rolled_form_finds_genesis(self, capsys):
        rc = cli.main(["--bench", "--device", "cpu", "--batch-bits", "13",
                       "--bench-nonces", "16384", "--unroll", "16",
                       "--vshare", "2"])
        assert rc == 0
        assert "FOUND+VERIFIED" in capsys.readouterr().out
