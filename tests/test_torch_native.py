"""The package's native CPU hasher (``backends/native.py`` over its own
copy of ``sha256d.cpp``) against the reference's ``backends/native.py``
and the hashlib oracle on seeded inputs: ``sha256d``, ``midstate``,
``scan`` (hit lists, totals, the ``max_hits`` cap), the one-call share
validator on every verdict class, and ``NativeCpuHasher`` at the
``Hasher`` seam. The library builds with g++ under ``build/native/``
and never writes into the reference's ``native/``. Skipped only where
there is no g++; a failed build fails."""

import hashlib
import shutil
from pathlib import Path

import numpy as np
import pytest

from bitcoin_miner_tpu.backends import native as ref_native
from bitcoin_miner_tpu.backends.cpu import NativeCpuHasher as RefNativeHasher
from bitcoin_miner_tpu_torch.backends import native
from bitcoin_miner_tpu_torch.backends.base import get_hasher
from bitcoin_miner_tpu_torch.backends.cpu import NativeCpuHasher
from bitcoin_miner_tpu_torch.core.header import (
    GENESIS_HEADER_HEX,
    GENESIS_NONCE,
    merkle_root_from_branch,
)
from bitcoin_miner_tpu_torch.core.sha256 import sha256d, sha256_midstate
from bitcoin_miner_tpu_torch.core.target import (
    difficulty_to_target,
    nbits_to_target,
)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ to build the native hasher")

REPO = Path(__file__).resolve().parents[1]
GENESIS76 = bytes.fromhex(GENESIS_HEADER_HEX)[:76]
DIFF1 = nbits_to_target(0x1D00FFFF)
SEEDS = [0, 1, 2]


def _rng(seed):
    return np.random.default_rng(1500 + seed)


def _bytes(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _tree(root: Path) -> dict:
    return {p.relative_to(root): (p.stat().st_mtime_ns,
                                  hashlib.sha256(p.read_bytes()).hexdigest())
            for p in sorted(root.rglob("*")) if p.is_file()}


class TestBuild:
    def test_library_builds_under_build_native(self):
        path = Path(native.load()._name)
        assert path.parent == REPO / "build" / "native"
        assert path.name.startswith("libsha256d-") and path.exists()
        assert native.backend_name() in ("shani", "scalar")

    def test_a_fresh_build_writes_nothing_into_native(self, tmp_path):
        before = _tree(REPO / "native")
        out = native.build(tmp_path / "native")
        assert out.parent == tmp_path / "native" and out.exists()
        assert [p.name for p in (tmp_path / "native").iterdir()] == [out.name]
        assert _tree(REPO / "native") == before
        # The name is the source's and the flags' digest: a rebuild is a
        # no-op, the same file.
        assert native.build(tmp_path / "native") == out

    def test_no_shani_probe_builds_the_scalar_path(self, tmp_path,
                                                   monkeypatch):
        monkeypatch.setattr(native, "shani_supported", lambda cxx: False)
        flags = native.build_flags(native.compiler())
        assert flags[-1] == "-DBTM_NO_SHANI"
        out = native.build(tmp_path)
        import ctypes

        lib = ctypes.CDLL(str(out))
        lib.btm_backend.restype = ctypes.c_char_p
        assert lib.btm_backend() == b"scalar"

    def test_a_failed_build_raises_with_the_compiler_output(self, tmp_path,
                                                            monkeypatch):
        bad = tmp_path / "bad.cpp"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(native, "SRC_PATH", bad)
        with pytest.raises(OSError, match="failed"):
            native.build(tmp_path / "out")
        assert not list((tmp_path / "out").glob("*.so"))


class TestPrimitives:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_sha256d_matches_reference_and_oracle(self, seed):
        rng = _rng(seed)
        for n in list(range(0, 130)) + [int(x) for x in
                                        rng.integers(130, 301, 40)]:
            data = _bytes(rng, n)
            want = sha256d(data)
            assert native.sha256d(data) == want
            assert ref_native.sha256d(data) == want

    @pytest.mark.parametrize("seed", SEEDS)
    def test_midstate_matches_reference_and_oracle(self, seed):
        rng = _rng(seed)
        for _ in range(20):
            first64 = _bytes(rng, 64)
            got = native.midstate(first64)
            assert got == tuple(sha256_midstate(first64))
            assert got == ref_native.midstate(first64)
        with pytest.raises(ValueError):
            native.midstate(b"x" * 63)


class TestScan:
    @pytest.mark.parametrize("start,count", [
        (GENESIS_NONCE - 2048, 4096),
        (GENESIS_NONCE, 1),
        (GENESIS_NONCE + 1, 1000),
        ((1 << 32) - 300, 300),
        (0, 0),
    ])
    def test_genesis_ranges_match_reference(self, start, count):
        got = native.scan(GENESIS76, start, count, DIFF1, 8)
        assert got == ref_native.scan(GENESIS76, start, count, DIFF1, 8)
        assert got == (([GENESIS_NONCE], 1)
                       if start <= GENESIS_NONCE < start + count
                       else ([], 0))

    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("max_hits", [1, 5, 64])
    def test_easy_targets_cap_the_list_not_the_total(self, seed, max_hits):
        rng = _rng(seed)
        header = _bytes(rng, 76)
        target = difficulty_to_target(1 / (1 << 28))  # ~1 hit in 16
        start = int(rng.integers(0, 1 << 31))
        hits, total = native.scan(header, start, 1024, target, max_hits)
        assert (hits, total) == ref_native.scan(header, start, 1024, target,
                                                max_hits)
        oracle = get_hasher("cpu").scan(header, start, 1024, target,
                                        max_hits=1024)
        assert total == oracle.total_hits
        assert hits == oracle.nonces[:max_hits]
        assert total > max_hits or max_hits == 64

    def test_hasher_seam_matches_reference(self):
        port, ref = NativeCpuHasher(), RefNativeHasher()
        target = difficulty_to_target(1 / (1 << 24))
        for start, count, tgt, cap in ((GENESIS_NONCE - 2048, 4096, DIFF1, 64),
                                       (1000, 8192, target, 64),
                                       (5, 8192, target, 3)):
            got = port.scan(GENESIS76, start, count, tgt, max_hits=cap)
            want = ref.scan(GENESIS76, start, count, tgt, max_hits=cap)
            assert (got.nonces, got.total_hits, got.hashes_done) == (
                want.nonces, want.total_hits, want.hashes_done)
        assert port.sha256d(b"abc") == ref.sha256d(b"abc")
        assert port.verify(GENESIS76 + GENESIS_NONCE.to_bytes(4, "little"),
                           DIFF1)
        with pytest.raises(ValueError):
            port.scan(GENESIS76, (1 << 32) - 1, 2, DIFF1)
        assert get_hasher("native").name == "native"


def _share(rng, prefix_len, branch_n):
    """A coinbase prefix of ``prefix_len`` bytes, a tail, a branch and a
    header prefix: one share's inputs."""
    prefix = _bytes(rng, prefix_len)
    tail = _bytes(rng, int(rng.integers(4, 90)))
    branch = [_bytes(rng, 32) for _ in range(branch_n)]
    prefix36 = _bytes(rng, 36)
    ntime, nbits, nonce = (int(x) for x in rng.integers(0, 1 << 32, 3))
    return prefix, tail, branch, prefix36, ntime, nbits, nonce


def _oracle_digest(prefix, tail, branch, prefix36, ntime, nbits, nonce):
    merkle = merkle_root_from_branch(sha256d(prefix + tail), branch)
    return sha256d(prefix36 + merkle + ntime.to_bytes(4, "little")
                   + nbits.to_bytes(4, "little") + nonce.to_bytes(4, "little"))


class TestValidateShare:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_digest_and_verdicts_match_reference_and_oracle(self, seed):
        rng = _rng(seed)
        for prefix_len in (0, 1, 63, 64, 65, 127, 128, 200):
            for branch_n in (0, 1, 3):
                args = _share(rng, prefix_len, branch_n)
                prefix, tail, branch, prefix36, ntime, nbits, nonce = args
                digest = _oracle_digest(*args)
                h = int.from_bytes(digest, "little")
                # Every verdict class: the hash just meets, just misses,
                # the widest target, and none.
                for target, want in ((h, True), (h - 1, False),
                                     ((1 << 256) - 1, True), (0, False)):
                    got = []
                    for mod in (native, ref_native):
                        mid8, absorbed, rem = mod.prefix_midstate(prefix)
                        assert absorbed == len(prefix) - len(prefix) % 64
                        got.append(mod.validate_share(
                            mid8, absorbed, rem + tail, b"".join(branch),
                            branch_n, prefix36, ntime, nbits, nonce,
                            target.to_bytes(32, "big")))
                    assert got[0] == got[1] == (want, digest)

    def test_validator_handles_reuse_one_digest_buffer(self):
        fn, buf = native.validator_handles()
        rng = _rng(9)
        prefix, tail, branch, prefix36, ntime, nbits, nonce = _share(rng, 70, 2)
        mid8, absorbed, rem = native.prefix_midstate(prefix)
        t = rem + tail
        ok = fn(mid8, absorbed, t, len(t), b"".join(branch), 2, prefix36,
                ntime, nbits, nonce, ((1 << 256) - 1).to_bytes(32, "big"), buf)
        assert ok == 1
        assert bytes(buf) == _oracle_digest(prefix, tail, branch, prefix36,
                                            ntime, nbits, nonce)
