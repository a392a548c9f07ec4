"""The tile hasher's batched rescan of candidate steps.

``rescan_steps_plain`` against ``scan_batch_plain`` slot by slot and
against the reference's one-step rescan (``make_scan_fn``, as
``PallasTpuHasher._tile_rescan`` builds it) on the same seeded job
blocks; at the ``Hasher`` seam, ``TileCudaHasher(device="cpu")`` against
``PallasTpuHasher`` in interpret mode at targets where most steps hold
several hits; and the host's one ``rescan_steps`` call per device and
dispatch. Exact equality: every output is an integer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitcoin_miner_tpu.backends.tpu import PallasTpuHasher
from bitcoin_miner_tpu.core.header import GENESIS_HEADER_HEX, GENESIS_NONCE
from bitcoin_miner_tpu.core.target import (
    difficulty_to_target,
    nbits_to_target,
)
from bitcoin_miner_tpu.ops.sha256_jax import make_scan_fn
from bitcoin_miner_tpu_torch.backends import cuda as port_cuda
from bitcoin_miner_tpu_torch.backends.cuda import (
    DEFAULT_VERSION_MASK,
    ShardedTileCudaHasher,
    TileCudaHasher,
    sibling_version_patterns,
)
from bitcoin_miner_tpu_torch.ops import csrc
from bitcoin_miner_tpu_torch.ops.sha256_tile import job_block_from_header
from bitcoin_miner_tpu_torch.ops.sha256_torch import (
    RESCAN_STEPS,
    rescan_counter,
    rescan_geometry,
    rescan_steps,
    rescan_steps_plain,
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
EASY = difficulty_to_target(1 / (1 << 24))  # ~2^-8 per nonce
REGTEST = nbits_to_target(0x207FFFFF)  # about half of all hashes
EVERYTHING = (1 << 256) - 1
MAX32 = 0xFFFFFFFF


def _header(seed):
    return np.random.default_rng(seed).integers(0, 256, 76,
                                                dtype=np.uint8).tobytes()


def _job(header76, target, base, limit, k):
    """The tile kernel's job block of k chains: the header's own version
    and k-1 siblings inside the default mask."""
    version = int.from_bytes(header76[:4], "little")
    versions = [version] + [version ^ p for p in
                            sibling_version_patterns(DEFAULT_VERSION_MASK, k)]
    return job_block_from_header(header76, target, base, limit,
                                 versions=versions)


def _step_range(tile, limit, step):
    return min(tile, limit - step * tile)


# (label, header, target, nonce_base, limit, k, tile, slots, max_hits)
CASES = [
    ("k1_easy_overflow", _header(1), EASY, 123_456, 4 * 1024, 1, 1024,
     [0, 2, 3], 2),
    ("k2_siblings", _header(2), EASY, 77, 3 * 1024, 2, 1024,
     [0, 1, 3, 4, 5], 16),
    ("limit_cuts_last_step", _header(3), EASY, 9, 2 * 2048 + 300, 1, 2048,
     [0, 2], 16),
    ("wraps_past_2_32", _header(4), EASY, (1 << 32) - 1500, 2 * 1024, 2,
     1024, [1, 2, 3], 16),
    ("all_hits", _header(5), EVERYTHING, (1 << 32) - 300, 3 * 1024, 1,
     1024, [0, 1, 2], 16),
    ("regtest", _header(6), REGTEST, 5000, 4 * 2048, 2, 2048,
     [0, 3, 5, 6], 16),
]


def _case_job(case):
    _, header76, target, base, limit, k, tile, slots, max_hits = case
    return _job(header76, target, base, limit, k)


@pytest.fixture(scope="module")
def reference_rescans():
    """The reference's one-step rescan, built once per (tile, max_hits)."""
    cache = {}

    def get(tile, max_hits):
        if (tile, max_hits) not in cache:
            cache[tile, max_hits] = make_scan_fn(tile, min(tile, 1 << 10),
                                                 max_hits, unroll=8)
        return cache[tile, max_hits]

    return get


class TestRescanStepsPlain:
    @pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
    def test_matches_scan_batch_plain_slot_by_slot(self, case):
        _, _, _, base, limit, k, tile, slots, max_hits = case
        job = _case_job(case)
        hits, count = rescan_steps_plain(job, torch.tensor(slots), k=k,
                                         tile=tile, max_hits=max_hits)
        assert hits.dtype == torch.uint32 and count.dtype == torch.int32
        assert hits.shape == (len(slots), max_hits)
        t = 16 * k
        for row, slot in enumerate(slots):
            step, c = divmod(slot, k)
            want_hits, want_count = scan_batch_plain(
                job[8 * c:8 * c + 8], job[t:t + 3], job[t + 3:t + 11],
                (base + step * tile) & MAX32,
                _step_range(tile, limit, step), inner_size=1024,
                n_steps=tile // 1024, max_hits=max_hits)
            assert torch.equal(hits[row], want_hits), (slot, row)
            assert int(count[row]) == int(want_count), slot

    @pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
    def test_matches_reference_rescan(self, case, reference_rescans):
        label, header76, target, base, limit, k, tile, slots, max_hits = case
        job = _case_job(case).numpy()
        hits, count = rescan_steps_plain(job, np.asarray(slots, np.int32),
                                         k=k, tile=tile, max_hits=max_hits)
        rescan = reference_rescans(tile, max_hits)
        t = 16 * k
        for row, slot in enumerate(slots):
            step, c = divmod(slot, k)
            ref_hits, ref_count = rescan(
                jnp.asarray(job[8 * c:8 * c + 8]), jnp.asarray(job[t:t + 3]),
                jnp.asarray(job[t + 3:t + 11]),
                jnp.uint32((base + step * tile) & MAX32),
                jnp.uint32(_step_range(tile, limit, step)))
            np.testing.assert_array_equal(hits[row].numpy(),
                                          np.asarray(ref_hits))
            assert int(count[row]) == int(ref_count), (label, slot)
        if label in ("k1_easy_overflow", "all_hits", "regtest"):
            assert int(count.min()) > max_hits, "every slot overflows"

    def test_siblings_use_their_own_chain(self):
        """Slots 2c and 2c+1 of one step differ: chain 1 hashes the
        sibling header."""
        case = CASES[1]
        _, _, _, base, limit, k, tile, _, max_hits = case
        hits, count = rescan_steps_plain(_case_job(case), [0, 1], k=2,
                                         tile=tile, max_hits=max_hits)
        assert not torch.equal(hits[0], hits[1])
        assert int(count[0]) > 0 and int(count[1]) > 0

    def test_step_past_the_limit_is_empty(self):
        job = _job(_header(7), EVERYTHING, 0, 1500, 1)
        hits, count = rescan_steps_plain(job, [1, 2], k=1, tile=1024,
                                         max_hits=4)
        assert count.tolist() == [476, 0]
        assert hits[1].tolist() == [MAX32] * 4
        assert hits[0].tolist() == [1024, 1025, 1026, 1027]

    def test_empty_slot_list(self):
        job = _job(_header(8), EASY, 0, 4096, 2)
        hits, count = rescan_steps_plain(job, [], k=2, tile=1024, max_hits=8)
        assert hits.shape == (0, 8) and count.shape == (0,)
        hits, count = rescan_steps(job, torch.zeros(0, dtype=torch.int32),
                                   k=2, tile=1024, max_hits=8)
        assert hits.shape == (0, 8) and count.shape == (0,)

    @pytest.mark.parametrize("kw, match", [
        (dict(k=1, tile=1024, max_hits=0), "max_hits"),
        (dict(k=1, tile=1024, max_hits=65537), "max_hits"),
        (dict(k=9, tile=1024, max_hits=8), "k must be"),
        (dict(k=1, tile=0, max_hits=8), "tile"),
    ])
    def test_refusals(self, kw, match):
        job = _job(_header(9), EASY, 0, 4096, min(kw["k"], 8))
        with pytest.raises(ValueError, match=match):
            rescan_steps_plain(job, [0], **kw)

    def test_negative_slot_is_refused(self):
        job = _job(_header(9), EASY, 0, 4096, 1)
        with pytest.raises(ValueError, match="non-negative"):
            rescan_steps_plain(job, torch.tensor([-1], dtype=torch.int32),
                               k=1, tile=1024, max_hits=8)


class TestWrapper:
    def test_cpu_tensors_take_the_plain_version(self):
        case = CASES[1]
        _, _, _, _, _, k, tile, slots, max_hits = case
        job = _case_job(case)
        before = RESCAN_STEPS.value
        got = rescan_steps(job, torch.tensor(slots, dtype=torch.int32), k=k,
                           tile=tile, max_hits=max_hits, unroll=8)
        want = rescan_steps_plain(job, slots, k=k, tile=tile,
                                  max_hits=max_hits)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert RESCAN_STEPS.value == before

    def test_form_is_checked(self):
        with pytest.raises(ValueError, match="unroll"):
            rescan_steps(_job(_header(9), EASY, 0, 1024, 1), [0], k=1,
                         tile=1024, max_hits=8, unroll=0)

    @pytest.mark.parametrize("unroll, spec, name", [
        (64, True, "rescan_steps"), (8, True, "rescan_steps_u8"),
        (64, False, "rescan_steps_nospec"),
    ])
    def test_counter_is_named_by_form(self, unroll, spec, name):
        assert rescan_counter(unroll, spec) == name
        assert csrc.launch_counter(name).name == name

    @pytest.mark.parametrize("n_slots, tile, iters, blocks_per_slot", [
        (1, 8192, 1, 64), (3, 8192, 1, 64), (1200, 8192, 32, 2),
        (2048, 8192, 32, 2), (5, 1024, 1, 8), (100, 8192, 6, 11),
    ])
    def test_geometry(self, n_slots, tile, iters, blocks_per_slot):
        got = rescan_geometry(n_slots, tile)
        assert got == (iters, blocks_per_slot)
        assert 128 * iters * blocks_per_slot >= tile  # covers the step


BATCH = 4096  # four 1024-nonce steps a dispatch (inner_tiles=1)


@pytest.fixture(scope="module")
def seam_pair():
    cache = {}

    def get(k):
        if k not in cache:
            cache[k] = (
                TileCudaHasher(batch_size=BATCH, inner_tiles=1, device="cpu",
                               vshare=k),
                PallasTpuHasher(batch_size=BATCH, sublanes=8, inner_tiles=1,
                                interpret=True, unroll=8, vshare=k))
        return cache[k]

    return get


def _seam_fields(result):
    return (result.nonces, result.total_hits, result.hashes_done,
            [tuple(v) for v in result.version_hits], result.version_total_hits)


SEAM_CASES = [
    ("easy", _header(11), EASY, 1000, 3 * BATCH - 700),
    ("regtest", _header(12), REGTEST, (1 << 32) - BATCH - 1234, BATCH + 1234),
]


class TestHasherSeam:
    @pytest.mark.parametrize("case", SEAM_CASES, ids=[c[0] for c in SEAM_CASES])
    @pytest.mark.parametrize("k", [1, 2])
    def test_scan_result_matches_pallas_hasher(self, seam_pair, k, case):
        label, header76, target, start, count = case
        port, ref = seam_pair(k)
        assert port.tile == ref.tile == 1024
        got = port.scan(header76, start, count, target)
        want = ref.scan(header76, start, count, target)
        assert _seam_fields(got) == _seam_fields(want)
        assert got.hashes_done == count * k
        # Most steps hold several hits: the rescans, not the mins, made it.
        assert got.total_hits > 2 * (count // 1024)
        if k == 2:
            assert got.version_total_hits > 2 * (count // 1024)


class _Recorder:
    """Stands in for ``rescan_steps`` in the backend: records each call's
    device and slots, then runs the real one."""

    def __init__(self):
        self.calls = []

    def __call__(self, job, slots, **kw):
        self.calls.append((job.device, [int(s) for s in slots]))
        return rescan_steps(job, slots, **kw)


class TestOneRescanPerDispatch:
    def test_one_call_per_dispatch_with_slots(self, monkeypatch):
        rec = _Recorder()
        monkeypatch.setattr(port_cuda, "rescan_steps", rec)
        h = TileCudaHasher(batch_size=BATCH, inner_tiles=1, device="cpu")
        # Three dispatches at an easy target: every one has slots.
        res = h.scan(_header(13), 0, 3 * BATCH, EASY)
        assert len(rec.calls) == 3
        assert all(slots and device.type == "cpu" for device, slots in rec.calls)
        assert res.total_hits > 3 * 4
        # Three dispatches around the genesis solve at difficulty 1 (word7
        # mode): one candidate step, so one call, for one slot.
        rec.calls.clear()
        base = GENESIS_NONCE - BATCH - 1000
        res = h.scan(GENESIS76, base, 3 * BATCH, DIFF1)
        assert res.nonces == [GENESIS_NONCE]
        assert rec.calls == [(torch.device("cpu"),
                              [(GENESIS_NONCE - base) // 1024 % 4])]

    def test_no_call_without_slots(self, monkeypatch):
        rec = _Recorder()
        monkeypatch.setattr(port_cuda, "rescan_steps", rec)
        h = TileCudaHasher(batch_size=BATCH, inner_tiles=1, device="cpu")
        res = h.scan(GENESIS76, 0, 2 * BATCH, DIFF1)
        assert res.total_hits == 0 and rec.calls == []

    def test_sharded_dispatch_groups_by_card(self, monkeypatch):
        """One card named four times: one call per dispatch, over the
        global slots of every shard's steps, as one device scans them."""
        rec = _Recorder()
        monkeypatch.setattr(port_cuda, "rescan_steps", rec)
        h = ShardedTileCudaHasher(batch_per_device=2048, inner_tiles=1,
                                  devices=["cpu"] * 4)
        one = TileCudaHasher(batch_size=4 * 2048, inner_tiles=1, device="cpu")
        got = h.scan(_header(14), 5, 2 * 4 * 2048, EASY)
        assert len(rec.calls) == 2
        assert max(max(slots) for _, slots in rec.calls) >= 6  # shard 3
        assert _seam_fields(got) == _seam_fields(
            one.scan(_header(14), 5, 2 * 4 * 2048, EASY))

    def test_slots_go_to_the_card_that_scanned_their_step(self,
                                                          monkeypatch):
        """Two cards in the launch mesh: each gets one call with the slots
        of the steps it owns, and hits are added in slot order."""
        h = TileCudaHasher(batch_size=4 * 1024, inner_tiles=1, device="cpu",
                           vshare=2)
        jc = h._job_constants(_header(15), EASY)
        cards = (torch.device("cpu"), torch.device("meta"))
        calls = []

        def fake_rescan(jc_, base, limit, out, device, slots):
            calls.append((device, list(slots)))
            job = torch.from_numpy(jc_.block(base, limit))
            return port_cuda._Dispatch(rescan_steps_plain(
                job, slots, k=2, tile=1024, max_hits=h.max_hits))

        monkeypatch.setattr(h, "_rescan", fake_rescan)
        # Slots step*2 + c of 4 steps: steps 0-1 on card 0, 2-3 on card 1.
        counts = np.array([0, 3, 1, 0, 2, 0, 0, 5], dtype=np.int32)
        mins = np.arange(8, dtype=np.uint32) + 100
        found = port_cuda._Found()
        out = port_cuda._Dispatch([], mesh=cards)
        h._collect_slots(counts, mins, jc, 50, 4 * 1024, found, out)
        assert calls == [(cards[0], [1]), (cards[1], [4, 7])]
        want = rescan_steps_plain(torch.from_numpy(jc.block(50, 4 * 1024)),
                                  [1, 4, 7], k=2, tile=1024, max_hits=64)
        # Slot 2 (chain 0, one hit) keeps its min; the others are rescans.
        rows = {s: want[0][i][:min(int(want[1][i]), 64)].tolist()
                for i, s in enumerate([1, 4, 7])}
        assert found.hits == [102, *rows[4]]
        assert [n for _, n in found.version_hits] == rows[1] + rows[7]
        assert found.total == 1 + int(want[1][1])
        assert found.version_total == int(want[1][0]) + int(want[1][2])
