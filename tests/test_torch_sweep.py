"""``Dispatcher.sweep``, the synchronous path, against the JAX package's:
the port's ``cuda-tile`` hasher on the CPU (its plain versions) against
the reference's sweep on its CPU oracle, over a few thousand nonces at an
easy target (~2^-8 a nonce), in the same request slices: the same
shares, the same counters, a busy clock that closes, and the same
``max_shares`` cut, after which the ring holds no dispatch."""

import dataclasses

import pytest
import torch

from bitcoin_miner_tpu import perf_cli as ref_perf_cli
from bitcoin_miner_tpu.backends.base import get_hasher as ref_get_hasher
from bitcoin_miner_tpu.miner import dispatcher as ref_dispatcher
from bitcoin_miner_tpu.telemetry import pipeline as ref_pipeline
from bitcoin_miner_tpu_torch import perf_cli as port_perf_cli
from bitcoin_miner_tpu_torch.backends.base import get_hasher
from bitcoin_miner_tpu_torch.backends.cuda import TileCudaHasher
from bitcoin_miner_tpu_torch.miner import dispatcher as port_dispatcher
from bitcoin_miner_tpu_torch.miner.scheduler import AdaptiveBatchScheduler
from bitcoin_miner_tpu_torch.telemetry import pipeline as port_pipeline

START = 1 << 20
COUNT = 3 * 1024 + 512  # the last request is cut by the range
BATCH = 1 << 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def reference_sweep():
    """The reference's sweep of the range on its CPU oracle: the whole
    range, and cut after 3 shares."""
    out = {}
    for cut in (None, 3):
        d = ref_dispatcher.Dispatcher(
            ref_get_hasher("cpu"), n_workers=1, batch_size=BATCH,
            telemetry=ref_pipeline.PipelineTelemetry())
        shares = d.sweep(ref_perf_cli._proxy_job(), nonce_start=START,
                         nonce_count=COUNT, max_shares=cut)
        out[cut] = (shares, d.stats)
    return out


def _port(telemetry=None, **kw):
    hasher = TileCudaHasher(batch_size=BATCH, device="cpu")
    hasher.telemetry = telemetry or port_pipeline.PipelineTelemetry()
    d = port_dispatcher.Dispatcher(hasher, n_workers=1, batch_size=BATCH,
                                   telemetry=hasher.telemetry, **kw)
    return d, hasher


def _as_tuples(shares):
    return [dataclasses.astuple(s) for s in shares]


def test_sweep_matches_the_reference(reference_sweep):
    ref_shares, ref_stats = reference_sweep[None]
    d, hasher = _port()
    shares = d.sweep(port_perf_cli._proxy_job(), nonce_start=START,
                     nonce_count=COUNT)
    assert _as_tuples(shares) == _as_tuples(ref_shares) and len(shares) > 5
    stats = d.stats
    for key in ("hashes", "batches", "shares_found", "hw_errors",
                "blocks_found"):
        assert getattr(stats, key) == getattr(ref_stats, key), key
    assert stats.hashes == COUNT and stats.batches == 4
    # The busy clock closed: one interval over the ring's dispatches.
    assert stats._active_scans == ref_stats._active_scans == 0
    assert stats.scan_seconds > 0
    tel = d.telemetry
    assert tel.ring_occupancy.value == 0 and hasher.dispatches_abandoned == 0
    assert tel.ring_collect.count == 4


def test_max_shares_cut_matches_and_empties_the_ring(reference_sweep):
    ref_shares, ref_stats = reference_sweep[3]
    d, hasher = _port()
    shares = d.sweep(port_perf_cli._proxy_job(), nonce_start=START,
                     nonce_count=COUNT, max_shares=3)
    assert _as_tuples(shares) == _as_tuples(ref_shares)
    assert len(shares) == 3
    # Every hit of the results collected before the cut was verified.
    assert d.stats.shares_found == ref_stats.shares_found >= 3
    assert d.stats.hashes == ref_stats.hashes < COUNT
    assert d.stats._active_scans == 0
    # The stream was closed: the ring gave back the dispatches it held.
    assert d.telemetry.ring_occupancy.value == 0
    assert hasher.dispatches_abandoned > 0


def test_sweep_follows_the_scheduler_and_the_oracle_backend():
    """Requests come from the scheduler when there is one; the ``cpu``
    backend (no ring) sweeps through the blocking adapter."""
    sched = AdaptiveBatchScheduler(min_bits=9, max_bits=10)
    d, _ = _port(scheduler=sched)
    shares = d.sweep(port_perf_cli._proxy_job(), nonce_start=START,
                     nonce_count=1 << 11)
    assert d.stats.hashes == 1 << 11 and d.stats.batches == 4
    oracle = port_dispatcher.Dispatcher(
        get_hasher("cpu"), n_workers=1, batch_size=BATCH,
        telemetry=port_pipeline.NullTelemetry())
    assert _as_tuples(oracle.sweep(port_perf_cli._proxy_job(),
                                   nonce_start=START,
                                   nonce_count=1 << 11)) == _as_tuples(shares)
    assert oracle.stats._active_scans == 0


def test_sweep_closes_the_busy_clock_when_the_hasher_raises():
    d, hasher = _port()

    def broken(*a):
        raise RuntimeError("card lost")

    hasher._scan_fn = broken
    with pytest.raises(RuntimeError, match="card lost"):
        d.sweep(port_perf_cli._proxy_job(), nonce_start=0, nonce_count=BATCH)
    assert d.stats._active_scans == 0 and d.stats.batches == 0
