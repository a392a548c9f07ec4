"""The PyTorch package's pipeline probe (``probes/pipeline_probe.py``)
against the reference's ``benchmarks/pipeline_probe.py``: the reference's
``TestPipelineProbe`` and ``TestProbeAdaptiveEdges`` cases on the port,
the same gap statistics and exposition from the same spans (the metric
names and buckets of the live ``/metrics``), the same report keys from
both packages' probes on their CPU hashers with ``overlap`` in both, and
the probe's spans in a trace armed in ``tmp_path``."""

import importlib.util
import os

import pytest

from bitcoin_miner_tpu.backends.base import get_hasher as ref_get
from bitcoin_miner_tpu.core.target import (
    difficulty_to_target as ref_difficulty_to_target,
)
from bitcoin_miner_tpu.telemetry import MetricRegistry as RefRegistry
from bitcoin_miner_tpu_torch.backends.base import ScanResult, get_hasher
from bitcoin_miner_tpu_torch.core.header import GENESIS_HEADER_HEX
from bitcoin_miner_tpu_torch.core.target import difficulty_to_target
from bitcoin_miner_tpu_torch.probes import pipeline_probe
from bitcoin_miner_tpu_torch.telemetry import (
    MetricRegistry,
    PipelineTelemetry,
    set_telemetry,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENESIS76 = bytes.fromhex(GENESIS_HEADER_HEX)[:76]
EASY = 1 / (1 << 24)


@pytest.fixture(scope="module")
def ref_probe():
    spec = importlib.util.spec_from_file_location(
        "ref_pipeline_probe", os.path.join(REPO, "benchmarks",
                                           "pipeline_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in d.items()}


class TestPipelineProbe:
    def test_streaming_closes_the_dispatch_gap(self):
        out = pipeline_probe.probe(
            get_hasher("native"), GENESIS76, difficulty_to_target(EASY),
            batches=4, batch_size=1 << 14, verify_seconds=0.05,
        )
        assert out["overlap"] is True
        assert out["streaming"]["gap_ms_mean"] < out["streaming"][
            "batch_ms_mean"]
        assert out["streaming"]["gap_ms_mean"] < out["blocking"][
            "gap_ms_mean"]
        assert out["streaming"]["busy_fraction"] > out["blocking"][
            "busy_fraction"]

    def test_parity_gate_inside_probe(self):
        class Lying:
            name = "liar"
            calls = 0

            def scan(self, header76, nonce_start, count, target,
                     max_hits=64):
                Lying.calls += 1  # the two passes diverge
                return ScanResult(nonces=[Lying.calls], total_hits=1,
                                  hashes_done=count)

        with pytest.raises(AssertionError, match="parity"):
            pipeline_probe.probe(Lying(), GENESIS76, 1 << 255, batches=2,
                                 batch_size=8, verify_seconds=0.0)


class TestProbeAdaptiveEdges:
    def test_switch_at_index_zero_reports_no_steady_state(self):
        out = pipeline_probe.probe_adaptive(
            get_hasher("cpu"), GENESIS76, difficulty_to_target(EASY),
            nonce_budget=1 << 8, min_bits=4, max_bits=6,
            switch_fraction=0.0,
        )
        assert out["steady_batch_nonces"] == 0
        assert out["steady_batch_ms"] is None
        assert out["adapted"] is False


def test_gap_stats_and_exposition_are_the_references(ref_probe):
    spans = [(0.0, 1.0), (1.5, 2.0), (2.1, 3.0), (3.0, 3.25),
             (3.2501, 4.0)]
    port_reg, ref_reg = MetricRegistry(), RefRegistry()
    port = pipeline_probe._gap_stats(spans, registry=port_reg)
    assert port == ref_probe._gap_stats(spans, registry=ref_reg)
    assert port["gap_ms_max"] == pytest.approx(500.0)
    assert port["busy_fraction"] == pytest.approx(3.3999 / 4.0, abs=1e-4)
    assert port_reg.render() == ref_reg.render()
    assert pipeline_probe._gap_stats([]) == ref_probe._gap_stats([])


def test_probe_reports_what_the_reference_reports(ref_probe):
    """Both probes on their CPU hashers, blocking against streaming with
    the same simulated leg: the same keys, and overlap in both."""
    kwargs = dict(batches=3, batch_size=1 << 6, verify_seconds=0.2)
    port = pipeline_probe.probe(get_hasher("cpu"), GENESIS76,
                                difficulty_to_target(EASY), **kwargs)
    ref = ref_probe.probe(ref_get("cpu"), GENESIS76,
                          ref_difficulty_to_target(EASY), **kwargs)
    assert _keys(port) == _keys(ref)
    assert port["overlap"] is True and ref["overlap"] is True
    assert port["backend"] == "cpu" and port["verify_ms"] == ref["verify_ms"]


def test_adaptive_report_keys_are_the_references(ref_probe):
    kwargs = dict(nonce_budget=1 << 8, min_bits=4, max_bits=6)
    port = pipeline_probe.probe_adaptive(
        get_hasher("cpu"), GENESIS76, difficulty_to_target(EASY), **kwargs)
    ref = ref_probe.probe_adaptive(
        ref_get("cpu"), GENESIS76, ref_difficulty_to_target(EASY), **kwargs)
    assert _keys(port) == _keys(ref)
    assert port["batches"] >= 2
    assert port["batch_nonces_min"] >= 1 << 4


def test_adaptive_probe_lifts_onto_the_dispatch_grid():
    """A tile hasher's grid (its batch) lifts the scheduler's floor."""
    from bitcoin_miner_tpu_torch.backends.cuda import TileCudaHasher

    hasher = TileCudaHasher(batch_size=1 << 10, device="cpu")
    out = pipeline_probe.probe_adaptive(
        hasher, GENESIS76, difficulty_to_target(EASY),
        nonce_budget=1 << 13, min_bits=5, max_bits=6)
    assert out["batch_nonces_min"] >= 1 << 10
    assert out["batch_nonces_max"] <= 1 << 13


def test_timed_dispatches_are_traced_when_tracing_is_armed(tmp_path):
    set_telemetry(PipelineTelemetry(trace_path=str(tmp_path / "t.json")))
    try:
        out = pipeline_probe.measure_pipeline(
            get_hasher("native"), [
                pipeline_probe.ScanRequest(
                    header76=GENESIS76, nonce_start=i << 10, count=1 << 10,
                    target=difficulty_to_target(EASY))
                for i in range(3)], mode="stream")
        from bitcoin_miner_tpu_torch.telemetry import get_telemetry

        names = [e["name"] for e in get_telemetry().tracer.events()]
    finally:
        set_telemetry(None)  # the next reader builds its own
    assert out["batches"] == 3 and len(out["hits"]) == 3
    assert names.count("device_dispatch") == 3
