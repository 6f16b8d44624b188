"""The `hybrid_ms` reader: None where the program opens no `mktfhe/phase2/hybrid` range (a
program without the hybrid product kernel, a CPU run), else the sum of those ranges' ms; the
merges' ranges, which `phase2_ms` reads, are not its."""

import pytest

from benchmark import harness

from conftest import ROOT


@pytest.fixture(scope="module")
def reader():
    return harness._module(ROOT / "benchmark/metrics/hybrid_ms.py", "bench_metric_hybrid_ms")


def _readings(phase_ms):
    return harness.Readings(params=None, width=8, graphed={}, key_setup_s=0.0, window_s=1.0, layer_s=[0.1],
                            phase_ms=phase_ms)


def test_none_without_the_range(reader):
    assert reader.read(_readings({})) is None
    assert reader.read(_readings({"mktfhe/phase1/party0": 14.0, "mktfhe/levkey_lift": 0.1,
                                  "mktfhe/phase2/merge1": 0.5, "mktfhe/phase2/merge2": 0.7})) is None


def test_sum_of_the_ranges(reader):
    ms = {"mktfhe/phase1/party0": 14.0, "mktfhe/phase2/merge1": 0.25, "mktfhe/phase2/hybrid": 1.5,
          "mktfhe/phase2/merge2": 0.5, "mktfhe/phase2/hybrid_other": 0.25, "mktfhe/keyswitch": 4.0}
    assert reader.read(_readings(ms)) == 1.75
