"""The window's arithmetic: the 90th percentile of layer times and the rate,
over a window that holds a stall; the reference check's sample; the host
copies of the outputs."""

import dataclasses

import pytest
import torch

from benchmark import harness


def test_p90_over_a_window_with_a_stall():
    times = [0.340] * 95 + [0.900] * 5  # five stalled layers of a hundred
    assert harness.percentile(times, 90) == 0.340
    times = [0.340] * 89 + [0.900] * 11
    assert harness.percentile(times, 90) == 0.900
    assert harness.percentile([0.1, 0.2, 0.3], 90) == 0.3


def test_rate_is_all_gates_over_all_the_time():
    times = [0.340] * 99 + [3.4]
    width = 128
    rate = len(times) * width / sum(times)
    assert rate == pytest.approx(12800 / 37.06)


@pytest.mark.parametrize("lanes", [1, 3, 9])
def test_sample_is_whole_lanes(lanes):
    """Every sampled gate's first input, the lane's output a layer before,
    is itself sampled, down to layer 0."""
    from benchmark.reference import kms as ref
    layers, width = 7, 5
    sample = harness._sample(3_000_000_001, layers, width, lanes, ref)
    lanes_drawn = {g for _, g in sample}
    assert len(lanes_drawn) == min(lanes, width)
    assert sorted(sample) == sorted((l, g) for g in lanes_drawn for l in range(layers))
    assert sample == harness._sample(3_000_000_001, layers, width, lanes, ref)


def test_outputs_grow_past_their_estimate():
    @dataclasses.dataclass
    class Ct:
        b: torch.Tensor
        a: torch.Tensor

    store = harness._Outputs(Ct(torch.zeros(3, dtype=torch.int32), torch.zeros(3, 4, dtype=torch.int32)), 1,
                             torch.device("cpu"))
    cts = [Ct(torch.full((3,), i, dtype=torch.int32), torch.full((3, 4), -i, dtype=torch.int32)) for i in range(5)]
    for ct in cts:
        store.add(ct)
    store.wait()
    assert len(store) == 5
    for i, ct in enumerate(cts):
        assert torch.equal(store.b[i], ct.b) and torch.equal(store.a[i], ct.a)
