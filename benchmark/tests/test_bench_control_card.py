"""The control at a cell's own size, on the card: the reference in the
program's place with its ring products in float64, one layer of
`kms8b-w8`, must come out not correct on every seed (the benchmark's own
runs never run it; `benchmark/control.py` runs it for any cell)."""

import time

import pytest
import torch

from benchmark import harness

from conftest import ROOT


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3_400_000_001, 3_400_000_002, 3_400_000_003])
def test_control_at_cell_size_is_not_correct(card, seed):
    cell = harness.load_cell(ROOT, "kms8b-w8")
    result, _ = harness.run(cell, seed, 0.0, False, "cuda", time.perf_counter(), control=True,
                            log=lambda *a, **k: None)
    assert result["correct"] is False
    assert result["checks"]["mismatched_words"]["value"] > 0
