"""The timed path broken underneath comes out not correct, once for each
fault a cell of this benchmark can have; the control (the reference in the
program's place, its ring products in float64) too.  At a tiny set on the
CPU; the control at the cells' own sizes runs on the card
(benchmark/control.py)."""

import time

import pytest

from benchmark import harness

SEED = 3_000_000_019


@pytest.mark.parametrize("fault", ["unchanged", "half", "flip"])
def test_fault_is_not_correct(tiny_root, fault):
    cell = harness.load_cell(tiny_root, "tiny")
    result, _ = harness.run(cell, SEED, 0.0, False, "cpu", time.perf_counter(), fault=fault,
                            log=lambda *a, **k: None)
    assert result["correct"] is False
    assert result["failed"] > 0


def test_decryption_silent_fault_is_not_correct(tiny_root):
    """Words changed without a bit flipped: only the reference sees it."""
    cell = harness.load_cell(tiny_root, "tiny")
    result, _ = harness.run(cell, SEED, 0.0, False, "cpu", time.perf_counter(), fault="words",
                            log=lambda *a, **k: None)
    assert result["correct"] is False
    assert result["checks"]["wrong_bits"]["value"] == 0
    assert result["checks"]["mismatched_words"]["value"] > 0


def test_control_is_not_correct(tiny_root):
    cell = harness.load_cell(tiny_root, "tiny")
    result, _ = harness.run(cell, SEED, 0.0, False, "cpu", time.perf_counter(), control=True,
                            log=lambda *a, **k: None)
    assert result["correct"] is False
    assert result["checks"]["mismatched_words"]["value"] > 0
