"""The harness end to end on the CPU at a tiny set, and the shape of its
result line; a cell, traffic mix and metric that were added as files and
entries alone (conftest.py) run without any edit to the harness."""

import json
import subprocess
import sys
import time

import pytest

from benchmark import harness

SEED = 2**31 + 977


@pytest.fixture(scope="module")
def tiny_cell(tiny_root):
    return harness.load_cell(tiny_root, "tiny")


def _run(cell, **kw):
    return harness.run(cell, SEED, 0.0, kw.pop("trace", False), "cpu", time.perf_counter(),
                       log=lambda *a, **k: None, **kw)


def test_untraced_result_line(tiny_cell):
    result, lines = _run(tiny_cell)
    assert result["correct"] is True
    assert result["attempted"] == 4 and result["failed"] == 0
    assert set(result["metrics"]) == {"gates_per_s", "device_reserved_gb", "setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert list(result)[-1] == "checks"
    assert result["checks"] == {"wrong_bits": {"value": 0, "limit": 0},
                                "mismatched_words": {"value": 0, "limit": 0}}
    assert lines == ["check wrong_bits: 0 (limit 0)", "check mismatched_words: 0 (limit 0)"]
    json.dumps(result)


def test_traced_result_reads_the_added_metric(tiny_cell):
    result, _ = _run(tiny_cell, trace=True)
    assert result["correct"] is True
    # per-layer metrics only; on the CPU the device readers find nothing and stay out
    assert result["metrics"]["layers_done"] == {"value": 1.0, "unit": "layers"}
    assert result["metrics"]["key_setup_s"]["value"] > 0
    assert "gates_per_s" not in result["metrics"]
    assert not {"phase1_ms", "sweep_roofline", "idle_share"} & set(result["metrics"])
    assert result["device"]["window_s"] > 0


def test_command_without_a_card_prints_no_result():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "kms8b-w8", "--seed", str(SEED),
                           "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                          cwd=harness.Path(__file__).resolve().parents[2])
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "needs 1 CUDA card" in proc.stderr
