"""The `kms_mx2` family (binary keys on the mx engine) found by name and run
end to end on the CPU: a throwaway copy of the benchmark with a tiny binary
configuration of that family and a tiny traffic mix, added as files and
entries alone; the harness loads the family's reference and adapter
through `harness.family` and runs the cell's set-up (`fused_mx2.setup`),
the graphed engine under the gate entry and the checks."""

import json
import shutil
import time
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 4099
TINY_BINARY = dict(n=8, alpha=16.0, f=8, log_d=2, big_n=128, beta=4.0, l_gsw=3, log_b_gsw=8, l_lev=2,
                   log_b_lev=8, l_uni=3, log_b_uni=8, k=2)


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench_mx2")
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = {"name": "TinyKMSmx2", "family": "kms_mx2", "engine": "kernels.fused_mx2:bootstrap_mx2",
              "params": TINY_BINARY}
    (root / "benchmark/configs/TinyKMSmx2.json").write_text(json.dumps(config))
    traffic = {"width": 4, "gates": ["NAND", "AND", "OR", "XOR", "XNOR", "NOR"], "parties": "cycle",
               "pool_batches": 2, "check_lanes": 2}
    (root / "benchmark/traffic/tiny-mx2.json").write_text(json.dumps(traffic))
    bench["configs"].append({"name": "TinyKMSmx2", "source": "a test set", "file": "benchmark/configs/TinyKMSmx2.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-mx2", "config": "TinyKMSmx2", "traffic": "tiny-mx2", "chips": 1,
                               "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return harness.load_cell(root, "tiny-mx2")


def test_family_is_found_by_name(cell):
    from mktfhe_tpu_torch.kernels import fused_mx2

    ref, ad = harness.family(cell)
    assert ref.__name__.endswith("reference.kms_mx2") and ad.__name__.endswith("adapters.kms_mx2")
    assert ad.engine(cell.config["engine"]) is fused_mx2.bootstrap_mx2
    assert ref.KmsSet.from_config(cell.config["params"]).n_bits == TINY_BINARY["n"]


def test_tiny_cell_runs_correct(cell):
    result, lines = harness.run(cell, SEED, 0.0, False, "cpu", time.perf_counter(), log=lambda *a, **k: None)
    assert result["correct"] is True and result["failed"] == 0
    assert result["checks"] == {"wrong_bits": {"value": 0, "limit": 0},
                                "mismatched_words": {"value": 0, "limit": 0}}
    assert set(result["metrics"]) == {"gates_per_s", "device_reserved_gb", "setup_s"}


def test_tiny_cell_traced_reads_the_key_setup(cell):
    result, _ = harness.run(cell, SEED, 0.0, True, "cpu", time.perf_counter(), log=lambda *a, **k: None)
    assert result["correct"] is True
    assert result["metrics"]["key_setup_s"]["value"] > 0
