"""A throwaway copy of the benchmark with one more configuration, traffic mix
and per-layer metric added as files and entries alone: a tiny KMS
block-binary set the CPU runs in seconds."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_BLOCK = dict(d=3, ell=3, alpha=16.0, f=8, log_d=2, big_n=256, beta=4.0, l_gsw=3, log_b_gsw=8,
                  l_lev=2, log_b_lev=8, l_uni=3, log_b_uni=8, k=2)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    config = {"name": "TinyKMSblock", "family": "kms", "engine": "kernels.fused_mx3:bootstrap_mx3",
              "params": TINY_BLOCK}
    (root / "benchmark/configs/TinyKMSblock.json").write_text(json.dumps(config))
    traffic = {"width": 4, "gates": ["NAND", "AND", "OR", "XOR", "XNOR", "NOR"], "parties": "cycle",
               "pool_batches": 2, "check_lanes": 2}
    (root / "benchmark/traffic/tiny.json").write_text(json.dumps(traffic))
    (root / "benchmark/metrics/layers_done.py").write_text("def read(r):\n    return float(len(r.layer_s))\n")
    bench["configs"].append({"name": "TinyKMSblock", "source": "a test set", "file": "benchmark/configs/TinyKMSblock.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny", "config": "TinyKMSblock", "traffic": "tiny", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "layers_done", "unit": "layers", "better": "higher", "source": "host_clock",
                               "layer": "a test", "moves": "gates_per_s", "workloads": ["tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
