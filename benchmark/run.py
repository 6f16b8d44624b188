#!/usr/bin/env python3
"""Run one cell of the benchmark of mktfhe_tpu_torch once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for (without them it exits 2 and prints no result).  The cell's
set-up makes the parties' keys on the card from the seed, runs the
package's key set-up and captures the cell's engine as one CUDA graph; the
window then runs the cell's traffic for `--seconds`; the outputs are judged
after it (harness.py).  The last line of standard output is the result, one
JSON object; the last lines of standard error are the numbers compared,
each beside its limit.  `--trace 1` reports the per-layer metrics in place
of the end-to-end ones, from a profiled window, CUDA events and one eager
bootstrap's named ranges.

Caches: the package builds its CUDA libraries into mktfhe_tpu_torch/_build/
inside the checkout; the benchmark points PyTorch's extension, Triton and
CUDA caches at .bench_cache/ in the checkout, so only a checkout's first run
builds.

Adding a cell is data: a traffic mix is a file traffic/<name>.json (width,
gate set, pool batches, lanes of the reference check), a configuration a
file configs/<name>.json (parameters as published, the scheme family whose
reference/<family>.py and adapters/<family>.py serve it, the engine as
"module:function" of the package), a per-layer metric a reader
metrics/<name>.py; each is named by an entry in BENCHMARK.json.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result, lines = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or of the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
                        **result["device"]}
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
