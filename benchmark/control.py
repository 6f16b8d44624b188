#!/usr/bin/env python3
"""The benchmark's control, on the card at a cell's own size: the plain
reference put in the program's place in the window, its ring products in
float64 (the precision of the scheme's Julia implementation, the step below
the exact 2^64 arithmetic the configuration states), one layer of the
cell's width; then the run's own checks, which must come out not correct.

    python3 benchmark/control.py --workload <name> --seed <n> [--seed <n> ...]

Prints each seed's numbers compared, beside their limits, and a JSON line.
The benchmark's own runs never run it.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    out = []
    for seed in args.seed:
        t0 = time.perf_counter()
        result, lines = harness.run(cell, seed, 0.0, False, "cuda", t0, control=True)
        print(f"control {cell.name} seed {seed}: " + "; ".join(lines) + f" ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        out.append({"seed": seed, "correct": result["correct"], "checks": result["checks"]})
    print(json.dumps({"workload": cell.name, "precision": "f64", "runs": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
