"""Time the two phase-1 sweep kernels on the card, at the widths of KMS presets.

For each preset named, one party's sweep at batch 128 with l_lev rows and
with 1 row, all steps: `phase1_sweep` on the preset's keys (block or binary) and,
for a binary preset, `mx_sweep` on its mx keys.  Each is first held bit-exact
against its plain version over a few steps.  Keys are uniform residues: the
kernels' time does not depend on the key values.

`--tree DIR` times another checkout of the repository beside this one (its
package is imported from DIR, its kernels built there), in turns: this tree,
the other, the other, this tree, each in a process of its own, so that two
commits can be compared within one call on one card.  Only the wrappers'
signatures, which are the same in every commit, are used.

Usage (one CUDA card):
  python -m mktfhe_tpu_torch.tools.time_sweeps
  python -m mktfhe_tpu_torch.tools.time_sweeps --preset KMS32party --preset KMS16partyblock \
      --tree _probe/parent
Prints one JSON object per tree and turn, each with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

CHECK_STEPS = 2
BATCH = 128
REPS = 3
DEFAULT_PRESETS = ("KMS8partyblock", "KMS8party")


def _ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()  # warm-up
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _residues(gen, shape, prime_axis: int, npr: int, device) -> torch.Tensor:
    """Uniform residues, the primes along `prime_axis`."""
    from mktfhe_tpu_torch.ring.modring import PRIMES

    x = torch.randint(0, 1 << 31, shape, generator=gen, device=device)
    view = [1] * len(shape)
    view[prime_axis] = npr
    p = torch.tensor(PRIMES[:npr], device=device).view(view)
    return torch.remainder(x, p).to(torch.int32)


def worker(names) -> dict:
    """Times of the package that this process imports (the first
    `mktfhe_tpu_torch` on its path)."""
    from mktfhe_tpu_torch.kernels import _build, fused_mx2, fused_mx3
    from mktfhe_tpu_torch.ring.context import make_ring_ctx
    from mktfhe_tpu_torch.schemes import kms
    from mktfhe_tpu_torch.schemes.params import KmsBlockParams
    from mktfhe_tpu_torch.schemes.presets import ALL_PRESETS

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(0)
    out = {}

    def tildea(params, n):
        return torch.randint(0, 2 * n, (BATCH, params.n), generator=gen, device=device, dtype=torch.int32)

    for name in names:
        params = ALL_PRESETS[name]
        ctx = kms._ctx(params)
        n, npr, l = ctx.n, ctx.nprimes, params.l_gsw
        block = isinstance(params, KmsBlockParams)
        brk = _residues(gen, (params.n, 2, l, 2, npr, n), 4, npr, device)
        mono = kms.monomial_table(ctx, device) if block else None
        ta = tildea(params, n)
        short = dataclasses.replace(params, **({"d": CHECK_STEPS} if block else {"n": CHECK_STEPS}))
        rows = params.l_lev
        args = (ta[:16, : short.n].contiguous(), brk[: short.n], rows, mono, short, ctx)
        exact = torch.equal(fused_mx3.phase1_sweep(*args), fused_mx3.phase1_sweep_plain(*args))
        out[name] = {
            "N": n, "l_gsw": l, "primes": npr, "rows": rows, "exact": exact,
            "rows_ms": _ms(lambda: fused_mx3.phase1_sweep(ta, brk, rows, mono, params, ctx), REPS),
            "row1_ms": _ms(lambda: fused_mx3.phase1_sweep(ta, brk, 1, mono, params, ctx), REPS),
        }
        del brk, mono
        if block:
            continue
        npr = fused_mx2.mx_nprimes(params)
        ctx_p = make_ring_ctx(params.big_n, params.ring_torus_bits, npr)
        brk_mx = _residues(gen, (params.n, npr, 2 * l, 2, n), 1, npr, device)
        args = (ta[:16, :CHECK_STEPS].contiguous(), brk_mx[:CHECK_STEPS], rows, short, ctx_p)
        exact = torch.equal(fused_mx2.mx_sweep(*args), fused_mx2.mx_sweep_plain(*args))
        out[name + " mx"] = {
            "N": n, "l_gsw": l, "primes": npr, "rows": rows, "exact": exact,
            "rows_ms": _ms(lambda: fused_mx2.mx_sweep(ta, brk_mx, rows, params, ctx_p), REPS),
            "row1_ms": _ms(lambda: fused_mx2.mx_sweep(ta, brk_mx, 1, params, ctx_p), REPS),
        }
        del brk_mx
    if hasattr(_build, "resource_usage"):  # registers and spills of the kernels just run, as ptxas said
        out["ptxas"] = {src.stem: _build.resource_usage(_build.build(src)) for src in (fused_mx3.SOURCE, fused_mx2.SOURCE)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", action="append", metavar="NAME",
                    help=f"a KMS preset of schemes/presets.py:ALL_PRESETS (default: {', '.join(DEFAULT_PRESETS)})")
    ap.add_argument("--tree", metavar="DIR", help="another checkout to time beside this one")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_sweeps: needs a CUDA card", file=sys.stderr)
        return 1
    names = ns.preset or list(DEFAULT_PRESETS)
    if ns.worker:
        print(json.dumps(worker(names)))
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    here = Path(__file__).resolve().parents[2]
    trees = [here] if ns.tree is None else [here, Path(ns.tree).resolve()]
    failed = False
    # the worker is this file, whichever tree's package it then imports
    command = [sys.executable, str(Path(__file__).resolve()), "--worker", *(a for n in names for a in ("--preset", n))]
    for tree in trees + trees[::-1][: 2 * (len(trees) - 1)]:
        proc = subprocess.run(command, cwd=tree, env={**os.environ, "PYTHONPATH": str(tree)},
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(json.dumps({"tree": str(tree), "error": proc.stderr[-3000:]}))
            failed = True
            continue
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        failed |= not all(r["exact"] for name, r in res.items() if name != "ptxas")
        print(json.dumps({"tree": str(tree), "card": smi, **res}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
