"""Time the hand kernels on the card at the widths of the main paths.

Sweeps (B2, B5): for each KMS preset named, one party's sweep at batch 128
with l_lev rows and with 1 row, all steps: `phase1_sweep` on the preset's
keys (block or binary) and, for a binary preset, `mx_sweep` on its mx keys.
`--cggi`: the CGGI step kernel (B3) at preset CGGI, 256 gates, all 630 steps
as one launch and one step.  `--ntt`: the natural NTT kernel (B1), forward
and inverse, at the shapes `bootstrap_mx3`, `bootstrap_mx2` and
`cggi.bootstrap` launch (NTT_SHAPES), and the batch-minor one (B4) at the
shapes the CGGI and KMS batch-minor engines launch (NTT_BM_SHAPES).
`--stages`: for each KMS preset named, also the last merge of phase 2
(`kms._phase2_party_mat` for party k), its hybrid product by itself
(`kernels/hybrid_product.py`) and the key switch (`kms._keyswitch`) at batch 128:
device ms and the device memory each allocates at its peak above its
inputs.  Each kernel is first held bit-exact against its plain
version.  Keys and inputs are uniform residues: the kernels' time does not
depend on them.  The short kernels are timed by their device time in
torch.profiler, found by the instance name the source's dispatcher reports
(`device_ms`).

`--tree DIR` (repeatable) times other checkouts of the repository beside this
one (each package imported from its DIR, its kernels built there), in turns:
this tree, the others, the others backwards, this tree, each in a process of
its own, so that commits can be compared within one call on one card.  Only
the wrappers' signatures, which are the same in every commit, are used;
`--stages` takes trees that have `kernels/hybrid_product.py`.

Usage (one CUDA card):
  python -m mktfhe_tpu_torch.tools.time_sweeps
  python -m mktfhe_tpu_torch.tools.time_sweeps --preset KMS32party --preset KMS16partyblock \
      --tree _probe/parent
  python -m mktfhe_tpu_torch.tools.time_sweeps --cggi --ntt --tree _probe/parent
  python -m mktfhe_tpu_torch.tools.time_sweeps --stages --preset KMS32partyblock
Prints one JSON object per tree and turn, each with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

CHECK_STEPS = 2
BATCH = 128
REPS = 3
PROFILE_TRIES = 4
DEFAULT_PRESETS = ("KMS8partyblock", "KMS8party")
CGGI_BATCH = 256
# [rows, npr, N] of the natural NTT: shapes that bootstrap_mx3 (KMS8partyblock)
# launches at batch 128 (chip_smoke.py phase 6c: the largest, the most
# frequent, the smallest) and that cggi.bootstrap launches at 256 gates
NTT_SHAPES = (
    (8192, 4, 2048), (3072, 4, 2048), (1024, 4, 2048), (768, 4, 2048), (128, 4, 2048),
    (1536, 2, 1024), (512, 2, 1024),
)
# [npr, R, N, G] of the batch-minor NTT: the CGGI engine's digits and outputs
# (bootstrap_bm, 256 gates), and those of kms.bootstrap_bm at KMS8party,
# batch 128, for a party with 3 RLEV rows and for the party with one
NTT_BM_SHAPES = (
    (2, 6, 1024, 256), (2, 2, 1024, 256),
    (3, 24, 2048, 128), (3, 6, 2048, 128), (3, 8, 2048, 128), (3, 2, 2048, 128),
)


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


def _profiler_name(key: str) -> str:
    """A kernel's name as torch.profiler shows it, in the form the
    dispatchers report instances: no spaces, bool template arguments as
    0 / 1 (`ntt_bm_kernel<11, 4, true, false>(...)` -> `ntt_bm_kernel<11,4,1,0>(...)`)."""
    key = re.sub(r"\s+", "", key)
    return re.sub(r"\bfalse\b", "0", re.sub(r"\btrue\b", "1", key))


def device_ms(fn, reps: int, kernel: str) -> float:
    """Mean device time in ms of the kernel `kernel` (an instance name as the
    dispatchers report it, e.g. `ntt_bm_kernel<11,4,1,0>`, or a prefix of one)
    over `reps` calls of fn(), from torch.profiler: the NTT kernels are
    shorter than a launch from Python takes, so CUDA events around the calls
    would time the host.  A profile that recorded no kernel at all (it
    happens now and then: the launches are there, the device activity is
    not, sometimes twice in a row) is taken again, up to PROFILE_TRIES times
    in all; raises if the profiler then shows no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        if attempt:
            time.sleep(0.5)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        rows = [e for e in events if kernel in _profiler_name(e.key)]
        us = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0) for e in rows)
        count = sum(e.count for e in rows)
        if us > 0 and count > 0:
            return us / count / 1e3
        if any(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0) for e in events):
            break  # kernels were recorded, not this one
    raise RuntimeError(f"torch.profiler shows no kernel {kernel}: {[e.key[:80] for e in events]}")


def _residues(gen, shape, prime_axis: int, npr: int, device) -> torch.Tensor:
    """Uniform residues, the primes along `prime_axis`."""
    from mktfhe_tpu_torch.ring.modring import PRIMES

    x = torch.randint(0, 1 << 31, shape, generator=gen, device=device)
    view = [1] * len(shape)
    view[prime_axis] = npr
    p = torch.tensor(PRIMES[:npr], device=device).view(view)
    return torch.remainder(x, p).to(torch.int32)


def time_cggi(device, gen) -> dict:
    """B3 at preset CGGI: all steps as one launch, one step."""
    from mktfhe_tpu_torch.kernels import fused_step
    from mktfhe_tpu_torch.schemes import cggi, kms
    from mktfhe_tpu_torch.schemes.presets import CGGI_PARAM

    params = CGGI_PARAM
    ctx = cggi._ctx(params)
    n, npr, l = ctx.n, ctx.nprimes, params.l_gsw
    brk = _residues(gen, (params.n, npr, 2 * l, 2, n), 1, npr, device)
    mono = kms.monomial_table(ctx, device)
    ta = torch.randint(0, 2 * n, (CGGI_BATCH, params.n), generator=gen, device=device, dtype=torch.int32)
    acc = torch.randint(-(1 << 31), 1 << 31, (CGGI_BATCH, 2, n), generator=gen, device=device, dtype=torch.int32)
    want = acc
    for i in range(CHECK_STEPS):
        want = fused_step.cggi_step_plain(want, brk[i], ta[:, i], mono, params, ctx)
    exact = torch.equal(fused_step.cggi_step(acc, ta, brk, mono, params, ctx, 0, CHECK_STEPS), want)
    return {
        "exact": exact,
        "steps_ms": _ms(lambda: fused_step.cggi_step(acc, ta, brk, mono, params, ctx), REPS),
        "one_step_ms": device_ms(lambda: fused_step.cggi_step(acc, ta, brk, mono, params, ctx, 0, 1), 20,
                                  "cggi_step_kernel"),
    }


def _bm_name(kntt, shape, forward: bool) -> str:
    """The batch-minor instance that serves `shape` ([npr, R, N, G]); a tree
    from before the dispatcher had one kernel a direction."""
    npr, rows, n, gates = shape
    if hasattr(kntt, "bm_kernel"):
        return kntt.bm_kernel(n, npr, rows, gates, forward)["name"]
    return f"ntt_bm_kernel<{int(forward)}>"


def time_ntt(device, gen) -> dict:
    """B1 at NTT_SHAPES and B4 at NTT_BM_SHAPES, forward and inverse."""
    from mktfhe_tpu_torch.kernels import ntt as kntt
    from mktfhe_tpu_torch.ring.ntt import fwd_ntt, inv_ntt, make_plan

    out = {}
    for shape in NTT_SHAPES:
        plan = make_plan(shape[2], shape[1])
        x = _residues(gen, shape, 1, shape[1], device)
        exact = torch.equal(kntt.fwd_ntt_nat(x, plan), fwd_ntt(x, plan))
        exact &= torch.equal(kntt.inv_ntt_nat(x, plan), inv_ntt(x, plan))
        out[f"nat {list(shape)}"] = {
            "exact": exact,
            "fwd_ms": device_ms(lambda: kntt.fwd_ntt_nat(x, plan), 20, kntt.nat_kernel(shape[2], True)["name"]),
            "inv_ms": device_ms(lambda: kntt.inv_ntt_nat(x, plan), 20, kntt.nat_kernel(shape[2], False)["name"]),
        }
    for shape in NTT_BM_SHAPES:
        plan = make_plan(shape[2], shape[0])
        x = _residues(gen, shape, 0, shape[0], device)
        exact = torch.equal(kntt.fwd_ntt_bm(x, plan), kntt.ntt_bm_plain(x, plan, True))
        exact &= torch.equal(kntt.inv_ntt_bm(x, plan), kntt.ntt_bm_plain(x, plan, False))
        out[f"bm {list(shape)}"] = {
            "exact": exact,
            "fwd_ms": device_ms(lambda: kntt.fwd_ntt_bm(x, plan), 50, _bm_name(kntt, shape, True)),
            "inv_ms": device_ms(lambda: kntt.inv_ntt_bm(x, plan), 50, _bm_name(kntt, shape, False)),
            "instances": [_bm_name(kntt, shape, f) for f in (True, False)],
        }
    return out


def _peak(fn) -> int:
    """Bytes fn() allocates on the card at its peak above what was
    allocated when it started."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - held


def time_stages(params, device, gen) -> dict:
    """Phase 2's last merge (party k onto components 0..k-1), its hybrid
    product alone and the key switch at batch BATCH on uniform inputs of
    the preset's shapes: the accumulator over all of 64 bits, lev key, rlk,
    public keys and crs as residues, the key-switching tables as int8 limbs
    (time and memory do not depend on the values)."""
    from mktfhe_tpu_torch.kernels.hybrid_product import hybrid_product
    from mktfhe_tpu_torch.schemes import kms
    from mktfhe_tpu_torch.schemes.common import NLIMB
    from mktfhe_tpu_torch.schemes.params import KmsBlockParams

    ctx = kms._ctx(params)
    npr, n, k = ctx.nprimes, ctx.n, params.k

    def residues(*lead):
        return _residues(gen, (*lead, npr, n), len(lead), npr, device)

    acc = torch.randint(-(1 << 63), (1 << 63) - 1, (BATCH, k + 1, n), generator=gen, device=device)
    acc[:, k] = 0
    levkey = residues(BATCH, params.l_lev, 2)
    rd, rf, crs = residues(params.l_uni), residues(params.l_uni, 2), residues(params.l_uni)
    pub = residues(k - 1, params.l_uni)
    coeffs = n - params.n if isinstance(params, KmsBlockParams) else n
    rows = coeffs * params.f * (1 << params.log_d) // 2
    limbs = dict(generator=gen, device=device, dtype=torch.int8)
    empty = torch.zeros((0,), dtype=torch.int32, device=device)
    scheme = kms.KmsScheme(
        crs_hat=crs, pub_b_hat=pub, brk_hat=empty, rlk_d_hat=residues(k, params.l_uni),
        rlk_f_hat=residues(k, params.l_uni, 2), ksk_b=torch.randint(-128, 128, (k, NLIMB, rows), **limbs),
        ksk_a=torch.randint(-128, 128, (k, NLIMB, rows, params.n), **limbs), mono_hat=empty,
    )

    def merge():
        return kms._phase2_party_mat(acc, levkey, k, rd, rf, pub, crs, params, ctx)

    # the merge's hybrid product by itself, on its components y [G, k, N]
    y = torch.randint(-(1 << 63), (1 << 63) - 1, (BATCH, k, n), generator=gen, device=device)

    def hybrid():
        return hybrid_product(y, rd, pub, crs, params, ctx)

    def keyswitch():
        return kms._keyswitch(acc, scheme, params)

    return {
        "merge_ms": _ms(merge, REPS), "merge_peak_gb": _peak(merge) / 1e9,
        "hybrid_ms": _ms(hybrid, REPS), "hybrid_peak_gb": _peak(hybrid) / 1e9,
        "keyswitch_ms": _ms(keyswitch, REPS), "keyswitch_peak_gb": _peak(keyswitch) / 1e9,
    }


def worker(names, cggi: bool = False, ntt: bool = False, stages: bool = False) -> dict:
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
    if stages:
        out["stages"] = {name: time_stages(ALL_PRESETS[name], device, gen) for name in names}
    if cggi:
        out["cggi_step"] = time_cggi(device, gen)
    if ntt:
        out.update(time_ntt(device, gen))
    if hasattr(_build, "resource_usage"):  # registers and spills of the kernels just run, as ptxas said
        from mktfhe_tpu_torch.kernels import fused_step, ntt as kntt

        sources = [fused_mx3.SOURCE, fused_mx2.SOURCE] if names else []
        sources += [fused_step.SOURCE] if cggi else []
        sources += [kntt.SOURCE] if ntt else []
        out["ptxas"] = {src.stem: _build.resource_usage(_build.build(src)) for src in sources}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", action="append", metavar="NAME",
                    help=f"a KMS preset of schemes/presets.py:ALL_PRESETS (default: {', '.join(DEFAULT_PRESETS)})")
    ap.add_argument("--cggi", action="store_true", help="time the CGGI step kernel")
    ap.add_argument("--ntt", action="store_true", help="time the NTT kernels")
    ap.add_argument("--stages", action="store_true",
                    help="also phase 2's last merge and the key switch of each preset named: ms and peak memory")
    ap.add_argument("--tree", metavar="DIR", action="append", default=[],
                    help="another checkout to time beside this one (repeatable)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_sweeps: needs a CUDA card", file=sys.stderr)
        return 1
    names = ns.preset or ([] if ns.cggi or ns.ntt else list(DEFAULT_PRESETS))
    if ns.worker:
        print(json.dumps(worker(names, ns.cggi, ns.ntt, ns.stages)))
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    here = Path(__file__).resolve().parents[2]
    trees = [here, *(Path(t).resolve() for t in ns.tree)]
    failed = False
    # the worker is this file, whichever tree's package it then imports
    command = [sys.executable, str(Path(__file__).resolve()), "--worker",
               *(a for n in names for a in ("--preset", n)), *(["--cggi"] if ns.cggi else []),
               *(["--ntt"] if ns.ntt else []), *(["--stages"] if ns.stages else [])]
    for tree in trees + trees[::-1] if len(trees) > 1 else trees:
        proc = subprocess.run(command, cwd=tree, env={**os.environ, "PYTHONPATH": str(tree)},
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(json.dumps({"tree": str(tree), "error": proc.stderr[-3000:]}))
            failed = True
            continue
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        failed |= not all(r["exact"] for name, r in res.items() if name not in ("ptxas", "stages"))
        print(json.dumps({"tree": str(tree), "card": smi, **res}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
