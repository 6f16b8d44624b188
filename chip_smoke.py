#!/usr/bin/env python3
"""Drive the PyTorch port (mktfhe_tpu_torch) on one CUDA card, end to end.

Phases, each printing one line; any failure exits non-zero:
  1. require a CUDA card; print `nvidia-smi` name and power limit;
  2. build the CUDA kernels from mktfhe_tpu_torch/csrc/ (nvcc, sm_90a, one
     process per source, started together); the sweep kernels' template
     instances that the main paths run must not spill registers; time the
     sweep kernels' own butterflies on registers alone (a measuring kernel,
     csrc/butterfly_rate.cu), the second yardstick beside their bounds;
  3. hold the NTT kernel against its plain PyTorch version on the card,
     bit-exact, forward and inverse, at the bootstrap's shapes, and time both;
  4. keygen on the card for KMS8partyblock and KMS8party: crs, 8 party
     keygens, setup;
  5. hold the phase-1 sweep kernel against its plain PyTorch version on the
     card, bit-exact, on real keys: block keys at KMS8partyblock width,
     binary keys at KMS8party width, and a small wide-gadget case, each
     through the template instance compiled for its shape (named with its
     threads, shared memory, registers and spills), and small block and
     binary sets through the kernel with run-time shapes; time kernel and
     plain version at the full number of steps;
  6. the main path: `bootstrap_mx3` of a batch of NAND gates on
     KMS8partyblock, decrypt-checked, then a timed data-dependent chain of
     two more (decrypt-checked too); the sweep and NTT kernels must have
     been launched; then one more under torch.profiler for the device time
     by kernel;
  7. the earlier path: one `kms.bootstrap` of the same ciphertext,
     decrypt-checked, whose output must equal `bootstrap_mx3`'s bit for bit;
  8. the binary-key path: one `bootstrap_mx3` on KMS8party, decrypt-checked;
  9. hold the key switch on the card against the same code on the CPU for
     4 gates, bit-exact;
 10. hold the batch-minor NTT kernel against its plain version, bit-exact,
     forward and inverse, at the shapes of the batch-minor CGGI engine and at
     a small ragged batch, and time both;
 11. CGGI keygen on the card (preset CGGI) and the batch-minor key layout;
 12. hold the fused CGGI step kernel against its plain version on real keys
     at 256 gates, bit-exact: a one-step launch against the plain step, a
     short range against as many plain steps; time all 630 steps as one
     launch, as 630 one-step launches and as 630 plain steps;
 13. this slice's main path: `bootstrap_fused` of 256 NAND gates on CGGI,
     decrypt-checked, then a timed data-dependent chain of two more; the
     step kernel must have been launched; then one more under torch.profiler;
 14. the other two CGGI engines on the same ciphertext, `bootstrap_bm` (the
     batch-minor NTT kernel must have been launched) and `cggi.bootstrap`
     (the natural NTT kernel): all three outputs equal bit for bit;
 15. mx-domain keys: `build_mx_kms_keys` on the KMS8party party keys of
     phase 4 (and on the wide-gadget set's);
 16. hold the mx sweep kernel against its plain version on those keys,
     bit-exact, with 3 rows and with 1 row, on the wide-gadget set and the
     six-digit set, each through its template instance, and on a small set
     through the kernel with run-time shapes; time kernel and plain version
     at the full number of steps;
 17. this slice's main path: `bootstrap_mx2` of a batch of NAND gates on
     KMS8party, on a scheme without `brk_hat`, decrypt-checked, then a timed
     data-dependent chain of two more; the mx sweep and NTT kernels must have
     been launched; its output on the ciphertext of phase 8 must equal
     `bootstrap_mx3`'s bit for bit; then one more under torch.profiler;
 18. the KMS batch-minor engine on the same ciphertext: `kms.bootstrap_bm`
     (the batch-minor NTT kernel must have been launched), decrypt-checked,
     bit-identical to `bootstrap_mx2`;
 19. print the kernels' JSON line, then the contract line last.

Usage: python3 chip_smoke.py   (one CUDA card; no arguments)
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from mktfhe_tpu_torch.kernels import _build, batchminor, fused_mx2, fused_mx3, fused_step
from mktfhe_tpu_torch.kernels import ntt as kntt
from mktfhe_tpu_torch.ring.context import make_ring_ctx
from mktfhe_tpu_torch.ring.modring import prime_column
from mktfhe_tpu_torch.ring.ntt import fwd_ntt, inv_ntt, make_plan
from mktfhe_tpu_torch.ring.sampler import uniform_torus
from mktfhe_tpu_torch.schemes import cggi, kms
from mktfhe_tpu_torch.schemes.gates import (
    GATE_IDS,
    gate_affine,
    lwe_decrypt_bit,
    lwe_decrypt_bit_mk,
    lwe_encrypt_bit,
    lwe_ith_encrypt_bit,
)
from mktfhe_tpu_torch.schemes.params import KmsBlockParams, KmsParams
from mktfhe_tpu_torch.schemes.presets import CGGI_PARAM, KMS_8PARTY, KMS_8PARTY_BLOCK, KMS_32PARTY
from mktfhe_tpu_torch.tools import butterfly_rate

BATCH = 128
CHAIN = 2
SEED = 0
# (rows, npr, N): phase-1 digit transforms at G=128 (128 gates x 3 RLEV rows
# x 2 components x 4 digits), the phase-1 inverse (128 x 3 x 2), and a
# small N=64 / 2-prime case at the kernel's lower limits.
NTT_SHAPES = [(3072, 4, 2048), (768, 4, 2048), (5, 2, 64)]
TOLERANCE = 0  # exact integer arithmetic: bit-identical or wrong
CHECK_STEPS = 4  # steps of the sweep / the CGGI step range in the kernel-vs-plain comparisons
CGGI_BATCH = 256
# (npr, R, N, G), gate batch minor: the digit transforms of one batch-minor
# CGGI step at G=256 (2 components x 3 digits), its inverse (2 components),
# a small ragged batch (one short gate tile) at the kernel's lower limits, and
# what kms.bootstrap_bm launches per step at KMS8party, batch 128: the digit
# transforms of 3 RLEV rows and of party 1's single row (rows x 2 components
# x 4 digits) and their inverses (rows x 2).
NTT_BM_SHAPES = [
    (2, 6, 1024, 256), (2, 2, 1024, 256), (2, 3, 64, 5),
    (3, 24, 2048, 128), (3, 6, 2048, 128), (3, 8, 2048, 128), (3, 2, 2048, 128),
]
# a small parameter set with the wide gadget of KMS2party (log_b_gsw = 12)
WIDE_GADGET = KmsParams(
    n=CHECK_STEPS, alpha=16.0, f=8, log_d=2, big_n=256, beta=4.0,
    l_gsw=3, log_b_gsw=12, l_lev=2, log_b_lev=8, l_uni=3, log_b_uni=8, k=2,
)
# KMS32party's gadget (l_gsw = 6) at full N and few steps: with four primes the
# mx sweep's power table no longer fits in shared memory beside the digits and
# is read from device memory (the kernel's other template instance)
SIX_DIGITS = dataclasses.replace(KMS_32PARTY, n=CHECK_STEPS, k=2)
SIX_DIGITS_PRIMES = 4

# small sets of no preset's shape: they run the sweep kernels' instances with
# run-time shapes
RUN_TIME_SHAPES = KmsParams(
    n=CHECK_STEPS, alpha=16.0, f=8, log_d=2, big_n=512, beta=4.0,
    l_gsw=2, log_b_gsw=10, l_lev=2, log_b_lev=8, l_uni=3, log_b_uni=8, k=2,
)
RUN_TIME_SHAPES_BLOCK = KmsBlockParams(
    d=CHECK_STEPS, ell=2, alpha=16.0, f=8, log_d=2, big_n=512, beta=4.0,
    l_gsw=2, log_b_gsw=10, l_lev=2, log_b_lev=8, l_uni=3, log_b_uni=8, k=2,
)

# The card's peaks for the bounds.  Device memory: 3.35 TB/s (H100 SXM data
# sheet).  32-bit integer arithmetic outside the tensor cores: Hopper runs
# it on half of the lanes that give the data sheet's 67 TFLOP/s of float32,
# 64 per SM and clock, so 33.5 T operations/s with a multiply-add counted as
# two, like a float32 FMA.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
# 32-bit integer operations of the arithmetic as csrc/modarith.cuh writes it
# (a multiply and an add count one each; a 64-bit add counts two).  The
# stage-by-stage transforms (ntt.cu, cggi_step.cu) run canonical butterflies
# and a carry-chain decomposition:
OPS_SHOUP_MUL = 6  # mulhi, two mullo, subtract, compare, subtract
OPS_BUTTERFLY = OPS_SHOUP_MUL + 3 + 4  # + add_mod + sub_mod
OPS_PRODUCT_TERM = 4  # 32x32 -> 64 multiply (lo, hi) and a 64-bit add
OPS_BARRETT = 12  # 64x64 high product as eight 32-bit mul/adds, then as Shoup's tail
OPS_DIGIT = 5  # mask, shift, carry add, sign test, lift
# the sweep kernels run lazy butterflies and take each digit from the
# accumulator word plus an offset:
OPS_CT_LAZY = 10  # csub (subtract, min), mulhi, two multiply-adds, 2 u0 + 2p, subtract
OPS_GS_LAZY = 9  # subtract, add, add, csub (subtract, min), mulhi, multiply, multiply-subtract
OPS_CANONICAL = 4  # two csub: [0, 4p) -> [0, p), once per transformed digit
OPS_DIGIT_SOURCE = 8  # per accumulator word and step: 64-bit shift, rounding bit (shift, mask), two 64-bit adds
OPS_LIFTED_DIGIT = 6  # funnel shift, mask, subtract, compare, select, add
NO_LIBRARY_CALL = (
    "library_ms is null for every kernel: no single PyTorch call computes a negacyclic "
    "NTT over CRT primes, a blind rotation or one step of it"
)


def _sync_ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms, by CUDA events around `reps` calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_us(event) -> float:
    """A profiler row's own device time in microseconds (the attribute's name
    differs between PyTorch versions)."""
    return getattr(event, "self_device_time_total", None) or getattr(event, "self_cuda_time_total", 0)


def _kernel_ms(fn, reps: int, kernel: str) -> float:
    """Mean device time in ms of the kernel whose name contains `kernel`, over
    `reps` calls of fn(), from torch.profiler.  For a kernel so short that the
    host cannot enqueue launches as fast as the card runs them, where CUDA
    events around the calls would time the host.  Falls back to the events
    if the profiler shows no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if kernel in e.key and _device_us(e) > 0]
    count = sum(e.count for e in rows)
    if count == 0:
        return _sync_ms(fn, reps)
    return sum(_device_us(e) for e in rows) / count / 1e3


def _max_abs_diff(got: torch.Tensor, want: torch.Tensor) -> int:
    """max |got - want| of two integer tensors (a wrapped int64 difference
    of -2^63 counts as 2^63)."""
    d = (got.long() - want.long()).abs()
    return 1 << 63 if bool((d < 0).any()) else int(d.max())


def _residues(gen, shape, device) -> torch.Tensor:
    """Uniform residues < p_i, int32 [rows, npr, N]."""
    rows, npr, n = shape
    x = torch.randint(0, 1 << 31, shape, generator=gen, device=device)
    return torch.remainder(x, prime_column(npr, device)).to(torch.int32)


def instance_note(kernel: dict, usage: list[str], must_not_spill: bool) -> str:
    """`kernel` (fused_mx3.sweep_kernel / fused_mx2.mx_kernel) with what ptxas
    said of it; fails if an instance of a main path spills."""
    said = [u.split(": ", 1)[1] for u in usage if u.startswith(kernel["name"] + ":")]
    if len(said) != 1:
        raise SystemExit(f"ptxas reported {len(said)} kernels named {kernel['name']}: {usage}")
    if must_not_spill and ", 0 spill bytes" not in said[0]:
        raise SystemExit(f"{kernel['name']} spills registers: {said[0]}")
    return (f"{kernel['name']} ({kernel['threads']} threads, {kernel['shared_bytes']} B dynamic "
            f"shared memory, {said[0]})")


def check_run_time_shapes(gen, device) -> int:
    """The sweep kernels' instances with run-time shapes vs the plain versions
    on small sets of uniform residues (N = 512, two digits), block and binary
    keys and mx keys; returns max |diff|."""
    err = 0
    for params in (RUN_TIME_SHAPES, RUN_TIME_SHAPES_BLOCK):
        ctx = kms._ctx(params)
        n, npr, l = ctx.n, ctx.nprimes, params.l_gsw
        block = isinstance(params, KmsBlockParams)
        brk = _residues(gen, (params.n * 2 * l * 2, npr, n), device).reshape(params.n, 2, l, 2, npr, n)
        mono = kms.monomial_table(ctx, device) if block else None
        tildea = torch.randint(0, 2 * n, (5, params.n), generator=gen, device=device, dtype=torch.int32)
        args = (tildea, brk, params.l_lev, mono, params, ctx)
        if not fused_mx3.sweep_kernel(params, ctx)["run_time_shapes"]:
            raise SystemExit(f"{params} should run the sweep kernel with run-time shapes")
        err = max(err, _max_abs_diff(fused_mx3.phase1_sweep(*args), fused_mx3.phase1_sweep_plain(*args)))
    params = RUN_TIME_SHAPES
    npr, l = fused_mx2.mx_nprimes(params), params.l_gsw
    ctx_p = make_ring_ctx(params.big_n, params.ring_torus_bits, npr)
    n = ctx_p.n
    brk_mx = _residues(gen, (params.n, npr, 2 * l * 2 * n), device).reshape(params.n, npr, 2 * l, 2, n)
    tildea = torch.randint(0, 2 * n, (5, params.n), generator=gen, device=device, dtype=torch.int32)
    args = (tildea, brk_mx, params.l_lev, params, ctx_p)
    if not fused_mx2.mx_kernel(params, ctx_p)["run_time_shapes"]:
        raise SystemExit(f"{params} should run the mx sweep kernel with run-time shapes")
    err = max(err, _max_abs_diff(fused_mx2.mx_sweep(*args), fused_mx2.mx_sweep_plain(*args)))
    torch.cuda.synchronize()
    if err > TOLERANCE:
        raise SystemExit(f"a sweep kernel with run-time shapes disagrees with its plain version: max |diff| {err}")
    return err


def ntt_bound(shape, forward: bool) -> dict:
    """Least time of one transform of [rows, npr, N] u32 on the card: every
    residue read and written once plus the twiddles, against N/2 log2 N
    butterflies per polynomial (and N scalings by 1/N in the inverse)."""
    rows, npr, n = shape
    nbytes = 2 * rows * npr * n * 4 + 2 * npr * n * 4
    ops = rows * npr * (n // 2 * (n.bit_length() - 1) * OPS_BUTTERFLY + (0 if forward else n * OPS_SHOUP_MUL))
    return _bound(nbytes, ops)


def _bound(nbytes: int, ops: int) -> dict:
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def check_ntt(gen, device) -> dict:
    """Kernel vs plain version on the card at NTT_SHAPES; times at the first."""
    err = {"fwd": 0, "inv": 0}
    times = {}
    for shape in NTT_SHAPES:
        plan = make_plan(shape[2], shape[1])
        x = _residues(gen, shape, device)
        fk = kntt.fwd_ntt_nat(x, plan)
        fp = fwd_ntt(x, plan)
        ik = kntt.inv_ntt_nat(fk, plan)
        ip = inv_ntt(fk, plan)
        torch.cuda.synchronize()
        err["fwd"] = max(err["fwd"], _max_abs_diff(fk, fp))
        err["inv"] = max(err["inv"], _max_abs_diff(ik, ip))
        if not torch.equal(ik, x):
            raise SystemExit(f"NTT round trip failed at {shape}")
        if shape == NTT_SHAPES[0]:
            for _ in range(3):  # warm-up
                kntt.fwd_ntt_nat(x, plan)
                kntt.inv_ntt_nat(fk, plan)
                fwd_ntt(x, plan)
                inv_ntt(fk, plan)
            times["fwd"] = (
                _sync_ms(lambda: kntt.fwd_ntt_nat(x, plan), 20),
                _sync_ms(lambda: fwd_ntt(x, plan), 5),
            )
            times["inv"] = (
                _sync_ms(lambda: kntt.inv_ntt_nat(fk, plan), 20),
                _sync_ms(lambda: inv_ntt(fk, plan), 5),
            )
    for d in ("fwd", "inv"):
        if err[d] > TOLERANCE:
            raise SystemExit(f"NTT {d} kernel disagrees with its plain version: max |diff| {err[d]}")
    return {"err": err, "times": times}


def keygen(gen, params):
    """crs, party keygens and setup on the generator's device: the LWE keys,
    the scheme and the party keys (torus domain)."""
    a = kms.crs(gen, params)
    parties = [kms.party_keygen(gen, a, params) for _ in range(params.k)]
    party_keys = [p[3] for p in parties]
    return [p[0] for p in parties], kms.setup(a, party_keys, params), party_keys


def sweep_step_ops(n: int, npr: int, l: int, per_position: int, accumulate: int, lazy: bool) -> int:
    """32-bit integer operations of one step of one (gate, row) of a sweep:
    per prime the 2l digit polynomials and their forward transforms,
    `per_position` operations of the pointwise stage at each of n positions,
    two inverse transforms scaled by 1/N; then per coefficient Garner mod 2^64
    and `accumulate` operations.  `lazy`: the arithmetic the sweep kernels run
    (lazy butterflies, digits from the accumulator word plus an offset, one
    canonical reduction per transformed digit); else the canonical radix-2
    arithmetic of the stage-by-stage transforms, by which the sweeps' bounds
    were counted before their redesign."""
    log_n = n.bit_length() - 1
    if lazy:
        fwd, inv = (n // 2 * log_n * ops for ops in (OPS_CT_LAZY, OPS_GS_LAZY))
        digits = 2 * l * n * (OPS_LIFTED_DIGIT + OPS_CANONICAL)
        sources = 2 * n * OPS_DIGIT_SOURCE
    else:
        fwd = inv = n // 2 * log_n * OPS_BUTTERFLY
        digits = 2 * l * n * OPS_DIGIT
        sources = 0
    per_prime = digits + 2 * l * fwd + n * per_position + 2 * inv + 2 * n * OPS_SHOUP_MUL
    garner = npr * (npr - 1) // 2 * (OPS_SHOUP_MUL + 4 + 2) + (npr - 1) * 8 + 4
    return sources + npr * per_prime + 2 * n * (garner + accumulate)


def sweep_bounds(nbytes: int, units: int, n: int, npr: int, l: int, per_position: int, accumulate: int,
                 rate: dict) -> dict:
    """The bound of a sweep of `units` (gate, row, step) triples: bytes
    against operations of the arithmetic the kernel runs (`bound_ms`); beside
    it the same bound counted in the canonical radix-2 arithmetic
    (`bound_ms_canonical_radix2`, the yardstick of the rows before the
    redesign), and the time that the sweep's butterflies alone take at the
    rate the card reaches on them in registers (`butterflies_only_ms`, from
    csrc/butterfly_rate.cu at the sweeps' occupancy of one CTA per SM)."""
    half_stages = n // 2 * (n.bit_length() - 1)
    return {
        **_bound(nbytes, units * sweep_step_ops(n, npr, l, per_position, accumulate, lazy=True)),
        "bound_ms_canonical_radix2":
            _bound(nbytes, units * sweep_step_ops(n, npr, l, per_position, accumulate, lazy=False))["bound_ms"],
        "butterflies_only_ms": units * npr * half_stages * (
            2 * l / rate["fwd_one_cta"] + 2 / rate["inv_one_cta"]) * 1e3,
    }


def bounds_note(res: dict) -> str:
    return (f"bound {res['bound_ms']:.2f} ms by {res['bound_by']} in the kernel's arithmetic, "
            f"{res['bound_ms_canonical_radix2']:.2f} ms counted in canonical radix-2 arithmetic; its "
            f"butterflies alone in registers {res['butterflies_only_ms']:.2f} ms")


def sweep_bound(params, ctx, g: int, rows: int, tildea: torch.Tensor, rate: dict) -> dict:
    """Least time of one sweep on the card.  Bytes: the accumulator read and
    written, the rotation amounts, the party's key rows, the twiddles, and
    the monomial images that these amounts select, each once.  Operations:
    `sweep_step_ops` with, per position, the members' external products (and
    monomial products); the accumulation is one 64-bit add for block keys and
    the signed roll for binary keys."""
    n, npr, l = ctx.n, ctx.nprimes, params.l_gsw
    block = isinstance(params, KmsBlockParams)
    ell = params.ell if block else 1
    steps = params.n // ell
    nbytes = 2 * g * rows * 2 * n * 8 + tildea.numel() * 4 + params.n * 2 * l * 2 * npr * n * 4 + 4 * npr * n * 4
    if block:
        nbytes += int(torch.unique(tildea).numel()) * npr * n * 4
    member = 2 * (2 * l * OPS_PRODUCT_TERM + OPS_BARRETT) + (2 * (OPS_PRODUCT_TERM + OPS_BARRETT) if block else 0)
    return sweep_bounds(nbytes, g * rows * steps, n, npr, l, ell * member, 2 if block else 8, rate)


def check_sweep(gen, params, scheme, party: int, g: int, rows: int, timed: bool, plain: bool = True,
                rate: dict | None = None) -> dict:
    """The sweep kernel vs its plain version on the card, on `party`'s real
    keys and uniform rotation amounts: bit-exact over CHECK_STEPS steps from
    the LEV gadget rows; then, if `timed`, the kernel (and, if `plain`, the
    plain version) at the full number of steps."""
    device = scheme.crs_hat.device
    ctx = kms._ctx(params)
    block = isinstance(params, KmsBlockParams)
    ell = params.ell if block else 1
    tildea = torch.randint(0, 2 * ctx.n, (g, params.n), generator=gen, device=device, dtype=torch.int32)
    short = dataclasses.replace(params, **({"d": CHECK_STEPS} if block else {"n": CHECK_STEPS}))
    args_short = (tildea[:, : short.n].contiguous(), scheme.brk_hat[party][: short.n], rows, scheme.mono_hat, short, ctx)
    got = fused_mx3.phase1_sweep(*args_short)
    want = fused_mx3.phase1_sweep_plain(*args_short)
    torch.cuda.synchronize()
    err = _max_abs_diff(got, want)
    if err > TOLERANCE or not torch.equal(got, want):
        raise SystemExit(f"sweep kernel disagrees with its plain version ({type(params).__name__}): max |diff| {err}")
    out = {"err": err, "steps": short.n // ell}
    if timed:
        args = (tildea, scheme.brk_hat[party], rows, scheme.mono_hat, params, ctx)
        fused_mx3.phase1_sweep(*args)  # warm-up at the full shape
        out["ms"] = _sync_ms(lambda: fused_mx3.phase1_sweep(*args), 3)
        if plain:
            out["plain_ms"] = _sync_ms(lambda: fused_mx3.phase1_sweep_plain(*args), 1)
        out.update(sweep_bound(params, ctx, g, rows, tildea, rate))
    return out


def gate_inputs(gen, params, lwe_keys, batch: int):
    """NAND inputs: (c1 NAND c2, c2, m1, m2) with party 0's and party 1's bits."""
    device = lwe_keys[0].key.device
    rng = np.random.default_rng(SEED)
    m1 = rng.integers(0, 2, batch).astype(bool)
    m2 = rng.integers(0, 2, batch).astype(bool)
    c2 = lwe_ith_encrypt_bit(gen, torch.from_numpy(m2).to(device), 1, lwe_keys[1], params.alpha, params.k, (batch,))
    c1 = lwe_ith_encrypt_bit(gen, torch.from_numpy(m1).to(device), 0, lwe_keys[0], params.alpha, params.k, (batch,))
    return gate_affine(GATE_IDS["NAND"], c1, c2), c2, m1, m2


def checked_bootstrap(bootstrap, ct, want, scheme, params, decrypt, what: str):
    """One bootstrap, its output decrypt-checked against the clear bits
    (`decrypt`: Lwe -> bits, with the secret keys bound)."""
    out = bootstrap(ct, scheme, params)
    got = decrypt(out).cpu().numpy()
    if not np.array_equal(got, want):
        raise SystemExit(f"{what} decrypt mismatch: {int((got != want).sum())} of {len(want)} gates")
    return out


def bootstrap_chain(bootstrap, ct, c2, m1, m2, params, decrypt, scheme, chain: int) -> dict:
    """NAND bootstrap of a batch, decrypt-checked, then a timed chain of
    `chain` dependent bootstraps, decrypt-checked."""
    nand = GATE_IDS["NAND"]
    want = ~(m1 & m2)
    t0 = time.time()
    first = out = checked_bootstrap(bootstrap, ct, want, scheme, params, decrypt, "bootstrap")
    first_s = time.time() - t0
    t0 = time.time()
    for _ in range(chain):
        out = bootstrap(gate_affine(nand, out, c2), scheme, params)
        want = ~(want & m2)
    out.b.cpu()  # a hard device -> host read ends the timed chain
    dt = (time.time() - t0) / chain
    got = decrypt(out).cpu().numpy()
    if not np.array_equal(got, want):
        raise SystemExit(f"chain decrypt mismatch: {int((got != want).sum())} of {len(want)} gates")
    return {"first_s": first_s, "batch_s": dt, "first": first}


def profile_bootstrap(bootstrap, ct, scheme, params, parts: dict, top: int = 6) -> dict:
    """Device time by kernel over one warm `bootstrap` (torch.profiler):
    `parts` names the hand kernels (label -> substring of the kernel's
    name); then everything else, and the wall."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()  # inside the context: the profiler's own start-up is not the bootstrap's
        bootstrap(ct, scheme, params).b.cpu()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3

    # kernel rows only: the operator rows carry their kernels' time a second time
    on_device = torch.autograd.DeviceType.CUDA
    rows = sorted(
        ((_device_us(e) / 1e3, e.count, e.key) for e in prof.key_averages()
         if e.device_type == on_device and _device_us(e) > 0),
        reverse=True,
    )
    return {
        "wall_ms": wall_ms,
        "device_ms": sum(ms for ms, _, _ in rows),
        "parts": {label: sum(ms for ms, _, key in rows if name in key) for label, name in parts.items()},
        "top": [f"{key[:60]} {ms:.2f} ms x{count}" for ms, count, key in rows[:top]],
    }


def profile_line(tag: str, what: str, prof: dict, smi: str) -> str:
    if prof["device_ms"] == 0:
        return f"[{tag}] torch.profiler recorded no device time"
    rest = prof["device_ms"] - sum(prof["parts"].values())
    parts = ", ".join(f"{label} {ms:.2f} ms" for label, ms in prof["parts"].items())
    return (
        f"[{tag}] one warm {what} under torch.profiler: wall {prof['wall_ms']:.1f} ms, "
        f"device busy {prof['device_ms']:.1f} ms (idle share "
        f"{max(0.0, 1 - prof['device_ms'] / prof['wall_ms']):.3f}); {parts}, everything else "
        f"{rest:.1f} ms; largest: " + "; ".join(prof["top"]) + f" ({smi})"
    )


def read_launches() -> dict:
    return {
        "fwd": kntt.fwd_ntt_nat.launches,
        "inv": kntt.inv_ntt_nat.launches,
        "sweep": fused_mx3.phase1_sweep.launches,
        "fwd_bm": kntt.fwd_ntt_bm.launches,
        "inv_bm": kntt.inv_ntt_bm.launches,
        "step": fused_step.cggi_step.launches,
        "mx": fused_mx2.mx_sweep.launches,
    }


def reset_launches() -> None:
    kntt.reset_launches()
    fused_mx3.reset_launches()
    fused_step.reset_launches()
    fused_mx2.reset_launches()


def check_keyswitch(gen, params, scheme, gates: int = 4) -> None:
    """The key switch on the scheme's device vs the same code on the CPU."""
    ctx = kms._ctx(params)
    acc = uniform_torus(gen, (gates, params.k + 1, params.big_n), ctx.dtype)
    got = kms._keyswitch(acc, scheme, params)
    cpu_scheme = dataclasses.replace(scheme, ksk_b=scheme.ksk_b.cpu(), ksk_a=scheme.ksk_a.cpu())
    want = kms._keyswitch(acc.cpu(), cpu_scheme, params)
    if not (torch.equal(got.b.cpu(), want.b) and torch.equal(got.a.cpu(), want.a)):
        raise SystemExit("key switch on the card differs from the CPU")


def check_ntt_bm(gen, device) -> dict:
    """Batch-minor kernel vs plain version on the card at NTT_BM_SHAPES; the
    forward timed at the first shape, the inverse at the second: the kernel's
    device time, the plain version, and the wrapper's call as the host
    enqueues it (the kernel is shorter than a launch from Python)."""
    err = {"fwd": 0, "inv": 0}
    times = {}
    for shape in NTT_BM_SHAPES:
        npr, _, n, _ = shape
        plan = make_plan(n, npr)
        x = torch.randint(0, 1 << 31, shape, generator=gen, device=device)
        x = torch.remainder(x, prime_column(npr, device)[:, :, None, None]).to(torch.int32)
        fk = kntt.fwd_ntt_bm(x, plan)
        ik = kntt.inv_ntt_bm(fk, plan)
        torch.cuda.synchronize()
        err["fwd"] = max(err["fwd"], _max_abs_diff(fk, kntt.ntt_bm_plain(x, plan, True)))
        err["inv"] = max(err["inv"], _max_abs_diff(ik, kntt.ntt_bm_plain(fk, plan, False)))
        if not torch.equal(ik, x):
            raise SystemExit(f"batch-minor NTT round trip failed at {shape}")
        for d, timed_at, forward, wrapper, kernel in (
            ("fwd", NTT_BM_SHAPES[0], True, kntt.fwd_ntt_bm, "ntt_bm_kernel<true>"),
            ("inv", NTT_BM_SHAPES[1], False, kntt.inv_ntt_bm, "ntt_bm_kernel<false>"),
        ):
            if shape == timed_at:
                for _ in range(3):  # warm-up
                    wrapper(x, plan)
                    kntt.ntt_bm_plain(x, plan, forward)
                times[d] = (
                    _kernel_ms(lambda: wrapper(x, plan), 50, kernel),
                    _sync_ms(lambda: kntt.ntt_bm_plain(x, plan, forward), 5),
                    _sync_ms(lambda: wrapper(x, plan), 50),
                )
    for d in ("fwd", "inv"):
        if err[d] > TOLERANCE:
            raise SystemExit(f"batch-minor NTT {d} kernel disagrees with its plain version: max |diff| {err[d]}")
    return {"err": err, "times": times}


def ntt_bm_bound(shape, forward: bool) -> dict:
    """As ntt_bound: a batch-minor tensor [npr, R, N, G] holds R * G
    polynomials per prime."""
    npr, r, n, g = shape
    return ntt_bound((r * g, npr, n), forward)


def step_bound(params, ctx, g: int, steps: int, tildea: torch.Tensor) -> dict:
    """Least time of `steps` CGGI steps on `g` gates on the card.  Bytes: the
    accumulator read and written, the rotation amounts, the steps' key rows,
    the twiddles, and the monomial images that these amounts select, each
    once.  Operations: per (gate, step) and prime the digits, 2l forward
    transforms, the external product and the monomial product, two inverse
    transforms; then Garner mod 2^32 and the accumulation per coefficient."""
    n, npr, l = ctx.n, ctx.nprimes, params.l_gsw
    log_n = n.bit_length() - 1
    nbytes = (2 * g * 2 * n * 4 + g * steps * 4 + steps * npr * 2 * l * 2 * n * 4 + 4 * npr * n * 4
              + int(torch.unique(tildea[:, :steps]).numel()) * npr * n * 4)
    ntt_ops = n // 2 * log_n * OPS_BUTTERFLY
    product = 2 * (2 * l * OPS_PRODUCT_TERM + OPS_BARRETT) + 2 * (OPS_PRODUCT_TERM + OPS_BARRETT)
    per_prime = 2 * n * l * OPS_DIGIT + 2 * l * ntt_ops + n * product + 2 * ntt_ops + 2 * n * OPS_SHOUP_MUL
    garner = npr * (npr - 1) // 2 * (OPS_SHOUP_MUL + 4 + 2) + (npr - 1) * 2 + 2
    per_step = npr * per_prime + 2 * n * (garner + 1)
    return _bound(nbytes, g * steps * per_step)


def check_step(gen, params, bm, g: int) -> dict:
    """The CGGI step kernel vs its plain version on the card, on real keys,
    uniform rotation amounts and accumulators over all of 32 bits: a one-step
    launch against the plain step, a range of CHECK_STEPS against as many
    plain steps; then all steps timed as one launch, as one launch per step,
    and as plain steps (the three must agree bit for bit)."""
    device = bm.brk_bm.device
    ctx = cggi._ctx(params)
    tildea = torch.randint(0, 2 * ctx.n, (g, params.n), generator=gen, device=device, dtype=torch.int32)
    acc = torch.randint(-(1 << 31), 1 << 31, (g, 2, ctx.n), generator=gen, device=device, dtype=torch.int32)
    keys = (bm.brk_bm, bm.mono_hat, params, ctx)

    def plain(a, i0, i1):
        for i in range(i0, i1):
            a = fused_step.cggi_step_plain(a, bm.brk_bm[i], tildea[:, i], bm.mono_hat, params, ctx)
        return a

    def one_by_one(a):
        for i in range(params.n):
            a = fused_step.cggi_step(a, tildea, *keys, i, i + 1)
        return a

    err = 0
    last = params.n - CHECK_STEPS
    for i0, i1 in ((0, 1), (last, params.n)):
        got = fused_step.cggi_step(acc, tildea, *keys, i0, i1)
        want = plain(acc, i0, i1)
        torch.cuda.synchronize()
        err = max(err, _max_abs_diff(got, want))
        if err > TOLERANCE or not torch.equal(got, want):
            raise SystemExit(f"CGGI step kernel disagrees with its plain version over steps [{i0}, {i1}): max |diff| {err}")
    whole = fused_step.cggi_step(acc, tildea, *keys)  # warm-up at the full range
    out = {
        "err": err,
        "ms": _sync_ms(lambda: fused_step.cggi_step(acc, tildea, *keys), 5),
        "stepwise_ms": _sync_ms(lambda: one_by_one(acc), 2),
        "one_step_ms": _kernel_ms(lambda: fused_step.cggi_step(acc, tildea, *keys, 0, 1), 20, "cggi_step_kernel"),
        "plain_ms": _sync_ms(lambda: plain(acc, 0, params.n), 1),
        "plain_step_ms": _sync_ms(lambda: plain(acc, 0, 1), 5),
        "one_step_bound_ms": step_bound(params, ctx, g, 1, tildea)["bound_ms"],
        **step_bound(params, ctx, g, params.n, tildea),
    }
    if not (torch.equal(whole, one_by_one(acc)) and torch.equal(whole, plain(acc, 0, params.n))):
        raise SystemExit("CGGI step kernel: one launch, one launch per step and the plain steps differ over all steps")
    return out


def cggi_gate_inputs(gen, params, lwe_key, batch: int):
    """Single-key NAND inputs: (c1 NAND c2, c2, m1, m2)."""
    device = lwe_key.key.device
    rng = np.random.default_rng(SEED + 1)
    m1 = rng.integers(0, 2, batch).astype(bool)
    m2 = rng.integers(0, 2, batch).astype(bool)
    c1 = lwe_encrypt_bit(gen, torch.from_numpy(m1).to(device), lwe_key, params.alpha, (batch,))
    c2 = lwe_encrypt_bit(gen, torch.from_numpy(m2).to(device), lwe_key, params.alpha, (batch,))
    return gate_affine(GATE_IDS["NAND"], c1, c2), c2, m1, m2


def mx_sweep_bound(params, ctx_p, g: int, rows: int, tildea: torch.Tensor, rate: dict) -> dict:
    """Least time of one mx sweep on the card, as `sweep_bound` for binary
    keys, with the monomial formed from the power table: per position, prime
    and output component one more 64-bit product and Barrett step, plus the
    table index and the subtraction of 1.  Bytes: the accumulator read and
    written, the rotation amounts, the party's key rows, the twiddles and the
    power table, each once.  (The kernel itself reads the keys once per wave
    of CTAs: one CTA fills an SM, the waves run one after the other, and a
    party's keys exceed the L2 cache.  That is its cost, not the function's.)"""
    n, npr, l = ctx_p.n, ctx_p.nprimes, params.l_gsw
    nbytes = (2 * g * rows * 2 * n * 8 + tildea.numel() * 4 + params.n * 2 * l * 2 * npr * n * 4
              + 4 * npr * n * 4 + 2 * n * npr * 4)
    position = 2 * (2 * l * OPS_PRODUCT_TERM + OPS_BARRETT) + 2 * (OPS_PRODUCT_TERM + OPS_BARRETT) + 8
    return sweep_bounds(nbytes, g * rows * params.n, n, npr, l, position, 2, rate)


def check_mx_sweep(gen, params, brk_mx_p, g: int, rows: int) -> tuple[int, tuple]:
    """The mx sweep kernel vs its plain version on the card, on one party's
    real mx keys and uniform rotation amounts, bit-exact over CHECK_STEPS
    steps from the LEV gadget rows.  Returns max |diff| and the sweep's
    arguments at the full number of steps."""
    device = brk_mx_p.device
    ctx_p = make_ring_ctx(params.big_n, params.ring_torus_bits, brk_mx_p.shape[1])
    tildea = torch.randint(0, 2 * ctx_p.n, (g, params.n), generator=gen, device=device, dtype=torch.int32)
    short = dataclasses.replace(params, n=CHECK_STEPS)
    args = (tildea[:, :CHECK_STEPS].contiguous(), brk_mx_p[:CHECK_STEPS], rows, short, ctx_p)
    got = fused_mx2.mx_sweep(*args)
    want = fused_mx2.mx_sweep_plain(*args)
    torch.cuda.synchronize()
    err = _max_abs_diff(got, want)
    if err > TOLERANCE or not torch.equal(got, want):
        raise SystemExit(f"mx sweep kernel disagrees with its plain version (rows={rows}, "
                         f"log_b_gsw={params.log_b_gsw}): max |diff| {err}")
    return err, (tildea, brk_mx_p, rows, params, ctx_p)


def run_mx2(gen, smi: str, binary: dict, usage: list[str], rate: dict) -> list[dict]:
    """Phases 15-18: the KMS path on mx-domain keys with its kernel, and the
    KMS batch-minor engine; returns the mx sweep's row of the kernels line."""
    params = KMS_8PARTY
    lwe_keys, party_keys = binary["lwe_keys"], binary["party_keys"]
    # 15. mx-domain keys
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.time()
    mx_keys = fused_mx2.build_mx_kms_keys(party_keys, params)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    wide_keys = fused_mx2.build_mx_kms_keys(binary["wide_party_keys"], WIDE_GADGET)
    crs = kms.crs(gen, SIX_DIGITS)
    six_keys = fused_mx2.build_mx_kms_keys(
        [kms.party_keygen(gen, crs, SIX_DIGITS)[3] for _ in range(SIX_DIGITS.k)], SIX_DIGITS, SIX_DIGITS_PRIMES,
    )
    print(
        f"[15 mx keys] build_mx_kms_keys on the KMS8party party keys: brk_mx "
        f"{list(mx_keys.brk_mx.shape)} int32 = {mx_keys.brk_mx.numel() * 4 / 1e9:.2f} GB, "
        f"{mx_keys.brk_mx.shape[2]} primes, in {build_s:.2f} s; peak allocated above what was held "
        f"before {(torch.cuda.max_memory_allocated() - before) / 1e9:.2f} GB; the wide-gadget set: "
        f"{wide_keys.brk_mx.shape[2]} primes; the six-digit set (N={SIX_DIGITS.big_n}, l_gsw="
        f"{SIX_DIGITS.l_gsw}, {SIX_DIGITS.n} steps): {six_keys.brk_mx.shape[2]} primes ({smi})"
    )

    # 16. mx sweep kernel vs plain version
    err3, args3 = check_mx_sweep(gen, params, mx_keys.brk_mx[1], BATCH, params.l_lev)
    err1, args1 = check_mx_sweep(gen, params, mx_keys.brk_mx[0], BATCH, 1)
    err_wide, _ = check_mx_sweep(gen, WIDE_GADGET, wide_keys.brk_mx[1], 5, WIDE_GADGET.l_lev)
    err_six, _ = check_mx_sweep(gen, SIX_DIGITS, six_keys.brk_mx[1], 5, SIX_DIGITS.l_lev)
    for args in (args3, args1):  # warm-up at the full shapes
        fused_mx2.mx_sweep(*args)
    rows3 = {
        "err": max(err3, err1, err_wide, err_six),
        "ms": _sync_ms(lambda: fused_mx2.mx_sweep(*args3), 3),
        "plain_ms": _sync_ms(lambda: fused_mx2.mx_sweep_plain(*args3), 1),
        **mx_sweep_bound(params, args3[4], BATCH, params.l_lev, args3[0], rate),
    }
    row1_ms = _sync_ms(lambda: fused_mx2.mx_sweep(*args1), 3)
    notes = [
        instance_note(
            fused_mx2.mx_kernel(p, make_ring_ctx(p.big_n, p.ring_torus_bits, keys.brk_mx.shape[2])),
            usage, must_not_spill=p is params,
        )
        for p, keys in ((params, mx_keys), (WIDE_GADGET, wide_keys), (SIX_DIGITS, six_keys))
    ]
    print(
        f"[16 mx sweep] bit-exact vs plain version (tolerance {TOLERANCE}) over {CHECK_STEPS} steps on "
        f"real mx keys: KMS8party width at G={BATCH} with rows=3 and rows=1 through {notes[0]}, wide gadget "
        f"(N={WIDE_GADGET.big_n}, log_b_gsw={WIDE_GADGET.log_b_gsw}, {wide_keys.brk_mx.shape[2]} primes) "
        f"through {notes[1]}, six digits with the power table in device memory (N={SIX_DIGITS.big_n}, "
        f"l_gsw={SIX_DIGITS.l_gsw}, {six_keys.brk_mx.shape[2]} primes, G=5) through {notes[2]}; the "
        f"kernel with run-time shapes: phase 5; "
        f"one party's sweep, G={BATCH}, {params.n} steps: rows=3 kernel {rows3['ms']:.2f} ms vs plain "
        f"{rows3['plain_ms']:.1f} ms ({bounds_note(rows3)}), "
        f"rows=1 kernel {row1_ms:.2f} ms; the torus-roll sweep "
        f"of phase 5 on the same card, same steps: {binary['sweep_ms']:.2f} ms ({smi})"
    )
    del wide_keys, six_keys

    # 17. this slice's main path, on a scheme without brk_hat: counts reset
    # just before it, read just after
    lean = kms.drop_brk(binary["scheme"])

    def decrypt(out):
        return lwe_decrypt_bit_mk(out, lwe_keys)

    def bootstrap_mx2(ct, scheme, params):
        return fused_mx2.bootstrap_mx2(ct, scheme, mx_keys, params)

    ct, c2, m1, m2 = binary["ct"], binary["c2"], binary["m1"], binary["m2"]
    torch.cuda.synchronize()
    reset_launches()
    boot = bootstrap_chain(bootstrap_mx2, ct, c2, m1, m2, params, decrypt, lean, CHAIN)
    launches = read_launches()
    if min(launches[k] for k in ("mx", "fwd", "inv")) == 0 or launches["sweep"] != 0:
        raise SystemExit(f"bootstrap_mx2 did not run on the mx sweep and NTT kernels alone: {launches}")
    same = all(torch.equal(x, y) for x, y in ((boot["first"].b, binary["mx3_out"].b), (boot["first"].a, binary["mx3_out"].a)))
    if not same:
        raise SystemExit("bootstrap_mx2 and bootstrap_mx3 differ on the same ciphertext")
    dt = boot["batch_s"]
    print(
        f"[17 bootstrap_mx2] KMS8party NAND batch {BATCH}, scheme without brk_hat: decrypt OK "
        f"x{1 + CHAIN}, output bit-identical to bootstrap_mx3 on the ciphertext of phase 8 (b and a); "
        f"first {boot['first_s'] * 1e3:.1f} ms; chain {dt * 1e3:.1f} ms/batch = {BATCH / dt:.2f} boots/s; "
        f"launches in {1 + CHAIN} bootstraps: mx sweep {launches['mx']}, NTT fwd {launches['fwd']} "
        f"inv {launches['inv']} ({smi})"
    )
    prof = profile_bootstrap(
        bootstrap_mx2, ct, lean, params,
        {"mx sweep kernel": "mx_sweep_kernel", "NTT kernels": "ntt_nat_kernel"},
    )
    print(profile_line("17b profile", "bootstrap_mx2", prof, smi))

    # 18. the KMS batch-minor engine on the same ciphertext: same bits
    t0 = time.time()
    bm_keys = batchminor.build_bm_kms_phase1(party_keys, params)
    torch.cuda.synchronize()
    bm_build_s = time.time() - t0

    def bootstrap_bm(ct, scheme, params):
        return kms.bootstrap_bm(ct, scheme, bm_keys, params)

    reset_launches()
    t0 = time.time()
    out = checked_bootstrap(bootstrap_bm, ct, ~(m1 & m2), lean, params, decrypt, "kms.bootstrap_bm")
    bm_s = time.time() - t0
    bm_launches = read_launches()
    if bm_launches["fwd_bm"] == 0 or bm_launches["inv_bm"] == 0:
        raise SystemExit(f"kms.bootstrap_bm did not launch the batch-minor NTT kernels: {bm_launches}")
    if not (torch.equal(out.b, boot["first"].b) and torch.equal(out.a, boot["first"].a)):
        raise SystemExit("kms.bootstrap_bm and bootstrap_mx2 differ on the same ciphertext")
    print(
        f"[18 kms.bootstrap_bm] same ciphertext, batch {BATCH}, scheme without brk_hat: decrypt OK, "
        f"output bit-identical to bootstrap_mx2 (b and a); build_bm_kms_phase1 {bm_build_s:.2f} s "
        f"({bm_keys.brk_bm.shape[2]} primes); one bootstrap {bm_s:.2f} s (host clock to the decrypted "
        f"bits, no warm-up); batch-minor NTT launches fwd {bm_launches['fwd_bm']} inv "
        f"{bm_launches['inv_bm']}, natural NTT fwd {bm_launches['fwd']} inv {bm_launches['inv']} ({smi})"
    )

    return [kernel_row(
        "mx_sweep_binary", "mx_sweep.cu", "mktfhe_tpu/kernels/fused_mx2.py:217", launches["mx"],
        rows3["err"], rows3["ms"], rows3["plain_ms"], rows3,
    )]


def kernel_row(name, source, replaces, launches, err, ms, plain_ms, bound) -> dict:
    """One kernel's entry of the kernels line; a sweep's carries its two
    further yardsticks (`sweep_bounds`) beside the keys every kernel has."""
    extra = {k: bound[k] for k in ("bound_ms_canonical_radix2", "butterflies_only_ms") if k in bound}
    return {
        "name": name,
        "route": "cuda",
        "source": f"mktfhe_tpu_torch/csrc/{source}",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"],
        "library_ms": None,
        **extra,
    }


def run_kms(gen, device, smi: str, usage: list[str], rate: dict) -> tuple[list[dict], dict]:
    """Phases 3-9: the KMS paths and their kernels; returns their rows of
    the kernels line, and the KMS8party keys, ciphertext and `bootstrap_mx3`
    output that the later phases go on from."""
    # 3. NTT kernel vs plain version
    ntt = check_ntt(gen, device)
    (kf, pf), (ki, pi) = ntt["times"]["fwd"], ntt["times"]["inv"]
    print(
        f"[3 ntt] bit-exact vs plain version at {NTT_SHAPES} (tolerance {TOLERANCE}); "
        f"at {list(NTT_SHAPES[0])}: fwd kernel {kf:.4f} ms vs plain {pf:.3f} ms, "
        f"inv kernel {ki:.4f} ms vs plain {pi:.3f} ms ({smi})"
    )

    # 4. keygen
    params = KMS_8PARTY_BLOCK
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    lwe_keys, scheme, _ = keygen(gen, params)
    torch.cuda.synchronize()
    block_s = time.time() - t0
    t0 = time.time()
    bin_keys, bin_scheme, bin_party_keys = keygen(gen, KMS_8PARTY)
    _, wide_scheme, wide_party_keys = keygen(gen, WIDE_GADGET)
    torch.cuda.synchronize()
    print(
        f"[4 keygen] KMS8partyblock (k={params.k}, n={params.n}, N={params.big_n}, "
        f"npr={params.ring_nprimes}): {block_s:.2f} s; KMS8party (n={KMS_8PARTY.n}, "
        f"npr={KMS_8PARTY.ring_nprimes}) and the wide-gadget set: {time.time() - t0:.2f} s; "
        f"peak allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({smi})"
    )

    # 5. sweep kernel vs plain version
    sweep_block = check_sweep(gen, params, scheme, 1, BATCH, params.l_lev, timed=True, rate=rate)
    sweep_bin = check_sweep(gen, KMS_8PARTY, bin_scheme, 1, BATCH, KMS_8PARTY.l_lev, timed=True, rate=rate)
    sweep_block1 = check_sweep(gen, params, scheme, 0, BATCH, 1, timed=True, plain=False, rate=rate)
    sweep_bin1 = check_sweep(gen, KMS_8PARTY, bin_scheme, 0, BATCH, 1, timed=True, plain=False, rate=rate)
    sweep_wide = check_sweep(gen, WIDE_GADGET, wide_scheme, 1, 5, WIDE_GADGET.l_lev, timed=False)
    err_run_time = check_run_time_shapes(gen, device)
    notes = [
        instance_note(fused_mx3.sweep_kernel(p, kms._ctx(p)), usage, must_not_spill=p is not WIDE_GADGET)
        for p in (params, KMS_8PARTY, WIDE_GADGET)
    ]
    print(
        f"[5 sweep] bit-exact vs plain version (tolerance {TOLERANCE}) over {CHECK_STEPS} steps: "
        f"block keys at KMS8partyblock width through {notes[0]}, binary keys at KMS8party width "
        f"through {notes[1]} (G={BATCH}, rows=3 and rows=1), wide gadget (N={WIDE_GADGET.big_n}, "
        f"log_b_gsw={WIDE_GADGET.log_b_gsw}) through {notes[2]}, and block, binary and mx keys at "
        f"N={RUN_TIME_SHAPES.big_n}, l_gsw={RUN_TIME_SHAPES.l_gsw} through the kernels with run-time "
        f"shapes (max |diff| {err_run_time}); one party's sweep, G={BATCH}: block, {params.d} steps: "
        f"rows=3 kernel {sweep_block['ms']:.2f} ms vs plain {sweep_block['plain_ms']:.1f} ms "
        f"({bounds_note(sweep_block)}), rows=1 kernel "
        f"{sweep_block1['ms']:.2f} ms; binary, {KMS_8PARTY.n} steps: rows=3 kernel "
        f"{sweep_bin['ms']:.2f} ms vs plain {sweep_bin['plain_ms']:.1f} ms "
        f"({bounds_note(sweep_bin)}), rows=1 kernel "
        f"{sweep_bin1['ms']:.2f} ms ({smi})"
    )
    del wide_scheme

    # 6. the KMS main path: counts reset just before it, read just after
    def decrypt(out):
        return lwe_decrypt_bit_mk(out, lwe_keys)

    ct, c2, m1, m2 = gate_inputs(gen, params, lwe_keys, BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    boot = bootstrap_chain(fused_mx3.bootstrap_mx3, ct, c2, m1, m2, params, decrypt, scheme, CHAIN)
    launches = read_launches()
    if min(launches[k] for k in ("sweep", "fwd", "inv")) == 0:
        raise SystemExit(f"bootstrap_mx3 did not launch every kernel of its path: {launches}")
    dt = boot["batch_s"]
    print(
        f"[6 bootstrap_mx3] KMS8partyblock NAND batch {BATCH}: decrypt OK x{1 + CHAIN}; first "
        f"{boot['first_s']:.2f} s; chain {dt * 1e3:.1f} ms/batch = {BATCH / dt:.2f} boots/s; "
        f"peak allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches in "
        f"{1 + CHAIN} bootstraps: sweep {launches['sweep']}, NTT fwd {launches['fwd']} "
        f"inv {launches['inv']} ({smi})"
    )
    prof = profile_bootstrap(
        fused_mx3.bootstrap_mx3, ct, scheme, params,
        {"sweep kernel": "phase1_sweep_kernel", "NTT kernels": "ntt_nat_kernel"},
    )
    print(profile_line("6b profile", "bootstrap_mx3", prof, smi))

    # 7. the earlier path, once, on the same ciphertext: same bits
    reset_launches()
    t0 = time.time()
    ref = checked_bootstrap(kms.bootstrap, ct, ~(m1 & m2), scheme, params, decrypt, "kms.bootstrap")
    ref_s = time.time() - t0
    ref_launches = read_launches()
    if ref_launches["fwd"] == 0 or ref_launches["inv"] == 0:
        raise SystemExit(f"kms.bootstrap did not launch the NTT kernels: {ref_launches}")
    if not (torch.equal(ref.b, boot["first"].b) and torch.equal(ref.a, boot["first"].a)):
        raise SystemExit("bootstrap_mx3 and kms.bootstrap differ on the same ciphertext")
    print(
        f"[7 kms.bootstrap] same ciphertext: decrypt OK, output bit-identical to bootstrap_mx3 "
        f"(b and a); {ref_s:.2f} s incl. warm-up; NTT launches fwd {ref_launches['fwd']} "
        f"inv {ref_launches['inv']}, sweep {ref_launches['sweep']} ({smi})"
    )

    # 8. the binary-key path
    bct, bc2, bm1, bm2 = gate_inputs(gen, KMS_8PARTY, bin_keys, BATCH)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    mx3_out = checked_bootstrap(
        fused_mx3.bootstrap_mx3, bct, ~(bm1 & bm2), bin_scheme, KMS_8PARTY,
        lambda out: lwe_decrypt_bit_mk(out, bin_keys), "KMS8party bootstrap_mx3",
    )
    bin_s = time.time() - t0
    bin_launches = read_launches()
    if min(bin_launches[k] for k in ("sweep", "fwd", "inv")) == 0:
        raise SystemExit(f"KMS8party bootstrap_mx3 did not launch every kernel of its path: {bin_launches}")
    print(
        f"[8 bootstrap_mx3 binary] KMS8party NAND batch {BATCH}: decrypt OK; {bin_s * 1e3:.1f} ms "
        f"(one bootstrap, host clock to the decrypted bits); launches: sweep "
        f"{bin_launches['sweep']}, NTT fwd {bin_launches['fwd']} inv {bin_launches['inv']} ({smi})"
    )

    # 9. key switch on the card vs the CPU
    check_keyswitch(gen, params, scheme)
    print("[9 keyswitch] 4 gates: card == CPU, bit-exact (float64 limb matmul)")

    rows = [
        kernel_row(name, "ntt.cu", "mktfhe_tpu/kernels/ntt_pallas.py:340", launches[d],
                   ntt["err"][d], *ntt["times"][d], ntt_bound(NTT_SHAPES[0], d == "fwd"))
        for d, name in (("fwd", "ntt_fwd_nat"), ("inv", "ntt_inv_nat"))
    ]
    rows += [
        kernel_row(name, "phase1_sweep.cu", "mktfhe_tpu/kernels/fused_mx3.py:226", count,
                   max(res["err"], row1["err"], sweep_wide["err"], err_run_time), res["ms"],
                   res["plain_ms"], res)
        for name, res, row1, count in (
            ("phase1_sweep_block", sweep_block, sweep_block1, launches["sweep"]),
            ("phase1_sweep_binary", sweep_bin, sweep_bin1, bin_launches["sweep"]),
        )
    ]
    binary = {
        "lwe_keys": bin_keys, "scheme": bin_scheme, "party_keys": bin_party_keys,
        "wide_party_keys": wide_party_keys, "ct": bct, "c2": bc2, "m1": bm1, "m2": bm2,
        "mx3_out": mx3_out, "sweep_ms": sweep_bin["ms"],
    }
    return rows, binary


def run_cggi(gen, device, smi: str) -> list[dict]:
    """Phases 10-14: the single-key CGGI path and its kernels; returns their
    rows of the kernels line."""
    params = CGGI_PARAM

    # 10. batch-minor NTT kernel vs plain version
    ntt = check_ntt_bm(gen, device)
    (kf, pf, cf), (ki, pi, ci) = ntt["times"]["fwd"], ntt["times"]["inv"]
    bounds = {"fwd": ntt_bm_bound(NTT_BM_SHAPES[0], True), "inv": ntt_bm_bound(NTT_BM_SHAPES[1], False)}
    print(
        f"[10 ntt batch-minor] bit-exact vs plain version at {NTT_BM_SHAPES} [npr, R, N, G] "
        f"(tolerance {TOLERANCE}); fwd at {list(NTT_BM_SHAPES[0])}: kernel {kf:.4f} ms on the device "
        f"({cf:.4f} ms per call as the host enqueues them) vs plain {pf:.3f} ms (bound "
        f"{bounds['fwd']['bound_ms']:.4f} ms by {bounds['fwd']['bound_by']}); inv at "
        f"{list(NTT_BM_SHAPES[1])}: kernel {ki:.4f} ms ({ci:.4f} ms per call) vs plain {pi:.3f} ms "
        f"(bound {bounds['inv']['bound_ms']:.4f} ms by {bounds['inv']['bound_by']}) ({smi})"
    )

    # 11. keygen
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.time()
    lwe_key, _, scheme = cggi.setup(gen, params)
    bm = batchminor.convert_scheme(scheme, params)
    torch.cuda.synchronize()
    print(
        f"[11 keygen] CGGI (n={params.n}, N={params.big_n}, l_gsw={params.l_gsw}, log_b_gsw="
        f"{params.log_b_gsw}, npr={params.nprimes}): setup and the batch-minor key layout in "
        f"{time.time() - t0:.2f} s; keys hold {(torch.cuda.memory_allocated() - before) / 1e9:.3f} GB ({smi})"
    )

    # 12. step kernel vs plain version
    step = check_step(gen, params, bm, CGGI_BATCH)
    print(
        f"[12 cggi step] bit-exact vs plain version (tolerance {TOLERANCE}) on real keys at G="
        f"{CGGI_BATCH}: one step, the last {CHECK_STEPS} steps, and all {params.n}; one step: kernel "
        f"{step['one_step_ms']:.4f} ms on the device vs plain {step['plain_step_ms']:.3f} ms (bound "
        f"{step['one_step_bound_ms']:.4f} ms); all {params.n} steps: one launch {step['ms']:.2f} ms, "
        f"one launch per step {step['stepwise_ms']:.2f} ms, plain steps {step['plain_ms']:.1f} ms "
        f"(bound {step['bound_ms']:.2f} ms by {step['bound_by']}) ({smi})"
    )

    # 13. this slice's main path: counts reset just before it, read just after
    def decrypt(out):
        return lwe_decrypt_bit(out, lwe_key)

    ct, c2, m1, m2 = cggi_gate_inputs(gen, params, lwe_key, CGGI_BATCH)
    torch.cuda.synchronize()
    reset_launches()
    boot = bootstrap_chain(fused_step.bootstrap_fused, ct, c2, m1, m2, params, decrypt, bm, CHAIN)
    launches = read_launches()
    if launches["step"] == 0:
        raise SystemExit(f"bootstrap_fused did not launch the step kernel: {launches}")
    dt = boot["batch_s"]
    print(
        f"[13 bootstrap_fused] CGGI NAND batch {CGGI_BATCH}: decrypt OK x{1 + CHAIN}; first "
        f"{boot['first_s'] * 1e3:.1f} ms; chain {dt * 1e3:.2f} ms/batch = {CGGI_BATCH / dt:.1f} "
        f"boots/s; step-kernel launches in {1 + CHAIN} bootstraps: {launches['step']} ({smi})"
    )
    prof = profile_bootstrap(fused_step.bootstrap_fused, ct, bm, params, {"step kernel": "cggi_step_kernel"})
    print(profile_line("13b profile", "bootstrap_fused", prof, smi))

    # 14. the other two engines on the same ciphertext: same bits
    want = ~(m1 & m2)
    seconds, counts = {}, {}
    for name, bootstrap, keys in (
        ("bootstrap_bm", batchminor.bootstrap_bm, bm),
        ("cggi.bootstrap", cggi.bootstrap, scheme),
    ):
        bootstrap(ct, keys, params)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.time()
        out = checked_bootstrap(bootstrap, ct, want, keys, params, decrypt, name)
        seconds[name] = time.time() - t0
        counts[name] = read_launches()
        if not (torch.equal(out.b, boot["first"].b) and torch.equal(out.a, boot["first"].a)):
            raise SystemExit(f"{name} and bootstrap_fused differ on the same ciphertext")
    bm_launches, ref_launches = counts["bootstrap_bm"], counts["cggi.bootstrap"]
    if bm_launches["fwd_bm"] == 0 or bm_launches["inv_bm"] == 0:
        raise SystemExit(f"bootstrap_bm did not launch the batch-minor NTT kernels: {bm_launches}")
    if ref_launches["fwd"] == 0 or ref_launches["inv"] == 0:
        raise SystemExit(f"cggi.bootstrap did not launch the NTT kernels: {ref_launches}")
    print(
        f"[14 engines] same ciphertext, batch {CGGI_BATCH}: bootstrap_bm and cggi.bootstrap decrypt "
        f"OK, outputs bit-identical to bootstrap_fused (b and a); bootstrap_bm "
        f"{seconds['bootstrap_bm'] * 1e3:.1f} ms (batch-minor NTT launches fwd {bm_launches['fwd_bm']} "
        f"inv {bm_launches['inv_bm']}), cggi.bootstrap {seconds['cggi.bootstrap'] * 1e3:.1f} ms (NTT "
        f"launches fwd {ref_launches['fwd']} inv {ref_launches['inv']}); one warm bootstrap each, host "
        f"clock to the decrypted bits ({smi})"
    )

    rows = [
        kernel_row(name, "ntt.cu", "mktfhe_tpu/kernels/ntt_pallas.py:240", bm_launches[f"{d}_bm"],
                   ntt["err"][d], *ntt["times"][d][:2], bounds[d])
        for d, name in (("fwd", "ntt_fwd_bm"), ("inv", "ntt_inv_bm"))
    ]
    rows.append(kernel_row(
        "cggi_step", "cggi_step.cu", "mktfhe_tpu/kernels/fused_step.py:86", launches["step"],
        step["err"], step["ms"], step["plain_ms"], step,
    ))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t_start = time.time()

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"[1 card] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    # 2. build
    t0 = time.time()
    sources = [kntt.SOURCE, fused_mx3.SOURCE, fused_step.SOURCE, fused_mx2.SOURCE, butterfly_rate.SOURCE]
    libs = _build.build_all(sources)
    kntt.load_library()
    fused_mx3.load_library()
    fused_step.load_library()
    fused_mx2.load_library()
    butterfly_rate.load_library()
    per_kernel = [_build.resource_usage(lib) for lib in libs]
    usage = "; ".join(f"{src.name}: {' | '.join(said)}" for src, said in zip(sources, per_kernel))
    print(
        f"[2 build] {', '.join(lib.name for lib in libs)} from csrc/ (sm_90a, one nvcc each, "
        f"started together) in {time.time() - t0:.2f} s; ptxas, per kernel: {usage}"
    )

    # the sweeps' own butterflies on registers alone: the rate behind `butterflies_only_ms`
    rate = butterfly_rate.measure(device)
    peak = INT32_OPS_PER_S / OPS_CT_LAZY
    print(
        f"[2b butterfly rate] csrc/butterfly_rate.cu, radix-8 tasks in registers, {rate['rounds']} rounds, "
        f"{rate['sms']} SMs, in 1e12 butterflies/s: ct_lazy (forward) {rate['fwd_one_cta'] / 1e12:.3f} with one "
        f"CTA of 512 threads per SM (the sweeps' occupancy), {rate['fwd_full'] / 1e12:.3f} with as many as "
        f"fit; gs_lazy (inverse) {rate['inv_one_cta'] / 1e12:.3f} and {rate['inv_full'] / 1e12:.3f}; the "
        f"bounds' peak of {INT32_OPS_PER_S / 1e12:.1f} T operations/s is {peak / 1e12:.3f} of ct_lazy's "
        f"{OPS_CT_LAZY} operations ({smi})"
    )

    gen = torch.Generator(device=device).manual_seed(SEED)
    kernels, binary = run_kms(gen, device, smi, per_kernel[1], rate)
    kernels += run_cggi(gen, device, smi)
    kernels += run_mx2(gen, smi, binary, per_kernel[3], rate)

    # 19. results
    print(f"[19 done] {time.time() - t_start:.1f} s in all; {NO_LIBRARY_CALL}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
