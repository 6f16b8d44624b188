#!/usr/bin/env python3
"""Drive the PyTorch port (mktfhe_tpu_torch) on one CUDA card, end to end.

Phases, each printing one line; any failure exits non-zero:
  1. require a CUDA card; print `nvidia-smi` name and power limit;
  2. build the CUDA kernels from mktfhe_tpu_torch/csrc/ (nvcc, sm_90a, one
     process per source, started together) and print what ptxas said of each
     kernel (registers, spills); the template instances that the main paths
     run must not spill registers (checked in phases 3, 5, 12, 16); time the
     kernels' own butterflies on registers alone (a measuring kernel,
     csrc/butterfly_rate.cu), the second yardstick beside their bounds;
  3. hold the natural NTT kernel against its plain PyTorch version on the
     card, bit-exact, forward and inverse, at the bootstrap's shapes and at
     every N from 64 to 2048 (each through its instance, named with its
     registers and spills), and time both;
  4. keygen on the card for KMS8partyblock and KMS8party: crs, 8 party
     keygens, setup;
  5. hold the phase-1 sweep kernel against its plain PyTorch version on the
     card, bit-exact, on real keys: block keys at KMS8partyblock width,
     binary keys at KMS8party width, and a small wide-gadget case, each
     through the template instance compiled for its shape (named with its
     threads, shared memory, registers and spills), and small block and
     binary sets through the kernel with run-time shapes; time kernel and
     plain version at the full number of steps; then every party's sweep in
     one launch at G = 8 (5b) against the plain version party by party and
     against one launch a party, bit-exact, timed beside both and against
     the k sweeps' bound;
  6. the main path: `bootstrap_mx3` of a batch of NAND gates on
     KMS8partyblock, decrypt-checked, then a timed data-dependent chain of
     two more (decrypt-checked too); the sweep (one launch of k parties a
     bootstrap) and NTT kernels must have been launched; then one more under
     torch.profiler for the device time
     by kernel; the natural NTT's launches by shape with the time at each
     (6c), which must add up to its share of the profile;
  7. the earlier path: one `kms.bootstrap` of the same ciphertext,
     decrypt-checked, whose output must equal `bootstrap_mx3`'s bit for bit;
  8. the binary-key path: one `bootstrap_mx3` on KMS8party, decrypt-checked;
  9. hold the key switch on the card against the same code on the CPU for
     4 gates, bit-exact;
 10. hold the batch-minor NTT kernel against its plain version, bit-exact,
     forward and inverse, at the shapes of the batch-minor CGGI engine, at
     a small ragged batch and at the shapes `kms.bootstrap_bm` launches at
     KMS8party (each through its instance, named with its registers and
     spills), and time both directions at the CGGI and KMS shapes against
     their bounds;
 11. CGGI keygen on the card (preset CGGI) and the batch-minor key layout;
 12. hold the fused CGGI step kernel against its plain version on real keys
     at 256 gates, bit-exact, through the instance of preset CGGI (named with
     its registers and spills): a one-step launch against the plain step, a
     short range against as many plain steps; and through the kernel with
     run-time shapes at a small set; time all 630 steps as one launch, as 630
     one-step launches and as 630 plain steps;
 13. this slice's main path: `bootstrap_fused` of 256 NAND gates on CGGI,
     decrypt-checked, then a timed data-dependent chain of two more; the
     step kernel must have been launched; then one more under torch.profiler;
 14. the other two CGGI engines on the same ciphertext, `bootstrap_bm` (the
     batch-minor NTT kernel must have been launched) and `cggi.bootstrap`
     (the natural NTT kernel): all three outputs equal bit for bit; then one
     more `bootstrap_bm` under torch.profiler, and the batch-minor NTT's
     launches by shape with the time at each (14b);
 15. mx-domain keys: `fused_mx2.setup` on the KMS8party party keys of
     phase 4, a scheme without `brk_hat` holding the mx image (and
     `build_mx_kms_keys` on the wide-gadget set's);
 16. hold the mx sweep kernel against its plain version on those keys,
     bit-exact, with 3 rows and with 1 row, on the wide-gadget set and the
     six-digit set, each through its template instance, and on a small set
     through the kernel with run-time shapes; time kernel and plain version
     at the full number of steps;
 17. this slice's main path: `bootstrap_mx2(ct, scheme, params)` of a batch
     of NAND gates on KMS8party, on the scheme of phase 15, decrypt-checked,
     then a timed data-dependent chain of two more; the mx sweep and NTT
     kernels must have been launched; its output on the ciphertext of phase
     8 must equal `bootstrap_mx3`'s bit for bit; then one more under
     torch.profiler, and the natural NTT's launches by shape (17c);
 18. the KMS batch-minor engine on the same ciphertext: `kms.bootstrap_bm`
     (the batch-minor NTT kernel must have been launched), decrypt-checked,
     bit-identical to `bootstrap_mx2`; then one more under torch.profiler,
     and the batch-minor NTT's launches by shape (18b);
 19. the LMSS path: keygen on the card for preset Block, then
     `lmss.bootstrap` of 256 NAND gates, decrypt-checked, and a timed
     data-dependent one more; the natural NTT kernel must have been
     launched 229 + 229 times a bootstrap and no other kernel; the first 4
     gates through the CPU path, bit for bit (run in a thread beside phases
     26 and 31, where the main process waits for ranks: line
     `[19-20 cpu]`); one more under torch.profiler,
     and the natural NTT's launches by shape (19c);
 20. the CCS path, the same at CCS2partyTight and CCS4partyTight, 128 gates
     (2 k n + 2 k n launches a bootstrap; the multi-key decrypt), and one
     decrypt-checked `ccs.bootstrap` of 128 gates on CCS8partyTight;
 21. the port's CLI, `python -m mktfhe_tpu_torch.cli`, as a subprocess with
     ChaCha seeding at Block and CCS2partyTight: both must exit 0 and print OK;
 30a. (run after 18, before 19) the batch-minor NTT kernel against its plain
     version at every shape `kms.bootstrap_bm` launches at KMS16party and
     KMS32party, each through its instance, timed against its bound;
 27. (run after 21, before 23) KMS32partyblock at full width, NAND batch 128:
     the hybrid product kernel against its plain version at merge 32 (and at
     KMS8partyblock's merge 8, batches 128 and 8), bit-exact, timed against
     its bound; keygen on the card; one party's sweep against its plain
     version over all steps; every party's sweep in one launch at G = 8 as
     in 5b (27b); a dependent chain of `bootstrap_mx3`, every link
     decrypt-checked, launches held to one sweep launch of k parties a
     bootstrap and one hybrid product a merge;
     `kms.bootstrap` once on the same input, bit-identical; the named-range
     split of 32 merges by CUDA events, as in 25, phase 1 held to the sweep
     kernel's record in a profile of the same path (taken again if a profile
     lost it, and said);
 28. KMS32party: both key images and the batch-minor image on the card; B2
     and B5 against their plain versions over all steps; `bootstrap_mx3` once,
     then a dependent chain of `bootstrap_mx2` on the scheme without
     `brk_hat`, bit-identical;
 29. KMS16, KMS4 and KMS2, block keys through `bootstrap_mx3`, binary keys
     through `bootstrap_mx2`: a decrypt-checked bootstrap and a dependent one,
     the instance that served the sweeps, each preset's keys freed before the
     next; then a summary of every preset of 27-29 (29b);
 30. (in 28 and 29) `kms.bootstrap_bm` at KMS32party and KMS16party on the
     chain's first input, on the batch-minor image of the same party keys:
     bit-identical to `bootstrap_mx2`, decrypt-checked, the batch-minor NTT's
     launches counted by shape, times the time at each; at KMS16party one
     warm bootstrap under the profiler, split by named range with CUDA
     events as in 25; the files of phase 31's ranks (each rank's share in a
     file of its own);
 32. (run after 31) CCS8party and CCS16party: keygen on the card, a decrypt-checked
     `ccs.bootstrap` of 128 gates and a dependent one (2 k n + 2 k n natural
     NTT launches a bootstrap), the natural NTT's launches by shape with the
     time and bound at each, and at CCS16party the kernel against its plain
     version at the path's largest shape;
 23. serialization on the card: the KMS8party scheme without `brk_hat`, its
     mx keys and the CGGI scheme saved (`utils.save`) and loaded back onto
     the card; `bootstrap_mx2` and `bootstrap_fused` on the loaded keys give
     phases 17's and 13's outputs bit for bit; the files phase 26 loads;
 24. (run last, after 32) noise: `utils.noise.noise_report` on the outputs of phases 6, 13, 17,
     19, 20, 27-29 and 32 beside MARGINS.md's rows (margins.json); fails where
     an error reaches the margin;
 25. named ranges: one `bootstrap_mx3` (KMS8partyblock) and one
     `bootstrap_mx2` (KMS8party) split by CUDA events at the named phase
     ranges' edges (`utils.profiling.event_ranges`): the ranges must add up
     to 0.90-1.02 of the bootstrap's event time, phase 1 to at least 0.95 of
     the sweep kernels in the profile of 6b / 17b; beside it the kernel
     records' total of one more under torch.profiler; and the cost model's
     summary against the H100's peaks;
 26. the party-sharded bootstrap (`parallel/`) in ranks spawned after the
     build, loading phase 23's files, each job eagerly and then replayed
     from the rank's CUDA graphs (`graphs.capture_sharded`): NCCL, one rank,
     the mx2 engine, the whole program one graph with its collectives,
     replayed with no sync, and captured by segment too (the nodes the
     collectives add); gloo, two ranks sharing the card, a graph a segment:
     mx2 with phase 2 replicated and with shard_phase2, the batch-minor
     engine, `kms_bootstrap_sharded` and the reference engine at
     KMS8partyblock; every output, eager and graphed, equal to the
     single-process one and decrypt-checked, every rank's launches counted
     (a replay's too); the same two ranks then run phase 31's k = 16 jobs;
 31. the party-sharded bootstrap at k = 16 (two gloo ranks sharing the card:
     the batch-minor engine, and mx2 with shard_phase2) and at k = 32 (four
     ranks, mx2 with shard_phase2), each rank reading only its share of the
     keys from disk, eagerly and graphed as in 26: every output equal to the
     single-process `bootstrap_mx2` output and decrypt-checked, every rank's
     launches counted, its key bytes, bytes read, host and device memory
     printed; then the graphed sharded jobs' JSON line;
 33. (inside the phases of each path, lines `[33 graph]`) every gate
     bootstrap captured as one CUDA graph (`graphs.capture_bootstrap`) at
     its path's preset and batch: `bootstrap_mx3` (KMS8partyblock,
     KMS32partyblock), `kms.bootstrap` (KMS8partyblock), `bootstrap_mx2` and
     `kms.bootstrap_bm` (KMS8party), CGGI's three engines, `lmss.bootstrap`
     (Block), `ccs.bootstrap` (CCS2partyTight, CCS4partyTight, CCS8party,
     and CCS16party as far as the time limit allows): the capture's eager
     warm-up == the path's eager output, the graph's first replay == the
     eager bootstrap of the same input, bit for bit, a replay's launches ==
     the eager bootstrap's, a dependent chain of replays timed beside the
     eager chain, every link decrypt-checked; one replay under
     torch.profiler (busy and idle share, the hand kernels there); the
     capture's seconds, nodes and pool bytes.  Every eager chain's
     bootstraps run under set_sync_debug_mode("error"), or one eager
     bootstrap of the path does here: no host read, no blocking copy.  Then
     a summary (`[33 graphs]`) and its JSON line;
 22. print the kernels' JSON line, then the contract line last.

Usage: python3 chip_smoke.py   (one CUDA card; no arguments)
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from mktfhe_tpu_torch import bridge, graphs
from mktfhe_tpu_torch.ciphertext.lwe import Lwe
from mktfhe_tpu_torch.kernels import _build, batchminor, fused_mx2, fused_mx3, fused_step
from mktfhe_tpu_torch.kernels import hybrid_product as khybrid
from mktfhe_tpu_torch.kernels import ntt as kntt
from mktfhe_tpu_torch.parallel.launch import Job, bootstrap_jobs, run_ranks
from mktfhe_tpu_torch.parallel.mesh import party_share
from mktfhe_tpu_torch.ring.context import make_ring_ctx, nprimes_monomial_weighted
from mktfhe_tpu_torch.ring.modring import prime_column
from mktfhe_tpu_torch.ring.ntt import fwd_ntt, inv_ntt, make_plan
from mktfhe_tpu_torch.ring.sampler import uniform_torus
from mktfhe_tpu_torch.schemes import ccs, cggi, kms, lmss
from mktfhe_tpu_torch.schemes.common import mod_switch_2n
from mktfhe_tpu_torch.schemes.gates import (
    GATE_IDS,
    gate_affine,
    lwe_decrypt_bit,
    lwe_decrypt_bit_mk,
    lwe_encrypt_bit,
    lwe_ith_encrypt_bit,
)
from mktfhe_tpu_torch.schemes.params import KmsBlockParams, KmsParams
from mktfhe_tpu_torch.schemes.presets import (
    BLOCK_PARAM,
    CCS_2PARTY_TIGHT,
    CCS_4PARTY_TIGHT,
    CCS_8PARTY,
    CCS_8PARTY_TIGHT,
    CCS_16PARTY,
    CGGI_PARAM,
    KMS_2PARTY,
    KMS_2PARTY_BLOCK,
    KMS_4PARTY,
    KMS_4PARTY_BLOCK,
    KMS_8PARTY,
    KMS_8PARTY_BLOCK,
    KMS_16PARTY,
    KMS_16PARTY_BLOCK,
    KMS_32PARTY,
    KMS_32PARTY_BLOCK,
)
from mktfhe_tpu_torch.tools import butterfly_rate
from mktfhe_tpu_torch.tools.time_sweeps import device_ms
from mktfhe_tpu_torch.utils import load, noise, profiling, save

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
# the LMSS and CCS paths: LMSS at the CGGI batch, CCS at the KMS batch, each
# timed over a dependent chain of GATE_CHAIN bootstraps after the first (one:
# phase 33 times their graphs over a chain of its own)
LMSS_BATCH = CGGI_BATCH
CCS_BATCH = BATCH
GATE_CHAIN = 1
CPU_GATES = 4  # gates of each path also run through the CPU path, bit for bit
CPU_CHECK_THREADS = 4  # of the host's 8 cores, the rest for phase 26's and 31's ranks
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
# the shapes that bootstrap_bm and kms.bootstrap_bm launch: timed both ways
NTT_BM_TIMED = [shape for shape in NTT_BM_SHAPES if shape[3] >= 128]
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

# phase 33: each path's bootstrap captured as one CUDA graph and replayed, a
# dependent chain of GRAPH_CHAIN replays (one where a replay takes seconds);
# one replay profiled where the graph holds at most PROFILE_NODES nodes (a
# profile of 10^5 nodes and more takes 8-30 s, and the profiles after it lose
# kernel records now and then); every chain timed by CUDA events too
GRAPH_CHAIN = CHAIN
PROFILE_NODES = 50_000
# CCS16party's graph (about 70 s: warm-up, capture, instantiate, a replay of
# 22 s) runs only if the script has run less than this many seconds when it
# gets there: after it come only the noise line and the end, so the script
# stays well inside its 1,200 s
CCS16_GRAPH_BY_S = 950

# phases 27-29: the KMS presets beyond k = 8, each at full width and BATCH,
# timed over a dependent chain of PARTY_CHAIN bootstraps after the first
# (phase 33 times k = 32's graph over a chain of its own)
PARTY_CHAIN = 1
OTHER_PARTIES = [
    ("KMS16partyblock", KMS_16PARTY_BLOCK), ("KMS16party", KMS_16PARTY),
    ("KMS4partyblock", KMS_4PARTY_BLOCK), ("KMS4party", KMS_4PARTY),
    ("KMS2partyblock", KMS_2PARTY_BLOCK), ("KMS2party", KMS_2PARTY),
]

# phase 30: kms.bootstrap_bm at the binary presets beyond k = 8; phase 32:
# the CCS presets that contract the most digit products (204 at CCS16party)
BM_PARTIES = (("KMS16party", KMS_16PARTY), ("KMS32party", KMS_32PARTY))
CCS_PARTIES = (("CCS8party", CCS_8PARTY), ("CCS16party", CCS_16PARTY))

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
# stage-by-stage transforms that every kernel ran before its redesign ran
# canonical butterflies and a carry-chain decomposition (the count kept
# beside each bound):
OPS_SHOUP_MUL = 6  # mulhi, two mullo, subtract, compare, subtract
OPS_BUTTERFLY = OPS_SHOUP_MUL + 3 + 4  # + add_mod + sub_mod
OPS_PRODUCT_TERM = 4  # 32x32 -> 64 multiply (lo, hi) and a 64-bit add
OPS_BARRETT = 12  # 64x64 high product as eight 32-bit mul/adds, then as Shoup's tail
OPS_DIGIT = 5  # mask, shift, carry add, sign test, lift
# the redesigned kernels (all five) run lazy butterflies and take each digit
# from the accumulator word plus an offset:
OPS_CT_LAZY = 10  # csub (subtract, min), mulhi, two multiply-adds, 2 u0 + 2p, subtract
OPS_GS_LAZY = 9  # subtract, add, add, csub (subtract, min), mulhi, multiply, multiply-subtract
OPS_CANONICAL = 4  # two csub: [0, 4p) -> [0, p), once per transformed digit
OPS_DIGIT_SOURCE = 8  # per accumulator word and step: 64-bit shift, rounding bit (shift, mask), two 64-bit adds
OPS_DIGIT_SOURCE_32 = 5  # the same on the 2^32 torus (the CGGI step kernel): shift, shift, mask, two adds
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


def ntt_bound(shape, forward: bool, rate: dict) -> dict:
    """Least time of one transform of [rows, npr, N] u32 on the card: every
    residue read and written once plus the twiddles, against N/2 log2 N
    butterflies per polynomial (and N scalings by 1/N in the inverse),
    counted in the lazy arithmetic the kernels run, one canonical reduction a
    forward output; beside it the canonical radix-2 count and the butterflies
    alone at the register rate of full occupancy (`rate`)."""
    rows, npr, n = shape
    nbytes = 2 * rows * npr * n * 4 + 2 * npr * n * 4
    butterflies = rows * npr * n // 2 * (n.bit_length() - 1)
    canonical = _bound(nbytes, butterflies * OPS_BUTTERFLY + (0 if forward else rows * npr * n * OPS_SHOUP_MUL))
    lazy = butterflies * (OPS_CT_LAZY if forward else OPS_GS_LAZY) + rows * npr * n * (
        OPS_CANONICAL if forward else OPS_SHOUP_MUL)
    return {
        **_bound(nbytes, lazy),
        "bound_ms_canonical_radix2": canonical["bound_ms"],
        "butterflies_only_ms": butterflies / rate["fwd_full" if forward else "inv_full"] * 1e3,
    }


def _bound(nbytes: int, ops: int) -> dict:
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def check_ntt(gen, device, usage: list[str]) -> dict:
    """Kernel vs plain version on the card at NTT_SHAPES and at 5 rows of
    every N the wrapper admits over 2, 3 and 4 primes; each instance's name
    with what ptxas said of it (none may spill); times at the first shape."""
    err = {"fwd": 0, "inv": 0}
    times = {}
    every_n = [(5, npr, 1 << log_n) for log_n in range(6, 12) for npr in (2, 3, 4)]
    for shape in NTT_SHAPES + every_n:
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
    notes = [instance_note(kntt.nat_kernel(1 << log_n, forward), usage, must_not_spill=True)
             for log_n in range(6, 12) for forward in (True, False)]
    return {"err": err, "times": times, "notes": notes}


def time_ntt_shapes(gen, device, shapes) -> dict:
    """Device time in ms of the natural kernel, forward and inverse, at each
    [rows, npr, N] of `shapes` (torch.profiler: the short ones are faster
    than the host enqueues them)."""
    out = {}
    for shape in shapes:
        plan = make_plan(shape[2], shape[1])
        x = _residues(gen, shape, device)
        for _ in range(3):  # warm-up
            kntt.fwd_ntt_nat(x, plan)
            kntt.inv_ntt_nat(x, plan)
        out[shape] = (
            device_ms(lambda: kntt.fwd_ntt_nat(x, plan), 20, kntt.nat_kernel(shape[2], True)["name"]),
            device_ms(lambda: kntt.inv_ntt_nat(x, plan), 20, kntt.nat_kernel(shape[2], False)["name"]),
        )
    return out


def time_bm_shapes(gen, device, shapes) -> dict:
    """Device time in ms of the batch-minor kernel, forward and inverse, at
    each [npr, R, N, G] of `shapes`, each through the instance that serves
    it (torch.profiler)."""
    out = {}
    for shape in shapes:
        npr, rows, n, gates = shape
        plan = make_plan(n, npr)
        x = _bm_residues(gen, shape, device)
        out[shape] = tuple(
            device_ms(lambda: wrapper(x, plan), 50, kntt.bm_kernel(n, npr, rows, gates, forward)["name"])
            for wrapper, forward in ((kntt.fwd_ntt_bm, True), (kntt.inv_ntt_bm, False))
        )
    return out


def ntt_by_shape(path: str, fwd: dict, inv: dict, bootstraps: int, times: dict) -> list[dict]:
    """An NTT kernel's launches on a path by shape (the wrappers' `shapes`),
    per bootstrap, with the time at each (`times`: time_ntt_shapes or
    time_bm_shapes)."""
    rows = []
    for shape in sorted(set(fwd) | set(inv), reverse=True):
        f, i = fwd.get(shape, 0) / bootstraps, inv.get(shape, 0) / bootstraps
        rows.append({"path": path, "shape": list(shape), "fwd": f, "inv": i,
                     "fwd_ms": times[shape][0], "inv_ms": times[shape][1],
                     "ms_per_bootstrap": f * times[shape][0] + i * times[shape][1]})
    return rows


def by_shape_line(tag: str, rows: list[dict], profiled_ms: float, smi: str,
                  kernel: str = "natural NTT kernel", axes: str = "[rows, npr, N]",
                  against: str = "in the profile") -> str:
    parts = "; ".join(f"{r['shape']} " + ", ".join(
        f"{d} {r[d]:g} x {r[d + '_ms']:.4f} ms" for d in ("fwd", "inv") if r[d]) for r in rows)
    total = sum(r["ms_per_bootstrap"] for r in rows)
    return (f"[{tag}] {kernel} per {rows[0]['path']}, by shape {axes}: {parts}; "
            f"launches x time = {total:.3f} ms against {profiled_ms:.3f} ms {against} ({smi})")


def keygen(gen, params):
    """crs, party keygens and setup on the generator's device: the LWE keys,
    the scheme, the party keys (torus domain) and the crs."""
    a = kms.crs(gen, params)
    parties = [kms.party_keygen(gen, a, params) for _ in range(params.k)]
    party_keys = [p[3] for p in parties]
    return [p[0] for p in parties], kms.setup(a, party_keys, params), party_keys, a


def sweep_step_ops(n: int, npr: int, l: int, per_position: int, accumulate: int, lazy: bool,
                   torus_bits: int = 64) -> int:
    """32-bit integer operations of one step of one (gate, row) of a sweep:
    per prime the 2l digit polynomials and their forward transforms,
    `per_position` operations of the pointwise stage at each of n positions,
    two inverse transforms scaled by 1/N; then per coefficient Garner mod
    2^torus_bits and `accumulate` operations.  `lazy`: the arithmetic the
    redesigned kernels run
    (lazy butterflies, digits from the accumulator word plus an offset, one
    canonical reduction per transformed digit); else the canonical radix-2
    arithmetic of the stage-by-stage transforms, by which the sweeps' bounds
    were counted before their redesign."""
    log_n = n.bit_length() - 1
    if lazy:
        fwd, inv = (n // 2 * log_n * ops for ops in (OPS_CT_LAZY, OPS_GS_LAZY))
        digits = 2 * l * n * (OPS_LIFTED_DIGIT + OPS_CANONICAL)
        sources = 2 * n * (OPS_DIGIT_SOURCE if torus_bits == 64 else OPS_DIGIT_SOURCE_32)
    else:
        fwd = inv = n // 2 * log_n * OPS_BUTTERFLY
        digits = 2 * l * n * OPS_DIGIT
        sources = 0
    per_prime = digits + 2 * l * fwd + n * per_position + 2 * inv + 2 * n * OPS_SHOUP_MUL
    horner = (npr - 1) * 8 + 4 if torus_bits == 64 else (npr - 1) * 2 + 2
    garner = npr * (npr - 1) // 2 * (OPS_SHOUP_MUL + 4 + 2) + horner
    return sources + npr * per_prime + 2 * n * (garner + accumulate)


def sweep_bounds(nbytes: int, units: int, n: int, npr: int, l: int, per_position: int, accumulate: int,
                 rate: dict, torus_bits: int = 64, occupancy: str = "one_cta") -> dict:
    """The bound of a sweep of `units` (gate, row, step) triples: bytes
    against operations of the arithmetic the kernel runs (`bound_ms`); beside
    it the same bound counted in the canonical radix-2 arithmetic
    (`bound_ms_canonical_radix2`, the yardstick of the rows before the
    redesign), and the time that the sweep's butterflies alone take at the
    rate the card reaches on them in registers (`butterflies_only_ms`, from
    csrc/butterfly_rate.cu at the kernel's occupancy: "one_cta" per SM, the
    sweeps', or "full", several CTAs an SM)."""
    half_stages = n // 2 * (n.bit_length() - 1)
    ops = functools.partial(sweep_step_ops, n, npr, l, per_position, accumulate, torus_bits=torus_bits)
    return {
        **_bound(nbytes, units * ops(lazy=True)),
        "bound_ms_canonical_radix2": _bound(nbytes, units * ops(lazy=False))["bound_ms"],
        "butterflies_only_ms": units * npr * half_stages * (
            2 * l / rate[f"fwd_{occupancy}"] + 2 / rate[f"inv_{occupancy}"]) * 1e3,
    }


def bounds_note(res: dict, digits: int = 2) -> str:
    return (f"bound {res['bound_ms']:.{digits}f} ms by {res['bound_by']} in the kernel's arithmetic, "
            f"{res['bound_ms_canonical_radix2']:.{digits}f} ms counted in canonical radix-2 arithmetic; its "
            f"butterflies alone in registers {res['butterflies_only_ms']:.{digits}f} ms")


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
        out.update(timed_whole(fused_mx3.phase1_sweep, fused_mx3.phase1_sweep_plain if plain else None, args,
                               f"sweep kernel ({type(params).__name__}, {params.n // ell} steps)"))
        out.update(sweep_bound(params, ctx, g, rows, tildea, rate))
    return out


SWEEPS_GATES = 8  # the narrow layer at which every party's sweep in one launch fills the card's waves


def sweeps_bound(params, ctx, g: int, tildea: torch.Tensor, rate: dict) -> dict:
    """The least time of every party's sweep: the k parties' bounds
    (`sweep_bound`; party 1 one row, the others l_lev) added up."""
    tild = tildea.reshape(g, params.k, params.n)
    parts = [sweep_bound(params, ctx, g, 1 if p == 0 else params.l_lev, tild[:, p], rate) for p in range(params.k)]
    out = {k: sum(b[k] for b in parts) for k in ("bound_ms", "bound_ms_canonical_radix2", "butterflies_only_ms")}
    return {**out, "bound_by": parts[-1]["bound_by"]}


def check_sweeps(gen, params, scheme, g: int, rate: dict) -> dict:
    """Every party's sweep in one launch (`phase1_sweeps`) on the scheme's
    keys and uniform rotation amounts at G = g, all steps: one launch of k
    parties; each party's accumulator == `phase1_sweep_plain` on that
    party's columns and keys, and == its own `phase1_sweep` launch, bit for
    bit; the one launch timed beside the plain version and beside the k
    launches it replaces (both without the public wrappers' range read),
    against the k sweeps' bound."""
    device = scheme.crs_hat.device
    ctx = kms._ctx(params)
    tildea = torch.randint(0, 2 * ctx.n, (g, params.k * params.n), generator=gen, device=device, dtype=torch.int32)
    tild = tildea.reshape(g, params.k, params.n)
    args = (tildea, scheme.brk_hat, params.l_lev, scheme.mono_hat, params, ctx)
    singles = [(tild[:, p].contiguous(), scheme.brk_hat[p], 1 if p == 0 else params.l_lev, scheme.mono_hat, params, ctx)
               for p in range(params.k)]
    before = (fused_mx3.phase1_sweep.launches, fused_mx3.phase1_sweep.parties)
    got = fused_mx3.phase1_sweeps(*args)
    served = (fused_mx3.phase1_sweep.launches - before[0], fused_mx3.phase1_sweep.parties - before[1])
    if served != (1, params.k):
        raise SystemExit(f"phase1_sweeps ({type(params).__name__}, k={params.k}): (launches, parties) {served}, "
                         f"expected (1, {params.k})")
    held = {}
    plain_ms = _sync_ms(lambda: held.setdefault("want", [fused_mx3.phase1_sweep_plain(*one) for one in singles]), 1)
    err = max(_max_abs_diff(got[p], want) for p, want in enumerate(held["want"]))
    if err > TOLERANCE or not all(torch.equal(got[p], want) for p, want in enumerate(held["want"])):
        raise SystemExit(f"phase1_sweeps disagrees with phase1_sweep_plain party by party (k={params.k}): "
                         f"max |diff| {err}")
    if not all(torch.equal(got[p], fused_mx3.phase1_sweep(*one)) for p, one in enumerate(singles)):
        raise SystemExit(f"phase1_sweeps disagrees with one launch a party (k={params.k})")
    return {
        "err": err,
        "ms": _sync_ms(lambda: fused_mx3.kms_phase1_sweeps(*args), 3),
        "plain_ms": plain_ms,
        "one_launch_a_party_ms": _sync_ms(lambda: [fused_mx3._sweep(*one) for one in singles], 3),
        **sweeps_bound(params, ctx, g, tildea, rate),
    }


def sweeps_note(res: dict, params) -> str:
    return (f"every party's B2 sweep in one launch ({SWEEPS_GATES} + {params.k - 1} x {SWEEPS_GATES * params.l_lev} "
            f"CTAs), G={SWEEPS_GATES}, all steps: bit-exact vs phase1_sweep_plain party by party (max |diff| "
            f"{res['err']}) and vs one launch a party; {res['ms']:.2f} ms vs {res['one_launch_a_party_ms']:.2f} ms "
            f"in {params.k} launches, plain version {res['plain_ms']:.1f} ms; {bounds_note(res)}")


def sweeps_row(name: str, preset: str, res: dict, launches: dict, runs: int) -> dict:
    """The kernels-line row of the multi-party launch: `launches` holds the
    counts read after the main path's `runs` bootstraps (phase 6 / 27c)."""
    row = kernel_row(name, "phase1_sweep.cu", "mktfhe_tpu/kernels/fused_mx3.py:226", launches["sweep"], res["err"],
                     res["ms"], res["plain_ms"], res)
    row.update(preset=preset, timed_at=[SWEEPS_GATES], one_launch_a_party_ms=res["one_launch_a_party_ms"],
               parties=launches["parties"], launches_per_bootstrap=launches["sweep"] // runs,
               parties_per_launch=launches["parties"] // launches["sweep"])
    return row


def timed_whole(kernel, plain, args: tuple, what: str) -> dict:
    """A sweep kernel's device time at the full shape (after a warm-up), and,
    if `plain` is given, its plain version's time on the same arguments,
    whose output must equal the kernel's bit for bit over all steps."""
    got = kernel(*args)  # warm-up at the full shape
    out = {"ms": _sync_ms(lambda: kernel(*args), 3)}
    if plain is not None:
        held = {}
        out["plain_ms"] = _sync_ms(lambda: held.setdefault("want", plain(*args)), 1)
        err = _max_abs_diff(got, held["want"])
        if err > TOLERANCE or not torch.equal(got, held["want"]):
            raise SystemExit(f"{what} disagrees with its plain version over all steps: max |diff| {err}")
        out["whole_err"] = err
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
    `chain` dependent bootstraps, every link decrypt-checked after the
    timing.  The links' bootstraps run under set_sync_debug_mode("error")
    (`graphs.without_sync`): none may make a host read or a blocking copy
    (the first bootstrap, outside the mode, has made the constant tables)."""
    nand = GATE_IDS["NAND"]
    want = ~(m1 & m2)
    t0 = time.time()
    first = out = checked_bootstrap(bootstrap, ct, want, scheme, params, decrypt, "bootstrap")
    first_s = time.time() - t0
    links = []
    t0 = time.time()
    for _ in range(chain):
        out = graphs.without_sync(bootstrap, gate_affine(nand, out, c2), scheme, params)
        want = ~(want & m2)
        links.append((out, want))
    out.b.cpu()  # a hard device -> host read ends the timed chain
    dt = (time.time() - t0) / chain
    for i, (out, want) in enumerate(links):
        got = decrypt(out).cpu().numpy()
        if not np.array_equal(got, want):
            raise SystemExit(f"chain link {i + 1} decrypt mismatch: {int((got != want).sum())} of {len(want)} gates")
    return {"first_s": first_s, "batch_s": dt, "first": first, "second": links[0][0] if links else None}


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

    # the device's own records, straight from the profiler's results: its
    # operator tree (`key_averages`) takes minutes to build at the 10^5-10^6
    # events of a plain-PyTorch bootstrap, and the operator rows would carry
    # their kernels' time a second time
    on_device = torch.autograd.DeviceType.CUDA
    by_name: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        # the device rows of the named phase ranges (utils/profiling.py) span
        # kernels, they are none
        if e.device_type() == on_device and e.duration_ns() > 0 and not e.is_user_annotation():
            row = by_name.setdefault(e.name(), [0.0, 0])
            row[0] += e.duration_ns() / 1e6
            row[1] += 1
    rows = sorted(((ms, count, key) for key, (ms, count) in by_name.items()), reverse=True)
    return {
        "wall_ms": wall_ms,
        "events": sum(count for _, count, _ in rows),
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
        "hybrid": khybrid.hybrid_product.launches,
        "parties": fused_mx3.phase1_sweep.parties,
    }


def reset_launches() -> None:
    kntt.reset_launches()
    khybrid.reset_launches()
    fused_mx3.reset_launches()
    fused_step.reset_launches()
    fused_mx2.reset_launches()


def same_bits(x: Lwe, y: Lwe) -> bool:
    return torch.equal(x.b, y.b) and torch.equal(x.a, y.a)


def graph_path(state: dict, path: str, preset: str, bootstrap, scheme, params, ct, c2, m1, m2, decrypt,
               eager: dict, parts: dict, smi: str, extra: tuple = (), chain: int = GRAPH_CHAIN) -> None:
    """Phase 33 for one path: `bootstrap(ct, scheme, *extra, params)`
    captured as one CUDA graph (`graphs.capture_bootstrap`) on the path's
    ciphertext and replayed over a dependent chain of `chain`.  Held to the
    eager run `eager`: "out", its output on `ct`; "next", its output on the
    chain's first input NAND(out, c2) where its chain had one (else one
    eager bootstrap of that input runs here under
    set_sync_debug_mode("error") and gives "next" and "ms"); "ms", its ms a
    batch, and "how" it was taken; "synced", how many of its bootstraps ran
    under that mode; "busy_ms", its device busy time a bootstrap where it
    was profiled.  The capture's eager warm-up must give "out" and the
    chain's first link "next", bit for bit; the chain's launches must be
    `chain` times the warm-up's, by wrapper and shape; every link is
    decrypt-checked, and the chain timed on the host clock and by CUDA
    events; one replay under torch.profiler (`parts`: the hand kernels that
    must appear) where the graph holds at most PROFILE_NODES nodes.  Appends
    the record to state["graphs"] and prints it."""
    batch = ct.b.shape[0]
    nand = GATE_IDS["NAND"]
    what = f"{path} {preset}"
    t_path = time.time()
    first_input = gate_affine(nand, eager["out"], c2)
    torch.cuda.synchronize()
    if eager.get("next") is None:
        t0 = time.time()
        out = graphs.without_sync(bootstrap, first_input, scheme, *extra, params)
        torch.cuda.synchronize()
        eager = dict(eager, next=out, ms=(time.time() - t0) * 1e3, synced=1,
                     how="one warm eager bootstrap, host clock to its end")

    reset_launches()
    graphed = graphs.capture_bootstrap(bootstrap, scheme, params, ct, *extra)
    once = graphs.launch_counts()
    if not same_bits(graphed.warmup_out, eager["out"]):
        raise SystemExit(f"{what}: the capture's eager warm-up differs from the path's output")

    want = ~(~(m1 & m2) & m2)
    links = []
    reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.time()
    start.record()
    out = graphed(first_input, scheme, *extra, params)
    links.append((out, want))
    for _ in range(chain - 1):
        out = graphed(gate_affine(nand, out, c2), scheme, *extra, params)
        want = ~(want & m2)
        links.append((out, want))
    end.record()
    out.b.cpu()  # a hard device -> host read ends the timed chain
    dt = (time.time() - t0) / chain
    span_ms = start.elapsed_time(end) / chain
    expect = {w: (chain * n, {k: chain * v for k, v in shapes.items()}) for w, (n, shapes) in once.items()}
    if graphs.launch_counts() != expect:
        raise SystemExit(f"{what}: {chain} replays counted {graphs.launch_counts()}, the eager bootstrap "
                         f"{once} each")
    if not same_bits(links[0][0], eager["next"]):
        raise SystemExit(f"{what}: the graph's output differs from the eager output on the same ciphertext")
    for i, (out, want) in enumerate(links):
        got = decrypt(out).cpu().numpy()
        if not np.array_equal(got, want):
            raise SystemExit(f"{what}: graphed chain link {i + 1} decrypt mismatch: {int((got != want).sum())} "
                             f"of {len(want)} gates")

    rec = {
        "path": path, "preset": preset, "batch": batch, "eager_ms": eager["ms"], "eager_how": eager["how"],
        "eager_boots_per_s": batch / eager["ms"] * 1e3, "graph_ms": dt * 1e3, "graph_boots_per_s": batch / dt,
        "chain": chain, "graph_span_ms": span_ms, "warmup_s": graphed.warmup_s, "capture_s": graphed.capture_s,
        "instantiate_s": graphed.instantiate_s, "pool_bytes": graphed.pool_bytes, "key_bytes": graphed.key_bytes,
        "pool_peak_bytes": graphed.pool_peak_bytes, "nodes": graphed.nodes, "launches": graphed.launches,
        "sync_checked": eager["synced"],
        "graph_busy_ms": span_ms, "graph_busy_from": "CUDA events around the chain", "events": None,
    }
    prof_note = (f"not profiled ({graphed.nodes} nodes > {PROFILE_NODES}): device busy from the CUDA events, which "
                 f"also count the gaps between the graph's nodes")
    if graphed.nodes <= PROFILE_NODES:
        prof = profile_bootstrap(lambda x, s, p: graphed(x, s, *extra, p), ct, scheme, params, parts)
        missing = [label for label, ms in prof["parts"].items() if ms <= 0]
        if prof["events"] == 0:
            prof_note = "the profiler recorded no device row of the replay: its kernels do not appear there"
        else:
            rec.update(graph_busy_ms=prof["device_ms"], graph_busy_from="torch.profiler", events=prof["events"],
                       parts=prof["parts"], graph_idle_profiled=max(0.0, 1 - prof["device_ms"] / prof["wall_ms"]))
            prof_note = (f"one replay under torch.profiler: {prof['events']} device rows, busy "
                         f"{prof['device_ms']:.2f} ms of a profiled wall of {prof['wall_ms']:.2f} ms (idle share "
                         f"{rec['graph_idle_profiled']:.3f}); "
                         + ", ".join(f"{k} {v:.2f} ms" for k, v in prof["parts"].items())
                         + (f"; MISSING from the profile: {missing}" if missing
                            else "; every hand kernel of the path there"))
    rec["graph_idle"] = max(0.0, 1 - rec["graph_busy_ms"] / (dt * 1e3))
    # the eager bootstrap runs the graph's kernels: where it was not profiled, the graph's busy time stands in
    rec["eager_busy_from"] = "its own profile" if eager.get("busy_ms") else f"the graph's ({rec['graph_busy_from']})"
    rec["eager_idle"] = max(0.0, 1 - (eager.get("busy_ms") or rec["graph_busy_ms"]) / eager["ms"])
    state["graphs"].append(rec)

    print(
        f"[33 graph] {what} NAND batch {batch}: captured as one CUDA graph (warm-up {graphed.warmup_s:.2f} s, "
        f"capture {graphed.capture_s:.2f} s, instantiate {graphed.instantiate_s:.2f} s, {graphed.nodes} nodes, pool "
        f"{graphed.pool_bytes / 1e9:.3f} GB reserved, {graphed.pool_peak_bytes / 1e9:.3f} GB its peak allocated, "
        f"above {graphed.key_bytes / 1e9:.3f} GB of keys); warm-up == the eager output and the chain's first link "
        f"== the eager bootstrap of the same input, bit for bit; a replay's launches == the eager bootstrap's "
        f"({graphed.launches}); no sync in {eager['synced']} eager bootstrap(s) under "
        f"set_sync_debug_mode('error'); graphed chain of {chain}, every link decrypted: {dt * 1e3:.2f} ms a batch "
        f"= {batch / dt:.2f} boots/s ({span_ms:.2f} ms on the device's clock, CUDA events) against eager "
        f"{eager['ms']:.2f} ms = {rec['eager_boots_per_s']:.2f} boots/s "
        f"({eager['how']}), x{eager['ms'] / (dt * 1e3):.2f}; idle share a batch (1 - device busy / ms a batch) "
        f"graphed {rec['graph_idle']:.3f} (busy from {rec['graph_busy_from']}), eager {rec['eager_idle']:.3f} (busy "
        f"from {rec['eager_busy_from']}); {prof_note} ({smi})"
    )
    rec["s"] = time.time() - t_path
    state["graph_s"] = state.get("graph_s", 0.0) + rec["s"]
    del graphed, out, links
    torch.cuda.empty_cache()


def graphs_summary(state: dict, smi: str) -> None:
    """Phase 33's table, one entry a path, and its JSON line."""
    rows = [f"{r['path']} {r['preset']}: eager {r['eager_ms']:.1f} -> graph {r['graph_ms']:.1f} ms a batch "
            f"(x{r['eager_ms'] / r['graph_ms']:.2f}), idle {r['eager_idle']:.3f} -> {r['graph_idle']:.3f}, capture "
            f"{r['capture_s']:.1f} s + {r['instantiate_s']:.1f} s, {r['nodes']} nodes, pool "
            f"{r['pool_bytes'] / 1e9:.2f} GB, {r['s']:.1f} s in all" for r in state["graphs"]]
    print(f"[33 graphs] {len(rows)} paths graphed in {state.get('graph_s', 0.0):.1f} s of the script, every output "
          f"== eager, every link decrypted: " + "; ".join(rows) + f" ({smi})")
    print(json.dumps({"graphs": state["graphs"]}, default=str))


def check_keyswitch(gen, params, scheme, gates: int = 4) -> None:
    """The key switch on the scheme's device vs the same code on the CPU."""
    ctx = kms._ctx(params)
    acc = uniform_torus(gen, (gates, params.k + 1, params.big_n), ctx.dtype)
    got = kms._keyswitch(acc, scheme, params)
    cpu_scheme = dataclasses.replace(scheme, ksk_b=scheme.ksk_b.cpu(), ksk_a=scheme.ksk_a.cpu())
    want = kms._keyswitch(acc.cpu(), cpu_scheme, params)
    if not (torch.equal(got.b.cpu(), want.b) and torch.equal(got.a.cpu(), want.a)):
        raise SystemExit("key switch on the card differs from the CPU")


def _bm_residues(gen, shape, device) -> torch.Tensor:
    """Uniform residues < p_i, int32 [npr, R, N, G]."""
    npr = shape[0]
    x = torch.randint(0, 1 << 31, shape, generator=gen, device=device)
    return torch.remainder(x, prime_column(npr, device)[:, :, None, None]).to(torch.int32)


def check_ntt_bm(gen, device, usage: list[str], rate: dict, shapes=tuple(NTT_BM_SHAPES), timed=tuple(NTT_BM_TIMED),
                 plain_at=(NTT_BM_SHAPES[0], NTT_BM_SHAPES[1])) -> dict:
    """Batch-minor kernel vs plain version on the card at `shapes`, each
    shape through the instances that serve it (named with what ptxas said of
    them; none may spill); both directions timed on the device at `timed`
    with their bounds, the plain version and the wrapper's call as the host
    enqueues it at `plain_at` (forward at the first, inverse at the second:
    the CGGI pair by default)."""
    err = {"fwd": 0, "inv": 0}
    notes = {}
    for shape in shapes:
        npr, rows, n, gates = shape
        plan = make_plan(n, npr)
        x = _bm_residues(gen, shape, device)
        fk = kntt.fwd_ntt_bm(x, plan)
        ik = kntt.inv_ntt_bm(fk, plan)
        torch.cuda.synchronize()
        err["fwd"] = max(err["fwd"], _max_abs_diff(fk, kntt.ntt_bm_plain(x, plan, True)))
        err["inv"] = max(err["inv"], _max_abs_diff(ik, kntt.ntt_bm_plain(fk, plan, False)))
        if not torch.equal(ik, x):
            raise SystemExit(f"batch-minor NTT round trip failed at {shape}")
        for forward in (True, False):
            kernel = kntt.bm_kernel(n, npr, rows, gates, forward)
            notes.setdefault(kernel["name"], instance_note(kernel, usage, must_not_spill=True))
    for d in ("fwd", "inv"):
        if err[d] > TOLERANCE:
            raise SystemExit(f"batch-minor NTT {d} kernel disagrees with its plain version: max |diff| {err[d]}")
    times = time_bm_shapes(gen, device, timed)
    rows = {shape: {
        d: {"ms": times[shape][k], **ntt_bm_bound(shape, d == "fwd", rate)} for k, d in enumerate(("fwd", "inv"))
    } for shape in timed}
    plain, enqueued = {}, {}
    for d, shape, wrapper, forward in (("fwd", plain_at[0], kntt.fwd_ntt_bm, True),
                                       ("inv", plain_at[1], kntt.inv_ntt_bm, False)):
        plan = make_plan(shape[2], shape[0])
        x = _bm_residues(gen, shape, device)
        kntt.ntt_bm_plain(x, plan, forward)  # warm-up
        plain[d] = _sync_ms(lambda: kntt.ntt_bm_plain(x, plan, forward), 5)
        enqueued[d] = _sync_ms(lambda: wrapper(x, plan), 50)
    return {"err": err, "times": times, "rows": rows, "plain": plain, "enqueued": enqueued,
            "notes": list(notes.values())}


def ntt_bm_bound(shape, forward: bool, rate: dict) -> dict:
    """As ntt_bound: a batch-minor tensor [npr, R, N, G] holds R * G
    polynomials per prime."""
    npr, r, n, g = shape
    return ntt_bound((r * g, npr, n), forward, rate)


def bm_times_line(res: dict) -> str:
    """Phase 10's times: each shape and direction, device ms against its
    bounds and the share of the bound reached."""
    out = []
    for shape, by_d in res["rows"].items():
        for d, r in by_d.items():
            out.append(f"{d} {list(shape)} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} by {r['bound_by']}, "
                       f"{r['bound_ms'] / r['ms']:.0%} reached; canonical count "
                       f"{r['bound_ms_canonical_radix2']:.4f}, butterflies alone {r['butterflies_only_ms']:.4f})")
    return "; ".join(out)


def step_bound(params, ctx, g: int, steps: int, tildea: torch.Tensor, rate: dict) -> dict:
    """Least time of `steps` CGGI steps on `g` gates on the card.  Bytes: the
    accumulator read and written, the rotation amounts, the steps' key rows,
    the twiddles, and the monomial images that these amounts select, each
    once.  Operations: `sweep_step_ops` on the 2^32 torus with, per position,
    the external product and the monomial product, and one add to accumulate
    (the kernel runs several CTAs an SM: the butterflies' rate at full
    occupancy)."""
    n, npr, l = ctx.n, ctx.nprimes, params.l_gsw
    nbytes = (2 * g * 2 * n * 4 + g * steps * 4 + steps * npr * 2 * l * 2 * n * 4 + 4 * npr * n * 4
              + int(torch.unique(tildea[:, :steps]).numel()) * npr * n * 4)
    product = 2 * (2 * l * OPS_PRODUCT_TERM + OPS_BARRETT) + 2 * (OPS_PRODUCT_TERM + OPS_BARRETT)
    return sweep_bounds(nbytes, g * steps, n, npr, l, product, 1, rate, torus_bits=32, occupancy="full")


# a small set of no preset's shape, with a 32-bit gadget: it runs the step
# kernel with run-time shapes
STEP_RUN_TIME = dataclasses.replace(CGGI_PARAM, n=CHECK_STEPS, big_n=512, l_gsw=2, log_b_gsw=16)


def check_step_run_time_shapes(gen, device) -> int:
    """The step kernel with run-time shapes vs its plain version on uniform
    residues at STEP_RUN_TIME with 3 primes; returns max |diff|."""
    params = STEP_RUN_TIME
    ctx = make_ring_ctx(params.big_n, 32, 3)
    n, npr, l = ctx.n, ctx.nprimes, params.l_gsw
    if not fused_step.step_kernel(params, ctx)["run_time_shapes"]:
        raise SystemExit(f"{params} should run the step kernel with run-time shapes")
    brk = _residues(gen, (params.n * 2 * l * 2, npr, n), device).reshape(params.n, 2 * l, 2, npr, n)
    brk = brk.permute(0, 3, 1, 2, 4).contiguous()
    mono = kms.monomial_table(ctx, device)
    tildea = torch.randint(0, 2 * n, (5, params.n), generator=gen, device=device, dtype=torch.int32)
    acc = torch.randint(-(1 << 31), 1 << 31, (5, 2, n), generator=gen, device=device, dtype=torch.int32)
    got = fused_step.cggi_step(acc, tildea, brk, mono, params, ctx)
    want = acc
    for i in range(params.n):
        want = fused_step.cggi_step_plain(want, brk[i], tildea[:, i], mono, params, ctx)
    torch.cuda.synchronize()
    err = _max_abs_diff(got, want)
    if err > TOLERANCE:
        raise SystemExit(f"the step kernel with run-time shapes disagrees with its plain version: max |diff| {err}")
    return err


def check_step(gen, params, bm, g: int, rate: dict) -> dict:
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
        "one_step_ms": device_ms(lambda: fused_step.cggi_step(acc, tildea, *keys, 0, 1), 20,
                                 fused_step.step_kernel(params, ctx)["name"]),
        "plain_ms": _sync_ms(lambda: plain(acc, 0, params.n), 1),
        "plain_step_ms": _sync_ms(lambda: plain(acc, 0, 1), 5),
        "one_step_bound_ms": step_bound(params, ctx, g, 1, tildea, rate)["bound_ms"],
        **step_bound(params, ctx, g, params.n, tildea, rate),
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


def run_mx2(gen, device, smi: str, binary: dict, usage: dict, rate: dict, ntt_rows: list[dict],
            bm_rows: list[dict], bm_times: dict, state: dict) -> list[dict]:
    """Phases 15-18: the KMS path on mx-domain keys with its kernel, and the
    KMS batch-minor engine; returns the mx sweep's row of the kernels line
    and adds the natural NTT's launches on `bootstrap_mx2` by shape to its
    rows (`ntt_rows`), the batch-minor NTT's on `kms.bootstrap_bm` to its
    (`bm_rows`, with phase 10's times `bm_times`); the keys and the output of
    `bootstrap_mx2` go into `state`."""
    params = KMS_8PARTY
    lwe_keys, party_keys = binary["lwe_keys"], binary["party_keys"]
    # 15. the mx engine's set-up: a scheme without brk_hat, holding the mx
    # image (the sharded path's MxKmsKeys view the same tensor)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.time()
    mx_scheme = fused_mx2.setup(binary["crs"], party_keys, params)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    mx_keys = fused_mx2.MxKmsKeys(brk_mx=mx_scheme.brk_mx)
    wide_keys = fused_mx2.build_mx_kms_keys(binary["wide_party_keys"], WIDE_GADGET)
    crs = kms.crs(gen, SIX_DIGITS)
    six_keys = fused_mx2.build_mx_kms_keys(
        [kms.party_keygen(gen, crs, SIX_DIGITS)[3] for _ in range(SIX_DIGITS.k)], SIX_DIGITS, SIX_DIGITS_PRIMES,
    )
    print(
        f"[15 mx keys] fused_mx2.setup on the KMS8party party keys: brk_mx "
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
    rows3 = {
        "err": max(err3, err1, err_wide, err_six),
        **timed_whole(fused_mx2.mx_sweep, fused_mx2.mx_sweep_plain, args3, "mx sweep kernel (KMS8party)"),
        **mx_sweep_bound(params, args3[4], BATCH, params.l_lev, args3[0], rate),
    }
    row1_ms = timed_whole(fused_mx2.mx_sweep, None, args1, "")["ms"]
    notes = [
        instance_note(
            fused_mx2.mx_kernel(p, make_ring_ctx(p.big_n, p.ring_torus_bits, keys.brk_mx.shape[2])),
            usage["mx_sweep"], must_not_spill=p is params,
        )
        for p, keys in ((params, mx_keys), (WIDE_GADGET, wide_keys), (SIX_DIGITS, six_keys))
    ]
    print(
        f"[16 mx sweep] bit-exact vs plain version (tolerance {TOLERANCE}) over {CHECK_STEPS} steps on "
        f"real mx keys (and over all {params.n} steps at rows=3): KMS8party width at G={BATCH} with rows=3 "
        f"and rows=1 through {notes[0]}, wide gadget "
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

    # 17. this slice's main path, on the scheme of phase 15 (no brk_hat):
    # counts reset just before it, read just after
    lean = kms.drop_brk(binary["scheme"])

    def decrypt(out):
        return lwe_decrypt_bit_mk(out, lwe_keys)

    ct, c2, m1, m2 = binary["ct"], binary["c2"], binary["m1"], binary["m2"]
    torch.cuda.synchronize()
    reset_launches()
    boot = bootstrap_chain(fused_mx2.bootstrap_mx2, ct, c2, m1, m2, params, decrypt, mx_scheme, CHAIN)
    launches = read_launches()
    shapes = (dict(kntt.fwd_ntt_nat.shapes), dict(kntt.inv_ntt_nat.shapes))
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
        fused_mx2.bootstrap_mx2, ct, mx_scheme, params,
        {"mx sweep kernel": "mx_sweep_kernel", "NTT kernels": "ntt_nat_kernel"},
    )
    print(profile_line("17b profile", "bootstrap_mx2", prof, smi))
    by_shape = ntt_by_shape("bootstrap_mx2", *shapes, 1 + CHAIN, time_ntt_shapes(gen, device, set(shapes[0]) | set(shapes[1])))
    print(by_shape_line("17c ntt by shape", by_shape, prof["parts"]["NTT kernels"], smi))
    for row, d in zip(ntt_rows, ("fwd", "inv")):
        row["launches_by_shape"] += [
            {"path": r["path"], "shape": r["shape"], "launches": r[d], "ms": r[f"{d}_ms"]} for r in by_shape]
    graph_path(state, "bootstrap_mx2", "KMS8party", fused_mx2.bootstrap_mx2, mx_scheme, params, ct, c2, m1, m2,
               decrypt, {"out": boot["first"], "next": boot["second"], "ms": dt * 1e3, "how": f"eager chain of {CHAIN}",
                         "synced": CHAIN, "busy_ms": prof["device_ms"]},
               {"mx sweep kernel": "mx_sweep_kernel", "NTT kernels": "ntt_nat_kernel"}, smi)

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
    bm_shapes = (dict(kntt.fwd_ntt_bm.shapes), dict(kntt.inv_ntt_bm.shapes))
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
    profile_bm(gen, device, "18b", "kms.bootstrap_bm", bootstrap_bm, ct, lean, params, bm_shapes, bm_times, bm_rows, smi)
    graph_path(state, "kms.bootstrap_bm", "KMS8party", kms.bootstrap_bm, lean, params, ct, c2, m1, m2, decrypt,
               {"out": boot["first"], "synced": 0},
               {"batch-minor NTT kernel": "ntt_bm_kernel", "NTT kernels": "ntt_nat_kernel"}, smi, extra=(bm_keys,),
               chain=1)
    state["mx2"] = {"lean": lean, "mx_keys": mx_keys, "mx_scheme": mx_scheme, "bm_keys": bm_keys,
                    "out": boot["first"], "chain_s": dt, "sweeps_ms": prof["parts"]["mx sweep kernel"]}
    state["noise"].append(("bootstrap_mx2 [17]", "KMS8party", boot["first"], lwe_keys, ~(m1 & m2)))

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


def run_kms(gen, device, smi: str, usage: dict, rate: dict, state: dict) -> tuple[list[dict], dict]:
    """Phases 3-9: the KMS paths and their kernels; returns their rows of
    the kernels line, and the KMS8party keys, ciphertext and `bootstrap_mx3`
    output that the later phases go on from; the KMS8partyblock keys,
    ciphertext and output go into `state` for phases 24-26."""
    # 3. NTT kernel vs plain version
    ntt = check_ntt(gen, device, usage["ntt"])
    (kf, pf), (ki, pi) = ntt["times"]["fwd"], ntt["times"]["inv"]
    bounds = {d: ntt_bound(NTT_SHAPES[0], d == "fwd", rate) for d in ("fwd", "inv")}
    print(
        f"[3 ntt] bit-exact vs plain version at {NTT_SHAPES} and at 5 rows of every N from 64 to "
        f"2048 over 2, 3 and 4 primes (tolerance {TOLERANCE}), through "
        + "; ".join(ntt["notes"]) + f"; at {list(NTT_SHAPES[0])}: fwd kernel {kf:.4f} ms vs plain "
        f"{pf:.3f} ms ({bounds_note(bounds['fwd'], 4)}), inv kernel {ki:.4f} ms vs plain {pi:.3f} ms "
        f"({bounds_note(bounds['inv'], 4)}) ({smi})"
    )

    # 4. keygen
    params = KMS_8PARTY_BLOCK
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    lwe_keys, scheme, _, _ = keygen(gen, params)
    torch.cuda.synchronize()
    block_s = time.time() - t0
    t0 = time.time()
    bin_keys, bin_scheme, bin_party_keys, bin_crs = keygen(gen, KMS_8PARTY)
    _, wide_scheme, wide_party_keys, _ = keygen(gen, WIDE_GADGET)
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
    sweeps = check_sweeps(gen, params, scheme, SWEEPS_GATES, rate)
    err_run_time = check_run_time_shapes(gen, device)
    notes = [
        instance_note(fused_mx3.sweep_kernel(p, kms._ctx(p)), usage["phase1_sweep"],
                      must_not_spill=p is not WIDE_GADGET)
        for p in (params, KMS_8PARTY, WIDE_GADGET)
    ]
    print(
        f"[5 sweep] bit-exact vs plain version (tolerance {TOLERANCE}) over {CHECK_STEPS} steps (and over "
        f"all steps at rows=3 where the plain version is timed): "
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
    print(f"[5b sweeps] KMS8partyblock, {sweeps_note(sweeps, params)} ({smi})")
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
    shapes = (dict(kntt.fwd_ntt_nat.shapes), dict(kntt.inv_ntt_nat.shapes))
    if min(launches[k] for k in ("sweep", "fwd", "inv")) == 0:
        raise SystemExit(f"bootstrap_mx3 did not launch every kernel of its path: {launches}")
    if (launches["sweep"], launches["parties"]) != (1 + CHAIN, (1 + CHAIN) * params.k):
        raise SystemExit(f"bootstrap_mx3: expected one sweep launch of {params.k} parties a bootstrap, got {launches}")
    dt = boot["batch_s"]
    print(
        f"[6 bootstrap_mx3] KMS8partyblock NAND batch {BATCH}: decrypt OK x{1 + CHAIN}; first "
        f"{boot['first_s']:.2f} s; chain {dt * 1e3:.1f} ms/batch = {BATCH / dt:.2f} boots/s; "
        f"peak allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches in "
        f"{1 + CHAIN} bootstraps: sweep {launches['sweep']} ({launches['parties']} parties), NTT fwd "
        f"{launches['fwd']} inv {launches['inv']} ({smi})"
    )
    prof = profile_bootstrap(
        fused_mx3.bootstrap_mx3, ct, scheme, params,
        {"sweep kernel": "phase1_sweep_kernel", "NTT kernels": "ntt_nat_kernel"},
    )
    print(profile_line("6b profile", "bootstrap_mx3", prof, smi))
    by_shape = ntt_by_shape("bootstrap_mx3", *shapes, 1 + CHAIN, time_ntt_shapes(gen, device, set(shapes[0]) | set(shapes[1])))
    print(by_shape_line("6c ntt by shape", by_shape, prof["parts"]["NTT kernels"], smi))
    graph_path(state, "bootstrap_mx3", "KMS8partyblock", fused_mx3.bootstrap_mx3, scheme, params, ct, c2, m1, m2,
               decrypt, {"out": boot["first"], "next": boot["second"], "ms": dt * 1e3, "how": f"eager chain of {CHAIN}", "synced": CHAIN,
                         "busy_ms": prof["device_ms"]},
               {"sweep kernel": "phase1_sweep_kernel", "NTT kernels": "ntt_nat_kernel"}, smi)

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
    graph_path(state, "kms.bootstrap", "KMS8partyblock", kms.bootstrap, scheme, params, ct, c2, m1, m2, decrypt,
               {"out": ref, "synced": 0}, {"NTT kernels": "ntt_nat_kernel"}, smi, chain=1)

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
    if (bin_launches["sweep"], bin_launches["parties"]) != (1, KMS_8PARTY.k):
        raise SystemExit(f"KMS8party bootstrap_mx3: expected one sweep launch of {KMS_8PARTY.k} parties, "
                         f"got {bin_launches}")
    print(
        f"[8 bootstrap_mx3 binary] KMS8party NAND batch {BATCH}: decrypt OK; {bin_s * 1e3:.1f} ms "
        f"(one bootstrap, host clock to the decrypted bits); launches: sweep "
        f"{bin_launches['sweep']}, NTT fwd {bin_launches['fwd']} inv {bin_launches['inv']} ({smi})"
    )

    state["block"] = {"scheme": scheme, "lwe_keys": lwe_keys, "ct": ct, "out": boot["first"],
                      "want": ~(m1 & m2), "chain_s": dt, "sweeps_ms": prof["parts"]["sweep kernel"]}
    state["noise"].append(("bootstrap_mx3 [6]", "KMS8partyblock", boot["first"], lwe_keys, ~(m1 & m2)))

    # 9. key switch on the card vs the CPU
    check_keyswitch(gen, params, scheme)
    print("[9 keyswitch] 4 gates: card == CPU, bit-exact (float64 limb matmul)")

    rows = [
        kernel_row(name, "ntt.cu", "mktfhe_tpu/kernels/ntt_pallas.py:340", launches[d],
                   ntt["err"][d], *ntt["times"][d], bounds[d])
        for d, name in (("fwd", "ntt_fwd_nat"), ("inv", "ntt_inv_nat"))
    ]
    for row, d in zip(rows, ("fwd", "inv")):
        row["timed_at"] = list(NTT_SHAPES[0])
        row["launches_by_shape"] = [
            {"path": r["path"], "shape": r["shape"], "launches": r[d], "ms": r[f"{d}_ms"]} for r in by_shape]
    rows += [
        kernel_row(name, "phase1_sweep.cu", "mktfhe_tpu/kernels/fused_mx3.py:226", count,
                   max(res["err"], row1["err"], sweep_wide["err"], err_run_time), res["ms"],
                   res["plain_ms"], res)
        for name, res, row1, count in (
            ("phase1_sweep_block", sweep_block, sweep_block1, launches["sweep"]),
            ("phase1_sweep_binary", sweep_bin, sweep_bin1, bin_launches["sweep"]),
        )
    ]
    rows.append(sweeps_row("phase1_sweeps_block", "KMS8partyblock", sweeps, launches, 1 + CHAIN))
    binary = {
        "lwe_keys": bin_keys, "scheme": bin_scheme, "party_keys": bin_party_keys, "crs": bin_crs,
        "wide_party_keys": wide_party_keys, "ct": bct, "c2": bc2, "m1": bm1, "m2": bm2,
        "mx3_out": mx3_out, "sweep_ms": sweep_bin["ms"],
    }
    return rows, binary


def profile_bm(gen, device, tag: str, what: str, bootstrap, ct, keys, params, shapes: tuple, times: dict,
               bm_rows: list[dict], smi: str) -> None:
    """One warm `bootstrap` (named `what`) under torch.profiler: the batch-minor NTT
    kernel's device time and the idle share; its launches by shape (`shapes`:
    the wrappers' counts over one bootstrap) with the time at each (`times`,
    timed here where a shape is missing), added to the kernel's rows of the
    kernels line."""
    prof = profile_bootstrap(bootstrap, ct, keys, params, {"batch-minor NTT kernel": "ntt_bm_kernel"})
    print(profile_line(f"{tag} profile", what, prof, smi))
    times.update(time_bm_shapes(gen, device, (set(shapes[0]) | set(shapes[1])) - set(times)))
    by_shape = ntt_by_shape(what, *shapes, 1, times)
    print(by_shape_line(f"{tag} ntt batch-minor by shape", by_shape, prof["parts"]["batch-minor NTT kernel"],
                        smi, "batch-minor NTT kernel", "[npr, R, N, G]"))
    for row, d in zip(bm_rows, ("fwd", "inv")):
        row["launches_by_shape"] += [
            {"path": r["path"], "shape": r["shape"], "launches": r[d], "ms": r[f"{d}_ms"]} for r in by_shape if r[d]]


def run_cggi(gen, device, smi: str, usage: dict, rate: dict, state: dict) -> tuple[list[dict], dict]:
    """Phases 10-14: the single-key CGGI path and its kernels; returns their
    rows of the kernels line and the batch-minor NTT's times by shape; the
    scheme, ciphertext and `bootstrap_fused` output go into `state`."""
    params = CGGI_PARAM

    # 10. batch-minor NTT kernel vs plain version
    ntt = check_ntt_bm(gen, device, usage["ntt"], rate)
    print(
        f"[10 ntt batch-minor] bit-exact vs plain version at {NTT_BM_SHAPES} [npr, R, N, G] "
        f"(tolerance {TOLERANCE}), through " + "; ".join(ntt["notes"]) + "; on the device: "
        + bm_times_line(ntt) + f"; plain version fwd {ntt['plain']['fwd']:.3f} ms at "
        f"{list(NTT_BM_SHAPES[0])}, inv {ntt['plain']['inv']:.3f} ms at {list(NTT_BM_SHAPES[1])}; per "
        f"call as the host enqueues them {ntt['enqueued']['fwd']:.4f} / {ntt['enqueued']['inv']:.4f} ms ({smi})"
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
    step = check_step(gen, params, bm, CGGI_BATCH, rate)
    step["err"] = max(step["err"], check_step_run_time_shapes(gen, device))
    note = instance_note(fused_step.step_kernel(params, cggi._ctx(params)), usage["cggi_step"], must_not_spill=True)
    run_time = fused_step.step_kernel(STEP_RUN_TIME, make_ring_ctx(STEP_RUN_TIME.big_n, 32, 3))
    print(
        f"[12 cggi step] bit-exact vs plain version (tolerance {TOLERANCE}) on real keys at G="
        f"{CGGI_BATCH} through {note}: one step, the last {CHECK_STEPS} steps, and all {params.n}; and "
        f"through {run_time['name']} at N={STEP_RUN_TIME.big_n}, l_gsw={STEP_RUN_TIME.l_gsw}, "
        f"log_b_gsw={STEP_RUN_TIME.log_b_gsw}, 3 primes, G=5; one step: kernel "
        f"{step['one_step_ms']:.4f} ms on the device vs plain {step['plain_step_ms']:.3f} ms (bound "
        f"{step['one_step_bound_ms']:.4f} ms); all {params.n} steps: one launch {step['ms']:.2f} ms, "
        f"one launch per step {step['stepwise_ms']:.2f} ms, plain steps {step['plain_ms']:.1f} ms "
        f"({bounds_note(step)}) ({smi})"
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
    graph_path(state, "bootstrap_fused", "CGGI", fused_step.bootstrap_fused, bm, params, ct, c2, m1, m2, decrypt,
               {"out": boot["first"], "next": boot["second"], "ms": dt * 1e3, "how": f"eager chain of {CHAIN}", "synced": CHAIN,
                "busy_ms": prof["device_ms"]}, {"step kernel": "cggi_step_kernel"}, smi)
    state["cggi"] = {"scheme": scheme, "ct": ct, "out": boot["first"]}
    state["noise"].append(("bootstrap_fused [13]", "CGGI", boot["first"], [lwe_key], ~(m1 & m2)))

    # 14. the other two engines on the same ciphertext: same bits
    want = ~(m1 & m2)
    seconds, counts, shapes = {}, {}, {}
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
        shapes[name] = (dict(kntt.fwd_ntt_bm.shapes), dict(kntt.inv_ntt_bm.shapes))
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
                   ntt["err"][d], ntt["rows"][shape][d]["ms"], ntt["plain"][d], ntt["rows"][shape][d])
        for d, name, shape in (("fwd", "ntt_fwd_bm", NTT_BM_SHAPES[0]), ("inv", "ntt_inv_bm", NTT_BM_SHAPES[1]))
    ]
    for row, shape in zip(rows, NTT_BM_SHAPES):
        row["timed_at"] = list(shape)
        row["launches_by_shape"] = []
    profile_bm(gen, device, "14b", "bootstrap_bm", batchminor.bootstrap_bm, ct, bm, params, shapes["bootstrap_bm"],
               ntt["times"], rows, smi)
    for name, bootstrap, keys, kernel in (("bootstrap_bm", batchminor.bootstrap_bm, bm, "ntt_bm_kernel"),
                                          ("cggi.bootstrap", cggi.bootstrap, scheme, "ntt_nat_kernel")):
        graph_path(state, name, "CGGI", bootstrap, keys, params, ct, c2, m1, m2, decrypt,
                   {"out": boot["first"], "synced": 0}, {"NTT kernels": kernel}, smi)
    rows.append(kernel_row(
        "cggi_step", "cggi_step.cu", "mktfhe_tpu/kernels/fused_step.py:86", launches["step"],
        step["err"], step["ms"], step["plain_ms"], step,
    ))
    return rows, ntt["times"]


def scheme_bytes(obj) -> int:
    """Bytes of every tensor field of a scheme dataclass or key tuple."""
    fields = obj._asdict().values() if hasattr(obj, "_asdict") else (
        getattr(obj, f.name) for f in dataclasses.fields(obj))
    return sum(t.numel() * t.element_size() for t in fields)


def check_cpu_path(bootstrap, ct, out, scheme, params, what: str, state: dict) -> None:
    """Queue the check that the first CPU_GATES gates of `ct` bootstrapped on
    the CPU (every kernel wrapper runs its plain version there) give the
    card's bits `out`: the gates, the scheme and those bits are copied to
    the host now; `cpu_checks_beside` runs the CPU bootstraps while the main
    process only waits for the ranks of phases 26 and 31."""
    cpu_scheme = dataclasses.replace(scheme, **{f.name: getattr(scheme, f.name).cpu()
                                                for f in dataclasses.fields(scheme)})
    state["cpu_checks"].append((what, bootstrap, Lwe(b=ct.b[:CPU_GATES].cpu(), a=ct.a[:CPU_GATES].cpu()),
                                Lwe(b=out.b[:CPU_GATES].cpu(), a=out.a[:CPU_GATES].cpu()), cpu_scheme, params))


def cpu_checks_beside(state: dict, run, smi: str) -> None:
    """run() with the queued CPU-path checks (`check_cpu_path`) in a thread of
    CPU_CHECK_THREADS beside it, then their line; fails if a card's bits
    differ from the CPU path's or a check raised.  run() is phases 26 and 31,
    where the main process waits for its ranks: their host time is shared
    with these checks, and their ms are bits and wiring, not scaling
    numbers, as their lines say."""
    done, errors = [], []

    def checks():
        try:
            for what, bootstrap, ct, want, scheme, params in state["cpu_checks"]:
                t0 = time.time()
                got = bootstrap(ct, scheme, params)
                done.append((what, torch.equal(got.b, want.b) and torch.equal(got.a, want.a), time.time() - t0))
        except BaseException as err:  # raised again below, in the main thread
            errors.append(err)

    threads = torch.get_num_threads()
    torch.set_num_threads(CPU_CHECK_THREADS)
    thread = threading.Thread(target=checks)
    t0 = time.time()
    thread.start()
    try:
        run()
    finally:
        thread.join()
        torch.set_num_threads(threads)
    if errors:
        raise SystemExit(f"a CPU-path check raised: {errors[0]!r}")
    differ = [what for what, same, _ in done if not same]
    if differ or len(done) != len(state["cpu_checks"]):
        raise SystemExit(f"the card's first {CPU_GATES} gates differ from the CPU path's: {differ}")
    print(f"[19-20 cpu] the first {CPU_GATES} gates of each path bootstrapped on the CPU (the plain versions), beside "
          f"phases 26 and 31 ({CPU_CHECK_THREADS} threads, done {time.time() - t0:.1f} s after they started): == the "
          f"card's, bit for bit: " + ", ".join(f"{what} ({s:.1f} s)" for what, _, s in done) + f" ({smi})")


def gate_path_ntt_shapes() -> set[tuple]:
    """[rows, npr, N] of every natural NTT launch of phases 19 and 20: per
    LMSS block the accumulator's digits forward and the block's sum back;
    per CCS step of party p1 the digits of components 0..p1 forward, v and
    e back, and the digit sum of G^-1(v) forward."""
    p = BLOCK_PARAM
    out = {(LMSS_BATCH * (p.k + 1) * rows, p.nprimes, p.big_n) for rows in (p.l_gsw, 1)}
    for p in (CCS_2PARTY_TIGHT, CCS_4PARTY_TIGHT) + tuple(params for _, params in CCS_PARTIES):
        out |= ccs_ntt_shapes(p)
    return out


def ccs_ntt_shapes(p) -> set[tuple]:
    """[rows, npr, N] of the natural NTT's launches in one `ccs.bootstrap` of
    CCS_BATCH gates at preset p (`gate_path_ntt_shapes`)."""
    return {(CCS_BATCH * p.l_uni, p.nprimes, p.big_n)} | {
        (CCS_BATCH * (p1 + 1) * rows, p.nprimes, p.big_n) for p1 in range(1, p.k + 1) for rows in (p.l_uni, 1)}


def ntt_bounds_note(by_shape: list[dict], rate: dict) -> str:
    """Each shape and direction of `ntt_by_shape`'s rows: launches a
    bootstrap, the time, and the bound (`ntt_bound`) with the share of it
    reached."""
    parts = []
    for r in by_shape:
        for d in ("fwd", "inv"):
            if r[d]:
                b = ntt_bound(tuple(r["shape"]), d == "fwd", rate)
                parts.append(f"{d} {r['shape']} x{r[d]:g} {r[d + '_ms']:.4f} ms (bound {b['bound_ms']:.4f} by "
                             f"{b['bound_by']}, {b['bound_ms'] / r[d + '_ms']:.0%} reached)")
    return "; ".join(parts)


def ntt_path(tag: str, path: str, preset: str, bootstrap, ct, c2, m1, m2, scheme, params, decrypt,
             batch: int, per_bootstrap: int, times: dict, rate: dict, ntt_rows: list[dict], smi: str,
             state: dict) -> Lwe:
    """A path whose every NTT goes through the natural NTT kernel: a
    decrypt-checked bootstrap and a chain of GATE_CHAIN more (counts reset
    just before, read just after: `per_bootstrap` forward and as many inverse
    launches a bootstrap, and no other kernel), its first CPU_GATES gates
    against the CPU path, one warm bootstrap under torch.profiler, and the
    kernel's launches by shape x the time at each (`times`, taken
    beforehand) against the profile, and each shape's time against its bound
    (`ntt_bound`), added to its rows of the kernels line (`ntt_rows`); then
    the same bootstrap as a CUDA graph (phase 33, `graph_path`).  Returns
    the first bootstrap's output."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    boot = bootstrap_chain(bootstrap, ct, c2, m1, m2, params, decrypt, scheme, GATE_CHAIN)
    launches = read_launches()
    shapes = (dict(kntt.fwd_ntt_nat.shapes), dict(kntt.inv_ntt_nat.shapes))
    peak = torch.cuda.max_memory_allocated()
    runs = 1 + GATE_CHAIN
    others = {k: v for k, v in launches.items() if k not in ("fwd", "inv") and v}
    if launches["fwd"] != runs * per_bootstrap or launches["inv"] != runs * per_bootstrap or others:
        raise SystemExit(f"{path}: expected {per_bootstrap} + {per_bootstrap} natural NTT launches a bootstrap and no "
                         f"other kernel, got {launches} in {runs} bootstraps")
    check_cpu_path(bootstrap, ct, boot["first"], scheme, params, path, state)
    dt = boot["batch_s"]
    print(
        f"[{tag}] {path} NAND batch {batch}: decrypt OK x{runs}; first {boot['first_s'] * 1e3:.1f} ms; "
        f"chain {dt * 1e3:.1f} ms/batch = {batch / dt:.2f} boots/s; peak allocated {peak / 1e9:.3f} GB; "
        f"natural NTT launches in {runs} bootstraps fwd {launches['fwd']} inv {launches['inv']}; first "
        f"{CPU_GATES} gates against the CPU path's in line [19-20 cpu] ({smi})"
    )
    missing = (set(shapes[0]) | set(shapes[1])) - set(times)
    if missing:
        raise SystemExit(f"{path} launched the natural NTT at shapes not timed beforehand: {sorted(missing)}")
    prof = profile_bootstrap(bootstrap, ct, scheme, params, {"NTT kernels": "ntt_nat_kernel"})
    print(profile_line(f"{tag}b profile", path, prof, smi))
    print(f"[{tag}b idle] unprofiled, the device is busy {prof['device_ms']:.1f} ms of the chain's "
          f"{dt * 1e3:.1f} ms a batch: idle share {max(0.0, 1 - prof['device_ms'] / (dt * 1e3)):.3f} ({smi})")
    by_shape = ntt_by_shape(path, *shapes, runs, times)
    print(by_shape_line(f"{tag}c ntt by shape", by_shape, prof["parts"]["NTT kernels"], smi))
    print(f"[{tag}d ntt bounds] " + ntt_bounds_note(by_shape, rate) + f" ({smi})")
    for row, d in zip(ntt_rows, ("fwd", "inv")):
        row["launches_by_shape"] += [
            {"path": r["path"], "shape": r["shape"], "launches": r[d], "ms": r[f"{d}_ms"]} for r in by_shape if r[d]]
    graph_path(state, path.removesuffix(f" {preset}"), preset, bootstrap, scheme, params, ct, c2, m1, m2, decrypt,
               {"out": boot["first"], "next": boot["second"], "ms": dt * 1e3, "how": f"eager chain of {GATE_CHAIN}", "synced": GATE_CHAIN,
                "busy_ms": prof["device_ms"]}, {"NTT kernels": "ntt_nat_kernel"}, smi)
    return boot["first"]


def run_lmss(gen, smi: str, times: dict, rate: dict, ntt_rows: list[dict], state: dict) -> None:
    """Phase 19: the LMSS gate bootstrap on preset Block (d = 229 blocks of
    ell = 3), keygen on the card, then `ntt_path`: 229 forward and 229
    inverse launches a bootstrap, one of each a block."""
    params = BLOCK_PARAM
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.time()
    lwe_key, _, scheme = lmss.setup(gen, params)
    torch.cuda.synchronize()
    print(
        f"[19 lmss keygen] Block (d={params.d}, ell={params.ell}, n={params.n}, N={params.big_n}, "
        f"l_gsw={params.l_gsw}, log_b_gsw={params.log_b_gsw}, npr={params.nprimes}): setup in "
        f"{time.time() - t0:.2f} s; scheme {scheme_bytes(scheme) / 1e6:.1f} MB; peak allocated above what "
        f"was held before {(torch.cuda.max_memory_allocated() - before) / 1e9:.3f} GB ({smi})"
    )
    ct, c2, m1, m2 = cggi_gate_inputs(gen, params, lwe_key, LMSS_BATCH)
    out = ntt_path("19", "lmss.bootstrap", "Block", lmss.bootstrap, ct, c2, m1, m2, scheme, params,
                   lambda out: lwe_decrypt_bit(out, lwe_key), LMSS_BATCH, params.d, times, rate, ntt_rows, smi,
                   state)
    state["noise"].append(("lmss.bootstrap [19]", "Block", out, [lwe_key], ~(m1 & m2)))


def ccs_keygen(gen, params) -> tuple:
    """crs, k party keygens and setup on the generator's device: the LWE
    keys, the scheme, the seconds and the peak allocated above what was held
    before."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.time()
    a = ccs.crs(gen, params)
    parties = [ccs.party_keygen(gen, a, params) for _ in range(params.k)]
    scheme = ccs.setup(a, [p[2] for p in parties], params)
    torch.cuda.synchronize()
    return [p[0] for p in parties], scheme, time.time() - t0, torch.cuda.max_memory_allocated() - before


def run_ccs(gen, smi: str, times: dict, rate: dict, ntt_rows: list[dict], state: dict) -> None:
    """Phase 20: the CCS gate bootstrap on CCS2partyTight and CCS4partyTight
    (keygen on the card, then `ntt_path`: 2 * k * n forward and as many
    inverse launches a bootstrap, two of each a step), then once on
    CCS8partyTight, decrypt-checked (its relinearisation contracts 9 * 10 =
    90 digit products through the components' digit sum); all at CCS_BATCH."""
    batch = CCS_BATCH
    for name, params in (("CCS2partyTight", CCS_2PARTY_TIGHT), ("CCS4partyTight", CCS_4PARTY_TIGHT),
                         ("CCS8partyTight", CCS_8PARTY_TIGHT)):
        lwe_keys, scheme, keygen_s, peak = ccs_keygen(gen, params)
        print(
            f"[20 ccs keygen] {name} (k={params.k}, n={params.n}, N={params.big_n}, l_uni={params.l_uni}, "
            f"log_b_uni={params.log_b_uni}, npr={params.nprimes}): crs, {params.k} party keygens and setup "
            f"in {keygen_s:.2f} s; scheme {scheme_bytes(scheme) / 1e6:.1f} MB; peak allocated above "
            f"what was held before {peak / 1e9:.3f} GB ({smi})"
        )
        ct, c2, m1, m2 = gate_inputs(gen, params, lwe_keys, batch)

        def decrypt(out):
            return lwe_decrypt_bit_mk(out, lwe_keys)

        if params is not CCS_8PARTY_TIGHT:
            out = ntt_path("20", f"ccs.bootstrap {name}", name, ccs.bootstrap, ct, c2, m1, m2, scheme,
                           params, decrypt, batch, 2 * params.k * params.n, times, rate, ntt_rows, smi, state)
            state["noise"].append(("ccs.bootstrap [20]", name, out, lwe_keys, ~(m1 & m2)))
            continue
        reset_launches()
        t0 = time.time()
        checked_bootstrap(ccs.bootstrap, ct, ~(m1 & m2), scheme, params, decrypt, f"ccs.bootstrap {name}")
        launches = read_launches()
        if launches["fwd"] != 2 * params.k * params.n or launches["inv"] != launches["fwd"]:
            raise SystemExit(f"ccs.bootstrap {name}: unexpected natural NTT launches {launches}")
        print(
            f"[20 ccs.bootstrap {name}] NAND batch {batch}: decrypt OK; one "
            f"bootstrap {time.time() - t0:.2f} s (host clock to the decrypted bits, no warm-up); natural NTT "
            f"launches fwd {launches['fwd']} inv {launches['inv']} ({smi})"
        )


def run_ccs_parties(gen, device, smi: str, times: dict, rate: dict, ntt_rows: list[dict], state: dict) -> list[dict]:
    """Phase 32: CCS8party and CCS16party at full width, NAND batch
    CCS_BATCH: keygen on the card (crs, k party keygens, setup); one
    decrypt-checked `ccs.bootstrap` and one dependent, timed and
    decrypt-checked (counts reset just before, read just after: 2 k n
    forward and as many inverse natural NTT launches a bootstrap and no
    other kernel); B1's launches by shape x the time at each (`times`, taken
    beforehand) and each shape's bound, added to B1's rows of the kernels
    line; at CCS16party B1 against its plain version at the path's largest
    shape (party 16's digits), whose rows of the kernels line this returns.
    No card-against-CPU check here: at k = 16 it takes minutes of the
    host's CPU (the CPU tests hold these gadgets to the JAX package)."""
    rows = []
    for name, params in CCS_PARTIES:
        lwe_keys, scheme, keygen_s, keygen_peak = ccs_keygen(gen, params)
        ct, c2, m1, m2 = gate_inputs(gen, params, lwe_keys, CCS_BATCH)

        def decrypt(out):
            return lwe_decrypt_bit_mk(out, lwe_keys)

        reset_launches()
        boot, above = with_peak(lambda: bootstrap_chain(ccs.bootstrap, ct, c2, m1, m2, params, decrypt, scheme, 1))
        launches = {k: v for k, v in read_launches().items() if v}
        shapes = (dict(kntt.fwd_ntt_nat.shapes), dict(kntt.inv_ntt_nat.shapes))
        per_bootstrap = 2 * params.k * params.n
        if launches != {"fwd": 2 * per_bootstrap, "inv": 2 * per_bootstrap}:
            raise SystemExit(f"ccs.bootstrap {name}: expected {per_bootstrap} + {per_bootstrap} natural NTT launches "
                             f"a bootstrap and no other kernel, got {launches} in 2 bootstraps")
        if set(shapes[0]) | set(shapes[1]) != ccs_ntt_shapes(params):
            raise SystemExit(f"ccs.bootstrap {name} launched B1 at {sorted(set(shapes[0]) | set(shapes[1]))}, "
                             f"expected {sorted(ccs_ntt_shapes(params))}")
        print(
            f"[32 ccs] {name} (k={params.k}, n={params.n}, N={params.big_n}, l_uni={params.l_uni}, log_b_uni="
            f"{params.log_b_uni}, npr={params.nprimes}; party {params.k}'s relinearisation contracts "
            f"{(params.k + 1) * params.l_uni} digit products): crs, {params.k} party keygens and setup in "
            f"{keygen_s:.2f} s, scheme {scheme_bytes(scheme) / 1e9:.3f} GB, peak allocated above what was held before "
            f"{keygen_peak / 1e9:.3f} GB; NAND batch {CCS_BATCH}: decrypt OK x2, first {boot['first_s']:.2f} s, a "
            f"dependent one {boot['batch_s']:.2f} s a batch = {CCS_BATCH / boot['batch_s']:.2f} boots/s (host clock, "
            f"unprofiled), peak {above / 1e9:.3f} GB above the held keys; natural NTT launches in 2 bootstraps "
            f"fwd {launches['fwd']} inv {launches['inv']} ({per_bootstrap} each way a bootstrap) ({smi})"
        )
        by_shape = ntt_by_shape(f"ccs.bootstrap {name}", *shapes, 2, times)
        total = sum(r["ms_per_bootstrap"] for r in by_shape)
        print(f"[32b ntt by shape] B1 per ccs.bootstrap {name}, a bootstrap by shape [rows, npr, N]: "
              + ntt_bounds_note(by_shape, rate) + f"; launches x time = {total:.1f} ms of the dependent bootstrap's "
              f"{boot['batch_s'] * 1e3:.1f} ms ({smi})")
        for row, d in zip(ntt_rows, ("fwd", "inv")):
            row["launches_by_shape"] += [
                {"path": r["path"], "shape": r["shape"], "launches": r[d], "ms": r[f"{d}_ms"]}
                for r in by_shape if r[d]]
        state["noise"].append(("ccs.bootstrap [32]", name, boot["first"], lwe_keys, ~(m1 & m2)))
        ran = time.time() - state["t_start"]
        if params is CCS_16PARTY and ran > CCS16_GRAPH_BY_S:
            print(f"[33 graph] ccs.bootstrap {name}: not graphed in this run, {ran:.0f} s into the script (more "
                  f"than {CCS16_GRAPH_BY_S} s: the graph would take about 70 s more) ({smi})")
        else:
            graph_path(state, "ccs.bootstrap", name, ccs.bootstrap, scheme, params, ct, c2, m1, m2, decrypt,
                       {"out": boot["first"], "next": boot["second"], "ms": boot["batch_s"] * 1e3,
                        "how": "one dependent eager bootstrap", "synced": 1},
                       {"NTT kernels": "ntt_nat_kernel"}, smi, chain=1)
        if params is CCS_16PARTY:
            big = max(shapes[0])
            ntt = check_ntt_at(gen, device, big, rate)
            print(
                f"[32c ntt at CCS16party] B1 vs plain version at {list(big)} (party {params.k}'s digits): bit-exact "
                f"both ways (tolerance {TOLERANCE}); fwd {ntt['fwd_ms']:.4f} ms vs plain {ntt['fwd_plain_ms']:.2f} "
                f"ms (bound {ntt['fwd_bound']['bound_ms']:.4f} by {ntt['fwd_bound']['bound_by']}), inv "
                f"{ntt['inv_ms']:.4f} ms vs plain {ntt['inv_plain_ms']:.2f} ms (bound "
                f"{ntt['inv_bound']['bound_ms']:.4f} by {ntt['inv_bound']['bound_by']}) ({smi})"
            )
            for d in ("fwd", "inv"):
                row = kernel_row(f"ntt_{d}_nat_ccs16party", "ntt.cu", "mktfhe_tpu/kernels/ntt_pallas.py:340",
                                 launches[d], ntt["err"], ntt[f"{d}_ms"], ntt[f"{d}_plain_ms"], ntt[f"{d}_bound"])
                row.update(preset=name, timed_at=list(big), launches_per_bootstrap=launches[d] // 2)
                rows.append(row)
        del scheme, boot
        torch.cuda.empty_cache()
    return rows


def run_cli(smi: str) -> None:
    """Phase 21: the port's CLI as a user runs it, ChaCha-seeded (no --seed),
    on the card, at Block and CCS2partyTight; each must exit 0 and print OK."""
    root = Path(__file__).resolve().parent
    for preset in ("Block", "CCS2partyTight"):
        cmd = [sys.executable, "-m", "mktfhe_tpu_torch.cli", "--preset", preset, "--trials", "1", "--batch", "8"]
        t0 = time.time()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines or not lines[-1].endswith("OK") or "ChaCha20" not in proc.stdout:
            raise SystemExit(f"{' '.join(cmd[1:])} exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
        print(f"[21 cli] {' '.join(cmd[1:])}: exit 0 in {time.time() - t0:.1f} s; "
              + " | ".join(lines[-3:]) + f" ({smi})")


def party_keygen_lean(gen, params, with_brk: bool, mx: bool, bm: bool = False) -> dict:
    """crs, k party keygens and setup on the card (and the mx keys, and
    after them the batch-minor image of `kms.bootstrap_bm`): the party keys,
    whose torus `brk` a k = 32 party holds 220 MB of, are dropped once the
    key images are built; `setup`, `build_mx_kms_keys` and
    `build_bm_kms_phase1` go party by party.  Returns the LWE keys, the
    scheme, the mx and batch-minor keys, the seconds, the bytes held and the
    peak allocated above what was held before."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.time()
    a = kms.crs(gen, params)
    parties = [kms.party_keygen(gen, a, params) for _ in range(params.k)]
    lwe_keys = [p[0] for p in parties]
    party_keys = [p[3] for p in parties]
    del parties
    scheme = kms.setup(a, party_keys, params, with_brk=with_brk)
    mx_keys = fused_mx2.build_mx_kms_keys(party_keys, params) if mx else None
    bm_keys = batchminor.build_bm_kms_phase1(party_keys, params) if bm else None
    with_party_keys = torch.cuda.memory_allocated() - before
    del party_keys
    torch.cuda.synchronize()
    return {
        "lwe_keys": lwe_keys, "scheme": scheme, "mx_keys": mx_keys, "bm_keys": bm_keys, "s": time.time() - t0,
        "scheme_bytes": scheme_bytes(scheme), "mx_bytes": scheme_bytes(mx_keys) if mx else 0,
        "bm_bytes": scheme_bytes(bm_keys) if bm else 0,
        "party_key_bytes": with_party_keys - (torch.cuda.memory_allocated() - before),
        "peak": torch.cuda.max_memory_allocated() - before,
    }


def with_peak(fn):
    """fn()'s result and the device memory it allocated at its peak above
    what was allocated when it started (its transients and its outputs)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - held


def preset_record(name: str, engine: str, keys: dict, ms: float, above: int, instance: str) -> dict:
    """One row of phase 29b's summary: keygen seconds, the key images' bytes,
    keygen's peak above what was held before it, the bootstrap's ms and its
    peak above the keys it found held, and the instance of its sweeps."""
    return {"preset": name, "engine": engine, "keygen_s": keys["s"],
            "key_gb": (keys["scheme_bytes"] + keys["mx_bytes"]) / 1e9, "keygen_peak_gb": keys["peak"] / 1e9,
            "ms": ms, "above_gb": above / 1e9, "instance": instance}


def keygen_note(name: str, params, keys: dict) -> str:
    return (f"{name} (k={params.k}, n={params.n}, N={params.big_n}, l_gsw={params.l_gsw}, l_uni={params.l_uni}, "
            f"npr={params.ring_nprimes}): crs, {params.k} party keygens, setup"
            + (", build_mx_kms_keys" if keys["mx_keys"] is not None else "")
            + (", build_bm_kms_phase1" if keys["bm_keys"] is not None else "")
            + f" in {keys['s']:.2f} s; scheme {keys['scheme_bytes'] / 1e9:.3f} GB"
            + (f", mx keys {keys['mx_bytes'] / 1e9:.3f} GB" if keys["mx_keys"] is not None else "")
            + (f", batch-minor keys {keys['bm_bytes'] / 1e9:.3f} GB" if keys["bm_keys"] is not None else "")
            + f", party keys dropped after ({keys['party_key_bytes'] / 1e9:.3f} GB); peak allocated above what "
            f"was held before {keys['peak'] / 1e9:.2f} GB")


def served_by(params, mx_keys=None) -> str:
    """The compiled instance that serves the preset's sweep (mx keys: the mx
    sweep's); fails on the kernel with run-time shapes."""
    if mx_keys is None:
        kernel = fused_mx3.sweep_kernel(params, kms._ctx(params))
    else:
        kernel = fused_mx2.mx_kernel(params, make_ring_ctx(params.big_n, params.ring_torus_bits,
                                                           mx_keys.brk_mx.shape[2]))
    if kernel["run_time_shapes"]:
        raise SystemExit(f"{params} runs the kernel with run-time shapes: {kernel['name']}")
    return kernel["name"]


def nat_shapes_note(fwd: dict, inv: dict, runs: int) -> str:
    """The natural NTT's launches a bootstrap by [rows, npr, N], in one line."""
    parts = []
    for d, shapes in (("fwd", fwd), ("inv", inv)):
        items = sorted(shapes.items(), reverse=True)
        parts.append(f"{d} {sum(c for _, c in items) // runs} at {len(items)} shapes (" + ", ".join(
            f"{list(shape)} x{c // runs}" for shape, c in items) + ")")
    return "; ".join(parts)


# phase 27a: the hybrid product kernel at the largest merge of each block
# preset of the benchmark, at its batches (preset, name, merge p1, batch G)
HYBRID_CHECKS = ((KMS_32PARTY_BLOCK, "KMS32partyblock", 32, BATCH), (KMS_8PARTY_BLOCK, "KMS8partyblock", 8, BATCH),
                 (KMS_8PARTY_BLOCK, "KMS8partyblock", 8, 8))


def hybrid_bound(params, ctx, g: int, p1: int) -> dict:
    """Least time of merge p1's hybrid product at batch g on the card.
    Bytes: y read, u and v written, the keys (rd, the crs and p1 - 1 public
    keys) and the twiddles read once each.  Operations, per gate, prime and
    component: l lifted digits a word, l forward transforms in lazy
    butterflies with one canonical reduction a digit, 2 l product terms and
    two Barrett reductions a word; beside it the same counted in canonical
    radix-2 arithmetic (carry-chain digits, canonical butterflies)."""
    n, npr, l = ctx.n, ctx.nprimes, params.l_uni
    nbytes = g * p1 * n * 8 + g * (p1 + 1) * npr * n * 4 + (p1 + 1) * l * npr * n * 4 + 2 * npr * n * 4
    butterflies = l * n // 2 * (n.bit_length() - 1)
    common = l * n * 2 * OPS_PRODUCT_TERM + 2 * n * OPS_BARRETT
    lazy = l * n * (OPS_LIFTED_DIGIT + OPS_CANONICAL) + butterflies * OPS_CT_LAZY + common
    canonical = l * n * OPS_DIGIT + butterflies * OPS_BUTTERFLY + common
    units = g * npr * p1
    return {**_bound(nbytes, units * lazy),
            "bound_ms_canonical_radix2": _bound(nbytes, units * canonical)["bound_ms"]}


def check_hybrid(gen, device, params, name: str, p1: int, g: int, usage: list[str]) -> dict:
    """The hybrid product kernel vs its plain version (`kms._hybrid_product`,
    its digits through B1 in chunks of parties) at merge p1 of the preset,
    batch g, on uniform inputs with the extreme torus words in the first
    component: u and v equal, tolerance 0, in one launch; the kernel's time
    against its bound (`hybrid_bound`)."""
    ctx = kms._ctx(params)
    n, npr, l = ctx.n, ctx.nprimes, params.l_uni
    y = torch.randint(-(1 << 63), (1 << 63) - 1, (g, p1, n), generator=gen, device=device)
    y[0, 0, :4] = torch.tensor([-1, -(1 << 63), (1 << 63) - 1, 0], device=device)
    rd, crs = _residues(gen, (l, npr, n), device), _residues(gen, (l, npr, n), device)
    pub = _residues(gen, ((p1 - 1) * l, npr, n), device).reshape(p1 - 1, l, npr, n)
    args = (y, rd, pub, crs, params, ctx)
    khybrid.reset_launches()
    u, v = khybrid.hybrid_product(*args)
    torch.cuda.synchronize()
    if khybrid.hybrid_product.launches != 1:
        raise SystemExit(f"{name} merge {p1}: the hybrid product took {khybrid.hybrid_product.launches} launches")
    held = {}
    plain_ms = _sync_ms(lambda: held.setdefault("uv", kms._hybrid_product(*args, prime_column(npr, device))), 1)
    want_u, want_v = held.pop("uv")
    err = max(_max_abs_diff(u, want_u), _max_abs_diff(v, want_v))
    if err > TOLERANCE:
        raise SystemExit(f"{name} merge {p1} at G={g}: the hybrid product kernel disagrees with its plain "
                         f"version: max |diff| {err}")
    del u, v, want_u, want_v
    khybrid.hybrid_product(*args)  # warm
    out = {"preset": name, "p1": p1, "g": g, "err": err, "plain_ms": plain_ms,
           "ms": _sync_ms(lambda: khybrid.hybrid_product(*args), 10),
           "instance": instance_note(khybrid.hybrid_kernel(params, ctx), usage, must_not_spill=True),
           **hybrid_bound(params, ctx, g, p1)}
    khybrid.reset_launches()
    torch.cuda.empty_cache()
    return out


def check_ntt_at(gen, device, shape, rate) -> dict:
    """The natural NTT kernel vs its plain version at one large shape [rows,
    npr, N], both ways, bit-exact; the kernel's time against its bound."""
    plan = make_plan(shape[2], shape[1])
    x = _residues(gen, shape, device)
    fk = kntt.fwd_ntt_nat(x, plan)
    held = {}
    fwd_plain_ms = _sync_ms(lambda: held.setdefault("fwd", fwd_ntt(x, plan)), 1)
    err = _max_abs_diff(fk, held.pop("fwd"))
    ik = kntt.inv_ntt_nat(fk, plan)
    inv_plain_ms = _sync_ms(lambda: held.setdefault("inv", inv_ntt(fk, plan)), 1)
    err = max(err, _max_abs_diff(ik, held.pop("inv")))
    torch.cuda.synchronize()
    if err > TOLERANCE or not torch.equal(ik, x):
        raise SystemExit(f"NTT kernel disagrees with its plain version at {shape}: max |diff| {err}")
    out = {"err": err, "fwd_ms": _sync_ms(lambda: kntt.fwd_ntt_nat(x, plan), 5),
           "inv_ms": _sync_ms(lambda: kntt.inv_ntt_nat(fk, plan), 5),
           "fwd_plain_ms": fwd_plain_ms, "inv_plain_ms": inv_plain_ms,
           "fwd_bound": ntt_bound(shape, True, rate), "inv_bound": ntt_bound(shape, False, rate)}
    del x, fk, ik
    torch.cuda.empty_cache()
    return out


def run_k32_block(gen, device, smi: str, usage: dict, rate: dict, state: dict) -> list[dict]:
    """Phase 27: KMS32partyblock at full width (k = 32, d = 203, ell = 3, N =
    2048, 3 primes), NAND batch 128: the hybrid product kernel against its
    plain version (`HYBRID_CHECKS`: merge 32 here, merge 8 of KMS8partyblock
    at batches 128 and 8), timed against its bound; keygen on the card; one party's B2 sweep against its plain
    version over all steps; a dependent chain of PARTY_CHAIN `bootstrap_mx3`
    after the first, every link decrypt-checked; `kms.bootstrap` once on the
    first input, bit-identical; the named-range split; launches of B2 and of
    B1 by shape.  Returns the B2 and hybrid product rows of the kernels
    line."""
    params = KMS_32PARTY_BLOCK
    ctx = kms._ctx(params)
    hybrid = [check_hybrid(gen, device, p, name, p1, g, usage["hybrid_product"]) for p, name, p1, g in HYBRID_CHECKS]
    for h in hybrid:
        print(
            f"[27a hybrid product] {h['preset']} merge {h['p1']} at G={h['g']}: kernel vs plain version "
            f"(kms._hybrid_product) on uniform inputs, u and v bit-exact (max |diff| {h['err']}, tolerance "
            f"{TOLERANCE}), one launch; kernel {h['ms']:.4f} ms vs plain {h['plain_ms']:.2f} ms, bound "
            f"{h['bound_ms']:.4f} ms by {h['bound_by']} in the kernel's arithmetic ({h['bound_ms'] / h['ms']:.1%} "
            f"of it), {h['bound_ms_canonical_radix2']:.4f} ms counted in canonical radix-2 arithmetic; through "
            f"{h['instance']} ({smi})"
        )
    keys = party_keygen_lean(gen, params, with_brk=True, mx=False)
    print(f"[27 keygen] " + keygen_note("KMS32partyblock", params, keys) + f" ({smi})")
    scheme, lwe_keys = keys["scheme"], keys["lwe_keys"]

    sweep = check_sweep(gen, params, scheme, 1, BATCH, params.l_lev, timed=True, rate=rate)
    sweep1 = check_sweep(gen, params, scheme, 0, BATCH, 1, timed=True, plain=False, rate=rate)
    sweeps = check_sweeps(gen, params, scheme, SWEEPS_GATES, rate)
    note = instance_note(fused_mx3.sweep_kernel(params, ctx), usage["phase1_sweep"], must_not_spill=True)
    print(
        f"[27b sweep] KMS32partyblock, one party's B2 sweep at G={BATCH}, rows=3, all {params.d} steps: kernel "
        f"{sweep['ms']:.2f} ms vs plain {sweep['plain_ms']:.1f} ms, bit-exact over all steps (max |diff| "
        f"{sweep['whole_err']}) and over {CHECK_STEPS} steps from the LEV rows at rows=1 too; rows=1 kernel "
        f"{sweep1['ms']:.2f} ms; through {note}; {bounds_note(sweep)} ({smi})"
    )
    print(f"[27b sweeps] KMS32partyblock, {sweeps_note(sweeps, params)} ({smi})")

    def decrypt(out):
        return lwe_decrypt_bit_mk(out, lwe_keys)

    ct, c2, m1, m2 = gate_inputs(gen, params, lwe_keys, BATCH)
    reset_launches()
    boot, above = with_peak(lambda: bootstrap_chain(fused_mx3.bootstrap_mx3, ct, c2, m1, m2, params, decrypt,
                                                    scheme, PARTY_CHAIN))
    launches = read_launches()
    shapes = (dict(kntt.fwd_ntt_nat.shapes), dict(kntt.inv_ntt_nat.shapes))
    runs = 1 + PARTY_CHAIN
    fwd, inv = merge_launches(params)
    want = {"sweep": runs, "parties": runs * params.k, "hybrid": runs * params.k, "fwd": runs * (params.k + fwd),
            "inv": runs * inv}
    if {k: launches[k] for k in want} != want:
        raise SystemExit(f"KMS32partyblock bootstrap_mx3: expected {want} launches in {runs} bootstraps (every "
                         f"party's sweep in one launch, phase 2's hybrid product one kernel a merge), got {launches}")
    dt = boot["batch_s"]
    print(
        f"[27c bootstrap_mx3] KMS32partyblock NAND batch {BATCH}: decrypt OK x{runs} (every link of the chain); "
        f"first {boot['first_s']:.2f} s; chain of {PARTY_CHAIN}: {dt * 1e3:.1f} ms/batch = {BATCH / dt:.2f} "
        f"boots/s; peak allocated {above / 1e9:.2f} GB above the held keys and inputs (phase 2's hybrid product "
        f"one kernel a merge, the key switch a party at a time); "
        f"launches in {runs} bootstraps: B2 {launches['sweep']} "
        f"({launches['sweep'] // runs} a bootstrap of {launches['parties'] // runs} parties, every one through "
        f"{served_by(params)}), B1 fwd "
        f"{launches['fwd']} inv {launches['inv']} ({smi})"
    )
    print(f"[27d ntt by shape] B1 per KMS32partyblock bootstrap_mx3, [rows, npr, N]: "
          + nat_shapes_note(*shapes, runs) + f" ({smi})")
    graph_path(state, "bootstrap_mx3", "KMS32partyblock", fused_mx3.bootstrap_mx3, scheme, params, ct, c2, m1, m2,
               decrypt, {"out": boot["first"], "next": boot["second"], "ms": dt * 1e3, "how": f"eager chain of {PARTY_CHAIN}",
                         "synced": PARTY_CHAIN},
               {"sweep kernel": "phase1_sweep_kernel", "NTT kernels": "ntt_nat_kernel"}, smi)

    reset_launches()
    t0 = time.time()
    ref = checked_bootstrap(kms.bootstrap, ct, ~(m1 & m2), scheme, params, decrypt, "KMS32partyblock kms.bootstrap")
    ref_s = time.time() - t0
    ref_launches = read_launches()
    if not (torch.equal(ref.b, boot["first"].b) and torch.equal(ref.a, boot["first"].a)):
        raise SystemExit("KMS32partyblock: kms.bootstrap and bootstrap_mx3 differ on the same ciphertext")
    if ref_launches["sweep"] != 0:
        raise SystemExit(f"kms.bootstrap launched the sweep kernel: {ref_launches}")
    print(
        f"[27e kms.bootstrap] KMS32partyblock, the chain's first input: decrypt OK, output bit-identical to "
        f"bootstrap_mx3 (b and a); {ref_s:.2f} s (host clock to the decrypted bits); B1 launches fwd "
        f"{ref_launches['fwd']} inv {ref_launches['inv']}, no sweep ({smi})"
    )
    del ref

    timed = timed_ranges(lambda: fused_mx3.bootstrap_mx3(ct, scheme, params))
    # phase 1 is one sweep launch, and profiles after those of 10^5 events
    # lose kernel records now and then (phase 33): a profile without the
    # launch's record is taken again, up to PROFILE_TRIES in all, and what
    # each lost is said; only if every one lost it is the launch on the same
    # input timed alone by CUDA events
    lost = []
    for _ in range(PROFILE_TRIES):
        prof = profile_bootstrap(fused_mx3.bootstrap_mx3, ct, scheme, params, {"sweep kernel": "phase1_sweep_kernel"})
        if prof["parts"]["sweep kernel"] > 0:
            break
        lost.append(f"{prof['events']} device records ({prof['device_ms']:.2f} ms), none of the sweep kernel")
    if prof["parts"]["sweep kernel"] > 0:
        yardstick = (prof["parts"]["sweep kernel"], "the sweep kernel of the same profile")
    else:
        _, tildea = mod_switch_2n(ct, params.big_n)
        alone = _sync_ms(lambda: fused_mx3.kms_phase1_sweeps(tildea, scheme.brk_hat, params.l_lev, scheme.mono_hat,
                                                              params, ctx), 1)
        yardstick = (alone, "the sweep launch on the same input timed alone by CUDA events")
    said = f"; profiles that lost the sweep's record first: {len(lost)} ({'; '.join(lost)})" if lost else ""
    print(ranges_line("27f named ranges", "bootstrap_mx3 KMS32partyblock", params, timed, prof, yardstick)
          + f"{said} ({smi})")
    state["noise"].append(("bootstrap_mx3 [27]", "KMS32partyblock", boot["first"], lwe_keys, ~(m1 & m2)))
    state["parties"].append(
        preset_record("KMS32partyblock", "bootstrap_mx3", keys, dt * 1e3, above, served_by(params)))
    row = kernel_row("phase1_sweep_block_k32", "phase1_sweep.cu", "mktfhe_tpu/kernels/fused_mx3.py:226",
                     launches["sweep"], max(sweep["err"], sweep["whole_err"], sweep1["err"]), sweep["ms"],
                     sweep["plain_ms"], sweep)
    row.update(preset="KMS32partyblock", launches_per_bootstrap=launches["sweep"] // runs)
    sweeps_k32 = sweeps_row("phase1_sweeps_block_k32", "KMS32partyblock", sweeps, launches, runs)
    big = hybrid[0]
    hybrid_row = kernel_row("hybrid_product_block_k32", "hybrid_product.cu",
                            "none: XLA in mktfhe_tpu/schemes/kms.py:305", launches["hybrid"],
                            max(h["err"] for h in hybrid), big["ms"], big["plain_ms"], big)
    hybrid_row.update(preset="KMS32partyblock", launches_per_bootstrap=launches["hybrid"] // runs,
                      timed_at=[big["g"], big["p1"]])
    return [row, sweeps_k32, hybrid_row]


def timed_ranges(run) -> dict:
    """run() (one bootstrap) with its named ranges timed by CUDA events
    (`profiling.event_ranges`): "ranges", ms by name between each range's
    edges less the ranges inside it; "total_ms", the bootstrap's event ms
    from end to end around them; "out", run()'s result."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profiling.event_ranges() as ms:
        start.record()
        out = run()
        end.record()
    return {"ranges": ms, "total_ms": start.elapsed_time(end), "out": out}


def ranges_line(tag: str, what: str, params, timed: dict, prof: dict, sweeps: tuple | None = None) -> str:
    """The split of one warm bootstrap by named range (`timed_ranges`); fails
    unless the ranges add up to RANGE_SHARE of the bootstrap's event ms from
    end to end, and, given `sweeps` (ms, where from), unless phase 1 holds
    PHASE1_OF_SWEEPS of the sweep kernels' profiled ms.  `prof`: a profile of
    the same path (`profile_bootstrap`, `profile_split`): its kernel records'
    total is printed beside, so that a profile that lost records shows as a
    number."""
    ms, total = timed["ranges"], timed["total_ms"]
    share = sum(ms.values()) / total
    if not RANGE_SHARE[0] <= share <= RANGE_SHARE[1]:
        raise SystemExit(f"{what}: the named ranges hold {share:.3f} of the bootstrap's {total:.2f} ms, outside "
                         f"{RANGE_SHARE}: {ms}")
    phase1 = sum(v for k, v in ms.items() if k.startswith("mktfhe/phase1/"))
    merges = [v for k, v in ms.items() if k.startswith("mktfhe/phase2/")]
    check = ""
    if sweeps is not None:
        if sweeps[0] <= 0:
            raise SystemExit(f"{what}: {sweeps[1]} hold no device time to hold phase 1 to")
        if phase1 < PHASE1_OF_SWEEPS * sweeps[0]:
            raise SystemExit(f"{what}: phase 1 reads {phase1:.2f} ms by events, under {PHASE1_OF_SWEEPS} of "
                             f"{sweeps[1]}'s {sweeps[0]:.2f} ms")
        check = f" ({phase1 / sweeps[0]:.3f} of {sweeps[1]}'s {sweeps[0]:.2f} ms)"
    idle = max(0.0, 1 - prof["device_ms"] / prof["wall_ms"])
    return (
        f"[{tag}] {what} batch {BATCH}, one warm bootstrap, {total:.2f} ms by CUDA events from end to end, split by "
        f"CUDA events at the named ranges' edges (a range's ms hold the card's idle gaps inside it: on a "
        f"device-bound path, as here, few): mod_switch {ms['mktfhe/mod_switch']:.3f} ms, phase 1 (sweeps, "
        f"{params.k} parties) {phase1:.2f} ms{check}, levkey_lift {ms['mktfhe/levkey_lift']:.3f} ms, phase 2 "
        f"{sum(merges):.2f} ms (merges 1..{params.k}: " + ", ".join(f"{v:.2f}" for v in merges)
        + f"), keyswitch {ms['mktfhe/keyswitch']:.3f} ms, outside every range {total - sum(ms.values()):.3f} ms; "
        f"the ranges hold {share:.2%}; torch.profiler's kernel records of a bootstrap of the same path "
        f"{prof['device_ms']:.2f} ms (its wall {prof['wall_ms']:.2f} ms, idle share {idle:.3f})"
    )


def run_k32_binary(gen, device, smi: str, usage: dict, rate: dict, state: dict) -> list[dict]:
    """Phase 28: KMS32party at full width (n = 560, 3 primes), NAND batch 128:
    keygen on the card with both key images (`brk_hat` and the mx keys) and
    the batch-minor image; one party's B2 and B5 sweeps against their plain
    versions over all steps; `bootstrap_mx3` once, then a dependent chain of
    PARTY_CHAIN `bootstrap_mx2` after the first on the scheme without
    `brk_hat`, every link decrypt-checked, the first equal to
    `bootstrap_mx3`'s output bit for bit; then phase 30 on the first input,
    and the files of phase 31's four ranks.  Returns the B2, B5 and B4 rows
    of the kernels line."""
    params = KMS_32PARTY
    ctx = kms._ctx(params)
    keys = party_keygen_lean(gen, params, with_brk=True, mx=True, bm=True)
    print(f"[28 keygen] " + keygen_note("KMS32party", params, keys) + f" ({smi})")
    scheme, mx_keys, lwe_keys = keys["scheme"], keys["mx_keys"], keys["lwe_keys"]

    sweep = check_sweep(gen, params, scheme, 1, BATCH, params.l_lev, timed=True, rate=rate)
    err_mx, args_mx = check_mx_sweep(gen, params, mx_keys.brk_mx[1], BATCH, params.l_lev)
    mx = {"err": err_mx, **timed_whole(fused_mx2.mx_sweep, fused_mx2.mx_sweep_plain, args_mx, "mx sweep (KMS32party)"),
          **mx_sweep_bound(params, args_mx[4], BATCH, params.l_lev, args_mx[0], rate)}
    note = instance_note(fused_mx3.sweep_kernel(params, ctx), usage["phase1_sweep"], must_not_spill=True)
    mx_note = instance_note(fused_mx2.mx_kernel(params, args_mx[4]), usage["mx_sweep"], must_not_spill=True)
    print(
        f"[28a sweeps] KMS32party, one party at G={BATCH}, rows=3, all {params.n} steps, bit-exact over all steps "
        f"and over {CHECK_STEPS} from the LEV rows (tolerance {TOLERANCE}): B2 kernel {sweep['ms']:.2f} ms vs plain "
        f"{sweep['plain_ms']:.1f} ms through {note}, {bounds_note(sweep)}; B5 kernel {mx['ms']:.2f} ms vs "
        f"mx_sweep_plain {mx['plain_ms']:.1f} ms ({args_mx[4].nprimes} primes) through {mx_note}, "
        f"{bounds_note(mx)} ({smi})"
    )

    def decrypt(out):
        return lwe_decrypt_bit_mk(out, lwe_keys)

    ct, c2, m1, m2 = gate_inputs(gen, params, lwe_keys, BATCH)
    reset_launches()
    t0 = time.time()
    mx3_out, mx3_above = with_peak(lambda: checked_bootstrap(
        fused_mx3.bootstrap_mx3, ct, ~(m1 & m2), scheme, params, decrypt, "KMS32party bootstrap_mx3"))
    mx3_s = time.time() - t0
    mx3_launches = read_launches()
    if (mx3_launches["sweep"], mx3_launches["parties"], mx3_launches["mx"]) != (1, params.k, 0):
        raise SystemExit(f"KMS32party bootstrap_mx3: expected one B2 launch of {params.k} parties, got {mx3_launches}")
    keys["scheme"] = lean = kms.drop_brk(scheme)  # brk_hat freed
    del scheme
    mx_scheme = fused_mx2.mx_scheme(lean, mx_keys.brk_mx)

    reset_launches()
    boot, above = with_peak(lambda: bootstrap_chain(fused_mx2.bootstrap_mx2, ct, c2, m1, m2, params, decrypt,
                                                    mx_scheme, PARTY_CHAIN))
    launches = read_launches()
    runs = 1 + PARTY_CHAIN
    if launches["mx"] != runs * params.k or launches["sweep"] != 0 or min(launches["fwd"], launches["inv"]) == 0:
        raise SystemExit(f"KMS32party bootstrap_mx2: expected {params.k} B5 sweeps a bootstrap and the NTT "
                         f"kernel, got {launches} in {runs} bootstraps")
    if not (torch.equal(boot["first"].b, mx3_out.b) and torch.equal(boot["first"].a, mx3_out.a)):
        raise SystemExit("KMS32party: bootstrap_mx2 and bootstrap_mx3 differ on the same ciphertext")
    dt = boot["batch_s"]
    print(
        f"[28b bootstrap_mx2] KMS32party NAND batch {BATCH}: bootstrap_mx3 once {mx3_s * 1e3:.1f} ms (host clock "
        f"to the decrypted bits, {mx3_launches['sweep']} B2 launches through {served_by(params)}, peak "
        f"{mx3_above / 1e9:.2f} GB above the held keys); on the scheme "
        f"without brk_hat bootstrap_mx2 decrypt OK x{runs} (every link), its first output bit-identical to "
        f"bootstrap_mx3's (b and a); first {boot['first_s']:.2f} s; chain of {PARTY_CHAIN}: {dt * 1e3:.1f} "
        f"ms/batch = {BATCH / dt:.2f} boots/s; peak allocated {above / 1e9:.2f} GB above the held keys; "
        f"launches in {runs} bootstraps: B5 {launches['mx']} through "
        f"{served_by(params, mx_keys=mx_keys)}, B1 fwd {launches['fwd']} inv {launches['inv']} ({smi})"
    )
    state["noise"].append(("bootstrap_mx2 [28]", "KMS32party", boot["first"], lwe_keys, ~(m1 & m2)))
    state["parties"] += [
        preset_record("KMS32party", "bootstrap_mx3", keys, mx3_s * 1e3, mx3_above, served_by(params)),
        preset_record("KMS32party", "bootstrap_mx2", keys, dt * 1e3, above, served_by(params, mx_keys=mx_keys)),
    ]
    rows = [
        kernel_row("phase1_sweep_binary_k32", "phase1_sweep.cu", "mktfhe_tpu/kernels/fused_mx3.py:226",
                   mx3_launches["sweep"], max(sweep["err"], sweep["whole_err"]), sweep["ms"], sweep["plain_ms"], sweep),
        kernel_row("mx_sweep_binary_k32", "mx_sweep.cu", "mktfhe_tpu/kernels/fused_mx2.py:217", launches["mx"],
                   max(mx["err"], mx["whole_err"]), mx["ms"], mx["plain_ms"], mx),
    ]
    rows[0].update(preset="KMS32party", launches_per_bootstrap=mx3_launches["sweep"])
    rows[1].update(preset="KMS32party", launches_per_bootstrap=launches["mx"] // runs)

    # 30. the batch-minor engine on the chain's first input: B4's rows at the
    # KMS32party shapes of the kernels line
    check = state["bm_check"]
    bm_rows = [
        kernel_row(f"ntt_{d}_bm_kms32party", "ntt.cu", "mktfhe_tpu/kernels/ntt_pallas.py:240", 0, check["err"][d],
                   check["rows"][shape][d]["ms"], check["plain"][d], check["rows"][shape][d])
        for d, shape in zip(("fwd", "inv"), check["k32"])
    ]
    for row, shape in zip(bm_rows, check["k32"]):
        row.update(preset="KMS32party", timed_at=list(shape), launches_by_shape=[])
    bm = run_bootstrap_bm("KMS32party", params, keys, ct, boot["first"], ~(m1 & m2), decrypt, check, smi, bm_rows,
                          profiled=False)
    for row, d in zip(bm_rows, ("fwd", "inv")):
        row.update(launches=bm["launches"][f"{d}_bm"], launches_per_bootstrap=bm["launches"][f"{d}_bm"])
    keys["bm_keys"] = None
    torch.cuda.empty_cache()
    save_shard_case(state, "KMS32party", params, keys, ct, boot["first"], ~(m1 & m2), 4)
    return rows + bm_rows


def run_other_parties(gen, smi: str, state: dict) -> None:
    """Phase 29: every other KMS preset the JAX package serves but KMS8, at
    full width, NAND batch 128: the block forms through `bootstrap_mx3`, the
    binary forms through `bootstrap_mx2` on mx keys and a scheme without
    `brk_hat`; one decrypt-checked bootstrap and one dependent, timed and
    decrypt-checked; the compiled instance that served the sweeps; each
    preset's keys freed before the next keygen, so that peaks are per
    preset.  At KMS16party also the batch-minor image, phase 30 on the
    first input and the files of phase 31's two ranks."""
    for name, params in OTHER_PARTIES:
        block = isinstance(params, KmsBlockParams)
        keys = party_keygen_lean(gen, params, with_brk=block, mx=not block, bm=params is KMS_16PARTY)
        lwe_keys, scheme, mx_keys = keys["lwe_keys"], keys["scheme"], keys["mx_keys"]

        def decrypt(out):
            return lwe_decrypt_bit_mk(out, lwe_keys)

        if block:
            engine, bootstrap, instance = "bootstrap_mx3", fused_mx3.bootstrap_mx3, served_by(params)
        else:
            engine, bootstrap, instance = "bootstrap_mx2", fused_mx2.bootstrap_mx2, served_by(params, mx_keys=mx_keys)
            scheme = fused_mx2.mx_scheme(scheme, mx_keys.brk_mx)

        ct, c2, m1, m2 = gate_inputs(gen, params, lwe_keys, BATCH)
        reset_launches()
        boot, above = with_peak(lambda: bootstrap_chain(bootstrap, ct, c2, m1, m2, params, decrypt, scheme, 1))
        launches = read_launches()
        sweeps = launches["parties" if block else "mx"]
        if sweeps != 2 * params.k or launches["sweep"] != (2 if block else 0) or (not block and launches["parties"]):
            raise SystemExit(f"{name} {engine}: expected {params.k} sweeps a bootstrap, got {launches}")
        dt = boot["batch_s"]
        print(
            f"[29 {name}] " + keygen_note(name, params, keys) + f"; {engine} NAND batch {BATCH}: decrypt OK x2, "
            f"first {boot['first_s'] * 1e3:.1f} ms, a dependent one {dt * 1e3:.1f} ms/batch = {BATCH / dt:.2f} "
            f"boots/s; {sweeps} sweeps through {instance}; peak allocated {above / 1e9:.2f} GB above the held keys "
            f"({smi})"
        )
        state["noise"].append((f"{engine} [29]", name, boot["first"], lwe_keys, ~(m1 & m2)))
        state["parties"].append(preset_record(name, engine, keys, dt * 1e3, above, instance))
        if keys["bm_keys"] is not None:
            run_bootstrap_bm(name, params, keys, ct, boot["first"], ~(m1 & m2), decrypt, state["bm_check"], smi, [],
                             profiled=True)
            save_shard_case(state, name, params, keys, ct, boot["first"], ~(m1 & m2), 2)
        del keys, scheme, mx_keys, boot
        torch.cuda.empty_cache()


def save_shard_case(state: dict, name: str, params, keys: dict, ct, want, clear, world: int) -> None:
    """The files of phase 31's `world` ranks, mesh (party world, batch 1),
    each rank's share in a file of its own: for the mx2 engine with
    shard_phase2, the scheme's shares with the phase-2 keys cut and the mx
    keys' shares; where `keys` hold the batch-minor image, for the
    batch-minor engine (phase 2 replicated, its gates split) the scheme
    without `brk_hat` whole and that image's shares; the ciphertext."""
    tag = name.lower()
    lean, mx_keys, bm_keys = keys["scheme"], keys["mx_keys"], keys["bm_keys"]
    objs = {"scheme": (lean, True), "mx": (mx_keys, False)}
    if bm_keys is not None:
        objs["bm"] = (bm_keys, False)
    shares = save_shares(state["tmp"], tag, world, objs)
    ct_path = os.path.join(state["tmp"], f"{tag}_ct.npz")
    save(ct_path, ct)
    jobs = [Job("mx2 shard_phase2", params, shares["scheme"], ct_path, mesh=(world, 1), phase1_keys=shares["mx"],
                shard_phase2=True, reps=SHARD_REPS, graphed=True)]
    if bm_keys is not None:
        whole = os.path.join(state["tmp"], f"{tag}_scheme.npz")
        save(whole, lean)
        jobs.insert(0, Job("bm", params, whole, ct_path, mesh=(world, 1), phase1_keys=shares["bm"], graphed=True))
    state["shard_cases"].append({"name": name, "params": params, "want": want, "lwe_keys": keys["lwe_keys"],
                                 "clear": clear, "mx_bytes": scheme_bytes(mx_keys), "jobs": jobs, "world": world})


def run_parties(gen, device, smi: str, usage: dict, rate: dict, state: dict) -> list[dict]:
    """Phases 27-29: the KMS main path at every party count the JAX package
    serves beyond phase 6's k = 8, at full width; a summary line; returns the
    k = 32 rows of the kernels line."""
    state.setdefault("parties", [])
    rows = run_k32_block(gen, device, smi, usage, rate, state)
    torch.cuda.empty_cache()
    rows += run_k32_binary(gen, device, smi, usage, rate, state)
    torch.cuda.empty_cache()
    run_other_parties(gen, smi, state)
    print(f"[29b presets] KMS on the card, NAND batch {BATCH}, ms a batch (a dependent bootstrap; KMS32party's "
          f"bootstrap_mx3: its one bootstrap), keygen s, key images GB, keygen's peak above what was held before "
          f"it, the bootstrap's peak above the keys: " + "; ".join(
              f"{r['preset']} {r['engine']} {r['ms']:.1f} ms = {BATCH / r['ms'] * 1e3:.2f} boots/s, keygen "
              f"{r['keygen_s']:.2f} s, keys {r['key_gb']:.3f} GB, keygen peak {r['keygen_peak_gb']:.2f} GB, "
              f"bootstrap peak {r['above_gb']:.2f} GB, {r['instance']}" for r in state["parties"]) + f" ({smi})")
    return rows


def bm_shapes(params, g: int) -> tuple[dict, dict]:
    """The batch-minor NTT's launches in one `kms.bootstrap_bm` at batch g,
    by [npr', R, N, G] (npr' the monomial-weighted prime count): a step of
    party 1 (one RLEV row) transforms 2 l_gsw digit rows forward and 2 back,
    a step of every other party l_lev times as many."""
    npr = nprimes_monomial_weighted(params.ring_torus_bits, params.big_n, params.l_gsw, params.log_b_gsw)
    fwd, inv = {}, {}
    for rows, parties in ((1, 1), (params.l_lev, params.k - 1)):
        fwd[(npr, rows * 2 * params.l_gsw, params.big_n, g)] = parties * params.n
        inv[(npr, rows * 2, params.big_n, g)] = parties * params.n
    return fwd, inv


def check_bm_parties(gen, device, usage: dict, rate: dict, smi: str) -> dict:
    """Phase 30a: the batch-minor NTT kernel against its plain version,
    bit-exact both ways, at every shape `kms.bootstrap_bm` launches at
    BM_PARTIES (each through the instance `bm_plan` picks, named with
    ptxas's registers), timed on the device against its bound; the plain
    version timed at KMS32party's forward and inverse shapes of parties
    2..k.  Run before the large profiles (short profiles after those have
    come back empty)."""
    shapes = sorted({shape for _, params in BM_PARTIES for d in bm_shapes(params, BATCH) for shape in d})
    k32_fwd, k32_inv = (max(d, key=lambda shape: shape[1]) for d in bm_shapes(KMS_32PARTY, BATCH))
    res = check_ntt_bm(gen, device, usage["ntt"], rate, shapes, shapes, (k32_fwd, k32_inv))
    print(
        f"[30a ntt batch-minor at k=16, 32] bit-exact vs plain version at every shape kms.bootstrap_bm launches at "
        f"KMS16party and KMS32party, batch {BATCH}, {[list(x) for x in shapes]} [npr, R, N, G] (tolerance "
        f"{TOLERANCE}), through " + "; ".join(res["notes"]) + "; on the device: " + bm_times_line(res)
        + f"; plain version fwd {res['plain']['fwd']:.3f} ms at {list(k32_fwd)}, inv {res['plain']['inv']:.3f} ms "
        f"at {list(k32_inv)} ({smi})"
    )
    res["k32"] = (k32_fwd, k32_inv)
    return res


def profile_split(bootstrap, ct, scheme, params, kernel: str) -> dict:
    """One warm `bootstrap` under torch.profiler, without a trace file (a
    batch-minor or CCS bootstrap makes 10^5-10^6 events), its named ranges
    timed by CUDA events ("timed", `timed_ranges`: the bootstrap alone, not
    the reading of the profile): the device ms of the kernels whose names
    hold `kernel`, device busy (every kernel record) and wall; taken again,
    up to PROFILE_TRIES times in all, if it recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    on_device = torch.autograd.DeviceType.CUDA
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            timed = timed_ranges(lambda: bootstrap(ct, scheme, params))  # synchronises at its end
            wall_ms = (time.time() - t0) * 1e3
        rows = [e for e in prof.profiler.kineto_results.events()
                if e.device_type() == on_device and not e.is_user_annotation() and e.duration_ns() > 0]
        if rows:
            return {"kernel_ms": sum(e.duration_ns() for e in rows if kernel in e.name()) / 1e6,
                    "device_ms": sum(e.duration_ns() for e in rows) / 1e6, "wall_ms": wall_ms, "timed": timed}
        time.sleep(0.5)
    raise SystemExit("torch.profiler recorded no device time in the named ranges' profile")


def run_bootstrap_bm(name: str, params, keys: dict, ct, want, clear, decrypt, bm_check: dict, smi: str,
                     bm_rows: list[dict], profiled: bool) -> dict:
    """Phase 30 at one binary preset: `kms.bootstrap_bm` once on the
    ciphertext whose `bootstrap_mx2` output is `want`, on the batch-minor
    image built from the same party keys and the scheme without `brk_hat`:
    decrypt-checked, bit-identical to `want`, B4 launched n times a party
    each way (by shape: `bm_shapes`), B1 for the lev keys and phase 2's
    merges and no other kernel; if `profiled`, one warm bootstrap under the
    profiler split by named range (not at KMS32party, for the script's
    time: its profile's 10^6 events are read in Python); B4's launches by
    shape x time against the profile, else against the bootstrap's host
    clock (added to B4's rows of the kernels line).  Returns the launches."""
    bm_keys, lean = keys["bm_keys"], keys["scheme"]

    def bootstrap(ct, scheme, params):
        return kms.bootstrap_bm(ct, scheme, bm_keys, params)

    reset_launches()
    t0 = time.time()
    out, above = with_peak(lambda: checked_bootstrap(bootstrap, ct, clear, lean, params, decrypt,
                                                     f"{name} kms.bootstrap_bm"))
    one_s = time.time() - t0
    launches = {k: v for k, v in read_launches().items() if v}
    shapes = (dict(kntt.fwd_ntt_bm.shapes), dict(kntt.inv_ntt_bm.shapes))
    fwd, inv = merge_launches(params)
    steps = params.k * params.n
    expect = {"fwd_bm": steps, "inv_bm": steps, "hybrid": params.k, "fwd": params.k + fwd, "inv": inv}
    if launches != expect or shapes != bm_shapes(params, BATCH):
        raise SystemExit(f"{name} kms.bootstrap_bm: expected launches {expect} by shape {bm_shapes(params, BATCH)}, "
                         f"got {launches} by shape {shapes}")
    if not (torch.equal(out.b, want.b) and torch.equal(out.a, want.a)):
        raise SystemExit(f"{name}: kms.bootstrap_bm and bootstrap_mx2 differ on the same ciphertext")
    instances = sorted({kntt.bm_kernel(shape[2], shape[0], shape[1], shape[3], forward)["name"]
                        for forward, by in ((True, shapes[0]), (False, shapes[1])) for shape in by})
    print(
        f"[30 kms.bootstrap_bm] {name} NAND batch {BATCH}, on build_bm_kms_phase1 of the party keys of the mx keys "
        f"({keys['bm_bytes'] / 1e9:.3f} GB, {bm_keys.brk_bm.shape[2]} primes) and the scheme without brk_hat: "
        f"decrypt OK, output bit-identical to bootstrap_mx2's on the same ciphertext (b and a); one bootstrap "
        f"{one_s:.2f} s (host clock to the decrypted bits, no warm-up), peak {above / 1e9:.2f} GB above the held "
        f"keys; launches {launches} (B4 {params.n} steps x {params.k} parties each way, through "
        + ", ".join(instances) + f"; B1 for the lev keys and phase 2) ({smi})"
    )
    times = {shape: bm_check["times"][shape] for shape in set(shapes[0]) | set(shapes[1])}
    by_shape = ntt_by_shape(f"kms.bootstrap_bm {name}", *shapes, 1, times)
    if profiled:
        prof = profile_split(bootstrap, ct, lean, params, "ntt_bm_kernel")
        print(ranges_line("30b named ranges", f"kms.bootstrap_bm {name} (under the profiler)", params, prof["timed"],
                          prof)
              + f"; B4 {prof['kernel_ms']:.2f} ms in the profile ({smi})")
        print(by_shape_line("30c ntt batch-minor by shape", by_shape, prof["kernel_ms"], smi,
                            "batch-minor NTT kernel", "[npr, R, N, G]"))
    else:
        print(by_shape_line("30c ntt batch-minor by shape", by_shape, one_s * 1e3, smi, "batch-minor NTT kernel",
                            "[npr, R, N, G]", "of the whole bootstrap on the host clock (not profiled)"))
    for row, d in zip(bm_rows, ("fwd", "inv")):
        row["launches_by_shape"] += [
            {"path": r["path"], "shape": r["shape"], "launches": r[d], "ms": r[f"{d}_ms"]} for r in by_shape if r[d]]
    return {"launches": launches}


def save_shares(tmp: str, tag: str, n_party: int, objs: dict) -> dict:
    """Each object of `objs` (name -> (object, shard_phase2)) saved as one
    file a rank of a party axis of n_party ranks (`mesh.party_share`), the
    files phase 31's ranks load; returns name -> the tuple of paths."""
    paths = {}
    for name, (obj, shard_phase2) in objs.items():
        paths[name] = tuple(os.path.join(tmp, f"{tag}_{name}_{p}of{n_party}.npz") for p in range(n_party))
        for p, path in enumerate(paths[name]):
            save(path, party_share(obj, p, n_party, shard_phase2))
    return paths


# The card's peaks for the cost model's summary (utils/profiling.py): its
# integer operations at INT32_OPS_PER_S, its matmul work (the key switch's
# float64 gemm) at the FP64 tensor-core rate, 67 TFLOP/s on the H100 SXM data
# sheet, a multiply-add counted as two, and device memory at HBM_BYTES_PER_S.
FP64_TENSOR_MACS_PER_S = 33.5e12
H100_PEAKS = {"peak_vpu": INT32_OPS_PER_S, "peak_mxu": FP64_TENSOR_MACS_PER_S, "peak_hbm": HBM_BYTES_PER_S}
PROFILE_TRIES = 3
# the named ranges' event ms over the bootstrap's event ms from end to end
RANGE_SHARE = (0.90, 1.02)
# phase 1's event ms over the same path's sweep kernels in a profile (6b, 17b)
PHASE1_OF_SWEEPS = 0.95
SHARD_REPS = 2  # bootstraps of each mx2 job in the ranks: the first warms, the last is timed


def fields_equal(got, want) -> bool:
    return all(torch.equal(getattr(got, f.name), getattr(want, f.name)) for f in dataclasses.fields(want))


def run_serialization(state: dict, binary: dict, tmp: str, device, smi: str) -> dict:
    """Phase 23: the KMS8party scheme without `brk_hat`, its MxKmsKeys and the
    CGGI scheme saved (`utils.save`) and loaded back onto the card
    (`utils.load`); `bootstrap_mx2` (on the loaded scheme and keys joined by
    `fused_mx2.mx_scheme`) and `bootstrap_fused` on the loaded keys must
    give phases 17's and 13's outputs bit for bit.  Then the files that
    phase 26's ranks load: the KMS8party ciphertext, the batch-minor phase-1
    keys, the KMS8partyblock scheme and its ciphertext.  Returns the paths."""
    objs = {"kms8party_scheme": state["mx2"]["lean"], "kms8party_mx_keys": state["mx2"]["mx_keys"],
            "cggi_scheme": state["cggi"]["scheme"]}
    paths = {name: os.path.join(tmp, f"{name}.npz") for name in objs}
    sizes, save_s, load_s, loaded = {}, {}, {}, {}
    for name, obj in objs.items():
        t0 = time.time()
        save(paths[name], obj)
        save_s[name] = time.time() - t0
        sizes[name] = os.path.getsize(paths[name])
        t0 = time.time()
        loaded[name] = load(paths[name], device)
        torch.cuda.synchronize()
        load_s[name] = time.time() - t0
        if not fields_equal(loaded[name], obj):
            raise SystemExit(f"{name}: the loaded object differs from the saved one")
    loaded_mx = fused_mx2.mx_scheme(loaded["kms8party_scheme"], loaded["kms8party_mx_keys"].brk_mx)
    out = fused_mx2.bootstrap_mx2(binary["ct"], loaded_mx, KMS_8PARTY)
    want = state["mx2"]["out"]
    if not (torch.equal(out.b, want.b) and torch.equal(out.a, want.a)):
        raise SystemExit("bootstrap_mx2 on the loaded keys differs from phase 17's output")
    bm = batchminor.convert_scheme(loaded["cggi_scheme"], CGGI_PARAM)
    out = fused_step.bootstrap_fused(state["cggi"]["ct"], bm, CGGI_PARAM)
    want = state["cggi"]["out"]
    if not (torch.equal(out.b, want.b) and torch.equal(out.a, want.a)):
        raise SystemExit("bootstrap_fused on the loaded CGGI scheme differs from phase 13's output")
    del loaded, loaded_mx, bm
    print(
        "[23 serialization] save / load onto the card, every field equal: " + "; ".join(
            f"{name} {sizes[name] / 1e6:.1f} MB, save {save_s[name]:.2f} s, load {load_s[name]:.2f} s"
            for name in objs) + "; bootstrap_mx2 (KMS8party) and bootstrap_fused (CGGI) on the loaded keys "
        f"== phases 17 and 13, bit for bit; {shutil.disk_usage(tmp).free / 1e9:.0f} GB free in the "
        f"temporary directory ({smi})"
    )
    t0 = time.time()
    more = {"kms8party_ct": binary["ct"], "kms8party_bm_keys": state["mx2"]["bm_keys"],
            "kms8partyblock_scheme": state["block"]["scheme"], "kms8partyblock_ct": state["block"]["ct"]}
    for name, obj in more.items():
        paths[name] = os.path.join(tmp, f"{name}.npz")
        save(paths[name], obj)
    print(f"[23b files for phase 26] " + ", ".join(
        f"{name} {os.path.getsize(paths[name]) / 1e6:.1f} MB" for name in more) + f" saved in {time.time() - t0:.2f} s")
    return paths


def run_noise(state: dict, smi: str) -> None:
    """Phase 24: `noise_report` on outputs of earlier phases, beside
    MARGINS.md's row (margins.json) for the same preset; fails where the
    largest error reaches the margin."""
    rows = {row["preset"]: row for row in json.loads((Path(__file__).resolve().parent / "margins.json").read_text())}
    parts = []
    for label, preset, out, keys, want in state["noise"]:
        rep = noise.noise_report(out, keys, want)
        if rep["max_abs_bits"] >= rep["margin_bits"]:
            raise SystemExit(f"{label} {preset}: phase error reaches the margin: {rep}")
        row = rows[preset]
        parts.append(
            f"{label} {preset}, {rep['samples']} gates: {rep['margin_sigmas']:.2f} sigma, std "
            f"{rep['std_bits']:.2f} bits, max |err| {rep['max_abs_bits']:.2f} of {rep['margin_bits']:.0f} bits "
            f"(MARGINS.md: {row['margin_sigmas']} sigma, std {row['std_bits']} bits at batch {row['batch']})")
    print("[24 noise] statistics of exact arithmetic, not speeds: " + "; ".join(parts) + f" ({smi})")


def run_named_ranges(state: dict, binary: dict, smi: str) -> None:
    """Phase 25: one warm `bootstrap_mx3` (KMS8partyblock) and one
    `bootstrap_mx2` (KMS8party) split by named range with CUDA events
    (`ranges_line`: the ranges must hold RANGE_SHARE of the bootstrap, phase 1
    PHASE1_OF_SWEEPS of the sweeps in 6b / 17b), beside the kernel records'
    total of one more under torch.profiler; then the cost model's summary
    against the H100's peaks at the chains' times of phases 6 and 17."""
    cases = (
        ("bootstrap_mx3", fused_mx3.bootstrap_mx3, state["block"]["ct"], state["block"]["scheme"],
         KMS_8PARTY_BLOCK, state["block"], "6b"),
        ("bootstrap_mx2", fused_mx2.bootstrap_mx2, binary["ct"], state["mx2"]["mx_scheme"], KMS_8PARTY,
         state["mx2"], "17b"),
    )
    for what, bootstrap, ct, scheme, params, path, tag in cases:
        timed = timed_ranges(lambda: bootstrap(ct, scheme, params))
        prof = profile_bootstrap(bootstrap, ct, scheme, params, {})
        cost = profiling.kms_cost(params, "ref", params.ring_nprimes)
        # the JAX package's TPU operation model, not the port's arithmetic: its
        # utilization against the card's peak is left out (each kernel's own
        # bound is in the kernels line)
        summary = cost.summary(BATCH, path["chain_s"], **H100_PEAKS)
        del summary["vpu_utilization"]
        preset = "KMS8partyblock" if params is KMS_8PARTY_BLOCK else "KMS8party"
        print(
            ranges_line("25 named ranges", f"{what} {preset}", params, timed, prof,
                        (path["sweeps_ms"], f"{tag}'s sweep kernels"))
            + f"; bounds of the JAX TPU op model, not the port's arithmetic (the JAX package's count, engine "
            f"'ref', {params.ring_nprimes} primes) against the H100's peaks (int32 {INT32_OPS_PER_S / 1e12:.1f} "
            f"T ops/s, fp64 tensor {FP64_TENSOR_MACS_PER_S / 1e12:.1f} T MAC/s, {HBM_BYTES_PER_S / 1e12:.2f} "
            f"TB/s) at the chain's {path['chain_s'] * 1e3:.1f} ms a batch: "
            + ", ".join(f"{k} {v:.4g}" for k, v in summary.items()) + f" ({smi})"
        )


def check_rank_results(job: str, ranks: list[list[dict]], index: int, want: Lwe, keys, clear, expect: dict) -> dict:
    """Every rank's output of job `index` equals `want` and decrypts to
    `clear`, eagerly and, for a graphed job, replayed from its graphs (and
    captured by segment where the capture was whole); every rank launched
    exactly `expect`'s kernels (the others not at all) in an eager bootstrap
    and in a replay, and imported no jax.  Returns the slowest rank's result
    (by eager ms)."""
    for rank, results in enumerate(ranks):
        res = results[index]
        outs = {"eager": res}
        if "graph" in res:
            outs["graphed"] = res["graph"]
            if "by_segment" in res["graph"]:
                outs["graphed by segment"] = res["graph"]["by_segment"]
        for how, got in outs.items():
            out = Lwe(b=bridge.from_numpy(got["b"], want.b.device), a=bridge.from_numpy(got["a"], want.a.device))
            if not (torch.equal(out.b, want.b) and torch.equal(out.a, want.a)):
                raise SystemExit(f"{job}: rank {rank}'s {how} output differs from the single-process output")
            if not np.array_equal(lwe_decrypt_bit_mk(out, keys).cpu().numpy(), clear):
                raise SystemExit(f"{job}: rank {rank}'s {how} output does not decrypt to the clear NAND")
        for how, got in {"eager": res, **({"a replay": res["graph"]} if "graph" in res else {})}.items():
            launched = got["launches"] = {k: v for k, v in got["launches"].items() if v}
            if launched != expect:
                raise SystemExit(f"{job}: rank {rank} launched {launched} in {how}, expected {expect}")
        if res["jax"] or res["mktfhe_tpu"]:
            raise SystemExit(f"{job}: rank {rank} imported jax or the JAX package")
    return max((results[index] for results in ranks), key=lambda r: r["ms"])


def graph_note(ranks: list[list[dict]], index: int) -> str:
    """The graphed replay of job `index` beside its eager bootstrap: the
    slowest rank's ms, and each rank's graphs, nodes, capture and pool."""
    results = [r[index] for r in ranks]
    g = max((r["graph"] for r in results), key=lambda x: x["ms"])
    per_rank = "; ".join(
        f"rank {rank} {r['graph']['segments']} graph(s), {r['graph']['nodes']} nodes, capture "
        f"{r['graph']['capture_s']:.2f} s + instantiate {r['graph']['instantiate_s']:.2f} s, pool "
        f"{r['graph']['pool_bytes'] / 1e9:.3f} GB reserved / {r['graph']['pool_peak_bytes'] / 1e9:.3f} GB peak"
        for rank, r in enumerate(results))
    return f"graphed {g['ms']:.1f} ms a replay (slowest rank), launches a replay == eager ({per_rank})"


def sharded_record(state: dict, name: str, preset: str, world: int, backend: str, ranks, index: int) -> None:
    """One graphed sharded job for the JSON line of `sharded_summary`."""
    results = [r[index] for r in ranks]
    state["sharded"].append({
        "job": name, "preset": preset, "ranks": world, "backend": backend,
        "eager_ms": max(r["ms"] for r in results), "graph_ms": max(r["graph"]["ms"] for r in results),
        **{key: [r["graph"][key] for r in results]
           for key in ("segments", "nodes", "capture_s", "instantiate_s", "pool_bytes", "pool_peak_bytes")},
        "device_peak_bytes": [r["device_peak_bytes"] for r in results],
    })


def merge_launches(params) -> tuple[int, int]:
    """Natural NTT launches of phase 2's k merges: forward the LEV digits and
    v's digits (the hybrid product transforms its digits inside its own
    kernel, one launch a merge); inverse y, v and the new accumulator."""
    return 2 * params.k, 3 * params.k


def shard_launches(params, kp: int, engine: str) -> dict:
    """The kernel launches of one rank's sharded bootstrap with kp resident
    parties: phase 1 by engine (the mx sweep once a party; the batch-minor
    NTT once a step each way; the reference engine's natural NTT once a step
    each way), each party's lev key lifted by one forward natural NTT, and
    phase 2's merges (`merge_launches`, and the hybrid product once a merge
    on every rank)."""
    steps = params.n // (params.ell if isinstance(params, KmsBlockParams) else 1)
    fwd, inv = merge_launches(params)
    if engine == "mx2":
        return {"mx": kp, "hybrid": params.k, "fwd": kp + fwd, "inv": inv}
    if engine == "bm":
        return {"fwd_bm": kp * steps, "inv_bm": kp * steps, "hybrid": params.k, "fwd": kp + fwd, "inv": inv}
    return {"fwd": kp * steps + kp + fwd, "inv": kp * steps + inv, "hybrid": params.k}


def run_sharded(state: dict, binary: dict, paths: dict, smi: str) -> None:
    """Phase 26: the party-sharded bootstrap in ranks that load their keys
    from phase 23's files (parallel/launch.py:bootstrap_jobs), the kernels
    built by phase 2, each job eagerly and then replayed from the rank's
    CUDA graphs (`graphs.capture_sharded`; the capture's warm-up is the
    job's last eager bootstrap): (a) NCCL, one rank, a (1, 1) mesh, the mx2
    engine at KMS8party, the whole program one graph with its collectives
    (one-rank NCCL collectives are issued, copies on the card), replayed
    with every synchronizing call an error, and captured by segment too: the
    nodes its collectives add; (b) gloo, two ranks sharing cuda:0, a (party
    2, batch 1) mesh, a graph a segment: mx2 with phase 2 replicated and with
    shard_phase2, the batch-minor engine, `kms_bootstrap_sharded` and the
    reference engine at KMS8partyblock; the same two ranks then run phase
    31's k = 16 jobs (their lines print in phase 31).  Every output must
    equal the single-process output of the same ciphertext and decrypt to
    the clear NAND; every rank's launches, eager and a replay, are held
    against `shard_launches`."""
    p8, pb = KMS_8PARTY, KMS_8PARTY_BLOCK
    mx2 = dict(params=p8, scheme=paths["kms8party_scheme"], ct=paths["kms8party_ct"],
               phase1_keys=paths["kms8party_mx_keys"], reps=SHARD_REPS, graphed=True)
    block = dict(params=pb, scheme=paths["kms8partyblock_scheme"], ct=paths["kms8partyblock_ct"], graphed=True)
    bin_want, bin_keys, bin_clear = state["mx2"]["out"], binary["lwe_keys"], ~(binary["m1"] & binary["m2"])
    blk_want, blk_keys, blk_clear = state["block"]["out"], state["block"]["lwe_keys"], state["block"]["want"]

    t0 = time.time()
    ranks = run_ranks(bootstrap_jobs, 1, "nccl", ([Job("mx2", mesh=(1, 1), **mx2)],), "cuda")
    res = check_rank_results("(a) nccl mx2", ranks, 0, bin_want, bin_keys, bin_clear, shard_launches(p8, p8.k, "mx2"))
    g = res["graph"]
    seg = g.get("by_segment", {"segments": 0, "nodes": g["nodes"]})
    if not g["whole"] or g["segments"] != 1 or g["nodes"] <= seg["nodes"]:
        raise SystemExit(f"(a) nccl mx2: expected one whole graph holding more nodes than its segments' graphs "
                         f"(its collectives), got {g['segments']} graph(s), {g['nodes']} nodes against "
                         f"{seg['segments']} graphs of {seg['nodes']} nodes")
    sharded_record(state, "mx2", "KMS8party", 1, "nccl", ranks, 0)
    print(
        f"[26a sharded, nccl] kms_bootstrap_shardmap, 1 rank, mesh (1, 1), mx2 engine, KMS8party NAND batch "
        f"{BATCH}: eager and graphed == bootstrap_mx2 of phase 17 bit for bit, decrypt OK, launches "
        f"{res['launches']} eager and a replay; eager {res['ms']:.1f} ms a bootstrap (warm); the whole program "
        f"one CUDA graph, collectives included: {g['nodes']} nodes, capture {g['capture_s']:.2f} s + instantiate "
        f"{g['instantiate_s']:.2f} s, pool {g['pool_bytes'] / 1e9:.3f} GB reserved / "
        f"{g['pool_peak_bytes'] / 1e9:.3f} GB peak; replayed under set_sync_debug_mode('error'), no sync, "
        f"{g['ms']:.1f} ms a replay (the last of {SHARD_REPS}); captured by segment, its collectives eager: "
        f"{seg['segments']} graphs of {seg['nodes']} nodes, == too: the one-rank NCCL collectives add "
        f"{g['nodes'] - seg['nodes']} nodes; {time.time() - t0:.1f} s with the rank's start and key load ({smi})"
    )

    jobs = [
        Job("mx2", mesh=(2, 1), **mx2),
        Job("mx2 shard_phase2", mesh=(2, 1), shard_phase2=True, **mx2),
        Job("bm", params=p8, scheme=paths["kms8party_scheme"], ct=paths["kms8party_ct"],
            phase1_keys=paths["kms8party_bm_keys"], mesh=(2, 1), graphed=True),
        Job("kms_bootstrap_sharded", mesh=(2, 1), sharded=True, **block),
        Job("ref", mesh=(2, 1), **block),
    ]
    cases = [(bin_want, bin_keys, bin_clear, p8, "mx2"), (bin_want, bin_keys, bin_clear, p8, "mx2"),
             (bin_want, bin_keys, bin_clear, p8, "bm"), (blk_want, blk_keys, blk_clear, pb, "ref"),
             (blk_want, blk_keys, blk_clear, pb, "ref")]
    # phase 31's two-rank jobs share these ranks: one start, one process a rank
    k16 = [case for case in state["shard_cases"] if case["world"] == 2]
    t0 = time.time()
    ranks = run_ranks(bootstrap_jobs, 2, "gloo", (jobs + [job for case in k16 for job in case["jobs"]],), "cuda")
    wall = time.time() - t0
    at = len(jobs)
    for case in k16:  # each case's results, for phase 31
        case["ranks"], case["wall"] = [r[at : at + len(case["jobs"])] for r in ranks], wall
        at += len(case["jobs"])
    parts = []
    for index, (job, (want, keys, clear, params, engine)) in enumerate(zip(jobs, cases)):
        res = check_rank_results(f"(b) gloo {job.name}", ranks, index, want, keys, clear,
                                 shard_launches(params, params.k // 2, engine))
        preset = "KMS8partyblock" if params is pb else "KMS8party"
        sharded_record(state, job.name, preset, 2, "gloo", ranks, index)
        held = max(results[index]["key_bytes"] for results in ranks)
        whole = sum(os.path.getsize(path) for path in (job.scheme, job.phase1_keys) if path)
        parts.append(f"{job.name} ({preset}): eager {res['ms']:.1f} ms{' (warm)' if job.reps > 1 else ''}, "
                     f"{graph_note(ranks, index)}, launches a rank {res['launches']}, keys a rank "
                     f"{held / 1e9:.3f} GB of {whole / 1e9:.3f} GB")
    print(
        f"[26b sharded, gloo] 2 ranks sharing cuda:0 (their SMs shared: a check of bits and wiring, not a "
        f"scaling number), mesh (party 2, batch 1), batch {BATCH}, every output, eager and replayed from the "
        f"rank's graphs (a graph a segment, the gloo collectives between them), == the single-process output of "
        f"the same ciphertext (phases 17 and 6) bit for bit on both ranks, decrypt OK; per job the slowest "
        f"rank's ms a bootstrap: " + "; ".join(parts) + f"; {wall:.1f} s with the ranks' start and key loads, "
        f"phase 31's k = 16 jobs included ({smi})"
    )


def file_bytes(paths) -> int:
    """Bytes on disk of a Job's key files (one path, or one a rank)."""
    if paths is None:
        return 0
    return sum(os.path.getsize(path) for path in ((paths,) if isinstance(paths, str) else paths))


def run_sharded_parties(state: dict, smi: str) -> None:
    """Phase 31: the party-sharded bootstrap at k = 16 and k = 32 in gloo
    ranks sharing cuda:0, on the files phases 28 and 29 saved, each job
    eagerly and replayed from the rank's graphs (a graph a segment; at
    k = 32 with shard_phase2 about 34 of them a rank, in one memory pool):
    KMS32party in four ranks, mesh (party 4, batch 1), mx2 with shard_phase2
    (PARALLEL.md's k = 32 residency: 8 parties a rank, the phase-2 keys
    party-sharded); KMS16party in two ranks, mesh (party 2, batch 1), the
    batch-minor engine (phase 2 replicated, its gates split) and the mx2
    engine with shard_phase2, run in phase 26's two ranks.  Every rank reads
    only its share of the party-sharded keys from disk.  Every output must
    equal the single-process `bootstrap_mx2` output of the same ciphertext
    (phases 29 and 28) and decrypt to the clear NAND; every rank's launches,
    eager and a replay, are held against `shard_launches`."""
    for case in state["shard_cases"]:
        params, jobs, world = case["params"], case["jobs"], case["world"]
        if world == 2:
            ranks = case["ranks"]
            how = (f"run in phase 26's two ranks ({case['wall']:.1f} s with their start and key loads, phase 26b's "
                   f"jobs included)")
        else:
            t0 = time.time()
            ranks = run_ranks(bootstrap_jobs, world, "gloo", (jobs,), "cuda")
            how = f"{time.time() - t0:.1f} s with the ranks' start and key loads"
        parts = []
        for index, job in enumerate(jobs):
            engine = "bm" if job.name == "bm" else "mx2"
            res = check_rank_results(f"(31) {case['name']} gloo {job.name}", ranks, index, case["want"],
                                     case["lwe_keys"], case["clear"], shard_launches(params, params.k // world, engine))
            sharded_record(state, job.name, case["name"], world, "gloo", ranks, index)
            results = [r[index] for r in ranks]
            host, dev = (", ".join(f"{r[key] / 1e9:.2f}" for r in results)
                         for key in ("host_rss_bytes", "device_peak_bytes"))
            parts.append(
                f"{job.name}: eager {res['ms']:.1f} ms{' (warm)' if job.reps > 1 else ''}, {graph_note(ranks, index)}, "
                f"launches a rank {res['launches']}, keys a rank (max) {max(r['key_bytes'] for r in results) / 1e9:.3f} "
                f"GB of {(file_bytes(job.scheme) + file_bytes(job.phase1_keys)) / 1e9:.3f} GB in the whole files, "
                f"read from disk a rank (max) {max(r['loaded_bytes'] for r in results) / 1e9:.3f} GB, host resident "
                f"a rank (sampled with the keys loaded and after the bootstraps) {host} GB, device peak a rank "
                f"(eager and graphs) {dev} GB")
        note = ""
        if world == 4:
            note = (f"; the brk_mx share a rank {case['mx_bytes'] / world / 1e9:.3f} GB (a quarter of "
                    f"{case['mx_bytes'] / 1e9:.3f} GB), beside PARALLEL.md's 4x2 row of the JAX package on TPU "
                    f"v5e: 5.28 GB of brk a device in its own layout")
        print(
            f"[31 sharded, k={params.k}] {case['name']} NAND batch {BATCH}, {world} gloo ranks sharing cuda:0 "
            f"(their SMs shared: a check of bits and wiring, not a scaling number), mesh (party {world}, batch 1), "
            f"{params.k // world} parties a rank; every rank's output, eager and replayed from its graphs, == the "
            f"single-process bootstrap_mx2 output bit for bit, decrypt OK; per job the slowest rank's ms a "
            f"bootstrap: " + "; ".join(parts) + note + f"; {how} ({smi})"
        )


def sharded_summary(state: dict, smi: str) -> None:
    """The graphed sharded jobs of phases 26 and 31 as one JSON line."""
    print(f"[26-31 sharded graphs] {len(state['sharded'])} jobs, every replay == eager == single-process ({smi})")
    print(json.dumps({"sharded_graphs": state["sharded"]}))


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
    sources = [kntt.SOURCE, fused_mx3.SOURCE, fused_step.SOURCE, fused_mx2.SOURCE, khybrid.SOURCE,
               butterfly_rate.SOURCE]
    libs = _build.build_all(sources)
    kntt.load_library()
    fused_mx3.load_library()
    fused_step.load_library()
    fused_mx2.load_library()
    khybrid.load_library()
    butterfly_rate.load_library()
    usage = {src.stem: _build.resource_usage(lib) for src, lib in zip(sources, libs)}
    said = "; ".join(f"{stem}.cu: {' | '.join(kernels)}" for stem, kernels in usage.items())
    print(
        f"[2 build] {', '.join(lib.name for lib in libs)} from csrc/ (sm_90a, one nvcc each, "
        f"started together) in {time.time() - t0:.2f} s; ptxas, per kernel: {said}"
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
    # what the later phases take from the earlier ones
    state = {"noise": [], "shard_cases": [], "graphs": [], "sharded": [], "cpu_checks": [], "t_start": t_start}
    kernels, binary = run_kms(gen, device, smi, usage, rate, state)
    cggi_rows, bm_times = run_cggi(gen, device, smi, usage, rate, state)
    kernels += cggi_rows
    kernels += run_mx2(gen, device, smi, binary, usage, rate, kernels[:2], cggi_rows[:2], bm_times, state)

    # B1 at every shape of phases 19, 20 and 32, and B4 at phase 30's (30a),
    # timed before the profiles of 10^5-10^6 events: after those, short
    # profiles have come back empty
    t_gates = time.time()
    gate_times = time_ntt_shapes(gen, device, gate_path_ntt_shapes())
    state["bm_check"] = check_bm_parties(gen, device, usage, rate, smi)
    run_lmss(gen, smi, gate_times, rate, kernels[:2], state)
    run_ccs(gen, smi, gate_times, rate, kernels[:2], state)
    run_cli(smi)

    with tempfile.TemporaryDirectory() as tmp:
        state["tmp"] = tmp
        # 27-30: every other party count, k = 32 at full width, and the
        # batch-minor engine at k = 16 and 32 (saving phase 31's files)
        t_parties = time.time()
        kernels += run_parties(gen, device, smi, usage, rate, state)
        torch.cuda.empty_cache()

        # 23, 25, 26 and 31: serialization, named ranges, the sharded path at
        # k = 8, 16 and 32
        t_tools = time.time()
        paths = run_serialization(state, binary, tmp, device, smi)
        run_named_ranges(state, binary, smi)

        def sharded():
            run_sharded(state, binary, paths, smi)
            # no later phase reads the keys of phases 4-21: their device memory
            # goes to phase 31's four ranks, which hold graph pools beside keys
            for held, names in ((binary, ("scheme", "party_keys", "wide_party_keys")), (state["block"], ("scheme",)),
                                (state["mx2"], ("lean", "mx_keys", "mx_scheme", "bm_keys")), (state["cggi"], ("scheme",))):
                for name in names:
                    del held[name]
            torch.cuda.empty_cache()
            state["t_shards"] = time.time()
            run_sharded_parties(state, smi)

        # the main process only waits for the ranks there: the CPU checks of 19-20 run beside them
        cpu_checks_beside(state, sharded, smi)
        t_shards = state["t_shards"]

    # 32: CCS8party and CCS16party, last: CCS16party's graph runs as far as
    # the time limit allows; then 24, noise with the outputs of 27-32
    t_ccs = time.time()
    kernels += run_ccs_parties(gen, device, smi, gate_times, rate, kernels[:2], state)
    run_noise(state, smi)
    graphs_summary(state, smi)
    sharded_summary(state, smi)

    # 22. results
    print(f"[22 done] {time.time() - t_start:.1f} s in all: phases 1-18 {t_gates - t_start:.1f} s, 19-21 and 30a "
          f"{t_parties - t_gates:.1f} s, 27-30 {t_tools - t_parties:.1f} s, 23, 25, 26 {t_shards - t_tools:.1f} s, "
          f"31 {t_ccs - t_shards:.1f} s, 32 and 24 {time.time() - t_ccs:.1f} s; phase 33 (graphs) "
          f"{state.get('graph_s', 0.0):.1f} s of these; {NO_LIBRARY_CALL}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
