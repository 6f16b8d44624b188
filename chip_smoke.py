#!/usr/bin/env python3
"""Drive the PyTorch port (mktfhe_tpu_torch) on one CUDA card, end to end.

Phases, each printing one line; any failure exits non-zero:
  1. require a CUDA card; print `nvidia-smi` name and power limit;
  2. build the NTT kernel from mktfhe_tpu_torch/csrc/ (nvcc, sm_90a);
  3. hold the kernel against its plain PyTorch twin on the card, bit-exact,
     forward and inverse, at the bootstrap's shapes, and time both;
  4. keygen for KMS8partyblock on the card: crs, 8 party keygens, setup;
  5. bootstrap a batch of NAND gates, decrypt-check it, then time a
     data-dependent chain of two more bootstraps (decrypt-checked too) and
     check that the bootstrap launched the NTT kernels;
  6. hold the key switch on the card against the same code on the CPU for
     4 gates, bit-exact;
  7. print the kernels' JSON line, then the contract line last.

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

from mktfhe_tpu_torch.kernels import ntt as kntt
from mktfhe_tpu_torch.ring.modring import prime_column
from mktfhe_tpu_torch.ring.ntt import fwd_ntt, inv_ntt, make_plan
from mktfhe_tpu_torch.ring.sampler import uniform_torus
from mktfhe_tpu_torch.schemes import kms
from mktfhe_tpu_torch.schemes.gates import (
    GATE_IDS,
    gate_affine,
    lwe_decrypt_bit_mk,
    lwe_ith_encrypt_bit,
)
from mktfhe_tpu_torch.schemes.presets import KMS_8PARTY_BLOCK

BATCH = 128
CHAIN = 2
SEED = 0
# (rows, npr, N): phase-1 digit transforms at G=128 (128 gates x 3 RLEV rows
# x 2 components x 4 digits), the phase-1 inverse (128 x 3 x 2), and a
# small N=64 / 2-prime case at the kernel's lower limits.
NTT_SHAPES = [(3072, 4, 2048), (768, 4, 2048), (5, 2, 64)]
TOLERANCE = 0  # exact integer arithmetic: bit-identical or wrong


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


def _residues(gen, shape, device) -> torch.Tensor:
    """Uniform residues < p_i, int32 [rows, npr, N]."""
    rows, npr, n = shape
    x = torch.randint(0, 1 << 31, shape, generator=gen, device=device)
    return torch.remainder(x, prime_column(npr, device)).to(torch.int32)


def check_ntt(gen, device) -> dict:
    """Kernel vs plain twin on the card at NTT_SHAPES; times at the first."""
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
        err["fwd"] = max(err["fwd"], int((fk.long() - fp.long()).abs().max()))
        err["inv"] = max(err["inv"], int((ik.long() - ip.long()).abs().max()))
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
            raise SystemExit(f"NTT {d} kernel disagrees with its plain twin: max |diff| {err[d]}")
    return {"err": err, "times": times}


def keygen(gen, params):
    """crs, party keygens and setup on the generator's device."""
    a = kms.crs(gen, params)
    parties = [kms.party_keygen(gen, a, params) for _ in range(params.k)]
    scheme = kms.setup(a, [p[3] for p in parties], params)
    return [p[0] for p in parties], scheme


def bootstrap_chain(gen, params, lwe_keys, scheme, batch: int, chain: int) -> dict:
    """NAND bootstrap of a batch, decrypt-checked, then a timed chain of
    `chain` dependent bootstraps, decrypt-checked."""
    device = scheme.crs_hat.device
    rng = np.random.default_rng(SEED)
    m1 = rng.integers(0, 2, batch).astype(bool)
    m2 = rng.integers(0, 2, batch).astype(bool)
    nand = GATE_IDS["NAND"]
    ct2 = lwe_ith_encrypt_bit(gen, torch.from_numpy(m2).to(device), 1, lwe_keys[1], params.alpha, params.k, (batch,))
    c1 = lwe_ith_encrypt_bit(gen, torch.from_numpy(m1).to(device), 0, lwe_keys[0], params.alpha, params.k, (batch,))
    t0 = time.time()
    out = kms.bootstrap(gate_affine(nand, c1, ct2), scheme, params)
    want = ~(m1 & m2)
    got = lwe_decrypt_bit_mk(out, lwe_keys).cpu().numpy()
    first_s = time.time() - t0
    if not np.array_equal(got, want):
        raise SystemExit(f"bootstrap decrypt mismatch: {int((got != want).sum())} of {batch} gates")
    t0 = time.time()
    for _ in range(chain):
        out = kms.bootstrap(gate_affine(nand, out, ct2), scheme, params)
        want = ~(want & m2)
    out.b.cpu()  # a hard device -> host read ends the timed chain
    dt = (time.time() - t0) / chain
    got = lwe_decrypt_bit_mk(out, lwe_keys).cpu().numpy()
    if not np.array_equal(got, want):
        raise SystemExit(f"chain decrypt mismatch: {int((got != want).sum())} of {batch} gates")
    return {"first_s": first_s, "batch_s": dt}


def check_keyswitch(gen, params, scheme, gates: int = 4) -> None:
    """The key switch on the scheme's device vs the same code on the CPU."""
    ctx = kms._ctx(params)
    acc = uniform_torus(gen, (gates, params.k + 1, params.big_n), ctx.dtype)
    got = kms._keyswitch(acc, scheme, params)
    cpu_scheme = dataclasses.replace(scheme, ksk_b=scheme.ksk_b.cpu(), ksk_a=scheme.ksk_a.cpu())
    want = kms._keyswitch(acc.cpu(), cpu_scheme, params)
    if not (torch.equal(got.b.cpu(), want.b) and torch.equal(got.a.cpu(), want.a)):
        raise SystemExit("key switch on the card differs from the CPU")


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
    lib = kntt.build()
    kntt.load_library()
    print(f"[2 build] {lib.name} from csrc/{kntt.SOURCE.name} (sm_90a) in {time.time() - t0:.2f} s")

    # 3. kernel vs plain twin
    gen = torch.Generator(device=device).manual_seed(SEED)
    ntt = check_ntt(gen, device)
    (kf, pf), (ki, pi) = ntt["times"]["fwd"], ntt["times"]["inv"]
    print(
        f"[3 ntt] bit-exact vs plain twin at {NTT_SHAPES} (tolerance {TOLERANCE}); "
        f"at {list(NTT_SHAPES[0])}: fwd kernel {kf:.4f} ms vs plain {pf:.3f} ms, "
        f"inv kernel {ki:.4f} ms vs plain {pi:.3f} ms ({smi})"
    )

    # 4. keygen
    params = KMS_8PARTY_BLOCK
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    lwe_keys, scheme = keygen(gen, params)
    torch.cuda.synchronize()
    print(
        f"[4 keygen] KMS8partyblock (k={params.k}, n={params.n}, N={params.big_n}, "
        f"npr={params.ring_nprimes}): {time.time() - t0:.2f} s, peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({smi})"
    )

    # 5. the main path: counts reset just before it, read just after
    torch.cuda.reset_peak_memory_stats()
    kntt.reset_launches()
    boot = bootstrap_chain(gen, params, lwe_keys, scheme, BATCH, CHAIN)
    launches = {"fwd": kntt.fwd_ntt_nat.launches, "inv": kntt.inv_ntt_nat.launches}
    if min(launches.values()) == 0:
        raise SystemExit(f"the bootstrap did not launch the NTT kernels: {launches}")
    dt = boot["batch_s"]
    print(
        f"[5 bootstrap] KMS8partyblock NAND batch {BATCH}: decrypt OK x{1 + CHAIN}; first "
        f"{boot['first_s']:.2f} s; chain {dt * 1e3:.1f} ms/batch = {BATCH / dt:.2f} boots/s; "
        f"peak allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; NTT launches "
        f"fwd {launches['fwd']} inv {launches['inv']} ({smi})"
    )

    # 6. key switch on the card vs the CPU
    check_keyswitch(gen, params, scheme)
    print("[6 keyswitch] 4 gates: card == CPU, bit-exact (float64 limb matmul)")

    # 7. results
    kernels = []
    for d, name in (("fwd", "ntt_fwd_nat"), ("inv", "ntt_inv_nat")):
        k_ms, p_ms = ntt["times"][d]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "mktfhe_tpu_torch/csrc/ntt.cu",
            "replaces": "mktfhe_tpu/kernels/ntt_pallas.py:340",
            "launches": launches[d],
            "max_abs_err": ntt["err"][d],
            "ms": k_ms,
            "plain_ms": p_ms,
        })
    print(f"[7 done] {time.time() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
