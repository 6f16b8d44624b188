"""Scheme-agnostic bootstrapping machinery (port of schemes/common.py).

Modulus switch, test-vector prologue and the key-switch epilogues (single
key, per party, and LMSS's partial one).  The key switch keeps the
reference's design: a signed one-hot of the balanced gadget digits
contracted against int8 limb tables of fresh LWE encryptions, the four
limbs recombined with wrapping shifts (exact mod 2^32, one fresh noise unit
per nonzero digit).

The reference ran that contraction as an int8 XLA dot outside any Pallas
kernel.  Here it is a float64 library matmul (CUDA has no integer
`torch.matmul`): every operand is an integer of at most 8 bits, so every
partial sum is an integer bounded by R * 128, with R the contraction length
(R = (N - n) * f * D/2 = 23,024 at KMS8partyblock, N * f * D/2 = 32,768 at
the non-block KMS presets, k * N * f * D/2 = 16,384 at CGGI and at CCS,
(k * N - n) * f * D/2 = 5,392 at LMSS Block: |sum| <= 2^22).  That is far below 2^53, so the
float64 product is exact in any summation order and under any math mode
(TF32 never applies to float64).
"""

from __future__ import annotations

import torch

from ..ciphertext.decomp import balanced_decomp
from ..ciphertext.keys import LweKey
from ..ciphertext.lwe import Lwe, lwe_encrypt
from ..ciphertext.rlwe import gadget_gvec
from ..kernels.ntt import inv_ntt_nat
from ..ring.context import RingCtx
from ..ring.modring import MASK32
from ..ring.torus import bits_of, divbits, from_crt, negacyclic_roll, wrap_i32

NLIMB = 4  # 8-bit limbs per u32 key-switch coefficient


def mod_switch_2n(ct: Lwe, big_n: int):
    """Scale a T-bit LWE ciphertext to modulus 2N, reduced mod 2N."""
    t = bits_of(ct.b.dtype)
    shift = t - (big_n.bit_length() - 1) - 1
    mask = 2 * big_n - 1
    return divbits(ct.b, shift) & mask, divbits(ct.a, shift) & mask


def initial_acc(tildeb: torch.Tensor, big_n: int, k: int, ring_dtype: torch.dtype) -> torch.Tensor:
    """RLWE accumulator [..., k+1, N] holding the test vector
    X^tildeb * (-1/8 * sum_i X^i) in component 0."""
    eighth = 1 << (bits_of(ring_dtype) - 3)
    base = torch.full((big_n,), -eighth, dtype=ring_dtype, device=tildeb.device)
    acc = torch.zeros((*tildeb.shape, k + 1, big_n), dtype=ring_dtype, device=tildeb.device)
    acc[..., 0, :] = negacyclic_roll(base, tildeb)
    return acc


def inv_to_torus(r: torch.Tensor, ctx: RingCtx) -> torch.Tensor:
    """Residues [..., npr, N] (int32 or int64, in [0, p)) -> torus polys
    [..., N]: the NTT kernel's inverse transform, then Garner."""
    return from_crt(inv_ntt_nat(r.to(torch.int32), ctx.plan), ctx.crt, ctx.dtype)


def to_signed_limbs(v: torch.Tensor) -> torch.Tensor:
    """u32 [...] (int32 carrier) -> int8 [..., NLIMB] balanced limbs:
    v = sum l_j 2^(8j) (mod 2^32) with l_j in [-128, 128)."""
    v = v.long() & MASK32
    limbs = []
    for _ in range(NLIMB):
        d = v & 0xFF
        carry = d >> 7
        v = (v >> 8) + carry
        limbs.append((d - (carry << 8)).to(torch.int8))
    return torch.stack(limbs, dim=-1)


def sample_extract_coeffs(a: torch.Tensor) -> torch.Tensor:
    """Negacyclic sample extraction: [..., k, N] ring masks -> the LWE mask
    coefficients [a_0, -a_{N-1}, ..., -a_1]."""
    return torch.cat([a[..., :1], -torch.flip(a[..., 1:], dims=[-1])], dim=-1)


def build_ksk(gen: torch.Generator, ring_coeffs: torch.Tensor, lwe_key: LweKey, f: int, log_d: int, sigma: float):
    """Key-switching key as int8 limb matrices (reference common.py:92-116).

    ring_coeffs: [rows] u32 (int32 carrier), the target-key coefficients in
    extraction order.  One table row per (coeff, level j, digit value v) for
    v = 1..D/2, encrypting coeff * g_j * v.  Returns
    (ksk_b [NLIMB, R] int8, ksk_a [NLIMB, R, n] int8), R = rows * f * D/2.
    """
    half = (1 << log_d) // 2
    dev = ring_coeffs.device
    gvec = gadget_gvec(f, log_d, torch.int32, dev).long()
    vals = torch.arange(1, half + 1, dtype=torch.int64, device=dev)
    msgs = wrap_i32(ring_coeffs.long()[:, None, None] * gvec[None, :, None] * vals)
    ct = lwe_encrypt(gen, msgs, lwe_key, sigma, shape=tuple(msgs.shape))
    rows = msgs.numel()
    ksk_b = to_signed_limbs(ct.b.reshape(rows))  # [R, NLIMB]
    ksk_a = to_signed_limbs(ct.a.reshape(rows, -1))  # [R, n, NLIMB]
    return ksk_b.movedim(-1, 0).contiguous(), ksk_a.movedim(-1, 0).contiguous()


def signed_onehot(digits: torch.Tensor, log_d: int) -> torch.Tensor:
    """Balanced digits int32 [..., f] in [-D/2, D/2) -> signed one-hot int8
    [..., f*(D/2)]: entry (j, v) is sign(d_j) iff |d_j| == v."""
    half = 1 << (log_d - 1)
    vs = torch.arange(1, half + 1, dtype=digits.dtype, device=digits.device)
    d = digits[..., None]
    oh = (d == vs).to(torch.int8) - (d == -vs).to(torch.int8)
    return oh.reshape(*digits.shape[:-1], digits.shape[-1] * half)


def limb_dot(flat: torch.Tensor, ksk_b: torch.Tensor, ksk_a: torch.Tensor):
    """One-hot digits x limb tables, limbs recombined.

    Per party: flat int8 [..., k, R]; ksk_b [k, NLIMB, R]; ksk_a
    [k, NLIMB, R, n]; returns (db [..., k], da [..., k, n]).  One table:
    flat [..., R]; ksk_b [NLIMB, R]; ksk_a [NLIMB, R, n]; returns (db [...],
    da [..., n]).  int64, correct mod 2^32.  Exact: see the module docstring
    for the float64 bound.
    """
    single = ksk_b.dim() == 2
    if single:  # one table is one party
        flat, ksk_b, ksk_a = flat[..., None, :], ksk_b[None], ksk_a[None]
    dbs, das = [], []
    # one party at a time: the float64 images of a party's tables (147 MB a
    # limb at the non-block KMS presets) rather than of all k at once
    for party in range(ksk_b.shape[0]):
        x = flat[..., party, :].to(torch.float64)
        db = da = 0
        for limb in range(NLIMB):
            pb = x @ ksk_b[party, limb].to(torch.float64)
            pa = x @ ksk_a[party, limb].to(torch.float64)
            db = db + (pb.to(torch.int64) << (8 * limb))
            da = da + (pa.to(torch.int64) << (8 * limb))
        dbs.append(db)
        das.append(da)
    return (dbs[0], das[0]) if single else (torch.stack(dbs, -1), torch.stack(das, -2))


def keyswitch_table(acc: torch.Tensor, ksk_b: torch.Tensor, ksk_a: torch.Tensor, f: int, log_d: int) -> Lwe:
    """Single-key key switch (reference common.py:161-173).

    acc: [..., k+1, N] u32 (int32 carrier; component 0 = b); ksk_b
    [NLIMB, R], ksk_a [NLIMB, R, n] with R = k * N * f * D/2.  Returns an Lwe
    of dimension n.
    """
    arr = sample_extract_coeffs(acc[..., 1:, :])  # [..., k, N]
    oh = signed_onehot(balanced_decomp(arr, f, log_d), log_d)  # [..., k, N, f*D/2]
    db, da = limb_dot(oh.reshape(*oh.shape[:-3], -1), ksk_b, ksk_a)
    return Lwe(b=wrap_i32(acc[..., 0, 0].long() + db), a=wrap_i32(da))


def keyswitch_per_party(acc: torch.Tensor, ksk_b: torch.Tensor, ksk_a: torch.Tensor, f: int, log_d: int) -> Lwe:
    """Multi-key key switch (reference common.py:176-208).

    acc: [..., k+1, N] u32 (int32 carrier; component i >= 1 = party i's
    ring mask).  Each party's extracted coefficients key-switch against its
    own ksk; the partial b's sum and the a segments concatenate into the
    k*n mask.
    """
    db, a = keyswitch_parties(acc[..., 1:, :], ksk_b, ksk_a, f, log_d)
    return Lwe(b=wrap_i32(acc[..., 0, 0].long() + db), a=a)


def keyswitch_parties(masks: torch.Tensor, ksk_b: torch.Tensor, ksk_a: torch.Tensor, f: int, log_d: int):
    """The key switch of some parties' ring masks: masks [..., kp, N] u32
    (int32 carrier), ksk_b [kp, NLIMB, R], ksk_a [kp, NLIMB, R, n].  Returns
    the parties' share of b, int64 [...] not yet wrapped (shares of
    disjoint parties add up to `keyswitch_per_party`'s), and their a
    segments, int32 [..., kp*n]."""
    arr = sample_extract_coeffs(masks)  # [..., kp, N]
    oh = signed_onehot(balanced_decomp(arr, f, log_d), log_d)  # [..., kp, N, f*D/2]
    flat = oh.reshape(*oh.shape[:-2], -1)  # [..., kp, R]
    db, da = limb_dot(flat, ksk_b, ksk_a)
    return db.sum(-1), wrap_i32(da).reshape(*flat.shape[:-2], -1)


def keyswitch_partial(acc: torch.Tensor, n_free: int, ksk_b: torch.Tensor, ksk_a: torch.Tensor, f: int, log_d: int) -> Lwe:
    """LMSS partial key switch (reference common.py:211-231).

    The ring key's first n_free coefficients are the LWE key, so those
    extracted coefficients of the flattened [k*N] mask pass through; the
    tail goes through the balanced decomposition's signed one-hot against
    the value table (ksk rows cover only the tail: R = (k*N - n_free) * f *
    D/2).  acc: [..., k+1, N] u32 (int32 carrier); returns an Lwe of
    dimension n_free.
    """
    arr = sample_extract_coeffs(acc[..., 1:, :])  # [..., k, N]
    flat = arr.reshape(*arr.shape[:-2], -1)  # [..., k*N]
    oh = signed_onehot(balanced_decomp(flat[..., n_free:], f, log_d), log_d)  # [..., tail, f*D/2]
    db, da = limb_dot(oh.reshape(*oh.shape[:-2], -1), ksk_b, ksk_a)
    return Lwe(b=wrap_i32(acc[..., 0, 0].long() + db), a=wrap_i32(flat[..., :n_free].long() + da))
