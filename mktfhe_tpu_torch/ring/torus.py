"""Torus scalar operations and CRT lifting/reconstruction.

Port of mktfhe_tpu/ring/torus.py.  Torus values on the 2^32 / 2^64 torus
live in int32 / int64 tensors: the same bits as the reference's uint32 /
uint64, and add and multiply wrap identically.  What differs is every right
shift and every unsigned compare, which are written out here explicitly
(`logical_shr`; the balanced lift reads the sign bit directly).

The balanced CRT lift maps a torus value to its representative in
[-q/2, q/2) -- which is exactly the signed value of the int carrier -- so
`lift` is one `torch.remainder` per prime.  Reconstruction is Garner's
mixed-radix algorithm with wrapping Horner evaluation, as in the reference.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .modring import MASK32, PRIMES, prime_column

_BITS = {torch.int32: 32, torch.int64: 64}


def bits_of(dtype: torch.dtype) -> int:
    """Torus width carried by an int32 / int64 tensor dtype."""
    return _BITS[dtype]


def torus_dtype(bits: int) -> torch.dtype:
    """Carrier dtype of the 2^bits torus."""
    return torch.int32 if bits == 32 else torch.int64


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 tensor as an int32 carrier (x mod 2^32)."""
    return (((x & MASK32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def to_carrier(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An int64 result of torus arithmetic, reduced to the carrier `dtype`."""
    return wrap_i32(x) if dtype == torch.int32 else x


def signed(v: int, bits: int) -> int:
    """A value mod 2^bits as the signed integer its carrier holds."""
    v %= 1 << bits
    return v - (1 << bits) if v >> (bits - 1) else v


def logical_shr(a: torch.Tensor, k: int) -> torch.Tensor:
    """Unsigned right shift by 0 < k < T of a T-bit carrier."""
    t = bits_of(a.dtype)
    assert 0 < k < t
    return (a >> k) & ((1 << (t - k)) - 1)


def divbits(a: torch.Tensor, bit: int) -> torch.Tensor:
    """Round-to-nearest shift: round(a / 2^bit), wrapped in T-bit arithmetic
    (reference torus.py:47-57)."""
    if bit == 0:
        return a
    return logical_shr(a, bit) + ((a >> (bit - 1)) & 1)


class CrtPlan(NamedTuple):
    """Host constants for CRT reconstruction (reference make_crt_plan)."""

    nprimes: int
    primes: tuple  # python ints
    inv_pj: tuple  # inv_pj[i][j] = p_j^{-1} mod p_i, for j < i
    prod_mod32: int  # prod(primes) mod 2^32
    prod_mod64: int  # prod(primes) mod 2^64


@functools.lru_cache(maxsize=None)
def make_crt_plan(nprimes: int) -> CrtPlan:
    ps = PRIMES[:nprimes]
    inv_pj = tuple(tuple(pow(ps[j], -1, ps[i]) for j in range(i)) for i in range(nprimes))
    prod = 1
    for p in ps:
        prod *= p
    return CrtPlan(
        nprimes=nprimes,
        primes=ps,
        inv_pj=inv_pj,
        prod_mod32=prod % (1 << 32),
        prod_mod64=prod % (1 << 64),
    )


def lift(a: torch.Tensor, plan: CrtPlan) -> torch.Tensor:
    """Torus [..., N] -> balanced residues int32 [..., npr, N] in [0, p_i).

    Covers the reference's lift_u32, lift_u64 and lift_signed_small: the
    balanced representative of a torus value is the signed value of its
    carrier, and a small signed digit is its own representative.
    """
    p = prime_column(plan.nprimes, a.device)
    return torch.remainder(a.long()[..., None, :], p).to(torch.int32).contiguous()


def _garner_digits(r: torch.Tensor, plan: CrtPlan):
    """Mixed-radix digits t_i (int64, in [0, p_i)) of residues [..., npr, N]."""
    ps = plan.primes
    t = [r[..., 0, :].long()]
    for i in range(1, plan.nprimes):
        u = r[..., i, :].long()
        for j in range(i):
            # |u - t_j| < 2^30 and p_j^{-1} < 2^30: the product fits int64
            u = torch.remainder((u - t[j]) * plan.inv_pj[i][j], ps[i])
        t.append(u)
    return t


def _garner(r: torch.Tensor, plan: CrtPlan, bits: int) -> torch.Tensor:
    """Balanced representative mod 2^bits, as an int64 holding its low bits."""
    t = _garner_digits(r, plan)
    ps = plan.primes
    x = t[-1]
    for i in range(plan.nprimes - 2, -1, -1):
        x = t[i] + ps[i] * x  # wrapping int64 Horner
    prod = plan.prod_mod64 if bits == 64 else plan.prod_mod32
    neg = t[-1] >= ps[-1] // 2
    return torch.where(neg, x - signed(prod, 64), x)


def from_crt_u32(r: torch.Tensor, plan: CrtPlan) -> torch.Tensor:
    """Residues [..., npr, N] -> balanced representative mod 2^32 (int32)."""
    return wrap_i32(_garner(r, plan, 32))


def from_crt_u64(r: torch.Tensor, plan: CrtPlan) -> torch.Tensor:
    """Residues [..., npr, N] -> balanced representative mod 2^64 (int64)."""
    return _garner(r, plan, 64)


def from_crt(r: torch.Tensor, plan: CrtPlan, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.int32:
        return from_crt_u32(r, plan)
    assert dtype == torch.int64
    return from_crt_u64(r, plan)


def negacyclic_roll(v: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """v(X) * X^shift in Z_q[X]/(X^N+1), as a gather.

    v: [..., N]; shift: integer tensor in [0, 2N) broadcastable to
    v.shape[:-1] (one shift per polynomial -- the reference vmaps a scalar
    shift over the gate axis, kms.py:249).  Output coefficient j reads
    [v, -v][(j - shift) mod 2N], the reference's roll of the extended
    vector (torus.py:209-221).
    """
    n = v.shape[-1]
    lead = torch.broadcast_shapes(v.shape[:-1], shift.shape)
    ext = torch.cat([v, -v], dim=-1).expand(*lead, 2 * n)
    j = torch.arange(n, device=v.device)
    idx = torch.remainder(j - shift.long()[..., None], 2 * n).expand(*lead, n)
    return torch.gather(ext, -1, idx)
