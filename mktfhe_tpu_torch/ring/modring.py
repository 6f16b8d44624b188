"""Exact modular arithmetic over the NTT-friendly CRT primes.

Port of mktfhe_tpu/ring/modring.py.  Residues are values in [0, p) with
p < 2^29.42; at rest they are int32 tensors, and arithmetic widens them to
int64.  A product of two residues is < 2^58.84, so a sum of up to
`MAX_PRODUCT_TERMS` = 16 such products stays below 2^63 and can be reduced
with a single `%` -- the plain twins use that in place of the reference's
per-product Shoup reductions (same canonical residue, fewer passes).

`shoup`/`shoup_mul` keep the reference's precomputed-quotient multiply
bit for bit: the CUDA NTT kernel uses it with `__umulhi`, and the plain NTT
twin uses this version so both run the same arithmetic.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Same primes as the reference (modring.py:42): each = 1 mod 2^13, 6p < 2^32.
PRIMES: tuple[int, ...] = (715825153, 715726849, 715694081, 715358209)
_PRIMITIVE_ROOTS: dict[int, int] = {
    715825153: 5,
    715726849: 11,
    715694081: 3,
    715358209: 13,
}

MASK32 = 0xFFFFFFFF
# 16 * (2^29.42)^2 < 2^63: products summed before one reduction.
MAX_PRODUCT_TERMS = 16


def nprimes_for_bits(torus_bits: int) -> int:
    """Number of CRT primes needed for a given torus width (32 or 64)."""
    if torus_bits == 32:
        return 2
    if torus_bits == 64:
        return 3
    raise ValueError(f"unsupported torus width {torus_bits}")


@functools.lru_cache(maxsize=None)
def prime_column(nprimes: int, device) -> torch.Tensor:
    """The first `nprimes` primes as an int64 [npr, 1] tensor on `device`
    (broadcasts against [..., npr, N] residues)."""
    return torch.tensor(PRIMES[:nprimes], dtype=torch.int64, device=device)[:, None]


def shoup(w: int, p: int) -> int:
    """Host-side Shoup precomputation: floor(w * 2^32 / p), for 0 <= w < p."""
    assert 0 <= w < p
    return (w << 32) // p


def mulhi_u32(x, y):
    """High 32 bits of the 64-bit product of two u32 values held in int64.

    The product of two values < 2^32 may pass 2^63 and wrap the int64, but
    the wrapped bits are the true product mod 2^64, so masking after the
    shift still gives the exact high word.
    """
    return ((x * y) >> 32) & MASK32


def shoup_mul(w, w_shoup, a, p):
    """(w * a) mod p for a constant w < p with w_shoup = floor(w 2^32 / p),
    exact for any a < 2^32 (int64 tensors holding u32 values)."""
    q = mulhi_u32(w_shoup, a)
    r = (w * a - q * p) & MASK32  # in [0, 2p)
    return torch.where(r >= p, r - p, r)


def mulmod_runtime(a, b, p):
    """(a * b) mod p for two runtime residues in [0, p)."""
    return torch.remainder(a.long() * b.long(), p)


def addmod(a, b, p):
    """(a + b) mod p for a, b in [0, p)."""
    s = a + b
    return torch.where(s >= p, s - p, s)


def submod(a, b, p):
    """(a - b) mod p for a, b in [0, p)."""
    d = a + (p - b)
    return torch.where(d >= p, d - p, d)


def negmod(a, p):
    """(-a) mod p for a in [0, p)."""
    return torch.where(a == 0, a, p - a)


def reduce_u32(x, p):
    """x mod p for any u32 x (int32 carrier or int64 holding a u32)."""
    return torch.remainder(x.long() & MASK32, p)


def modsum(x, dim: int, p):
    """Sum of residues in [0, p) along `dim`, mod p (int64 result)."""
    return torch.remainder(x.long().sum(dim), p)


def mulsum_mod(x, y, dim: int, p):
    """sum(x * y) mod p along `dim` for residues x, y in [0, p): the
    products are summed unreduced (at most MAX_PRODUCT_TERMS of them) and
    reduced once.  The exact contraction of the reference's Shoup multiply
    + modular tree-sum (modring.modsum), int64 result."""
    prods = x.long() * y.long()
    if prods.shape[dim] > MAX_PRODUCT_TERMS:
        raise ValueError(
            f"{prods.shape[dim]} products would overflow int64; at most "
            f"{MAX_PRODUCT_TERMS} may be summed before a reduction"
        )
    return torch.remainder(prods.sum(dim), p)


@functools.lru_cache(maxsize=None)
def _root_of_unity(p: int, order: int) -> int:
    """Primitive `order`-th root of unity mod p (host-side Python ints)."""
    assert (p - 1) % order == 0
    g = _PRIMITIVE_ROOTS[p]
    w = pow(g, (p - 1) // order, p)
    assert pow(w, order // 2, p) == p - 1
    return w


def _bitrev_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev
