"""Ring context: bundles ring dimension, torus dtype, NTT and CRT plans.

Port of mktfhe_tpu/ring/context.py.  The context is device-free: tensors
derived from its plans are cached per device by the functions that use
them, keyed on the device of their input.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from .modring import PRIMES, nprimes_for_bits
from .ntt import NttPlan, make_plan
from .torus import CrtPlan, bits_of, make_crt_plan, torus_dtype


class RingCtx(NamedTuple):
    """Everything needed for exact arithmetic in Z_q[X]/(X^N+1)."""

    n: int
    dtype: torch.dtype
    plan: NttPlan
    crt: CrtPlan

    @property
    def torus_bits(self) -> int:
        return bits_of(self.dtype)

    @property
    def nprimes(self) -> int:
        return self.plan.nprimes


@functools.lru_cache(maxsize=None)
def make_ring_ctx(n: int, torus_bits: int, nprimes: int | None = None) -> RingCtx:
    npr = nprimes if nprimes is not None else nprimes_for_bits(torus_bits)
    return RingCtx(
        n=n, dtype=torus_dtype(torus_bits), plan=make_plan(n, npr), crt=make_crt_plan(npr)
    )


def nprimes_needed(torus_bits: int, n: int, terms) -> int:
    """Smallest CRT prime count whose range covers every contraction.

    terms: iterable of (halfB, nterms); the worst reconstructed integer has
    |value| <= halfB * 2^(torus_bits-1) * N * nterms and must stay below
    prod(primes)/2 for balanced Garner reconstruction to be exact.
    """
    worst = max(2 * half_b * (1 << (torus_bits - 1)) * n * nt for half_b, nt in terms)
    npr = nprimes_for_bits(torus_bits)
    while math.prod(PRIMES[:npr]) <= worst:
        npr += 1
        assert npr <= len(PRIMES), "contraction exceeds available CRT range"
    return npr


def nprimes_monomial_weighted(torus_bits: int, n: int, l_gsw: int, log_b_gsw: int) -> int:
    """CRT primes that cover a rank-1 external product (2 * l_gsw digit terms)
    weighted by X^a - 1 in the evaluation domain: the two-term monomial
    doubles the bound against a roll on the torus."""
    return nprimes_needed(torus_bits, n, [(1 << (log_b_gsw - 1), 2 * l_gsw * 2)])
