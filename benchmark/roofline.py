"""The yardstick of the kernels' shares: the card's peaks and the work of a
phase-1 sweep counted from its shapes.

Frozen from the port's smoke script (`chip_smoke.py`: `sweep_step_ops`,
`sweep_bound`, the peaks) in its canonical radix-2 count, which reads the
same work whatever kernel runs it: per step of one (gate, row), per prime,
the 2 l_gsw digit polynomials and their forward transforms, the pointwise
products, two inverse transforms scaled by 1/N, then per coefficient a
Garner reconstruction mod 2^64 and the accumulation.

The peaks are those of NVIDIA's H100 SXM data sheet at its 700 W limit:
3.35 TB/s of device memory, and 33.5 T 32-bit integer operations/s, which is
assumed: Hopper runs integer arithmetic outside the tensor cores on half of
the lanes that give the data sheet's 67 TFLOP/s of float32 (a multiply-add
counted as two).  A share against them is read on a card whose power limit
the run prints beside it.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12  # assumed, see above

OPS_SHOUP_MUL = 6  # mulhi, two mullo, subtract, compare, subtract
OPS_BUTTERFLY = OPS_SHOUP_MUL + 3 + 4  # + add_mod + sub_mod
OPS_PRODUCT_TERM = 4  # 32x32 -> 64 multiply (lo, hi) and a 64-bit add
OPS_BARRETT = 12  # 64x64 high product as eight 32-bit mul/adds, then as Shoup's tail
OPS_DIGIT = 5  # mask, shift, carry add, sign test, lift

# the CRT primes' sizes the count assumes (four primes of about 2^29.42,
# as the scheme's exact engines use; the prime count follows from the
# parameters' largest contraction)
PRIME_BITS = (715825153, 715726849, 715694081, 715358209)


def ring_nprimes(params) -> int:
    """Primes whose product covers twice every contraction's integer bound
    on the 2^64 torus: phase 1's (monomial-weighted) external products,
    phase 2's LEV contraction and hybrid product over up to k components."""
    n, k = params.big_n, max(params.k, 1)
    terms = [
        (1 << (params.log_b_gsw - 1), params.l_gsw * 2 * (params.members * 2 if params.block else 1)),
        (1 << (params.log_b_lev - 1), params.l_lev * k),
        (1 << (params.log_b_uni - 1), params.l_uni * k),
    ]
    worst = max(2 * half * (1 << 63) * n * nt for half, nt in terms)
    npr = 3
    while math.prod(PRIME_BITS[:npr]) <= worst:
        npr += 1
    return npr


def sweep_step_ops(n: int, npr: int, l: int, per_position: int, accumulate: int) -> int:
    """32-bit integer operations of one step of one (gate, row) of a sweep,
    in canonical radix-2 arithmetic (2^64 torus)."""
    log_n = n.bit_length() - 1
    fwd = inv = n // 2 * log_n * OPS_BUTTERFLY
    digits = 2 * l * n * OPS_DIGIT
    per_prime = digits + 2 * l * fwd + n * per_position + 2 * inv + 2 * n * OPS_SHOUP_MUL
    horner = (npr - 1) * 8 + 4
    garner = npr * (npr - 1) // 2 * (OPS_SHOUP_MUL + 4 + 2) + horner
    return npr * per_prime + 2 * n * (garner + accumulate)


def sweep_bound_ms(params, gates: int, rows: int, distinct_amounts: int) -> float:
    """Least time of one party's sweep on the card: the larger of its bytes
    (the accumulator read and written, the rotation amounts, the party's key
    rows, the twiddles and, for block keys, the monomial images of the
    distinct amounts, each once) over the memory peak and its operations
    over the integer peak."""
    n, l = params.big_n, params.l_gsw
    npr = ring_nprimes(params)
    block = params.block
    ell = params.members
    steps = params.n // ell
    nbytes = (2 * gates * rows * 2 * n * 8 + gates * params.n * 4 + params.n * 2 * l * 2 * npr * n * 4
              + 4 * npr * n * 4)
    if block:
        nbytes += distinct_amounts * npr * n * 4
    member = 2 * (2 * l * OPS_PRODUCT_TERM + OPS_BARRETT) + (2 * (OPS_PRODUCT_TERM + OPS_BARRETT) if block else 0)
    ops = gates * rows * steps * sweep_step_ops(n, npr, l, ell * member, 2 if block else 8)
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
