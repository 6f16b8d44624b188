"""Balanced and unbalanced gadget decomposition (port of
mktfhe_tpu/ciphertext/decomp.py).

Digit index convention: output axis -1 has length l with index j
corresponding to gadget entry g_j = 2^(T - (j+1)*logB).
"""

from __future__ import annotations

import torch

from ..ring.torus import bits_of, divbits, signed


def balanced_decomp(a: torch.Tensor, l: int, log_b: int) -> torch.Tensor:
    """Signed digit decomposition; a torus [...] -> int32 [..., l].

    sum_j digits[j] * g_j == round(a / 2^low) * 2^low (mod 2^T), digits in
    [-B/2, B/2), the top digit's carry wrapping away (reference
    decomp.py:37-61).  The reference's carry chain is one addition here:
    with B/2 added at every digit position, each balanced digit is the
    unsigned digit of the sum less B/2 (a digit >= B/2 carries one into the
    next position, as in the chain), and the carry out of the top digit
    wraps away with the bits above it.  So all l digits come from one
    shifted and masked tensor (a digit's bits lie below bit T, so the
    arithmetic shift of the carrier reads them as the unsigned one would).
    """
    t = bits_of(a.dtype)
    low = t - l * log_b
    assert low >= 0
    half_b = 1 << (log_b - 1)
    offset = signed(sum(half_b << (j * log_b) for j in range(l)), t)
    shifts = torch.arange(l - 1, -1, -1, dtype=a.dtype, device=a.device) * log_b
    x = divbits(a, low) + offset
    return (((x[..., None] >> shifts) & ((1 << log_b) - 1)) - half_b).to(torch.int32)


def unbalanced_decomp(a: torch.Tensor, l: int, log_b: int) -> torch.Tensor:
    """Non-negative digit decomposition; a torus [...] -> int32 [..., l] in
    [0, B) (reference decomp.py:64-78): the digits of round(a / 2^low), from
    one shifted and masked tensor as in `balanced_decomp`."""
    t = bits_of(a.dtype)
    low = t - l * log_b
    assert low >= 0
    shifts = torch.arange(l - 1, -1, -1, dtype=a.dtype, device=a.device) * log_b
    return ((divbits(a, low)[..., None] >> shifts) & ((1 << log_b) - 1)).to(torch.int32)
