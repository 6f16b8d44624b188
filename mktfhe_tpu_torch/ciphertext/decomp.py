"""Balanced gadget decomposition (port of mktfhe_tpu/ciphertext/decomp.py).

Digit index convention: output axis -1 has length l with index j
corresponding to gadget entry g_j = 2^(T - (j+1)*logB).
"""

from __future__ import annotations

import torch

from ..ring.torus import bits_of, divbits, logical_shr


def balanced_decomp(a: torch.Tensor, l: int, log_b: int) -> torch.Tensor:
    """Signed digit decomposition; a torus [...] -> int32 [..., l].

    sum_j digits[j] * g_j == round(a / 2^low) * 2^low (mod 2^T), digits in
    [-B/2, B/2), the top digit's carry wrapping away (decomp.py:37-61).
    The carry chain shifts the running value as UNSIGNED (logical_shr), as
    the reference's uint arithmetic does.
    """
    t = bits_of(a.dtype)
    low = t - l * log_b
    assert low >= 0
    ai = divbits(a, low)
    mask = (1 << log_b) - 1
    half_b = 1 << (log_b - 1)
    digs = []
    for lev in range(l, 0, -1):
        d = ai & mask
        if lev > 1:
            ai = logical_shr(ai, log_b) + (d >> (log_b - 1))
        digs.append((d - ((d & half_b) << 1)).to(torch.int32))
    digs.reverse()
    return torch.stack(digs, dim=-1)
