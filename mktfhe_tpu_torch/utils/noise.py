"""Noise-budget measurement: empirical phase-error statistics.

Port of mktfhe_tpu/utils/noise.py.  The arithmetic is exact, so every bit of
observed phase error comes from the scheme's own noise terms (encryption
noise, decomposition rounding, modulus-switch rounding), and the measured
margins validate a parameter set (MARGINS.md).

The margin of a binary TFHE ciphertext is 1/16 of the torus (from the
+-1/8 message centres to the decision boundary); `margin_sigmas` is how
many noise standard deviations fit in it.

The torus width is read from the carrier dtype (int32: 2^32, int64: 2^64).
The phases are computed on the ciphertext's device; only the errors (and
in `noise_report` only the statistics) come back to the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ciphertext.keys import LweKey
from ..ciphertext.lwe import Lwe
from ..ring.torus import bits_of, wrap_i32


def _phase_error(out: Lwe, keys: list[LweKey], want) -> torch.Tensor:
    """Signed phase error on the ciphertext's device, int64."""
    t = bits_of(out.b.dtype)
    n = keys[0].key.shape[-1]
    ph = out.b.long()
    for i, key in enumerate(keys):
        seg = out.a[..., i * n : (i + 1) * n].long()
        ph = ph + (seg * key.key.to(out.a.device).long()).sum(-1)  # wraps mod 2^64
    want = torch.as_tensor(np.asarray(want), device=out.b.device, dtype=torch.bool)
    eighth = 1 << (t - 3)
    err = ph - torch.where(want, eighth, -eighth)
    return wrap_i32(err).long() if t == 32 else err


def phase_error_bits(out: Lwe, keys: list[LweKey], want) -> np.ndarray:
    """Signed phase error (in torus units) of bootstrapped ciphertexts
    against the ideal +-1/8 encodings of `want`, int64 numpy."""
    return _phase_error(out, keys, want).cpu().numpy()


def noise_report(out: Lwe, keys: list[LweKey], want) -> dict:
    """Summary statistics of bootstrap output noise (the JAX function's keys)."""
    t = bits_of(out.b.dtype)
    err = _phase_error(out, keys, want).double()
    std = float(err.std(correction=0))
    margin = float(1 << (t - 4))  # 1/16 torus to the decision boundary
    return {
        "samples": int(err.numel()),
        "std_bits": math.log2(std) if std > 0 else 0.0,
        "max_abs_bits": math.log2(float(err.abs().max()) + 1),
        "margin_bits": math.log2(margin),
        "margin_sigmas": margin / std if std > 0 else float("inf"),
    }
