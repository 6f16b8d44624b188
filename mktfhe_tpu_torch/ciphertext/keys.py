"""Secret keys: LWE vectors and ring (RLWE) keys with NTT-domain mirrors.

Port of mktfhe_tpu/ciphertext/keys.py.  A ring key carries its
coefficients and their forward-NTT image; the port multiplies with int64
`%` and stores no Shoup companions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ring.context import RingCtx
from ..ring.ntt import fwd_ntt
from ..ring.sampler import block_binary, uniform_binary, uniform_ternary
from ..ring.torus import lift


class LweKey(NamedTuple):
    """Binary / ternary / block-binary LWE secret."""

    key: torch.Tensor  # [n] torus carrier, entries 0/1 (or -1/0/1)

    @property
    def n(self) -> int:
        return self.key.shape[-1]


class RingKey(NamedTuple):
    """RLWE secret: k polynomials + NTT-domain mirror."""

    key: torch.Tensor  # [k, N] torus carrier
    hat: torch.Tensor  # [k, npr, N] int32

    @property
    def k(self) -> int:
        return self.key.shape[0]


def _mk_ringkey(coeffs: torch.Tensor, ctx: RingCtx) -> RingKey:
    return RingKey(key=coeffs, hat=fwd_ntt(lift(coeffs, ctx.crt), ctx.plan))


def binary_lwe_key(gen: torch.Generator, n: int, dtype: torch.dtype) -> LweKey:
    return LweKey(key=uniform_binary(gen, (n,), dtype))


def ternary_lwe_key(gen: torch.Generator, n: int, dtype: torch.dtype) -> LweKey:
    return LweKey(key=uniform_ternary(gen, (n,), dtype))


def block_binary_lwe_key(gen: torch.Generator, d: int, ell: int, dtype: torch.dtype) -> LweKey:
    return LweKey(key=block_binary(gen, d, ell, dtype))


def binary_ring_key(gen: torch.Generator, k: int, ctx: RingCtx) -> RingKey:
    return _mk_ringkey(uniform_binary(gen, (k, ctx.n), ctx.dtype), ctx)


def ternary_ring_key(gen: torch.Generator, k: int, ctx: RingCtx) -> RingKey:
    return _mk_ringkey(uniform_ternary(gen, (k, ctx.n), ctx.dtype), ctx)


def partial_ring_key(gen: torch.Generator, k: int, lwe_key: LweKey, ctx: RingCtx) -> RingKey:
    """Ring key whose first n coefficients are the LWE key bits (the LMSS
    free partial key switch, reference keys.py:72-84)."""
    n = lwe_key.n
    total = k * ctx.n
    assert n <= total
    fill = uniform_binary(gen, (total - n,), ctx.dtype)
    flat = torch.cat([lwe_key.key.to(ctx.dtype), fill])
    return _mk_ringkey(flat.reshape(k, ctx.n), ctx)
