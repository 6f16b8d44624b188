"""CCS19 uni-encryption against a common reference string (CRS).

Port of mktfhe_tpu/ciphertext/unienc.py.  A uni-encryption of m under
party key s is d_j = r * a_j + m * g_j + e (a = the CRS) and f = an RLEV
encryption of the ephemeral ternary key r under s; a party's public key is
b_j = -s * a_j + e.  The ring always has k = 1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ring.context import RingCtx
from ..ring.modring import mulmod_runtime, prime_column
from ..ring.ntt import fwd_ntt, inv_ntt
from ..ring.sampler import gaussian_torus, uniform_ternary, uniform_torus
from ..ring.torus import from_crt, lift
from .keys import RingKey
from .rlwe import gadget_gvec, rlev_encrypt


class UniEnc(NamedTuple):
    d: torch.Tensor  # [..., l, N] torus
    f: torch.Tensor  # [..., l, 2, N] torus (RLEV over a k=1 ring)


def sample_crs(gen: torch.Generator, l_uni: int, ctx: RingCtx) -> torch.Tensor:
    """Uniform CRS polynomials [l_uni, N]."""
    return uniform_torus(gen, (l_uni, ctx.n), ctx.dtype)


def _mul_hat(polys: torch.Tensor, s_hat: torch.Tensor, ctx: RingCtx) -> torch.Tensor:
    """Exact s * a_j for a stack of polys [l, N] and NTT images of ring
    elements s_hat [..., npr, N]; returns [..., l, N]."""
    ahat = fwd_ntt(lift(polys, ctx.crt), ctx.plan)
    prod = mulmod_runtime(s_hat[..., None, :, :], ahat, prime_column(ctx.nprimes, polys.device))
    return from_crt(inv_ntt(prod.to(torch.int32), ctx.plan), ctx.crt, ctx.dtype)


def gen_b(gen: torch.Generator, crs: torch.Tensor, key: RingKey, sigma: float, ctx: RingCtx) -> torch.Tensor:
    """Party public key b_j = -s a_j + e; [l, N]."""
    e = gaussian_torus(gen, tuple(crs.shape), sigma, ctx.dtype)
    return e - _mul_hat(crs, key.hat[0], ctx)


def unienc_encrypt(gen: torch.Generator, msg: torch.Tensor, crs: torch.Tensor, key: RingKey, sigma: float, l: int, log_b: int, ctx: RingCtx) -> UniEnc:
    """Uni-encrypt polynomial messages msg [..., N], each under its own
    ephemeral ternary key r; returns d [..., l, N], f [..., l, 2, N]."""
    lead = tuple(msg.shape[:-1])
    r = uniform_ternary(gen, (*lead, 1, ctx.n), ctx.dtype)[..., 0, :]
    msgpoly = gadget_gvec(l, log_b, ctx.dtype, msg.device)[:, None] * msg[..., None, :]
    e = gaussian_torus(gen, (*lead, l, ctx.n), sigma, ctx.dtype)
    d = _mul_hat(crs, fwd_ntt(lift(r, ctx.crt), ctx.plan), ctx) + msgpoly + e
    f = rlev_encrypt(gen, r, 0, key, sigma, l, log_b, ctx)
    return UniEnc(d=d, f=f)
