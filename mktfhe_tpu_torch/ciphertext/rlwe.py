"""RLWE / RLEV ciphertexts as stacked component tensors.

Port of mktfhe_tpu/ciphertext/rlwe.py.  An RLWE ciphertext is one tensor
[..., k+1, N] with component 0 = b and components 1..k = the masks; an
RLEV is [..., l, k+1, N].
"""

from __future__ import annotations

import functools

import torch

from ..ring.context import RingCtx
from ..ring.modring import mulsum_mod, prime_column
from ..ring.ntt import fwd_ntt, inv_ntt
from ..ring.sampler import gaussian_torus, uniform_torus
from ..ring.torus import bits_of, from_crt, lift, signed
from .keys import RingKey


def rlwe_sample(gen: torch.Generator, key: RingKey, sigma: float, ctx: RingCtx, shape=()) -> torch.Tensor:
    """Fresh RLWE encryption of zero: b = -sum_i s_i a_i + e, exact through
    the CRT-NTT.  Returns [..., k+1, N] (component 0 = b)."""
    a = uniform_torus(gen, (*shape, key.k, ctx.n), ctx.dtype)
    ahat = fwd_ntt(lift(a, ctx.crt), ctx.plan)
    p = prime_column(ctx.nprimes, a.device)
    acc = mulsum_mod(key.hat, ahat, -3, p)
    s_dot_a = from_crt(inv_ntt(acc.to(torch.int32), ctx.plan), ctx.crt, ctx.dtype)
    e = gaussian_torus(gen, (*shape, ctx.n), sigma, ctx.dtype)
    return torch.cat([(e - s_dot_a)[..., None, :], a], dim=-2)


def rlwe_encrypt_msg(gen: torch.Generator, msg: torch.Tensor, comp: int, key: RingKey, sigma: float, ctx: RingCtx, shape=()) -> torch.Tensor:
    """Encrypt by adding `msg` to component `comp` of fresh samples
    [*shape, k+1, N]: a polynomial msg [..., N] to the whole component, a
    scalar (or a tensor whose last axis is not N) to its coefficient 0.
    comp = 0 adds to b, comp = i to the mask a_i."""
    ct = rlwe_sample(gen, key, sigma, ctx, shape)
    msg = torch.as_tensor(msg, dtype=ctx.dtype, device=ct.device)
    if msg.dim() == 0 or msg.shape[-1] != ctx.n:
        ct[..., comp, 0] += msg
    else:
        ct[..., comp, :] += msg
    return ct


def rlwe_phase(ct: torch.Tensor, key: RingKey, ctx: RingCtx) -> torch.Tensor:
    """b + sum_i s_i a_i, exact through the CRT-NTT; ct [..., k+1, N] ->
    [..., N]."""
    ahat = fwd_ntt(lift(ct[..., 1:, :], ctx.crt), ctx.plan)
    acc = mulsum_mod(key.hat, ahat, -3, prime_column(ctx.nprimes, ct.device))
    return ct[..., 0, :] + from_crt(inv_ntt(acc.to(torch.int32), ctx.plan), ctx.crt, ctx.dtype)


@functools.lru_cache(maxsize=None)
def gadget_gvec(l: int, log_b: int, dtype: torch.dtype, device) -> torch.Tensor:
    """g_j = 2^(T - (j+1) logB), j = 0..l-1, in the torus carrier; made once
    per device (a copy from the host is a sync, which no CUDA graph of a
    bootstrap can hold) and shared: read it, never write into it."""
    t = bits_of(dtype)
    vals = [signed(1 << (t - (j + 1) * log_b), t) for j in range(l)]
    return torch.tensor(vals, dtype=dtype, device=device)


def rlev_encrypt(gen: torch.Generator, msg: torch.Tensor, comp: int, key: RingKey, sigma: float, l: int, log_b: int, ctx: RingCtx) -> torch.Tensor:
    """RLEV: l RLWE rows encrypting g_j * msg on component `comp`.

    msg: polys [..., N].  Returns [..., l, k+1, N].
    """
    gvec = gadget_gvec(l, log_b, ctx.dtype, msg.device)
    ct = rlwe_sample(gen, key, sigma, ctx, shape=(*msg.shape[:-1], l))
    ct[..., comp, :] += gvec[:, None] * msg[..., None, :]
    return ct
