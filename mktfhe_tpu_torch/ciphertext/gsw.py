"""RGSW ciphertexts and the external product (port of ciphertext/gsw.py).

An RGSW encryption of m is the stacked tensor [cin, l, cout, N]: row
(ci, j) is an RLWE sample with m * g_j added to component ci.
"""

from __future__ import annotations

import torch

from ..ring.context import RingCtx
from ..ring.modring import mulsum_mod, prime_column
from ..ring.ntt import fwd_ntt
from ..ring.torus import lift
from .decomp import balanced_decomp
from .keys import RingKey
from .rlwe import gadget_gvec, rlwe_sample


def rgsw_encrypt(gen: torch.Generator, msg: torch.Tensor, key: RingKey, sigma: float, l: int, log_b: int, ctx: RingCtx) -> torch.Tensor:
    """RGSW of scalar messages: msg [...] torus -> [..., cin, l, cout, N].

    Batched over msg's axes (the reference vmaps over key bits,
    kms.py:132-137); every message is a constant polynomial.
    """
    kp1 = key.k + 1
    dev = msg.device
    gvec = gadget_gvec(l, log_b, ctx.dtype, dev)
    msgpoly = torch.zeros((*msg.shape, l, ctx.n), dtype=ctx.dtype, device=dev)
    msgpoly[..., 0] = gvec * msg[..., None]
    sample = rlwe_sample(gen, key, sigma, ctx, shape=(*msg.shape, kp1, l))
    onehot = torch.eye(kp1, dtype=ctx.dtype, device=dev)
    return sample + onehot[:, None, :, None] * msgpoly[..., None, :, None, :]


def rgsw_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Homomorphic RGSW add: the stacks add, wrapping (reference gsw.py:47)."""
    return x + y


def rgsw_sub(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Homomorphic RGSW subtract (reference gsw.py:53)."""
    return x - y


def rgsw_to_hat(stack: torch.Tensor, ctx: RingCtx) -> torch.Tensor:
    """NTT-domain image of an RGSW stack (balanced lift)."""
    return fwd_ntt(lift(stack, ctx.crt), ctx.plan)


def rlwe_decomp_hat(ct: torch.Tensor, l: int, log_b: int, ctx: RingCtx, fwd=fwd_ntt) -> torch.Tensor:
    """Gadget-decompose torus polynomials [..., N] (an RLWE ciphertext
    [..., k+1, N], on either torus) and transform the digits: int32 residues
    [..., l, npr, N].  `fwd` may be the NTT kernel's wrapper
    (kernels/ntt.py:fwd_ntt_nat), bit-identical."""
    digits = balanced_decomp(ct, l, log_b).movedim(-1, -2)  # [..., l, N]
    return fwd(lift(digits, ctx.crt), ctx.plan)


def external_product_hat(dhat: torch.Tensor, hat: torch.Tensor, ctx: RingCtx) -> torch.Tensor:
    """Contract decomposed digits against an RGSW stack, in the NTT domain.

    dhat: [..., cin, l, npr, N]; hat: [..., cin, l, cout, npr, N] (leading
    axes broadcast).  Returns int64 residues [..., cout, npr, N].
    """
    p = prime_column(ctx.nprimes, dhat.device)
    cin, l = dhat.shape[-4], dhat.shape[-3]
    # merge (cin, l) into one contraction axis of cin*l <= 16 terms
    x = dhat.reshape(*dhat.shape[:-4], cin * l, 1, *dhat.shape[-2:])
    w = hat.reshape(*hat.shape[:-5], cin * l, *hat.shape[-3:])
    return mulsum_mod(x, w, -4, p)
