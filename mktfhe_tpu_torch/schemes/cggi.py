"""CGGI16 single-key gate bootstrapping (port of schemes/cggi.py).

The reference engine of the CGGI path: the n-step blind rotation as a
Python loop in plain PyTorch (the reference's `lax.scan`), every NTT of it
through the CUDA NTT kernel's wrapper kernels/ntt.py (on CPU tensors, its
plain twin).  The monomial multiply (X^a - 1) is a negacyclic roll on the
torus.  LWE ciphertexts and the ring accumulator both live on the 2^32
torus (int32 carriers, exact via 2 CRT primes at the CGGI preset).

The scheme stores the bootstrapping key in the NTT domain without a Shoup
companion: products of runtime residues are reduced with int64 `%`.  The
batch-minor engine (kernels/batchminor.py) and the fused engine
(kernels/fused_step.py) compute the same bits from the same keys.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ciphertext.gsw import external_product_hat, rgsw_encrypt, rgsw_to_hat, rlwe_decomp_hat
from ..ciphertext.keys import LweKey, RingKey, binary_lwe_key, binary_ring_key
from ..ciphertext.lwe import Lwe
from ..kernels.ntt import fwd_ntt_nat
from ..ring.context import RingCtx, make_ring_ctx
from ..ring.sampler import rng_streams
from ..ring.torus import negacyclic_roll
from ..utils.profiling import phase_range
from .common import build_ksk, initial_acc, inv_to_torus, keyswitch_table, mod_switch_2n
from .params import CggiParams

# top-level sampling streams consumed by keygen (ring/sampler.rng_streams)
KEYGEN_STREAMS = 4


@dataclass(frozen=True)
class CggiScheme:
    """Runtime scheme state: the NTT-domain bootstrapping key as int32
    residues and the key-switching key as int8 limb tables."""

    brk_hat: torch.Tensor  # [n, k+1, l, k+1, npr, N]
    ksk_b: torch.Tensor  # [NLIMB, R] int8, R = k*N*f*D/2
    ksk_a: torch.Tensor  # [NLIMB, R, n] int8


def _ctx(params: CggiParams) -> RingCtx:
    return make_ring_ctx(params.big_n, params.torus_bits, params.nprimes)


def setup(gen, params: CggiParams) -> tuple[LweKey, RingKey, CggiScheme]:
    """Keygen on the generators' device: (lwe_key, ring_key, scheme).

    gen: one torch.Generator or KEYGEN_STREAMS of them (rng_streams).
    brk[i] = NTT(RGSW(s_i)); the ksk rows encrypt the ring-key coefficients
    in extraction order (common.build_ksk).
    """
    ctx = _ctx(params)
    g_lwe, g_ring, g_brk, g_ksk = rng_streams(gen, KEYGEN_STREAMS)
    lwe_key = binary_lwe_key(g_lwe, params.n, torch.int32)
    ring_key = binary_ring_key(g_ring, params.k, ctx)
    brk = rgsw_encrypt(
        g_brk, lwe_key.key.to(ctx.dtype), ring_key, params.beta, params.l_gsw, params.log_b_gsw, ctx
    )
    coeffs = ring_key.key.reshape(-1).to(torch.int32)
    ksk_b, ksk_a = build_ksk(g_ksk, coeffs, lwe_key, params.f, params.log_d, params.alpha)
    return lwe_key, ring_key, CggiScheme(brk_hat=rgsw_to_hat(brk, ctx), ksk_b=ksk_b, ksk_a=ksk_a)


def blind_rotate(acc: torch.Tensor, tildea: torch.Tensor, scheme: CggiScheme, params: CggiParams, ctx: RingCtx) -> torch.Tensor:
    """n sequential CMux steps.  acc: [G, k+1, N]; tildea: [G, n] values in
    [0, 2N).  Step: decompose acc -> NTT -> external product with brk_i ->
    inverse NTT -> acc += X^{a_i} e - e (a_i = 0 contributes zero)."""
    for i in range(params.n):
        dhat = rlwe_decomp_hat(acc, params.l_gsw, params.log_b_gsw, ctx, fwd_ntt_nat)
        ehat = external_product_hat(dhat, scheme.brk_hat[i], ctx)
        e = inv_to_torus(ehat, ctx)
        acc = acc + negacyclic_roll(e, tildea[:, i, None]) - e
    return acc


def bootstrap(ct: Lwe, scheme: CggiScheme, params: CggiParams) -> Lwe:
    """Gate bootstrap of a batch of LWE ciphertexts.  ct: Lwe with b [G],
    a [G, n]."""
    ctx = _ctx(params)
    with phase_range("mktfhe/mod_switch"):
        tildeb, tildea = mod_switch_2n(ct, params.big_n)
    with phase_range("mktfhe/rotate"):
        acc = initial_acc(tildeb, params.big_n, params.k, ctx.dtype)
        acc = blind_rotate(acc, tildea, scheme, params, ctx)
    with phase_range("mktfhe/keyswitch"):
        return keyswitch_table(acc, scheme.ksk_b, scheme.ksk_a, params.f, params.log_d)
