"""LMSS23 single-key gate bootstrapping with block-binary secrets.

Port of mktfhe_tpu/schemes/lmss.py, the `pallas_ntt=True` path: every NTT
of `bootstrap` goes through the NTT kernel's wrappers kernels/ntt.py (on
CPU tensors, their plain twin).  LWE ciphertexts and the ring accumulator
live on the 2^32 torus (int32 carriers).

The LWE secret has d blocks of length ell with at most one 1 per block, so
one decomposition and forward NTT of the accumulator serve all ell external
products of a block; each product is weighted by its monomial X^a - 1 in
the evaluation domain (`mono_hat`, the 2N-entry table of
kms.monomial_table) and the block is summed before a single inverse NTT.
The ring key embeds the LWE key in its low coefficients
(`partial_ring_key`), so the first n extracted coefficients key-switch for
free (`common.keyswitch_partial`).

The scheme stores NTT-domain keys without Shoup companions: products of
residues are reduced with int64 `%`, which gives the same canonical
residues.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ciphertext.gsw import external_product_hat, rgsw_encrypt, rgsw_to_hat, rlwe_decomp_hat
from ..ciphertext.keys import LweKey, RingKey, block_binary_lwe_key, partial_ring_key
from ..ciphertext.lwe import Lwe
from ..kernels.ntt import fwd_ntt_nat
from ..ring.context import RingCtx, make_ring_ctx
from ..ring.modring import mulsum_mod, prime_column
from ..ring.sampler import rng_streams
from ..utils.profiling import phase_range
from .common import build_ksk, initial_acc, inv_to_torus, keyswitch_partial, mod_switch_2n
from .kms import monomial_table
from .params import BlockParams

# top-level sampling streams consumed by keygen (ring/sampler.rng_streams)
KEYGEN_STREAMS = 4


@dataclass(frozen=True)
class LmssScheme:
    """Runtime scheme state: NTT-domain keys as int32 residues."""

    brk_hat: torch.Tensor  # [n, k+1, l, k+1, npr, N]
    mono_hat: torch.Tensor  # [2N, npr, N] NTT(X^a - 1)
    ksk_b: torch.Tensor  # [NLIMB, R] int8, R = (k*N - n) * f * D/2
    ksk_a: torch.Tensor  # [NLIMB, R, n] int8


def _ctx(params: BlockParams) -> RingCtx:
    return make_ring_ctx(params.big_n, params.torus_bits, params.nprimes)


def setup(gen, params: BlockParams) -> tuple[LweKey, RingKey, LmssScheme]:
    """Keygen on the generators' device: (lwe_key, ring_key, scheme).

    gen: one torch.Generator or KEYGEN_STREAMS of them (rng_streams).  The
    ksk covers only the ring-key coefficients beyond n (the first n are the
    LWE key).
    """
    ctx = _ctx(params)
    g_lwe, g_ring, g_brk, g_ksk = rng_streams(gen, KEYGEN_STREAMS)
    lwe_key = block_binary_lwe_key(g_lwe, params.d, params.ell, torch.int32)
    ring_key = partial_ring_key(g_ring, params.k, lwe_key, ctx)
    brk = rgsw_encrypt(
        g_brk, lwe_key.key.to(ctx.dtype), ring_key, params.beta, params.l_gsw, params.log_b_gsw, ctx
    )
    tail = ring_key.key.reshape(-1)[params.n :].to(torch.int32)
    ksk_b, ksk_a = build_ksk(g_ksk, tail, lwe_key, params.f, params.log_d, params.alpha)
    return lwe_key, ring_key, LmssScheme(
        brk_hat=rgsw_to_hat(brk, ctx),
        mono_hat=monomial_table(ctx, lwe_key.key.device),
        ksk_b=ksk_b,
        ksk_a=ksk_a,
    )


def blind_rotate(acc: torch.Tensor, tildea: torch.Tensor, scheme: LmssScheme, params: BlockParams, ctx: RingCtx) -> torch.Tensor:
    """d block steps.  acc: [G, k+1, N]; tildea: [G, n] values in [0, 2N).

    Step: decompose acc -> NTT (one launch) -> the block's ell external
    products, each reduced, weighted by mono_hat[a] and summed mod p -> one
    inverse NTT -> Garner -> acc += e.
    """
    d, ell = params.d, params.ell
    p = prime_column(ctx.nprimes, acc.device)
    brk = scheme.brk_hat.reshape(d, ell, 1, *scheme.brk_hat.shape[1:])  # [d, ell, 1, k+1, l, k+1, npr, N]
    ta = tildea.T.reshape(d, ell, -1)  # [d, ell, G]
    for i in range(d):
        dhat = rlwe_decomp_hat(acc, params.l_gsw, params.log_b_gsw, ctx, fwd_ntt_nat)  # [G, k+1, l, npr, N]
        ehat = external_product_hat(dhat, brk[i], ctx)  # [ell, G, k+1, npr, N]
        mono = scheme.mono_hat[ta[i]]  # [ell, G, npr, N]
        tacc = mulsum_mod(ehat, mono[:, :, None], 0, p)  # [G, k+1, npr, N]
        acc = acc + inv_to_torus(tacc, ctx)
    return acc


def bootstrap(ct: Lwe, scheme: LmssScheme, params: BlockParams) -> Lwe:
    """Gate bootstrap of a batch of LWE ciphertexts.  ct: Lwe with b [G],
    a [G, n]: modulus switch, initial accumulator, blind rotation, partial
    key switch."""
    ctx = _ctx(params)
    with phase_range("mktfhe/mod_switch"):
        tildeb, tildea = mod_switch_2n(ct, params.big_n)
    with phase_range("mktfhe/rotate"):
        acc = initial_acc(tildeb, params.big_n, params.k, ctx.dtype)
        acc = blind_rotate(acc, tildea, scheme, params, ctx)
    with phase_range("mktfhe/keyswitch"):
        return keyswitch_partial(acc, params.n, scheme.ksk_b, scheme.ksk_a, params.f, params.log_d)
