"""CCS19 multi-key gate bootstrapping.

Port of mktfhe_tpu/schemes/ccs.py, the `pallas_ntt=True` path: every NTT
of `bootstrap` goes through the NTT kernel's wrappers kernels/ntt.py (on
CPU tensors, their plain twin).  LWE ciphertexts and the ring accumulator
live on the 2^32 torus (int32 carriers).

Each of the k parties runs keygen on its own against a common reference
string (CRS).  The accumulator's mask grows party by party: party p1's n
steps of hybrid-product rotation touch components 0..p1, so the blind
rotation is a loop over parties, each a loop over its key bits.  The key
switch is the per-party int8-limb one of schemes/common.py.

The relinearisation w = sum_{c, j} G^-1(v_c)_j * f_j contracts (p1+1) *
l_uni digit products (up to 204 at CCS16party), more than int64 holds
unreduced (ring/modring.MAX_PRODUCT_TERMS).  The components' digits are
summed first, in the coefficient domain, and only their sum is transformed:
the NTT is linear mod p, so the residues equal the reference's sum of
(p1+1) * l_uni reduced products, and one forward transform of G * l_uni
polynomials replaces one of G * (p1+1) * l_uni.

The scheme stores NTT-domain keys without Shoup companions: products of
residues are reduced with int64 `%`, which gives the same canonical
residues.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..ciphertext.decomp import balanced_decomp
from ..ciphertext.gsw import rlwe_decomp_hat
from ..ciphertext.keys import binary_lwe_key, binary_ring_key
from ..ciphertext.lwe import Lwe
from ..ciphertext.unienc import gen_b, sample_crs, unienc_encrypt
from ..kernels.ntt import fwd_ntt_nat
from ..ring.context import RingCtx, make_ring_ctx
from ..ring.modring import addmod, mulsum_mod, negmod, prime_column
from ..ring.ntt import fwd_ntt
from ..ring.sampler import rng_streams
from ..ring.torus import lift, negacyclic_roll
from ..utils.profiling import phase_range
from .common import build_ksk, initial_acc, inv_to_torus, keyswitch_per_party, mod_switch_2n
from .params import CcsParams

# top-level sampling streams consumed by keygen (ring/sampler.rng_streams)
KEYGEN_STREAMS = 5


class CcsPartyKey(NamedTuple):
    """One party's bootstrapping material, torus domain: what crosses the
    party boundary."""

    pub_b: torch.Tensor  # [l_uni, N] public key against the CRS
    brk_d: torch.Tensor  # [n, l_uni, N] uni-encryption masked vectors
    brk_f: torch.Tensor  # [n, l_uni, 2, N] uni-encryption RLEV parts
    ksk_b: torch.Tensor  # [NLIMB, R] int8, R = N * f * D/2
    ksk_a: torch.Tensor  # [NLIMB, R, n] int8


@dataclass(frozen=True)
class CcsScheme:
    """Aggregated runtime state: NTT-domain keys as int32 residues."""

    crs_hat: torch.Tensor  # [l_uni, npr, N]
    pub_b_hat: torch.Tensor  # [k, l_uni, npr, N]
    brk_d_hat: torch.Tensor  # [k, n, l_uni, npr, N]
    brk_f_hat: torch.Tensor  # [k, n, l_uni, 2, npr, N]
    ksk_b: torch.Tensor  # [k, NLIMB, R] int8
    ksk_a: torch.Tensor  # [k, NLIMB, R, n] int8


def _ctx(params: CcsParams) -> RingCtx:
    return make_ring_ctx(params.big_n, params.torus_bits, params.nprimes)


def crs(gen: torch.Generator, params: CcsParams) -> torch.Tensor:
    """Common reference string [l_uni, N], on the generator's device."""
    return sample_crs(gen, params.l_uni, _ctx(params))


def party_keygen(gen, crs_polys: torch.Tensor, params: CcsParams):
    """Independent per-party keygen on the device of crs_polys.

    gen: one torch.Generator or KEYGEN_STREAMS of them (rng_streams).
    Returns (lwe_key, ring_key, CcsPartyKey); only the CcsPartyKey crosses
    the party boundary.
    """
    ctx = _ctx(params)
    g_lwe, g_ring, g_b, g_brk, g_ksk = rng_streams(gen, KEYGEN_STREAMS)
    lwe_key = binary_lwe_key(g_lwe, params.n, torch.int32)
    ring_key = binary_ring_key(g_ring, 1, ctx)
    pub_b = gen_b(g_b, crs_polys, ring_key, params.beta, ctx)
    # each key bit uni-encrypted as a constant polynomial
    bits = torch.zeros((params.n, ctx.n), dtype=ctx.dtype, device=crs_polys.device)
    bits[:, 0] = lwe_key.key
    uni = unienc_encrypt(g_brk, bits, crs_polys, ring_key, params.beta, params.l_uni, params.log_b_uni, ctx)
    ksk_b, ksk_a = build_ksk(
        g_ksk, ring_key.key[0].to(torch.int32), lwe_key, params.f, params.log_d, params.alpha
    )
    return lwe_key, ring_key, CcsPartyKey(
        pub_b=pub_b, brk_d=uni.d, brk_f=uni.f, ksk_b=ksk_b, ksk_a=ksk_a
    )


def setup(crs_polys: torch.Tensor, party_keys: list[CcsPartyKey], params: CcsParams) -> CcsScheme:
    """Aggregate party keys into NTT-domain images on the CRS's device."""
    ctx = _ctx(params)

    def hat(x):
        return fwd_ntt(lift(x, ctx.crt), ctx.plan)

    return CcsScheme(
        crs_hat=hat(crs_polys),
        pub_b_hat=hat(torch.stack([pk.pub_b for pk in party_keys])),
        brk_d_hat=hat(torch.stack([pk.brk_d for pk in party_keys])),
        brk_f_hat=hat(torch.stack([pk.brk_f for pk in party_keys])),
        ksk_b=torch.stack([pk.ksk_b for pk in party_keys]),
        ksk_a=torch.stack([pk.ksk_a for pk in party_keys]),
    )


def _hybrid_rotate_party(acc: torch.Tensor, tildea_p: torch.Tensor, p1: int, scheme: CcsScheme, params: CcsParams, ctx: RingCtx) -> None:
    """Party p1's (1-based) n steps of hybrid-product rotation, in place on
    components 0..p1 of acc [G, k+1, N].  tildea_p: [G, n] in [0, 2N)."""
    l, log_b = params.l_uni, params.log_b_uni
    p = prime_column(ctx.nprimes, acc.device)
    comps = p1 + 1
    # v's weights by component: the CRS for the b component (negated after
    # the contraction), the earlier parties' public keys for masks 1..p1
    vkey = torch.cat([scheme.crs_hat[None], scheme.pub_b_hat[:p1]])  # [p1+1, l, npr, N]
    d_hat, f_hat = scheme.brk_d_hat[p1 - 1], scheme.brk_f_hat[p1 - 1]
    for i in range(params.n):
        dhat = rlwe_decomp_hat(acc[:, :comps], l, log_b, ctx, fwd_ntt_nat)  # [G, p1+1, l, npr, N]
        u = mulsum_mod(d_hat[i], dhat, -3, p)  # [G, p1+1, npr, N]
        v = mulsum_mod(vkey, dhat, -3, p)
        v[:, 0] = negmod(v[:, 0], p)
        # w: G^-1(v) against f, the components' digits summed before the transform
        digits = balanced_decomp(inv_to_torus(v, ctx), l, log_b).sum(1)  # [G, N, l]
        vhat = fwd_ntt_nat(lift(digits.movedim(-1, -2), ctx.crt), ctx.plan)  # [G, l, npr, N]
        w = mulsum_mod(vhat[:, :, None], f_hat[i], -4, p)  # [G, 2, npr, N]
        u[:, 0] = addmod(u[:, 0], w[:, 0], p)
        u[:, p1] = addmod(u[:, p1], w[:, 1], p)
        e = inv_to_torus(u, ctx)  # [G, p1+1, N]
        acc[:, :comps] += negacyclic_roll(e, tildea_p[:, i, None]) - e


def bootstrap(ct: Lwe, scheme: CcsScheme, params: CcsParams) -> Lwe:
    """Multi-key gate bootstrap.  ct: Lwe with b [G], a [G, k*n]: modulus
    switch, initial accumulator, k parties' rotations, per-party key
    switch."""
    ctx = _ctx(params)
    with phase_range("mktfhe/mod_switch"):
        tildeb, tildea = mod_switch_2n(ct, params.big_n)
    with phase_range("mktfhe/rotate"):
        acc = initial_acc(tildeb, params.big_n, params.k, ctx.dtype)
        tild = tildea.reshape(tildea.shape[0], params.k, params.n)
        for p1 in range(1, params.k + 1):
            _hybrid_rotate_party(acc, tild[:, p1 - 1], p1, scheme, params, ctx)
    with phase_range("mktfhe/keyswitch"):
        return keyswitch_per_party(acc, scheme.ksk_b, scheme.ksk_a, params.f, params.log_d)
