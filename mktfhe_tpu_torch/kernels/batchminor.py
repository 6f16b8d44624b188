"""Batch-minor blind-rotation engine for CGGI (port of kernels/batchminor.py).

All per-step tensors keep the gate batch as the minor axis -- [.., N, G] --
and every NTT of the rotation runs through the batch-minor NTT kernel
(kernels/ntt.py:fwd_ntt_bm / inv_ntt_bm, csrc/ntt.cu), which reads and
writes that layout itself.  The layout is converted once per bootstrap, not
per step.

The monomial weight (X^a - 1) is applied in the NTT domain from the table
of 2N images (`schemes.kms.monomial_table`).  That doubles the CRT
reconstruction bound against the roll of schemes/cggi.py; the CGGI preset
leaves more than 5 bits of margin below prod(primes)/2, and
`convert_scheme` refuses parameters that do not cover it.

Bit-identical to the reference engine schemes/cggi.py
(tests/test_torch_cggi_engines.py).

The KMS half (`BmKmsPhase1`, `build_bm_kms_phase1`, `kms_phase1_bm`; the
bootstrap is schemes/kms.py:bootstrap_bm) runs one party's phase-1 rotation
the same way over an RLEV accumulator on the 2^64 torus, on its own image of
the bootstrapping keys in a prime basis wide enough for the monomial table;
bit-identical to schemes.kms.bootstrap (tests/test_torch_kms_bm.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ciphertext.decomp import balanced_decomp
from ..ciphertext.lwe import Lwe
from ..ciphertext.rlwe import gadget_gvec
from ..ring.context import RingCtx, make_ring_ctx, nprimes_monomial_weighted, nprimes_needed
from ..ring.modring import mulsum_mod, prime_column
from ..ring.ntt import fwd_ntt
from ..ring.torus import from_crt
from ..schemes.cggi import CggiScheme, _ctx
from ..schemes.common import initial_acc, keyswitch_table, mod_switch_2n
from ..schemes.kms import levkey_lift, monomial_table, phase1_key_image
from ..schemes.params import CggiParams, KmsParams
from ..utils.profiling import phase_range
from .ntt import fwd_ntt_bm, inv_ntt_bm


def _p_col(ctx: RingCtx, device) -> torch.Tensor:
    """Primes broadcastable over [npr, ..., N, G], int64."""
    return prime_column(ctx.nprimes, device)[:, :, None, None]


def lift_signed_bm(d: torch.Tensor, ctx: RingCtx) -> torch.Tensor:
    """int32 digits [R, N, G] -> residues [npr, R, N, G] int32."""
    p = _p_col(ctx, d.device).to(torch.int32)
    return torch.where(d[None] < 0, d[None] + p, d[None])


def from_crt_bm(r: torch.Tensor, ctx: RingCtx, dtype: torch.dtype) -> torch.Tensor:
    """Garner in batch-minor layout: [npr, C, N, G] -> [C, N, G] torus (the
    reconstruction is elementwise, so it reads the primes through a view)."""
    return from_crt(r.movedim(0, -2), ctx.crt, dtype)


def decomp_hat_bm(acc: torch.Tensor, l: int, log_b: int, ctx: RingCtx) -> torch.Tensor:
    """acc [C, N, G] -> NTT'd digits [npr, C*l, N, G]."""
    c, n, g = acc.shape
    d = balanced_decomp(acc, l, log_b)  # [C, N, G, l]
    d = d.movedim(-1, 1).reshape(c * l, n, g)
    return fwd_ntt_bm(lift_signed_bm(d, ctx), ctx.plan)


@dataclass(frozen=True)
class BmScheme:
    """CGGI scheme state in batch-minor-friendly form (no Shoup companions).

    brk_bm: [n, npr, cin*l, cout, N] -- per-step slices broadcast against
    dhat [npr, cin*l, 1, N, G].  mono_hat: [2N, npr, N].  ksk as in
    schemes/cggi.py.
    """

    brk_bm: torch.Tensor
    mono_hat: torch.Tensor
    ksk_b: torch.Tensor
    ksk_a: torch.Tensor


def convert_scheme(scheme: CggiScheme, params: CggiParams) -> BmScheme:
    """Re-layout a CggiScheme for the batch-minor and fused engines."""
    ctx = _ctx(params)
    n_bits, cin, l, cout, npr, n = scheme.brk_hat.shape
    weighted = [(1 << (params.log_b_gsw - 1), 2 * params.l_gsw * (params.k + 1))]
    if nprimes_needed(params.torus_bits, params.big_n, weighted) > npr:
        raise ValueError(
            f"{npr} CRT primes do not cover the monomial-weighted external product "
            f"(N={params.big_n}, l_gsw={params.l_gsw}, log_b_gsw={params.log_b_gsw})"
        )
    # [n, cin, l, cout, npr, N] -> [n, npr, cin*l, cout, N]
    brk_bm = scheme.brk_hat.permute(0, 4, 1, 2, 3, 5).reshape(n_bits, npr, cin * l, cout, n)
    return BmScheme(
        brk_bm=brk_bm.contiguous(),
        mono_hat=monomial_table(ctx, scheme.brk_hat.device),
        ksk_b=scheme.ksk_b,
        ksk_a=scheme.ksk_a,
    )


def blind_rotate_bm(acc: torch.Tensor, tildea: torch.Tensor, scheme: BmScheme, params: CggiParams, ctx: RingCtx) -> torch.Tensor:
    """CGGI blind rotation in batch-minor layout.  acc: [k+1, N, G];
    tildea: [G, n].  Per step: decompose + NTT (kernel), pointwise external
    product with the monomial weight folded in, inverse NTT (kernel),
    reconstruct, accumulate."""
    p = _p_col(ctx, acc.device)
    for i in range(params.n):
        dhat = decomp_hat_bm(acc, params.l_gsw, params.log_b_gsw, ctx)  # [npr, cin*l, N, G]
        # [npr, cin*l, cout, N, 1] x [npr, cin*l, 1, N, G] -> [npr, cout, N, G]
        ehat = mulsum_mod(scheme.brk_bm[i][..., None], dhat[:, :, None], 1, p)
        mono = scheme.mono_hat[tildea[:, i].long()].permute(1, 2, 0)  # [npr, N, G]
        weighted = torch.remainder(ehat * mono[:, None], p).to(torch.int32).contiguous()
        acc = acc + from_crt_bm(inv_ntt_bm(weighted, ctx.plan), ctx, ctx.dtype)
    return acc


def bootstrap_bm(ct: Lwe, scheme: BmScheme, params: CggiParams) -> Lwe:
    """CGGI gate bootstrap via the batch-minor engine; bit-identical to
    schemes.cggi.bootstrap (the monomial table and the negacyclic roll
    compute the same exact integers)."""
    ctx = _ctx(params)
    with phase_range("mktfhe/mod_switch"):
        tildeb, tildea = mod_switch_2n(ct, params.big_n)
    with phase_range("mktfhe/rotate"):
        acc = initial_acc(tildeb, params.big_n, params.k, ctx.dtype)  # [G, k+1, N]
        acc = blind_rotate_bm(acc.permute(1, 2, 0).contiguous(), tildea, scheme, params, ctx)
    with phase_range("mktfhe/keyswitch"):
        return keyswitch_table(acc.permute(2, 0, 1), scheme.ksk_b, scheme.ksk_a, params.f, params.log_d)


@dataclass(frozen=True)
class BmKmsPhase1:
    """KMS phase-1 keys in batch-minor form (no Shoup companions).

    brk_bm: [k, n, npr', 2*l_gsw, 2, N]; mono_hat: [2N, npr', N].  npr' may
    exceed the scheme's ring prime count, because the evaluation-domain
    monomial weight doubles the reconstruction bound against the roll of
    the reference engine; the phase-1 output re-enters the scheme's prime
    basis through the torus, so phase 2 is unaffected.
    """

    brk_bm: torch.Tensor
    mono_hat: torch.Tensor


def build_bm_kms_phase1(party_keys, params: KmsParams) -> BmKmsPhase1:
    """Convert KMS party keys (torus domain, `KmsPartyKey.brk`
    [n, 2, l, 2, N]) for the batch-minor phase 1, one party at a time."""
    npr = nprimes_monomial_weighted(
        params.ring_torus_bits, params.big_n, params.l_gsw, params.log_b_gsw)
    ctx = make_ring_ctx(params.big_n, params.ring_torus_bits, npr)
    brk_bm = phase1_key_image(party_keys, ctx, fwd_ntt)
    return BmKmsPhase1(brk_bm=brk_bm, mono_hat=monomial_table(ctx, brk_bm.device))


def kms_phase1_bm(tildea_p: torch.Tensor, brk_p: torch.Tensor, phase1_keys: BmKmsPhase1, iter_rows: int, params: KmsParams, out_ctx: RingCtx) -> torch.Tensor:
    """Batch-minor KMS phase 1 for one party (cf. schemes/kms.py:phase1).

    tildea_p: [G, n]; brk_p: [n, npr', 2l, 2, N] (one party of
    `phase1_keys.brk_bm`).  Returns the party's lev key in the scheme's own
    prime basis `out_ctx`: [G, iter_rows, 2, npr, N] int32.
    """
    npr_p = brk_p.shape[1]
    ctx_p = make_ring_ctx(params.big_n, params.ring_torus_bits, npr_p)
    g, n, l = tildea_p.shape[0], params.big_n, params.l_gsw
    dev = tildea_p.device
    p = _p_col(ctx_p, dev)[..., None]  # over [npr', rows, 2, N, G]

    gvec = gadget_gvec(params.l_lev, params.log_b_lev, ctx_p.dtype, dev)[:iter_rows]
    acc = torch.zeros((iter_rows, 2, n, g), dtype=ctx_p.dtype, device=dev)
    acc[:, 0, 0, :] = gvec[:, None]
    for i in range(params.n):
        dhat = decomp_hat_bm(acc.reshape(iter_rows * 2, n, g), l, params.log_b_gsw, ctx_p)
        dhat = dhat.reshape(npr_p, iter_rows, 2 * l, n, g)
        # [npr', 1, 2l, 2, N, 1] x [npr', rows, 2l, 1, N, G] -> [npr', rows, 2, N, G]
        ehat = mulsum_mod(brk_p[i][:, None, :, :, :, None], dhat[:, :, :, None], 2, p)
        mono = phase1_keys.mono_hat[tildea_p[:, i].long()].permute(1, 2, 0)  # [npr', N, G]
        weighted = torch.remainder(ehat * mono[:, None, None], p).to(torch.int32)
        e = inv_ntt_bm(weighted.reshape(npr_p, iter_rows * 2, n, g), ctx_p.plan)
        acc = acc + from_crt_bm(e, ctx_p, ctx_p.dtype).reshape(iter_rows, 2, n, g)
    # back to the standard layout and the scheme's prime basis for phase 2
    return levkey_lift(acc.permute(3, 0, 1, 2).contiguous(), out_ctx)  # [G, rows, 2, N]
