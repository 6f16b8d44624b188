"""KMS two-phase multi-key bootstrapping (eprint 2022/1460), + block variant.

Port of mktfhe_tpu/schemes/kms.py, the `pallas_ntt=True` path: every NTT
of `bootstrap` goes through the CUDA kernel wrapper kernels/ntt.py (on CPU
tensors, its plain twin).  LWE ciphertexts live on the 2^32 torus (int32
carriers), ring accumulators on the 2^64 torus (int64 carriers, exact via
3-4 CRT primes).

Phase 1 (per party): a single-key blind rotation over an RLEV accumulator
whose rows carry the LEV gadget constants, producing the party's "lev key"
in the NTT domain.  The reference's `lax.scan` over key bits is a Python
loop here (kernels/fused_mx3.py:phase1_sweep_plain, which is also the plain
version of the sweep kernel that `bootstrap_mx3` launches instead), and its
vmap over parties a loop over parties, which keeps the peak device memory
to one party's temporaries; `bootstrap_mx3` sweeps every party in one
launch (kernels/fused_mx3.py:kms_phase1_sweeps), then lifts each party's
lev key.
Phase 2 (sequential merge): per party, LEV-multiply the accumulator's
digits by the lev key, relinearize through the party's rlk and public keys
(hybrid product: on the card one launch of csrc/hybrid_product.cu,
kernels/hybrid_product.py), and extend the accumulator by one mask
component.
Key switch: modulus switch 2^64 -> 2^32, then the per-party int8-limb key
switch (schemes/common.py).

`bootstrap_bm` runs phase 1 on the batch-minor engine's own keys
(kernels/batchminor.py); `kernels/fused_mx2.py:bootstrap_mx2` on the
mx-domain image that its own set-up, `fused_mx2.setup`, puts in the scheme
(an `MxKmsScheme`) in place of `brk_hat`.  Neither reads
`KmsScheme.brk_hat`; `setup(..., with_brk=False)` and `drop_brk` give a
scheme without it.

The scheme stores NTT-domain keys without Shoup companions: products of
runtime residues are reduced with int64 `%`, which gives the same
canonical residues and halves key memory.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ciphertext.decomp import balanced_decomp
from ..ciphertext.gsw import rgsw_encrypt, rlwe_decomp_hat
from ..ciphertext.keys import (
    binary_lwe_key,
    binary_ring_key,
    block_binary_lwe_key,
    partial_ring_key,
)
from ..ciphertext.lwe import Lwe
from ..ciphertext.unienc import gen_b, sample_crs, unienc_encrypt
from ..kernels.fused_mx3 import kms_phase1_sweeps, phase1_sweep_plain
from ..kernels.hybrid_product import hybrid_product
from ..kernels.ntt import fwd_ntt_nat, inv_ntt_nat
from ..ring.context import RingCtx, make_ring_ctx
from ..ring.modring import addmod, mulsum_mod, prime_column
from ..ring.sampler import rng_streams
from ..ring.ntt import fwd_ntt
from ..ring.torus import lift, wrap_i32
from ..utils.profiling import phase_range
from .common import (
    build_ksk,
    initial_acc,
    inv_to_torus,
    keyswitch_per_party,
    limb_dot,
    mod_switch_2n,
    sample_extract_coeffs,
    signed_onehot,
)
from .params import KmsBlockParams, KmsParams


class KmsPartyKey(NamedTuple):
    """One party's bootstrapping material, torus domain."""

    pub_b: torch.Tensor  # [l_uni, N] int64, public key vs the CRS (unikey)
    brk: torch.Tensor  # [n, 2, l_gsw, 2, N] int64, RGSW(s_i) under gswkey
    rlk_d: torch.Tensor  # [l_uni, N] int64, UniEnc(gswkey) d-vector
    rlk_f: torch.Tensor  # [l_uni, 2, N] int64, UniEnc(gswkey) RLEV part
    ksk_b: torch.Tensor  # [NLIMB, rows] int8 (encrypts unikey coeffs, u32)
    ksk_a: torch.Tensor  # [NLIMB, rows, n] int8


@dataclass(frozen=True)
class KmsScheme:
    """Aggregated runtime state: NTT-domain keys as int32 residues."""

    crs_hat: torch.Tensor  # [l_uni, npr, N]
    pub_b_hat: torch.Tensor  # [k, l_uni, npr, N]
    brk_hat: torch.Tensor  # [k, n, 2, l_gsw, 2, npr, N]
    rlk_d_hat: torch.Tensor  # [k, l_uni, npr, N]
    rlk_f_hat: torch.Tensor  # [k, l_uni, 2, npr, N]
    ksk_b: torch.Tensor  # [k, NLIMB, rows] int8
    ksk_a: torch.Tensor  # [k, NLIMB, rows, n] int8
    mono_hat: torch.Tensor  # [2N, npr, N] (block variant; empty otherwise)


AnyKmsParams = KmsParams | KmsBlockParams
# top-level sampling streams consumed by keygen (ring/sampler.rng_streams)
KEYGEN_STREAMS = 7
# residues of one chunk of the plain hybrid product's digits (`hybrid_chunk`;
# the kernel has no digit transients): one chunk a merge at every preset up
# to k = 16 at batch 128, a transient of about 2.5 GB at most
PHASE2_CHUNK_RESIDUES = 1 << 27
# this engine's phase 1 is the sweep's loop in plain PyTorch with the NTT
# kernel under its transforms
_NTT_KERNEL = (fwd_ntt_nat, inv_ntt_nat)


def _ctx(params: AnyKmsParams) -> RingCtx:
    return make_ring_ctx(params.big_n, params.ring_torus_bits, params.ring_nprimes)


def crs(gen: torch.Generator, params: AnyKmsParams) -> torch.Tensor:
    """Common reference string [l_uni, N], on the generator's device."""
    return sample_crs(gen, params.l_uni, _ctx(params))


def party_keygen(gen, crs_polys: torch.Tensor, params: AnyKmsParams):
    """Independent per-party keygen on the device of crs_polys.

    gen: one torch.Generator or KEYGEN_STREAMS of them (rng_streams).
    Returns (lwe_key [int32], gsw_key, uni_key, KmsPartyKey).
    """
    ctx = _ctx(params)
    is_block = isinstance(params, KmsBlockParams)
    g_lwe, g_gsw, g_uni, g_b, g_rlk, g_brk, g_ksk = rng_streams(gen, KEYGEN_STREAMS)
    if is_block:
        lwe_key = block_binary_lwe_key(g_lwe, params.d, params.ell, torch.int32)
        uni_key = partial_ring_key(g_uni, 1, lwe_key, ctx)
    else:
        lwe_key = binary_lwe_key(g_lwe, params.n, torch.int32)
        uni_key = binary_ring_key(g_uni, 1, ctx)
    gsw_key = binary_ring_key(g_gsw, 1, ctx)

    pub_b = gen_b(g_b, crs_polys, uni_key, params.beta, ctx)
    rlk = unienc_encrypt(
        g_rlk, gsw_key.key[0], crs_polys, uni_key, params.beta,
        params.l_uni, params.log_b_uni, ctx,
    )
    brk = rgsw_encrypt(
        g_brk, lwe_key.key.to(ctx.dtype), gsw_key, params.beta,
        params.l_gsw, params.log_b_gsw, ctx,
    )
    # ksk encrypts the (binary) uni-key coefficients on the 2^32 torus under
    # the party's LWE key; the block variant covers only the tail beyond n.
    coeffs = uni_key.key[0].to(torch.int32)
    if is_block:
        coeffs = coeffs[params.n :]
    ksk_b, ksk_a = build_ksk(g_ksk, coeffs, lwe_key, params.f, params.log_d, params.alpha)
    return lwe_key, gsw_key, uni_key, KmsPartyKey(
        pub_b=pub_b, brk=brk, rlk_d=rlk.d, rlk_f=rlk.f, ksk_b=ksk_b, ksk_a=ksk_a
    )


def monomial_table(ctx: RingCtx, device) -> torch.Tensor:
    """NTT images of X^a - 1 for a in [0, 2N) (reference lmss.py:60-78)."""
    n = ctx.n
    eye = np.zeros((2 * n, n), dtype=np.int64)
    for a in range(1, 2 * n):
        if a < n:
            eye[a, a] = 1
        else:
            eye[a, a - n] = -1
        eye[a, 0] -= 1
    polys = torch.from_numpy(eye).to(device=device, dtype=ctx.dtype)
    return fwd_ntt(lift(polys, ctx.crt), ctx.plan)


def setup(crs_polys: torch.Tensor, party_keys: list[KmsPartyKey], params: AnyKmsParams, with_brk: bool = True) -> KmsScheme:
    """Aggregate party keys into NTT-domain images on the CRS's device.

    The brk images (2.55 GB at KMS8partyblock) are written party by party
    into one preallocated tensor, so only one party's transform temporaries
    are alive at a time.  with_brk=False skips them (an empty `brk_hat`, as
    after `drop_brk`): for the engines that carry their own phase-1 keys
    (`fused_mx2.setup` makes its scheme so, and adds its mx image).
    """
    ctx = _ctx(params)
    dev = crs_polys.device

    def hat(x):
        return fwd_ntt(lift(x, ctx.crt), ctx.plan)

    if with_brk:
        brk0 = party_keys[0].brk
        brk_hat = torch.empty(
            (len(party_keys), *brk0.shape[:-1], ctx.nprimes, ctx.n), dtype=torch.int32, device=dev
        )
        for i, pk in enumerate(party_keys):
            brk_hat[i] = hat(pk.brk)
    else:
        brk_hat = torch.zeros((0,), dtype=torch.int32, device=dev)
    if isinstance(params, KmsBlockParams):
        mono_hat = monomial_table(ctx, dev)
    else:
        mono_hat = torch.zeros((0,), dtype=torch.int32, device=dev)
    return KmsScheme(
        crs_hat=hat(crs_polys),
        pub_b_hat=hat(torch.stack([pk.pub_b for pk in party_keys])),
        brk_hat=brk_hat,
        rlk_d_hat=hat(torch.stack([pk.rlk_d for pk in party_keys])),
        rlk_f_hat=hat(torch.stack([pk.rlk_f for pk in party_keys])),
        ksk_b=torch.stack([pk.ksk_b for pk in party_keys]),
        ksk_a=torch.stack([pk.ksk_a for pk in party_keys]),
        mono_hat=mono_hat,
    )


def drop_brk(scheme: KmsScheme) -> KmsScheme:
    """The scheme without its phase-1 keys (an empty `brk_hat`), for the
    engines that carry their own: `bootstrap_bm` (`BmKmsPhase1`) and the
    sharded path's phase 1 (`MxKmsKeys`, `BmKmsPhase1`).  Phase 2 and the
    key switch never read `brk_hat`; `bootstrap` and `bootstrap_mx3` do, and
    refuse such a scheme."""
    empty = torch.zeros((0,), dtype=torch.int32, device=scheme.brk_hat.device)
    return dataclasses.replace(scheme, brk_hat=empty)


def require_brk(scheme: KmsScheme, engine: str) -> None:
    """Raise if `scheme` has no phase-1 keys (`setup(with_brk=False)`,
    `drop_brk`)."""
    if scheme.brk_hat.numel() == 0:
        raise ValueError(
            f"{engine} reads scheme.brk_hat, which this scheme does not hold (setup with "
            f"with_brk=False, or drop_brk); use bootstrap_mx2 on a scheme of fused_mx2.setup, or bootstrap_bm "
            f"with its own keys"
        )


def levkey_lift(acc: torch.Tensor, ctx: RingCtx) -> torch.Tensor:
    """A party's phase-1 accumulator [G, rows, 2, N] as its lev key: lifted
    into `ctx`'s primes and forward-transformed by the NTT kernel,
    [G, rows, 2, npr, N] int32 (the named range mktfhe/levkey_lift).  Every
    phase-1 engine ends with it."""
    with phase_range("mktfhe/levkey_lift"):
        return fwd_ntt_nat(lift(acc, ctx.crt), ctx.plan)


def phase1(tildea_p: torch.Tensor, brk_hat_p: torch.Tensor, iter_rows: int, params: KmsParams, ctx: RingCtx) -> torch.Tensor:
    """Single-key blind rotation over an RLEV accumulator.

    tildea_p: [G, n]; brk_hat_p: [n, 2, l, 2, npr, N].  Returns the party's
    lev key in the NTT domain: [G, iter_rows, 2, npr, N] int32.
    """
    acc = phase1_sweep_plain(tildea_p, brk_hat_p, iter_rows, None, params, ctx, ntt=_NTT_KERNEL)
    return levkey_lift(acc, ctx)


def phase1_block(tildea_p: torch.Tensor, brk_hat_p: torch.Tensor, iter_rows: int, mono_hat: torch.Tensor, params: KmsBlockParams, ctx: RingCtx) -> torch.Tensor:
    """Block-binary phase 1: one decomposition + forward NTT per block, its
    ell monomial-weighted external products accumulated in the evaluation
    domain, one inverse NTT per block."""
    acc = phase1_sweep_plain(tildea_p, brk_hat_p, iter_rows, mono_hat, params, ctx, ntt=_NTT_KERNEL)
    return levkey_lift(acc, ctx)


def _phase2_party_mat(acc, levkey, p1: int, rd, rf, pub_h, crs_hat, params: AnyKmsParams, ctx: RingCtx) -> torch.Tensor:
    """One merge step of phase 2 with this step's key material explicit:
    rd [l_uni, npr, N] (party p1's rlk d-vector), rf [l_uni, 2, npr, N]
    (its rlk RLEV part), pub_h [p1-1, l_uni, npr, N] (the earlier parties'
    public keys).  acc: [G, k+1, N] (components > p1 are zero); levkey:
    [G, iter, 2, npr, N].  Returns the new acc with component p1 filled.
    """
    p = prime_column(ctx.nprimes, acc.device)
    iter_rows = levkey.shape[1]

    # LEV contraction of acc's components 0..p1-1 against the lev key;
    # only the first iter_rows digits engage.
    dhat = rlwe_decomp_hat(acc[:, :p1], params.l_lev, params.log_b_lev, ctx, fwd_ntt_nat)[:, :, :iter_rows]
    x = mulsum_mod(dhat, levkey[:, None, :, 0], -3, p)  # [G, p1, npr, N]
    y = mulsum_mod(dhat, levkey[:, None, :, 1], -3, p)
    y_t = inv_to_torus(y, ctx)  # [G, p1, N]

    # hybrid product of y with this party's rlk: one kernel launch on the
    # card, `_hybrid_product` on the CPU
    with phase_range("mktfhe/phase2/hybrid"):
        u, v = hybrid_product(y_t, rd, pub_h, crs_hat, params, ctx)
    v_t = inv_to_torus(v, ctx)  # [G, N]

    vhat = rlwe_decomp_hat(v_t, params.l_uni, params.log_b_uni, ctx, fwd_ntt_nat)  # [G, l, npr, N]
    w_b = mulsum_mod(rf[:, 0], vhat, -3, p)
    w_a = mulsum_mod(rf[:, 1], vhat, -3, p)

    tx = addmod(x, u, p)
    tx[:, 0] = addmod(tx[:, 0], w_b, p)
    new = inv_to_torus(torch.cat([tx, w_a[:, None]], dim=1), ctx)  # [G, p1+1, N]
    out = torch.zeros_like(acc)
    out[:, : p1 + 1] = new
    return out


def hybrid_chunk(g: int, params: AnyKmsParams, ctx: RingCtx) -> int:
    """Parties per chunk of phase 2's hybrid product at batch g: as many as
    keep a chunk's digit transforms [g, parties, l_uni, npr, N] within
    PHASE2_CHUNK_RESIDUES residues (at least one party)."""
    return max(1, PHASE2_CHUNK_RESIDUES // (g * params.l_uni * ctx.nprimes * ctx.n))


def _hybrid_product(y_t, rd, pub_h, crs_hat, params: AnyKmsParams, ctx: RingCtx, p):
    """The hybrid product of a merge in plain PyTorch, the plain version of
    csrc/hybrid_product.cu (kernels/hybrid_product.py runs it on CPU
    tensors): y_t [G, p1, N] torus, each party's component decomposed and
    transformed, contracted against party p1's rlk d-vector `rd`
    (u [G, p1, npr, N]) and against the crs (component 0) and the earlier
    parties' public keys `pub_h` (v [G, npr, N], reduced).

    The digits go through chunks of `hybrid_chunk` parties, so the
    transients of this contraction stop growing with p1 (about 9 GB at
    merge 32 of the KMS32 presets at G = 128 when taken at once); each
    chunk's u is exact and v is summed over chunks before one reduction, so
    the residues are the unchunked ones."""
    g, p1 = y_t.shape[0], y_t.shape[1]
    step = hybrid_chunk(g, params, ctx)
    us, v = [], 0
    for c0 in range(0, p1, step):
        c1 = min(c0 + step, p1)
        yhat = rlwe_decomp_hat(y_t[:, c0:c1], params.l_uni, params.log_b_uni, ctx, fwd_ntt_nat)  # [G, c, l, npr, N]
        us.append(mulsum_mod(rd, yhat, -3, p))
        if c0 == 0:
            v = v - mulsum_mod(crs_hat, yhat[:, 0], -3, p)
        lo = max(c0, 1)  # parties 2.. weigh by the earlier parties' public keys
        if lo < c1:
            v = v + mulsum_mod(pub_h[lo - 1 : c1 - 1], yhat[:, lo - c0 :], -3, p).sum(1)
    return torch.cat(us, 1), torch.remainder(v, p)


def _phase2_party(acc, levkey, p1: int, scheme: KmsScheme, params: AnyKmsParams, ctx: RingCtx) -> torch.Tensor:
    """One merge step of phase 2 with party p1's keys read from the scheme
    (`_phase2_party_mat`)."""
    return _phase2_party_mat(
        acc, levkey, p1, scheme.rlk_d_hat[p1 - 1], scheme.rlk_f_hat[p1 - 1],
        scheme.pub_b_hat[: p1 - 1], scheme.crs_hat, params, ctx,
    )


def _phase2(tildeb: torch.Tensor, levkeys: list[torch.Tensor], scheme: KmsScheme, params: AnyKmsParams, ctx: RingCtx) -> torch.Tensor:
    """The k sequential merges of phase 2 from the test vector: levkeys[i]
    is party i+1's lev key [G, rows, 2, npr, N].  Returns acc [G, k+1, N]."""
    acc = initial_acc(tildeb, params.big_n, params.k, ctx.dtype)
    for p1 in range(1, params.k + 1):
        with phase_range(f"mktfhe/phase2/merge{p1}"):
            acc = _phase2_party(acc, levkeys[p1 - 1], p1, scheme, params, ctx)
    return acc


def phase1_key_image(party_keys: list[KmsPartyKey], ctx: RingCtx, transform) -> torch.Tensor:
    """The parties' bootstrapping keys (torus domain, `KmsPartyKey.brk`
    [n, 2, l, 2, N]) in the layout of the engines that carry their own
    phase-1 keys: lift into `ctx`'s primes, `transform(residues, ctx.plan)`
    into the engine's evaluation order, then [n, 2, l, 2, npr, N] ->
    [n, npr, 2l, 2, N]; one party at a time, so only one party's transform
    temporaries are alive.  Returns [k, n, npr, 2l, 2, N] int32."""
    brk0 = party_keys[0].brk
    n_bits, cin, l, cout, n = brk0.shape
    out = torch.empty(
        (len(party_keys), n_bits, ctx.nprimes, cin * l, cout, n), dtype=torch.int32, device=brk0.device
    )
    for i, pk in enumerate(party_keys):
        hat = transform(lift(pk.brk, ctx.crt), ctx.plan)  # [n, 2, l, 2, npr, N]
        out[i] = hat.permute(0, 4, 1, 2, 3, 5).reshape(n_bits, ctx.nprimes, cin * l, cout, n)
    return out


def _levkeys(tildea: torch.Tensor, engine: str, scheme: KmsScheme, params: AnyKmsParams, ctx: RingCtx, phase1_keys) -> list[torch.Tensor]:
    """Phase 1 of every party on `engine`: 'mx3' (the sweep kernel on
    `scheme.brk_hat`) or an engine of `phase1_levkey`.  tildea: [G, k*n].
    Returns each party's lev key [G, rows, 2, npr, N].

    Party 1's phase 2 reads only row 0 of its lev key, so its phase 1 runs
    one RLEV row (the reference's iter=1 case); rows never mix, so that
    row is bit-identical to the JAX engine's uniform l_lev-row sweep.

    On 'mx3' every party's sweep is one call (`kms_phase1_sweeps`: one
    kernel launch on the card) in the range mktfhe/phase1/sweeps, then each
    party's lift; the other engines run party by party.
    """
    if engine == "mx3":
        with phase_range("mktfhe/phase1/sweeps"):
            accs = kms_phase1_sweeps(tildea.contiguous(), scheme.brk_hat, params.l_lev, scheme.mono_hat, params, ctx)
        return [levkey_lift(acc, ctx) for acc in accs]
    tild = tildea.reshape(tildea.shape[0], params.k, params.n)
    levkeys = []
    for party in range(params.k):
        with phase_range(f"mktfhe/phase1/party{party}"):
            rows = 1 if party == 0 else params.l_lev
            levkeys.append(phase1_levkey(engine, party, tild[:, party].contiguous(), rows, scheme, params, ctx,
                                         phase1_keys))
    return levkeys


def phase1_engine(phase1_keys) -> str:
    """The phase-1 engine that reads `phase1_keys`: None 'ref' (on
    `scheme.brk_hat`), an MxKmsKeys 'mx2', a BmKmsPhase1 'bm' (the sharded
    path's forms)."""
    from ..kernels.batchminor import BmKmsPhase1  # both import this module
    from ..kernels.fused_mx2 import MxKmsKeys

    if phase1_keys is None:
        return "ref"
    if isinstance(phase1_keys, MxKmsKeys):
        return "mx2"
    if isinstance(phase1_keys, BmKmsPhase1):
        return "bm"
    raise TypeError(f"no phase-1 engine reads a {type(phase1_keys).__name__}")


def phase1_levkey(engine: str, party: int, tildea_p: torch.Tensor, rows: int, scheme: KmsScheme, params: AnyKmsParams, ctx: RingCtx, phase1_keys=None) -> torch.Tensor:
    """One party's phase 1 on the named engine: 'ref' (`phase1` /
    `phase1_block` on `scheme.brk_hat[party]`), 'bm' (`kms_phase1_bm` on
    `phase1_keys.brk_bm[party]`, a BmKmsPhase1) or 'mx2' (`kms_phase1_mx2`
    on `phase1_keys.brk_mx[party]`, an MxKmsKeys or an MxKmsScheme).
    `party` indexes the tensors given, which may hold only some of the
    parties.  Returns the lev key [G, rows, 2, npr, N] in the scheme's prime
    basis `ctx`."""
    if engine == "ref":
        if isinstance(params, KmsBlockParams):
            return phase1_block(tildea_p, scheme.brk_hat[party], rows, scheme.mono_hat, params, ctx)
        return phase1(tildea_p, scheme.brk_hat[party], rows, params, ctx)
    if engine == "bm":
        from ..kernels.batchminor import kms_phase1_bm  # batchminor imports this module

        return kms_phase1_bm(tildea_p, phase1_keys.brk_bm[party], phase1_keys, rows, params, ctx)
    if engine == "mx2":
        from ..kernels.fused_mx2 import kms_phase1_mx2

        return kms_phase1_mx2(tildea_p, phase1_keys.brk_mx[party], rows, params, ctx)
    raise ValueError(f"unknown phase-1 engine {engine!r}")


def _keyswitch(acc: torch.Tensor, scheme: KmsScheme, params: AnyKmsParams) -> Lwe:
    """Modulus switch 2^64 -> 2^32, then the per-party key switch (block:
    the first n extracted coefficients of each party pass for free)."""
    # arithmetic shift: the signed high word carries the u32 high word's bits
    acc32 = (acc >> 32).to(torch.int32)
    if not isinstance(params, KmsBlockParams):
        return keyswitch_per_party(acc32, scheme.ksk_b, scheme.ksk_a, params.f, params.log_d)
    n = params.n
    b0 = acc32[..., 0, 0]
    arr = sample_extract_coeffs(acc32[..., 1:, :])  # [G, k, N]
    oh = signed_onehot(balanced_decomp(arr[..., n:], params.f, params.log_d), params.log_d)
    db, da = limb_dot(oh.reshape(*oh.shape[:-2], -1), scheme.ksk_b, scheme.ksk_a)
    b = wrap_i32(b0.long() + db.sum(-1))
    a = wrap_i32(arr[..., :n].long() + da).reshape(arr.shape[0], -1)
    return Lwe(b=b, a=a)


def bootstrap_with_phase1(ct: Lwe, scheme: KmsScheme, params: AnyKmsParams, engine: str, phase1_keys=None) -> Lwe:
    """The gate bootstrap around a phase-1 engine (`phase1_levkey`): modulus
    switch, phase 1 per party, phase 2, key switch."""
    ctx = _ctx(params)
    with phase_range("mktfhe/mod_switch"):
        tildeb, tildea = mod_switch_2n(ct, params.big_n)
    acc = _phase2(tildeb, _levkeys(tildea, engine, scheme, params, ctx, phase1_keys), scheme, params, ctx)
    with phase_range("mktfhe/keyswitch"):
        return _keyswitch(acc, scheme, params)


def bootstrap(ct: Lwe, scheme: KmsScheme, params: AnyKmsParams) -> Lwe:
    """Multi-key gate bootstrap.  ct: Lwe on the 2^32 torus, b [G],
    a [G, k*n]; every NTT runs through the kernel wrapper."""
    require_brk(scheme, "kms.bootstrap")
    return bootstrap_with_phase1(ct, scheme, params, "ref")


def bootstrap_bm(ct: Lwe, scheme: KmsScheme, phase1_keys, params: KmsParams) -> Lwe:
    """KMS bootstrap with the batch-minor phase-1 engine (every phase-1 NTT
    through the batch-minor NTT kernel).  phase1_keys:
    kernels.batchminor.BmKmsPhase1 (from build_bm_kms_phase1); reads no
    `scheme.brk_hat`.  Phase 2 and the key switch as in `bootstrap`;
    bit-identical to it.  Binary keys only."""
    if isinstance(params, KmsBlockParams):
        raise TypeError(
            "batch-minor phase 1 implements the binary-key rotation; use bootstrap or "
            "bootstrap_mx3 for block presets"
        )
    return bootstrap_with_phase1(ct, scheme, params, "bm", phase1_keys)
