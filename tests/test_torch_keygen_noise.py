"""The error distributions and secret weights of one party's KMS keys, made
by the port's keygen and by the JAX package's, at the parameters of every
binary KMS preset (KMS2party .. KMS32party).

Each key's errors are read back with the party's own secrets through the
port's exact ring arithmetic (the JAX keys bridged as numpy):
  * brk, RGSW(s_i) under the gsw key: every row's phase minus g_j s_i (times
    the gsw key on the mask component);
  * pub_b = -s a_j + e against the CRS: its phase under the uni key;
  * rlk = UniEnc(gsw key): f's rows are an RLEV of the ephemeral ternary r
    under the uni key (r read back from the top row), d_j - r a_j - g_j z;
  * ksk, LWE encryptions on the 2^32 torus of the uni key's coefficients
    times g_j v, reassembled from their int8 limbs: b + <a, s> - m.
Every error's sample std must lie within STD_ERRORS standard errors of its
sigma (beta on the 2^64 torus, alpha on the 2^32 torus; the rounding of a
gaussian adds 1/12 to its variance), its mean within as many of 0, and each
binary secret's weight within as many of half its length (the ternary r's
support within as many of two thirds).  A sample std of m gaussian values
has a standard error of sigma / sqrt(2 (m - 1)).

The per-sample distributions depend on alpha, beta, N and the gadget, not on
the LWE dimension n, which only sets how many brk rows there are: n is cut to
N_CUT (the LWE key's weight is tested on its own at the preset's n).
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from mktfhe_tpu.ciphertext.keys import binary_lwe_key as j_binary_lwe_key
from mktfhe_tpu.schemes import kms as jkms
from mktfhe_tpu.schemes import presets as jpresets
from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.ciphertext.keys import _mk_ringkey, binary_lwe_key
from mktfhe_tpu_torch.ciphertext.rlwe import gadget_gvec, rlwe_phase
from mktfhe_tpu_torch.ciphertext.unienc import _mul_hat
from mktfhe_tpu_torch.ring.modring import prime_column
from mktfhe_tpu_torch.ring.ntt import fwd_ntt
from mktfhe_tpu_torch.ring.torus import lift
from mktfhe_tpu_torch.schemes import kms
from mktfhe_tpu_torch.schemes.common import NLIMB

CPU = torch.device("cpu")
BINARY_PRESETS = ["KMS2party", "KMS4party", "KMS8party", "KMS16party", "KMS32party"]
N_CUT = 8
STD_ERRORS = 5.0  # a bound this many standard errors wide fails a correct keygen about once in 10^6 checks


def _keys(name: str, package: str):
    """One party's (lwe_key, gsw_key, uni_key, KmsPartyKey, crs) from either
    keygen at the preset's parameters with n = N_CUT, as port tensors."""
    jparams = dataclasses.replace(jpresets.ALL_PRESETS[name], n=N_CUT)
    params = bridge.params(jparams)
    ctx = kms._ctx(params)
    if package == "port":
        gen = torch.Generator().manual_seed(BINARY_PRESETS.index(name))
        a = kms.crs(gen, params)
        lwe_key, gsw_key, uni_key, pk = kms.party_keygen(gen, a, params)
        return params, ctx, lwe_key, gsw_key, uni_key, pk, a
    a = jkms.crs(jax.random.key(11), jparams)
    jl, jg, ju, jpk = jkms.party_keygen(jax.random.key(12 + BINARY_PRESETS.index(name)), a, jparams)

    def ring(key):
        return _mk_ringkey(bridge.from_numpy(np.asarray(key.key), CPU), ctx)

    return (params, ctx, bridge.lwe_key(jl, CPU), ring(jg), ring(ju), bridge.party_key(jpk, CPU),
            bridge.from_numpy(np.asarray(a), CPU))


def _limbs_u32(limbs: torch.Tensor) -> torch.Tensor:
    """int8 balanced limbs [NLIMB, ...] -> the u32 values, int64 in [0, 2^32)."""
    return sum(limbs[j].long() << (8 * j) for j in range(NLIMB)) & 0xFFFFFFFF


def _signed(x: torch.Tensor, bits: int) -> np.ndarray:
    """Torus values (wrapped) as signed floats."""
    x = x.long()
    if bits == 32:
        x = x & 0xFFFFFFFF
        x = torch.where(x >= 1 << 31, x - (1 << 32), x)
    return x.double().numpy().ravel()


def _errors(params, ctx, lwe_key, gsw_key, uni_key, pk, crs) -> dict:
    """Every key component's errors, as signed floats."""
    out = {}
    # brk [n, 2, l, 2, N]: row (i, c, j) adds g_j s_i to component c
    l = params.l_gsw
    g = gadget_gvec(l, params.log_b_gsw, ctx.dtype, CPU)
    phase = rlwe_phase(pk.brk, gsw_key, ctx)  # [n, 2, l, N]
    bits = lwe_key.key.long()
    msg = torch.zeros_like(phase)
    msg[:, 0, :, 0] = g[None] * bits[:, None]
    msg[:, 1] = (g[None, :, None] * bits[:, None, None]) * gsw_key.key[0][None, None]
    out["brk"] = _signed(phase - msg, 64)
    # pub_b_j = -s a_j + e
    out["pub_b"] = _signed(rlwe_phase(torch.stack([pk.pub_b, crs], dim=-2), uni_key, ctx), 64)
    # rlk: f_j = RLEV_j(r) under the uni key, d_j = r a_j + g_j z + e
    gu = gadget_gvec(params.l_uni, params.log_b_uni, ctx.dtype, CPU)
    fphase = rlwe_phase(pk.rlk_f, uni_key, ctx)  # [l_uni, N]
    top = gu[0].item()
    r = torch.round(torch.from_numpy(_signed(fphase[0], 64)) / top).long()
    out["rlk_f"] = _signed(fphase - gu[:, None] * r[None], 64)
    r_hat = fwd_ntt(lift(r[None], ctx.crt), ctx.plan)[0]
    out["rlk_d"] = _signed(pk.rlk_d - _mul_hat(crs, r_hat, ctx) - gu[:, None] * gsw_key.key[0][None], 64)
    out["r"] = r.numpy()
    # ksk rows (coeff, level j, value v): b = -<a, s> + coeff g_j v + e on the 2^32 torus
    b, a = _limbs_u32(pk.ksk_b), _limbs_u32(pk.ksk_a)
    gk = gadget_gvec(params.f, params.log_d, torch.int32, CPU).long() & 0xFFFFFFFF
    vals = torch.arange(1, (1 << params.log_d) // 2 + 1)
    m = (uni_key.key[0].long()[:, None, None] * gk[None, :, None] * vals).reshape(-1)
    out["ksk"] = _signed(b + (a * lwe_key.key.long()).sum(-1) - m, 32)
    return out


def _within(sample: np.ndarray, sigma: float, what: str) -> None:
    m = sample.size
    want = math.sqrt(sigma * sigma + 1 / 12)
    std = sample.std(ddof=1)
    assert abs(std / want - 1) <= STD_ERRORS / math.sqrt(2 * (m - 1)), f"{what}: std {std} against {want}, {m} samples"
    assert abs(sample.mean()) <= STD_ERRORS * want / math.sqrt(m), f"{what}: mean {sample.mean()}, {m} samples"


def _weight_within(bits: np.ndarray, p: float, what: str) -> None:
    m = bits.size
    assert abs(bits.sum() - p * m) <= STD_ERRORS * math.sqrt(m * p * (1 - p)), f"{what}: {bits.sum()} of {m}"


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("name", BINARY_PRESETS)
def test_key_errors_and_secrets(name, package):
    params, ctx, lwe_key, gsw_key, uni_key, pk, crs = _keys(name, package)
    err = _errors(params, ctx, lwe_key, gsw_key, uni_key, pk, crs)
    for comp in ("brk", "pub_b", "rlk_f", "rlk_d"):
        _within(err[comp], params.beta, f"{package} {name} {comp}")
    _within(err["ksk"], params.alpha, f"{package} {name} ksk")
    for key, what in ((gsw_key, "gsw key"), (uni_key, "uni key")):
        bits = key.key.numpy().ravel()
        assert set(np.unique(bits)) <= {0, 1}, what
        _weight_within(bits, 0.5, f"{package} {name} {what}")
    r = err["r"]
    assert set(np.unique(r)) <= {-1, 0, 1}, "the ephemeral key r is not ternary"
    _weight_within(r != 0, 2 / 3, f"{package} {name} r's support")


@pytest.mark.parametrize("package", ["port", "jax"])
def test_lwe_key_weight(package):
    """The LWE key at the binary presets' n (560): a fair coin per bit."""
    n = jpresets.KMS_32PARTY.n
    if package == "port":
        bits = binary_lwe_key(torch.Generator().manual_seed(5), n, torch.int32).key.numpy()
    else:
        bits = np.asarray(j_binary_lwe_key(jax.random.key(5), n, np.uint32).key)
    assert set(np.unique(bits)) <= {0, 1}
    _weight_within(bits.astype(np.int64), 0.5, f"{package} LWE key")
