"""Port parity at the gadget of the largest KMS presets (KMS32party,
KMS32partyblock: l_gsw = 6, l_lev = 3, l_uni = 16, log_b_uni = 2).

The port's KMS engines -- `kms.bootstrap`, `bootstrap_mx3` (on CPU
tensors the sweep kernel's plain version), and for binary keys
`bootstrap_mx2` (the mx sweep kernel's plain version) and `kms.bootstrap_bm`
(the batch-minor NTT's plain version) -- on the JAX package's own keys and
gate ciphertexts, bridged as numpy, against the JAX `kms.bootstrap` (jitted);
tolerance 0; phase 2's hybrid product also over chunks of parties.  The
tiny sets keep the presets' gadgets and cut n, N and k:
binary keys at n = 8, N = 128 (the mx order needs N % 128 == 0), block keys
at d = 3, ell = 3, N = 64, both at k = 3.  With l_uni = 16 the hybrid
product's contraction is exactly `MAX_PRODUCT_TERMS` products, summed before
one reduction: the test below holds that sum at its int64 limit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mktfhe_tpu.schemes import kms as jkms
from mktfhe_tpu.schemes.gates import gate_affine as j_gate_affine
from mktfhe_tpu.schemes.gates import lwe_ith_encrypt_bit as j_encrypt
from mktfhe_tpu.schemes.params import KmsBlockParams, KmsParams
from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.kernels import batchminor, fused_mx2
from mktfhe_tpu_torch.kernels.fused_mx3 import bootstrap_mx3
from mktfhe_tpu_torch.ring.modring import MAX_PRODUCT_TERMS, PRIMES, mulsum_mod
from mktfhe_tpu_torch.schemes import kms

CPU = torch.device("cpu")
# the gadget of KMS32party and KMS32partyblock (schemes/presets.py)
KMS32_GADGET = dict(l_gsw=6, log_b_gsw=7, l_lev=3, log_b_lev=7, l_uni=16, log_b_uni=2)
TINY_NOISE = dict(alpha=16.0, f=8, log_d=2, beta=4.0)
KMS32_TINY = KmsParams(n=8, big_n=128, k=3, **TINY_NOISE, **KMS32_GADGET)
KMS32_TINY_BLOCK = KmsBlockParams(d=3, ell=3, big_n=64, k=3, **TINY_NOISE, **KMS32_GADGET)
OPS = [0, 2, 4, 5]  # NAND, OR, XNOR, NOR


def reference_case(params):
    """The JAX package's crs, party keys and four gate ciphertexts (parties 1
    and 2 encrypt), its scheme and its jitted `kms.bootstrap` of them."""
    a = jkms.crs(jax.random.key(300), params)
    parties = [jkms.party_keygen(jax.random.key(400 + i), a, params) for i in range(params.k)]
    rng = np.random.default_rng(13)
    m1 = rng.integers(0, 2, size=len(OPS)).astype(bool)
    m2 = rng.integers(0, 2, size=len(OPS)).astype(bool)
    g = len(OPS)
    ct1 = j_encrypt(jax.random.key(1), jnp.array(m1), 0, parties[0][0], params.alpha, params.k, (g,))
    ct2 = j_encrypt(jax.random.key(2), jnp.array(m2), 1, parties[1][0], params.alpha, params.k, (g,))
    ct = j_gate_affine(jnp.array(OPS, dtype=jnp.int32), ct1, ct2)
    jscheme = jkms.setup(a, [p[3] for p in parties], params)
    want = jkms.bootstrap(ct, jscheme, params)
    tparams = bridge.params(params)
    pkeys = [bridge.party_key(p[3], CPU) for p in parties]
    return {
        "params": params,
        "tparams": tparams,
        "jscheme": jscheme,
        "want": want,
        "ct": bridge.lwe(ct, CPU),
        "party_keys": pkeys,
        "crs": bridge.from_numpy(a, CPU),
        "scheme": kms.setup(bridge.from_numpy(a, CPU), pkeys, tparams),
    }


def port_output(case, engine: str):
    """The port's bootstrap of the case's ciphertexts on the named engine."""
    ct, scheme, tparams = case["ct"], case["scheme"], case["tparams"]
    if engine == "kms.bootstrap":
        return kms.bootstrap(ct, scheme, tparams)
    if engine == "bootstrap_mx3":
        return bootstrap_mx3(ct, scheme, tparams)
    if engine == "kms.bootstrap_bm":
        bm_keys = batchminor.build_bm_kms_phase1(case["party_keys"], tparams)
        return kms.bootstrap_bm(ct, kms.drop_brk(scheme), bm_keys, tparams)
    return fused_mx2.bootstrap_mx2(ct, fused_mx2.setup(case["crs"], case["party_keys"], tparams), tparams)


def assert_same(got, want) -> None:
    np.testing.assert_array_equal(bridge.to_numpy(got.b), np.asarray(want.b))
    np.testing.assert_array_equal(bridge.to_numpy(got.a), np.asarray(want.a))


@pytest.fixture(scope="module")
def binary():
    return reference_case(KMS32_TINY)


@pytest.fixture(scope="module")
def block():
    return reference_case(KMS32_TINY_BLOCK)


@pytest.fixture(params=["binary", "block"])
def case(request):
    return request.getfixturevalue(request.param)


def test_setup_matches_reference(case):
    """The port's scheme from the bridged party keys has the JAX package's
    NTT-domain images, bit for bit."""
    want = case["jscheme"]
    for name in ("crs_hat", "pub_b_hat", "brk_hat", "rlk_d_hat", "rlk_f_hat", "ksk_b", "ksk_a", "mono_hat"):
        ref = np.asarray(getattr(want, name))
        np.testing.assert_array_equal(bridge.to_numpy(getattr(case["scheme"], name)).view(ref.dtype), ref,
                                      err_msg=name)


def test_hybrid_product_runs_at_the_contraction_limit(case):
    """Phase 2 contracts l_uni = MAX_PRODUCT_TERMS digit products unreduced,
    over the preset's own prime count (3 at both KMS32 presets)."""
    assert case["params"].l_uni == MAX_PRODUCT_TERMS
    assert case["tparams"].ring_nprimes == 3


@pytest.mark.parametrize("engine", ["kms.bootstrap", "bootstrap_mx3"])
def test_bootstrap_matches_reference(case, engine):
    assert_same(port_output(case, engine), case["want"])


def test_bootstrap_mx2_matches_reference(binary):
    """The mx engine (binary keys only), on the scheme of its own set-up
    from the bridged party keys: no `brk_hat`, the mx image in its place."""
    assert_same(port_output(binary, "bootstrap_mx2"), binary["want"])


def test_bootstrap_bm_matches_reference(binary):
    """The batch-minor engine (binary keys only), on its own keys built from
    the bridged party keys (l_gsw = 6: forward transforms of 3 x 2 x 6 = 36
    rows a step) and a scheme without `brk_hat`."""
    assert_same(port_output(binary, "kms.bootstrap_bm"), binary["want"])


@pytest.mark.parametrize("parties", [1, 2])
def test_phase2_in_chunks_matches_reference(case, parties, monkeypatch):
    """Phase 2's hybrid product over chunks of one and of two parties (the
    second: a chunk holding party 1 and 2, then one holding party 3) gives
    the unchunked residues."""
    ctx = kms._ctx(case["tparams"])
    per_party = len(OPS) * case["params"].l_uni * ctx.nprimes * ctx.n
    monkeypatch.setattr(kms, "PHASE2_CHUNK_RESIDUES", parties * per_party)
    assert kms.hybrid_chunk(len(OPS), case["tparams"], ctx) == parties
    assert_same(port_output(case, "bootstrap_mx3"), case["want"])


@pytest.mark.parametrize("prime", PRIMES)
def test_mulsum_mod_at_sixteen_terms(prime):
    """MAX_PRODUCT_TERMS products of the largest residues sum below 2^63 and
    reduce to the Python integer's residue; one more term is refused."""
    top = torch.full((MAX_PRODUCT_TERMS, 2), prime - 1, dtype=torch.int32)
    p = torch.tensor(prime, dtype=torch.int64)
    got = mulsum_mod(top, top, 0, p)
    want = MAX_PRODUCT_TERMS * (prime - 1) ** 2
    assert want < 1 << 63
    assert got.tolist() == [want % prime] * 2
    mixed = torch.randint(0, prime, (MAX_PRODUCT_TERMS, 5), generator=torch.Generator().manual_seed(prime))
    mixed = mixed.to(torch.int32)
    exact = [sum(int(x) * int(x) for x in col) % prime for col in mixed.T]
    assert mulsum_mod(mixed, mixed, 0, p).tolist() == exact
    with pytest.raises(ValueError):
        mulsum_mod(torch.cat([top, top[:1]]), torch.cat([top, top[:1]]), 0, p)
