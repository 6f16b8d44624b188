"""Port parity of the KMS batch-minor engine (kernels/batchminor.py, KMS half;
schemes/kms.py:bootstrap_bm).

`build_bm_kms_phase1` of the port on the reference's party keys against the
JAX package's `brk_bm` and monomial table; `kms.bootstrap_bm` against the JAX
`kms.bootstrap_bm` with its Pallas NTT interpreted, at the `TINY` of
tests/test_kms.py (as tests/test_kms_bm.py), on the reference's keys and
ciphertexts bridged as numpy; tolerance 0.  On CPU tensors the batch-minor
NTT wrapper runs the kernel's plain version.  Also the engine against the
port's `kms.bootstrap`, on a scheme without `brk_hat`, and the refusal of
block parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mktfhe_tpu.kernels.batchminor import build_bm_kms_phase1 as j_build_bm_kms_phase1
from mktfhe_tpu.schemes import kms as jkms
from mktfhe_tpu.schemes.gates import gate_affine as j_gate_affine
from mktfhe_tpu.schemes.gates import lwe_ith_encrypt_bit as j_encrypt
from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.kernels import batchminor
from mktfhe_tpu_torch.schemes import kms

from test_kms import TINY, TINY_BLOCK

CPU = torch.device("cpu")
G = 4


@pytest.fixture(scope="module")
def case():
    params = TINY
    a = jkms.crs(jax.random.key(300), params)
    parties = [jkms.party_keygen(jax.random.key(400 + i), a, params) for i in range(params.k)]
    rng = np.random.default_rng(17)
    m1 = rng.integers(0, 2, G).astype(bool)
    m2 = rng.integers(0, 2, G).astype(bool)
    ct1 = j_encrypt(jax.random.key(1), jnp.array(m1), 0, parties[0][0], params.alpha, params.k, (G,))
    ct2 = j_encrypt(jax.random.key(2), jnp.array(m2), 1, parties[1][0], params.alpha, params.k, (G,))
    ct = j_gate_affine(jnp.array([0, 2, 4, 5], dtype=jnp.int32), ct1, ct2)
    tparams = bridge.params(params)
    pkeys = [bridge.party_key(p[3], CPU) for p in parties]
    scheme = kms.setup(bridge.from_numpy(a, CPU), pkeys, tparams)
    bm_keys = batchminor.build_bm_kms_phase1(pkeys, tparams)
    return {
        "params": params, "a": a, "parties": parties, "ct": ct, "tparams": tparams,
        "scheme": scheme, "bm_keys": bm_keys,
        "jkeys": j_build_bm_kms_phase1([p[3] for p in parties], params),
        "got": kms.bootstrap_bm(bridge.lwe(ct, CPU), scheme, bm_keys, tparams),
    }


def test_build_bm_kms_phase1_matches_reference(case):
    got, want, params = case["bm_keys"], case["jkeys"], case["params"]
    assert got.brk_bm.dtype == torch.int32 and got.mono_hat.dtype == torch.int32
    assert tuple(got.brk_bm.shape[:2]) == (params.k, params.n)
    assert tuple(got.brk_bm.shape[3:]) == (2 * params.l_gsw, 2, params.big_n)
    np.testing.assert_array_equal(bridge.to_numpy(got.brk_bm), np.asarray(want.brk_bm))
    np.testing.assert_array_equal(bridge.to_numpy(got.mono_hat), np.asarray(want.mono_hat))
    carried = bridge.bm_kms_phase1(want, CPU)  # without the Shoup companions
    assert torch.equal(carried.brk_bm, got.brk_bm) and torch.equal(carried.mono_hat, got.mono_hat)


def test_kms_bootstrap_bm_matches_reference(case):
    params, got = case["params"], case["got"]
    scheme = jkms.setup(case["a"], [p[3] for p in case["parties"]], params)
    want = jkms.bootstrap_bm(case["ct"], scheme, case["jkeys"], params, interpret=True)
    np.testing.assert_array_equal(bridge.to_numpy(got.b), np.asarray(want.b))
    np.testing.assert_array_equal(bridge.to_numpy(got.a), np.asarray(want.a))


def test_kms_bootstrap_bm_matches_port_reference_engine(case):
    want = kms.bootstrap(bridge.lwe(case["ct"], CPU), case["scheme"], case["tparams"])
    got = case["got"]
    assert got.b.dtype == want.b.dtype and got.a.shape == want.a.shape
    assert torch.equal(got.b, want.b) and torch.equal(got.a, want.a)


def test_kms_bootstrap_bm_runs_without_brk_hat(case):
    lean = kms.drop_brk(case["scheme"])
    out = kms.bootstrap_bm(bridge.lwe(case["ct"], CPU), lean, case["bm_keys"], case["tparams"])
    assert torch.equal(out.b, case["got"].b) and torch.equal(out.a, case["got"].a)


def test_kms_phase1_bm_matches_phase1(case):
    """One party's lev key, l_lev rows, against the reference engine's loop."""
    tparams, scheme = case["tparams"], case["scheme"]
    ctx = kms._ctx(tparams)
    rng = np.random.default_rng(3)
    ta = torch.from_numpy(rng.integers(0, 2 * tparams.big_n, size=(3, tparams.n)).astype(np.int32))
    got = batchminor.kms_phase1_bm(ta, case["bm_keys"].brk_bm[1], case["bm_keys"], tparams.l_lev, tparams, ctx)
    want = kms.phase1(ta, scheme.brk_hat[1], tparams.l_lev, tparams, ctx)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_kms_bootstrap_bm_refuses_block_parameters(case):
    with pytest.raises(TypeError, match="binary-key rotation"):
        kms.bootstrap_bm(bridge.lwe(case["ct"], CPU), case["scheme"], case["bm_keys"], bridge.params(TINY_BLOCK))
