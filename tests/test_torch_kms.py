"""Port parity, the slice end to end: the port's KMS setup and bootstrap on
the reference's own keys and ciphertexts (bridged as numpy) vs
mktfhe_tpu.schemes.kms; tolerance 0 (bit-identical).

The comparison reference is kms.bootstrap(pallas_ntt=False), which is
bit-identical to the Pallas-NTT path (tests/test_kms.py) that the port's
bootstrap mirrors; on CPU the port's kernel wrapper runs its plain twin.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mktfhe_tpu.schemes import kms as jkms
from mktfhe_tpu.schemes.gates import gate_affine as j_gate_affine
from mktfhe_tpu.schemes.gates import lwe_ith_encrypt_bit as j_encrypt
from mktfhe_tpu.schemes.presets import TEST_PRESETS
from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.schemes import kms

from test_kms import TINY, TINY_BLOCK

CPU = torch.device("cpu")


def _reference_inputs(params, m1, m2, op):
    """The reference's keys (seeds of tests/test_kms.py) and a gate ct."""
    a = jkms.crs(jax.random.key(300), params)
    parties = [jkms.party_keygen(jax.random.key(400 + i), a, params) for i in range(params.k)]
    g = len(m1)
    ct1 = j_encrypt(jax.random.key(1), jnp.array(m1), 0, parties[0][0], params.alpha, params.k, (g,))
    ct2 = j_encrypt(jax.random.key(2), jnp.array(m2), 1, parties[1][0], params.alpha, params.k, (g,))
    return a, parties, j_gate_affine(op, ct1, ct2)


def _port_scheme(a, parties, tparams):
    return kms.setup(
        bridge.from_numpy(a, CPU), [bridge.party_key(p[3], CPU) for p in parties], tparams
    )


@pytest.fixture(scope="module", params=[TINY, TINY_BLOCK], ids=["kms", "kms_block"])
def case(request):
    params = request.param
    rng = np.random.default_rng(13)
    m1 = rng.integers(0, 2, size=4).astype(bool)
    m2 = rng.integers(0, 2, size=4).astype(bool)
    op = jnp.array([0, 2, 4, 5], dtype=jnp.int32)  # NAND, OR, XNOR, NOR
    a, parties, ct = _reference_inputs(params, m1, m2, op)
    tparams = bridge.params(params)
    return params, tparams, a, parties, ct


def test_setup_matches_reference(case):
    """The port's setup builds, from the bridged party keys, the same
    NTT-domain keys as the reference's KmsScheme."""
    params, tparams, a, parties, _ = case
    want = jkms.setup(a, [p[3] for p in parties], params)
    got = _port_scheme(a, parties, tparams)
    for name in ("crs_hat", "pub_b_hat", "brk_hat", "rlk_d_hat", "rlk_f_hat", "ksk_b", "ksk_a", "mono_hat"):
        np.testing.assert_array_equal(
            bridge.to_numpy(getattr(got, name)).view(np.asarray(getattr(want, name)).dtype),
            np.asarray(getattr(want, name)),
            err_msg=name,
        )


def test_bootstrap_matches_reference(case):
    params, tparams, a, parties, ct = case
    want = jkms.bootstrap(ct, jkms.setup(a, [p[3] for p in parties], params), params)
    got = kms.bootstrap(bridge.lwe(ct, CPU), _port_scheme(a, parties, tparams), tparams)
    np.testing.assert_array_equal(bridge.to_numpy(got.b), np.asarray(want.b))
    np.testing.assert_array_equal(bridge.to_numpy(got.a), np.asarray(want.a))


def test_bootstrap_golden_digest():
    """The KMS golden of tests/test_goldens.py:54-83 (pinned there on the
    mx2 engine; all KMS engines are bit-identical), reproduced by the port
    from the same reference-made keys and ciphertexts."""
    params = TEST_PRESETS["TinyKMS2partyMX"]
    m = np.array([True, False, True, True])
    a, parties, ct = _reference_inputs(params, m, ~m, 0)
    out = kms.bootstrap(bridge.lwe(ct, CPU), _port_scheme(a, parties, bridge.params(params)), bridge.params(params))
    h = hashlib.sha256()
    for x in (out.b, out.a):
        h.update(np.ascontiguousarray(bridge.to_numpy(x)).tobytes())
    assert h.hexdigest()[:16] == "92d8cc645cbb9c54", h.hexdigest()[:16]
