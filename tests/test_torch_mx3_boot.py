"""Port parity of `bootstrap_mx3`, the slice end to end.

The port's `bootstrap_mx3` (on CPU: the sweep kernel's plain version and
the NTT kernel's) against the JAX package's `bootstrap_mx3` with its Pallas
sweep interpreted (`interpret=True, g_tile=4`), on the reference's own keys
and gate ciphertexts bridged as numpy, for a binary-key and a block-key
parameter set; tolerance 0.  Also the port's two engines against each other
and the KMS golden digest through `bootstrap_mx3`.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mktfhe_tpu.kernels.fused_mx3 import bootstrap_mx3 as j_bootstrap_mx3
from mktfhe_tpu.kernels.fused_mx3 import build_mx3_kms_keys
from mktfhe_tpu.schemes import kms as jkms
from mktfhe_tpu.schemes.gates import gate_affine as j_gate_affine
from mktfhe_tpu.schemes.gates import lwe_ith_encrypt_bit as j_encrypt
from mktfhe_tpu.schemes.presets import TEST_PRESETS
from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.kernels.fused_mx3 import bootstrap_mx3
from mktfhe_tpu_torch.schemes import kms

from test_torch_mx3 import BLOCK, TINYMX2, _port_scheme, _reference_keys

CPU = torch.device("cpu")


def _gate_ct(params, parties, m1, m2, op):
    """A gate input made by the reference (seeds of tests/test_fused_mx3.py)."""
    g = len(m1)
    ct1 = j_encrypt(jax.random.key(1), jnp.array(m1), 0, parties[0][0], params.alpha, params.k, (g,))
    ct2 = j_encrypt(jax.random.key(2), jnp.array(m2), 1, parties[1][0], params.alpha, params.k, (g,))
    return j_gate_affine(op, ct1, ct2)


@pytest.fixture(scope="module", params=[TINYMX2, BLOCK], ids=["binary", "block"])
def case(request):
    params = request.param
    a, parties = _reference_keys(params)
    rng = np.random.default_rng(13)
    m1 = rng.integers(0, 2, size=4).astype(bool)
    m2 = rng.integers(0, 2, size=4).astype(bool)
    op = jnp.array([0, 2, 4, 5], dtype=jnp.int32)  # NAND, OR, XNOR, NOR
    ct = _gate_ct(params, parties, m1, m2, op)
    tparams = bridge.params(params)
    got = bootstrap_mx3(bridge.lwe(ct, CPU), _port_scheme(a, parties, tparams), tparams)
    return params, tparams, a, parties, ct, got


def test_bootstrap_mx3_matches_reference_mx3(case):
    params, _, a, parties, ct, got = case
    scheme = jkms.setup(a, [p[3] for p in parties], params)
    keys3 = build_mx3_kms_keys([p[3] for p in parties], params, chunk=3)
    want = j_bootstrap_mx3(ct, scheme, keys3, params, interpret=True, g_tile=4)
    np.testing.assert_array_equal(bridge.to_numpy(got.b), np.asarray(want.b))
    np.testing.assert_array_equal(bridge.to_numpy(got.a), np.asarray(want.a))


def test_bootstrap_mx3_matches_port_reference_engine(case):
    """The port's two engines agree: the sweep path and kms.bootstrap."""
    _, tparams, a, parties, ct, got = case
    want = kms.bootstrap(bridge.lwe(ct, CPU), _port_scheme(a, parties, tparams), tparams)
    assert got.b.dtype == want.b.dtype and got.a.shape == want.a.shape
    assert torch.equal(got.b, want.b) and torch.equal(got.a, want.a)


def test_bootstrap_mx3_golden_digest():
    """The KMS golden of tests/test_goldens.py:54-83 through bootstrap_mx3,
    from the same reference-made keys and ciphertexts."""
    params = TEST_PRESETS["TinyKMS2partyMX"]
    m = np.array([True, False, True, True])
    a, parties = _reference_keys(params)
    ct = _gate_ct(params, parties, m, ~m, 0)
    tparams = bridge.params(params)
    out = bootstrap_mx3(bridge.lwe(ct, CPU), _port_scheme(a, parties, tparams), tparams)
    h = hashlib.sha256()
    for x in (out.b, out.a):
        h.update(np.ascontiguousarray(bridge.to_numpy(x)).tobytes())
    assert h.hexdigest()[:16] == "92d8cc645cbb9c54", h.hexdigest()[:16]
