"""Port parity of `bootstrap_mx2`, the slice end to end.

The port's `bootstrap_mx2` (on CPU: the mx sweep kernel's plain version and
the NTT kernel's) against the JAX package's `bootstrap_mx2` with its Pallas
sweep interpreted (`interpret=True, g_tile=4`), on the reference's own keys
and gate ciphertexts bridged as numpy, at TinyKMS2partyMX; tolerance 0.  Also
the KMS golden digest through `bootstrap_mx2`, the port's three KMS engines
against each other, the scheme of `fused_mx2.setup` (no `brk_hat`, the mx
image in its place), and the refusals.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mktfhe_tpu.kernels import fused_mx2 as jmx2
from mktfhe_tpu.schemes import kms as jkms
from mktfhe_tpu.schemes.gates import gate_affine as j_gate_affine
from mktfhe_tpu.schemes.gates import lwe_ith_encrypt_bit as j_encrypt
from mktfhe_tpu.schemes.presets import TEST_PRESETS
from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.kernels import fused_mx2
from mktfhe_tpu_torch.kernels.fused_mx3 import bootstrap_mx3
from mktfhe_tpu_torch.schemes import kms
from mktfhe_tpu_torch.schemes.params import KmsBlockParams

from test_torch_mx2 import reference_keys

CPU = torch.device("cpu")
PARAMS = TEST_PRESETS["TinyKMS2partyMX"]


def _gate_ct(parties, m1, m2, op):
    """A gate input made by the reference (seeds of tests/test_fused_mx2.py)."""
    g = len(m1)
    ct1 = j_encrypt(jax.random.key(1), jnp.array(m1), 0, parties[0][0], PARAMS.alpha, PARAMS.k, (g,))
    ct2 = j_encrypt(jax.random.key(2), jnp.array(m2), 1, parties[1][0], PARAMS.alpha, PARAMS.k, (g,))
    return j_gate_affine(op, ct1, ct2)


def _same(x, y) -> bool:
    return x.b.dtype == y.b.dtype and torch.equal(x.b, y.b) and torch.equal(x.a, y.a)


@pytest.fixture(scope="module")
def keys():
    a, parties = reference_keys(PARAMS)
    tparams = bridge.params(PARAMS)
    pkeys = [bridge.party_key(p[3], CPU) for p in parties]
    return {
        "a": a,
        "parties": parties,
        "tparams": tparams,
        "scheme": kms.setup(bridge.from_numpy(a, CPU), pkeys, tparams),
        "mx_scheme": fused_mx2.setup(bridge.from_numpy(a, CPU), pkeys, tparams),
        "mx_keys": fused_mx2.build_mx_kms_keys(pkeys, tparams),
    }


@pytest.fixture(scope="module")
def gates(keys):
    """Four gates (NAND, OR, XNOR, NOR) and the port's bootstrap_mx2 of them."""
    rng = np.random.default_rng(13)
    m1 = rng.integers(0, 2, size=4).astype(bool)
    m2 = rng.integers(0, 2, size=4).astype(bool)
    ct = _gate_ct(keys["parties"], m1, m2, jnp.array([0, 2, 4, 5], dtype=jnp.int32))
    got = fused_mx2.bootstrap_mx2(bridge.lwe(ct, CPU), keys["mx_scheme"], keys["tparams"])
    return ct, got


def test_bootstrap_mx2_matches_reference_mx2(keys, gates):
    ct, got = gates
    pkeys = [p[3] for p in keys["parties"]]
    scheme = jkms.setup(keys["a"], pkeys, PARAMS)
    jkeys = jmx2.build_mx_kms_keys(pkeys, PARAMS)
    want = jmx2.bootstrap_mx2(ct, scheme, jkeys, PARAMS, interpret=True, g_tile=4)
    np.testing.assert_array_equal(bridge.to_numpy(got.b), np.asarray(want.b))
    np.testing.assert_array_equal(bridge.to_numpy(got.a), np.asarray(want.a))


def test_bootstrap_mx2_golden_digest(keys):
    """The KMS golden of tests/test_goldens.py:54-83, from the same
    reference-made keys and ciphertexts."""
    m = np.array([True, False, True, True])
    ct = _gate_ct(keys["parties"], m, ~m, 0)
    out = fused_mx2.bootstrap_mx2(bridge.lwe(ct, CPU), keys["mx_scheme"], keys["tparams"])
    h = hashlib.sha256()
    for x in (out.b, out.a):
        h.update(np.ascontiguousarray(bridge.to_numpy(x)).tobytes())
    assert h.hexdigest()[:16] == "92d8cc645cbb9c54", h.hexdigest()[:16]


@pytest.mark.parametrize("engine", ["kms.bootstrap", "bootstrap_mx3"])
def test_bootstrap_mx2_matches_port_engines(keys, gates, engine):
    ct, got = gates
    bootstrap = kms.bootstrap if engine == "kms.bootstrap" else bootstrap_mx3
    assert _same(got, bootstrap(bridge.lwe(ct, CPU), keys["scheme"], keys["tparams"]))


@pytest.mark.parametrize("how", ["drop_brk", "setup_without_brk"])
def test_bootstrap_mx2_runs_without_brk_hat(keys, gates, how):
    """The scheme of `fused_mx2.setup`, and a scheme with `brk_hat` joined to
    the mx image by `mx_scheme` (which drops it), hold no `brk_hat`, the
    phase-2 and key-switch keys of `kms.setup` and the mx image of
    `build_mx_kms_keys`."""
    ct, got = gates
    if how == "drop_brk":
        lean = fused_mx2.mx_scheme(keys["scheme"], keys["mx_keys"].brk_mx)
    else:
        lean = keys["mx_scheme"]
    assert isinstance(lean, fused_mx2.MxKmsScheme)
    assert lean.brk_hat.numel() == 0 and lean.brk_hat.dtype == torch.int32
    assert torch.equal(lean.rlk_f_hat, keys["scheme"].rlk_f_hat)
    assert torch.equal(lean.ksk_a, keys["scheme"].ksk_a)
    assert torch.equal(lean.brk_mx, keys["mx_keys"].brk_mx)
    assert _same(got, fused_mx2.bootstrap_mx2(bridge.lwe(ct, CPU), lean, keys["tparams"]))


@pytest.mark.parametrize("engine", ["kms.bootstrap", "bootstrap_mx3"])
def test_engines_that_read_brk_hat_refuse_a_scheme_without(keys, gates, engine):
    ct, _ = gates
    bootstrap = kms.bootstrap if engine == "kms.bootstrap" else bootstrap_mx3
    with pytest.raises(ValueError, match="brk_hat"):
        bootstrap(bridge.lwe(ct, CPU), kms.drop_brk(keys["scheme"]), keys["tparams"])


def test_bootstrap_mx2_refuses_block_parameters(keys, gates):
    ct, _ = gates
    block = KmsBlockParams(
        d=4, ell=2, alpha=16.0, f=8, log_d=2, big_n=128, beta=4.0,
        l_gsw=3, log_b_gsw=8, l_lev=2, log_b_lev=8, l_uni=3, log_b_uni=8, k=2,
    )
    with pytest.raises(TypeError, match="the mx phase-1 kernel implements the binary-key rotation"):
        fused_mx2.bootstrap_mx2(bridge.lwe(ct, CPU), keys["mx_scheme"], block)

