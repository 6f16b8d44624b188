"""Port parity of `utils/noise.py`.

`phase_error_bits` and `noise_report` of the port against the JAX package's
on the same bootstrap outputs (CGGI TINY and TinyKMS2party, made by the JAX
package, u32 carriers): the errors exactly, the report's integers exactly
and its floats to a relative 1e-12.  On u64 carriers the JAX functions
raise under NumPy 2 (their `% (1 << 64)` overflows a C long), so there, and
again on u32, the port is held against the definition in Python integers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mktfhe_tpu.ciphertext.keys import LweKey as JLweKey
from mktfhe_tpu.ciphertext.lwe import Lwe as JLwe
from mktfhe_tpu.schemes import cggi as jcggi
from mktfhe_tpu.schemes import kms as jkms
from mktfhe_tpu.schemes.gates import gate_affine as j_gate_affine
from mktfhe_tpu.schemes.gates import lwe_encrypt_bit as j_encrypt
from mktfhe_tpu.schemes.gates import lwe_ith_encrypt_bit as j_encrypt_ith
from mktfhe_tpu.schemes.presets import TEST_PRESETS
from mktfhe_tpu.utils import noise as jnoise
from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.ciphertext.keys import LweKey
from mktfhe_tpu_torch.ciphertext.lwe import Lwe
from mktfhe_tpu_torch.utils import noise

from test_cggi import TINY as CGGI_TINY

CPU = torch.device("cpu")
G = 32


def _cggi_case():
    lwe_key, _, scheme = jcggi.setup(jax.random.key(7), CGGI_TINY)
    rng = np.random.default_rng(2)
    m1, m2 = (rng.integers(0, 2, G).astype(bool) for _ in range(2))
    cts = [j_encrypt(jax.random.key(1 + i), jnp.array(m), lwe_key, CGGI_TINY.alpha, (G,)) for i, m in enumerate((m1, m2))]
    return jcggi.bootstrap(j_gate_affine(0, *cts), scheme, CGGI_TINY), [lwe_key], ~(m1 & m2)


def _kms_case():
    params = TEST_PRESETS["TinyKMS2party"]
    a = jkms.crs(jax.random.key(300), params)
    parties = [jkms.party_keygen(jax.random.key(400 + i), a, params) for i in range(params.k)]
    scheme = jkms.setup(a, [p[3] for p in parties], params)
    rng = np.random.default_rng(3)
    m1, m2 = (rng.integers(0, 2, G).astype(bool) for _ in range(2))
    cts = [j_encrypt_ith(jax.random.key(1 + i), jnp.array(m), i, parties[i][0], params.alpha, params.k, (G,))
           for i, m in enumerate((m1, m2))]
    return jkms.bootstrap(j_gate_affine(0, *cts), scheme, params), [p[0] for p in parties], ~(m1 & m2)


def _assert_report(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    assert got["samples"] == want["samples"]
    for key in ("std_bits", "max_abs_bits", "margin_bits", "margin_sigmas"):
        assert got[key] == pytest.approx(float(want[key]), rel=1e-12), key


@pytest.mark.parametrize("case", [_cggi_case, _kms_case], ids=["cggi", "kms"])
def test_matches_jax_on_bootstrap_outputs(case):
    out, keys, want = case()
    t_out, t_keys = bridge.lwe(out, CPU), [bridge.lwe_key(k, CPU) for k in keys]
    err = noise.phase_error_bits(t_out, t_keys, want)
    assert err.dtype == np.int64
    np.testing.assert_array_equal(err, jnoise.phase_error_bits(out, keys, want))
    rep = noise.noise_report(t_out, t_keys, want)
    _assert_report(rep, jnoise.noise_report(out, keys, want))
    assert rep["max_abs_bits"] < rep["margin_bits"]


def _exact_errors(b, a, keys, want, t):
    """The phase error by its definition, in Python integers."""
    n = len(keys[0])
    out = []
    for g in range(len(b)):
        ph = int(b[g]) + sum(int(a[g, i * n + j]) * int(key[j]) for i, key in enumerate(keys) for j in range(n))
        err = (ph - (1 << (t - 3) if want[g] else -(1 << (t - 3)))) % (1 << t)
        out.append(err - (1 << t) if err >= 1 << (t - 1) else err)
    return np.array(out, dtype=np.int64)


@pytest.mark.parametrize("t", [32, 64])
def test_carrier_widths_against_the_definition(t):
    """Uniform b and a over all t bits, two binary keys of 16: the errors
    exactly, and the report from them."""
    rng = np.random.default_rng(t)
    udt = np.uint32 if t == 32 else np.uint64
    b = rng.integers(0, 1 << t, 40, dtype=np.uint64).astype(udt)
    a = rng.integers(0, 1 << t, (40, 32), dtype=np.uint64).astype(udt)
    keys = [rng.integers(0, 2, 16).astype(udt) for _ in range(2)]
    want = rng.integers(0, 2, 40).astype(bool)
    out = Lwe(b=bridge.from_numpy(b, CPU), a=bridge.from_numpy(a, CPU))
    t_keys = [LweKey(key=bridge.from_numpy(k, CPU)) for k in keys]
    assert out.b.dtype == (torch.int32 if t == 32 else torch.int64)
    exact = _exact_errors(b, a, keys, want, t)
    np.testing.assert_array_equal(noise.phase_error_bits(out, t_keys, want), exact)
    if t == 32:
        j_out, j_keys = JLwe(b=jnp.asarray(b), a=jnp.asarray(a)), [JLweKey(key=jnp.asarray(k)) for k in keys]
        np.testing.assert_array_equal(jnoise.phase_error_bits(j_out, j_keys, want), exact)
    err = exact.astype(np.float64)
    rep = noise.noise_report(out, t_keys, want)
    assert rep["samples"] == 40
    assert rep["std_bits"] == pytest.approx(np.log2(err.std()), rel=1e-12)
    assert rep["max_abs_bits"] == pytest.approx(np.log2(np.abs(err).max() + 1), rel=1e-12)
    assert rep["margin_bits"] == t - 4
    assert rep["margin_sigmas"] == pytest.approx(2.0 ** (t - 4) / err.std(), rel=1e-12)
