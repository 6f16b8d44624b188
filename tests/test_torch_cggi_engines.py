"""Port parity of the batch-minor and fused CGGI engines.

`bootstrap_bm` (mktfhe_tpu_torch/kernels/batchminor.py) and
`bootstrap_fused` (kernels/fused_step.py) of the port against the JAX
package's engines of the same names, whose Pallas kernels run in interpret
mode, and against the port's reference engine `cggi.bootstrap`; on the
reference's own keys and ciphertexts (bridged as numpy, seeds of
tests/test_batchminor.py) at TINY, batches of 8 and 256; tolerance 0.  The
larger batch reaches rotation amounts that round to 2N and must wrap to 0
(the monomial table has 2N entries).  On CPU tensors the port's kernel
wrappers run their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mktfhe_tpu.kernels.batchminor import bootstrap_bm as j_bootstrap_bm
from mktfhe_tpu.kernels.batchminor import convert_scheme as j_convert_scheme
from mktfhe_tpu.kernels.fused_step import bootstrap_fused as j_bootstrap_fused
from mktfhe_tpu.schemes import cggi as jcggi
from mktfhe_tpu.schemes.gates import gate_affine as j_gate_affine
from mktfhe_tpu.schemes.gates import lwe_encrypt_bit as j_encrypt
from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.kernels import batchminor, fused_step
from mktfhe_tpu_torch.schemes import cggi
from mktfhe_tpu_torch.schemes.common import mod_switch_2n

from test_cggi import TINY

CPU = torch.device("cpu")
TPARAMS = bridge.params(TINY)


@pytest.fixture(scope="module")
def keys():
    lwe_key, _ring_key, jscheme = jcggi.setup(jax.random.key(7), TINY)
    scheme = bridge.cggi_scheme(jscheme, CPU)
    return lwe_key, jscheme, j_convert_scheme(jscheme, TINY), scheme, batchminor.convert_scheme(scheme, TPARAMS)


@pytest.fixture(scope="module", params=[8, 256], ids=lambda g: f"G{g}")
def case(request, keys):
    """A NAND batch, the port's reference-engine output, and a cache of the
    JAX engines' outputs."""
    lwe_key, jscheme, jbm, scheme, bm = keys
    g = request.param
    rng = np.random.default_rng(21)
    m1 = rng.integers(0, 2, g).astype(bool)
    m2 = rng.integers(0, 2, g).astype(bool)
    ct1 = j_encrypt(jax.random.key(1), jnp.array(m1), lwe_key, TINY.alpha, (g,))
    ct2 = j_encrypt(jax.random.key(2), jnp.array(m2), lwe_key, TINY.alpha, (g,))
    jct = j_gate_affine(0, ct1, ct2)
    ct = bridge.lwe(jct, CPU)
    return {"g": g, "jct": jct, "ct": ct, "ref": cggi.bootstrap(ct, scheme, TPARAMS)}


def _same(got, want_b, want_a):
    np.testing.assert_array_equal(bridge.to_numpy(got.b), np.asarray(want_b))
    np.testing.assert_array_equal(bridge.to_numpy(got.a), np.asarray(want_a))


def test_convert_scheme_matches_reference(keys):
    _, _, jbm, _, bm = keys
    np.testing.assert_array_equal(bridge.to_numpy(bm.brk_bm), np.asarray(jbm.brk_bm))
    np.testing.assert_array_equal(bridge.to_numpy(bm.mono_hat), np.asarray(jbm.mono_hat))


def test_large_batch_reaches_the_wrap(keys, case):
    """The regression of tests/test_batchminor.py:35-50 on this data: every
    amount lies in [0, 2N), and at G = 256 some are exactly 0 after
    rounding to 2N."""
    _, tildea = mod_switch_2n(case["ct"], TINY.big_n)
    assert int(tildea.min()) >= 0 and int(tildea.max()) < 2 * TINY.big_n
    if case["g"] == 256:
        a = bridge.to_numpy(case["ct"].a).astype(np.int64)
        shift = 32 - 7  # log2(2N) = 7 at N = 64
        assert ((a >> (shift - 1)) + 1 >> 1 == 2 * TINY.big_n).any()


def test_bootstrap_bm_matches_reference(keys, case):
    _, _, jbm, _, bm = keys
    got = batchminor.bootstrap_bm(case["ct"], bm, TPARAMS)
    want = j_bootstrap_bm(case["jct"], jbm, TINY, interpret=True)
    _same(got, want.b, want.a)
    assert torch.equal(got.b, case["ref"].b) and torch.equal(got.a, case["ref"].a)


def test_bootstrap_fused_matches_reference(keys, case):
    _, _, jbm, _, bm = keys
    fused_step.reset_launches()
    got = fused_step.bootstrap_fused(case["ct"], bm, TPARAMS)
    want = j_bootstrap_fused(case["jct"], jbm, TINY, g_tile=8, interpret=True)
    _same(got, want.b, want.a)
    assert torch.equal(got.b, case["ref"].b) and torch.equal(got.a, case["ref"].a)
    assert fused_step.cggi_step.launches == 0  # only kernel launches count


def test_reference_engine_matches_jax(keys, case):
    _, jscheme, _, _, _ = keys
    want = jcggi.bootstrap(case["jct"], jscheme, TINY)
    _same(case["ref"], want.b, want.a)
