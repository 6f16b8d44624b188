"""Port parity of the CCS gate bootstrap at the party count and gadget of
CCS8party (k = 8, l_uni 5, log_b_uni 6), at tests/test_ccs.py's TINY width
(n = 8, N = 64); CCS16party's in test_torch_ccs_parties16.py.

The relinearisation of party k contracts (k+1) * l_uni = 45 digit products
(204 at CCS16party), past the 16 that int64 sums unreduced
(`MAX_PRODUCT_TERMS`); the port sums the components' digits before their
transform (schemes/ccs.py).  The port's `ccs.setup` images from the bridged
reference party keys and its `ccs.bootstrap` against the JAX package's
(jitted), tolerance 0, and the outputs decrypted to the clear gates.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mktfhe_tpu.schemes.gates import GATE_IDS
from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.ring.modring import MAX_PRODUCT_TERMS
from mktfhe_tpu_torch.schemes import ccs, gates

from test_ccs import TINY
from test_torch_ccs import _assert_same, _gate_ct, _reference_keys, j_bootstrap

CPU = torch.device("cpu")
# the gadget and party count of CCS8party (schemes/presets.py)
CCS8_TINY = dataclasses.replace(TINY, k=8, l_uni=5, log_b_uni=6)
OPS = ["NAND", "AND", "OR", "XOR"]


def reference_case(params):
    """The JAX package's keys and four gate ciphertexts (parties 1 and 2
    encrypt), its scheme and the port's from the bridged party keys."""
    lwe_keys, jscheme, scheme = _reference_keys(params, 700, 800)
    rng = np.random.default_rng(17)
    m1 = rng.integers(0, 2, size=len(OPS)).astype(bool)
    m2 = rng.integers(0, 2, size=len(OPS)).astype(bool)
    ct = _gate_ct(params, lwe_keys, m1, m2, jnp.array([GATE_IDS[o] for o in OPS], dtype=jnp.int32))
    return {"params": params, "lwe_keys": lwe_keys, "jscheme": jscheme, "scheme": scheme, "ct": ct,
            "clear": [gates.CLEAR_OPS[o](bool(a), bool(b)) for o, a, b in zip(OPS, m1, m2)]}


@pytest.fixture(scope="module")
def case():
    return reference_case(CCS8_TINY)


def test_setup_matches_reference_images(case):
    for name in ("crs_hat", "pub_b_hat", "brk_d_hat", "brk_f_hat", "ksk_b", "ksk_a"):
        want = np.asarray(getattr(case["jscheme"], name))
        got = bridge.to_numpy(getattr(case["scheme"], name))
        np.testing.assert_array_equal(got.view(want.dtype), want, err_msg=name)


def test_bootstrap_matches_reference(case):
    params = case["params"]
    contracted = (params.k + 1) * params.l_uni
    assert contracted == {8: 45, 16: 204}[params.k] and contracted > MAX_PRODUCT_TERMS
    got = ccs.bootstrap(bridge.lwe(case["ct"], CPU), case["scheme"], bridge.params(params))
    _assert_same(got, j_bootstrap(case["ct"], case["jscheme"], params))
    bits = gates.lwe_decrypt_bit_mk(got, [bridge.lwe_key(k, CPU) for k in case["lwe_keys"]]).numpy()
    np.testing.assert_array_equal(bits, np.array(case["clear"]))
