"""Port parity of the CCS gate bootstrap (mktfhe_tpu_torch/schemes/ccs.py).

`ccs.bootstrap` of the port against the JAX package on the reference's own
party keys and ciphertexts (bridged as numpy; the port's `setup` builds its
scheme from them), seeds of tests/test_ccs.py and tests/test_goldens.py:
TINY (k = 2), TINY4 (k = 4), and a set whose relinearisation contracts
(k+1) * l_uni = 18 > 16 digit products; tolerance 0 (bit-identical).  On
CPU tensors the port's NTT wrappers run their plain twin.  Then the port's
own keygen, checked by decryption.
"""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mktfhe_tpu.schemes import ccs as jccs
from mktfhe_tpu.schemes.gates import GATE_IDS
from mktfhe_tpu.schemes.gates import gate_affine as j_gate_affine
from mktfhe_tpu.schemes.gates import lwe_ith_encrypt_bit as j_encrypt
from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.ring.modring import MAX_PRODUCT_TERMS
from mktfhe_tpu_torch.schemes import ccs, gates
from mktfhe_tpu_torch.schemes.common import NLIMB

from test_ccs import TINY, TINY4

CPU = torch.device("cpu")
# TINY with CCS2partyTight's gadget: the w contraction has 3 * 6 = 18 terms
WIDE = dataclasses.replace(TINY, l_uni=6, log_b_uni=4)
j_bootstrap = jax.jit(jccs.bootstrap, static_argnames=("params", "pallas_ntt", "interpret"))


def _reference_keys(params, crs_seed, party_seed):
    a = jccs.crs(jax.random.key(crs_seed), params)
    parties = [jccs.party_keygen(jax.random.key(party_seed + i), a, params) for i in range(params.k)]
    jscheme = jccs.setup(a, [p[2] for p in parties], params)
    scheme = ccs.setup(bridge.from_numpy(a, CPU), [bridge.ccs_party_key(p[2], CPU) for p in parties],
                       bridge.params(params))
    return [p[0] for p in parties], jscheme, scheme


def _gate_ct(params, lwe_keys, m1, m2, op):
    g = len(m1)
    ct1 = j_encrypt(jax.random.key(1), jnp.array(m1), 0, lwe_keys[0], params.alpha, params.k, (g,))
    ct2 = j_encrypt(jax.random.key(2), jnp.array(m2), 1, lwe_keys[1], params.alpha, params.k, (g,))
    return j_gate_affine(op, ct1, ct2)


def _assert_same(got, want):
    np.testing.assert_array_equal(bridge.to_numpy(got.b), np.asarray(want.b))
    np.testing.assert_array_equal(bridge.to_numpy(got.a), np.asarray(want.a))


def test_setup_matches_reference_images():
    """The port's setup on bridged party keys gives the reference's images
    (without Shoup companions)."""
    _, jscheme, scheme = _reference_keys(TINY, 100, 200)
    for name in ("crs_hat", "pub_b_hat", "brk_d_hat", "brk_f_hat"):
        np.testing.assert_array_equal(bridge.to_numpy(getattr(scheme, name)), np.asarray(getattr(jscheme, name)))
    np.testing.assert_array_equal(scheme.ksk_a.numpy(), np.asarray(jscheme.ksk_a))
    assert not hasattr(scheme, "brk_d_shoup")


@pytest.mark.parametrize("params,seeds", [(TINY, (100, 200)), (TINY4, (500, 600)), (WIDE, (100, 200))],
                         ids=["TINY", "TINY4", "WIDE"])
def test_bootstrap_matches_reference(params, seeds):
    """Four gates of party 0's and party 1's bits: the port's bits equal the
    reference's and decrypt to the clear gates."""
    assert params is not WIDE or (WIDE.k + 1) * WIDE.l_uni > MAX_PRODUCT_TERMS
    lwe_keys, jscheme, scheme = _reference_keys(params, *seeds)
    ops = ["NAND", "AND", "OR", "XOR"]
    rng = np.random.default_rng(9)
    m1 = rng.integers(0, 2, size=len(ops)).astype(bool)
    m2 = rng.integers(0, 2, size=len(ops)).astype(bool)
    ct = _gate_ct(params, lwe_keys, m1, m2, jnp.array([GATE_IDS[o] for o in ops], dtype=jnp.int32))
    got = ccs.bootstrap(bridge.lwe(ct, CPU), scheme, bridge.params(params))
    assert got.b.dtype == torch.int32 and tuple(got.a.shape) == (len(ops), params.k * params.n)
    _assert_same(got, j_bootstrap(ct, jscheme, params))
    bits = gates.lwe_decrypt_bit_mk(got, [bridge.lwe_key(k, CPU) for k in lwe_keys]).numpy()
    clear = [gates.CLEAR_OPS[o](bool(a), bool(b)) for o, a, b in zip(ops, m1, m2)]
    np.testing.assert_array_equal(bits, np.array(clear))


def test_bootstrap_golden_digest():
    """The CCS golden of tests/test_goldens.py:102-126, reproduced by the port
    from the same reference-made keys and ciphertexts."""
    lwe_keys, _, scheme = _reference_keys(TINY, 500, 600)
    m = np.array([True, True, False, False])
    out = ccs.bootstrap(bridge.lwe(_gate_ct(TINY, lwe_keys, m, ~m, 0), CPU), scheme, bridge.params(TINY))
    h = hashlib.sha256()
    for x in (out.b, out.a):
        h.update(np.ascontiguousarray(bridge.to_numpy(x)).tobytes())
    assert h.hexdigest()[:16] == "3279edf828ae6b40", h.hexdigest()[:16]


@pytest.mark.parametrize("params", [TINY, TINY4], ids=["TINY", "TINY4"])
def test_own_keygen_decrypts(params):
    """Every party's bit in a chain of NANDs, k - 1 bootstraps deep (the
    growing mask), from the port's own keys."""
    tparams = bridge.params(params)
    gen = torch.Generator().manual_seed(31)
    a = ccs.crs(gen, tparams)
    parties = [ccs.party_keygen(gen, a, tparams) for _ in range(params.k)]
    lwe_keys = [p[0] for p in parties]
    pk = parties[0][2]
    rows = params.big_n * params.f * (1 << params.log_d) // 2
    assert tuple(pk.brk_d.shape) == (params.n, params.l_uni, params.big_n)
    assert tuple(pk.brk_f.shape) == (params.n, params.l_uni, 2, params.big_n)
    assert tuple(pk.ksk_a.shape) == (NLIMB, rows, params.n) and pk.ksk_a.dtype == torch.int8
    scheme = ccs.setup(a, [p[2] for p in parties], tparams)
    rng = np.random.default_rng(11)
    g = 4
    ms = rng.integers(0, 2, size=(params.k, g)).astype(bool)
    cts = [gates.lwe_ith_encrypt_bit(gen, torch.from_numpy(ms[i]), i, lwe_keys[i], params.alpha, params.k, (g,))
           for i in range(params.k)]
    res, want = cts[0], ms[0]
    for i in range(1, params.k):
        res = gates.gate("NAND", res, cts[i], lambda ct: ccs.bootstrap(ct, scheme, tparams))
        want = ~(want & ms[i])
    np.testing.assert_array_equal(gates.lwe_decrypt_bit_mk(res, lwe_keys).numpy(), want)
