"""Port parity of the LMSS gate bootstrap (mktfhe_tpu_torch/schemes/lmss.py).

`lmss.bootstrap` and `keyswitch_partial` of the port against the JAX
package on the reference's own keys and ciphertexts (bridged as numpy,
seeds of tests/test_lmss.py and tests/test_goldens.py) at TINY; tolerance 0
(bit-identical).  On CPU tensors the port's NTT wrappers run their plain
twin.  Then the port's own keygen, checked by decryption, from one
generator and from KEYGEN_STREAMS of them.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mktfhe_tpu.schemes import lmss as jlmss
from mktfhe_tpu.schemes.common import keyswitch_partial as j_keyswitch_partial
from mktfhe_tpu.schemes.gates import GATE_IDS
from mktfhe_tpu.schemes.gates import gate_affine as j_gate_affine
from mktfhe_tpu.schemes.gates import lwe_encrypt_bit as j_encrypt
from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.kernels import ntt as kntt
from mktfhe_tpu_torch.schemes import gates, lmss
from mktfhe_tpu_torch.schemes.common import NLIMB, keyswitch_partial

from test_lmss import TINY

CPU = torch.device("cpu")
TPARAMS = bridge.params(TINY)
j_bootstrap = jax.jit(jlmss.bootstrap, static_argnames=("params", "pallas_ntt", "interpret"))


@pytest.fixture(scope="module")
def keys():
    """The reference's keygen (seed of tests/test_lmss.py) and its bridged
    image."""
    lwe_key, _ring_key, jscheme = jlmss.setup(jax.random.key(11), TINY)
    return lwe_key, jscheme, bridge.lmss_scheme(jscheme, CPU)


def _gate_ct(lwe_key, m1, m2, op):
    g = len(m1)
    ct1 = j_encrypt(jax.random.key(1), jnp.array(m1), lwe_key, TINY.alpha, (g,))
    ct2 = j_encrypt(jax.random.key(2), jnp.array(m2), lwe_key, TINY.alpha, (g,))
    return j_gate_affine(op, ct1, ct2)


def _assert_same(got, want):
    np.testing.assert_array_equal(bridge.to_numpy(got.b), np.asarray(want.b))
    np.testing.assert_array_equal(bridge.to_numpy(got.a), np.asarray(want.a))


def test_bridge_drops_shoup_and_keeps_bits(keys):
    _, jscheme, scheme = keys
    assert scheme.brk_hat.dtype == torch.int32 and scheme.mono_hat.dtype == torch.int32
    np.testing.assert_array_equal(bridge.to_numpy(scheme.brk_hat), np.asarray(jscheme.brk_hat))
    np.testing.assert_array_equal(bridge.to_numpy(scheme.mono_hat), np.asarray(jscheme.mono_hat))
    assert not hasattr(scheme, "brk_shoup") and not hasattr(scheme, "mono_shoup")


def test_bootstrap_all_gates_matches_reference(keys):
    lwe_key, jscheme, scheme = keys
    ops = list(GATE_IDS)
    rng = np.random.default_rng(4)
    m1 = rng.integers(0, 2, size=len(ops)).astype(bool)
    m2 = rng.integers(0, 2, size=len(ops)).astype(bool)
    ct = _gate_ct(lwe_key, m1, m2, jnp.array([GATE_IDS[o] for o in ops], dtype=jnp.int32))
    kntt.reset_launches()
    got = lmss.bootstrap(bridge.lwe(ct, CPU), scheme, TPARAMS)
    assert kntt.fwd_ntt_nat.launches == 0  # CPU tensors: the plain twin
    assert got.b.dtype == torch.int32 and tuple(got.a.shape) == (len(ops), TINY.n)
    _assert_same(got, j_bootstrap(ct, jscheme, TINY))
    bits = gates.lwe_decrypt_bit(got, bridge.lwe_key(lwe_key, CPU)).numpy()
    clear = [gates.CLEAR_OPS[o](bool(a), bool(b)) for o, a, b in zip(ops, m1, m2)]
    np.testing.assert_array_equal(bits, np.array(clear))


def test_bootstrap_matches_the_pallas_ntt_route(keys):
    """The reference's route through its Pallas NTT kernel (interpreted),
    the one whose kernel the port's wrappers replace."""
    lwe_key, jscheme, scheme = keys
    rng = np.random.default_rng(3)
    m1 = rng.integers(0, 2, 4).astype(bool)
    m2 = rng.integers(0, 2, 4).astype(bool)
    ct = _gate_ct(lwe_key, m1, m2, 0)
    want = j_bootstrap(ct, jscheme, TINY, pallas_ntt=True, interpret=True)
    _assert_same(lmss.bootstrap(bridge.lwe(ct, CPU), scheme, TPARAMS), want)


def test_bootstrap_golden_digest():
    """The LMSS golden of tests/test_goldens.py:86-99, reproduced by the port
    from the same reference-made keys and ciphertexts."""
    lwe_key, _, jscheme = jlmss.setup(jax.random.key(21), TINY)
    m = np.array([True, False, False, True])
    ct = _gate_ct(lwe_key, m, ~m, 0)
    out = lmss.bootstrap(bridge.lwe(ct, CPU), bridge.lmss_scheme(jscheme, CPU), TPARAMS)
    h = hashlib.sha256()
    for x in (out.b, out.a):
        h.update(np.ascontiguousarray(bridge.to_numpy(x)).tobytes())
    assert h.hexdigest()[:16] == "f6f005a68d57657a", h.hexdigest()[:16]


@pytest.mark.parametrize("lead", [(5,), (2, 3)], ids=["G5", "G2x3"])
def test_keyswitch_partial_matches_reference(keys, lead):
    """Accumulators over all of 32 bits, extreme values among them."""
    _, jscheme, scheme = keys
    rng = np.random.default_rng(19)
    acc = rng.integers(0, 1 << 32, size=(*lead, TINY.k + 1, TINY.big_n), dtype=np.uint64).astype(np.uint32)
    acc.reshape(-1)[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    args = (TINY.n, jscheme.ksk_b, jscheme.ksk_a, TINY.f, TINY.log_d)
    want = jax.jit(lambda a: j_keyswitch_partial(a, *args))(jnp.asarray(acc))
    got = keyswitch_partial(bridge.from_numpy(acc, CPU), TINY.n, scheme.ksk_b, scheme.ksk_a, TINY.f, TINY.log_d)
    assert tuple(got.a.shape) == (*lead, TINY.n)
    _assert_same(got, want)


def _gate_chain(gen, lwe_key, scheme):
    """Every gate on fresh encryptions, then a chain of two more NAND
    bootstraps on the outputs: decrypted bits against the clear ones."""
    ops = list(gates.GATE_IDS)
    rng = np.random.default_rng(5)
    m1 = rng.integers(0, 2, size=len(ops)).astype(bool)
    m2 = rng.integers(0, 2, size=len(ops)).astype(bool)
    ct1 = gates.lwe_encrypt_bit(gen, torch.from_numpy(m1), lwe_key, TINY.alpha, (len(ops),))
    ct2 = gates.lwe_encrypt_bit(gen, torch.from_numpy(m2), lwe_key, TINY.alpha, (len(ops),))
    op_ids = torch.tensor([gates.GATE_IDS[o] for o in ops])
    out = gates.gate(op_ids, ct1, ct2, lambda ct: lmss.bootstrap(ct, scheme, TPARAMS))
    want = np.array([gates.CLEAR_OPS[o](bool(a), bool(b)) for o, a, b in zip(ops, m1, m2)])
    np.testing.assert_array_equal(gates.lwe_decrypt_bit(out, lwe_key).numpy(), want)
    for _ in range(2):
        out = gates.gate("NAND", out, ct2, lambda ct: lmss.bootstrap(ct, scheme, TPARAMS))
        want = ~(want & m2)
    np.testing.assert_array_equal(gates.lwe_decrypt_bit(out, lwe_key).numpy(), want)


def test_own_keygen_decrypts():
    gen = torch.Generator().manual_seed(13)
    lwe_key, ring_key, scheme = lmss.setup(gen, TPARAMS)
    npr, rows = TPARAMS.nprimes, (TINY.k * TINY.big_n - TINY.n) * TINY.f * (1 << TINY.log_d) // 2
    key = lwe_key.key.reshape(TINY.d, TINY.ell)
    assert set(key.reshape(-1).tolist()) <= {0, 1} and int(key.sum(1).max()) <= 1
    assert torch.equal(ring_key.key.reshape(-1)[: TINY.n], lwe_key.key)
    assert tuple(scheme.brk_hat.shape) == (TINY.n, 2, TINY.l_gsw, 2, npr, TINY.big_n)
    assert tuple(scheme.mono_hat.shape) == (2 * TINY.big_n, npr, TINY.big_n)
    assert tuple(scheme.ksk_a.shape) == (NLIMB, rows, TINY.n) and scheme.ksk_a.dtype == torch.int8
    _gate_chain(gen, lwe_key, scheme)


def test_own_keygen_from_streams_decrypts():
    """The stream form: one generator per top-level stream, as the CLI's
    ChaCha seeding gives them; the keys differ from the one-generator form."""
    gens = [torch.Generator().manual_seed(100 + i) for i in range(lmss.KEYGEN_STREAMS)]
    lwe_key, _, scheme = lmss.setup(gens, TPARAMS)
    with pytest.raises(ValueError):
        lmss.setup(gens[:-1], TPARAMS)
    one = lmss.setup(torch.Generator().manual_seed(100), TPARAMS)
    assert not torch.equal(one[2].brk_hat, scheme.brk_hat)
    _gate_chain(torch.Generator().manual_seed(1), lwe_key, scheme)
