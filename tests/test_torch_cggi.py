"""Port parity of the CGGI reference engine (mktfhe_tpu_torch/schemes/cggi.py).

`cggi.bootstrap` and `keyswitch_table` of the port against the JAX package
on the reference's own keys and ciphertexts (bridged as numpy, seeds of
tests/test_cggi.py) at TINY; tolerance 0 (bit-identical).  On CPU tensors the
port's NTT wrapper runs its plain twin.  The other two engines are held in
tests/test_torch_cggi_engines.py.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mktfhe_tpu.schemes import cggi as jcggi
from mktfhe_tpu.schemes.common import keyswitch_table as j_keyswitch_table
from mktfhe_tpu.schemes.gates import GATE_IDS
from mktfhe_tpu.schemes.gates import gate_affine as j_gate_affine
from mktfhe_tpu.schemes.gates import lwe_encrypt_bit as j_encrypt
from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.ciphertext.lwe import Lwe, lwe_add, lwe_neg, lwe_sub
from mktfhe_tpu_torch.schemes import cggi, gates
from mktfhe_tpu_torch.schemes.common import keyswitch_table

from test_cggi import TINY

CPU = torch.device("cpu")
TPARAMS = bridge.params(TINY)


@pytest.fixture(scope="module")
def keys():
    """The reference's keygen and its bridged image."""
    lwe_key, _ring_key, jscheme = jcggi.setup(jax.random.key(7), TINY)
    return lwe_key, jscheme, bridge.cggi_scheme(jscheme, CPU)


def _gate_ct(lwe_key, m1, m2, op):
    g = len(m1)
    ct1 = j_encrypt(jax.random.key(1), jnp.array(m1), lwe_key, TINY.alpha, (g,))
    ct2 = j_encrypt(jax.random.key(2), jnp.array(m2), lwe_key, TINY.alpha, (g,))
    return j_gate_affine(op, ct1, ct2)


def test_bridge_drops_shoup_and_keeps_bits(keys):
    _, jscheme, scheme = keys
    assert scheme.brk_hat.dtype == torch.int32 and scheme.ksk_a.dtype == torch.int8
    np.testing.assert_array_equal(bridge.to_numpy(scheme.brk_hat), np.asarray(jscheme.brk_hat))
    np.testing.assert_array_equal(scheme.ksk_b.numpy(), np.asarray(jscheme.ksk_b))
    np.testing.assert_array_equal(scheme.ksk_a.numpy(), np.asarray(jscheme.ksk_a))
    assert not hasattr(scheme, "brk_shoup")


def test_bootstrap_all_gates_matches_reference(keys):
    lwe_key, jscheme, scheme = keys
    ops = list(GATE_IDS)
    rng = np.random.default_rng(3)
    m1 = rng.integers(0, 2, size=len(ops)).astype(bool)
    m2 = rng.integers(0, 2, size=len(ops)).astype(bool)
    op_ids = jnp.array([GATE_IDS[o] for o in ops], dtype=jnp.int32)
    ct = _gate_ct(lwe_key, m1, m2, op_ids)
    want = jcggi.bootstrap(ct, jscheme, TINY)
    got = cggi.bootstrap(bridge.lwe(ct, CPU), scheme, TPARAMS)
    assert got.b.dtype == torch.int32 and tuple(got.a.shape) == (len(ops), TINY.n)
    np.testing.assert_array_equal(bridge.to_numpy(got.b), np.asarray(want.b))
    np.testing.assert_array_equal(bridge.to_numpy(got.a), np.asarray(want.a))
    bits = gates.lwe_decrypt_bit(got, bridge.lwe_key(lwe_key, CPU)).numpy()
    clear = [gates.CLEAR_OPS[o](bool(a), bool(b)) for o, a, b in zip(ops, m1, m2)]
    np.testing.assert_array_equal(bits, np.array(clear))


def test_bootstrap_golden_digest(keys):
    """The CGGI golden of tests/test_goldens.py:45-51, reproduced by the port
    from the same reference-made keys and ciphertexts."""
    lwe_key, _, scheme = keys
    m = np.array([True, False, True, True])
    out = cggi.bootstrap(bridge.lwe(_gate_ct(lwe_key, m, ~m, 0), CPU), scheme, TPARAMS)
    h = hashlib.sha256()
    for x in (out.b, out.a):
        h.update(np.ascontiguousarray(bridge.to_numpy(x)).tobytes())
    assert h.hexdigest()[:16] == "544bd48d5be989c3", h.hexdigest()[:16]


@pytest.mark.parametrize("lead", [(5,), (2, 3)], ids=["G5", "G2x3"])
def test_keyswitch_table_matches_reference(keys, lead):
    """Accumulators over all of 32 bits, extreme values among them."""
    _, jscheme, scheme = keys
    rng = np.random.default_rng(17)
    acc = rng.integers(0, 1 << 32, size=(*lead, TINY.k + 1, TINY.big_n), dtype=np.uint64).astype(np.uint32)
    acc.reshape(-1)[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    want = jax.jit(lambda a: j_keyswitch_table(a, jscheme.ksk_b, jscheme.ksk_a, TINY.f, TINY.log_d))(jnp.asarray(acc))
    got = keyswitch_table(bridge.from_numpy(acc, CPU), scheme.ksk_b, scheme.ksk_a, TINY.f, TINY.log_d)
    assert tuple(got.a.shape) == (*lead, TINY.n)
    np.testing.assert_array_equal(bridge.to_numpy(got.b), np.asarray(want.b))
    np.testing.assert_array_equal(bridge.to_numpy(got.a), np.asarray(want.a))


def test_lwe_linear_ops_wrap():
    x = Lwe(b=torch.tensor([2**31 - 1, -5], dtype=torch.int32), a=torch.tensor([[1, -(2**31)], [7, 9]], dtype=torch.int32))
    y = Lwe(b=torch.tensor([1, 6], dtype=torch.int32), a=torch.tensor([[3, -1], [-7, 2**31 - 1]], dtype=torch.int32))
    s, d, n = lwe_add(x, y), lwe_sub(x, y), lwe_neg(x)
    assert s.b.tolist() == [-(2**31), 1] and s.a.tolist() == [[4, 2**31 - 1], [0, -(2**31) + 8]]
    assert d.b.tolist() == [2**31 - 2, -11] and d.a.tolist() == [[-2, -(2**31) + 1], [14, -(2**31) + 10]]
    assert n.b.tolist() == [-(2**31) + 1, 5] and n.a.tolist() == [[-1, -(2**31)], [-7, -9]]
    back = lwe_sub(lwe_add(x, y), y)
    assert torch.equal(back.b, x.b) and torch.equal(back.a, x.a)
