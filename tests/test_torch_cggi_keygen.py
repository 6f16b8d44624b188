"""The port's own CGGI keygen (torch.Generator streams, which differ from the
reference's jax.random streams): checked by decryption of every gate through
all three engines, which must also agree bit for bit, and by the shapes and
types of the keys it makes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mktfhe_tpu_torch.kernels import batchminor, fused_step
from mktfhe_tpu_torch.schemes import cggi, gates
from mktfhe_tpu_torch.schemes.common import NLIMB
from mktfhe_tpu_torch.schemes.presets import TINY_CGGI as TINY

ENGINES = {
    "cggi.bootstrap": lambda ct, scheme, bm: cggi.bootstrap(ct, scheme, TINY),
    "bootstrap_bm": lambda ct, scheme, bm: batchminor.bootstrap_bm(ct, bm, TINY),
    "bootstrap_fused": lambda ct, scheme, bm: fused_step.bootstrap_fused(ct, bm, TINY),
}


@pytest.fixture(scope="module")
def keys():
    gen = torch.Generator().manual_seed(7)
    lwe_key, ring_key, scheme = cggi.setup(gen, TINY)
    return gen, lwe_key, ring_key, scheme, batchminor.convert_scheme(scheme, TINY)


def test_setup_shapes_and_types(keys):
    _, lwe_key, ring_key, scheme, bm = keys
    npr, rows = TINY.nprimes, TINY.k * TINY.big_n * TINY.f * (1 << TINY.log_d) // 2
    assert lwe_key.key.dtype == torch.int32 and set(lwe_key.key.tolist()) <= {0, 1}
    assert tuple(ring_key.key.shape) == (TINY.k, TINY.big_n) and ring_key.key.dtype == torch.int32
    assert tuple(scheme.brk_hat.shape) == (TINY.n, 2, TINY.l_gsw, 2, npr, TINY.big_n)
    assert scheme.brk_hat.dtype == torch.int32 and int(scheme.brk_hat.min()) >= 0
    assert tuple(scheme.ksk_b.shape) == (NLIMB, rows) and scheme.ksk_b.dtype == torch.int8
    assert tuple(scheme.ksk_a.shape) == (NLIMB, rows, TINY.n) and scheme.ksk_a.dtype == torch.int8
    assert tuple(bm.brk_bm.shape) == (TINY.n, npr, 2 * TINY.l_gsw, 2, TINY.big_n) and bm.brk_bm.is_contiguous()
    assert tuple(bm.mono_hat.shape) == (2 * TINY.big_n, npr, TINY.big_n)
    assert not hasattr(scheme, "brk_shoup")


@pytest.mark.parametrize("engine", list(ENGINES))
def test_all_gates_decrypt(keys, engine):
    gen, lwe_key, _, scheme, bm = keys
    ops = list(gates.GATE_IDS) * 2
    rng = np.random.default_rng(3)
    m1 = rng.integers(0, 2, size=len(ops)).astype(bool)
    m2 = rng.integers(0, 2, size=len(ops)).astype(bool)
    ct1 = gates.lwe_encrypt_bit(gen, torch.from_numpy(m1), lwe_key, TINY.alpha, (len(ops),))
    ct2 = gates.lwe_encrypt_bit(gen, torch.from_numpy(m2), lwe_key, TINY.alpha, (len(ops),))
    np.testing.assert_array_equal(gates.lwe_decrypt_bit(ct1, lwe_key).numpy(), m1)
    op_ids = torch.tensor([gates.GATE_IDS[o] for o in ops])
    out = gates.gate(op_ids, ct1, ct2, lambda ct: ENGINES[engine](ct, scheme, bm))
    want = np.array([gates.CLEAR_OPS[o](bool(a), bool(b)) for o, a, b in zip(ops, m1, m2)])
    np.testing.assert_array_equal(gates.lwe_decrypt_bit(out, lwe_key).numpy(), want)
    ref = cggi.bootstrap(gates.gate_affine(op_ids, ct1, ct2), scheme, TINY)
    assert torch.equal(out.b, ref.b) and torch.equal(out.a, ref.a)


def test_gate_chain_and_not(keys):
    """Bootstrapped outputs through further gates by name (noise refresh),
    and NOT without a bootstrap."""
    gen, lwe_key, _, scheme, bm = keys
    rng = np.random.default_rng(5)
    m = rng.integers(0, 2, size=(4, 4)).astype(bool)
    cts = [gates.lwe_encrypt_bit(gen, torch.from_numpy(m[i]), lwe_key, TINY.alpha, (4,)) for i in range(4)]
    res, mres = cts[0], m[0]
    for i, op in enumerate(["NAND", "XOR", "OR"], start=1):
        res = gates.gate(op, res, cts[i], lambda ct: fused_step.bootstrap_fused(ct, bm, TINY))
        mres = np.array([gates.CLEAR_OPS[op](bool(x), bool(y)) for x, y in zip(mres, m[i])])
    np.testing.assert_array_equal(gates.lwe_decrypt_bit(res, lwe_key).numpy(), mres)
    np.testing.assert_array_equal(gates.lwe_decrypt_bit(gates.not_gate(res), lwe_key).numpy(), ~mres)


def test_convert_scheme_refuses_a_short_crt_range(keys):
    """The monomial-weighted product needs twice the range of the roll: at
    N = 512 with two 16-bit digits the roll fits two primes, the table not."""
    _, _, _, scheme, _ = keys
    wide = dataclasses.replace(TINY, big_n=512, l_gsw=2, log_b_gsw=16)
    assert wide.nprimes == 2
    with pytest.raises(ValueError):
        batchminor.convert_scheme(scheme, wide)
