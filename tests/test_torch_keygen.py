"""The port's own keygen (torch.Generator streams, CPU): samplers by
distribution, encryption by exact phase, and gates by decryption.

The port's random streams differ from the reference's jax.random streams,
so these tests check what keys made by the port do, not their bits.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.ciphertext.keys import LweKey, binary_ring_key
from mktfhe_tpu_torch.ciphertext.lwe import lwe_ith_encrypt, phase
from mktfhe_tpu_torch.ciphertext.rlwe import rlwe_sample
from mktfhe_tpu_torch.ring import sampler
from mktfhe_tpu_torch.ring.context import make_ring_ctx
from mktfhe_tpu_torch.schemes import kms
from mktfhe_tpu_torch.schemes.gates import (
    CLEAR_OPS,
    GATE_IDS,
    gate_affine,
    lwe_decrypt_bit_mk,
    lwe_ith_encrypt_bit,
)

from test_kms import TINY, TINY_BLOCK

TINY_K4 = dataclasses.replace(bridge.params(TINY), n=4, k=4)  # phase-2 depth beyond 2 parties


def test_samplers():
    gen = torch.Generator().manual_seed(0)
    u64 = sampler.uniform_torus(gen, (1 << 16,), torch.int64)
    u32 = sampler.uniform_torus(gen, (1 << 16,), torch.int32)
    for u, t in ((u64, 64), (u32, 32)):
        assert u.dtype == (torch.int64 if t == 64 else torch.int32)
        bits = bridge.to_numpy(u)
        for b in (0, t // 2 - 1, t // 2, t - 1):  # both 32-bit draws reach every bit
            frac = ((bits >> np.array(b, dtype=bits.dtype)) & 1).mean()
            assert abs(frac - 0.5) < 0.02, (t, b, frac)
    binary = sampler.uniform_binary(gen, (1 << 14,), torch.int64)
    assert set(binary.unique().tolist()) == {0, 1} and abs(binary.float().mean() - 0.5) < 0.02
    tern = sampler.uniform_ternary(gen, (1 << 14,), torch.int64)
    assert set(tern.unique().tolist()) == {-1, 0, 1}
    blocks = sampler.block_binary(gen, 2000, 3, torch.int32).reshape(2000, 3)
    assert blocks.sum(1).max() == 1 and abs((blocks.sum(1) == 0).float().mean() - 0.25) < 0.04
    e = sampler.gaussian_torus(gen, (1 << 16,), 85.4084, torch.int64).double()
    assert abs(e.std() - 85.4084) < 2 and abs(e.mean()) < 2


def test_lwe_and_rlwe_phase_exact():
    """Noise-free samples satisfy their defining equations exactly."""
    gen = torch.Generator().manual_seed(1)
    key = LweKey(key=sampler.uniform_binary(gen, (16,), torch.int32))
    m = torch.tensor([5, -7], dtype=torch.int32)
    ct = lwe_ith_encrypt(gen, m, 3, key, 0.0, shape=(2,))
    assert torch.equal(phase(ct, key), m * key.key[3])

    ctx = make_ring_ctx(64, 64, 3)
    rk = binary_ring_key(gen, 1, ctx)
    ct = rlwe_sample(gen, rk, 0.0, ctx, shape=(2,))  # [2, 2, N]; b = -s * a
    s = [int(v) for v in rk.key[0]]
    for row in bridge.to_numpy(ct):
        a = [int(v) for v in row[1]]
        # negacyclic s * a: X^i * X^(k-i+N) = -X^k for i > k
        prod = [sum((1 if i <= k else -1) * s[i] * a[(k - i) % 64] for i in range(64)) for k in range(64)]
        assert [(-x) % (1 << 64) for x in prod] == [int(v) for v in row[0]]


@pytest.mark.parametrize(
    "params", [bridge.params(TINY), bridge.params(TINY_BLOCK), TINY_K4], ids=["kms", "kms_block", "kms_k4"]
)
def test_port_keygen_gates_decrypt(params):
    gen = torch.Generator().manual_seed(300)
    a = kms.crs(gen, params)
    parties = [kms.party_keygen(gen, a, params) for _ in range(params.k)]
    keys = [p[0] for p in parties]
    scheme = kms.setup(a, [p[3] for p in parties], params)
    ops = ["NAND", "OR", "XNOR"] * 3
    rng = np.random.default_rng(13)
    m1 = rng.integers(0, 2, size=len(ops)).astype(bool)
    m2 = rng.integers(0, 2, size=len(ops)).astype(bool)
    last = params.k - 1  # the second operand from the last party: every merge engages
    ct1 = lwe_ith_encrypt_bit(gen, torch.from_numpy(m1), 0, keys[0], params.alpha, params.k, (len(ops),))
    ct2 = lwe_ith_encrypt_bit(gen, torch.from_numpy(m2), last, keys[last], params.alpha, params.k, (len(ops),))
    op_ids = torch.tensor([GATE_IDS[o] for o in ops])
    out = kms.bootstrap(gate_affine(op_ids, ct1, ct2), scheme, params)
    want = [CLEAR_OPS[o](bool(x), bool(y)) for o, x, y in zip(ops, m1, m2)]
    assert lwe_decrypt_bit_mk(out, keys).tolist() == want
