"""The plain reference against the package under test on the CPU: the same
keys and inputs give the same output words, at tiny block-binary and binary
sets and at the KMS32 presets' gadget; decryption catches a flipped output
bit; the float64 control does not reproduce the words."""

import dataclasses

import pytest
import torch

from benchmark.adapters import kms as ad
from benchmark.reference import kms as ref
from mktfhe_tpu_torch.kernels import fused_mx3

from conftest import TINY_BLOCK

SEED = 2**33 + 5
BINARY = dict(n=8, alpha=16.0, f=8, log_d=2, big_n=128, beta=4.0, l_gsw=3, log_b_gsw=8, l_lev=2, log_b_lev=8,
              l_uni=3, log_b_uni=8, k=2)
KMS32_GADGET = dict(TINY_BLOCK, d=2, l_gsw=6, log_b_gsw=7, l_lev=3, log_b_lev=7, l_uni=16, log_b_uni=2, k=3)


def _case(p: dict, gates: int = 6):
    params = ref.KmsSet.from_config(p)
    port = ad.params({"name": "test", "params": p})
    dev = torch.device("cpu")
    ring = ref.ExactRing(params.big_n, dev)
    crs = ref.crs(params, SEED, dev)
    secrets = [ref.party_secrets(params, SEED, i, dev) for i in range(params.k)]
    keys = [ad.party_key(ref.party_keys(params, SEED, i, crs, ring)) for i in range(params.k)]
    scheme = ad.setup(crs, keys, port)
    gen = ref.generator(dev, SEED, "test")
    bits = ref.binary(gen, (2, gates))
    party = torch.arange(2 * gates).reshape(2, gates) % params.k
    b, a = ref.encrypt_bits(gen, bits, party, secrets, params.alpha)
    op = torch.arange(gates) % len(ref.GATE_NAMES)
    bb, aa = ref.gate_affine(op, b[0], a[0], b[1], a[1])
    ct = ad.affine(op, ad.lwe(b[0], a[0]), ad.lwe(b[1], a[1]))
    assert torch.equal(ct.b, bb) and torch.equal(ct.a, aa)
    out = fused_mx3.bootstrap_mx3(ct, scheme, port)
    return params, crs, secrets, bits, op, (bb, aa), out


@pytest.mark.parametrize("p", [TINY_BLOCK, BINARY, KMS32_GADGET], ids=["block", "binary", "kms32-gadget"])
def test_reference_equals_the_package(p):
    params, crs, secrets, bits, op, (bb, aa), out = _case(p)
    ring = ref.ExactRing(params.big_n, bb.device)
    rb, ra = ref.bootstrap(ring, params, bb, aa, SEED, crs, party_chunk=2)
    assert torch.equal(rb, out.b) and torch.equal(ra, out.a)
    clear = ref.clear_gate(op, bits[0], bits[1])
    assert torch.equal(ref.decrypt(rb, ra, secrets), clear)


def test_decryption_catches_a_flipped_bit():
    params, crs, secrets, bits, op, _, out = _case(TINY_BLOCK)
    clear = ref.clear_gate(op, bits[0], bits[1])
    b, a = out.b.clone(), out.a.clone()
    b[2], a[2] = -b[2], -a[2]
    got = ref.decrypt(b, a, secrets)
    assert (got != clear).sum() == 1 and got[2] != clear[2]


def test_float64_control_differs():
    params, crs, secrets, bits, op, (bb, aa), out = _case(TINY_BLOCK)
    fb, fa = ref.bootstrap(ref.F64Ring(params.big_n, bb.device), params, bb, aa, SEED, crs)
    assert (fb != out.b).sum() + (fa != out.a).sum() > 0


def test_ring_products_are_exact():
    dev = torch.device("cpu")
    ring = ref.ExactRing(64, dev)
    gen = ref.generator(dev, SEED, "ring")
    x = torch.randint(-128, 128, (3, 64), generator=gen)
    y = ref.uniform64(gen, (3, 64))
    got = ring.inv(ring.mul(ring.fwd(x), ring.fwd(y)))
    want = torch.zeros_like(y)
    for i in range(64):  # schoolbook, negacyclic, wrapping int64
        want += x[:, i:i + 1] * ref.negacyclic_roll(y, torch.tensor(i))
    assert torch.equal(got, want)


def test_ksk_limbs_round_trip():
    v = torch.tensor([0, 1, -1, 127, 128, -129, 2**31 - 1, -(2**31)], dtype=torch.int32)
    limbs = ref.to_limbs(v).long()
    back = sum(limbs[..., j] << (8 * j) for j in range(4))
    assert torch.equal(ref.wrap32(back), v)
