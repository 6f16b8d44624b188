"""Port parity, ciphertext layer and key switch: mktfhe_tpu_torch vs mktfhe_tpu.

Same numpy inputs (or the reference's own keys, bridged) through the JAX
function and its port; tolerance 0 (bit-identical).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mktfhe_tpu.ciphertext import gsw as jgsw
from mktfhe_tpu.ciphertext.lwe import phase as j_phase
from mktfhe_tpu.ring.context import make_ring_ctx as j_make_ctx
from mktfhe_tpu.schemes import common as jcommon
from mktfhe_tpu.schemes import gates as jgates
from mktfhe_tpu.schemes import kms as jkms
from mktfhe_tpu.schemes.params import KmsBlockParams as JKmsBlockParams
from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.ciphertext import gsw
from mktfhe_tpu_torch.ciphertext.lwe import phase
from mktfhe_tpu_torch.ring.context import make_ring_ctx
from mktfhe_tpu_torch.ring.modring import PRIMES
from mktfhe_tpu_torch.schemes import common, gates, kms

from test_kms import TINY, TINY_BLOCK

CPU = torch.device("cpu")


def _t(x):
    return bridge.from_numpy(x, CPU)


def _np(t):
    return bridge.to_numpy(t)


def test_rgsw_to_hat_and_external_product():
    rng = np.random.default_rng(11)
    n, npr, l = 64, 4, 3
    jctx = j_make_ctx(n, 64, npr)
    ctx = make_ring_ctx(n, 64, npr)
    stack = rng.integers(0, 1 << 64, size=(2, l, 2, n), dtype=np.uint64)
    jhat, jhat_sh = jax.jit(lambda x: jgsw.rgsw_to_hat(x, jctx))(jnp.array(stack))
    hat = gsw.rgsw_to_hat(_t(stack), ctx)
    np.testing.assert_array_equal(_np(hat), np.asarray(jhat))

    p = np.array(PRIMES[:npr], dtype=np.int64)[:, None]
    dhat = rng.integers(0, p, size=(5, 3, 2, l, npr, n)).astype(np.uint32)
    want = jax.jit(lambda d: jgsw.external_product_hat(d, jhat, jhat_sh, jctx))(jnp.array(dhat))
    got = gsw.external_product_hat(_t(dhat), hat, ctx)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), np.asarray(want))


def test_build_ksk_layout():
    """The random masks differ between the two packages, so hold the
    layouts: with zero noise every row of both tables decrypts (limbs
    recombined, then b + <a, s>) to the same message table."""
    rng = np.random.default_rng(12)
    n, f, log_d = 8, 8, 2
    key_np = rng.integers(0, 2, size=n).astype(np.uint32)
    coeffs = rng.integers(0, 1 << 32, size=5, dtype=np.uint64).astype(np.uint32)
    jb, ja = jcommon.build_ksk(
        jax.random.key(1), jnp.array(coeffs), SimpleNamespace(key=jnp.array(key_np), n=n), f, log_d, 0.0
    )
    key = bridge.lwe_key(SimpleNamespace(key=key_np), CPU)
    tb, ta = common.build_ksk(torch.Generator().manual_seed(1), _t(coeffs), key, f, log_d, 0.0)

    def decrypt(b, a):
        w = (np.uint64(1) << (8 * np.arange(4, dtype=np.uint64)))
        bv = (b.astype(np.int64).astype(np.uint64) * w[:, None]).sum(0)
        av = (a.astype(np.int64).astype(np.uint64) * w[:, None, None]).sum(0)
        return (bv + (av * key_np.astype(np.uint64)).sum(-1)).astype(np.uint32)

    assert tb.shape == tuple(jb.shape) and ta.shape == tuple(ja.shape)
    assert tb.dtype == torch.int8 and ta.dtype == torch.int8
    want = decrypt(np.asarray(jb), np.asarray(ja))
    np.testing.assert_array_equal(decrypt(tb.numpy(), ta.numpy()), want)
    msgs = (coeffs.astype(np.uint64)[:, None, None] * (np.uint64(1) << (32 - 2 * np.arange(1, 9, dtype=np.uint64)))[None, :, None]
            * np.arange(1, 3, dtype=np.uint64)).astype(np.uint32)
    np.testing.assert_array_equal(want, msgs.reshape(-1))


@pytest.fixture(scope="module", params=[TINY, TINY_BLOCK], ids=["kms", "kms_block"])
def reference(request):
    """The reference's keys at a tiny preset, and the port's params."""
    params = request.param
    a = jkms.crs(jax.random.key(300), params)
    parties = [jkms.party_keygen(jax.random.key(400 + i), a, params) for i in range(params.k)]
    ksk = SimpleNamespace(
        ksk_b=jnp.stack([p[3].ksk_b for p in parties]), ksk_a=jnp.stack([p[3].ksk_a for p in parties])
    )
    return params, bridge.params(params), parties, ksk


def test_keyswitch_matches_reference(reference):
    """kms._keyswitch (64 -> 32 bit switch, per-party key switch; block:
    free head segment) on random accumulators, including the non-block
    path's keyswitch_per_party."""
    params, tparams, parties, ksk = reference
    rng = np.random.default_rng(13)
    acc = rng.integers(0, 1 << 64, size=(3, params.k + 1, params.big_n), dtype=np.uint64)
    acc.flat[:2] = [1 << 63, (1 << 64) - 1]
    want = jkms._keyswitch(jnp.array(acc), ksk, params)
    tksk = SimpleNamespace(ksk_b=_t(np.asarray(ksk.ksk_b)), ksk_a=_t(np.asarray(ksk.ksk_a)))
    got = kms._keyswitch(_t(acc), tksk, tparams)
    np.testing.assert_array_equal(_np(got.b), np.asarray(want.b))
    np.testing.assert_array_equal(_np(got.a), np.asarray(want.a))
    if isinstance(params, JKmsBlockParams):
        return
    acc32 = (acc >> np.uint64(32)).astype(np.uint32)
    want = jcommon.keyswitch_per_party(jnp.array(acc32), ksk.ksk_b, ksk.ksk_a, params.f, params.log_d)
    got = common.keyswitch_per_party(_t(acc32), tksk.ksk_b, tksk.ksk_a, params.f, params.log_d)
    np.testing.assert_array_equal(_np(got.b), np.asarray(want.b))
    np.testing.assert_array_equal(_np(got.a), np.asarray(want.a))


def test_gate_layer_matches_reference(reference):
    """mod_switch_2n, initial_acc, gate_affine, phase and the multi-key
    decrypt on the reference's ciphertexts."""
    params, tparams, parties, _ = reference
    g = 6
    rng = np.random.default_rng(14)
    m1 = rng.integers(0, 2, size=g).astype(bool)
    m2 = rng.integers(0, 2, size=g).astype(bool)
    ct1 = jgates.lwe_ith_encrypt_bit(jax.random.key(1), jnp.array(m1), 0, parties[0][0], params.alpha, params.k, (g,))
    ct2 = jgates.lwe_ith_encrypt_bit(jax.random.key(2), jnp.array(m2), 1, parties[1][0], params.alpha, params.k, (g,))
    ops = np.arange(g, dtype=np.int32)
    jct = jgates.gate_affine(jnp.array(ops), ct1, ct2)
    ct = gates.gate_affine(torch.from_numpy(ops), bridge.lwe(ct1, CPU), bridge.lwe(ct2, CPU))
    np.testing.assert_array_equal(_np(ct.b), np.asarray(jct.b))
    np.testing.assert_array_equal(_np(ct.a), np.asarray(jct.a))

    jtb, jta = jcommon.mod_switch_2n(jct, params.big_n)
    tb, ta = common.mod_switch_2n(ct, params.big_n)
    np.testing.assert_array_equal(_np(tb), np.asarray(jtb))
    np.testing.assert_array_equal(_np(ta), np.asarray(jta))
    jacc = jcommon.initial_acc(jtb, params.big_n, params.k, jnp.uint64)
    acc = common.initial_acc(tb, params.big_n, params.k, torch.int64)
    np.testing.assert_array_equal(_np(acc), np.asarray(jacc))

    keys = [bridge.lwe_key(p[0], CPU) for p in parties]
    np.testing.assert_array_equal(
        gates.lwe_decrypt_bit_mk(ct, keys).numpy(), np.asarray(jgates.lwe_decrypt_bit_mk(jct, [p[0] for p in parties]))
    )
    n = params.n
    seg = type(ct)(b=ct.b, a=ct.a[:, :n].contiguous())
    jseg = type(jct)(b=jct.b, a=jct.a[:, :n])
    np.testing.assert_array_equal(_np(phase(seg, keys[0])), np.asarray(j_phase(jseg, parties[0][0])))


def test_encode_matches_reference():
    m = np.array([0, 1, 1, 0], dtype=bool)
    for jd, td in [(jnp.uint32, torch.int32), (jnp.uint64, torch.int64)]:
        np.testing.assert_array_equal(
            _np(gates.encode(torch.from_numpy(m), td)), np.asarray(jgates.encode(jnp.array(m), jd))
        )
