"""Port parity of the rest of `ciphertext/` and of `kernels.natural`.

LEV / GSW over plain LWE (`ciphertext/lev.py`), `unbalanced_decomp`,
`ternary_lwe_key`, `rlwe_encrypt_msg` / `rlwe_phase` and `rgsw_add` /
`rgsw_sub` of the port against the JAX package: the deterministic functions
on the same inputs (bridged as numpy), tolerance 0; the encryptions (whose
streams differ from jax.random's) by the phase of what they make, with the
bounds of tests/test_lev.py.  Then `bootstrap_nat` on the case of
tests/test_natural.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mktfhe_tpu.ciphertext import decomp as jdecomp
from mktfhe_tpu.ciphertext import gsw as jgsw
from mktfhe_tpu.ciphertext import lev as jlev
from mktfhe_tpu.ciphertext import rlwe as jrlwe
from mktfhe_tpu.ciphertext.keys import binary_lwe_key as j_binary_lwe_key
from mktfhe_tpu.ciphertext.keys import binary_ring_key as j_binary_ring_key
from mktfhe_tpu.kernels.natural import bootstrap_nat as j_bootstrap_nat
from mktfhe_tpu.ring.context import make_ring_ctx as j_make_ring_ctx
from mktfhe_tpu.schemes import cggi as jcggi
from mktfhe_tpu.schemes.gates import gate_affine as j_gate_affine
from mktfhe_tpu.schemes.gates import lwe_encrypt_bit as j_encrypt
from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.ciphertext import lev
from mktfhe_tpu_torch.ciphertext.decomp import unbalanced_decomp
from mktfhe_tpu_torch.ciphertext.gsw import (
    external_product_hat,
    rgsw_add,
    rgsw_encrypt,
    rgsw_sub,
    rgsw_to_hat,
    rlwe_decomp_hat,
)
from mktfhe_tpu_torch.ciphertext.keys import RingKey, binary_lwe_key, ternary_lwe_key
from mktfhe_tpu_torch.ciphertext.lwe import Lwe, phase
from mktfhe_tpu_torch.ciphertext.rlwe import gadget_gvec, rlwe_encrypt_msg, rlwe_phase, rlwe_sample
from mktfhe_tpu_torch.kernels.natural import bootstrap_nat
from mktfhe_tpu_torch.ring.context import make_ring_ctx
from mktfhe_tpu_torch.ring.ntt import inv_ntt
from mktfhe_tpu_torch.ring.torus import from_crt
from mktfhe_tpu_torch.schemes import cggi

from test_cggi import TINY

CPU = torch.device("cpu")
L, LOG_B = 3, 8


def _signed(x, bits=32):
    x = np.asarray(x).astype(np.int64) % (1 << bits)
    return np.where(x >= 1 << (bits - 1), x - (1 << bits), x)


@pytest.mark.parametrize("bits,l,log_b", [(32, 3, 8), (32, 4, 8), (32, 8, 2), (64, 3, 12), (64, 16, 4)])
def test_unbalanced_decomp_matches_reference(bits, l, log_b):
    dtype = np.uint32 if bits == 32 else np.uint64
    rng = np.random.default_rng(bits + l)
    a = rng.integers(0, 1 << 62, size=(4, 33), dtype=np.uint64).astype(dtype)
    a.reshape(-1)[:4] = [0, np.iinfo(dtype).max, 1 << (bits - 1), (1 << (bits - 1)) - 1]
    want = jax.jit(lambda x: jdecomp.unbalanced_decomp(x, l, log_b))(jnp.asarray(a))
    got = unbalanced_decomp(bridge.from_numpy(a, CPU), l, log_b)
    assert got.dtype == torch.int32 and tuple(got.shape) == (4, 33, l)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ternary_lwe_key():
    key = ternary_lwe_key(torch.Generator().manual_seed(3), 4096, torch.int32)
    assert key.key.dtype == torch.int32 and key.n == 4096
    assert set(key.key.tolist()) == {-1, 0, 1}


@pytest.fixture(scope="module")
def ring():
    """A reference ring key at N = 64 on the 2^32 torus and its bridged
    image."""
    jctx = j_make_ring_ctx(64, 32)
    jkey = jax.jit(lambda r: j_binary_ring_key(r, 1, jctx))(jax.random.key(0))
    key = RingKey(key=bridge.from_numpy(jkey.key, CPU), hat=bridge.from_numpy(jkey.hat, CPU))
    return jctx, jkey, make_ring_ctx(64, 32), key


def test_rlwe_phase_matches_reference(ring):
    jctx, jkey, ctx, key = ring
    ct = np.random.default_rng(5).integers(0, 1 << 32, size=(3, 2, 64), dtype=np.uint64).astype(np.uint32)
    want = jax.jit(lambda c: jrlwe.rlwe_phase(c, jkey, jctx))(jnp.asarray(ct))
    np.testing.assert_array_equal(bridge.to_numpy(rlwe_phase(bridge.from_numpy(ct, CPU), key, ctx)), np.asarray(want))


@pytest.mark.parametrize("comp", [0, 1])
def test_rlwe_encrypt_msg(ring, comp):
    """A polynomial message on a whole component, a scalar on coefficient 0:
    the sample of the same stream plus the message, and a phase near the
    message (b) or near s * message (a)."""
    jctx, jkey, ctx, key = ring
    poly = torch.arange(64, dtype=torch.int32) << 20
    for msg in (poly, torch.tensor(7 << 24, dtype=torch.int32)):
        ct = rlwe_encrypt_msg(torch.Generator().manual_seed(9), msg, comp, key, 4.0, ctx, shape=(2,))
        base = rlwe_sample(torch.Generator().manual_seed(9), key, 4.0, ctx, shape=(2,))
        diff = ct - base
        placed = torch.zeros(64, dtype=torch.int32)
        placed[: msg.numel()] = msg
        assert torch.equal(diff[:, comp], placed.expand(2, 64)) and not diff[:, 1 - comp].any()
    # the reference's rlwe_encrypt_msg, decrypted by the port's phase
    m = jnp.zeros((64,), jctx.dtype).at[0].set(jnp.uint32(1) << 29)
    jct = jax.jit(lambda r: jrlwe.rlwe_encrypt_msg(r, m, 0, jkey, 4.0, jctx))(jax.random.key(3))
    err = _signed(bridge.to_numpy(rlwe_phase(bridge.from_numpy(jct, CPU), key, ctx)) - np.asarray(m))
    assert np.abs(err).max() < 1 << 12


def _lev_err(ct: lev.Lev, key, m):
    """phase(row j) - m * g_j as signed ints."""
    gvec = gadget_gvec(L, LOG_B, torch.int32, CPU).numpy().astype(np.int64)
    return _signed(phase(Lwe(b=ct.b, a=ct.a), key).numpy().astype(np.int64) - m * gvec)


def test_lev_and_gsw_encrypt_carry_the_gadget():
    gen = torch.Generator().manual_seed(1)
    key = binary_lwe_key(gen, 32, torch.int32)
    m, i = 3 << 20, 2
    ct = lev.lev_encrypt(gen, m, key, 16.0, L, LOG_B)
    assert tuple(ct.b.shape) == (L,) and tuple(ct.a.shape) == (L, 32)
    assert np.abs(_lev_err(ct, key, m)).max() < 2000
    ct = lev.lev_ith_encrypt(gen, m, i, key, 16.0, L, LOG_B)
    assert np.abs(_lev_err(ct, key, m * int(key.key[i]))).max() < 2000
    batch = lev.lev_encrypt(gen, torch.tensor([m, -m]), key, 16.0, L, LOG_B)
    assert tuple(batch.a.shape) == (2, L, 32)
    assert np.abs(_lev_err(lev.Lev(b=batch.b[1], a=batch.a[1]), key, -m)).max() < 2000
    g = lev.gsw_encrypt(gen, m, key, 16.0, L, LOG_B)
    assert tuple(g.b.shape) == (33, L) and tuple(g.a.shape) == (33, L, 32)
    for row in range(33):
        want = m if row == 0 else m * int(key.key[row - 1])
        assert np.abs(_lev_err(lev.Lev(b=g.b[row], a=g.a[row]), key, want)).max() < 2000


def test_lev_gsw_add_sub_match_reference():
    """The reference's encryptions through the port's add / subtract: the
    same wrapped bits, and phases near m1 +- m2."""
    n = 16
    jkey = j_binary_lwe_key(jax.random.key(0), n, jnp.uint32)
    key = bridge.lwe_key(jkey, CPU)
    m1, m2 = 9 << 18, 5 << 18
    jl = [jlev.lev_encrypt(jax.random.key(s), m, jkey, 16.0, L, LOG_B) for s, m in ((1, m1), (2, m2))]
    jg = [jlev.gsw_encrypt(jax.random.key(s), m, jkey, 16.0, L, LOG_B) for s, m in ((3, m1), (4, m2))]
    tl = [lev.Lev(b=bridge.from_numpy(c.b, CPU), a=bridge.from_numpy(c.a, CPU)) for c in jl]
    tg = [lev.Gsw(b=bridge.from_numpy(c.b, CPU), a=bridge.from_numpy(c.a, CPU)) for c in jg]
    for port_op, ref_op, xs, refs, want in (
        (lev.lev_add, jlev.lev_add, tl, jl, m1 + m2), (lev.lev_sub, jlev.lev_sub, tl, jl, m1 - m2),
        (lev.gsw_add, jlev.gsw_add, tg, jg, m1 + m2), (lev.gsw_sub, jlev.gsw_sub, tg, jg, m1 - m2),
    ):
        got, ref = port_op(*xs), ref_op(*refs)
        np.testing.assert_array_equal(bridge.to_numpy(got.b), np.asarray(ref.b))
        np.testing.assert_array_equal(bridge.to_numpy(got.a), np.asarray(ref.a))
        b_row = lev.Lev(b=got.b[0], a=got.a[0]) if isinstance(got, lev.Gsw) else got
        assert np.abs(_lev_err(b_row, key, want)).max() < 4000, port_op.__name__


def test_rgsw_add_sub(ring):
    """Wrapping adds of the reference's stacks, bit for bit; the external
    product with the sum (difference) of two RGSW(1) carries 2 (0) times the
    message."""
    jctx, jkey, ctx, key = ring
    encrypt = jax.jit(lambda r: jgsw.rgsw_encrypt(r, jnp.array(1, jctx.dtype), jkey, 4.0, L, LOG_B, jctx))
    j1, j2 = encrypt(jax.random.key(1)), encrypt(jax.random.key(2))
    g1, g2 = bridge.from_numpy(j1, CPU), bridge.from_numpy(j2, CPU)
    np.testing.assert_array_equal(bridge.to_numpy(rgsw_add(g1, g2)), np.asarray(jgsw.rgsw_add(j1, j2)))
    np.testing.assert_array_equal(bridge.to_numpy(rgsw_sub(g1, g2)), np.asarray(jgsw.rgsw_sub(j1, j2)))
    gen = torch.Generator().manual_seed(4)
    own = rgsw_encrypt(gen, torch.ones((2,), dtype=torch.int32), key, 4.0, L, LOG_B, ctx)
    ct = rlwe_encrypt_msg(gen, torch.tensor(1 << 29, dtype=torch.int32), 0, key, 4.0, ctx)
    dhat = rlwe_decomp_hat(ct, L, LOG_B, ctx)
    for op, scale in ((rgsw_add, 2), (rgsw_sub, 0)):
        prod = external_product_hat(dhat, rgsw_to_hat(op(own[0], own[1]), ctx), ctx)
        e = from_crt(inv_ntt(prod.to(torch.int32), ctx.plan), ctx.crt, ctx.dtype)
        ph = rlwe_phase(e, key, ctx).numpy().astype(np.int64)
        err = _signed(ph - np.where(np.arange(64) == 0, scale << 29, 0))
        assert np.abs(err).max() < 1 << 22, op.__name__


def test_bootstrap_nat_matches_reference():
    """tests/test_natural.py's case: the reference's natural-layout engine
    (Pallas NTT interpreted) against the port's, which is cggi.bootstrap."""
    assert bootstrap_nat is cggi.bootstrap
    lwe_key, _, jscheme = jcggi.setup(jax.random.key(7), TINY)
    g = 8
    rng = np.random.default_rng(41)
    m1 = rng.integers(0, 2, g).astype(bool)
    m2 = rng.integers(0, 2, g).astype(bool)
    ct1 = j_encrypt(jax.random.key(1), jnp.array(m1), lwe_key, TINY.alpha, (g,))
    ct2 = j_encrypt(jax.random.key(2), jnp.array(m2), lwe_key, TINY.alpha, (g,))
    ct = j_gate_affine(0, ct1, ct2)
    want = j_bootstrap_nat(ct, jscheme, TINY, interpret=True)
    got = bootstrap_nat(bridge.lwe(ct, CPU), bridge.cggi_scheme(jscheme, CPU), bridge.params(TINY))
    np.testing.assert_array_equal(bridge.to_numpy(got.b), np.asarray(want.b))
    np.testing.assert_array_equal(bridge.to_numpy(got.a), np.asarray(want.a))
