"""Port parity, ring layer: mktfhe_tpu_torch.ring vs mktfhe_tpu.ring.

Same numpy inputs through the JAX function and its port; tolerance 0 (the
arithmetic is exact integer CRT-NTT, so outputs must be bit-identical).
Inputs include torus values >= 2^31 / >= 2^63, where the port's signed
carriers differ from the reference's unsigned types.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mktfhe_tpu import ring as jring
from mktfhe_tpu.ciphertext.decomp import balanced_decomp as j_balanced_decomp
from mktfhe_tpu.kernels.ntt_pallas import fwd_ntt_nat as j_fwd_nat
from mktfhe_tpu.kernels.ntt_pallas import inv_ntt_nat as j_inv_nat
from mktfhe_tpu.ring.torus import negacyclic_roll as j_roll
from mktfhe_tpu_torch.bridge import from_numpy, to_numpy
from mktfhe_tpu_torch.ciphertext.decomp import balanced_decomp
from mktfhe_tpu_torch.kernels import ntt as kntt
from mktfhe_tpu_torch.ring import modring, ntt, torus

CPU = torch.device("cpu")


def _u32(rng, shape):
    x = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
    x.flat[:4] = [0, 1 << 31, (1 << 32) - 1, (1 << 31) - 1]
    return x


def _u64(rng, shape):
    x = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
    x.flat[:4] = [0, 1 << 63, (1 << 64) - 1, (1 << 63) - 1]
    return x


def _residues(rng, npr, shape):
    """Residues < p_i, uint32 [*shape[:-1], npr, shape[-1]]."""
    p = np.array(modring.PRIMES[:npr], dtype=np.int64)[:, None]
    return rng.integers(0, p, size=(*shape[:-1], npr, shape[-1])).astype(np.uint32)


def _t(x):
    return from_numpy(x, CPU)


@pytest.mark.parametrize("p", modring.PRIMES)
def test_modring_ops(p):
    rng = np.random.default_rng(p)
    w = rng.integers(0, p, size=2048, dtype=np.uint64).astype(np.uint32)
    a = rng.integers(0, p, size=2048, dtype=np.uint64).astype(np.uint32)
    x = _u32(rng, 2048)
    w_sh = np.array([modring.shoup(int(v), p) for v in w], dtype=np.uint32)
    assert [modring.shoup(int(v), p) for v in w[:8]] == [jring.shoup(int(v), p) for v in w[:8]]

    def i64(v):
        return torch.from_numpy(v.astype(np.int64))

    # shoup_mul takes any a < 2^32
    got = modring.shoup_mul(i64(w), i64(w_sh), i64(x), p)
    want = jring.shoup_mul(jnp.array(w), jnp.array(w_sh), jnp.array(x), p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        modring.mulhi_u32(i64(x), i64(w_sh)).numpy(),
        np.asarray(jring.mulhi_u32(jnp.array(x), jnp.array(w_sh))),
    )
    crt = jring.make_crt_plan(4)
    q = modring.PRIMES.index(p)
    want = jring.modring.mulmod_runtime(
        jnp.array(w), jnp.array(a), p, crt.c32[q], crt.c32_shoup[q]
    )
    np.testing.assert_array_equal(modring.mulmod_runtime(_t(w), _t(a), p).numpy(), np.asarray(want))
    for port_fn, jax_fn in [(modring.addmod, jring.addmod), (modring.submod, jring.submod)]:
        got = port_fn(i64(w), i64(a), p)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_fn(jnp.array(w), jnp.array(a), p)))
    np.testing.assert_array_equal(
        modring.negmod(i64(w), p).numpy(), np.asarray(jring.negmod(jnp.array(w), p))
    )
    np.testing.assert_array_equal(
        modring.reduce_u32(_t(x), p).numpy(), np.asarray(jring.reduce_u32(jnp.array(x), p))
    )
    for n in [1, 3, 16, 17]:
        s = rng.integers(0, p, size=(n, 8), dtype=np.uint64).astype(np.uint32)
        np.testing.assert_array_equal(
            modring.modsum(_t(s), 0, p).numpy(), np.asarray(jring.modsum(jnp.array(s), 0, p))
        )


def test_mulsum_mod_bound():
    """16 products of residues are summed before one reduction; 17 raise."""
    p = modring.PRIMES[0]
    x = torch.full((16, 4), p - 1, dtype=torch.int64)
    assert modring.mulsum_mod(x, x, 0, p).tolist() == [16 * (p - 1) ** 2 % p] * 4
    with pytest.raises(ValueError):
        modring.mulsum_mod(torch.cat([x, x[:1]]), torch.cat([x, x[:1]]), 0, p)


@pytest.mark.parametrize("npr", [2, 3, 4])
def test_lift_and_garner(npr):
    rng = np.random.default_rng(npr)
    jcrt, crt = jring.make_crt_plan(npr), torus.make_crt_plan(npr)
    x32, x64 = _u32(rng, (3, 64)), _u64(rng, (3, 64))
    np.testing.assert_array_equal(
        to_numpy(torus.lift(_t(x32), crt)), np.asarray(jring.lift_u32(jnp.array(x32), jcrt))
    )
    np.testing.assert_array_equal(
        to_numpy(torus.lift(_t(x64), crt)), np.asarray(jring.lift_u64(jnp.array(x64), jcrt))
    )
    d = rng.integers(-(1 << 20), 1 << 20, size=(3, 64), dtype=np.int32)
    np.testing.assert_array_equal(
        to_numpy(torus.lift(torch.from_numpy(d), crt)),
        np.asarray(jring.lift_signed_small(jnp.array(d), jcrt)),
    )
    r = _residues(rng, npr, (5, 64))
    np.testing.assert_array_equal(
        to_numpy(torus.from_crt_u32(_t(r), crt)), np.asarray(jring.from_crt_u32(jnp.array(r), jcrt))
    )
    np.testing.assert_array_equal(
        to_numpy(torus.from_crt_u64(_t(r), crt)), np.asarray(jring.from_crt_u64(jnp.array(r), jcrt))
    )


def test_divbits_and_decomp():
    """Both widths; gadgets include l*logB == T (no rounding shift, so the
    carry chain sees full-width values)."""
    rng = np.random.default_rng(5)
    gadgets = {32: [(3, 8), (8, 2), (8, 4)], 64: [(4, 9), (3, 6), (8, 4), (16, 4)]}
    for x in (_u32(rng, 4096), _u64(rng, 4096)):
        t = x.dtype.itemsize * 8
        for bit in [1, 5, t - 12, t - 1]:
            np.testing.assert_array_equal(
                to_numpy(torus.divbits(_t(x), bit)), np.asarray(jring.divbits(jnp.array(x), bit))
            )
        for l, log_b in gadgets[t]:
            want = jax.jit(lambda v: j_balanced_decomp(v, l, log_b))(jnp.array(x))
            np.testing.assert_array_equal(balanced_decomp(_t(x), l, log_b).numpy(), np.asarray(want))


def test_negacyclic_roll():
    rng = np.random.default_rng(6)
    v = _u64(rng, (5, 64))
    shifts = np.array([0, 1, 63, 64, 127])
    got = torus.negacyclic_roll(_t(v), torch.from_numpy(shifts))
    want = np.stack([np.asarray(j_roll(jnp.array(v[i]), int(s))) for i, s in enumerate(shifts)])
    np.testing.assert_array_equal(to_numpy(got), want)


@pytest.mark.parametrize("n", [64, 2048])
@pytest.mark.parametrize("npr", [2, 3, 4])
def test_ntt_matches_reference(n, npr):
    rng = np.random.default_rng(n + npr)
    a = _residues(rng, npr, (3, n))
    jplan, plan = jring.make_plan(n, npr), ntt.make_plan(n, npr)
    for field in ("psi_brv", "psi_brv_shoup", "ipsi_brv", "ipsi_brv_shoup", "n_inv", "n_inv_shoup"):
        np.testing.assert_array_equal(getattr(plan, field), getattr(jplan, field))
    # jit: the reference's eager stages would dominate the test's time
    j_fwd = jax.jit(lambda x: jring.fwd_ntt(x, jplan))
    j_inv = jax.jit(lambda x: jring.inv_ntt(x, jplan))
    hat = ntt.fwd_ntt(_t(a), plan)
    np.testing.assert_array_equal(to_numpy(hat), np.asarray(j_fwd(jnp.array(a))))
    back = ntt.inv_ntt(_t(a), plan)
    np.testing.assert_array_equal(to_numpy(back), np.asarray(j_inv(jnp.array(a))))
    np.testing.assert_array_equal(to_numpy(ntt.inv_ntt(hat, plan)), a)


def test_ntt_golden():
    """The reference's NTT golden (tests/test_goldens.py:30-42)."""
    x = np.arange(64, dtype=np.uint32) * np.uint32(0x9E3779B9)
    hat = ntt.fwd_ntt(torus.lift(_t(x), torus.make_crt_plan(2)), ntt.make_plan(64, 2))
    digest = hashlib.sha256(np.ascontiguousarray(to_numpy(hat)).tobytes()).hexdigest()[:16]
    assert digest == "f97a3773cff6b44e", digest


def test_kernel_wrapper_cpu_matches_pallas_interpret():
    """The kernel wrapper (on CPU: the plain twin) vs the Pallas kernel it
    replaces, run in interpret mode."""
    rng = np.random.default_rng(8)
    a = _residues(rng, 2, (3, 128))
    jplan, plan = jring.make_plan(128, 2), ntt.make_plan(128, 2)
    hat = kntt.fwd_ntt_nat(_t(a), plan)
    np.testing.assert_array_equal(to_numpy(hat), np.asarray(j_fwd_nat(jnp.array(a), jplan, interpret=True)))
    back = kntt.inv_ntt_nat(_t(a), plan)
    np.testing.assert_array_equal(to_numpy(back), np.asarray(j_inv_nat(jnp.array(a), jplan, interpret=True)))


def test_kernel_wrapper_contract():
    """CPU tensors run the twin and count no launch; bad inputs raise."""
    plan = ntt.make_plan(64, 2)
    kntt.reset_launches()
    x = torch.zeros((3, 2, 64), dtype=torch.int32)
    kntt.fwd_ntt_nat(x, plan)
    kntt.inv_ntt_nat(x, plan)
    assert kntt.fwd_ntt_nat.launches == 0 and kntt.inv_ntt_nat.launches == 0
    with pytest.raises(TypeError):
        kntt.fwd_ntt_nat(x.long(), plan)
    with pytest.raises(ValueError):
        kntt.fwd_ntt_nat(x[..., :32], plan)
    with pytest.raises(ValueError):
        kntt.inv_ntt_nat(torch.zeros((2, 64, 3), dtype=torch.int32).transpose(1, 2).transpose(0, 1), plan)
