"""Port parity of the mx-domain keys (mktfhe_tpu_torch/kernels/fused_mx2.py).

`build_mx_kms_keys` of the port on the reference's party keys (bridged as
numpy) against the JAX package's `brk_mx`, bit for bit; the prime count of
every binary KMS preset against the reference's rule; and the table of
powers of psi from which kernel and plain version form the monomial against
the reference's `mx_mono_table` and its A * B factor tables.  Tolerance 0.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mktfhe_tpu.kernels import fused_mx2 as jmx2
from mktfhe_tpu.ring.context import make_ring_ctx as j_ring_ctx
from mktfhe_tpu.ring.context import nprimes_needed as j_nprimes_needed
from mktfhe_tpu.schemes import kms as jkms
from mktfhe_tpu.schemes import presets as jpresets
from mktfhe_tpu.schemes.presets import TINY_KMS_2PARTY_MX as TINYMX
from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.kernels import fused_mx2
from mktfhe_tpu_torch.ring.modring import PRIMES
from mktfhe_tpu_torch.schemes import presets

CPU = torch.device("cpu")
KEY_CASES = {
    "TinyKMS2partyMX": TINYMX,
    "n256": dataclasses.replace(TINYMX, big_n=256),
    "n256_wide_gadget_4primes": dataclasses.replace(TINYMX, big_n=256, log_b_gsw=14),
}


@pytest.mark.parametrize("name", list(KEY_CASES))
def test_build_mx_kms_keys_matches_reference(name):
    params = KEY_CASES[name]
    a = jkms.crs(jax.random.key(300), params)
    parties = [jkms.party_keygen(jax.random.key(400 + i), a, params) for i in range(params.k)]
    want = jmx2.build_mx_kms_keys([p[3] for p in parties], params, chunk=3)
    tparams = bridge.params(params)
    got = fused_mx2.build_mx_kms_keys([bridge.party_key(p[3], CPU) for p in parties], tparams)
    npr = fused_mx2.mx_nprimes(tparams)
    assert got.brk_mx.dtype == torch.int32
    assert tuple(got.brk_mx.shape) == (params.k, params.n, npr, 2 * params.l_gsw, 2, params.big_n)
    np.testing.assert_array_equal(bridge.to_numpy(got.brk_mx), np.asarray(want.brk_mx))
    # the bridge carries the reference's keys across without the Shoup companion
    assert torch.equal(bridge.mx_kms_keys(want, CPU).brk_mx, got.brk_mx)
    # an explicit prime count overrides the rule
    more = fused_mx2.build_mx_kms_keys([bridge.party_key(parties[0][3], CPU)], tparams, npr=4)
    assert more.brk_mx.shape[2] == 4
    assert torch.equal(more.brk_mx[0, :, :npr], got.brk_mx[0])


BINARY_PRESETS = ["KMS_2PARTY", "KMS_4PARTY", "KMS_8PARTY", "KMS_16PARTY", "KMS_32PARTY",
                  "TINY_KMS_2PARTY", "TINY_KMS_2PARTY_MX"]


@pytest.mark.parametrize("name", BINARY_PRESETS)
def test_mx_prime_count_matches_reference_rule(name):
    """The rule of fused_mx2.py:491-495 of the JAX package on its own preset."""
    jp = getattr(jpresets, name)
    want = j_nprimes_needed(
        jp.ring_torus_bits, jp.big_n, [(1 << (jp.log_b_gsw - 1), jp.l_gsw * 2 * 2)])
    assert fused_mx2.mx_nprimes(getattr(presets, name)) == want
    assert 2 <= want <= 4


def test_mx_prime_count_of_the_large_presets():
    assert fused_mx2.mx_nprimes(presets.KMS_8PARTY) == 3
    assert fused_mx2.mx_nprimes(presets.KMS_2PARTY) == 4


AMOUNTS = {128: [0, 1, 7, 127, 128, 255], 256: [0, 1, 5, 129, 255, 256, 300, 511]}


@pytest.mark.parametrize("n", [128, 256])
def test_power_table_reproduces_reference_monomials(n):
    """psi^(a o mod 2N) - 1 from the 2N powers equals the reference's full
    monomial table mono_mx[a] and its factorization A[a, k1] B[a, k2'] - 1
    (the rotation amounts of tests/test_fused_mx2.py, and all of them against
    the table)."""
    npr = 3
    ctx = j_ring_ctx(n, 64, npr)
    mono, _ = jmx2.mx_mono_table(ctx)  # [2N, npr, N]
    got = fused_mx2.mx_mono_rows(torch.arange(2 * n), n, npr)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(mono).astype(np.int64))

    a_tab, _, b_tab, _ = jmx2.mono_factor_tables(n, npr)
    primes = np.asarray(PRIMES[:npr], np.uint64)[:, None, None]
    nb = n // 128
    for a in AMOUNTS[n]:
        prod = (a_tab[:, a].astype(np.uint64)[:, None, :] * b_tab[:, a].astype(np.uint64)[:, :, None]) % primes
        want = ((prod + primes - 1) % primes).reshape(npr, nb * 128)
        np.testing.assert_array_equal(got[a].numpy().astype(np.uint64), want)


def test_power_table_is_the_plan_root():
    """pw[q, e] = psi_q^e with psi_q of order exactly 2N, the root of the
    port's NTT plan (its table's entry at index 1 is psi^(N/2))."""
    n, npr = 256, 4
    pw = fused_mx2.mx_power_table(n, npr).astype(object)
    for q, p in enumerate(PRIMES[:npr]):
        assert pw[q, 0] == 1 and pw[q, n] == p - 1
        assert (pw[q, 1] * pw[q, 2 * n - 1]) % p == 1
        np.testing.assert_array_equal((pw[q, 1:] * 1) % p, (pw[q, :-1] * pw[q, 1]) % p)
