"""Port parity of the mx evaluation order (mktfhe_tpu_torch/kernels/mx_ntt.py).

`mx_fwd_ref` / `mx_inv_ref` and `to_mx_order` / `from_mx_order` of the port
against the JAX package's functions of the same names on numpy-seeded
residues, at N = 128, 256, 512 (nb = 1, 2, 4) and 2-4 primes; tolerance 0.
Also the identity the port's module rests on: the mx order is a fixed
permutation of the plain transform's bit-reversed order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mktfhe_tpu.kernels import mx_ntt as jmx
from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.kernels import mx_ntt
from mktfhe_tpu_torch.ring.modring import PRIMES
from mktfhe_tpu_torch.ring.ntt import fwd_ntt, make_plan

CPU = torch.device("cpu")
SIZES = [(n, npr) for n in (128, 256, 512) for npr in (2, 3, 4)]
IDS = [f"n{n}_npr{npr}" for n, npr in SIZES]


def _residues(n, npr):
    rng = np.random.default_rng(1000 * npr + n)
    p = np.array(PRIMES[:npr], dtype=np.int64)[:, None]
    x = rng.integers(0, 1 << 62, size=(2, 3, npr, n)) % p
    x[0, 0, :, :3] = [[0, 1, q - 1] for q in PRIMES[:npr]]
    return x.astype(np.uint32)


@pytest.mark.parametrize("n,npr", SIZES, ids=IDS)
def test_mx_fwd_matches_reference(n, npr):
    x = _residues(n, npr)
    want = np.asarray(jmx.mx_fwd_ref(jnp.asarray(x), jmx.mx_plan(n, npr)))
    got = mx_ntt.mx_fwd_ref(bridge.from_numpy(x, CPU), make_plan(n, npr))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(bridge.to_numpy(got), want)


@pytest.mark.parametrize("n,npr", SIZES, ids=IDS)
def test_mx_inv_matches_reference_and_round_trips(n, npr):
    x = _residues(n, npr)  # any residues are some polynomial's evaluations
    want = np.asarray(jmx.mx_inv_ref(jnp.asarray(x), jmx.mx_plan(n, npr)))
    plan = make_plan(n, npr)
    got = mx_ntt.mx_inv_ref(bridge.from_numpy(x, CPU), plan)
    np.testing.assert_array_equal(bridge.to_numpy(got), want)
    np.testing.assert_array_equal(bridge.to_numpy(mx_ntt.mx_fwd_ref(got, plan)), x)


@pytest.mark.parametrize("n", [128, 256, 1024, 2048])
def test_mx_order_is_a_permutation_of_the_plain_transform(n):
    """mx[k2' * 128 + k1] == fwd_ntt[bitrev7(k1) * nb + k2'], and position
    k2' * 128 + k1 evaluates at psi^(2 (k1 + 128 bitrev(k2')) + 1): the plain
    transform holds the evaluation at psi^(2 bitrev(t) + 1) at position t."""
    nb = n // mx_ntt.NK
    idx = mx_ntt.mx_eval_index(n, CPU).numpy()
    inv = mx_ntt.mx_eval_index_inv(n, CPU).numpy()
    assert sorted(idx) == list(range(n))
    np.testing.assert_array_equal(idx[inv], np.arange(n))

    def bitrev(v, bits):
        return int(f"{v:0{bits}b}"[::-1], 2) if bits else 0

    log_n, log_nb = n.bit_length() - 1, nb.bit_length() - 1
    odd = mx_ntt.mx_odd_exponents(n)
    for pos in (0, 1, 5, 127, n // 2, (n // 2 + 77) % n, n - 128, n - 1):
        k2, k1 = divmod(pos, mx_ntt.NK)
        assert idx[pos] == bitrev(k1, 7) * nb + k2
        assert odd[pos] == 2 * (k1 + 128 * bitrev(k2, log_nb)) + 1 == 2 * bitrev(int(idx[pos]), log_n) + 1
    x = torch.from_numpy(_residues(n, 3).view(np.int32))
    plan = make_plan(n, 3)
    assert torch.equal(mx_ntt.mx_fwd_ref(x, plan), fwd_ntt(x, plan)[..., torch.from_numpy(idx)])


@pytest.mark.parametrize("nb", [1, 2, 4, 16])
def test_mx_coefficient_order_matches_reference(nb):
    rng = np.random.default_rng(nb)
    x = rng.integers(0, 1 << 63, size=(3, 2, nb * 128), dtype=np.int64)
    t = torch.from_numpy(x)
    want = np.asarray(jmx.to_mx_order(jnp.asarray(x), nb))
    np.testing.assert_array_equal(mx_ntt.to_mx_order(t, nb).numpy(), want)
    np.testing.assert_array_equal(
        mx_ntt.from_mx_order(t, nb).numpy(), np.asarray(jmx.from_mx_order(jnp.asarray(x), nb)))
    assert torch.equal(mx_ntt.from_mx_order(mx_ntt.to_mx_order(t, nb), nb), t)


def test_mx_order_refuses_small_rings():
    with pytest.raises(ValueError):
        mx_ntt.mx_eval_index(64, CPU)
    with pytest.raises(ValueError):
        mx_ntt.mx_odd_exponents(192)
