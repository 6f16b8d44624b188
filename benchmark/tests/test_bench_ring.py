"""The reference's matrix-product ring against today's form (`ExactRing`): at
N = 2048 with the four primes, the same hats up to their order and the same
words back, on random inputs and on the extremes (residues 0 and p - 1,
the most negative digit, the ends of the 2^64 torus); the in-place
contraction's reduction at its longest sums of (p - 1)^2; and the whole
bootstrap word for word at tiny sets."""

import pytest
import torch

from benchmark.reference import kms as ref

from conftest import TINY_BLOCK

N = 2048
SEED = 2**32 + 17


@pytest.fixture(scope="module")
def rings():
    old, new = ref.ExactRing(N, "cpu"), ref.MatrixRing(N, "cpu")
    # the order of the new hats in the old ones', read off one random torus polynomial
    x = ref.uniform64(ref.generator("cpu", SEED, "order"), (N,))
    h_old, h_new = old.fwd(x), new.fwd(x)
    where = {int(v): i for i, v in enumerate(h_new[0])}
    assert len(where) == N
    perm = torch.tensor([where[int(v)] for v in h_old[0]])  # new[..., perm] == old
    return old, new, perm


def _digits(gen, log_b, rows=6):
    half = 1 << (log_b - 1)
    d = torch.randint(-half, half, (rows, N), generator=gen)
    d[0] = -half  # the most negative digit everywhere
    d[1] = half - 1
    d[2, ::2] = -half
    return d


def _torus(gen, rows=6):
    y = ref.uniform64(gen, (rows, N))
    y[0] = -(1 << 63)
    y[1] = (1 << 63) - 1
    y[2] = -1
    y[3, ::3] = -(1 << 63)
    return y


@pytest.mark.parametrize("log_b", [2, 6, 9])
def test_forward_equals_todays_up_to_order(rings, log_b):
    old, new, perm = rings
    gen = ref.generator("cpu", SEED, "fwd", log_b)
    for x in (_digits(gen, log_b), _torus(gen), torch.randint(-1, 2, (3, N), generator=gen)):
        assert torch.equal(new.fwd(x)[..., perm], old.fwd(x))


def test_inverse_equals_todays_on_extreme_residues(rings):
    old, new, perm = rings
    gen = ref.generator("cpu", SEED, "inv")
    h = torch.randint(0, 1 << 30, (5, 4, N), generator=gen) % old.p
    h[0] = old.p - 1
    h[1] = 0
    h[2, :, ::2] = old.p - 1
    h[3, 0] = old.p[0] - 1  # one prime at its top, the others at 0
    h[3, 1:] = 0
    back = torch.empty_like(perm)
    back[perm] = torch.arange(N)
    assert torch.equal(new.inv(h[..., back]), old.inv(h))


@pytest.mark.parametrize("log_b", [7, 9])
def test_products_equal_todays(rings, log_b):
    """Digits times torus polynomials, summed over as many terms as phase 2's
    longest contraction (16), with every residue at p - 1 in half of them."""
    old, new, _ = rings
    gen = ref.generator("cpu", SEED, "mul", log_b)
    d, y = _digits(gen, log_b, 16), _torus(gen, 16)
    want = old.inv(old.mulsum(old.fwd(d)[:, None], old.fwd(y)[:, None], 0))
    assert torch.equal(new.inv(new.mulsum(new.fwd(d)[:, None], new.fwd(y)[:, None], 0)), want)
    a = torch.randint(0, 1 << 30, (16, 3, 4, N), generator=gen) % old.p
    b = torch.randint(0, 1 << 30, (16, 1, 4, N), generator=gen) % old.p
    a[:8], b[:8] = old.p - 1, old.p - 1
    for dim in (0, -2):
        x, z = (a, b) if dim == 0 else (a.movedim(0, 1), b.movedim(0, 1))
        assert torch.equal(new.mulsum(x, z, dim), old.mulsum(x, z, dim))
    assert torch.equal(new.mul(a[0], b[0]), old.mul(a[0], b[0]))


BINARY = dict(n=8, alpha=16.0, f=8, log_d=2, big_n=128, beta=4.0, l_gsw=3, log_b_gsw=8, l_lev=2, log_b_lev=8,
              l_uni=3, log_b_uni=8, k=2)
KMS32_GADGET = dict(TINY_BLOCK, d=2, l_gsw=6, log_b_gsw=7, l_lev=3, log_b_lev=7, l_uni=16, log_b_uni=2, k=3)


@pytest.mark.parametrize("p", [TINY_BLOCK, BINARY, KMS32_GADGET], ids=["block", "binary", "kms32-gadget"])
def test_bootstrap_equals_todays(p):
    params = ref.KmsSet.from_config(p)
    crs = ref.crs(params, SEED, "cpu")
    gen = ref.generator("cpu", SEED, "cts")
    b, a = ref.uniform32(gen, (5,)), ref.uniform32(gen, (5, params.k * params.n))
    want = ref.bootstrap(ref.ExactRing(params.big_n, "cpu"), params, b, a, SEED, crs, party_chunk=2)
    got = ref.bootstrap(ref.MatrixRing(params.big_n, "cpu"), params, b, a, SEED, crs, party_chunk=2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
