"""Port parity of the mx phase-1 sweep (mktfhe_tpu_torch/kernels/fused_mx2.py).

`kms_phase1_mx2` of the port against the JAX package's `kms_phase1_mx2` with
its Pallas kernel interpreted, at TinyKMS2partyMX (party 1 with one row,
party 2 with l_lev rows, as tests/test_fused_mx2.py); against the jnp engine
`kms.phase1` at N = 256 and 512 and with a wide gadget, where the
interpreter would be slow; on the reference's own keys (bridged as numpy;
the port builds its mx keys from them) and numpy-seeded rotation amounts.
Tolerance 0.  On CPU tensors the port's wrapper runs the kernel's plain
version.  Also a given start accumulator and the wrapper's refusals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mktfhe_tpu.kernels import fused_mx2 as jmx2
from mktfhe_tpu.ring.context import make_ring_ctx as j_ring_ctx
from mktfhe_tpu.schemes import kms as jkms
from mktfhe_tpu.schemes.presets import TINY_KMS_2PARTY_MX as TINYMX
from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.kernels import fused_mx2, fused_mx3
from mktfhe_tpu_torch.ring.context import make_ring_ctx
from mktfhe_tpu_torch.ring.ntt import fwd_ntt
from mktfhe_tpu_torch.ring.torus import lift
from mktfhe_tpu_torch.schemes import kms
from mktfhe_tpu_torch.schemes.params import KmsBlockParams

CPU = torch.device("cpu")
G = 4
CASES = {
    "n128": TINYMX,
    "n256": dataclasses.replace(TINYMX, big_n=256),
    "n512": dataclasses.replace(TINYMX, big_n=512),
    "wide_gadget": dataclasses.replace(TINYMX, big_n=256, log_b_gsw=12),
}
PARTIES = [(0, "party0_row1"), (1, "party1_rows_l_lev")]


def reference_keys(params):
    """The reference's crs and party keys (seeds of tests/test_fused_mx2.py)."""
    a = jkms.crs(jax.random.key(300), params)
    parties = [jkms.party_keygen(jax.random.key(400 + i), a, params) for i in range(params.k)]
    return a, parties


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    params = CASES[request.param]
    a, parties = reference_keys(params)
    rng = np.random.default_rng(3)
    tildea = rng.integers(0, 2 * params.big_n, size=(G, params.n), dtype=np.int64).astype(np.int32)
    tparams = bridge.params(params)
    return {
        "name": request.param,
        "params": params,
        "tparams": tparams,
        "a": a,
        "parties": parties,
        "mx_keys": fused_mx2.build_mx_kms_keys([bridge.party_key(p[3], CPU) for p in parties], tparams),
        "tildea": tildea,
    }


def _port_levkey(case, party):
    tparams = case["tparams"]
    rows = 1 if party == 0 else tparams.l_lev
    out = fused_mx2.kms_phase1_mx2(
        torch.from_numpy(case["tildea"]), case["mx_keys"].brk_mx[party], rows, tparams, kms._ctx(tparams))
    assert out.dtype == torch.int32
    assert tuple(out.shape) == (G, rows, 2, tparams.ring_nprimes, tparams.big_n)
    return bridge.to_numpy(out)


@pytest.mark.parametrize("party", [p for p, _ in PARTIES], ids=[i for _, i in PARTIES])
def test_phase1_matches_reference(case, party):
    """vs the JAX kernel interpreted at N = 128, vs jnp kms.phase1 elsewhere."""
    params = case["params"]
    ctx = j_ring_ctx(params.big_n, params.ring_torus_bits, params.ring_nprimes)
    rows = 1 if party == 0 else params.l_lev
    pkeys = [p[3] for p in case["parties"]]
    ta = jnp.asarray(case["tildea"])
    if case["name"] == "n128":
        jkeys = jmx2.build_mx_kms_keys(pkeys, params)
        want = jmx2.kms_phase1_mx2(
            ta, jkeys.brk_mx[party], jkeys.brk_mx_shoup[party], rows, params, ctx, interpret=True)
    else:
        js = jkms.setup(case["a"], pkeys, params)
        want = jax.jit(lambda t: jkms.phase1(
            t, js.brk_hat[party], js.brk_shoup[party], rows, params, ctx))(ta)
    np.testing.assert_array_equal(_port_levkey(case, party), np.asarray(want))


def test_phase1_matches_port_mx3(case):
    """The port's two sweeps agree on the same party keys, each on its own
    image of them (standard order and the scheme's primes; mx order and the
    key's primes)."""
    tparams, party = case["tparams"], 1
    ctx = kms._ctx(tparams)
    brk_hat = fwd_ntt(lift(bridge.party_key(case["parties"][party][3], CPU).brk, ctx.crt), ctx.plan)
    acc = fused_mx3.phase1_sweep(torch.from_numpy(case["tildea"]), brk_hat, tparams.l_lev, None, tparams, ctx)
    want = kms.levkey_lift(acc, ctx)
    np.testing.assert_array_equal(_port_levkey(case, party), bridge.to_numpy(want))


# --- a given accumulator, and the wrapper's contract on CPU tensors ----------


@pytest.fixture(scope="module")
def small():
    """Random residues at N = 128, 4 primes, for the contract tests (no keygen)."""
    params = bridge.params(dataclasses.replace(TINYMX, n=3))
    ctx = make_ring_ctx(params.big_n, 64, 4)
    rng = np.random.default_rng(5)
    brk = torch.from_numpy(
        rng.integers(0, 1 << 29, size=(params.n, 4, 2 * params.l_gsw, 2, ctx.n)).astype(np.int32))
    ta = torch.from_numpy(rng.integers(0, 2 * ctx.n, size=(G, params.n)).astype(np.int32))
    return params, ctx, ta, brk


def test_wrapper_on_cpu_runs_plain_version(small):
    params, ctx, ta, brk = small
    fused_mx2.reset_launches()
    got = fused_mx2.mx_sweep(ta, brk, 2, params, ctx)
    assert got.dtype == torch.int64 and tuple(got.shape) == (G, 2, 2, ctx.n)
    assert torch.equal(got, fused_mx2.mx_sweep_plain(ta, brk, 2, params, ctx))
    assert fused_mx2.mx_sweep.launches == 0  # only kernel launches count


def test_sweep_from_a_given_accumulator(small):
    """Two sweeps over the halves of the key equal one over the whole, and
    the caller's accumulator is not written."""
    params, ctx, ta, brk = small
    whole = fused_mx2.mx_sweep(ta, brk, 2, params, ctx)
    first = dataclasses.replace(params, n=1)
    rest = dataclasses.replace(params, n=params.n - 1)
    mid = fused_mx2.mx_sweep(ta[:, :1].contiguous(), brk[:1], 2, first, ctx)
    keep = mid.clone()
    got = fused_mx2.mx_sweep(ta[:, 1:].contiguous(), brk[1:], 2, rest, ctx, acc0=mid)
    assert torch.equal(mid, keep)
    assert torch.equal(got, whole)
    rng = np.random.default_rng(6)
    acc0 = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, size=(G, 2, 2, ctx.n)))
    assert not torch.equal(fused_mx2.mx_sweep(ta, brk, 2, params, ctx, acc0=acc0), whole)


REFUSALS = {
    "tildea_int64": (lambda ta, brk: (ta.long(), brk), TypeError),
    "tildea_shape": (lambda ta, brk: (ta[:, :-1].contiguous(), brk), ValueError),
    "tildea_strided": (lambda ta, brk: (ta.t().contiguous().t(), brk), ValueError),
    "tildea_negative": (lambda ta, brk: (ta - 1000, brk), ValueError),
    "tildea_2n": (lambda ta, brk: (ta + 256, brk), ValueError),
    "brk_int64": (lambda ta, brk: (ta, brk.long()), TypeError),
    "brk_other_prime_count": (lambda ta, brk: (ta, brk[:, :3].contiguous()), ValueError),
    "brk_standard_layout": (lambda ta, brk: (ta, brk.permute(0, 2, 3, 1, 4).contiguous()), ValueError),
    "brk_strided": (lambda ta, brk: (ta, brk.transpose(1, 3).contiguous().transpose(1, 3)), ValueError),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_wrapper_refuses_tensors(small, name):
    params, ctx, ta, brk = small
    change, error = REFUSALS[name]
    ta, brk = change(ta, brk)
    with pytest.raises(error):
        fused_mx2.mx_sweep(ta, brk, 2, params, ctx)


def test_wrapper_refuses_ranges(small):
    params, ctx, ta, brk = small
    with pytest.raises(ValueError):  # rows beyond l_lev
        fused_mx2.mx_sweep(ta, brk, params.l_lev + 1, params, ctx)
    with pytest.raises(ValueError):  # acc0 of another shape
        fused_mx2.mx_sweep(ta, brk, 2, params, ctx, acc0=torch.zeros((G, 1, 2, ctx.n), dtype=torch.int64))
    with pytest.raises(TypeError):  # acc0 of another type
        fused_mx2.mx_sweep(ta, brk, 2, params, ctx, acc0=torch.zeros((G, 2, 2, ctx.n), dtype=torch.int32))
    with pytest.raises(ValueError):  # l_gsw above 6
        fused_mx2.mx_sweep(ta, brk, 2, dataclasses.replace(params, l_gsw=7, log_b_gsw=9), ctx)
    with pytest.raises(ValueError):  # 65 bits of digits
        fused_mx2.mx_sweep(ta, brk, 2, dataclasses.replace(params, l_gsw=5, log_b_gsw=13), ctx)
    small_ring = dataclasses.replace(params, big_n=64)  # N below 128: no mx order
    with pytest.raises(ValueError):
        fused_mx2.mx_sweep(ta, brk, 2, small_ring, make_ring_ctx(64, 64, 4))
    with pytest.raises(ValueError):  # a context of another ring
        fused_mx2.mx_sweep(ta, brk, 2, params, make_ring_ctx(256, 64, 4))
    with pytest.raises(ValueError):  # the 2^32 torus
        fused_mx2.mx_sweep(ta, brk, 2, params, make_ring_ctx(128, 32, 4))
    with pytest.raises(TypeError):  # parameters of another scheme
        fused_mx2.mx_sweep(ta, brk, 2, object(), ctx)


def test_wrapper_refuses_block_keys(small):
    _, ctx, ta, brk = small
    block = KmsBlockParams(
        d=1, ell=3, alpha=16.0, f=8, log_d=2, big_n=128, beta=4.0,
        l_gsw=3, log_b_gsw=8, l_lev=2, log_b_lev=8, l_uni=3, log_b_uni=8, k=2,
    )
    with pytest.raises(TypeError, match="binary-key rotation"):
        fused_mx2.mx_sweep(ta, brk, 2, block, ctx)
