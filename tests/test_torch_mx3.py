"""Port parity of the phase-1 sweep (mktfhe_tpu_torch/kernels/fused_mx3.py).

The port's phase 1 (`kms_phase1_sweeps`, every party's sweep in one call,
then each party's `kms.levkey_lift`) against the reference engine `kms.phase1` /
`kms.phase1_block` of the JAX package, on the reference's own keys (bridged
as numpy) and numpy-seeded rotation amounts, at the cases of
tests/test_fused_mx3.py; tolerance 0 (the arithmetic is exact).  On CPU
tensors the port's wrapper runs the kernel's plain version.  The same cases
against the JAX package's own sweep kernel (interpreted) are in
tests/test_torch_mx3_interpret.py, the bootstrap in
tests/test_torch_mx3_boot.py.

Also: the plain version against an independent big-integer computation of
one step at accumulators with extreme bits (signed digits, carries that
wrap), and the wrapper's refusals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mktfhe_tpu.kernels.fused_mx3 import build_mx3_kms_keys
from mktfhe_tpu.ring.context import make_ring_ctx as j_ring_ctx
from mktfhe_tpu.schemes import kms as jkms
from mktfhe_tpu.schemes.params import KmsBlockParams as JKmsBlockParams
from mktfhe_tpu.schemes.presets import TINY_KMS_2PARTY_MX as TINYMX
from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.kernels import fused_mx3
from mktfhe_tpu_torch.ring.ntt import fwd_ntt
from mktfhe_tpu_torch.ring.torus import lift
from mktfhe_tpu_torch.schemes import kms

CPU = torch.device("cpu")
G = 4

TINYMX2 = dataclasses.replace(TINYMX, big_n=256)
BLOCK = JKmsBlockParams(
    d=3, ell=3, alpha=16.0, f=8, log_d=2, big_n=256, beta=4.0,
    l_gsw=3, log_b_gsw=8, l_lev=2, log_b_lev=8, l_uni=3, log_b_uni=8, k=2,
)
CASES = {
    "n128": TINYMX,
    "n256": TINYMX2,
    "n512": dataclasses.replace(TINYMX, big_n=512),
    "wide_gadget": dataclasses.replace(TINYMX2, log_b_gsw=12),
    "block": BLOCK,
}


def _reference_keys(params):
    """The reference's crs and party keys (seeds of tests/test_fused_mx3.py)."""
    a = jkms.crs(jax.random.key(300), params)
    parties = [jkms.party_keygen(jax.random.key(400 + i), a, params) for i in range(params.k)]
    return a, parties


def _port_scheme(a, parties, tparams):
    return kms.setup(
        bridge.from_numpy(a, CPU), [bridge.party_key(p[3], CPU) for p in parties], tparams
    )


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    params = CASES[request.param]
    a, parties = _reference_keys(params)
    rng = np.random.default_rng(3)
    tildea = rng.integers(0, 2 * params.big_n, size=(G, params.n), dtype=np.int64).astype(np.int32)
    tparams = bridge.params(params)
    return {
        "params": params,
        "tparams": tparams,
        "jscheme": jkms.setup(a, [p[3] for p in parties], params),
        "jkeys3": build_mx3_kms_keys([p[3] for p in parties], params, chunk=3),
        "scheme": _port_scheme(a, parties, tparams),
        "tildea": tildea,
        "got": {},
    }


def _port_levkey(case, party):
    """The port's lev key for `party` (rows 1 for party 0, l_lev otherwise):
    every party's sweep in one `kms_phase1_sweeps` call, each party on the
    case's rotation amounts, then each party's lift; computed once per
    case."""
    if not case["got"]:
        tparams, scheme = case["tparams"], case["scheme"]
        ctx = kms._ctx(tparams)
        tildea = torch.from_numpy(np.tile(case["tildea"], (1, tparams.k)))
        accs = fused_mx3.kms_phase1_sweeps(tildea, scheme.brk_hat, tparams.l_lev, scheme.mono_hat, tparams, ctx)
        for p, acc in enumerate(accs):
            out = kms.levkey_lift(acc, ctx)
            assert out.dtype == torch.int32
            case["got"][p] = bridge.to_numpy(out)
    return case["got"][party]


@pytest.mark.parametrize("party", [0, 1], ids=["party0_row1", "party1_rows_l_lev"])
def test_phase1_matches_reference_engine(case, party):
    """vs kms.phase1 / kms.phase1_block of the JAX package."""
    params, js = case["params"], case["jscheme"]
    ctx = j_ring_ctx(params.big_n, params.ring_torus_bits, params.ring_nprimes)
    rows = 1 if party == 0 else params.l_lev
    if isinstance(params, JKmsBlockParams):
        ref = jax.jit(lambda ta: jkms.phase1_block(
            ta, js.brk_hat[party], js.brk_shoup[party], rows, js, params, ctx))
    else:
        ref = jax.jit(lambda ta: jkms.phase1(
            ta, js.brk_hat[party], js.brk_shoup[party], rows, params, ctx))
    want = np.asarray(ref(jnp.asarray(case["tildea"])))
    np.testing.assert_array_equal(_port_levkey(case, party), want)


# --- the plain version against big integers, one step ----------------------

EDGE = [-1, -(1 << 63), (1 << 63) - 1, 0, 1, -(1 << 62), (1 << 62) - 1, 1 << 31, -(1 << 31)]


def _exact_digits(a: int, l: int, log_b: int) -> list[int]:
    """Balanced digits of the torus value a (mod 2^64) by their definition:
    v = round(a / 2^low) mod B^l, then the unique digits in [-B/2, B/2)
    with sum d_j B^(l-1-j) == v (mod B^l)."""
    low = 64 - l * log_b
    b = 1 << log_b
    v = a % (1 << 64)
    if low:
        v = (v + (1 << (low - 1))) >> low
    digs = []
    for _ in range(l):
        d = (v + b // 2) % b - b // 2
        v = (v - d) >> log_b
        digs.append(d)
    return digs[::-1]


def _negacyclic(x, y):
    """Product of two integer polynomials mod X^N + 1, Python integers."""
    n = len(x)
    full = np.convolve(np.array(x, dtype=object), np.array(y, dtype=object))
    out = full[:n].copy()
    out[: n - 1] -= full[n:]
    return out


def _times_monomial_minus_one(e, a):
    """(X^a - 1) e mod X^N + 1 for a in [0, 2N)."""
    n = len(e)
    mono = [0] * n
    if a < n:
        mono[a] += 1
    else:
        mono[a - n] -= 1
    mono[0] -= 1
    return _negacyclic(mono, e)


def _exact_step(acc0, brk, amounts, l, log_b):
    """acc0 [2, N] ints + sum_m (X^{a_m} - 1) (digits(acc0) . brk[m]) mod 2^64;
    brk [ell, 2, l, 2, N] as signed integers (the balanced lift)."""
    n = len(acc0[0])
    digs = [[_exact_digits(int(v), l, log_b) for v in comp] for comp in acc0]
    out = [np.array([int(v) for v in comp], dtype=object) for comp in acc0]
    for m, a in enumerate(amounts):
        for cout in range(2):
            e = np.zeros(n, dtype=object)
            for cin in range(2):
                for j in range(l):
                    e = e + _negacyclic([digs[cin][i][j] for i in range(n)],
                                        [int(v) for v in brk[m][cin][j][cout]])
            out[cout] = out[cout] + _times_monomial_minus_one(e, a)
    return np.array([[int(v) % (1 << 64) for v in comp] for comp in out], dtype=np.uint64)


ONE_STEP = {
    "binary": dataclasses.replace(TINYMX, n=1, big_n=64),
    "binary_wide_gadget": dataclasses.replace(TINYMX, n=1, big_n=64, log_b_gsw=12),
    "binary_l4_b16": dataclasses.replace(TINYMX, n=1, big_n=64, l_gsw=4, log_b_gsw=16),
    "block": dataclasses.replace(BLOCK, d=1, big_n=64),
}


@pytest.mark.parametrize("name", list(ONE_STEP))
def test_plain_sweep_matches_big_integers(name):
    """One step from accumulators with extreme bits: digits at and around
    the sign boundary, rounding carries that run through every digit and
    wrap away at bit 64."""
    params = bridge.params(ONE_STEP[name])
    ctx = kms._ctx(params)
    n, l, log_b = ctx.n, params.l_gsw, params.log_b_gsw
    rng = np.random.default_rng(11)
    acc0 = rng.integers(-(1 << 63), (1 << 63) - 1, size=(2, 1, 2, n), dtype=np.int64)
    acc0[0, 0, 0, : len(EDGE)] = EDGE
    low = 64 - l * log_b
    if low:  # the rounding bit set under an all-ones digit field: the carry wraps
        acc0[0, 0, 1, 0] = -(1 << (low - 1))
        acc0[0, 0, 1, 1] = (1 << 63) - (1 << (low - 1))
    brk = rng.integers(-(1 << 63), (1 << 63) - 1, size=(params.n, 2, l, 2, n), dtype=np.int64)
    amounts = np.array([[0] * params.n, [2 * n - 1] + [n - 3] * (params.n - 1)], dtype=np.int32)
    brk_hat = fwd_ntt(lift(torch.from_numpy(brk), ctx.crt), ctx.plan)
    mono = kms.monomial_table(ctx, CPU) if hasattr(params, "ell") else None
    got = fused_mx3.phase1_sweep_plain(
        torch.from_numpy(amounts), brk_hat, 1, mono, params, ctx, acc0=torch.from_numpy(acc0),
    )
    for g in range(2):
        want = _exact_step(acc0[g, 0], brk, amounts[g], l, log_b)
        np.testing.assert_array_equal(bridge.to_numpy(got[g, 0]), want)


# --- the wrapper's contract on CPU tensors ---------------------------------


@pytest.fixture(scope="module")
def small():
    """Random residues at N = 64 for the contract tests (no keygen)."""
    params = bridge.params(dataclasses.replace(BLOCK, big_n=64))
    ctx = kms._ctx(params)
    rng = np.random.default_rng(5)
    shape = (params.n, 2, params.l_gsw, 2, ctx.nprimes, ctx.n)
    brk = torch.from_numpy(rng.integers(0, 1 << 29, size=shape).astype(np.int32))
    ta = torch.from_numpy(rng.integers(0, 2 * ctx.n, size=(G, params.n)).astype(np.int32))
    return params, ctx, ta, brk, kms.monomial_table(ctx, CPU)


def test_wrapper_on_cpu_runs_plain_version(small):
    params, ctx, ta, brk, mono = small
    fused_mx3.reset_launches()
    got = fused_mx3.phase1_sweep(ta, brk, 2, mono, params, ctx)
    want = fused_mx3.phase1_sweep_plain(ta, brk, 2, mono, params, ctx)
    assert got.dtype == torch.int64 and tuple(got.shape) == (G, 2, 2, ctx.n)
    assert torch.equal(got, want)
    assert fused_mx3.phase1_sweep.launches == 0  # only kernel launches count
    acc0 = torch.from_numpy(
        np.random.default_rng(6).integers(-(1 << 63), (1 << 63) - 1, size=(G, 2, 2, ctx.n)))
    keep = acc0.clone()
    fused_mx3.phase1_sweep(ta, brk, 2, mono, params, ctx, acc0=acc0)
    assert torch.equal(acc0, keep)  # the caller's accumulator is not written


REFUSALS = {
    "tildea_int64": (lambda ta, brk, mono: (ta.long(), brk, mono), TypeError),
    "tildea_shape": (lambda ta, brk, mono: (ta[:, :-1].contiguous(), brk, mono), ValueError),
    "tildea_strided": (lambda ta, brk, mono: (ta.t().contiguous().t(), brk, mono), ValueError),
    "tildea_negative": (lambda ta, brk, mono: (ta - 1000, brk, mono), ValueError),
    "tildea_2n": (lambda ta, brk, mono: (ta + 128, brk, mono), ValueError),
    "brk_int64": (lambda ta, brk, mono: (ta, brk.long(), mono), TypeError),
    "brk_shape": (lambda ta, brk, mono: (ta, brk[:, :, :-1].contiguous(), mono), ValueError),
    "brk_strided": (lambda ta, brk, mono: (ta, brk.transpose(1, 3).contiguous().transpose(1, 3), mono), ValueError),
    "mono_shape": (lambda ta, brk, mono: (ta, brk, mono[:-1]), ValueError),
    "mono_int64": (lambda ta, brk, mono: (ta, brk, mono.long()), TypeError),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_wrapper_refuses_tensors(small, name):
    params, ctx, ta, brk, mono = small
    change, error = REFUSALS[name]
    ta, brk, mono = change(ta, brk, mono)
    with pytest.raises(error):
        fused_mx3.phase1_sweep(ta, brk, 2, mono, params, ctx)


def test_wrapper_refuses_ranges(small):
    params, ctx, ta, brk, mono = small
    with pytest.raises(ValueError):  # rows beyond l_lev
        fused_mx3.phase1_sweep(ta, brk, params.l_lev + 1, mono, params, ctx)
    with pytest.raises(ValueError):  # acc0 of another shape
        fused_mx3.phase1_sweep(ta, brk, 2, mono, params, ctx,
                               acc0=torch.zeros((G, 1, 2, ctx.n), dtype=torch.int64))
    with pytest.raises(TypeError):  # acc0 of another type
        fused_mx3.phase1_sweep(ta, brk, 2, mono, params, ctx,
                               acc0=torch.zeros((G, 2, 2, ctx.n), dtype=torch.int32))
    wide = dataclasses.replace(params, l_gsw=7, log_b_gsw=9)  # l_gsw above 6
    with pytest.raises(ValueError):
        fused_mx3.phase1_sweep(ta, brk, 2, mono, wide, ctx)
    long = dataclasses.replace(params, l_gsw=5, log_b_gsw=13)  # 65 bits of digits
    with pytest.raises(ValueError):
        fused_mx3.phase1_sweep(ta, brk, 2, mono, long, ctx)
    small_ring = dataclasses.replace(params, big_n=32)  # N below 64
    with pytest.raises(ValueError):
        fused_mx3.phase1_sweep(ta, brk, 2, mono, small_ring, kms._ctx(small_ring))
    with pytest.raises(TypeError):  # parameters of another scheme
        fused_mx3.phase1_sweep(ta, brk, 2, mono, object(), ctx)


# --- every party's sweep in one call (`phase1_sweeps`) -----------------------


@pytest.fixture(scope="module")
def small_parties(small):
    """`small`'s inputs for two parties: the second party's keys and
    amounts differ from the first's."""
    params, ctx, ta, brk, mono = small
    ta2 = torch.cat([ta, torch.flip(ta, (0,))], 1)
    brk2 = torch.stack([brk, torch.roll(brk, 1, 0)])
    return params, ctx, ta2, brk2, mono


def test_sweeps_wrapper_on_cpu_runs_plain_party_by_party(small_parties):
    """Party 1 one row, party 2 `rows`, each == `phase1_sweep_plain` on its
    columns and keys; the accumulators are views of one buffer."""
    params, ctx, ta, brk, mono = small_parties
    fused_mx3.reset_launches()
    got = fused_mx3.phase1_sweeps(ta, brk, 2, mono, params, ctx)
    assert [tuple(a.shape) for a in got] == [(G, 1, 2, ctx.n), (G, 2, 2, ctx.n)]
    assert got[1].untyped_storage().data_ptr() == got[0].untyped_storage().data_ptr()
    for party, rows in enumerate((1, 2)):
        cols = ta[:, party * params.n : (party + 1) * params.n].contiguous()
        assert torch.equal(got[party], fused_mx3.phase1_sweep_plain(cols, brk[party], rows, mono, params, ctx))
    assert (fused_mx3.phase1_sweep.launches, fused_mx3.phase1_sweep.parties) == (0, 0)


@pytest.mark.parametrize("name", list(REFUSALS))
def test_sweeps_wrapper_refuses_tensors(small_parties, name):
    params, ctx, ta, brk, mono = small_parties
    change, error = REFUSALS[name]
    ta, brk, mono = change(ta, brk, mono)
    with pytest.raises(error):
        fused_mx3.phase1_sweeps(ta, brk, 2, mono, params, ctx)


def test_sweeps_wrapper_refuses_one_partys_keys(small_parties):
    """One party's brk_hat (no party axis), or none, is not every party's."""
    params, ctx, ta, brk, mono = small_parties
    with pytest.raises(ValueError):
        fused_mx3.phase1_sweeps(ta, brk[0], 2, mono, params, ctx)
    with pytest.raises(ValueError):
        fused_mx3.phase1_sweeps(ta[:, : params.n].contiguous(), brk, 2, mono, params, ctx)
    with pytest.raises(ValueError):
        fused_mx3.phase1_sweeps(ta[:, :0].contiguous(), brk[:0], 2, mono, params, ctx)
    with pytest.raises(ValueError):  # rows beyond l_lev
        fused_mx3.phase1_sweeps(ta, brk, params.l_lev + 1, mono, params, ctx)
