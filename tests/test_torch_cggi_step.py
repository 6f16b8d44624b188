"""The plain version of the fused CGGI step against big integers, and the
wrapper's contract on CPU tensors (mktfhe_tpu_torch/kernels/fused_step.py).

`cggi_step_plain` is what the CUDA kernel is held against on the card, so it
is held here against an independent computation of one step in Python
integers, from accumulators with extreme bits: 0, 2^32 - 1, 2^31, and values
whose rounding carry runs through every digit and wraps away at bit 32.
Tolerance 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.kernels import fused_step
from mktfhe_tpu_torch.ring.context import make_ring_ctx
from mktfhe_tpu_torch.ring.ntt import fwd_ntt
from mktfhe_tpu_torch.ring.torus import lift
from mktfhe_tpu_torch.schemes import kms
from mktfhe_tpu_torch.schemes.params import CggiParams, KmsParams

from test_torch_mx3 import _negacyclic, _times_monomial_minus_one

CPU = torch.device("cpu")
_CGGI = dict(alpha=16.0, f=8, log_d=2, k=1, beta=16.0)


def _exact_digits(a: int, l: int, log_b: int) -> list[int]:
    """Balanced digits of the torus value a (mod 2^32) by their definition:
    v = round(a / 2^low) mod B^l, then the unique digits in [-B/2, B/2) with
    sum d_j B^(l-1-j) == v (mod B^l)."""
    low = 32 - l * log_b
    b = 1 << log_b
    v = a % (1 << 32)
    if low:
        v = (v + (1 << (low - 1))) >> low
    digs = []
    for _ in range(l):
        d = (v + b // 2) % b - b // 2
        v = (v - d) >> log_b
        digs.append(d)
    return digs[::-1]


def _exact_step(acc0, brk, a, l, log_b):
    """acc0 [2, N] ints + (X^a - 1) (digits(acc0) . brk) mod 2^32; brk
    [2, l, 2, N] as signed integers (the balanced lift)."""
    n = len(acc0[0])
    digs = [[_exact_digits(int(v), l, log_b) for v in comp] for comp in acc0]
    out = []
    for cout in range(2):
        e = np.zeros(n, dtype=object)
        for cin in range(2):
            for j in range(l):
                e = e + _negacyclic([digs[cin][i][j] for i in range(n)], [int(v) for v in brk[cin][j][cout]])
        out.append([(int(v) + int(d)) % (1 << 32) for v, d in zip(acc0[cout], _times_monomial_minus_one(e, a))])
    return np.array(out, dtype=np.uint32)


def _brk_bm(brk: np.ndarray, ctx) -> torch.Tensor:
    """Torus-domain RGSW rows [n, 2, l, 2, N] -> `BmScheme.brk_bm` layout."""
    hat = fwd_ntt(lift(torch.from_numpy(brk), ctx.crt), ctx.plan)  # [n, 2, l, 2, npr, N]
    n_bits, cin, l, cout, npr, n = hat.shape
    return hat.permute(0, 4, 1, 2, 3, 5).reshape(n_bits, npr, cin * l, cout, n).contiguous()


ONE_STEP = {
    "cggi_gadget_27_bits": (3, 9),  # the preset's gadget: the rounding carry is live
    "tiny_gadget_24_bits": (3, 8),
    "gadget_32_bits": (4, 8),  # no rounding
    "gadget_2x16": (2, 16),
    "one_digit": (1, 7),
}


@pytest.mark.parametrize("name", list(ONE_STEP))
def test_plain_step_matches_big_integers(name):
    l, log_b = ONE_STEP[name]
    params = CggiParams(n=1, big_n=64, l_gsw=l, log_b_gsw=log_b, **_CGGI)
    ctx = make_ring_ctx(64, 32, 2)
    n = ctx.n
    rng = np.random.default_rng(11)
    amounts = [0, 2 * n - 1, n, n - 3]
    acc0 = rng.integers(-(1 << 31), (1 << 31) - 1, size=(len(amounts), 2, n), dtype=np.int64).astype(np.int32)
    low = 32 - l * log_b
    edge = [0, -1, -(1 << 31), (1 << 31) - 1, 1, 1 << 30, -(1 << 30)]
    if low:  # the rounding bit set under all-ones digit fields: the carry wraps
        edge += [-(1 << (low - 1)), (1 << 31) - (1 << (low - 1)), (1 << (low - 1)) - 1, 1 << (low - 1)]
    acc0[1, 0, : len(edge)] = edge
    acc0[1, 1, : len(edge)] = edge[::-1]
    brk = rng.integers(-(1 << 31), (1 << 31) - 1, size=(1, 2, l, 2, n), dtype=np.int64).astype(np.int32)
    got = fused_step.cggi_step_plain(
        torch.from_numpy(acc0), _brk_bm(brk, ctx)[0], torch.tensor(amounts, dtype=torch.int32),
        kms.monomial_table(ctx, CPU), params, ctx,
    )
    assert got.dtype == torch.int32
    for g, a in enumerate(amounts):
        want = _exact_step(acc0[g], brk[0], a, l, log_b)
        np.testing.assert_array_equal(bridge.to_numpy(got[g]), want)


# --- the wrapper's contract on CPU tensors ---------------------------------

G, STEPS = 3, 4


@pytest.fixture(scope="module")
def small():
    """Random residues at N = 64 (no keygen)."""
    params = CggiParams(n=STEPS, big_n=64, l_gsw=3, log_b_gsw=8, **_CGGI)
    ctx = make_ring_ctx(64, 32, 2)
    rng = np.random.default_rng(5)
    brk = torch.from_numpy(rng.integers(0, 1 << 29, size=(STEPS, 2, 6, 2, 64)).astype(np.int32))
    ta = torch.from_numpy(rng.integers(0, 128, size=(G, STEPS)).astype(np.int32))
    acc = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(G, 2, 64)).astype(np.int32))
    return params, ctx, acc, ta, brk, kms.monomial_table(ctx, CPU)


def test_wrapper_on_cpu_runs_plain_steps(small):
    params, ctx, acc, ta, brk, mono = small
    fused_step.reset_launches()
    keep = acc.clone()
    got = fused_step.cggi_step(acc, ta, brk, mono, params, ctx)
    want = acc
    for i in range(STEPS):
        want = fused_step.cggi_step_plain(want, brk[i], ta[:, i], mono, params, ctx)
    assert got.dtype == torch.int32 and tuple(got.shape) == (G, 2, ctx.n)
    assert torch.equal(got, want) and torch.equal(acc, keep)
    assert fused_step.cggi_step.launches == 0  # only kernel launches count
    # a range in two launches is the range in one
    half = fused_step.cggi_step(acc, ta, brk, mono, params, ctx, 0, 2)
    assert torch.equal(fused_step.cggi_step(half, ta, brk, mono, params, ctx, 2, STEPS), got)
    assert torch.equal(fused_step.cggi_step(acc, ta, brk, mono, params, ctx, 1, 1), acc)


REFUSALS = {
    "acc_int64": (lambda acc, ta, brk, mono: (acc.long(), ta, brk, mono), TypeError),
    "acc_shape": (lambda acc, ta, brk, mono: (acc[:, :1].contiguous(), ta, brk, mono), ValueError),
    "acc_batch_minor": (lambda acc, ta, brk, mono: (acc.permute(1, 2, 0).contiguous(), ta, brk, mono), ValueError),
    "tildea_int64": (lambda acc, ta, brk, mono: (acc, ta.long(), brk, mono), TypeError),
    "tildea_shape": (lambda acc, ta, brk, mono: (acc, ta[:, :-1].contiguous(), brk, mono), ValueError),
    "tildea_strided": (lambda acc, ta, brk, mono: (acc, ta.t().contiguous().t(), brk, mono), ValueError),
    "tildea_negative": (lambda acc, ta, brk, mono: (acc, ta - 1000, brk, mono), ValueError),
    "tildea_2n": (lambda acc, ta, brk, mono: (acc, ta + 128, brk, mono), ValueError),
    "brk_int64": (lambda acc, ta, brk, mono: (acc, ta, brk.long(), mono), TypeError),
    "brk_scheme_layout": (lambda acc, ta, brk, mono: (acc, ta, brk.reshape(STEPS, 2, 3, 2, 2, 64), mono), ValueError),
    "brk_strided": (lambda acc, ta, brk, mono: (acc, ta, brk.transpose(1, 3).contiguous().transpose(1, 3), mono), ValueError),
    "mono_shape": (lambda acc, ta, brk, mono: (acc, ta, brk, mono[:-1]), ValueError),
    "mono_int64": (lambda acc, ta, brk, mono: (acc, ta, brk, mono.long()), TypeError),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_wrapper_refuses_tensors(small, name):
    params, ctx, *tensors = small
    change, error = REFUSALS[name]
    with pytest.raises(error):
        fused_step.cggi_step(*change(*tensors), params, ctx)


def test_wrapper_refuses_ranges(small):
    params, ctx, acc, ta, brk, mono = small
    for i0, i1 in ((-1, 2), (3, 2), (0, STEPS + 1)):
        with pytest.raises(ValueError):
            fused_step.cggi_step(acc, ta, brk, mono, params, ctx, i0, i1)
    with pytest.raises(ValueError):  # seven digits per component
        fused_step.cggi_step(acc, ta, brk, mono, dataclasses.replace(params, l_gsw=7, log_b_gsw=4), ctx)
    with pytest.raises(ValueError):  # 33 bits of digits
        fused_step.cggi_step(acc, ta, brk, mono, dataclasses.replace(params, log_b_gsw=11), ctx)
    with pytest.raises(ValueError):  # N below 64
        fused_step.cggi_step(acc, ta, brk, mono, dataclasses.replace(params, big_n=32), make_ring_ctx(32, 32, 2))
    with pytest.raises(ValueError):  # the 2^64 torus
        fused_step.cggi_step(acc, ta, brk, mono, params, make_ring_ctx(64, 64, 3))
    with pytest.raises(ValueError):  # ring rank 2
        fused_step.cggi_step(acc, ta, brk, mono, dataclasses.replace(params, k=2), ctx)
    kms_params = KmsParams(n=4, alpha=16.0, f=8, log_d=2, big_n=64, beta=4.0, l_gsw=3, log_b_gsw=8,
                           l_lev=2, log_b_lev=8, l_uni=3, log_b_uni=8, k=2)
    with pytest.raises(TypeError):  # parameters of another scheme
        fused_step.cggi_step(acc, ta, brk, mono, kms_params, ctx)
