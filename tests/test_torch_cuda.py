"""The CUDA kernels against their plain versions, on the card (marker `cuda`).

The NTT kernel at every supported ring size and prime count, forward and
inverse, and the phase-1 sweep kernel over ring sizes, prime counts, binary
and block keys, row counts, gadgets and batch sizes; bit-exact (tolerance
0), plus the wrappers' contracts on CUDA tensors.  Skips where there is no
CUDA card; this file imports no jax, so on a machine without it run it
without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

from mktfhe_tpu_torch.kernels import fused_mx3
from mktfhe_tpu_torch.kernels import ntt as kntt
from mktfhe_tpu_torch.ring.context import make_ring_ctx
from mktfhe_tpu_torch.ring.modring import prime_column
from mktfhe_tpu_torch.ring.ntt import fwd_ntt, inv_ntt, make_plan
from mktfhe_tpu_torch.schemes import kms
from mktfhe_tpu_torch.schemes.params import KmsBlockParams, KmsParams

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _residues(shape, npr, n, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, 1 << 31, (*shape, npr, n), generator=gen, device=device)
    return torch.remainder(x, prime_column(npr, device)).to(torch.int32)


@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024, 2048])
@pytest.mark.parametrize("npr", [2, 3, 4])
def test_kernel_matches_twin(device, n, npr):
    plan = make_plan(n, npr)
    x = _residues((3, 5), npr, n, device, seed=n + npr)
    kntt.reset_launches()
    hat = kntt.fwd_ntt_nat(x, plan)
    assert torch.equal(hat, fwd_ntt(x, plan))
    back = kntt.inv_ntt_nat(x, plan)
    assert torch.equal(back, inv_ntt(x, plan))
    assert torch.equal(kntt.inv_ntt_nat(hat, plan), x)
    assert (kntt.fwd_ntt_nat.launches, kntt.inv_ntt_nat.launches) == (1, 2)


def test_wrapper_contract_on_cuda(device):
    plan = make_plan(64, 2)
    x = _residues((4,), 2, 64, device, seed=0)
    with pytest.raises(ValueError):
        kntt.fwd_ntt_nat(x.transpose(0, 1).contiguous().transpose(0, 1), plan)
    with pytest.raises(ValueError):
        kntt.fwd_ntt_nat(_residues((4,), 2, 32, device, seed=0), make_plan(32, 2))
    assert kntt.fwd_ntt_nat(x[:0], plan).shape == (0, 2, 64)


# --- the phase-1 sweep kernel ------------------------------------------------

_COMMON = dict(alpha=16.0, f=8, log_d=2, beta=4.0, l_lev=3, log_b_lev=6, l_uni=3, log_b_uni=8, k=2)
STEPS = 3
# (N, primes, ell, rows, l_gsw, log_b_gsw, gates); at N = 2048 one CTA fills
# an SM: 10 x 3 CTAs leave most of the card idle, 50 x 3 and 140 overfill it.
SWEEP_CASES = [
    (64, 2, 1, 1, 3, 8, 5),
    (64, 3, 3, 3, 4, 9, 7),
    (64, 4, 1, 3, 4, 16, 3),
    (256, 3, 1, 3, 3, 12, 9),
    (256, 4, 3, 1, 5, 8, 6),
    (256, 2, 2, 2, 1, 9, 4),
    (2048, 3, 1, 3, 4, 9, 50),
    (2048, 4, 3, 3, 4, 9, 10),
    (2048, 4, 3, 1, 3, 12, 140),
    (2048, 2, 1, 1, 6, 8, 3),
    (2048, 4, 1, 2, 6, 7, 4),
]


def _sweep_inputs(n, npr, ell, rows, l, log_b, g, device, seed=1):
    """Parameters, context and random inputs: key residues below each prime,
    rotation amounts over all of [0, 2N), accumulators over all of 64 bits."""
    if ell == 1:
        params = KmsParams(n=STEPS, big_n=n, l_gsw=l, log_b_gsw=log_b, **_COMMON)
    else:
        params = KmsBlockParams(d=STEPS, ell=ell, big_n=n, l_gsw=l, log_b_gsw=log_b, **_COMMON)
    ctx = make_ring_ctx(n, 64, npr)
    gen = torch.Generator(device=device).manual_seed(seed)
    brk = torch.randint(0, 1 << 62, (params.n, 2, l, 2, npr, n), generator=gen, device=device)
    brk = torch.remainder(brk, prime_column(npr, device)).to(torch.int32)
    ta = torch.randint(0, 2 * n, (g, params.n), generator=gen, device=device, dtype=torch.int32)
    ta[0, 0], ta[-1, -1] = 0, 2 * n - 1
    mono = kms.monomial_table(ctx, device) if ell > 1 else None
    acc0 = torch.randint(-(1 << 63), (1 << 63) - 1, (g, rows, 2, n), generator=gen, device=device)
    acc0[0, 0, 0, :4] = torch.tensor([-1, -(1 << 63), (1 << 63) - 1, 0], device=device)
    return params, ctx, ta, brk, mono, acc0


@pytest.mark.parametrize("shape", SWEEP_CASES, ids=lambda c: "-".join(map(str, c)))
def test_sweep_kernel_matches_plain(device, shape):
    n, npr, ell, rows, l, log_b, g = shape
    params, ctx, ta, brk, mono, acc0 = _sweep_inputs(*shape, device)
    fused_mx3.reset_launches()
    keep = acc0.clone()
    got = fused_mx3.phase1_sweep(ta, brk, rows, mono, params, ctx, acc0=acc0)
    torch.cuda.synchronize()
    assert fused_mx3.phase1_sweep.launches == 1
    assert torch.equal(acc0, keep)  # the caller's accumulator is not written
    assert torch.equal(got, fused_mx3.phase1_sweep_plain(ta, brk, rows, mono, params, ctx, acc0=acc0))
    # from the LEV gadget rows, and on through the NTT kernel to the lev key
    fresh = fused_mx3.phase1_sweep(ta, brk, rows, mono, params, ctx)
    assert torch.equal(fresh, fused_mx3.phase1_sweep_plain(ta, brk, rows, mono, params, ctx))
    levkey = fused_mx3.kms_phase1_mx3(ta, brk, rows, mono, params, ctx)
    assert tuple(levkey.shape) == (g, rows, 2, npr, n) and levkey.dtype == torch.int32
    assert fused_mx3.phase1_sweep.launches == 3


def test_sweep_wrapper_contract_on_cuda(device):
    params, ctx, ta, brk, mono, acc0 = _sweep_inputs(64, 3, 3, 2, 3, 8, 4, device)
    fused_mx3.reset_launches()
    with pytest.raises(ValueError):  # keys on another device
        fused_mx3.phase1_sweep(ta, brk.cpu(), 2, mono, params, ctx)
    with pytest.raises(ValueError):
        fused_mx3.phase1_sweep(ta, brk, 2, mono.cpu(), params, ctx)
    with pytest.raises(ValueError):  # amounts outside [0, 2N)
        fused_mx3.phase1_sweep(ta + 2 * ctx.n, brk, 2, mono, params, ctx)
    with pytest.raises(ValueError):
        fused_mx3.phase1_sweep(ta.t().contiguous().t(), brk, 2, mono, params, ctx)
    with pytest.raises(TypeError):
        fused_mx3.phase1_sweep(ta.long(), brk, 2, mono, params, ctx)
    with pytest.raises(ValueError):  # seven digits per component
        fused_mx3.phase1_sweep(ta, brk, 2, mono, dataclasses.replace(params, l_gsw=7), ctx)
    assert fused_mx3.phase1_sweep.launches == 0
    empty = fused_mx3.phase1_sweep(ta[:0], brk, 2, mono, params, ctx)
    assert tuple(empty.shape) == (0, 2, 2, ctx.n) and fused_mx3.phase1_sweep.launches == 0
