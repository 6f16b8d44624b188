"""The CUDA kernels against their plain versions, on the card (marker `cuda`).

The NTT kernel at every supported ring size and prime count, forward and
inverse, in the natural and the batch-minor layout (whole and ragged gate
tiles); the phase-1 sweep kernel over ring sizes, prime counts, binary and
block keys, row counts, gadgets and batch sizes; the mx sweep kernel over
ring sizes (nb = 1 to 16), the key's prime counts, row counts, gadgets and
both homes of its power table; the fused CGGI step kernel
over ring sizes, prime counts, gadgets (the 32-bit rounding carry live and
not), step ranges and batch sizes; bit-exact (tolerance 0), plus the
wrappers' contracts on CUDA tensors.  Skips where there is no
CUDA card; this file imports no jax, so on a machine without it run it
without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

from mktfhe_tpu_torch.kernels import fused_mx2, fused_mx3, fused_step
from mktfhe_tpu_torch.kernels import ntt as kntt
from mktfhe_tpu_torch.ring.context import make_ring_ctx
from mktfhe_tpu_torch.ring.modring import prime_column
from mktfhe_tpu_torch.ring.ntt import fwd_ntt, inv_ntt, make_plan
from mktfhe_tpu_torch.schemes import kms
from mktfhe_tpu_torch.schemes.params import CggiParams, KmsBlockParams, KmsParams

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
    # the compiled instances with one row (party 1), and run-time shapes at N = 1024
    (2048, 3, 1, 1, 4, 9, 140),
    (2048, 4, 3, 1, 4, 9, 140),
    (256, 3, 1, 1, 3, 12, 5),
    (1024, 3, 2, 2, 2, 9, 6),
    (1024, 3, 1, 3, 2, 9, 6),
    # the other presets' instances: KMS2party, KMS16party, KMS32party, binary and block
    (2048, 4, 1, 2, 3, 12, 140),
    (2048, 3, 1, 3, 5, 8, 50),
    (2048, 3, 3, 3, 5, 8, 50),
    (2048, 3, 1, 3, 6, 7, 50),
    (2048, 3, 3, 1, 6, 7, 140),
]
# (N, primes, ell, l_gsw) -> the instance compiled for the shape; every other
# case: the kernel with run-time shapes
SWEEP_INSTANCE = {
    (2048, 4, 3, 4): "phase1_sweep_kernel<1,11,4,4,3>",
    (2048, 3, 1, 4): "phase1_sweep_kernel<0,11,4,3,1>",
    (256, 3, 1, 3): "phase1_sweep_kernel<0,8,3,3,1>",
    (2048, 4, 3, 3): "phase1_sweep_kernel<1,11,3,4,3>",
    (2048, 4, 1, 3): "phase1_sweep_kernel<0,11,3,4,1>",
    (2048, 3, 1, 5): "phase1_sweep_kernel<0,11,5,3,1>",
    (2048, 3, 3, 5): "phase1_sweep_kernel<1,11,5,3,3>",
    (2048, 3, 1, 6): "phase1_sweep_kernel<0,11,6,3,1>",
    (2048, 3, 3, 6): "phase1_sweep_kernel<1,11,6,3,3>",
}


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
    run_time = "phase1_sweep_kernel<1,0,0,0,0>" if ell > 1 else "phase1_sweep_kernel<0,0,0,0,1>"
    assert fused_mx3.sweep_kernel(params, ctx)["name"] == SWEEP_INSTANCE.get((n, npr, ell, l), run_time)
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


@pytest.mark.parametrize("shape", [(2048, 4, 3, 3, 4, 9, 2), (2048, 3, 1, 3, 4, 9, 2), (512, 3, 1, 2, 3, 8, 2)],
                         ids=lambda c: "-".join(map(str, c)))
def test_sweep_kernel_is_built_as_described(device, shape):
    """What the dispatcher says of a shape names a kernel that ptxas built,
    and its launch fits the card; the instances of the main paths do not
    spill."""
    from mktfhe_tpu_torch.kernels import _build

    n, npr, ell, rows, l, log_b, g = shape
    params, ctx, *_ = _sweep_inputs(*shape, device)
    kernel = fused_mx3.sweep_kernel(params, ctx)
    said = [u for u in _build.resource_usage(_build.build(fused_mx3.SOURCE)) if u.startswith(kernel["name"] + ":")]
    assert len(said) == 1
    assert kernel["run_time_shapes"] == (n == 512)
    assert kernel["run_time_shapes"] or ", 0 spill bytes" in said[0]
    assert kernel["threads"] == min(n // 2, 512)
    assert kernel["shared_bytes"] <= torch.cuda.get_device_properties(device).shared_memory_per_block_optin


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


# --- the mx sweep kernel -----------------------------------------------------

# (N, primes, rows, l_gsw, log_b_gsw, gates); at N = 2048 the power table lies
# in shared memory up to l_gsw = 6 with 3 primes and in device memory with 4.
MX_CASES = [
    (128, 3, 1, 3, 8, 5),
    (128, 4, 3, 3, 12, 3),
    (128, 2, 2, 6, 7, 4),
    (256, 3, 1, 3, 8, 6),
    (256, 4, 3, 3, 12, 9),
    (512, 3, 2, 1, 9, 4),
    (1024, 3, 3, 4, 9, 7),
    (2048, 3, 3, 4, 9, 50),
    (2048, 3, 1, 4, 9, 140),
    (2048, 4, 3, 3, 12, 10),
    (2048, 3, 2, 6, 8, 4),
    (2048, 4, 2, 6, 7, 4),
    # the compiled instances with the other row counts, and run-time shapes at N = 1024
    (2048, 4, 1, 6, 7, 4),
    (256, 3, 2, 3, 12, 5),
    (256, 3, 1, 3, 12, 5),
    (1024, 4, 1, 2, 9, 6),
    (2048, 3, 3, 5, 8, 50),  # KMS16party's instance
]
# (N, primes, l_gsw) -> the instance compiled for the shape; every other case:
# the kernel with run-time shapes, the power table where it fits
MX_INSTANCE = {
    (2048, 3, 4): "mx_sweep_kernel<1,11,4,3>",
    (256, 3, 3): "mx_sweep_kernel<1,8,3,3>",
    (2048, 4, 6): "mx_sweep_kernel<0,11,6,4>",
    (2048, 4, 3): "mx_sweep_kernel<1,11,3,4>",
    (2048, 3, 6): "mx_sweep_kernel<1,11,6,3>",
    (2048, 3, 5): "mx_sweep_kernel<1,11,5,3>",
}


def _mx_inputs(n, npr, rows, l, log_b, g, device, seed=3):
    """Parameters, the key's context and random inputs: key residues below
    each prime in the mx layout, rotation amounts over all of [0, 2N),
    accumulators over all of 64 bits."""
    params = KmsParams(n=STEPS, big_n=n, l_gsw=l, log_b_gsw=log_b, **_COMMON)
    ctx = make_ring_ctx(n, 64, npr)
    gen = torch.Generator(device=device).manual_seed(seed)
    brk = torch.randint(0, 1 << 62, (STEPS, npr, 2 * l, 2, n), generator=gen, device=device)
    brk = torch.remainder(brk, prime_column(npr, device)[:, None, None]).to(torch.int32)
    ta = torch.randint(0, 2 * n, (g, STEPS), generator=gen, device=device, dtype=torch.int32)
    ta[0, 0], ta[-1, -1] = 0, 2 * n - 1
    acc0 = torch.randint(-(1 << 63), (1 << 63) - 1, (g, rows, 2, n), generator=gen, device=device)
    acc0[0, 0, 0, :4] = torch.tensor([-1, -(1 << 63), (1 << 63) - 1, 0], device=device)
    return params, ctx, ta, brk, acc0


@pytest.mark.parametrize("shape", MX_CASES, ids=lambda c: "-".join(map(str, c)))
def test_mx_sweep_kernel_matches_plain(device, shape):
    n, npr, rows, l, log_b, g = shape
    params, ctx, ta, brk, acc0 = _mx_inputs(*shape, device)
    kernel = fused_mx2.mx_kernel(params, ctx)
    assert kernel["name"] == MX_INSTANCE.get((n, npr, l), f"mx_sweep_kernel<{int(kernel['table_in_shared'])},0,0,0>")
    fused_mx2.reset_launches()
    keep = acc0.clone()
    got = fused_mx2.mx_sweep(ta, brk, rows, params, ctx, acc0=acc0)
    torch.cuda.synchronize()
    assert fused_mx2.mx_sweep.launches == 1
    assert torch.equal(acc0, keep)  # the caller's accumulator is not written
    assert torch.equal(got, fused_mx2.mx_sweep_plain(ta, brk, rows, params, ctx, acc0=acc0))
    # from the LEV gadget rows, and on through the NTT kernel to the lev key
    fresh = fused_mx2.mx_sweep(ta, brk, rows, params, ctx)
    assert torch.equal(fresh, fused_mx2.mx_sweep_plain(ta, brk, rows, params, ctx))
    out_ctx = make_ring_ctx(n, 64, 3)
    levkey = fused_mx2.kms_phase1_mx2(ta, brk, rows, params, out_ctx)
    assert tuple(levkey.shape) == (g, rows, 2, 3, n) and levkey.dtype == torch.int32
    assert fused_mx2.mx_sweep.launches == 3


@pytest.mark.parametrize("shape", [(2048, 3, 3, 4, 9, 2), (2048, 4, 2, 6, 7, 2), (512, 3, 2, 3, 8, 2)],
                         ids=lambda c: "-".join(map(str, c)))
def test_mx_sweep_kernel_is_built_as_described(device, shape):
    """What the dispatcher says of a shape names a kernel that ptxas built,
    and its launch fits the card; the instances do not spill."""
    from mktfhe_tpu_torch.kernels import _build

    n, npr, rows, l, log_b, g = shape
    params, ctx, *_ = _mx_inputs(*shape, device)
    kernel = fused_mx2.mx_kernel(params, ctx)
    said = [u for u in _build.resource_usage(_build.build(fused_mx2.SOURCE)) if u.startswith(kernel["name"] + ":")]
    assert len(said) == 1
    assert kernel["run_time_shapes"] == (n == 512)
    assert kernel["run_time_shapes"] or ", 0 spill bytes" in said[0]
    assert kernel["threads"] == min(n // 2, 512)
    assert kernel["shared_bytes"] <= torch.cuda.get_device_properties(device).shared_memory_per_block_optin


def test_mx_sweep_wrapper_contract_on_cuda(device):
    params, ctx, ta, brk, acc0 = _mx_inputs(128, 3, 2, 3, 8, 4, device)
    fused_mx2.reset_launches()
    with pytest.raises(ValueError):  # keys on another device
        fused_mx2.mx_sweep(ta, brk.cpu(), 2, params, ctx)
    with pytest.raises(ValueError):
        fused_mx2.mx_sweep(ta, brk, 2, params, ctx, acc0=acc0.cpu())
    with pytest.raises(ValueError):  # amounts outside [0, 2N)
        fused_mx2.mx_sweep(ta + 2 * ctx.n, brk, 2, params, ctx)
    with pytest.raises(ValueError):
        fused_mx2.mx_sweep(ta.t().contiguous().t(), brk, 2, params, ctx)
    with pytest.raises(TypeError):
        fused_mx2.mx_sweep(ta.long(), brk, 2, params, ctx)
    with pytest.raises(ValueError):  # the key's primes are not the context's
        fused_mx2.mx_sweep(ta, brk, 2, params, make_ring_ctx(128, 64, 4))
    with pytest.raises(ValueError):  # seven digits per component
        fused_mx2.mx_sweep(ta, brk, 2, dataclasses.replace(params, l_gsw=7), ctx)
    assert fused_mx2.mx_sweep.launches == 0
    empty = fused_mx2.mx_sweep(ta[:0], brk, 2, params, ctx)
    assert tuple(empty.shape) == (0, 2, 2, ctx.n) and fused_mx2.mx_sweep.launches == 0


# --- the batch-minor NTT kernel ----------------------------------------------


def _bm_residues(npr, rows, n, gates, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, 1 << 31, (npr, rows, n, gates), generator=gen, device=device)
    return torch.remainder(x, prime_column(npr, device)[:, :, None, None]).to(torch.int32)


@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024, 2048])
@pytest.mark.parametrize("npr", [2, 3, 4])
def test_bm_kernel_matches_plain(device, n, npr):
    """19 gates: two whole tiles of 8 and a ragged one of 3."""
    plan = make_plan(n, npr)
    x = _bm_residues(npr, 3, n, 19, device, seed=n + npr)
    kntt.reset_launches()
    hat = kntt.fwd_ntt_bm(x, plan)
    assert torch.equal(hat, kntt.ntt_bm_plain(x, plan, True))
    assert torch.equal(kntt.inv_ntt_bm(x, plan), kntt.ntt_bm_plain(x, plan, False))
    assert torch.equal(kntt.inv_ntt_bm(hat, plan), x)
    assert (kntt.fwd_ntt_bm.launches, kntt.inv_ntt_bm.launches) == (1, 2)
    # the same data through the natural-layout kernel
    nat = kntt.fwd_ntt_nat(x.permute(1, 3, 0, 2).contiguous(), plan)
    assert torch.equal(hat, nat.permute(2, 0, 3, 1))


@pytest.mark.parametrize("gates", [1, 5, 8, 256, 257])
def test_bm_kernel_any_batch(device, gates):
    plan = make_plan(1024, 2)
    x = _bm_residues(2, 6, 1024, gates, device, seed=gates)
    assert torch.equal(kntt.fwd_ntt_bm(x, plan), kntt.ntt_bm_plain(x, plan, True))
    assert torch.equal(kntt.inv_ntt_bm(x, plan), kntt.ntt_bm_plain(x, plan, False))


def test_bm_wrapper_contract_on_cuda(device):
    plan = make_plan(64, 2)
    x = _bm_residues(2, 3, 64, 5, device, seed=0)
    kntt.reset_launches()
    with pytest.raises(ValueError):
        kntt.fwd_ntt_bm(x.transpose(1, 3).contiguous().transpose(1, 3), plan)
    with pytest.raises(ValueError):
        kntt.fwd_ntt_bm(_bm_residues(2, 3, 32, 5, device, seed=0), make_plan(32, 2))
    with pytest.raises(TypeError):
        kntt.inv_ntt_bm(x.long(), plan)
    assert kntt.fwd_ntt_bm(x[:, :0], plan).shape == (2, 0, 64, 5)
    assert (kntt.fwd_ntt_bm.launches, kntt.inv_ntt_bm.launches) == (0, 0)


# --- the fused CGGI step kernel ----------------------------------------------

_CGGI = dict(alpha=16.0, f=8, log_d=2, k=1, beta=16.0)
# (N, primes, l_gsw, log_b_gsw, steps, first, last, gates); at the CGGI preset's
# widths 140 gates leave SMs idle and 600 run several waves.
STEP_CASES = [
    (64, 2, 3, 9, 4, 0, 4, 3),
    (64, 2, 3, 8, 4, 2, 3, 5),
    (64, 2, 4, 8, 3, 0, 3, 2),
    (64, 3, 2, 16, 2, 0, 2, 2),
    (128, 3, 6, 5, 3, 1, 3, 4),
    (256, 4, 1, 7, 3, 0, 3, 7),
    (1024, 2, 3, 9, 5, 0, 5, 140),
    (1024, 2, 3, 9, 3, 1, 2, 600),
    (2048, 4, 6, 5, 2, 0, 2, 9),
    (2048, 2, 3, 10, 2, 0, 2, 200),
]


def _step_inputs(n, npr, l, log_b, steps, g, device, seed=2):
    """Parameters, context and random inputs: key residues below each prime,
    rotation amounts over all of [0, 2N), accumulators over all of 32 bits."""
    params = CggiParams(n=steps, big_n=n, l_gsw=l, log_b_gsw=log_b, **_CGGI)
    ctx = make_ring_ctx(n, 32, npr)
    gen = torch.Generator(device=device).manual_seed(seed)
    brk = torch.randint(0, 1 << 62, (steps, npr, 2 * l, 2, n), generator=gen, device=device)
    brk = torch.remainder(brk, prime_column(npr, device)[:, None, None]).to(torch.int32)
    ta = torch.randint(0, 2 * n, (g, steps), generator=gen, device=device, dtype=torch.int32)
    ta[0, 0], ta[-1, -1] = 0, 2 * n - 1
    mono = kms.monomial_table(ctx, device)
    acc = torch.randint(-(1 << 31), 1 << 31, (g, 2, n), generator=gen, device=device, dtype=torch.int32)
    low = 32 - l * log_b
    edge = [0, -1, -(1 << 31), (1 << 31) - 1] + ([-(1 << (low - 1)), (1 << 31) - (1 << (low - 1))] if low else [])
    acc[0, 0, : len(edge)] = torch.tensor(edge, dtype=torch.int32, device=device)
    return params, ctx, ta, brk, mono, acc


@pytest.mark.parametrize("shape", STEP_CASES, ids=lambda c: "-".join(map(str, c)))
def test_step_kernel_matches_plain(device, shape):
    n, npr, l, log_b, steps, i0, i1, g = shape
    params, ctx, ta, brk, mono, acc = _step_inputs(n, npr, l, log_b, steps, g, device)
    fused_step.reset_launches()
    keep = acc.clone()
    got = fused_step.cggi_step(acc, ta, brk, mono, params, ctx, i0, i1)
    torch.cuda.synchronize()
    assert fused_step.cggi_step.launches == 1
    assert torch.equal(acc, keep)  # the caller's accumulator is not written
    want = acc
    for i in range(i0, i1):
        want = fused_step.cggi_step_plain(want, brk[i], ta[:, i], mono, params, ctx)
    assert torch.equal(got, want)
    # one launch per step gives the same as one launch over the range
    by_step = acc
    for i in range(i0, i1):
        by_step = fused_step.cggi_step(by_step, ta, brk, mono, params, ctx, i, i + 1)
    assert torch.equal(by_step, got)
    assert fused_step.cggi_step.launches == 1 + (i1 - i0)


def test_step_wrapper_contract_on_cuda(device):
    params, ctx, ta, brk, mono, acc = _step_inputs(64, 2, 3, 8, 4, 4, device)
    fused_step.reset_launches()
    with pytest.raises(ValueError):  # keys on another device
        fused_step.cggi_step(acc, ta, brk.cpu(), mono, params, ctx)
    with pytest.raises(ValueError):
        fused_step.cggi_step(acc, ta, brk, mono.cpu(), params, ctx)
    with pytest.raises(ValueError):  # amounts outside [0, 2N)
        fused_step.cggi_step(acc, ta + 2 * ctx.n, brk, mono, params, ctx)
    with pytest.raises(ValueError):
        fused_step.cggi_step(acc, ta.t().contiguous().t(), brk, mono, params, ctx)
    with pytest.raises(TypeError):
        fused_step.cggi_step(acc, ta.long(), brk, mono, params, ctx)
    with pytest.raises(ValueError):  # steps beyond the key
        fused_step.cggi_step(acc, ta, brk, mono, params, ctx, 0, 5)
    with pytest.raises(ValueError):  # 36 bits of digits
        fused_step.cggi_step(acc, ta, brk, mono, dataclasses.replace(params, log_b_gsw=12), ctx)
    assert fused_step.cggi_step.launches == 0
    same = fused_step.cggi_step(acc, ta, brk, mono, params, ctx, 2, 2)
    empty = fused_step.cggi_step(acc[:0], ta[:0], brk, mono, params, ctx)
    assert torch.equal(same, acc) and tuple(empty.shape) == (0, 2, ctx.n)
    assert fused_step.cggi_step.launches == 0


def test_butterfly_rate_kernel_on_cuda(device):
    """The measuring kernel of csrc/butterfly_rate.cu launches at both
    occupancies and gives the same residues whatever the grid."""
    from mktfhe_tpu_torch.tools import butterfly_rate

    for forward in (True, False):
        one = butterfly_rate.run(device, forward, 5, 2, butterfly_rate.ONE_CTA_PER_SM)
        many = butterfly_rate.run(device, forward, 5, 4, 0)
        torch.cuda.synchronize()
        assert tuple(one.shape) == (2 * butterfly_rate.THREADS, 8)
        assert torch.equal(one, many[: one.shape[0]])
        assert int(one.min()) >= 0  # canonical residues below a 30-bit prime
    rate = butterfly_rate.measure(device, rounds=200)
    assert all(rate[k] > 0 for k in ("fwd_one_cta", "fwd_full", "inv_one_cta", "inv_full"))
