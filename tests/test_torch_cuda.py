"""The CUDA kernels against their plain versions, on the card (marker `cuda`).

The NTT kernel at every supported ring size and prime count, forward and
inverse, in the natural and the batch-minor layout (whole and ragged gate
tiles); the phase-1 sweep kernel over ring sizes, prime counts, binary and
block keys, row counts, gadgets and batch sizes, and at every KMS preset
through its compiled instance over all of the preset's steps (the mx sweep
too, at the binary presets); every party's sweep in one launch
(`phase1_sweeps`) against k one-party launches at KMS8partyblock and
KMS32partyblock, G = 8, and `bootstrap_mx3`'s one sweep launch of k
parties; phase 2's hybrid product kernel at the last
merge of KMS8partyblock and KMS32partyblock and at merge 1 (the crs alone),
replayed from a graph too, and launched once a merge by every KMS engine;
the mx sweep kernel over
ring sizes (nb = 1 to 16), the key's prime counts, row counts, gadgets and
both homes of its power table; the fused CGGI step kernel
over ring sizes, prime counts, gadgets (the 32-bit rounding carry live and
not), step ranges and batch sizes; bit-exact (tolerance 0), plus the
wrappers' contracts on CUDA tensors and each dispatcher's instance as ptxas
built it.  Then LMSS, CCS, `utils.load`, `utils.noise` and the sharded
bootstrap in two gloo ranks sharing the card, each against the CPU at the
tiny sets.  Then every engine's bootstrap captured as a CUDA graph
(graphs.py) at a tiny set: graph == eager bit for bit, over a dependent
chain too; the launch counts of replays == the eager call's; no
synchronizing call in an eager bootstrap (`set_sync_debug_mode("error")`);
the graph's refusals on the card.  Then the block sweep and the CGGI step at
rotation amounts outside [0, 2N) (== their plain versions at the amounts
mod 2N); the sharded bootstrap captured (`graphs.capture_sharded`) in one
NCCL rank (one graph, collectives included, replayed with no sync) and in
two gloo ranks (a graph a segment): graph == eager == `kms.bootstrap`,
launches equal; and the named ranges timed by CUDA events
(`profiling.event_ranges`): they add up to the bootstrap's event time, and
a capture records none.  Then the ranges inside a graph captured with
ranges=True: an external event pair times a B1 launch as eager events do,
`range_ms()` names the eager ranges and adds up to the replay's event time,
the bits are those of the graph without ranges, which holds no event node;
and a replay's host spans.  Last, KMS8party on the mx engine through the
normal path: `fused_mx2.setup`'s scheme (no `brk_hat`), its set-up range,
and a replay of `bootstrap_mx2` at G = 128 == eager `bootstrap_mx2` ==
`bootstrap_mx3`, with its launch counts.  Skips where there is no
CUDA card; this file imports no jax, so on a machine without it run it
without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import statistics

import pytest
import torch

from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.ciphertext.lwe import Lwe
from mktfhe_tpu_torch.kernels import fused_mx2, fused_mx3, fused_step
from mktfhe_tpu_torch.kernels import hybrid_product as khybrid
from mktfhe_tpu_torch.kernels import ntt as kntt
from mktfhe_tpu_torch.ring.context import make_ring_ctx
from mktfhe_tpu_torch.ring.modring import PRIMES, prime_column
from mktfhe_tpu_torch.ring.ntt import fwd_ntt, inv_ntt, make_plan
from mktfhe_tpu_torch.schemes import ccs, gates, kms, lmss, presets
from mktfhe_tpu_torch.parallel.launch import Job, bootstrap_jobs, run_ranks
from mktfhe_tpu_torch.schemes.params import BlockParams, CcsParams, CggiParams, KmsBlockParams, KmsParams
from mktfhe_tpu_torch.schemes.presets import TEST_PRESETS
from mktfhe_tpu_torch.utils import load, noise, save

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


@pytest.mark.parametrize("rows,npr,n", [(3072, 4, 2048), (700, 3, 1024), (3001, 2, 64)])
def test_kernel_goes_round_the_tiles(device, rows, npr, n):
    """More tiles than the card holds CTAs at once: each CTA takes tile after
    tile with the next one arriving in its second buffer (the last tile of a
    prime ragged at N = 64)."""
    plan = make_plan(n, npr)
    x = _residues((rows,), npr, n, device, seed=rows)
    assert torch.equal(kntt.fwd_ntt_nat(x, plan), fwd_ntt(x, plan))
    assert torch.equal(kntt.inv_ntt_nat(x, plan), inv_ntt(x, plan))


@pytest.mark.parametrize("rows", [8 * 17 * 12, 8 * 2 * 12, 8 * 12, 8 * 17, 8 * 2])
def test_kernel_ccs16party_shapes(device, rows):
    """The natural NTT at the shapes `ccs.bootstrap` launches at CCS16party
    (N = 1024, 2 primes) for 8 gates: party p1's digits of p1 + 1
    components (p1 = 16 and 1), the digit sum of G^-1(v), and the inverses
    of p1 + 1 components; both ways against the twin."""
    plan = make_plan(1024, 2)
    x = _residues((rows,), 2, 1024, device, seed=rows)
    hat = kntt.fwd_ntt_nat(x, plan)
    assert torch.equal(hat, fwd_ntt(x, plan))
    assert torch.equal(kntt.inv_ntt_nat(x, plan), inv_ntt(x, plan))
    assert torch.equal(kntt.inv_ntt_nat(hat, plan), x)


@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024, 2048])
def test_kernel_is_built_as_described(device, n):
    """The dispatcher's instance for N, both directions, is a kernel that
    ptxas built, without spills."""
    from mktfhe_tpu_torch.kernels import _build

    usage = _build.resource_usage(_build.build(kntt.SOURCE))
    for forward in (True, False):
        kernel = kntt.nat_kernel(n, forward)
        said = [u for u in usage if u.startswith(kernel["name"] + ":")]
        assert len(said) == 1 and ", 0 spill bytes" in said[0], said


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
    levkey = kms.levkey_lift(fused_mx3._sweep(ta, brk, rows, mono, params, ctx), ctx)
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



# --- the hybrid product kernel (phase 2) ---------------------------------------

HYBRID_PRESETS = {"KMS32partyblock": presets.KMS_32PARTY_BLOCK, "KMS8partyblock": presets.KMS_8PARTY_BLOCK}
HYBRID_INSTANCE = {"KMS32partyblock": "hybrid_product_kernel<11,16,3>",
                   "KMS8partyblock": "hybrid_product_kernel<11,8,4>"}


def _hybrid_inputs(params, p1: int, g: int, device, seed: int = 7):
    """A merge's inputs at the preset's shapes: y over all 64 bits, the
    keys as residues."""
    ctx = kms._ctx(params)
    gen = torch.Generator(device=device).manual_seed(seed)
    y = torch.randint(-(1 << 63), (1 << 63) - 1, (g, p1, ctx.n), generator=gen, device=device)
    y[0, 0, :4] = torch.tensor([-1, -(1 << 63), (1 << 63) - 1, 0], device=device)
    l = params.l_uni
    rd, pub, crs = (_residues(lead, ctx.nprimes, ctx.n, device, seed + i)
                    for i, lead in enumerate(((l,), (p1 - 1, l), (l,))))
    return ctx, y, rd, pub, crs


@pytest.mark.parametrize("name,p1,g", [("KMS32partyblock", 32, 128), ("KMS32partyblock", 1, 128),
                                       ("KMS8partyblock", 8, 128), ("KMS8partyblock", 1, 128),
                                       ("KMS8partyblock", 8, 8)], ids=lambda c: str(c))
def test_hybrid_kernel_matches_plain(device, name, p1, g):
    """Merge p1 of the preset at batch g through the preset's instance, one
    launch, against the plain version (its digits through B1 in chunks of
    parties): the same residues, tolerance 0."""
    params = HYBRID_PRESETS[name]
    ctx, y, rd, pub, crs = _hybrid_inputs(params, p1, g, device)
    assert khybrid.hybrid_kernel(params, ctx)["name"] == HYBRID_INSTANCE[name]
    khybrid.reset_launches()
    u, v = khybrid.hybrid_product(y, rd, pub, crs, params, ctx)
    torch.cuda.synchronize()
    assert khybrid.hybrid_product.launches == 1
    assert u.dtype == v.dtype == torch.int32
    assert tuple(u.shape) == (g, p1, ctx.nprimes, ctx.n) and tuple(v.shape) == (g, ctx.nprimes, ctx.n)
    want_u, want_v = kms._hybrid_product(y, rd, pub, crs, params, ctx, prime_column(ctx.nprimes, device))
    assert torch.equal(u.long(), want_u) and torch.equal(v.long(), want_v)


@pytest.mark.parametrize("name", [*HYBRID_PRESETS, "run-time N=512"])
def test_hybrid_kernel_is_built_as_described(device, name):
    """What the dispatcher says of a shape names a kernel that ptxas built,
    and its launch fits the card; the presets' instances do not spill."""
    from mktfhe_tpu_torch.kernels import _build

    params = HYBRID_PRESETS.get(name, dataclasses.replace(presets.KMS_8PARTY_BLOCK, big_n=512))
    ctx = kms._ctx(params)
    kernel = khybrid.hybrid_kernel(params, ctx)
    said = [u for u in _build.resource_usage(_build.build(khybrid.SOURCE)) if u.startswith(kernel["name"] + ":")]
    assert len(said) == 1
    assert kernel["run_time_shapes"] == (name not in HYBRID_PRESETS)
    assert kernel["run_time_shapes"] or ", 0 spill bytes" in said[0]
    assert kernel["threads"] == min(ctx.n // 2, 512)
    assert kernel["shared_bytes"] <= torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    # and the run-time kernel computes what the instance does
    if name == "run-time N=512":
        ctx, y, rd, pub, crs = _hybrid_inputs(params, 3, 4, device)
        u, v = khybrid.hybrid_product(y, rd, pub, crs, params, ctx)
        want_u, want_v = kms._hybrid_product(y, rd, pub, crs, params, ctx, prime_column(ctx.nprimes, device))
        assert torch.equal(u.long(), want_u) and torch.equal(v.long(), want_v)


def test_hybrid_kernel_replays_from_a_graph(device):
    """Captured into a CUDA graph (its wrapper reads no value back), a
    replay computes the eager residues, for the captured input and for a
    new one copied into it."""
    params = presets.KMS_8PARTY_BLOCK
    ctx, y, rd, pub, crs = _hybrid_inputs(params, 8, 8, device)
    want = khybrid.hybrid_product(y, rd, pub, crs, params, ctx)  # warm-up: the tables
    static_y = y.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        u, v = khybrid.hybrid_product(static_y, rd, pub, crs, params, ctx)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(u, want[0]) and torch.equal(v, want[1])
    y2 = _hybrid_inputs(params, 8, 8, device, seed=8)[1]
    static_y.copy_(y2)
    graph.replay()
    torch.cuda.synchronize()
    want2 = khybrid.hybrid_product(y2, rd, pub, crs, params, ctx)
    assert torch.equal(u, want2[0]) and torch.equal(v, want2[1]) and not torch.equal(u, want[0])


def test_hybrid_wrapper_contract_on_cuda(device):
    params = presets.KMS_8PARTY_BLOCK
    ctx, y, rd, pub, crs = _hybrid_inputs(params, 3, 4, device)
    khybrid.reset_launches()
    with pytest.raises(ValueError):  # a key on the CPU, y_t on the card
        khybrid.hybrid_product(y, rd.cpu(), pub, crs, params, ctx)
    with pytest.raises(ValueError):
        khybrid.hybrid_product(y, rd, pub, crs.cpu(), params, ctx)
    with pytest.raises(TypeError):
        khybrid.hybrid_product(y.int(), rd, pub, crs, params, ctx)
    with pytest.raises(TypeError):
        khybrid.hybrid_product(y, rd, pub.long(), crs, params, ctx)
    with pytest.raises(ValueError):  # one public key short of the merge
        khybrid.hybrid_product(y, rd, pub[:-1], crs, params, ctx)
    with pytest.raises(ValueError):
        khybrid.hybrid_product(y.transpose(0, 1).contiguous().transpose(0, 1), rd, pub, crs, params, ctx)
    with pytest.raises(ValueError):  # seventeen digits would overflow the unreduced sum
        khybrid.hybrid_product(y, rd, pub, crs, dataclasses.replace(params, l_uni=17), ctx)
    assert khybrid.hybrid_product.launches == 0
    u, v = khybrid.hybrid_product(y[:0], rd, pub, crs, params, ctx)
    assert tuple(u.shape) == (0, 3, ctx.nprimes, ctx.n) and tuple(v.shape) == (0, ctx.nprimes, ctx.n)
    assert khybrid.hybrid_product.launches == 0


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


# --- every KMS preset's sweeps, whole -----------------------------------------

# the KMS presets at full width (schemes/presets.py), each served by a compiled
# instance of each sweep it runs
KMS_FULL = {name: p for name, p in vars(presets).items()
            if isinstance(p, (KmsParams, KmsBlockParams)) and p.big_n == 2048}
WHOLE_GATES = 8


def _preset_inputs(params, npr, key_shape, prime_axis, device, seed):
    """Random key residues of `key_shape`, below the prime of their index on
    `prime_axis`, and rotation amounts over all of [0, 2N) for WHOLE_GATES
    gates."""
    gen = torch.Generator(device=device).manual_seed(seed)
    keys = torch.randint(0, 1 << 62, key_shape, generator=gen, device=device)
    column = prime_column(npr, device).reshape(npr, *[1] * (len(key_shape) - prime_axis - 1))
    keys = torch.remainder(keys, column).to(torch.int32)
    ta = torch.randint(0, 2 * params.big_n, (WHOLE_GATES, params.n), generator=gen, device=device, dtype=torch.int32)
    ta[0, 0], ta[-1, -1] = 0, 2 * params.big_n - 1
    return keys, ta


@pytest.mark.parametrize("name", sorted(KMS_FULL))
def test_sweep_kernel_whole_preset(device, name):
    """A preset's phase-1 sweep through the instance compiled for it (never
    the kernel with run-time shapes), all of its steps, l_lev rows, against
    the plain version on random keys."""
    params = KMS_FULL[name]
    ctx = kms._ctx(params)
    assert not fused_mx3.sweep_kernel(params, ctx)["run_time_shapes"]
    brk, ta = _preset_inputs(params, ctx.nprimes, (params.n, 2, params.l_gsw, 2, ctx.nprimes, ctx.n), 4, device,
                             seed=params.k)
    mono = kms.monomial_table(ctx, device) if isinstance(params, KmsBlockParams) else None
    fused_mx3.reset_launches()
    got = fused_mx3.phase1_sweep(ta, brk, params.l_lev, mono, params, ctx)
    assert fused_mx3.phase1_sweep.launches == 1
    assert torch.equal(got, fused_mx3.phase1_sweep_plain(ta, brk, params.l_lev, mono, params, ctx))


def _party_keys(params, ctx, device, seed) -> torch.Tensor:
    """Every party's brk_hat [k, n, 2, l, 2, npr, N] of random residues
    below each prime, drawn a (party, prime) at a time."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (params.k, params.n, 2, params.l_gsw, 2, ctx.nprimes, ctx.n)
    keys = torch.empty(shape, dtype=torch.int32, device=device)
    for party in range(params.k):
        for q, p in enumerate(PRIMES[: ctx.nprimes]):
            keys[party, :, :, :, :, q] = torch.randint(0, p, (*shape[1:5], ctx.n), generator=gen, device=device,
                                                       dtype=torch.int32)
    return keys


@pytest.mark.parametrize("name", ["KMS_8PARTY_BLOCK", "KMS_32PARTY_BLOCK"])
def test_multi_party_sweep_equals_one_launch_a_party(device, name):
    """Every party's sweep in one launch over (party, gate, row), party 1
    one row, the others l_lev, at G = 8 through the preset's instance: each
    party's accumulator == its own `phase1_sweep` launch, bit for bit, and
    the launch counts one launch of k parties."""
    params = KMS_FULL[name]
    ctx = kms._ctx(params)
    brk = _party_keys(params, ctx, device, seed=params.k + 2)
    gen = torch.Generator(device=device).manual_seed(params.k + 3)
    ta = torch.randint(0, 2 * ctx.n, (WHOLE_GATES, params.k * params.n), generator=gen, device=device,
                       dtype=torch.int32)
    ta[0, 0], ta[-1, -1] = 0, 2 * ctx.n - 1
    mono = kms.monomial_table(ctx, device)
    fused_mx3.reset_launches()
    got = fused_mx3.phase1_sweeps(ta, brk, params.l_lev, mono, params, ctx)
    assert (fused_mx3.phase1_sweep.launches, fused_mx3.phase1_sweep.parties) == (1, params.k)
    tild = ta.reshape(WHOLE_GATES, params.k, params.n)
    for party in range(params.k):
        rows = 1 if party == 0 else params.l_lev
        want = fused_mx3.phase1_sweep(tild[:, party].contiguous(), brk[party], rows, mono, params, ctx)
        assert torch.equal(got[party], want), f"party {party + 1}"
    assert (fused_mx3.phase1_sweep.launches, fused_mx3.phase1_sweep.parties) == (1 + params.k, 2 * params.k)


@pytest.mark.parametrize("name", sorted(n for n, p in KMS_FULL.items() if not isinstance(p, KmsBlockParams)))
def test_mx_sweep_kernel_whole_preset(device, name):
    """A binary preset's mx sweep on keys over `mx_nprimes` primes through
    the instance compiled for it, all of its steps, l_lev rows, against
    `mx_sweep_plain`."""
    params = KMS_FULL[name]
    npr = fused_mx2.mx_nprimes(params)
    ctx = make_ring_ctx(params.big_n, params.ring_torus_bits, npr)
    assert not fused_mx2.mx_kernel(params, ctx)["run_time_shapes"]
    brk, ta = _preset_inputs(params, npr, (params.n, npr, 2 * params.l_gsw, 2, ctx.n), 1, device, seed=params.k + 1)
    fused_mx2.reset_launches()
    got = fused_mx2.mx_sweep(ta, brk, params.l_lev, params, ctx)
    assert fused_mx2.mx_sweep.launches == 1
    assert torch.equal(got, fused_mx2.mx_sweep_plain(ta, brk, params.l_lev, params, ctx))


# --- the batch-minor NTT kernel ----------------------------------------------


def _bm_residues(npr, rows, n, gates, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, 1 << 31, (npr, rows, n, gates), generator=gen, device=device)
    return torch.remainder(x, prime_column(npr, device)[:, :, None, None]).to(torch.int32)


@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024, 2048])
@pytest.mark.parametrize("npr", [2, 3, 4])
def test_bm_kernel_matches_plain(device, n, npr):
    """19 gates: four whole tiles of 4 and a ragged one of 3, rows not 16-byte
    aligned (word-by-word copies); launches counted by shape."""
    plan = make_plan(n, npr)
    x = _bm_residues(npr, 3, n, 19, device, seed=n + npr)
    kntt.reset_launches()
    hat = kntt.fwd_ntt_bm(x, plan)
    assert torch.equal(hat, kntt.ntt_bm_plain(x, plan, True))
    assert torch.equal(kntt.inv_ntt_bm(x, plan), kntt.ntt_bm_plain(x, plan, False))
    assert torch.equal(kntt.inv_ntt_bm(hat, plan), x)
    assert (kntt.fwd_ntt_bm.launches, kntt.inv_ntt_bm.launches) == (1, 2)
    assert (kntt.fwd_ntt_bm.shapes, kntt.inv_ntt_bm.shapes) == ({(npr, 3, n, 19): 1}, {(npr, 3, n, 19): 2})
    # the same data through the natural-layout kernel
    nat = kntt.fwd_ntt_nat(x.permute(1, 3, 0, 2).contiguous(), plan)
    assert torch.equal(hat, nat.permute(2, 0, 3, 1))


@pytest.mark.parametrize("gates", [1, 5, 8, 256, 257])
def test_bm_kernel_any_batch(device, gates):
    plan = make_plan(1024, 2)
    x = _bm_residues(2, 6, 1024, gates, device, seed=gates)
    assert torch.equal(kntt.fwd_ntt_bm(x, plan), kntt.ntt_bm_plain(x, plan, True))
    assert torch.equal(kntt.inv_ntt_bm(x, plan), kntt.ntt_bm_plain(x, plan, False))


@pytest.mark.parametrize("shape", [(3, 24, 2048, 128), (3, 6, 2048, 128), (3, 2, 2048, 128), (2, 6, 1024, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_bm_kernel_engine_shapes(device, shape):
    """The shapes the engines launch: more line tiles than the card holds
    clusters at once (both buffers take turns), and a CTA a tile without a
    cluster at [3, 2, 2048, 128]."""
    npr, _, n, _ = shape
    plan = make_plan(n, npr)
    x = _bm_residues(*shape, device, seed=sum(shape))
    hat = kntt.fwd_ntt_bm(x, plan)
    assert torch.equal(hat, kntt.ntt_bm_plain(x, plan, True))
    assert torch.equal(kntt.inv_ntt_bm(hat, plan), x)


@pytest.mark.parametrize("shape", [(3, 30, 2048, 8), (3, 10, 2048, 8), (3, 36, 2048, 8), (3, 12, 2048, 8),
                                   (3, 6, 2048, 8)], ids=lambda s: "x".join(map(str, s)))
def test_bm_kernel_party_shapes(device, shape):
    """The shapes `kms.bootstrap_bm` launches at KMS16party and KMS32party
    (forward l_lev x 2 x l_gsw digit rows, 30 and 36, and party 1's 10 and
    12; inverse 6 rows) at 8 gates, both ways."""
    npr, _, n, _ = shape
    plan = make_plan(n, npr)
    x = _bm_residues(*shape, device, seed=sum(shape))
    hat = kntt.fwd_ntt_bm(x, plan)
    assert torch.equal(hat, kntt.ntt_bm_plain(x, plan, True))
    assert torch.equal(kntt.inv_ntt_bm(x, plan), kntt.ntt_bm_plain(x, plan, False))
    assert torch.equal(kntt.inv_ntt_bm(hat, plan), x)


@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024, 2048])
def test_bm_kernel_is_built_as_described(device, n):
    """The dispatcher's instances for N, in a cluster and without, both
    directions, are kernels that ptxas built, without spills."""
    from mktfhe_tpu_torch.kernels import _build

    usage = _build.resource_usage(_build.build(kntt.SOURCE))
    for rows, gates in ((24, 128), (1, 8)):  # many line tiles, few
        for forward in (True, False):
            kernel = kntt.bm_kernel(n, 3, rows, gates, forward)
            said = [u for u in usage if u.startswith(kernel["name"] + ":")]
            assert len(said) == 1 and ", 0 spill bytes" in said[0], said


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


@pytest.mark.parametrize("shape", [(1024, 2, 3, 9), (512, 3, 2, 16)], ids=lambda c: "-".join(map(str, c)))
def test_step_kernel_is_built_as_described(device, shape):
    """What the dispatcher says of a shape names a kernel that ptxas built,
    and its launch fits the card; the instance of preset CGGI does not spill."""
    from mktfhe_tpu_torch.kernels import _build

    n, npr, l, log_b = shape
    params, ctx, *_ = _step_inputs(n, npr, l, log_b, 2, 1, device)
    kernel = fused_step.step_kernel(params, ctx)
    said = [u for u in _build.resource_usage(_build.build(fused_step.SOURCE)) if u.startswith(kernel["name"] + ":")]
    assert len(said) == 1
    assert kernel["run_time_shapes"] == (n == 512)
    assert kernel["run_time_shapes"] or ", 0 spill bytes" in said[0]
    assert kernel["threads"] == n // 4
    assert kernel["shared_bytes"] <= torch.cuda.get_device_properties(device).shared_memory_per_block_optin


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


# the tiny sets of tests/test_lmss.py and tests/test_ccs.py (this file imports no jax), and
# TINY with a gadget whose w contraction has 3 * 6 = 18 > 16 terms
LMSS_TINY = BlockParams(d=8, ell=2, alpha=16.0, f=8, log_d=2, big_n=64, k=1, beta=16.0, l_gsw=3, log_b_gsw=8)
CCS_TINY = CcsParams(n=8, alpha=16.0, f=8, log_d=2, big_n=64, beta=4.0, l_uni=3, log_b_uni=8, k=2)


def _on(obj, device):
    """A scheme dataclass with every tensor on `device`."""
    return dataclasses.replace(obj, **{f.name: getattr(obj, f.name).to(device) for f in dataclasses.fields(obj)})


def _same_on_card(device, bootstrap, scheme, ct):
    """The bootstrap of `ct` on the card equals the CPU's bit for bit and
    launched the natural NTT kernel; returns the CPU's output."""
    want = bootstrap(ct, scheme)
    kntt.reset_launches()
    got = bootstrap(Lwe(b=ct.b.to(device), a=ct.a.to(device)), _on(scheme, device))
    assert kntt.fwd_ntt_nat.launches > 0 and kntt.inv_ntt_nat.launches > 0
    assert torch.equal(got.b.cpu(), want.b) and torch.equal(got.a.cpu(), want.a)
    return want


def test_lmss_bootstrap_card_equals_cpu(device):
    gen = torch.Generator().manual_seed(11)
    lwe_key, _, scheme = lmss.setup(gen, LMSS_TINY)
    ops = list(gates.GATE_IDS)
    m1, m2 = (torch.randint(0, 2, (len(ops),), generator=gen) for _ in range(2))
    ct1, ct2 = (gates.lwe_encrypt_bit(gen, m, lwe_key, LMSS_TINY.alpha, (len(ops),)) for m in (m1, m2))
    op_ids = torch.tensor([gates.GATE_IDS[o] for o in ops])
    out = _same_on_card(device, lambda ct, s: lmss.bootstrap(ct, s, LMSS_TINY), scheme,
                        gates.gate_affine(op_ids, ct1, ct2))
    want = [gates.CLEAR_OPS[o](bool(a), bool(b)) for o, a, b in zip(ops, m1, m2)]
    assert gates.lwe_decrypt_bit(out, lwe_key).tolist() == want
    assert kntt.fwd_ntt_nat.launches == kntt.inv_ntt_nat.launches == LMSS_TINY.d


@pytest.mark.parametrize("params", [CCS_TINY, dataclasses.replace(CCS_TINY, k=4),
                                    dataclasses.replace(CCS_TINY, l_uni=6, log_b_uni=4)],
                         ids=["k2", "k4", "wide"])
def test_ccs_bootstrap_card_equals_cpu(device, params):
    gen = torch.Generator().manual_seed(31)
    a = ccs.crs(gen, params)
    parties = [ccs.party_keygen(gen, a, params) for _ in range(params.k)]
    lwe_keys = [p[0] for p in parties]
    scheme = ccs.setup(a, [p[2] for p in parties], params)
    m1, m2 = (torch.randint(0, 2, (4,), generator=gen) for _ in range(2))
    ct1 = gates.lwe_ith_encrypt_bit(gen, m1, 0, lwe_keys[0], params.alpha, params.k, (4,))
    ct2 = gates.lwe_ith_encrypt_bit(gen, m2, 1, lwe_keys[1], params.alpha, params.k, (4,))
    out = _same_on_card(device, lambda ct, s: ccs.bootstrap(ct, s, params), scheme,
                        gates.gate_affine(gates.GATE_IDS["NAND"], ct1, ct2))
    assert gates.lwe_decrypt_bit_mk(out, lwe_keys).tolist() == [not (x and y) for x, y in zip(m1.tolist(), m2.tolist())]
    steps = params.k * params.n
    assert kntt.fwd_ntt_nat.launches == kntt.inv_ntt_nat.launches == 2 * steps


def _tiny_kms(seed: int):
    """TinyKMS2party keys, scheme and a NAND batch of 6 gates, on the CPU."""
    params = TEST_PRESETS["TinyKMS2party"]
    gen = torch.Generator().manual_seed(seed)
    a = kms.crs(gen, params)
    parties = [kms.party_keygen(gen, a, params) for _ in range(params.k)]
    lwe_keys = [p[0] for p in parties]
    m1, m2 = (torch.randint(0, 2, (6,), generator=gen).bool() for _ in range(2))
    cts = [gates.lwe_ith_encrypt_bit(gen, m, i, lwe_keys[i], params.alpha, params.k, (6,)) for i, m in enumerate((m1, m2))]
    return params, lwe_keys, kms.setup(a, [p[3] for p in parties], params), gates.gate_affine(0, *cts), ~(m1 & m2)


def test_serialization_on_card_equals_cpu(device, tmp_path):
    params, _, scheme, ct, _ = _tiny_kms(41)
    for name, obj in (("scheme", scheme), ("ct", ct)):
        save(str(tmp_path / f"{name}.npz"), obj)
    on_card = load(str(tmp_path / "scheme.npz"), device)
    assert all(getattr(on_card, f.name).device == device for f in dataclasses.fields(on_card))
    assert all(torch.equal(getattr(on_card, f.name).cpu(), getattr(scheme, f.name)) for f in dataclasses.fields(scheme))
    got = kms.bootstrap(load(str(tmp_path / "ct.npz"), device), on_card, params)
    want = kms.bootstrap(ct, scheme, params)
    assert torch.equal(got.b.cpu(), want.b) and torch.equal(got.a.cpu(), want.a)


def test_noise_on_card_equals_cpu(device):
    params, lwe_keys, scheme, ct, clear = _tiny_kms(43)
    out = kms.bootstrap(ct, scheme, params)
    card = Lwe(b=out.b.to(device), a=out.a.to(device))
    card_keys = [k._replace(key=k.key.to(device)) for k in lwe_keys]
    assert (noise.phase_error_bits(card, card_keys, clear) == noise.phase_error_bits(out, lwe_keys, clear)).all()
    got, want = noise.noise_report(card, card_keys, clear), noise.noise_report(out, lwe_keys, clear)
    assert got["samples"] == want["samples"]
    assert got == pytest.approx(want, rel=1e-12)


def test_sharded_two_gloo_ranks_on_one_card_equal_cpu(device, tmp_path):
    """kms_bootstrap_shardmap in two ranks sharing cuda:0 over gloo, a
    (party 2, batch 1) mesh: bit for bit the CPU's kms.bootstrap; each rank
    launched the natural NTT kernel."""
    params, lwe_keys, scheme, ct, clear = _tiny_kms(47)
    paths = [str(tmp_path / f) for f in ("scheme.npz", "ct.npz")]
    save(paths[0], scheme)
    save(paths[1], ct)
    ranks = run_ranks(bootstrap_jobs, 2, "gloo", ([Job("ref", params, *paths, mesh=(2, 1))],), "cuda")
    want = kms.bootstrap(ct, scheme, params)
    assert gates.lwe_decrypt_bit_mk(want, lwe_keys).tolist() == clear.tolist()
    for (res,) in ranks:
        assert (res["b"] == bridge.to_numpy(want.b)).all() and (res["a"] == bridge.to_numpy(want.a)).all()
        assert res["launches"]["fwd"] > 0 and res["launches"]["inv"] > 0 and not res["jax"]


# --- the bootstraps as CUDA graphs (graphs.py) --------------------------------

from mktfhe_tpu_torch import graphs  # noqa: E402
from test_torch_graphs import ENGINES, _messages, engine_case, refusals, run  # noqa: E402


def _reset_counts() -> None:
    kntt.reset_launches()
    khybrid.reset_launches()
    fused_mx3.reset_launches()
    fused_mx2.reset_launches()
    fused_step.reset_launches()


def _same(x: Lwe, y: Lwe) -> bool:
    return torch.equal(x.b, y.b) and torch.equal(x.a, y.a)


@pytest.mark.parametrize("name", ENGINES)
def test_graph_equals_eager(device, name):
    """The graph's output == the eager bootstrap's on the capture's example,
    and over a dependent chain of two more (each link's input the previous
    link's output, NAND with c2); every link decrypts to the clear NAND."""
    case = engine_case(name, device)
    want = run(case)
    graphed = graphs.capture_bootstrap(case["bootstrap"], case["scheme"], case["params"], case["ct"], *case["extra"])
    assert graphed.graph is not None and graphed.nodes > 0 and graphed.pool_bytes >= 0
    assert _same(graphed.warmup_out, want)
    got = graphed(case["ct"], case["scheme"], *case["extra"], case["params"])
    assert _same(got, want)
    m1, m2 = (m.to(device) for m in _messages(3))
    clear = ~(m1 & m2)
    assert torch.equal(case["decrypt"](got), clear)
    nand = gates.GATE_IDS["NAND"]
    x, y = got, want
    for _ in range(2):
        x = graphed(gates.gate_affine(nand, x, case["c2"]), case["scheme"], *case["extra"], case["params"])
        y = run(case, gates.gate_affine(nand, y, case["c2"]))
        clear = ~(clear & m2)
        assert _same(x, y) and torch.equal(case["decrypt"](x), clear)
    assert _same(got, want)  # a later replay does not write into an earlier output


@pytest.mark.parametrize("name", ENGINES)
def test_graph_counts_its_launches(device, name):
    """The capture counts only its eager warm-up; three replays count three
    times the eager bootstrap's launches, by wrapper and by shape."""
    case = engine_case(name, device)
    run(case)
    _reset_counts()
    run(case)
    eager = graphs.launch_counts()
    assert any(n for n, _ in eager.values())
    _reset_counts()
    graphed = graphs.capture_bootstrap(case["bootstrap"], case["scheme"], case["params"], case["ct"], *case["extra"])
    assert graphs.launch_counts() == eager
    assert graphed.launches == {w: n for w, (n, _) in eager.items() if n}
    _reset_counts()
    for _ in range(3):
        graphed(case["ct"], case["scheme"], *case["extra"], case["params"])
    assert graphs.launch_counts() == {w: (3 * n, {k: 3 * v for k, v in shapes.items()}) for w, (n, shapes) in eager.items()}


@pytest.mark.parametrize("name", ["fused_mx3.bootstrap_mx3", "fused_mx3.bootstrap_mx3 block", "kms.bootstrap",
                                  "fused_mx2.bootstrap_mx2", "kms.bootstrap_bm"])
def test_hybrid_product_launches_once_a_merge(device, name):
    """Every KMS engine's phase 2 launches the hybrid product kernel once a
    merge, eager and in each replay of its graph."""
    case = engine_case(name, device)
    run(case)
    khybrid.reset_launches()
    run(case)
    assert khybrid.hybrid_product.launches == case["params"].k
    graphed = graphs.capture_bootstrap(case["bootstrap"], case["scheme"], case["params"], case["ct"], *case["extra"])
    khybrid.reset_launches()
    graphed(case["ct"], case["scheme"], *case["extra"], case["params"])
    assert khybrid.hybrid_product.launches == case["params"].k


@pytest.mark.parametrize("name", ["fused_mx3.bootstrap_mx3", "fused_mx3.bootstrap_mx3 block"])
def test_bootstrap_mx3_sweeps_every_party_in_one_launch(device, name):
    """`bootstrap_mx3` launches the sweep kernel once for all k parties,
    eager and in each replay of its graph."""
    case = engine_case(name, device)
    run(case)
    _reset_counts()
    run(case)
    want = {"phase1_sweep": (1, {}), "phase1_sweep.parties": (case["params"].k, {})}
    counts = graphs.launch_counts()
    assert {w: counts[w] for w in want} == want
    graphed = graphs.capture_bootstrap(case["bootstrap"], case["scheme"], case["params"], case["ct"], *case["extra"])
    _reset_counts()
    graphed(case["ct"], case["scheme"], *case["extra"], case["params"])
    counts = graphs.launch_counts()
    assert {w: counts[w] for w in want} == want


@pytest.mark.parametrize("name", ENGINES)
def test_bootstrap_makes_no_sync(device, name):
    """An eager bootstrap (after one that made the constant tables) under
    set_sync_debug_mode("error"): no synchronizing call, the same bits.  The
    public wrappers' range read is one, and the mode catches it."""
    case = engine_case(name, device)
    want = run(case)
    assert _same(graphs.without_sync(run, case), want)
    with pytest.raises(RuntimeError):
        graphs.without_sync(lambda: torch.zeros(1, device=device).item())


def test_public_wrappers_sync_on_the_range_read(device):
    case = engine_case("fused_mx3.bootstrap_mx3", device)
    params, scheme = case["params"], case["scheme"]
    ta = torch.zeros((3, params.n), dtype=torch.int32, device=device)
    args = (ta, scheme.brk_hat[0], 1, scheme.mono_hat, params, kms._ctx(params))
    fused_mx3.phase1_sweep(*args)
    with pytest.raises(RuntimeError):
        graphs.without_sync(fused_mx3.phase1_sweep, *args)
    assert torch.equal(graphs.without_sync(fused_mx3._sweep, *args), fused_mx3.phase1_sweep(*args))
    every = (ta.repeat(1, params.k), scheme.brk_hat, 1, scheme.mono_hat, params, kms._ctx(params))
    fused_mx3.phase1_sweeps(*every)
    with pytest.raises(RuntimeError):
        graphs.without_sync(fused_mx3.phase1_sweeps, *every)
    got = graphs.without_sync(fused_mx3.kms_phase1_sweeps, *every)
    assert all(torch.equal(x, y) for x, y in zip(got, fused_mx3.phase1_sweeps(*every)))


@pytest.mark.parametrize("name", ENGINES)
def test_graph_refuses_on_the_card(device, name):
    """Another batch, dtype or width, another scheme, key or parameter
    object, and a CPU ciphertext: ValueError, nothing replayed."""
    case = engine_case(name, device)
    graphed = graphs.capture_bootstrap(case["bootstrap"], case["scheme"], case["params"], case["ct"], *case["extra"])
    _reset_counts()
    cases = refusals(case)
    cases["device"] = (Lwe(b=case["ct"].b.cpu(), a=case["ct"].a.cpu()), case["scheme"],
                       (*case["extra"], case["params"]))
    for what, (ct, scheme, rest) in cases.items():
        with pytest.raises(ValueError):
            graphed(ct, scheme, *rest)
    assert not any(n for n, _ in graphs.launch_counts().values())


@pytest.mark.parametrize("name", ["fused_mx3.bootstrap_mx3", "fused_mx2.bootstrap_mx2", "cggi.bootstrap"])
def test_graph_keeps_its_keys_alive(device, name):
    """With every other reference to the scheme and keys gone (and the
    scheme rebuilt by drop_brk where it has brk_hat) and their memory
    offered to new tensors, the graph still gives the eager bits."""
    import gc

    case = engine_case(name, device)
    want = run(case)
    graphed = graphs.capture_bootstrap(case["bootstrap"], case["scheme"], case["params"], case["ct"], *case["extra"])
    if isinstance(case["scheme"], kms.KmsScheme) and case["scheme"].brk_hat.numel():
        case["scheme"] = kms.drop_brk(case["scheme"])
    ct, params = case["ct"], case["params"]
    del case
    gc.collect()
    torch.cuda.empty_cache()
    filler = [torch.full((1 << 20,), -1, dtype=torch.int64, device=device) for _ in range(8)]
    assert _same(graphed(ct, graphed.scheme, *graphed.extra, params), want)
    del filler


# --- rotation amounts outside [0, 2N) ----------------------------------------


def _outside(n: int, g: int, steps: int, device) -> torch.Tensor:
    """[g, steps] int32 rotation amounts: 2N, 2N + 5, 4N - 1, -1, -2N and
    both ends of int32 first, random int32 ones after them."""
    odd = [2 * n, 2 * n + 5, 4 * n - 1, -1, -2 * n, -(1 << 31), -(1 << 31) + 7, (1 << 31) - 1, (1 << 31) - 5]
    gen = torch.Generator(device=device).manual_seed(n + g)
    ta = torch.randint(-(1 << 31), (1 << 31) - 1, (g, steps), generator=gen, device=device, dtype=torch.int32)
    ta.view(-1)[: len(odd)] = torch.tensor(odd, dtype=torch.int32, device=device)
    return ta


def _mod_2n(ta: torch.Tensor, n: int) -> torch.Tensor:
    return torch.remainder(ta.long(), 2 * n).to(torch.int32)


@pytest.mark.parametrize("shape", [(64, 3, 3, 2, 3, 8, 4), (2048, 4, 3, 3, 4, 9, 4), (2048, 3, 1, 3, 4, 9, 4)],
                         ids=lambda c: "-".join(map(str, c)))
def test_sweep_kernel_takes_amounts_mod_2n(device, shape):
    """The sweep's private form (the bootstrap steps', which skips the range
    read) at amounts outside [0, 2N) == the plain version at the amounts
    mod 2N: block keys index the 2N monomial images with the reduced
    amount, binary keys roll by it."""
    n, npr, ell, rows, l, log_b, g = shape
    params, ctx, _, brk, mono, acc0 = _sweep_inputs(*shape, device)
    ta = _outside(n, g, params.n, device)
    got = fused_mx3._sweep(ta, brk, rows, mono, params, ctx, acc0)
    assert torch.equal(got, fused_mx3.phase1_sweep_plain(_mod_2n(ta, n), brk, rows, mono, params, ctx, acc0=acc0))


@pytest.mark.parametrize("shape", [(64, 2, 3, 9, 4, 4), (1024, 2, 3, 9, 4, 4)], ids=lambda c: "-".join(map(str, c)))
def test_step_kernel_takes_amounts_mod_2n(device, shape):
    """All steps of the CGGI step kernel in one launch (the form
    `bootstrap_fused` calls) at amounts outside [0, 2N) == the plain steps
    at the amounts mod 2N."""
    n, npr, l, log_b, steps, g = shape
    params, ctx, _, brk, mono, acc = _step_inputs(n, npr, l, log_b, steps, g, device)
    ta = _outside(n, g, steps, device)
    got = fused_step._steps(acc, ta, brk, mono, params, ctx)
    want = acc
    for i in range(steps):
        want = fused_step.cggi_step_plain(want, brk[i], _mod_2n(ta, n)[:, i], mono, params, ctx)
    assert torch.equal(got, want)


# --- the sharded bootstrap as CUDA graphs -------------------------------------


def _same_numpy(res: dict, want: Lwe) -> bool:
    return (res["b"] == bridge.to_numpy(want.b)).all() and (res["a"] == bridge.to_numpy(want.a)).all()


def test_shard_graph_one_nccl_rank(device, tmp_path):
    """One NCCL rank, mesh (1, 1): the whole program one graph, its one-rank
    collectives in it (more nodes than the same program's segments'
    graphs), replayed with no sync (the rank runs the replays under
    set_sync_debug_mode("error")); eager == graph == by segment ==
    `kms.bootstrap`, a replay's launches == eager."""
    params, lwe_keys, scheme, ct, clear = _tiny_kms(53)
    paths = [str(tmp_path / f) for f in ("scheme.npz", "ct.npz")]
    save(paths[0], scheme)
    save(paths[1], ct)
    job = Job("ref", params, *paths, mesh=(1, 1), reps=2, graphed=True)
    ((res,),) = run_ranks(bootstrap_jobs, 1, "nccl", ([job],), "cuda")
    want = kms.bootstrap(ct, scheme, params)
    graph = res["graph"]
    assert graph["whole"] and graph["segments"] == 1 and graph["nodes"] > graph["by_segment"]["nodes"] > 0
    assert all(_same_numpy(out, want) for out in (res, graph, graph["by_segment"]))
    assert graph["launches"] == res["launches"] and res["launches"]["fwd"] > 0
    assert gates.lwe_decrypt_bit_mk(want, lwe_keys).tolist() == clear.tolist()


@pytest.mark.parametrize("shard_phase2", [False, True], ids=["replicated", "shard_phase2"])
def test_shard_graph_two_gloo_ranks(device, tmp_path, shard_phase2):
    """Two gloo ranks sharing cuda:0, mesh (party 2, batch 1): a graph a
    segment, the collectives eager between the replays; eager == graph ==
    `kms.bootstrap` on both ranks, a replay's launches == eager."""
    params, _, scheme, ct, _ = _tiny_kms(59)
    paths = [str(tmp_path / f) for f in ("scheme.npz", "ct.npz")]
    save(paths[0], scheme)
    save(paths[1], ct)
    job = Job("ref", params, *paths, mesh=(2, 1), shard_phase2=shard_phase2, reps=2, graphed=True)
    ranks = run_ranks(bootstrap_jobs, 2, "gloo", ([job],), "cuda")
    want = kms.bootstrap(ct, scheme, params)
    for (res,) in ranks:
        graph = res["graph"]
        assert not graph["whole"] and graph["segments"] >= 2 and "by_segment" not in graph
        assert _same_numpy(res, want) and _same_numpy(graph, want)
        assert graph["launches"] == res["launches"] and res["launches"]["fwd"] > 0


# --- the named ranges timed by CUDA events ------------------------------------

from mktfhe_tpu_torch.utils import profiling  # noqa: E402


def _event_split(bootstrap):
    """bootstrap() with its named ranges timed by CUDA events: (its
    output, ms by range, the bootstrap's event ms from end to end)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profiling.event_ranges() as ms:
        start.record()
        out = bootstrap()
        end.record()
    return out, ms, start.elapsed_time(end)


@pytest.mark.parametrize("name", ["fused_mx3.bootstrap_mx3", "kms.bootstrap", "cggi.bootstrap"])
def test_event_ranges_name_the_profilers_ranges(device, name, tmp_path):
    """At a tiny set: the ranges timed by CUDA events are the profiler's,
    in order of first opening, and lie inside the bootstrap (a tiny
    bootstrap waits on the host, which spends a tenth of its time outside
    the ranges: the sum is held from below at a device-bound one)."""
    case = engine_case(name, device)
    want = run(case)
    got, ms, total = _event_split(lambda: run(case))
    assert _same(got, want)
    assert all(v >= 0 for v in ms.values()) and 0 < sum(ms.values()) <= 1.02 * total, (ms, total)
    with profiling.trace(str(tmp_path)) as prof:
        run(case)
    names = [n for _, n in sorted((e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                                  if e.is_user_annotation() and e.name().startswith(profiling.PREFIX))]
    assert list(ms) == list(dict.fromkeys(names))


def _device_bound_case(device):
    """`bootstrap_mx3`'s inputs at KMS2partyblock, batch 128 (its sweeps
    keep the card busy): (ct, scheme, params)."""
    params = presets.KMS_2PARTY_BLOCK
    gen = torch.Generator(device=device).manual_seed(61)
    a = kms.crs(gen, params)
    parties = [kms.party_keygen(gen, a, params) for _ in range(params.k)]
    scheme = kms.setup(a, [p[3] for p in parties], params)
    m1, m2 = (torch.randint(0, 2, (128,), generator=gen, device=device).bool() for _ in range(2))
    ct = gates.gate_affine(gates.GATE_IDS["NAND"], *(
        gates.lwe_ith_encrypt_bit(gen, m, i, parties[i][0], params.alpha, params.k, (128,))
        for i, m in enumerate((m1, m2))))
    return ct, scheme, params


def test_event_ranges_add_up_to_a_device_bound_bootstrap(device):
    """`bootstrap_mx3` at KMS2partyblock, batch 128 (its sweeps keep the
    card busy): the ranges' event ms add up to 0.90-1.02 of the
    bootstrap's, phase 1 is most of them, and the bits are the untimed
    bootstrap's."""
    ct, scheme, params = _device_bound_case(device)
    want = fused_mx3.bootstrap_mx3(ct, scheme, params)
    got, ms, total = _event_split(lambda: fused_mx3.bootstrap_mx3(ct, scheme, params))
    assert _same(got, want)
    assert 0.90 <= sum(ms.values()) / total <= 1.02, (ms, total)
    phase1 = sum(v for k, v in ms.items() if k.startswith("mktfhe/phase1/"))
    assert phase1 > 0.5 * total, (ms, total)


def test_event_ranges_skip_a_capture(device):
    """A capture records no event (they would be nodes of the graph): under
    `event_ranges` the capture's eager warm-up is timed, its replays add
    no range."""
    case = engine_case("fused_mx3.bootstrap_mx3", device)
    with profiling.event_ranges() as warm:
        graphed = graphs.capture_bootstrap(case["bootstrap"], case["scheme"], case["params"], case["ct"],
                                           *case["extra"])
    with profiling.event_ranges() as replay:
        graphed(case["ct"], case["scheme"], *case["extra"], case["params"])
    assert warm and all(k.startswith(profiling.PREFIX) for k in warm) and replay == {}


# --- the named ranges inside a captured graph, the host spans of a replay ----


def test_external_events_in_a_graph_time_a_launch_as_eager(device):
    """An external timing-event pair captured around one B1 launch
    ([8192, 4, 2048]) reads on replay, in the median of 20, within 10% of
    that launch's eager event time (taken behind a device-side sleep, so
    that the host's launch does not lie between the events); the replay
    computes the eager bits."""
    plan = make_plan(2048, 4)
    x = _residues((8192,), 4, 2048, device, seed=8)
    want = kntt.fwd_ntt_nat(x, plan)  # also makes the tables, once per device

    def timed(start, end):
        start.record()
        out = kntt.fwd_ntt_nat(x, plan)
        end.record()
        return out

    eager = []
    for _ in range(20):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        timed(start, end)
        torch.cuda.synchronize()
        eager.append(start.elapsed_time(end))
    graph = torch.cuda.CUDAGraph()
    start, end = (torch.cuda.Event(enable_timing=True, external=True) for _ in range(2))
    with torch.cuda.graph(graph):
        got = timed(start, end)
    replayed = []
    for _ in range(20):
        graph.replay()
        end.synchronize()
        replayed.append(start.elapsed_time(end))
    assert torch.equal(got, want)
    ratio = statistics.median(replayed) / statistics.median(eager)
    assert 0.9 <= ratio <= 1.1, (replayed, eager)


def test_capture_carves_its_pool_from_one_segment(device):
    """`bootstrap_mx3` at KMS2partyblock, batch 128, whose phase-2
    transients grow from merge to merge: the capture opens its pool with
    one segment of the warm-up's transient peak, and the pool reserves at
    most twice its peak; the bits are the eager ones."""
    ct, scheme, params = _device_bound_case(device)
    want = fused_mx3.bootstrap_mx3(ct, scheme, params)
    graphed = graphs.capture_bootstrap(fused_mx3.bootstrap_mx3, scheme, params, ct)
    assert graphed.warmup_transient_bytes > 0
    assert graphed.pool_peak_bytes >= graphed.warmup_transient_bytes
    assert graphed.pool_bytes <= 2 * graphed.pool_peak_bytes, (graphed.pool_bytes, graphed.pool_peak_bytes)
    assert _same(graphed(ct, scheme, params), want)


def test_graph_ranges_split_a_device_bound_replay(device):
    """`bootstrap_mx3` at KMS2partyblock, batch 128, captured with ranges:
    `range_ms()` names the eager ranges in the same order and adds up to
    0.95-1.02 of the replay's event time; the graph holds two event nodes
    a range more than the one without ranges, and both compute the eager
    bits."""
    ct, scheme, params = _device_bound_case(device)
    bootstrap = fused_mx3.bootstrap_mx3
    want, eager, _ = _event_split(lambda: bootstrap(ct, scheme, params))
    plain = graphs.capture_bootstrap(bootstrap, scheme, params, ct)
    graphed = graphs.capture_bootstrap(bootstrap, scheme, params, ct, ranges=True)
    assert plain.recorder is None and plain.range_ms() == {}
    assert graphed.nodes == plain.nodes + 2 * len(graphed.recorder.ranges)
    for _ in range(2):
        got, _, total = _event_split(lambda: graphed(ct, scheme, params))
        ms = graphed.range_ms()
        assert _same(got, want) and _same(plain(ct, scheme, params), want)
        assert list(ms) == list(eager) and all(v >= 0 for v in ms.values())
        assert 0.95 <= sum(ms.values()) / total <= 1.02, (ms, total)


@pytest.mark.parametrize("name", ["fused_mx3.bootstrap_mx3", "kms.bootstrap", "cggi.bootstrap"])
def test_graph_ranges_leave_the_bits(device, name):
    """At a tiny set: the graph captured with ranges computes the bits of
    the one captured without, over a dependent chain, and reads the eager
    ranges' names in order after every replay."""
    case = engine_case(name, device)
    want = run(case)
    _, eager, _ = _event_split(lambda: run(case))
    args = (case["scheme"], *case["extra"], case["params"])
    plain = graphs.capture_bootstrap(case["bootstrap"], case["scheme"], case["params"], case["ct"], *case["extra"])
    graphed = graphs.capture_bootstrap(case["bootstrap"], case["scheme"], case["params"], case["ct"],
                                       *case["extra"], ranges=True)
    nand = gates.GATE_IDS["NAND"]
    x, y = case["ct"], case["ct"]
    for _ in range(3):
        x, y = graphed(x, *args), plain(y, *args)
        assert _same(x, y) and list(graphed.range_ms()) == list(eager)
        x, y = gates.gate_affine(nand, x, case["c2"]), gates.gate_affine(nand, y, case["c2"])
    assert _same(graphed(case["ct"], *args), want)


def test_graph_without_ranges_holds_no_event_node(device):
    """A capture without ranges inside `event_ranges` has the node count of
    one outside any recorder, and its replay records no range there."""
    case = engine_case("fused_mx3.bootstrap_mx3", device)
    args = (case["bootstrap"], case["scheme"], case["params"], case["ct"], *case["extra"])
    outside = graphs.capture_bootstrap(*args)
    with profiling.event_ranges() as warm:
        inside = graphs.capture_bootstrap(*args)
    assert warm and inside.nodes == outside.nodes and inside.recorder is None
    with profiling.event_ranges() as replay:
        inside(case["ct"], case["scheme"], *case["extra"], case["params"])
    assert replay == {}


def test_replay_opens_its_host_spans(device, tmp_path):
    """Under the profiler a gate through a graph opens `mktfhe/gate`, its
    affine's span, then the replay's three spans in order, all inside the
    gate's; a graph with ranges opens no bootstrap range on the host."""
    case = engine_case("fused_mx3.bootstrap_mx3", device)
    graphed = graphs.capture_bootstrap(case["bootstrap"], case["scheme"], case["params"], case["ct"],
                                       *case["extra"], ranges=True)

    def boot(ct):
        return graphed(ct, case["scheme"], *case["extra"], case["params"])

    with profiling.trace(str(tmp_path)) as prof:
        gates.gate("NAND", case["ct"], case["c2"], boot)
    spans = sorted(((e.start_ns(), e.end_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                    if e.is_user_annotation() and e.device_type() == torch.autograd.DeviceType.CPU
                    and e.name().startswith(profiling.PREFIX)), key=lambda span: (span[0], -span[1]))
    assert [n for _, _, n in spans] == ["mktfhe/gate", "mktfhe/gate/affine", "mktfhe/graph/inputs",
                                        "mktfhe/graph/launch", "mktfhe/graph/outputs"]
    g0, g1 = spans[0][:2]
    assert all(g0 <= s0 <= s1 <= g1 for s0, s1, _ in spans[1:])
    assert all(spans[i][1] <= spans[i + 1][0] for i in range(1, 4))


# --- KMS8party on the mx engine, through the normal path ----------------------


@pytest.fixture(scope="module")
def kms8party():
    """KMS8party keys from the port's keygen on the card, both schemes (with
    `brk_hat`, and `fused_mx2.setup`'s, timed by its named ranges) and a
    batch of 128 NAND gates of parties 0 and 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    device = torch.device("cuda", 0)
    params = presets.KMS_8PARTY
    gen = torch.Generator(device=device).manual_seed(8)
    a = kms.crs(gen, params)
    parties = [kms.party_keygen(gen, a, params) for _ in range(params.k)]
    lwe_keys, party_keys = [p[0] for p in parties], [p[3] for p in parties]
    del parties
    with profiling.event_ranges() as setup_ms:
        mx_scheme = fused_mx2.setup(a, party_keys, params)
    full = kms.setup(a, party_keys, params)
    m1, m2 = (torch.randint(0, 2, (128,), generator=gen, device=device).bool() for _ in range(2))
    cts = [gates.lwe_ith_encrypt_bit(gen, m, i, lwe_keys[i], params.alpha, params.k, (128,))
           for i, m in enumerate((m1, m2))]
    return dict(params=params, lwe_keys=lwe_keys, mx_scheme=mx_scheme, full=full, setup_ms=setup_ms, inputs=cts,
                ct=gates.gate_affine(gates.GATE_IDS["NAND"], *cts), clear=~(m1 & m2))


def test_kms8party_mx2_replay_equals_eager(kms8party):
    """At KMS8party, G = 128: `bootstrap_mx2(ct, scheme, params)` on the
    scheme of `fused_mx2.setup` (its `brk_hat` empty) captured by
    `capture_bootstrap` with no extra argument; a replay under `gates.gate`
    equals the eager `bootstrap_mx2` and `bootstrap_mx3` (on the scheme with
    `brk_hat`) bit for bit, decrypts to the NANDs, and launches B5 k times,
    B2 never and the hybrid product kernel k times, as the eager call
    does."""
    c = kms8party
    params, scheme, ct = c["params"], c["mx_scheme"], c["ct"]
    assert scheme.brk_hat.numel() == 0
    eager = fused_mx2.bootstrap_mx2(ct, scheme, params)
    assert _same(eager, fused_mx3.bootstrap_mx3(ct, c["full"], params))
    _reset_counts()
    fused_mx2.bootstrap_mx2(ct, scheme, params)
    counts = {w: n for w, (n, _) in graphs.launch_counts().items()}
    assert counts["mx_sweep"] == params.k and counts["phase1_sweep"] == 0 and counts["hybrid_product"] == params.k
    graphed = graphs.capture_bootstrap(fused_mx2.bootstrap_mx2, scheme, params, ct)
    assert graphed.extra == ()
    _reset_counts()
    got = gates.gate("NAND", *c["inputs"], lambda x: graphed(x, scheme, params))
    assert {w: n for w, (n, _) in graphs.launch_counts().items()} == counts
    assert _same(got, eager)
    assert torch.equal(gates.lwe_decrypt_bit_mk(got, c["lwe_keys"]), c["clear"])


def test_kms8party_mx_keys_range_at_setup(kms8party):
    """The mx image's build is timed by the named range mktfhe/setup/mx_keys,
    and `fused_mx2.setup` opens no other range."""
    assert list(kms8party["setup_ms"]) == ["mktfhe/setup/mx_keys"]
    assert kms8party["setup_ms"]["mktfhe/setup/mx_keys"] > 0
