"""Which kernel serves which shape: the CGGI step (B3) and the NTTs (B1, B4).

The step kernel (csrc/cggi_step.cu) is compiled for preset CGGI and once more
with run-time shapes for every other shape its wrapper admits; the natural
and the batch-minor NTT kernels (csrc/ntt.cu) have an instance for every N
their wrappers admit, the batch-minor one in two tile widths.  The choice is
made in one place, the sources' own dispatchers (`step_plan`, `nat_plan`,
`bm_plan`), which the wrappers ask through `fused_step.step_kernel` /
`kntt.nat_kernel` / `kntt.bm_kernel`; here the dispatchers are compiled for
the host (mktfhe_tpu_torch/tools/host_kernels.py) and held against the table
that PERF.md prints, without a card.
"""

import pytest
import torch

from mktfhe_tpu_torch.kernels import fused_step
from mktfhe_tpu_torch.kernels import ntt as kntt
from mktfhe_tpu_torch.ring.context import make_ring_ctx
from mktfhe_tpu_torch.schemes import cggi, presets
from mktfhe_tpu_torch.schemes.params import CggiParams
from mktfhe_tpu_torch.tools import host_kernels

META = torch.device("meta")
MAX_SHARED = 232448  # bytes a CTA may ask for on sm_90

CGGI_PRESETS = {name: p for name, p in vars(presets).items() if isinstance(p, CggiParams)}
RUN_TIME = "cggi_step_kernel<0,0,0,1>"
# preset -> the kernel of cggi_step.cu that serves it (PERF.md, section 6):
# (name, threads, CTAs an SM is sized for)
STEP_KERNEL = {
    "CGGI_PARAM": ("cggi_step_kernel<10,3,2,2>", 256, 2),
    "TINY_CGGI": (RUN_TIME, 16, 1),
}


def _host(tmp_path_factory, stem):
    try:
        return host_kernels.library(stem, tmp_path_factory.mktemp(stem))
    except host_kernels.Unavailable as err:
        pytest.skip(str(err))


@pytest.fixture(scope="module")
def step_lib(tmp_path_factory):
    return _host(tmp_path_factory, "cggi_step")


@pytest.fixture(scope="module")
def ntt_lib(tmp_path_factory):
    return _host(tmp_path_factory, "ntt")


def test_table_covers_every_cggi_preset():
    assert set(STEP_KERNEL) == set(CGGI_PRESETS)


@pytest.mark.parametrize("name", sorted(CGGI_PRESETS))
def test_step_kernel_of_preset(step_lib, name):
    params = CGGI_PRESETS[name]
    ctx = cggi._ctx(params)
    n, npr, l = ctx.n, ctx.nprimes, params.l_gsw
    acc = torch.empty((0, 2, n), dtype=torch.int32, device=META)
    ta = torch.empty((0, params.n), dtype=torch.int32, device=META)
    brk = torch.empty((params.n, npr, 2 * l, 2, n), dtype=torch.int32, device=META)
    mono = torch.empty((2 * n, npr, n), dtype=torch.int32, device=META)
    fused_step._check(acc, ta, brk, mono, params, ctx, 0, params.n)  # admitted
    kernel = fused_step.step_kernel(params, ctx, step_lib)
    want, threads, ctas = STEP_KERNEL[name]
    assert (kernel["name"], kernel["threads"]) == (want, threads)
    assert kernel["run_time_shapes"] == (want == RUN_TIME)
    assert kernel["threads"] == n // 4  # a thread holds 8 accumulator words
    # the 2l digit polynomials, all but the last prime's outputs, every prime's twiddles
    assert kernel["twiddles_in_shared"]
    assert kernel["shared_bytes"] == 4 * n * (2 * l + 2 * (npr - 1)) + 16 * n * npr
    assert ctas * (kernel["shared_bytes"] + 1024) <= 228 * 1024  # as many CTAs share an SM
    if not kernel["run_time_shapes"]:
        assert kernel["name"] == f"cggi_step_kernel<{n.bit_length() - 1},{l},{npr},{ctas}>"


def test_step_kernel_twiddles_leave_shared_memory_when_they_do_not_fit(step_lib):
    """N = 2048, l_gsw = 6, 4 primes: 144 KB of digits and outputs leave no
    room for 128 KB of twiddles, which the kernel then reads from L1."""
    params = CggiParams(n=2, alpha=16.0, f=8, log_d=2, big_n=2048, k=1, beta=16.0, l_gsw=6, log_b_gsw=5)
    ctx = make_ring_ctx(2048, 32, 4)
    kernel = fused_step.step_kernel(params, ctx, step_lib)
    assert kernel["name"] == RUN_TIME and not kernel["twiddles_in_shared"]
    assert kernel["shared_bytes"] == 4 * 2048 * (12 + 6) <= MAX_SHARED


@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024, 2048])
def test_nat_kernel_of_size(ntt_lib, n, forward):
    kernel = kntt.nat_kernel(n, forward, ntt_lib)
    assert kernel == {
        "name": f"ntt_nat_kernel<{n.bit_length() - 1},{int(forward)}>",
        "threads": 256,
        "polys_per_tile": 2048 // n,
        "shared_bytes": 2 * 2048 * 4,  # two tiles: the one transformed, the one arriving
    }


@pytest.mark.parametrize("n", [32, 4096])
def test_nat_kernel_refuses_other_sizes(ntt_lib, n):
    with pytest.raises(ValueError):
        kntt.nat_kernel(n, True, ntt_lib)


# [npr, R, N, G] -> (gates per tile, CTAs a cluster) of the batch-minor
# kernel, both directions (PERF.md, section 6): the shapes bootstrap_bm (CGGI,
# 256 gates) and kms.bootstrap_bm (KMS8party, batch 128) launch
BM_TILE = {
    (2, 6, 1024, 256): (8, 4), (2, 2, 1024, 256): (4, 1),
    (3, 24, 2048, 128): (4, 8), (3, 6, 2048, 128): (4, 8), (3, 8, 2048, 128): (4, 8), (3, 2, 2048, 128): (4, 1),
}
# (npr, rows, gates) -> (gates per tile, CTAs a cluster) at N <= 1024 and at
# N = 2048: tiles of 8 (clusters of 4) at N <= 1024 where a line tile of 32
# gates for each 4 CTAs fill 132 SMs twice over (264 CTAs), else tiles of 4
# in clusters of 8, or in none where 8 CTAs a line tile are no more than 264
BM_RULE = {
    (3, 24, 128): ((8, 4), (4, 8)), (2, 2, 256): ((4, 1), (4, 1)), (2, 3, 5): ((4, 1), (4, 1)),
    (4, 33, 33): ((8, 4), (4, 8)), (2, 33, 32): ((8, 4), (4, 8)), (4, 16, 32): ((4, 8), (4, 8)),
    (3, 11, 32): ((4, 1), (4, 1)),
}


def _bm_expected(n, gt, cluster, forward):
    full = n == 2048  # two (task, quad) items of a 3-stage pass a thread, one tile in shared memory
    return {
        "name": f"ntt_bm_kernel<{n.bit_length() - 1},{gt},{int(cluster > 1)},{int(forward)}>",
        "threads": min(512, max(32, n * gt // (64 if full else 32))),  # else one item a thread
        "gates_per_tile": gt,
        "shared_bytes": (1 if full else 2) * n * gt * 4,  # else the tile transformed and the one arriving
        "cluster": cluster,
    }


@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024, 2048])
def test_bm_kernel_of_size(ntt_lib, n, forward):
    """An instance for every N; a cluster of C CTAs with tiles gt gates wide
    walks tiles of C gt gates, ceil(G / (C gt)) per (prime, row)."""
    for (npr, rows, gates), by_n in BM_RULE.items():
        gt, cluster = by_n[n == 2048]
        kernel = kntt.bm_kernel(n, npr, rows, gates, forward, ntt_lib)
        assert kernel == {**_bm_expected(n, gt, cluster, forward), "tiles": npr * rows * -(-gates // (cluster * gt))}
        assert kernel["shared_bytes"] <= MAX_SHARED


@pytest.mark.parametrize("shape", sorted(BM_TILE), ids=lambda s: "x".join(map(str, s)))
def test_bm_kernel_of_engine_shape(ntt_lib, shape):
    npr, rows, n, gates = shape
    for forward in (True, False):
        kernel = kntt.bm_kernel(n, npr, rows, gates, forward, ntt_lib)
        assert kernel == {**_bm_expected(n, *BM_TILE[shape], forward), "tiles": kernel["tiles"]}


@pytest.mark.parametrize("n", [32, 4096])
def test_bm_kernel_refuses_other_sizes(ntt_lib, n):
    with pytest.raises(ValueError):
        kntt.bm_kernel(n, 2, 1, 8, True, ntt_lib)
