"""Which kernel serves which shape: the CGGI step (B3) and the natural NTT (B1).

The step kernel (csrc/cggi_step.cu) is compiled for preset CGGI and once more
with run-time shapes for every other shape its wrapper admits; the natural
NTT kernel (csrc/ntt.cu) has an instance for every N its wrapper admits.  The
choice is made in one place, the sources' own dispatchers (`step_plan`,
`nat_plan`), which the wrappers ask through `fused_step.step_kernel` /
`kntt.nat_kernel`; here the dispatchers are compiled for the host
(mktfhe_tpu_torch/tools/host_kernels.py) and held against the table that
PERF.md prints, without a card.
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
