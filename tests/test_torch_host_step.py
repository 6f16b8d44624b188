"""csrc/cggi_step.cu (B3), its device code run on the CPU.

The instance of preset CGGI (N = 1024, l_gsw = 3, 2 primes) at full N over a
few steps, and the kernel with run-time shapes over ring sizes, prime counts
and gadgets -- the 32-bit rounding carry live (l log_b < 32) and not
(l log_b = 32) -- step ranges and batch sizes, against
`fused_step.cggi_step_plain`, from accumulators with extreme bits.
The device code is compiled for the host with g++
(mktfhe_tpu_torch/tools/host_kernels.py: one std::thread per CUDA thread, a
std::barrier for `__syncthreads()`) and held bit for bit against the plain
PyTorch versions (tolerance 0).  It says nothing about what nvcc accepts or
about speed.  Skips where there is no g++ with C++20.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mktfhe_tpu_torch.kernels import fused_mx3, fused_step
from mktfhe_tpu_torch.kernels import ntt as kntt
from mktfhe_tpu_torch.ring.context import make_ring_ctx
from mktfhe_tpu_torch.ring.modring import PRIMES
from mktfhe_tpu_torch.schemes import kms
from mktfhe_tpu_torch.schemes.params import CggiParams
from mktfhe_tpu_torch.schemes.presets import CGGI_PARAM, TINY_CGGI
from mktfhe_tpu_torch.tools import host_kernels

CPU = torch.device("cpu")
RUN_TIME = "cggi_step_kernel<0,0,0,1>"


@pytest.fixture(scope="module")
def step_lib(tmp_path_factory):
    try:
        return host_kernels.library("cggi_step", tmp_path_factory.mktemp("step_host"))
    except host_kernels.Unavailable as err:
        pytest.skip(str(err))


_CGGI = dict(alpha=16.0, f=8, log_d=2, k=1, beta=16.0)
# (parameters, primes, gates, first step, last step, run-time kernel forced)
STEP_CASES = {
    "cggi_gadget_27_bits": (CggiParams(n=4, big_n=64, l_gsw=3, log_b_gsw=9, **_CGGI), 2, 3, 0, 4, False),
    "one_step": (CggiParams(n=4, big_n=64, l_gsw=3, log_b_gsw=8, **_CGGI), 2, 2, 2, 3, False),
    "later_range": (CggiParams(n=5, big_n=64, l_gsw=2, log_b_gsw=10, **_CGGI), 2, 2, 1, 5, False),
    "gadget_32_bits": (CggiParams(n=3, big_n=64, l_gsw=4, log_b_gsw=8, **_CGGI), 2, 2, 0, 3, False),
    "gadget_2x16": (CggiParams(n=2, big_n=64, l_gsw=2, log_b_gsw=16, **_CGGI), 3, 2, 0, 2, False),
    "one_digit": (CggiParams(n=3, big_n=64, l_gsw=1, log_b_gsw=7, **_CGGI), 2, 2, 0, 3, False),
    "l6_n128_3primes": (CggiParams(n=2, big_n=128, l_gsw=6, log_b_gsw=5, **_CGGI), 3, 2, 0, 2, False),
    "n256_4primes": (CggiParams(n=2, big_n=256, l_gsw=3, log_b_gsw=9, **_CGGI), 4, 1, 0, 2, False),
    # preset TinyCGGI's shape over its last steps, and a 32-bit gadget at N = 512
    "tiny_cggi": (TINY_CGGI, 2, 3, 12, 16, False),
    "n512_gadget_32_bits": (CggiParams(n=2, big_n=512, l_gsw=2, log_b_gsw=16, **_CGGI), 2, 1, 0, 2, False),
    # the instance of preset CGGI, and the same shape through the kernel with
    # run-time shapes
    "instance_cggi": (dataclasses.replace(CGGI_PARAM, n=3), 2, 2, 0, 3, False),
    "instance_cggi_run_time_shapes": (dataclasses.replace(CGGI_PARAM, n=2), 2, 1, 0, 2, True),
}
# what the dispatcher picks (the last case runs the kernel with run-time shapes all the same)
STEP_INSTANCE = {
    "instance_cggi": "cggi_step_kernel<10,3,2,2>",
    "instance_cggi_run_time_shapes": "cggi_step_kernel<10,3,2,2>",
}


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_cggi_step_kernel_source_matches_plain(step_lib, name):
    """The 32-bit decomposition (rounding carry live below 32 gadget bits),
    the u32 Garner and the step range, from accumulators with extreme bits,
    through the kernel the source's dispatcher picks (or the kernel with
    run-time shapes where the case forces it)."""
    params, npr, g, i0, i1, run_time_shapes = STEP_CASES[name]
    ctx = make_ring_ctx(params.big_n, 32, npr)
    n, l = ctx.n, params.l_gsw
    assert fused_step.step_kernel(params, ctx, step_lib)["name"] == STEP_INSTANCE.get(name, RUN_TIME)
    rng = np.random.default_rng(len(name))
    p = np.array(PRIMES[:npr], dtype=np.int64)[:, None, None, None]
    brk = torch.from_numpy((rng.integers(0, 1 << 62, size=(params.n, npr, 2 * l, 2, n)) % p).astype(np.int32))
    ta = torch.from_numpy(rng.integers(0, 2 * n, size=(g, params.n)).astype(np.int32))
    ta[0, i0], ta[-1, i1 - 1] = 0, 2 * n - 1
    mono = kms.monomial_table(ctx, CPU)
    acc0 = rng.integers(-(1 << 31), (1 << 31) - 1, size=(g, 2, n), dtype=np.int64).astype(np.int32)
    low = 32 - l * params.log_b_gsw
    edge = [0, -1, -(1 << 31), (1 << 31) - 1, 1, 1 << 30, -(1 << 30)]
    if low:  # the rounding bit under all-ones digit fields: the carry runs through every digit
        edge += [-(1 << (low - 1)), (1 << 31) - (1 << (low - 1)), (1 << (low - 1)) - 1]
    acc0[0, 0, : len(edge)] = edge
    acc0[0, 1, : len(edge)] = edge[::-1]
    acc0 = torch.from_numpy(acc0)
    want = fused_step.cggi_step(acc0, ta, brk, mono, params, ctx, i0, i1)
    got = acc0.clone()
    tw_f, tw_f_sh, _ = kntt._kernel_tables(n, npr, True, CPU)
    tw_i, tw_i_sh, _ = kntt._kernel_tables(n, npr, False, CPU)
    consts = fused_mx3._sweep_consts(n, npr, CPU)
    err = step_lib.host_cggi_step(
        got.data_ptr(), ta.data_ptr(), brk.data_ptr(), mono.data_ptr(),
        tw_f.data_ptr(), tw_f_sh.data_ptr(), tw_i.data_ptr(), tw_i_sh.data_ptr(),
        consts.data_ptr(), ctx.crt.prod_mod32, g, params.n, i0, i1, npr, l,
        params.log_b_gsw, n.bit_length() - 1, int(run_time_shapes),
    )
    assert err == 0
    assert torch.equal(got, want), f"{int((got != want).sum())} of {want.numel()} differ"
