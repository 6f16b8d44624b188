"""csrc/mx_sweep.cu (B5), its device code run on the CPU.

The mx sweep's instances and its kernel with run-time shapes, with the power
table in either memory, against `fused_mx2.mx_sweep_plain`.
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

from mktfhe_tpu_torch.kernels import fused_mx2, fused_mx3
from mktfhe_tpu_torch.kernels import ntt as kntt
from mktfhe_tpu_torch.ring.context import make_ring_ctx
from mktfhe_tpu_torch.ring.modring import PRIMES
from mktfhe_tpu_torch.schemes.params import KmsParams
from mktfhe_tpu_torch.tools import host_kernels

CPU = torch.device("cpu")
_COMMON = dict(alpha=16.0, f=8, log_d=2, beta=4.0, l_lev=2, log_b_lev=8, l_uni=3, log_b_uni=8, k=2)


@pytest.fixture(scope="module")
def mx_lib(tmp_path_factory):
    try:
        return host_kernels.library("mx_sweep", tmp_path_factory.mktemp("mx_host"))
    except host_kernels.Unavailable as err:
        pytest.skip(str(err))


_MX = KmsParams(n=4, big_n=128, l_gsw=3, log_b_gsw=8, **_COMMON)
# (parameters, primes, gates, rows, power table in shared memory)
MX_CASES = {
    "n128_row1": (_MX, 3, 3, 1, True),
    "n128_rows_l_lev": (_MX, 3, 2, 2, True),
    "n128_4primes_table_in_device_memory": (_MX, 4, 2, 2, False),
    "n128_wide_gadget_4primes": (dataclasses.replace(_MX, log_b_gsw=12), 4, 2, 1, True),
    "n128_l6_2primes": (dataclasses.replace(_MX, l_gsw=6, log_b_gsw=7), 2, 2, 1, False),
    "n256_row1": (dataclasses.replace(_MX, big_n=256, n=3), 3, 2, 1, True),
    "n256_rows_l_lev_4primes": (dataclasses.replace(_MX, big_n=256, n=3), 4, 1, 2, True),
    "n256_wide_gadget": (dataclasses.replace(_MX, big_n=256, n=3, log_b_gsw=12), 3, 2, 2, False),
    "n512_one_digit": (dataclasses.replace(_MX, big_n=512, n=2, l_gsw=1, log_b_gsw=9), 3, 1, 2, True),
    # nb = 8: the first size at which a warp's 4 values of k2' are not all of them
    "n1024_two_digits": (dataclasses.replace(_MX, big_n=1024, n=2, l_gsw=2, log_b_gsw=9), 3, 1, 1, True),
    "n2048_kms8party_gadget": (dataclasses.replace(_MX, big_n=2048, n=1, l_gsw=4, log_b_gsw=9), 3, 1, 1, True),
    "n1024_table_in_device_memory": (
        dataclasses.replace(_MX, big_n=1024, n=2, l_gsw=2, log_b_gsw=9), 3, 1, 1, False),
    # the shapes the kernel is compiled for (csrc/mx_sweep.cu:mx_plan); None:
    # the kernel and the table's place as the source's dispatcher picks them
    "instance_kms8party": (dataclasses.replace(_MX, big_n=2048, n=2, l_gsw=4, log_b_gsw=9), 3, 1, 1, None),
    "instance_wide_gadget": (dataclasses.replace(_MX, big_n=256, n=3, log_b_gsw=12), 3, 2, 2, None),
    "instance_six_digits_table_in_device_memory": (
        dataclasses.replace(_MX, big_n=2048, n=1, l_gsw=6, log_b_gsw=7), 4, 1, 1, None),
    "instance_kms2party": (dataclasses.replace(_MX, big_n=2048, n=1, l_gsw=3, log_b_gsw=12), 4, 1, 1, None),
    "instance_kms16party": (dataclasses.replace(_MX, big_n=2048, n=1, l_gsw=5, log_b_gsw=8), 3, 1, 1, None),
    "instance_kms32party": (dataclasses.replace(_MX, big_n=2048, n=1, l_gsw=6, log_b_gsw=7), 3, 1, 1, None),
}
MX_INSTANCE = {
    "instance_kms8party": "mx_sweep_kernel<1,11,4,3>",
    "instance_wide_gadget": "mx_sweep_kernel<1,8,3,3>",
    "instance_six_digits_table_in_device_memory": "mx_sweep_kernel<0,11,6,4>",
    "instance_kms2party": "mx_sweep_kernel<1,11,3,4>",
    "instance_kms16party": "mx_sweep_kernel<1,11,5,3>",
    "instance_kms32party": "mx_sweep_kernel<1,11,6,3>",
}


@pytest.mark.parametrize("name", list(MX_CASES))
def test_mx_sweep_kernel_source_matches_plain(mx_lib, name):
    """The key's mx order read through the permutation (nb = 1, 2, 4), the
    monomial from the power table in either memory, the key's own prime
    count, from accumulators with extreme bits."""
    params, npr, g, rows, pow_shared = MX_CASES[name]
    ctx = make_ring_ctx(params.big_n, 64, npr)
    n, l = ctx.n, params.l_gsw
    rng = np.random.default_rng(len(name))
    p = np.array(PRIMES[:npr], dtype=np.int64)[:, None, None, None]
    brk = torch.from_numpy((rng.integers(0, 1 << 62, size=(params.n, npr, 2 * l, 2, n)) % p).astype(np.int32))
    ta = torch.from_numpy(rng.integers(0, 2 * n, size=(g, params.n)).astype(np.int32))
    ta[0, 0], ta[-1, -1] = 0, 2 * n - 1
    acc0 = rng.integers(-(1 << 63), (1 << 63) - 1, size=(g, rows, 2, n), dtype=np.int64)
    acc0[0, 0, 0, :8] = [-1, -(1 << 63), (1 << 63) - 1, 0, 1, -(1 << 62), (1 << 62) - 1, -2]
    acc0 = torch.from_numpy(acc0)
    want = fused_mx2.mx_sweep(ta, brk, rows, params, ctx, acc0)
    got = acc0.clone()
    tw_f, tw_f_sh, _ = kntt._kernel_tables(n, npr, True, CPU)
    tw_i, tw_i_sh, _ = kntt._kernel_tables(n, npr, False, CPU)
    consts = fused_mx3._sweep_consts(n, npr, CPU)
    powers = fused_mx2._power_table_on(n, npr, CPU)
    if pow_shared is None:  # a forced table place runs the kernel with run-time shapes
        assert fused_mx2.mx_kernel(params, ctx, mx_lib)["name"] == MX_INSTANCE[name]
    err = mx_lib.host_mx_sweep(
        got.data_ptr(), ta.data_ptr(), brk.data_ptr(), powers.data_ptr(),
        tw_f.data_ptr(), tw_f_sh.data_ptr(), tw_i.data_ptr(), tw_i_sh.data_ptr(),
        consts.data_ptr(), ctx.crt.prod_mod64, g * rows, rows, params.n, npr, l,
        params.log_b_gsw, n.bit_length() - 1, -1 if pow_shared is None else int(pow_shared),
    )
    assert err == 0
    assert torch.equal(got, want), f"{int((got != want).sum())} of {want.numel()} differ"
