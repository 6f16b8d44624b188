"""csrc/phase1_sweep.cu (B2), its device code run on the CPU.

Every template instance of the phase-1 sweep and the kernel with run-time
shapes, block and binary keys, against `fused_mx3.phase1_sweep_plain`; and
one launch over several parties (`fused_mx3.phase1_sweeps`' grid) against
the plain version party by party.
The device code is compiled for the host with g++
(mktfhe_tpu_torch/tools/host_kernels.py: one std::thread per CUDA thread, a
std::barrier for `__syncthreads()`) and held bit for bit against the plain
PyTorch versions (tolerance 0).  It says nothing about what nvcc accepts or
about speed.  Skips where there is no g++ with C++20.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from mktfhe_tpu_torch.kernels import fused_mx3
from mktfhe_tpu_torch.kernels import ntt as kntt
from mktfhe_tpu_torch.ring.context import make_ring_ctx
from mktfhe_tpu_torch.ring.modring import PRIMES
from mktfhe_tpu_torch.schemes import kms
from mktfhe_tpu_torch.schemes.params import KmsBlockParams, KmsParams
from mktfhe_tpu_torch.tools import host_kernels

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def sweep_lib(tmp_path_factory):
    try:
        return host_kernels.library("phase1_sweep", tmp_path_factory.mktemp("sweep_host"))
    except host_kernels.Unavailable as err:
        pytest.skip(str(err))


def _host_launch(lib, acc, ta, brk, parties, first_rows, rows, mono, params, ctx, run_time_shapes=False):
    """The wrapper's launch (fused_mx3._launch) on the host library, into
    `acc` in place, through the kernel the source's dispatcher picks, or
    through the kernel with run-time shapes."""
    n, npr = ctx.n, ctx.nprimes
    ell = params.ell if isinstance(params, KmsBlockParams) else 1
    tw_f, tw_f_sh, _ = kntt._kernel_tables(n, npr, True, CPU)
    tw_i, tw_i_sh, _ = kntt._kernel_tables(n, npr, False, CPU)
    consts = fused_mx3._sweep_consts(n, npr, CPU)
    err = lib.host_phase1_sweep(
        acc.data_ptr(), ta.data_ptr(), brk.data_ptr(),
        mono.data_ptr() if isinstance(params, KmsBlockParams) else None,
        tw_f.data_ptr(), tw_f_sh.data_ptr(), tw_i.data_ptr(), tw_i_sh.data_ptr(),
        consts.data_ptr(), ctx.crt.prod_mod64, acc.shape[0], ta.shape[0], parties, first_rows, rows,
        params.n // ell, ell, npr, params.l_gsw, params.log_b_gsw, n.bit_length() - 1, int(run_time_shapes),
    )
    assert err == 0


def _host_sweep(lib, ta, brk, rows, mono, params, ctx, acc0, run_time_shapes=False):
    """One party's sweep (`fused_mx3.phase1_sweep`'s launch) on the host
    library."""
    fused_mx3._check(ta, brk, rows, mono, params, ctx, acc0)
    acc = acc0.clone()
    _host_launch(lib, acc.view(-1, 2, ctx.n), ta, brk, 1, rows, rows, mono, params, ctx, run_time_shapes)
    return acc


_COMMON = dict(alpha=16.0, f=8, log_d=2, beta=4.0, l_lev=2, log_b_lev=8, l_uni=3, log_b_uni=8, k=2)
BINARY = KmsParams(n=5, big_n=64, l_gsw=3, log_b_gsw=8, **_COMMON)
BLOCK = KmsBlockParams(d=3, ell=3, big_n=64, l_gsw=3, log_b_gsw=8, **_COMMON)
# (parameters, primes, gates, rows)
SWEEP_CASES = {
    "binary": (BINARY, 3, 3, 2),
    "binary_row1": (BINARY, 3, 2, 1),
    "binary_wide_gadget": (dataclasses.replace(BINARY, log_b_gsw=12), 3, 2, 2),
    "binary_l6_4primes": (dataclasses.replace(BINARY, l_gsw=6, log_b_gsw=7), 4, 2, 1),
    "binary_64_digit_bits": (dataclasses.replace(BINARY, l_gsw=4, log_b_gsw=16), 4, 2, 1),
    "binary_one_digit": (dataclasses.replace(BINARY, l_gsw=1, log_b_gsw=9), 3, 2, 1),
    "binary_n128_2primes": (dataclasses.replace(BINARY, big_n=128), 2, 2, 2),
    "block": (BLOCK, 3, 3, 2),
    "block_row1": (BLOCK, 3, 2, 1),
    "block_n128_4primes": (dataclasses.replace(BLOCK, l_gsw=4, log_b_gsw=9, big_n=128), 4, 2, 2),
    "block_ell1": (dataclasses.replace(BLOCK, ell=1, d=4), 3, 2, 2),
    "block_n256_ell2": (dataclasses.replace(BLOCK, big_n=256, ell=2), 3, 1, 2),
    # index arithmetic of the passes and the swizzle beyond 8 address bits
    "binary_n1024": (dataclasses.replace(BINARY, big_n=1024, n=2, l_gsw=2, log_b_gsw=9), 3, 1, 1),
    "block_n1024": (dataclasses.replace(BLOCK, big_n=1024, d=1, ell=2, l_gsw=2, log_b_gsw=9), 3, 1, 1),
    "block_n2048_run_time_shapes": (
        dataclasses.replace(BLOCK, big_n=2048, d=1, ell=2, l_gsw=2, log_b_gsw=10), 3, 1, 1),
    # the shapes the kernel is compiled for (csrc/phase1_sweep.cu:sweep_plan)
    "instance_kms8partyblock": (
        dataclasses.replace(BLOCK, big_n=2048, d=1, ell=3, l_gsw=4, log_b_gsw=9), 4, 1, 1),
    "instance_kms8party": (dataclasses.replace(BINARY, big_n=2048, n=2, l_gsw=4, log_b_gsw=9), 3, 1, 1),
    "instance_wide_gadget": (dataclasses.replace(BINARY, big_n=256, n=3, log_b_gsw=12), 3, 2, 2),
    "instance_kms2party": (dataclasses.replace(BINARY, big_n=2048, n=1, l_gsw=3, log_b_gsw=12), 4, 1, 1),
    "instance_kms16party": (dataclasses.replace(BINARY, big_n=2048, n=1, l_gsw=5, log_b_gsw=8), 3, 1, 1),
    "instance_kms32party": (dataclasses.replace(BINARY, big_n=2048, n=1, l_gsw=6, log_b_gsw=7), 3, 1, 1),
    "instance_kms2partyblock": (
        dataclasses.replace(BLOCK, big_n=2048, d=1, ell=3, l_gsw=3, log_b_gsw=12), 4, 1, 1),
    "instance_kms16partyblock": (
        dataclasses.replace(BLOCK, big_n=2048, d=1, ell=3, l_gsw=5, log_b_gsw=8), 3, 1, 1),
    "instance_kms32partyblock": (
        dataclasses.replace(BLOCK, big_n=2048, d=1, ell=3, l_gsw=6, log_b_gsw=7), 3, 1, 1),
}
SWEEP_INSTANCE = {
    "instance_kms8partyblock": "phase1_sweep_kernel<1,11,4,4,3>",
    "instance_kms8party": "phase1_sweep_kernel<0,11,4,3,1>",
    "instance_wide_gadget": "phase1_sweep_kernel<0,8,3,3,1>",
    "instance_kms2party": "phase1_sweep_kernel<0,11,3,4,1>",
    "instance_kms16party": "phase1_sweep_kernel<0,11,5,3,1>",
    "instance_kms32party": "phase1_sweep_kernel<0,11,6,3,1>",
    "instance_kms2partyblock": "phase1_sweep_kernel<1,11,3,4,3>",
    "instance_kms16partyblock": "phase1_sweep_kernel<1,11,5,3,3>",
    "instance_kms32partyblock": "phase1_sweep_kernel<1,11,6,3,3>",
}


@functools.cache
def _monomial_table(n: int, npr: int) -> torch.Tensor:
    """One table per ring for all the block cases (seconds at N = 2048)."""
    return kms.monomial_table(make_ring_ctx(n, 64, npr), CPU)


@pytest.mark.parametrize("name", list(SWEEP_CASES))
def test_sweep_kernel_source_matches_plain(sweep_lib, name):
    params, npr, g, rows = SWEEP_CASES[name]
    ctx = make_ring_ctx(params.big_n, 64, npr)
    n = ctx.n
    rng = np.random.default_rng(len(name))
    p = np.array(PRIMES[:npr], dtype=np.int64)[:, None]
    shape = (params.n, 2, params.l_gsw, 2, npr, n)
    brk = torch.from_numpy((rng.integers(0, 1 << 62, size=shape) % p).astype(np.int32))
    ta = torch.from_numpy(rng.integers(0, 2 * n, size=(g, params.n)).astype(np.int32))
    ta[0, 0], ta[-1, -1] = 0, 2 * n - 1
    mono = _monomial_table(n, npr) if isinstance(params, KmsBlockParams) else None
    acc0 = rng.integers(-(1 << 63), (1 << 63) - 1, size=(g, rows, 2, n), dtype=np.int64)
    acc0[0, 0, 0, :8] = [-1, -(1 << 63), (1 << 63) - 1, 0, 1, -(1 << 62), (1 << 62) - 1, -2]
    acc0 = torch.from_numpy(acc0)
    want = fused_mx3.phase1_sweep_plain(ta, brk, rows, mono, params, ctx, acc0)
    kernel = fused_mx3.sweep_kernel(params, ctx, sweep_lib)
    run_time = "phase1_sweep_kernel<1,0,0,0,0>" if mono is not None else "phase1_sweep_kernel<0,0,0,0,1>"
    assert kernel["name"] == SWEEP_INSTANCE.get(name, run_time)
    got = _host_sweep(sweep_lib, ta, brk, rows, mono, params, ctx, acc0)
    assert torch.equal(got, want), f"{int((got != want).sum())} of {want.numel()} differ"
    if not kernel["run_time_shapes"] and n < 2048:  # the same shape through the kernel with run-time shapes
        assert torch.equal(_host_sweep(sweep_lib, ta, brk, rows, mono, params, ctx, acc0, True), want)


# (parameters, primes, gates, parties, rows of parties 2..k)
SWEEPS_CASES = {
    "binary": (dataclasses.replace(BINARY, n=3), 3, 2, 3, 2),
    "block": (dataclasses.replace(BLOCK, d=1, big_n=128), 3, 2, 3, 2),
}


@pytest.mark.parametrize("name", list(SWEEPS_CASES))
def test_multi_party_sweep_matches_plain_party_by_party(sweep_lib, name):
    """One launch over (party, gate, row), as `fused_mx3.phase1_sweeps`
    makes it (party 1 one row, the others `rows`), from the buffer of
    `phase1_sweeps_init`: every party's accumulator == `phase1_sweep_plain`
    on that party's tildea columns and keys."""
    params, npr, g, parties, rows = SWEEPS_CASES[name]
    params = dataclasses.replace(params, k=parties, l_lev=rows)
    ctx = make_ring_ctx(params.big_n, 64, npr)
    n = ctx.n
    rng = np.random.default_rng(7 + len(name))
    p = np.array(PRIMES[:npr], dtype=np.int64)[:, None]
    brk = rng.integers(0, 1 << 62, size=(parties, params.n, 2, params.l_gsw, 2, npr, n)) % p
    brk = torch.from_numpy(brk.astype(np.int32))
    ta = torch.from_numpy(rng.integers(0, 2 * n, size=(g, parties * params.n)).astype(np.int32))
    mono = _monomial_table(n, npr) if isinstance(params, KmsBlockParams) else None
    fused_mx3._check(ta, brk, rows, mono, params, ctx, None, parties=parties)
    acc = fused_mx3.phase1_sweeps_init(g, parties, rows, params, ctx, CPU)
    _host_launch(sweep_lib, acc, ta, brk, parties, 1, rows, mono, params, ctx)
    got = fused_mx3._party_views(acc, g, parties, rows)
    want = fused_mx3.phase1_sweeps(ta, brk, rows, mono, params, ctx)
    tild = ta.reshape(g, parties, params.n)
    for party in range(parties):
        party_rows = 1 if party == 0 else rows
        plain = fused_mx3.phase1_sweep_plain(tild[:, party].contiguous(), brk[party], party_rows, mono, params, ctx)
        assert tuple(got[party].shape) == (g, party_rows, 2, n)
        assert torch.equal(got[party], plain), f"party {party + 1}"
        assert torch.equal(want[party], plain), f"party {party + 1}"
