"""The CUDA kernels' own source, run on the CPU.

There is no CUDA compiler or card where the CPU tests run, so the kernels
in mktfhe_tpu_torch/csrc/ are otherwise only checked on the card
(tests/test_torch_cuda.py, chip_smoke.py).  Here the device code of each
source (ntt.cu, phase1_sweep.cu, cggi_step.cu, mx_sweep.cu, butterfly_rate.cu)
-- everything above its `extern "C"` entry points -- is compiled for the host with g++ against a small stand-in for the CUDA runtime header: one
std::thread per CUDA thread, a std::barrier for `__syncthreads()`, CTAs one
after the other.  That exercises the kernels' arithmetic, indexing and
barrier placement at small sizes, bit for bit against the plain PyTorch
versions (tolerance 0).  It says nothing about what nvcc accepts or about
speed.  Skips where there is no g++ with C++20.
"""

import ctypes
import dataclasses
import functools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mktfhe_tpu_torch.kernels import fused_mx2, fused_mx3, fused_step
from mktfhe_tpu_torch.kernels import ntt as kntt
from mktfhe_tpu_torch.ring.context import make_ring_ctx
from mktfhe_tpu_torch.ring.modring import PRIMES
from mktfhe_tpu_torch.ring.ntt import fwd_ntt, inv_ntt, make_plan
from mktfhe_tpu_torch.schemes import kms
from mktfhe_tpu_torch.schemes.params import CggiParams, KmsBlockParams, KmsParams

CPU = torch.device("cpu")

SHIM = r"""
#pragma once
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
struct Dim3 { int x = 0; };
struct alignas(16) uint4 { uint32_t x, y, z, w; };
inline thread_local Dim3 threadIdx, blockIdx, blockDim;
inline std::barrier<>* g_barrier = nullptr;
inline void __syncthreads() { g_barrier->arrive_and_wait(); }
inline uint32_t __umulhi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
inline uint64_t __umul64hi(uint64_t a, uint64_t b) {
    return (uint64_t)(((unsigned __int128)a * b) >> 64);
}
inline uint32_t min(uint32_t a, uint32_t b) { return a < b ? a : b; }
inline uint32_t __brev(uint32_t v) {
    uint32_t r = 0;
    for (int i = 0; i < 32; ++i) r |= ((v >> i) & 1u) << (31 - i);
    return r;
}
alignas(16) inline unsigned char g_smem[1 << 20];
// one CTA after the other, `threads` host threads each
template <typename F>
void run_grid(long long ctas, int threads, F body) {
    for (long long c = 0; c < ctas; ++c) {
        std::barrier<> bar(threads);
        g_barrier = &bar;
        std::vector<std::thread> pool;
        for (int t = 0; t < threads; ++t) pool.emplace_back([=]() {
            threadIdx.x = t; blockIdx.x = (int)c; blockDim.x = threads;
            body();
        });
        for (auto& th : pool) th.join();
    }
}
"""

# each kernel's dynamic shared memory becomes a pointer to the stand-in's buffer
DYNAMIC_SHARED = {
    "extern __shared__ __align__(16) unsigned char smem[];": "unsigned char* smem = g_smem;",
    "extern __shared__ __align__(16) uint32_t a[];": "uint32_t* a = (uint32_t*)g_smem;",
}

# the kernel that the source's dispatcher picks for the shape, or, with
# `run_time_shapes` set, the kernel with run-time shapes whatever the shape;
# the second entry point is the C library's own, word for word
SWEEP_ENTRY = r"""
extern "C" int host_phase1_sweep(void* acc, const void* tildea, const void* brk, const void* mono,
        const void* tw_f, const void* tw_f_sh, const void* tw_i, const void* tw_i_sh,
        const void* consts, unsigned long long prod_mod64, long long ctas, int rows, int n_steps,
        int ell, int npr, int l, int log_b, int log_n, int run_time_shapes) {
    const SweepShape shape{rows, n_steps, ell, npr, l, log_b, log_n};
    const SweepPlan plan = sweep_plan(mono != nullptr, shape);
    const SweepKernel kernel = !run_time_shapes ? plan.kernel
        : mono != nullptr ? &phase1_sweep_kernel<true, 0, 0, 0, 0> : &phase1_sweep_kernel<false, 0, 0, 0, 1>;
    if (plan.shared_bytes > (int)sizeof(g_smem)) return 2;
    run_grid(ctas, plan.threads, [=]() {
        kernel((uint64_t*)acc, (const int32_t*)tildea, (const uint32_t*)brk, (const uint32_t*)mono,
               (const uint32_t*)tw_f, (const uint32_t*)tw_f_sh, (const uint32_t*)tw_i,
               (const uint32_t*)tw_i_sh, (const uint64_t*)consts, prod_mod64, shape);
    });
    return 0;
}
extern "C" void mktfhe_phase1_sweep_describe(int block, int ell, int npr, int l, int log_n,
                                             int* out) {
    describe_plan(block, ell, npr, l, log_n, out);
}
"""

NTT_ENTRY = r"""
extern "C" void host_ntt_nat(const void* x, void* y, const void* tw, const void* tw_sh,
        const void* consts, long long polys, int npr, int log_n, int forward) {
    auto kernel = forward ? &ntt_nat_kernel<true> : &ntt_nat_kernel<false>;
    run_grid(polys, (1 << log_n) / 2, [=]() {
        kernel((const uint32_t*)x, (uint32_t*)y, (const uint32_t*)tw, (const uint32_t*)tw_sh,
               (const uint32_t*)consts, npr, log_n);
    });
}
"""

NTT_BM_ENTRY = r"""
extern "C" void host_ntt_bm(const void* x, void* y, const void* tw, const void* tw_sh,
        const void* consts, int npr, int rows, int gates, int log_n, int forward) {
    auto kernel = forward ? &ntt_bm_kernel<true> : &ntt_bm_kernel<false>;
    const long long tiles = (gates + kGt - 1) / kGt;
    run_grid(npr * rows * tiles, (1 << log_n) / 2, [=]() {
        kernel((const uint32_t*)x, (uint32_t*)y, (const uint32_t*)tw, (const uint32_t*)tw_sh,
               (const uint32_t*)consts, rows, gates, log_n);
    });
}
"""

STEP_ENTRY = r"""
extern "C" void host_cggi_step(void* acc, const void* tildea, const void* brk, const void* mono,
        const void* tw_f, const void* tw_f_sh, const void* tw_i, const void* tw_i_sh,
        const void* consts, unsigned int prod_mod32, long long gates, int n_total, int i0, int i1,
        int npr, int l, int log_b, int log_n) {
    const StepShape shape{n_total, i0, i1, npr, l, log_b, log_n};
    run_grid(gates, (1 << log_n) / 2, [=]() {
        cggi_step_kernel((uint32_t*)acc, (const int32_t*)tildea, (const uint32_t*)brk,
                         (const uint32_t*)mono, (const uint32_t*)tw_f, (const uint32_t*)tw_f_sh,
                         (const uint32_t*)tw_i, (const uint32_t*)tw_i_sh, (const uint64_t*)consts,
                         prod_mod32, shape);
    });
}
"""

# `pow_shared` < 0: the kernel that the source's dispatcher picks for the
# shape; 0 / 1: the kernel with run-time shapes with the power table in device
# / shared memory, and the twiddles where the table is: both ways run in the
# cases of the test.  The second entry point is the C library's own.
MX_ENTRY = r"""
extern "C" int host_mx_sweep(void* acc, const void* tildea, const void* brk, const void* pow,
        const void* tw_f, const void* tw_f_sh, const void* tw_i, const void* tw_i_sh,
        const void* consts, unsigned long long prod_mod64, long long ctas, int rows, int n_steps,
        int npr, int l, int log_b, int log_n, int pow_shared) {
    const MxPlan plan = mx_plan(log_n, npr, l);
    const MxKernel kernel = pow_shared < 0 ? plan.kernel
        : pow_shared ? &mx_sweep_kernel<true, 0, 0, 0> : &mx_sweep_kernel<false, 0, 0, 0>;
    const MxShape shape{rows, n_steps, npr, l, log_b, log_n,
                        pow_shared < 0 ? plan.tw_shared : pow_shared != 0};
    if (2 * plan.shared_bytes > sizeof(g_smem)) return 2;  // room for a table forced into shared memory
    run_grid(ctas, plan.threads, [=]() {
        kernel((uint64_t*)acc, (const int32_t*)tildea, (const uint32_t*)brk, (const uint32_t*)pow,
               (const uint32_t*)tw_f, (const uint32_t*)tw_f_sh, (const uint32_t*)tw_i,
               (const uint32_t*)tw_i_sh, (const uint64_t*)consts, prod_mod64, shape);
    });
    return 0;
}
extern "C" void mktfhe_mx_sweep_describe(int npr, int l, int log_n, int* out) {
    describe_plan(npr, l, log_n, out);
}
"""

RATE_ENTRY = r"""
extern "C" void host_butterfly_rate(void* out, const void* tw, const void* tw_sh, unsigned int p,
        unsigned int seed, int rounds, int forward, int ctas, int threads) {
    auto kernel = forward ? &butterfly_rate_kernel<true> : &butterfly_rate_kernel<false>;
    run_grid(ctas, threads, [=]() {
        kernel((uint32_t*)out, (const uint32_t*)tw, (const uint32_t*)tw_sh, p, seed, rounds);
    });
}
"""


def _host_library(source, entry: str, workdir):
    """The device code of `source` plus `entry`, compiled for the host."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    text = source.read_text()
    device_code = text[: text.index('extern "C"')]
    for dynamic, pointer in DYNAMIC_SHARED.items():
        device_code = device_code.replace(dynamic, pointer)
    assert "extern __shared__" not in device_code
    (workdir / "cuda_runtime.h").write_text(SHIM)
    (workdir / "modarith.cuh").write_text((source.parent / "modarith.cuh").read_text())
    cpp = workdir / f"{source.stem}_host.cpp"
    cpp.write_text(device_code + entry)
    lib = workdir / f"lib{source.stem}_host.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-I", str(workdir), "-shared", "-fPIC", "-pthread",
         "-o", str(lib), str(cpp)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0 and "c++20" in proc.stderr:
        pytest.skip("needs a g++ with C++20 (std::barrier)")
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def sweep_lib(tmp_path_factory):
    lib = _host_library(fused_mx3.SOURCE, SWEEP_ENTRY, tmp_path_factory.mktemp("sweep_host"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.host_phase1_sweep.argtypes = [ptr] * 9 + [ctypes.c_ulonglong, ctypes.c_longlong] + [i32] * 8
    lib.host_phase1_sweep.restype = i32
    return lib


@pytest.fixture(scope="module")
def ntt_lib(tmp_path_factory):
    lib = _host_library(kntt.SOURCE, NTT_ENTRY + NTT_BM_ENTRY, tmp_path_factory.mktemp("ntt_host"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.host_ntt_nat.argtypes = [ptr] * 5 + [ctypes.c_longlong, i32, i32, i32]
    lib.host_ntt_nat.restype = None
    lib.host_ntt_bm.argtypes = [ptr] * 5 + [i32] * 5
    lib.host_ntt_bm.restype = None
    return lib


@pytest.fixture(scope="module")
def step_lib(tmp_path_factory):
    lib = _host_library(fused_step.SOURCE, STEP_ENTRY, tmp_path_factory.mktemp("step_host"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.host_cggi_step.argtypes = [ptr] * 9 + [ctypes.c_uint, ctypes.c_longlong] + [i32] * 7
    lib.host_cggi_step.restype = None
    return lib


@pytest.fixture(scope="module")
def mx_lib(tmp_path_factory):
    lib = _host_library(fused_mx2.SOURCE, MX_ENTRY, tmp_path_factory.mktemp("mx_host"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.host_mx_sweep.argtypes = [ptr] * 9 + [ctypes.c_ulonglong, ctypes.c_longlong] + [i32] * 7
    lib.host_mx_sweep.restype = i32
    return lib


def _host_sweep(lib, ta, brk, rows, mono, params, ctx, acc0, run_time_shapes=False):
    """The wrapper's launch (fused_mx3._launch), on the host library, through
    the kernel the source's dispatcher picks, or through the kernel with
    run-time shapes."""
    fused_mx3._check(ta, brk, rows, mono, params, ctx, acc0)
    n, npr = ctx.n, ctx.nprimes
    ell = params.ell if isinstance(params, KmsBlockParams) else 1
    acc = acc0.clone()
    tw_f, tw_f_sh, _ = kntt._kernel_tables(n, npr, True, CPU)
    tw_i, tw_i_sh, _ = kntt._kernel_tables(n, npr, False, CPU)
    consts = fused_mx3._sweep_consts(n, npr, CPU)
    err = lib.host_phase1_sweep(
        acc.data_ptr(), ta.data_ptr(), brk.data_ptr(),
        mono.data_ptr() if isinstance(params, KmsBlockParams) else None,
        tw_f.data_ptr(), tw_f_sh.data_ptr(), tw_i.data_ptr(), tw_i_sh.data_ptr(),
        consts.data_ptr(), ctx.crt.prod_mod64, ta.shape[0] * rows, rows, params.n // ell, ell,
        npr, params.l_gsw, params.log_b_gsw, n.bit_length() - 1, int(run_time_shapes),
    )
    assert err == 0
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


@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("npr", [2, 3, 4])
def test_ntt_kernel_source_matches_plain(ntt_lib, n, npr):
    plan = make_plan(n, npr)
    rng = np.random.default_rng(n + npr)
    p = np.array(PRIMES[:npr], dtype=np.int64)[:, None]
    x = torch.from_numpy((rng.integers(0, 1 << 62, size=(3, npr, n)) % p).astype(np.int32))
    for forward, plain in ((True, fwd_ntt), (False, inv_ntt)):
        tw, tw_sh, consts = kntt._kernel_tables(n, npr, forward, CPU)
        out = torch.empty_like(x)
        ntt_lib.host_ntt_nat(
            x.data_ptr(), out.data_ptr(), tw.data_ptr(), tw_sh.data_ptr(), consts.data_ptr(),
            x.numel() // n, npr, n.bit_length() - 1, int(forward),
        )
        assert torch.equal(out, plain(x, plan))


@pytest.mark.parametrize("gates", [5, 8, 19], ids=lambda g: f"G{g}")
@pytest.mark.parametrize("n,npr", [(64, 2), (128, 3), (256, 4)])
def test_ntt_bm_kernel_source_matches_plain(ntt_lib, n, npr, gates):
    """The batch-minor load/store path: whole tiles of 8 gates and a ragged
    last one (5 = one short tile, 19 = two whole and one of 3)."""
    plan = make_plan(n, npr)
    rows = 3
    rng = np.random.default_rng(n + npr + gates)
    p = np.array(PRIMES[:npr], dtype=np.int64)[:, None, None, None]
    x = torch.from_numpy((rng.integers(0, 1 << 62, size=(npr, rows, n, gates)) % p).astype(np.int32))
    for forward in (True, False):
        tw, tw_sh, consts = kntt._kernel_tables(n, npr, forward, CPU)
        out = torch.full_like(x, -1)
        ntt_lib.host_ntt_bm(
            x.data_ptr(), out.data_ptr(), tw.data_ptr(), tw_sh.data_ptr(), consts.data_ptr(),
            npr, rows, gates, n.bit_length() - 1, int(forward),
        )
        assert torch.equal(out, kntt.ntt_bm_plain(x, plan, forward))


_CGGI = dict(alpha=16.0, f=8, log_d=2, k=1, beta=16.0)
# (parameters, primes, gates, first step, last step)
STEP_CASES = {
    "cggi_gadget_27_bits": (CggiParams(n=4, big_n=64, l_gsw=3, log_b_gsw=9, **_CGGI), 2, 3, 0, 4),
    "one_step": (CggiParams(n=4, big_n=64, l_gsw=3, log_b_gsw=8, **_CGGI), 2, 2, 2, 3),
    "later_range": (CggiParams(n=5, big_n=64, l_gsw=2, log_b_gsw=10, **_CGGI), 2, 2, 1, 5),
    "gadget_32_bits": (CggiParams(n=3, big_n=64, l_gsw=4, log_b_gsw=8, **_CGGI), 2, 2, 0, 3),
    "gadget_2x16": (CggiParams(n=2, big_n=64, l_gsw=2, log_b_gsw=16, **_CGGI), 3, 2, 0, 2),
    "one_digit": (CggiParams(n=3, big_n=64, l_gsw=1, log_b_gsw=7, **_CGGI), 2, 2, 0, 3),
    "l6_n128_3primes": (CggiParams(n=2, big_n=128, l_gsw=6, log_b_gsw=5, **_CGGI), 3, 2, 0, 2),
    "n256_4primes": (CggiParams(n=2, big_n=256, l_gsw=3, log_b_gsw=9, **_CGGI), 4, 1, 0, 2),
}


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_cggi_step_kernel_source_matches_plain(step_lib, name):
    """The 32-bit decomposition (rounding carry live below 32 gadget bits),
    the u32 Garner and the step range, from accumulators with extreme bits."""
    params, npr, g, i0, i1 = STEP_CASES[name]
    ctx = make_ring_ctx(params.big_n, 32, npr)
    n, l = ctx.n, params.l_gsw
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
    step_lib.host_cggi_step(
        got.data_ptr(), ta.data_ptr(), brk.data_ptr(), mono.data_ptr(),
        tw_f.data_ptr(), tw_f_sh.data_ptr(), tw_i.data_ptr(), tw_i_sh.data_ptr(),
        consts.data_ptr(), ctx.crt.prod_mod32, g, params.n, i0, i1, npr, l,
        params.log_b_gsw, n.bit_length() - 1,
    )
    assert torch.equal(got, want), f"{int((got != want).sum())} of {want.numel()} differ"


@pytest.fixture(scope="module")
def rate_lib(tmp_path_factory):
    from mktfhe_tpu_torch.tools import butterfly_rate

    lib = _host_library(butterfly_rate.SOURCE, RATE_ENTRY, tmp_path_factory.mktemp("rate_host"))
    lib.host_butterfly_rate.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_uint] * 2 + [ctypes.c_int] * 4
    lib.host_butterfly_rate.restype = None
    return lib


@pytest.mark.parametrize("forward", [True, False], ids=["ct_lazy", "gs_lazy"])
def test_butterfly_rate_kernel_source_matches_big_integers(rate_lib, forward):
    """The measuring kernel's loop of lazy radix-8 butterflies stays inside
    their ranges: after several rounds the canonical residues are those of the
    same butterflies on Python integers mod p."""
    rounds, threads, seed = 5, 4, 7
    p = PRIMES[0]
    tw, tw_sh, _ = kntt._kernel_tables(64, 2, forward, CPU)
    out = torch.empty((threads, 8), dtype=torch.int32)
    rate_lib.host_butterfly_rate(out.data_ptr(), tw.data_ptr(), tw_sh.data_ptr(), p, seed, rounds,
                                 int(forward), 1, threads)
    w = [int(v) & 0xFFFFFFFF for v in tw[0]]
    for gid in range(threads):
        e = [((seed + gid * 2654435761 % (1 << 32) + j * 40503) % (1 << 32)) % p for j in range(8)]
        for _ in range(rounds):
            for k in ((2, 1, 0) if forward else (0, 1, 2)):  # half-width 2^k, 2^(2-k) twiddles from entry 2^(2-k)
                for j in range(8):
                    if j & (1 << k):
                        continue
                    u, v, tww = e[j], e[j | (1 << k)], w[(1 << (2 - k)) + (j >> (k + 1))]
                    if forward:
                        e[j], e[j | (1 << k)] = (u + tww * v) % p, (u - tww * v) % p
                    else:
                        e[j], e[j | (1 << k)] = (u + v) % p, tww * (u - v) % p
        assert [int(v) & 0xFFFFFFFF for v in out[gid]] == e
