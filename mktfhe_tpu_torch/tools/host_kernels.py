"""The CUDA kernels' own device code, compiled for the CPU.

There is no CUDA compiler or card where the CPU tests run, so the kernels of
mktfhe_tpu_torch/csrc/ are otherwise only checked on the card
(tests/test_torch_cuda.py, chip_smoke.py).  `library(source, workdir)`
compiles the device code of a source -- everything above its `extern "C"`
entry points -- with g++ against a small stand-in for the CUDA runtime
header: one std::thread per CUDA thread, a std::barrier for
`__syncthreads()`, CTAs one after the other (the CTAs of a thread-block
cluster at once, with a barrier of their own and each other's shared memory
in reach), cp.async as a plain copy.  Its
C entry points (`ENTRIES`) launch the kernel that the source's own
dispatcher picks, or another instance where a test asks for one, and the
source's describe calls are the library's own, word for word.  That
exercises the kernels' arithmetic, indexing and barrier placement at small
sizes, bit for bit against the plain PyTorch versions
(tests/test_torch_host_*.py).  It says nothing about what nvcc accepts or
about speed.

Usage (from a test):
  lib = host_kernels.library("cggi_step", tmp_path)  # raises Unavailable without g++ / C++20
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

from ..kernels import _build

SHIM = r"""
#pragma once
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>
#define MKTFHE_HOST_BUILD 1
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
struct Dim3 { int x = 0; };
struct alignas(16) uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) { return {x, y, z, w}; }
template <typename T> inline T __ldg(const T* p) { return *p; }
inline thread_local Dim3 threadIdx, blockIdx, blockDim, gridDim;
constexpr int kMaxCluster = 8;
constexpr size_t kSmemBytes = 1 << 20;  // a CTA's dynamic shared memory
alignas(16) inline unsigned char g_smem_of[kMaxCluster][kSmemBytes];  // a cluster's CTAs'
inline thread_local unsigned char* g_smem = g_smem_of[0];  // this thread's CTA's
inline thread_local std::barrier<>* g_barrier = nullptr;  // this thread's CTA's
inline thread_local std::barrier<>* g_cluster_barrier = nullptr;
inline thread_local int g_cluster_rank = 0;
inline void __syncthreads() { g_barrier->arrive_and_wait(); }
inline void cluster_sync() { g_cluster_barrier->arrive_and_wait(); }
inline int cluster_rank() { return g_cluster_rank; }
template <typename T>
inline T ld_shared_cluster(const T* p, int rank) {
    return *reinterpret_cast<const T*>(g_smem_of[rank] + (reinterpret_cast<const unsigned char*>(p) - g_smem));
}
inline uint32_t __umulhi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
inline uint64_t __umul64hi(uint64_t a, uint64_t b) {
    return (uint64_t)(((unsigned __int128)a * b) >> 64);
}
inline uint32_t min(uint32_t a, uint32_t b) { return a < b ? a : b; }
inline int min(int a, int b) { return a < b ? a : b; }
inline uint32_t __brev(uint32_t v) {
    uint32_t r = 0;
    for (int i = 0; i < 32; ++i) r |= ((v >> i) & 1u) << (31 - i);
    return r;
}
// one cluster of `cluster` CTAs after the other, `threads` host threads each
template <typename F>
void run_grid(long long ctas, int threads, F body, int cluster = 1) {
    for (long long c0 = 0; c0 < ctas; c0 += cluster) {
        std::barrier<> cluster_bar(cluster * threads);
        std::vector<std::unique_ptr<std::barrier<>>> bars;
        for (int r = 0; r < cluster; ++r) bars.push_back(std::make_unique<std::barrier<>>(threads));
        std::vector<std::thread> pool;
        for (int r = 0; r < cluster; ++r) {
            for (int t = 0; t < threads; ++t) pool.emplace_back([=, &cluster_bar, &bars]() {
                threadIdx.x = t; blockIdx.x = (int)(c0 + r); blockDim.x = threads; gridDim.x = (int)ctas;
                g_smem = g_smem_of[r]; g_barrier = bars[r].get(); g_cluster_barrier = &cluster_bar;
                g_cluster_rank = r;
                body();
            });
        }
        for (auto& th : pool) th.join();
    }
}
"""

# each kernel's dynamic shared memory becomes a pointer to the stand-in's buffer
DYNAMIC_SHARED = {
    "extern __shared__ __align__(16) unsigned char smem[];": "unsigned char* smem = g_smem;",
    "extern __shared__ __align__(16) uint32_t a[];": "uint32_t* a = (uint32_t*)g_smem;",
}

_P, _I, _LL, _U, _ULL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint, ctypes.c_ulonglong

# source stem -> (C entry points appended to its device code, {function:
# (argtypes, restype)})
ENTRIES = {
    # the kernel that the source's dispatcher picks for the shape, or, with
    # `run_time_shapes` set, the kernel with run-time shapes whatever the shape
    "phase1_sweep": (r"""
extern "C" int host_phase1_sweep(void* acc, const void* tildea, const void* brk, const void* mono,
        const void* tw_f, const void* tw_f_sh, const void* tw_i, const void* tw_i_sh,
        const void* consts, unsigned long long prod_mod64, long long ctas, int gates, int parties,
        int first_rows, int rows, int n_steps, int ell, int npr, int l, int log_b, int log_n,
        int run_time_shapes) {
    const SweepShape shape{gates, parties, first_rows, rows, n_steps, ell, npr, l, log_b, log_n};
    const SweepPlan plan = sweep_plan(mono != nullptr, shape);
    const SweepKernel kernel = !run_time_shapes ? plan.kernel
        : mono != nullptr ? &phase1_sweep_kernel<true, 0, 0, 0, 0> : &phase1_sweep_kernel<false, 0, 0, 0, 1>;
    if (plan.shared_bytes > (int)kSmemBytes) return 2;
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
""", {"host_phase1_sweep": ([_P] * 9 + [_ULL, _LL] + [_I] * 11, _I),
      "mktfhe_phase1_sweep_describe": ([_I] * 5 + [_P], None)}),
    # `pow_shared` < 0: the kernel that the source's dispatcher picks for the
    # shape; 0 / 1: the kernel with run-time shapes with the power table in
    # device / shared memory, and the twiddles where the table is
    "mx_sweep": (r"""
extern "C" int host_mx_sweep(void* acc, const void* tildea, const void* brk, const void* pow,
        const void* tw_f, const void* tw_f_sh, const void* tw_i, const void* tw_i_sh,
        const void* consts, unsigned long long prod_mod64, long long ctas, int rows, int n_steps,
        int npr, int l, int log_b, int log_n, int pow_shared) {
    const MxPlan plan = mx_plan(log_n, npr, l);
    const MxKernel kernel = pow_shared < 0 ? plan.kernel
        : pow_shared ? &mx_sweep_kernel<true, 0, 0, 0> : &mx_sweep_kernel<false, 0, 0, 0>;
    const MxShape shape{rows, n_steps, npr, l, log_b, log_n,
                        pow_shared < 0 ? plan.tw_shared : pow_shared != 0};
    if (2 * plan.shared_bytes > kSmemBytes) return 2;  // room for a table forced into shared memory
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
""", {"host_mx_sweep": ([_P] * 9 + [_ULL, _LL] + [_I] * 7, _I),
      "mktfhe_mx_sweep_describe": ([_I] * 3 + [_P], None)}),
    # the natural and the batch-minor kernel that the source's dispatchers
    # pick, on a grid of `ctas` CTAs / `clusters` clusters (fewer than the
    # tiles: they go round the tiles, both buffers in use)
    "ntt": (r"""
extern "C" int host_ntt_nat(const void* x, void* y, const void* tw, const void* tw_sh,
        const void* consts, long long polys, int npr, int log_n, int forward, int ctas) {
    const NatPlan plan = nat_plan(log_n, forward != 0);
    if (plan.kernel == nullptr || plan.shared_bytes > (int)kSmemBytes) return 2;
    run_grid(ctas, plan.threads, [=]() {
        plan.kernel((const uint32_t*)x, (uint32_t*)y, (const uint32_t*)tw, (const uint32_t*)tw_sh,
                    (const uint32_t*)consts, (int)(polys / npr), npr);
    });
    return 0;
}
extern "C" void mktfhe_ntt_nat_describe(int log_n, int forward, int* out) {
    describe_nat(log_n, forward, out);
}
extern "C" int host_ntt_bm(const void* x, void* y, const void* tw, const void* tw_sh,
        const void* consts, int npr, int rows, int gates, int log_n, int forward, int clusters) {
    const BmPlan plan = bm_plan(log_n, (long long)npr * rows, gates, forward != 0);
    if (plan.kernel == nullptr || plan.shared_bytes > (int)kSmemBytes || plan.cluster > kMaxCluster) return 2;
    run_grid((long long)clusters * plan.cluster, plan.threads, [=]() {
        plan.kernel((const uint32_t*)x, (uint32_t*)y, (const uint32_t*)tw, (const uint32_t*)tw_sh,
                    (const uint32_t*)consts, npr, rows, gates);
    }, plan.cluster);
    return 0;
}
extern "C" void mktfhe_ntt_bm_describe(int log_n, int npr, int rows, int gates, int forward, int* out) {
    describe_bm(log_n, npr, rows, gates, forward, out);
}
""", {"host_ntt_nat": ([_P] * 5 + [_LL] + [_I] * 4, _I),
      "mktfhe_ntt_nat_describe": ([_I, _I, _P], None),
      "host_ntt_bm": ([_P] * 5 + [_I] * 6, _I),
      "mktfhe_ntt_bm_describe": ([_I] * 5 + [_P], None)}),
    # the kernel that the source's dispatcher picks, or, with
    # `run_time_shapes` set, the kernel with run-time shapes
    "cggi_step": (r"""
extern "C" int host_cggi_step(void* acc, const void* tildea, const void* brk, const void* mono,
        const void* tw_f, const void* tw_f_sh, const void* tw_i, const void* tw_i_sh,
        const void* consts, unsigned int prod_mod32, long long gates, int n_total, int i0, int i1,
        int npr, int l, int log_b, int log_n, int run_time_shapes) {
    const StepPlan plan = step_plan(log_n, l, npr);
    const StepKernel kernel = run_time_shapes ? &cggi_step_kernel<0, 0, 0, 1> : plan.kernel;
    const int threads = run_time_shapes ? (1 << log_n) / 4 : plan.threads;
    const StepShape shape{n_total, i0, i1, npr, l, log_b, log_n, plan.tw_shared};
    if (plan.shared_bytes > (int)kSmemBytes) return 2;
    run_grid(gates, threads, [=]() {
        kernel((uint32_t*)acc, (const int32_t*)tildea, (const uint32_t*)brk, (const uint32_t*)mono,
               (const uint32_t*)tw_f, (const uint32_t*)tw_f_sh, (const uint32_t*)tw_i,
               (const uint32_t*)tw_i_sh, (const uint64_t*)consts, prod_mod32, shape);
    });
    return 0;
}
extern "C" void mktfhe_cggi_step_describe(int npr, int l, int log_n, int* out) {
    describe_plan(npr, l, log_n, out);
}
""", {"host_cggi_step": ([_P] * 9 + [_U, _LL] + [_I] * 8, _I),
      "mktfhe_cggi_step_describe": ([_I] * 3 + [_P], None)}),
    # the kernel that the source's dispatcher picks, or, with
    # `run_time_shapes` set, the kernel with run-time shapes
    "hybrid_product": (r"""
extern "C" int host_hybrid_product(const void* y, const void* rd, const void* pub, const void* crs,
        void* u, void* v, const void* tw_f, const void* tw_f_sh, const void* consts,
        long long gates, int p1, int npr, int l, int log_b, int log_n, int run_time_shapes) {
    const HybridPlan plan = hybrid_plan(log_n, l, npr);
    const HybridKernel kernel = run_time_shapes ? &hybrid_product_kernel<0, 0, 0> : plan.kernel;
    const HybridShape shape{p1, npr, l, log_b, log_n};
    if (plan.shared_bytes > (int)kSmemBytes) return 2;
    run_grid(gates * npr, plan.threads, [=]() {
        kernel((const uint64_t*)y, (const uint32_t*)rd, (const uint32_t*)pub, (const uint32_t*)crs,
               (uint32_t*)u, (uint32_t*)v, (const uint32_t*)tw_f, (const uint32_t*)tw_f_sh,
               (const uint64_t*)consts, shape);
    });
    return 0;
}
extern "C" void mktfhe_hybrid_product_describe(int log_n, int l, int npr, int* out) {
    describe_plan(log_n, l, npr, out);
}
""", {"host_hybrid_product": ([_P] * 9 + [_LL] + [_I] * 6, _I),
      "mktfhe_hybrid_product_describe": ([_I] * 3 + [_P], None)}),
    "butterfly_rate": (r"""
extern "C" void host_butterfly_rate(void* out, const void* tw, const void* tw_sh, unsigned int p,
        unsigned int seed, int rounds, int forward, int ctas, int threads) {
    auto kernel = forward ? &butterfly_rate_kernel<true> : &butterfly_rate_kernel<false>;
    run_grid(ctas, threads, [=]() {
        kernel((uint32_t*)out, (const uint32_t*)tw, (const uint32_t*)tw_sh, p, seed, rounds);
    });
}
""", {"host_butterfly_rate": ([_P] * 3 + [_U] * 2 + [_I] * 4, None)}),
}


class Unavailable(RuntimeError):
    """No g++ with C++20 (std::barrier) to compile the device code with."""


def library(stem: str, workdir: Path) -> ctypes.CDLL:
    """The device code of csrc/<stem>.cu plus its entry points of `ENTRIES`,
    compiled for the host in `workdir`, loaded, its functions declared."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise Unavailable("needs g++ to compile the kernel source for the host")
    entry, functions = ENTRIES[stem]
    source = _build.CSRC / f"{stem}.cu"
    text = source.read_text()
    device_code = text[: text.index('extern "C"')]
    for dynamic, pointer in DYNAMIC_SHARED.items():
        device_code = device_code.replace(dynamic, pointer)
    if "extern __shared__" in device_code:
        raise ValueError(f"{source.name} declares dynamic shared memory the stand-in does not know")
    workdir = Path(workdir)
    (workdir / "cuda_runtime.h").write_text(SHIM)
    for header in _build.CSRC.glob("*.cuh"):
        (workdir / header.name).write_text(header.read_text())
    cpp = workdir / f"{stem}_host.cpp"
    cpp.write_text(device_code + entry)
    lib_path = workdir / f"lib{stem}_host.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-I", str(workdir), "-shared", "-fPIC", "-pthread",
         "-o", str(lib_path), str(cpp)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0 and "c++20" in proc.stderr:
        raise Unavailable("needs a g++ with C++20 (std::barrier)")
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {source.name}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for name, (argtypes, restype) in functions.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
