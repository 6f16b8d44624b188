// Fused CGGI blind-rotation step (one whole CMux on the 2^32 torus), and a
// range of such steps in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// mktfhe_tpu/kernels/fused_step.py:make_cggi_step_kernel (reached through
// bootstrap_fused).  Plain PyTorch version of the same function:
// mktfhe_tpu_torch/kernels/fused_step.py:cggi_step_plain; the output is
// bit-identical to it (the arithmetic is exact).
//
// What it computes.  For every gate independently, the RLWE accumulator
// acc (components b, a; N coefficients each, u32) goes through the steps
// [i0, i1).  Per step i: balanced gadget decomposition of both components
// into l digits each (rounded to l log_b bits first; the rounding carry is
// live whenever l log_b < 32); per CRT prime the 2l signed digits are lifted
// and forward-transformed; the external product with the step's
// bootstrapping-key rows brk[i] is a pointwise sum over the 2l digits per
// output component; the product is weighted by the evaluation-domain image of
// X^a - 1 for the gate's rotation amount a = tildea[gate, i] (table of 2N
// entries); inverse NTT; balanced Garner mod 2^32; acc += the result.
// A launch over [i, i + 1) is the TPU kernel's function; the TPU kernel ran
// one step per launch inside a scan.
//
// Design.  One CTA per gate with the accumulator as [gate, 2, N] (each
// component a contiguous polynomial), so the TPU kernel's batch-minor
// transposes have no counterpart.  The loop over steps runs inside the CTA
// with the accumulator resident in shared memory; gates never interact, so
// there is no grid-wide synchronisation.  Shared memory: the accumulator
// (8 N bytes), the 2l transformed digit polynomials of the current prime
// (8 l N bytes; primes run one after the other and reuse it) and the
// inverse-transformed residues of every prime waiting for Garner
// (8 npr N bytes): 48 KB at N = 1024, l = 3, 2 primes, so several CTAs share
// an SM and 256 gates run as one wave on 132 SMs.  N/2 threads, one butterfly
// each per polynomial and stage.  Keys are read as the scheme stores them
// (bit-reversed NTT order, no Shoup companions): products of two runtime
// residues are summed in 64 bits (2l <= 16 terms) and reduced by one Barrett
// step.  Digits, stage loops and Garner are in modarith.cuh, shared with
// phase1_sweep.cu.
//
// What bounds it.  Integer arithmetic and shared-memory round trips, not
// device memory: a step's key rows (96 KB at the CGGI preset) are shared by
// all CTAs and served from L2, as is the monomial table.  Making it fast is
// later work: the accumulator in registers, register-resident radix-4 stages,
// twiddles in shared memory, compile-time shapes.
//
// Built by mktfhe_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (wrapper: kernels/fused_step.py); the C entry
// point returns the first CUDA error of the attribute call or the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

using namespace mktfhe;

struct StepShape {
    int n_total, i0, i1, npr, l, log_b, log_n;
};

// acc:    [gates, 2, n] u32, in and out
// tildea: [gates, n_total] rotation amounts in [0, 2n)
// brk:    [n_total, npr, 2l, 2, n] residues
// mono:   [2n, npr, n] images of X^a - 1
// tw_*:   [npr, n] bit-reversed psi / psi^-1 tables with Shoup companions
// consts: [npr, kConstCols]
__global__ void __launch_bounds__(1024)
cggi_step_kernel(uint32_t* __restrict__ acc_g, const int32_t* __restrict__ tildea,
                 const uint32_t* __restrict__ brk, const uint32_t* __restrict__ mono,
                 const uint32_t* __restrict__ tw_f, const uint32_t* __restrict__ tw_f_sh,
                 const uint32_t* __restrict__ tw_i, const uint32_t* __restrict__ tw_i_sh,
                 const uint64_t* __restrict__ consts, uint32_t prod_mod32, StepShape s) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ uint64_t sc[kMaxPrimes * kConstCols];

    const int n = 1 << s.log_n;
    const int nthreads = blockDim.x;  // n / 2
    const int tid = threadIdx.x;
    const int npr = s.npr, l = s.l, log_b = s.log_b, log_n = s.log_n;
    const int terms = 2 * l;

    uint32_t* acc = reinterpret_cast<uint32_t*>(smem);  // [2, n]
    uint32_t* dig = acc + 2 * n;  // [2l, n]
    uint32_t* res = dig + terms * n;  // [npr, 2, n]

    const long long gate = blockIdx.x;
    const int32_t* ta = tildea + gate * s.n_total;
    uint32_t* acc_io = acc_g + gate * 2 * n;

    for (int i = tid; i < npr * kConstCols; i += nthreads) sc[i] = consts[i];
    for (int i = tid; i < 2 * n; i += nthreads) acc[i] = acc_io[i];
    __syncthreads();

    const size_t step_stride = static_cast<size_t>(npr) * terms * 2 * n;

    for (int step = s.i0; step < s.i1; ++step) {
        const uint32_t a = static_cast<uint32_t>(ta[step]);
        for (int q = 0; q < npr; ++q) {
            const uint32_t p = static_cast<uint32_t>(sc[q * kConstCols + kColP]);
            const uint64_t mu = sc[q * kConstCols + kColMu];

            // balanced gadget digits of both components, lifted mod p, and
            // their forward NTTs together
            for (int idx = tid; idx < 2 * n; idx += nthreads) {
                const int c = idx >> log_n;
                const int i = idx & (n - 1);
                balanced_digits<uint32_t>(acc[idx], l, log_b, p,
                                          dig + static_cast<size_t>(c) * l * n + i, n);
            }
            __syncthreads();
            fwd_ntt_shared(dig, terms, tid, log_n, tw_f + static_cast<size_t>(q) * n,
                           tw_f_sh + static_cast<size_t>(q) * n, p);

            // external product per output component, weighted by the image
            // of X^a - 1
            const uint32_t* key = brk + step * step_stride + static_cast<size_t>(q) * terms * 2 * n;
            const uint32_t* mon = mono + (static_cast<size_t>(a) * npr + q) * n;
            uint32_t* out = res + static_cast<size_t>(q) * 2 * n;
            for (int i = tid; i < n; i += nthreads) {
                uint64_t s0 = 0, s1 = 0;
                for (int t = 0; t < terms; ++t) {
                    const uint64_t d = dig[t * n + i];
                    s0 += d * key[(2 * t) * n + i];
                    s1 += d * key[(2 * t + 1) * n + i];
                }
                const uint64_t m = mon[i];
                out[i] = barrett_reduce(barrett_reduce(s0, mu, p) * m, mu, p);
                out[n + i] = barrett_reduce(barrett_reduce(s1, mu, p) * m, mu, p);
            }
            __syncthreads();

            // inverse NTT of the two output polynomials, 1/N folded
            inv_ntt_shared(out, 2, tid, log_n, tw_i + static_cast<size_t>(q) * n,
                           tw_i_sh + static_cast<size_t>(q) * n, p);
            const uint32_t ninv = static_cast<uint32_t>(sc[q * kConstCols + kColNinv]);
            const uint32_t ninv_sh = static_cast<uint32_t>(sc[q * kConstCols + kColNinvSh]);
            for (int idx = tid; idx < 2 * n; idx += nthreads) {
                out[idx] = shoup_mul(ninv, ninv_sh, out[idx], p);
            }
        }
        __syncthreads();

        // Garner mod 2^32 and accumulate
        for (int idx = tid; idx < 2 * n; idx += nthreads) {
            acc[idx] += garner<uint32_t>(res + idx, 2 * n, npr, sc, prod_mod32);
        }
        __syncthreads();
    }

    for (int i = tid; i < 2 * n; i += nthreads) acc_io[i] = acc[i];
}

}  // namespace

extern "C" int mktfhe_cggi_step(void* acc, const void* tildea, const void* brk, const void* mono,
                                const void* tw_f, const void* tw_f_sh, const void* tw_i,
                                const void* tw_i_sh, const void* consts, unsigned int prod_mod32,
                                long long gates, int n_total, int i0, int i1, int npr, int l,
                                int log_b, int log_n, void* stream) {
    const StepShape shape{n_total, i0, i1, npr, l, log_b, log_n};
    const int n = 1 << log_n;
    const int smem = 4 * n * (2 + 2 * l + 2 * npr);
    const cudaError_t attr = cudaFuncSetAttribute(
        cggi_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid(static_cast<unsigned int>(gates));
    const dim3 block(n / 2);
    cggi_step_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint32_t*>(acc), static_cast<const int32_t*>(tildea),
        static_cast<const uint32_t*>(brk), static_cast<const uint32_t*>(mono),
        static_cast<const uint32_t*>(tw_f), static_cast<const uint32_t*>(tw_f_sh),
        static_cast<const uint32_t*>(tw_i), static_cast<const uint32_t*>(tw_i_sh),
        static_cast<const uint64_t*>(consts), prod_mod32, shape);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mktfhe_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
