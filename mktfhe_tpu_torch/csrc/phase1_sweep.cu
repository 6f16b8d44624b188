// KMS phase-1 sweep: one party's whole blind rotation over an RLEV
// accumulator on the 2^64 torus, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// mktfhe_tpu/kernels/fused_mx3.py:make_mx3_sweep_kernel (reached through
// kms_phase1_mx3 / bootstrap_mx3).  Plain PyTorch version of the same
// function: mktfhe_tpu_torch/kernels/fused_mx3.py:phase1_sweep_plain; the
// output is bit-identical to it (the arithmetic is exact).
//
// What it computes.  For every gate g and RLEV row r, independently, the
// accumulator acc[g, r] (components b, a; N coefficients each, u64) goes
// through n_steps steps.  Per step: balanced gadget decomposition of both
// components into l digits each; per CRT prime the 2l signed digits are
// lifted and forward-transformed; the external product with the step's
// bootstrapping-key rows is a pointwise sum over the 2l digits per output
// component; then
//   binary keys (ell = 1): inverse NTT, balanced Garner mod 2^64 to e, and
//     acc += X^a e - e with the monomial applied on the torus as a signed
//     index remap (this stays inside the CRT range the parameters size for
//     2l terms; the TPU kernel fused (X^a - 1) in the evaluation domain and
//     needed twice the range);
//   block keys (ell > 1): the ell members' products are weighted by the
//     evaluation-domain images of X^{a_m} - 1 and summed before ONE inverse
//     NTT and Garner, acc += result.
//
// Design.  One CTA per (gate, row); the loop over steps runs inside the CTA,
// where the TPU kernel had a sequential grid dimension with the accumulator
// in VMEM scratch.  Rows and gates never interact, so there is no grid-wide
// synchronisation and one launch does a party's whole rotation.  All state
// lives in shared memory: the accumulator (16 N bytes), the 2l transformed
// digit polynomials of the current prime (8 l N bytes; primes run one after
// the other and reuse it), and the inverse-transformed residues of every
// prime waiting for Garner (8 npr N bytes): 160 KB at N = 2048, l = 4,
// 4 primes, hence the opt-in to more than 48 KB of dynamic shared memory.
// N/2 threads, one butterfly each per polynomial and stage; the 2l forward
// transforms of a prime advance together, so they share each stage's twiddle
// load and barrier (the digits, the stage loops and Garner are in modarith.cuh,
// shared with cggi_step.cu).  Keys are read as the scheme stores them (standard NTT
// domain in the plain transform's bit-reversed order, no Shoup companions):
// products of two runtime residues are summed in 64 bits (at most 2l <= 16
// terms) and reduced by one Barrett step.
//
// What bounds it.  Integer arithmetic and shared-memory round trips, not
// device memory: a step does about 0.9 M modular multiplies per CTA at
// KMS8partyblock widths, while the step's key rows (1.57 MB) are shared by
// all CTAs, which advance nearly in step, and are served from L2.  Making it
// fast is later work: register-resident radix-4 stages, twiddles in shared
// memory, compile-time shapes.
//
// Built by mktfhe_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (wrapper: kernels/fused_mx3.py); the C entry
// point returns the first CUDA error of the attribute call or the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

using namespace mktfhe;

struct SweepShape {
    int rows, n_steps, ell, npr, l, log_b, log_n;
};

// acc:    [ctas, 2, n] u64, in and out; cta = gate * rows + row
// tildea: [gates, n_steps * ell] rotation amounts in [0, 2n)
// brk:    [n_steps * ell, 2l, 2, npr, n] residues (key row = step * ell + member)
// mono:   [2n, npr, n] images of X^a - 1 (block variant only)
// tw_*:   [npr, n] bit-reversed psi / psi^-1 tables with Shoup companions
// consts: [npr, kConstCols]
template <bool kBlock>
__global__ void __launch_bounds__(1024)
phase1_sweep_kernel(uint64_t* __restrict__ acc_g, const int32_t* __restrict__ tildea,
                    const uint32_t* __restrict__ brk, const uint32_t* __restrict__ mono,
                    const uint32_t* __restrict__ tw_f, const uint32_t* __restrict__ tw_f_sh,
                    const uint32_t* __restrict__ tw_i, const uint32_t* __restrict__ tw_i_sh,
                    const uint64_t* __restrict__ consts, uint64_t prod_mod64, SweepShape s) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ uint64_t sc[kMaxPrimes * kConstCols];

    const int n = 1 << s.log_n;
    const int nthreads = blockDim.x;  // n / 2
    const int tid = threadIdx.x;
    const int npr = s.npr, l = s.l, ell = s.ell, log_b = s.log_b, log_n = s.log_n;
    const int terms = 2 * l;

    uint64_t* acc = reinterpret_cast<uint64_t*>(smem);  // [2, n]
    uint32_t* dig = reinterpret_cast<uint32_t*>(acc + 2 * n);  // [2l, n]
    const int dig_words = terms * n > 4 * n ? terms * n : 4 * n;
    uint32_t* res = dig + dig_words;  // [npr, 2, n]
    // binary variant: e on the torus, [2, n] u64, over the idle digit buffer
    uint64_t* etor = reinterpret_cast<uint64_t*>(dig);

    const long long cta = blockIdx.x;
    const long long gate = cta / s.rows;
    const int32_t* ta = tildea + gate * (static_cast<long long>(s.n_steps) * ell);
    uint64_t* acc_io = acc_g + cta * 2 * n;

    for (int i = tid; i < npr * kConstCols; i += nthreads) sc[i] = consts[i];
    for (int i = tid; i < 2 * n; i += nthreads) acc[i] = acc_io[i];
    __syncthreads();

    const size_t poly_stride = static_cast<size_t>(npr) * n;  // one (term, cout) key row
    const size_t member_stride = static_cast<size_t>(terms) * 2 * poly_stride;

    for (int step = 0; step < s.n_steps; ++step) {
        const uint32_t* brk_s = brk + static_cast<size_t>(step) * ell * member_stride;
        for (int q = 0; q < npr; ++q) {
            const uint32_t p = static_cast<uint32_t>(sc[q * kConstCols + kColP]);
            const uint64_t mu = sc[q * kConstCols + kColMu];

            // 1-2. balanced gadget digits of both components, lifted mod p,
            // and their forward NTTs together
            for (int idx = tid; idx < 2 * n; idx += nthreads) {
                const int c = idx >> log_n;
                const int i = idx & (n - 1);
                balanced_digits<uint64_t>(acc[idx], l, log_b, p,
                                          dig + static_cast<size_t>(c) * l * n + i, n);
            }
            __syncthreads();
            fwd_ntt_shared(dig, terms, tid, log_n, tw_f + static_cast<size_t>(q) * n,
                           tw_f_sh + static_cast<size_t>(q) * n, p);

            // 3-4. external product per output component; block variant:
            // weighted by the members' monomial images and summed
            uint32_t* out = res + static_cast<size_t>(q) * 2 * n;
            for (int i = tid; i < n; i += nthreads) {
                uint32_t u0 = 0, u1 = 0;
                for (int m = 0; m < ell; ++m) {
                    const uint32_t* key = brk_s + m * member_stride + static_cast<size_t>(q) * n + i;
                    uint64_t s0 = 0, s1 = 0;
                    for (int t = 0; t < terms; ++t) {
                        const uint64_t d = dig[t * n + i];
                        s0 += d * key[(2 * t) * poly_stride];
                        s1 += d * key[(2 * t + 1) * poly_stride];
                    }
                    const uint32_t e0 = barrett_reduce(s0, mu, p);
                    const uint32_t e1 = barrett_reduce(s1, mu, p);
                    if (kBlock) {
                        const uint32_t a = static_cast<uint32_t>(ta[step * ell + m]);
                        const uint64_t mon = mono[(static_cast<size_t>(a) * npr + q) * n + i];
                        u0 = barrett_reduce(u0 + e0 * mon, mu, p);
                        u1 = barrett_reduce(u1 + e1 * mon, mu, p);
                    } else {
                        u0 = e0;
                        u1 = e1;
                    }
                }
                out[i] = u0;
                out[n + i] = u1;
            }
            __syncthreads();

            // 5. inverse NTT of the two output polynomials, 1/N folded
            inv_ntt_shared(out, 2, tid, log_n, tw_i + static_cast<size_t>(q) * n,
                           tw_i_sh + static_cast<size_t>(q) * n, p);
            const uint32_t ninv = static_cast<uint32_t>(sc[q * kConstCols + kColNinv]);
            const uint32_t ninv_sh = static_cast<uint32_t>(sc[q * kConstCols + kColNinvSh]);
            for (int idx = tid; idx < 2 * n; idx += nthreads) {
                out[idx] = shoup_mul(ninv, ninv_sh, out[idx], p);
            }
        }
        __syncthreads();

        // Garner mod 2^64 and accumulate
        if (kBlock) {
            for (int idx = tid; idx < 2 * n; idx += nthreads) {
                acc[idx] += garner<uint64_t>(res + idx, 2 * n, npr, sc, prod_mod64);
            }
        } else {
            for (int idx = tid; idx < 2 * n; idx += nthreads) {
                etor[idx] = garner<uint64_t>(res + idx, 2 * n, npr, sc, prod_mod64);
            }
            __syncthreads();
            // acc += X^a e - e: coefficient j of X^a e is [e, -e][(j - a) mod 2n]
            const int a = ta[step];
            for (int idx = tid; idx < 2 * n; idx += nthreads) {
                const int c = idx >> log_n;
                const int src = ((idx & (n - 1)) - a) & (2 * n - 1);
                const uint64_t* e = etor + static_cast<size_t>(c) * n;
                const uint64_t rolled = src < n ? e[src] : 0 - e[src - n];
                acc[idx] += rolled - etor[idx];
            }
        }
        __syncthreads();
    }

    for (int i = tid; i < 2 * n; i += nthreads) acc_io[i] = acc[i];
}

}  // namespace

// `mono` is null for binary keys and selects the variant.
extern "C" int mktfhe_phase1_sweep(void* acc, const void* tildea, const void* brk,
                                   const void* mono, const void* tw_f, const void* tw_f_sh,
                                   const void* tw_i, const void* tw_i_sh, const void* consts,
                                   unsigned long long prod_mod64, long long ctas, int rows,
                                   int n_steps, int ell, int npr, int l, int log_b, int log_n,
                                   void* stream) {
    const SweepShape shape{rows, n_steps, ell, npr, l, log_b, log_n};
    const int n = 1 << log_n;
    const int dig_words = 2 * l * n > 4 * n ? 2 * l * n : 4 * n;
    const int smem = 16 * n + 4 * dig_words + 8 * npr * n;
    decltype(&phase1_sweep_kernel<true>) kernel =
        mono != nullptr ? &phase1_sweep_kernel<true> : &phase1_sweep_kernel<false>;
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid(static_cast<unsigned int>(ctas));
    const dim3 block(n / 2);
    kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t*>(acc), static_cast<const int32_t*>(tildea),
        static_cast<const uint32_t*>(brk), static_cast<const uint32_t*>(mono),
        static_cast<const uint32_t*>(tw_f), static_cast<const uint32_t*>(tw_f_sh),
        static_cast<const uint32_t*>(tw_i), static_cast<const uint32_t*>(tw_i_sh),
        static_cast<const uint64_t*>(consts), prod_mod64, shape);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mktfhe_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
