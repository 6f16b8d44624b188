// KMS phase 2's hybrid product of one merge, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes this product in XLA
// (mktfhe_tpu/schemes/kms.py:_phase2_party_mat, its digits through the
// natural NTT kernel), and so did the port (schemes/kms.py:_hybrid_product,
// its digits through csrc/ntt.cu).  Plain PyTorch version of the same
// function: schemes/kms.py:_hybrid_product; the output is bit-identical to
// it (the arithmetic is exact).
//
// What it computes.  Merge p1 of phase 2 holds y [G, p1, N] on the 2^64
// torus, one polynomial a component.  Each component c is gadget-decomposed
// into l balanced digit polynomials D_c,j, lifted and transformed, and
//   u[g, c] = sum_j rd[j] D_c,j                          (party p1's rlk d)
//   v[g]    = -sum_j crs[j] D_0,j + sum_{c >= 1} sum_j pub[c - 1, j] D_c,j
// per CRT prime, in the evaluation domain.
//
// What bounded it before.  In PyTorch the digits went to device memory
// (int32 [G, p1, l, npr, N]: 50 MB a component at G = 128, l = 16), were
// transformed there, widened to int64 and multiplied into int64 product
// tensors that were summed and reduced with int64 remainders: several trips
// through device memory per residue, in chunks of parties that bounded the
// transients (about 2.5 GB).  The work is small: a component's l transforms
// and 2l products a residue.
//
// Design.  One CTA per (gate, prime), 512 threads; the loop over the merge's
// components runs inside the CTA, so the digits never leave shared memory
// and v's sum over the components stays resident:
//  - the first forward pass decomposes the component on the fly from device
//    memory (`digits_first_pass`, as the sweeps do from shared memory), the
//    rest of the transforms are modarith.cuh's register-resident passes over
//    the l digit polynomials in shared memory (l N words: 128 KB at l = 16,
//    N = 2048), with the prime's twiddles staged once for all components;
//  - one pointwise walk forms u (written at once) and adds the component's
//    key product into v's accumulator (N words of shared memory that each
//    thread reads and writes at its own positions only); a position's l
//    digits stay in registers for both products;
//  - at most l <= 16 products of canonical residues are summed in 64 bits
//    (< 2^63) and reduced by one Barrett step;
//  - the shapes (log2 N, l, primes) are template arguments for the KMS
//    presets (`hybrid_plan` picks by the shape); every other shape the
//    wrapper admits runs the same kernel with run-time shapes.
// Keys are read as the scheme stores them (the plain transform's
// bit-reversed order, no Shoup companions), as the sweeps read brk_hat.
//
// Built by mktfhe_tpu_torch/kernels/_build.py and called through ctypes
// (wrapper: kernels/hybrid_product.py); the C entry point returns the first
// CUDA error of the attribute call or the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

using namespace mktfhe;

constexpr int kMaxThreads = 512;
constexpr int kMaxDigits = 16;  // l products summed before one reduction (ring/modring.py)

struct HybridShape {
    int p1, npr, l, log_b, log_n;
};

// y:      [gates, p1, n] u64, the merge's components on the 2^64 torus
// rd:     [l, npr, n] residues, party p1's rlk d-vector
// pub:    [p1 - 1, l, npr, n] residues, the earlier parties' public keys
// crs:    [l, npr, n] residues
// u:      [gates, p1, npr, n] out, canonical residues
// v:      [gates, npr, n] out, canonical residues
// tw_f:   [npr, n] bit-reversed psi table and its Shoup companion
// consts: [npr, kConstCols]
// kLogN, kL, kNpr: the shape at compile time, or 0 to take it from `s`.
template <int kLogN, int kL, int kNpr>
__global__ void __launch_bounds__(kMaxThreads)
hybrid_product_kernel(const uint64_t* __restrict__ y, const uint32_t* __restrict__ rd,
                      const uint32_t* __restrict__ pub, const uint32_t* __restrict__ crs,
                      uint32_t* __restrict__ u, uint32_t* __restrict__ v,
                      const uint32_t* __restrict__ tw_f, const uint32_t* __restrict__ tw_f_sh,
                      const uint64_t* __restrict__ consts, HybridShape s) {
    extern __shared__ __align__(16) unsigned char smem[];

    const int log_n = kLogN ? kLogN : s.log_n;
    const int l = kL ? kL : s.l;
    const int npr = kNpr ? kNpr : s.npr;
    const int n = 1 << log_n;
    const int nthreads = blockDim.x;
    const int tid = threadIdx.x;
    const DigitShape<uint64_t> gadget = digit_shape<uint64_t>(l, s.log_b);

    uint32_t* dig = reinterpret_cast<uint32_t*>(smem);  // [l, n], swizzled rows
    uint32_t* tws = dig + static_cast<size_t>(l) * n;  // [2, n]: the prime's forward twiddles
    uint32_t* vacc = tws + 2 * n;  // [n]: v's sum so far, at natural positions

    const long long cta = blockIdx.x;
    const long long gate = cta / npr;
    const int q = static_cast<int>(cta % npr);
    const uint32_t p = static_cast<uint32_t>(consts[q * kConstCols + kColP]);
    const uint64_t mu = consts[q * kConstCols + kColMu];
    const uint32_t* tw_q = tw_f + static_cast<size_t>(q) * n;
    const uint32_t* tw_q_sh = tw_f_sh + static_cast<size_t>(q) * n;
    for (int j = tid; j < n / 4; j += nthreads) {
        reinterpret_cast<uint4*>(tws)[j] = reinterpret_cast<const uint4*>(tw_q)[j];
        reinterpret_cast<uint4*>(tws + n)[j] = reinterpret_cast<const uint4*>(tw_q_sh)[j];
    }

    // one digit row of a key: [npr, n]
    const size_t row = static_cast<size_t>(npr) * n;
    const uint32_t* rd_q = rd + static_cast<size_t>(q) * n;
    for (int c = 0; c < s.p1; ++c) {
        // the component's l digit polynomials, decomposed in the first pass
        // (its barrier also covers the twiddles' staging)
        const uint64_t* yc = y + (gate * s.p1 + c) * n;
        digits_first_pass(dig, yc, 1, gadget, log_n, tid, nthreads, tw_q, tw_q_sh, p);
        __syncthreads();
        fwd_ntt_passes<kLogN>(dig, l, log_n, tid, nthreads, tws, tws + n, p);

        // u's component and v's term: the crs, negated, for component 0, the
        // public key of party c for the others
        const uint32_t* key = (c == 0 ? crs : pub + static_cast<size_t>(c - 1) * l * row) +
                              static_cast<size_t>(q) * n;
        uint32_t* uc = u + ((gate * s.p1 + c) * npr + q) * n;
        for (int i = tid; i < n; i += nthreads) {
            const int pi = swz(i);
            uint64_t su = 0, sv = 0;
            if (kL != 0) {
                uint32_t d[kMaxDigits];
#pragma unroll
                for (int j = 0; j < kMaxDigits; ++j) {
                    if (j < l) d[j] = canonical(dig[j * n + pi], p);
                }
#pragma unroll
                for (int j = 0; j < kMaxDigits; ++j) {
                    if (j < l) {
                        su += static_cast<uint64_t>(d[j]) * rd_q[j * row + i];
                        sv += static_cast<uint64_t>(d[j]) * key[j * row + i];
                    }
                }
            } else {
                for (int j = 0; j < l; ++j) {
                    const uint64_t dj = canonical(dig[j * n + pi], p);
                    su += dj * rd_q[j * row + i];
                    sv += dj * key[j * row + i];
                }
            }
            uc[i] = barrett_reduce(su, mu, p);
            const uint32_t t = barrett_reduce(sv, mu, p);
            vacc[i] = c == 0 ? csub(p - t, p) : csub(vacc[i] + t, p);
        }
        __syncthreads();  // the walk's last read of `dig` before the next component's first pass
    }

    uint32_t* vg = v + (gate * npr + q) * n;
    for (int i = tid; i < n; i += nthreads) vg[i] = vacc[i];
}

using HybridKernel = decltype(&hybrid_product_kernel<0, 0, 0>);

// Threads of a CTA: one per butterfly of a stage, at most kMaxThreads.
inline int hybrid_threads(int log_n) {
    return (1 << log_n) / 2 < kMaxThreads ? (1 << log_n) / 2 : kMaxThreads;
}

// Dynamic shared memory of one CTA: the l digit polynomials, the prime's
// forward twiddles and v's accumulator; 152 KB at l = 16, N = 2048.
inline int hybrid_shared_bytes(int log_n, int l) { return 4 * (l + 3) * (1 << log_n); }

// How a shape is served: the kernel, its template arguments (log2 N, l,
// primes; 0 where the kernel takes the value at run time) and its launch.
struct HybridPlan {
    HybridKernel kernel;
    int targs[3];
    int threads, shared_bytes;
};

template <int kLogN, int kL, int kNpr>
inline HybridPlan plan_with(int log_n, int l) {
    return {&hybrid_product_kernel<kLogN, kL, kNpr>, {kLogN, kL, kNpr}, hybrid_threads(log_n),
            hybrid_shared_bytes(log_n, l)};
}

// The one place that decides which kernel serves a shape: the instance
// compiled for it -- every KMS preset of schemes/presets.py (N = 2048, binary
// and block keys alike) has one:
//   KMS2party(block):  l_uni = 3, 4 primes
//   KMS4party(block):  l_uni = 7, 3 primes
//   KMS8party:         l_uni = 8, 3 primes
//   KMS8partyblock:    l_uni = 8, 4 primes
//   KMS16party(block): l_uni = 9, 3 primes
//   KMS32party(block): l_uni = 16, 3 primes
// -- else the kernel with run-time shapes.
inline HybridPlan hybrid_plan(int log_n, int l, int npr) {
    const auto is = [&](int log_n_, int l_, int npr_) {
        return log_n == log_n_ && l == l_ && npr == npr_;
    };
    if (is(11, 3, 4)) return plan_with<11, 3, 4>(log_n, l);
    if (is(11, 7, 3)) return plan_with<11, 7, 3>(log_n, l);
    if (is(11, 8, 3)) return plan_with<11, 8, 3>(log_n, l);
    if (is(11, 8, 4)) return plan_with<11, 8, 4>(log_n, l);
    if (is(11, 9, 3)) return plan_with<11, 9, 3>(log_n, l);
    if (is(11, 16, 3)) return plan_with<11, 16, 3>(log_n, l);
    return plan_with<0, 0, 0>(log_n, l);
}

// What `hybrid_plan` says of a shape, for the wrapper's notes: out[0..2] the
// template arguments, out[3] threads per CTA, out[4] dynamic shared bytes.
inline void describe_plan(int log_n, int l, int npr, int* out) {
    const HybridPlan plan = hybrid_plan(log_n, l, npr);
    for (int i = 0; i < 3; ++i) out[i] = plan.targs[i];
    out[3] = plan.threads;
    out[4] = plan.shared_bytes;
}

}  // namespace

extern "C" int mktfhe_hybrid_product(const void* y, const void* rd, const void* pub,
                                     const void* crs, void* u, void* v, const void* tw_f,
                                     const void* tw_f_sh, const void* consts, long long gates,
                                     int p1, int npr, int l, int log_b, int log_n, void* stream) {
    const HybridShape shape{p1, npr, l, log_b, log_n};
    const HybridPlan plan = hybrid_plan(log_n, l, npr);
    const cudaError_t attr = cudaFuncSetAttribute(
        plan.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.shared_bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid(static_cast<unsigned int>(gates * npr));
    const dim3 block(plan.threads);
    plan.kernel<<<grid, block, plan.shared_bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(y), static_cast<const uint32_t*>(rd),
        static_cast<const uint32_t*>(pub), static_cast<const uint32_t*>(crs),
        static_cast<uint32_t*>(u), static_cast<uint32_t*>(v), static_cast<const uint32_t*>(tw_f),
        static_cast<const uint32_t*>(tw_f_sh), static_cast<const uint64_t*>(consts), shape);
    return static_cast<int>(cudaGetLastError());
}

extern "C" void mktfhe_hybrid_product_describe(int log_n, int l, int npr, int* out) {
    describe_plan(log_n, l, npr, out);
}

extern "C" const char* mktfhe_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
