// KMS phase-1 sweep on mx-domain keys: one party's whole blind rotation over
// an RLEV accumulator on the 2^64 torus, binary keys, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// mktfhe_tpu/kernels/fused_mx2.py:make_mx_sweep_kernel (reached through
// kms_phase1_mx2 / bootstrap_mx2).  Plain PyTorch version of the same
// function: mktfhe_tpu_torch/kernels/fused_mx2.py:mx_sweep_plain; the output
// is bit-identical to it (the arithmetic is exact).
//
// What it computes.  For every gate g and RLEV row r, independently, the
// accumulator acc[g, r] (components b, a; N coefficients each, u64) goes
// through n_steps steps.  Per step and CRT prime: balanced gadget
// decomposition of both components into l digits each, lifted and
// forward-transformed; the external product with the step's key rows, a
// pointwise sum over the 2l digits per output component; the product with
// the evaluation-domain image of X^a - 1; the inverse transform.  Then
// balanced Garner mod 2^64 over the primes and acc += the result.
//
// What sets it apart from phase1_sweep.cu.
//  - The keys are read as fused_mx2.build_mx_kms_keys stores them:
//    [n_steps, npr, 2l, 2, N] per party, prime-major, in the mx evaluation
//    order, where position k2' * 128 + k1 (N = 128 nb) holds the evaluation at
//    psi^(2 (k1 + 128 bitrev(k2')) + 1).  The digit transforms stay in the
//    plain transform's bit-reversed order inside the CTA, where position t
//    holds the evaluation at psi^(2 bitrev(t) + 1): mx position
//    k2' * 128 + k1 is position bitrev7(k1) * nb + k2' there
//    (kernels/mx_ntt.py:mx_eval_index).  The pointwise stage walks the mx
//    positions, reads the key rows along them and the digits through that
//    index.
//  - The monomial is formed here, in the evaluation domain, from the 2N
//    powers of psi per prime: the image of X^a - 1 at the point psi^o is
//    psi^(a o mod 2N) - 1, with o = 2 bitrev(t) + 1 the odd exponent of the
//    position.  The table is 8 npr N bytes (48 KB at N = 2048, 3 primes) and
//    lies in shared memory whenever the CTA's other state leaves room for it,
//    in device memory otherwise (l_gsw = 6 with 4 primes at N = 2048).  The
//    TPU kernel split the same power into two factor rows A[a, k1] B[a, k2']
//    gathered per step outside the kernel; one table indexed by a o needs no
//    gather and no second multiply.  The factor is a runtime value without a
//    Shoup companion, so the product takes the 64-bit Barrett step that the
//    external product already uses.  It doubles the CRT range against the
//    torus roll of phase1_sweep.cu's binary variant: npr is the KEY's prime
//    count (fused_mx2.mx_nprimes), not the scheme's.
//
// What bounds it on this card: as phase1_sweep.cu.  Integer operations set
// the floor; above it one CTA fills an SM's shared memory (224 KB at
// KMS8party: N = 2048, l = 4, 3 primes, with the power table and the
// twiddles), so whatever makes its warps wait idles the SM: the step's key
// rows (393 KB at KMS8party), which all CTAs read from L2 at about the same
// time (9% of the sweep, measured on an H100 with a build that read them from
// one L1-resident window instead), and the barriers between the passes (9%).
//
// Design.  One CTA per (gate, row), the loop over steps inside it, one launch
// per party.  Shared memory: the accumulator (16 N bytes), the 2l
// transformed digit polynomials of the current prime (8 l N), the
// inverse-transformed residues of every prime waiting for Garner (8 npr N),
// the power table (8 npr N) and the current prime's twiddles (16 N), the last
// two where they fit.  The transforms are phase1_sweep.cu's (modarith.cuh):
// register-resident radix-8 passes with lazy butterflies, the accumulator
// decomposed in the first pass, 1/N on the inverse's last pass, swizzled
// polynomial rows, 512 threads, compile-time shapes for the KMS presets and
// run-time shapes for the rest.
//
// The pointwise stage is a transposition: key rows want consecutive mx
// positions (k1 minor), the digits in shared memory sit nb words apart along
// k1.  A warp walks 32 consecutive mx positions, so each key load is one whole
// 128-byte line.  Its digit reads then differ in bits 6-10 of the position
// (the reversed low bits of k1) at N = 2048; the swizzle folds bits 8-10 into
// the bank bits, which leaves them colliding 4 ways where the plain layout
// made them collide 16 ways.  Timed on the card: taking 8 consecutive k1 for
// each of 4 values of k2' instead (conflict-free digit reads, four 32-byte
// key sectors per load) was 9% slower, 16 by 2 the same as this walk.
//
// Built by mktfhe_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (wrapper: kernels/fused_mx2.py:mx_sweep); the C
// entry point returns the first CUDA error of the attribute call or the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

using namespace mktfhe;

constexpr int kLogNk = 7;  // log2 of the 128 positions along k1
constexpr int kMaxThreads = 512;  // threads of a CTA at N >= 1024
constexpr int kMaxTerms = 12;  // 2 l_gsw digit polynomials, l_gsw <= 6

struct MxShape {
    int rows, n_steps, npr, l, log_b, log_n;
    int tw_shared;  // the current prime's twiddles are staged in shared memory
};

// Reverse the low `bits` bits of v (0 for bits = 0).
__device__ __forceinline__ uint32_t bitrev(uint32_t v, int bits) {
    return bits == 0 ? 0u : __brev(v) >> (32 - bits);
}

// acc:    [ctas, 2, n] u64, in and out; cta = gate * rows + row
// tildea: [gates, n_steps] rotation amounts in [0, 2n)
// brk:    [n_steps, npr, 2l, 2, n] residues in the mx evaluation order
// pow_g:  [npr, 2n] powers psi^e mod p of each prime's 2n-th root
// tw_*:   [npr, n] bit-reversed psi / psi^-1 tables with Shoup companions
// consts: [npr, kConstCols]
// kLogN, kL, kNpr: the shape at compile time, or 0 to take it from `s`.
template <bool kPowShared, int kLogN, int kL, int kNpr>
__global__ void __launch_bounds__(kMaxThreads)
mx_sweep_kernel(uint64_t* __restrict__ acc_g, const int32_t* __restrict__ tildea,
                const uint32_t* __restrict__ brk, const uint32_t* __restrict__ pow_g,
                const uint32_t* __restrict__ tw_f, const uint32_t* __restrict__ tw_f_sh,
                const uint32_t* __restrict__ tw_i, const uint32_t* __restrict__ tw_i_sh,
                const uint64_t* __restrict__ consts, uint64_t prod_mod64, MxShape s) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ uint64_t sc[kMaxPrimes * kConstCols];

    const int log_n = kLogN ? kLogN : s.log_n;
    const int l = kL ? kL : s.l;
    const int npr = kNpr ? kNpr : s.npr;
    const int n = 1 << log_n;
    const int nthreads = blockDim.x;
    const int tid = threadIdx.x;
    const int terms = 2 * l;
    const int log_nb = log_n - kLogNk;
    const DigitShape<uint64_t> gadget = digit_shape<uint64_t>(l, s.log_b);

    uint64_t* acc = reinterpret_cast<uint64_t*>(smem);  // [2, n]
    uint32_t* dig = reinterpret_cast<uint32_t*>(acc + 2 * n);  // [2l, n], swizzled rows
    uint32_t* res = dig + static_cast<size_t>(terms) * n;  // [npr, 2, n], swizzled rows
    uint32_t* pow_s = res + static_cast<size_t>(npr) * 2 * n;  // [npr, 2n] if kPowShared
    // [4, n] if s.tw_shared: the prime's twiddles
    uint32_t* tws = pow_s + (kPowShared ? static_cast<size_t>(npr) * 2 * n : 0);

    const long long cta = blockIdx.x;
    const long long gate = cta / s.rows;
    const int32_t* ta = tildea + gate * s.n_steps;
    uint64_t* acc_io = acc_g + cta * 2 * n;

    for (int i = tid; i < npr * kConstCols; i += nthreads) sc[i] = consts[i];
    for (int i = tid; i < 2 * n; i += nthreads) acc[i] = acc_io[i];
    if (kPowShared) {
        for (int i = tid; i < npr * 2 * n; i += nthreads) pow_s[i] = pow_g[i];
    }
    const uint32_t* pw = kPowShared ? pow_s : pow_g;
    __syncthreads();

    const size_t prime_stride = static_cast<size_t>(terms) * 2 * n;  // one prime's key rows
    const size_t step_stride = static_cast<size_t>(npr) * prime_stride;

    for (int step = 0; step < s.n_steps; ++step) {
        const uint32_t a = static_cast<uint32_t>(ta[step]);
        for (int q = 0; q < npr; ++q) {
            const uint32_t p = static_cast<uint32_t>(sc[q * kConstCols + kColP]);
            const uint64_t mu = sc[q * kConstCols + kColMu];

            // forward NTTs of the 2l lifted digit polynomials (polynomial
            // comp * l + j: digit j of component comp), decomposed in the
            // first pass
            const uint32_t* tw_q = tw_f + static_cast<size_t>(q) * n;
            const uint32_t* tw_q_sh = tw_f_sh + static_cast<size_t>(q) * n;
            const uint32_t* ti_q = tw_i + static_cast<size_t>(q) * n;
            const uint32_t* ti_q_sh = tw_i_sh + static_cast<size_t>(q) * n;
            if (s.tw_shared) stage_twiddles(tws, tw_q, tw_q_sh, ti_q, ti_q_sh, n, tid, nthreads);
            digits_first_pass(dig, acc, 2, gadget, log_n, tid, nthreads, tw_q, tw_q_sh, p);
            __syncthreads();
            fwd_ntt_passes<kLogN>(dig, terms, log_n, tid, nthreads, s.tw_shared ? tws : tw_q,
                                  s.tw_shared ? tws + n : tw_q_sh, p);

            // external product along the mx positions, times psi^(a o) - 1
            const uint32_t* key_q = brk + step * step_stride + q * prime_stride;
            const uint32_t* pw_q = pw + static_cast<size_t>(q) * 2 * n;
            uint32_t* out = res + static_cast<size_t>(q) * 2 * n;
            for (int w = tid; w < n; w += nthreads) {
                const int k1 = w & ((1 << kLogNk) - 1), k2 = w >> kLogNk;  // mx position w
                const int t = static_cast<int>(bitrev(k1, kLogNk) << log_nb) | k2;
                const int pt = swz(t);
                const uint32_t* key = key_q + w;
                uint64_t s0 = 0, s1 = 0;
                // compile-time digit count: all 4l key loads in flight together;
                // run-time: the terms stay a loop (unrolled to the most terms,
                // its predicated loads spilled registers)
                if (kL != 0) {
#pragma unroll
                    for (int j = 0; j < kMaxTerms; ++j) {
                        if (j < terms) {
                            const uint64_t d = canonical(dig[j * n + pt], p);
                            s0 += d * key[(2 * j) * n];
                            s1 += d * key[(2 * j + 1) * n];
                        }
                    }
                } else {
#pragma unroll 2
                    for (int j = 0; j < terms; ++j) {
                        const uint64_t d = canonical(dig[j * n + pt], p);
                        s0 += d * key[(2 * j) * n];
                        s1 += d * key[(2 * j + 1) * n];
                    }
                }
                const uint32_t o = 2 * bitrev(t, log_n) + 1;
                const uint64_t mon = sub_mod(pw_q[(a * o) & (2 * n - 1)], 1u, p);
                out[pt] = barrett_reduce(barrett_reduce(s0, mu, p) * mon, mu, p);
                out[n + pt] = barrett_reduce(barrett_reduce(s1, mu, p) * mon, mu, p);
            }
            __syncthreads();

            // inverse NTT of the two output polynomials, scaled by 1/N
            inv_ntt_passes<kLogN>(out, 2, log_n, tid, nthreads, s.tw_shared ? tws + 2 * n : ti_q,
                                  s.tw_shared ? tws + 3 * n : ti_q_sh, p,
                                  static_cast<uint32_t>(sc[q * kConstCols + kColNinv]),
                                  static_cast<uint32_t>(sc[q * kConstCols + kColNinvSh]));
        }

        // Garner mod 2^64 over the canonical residues, and accumulate
        for (int idx = tid; idx < 2 * n; idx += nthreads) {
            const int at = (idx & n) | swz(idx & (n - 1));
            acc[idx] += garner<uint64_t>(res + at, 2 * n, npr, sc, prod_mod64);
        }
        __syncthreads();
    }

    for (int i = tid; i < 2 * n; i += nthreads) acc_io[i] = acc[i];
}

// Dynamic shared memory of one CTA without the power table, and the table's.
inline size_t state_bytes(int n, int npr, int l) {
    return static_cast<size_t>(n) * (16 + 8 * l + 8 * npr);
}
inline size_t table_bytes(int n, int npr) { return static_cast<size_t>(n) * 8 * npr; }

// what a CTA may ask for on sm_90 (227 KB), less the static constants
constexpr size_t kMaxDynamicShared = 232448 - sizeof(uint64_t) * kMaxPrimes * kConstCols;

// The power table goes to shared memory when it fits beside the CTA's state.
inline bool table_in_shared(int log_n, int npr, int l) {
    const int n = 1 << log_n;
    return state_bytes(n, npr, l) + table_bytes(n, npr) <= kMaxDynamicShared;
}

// One prime's twiddles go to shared memory too when they fit behind the state
// and the table (the table comes first: it is read at random, the twiddles
// in rows that L1 serves well).
inline bool twiddles_in_shared(int log_n, int npr, int l) {
    const int n = 1 << log_n;
    const size_t used = state_bytes(n, npr, l) + (table_in_shared(log_n, npr, l) ? table_bytes(n, npr) : 0);
    return used + static_cast<size_t>(16) * n <= kMaxDynamicShared;
}

using MxKernel = decltype(&mx_sweep_kernel<true, 0, 0, 0>);

// Threads of a CTA: one per butterfly of a stage, at most kMaxThreads.
inline int mx_threads(int log_n) {
    return (1 << log_n) / 2 < kMaxThreads ? (1 << log_n) / 2 : kMaxThreads;
}

// How a shape is served: the kernel, its template arguments (power table in
// shared memory, log2 N, l, primes; 0 where the kernel takes the value at run
// time), its launch, and whether the twiddles are staged in shared memory.
struct MxPlan {
    MxKernel kernel;
    int targs[4];
    int threads;
    size_t shared_bytes;
    bool tw_shared;
};

template <bool kPowShared, int kLogN, int kL, int kNpr>
inline MxPlan plan_with(int log_n, int npr, int l) {
    const int n = 1 << log_n;
    const bool tw_shared = twiddles_in_shared(log_n, npr, l);
    return {&mx_sweep_kernel<kPowShared, kLogN, kL, kNpr>,
            {kPowShared, kLogN, kL, kNpr},
            mx_threads(log_n),
            state_bytes(n, npr, l) + (kPowShared ? table_bytes(n, npr) : 0) +
                (tw_shared ? static_cast<size_t>(16) * n : 0),
            tw_shared};
}

// The one place that decides which kernel serves a shape: the instance
// compiled for it -- the mx keys of every binary KMS preset of
// schemes/presets.py at N = 2048, the table in shared memory:
//   KMS2party:             l = 3, 4 primes
//   KMS4party, KMS16party: l = 5, 3 primes
//   KMS8party:             l = 4, 3 primes (the twiddles fit there too)
//   KMS32party:            l = 6, 3 primes
// a small wide-gadget set (N = 256, l = 3, 3 primes, table in shared memory),
// and KMS32party's gadget over 4 primes (N = 2048, l = 6, table in device
// memory) -- else the kernel with run-time shapes, with the power table in
// shared memory where it fits and in device memory where not.  That one runs
// at about two thirds of an instance's speed: a parameter set that is to be
// served wants its line here.
inline MxPlan mx_plan(int log_n, int npr, int l) {
    const auto is = [&](int a, int b, int c) { return log_n == a && l == b && npr == c; };
    if (is(11, 4, 3)) return plan_with<true, 11, 4, 3>(log_n, npr, l);
    if (is(11, 3, 4)) return plan_with<true, 11, 3, 4>(log_n, npr, l);
    if (is(11, 5, 3)) return plan_with<true, 11, 5, 3>(log_n, npr, l);
    if (is(11, 6, 3)) return plan_with<true, 11, 6, 3>(log_n, npr, l);
    if (is(8, 3, 3)) return plan_with<true, 8, 3, 3>(log_n, npr, l);
    if (is(11, 6, 4)) return plan_with<false, 11, 6, 4>(log_n, npr, l);
    return table_in_shared(log_n, npr, l) ? plan_with<true, 0, 0, 0>(log_n, npr, l)
                                          : plan_with<false, 0, 0, 0>(log_n, npr, l);
}

// What `mx_plan` says of a shape, for the wrapper's notes: out[0..3] the
// template arguments, out[4] threads per CTA, out[5] dynamic shared bytes,
// out[6] whether the twiddles are staged in shared memory.
inline void describe_plan(int npr, int l, int log_n, int* out) {
    const MxPlan plan = mx_plan(log_n, npr, l);
    for (int i = 0; i < 4; ++i) out[i] = plan.targs[i];
    out[4] = plan.threads;
    out[5] = static_cast<int>(plan.shared_bytes);
    out[6] = plan.tw_shared;
}

}  // namespace

extern "C" int mktfhe_mx_sweep(void* acc, const void* tildea, const void* brk, const void* pow,
                               const void* tw_f, const void* tw_f_sh, const void* tw_i,
                               const void* tw_i_sh, const void* consts,
                               unsigned long long prod_mod64, long long ctas, int rows,
                               int n_steps, int npr, int l, int log_b, int log_n, void* stream) {
    const MxPlan plan = mx_plan(log_n, npr, l);
    const MxShape shape{rows, n_steps, npr, l, log_b, log_n, plan.tw_shared};
    const cudaError_t attr =
        cudaFuncSetAttribute(plan.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(plan.shared_bytes));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid(static_cast<unsigned int>(ctas));
    const dim3 block(plan.threads);
    plan.kernel<<<grid, block, plan.shared_bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t*>(acc), static_cast<const int32_t*>(tildea),
        static_cast<const uint32_t*>(brk), static_cast<const uint32_t*>(pow),
        static_cast<const uint32_t*>(tw_f), static_cast<const uint32_t*>(tw_f_sh),
        static_cast<const uint32_t*>(tw_i), static_cast<const uint32_t*>(tw_i_sh),
        static_cast<const uint64_t*>(consts), prod_mod64, shape);
    return static_cast<int>(cudaGetLastError());
}

extern "C" void mktfhe_mx_sweep_describe(int npr, int l, int log_n, int* out) {
    describe_plan(npr, l, log_n, out);
}

extern "C" const char* mktfhe_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
