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
// What bounds it on this card.  Integer arithmetic, not device memory: a
// step's key rows (96 KB at the CGGI preset) are shared by all CTAs and
// served from L2, as is the monomial table (16 MB); per gate and step the
// kernel runs 16 transforms of N = 1024 (2l forward, 2 inverse, per prime).
// Above the arithmetic: the barriers between the passes and the
// shared-memory round trips of the transforms.
//
// Design.  One CTA per gate, the loop over steps inside it; gates never
// interact, so there is no grid-wide synchronisation and the whole rotation
// is one launch.  Against the barriers and round trips (modarith.cuh has the
// parts):
//  - the transforms are the register-resident passes of modarith.cuh with
//    lazy butterflies: at N = 1024 a top pass of 3 stages, middle passes of
//    3 and 2, and a tail of the 2 narrowest stages;
//  - the top forward pass takes the digits from the accumulator words with
//    no carry chain (`digit_task`), and the top inverse pass ends in Garner
//    and the accumulation; both passes give a thread the same 8 coefficients
//    of one component (t0 | j N/8), so the accumulator never leaves the
//    registers: N/4 threads, 8 words each;
//  - the tail of the forward transforms, the pointwise stage and the tail of
//    the inverse transforms are one pass: a thread takes 4 neighbouring
//    positions of the 2l digit polynomials (16-byte accesses), finishes their
//    transforms, reduces them, multiplies by 16-byte quads of the key rows
//    and of the monomial image, and starts the inverse of its 4 positions of
//    both outputs: 13 barriers a step at the CGGI preset where the
//    stage-by-stage kernel had 46;
//  - both primes' twiddles are staged in shared memory once per launch;
//  - polynomials lie swizzled (`swz`), so every pass meets 32 banks;
//  - the lazy forward outputs are made canonical before the products, so
//    the 64-bit sums of 2l <= 12 terms stay below 12 p^2 < 2^63 and one
//    Barrett step reduces them;
//  - the shapes (log2 N, l, primes) are template arguments for preset CGGI
//    (step_plan below); every other shape the wrapper admits runs the same
//    kernel with run-time shapes.
// Shared memory: the 2l digit polynomials (8 l N bytes; the last prime's
// outputs go over the first two of them), the outputs of the other primes
// waiting for Garner (8 (npr - 1) N bytes) and, where they fit, every
// prime's twiddles (16 npr N bytes): 64 KB at the CGGI preset, so that two
// CTAs of up to 128 registers a thread share an SM.  Keys are read as the scheme stores them (bit-reversed
// NTT order, no Shoup companions).
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

constexpr int kMaxThreads = 512;  // N / 4 at N = 2048
constexpr int kMaxTerms = 12;  // 2 l_gsw digit polynomials, l_gsw <= 6
constexpr int kMaxShared = 232448 - static_cast<int>(sizeof(uint64_t)) * kMaxPrimes * kConstCols;

struct StepShape {
    int n_total, i0, i1, npr, l, log_b, log_n, tw_shared;
};

// The fused pass of one prime at the 4 neighbouring positions 4i .. 4i + 3:
// the last two stages of the 2l forward transforms at `dig` (in [0, 4p)), the
// external product with the key rows `key` [2l, 2, n], the monomial image
// `mon` [n], the first two stages of the two inverse transforms, written to
// `out` [2, n] (in [0, 2p)).  `out` may be `dig`: a thread writes only the
// words it read.
template <int kL>
__device__ __forceinline__ void tail_pass(uint32_t* dig, uint32_t* out, int terms, int n, int i,
                                          const uint32_t* __restrict__ key,
                                          const uint32_t* __restrict__ mon,
                                          const uint32_t* tf, const uint32_t* tf_sh,
                                          const uint32_t* ti, const uint32_t* ti_sh, uint32_t p,
                                          uint64_t mu) {
    const uint32_t two_p = 2 * p;
    const int p0 = swz(4 * i);
    const Twiddles<2> twf = load_twiddles<2>(n / 4 + i, tf, tf_sh);
    uint64_t s0[4] = {0, 0, 0, 0}, s1[4] = {0, 0, 0, 0};
    const uint4* key4 = reinterpret_cast<const uint4*>(key) + i;
    const int row4 = n / 4;  // uint4 per key row
    auto term = [&](int t) {
        const uint4 q = *reinterpret_cast<const uint4*>(dig + static_cast<size_t>(t) * n + p0);
        uint32_t e[4] = {q.x, q.y, q.z, q.w};
        butterflies<2, true>(e, twf, p, two_p);
        const uint4 k0 = __ldg(key4 + (2 * t) * row4);
        const uint4 k1 = __ldg(key4 + (2 * t + 1) * row4);
        const uint32_t k0v[4] = {k0.x, k0.y, k0.z, k0.w};
        const uint32_t k1v[4] = {k1.x, k1.y, k1.z, k1.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const uint64_t d = canonical(e[j], p);
            s0[j] += d * k0v[j];
            s1[j] += d * k1v[j];
        }
    };
    if (kL != 0) {
#pragma unroll
        for (int t = 0; t < kMaxTerms; ++t) {
            if (t < 2 * kL) term(t);
        }
    } else {
        for (int t = 0; t < terms; ++t) term(t);
    }
    const uint4 m4 = __ldg(reinterpret_cast<const uint4*>(mon) + i);
    const uint32_t m[4] = {m4.x, m4.y, m4.z, m4.w};
    uint32_t o0[4], o1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        o0[j] = barrett_reduce(static_cast<uint64_t>(barrett_reduce(s0[j], mu, p)) * m[j], mu, p);
        o1[j] = barrett_reduce(static_cast<uint64_t>(barrett_reduce(s1[j], mu, p)) * m[j], mu, p);
    }
    const Twiddles<2> twi = load_twiddles<2>(n / 4 + i, ti, ti_sh);
    butterflies<2, false>(o0, twi, p, two_p);
    butterflies<2, false>(o1, twi, p, two_p);
    *reinterpret_cast<uint4*>(out + p0) = make_uint4(o0[0], o0[1], o0[2], o0[3]);
    *reinterpret_cast<uint4*>(out + n + p0) = make_uint4(o1[0], o1[1], o1[2], o1[3]);
}

// acc:    [gates, 2, n] u32, in and out
// tildea: [gates, n_total] rotation amounts in [0, 2n)
// brk:    [n_total, npr, 2l, 2, n] residues
// mono:   [2n, npr, n] images of X^a - 1
// tw_*:   [npr, n] bit-reversed psi / psi^-1 tables with Shoup companions
// consts: [npr, kConstCols]
// kLogN, kL, kNpr: the shape at compile time, or 0 to take it from `s`.
// N/4 threads.  kMinCtas: CTAs an SM is to hold (registers are sized for it).
template <int kLogN, int kL, int kNpr, int kMinCtas>
__global__ void __launch_bounds__(kLogN ? 1 << (kLogN ? kLogN - 2 : 0) : kMaxThreads, kMinCtas)
cggi_step_kernel(uint32_t* __restrict__ acc_g, const int32_t* __restrict__ tildea,
                 const uint32_t* __restrict__ brk, const uint32_t* __restrict__ mono,
                 const uint32_t* __restrict__ tw_f, const uint32_t* __restrict__ tw_f_sh,
                 const uint32_t* __restrict__ tw_i, const uint32_t* __restrict__ tw_i_sh,
                 const uint64_t* __restrict__ consts, uint32_t prod_mod32, StepShape s) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ uint64_t sc[kMaxPrimes * kConstCols];

    const int log_n = kLogN ? kLogN : s.log_n;
    const int l = kL ? kL : s.l;
    const int npr = kNpr ? kNpr : s.npr;
    const int n = 1 << log_n;
    const int nthreads = blockDim.x;
    const int tid = threadIdx.x;
    const int terms = 2 * l;
    const int top = log_n - 3;  // the top passes' s
    const DigitShape<uint32_t> gadget = digit_shape<uint32_t>(l, s.log_b);

    uint32_t* dig = reinterpret_cast<uint32_t*>(smem);  // [2l, n], swizzled rows
    uint32_t* res = dig + static_cast<size_t>(terms) * n;  // [npr - 1, 2, n], swizzled rows
    uint32_t* tws = res + static_cast<size_t>(npr - 1) * 2 * n;  // [npr, 4, n] if s.tw_shared

    const long long gate = blockIdx.x;
    const int32_t* ta = tildea + gate * s.n_total;
    uint32_t* acc_io = acc_g + gate * 2 * n;

    // this thread's (component, task) of the top passes
    const int c = tid >> top, t0 = tid & ((1 << top) - 1);
    uint32_t acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = acc_io[c * n + (t0 | (j << top))];

    for (int i = tid; i < npr * kConstCols; i += nthreads) sc[i] = consts[i];
    if (s.tw_shared) {
        for (int q = 0; q < npr; ++q) {
            const size_t at = static_cast<size_t>(q) * n;
            stage_twiddles(tws + 4 * at, tw_f + at, tw_f_sh + at, tw_i + at, tw_i_sh + at, n, tid,
                           nthreads);
        }
    }
    __syncthreads();

    const size_t row_stride = static_cast<size_t>(terms) * 2 * n;  // one prime's key rows
    for (int step = s.i0; step < s.i1; ++step) {
        // X^(a + 2N) = X^a: any int32 amount, reduced mod 2N on its bits
        const uint32_t a = static_cast<uint32_t>(ta[step]) & (2u * n - 1u);
        for (int q = 0; q < npr; ++q) {
            const uint32_t p = static_cast<uint32_t>(sc[q * kConstCols + kColP]);
            const uint64_t mu = sc[q * kConstCols + kColMu];
            const size_t at = static_cast<size_t>(q) * n;
            const uint32_t* tf = s.tw_shared ? tws + 4 * at : tw_f + at;
            const uint32_t* tf_sh = s.tw_shared ? tws + 4 * at + n : tw_f_sh + at;
            const uint32_t* ti = s.tw_shared ? tws + 4 * at + 2 * n : tw_i + at;
            const uint32_t* ti_sh = s.tw_shared ? tws + 4 * at + 3 * n : tw_i_sh + at;

            // 1-2. the forward transforms of the 2l lifted digit polynomials
            // (polynomial c * l + j: digit j of component c), decomposed in
            // the top pass (the digit sources are formed again per prime: 8
            // registers fewer over the passes)
            uint32_t v[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) v[j] = digit_source(acc[j], gadget);
            digit_task(dig + static_cast<size_t>(c) * l * n, v, 0, 1, gadget, log_n, t0,
                       load_twiddles<3>(1, tf, tf_sh), p);
            __syncthreads();
            middle_passes<kLogN, true>(dig, terms, log_n, tid, nthreads, tf, tf_sh, p);

            // 3-4. their tails, the external product weighted by the image of
            // X^a - 1, and the tails of the two inverse transforms
            uint32_t* out = q + 1 < npr ? res + 2 * at : dig;
            const uint32_t* key = brk + (static_cast<size_t>(step) * npr + q) * row_stride;
            const uint32_t* mon = mono + (static_cast<size_t>(a) * npr + q) * n;
            for (int i = tid; i < n / 4; i += nthreads) {
                tail_pass<kL>(dig, out, terms, n, i, key, mon, tf, tf_sh, ti, ti_sh, p, mu);
            }
            __syncthreads();

            // 5. the rest of the inverse transforms; the top pass scales by
            // 1/N, and for the last prime ends in Garner mod 2^32 over every
            // prime's residues and acc += the result
            middle_passes<kLogN, false>(out, 2, log_n, tid, nthreads, ti, ti_sh, p);
            const uint32_t ninv = static_cast<uint32_t>(sc[q * kConstCols + kColNinv]);
            const uint32_t ninv_sh = static_cast<uint32_t>(sc[q * kConstCols + kColNinvSh]);
            if (q + 1 < npr) {
                radix_pass<3, false>(out, 2, log_n, top, tid, nthreads, ti, ti_sh, p, true, ninv,
                                     ninv_sh);
            } else {
                const Twiddles<3> tw = load_twiddles<3>(1, ti, ti_sh);
                const int p0 = swz(t0);
                uint32_t e[8];
#pragma unroll
                for (int j = 0; j < 8; ++j) e[j] = out[c * n + (p0 ^ swz(j << top))];
                butterflies<3, false>(e, tw, p, 2 * p);
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    uint32_t r[kMaxPrimes];
                    for (int qq = 0; qq + 1 < npr; ++qq) {
                        r[qq] = res[(2 * qq + c) * static_cast<size_t>(n) + (p0 ^ swz(j << top))];
                    }
                    r[npr - 1] = shoup_mul(ninv, ninv_sh, e[j], p);
                    acc[j] += garner<uint32_t>(r, 1, npr, sc, prod_mod32);
                }
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 8; ++j) acc_io[c * n + (t0 | (j << top))] = acc[j];
}

using StepKernel = decltype(&cggi_step_kernel<0, 0, 0, 1>);

// Dynamic shared memory of one CTA: digit polynomials, the outputs of all
// but the last prime, and every prime's twiddles if `tw_shared`.
inline int step_shared_bytes(int log_n, int l, int npr, bool tw_shared) {
    const int n = 1 << log_n;
    return 4 * n * (2 * l + 2 * (npr - 1)) + (tw_shared ? 16 * n * npr : 0);
}

// How a shape is served: the kernel, its template arguments (log2 N, l,
// primes, CTAs per SM; 0 where the kernel takes the shape at run time), its
// launch and where the twiddles lie.
struct StepPlan {
    StepKernel kernel;
    int targs[4];
    int threads, shared_bytes;
    bool tw_shared;
};

template <int kLogN, int kL, int kNpr, int kMinCtas>
inline StepPlan plan_with(int log_n, int l, int npr) {
    const bool tw_shared = step_shared_bytes(log_n, l, npr, true) <= kMaxShared;
    return {&cggi_step_kernel<kLogN, kL, kNpr, kMinCtas>,
            {kLogN, kL, kNpr, kMinCtas},
            1 << (log_n - 2),
            step_shared_bytes(log_n, l, npr, tw_shared),
            tw_shared};
}

// The one place that decides which kernel serves a shape: the instance
// compiled for preset CGGI of schemes/presets.py (N = 1024, l_gsw = 3, 2
// primes; 256 threads, two CTAs an SM: sized for three, 80 registers spilled
// and the kernel was 5-13% slower; 512 threads, two to a top-pass task,
// were 28% slower), else the kernel with run-time shapes (N / 4 threads).
inline StepPlan step_plan(int log_n, int l, int npr) {
    if (log_n == 10 && l == 3 && npr == 2) return plan_with<10, 3, 2, 2>(log_n, l, npr);
    return plan_with<0, 0, 0, 1>(log_n, l, npr);
}

// What `step_plan` says of a shape, for the wrapper's notes: out[0..3] the
// template arguments, out[4] threads per CTA, out[5] dynamic shared bytes,
// out[6] 1 if the twiddles lie in shared memory.
inline void describe_plan(int npr, int l, int log_n, int* out) {
    const StepPlan plan = step_plan(log_n, l, npr);
    for (int i = 0; i < 4; ++i) out[i] = plan.targs[i];
    out[4] = plan.threads;
    out[5] = plan.shared_bytes;
    out[6] = plan.tw_shared;
}

}  // namespace

extern "C" int mktfhe_cggi_step(void* acc, const void* tildea, const void* brk, const void* mono,
                                const void* tw_f, const void* tw_f_sh, const void* tw_i,
                                const void* tw_i_sh, const void* consts, unsigned int prod_mod32,
                                long long gates, int n_total, int i0, int i1, int npr, int l,
                                int log_b, int log_n, void* stream) {
    const StepPlan plan = step_plan(log_n, l, npr);
    const StepShape shape{n_total, i0, i1, npr, l, log_b, log_n, plan.tw_shared};
    const cudaError_t attr = cudaFuncSetAttribute(
        plan.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.shared_bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    plan.kernel<<<dim3(static_cast<unsigned int>(gates)), dim3(plan.threads), plan.shared_bytes,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint32_t*>(acc), static_cast<const int32_t*>(tildea),
        static_cast<const uint32_t*>(brk), static_cast<const uint32_t*>(mono),
        static_cast<const uint32_t*>(tw_f), static_cast<const uint32_t*>(tw_f_sh),
        static_cast<const uint32_t*>(tw_i), static_cast<const uint32_t*>(tw_i_sh),
        static_cast<const uint64_t*>(consts), prod_mod32, shape);
    return static_cast<int>(cudaGetLastError());
}

extern "C" void mktfhe_cggi_step_describe(int npr, int l, int log_n, int* out) {
    describe_plan(npr, l, log_n, out);
}

extern "C" const char* mktfhe_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
