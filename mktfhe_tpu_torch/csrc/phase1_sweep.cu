// KMS phase-1 sweep: the parties' whole blind rotations over their RLEV
// accumulators on the 2^64 torus, every party in one launch, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// mktfhe_tpu/kernels/fused_mx3.py:make_mx3_sweep_kernel (reached there
// through kms_phase1_mx3 / bootstrap_mx3; here through kms_phase1_sweeps /
// phase1_sweep of kernels/fused_mx3.py).  Plain PyTorch version of the same
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
// What bounds it on this card.  Not device memory: a step does about 0.9 M
// modular multiplies per CTA at KMS8partyblock widths while its key rows
// (1.57 MB a party) are shared by all CTAs of the party, which advance nearly
// in step, and come from L2.  The state of one (gate, row) fills most of an
// SM's shared memory (192 KB at N = 2048, l = 4, 4 primes), so one CTA runs per SM and
// whatever makes its warps wait idles the SM.  Integer operations set the
// floor; above it, measured on an H100 with builds that left one part out:
// the key rows from L2 (a quarter of the block variant's time, a tenth of the
// binary variant's: 132 SMs ask for the same 123 GB per party sweep within
// the pointwise stages), and the barriers between the passes (8%).
//
// Design.  One CTA per (party, gate, row); the loop over steps runs inside
// the CTA, where the TPU kernel had a sequential grid dimension with the
// accumulator in VMEM scratch.  Parties, rows and gates never interact, so
// there is no grid-wide synchronisation and one launch does every party's
// whole rotation.  The parties share one grid because one party's fills a
// wave of 132 SMs only at wide batches: at 8 gates a party of 3 rows is 24
// CTAs, and k launches of a partial wave each take a CTA's whole sweep,
// where one grid of all k parties takes ceil(sum) <= sum(ceil) waves.  The
// first party of a launch may run fewer rows (KMS party 1 needs one), so
// it owns CTAs [0, G rows_1) and every later party G rows after them.  All state
// lives in shared memory: the accumulator (16 N bytes), the 2l transformed
// digit polynomials of the current prime (8 l N bytes; primes run one after
// the other and reuse it), the inverse-transformed residues of every prime
// waiting for Garner (8 npr N bytes) and the current prime's twiddles
// (16 N bytes).  Against the barriers and the shared-memory bytes
// (modarith.cuh has the parts):
//  - the transforms are register-resident radix-8 passes with lazy
//    butterflies: 4 passes and 4 barriers per transform at N = 2048 where a
//    stage-by-stage transform has 11, a prime's step 9 barriers for 25;
//  - the first forward pass decomposes the accumulator on the fly (each
//    digit is a shift and a mask of the value plus an offset, no carry
//    chain), so the digits never make a trip of their own;
//  - the polynomials lie swizzled, so every pass and the pointwise walk meet
//    32 banks; the last pass moves 16 bytes a thread;
//  - a thread keeps a task's twiddles in registers over the polynomials it
//    serves, and takes them from shared memory, where each prime's tables
//    are copied while the first pass runs;
//  - the pointwise stage holds a position's 2l digits in registers over the
//    ell members, and the 4l key loads of a member are in flight together;
//  - the scaling by 1/N rides on the inverse's last pass;
//  - 512 threads, so that a thread may hold 128 registers (1,024 threads of
//    64 registers spilled and were 3% slower, 256 threads 25% slower);
//  - the shapes (log2 N, l, primes, ell) are template arguments for the
//    KMS presets (sweep_plan below picks by the shape); every other shape
//    the wrapper admits runs the same kernel with run-time shapes, whose
//    loops do not unroll and which is half as fast.
// Keys are read as the scheme stores them (standard NTT domain in the plain
// transform's bit-reversed order, no Shoup companions): products of two
// runtime residues are summed in 64 bits (at most 2l <= 12 canonical terms)
// and reduced by one Barrett step.
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

constexpr int kMaxThreads = 512;  // threads of a CTA at N >= 1024
constexpr int kMaxTerms = 12;  // 2 l_gsw digit polynomials, l_gsw <= 6

// gates and rows of a launch: the first party `first_rows` rows a gate, each
// of the other parties - 1 parties `rows`
struct SweepShape {
    int gates, parties, first_rows, rows, n_steps, ell, npr, l, log_b, log_n;
};

// acc:    [ctas, 2, n] u64, in and out; party 0's CTAs first, then party 1's,
//         ...; within a party cta = gate * rows + row
// tildea: [gates, parties * n_steps * ell] rotation amounts in [0, 2n), a
//         party's after the party before it
// brk:    [parties, n_steps * ell, 2l, 2, npr, n] residues (key row = step * ell
//         + member)
// mono:   [2n, npr, n] images of X^a - 1 (block variant only)
// tw_*:   [npr, n] bit-reversed psi / psi^-1 tables with Shoup companions
// consts: [npr, kConstCols]
// kLogN, kL, kNpr, kEll: the shape at compile time, or 0 to take it from `s`.
template <bool kBlock, int kLogN, int kL, int kNpr, int kEll>
__global__ void __launch_bounds__(kMaxThreads)
phase1_sweep_kernel(uint64_t* __restrict__ acc_g, const int32_t* __restrict__ tildea,
                    const uint32_t* __restrict__ brk, const uint32_t* __restrict__ mono,
                    const uint32_t* __restrict__ tw_f, const uint32_t* __restrict__ tw_f_sh,
                    const uint32_t* __restrict__ tw_i, const uint32_t* __restrict__ tw_i_sh,
                    const uint64_t* __restrict__ consts, uint64_t prod_mod64, SweepShape s) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ uint64_t sc[kMaxPrimes * kConstCols];

    const int log_n = kLogN ? kLogN : s.log_n;
    const int l = kL ? kL : s.l;
    const int npr = kNpr ? kNpr : s.npr;
    const int ell = kEll ? kEll : s.ell;
    const int n = 1 << log_n;
    const int nthreads = blockDim.x;
    const int tid = threadIdx.x;
    const int terms = 2 * l;
    const DigitShape<uint64_t> gadget = digit_shape<uint64_t>(l, s.log_b);

    uint64_t* acc = reinterpret_cast<uint64_t*>(smem);  // [2, n]
    uint32_t* dig = reinterpret_cast<uint32_t*>(acc + 2 * n);  // [2l, n], swizzled rows
    const int dig_words = terms * n > 4 * n ? terms * n : 4 * n;
    uint32_t* res = dig + dig_words;  // [npr, 2, n], swizzled rows
    // binary variant: e on the torus, [2, n] u64, over the idle digit buffer
    uint64_t* etor = reinterpret_cast<uint64_t*>(dig);
    uint32_t* tws = res + static_cast<size_t>(npr) * 2 * n;  // [4, n]: the prime's twiddles

    // the CTA's party, and its gate within the party's grid
    const long long cta = blockIdx.x;
    const long long lead = static_cast<long long>(s.gates) * s.first_rows;
    const long long later = cta - lead;
    const long long party_ctas = static_cast<long long>(s.gates) * s.rows;
    const int party = later < 0 ? 0 : 1 + static_cast<int>(later / party_ctas);
    const long long gate = later < 0 ? cta / s.first_rows : (later % party_ctas) / s.rows;
    const long long key_rows = static_cast<long long>(s.n_steps) * ell;
    const int32_t* ta = tildea + (gate * s.parties + party) * key_rows;
    uint64_t* acc_io = acc_g + cta * 2 * n;

    for (int i = tid; i < npr * kConstCols; i += nthreads) sc[i] = consts[i];
    for (int i = tid; i < 2 * n; i += nthreads) acc[i] = acc_io[i];
    __syncthreads();

    // one (term, cout) key row
    const size_t poly_stride = static_cast<size_t>(npr) * n;
    const size_t member_stride = static_cast<size_t>(terms) * 2 * poly_stride;
    const uint32_t* brk_p = brk + static_cast<size_t>(party) * key_rows * member_stride;

    for (int step = 0; step < s.n_steps; ++step) {
        const uint32_t* brk_s = brk_p + static_cast<size_t>(step) * ell * member_stride;
        for (int q = 0; q < npr; ++q) {
            const uint32_t p = static_cast<uint32_t>(sc[q * kConstCols + kColP]);
            const uint64_t mu = sc[q * kConstCols + kColMu];

            // 1-2. forward NTTs of the 2l lifted digit polynomials (polynomial
            // c * l + j: digit j of component c), decomposed in the first pass
            const uint32_t* tw_q = tw_f + static_cast<size_t>(q) * n;
            const uint32_t* tw_q_sh = tw_f_sh + static_cast<size_t>(q) * n;
            stage_twiddles(tws, tw_q, tw_q_sh, tw_i + static_cast<size_t>(q) * n,
                           tw_i_sh + static_cast<size_t>(q) * n, n, tid, nthreads);
            digits_first_pass(dig, acc, 2, gadget, log_n, tid, nthreads, tw_q, tw_q_sh, p);
            __syncthreads();
            fwd_ntt_passes<kLogN>(dig, terms, log_n, tid, nthreads, tws, tws + n, p);

            // 3-4. external product per output component; block variant:
            // weighted by the members' monomial images and summed
            uint32_t* out = res + static_cast<size_t>(q) * 2 * n;
            // binary variant: neighbouring CTAs start their walk n / 32 positions
            // apart, so that the SMs, which advance nearly in step, do not all
            // ask the same L2 lines at once (the launch's CTA index: it only
            // reorders the positions)
            const int first = kBlock ? 0 : (static_cast<int>(cta) & 31) * (n / 32);
            for (int i0 = tid; i0 < n; i0 += nthreads) {
                const int i = (i0 + first) & (n - 1);
                const int pi = swz(i);
                // Compile-time digit count: the position's 2l digits stay in
                // registers over the ell members and a member's 4l key loads are
                // in flight together.  Run-time digit count: the terms stay a
                // loop that reads each digit where it is needed (unrolled to
                // the most terms, its predicated loads spilled registers and
                // the block variant fell behind the stage-by-stage kernel).
                uint32_t d[kMaxTerms];
                if (kL != 0) {
#pragma unroll
                    for (int t = 0; t < kMaxTerms; ++t) {
                        if (t < terms) d[t] = canonical(dig[t * n + pi], p);
                    }
                }
                uint32_t u0 = 0, u1 = 0;
                for (int m = 0; m < ell; ++m) {
                    const uint32_t* key = brk_s + m * member_stride + static_cast<size_t>(q) * n + i;
                    uint64_t s0 = 0, s1 = 0;
                    if (kL != 0) {
#pragma unroll
                        for (int t = 0; t < kMaxTerms; ++t) {
                            if (t < terms) {
                                s0 += static_cast<uint64_t>(d[t]) * key[(2 * t) * poly_stride];
                                s1 += static_cast<uint64_t>(d[t]) * key[(2 * t + 1) * poly_stride];
                            }
                        }
                    } else {
#pragma unroll 2
                        for (int t = 0; t < terms; ++t) {
                            const uint64_t dt = canonical(dig[t * n + pi], p);
                            s0 += dt * key[(2 * t) * poly_stride];
                            s1 += dt * key[(2 * t + 1) * poly_stride];
                        }
                    }
                    const uint32_t e0 = barrett_reduce(s0, mu, p);
                    const uint32_t e1 = barrett_reduce(s1, mu, p);
                    if (kBlock) {
                        // X^(a + 2N) = X^a: any int32 amount, reduced mod 2N on its bits
                        const uint32_t a = static_cast<uint32_t>(ta[step * ell + m]) & (2u * n - 1u);
                        const uint64_t mon = mono[(static_cast<size_t>(a) * npr + q) * n + i];
                        u0 = barrett_reduce(u0 + e0 * mon, mu, p);
                        u1 = barrett_reduce(u1 + e1 * mon, mu, p);
                    } else {
                        u0 = e0;
                        u1 = e1;
                    }
                }
                out[pi] = u0;
                out[n + pi] = u1;
            }
            __syncthreads();

            // 5. inverse NTT of the two output polynomials, scaled by 1/N
            inv_ntt_passes<kLogN>(out, 2, log_n, tid, nthreads, tws + 2 * n, tws + 3 * n, p,
                                  static_cast<uint32_t>(sc[q * kConstCols + kColNinv]),
                                  static_cast<uint32_t>(sc[q * kConstCols + kColNinvSh]));
        }

        // Garner mod 2^64 over the canonical residues, and accumulate
        if (kBlock) {
            for (int idx = tid; idx < 2 * n; idx += nthreads) {
                const int at = (idx & n) | swz(idx & (n - 1));
                acc[idx] += garner<uint64_t>(res + at, 2 * n, npr, sc, prod_mod64);
            }
        } else {
            for (int idx = tid; idx < 2 * n; idx += nthreads) {
                const int at = (idx & n) | swz(idx & (n - 1));
                etor[idx] = garner<uint64_t>(res + at, 2 * n, npr, sc, prod_mod64);
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

using SweepKernel = decltype(&phase1_sweep_kernel<true, 0, 0, 0, 0>);

// Threads of a CTA: one per butterfly of a stage, at most kMaxThreads.
inline int sweep_threads(int log_n) {
    return (1 << log_n) / 2 < kMaxThreads ? (1 << log_n) / 2 : kMaxThreads;
}

// Dynamic shared memory of one CTA: accumulator, digit polynomials, residues
// and one prime's twiddles; at most 112 n bytes (l = 6, 4 primes), 224 KB at
// N = 2048.
inline int sweep_shared_bytes(int log_n, int l, int npr) {
    const int n = 1 << log_n;
    const int dig_words = 2 * l * n > 4 * n ? 2 * l * n : 4 * n;
    return 16 * n + 4 * dig_words + 8 * npr * n + 16 * n;
}

// How a shape is served: the kernel, its template arguments (block keys,
// log2 N, l, primes, ell; 0 where the kernel takes the value at run time) and
// its launch.
struct SweepPlan {
    SweepKernel kernel;
    int targs[5];
    int threads, shared_bytes;
};

template <bool kBlock, int kLogN, int kL, int kNpr, int kEll>
inline SweepPlan plan_with(const SweepShape& s) {
    return {&phase1_sweep_kernel<kBlock, kLogN, kL, kNpr, kEll>,
            {kBlock, kLogN, kL, kNpr, kEll},
            sweep_threads(s.log_n),
            sweep_shared_bytes(s.log_n, s.l, s.npr)};
}

// The one place that decides which kernel serves a shape: the instance
// compiled for it -- every KMS preset of schemes/presets.py at N = 2048 has
// one, with binary keys and with block keys (ell = 3):
//   KMS2party, KMS2partyblock:          l = 3, 4 primes
//   KMS4party, KMS16party, their block: l = 5, 3 primes
//   KMS8party:                          l = 4, 3 primes
//   KMS8partyblock:                     l = 4, 4 primes
//   KMS32party, KMS32partyblock:        l = 6, 3 primes
// and a small wide-gadget set (binary keys, N = 256, l = 3, 3 primes) --
// else the kernel with run-time shapes, which runs at about the speed of a
// stage-by-stage kernel (half of an instance's): a parameter set that is
// to be served wants its line here.
inline SweepPlan sweep_plan(bool block, const SweepShape& s) {
    const auto is = [&](bool b, int log_n, int l, int npr, int ell) {
        return block == b && s.log_n == log_n && s.l == l && s.npr == npr && s.ell == ell;
    };
    if (is(true, 11, 4, 4, 3)) return plan_with<true, 11, 4, 4, 3>(s);
    if (is(false, 11, 4, 3, 1)) return plan_with<false, 11, 4, 3, 1>(s);
    if (is(true, 11, 3, 4, 3)) return plan_with<true, 11, 3, 4, 3>(s);
    if (is(false, 11, 3, 4, 1)) return plan_with<false, 11, 3, 4, 1>(s);
    if (is(true, 11, 5, 3, 3)) return plan_with<true, 11, 5, 3, 3>(s);
    if (is(false, 11, 5, 3, 1)) return plan_with<false, 11, 5, 3, 1>(s);
    if (is(true, 11, 6, 3, 3)) return plan_with<true, 11, 6, 3, 3>(s);
    if (is(false, 11, 6, 3, 1)) return plan_with<false, 11, 6, 3, 1>(s);
    if (is(false, 8, 3, 3, 1)) return plan_with<false, 8, 3, 3, 1>(s);
    return block ? plan_with<true, 0, 0, 0, 0>(s) : plan_with<false, 0, 0, 0, 1>(s);
}

// What `sweep_plan` says of a shape, for the wrapper's notes: out[0..4] the
// template arguments, out[5] threads per CTA, out[6] dynamic shared bytes.
inline void describe_plan(int block, int ell, int npr, int l, int log_n, int* out) {
    const SweepPlan plan = sweep_plan(block != 0, SweepShape{1, 1, 1, 1, 0, ell, npr, l, 1, log_n});
    for (int i = 0; i < 5; ++i) out[i] = plan.targs[i];
    out[5] = plan.threads;
    out[6] = plan.shared_bytes;
}

}  // namespace

// `mono` is null for binary keys and selects the variant.  `ctas`: gates *
// (first_rows + (parties - 1) * rows), which the caller keeps below 2^31.
extern "C" int mktfhe_phase1_sweep(void* acc, const void* tildea, const void* brk,
                                   const void* mono, const void* tw_f, const void* tw_f_sh,
                                   const void* tw_i, const void* tw_i_sh, const void* consts,
                                   unsigned long long prod_mod64, long long ctas, int gates,
                                   int parties, int first_rows, int rows, int n_steps, int ell,
                                   int npr, int l, int log_b, int log_n, void* stream) {
    const SweepShape shape{gates, parties, first_rows, rows, n_steps, ell, npr, l, log_b, log_n};
    const SweepPlan plan = sweep_plan(mono != nullptr, shape);
    const cudaError_t attr = cudaFuncSetAttribute(
        plan.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.shared_bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid(static_cast<unsigned int>(ctas));
    const dim3 block(plan.threads);
    plan.kernel<<<grid, block, plan.shared_bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t*>(acc), static_cast<const int32_t*>(tildea),
        static_cast<const uint32_t*>(brk), static_cast<const uint32_t*>(mono),
        static_cast<const uint32_t*>(tw_f), static_cast<const uint32_t*>(tw_f_sh),
        static_cast<const uint32_t*>(tw_i), static_cast<const uint32_t*>(tw_i_sh),
        static_cast<const uint64_t*>(consts), prod_mod64, shape);
    return static_cast<int>(cudaGetLastError());
}

extern "C" void mktfhe_phase1_sweep_describe(int block, int ell, int npr, int l, int log_n,
                                             int* out) {
    describe_plan(block, ell, npr, l, log_n, out);
}

extern "C" const char* mktfhe_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
