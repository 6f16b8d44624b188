// Modular arithmetic, NTT butterflies and passes, gadget digits and Garner
// reconstruction over the 30-bit CRT primes, shared by the CUDA kernels of
// this package (ntt.cu, cggi_step.cu, phase1_sweep.cu, mx_sweep.cu,
// hybrid_product.cu).
//
// Residues are canonical u32 values in [0, p) with p < 2^29.42, so 4p fits
// 32 bits.  The arithmetic mirrors mktfhe_tpu_torch/ring/modring.py,
// ring/torus.py and ciphertext/decomp.py bit for bit: the kernels and their
// plain PyTorch versions compute the same integers.
//
// The transform (ntt.cu's natural kernel, cggi_step.cu and both sweeps): a
// thread holds 2^R <= 8 coefficients of a polynomial in registers and runs R
// stages on them between two trips to shared memory (`radix_pass`); a
// transform of N = 2^log_n is one pass of 3 stages at the top, the middle
// passes (`middle_passes`: 3 stages each, the rest of log_n - 5 as one pass
// of 1 or 2 stages ending at half-width 4) and a pass of the 2 narrowest
// stages on 4 neighbouring words, one 16-byte access (4 passes and 4
// barriers at N = 1024 and 2048 where a stage-by-stage transform has 10 and
// 11).  A thread keeps a pass's twiddles in registers over all the
// polynomials it serves; butterflies are lazy (Harvey): values stay in
// [0, 4p) forward and [0, 2p) inverse and are reduced once at the end, which
// leaves the same canonical integers; the polynomial is laid out through an
// XOR swizzle (`swz`) under which every pass meets 32 distinct banks at
// N = 1024 and 2048; and the shapes are template arguments, so every loop
// over stages is unrolled.  The batch-minor kernel of ntt.cu runs the same
// plan and `butterflies` on 16-byte quads of 4 gates (its own pass,
// `tile_pass`, for the gate-minor tile and its swizzle `bm_swz`).

#pragma once

#include <cstddef>
#include <cstdint>

namespace mktfhe {

// (w * a) mod p for a constant w < p with w_sh = floor(w 2^32 / p); exact for
// any a < 2^32.
__device__ __forceinline__ uint32_t shoup_mul(uint32_t w, uint32_t w_sh, uint32_t a, uint32_t p) {
    const uint32_t q = __umulhi(w_sh, a);
    const uint32_t r = w * a - q * p;  // wrapping; r in [0, 2p)
    return r >= p ? r - p : r;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t p) {
    const uint32_t d = a + (p - b);
    return d >= p ? d - p : d;
}

// x mod p for any x < 2^64, with mu = floor(2^64 / p).  The quotient estimate
// q = floor(x mu / 2^64) satisfies floor(x/p) - 1 <= q <= floor(x/p), so
// x - q p lies in [0, 2p) and its low 32 bits are exact.
__device__ __forceinline__ uint32_t barrett_reduce(uint64_t x, uint64_t mu, uint32_t p) {
    const uint32_t q = static_cast<uint32_t>(__umul64hi(x, mu));
    const uint32_t r = static_cast<uint32_t>(x) - q * p;  // wrapping
    return r >= p ? r - p : r;
}

// ---------------------------------------------------------------------------
// The register-resident transform of every kernel.

// x in [0, 2m) -> x mod m (unsigned wrap makes x - m huge when x < m).
__device__ __forceinline__ uint32_t csub(uint32_t x, uint32_t m) { return min(x, x - m); }

// (w * a) mod p up to one p: a value in [0, 2p) congruent to w a, for any
// a < 2^32 (w < p, w_sh = floor(w 2^32 / p)).
__device__ __forceinline__ uint32_t shoup_mul_lazy(uint32_t w, uint32_t w_sh, uint32_t a,
                                                   uint32_t p) {
    return w * a - __umulhi(w_sh, a) * p;  // wrapping
}

// Lazy Cooley-Tukey butterfly on registers.  In: u, v in [0, 4p).  Out:
// (u + w v, u - w v) mod p as values in [0, 4p).  4p < 2^32 for every prime.
// With t = w v - q p in [0, 2p) the Shoup product, u + t is formed inside the
// two multiply-adds and u - t + 2p as (2u + 2p) - (u + t): the integer adders
// are the busier pipe of an SM here, the multiplier has room (4% of a sweep).
__device__ __forceinline__ void ct_lazy(uint32_t& u, uint32_t& v, uint32_t w, uint32_t w_sh,
                                        uint32_t p, uint32_t two_p) {
    const uint32_t u0 = csub(u, two_p);                  // [0, 2p)
    const uint32_t q = __umulhi(w_sh, v);
    u = (w * v + u0) - q * p;                            // u0 + t: [0, 4p); wrapping
    v = (2 * u0 + two_p) - u;                            // u0 - t + 2p: (0, 4p)
}

// Lazy Gentleman-Sande butterfly on registers.  In: u, v in [0, 2p).  Out:
// (u + v, w (u - v)) mod p as values in [0, 2p).
__device__ __forceinline__ void gs_lazy(uint32_t& u, uint32_t& v, uint32_t w, uint32_t w_sh,
                                        uint32_t p, uint32_t two_p) {
    const uint32_t d = u - v + two_p;                    // (0, 4p)
    u = csub(u + v, two_p);                              // [0, 2p)
    v = shoup_mul_lazy(w, w_sh, d, p);                   // [0, 2p)
}

// [0, 4p) -> the canonical residue.
__device__ __forceinline__ uint32_t canonical(uint32_t x, uint32_t p) {
    return csub(csub(x, 2 * p), p);
}

// Where coefficient t of a polynomial lies inside its n words of shared
// memory.  XOR-linear (swz(a ^ b) = swz(a) ^ swz(b)), keeps groups of four
// words together (bits 0-1) and everything above bit 4, so it is a bijection
// on [0, n) for every n >= 32.  Bits 5-7 and 8-10 go into the bank bits 2-4,
// so that the 32 lanes of a warp meet 32 banks in every pass:
//  - N = 2048, passes at s = 8, 5, 2 and the tail: lanes differ in bits 0-4
//    (s = 8, 5), in bits 0-1 and 5-7 (s = 2: bank bits 2-4 ^= bits 5-7), and
//    the tail's 16-byte accesses in bits 2-6 (8 lanes at a time: bits 2-4);
//  - N = 1024, passes at s = 7, 4, 2 (2 stages) and the tail: lanes differ
//    in bits 0-4, in bits 0-3 and 7 (bank bit 4 ^= bit 7), in bits 0-1 and
//    4-6 (bank bits 2-3 ^= bits 5-6), and the tail as above;
//  - the mx walk, whose lanes differ in bits 8-10 and 0-1.
__device__ __forceinline__ int swz(int t) { return t ^ ((((t >> 5) ^ (t >> 8)) & 7) << 2); }

// The 2^R - 1 twiddles of one task of a pass (see radix_pass): stage k
// (half-width 2^(s+k)) has 2^(R-1-k) of them, kept at [2^(R-1-k) - 1 + i];
// table index (base << (R-1-k)) | i with base = n / 2^(s+R) + the task's
// high part.
template <int R>
struct Twiddles {
    uint32_t w[(1 << R) - 1], sh[(1 << R) - 1];
};

template <int R>
__device__ __forceinline__ Twiddles<R> load_twiddles(int base, const uint32_t* __restrict__ w,
                                                     const uint32_t* __restrict__ w_sh) {
    Twiddles<R> tw;
#pragma unroll
    for (int k = 0; k < R; ++k) {
#pragma unroll
        for (int i = 0; i < (1 << (R - 1 - k)); ++i) {
            const int idx = (base << (R - 1 - k)) | i;
            tw.w[(1 << (R - 1 - k)) - 1 + i] = w[idx];
            tw.sh[(1 << (R - 1 - k)) - 1 + i] = w_sh[idx];
        }
    }
    return tw;
}

// The R stages of a task on its 2^R coefficients in registers: forward from
// the widest stage down, inverse upwards.  Ranges: see ct_lazy / gs_lazy.
template <int R, bool kFwd>
__device__ __forceinline__ void butterflies(uint32_t (&e)[1 << R], const Twiddles<R>& tw,
                                            uint32_t p, uint32_t two_p) {
#pragma unroll
    for (int kk = 0; kk < R; ++kk) {
        const int k = kFwd ? R - 1 - kk : kk;
#pragma unroll
        for (int j = 0; j < (1 << R); ++j) {
            if (j & (1 << k)) continue;
            const int i = (1 << (R - 1 - k)) - 1 + (j >> (k + 1));
            if (kFwd) ct_lazy(e[j], e[j | (1 << k)], tw.w[i], tw.sh[i], p, two_p);
            else gs_lazy(e[j], e[j | (1 << k)], tw.w[i], tw.sh[i], p, two_p);
        }
    }
}

// One pass of R stages over `count` polynomials of n = 2^log_n words at `a`
// (swizzled), called by all `nthreads` threads of the CTA between barriers.
// The pass covers half-widths 2^(s+R-1) .. 2^s: a task owns the 2^R
// coefficients t0 | (j << s), where t0 has those R bits clear, and no other
// task touches them, so the pass works in place.  Forward (kFwd) uses w = the
// bit-reversed psi table; inverse the psi^-1 table.  A thread serves one task
// for several polynomials where there are at least as many threads as tasks,
// and keeps the task's twiddles in registers meanwhile.  `scale`: multiply
// every result by (ninv, ninv_sh) and store it canonical (the inverse
// transform's last pass).
template <int R, bool kFwd>
__device__ __forceinline__ void radix_pass(uint32_t* a, int count, int log_n, int s, int tid,
                                           int nthreads, const uint32_t* __restrict__ w,
                                           const uint32_t* __restrict__ w_sh, uint32_t p,
                                           bool scale = false, uint32_t ninv = 0,
                                           uint32_t ninv_sh = 0) {
    constexpr int kElems = 1 << R;
    const int n = 1 << log_n;
    const int log_tasks = log_n - R;
    const int ntasks = 1 << log_tasks;
    const uint32_t two_p = 2 * p;
    // four words that lie together: one 16-byte access
    const bool vec = R == 2 && s == 0;

    auto run = [&](int task, int poly0, int poly_step) {
        const int hi = task >> s;
        const int t0 = (hi << (s + R)) | (task & ((1 << s) - 1));
        const int p0 = swz(t0);
        const Twiddles<R> tw = load_twiddles<R>((1 << (log_n - s - R)) + hi, w, w_sh);
        for (int poly = poly0; poly < count; poly += poly_step) {
            uint32_t* row = a + static_cast<size_t>(poly) * n;
            uint32_t e[kElems];
            if (vec) {
                const uint4 q = *reinterpret_cast<const uint4*>(row + p0);
                e[0] = q.x; e[1] = q.y; e[2 % kElems] = q.z; e[3 % kElems] = q.w;
            } else {
#pragma unroll
                for (int j = 0; j < kElems; ++j) e[j] = row[p0 ^ swz(j << s)];
            }
            butterflies<R, kFwd>(e, tw, p, two_p);
            if (scale) {
#pragma unroll
                for (int j = 0; j < kElems; ++j) e[j] = shoup_mul(ninv, ninv_sh, e[j], p);
            }
            if (vec) {
                uint4 q;
                q.x = e[0]; q.y = e[1]; q.z = e[2 % kElems]; q.w = e[3 % kElems];
                *reinterpret_cast<uint4*>(row + p0) = q;
            } else {
#pragma unroll
                for (int j = 0; j < kElems; ++j) row[p0 ^ swz(j << s)] = e[j];
            }
        }
    };
    if (nthreads >= ntasks) {
        run(tid & (ntasks - 1), tid >> log_tasks, nthreads >> log_tasks);
    } else {
        for (int task = tid; task < ntasks; task += nthreads) run(task, 0, 1);
    }
}

// Balanced gadget digits without the carry chain, of a torus value a of T =
// uint32_t or uint64_t (ciphertext/decomp.py:balanced_decomp): digit j
// belongs to the gadget entry 2^(bits - (j+1) log_b), lies in [-B/2, B/2),
// and the top carry wraps away; where l log_b < bits the value is first
// rounded to l log_b bits.  With off = sum over the l levels of (B/2) B^k,
// the unsigned digit k of v = round(a) + off, less B/2, is the balanced digit
// k of a: both are THE representation of round(a) mod B^l with digits in
// [-B/2, B/2).  v fits T: below 2^(l log_b + 1) where l log_b < bits, and
// taken mod 2^bits = B^l where l log_b = bits.
template <typename T>
struct DigitShape {
    int l, log_b, low;  // low = bits - l log_b bits rounded away
    uint32_t mask, half_b;
    T off;
};

template <typename T>
__device__ __forceinline__ DigitShape<T> digit_shape(int l, int log_b) {
    DigitShape<T> g{l, log_b, static_cast<int>(8 * sizeof(T)) - l * log_b, (1u << log_b) - 1,
                    1u << (log_b - 1), 0};
    for (int k = 0; k < l; ++k) g.off += static_cast<T>(g.half_b) << (k * log_b);
    return g;
}

// v = round(a) + off, from which every digit of the torus value a comes.
template <typename T>
__device__ __forceinline__ T digit_source(T a, const DigitShape<T>& g) {
    const T ai = g.low > 0 ? static_cast<T>((a >> g.low) + ((a >> (g.low - 1)) & 1)) : a;
    return static_cast<T>(ai + g.off);
}

// Digit of level lev0 + 1 (gadget entry 2^(bits - (lev0 + 1) log_b)) out of
// v = digit_source(a), lifted mod p: canonical.
template <typename T>
__device__ __forceinline__ uint32_t lifted_digit(T v, int lev0, const DigitShape<T>& g, uint32_t p) {
    const uint32_t u = static_cast<uint32_t>(v >> ((g.l - 1 - lev0) * g.log_b)) & g.mask;
    return u - g.half_b + (u < g.half_b ? p : 0u);
}

// The 3 widest stages of the forward transforms of the l digit polynomials
// lev0, lev0 + split, ... of one accumulator component, for one task: v[j] =
// digit_source of the component's coefficient t0 | (j << (log_n - 3)); the
// results go to rows[lev * n] (swizzled).  Every task of this pass uses the
// same 7 twiddles `tw`.
template <typename T>
__device__ __forceinline__ void digit_task(uint32_t* rows, const T (&v)[8], int lev0, int split,
                                           const DigitShape<T>& g, int log_n, int t0,
                                           const Twiddles<3>& tw, uint32_t p) {
    const int n = 1 << log_n;
    const int s = log_n - 3;
    const int p0 = swz(t0);
    for (int lev = lev0; lev < g.l; lev += split) {
        uint32_t* row = rows + static_cast<size_t>(lev) * n;
        uint32_t e[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = lifted_digit(v[j], lev, g, p);
        butterflies<3, true>(e, tw, p, 2 * p);
#pragma unroll
        for (int j = 0; j < 8; ++j) row[p0 ^ swz(j << s)] = e[j];
    }
}

// First pass of the forward transform of the comps * l digit polynomials of
// the accumulator acc [comps, n] (T words, in shared or device memory;
// polynomial c * l + j: digit j of component c) into dig [comps * l, n]
// (swizzled): the 3 widest stages, on digits taken from the accumulator on
// the fly.  A thread reads its 8 accumulator words once and runs its share
// of the l digit polynomials over them.  Called by all threads behind a
// barrier after the last read of `dig`; the caller puts a barrier behind it.
template <typename T>
__device__ __forceinline__ void digits_first_pass(uint32_t* dig, const T* acc, int comps,
                                                  const DigitShape<T>& g, int log_n, int tid,
                                                  int nthreads, const uint32_t* __restrict__ w,
                                                  const uint32_t* __restrict__ w_sh, uint32_t p) {
    const int n = 1 << log_n;
    const int s = log_n - 3;
    const int items = comps << s;  // (component, task)
    const Twiddles<3> tw = load_twiddles<3>(1, w, w_sh);
    // where the threads outnumber the items they share an item's digits
    const int split = nthreads > items ? nthreads / items : 1;
    for (int it = tid; it < items * split; it += nthreads) {
        const int item = it & (items - 1);
        const int c = item >> s, t0 = item & ((1 << s) - 1);
        T v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = digit_source(acc[c * n + (t0 | (j << s))], g);
        digit_task(dig + static_cast<size_t>(c) * g.l * n, v, it / items, split, g, log_n, t0, tw, p);
    }
}

// One prime's twiddles in shared memory: tws [4, n] = psi table, its Shoup
// companion, psi^-1 table, its companion (n a multiple of 4, 16-byte aligned
// rows).  The passes read 2^R - 1 twiddle pairs per task; from shared memory
// they cost the binary sweep 4% less than from device memory through L1.
// Called by all threads; a barrier must follow before a pass reads them (the
// one behind the first pass does: it takes its 7 twiddles from device
// memory) and must lie behind the last pass that read the previous prime's.
__device__ __forceinline__ void stage_twiddles(uint32_t* tws, const uint32_t* __restrict__ f,
                                               const uint32_t* __restrict__ f_sh,
                                               const uint32_t* __restrict__ i,
                                               const uint32_t* __restrict__ i_sh, int n, int tid,
                                               int nthreads) {
    const uint32_t* src[4] = {f, f_sh, i, i_sh};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        const uint4* from = reinterpret_cast<const uint4*>(src[t]);
        uint4* to = reinterpret_cast<uint4*>(tws + static_cast<size_t>(t) * n);
        for (int j = tid; j < n / 4; j += nthreads) to[j] = from[j];
    }
}

// The passes of one transform of N = 2^log_n, log_n in 6..11, from the
// widest stage down: the top pass (3 stages, half-widths 2^(log_n - 1) ..
// 2^(log_n - 3)), the middle passes (stages 2^(log_n - 4) .. 4: 3 stages each
// and the rest, 1 or 2, as one pass ending at half-width 4) and the tail (the
// 2 narrowest stages, on 4 neighbouring words: one 16-byte access).  At
// N = 2048: 3 + 3 + 3 + 2 stages, at N = 1024: 3 + 3 + 2 + 2, at N = 512:
// 3 + 3 + 1 + 2.  The inverse runs the same passes backwards.  kLogN = 0
// takes log_n at run time (the generic kernels); otherwise the loops below
// unroll and every `s` is a constant.
constexpr int kMaxMiddle = 2;  // passes of 3 stages between top and tail

// The middle passes over `count` polynomials at `a` (swizzled), each behind
// a barrier; forward in [0, 4p) out [0, 4p), inverse in [0, 2p) out [0, 2p).
// Called by all threads behind a barrier.
template <int kLogN, bool kFwd>
__device__ __forceinline__ void middle_passes(uint32_t* a, int count, int log_n_rt, int tid,
                                              int nthreads, const uint32_t* __restrict__ w,
                                              const uint32_t* __restrict__ w_sh, uint32_t p) {
    const int log_n = kLogN ? kLogN : log_n_rt;
    const int m = log_n - 5;  // stages between the top pass and the tail
    const int full = m / 3, rest = m % 3;
    if (!kFwd) {
        if (rest == 2) radix_pass<2, false>(a, count, log_n, 2, tid, nthreads, w, w_sh, p);
        if (rest == 1) radix_pass<1, false>(a, count, log_n, 2, tid, nthreads, w, w_sh, p);
        if (rest != 0) __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < kMaxMiddle; ++k) {
        if (k < full) {
            // forward from the widest, inverse from the narrowest
            const int s = 2 + rest + 3 * (kFwd ? full - 1 - k : k);
            radix_pass<3, kFwd>(a, count, log_n, s, tid, nthreads, w, w_sh, p);
            __syncthreads();
        }
    }
    if (kFwd) {
        if (rest == 2) radix_pass<2, true>(a, count, log_n, 2, tid, nthreads, w, w_sh, p);
        if (rest == 1) radix_pass<1, true>(a, count, log_n, 2, tid, nthreads, w, w_sh, p);
        if (rest != 0) __syncthreads();
    }
}

// The rest of the forward negacyclic NTT (natural -> bit-reversed order, as
// ring/ntt.py:fwd_ntt) of `count` polynomials at `a` (swizzled) whose top
// pass is done (digits_first_pass): the middle passes and the tail, out in
// [0, 4p), see `canonical`.  Called by all threads behind a barrier; returns
// behind a barrier.
template <int kLogN>
__device__ __forceinline__ void fwd_ntt_passes(uint32_t* a, int count, int log_n_rt, int tid,
                                               int nthreads, const uint32_t* __restrict__ w,
                                               const uint32_t* __restrict__ w_sh, uint32_t p) {
    const int log_n = kLogN ? kLogN : log_n_rt;
    middle_passes<kLogN, true>(a, count, log_n, tid, nthreads, w, w_sh, p);
    radix_pass<2, true>(a, count, log_n, 0, tid, nthreads, w, w_sh, p);
    __syncthreads();
}

// Inverse of the whole forward transform in place (bit-reversed -> natural
// order), scaled by 1/N = (ninv, ninv_sh) in the top pass: in [0, 2p), out
// canonical.  w, w_sh: the psi^-1 table.  Same calling rules.
template <int kLogN>
__device__ __forceinline__ void inv_ntt_passes(uint32_t* a, int count, int log_n_rt, int tid,
                                               int nthreads, const uint32_t* __restrict__ w,
                                               const uint32_t* __restrict__ w_sh, uint32_t p,
                                               uint32_t ninv, uint32_t ninv_sh) {
    const int log_n = kLogN ? kLogN : log_n_rt;
    radix_pass<2, false>(a, count, log_n, 0, tid, nthreads, w, w_sh, p);
    __syncthreads();
    middle_passes<kLogN, false>(a, count, log_n, tid, nthreads, w, w_sh, p);
    radix_pass<3, false>(a, count, log_n, log_n - 3, tid, nthreads, w, w_sh, p, true, ninv, ninv_sh);
    __syncthreads();
}

constexpr int kMaxPrimes = 4;
// columns of the per-prime constants table (u64 [npr, kConstCols]):
// p, 1/N, shoup(1/N), floor(2^64 / p), then for j < 3 the Garner inverses
// p_j^{-1} mod p and their Shoup companions.
constexpr int kConstCols = 10;
constexpr int kColP = 0, kColNinv = 1, kColNinvSh = 2, kColMu = 3, kColGinv = 4, kColGinvSh = 7;

// Balanced representative mod 2^bits(T) of the residues r[q * stride], q < npr:
// Garner's mixed-radix digits, wrapping Horner evaluation, and minus
// prod(primes) (given mod 2^bits) when the last digit is in the upper half
// (ring/torus.py:from_crt_u32 / from_crt_u64).  The primes differ by less than
// 0.1%, so an earlier digit t_j < p_j is brought below p_i by one subtraction.
template <typename T>
__device__ __forceinline__ T garner(const uint32_t* r, int stride, int npr, const uint64_t* sc,
                                    T prod_mod) {
    uint32_t t[kMaxPrimes];
    t[0] = r[0];
#pragma unroll
    for (int i = 1; i < kMaxPrimes; ++i) {
        if (i < npr) {
            const uint64_t* ci = sc + i * kConstCols;
            const uint32_t p = static_cast<uint32_t>(ci[kColP]);
            uint32_t u = r[i * stride];
#pragma unroll
            for (int j = 0; j < i; ++j) {
                const uint32_t tj = t[j] >= p ? t[j] - p : t[j];
                u = shoup_mul(static_cast<uint32_t>(ci[kColGinv + j]),
                              static_cast<uint32_t>(ci[kColGinvSh + j]), sub_mod(u, tj, p), p);
            }
            t[i] = u;
        }
    }
    T x = 0;
    uint32_t last = 0;
#pragma unroll
    for (int i = kMaxPrimes - 1; i >= 0; --i) {
        if (i == npr - 1) {
            x = t[i];
            last = t[i];
        } else if (i < npr) {
            x = static_cast<T>(t[i] + static_cast<T>(sc[i * kConstCols + kColP]) * x);  // wrapping
        }
    }
    const uint32_t p_last = static_cast<uint32_t>(sc[(npr - 1) * kConstCols + kColP]);
    return last >= p_last / 2 ? static_cast<T>(x - prod_mod) : x;
}

}  // namespace mktfhe
