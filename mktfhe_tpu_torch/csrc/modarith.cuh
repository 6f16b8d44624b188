// Modular arithmetic, NTT butterflies and stage loops, gadget digits and
// Garner reconstruction over the 30-bit CRT primes, shared by the CUDA kernels
// of this package (ntt.cu, phase1_sweep.cu, cggi_step.cu).
//
// Residues are canonical u32 values in [0, p) with p < 2^29.42, so 2p and 3p
// fit 32 bits.  The arithmetic mirrors mktfhe_tpu_torch/ring/modring.py,
// ring/torus.py and ciphertext/decomp.py bit for bit: the kernels and their
// plain PyTorch versions compute the same integers.

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

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t p) {
    const uint32_t s = a + b;
    return s >= p ? s - p : s;
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

// Index of the upper element of butterfly j in [0, n/2) at half-width 2^log_t;
// its partner is 2^log_t further on.
__device__ __forceinline__ int butterfly_index(int j, int log_t) {
    return ((j >> log_t) << (log_t + 1)) + (j & ((1 << log_t) - 1));
}

// Cooley-Tukey butterfly of the forward transform: (u, v) -> (u + w v, u - w v).
// u and v are read once into registers before either is written: they are
// references into shared memory, which the compiler must take to alias.
__device__ __forceinline__ void ct_pair(uint32_t& u, uint32_t& v, uint32_t w, uint32_t w_sh,
                                        uint32_t p) {
    const uint32_t u0 = u;
    const uint32_t t = shoup_mul(w, w_sh, v, p);
    u = add_mod(u0, t, p);
    v = sub_mod(u0, t, p);
}

// Gentleman-Sande butterfly of the inverse transform: (u, v) -> (u + v, w (u - v)).
__device__ __forceinline__ void gs_pair(uint32_t& u, uint32_t& v, uint32_t w, uint32_t w_sh,
                                        uint32_t p) {
    const uint32_t u0 = u;
    const uint32_t v0 = v;
    u = add_mod(u0, v0, p);
    v = shoup_mul(w, w_sh, sub_mod(u0, v0, p), p);
}

// Forward negacyclic NTT (natural -> bit-reversed order, as ring/ntt.py:fwd_ntt)
// of `count` polynomials of n = 2^log_n residues that lie one after the other
// in shared memory at `a`.  Called by all n/2 threads of the CTA (tid = the
// thread's butterfly), after a barrier behind the last write to `a`; returns
// behind a barrier.  The polynomials advance together, so they share each
// stage's twiddle load and barrier.  w, w_sh: this prime's bit-reversed psi
// table and its Shoup companion.
__device__ __forceinline__ void fwd_ntt_shared(uint32_t* a, int count, int tid, int log_n,
                                               const uint32_t* __restrict__ w,
                                               const uint32_t* __restrict__ w_sh, uint32_t p) {
    const int n = 1 << log_n;
    // stage with half-width t = 2^log_t pairs a[u], a[u + t] in m blocks
    for (int log_t = log_n - 1, m = 1; log_t >= 0; --log_t, m <<= 1) {
        const int blk = tid >> log_t;
        const int iu = butterfly_index(tid, log_t);
        const int iv = iu + (1 << log_t);
        const uint32_t tw = w[m + blk];
        const uint32_t tw_sh = w_sh[m + blk];
        for (int t = 0; t < count; ++t) ct_pair(a[t * n + iu], a[t * n + iv], tw, tw_sh, p);
        __syncthreads();
    }
}

// Inverse of fwd_ntt_shared (bit-reversed -> natural order) WITHOUT the final
// scaling by 1/N; w, w_sh: the psi^-1 table.  Same calling rules.
__device__ __forceinline__ void inv_ntt_shared(uint32_t* a, int count, int tid, int log_n,
                                               const uint32_t* __restrict__ w,
                                               const uint32_t* __restrict__ w_sh, uint32_t p) {
    const int n = 1 << log_n;
    for (int log_t = 0, h = n / 2; log_t < log_n; ++log_t, h >>= 1) {
        const int blk = tid >> log_t;
        const int iu = butterfly_index(tid, log_t);
        const int iv = iu + (1 << log_t);
        const uint32_t tw = w[h + blk];
        const uint32_t tw_sh = w_sh[h + blk];
        for (int t = 0; t < count; ++t) gs_pair(a[t * n + iu], a[t * n + iv], tw, tw_sh, p);
        __syncthreads();
    }
}

// Balanced gadget digits of the torus value a (T = uint32_t or uint64_t),
// lifted mod p, digit j written to d[j * stride]: digit j belongs to the
// gadget entry 2^(bits - (j+1) log_b), lies in [-B/2, B/2), and the top carry
// wraps away (ciphertext/decomp.py:balanced_decomp).  Where l log_b < bits the
// value is first rounded to l log_b bits.
template <typename T>
__device__ __forceinline__ void balanced_digits(T a, int l, int log_b, uint32_t p, uint32_t* d,
                                                size_t stride) {
    const int low = static_cast<int>(8 * sizeof(T)) - l * log_b;
    const uint32_t mask = (1u << log_b) - 1;
    const uint32_t half_b = 1u << (log_b - 1);
    T ai = low > 0 ? static_cast<T>((a >> low) + ((a >> (low - 1)) & 1)) : a;
    for (int lev = l; lev >= 1; --lev) {
        const uint32_t dgt = static_cast<uint32_t>(ai) & mask;
        ai = static_cast<T>((ai >> log_b) + (dgt >> (log_b - 1)));
        // signed digit dgt - B when its top bit is set; lifted: p + it
        d[static_cast<size_t>(lev - 1) * stride] = (dgt & half_b) ? p + dgt - 2 * half_b : dgt;
    }
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
