// Modular arithmetic and NTT butterflies over the 30-bit CRT primes, shared
// by the CUDA kernels of this package (ntt.cu, phase1_sweep.cu).
//
// Residues are canonical u32 values in [0, p) with p < 2^29.42, so 2p and 3p
// fit 32 bits.  The arithmetic mirrors mktfhe_tpu_torch/ring/modring.py bit
// for bit: the kernels and their plain PyTorch versions compute the same
// integers.

#pragma once

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
__device__ __forceinline__ void ct_butterfly(uint32_t* a, int iu, int iv, uint32_t w,
                                             uint32_t w_sh, uint32_t p) {
    const uint32_t u = a[iu];
    const uint32_t v = shoup_mul(w, w_sh, a[iv], p);
    a[iu] = add_mod(u, v, p);
    a[iv] = sub_mod(u, v, p);
}

// Gentleman-Sande butterfly of the inverse transform: (u, v) -> (u + v, w (u - v)).
__device__ __forceinline__ void gs_butterfly(uint32_t* a, int iu, int iv, uint32_t w,
                                             uint32_t w_sh, uint32_t p) {
    const uint32_t u = a[iu];
    const uint32_t v = a[iv];
    a[iu] = add_mod(u, v, p);
    a[iv] = shoup_mul(w, w_sh, sub_mod(u, v, p), p);
}

}  // namespace mktfhe
