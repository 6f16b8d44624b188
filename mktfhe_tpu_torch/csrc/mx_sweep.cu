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
//    bit-reversed order of fwd_ntt_shared inside the CTA, where position t
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
// Design.  One CTA per (gate, row), the loop over steps inside it, one launch
// per party, as phase1_sweep.cu.  Shared memory: the accumulator (16 N
// bytes), the 2l transformed digit polynomials of the current prime (8 l N),
// the inverse-transformed residues of every prime waiting for Garner
// (8 npr N) and the power table (8 npr N): 192 KB at KMS8party (N = 2048,
// l = 4, 3 primes).  N/2 threads; digits, stage loops and Garner come from
// modarith.cuh.
//
// The pointwise stage is a transposition: key rows want consecutive mx
// positions (k1 minor), the digits in shared memory sit nb words apart along
// k1.  A warp takes 2^(5 - c) consecutive k1 for each of 2^c values of k2'
// (c = kKeyLaneBits, at most log2 nb): its key loads cover whole 32-byte
// sectors while its digit reads spread over 2^c times as many banks as a
// plain walk of the positions would.
//
// What bounds it.  Integer arithmetic and shared-memory round trips, as the
// other sweep; the step's key rows (393 KB at KMS8party) are shared by all
// CTAs, which advance nearly in step, and come from L2.
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

constexpr int kLogNk = 7;       // log2 of the 128 positions along k1
constexpr int kKeyLaneBits = 2;  // a warp's key loads: 4 values of k2', 8 consecutive k1

struct MxShape {
    int rows, n_steps, npr, l, log_b, log_n;
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
template <bool kPowShared>
__global__ void __launch_bounds__(1024)
mx_sweep_kernel(uint64_t* __restrict__ acc_g, const int32_t* __restrict__ tildea,
                const uint32_t* __restrict__ brk, const uint32_t* __restrict__ pow_g,
                const uint32_t* __restrict__ tw_f, const uint32_t* __restrict__ tw_f_sh,
                const uint32_t* __restrict__ tw_i, const uint32_t* __restrict__ tw_i_sh,
                const uint64_t* __restrict__ consts, uint64_t prod_mod64, MxShape s) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ uint64_t sc[kMaxPrimes * kConstCols];

    const int n = 1 << s.log_n;
    const int nthreads = blockDim.x;  // n / 2
    const int tid = threadIdx.x;
    const int npr = s.npr, l = s.l, log_b = s.log_b, log_n = s.log_n;
    const int terms = 2 * l;
    const int log_nb = log_n - kLogNk;
    const int c = kKeyLaneBits < log_nb ? kKeyLaneBits : log_nb;

    uint64_t* acc = reinterpret_cast<uint64_t*>(smem);  // [2, n]
    uint32_t* dig = reinterpret_cast<uint32_t*>(acc + 2 * n);  // [2l, n]
    uint32_t* res = dig + static_cast<size_t>(terms) * n;  // [npr, 2, n]
    uint32_t* pow_s = res + static_cast<size_t>(npr) * 2 * n;  // [npr, 2n] if kPowShared

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

            // balanced gadget digits of both components, lifted mod p, and
            // their forward NTTs together
            for (int idx = tid; idx < 2 * n; idx += nthreads) {
                const int comp = idx >> log_n;
                const int i = idx & (n - 1);
                balanced_digits<uint64_t>(acc[idx], l, log_b, p,
                                          dig + static_cast<size_t>(comp) * l * n + i, n);
            }
            __syncthreads();
            fwd_ntt_shared(dig, terms, tid, log_n, tw_f + static_cast<size_t>(q) * n,
                           tw_f_sh + static_cast<size_t>(q) * n, p);

            // external product along the mx positions, times psi^(a o) - 1
            const uint32_t* key_q = brk + step * step_stride + q * prime_stride;
            const uint32_t* pw_q = pw + static_cast<size_t>(q) * 2 * n;
            uint32_t* out = res + static_cast<size_t>(q) * 2 * n;
            for (int w = tid; w < n; w += nthreads) {
                const int lane = w & 31, blk = w >> 5;
                const int k1 = (lane & ((32 >> c) - 1)) | ((blk & ((4 << c) - 1)) << (5 - c));
                const int k2 = (lane >> (5 - c)) | ((blk >> (2 + c)) << c);
                const int pos = (k2 << kLogNk) | k1;
                const int t = static_cast<int>(bitrev(k1, kLogNk) << log_nb) | k2;
                const uint32_t* key = key_q + pos;
                uint64_t s0 = 0, s1 = 0;
                for (int j = 0; j < terms; ++j) {
                    const uint64_t d = dig[j * n + t];
                    s0 += d * key[(2 * j) * n];
                    s1 += d * key[(2 * j + 1) * n];
                }
                const uint32_t o = 2 * bitrev(t, log_n) + 1;
                const uint64_t mon = sub_mod(pw_q[(a * o) & (2 * n - 1)], 1u, p);
                out[t] = barrett_reduce(barrett_reduce(s0, mu, p) * mon, mu, p);
                out[n + t] = barrett_reduce(barrett_reduce(s1, mu, p) * mon, mu, p);
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

        // Garner mod 2^64 and accumulate
        for (int idx = tid; idx < 2 * n; idx += nthreads) {
            acc[idx] += garner<uint64_t>(res + idx, 2 * n, npr, sc, prod_mod64);
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

}  // namespace

// The power table goes to shared memory when it fits beside the CTA's state.
extern "C" int mktfhe_mx_sweep(void* acc, const void* tildea, const void* brk, const void* pow,
                               const void* tw_f, const void* tw_f_sh, const void* tw_i,
                               const void* tw_i_sh, const void* consts,
                               unsigned long long prod_mod64, long long ctas, int rows,
                               int n_steps, int npr, int l, int log_b, int log_n, void* stream) {
    const MxShape shape{rows, n_steps, npr, l, log_b, log_n};
    const int n = 1 << log_n;
    size_t smem = state_bytes(n, npr, l);
    const bool pow_shared = smem + table_bytes(n, npr) <= kMaxDynamicShared;
    if (pow_shared) smem += table_bytes(n, npr);
    decltype(&mx_sweep_kernel<true>) kernel =
        pow_shared ? &mx_sweep_kernel<true> : &mx_sweep_kernel<false>;
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid(static_cast<unsigned int>(ctas));
    const dim3 block(n / 2);
    kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t*>(acc), static_cast<const int32_t*>(tildea),
        static_cast<const uint32_t*>(brk), static_cast<const uint32_t*>(pow),
        static_cast<const uint32_t*>(tw_f), static_cast<const uint32_t*>(tw_f_sh),
        static_cast<const uint32_t*>(tw_i), static_cast<const uint32_t*>(tw_i_sh),
        static_cast<const uint64_t*>(consts), prod_mod64, shape);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mktfhe_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
