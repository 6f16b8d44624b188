// Natural-layout negacyclic NTT over the CRT primes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mktfhe_tpu/kernels/ntt_pallas.py:_nat_call
// (entry points fwd_ntt_nat / inv_ntt_nat), which runs every NTT of the KMS
// bootstrap on its pallas_ntt=True path.  The arithmetic is the reference's
// plain transform (mktfhe_tpu/ring/ntt.py, twin: mktfhe_tpu_torch/ring/ntt.py):
// merged-twist Cooley-Tukey forward (natural -> bit-reversed order) and
// Gentleman-Sande inverse with 1/N folded in, twiddles from the bit-reversed
// psi tables with Shoup companions.  Output is canonical [0, p) and
// bit-identical to the twin.  The TPU kernel's per-position roll/select stage
// tables exist only for the TPU's lane layout and are not used here.
//
// Design: one CTA per (row, prime) polynomial, held in shared memory
// (N u32: 8 KB at N = 2048); one thread per butterfly (N/2 threads); all
// log2 N stages in one launch with __syncthreads() between stages.  Shoup
// multiplication uses __umulhi.
//
// What bounds it: each stage is a shared-memory round trip (two loads, two
// stores per thread) plus one Shoup modmul (three 32-bit multiplies), so it
// is bound by shared-memory bandwidth and modmul throughput, not by device
// memory (each polynomial is read and written once).  Making it fast is
// later work: several polynomials per CTA, register-resident radix-4 stages
// with warp shuffles for the short strides, and twiddles staged in shared
// memory.
//
// Built by mktfhe_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (wrapper: kernels/ntt.py); the C entry point
// returns cudaGetLastError().  The modular arithmetic and the butterflies are
// in modarith.cuh, shared with phase1_sweep.cu.

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

using namespace mktfhe;

// x, y: [polys, n] with polys = rows * npr, prime index = poly % npr.
// tw, tw_sh: [npr, n] (psi_brv for forward, ipsi_brv for inverse).
// consts: [npr, 3] = (p, n_inv, n_inv_shoup).
template <bool kForward>
__global__ void ntt_nat_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                               const uint32_t* __restrict__ tw,
                               const uint32_t* __restrict__ tw_sh,
                               const uint32_t* __restrict__ consts, int npr, int log_n) {
    extern __shared__ uint32_t a[];
    const int n = 1 << log_n;
    const long long poly = blockIdx.x;
    const int q = static_cast<int>(poly % npr);
    const uint32_t p = consts[3 * q];
    const uint32_t* w = tw + static_cast<long long>(q) * n;
    const uint32_t* w_sh = tw_sh + static_cast<long long>(q) * n;
    const uint32_t* src = x + poly * n;
    uint32_t* dst = y + poly * n;

    const int j = threadIdx.x;  // butterfly index in [0, n/2)
    a[j] = src[j];
    a[j + n / 2] = src[j + n / 2];
    __syncthreads();

    if (kForward) {
        // stage with half-width t = 2^log_t pairs a[u], a[u + t] in m blocks
        for (int log_t = log_n - 1, m = 1; log_t >= 0; --log_t, m <<= 1) {
            const int blk = j >> log_t;
            const int iu = butterfly_index(j, log_t);
            ct_butterfly(a, iu, iu + (1 << log_t), w[m + blk], w_sh[m + blk], p);
            __syncthreads();
        }
        dst[j] = a[j];
        dst[j + n / 2] = a[j + n / 2];
    } else {
        for (int log_t = 0, h = n / 2; log_t < log_n; ++log_t, h >>= 1) {
            const int blk = j >> log_t;
            const int iu = butterfly_index(j, log_t);
            gs_butterfly(a, iu, iu + (1 << log_t), w[h + blk], w_sh[h + blk], p);
            __syncthreads();
        }
        const uint32_t ninv = consts[3 * q + 1];
        const uint32_t ninv_sh = consts[3 * q + 2];
        dst[j] = shoup_mul(ninv, ninv_sh, a[j], p);
        dst[j + n / 2] = shoup_mul(ninv, ninv_sh, a[j + n / 2], p);
    }
}

}  // namespace

extern "C" int mktfhe_ntt_nat(const void* x, void* y, const void* tw, const void* tw_sh,
                              const void* consts, long long polys, int npr, int log_n,
                              int forward, void* stream) {
    const int n = 1 << log_n;
    const dim3 grid(static_cast<unsigned int>(polys));
    const dim3 block(n / 2);
    const size_t smem = static_cast<size_t>(n) * sizeof(uint32_t);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* xi = static_cast<const uint32_t*>(x);
    auto* yo = static_cast<uint32_t*>(y);
    const auto* t = static_cast<const uint32_t*>(tw);
    const auto* ts = static_cast<const uint32_t*>(tw_sh);
    const auto* c = static_cast<const uint32_t*>(consts);
    if (forward) {
        ntt_nat_kernel<true><<<grid, block, smem, s>>>(xi, yo, t, ts, c, npr, log_n);
    } else {
        ntt_nat_kernel<false><<<grid, block, smem, s>>>(xi, yo, t, ts, c, npr, log_n);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mktfhe_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
