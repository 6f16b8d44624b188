// Negacyclic NTT over the CRT primes for Hopper (sm_90a), in two memory
// layouts: natural [rows, npr, N] and batch-minor [npr, R, N, G].
//
// Replaces two Pallas TPU kernels of mktfhe_tpu/kernels/ntt_pallas.py:
//   _nat_call  (entry points fwd_ntt_nat / inv_ntt_nat), which runs every NTT
//              of the KMS bootstrap on its pallas_ntt=True path, and
//   _make_call (entry points fwd_ntt_pallas / inv_ntt_pallas), the transform
//              of the batch-minor engine (kernels/batchminor.py), whose data
//              keeps the gate batch G as the minor axis.
// The arithmetic of both is the reference's plain transform
// (mktfhe_tpu/ring/ntt.py, twin: mktfhe_tpu_torch/ring/ntt.py): merged-twist
// Cooley-Tukey forward (natural -> bit-reversed order) and Gentleman-Sande
// inverse with 1/N folded in, twiddles from the bit-reversed psi tables with
// Shoup companions.  Output is canonical [0, p) and bit-identical to the twin.
// The TPU kernels' per-position roll/select stage tables exist only for the
// TPU's lane layout and are not used here.
//
// Natural layout: one CTA per (row, prime) polynomial, held in shared memory
// (N u32: 8 KB at N = 2048); one thread per butterfly (N/2 threads); all
// log2 N stages in one launch with __syncthreads() between stages.
//
// Batch-minor layout: one CTA per (prime, row, tile of kGt = 8 gates).  The
// kernel reads and writes [npr, R, N, G] memory itself: the [N, 8] tile is
// copied to shared memory as it lies (rows of 8 consecutive gates, 32-byte
// segments of device memory; the last tile of a batch may hold fewer gates,
// its missing columns are zero and are not written back).  Thread j does
// butterfly j of all 8 gates of the tile at once: it reads the two tile rows
// as four 16-byte vectors (consecutive threads, consecutive rows: no bank
// conflict), so the 8 gates share one twiddle load and one barrier per stage.
// Shared memory: 32 N bytes (64 KB at N = 2048, hence the opt-in above 48 KB).
//
// What bounds them: each stage is a shared-memory round trip (two loads, two
// stores per residue pair) plus one Shoup modmul (three 32-bit multiplies),
// so they are bound by shared-memory bandwidth and modmul throughput, not by
// device memory (each residue is read and written once).  Making them fast is
// later work: register-resident radix-4 stages with warp shuffles for the
// short strides, twiddles staged in shared memory, wider gate tiles.
//
// Built by mktfhe_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (wrapper: kernels/ntt.py); the C entry points
// return the first CUDA error of the attribute call or the launch.  The
// modular arithmetic and the stage loops are in modarith.cuh, shared with
// phase1_sweep.cu and cggi_step.cu.

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
    extern __shared__ __align__(16) uint32_t a[];
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
        fwd_ntt_shared(a, 1, j, log_n, w, w_sh, p);
        dst[j] = a[j];
        dst[j + n / 2] = a[j + n / 2];
    } else {
        inv_ntt_shared(a, 1, j, log_n, w, w_sh, p);
        const uint32_t ninv = consts[3 * q + 1];
        const uint32_t ninv_sh = consts[3 * q + 2];
        dst[j] = shoup_mul(ninv, ninv_sh, a[j], p);
        dst[j + n / 2] = shoup_mul(ninv, ninv_sh, a[j + n / 2], p);
    }
}

constexpr int kGt = 8;  // gates per tile of the batch-minor kernel: two uint4 per tile row

// One butterfly on each of the kGt gates of tile rows iu and iv.
template <bool kForward>
__device__ __forceinline__ void tile_butterfly(uint32_t* a, int iu, int iv, uint32_t w,
                                               uint32_t w_sh, uint32_t p) {
    uint4* ru = reinterpret_cast<uint4*>(a + iu * kGt);
    uint4* rv = reinterpret_cast<uint4*>(a + iv * kGt);
#pragma unroll
    for (int h = 0; h < kGt / 4; ++h) {
        uint4 u = ru[h];
        uint4 v = rv[h];
        if (kForward) {
            ct_pair(u.x, v.x, w, w_sh, p);
            ct_pair(u.y, v.y, w, w_sh, p);
            ct_pair(u.z, v.z, w, w_sh, p);
            ct_pair(u.w, v.w, w, w_sh, p);
        } else {
            gs_pair(u.x, v.x, w, w_sh, p);
            gs_pair(u.y, v.y, w, w_sh, p);
            gs_pair(u.z, v.z, w, w_sh, p);
            gs_pair(u.w, v.w, w, w_sh, p);
        }
        ru[h] = u;
        rv[h] = v;
    }
}

// x, y: [npr, rows, n, gates] with the gate index minor; one CTA per
// (prime, row, gate tile), cta = (prime * rows + row) * tiles + tile.
// tw, tw_sh, consts as above.
template <bool kForward>
__global__ void ntt_bm_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                              const uint32_t* __restrict__ tw,
                              const uint32_t* __restrict__ tw_sh,
                              const uint32_t* __restrict__ consts, int rows, int gates,
                              int log_n) {
    extern __shared__ __align__(16) uint32_t a[];  // the tile, [n, kGt]
    const int n = 1 << log_n;
    const int nthreads = blockDim.x;  // n / 2
    const int tid = threadIdx.x;
    const int tiles = (gates + kGt - 1) / kGt;
    const long long cta = blockIdx.x;
    const int tile = static_cast<int>(cta % tiles);
    const long long poly = cta / tiles;  // prime * rows + row
    const int q = static_cast<int>(poly / rows);
    const uint32_t p = consts[3 * q];
    const uint32_t* w = tw + static_cast<long long>(q) * n;
    const uint32_t* w_sh = tw_sh + static_cast<long long>(q) * n;
    const int g0 = tile * kGt;
    const int valid = gates - g0 < kGt ? gates - g0 : kGt;  // the last tile may be ragged
    const long long base = poly * n * gates + g0;

    for (int idx = tid; idx < n * kGt; idx += nthreads) {
        const int i = idx / kGt;
        const int g = idx % kGt;
        a[idx] = g < valid ? x[base + static_cast<long long>(i) * gates + g] : 0u;
    }
    __syncthreads();

    if (kForward) {
        for (int log_t = log_n - 1, m = 1; log_t >= 0; --log_t, m <<= 1) {
            const int blk = tid >> log_t;
            const int iu = butterfly_index(tid, log_t);
            tile_butterfly<true>(a, iu, iu + (1 << log_t), w[m + blk], w_sh[m + blk], p);
            __syncthreads();
        }
    } else {
        for (int log_t = 0, h = n / 2; log_t < log_n; ++log_t, h >>= 1) {
            const int blk = tid >> log_t;
            const int iu = butterfly_index(tid, log_t);
            tile_butterfly<false>(a, iu, iu + (1 << log_t), w[h + blk], w_sh[h + blk], p);
            __syncthreads();
        }
    }

    const uint32_t ninv = consts[3 * q + 1];
    const uint32_t ninv_sh = consts[3 * q + 2];
    for (int idx = tid; idx < n * kGt; idx += nthreads) {
        const int i = idx / kGt;
        const int g = idx % kGt;
        if (g < valid) {
            y[base + static_cast<long long>(i) * gates + g] =
                kForward ? a[idx] : shoup_mul(ninv, ninv_sh, a[idx], p);
        }
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

// x, y: [npr, rows, 2^log_n, gates] u32, any gates >= 1.
extern "C" int mktfhe_ntt_bm(const void* x, void* y, const void* tw, const void* tw_sh,
                             const void* consts, int npr, int rows, int gates, int log_n,
                             int forward, void* stream) {
    const int n = 1 << log_n;
    const long long tiles = (gates + kGt - 1) / kGt;
    const long long ctas = static_cast<long long>(npr) * rows * tiles;
    const int smem = n * kGt * static_cast<int>(sizeof(uint32_t));
    decltype(&ntt_bm_kernel<true>) kernel = forward ? &ntt_bm_kernel<true> : &ntt_bm_kernel<false>;
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    kernel<<<dim3(static_cast<unsigned int>(ctas)), dim3(n / 2), smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
        static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(tw_sh),
        static_cast<const uint32_t*>(consts), rows, gates, log_n);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mktfhe_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
