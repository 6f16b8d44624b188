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
// Natural layout: bound by device memory (every residue read and written
// once: 201 MB at [3072, 4, 2048]), so the design keeps memory busy and the
// arithmetic off its way.  A CTA of 256 threads takes tiles of 2048 words --
// 2048 / N polynomials of one prime -- one after the other (a grid of as
// many CTAs as the card holds at once), and copies the next tile into the
// second of two shared-memory buffers with cp.async while it transforms the
// current one.  N/8 threads serve a polynomial; the transform is the
// register-resident passes of modarith.cuh (lazy butterflies, 4 passes at
// N = 1024 and 2048, swizzled rows), with log2 N a template argument (an
// instance for each N the wrapper admits, nat_plan below).  The loads are
// 16-byte chunks into the swizzled layout; the forward's tail pass stores
// its 4 neighbouring words straight from registers as one coalesced 16-byte
// vector; the inverse's top pass scales by 1/N and stores its 8 words, each
// a coalesced 128-byte line of a warp.
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
// Each stage is a shared-memory round trip plus one Shoup modmul, so it is
// bound by shared-memory bandwidth and modmul throughput, not by device
// memory.
//
// Built by mktfhe_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (wrapper: kernels/ntt.py); the C entry points
// return the first CUDA error of the attribute call or the launch.  The
// modular arithmetic and the passes are in modarith.cuh, shared with
// phase1_sweep.cu, mx_sweep.cu and cggi_step.cu.

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

using namespace mktfhe;

constexpr int kNatThreads = 256;
constexpr int kTileWords = 2048;  // words of a tile: one polynomial at N = 2048
constexpr int kNatBuffers = 2;  // tiles in shared memory: one transformed, one arriving

// 16 bytes from device memory to shared memory without a trip through
// registers, completed by cp_async_wait.  (The host build of the device
// code, mktfhe_tpu_torch/tools/host_kernels.py, copies at once.)
__device__ __forceinline__ void cp_async_16(uint32_t* smem_dst, const uint32_t* gmem_src) {
#ifdef __CUDA_ARCH__
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src) : "memory");
#else
    *reinterpret_cast<uint4*>(smem_dst) = *reinterpret_cast<const uint4*>(gmem_src);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait until at most `kPending` groups of this thread's copies are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
#endif
}

// x, y: [rows, npr, n] (polynomial = row * npr + prime); tw, tw_sh: [npr, n]
// (psi_brv for forward, ipsi_brv for inverse); consts: [npr, 3] = (p, n_inv,
// n_inv_shoup).  Tile t holds the rows (t / npr) * kPolys .. + kPolys - 1 of
// prime t % npr (fewer at the end of the rows).  rows * npr < 2^31 (the
// wrapper checks it), so 32-bit indices.
template <int kLogN, bool kFwd>
__global__ void __launch_bounds__(kNatThreads)
ntt_nat_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
               const uint32_t* __restrict__ tw, const uint32_t* __restrict__ tw_sh,
               const uint32_t* __restrict__ consts, int rows, int npr) {
    extern __shared__ __align__(16) uint32_t a[];  // [kNatBuffers, kTileWords]: a ring of tiles
    constexpr int n = 1 << kLogN;
    constexpr int kPolys = kTileWords / n;
    constexpr int top = kLogN - 3;
    const int tid = threadIdx.x;
    const int tiles = (rows + kPolys - 1) / kPolys * npr;
    const size_t poly_stride = static_cast<size_t>(npr) * n;
    int t = blockIdx.x;
    if (t >= tiles) return;

    // tile tt into buffer `slot`; one commit group each, empty past the last
    // tile, so that a thread's groups and the tiles stay in step
    auto load = [&](int tt, int slot) {
        if (tt < tiles) {
            const int r0 = tt / npr * kPolys;
            const int count = min(rows - r0, kPolys);
            const uint32_t* src = x + (static_cast<size_t>(r0) * npr + (tt - r0 / kPolys * npr)) * n;
            uint32_t* buf = a + slot * kTileWords;
            for (int ch = tid; ch < count * (n / 4); ch += kNatThreads) {
                const int k = ch >> (kLogN - 2), w = 4 * (ch & (n / 4 - 1));
                cp_async_16(buf + k * n + swz(w), src + k * poly_stride + w);
            }
        }
        cp_async_commit();
    };

#pragma unroll
    for (int k = 0; k + 1 < kNatBuffers; ++k) load(t + k * gridDim.x, k);
    for (int it = 0; t < tiles; ++it, t += gridDim.x) {
        // the tile kNatBuffers - 1 rounds ahead, into the buffer of the
        // previous round (behind its closing barrier)
        load(t + (kNatBuffers - 1) * gridDim.x, (it + kNatBuffers - 1) % kNatBuffers);
        cp_async_wait<kNatBuffers - 1>();  // this round's tile has landed
        __syncthreads();
        uint32_t* buf = a + (it % kNatBuffers) * kTileWords;

        const int r0 = t / npr * kPolys;
        const int q = t - r0 / kPolys * npr;
        const int count = min(rows - r0, kPolys);
        const uint32_t p = consts[3 * q];
        const uint32_t* w = tw + q * n;
        const uint32_t* w_sh = tw_sh + q * n;
        uint32_t* dst = y + (static_cast<size_t>(r0) * npr + q) * n;
        if (kFwd) {
            radix_pass<3, true>(buf, count, kLogN, top, tid, kNatThreads, w, w_sh, p);
            __syncthreads();
            middle_passes<kLogN, true>(buf, count, kLogN, tid, kNatThreads, w, w_sh, p);
            // the tail, canonical, straight to device memory
            for (int idx = tid; idx < count * (n / 4); idx += kNatThreads) {
                const int k = idx >> (kLogN - 2), i = idx & (n / 4 - 1);
                const Twiddles<2> tw2 = load_twiddles<2>(n / 4 + i, w, w_sh);
                const uint4 v = *reinterpret_cast<const uint4*>(buf + k * n + swz(4 * i));
                uint32_t e[4] = {v.x, v.y, v.z, v.w};
                butterflies<2, true>(e, tw2, p, 2 * p);
                *reinterpret_cast<uint4*>(dst + k * poly_stride + 4 * i) =
                    make_uint4(canonical(e[0], p), canonical(e[1], p), canonical(e[2], p),
                               canonical(e[3], p));
            }
        } else {
            radix_pass<2, false>(buf, count, kLogN, 0, tid, kNatThreads, w, w_sh, p);
            __syncthreads();
            middle_passes<kLogN, false>(buf, count, kLogN, tid, kNatThreads, w, w_sh, p);
            // the top pass scaled by 1/N, straight to device memory
            const uint32_t ninv = consts[3 * q + 1];
            const uint32_t ninv_sh = consts[3 * q + 2];
            const Twiddles<3> tw3 = load_twiddles<3>(1, w, w_sh);
            for (int idx = tid; idx < count * (n / 8); idx += kNatThreads) {
                const int k = idx >> top, t0 = idx & (n / 8 - 1);
                const uint32_t* row = buf + k * n;
                const int p0 = swz(t0);
                uint32_t e[8];
#pragma unroll
                for (int j = 0; j < 8; ++j) e[j] = row[p0 ^ swz(j << top)];
                butterflies<3, false>(e, tw3, p, 2 * p);
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    dst[k * poly_stride + (t0 | (j << top))] = shoup_mul(ninv, ninv_sh, e[j], p);
                }
            }
        }
        __syncthreads();  // the buffer is refilled in the next round
    }
}

using NatKernel = decltype(&ntt_nat_kernel<11, true>);

// The one place that decides which kernel serves a transform: the instance
// for its log2 N (every N the wrapper admits, 64 .. 2048) and direction.
struct NatPlan {
    NatKernel kernel;
    int log_n, threads, polys_per_tile, shared_bytes;
};

template <int kLogN>
inline NatPlan nat_with(bool forward) {
    return {forward ? &ntt_nat_kernel<kLogN, true> : &ntt_nat_kernel<kLogN, false>, kLogN,
            kNatThreads, kTileWords >> kLogN, kNatBuffers * kTileWords * static_cast<int>(sizeof(uint32_t))};
}

inline NatPlan nat_plan(int log_n, bool forward) {
    switch (log_n) {
        case 6: return nat_with<6>(forward);
        case 7: return nat_with<7>(forward);
        case 8: return nat_with<8>(forward);
        case 9: return nat_with<9>(forward);
        case 10: return nat_with<10>(forward);
        case 11: return nat_with<11>(forward);
        default: return {nullptr, 0, 0, 0, 0};
    }
}

// What `nat_plan` says: out[0] the instance's log2 N (0: none), out[1]
// threads per CTA, out[2] polynomials per tile, out[3] dynamic shared bytes.
inline void describe_nat(int log_n, int forward, int* out) {
    const NatPlan plan = nat_plan(log_n, forward != 0);
    out[0] = plan.log_n;
    out[1] = plan.threads;
    out[2] = plan.polys_per_tile;
    out[3] = plan.shared_bytes;
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

// x, y: [polys, 2^log_n] u32 with polys = rows * npr.  The grid holds as
// many CTAs as the card runs at once, or one per tile where there are fewer.
extern "C" int mktfhe_ntt_nat(const void* x, void* y, const void* tw, const void* tw_sh,
                              const void* consts, long long polys, int npr, int log_n,
                              int forward, void* stream) {
    const NatPlan plan = nat_plan(log_n, forward != 0);
    if (plan.kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, plan.kernel, plan.threads,
                                                            plan.shared_bytes);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const int rows = static_cast<int>(polys / npr);
    const long long tiles = (rows + plan.polys_per_tile - 1) / plan.polys_per_tile * npr;
    const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    const long long ctas = tiles < resident ? tiles : resident;
    plan.kernel<<<dim3(static_cast<unsigned int>(ctas)), dim3(plan.threads), plan.shared_bytes,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
        static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(tw_sh),
        static_cast<const uint32_t*>(consts), rows, npr);
    return static_cast<int>(cudaGetLastError());
}

extern "C" void mktfhe_ntt_nat_describe(int log_n, int forward, int* out) {
    describe_nat(log_n, forward, out);
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
