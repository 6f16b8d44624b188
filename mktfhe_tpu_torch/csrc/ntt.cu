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
// Batch-minor layout: bound by device memory too (each residue read and
// written once; 151 MB at [3, 24, 2048, 128], the digit transforms of
// kms.bootstrap_bm), with the butterflies at about four fifths of the
// bytes' time, and its data lie in short row segments: a tile of kGt
// consecutive gates of one (prime, row) is [N, kGt] words, a row of kGt
// words at a stride of G words.  Stores of such 16- or 32-byte pieces (one
// sector of a 128-byte line per row) cost the first version of this design
// two thirds of its time, the copies in much less.  So the CTAs that hold
// the 32 gates of a line (4 tiles of 8 or 8 of 4) form a thread-block
// cluster: each transforms its own tile, then each stores a quarter (an
// eighth) of the rows as whole lines, read from the cluster's buffers
// through distributed shared memory.  The rest is the natural kernel's
// design: a cluster takes line tiles one after the other (a grid of as
// many clusters as the card holds at once), each CTA copying its part of
// the next one into the second of two shared-memory buffers with cp.async
// (16-byte chunks where rows are 16-byte aligned, G % 4 == 0, else words)
// while it transforms the current one; at N = 2048 six CTAs of 128 threads
// with one buffer each share an SM and overlap each other's copies instead
// (7% quicker than three of 256 with two).  A thread holds 8 coefficients of 4
// gates, one 16-byte quad each, in registers, and runs modarith.cuh's plan
// of radix-8 passes (4 passes and 4 barriers at N = 1024 and 2048; lazy
// butterflies, once a gate, on twiddles kept in registers for the 4 gates);
// every shared access is 16 bytes, through an XOR swizzle of the quads
// (`bm_swz`) under which no pass meets a bank conflict.  The last pass
// leaves the forward canonical and scales the inverse by 1/N.  log2 N and
// kGt are template arguments; `bm_plan` takes tiles of 4 gates, of 8 at
// N <= 1024 where 4 CTAs a line tile fill the card twice over, and drops
// the cluster where each CTA would take one tile anyway (the small
// inverses): there the last pass stores its 16-byte quads itself, which is
// quicker than the cluster's barriers.  A batch that is no multiple of 32
// leaves CTAs with no gate or a ragged tile: their missing columns are
// transformed on stale words and never stored.
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
// registers, completed by cp_async_wait; on a miss the L2 fetches the whole
// 128-byte line (the batch-minor kernel's CTAs copy 16- or 32-byte pieces
// of each line; 2% on its time, none on the natural kernel's).  (The host
// build of the device code, mktfhe_tpu_torch/tools/host_kernels.py, copies
// at once.)
__device__ __forceinline__ void cp_async_16(uint32_t* smem_dst, const uint32_t* gmem_src) {
#ifdef __CUDA_ARCH__
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src) : "memory");
#else
    *reinterpret_cast<uint4*>(smem_dst) = *reinterpret_cast<const uint4*>(gmem_src);
#endif
}

// 4 bytes the same way (rows whose words are not 16-byte aligned).
__device__ __forceinline__ void cp_async_4(uint32_t* smem_dst, const uint32_t* gmem_src) {
#ifdef __CUDA_ARCH__
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem_src) : "memory");
#else
    *smem_dst = *gmem_src;
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

// ---------------------------------------------------------------------------
// The batch-minor kernel.  A tile is kGt consecutive gates of one (prime,
// row): [n, kGt] words, kQ = kGt / 4 16-byte quads a coefficient.  In shared
// memory it lies as n * kQ quads, quad a = coefficient * kQ + quad of the
// coefficient, at bm_swz(a).

// Where quad a of a tile lies.  XOR-linear and a bijection (bits 0-2 are
// XORed with a function of bits 3-5, everything above bit 2 stays).  A
// 16-byte access is served a quarter-warp at a time, so 8 threads with
// consecutive items (item = task * kQ + quad) must meet the 8 bank groups
// (bits 0-2 of the quad position) once each.  Across such 8 threads the
// quad (log2 kQ = q bits, bits 0 .. q-1 of a) and the low 3 - q bits of the
// task vary; task bit b lies at coefficient bit b where b < s and at bit
// b + R where b >= s (a pass of R stages at half-widths 2^(s+R-1) .. 2^s),
// i.e. at bit q + b or q + b + R of a.  Where s >= 3 - q every varying bit
// is below bit 3 and bits 3 up are common to the 8: no conflict whatever the
// XOR.  The rest (s = 2 and the tail at s = 0; the bank bits are
// (a0 ^ a3, a1 ^ a4, a2 ^ a3 ^ a4 ^ a5)):
//  - s = 2, q = 0 (kGt = 4): a varies in bits 0, 1 and 2 + R (R = 1, 2, 3):
//    bank bit 2 takes a3, a4 or a5, bits 0-1 stay a0 and a1 up to it;
//  - s = 0, R = 2, q = 0: a varies in bits 2, 3, 4: banks (a3, a4, a2 ^ ..);
//  - s = 0, q = 1 (kGt = 8): bits 0, 3, 4: banks (a0 ^ a3, a4, a3 ^ a4);
//  - s = 2, q = 1: below bit 3.
// Each 3 x 3 map is invertible, so every pass of every instance meets 8
// bank groups a quarter-warp.  The copies in and out (quad a for chunk a)
// vary in bits 0-2.
__device__ __forceinline__ int bm_swz(int a) {
    return a ^ (((a >> 3) & 3) | ((((a >> 3) ^ (a >> 4) ^ (a >> 5)) & 1) << 2));
}

constexpr int kBmMaxThreads = 512;
constexpr int kBmLineGates = 32;  // gates of a 128-byte line of device memory

template <int kLogN, int kGt>
struct BmTile {
    static constexpr int n = 1 << kLogN;
    static constexpr int quads = kGt / 4;  // kQ
    static constexpr int log_quads = kGt == 8 ? 1 : 0;
    static constexpr int words = n * kGt;
    // Tiles in shared memory: one transformed, one arriving; and items (task,
    // quad) of a 3-stage pass a thread.  At N = 2048 one tile and two items:
    // six CTAs of 128 threads an SM, which overlap each other's copies and
    // passes, took 7% less than three of 256 that each overlap their own
    // (PERF.md); at N = 1024 they took more.
    static constexpr int buffers = kLogN == 11 ? 1 : 2;
    static constexpr int items_per_thread = kLogN == 11 ? 2 : 1;
    static constexpr int threads = n * kGt / 32 / items_per_thread < 32 ? 32
        : n * kGt / 32 / items_per_thread > kBmMaxThreads ? kBmMaxThreads : n * kGt / 32 / items_per_thread;
    static constexpr int shared_bytes = buffers * words * static_cast<int>(sizeof(uint32_t));
    // the CTAs whose tiles make up a line of every row: a cluster
    static constexpr int cluster = kBmLineGates / kGt;
    // as many CTAs an SM as its 228 KB of shared memory hold (1 KB of it
    // reserved a CTA), where they get 80 registers a thread or more (the
    // forward's; the inverse's last pass spills at 80, and the inverse runs
    // as fast with the registers ptxas picks)
    static constexpr int fit = 233472 / (shared_bytes + 1024);
    static constexpr int min_ctas = fit < 65536 / (threads * 80) ? fit : 65536 / (threads * 80);
    static_assert(kGt == 4 || kGt == 8, "a tile is 1 or 2 quads wide");
};

// The cluster's barrier (every thread of its CTAs; a barrier of the CTA
// too), this CTA's rank in it, and a 16-byte read of the shared memory of
// the cluster's CTA `rank` at the place of `p` in this CTA's.  (The host
// build of the device code, mktfhe_tpu_torch/tools/host_kernels.py, brings
// its own: it runs a cluster's CTAs at once.)
#ifndef MKTFHE_HOST_BUILD
__device__ __forceinline__ void cluster_sync() {
#ifdef __CUDA_ARCH__
    asm volatile("barrier.cluster.arrive.release.aligned;\n\tbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
#endif
}

__device__ __forceinline__ int cluster_rank() {
    unsigned r = 0;
#ifdef __CUDA_ARCH__
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
#endif
    return static_cast<int>(r);
}

__device__ __forceinline__ uint4 ld_shared_cluster(const uint4* p, int rank) {
    uint4 v = make_uint4(0, 0, 0, 0);
#ifdef __CUDA_ARCH__
    const unsigned local = static_cast<unsigned>(__cvta_generic_to_shared(p));
    unsigned remote = 0;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
    asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(remote) : "memory");
#endif
    return v;
}
#endif

// Where the last pass of a CTA that is a cluster of its own stores: to
// device memory, straight from registers.
struct BmOut {
    uint32_t* dst;  // the tile's first word in y
    int gates, valid;  // row stride in words; gates of the tile that exist
    bool vec;  // rows 16-byte aligned (gates % 4 == 0)
};

// One pass of R stages at half-widths 2^(kS+R-1) .. 2^kS over the tile `a`,
// by all threads.  Item = task * kQ + quad: the task's 2^R coefficients of
// 4 gates, one 16-byte quad each, and the task's 2^R - 1 twiddles in
// registers for the 4 gates; the butterflies are modarith.cuh's, once a
// gate.  Forward in [0, 4p) out [0, 4p), inverse in [0, 2p) out [0, 2p);
// the transform's last pass (kLast) leaves the forward canonical and scales
// the inverse by 1/N = (ninv, ninv_sh), into the tile or (kDirect) to
// device memory as `out` says.
template <int kLogN, int kGt, int R, int kS, bool kFwd, bool kLast = false, bool kDirect = false>
__device__ __forceinline__ void tile_pass(uint4* a, int tid, const uint32_t* __restrict__ w,
                                          const uint32_t* __restrict__ w_sh, uint32_t p,
                                          uint32_t ninv = 0, uint32_t ninv_sh = 0,
                                          const BmOut& out = BmOut{}) {
    using T = BmTile<kLogN, kGt>;
    constexpr int kElems = 1 << R;
    constexpr int items = (T::n >> R) * T::quads;
    const uint32_t two_p = 2 * p;
#pragma unroll 1
    for (int item0 = 0; item0 < items; item0 += T::threads) {
        const int item = item0 + tid;
        if (items % T::threads != 0 && item >= items) break;
        const int h = item & (T::quads - 1);
        const int task = item >> T::log_quads;
        const int hi = task >> kS;
        const int t0 = (hi << (kS + R)) | (task & ((1 << kS) - 1));
        const Twiddles<R> tw = load_twiddles<R>((1 << (kLogN - kS - R)) + hi, w, w_sh);
        const int p0 = bm_swz((t0 << T::log_quads) | h);  // bm_swz is XOR-linear
        uint32_t e[4][kElems];
#pragma unroll
        for (int j = 0; j < kElems; ++j) {
            const uint4 v = a[p0 ^ bm_swz(j << (kS + T::log_quads))];
            e[0][j] = v.x; e[1][j] = v.y; e[2][j] = v.z; e[3][j] = v.w;
        }
#pragma unroll
        for (int g = 0; g < 4; ++g) {
            butterflies<R, kFwd>(e[g], tw, p, two_p);
#pragma unroll
            for (int j = 0; j < kElems; ++j) {
                if (kLast) e[g][j] = kFwd ? canonical(e[g][j], p) : shoup_mul(ninv, ninv_sh, e[g][j], p);
            }
        }
#pragma unroll
        for (int j = 0; j < kElems; ++j) {
            if (!kDirect) {
                a[p0 ^ bm_swz(j << (kS + T::log_quads))] = make_uint4(e[0][j], e[1][j], e[2][j], e[3][j]);
                continue;
            }
            uint32_t* d = out.dst + static_cast<size_t>(t0 | (j << kS)) * out.gates + 4 * h;
            if (out.vec) {
                if (4 * h < out.valid) *reinterpret_cast<uint4*>(d) = make_uint4(e[0][j], e[1][j], e[2][j], e[3][j]);
            } else {
#pragma unroll
                for (int g = 0; g < 4; ++g) {
                    if (4 * h + g < out.valid) d[g] = e[g][j];
                }
            }
        }
    }
}

// The middle passes of modarith.cuh's plan (middle_passes) on a tile, each
// behind a barrier: 3 stages each, and the rest of 1 or 2 ending at
// half-width 4.
template <int kLogN, int kGt, bool kFwd>
__device__ __forceinline__ void tile_middle(uint4* a, int tid, const uint32_t* __restrict__ w,
                                            const uint32_t* __restrict__ w_sh, uint32_t p) {
    constexpr int m = kLogN - 5, full = m / 3, rest = m % 3;
    static_assert(full <= 2, "N <= 2048");
    if constexpr (!kFwd && rest != 0) {
        tile_pass<kLogN, kGt, rest, 2, false>(a, tid, w, w_sh, p);
        __syncthreads();
    }
    if constexpr (full >= 1) {
        tile_pass<kLogN, kGt, 3, 2 + rest + 3 * (kFwd ? full - 1 : 0), kFwd>(a, tid, w, w_sh, p);
        __syncthreads();
    }
    if constexpr (full >= 2) {
        tile_pass<kLogN, kGt, 3, 2 + rest + 3 * (kFwd ? 0 : 1), kFwd>(a, tid, w, w_sh, p);
        __syncthreads();
    }
    if constexpr (kFwd && rest != 0) {
        tile_pass<kLogN, kGt, rest, 2, true>(a, tid, w, w_sh, p);
        __syncthreads();
    }
}

// x, y: [npr, rows, n, gates] with the gate index minor, any gates >= 1.
// Launched in clusters of kBmLineGates / kGt CTAs (kCluster) or of 1.  A
// cluster takes `span` = its CTAs x kGt consecutive gates of one (prime,
// row), t = (prime * rows + row) * per_row + group, per_row = ceil(gates /
// span); CTA `rank` transforms gates rank * kGt .. + kGt - 1 of it.  The clusters go
// round their tiles (t = cluster index, + clusters, ...), each CTA copying
// its part of the next one into the second buffer with cp.async while it
// transforms the current one (at N = 2048 with one buffer, one after the
// other, six CTAs an SM).  A full cluster then stores the line tile:
// CTA `rank` the rows rank * n / cluster .., all 32 gates, whole 128-byte
// lines read from the CTAs' buffers; a cluster of one CTA stores its tile
// from the last pass's registers (where each CTA takes one tile, that is
// quicker than the cluster's barriers).  Columns past `gates` are
// transformed on stale words and never stored.  tw, tw_sh, consts as for
// the natural kernel.
template <int kLogN, int kGt, bool kCluster, bool kFwd>
__global__ void __launch_bounds__(BmTile<kLogN, kGt>::threads, kFwd ? BmTile<kLogN, kGt>::min_ctas : 1)
ntt_bm_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
              const uint32_t* __restrict__ tw, const uint32_t* __restrict__ tw_sh,
              const uint32_t* __restrict__ consts, int npr, int rows, int gates) {
    extern __shared__ __align__(16) uint32_t a[];  // [T::buffers, n * kGt]: a ring of tiles
    using T = BmTile<kLogN, kGt>;
    constexpr int n = T::n;
    constexpr int kRows = n / T::cluster;  // rows of a line tile a CTA of a full cluster stores
    const int tid = threadIdx.x;
    constexpr int cluster = kCluster ? T::cluster : 1;
    constexpr int span = cluster * kGt;
    const int rank = kCluster ? cluster_rank() : 0;
    const int per_row = (gates + span - 1) / span;
    const int tiles = npr * rows * per_row;  // < 2^31: the wrapper checks npr * rows * n * gates
    const bool vec = (gates & 3) == 0;
    const int step = gridDim.x / cluster;
    int t = blockIdx.x / cluster;
    if (t >= tiles) return;  // the whole cluster

    // this CTA's part of line tile tt into buffer `slot`; one commit group
    // each, empty past the last tile, so that a thread's groups and the
    // tiles stay in step
    constexpr int kBuffers = T::buffers;
    auto load = [&](int tt, int slot) {
        if (tt < tiles) {
            const int poly = tt / per_row;
            const int g0 = (tt - poly * per_row) * span + rank * kGt;
            const int valid = min(gates - g0, kGt);  // <= 0: nothing of this line tile is ours
            const uint32_t* src = x + static_cast<size_t>(poly) * n * gates + g0;
            uint32_t* buf = a + slot * T::words;
            if (vec) {
                for (int c = tid; c < n * T::quads; c += T::threads) {
                    const int h = c & (T::quads - 1);
                    if (4 * h < valid) {
                        cp_async_16(buf + 4 * bm_swz(c), src + static_cast<size_t>(c >> T::log_quads) * gates + 4 * h);
                    }
                }
            } else {
                for (int k = tid; k < T::words; k += T::threads) {
                    const int g = k & (kGt - 1);
                    if (g < valid) {
                        cp_async_4(buf + 4 * bm_swz(k >> 2) + (k & 3), src + static_cast<size_t>(k / kGt) * gates + g);
                    }
                }
            }
        }
        cp_async_commit();
    };

#pragma unroll
    for (int k = 0; k + 1 < kBuffers; ++k) load(t + k * step, k);
    for (int it = 0; t < tiles; ++it, t += step) {
        // the tile kBuffers - 1 rounds ahead (with one buffer: this round's),
        // into the buffer of the previous round (behind its closing barrier)
        load(t + (kBuffers - 1) * step, (it + kBuffers - 1) % kBuffers);
        cp_async_wait<kBuffers - 1>();  // this round's tile has landed
        __syncthreads();
        uint4* buf = reinterpret_cast<uint4*>(a + (it % kBuffers) * T::words);

        const int poly = t / per_row;
        const int line0 = (t - poly * per_row) * span;
        const int q = poly / rows;
        const uint32_t p = consts[3 * q];
        const uint32_t* w = tw + q * n;
        const uint32_t* w_sh = tw_sh + q * n;
        const BmOut out{y + static_cast<size_t>(poly) * n * gates + line0, gates, min(gates - line0, kGt), vec};
        if (kFwd) {
            tile_pass<kLogN, kGt, 3, kLogN - 3, true>(buf, tid, w, w_sh, p);
            __syncthreads();
            tile_middle<kLogN, kGt, true>(buf, tid, w, w_sh, p);
            tile_pass<kLogN, kGt, 2, 0, true, true, !kCluster>(buf, tid, w, w_sh, p, 0, 0, out);  // canonical
        } else {
            tile_pass<kLogN, kGt, 2, 0, false>(buf, tid, w, w_sh, p);
            __syncthreads();
            tile_middle<kLogN, kGt, false>(buf, tid, w, w_sh, p);
            tile_pass<kLogN, kGt, 3, kLogN - 3, false, true, !kCluster>(buf, tid, w, w_sh, p, consts[3 * q + 1],
                                                                        consts[3 * q + 2], out);  // 1/N
        }
        if (!kCluster) {
            __syncthreads();  // the buffer is refilled in the next round
            continue;
        }
        cluster_sync();  // every CTA of the cluster holds its results

        // rows rank * kRows .. of the line tile, 8 quads a row: a warp stores
        // 4 whole lines; quad qq of a row lies with CTA qq / kQ.  All of a
        // thread's reads first, then its stores.
        constexpr int kOut = kRows * 8 / T::threads;  // quads a thread stores
        constexpr int kBatch = kOut < 8 ? kOut : 8;  // read before stored
        static_assert(kRows * 8 % T::threads == 0 && kOut % kBatch == 0, "whole rounds of quads");
        const int qq = tid & 7;  // the same quad of every row a thread stores
        uint32_t* dst = y + static_cast<size_t>(poly) * n * gates + line0 + 4 * qq;
#pragma unroll 1
        for (int k0 = 0; k0 < kOut; k0 += kBatch) {
            uint4 v[kBatch];
#pragma unroll
            for (int k = 0; k < kBatch; ++k) {
                const int row = rank * kRows + (((k0 + k) * T::threads + tid) >> 3);
                v[k] = ld_shared_cluster(buf + bm_swz(row * T::quads + (qq & (T::quads - 1))), qq >> T::log_quads);
            }
            if (line0 + 4 * qq >= gates) continue;
#pragma unroll
            for (int k = 0; k < kBatch; ++k) {
                uint32_t* d = dst + static_cast<size_t>(rank * kRows + (((k0 + k) * T::threads + tid) >> 3)) * gates;
                if (vec) {
                    *reinterpret_cast<uint4*>(d) = v[k];
                } else {
                    const uint32_t r[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
                    for (int g = 0; g < 4; ++g) {
                        if (line0 + 4 * qq + g < gates) d[g] = r[g];
                    }
                }
            }
        }
        cluster_sync();  // no CTA refills a buffer that another still reads
    }
}

using BmKernel = decltype(&ntt_bm_kernel<11, 4, true, true>);

// The one place that decides which kernel serves a batch-minor transform:
// the instance for its log2 N (every N the wrapper admits, 64 .. 2048), its
// tile width and direction, and the cluster it is launched in.  Tiles of 4
// gates (clusters of 8 CTAs), three CTAs an SM at N = 2048; tiles of 8
// (clusters of 4) only at N <= 1024 where the shape has enough line tiles
// for 4 CTAs each to fill the card twice over; no cluster (each CTA stores
// its own tile) where even tiles of 4 give no more CTAs than that, so that
// each takes one tile (PERF.md has the times of each choice at the
// engines' shapes).
constexpr int kBmFillCtas = 2 * 132;

struct BmPlan {
    BmKernel kernel;
    int log_n, threads, gates_per_tile, shared_bytes, cluster;
};

template <int kLogN, int kGt, bool kCluster>
inline BmPlan bm_with(bool forward) {
    using T = BmTile<kLogN, kGt>;
    return {forward ? &ntt_bm_kernel<kLogN, kGt, kCluster, true> : &ntt_bm_kernel<kLogN, kGt, kCluster, false>,
            kLogN, T::threads, kGt, T::shared_bytes, kCluster ? T::cluster : 1};
}

// the tiles of [npr, rows, n, gates] that clusters of `cluster` CTAs of
// tiles `gt` gates wide walk: polys = npr * rows of ceil(gates / span);
// by default line tiles, 32 gates
inline long long bm_tiles(long long polys, int gates, int span = kBmLineGates) {
    return polys * ((gates + span - 1) / span);
}

template <int kLogN>
inline BmPlan bm_sized(long long polys, int gates, bool forward) {
    if constexpr (kLogN <= 10) {
        if (bm_tiles(polys, gates) * 4 >= kBmFillCtas) return bm_with<kLogN, 8, true>(forward);
    }
    if (bm_tiles(polys, gates) * 8 <= kBmFillCtas) return bm_with<kLogN, 4, false>(forward);
    return bm_with<kLogN, 4, true>(forward);
}

// polys = npr * rows
inline BmPlan bm_plan(int log_n, long long polys, int gates, bool forward) {
    switch (log_n) {
        case 6: return bm_sized<6>(polys, gates, forward);
        case 7: return bm_sized<7>(polys, gates, forward);
        case 8: return bm_sized<8>(polys, gates, forward);
        case 9: return bm_sized<9>(polys, gates, forward);
        case 10: return bm_sized<10>(polys, gates, forward);
        case 11: return bm_sized<11>(polys, gates, forward);
        default: return {nullptr, 0, 0, 0, 0, 0};
    }
}

// What `bm_plan` says: out[0] the instance's log2 N (0: none), out[1]
// threads per CTA, out[2] gates per tile, out[3] dynamic shared bytes,
// out[4] tiles the grid's clusters walk, out[5] CTAs a cluster.
inline void describe_bm(int log_n, int npr, int rows, int gates, int forward, int* out) {
    const long long polys = static_cast<long long>(npr) * rows;
    const BmPlan plan = bm_plan(log_n, polys, gates, forward != 0);
    out[0] = plan.log_n;
    out[1] = plan.threads;
    out[2] = plan.gates_per_tile;
    out[3] = plan.shared_bytes;
    out[4] = plan.kernel == nullptr ? 0 : static_cast<int>(bm_tiles(polys, gates, plan.cluster * plan.gates_per_tile));
    out[5] = plan.cluster;
}

}  // namespace

// What the dispatchers say (the host build of the device code,
// tools/host_kernels.py, defines the same two).
extern "C" void mktfhe_ntt_nat_describe(int log_n, int forward, int* out) {
    describe_nat(log_n, forward, out);
}

extern "C" void mktfhe_ntt_bm_describe(int log_n, int npr, int rows, int gates, int forward, int* out) {
    describe_bm(log_n, npr, rows, gates, forward, out);
}

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

// x, y: [npr, rows, 2^log_n, gates] u32, any gates >= 1.  The grid holds as
// many clusters as the card runs at once, or one per line tile where there
// are fewer.
extern "C" int mktfhe_ntt_bm(const void* x, void* y, const void* tw, const void* tw_sh,
                             const void* consts, int npr, int rows, int gates, int log_n,
                             int forward, void* stream) {
    const long long polys = static_cast<long long>(npr) * rows;
    const BmPlan plan = bm_plan(log_n, polys, gates, forward != 0);
    if (plan.kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(plan.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           plan.shared_bytes);
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = static_cast<unsigned>(plan.cluster);
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.blockDim = dim3(plan.threads);
    config.dynamicSmemBytes = static_cast<size_t>(plan.shared_bytes);
    config.stream = static_cast<cudaStream_t>(stream);
    config.attrs = cluster;
    config.numAttrs = 1;
    const long long tiles = bm_tiles(polys, gates, plan.cluster * plan.gates_per_tile);
    config.gridDim = dim3(static_cast<unsigned>(plan.cluster));
    int resident = 0;
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveClusters(&resident, reinterpret_cast<const void*>(plan.kernel), &config);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long clusters = tiles < resident ? tiles : (resident > 0 ? resident : 1);
    config.gridDim = dim3(static_cast<unsigned>(clusters * plan.cluster));
    err = cudaLaunchKernelEx(&config, plan.kernel, static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
                             static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(tw_sh),
                             static_cast<const uint32_t*>(consts), npr, rows, gates);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mktfhe_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
