// What the card reaches on the sweep kernels' own butterflies when nothing
// else is in the way: a measuring kernel, on no bootstrap's path.
//
// The bounds that chip_smoke.py prints for the sweep kernels count integer
// operations against the card's peak rate.  This kernel gives the second
// yardstick beside them: every thread keeps 8 residues and the 7 twiddle
// pairs of a radix-8 task in registers and runs `butterflies<3, kFwd>` of
// modarith.cuh on them again and again -- the arithmetic of one pass of
// fwd_ntt_passes / inv_ntt_passes without its shared-memory traffic, its
// barriers and its twiddle loads.  The lazy butterflies map [0, 4p) to [0, 4p)
// (forward) and [0, 2p) to [0, 2p) (inverse), so the loop stays inside their
// ranges for any number of rounds.  The residues go out canonical at the end,
// so that the arithmetic can be held against big integers
// (tests/test_torch_host_rate.py) and the compiler keeps the loop.
//
// Launched with the sweeps' CTA shape (512 threads of up to 128 registers);
// `shared_bytes` of dynamic shared memory, never touched, set how many CTAs
// share an SM: 0 for as many as fit, above half of an SM's memory for one,
// which is the sweeps' occupancy.
//
// Built by mktfhe_tpu_torch/kernels/_build.py like the other sources; wrapper:
// mktfhe_tpu_torch/tools/butterfly_rate.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

using namespace mktfhe;

constexpr int kRateThreads = 512;
constexpr int kRateElems = 8;  // residues a thread holds: one radix-8 task

// out: [ctas * threads, 8] canonical residues after `rounds` rounds of the 3
// stages (12 butterflies a round) on values made from `seed` and the thread's
// index; tw, tw_sh: one prime's twiddle table and its Shoup companion (the
// task of digits_first_pass: entries 1..7).
template <bool kFwd>
__global__ void __launch_bounds__(kRateThreads)
butterfly_rate_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ tw,
                      const uint32_t* __restrict__ tw_sh, uint32_t p, uint32_t seed, int rounds) {
    extern __shared__ __align__(16) unsigned char smem[];
    (void)smem;
    const uint32_t gid = blockIdx.x * blockDim.x + threadIdx.x;
    const uint32_t two_p = 2 * p;
    const Twiddles<3> t = load_twiddles<3>(1, tw, tw_sh);
    uint32_t e[kRateElems];
#pragma unroll
    for (int j = 0; j < kRateElems; ++j) {
        // any value below p: inside both butterflies' input ranges
        e[j] = (seed + gid * 2654435761u + j * 40503u) % p;
    }
    for (int r = 0; r < rounds; ++r) butterflies<3, kFwd>(e, t, p, two_p);
#pragma unroll
    for (int j = 0; j < kRateElems; ++j) {
        out[static_cast<size_t>(gid) * kRateElems + j] = canonical(e[j], p);
    }
}

}  // namespace

// Returns the first CUDA error of the attribute call or the launch.
extern "C" int mktfhe_butterfly_rate(void* out, const void* tw, const void* tw_sh, unsigned int p,
                                     unsigned int seed, int rounds, int forward, int ctas,
                                     int shared_bytes, void* stream) {
    const auto kernel = forward ? &butterfly_rate_kernel<true> : &butterfly_rate_kernel<false>;
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    kernel<<<dim3(static_cast<unsigned int>(ctas)), dim3(kRateThreads), shared_bytes,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint32_t*>(out), static_cast<const uint32_t*>(tw),
        static_cast<const uint32_t*>(tw_sh), p, seed, rounds);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mktfhe_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
