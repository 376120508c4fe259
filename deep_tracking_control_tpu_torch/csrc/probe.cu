// Launch-floor probes: kernels that launch and do (almost) nothing.
//
// No path of the port runs them.  chip_smoke.py and scripts/kernel_times.py
// time them in the same profiler session as a small kernel, so that its
// device time can be read against the least time any launch of its shape
// takes on the card: `empty_kernel` does nothing; `seed_kernel` loads the
// 16-byte (2,) int64 seed in every thread, as the uniform kernel (rng.cu)
// must before it draws, and stores nothing unless the seed's two words
// meet a test that keeps the load (then one word, to `sink`).
#include <stdint.h>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int MAX_THREADS = 256;

__global__ void __launch_bounds__(MAX_THREADS) empty_kernel() {}

__global__ void __launch_bounds__(MAX_THREADS) seed_kernel(
        const long long* __restrict__ seed, unsigned* __restrict__ sink) {
    uint32_t k0, k1;
    philox_key(seed, k0, k1);
    if ((k0 ^ k1) == 0x9E3779B9u && threadIdx.x == 0) *sink = k0;
}

}  // namespace

// what: 0 the empty kernel, 1 the seed load; seed: device int64 (2,);
// sink: device uint32 (1,); blocks x threads (threads <= 256).
DTC_EXPORT int dtc_launch_floor(int what, const void* seed, void* sink,
                                int blocks, int threads, void* stream) {
    if (blocks < 1 || threads < 1 || threads > MAX_THREADS || what < 0
        || what > 1) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = (cudaStream_t)stream;
    if (what == 0) {
        empty_kernel<<<blocks, threads, 0, s>>>();
    } else {
        seed_kernel<<<blocks, threads, 0, s>>>((const long long*)seed,
                                               (unsigned*)sink);
    }
    return (int)cudaGetLastError();
}
