// Uniform noise in [-1, 1): Philox4x32-10 straight into an output array.
//
// Replaces the JAX package's Pallas kernel experimental/pallas_rng.py
// (`uniform_pm1` -> `_kernel`), which streamed the TPU core's hardware
// generator into a (N, D) float32 array.  Here the generator is Philox
// (philox.cuh): element i of the flat output is word j % 4 of the block
// j / 4 on the caller's stream word, j = offset + i, so the output equals
// the plain version (ops/cuda_rng.py) bit for bit, any (N, D) works, and
// a rank holding rows [r, r + n) of an (N, D) draw (offset r D) gets
// those rows of the unsharded draw.
//
// Bound on the H100: bytes (4 written per element; 2.8 M elements for a
// (4096, 693) draw are 11.4 MB, 3.4 us at 3.35 TB/s); the 10 rounds cost
// 20 32-bit multiplies per 4 elements.  Design: one thread per counter
// block, four elements per thread, stored as one 16-byte vector where the
// block lies whole inside the output and the offset is 0 mod 4 (the
// output's base is 16-byte aligned, as every PyTorch allocation is),
// element stores otherwise (an odd row width at a nonzero offset),
// neighbouring threads on neighbouring blocks.
#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int THREADS = 256;                      // threads a block
constexpr long long MAX_BLOCKS = 65535LL * 32;    // the grid-stride cap

__global__ void __launch_bounds__(THREADS) uniform_kernel(
        const long long* __restrict__ seed, float* __restrict__ out,
        long long numel, uint32_t stream, long long offset) {
    uint32_t k0, k1;
    philox_key(seed, k0, k1);
    // counter blocks [first, first + nblk) cover elements [offset,
    // offset + numel); block gb holds elements 4 gb .. 4 gb + 3, which lie
    // at out[4 gb - offset + w]
    const long long first = offset >> 2;
    const long long nblk = ((offset + numel + 3) >> 2) - first;
    const bool aligned = (offset & 3) == 0;
    for (long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         b < nblk; b += (long long)gridDim.x * blockDim.x) {
        const PhiloxOut r = philox_block(first + b, stream, k0, k1);
        const long long i = 4 * (first + b) - offset;
        if (aligned && i + 4 <= numel) {
            reinterpret_cast<float4*>(out)[b] =
                make_float4(bits_to_pm1(r.w[0]), bits_to_pm1(r.w[1]),
                            bits_to_pm1(r.w[2]), bits_to_pm1(r.w[3]));
        } else {
            for (int w = 0; w < 4; ++w) {
                if (i + w >= 0 && i + w < numel) out[i + w] = bits_to_pm1(r.w[w]);
            }
        }
    }
}

}  // namespace

// seed: device int64 (2,); out: device float32 (numel,), 16-byte aligned,
// element k of which is element offset + k of the counter layout.
DTC_EXPORT int dtc_uniform_pm1(const void* seed, void* out, int numel,
                               int stream, int offset, void* cuda_stream) {
    if (numel < 0 || stream < 0 || offset < 0) return (int)cudaErrorInvalidValue;
    if (((unsigned long long)(uintptr_t)out & 15) != 0) {
        return (int)cudaErrorMisalignedAddress;
    }
    const long long nblk = numel ? (((long long)offset + numel + 3) >> 2)
                                       - ((long long)offset >> 2)
                                 : 0;
    if (nblk > 0) {
        const long long blocks = (nblk + THREADS - 1) / THREADS;
        uniform_kernel<<<(unsigned)(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS),
                         THREADS, 0, (cudaStream_t)cuda_stream>>>(
            (const long long*)seed, (float*)out, (long long)numel,
            (uint32_t)stream, (long long)offset);
    }
    return (int)cudaGetLastError();
}
