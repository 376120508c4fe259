// Per-env terrain patch and contact-window copies.
//
// Replaces the JAX package's Pallas kernels ops/pallas_patch.py
// `extract_patches_pallas` (`_kernel`) and `extract_windows_pallas`
// (`_window_kernel`).  Both copy a run of whole 128-column rows of a
// blocked terrain table (terrain/patch.py make_source: (T, B, R_pad, 128)
// float32) for every env, from the env's start (row r0, column block b):
//   patches: out[t, n] = blocks[t, b_n, r0_n : r0_n + 64, :]   (T, N, 64, 128)
//   windows: out[n] = blocks[0, b_n, r0_n + 16 : r0_n + 56, :]  (N, 40, 128)
// On the TPU each grid step issued one async DMA per env and waited on a
// semaphore per copy; here a block copies one (table, env) slab.
//
// Bound on the H100: bytes.  Nothing is computed; each byte of the slab is
// read once and written once (a slab is rows x 512 contiguous bytes on
// both sides).  Design: one block per (env, table), 256 threads, 16-byte
// loads and stores with neighbouring threads on neighbouring addresses,
// 64-bit offsets.  A start outside the table (which patch_starts never
// makes) fills the slab with NaN instead of reading out of bounds.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int COLS = 128;            // columns of a blocked table
constexpr int VEC = COLS / 4;        // float4 per row

__global__ void copy_rows_kernel(const float4* __restrict__ blocks,
                                 const int* __restrict__ starts,
                                 float4* __restrict__ out, int N, int B,
                                 int Rp, int row0, int rows) {
    const long long n = blockIdx.x;
    const long long t = blockIdx.y;
    const long long r0 = (long long)starts[2 * n] + row0;
    const long long b = starts[2 * n + 1];
    float4* dst = out + (t * N + n) * rows * VEC;
    const long long count = (long long)rows * VEC;
    if (r0 < 0 || r0 + rows > Rp || b < 0 || b >= B) {
        const float nan = __int_as_float(0x7fc00000);
        for (long long i = threadIdx.x; i < count; i += blockDim.x)
            dst[i] = make_float4(nan, nan, nan, nan);
        return;
    }
    const float4* src = blocks + ((t * B + b) * Rp + r0) * VEC;
    for (long long i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

int launch(const void* blocks, const void* starts, void* out, int T, int N,
           int B, int Rp, int row0, int rows, void* stream) {
    if (T < 1 || T > 65535 || N < 0 || rows < 1 || B < 1)
        return (int)cudaErrorInvalidValue;
    if (N > 0) {
        copy_rows_kernel<<<dim3(N, T), 256, 0, (cudaStream_t)stream>>>(
            (const float4*)blocks, (const int*)starts, (float4*)out, N, B,
            Rp, row0, rows);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// blocks: (T, B, Rp, 128) float32, 16-byte aligned; starts: (N, 2) int32
// (row, column block); out: (T, N, rows, 128) float32.
DTC_EXPORT int dtc_extract_patches(const void* blocks, const void* starts,
                                   void* out, int T, int N, int B, int Rp,
                                   int rows, void* stream) {
    return launch(blocks, starts, out, T, N, B, Rp, 0, rows, stream);
}

// Rows [r0 + win_r0, r0 + win_r0 + win_r) of table 0: out (N, win_r, 128).
DTC_EXPORT int dtc_extract_windows(const void* blocks, const void* starts,
                                   void* out, int N, int B, int Rp,
                                   int win_r0, int win_r, void* stream) {
    return launch(blocks, starts, out, 1, N, B, Rp, win_r0, win_r, stream);
}
