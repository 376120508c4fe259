// Fused terrain sampler: every terrain query of one policy step.
//
// Replaces the JAX package's Pallas kernel terrain/pallas_sampler.py
// (_sample_all_pallas -> _kernel).  Per env, 736 packed queries:
//   [0, 704)    min3 nearest from the bf16 pooled table   (height scan)
//   [704, 712)  max10 nearest from the bf16 pooled table  (foot clearance)
//   [712, 736)  raw bilinear height + x/y slope           (body planes)
// The TPU kernel DMAs an 80x128 slab per env and turns the gathers into
// one-hot matmuls; here each thread reads its cells directly, which is the
// same arithmetic (a one-hot row times a table is the selected cell).
//
// The patch coordinates fr/fc arrive computed by the wrapper (as in the
// TPU kernel), so the nearest-cell choice is the plain version's exactly.
// Divisions by the cell size are multiplications by inv_hs = 1/hs, the
// form PyTorch uses on the card for a tensor divided by a scalar.
//
// Bound on the H100: memory.  At 4096 envs the kernel moves about 36 MB
// (qx/qy in, heights and slopes out); the table reads hit a small per-env
// window that stays in L1/L2.  Design: one block per env, threads striding
// over the queries, so that the query and result rows are read and written
// coalesced; no shared memory is needed.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int Q_MIN3 = 704;
constexpr int Q_MAX10 = 8;
constexpr int Q_BIL = 24;
constexpr int Q_TOT = Q_MIN3 + Q_MAX10 + Q_BIL;
constexpr int PATCH_R = 64;
constexpr int PATCH_C = 128;

__global__ void sample_all_kernel(
        const float* __restrict__ raw,              // (B, Rp, 128) table 0
        const __nv_bfloat16* __restrict__ pooled,   // (2, B, Rp, 128)
        const int* __restrict__ starts,             // (N, 2) r0, block
        const float* __restrict__ fr_in,            // (N, Q_TOT) patch row coords
        const float* __restrict__ fc_in,            // (N, Q_TOT) patch col coords
        float* __restrict__ h_out,                  // (N, Q_TOT)
        float* __restrict__ gx_out,                 // (N, Q_BIL)
        float* __restrict__ gy_out,
        int B, int Rp, float inv_hs) {
    const int n = blockIdx.x;
    const long r0 = starts[2 * n];
    const long blk = starts[2 * n + 1];
    for (int q = threadIdx.x; q < Q_TOT; q += blockDim.x) {
        const long iq = (long)n * Q_TOT + q;
        // the edge clip of the row coordinate comes first
        // (pallas_sampler.py:160); the TPU's 16-row alignment shift is a
        // DMA artefact and has no counterpart here
        float fr = clampf(fr_in[iq], 0.0f, (float)(PATCH_R - 1));
        const float fc = fc_in[iq];
        if (q < Q_MIN3 + Q_MAX10) {
            // nearest cell: floor, clipped into the patch (patch.py:149)
            const long ir = (long)floorf(fr);
            const long ic = (long)clampf(floorf(fc), 0.0f, (float)(PATCH_C - 1));
            const long t = q < Q_MIN3 ? 0 : 1;
            h_out[iq] = __bfloat162float(
                pooled[((t * B + blk) * Rp + r0 + ir) * PATCH_C + ic]);
        } else {
            const int k = q - (Q_MIN3 + Q_MAX10);
            // back off the bottom edge so the corner rows stay inside the
            // patch (pallas_sampler.py:168)
            fr = fminf(fr, 62.9999f);
            const float i0 = clampf(floorf(fr), 0.0f, (float)(PATCH_R - 2));
            const float tx = clampf(fr - i0, 0.0f, 1.0f);
            const float j0 = clampf(floorf(fc), 0.0f, (float)(PATCH_C - 2));
            const float ty = clampf(fc - j0, 0.0f, 1.0f);
            const float* row0 = raw + (blk * Rp + r0 + (long)i0) * PATCH_C + (long)j0;
            const float s00 = row0[0], s01 = row0[1];
            const float s10 = row0[PATCH_C], s11 = row0[PATCH_C + 1];
            // the separable form of the TPU kernel: rows first, then cols
            const float rw0 = s00 * (1.0f - tx) + s10 * tx;
            const float rw1 = s01 * (1.0f - tx) + s11 * tx;
            h_out[iq] = rw0 * (1.0f - ty) + rw1 * ty;
            const float gx = ((s10 - s00) * (1.0f - ty) + (s11 - s01) * ty) * inv_hs;
            const float gy = (rw1 - rw0) * inv_hs;
            gx_out[(long)n * Q_BIL + k] = clampf(gx, -3.0f, 3.0f);
            gy_out[(long)n * Q_BIL + k] = clampf(gy, -3.0f, 3.0f);
        }
    }
}

}  // namespace

DTC_EXPORT int dtc_sample_all(const void* raw, const void* pooled,
                              const void* starts, const void* fr,
                              const void* fc, void* h_out, void* gx_out,
                              void* gy_out, int N, int B, int Rp,
                              float inv_hs, void* stream) {
    if (N > 0) {
        sample_all_kernel<<<N, 256, 0, (cudaStream_t)stream>>>(
            (const float*)raw, (const __nv_bfloat16*)pooled,
            (const int*)starts, (const float*)fr, (const float*)fc,
            (float*)h_out, (float*)gx_out, (float*)gy_out, B, Rp, inv_hs);
    }
    return (int)cudaGetLastError();
}
