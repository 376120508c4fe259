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
// The kernel takes the world query coordinates and makes the patch
// coordinates itself, fr = (qx - ox) * inv_hs, as PyTorch computes
// (qx - origin) / hs on the card (a float32 subtract, then a multiply by
// the float32 reciprocal of hs): __fsub_rn then __fmul_rn, never
// contracted, so that the nearest cell is the plain version's exactly.
//
// Bound on the H100: memory.  At 4096 envs the call moves 44.4 MB: the
// world coordinates qx/qy in (24.1 MB), the heights and slopes out
// (12.8 MB), one bf16 cell per nearest query and four float32 cells per
// bilinear one (7.4 MB, counted by the cells touched; the tables, 50.9 MB
// at lite3_dtc's size, largely stay in L2).  Design: one thread per 4
// consecutive queries of an env (Q_TOT = 736 = 184 x 4, so a row is 184
// float4 and 16-byte aligned), float4 loads of qx/qy and float4 stores
// of the heights, a warp covering 512 contiguous bytes of a row; the grid
// is N x 184 threads in blocks of THREADS = 128 (about 2.8 waves of 64
// warps an SM at 4096 envs), so that every SM holds enough warps to cover
// the scattered table reads.  Each group of 4 lies in one section of the
// row (704, 712 and 736 are multiples of 4): a group either takes 4
// nearest cells or 4 bilinear samples.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int Q_MIN3 = 704;
constexpr int Q_MAX10 = 8;
constexpr int Q_BIL = 24;
constexpr int Q_TOT = Q_MIN3 + Q_MAX10 + Q_BIL;
constexpr int G_TOT = Q_TOT / 4;                  // float4 groups a row
constexpr int G_BIL = (Q_MIN3 + Q_MAX10) / 4;     // first bilinear group
constexpr int PATCH_R = 64;
constexpr int PATCH_C = 128;
constexpr int THREADS = 128;                      // threads a block
static_assert(Q_TOT % 4 == 0 && Q_MIN3 % 4 == 0 && Q_BIL % 4 == 0,
              "each float4 group lies in one section of the row");

__device__ __forceinline__ float4 ld4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float comp(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(THREADS) sample_all_kernel(
        const float* __restrict__ raw,              // (B, Rp, 128) table 0
        const __nv_bfloat16* __restrict__ pooled,   // (2, B, Rp, 128)
        const int* __restrict__ starts,             // (N, 2) r0, block
        const float* __restrict__ origin,           // (N, 2) world xy of cell (0,0)
        const float* __restrict__ qx,               // (N, Q_TOT) world x
        const float* __restrict__ qy,               // (N, Q_TOT) world y
        float* __restrict__ h_out,                  // (N, Q_TOT)
        float* __restrict__ gx_out,                 // (N, Q_BIL)
        float* __restrict__ gy_out,
        long long N, int B, int Rp, float inv_hs) {
    const long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (g >= N * G_TOT) return;                     // the ragged tail
    const long long n = g / G_TOT;
    const int k4 = (int)(g - n * G_TOT);
    const int2 st = __ldg(reinterpret_cast<const int2*>(starts) + n);
    const float2 org = __ldg(reinterpret_cast<const float2*>(origin) + n);
    const long long r0 = st.x, blk = st.y;
    const long long iq = n * Q_TOT + 4 * k4;
    const float4 x4 = ld4(qx + iq), y4 = ld4(qy + iq);
    float h[4];
    if (k4 < G_BIL) {
        // nearest cells of the min3 (scan) or max10 (clearance) table
        const long long t = 4 * k4 < Q_MIN3 ? 0 : 1;
        const __nv_bfloat16* tab = pooled + ((t * B + blk) * Rp + r0) * PATCH_C;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            // the edge clip of the row coordinate comes first
            // (pallas_sampler.py:160); the TPU's 16-row alignment shift
            // is a DMA artefact and has no counterpart here
            const float fr = clampf(__fmul_rn(__fsub_rn(comp(x4, i), org.x), inv_hs),
                                    0.0f, (float)(PATCH_R - 1));
            const float fc = __fmul_rn(__fsub_rn(comp(y4, i), org.y), inv_hs);
            // nearest cell: floor, clipped into the patch (patch.py:149)
            const long long ir = (long long)floorf(fr);
            const long long ic = (long long)clampf(floorf(fc), 0.0f,
                                                   (float)(PATCH_C - 1));
            h[i] = __bfloat162float(tab[ir * PATCH_C + ic]);
        }
    } else {
        const int k = 4 * (k4 - G_BIL);
        float gx[4], gy[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float fr = clampf(__fmul_rn(__fsub_rn(comp(x4, i), org.x), inv_hs),
                              0.0f, (float)(PATCH_R - 1));
            const float fc = __fmul_rn(__fsub_rn(comp(y4, i), org.y), inv_hs);
            // back off the bottom edge so the corner rows stay inside the
            // patch (pallas_sampler.py:168)
            fr = fminf(fr, 62.9999f);
            const float i0 = clampf(floorf(fr), 0.0f, (float)(PATCH_R - 2));
            const float tx = clampf(__fsub_rn(fr, i0), 0.0f, 1.0f);
            const float j0 = clampf(floorf(fc), 0.0f, (float)(PATCH_C - 2));
            const float ty = clampf(__fsub_rn(fc, j0), 0.0f, 1.0f);
            const float* row0 = raw + (blk * Rp + r0 + (long long)i0) * PATCH_C
                                + (long long)j0;
            const float s00 = __ldg(row0), s01 = __ldg(row0 + 1);
            const float s10 = __ldg(row0 + PATCH_C), s11 = __ldg(row0 + PATCH_C + 1);
            // the separable form of the TPU kernel: rows first, then cols
            const float rw0 = s00 * (1.0f - tx) + s10 * tx;
            const float rw1 = s01 * (1.0f - tx) + s11 * tx;
            h[i] = rw0 * (1.0f - ty) + rw1 * ty;
            gx[i] = clampf(((s10 - s00) * (1.0f - ty) + (s11 - s01) * ty) * inv_hs,
                           -3.0f, 3.0f);
            gy[i] = clampf((rw1 - rw0) * inv_hs, -3.0f, 3.0f);
        }
        reinterpret_cast<float4*>(gx_out + n * Q_BIL + k)[0] =
            make_float4(gx[0], gx[1], gx[2], gx[3]);
        reinterpret_cast<float4*>(gy_out + n * Q_BIL + k)[0] =
            make_float4(gy[0], gy[1], gy[2], gy[3]);
    }
    reinterpret_cast<float4*>(h_out + iq)[0] = make_float4(h[0], h[1], h[2], h[3]);
}

}  // namespace

// qx, qy, h_out, gx_out and gy_out 16-byte aligned (rows of Q_TOT and
// Q_BIL floats keep every row aligned); origin 8-byte and starts 8-byte
// aligned.
DTC_EXPORT int dtc_sample_all(const void* raw, const void* pooled,
                              const void* starts, const void* origin,
                              const void* qx, const void* qy, void* h_out,
                              void* gx_out, void* gy_out, int N, int B,
                              int Rp, float inv_hs, void* stream) {
    if (N > 0) {
        const long long work = (long long)N * G_TOT;
        const unsigned blocks = (unsigned)((work + THREADS - 1) / THREADS);
        sample_all_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            (const float*)raw, (const __nv_bfloat16*)pooled,
            (const int*)starts, (const float*)origin, (const float*)qx,
            (const float*)qy, (float*)h_out, (float*)gx_out, (float*)gy_out,
            (long long)N, B, Rp, inv_hs);
    }
    return (int)cudaGetLastError();
}
