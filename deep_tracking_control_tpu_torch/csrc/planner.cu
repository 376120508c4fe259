// Fused DTC foothold-planner scoring + selection.
//
// Replaces the JAX package's Pallas kernel env/pallas_planner.py
// (_plan_pallas -> _kernel).  Per env over the 33x21 height scan: heights
// relative to the base clipped to +-0.5 (points with |rel| > 1 excluded),
// one-sided/central gradient stencils, score = 0.2 edge + slope + 0.3
// roughness with the 0.1 -> 10 threshold, scan points rotated into the
// world by the base yaw, per-leg distance to the nominal foothold
// (>= 0.16 -> 10), total = 0.2 score + 0.8 dist, the first-occurrence
// argmin per leg, and the reference's tiled-table decode.
//
// Bound on the H100: latency of the per-env reductions (about 3 KB of
// heights in, 80 B out per env).  Design: one block per env; the scan,
// its world coordinates and the scores live in shared memory; the mean,
// the mean square and the four argmins are block reductions (warp
// shuffles, then one value per warp).  Elementwise steps use the _rn
// intrinsics so that no multiply-add is contracted: the scores near the
// 0.1 threshold then differ from the plain version only through the order
// of the two sums.  Divisions by the grid spacing are multiplications by
// its float32 reciprocal, as PyTorch computes a tensor over a scalar on
// the card.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int OUT_W = 20;   // 4 tx | 4 ty | 4 world x | 4 world y | 4 world z

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ void argmin_merge(float& v, int& i, float v2, int i2) {
    if (v2 < v || (v2 == v && i2 < i)) {
        v = v2;
        i = i2;
    }
}

__global__ void plan_kernel(const float* __restrict__ scal,     // (N, 16)
                            const float* __restrict__ heights,  // (N, H)
                            const float* __restrict__ stat,     // (4, H)
                            float* __restrict__ out,            // (N, 20)
                            int H, int ny, float inv_s, float inv_2s) {
    extern __shared__ float sm[];
    float* g = sm;              // clipped relative heights
    float* hwx = sm + H;        // world x of the scan points
    float* hwy = sm + 2 * H;    // world y
    float* bsc = sm + 3 * H;    // 0.2 * score, or -1 where excluded
    __shared__ float red[2][WARPS];
    __shared__ float rv[4][WARPS];
    __shared__ int ri[4][WARPS];

    const int n = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float* sc = scal + (long)n * 16;
    const float bx = sc[0], by = sc[1], bz = sc[2], cy = sc[3], sy = sc[4];
    const float* h = heights + (long)n * H;
    const int nx = H / ny;

    // ---- clipped heights and the two sums -----------------------------
    float s1 = 0.0f, s2 = 0.0f;
    for (int k = tid; k < H; k += THREADS) {
        const float gk = clampf(__fsub_rn(h[k], bz), -0.5f, 0.5f);
        g[k] = gk;
        s1 = __fadd_rn(s1, gk);
        s2 = __fadd_rn(s2, __fmul_rn(gk, gk));
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
        red[0][warp] = s1;
        red[1][warp] = s2;
    }
    __syncthreads();
    float t1 = 0.0f, t2 = 0.0f;
    for (int w = 0; w < WARPS; ++w) {
        t1 += red[0][w];
        t2 += red[1][w];
    }
    const float mean = t1 / (float)H;
    const float var = __fsub_rn(t2 / (float)H, __fmul_rn(mean, mean));
    const float edge = clampf(sqrtf(fmaxf(var, 0.0f)), 0.0f, 0.3f);

    // ---- per-point score and world coordinates ------------------------
    for (int k = tid; k < H; k += THREADS) {
        const int i = k / ny, j = k - i * ny;
        const float gk = g[k];
        float dx, dy;
        if (i == 0) dx = __fmul_rn(__fsub_rn(g[k + ny], gk), inv_s);
        else if (i == nx - 1) dx = __fmul_rn(__fsub_rn(gk, g[k - ny]), inv_s);
        else dx = __fmul_rn(__fsub_rn(g[k + ny], g[k - ny]), inv_2s);
        if (j == 0) dy = __fmul_rn(__fsub_rn(g[k + 1], gk), inv_s);
        else if (j == ny - 1) dy = __fmul_rn(__fsub_rn(gk, g[k - 1]), inv_s);
        else dy = __fmul_rn(__fsub_rn(g[k + 1], g[k - 1]), inv_2s);
        const float slope = sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
        const float rough = fabsf(__fsub_rn(gk, mean));
        float score = __fadd_rn(__fadd_rn(__fmul_rn(0.2f, edge), slope),
                                __fmul_rn(0.3f, rough));
        score = score < 0.1f ? score : 10.0f;
        const float rel = __fsub_rn(h[k], bz);
        const bool excluded = (rel > 1.0f) || (rel < -1.0f);
        bsc[k] = excluded ? -1.0f : __fmul_rn(score, 0.2f);
        const float hpx = stat[k], hpy = stat[H + k];
        hwx[k] = __fadd_rn(__fsub_rn(__fmul_rn(cy, hpx), __fmul_rn(sy, hpy)), bx);
        hwy[k] = __fadd_rn(__fadd_rn(__fmul_rn(sy, hpx), __fmul_rn(cy, hpy)), by);
    }
    __syncthreads();

    // ---- per-leg first-occurrence argmin --------------------------------
    float bv[4];
    int bi[4];
    for (int l = 0; l < 4; ++l) {
        bv[l] = FLT_MAX;
        bi[l] = H;
    }
    for (int k = tid; k < H; k += THREADS) {
        const float b = bsc[k];
        for (int l = 0; l < 4; ++l) {
            const float ddx = __fsub_rn(sc[5 + l], hwx[k]);
            const float ddy = __fsub_rn(sc[9 + l], hwy[k]);
            float dis = sqrtf(__fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy)));
            dis = dis < 0.16f ? dis : 10.0f;
            const float total = b < 0.0f ? 10.0f : __fadd_rn(b, __fmul_rn(dis, 0.8f));
            argmin_merge(bv[l], bi[l], total, k);
        }
    }
    for (int l = 0; l < 4; ++l) {
        for (int o = 16; o > 0; o >>= 1) {
            const float v2 = __shfl_xor_sync(0xffffffffu, bv[l], o);
            const int i2 = __shfl_xor_sync(0xffffffffu, bi[l], o);
            argmin_merge(bv[l], bi[l], v2, i2);
        }
        if (lane == 0) {
            rv[l][warp] = bv[l];
            ri[l][warp] = bi[l];
        }
    }
    __syncthreads();
    if (tid < 4) {
        const int l = tid;
        float v = rv[l][0];
        int idx = ri[l][0];
        for (int w = 1; w < WARPS; ++w) argmin_merge(v, idx, rv[l][w], ri[l][w]);
        float* o = out + (long)n * OUT_W;
        o[l] = stat[2 * H + idx];
        o[4 + l] = stat[3 * H + idx];
        o[8 + l] = hwx[idx];
        o[12 + l] = hwy[idx];
        o[16 + l] = h[idx];
    }
}

}  // namespace

DTC_EXPORT int dtc_plan_footholds(const void* scal, const void* heights,
                                  const void* stat, void* out, int N, int H,
                                  int ny, float inv_s, float inv_2s,
                                  void* stream) {
    if (N > 0) {
        const size_t smem = 4 * (size_t)H * sizeof(float);
        plan_kernel<<<N, THREADS, smem, (cudaStream_t)stream>>>(
            (const float*)scal, (const float*)heights, (const float*)stat,
            (float*)out, H, ny, inv_s, inv_2s);
    }
    return (int)cudaGetLastError();
}
