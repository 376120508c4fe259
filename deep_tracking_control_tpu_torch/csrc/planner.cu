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
// Bound on the H100: the latency of the per-env reductions over a little
// work (about 3 KB of heights in, 80 B out per env; ~60 operations a
// point).  Design: one warp per env, 8 envs a block (512 blocks of 256
// threads at 4096 envs, held to 64 registers a thread so that 4 blocks fit
// an SM and all run in one wave).  The block loads the scan's
// env-independent tables (the base-frame scan x/y and the two decode rows)
// into shared memory once for its envs.  Each lane keeps its points (every
// 32nd) in registers; the clipped heights the stencils need from
// neighbouring points go in the warp's own slice of shared memory.  The
// mean, the mean square and the four first-occurrence argmins are warp
// shuffles, ordered by __syncwarp() alone: no barrier of the block after
// the table load.  A lane walks its points' rows and columns by a fixed
// step instead of dividing each index.  Elementwise steps use the _rn
// intrinsics so that no multiply-add is contracted: the scores near the
// 0.1 threshold then differ from the plain version only through the order
// of the two sums.  Divisions by the grid spacing are multiplications by
// its float32 reciprocal, as PyTorch computes a tensor over a scalar on
// the card.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int OUT_W = 20;   // 4 tx | 4 ty | 4 world x | 4 world y | 4 world z
constexpr int MAXM = 24;    // points a lane: H <= 32 * MAXM
constexpr int ENVS = 8;     // envs a block, one warp each

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

__device__ __forceinline__ float world_x(float cy, float sy, float bx,
                                         float hpx, float hpy) {
    return __fadd_rn(__fsub_rn(__fmul_rn(cy, hpx), __fmul_rn(sy, hpy)), bx);
}

__device__ __forceinline__ float world_y(float cy, float sy, float by,
                                         float hpx, float hpy) {
    return __fadd_rn(__fadd_rn(__fmul_rn(sy, hpx), __fmul_rn(cy, hpy)), by);
}

// at most 64 registers a thread: 4 blocks an SM, 512 blocks in one wave
__global__ void __launch_bounds__(32 * ENVS, 4)
plan_kernel(const float* __restrict__ scal,     // (N, 16)
            const float* __restrict__ heights,  // (N, H)
            const float* __restrict__ stat,     // (4, H)
            float* __restrict__ out,            // (N, 20)
            int N, int H, int ny, float inv_s, float inv_2s) {
    extern __shared__ float4 sm4[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float* tab = reinterpret_cast<float*>(sm4);   // (4, H): scan x, y,
                                                  // decode x, y
    float* g = tab + (4 + warp) * H;       // this env's clipped heights
    const float4* stat4 = reinterpret_cast<const float4*>(stat);
    for (int k = threadIdx.x; k < H; k += blockDim.x) sm4[k] = stat4[k];
    __syncthreads();
    const long n = (long)blockIdx.x * (blockDim.x >> 5) + warp;
    if (n >= N) return;
    const float* sc = scal + n * 16;
    const float bx = sc[0], by = sc[1], bz = sc[2], cy = sc[3], sy = sc[4];
    const float* h = heights + n * H;
    const int nx = H / ny;

    // ---- clipped heights and the two sums -----------------------------
    float gr[MAXM];
    unsigned excluded = 0u;
    float s1 = 0.0f, s2 = 0.0f;
    float hv[MAXM];
#pragma unroll
    for (int m = 0; m < MAXM; ++m)      // all loads in flight at once
        hv[m] = h[min(lane + 32 * m, H - 1)];
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
        const int k = lane + 32 * m;
        if (k >= H) break;
        const float rel = __fsub_rn(hv[m], bz);
        const float gk = clampf(rel, -0.5f, 0.5f);
        gr[m] = gk;
        g[k] = gk;
        s1 = __fadd_rn(s1, gk);
        s2 = __fadd_rn(s2, __fmul_rn(gk, gk));
        excluded |= ((rel > 1.0f) || (rel < -1.0f)) ? 1u << m : 0u;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    __syncwarp();
    const float mean = s1 / (float)H;
    const float var = __fsub_rn(s2 / (float)H, __fmul_rn(mean, mean));
    const float edge = clampf(sqrtf(fmaxf(var, 0.0f)), 0.0f, 0.3f);
    const float edge_term = __fmul_rn(0.2f, edge);

    // ---- per point: score, world position, the first argmins -----------
    // A leg's total is 0.2 score + 0.8 dis (dis = 10 where the point lies
    // 0.16 or more from the leg's nominal foothold), or 10 where the point
    // is excluded.  A point within 0.16 and not excluded totals under
    // 2.13, every other point 8 or more; so a leg with such a point takes
    // the first argmin over those points, and a leg without one the first
    // argmin of the far total (0.2 score + 8, or 10), the same for every
    // leg.
    float px[4], py[4], bv[4], fv = FLT_MAX;
    int bi[4], fi = H;
    for (int l = 0; l < 4; ++l) {
        px[l] = sc[5 + l];
        py[l] = sc[9 + l];
        bv[l] = FLT_MAX;
        bi[l] = H;
    }
    const int di = 32 / ny, dj = 32 - di * ny;   // a lane's step, rows/cols
    int i = lane / ny, j = lane - i * ny;
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
        const int k = lane + 32 * m;
        if (k >= H) break;
        const float gk = gr[m];
        // one-sided stencils at the edges, central inside, without
        // branches (a warp's lanes lie on different columns)
        const int up = i < nx - 1 ? k + ny : k, dn = i > 0 ? k - ny : k;
        const int rt = j < ny - 1 ? k + 1 : k, lt = j > 0 ? k - 1 : k;
        const float dx = __fmul_rn(__fsub_rn(g[up], g[dn]),
                                   i == 0 || i == nx - 1 ? inv_s : inv_2s);
        const float dy = __fmul_rn(__fsub_rn(g[rt], g[lt]),
                                   j == 0 || j == ny - 1 ? inv_s : inv_2s);
        // the score passes its 0.1 gate only if the slope does (the other
        // terms are >= 0): past slope^2 = 0.0101 the square root is not
        // needed, and the result is the same
        const float sl2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        float score = 10.0f;
        if (sl2 < 0.0101f) {
            const float rough = fabsf(__fsub_rn(gk, mean));
            // (flat ground: sqrtf's slow path would take every zero)
            const float slope = sl2 > 0.0f ? sqrtf(sl2) : 0.0f;
            const float raw = __fadd_rn(__fadd_rn(edge_term, slope),
                                        __fmul_rn(0.3f, rough));
            if (raw < 0.1f) score = raw;
        }
        const bool excl = (excluded >> m) & 1u;
        const float b = __fmul_rn(score, 0.2f);
        const float hwx = world_x(cy, sy, bx, tab[k], tab[H + k]);
        const float hwy = world_y(cy, sy, by, tab[k], tab[H + k]);
        const float far = excl ? 10.0f : __fadd_rn(b, __fmul_rn(10.0f, 0.8f));
        if (far < fv) {             // a lane's points come in index order
            fv = far;
            fi = k;
        }
        for (int l = 0; l < 4; ++l) {
            const float ddx = __fsub_rn(px[l], hwx);
            const float ddy = __fsub_rn(py[l], hwy);
            const float d2 = __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy));
            // the 0.16 gate likewise: sqrt(0.0257) > 0.16
            if (d2 < 0.0257f && !excl) {
                const float r = sqrtf(d2);
                const float total = __fadd_rn(b, __fmul_rn(r, 0.8f));
                if (r < 0.16f && total < bv[l]) {
                    bv[l] = total;
                    bi[l] = k;
                }
            }
        }
        j += dj;
        i += di;
        if (j >= ny) {
            j -= ny;
            ++i;
        }
    }
    for (int o = 16; o > 0; o >>= 1) {
        const float v2 = __shfl_xor_sync(0xffffffffu, fv, o);
        const int i2 = __shfl_xor_sync(0xffffffffu, fi, o);
        argmin_merge(fv, fi, v2, i2);
    }
    for (int l = 0; l < 4; ++l) {
        for (int o = 16; o > 0; o >>= 1) {
            const float v2 = __shfl_xor_sync(0xffffffffu, bv[l], o);
            const int i2 = __shfl_xor_sync(0xffffffffu, bi[l], o);
            argmin_merge(bv[l], bi[l], v2, i2);
        }
        if (bi[l] == H) bi[l] = fi;         // no point within 0.16
    }
    if (lane < 4) {
        const int l = lane;
        const int idx = l == 0 ? bi[0] : l == 1 ? bi[1] : l == 2 ? bi[2] : bi[3];
        const float hpx = tab[idx], hpy = tab[H + idx];
        float* o = out + n * OUT_W;
        o[l] = tab[2 * H + idx];
        o[4 + l] = tab[3 * H + idx];
        o[8 + l] = world_x(cy, sy, bx, hpx, hpy);
        o[12 + l] = world_y(cy, sy, by, hpx, hpy);
        o[16 + l] = h[idx];
    }
}

}  // namespace

// shared memory: the 4 tables and each warp's clipped heights, at most
// 12 * 768 floats (36 KB)
DTC_EXPORT int dtc_plan_footholds(const void* scal, const void* heights,
                                  const void* stat, void* out, int N, int H,
                                  int ny, float inv_s, float inv_2s,
                                  void* stream) {
    if (H > 32 * MAXM) return (int)cudaErrorInvalidValue;
    if (N > 0) {
        const size_t smem = (4 + ENVS) * (size_t)H * sizeof(float);
        plan_kernel<<<(N + ENVS - 1) / ENVS, 32 * ENVS, smem,
                      (cudaStream_t)stream>>>(
            (const float*)scal, (const float*)heights, (const float*)stat,
            (float*)out, N, H, ny, inv_s, inv_2s);
    }
    return (int)cudaGetLastError();
}
