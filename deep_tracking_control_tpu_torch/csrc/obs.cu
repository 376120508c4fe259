// The observation tail of the env step in one launch.
//
// Replaces the JAX package's Pallas kernel experimental/pallas_obs.py
// (`compute_observations_fused` -> `_kernel`): the 53- or 45-dim obs (base
// angular velocity, projected gravity, scaled commands, joint positions
// and velocities, actions, and the 8 foothold values of the DTC layout),
// its noise, the height-scan chain clip(z - target - h, -1, 1) * scale,
// the privileged obs [heights + noise + episode offset | push force |
// heights], both clips, and the roll of the obs history.  As on the TPU
// the two uniform draws are made inside the kernel and never reach
// memory: the height noise is stream 0 and the obs noise stream 1 of the
// port's Philox counter layout (philox.cuh), so they equal what the
// uniform kernel (rng.cu) returns for the same seed and shape, bit for
// bit.
//
// Every arithmetic step is the plain version's (ops/cuda_obs.py), in its
// order, with the _rn intrinsics so that no multiply-add is contracted:
// outside the noise the kernel and the plain version agree exactly.
//
// Bound on the H100: bytes (per env 693 heights and the 265-wide history
// in; 1389 privileged, 265 history and 53 obs values out: about 45 MB at
// 4096 envs, 13 us at 3.35 TB/s).  Design: one block per env, threads
// over the features, so that every wide row (heights, history, outputs)
// is read and written by neighbouring threads at neighbouring addresses;
// the narrow inputs are read through their strides where they lie (the
// env hands in transposed views of the physics state); the env's noise is
// drawn first into shared memory, one Philox block per thread (four
// values), and the finished obs row stays in shared memory for the
// history roll.
#include <stdint.h>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int THREADS = 256;

// inputs: address and two strides (elements) of each; env-leading inputs
// are (N, D), q and qd (nq, N) with a row per joint, vectors (D,)
enum In {
    BAV, PG, CMD, Q, QD, ACT, FOOT, BASE_Z, HEIGHTS, PUSH, HNO, HIST,
    NSCALE, DEFQ, CSCALE, SEED, N_IN
};
enum Out { OBS, PRIV, HIST_OUT, N_OUT };
enum FParam { S_ANG, S_POS, S_VEL, S_FORCE, S_HEIGHT, TARGET, CLIP, N_F };

struct ObsArgs {
    const float* in[N_IN];
    long long s0[N_IN], s1[N_IN];
    float* out[N_OUT];
    float f[N_F];
    int N, H, nq, na, num_obs, hist_w;
    int has_foot, add_noise;
};

__device__ __forceinline__ void draw(float* dst, long long f0, int len,
                                     uint32_t stream, uint32_t k0, uint32_t k1) {
    // the elements [f0, f0 + len) of the flat (N, len) draw
    const long long b0 = f0 >> 2, b1 = (f0 + len + 3) >> 2;
    for (long long b = b0 + threadIdx.x; b < b1; b += blockDim.x) {
        const PhiloxOut r = philox_block(b, stream, k0, k1);
        for (int w = 0; w < 4; ++w) {
            const long long i = 4 * b + w - f0;
            if (i >= 0 && i < len) dst[i] = bits_to_pm1(r.w[w]);
        }
    }
}

__global__ void obs_kernel(const __grid_constant__ ObsArgs a) {
    extern __shared__ float sm[];
    float* hnoise = sm;                 // (H,)
    float* onoise = sm + a.H;           // (num_obs,)
    float* orow = onoise + a.num_obs;   // the finished obs row
    const int n = blockIdx.x;
    const long long nn = n;
    const float* const* in = a.in;
    // element (i, j) of input k
    auto at = [&](int k, long long i, long long j) {
        return in[k][i * a.s0[k] + j * a.s1[k]];
    };

    uint32_t k0, k1;
    philox_key(reinterpret_cast<const long long*>(in[SEED]), k0, k1);
    draw(hnoise, nn * a.H, a.H, 0u, k0, k1);
    if (a.add_noise) draw(onoise, nn * a.num_obs, a.num_obs, 1u, k0, k1);
    __syncthreads();

    const float clip = a.f[CLIP];
    const int nq = a.nq;
    const int base_w = 9 + 2 * nq + a.na;
    for (int j = threadIdx.x; j < a.num_obs; j += blockDim.x) {
        float v;
        if (j < 3) {
            v = __fmul_rn(at(BAV, nn, j), a.f[S_ANG]);
        } else if (j < 6) {
            v = at(PG, nn, j - 3);
        } else if (j < 9) {
            v = __fmul_rn(at(CMD, nn, j - 6), at(CSCALE, j - 6, 0));
        } else if (j < 9 + nq) {
            const int k = j - 9;
            v = __fmul_rn(__fsub_rn(at(Q, k, nn), at(DEFQ, k, 0)), a.f[S_POS]);
        } else if (j < 9 + 2 * nq) {
            v = __fmul_rn(at(QD, j - 9 - nq, nn), a.f[S_VEL]);
        } else if (j < base_w) {
            v = at(ACT, nn, j - 9 - 2 * nq);
        } else {
            v = at(FOOT, nn, j - base_w);
        }
        if (a.add_noise) v = __fadd_rn(v, __fmul_rn(onoise[j], at(NSCALE, j, 0)));
        v = clampf(v, -clip, clip);
        a.out[OBS][nn * a.num_obs + j] = v;
        orow[j] = v;
    }

    const int P = 2 * a.H + 3;
    float* priv = a.out[PRIV] + nn * P;
    const float bz = __fsub_rn(at(BASE_Z, nn, 0), a.f[TARGET]);
    const float hno = at(HNO, nn, 0);
    for (int j = threadIdx.x; j < a.H; j += blockDim.x) {
        const float h = __fmul_rn(clampf(__fsub_rn(bz, at(HEIGHTS, nn, j)),
                                         -1.0f, 1.0f),
                                  a.f[S_HEIGHT]);
        const float noisy = __fadd_rn(__fadd_rn(h, __fmul_rn(hnoise[j], 0.1f)),
                                      hno);
        priv[j] = clampf(noisy, -clip, clip);
        priv[a.H + 3 + j] = clampf(h, -clip, clip);
    }
    if (threadIdx.x < 3) {
        const int j = threadIdx.x;
        priv[a.H + j] = clampf(
            __fmul_rn(at(PUSH, nn, j), a.f[S_FORCE]), -clip, clip);
    }
    __syncthreads();

    // HistoryWrapper.step: drop the oldest obs, append this one
    const int keep = a.hist_w - a.num_obs;
    float* hout = a.out[HIST_OUT] + nn * a.hist_w;
    for (int j = threadIdx.x; j < a.hist_w; j += blockDim.x) {
        hout[j] = j < keep ? at(HIST, nn, j + a.num_obs) : orow[j - keep];
    }
}

}  // namespace

// ptrs: host int64 [N_IN input addresses | N_IN first strides | N_IN second
// strides | N_OUT output addresses]; fparams: host float32 [N_F]; flags:
// bit 0 foothold block, bit 1 obs noise.
DTC_EXPORT int dtc_observations(const void* ptrs, const void* fparams, int N,
                                int H, int nq, int na, int num_obs, int hist_w,
                                int flags, void* stream) {
    const long long* p = (const long long*)ptrs;
    ObsArgs a;
    for (int i = 0; i < N_IN; ++i) {
        a.in[i] = (const float*)(uintptr_t)p[i];
        a.s0[i] = p[N_IN + i];
        a.s1[i] = p[2 * N_IN + i];
    }
    for (int i = 0; i < N_OUT; ++i) a.out[i] = (float*)(uintptr_t)p[3 * N_IN + i];
    for (int i = 0; i < N_F; ++i) a.f[i] = ((const float*)fparams)[i];
    a.N = N;
    a.H = H;
    a.nq = nq;
    a.na = na;
    a.num_obs = num_obs;
    a.hist_w = hist_w;
    a.has_foot = flags & 1;
    a.add_noise = (flags >> 1) & 1;
    const int base_w = 9 + 2 * nq + na;
    if (N < 0 || H < 1 || hist_w < num_obs
        || num_obs != base_w + (a.has_foot ? 8 : 0)) {
        return (int)cudaErrorInvalidValue;
    }
    if (N > 0) {
        const size_t smem = sizeof(float) * (size_t)(H + 2 * num_obs);
        obs_kernel<<<N, THREADS, smem, (cudaStream_t)stream>>>(a);
    }
    return (int)cudaGetLastError();
}
