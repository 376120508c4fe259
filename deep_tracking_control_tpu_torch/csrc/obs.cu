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
// Every arithmetic step is the plain version's (env/cuda_obs.py), in its
// order, with the _rn intrinsics so that no multiply-add is contracted:
// outside the noise the kernel and the plain version agree exactly.
//
// Bound on the H100: bytes.  Per env 693 heights, the 265-wide history
// and some 60 narrow values in (4,068 bytes), 1389 privileged, 265
// history and 53 obs values out (6,828 bytes): 16.7 + 28.0 MB at 4096
// envs, 13.3 us at 3.35 TB/s.  The Philox draws (some 190 blocks of 10
// rounds an env) and the chain take the card's 132 SMs a few
// microseconds, under the bytes if they overlap the loads.
//
// Design: a block holds ENVS consecutive envs (a multiple of 4), at 4096
// envs 256 blocks of 512 threads: two blocks an SM, every block resident
// at once.  Every output row is 1 mod 4 floats wide, so no single row
// starts 16-byte aligned; a block's span of rows, starting at env n0 = 0
// mod 4, does, and the kernel walks each span as flat float4 stores, the
// env and column of each element tracked by a cursor (a division at its
// start, none as it steps).  A float4 that lies in one env and one
// section takes a fast path; one that straddles two envs or two sections
// is done lane by lane.
//   1. Before any arithmetic the block puts its big inputs in flight:
//      each height row (16-byte aligned, as the sampler's 736-float rows
//      are) and the block's span of the history, in 16-byte asynchronous
//      copies (cp.async) into shared memory, a tail word by word; inputs
//      laid out otherwise are copied word by word through their strides.
//   2. While they arrive: the block's height noise into shared memory,
//      one Philox block of stream 0 a thread (the span starts at element
//      (row0 + n0) * H = 0 mod 4, row0 the global row of env 0 on a rank
//      that holds a block of a sharded run); the narrow state, a warp's threads on adjacent
//      envs (the env hands in transposed views: the block's envs of one
//      joint row are contiguous), into the obs rows in shared memory;
//      the obs noise, one Philox block of stream 1 a float4 of the obs
//      span (it starts at element (row0 + n0) * num_obs = 0 mod 4), added,
//      clipped and stored as float4.
//   3. Then the privileged span (the staged rows and noise read with two
//      aligned 16-byte shared loads a float4) and the history span (the
//      rolled rows are the staged span shifted by num_obs floats, the new
//      obs the block's finished obs rows).
// Measured on NVIDIA H100 80GB HBM3, 700.00 W (scripts/kernel_times.py,
// L2 evicted before each call): drawing the height noise where it is
// used, after the loads had arrived, cost 6 us a call; 16 x 512 was the
// fastest launch shape of the 4 to 32 envs and 64 to 512 threads tried.  Staging the narrow state
// with cp.async, or writing the spans of 4 envs as soon as their copies
// arrived (commit groups), was slower.
// A block past N (the ragged tail) stages and writes only its envs.
#include <stdint.h>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int ENVS = 16;         // envs a block (a multiple of 4)
constexpr int THREADS = 512;     // threads a block
static_assert(ENVS % 4 == 0, "a block's spans start 16-byte aligned");
static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps a block");
constexpr int ENV_WORDS = 5;     // staged per env: z - target, offset, push

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
    long long row0;  // global row of env 0 (a rank's first env), 0 mod 4
    int add_noise;
    int rows16;      // the height rows copy in 16-byte pieces
    int span16;      // the history is contiguous rows: its span copies so
};

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// asynchronous copies of 4 and 16 bytes from global to shared memory,
// and the wait for all of a thread's copies
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(d), "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// s[a .. a + 3] for any a >= 0, from two aligned 16-byte shared loads
// (the buffer holds 4 floats past its last element read)
__device__ __forceinline__ float4 lds4(const float* s, int a) {
    const int r = a & 3;
    const float4* v = reinterpret_cast<const float4*>(s + (a - r));
    const float4 x = v[0];
    if (r == 0) return x;
    const float4 y = v[1];
    return r == 1 ? make_float4(x.y, x.z, x.w, y.x)
         : r == 2 ? make_float4(x.z, x.w, y.x, y.y)
                  : make_float4(x.w, y.x, y.y, y.z);
}

__device__ __forceinline__ float4 pm1x4(const PhiloxOut& r) {
    return make_float4(bits_to_pm1(r.w[0]), bits_to_pm1(r.w[1]),
                       bits_to_pm1(r.w[2]), bits_to_pm1(r.w[3]));
}

__device__ __forceinline__ float lane(const float4& v, int c) {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// stores the first `cnt` (1..4) lanes of v at dst, as one float4 when
// all four are written (dst is 16-byte aligned)
__device__ __forceinline__ void store4(float* dst, const float4& v, int cnt) {
    if (cnt >= 4) {
        *reinterpret_cast<float4*>(dst) = v;
    } else {
        for (int c = 0; c < cnt; ++c) dst[c] = lane(v, c);
    }
}

// the position (row, col) of flat index i in rows `width` wide, moved on
// by a fixed step (one division each at the start, none after)
struct Cursor {
    int row, col, drow, dcol, width;
    __device__ __forceinline__ Cursor(int i, int step, int w)
        : row(i / w), col(i - (i / w) * w), drow(step / w),
          dcol(step - (step / w) * w), width(w) {}
    __device__ __forceinline__ void advance() {
        row += drow;
        col += dcol;
        if (col >= width) {
            col -= width;
            ++row;
        }
    }
};

// shared memory (floats): the height rows (ENVS x round4(H), +4), the
// history span (ENVS x hist_w, + num_obs + 4), the obs rows (ENVS x
// num_obs, +4), the per-env words (ENVS x ENV_WORDS), the height noise
// (ENVS x H, +4)
__host__ __device__ __forceinline__ int smem_floats(int H, int num_obs,
                                                    int hist_w) {
    return ENVS * round4(H) + 4 + round4(ENVS * hist_w + num_obs + 4)
           + round4(ENVS * num_obs + 4) + round4(ENVS * ENV_WORDS)
           + round4(ENVS * H) + 4;
}

__global__ void __launch_bounds__(THREADS) obs_kernel(
        const __grid_constant__ ObsArgs a) {
    extern __shared__ __align__(16) float sm[];
    const int H = a.H, NO = a.num_obs, HW = a.hist_w;
    const int HP = round4(H), P = 2 * H + 3, KEEP = HW - NO;
    float* sh = sm;                                     // height rows
    float* shist = sh + ENVS * HP + 4;                  // history span
    float* sobs = shist + round4(ENVS * HW + NO + 4);   // obs rows
    float* senv = sobs + round4(ENVS * NO + 4);         // per-env words
    float* snoise = senv + round4(ENVS * ENV_WORDS);    // height noise
    const long long n0 = (long long)blockIdx.x * ENVS;
    const int ne = (int)min((long long)ENVS, (long long)a.N - n0);
    const int t = threadIdx.x;
    const float* const* in = a.in;
    uint32_t k0, k1;
    philox_key(reinterpret_cast<const long long*>(in[SEED]), k0, k1);

    // 1. the height rows and the history span in flight
    {
        const float* h = in[HEIGHTS] + n0 * a.s0[HEIGHTS];
        const long long hs0 = a.s0[HEIGHTS], hs1 = a.s1[HEIGHTS];
        const int n16 = a.rows16 ? H >> 2 : 0;
        if (n16 > 0) {
            Cursor c(t, THREADS, n16);
            for (; c.row < ne; c.advance()) {
                cp_async16(sh + c.row * HP + 4 * c.col,
                           h + c.row * hs0 + 4 * c.col);
            }
        }
        const int rest = H - 4 * n16;                   // words a row left
        if (rest > 0) {
            Cursor c(t, THREADS, rest);
            for (; c.row < ne; c.advance()) {
                const int j = 4 * n16 + c.col;
                cp_async4(sh + c.row * HP + j, h + c.row * hs0 + j * hs1);
            }
        }
    }
    {
        const float* hi = in[HIST] + n0 * a.s0[HIST];
        if (a.span16) {
            const int cnt = ne * HW, n16 = cnt >> 2;
            for (int i = t; i < n16; i += THREADS) {
                cp_async16(shist + 4 * i, hi + 4 * i);
            }
            for (int i = 4 * n16 + t; i < cnt; i += THREADS) {
                cp_async4(shist + i, hi + i);
            }
        } else {
            const long long s0 = a.s0[HIST], s1 = a.s1[HIST];
            Cursor c(t, THREADS, HW);
            for (; c.row < ne; c.advance()) {
                cp_async4(shist + c.row * HW + c.col,
                          hi + c.row * s0 + c.col * s1);
            }
        }
    }
    // 2. while they arrive: the block's height noise, elements
    // [n0 H, (n0 + ne) H) of stream 0, a Philox block a thread
    {
        // global row row0 + n0 = 0 mod 4, so its first element is too
        const long long b0 = ((a.row0 + n0) * H) >> 2;
        for (int b = t; 4 * b < ne * H; b += THREADS) {
            *reinterpret_cast<float4*>(snoise + 4 * b) =
                pm1x4(philox_block(b0 + b, 0u, k0, k1));
        }
    }

    // the narrow state into the obs rows (before the noise) and the
    // per-env words; item (j, e) is thread e + ENVS * j, envs adjacent
    auto at = [&](int k, long long i, long long j) {
        return in[k][i * a.s0[k] + j * a.s1[k]];
    };
    const float clip = a.f[CLIP];
    const int nq = a.nq, base_w = 9 + 2 * nq + a.na;
    for (int i = t; i < (NO + ENV_WORDS) * ENVS; i += THREADS) {
        const int j = i / ENVS, e = i - j * ENVS;
        if (e >= ne) continue;
        const long long n = n0 + e;
        if (j >= NO) {
            const int w = j - NO;
            float v;
            if (w == 0) {
                v = __fsub_rn(at(BASE_Z, n, 0), a.f[TARGET]);
            } else if (w == 1) {
                v = at(HNO, n, 0);
            } else {
                v = clampf(__fmul_rn(at(PUSH, n, w - 2), a.f[S_FORCE]),
                           -clip, clip);
            }
            senv[e * ENV_WORDS + w] = v;
            continue;
        }
        float v;
        if (j < 3) {
            v = __fmul_rn(at(BAV, n, j), a.f[S_ANG]);
        } else if (j < 6) {
            v = at(PG, n, j - 3);
        } else if (j < 9) {
            v = __fmul_rn(at(CMD, n, j - 6), at(CSCALE, j - 6, 0));
        } else if (j < 9 + nq) {
            const int k = j - 9;
            v = __fmul_rn(__fsub_rn(at(Q, k, n), at(DEFQ, k, 0)), a.f[S_POS]);
        } else if (j < 9 + 2 * nq) {
            v = __fmul_rn(at(QD, j - 9 - nq, n), a.f[S_VEL]);
        } else if (j < base_w) {
            v = at(ACT, n, j - 9 - 2 * nq);
        } else {
            v = at(FOOT, n, j - base_w);
        }
        sobs[e * NO + j] = v;
    }
    __syncthreads();

    // the obs span: noise (one Philox block a float4), clip, store
    {
        const int cnt = ne * NO;
        float* out = a.out[OBS] + n0 * NO;
        const long long blk0 = ((a.row0 + n0) * NO) >> 2;  // 0 mod 4 too
        Cursor c(4 * t, 4 * THREADS, NO);
        for (int i = 4 * t; i < cnt; i += 4 * THREADS, c.advance()) {
            float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
            if (a.add_noise) z = pm1x4(philox_block(blk0 + (i >> 2), 1u, k0, k1));
            float v[4];
            for (int l = 0; l < 4; ++l) {
                int j = c.col + l;
                if (j >= NO) j -= NO;
                float x = sobs[i + l];
                if (a.add_noise) {
                    x = __fadd_rn(x, __fmul_rn(lane(z, l), at(NSCALE, j, 0)));
                }
                v[l] = clampf(x, -clip, clip);
            }
            const int m = min(4, cnt - i);
            for (int l = 0; l < m; ++l) sobs[i + l] = v[l];
            store4(out + i, make_float4(v[0], v[1], v[2], v[3]), m);
        }
    }
    cp_async_wait_all();
    __syncthreads();

    // 3. the privileged span: [noisy heights | push | heights] an env
    {
        const int cnt = ne * P;
        float* out = a.out[PRIV] + n0 * P;
        const float scale = a.f[S_HEIGHT];
        auto chain = [&](float bz, float h) {
            return __fmul_rn(clampf(__fsub_rn(bz, h), -1.0f, 1.0f), scale);
        };
        auto noisy = [&](float hc, float z, float hno) {
            return clampf(__fadd_rn(__fadd_rn(hc, __fmul_rn(z, 0.1f)), hno),
                          -clip, clip);
        };
        Cursor c(4 * t, 4 * THREADS, P);
        for (int i = 4 * t; i < cnt; i += 4 * THREADS, c.advance()) {
            const int e = c.row, j = c.col;
            const int m = min(4, cnt - i);
            float4 v;
            if (j + 3 < H) {                            // noisy, one env
                const float* w = senv + e * ENV_WORDS;
                const float4 h = lds4(sh + e * HP, j);
                const float4 z = lds4(snoise, e * H + j);
                v = make_float4(noisy(chain(w[0], h.x), z.x, w[1]),
                                noisy(chain(w[0], h.y), z.y, w[1]),
                                noisy(chain(w[0], h.z), z.z, w[1]),
                                noisy(chain(w[0], h.w), z.w, w[1]));
            } else if (j >= H + 3 && j + 3 < P) {       // clean, one env
                const float bz = senv[e * ENV_WORDS];
                const float4 h = lds4(sh + e * HP, j - H - 3);
                v = make_float4(clampf(chain(bz, h.x), -clip, clip),
                                clampf(chain(bz, h.y), -clip, clip),
                                clampf(chain(bz, h.z), -clip, clip),
                                clampf(chain(bz, h.w), -clip, clip));
            } else {                                    // lane by lane
                float r[4];
                for (int l = 0; l < 4; ++l) {
                    int ee = e, jj = j + l;
                    if (jj >= P) { jj -= P; ++ee; }
                    r[l] = 0.0f;
                    if (l >= m) continue;
                    const float* w = senv + ee * ENV_WORDS;
                    if (jj < H) {
                        r[l] = noisy(chain(w[0], sh[ee * HP + jj]),
                                     snoise[ee * H + jj], w[1]);
                    } else if (jj < H + 3) {
                        r[l] = w[2 + jj - H];
                    } else {
                        r[l] = clampf(chain(w[0], sh[ee * HP + jj - H - 3]),
                                      -clip, clip);
                    }
                }
                v = make_float4(r[0], r[1], r[2], r[3]);
            }
            store4(out + i, v, m);
        }
    }

    // HistoryWrapper.step: drop the oldest obs, append this one; in the
    // flat span the kept part of element i is staged element i + NO
    {
        const int cnt = ne * HW;
        float* out = a.out[HIST_OUT] + n0 * HW;
        Cursor c(4 * t, 4 * THREADS, HW);
        for (int i = 4 * t; i < cnt; i += 4 * THREADS, c.advance()) {
            const int e = c.row, j = c.col;
            const int m = min(4, cnt - i);
            float4 v;
            if (j + 3 < KEEP) {
                v = lds4(shist, i + NO);
            } else if (j >= KEEP && j + 3 < HW) {
                v = lds4(sobs, e * NO + j - KEEP);
            } else {
                float r[4];
                for (int l = 0; l < 4; ++l) {
                    int ee = e, jj = j + l;
                    if (jj >= HW) { jj -= HW; ++ee; }
                    r[l] = l >= m ? 0.0f
                         : jj < KEEP ? shist[i + l + NO]
                                     : sobs[ee * NO + jj - KEEP];
                }
                v = make_float4(r[0], r[1], r[2], r[3]);
            }
            store4(out + i, v, m);
        }
    }
}

}  // namespace

// ptrs: host int64 [N_IN input addresses | N_IN first strides | N_IN second
// strides | N_OUT output addresses (16-byte aligned, contiguous)];
// fparams: host float32 [N_F]; flags: bit 0 foothold block, bit 1 obs
// noise; row0: the global row of env 0 (0 mod 4), whose draws the noise
// continues.  Launch: ceil(N / ENVS) blocks of THREADS threads.
DTC_EXPORT int dtc_observations(const void* ptrs, const void* fparams, int N,
                                int H, int nq, int na, int num_obs, int hist_w,
                                int flags, int row0, void* stream) {
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
    a.row0 = row0;
    const int has_foot = flags & 1;
    a.add_noise = (flags >> 1) & 1;
    const int base_w = 9 + 2 * nq + na;
    if (N < 0 || H < 1 || hist_w < num_obs || row0 < 0 || (row0 & 3) != 0
        || num_obs != base_w + (has_foot ? 8 : 0)) {
        return (int)cudaErrorInvalidValue;
    }
    for (int i = 0; i < N_OUT; ++i) {
        if (((uintptr_t)a.out[i] & 15) != 0) return (int)cudaErrorMisalignedAddress;
    }
    auto aligned = [](const float* q) { return ((uintptr_t)q & 15) == 0; };
    a.rows16 = a.s1[HEIGHTS] == 1 && (a.s0[HEIGHTS] & 3) == 0
               && aligned(a.in[HEIGHTS]);
    a.span16 = a.s1[HIST] == 1 && (a.s0[HIST] == hist_w || N == 1)
               && aligned(a.in[HIST]);
    const size_t smem = sizeof(float) * (size_t)smem_floats(H, num_obs, hist_w);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            obs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    if (N > 0) {
        obs_kernel<<<(N + ENVS - 1) / ENVS, THREADS, smem,
                     (cudaStream_t)stream>>>(a);
    }
    return (int)cudaGetLastError();
}
