// The reward stack of the env step in one launch.
//
// Replaces the JAX package's Pallas kernel experimental/pallas_rewards.py
// (`compute_rewards_fused` -> `_kernel`): every active reward term of
// env/rewards.py (legged_robot.py:1320-1622 and legged_robot_dtc.py:
// 522-586), each times its scale * dt, summed in the reference's order;
// the positive clip; the termination term; the (K, N) episode sums, added
// in place; and the three pieces of reward state (feet air time, the
// 5-deep stumble ring, the pitch filter), each written only when a term
// that owns it is active.  Which terms run is a table of term ids, sum
// rows and scales passed by value, so one build serves every task.
//
// Every term repeats the plain version's float32 operations
// (env/rewards.py) in its order, with the _rn intrinsics where a multiply
// and an add could be contracted; divisions by a Python float are
// multiplications by its float32 reciprocal, as PyTorch computes them on
// the card.  Sums over joints and feet run serially here, while PyTorch's
// reductions may pair them otherwise: the two versions differ by float
// rounding only.  The plane fit of the orientation terms, a (N, 693) x
// (693, 3) product, stays a matrix product outside the kernel, as in the
// JAX package; the kernel reads its (N, 3) result.
//
// Bound on the H100: bytes (about 330 float32 values in and 60 out per
// env, some 5 MB at 4096 envs: 1.6 us at 3.35 TB/s); the work is some
// thousand float operations an env.  Design: one thread per env, every
// input read through its own strides (the env hands in transposed views
// of the physics outputs; the kernel reads them where they lie instead
// of copying them), the terms in registers, one pass.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 64;
constexpr int MAX_TERMS = 40;
constexpr int MAX_FEET = 8;

// term ids: the order of env/rewards.py REWARD_FUNCTIONS
enum Term {
    LIN_VEL_Z, ANG_VEL_XY, TORQUES, DOF_VEL, DOF_ACC, ACTION_RATE, COLLISION,
    DOF_POS_LIMITS, DOF_VEL_LIMITS, TORQUE_LIMITS, TRACKING_LIN_VEL,
    TRACKING_ANG_VEL, FEET_AIR_TIME, STUMBLE, STAND_STILL,
    FEET_CONTACT_FORCES, POWER, SMOOTH, FOOT_CLEARANCE, FEET_SLIP, HIP_POS,
    POWERCHANGE, POS_ACC, FOOT_ACC, ORIENTATION, ORIENTATION_ROLL, BIG_PITCH,
    FEET_STUMBLE, BASE_HEIGHT, FOOTHOLD_MISS, SOFT_TRACKING_LIN_VEL,
    SOFT_TRACKING_ANG_VEL, TRACKING_OPTIMAL_FOOTHOLDS, N_TERMS
};

// inputs, each a view (address, three strides in elements); per-env
// inputs have the env first, per-joint constants are (N, nq) views with
// a zero env stride
enum In {
    BLV, BAV, PG, Q, QD, LQD, ACT, LACT, LACT2, TAU,    // float32
    CF, AIR, CMD, CMDB, LVB, AVB, DEFQ, SOFT_LO, SOFT_HI, VEL_LIM, TAU_LIM,
    MASS, FP, FV, LFV, CLEAR, PLANE_X, PITCH, ACC_PTS, OPT, ROOT_Z, ORIGIN_Z,
    LINMAX,
    FC, LC, FILT, STUMB, RESET, TIMEOUT,                // bool (uint8)
    LEVELS,                                             // int32
    FEET_IDX, PEN_IDX, HIP_IDX,                         // int64
    N_IN
};
enum Out { REW, SUMS, AIR_OUT, STUMB_OUT, PITCH_OUT, N_OUT };
enum FParam {
    DT, INV_DT, INV_SIGMA, INV_YAW_MAX, SOFT_VEL, SOFT_TAU, MAX_CF, MAX_ACC,
    HEIGHT_TARGET, N_F
};
enum IParam {
    I_N, I_NQ, I_NF, I_NPEN, I_NHIP, I_NPTS, I_LCMDB, I_LLVB, I_LAVB,
    I_NTERMS, I_TERM_ON, I_TERM_ROW, I_ONLY_POS, N_I
};

struct View {
    const void* p;
    long long s0, s1, s2;
};

struct RewardArgs {
    View in[N_IN];
    void* out[N_OUT];
    float f[N_F];
    int i[N_I];
    int id[MAX_TERMS];
    int row[MAX_TERMS];
    float scale[MAX_TERMS];
    float term_scale;
};

__device__ __forceinline__ float ld(const View& v, long long a, long long b = 0,
                                    long long c = 0) {
    return reinterpret_cast<const float*>(v.p)[a * v.s0 + b * v.s1 + c * v.s2];
}
__device__ __forceinline__ bool ldb(const View& v, long long a, long long b = 0,
                                    long long c = 0) {
    return reinterpret_cast<const uint8_t*>(v.p)[a * v.s0 + b * v.s1 + c * v.s2] != 0;
}
__device__ __forceinline__ long long ldi64(const View& v, long long a) {
    return reinterpret_cast<const long long*>(v.p)[a * v.s0];
}
__device__ __forceinline__ int ldi32(const View& v, long long a) {
    return reinterpret_cast<const int*>(v.p)[a * v.s0];
}

__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// torch.linalg.vector_norm of 2 or 3 components
__device__ __forceinline__ float norm2(float x, float y) {
    return sqrtf(add(sq(x), sq(y)));
}
__device__ __forceinline__ float norm3(float x, float y, float z) {
    return sqrtf(add(add(sq(x), sq(y)), sq(z)));
}

struct Env {
    const RewardArgs& a;
    long long n;
    int nq, nf;
    float cmd_norm;       // |commands[:2]|
    bool have_orient;
    float p_local_x, p_local_y, new_pitch;

    __device__ float f(int k, long long b = 0, long long c = 0) const {
        return ld(a.in[k], n, b, c);
    }
    __device__ bool b(int k, long long i = 0, long long j = 0) const {
        return ldb(a.in[k], n, i, j);
    }
    // contact force component c of body `body`
    __device__ float cf(long long body, int c) const {
        return ld(a.in[CF], n, body, c);
    }
    __device__ long long foot(int i) const { return ldi64(a.in[FEET_IDX], i); }

    // the plane-fit pitch/roll estimate and the filtered pitch
    // (_orientation_common, legged_robot.py:1535-1596)
    __device__ void orientation_common() {
        if (have_orient) return;
        have_orient = true;
        const float X0 = f(PLANE_X, 0), X1 = f(PLANE_X, 1);
        const float nrm = norm3(X0, X1, -1.0f);
        const float pitch_est = atanf(-__fdiv_rn(X0, nrm));
        const float roll_est = -atanf(-__fdiv_rn(X1, nrm));
        const float pitch_clip =
            (pitch_est >= -0.1f && pitch_est <= 0.1f) ? 0.0f : pitch_est;
        const float roll_clip =
            (roll_est >= -0.1f && roll_est <= 0.1f) ? 0.0f : roll_est;
        new_pitch = add(mul(f(PITCH), 0.2f), mul(0.8f, pitch_clip));
        // quat_from_euler_xyz(roll_clip, new_pitch, 0), then
        // quat_rotate_inverse(q, (0, 0, -1)) written out
        const float hr = mul(roll_clip, 0.5f), hp = mul(new_pitch, 0.5f);
        const float cr = cosf(hr), sr = sinf(hr), cp = cosf(hp), sp = sinf(hp);
        const float qx = mul(sr, cp), qy = mul(cr, sp);
        const float qz = -mul(sr, sp), qw = mul(cr, cp);
        const float t0 = -2.0f * qy, t1 = 2.0f * qx;     // 2 (qvec x v)
        const float c0 = -mul(qz, t1), c1 = mul(qz, t0); // qvec x t
        p_local_x = add(-mul(qw, t0), c0);
        p_local_y = add(-mul(qw, t1), c1);
    }

    __device__ float term(int id) {
        const float* fp = a.f;
        float s = 0.0f;
        switch (id) {
        case LIN_VEL_Z:
            return sq(f(BLV, 2));
        case ANG_VEL_XY:
            return add(sq(f(BAV, 0)), sq(f(BAV, 1)));
        case TORQUES:
            for (int j = 0; j < nq; ++j) s = add(s, sq(f(TAU, j)));
            return s;
        case DOF_VEL:
            for (int j = 0; j < nq; ++j) s = add(s, sq(f(QD, j)));
            return s;
        case DOF_ACC:
            for (int j = 0; j < nq; ++j) {
                s = add(s, sq(mul(sub(f(LQD, j), f(QD, j)), fp[INV_DT])));
            }
            return s;
        case ACTION_RATE:
            for (int j = 0; j < nq; ++j) s = add(s, sq(sub(f(LACT, j), f(ACT, j))));
            return s;
        case COLLISION:
            for (int p = 0; p < a.i[I_NPEN]; ++p) {
                const long long body = ldi64(a.in[PEN_IDX], p);
                s = add(s, norm3(cf(body, 0), cf(body, 1), cf(body, 2)) > 0.1f
                               ? 1.0f : 0.0f);
            }
            return s;
        case DOF_POS_LIMITS:
            for (int j = 0; j < nq; ++j) {
                const float q = f(Q, j);
                s = add(s, add(-fminf(sub(q, f(SOFT_LO, j)), 0.0f),
                               fmaxf(sub(q, f(SOFT_HI, j)), 0.0f)));
            }
            return s;
        case DOF_VEL_LIMITS:
            for (int j = 0; j < nq; ++j) {
                const float lim = mul(f(VEL_LIM, j), fp[SOFT_VEL]);
                s = add(s, clampf(sub(fabsf(f(QD, j)), lim), 0.0f, 1.0f));
            }
            return s;
        case TORQUE_LIMITS:
            for (int j = 0; j < nq; ++j) {
                const float lim = mul(f(TAU_LIM, j), fp[SOFT_TAU]);
                s = add(s, fmaxf(sub(fabsf(f(TAU, j)), lim), 0.0f));
            }
            return s;
        case TRACKING_LIN_VEL: {
            const float m = f(LINMAX);
            const float e0 = __fdiv_rn(sub(f(CMD, 0), f(BLV, 0)), m);
            const float e1 = __fdiv_rn(sub(f(CMD, 1), f(BLV, 1)), m);
            return expf(mul(-add(sq(e0), sq(e1)), fp[INV_SIGMA]));
        }
        case TRACKING_ANG_VEL:
            return expf(mul(-sq(sub(f(CMD, 2), f(BAV, 2))), fp[INV_SIGMA]));
        case FEET_AIR_TIME: {
            float* air_out = reinterpret_cast<float*>(a.out[AIR_OUT]);
            for (int i = 0; i < nf; ++i) {
                const bool filt = b(FC, i) || b(LC, i);
                const float air0 = f(AIR, i);
                const bool first = air0 > 0.0f && filt;
                const float air = add(air0, fp[DT]);
                s = add(s, mul(sub(air, 0.5f), first ? 1.0f : 0.0f));
                air_out[n * nf + i] = mul(air, filt ? 0.0f : 1.0f);
            }
            return mul(s, cmd_norm > 0.1f ? 1.0f : 0.0f);
        }
        case STUMBLE:
        case FEET_STUMBLE: {
            const float k = id == STUMBLE ? 5.0f : 3.0f;
            bool any = false;
            for (int i = 0; i < nf; ++i) {
                const long long body = foot(i);
                any |= norm2(cf(body, 0), cf(body, 1)) > mul(k, fabsf(cf(body, 2)));
            }
            return any ? 1.0f : 0.0f;
        }
        case STAND_STILL:
            for (int j = 0; j < nq; ++j) s = add(s, fabsf(sub(f(Q, j), f(DEFQ, j))));
            return mul(s, cmd_norm < 0.1f ? 1.0f : 0.0f);
        case FEET_CONTACT_FORCES:
            for (int i = 0; i < nf; ++i) {
                const long long body = foot(i);
                s = add(s, fmaxf(sub(norm3(cf(body, 0), cf(body, 1), cf(body, 2)),
                                     fp[MAX_CF]), 0.0f));
            }
            return s;
        case POWER:
            for (int j = 0; j < nq; ++j) s = add(s, fmaxf(mul(f(TAU, j), f(QD, j)), 0.0f));
            return s;
        case SMOOTH:
            for (int j = 0; j < nq; ++j) {
                s = add(s, sq(add(sub(f(ACT, j), mul(2.0f, f(LACT, j))), f(LACT2, j))));
            }
            return s;
        case FOOT_CLEARANCE: {
            // the 5-deep stumble ring: drop the oldest row, append this one
            uint8_t* ring = reinterpret_cast<uint8_t*>(a.out[STUMB_OUT]);
            for (int i = 0; i < nf; ++i) {
                const long long body = foot(i);
                const bool stumb =
                    norm2(cf(body, 0), cf(body, 1)) > mul(4.0f, fabsf(cf(body, 2)));
                bool flag = stumb;
                for (int r = 0; r < 4; ++r) {
                    const bool v = b(STUMB, r + 1, i);
                    ring[(n * 5 + r) * nf + i] = v;
                    flag |= v;
                }
                ring[(n * 5 + 4) * nf + i] = stumb;
                s = add(s, (!flag && f(CLEAR, i) > 0.18f) ? 1.0f : 0.0f);
            }
            return s;
        }
        case FEET_SLIP:
            for (int i = 0; i < nf; ++i) {
                const bool filt = b(FC, i) || b(LC, i);
                s = add(s, mul(filt ? 1.0f : 0.0f,
                               sq(norm2(f(FV, i, 0), f(FV, i, 1)))));
            }
            return s;
        case HIP_POS:
            for (int h = 0; h < a.i[I_NHIP]; ++h) {
                s = add(s, sq(f(Q, ldi64(a.in[HIP_IDX], h))));
            }
            return s;
        case POWERCHANGE: {
            const float smooth_co = fmaxf(f(CMD, 0), 1.0f);
            for (int j = 0; j < nq; ++j) s = add(s, fmaxf(mul(f(TAU, j), f(QD, j)), 0.0f));
            return sq(__fdiv_rn(s, mul(mul(f(MASS), 9.815f), smooth_co)));
        }
        case POS_ACC: {
            const float vx = f(BLV, 0), vy = f(BLV, 1), vz = f(BLV, 2);
            const float wx = f(BAV, 0), wy = f(BAV, 1), wz = f(BAV, 2);
            const View& pts = a.in[ACC_PTS];
            for (int k = 0; k < a.i[I_NPTS]; ++k) {
                const float px = ld(pts, k, 0), py = ld(pts, k, 1), pz = ld(pts, k, 2);
                const float ax = add(vx, sub(mul(wy, pz), mul(wz, py)));
                const float ay = add(vy, sub(mul(wz, px), mul(wx, pz)));
                const float az = add(vz, sub(mul(wx, py), mul(wy, px)));
                s = add(s, sq(norm3(ax, ay, az)));
            }
            return s;
        }
        case FOOT_ACC: {
            const float mask = ldi32(a.in[LEVELS], n) > 5 ? 0.2f : 1.0f;
            for (int i = 0; i < nf; ++i) {
                const float ax = mul(sub(f(LFV, i, 0), f(FV, i, 0)), fp[INV_DT]);
                const float ay = mul(sub(f(LFV, i, 1), f(FV, i, 1)), fp[INV_DT]);
                const float az = mul(sub(f(LFV, i, 2), f(FV, i, 2)), fp[INV_DT]);
                s = add(s, fmaxf(mul(mask, sub(norm3(ax, ay, az), fp[MAX_ACC])), 0.0f));
            }
            return s;
        }
        case ORIENTATION:
            orientation_common();
            return sq(sub(f(PG, 0), p_local_x));
        case ORIENTATION_ROLL:
            orientation_common();
            return fabsf(sub(f(PG, 1), p_local_y));
        case BIG_PITCH:
            return fabsf(f(PG, 0)) > 0.6f ? 1.0f : 0.0f;
        case BASE_HEIGHT: {
            for (int i = 0; i < nf; ++i) s = add(s, f(FP, i, 2));
            const float mean = mul(s, 1.0f / (float)nf);
            return sq(sub(sub(f(ROOT_Z), mean), fp[HEIGHT_TARGET]));
        }
        case FOOTHOLD_MISS: {
            float m = f(FP, 0, 2);
            for (int i = 1; i < nf; ++i) m = fminf(m, f(FP, i, 2));
            return m < f(ORIGIN_Z) ? 1.0f : 0.0f;
        }
        case SOFT_TRACKING_LIN_VEL: {
            // commands over the last 3 steps against the velocity 3 back
            const float m = f(LINMAX);
            const int lc = a.i[I_LCMDB], r = a.i[I_LLVB] - 3;
            const float v0 = f(LVB, r, 0), v1 = f(LVB, r, 1);
            for (int k = lc - 3; k < lc; ++k) {
                const float e0 = __fdiv_rn(sub(f(CMDB, k, 0), v0), m);
                const float e1 = __fdiv_rn(sub(f(CMDB, k, 1), v1), m);
                s = add(s, expf(mul(-add(sq(e0), sq(e1)), fp[INV_SIGMA])));
            }
            return mul(s, 1.0f / 3.0f);
        }
        case SOFT_TRACKING_ANG_VEL: {
            const int lc = a.i[I_LCMDB], la = a.i[I_LAVB];
            for (int k = 0; k < 4; ++k) {
                const float e = mul(sub(f(CMDB, lc - 4 + k, 2), f(AVB, la - 4 + k, 0)),
                                    fp[INV_YAW_MAX]);
                const float d = sq(e) <= 0.0225f ? 0.0f : 1.0f;
                s = add(s, expf(mul(-d, fp[INV_SIGMA])));
            }
            return mul(s, 0.25f);
        }
        case TRACKING_OPTIMAL_FOOTHOLDS:
            for (int i = 0; i < nf; ++i) {
                const float dis = norm2(sub(f(FP, i, 0), f(OPT, i, 0)),
                                        sub(f(FP, i, 1), f(OPT, i, 1)));
                s = add(s, b(FILT, i) ? -logf(add(0.8f, dis)) : 0.0f);
            }
            return s;
        }
        return 0.0f;
    }
};

__global__ void rewards_kernel(const __grid_constant__ RewardArgs a) {
    const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    const int N = a.i[I_N];
    if (n >= N) return;
    Env e{a, n, a.i[I_NQ], a.i[I_NF], 0.0f, false, 0.0f, 0.0f, 0.0f};
    e.cmd_norm = norm2(e.f(CMD, 0), e.f(CMD, 1));
    float* sums = reinterpret_cast<float*>(a.out[SUMS]);
    float total = 0.0f;
    for (int k = 0; k < a.i[I_NTERMS]; ++k) {
        const float r = mul(e.term(a.id[k]), a.scale[k]);
        total = add(total, r);
        if (a.row[k] >= 0) {
            float* s = sums + (long long)a.row[k] * N + n;
            *s = add(*s, r);
        }
    }
    if (a.i[I_ONLY_POS]) total = fmaxf(total, 0.0f);
    if (a.i[I_TERM_ON]) {
        const bool term = e.b(RESET) && !e.b(TIMEOUT);
        const float r = mul(term ? 1.0f : 0.0f, a.term_scale);
        total = add(total, r);
        if (a.i[I_TERM_ROW] >= 0) {
            float* s = sums + (long long)a.i[I_TERM_ROW] * N + n;
            *s = add(*s, r);
        }
    }
    reinterpret_cast<float*>(a.out[REW])[n] = total;
    if (a.out[PITCH_OUT] != nullptr) {
        e.orientation_common();
        reinterpret_cast<float*>(a.out[PITCH_OUT])[n] = e.new_pitch;
    }
}

}  // namespace

// views: host int64 [N_IN x (address, s0, s1, s2)]; outs: host int64
// [N_OUT addresses, 0 where not written]; fparams: host float32 [N_F];
// iparams: host int32 [N_I]; ids, rows (the episode-sum row of each term,
// -1 for none): host int32 [n_terms]; scales: host float32 [n_terms].
DTC_EXPORT int dtc_compute_rewards(const void* views, const void* outs,
                                   const void* fparams, const void* iparams,
                                   const void* ids, const void* rows,
                                   const void* scales, float term_scale,
                                   void* stream) {
    const long long* v = (const long long*)views;
    RewardArgs a;
    for (int k = 0; k < N_IN; ++k) {
        a.in[k].p = (const void*)(uintptr_t)v[4 * k];
        a.in[k].s0 = v[4 * k + 1];
        a.in[k].s1 = v[4 * k + 2];
        a.in[k].s2 = v[4 * k + 3];
    }
    for (int k = 0; k < N_OUT; ++k) {
        a.out[k] = (void*)(uintptr_t)((const long long*)outs)[k];
    }
    for (int k = 0; k < N_F; ++k) a.f[k] = ((const float*)fparams)[k];
    for (int k = 0; k < N_I; ++k) a.i[k] = ((const int*)iparams)[k];
    const int nt = a.i[I_NTERMS];
    if (nt < 0 || nt > MAX_TERMS || a.i[I_NF] > MAX_FEET || a.i[I_N] < 0) {
        return (int)cudaErrorInvalidValue;
    }
    for (int k = 0; k < nt; ++k) {
        a.id[k] = ((const int*)ids)[k];
        a.row[k] = ((const int*)rows)[k];
        a.scale[k] = ((const float*)scales)[k];
        if (a.id[k] < 0 || a.id[k] >= N_TERMS) return (int)cudaErrorInvalidValue;
    }
    a.term_scale = term_scale;
    const int N = a.i[I_N];
    if (N > 0) {
        rewards_kernel<<<(N + THREADS - 1) / THREADS, THREADS, 0,
                         (cudaStream_t)stream>>>(a);
    }
    return (int)cudaGetLastError();
}
