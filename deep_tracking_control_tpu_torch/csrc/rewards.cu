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
// rounding only.  The plane fit of the orientation terms (the plain
// version's (N, 693) x (693, 3) matrix product) is a reduction inside the
// kernel: a warp an env over its 693-cell scan row, with the (3, 693)
// pseudo-inverse in shared memory; its order of additions is not
// cuBLAS's, which moves the fit by float rounding only.
//
// Bound on the H100: bytes.  At 4096 envs the call moves 17.0 MB: the
// height scan the plane fit reads (11.4 MB), the step quantities (some
// 300 float32 values an env) and the episode sums read and written, the
// outputs; the work is some thousand float operations an env.  Design:
// a block holds ENVS = 16 envs and a team of TEAM = 16 lanes an env (at
// 4096 envs 256 blocks of 256 threads: every SM holds blocks, 8 warps
// each).
//   1. The block stages its inputs into shared memory with asynchronous
//      copies (cp.async), every copy of a thread in flight at once: its
//      envs' scan rows (16-byte copies where aligned), the plane fit's
//      pseudo-inverse, and each env's row of step quantities, word by word
//      from a plan in the kernel's parameters (the env hands in strided
//      views, often transposed ones; a warp's threads take adjacent envs).
//      The inputs that do not vary with the env (per-joint limits, index
//      tables, acceleration points) are staged once a block.
//   2. A warp an env fits the plane from shared memory.
//   3. The active terms are dealt out across the team's lanes (term k on
//      lane k mod TEAM): lane l of env e is thread l * ENVS + e, so that a
//      warp runs one term for adjacent envs (lanes of one warp run their
//      terms one after the other).  Each term reads shared memory and
//      writes its value there.
//   4. One lane an env adds the values in the reference order (the
//      total's order of additions is the one-thread-an-env kernel's), and
//      the block adds the episode-sum rows with envs adjacent, coalesced.
// A team past N (the ragged tail) stages, computes and writes nothing.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int MAX_TERMS = 40;
constexpr int MAX_FEET = 8;
// the staging plans live in the kernel's parameters, which hold 4 KB
constexpr int MAX_WORDS = 320;    // staged words an env
constexpr int MAX_CWORDS = 160;   // staged constants a block
constexpr int TEAM = 16;          // lanes an env
constexpr int ENVS = 16;          // envs a block
constexpr int THREADS = TEAM * ENVS;
// the rows of the command and velocity buffers that the terms read: the
// wrapper hands in the last BUFFER_ROWS of each
constexpr int BUFFER_ROWS = 4;
static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps a block");

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

// inputs, each a view (address, three strides in elements, the two
// dims past the env's); per-env inputs have the env first, per-joint
// constants are (N, nq) views with a zero env stride.  The inputs before
// FEET_IDX may be staged in shared memory (the wrapper gives each per-env
// one its offset in the env's row there); the scan and the pseudo-inverse
// of the plane fit are read where they lie.
enum In {
    BLV, BAV, PG, Q, QD, LQD, ACT, LACT, LACT2, TAU,    // float32
    CF, AIR, CMD, CMDB, LVB, AVB, DEFQ, SOFT_LO, SOFT_HI, VEL_LIM, TAU_LIM,
    MASS, FP, FV, LFV, CLEAR, PITCH, ACC_PTS, OPT, ROOT_Z, ORIGIN_Z,
    LINMAX,
    FC, LC, FILT, STUMB, RESET, TIMEOUT,                // bool (uint8)
    LEVELS,                                             // int32
    FEET_IDX, PEN_IDX, HIP_IDX,                         // int64
    HSCAN, PINV,                                        // the plane fit (float32)
    N_IN
};
constexpr int N_STAGE = FEET_IDX;   // the inputs that may be staged
enum Out { REW, SUMS, AIR_OUT, STUMB_OUT, PITCH_OUT, N_OUT };
enum FParam {
    DT, INV_DT, INV_SIGMA, INV_YAW_MAX, SOFT_VEL, SOFT_TAU, MAX_CF, MAX_ACC,
    HEIGHT_TARGET, N_F
};
// I_NH: the scan's length (0: no orientation term, no plane fit); I_NC:
// the block's constant words;
// I_W: the words of an env's row in shared memory (odd), I_OFF_PLANE and
// I_OFF_VAL the offsets of its plane fit (3) and of its term values
// (MAX_TERMS, then the termination term's and the total) there
enum IParam {
    I_N, I_NQ, I_NF, I_NPEN, I_NHIP, I_NPTS, I_NTERMS, I_TERM_ON, I_TERM_ROW,
    I_ONLY_POS, I_NH, I_W, I_OFF_PLANE, I_OFF_VAL, I_NC, N_I
};

struct View {
    const void* p;
    int s0, s1, s2;         // strides in elements
    short d1, d2;           // the dims past the env's (an index table's own)
};

// Where each input is read in shared memory: off[k] >= 0 is its offset in
// an env's staged row; else -1 - off[k] is its offset in the block's
// constants (an input with a zero env stride, the acceleration points,
// the index tables), staged once a block.  A staged word is element
// (word & 0xffffff) of input (word >> 24) past the env's first (past the
// table's first for a constant's word).
struct RewardArgs {
    View in[N_IN];
    void* out[N_OUT];
    float f[N_F];
    int i[N_I];
    short off[HSCAN];
    unsigned word[MAX_WORDS];       // an env's row
    unsigned cword[MAX_CWORDS];     // the block's constants
    int id[MAX_TERMS];
    int row[MAX_TERMS];
    float scale[MAX_TERMS];
    float term_scale;
};

// the inputs are read-only for the whole launch: read-only cache loads
__device__ __forceinline__ float ld(const View& v, long long a, long long b = 0) {
    return __ldg(reinterpret_cast<const float*>(v.p) + a * v.s0 + b * v.s1);
}

// element `at` of input k as a 32-bit word (a bool as 0/1, an int32 or
// int64 index as its int32 bits)
__device__ __forceinline__ float load_word(const View& v, int k, long long at) {
    if (k < FC) return __ldg(reinterpret_cast<const float*>(v.p) + at);
    if (k < LEVELS) {
        return __ldg(reinterpret_cast<const unsigned char*>(v.p) + at) != 0 ? 1.0f
                                                                             : 0.0f;
    }
    if (k == LEVELS) return __int_as_float(__ldg(reinterpret_cast<const int*>(v.p) + at));
    return __int_as_float((int)__ldg(reinterpret_cast<const long long*>(v.p) + at));
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
    const float* row;     // the env's row in shared memory
    const float* cst;     // the block's constants in shared memory
    long long n;
    int nq, nf;
    float cmd_norm;       // |commands[:2]|
    bool have_orient;
    float p_local_x, p_local_y, new_pitch;

    // word (b, c) of input k: from the env's staged row, or from the
    // block's constants
    __device__ __forceinline__ float word_at(int k, int b, int c) const {
        const int o = a.off[k], at = b * a.in[k].d2 + c;
        return o >= 0 ? row[o + at] : cst[-1 - o + at];
    }
    __device__ __forceinline__ float f(int k, int b = 0, int c = 0) const {
        return word_at(k, b, c);
    }
    __device__ __forceinline__ bool b(int k, int i = 0, int j = 0) const {
        return word_at(k, i, j) != 0.0f;
    }
    __device__ __forceinline__ int ix(int k, int i = 0) const {
        return __float_as_int(word_at(k, i, 0));
    }
    // contact force component c of body `body`
    __device__ __forceinline__ float cf(int body, int c) const {
        return f(CF, body, c);
    }
    __device__ __forceinline__ int foot(int i) const { return ix(FEET_IDX, i); }

    // the plane-fit pitch/roll estimate and the filtered pitch
    // (_orientation_common, legged_robot.py:1535-1596)
    __device__ __forceinline__ void orientation_common() {
        if (have_orient) return;
        have_orient = true;
        const float X0 = row[a.i[I_OFF_PLANE]], X1 = row[a.i[I_OFF_PLANE] + 1];
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

    // The term loops stay rolled (`#pragma unroll 1`): so the terms ran
    // in less time on the H100 than unrolled (PERF.md, Findings).
    __device__ __forceinline__ float term(int id) {
        const float* fp = a.f;
        float s = 0.0f;
        switch (id) {
        case LIN_VEL_Z:
            return sq(f(BLV, 2));
        case ANG_VEL_XY:
            return add(sq(f(BAV, 0)), sq(f(BAV, 1)));
        case TORQUES:
#pragma unroll 1
            for (int j = 0; j < nq; ++j) s = add(s, sq(f(TAU, j)));
            return s;
        case DOF_VEL:
#pragma unroll 1
            for (int j = 0; j < nq; ++j) s = add(s, sq(f(QD, j)));
            return s;
        case DOF_ACC:
#pragma unroll 1
            for (int j = 0; j < nq; ++j) {
                s = add(s, sq(mul(sub(f(LQD, j), f(QD, j)), fp[INV_DT])));
            }
            return s;
        case ACTION_RATE:
#pragma unroll 1
            for (int j = 0; j < nq; ++j) s = add(s, sq(sub(f(LACT, j), f(ACT, j))));
            return s;
        case COLLISION:
#pragma unroll 1
            for (int p = 0; p < a.i[I_NPEN]; ++p) {
                const int body = ix(PEN_IDX, p);
                s = add(s, norm3(cf(body, 0), cf(body, 1), cf(body, 2)) > 0.1f
                               ? 1.0f : 0.0f);
            }
            return s;
        case DOF_POS_LIMITS:
#pragma unroll 1
            for (int j = 0; j < nq; ++j) {
                const float q = f(Q, j);
                s = add(s, add(-fminf(sub(q, f(SOFT_LO, j)), 0.0f),
                               fmaxf(sub(q, f(SOFT_HI, j)), 0.0f)));
            }
            return s;
        case DOF_VEL_LIMITS:
#pragma unroll 1
            for (int j = 0; j < nq; ++j) {
                const float lim = mul(f(VEL_LIM, j), fp[SOFT_VEL]);
                s = add(s, clampf(sub(fabsf(f(QD, j)), lim), 0.0f, 1.0f));
            }
            return s;
        case TORQUE_LIMITS:
#pragma unroll 1
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
#pragma unroll 1
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
#pragma unroll 1
            for (int i = 0; i < nf; ++i) {
                const int body = foot(i);
                any |= norm2(cf(body, 0), cf(body, 1)) > mul(k, fabsf(cf(body, 2)));
            }
            return any ? 1.0f : 0.0f;
        }
        case STAND_STILL:
#pragma unroll 1
            for (int j = 0; j < nq; ++j) s = add(s, fabsf(sub(f(Q, j), f(DEFQ, j))));
            return mul(s, cmd_norm < 0.1f ? 1.0f : 0.0f);
        case FEET_CONTACT_FORCES:
#pragma unroll 1
            for (int i = 0; i < nf; ++i) {
                const int body = foot(i);
                s = add(s, fmaxf(sub(norm3(cf(body, 0), cf(body, 1), cf(body, 2)),
                                     fp[MAX_CF]), 0.0f));
            }
            return s;
        case POWER:
#pragma unroll 1
            for (int j = 0; j < nq; ++j) s = add(s, fmaxf(mul(f(TAU, j), f(QD, j)), 0.0f));
            return s;
        case SMOOTH:
#pragma unroll 1
            for (int j = 0; j < nq; ++j) {
                s = add(s, sq(add(sub(f(ACT, j), mul(2.0f, f(LACT, j))), f(LACT2, j))));
            }
            return s;
        case FOOT_CLEARANCE: {
            // the 5-deep stumble ring: drop the oldest row, append this one
            uint8_t* ring = reinterpret_cast<uint8_t*>(a.out[STUMB_OUT]);
#pragma unroll 1
            for (int i = 0; i < nf; ++i) {
                const int body = foot(i);
                const bool stumb =
                    norm2(cf(body, 0), cf(body, 1)) > mul(4.0f, fabsf(cf(body, 2)));
                bool flag = stumb;
#pragma unroll 1
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
#pragma unroll 1
            for (int i = 0; i < nf; ++i) {
                const bool filt = b(FC, i) || b(LC, i);
                s = add(s, mul(filt ? 1.0f : 0.0f,
                               sq(norm2(f(FV, i, 0), f(FV, i, 1)))));
            }
            return s;
        case HIP_POS:
#pragma unroll 1
            for (int h = 0; h < a.i[I_NHIP]; ++h) {
                s = add(s, sq(f(Q, ix(HIP_IDX, h))));
            }
            return s;
        case POWERCHANGE: {
            const float smooth_co = fmaxf(f(CMD, 0), 1.0f);
#pragma unroll 1
            for (int j = 0; j < nq; ++j) s = add(s, fmaxf(mul(f(TAU, j), f(QD, j)), 0.0f));
            return sq(__fdiv_rn(s, mul(mul(f(MASS), 9.815f), smooth_co)));
        }
        case POS_ACC: {
            const float vx = f(BLV, 0), vy = f(BLV, 1), vz = f(BLV, 2);
            const float wx = f(BAV, 0), wy = f(BAV, 1), wz = f(BAV, 2);
#pragma unroll 1
            for (int k = 0; k < a.i[I_NPTS]; ++k) {
                const float px = f(ACC_PTS, k, 0), py = f(ACC_PTS, k, 1);
                const float pz = f(ACC_PTS, k, 2);
                const float ax = add(vx, sub(mul(wy, pz), mul(wz, py)));
                const float ay = add(vy, sub(mul(wz, px), mul(wx, pz)));
                const float az = add(vz, sub(mul(wx, py), mul(wy, px)));
                s = add(s, sq(norm3(ax, ay, az)));
            }
            return s;
        }
        case FOOT_ACC: {
            const float mask = ix(LEVELS) > 5 ? 0.2f : 1.0f;
#pragma unroll 1
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
#pragma unroll 1
            for (int i = 0; i < nf; ++i) s = add(s, f(FP, i, 2));
            const float mean = mul(s, 1.0f / (float)nf);
            return sq(sub(sub(f(ROOT_Z), mean), fp[HEIGHT_TARGET]));
        }
        case FOOTHOLD_MISS: {
            float m = f(FP, 0, 2);
#pragma unroll 1
            for (int i = 1; i < nf; ++i) m = fminf(m, f(FP, i, 2));
            return m < f(ORIGIN_Z) ? 1.0f : 0.0f;
        }
        case SOFT_TRACKING_LIN_VEL: {
            // commands over the last 3 steps against the velocity 3 back
            const float m = f(LINMAX);
            const int r = BUFFER_ROWS - 3;
            const float v0 = f(LVB, r, 0), v1 = f(LVB, r, 1);
#pragma unroll 1
            for (int k = BUFFER_ROWS - 3; k < BUFFER_ROWS; ++k) {
                const float e0 = __fdiv_rn(sub(f(CMDB, k, 0), v0), m);
                const float e1 = __fdiv_rn(sub(f(CMDB, k, 1), v1), m);
                s = add(s, expf(mul(-add(sq(e0), sq(e1)), fp[INV_SIGMA])));
            }
            return mul(s, 1.0f / 3.0f);
        }
        case SOFT_TRACKING_ANG_VEL: {
#pragma unroll 1
            for (int k = BUFFER_ROWS - 4; k < BUFFER_ROWS; ++k) {
                const float e = mul(sub(f(CMDB, k, 2), f(AVB, k, 0)),
                                    fp[INV_YAW_MAX]);
                const float d = sq(e) <= 0.0225f ? 0.0f : 1.0f;
                s = add(s, expf(mul(-d, fp[INV_SIGMA])));
            }
            return mul(s, 0.25f);
        }
        case TRACKING_OPTIMAL_FOOTHOLDS:
#pragma unroll 1
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

__global__ void __launch_bounds__(THREADS) rewards_kernel(
        const __grid_constant__ RewardArgs a) {
    extern __shared__ __align__(16) float sm[];
    const int N = a.i[I_N], NH = a.i[I_NH], W = a.i[I_W];
    const int S = a.i[I_OFF_PLANE];                     // staged words an env
    const long long n0 = (long long)blockIdx.x * ENVS;
    const int ne = (int)min((long long)ENVS, N - n0);   // envs of this block
    const int NHP = (NH + 3) & ~3;                      // 16-byte scan rows
    float* scan = sm;                                   // (ENVS, NHP)
    float* pinv = scan + ENVS * NHP;                    // (3, NH)
    float* rows = pinv + 3 * NH;                        // (ENVS, W)
    float* cst = rows + ENVS * W;                       // (I_NC)

    // 1. the block's inputs into shared memory, with asynchronous copies
    // (cp.async: no register round trip, every copy of a thread in flight
    // at once): the plane fit's pseudo-inverse and the envs' scan rows,
    // then the envs' rows of step quantities.
    // Thread (l, e) of the block (l = its lane in env e's team) copies env
    // e's words l, l + TEAM, ...; word w is element a.word[w] & 0xffffff
    // of input a.word[w] >> 24 past the env's first.  A warp's threads
    // take adjacent envs (the env's transposed views of the physics
    // outputs load coalesced) and two words, so its reads of the plan are
    // two addresses.  A bool is loaded and stored as 0/1; then the
    // block's constants (one word a thread).
    if (NH > 0) {
        const View& pv = a.in[PINV];
        for (int c = 0; c < 3; ++c) {
            const float* p = reinterpret_cast<const float*>(pv.p) + (long long)c * pv.s0;
            for (int k = threadIdx.x; k < NH; k += blockDim.x) {
                cp_async4(pinv + c * NH + k, p + (long long)k * pv.s1);
            }
        }
        // the scan rows in 16-byte copies where they are contiguous and
        // aligned (the sampler's output rows are), else word by word
        const View& hv = a.in[HSCAN];
        const float* h = reinterpret_cast<const float*>(hv.p) + n0 * hv.s0;
        const bool by16 = hv.s1 == 1 && (hv.s0 & 3) == 0
                          && (reinterpret_cast<uintptr_t>(h) & 15) == 0;
        const int n16 = by16 ? NH / 4 : 0;
        for (int e = 0; e < ne; ++e) {
            const float* he = h + (long long)e * hv.s0;
            for (int j = threadIdx.x; j < n16; j += blockDim.x) {
                cp_async16(scan + e * NHP + 4 * j, he + 4 * j);
            }
            for (int k = 4 * n16 + threadIdx.x; k < NH; k += blockDim.x) {
                cp_async4(scan + e * NHP + k, he + (long long)k * hv.s1);
            }
        }
    }
    {
        const int l = threadIdx.x / ENVS, e = threadIdx.x - l * ENVS;
        if (e < ne) {
            float* row = rows + e * W;
            for (int w = l; w < S; w += TEAM) {
                const unsigned ent = a.word[w];
                const int k = (int)(ent >> 24);
                const View& v = a.in[k];
                const long long at = (n0 + e) * v.s0 + (ent & 0xffffffu);
                if (k >= FC && k < LEVELS) {
                    row[w] = load_word(v, k, at);
                } else {            // float32, int32: the word's bits
                    cp_async4(row + w, reinterpret_cast<const float*>(v.p) + at);
                }
            }
        }
    }
    for (int c = threadIdx.x; c < a.i[I_NC]; c += blockDim.x) {
        const unsigned ent = a.cword[c];
        const int k = (int)(ent >> 24);
        cst[c] = load_word(a.in[k], k, ent & 0xffffffu);
    }
    cp_async_wait_all();
    __syncthreads();

    // 2. the plane fit, X = pinv @ heights, from shared memory: a warp an
    // env, each lane a strided share of the scan, then a butterfly sum
    if (NH > 0) {
        const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
        for (int e = threadIdx.x >> 5; e < ne; e += nwarps) {
            const float* hs = scan + e * NHP;
            float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f;
            for (int k = lane; k < NH; k += 32) {
                const float h = hs[k];
                x0 = fmaf(h, pinv[k], x0);
                x1 = fmaf(h, pinv[NH + k], x1);
                x2 = fmaf(h, pinv[2 * NH + k], x2);
            }
#pragma unroll
            for (int m = 16; m > 0; m >>= 1) {
                x0 += __shfl_xor_sync(0xffffffffu, x0, m);
                x1 += __shfl_xor_sync(0xffffffffu, x1, m);
                x2 += __shfl_xor_sync(0xffffffffu, x2, m);
            }
            if (lane == 0) {
                float* X = rows + e * W + a.i[I_OFF_PLANE];
                X[0] = x0;
                X[1] = x1;
                X[2] = x2;
            }
        }
    }
    __syncthreads();

    // 3. the terms, dealt out across the team's lanes: lane l of env e is
    // thread l * ENVS + e, so that a warp's threads run one term for
    // adjacent envs (a term per lane of one warp would serialize them)
    const int lane = threadIdx.x / ENVS, e = threadIdx.x - lane * ENVS;
    const int nt = a.i[I_NTERMS];
    float* row = rows + e * W;
    float* val = row + a.i[I_OFF_VAL];
    Env env{a, row, cst, n0 + e, a.i[I_NQ], a.i[I_NF], 0.0f, false, 0.0f,
            0.0f, 0.0f};
    if (e < ne) {
        env.cmd_norm = norm2(env.f(CMD, 0), env.f(CMD, 1));
        for (int k = lane; k < nt; k += TEAM) {
            val[k] = mul(env.term(a.id[k]), a.scale[k]);
        }
        // the pitch filter's state, from the lane(s) of the orientation
        // terms (the wrapper asks for it exactly when one is active; two
        // lanes write the same value)
        if (env.have_orient && a.out[PITCH_OUT] != nullptr) {
            reinterpret_cast<float*>(a.out[PITCH_OUT])[n0 + e] = env.new_pitch;
        }
    }
    __syncthreads();

    // 4. the total on one lane, in the reference order
    if (e < ne && lane == 0) {
        float total = 0.0f;
        for (int k = 0; k < nt; ++k) total = add(total, val[k]);
        if (a.i[I_ONLY_POS]) total = fmaxf(total, 0.0f);
        if (a.i[I_TERM_ON]) {
            const bool term = env.b(RESET) && !env.b(TIMEOUT);
            const float r = mul(term ? 1.0f : 0.0f, a.term_scale);
            val[nt] = r;
            total = add(total, r);
        }
        val[MAX_TERMS + 1] = total;
    }
    __syncthreads();

    // 5. the outputs with envs adjacent: the reward, then each term's row
    // of the episode sums (the termination term's last)
    for (int i = threadIdx.x; i < ne; i += blockDim.x) {
        reinterpret_cast<float*>(a.out[REW])[n0 + i] =
            rows[i * W + a.i[I_OFF_VAL] + MAX_TERMS + 1];
    }
    float* sums = reinterpret_cast<float*>(a.out[SUMS]);
    const int nv = nt + (a.i[I_TERM_ON] ? 1 : 0);
    for (int idx = threadIdx.x; idx < nv * ne; idx += blockDim.x) {
        const int k = idx / ne, i = idx - k * ne;
        const int r = k < nt ? a.row[k] : a.i[I_TERM_ROW];
        if (r >= 0) {
            float* s = sums + (long long)r * N + n0 + i;
            *s = add(*s, rows[i * W + a.i[I_OFF_VAL] + k]);
        }
    }
}

}  // namespace

// views: host int64 [N_IN x (address, s0, s1, s2, d1, d2)]; outs: host
// int64 [N_OUT addresses, 0 where not written]; fparams: host float32
// [N_F]; iparams: host int32 [N_I]; offs: host int32 [HSCAN] (RewardArgs
// `off`); words, cwords: host uint32 [I_OFF_PLANE], [I_NC] (the staging
// plans of an env's row and of the block's constants); ids,
// rows (the episode-sum row of each term, -1 for none): host int32
// [n_terms]; scales: host float32 [n_terms].  Shared memory: ENVS scan
// rows (I_NH rounded up to 4), the pseudo-inverse (3 x I_NH), ENVS rows
// of I_W words, the I_NC constants.
DTC_EXPORT int dtc_compute_rewards(const void* views, const void* outs,
                                   const void* fparams, const void* iparams,
                                   const void* offs, const void* words,
                                   const void* cwords, const void* ids,
                                   const void* rows, const void* scales,
                                   float term_scale, void* stream) {
    const long long* v = (const long long*)views;
    RewardArgs a;
    for (int k = 0; k < N_IN; ++k) {
        const long long* t = v + 6 * k;
        a.in[k].p = (const void*)(uintptr_t)t[0];
        for (int j = 1; j < 6; ++j) {
            if (t[j] < 0 || t[j] > (j < 4 ? 0x7fffffffLL : 0x7fffLL)) {
                return (int)cudaErrorInvalidValue;
            }
        }
        a.in[k].s0 = (int)t[1];
        a.in[k].s1 = (int)t[2];
        a.in[k].s2 = (int)t[3];
        a.in[k].d1 = (short)t[4];
        a.in[k].d2 = (short)t[5];
    }
    for (int k = 0; k < N_OUT; ++k) {
        a.out[k] = (void*)(uintptr_t)((const long long*)outs)[k];
    }
    for (int k = 0; k < N_F; ++k) a.f[k] = ((const float*)fparams)[k];
    for (int k = 0; k < N_I; ++k) a.i[k] = ((const int*)iparams)[k];
    for (int k = 0; k < HSCAN; ++k) a.off[k] = (short)((const int*)offs)[k];
    const int nw = a.i[I_OFF_PLANE], nc = a.i[I_NC];
    if (nw < 0 || nw > MAX_WORDS || nc < 0 || nc > MAX_CWORDS) {
        return (int)cudaErrorInvalidValue;
    }
    for (int w = 0; w < nw; ++w) {
        a.word[w] = ((const unsigned*)words)[w];
        if ((int)(a.word[w] >> 24) >= N_STAGE) return (int)cudaErrorInvalidValue;
    }
    for (int c = 0; c < nc; ++c) {
        a.cword[c] = ((const unsigned*)cwords)[c];
        if ((int)(a.cword[c] >> 24) >= HSCAN) return (int)cudaErrorInvalidValue;
    }
    const int nt = a.i[I_NTERMS];
    if (nt < 0 || nt > MAX_TERMS || a.i[I_NF] > MAX_FEET || a.i[I_N] < 0
            || a.i[I_W] < a.i[I_OFF_VAL] + MAX_TERMS + 2) {
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
    const size_t NHP = ((size_t)a.i[I_NH] + 3) & ~(size_t)3;
    const size_t smem = sizeof(float) * (3 * (size_t)a.i[I_NH] + ENVS * NHP
                                         + (size_t)ENVS * a.i[I_W] + nc);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            rewards_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    if (N > 0) {
        rewards_kernel<<<(N + ENVS - 1) / ENVS, THREADS, smem,
                         (cudaStream_t)stream>>>(a);
    }
    return (int)cudaGetLastError();
}
