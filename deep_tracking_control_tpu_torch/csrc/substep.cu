// The physics decimation step: all `decimation` substeps of one policy
// step in one launch.
//
// Replaces the JAX package's Pallas kernels physics/pallas_substep.py
// (decimation_step -> _substep_kernel_fused and _substep_kernel ->
// _substep_body).  Each
// substep: PD torque (motor strength and offset, clipped at 0.8 x effort)
// plus the joint-limit spring; FK of the 13 bodies; world state of the
// contact points; terrain under each point (feet: bilinear height + slope
// from a 16x16-cell band of the env's 40x128 contact window, placed at
// substep 0 and clamped beyond its edge; body points: the frozen plane of
// the previous step); implicit penalty normal + stiction-anchor friction
// with cliff/rim support; per-body spatial force sums; the leg-batched
// articulated-body algorithm with the 6x6 LDL^T base solve; semi-implicit
// integration with the exponential-map quaternion update.
//
// Bound on the H100: the latency of a long serial program per env.  At
// 4096 envs there is little parallelism to hide it (a few warps an SM at
// most), so what counts is how many SMs work and how long each thread's
// chain is.  Design: a team of four lanes steps one env, one lane per leg:
// lane `leg` owns its three joints (PD torque, limit spring, integration),
// its leg's FK chain, the contact points on its leg (per the owner table
// packed after the points; its foot among them), the leg's ABA backward
// pass and, after the base solve, its forward pass.  Every lane computes
// the base itself (rotation, body velocity, the base's articulated
// inertia plus the four legs' in leg order, exchanged by warp shuffles,
// the 6x6 LDL^T solve, the base integration), so the team's base values
// are bit for bit the same and no lane waits on shared memory.  The torso
// points are spread over the team; their forces are exchanged and summed
// in point order, so every per-body sum keeps the plain version's order.
// 32 envs a 128-thread block: 128 blocks at 4096 envs, one an SM.  A lane
// holds 4 bodies' kinematics where one thread held 13.  The env-trailing
// (k, N) arrays are read and written as they come; each foot reads its
// four terrain cells straight from the blocked raw table (the fused
// variant: the TPU kernel's window DMA has no counterpart) or from a
// materialized (N, 40, 128) contact window read through its strides (the
// window variant, dtc_decimation_step_window: a view of the patch copy or
// the window copy, no transpose); the two are one template, the same
// arithmetic on the same cells; the per-robot constants come from one
// packed float32 table (physics/cuda_substep.py pack_constants).
// Divisions by a Python scalar in the plain version are multiplications
// by its float32 reciprocal here, as PyTorch computes them on the card.
// The source is one template on its scalar type: the kernel is its float
// build; dtc_decimation_step_f64, its double build, reads the same float32
// terrain and constant tables and computes everything else in double, to
// hold the kernel's arithmetic to the plain version's where float32 does
// not resolve a step to the budget (the X30's).  It is no route of the env.
#include "common.cuh"

namespace {

constexpr int NQ = 12;
constexpr int NF = 4;
constexpr int PC = 128;      // table columns
constexpr int WIN_R0 = 16;   // contact window rows [r0+16, r0+56)
constexpr int MAXP = 32;
constexpr int MAXRB = 32;
constexpr int LANES = 4;         // a team: one lane per leg
constexpr int MAX_THREADS = 128;
constexpr int MAXLP = 3;         // contact points on one leg
constexpr int MAXTS = 2;         // torso points a lane

// packed constant table: scalars, then per-joint rows, layout, points;
// after the points' rows, each point's owner: leg + LANES * (depth + 1)
// for a point on a leg body, its lane (torso points in turn) for the torso
enum {
    S_DT, S_G, S_K, S_CD, S_FMAX, S_ARM, S_JF, S_LK, S_LD, S_KT, S_CT,
    S_NCAP, S_CLIFF, S_CDEPTH, S_HS, S_INV_HS, S_KDT, S_KTDT, S_INV_KT,
    S_HALF_DT
};
constexpr int C_LO = 24, C_HI = 36, C_TLIM = 48, C_VLIM = 60;
constexpr int C_AXIS = 72, C_R = 81, C_BODY = 117, C_JOINT = 129;
constexpr int C_THIGH = 141, C_PTS = 145;

// real: float in the kernel, double in its float64 build; the terrain
// tables and the constant table are float32 in both
template <typename real>
struct Args {
    const real *q, *qd, *pos, *quat, *lin, *ang, *anchors, *inertias;
    const real *goals, *kp, *kd, *strength, *offset, *friction;
    const real* restitution;
    const float* blocks;
    const int* starts;
    const real *worigin, *planes;
    const float* consts;
    const float* window;            // the window variant's (N, 40, 128)
    long long wsN, wsR, wsC;        // its strides, in elements
    real *q_o, *qd_o, *pos_o, *quat_o, *lin_o, *ang_o, *anchors_o;
    real *report_o, *footpos_o, *footvel_o, *thigh_o, *tau_o, *bodypts_o;
    int N, P, nrb, decimation, B, Rp;
};

// The math of the kernel in float (the float intrinsics it calls) or in
// double, by the type of its arguments: one source for both builds.
template <typename T>
__device__ __forceinline__ T m_floor(T x) {
    if constexpr (sizeof(T) == 4) return floorf(x); else return floor(x);
}
template <typename T>
__device__ __forceinline__ T m_fabs(T x) {
    if constexpr (sizeof(T) == 4) return fabsf(x); else return fabs(x);
}
template <typename T>
__device__ __forceinline__ T m_sqrt(T x) {
    if constexpr (sizeof(T) == 4) return sqrtf(x); else return sqrt(x);
}
template <typename T>
__device__ __forceinline__ T m_rsqrt(T x) {
    if constexpr (sizeof(T) == 4) return rsqrtf(x); else return rsqrt(x);
}
template <typename T>
__device__ __forceinline__ T m_sin(T x) {
    if constexpr (sizeof(T) == 4) return sinf(x); else return sin(x);
}
template <typename T>
__device__ __forceinline__ T m_cos(T x) {
    if constexpr (sizeof(T) == 4) return cosf(x); else return cos(x);
}
template <typename A, typename B>
__device__ __forceinline__ decltype(A() + B()) m_fmin(A a, B b) {
    if constexpr (sizeof(a + b) == 4) return fminf(a, b);
    else return fmin((double)a, (double)b);
}
template <typename A, typename B>
__device__ __forceinline__ decltype(A() + B()) m_fmax(A a, B b) {
    if constexpr (sizeof(a + b) == 4) return fmaxf(a, b);
    else return fmax((double)a, (double)b);
}
template <typename T, typename B>
__device__ __forceinline__ T m_clamp(T x, B lo, B hi) {   // clampf's order
    return m_fmin(m_fmax(x, lo), hi);
}

// ---- 3-vectors and 3x3 matrices (row-major [9]) --------------------------
// (each operand its own element type: a per-robot constant is float32 in
// both builds)

template <typename A, typename B, typename O>
__device__ __forceinline__ void cross(const A* a, const B* b, O* o) {
    o[0] = a[1] * b[2] - a[2] * b[1];
    o[1] = a[2] * b[0] - a[0] * b[2];
    o[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename M, typename V, typename O>
__device__ __forceinline__ void rmul(const M* R, const V* v, O* o) {
    for (int i = 0; i < 3; ++i)
        o[i] = R[3 * i] * v[0] + R[3 * i + 1] * v[1] + R[3 * i + 2] * v[2];
}

template <typename M, typename V, typename O>
__device__ __forceinline__ void rtmul(const M* R, const V* v, O* o) {
    for (int i = 0; i < 3; ++i)
        o[i] = R[i] * v[0] + R[3 + i] * v[1] + R[6 + i] * v[2];
}

template <typename MA, typename MB, typename O>
__device__ __forceinline__ void mmul3(const MA* A, const MB* B, O* C) {
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j]
                         + A[3 * i + 2] * B[6 + j];
}

template <typename M, typename O>
__device__ __forceinline__ void transpose3(const M* A, O* T) {
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) T[3 * i + j] = A[3 * j + i];
}

// Rodrigues rotation by angle q about the unit axis ax (ops/spatial.py).
template <typename A, typename real>
__device__ __forceinline__ void axis_rotation(const A* ax, real q, real* R) {
    const real c = m_cos(q), s = m_sin(q), C = 1.0f - c;
    const real x = ax[0], y = ax[1], z = ax[2];
    R[0] = c + x * x * C;     R[1] = x * y * C - z * s; R[2] = x * z * C + y * s;
    R[3] = y * x * C + z * s; R[4] = c + y * y * C;     R[5] = y * z * C - x * s;
    R[6] = z * x * C - y * s; R[7] = z * y * C + x * s; R[8] = c + z * z * C;
}

template <typename real>
__device__ __forceinline__ void quat_to_rotmat(const real* q, real* m) {
    const real x = q[0], y = q[1], z = q[2], w = q[3];
    const real xx = x * x, yy = y * y, zz = z * z;
    const real xy = x * y, xz = x * z, yz = y * z;
    const real wx = w * x, wy = w * y, wz = w * z;
    m[0] = 1.0f - 2.0f * (yy + zz); m[1] = 2.0f * (xy - wz); m[2] = 2.0f * (xz + wy);
    m[3] = 2.0f * (xy + wz); m[4] = 1.0f - 2.0f * (xx + zz); m[5] = 2.0f * (yz - wx);
    m[6] = 2.0f * (xz - wy); m[7] = 2.0f * (yz + wx); m[8] = 1.0f - 2.0f * (xx + yy);
}

// ---- spatial algebra (ops/spatial.py), vectors [6] -----------------------

// motion vector, parent -> child coords
template <typename ME, typename R, typename MV, typename O>
__device__ __forceinline__ void xm_apply(const ME* E, const R* r,
                                         const MV* m, O* o) {
    O rw[3], t[3];
    rmul(E, m, o);
    cross(r, m, rw);
    for (int i = 0; i < 3; ++i) t[i] = m[3 + i] - rw[i];
    rmul(E, t, o + 3);
}

// force vector, child -> parent coords
template <typename ME, typename R, typename MV, typename O>
__device__ __forceinline__ void xf_inv_apply(const ME* E, const R* r,
                                             const MV* f, O* o) {
    O en[3], rf[3];
    rtmul(E, f + 3, o + 3);
    rtmul(E, f, en);
    cross(r, o + 3, rf);
    for (int i = 0; i < 3; ++i) o[i] = en[i] + rf[i];
}

template <typename V, typename M, typename O>
__device__ __forceinline__ void crm(const V* v, const M* m, O* o) {
    O a[3], b[3];
    cross(v, m, o);
    cross(v + 3, m, a);
    cross(v, m + 3, b);
    for (int i = 0; i < 3; ++i) o[3 + i] = a[i] + b[i];
}

template <typename V, typename M, typename O>
__device__ __forceinline__ void crf(const V* v, const M* f, O* o) {
    O a[3], b[3];
    cross(v, f, a);
    cross(v + 3, f + 3, b);
    for (int i = 0; i < 3; ++i) o[i] = a[i] + b[i];
    cross(v, f + 3, o + 3);
}

template <typename MI, typename MV, typename O>
__device__ __forceinline__ void imul(const MI* I, const MV* m, O* o) {
    for (int i = 0; i < 6; ++i) {
        O acc = I[6 * i] * m[0];
        for (int j = 1; j < 6; ++j) acc = acc + I[6 * i + j] * m[j];
        o[i] = acc;
    }
}

// Articulated inertia, child -> parent coords, block-wise (Featherstone 2.66)
template <typename T, typename R>
__device__ void inertia_to_parent(const T* E, const R* r, const T* I, T* O) {
    T A[9], Bm[9], Cm[9], D[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            A[3 * i + j] = I[6 * i + j];
            Bm[3 * i + j] = I[6 * i + 3 + j];
            Cm[3 * i + j] = I[6 * (i + 3) + j];
            D[3 * i + j] = I[6 * (i + 3) + 3 + j];
        }
    const R rh[9] = {0.0f, -r[2], r[1], r[2], 0.0f, -r[0], -r[1], r[0], 0.0f};
    T F[9], Et[9], Ft[9], t1[9], t2[9], AE_BF[9], CE_DF[9], DE[9];
    mmul3(E, rh, F);
    for (int i = 0; i < 9; ++i) F[i] = -F[i];
    transpose3(E, Et);
    transpose3(F, Ft);
    mmul3(A, E, t1); mmul3(Bm, F, t2);
    for (int i = 0; i < 9; ++i) AE_BF[i] = t1[i] + t2[i];
    mmul3(Cm, E, t1); mmul3(D, F, t2);
    for (int i = 0; i < 9; ++i) CE_DF[i] = t1[i] + t2[i];
    mmul3(D, E, DE);
    T bl[9], tl[9], br[9];
    mmul3(Et, CE_DF, bl);
    mmul3(Et, AE_BF, t1); mmul3(Ft, CE_DF, t2);
    for (int i = 0; i < 9; ++i) tl[i] = t1[i] + t2[i];
    mmul3(Et, DE, br);
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            O[6 * i + j] = tl[3 * i + j];
            O[6 * i + 3 + j] = bl[3 * j + i];
            O[6 * (i + 3) + j] = bl[3 * i + j];
            O[6 * (i + 3) + 3 + j] = br[3 * i + j];
        }
}

// A x = b for SPD 6x6 A by unrolled LDL^T (ops/spatial.py solve_spd6)
template <typename T>
__device__ void solve_spd6(const T* A, const T* b, T* x) {
    T L[6][6], Dg[6], y[6];
    for (int j = 0; j < 6; ++j) {
        T d = A[7 * j] + 1e-8f;
        for (int k = 0; k < j; ++k) d = d - L[j][k] * L[j][k] * Dg[k];
        Dg[j] = d;
        const T inv_d = 1.0f / d;
        for (int i = j + 1; i < 6; ++i) {
            T s = A[6 * i + j];
            for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k] * Dg[k];
            L[i][j] = s * inv_d;
        }
    }
    for (int i = 0; i < 6; ++i) {
        T s = b[i];
        for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
        y[i] = s;
    }
    for (int i = 5; i >= 0; --i) {
        T s = y[i] / Dg[i];
        for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
        x[i] = s;
    }
}

// ---- one contact point ---------------------------------------------------

// World state of point p on a body (Rb, Xb, Vb), the terrain under it, the
// anchored penalty contact (physics/engine.py heightfield_contact) and the
// spatial force it puts on its body (tq, f: world-aligned at the body's
// origin).  A foot (p < NF) samples its band of the contact window, the
// band placed at substep 0; a body point its frozen plane.
template <bool MAYBE_FOOT, typename real>
__device__ __forceinline__ void point_contact(
        const Args<real>& a, const float* c, int p, int s, long N, long n,
        const real* Rb, const real* Xb, const real* Vb, real& anc_x,
        real& anc_y, real& band_r, real& band_c, const float* win,
        long long rs, long long cs, real wox, real woy, real fric,
        real rest, real* f, real* tq, real* pp, real* pv) {
    const int P = a.P;
    const real dt = c[S_DT];
    const float* o3 = c + C_PTS + 2 * P + 3 * p;
    real t[3], vb[3];
    rmul(Rb, o3, t);
    for (int i = 0; i < 3; ++i) pp[i] = Xb[i] + t[i];
    cross(Vb, o3, t);
    for (int i = 0; i < 3; ++i) vb[i] = Vb[3 + i] + t[i];
    rmul(Rb, vb, pv);

    real h, dhdx, dhdy, hmax;
    if (MAYBE_FOOT && p < NF) {
        const real fr = (pp[0] - wox) * c[S_INV_HS];
        const real fc = (pp[1] - woy) * c[S_INV_HS];
        if (s == 0) {
            band_r = m_clamp(m_floor((fr - 2.0f) * 0.125f), 0.0f, 3.0f) * 8.0f;
            band_c = m_clamp(m_floor((fc - 2.0f) * 0.125f), 0.0f, 14.0f) * 8.0f;
        }
        const real lfr = m_clamp(fr - band_r, 0.0f, 14.999f);
        const real lfc = m_clamp(fc - band_c, 0.0f, 14.999f);
        const real i0 = m_floor(lfr), j0 = m_floor(lfc);
        const real tx = lfr - i0, ty = lfc - j0;
        const float* cp = win + (long long)(band_r + i0) * rs
                        + (long long)(band_c + j0) * cs;
        const real c00 = cp[0], c01 = cp[cs], c10 = cp[rs], c11 = cp[rs + cs];
        h = c00 * (1.0f - tx) * (1.0f - ty) + c10 * tx * (1.0f - ty)
          + c01 * (1.0f - tx) * ty + c11 * tx * ty;
        dhdx = m_clamp(((c10 - c00) * (1.0f - ty) + (c11 - c01) * ty) * c[S_INV_HS],
                      -3.0f, 3.0f);
        dhdy = m_clamp(((c01 - c00) * (1.0f - tx) + (c11 - c10) * tx) * c[S_INV_HS],
                      -3.0f, 3.0f);
        hmax = m_fmax(m_fmax(c00, c10), m_fmax(c01, c11));
    } else {
        const real* pl = a.planes + (long)(p - NF) * 5 * N + n;
        h = pl[0] + pl[N] * (pp[0] - pl[3 * N]) + pl[2 * N] * (pp[1] - pl[4 * N]);
        dhdx = pl[N];
        dhdy = pl[2 * N];
        hmax = h;
    }

    const real zr = pp[2] - c[C_PTS + p];
    const bool cliff = m_fabs(dhdx) >= c[S_CLIFF] || m_fabs(dhdy) >= c[S_CLIFF];
    const bool sup = cliff && (hmax - zr) < c[S_CDEPTH];
    const real h_eff = sup ? hmax : h;
    const real ncap = c[S_NCAP];
    const real gx = sup ? 0.0f : (cliff ? dhdx : m_clamp(dhdx, -ncap, ncap));
    const real gy = sup ? 0.0f : (cliff ? dhdy : m_clamp(dhdy, -ncap, ncap));
    real nx = -gx, ny = -gy;
    const real inv_norm = m_rsqrt(nx * nx + ny * ny + 1.0f);
    nx = nx * inv_norm;
    ny = ny * inv_norm;
    const real nz = inv_norm;
    const real pen = h_eff - zr;
    const real vn = pv[0] * nx + pv[1] * ny + pv[2] * nz;
    const real active = (pen > 0.0f && pen < 0.5f) ? 1.0f : 0.0f;
    const real m = c[C_PTS + P + p];
    const real damp = vn < 0.0f ? c[S_CD] : c[S_CD] * (1.0f - rest);
    const real denom = 1.0f + (c[S_KDT] + damp) * dt / m;
    real fn = (c[S_K] * pen - (c[S_KDT] + damp) * vn) / denom;
    fn = m_clamp(fn, 0.0f, c[S_FMAX]) * active;
    const real inv_t = 1.0f / (1.0f + c[S_KTDT] / m);
    const real disp_x = pp[0] - anc_x, disp_y = pp[1] - anc_y;
    real ftx = -(c[S_KT] * disp_x + c[S_CT] * pv[0]) * inv_t;
    real fty = -(c[S_KT] * disp_y + c[S_CT] * pv[1]) * inv_t;
    const real ft_mag = m_sqrt(ftx * ftx + fty * fty + 1e-12f);
    const real scale = m_fmin(1.0f, fric * fn / ft_mag);
    ftx = ftx * scale * active;
    fty = fty * scale * active;
    const bool is_active = active > 0.0f;
    const bool slip = scale < 1.0f && is_active;
    if (slip) {
        anc_x = pp[0] + ftx * c[S_INV_KT];
        anc_y = pp[1] + fty * c[S_INV_KT];
    } else if (!is_active) {
        anc_x = pp[0];
        anc_y = pp[1];
    }
    f[0] = nx * fn + ftx;
    f[1] = ny * fn + fty;
    f[2] = nz * fn;
    real arm[3];
    for (int i = 0; i < 3; ++i) arm[i] = pp[i] - Xb[i];
    cross(arm, f, tq);
}

// ---- the kernel -------------------------------------------------------

// A team of LANES threads steps one env: lane `leg` owns that leg's joints,
// bodies and contact points; every lane computes the base.  The teams of a
// warp are consecutive envs.  A team past the last env steps env N-1 again
// (every shuffle takes the whole warp) and writes nothing.
template <bool WINDOW, typename real>
__global__ void __launch_bounds__(MAX_THREADS) substep_kernel(Args<real> a) {
    __shared__ real s_force[MAX_THREADS / LANES][MAXP * 3];   // last substep
    const unsigned FULL = 0xffffffffu;
    const long N = a.N;
    const int leg = threadIdx.x & (LANES - 1);
    const int team = threadIdx.x / LANES;
    long n = (long)blockIdx.x * (blockDim.x / LANES) + team;
    const bool valid = n < N;
    if (!valid) n = N - 1;
    const float* c = a.consts;
    const int P = a.P;
    const real dt = c[S_DT];
    const float* c_rep = c + C_PTS + 6 * P;
    const float* c_own = c + C_PTS + 7 * P;

    // this lane's points, in point order: on its leg (body depth from the
    // owner table) and on the torso (every LANES-th torso point)
    int lp[MAXLP], ld[MAXLP], tp[MAXTS];
    int n_torso = 0;
    {
        unsigned legm = 0u, torm = 0u;
        for (int p = 0; p < P; ++p) {
            const int code = (int)c_own[p];
            n_torso += code < LANES;
            if ((code & (LANES - 1)) == leg)
                (code < LANES ? torm : legm) |= 1u << p;
        }
#pragma unroll
        for (int k = 0; k < MAXLP; ++k) {
            lp[k] = legm ? __ffs(legm) - 1 : -1;
            ld[k] = legm ? (int)c_own[lp[k]] / LANES - 1 : 0;
            legm &= legm - 1u;
        }
#pragma unroll
        for (int k = 0; k < MAXTS; ++k) {
            tp[k] = torm ? __ffs(torm) - 1 : -1;
            torm &= torm - 1u;
        }
    }

    // the lane's three joints, base to foot
    int jn[3];
    real q[3], qd[3], kp[3], kd[3], st[3], off[3], tau[3], tau_eff[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
        const int j = (int)c[C_JOINT + 4 * d + leg];
        jn[d] = j;
        q[d] = a.q[j * N + n];
        qd[d] = a.qd[j * N + n];
        kp[d] = a.kp[j * N + n];
        kd[d] = a.kd[j * N + n];
        st[d] = a.strength[j * N + n];
        off[d] = a.offset[j * N + n];
    }
    real pos[3], quat[4], lin[3], ang[3];
    for (int i = 0; i < 3; ++i) {
        pos[i] = a.pos[i * N + n];
        lin[i] = a.lin[i * N + n];
        ang[i] = a.ang[i * N + n];
    }
    for (int i = 0; i < 4; ++i) quat[i] = a.quat[i * N + n];
    real anc[MAXLP][2], band[MAXLP][2], tanc[MAXTS][2];
#pragma unroll
    for (int k = 0; k < MAXLP; ++k) {
        const int p = lp[k] < 0 ? 0 : lp[k];
        anc[k][0] = a.anchors[(2 * p) * N + n];
        anc[k][1] = a.anchors[(2 * p + 1) * N + n];
        band[k][0] = band[k][1] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < MAXTS; ++k) {
        const int p = tp[k] < 0 ? 0 : tp[k];
        tanc[k][0] = a.anchors[(2 * p) * N + n];
        tanc[k][1] = a.anchors[(2 * p + 1) * N + n];
    }
    const real fric = a.friction[n], rest = a.restitution[n];
    const real wox = a.worigin[n], woy = a.worigin[N + n];
    // the foot cells: window row i, column j at win + i * rs + j * cs
    const float* win;
    long long rs, cs;
    if constexpr (WINDOW) {
        win = a.window + n * a.wsN;
        rs = a.wsR;
        cs = a.wsC;
    } else {
        const long r0 = a.starts[2 * n], blk = a.starts[2 * n + 1];
        win = a.blocks + (blk * (long)a.Rp + r0 + WIN_R0) * PC;   // table 0
        rs = PC;
        cs = 1;
    }

    for (int s = 0; s < a.decimation; ++s) {
        const bool last = (s == a.decimation - 1);
        // ---- PD torques + joint-limit spring (the lane's joints) --------
#pragma unroll
        for (int d = 0; d < 3; ++d) {
            const int j = jn[d];
            const real goal = a.goals[((long)s * NQ + j) * N + n];
            const real tlim = c[C_TLIM + j], lo = c[C_LO + j], hi = c[C_HI + j];
            real t = kp[d] * (goal - q[d] + off[d]) - kd[d] * qd[d];
            t = m_fmax(m_fmin(t * st[d], tlim), -tlim);
            tau[d] = t;
            const real beyond = (q[d] < lo || q[d] > hi) ? 1.0f : 0.0f;
            const real tl = c[S_LK] * (m_fmax(lo - q[d], 0.0f) - m_fmax(q[d] - hi, 0.0f))
                           - c[S_LD] * qd[d] * beyond;
            tau_eff[d] = t + tl;
        }

        // ---- FK: the base (every lane), then the lane's leg -------------
        real R0[9], V0[6];
        quat_to_rotmat(quat, R0);
        rtmul(R0, ang, V0);
        rtmul(R0, lin, V0 + 3);
        real R[3][9], X[3][3], V[3][6], E[3][9];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
            const float* ax = c + C_AXIS + 3 * d;
            const float* r = c + C_R + 3 * (4 * d + leg);
            const real* Rp = d == 0 ? R0 : R[d - 1];
            const real* Xp = d == 0 ? pos : X[d - 1];
            const real* Vp = d == 0 ? V0 : V[d - 1];
            real Rj[9], t[3];
            axis_rotation(ax, q[d], Rj);
            transpose3(Rj, E[d]);
            xm_apply(E[d], r, Vp, V[d]);
            for (int i = 0; i < 3; ++i) V[d][i] = V[d][i] + ax[i] * qd[d];
            mmul3(Rp, Rj, R[d]);
            rmul(Rp, r, t);
            for (int i = 0; i < 3; ++i) X[d][i] = Xp[i] + t[i];
        }

        // ---- contact points and the per-body force sums ------------------
        real fext[3][6], fext0[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) {
            fext0[i] = 0.0f;
            fext[0][i] = fext[1][i] = fext[2][i] = 0.0f;
        }
        real* my_force = s_force[team];
#pragma unroll
        for (int k = 0; k < MAXLP; ++k) {
            const int p = lp[k];
            if (p < 0) break;
            const int d = ld[k];
            real Rb[9], Xb[3], Vb[6];
            for (int i = 0; i < 9; ++i)
                Rb[i] = d == 0 ? R[0][i] : (d == 1 ? R[1][i] : R[2][i]);
            for (int i = 0; i < 3; ++i)
                Xb[i] = d == 0 ? X[0][i] : (d == 1 ? X[1][i] : X[2][i]);
            for (int i = 0; i < 6; ++i)
                Vb[i] = d == 0 ? V[0][i] : (d == 1 ? V[1][i] : V[2][i]);
            real f[3], tq[3], pp[3], pv[3];
            point_contact<true>(a, c, p, s, N, n, Rb, Xb, Vb, anc[k][0],
                                anc[k][1], band[k][0], band[k][1], win, rs, cs,
                                wox, woy, fric, rest, f, tq, pp, pv);
#pragma unroll
            for (int dd = 0; dd < 3; ++dd)
                if (d == dd)
                    for (int i = 0; i < 3; ++i) {
                        fext[dd][i] = fext[dd][i] + tq[i];
                        fext[dd][3 + i] = fext[dd][3 + i] + f[i];
                    }
            if (last) {
                for (int i = 0; i < 3; ++i) my_force[3 * p + i] = f[i];
                if (valid) {
                    if (p < NF) {
                        for (int i = 0; i < 3; ++i) {
                            a.footpos_o[(3 * p + i) * N + n] = pp[i];
                            a.footvel_o[(3 * p + i) * N + n] = pv[i];
                        }
                    } else {
                        for (int i = 0; i < 3; ++i)
                            a.bodypts_o[(3 * (p - NF) + i) * N + n] = pp[i];
                    }
                }
            }
        }
        // torso points: LANES at a time, one a lane; their forces go to
        // every lane and into fext[0] in point order
#pragma unroll
        for (int k = 0; k < MAXTS; ++k) {
            if (LANES * k >= n_torso) break;
            real w[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
            const int p = tp[k];
            if (p >= 0) {
                real f[3], tq[3], pp[3], pv[3], unused_r, unused_c;
                point_contact<false>(a, c, p, s, N, n, R0, pos, V0, tanc[k][0],
                                     tanc[k][1], unused_r, unused_c, win, rs,
                                     cs, wox, woy, fric, rest, f, tq, pp, pv);
                for (int i = 0; i < 3; ++i) {
                    w[i] = tq[i];
                    w[3 + i] = f[i];
                }
                if (last) {
                    for (int i = 0; i < 3; ++i) my_force[3 * p + i] = f[i];
                    if (valid)
                        for (int i = 0; i < 3; ++i)
                            a.bodypts_o[(3 * (p - NF) + i) * N + n] = pp[i];
                }
            }
#pragma unroll
            for (int src = 0; src < LANES; ++src) {
                real v[6];
                for (int i = 0; i < 6; ++i) v[i] = __shfl_sync(FULL, w[i], src, LANES);
                if (LANES * k + src < n_torso)
                    for (int i = 0; i < 6; ++i) fext0[i] = fext0[i] + v[i];
            }
        }
        if (last) {
            __syncwarp();
            // report sums in point order, every LANES-th body a lane
            for (int b = leg; b < a.nrb; b += LANES) {
                real acc[3] = {0.0f, 0.0f, 0.0f};
                for (int p = 0; p < P; ++p)
                    if ((int)c_rep[p] == b)
                        for (int i = 0; i < 3; ++i) acc[i] = acc[i] + my_force[3 * p + i];
                if (valid)
                    for (int i = 0; i < 3; ++i) a.report_o[(3 * b + i) * N + n] = acc[i];
            }
            if (valid) {
                for (int k = 0; k < 4; ++k) {
                    const int b = (int)c[C_THIGH + k];
#pragma unroll
                    for (int d = 0; d < 3; ++d)
                        if ((int)c[C_BODY + 4 * d + leg] == b)
                            for (int i = 0; i < 3; ++i)
                                a.thigh_o[(3 * k + i) * N + n] = X[d][i];
                    if (b == 0 && leg == 0)
                        for (int i = 0; i < 3; ++i) a.thigh_o[(3 * k + i) * N + n] = pos[i];
                }
#pragma unroll
                for (int d = 0; d < 3; ++d) a.tau_o[jn[d] * N + n] = tau[d];
            }
        }

        // ---- articulated-body algorithm (physics/quadruped.py aba) -------
        // the lane's leg, foot to hip; then the base from the four legs'
        // articulated inertias, added in leg order as the plain version does
        real Ust[3][6], cst[3][6], dinv[3], ust[3];
        real IAc[36], pAc[6], tmp6[6], f6[6];
#pragma unroll
        for (int d = 2; d >= 0; --d) {
            const int b = (int)c[C_BODY + 4 * d + leg];
            const float* ax = c + C_AXIS + 3 * d;
            const float* r = c + C_R + 3 * (4 * d + leg);
            real IA[36], pA[6];
            for (int i = 0; i < 36; ++i) IA[i] = a.inertias[((long)b * 36 + i) * N + n];
            imul(IA, V[d], tmp6);
            crf(V[d], tmp6, pA);
            rtmul(R[d], fext[d], f6);
            rtmul(R[d], fext[d] + 3, f6 + 3);
            for (int i = 0; i < 6; ++i) pA[i] = pA[i] - f6[i];
            if (d < 2) {
                for (int i = 0; i < 36; ++i) IA[i] = IA[i] + IAc[i];
                for (int i = 0; i < 6; ++i) pA[i] = pA[i] + pAc[i];
            }
            const real sq[6] = {ax[0] * qd[d], ax[1] * qd[d], ax[2] * qd[d],
                                 0.0f, 0.0f, 0.0f};
            crm(V[d], sq, cst[d]);
            real* U = Ust[d];
            for (int i = 0; i < 6; ++i)
                U[i] = IA[6 * i] * ax[0] + IA[6 * i + 1] * ax[1] + IA[6 * i + 2] * ax[2];
            const real D = ax[0] * U[0] + ax[1] * U[1] + ax[2] * U[2] + c[S_ARM];
            const real u = tau_eff[d] - c[S_JF] * qd[d]
                          - (ax[0] * pA[0] + ax[1] * pA[1] + ax[2] * pA[2]);
            dinv[d] = 1.0f / D;
            ust[d] = u;
            real Ia[36], pa[6], Iac[6];
            for (int i = 0; i < 6; ++i)
                for (int k = 0; k < 6; ++k)
                    Ia[6 * i + k] = IA[6 * i + k] - U[i] * U[k] * dinv[d];
            imul(Ia, cst[d], Iac);
            const real uD = u / D;
            for (int i = 0; i < 6; ++i) pa[i] = pA[i] + Iac[i] + U[i] * uD;
            inertia_to_parent(E[d], r, Ia, IAc);
            xf_inv_apply(E[d], r, pa, pAc);
        }
        real IA0[36], pA0[6];
        for (int i = 0; i < 36; ++i) IA0[i] = a.inertias[(long)i * N + n];
        imul(IA0, V0, tmp6);
        crf(V0, tmp6, pA0);
        rtmul(R0, fext0, f6);
        rtmul(R0, fext0 + 3, f6 + 3);
        for (int i = 0; i < 6; ++i) pA0[i] = pA0[i] - f6[i];
        // the base solve reads the lower triangle only
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
            for (int k = 0; k <= i; ++k) {
                real sum = 0.0f;
#pragma unroll
                for (int src = 0; src < LANES; ++src)
                    sum = sum + __shfl_sync(FULL, IAc[6 * i + k], src, LANES);
                IA0[6 * i + k] = IA0[6 * i + k] + sum;
            }
#pragma unroll
        for (int i = 0; i < 6; ++i) {
            real sum = 0.0f;
#pragma unroll
            for (int src = 0; src < LANES; ++src)
                sum = sum + __shfl_sync(FULL, pAc[i], src, LANES);
            pA0[i] = pA0[i] + sum;
        }
        real a0[6];
        solve_spd6(IA0, pA0, a0);
        for (int i = 0; i < 6; ++i) a0[i] = -a0[i];

        real qdd[3];
        {
            real a_par[6];
            for (int i = 0; i < 6; ++i) a_par[i] = a0[i];
#pragma unroll
            for (int d = 0; d < 3; ++d) {
                const float* ax = c + C_AXIS + 3 * d;
                const float* r = c + C_R + 3 * (4 * d + leg);
                real ap[6];
                xm_apply(E[d], r, a_par, ap);
                for (int i = 0; i < 6; ++i) ap[i] = ap[i] + cst[d][i];
                real ua = Ust[d][0] * ap[0];
                for (int i = 1; i < 6; ++i) ua = ua + Ust[d][i] * ap[i];
                qdd[d] = (ust[d] - ua) * dinv[d];
                for (int i = 0; i < 3; ++i) ap[i] = ap[i] + ax[i] * qdd[d];
                for (int i = 0; i < 6; ++i) a_par[i] = ap[i];
            }
        }

        // ---- semi-implicit integration ----------------------------------
        const real gw[3] = {0.0f, 0.0f, c[S_G]};
        real gb[3], v0n[6], ww[3], vw[3];
        rtmul(R0, gw, gb);
        for (int i = 0; i < 3; ++i) {
            v0n[i] = V0[i] + dt * a0[i];
            v0n[3 + i] = V0[3 + i] + dt * (a0[3 + i] + gb[i]);
        }
        rmul(R0, v0n, ww);
        rmul(R0, v0n + 3, vw);
        for (int i = 0; i < 3; ++i) {
            ww[i] = m_clamp(ww[i], -50.0f, 50.0f);
            vw[i] = m_clamp(vw[i], -100.0f, 100.0f);
        }
#pragma unroll
        for (int d = 0; d < 3; ++d) {
            const real vl = c[C_VLIM + jn[d]];
            qd[d] = m_fmax(m_fmin(qd[d] + dt * qdd[d], vl), -vl);
            q[d] = q[d] + dt * qd[d];
        }
        for (int i = 0; i < 3; ++i) {
            pos[i] = pos[i] + dt * vw[i];
            lin[i] = vw[i];
            ang[i] = ww[i];
        }
        // exponential-map quaternion update (pallas_substep.py:74-92)
        const real angle = m_sqrt(ww[0] * ww[0] + ww[1] * ww[1] + ww[2] * ww[2]);
        const real inv = 1.0f / m_fmax(angle, 1e-9f);
        const real half = angle * c[S_HALF_DT];
        const real si = m_sin(half) * inv, co = m_cos(half);
        const real ax_ = ww[0] * si, ay_ = ww[1] * si, az_ = ww[2] * si, aw_ = co;
        const real bx = quat[0], by = quat[1], bz = quat[2], bw = quat[3];
        real qn[4] = {aw_ * bx + ax_ * bw + ay_ * bz - az_ * by,
                       aw_ * by - ax_ * bz + ay_ * bw + az_ * bx,
                       aw_ * bz + ax_ * by - ay_ * bx + az_ * bw,
                       aw_ * bw - ax_ * bx - ay_ * by - az_ * bz};
        const real nrm = m_fmax(m_sqrt(qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2]
                                      + qn[3] * qn[3]), 1e-9f);
        for (int i = 0; i < 4; ++i) quat[i] = qn[i] / nrm;
    }

    if (!valid) return;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
        a.q_o[jn[d] * N + n] = q[d];
        a.qd_o[jn[d] * N + n] = qd[d];
    }
    if (leg == 0) {
        for (int i = 0; i < 3; ++i) {
            a.pos_o[i * N + n] = pos[i];
            a.lin_o[i * N + n] = lin[i];
            a.ang_o[i * N + n] = ang[i];
        }
        for (int i = 0; i < 4; ++i) a.quat_o[i * N + n] = quat[i];
    }
#pragma unroll
    for (int k = 0; k < MAXLP; ++k)
        if (lp[k] >= 0) {
            a.anchors_o[(2 * lp[k]) * N + n] = anc[k][0];
            a.anchors_o[(2 * lp[k] + 1) * N + n] = anc[k][1];
        }
#pragma unroll
    for (int k = 0; k < MAXTS; ++k)
        if (tp[k] >= 0) {
            a.anchors_o[(2 * tp[k]) * N + n] = tanc[k][0];
            a.anchors_o[(2 * tp[k] + 1) * N + n] = tanc[k][1];
        }
}

// The arguments common to both variants; the terrain source is set by
// the entry point.
template <typename real>
Args<real> make_args(
        const void* q, const void* qd, const void* pos, const void* quat,
        const void* lin, const void* ang, const void* anchors,
        const void* inertias, const void* goals, const void* kp,
        const void* kd, const void* strength, const void* offset,
        const void* friction, const void* restitution, const void* worigin,
        const void* planes, const void* consts,
        void* q_o, void* qd_o, void* pos_o, void* quat_o, void* lin_o,
        void* ang_o, void* anchors_o, void* report_o, void* footpos_o,
        void* footvel_o, void* thigh_o, void* tau_o, void* bodypts_o,
        int N, int P, int nrb, int decimation) {
    Args<real> a = {};
    a.q = (const real*)q; a.qd = (const real*)qd; a.pos = (const real*)pos;
    a.quat = (const real*)quat; a.lin = (const real*)lin;
    a.ang = (const real*)ang; a.anchors = (const real*)anchors;
    a.inertias = (const real*)inertias; a.goals = (const real*)goals;
    a.kp = (const real*)kp; a.kd = (const real*)kd;
    a.strength = (const real*)strength; a.offset = (const real*)offset;
    a.friction = (const real*)friction;
    a.restitution = (const real*)restitution;
    a.worigin = (const real*)worigin; a.planes = (const real*)planes;
    a.consts = (const float*)consts;
    a.q_o = (real*)q_o; a.qd_o = (real*)qd_o; a.pos_o = (real*)pos_o;
    a.quat_o = (real*)quat_o; a.lin_o = (real*)lin_o;
    a.ang_o = (real*)ang_o; a.anchors_o = (real*)anchors_o;
    a.report_o = (real*)report_o; a.footpos_o = (real*)footpos_o;
    a.footvel_o = (real*)footvel_o; a.thigh_o = (real*)thigh_o;
    a.tau_o = (real*)tau_o; a.bodypts_o = (real*)bodypts_o;
    a.N = N; a.P = P; a.nrb = nrb; a.decimation = decimation;
    return a;
}

template <bool WINDOW, typename real>
int run(const Args<real>& a, int threads, void* stream) {
    if (a.P > MAXP || a.nrb > MAXRB || a.P < NF || threads % 32 != 0
            || threads < 32 || threads > MAX_THREADS)
        return (int)cudaErrorInvalidValue;
    if (a.N > 0) {
        const int envs = threads / LANES;
        const int grid = (a.N + envs - 1) / envs;
        substep_kernel<WINDOW, real><<<grid, threads, 0, (cudaStream_t)stream>>>(a);
    }
    return (int)cudaGetLastError();
}

}  // namespace

#define DTC_STEP_PARAMS                                                       \
        const void* q, const void* qd, const void* pos, const void* quat,    \
        const void* lin, const void* ang, const void* anchors,               \
        const void* inertias, const void* goals, const void* kp,             \
        const void* kd, const void* strength, const void* offset,            \
        const void* friction, const void* restitution
#define DTC_STEP_OUTS                                                         \
        void* q_o, void* qd_o, void* pos_o, void* quat_o, void* lin_o,       \
        void* ang_o, void* anchors_o, void* report_o, void* footpos_o,       \
        void* footvel_o, void* thigh_o, void* tau_o, void* bodypts_o
#define DTC_STEP_ARGS(real, worigin, planes, consts)                         \
        make_args<real>(q, qd, pos, quat, lin, ang, anchors, inertias, goals, kp,  \
                  kd, strength, offset, friction, restitution, worigin,      \
                  planes, consts, q_o, qd_o, pos_o, quat_o, lin_o, ang_o,    \
                  anchors_o, report_o, footpos_o, footvel_o, thigh_o, tau_o, \
                  bodypts_o, N, P, nrb, decimation)

// The fused variant: the feet's cells from the blocked tables (T, B, Rp,
// 128) at each env's start (N, 2) int32.
DTC_EXPORT int dtc_decimation_step(
        DTC_STEP_PARAMS, const void* blocks, const void* starts,
        const void* worigin, const void* planes, const void* consts,
        DTC_STEP_OUTS, int N, int P, int nrb, int decimation, int B, int Rp,
        int threads, void* stream) {
    Args<float> a = DTC_STEP_ARGS(float, worigin, planes, consts);
    a.blocks = (const float*)blocks; a.starts = (const int*)starts;
    a.B = B; a.Rp = Rp;
    return run<false>(a, threads, stream);
}

// The window variant: the feet's cells from a (N, 40, 128) float32 window
// with element strides (sN, sR, sC).
DTC_EXPORT int dtc_decimation_step_window(
        DTC_STEP_PARAMS, const void* window, int sN, int sR, int sC,
        const void* worigin, const void* planes,
        const void* consts, DTC_STEP_OUTS, int N, int P, int nrb,
        int decimation, int threads, void* stream) {
    Args<float> a = DTC_STEP_ARGS(float, worigin, planes, consts);
    a.window = (const float*)window;
    a.wsN = sN; a.wsR = sR; a.wsC = sC;
    return run<true>(a, threads, stream);
}

// The fused variant built in float64 (the same source, every state,
// parameter and result in double; the terrain and constant tables the
// kernel's float32 ones): a check of the kernel's arithmetic free of
// float32 rounding, not a route of the env.
DTC_EXPORT int dtc_decimation_step_f64(
        DTC_STEP_PARAMS, const void* blocks, const void* starts,
        const void* worigin, const void* planes, const void* consts,
        DTC_STEP_OUTS, int N, int P, int nrb, int decimation, int B, int Rp,
        int threads, void* stream) {
    Args<double> a = DTC_STEP_ARGS(double, worigin, planes, consts);
    a.blocks = (const float*)blocks; a.starts = (const int*)starts;
    a.B = B; a.Rp = Rp;
    return run<false>(a, threads, stream);
}
