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
// Bound on the H100: latency and local memory.  Every env is a long serial
// program; the 13 bodies' kinematics and the ABA's 6x6 articulated
// inertias take about 4 KB a thread, far beyond the register file, so they
// live in local memory (L1/L2).  Design: one thread per env, 128 threads a
// block; the env-trailing (k, N) arrays are read and written coalesced as
// they come; each foot reads its four terrain cells straight from the
// blocked raw table (the fused variant: the TPU kernel's window DMA has no
// counterpart) or from a materialized (N, 40, 128) contact window read
// through its strides (the window variant, dtc_decimation_step_window: a
// view of the patch copy or the window copy, no transpose); the two are
// one template, the same arithmetic on the same cells; the
// per-robot constants come from one packed float32 table
// (physics/cuda_substep.py pack_constants).  Divisions by a Python scalar
// in the plain version are multiplications by its float32 reciprocal
// here, as PyTorch computes them on the card.
#include "common.cuh"

namespace {

constexpr int NQ = 12;
constexpr int NB = 13;
constexpr int NF = 4;
constexpr int PC = 128;      // table columns
constexpr int WIN_R0 = 16;   // contact window rows [r0+16, r0+56)
constexpr int MAXP = 32;
constexpr int MAXRB = 32;

// packed constant table: scalars, then per-joint rows, layout, points
enum {
    S_DT, S_G, S_K, S_CD, S_FMAX, S_ARM, S_JF, S_LK, S_LD, S_KT, S_CT,
    S_NCAP, S_CLIFF, S_CDEPTH, S_HS, S_INV_HS, S_KDT, S_KTDT, S_INV_KT,
    S_HALF_DT
};
constexpr int C_LO = 24, C_HI = 36, C_TLIM = 48, C_VLIM = 60;
constexpr int C_AXIS = 72, C_R = 81, C_BODY = 117, C_JOINT = 129;
constexpr int C_THIGH = 141, C_PTS = 145;

struct Args {
    const float *q, *qd, *pos, *quat, *lin, *ang, *anchors, *inertias;
    const float *goals, *kp, *kd, *strength, *offset, *friction;
    const float *restitution, *blocks;
    const int* starts;
    const float *worigin, *planes, *consts;
    const float* window;            // the window variant's (N, 40, 128)
    long long wsN, wsR, wsC;        // its strides, in elements
    float *q_o, *qd_o, *pos_o, *quat_o, *lin_o, *ang_o, *anchors_o;
    float *report_o, *footpos_o, *footvel_o, *thigh_o, *tau_o, *bodypts_o;
    int N, P, nrb, decimation, B, Rp;
};

// ---- 3-vectors and 3x3 matrices (row-major float[9]) --------------------

__device__ __forceinline__ void cross(const float* a, const float* b, float* o) {
    o[0] = a[1] * b[2] - a[2] * b[1];
    o[1] = a[2] * b[0] - a[0] * b[2];
    o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void rmul(const float* R, const float* v, float* o) {
    for (int i = 0; i < 3; ++i)
        o[i] = R[3 * i] * v[0] + R[3 * i + 1] * v[1] + R[3 * i + 2] * v[2];
}

__device__ __forceinline__ void rtmul(const float* R, const float* v, float* o) {
    for (int i = 0; i < 3; ++i)
        o[i] = R[i] * v[0] + R[3 + i] * v[1] + R[6 + i] * v[2];
}

__device__ __forceinline__ void mmul3(const float* A, const float* B, float* C) {
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j]
                         + A[3 * i + 2] * B[6 + j];
}

__device__ __forceinline__ void transpose3(const float* A, float* T) {
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) T[3 * i + j] = A[3 * j + i];
}

// Rodrigues rotation by angle q about the unit axis ax (ops/spatial.py).
__device__ __forceinline__ void axis_rotation(const float* ax, float q, float* R) {
    const float c = cosf(q), s = sinf(q), C = 1.0f - c;
    const float x = ax[0], y = ax[1], z = ax[2];
    R[0] = c + x * x * C;     R[1] = x * y * C - z * s; R[2] = x * z * C + y * s;
    R[3] = y * x * C + z * s; R[4] = c + y * y * C;     R[5] = y * z * C - x * s;
    R[6] = z * x * C - y * s; R[7] = z * y * C + x * s; R[8] = c + z * z * C;
}

__device__ __forceinline__ void quat_to_rotmat(const float* q, float* m) {
    const float x = q[0], y = q[1], z = q[2], w = q[3];
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, xz = x * z, yz = y * z;
    const float wx = w * x, wy = w * y, wz = w * z;
    m[0] = 1.0f - 2.0f * (yy + zz); m[1] = 2.0f * (xy - wz); m[2] = 2.0f * (xz + wy);
    m[3] = 2.0f * (xy + wz); m[4] = 1.0f - 2.0f * (xx + zz); m[5] = 2.0f * (yz - wx);
    m[6] = 2.0f * (xz - wy); m[7] = 2.0f * (yz + wx); m[8] = 1.0f - 2.0f * (xx + yy);
}

// ---- spatial algebra (ops/spatial.py), vectors float[6] -----------------

// motion vector, parent -> child coords
__device__ __forceinline__ void xm_apply(const float* E, const float* r,
                                         const float* m, float* o) {
    float rw[3], t[3];
    rmul(E, m, o);
    cross(r, m, rw);
    for (int i = 0; i < 3; ++i) t[i] = m[3 + i] - rw[i];
    rmul(E, t, o + 3);
}

// force vector, child -> parent coords
__device__ __forceinline__ void xf_inv_apply(const float* E, const float* r,
                                             const float* f, float* o) {
    float en[3], rf[3];
    rtmul(E, f + 3, o + 3);
    rtmul(E, f, en);
    cross(r, o + 3, rf);
    for (int i = 0; i < 3; ++i) o[i] = en[i] + rf[i];
}

__device__ __forceinline__ void crm(const float* v, const float* m, float* o) {
    float a[3], b[3];
    cross(v, m, o);
    cross(v + 3, m, a);
    cross(v, m + 3, b);
    for (int i = 0; i < 3; ++i) o[3 + i] = a[i] + b[i];
}

__device__ __forceinline__ void crf(const float* v, const float* f, float* o) {
    float a[3], b[3];
    cross(v, f, a);
    cross(v + 3, f + 3, b);
    for (int i = 0; i < 3; ++i) o[i] = a[i] + b[i];
    cross(v, f + 3, o + 3);
}

__device__ __forceinline__ void imul(const float* I, const float* m, float* o) {
    for (int i = 0; i < 6; ++i) {
        float acc = I[6 * i] * m[0];
        for (int j = 1; j < 6; ++j) acc = acc + I[6 * i + j] * m[j];
        o[i] = acc;
    }
}

// Articulated inertia, child -> parent coords, block-wise (Featherstone 2.66)
__device__ void inertia_to_parent(const float* E, const float* r,
                                  const float* I, float* O) {
    float A[9], Bm[9], Cm[9], D[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            A[3 * i + j] = I[6 * i + j];
            Bm[3 * i + j] = I[6 * i + 3 + j];
            Cm[3 * i + j] = I[6 * (i + 3) + j];
            D[3 * i + j] = I[6 * (i + 3) + 3 + j];
        }
    const float rh[9] = {0.0f, -r[2], r[1], r[2], 0.0f, -r[0], -r[1], r[0], 0.0f};
    float F[9], Et[9], Ft[9], t1[9], t2[9], AE_BF[9], CE_DF[9], DE[9];
    mmul3(E, rh, F);
    for (int i = 0; i < 9; ++i) F[i] = -F[i];
    transpose3(E, Et);
    transpose3(F, Ft);
    mmul3(A, E, t1); mmul3(Bm, F, t2);
    for (int i = 0; i < 9; ++i) AE_BF[i] = t1[i] + t2[i];
    mmul3(Cm, E, t1); mmul3(D, F, t2);
    for (int i = 0; i < 9; ++i) CE_DF[i] = t1[i] + t2[i];
    mmul3(D, E, DE);
    float bl[9], tl[9], br[9];
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
__device__ void solve_spd6(const float* A, const float* b, float* x) {
    float L[6][6], Dg[6], y[6];
    for (int j = 0; j < 6; ++j) {
        float d = A[7 * j] + 1e-8f;
        for (int k = 0; k < j; ++k) d = d - L[j][k] * L[j][k] * Dg[k];
        Dg[j] = d;
        const float inv_d = 1.0f / d;
        for (int i = j + 1; i < 6; ++i) {
            float s = A[6 * i + j];
            for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k] * Dg[k];
            L[i][j] = s * inv_d;
        }
    }
    for (int i = 0; i < 6; ++i) {
        float s = b[i];
        for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
        y[i] = s;
    }
    for (int i = 5; i >= 0; --i) {
        float s = y[i] / Dg[i];
        for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
        x[i] = s;
    }
}

// ---- the kernel -------------------------------------------------------

template <bool WINDOW>
__global__ void __launch_bounds__(128) substep_kernel(Args a) {
    const long N = a.N;
    const long n = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    const float* c = a.consts;
    const int P = a.P;
    const float dt = c[S_DT];
    const float* c_rad = c + C_PTS;
    const float* c_effm = c + C_PTS + P;
    const float* c_off = c + C_PTS + 2 * P;
    const float* c_dyn = c + C_PTS + 5 * P;
    const float* c_rep = c + C_PTS + 6 * P;

    float q[NQ], qd[NQ], kp[NQ], kd[NQ], st[NQ], off[NQ], tau[NQ], tau_eff[NQ];
    for (int j = 0; j < NQ; ++j) {
        q[j] = a.q[j * N + n];
        qd[j] = a.qd[j * N + n];
        kp[j] = a.kp[j * N + n];
        kd[j] = a.kd[j * N + n];
        st[j] = a.strength[j * N + n];
        off[j] = a.offset[j * N + n];
    }
    float pos[3], quat[4], lin[3], ang[3];
    for (int i = 0; i < 3; ++i) {
        pos[i] = a.pos[i * N + n];
        lin[i] = a.lin[i * N + n];
        ang[i] = a.ang[i * N + n];
    }
    for (int i = 0; i < 4; ++i) quat[i] = a.quat[i * N + n];
    float anc[MAXP][2];
    for (int p = 0; p < P; ++p) {
        anc[p][0] = a.anchors[(2 * p) * N + n];
        anc[p][1] = a.anchors[(2 * p + 1) * N + n];
    }
    const float fric = a.friction[n], rest = a.restitution[n];
    const float wox = a.worigin[n], woy = a.worigin[N + n];
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
    float band_r[NF], band_c[NF];

    float R[NB][9], X[NB][3], V[NB][6], fext[NB][6];
    float Ust[NQ][6], cst[NQ][6], dinv[NQ], ust[NQ];

    for (int s = 0; s < a.decimation; ++s) {
        const bool last = (s == a.decimation - 1);
        // ---- PD torques + joint-limit spring ---------------------------
        for (int j = 0; j < NQ; ++j) {
            const float goal = a.goals[((long)s * NQ + j) * N + n];
            const float tlim = c[C_TLIM + j], lo = c[C_LO + j], hi = c[C_HI + j];
            float t = kp[j] * (goal - q[j] + off[j]) - kd[j] * qd[j];
            t = fmaxf(fminf(t * st[j], tlim), -tlim);
            tau[j] = t;
            const float beyond = (q[j] < lo || q[j] > hi) ? 1.0f : 0.0f;
            const float tl = c[S_LK] * (fmaxf(lo - q[j], 0.0f) - fmaxf(q[j] - hi, 0.0f))
                           - c[S_LD] * qd[j] * beyond;
            tau_eff[j] = t + tl;
        }

        // ---- FK ---------------------------------------------------------
        quat_to_rotmat(quat, R[0]);
        for (int i = 0; i < 3; ++i) X[0][i] = pos[i];
        rtmul(R[0], ang, V[0]);
        rtmul(R[0], lin, V[0] + 3);
        for (int leg = 0; leg < 4; ++leg) {
            int par = 0;
            for (int d = 0; d < 3; ++d) {
                const int b = (int)c[C_BODY + 4 * d + leg];
                const int j = (int)c[C_JOINT + 4 * d + leg];
                const float* ax = c + C_AXIS + 3 * d;
                const float* r = c + C_R + 3 * (4 * d + leg);
                float Rj[9], E[9], t[3];
                axis_rotation(ax, q[j], Rj);
                transpose3(Rj, E);
                xm_apply(E, r, V[par], V[b]);
                for (int i = 0; i < 3; ++i) V[b][i] = V[b][i] + ax[i] * qd[j];
                mmul3(R[par], Rj, R[b]);
                rmul(R[par], r, t);
                for (int i = 0; i < 3; ++i) X[b][i] = X[par][i] + t[i];
                par = b;
            }
        }

        // ---- contact points: state, terrain, contact, force sums --------
        for (int b = 0; b < NB; ++b)
            for (int i = 0; i < 6; ++i) fext[b][i] = 0.0f;
        float rep[MAXRB][3];
        if (last)
            for (int b = 0; b < a.nrb; ++b) rep[b][0] = rep[b][1] = rep[b][2] = 0.0f;
        for (int p = 0; p < P; ++p) {
            const int b = (int)c_dyn[p];
            const float* o3 = c_off + 3 * p;
            float t[3], pp[3], pv[3], vb[3];
            rmul(R[b], o3, t);
            for (int i = 0; i < 3; ++i) pp[i] = X[b][i] + t[i];
            cross(V[b], o3, t);
            for (int i = 0; i < 3; ++i) vb[i] = V[b][3 + i] + t[i];
            rmul(R[b], vb, pv);

            float h, dhdx, dhdy, hmax;
            if (p < NF) {
                const float fr = (pp[0] - wox) * c[S_INV_HS];
                const float fc = (pp[1] - woy) * c[S_INV_HS];
                if (s == 0) {
                    band_r[p] = clampf(floorf((fr - 2.0f) * 0.125f), 0.0f, 3.0f) * 8.0f;
                    band_c[p] = clampf(floorf((fc - 2.0f) * 0.125f), 0.0f, 14.0f) * 8.0f;
                }
                const float lfr = clampf(fr - band_r[p], 0.0f, 14.999f);
                const float lfc = clampf(fc - band_c[p], 0.0f, 14.999f);
                const float i0 = floorf(lfr), j0 = floorf(lfc);
                const float tx = lfr - i0, ty = lfc - j0;
                const float* cp = win + (long long)(band_r[p] + i0) * rs
                                + (long long)(band_c[p] + j0) * cs;
                const float c00 = cp[0], c01 = cp[cs], c10 = cp[rs], c11 = cp[rs + cs];
                h = c00 * (1.0f - tx) * (1.0f - ty) + c10 * tx * (1.0f - ty)
                  + c01 * (1.0f - tx) * ty + c11 * tx * ty;
                dhdx = clampf(((c10 - c00) * (1.0f - ty) + (c11 - c01) * ty) * c[S_INV_HS],
                              -3.0f, 3.0f);
                dhdy = clampf(((c01 - c00) * (1.0f - tx) + (c11 - c10) * tx) * c[S_INV_HS],
                              -3.0f, 3.0f);
                hmax = fmaxf(fmaxf(c00, c10), fmaxf(c01, c11));
            } else {
                const float* pl = a.planes + (long)(p - NF) * 5 * N + n;
                h = pl[0] + pl[N] * (pp[0] - pl[3 * N]) + pl[2 * N] * (pp[1] - pl[4 * N]);
                dhdx = pl[N];
                dhdy = pl[2 * N];
                hmax = h;
            }

            // anchored penalty contact (physics/engine.py heightfield_contact)
            const float zr = pp[2] - c_rad[p];
            const bool cliff = fabsf(dhdx) >= c[S_CLIFF] || fabsf(dhdy) >= c[S_CLIFF];
            const bool sup = cliff && (hmax - zr) < c[S_CDEPTH];
            const float h_eff = sup ? hmax : h;
            const float ncap = c[S_NCAP];
            const float gx = sup ? 0.0f : (cliff ? dhdx : clampf(dhdx, -ncap, ncap));
            const float gy = sup ? 0.0f : (cliff ? dhdy : clampf(dhdy, -ncap, ncap));
            float nx = -gx, ny = -gy;
            const float inv_norm = rsqrtf(nx * nx + ny * ny + 1.0f);
            nx = nx * inv_norm;
            ny = ny * inv_norm;
            const float nz = inv_norm;
            const float pen = h_eff - zr;
            const float vn = pv[0] * nx + pv[1] * ny + pv[2] * nz;
            const float active = (pen > 0.0f && pen < 0.5f) ? 1.0f : 0.0f;
            const float m = c_effm[p];
            const float damp = vn < 0.0f ? c[S_CD] : c[S_CD] * (1.0f - rest);
            const float denom = 1.0f + (c[S_KDT] + damp) * dt / m;
            float fn = (c[S_K] * pen - (c[S_KDT] + damp) * vn) / denom;
            fn = clampf(fn, 0.0f, c[S_FMAX]) * active;
            const float inv_t = 1.0f / (1.0f + c[S_KTDT] / m);
            const float disp_x = pp[0] - anc[p][0], disp_y = pp[1] - anc[p][1];
            float ftx = -(c[S_KT] * disp_x + c[S_CT] * pv[0]) * inv_t;
            float fty = -(c[S_KT] * disp_y + c[S_CT] * pv[1]) * inv_t;
            const float ft_mag = sqrtf(ftx * ftx + fty * fty + 1e-12f);
            const float scale = fminf(1.0f, fric * fn / ft_mag);
            ftx = ftx * scale * active;
            fty = fty * scale * active;
            const bool is_active = active > 0.0f;
            const bool slip = scale < 1.0f && is_active;
            if (slip) {
                anc[p][0] = pp[0] + ftx * c[S_INV_KT];
                anc[p][1] = pp[1] + fty * c[S_INV_KT];
            } else if (!is_active) {
                anc[p][0] = pp[0];
                anc[p][1] = pp[1];
            }
            const float f[3] = {nx * fn + ftx, ny * fn + fty, nz * fn};

            // spatial force on the body, world-aligned at its origin
            float arm[3], tq[3];
            for (int i = 0; i < 3; ++i) arm[i] = pp[i] - X[b][i];
            cross(arm, f, tq);
            for (int i = 0; i < 3; ++i) {
                fext[b][i] = fext[b][i] + tq[i];
                fext[b][3 + i] = fext[b][3 + i] + f[i];
            }
            if (last) {
                const int rb = (int)c_rep[p];
                for (int i = 0; i < 3; ++i) rep[rb][i] = rep[rb][i] + f[i];
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
        if (last) {
            for (int b = 0; b < a.nrb; ++b)
                for (int i = 0; i < 3; ++i) a.report_o[(3 * b + i) * N + n] = rep[b][i];
            for (int k = 0; k < 4; ++k) {
                const int b = (int)c[C_THIGH + k];
                for (int i = 0; i < 3; ++i) a.thigh_o[(3 * k + i) * N + n] = X[b][i];
            }
            for (int j = 0; j < NQ; ++j) a.tau_o[j * N + n] = tau[j];
        }

        // ---- articulated-body algorithm (physics/quadruped.py aba) -------
        float IA0[36], pA0[6], IAsum[36], pAsum[6], tmp6[6], f6[6];
        for (int i = 0; i < 36; ++i) {
            IA0[i] = a.inertias[(long)i * N + n];
            IAsum[i] = 0.0f;
        }
        imul(IA0, V[0], tmp6);
        crf(V[0], tmp6, pA0);
        rtmul(R[0], fext[0], f6);
        rtmul(R[0], fext[0] + 3, f6 + 3);
        for (int i = 0; i < 6; ++i) {
            pA0[i] = pA0[i] - f6[i];
            pAsum[i] = 0.0f;
        }
        for (int leg = 0; leg < 4; ++leg) {
            float IAc[36], pAc[6];
            for (int d = 2; d >= 0; --d) {
                const int b = (int)c[C_BODY + 4 * d + leg];
                const int j = (int)c[C_JOINT + 4 * d + leg];
                const float* ax = c + C_AXIS + 3 * d;
                const float* r = c + C_R + 3 * (4 * d + leg);
                float IA[36], pA[6], Rj[9], E[9];
                for (int i = 0; i < 36; ++i) IA[i] = a.inertias[((long)b * 36 + i) * N + n];
                imul(IA, V[b], tmp6);
                crf(V[b], tmp6, pA);
                rtmul(R[b], fext[b], f6);
                rtmul(R[b], fext[b] + 3, f6 + 3);
                for (int i = 0; i < 6; ++i) pA[i] = pA[i] - f6[i];
                if (d < 2) {
                    for (int i = 0; i < 36; ++i) IA[i] = IA[i] + IAc[i];
                    for (int i = 0; i < 6; ++i) pA[i] = pA[i] + pAc[i];
                }
                const float sq[6] = {ax[0] * qd[j], ax[1] * qd[j], ax[2] * qd[j],
                                     0.0f, 0.0f, 0.0f};
                crm(V[b], sq, cst[j]);
                float* U = Ust[j];
                for (int i = 0; i < 6; ++i)
                    U[i] = IA[6 * i] * ax[0] + IA[6 * i + 1] * ax[1] + IA[6 * i + 2] * ax[2];
                const float D = ax[0] * U[0] + ax[1] * U[1] + ax[2] * U[2] + c[S_ARM];
                const float u = tau_eff[j] - c[S_JF] * qd[j]
                              - (ax[0] * pA[0] + ax[1] * pA[1] + ax[2] * pA[2]);
                dinv[j] = 1.0f / D;
                ust[j] = u;
                float Ia[36], pa[6], Iac[6];
                for (int i = 0; i < 6; ++i)
                    for (int k = 0; k < 6; ++k)
                        Ia[6 * i + k] = IA[6 * i + k] - U[i] * U[k] * dinv[j];
                imul(Ia, cst[j], Iac);
                const float uD = u / D;
                for (int i = 0; i < 6; ++i) pa[i] = pA[i] + Iac[i] + U[i] * uD;
                axis_rotation(ax, q[j], Rj);
                transpose3(Rj, E);
                inertia_to_parent(E, r, Ia, IAc);
                xf_inv_apply(E, r, pa, pAc);
                if (d == 0) {
                    for (int i = 0; i < 36; ++i) IAsum[i] = IAsum[i] + IAc[i];
                    for (int i = 0; i < 6; ++i) pAsum[i] = pAsum[i] + pAc[i];
                }
            }
        }
        for (int i = 0; i < 36; ++i) IA0[i] = IA0[i] + IAsum[i];
        for (int i = 0; i < 6; ++i) pA0[i] = pA0[i] + pAsum[i];
        float a0[6];
        solve_spd6(IA0, pA0, a0);
        for (int i = 0; i < 6; ++i) a0[i] = -a0[i];

        float qdd[NQ];
        for (int leg = 0; leg < 4; ++leg) {
            float a_par[6];
            for (int i = 0; i < 6; ++i) a_par[i] = a0[i];
            for (int d = 0; d < 3; ++d) {
                const int j = (int)c[C_JOINT + 4 * d + leg];
                const float* ax = c + C_AXIS + 3 * d;
                const float* r = c + C_R + 3 * (4 * d + leg);
                float Rj[9], E[9], ap[6];
                axis_rotation(ax, q[j], Rj);
                transpose3(Rj, E);
                xm_apply(E, r, a_par, ap);
                for (int i = 0; i < 6; ++i) ap[i] = ap[i] + cst[j][i];
                float ua = Ust[j][0] * ap[0];
                for (int i = 1; i < 6; ++i) ua = ua + Ust[j][i] * ap[i];
                qdd[j] = (ust[j] - ua) * dinv[j];
                for (int i = 0; i < 3; ++i) ap[i] = ap[i] + ax[i] * qdd[j];
                for (int i = 0; i < 6; ++i) a_par[i] = ap[i];
            }
        }

        // ---- semi-implicit integration ----------------------------------
        const float gw[3] = {0.0f, 0.0f, c[S_G]};
        float gb[3], v0n[6], ww[3], vw[3];
        rtmul(R[0], gw, gb);
        for (int i = 0; i < 3; ++i) {
            v0n[i] = V[0][i] + dt * a0[i];
            v0n[3 + i] = V[0][3 + i] + dt * (a0[3 + i] + gb[i]);
        }
        rmul(R[0], v0n, ww);
        rmul(R[0], v0n + 3, vw);
        for (int i = 0; i < 3; ++i) {
            ww[i] = clampf(ww[i], -50.0f, 50.0f);
            vw[i] = clampf(vw[i], -100.0f, 100.0f);
        }
        for (int j = 0; j < NQ; ++j) {
            const float vl = c[C_VLIM + j];
            qd[j] = fmaxf(fminf(qd[j] + dt * qdd[j], vl), -vl);
            q[j] = q[j] + dt * qd[j];
        }
        for (int i = 0; i < 3; ++i) {
            pos[i] = pos[i] + dt * vw[i];
            lin[i] = vw[i];
            ang[i] = ww[i];
        }
        // exponential-map quaternion update (pallas_substep.py:74-92)
        const float angle = sqrtf(ww[0] * ww[0] + ww[1] * ww[1] + ww[2] * ww[2]);
        const float inv = 1.0f / fmaxf(angle, 1e-9f);
        const float half = angle * c[S_HALF_DT];
        const float si = sinf(half) * inv, co = cosf(half);
        const float ax_ = ww[0] * si, ay_ = ww[1] * si, az_ = ww[2] * si, aw_ = co;
        const float bx = quat[0], by = quat[1], bz = quat[2], bw = quat[3];
        float qn[4] = {aw_ * bx + ax_ * bw + ay_ * bz - az_ * by,
                       aw_ * by - ax_ * bz + ay_ * bw + az_ * bx,
                       aw_ * bz + ax_ * by - ay_ * bx + az_ * bw,
                       aw_ * bw - ax_ * bx - ay_ * by - az_ * bz};
        const float nrm = fmaxf(sqrtf(qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2]
                                      + qn[3] * qn[3]), 1e-9f);
        for (int i = 0; i < 4; ++i) quat[i] = qn[i] / nrm;
    }

    for (int j = 0; j < NQ; ++j) {
        a.q_o[j * N + n] = q[j];
        a.qd_o[j * N + n] = qd[j];
    }
    for (int i = 0; i < 3; ++i) {
        a.pos_o[i * N + n] = pos[i];
        a.lin_o[i * N + n] = lin[i];
        a.ang_o[i * N + n] = ang[i];
    }
    for (int i = 0; i < 4; ++i) a.quat_o[i * N + n] = quat[i];
    for (int p = 0; p < P; ++p) {
        a.anchors_o[(2 * p) * N + n] = anc[p][0];
        a.anchors_o[(2 * p + 1) * N + n] = anc[p][1];
    }
}

// The arguments common to both variants; the terrain source is set by
// the entry point.
Args make_args(
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
    Args a = {};
    a.q = (const float*)q; a.qd = (const float*)qd; a.pos = (const float*)pos;
    a.quat = (const float*)quat; a.lin = (const float*)lin;
    a.ang = (const float*)ang; a.anchors = (const float*)anchors;
    a.inertias = (const float*)inertias; a.goals = (const float*)goals;
    a.kp = (const float*)kp; a.kd = (const float*)kd;
    a.strength = (const float*)strength; a.offset = (const float*)offset;
    a.friction = (const float*)friction;
    a.restitution = (const float*)restitution;
    a.worigin = (const float*)worigin; a.planes = (const float*)planes;
    a.consts = (const float*)consts;
    a.q_o = (float*)q_o; a.qd_o = (float*)qd_o; a.pos_o = (float*)pos_o;
    a.quat_o = (float*)quat_o; a.lin_o = (float*)lin_o;
    a.ang_o = (float*)ang_o; a.anchors_o = (float*)anchors_o;
    a.report_o = (float*)report_o; a.footpos_o = (float*)footpos_o;
    a.footvel_o = (float*)footvel_o; a.thigh_o = (float*)thigh_o;
    a.tau_o = (float*)tau_o; a.bodypts_o = (float*)bodypts_o;
    a.N = N; a.P = P; a.nrb = nrb; a.decimation = decimation;
    return a;
}

template <bool WINDOW>
int run(const Args& a, int threads, void* stream) {
    if (a.P > MAXP || a.nrb > MAXRB || a.P < NF || threads > 128)
        return (int)cudaErrorInvalidValue;
    if (a.N > 0) {
        const int grid = (a.N + threads - 1) / threads;
        substep_kernel<WINDOW><<<grid, threads, 0, (cudaStream_t)stream>>>(a);
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
#define DTC_STEP_ARGS(worigin, planes, consts)                               \
        make_args(q, qd, pos, quat, lin, ang, anchors, inertias, goals, kp,  \
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
    Args a = DTC_STEP_ARGS(worigin, planes, consts);
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
    Args a = DTC_STEP_ARGS(worigin, planes, consts);
    a.window = (const float*)window;
    a.wsN = sN; a.wsR = sR; a.wsC = sC;
    return run<true>(a, threads, stream);
}
