// K1: one 5 ms control step of the 8-dof balance robot on a flat floor.
//
// Replaces balance_robot_tpu/physics/pallas_step.py::_kernel (the Pallas
// TPU kernel launched by control_step_pallas). Its plain PyTorch version is
// balance_robot_tpu_torch/physics/step.py::control_step, which does the same
// arithmetic one tensor op at a time.
//
// Per substep (frame_skip of them, 250 for a control step, at constant
// ctrl): fk -> com_vel -> CRB mass matrix M -> RNE bias -> velocity-servo
// actuation + wheel damping -> 8x8 Cholesky a_smooth -> 2x4 wheel
// plane-cylinder + 8 chassis plane-box floor candidates -> 64 pyramid rows
// (16 contacts x 4), with an optional per-env wheel friction -> warm start
// chosen by cost -> Newton (fixed newton_iters) with an exact line search
// (fixed ls_iters) -> constraint forces -> implicitfast velocity update on
// M - h*D -> quaternion integration.
//
// Design: one thread per env and all substeps in one launch. Only qpos,
// qvel, warm start, ctrl and friction cross device memory, once each; every
// intermediate stays in registers and thread-local memory. Trip counts are
// fixed, the ragged batch edge is masked in the kernel (no padding), and
// the scene parameters and iteration counts are runtime arguments, so a
// change of solver grade rebuilds nothing.
//
// What bounds it on an H100: operations. Each substep is one long serial
// chain of scalar float math (Hessian assembly over 64 rows, an unrolled
// Cholesky, a line search over 64 rows per step) with no matrix product to
// put on the tensor cores; the bytes moved are ~100 per env per control
// step. The 64 rows (8 J entries + aref + D + mask) plus jar and J*step are
// 832 values per env, far beyond 255 registers, so they live in local
// memory (L1-cached); blocks of 32 threads keep one warp's rows within an
// SM's L1. At B = 4096 that is 128 blocks, one warp per SM: the kernel is
// latency-bound on each thread's chain. Shared-memory rows, skipping masked
// rows and more envs per SM are later work.
//
// ptxas (-Xptxas -v, nvcc 12.8, sm_90a): float kernel 213 registers, 3632
// bytes stack frame, 0 bytes spilled; double kernel 255 registers, 7696
// bytes stack frame, 816 bytes spill stores, 2872 bytes spill loads. The
// stack frame is the per-thread row arrays. chip_smoke.py prints the counts
// of each build.
//
// The same templated code also runs on the host with `Counted`, a double
// that counts every arithmetic operation: k1_count_ops gives the operation
// count from which chip_smoke.py computes the kernel's bound.

#include <cmath>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define K1_HD __host__ __device__ __forceinline__
#else
#define K1_HD inline
#endif

namespace k1 {

constexpr int NV = 8;
constexpr int NCON = 16;
constexpr int NROW = 4 * NCON;
constexpr double FLOOR_Z = -0.02;
constexpr double WHEEL_R = 0.034;
constexpr double WHEEL_H = 0.013;
constexpr double CH_HX = 0.05, CH_HY = 0.0185, CH_HZ = 0.0855;
constexpr double CH_OFF = 0.0995;      // chassis geom / inertia offset (z)
constexpr double WHEEL_X = 0.074;      // wheel body origin (+-x, 0, z)
constexpr double WHEEL_Z = 0.034;
constexpr double MJ_MINVAL = 1e-15;
constexpr double MJ_MINMU = 1e-5;
constexpr double C120 = -0.5, S120 = 0.8660254037844386;

// Per contact-type constants. The wrapper derives them in double from the
// scene's ContactParams, as the Python code evaluates them.
struct ContactP {
  double d0, d1, width, mid, power;  // solimp
  double imp_a, imp_b;               // 1/mid^(power-1), 1/(1-mid)^(power-1)
  double k, b;                       // aref stiffness and damping
  double mu1, mu2;                   // the pair's friction
  double dA1, dA2;                   // 2 mu^2 (1 + mu^2) invweight
  double invweight;
};

struct Params {
  double timestep, gx, gy, gz;
  double m_ch, m_w, ich0, ich1, ich2, iw0, iw1, iw2;
  double damping, act_gain, act_bias, ctrl_range, force_range;
  ContactP wheel, chassis;
};

// ------------------------------------------------------- operation count
static long long g_ops = 0;   // host only: read by k1_count_ops

K1_HD void tick() {
#ifndef __CUDA_ARCH__
  ++g_ops;
#endif
}

// A double that counts +, -, *, / and each math function as one operation
// (host runs only; on the device the count is compiled out).
struct Counted {
  double v;
  K1_HD Counted(double x = 0.0) : v(x) {}
};
K1_HD Counted operator+(Counted a, Counted b) { tick(); return Counted(a.v + b.v); }
K1_HD Counted operator-(Counted a, Counted b) { tick(); return Counted(a.v - b.v); }
K1_HD Counted operator*(Counted a, Counted b) { tick(); return Counted(a.v * b.v); }
K1_HD Counted operator/(Counted a, Counted b) { tick(); return Counted(a.v / b.v); }
K1_HD Counted operator-(Counted a) { return Counted(-a.v); }
K1_HD bool operator<(Counted a, Counted b) { return a.v < b.v; }
K1_HD bool operator>(Counted a, Counted b) { return a.v > b.v; }
K1_HD bool operator>=(Counted a, Counted b) { return a.v >= b.v; }
K1_HD bool operator==(Counted a, Counted b) { return a.v == b.v; }

K1_HD float Sqrt(float x) { return sqrtf(x); }
K1_HD double Sqrt(double x) { return sqrt(x); }
K1_HD Counted Sqrt(Counted x) { tick(); return Counted(sqrt(x.v)); }
K1_HD float Sin(float x) { return sinf(x); }
K1_HD double Sin(double x) { return sin(x); }
K1_HD Counted Sin(Counted x) { tick(); return Counted(sin(x.v)); }
K1_HD float Cos(float x) { return cosf(x); }
K1_HD double Cos(double x) { return cos(x); }
K1_HD Counted Cos(Counted x) { tick(); return Counted(cos(x.v)); }
K1_HD float Pow(float x, float y) { return powf(x, y); }
K1_HD double Pow(double x, double y) { return pow(x, y); }
K1_HD Counted Pow(Counted x, Counted y) { tick(); return Counted(pow(x.v, y.v)); }
K1_HD float Abs(float x) { return fabsf(x); }
K1_HD double Abs(double x) { return fabs(x); }
K1_HD Counted Abs(Counted x) { tick(); return Counted(fabs(x.v)); }

// jnp.maximum / jnp.minimum / jnp.clip
template <typename T> K1_HD T Max(T a, T b) { tick(); return a < b ? b : a; }
template <typename T> K1_HD T Min(T a, T b) { tick(); return b < a ? b : a; }
template <typename T> K1_HD T Clip(T x, T lo, T hi) { return Min(Max(x, lo), hi); }

// ------------------------------------------------------- small algebra
template <typename T>
K1_HD void cross(const T a[3], const T b[3], T out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename T>
K1_HD T dot6(const T a[6], const T b[6]) {
  T s = T(0.0);
  for (int i = 0; i < 6; ++i) s = s + a[i] * b[i];
  return s;
}

// mju_crossMotion: v x s
template <typename T>
K1_HD void motion_cross(const T v[6], const T s[6], T out[6]) {
  T t1[3], t2[3];
  cross(v, s, out);
  cross(v + 3, s, t1);
  cross(v, s + 3, t2);
  for (int i = 0; i < 3; ++i) out[3 + i] = t1[i] + t2[i];
}

// mju_crossForce: v x* f
template <typename T>
K1_HD void force_cross(const T v[6], const T f[6], T out[6]) {
  T t1[3], t2[3];
  cross(v, f, t1);
  cross(v + 3, f + 3, t2);
  for (int i = 0; i < 3; ++i) out[i] = t1[i] + t2[i];
  cross(v, f + 3, out + 3);
}

// mju_mulInertVec: cinert (Ixx,Iyy,Izz,Ixy,Ixz,Iyz,hx,hy,hz,m) * s
template <typename T>
K1_HD void inert_mul(const T ci[10], const T s[6], T out[6]) {
  const T* h = ci + 6;
  T hs[3], ha[3];
  cross(h, s + 3, hs);
  cross(h, s, ha);
  out[0] = ci[0] * s[0] + ci[3] * s[1] + ci[4] * s[2] + hs[0];
  out[1] = ci[3] * s[0] + ci[1] * s[1] + ci[5] * s[2] + hs[1];
  out[2] = ci[4] * s[0] + ci[5] * s[1] + ci[2] * s[2] + hs[2];
  for (int i = 0; i < 3; ++i) out[3 + i] = s[3 + i] * ci[9] - ha[i];
}

// MuJoCo cinert 10-vector: R diag(idiag) R^T shifted to offset d
template <typename T>
K1_HD void cinert(const T R[3][3], T i0, T i1, T i2, T m, const T d[3],
                  T out[10]) {
  T dd = T(0.0);
  for (int a = 0; a < 3; ++a) dd = dd + d[a] * d[a];
  const int ia[6] = {0, 1, 2, 0, 0, 1};
  const int ib[6] = {0, 1, 2, 1, 2, 2};
  for (int e = 0; e < 6; ++e) {
    int a = ia[e], b = ib[e];
    T I = i0 * R[a][0] * R[b][0] + i1 * R[a][1] * R[b][1] +
          i2 * R[a][2] * R[b][2];
    if (a == b) I = I + m * dd;
    out[e] = I - m * d[a] * d[b];
  }
  for (int a = 0; a < 3; ++a) out[6 + a] = d[a] * m;
  out[9] = m;
}

// Unrolled Cholesky of a symmetric positive definite NV x NV matrix
// (lower triangle read) and the two triangular solves.
template <typename T>
K1_HD void chol_factor(const T A[NV][NV], T L[NV][NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      T s = A[i][j];
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = (i == j) ? Sqrt(s) : s / L[j][j];
    }
  }
}

template <typename T>
K1_HD void chol_solve(const T L[NV][NV], const T b[NV], T x[NV]) {
  T y[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    T s = b[i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = NV - 1; i >= 0; --i) {
    T s = y[i];
    for (int k = i + 1; k < NV; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// ------------------------------------------------------- contacts
template <typename T>
K1_HD void floor_point(const T p[3], T pos[3], T* dist, bool* inc) {
  T d = p[2] - T(FLOOR_Z);
  pos[0] = p[0];
  pos[1] = p[1];
  pos[2] = p[2] - d * T(0.5);
  *dist = d;
  *inc = d < T(0.0);
}

// 4 plane-cylinder candidates of one wheel
template <typename T>
K1_HD void plane_cylinder(const T c[3], const T axis[3], T pos[4][3],
                          T dist[4], bool inc[4]) {
  const T r = T(WHEEL_R), h = T(WHEEL_H);
  T ca = axis[2];
  T w_raw[3] = {T(0.0) - axis[0] * ca, T(0.0) - axis[1] * ca,
                T(1.0) - axis[2] * ca};
  T wn = Sqrt(w_raw[0] * w_raw[0] + w_raw[1] * w_raw[1] +
              w_raw[2] * w_raw[2]);
  T safe = Max(wn, T(1e-12));
  T w[3];
  bool ok = wn > T(1e-10);
  w[0] = ok ? w_raw[0] / safe : T(1.0);
  w[1] = ok ? w_raw[1] / safe : T(0.0);
  w[2] = ok ? w_raw[2] / safe : T(0.0);
  T s = ca >= T(0.0) ? T(1.0) : T(-1.0);
  T a_s[3], low[3], upp[3], rim[3], nw[3], v[3], p[3];
  for (int i = 0; i < 3; ++i) {
    a_s[i] = axis[i] * s;
    low[i] = c[i] - a_s[i] * h;
    upp[i] = c[i] + a_s[i] * h;
    rim[i] = w[i] * r;
    nw[i] = w[i] * T(-1.0);
  }
  cross(a_s, nw, v);
  for (int i = 0; i < 3; ++i) p[i] = low[i] - rim[i];
  floor_point(p, pos[0], &dist[0], &inc[0]);
  for (int i = 0; i < 3; ++i) p[i] = upp[i] - rim[i];
  floor_point(p, pos[1], &dist[1], &inc[1]);
  for (int i = 0; i < 3; ++i)
    p[i] = low[i] + (nw[i] * T(C120) + v[i] * T(S120)) * r;
  floor_point(p, pos[2], &dist[2], &inc[2]);
  for (int i = 0; i < 3; ++i)
    p[i] = low[i] + (nw[i] * T(C120) + v[i] * T(-S120)) * r;
  floor_point(p, pos[3], &dist[3], &inc[3]);
}

// 8 chassis plane-box corners; the 4 deepest penetrating ones are kept,
// ranked pairwise with the earlier corner winning ties
template <typename T>
K1_HD void plane_box(const T c[3], const T R[3][3], T pos[8][3], T dist[8],
                     bool inc[8]) {
  for (int i = 0; i < 8; ++i) {
    T l0 = T((i & 1) ? CH_HX : -CH_HX);
    T l1 = T((i & 2) ? CH_HY : -CH_HY);
    T l2 = T((i & 4) ? CH_HZ : -CH_HZ);
    T p[3];
    for (int a = 0; a < 3; ++a)
      p[a] = c[a] + (R[a][0] * l0 + R[a][1] * l1 + R[a][2] * l2);
    floor_point(p, pos[i], &dist[i], &inc[i]);
  }
  bool keep[8];
  for (int i = 0; i < 8; ++i) {
    int rank = 0;
    for (int j = 0; j < 8; ++j)
      if (j != i && (dist[j] < dist[i] || (dist[j] == dist[i] && j < i)))
        ++rank;
    keep[i] = inc[i] && rank < 4;
  }
  for (int i = 0; i < 8; ++i) inc[i] = keep[i];
}

template <typename T>
K1_HD T impedance(T x_pos, const ContactP& c) {
  T x = Clip(Abs(x_pos) / T(c.width), T(0.0), T(1.0));
  T y = x < T(c.mid) ? T(c.imp_a) * Pow(x, T(c.power))
                     : T(1.0) - T(c.imp_b) * Pow(T(1.0) - x, T(c.power));
  return Clip(T(c.d0) + y * T(c.d1 - c.d0), T(0.0001), T(0.9999));
}

// ------------------------------------------------------- one substep
template <typename T>
K1_HD void substep(T qpos[9], T qvel[8], T ws[8], const T ctrl[2], T fric,
                   bool use_fric, const Params& p, int newton_iters,
                   int ls_iters) {
  // ---- fk: pose, body origins, com, cinert, cdof
  T qn = Sqrt(qpos[3] * qpos[3] + qpos[4] * qpos[4] + qpos[5] * qpos[5] +
              qpos[6] * qpos[6]);
  T inv = T(1.0) / qn;
  T w = qpos[3] * inv, x = qpos[4] * inv, y = qpos[5] * inv,
    z = qpos[6] * inv;
  T R[3][3];
  {
    T xx = x * x, yy = y * y, zz = z * z, xy = x * y, xz = x * z,
      yz = y * z, wx = w * x, wy = w * y, wz = w * z;
    R[0][0] = T(1.0) - T(2.0) * (yy + zz);
    R[0][1] = T(2.0) * (xy - wz);
    R[0][2] = T(2.0) * (xz + wy);
    R[1][0] = T(2.0) * (xy + wz);
    R[1][1] = T(1.0) - T(2.0) * (xx + zz);
    R[1][2] = T(2.0) * (yz - wx);
    R[2][0] = T(2.0) * (xz - wy);
    R[2][1] = T(2.0) * (yz + wx);
    R[2][2] = T(1.0) - T(2.0) * (xx + yy);
  }
  T pos[3] = {qpos[0], qpos[1], qpos[2]};
  T xl[3], xr[3], xich[3], com[3];
  const T m_ch = T(p.m_ch), m_w = T(p.m_w);
  const T inv_mtot = T(1.0 / (p.m_ch + 2 * p.m_w));
  for (int a = 0; a < 3; ++a) {
    xl[a] = pos[a] + (R[a][0] * T(-WHEEL_X) + R[a][2] * T(WHEEL_Z));
    xr[a] = pos[a] + (R[a][0] * T(WHEEL_X) + R[a][2] * T(WHEEL_Z));
    xich[a] = pos[a] + R[a][2] * T(CH_OFF);
    com[a] = (xich[a] * m_ch + (xl[a] * m_w + xr[a] * m_w)) * inv_mtot;
  }
  T cin[3][10];
  {
    T d[3];
    for (int a = 0; a < 3; ++a) d[a] = xich[a] - com[a];
    cinert(R, T(p.ich0), T(p.ich1), T(p.ich2), m_ch, d, cin[0]);
    for (int a = 0; a < 3; ++a) d[a] = xl[a] - com[a];
    cinert(R, T(p.iw2), T(p.iw0), T(p.iw1), m_w, d, cin[1]);
    for (int a = 0; a < 3; ++a) d[a] = xr[a] - com[a];
    cinert(R, T(p.iw2), T(p.iw0), T(p.iw1), m_w, d, cin[2]);
  }
  T cdof[NV][6];
  for (int i = 0; i < 3; ++i)
    for (int a = 0; a < 6; ++a) cdof[i][a] = T(a == 3 + i ? 1.0 : 0.0);
  {
    T off[3];
    for (int a = 0; a < 3; ++a) off[a] = com[a] - pos[a];
    for (int i = 0; i < 3; ++i) {
      for (int a = 0; a < 3; ++a) cdof[3 + i][a] = R[a][i];
      cross(cdof[3 + i], off, cdof[3 + i] + 3);
    }
    for (int a = 0; a < 3; ++a) {
      cdof[6][a] = -R[a][0];
      cdof[7][a] = R[a][0];
    }
    for (int a = 0; a < 3; ++a) off[a] = com[a] - xl[a];
    cross(cdof[6], off, cdof[6] + 3);
    for (int a = 0; a < 3; ++a) off[a] = com[a] - xr[a];
    cross(cdof[7], off, cdof[7] + 3);
  }

  // ---- com_vel: cvel per body and cdof_dot (rows 0-2 are zero)
  T cvel[3][6], cdof_dot[NV][6];
  {
    T cvel_t[6] = {T(0.0), T(0.0), T(0.0), qvel[0], qvel[1], qvel[2]};
    for (int i = 3; i < 6; ++i) motion_cross(cvel_t, cdof[i], cdof_dot[i]);
    for (int a = 0; a < 6; ++a) {
      T s = cvel_t[a];
      for (int i = 3; i < 6; ++i) s = s + cdof[i][a] * qvel[i];
      cvel[0][a] = s;
    }
    motion_cross(cvel[0], cdof[6], cdof_dot[6]);
    motion_cross(cvel[0], cdof[7], cdof_dot[7]);
    for (int a = 0; a < 6; ++a) {
      cvel[1][a] = cvel[0][a] + cdof[6][a] * qvel[6];
      cvel[2][a] = cvel[0][a] + cdof[7][a] * qvel[7];
    }
  }

  // ---- CRB mass matrix
  T M[NV][NV];
  {
    T crb[10], f[6];
    for (int e = 0; e < 10; ++e) crb[e] = cin[0][e] + cin[1][e] + cin[2][e];
    for (int j = 0; j < 6; ++j) {
      inert_mul(crb, cdof[j], f);
      for (int i = 0; i <= j; ++i) {
        M[i][j] = dot6(cdof[i], f);
        M[j][i] = M[i][j];
      }
    }
    for (int wh = 0; wh < 2; ++wh) {
      int dof = 6 + wh;
      inert_mul(cin[1 + wh], cdof[dof], f);
      for (int i = 0; i < 6; ++i) {
        M[i][dof] = dot6(cdof[i], f);
        M[dof][i] = M[i][dof];
      }
      M[dof][dof] = dot6(cdof[dof], f);
    }
    M[6][7] = T(0.0);
    M[7][6] = T(0.0);
  }

  // ---- RNE bias
  T bias[NV];
  {
    T cacc[3][6];
    T g6[6] = {T(0.0), T(0.0), T(0.0), T(-p.gx), T(-p.gy), T(-p.gz)};
    for (int a = 0; a < 6; ++a) {
      T s = g6[a];
      for (int j = 3; j < 6; ++j) s = s + cdof_dot[j][a] * qvel[j];
      cacc[0][a] = s;
    }
    for (int a = 0; a < 6; ++a) {
      cacc[1][a] = cacc[0][a] + cdof_dot[6][a] * qvel[6];
      cacc[2][a] = cacc[0][a] + cdof_dot[7][a] * qvel[7];
    }
    T frc[3][6], tot[6];
    for (int bd = 0; bd < 3; ++bd) {
      T f1[6], pm[6], fc[6];
      inert_mul(cin[bd], cacc[bd], f1);
      inert_mul(cin[bd], cvel[bd], pm);
      force_cross(cvel[bd], pm, fc);
      for (int a = 0; a < 6; ++a) frc[bd][a] = f1[a] + fc[a];
    }
    for (int a = 0; a < 6; ++a) tot[a] = frc[0][a] + frc[1][a] + frc[2][a];
    for (int j = 0; j < 6; ++j) bias[j] = dot6(cdof[j], tot);
    bias[6] = dot6(cdof[6], frc[1]);
    bias[7] = dot6(cdof[7], frc[2]);
  }

  // ---- actuation, passive damping, a_smooth
  T qfrc_smooth[NV], dfdv[2];
  for (int j = 0; j < 6; ++j) qfrc_smooth[j] = -bias[j];
  for (int i = 0; i < 2; ++i) {
    T c = Clip(ctrl[i], T(-p.ctrl_range), T(p.ctrl_range));
    T raw = T(p.act_gain) * c + T(p.act_bias) * qvel[6 + i];
    T frc = Clip(raw, T(-p.force_range), T(p.force_range));
    dfdv[i] = Abs(raw) < T(p.force_range) ? T(p.act_bias) : T(0.0);
    qfrc_smooth[6 + i] = (frc + T(-p.damping) * qvel[6 + i]) - bias[6 + i];
  }
  T L[NV][NV], a_smooth[NV];
  chol_factor(M, L);
  chol_solve(L, qfrc_smooth, a_smooth);

  // ---- floor contacts: left wheel 0-3, right wheel 4-7, chassis 8-15
  T cpos[NCON][3], cdist[NCON];
  bool cinc[NCON];
  {
    T axis[3] = {R[0][0], R[1][0], R[2][0]};
    plane_cylinder(xl, axis, cpos, cdist, cinc);
    plane_cylinder(xr, axis, cpos + 4, cdist + 4, cinc + 4);
    T cc[3];
    for (int a = 0; a < 3; ++a) cc[a] = pos[a] + R[a][2] * T(CH_OFF);
    plane_box(cc, R, cpos + 8, cdist + 8, cinc + 8);
  }

  // ---- pyramid rows, per contact (mu1,+), (mu1,-), (mu2,+), (mu2,-)
  T J[NROW][NV], aref[NROW], D[NROW], mask[NROW];
#pragma unroll 1
  for (int c = 0; c < NCON; ++c) {
    const int body = c < 4 ? 1 : (c < 8 ? 2 : 0);
    const ContactP& prm = body ? p.wheel : p.chassis;
    T mu1 = T(prm.mu1), mu2 = T(prm.mu2), dA1 = T(prm.dA1), dA2 = T(prm.dA2);
    if (use_fric && body) {
      mu1 = Max(fric, T(MJ_MINMU));
      mu2 = mu1;
      dA1 = T(2.0) * mu1 * mu1 * (T(1.0) + mu1 * mu1) * T(prm.invweight);
      dA2 = dA1;
    }
    T imp = impedance(cdist[c], prm);
    T Jn[NV], Jt1[NV], Jt2[NV];
    T rel[3];
    for (int a = 0; a < 3; ++a) rel[a] = cpos[c][a] - com[a];
    for (int j = 0; j < NV; ++j) {
      bool in_chain = j < 6 || (body == 1 && j == 6) || (body == 2 && j == 7);
      if (in_chain) {
        const T* ang = cdof[j];
        const T* lin = cdof[j] + 3;
        T vx = lin[0] + ang[1] * rel[2] - ang[2] * rel[1];
        T vy = lin[1] + ang[2] * rel[0] - ang[0] * rel[2];
        T vz = lin[2] + ang[0] * rel[1] - ang[1] * rel[0];
        Jn[j] = vz;
        Jt1[j] = vy;
        Jt2[j] = -vx;
      } else {
        Jn[j] = Jt1[j] = Jt2[j] = T(0.0);
      }
    }
    T inc = cinc[c] ? T(1.0) : T(0.0);
    T stiff = T(prm.k) * imp * cdist[c];
    for (int d = 0; d < 2; ++d) {
      T mu = d ? mu2 : mu1;
      T dA = d ? dA2 : dA1;
      const T* Jt = d ? Jt2 : Jt1;
      T Rr = Max(T(MJ_MINVAL), (T(1.0) - imp) / imp * dA);
      T Dv = T(1.0) / Rr;
      for (int sg = 0; sg < 2; ++sg) {
        int r = 4 * c + 2 * d + sg;
        T smu = sg ? -mu : mu;
        T vel = T(0.0);
        for (int j = 0; j < NV; ++j) {
          J[r][j] = Jn[j] + smu * Jt[j];
          vel = vel + J[r][j] * qvel[j];
        }
        aref[r] = T(-prm.b) * vel - stiff;
        D[r] = Dv;
        mask[r] = inc;
      }
    }
  }

  // ---- warm start: the better of ws and a_smooth by cost
  T jar[NROW], Jd[NROW];
  T a[NV];
  {
    T cst[2];
    for (int pick = 0; pick < 2; ++pick) {
      const T* aa = pick ? a_smooth : ws;
      T da[NV];
      for (int j = 0; j < NV; ++j) da[j] = aa[j] - a_smooth[j];
      T c = T(0.0);
      for (int r = 0; r < NV; ++r) {
        T s = T(0.0);
        for (int j = 0; j < NV; ++j) s = s + M[r][j] * da[j];
        c = c + T(0.5) * da[r] * s;
      }
      T q = T(0.0);
#pragma unroll 1
      for (int r = 0; r < NROW; ++r) {
        T s = J[r][0] * aa[0];
        for (int j = 1; j < NV; ++j) s = s + J[r][j] * aa[j];
        s = s - aref[r];
        T act = s < T(0.0) ? mask[r] : T(0.0);
        q = q + D[r] * act * s * s;
      }
      cst[pick] = c + T(0.5) * q;
    }
    bool better = cst[0] < cst[1];
    for (int j = 0; j < NV; ++j) a[j] = better ? ws[j] : a_smooth[j];
  }

  // ---- Newton with exact line search, fixed trip counts
  for (int it = 0; it < newton_iters; ++it) {
    T da[NV], g[NV], H[NV][NV];
    for (int j = 0; j < NV; ++j) da[j] = a[j] - a_smooth[j];
    for (int r = 0; r < NV; ++r) {
      T s = T(0.0);
      for (int j = 0; j < NV; ++j) s = s + M[r][j] * da[j];
      g[r] = s;
      for (int c2 = 0; c2 <= r; ++c2) H[r][c2] = T(0.0);
    }
#pragma unroll 1
    for (int row = 0; row < NROW; ++row) {
      T s = J[row][0] * a[0];
      for (int j = 1; j < NV; ++j) s = s + J[row][j] * a[j];
      s = s - aref[row];
      jar[row] = s;
      T wgt = D[row] * (s < T(0.0) ? mask[row] : T(0.0));
      T wj = wgt * s;
      for (int r = 0; r < NV; ++r) {
        g[r] = g[r] + wj * J[row][r];
        T wr = wgt * J[row][r];
        for (int c2 = 0; c2 <= r; ++c2) H[r][c2] = H[r][c2] + wr * J[row][c2];
      }
    }
    for (int r = 0; r < NV; ++r)
      for (int c2 = 0; c2 <= r; ++c2) {
        H[r][c2] = M[r][c2] + H[r][c2];
        H[c2][r] = H[r][c2];
      }
    T Lh[NV][NV], ng[NV], step[NV];
    chol_factor(H, Lh);
    for (int j = 0; j < NV; ++j) ng[j] = -g[j];
    chol_solve(Lh, ng, step);

    T dMd = T(0.0), dMda = T(0.0);
    for (int r = 0; r < NV; ++r) {
      T s = T(0.0);
      for (int j = 0; j < NV; ++j) s = s + M[r][j] * step[j];
      dMd = dMd + step[r] * s;
      dMda = dMda + s * da[r];
    }
#pragma unroll 1
    for (int row = 0; row < NROW; ++row) {
      T s = J[row][0] * step[0];
      for (int j = 1; j < NV; ++j) s = s + J[row][j] * step[j];
      Jd[row] = s;
    }
    T t = T(1.0);
    for (int ls = 0; ls < ls_iters; ++ls) {
      T s1 = T(0.0), s2 = T(0.0);
#pragma unroll 1
      for (int row = 0; row < NROW; ++row) {
        T jt = jar[row] + t * Jd[row];
        T act = jt < T(0.0) ? mask[row] : T(0.0);
        T aDJd = act * (D[row] * Jd[row]);
        s1 = s1 + aDJd * jt;
        s2 = s2 + aDJd * Jd[row];
      }
      T phi1 = dMda + t * dMd + s1;
      T phi2 = dMd + s2;
      t = t - phi1 / Max(phi2, T(MJ_MINVAL));
    }
    t = Max(t, T(0.0));
    for (int j = 0; j < NV; ++j) a[j] = a[j] + t * step[j];
  }

  // ---- constraint forces and implicitfast integration
  T qfrc[NV];
  for (int j = 0; j < NV; ++j) qfrc[j] = qfrc_smooth[j];
  {
    T qcon[NV];
    for (int j = 0; j < NV; ++j) qcon[j] = T(0.0);
#pragma unroll 1
    for (int row = 0; row < NROW; ++row) {
      T s = J[row][0] * a[0];
      for (int j = 1; j < NV; ++j) s = s + J[row][j] * a[j];
      s = s - aref[row];
      T f = mask[row] * D[row] * Max(-s, T(0.0));
      for (int j = 0; j < NV; ++j) qcon[j] = qcon[j] + f * J[row][j];
    }
    for (int j = 0; j < NV; ++j) qfrc[j] = qfrc[j] + qcon[j];
  }
  const T h = T(p.timestep);
  for (int i = 0; i < 2; ++i)
    M[6 + i][6 + i] = M[6 + i][6 + i] - h * (T(-p.damping) + dfdv[i]);
  T dv[NV];
  chol_factor(M, L);
  chol_solve(L, qfrc, dv);
  for (int j = 0; j < NV; ++j) {
    qvel[j] = qvel[j] + h * dv[j];
    ws[j] = a[j];
  }
  for (int i = 0; i < 3; ++i) qpos[i] = qpos[i] + h * qvel[i];
  {
    // mj_integratePos for the free joint's quaternion
    T wx = qvel[3], wy = qvel[4], wz = qvel[5];
    T norm = Sqrt(wx * wx + wy * wy + wz * wz);
    T angle = h * norm;
    bool moving = norm > T(0.0);
    T safe_n = moving ? norm : T(1.0);
    T half = angle * T(0.5);
    T s = moving ? Sin(half) : T(0.0);
    T dq[4] = {Cos(half), wx / safe_n * s, wy / safe_n * s, wz / safe_n * s};
    T q1[4] = {qpos[3], qpos[4], qpos[5], qpos[6]};
    T qq[4];
    qq[0] = q1[0] * dq[0] - q1[1] * dq[1] - q1[2] * dq[2] - q1[3] * dq[3];
    qq[1] = q1[0] * dq[1] + q1[1] * dq[0] + q1[2] * dq[3] - q1[3] * dq[2];
    qq[2] = q1[0] * dq[2] - q1[1] * dq[3] + q1[2] * dq[0] + q1[3] * dq[1];
    qq[3] = q1[0] * dq[3] + q1[1] * dq[2] - q1[2] * dq[1] + q1[3] * dq[0];
    T n = Sqrt(qq[0] * qq[0] + qq[1] * qq[1] + qq[2] * qq[2] + qq[3] * qq[3]);
    T ninv = T(1.0) / n;
    for (int i = 0; i < 4; ++i) qpos[3 + i] = qq[i] * ninv;
  }
  qpos[7] = qpos[7] + h * qvel[6];
  qpos[8] = qpos[8] + h * qvel[7];
}

template <typename T>
K1_HD void control_step_one(T q[9], T v[8], T w[8], const T c[2], T fric,
                            bool use_fric, const Params& p, int newton_iters,
                            int ls_iters, int frame_skip) {
  for (int s = 0; s < frame_skip; ++s)
    substep(q, v, w, c, fric, use_fric, p, newton_iters, ls_iters);
}

#ifdef __CUDACC__
template <typename T>
__global__ void control_step_kernel(
    const T* __restrict__ qpos, const T* __restrict__ qvel,
    const T* __restrict__ ws, const T* __restrict__ ctrl,
    const T* __restrict__ fric, T* __restrict__ qpos_out,
    T* __restrict__ qvel_out, T* __restrict__ ws_out, int B, Params p,
    int newton_iters, int ls_iters, int frame_skip, int use_fric) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  T q[9], v[8], w[8], c[2];
  for (int k = 0; k < 9; ++k) q[k] = qpos[9 * i + k];
  for (int k = 0; k < 8; ++k) {
    v[k] = qvel[8 * i + k];
    w[k] = ws[8 * i + k];
  }
  c[0] = ctrl[2 * i];
  c[1] = ctrl[2 * i + 1];
  T f = use_fric ? fric[i] : T(0.0);
  control_step_one(q, v, w, c, f, use_fric != 0, p, newton_iters, ls_iters,
                   frame_skip);
  for (int k = 0; k < 9; ++k) qpos_out[9 * i + k] = q[k];
  for (int k = 0; k < 8; ++k) {
    qvel_out[8 * i + k] = v[k];
    ws_out[8 * i + k] = w[k];
  }
}

constexpr int THREADS = 32;

template <typename T>
int launch(const T* qpos, const T* qvel, const T* ws, const T* ctrl,
           const T* fric, T* qpos_out, T* qvel_out, T* ws_out, int B,
           const Params* p, int newton_iters, int ls_iters, int frame_skip,
           int use_fric, void* stream) {
  const int blocks = (B + THREADS - 1) / THREADS;
  control_step_kernel<T><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      qpos, qvel, ws, ctrl, fric, qpos_out, qvel_out, ws_out, B, *p,
      newton_iters, ls_iters, frame_skip, use_fric);
  return (int)cudaGetLastError();
}
#endif

}  // namespace k1

extern "C" {

#ifdef __CUDACC__
// Launch K1 on `stream` for B envs (row-major (B,9)/(B,8)/(B,8)/(B,2)
// inputs, fric (B,) or null). Returns cudaGetLastError() after the launch.
int k1_control_step_f32(const float* qpos, const float* qvel, const float* ws,
                        const float* ctrl, const float* fric, float* qpos_out,
                        float* qvel_out, float* ws_out, int B,
                        const k1::Params* p, int newton_iters, int ls_iters,
                        int frame_skip, int use_fric, void* stream) {
  return k1::launch(qpos, qvel, ws, ctrl, fric, qpos_out, qvel_out, ws_out, B,
                    p, newton_iters, ls_iters, frame_skip, use_fric, stream);
}

int k1_control_step_f64(const double* qpos, const double* qvel,
                        const double* ws, const double* ctrl,
                        const double* fric, double* qpos_out,
                        double* qvel_out, double* ws_out, int B,
                        const k1::Params* p, int newton_iters, int ls_iters,
                        int frame_skip, int use_fric, void* stream) {
  return k1::launch(qpos, qvel, ws, ctrl, fric, qpos_out, qvel_out, ws_out, B,
                    p, newton_iters, ls_iters, frame_skip, use_fric, stream);
}
#endif

// One env's control step on the host in double precision, with every
// arithmetic operation counted. Writes the new state and returns the count.
long long k1_count_ops(const double* qpos, const double* qvel,
                       const double* ws, const double* ctrl, double fric,
                       double* qpos_out, double* qvel_out, double* ws_out,
                       const k1::Params* p, int newton_iters, int ls_iters,
                       int frame_skip, int use_fric) {
  using T = k1::Counted;
  T q[9], v[8], w[8], c[2];
  for (int k = 0; k < 9; ++k) q[k] = T(qpos[k]);
  for (int k = 0; k < 8; ++k) {
    v[k] = T(qvel[k]);
    w[k] = T(ws[k]);
  }
  c[0] = T(ctrl[0]);
  c[1] = T(ctrl[1]);
  k1::g_ops = 0;
  k1::control_step_one(q, v, w, c, T(fric), use_fric != 0, *p, newton_iters,
                       ls_iters, frame_skip);
  for (int k = 0; k < 9; ++k) qpos_out[k] = q[k].v;
  for (int k = 0; k < 8; ++k) {
    qvel_out[k] = v[k].v;
    ws_out[k] = w[k].v;
  }
  return k1::g_ops;
}

}  // extern "C"
