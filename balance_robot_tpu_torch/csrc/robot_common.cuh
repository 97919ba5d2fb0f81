// Device code shared by the fused control-step kernels (K1: control_step.cu,
// 8-dof robot on a flat floor; K2: control_step14.cu, robot + block; K3:
// control_step_walls.cu, robot between static walls).
//
// Everything here is templated on the scalar type T (float, double, or the
// host-only `Counted`) and, where the size matters, on the number of dofs
// NV. The same code compiles as plain C++: a kernel's `*_count_ops` entry
// point runs it on the host with `Counted`, a double that counts every
// arithmetic operation.
//
// Contents: math wrappers, 3-vector / spatial algebra, an N x N Cholesky,
// the robot's smooth dynamics (fk, com_vel, CRB, RNE, actuation), the floor
// colliders (plane-cylinder, plane-box), the solver impedance, the pyramid
// row emitter, and the Newton solver with its exact line search followed by
// the implicitfast velocity update.

#pragma once

#include <cmath>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define BRT_HD __host__ __device__ __forceinline__
#else
#define BRT_HD inline
#endif

namespace brt {

constexpr int NV_ROBOT = 8;
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
static long long g_ops = 0;   // host only: read by the *_count_ops entries

BRT_HD void tick() {
#ifndef __CUDA_ARCH__
  ++g_ops;
#endif
}

// A double that counts +, -, *, / and each math function as one operation
// (host runs only; on the device the count is compiled out).
struct Counted {
  double v;
  BRT_HD Counted(double x = 0.0) : v(x) {}
};
BRT_HD Counted operator+(Counted a, Counted b) { tick(); return Counted(a.v + b.v); }
BRT_HD Counted operator-(Counted a, Counted b) { tick(); return Counted(a.v - b.v); }
BRT_HD Counted operator*(Counted a, Counted b) { tick(); return Counted(a.v * b.v); }
BRT_HD Counted operator/(Counted a, Counted b) { tick(); return Counted(a.v / b.v); }
BRT_HD Counted operator-(Counted a) { return Counted(-a.v); }
BRT_HD bool operator<(Counted a, Counted b) { return a.v < b.v; }
BRT_HD bool operator>(Counted a, Counted b) { return a.v > b.v; }
BRT_HD bool operator<=(Counted a, Counted b) { return a.v <= b.v; }
BRT_HD bool operator>=(Counted a, Counted b) { return a.v >= b.v; }
BRT_HD bool operator==(Counted a, Counted b) { return a.v == b.v; }
BRT_HD bool operator!=(Counted a, Counted b) { return a.v != b.v; }

BRT_HD float Sqrt(float x) { return sqrtf(x); }
BRT_HD double Sqrt(double x) { return sqrt(x); }
BRT_HD Counted Sqrt(Counted x) { tick(); return Counted(sqrt(x.v)); }
BRT_HD float Sin(float x) { return sinf(x); }
BRT_HD double Sin(double x) { return sin(x); }
BRT_HD Counted Sin(Counted x) { tick(); return Counted(sin(x.v)); }
BRT_HD float Cos(float x) { return cosf(x); }
BRT_HD double Cos(double x) { return cos(x); }
BRT_HD Counted Cos(Counted x) { tick(); return Counted(cos(x.v)); }
BRT_HD float Pow(float x, float y) { return powf(x, y); }
BRT_HD double Pow(double x, double y) { return pow(x, y); }
BRT_HD Counted Pow(Counted x, Counted y) { tick(); return Counted(pow(x.v, y.v)); }
BRT_HD float Abs(float x) { return fabsf(x); }
BRT_HD double Abs(double x) { return fabs(x); }
BRT_HD Counted Abs(Counted x) { tick(); return Counted(fabs(x.v)); }

// jnp.maximum / jnp.minimum / jnp.clip
template <typename T> BRT_HD T Max(T a, T b) { tick(); return a < b ? b : a; }
template <typename T> BRT_HD T Min(T a, T b) { tick(); return b < a ? b : a; }
template <typename T> BRT_HD T Clip(T x, T lo, T hi) { return Min(Max(x, lo), hi); }

// ------------------------------------------------------- small algebra
template <typename T>
BRT_HD void cross(const T a[3], const T b[3], T out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename T>
BRT_HD T dot3(const T a[3], const T b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

template <typename T>
BRT_HD T dot6(const T a[6], const T b[6]) {
  T s = T(0.0);
  for (int i = 0; i < 6; ++i) s = s + a[i] * b[i];
  return s;
}

// mju_crossMotion: v x s
template <typename T>
BRT_HD void motion_cross(const T v[6], const T s[6], T out[6]) {
  T t1[3], t2[3];
  cross(v, s, out);
  cross(v + 3, s, t1);
  cross(v, s + 3, t2);
  for (int i = 0; i < 3; ++i) out[3 + i] = t1[i] + t2[i];
}

// mju_crossForce: v x* f
template <typename T>
BRT_HD void force_cross(const T v[6], const T f[6], T out[6]) {
  T t1[3], t2[3];
  cross(v, f, t1);
  cross(v + 3, f + 3, t2);
  for (int i = 0; i < 3; ++i) out[i] = t1[i] + t2[i];
  cross(v, f + 3, out + 3);
}

// mju_mulInertVec: cinert (Ixx,Iyy,Izz,Ixy,Ixz,Iyz,hx,hy,hz,m) * s
template <typename T>
BRT_HD void inert_mul(const T ci[10], const T s[6], T out[6]) {
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
BRT_HD void cinert(const T R[3][3], T i0, T i1, T i2, T m, const T d[3],
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

// Rotation matrix of the normalized quaternion q = (w, x, y, z)
template <typename T>
BRT_HD void quat_to_mat(const T q[4], T R[3][3]) {
  T qn = Sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  T inv = T(1.0) / qn;
  T w = q[0] * inv, x = q[1] * inv, y = q[2] * inv, z = q[3] * inv;
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

// mj_integratePos for a free joint's quaternion: q <- normalize(q * exp(h w/2)),
// w body-local
template <typename T>
BRT_HD void quat_integrate(T q[4], const T w[3], T h) {
  T wx = w[0], wy = w[1], wz = w[2];
  T norm = Sqrt(wx * wx + wy * wy + wz * wz);
  T angle = h * norm;
  bool moving = norm > T(0.0);
  T safe_n = moving ? norm : T(1.0);
  T half = angle * T(0.5);
  T s = moving ? Sin(half) : T(0.0);
  T dq[4] = {Cos(half), wx / safe_n * s, wy / safe_n * s, wz / safe_n * s};
  T q1[4] = {q[0], q[1], q[2], q[3]};
  T qq[4];
  qq[0] = q1[0] * dq[0] - q1[1] * dq[1] - q1[2] * dq[2] - q1[3] * dq[3];
  qq[1] = q1[0] * dq[1] + q1[1] * dq[0] + q1[2] * dq[3] - q1[3] * dq[2];
  qq[2] = q1[0] * dq[2] - q1[1] * dq[3] + q1[2] * dq[0] + q1[3] * dq[1];
  qq[3] = q1[0] * dq[3] + q1[1] * dq[2] - q1[2] * dq[1] + q1[3] * dq[0];
  T n = Sqrt(qq[0] * qq[0] + qq[1] * qq[1] + qq[2] * qq[2] + qq[3] * qq[3]);
  T ninv = T(1.0) / n;
  for (int i = 0; i < 4; ++i) q[i] = qq[i] * ninv;
}

// Cholesky of a symmetric positive definite N x N matrix (lower triangle
// read) and the two triangular solves. Fully unrolled up to N = 8, where L
// fits in registers; a rolled outer loop beyond that.
template <typename T, int N>
BRT_HD void chol_factor(const T A[N][N], T L[N][N]) {
#pragma unroll(N <= 8 ? N : 1)
  for (int i = 0; i < N; ++i) {
#pragma unroll(N <= 8 ? N : 1)
    for (int j = 0; j <= i; ++j) {
      T s = A[i][j];
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = (i == j) ? Sqrt(s) : s / L[j][j];
    }
  }
}

template <typename T, int N>
BRT_HD void chol_solve(const T L[N][N], const T b[N], T x[N]) {
  T y[N];
#pragma unroll(N <= 8 ? N : 1)
  for (int i = 0; i < N; ++i) {
    T s = b[i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll(N <= 8 ? N : 1)
  for (int i = N - 1; i >= 0; --i) {
    T s = y[i];
    for (int k = i + 1; k < N; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// ------------------------------------------------------- floor colliders
template <typename T>
BRT_HD void floor_point(const T p[3], T margin, T pos[3], T* dist,
                        bool* inc) {
  T d = p[2] - T(FLOOR_Z);
  pos[0] = p[0];
  pos[1] = p[1];
  pos[2] = p[2] - d * T(0.5);
  *dist = d;
  *inc = d < margin;
}

// 4 plane-cylinder candidates of one wheel
template <typename T>
BRT_HD void plane_cylinder(const T c[3], const T axis[3], T pos[4][3],
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
  floor_point(p, T(0.0), pos[0], &dist[0], &inc[0]);
  for (int i = 0; i < 3; ++i) p[i] = upp[i] - rim[i];
  floor_point(p, T(0.0), pos[1], &dist[1], &inc[1]);
  for (int i = 0; i < 3; ++i)
    p[i] = low[i] + (nw[i] * T(C120) + v[i] * T(S120)) * r;
  floor_point(p, T(0.0), pos[2], &dist[2], &inc[2]);
  for (int i = 0; i < 3; ++i)
    p[i] = low[i] + (nw[i] * T(C120) + v[i] * T(-S120)) * r;
  floor_point(p, T(0.0), pos[3], &dist[3], &inc[3]);
}

// 8 plane-box corners of a box with half-extents (hx, hy, hz); the 4
// deepest ones closer than `margin` are kept, ranked pairwise with the
// earlier corner winning ties
template <typename T>
BRT_HD void plane_box(const T c[3], const T R[3][3], double hx, double hy,
                      double hz, T margin, T pos[8][3], T dist[8],
                      bool inc[8]) {
  for (int i = 0; i < 8; ++i) {
    T l0 = T((i & 1) ? hx : -hx);
    T l1 = T((i & 2) ? hy : -hy);
    T l2 = T((i & 4) ? hz : -hz);
    T p[3];
    for (int a = 0; a < 3; ++a)
      p[a] = c[a] + (R[a][0] * l0 + R[a][1] * l1 + R[a][2] * l2);
    floor_point(p, margin, pos[i], &dist[i], &inc[i]);
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
BRT_HD T impedance(T x_pos, const ContactP& c) {
  T x = Clip(Abs(x_pos) / T(c.width), T(0.0), T(1.0));
  T y = x < T(c.mid) ? T(c.imp_a) * Pow(x, T(c.power))
                     : T(1.0) - T(c.imp_b) * Pow(T(1.0) - x, T(c.power));
  return Clip(T(c.d0) + y * T(c.d1 - c.d0), T(0.0001), T(0.9999));
}

// ------------------------------------------------------- robot dynamics
// What the contact stage needs of the robot's kinematics.
template <typename T>
struct RobotKin {
  T R[3][3];              // chassis rotation
  T pos[3];               // chassis body origin
  T xl[3], xr[3];         // wheel body origins
  T com[3];               // robot subtree com
  T cdof[NV_ROBOT][6];    // motion axes about com, (angular, linear)
};

// fk -> com_vel -> CRB -> RNE -> actuation for the 8-dof robot. Writes the
// robot's 8 x 8 block of M (both triangles), qfrc_smooth[0..7] (actuation +
// wheel damping - bias) and the actuators' force/velocity derivative.
template <typename T, int NV>
BRT_HD void robot_smooth(const T qpos[9], const T* qvel, const T ctrl[2],
                         const Params& p, RobotKin<T>& k, T M[NV][NV],
                         T qfrc_smooth[NV], T dfdv[2]) {
  // ---- fk: pose, body origins, com, cinert, cdof
  T (&R)[3][3] = k.R;
  T (&pos)[3] = k.pos;
  T (&xl)[3] = k.xl;
  T (&xr)[3] = k.xr;
  T (&com)[3] = k.com;
  T (&cdof)[NV_ROBOT][6] = k.cdof;
  quat_to_mat(qpos + 3, R);
  pos[0] = qpos[0];
  pos[1] = qpos[1];
  pos[2] = qpos[2];
  T xich[3];
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
  T cvel[3][6], cdof_dot[NV_ROBOT][6];
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
  T bias[NV_ROBOT];
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

  // ---- actuation and passive damping
  for (int j = 0; j < 6; ++j) qfrc_smooth[j] = -bias[j];
  for (int i = 0; i < 2; ++i) {
    T c = Clip(ctrl[i], T(-p.ctrl_range), T(p.ctrl_range));
    T raw = T(p.act_gain) * c + T(p.act_bias) * qvel[6 + i];
    T frc = Clip(raw, T(-p.force_range), T(p.force_range));
    dfdv[i] = Abs(raw) < T(p.force_range) ? T(p.act_bias) : T(0.0);
    qfrc_smooth[6 + i] = (frc + T(-p.damping) * qvel[6 + i]) - bias[6 + i];
  }
}

// ------------------------------------------------------- pyramid rows
// The 4 rows (mu1,+), (mu1,-), (mu2,+), (mu2,-) of one contact, from its
// point Jacobian along the normal (Jn) and the two tangents (Jt1, Jt2),
// written at rows r .. r+3.
template <typename T, int NV>
BRT_HD void emit_rows(int r, const T Jn[NV], const T Jt1[NV],
                      const T Jt2[NV], T dist, T mu1, T mu2, T dA1, T dA2,
                      const ContactP& prm, const T* qvel, T (*J)[NV],
                      T* aref, T* D) {
  T imp = impedance(dist, prm);
  T stiff = T(prm.k) * imp * dist;
  for (int d = 0; d < 2; ++d) {
    T mu = d ? mu2 : mu1;
    T dA = d ? dA2 : dA1;
    const T* Jt = d ? Jt2 : Jt1;
    T Rr = Max(T(MJ_MINVAL), (T(1.0) - imp) / imp * dA);
    T Dv = T(1.0) / Rr;
    for (int sg = 0; sg < 2; ++sg) {
      int row = r + 2 * d + sg;
      T smu = sg ? -mu : mu;
      T vel = T(0.0);
      for (int j = 0; j < NV; ++j) {
        J[row][j] = Jn[j] + smu * Jt[j];
        vel = vel + J[row][j] * qvel[j];
      }
      aref[row] = T(-prm.b) * vel - stiff;
      D[row] = Dv;
    }
  }
}

// Rows of one floor contact of robot body `body` (0 chassis, 1 left wheel,
// 2 right wheel) at `cpos`, in the constant floor frame
// (n, t1, t2) = ((0,0,1), (0,1,0), (-1,0,0)). Columns beyond the robot's 8
// dofs are zero.
template <typename T, int NV>
BRT_HD void robot_floor_rows(int r, const T cpos[3], T dist, int body, T mu1,
                             T mu2, T dA1, T dA2, const ContactP& prm,
                             const RobotKin<T>& k, const T* qvel, T (*J)[NV],
                             T* aref, T* D) {
  T Jn[NV], Jt1[NV], Jt2[NV];
  T rel[3];
  for (int a = 0; a < 3; ++a) rel[a] = cpos[a] - k.com[a];
  for (int j = 0; j < NV; ++j) {
    bool in_chain = j < 6 || (body == 1 && j == 6) || (body == 2 && j == 7);
    if (in_chain) {
      const T* ang = k.cdof[j];
      const T* lin = k.cdof[j] + 3;
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
  emit_rows<T, NV>(r, Jn, Jt1, Jt2, dist, mu1, mu2, dA1, dA2, prm, qvel, J,
                   aref, D);
}

// -J of the point `cpos` of robot body `body` (0 chassis, 1 left wheel, 2
// right wheel), taken about the robot's com and projected on n, t1, t2:
// what a contact with a body outside the robot's tree (the block, a wall)
// puts on the robot's 8 columns. Columns off the body's chain are zero.
template <typename T>
BRT_HD void robot_neg_jac(const T cpos[3], int body, const T n[3],
                          const T t1[3], const T t2[3], const RobotKin<T>& k,
                          T* Jn, T* Jt1, T* Jt2) {
  T rel[3];
  for (int a = 0; a < 3; ++a) rel[a] = cpos[a] - k.com[a];
  for (int j = 0; j < NV_ROBOT; ++j) {
    bool in_chain = j < 6 || (body == 1 && j == 6) || (body == 2 && j == 7);
    if (!in_chain) {
      Jn[j] = Jt1[j] = Jt2[j] = T(0.0);
      continue;
    }
    const T* ang = k.cdof[j];
    T v[3];
    cross(ang, rel, v);
    for (int a = 0; a < 3; ++a) v[a] = k.cdof[j][3 + a] + v[a];
    Jn[j] = -dot3(n, v);
    Jt1[j] = -dot3(t1, v);
    Jt2[j] = -dot3(t2, v);
  }
}

// ------------------------------------------------------- solver
// From the rows to the new velocity: warm start chosen by cost, Newton with
// an exact line search (fixed trip counts), constraint forces, and the
// implicitfast update qvel += h (M - h D)^-1 qfrc. M's wheel diagonal is
// overwritten. With MASKED, row r counts only where mask[r] is 1; without,
// every one of the nrow rows is a live contact row and rows that are
// inactive at the current iterate are skipped in the Hessian (they add
// exact zeros).
template <typename T, int NV, bool MASKED>
BRT_HD void solve_and_integrate(int nrow, const T (*J)[NV], const T* aref,
                                const T* D, const T* mask, T* jar, T* Jd,
                                T M[NV][NV], const T a_smooth[NV],
                                const T qfrc_smooth[NV], const T dfdv[2],
                                const Params& p, int newton_iters,
                                int ls_iters, T* qvel, T* ws) {
  // ---- warm start: the better of ws and a_smooth by cost
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
      for (int r = 0; r < nrow; ++r) {
        T s = J[r][0] * aa[0];
        for (int j = 1; j < NV; ++j) s = s + J[r][j] * aa[j];
        s = s - aref[r];
        T act = s < T(0.0) ? (MASKED ? mask[r] : T(1.0)) : T(0.0);
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
    for (int row = 0; row < nrow; ++row) {
      T s = J[row][0] * a[0];
      for (int j = 1; j < NV; ++j) s = s + J[row][j] * a[j];
      s = s - aref[row];
      jar[row] = s;
      T wgt = D[row] * (s < T(0.0) ? (MASKED ? mask[row] : T(1.0)) : T(0.0));
      if (MASKED || wgt != T(0.0)) {
        T wj = wgt * s;
        for (int r = 0; r < NV; ++r) {
          g[r] = g[r] + wj * J[row][r];
          T wr = wgt * J[row][r];
          for (int c2 = 0; c2 <= r; ++c2)
            H[r][c2] = H[r][c2] + wr * J[row][c2];
        }
      }
    }
    for (int r = 0; r < NV; ++r)
      for (int c2 = 0; c2 <= r; ++c2) {
        H[r][c2] = M[r][c2] + H[r][c2];
        H[c2][r] = H[r][c2];
      }
    T Lh[NV][NV], ng[NV], step[NV];
    chol_factor<T, NV>(H, Lh);
    for (int j = 0; j < NV; ++j) ng[j] = -g[j];
    chol_solve<T, NV>(Lh, ng, step);

    T dMd = T(0.0), dMda = T(0.0);
    for (int r = 0; r < NV; ++r) {
      T s = T(0.0);
      for (int j = 0; j < NV; ++j) s = s + M[r][j] * step[j];
      dMd = dMd + step[r] * s;
      dMda = dMda + s * da[r];
    }
#pragma unroll 1
    for (int row = 0; row < nrow; ++row) {
      T s = J[row][0] * step[0];
      for (int j = 1; j < NV; ++j) s = s + J[row][j] * step[j];
      Jd[row] = s;
    }
    T t = T(1.0);
    for (int ls = 0; ls < ls_iters; ++ls) {
      T s1 = T(0.0), s2 = T(0.0);
#pragma unroll 1
      for (int row = 0; row < nrow; ++row) {
        T jt = jar[row] + t * Jd[row];
        T act = jt < T(0.0) ? (MASKED ? mask[row] : T(1.0)) : T(0.0);
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
    for (int row = 0; row < nrow; ++row) {
      T s = J[row][0] * a[0];
      for (int j = 1; j < NV; ++j) s = s + J[row][j] * a[j];
      s = s - aref[row];
      T f = (MASKED ? mask[row] : T(1.0)) * D[row] * Max(-s, T(0.0));
      for (int j = 0; j < NV; ++j) qcon[j] = qcon[j] + f * J[row][j];
    }
    for (int j = 0; j < NV; ++j) qfrc[j] = qfrc[j] + qcon[j];
  }
  const T h = T(p.timestep);
  for (int i = 0; i < 2; ++i)
    M[6 + i][6 + i] = M[6 + i][6 + i] - h * (T(-p.damping) + dfdv[i]);
  T L[NV][NV], dv[NV];
  chol_factor<T, NV>(M, L);
  chol_solve<T, NV>(L, qfrc, dv);
  for (int j = 0; j < NV; ++j) {
    qvel[j] = qvel[j] + h * dv[j];
    ws[j] = a[j];
  }
}

// Position update of the robot's 9 qpos from its new qvel
template <typename T>
BRT_HD void integrate_robot(T qpos[9], const T* qvel, T h) {
  for (int i = 0; i < 3; ++i) qpos[i] = qpos[i] + h * qvel[i];
  quat_integrate(qpos + 3, qvel + 3, h);
  qpos[7] = qpos[7] + h * qvel[6];
  qpos[8] = qpos[8] + h * qvel[7];
}

constexpr int THREADS = 32;   // one warp per block: see each kernel's note

}  // namespace brt
