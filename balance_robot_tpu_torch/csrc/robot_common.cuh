// Device code shared by the fused control-step kernels (K1: control_step.cu,
// 8-dof robot on a flat floor; K2: control_step14.cu, robot + block; K3:
// control_step_walls.cu, robot between static walls).
//
// Everything here is templated on the scalar type T (float, double, or the
// host-only `Counted`) and, where the size matters, on the number of dofs
// NV. The same code compiles as plain C++: a kernel's `*_count_ops` entry
// point runs it on the host with `Counted`, a double that counts every
// arithmetic operation, and with a team of one lane, where every
// warp-level call is compiled out.
//
// Contents: math wrappers, 3-vector / spatial algebra, an N x N Cholesky
// (unrolled, so that with compile-time indices it lives in registers), the
// robot's smooth dynamics (fk, com_vel, CRB, RNE, actuation), the floor
// colliders (plane-cylinder, plane-box), the solver impedance, the pyramid
// row emitter, and the solver (Newton with an exact line search, then the
// implicitfast velocity update): team_solve, for a team of G lanes of one
// warp per env, rows in TeamRows (shared memory) or, for one lane per env,
// LaneRows (the thread's local array), row loops split over the lanes with
// shuffle sums, the Newton Hessian and gradient split by entry, its
// factorization and solves by row (team_factor_solve), and M's and H's
// block structure used for K2's 14 dofs (K1, K2, K3). What bounds it is the
// serial chain that stays on every lane: each kernel's note gives its
// figures. The section counters say where that chain spends its time.

#pragma once

#include <cmath>
#include <type_traits>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define BRT_HD __host__ __device__ __forceinline__
#else
#define BRT_HD inline
#endif

// A checked build (-DBRT_CHECK_ROWS; the tests build one) holds every index
// into a row store to its range, and a team's lanes to the same bits of
// the rows they count and the state they leave; a breach traps the kernel
// (aborts on the host). Other builds compile the checks out.
#ifdef BRT_CHECK_ROWS
#ifdef __CUDA_ARCH__
#define BRT_REQUIRE(cond) do { if (!(cond)) __trap(); } while (0)
#else
#include <cstdlib>
#define BRT_REQUIRE(cond) do { if (!(cond)) std::abort(); } while (0)
#endif
#else
#define BRT_REQUIRE(cond) do { } while (0)
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
static long long g_coupled = 0;   // host only: 14 x 14 Newton factorizations

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

// ------------------------------------------------------- section counters
// Where an env's control step spends its time, by section of the chain
// that K1, K2 and K3 share. The edges lie in team_solve and in each
// kernel's substep; the time since the last edge goes to the section that
// an edge closes:
//   SMOOTH      the substep's start to a_smooth (robot_smooth, M's factor
//               and solve; K2 also the block's pose and bias);
//   CONTACTS    the colliders, the team's scan, the staging and the rows
//               written, up to team_solve;
//   HESSIAN     warm start's cost pass, then for each Newton step da / Mda,
//               the row pass (jar, w) and the Hessian and gradient, up to H
//               being written;
//   FACTOR      ng, the split or the coupled factorization and solve, Ms,
//               dMd, dMda;
//   LINESEARCH  the Jd pass, the ls_iters iterations, the update of a;
//   UPDATE      the constraint forces, the implicitfast update, qvel / ws,
//               the integration.
// An env's counters: the six sections, then ROWS (nrow summed over the
// substeps), COUPLED (the Newton steps that factorized K2's 14 x 14 H) and
// LAUNCHES. A kernel's timed instantiation counts SM cycles
// (SectionClock<SmCycles>) and adds them to the env's row of a device
// buffer; the host build counts operations (SectionClock<CountedOps>); the
// untimed instantiation takes NoClock, whose every call compiles out.
enum Section { SMOOTH, CONTACTS, HESSIAN, FACTOR, LINESEARCH, UPDATE,
               NSECTION };
constexpr int ROWS = NSECTION, COUPLED = NSECTION + 1,
              LAUNCHES = NSECTION + 2, NCOUNTER = NSECTION + 3;

struct NoClock {
  BRT_HD void mark(Section) {}
  BRT_HD void add_rows(int) {}
  BRT_HD void add_coupled() {}
  BRT_HD void add_to(long long*) const {}
};

// The low 32 bits of the SM's cycle counter: a section's sum over one
// launch stays below 2^32 cycles (2.2 s at 1980 MHz), in fewer registers
// than 64 bits take.
struct SmCycles {
  using Tick = unsigned;
  BRT_HD static Tick now() {
#ifdef __CUDA_ARCH__
    unsigned t;
    asm volatile("mov.u32 %0, %%clock;" : "=r"(t));
    return t;
#else
    return 0;
#endif
  }
};

// The operations counted so far (host builds).
struct CountedOps {
  using Tick = long long;
  BRT_HD static Tick now() {
#ifdef __CUDA_ARCH__
    return 0;
#else
    return g_ops;
#endif
  }
};

template <class Now>
struct SectionClock {
  using Tick = typename Now::Tick;
  Tick last, acc[NSECTION];
  int rows = 0, coupled = 0;
  BRT_HD SectionClock() : last(Now::now()) {
    for (int s = 0; s < NSECTION; ++s) acc[s] = 0;
  }
  BRT_HD void mark(Section s) {
    const Tick t = Now::now();
    acc[s] += t - last;
    last = t;
  }
  BRT_HD void add_rows(int n) { rows += n; }
  BRT_HD void add_coupled() { ++coupled; }
  // Add this launch's counts to `row` (NCOUNTER values).
  BRT_HD void add_to(long long* row) const {
    for (int s = 0; s < NSECTION; ++s) row[s] += (long long)acc[s];
    row[ROWS] += rows;
    row[COUPLED] += coupled;
    row[LAUNCHES] += 1;
  }
};

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
// read) and the two triangular solves. Fully unrolled, so that with
// compile-time indices A, L and the vectors live in registers (N <= 14).
// chol_factor_by reads A(i, j) when it needs it, so that a caller can
// leave A in shared memory and keep only L in registers.
template <typename T, int N, class F>
BRT_HD void chol_factor_by(const F& A, T L[N][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      T s = A(i, j);
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = (i == j) ? Sqrt(s) : s / L[j][j];
    }
  }
}

template <typename T, int N>
BRT_HD void chol_factor(const T A[N][N], T L[N][N]) {
  chol_factor_by<T, N>([&](int i, int j) { return A[i][j]; }, L);
}

template <typename T, int N>
BRT_HD void chol_solve(const T L[N][N], const T b[N], T x[N]) {
  T y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    T s = y[i];
#pragma unroll
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
// written at rows r .. r+3 of the row store `rows` (TeamRows, below: it
// has J(row, j), aref(row) and D(row)).
template <typename T, int NV, class R>
BRT_HD void emit_rows(const R& rows, int r, const T Jn[NV], const T Jt1[NV],
                      const T Jt2[NV], T dist, T mu1, T mu2, T dA1, T dA2,
                      const ContactP& prm, const T* qvel) {
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
        T Jj = Jn[j] + smu * Jt[j];
        rows.J(row, j) = Jj;
        vel = vel + Jj * qvel[j];
      }
      rows.aref(row) = T(-prm.b) * vel - stiff;
      rows.D(row) = Dv;
    }
  }
}

// Rows of one floor contact of robot body `body` (0 chassis, 1 left wheel,
// 2 right wheel) at `cpos`, in the constant floor frame
// (n, t1, t2) = ((0,0,1), (0,1,0), (-1,0,0)). Columns beyond the robot's 8
// dofs are zero.
template <typename T, int NV, class R>
BRT_HD void robot_floor_rows(const R& rows, int r, const T cpos[3], T dist,
                             int body, T mu1, T mu2, T dA1, T dA2,
                             const ContactP& prm, const RobotKin<T>& k,
                             const T* qvel) {
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
  emit_rows<T, NV>(rows, r, Jn, Jt1, Jt2, dist, mu1, mu2, dA1, dA2, prm,
                   qvel);
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

// ------------------------------------------------------- team solver
// A team of G lanes (G a power of two <= 32, inside one warp) works on one
// env. Sums over rows are taken by a butterfly of __shfl_xor_sync on the
// team's mask; a^b == b^a, so every lane ends with the same bits, and the
// parts that stay serial (fk, CRB, RNE, M's factor) run redundantly on
// every lane and agree bit for bit; the Newton factorization is shared
// out by row, each value shuffled from the lane that owns it. With G = 1
// (the host's `*_count_ops` builds, and K1's and K3's kernels for large
// batches) every team call is the identity.
// A team may take its row sums as a team of W lanes would (W a multiple of
// G): row r adds to the partial of virtual lane r mod W, each lane holds
// V = W / G of them, and `vsum` runs W's butterfly, its steps across a
// lane's own partials first. Teams of any G with one W then give the same
// bits (K2's instantiations). With W = G every call is as above: K1's
// and K3's SASS is what it was before W but for the operand order of one
// commutative add per kernel, with the same registers, stack and spills
// (cuobjdump and ptxas, nvcc 12.8, sm_90a).
template <int G_, int W_ = G_>
struct Team {
  static constexpr int G = G_;
  static constexpr int W = W_;
  static constexpr int V = W / G;   // partials per lane
  static_assert(W >= G && W % G == 0, "W is a multiple of the team");
  int lane;        // 0 .. G-1
  unsigned mask;   // the team's lanes in its warp
  // f(row, k) for each of this lane's rows below n (row = lane, lane + G,
  // ...), k its partial (row / G mod V)
  template <class F>
  BRT_HD void for_rows(int n, F&& f) const {
#pragma unroll 1
    for (int r0 = lane; r0 < n; r0 += W)
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (r0 + k * G < n) f(r0 + k * G, k);
  }
  // The sum over the virtual lanes of their partials p.
  template <typename T>
  BRT_HD T vsum(const T (&p)[V]) const {
    T q[V];
#pragma unroll
    for (int k = 0; k < V; ++k) q[k] = p[k];
#pragma unroll
    for (int o = V / 2; o > 0; o >>= 1) {
      T n[V];
#pragma unroll
      for (int k = 0; k < V; ++k) n[k] = q[k] + q[k ^ o];
#pragma unroll
      for (int k = 0; k < V; ++k) q[k] = n[k];
    }
    return sum(q[0]);
  }
  template <typename T>
  BRT_HD T sum(T v) const {
#ifdef __CUDA_ARCH__
    if constexpr (G > 1) {
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        v = v + __shfl_xor_sync(mask, v, o);
    }
#endif
    return v;
  }
  BRT_HD bool any(bool b) const {
#ifdef __CUDA_ARCH__
    return G > 1 ? __any_sync(mask, b) != 0 : b;
#else
    return b;
#endif
  }
  // v of the team's lane `src`, on every lane.
  template <typename T>
  BRT_HD T bcast(T v, int src) const {
#ifdef __CUDA_ARCH__
    if constexpr (G > 1) return __shfl_sync(mask, v, src, G);
#endif
    return v;
  }
  BRT_HD void sync() const {
#ifdef __CUDA_ARCH__
    if constexpr (G > 1) __syncwarp(mask);
#endif
  }
  // Whether every lane of the team holds the same v (checked builds).
  template <typename T>
  BRT_HD bool agree(T v) const {
#ifdef __CUDA_ARCH__
    if constexpr (G > 1)
      return __all_sync(mask, __shfl_sync(mask, v, 0, G) == v) != 0;
#endif
    return true;
  }
  // The sum of v over the team's lanes before this one (in lane order),
  // and in `total` the sum over all of them, the same on every lane.
  BRT_HD int excl_scan(int v, int& total) const {
#ifdef __CUDA_ARCH__
    if constexpr (G > 1) {
      int incl = v;
#pragma unroll
      for (int o = 1; o < G; o <<= 1) {
        const int up = __shfl_up_sync(mask, incl, o, G);
        if (lane >= o) incl += up;
      }
      total = __shfl_sync(mask, incl, G - 1, G);
      return incl - v;
    }
#endif
    total = v;
    return 0;
  }
};

// One env's rows and solver scratch for a team of lanes, column-major, in
// shared memory on the card (a plain array in the host builds, a team of
// one lane). The column stride is odd, so the lanes of a team walk
// consecutive rows of one column without bank conflicts, and the entry
// loop reads columns r and c of one row at distinct banks. Columns: J (NV), aref, D, jar (J a - aref), Jd (J step),
// w (active weight, then the constraint force), then the Hessian's lower
// triangle and the gradient as the lanes that own them leave them.
template <typename T, int NV, int MAXROW>
struct TeamRows {
  static constexpr bool ONE_PASS = false;   // see team_solve
  static constexpr int RS = MAXROW + 1;
  static constexpr int NE = NV * (NV + 1) / 2;
  static constexpr int JAR = NV + 2;
  static constexpr int SIZE = (NV + 5) * RS + NE + NV;   // values per env
  T* base;
  BRT_HD static int row(int r) {
    BRT_REQUIRE(r >= 0 && r < MAXROW);
    return r;
  }
  BRT_HD T& J(int r, int j) const {
    BRT_REQUIRE(j >= 0 && j < NV);
    return base[j * RS + row(r)];
  }
  BRT_HD T& aref(int r) const { return base[NV * RS + row(r)]; }
  BRT_HD T& D(int r) const { return base[(NV + 1) * RS + row(r)]; }
  BRT_HD T& jar(int r) const { return base[JAR * RS + row(r)]; }
  BRT_HD T& Jd(int r) const { return base[(NV + 3) * RS + row(r)]; }
  BRT_HD T& w(int r) const { return base[(NV + 4) * RS + row(r)]; }
  BRT_HD T& H(int e) const {
    BRT_REQUIRE(e >= 0 && e < NE + NV);
    return base[(NV + 5) * RS + e];
  }
  // Entry e of the Hessian-and-gradient sum sum_row (w A[row]) B[row], as
  // the column offsets of A and B: H[r][c] for e < NE (lower triangle, row
  // by row), g[e - NE] after.
  BRT_HD static void entry_cols(int e, int& oa, int& ob) {
    if (e < NE) {
      int r = 0;
      while ((r + 1) * (r + 2) / 2 <= e) ++r;
      oa = r * RS;
      ob = (e - r * (r + 1) / 2) * RS;
    } else {
      oa = JAR * RS;
      ob = (e - NE) * RS;
    }
  }
};

// One env's rows for a team of one lane, in the thread's own array: J
// row-major, so that a row's NV columns are adjacent (vector loads), then
// aref, D, jar and Jd. team_solve takes a single lane's weights and forces
// row by row and keeps its Hessian in registers, so there is no w and no H.
template <typename T, int NV, int MAXROW>
struct LaneRows {
  static constexpr bool ONE_PASS = true;    // see team_solve
  static constexpr int SIZE = (NV + 4) * MAXROW;   // values per env
  T* base;
  BRT_HD static int row(int r) {
    BRT_REQUIRE(r >= 0 && r < MAXROW);
    return r;
  }
  BRT_HD T& J(int r, int j) const {
    BRT_REQUIRE(j >= 0 && j < NV);
    return base[row(r) * NV + j];
  }
  BRT_HD T& aref(int r) const { return base[NV * MAXROW + row(r)]; }
  BRT_HD T& D(int r) const { return base[(NV + 1) * MAXROW + row(r)]; }
  BRT_HD T& jar(int r) const { return base[(NV + 2) * MAXROW + row(r)]; }
  BRT_HD T& Jd(int r) const { return base[(NV + 3) * MAXROW + row(r)]; }
};

// M x for the mass matrix of the team kernels: the robot's 8 x 8 block Mr
// (its lower triangle read, so the upper one need not stay in registers)
// and, for NV = 14, the block's diagonal m I3, I I3.
template <typename T, int NV>
BRT_HD void mass_mul(const T Mr[8][8], T mb, T Ib, const T x[NV], T out[NV]) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    T s = T(0.0);
#pragma unroll
    for (int j = 0; j < 8; ++j) s = s + (j <= r ? Mr[r][j] : Mr[j][r]) * x[j];
    out[r] = s;
  }
#pragma unroll
  for (int i = 8; i < NV; ++i) out[i] = (i < 11 ? mb : Ib) * x[i];
}

// (M' x = b) for M' = M with Mr's own factor L8: the robot's 8 dofs by the
// Cholesky solve, the block's 6 by a division each.
template <typename T, int NV>
BRT_HD void mass_solve(const T L8[8][8], T mb, T Ib, const T b[NV], T x[NV]) {
  chol_solve<T, 8>(L8, b, x);
#pragma unroll
  for (int i = 8; i < NV; ++i) x[i] = b[i] / (i < 11 ? mb : Ib);
}

// step = H^-1 ng for a Newton Hessian H, read as H(r, c) (lower triangle),
// that is block-diagonal past row 8 when NV = 14: an 8 x 8 and a 6 x 6
// factorization, unrolled in registers.
template <typename T, int NV, class F>
BRT_HD void factor_solve_split(const F& H, const T ng[NV], T step[NV]) {
  T Lr[8][8];
  chol_factor_by<T, 8>(H, Lr);
  chol_solve<T, 8>(Lr, ng, step);
  if constexpr (NV > 8) {
    constexpr int NB = NV - 8;
    T Lb[NB][NB];
    chol_factor_by<T, NB>([&](int r, int c) { return H(8 + r, 8 + c); }, Lb);
    chol_solve<T, NB>(Lb, ng + 8, step + 8);
  }
}

// c - a b rounded once: the fused multiply-add that the serial code's
// c - a * b compiles to on the card, written out so that the team's
// products, whose operands come through shuffles and selects, take it too
// (left to the compiler, some were not fused, and the bits moved).
template <typename T>
BRT_HD T fms(T a, T b, T c) {
#ifdef __CUDA_ARCH__
  return fma(-a, b, c);
#else
  return c - a * b;
#endif
}

// The same step = H^-1 ng on a team of G > 1 lanes, for team_solve's H on
// TeamRows (H(r, c) = Mr[r][c] or the block's mb, Ib, plus the H scratch's
// entry), shared out over the lanes: lane r mod G owns row r (its slot r /
// G), loads that row of H at once and keeps only it and, from its
// diagonal's turn on, the column of L under that diagonal. Column by column:
// the owner of the diagonal takes its square root, which a shuffle gives to
// the team, each lane divides its row's entry of the column by it and
// subtracts the column's products from the rest of its row; the forward
// solve's right-hand side rides along as one more entry of each row. Then
// the back solve, a row at a time, each x shuffled to every lane. Every
// entry takes chol_factor_by's and chol_solve's operations in their order
// (H(i, j) less L[i][k] L[j][k] for k = 0, 1, ..., then the root or the
// division), so the serial code's bits. When `split` (NV = 8, or no
// robot-block row active), rows 0-7 and rows 8.. are two matrices, as
// factor_solve_split takes them, and run side by side on their lanes: the
// coupled case's first 8 columns on other rows, one code path for both.
template <typename T, int NV, class Tm, class R>
BRT_HD void team_factor_solve(const Tm& tm, const R& rw, const T Mr[8][8],
                              T mb, T Ib, const T ng[NV], bool split,
                              T step[NV]) {
  constexpr int G = Tm::G;
  constexpr int S = (NV + G - 1) / G;   // rows per lane
  constexpr int NB = NV - 8;            // the block's rows (none for NV = 8)
  constexpr int NB1 = NB > 0 ? NB : 1;
  // the slot of the lane that owns row 8 + j, and the last row of slot k
  constexpr auto slot_b = [](int j) { return (8 + j) / G < S ? (8 + j) / G
                                                             : S - 1; };
  constexpr auto last = [](int k) { return k * G + G - 1 < NV ? k * G + G - 1
                                                              : NV - 1; };
  const int ncol = split ? 8 : NV;      // the columns of the longest block
  int lr[S];             // a slot's row in its block (-1: none)
  int nb[S];             // and the size of that block
  bool inb[S];           // the slot's row is in the block of rows 8.. (split)
  T s[S][NV];            // the row's entries left of its diagonal: H, then L
  T c[S][NV];            // from the diagonal's turn: L[j][lr], j > lr
  T dg[S], sy[S], diag[S], y[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int i = tm.lane + k * G;
    const int r = i < NV ? i : 0;       // a lane with no row reads row 0
    inb[k] = split && r >= 8;
    lr[k] = i >= NV ? -1 : inb[k] ? r - 8 : r;
    nb[k] = inb[k] ? NB : ncol;
    const int e = r * (r + 1) / 2;
#pragma unroll
    for (int j = 0; j < NV - 1; ++j) s[k][j] = rw.H(e + (inb[k] ? 8 : 0) + j);
    T md = r < 11 ? mb : Ib;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      T m = T(0.0);
#pragma unroll
      for (int a = j; a < 8; ++a)
        if (r == a) m = Mr[a][j];
      if (j < r && r < 8) s[k][j] = m + s[k][j];
      if (j == r) md = m;
    }
    T b = T(0.0);
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (r == j) b = ng[j];
    dg[k] = i < NV ? md + rw.H(e + r) : T(1.0);
    sy[k] = b;
    diag[k] = y[k] = T(1.0);
#pragma unroll
    for (int j = 0; j < NV; ++j) c[k][j] = T(0.0);
  }
  T X1[NV], X2[NB1];
#pragma unroll
  for (int j = 0; j < NV; ++j) X1[j] = T(0.0);
#pragma unroll
  for (int j = 0; j < NB1; ++j) X2[j] = T(0.0);

#pragma unroll
  for (int t = 0; t < NV; ++t) {
    if (t < ncol) {
      // row t's diagonal, and the block's row t when split, from its owner
      const T d1 = tm.bcast(Sqrt(dg[t / G]), t % G);
      T d2 = d1;
      if (t < NB) d2 = tm.bcast(Sqrt(dg[slot_b(t)]), (8 + t) % G);
      // L[lr][t], and on the owner y[t] (forward solve)
      T q[S];
#pragma unroll
      for (int k = 0; k < S; ++k) {
        if (t > last(k)) continue;   // the slot's rows are done
        const bool own = lr[k] == t;
        const T dk = inb[k] ? d2 : d1;
        q[k] = (own ? sy[k] : lr[k] > t ? s[k][t] : T(1.0)) / dk;
        if (own) {
          diag[k] = dk;
          y[k] = q[k];
        }
        s[k][t] = q[k];
      }
      // y[t] and the column under row t's diagonal, to every lane
      const T y1 = tm.bcast(q[t / G], t % G);
      T y2 = y1;
      if (t < NB) y2 = tm.bcast(q[slot_b(t)], (8 + t) % G);
      T v1[NV], v2[NB1];
#pragma unroll
      for (int j = t + 1; j < NV; ++j) v1[j] = tm.bcast(s[j / G][t], j % G);
#pragma unroll
      for (int j = t + 1; j < NB; ++j)
        v2[j] = tm.bcast(s[slot_b(j)][t], (8 + j) % G);
#pragma unroll
      for (int k = 0; k < S; ++k) {
        if (t > last(k)) continue;
        const T L = s[k][t];
        if (lr[k] > t) {
          sy[k] = fms(L, inb[k] ? y2 : y1, sy[k]);
          dg[k] = fms(L, L, dg[k]);
        }
        // entries right of the row's diagonal are never read: no test
#pragma unroll
        for (int j = t + 1; j < NV; ++j) {
          const T v = j < NB && inb[k] ? v2[j < NB ? j : 0] : v1[j];
          s[k][j] = fms(L, v, s[k][j]);
          if (lr[k] == t) c[k][j] = v;
        }
      }
    }
  }

  // back solve: x[u] = (y[u] - sum_{j > u} L[j][u] x[j]) / L[u][u], j
  // ascending, on the owner of row u
#pragma unroll
  for (int u = NV - 1; u >= 0; --u) {
    if (u < ncol) {
      T xq[S];
#pragma unroll
      for (int k = 0; k < S; ++k) {
        if (u > last(k)) continue;   // no row of the slot is row u
        T sx = y[k];
#pragma unroll
        for (int j = u + 1; j < NV; ++j)
          if (j < nb[k])
            sx = fms(c[k][j], j < NB && inb[k] ? X2[j < NB ? j : 0] : X1[j],
                     sx);
        const bool own = lr[k] == u;
        xq[k] = (own ? sx : T(1.0)) / (own ? diag[k] : T(1.0));
      }
      X1[u] = tm.bcast(xq[u / G], u % G);
      if (u < NB) X2[u < NB ? u : 0] = tm.bcast(xq[slot_b(u)], (8 + u) % G);
    }
  }
#pragma unroll
  for (int j = 0; j < NV; ++j)
    step[j] = j >= 8 && split ? X2[j >= 8 ? j - 8 : 0] : X1[j];
}

// From the rows to the new velocity, for a team on TeamRows: warm start
// chosen by cost, Newton with an exact line search (fixed trip counts),
// constraint forces, and the implicitfast update qvel += h (M - h D)^-1
// qfrc. Every one of the nrow rows is a live contact row; rows that are
// inactive at the current iterate add exact zeros. The row loops are split
// over the lanes (row = lane, lane + G, ...) and the Hessian and gradient
// by entry: each lane owns entries of the lower triangle of H and of g and
// walks every active row for them, so no partial Hessian has to be
// reduced. M is Mr (8 x 8) plus, for NV = 14,
// the block's diagonal (mb, Ib). Rows from `couple_row` on couple the robot
// and the block (K2's chassis-block and wheel-block contacts): while none
// of them is active, H is block-diagonal and is factorized as 8 x 8 and
// 6 x 6, which gives the bits of the 14 x 14 factorization (its
// off-block entries are exact zeros); a team of G > 1 lanes shares either
// out over its lanes (team_factor_solve), one lane runs the serial code.
// Mr's wheel diagonal is overwritten.
// On a row store that asks for it (R::ONE_PASS: LaneRows, which has J,
// aref, D, jar and Jd only and is held by a team of one lane), each row's
// Hessian and gradient entries and its constraint force are taken in the
// same pass as its J a - aref, from J in registers, and H stays in
// registers: the same operations in the same order as the by-entry code,
// so the same bits. On TeamRows every team, one lane included (the host
// builds of K1, K2 and K3's team instantiation), runs the by-entry code.
// `ck` takes the section edges from CONTACTS to LINESEARCH (see above).
template <typename T, int NV, int MAXROW, class Tm, class R, class Ck>
BRT_HD void team_solve(const Tm& tm, const R& rw, int nrow, int couple_row,
                       T Mr[8][8], T mb, T Ib, const T a_smooth[NV],
                       const T qfrc_smooth[NV], const T dfdv[2],
                       const Params& p, int newton_iters, int ls_iters,
                       T* qvel, T* ws, Ck& ck) {
  ck.mark(CONTACTS);
  ck.add_rows(nrow);
  constexpr int G = Tm::G;
  constexpr bool ONE_PASS = R::ONE_PASS;
  static_assert(!ONE_PASS || G == 1, "a one-pass row store has one lane");
  constexpr int NE = NV * (NV + 1) / 2;
  constexpr int KPL = (NE + NV + G - 1) / G;   // entries per lane
  const T* base = rw.base;
  BRT_REQUIRE(nrow >= 0 && nrow <= MAXROW && tm.agree(nrow));
  int oa[KPL], ob[KPL];
  if constexpr (!ONE_PASS) {
#pragma unroll
    for (int k = 0; k < KPL; ++k) {
      const int e = tm.lane + k * G;
      oa[k] = ob[k] = 0;
      if (e < NE + NV) rw.entry_cols(e, oa[k], ob[k]);
    }
  }

  // ---- warm start: the better of ws and a_smooth by cost
  T a[NV];
  {
    T cst[2];
    for (int pick = 0; pick < 2; ++pick) {
      const T* aa = pick ? a_smooth : ws;
      T da[NV], Mda[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) da[j] = aa[j] - a_smooth[j];
      mass_mul<T, NV>(Mr, mb, Ib, da, Mda);
      T c = T(0.0);
#pragma unroll
      for (int r = 0; r < NV; ++r) c = c + T(0.5) * da[r] * Mda[r];
      T q[Tm::V];
#pragma unroll
      for (int v = 0; v < Tm::V; ++v) q[v] = T(0.0);
      tm.for_rows(nrow, [&](int r, int v) {
        T s = rw.J(r, 0) * aa[0];
#pragma unroll
        for (int j = 1; j < NV; ++j) s = s + rw.J(r, j) * aa[j];
        s = s - rw.aref(r);
        T act = s < T(0.0) ? T(1.0) : T(0.0);
        q[v] = q[v] + rw.D(r) * act * s * s;
      });
      cst[pick] = c + T(0.5) * tm.vsum(q);
    }
    bool better = cst[0] < cst[1];
#pragma unroll
    for (int j = 0; j < NV; ++j) a[j] = better ? ws[j] : a_smooth[j];
  }

  // ---- Newton with exact line search, fixed trip counts
  for (int it = 0; it < newton_iters; ++it) {
    T da[NV], Mda[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) da[j] = a[j] - a_smooth[j];
    mass_mul<T, NV>(Mr, mb, Ib, da, Mda);
    bool coupled = false;
    T acc[KPL];
    if constexpr (ONE_PASS) {
      // entry e of acc is entry e of the lower triangle of H, then of g
#pragma unroll
      for (int k = 0; k < KPL; ++k) acc[k] = T(0.0);
#pragma unroll 1
      for (int row = 0; row < nrow; ++row) {
        T Jr[NV];
#pragma unroll
        for (int j = 0; j < NV; ++j) Jr[j] = rw.J(row, j);
        T s = Jr[0] * a[0];
#pragma unroll
        for (int j = 1; j < NV; ++j) s = s + Jr[j] * a[j];
        s = s - rw.aref(row);
        rw.jar(row) = s;
        const T wgt = rw.D(row) * (s < T(0.0) ? T(1.0) : T(0.0));
        coupled = coupled || (row >= couple_row && wgt != T(0.0));
        if (wgt != T(0.0)) {
#pragma unroll
          for (int r = 0; r < NV; ++r)
#pragma unroll
            for (int c = 0; c <= r; ++c)
              acc[r * (r + 1) / 2 + c] =
                  acc[r * (r + 1) / 2 + c] + (wgt * Jr[r]) * Jr[c];
#pragma unroll
          for (int j = 0; j < NV; ++j)
            acc[NE + j] = acc[NE + j] + (wgt * s) * Jr[j];
        }
      }
    } else {
#pragma unroll 1
      for (int row = tm.lane; row < nrow; row += G) {
        T s = rw.J(row, 0) * a[0];
#pragma unroll
        for (int j = 1; j < NV; ++j) s = s + rw.J(row, j) * a[j];
        s = s - rw.aref(row);
        rw.jar(row) = s;
        T wgt = rw.D(row) * (s < T(0.0) ? T(1.0) : T(0.0));
        rw.w(row) = wgt;
        coupled = coupled || (row >= couple_row && wgt != T(0.0));
      }
      coupled = tm.any(coupled);
      tm.sync();
#pragma unroll
      for (int k = 0; k < KPL; ++k) acc[k] = T(0.0);
#pragma unroll 1
      for (int row = 0; row < nrow; ++row) {
        const T wgt = rw.w(row);
        if (wgt != T(0.0)) {
#pragma unroll
          for (int k = 0; k < KPL; ++k)
            if (tm.lane + k * G < NE + NV)
              acc[k] = acc[k] + (wgt * base[oa[k] + row]) * base[ob[k] + row];
        }
      }
#pragma unroll
      for (int k = 0; k < KPL; ++k)
        if (tm.lane + k * G < NE + NV) rw.H(tm.lane + k * G) = acc[k];
      tm.sync();
    }
    ck.mark(HESSIAN);
    // H = M + the lanes' sums, read from shared memory entry by entry as
    // the factorization needs it (a one-pass store: from registers): only
    // the factor lives in registers
    const auto Hsum = [&](int e) {
      if constexpr (ONE_PASS) return acc[e];
      else return rw.H(e);
    };
    T ng[NV], step[NV];
#pragma unroll
    for (int r = 0; r < NV; ++r) ng[r] = -(Mda[r] + Hsum(NE + r));
    const auto H = [&](int r, int c) {
      const T h = Hsum(r * (r + 1) / 2 + c);
      if (r < 8) return Mr[r][c] + h;
      return r == c ? (r < 11 ? mb : Ib) + h : h;
    };
    if constexpr (G > 1) {
      // the team's lanes share the factorization and the solves
      (void)H;
      if (NV > 8 && coupled) ck.add_coupled();
      team_factor_solve<T, NV>(tm, rw, Mr, mb, Ib, ng, NV == 8 || !coupled,
                               step);
    } else if (NV == 8 || !coupled) {
      factor_solve_split<T, NV>(H, ng, step);
    } else {
#ifndef __CUDA_ARCH__
      g_coupled += 1;
#endif
      ck.add_coupled();
      T L[NV][NV];
      chol_factor_by<T, NV>(H, L);
      chol_solve<T, NV>(L, ng, step);
    }

    T Ms[NV], dMd = T(0.0), dMda = T(0.0);
    mass_mul<T, NV>(Mr, mb, Ib, step, Ms);
#pragma unroll
    for (int r = 0; r < NV; ++r) {
      dMd = dMd + step[r] * Ms[r];
      dMda = dMda + Ms[r] * da[r];
    }
    ck.mark(FACTOR);
#pragma unroll 1
    for (int row = tm.lane; row < nrow; row += G) {
      T s = rw.J(row, 0) * step[0];
#pragma unroll
      for (int j = 1; j < NV; ++j) s = s + rw.J(row, j) * step[j];
      rw.Jd(row) = s;
    }
    T t = T(1.0);
    for (int ls = 0; ls < ls_iters; ++ls) {
      T s1[Tm::V], s2[Tm::V];
#pragma unroll
      for (int v = 0; v < Tm::V; ++v) s1[v] = s2[v] = T(0.0);
      tm.for_rows(nrow, [&](int row, int v) {
        T jd = rw.Jd(row);
        T jt = rw.jar(row) + t * jd;
        T act = jt < T(0.0) ? T(1.0) : T(0.0);
        T aDJd = act * (rw.D(row) * jd);
        s1[v] = s1[v] + aDJd * jt;
        s2[v] = s2[v] + aDJd * jd;
      });
      T phi1 = dMda + t * dMd + tm.vsum(s1);
      T phi2 = dMd + tm.vsum(s2);
      t = t - phi1 / Max(phi2, T(MJ_MINVAL));
    }
    t = Max(t, T(0.0));
#pragma unroll
    for (int j = 0; j < NV; ++j) a[j] = a[j] + t * step[j];
    ck.mark(LINESEARCH);
  }

  // ---- constraint forces (by entry, as the gradient) and implicitfast
  // integration
  T qfrc[NV];
  if constexpr (ONE_PASS) {
    T qcon[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) qcon[j] = T(0.0);
#pragma unroll 1
    for (int row = 0; row < nrow; ++row) {
      T Jr[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) Jr[j] = rw.J(row, j);
      T s = Jr[0] * a[0];
#pragma unroll
      for (int j = 1; j < NV; ++j) s = s + Jr[j] * a[j];
      s = s - rw.aref(row);
      const T f = rw.D(row) * Max(-s, T(0.0));
#pragma unroll
      for (int j = 0; j < NV; ++j) qcon[j] = qcon[j] + f * Jr[j];
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) qfrc[j] = qfrc_smooth[j] + qcon[j];
  } else {
#pragma unroll 1
    for (int row = tm.lane; row < nrow; row += G) {
      T s = rw.J(row, 0) * a[0];
#pragma unroll
      for (int j = 1; j < NV; ++j) s = s + rw.J(row, j) * a[j];
      s = s - rw.aref(row);
      rw.w(row) = rw.D(row) * Max(-s, T(0.0));
    }
    tm.sync();
    for (int j = tm.lane; j < NV; j += G) {
      T q = T(0.0);
#pragma unroll 1
      for (int row = 0; row < nrow; ++row) q = q + rw.w(row) * rw.J(row, j);
      rw.H(j) = q;
    }
    tm.sync();
#pragma unroll
    for (int j = 0; j < NV; ++j) qfrc[j] = qfrc_smooth[j] + rw.H(j);
  }
  const T h = T(p.timestep);
  for (int i = 0; i < 2; ++i)
    Mr[6 + i][6 + i] = Mr[6 + i][6 + i] - h * (T(-p.damping) + dfdv[i]);
  T L8[8][8], dv[NV];
  chol_factor<T, 8>(Mr, L8);
  mass_solve<T, NV>(L8, mb, Ib, qfrc, dv);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    qvel[j] = qvel[j] + h * dv[j];
    ws[j] = a[j];
    BRT_REQUIRE(tm.agree(qvel[j]) && tm.agree(ws[j]));
  }
}

// Number of set bits: the slot of an included contact is the count of
// included candidates before it.
BRT_HD int popc(unsigned x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// The lanes of the team of G that holds warp lane `wl`.
BRT_HD unsigned team_mask(int G, int wl) {
  return G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (wl & ~(G - 1));
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

#ifdef __CUDACC__
// Dynamic shared memory above 48 KB needs the kernel's opt-in.
template <typename K>
int allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}
#endif

// ------------------------------------------------------- the launch seam
// What K1, K2 and K3 share around their step: the ladder of teams that the
// batch climbs, the launch of a rung's instantiation and its shape, the
// body of a kernel of one-warp blocks, and the host driver of the
// operation count. A kernel states its rungs, its row store, its state
// widths and its step; its note says why each rung starts where it does.

// One rung of a kernel's ladder: a team of G lanes per env from a batch of
// FROM envs on.
template <int G_, int FROM_>
struct Rung {
  static_assert(G_ >= 1 && G_ <= 32 && (G_ & (G_ - 1)) == 0,
                "a team is a power of two inside one warp");
  static constexpr int G = G_, FROM = FROM_;
};

// A kernel's rungs R, from the smallest batch up, on the row store
// Rows<T, G> of a team of G lanes (LaneRows, in the thread's own array,
// only for one lane).
template <template <typename, int> class Rows, class... R>
struct Ladder {
  // The lanes per env of a launch of B envs: the last rung that B reaches
  // (the first for any B).
  static int team_for(int B) {
    int g = 0;
    ((g = g == 0 || B >= R::FROM ? R::G : g), ...);
    return g;
  }

  // f(std::integral_constant<int, G>()) for the first rung whose team is
  // `team` lanes, or `none` if no rung's is.
  template <class F>
  static int with_team(int team, int none, const F& f) {
    int out = none;
    bool found = false;
    auto rung = [&](auto g) {
      if (!found && team == decltype(g)::value) {
        found = true;
        out = f(g);
      }
    };
    (rung(std::integral_constant<int, R::G>()), ...);
    return out;
  }

  // Dynamic shared memory per block of the rung of G lanes: none on
  // LaneRows, the THREADS / G teams' row stores otherwise.
  template <typename T, int G>
  static constexpr int smem_bytes() {
    using Rw = Rows<T, G>;
    return Rw::ONE_PASS ? 0 : THREADS / G * Rw::SIZE * (int)sizeof(T);
  }

  // The launch shape for B envs: lanes per env, envs per block and dynamic
  // shared memory per block for float (f64 = 0) or double (f64 = 1).
  static void launch_config(int f64, int B, int* team, int* envs,
                            int* smem) {
    *team = team_for(B);
    *envs = THREADS / *team;
    *smem = with_team(*team, 0, [&](auto g) {
      constexpr int G = decltype(g)::value;
      return f64 ? smem_bytes<double, G>() : smem_bytes<float, G>();
    });
  }

#ifdef __CUDACC__
  // Launch `kernel`, the instantiation for T and the rung of G lanes, for B
  // envs on `stream`, THREADS / G envs per one-warp block; returns the CUDA
  // error of the launch, 0 if none.
  template <typename T, int G, class... P, class... A>
  static int launch_team(void (*kernel)(P...), int B, void* stream,
                         const A&... args) {
    const int smem = smem_bytes<T, G>();
    int err = allow_smem(kernel, smem);
    if (err) return err;
    const int envs = THREADS / G;
    const int blocks = (B + envs - 1) / envs;
    kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(args...);
    return (int)cudaGetLastError();
  }

  // Launch kernel_of(std::integral_constant<int, G>()), the instantiation
  // of the rung whose team is `team` lanes (what launch_config gives for
  // B), with `args`; cudaErrorInvalidValue for a team that no rung has.
  template <typename T, class K, class... A>
  static int launch(int team, int B, void* stream, const K& kernel_of,
                    const A&... args) {
    return with_team(team, (int)cudaErrorInvalidValue, [&](auto g) {
      return launch_team<T, decltype(g)::value>(kernel_of(g), B, stream,
                                                args...);
    });
  }

  // The blocks of the rung of `team` lanes that one SM holds at once (the
  // occupancy of kernel_of(g) with the rung's shared memory), 0 for a team
  // that no rung has: a launch of more blocks than the SMs hold takes
  // more than one wave.
  template <typename T, class K>
  static int blocks_per_sm(int team, const K& kernel_of) {
    return with_team(team, 0, [&](auto g) {
      constexpr int G = decltype(g)::value;
      const int smem = smem_bytes<T, G>();
      int n = 0;
      if (allow_smem(kernel_of(g), smem) == 0)
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel_of(g),
                                                      THREADS, smem);
      return n;
    });
  }

  // Load the instantiation of every rung that each kernel_of gives, so
  // that no launch pays CUDA's lazy load of its kernel (a query loads it);
  // returns the first CUDA error, 0 if none.
  template <class... K>
  static int load(const K&... kernel_of) {
    int err = 0;
    auto query = [&](auto kernel) {
      cudaFuncAttributes attr;
      if (!err) err = (int)cudaFuncGetAttributes(&attr, kernel);
    };
    auto rungs = [&](const auto& of) {
      (query(of(std::integral_constant<int, R::G>())), ...);
    };
    (rungs(kernel_of), ...);
    return err;
  }
#endif
};

#ifdef __CUDACC__
// The body of a kernel of one-warp blocks, THREADS / G teams Tm of G lanes
// each and one env per team: env i's state in, step(tm, rw, q, v, w, c, i,
// ck), and lane 0's state out; lane 0 adds the section counters of the
// clock Ck to env i's row of `counters` (NCOUNTER values per env; a
// NoClock adds nothing and `counters` may be null). A team on LaneRows
// keeps its rows in its own local array, any other in its slice of the
// block's dynamic shared memory.
template <typename T, class Tm, class Rw, int NQ, int NV, class Ck,
          class Step>
__device__ __forceinline__ void step_envs(
    const T* qpos, const T* qvel, const T* ws, const T* ctrl, T* qpos_out,
    T* qvel_out, T* ws_out, int B, long long* counters, const Step& step) {
  constexpr int G = Tm::G;
  extern __shared__ __align__(16) unsigned char smem[];
  alignas(16) T own[Rw::ONE_PASS ? Rw::SIZE : 1];
  const int team = threadIdx.x / G;
  const int i = blockIdx.x * (THREADS / G) + team;
  if (i >= B) return;
  const Tm tm{(int)threadIdx.x % G, team_mask(G, threadIdx.x % 32)};
  const Rw rw{Rw::ONE_PASS ? own
                           : reinterpret_cast<T*>(smem) + team * Rw::SIZE};
  // the loads and stores written out here, not in a helper, keep the
  // kernels' machine code as it was (a helper reorders the PTX)
  T q[NQ], v[NV], w[NV], c[2];
  for (int k = 0; k < NQ; ++k) q[k] = qpos[NQ * i + k];
  for (int k = 0; k < NV; ++k) {
    v[k] = qvel[NV * i + k];
    w[k] = ws[NV * i + k];
  }
  c[0] = ctrl[2 * i];
  c[1] = ctrl[2 * i + 1];
  Ck ck;
  step(tm, rw, q, v, w, c, i, ck);
  if (tm.lane != 0) return;
  for (int k = 0; k < NQ; ++k) qpos_out[NQ * i + k] = q[k];
  for (int k = 0; k < NV; ++k) {
    qvel_out[NV * i + k] = v[k];
    ws_out[NV * i + k] = w[k];
  }
  ck.add_to(counters + NCOUNTER * i);
}
#endif

// One env's control step on the host in double, every arithmetic
// operation counted, as a team of one lane on the row store Rw: the state
// in, step(tm, rw, q, v, w, c, ck), the state out; returns the count. If
// `sections` is not null it receives the operations of each section, the
// rows and the coupled Newton steps (NCOUNTER - 1 values; see above).
template <int NQ, int NV, class Rw, class Step>
long long count_ops(const double* qpos, const double* qvel, const double* ws,
                    const double* ctrl, double* qpos_out, double* qvel_out,
                    double* ws_out, long long* sections, const Step& step) {
  using T = Counted;
  static T buf[Rw::SIZE];
  const Team<1> tm{0, 1u};
  const Rw rw{buf};
  T q[NQ], v[NV], w[NV], c[2];
  for (int k = 0; k < NQ; ++k) q[k] = T(qpos[k]);
  for (int k = 0; k < NV; ++k) {
    v[k] = T(qvel[k]);
    w[k] = T(ws[k]);
  }
  c[0] = T(ctrl[0]);
  c[1] = T(ctrl[1]);
  g_ops = 0;
  SectionClock<CountedOps> ck;
  step(tm, rw, q, v, w, c, ck);
  for (int k = 0; k < NQ; ++k) qpos_out[k] = q[k].v;
  for (int k = 0; k < NV; ++k) {
    qvel_out[k] = v[k].v;
    ws_out[k] = w[k].v;
  }
  if (sections) {
    long long row[NCOUNTER] = {};
    ck.add_to(row);
    for (int k = 0; k < LAUNCHES; ++k) sections[k] = row[k];
  }
  return g_ops;
}

}  // namespace brt
