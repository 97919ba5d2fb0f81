// K2: one 5 ms control step of the 14-dof scene, the 8-dof balance robot
// plus the free 4 cm block that the Env03 envs fire at it.
//
// Replaces balance_robot_tpu/physics/pallas_block.py::_kernel14 (the Pallas
// TPU kernel launched by control_step14_pallas; its body is
// substep14_scalar). Its plain PyTorch version is
// balance_robot_tpu_torch/physics/block_step.py::control_step14, which does
// the same arithmetic one tensor op at a time with array-form colliders.
//
// Per substep (frame_skip of them, 250 for a control step, at constant
// ctrl): the robot half as in K1 (fk -> com_vel -> CRB -> RNE -> actuation,
// robot_common.cuh) -> block pose and gravity bias -> block-diagonal 14x14
// mass matrix (robot 8x8, m I3, I I3) and its Cholesky for a_smooth ->
// contacts: 2x4 wheel-floor plane-cylinder, 8 chassis-floor and 8
// block-floor plane-box corners (the block's with its 2 mm margin),
// chassis-block box-box and 2x3 wheel-block box-cylinder (box_collide.cuh)
// -> 4 pyramid rows per contact over 14 columns, in the contact's own
// frame, with J = J(block) - J(robot body) for the two-body contacts ->
// warm start chosen by cost -> Newton (fixed newton_iters) with an exact
// line search (fixed ls_iters) -> constraint forces -> implicitfast velocity
// update on M - h*D -> integration of both free joints. No dynamic
// friction: the Env03 envs carry none.
//
// Design: one thread per env and all substeps in one launch, as K1. Only
// qpos, qvel, warm start and ctrl cross device memory, once each. The
// ragged batch edge is masked in the kernel; scene parameters and iteration
// counts are runtime arguments, so a change of solver grade rebuilds
// nothing.
//
// Where the rows live. The TPU kernel emits all 55 candidate records (220
// rows of 14 columns) and masks the ones that are out. Here a thread keeps
// only the contacts that are included, written one after another: a masked
// row adds exact zeros to the cost, the gradient, the Hessian and the
// forces, so leaving it out changes no sum. At most 8 wheel-floor + 4
// chassis-floor + 4 block-floor (plane-box keeps the deepest 4) + 8
// chassis-block (8 face contacts or 1 edge contact) + 6 wheel-block = 30
// contacts can be included at once, so the arrays hold 120 rows: J, aref,
// D, jar and J*step are 2,160 values per thread, with M, the Hessian and
// their factors about 3,000, all in thread-local memory (L1-cached). A
// typical state (both wheels and the block on the floor) has 8-10 contacts,
// so the row loops are usually 3-4x shorter than the bound of 120, and a
// row that is inactive at the current Newton iterate is skipped in the
// Hessian. Box-box returns before its manifold when the boxes are apart,
// which is nearly always.
//
// What bounds it on an H100: operations, as K1. One serial chain of scalar
// float math per thread (14x14 Cholesky factorizations, Hessian assembly at
// 105 multiply-adds per active row, the line search) with no matrix product
// for the tensor cores; about 240 bytes per env per control step cross
// device memory. Blocks of 32 threads: B = 4096 is 128 blocks, one warp per
// SM, so the kernel is latency-bound on each thread's chain, and a warp
// waits for its env with the most contacts. Spreading an env's rows over
// the lanes of a warp is later work.
//
// The same templated code also runs on the host with `Counted`:
// k2_count_ops gives the operation count behind the kernel's bound, and
// lets the kernel's arithmetic be compared with the plain version without
// a GPU. chip_smoke.py prints ptxas's registers, stack and spills of each
// build.

#include "box_collide.cuh"
#include "robot_common.cuh"

namespace k2 {

using namespace brt;

constexpr int NV = 14;
constexpr int MAXCON = 30;
constexpr int MAXROW = 4 * MAXCON;

struct Params14 {
  Params robot;
  ContactP block_floor, block_chassis, block_wheel;
  double block_mass, block_inertia, block_half, block_margin;
};

// What the block's contact rows need of both bodies.
template <typename T>
struct Scene {
  RobotKin<T> k;
  T pos_b[3];
  T Rb[3][3];
};

// The 4 rows of one contact of the block at `cpos` with distance `dist`
// (margin already subtracted) in frame (n, t1, t2): +J on the block's 6
// dofs about its centre and, when robot_body >= 0, -J on that body's chain
// about the robot's com.
template <typename T>
BRT_HD void block_rows(int r, const T cpos[3], T dist, const T n[3],
                       const T t1[3], const T t2[3], int robot_body,
                       const ContactP& prm, const Scene<T>& s, const T* qvel,
                       T (*J)[NV], T* aref, T* D) {
  T Jn[NV], Jt1[NV], Jt2[NV];
  if (robot_body >= 0)
    robot_neg_jac(cpos, robot_body, n, t1, t2, s.k, Jn, Jt1, Jt2);
  else
    for (int j = 0; j < NV_ROBOT; ++j) Jn[j] = Jt1[j] = Jt2[j] = T(0.0);
  T rel[3];
  for (int a = 0; a < 3; ++a) rel[a] = cpos[a] - s.pos_b[a];
  for (int i = 0; i < 3; ++i) {
    Jn[8 + i] = n[i];
    Jt1[8 + i] = t1[i];
    Jt2[8 + i] = t2[i];
    T ang[3] = {s.Rb[0][i], s.Rb[1][i], s.Rb[2][i]}, v[3];
    cross(ang, rel, v);
    Jn[11 + i] = dot3(n, v);
    Jt1[11 + i] = dot3(t1, v);
    Jt2[11 + i] = dot3(t2, v);
  }
  emit_rows<T, NV>(r, Jn, Jt1, Jt2, dist, T(prm.mu1), T(prm.mu2),
                   T(prm.dA1), T(prm.dA2), prm, qvel, J, aref, D);
}

// ------------------------------------------------------- one substep
template <typename T>
BRT_HD void substep(T qpos[16], T qvel[14], T ws[14], const T ctrl[2],
                    const Params14& P, int newton_iters, int ls_iters) {
  const Params& p = P.robot;
  Scene<T> s;
  RobotKin<T>& k = s.k;
  T M[NV][NV], qfrc_smooth[NV], dfdv[2];
  for (int i = 0; i < NV; ++i)
    for (int j = 0; j < NV; ++j) M[i][j] = T(0.0);
  robot_smooth<T, NV>(qpos, qvel, ctrl, p, k, M, qfrc_smooth, dfdv);

  // ---- block: pose, bias (gravity only: the cube's inertia is isotropic,
  // so the gyroscopic term vanishes), diagonal mass block
  for (int a = 0; a < 3; ++a) s.pos_b[a] = qpos[9 + a];
  quat_to_mat(qpos + 12, s.Rb);
  const T grav[3] = {T(p.gx), T(p.gy), T(p.gz)};
  for (int i = 0; i < 3; ++i) {
    qfrc_smooth[8 + i] = -(T(-P.block_mass) * grav[i]);
    qfrc_smooth[11 + i] = T(0.0);
    M[8 + i][8 + i] = T(P.block_mass);
    M[11 + i][11 + i] = T(P.block_inertia);
  }
  T a_smooth[NV];
  {
    T L[NV][NV];
    chol_factor<T, NV>(M, L);
    chol_solve<T, NV>(L, qfrc_smooth, a_smooth);
  }

  // ---- contacts -> rows, included contacts only, in the order wheels,
  // chassis, block-floor, chassis-block, wheel-block
  T J[MAXROW][NV], aref[MAXROW], D[MAXROW];
  int nrow = 0;
  const T margin = T(P.block_margin);
  const T axis[3] = {k.R[0][0], k.R[1][0], k.R[2][0]};
  const T bhalf[3] = {T(P.block_half), T(P.block_half), T(P.block_half)};
  T cc[3];
  for (int a = 0; a < 3; ++a) cc[a] = k.pos[a] + k.R[a][2] * T(CH_OFF);
  {
    T cpos[8][3], cdist[8];
    bool cinc[8];
    plane_cylinder(k.xl, axis, cpos, cdist, cinc);
    plane_cylinder(k.xr, axis, cpos + 4, cdist + 4, cinc + 4);
    for (int c = 0; c < 8; ++c)
      if (cinc[c]) {
        robot_floor_rows<T, NV>(nrow, cpos[c], cdist[c], c < 4 ? 1 : 2,
                                T(p.wheel.mu1), T(p.wheel.mu2),
                                T(p.wheel.dA1), T(p.wheel.dA2), p.wheel, k,
                                qvel, J, aref, D);
        nrow += 4;
      }
    plane_box(cc, k.R, CH_HX, CH_HY, CH_HZ, T(0.0), cpos, cdist, cinc);
    for (int c = 0; c < 8; ++c)
      if (cinc[c]) {
        robot_floor_rows<T, NV>(nrow, cpos[c], cdist[c], 0, T(p.chassis.mu1),
                                T(p.chassis.mu2), T(p.chassis.dA1),
                                T(p.chassis.dA2), p.chassis, k, qvel, J,
                                aref, D);
        nrow += 4;
      }
    const T fn[3] = {T(0.0), T(0.0), T(1.0)};
    const T ft1[3] = {T(0.0), T(1.0), T(0.0)};
    const T ft2[3] = {T(-1.0), T(0.0), T(0.0)};
    plane_box(s.pos_b, s.Rb, P.block_half, P.block_half, P.block_half,
              margin, cpos, cdist, cinc);
    for (int c = 0; c < 8; ++c)
      if (cinc[c]) {
        block_rows(nrow, cpos[c], cdist[c] - margin, fn, ft1, ft2, -1,
                   P.block_floor, s, qvel, J, aref, D);
        nrow += 4;
      }
  }
  {
    const T chalf[3] = {T(CH_HX), T(CH_HY), T(CH_HZ)};
    T bpos[8][3], bdist[8], n[3], t1[3], t2[3];
    int nb = box_box(cc, k.R, chalf, s.pos_b, s.Rb, bhalf, margin, bpos,
                     bdist, n, t1, t2);
    for (int c = 0; c < nb; ++c) {
      block_rows(nrow, bpos[c], bdist[c] - margin, n, t1, t2, 0,
                 P.block_chassis, s, qvel, J, aref, D);
      nrow += 4;
    }
  }
  for (int wheel = 1; wheel <= 2; ++wheel) {
    T wpos[3][3], wdist[3], wn[3][3];
    bool winc[3];
    box_cylinder(s.pos_b, s.Rb, bhalf, wheel == 1 ? k.xl : k.xr, axis,
                 T(WHEEL_R), T(WHEEL_H), margin, wpos, wdist, winc, wn);
    for (int c = 0; c < 3; ++c)
      if (winc[c]) {
        T t1[3], t2[3];
        make_frame(wn[c], t1, t2);
        block_rows(nrow, wpos[c], wdist[c] - margin, wn[c], t1, t2, wheel,
                   P.block_wheel, s, qvel, J, aref, D);
        nrow += 4;
      }
  }

  T jar[MAXROW], Jd[MAXROW];
  solve_and_integrate<T, NV, false>(nrow, J, aref, D, nullptr, jar, Jd, M,
                                    a_smooth, qfrc_smooth, dfdv, p,
                                    newton_iters, ls_iters, qvel, ws);
  const T h = T(p.timestep);
  integrate_robot(qpos, qvel, h);
  for (int i = 0; i < 3; ++i) qpos[9 + i] = qpos[9 + i] + h * qvel[8 + i];
  quat_integrate(qpos + 12, qvel + 11, h);
}

template <typename T>
BRT_HD void control_step_one(T q[16], T v[14], T w[14], const T c[2],
                             const Params14& p, int newton_iters,
                             int ls_iters, int frame_skip) {
  for (int s = 0; s < frame_skip; ++s)
    substep(q, v, w, c, p, newton_iters, ls_iters);
}

#ifdef __CUDACC__
template <typename T>
__global__ void control_step14_kernel(
    const T* __restrict__ qpos, const T* __restrict__ qvel,
    const T* __restrict__ ws, const T* __restrict__ ctrl,
    T* __restrict__ qpos_out, T* __restrict__ qvel_out,
    T* __restrict__ ws_out, int B, Params14 p, int newton_iters,
    int ls_iters, int frame_skip) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  T q[16], v[14], w[14], c[2];
  for (int k = 0; k < 16; ++k) q[k] = qpos[16 * i + k];
  for (int k = 0; k < 14; ++k) {
    v[k] = qvel[14 * i + k];
    w[k] = ws[14 * i + k];
  }
  c[0] = ctrl[2 * i];
  c[1] = ctrl[2 * i + 1];
  control_step_one(q, v, w, c, p, newton_iters, ls_iters, frame_skip);
  for (int k = 0; k < 16; ++k) qpos_out[16 * i + k] = q[k];
  for (int k = 0; k < 14; ++k) {
    qvel_out[14 * i + k] = v[k];
    ws_out[14 * i + k] = w[k];
  }
}

template <typename T>
int launch(const T* qpos, const T* qvel, const T* ws, const T* ctrl,
           T* qpos_out, T* qvel_out, T* ws_out, int B, const Params14* p,
           int newton_iters, int ls_iters, int frame_skip, void* stream) {
  const int blocks = (B + THREADS - 1) / THREADS;
  control_step14_kernel<T><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      qpos, qvel, ws, ctrl, qpos_out, qvel_out, ws_out, B, *p, newton_iters,
      ls_iters, frame_skip);
  return (int)cudaGetLastError();
}
#endif

}  // namespace k2

extern "C" {

#ifdef __CUDACC__
// Launch K2 on `stream` for B envs (row-major (B,16)/(B,14)/(B,14)/(B,2)
// inputs). Returns cudaGetLastError() after the launch.
int k2_control_step_f32(const float* qpos, const float* qvel, const float* ws,
                        const float* ctrl, float* qpos_out, float* qvel_out,
                        float* ws_out, int B, const k2::Params14* p,
                        int newton_iters, int ls_iters, int frame_skip,
                        void* stream) {
  return k2::launch(qpos, qvel, ws, ctrl, qpos_out, qvel_out, ws_out, B, p,
                    newton_iters, ls_iters, frame_skip, stream);
}

int k2_control_step_f64(const double* qpos, const double* qvel,
                        const double* ws, const double* ctrl,
                        double* qpos_out, double* qvel_out, double* ws_out,
                        int B, const k2::Params14* p, int newton_iters,
                        int ls_iters, int frame_skip, void* stream) {
  return k2::launch(qpos, qvel, ws, ctrl, qpos_out, qvel_out, ws_out, B, p,
                    newton_iters, ls_iters, frame_skip, stream);
}
#endif

// One env's control step on the host in double precision, with every
// arithmetic operation counted. Writes the new state and returns the count.
long long k2_count_ops(const double* qpos, const double* qvel,
                       const double* ws, const double* ctrl,
                       double* qpos_out, double* qvel_out, double* ws_out,
                       const k2::Params14* p, int newton_iters, int ls_iters,
                       int frame_skip) {
  using T = brt::Counted;
  T q[16], v[14], w[14], c[2];
  for (int k = 0; k < 16; ++k) q[k] = T(qpos[k]);
  for (int k = 0; k < 14; ++k) {
    v[k] = T(qvel[k]);
    w[k] = T(ws[k]);
  }
  c[0] = T(ctrl[0]);
  c[1] = T(ctrl[1]);
  brt::g_ops = 0;
  k2::control_step_one(q, v, w, c, *p, newton_iters, ls_iters, frame_skip);
  for (int k = 0; k < 16; ++k) qpos_out[k] = q[k].v;
  for (int k = 0; k < 14; ++k) {
    qvel_out[k] = v[k].v;
    ws_out[k] = w[k].v;
  }
  return brt::g_ops;
}

}  // extern "C"
