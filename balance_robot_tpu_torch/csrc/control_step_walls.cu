// K3: one 5 ms control step of the 8-dof balance robot on a flat floor
// between static wall boxes (the corridor of EnvMove05).
//
// Replaces balance_robot_tpu/physics/pallas_move.py::_kernel_walls (the
// Pallas TPU kernel launched by control_step_walls_pallas; its body is
// substep_walls_scalar). Its plain PyTorch version is the wall scene of
// balance_robot_tpu_torch/physics/step.py::control_step, which does the
// same arithmetic one tensor op at a time with array-form colliders.
//
// Per substep (frame_skip of them, 250 for a control step, at constant
// ctrl): the robot's smooth dynamics as in K1 (fk -> com_vel -> CRB -> RNE
// -> actuation -> 8x8 Cholesky a_smooth, robot_common.cuh) -> contacts: 2x4
// wheel-floor plane-cylinder and 8 chassis-floor plane-box corners, then
// per wall one chassis-wall box-box (normal chassis -> wall) and two
// wheel-wall box-cylinder (box = wall, 3 candidates each, box_collide.cuh)
// -> 4 pyramid rows per contact over 8 columns; a wall is the world, so its
// rows carry -J(robot) in the contact's own frame, with the wall contact
// parameters at the chassis' or the wheel's invweight -> warm start chosen
// by cost -> Newton (fixed newton_iters) with an exact line search (fixed
// ls_iters) -> constraint forces -> implicitfast velocity update on
// M - h*D -> quaternion integration. No dynamic friction: the wall scene
// carries none.
//
// Design: one thread per env and all substeps in one launch, as K1 and K2.
// Only qpos, qvel, warm start and ctrl cross device memory, once each. The
// ragged batch edge is masked in the kernel; the scene (robot, contact
// parameters, up to MAX_WALLS axis-aligned walls) and the iteration counts
// are runtime arguments, so a change of solver grade rebuilds nothing.
//
// Where the rows live. The TPU kernel emits all 130 candidate records (520
// rows of 8 columns) and masks the ones that are out. Here a thread keeps
// only the contacts that are included, written one after another, as K2
// does: a masked row adds exact zeros to every sum. The arrays are sized
// for the worst case of the colliders' own caps, so that no contact can be
// dropped whatever the walls and the pose: 8 wheel-floor + 4 chassis-floor
// (plane-box keeps the deepest 4) + MAX_WALLS x (8 chassis-wall face
// contacts, or 1 edge contact, + 6 wheel-wall) = 68 contacts, 272 rows. J,
// aref, D, jar and J*step are 3,264 values per thread in thread-local
// memory (L1-cached), of which a robot clear of the walls touches the first
// 32 rows or so. Box-box returns before its manifold when the boxes are
// apart, which for a wall is nearly always: a substep away from the walls
// costs K1's work on fewer rows plus four 15-axis separation tests and
// eight 3-point box-cylinder tests.
//
// What bounds it on an H100: operations, as K1 and K2: one serial chain of
// scalar float math per thread with no matrix product for the tensor cores;
// about 208 bytes per env per control step cross device memory. Blocks of
// 32 threads: B = 4096 is 128 blocks, one warp per SM, so the kernel is
// latency-bound on each thread's chain, and a warp waits for its env with
// the most contacts.
//
// ptxas (-Xptxas -v, nvcc 12.8, sm_90a): float kernel 255 registers, 14,736
// bytes stack frame, 360 bytes spill stores, 1,276 bytes spill loads; double
// kernel 255 registers, 30,400 bytes stack frame, 2,140 bytes spill stores,
// 6,716 bytes spill loads. The stack frame is the per-thread row arrays.
// chip_smoke.py prints the counts of each build.
//
// The same templated code also runs on the host with `Counted`:
// k3_count_ops gives the operation count behind the kernel's bound, and
// lets the kernel's arithmetic be compared with the plain version without
// a GPU.

#include "box_collide.cuh"
#include "robot_common.cuh"

namespace k3 {

using namespace brt;

constexpr int NV = NV_ROBOT;
constexpr int MAX_WALLS = 4;
constexpr int MAXCON = 12 + 14 * MAX_WALLS;
constexpr int MAXROW = 4 * MAXCON;

struct ParamsWalls {
  Params robot;
  ContactP wall_chassis, wall_wheel;   // wall_contact at each body's invweight
  int n_walls;
  double walls[MAX_WALLS][6];          // centre xyz, half-extents xyz
};

// The 4 rows of one wall contact of robot body `body` at `cpos` with
// distance `dist` in frame (n, t1, t2): -J on that body's chain.
template <typename T>
BRT_HD void wall_rows(int r, const T cpos[3], T dist, const T n[3],
                      const T t1[3], const T t2[3], int body,
                      const ContactP& prm, const RobotKin<T>& k,
                      const T* qvel, T (*J)[NV], T* aref, T* D) {
  T Jn[NV], Jt1[NV], Jt2[NV];
  robot_neg_jac(cpos, body, n, t1, t2, k, Jn, Jt1, Jt2);
  emit_rows<T, NV>(r, Jn, Jt1, Jt2, dist, T(prm.mu1), T(prm.mu2),
                   T(prm.dA1), T(prm.dA2), prm, qvel, J, aref, D);
}

// ------------------------------------------------------- one substep
template <typename T>
BRT_HD void substep(T qpos[9], T qvel[8], T ws[8], const T ctrl[2],
                    const ParamsWalls& P, int newton_iters, int ls_iters) {
  const Params& p = P.robot;
  RobotKin<T> k;
  T M[NV][NV], qfrc_smooth[NV], dfdv[2];
  robot_smooth<T, NV>(qpos, qvel, ctrl, p, k, M, qfrc_smooth, dfdv);
  T a_smooth[NV];
  {
    T L[NV][NV];
    chol_factor<T, NV>(M, L);
    chol_solve<T, NV>(L, qfrc_smooth, a_smooth);
  }

  // ---- contacts -> rows, included contacts only, in the order wheels,
  // chassis, then per wall chassis, left wheel, right wheel
  T J[MAXROW][NV], aref[MAXROW], D[MAXROW];
  int nrow = 0;
  const T axis[3] = {k.R[0][0], k.R[1][0], k.R[2][0]};
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
  }
  const T chalf[3] = {T(CH_HX), T(CH_HY), T(CH_HZ)};
  const T eye[3][3] = {{T(1.0), T(0.0), T(0.0)},
                       {T(0.0), T(1.0), T(0.0)},
                       {T(0.0), T(0.0), T(1.0)}};
  const T no_margin = T(0.0);
#pragma unroll 1
  for (int w = 0; w < P.n_walls; ++w) {
    const T cw[3] = {T(P.walls[w][0]), T(P.walls[w][1]), T(P.walls[w][2])};
    const T hw[3] = {T(P.walls[w][3]), T(P.walls[w][4]), T(P.walls[w][5])};
    {
      T bpos[8][3], bdist[8], n[3], t1[3], t2[3];
      int nb = box_box(cc, k.R, chalf, cw, eye, hw, no_margin, bpos, bdist,
                       n, t1, t2);
      for (int c = 0; c < nb; ++c) {
        wall_rows(nrow, bpos[c], bdist[c], n, t1, t2, 0, P.wall_chassis, k,
                  qvel, J, aref, D);
        nrow += 4;
      }
    }
#pragma unroll 1
    for (int wheel = 1; wheel <= 2; ++wheel) {
      T wpos[3][3], wdist[3], wn[3][3];
      bool winc[3];
      box_cylinder(cw, eye, hw, wheel == 1 ? k.xl : k.xr, axis, T(WHEEL_R),
                   T(WHEEL_H), no_margin, wpos, wdist, winc, wn);
      for (int c = 0; c < 3; ++c)
        if (winc[c]) {
          T t1[3], t2[3];
          make_frame(wn[c], t1, t2);
          wall_rows(nrow, wpos[c], wdist[c], wn[c], t1, t2, wheel,
                    P.wall_wheel, k, qvel, J, aref, D);
          nrow += 4;
        }
    }
  }

  T jar[MAXROW], Jd[MAXROW];
  solve_and_integrate<T, NV>(nrow, J, aref, D, jar, Jd, M, a_smooth,
                             qfrc_smooth, dfdv, p, newton_iters, ls_iters,
                             qvel, ws);
  integrate_robot(qpos, qvel, T(p.timestep));
}

template <typename T>
BRT_HD void control_step_one(T q[9], T v[8], T w[8], const T c[2],
                             const ParamsWalls& p, int newton_iters,
                             int ls_iters, int frame_skip) {
  for (int s = 0; s < frame_skip; ++s)
    substep(q, v, w, c, p, newton_iters, ls_iters);
}

#ifdef __CUDACC__
template <typename T>
__global__ void control_step_walls_kernel(
    const T* __restrict__ qpos, const T* __restrict__ qvel,
    const T* __restrict__ ws, const T* __restrict__ ctrl,
    T* __restrict__ qpos_out, T* __restrict__ qvel_out,
    T* __restrict__ ws_out, int B, ParamsWalls p, int newton_iters,
    int ls_iters, int frame_skip) {
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
  control_step_one(q, v, w, c, p, newton_iters, ls_iters, frame_skip);
  for (int k = 0; k < 9; ++k) qpos_out[9 * i + k] = q[k];
  for (int k = 0; k < 8; ++k) {
    qvel_out[8 * i + k] = v[k];
    ws_out[8 * i + k] = w[k];
  }
}

template <typename T>
int launch(const T* qpos, const T* qvel, const T* ws, const T* ctrl,
           T* qpos_out, T* qvel_out, T* ws_out, int B, const ParamsWalls* p,
           int newton_iters, int ls_iters, int frame_skip, void* stream) {
  const int blocks = (B + THREADS - 1) / THREADS;
  control_step_walls_kernel<T><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      qpos, qvel, ws, ctrl, qpos_out, qvel_out, ws_out, B, *p, newton_iters,
      ls_iters, frame_skip);
  return (int)cudaGetLastError();
}
#endif

}  // namespace k3

extern "C" {

#ifdef __CUDACC__
// Launch K3 on `stream` for B envs (row-major (B,9)/(B,8)/(B,8)/(B,2)
// inputs). Returns cudaGetLastError() after the launch.
int k3_control_step_f32(const float* qpos, const float* qvel, const float* ws,
                        const float* ctrl, float* qpos_out, float* qvel_out,
                        float* ws_out, int B, const k3::ParamsWalls* p,
                        int newton_iters, int ls_iters, int frame_skip,
                        void* stream) {
  return k3::launch(qpos, qvel, ws, ctrl, qpos_out, qvel_out, ws_out, B, p,
                    newton_iters, ls_iters, frame_skip, stream);
}

int k3_control_step_f64(const double* qpos, const double* qvel,
                        const double* ws, const double* ctrl,
                        double* qpos_out, double* qvel_out, double* ws_out,
                        int B, const k3::ParamsWalls* p, int newton_iters,
                        int ls_iters, int frame_skip, void* stream) {
  return k3::launch(qpos, qvel, ws, ctrl, qpos_out, qvel_out, ws_out, B, p,
                    newton_iters, ls_iters, frame_skip, stream);
}
#endif

// The most walls a ParamsWalls holds.
int k3_max_walls() { return k3::MAX_WALLS; }

// One env's control step on the host in double precision, with every
// arithmetic operation counted. Writes the new state and returns the count.
long long k3_count_ops(const double* qpos, const double* qvel,
                       const double* ws, const double* ctrl,
                       double* qpos_out, double* qvel_out, double* ws_out,
                       const k3::ParamsWalls* p, int newton_iters,
                       int ls_iters, int frame_skip) {
  using T = brt::Counted;
  T q[9], v[8], w[8], c[2];
  for (int k = 0; k < 9; ++k) q[k] = T(qpos[k]);
  for (int k = 0; k < 8; ++k) {
    v[k] = T(qvel[k]);
    w[k] = T(ws[k]);
  }
  c[0] = T(ctrl[0]);
  c[1] = T(ctrl[1]);
  brt::g_ops = 0;
  k3::control_step_one(q, v, w, c, *p, newton_iters, ls_iters, frame_skip);
  for (int k = 0; k < 9; ++k) qpos_out[k] = q[k].v;
  for (int k = 0; k < 8; ++k) {
    qvel_out[k] = v[k].v;
    ws_out[k] = w[k].v;
  }
  return brt::g_ops;
}

}  // extern "C"
