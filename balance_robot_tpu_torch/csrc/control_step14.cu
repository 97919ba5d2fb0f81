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
// robot_common.cuh) -> block pose and gravity bias -> a_smooth from the
// block-diagonal 14x14 mass matrix (robot 8x8 by Cholesky, m I3 and I I3 by
// 6 divisions) -> contacts: 2x4 wheel-floor plane-cylinder, 8 chassis-floor
// and 8 block-floor plane-box corners (the block's with its 2 mm margin),
// chassis-block box-box and 2x3 wheel-block box-cylinder (box_collide.cuh)
// -> 4 pyramid rows per included contact over 14 columns, in the contact's
// own frame, with J = J(block) - J(robot body) for the two-body contacts ->
// warm start chosen by cost -> Newton (fixed newton_iters) with an exact
// line search (fixed ls_iters) -> constraint forces -> implicitfast velocity
// update on M - h*D (8x8 Cholesky and 6 divisions) -> integration of both
// free joints. No dynamic friction: the Env03 envs carry none.
//
// Design: a team of TEAM lanes of one warp per env (team_solve in
// robot_common.cuh), one warp per block (THREADS / TEAM envs), all
// substeps in one launch. Only qpos, qvel, warm start and ctrl cross device
// memory, once each; the ragged batch edge is masked per team; scene
// parameters and iteration counts are runtime arguments.
// - Rows in shared memory. Only included contacts are kept, in the order
//   robot-floor, block-floor, chassis-block, wheel-block; at most 8 + 4 + 4
//   + 8 + 6 = 30 contacts (plane-box keeps the deepest 4; box-box gives 8
//   face contacts or 1 edge contact), 120 rows, and every one of them fits:
//   J (14 columns), aref, D, J a - aref, J step and the active weight,
//   column-major with a stride of 121, plus the 119 Hessian and gradient
//   entries: 9,672 bytes per env in float, 19,344 in double; 38.7 KB per
//   block of 4 envs in float, 77.4 KB in double, where the launch opts in
//   to more than 48 KB of dynamic shared memory. Sizing for the worst case
//   keeps every contact without a second buffer in device memory; the cost
//   is shared memory per SM: 5 blocks, 20 envs, fit an SM in float.
// - Every lane computes the colliders (they are a small part of the
//   chain); each group's candidates are then dealt to the lanes, and an
//   included one writes its 4 rows at the slot that the count of included
//   candidates before it gives, so the row order is the serial one.
// - The solver's row loops run over the team's lanes with shuffle sums;
//   the lanes own the Hessian's 105 lower-triangle entries and the 14
//   gradient entries and walk the active rows for them.
// - M is block-diagonal, and so is the Newton H while no chassis-block or
//   wheel-block row (the rows from `couple_row` on) is active: then H is
//   factorized as 8x8 and 6x6, unrolled in registers, which gives the
//   bits of the 14x14 factorization (its off-block entries are exact
//   zeros). When one is active (the block touching the robot) every lane
//   factorizes the full 14x14 H, unrolled in registers.
//
// What bounds it on an H100: the latency of each team's serial chain, not
// operations or bytes. The fk/CRB/RNE, the colliders and the small
// factorizations are one long dependent chain of scalar float math on
// every lane (no matrix product for the tensor cores, and float32 physics
// rules out TF32); about 240 bytes per env per control step cross device
// memory. The work that stays serial on every lane (the coupled 14x14
// factorization and box-box's manifold when the block meets the robot)
// is paid once per env-chain, so more envs per SM matter as much as
// shorter row loops: 8 lanes give 4 envs per warp, and shared memory
// allows 5 warps, 20 envs, per SM. Registers (255 a thread, with spills)
// would allow 8 warps; capping them at 168 or 128 made the float kernel
// spill 4-6x as much and lost more than the extra warps won (PERF.md).
//
// ptxas (-Xptxas -v, nvcc 12.8, sm_90a): float kernel 255 registers, 2,208
// bytes stack frame (the collider candidates, indexed by lane), 532 bytes
// spill stores, 1,616 bytes spill loads; double kernel 255 registers, 5,344
// bytes stack frame, 3,676 / 9,600 bytes spilled (the one-thread-per-env
// design before: float 255 registers, 13,968 bytes stack with the row
// arrays).
//
// The same templated code also runs on the host with `Counted` and a team
// of one lane: k2_count_ops gives the operation count behind the kernel's
// bound, and lets the kernel's arithmetic be compared with the plain
// version without a GPU. chip_smoke.py prints ptxas's registers, stack and
// spills of each build and the launch shape.

#include "box_collide.cuh"
#include "robot_common.cuh"

namespace k2 {

using namespace brt;

constexpr int NV = 14;
constexpr int MAXCON = 30;
constexpr int MAXROW = 4 * MAXCON;
// The team size and the blocks per SM that registers are capped for
// (__launch_bounds__): 8 lanes and no cap (255 registers a thread) ran the
// Env03-v2 main path fastest of the variants timed together, 15% ahead of
// 16 lanes, which are 18% faster at the flagship serving's 1024 envs at
// the exact grade (PERF.md); a cap spills more than the extra warps win.
#ifndef BRT_K2_TEAM
#define BRT_K2_TEAM 8
#endif
#ifndef BRT_K2_MINB
#define BRT_K2_MINB 1
#endif
constexpr int TEAM = BRT_K2_TEAM;     // lanes per env
constexpr int ENVS = THREADS / TEAM;   // envs per block of one warp
static_assert(TEAM >= 1 && TEAM <= 32 && (TEAM & (TEAM - 1)) == 0,
              "the team is a power of two inside one warp");
template <typename T>
using Rows = TeamRows<T, NV, MAXROW>;

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
template <typename T, class R>
BRT_HD void block_rows(const R& rows, int r, const T cpos[3], T dist,
                       const T n[3], const T t1[3], const T t2[3],
                       int robot_body, const ContactP& prm, const Scene<T>& s,
                       const T* qvel) {
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
  emit_rows<T, NV>(rows, r, Jn, Jt1, Jt2, dist, T(prm.mu1), T(prm.mu2),
                   T(prm.dA1), T(prm.dA2), prm, qvel);
}

// bits below bit c
BRT_HD unsigned below(int c) { return (1u << c) - 1u; }

// ------------------------------------------------------- one substep
template <typename T, class Tm>
BRT_HD void substep(const Tm& tm, const Rows<T>& rw, T qpos[16], T qvel[14],
                    T ws[14], const T ctrl[2], const Params14& P,
                    int newton_iters, int ls_iters) {
  const Params& p = P.robot;
  Scene<T> s;
  RobotKin<T>& k = s.k;
  T Mr[8][8], qfrc_smooth[NV], dfdv[2];
  robot_smooth<T, 8>(qpos, qvel, ctrl, p, k, Mr, qfrc_smooth, dfdv);

  // ---- block: pose, bias (gravity only: the cube's inertia is isotropic,
  // so the gyroscopic term vanishes); its mass block is m I3, I I3, so M is
  // block-diagonal and a_smooth takes an 8 x 8 solve and 6 divisions
  for (int a = 0; a < 3; ++a) s.pos_b[a] = qpos[9 + a];
  quat_to_mat(qpos + 12, s.Rb);
  const T grav[3] = {T(p.gx), T(p.gy), T(p.gz)};
  for (int i = 0; i < 3; ++i) {
    qfrc_smooth[8 + i] = -(T(-P.block_mass) * grav[i]);
    qfrc_smooth[11 + i] = T(0.0);
  }
  const T mb = T(P.block_mass), Ib = T(P.block_inertia);
  T a_smooth[NV];
  {
    T L8[8][8];
    chol_factor<T, 8>(Mr, L8);
    mass_solve<T, NV>(L8, mb, Ib, qfrc_smooth, a_smooth);
  }

  // ---- contacts, computed by every lane: robot-floor (2 x 4 wheel, 8
  // chassis corners), block-floor (8 corners), chassis-block (box-box, up
  // to 8), wheel-block (2 x 3)
  const T margin = T(P.block_margin);
  const T axis[3] = {k.R[0][0], k.R[1][0], k.R[2][0]};
  const T bhalf[3] = {T(P.block_half), T(P.block_half), T(P.block_half)};
  T cc[3];
  for (int a = 0; a < 3; ++a) cc[a] = k.pos[a] + k.R[a][2] * T(CH_OFF);
  T fpos[16][3], fdist[16], bfpos[8][3], bfdist[8];
  bool finc[16], bfinc[8];
  plane_cylinder(k.xl, axis, fpos, fdist, finc);
  plane_cylinder(k.xr, axis, fpos + 4, fdist + 4, finc + 4);
  plane_box(cc, k.R, CH_HX, CH_HY, CH_HZ, T(0.0), fpos + 8, fdist + 8,
            finc + 8);
  plane_box(s.pos_b, s.Rb, P.block_half, P.block_half, P.block_half, margin,
            bfpos, bfdist, bfinc);
  const T chalf[3] = {T(CH_HX), T(CH_HY), T(CH_HZ)};
  T bpos[8][3], bdist[8], bn[3], bt1[3], bt2[3];
  const int nbox = box_box(cc, k.R, chalf, s.pos_b, s.Rb, bhalf, margin,
                           bpos, bdist, bn, bt1, bt2);
  T wpos[6][3], wdist[6], wn[6][3];
  bool winc[6];
  box_cylinder(s.pos_b, s.Rb, bhalf, k.xl, axis, T(WHEEL_R), T(WHEEL_H),
               margin, wpos, wdist, winc, wn);
  box_cylinder(s.pos_b, s.Rb, bhalf, k.xr, axis, T(WHEEL_R), T(WHEEL_H),
               margin, wpos + 3, wdist + 3, winc + 3, wn + 3);
  unsigned fmask = 0, bfmask = 0, wmask = 0;
  for (int c = 0; c < 16; ++c) fmask |= finc[c] ? 1u << c : 0u;
  for (int c = 0; c < 8; ++c) bfmask |= bfinc[c] ? 1u << c : 0u;
  for (int c = 0; c < 6; ++c) wmask |= winc[c] ? 1u << c : 0u;
  const int n_f = popc(fmask), n_bf = popc(bfmask);
  const int couple_row = 4 * (n_f + n_bf);     // first robot-block row
  const int nrow = couple_row + 4 * (nbox + popc(wmask));

  // ---- rows of the included contacts only, in the order robot-floor,
  // block-floor, chassis-block, wheel-block (the candidates' own order
  // within each); each group's candidates are dealt to the lanes in turn
  // and an included one goes to the slot its included predecessors leave
  tm.sync();   // every lane is done with the last substep's rows
  constexpr int G = Tm::G;
#pragma unroll 1
  for (int c = tm.lane; c < 16; c += G)
    if ((fmask >> c) & 1u) {
      const int body = c < 4 ? 1 : (c < 8 ? 2 : 0);
      const ContactP& prm = body ? p.wheel : p.chassis;
      robot_floor_rows<T, NV>(rw, 4 * popc(fmask & below(c)), fpos[c],
                              fdist[c], body, T(prm.mu1), T(prm.mu2),
                              T(prm.dA1), T(prm.dA2), prm, k, qvel);
    }
  {
    const T fn[3] = {T(0.0), T(0.0), T(1.0)};
    const T ft1[3] = {T(0.0), T(1.0), T(0.0)};
    const T ft2[3] = {T(-1.0), T(0.0), T(0.0)};
#pragma unroll 1
    for (int c = tm.lane; c < 8; c += G)
      if ((bfmask >> c) & 1u)
        block_rows(rw, 4 * (n_f + popc(bfmask & below(c))), bfpos[c],
                   bfdist[c] - margin, fn, ft1, ft2, -1, P.block_floor, s,
                   qvel);
  }
#pragma unroll 1
  for (int c = tm.lane; c < nbox; c += G)
    block_rows(rw, couple_row + 4 * c, bpos[c], bdist[c] - margin, bn, bt1,
               bt2, 0, P.block_chassis, s, qvel);
#pragma unroll 1
  for (int c = tm.lane; c < 6; c += G)
    if ((wmask >> c) & 1u) {
      T t1[3], t2[3];
      make_frame(wn[c], t1, t2);
      block_rows(rw, couple_row + 4 * (nbox + popc(wmask & below(c))),
                 wpos[c], wdist[c] - margin, wn[c], t1, t2, c < 3 ? 1 : 2,
                 P.block_wheel, s, qvel);
    }
  tm.sync();

  team_solve<T, NV, MAXROW>(tm, rw, nrow, couple_row, Mr, mb, Ib, a_smooth,
                            qfrc_smooth, dfdv, p, newton_iters, ls_iters,
                            qvel, ws);
  const T h = T(p.timestep);
  integrate_robot(qpos, qvel, h);
  for (int i = 0; i < 3; ++i) qpos[9 + i] = qpos[9 + i] + h * qvel[8 + i];
  quat_integrate(qpos + 12, qvel + 11, h);
}

template <typename T, class Tm>
BRT_HD void control_step_one(const Tm& tm, const Rows<T>& rw, T q[16],
                             T v[14], T w[14], const T c[2],
                             const Params14& p, int newton_iters,
                             int ls_iters, int frame_skip) {
  for (int s = 0; s < frame_skip; ++s)
    substep(tm, rw, q, v, w, c, p, newton_iters, ls_iters);
}

template <typename T>
constexpr int smem_bytes() {
  return ENVS * Rows<T>::SIZE * (int)sizeof(T);
}

#ifdef __CUDACC__
// One warp per block, ENVS teams of TEAM lanes, one env per team; each
// team's rows in its slice of the block's dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(THREADS, BRT_K2_MINB) control_step14_kernel(
    const T* __restrict__ qpos, const T* __restrict__ qvel,
    const T* __restrict__ ws, const T* __restrict__ ctrl,
    T* __restrict__ qpos_out, T* __restrict__ qvel_out,
    T* __restrict__ ws_out, int B, Params14 p, int newton_iters,
    int ls_iters, int frame_skip) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int team = threadIdx.x / TEAM;
  const int i = blockIdx.x * ENVS + team;
  if (i >= B) return;
  const Team<TEAM> tm{(int)threadIdx.x % TEAM,
                      team_mask(TEAM, threadIdx.x % 32)};
  const Rows<T> rw{reinterpret_cast<T*>(smem) + team * Rows<T>::SIZE};
  T q[16], v[14], w[14], c[2];
  for (int k = 0; k < 16; ++k) q[k] = qpos[16 * i + k];
  for (int k = 0; k < 14; ++k) {
    v[k] = qvel[14 * i + k];
    w[k] = ws[14 * i + k];
  }
  c[0] = ctrl[2 * i];
  c[1] = ctrl[2 * i + 1];
  control_step_one(tm, rw, q, v, w, c, p, newton_iters, ls_iters,
                   frame_skip);
  if (tm.lane != 0) return;
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
  const int smem = smem_bytes<T>();
  int err = allow_smem(control_step14_kernel<T>, smem);
  if (err) return err;
  const int blocks = (B + ENVS - 1) / ENVS;
  control_step14_kernel<T><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      qpos, qvel, ws, ctrl, qpos_out, qvel_out, ws_out, B, *p, newton_iters,
      ls_iters, frame_skip);
  return (int)cudaGetLastError();
}
#endif

}  // namespace k2

extern "C" {

#ifdef __CUDACC__
// Launch K2 on `stream` for B envs (row-major (B,16)/(B,14)/(B,14)/(B,2)
// inputs). Returns the CUDA error of the launch, 0 if none.
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

// The card's launch shape: lanes per env, envs per block and dynamic
// shared memory per block for float (f64 = 0) or double (f64 = 1).
void k2_launch_config(int f64, int* team, int* envs, int* smem) {
  *team = k2::TEAM;
  *envs = k2::ENVS;
  *smem = f64 ? k2::smem_bytes<double>() : k2::smem_bytes<float>();
}

// One env's control step on the host in double precision, as a team of one
// lane, with every arithmetic operation counted. Writes the new state and
// returns the count; *coupled_factorizations receives the Newton steps
// that factorized H as 14 x 14 because a robot-block row was active.
long long k2_count_ops(const double* qpos, const double* qvel,
                       const double* ws, const double* ctrl,
                       double* qpos_out, double* qvel_out, double* ws_out,
                       const k2::Params14* p, int newton_iters, int ls_iters,
                       int frame_skip, long long* coupled_factorizations) {
  using T = brt::Counted;
  static T buf[k2::Rows<T>::SIZE];
  const brt::Team<1> tm{0, 1u};
  const k2::Rows<T> rw{buf};
  T q[16], v[14], w[14], c[2];
  for (int k = 0; k < 16; ++k) q[k] = T(qpos[k]);
  for (int k = 0; k < 14; ++k) {
    v[k] = T(qvel[k]);
    w[k] = T(ws[k]);
  }
  c[0] = T(ctrl[0]);
  c[1] = T(ctrl[1]);
  brt::g_ops = 0;
  brt::g_coupled = 0;
  k2::control_step_one(tm, rw, q, v, w, c, *p, newton_iters, ls_iters,
                       frame_skip);
  for (int k = 0; k < 16; ++k) qpos_out[k] = q[k].v;
  for (int k = 0; k < 14; ++k) {
    qvel_out[k] = v[k].v;
    ws_out[k] = w[k].v;
  }
  *coupled_factorizations = brt::g_coupled;
  return brt::g_ops;
}

}  // extern "C"
