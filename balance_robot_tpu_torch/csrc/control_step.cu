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
// plane-cylinder + 8 chassis plane-box floor candidates -> 4 pyramid rows
// per included contact (at most 16 contacts, 64 rows), with an optional
// per-env wheel friction -> warm start chosen by cost -> Newton (fixed
// newton_iters) with an exact line search (fixed ls_iters) -> constraint
// forces -> implicitfast velocity update on M - h*D -> quaternion
// integration.
//
// Design: a team of TEAM lanes of one warp per env, as K2 (team_solve in
// robot_common.cuh), one warp per block (THREADS / TEAM envs), all
// substeps in one launch. Only qpos, qvel, warm start, ctrl and friction
// cross device memory, once each. Trip counts are fixed, the ragged batch
// edge is masked per team (no padding), and the scene parameters and
// iteration counts are runtime arguments, so a change of solver grade
// rebuilds nothing.
// - Included rows only. The TPU kernel (and this one up to its first
//   redesign) builds all 64 rows and masks the ones that are out; a masked
//   row adds exact zeros to the cost, the gradient, the Hessian and the
//   forces, so leaving it out changes no result. A robot standing on its
//   wheels has 2-8 contacts, 8-32 rows.
// - Rows in shared memory: J (8 columns), aref, D, J a - aref, J step and
//   the active weight, column-major with a stride of 65, plus the 36
//   Hessian and 8 gradient entries: 3,556 bytes per env in float, 7,112 in
//   double, for the worst case of 64 rows.
// - Every lane computes the fk/CRB/RNE, the 16 candidates and the 8x8
//   factorizations; candidate c is emitted by lane c mod TEAM at the slot
//   its included predecessors leave; the row loops run over the lanes with
//   shuffle sums, and the lanes own the Hessian's 36 lower-triangle and the
//   gradient's 8 entries.
//
// What bounds it on an H100: the latency of each team's serial chain (the
// robot dynamics and the small factorizations stay serial on every lane);
// the operations are about 1% of the card's fp32 peak in that time and the
// bytes moved ~100 per env per control step. So the launch shape trades
// the chain's length against the warps in flight: a team of 32 lanes
// shortens the row loops most, and capping registers at 128 (16 blocks of
// one warp per SM) lets 16 envs share an SM at the price of some spills.
// Of the shapes timed together (PERF.md), 8 lanes won at 4096 envs
// and lost at 256; 32 lanes with the cap were within ~15% of the best at
// both.
//
// ptxas (-Xptxas -v, nvcc 12.8, sm_90a): float kernel 128 registers, 640
// bytes stack frame, 448 bytes spill stores, 1,576 bytes spill loads;
// double kernel 128 registers, 2,000 bytes stack frame, 2,304 / 6,556
// bytes spilled. The row arrays are in shared memory, no longer in the
// stack frame (the one-thread-per-env design before: float 224
// registers, 3,632 bytes stack).
//
// The same templated code also runs on the host with `Counted`, a double
// that counts every arithmetic operation, and a team of one lane:
// k1_count_ops gives the operation count from which chip_smoke.py computes
// the kernel's bound. chip_smoke.py prints ptxas's registers, stack and
// spills of each build and the launch shape.
//
// The device code K1 shares with K2 (control_step14.cu) and K3
// (control_step_walls.cu) is in robot_common.cuh: the algebra, the robot's
// smooth dynamics, the floor colliders, the row emitter and both solvers.

#include "robot_common.cuh"

namespace k1 {

using namespace brt;

constexpr int NV = NV_ROBOT;
constexpr int NCON = 16;
constexpr int MAXROW = 4 * NCON;
// The team size and the blocks per SM that registers are capped for
// (__launch_bounds__): 32 lanes and 16 blocks (128 registers a thread, with
// spills) are the best of the variants timed together over the main
// path's 4096 envs and Env01 serving's 256 (PERF.md).
#ifndef BRT_K1_TEAM
#define BRT_K1_TEAM 32
#endif
#ifndef BRT_K1_MINB
#define BRT_K1_MINB 16
#endif
constexpr int TEAM = BRT_K1_TEAM;     // lanes per env
constexpr int ENVS = THREADS / TEAM;   // envs per block of one warp
static_assert(TEAM >= 1 && TEAM <= 32 && (TEAM & (TEAM - 1)) == 0,
              "the team is a power of two inside one warp");
template <typename T>
using Rows = TeamRows<T, NV, MAXROW>;

// ------------------------------------------------------- one substep
template <typename T, class Tm>
BRT_HD void substep(const Tm& tm, const Rows<T>& rw, T qpos[9], T qvel[8],
                    T ws[8], const T ctrl[2], T fric, bool use_fric,
                    const Params& p, int newton_iters, int ls_iters) {
  RobotKin<T> k;
  T M[NV][NV], qfrc_smooth[NV], dfdv[2];
  robot_smooth<T, NV>(qpos, qvel, ctrl, p, k, M, qfrc_smooth, dfdv);
  T L[NV][NV], a_smooth[NV];
  chol_factor<T, NV>(M, L);
  chol_solve<T, NV>(L, qfrc_smooth, a_smooth);

  // ---- floor contacts: left wheel 0-3, right wheel 4-7, chassis 8-15
  T cpos[NCON][3], cdist[NCON];
  bool cinc[NCON];
  {
    T axis[3] = {k.R[0][0], k.R[1][0], k.R[2][0]};
    plane_cylinder(k.xl, axis, cpos, cdist, cinc);
    plane_cylinder(k.xr, axis, cpos + 4, cdist + 4, cinc + 4);
    T cc[3];
    for (int a = 0; a < 3; ++a) cc[a] = k.pos[a] + k.R[a][2] * T(CH_OFF);
    plane_box(cc, k.R, CH_HX, CH_HY, CH_HZ, T(0.0), cpos + 8, cdist + 8,
              cinc + 8);
  }
  unsigned inc = 0;
  for (int c = 0; c < NCON; ++c) inc |= cinc[c] ? 1u << c : 0u;

  // ---- pyramid rows of the included contacts only, in candidate order,
  // per contact (mu1,+), (mu1,-), (mu2,+), (mu2,-): candidate c goes to
  // lane c mod G, at the slot its included predecessors leave
  tm.sync();   // every lane is done with the last substep's rows
#pragma unroll 1
  for (int c = tm.lane; c < NCON; c += Tm::G) {
    if (!((inc >> c) & 1u)) continue;
    const int body = c < 4 ? 1 : (c < 8 ? 2 : 0);
    const ContactP& prm = body ? p.wheel : p.chassis;
    T mu1 = T(prm.mu1), mu2 = T(prm.mu2), dA1 = T(prm.dA1), dA2 = T(prm.dA2);
    if (use_fric && body) {
      mu1 = Max(fric, T(MJ_MINMU));
      mu2 = mu1;
      dA1 = T(2.0) * mu1 * mu1 * (T(1.0) + mu1 * mu1) * T(prm.invweight);
      dA2 = dA1;
    }
    robot_floor_rows<T, NV>(rw, 4 * popc(inc & ((1u << c) - 1u)), cpos[c],
                            cdist[c], body, mu1, mu2, dA1, dA2, prm, k, qvel);
  }
  tm.sync();

  const int nrow = 4 * popc(inc);
  team_solve<T, NV, MAXROW>(tm, rw, nrow, nrow, M, T(0.0), T(0.0), a_smooth,
                            qfrc_smooth, dfdv, p, newton_iters, ls_iters,
                            qvel, ws);
  integrate_robot(qpos, qvel, T(p.timestep));
}

template <typename T, class Tm>
BRT_HD void control_step_one(const Tm& tm, const Rows<T>& rw, T q[9],
                             T v[8], T w[8], const T c[2], T fric,
                             bool use_fric, const Params& p, int newton_iters,
                             int ls_iters, int frame_skip) {
  for (int s = 0; s < frame_skip; ++s)
    substep(tm, rw, q, v, w, c, fric, use_fric, p, newton_iters, ls_iters);
}

template <typename T>
constexpr int smem_bytes() {
  return ENVS * Rows<T>::SIZE * (int)sizeof(T);
}

#ifdef __CUDACC__
// One warp per block, ENVS teams of TEAM lanes, one env per team; each
// team's rows in its slice of the block's dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(THREADS, BRT_K1_MINB) control_step_kernel(
    const T* __restrict__ qpos, const T* __restrict__ qvel,
    const T* __restrict__ ws, const T* __restrict__ ctrl,
    const T* __restrict__ fric, T* __restrict__ qpos_out,
    T* __restrict__ qvel_out, T* __restrict__ ws_out, int B, Params p,
    int newton_iters, int ls_iters, int frame_skip, int use_fric) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int team = threadIdx.x / TEAM;
  const int i = blockIdx.x * ENVS + team;
  if (i >= B) return;
  const Team<TEAM> tm{(int)threadIdx.x % TEAM,
                      team_mask(TEAM, threadIdx.x % 32)};
  const Rows<T> rw{reinterpret_cast<T*>(smem) + team * Rows<T>::SIZE};
  T q[9], v[8], w[8], c[2];
  for (int k = 0; k < 9; ++k) q[k] = qpos[9 * i + k];
  for (int k = 0; k < 8; ++k) {
    v[k] = qvel[8 * i + k];
    w[k] = ws[8 * i + k];
  }
  c[0] = ctrl[2 * i];
  c[1] = ctrl[2 * i + 1];
  T f = use_fric ? fric[i] : T(0.0);
  control_step_one(tm, rw, q, v, w, c, f, use_fric != 0, p, newton_iters,
                   ls_iters, frame_skip);
  if (tm.lane != 0) return;
  for (int k = 0; k < 9; ++k) qpos_out[9 * i + k] = q[k];
  for (int k = 0; k < 8; ++k) {
    qvel_out[8 * i + k] = v[k];
    ws_out[8 * i + k] = w[k];
  }
}

template <typename T>
int launch(const T* qpos, const T* qvel, const T* ws, const T* ctrl,
           const T* fric, T* qpos_out, T* qvel_out, T* ws_out, int B,
           const Params* p, int newton_iters, int ls_iters, int frame_skip,
           int use_fric, void* stream) {
  const int smem = smem_bytes<T>();
  int err = allow_smem(control_step_kernel<T>, smem);
  if (err) return err;
  const int blocks = (B + ENVS - 1) / ENVS;
  control_step_kernel<T><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      qpos, qvel, ws, ctrl, fric, qpos_out, qvel_out, ws_out, B, *p,
      newton_iters, ls_iters, frame_skip, use_fric);
  return (int)cudaGetLastError();
}
#endif

}  // namespace k1

extern "C" {

#ifdef __CUDACC__
// Launch K1 on `stream` for B envs (row-major (B,9)/(B,8)/(B,8)/(B,2)
// inputs, fric (B,) or null). Returns the CUDA error of the launch, 0 if
// none.
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

// The card's launch shape: lanes per env, envs per block and dynamic
// shared memory per block for float (f64 = 0) or double (f64 = 1).
void k1_launch_config(int f64, int* team, int* envs, int* smem) {
  *team = k1::TEAM;
  *envs = k1::ENVS;
  *smem = f64 ? k1::smem_bytes<double>() : k1::smem_bytes<float>();
}

// One env's control step on the host in double precision, as a team of one
// lane, with every arithmetic operation counted. Writes the new state and
// returns the count.
long long k1_count_ops(const double* qpos, const double* qvel,
                       const double* ws, const double* ctrl, double fric,
                       double* qpos_out, double* qvel_out, double* ws_out,
                       const k1::Params* p, int newton_iters, int ls_iters,
                       int frame_skip, int use_fric) {
  using T = brt::Counted;
  static T buf[k1::Rows<T>::SIZE];
  const brt::Team<1> tm{0, 1u};
  const k1::Rows<T> rw{buf};
  T q[9], v[8], w[8], c[2];
  for (int k = 0; k < 9; ++k) q[k] = T(qpos[k]);
  for (int k = 0; k < 8; ++k) {
    v[k] = T(qvel[k]);
    w[k] = T(ws[k]);
  }
  c[0] = T(ctrl[0]);
  c[1] = T(ctrl[1]);
  brt::g_ops = 0;
  k1::control_step_one(tm, rw, q, v, w, c, T(fric), use_fric != 0, *p,
                       newton_iters, ls_iters, frame_skip);
  for (int k = 0; k < 9; ++k) qpos_out[k] = q[k].v;
  for (int k = 0; k < 8; ++k) {
    qvel_out[k] = v[k].v;
    ws_out[k] = w[k].v;
  }
  return brt::g_ops;
}

}  // extern "C"
