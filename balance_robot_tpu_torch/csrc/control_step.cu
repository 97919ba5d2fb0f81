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
// ptxas (-Xptxas -v, nvcc 12.8, sm_90a): float kernel 224 registers, 3632
// bytes stack frame, 0 bytes spilled; double kernel 255 registers, 7712
// bytes stack frame, 872 bytes spill stores, 3056 bytes spill loads. The
// stack frame is the per-thread row arrays. chip_smoke.py prints the counts
// of each build.
//
// The same templated code also runs on the host with `Counted`, a double
// that counts every arithmetic operation: k1_count_ops gives the operation
// count from which chip_smoke.py computes the kernel's bound.
//
// The device code K1 shares with K2 (control_step14.cu) is in
// robot_common.cuh: the algebra, the robot's smooth dynamics, the floor
// colliders, the row emitter and the solver, with NV and the row count as
// template or function parameters (here 8 dofs, 16 contacts, 64 rows).

#include "robot_common.cuh"

namespace k1 {

using namespace brt;

constexpr int NV = NV_ROBOT;
constexpr int NCON = 16;
constexpr int NROW = 4 * NCON;

// ------------------------------------------------------- one substep
template <typename T>
BRT_HD void substep(T qpos[9], T qvel[8], T ws[8], const T ctrl[2], T fric,
                    bool use_fric, const Params& p, int newton_iters,
                    int ls_iters) {
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
    robot_floor_rows<T, NV>(4 * c, cpos[c], cdist[c], body, mu1, mu2, dA1,
                            dA2, prm, k, qvel, J, aref, D);
    T inc = cinc[c] ? T(1.0) : T(0.0);
    for (int r = 4 * c; r < 4 * c + 4; ++r) mask[r] = inc;
  }

  T jar[NROW], Jd[NROW];
  solve_and_integrate<T, NV, true>(NROW, J, aref, D, mask, jar, Jd, M,
                                   a_smooth, qfrc_smooth, dfdv, p,
                                   newton_iters, ls_iters, qvel, ws);
  integrate_robot(qpos, qvel, T(p.timestep));
}

template <typename T>
BRT_HD void control_step_one(T q[9], T v[8], T w[8], const T c[2], T fric,
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
