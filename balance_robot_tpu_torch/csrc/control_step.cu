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
// Design: the team solver of K2 and K3 (team_solve in robot_common.cuh),
// one warp per block, all substeps in one launch. Only qpos, qvel, warm
// start, ctrl and friction cross device memory, once each. Trip counts are
// fixed, the ragged batch edge is masked per team (no padding), and the
// scene parameters and iteration counts are runtime arguments, so a change
// of solver grade rebuilds nothing.
// - Included rows only. The TPU kernel (and this one up to its first
//   redesign) builds all 64 rows and masks the ones that are out; a masked
//   row adds exact zeros to the cost, the gradient, the Hessian and the
//   forces, so leaving it out changes no result. A robot standing on its
//   wheels has 2-8 contacts, 8-32 rows.
// - Every lane computes the fk/CRB/RNE, the 16 candidates and M's 8x8
//   factorization; candidate c is emitted by lane c mod G at the slot its
//   included predecessors leave. The team shares the Newton H's 8x8
//   factorization and solves out, a row per lane (team_factor_solve in
//   robot_common.cuh), with the serial code's bits.
//
// Two instantiations of the one source, chosen by batch size in the
// wrapper (cuda_step.py), which reads the choice from k1_launch_config:
// - below CROSSOVER envs (serving at 256, PPO at the CLI's 1,024, the
//   sharded and off-policy runs), a team of TEAM = 32 lanes per env, one
//   env per one-warp block, its rows in dynamic shared memory (TeamRows: J
//   (8 columns), aref, D, J a - aref, J step and the active weight,
//   column-major with a stride of 65, plus the 36 Hessian and 8 gradient
//   entries; 3,556 bytes per env in float, 7,112 in double, for the worst
//   case of 64 rows); the row loops run over the lanes with shuffle sums,
//   and the lanes own the Hessian's and the gradient's 44 entries.
//   Registers are capped at 128 (16 one-warp blocks per SM, with spills):
//   one wave holds 16 x 132 = 2,112 envs;
// - from CROSSOVER envs on (the 4096-env collections), one lane per env,
//   its rows in the thread's own local array (LaneRows: J row-major,
//   3,072 bytes in float), as K3's one-lane instantiation; every shuffle
//   and warp sync compiles out, and team_solve takes each row's Hessian,
//   gradient and force in one pass from J in registers. A team there runs
//   the serial chain once per lane, and its second wave doubles its time.
// An env's float32 bits depend on the side of the crossover its batch
// falls on (the two instantiations sum the rows in another order).
//
// The crossover is the first batch past one wave of the 32-lane team
// (2,112 envs), where one lane wins at both solver grades. Timed in turns
// on an H100 80GB HBM3 at 700 W (tools/time_kernels.py; PERF.md), ms at
// B = 256 / 512 / 1024 / 1536 / 2048 / 2112 / 2176 / 3072 / 4096 on the
// Env01-v2 main path's states, float32:
//   fast grade:  32 lanes 9.20 / 9.78 / 12.14 / 14.13 / 16.49 / 16.60 /
//                24.59 / 29.60 / 32.16; one lane 14.17 / 14.21 / 14.30 /
//                14.28 / 14.36 / 14.36 / 14.30 / 14.32 / 14.24;
//   exact grade: 32 lanes 18.71 / 18.88 / 22.22 / 25.21 / 28.21 / 28.36 /
//                44.57 / 52.06 / 55.16; one lane 31.24 / 31.44 / 31.51 /
//                31.53 / 31.56 / 31.58 / 31.51 / 31.48 / 31.62.
// One lane takes about the same time at any batch up to one warp per SM
// (4,224 envs), the team one more wave from 2,113 envs on. At the fast
// grade one lane already wins at 2,048 (14.36 against 16.49; at 1,536 the
// team's 14.13 against 14.28), at the exact grade only from 2,176 (at
// 2,112 31.58 against 28.36). Teams of 4 and 2 lanes on TeamRows (still
// capped for 16 blocks per SM, which their shared rows cannot fill) took
// 84.7 and 207.7 ms at 4096, fast.
//
// What bounds it on an H100: the latency of each env's serial chain (the
// robot dynamics and M's factorization stay serial on every lane);
// the operations are 1-2.5% of the card's fp32 peak in that time and the
// bytes moved ~100 per env per control step.
//
// ptxas (-Xptxas -v, nvcc 12.8, sm_90a): team of 32, float: 128
// registers, 624 bytes stack frame, 404 bytes spill stores, 1,356 bytes
// spill loads (640, 448 / 1,576 before the team shared the Newton
// factorization); double: 128 registers, 2,080 bytes stack frame, 2,392 /
// 6,108 bytes spilled (2,000, 2,304 / 6,556). One lane, float: 211 registers, 3,360 bytes stack
// frame (3,072 of it the rows), no spills; double: 255 registers, 7,184
// bytes stack frame, 856 / 3,232 bytes spilled.
//
// Each rung also has a timed instantiation (TIMED; robot_common.cuh's
// section counters), which only a launch under torch.profiler takes: the
// same arithmetic and bits, 15 clock reads per fast substep; float: team
// 128 registers, 640 bytes stack, 412 / 1,368 spilled; one lane 214
// registers, no spills. Where its chain spends its time: PERF.md.
//
// The same templated code also runs on the host with `Counted`, a double
// that counts every arithmetic operation, and a team of one lane:
// k1_count_ops (on LaneRows, the one-pass solver) gives the operation
// count from which chip_smoke.py computes the kernel's bound, and with
// k1_count_ops_team_rows (on TeamRows, the by-entry solver that the team's
// lanes run; the same bits and count) lets both instantiations' arithmetic
// be compared with the plain version without a GPU. chip_smoke.py prints
// ptxas's registers, stack and spills of each build and each
// instantiation's launch shape.
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
// The small-batch team, the blocks per SM that its registers are capped
// for (__launch_bounds__) and the batch from which one lane per env runs
// instead (see above); only tools/time_kernels.py overrides them (a
// crossover of 0 for always one lane, a large one for never).
#ifndef BRT_K1_TEAM
#define BRT_K1_TEAM 32
#endif
#ifndef BRT_K1_MINB
#define BRT_K1_MINB 16
#endif
#ifndef BRT_K1_CROSSOVER
#define BRT_K1_CROSSOVER 2113
#endif
constexpr int TEAM = BRT_K1_TEAM;
constexpr int CROSSOVER = BRT_K1_CROSSOVER;
// The row store of a team of G lanes: TeamRows for several lanes (shared
// memory), LaneRows for one (its own array, J row-major).
template <typename T, int G>
using Rows = std::conditional_t<G == 1, LaneRows<T, NV, MAXROW>,
                                TeamRows<T, NV, MAXROW>>;
// The rungs: the team of TEAM lanes, one lane per env from CROSSOVER on.
using Teams = Ladder<Rows, Rung<TEAM, 1>, Rung<1, CROSSOVER>>;

// ------------------------------------------------------- one substep
// `ck` takes the section edges (robot_common.cuh): SMOOTH and UPDATE here,
// the others in team_solve.
template <typename T, class Tm, class R, class Ck>
BRT_HD void substep(const Tm& tm, const R& rw, T qpos[9], T qvel[8],
                    T ws[8], const T ctrl[2], T fric, bool use_fric,
                    const Params& p, int newton_iters, int ls_iters,
                    Ck& ck) {
  RobotKin<T> k;
  T M[NV][NV], qfrc_smooth[NV], dfdv[2];
  robot_smooth<T, NV>(qpos, qvel, ctrl, p, k, M, qfrc_smooth, dfdv);
  T L[NV][NV], a_smooth[NV];
  chol_factor<T, NV>(M, L);
  chol_solve<T, NV>(L, qfrc_smooth, a_smooth);
  ck.mark(SMOOTH);

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
                            qvel, ws, ck);
  integrate_robot(qpos, qvel, T(p.timestep));
  ck.mark(UPDATE);
}

template <typename T, class Tm, class R, class Ck>
BRT_HD void control_step_one(const Tm& tm, const R& rw, T q[9],
                             T v[8], T w[8], const T c[2], T fric,
                             bool use_fric, const Params& p, int newton_iters,
                             int ls_iters, int frame_skip, Ck& ck) {
  for (int s = 0; s < frame_skip; ++s)
    substep(tm, rw, q, v, w, c, fric, use_fric, p, newton_iters, ls_iters,
            ck);
}

// One env's control step on the host (brt::count_ops) on the row store of
// the team of G lanes; `sections`, if not null, receives its counters.
template <int G>
long long count_ops(const double* qpos, const double* qvel, const double* ws,
                    const double* ctrl, double fric, double* qpos_out,
                    double* qvel_out, double* ws_out, const Params* p,
                    int newton_iters, int ls_iters, int frame_skip,
                    int use_fric, long long* sections) {
  return brt::count_ops<9, 8, Rows<Counted, G>>(
      qpos, qvel, ws, ctrl, qpos_out, qvel_out, ws_out, sections,
      [&](const auto& tm, const auto& rw, Counted* q, Counted* v, Counted* w,
          const Counted* c, auto& ck) {
        control_step_one(tm, rw, q, v, w, c, Counted(fric), use_fric != 0,
                         *p, newton_iters, ls_iters, frame_skip, ck);
      });
}

#ifdef __CUDACC__
// One warp per block, THREADS / G teams of G lanes, one env per team
// (brt::step_envs); a team of several lanes has its registers capped for
// BRT_K1_MINB blocks per SM. The TIMED instantiation counts the sections
// of each env's chain into `counters` (robot_common.cuh); the other leaves
// them alone.
template <typename T, int G, bool TIMED>
__global__ void __launch_bounds__(THREADS, G == 1 ? 1 : BRT_K1_MINB)
    control_step_kernel(
        const T* __restrict__ qpos, const T* __restrict__ qvel,
        const T* __restrict__ ws, const T* __restrict__ ctrl,
        const T* __restrict__ fric, T* __restrict__ qpos_out,
        T* __restrict__ qvel_out, T* __restrict__ ws_out, int B, Params p,
        int newton_iters, int ls_iters, int frame_skip, int use_fric,
        long long* __restrict__ counters) {
  using Ck = std::conditional_t<TIMED, SectionClock<SmCycles>, NoClock>;
  step_envs<T, Team<G>, Rows<T, G>, 9, 8, Ck>(
      qpos, qvel, ws, ctrl, qpos_out, qvel_out, ws_out, B, counters,
      [&](const Team<G>& tm, const Rows<T, G>& rw, T* q, T* v, T* w,
          const T* c, int i, Ck& ck) {
        T f = use_fric ? fric[i] : T(0.0);
        control_step_one(tm, rw, q, v, w, c, f, use_fric != 0, p,
                         newton_iters, ls_iters, frame_skip, ck);
      });
}

// The kernel's instantiation for T, the rung of a team of g lanes and
// TIMED.
template <typename T, bool TIMED>
constexpr auto kernel_of = [](auto g) {
  return control_step_kernel<T, decltype(g)::value, TIMED>;
};

// Launch the instantiation for T, TIMED and the rung of `team` lanes.
template <typename T, bool TIMED>
int launch(const T* qpos, const T* qvel, const T* ws, const T* ctrl,
           const T* fric, T* qpos_out, T* qvel_out, T* ws_out, int B,
           const Params* p, int newton_iters, int ls_iters, int frame_skip,
           int use_fric, long long* counters, int team, void* stream) {
  return Teams::launch<T>(team, B, stream, kernel_of<T, TIMED>, qpos, qvel,
                          ws, ctrl, fric, qpos_out, qvel_out, ws_out, B, *p,
                          newton_iters, ls_iters, frame_skip, use_fric,
                          counters);
}
#endif

}  // namespace k1

extern "C" {

#ifdef __CUDACC__
// Launch K1 on `stream` for B envs (row-major (B,9)/(B,8)/(B,8)/(B,2)
// inputs, fric (B,) or null) with `team` lanes per env, as
// k1_launch_config gives it for B. Returns the CUDA error of the launch, 0
// if none.
int k1_control_step_f32(const float* qpos, const float* qvel, const float* ws,
                        const float* ctrl, const float* fric, float* qpos_out,
                        float* qvel_out, float* ws_out, int B,
                        const k1::Params* p, int newton_iters, int ls_iters,
                        int frame_skip, int use_fric, int team,
                        void* stream) {
  return k1::launch<float, false>(qpos, qvel, ws, ctrl, fric, qpos_out,
                                  qvel_out, ws_out, B, p, newton_iters,
                                  ls_iters, frame_skip, use_fric, nullptr,
                                  team, stream);
}

int k1_control_step_f64(const double* qpos, const double* qvel,
                        const double* ws, const double* ctrl,
                        const double* fric, double* qpos_out,
                        double* qvel_out, double* ws_out, int B,
                        const k1::Params* p, int newton_iters, int ls_iters,
                        int frame_skip, int use_fric, int team,
                        void* stream) {
  return k1::launch<double, false>(qpos, qvel, ws, ctrl, fric, qpos_out,
                                   qvel_out, ws_out, B, p, newton_iters,
                                   ls_iters, frame_skip, use_fric, nullptr,
                                   team, stream);
}

// The same with the timed instantiation, which adds each env's section
// counters to its row of `counters` ((B, NCOUNTER) int64).
int k1_control_step_timed_f32(const float* qpos, const float* qvel,
                              const float* ws, const float* ctrl,
                              const float* fric, float* qpos_out,
                              float* qvel_out, float* ws_out, int B,
                              const k1::Params* p, int newton_iters,
                              int ls_iters, int frame_skip, int use_fric,
                              long long* counters, int team, void* stream) {
  return k1::launch<float, true>(qpos, qvel, ws, ctrl, fric, qpos_out,
                                 qvel_out, ws_out, B, p, newton_iters,
                                 ls_iters, frame_skip, use_fric, counters,
                                 team, stream);
}

int k1_control_step_timed_f64(const double* qpos, const double* qvel,
                              const double* ws, const double* ctrl,
                              const double* fric, double* qpos_out,
                              double* qvel_out, double* ws_out, int B,
                              const k1::Params* p, int newton_iters,
                              int ls_iters, int frame_skip, int use_fric,
                              long long* counters, int team, void* stream) {
  return k1::launch<double, true>(qpos, qvel, ws, ctrl, fric, qpos_out,
                                  qvel_out, ws_out, B, p, newton_iters,
                                  ls_iters, frame_skip, use_fric, counters,
                                  team, stream);
}

// The blocks of the instantiation for float (f64 = 0) or double (f64 = 1)
// and the rung of `team` lanes that one SM holds at once.
int k1_blocks_per_sm(int f64, int team) {
  return f64 ? k1::Teams::blocks_per_sm<double>(team,
                                                  k1::kernel_of<double, false>)
             : k1::Teams::blocks_per_sm<float>(team,
                                                 k1::kernel_of<float, false>);
}

// Load every instantiation, timed and untimed (Ladder::load).
int k1_load() {
  return k1::Teams::load(k1::kernel_of<float, false>,
                         k1::kernel_of<float, true>,
                         k1::kernel_of<double, false>,
                         k1::kernel_of<double, true>);
}
#endif

// The batch from which a launch takes one lane per env.
int k1_crossover() { return k1::CROSSOVER; }

// The launch shape for B envs: lanes per env, envs per block and dynamic
// shared memory per block for float (f64 = 0) or double (f64 = 1).
void k1_launch_config(int f64, int B, int* team, int* envs, int* smem) {
  k1::Teams::launch_config(f64, B, team, envs, smem);
}

// One env's control step on the host in double precision, as a team of one
// lane on the row store of the one-lane instantiation (LaneRows, the
// one-pass solver), with every arithmetic operation counted. Writes the new
// state and returns the count.
long long k1_count_ops(const double* qpos, const double* qvel,
                       const double* ws, const double* ctrl, double fric,
                       double* qpos_out, double* qvel_out, double* ws_out,
                       const k1::Params* p, int newton_iters, int ls_iters,
                       int frame_skip, int use_fric) {
  return k1::count_ops<1>(qpos, qvel, ws, ctrl, fric, qpos_out, qvel_out,
                          ws_out, p, newton_iters, ls_iters, frame_skip,
                          use_fric, nullptr);
}

// The same, and `sections` receives the operations of each section of the
// chain, the rows and the coupled Newton steps (robot_common.cuh's
// counters but LAUNCHES).
long long k1_count_ops_sections(const double* qpos, const double* qvel,
                                const double* ws, const double* ctrl,
                                double fric, double* qpos_out,
                                double* qvel_out, double* ws_out,
                                const k1::Params* p, int newton_iters,
                                int ls_iters, int frame_skip, int use_fric,
                                long long* sections) {
  return k1::count_ops<1>(qpos, qvel, ws, ctrl, fric, qpos_out, qvel_out,
                          ws_out, p, newton_iters, ls_iters, frame_skip,
                          use_fric, sections);
}

// The same on the row store of the team instantiation (TeamRows, the
// by-entry solver that the team's lanes run), as a team of one lane.
long long k1_count_ops_team_rows(const double* qpos, const double* qvel,
                                 const double* ws, const double* ctrl,
                                 double fric, double* qpos_out,
                                 double* qvel_out, double* ws_out,
                                 const k1::Params* p, int newton_iters,
                                 int ls_iters, int frame_skip, int use_fric) {
  return k1::count_ops<k1::TEAM>(qpos, qvel, ws, ctrl, fric, qpos_out,
                                 qvel_out, ws_out, p, newton_iters, ls_iters,
                                 frame_skip, use_fric, nullptr);
}

}  // extern "C"
