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
// Design: the team solver of K1 and K2 (team_solve in robot_common.cuh),
// all substeps in one launch, one warp per block. Only qpos, qvel, warm
// start and ctrl cross device memory, once each; the ragged batch edge is
// masked per team; the scene (robot, contact parameters, up to MAX_WALLS
// axis-aligned walls) and the iteration counts are runtime arguments, so a
// change of solver grade rebuilds nothing.
// - Rows of included contacts only, in the serial order: wheel-floor,
//   chassis-floor, then per wall chassis-wall, left wheel-wall, right
//   wheel-wall; each contact's rows go to the slot that its included
//   predecessors leave (a masked row adds exact zeros to every sum). The
//   store holds the colliders' own worst case, so that no contact can be
//   dropped whatever the walls and the pose: 8 wheel-floor + 4
//   chassis-floor (plane-box keeps the deepest 4) + MAX_WALLS x (8
//   chassis-wall face contacts, or 1 edge contact, + 6 wheel-wall) = 68
//   contacts, 272 rows of J (8 columns), aref, D, J a - aref and J step.
//   A robot clear of the walls fills the first 8-32 rows.
// - The floor colliders run on every lane, as in K1; candidate c is
//   emitted by lane c mod G. The 3 x n_walls wall-collider calls (call
//   c = 3 w + i: wall w's box-box for i = 0, its box-cylinder with the
//   left or right wheel for i = 1, 2) are dealt whole to the lanes, call c
//   on lane c mod G; the team's shuffle scan of their counts of included
//   contacts gives each call its slot, and the lane that ran a call writes
//   its rows. Box-box returns before its manifold when the boxes are
//   apart, which for a wall is nearly always.
//
// Two instantiations of the one source, chosen by batch size in the
// wrapper (cuda_move.py), which reads the choice from k3_launch_config:
// - below CROSSOVER envs (serving: EnvMove05-v1 evaluates 2 x 256 episodes
//   in one batch of 512), a team of TEAM = 32 lanes per env, one env per
//   warp, its rows in dynamic shared memory (TeamRows: column-major with a
//   stride of 273, plus the 44 Hessian and gradient entries; 14,372 bytes
//   per env in float, 28,744 in double). At B = 512 each SM holds about 4
//   env-chains where one thread per env keeps 16 of 132 SMs busy, and the
//   272-row loops shrink 32-fold at a wall;
// - from CROSSOVER envs on (the 4096-env main path), a team of one lane,
//   one thread per env, its rows in the thread's own local array
//   (LaneRows: J row-major, 13,056 bytes in float), which the hardware
//   interleaves by thread so that a warp's accesses to one row coalesce;
//   every shuffle and warp sync compiles out, and on that store team_solve
//   takes each row's Hessian, gradient and force in one pass from J in
//   registers, as the one-thread design before did. A team there would
//   run the serial parts (fk, CRB, RNE, the floor colliders, M's
//   factorization) once per lane on a card that one thread per env
//   already fills: one thread per env takes ~17.4 ms at any batch up to
//   one warp per SM (4,224 envs).
// The crossover is where the 32-lane team stops fitting one wave: 255
// registers a thread leave 8 one-warp blocks per SM, 1,056 envs on 132
// SMs; a second wave doubles the team's time. Timed in turns on an H100
// 80GB HBM3 at 700 W (tools/time_kernels.py; PERF.md), ms at
// B = 512 / 1024 / 2048 / 4096, fast grade, on the EnvMove05-v1 main
// path's states: 32 lanes 10.1 / 13.3 / 25.7 / 50.1; one lane 17.4 /
// 17.6 / 17.6 / 17.5; 16 lanes 15.7 / 17.9 / 35.9 / 58.7; 8 lanes 27.6 /
// 28.0 / 52.4 / 78.1; 32 lanes capped at 128 registers (16 blocks per SM,
// a __launch_bounds__ minimum of 16, since removed) 16.8 / 22.8 / 43.5 /
// 71.0 (more spills than warps won); the one-thread-per-env design before
// 17.3 at every batch.
//
// What bounds it on an H100: the latency of each env's serial chain of
// scalar float math (no matrix product for the tensor cores); the
// operations are under 2% of the card's fp32 peak in that time (under
// 0.5% at B = 512) and about 208 bytes per env per control step cross
// device memory.
//
// ptxas (-Xptxas -v, nvcc 12.8, sm_90a), 255 registers for every kernel:
// float, 32 lanes: 2,176 bytes stack frame, 312 / 1,200 bytes spill
// stores / loads (2,160, 296 / 1,140 before the team shared the Newton
// factorization); float, one lane: 15,120 bytes stack frame (13,056 of it
// the rows), 240 / 828 spilled; double, 32 lanes: 5,360, 2,096 / 5,984;
// double, one lane: 31,184, 1,928 / 6,280 (the one-thread design before:
// float 14,736 bytes stack, 360 / 1,276 spilled; double 30,400, 2,140 /
// 6,716).
//
// Each rung also has a timed instantiation (TIMED; robot_common.cuh's
// section counters), which only a launch under torch.profiler takes: the
// same arithmetic and bits; float, 32 lanes 2,192 bytes stack, 352 /
// 1,228 spilled; one lane 15,120, 248 / 836. Where its chain spends its
// time: PERF.md.
//
// The same templated code also runs on the host with `Counted` and a team
// of one lane: k3_count_ops (on LaneRows, the one-pass solver) gives the
// operation count behind the kernel's bound, and with
// k3_count_ops_team_rows (on TeamRows, the by-entry solver that the team's
// lanes run; the same bits and count) lets both instantiations' arithmetic
// be compared with the plain version without a GPU. chip_smoke.py prints
// ptxas's registers, stack and spills of each build and each
// instantiation's launch shape.

#include "box_collide.cuh"
#include "robot_common.cuh"

namespace k3 {

using namespace brt;

constexpr int NV = NV_ROBOT;
constexpr int MAX_WALLS = 4;
constexpr int NFLOOR = 16;   // floor candidates: 2 x 4 wheel, 8 chassis
constexpr int MAXCON = 12 + 14 * MAX_WALLS;
constexpr int MAXROW = 4 * MAXCON;
// The small-batch team and the batch from which one lane per env runs
// instead (see above); only tools/time_kernels.py overrides them.
#ifndef BRT_K3_TEAM
#define BRT_K3_TEAM 32
#endif
#ifndef BRT_K3_CROSSOVER
#define BRT_K3_CROSSOVER 1057
#endif
constexpr int TEAM = BRT_K3_TEAM;
constexpr int CROSSOVER = BRT_K3_CROSSOVER;
// The row store of a team of G lanes: TeamRows for several lanes (shared
// memory), LaneRows for one (its own array, J row-major).
template <typename T, int G>
using Rows = std::conditional_t<G == 1, LaneRows<T, NV, MAXROW>,
                                TeamRows<T, NV, MAXROW>>;
// The rungs: the team of TEAM lanes, one lane per env from CROSSOVER on.
using Teams = Ladder<Rows, Rung<TEAM, 1>, Rung<1, CROSSOVER>>;

struct ParamsWalls {
  Params robot;
  ContactP wall_chassis, wall_wheel;   // wall_contact at each body's invweight
  int n_walls;
  double walls[MAX_WALLS][6];          // centre xyz, half-extents xyz
};

// The 4 rows of one wall contact of robot body `body` at `cpos` with
// distance `dist` in frame (n, t1, t2): -J on that body's chain.
template <typename T, class R>
BRT_HD void wall_rows(const R& rows, int r, const T cpos[3], T dist,
                      const T n[3], const T t1[3], const T t2[3], int body,
                      const ContactP& prm, const RobotKin<T>& k,
                      const T* qvel) {
  T Jn[NV], Jt1[NV], Jt2[NV];
  robot_neg_jac(cpos, body, n, t1, t2, k, Jn, Jt1, Jt2);
  emit_rows<T, NV>(rows, r, Jn, Jt1, Jt2, dist, T(prm.mu1), T(prm.mu2),
                   T(prm.dA1), T(prm.dA2), prm, qvel);
}

// ------------------------------------------------------- one substep
// `ck` takes the section edges (robot_common.cuh): SMOOTH and UPDATE here,
// the others in team_solve.
template <typename T, class Tm, class R, class Ck>
BRT_HD void substep(const Tm& tm, const R& rw, T qpos[9], T qvel[8],
                    T ws[8], const T ctrl[2], const ParamsWalls& P,
                    int newton_iters, int ls_iters, Ck& ck) {
  constexpr int G = Tm::G;
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
  ck.mark(SMOOTH);

  // ---- floor contacts, on every lane: left wheel 0-3, right wheel 4-7,
  // chassis 8-15; candidate c goes to lane c mod G, at the slot its
  // included predecessors leave
  const T axis[3] = {k.R[0][0], k.R[1][0], k.R[2][0]};
  T cc[3];
  for (int a = 0; a < 3; ++a) cc[a] = k.pos[a] + k.R[a][2] * T(CH_OFF);
  unsigned fmask = 0;
  {
    T fpos[NFLOOR][3], fdist[NFLOOR];
    bool finc[NFLOOR];
    plane_cylinder(k.xl, axis, fpos, fdist, finc);
    plane_cylinder(k.xr, axis, fpos + 4, fdist + 4, finc + 4);
    plane_box(cc, k.R, CH_HX, CH_HY, CH_HZ, T(0.0), fpos + 8, fdist + 8,
              finc + 8);
    for (int c = 0; c < NFLOOR; ++c) fmask |= finc[c] ? 1u << c : 0u;
    tm.sync();   // every lane is done with the last substep's rows
#pragma unroll 1
    for (int c = tm.lane; c < NFLOOR; c += G) {
      if (!((fmask >> c) & 1u)) continue;
      const int body = c < 4 ? 1 : (c < 8 ? 2 : 0);
      const ContactP& prm = body ? p.wheel : p.chassis;
      robot_floor_rows<T, NV>(rw, 4 * popc(fmask & ((1u << c) - 1u)),
                              fpos[c], fdist[c], body, T(prm.mu1),
                              T(prm.mu2), T(prm.dA1), T(prm.dA2), prm, k,
                              qvel);
    }
  }
  int nrow = 4 * popc(fmask);

  // ---- wall contacts: call c = 3 w + i (wall w; i = 0 chassis box-box,
  // 1 left and 2 right wheel box-cylinder) runs on lane c mod G; the
  // team's scan of the calls' contact counts, in call order, gives each
  // call its slot after the floor rows, and the lane that ran it writes
  // its rows there
  const T chalf[3] = {T(CH_HX), T(CH_HY), T(CH_HZ)};
  const T eye[3][3] = {{T(1.0), T(0.0), T(0.0)},
                       {T(0.0), T(1.0), T(0.0)},
                       {T(0.0), T(0.0), T(1.0)}};
  const T no_margin = T(0.0);
  const int ncalls = 3 * P.n_walls;
#pragma unroll 1
  for (int c0 = 0; c0 < ncalls; c0 += G) {
    const int c = c0 + tm.lane;
    const int w = c / 3, body = c % 3;
    T pos[8][3], dist[8], n[3], t1[3], t2[3], wn[3][3];
    bool winc[3];
    int cnt = 0;
    if (c < ncalls) {
      const T cw[3] = {T(P.walls[w][0]), T(P.walls[w][1]), T(P.walls[w][2])};
      const T hw[3] = {T(P.walls[w][3]), T(P.walls[w][4]), T(P.walls[w][5])};
      if (body == 0) {
        cnt = box_box(cc, k.R, chalf, cw, eye, hw, no_margin, pos, dist, n,
                      t1, t2);
      } else {
        box_cylinder(cw, eye, hw, body == 1 ? k.xl : k.xr, axis, T(WHEEL_R),
                     T(WHEEL_H), no_margin, pos, dist, winc, wn);
        cnt = int(winc[0]) + int(winc[1]) + int(winc[2]);
      }
    }
    int total;
    int r = nrow + 4 * tm.excl_scan(cnt, total);
    if (c < ncalls) {
      if (body == 0) {
        for (int i = 0; i < cnt; ++i, r += 4)
          wall_rows(rw, r, pos[i], dist[i], n, t1, t2, 0, P.wall_chassis, k,
                    qvel);
      } else {
        for (int i = 0; i < 3; ++i)
          if (winc[i]) {
            make_frame(wn[i], t1, t2);
            wall_rows(rw, r, pos[i], dist[i], wn[i], t1, t2, body,
                      P.wall_wheel, k, qvel);
            r += 4;
          }
      }
    }
    nrow += 4 * total;
  }
  tm.sync();

  team_solve<T, NV, MAXROW>(tm, rw, nrow, nrow, M, T(0.0), T(0.0), a_smooth,
                            qfrc_smooth, dfdv, p, newton_iters, ls_iters,
                            qvel, ws, ck);
  integrate_robot(qpos, qvel, T(p.timestep));
  ck.mark(UPDATE);
}

template <typename T, class Tm, class R, class Ck>
BRT_HD void control_step_one(const Tm& tm, const R& rw, T q[9],
                             T v[8], T w[8], const T c[2],
                             const ParamsWalls& p, int newton_iters,
                             int ls_iters, int frame_skip, Ck& ck) {
  for (int s = 0; s < frame_skip; ++s)
    substep(tm, rw, q, v, w, c, p, newton_iters, ls_iters, ck);
}

// One env's control step on the host (brt::count_ops) on the row store of
// the team of G lanes; `sections`, if not null, receives its counters.
template <int G>
long long count_ops(const double* qpos, const double* qvel, const double* ws,
                    const double* ctrl, double* qpos_out, double* qvel_out,
                    double* ws_out, const ParamsWalls* p, int newton_iters,
                    int ls_iters, int frame_skip, long long* sections) {
  return brt::count_ops<9, 8, Rows<Counted, G>>(
      qpos, qvel, ws, ctrl, qpos_out, qvel_out, ws_out, sections,
      [&](const auto& tm, const auto& rw, Counted* q, Counted* v, Counted* w,
          const Counted* c, auto& ck) {
        control_step_one(tm, rw, q, v, w, c, *p, newton_iters, ls_iters,
                         frame_skip, ck);
      });
}

#ifdef __CUDACC__
// One warp per block, THREADS / G teams of G lanes, one env per team
// (brt::step_envs). The TIMED instantiation counts the sections of each
// env's chain into `counters` (robot_common.cuh); the other leaves them
// alone.
template <typename T, int G, bool TIMED>
__global__ void __launch_bounds__(THREADS, 1)
    control_step_walls_kernel(
        const T* __restrict__ qpos, const T* __restrict__ qvel,
        const T* __restrict__ ws, const T* __restrict__ ctrl,
        T* __restrict__ qpos_out, T* __restrict__ qvel_out,
        T* __restrict__ ws_out, int B, ParamsWalls p, int newton_iters,
        int ls_iters, int frame_skip, long long* __restrict__ counters) {
  using Ck = std::conditional_t<TIMED, SectionClock<SmCycles>, NoClock>;
  step_envs<T, Team<G>, Rows<T, G>, 9, 8, Ck>(
      qpos, qvel, ws, ctrl, qpos_out, qvel_out, ws_out, B, counters,
      [&](const Team<G>& tm, const Rows<T, G>& rw, T* q, T* v, T* w,
          const T* c, int, Ck& ck) {
        control_step_one(tm, rw, q, v, w, c, p, newton_iters, ls_iters,
                         frame_skip, ck);
      });
}

// The kernel's instantiation for T, the rung of a team of g lanes and
// TIMED.
template <typename T, bool TIMED>
constexpr auto kernel_of = [](auto g) {
  return control_step_walls_kernel<T, decltype(g)::value, TIMED>;
};

// Launch the instantiation for T, TIMED and the rung of `team` lanes.
template <typename T, bool TIMED>
int launch(const T* qpos, const T* qvel, const T* ws, const T* ctrl,
           T* qpos_out, T* qvel_out, T* ws_out, int B, const ParamsWalls* p,
           int newton_iters, int ls_iters, int frame_skip,
           long long* counters, int team, void* stream) {
  return Teams::launch<T>(team, B, stream, kernel_of<T, TIMED>, qpos, qvel,
                          ws, ctrl, qpos_out, qvel_out, ws_out, B, *p,
                          newton_iters, ls_iters, frame_skip, counters);
}
#endif

}  // namespace k3

extern "C" {

#ifdef __CUDACC__
// Launch K3 on `stream` for B envs (row-major (B,9)/(B,8)/(B,8)/(B,2)
// inputs) with `team` lanes per env, as k3_launch_config gives it for B.
// Returns the CUDA error of the launch, 0 if none.
int k3_control_step_f32(const float* qpos, const float* qvel, const float* ws,
                        const float* ctrl, float* qpos_out, float* qvel_out,
                        float* ws_out, int B, const k3::ParamsWalls* p,
                        int newton_iters, int ls_iters, int frame_skip,
                        int team, void* stream) {
  return k3::launch<float, false>(qpos, qvel, ws, ctrl, qpos_out, qvel_out,
                                  ws_out, B, p, newton_iters, ls_iters,
                                  frame_skip, nullptr, team, stream);
}

int k3_control_step_f64(const double* qpos, const double* qvel,
                        const double* ws, const double* ctrl,
                        double* qpos_out, double* qvel_out, double* ws_out,
                        int B, const k3::ParamsWalls* p, int newton_iters,
                        int ls_iters, int frame_skip, int team,
                        void* stream) {
  return k3::launch<double, false>(qpos, qvel, ws, ctrl, qpos_out, qvel_out,
                                   ws_out, B, p, newton_iters, ls_iters,
                                   frame_skip, nullptr, team, stream);
}

// The same with the timed instantiation, which adds each env's section
// counters to its row of `counters` ((B, NCOUNTER) int64).
int k3_control_step_timed_f32(const float* qpos, const float* qvel,
                              const float* ws, const float* ctrl,
                              float* qpos_out, float* qvel_out,
                              float* ws_out, int B, const k3::ParamsWalls* p,
                              int newton_iters, int ls_iters, int frame_skip,
                              long long* counters, int team, void* stream) {
  return k3::launch<float, true>(qpos, qvel, ws, ctrl, qpos_out, qvel_out,
                                 ws_out, B, p, newton_iters, ls_iters,
                                 frame_skip, counters, team, stream);
}

int k3_control_step_timed_f64(const double* qpos, const double* qvel,
                              const double* ws, const double* ctrl,
                              double* qpos_out, double* qvel_out,
                              double* ws_out, int B,
                              const k3::ParamsWalls* p, int newton_iters,
                              int ls_iters, int frame_skip,
                              long long* counters, int team, void* stream) {
  return k3::launch<double, true>(qpos, qvel, ws, ctrl, qpos_out, qvel_out,
                                  ws_out, B, p, newton_iters, ls_iters,
                                  frame_skip, counters, team, stream);
}

// The blocks of the instantiation for float (f64 = 0) or double (f64 = 1)
// and the rung of `team` lanes that one SM holds at once.
int k3_blocks_per_sm(int f64, int team) {
  return f64 ? k3::Teams::blocks_per_sm<double>(team,
                                                  k3::kernel_of<double, false>)
             : k3::Teams::blocks_per_sm<float>(team,
                                                 k3::kernel_of<float, false>);
}

// Load every instantiation, timed and untimed (Ladder::load).
int k3_load() {
  return k3::Teams::load(k3::kernel_of<float, false>,
                         k3::kernel_of<float, true>,
                         k3::kernel_of<double, false>,
                         k3::kernel_of<double, true>);
}
#endif

// The most walls a ParamsWalls holds.
int k3_max_walls() { return k3::MAX_WALLS; }

// The batch from which a launch takes one lane per env.
int k3_crossover() { return k3::CROSSOVER; }

// The launch shape for B envs: lanes per env, envs per block and dynamic
// shared memory per block for float (f64 = 0) or double (f64 = 1).
void k3_launch_config(int f64, int B, int* team, int* envs, int* smem) {
  k3::Teams::launch_config(f64, B, team, envs, smem);
}

// One env's control step on the host in double precision, as a team of one
// lane on the row store of the one-lane instantiation (LaneRows, the
// one-pass solver), with every arithmetic operation counted. Writes the new
// state and returns the count.
long long k3_count_ops(const double* qpos, const double* qvel,
                       const double* ws, const double* ctrl,
                       double* qpos_out, double* qvel_out, double* ws_out,
                       const k3::ParamsWalls* p, int newton_iters,
                       int ls_iters, int frame_skip) {
  return k3::count_ops<1>(qpos, qvel, ws, ctrl, qpos_out, qvel_out, ws_out,
                          p, newton_iters, ls_iters, frame_skip, nullptr);
}

// The same, and `sections` receives the operations of each section of the
// chain, the rows and the coupled Newton steps (robot_common.cuh's
// counters but LAUNCHES).
long long k3_count_ops_sections(const double* qpos, const double* qvel,
                                const double* ws, const double* ctrl,
                                double* qpos_out, double* qvel_out,
                                double* ws_out, const k3::ParamsWalls* p,
                                int newton_iters, int ls_iters,
                                int frame_skip, long long* sections) {
  return k3::count_ops<1>(qpos, qvel, ws, ctrl, qpos_out, qvel_out, ws_out,
                          p, newton_iters, ls_iters, frame_skip, sections);
}

// The same on the row store of the team instantiation (TeamRows, the
// by-entry solver that the team's lanes run), as a team of one lane.
long long k3_count_ops_team_rows(const double* qpos, const double* qvel,
                                 const double* ws, const double* ctrl,
                                 double* qpos_out, double* qvel_out,
                                 double* ws_out, const k3::ParamsWalls* p,
                                 int newton_iters, int ls_iters,
                                 int frame_skip) {
  return k3::count_ops<k3::TEAM>(qpos, qvel, ws, ctrl, qpos_out, qvel_out,
                                 ws_out, p, newton_iters, ls_iters,
                                 frame_skip, nullptr);
}

}  // extern "C"
