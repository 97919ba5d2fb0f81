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
// Design: a team of G lanes of one warp per env (team_solve in
// robot_common.cuh), one warp per block (THREADS / G envs), all substeps
// in one launch. Only qpos, qvel, warm start and ctrl cross device memory,
// once each; the ragged batch edge is masked per team; scene parameters
// and iteration counts are runtime arguments.
// - Rows in shared memory. Only included contacts are kept, in the order
//   robot-floor, block-floor, chassis-block, wheel-block; at most 8 + 4 + 4
//   + 8 + 6 = 30 contacts (plane-box keeps the deepest 4; box-box gives 8
//   face contacts or 1 edge contact), 120 rows, and every one of them fits:
//   J (14 columns), aref, D, J a - aref, J step and the active weight,
//   column-major with a stride of 121, plus the 119 Hessian and gradient
//   entries: 9,672 bytes per env in float, 19,344 in double. Sizing for the
//   worst case keeps every contact without a second buffer in device
//   memory.
// - The 7 collider calls are dealt whole to the lanes (call c on lane c mod
//   G); calls of one kind share a code path, so a warp runs 4 collider
//   paths. The team's scan of their counts of included contacts gives each
//   call its first contact and couple_row. Each call's lane stages its
//   contacts (point, distance, frame) in the row store's solver scratch,
//   and the contacts are dealt to the lanes, which write their rows: one
//   round for 32 lanes. Writing a call's rows on the lane that ran it cost
//   the Env03-v2 main path's impact steps 13% at 4096 (8 box-box contacts
//   in turn on one lane; PERF.md).
// - The solver's row loops run over the team's lanes with shuffle sums;
//   the lanes own the Hessian's 105 lower-triangle entries and the 14
//   gradient entries and walk the active rows for them. Every
//   instantiation takes its sums as 32 lanes would (Team's W = SUM_LANES:
//   a team of 8 keeps 4 partials per lane), and every other sum is taken
//   by one lane in row order, so an env's bits do not depend on the batch:
//   the oracle's replay at F gives what its generations scored at F x 128.
// - M is block-diagonal, and so is the Newton H while no chassis-block or
//   wheel-block row (the rows from `couple_row` on) is active: then H is
//   factorized as 8x8 and 6x6, which gives the bits of the 14x14
//   factorization (its off-block entries are exact zeros); when one is
//   active (the block touching the robot), as the full 14x14. The team
//   shares either out (team_factor_solve in robot_common.cuh): lane r mod
//   G owns row r of the factor (a team of 8: two rows per lane), loads it
//   from the H scratch at once and keeps it in registers; per column the
//   diagonal's owner takes the square root, a shuffle gives it to the
//   team and each lane divides its own entry, in the serial code's order,
//   so the same bits. The 8x8 and the 6x6 run side by side on their own
//   lanes, as the 14x14's first 8 columns: the envs of a warp that take
//   both run one code path, the coupled ones 6 columns longer.
//
// Three instantiations of the one source, chosen by batch size in the
// wrapper (cuda_block.py), which reads the choice from k2_launch_config.
// Each takes the widest team whose warps fit one per scheduler (4 per SM on
// 132 SMs); from there on a wider team's redundant serial work (fk, CRB,
// RNE and M's factor on every lane) queues at the schedulers:
// - below MID envs (the evals at 512, cli test at B = 1), a team of TEAM =
//   32 lanes, one env per warp: the row loops and the Hessian's entries
//   split 32 ways, and no env waits on another's path (its row count,
//   box-box's manifold, the coupled factorization) at the team's syncs;
// - from MID to CROSSOVER envs (the training and DAgger collects and the
//   flagship serving at 1024, the MPC expert's plan rollouts, 64
//   candidates per state), a team of MID_TEAM = 16 lanes, 2 envs per warp;
// - from CROSSOVER envs on (the 4096-env main path, the oracle's 1,792), a
//   team of MAIN_TEAM = 8 lanes, 4 envs per warp, 38.7 KB of rows per block
//   in float (5 blocks per SM), where 32 lanes would take several waves.
// What bounds it on an H100: the latency of each env's serial chain, not
// operations or bytes. The fk/CRB/RNE, the colliders and the Newton
// factorization's columns are one long dependent chain of scalar float
// math (no matrix product for the tensor cores, and float32 physics
// rules out TF32); about 240 bytes per env per control step cross device
// memory. 255 registers a thread leave 8 one-warp blocks per SM. Timed in
// turns on an H100 80GB HBM3 at 700 W
// (tools/time_kernels.py; PERF.md), ms at B = 1 / 512 / 1024 / 2048 / 4096
// on the Env03-v2 main path's states, fast grade: 32 lanes 13.97 / 14.66
// / 18.21 / 35.61 / 69.66; 16 lanes 14.48 / 17.36 / 18.25 / 23.98 /
// 42.48; 8 lanes 15.30 / 20.25 / 22.16 / 25.07 / 41.81; the one-team
// design before (8 lanes, every lane running every collider) 15.86 / 20.38
// / 22.49 / 25.48 / 43.95. Exact grade: 32 lanes 25.65 / 28.12 / 35.45 /
// 68.51 / 135.42; 16 lanes 26.66 / 32.58 / 34.71 / 44.28 / 80.34; 8 lanes
// 27.30 / 38.18 / 41.85 / 46.72 / 76.93; before 27.76 / 37.50 / 41.48 /
// 46.74 / 77.56. Where the envs of a batch run in lockstep (the MPC
// expert's 14 states x 64 candidates, B = 896), 32 lanes read 21.69 ms
// fast and 46.13 exact, 16 lanes 19.05 / 36.28, 8 lanes 20.12 / 35.93, the
// design before 20.89 / 36.50; at 8 x 64 = 512 (one warp per scheduler)
// 32 lanes 15.64 / 33.30 against 8 lanes' 20.32 / 35.99. On the main
// path's states at 640 / 768 / 896, 32 lanes 16.90 / 17.88 / 18.44, 16
// lanes 17.20 / 17.87 / 18.30. Capping registers at 168 or 128 made the float kernel
// spill 4-6x as much and lost more than the extra warps won.
//
// ptxas (-Xptxas -v, nvcc 12.8, sm_90a), 255 registers for every kernel,
// stack frame, spill stores / loads in bytes: float, 32 lanes 1,696, 268
// / 432; 16 lanes 1,696, 276 / 436; 8 lanes 1,696, 380 / 1,208; double,
// 32 lanes 4,400, 4,432 / 8,720; 16 lanes 4,416, 5,248 / 10,084; 8 lanes
// 4,368, 3,340 / 7,564. With every lane factorizing the whole H (before
// the team shared it): float 1,712, 400 / 1,340; 1,712, 368 / 1,088;
// 1,760, 472 / 1,492; double 4,448, 3,320 / 8,952; 4,512, 3,444 / 9,096;
// 4,560, 3,496 / 9,140. Shared out, the factorization and its solves take
// ~35% less time at B = 1, 16-19% less at 512 and 1,024, 17-32% less on
// impact states, and the team of 8 (two rows per lane) 2-6% more at 1,792
// to 4096 on the main path's calm states (in turns; PERF.md).
//
// Each rung also has a timed instantiation (TIMED; robot_common.cuh's
// section counters), which only a launch under torch.profiler takes: the
// same arithmetic and bits; float, 32 lanes: the same ptxas line; 16
// lanes 1,728, 344 / 588; 8 lanes 1,744, 464 / 1,436. Where its chain
// spends its time: PERF.md.
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
// The small-batch team, the batch from which MID_TEAM runs instead, the
// batch from which MAIN_TEAM runs, and the blocks per SM that registers
// are capped for (__launch_bounds__; see above); only
// tools/time_kernels.py overrides them.
#ifndef BRT_K2_TEAM
#define BRT_K2_TEAM 32
#endif
#ifndef BRT_K2_MID
#define BRT_K2_MID 529
#endif
#ifndef BRT_K2_MID_TEAM
#define BRT_K2_MID_TEAM 16
#endif
#ifndef BRT_K2_CROSSOVER
#define BRT_K2_CROSSOVER 1057
#endif
#ifndef BRT_K2_MINB
#define BRT_K2_MINB 1
#endif
constexpr int TEAM = BRT_K2_TEAM;
constexpr int MAIN_TEAM = 8;
constexpr int CROSSOVER = BRT_K2_CROSSOVER;
constexpr int MID = BRT_K2_MID;
constexpr int MID_TEAM = BRT_K2_MID_TEAM;
// Every instantiation takes its row sums as a team of 32 lanes would
// (Team's W): the bits of an env's step do not depend on the batch.
constexpr int SUM_LANES = 32;
constexpr int NCALL = 7;         // collider calls per substep
constexpr int COUPLE_CALL = 4;   // the first call of a robot-block pair
// Every team keeps its rows in shared memory.
template <typename T, int G = 1>
using Rows = TeamRows<T, NV, MAXROW>;
// The rungs: TEAM lanes, MID_TEAM from MID on, MAIN_TEAM from CROSSOVER on.
using Teams = Ladder<Rows, Rung<TEAM, 1>, Rung<MID_TEAM, MID>,
                     Rung<MAIN_TEAM, CROSSOVER>>;

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

BRT_HD int as_int(float x) { return int(x); }
BRT_HD int as_int(double x) { return int(x); }
BRT_HD int as_int(Counted x) { return int(x.v); }

// The contacts between the colliders and their rows: contact q's call,
// point, distance and frame (the normal alone where its rows make the
// tangents), kept in the row store's solver scratch (its columns from
// jar on), which team_solve fills only after the rows are written.
template <typename T>
struct Staged {
  static constexpr int N = 14;   // values per contact
  T* base;
  BRT_HD T* at(int q) const {
    BRT_REQUIRE(q >= 0 && q < MAXCON);
    return base + q * N;
  }
  BRT_HD T* pos(int q) const { return at(q); }
  BRT_HD T& dist(int q) const { return at(q)[3]; }
  BRT_HD T* n(int q) const { return at(q) + 4; }
  BRT_HD T* t1(int q) const { return at(q) + 7; }
  BRT_HD T* t2(int q) const { return at(q) + 10; }
  // the call, kept as a value of T (exact for these small integers)
  BRT_HD void set_call(int q, int c) const { at(q)[13] = T(double(c)); }
  BRT_HD int call(int q) const { return as_int(at(q)[13]); }
};
static_assert(MAXCON * Staged<float>::N <=
                  Rows<float>::SIZE - Rows<float>::JAR * Rows<float>::RS,
              "the staged contacts fit the row store's scratch");

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

// ------------------------------------------------------- one substep
// `ck` takes the section edges (robot_common.cuh): SMOOTH and UPDATE here,
// the others in team_solve.
template <typename T, class Tm, class Ck>
BRT_HD void substep(const Tm& tm, const Rows<T>& rw, T qpos[16], T qvel[14],
                    T ws[14], const T ctrl[2], const Params14& P,
                    int newton_iters, int ls_iters, Ck& ck) {
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
  ck.mark(SMOOTH);

  // ---- contacts: NCALL collider calls, call c on lane c mod G: 0, 1 the
  // left and right wheel on the floor (plane-cylinder, 4 candidates each),
  // 2 the chassis and 3 the block on the floor (plane-box, the deepest 4 of
  // 8 corners, the block's with its margin), 4 chassis-block (box-box, up to
  // 8), 5, 6 the left and right wheel on the block (box-cylinder, 3 each).
  // Calls of one kind share their code path, their arguments chosen by
  // value, so a warp runs 4 collider paths, not 7. The team's scan of the
  // calls' counts of included contacts, in call order, gives each call its
  // first contact, so the contacts keep the serial order robot-floor,
  // block-floor, chassis-block, wheel-block, each call's in their own
  // order; the scan's partial total (the calls before COUPLE_CALL, packed
  // above bit 8) gives couple_row. The lane that ran a call stages its
  // contacts; then the contacts are dealt to the lanes, contact q on lane
  // q mod G, which write its 4 rows.
  constexpr int G = Tm::G;
  const T margin = T(P.block_margin);
  const T axis[3] = {k.R[0][0], k.R[1][0], k.R[2][0]};
  const T bhalf[3] = {T(P.block_half), T(P.block_half), T(P.block_half)};
  const T chalf[3] = {T(CH_HX), T(CH_HY), T(CH_HZ)};
  T cc[3];
  for (int a = 0; a < 3; ++a) cc[a] = k.pos[a] + k.R[a][2] * T(CH_OFF);
  const Staged<T> st{&rw.jar(0)};
  int ncon = 0, ncouple = 0;
  tm.sync();   // every lane is done with the last substep's rows
#pragma unroll 1
  for (int c0 = 0; c0 < NCALL; c0 += G) {
    const int c = c0 + tm.lane;
    T pos[8][3], dist[8], n[3], t1[3], t2[3], wn[3][3];
    bool inc[8];
    for (int i = 0; i < 8; ++i) inc[i] = false;
    if (c < 2) {
      T x[3];
      for (int a = 0; a < 3; ++a) x[a] = c == 0 ? k.xl[a] : k.xr[a];
      plane_cylinder(x, axis, pos, dist, inc);
    } else if (c < 4) {
      const bool ch = c == 2;
      T x[3], R[3][3];
      for (int a = 0; a < 3; ++a) {
        x[a] = ch ? cc[a] : s.pos_b[a];
        for (int b = 0; b < 3; ++b) R[a][b] = ch ? k.R[a][b] : s.Rb[a][b];
      }
      plane_box(x, R, ch ? CH_HX : P.block_half, ch ? CH_HY : P.block_half,
                ch ? CH_HZ : P.block_half, ch ? T(0.0) : margin, pos, dist,
                inc);
    } else if (c == COUPLE_CALL) {
      const int nbox = box_box(cc, k.R, chalf, s.pos_b, s.Rb, bhalf, margin,
                               pos, dist, n, t1, t2);
      for (int i = 0; i < 8; ++i) inc[i] = i < nbox;
    } else if (c < NCALL) {
      T x[3];
      for (int a = 0; a < 3; ++a) x[a] = c == 5 ? k.xl[a] : k.xr[a];
      box_cylinder(s.pos_b, s.Rb, bhalf, x, axis, T(WHEEL_R), T(WHEEL_H),
                   margin, pos, dist, inc, wn);
    }
    int cnt = 0;
    for (int i = 0; i < 8; ++i) cnt += inc[i] ? 1 : 0;
    int total;
    int q = ncon + (tm.excl_scan(cnt + (c < COUPLE_CALL ? cnt << 8 : 0),
                                 total) & 0xff);
    ncon += total & 0xff;
    ncouple += total >> 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (!inc[i]) continue;
      st.set_call(q, c);
      for (int a = 0; a < 3; ++a) st.pos(q)[a] = pos[i][a];
      st.dist(q) = dist[i];
      if (c == COUPLE_CALL) {
        for (int a = 0; a < 3; ++a) {
          st.n(q)[a] = n[a];
          st.t1(q)[a] = t1[a];
          st.t2(q)[a] = t2[a];
        }
      } else if (c > COUPLE_CALL && i < 3) {
        for (int a = 0; a < 3; ++a) st.n(q)[a] = wn[i][a];
      }
      ++q;
    }
  }
  tm.sync();
#pragma unroll 1
  for (int q = tm.lane; q < ncon; q += G) {
    const int c = st.call(q);
    T cpos[3];
    for (int a = 0; a < 3; ++a) cpos[a] = st.pos(q)[a];
    const T dist = st.dist(q);
    if (c < 3) {
      const int body = c == 2 ? 0 : c + 1;
      const ContactP& prm = body ? p.wheel : p.chassis;
      robot_floor_rows<T, NV>(rw, 4 * q, cpos, dist, body, T(prm.mu1),
                              T(prm.mu2), T(prm.dA1), T(prm.dA2), prm, k,
                              qvel);
    } else {
      T fn[3], ft1[3], ft2[3];
      if (c == 3) {   // the floor's frame
        for (int a = 0; a < 3; ++a) fn[a] = ft1[a] = ft2[a] = T(0.0);
        fn[2] = T(1.0);
        ft1[1] = T(1.0);
        ft2[0] = T(-1.0);
      } else {
        for (int a = 0; a < 3; ++a) fn[a] = st.n(q)[a];
        if (c == COUPLE_CALL) {
          for (int a = 0; a < 3; ++a) {
            ft1[a] = st.t1(q)[a];
            ft2[a] = st.t2(q)[a];
          }
        } else {
          make_frame(fn, ft1, ft2);
        }
      }
      block_rows(rw, 4 * q, cpos, dist - margin, fn, ft1, ft2,
                 c == 3 ? -1 : c - COUPLE_CALL,
                 c == 3 ? P.block_floor
                        : (c == COUPLE_CALL ? P.block_chassis
                                            : P.block_wheel),
                 s, qvel);
    }
  }
  tm.sync();
  const int nrow = 4 * ncon, couple_row = 4 * ncouple;

  team_solve<T, NV, MAXROW>(tm, rw, nrow, couple_row, Mr, mb, Ib, a_smooth,
                            qfrc_smooth, dfdv, p, newton_iters, ls_iters,
                            qvel, ws, ck);
  const T h = T(p.timestep);
  integrate_robot(qpos, qvel, h);
  for (int i = 0; i < 3; ++i) qpos[9 + i] = qpos[9 + i] + h * qvel[8 + i];
  quat_integrate(qpos + 12, qvel + 11, h);
  ck.mark(UPDATE);
}

template <typename T, class Tm, class Ck>
BRT_HD void control_step_one(const Tm& tm, const Rows<T>& rw, T q[16],
                             T v[14], T w[14], const T c[2],
                             const Params14& p, int newton_iters,
                             int ls_iters, int frame_skip, Ck& ck) {
  for (int s = 0; s < frame_skip; ++s)
    substep(tm, rw, q, v, w, c, p, newton_iters, ls_iters, ck);
}

// One env's control step on the host (brt::count_ops); `sections`, if not
// null, receives its counters.
long long count_ops(const double* qpos, const double* qvel, const double* ws,
                    const double* ctrl, double* qpos_out, double* qvel_out,
                    double* ws_out, const Params14* p, int newton_iters,
                    int ls_iters, int frame_skip,
                    long long* coupled_factorizations, long long* sections) {
  g_coupled = 0;
  const long long ops = brt::count_ops<16, 14, Rows<Counted>>(
      qpos, qvel, ws, ctrl, qpos_out, qvel_out, ws_out, sections,
      [&](const auto& tm, const auto& rw, Counted* q, Counted* v, Counted* w,
          const Counted* c, auto& ck) {
        control_step_one(tm, rw, q, v, w, c, *p, newton_iters, ls_iters,
                         frame_skip, ck);
      });
  *coupled_factorizations = g_coupled;
  return ops;
}

#ifdef __CUDACC__
// One warp per block, THREADS / G teams of G lanes, one env per team
// (brt::step_envs), each team's rows in its slice of the block's dynamic
// shared memory. The TIMED instantiation counts the sections of each env's
// chain into `counters` (robot_common.cuh); the other leaves them alone.
template <typename T, int G, bool TIMED>
__global__ void __launch_bounds__(THREADS, BRT_K2_MINB) control_step14_kernel(
    const T* __restrict__ qpos, const T* __restrict__ qvel,
    const T* __restrict__ ws, const T* __restrict__ ctrl,
    T* __restrict__ qpos_out, T* __restrict__ qvel_out,
    T* __restrict__ ws_out, int B, Params14 p, int newton_iters,
    int ls_iters, int frame_skip, long long* __restrict__ counters) {
  using Ck = std::conditional_t<TIMED, SectionClock<SmCycles>, NoClock>;
  step_envs<T, Team<G, SUM_LANES>, Rows<T>, 16, 14, Ck>(
      qpos, qvel, ws, ctrl, qpos_out, qvel_out, ws_out, B, counters,
      [&](const Team<G, SUM_LANES>& tm, const Rows<T>& rw, T* q, T* v, T* w,
          const T* c, int, Ck& ck) {
        control_step_one(tm, rw, q, v, w, c, p, newton_iters, ls_iters,
                         frame_skip, ck);
      });
}

// The kernel's instantiation for T, the rung of a team of g lanes and
// TIMED.
template <typename T, bool TIMED>
constexpr auto kernel_of = [](auto g) {
  return control_step14_kernel<T, decltype(g)::value, TIMED>;
};

// Launch the instantiation for T, TIMED and the rung of `team` lanes.
template <typename T, bool TIMED>
int launch(const T* qpos, const T* qvel, const T* ws, const T* ctrl,
           T* qpos_out, T* qvel_out, T* ws_out, int B, const Params14* p,
           int newton_iters, int ls_iters, int frame_skip,
           long long* counters, int team, void* stream) {
  return Teams::launch<T>(team, B, stream, kernel_of<T, TIMED>, qpos, qvel,
                          ws, ctrl, qpos_out, qvel_out, ws_out, B, *p,
                          newton_iters, ls_iters, frame_skip, counters);
}
#endif

}  // namespace k2

extern "C" {

#ifdef __CUDACC__
// Launch K2 on `stream` for B envs (row-major (B,16)/(B,14)/(B,14)/(B,2)
// inputs) with `team` lanes per env, as k2_launch_config gives it for B.
// Returns the CUDA error of the launch, 0 if none.
int k2_control_step_f32(const float* qpos, const float* qvel, const float* ws,
                        const float* ctrl, float* qpos_out, float* qvel_out,
                        float* ws_out, int B, const k2::Params14* p,
                        int newton_iters, int ls_iters, int frame_skip,
                        int team, void* stream) {
  return k2::launch<float, false>(qpos, qvel, ws, ctrl, qpos_out, qvel_out,
                                  ws_out, B, p, newton_iters, ls_iters,
                                  frame_skip, nullptr, team, stream);
}

int k2_control_step_f64(const double* qpos, const double* qvel,
                        const double* ws, const double* ctrl,
                        double* qpos_out, double* qvel_out, double* ws_out,
                        int B, const k2::Params14* p, int newton_iters,
                        int ls_iters, int frame_skip, int team,
                        void* stream) {
  return k2::launch<double, false>(qpos, qvel, ws, ctrl, qpos_out, qvel_out,
                                   ws_out, B, p, newton_iters, ls_iters,
                                   frame_skip, nullptr, team, stream);
}

// The same with the timed instantiation, which adds each env's section
// counters to its row of `counters` ((B, NCOUNTER) int64).
int k2_control_step_timed_f32(const float* qpos, const float* qvel,
                              const float* ws, const float* ctrl,
                              float* qpos_out, float* qvel_out,
                              float* ws_out, int B, const k2::Params14* p,
                              int newton_iters, int ls_iters, int frame_skip,
                              long long* counters, int team, void* stream) {
  return k2::launch<float, true>(qpos, qvel, ws, ctrl, qpos_out, qvel_out,
                                 ws_out, B, p, newton_iters, ls_iters,
                                 frame_skip, counters, team, stream);
}

int k2_control_step_timed_f64(const double* qpos, const double* qvel,
                              const double* ws, const double* ctrl,
                              double* qpos_out, double* qvel_out,
                              double* ws_out, int B, const k2::Params14* p,
                              int newton_iters, int ls_iters, int frame_skip,
                              long long* counters, int team, void* stream) {
  return k2::launch<double, true>(qpos, qvel, ws, ctrl, qpos_out, qvel_out,
                                  ws_out, B, p, newton_iters, ls_iters,
                                  frame_skip, counters, team, stream);
}

// The blocks of the instantiation for float (f64 = 0) or double (f64 = 1)
// and the rung of `team` lanes that one SM holds at once.
int k2_blocks_per_sm(int f64, int team) {
  return f64 ? k2::Teams::blocks_per_sm<double>(team,
                                                  k2::kernel_of<double, false>)
             : k2::Teams::blocks_per_sm<float>(team,
                                                 k2::kernel_of<float, false>);
}

// Load every instantiation, timed and untimed (Ladder::load).
int k2_load() {
  return k2::Teams::load(k2::kernel_of<float, false>,
                         k2::kernel_of<float, true>,
                         k2::kernel_of<double, false>,
                         k2::kernel_of<double, true>);
}
#endif

// The batch from which a launch takes MAIN_TEAM lanes per env.
int k2_crossover() { return k2::CROSSOVER; }

// The batch from which a launch takes MID_TEAM lanes per env.
int k2_mid_crossover() { return k2::MID; }

// The launch shape for B envs: lanes per env, envs per block and dynamic
// shared memory per block for float (f64 = 0) or double (f64 = 1).
void k2_launch_config(int f64, int B, int* team, int* envs, int* smem) {
  k2::Teams::launch_config(f64, B, team, envs, smem);
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
  return k2::count_ops(qpos, qvel, ws, ctrl, qpos_out, qvel_out, ws_out, p,
                       newton_iters, ls_iters, frame_skip,
                       coupled_factorizations, nullptr);
}

// The same, and `sections` receives the operations of each section of the
// chain, the rows and the coupled Newton steps (robot_common.cuh's
// counters but LAUNCHES).
long long k2_count_ops_sections(const double* qpos, const double* qvel,
                                const double* ws, const double* ctrl,
                                double* qpos_out, double* qvel_out,
                                double* ws_out, const k2::Params14* p,
                                int newton_iters, int ls_iters,
                                int frame_skip,
                                long long* coupled_factorizations,
                                long long* sections) {
  return k2::count_ops(qpos, qvel, ws, ctrl, qpos_out, qvel_out, ws_out, p,
                       newton_iters, ls_iters, frame_skip,
                       coupled_factorizations, sections);
}

}  // extern "C"
