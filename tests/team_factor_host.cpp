// The team factorization of the Newton step (robot_common.cuh's
// team_factor_solve) run on the host: a team of G lanes as G threads, each
// shuffle between two barriers, against the serial code that a team of one
// lane runs (factor_solve_split, or chol_factor_by and chol_solve on the
// coupled 14 x 14), bit for bit, on every lane.
//
//     team_factor NV G float|double [TRIALS]
//
// Per trial: an SPD H in team_solve's form (Mr's rows 0-7, the block's mb
// and Ib, the H scratch's lower triangle) and a right-hand side, split
// (rows 8.. not coupled to rows 0-7; those scratch entries hold NaN, which
// neither code may read) and, for NV = 14, coupled. Prints the cases run and
// the entries of `step` that differ, on any lane; exits 1 if any does.

#include <barrier>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include "robot_common.cuh"

using namespace brt;

struct Shuffles {
  std::barrier<> bar;
  double slot[32];
  explicit Shuffles(int g) : bar(g) {}
};

// Team's bcast across threads, one thread per lane.
template <int G_>
struct ThreadTeam {
  static constexpr int G = G_;
  int lane;
  Shuffles* sh;
  template <typename T>
  T bcast(T v, int src) const {
    sh->slot[lane] = double(v);
    sh->bar.arrive_and_wait();
    const T out = T(sh->slot[src]);
    sh->bar.arrive_and_wait();
    return out;
  }
};

// TeamRows' H scratch alone (lower triangle row by row, then g).
template <typename T, int NV>
struct Scratch {
  static constexpr int NE = NV * (NV + 1) / 2;
  T* base;
  T& H(int e) const {
    if (e < 0 || e >= NE + NV) {
      std::printf("H(%d) out of range\n", e);
      std::abort();
    }
    return base[e];
  }
};

template <typename T>
bool same_bits(T a, T b) { return std::memcmp(&a, &b, sizeof(T)) == 0; }

template <typename T, int NV, int G>
int trial(std::mt19937_64& rng, bool split) {
  constexpr int NE = NV * (NV + 1) / 2;
  std::normal_distribution<double> normal;
  double A[NV][NV], Bm[NV][NV];
  for (int i = 0; i < NV; ++i)
    for (int j = 0; j < NV; ++j)
      Bm[i][j] = split && (i < 8) != (j < 8) ? 0.0 : normal(rng);
  for (int i = 0; i < NV; ++i)
    for (int j = 0; j < NV; ++j) {
      double s = i == j ? NV : 0.0;
      for (int k = 0; k < NV; ++k) s += Bm[i][k] * Bm[j][k];
      A[i][j] = s;
    }
  T Mr[8][8];
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j)
      Mr[i][j] = T(i == j ? 1.0 + std::fabs(normal(rng)) : 0.3 * normal(rng));
  const T mb = T(0.064), Ib = T(1.7e-5);
  std::vector<T> buf(NE + NV);
  for (int r = 0; r < NV; ++r)
    for (int c = 0; c <= r; ++c)
      buf[r * (r + 1) / 2 + c] = split && r >= 8 && c < 8 ? T(NAN)
                                                          : T(A[r][c]);
  T ng[NV];
  for (int r = 0; r < NV; ++r) ng[r] = buf[NE + r] = T(normal(rng));

  // the serial code, as team_solve's team of one lane runs it
  const auto H = [&](int r, int c) {
    const T h = buf[r * (r + 1) / 2 + c];
    if (r < 8) return Mr[r][c] + h;
    return r == c ? (r < 11 ? mb : Ib) + h : h;
  };
  T ref[NV];
  if (split) {
    factor_solve_split<T, NV>(H, ng, ref);
  } else {
    T L[NV][NV];
    chol_factor_by<T, NV>(H, L);
    chol_solve<T, NV>(L, ng, ref);
  }

  Shuffles sh(G);
  const Scratch<T, NV> rw{buf.data()};
  std::vector<std::vector<T>> step(G, std::vector<T>(NV));
  std::vector<std::thread> lanes;
  for (int l = 0; l < G; ++l)
    lanes.emplace_back([&, l] {
      const ThreadTeam<G> tm{l, &sh};
      team_factor_solve<T, NV>(tm, rw, Mr, mb, Ib, ng, split,
                               step[l].data());
    });
  for (auto& t : lanes) t.join();
  int differ = 0;
  for (int l = 0; l < G; ++l)
    for (int j = 0; j < NV; ++j)
      if (!same_bits(step[l][j], ref[j])) {
        if (differ < 4)
          std::printf("lane %d step[%d] %.17g, serial %.17g (split %d)\n", l,
                      j, double(step[l][j]), double(ref[j]), int(split));
        ++differ;
      }
  return differ;
}

template <typename T, int NV, int G>
int run(int trials) {
  std::mt19937_64 rng(NV * 1000 + G * 10 + int(sizeof(T)));
  int differ = 0, cases = 0;
  for (int n = 0; n < trials; ++n)
    for (int split = NV == 8; split < 2; ++split, ++cases)
      differ += trial<T, NV, G>(rng, split != 0);
  std::printf("%d cases, %d entries differ\n", cases, differ);
  return differ != 0;
}

template <typename T>
int dispatch(int nv, int g, int trials) {
  if (nv == 14 && g == 32) return run<T, 14, 32>(trials);
  if (nv == 14 && g == 16) return run<T, 14, 16>(trials);
  if (nv == 14 && g == 8) return run<T, 14, 8>(trials);
  if (nv == 8 && g == 32) return run<T, 8, 32>(trials);
  if (nv == 8 && g == 8) return run<T, 8, 8>(trials);
  std::printf("no team of %d lanes for %d dofs here\n", g, nv);
  return 2;
}

int main(int argc, char** argv) {
  if (argc < 4) {
    std::printf("usage: %s NV G float|double [TRIALS]\n", argv[0]);
    return 2;
  }
  const int nv = std::atoi(argv[1]), g = std::atoi(argv[2]);
  const int trials = argc > 4 ? std::atoi(argv[4]) : 40;
  return std::string(argv[3]) == "float" ? dispatch<float>(nv, g, trials)
                                         : dispatch<double>(nv, g, trials);
}
