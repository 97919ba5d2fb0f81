// Box-box and box-cylinder colliders, in the per-thread scalar form the
// fused kernels use. Counterparts of box_box_scalar / box_cylinder_scalar in
// balance_robot_tpu/physics/pallas_block.py; the array form is
// balance_robot_tpu_torch/physics/box_collisions.py, and both must make the
// same discrete choices (first index wins every tie; `>=` where marked).
//
// Box-box: SAT over 6 face and 9 edge axes; face axes are preferred unless
// an edge axis beats the best face separation by 5%. Face case: a fixed set
// of 24 manifold candidates (4 incident-face corners, 4 reference corners
// projected onto the incident face, 16 edge-pair intersections), of which
// the penetrating ones are kept, capped to the deepest 8. Edge case: one
// closest-point contact. Only contacts that are included are written, so a
// caller gets at most 8 of them, all sharing one frame. A TPU lane computes
// both reference choices and all 25 records and masks; a thread branches on
// the reference box and returns early when the boxes are separated, which
// changes no included contact.
//
// Box-cylinder: 3 candidates (segment centre and both cap ends), each with
// its own frame. Frames follow mju_makeFrame.

#pragma once

#include "robot_common.cuh"

namespace brt {

// mju_makeFrame: helper = y when |n_y| < 0.5 else z
template <typename T>
BRT_HD void make_frame(const T n[3], T t1[3], T t2[3]) {
  bool use_y = Abs(n[1]) < T(0.5);
  T h[3] = {T(0.0), use_y ? T(1.0) : T(0.0), use_y ? T(0.0) : T(1.0)};
  T d = dot3(n, h);
  for (int k = 0; k < 3; ++k) t1[k] = h[k] - n[k] * d;
  T t1n = Sqrt(dot3(t1, t1));
  T inv = T(1.0) / Max(t1n, T(1e-15));
  for (int k = 0; k < 3; ++k) t1[k] = t1[k] * inv;
  cross(n, t1, t2);
}

// index of the largest of 3 values, the first winning ties
template <typename T>
BRT_HD int argmax3(const T v[3]) {
  if (v[0] >= v[1]) return v[0] >= v[2] ? 0 : 2;
  return v[1] >= v[2] ? 1 : 2;
}

// The 24 face-manifold candidates in the reference box's local frame.
// aref / ainc: the boxes' axes as rows; axis: the reference face axis;
// dref: the incident centre along the reference axes (world d projected);
// inward: +1 when the reference is box 1, -1 when it is box 2.
// Writes world points, depths and validity; returns nsign.
template <typename T>
BRT_HD T face_manifold(const T cref[3], const T aref[3][3],
                       const T halfref[3], const T cinc[3],
                       const T ainc[3][3], const T halfinc[3], int axis,
                       const T dref[3], T inward, T world[24][3],
                       T depth[24], bool ok[24]) {
  T nsign = dref[axis] >= T(0.0) ? inward : -inward;
  T dc[3], dloc[3], Aloc[3][3];
  for (int k = 0; k < 3; ++k) dc[k] = cinc[k] - cref[k];
  for (int i = 0; i < 3; ++i) {
    dloc[i] = dot3(aref[i], dc);
    for (int j = 0; j < 3; ++j) Aloc[i][j] = dot3(aref[i], ainc[j]);
  }
  T dots[3], absd[3];
  for (int j = 0; j < 3; ++j) {
    dots[j] = nsign * Aloc[axis][j];
    absd[j] = Abs(dots[j]);
  }
  const int jj = argmax3(absd);
  T sgn_inc = dots[jj] >= T(0.0) ? T(-1.0) : T(1.0);
  const int p1 = (jj + 1) % 3, p2 = (jj + 2) % 3;
  T ctr[3], u[3], v[3];
  for (int k = 0; k < 3; ++k) {
    ctr[k] = dloc[k] + sgn_inc * (halfinc[jj] * Aloc[k][jj]);
    u[k] = halfinc[p1] * Aloc[k][p1];
    v[k] = halfinc[p2] * Aloc[k][p2];
  }
  T quad[4][3];
  for (int k = 0; k < 3; ++k) {
    quad[0][k] = (ctr[k] + u[k]) + v[k];
    quad[1][k] = (ctr[k] - u[k]) + v[k];
    quad[2][k] = (ctr[k] - u[k]) - v[k];
    quad[3][k] = (ctr[k] + u[k]) - v[k];
  }
  const int t1i = axis == 0 ? 1 : 0;
  const int t2i = axis == 2 ? 1 : 2;
  const T h_t1 = halfref[t1i], h_t2 = halfref[t2i], href = halfref[axis];
  T cand[24][3];

  // 1: incident-face corners inside the reference rectangle
  for (int c = 0; c < 4; ++c) {
    for (int k = 0; k < 3; ++k) cand[c][k] = quad[c][k];
    ok[c] = Abs(quad[c][t1i]) <= h_t1 && Abs(quad[c][t2i]) <= h_t2;
  }
  // 2: reference corners projected along nref onto the incident plane
  const T s1s[4] = {T(1.0), T(-1.0), T(-1.0), T(1.0)};
  const T s2s[4] = {T(1.0), T(1.0), T(-1.0), T(-1.0)};
  {
    T m[3], nref[3];
    cross(u, v, m);
    T mn = Sqrt(dot3(m, m));
    T minv = T(1.0) / Max(mn, T(1e-15));
    for (int k = 0; k < 3; ++k) {
      m[k] = m[k] * minv;
      nref[k] = k == axis ? nsign : T(0.0);
    }
    T denom = dot3(nref, m);
    if (Abs(denom) < T(1e-12)) denom = T(1e-12);
    T uu = Max(dot3(u, u), T(1e-15));
    T vv = Max(dot3(v, v), T(1e-15));
    for (int c = 0; c < 4; ++c) {
      T rect[3], diff[3], relp[3];
      for (int k = 0; k < 3; ++k) {
        rect[k] = (k == t1i ? s1s[c] * h_t1 : T(0.0)) +
                  (k == t2i ? s2s[c] * h_t2 : T(0.0));
        diff[k] = ctr[k] - rect[k];
      }
      T t = dot3(diff, m) / denom;
      for (int k = 0; k < 3; ++k) {
        cand[4 + c][k] = rect[k] + nref[k] * t;
        relp[k] = cand[4 + c][k] - ctr[k];
      }
      T cu = dot3(relp, u) / uu;
      T cv = dot3(relp, v) / vv;
      ok[4 + c] = Abs(cu) <= T(1.0) && Abs(cv) <= T(1.0);
    }
  }
  // 3: 16 edge-pair intersections in the reference face's tangent plane
  for (int ia = 0; ia < 4; ++ia) {
    const int ia1 = (ia + 1) % 4;
    T a0[2] = {quad[ia][t1i], quad[ia][t2i]};
    T r2d[2] = {quad[ia1][t1i] - a0[0], quad[ia1][t2i] - a0[1]};
    for (int ib = 0; ib < 4; ++ib) {
      const int ib1 = (ib + 1) % 4;
      T b0[2] = {s1s[ib] * h_t1, s2s[ib] * h_t2};
      T s2d[2] = {s1s[ib1] * h_t1 - b0[0], s2s[ib1] * h_t2 - b0[1]};
      T qp[2] = {b0[0] - a0[0], b0[1] - a0[1]};
      T rxs = r2d[0] * s2d[1] - r2d[1] * s2d[0];
      bool tiny = Abs(rxs) < T(1e-14);
      T rxs_s = tiny ? T(1e-14) : rxs;
      T tt = (qp[0] * s2d[1] - qp[1] * s2d[0]) / rxs_s;
      T uu2 = (qp[0] * r2d[1] - qp[1] * r2d[0]) / rxs_s;
      const int c = 8 + 4 * ia + ib;
      ok[c] = Abs(rxs) > T(1e-14) && tt >= T(0.0) && tt <= T(1.0) &&
              uu2 >= T(0.0) && uu2 <= T(1.0);
      for (int k = 0; k < 3; ++k)
        cand[c][k] = quad[ia][k] + tt * (quad[ia1][k] - quad[ia][k]);
    }
  }
  for (int c = 0; c < 24; ++c) {
    depth[c] = nsign * cand[c][axis] - href;
    for (int k = 0; k < 3; ++k)
      world[c][k] = cref[k] + (aref[0][k] * cand[c][0] +
                               aref[1][k] * cand[c][1] +
                               aref[2][k] * cand[c][2]);
  }
  return nsign;
}

// Contacts of box 1 (c1, R1 with columns = axes, half1) and box 2, closer
// than `margin`. Writes the included contacts' midpoints and distances and
// their common frame (normal from box 1 to box 2); returns their number,
// at most 8.
template <typename T>
BRT_HD int box_box(const T c1[3], const T R1[3][3], const T half1[3],
                   const T c2[3], const T R2[3][3], const T half2[3],
                   T margin, T pos[8][3], T dist[8], T n[3], T t1[3],
                   T t2[3]) {
  T a1[3][3], a2[3][3], d[3], dp[3], dq[3], C[3][3];
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) {
      a1[i][k] = R1[k][i];
      a2[i][k] = R2[k][i];
    }
  for (int k = 0; k < 3; ++k) d[k] = c2[k] - c1[k];
  for (int i = 0; i < 3; ++i) {
    dp[i] = dot3(a1[i], d);
    dq[i] = dot3(a2[i], d);
    for (int j = 0; j < 3; ++j) C[i][j] = dot3(a1[i], a2[j]);
  }
  T sep[15];
  for (int i = 0; i < 3; ++i) {
    sep[i] = Abs(dp[i]) - half1[i] -
             (Abs(C[i][0]) * half2[0] + Abs(C[i][1]) * half2[1] +
              Abs(C[i][2]) * half2[2]);
    sep[3 + i] = Abs(dq[i]) - half2[i] -
                 (Abs(C[0][i]) * half1[0] + Abs(C[1][i]) * half1[1] +
                  Abs(C[2][i]) * half1[2]);
  }
  // 9 edge axes a1_i x a2_j; a degenerate (parallel) pair never separates
  T edge_ax[9][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      T* ax = edge_ax[3 * i + j];
      cross(a1[i], a2[j], ax);
      T ln = Sqrt(dot3(ax, ax));
      bool ok = ln > T(1e-9);
      T inv = T(1.0) / Max(ln, T(1e-9));
      for (int k = 0; k < 3; ++k) ax[k] = ax[k] * inv;
      T s = dot3(ax, d);
      T sg = s >= T(0.0) ? T(1.0) : T(-1.0);
      for (int k = 0; k < 3; ++k) ax[k] = ax[k] * sg;
      T r1 = Abs(dot3(ax, a1[0])) * half1[0] +
             Abs(dot3(ax, a1[1])) * half1[1] +
             Abs(dot3(ax, a1[2])) * half1[2];
      T r2 = Abs(dot3(ax, a2[0])) * half2[0] +
             Abs(dot3(ax, a2[1])) * half2[1] +
             Abs(dot3(ax, a2[2])) * half2[2];
      sep[6 + 3 * i + j] = ok ? Abs(s) - r1 - r2 : T(-INFINITY);
    }
  // first maximum among the faces and among the edges
  int face_idx = 0, edge_idx = 0;
  for (int i = 1; i < 6; ++i)
    if (sep[i] > sep[face_idx]) face_idx = i;
  for (int i = 1; i < 9; ++i)
    if (sep[6 + i] > sep[6 + edge_idx]) edge_idx = i;
  const T face_sep = sep[face_idx], edge_sep = sep[6 + edge_idx];
  const T max_sep = face_sep < edge_sep ? edge_sep : face_sep;
  if (max_sep >= margin) return 0;                       // separated
  const bool use_edge =
      edge_sep > face_sep + T(0.05) * Abs(face_sep) + T(1e-14);

  if (!use_edge) {
    T world[24][3], depth[24];
    bool ok[24];
    const bool ref1 = face_idx < 3;
    const int axis = ref1 ? face_idx : face_idx - 3;
    if (ref1) {
      T ns = face_manifold(c1, a1, half1, c2, a2, half2, axis, dp, T(1.0),
                           world, depth, ok);
      for (int k = 0; k < 3; ++k) n[k] = ns * a1[axis][k];
    } else {
      T ns = face_manifold(c2, a2, half2, c1, a1, half1, axis, dq, T(-1.0),
                           world, depth, ok);
      for (int k = 0; k < 3; ++k) n[k] = -ns * a2[axis][k];
    }
    make_frame(n, t1, t2);
    // the deepest 8 penetrating candidates, by pairwise rank over keys
    // that are +inf where a candidate is out (ties: the earlier index)
    T key[24];
    for (int c = 0; c < 24; ++c) {
      ok[c] = ok[c] && depth[c] < margin;
      key[c] = ok[c] ? depth[c] : T(INFINITY);
    }
    int cnt = 0;
    for (int c = 0; c < 24; ++c) {
      if (!ok[c]) continue;
      int rank = 0;
      for (int j = 0; j < 24; ++j)
        if (j != c && (key[j] < key[c] || (key[j] == key[c] && j < c)))
          ++rank;
      if (rank < 8) {
        T half_d = T(0.5) * depth[c];
        for (int k = 0; k < 3; ++k)
          pos[cnt][k] = world[c][k] - n[k] * half_d;
        dist[cnt] = depth[c];
        ++cnt;
      }
    }
    return cnt;
  }

  // edge-edge: closest points of the two supporting edges
  if (!(edge_sep < margin)) return 0;
  const int ei = edge_idx / 3, ej = edge_idx % 3;
  const T* axe = edge_ax[edge_idx];
  T p1e[3], p2e[3], r12[3];
  for (int k = 0; k < 3; ++k) {
    p1e[k] = c1[k];
    p2e[k] = c2[k];
  }
  for (int i = 0; i < 3; ++i) {
    T sk = dot3(a1[i], axe) >= T(0.0) ? T(1.0) : T(-1.0);
    T w = (i == ei ? T(0.0) : T(1.0)) * sk * half1[i];
    for (int k = 0; k < 3; ++k) p1e[k] = p1e[k] + a1[i][k] * w;
  }
  for (int i = 0; i < 3; ++i) {
    T sk = dot3(a2[i], axe) >= T(0.0) ? T(-1.0) : T(1.0);
    T w = (i == ej ? T(0.0) : T(1.0)) * sk * half2[i];
    for (int k = 0; k < 3; ++k) p2e[k] = p2e[k] + a2[i][k] * w;
  }
  for (int k = 0; k < 3; ++k) r12[k] = p2e[k] - p1e[k];
  const T* a1v = a1[ei];
  const T* a2v = a2[ej];
  T a12 = dot3(a1v, a2v);
  T den = T(1.0) - a12 * a12;
  if (Abs(den) < T(1e-12)) den = T(1e-12);
  T ra1 = dot3(r12, a1v), ra2 = dot3(r12, a2v);
  T tpar = (ra1 - a12 * ra2) / den;
  T upar = (a12 * ra1 - ra2) / den;
  for (int k = 0; k < 3; ++k) {
    pos[0][k] = ((p1e[k] + a1v[k] * tpar) + (p2e[k] + a2v[k] * upar)) *
                T(0.5);
    n[k] = axe[k];
  }
  dist[0] = edge_sep;
  make_frame(n, t1, t2);
  return 1;
}

// Contacts of a box with a cylinder (centre, unit axis, radius r,
// half-length h): 3 candidates with the normal from the cylinder to the
// box; a sample point inside the box has no normal and is left out.
template <typename T>
BRT_HD void box_cylinder(const T cbox[3], const T Rbox[3][3],
                         const T half[3], const T ccyl[3], const T axis[3],
                         T r, T h, T margin, T pos[3][3], T dist[3],
                         bool inc[3], T nrm[3][3]) {
  const T ts[3] = {T(0.0), T(-1.0), T(1.0)};
  for (int c = 0; c < 3; ++c) {
    T pc[3], rel[3], delta[3];
    for (int k = 0; k < 3; ++k) {
      pc[k] = ccyl[k] + axis[k] * (ts[c] * h);
      rel[k] = pc[k] - cbox[k];
    }
    for (int j = 0; j < 3; ++j) {
      T lp = Rbox[0][j] * rel[0] + Rbox[1][j] * rel[1] + Rbox[2][j] * rel[2];
      delta[j] = lp - Clip(lp, -half[j], half[j]);
    }
    T dl = Sqrt(dot3(delta, delta));
    bool outside = dl > T(1e-12);
    T inv = T(1.0) / Max(dl, T(1e-12));
    T n[3];
    for (int k = 0; k < 3; ++k)
      n[k] = (Rbox[k][0] * (delta[0] * inv) + Rbox[k][1] * (delta[1] * inv) +
              Rbox[k][2] * (delta[2] * inv)) * T(-1.0);
    T ca = dot3(n, axis);
    T perp = Sqrt(Max(T(1.0) - ca * ca, T(0.0)));
    T support = r * perp;
    T dd = outside ? dl - support : -support - dl;
    for (int k = 0; k < 3; ++k) {
      T surf = pc[k] + n[k] * support;
      pos[c][k] = surf - n[k] * (T(0.5) * dd);
      nrm[c][k] = n[k];
    }
    dist[c] = dd;
    inc[c] = dd < margin && outside;
  }
}

}  // namespace brt
