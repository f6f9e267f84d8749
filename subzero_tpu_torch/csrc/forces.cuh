// Per-row arithmetic of the force law (B4): the contact forces of the step's
// two contact lists and the fuse / remove marking of its candidate rows.
//
// The same math, in the same operation order within every term, as the plain
// PyTorch version subzero_tpu_torch/physics/collisions.py (_force_law_plain:
// the overlap totals and the fuse / remove marking, _fast_regions and
// _region_forces; the reference's is subzero_tpu/physics/collisions.py
// :_region_forces).  Each PyTorch operation rounds once, and a Python scalar
// is cast to the working type T before the operation that takes it, so every
// line below is one PyTorch operation on values of type T.  One difference
// between PyTorch's two builds is kept: a tensor divided by a Python scalar
// (min_area's "/ 1.75") is a multiplication by the scalar's reciprocal on
// CUDA and a division on the CPU (``card_div``).
//
// Work items, each independent of every other (no item reads what another
// writes, so any order of them gives the same bits):
//   * candidate row k of the narrow phase's list (R = 1 region: B1's
//     two-crossing result): its overlap total, the fuse / remove marks, and
//     its contact force.  A row the slow clip took (cnt > 0 and not ok)
//     finds its slow row by a binary search of the slow selection (ascending,
//     padded with PC), for the slow total and largest slow region that the
//     plain version writes into the row;
//   * region r of slow row s (R = the slow clip's CAP regions, B2's result):
//     its contact force, with the pair's on-flag from the same marking of the
//     candidate row it came from; region 0 also writes the row's centroids
//     and floe flag, which the contact sums read.
// Everything is read in place: the floe pool's arrays, the Q pool's table
// (collisions._q_table), the candidate list, B1's packed rows and B2's
// regions.  The CUDA kernel (forces.cu) gives a thread to an item, the CPU
// shim (forces_host.cpp, built by g++ for the CPU tests) runs the items one
// after another.  Build both without floating-point contraction (nvcc
// --fmad=false, g++ -ffp-contract=off).
#pragma once

#include <math.h>

#ifndef SZ_HD
#ifdef __CUDACC__
#define SZ_HD __host__ __device__ __forceinline__
#else
#define SZ_HD inline
#endif
#endif

namespace sz {
namespace forces {

// columns of the Q pool's table (collisions._q_table)
enum QCol { kQn = 0, kQu, kQv, kQxi, kQcx, kQcy, kQh, kQarea, kQrmax, kQCols };
// floats of a row of B1's packed output (two_cross.cuh:OutSlot)
enum TcSlot { kContain = 0, kArea, kCx, kCy, kAx, kAy, kBx, kBy, kPnx, kPny, kTcFloats };
// walls, as core/domain.py numbers them (and the columns of vals)
enum Wall { kNorth = 0, kSouth, kEast, kWest };

// Everything a launch reads and writes.  Pointers first, then the law's
// scalars, then the sizes; the Python binding (physics/forces.py) mirrors
// this layout with ctypes.
template <typename T>
struct Args {
  // floe pool [N] (centroid [N, 2])
  const T* area;
  const T* height;
  const int* nverts;
  const T* centroid;
  const T* u;
  const T* v;
  const T* xi;
  const T* q_table;  // [NQ, kQCols]
  const T* vals;     // [4] wall coordinates, N S E W
  // the candidate list [PC]
  const long long* qi;
  const long long* qj;
  const T* shift;  // [PC, 2]
  const unsigned char* valid;
  // B1's rows: [PC, kTcFloats] floats, counts, ok flags
  const T* tc;
  const int* tc_cnt;
  const unsigned char* tc_ok;
  // the slow selection [S] (a row of the list, PC where unused) and the slow
  // rows' own P floe, Q slot and shift
  const long long* ssel;
  const long long* si;
  const long long* sj;
  const T* sshift;  // [S, 2]
  // B2's regions: [S] totals, [S, R] (points [S, R, 2]) fields
  const T* s_total;
  const T* s_area;
  const T* s_centroid;
  const int* s_n_cross;
  const T* s_chord_a;
  const T* s_chord_b;
  const T* s_p_norm;
  const T* s_p_len;
  const int* s_p_cnt;
  const int* s_q_cnt;
  const unsigned char* s_valid;
  // outputs: candidate rows [PC] (force [PC, 2])
  T* f_force;
  T* f_rec;
  unsigned char* is_ff;
  unsigned char* fuse;
  unsigned char* dom_remove;
  // outputs: slow rows (force [S, R, 2], rec [S, R], centroids [S, 2])
  T* s_force;
  T* s_rec;
  T* s_cent_i;
  T* s_cent_j;
  unsigned char* s_is_floe;
  // the law: E, G = E / (2 (1 + nu)), mu and -mu, dt, and the fuse and
  // domain-remove overlap fractions, each a Python float cast to T
  T E, G, mu, neg_mu, dt, ff_max, fd_max;
  int N;        // floe pool capacity: Q slots below N are floes
  int PC;       // candidate rows
  int S;        // slow rows
  int R;        // regions a slow row (the slow clip's CAP)
  int marking;  // 1: the step's marking gates the pairs; 0: pair_interactions'
};

// ---- PyTorch's elementwise operations ---------------------------------------

SZ_HD float t_sqrt(float x) { return sqrtf(x); }
SZ_HD double t_sqrt(double x) { return sqrt(x); }
SZ_HD float t_abs(float x) { return fabsf(x); }
SZ_HD double t_abs(double x) { return fabs(x); }

// torch.minimum / torch.maximum: a NaN in either wins
template <typename T>
SZ_HD T t_min(T a, T b) { return a != a ? a : (b != b ? b : (a < b ? a : b)); }
template <typename T>
SZ_HD T t_max(T a, T b) { return a != a ? a : (b != b ? b : (a > b ? a : b)); }

// torch.clamp(x, min=lo): NaN stays NaN
template <typename T>
SZ_HD T t_clamp_min(T x, T lo) { return x != x ? x : (x < lo ? lo : x); }

// torch.sign (0 for 0 and NaN)
template <typename T>
SZ_HD T t_sign(T x) { return T(int(T(0) < x) - int(x < T(0))); }

// x * flag, a bool tensor promoted to T
template <typename T>
SZ_HD T t_mask(T x, bool on) { return x * (on ? T(1) : T(0)); }

// ---- one contact's inputs -----------------------------------------------------

template <typename T>
struct Sides {  // collisions._PairSides of one pair
  T area_i, h_i, nv_i, cix, ciy, u_i, v_i, xi_i;
  T n_j, u_j, v_j, xi_j, cjx, cjy, h_j, area_j;
  bool is_floe_j;
  long long wall_id_j;
};

template <typename T>
SZ_HD Sides<T> load_sides(const Args<T>& a, long long i, long long j) {
  const T* q = a.q_table + j * kQCols;
  Sides<T> s;
  s.area_i = a.area[i];
  s.h_i = a.height[i];
  s.nv_i = T(a.nverts[i]);
  s.cix = a.centroid[2 * i];
  s.ciy = a.centroid[2 * i + 1];
  s.u_i = a.u[i];
  s.v_i = a.v[i];
  s.xi_i = a.xi[i];
  s.n_j = q[kQn];
  s.u_j = q[kQu];
  s.v_j = q[kQv];
  s.xi_j = q[kQxi];
  s.cjx = q[kQcx];
  s.cjy = q[kQcy];
  s.h_j = q[kQh];
  s.area_j = q[kQarea];
  s.is_floe_j = j < a.N;
  s.wall_id_j = j - a.N;
  return s;
}

template <typename T>
struct Region {  // one region of clip.ClipRegions
  T area, cx, cy, ax, ay, bx, by, pnx, pny, p_len;
  int n_cross, p_cnt, q_cnt;
  bool valid;
};

// ---- the force law (collisions._region_forces) -------------------------------

// the pair's force factor (collisions.jl:371-379, 528)
template <typename T>
SZ_HD T force_factor(const Sides<T>& s, T E) {
  const T hi = s.h_i;
  const T ri = t_sqrt(s.area_i);
  const T hj = s.h_j;
  const T rj = t_sqrt(s.is_floe_j ? s.area_j : T(1));
  const T den_big = t_min(ri, rj);
  const T ff_big = (E * t_min(hi, hj)) / (den_big > T(0) ? den_big : T(1));
  const T den_std = hi * rj + hj * ri;
  const T ff_std = (E * (hi * hj)) / (den_std > T(0) ? den_std : T(1));
  const T ff_floe = (ri > T(1e5) || rj > T(1e5)) ? ff_big : ff_std;
  const T ff_dom = (E * hi) / (ri > T(0) ? ri : T(1));
  return s.is_floe_j ? ff_floe : ff_dom;
}

// the region min-area gate (calc_elastic_forces, collisions.jl:158-169):
// min(nv_i, n_j) * 100.0 / 1.75
template <typename T>
SZ_HD T min_area(const Sides<T>& s, bool card_div) {
  const T m = t_min(s.nv_i, s.n_j) * T(100);
  return card_div ? m * (T(1) / T(1.75)) : m / T(1.75);
}

template <typename T>
struct Force {
  T fx, fy, rec;
};

// One region's Hopkins elastic + Coulomb friction force and its overlap
// record, given the pair's force factor and min-area gate.
template <typename T>
SZ_HD Force<T> region_force(const Args<T>& a, const Sides<T>& s, T shx, T shy,
                            const Region<T>& r, bool pair_on, T ff, T min_a) {
  const bool reg_ok = r.valid && (r.area >= min_a) && pair_on;

  const T chx = r.bx - r.ax;
  const T chy = r.by - r.ay;
  const T chord_len = t_sqrt(chx * chx + chy * chy);
  const bool two_pts = r.n_cross == 2;
  // 2 crossings: perpendicular to the chord, aligned with the P-chain normal
  const T perpx = -chy;
  const T perpy = chx;
  T sgn = t_sign(perpx * r.pnx + perpy * r.pny);
  sgn = sgn == T(0) ? T(1) : sgn;
  const T clen = t_clamp_min(chord_len, T(1e-30));
  const T dir2x = (perpx * sgn) / clen;
  const T dir2y = (perpy * sgn) / clen;
  // many crossings (_many_intersect_normal_force!, collisions.jl:78-119)
  const T pn_norm = t_sqrt(r.pnx * r.pnx + r.pny * r.pny);
  const T pclamp = t_clamp_min(pn_norm, T(1e-30));
  const T dirMx = r.pnx / pclamp;
  const T dirMy = r.pny / pclamp;
  const T dlM = r.p_len / T(r.p_cnt < 1 ? 1 : r.p_cnt);
  const bool manyok = (r.p_cnt > 0) && (r.q_cnt > 0);

  const T dl = two_pts ? chord_len : (manyok ? dlM : T(0));
  const T fdx = two_pts ? dir2x : (manyok ? dirMx : T(0));
  const T fdy = two_pts ? dir2y : (manyok ? dirMy : T(0));
  // overlap-too-small gate (collisions.jl:51, 112)
  const bool force_on = reg_ok && (dl > T(0.1));
  const T af = r.area * ff;
  T nfx = t_mask(fdx * af, force_on);
  T nfy = t_mask(fdy * af, force_on);

  // wall normal-direction correction (boundaries.jl:37-148)
  const bool is_wall = (s.wall_id_j >= 0) && (s.wall_id_j < 4);
  const int wid = s.wall_id_j < 0 ? 0 : (s.wall_id_j > 3 ? 3 : int(s.wall_id_j));
  const T wv = a.vals[wid];
  const bool zx = (wid == kNorth && r.cy >= wv) || (wid == kSouth && r.cy <= wv);
  const bool zy = (wid == kEast && r.cx >= wv) || (wid == kWest && r.cx <= wv);
  nfx = (is_wall && zx) ? T(0) : nfx;
  nfy = (is_wall && zy) ? T(0) : nfy;

  // friction (calc_friction_forces, collisions.jl:243-283)
  const T nnorm = t_sqrt(nfx * nfx + nfy * nfy);
  const T ui = s.u_i + s.xi_i * -(r.cy - s.ciy);
  const T vi = s.v_i + s.xi_i * (r.cx - s.cix);
  const T cjsx = s.cjx + shx;  // Q's centroid, shifted
  const T cjsy = s.cjy + shy;
  const T ujp = s.u_j + s.xi_j * -(r.cy - cjsy);
  const T vjp = s.v_j + s.xi_j * (r.cx - cjsx);
  const T udiff = ui - ujp;
  const T vdiff = vi - vjp;
  const T vnorm = t_sqrt(udiff * udiff + vdiff * vdiff);
  const T vn_safe = vnorm > T(0) ? vnorm : T(1);
  const T xdir = vnorm > T(0) ? udiff / vn_safe : T(0);
  const T ydir = vnorm > T(0) ? vdiff / vn_safe : T(0);
  const T dot_dir = xdir * udiff + ydir * vdiff;
  // G * dl * dt * nnorm * dir * -dot_dir, left to right
  const T g = ((a.G * dl) * a.dt) * nnorm;
  T xfric = (g * xdir) * -dot_dir;
  T yfric = (g * ydir) * -dot_dir;
  const T fric_norm = t_sqrt(xfric * xfric + yfric * yfric);
  const bool over = fric_norm > a.mu * nnorm;
  const T cap = a.neg_mu * nnorm;
  xfric = over ? cap * xdir : xfric;
  yfric = over ? cap * ydir : yfric;
  xfric = t_mask(xfric, force_on);
  yfric = t_mask(yfric, force_on);

  Force<T> f;
  f.fx = nfx + xfric;
  f.fy = nfy + yfric;
  // interactions are recorded only when force != 0 (add_interactions!,
  // collisions.jl:288)
  const bool nonzero = force_on && ((t_abs(f.fx) + t_abs(f.fy)) > T(0));
  f.rec = nonzero ? r.area : T(0);
  return f;
}

// ---- the fuse / remove marking of a candidate row ----------------------------

struct Marks {
  bool is_ff, fuse, dom_remove;
};

// The largest valid region of slow row s (torch.amax over its R regions).
template <typename T>
SZ_HD T slow_max_region(const Args<T>& a, int s) {
  T m = -T(HUGE_VAL);
  for (int r = 0; r < a.R; ++r) {
    const long long e = static_cast<long long>(s) * a.R + r;
    m = t_max(m, a.s_valid[e] ? a.s_area[e] : T(0));
  }
  return m;
}

// Candidate row k's marks (collisions.jl:364-368, 522-525), with the slow
// total and largest slow region that the plain version puts into the row
// (zeros for a row the slow clip did not take).
template <typename T>
SZ_HD Marks mark_row(const Args<T>& a, int k, const Sides<T>& s, T put_total,
                     T put_max) {
  const T* t = a.tc + static_cast<long long>(k) * kTcFloats;
  const bool ok = a.tc_ok[k] != 0;
  const bool pvalid = a.valid[k] != 0;
  const T contain = t[kContain];
  const T fast_area = ok ? t[kArea] : T(0);
  const T total = (contain + fast_area) + put_total;
  const T area_j = s.is_floe_j ? s.area_j : T(HUGE_VAL);
  const T frac = t_max(total / s.area_i, total / area_j);
  Marks m;
  m.is_ff = s.is_floe_j && pvalid;
  m.fuse = m.is_ff && (frac > a.ff_max) && (total > T(0));
  // domain pairs: the largest single region; containment against a wall
  // counts as a full-floe region
  T max_reg = t_max(fast_area, put_max);
  max_reg = t_max(max_reg, !s.is_floe_j ? contain : T(0));
  m.dom_remove = pvalid && !s.is_floe_j && ((max_reg / s.area_i) > a.fd_max);
  return m;
}

// The slow row that took candidate row k: S where none did.  ssel is
// ascending and padded with PC.
template <typename T>
SZ_HD int slow_row_of(const Args<T>& a, int k) {
  int lo = 0, hi = a.S;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (a.ssel[mid] < k) lo = mid + 1; else hi = mid;
  }
  return (lo < a.S && a.ssel[lo] == k) ? lo : a.S;
}

// ---- the two kinds of work item ----------------------------------------------

template <typename T>
SZ_HD void candidate_row(const Args<T>& a, int k, bool card_div) {
  const Sides<T> s = load_sides(a, a.qi[k], a.qj[k]);
  const T* t = a.tc + static_cast<long long>(k) * kTcFloats;
  const bool ok = a.tc_ok[k] != 0;
  // the step: B1's ok (a row that is no candidate is not ok);
  // pair_interactions: the candidate's validity too
  const bool fast_ok = a.marking ? ok : (a.valid[k] != 0 && ok);
  bool pair_on = fast_ok;
  if (a.marking) {
    T put_total = T(0), put_max = T(0);
    if (a.tc_cnt[k] > 0 && !ok) {
      const int sr = slow_row_of(a, k);
      if (sr < a.S) {
        put_total = a.s_total[sr];
        put_max = slow_max_region(a, sr);
      }
    }
    const Marks m = mark_row(a, k, s, put_total, put_max);
    a.is_ff[k] = m.is_ff;
    a.fuse[k] = m.fuse;
    a.dom_remove[k] = m.dom_remove;
    pair_on = fast_ok && !m.fuse && !m.dom_remove;
  }
  // the row as one region (collisions._fast_regions)
  Region<T> r;
  r.area = t[kArea];
  r.cx = t[kCx];
  r.cy = t[kCy];
  r.ax = t[kAx];
  r.ay = t[kAy];
  r.bx = t[kBx];
  r.by = t[kBy];
  r.pnx = t[kPnx];
  r.pny = t[kPny];
  r.p_len = T(0);
  r.n_cross = 2;
  r.p_cnt = 0;
  r.q_cnt = 0;
  r.valid = fast_ok && (r.area > T(0));
  const Force<T> f = region_force(a, s, a.shift[2 * static_cast<long long>(k)],
                                  a.shift[2 * static_cast<long long>(k) + 1], r,
                                  pair_on, force_factor(s, a.E), min_area(s, card_div));
  a.f_force[2 * static_cast<long long>(k)] = f.fx;
  a.f_force[2 * static_cast<long long>(k) + 1] = f.fy;
  a.f_rec[k] = f.rec;
}

template <typename T>
SZ_HD void slow_region(const Args<T>& a, int s, int r, bool card_div) {
  const long long k = a.ssel[s];
  const bool svalid = k < a.PC;
  const T total = svalid ? a.s_total[s] : T(0);
  const long long i = a.si[s], j = a.sj[s];
  const Sides<T> sd = load_sides(a, i, j);
  bool pair_on;
  if (a.marking) {
    pair_on = false;
    if (svalid) {  // the candidate row's marks, as candidate_row makes them
      const Marks m = mark_row(a, static_cast<int>(k), sd, total,
                               slow_max_region(a, s));
      pair_on = !m.fuse && !m.dom_remove && (total > T(0));
    }
  } else {
    pair_on = svalid && (a.s_total[s] > T(0));
  }
  const long long e = static_cast<long long>(s) * a.R + r;
  Region<T> g;
  g.area = a.s_area[e];
  g.cx = a.s_centroid[2 * e];
  g.cy = a.s_centroid[2 * e + 1];
  g.ax = a.s_chord_a[2 * e];
  g.ay = a.s_chord_a[2 * e + 1];
  g.bx = a.s_chord_b[2 * e];
  g.by = a.s_chord_b[2 * e + 1];
  g.pnx = a.s_p_norm[2 * e];
  g.pny = a.s_p_norm[2 * e + 1];
  g.p_len = a.s_p_len[e];
  g.n_cross = a.s_n_cross[e];
  g.p_cnt = a.s_p_cnt[e];
  g.q_cnt = a.s_q_cnt[e];
  g.valid = a.s_valid[e] != 0;
  const Force<T> f = region_force(a, sd, a.sshift[2 * s], a.sshift[2 * s + 1], g,
                                  pair_on, force_factor(sd, a.E), min_area(sd, card_div));
  a.s_force[2 * e] = f.fx;
  a.s_force[2 * e + 1] = f.fy;
  a.s_rec[e] = f.rec;
  if (r == 0) {  // the sides the contact sums read
    a.s_cent_i[2 * s] = sd.cix;
    a.s_cent_i[2 * s + 1] = sd.ciy;
    a.s_cent_j[2 * s] = sd.cjx;
    a.s_cent_j[2 * s + 1] = sd.cjy;
    a.s_is_floe[s] = sd.is_floe_j;
  }
}

// Work item t of a launch: candidate rows first, then slow (row, region).
template <typename T>
SZ_HD void work_item(const Args<T>& a, long long t, bool card_div) {
  if (t < a.PC) {
    candidate_row(a, static_cast<int>(t), card_div);
  } else {
    const long long u = t - a.PC;
    if (u < static_cast<long long>(a.S) * a.R)
      slow_region(a, static_cast<int>(u / a.R), static_cast<int>(u % a.R), card_div);
  }
}

template <typename T>
SZ_HD long long work_items(const Args<T>& a) {
  return a.PC + static_cast<long long>(a.S) * a.R;
}

}  // namespace forces
}  // namespace sz
