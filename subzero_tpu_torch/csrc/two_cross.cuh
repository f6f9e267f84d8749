// Per-term arithmetic of the two-crossing narrow phase.
//
// The same math, in the same operation order within every term, as the plain
// PyTorch version subzero_tpu_torch/geometry/clip.py:two_cross_pairs (its
// core is two_cross_pass; the reference's is
// subzero_tpu/geometry/clip.py:two_cross_pass).  For one candidate pair
// (floe i of the P pool, slot j of the Q pool):
//   1. the Q ring is moved to P's periodic image (+ shift) and then offset
//      by (0.618..., 1) * pert, each add rounded on its own (q_coord);
//   2. every P edge is tested against every Q edge for a proper crossing
//      (0 < t, u < 1 with eps = 1e-12 in the working type; edge_crossing);
//   3. crossings are counted, and the entering / exiting crossing points
//      with their edge indices and t/u parameters are summed (CrossSums);
//   4. pairs with exactly 2 crossings and 1 entry chain shoelace and first
//      moment integrals along both rings (enter -> exit along P, exit ->
//      enter along Q; chain_*) to the overlap area and centroid, kept only
//      inside the sliver gate -sliver * A_max < S <= A_max (finish);
//   5. 0-crossing pairs get the containment area (crossing-number
//      point-in-polygon of each ring's first vertex in the other ring;
//      pip_hit).
//
// This header holds one term of each sum and the final combine, and says
// nothing about who sums them.  The CUDA kernel (two_cross.cu) gives a warp
// to a pair and combines the terms across its lanes; the CPU shim
// (two_cross_host.cpp, built by g++ for the CPU tests) combines the same
// functions serially.  Both fold crossings in (i, j) order, i outer, and
// every ring sum in ascending vertex order, so they agree to the bit.
// Build both without floating-point contraction (nvcc --fmad=false, g++
// -ffp-contract=off) so each operation rounds as PyTorch's does.
#pragma once

#ifdef __CUDACC__
#define SZ_HD __host__ __device__ __forceinline__
#else
#define SZ_HD inline
#endif

namespace sz {

// Floats a pair writes, in the order of the packed output row.
enum OutSlot {
  kContain = 0, kArea, kCx, kCy, kAx, kAy, kBx, kBy, kPnx, kPny, kOutFloats
};

template <typename T>
struct TwoCrossOut {
  int cnt;
  bool ok;
  T f[kOutFloats];
};

// floored modulo for a positive divisor (jnp.mod / torch.remainder)
SZ_HD int pmod(int a, int n) {
  int r = a % n;
  return r < 0 ? r + n : r;
}

SZ_HD int next_vertex(int k, int n) { return k + 1 == n ? 0 : k + 1; }

// vertex counts beyond the ring width behave as the full ring (the closing
// edge wraps at V - 1), negative counts as an empty ring
SZ_HD int clamp_count(int n, int V) { return n < 0 ? 0 : (n > V ? V : n); }

template <typename T>
SZ_HD T absval(T x) { return x < T(0) ? -x : x; }

template <typename T>
SZ_HD T perturb_x(T pert) { return pert * T(0.6180339887498949); }

// One Q coordinate: pool value, shifted to P's image, then perturbed.
template <typename T>
SZ_HD T q_coord(T v, T shift, T off) { return (v + shift) + off; }

// ---- crossings ------------------------------------------------------------

template <typename T>
struct Crossing {
  T t, u, denom;
  bool hit;
};

// P edge from (pax, pay) along (rx, ry) against Q edge from (qax, qay)
// along (sx, sy).
template <typename T>
SZ_HD Crossing<T> edge_crossing(T pax, T pay, T rx, T ry, T qax, T qay, T sx,
                                T sy) {
  const T eps = T(1e-12);
  const T one_m_eps = T(1) - eps;
  const T d0x = qax - pax, d0y = qay - pay;
  Crossing<T> c;
  c.denom = rx * sy - ry * sx;
  const T ds = c.denom == T(0) ? T(1) : c.denom;
  c.t = (d0x * sy - d0y * sx) / ds;
  c.u = (d0x * ry - d0y * rx) / ds;
  c.hit = c.denom != T(0) && c.t > eps && c.t < one_m_eps && c.u > eps &&
          c.u < one_m_eps;
  return c;
}

// Running sums over a pair's crossings; add() folds one in.  Callers add
// crossings in (i, j) order, i outer.
template <typename T>
struct CrossSums {
  int cnt = 0, n_en = 0, e_en = 0, f_en = 0, e_ex = 0, f_ex = 0;
  T xen_x = T(0), xen_y = T(0), xex_x = T(0), xex_y = T(0);
  T t_en = T(0), u_en = T(0), t_ex = T(0), u_ex = T(0);

  SZ_HD void add(int i, int j, T t, T u, T denom, T pax, T pay, T rx, T ry) {
    ++cnt;
    const T cx = pax + t * rx, cy = pay + t * ry;
    if (denom < T(0)) {  // boundary leaves along P (P enters Q)
      ++n_en;
      xen_x += cx; xen_y += cy;
      e_en += i; f_en += j;
      t_en += t; u_en += u;
    } else {
      xex_x += cx; xex_y += cy;
      e_ex += i; f_ex += j;
      t_ex += t; u_ex += u;
    }
  }

  SZ_HD bool two_cross() const { return cnt == 2 && n_en == 1; }
};

// ---- ring sums: one edge (ax, ay) -> (bx, by) -------------------------------

template <typename T>
SZ_HD T shoelace_term(T ax, T ay, T bx, T by) { return ax * by - bx * ay; }

template <typename T>
SZ_HD T ring_area(T shoelace_sum) { return absval(T(0.5) * shoelace_sum); }

// Does the ray from (px, py) towards +x cross this edge?
template <typename T>
SZ_HD bool pip_hit(T px, T py, T ax, T ay, T bx, T by) {
  const bool cond = (ay > py) != (by > py);
  const T dy = by - ay;
  const T tt = (py - ay) / (dy == T(0) ? T(1) : dy);
  const T xint = ax + tt * (bx - ax);
  return cond && px < xint;
}

// ---- chain integrals --------------------------------------------------------
// Line integrals (S, MX, MY) along the ring arc from crossing xin (on edge
// e_in at parameter t_in) forward to crossing xout (on edge e_out).

struct ChainPlan {
  bool same;     // both crossings on one edge, in order: a single segment
  int b_in;      // end vertex of the entering edge
  int e0;        // first full edge of the run
  int cnt_full;  // number of full edges strictly between e_in and e_out
  int nsafe;
};

template <typename T>
SZ_HD ChainPlan chain_plan(int n, int e_in, T t_in, int e_out, T t_out) {
  ChainPlan p;
  p.nsafe = n > 1 ? n : 1;
  p.same = e_in == e_out && t_out > t_in;
  p.b_in = next_vertex(e_in, n);
  p.cnt_full = pmod(e_out - e_in - 1, p.nsafe);
  p.e0 = pmod(e_in + 1, p.nsafe);
  return p;
}

// Is edge k (k < n) one of the run's full edges?
SZ_HD bool chain_runs(const ChainPlan& p, int k) {
  return pmod(k - p.e0, p.nsafe) < p.cnt_full;
}

template <typename T>
struct Moments {
  T s, mx, my;
};

template <typename T>
SZ_HD Moments<T> chain_term(T ax, T ay, T bx, T by) {
  const T cr = ax * by - bx * ay;
  return Moments<T>{cr, (ax + bx) * cr, (ay + by) * cr};
}

template <typename T>
SZ_HD Moments<T> chain_same(T xin_x, T xin_y, T xout_x, T xout_y) {
  const T c = xin_x * xout_y - xout_x * xin_y;
  return Moments<T>{T(0.5) * c, (xin_x + xout_x) * c, (xin_y + xout_y) * c};
}

// xin -> vertex b_in, the run's sums, vertex a_out -> xout.
template <typename T>
SZ_HD Moments<T> chain_close(T xin_x, T xin_y, T bin_x, T bin_y, T aout_x,
                             T aout_y, T xout_x, T xout_y,
                             const Moments<T>& run) {
  const T c1 = xin_x * bin_y - bin_x * xin_y;
  const T c2 = aout_x * xout_y - xout_x * aout_y;
  Moments<T> m;
  m.s = T(0.5) * c1 + T(0.5) * run.s + T(0.5) * c2;
  m.mx = (xin_x + bin_x) * c1 + run.mx + (aout_x + xout_x) * c2;
  m.my = (xin_y + bin_y) * c1 + run.my + (aout_y + xout_y) * c2;
  return m;
}

// ---- final combine ----------------------------------------------------------
// chP / chQ are read only where c.two_cross(); p_in_q / q_in_p only where
// c.cnt == 0.
template <typename T>
SZ_HD TwoCrossOut<T> finish(const CrossSums<T>& c, T areaP, T areaQ,
                            const Moments<T>& chP, const Moments<T>& chQ,
                            bool p_in_q, bool q_in_p, T sliver) {
  TwoCrossOut<T> o;
  o.cnt = c.cnt;
  bool ok = c.two_cross();
  o.f[kArea] = T(0);
  o.f[kCx] = T(0);
  o.f[kCy] = T(0);
  if (ok) {
    const T S = chP.s + chQ.s;
    const T max_reasonable = (areaP < areaQ ? areaP : areaQ) * T(1 + 1e-6);
    ok = S > -sliver * max_reasonable && S <= max_reasonable;
    if (ok && S > T(0)) {
      const T dc = T(6) * S;
      o.f[kArea] = S;
      o.f[kCx] = (chP.mx + chQ.mx) / dc;
      o.f[kCy] = (chP.my + chQ.my) / dc;
    }
  }
  o.ok = ok;
  o.f[kContain] = T(0);
  if (c.cnt == 0) {
    if (p_in_q)
      o.f[kContain] = areaP;
    else if (q_in_p)
      o.f[kContain] = areaQ;
  }
  o.f[kAx] = c.xen_x;
  o.f[kAy] = c.xen_y;
  o.f[kBx] = c.xex_x;
  o.f[kBy] = c.xex_y;
  o.f[kPnx] = -(c.xex_y - c.xen_y);
  o.f[kPny] = c.xex_x - c.xen_x;
  return o;
}

// The result of a row that is not a candidate pair: zeros, not ok.
template <typename T>
SZ_HD TwoCrossOut<T> invalid_row() {
  TwoCrossOut<T> o;
  o.cnt = 0;
  o.ok = false;
  for (int k = 0; k < kOutFloats; ++k) o.f[k] = T(0);
  return o;
}

// A row is computed only if it is valid and both indices lie in their pool.
SZ_HD bool row_live(bool valid, long long i, long long j, int N, int NQ) {
  return valid && i >= 0 && i < N && j >= 0 && j < NQ;
}

}  // namespace sz
