// Per-row arithmetic of the general multi-region clip (B2).
//
// The same math, in the same operation order within every term, as the
// plain PyTorch version subzero_tpu_torch/geometry/clip.py:intersect_regions
// (the reference's is subzero_tpu/geometry/clip.py:intersect_regions, which
// XLA fused into one TPU program).  For one pair of padded CCW rings P and Q
// (Q moved to P's periodic image and offset by (0.618..., 1) * pert, each
// add rounded on its own, as two_cross.cuh:q_coord does):
//   1. every P edge i is tested against every Q edge j for a proper crossing
//      (two_cross.cuh:edge_crossing: 0 < t, u < 1 with eps = 1e-12);
//   2. the first CAP crossings in flat (i, j) order, i outer, are kept;
//      more than CAP crossings, or an odd number, set the row's overflow;
//   3. next-crossing pointers along each ring come from a stable rank of
//      the keys i + t (along P) and j + u (along Q) (rank_before);
//   4. each crossing's outgoing arc (along P where P's edge enters Q,
//      denom < 0, else along Q) is integrated from doubled prefix sums of
//      the ring's per-edge terms (edge_term, ring_sums, arc);
//   5. the arcs' successor function is a permutation whose cycles are the
//      overlap regions: labels by pointer doubling, each cycle labelled by
//      its least crossing index;
//   6. each region sums its arcs (area, first moments, P-chain normal,
//      length and segment counts) and is kept if it has two crossings or
//      more and 0 < S <= min(area P, area Q) * (1 + 1e-6) (region_finish);
//   7. with no crossing, the containment area: point-in-polygon of each
//      ring's first vertex in the other ring, boundary included (pip_edge).
//
// This header holds the terms and the serial pieces, and fixes the order of
// every reduction; the CUDA kernel (intersect_regions.cu, a warp a row) and
// the CPU shim (intersect_regions_host.cpp, built by g++ for the CPU tests)
// combine them in that order, so they agree to the bit:
//   * each prefix sum runs in ascending doubled-edge order and accumulates
//     in double, each entry rounded to T (torch.cumsum on the CPU does the
//     same, so the arcs equal the plain version's on the CPU to the bit);
//   * a region's sums add its crossings' arcs in ascending crossing index,
//     from zero, in T;
//   * the ring areas add their shoelace terms in ascending edge order, from
//     zero, in T; the total adds the regions' areas in ascending slot order.
// PyTorch's own sums (torch.sum) take another order, which depends on the
// dtype, the width and the CPU's vector width, so the region sums, the
// areas and the total are the only fields that may differ from the plain
// version in the last bits.
// Build without floating-point contraction (nvcc --fmad=false, g++
// -ffp-contract=off) so each operation rounds as PyTorch's does.
#pragma once

#include <math.h>

#include "two_cross.cuh"

namespace sz {
namespace regions {

// The widest shapes the kernel takes (geometry/regions.py checks them
// before a launch): CAP crossing slots a row, two a lane, and rings of V and
// W vertices, so that a warp's scratch in f64 fits a block with room to
// spare (intersect_regions.cu:Scratch).
constexpr int kMaxCap = 64;
constexpr int kMaxVerts = 128;

// Entries of a doubled prefix sum of a ring of width V.
SZ_HD int pre_len(int V) { return 2 * V + 1; }

SZ_HD float sqrt_t(float x) { return sqrtf(x); }
SZ_HD double sqrt_t(double x) { return sqrt(x); }

// ---- the packed output ------------------------------------------------------
// For R rows of CAP region slots, field by field, each [R] or [R, CAP] (x2 for
// points): floats total_area, area, centroid, chord_a, chord_b, p_norm,
// p_len; int32 n_cross, p_cnt, q_cnt; bytes valid, overflow, parity_bad.
// geometry/regions.py:result_of reads the same layout.

template <typename T>
struct Out {
  T *total, *area, *cent, *cha, *chb, *pnorm, *plen;
  int *ncross, *pcnt, *qcnt;
  unsigned char *valid, *overflow, *parity_bad;
};

// Bytes of that layout (geometry/regions.py:output_bytes).
SZ_HD long long out_bytes(long long R, int cap, int elt) {
  return R * (1 + 10LL * cap) * elt + 12LL * R * cap + R * cap + 2 * R;
}

// The retry's scratch (intersect_regions.cu) holds R rows in that layout, R
// bytes of flags, then the launch's 8-byte ticket at this offset, 8-byte
// aligned (geometry/regions.py:scratch_bytes).
SZ_HD long long ticket_offset(long long R, int cap, int elt) {
  return (out_bytes(R, cap, elt) + R + 7) / 8 * 8;
}

template <typename T>
SZ_HD Out<T> out_views(void* base, long long R, int cap) {
  Out<T> o;
  const long long RC = R * cap;
  T* f = static_cast<T*>(base);
  o.total = f;
  o.area = o.total + R;
  o.cent = o.area + RC;
  o.cha = o.cent + 2 * RC;
  o.chb = o.cha + 2 * RC;
  o.pnorm = o.chb + 2 * RC;
  o.plen = o.pnorm + 2 * RC;
  int* n = reinterpret_cast<int*>(o.plen + RC);
  o.ncross = n;
  o.pcnt = n + RC;
  o.qcnt = n + 2 * RC;
  unsigned char* b = reinterpret_cast<unsigned char*>(n + 3 * RC);
  o.valid = b;
  o.overflow = b + RC;
  o.parity_bad = b + RC + R;
  return o;
}

// ---- crossings ----------------------------------------------------------------

// One kept crossing: its point, edges and parameters along both rings, and
// whether the boundary leaves it along P.
template <typename T>
struct Cross {
  T x, y, t, u;
  int e, f;
  bool follow_p;
};

// Crossing m comes before crossing k along a ring (keys km, kk): the order of
// a stable sort of the keys.
template <typename T>
SZ_HD bool rank_before(T km, int m, T kk, int k) {
  return km < kk || (km == kk && m < k);
}

// ---- ring sums ------------------------------------------------------------------

// Per-edge integral terms of the edge (ax, ay) -> (bx, by).
template <typename T>
struct Terms {
  T s, mx, my, len;
};

template <typename T>
SZ_HD Terms<T> seg_terms(T ax, T ay, T bx, T by) {
  const T cr = ax * by - bx * ay;
  const T dx = bx - ax, dy = by - ay;
  return Terms<T>{T(0.5) * cr, (ax + bx) * cr, (ay + by) * cr,
                  sqrt_t(dx * dx + dy * dy)};
}

// Terms a kernel keeps of each edge: seg_terms' four (s, mx, my, len) and
// its shoelace term (shoelace_term, the cross product), in this order.
constexpr int kTerms = 5;

// Doubled prefix sums of a ring's edge terms, pre[q * stride + m] for the
// terms q = s, mx, my, len over the first m edges of the ring walked twice
// (m <= 2n; stride >= 2n + 1); returns the ring's shoelace sum (its edges'
// cross products in ascending order, from zero).  Vertices (x[k], y[k]),
// k < n.  The kernel runs each term's chain on a lane of its own, in this
// order.
template <typename T>
SZ_HD T ring_sums(const T* x, const T* y, int n, T* pre, int stride) {
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  for (int q = 0; q < 4; ++q) pre[q * stride] = T(0);
  for (int m = 0; m < 2 * n; ++m) {
    const int e = m < n ? m : m - n;
    const int e2 = next_vertex(e, n);
    const Terms<T> d = seg_terms(x[e], y[e], x[e2], y[e2]);
    acc[0] += static_cast<double>(d.s);
    acc[1] += static_cast<double>(d.mx);
    acc[2] += static_cast<double>(d.my);
    acc[3] += static_cast<double>(d.len);
    for (int q = 0; q < 4; ++q) pre[q * stride + m + 1] = T(acc[q]);
  }
  T shoe = T(0);
  for (int e = 0; e < n; ++e) {
    const int e2 = next_vertex(e, n);
    shoe += shoelace_term(x[e], y[e], x[e2], y[e2]);
  }
  return shoe;
}

// ---- arcs -------------------------------------------------------------------------

template <typename T>
struct Arc {
  T s, mx, my, len;
  int cnt;
};

// Line integrals along the ring (x, y, n; prefix sums pre, each term's
// ``stride`` entries apart) from the crossing
// (xk, yk) on edge ek at parameter tk forward to the crossing (x2, y2) on
// edge e2 at t2: one segment where both lie on one edge in that order, else
// the piece to the end of edge ek, the full edges between, and the piece
// from the start of edge e2.
template <typename T>
SZ_HD Arc<T> arc(const T* x, const T* y, int n, const T* pre, int stride,
                 T xk, T yk, int ek, T tk, T x2, T y2, int e2, T t2) {
  if (e2 == ek && t2 > tk) {
    const Terms<T> d = seg_terms(xk, yk, x2, y2);
    return Arc<T>{d.s, d.mx, d.my, d.len, 1};
  }
  const int nsafe = n > 1 ? n : 1;
  const int cnt_full = pmod(e2 - ek - 1, nsafe);
  const int e0 = pmod(ek + 1, nsafe);
  const int b = next_vertex(ek, n);
  const Terms<T> d1 = seg_terms(xk, yk, x[b], y[b]);
  const Terms<T> d2 = seg_terms(x[e2], y[e2], x2, y2);
  const T* lo = pre + e0;
  const T* hi = pre + e0 + cnt_full;
  Arc<T> a;
  a.s = (d1.s + (hi[0] - lo[0])) + d2.s;
  a.mx = (d1.mx + (hi[stride] - lo[stride])) + d2.mx;
  a.my = (d1.my + (hi[2 * stride] - lo[2 * stride])) + d2.my;
  a.len = (d1.len + (hi[3 * stride] - lo[3 * stride])) + d2.len;
  a.cnt = 2 + cnt_full;
  return a;
}

// What one valid crossing adds to its region: the outgoing arc's integrals
// and, for an arc along P, its normal (the arc's displacement turned left),
// length and segment count; for an arc along Q, its segment count.
template <typename T>
struct ArcSums {
  T s, mx, my, nx, ny, pl;
  int pc, qc;
};

template <typename T>
SZ_HD ArcSums<T> arc_sums(const Cross<T>& c, const Arc<T>& a, T x2, T y2) {
  ArcSums<T> r;
  r.s = a.s;
  r.mx = a.mx;
  r.my = a.my;
  if (c.follow_p) {
    r.nx = -(y2 - c.y);
    r.ny = x2 - c.x;
    r.pl = a.len;
    r.pc = a.cnt;
    r.qc = 0;
  } else {
    r.nx = T(0);
    r.ny = T(0);
    r.pl = T(0);
    r.pc = 0;
    r.qc = a.cnt;
  }
  return r;
}

// Rounds of pointer doubling that label every cycle of n slots (2^rounds
// >= n >= the longest cycle; more rounds change no label).
SZ_HD int label_rounds(int n) {
  int bits = 0;
  for (int v = n - 1; v > 0; v >>= 1) ++bits;
  return bits > 1 ? bits : 1;
}

// ---- regions ----------------------------------------------------------------------

template <typename T>
struct Region {
  T area, cx, cy;
  bool valid;
};

// A region's sums (S, MX, MY over m crossings) against the clamp a real
// overlap obeys: never more than the smaller ring's area.
template <typename T>
SZ_HD Region<T> region_finish(T S, T MX, T MY, int m, T areaP, T areaQ) {
  const T max_reasonable = (areaP < areaQ ? areaP : areaQ) * T(1 + 1e-6);
  Region<T> r;
  r.valid = m >= 2 && S > T(0) && S <= max_reasonable;
  r.area = r.valid ? S : T(0);
  const T dc = T(6) * S;
  r.cx = r.valid ? MX / dc : T(0);
  r.cy = r.valid ? MY / dc : T(0);
  return r;
}

// ---- containment ------------------------------------------------------------------

// The point (px, py) against one edge (ax, ay) -> (bx, by): does the ray
// towards +x cross it (two_cross.cuh:pip_hit), and does the point lie on it
// within the relative tolerance of polygon.py:point_in_polygon?
struct PipEdge {
  bool hit, on_edge;
};

template <typename T>
SZ_HD PipEdge pip_edge(T px, T py, T ax, T ay, T bx, T by) {
  PipEdge r;
  r.hit = pip_hit(px, py, ax, ay, bx, by);
  const T dx = bx - ax, dy = by - ay;
  const T crs = (px - ax) * dy - (py - ay) * dx;
  const T seg_len2 = dx * dx + dy * dy;
  const T scale = sqrt_t(seg_len2 > T(1e-30) ? seg_len2 : T(1e-30));
  const T dot = (px - ax) * dx + (py - ay) * dy;
  r.on_edge = absval(crs) <= T(1e-9) * (scale > T(1) ? scale : T(1)) * scale &&
              dot >= T(-1e-9) * seg_len2 && dot <= seg_len2 * T(1 + 1e-9);
  return r;
}

// The row's total area: the regions' areas, or with no crossing the area of
// the ring that lies inside the other.
template <typename T>
SZ_HD T total_area(int n_total, T cross_area, bool p_in_q, bool q_in_p,
                   T areaP, T areaQ) {
  if (n_total != 0) return cross_area;
  return p_in_q ? areaP : (q_in_p ? areaQ : T(0));
}

// Crossings more than CAP, or odd in number: the row is unreliable.
SZ_HD bool overflowed(int n_total, int cap) {
  return n_total > cap || (n_total & 1) == 1;
}

// A slow row is clipped when it is one of the step's first min(n_slow, R)
// slow rows, its selection lies in the pair list and the pair's indices lie
// in their pools (read in that order: each test guards the next read).
SZ_HD bool sel_live(int row, long long n_slow, long long sel, long long PC) {
  return row < n_slow && sel >= 0 && sel < PC;
}

SZ_HD bool pair_live(long long i, long long j, int N, int NQ) {
  return i >= 0 && i < N && j >= 0 && j < NQ;
}

}  // namespace regions
}  // namespace sz
