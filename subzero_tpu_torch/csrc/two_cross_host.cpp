// CPU build of the two-crossing kernel's arithmetic (two_cross.cuh), loaded
// with ctypes by the CPU tests so that the code the card runs is checked
// against the plain PyTorch version:
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC
//       -o libtwo_cross_host.so two_cross_host.cpp
//
// Same interface as the CUDA library (pools, pair list, one packed output),
// and the same order of combination as the kernel, done serially: crossings
// folded in (i, j) order, i outer; ring sums in ascending vertex order.
#include "two_cross.cuh"

namespace {

// A ring read in place: n vertices (x, y) interleaved, each coordinate
// shifted and then offset (both zero for P).
template <typename T>
struct Ring {
  const T* v;
  int n;
  T shx, shy, ox, oy;
  T x(int k) const { return sz::q_coord(v[2 * k], shx, ox); }
  T y(int k) const { return sz::q_coord(v[2 * k + 1], shy, oy); }
};

template <typename T>
T area(const Ring<T>& r) {
  T s = T(0);
  for (int k = 0; k < r.n; ++k) {
    const int k2 = sz::next_vertex(k, r.n);
    s += sz::shoelace_term(r.x(k), r.y(k), r.x(k2), r.y(k2));
  }
  return sz::ring_area(s);
}

template <typename T>
bool point_in(T px, T py, const Ring<T>& r) {
  int hits = 0;
  for (int k = 0; k < r.n; ++k) {
    const int k2 = sz::next_vertex(k, r.n);
    if (sz::pip_hit(px, py, r.x(k), r.y(k), r.x(k2), r.y(k2))) ++hits;
  }
  return (hits & 1) == 1;
}

template <typename T>
sz::Moments<T> chain(const Ring<T>& r, int e_in, T t_in, T xin_x, T xin_y,
                     int e_out, T t_out, T xout_x, T xout_y) {
  const sz::ChainPlan p = sz::chain_plan(r.n, e_in, t_in, e_out, t_out);
  if (p.same) return sz::chain_same(xin_x, xin_y, xout_x, xout_y);
  sz::Moments<T> run{T(0), T(0), T(0)};
  for (int k = 0; k < r.n; ++k) {
    if (!sz::chain_runs(p, k)) continue;
    const int k2 = sz::next_vertex(k, r.n);
    const sz::Moments<T> m = sz::chain_term(r.x(k), r.y(k), r.x(k2), r.y(k2));
    run.s += m.s;
    run.mx += m.mx;
    run.my += m.my;
  }
  return sz::chain_close(xin_x, xin_y, r.x(p.b_in), r.y(p.b_in), r.x(e_out),
                         r.y(e_out), xout_x, xout_y, run);
}

template <typename T>
sz::TwoCrossOut<T> pair(const Ring<T>& P, const Ring<T>& Q, T sliver) {
  sz::CrossSums<T> c;
  for (int i = 0; i < P.n; ++i) {
    const int i2 = sz::next_vertex(i, P.n);
    const T pax = P.x(i), pay = P.y(i);
    const T rx = P.x(i2) - pax, ry = P.y(i2) - pay;
    for (int j = 0; j < Q.n; ++j) {
      const int j2 = sz::next_vertex(j, Q.n);
      const T qax = Q.x(j), qay = Q.y(j);
      const sz::Crossing<T> x = sz::edge_crossing(
          pax, pay, rx, ry, qax, qay, Q.x(j2) - qax, Q.y(j2) - qay);
      if (x.hit) c.add(i, j, x.t, x.u, x.denom, pax, pay, rx, ry);
    }
  }
  sz::Moments<T> chP{T(0), T(0), T(0)}, chQ{T(0), T(0), T(0)};
  if (c.two_cross()) {
    chP = chain(P, c.e_en, c.t_en, c.xen_x, c.xen_y, c.e_ex, c.t_ex, c.xex_x,
                c.xex_y);
    chQ = chain(Q, c.f_ex, c.u_ex, c.xex_x, c.xex_y, c.f_en, c.u_en, c.xen_x,
                c.xen_y);
  }
  bool p_in_q = false, q_in_p = false;
  if (c.cnt == 0) {
    p_in_q = point_in(P.x(0), P.y(0), Q);
    q_in_p = point_in(Q.x(0), Q.y(0), P);
  }
  return sz::finish(c, area(P), area(Q), chP, chQ, p_in_q, q_in_p, sliver);
}

template <typename T>
void run(const T* pverts, const int* pnv, int N, int V, const T* qverts,
         const int* qnv, int NQ, int W, const long long* qi,
         const long long* qj, const T* shift, const T* perturb,
         const unsigned char* valid, int PC, T sliver, T* out, int* cnt,
         unsigned char* ok) {
  for (int row = 0; row < PC; ++row) {
    const long long i = qi[row], j = qj[row];
    sz::TwoCrossOut<T> o = sz::invalid_row<T>();
    if (sz::row_live(valid[row] != 0, i, j, N, NQ)) {
      const T pert = perturb[row];
      // P adds exact zeros: x + 0 + 0 == x
      const Ring<T> P{pverts + i * V * 2, sz::clamp_count(pnv[i], V), T(0),
                      T(0), T(0), T(0)};
      const Ring<T> Q{qverts + j * W * 2, sz::clamp_count(qnv[j], W),
                      shift[2 * row], shift[2 * row + 1], sz::perturb_x(pert),
                      pert};
      o = pair(P, Q, sliver);
    }
    for (int k = 0; k < sz::kOutFloats; ++k)
      out[static_cast<long long>(row) * sz::kOutFloats + k] = o.f[k];
    cnt[row] = o.cnt;
    ok[row] = o.ok ? 1 : 0;
  }
}

}  // namespace

extern "C" void sz_two_cross_host_f32(
    const float* pverts, const int* pnv, int N, int V, const float* qverts,
    const int* qnv, int NQ, int W, const long long* qi, const long long* qj,
    const float* shift, const float* perturb, const unsigned char* valid,
    int PC, float sliver, float* out, int* cnt, unsigned char* ok) {
  run<float>(pverts, pnv, N, V, qverts, qnv, NQ, W, qi, qj, shift, perturb,
             valid, PC, sliver, out, cnt, ok);
}

extern "C" void sz_two_cross_host_f64(
    const double* pverts, const int* pnv, int N, int V, const double* qverts,
    const int* qnv, int NQ, int W, const long long* qi, const long long* qj,
    const double* shift, const double* perturb, const unsigned char* valid,
    int PC, double sliver, double* out, int* cnt, unsigned char* ok) {
  run<double>(pverts, pnv, N, V, qverts, qnv, NQ, W, qi, qj, shift, perturb,
              valid, PC, sliver, out, cnt, ok);
}
