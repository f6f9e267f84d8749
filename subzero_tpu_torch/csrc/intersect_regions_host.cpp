// CPU build of the slow clip's arithmetic (intersect_regions.cuh), loaded
// with ctypes by the CPU tests so that the code the card runs is checked
// against the plain PyTorch version and the JAX package:
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC
//       -o libregions_host.so intersect_regions_host.cpp
//
// Same interface as the CUDA library (pools, pair list, slow selection, the
// slow-row count, one packed output) without the stream and the retry's
// scratch, at any ring widths V, W and any CAP, and the same order of
// combination as the kernel, done serially: crossings in (i, j) order, i
// outer; prefix sums, region sums, ring areas and the total in the header's
// orders; the retry's rows in row order.
#include <vector>

#include "intersect_regions.cuh"

namespace {

namespace rg = sz::regions;

template <typename T>
struct Inputs {
  const T* pverts;
  const int* pnv;
  int N, V;
  const T* qverts;
  const int* qnv;
  int NQ, W;
  const long long* qi;
  const long long* qj;
  const T* shift;
  const T* perturb;
  long long PC;
  const long long* ssel;
  int R;
  const long long* n_slow;
  int cap;
};

template <typename T>
void write_zero_row(const rg::Out<T>& o, int row, int cap) {
  for (int r = 0; r < cap; ++r) {
    const long long s = static_cast<long long>(row) * cap + r;
    o.area[s] = o.plen[s] = T(0);
    for (int d = 0; d < 2; ++d)
      o.cent[2 * s + d] = o.cha[2 * s + d] = o.chb[2 * s + d] =
          o.pnorm[2 * s + d] = T(0);
    o.ncross[s] = o.pcnt[s] = o.qcnt[s] = 0;
    o.valid[s] = 0;
  }
  o.total[row] = T(0);
  o.overflow[row] = 0;
  o.parity_bad[row] = 0;
}

// The clip of one live row, written into the row; a retry that overflows
// again writes nothing, and a retry never writes parity_bad.
template <typename T>
void clip_row(const Inputs<T>& in, const rg::Out<T>& o, int row, long long sel,
              T pscale, bool retry) {
  const int cap = in.cap;
  const long long i = in.qi[sel], j = in.qj[sel];
  const int np = sz::clamp_count(in.pnv[i], in.V);
  const int nq = sz::clamp_count(in.qnv[j], in.W);
  const T pert = in.perturb[sel] * pscale;
  const T ox = sz::perturb_x(pert), oy = pert;
  const T shx = in.shift[2 * sel], shy = in.shift[2 * sel + 1];
  std::vector<T> px(in.V), py(in.V), qx(in.W), qy(in.W);
  for (int k = 0; k < in.V; ++k) {
    px[k] = in.pverts[(i * in.V + k) * 2];
    py[k] = in.pverts[(i * in.V + k) * 2 + 1];
  }
  for (int k = 0; k < in.W; ++k) {
    qx[k] = sz::q_coord(in.qverts[(j * in.W + k) * 2], shx, ox);
    qy[k] = sz::q_coord(in.qverts[(j * in.W + k) * 2 + 1], shy, oy);
  }

  // ---- 1-2. crossings in (i, j) order, the first CAP kept ----------------
  std::vector<rg::Cross<T>> c(cap);
  int count = 0;
  for (int e = 0; e < np; ++e) {
    const int e2 = sz::next_vertex(e, np);
    const T pax = px[e], pay = py[e];
    const T rx = px[e2] - pax, ry = py[e2] - pay;
    for (int f = 0; f < nq; ++f) {
      const int f2 = sz::next_vertex(f, nq);
      const T qax = qx[f], qay = qy[f];
      const sz::Crossing<T> x = sz::edge_crossing(
          pax, pay, rx, ry, qax, qay, qx[f2] - qax, qy[f2] - qay);
      if (!x.hit) continue;
      if (count < cap)
        c[count] = rg::Cross<T>{pax + x.t * rx, pay + x.t * ry, x.t, x.u, e,
                                f, x.denom < T(0)};
      ++count;
    }
  }
  const int sP = rg::pre_len(in.V), sQ = rg::pre_len(in.W);
  std::vector<T> preP(4 * sP), preQ(4 * sQ);
  const T areaP = sz::ring_area(rg::ring_sums(px.data(), py.data(), np, preP.data(), sP));
  const T areaQ = sz::ring_area(rg::ring_sums(qx.data(), qy.data(), nq, preQ.data(), sQ));
  const int C = count < cap ? count : cap;
  const bool overflow = rg::overflowed(count, cap);

  // ---- 3. ranks and next pointers ------------------------------------------
  std::vector<int> nxtP(cap), nxtQ(cap), rankP(cap), rankQ(cap);
  for (int k = 0; k < C; ++k) {
    const T kP = T(c[k].e) + c[k].t, kQ = T(c[k].f) + c[k].u;
    rankP[k] = rankQ[k] = 0;
    for (int m = 0; m < C; ++m) {
      rankP[k] += rg::rank_before(T(c[m].e) + c[m].t, m, kP, k) ? 1 : 0;
      rankQ[k] += rg::rank_before(T(c[m].f) + c[m].u, m, kQ, k) ? 1 : 0;
    }
  }
  for (int k = 0; k < C; ++k) {
    nxtP[k] = nxtQ[k] = k;
    for (int m = 0; m < C; ++m) {
      if (rankP[m] == (rankP[k] + 1) % C) nxtP[k] = m;
      if (rankQ[m] == (rankQ[k] + 1) % C) nxtQ[k] = m;
    }
  }

  // ---- 4. each crossing's outgoing arc -------------------------------------
  std::vector<int> succ(cap);
  std::vector<rg::ArcSums<T>> as(cap);
  for (int k = 0; k < cap; ++k) succ[k] = k;
  for (int k = 0; k < C; ++k) {
    const int n2 = c[k].follow_p ? nxtP[k] : nxtQ[k];
    succ[k] = n2;
    const rg::Cross<T>& d = c[n2];
    const rg::Arc<T> a =
        c[k].follow_p
            ? rg::arc(px.data(), py.data(), np, preP.data(), sP, c[k].x, c[k].y,
                      c[k].e, c[k].t, d.x, d.y, d.e, d.t)
            : rg::arc(qx.data(), qy.data(), nq, preQ.data(), sQ, c[k].x, c[k].y,
                      c[k].f, c[k].u, d.x, d.y, d.f, d.u);
    as[k] = rg::arc_sums(c[k], a, d.x, d.y);
  }

  // ---- 5. cycles: pointer doubling over CAP slots, least index labels ------
  std::vector<int> lbl(cap), s2(cap), l_new(cap), s_new(cap);
  for (int k = 0; k < cap; ++k) {
    lbl[k] = k;
    s2[k] = succ[k];
  }
  const int rounds = rg::label_rounds(cap);
  for (int r = 0; r < rounds; ++r) {
    for (int k = 0; k < cap; ++k) {
      const int l2 = lbl[s2[k]];
      l_new[k] = l2 < lbl[k] ? l2 : lbl[k];
      s_new[k] = s2[s2[k]];
    }
    lbl.swap(l_new);
    s2.swap(s_new);
  }

  // ---- 6. regions: each sums its crossings' arcs in ascending order --------
  T cross_area = T(0);
  std::vector<rg::Region<T>> reg(cap);
  std::vector<T> NX(cap), NY(cap), PL(cap);
  std::vector<int> PCn(cap), QCn(cap), M(cap);
  for (int r = 0; r < cap; ++r) {
    T S = T(0), MX = T(0), MY = T(0);
    NX[r] = NY[r] = PL[r] = T(0);
    PCn[r] = QCn[r] = M[r] = 0;
    for (int k = 0; k < C; ++k) {
      if (lbl[k] != r) continue;
      S += as[k].s;
      MX += as[k].mx;
      MY += as[k].my;
      NX[r] += as[k].nx;
      NY[r] += as[k].ny;
      PL[r] += as[k].pl;
      PCn[r] += as[k].pc;
      QCn[r] += as[k].qc;
      ++M[r];
    }
    reg[r] = rg::region_finish(S, MX, MY, M[r], areaP, areaQ);
    cross_area += reg[r].area;
  }

  // ---- 7. containment --------------------------------------------------------
  bool p_in_q = false, q_in_p = false;
  if (count == 0) {
    int hq = 0, hp = 0;
    bool oq = false, op = false;
    for (int e = 0; e < nq; ++e) {
      const int e2 = sz::next_vertex(e, nq);
      const rg::PipEdge d = rg::pip_edge(px[0], py[0], qx[e], qy[e], qx[e2], qy[e2]);
      hq += d.hit ? 1 : 0;
      oq = oq || d.on_edge;
    }
    for (int e = 0; e < np; ++e) {
      const int e2 = sz::next_vertex(e, np);
      const rg::PipEdge d = rg::pip_edge(qx[0], qy[0], px[e], py[e], px[e2], py[e2]);
      hp += d.hit ? 1 : 0;
      op = op || d.on_edge;
    }
    p_in_q = (hq & 1) == 1 || oq;
    q_in_p = (hp & 1) == 1 || op;
  }

  if (retry && overflow) return;
  for (int r = 0; r < cap; ++r) {
    const long long s = static_cast<long long>(row) * cap + r;
    const bool v = r < C;
    o.area[s] = reg[r].area;
    o.cent[2 * s] = reg[r].cx;
    o.cent[2 * s + 1] = reg[r].cy;
    o.cha[2 * s] = v ? c[r].x : T(0);
    o.cha[2 * s + 1] = v ? c[r].y : T(0);
    o.chb[2 * s] = v ? c[succ[r]].x : T(0);
    o.chb[2 * s + 1] = v ? c[succ[r]].y : T(0);
    o.pnorm[2 * s] = NX[r];
    o.pnorm[2 * s + 1] = NY[r];
    o.plen[s] = PL[r];
    o.ncross[s] = M[r];
    o.pcnt[s] = PCn[r];
    o.qcnt[s] = QCn[r];
    o.valid[s] = reg[r].valid ? 1 : 0;
  }
  o.total[row] = rg::total_area(count, cross_area, p_in_q, q_in_p, areaP, areaQ);
  o.overflow[row] = overflow ? 1 : 0;
  if (!retry) o.parity_bad[row] = overflow ? 1 : 0;
}

template <typename T>
void run(const Inputs<T>& in, T retry_scale, int retry_rows, void* out) {
  const rg::Out<T> o = rg::out_views<T>(out, in.R, in.cap);
  const long long n_slow = *in.n_slow;
  for (int row = 0; row < in.R; ++row) {
    const long long sel = in.ssel[row];
    if (rg::sel_live(row, n_slow, sel, in.PC) &&
        rg::pair_live(in.qi[sel], in.qj[sel], in.N, in.NQ))
      clip_row(in, o, row, sel, T(1), false);
    else
      write_zero_row(o, row, in.cap);
  }
  // the retry: the first retry_rows rows whose parity came out odd
  int done = 0;
  for (int row = 0; row < in.R && done < retry_rows; ++row) {
    if (!o.parity_bad[row]) continue;
    clip_row(in, o, row, in.ssel[row], retry_scale, true);
    ++done;
  }
}

}  // namespace

extern "C" void sz_regions_host_f32(
    const float* pverts, const int* pnv, int N, int V, const float* qverts,
    const int* qnv, int NQ, int W, const long long* qi, const long long* qj,
    const float* shift, const float* perturb, long long PC,
    const long long* ssel, int R, const long long* n_slow, int cap,
    float retry_scale, int retry_rows, void* out) {
  run<float>(Inputs<float>{pverts, pnv, N, V, qverts, qnv, NQ, W, qi, qj,
                           shift, perturb, PC, ssel, R, n_slow, cap},
             retry_scale, retry_rows, out);
}

extern "C" void sz_regions_host_f64(
    const double* pverts, const int* pnv, int N, int V, const double* qverts,
    const int* qnv, int NQ, int W, const long long* qi, const long long* qj,
    const double* shift, const double* perturb, long long PC,
    const long long* ssel, int R, const long long* n_slow, int cap,
    double retry_scale, int retry_rows, void* out) {
  run<double>(Inputs<double>{pverts, pnv, N, V, qverts, qnv, NQ, W, qi, qj,
                             shift, perturb, PC, ssel, R, n_slow, cap},
              retry_scale, retry_rows, out);
}
