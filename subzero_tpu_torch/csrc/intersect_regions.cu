// CUDA kernel of the general multi-region clip of the slow rows (sm_90a).
//
// Replaces the jnp path subzero_tpu/geometry/clip.py:intersect_regions as
// subzero_tpu/physics/collisions.py runs it on the step's slow rows (the
// candidate pairs that cross but are no clean two-crossing contact), which
// XLA fused into one TPU program; it has no Pallas counterpart.  The JAX
// package sizes that clip to the step's own demand by lax.cond: no clip when
// no row is slow, else the smallest tier of (8, 16, 64, 256, slow_cap) rows
// that holds them, and a 16-row retry with the perturbation scaled by -41
// only when a parity came out odd (collisions.py:1336-1403).  Here the same
// semantics are decided on the device, in one launch, with no host read:
//   * a warp a row of the R = slow_cap rows; a row at or past
//     min(n_slow, R) (n_slow read from device memory) writes zeros and
//     leaves, so a step with no slow row is one near-empty launch;
//   * a warp whose row comes out odd (more than CAP crossings, or an odd
//     number) keeps that first result in a scratch row and clips the row
//     again at once with the perturbation scaled, on the rings it holds,
//     writing the retry over the row where it resolves;
//   * each row then takes a ticket (one 64-bit integer atomic counts the
//     rows done and the odd rows among them).  The ticket lives at the end
//     of the call's own scratch and the launch zeroes it first (a memset on
//     the same stream), so every launch and every graph replay starts from
//     0, and launches on other streams, into other buffers, share nothing.
//     The last row knows how many rows came out odd; only where more than
//     the 16 of the JAX rule did (rare) does it put the first result back
//     on the odd rows past the first 16, in row order.  Every row's result
//     is out before its ticket, so the outcome does not depend on which row
//     is last.
// The per-row arithmetic and the order of every reduction are in
// intersect_regions.cuh.
//
// What bounds it on the H100.  A live row reads two rings of at most 256 B
// (f32, 32 vertices), its indices, shift and perturbation, and writes
// CAP x 14 values + 3 (~1 KB at CAP 16 in f32); it runs pn x qn crossing
// tests of ~25 operations (~8 x 8 edge pairs on a typical pair), then work
// in CAP^2 (ranks, pointers, region sums).  A step has a few to a few
// hundred live rows, so bytes and operations are both a microsecond or
// less: the kernel is bound by latency, one row's dependent chain, and by
// the launch.  The first design (two launches, clip then retry) took
// ~15 500 cycles a row at the 32 000-floe field's 740 rows (H100, clock64
// by phase, chip_smoke.py's regions phase): the ring prefix sums, run
// serially by two lanes (four terms and the shoelace each step, 2n steps),
// were 46% of it, the crossing sweep (one P edge a step) 23%; and the retry
// waited for a second launch.  This design takes ~11 800 there, ~4 800 of
// them the three dependent global loads of the gather that no design of
// the row avoids, and ~7 300 more on a row whose parity comes out odd.
//
// What the design does about it:
//   * One launch a step; the retry runs in the warp that found the odd row,
//     on the P ring, P prefix sums and P area it already holds, and in the
//     common case (16 odd rows or fewer) nothing is merged afterwards.
//   * The crossing sweep runs over the flat (i, j) grid, 32 edge pairs a
//     step: ceil(np nq / 32) steps (2 for 8 x 8) instead of np.  Slots are
//     assigned by ballot and popc in flat order, which is the (i outer, j
//     inner) order, so the crossing list is the same, bit for bit.
//   * The ring prefix sums keep their serial order (in double, ascending
//     doubled-edge index, each entry rounded to T: the bits of torch.cumsum
//     on the CPU), but every lane first computes its edges' terms, and then
//     ten lanes run one chain each (four terms and the shoelace sum of each
//     ring) over terms that the compiler may load ahead, so a step of the
//     chain is one add.
//   * Next pointers come from the ranks' inverse (one shared-memory store
//     and load, not an O(C) search); pointer doubling runs bits(C - 1)
//     rounds, not bits(CAP - 1); a region's head sums its members from its
//     own index on, in ascending crossing order; the cross area adds the C
//     slots that can hold a region (the other slots add +0, which changes
//     no bit).
//   * Any ring width V, W <= 128 and CAP <= 64: lanes own vertices, edges
//     and crossings l, l + 32, ...; each warp's rings, terms, prefix sums
//     and crossing arrays sit in dynamic shared memory, laid out for one of
//     two size classes (up to 32 vertices and 32 slots, which every
//     configuration uses, or up to 128 and 64), and a block holds as many
//     warps (up to 4) as fit 227 KB.
//   * The rings are gathered here from the pools (the floe pool, and the
//     Q pool of floes, walls and topography) through the slow selection
//     ssel; no ring batch is materialised.  Nothing is read on the host, so
//     the step stays one CUDA graph.
//   * No float atomics: two runs give the same bits, the bits of the serial
//     CPU shim (intersect_regions_host.cpp).
//
// Build (plain C interface, loaded with ctypes; see geometry/regions.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -o libregions.so intersect_regions.cu
// With -DSZ_REGIONS_CLOCK the kernel also stamps each phase of a row's chain
// with clock64() (chip_smoke.py's regions phase; never the main path).
#include <cuda_runtime.h>

#include "intersect_regions.cuh"

namespace {

namespace rg = sz::regions;

constexpr int kMaxWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
// shared memory a block may use on sm_90, and without opting in
constexpr size_t kSmemLimit = 232448;
constexpr size_t kSmemDefault = 49152;

// Per-phase clock stamps of a row's chain, only in the build with
// -DSZ_REGIONS_CLOCK: lane 0 of each live row's warp writes kClockSlots
// values, the cycles of each phase of the first clip (gather, crossing
// sweep, prefix sums, ranks and next pointers, arcs, pointer doubling,
// region sums and cross area, containment, store), then the retry's whole
// chain (0 without one).
constexpr int kClockSlots = 10;
#ifdef SZ_REGIONS_CLOCK
#define SZ_STAMP(k)       \
  do {                    \
    __syncwarp();         \
    stamp[k] = clock64(); \
  } while (0)
#else
#define SZ_STAMP(k) \
  do {              \
  } while (0)
#endif

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

// One warp's scratch, for rings of up to VM vertices and CM crossing
// slots; a block's warps take consecutive ones from dynamic shared memory.
// Two size classes (launch): VM = CM = 32, which every configuration uses,
// and VM = kMaxVerts, CM = kMaxCap for anything wider.  Every array is
// addressed at compile-time offsets from one shared-memory base, so the
// loads and stores are shared-memory ones.
template <typename T, int VM, int CM>
struct Scratch {
  T px[VM], py[VM];       // P ring
  T qsx[VM], qsy[VM];     // Q ring moved to P's image, before the offset
  T qx[VM], qy[VM];       // Q ring as clipped
  // edge terms [q][e] in double, as the prefix sums add them, each term
  // VM + 1 apart, so that the ten lanes that read one term each (term q of
  // P or Q at the same e) hit distinct banks
  double termP[rg::kTerms * (VM + 1)], termQ[rg::kTerms * (VM + 1)];
  T preP[4 * (2 * VM + 1)], preQ[4 * (2 * VM + 1)];  // doubled prefix sums
  // crossing k's point, parameters, keys, arc sums; region r's area
  T cx[CM], cy[CM], ct[CM], cu[CM], keyP[CM], keyQ[CM];
  T as[CM], amx[CM], amy[CM], anx[CM], any_[CM], apl[CM], rarea[CM];
  // crossing k's edges, direction, ranks, successor, label, hop, counts;
  // rank r's crossing along each ring
  int ce[CM], cf[CM], cfp[CM], rankP[CM], rankQ[CM], ordP[CM], ordQ[CM];
  int succ[CM], lbl[CM], hop[CM], apc[CM], aqc[CM];
};

struct Inputs {
  const void* pverts;
  const int* pnv;
  int N, V;
  const void* qverts;
  const int* qnv;
  int NQ, W;
  const long long* qi;
  const long long* qj;
  const void* shift;
  const void* perturb;
  long long PC;
  const long long* ssel;
  int R;
  const long long* n_slow;
  int cap;
  long long* clk;  // [R, kClockSlots] or null (SZ_REGIONS_CLOCK only)
};

// Row ``row`` of the output: zeros, no region, no overflow.
template <typename T>
__device__ void write_zero_row(const rg::Out<T>& o, int row, int cap,
                               int lane) {
  const long long base = static_cast<long long>(row) * cap;
  for (int r = lane; r < cap; r += 32) {
    const long long s = base + r;
    o.area[s] = T(0);
    o.cent[2 * s] = T(0);
    o.cent[2 * s + 1] = T(0);
    o.cha[2 * s] = T(0);
    o.cha[2 * s + 1] = T(0);
    o.chb[2 * s] = T(0);
    o.chb[2 * s + 1] = T(0);
    o.pnorm[2 * s] = T(0);
    o.pnorm[2 * s + 1] = T(0);
    o.plen[s] = T(0);
    o.ncross[s] = 0;
    o.pcnt[s] = 0;
    o.qcnt[s] = 0;
    o.valid[s] = 0;
  }
  if (lane == 0) {
    o.total[row] = T(0);
    o.overflow[row] = 0;
    o.parity_bad[row] = 0;
  }
}

// Slot r of row ``row`` of the retry's scratch ``o2`` over the same slot of
// ``o`` (with the row's total and overflow flag at slot 0; parity_bad is
// the first clip's), read past L1: another SM wrote it.
template <typename T>
__device__ __forceinline__ void copy_slot(const rg::Out<T>& o,
                                          const rg::Out<T>& o2, int row,
                                          int r, int cap) {
  const long long s = static_cast<long long>(row) * cap + r;
  const T area = __ldcg(o2.area + s), plen = __ldcg(o2.plen + s);
  T v2[8];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    v2[d] = __ldcg(o2.cent + 2 * s + d);
    v2[2 + d] = __ldcg(o2.cha + 2 * s + d);
    v2[4 + d] = __ldcg(o2.chb + 2 * s + d);
    v2[6 + d] = __ldcg(o2.pnorm + 2 * s + d);
  }
  const int nc = __ldcg(o2.ncross + s), pc = __ldcg(o2.pcnt + s),
            qc = __ldcg(o2.qcnt + s);
  const unsigned char v = __ldcg(o2.valid + s);
  T total = T(0);
  unsigned char of = 0;
  if (r == 0) {
    total = __ldcg(o2.total + row);
    of = __ldcg(o2.overflow + row);
  }
  o.area[s] = area;
  o.plen[s] = plen;
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    o.cent[2 * s + d] = v2[d];
    o.cha[2 * s + d] = v2[2 + d];
    o.chb[2 * s + d] = v2[4 + d];
    o.pnorm[2 * s + d] = v2[6 + d];
  }
  o.ncross[s] = nc;
  o.pcnt[s] = pc;
  o.qcnt[s] = qc;
  o.valid[s] = v;
  if (r == 0) {
    o.total[row] = total;
    o.overflow[row] = of;
  }
}

// The odd rows past the first ``retry_rows`` (in row order, of the ``live``
// clipped ones) whose retry resolved take back their first result, which
// the scratch ``o2`` holds: the JAX package retries the first 16 only.
template <typename T>
__device__ void undo_late_retries(const rg::Out<T>& o, const rg::Out<T>& o2,
                                  const unsigned char* resolved, int live,
                                  int retry_rows, int cap, int lane) {
  int seen = 0;
  for (int base = 0; base < live; base += 32) {
    const int k = base + lane;
    const bool bad = k < live && __ldcg(o.parity_bad + k) != 0;
    const unsigned m = __ballot_sync(kFull, bad);
    const bool late = bad && seen + __popc(m & ((1u << lane) - 1u)) >= retry_rows &&
                      __ldcg(resolved + k) != 0;
    unsigned rows = __ballot_sync(kFull, late);
    while (rows != 0) {  // uniform over the warp
      const int row = base + __ffs(rows) - 1;
      rows &= rows - 1;
      for (int r = lane; r < cap; r += 32) copy_slot(o, o2, row, r, cap);
    }
    seen += __popc(m);
  }
}

// Slot r (lanes r, r + 32) and the row's scalars, for the clip's store.
template <typename T>
struct SlotOut {
  rg::Region<T> reg;
  T nx, ny, pl;
  int pc, qc, m;
};

// The row's result into row ``row`` of the packed output at ``base``.
template <typename T, int VM, int CM>
__device__ __forceinline__ void store_row(void* base, int R, int cap,
                                          int row, int lane, int C,
                                          const SlotOut<T> (&so)[2], T total,
                                          bool overflow,
                                          const Scratch<T, VM, CM>& sm) {
  const rg::Out<T> t = rg::out_views<T>(base, R, cap);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = lane + 32 * h;
    if (r < cap) {
      const long long s = static_cast<long long>(row) * cap + r;
      const bool v = r < C;
      const int b = v ? sm.succ[r] : 0;
      t.area[s] = so[h].reg.area;
      t.cent[2 * s] = so[h].reg.cx;
      t.cent[2 * s + 1] = so[h].reg.cy;
      t.cha[2 * s] = v ? sm.cx[r] : T(0);
      t.cha[2 * s + 1] = v ? sm.cy[r] : T(0);
      t.chb[2 * s] = v ? sm.cx[b] : T(0);
      t.chb[2 * s + 1] = v ? sm.cy[b] : T(0);
      t.pnorm[2 * s] = so[h].nx;
      t.pnorm[2 * s + 1] = so[h].ny;
      t.plen[s] = so[h].pl;
      t.ncross[s] = so[h].m;
      t.pcnt[s] = so[h].pc;
      t.qcnt[s] = so[h].qc;
      t.valid[s] = so[h].reg.valid ? 1 : 0;
    }
  }
  if (lane == 0) {
    t.total[row] = total;
    t.overflow[row] = overflow ? 1 : 0;
  }
}

// The clip of one live row by its warp into row ``row`` of ``out``; returns
// whether it came out odd.  Where it does and ``retry_rows`` > 0, that result
// goes to the same row of ``scratch`` too, and the row is clipped again with
// the perturbation scaled by ``retry_scale``; the retry is written over the
// row where it resolves (resolved[row] says whether).
template <typename T, int VM, int CM>
__device__ __forceinline__ bool clip_row(
    const Inputs& in, void* out, void* scratch, unsigned char* resolved,
    int row, long long sel, long long i, long long j, T retry_scale,
    int retry_rows, int lane, Scratch<T, VM, CM>& sm, long long* stamp) {
  using V2 = typename Vec2<T>::type;
  (void)stamp;
  const T* shift = static_cast<const T*>(in.shift);
  const int V = in.V, W = in.W, cap = in.cap;
  constexpr int S = 2 * VM + 1;  // a prefix sum's entries in the scratch
  constexpr int TS = VM + 1;     // a term's entries in the scratch
  const int np = sz::clamp_count(in.pnv[i], V);
  const int nq = sz::clamp_count(in.qnv[j], W);
  const T pert0 = static_cast<const T*>(in.perturb)[sel];
  const T shx = shift[2 * sel], shy = shift[2 * sel + 1];
  const unsigned below = (1u << lane) - 1u;

  // ---- the rings into shared memory: lane l holds vertices l, l + 32, ...
  for (int k = lane; k < V; k += 32) {
    const V2 v = static_cast<const V2*>(in.pverts)[i * V + k];
    sm.px[k] = v.x;
    sm.py[k] = v.y;
  }
  for (int k = lane; k < W; k += 32) {
    const V2 v = static_cast<const V2*>(in.qverts)[j * W + k];
    sm.qsx[k] = v.x + shx;  // q_coord's first add
    sm.qsy[k] = v.y + shy;
  }
  T areaP = T(0);
  bool odd = false;
  for (int pass = 0; pass < 2; ++pass) {
    const bool first = pass == 0;
    const T pert = pert0 * (first ? T(1) : retry_scale);
    const T ox = sz::perturb_x(pert), oy = pert;
    for (int k = lane; k < W; k += 32) {
      sm.qx[k] = sm.qsx[k] + ox;  // q_coord's second add
      sm.qy[k] = sm.qsy[k] + oy;
    }
    __syncwarp();
    if (first) SZ_STAMP(1);

    // ---- 1-2. crossings over the flat (i, j) grid, 32 edge pairs a step
    const int total = np * nq;
    int count = 0;
    for (int base = 0; base < total; base += 32) {
      const int k = base + lane;
      bool hit = false;
      int e = 0, f = 0;
      T pax = T(0), pay = T(0), rx = T(0), ry = T(0);
      sz::Crossing<T> x{T(0), T(0), T(0), false};
      if (k < total) {
        e = k / nq;
        f = k - e * nq;
        const int e2 = sz::next_vertex(e, np), f2 = sz::next_vertex(f, nq);
        pax = sm.px[e];
        pay = sm.py[e];
        rx = sm.px[e2] - pax;
        ry = sm.py[e2] - pay;
        const T qax = sm.qx[f], qay = sm.qy[f];
        x = sz::edge_crossing(pax, pay, rx, ry, qax, qay, sm.qx[f2] - qax,
                              sm.qy[f2] - qay);
        hit = x.hit;
      }
      const unsigned hits = __ballot_sync(kFull, hit);
      if (hit) {
        const int slot = count + __popc(hits & below);
        if (slot < cap) {
          sm.cx[slot] = pax + x.t * rx;
          sm.cy[slot] = pay + x.t * ry;
          sm.ct[slot] = x.t;
          sm.cu[slot] = x.u;
          sm.ce[slot] = e;
          sm.cf[slot] = f;
          sm.cfp[slot] = x.denom < T(0) ? 1 : 0;
        }
      }
      count += __popc(hits);
    }
    if (first) SZ_STAMP(2);

    // ---- the rings' prefix sums: each lane its edges' terms, then one lane
    // a chain: 0-3 P's s, mx, my, len, 4-7 Q's, 8 and 9 the shoelace sums
    if (first) {
      for (int e = lane; e < np; e += 32) {
        const int e2 = sz::next_vertex(e, np);
        const T ax = sm.px[e], ay = sm.py[e], bx = sm.px[e2], by = sm.py[e2];
        const rg::Terms<T> d = rg::seg_terms(ax, ay, bx, by);
        sm.termP[e] = d.s;
        sm.termP[TS + e] = d.mx;
        sm.termP[2 * TS + e] = d.my;
        sm.termP[3 * TS + e] = d.len;
        sm.termP[4 * TS + e] = sz::shoelace_term(ax, ay, bx, by);
      }
    }
    for (int e = lane; e < nq; e += 32) {
      const int e2 = sz::next_vertex(e, nq);
      const T ax = sm.qx[e], ay = sm.qy[e], bx = sm.qx[e2], by = sm.qy[e2];
      const rg::Terms<T> d = rg::seg_terms(ax, ay, bx, by);
      sm.termQ[e] = d.s;
      sm.termQ[TS + e] = d.mx;
      sm.termQ[2 * TS + e] = d.my;
      sm.termQ[3 * TS + e] = d.len;
      sm.termQ[4 * TS + e] = sz::shoelace_term(ax, ay, bx, by);
    }
    __syncwarp();
    T shoe = T(0);
    const bool onP = lane < 4 || lane == 8;
    if (lane < 10 && (first || !onP)) {
      const int q = lane < 8 ? (lane & 3) : 4;
      const int n = onP ? np : nq;
      // the terms are only read and the sums only written here, so the
      // loads may run ahead of the chain of adds
      const double* __restrict__ term = (onP ? sm.termP : sm.termQ) + q * TS;
      T* __restrict__ pre = (onP ? sm.preP : sm.preQ) + q * S;
      const bool chain = lane < 8;
      if (chain) pre[0] = T(0);
      // four terms loaded ahead of their four adds: the loop carries only
      // the adds (a term in double is its T value exactly)
      double acc = 0.0;
      int m = 0;
      for (; m + 4 <= 2 * n; m += 4) {
        double d[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) d[u] = term[m + u < n ? m + u : m + u - n];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc += d[u];
          if (m + u < n) shoe += T(d[u]);
          if (chain) pre[m + u + 1] = T(acc);
        }
      }
      for (; m < 2 * n; ++m) {
        const double d = term[m < n ? m : m - n];
        acc += d;
        if (m < n) shoe += T(d);
        if (chain) pre[m + 1] = T(acc);
      }
    }
    __syncwarp();
    if (first) areaP = sz::ring_area(__shfl_sync(kFull, shoe, 8));
    const T areaQ = sz::ring_area(__shfl_sync(kFull, shoe, 9));
    const int C = count < cap ? count : cap;
    const bool overflow = rg::overflowed(count, cap);
    if (first) {
      odd = overflow;
      SZ_STAMP(3);
    }

    // ---- 3. crossing k (lanes k, k + 32): ranks along both rings by
    // counting (no chain of selects), then each rank's crossing -----------
    for (int k = lane; k < C; k += 32) {
      sm.keyP[k] = T(sm.ce[k]) + sm.ct[k];
      sm.keyQ[k] = T(sm.cf[k]) + sm.cu[k];
    }
    __syncwarp();
    for (int k = lane; k < C; k += 32) {
      const T kp = sm.keyP[k], kq = sm.keyQ[k];
      int rp = 0, rq = 0;
#pragma unroll 4
      for (int m = 0; m < C; ++m) {
        rp += rg::rank_before(sm.keyP[m], m, kp, k) ? 1 : 0;
        rq += rg::rank_before(sm.keyQ[m], m, kq, k) ? 1 : 0;
      }
      sm.rankP[k] = rp;
      sm.rankQ[k] = rq;
      sm.ordP[rp] = k;
      sm.ordQ[rq] = k;
    }
    __syncwarp();
    if (first) SZ_STAMP(4);

    // ---- 4. the outgoing arc of crossing k: to the next crossing along the
    // ring it leaves on (the rank order's next, the first after the last)
    for (int k = lane; k < C; k += 32) {
      const rg::Cross<T> c{sm.cx[k], sm.cy[k], sm.ct[k], sm.cu[k],
                           sm.ce[k], sm.cf[k], sm.cfp[k] != 0};
      const int r = c.follow_p ? sm.rankP[k] : sm.rankQ[k];
      const int s = (c.follow_p ? sm.ordP : sm.ordQ)[r + 1 == C ? 0 : r + 1];
      const T x2 = sm.cx[s], y2 = sm.cy[s];
      const rg::Arc<T> a =
          c.follow_p
              ? rg::arc(sm.px, sm.py, np, sm.preP, S, c.x, c.y, c.e, c.t,
                        x2, y2, sm.ce[s], sm.ct[s])
              : rg::arc(sm.qx, sm.qy, nq, sm.preQ, S, c.x, c.y, c.f, c.u,
                        x2, y2, sm.cf[s], sm.cu[s]);
      const rg::ArcSums<T> as = rg::arc_sums(c, a, x2, y2);
      sm.succ[k] = s;
      sm.hop[k] = s;
      sm.lbl[k] = k;
      sm.as[k] = as.s;
      sm.amx[k] = as.mx;
      sm.amy[k] = as.my;
      sm.anx[k] = as.nx;
      sm.any_[k] = as.ny;
      sm.apl[k] = as.pl;
      sm.apc[k] = as.pc;
      sm.aqc[k] = as.qc;
    }
    __syncwarp();
    if (first) SZ_STAMP(5);

    // ---- 5. cycles: pointer doubling, least index labels, bits(C - 1)
    // rounds over the crossings lane and lane + 32 -------------------------
    int lb[2] = {lane, lane + 32}, hp[2] = {lane, lane + 32};
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (lane + 32 * h < C) hp[h] = sm.hop[lane + 32 * h];
    const int rounds = C > 0 ? rg::label_rounds(C) : 0;
    for (int rd = 0; rd < rounds; ++rd) {
      int l2[2] = {0, 0}, h2[2] = {0, 0};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (lane + 32 * h < C) {
          l2[h] = sm.lbl[hp[h]];
          h2[h] = sm.hop[hp[h]];
        }
      }
      __syncwarp();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = lane + 32 * h;
        if (k < C) {
          lb[h] = l2[h] < lb[h] ? l2[h] : lb[h];
          hp[h] = h2[h];
          sm.lbl[k] = lb[h];
          sm.hop[k] = hp[h];
        }
      }
      __syncwarp();
    }
    if (first) SZ_STAMP(6);

    // ---- 6. the head of region r (lanes r, r + 32) sums the crossings of
    // its label in ascending order, from its own index on (the head is the
    // cycle's least index); slots with no region are zeros
    SlotOut<T> so[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h;
      T S_ = T(0), MX = T(0), MY = T(0), NX = T(0), NY = T(0), PL = T(0);
      int PCn = 0, QCn = 0, M = 0;
      if (r < C && lb[h] == r) {
#pragma unroll 4
        for (int k = r; k < C; ++k) {
          if (sm.lbl[k] != r) continue;
          S_ += sm.as[k];
          MX += sm.amx[k];
          MY += sm.amy[k];
          NX += sm.anx[k];
          NY += sm.any_[k];
          PL += sm.apl[k];
          PCn += sm.apc[k];
          QCn += sm.aqc[k];
          ++M;
        }
      }
      so[h] = SlotOut<T>{rg::region_finish(S_, MX, MY, M, areaP, areaQ), NX, NY,
                         PL, PCn, QCn, M};
      if (r < C) sm.rarea[r] = so[h].reg.area;
    }
    __syncwarp();
    T cross_area = T(0);
    if (lane == 0)
      for (int r = 0; r < C; ++r) cross_area += sm.rarea[r];
    cross_area = __shfl_sync(kFull, cross_area, 0);
    if (first) SZ_STAMP(7);

    // ---- 7. containment: lanes over the edges of each ring ---------------
    bool p_in_q = false, q_in_p = false;
    if (count == 0) {  // uniform over the warp
      bool hq = false, oq = false, hpp = false, op = false;
      for (int e = lane; e < nq; e += 32) {
        const int e2 = sz::next_vertex(e, nq);
        const rg::PipEdge d = rg::pip_edge(sm.px[0], sm.py[0], sm.qx[e],
                                           sm.qy[e], sm.qx[e2], sm.qy[e2]);
        hq ^= d.hit;
        oq = oq || d.on_edge;
      }
      for (int e = lane; e < np; e += 32) {
        const int e2 = sz::next_vertex(e, np);
        const rg::PipEdge d = rg::pip_edge(sm.qx[0], sm.qy[0], sm.px[e],
                                           sm.py[e], sm.px[e2], sm.py[e2]);
        hpp ^= d.hit;
        op = op || d.on_edge;
      }
      p_in_q = (__popc(__ballot_sync(kFull, hq)) & 1) == 1 ||
               __ballot_sync(kFull, oq) != 0;
      q_in_p = (__popc(__ballot_sync(kFull, hpp)) & 1) == 1 ||
               __ballot_sync(kFull, op) != 0;
    }
    const T tot =
        rg::total_area(count, cross_area, p_in_q, q_in_p, areaP, areaQ);
    if (first) SZ_STAMP(8);

    // ---- the row's output: lanes r, r + 32 write slot r ------------------
    const bool again = first && overflow && retry_rows > 0;
    if (first) {
      store_row(out, in.R, cap, row, lane, C, so, tot, overflow, sm);
      if (lane == 0)
        rg::out_views<T>(out, in.R, cap).parity_bad[row] = overflow ? 1 : 0;
      if (again)  // kept for the odd rows past the first 16
        store_row(scratch, in.R, cap, row, lane, C, so, tot, overflow, sm);
    } else {
      if (!overflow)  // a retry that stays odd writes nothing
        store_row(out, in.R, cap, row, lane, C, so, tot, overflow, sm);
      if (lane == 0) resolved[row] = overflow ? 0 : 1;
    }
    if (first) SZ_STAMP(9);
    if (!again) break;  // uniform
    __syncwarp();  // the retry rewrites the Q ring and the crossing arrays
  }
  return odd;
}

template <typename T, int VM, int CM>
__global__ void __launch_bounds__(32 * kMaxWarpsPerBlock)
regions_kernel(Inputs in, T retry_scale, int retry_rows, void* out,
               void* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + w;
  if (row >= in.R) return;  // the whole warp leaves together
  long long stamp[kClockSlots];
  (void)stamp;
  SZ_STAMP(0);
  const rg::Out<T> o = rg::out_views<T>(out, in.R, in.cap);
  unsigned char* resolved =
      static_cast<unsigned char*>(scratch) +
      rg::out_bytes(in.R, in.cap, static_cast<int>(sizeof(T)));
  // the launch's ticket, when it retries: rows done in the low 32 bits, odd
  // rows among them in the high 32 (zeroed by the launch)
  unsigned long long* ticket = reinterpret_cast<unsigned long long*>(
      static_cast<unsigned char*>(scratch) +
      rg::ticket_offset(in.R, in.cap, static_cast<int>(sizeof(T))));
  const long long n_slow = *in.n_slow;
  const int live =
      n_slow <= 0 ? 0 : (n_slow < in.R ? static_cast<int>(n_slow) : in.R);
  const long long sel = in.ssel[row];
  bool clip = rg::sel_live(row, n_slow, sel, in.PC);
  long long i = 0, j = 0;
  if (clip) {
    i = in.qi[sel];
    j = in.qj[sel];
    clip = rg::pair_live(i, j, in.N, in.NQ);
  }
  bool odd = false;
  if (!clip) {  // uniform over the warp
    write_zero_row(o, row, in.cap, lane);
  } else {
    Scratch<T, VM, CM>& sm = reinterpret_cast<Scratch<T, VM, CM>*>(smem)[w];
    odd = clip_row<T, VM, CM>(in, out, scratch, resolved, row, sel, i, j,
                              retry_scale, retry_rows, lane, sm, stamp);
#ifdef SZ_REGIONS_CLOCK
    if (in.clk != nullptr && lane == 0) {
      long long* c = in.clk + static_cast<long long>(row) * kClockSlots;
      for (int k = 0; k < kClockSlots - 1; ++k) c[k] = stamp[k + 1] - stamp[k];
      c[kClockSlots - 1] = odd && retry_rows > 0 ? clock64() - stamp[9] : 0;
    }
#endif
  }
  if (retry_rows > 0 && row < live) {
    // this row's results are out: take the ticket, counting an odd row
    __threadfence();
    __syncwarp();
    unsigned long long before = 0;
    if (lane == 0)
      before = atomicAdd(ticket, (odd ? 1ull << 32 : 0ull) + 1ull);
    before = __shfl_sync(kFull, before, 0);
    if (static_cast<unsigned>(before) == static_cast<unsigned>(live - 1)) {
      // the last row: every row is out; more odd rows than the JAX rule
      // retries (rare) take back their first result past the first 16
      const unsigned n_odd = static_cast<unsigned>(before >> 32) + (odd ? 1u : 0u);
      if (n_odd > static_cast<unsigned>(retry_rows)) {
        __threadfence();
        const rg::Out<T> o2 = rg::out_views<T>(scratch, in.R, in.cap);
        undo_late_retries(o, o2, resolved, live, retry_rows, in.cap, lane);
      }
    }
  }
}

// One size class's launch: as many warps a block (up to 4) as its scratch
// lets fit the shared memory, beyond 48 KB by opting in.
template <typename T, int VM, int CM>
int launch_class(const Inputs& in, T retry_scale, int retry_rows, void* out,
                 void* scratch, cudaStream_t s) {
  constexpr size_t per_warp = sizeof(Scratch<T, VM, CM>);
  int wpb = kMaxWarpsPerBlock;
  while (wpb > 1 && wpb * per_warp > kSmemLimit) --wpb;
  const size_t smem = wpb * per_warp;
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        regions_kernel<T, VM, CM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (in.R + wpb - 1) / wpb;
  regions_kernel<T, VM, CM><<<blocks, 32 * wpb, smem, s>>>(
      in, retry_scale, retry_rows, out, scratch);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Inputs& in, T retry_scale, int retry_rows, void* out,
           void* scratch, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in.V > rg::kMaxVerts || in.W > rg::kMaxVerts || in.cap > rg::kMaxCap)
    return static_cast<int>(cudaErrorInvalidValue);
  if (in.R <= 0) return static_cast<int>(cudaGetLastError());
  if (retry_rows > 0) {
    void* ticket = static_cast<unsigned char*>(scratch) +
                   rg::ticket_offset(in.R, in.cap, static_cast<int>(sizeof(T)));
    const cudaError_t err = cudaMemsetAsync(ticket, 0, 8, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (in.V <= 32 && in.W <= 32 && in.cap <= 32)
    return launch_class<T, 32, 32>(in, retry_scale, retry_rows, out, scratch, s);
  return launch_class<T, rg::kMaxVerts, rg::kMaxCap>(in, retry_scale, retry_rows,
                                                     out, scratch, s);
}

Inputs inputs(const void* pverts, const int* pnv, int N, int V,
              const void* qverts, const int* qnv, int NQ, int W,
              const long long* qi, const long long* qj, const void* shift,
              const void* perturb, long long PC, const long long* ssel, int R,
              const long long* n_slow, int cap, long long* clk = nullptr) {
  return Inputs{pverts, pnv, N, V, qverts, qnv, NQ, W, qi, qj, shift,
                perturb, PC, ssel, R, n_slow, cap, clk};
}

__global__ void empty_kernel() {}

}  // namespace

// The clip of R slow rows and the retry of the first retry_rows rows whose
// parity came out odd, one launch on ``stream`` (after zeroing the ticket,
// when it retries).  ``scratch``: the retry's rows (out_views' layout for R
// rows), R bytes of flags and the ticket (ticket_offset).
extern "C" int sz_regions_f32(const float* pverts, const int* pnv, int N,
                              int V, const float* qverts, const int* qnv,
                              int NQ, int W, const long long* qi,
                              const long long* qj, const float* shift,
                              const float* perturb, long long PC,
                              const long long* ssel, int R,
                              const long long* n_slow, int cap,
                              float retry_scale, int retry_rows, void* out,
                              void* scratch, void* stream) {
  return launch<float>(inputs(pverts, pnv, N, V, qverts, qnv, NQ, W, qi, qj,
                              shift, perturb, PC, ssel, R, n_slow, cap),
                       retry_scale, retry_rows, out, scratch, stream);
}

extern "C" int sz_regions_f64(const double* pverts, const int* pnv, int N,
                              int V, const double* qverts, const int* qnv,
                              int NQ, int W, const long long* qi,
                              const long long* qj, const double* shift,
                              const double* perturb, long long PC,
                              const long long* ssel, int R,
                              const long long* n_slow, int cap,
                              double retry_scale, int retry_rows, void* out,
                              void* scratch, void* stream) {
  return launch<double>(inputs(pverts, pnv, N, V, qverts, qnv, NQ, W, qi, qj,
                               shift, perturb, PC, ssel, R, n_slow, cap),
                        retry_scale, retry_rows, out, scratch, stream);
}

#ifdef SZ_REGIONS_CLOCK
// The same launch with the per-phase clock stamps written to clk [R, 10].
extern "C" int sz_regions_clocked_f32(
    const float* pverts, const int* pnv, int N, int V, const float* qverts,
    const int* qnv, int NQ, int W, const long long* qi, const long long* qj,
    const float* shift, const float* perturb, long long PC,
    const long long* ssel, int R, const long long* n_slow, int cap,
    float retry_scale, int retry_rows, void* out, void* scratch,
    long long* clk, void* stream) {
  return launch<float>(inputs(pverts, pnv, N, V, qverts, qnv, NQ, W, qi, qj,
                              shift, perturb, PC, ssel, R, n_slow, cap, clk),
                       retry_scale, retry_rows, out, scratch, stream);
}

extern "C" int sz_regions_clocked_f64(
    const double* pverts, const int* pnv, int N, int V, const double* qverts,
    const int* qnv, int NQ, int W, const long long* qi, const long long* qj,
    const double* shift, const double* perturb, long long PC,
    const long long* ssel, int R, const long long* n_slow, int cap,
    double retry_scale, int retry_rows, void* out, void* scratch,
    long long* clk, void* stream) {
  return launch<double>(inputs(pverts, pnv, N, V, qverts, qnv, NQ, W, qi, qj,
                               shift, perturb, PC, ssel, R, n_slow, cap, clk),
                        retry_scale, retry_rows, out, scratch, stream);
}
#endif

// An empty kernel on the same stream: the floor of any launch's time.
// This and the error string carry two_cross.cu's names, so one binding
// (two_cross.py:bind_common) serves both libraries.
extern "C" int sz_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
