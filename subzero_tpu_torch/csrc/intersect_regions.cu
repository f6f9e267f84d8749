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
// semantics are decided on the device, inside one launch, with no host read:
//   * regions_clip_kernel gives a warp to each of the R = slow_cap rows; a
//     row at or past min(n_slow, R) (n_slow read from device memory) writes
//     zeros and returns, so a step with no slow row is one near-empty
//     launch;
//   * regions_retry_kernel gives a warp to each of the first 16 rows whose
//     parity came out odd: warp w finds the w-th set flag of parity_bad (a
//     ballot scan over the min(n_slow, R) clipped rows' flags, none when no
//     row is slow), clips that row again with the perturbation
//     scaled, and where the retry resolves writes its result over the
//     row's.  parity_bad is written by the clip and only read here, and
//     every warp writes its own row, so the merge is deterministic.
// The per-row arithmetic and the order of every reduction are in
// intersect_regions.cuh.
//
// What bounds it on the H100.  A live row reads two rings of at most 256 B
// (f32, 32 vertices), its indices, shift and perturbation, and writes
// CAP x 14 values + 3 (~1 KB at CAP 16 in f32); it runs pn x qn crossing
// tests of ~25 operations (~8 x 8 edge pairs on a typical pair), then work
// in CAP^2 (ranks, pointers, region sums).  A step has a few to a few
// hundred live rows, so bytes and operations are both microseconds or less:
// the kernel is bound by latency, one row's dependent chain (a serial
// prefix sum of 2n terms, the rank loops, the doubling rounds), and by the
// launch.
//
// What the design does about it:
//   * A warp a row, as B1 (two_cross.cu) does.  Lane j owns Q edge j; the
//     loop over P edges tests (i, j) for all j at once, a ballot finds the
//     hits and a popc prefix over the ballots puts each crossing into its
//     slot of the flat (i, j) order.  Lane k then owns crossing k: its rank
//     along each ring by counting over shuffles, its next pointers by
//     matching ranks, the pointer doubling by shuffles; lane r sums region
//     r over the crossings in ascending order.
//   * The rings are gathered here from the pools (the floe pool, and the
//     Q pool of floes, walls and topography) through the slow selection
//     ssel; no ring batch is materialised.  Each warp keeps its rings, the
//     prefix sums and its crossings in its own ~8 KB (f64) of shared memory.
//   * Rows past n_slow do no work, the retry rows find their targets on
//     the device, and nothing is read on the host, so the step stays one
//     CUDA graph and the eager step makes two launches instead of the plain
//     version's ~1 500.
//   * No float atomics: two runs give the same bits, the bits of the
//     serial CPU shim (intersect_regions_host.cpp).
//
// Build (plain C interface, loaded with ctypes; see geometry/regions.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -o libregions.so intersect_regions.cu
#include <cuda_runtime.h>

#include "intersect_regions.cuh"

namespace {

namespace rg = sz::regions;

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr unsigned kFull = 0xffffffffu;

// One warp's scratch.
template <typename T>
struct Scratch {
  T px[rg::kMaxVerts], py[rg::kMaxVerts], qx[rg::kMaxVerts], qy[rg::kMaxVerts];
  T preP[4 * rg::kPre], preQ[4 * rg::kPre];
  T cx[rg::kMaxCap], cy[rg::kMaxCap], ct[rg::kMaxCap], cu[rg::kMaxCap];
  int ce[rg::kMaxCap], cf[rg::kMaxCap];
  bool cfp[rg::kMaxCap];
  T as[rg::kMaxCap], amx[rg::kMaxCap], amy[rg::kMaxCap], anx[rg::kMaxCap],
      any_[rg::kMaxCap], apl[rg::kMaxCap];
  int apc[rg::kMaxCap], aqc[rg::kMaxCap], seg[rg::kMaxCap];
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
};

// Row ``row`` of the output: zeros, no region, no overflow.
template <typename T>
__device__ void write_zero_row(const rg::Out<T>& o, int row, int cap,
                               int lane) {
  const long long base = static_cast<long long>(row) * cap;
  if (lane < cap) {
    const long long s = base + lane;
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

// The clip of one live row by its warp, written into the row; a retry
// (``retry``) that overflows again writes nothing, so the row keeps the
// first clip's result, and never writes parity_bad.
template <typename T>
__device__ void clip_row(const Inputs& in, const rg::Out<T>& o, int row,
                         long long sel, T pscale, bool retry, int lane,
                         Scratch<T>& sm) {
  const T* pverts = static_cast<const T*>(in.pverts);
  const T* qverts = static_cast<const T*>(in.qverts);
  const T* shift = static_cast<const T*>(in.shift);
  const T* perturb = static_cast<const T*>(in.perturb);
  const int cap = in.cap;
  const long long i = in.qi[sel];
  const long long j = in.qj[sel];
  const int np = sz::clamp_count(in.pnv[i], in.V);
  const int nq = sz::clamp_count(in.qnv[j], in.W);
  const T pert = perturb[sel] * pscale;
  const T ox = sz::perturb_x(pert), oy = pert;
  const T shx = shift[2 * sel], shy = shift[2 * sel + 1];

  // ---- the two rings into shared memory; lane l holds vertex l ---------
  if (lane < in.V) {
    sm.px[lane] = pverts[(i * in.V + lane) * 2];
    sm.py[lane] = pverts[(i * in.V + lane) * 2 + 1];
  }
  if (lane < in.W) {
    sm.qx[lane] = sz::q_coord(qverts[(j * in.W + lane) * 2], shx, ox);
    sm.qy[lane] = sz::q_coord(qverts[(j * in.W + lane) * 2 + 1], shy, oy);
  }
  __syncwarp();

  // ---- 1-2. crossings: lane j tests Q edge j against P edge i ----------
  const bool qlive = lane < nq;
  const int j2 = qlive ? sz::next_vertex(lane, nq) : lane;
  const T qax = sm.qx[lane], qay = sm.qy[lane];
  const T sx = sm.qx[j2] - qax, sy = sm.qy[j2] - qay;
  const unsigned below = (1u << lane) - 1u;
  int count = 0;
  for (int e = 0; e < np; ++e) {
    const int e2 = sz::next_vertex(e, np);
    const T pax = sm.px[e], pay = sm.py[e];
    const T rx = sm.px[e2] - pax, ry = sm.py[e2] - pay;
    const sz::Crossing<T> x =
        sz::edge_crossing(pax, pay, rx, ry, qax, qay, sx, sy);
    const bool hit = qlive && x.hit;
    const unsigned hits = __ballot_sync(kFull, hit);
    if (hit) {
      const int slot = count + __popc(hits & below);
      if (slot < cap) {
        sm.cx[slot] = pax + x.t * rx;
        sm.cy[slot] = pay + x.t * ry;
        sm.ct[slot] = x.t;
        sm.cu[slot] = x.u;
        sm.ce[slot] = e;
        sm.cf[slot] = lane;
        sm.cfp[slot] = x.denom < T(0);
      }
    }
    count += __popc(hits);
  }
  // the prefix sums of both rings, one lane a ring
  T shoe = T(0);
  if (lane == 0) shoe = rg::ring_sums(sm.px, sm.py, np, sm.preP);
  if (lane == 1) shoe = rg::ring_sums(sm.qx, sm.qy, nq, sm.preQ);
  __syncwarp();
  const T areaP = sz::ring_area(__shfl_sync(kFull, shoe, 0));
  const T areaQ = sz::ring_area(__shfl_sync(kFull, shoe, 1));
  const int C = count < cap ? count : cap;
  const bool overflow = rg::overflowed(count, cap);

  // ---- 3. lane k owns crossing k: ranks and next pointers --------------
  const bool valid = lane < C;
  rg::Cross<T> c{T(0), T(0), T(0), T(0), 0, 0, false};
  if (valid)
    c = rg::Cross<T>{sm.cx[lane], sm.cy[lane], sm.ct[lane], sm.cu[lane],
                     sm.ce[lane], sm.cf[lane], sm.cfp[lane]};
  const T keyP = T(c.e) + c.t, keyQ = T(c.f) + c.u;
  int rankP = 0, rankQ = 0;
  for (int m = 0; m < C; ++m) {
    const T kpm = __shfl_sync(kFull, keyP, m);
    const T kqm = __shfl_sync(kFull, keyQ, m);
    rankP += rg::rank_before(kpm, m, keyP, lane) ? 1 : 0;
    rankQ += rg::rank_before(kqm, m, keyQ, lane) ? 1 : 0;
  }
  int nxtP = lane, nxtQ = lane;
  const int wantP = C > 0 ? (rankP + 1) % C : 0;
  const int wantQ = C > 0 ? (rankQ + 1) % C : 0;
  for (int m = 0; m < C; ++m) {
    const int rpm = __shfl_sync(kFull, rankP, m);
    const int rqm = __shfl_sync(kFull, rankQ, m);
    if (valid && rpm == wantP) nxtP = m;
    if (valid && rqm == wantQ) nxtQ = m;
  }

  // ---- 4. the outgoing arc of crossing k -------------------------------
  const int succ = valid ? (c.follow_p ? nxtP : nxtQ) : lane;
  if (valid) {
    const T x2 = sm.cx[succ], y2 = sm.cy[succ];
    const rg::Arc<T> a =
        c.follow_p
            ? rg::arc(sm.px, sm.py, np, sm.preP, c.x, c.y, c.e, c.t, x2, y2,
                      sm.ce[succ], sm.ct[succ])
            : rg::arc(sm.qx, sm.qy, nq, sm.preQ, c.x, c.y, c.f, c.u, x2, y2,
                      sm.cf[succ], sm.cu[succ]);
    const rg::ArcSums<T> s = rg::arc_sums(c, a, x2, y2);
    sm.as[lane] = s.s;
    sm.amx[lane] = s.mx;
    sm.amy[lane] = s.my;
    sm.anx[lane] = s.nx;
    sm.any_[lane] = s.ny;
    sm.apl[lane] = s.pl;
    sm.apc[lane] = s.pc;
    sm.aqc[lane] = s.qc;
  }

  // ---- 5. cycles: pointer doubling, least index labels -----------------
  int lbl = lane, s2 = succ;
  const int rounds = rg::label_rounds(cap);
  for (int r = 0; r < rounds; ++r) {
    const int l2 = __shfl_sync(kFull, lbl, s2);
    const int s3 = __shfl_sync(kFull, s2, s2);
    lbl = l2 < lbl ? l2 : lbl;
    s2 = s3;
  }
  if (valid) sm.seg[lane] = lbl;
  __syncwarp();

  // ---- 6. lane r sums region r over its crossings, ascending -----------
  T S = T(0), MX = T(0), MY = T(0), NX = T(0), NY = T(0), PL = T(0);
  int PCn = 0, QCn = 0, M = 0;
  for (int k = 0; k < C; ++k) {
    if (sm.seg[k] != lane) continue;
    S += sm.as[k];
    MX += sm.amx[k];
    MY += sm.amy[k];
    NX += sm.anx[k];
    NY += sm.any_[k];
    PL += sm.apl[k];
    PCn += sm.apc[k];
    QCn += sm.aqc[k];
    ++M;
  }
  const rg::Region<T> reg = rg::region_finish(S, MX, MY, M, areaP, areaQ);
  T cross_area = T(0);
  for (int r = 0; r < cap; ++r)
    cross_area += __shfl_sync(kFull, reg.area, r);

  // ---- 7. containment: lane e tests edge e of each ring ----------------
  bool p_in_q = false, q_in_p = false;
  if (count == 0) {  // uniform over the warp
    bool hq = false, oq = false, hp = false, op = false;
    if (lane < nq) {
      const sz::regions::PipEdge d =
          rg::pip_edge(sm.px[0], sm.py[0], sm.qx[lane], sm.qy[lane],
                       sm.qx[j2], sm.qy[j2]);
      hq = d.hit;
      oq = d.on_edge;
    }
    if (lane < np) {
      const int e2 = sz::next_vertex(lane, np);
      const sz::regions::PipEdge d =
          rg::pip_edge(sm.qx[0], sm.qy[0], sm.px[lane], sm.py[lane],
                       sm.px[e2], sm.py[e2]);
      hp = d.hit;
      op = d.on_edge;
    }
    p_in_q = (__popc(__ballot_sync(kFull, hq)) & 1) == 1 ||
             __ballot_sync(kFull, oq) != 0;
    q_in_p = (__popc(__ballot_sync(kFull, hp)) & 1) == 1 ||
             __ballot_sync(kFull, op) != 0;
  }
  const T total =
      rg::total_area(count, cross_area, p_in_q, q_in_p, areaP, areaQ);

  // ---- the row's output: lane r writes slot r --------------------------
  if (!(retry && overflow)) {
    const long long s = static_cast<long long>(row) * cap + lane;
    if (lane < cap) {
      const T ax = valid ? c.x : T(0), ay = valid ? c.y : T(0);
      const T bx = valid ? sm.cx[succ] : T(0);
      const T by = valid ? sm.cy[succ] : T(0);
      o.area[s] = reg.area;
      o.cent[2 * s] = reg.cx;
      o.cent[2 * s + 1] = reg.cy;
      o.cha[2 * s] = ax;
      o.cha[2 * s + 1] = ay;
      o.chb[2 * s] = bx;
      o.chb[2 * s + 1] = by;
      o.pnorm[2 * s] = NX;
      o.pnorm[2 * s + 1] = NY;
      o.plen[s] = PL;
      o.ncross[s] = M;
      o.pcnt[s] = PCn;
      o.qcnt[s] = QCn;
      o.valid[s] = reg.valid ? 1 : 0;
    }
    if (lane == 0) {
      o.total[row] = total;
      o.overflow[row] = overflow ? 1 : 0;
      if (!retry) o.parity_bad[row] = overflow ? 1 : 0;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
regions_clip_kernel(Inputs in, void* out) {
  __shared__ Scratch<T> scratch[kWarpsPerBlock];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarpsPerBlock + w;
  if (row >= in.R) return;  // the whole warp leaves together
  const rg::Out<T> o = rg::out_views<T>(out, in.R, in.cap);
  const long long n_slow = *in.n_slow;
  const long long sel = in.ssel[row];
  const bool live = rg::sel_live(row, n_slow, sel, in.PC) &&
                    rg::pair_live(in.qi[sel], in.qj[sel], in.N, in.NQ);
  if (!live) {  // uniform over the warp
    write_zero_row(o, row, in.cap, lane);
    return;
  }
  clip_row(in, o, row, sel, T(1), false, lane, scratch[w]);
}

// Warp w retries the w-th row (in row order) whose parity came out odd.
template <typename T>
__global__ void __launch_bounds__(kThreads)
regions_retry_kernel(Inputs in, T pscale, int retry_rows, void* out) {
  __shared__ Scratch<T> scratch[kWarpsPerBlock];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int want = blockIdx.x * kWarpsPerBlock + w;
  if (want >= retry_rows) return;
  const rg::Out<T> o = rg::out_views<T>(out, in.R, in.cap);
  // only the clipped rows, those before min(n_slow, R), can be odd
  const long long n_slow = *in.n_slow;
  const int live = n_slow < in.R ? static_cast<int>(n_slow) : in.R;
  int seen = 0, row = -1;
  for (int base = 0; base < live && row < 0; base += 32) {
    const int k = base + lane;
    const unsigned bad = __ballot_sync(kFull, k < live && o.parity_bad[k]);
    const int n = __popc(bad);
    if (want < seen + n) {
      unsigned m = bad;
      for (int skip = want - seen; skip > 0; --skip) m &= m - 1;
      row = base + __ffs(m) - 1;
    }
    seen += n;
  }
  if (row < 0) return;  // fewer odd rows than this warp's rank
  clip_row(in, o, row, in.ssel[row], pscale, true, lane, scratch[w]);
}

template <typename T>
int launch(const Inputs& in, T retry_scale, int retry_rows, void* out,
           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in.R > 0) {
    const int blocks = (in.R + kWarpsPerBlock - 1) / kWarpsPerBlock;
    regions_clip_kernel<T><<<blocks, kThreads, 0, s>>>(in, out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (retry_rows > 0) {
      const int rblocks = (retry_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
      regions_retry_kernel<T><<<rblocks, kThreads, 0, s>>>(in, retry_scale,
                                                           retry_rows, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

Inputs inputs(const void* pverts, const int* pnv, int N, int V,
              const void* qverts, const int* qnv, int NQ, int W,
              const long long* qi, const long long* qj, const void* shift,
              const void* perturb, long long PC, const long long* ssel, int R,
              const long long* n_slow, int cap) {
  return Inputs{pverts, pnv, N, V, qverts, qnv, NQ, W, qi, qj, shift,
                perturb, PC, ssel, R, n_slow, cap};
}

__global__ void empty_kernel() {}

}  // namespace

// The clip of R slow rows, then (retry_rows > 0) the retry of the first
// retry_rows rows whose parity came out odd; two launches on ``stream``.
extern "C" int sz_regions_f32(const float* pverts, const int* pnv, int N,
                              int V, const float* qverts, const int* qnv,
                              int NQ, int W, const long long* qi,
                              const long long* qj, const float* shift,
                              const float* perturb, long long PC,
                              const long long* ssel, int R,
                              const long long* n_slow, int cap,
                              float retry_scale, int retry_rows, void* out,
                              void* stream) {
  return launch<float>(inputs(pverts, pnv, N, V, qverts, qnv, NQ, W, qi, qj,
                              shift, perturb, PC, ssel, R, n_slow, cap),
                       retry_scale, retry_rows, out, stream);
}

extern "C" int sz_regions_f64(const double* pverts, const int* pnv, int N,
                              int V, const double* qverts, const int* qnv,
                              int NQ, int W, const long long* qi,
                              const long long* qj, const double* shift,
                              const double* perturb, long long PC,
                              const long long* ssel, int R,
                              const long long* n_slow, int cap,
                              double retry_scale, int retry_rows, void* out,
                              void* stream) {
  return launch<double>(inputs(pverts, pnv, N, V, qverts, qnv, NQ, W, qi, qj,
                               shift, perturb, PC, ssel, R, n_slow, cap),
                        retry_scale, retry_rows, out, stream);
}

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
