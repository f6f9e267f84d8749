// Per-cell arithmetic of the coupling's cell clip (B6): the ice area of a
// floe inside one cell of its coupling window.
//
// The same math, in the same operation order, as the plain PyTorch version
// subzero_tpu_torch/physics/coupling.py:_clip_area_to_rects (the closed-form
// clamped-image shoelace; the JAX package's is
// subzero_tpu/physics/coupling.py:_clip_area_to_rects).  Each PyTorch
// operation rounds once, and a Python scalar is cast to the working type T
// before the operation that takes it, so every line of edge_term is one
// PyTorch operation on values of type T: the same divisions by dxs / dys,
// the same clamps to [0, 1], the same sort network of the four crossing
// parameters, the same six clamped points and the same chain of five cross
// products.  minimum / maximum / clamp propagate a NaN as PyTorch's do.
//
// The sum over a ring's edges groups its terms as torch.sum(x, dim=1) does
// on CUDA over the plain version's [N, V, cells] tensor, a reduction over a
// dimension that is not the innermost (ATen/native/cuda/Reduce.cuh): one
// thread an output, its V inputs in order into vt0 = 4 interleaved
// accumulators (edge k into accumulator k % 4, each starting from 0), then
// ((a0 + a1) + a2) + a3.  A padded edge (k >= nverts) adds an exact zero
// there (its term times 0), so the walk stops at nverts with the same bits.
// PyTorch's CPU build groups the same sum otherwise (a cascade over blocks
// of rows), so on the CPU the plain version and this header part in the
// last bits; the CPU tests hold this header to the plain version's own
// terms summed in the card's order (tests/test_torch_cell_clip.py).
//
// The CUDA kernel (cell_clip.cu) gives a warp to a floe and a lane to each
// of its cells that the window's mask keeps; the CPU shim
// (cell_clip_host.cpp, built by g++ for the CPU tests) walks the same cells
// one after another.  Build both without floating-point contraction (nvcc
// --fmad=false, g++ -ffp-contract=off).
#pragma once

#ifndef SZ_HD
#ifdef __CUDACC__
#define SZ_HD __host__ __device__ __forceinline__
#else
#define SZ_HD inline
#endif
#endif

namespace sz {
namespace cell_clip {

// Everything a launch reads and writes; the Python binding
// (physics/cell_clip.py) mirrors this layout with ctypes.  A window is A
// columns by B rows of cells; its rects are separable, so a floe's cell
// (i, j) spans [xmin[i], xmax[i]] x [ymin[j], ymax[j]] and is kept where
// okx[i] and oky[j] both hold.
template <typename T>
struct Args {
  const T* verts;            // [N, V, 2] rings (padded)
  const int* nverts;         // [N]
  const T* xmin;             // [N, A]
  const T* xmax;             // [N, A]
  const T* ymin;             // [N, B]
  const T* ymax;             // [N, B]
  const unsigned char* okx;  // [N, A]
  const unsigned char* oky;  // [N, B]
  T* out;                    // [N, A, B] area in each cell, 0 where not kept
  long long* count;          // cells clipped are added here (or null)
  int N, V, A, B;
};

template <typename T>
SZ_HD T minimum(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

template <typename T>
SZ_HD T maximum(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return b > a ? b : a;
}

// torch.clamp(v, 0.0, 1.0)
template <typename T>
SZ_HD T clamp01(T v) {
  if (v != v) return v;
  return minimum(maximum(v, T(0)), T(1));
}

// One clamped point of an edge: pt(t) of the plain version.
template <typename T>
SZ_HD void clamped_point(T x1, T y1, T dx, T dy, T t, T x0c, T x1c, T y0c, T y1c,
                         T* px, T* py) {
  const T ax = t * dx;
  const T bx = x1 + ax;
  *px = minimum(maximum(bx, x0c), x1c);
  const T ay = t * dy;
  const T by = y1 + ay;
  *py = minimum(maximum(by, y0c), y1c);
}

// The shoelace term of edge (x1, y1) -> (x2, y2) clamped to the rect
// [x0c, x1c] x [y0c, y1c]: acc of the plain version for one (edge, cell).
template <typename T>
SZ_HD T edge_term(T x1, T y1, T x2, T y2, T x0c, T x1c, T y0c, T y1c) {
  const T dx = x2 - x1;
  const T dy = y2 - y1;
  const T dxs = dx == T(0) ? T(1) : dx;
  const T dys = dy == T(0) ? T(1) : dy;
  const T ta = clamp01((x0c - x1) / dxs);
  const T tb = clamp01((x1c - x1) / dxs);
  const T tc = clamp01((y0c - y1) / dys);
  const T td = clamp01((y1c - y1) / dys);
  // 4-value sort network
  const T lo1 = minimum(ta, tb), hi1 = maximum(ta, tb);
  const T lo2 = minimum(tc, td), hi2 = maximum(tc, td);
  const T t1 = minimum(lo1, lo2);
  const T t4 = maximum(hi1, hi2);
  const T m1 = maximum(lo1, lo2), m2 = minimum(hi1, hi2);
  const T t2 = minimum(m1, m2);
  const T t3 = maximum(m1, m2);
  const T ts[5] = {t1, t2, t3, t4, T(1)};
  T prev_x, prev_y;
  clamped_point(x1, y1, dx, dy, T(0), x0c, x1c, y0c, y1c, &prev_x, &prev_y);
  T acc = T(0);
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    T cur_x, cur_y;
    clamped_point(x1, y1, dx, dy, ts[s], x0c, x1c, y0c, y1c, &cur_x, &cur_y);
    const T p = prev_x * cur_y;
    const T q = cur_x * prev_y;
    const T cr = p - q;
    acc = s == 0 ? cr : acc + cr;
    prev_x = cur_x;
    prev_y = cur_y;
  }
  return acc;
}

// Edge k of a ring of nv vertices (xy: its x, y pairs): vertex k to k + 1,
// the last to vertex 0, as the plain version's roll and wrap give it.
template <typename T>
SZ_HD T ring_edge_term(const T* xy, int nv, int k, T x0c, T x1c, T y0c, T y1c) {
  const int k2 = k == nv - 1 ? 0 : k + 1;
  return edge_term(xy[2 * k], xy[2 * k + 1], xy[2 * k2], xy[2 * k2 + 1], x0c, x1c,
                   y0c, y1c);
}

// The area of a ring of nv real vertices inside the rect: its edges' terms
// summed in torch.sum's CUDA order, halved, its absolute value, and 0 where
// that is not above 0 (the coupling's torch.where(pair_ok & (area > 0),
// area, 0.0)).
template <typename T>
SZ_HD T cell_area(const T* xy, int nv, T x0c, T x1c, T y0c, T y1c) {
  T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
  int k = 0;
  for (; k + 4 <= nv; k += 4) {
    a0 = a0 + ring_edge_term(xy, nv, k, x0c, x1c, y0c, y1c);
    a1 = a1 + ring_edge_term(xy, nv, k + 1, x0c, x1c, y0c, y1c);
    a2 = a2 + ring_edge_term(xy, nv, k + 2, x0c, x1c, y0c, y1c);
    a3 = a3 + ring_edge_term(xy, nv, k + 3, x0c, x1c, y0c, y1c);
  }
  if (k < nv) a0 = a0 + ring_edge_term(xy, nv, k, x0c, x1c, y0c, y1c);
  if (k + 1 < nv) a1 = a1 + ring_edge_term(xy, nv, k + 1, x0c, x1c, y0c, y1c);
  if (k + 2 < nv) a2 = a2 + ring_edge_term(xy, nv, k + 2, x0c, x1c, y0c, y1c);
  const T s = ((a0 + a1) + a2) + a3;
  const T area = T(0.5) * s;
  const T mag = area < T(0) ? -area : area;  // torch.abs, up to a zero's sign
  return mag > T(0) ? mag : T(0);
}

}  // namespace cell_clip
}  // namespace sz
