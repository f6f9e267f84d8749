// CUDA kernel of the coupling's cell clip (B6, sm_90a): the ice area of
// every floe in every cell of its coupling window, in one launch.
//
// Replaces the plain PyTorch body of subzero_tpu_torch/physics/coupling.py
// :_clip_area_to_rects on the card, which ran ~95 elementwise kernels over
// [N, V, A x B] tensors (0.9 GB each at 16 000 floes, 32-vertex rings and a
// 21 x 21 window, some two dozen of them alive at once), and which XLA
// fused into one TPU program in the JAX package
// (subzero_tpu/physics/coupling.py:_clip_area_to_rects, no Pallas kernel).
// A warp a floe: it writes 0 in each window cell that the mask drops (the
// plain version's where), then takes the kept cells, okx[i] and oky[j] of
// the separable mask compacted by ballot, a lane a cell, and each lane walks
// the floe's ring against its rect (cell_clip.cuh).  Nothing of size
// [N, V, A x B] exists; the rects come in as [N, A] and [N, B] vectors.
// Each warp counts its floe's kept cells and one 64-bit integer atomic a
// block adds them to the caller's counter (integer adds: the same total in
// any order).
//
// What bounds it on the H100.  It reads each kept floe's ring once
// (16 000 x 32 vertices x 8 B = 4 MB in f32), the rect vectors and masks,
// and writes the [N, A, B] areas (28 MB at 16 000 floes and A = B = 21):
// ~10 us at the memory rate.  The arithmetic is ~90 operations (four
// divisions among them) for each kept cell and real edge of its ring: only
// the cells in the floe's bounding circle are kept (~5 a side at that
// field's floe size, a few per cent of the window), so a few million
// edge-cell terms, tens of microseconds at most.  So the launch, the
// ballots and one lane's ring walk (its edges one after another, as the
// plain version's sum groups them) set its time.
//
// Built without FMA contraction (--fmad=false, two_cross.py's flags) and
// with IEEE division, so each operation rounds as PyTorch's elementwise
// kernels do: the areas equal the plain version's on the card to the bit.
#include <cuda_runtime.h>

#include "cell_clip.cuh"

namespace {

constexpr int kWarps = 8;  // floes a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// The position of the (r + 1)-th set bit of m (r < popc(m)).
__device__ __forceinline__ int nth_set_bit(unsigned m, int r) {
  for (int s = 0; s < r; ++s) m &= m - 1;
  return __ffs(m) - 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) cell_clip_kernel(const sz::cell_clip::Args<T> a) {
  __shared__ unsigned long long block_cells;
  if (threadIdx.x == 0) block_cells = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long n = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (n < a.N) {  // the whole warp, or none of it
    const int A = a.A, B = a.B;
    const unsigned char* okx = a.okx + n * A;
    const unsigned char* oky = a.oky + n * B;
    const T* xmin = a.xmin + n * A;
    const T* xmax = a.xmax + n * A;
    const T* ymin = a.ymin + n * B;
    const T* ymax = a.ymax + n * B;
    T* out = a.out + n * A * B;
    for (int c = lane; c < A * B; c += 32) {
      const int i = c / B;
      if (!(okx[i] && oky[c - i * B])) out[c] = T(0);
    }
    const int nv = a.nverts[n] < a.V ? a.nverts[n] : a.V;
    const T* xy = a.verts + n * a.V * 2;
    unsigned long long cells = 0;
    for (int i0 = 0; i0 < A; i0 += 32) {
      const unsigned bx = __ballot_sync(kFull, i0 + lane < A && okx[i0 + lane]);
      if (bx == 0) continue;
      const int cx = __popc(bx);
      for (int j0 = 0; j0 < B; j0 += 32) {
        const unsigned by = __ballot_sync(kFull, j0 + lane < B && oky[j0 + lane]);
        if (by == 0) continue;
        const int cy = __popc(by);
        for (int t = lane; t < cx * cy; t += 32) {
          const int p = t / cy;
          const int i = i0 + nth_set_bit(bx, p);
          const int j = j0 + nth_set_bit(by, t - p * cy);
          out[i * B + j] = sz::cell_clip::cell_area(xy, nv, xmin[i], xmax[i], ymin[j], ymax[j]);
        }
        cells += static_cast<unsigned long long>(cx) * cy;
      }
    }
    if (lane == 0 && cells != 0) atomicAdd(&block_cells, cells);
  }
  __syncthreads();
  if (threadIdx.x == 0 && a.count != nullptr && block_cells != 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(a.count), block_cells);
  }
}

template <typename T>
int launch(const sz::cell_clip::Args<T>* a, void* stream) {
  if (a->N > 0) {
    const long long blocks = (static_cast<long long>(a->N) + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    cell_clip_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(*a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sz_cell_clip_f32(const sz::cell_clip::Args<float>* a, void* stream) {
  return launch<float>(a, stream);
}

extern "C" int sz_cell_clip_f64(const sz::cell_clip::Args<double>* a, void* stream) {
  return launch<double>(a, stream);
}
