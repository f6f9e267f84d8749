// CPU build of the cell clip's arithmetic (cell_clip.cuh), loaded with ctypes
// by the CPU tests so that the code the card runs is held to the plain
// PyTorch version and the JAX package:
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC
//       -o libcell_clip_host.so cell_clip_host.cpp
//
// Same arguments as the CUDA library (cell_clip.cu) without the stream; the
// floes and their window cells run one after another.
#include "cell_clip.cuh"

namespace {

template <typename T>
void run(const sz::cell_clip::Args<T>* a) {
  const int A = a->A, B = a->B;
  for (long long n = 0; n < a->N; ++n) {
    const int nv = a->nverts[n] < a->V ? a->nverts[n] : a->V;
    const T* xy = a->verts + n * a->V * 2;
    long long cells = 0;
    for (int i = 0; i < A; ++i) {
      for (int j = 0; j < B; ++j) {
        T* out = a->out + (n * A + i) * B + j;
        if (!(a->okx[n * A + i] && a->oky[n * B + j])) {
          *out = T(0);
          continue;
        }
        *out = sz::cell_clip::cell_area(xy, nv, a->xmin[n * A + i], a->xmax[n * A + i],
                                        a->ymin[n * B + j], a->ymax[n * B + j]);
        ++cells;
      }
    }
    if (a->count != nullptr) *a->count += cells;
  }
}

}  // namespace

extern "C" void sz_cell_clip_host_f32(const sz::cell_clip::Args<float>* a) {
  run<float>(a);
}

extern "C" void sz_cell_clip_host_f64(const sz::cell_clip::Args<double>* a) {
  run<double>(a);
}
