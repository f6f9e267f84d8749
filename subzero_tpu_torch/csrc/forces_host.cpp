// CPU build of the force law's arithmetic (forces.cuh), loaded with ctypes by
// the CPU tests so that the code the card runs is held to the plain PyTorch
// version and the JAX package:
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC
//       -o libforces_host.so forces_host.cpp
//
// Same arguments as the CUDA library (forces.cu) without the stream; the
// work items run one after another.  ``card_div`` 1 takes PyTorch's CUDA
// rule for a tensor divided by a Python scalar (times its reciprocal), 0 its
// CPU rule (a division).
#include "forces.cuh"

namespace {

template <typename T>
void run(const sz::forces::Args<T>* a, int card_div) {
  const long long n = sz::forces::work_items(*a);
  for (long long t = 0; t < n; ++t) sz::forces::work_item(*a, t, card_div != 0);
}

}  // namespace

extern "C" void sz_forces_host_f32(const sz::forces::Args<float>* a, int card_div) {
  run<float>(a, card_div);
}

extern "C" void sz_forces_host_f64(const sz::forces::Args<double>* a, int card_div) {
  run<double>(a, card_div);
}
