// CUDA kernel of the force law (B4, sm_90a): the step's contact forces and
// the fuse / remove marking of its candidate rows, in one launch.
//
// Replaces the elementwise chain of subzero_tpu_torch/physics/collisions.py
// between the narrow phase's slow clip and the contact sums (the overlap
// totals, the fuse / remove marking, _fast_regions and both _region_forces),
// which PyTorch ran as ~380 small kernels a step and XLA fused into one TPU
// program in the JAX package.  A thread a work item (forces.cuh): a candidate
// row of the narrow phase's list (one region, B1's result), or a region of a
// slow row (the slow clip's CAP regions, B2's result).  The items read only
// inputs, never each other's outputs, so the marking that gates a slow row's
// force is computed again by that row's threads, with the same operations as
// the candidate row's own thread, rather than passed between launches.
//
// What bounds it on the H100: a candidate row reads ~130 B (its indices,
// shift, B1's row, two floes' scalars) and writes 15 B; ~4 300 rows and
// ~500 slow regions at 500 floes make ~0.7 MB, 0.2 us at the memory rate,
// and ~150 operations a row.  So the launch and one row's dependent chain
// (index -> floe -> arithmetic -> store) set its time.
//
// Built without FMA contraction (--fmad=false, two_cross.py's flags) so
// each operation rounds as PyTorch's elementwise kernels do: the outputs
// equal the plain version's on the card to the bit.
#include <cuda_runtime.h>

#include "forces.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads) forces_kernel(const sz::forces::Args<T> a) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t < sz::forces::work_items(a)) sz::forces::work_item(a, t, /*card_div=*/true);
}

template <typename T>
int launch(const sz::forces::Args<T>* a, void* stream) {
  const long long n = sz::forces::work_items(*a);
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    forces_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(*a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sz_forces_f32(const sz::forces::Args<float>* a, void* stream) {
  return launch<float>(a, stream);
}

extern "C" int sz_forces_f64(const sz::forces::Args<double>* a, void* stream) {
  return launch<double>(a, stream);
}
