// Layer marks of the device step (sm_90a): tracing.py's device instrument.
//
// A mark is a kernel of one block that the step launches, and that a CUDA
// graph captures, at each boundary between two of the step's layers.  Its
// first thread reads the device's nanosecond clock (%globaltimer) as the
// mark starts, which in stream order is when the work before it has
// finished, adds the time since the previous mark to the accumulator of the
// layer that mark K closes, and stores the new time.  The last mark of a
// step also counts the step.  Two marks carry the step's work counters:
// one counts the candidate pairs (the broad phase's valid rows, one byte a
// row, summed by the block) and, on the binned broad phase, reads its slot
// tests and its fullest bin from the device; one reads the number of slow
// rows from the device.  Each adds to a sum and to the largest value since
// the caller last zeroed it.  A mark writes nothing but the accumulator buffer (tracing.py
// lays it out: SLOTS).
//
// The kernel is templated on K, so that each mark has its own name in a
// profiler's trace (subzero_mark<3>): a trace reader can put each device
// operation into the layer its two marks bracket.
//
// Build (plain C interface, loaded with ctypes; see tracing.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -o libmarks.so marks.cu
#include <cuda_runtime.h>

namespace {

// slots of the int64 buffer (tracing.py: SLOTS)
constexpr int kLayers = 7;       // 0 .. 6: nanoseconds by layer
constexpr int kLast = 7;         // the previous mark's time, 0 before any
constexpr int kSteps = 8;
constexpr int kPairs = 9;
constexpr int kSlow = 10;
constexpr int kBinTests = 11;
constexpr int kBinFill = 12;
constexpr int kMax = 4;          // a counter's largest value: its slot + 4
// slot 17 is the step's overflow count, slot 18 the window cells that the
// coupling's cell clip (cell_clip.cu) adds to itself: no mark writes them

constexpr int kCountThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

// Add ``v`` to counter ``slot`` and keep the largest value.
__device__ __forceinline__ void count(long long* acc, int slot, long long v) {
  acc[slot] += v;
  if (v > acc[slot + kMax]) acc[slot + kMax] = v;
}

}  // namespace

template <int K>
__global__ void subzero_mark(long long* acc, const unsigned char* valid, int n,
                             const long long* n_slow, const long long* bins) {
  long long now = 0;
  if (threadIdx.x == 0) now = global_ns();
  long long pairs = 0;
  if (valid != nullptr) {
    int c = 0;
    for (int r = threadIdx.x; r < n; r += blockDim.x) c += valid[r] != 0;
    for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(kFull, c, o);
    __shared__ int warp_sums[kCountThreads / 32];
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) pairs += warp_sums[w];
    }
  }
  if (threadIdx.x != 0) return;
  const long long last = acc[kLast];
  if (last != 0) acc[K] += now - last;
  acc[kLast] = now;
  if (K == kLayers - 1) acc[kSteps] += 1;
  if (valid != nullptr) count(acc, kPairs, pairs);
  if (n_slow != nullptr) count(acc, kSlow, *n_slow);
  if (bins != nullptr) {
    count(acc, kBinTests, bins[0]);
    count(acc, kBinFill, bins[1]);
  }
}

namespace {

template <int K>
void launch(long long* acc, const unsigned char* valid, int n,
            const long long* n_slow, const long long* bins, cudaStream_t s) {
  const int threads = valid != nullptr ? kCountThreads : 1;
  subzero_mark<K><<<1, threads, 0, s>>>(acc, valid, n, n_slow, bins);
}

}  // namespace

// Mark k (0 .. 6) on the stream: acc is the int64 buffer, valid (n bytes,
// or null) the candidate rows to count, n_slow (or null) the slow rows,
// bins (2 values, or null) the binned broad phase's slot tests and fullest
// bin.
extern "C" int sz_mark(int k, long long* acc, const unsigned char* valid, int n,
                       const long long* n_slow, const long long* bins,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 0: launch<0>(acc, valid, n, n_slow, bins, s); break;
    case 1: launch<1>(acc, valid, n, n_slow, bins, s); break;
    case 2: launch<2>(acc, valid, n, n_slow, bins, s); break;
    case 3: launch<3>(acc, valid, n, n_slow, bins, s); break;
    case 4: launch<4>(acc, valid, n, n_slow, bins, s); break;
    case 5: launch<5>(acc, valid, n, n_slow, bins, s); break;
    case 6: launch<6>(acc, valid, n, n_slow, bins, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
