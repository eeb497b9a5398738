// Designs of the APGD cone solve kernel K6 timed beside the shipped one by
// scripts/probe_apgd.py (not part of the kernel library). Each is
// dair_pll_tpu_torch/csrc/apgd_cone_solve.cu's apgd_cone_solve_kernel at
// another group width and exchange, and computes what the shipped kernel
// computes, operation for operation:
//
//   warp_shuffle   one warp a problem, the iterate by shuffles (the kernel
//                  before packed groups, with the warp's Q read through
//                  shared memory);
//   group_shuffle  a group of kGroupLanes lanes a problem, shuffles;
//   group_shared   a group a problem, the iterate through shared memory
//                  (the shipped design);
//   warp_shared    one warp a problem, the iterate through shared memory.
//
// The script compiles this file with the kernel library's nvcc flags and
// the checkout's csrc/ on the include path, into a library of its own.
// Every entry takes the library entry's arguments, Q (B, 3k, 3k), q (B,
// 3k) -> x (B, 3k), for k = 1, 4 and 9.

#include "apgd_cone_solve.cu"

namespace {

// The iterate through shuffles within the group, in place of
// SharedExchange's shared memory (at G = 32 the kernel before packed
// groups).
template <typename T, int K, int G>
struct ShuffleExchange {
  static constexpr int N = 3 * K, kSlots = 0;
  T v_;
  __device__ ShuffleExchange(T*, int) {}
  __device__ void publish(T v, int) { v_ = v; }
  __device__ void all(T (&out)[N]) const {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = __shfl_sync(kFullMask, v_, j, G);
  }
  __device__ T entry(int j) const { return __shfl_sync(kFullMask, v_, j, G); }
};

template <typename T, int K, bool kWarp, template <typename, int, int> class X>
int probe_k(const void* Q, const void* q, void* x, long long B,
            int iterations, cudaStream_t stream) {
  return launch_design<T, K, (kWarp ? 32 : kGroupLanes<K>), X>(Q, q, x, B,
                                                            iterations, stream);
}

template <typename T, bool kWarp, template <typename, int, int> class X>
int probe(const void* Q, const void* q, void* x, long long B, int k,
          int iterations, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  switch (k) {
    case 1: return probe_k<T, 1, kWarp, X>(Q, q, x, B, iterations, stream);
    case 4: return probe_k<T, 4, kWarp, X>(Q, q, x, B, iterations, stream);
    case 9: return probe_k<T, 9, kWarp, X>(Q, q, x, B, iterations, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

#define PROBE_ENTRY(NAME, WARP, X, T, SUFFIX)                                \
  extern "C" int probe_apgd_##NAME##_##SUFFIX(                               \
      const void* Q, const void* q, void* x, long long B, int k,             \
      int iterations, void* stream) {                                        \
    return probe<T, WARP, X>(Q, q, x, B, k, iterations, stream);             \
  }
#define PROBE_DESIGN(NAME, WARP, X)                                          \
  PROBE_ENTRY(NAME, WARP, X, float, f32)                                     \
  PROBE_ENTRY(NAME, WARP, X, double, f64)

PROBE_DESIGN(warp_shuffle, true, ShuffleExchange)
PROBE_DESIGN(group_shuffle, false, ShuffleExchange)
PROBE_DESIGN(group_shared, false, SharedExchange)
PROBE_DESIGN(warp_shared, true, SharedExchange)
