// Batched APGD (FISTA with adaptive restart) cone-QP solve, one warp per
// problem.
//
// Replaces the TPU kernel `_make_kernel` of
// dair_pll_tpu/ops/pallas_cone_solver.py (called through
// `solve_cone_qp_pallas`), the solve of the vmapped ContactNets loss with
// the APGD kernel route. For each of B problems it minimises
// 0.5 x'Qx + q'x over k unit Lorentz cones in the stacked layout
// [n_1..n_k, t_1x t_1y ..]: a step 1/L from 12 power iterations from
// 1/sqrt(n), L = 1.1 max(v'Qv, 1e-12), then `iterations` FISTA steps from
// zero, each projecting onto the cones and restarting the momentum when
// (y - x_new).(x_new - x) > 0. It computes what the plain PyTorch version
// `dair_pll_tpu_torch.ops.cone_kernels.plain_apgd` computes, in the same
// operation order.
//
// What bounds it on an H100: at the main path's shapes (k = 4, n = 12,
// 200 iterations) a problem does 213 matvecs of some 2 n^2 = 288
// operations plus the projections, the reductions and the momentum,
// 96,684 operations as chip_smoke.py counts them, against 624 bytes read
// and 48 written in float32: the operations bound it (at the 65,536
// problems of the main path 0.095 ms at the float32 vector peak, against
// 0.013 ms for the bytes). Every iteration depends on the last, so the
// design spreads each problem over a warp: lane i owns row i of Q (n <=
// 30, so k <= 10), kept in registers for the whole solve; the matvec is
// each lane's own sum over the columns with the iterate broadcast by
// __shfl_sync; the dot products, the power-iteration norm and the restart
// test are butterfly reductions over the warp, which leave the same sum
// in every lane. A problem's Q is read once, from contiguous rows. Lanes
// past n hold zeros, which add nothing to the reductions. One thread per
// problem would hold 144 values of Q alone at k = 4 (288 registers in
// float64, past the 255-register cap) and spill.
//
// Build: ops/soa_kernels.py compiles every source of this directory into
// one library, without fast math and without fused multiply-adds
// (-fmad=false), so that every product and sum rounds as in the plain
// version. Maxima are written as `x < c ? c : x`, which keeps a NaN as
// torch.clamp does.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
constexpr int kPowerIterations = 12;

template <typename T>
__device__ __forceinline__ T clamp_below(T x, T c) {
  return x < c ? c : x;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v = v + __shfl_xor_sync(kFullMask, v, offset);
  return v;
}

// (Q v)_lane = sum_j Q[lane][j] v[j], columns in order.
template <typename T, int N>
__device__ __forceinline__ T matvec(const T (&row)[N], T v) {
  T acc = row[0] * __shfl_sync(kFullMask, v, 0);
#pragma unroll
  for (int j = 1; j < N; ++j) acc = acc + row[j] * __shfl_sync(kFullMask, v, j);
  return acc;
}

// Projection of the stacked vector held one entry per lane onto the cones.
template <typename T, int K>
__device__ __forceinline__ T project(T z, int lane) {
  constexpr int N = 3 * K;
  const int cone = lane < K ? lane : (lane < N ? (lane - K) >> 1 : 0);
  const T n = __shfl_sync(kFullMask, z, cone);
  const T tx = __shfl_sync(kFullMask, z, K + 2 * cone);
  const T ty = __shfl_sync(kFullMask, z, K + 2 * cone + 1);
  const T s = sqrt(clamp_below(tx * tx + ty * ty, T(1e-30)));
  const bool inside = s <= n;
  const bool polar = s <= -n;
  const T h = T(0.5) * (n + s);
  if (lane < K) return inside ? n : (polar ? T(0) : h);
  if (lane < N) {
    const T scale = inside ? T(1) : (polar ? T(0) : h / s);
    return z * scale;
  }
  return T(0);
}

template <typename T, int K>
__global__ void apgd_cone_solve_kernel(const T* __restrict__ Q,
                                       const T* __restrict__ q,
                                       T* __restrict__ x_out, long long B,
                                       int iterations) {
  constexpr int N = 3 * K;
  const int lane = threadIdx.x & 31;
  const long long b =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const bool active = lane < N;

  T row[N];
  const T* Qb = Q + b * (long long)(N * N);
#pragma unroll
  for (int j = 0; j < N; ++j) row[j] = active ? Qb[lane * N + j] : T(0);
  const T qi = active ? q[b * N + lane] : T(0);

  // Lipschitz estimate by power iteration.
  T v = active ? T(1) / sqrt(T(N)) : T(0);
  for (int it = 0; it < kPowerIterations; ++it) {
    const T w = matvec<T, N>(row, v);
    const T norm = sqrt(clamp_below(warp_sum(w * w), T(1e-30)));
    v = w / norm;
  }
  const T lam = warp_sum(v * matvec<T, N>(row, v));
  const T inv_L = T(1) / (T(1.1) * clamp_below(lam, T(1e-12)));

  T x = T(0), y = T(0), t = T(1);
  for (int it = 0; it < iterations; ++it) {
    const T grad = matvec<T, N>(row, y) + qi;
    const T x_new = project<T, K>(y - inv_L * grad, lane);
    T t_new = T(0.5) * (T(1) + sqrt(T(1) + T(4) * t * t));
    T momentum = (t - T(1)) / t_new;
    const T step = x_new - x;
    const bool restart = warp_sum((y - x_new) * step) > T(0);
    if (restart) {
      t_new = T(1);
      momentum = T(0);
    }
    y = x_new + momentum * step;
    x = x_new;
    t = t_new;
  }
  if (active) x_out[b * N + lane] = x;
}

template <typename T, int K>
void launch_k(const void* Q, const void* q, void* x, long long B,
              int iterations, cudaStream_t stream) {
  const unsigned blocks =
      (unsigned)((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  apgd_cone_solve_kernel<T, K><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      (const T*)Q, (const T*)q, (T*)x, B, iterations);
}

template <typename T>
int launch(const void* Q, const void* q, void* x, long long B, int k,
           int iterations, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  switch (k) {
    case 1: launch_k<T, 1>(Q, q, x, B, iterations, stream); break;
    case 2: launch_k<T, 2>(Q, q, x, B, iterations, stream); break;
    case 3: launch_k<T, 3>(Q, q, x, B, iterations, stream); break;
    case 4: launch_k<T, 4>(Q, q, x, B, iterations, stream); break;
    case 5: launch_k<T, 5>(Q, q, x, B, iterations, stream); break;
    case 6: launch_k<T, 6>(Q, q, x, B, iterations, stream); break;
    case 7: launch_k<T, 7>(Q, q, x, B, iterations, stream); break;
    case 8: launch_k<T, 8>(Q, q, x, B, iterations, stream); break;
    case 9: launch_k<T, 9>(Q, q, x, B, iterations, stream); break;
    case 10: launch_k<T, 10>(Q, q, x, B, iterations, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Q (B, 3k, 3k) and q (B, 3k),
// contiguous, 1 <= k <= 10 -> x (B, 3k). Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for another k).
extern "C" int apgd_cone_solve_f32(const void* Q, const void* q, void* x,
                                   long long B, int k, int iterations,
                                   void* stream) {
  return launch<float>(Q, q, x, B, k, iterations, stream);
}

extern "C" int apgd_cone_solve_f64(const void* Q, const void* q, void* x,
                                   long long B, int k, int iterations,
                                   void* stream) {
  return launch<double>(Q, q, x, B, k, iterations, stream);
}
