// Batched APGD (FISTA with adaptive restart) cone-QP solve on packed groups
// of lanes: K6.
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
// 0.013 ms for the bytes). Every iteration depends on the last, so a
// problem is spread over a group of G lanes of a warp, G the smallest of
// 8, 16 and 32 that holds its n = 3k rows (kGroupLanes: 4 problems a warp
// at k <= 2, 2 at k <= 5, 1 at k <= 10). Lane i of a group owns row i of Q,
// kept in registers for the whole solve; lanes past n hold zeros. Beyond
// k = 10 a problem takes a whole warp and each lane owns R rows (kLaneRows:
// the power of two that makes 32 R hold the 3k rows), rows lane, lane +
// 32, ..., read from device memory straight into registers; a lane first
// sums its own R values by halves (r with r + R/2), then the warp's
// butterfly adds the lanes, which is the plain version's halving sum over
// 32 R rows (`cone_kernels._warp_sum` pads to that width). Every k builds
// at first use (ops/soa_kernels.py), one instantiation per k and type.
//
// - The matvec is each lane's own sum over the columns, in column order.
//   The iterate reaches every lane of its group through shared memory:
//   each lane writes its entry to the group's row of slots, the warp meets
//   at __syncwarp, and each lane reads the row with 16-byte loads. The cone
//   projection reads its three fields from the same kind of row. Two rows
//   a group, used in turn, keep the write of one exchange from racing the
//   reads of the last.
// - The dot products, the power-iteration norm and the restart test are
//   butterflies of width G (__shfl_xor_sync from G/2 down), which leave the
//   same sum in every lane of the group. With zeros in lanes n..G-1 this is
//   the 32-lane butterfly's sum bit for bit, the one the plain version
//   takes (`cone_kernels._warp_sum`): that butterfly's first log2(32/G)
//   steps only add exact zeros. Its one difference, the sign of an all-zero
//   sum, reaches no result: every use is `max(., 1e-30)`, `max(., 1e-12)`
//   or `> 0` (tests/test_torch_apgd_groups.py).
// - A warp reads its groups' Q (contiguous n^2 values each) with
//   consecutive lanes on consecutive addresses into shared memory, and each
//   lane takes its row from there.
// - A group past B solves problem B - 1 again and writes nothing, so every
//   lane of a warp meets each __syncwarp and shuffle with the full mask.
//
// The kernel takes the exchange as a template so that scripts/probe_apgd.cu
// can time it with shuffles in place of shared memory, and at one warp a
// problem (the design this replaces), beside the shipped one.
//
// Build: ops/soa_kernels.py compiles each k's instantiation at first use
// (DEFINE_APGD_ENTRY), without fast math and without fused multiply-adds
// (-fmad=false), so that every product and sum rounds as in the plain
// version. Maxima are written as `x < c ? c : x`, which keeps a NaN as
// torch.clamp does.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
constexpr int kPowerIterations = 12;

// Lanes a problem of k cones: the smallest of 8, 16 and 32 that holds its
// 3k rows; 32 beyond k = 10.
template <int K>
constexpr int kGroupLanes = 3 * K <= 8 ? 8 : (3 * K <= 16 ? 16 : 32);

// Rows a lane owns: the smallest power of two R with 32 R >= 3k (1 up to
// k = 10, 2 up to 21, 4 up to 42, ...).
constexpr int lane_rows(int n) {
  int r = 1;
  while (32 * r < n) r *= 2;
  return r;
}
template <int K> constexpr int kLaneRows = lane_rows(3 * K);

template <typename T>
__device__ __forceinline__ T clamp_below(T x, T c) {
  return x < c ? c : x;
}

// The sum over a group of G lanes by a butterfly: every lane gets the sum.
template <int G, typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int offset = G / 2; offset > 0; offset >>= 1)
    v = v + __shfl_xor_sync(kFullMask, v, offset, G);
  return v;
}

// The sum of the R values each lane holds over the group: each lane's by
// halves (r with r + R/2 first), then the butterfly; the halving sum over
// 32 R rows, row r G + lane the lane's value r.
template <int G, int R, typename T>
__device__ __forceinline__ T rows_sum(const T (&v)[R]) {
  T h[R];
#pragma unroll
  for (int r = 0; r < R; ++r) h[r] = v[r];
#pragma unroll
  for (int w = R / 2; w > 0; w >>= 1)
#pragma unroll
    for (int r = 0; r < w; ++r) h[r] = h[r] + h[r + w];
  return group_sum<G>(h[0]);
}

// Values of one shared row of n entries, padded to 16 bytes.
template <typename T, int N>
constexpr int kRowValues =
    (N * (int)sizeof(T) + 15) / 16 * 16 / (int)sizeof(T);

__device__ __forceinline__ void load16(const float* s, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load16(const double* s, double* out) {
  const double2 v = *reinterpret_cast<const double2*>(s);
  out[0] = v.x;
  out[1] = v.y;
}

// The iterate's exchange through shared memory: a group's two rows of
// slots. publish writes the lanes' entries to a row and meets the warp at
// __syncwarp; all reads the row whole, entry one value of it.
template <typename T, int K, int G>
struct SharedExchange {
  static constexpr int N = 3 * K, R = kLaneRows<K>, kRow = kRowValues<T, N>;
  // Shared values a group needs.
  static constexpr int kSlots = 2 * kRow;
  T* slots_;
  const T* row_ = nullptr;
  int lane_;
  __device__ SharedExchange(T* slots, int lane) : slots_(slots), lane_(lane) {}
  __device__ void publish(T v, int row) {
    T* r = slots_ + row * kRow;
    if (lane_ < N) r[lane_] = v;
    __syncwarp(kFullMask);
    row_ = r;
  }
  // A lane's R rows (lane + s G) at once.
  __device__ void publish_rows(const T (&v)[R], int row) {
    T* r = slots_ + row * kRow;
#pragma unroll
    for (int s = 0; s < R; ++s)
      if (s * G + lane_ < N) r[s * G + lane_] = v[s];
    __syncwarp(kFullMask);
    row_ = r;
  }
  __device__ void all(T (&out)[N]) const {
    constexpr int W = 16 / sizeof(T);
    T v[kRow];
#pragma unroll
    for (int c = 0; c < kRow; c += W) load16(row_ + c, v + c);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = v[j];
  }
  __device__ T entry(int j) const { return row_[j]; }
};

template <int R, typename T, typename X>
__device__ __forceinline__ void publish(X& ex, const T (&v)[R], int row) {
  if constexpr (R == 1)
    ex.publish(v[0], row);
  else
    ex.publish_rows(v, row);
}

// Each owned row's dot product with the group's vector v, over the
// columns in order.
template <typename T, int N, int R, typename X>
__device__ __forceinline__ void matvec(const T (&q_rows)[R][N],
                                       const T (&v)[R], X& ex, int row,
                                       T (&out)[R]) {
  publish<R>(ex, v, row);
  T all[N];
  ex.all(all);
#pragma unroll
  for (int s = 0; s < R; ++s) {
    T acc = q_rows[s][0] * all[0];
#pragma unroll
    for (int j = 1; j < N; ++j) acc = acc + q_rows[s][j] * all[j];
    out[s] = acc;
  }
}

// The projection onto the k cones, for each owned row i = s G + lane: a
// normal entry (i < k) or a tangent entry of cone (i - k) / 2; rows past n
// give zero.
template <typename T, int K, int G, int R, typename X>
__device__ __forceinline__ void project(const T (&z)[R], int lane, X& ex,
                                        int row, T (&out)[R]) {
  constexpr int N = 3 * K;
  publish<R>(ex, z, row);
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int i = s * G + lane;
    const int cone = i < K ? i : (i < N ? (i - K) >> 1 : 0);
    const T n = ex.entry(cone);
    const T tx = ex.entry(K + 2 * cone);
    const T ty = ex.entry(K + 2 * cone + 1);
    const T sn = sqrt(clamp_below(tx * tx + ty * ty, T(1e-30)));
    const bool inside = sn <= n;
    const bool polar = sn <= -n;
    const T h = T(0.5) * (n + sn);
    if (i < K) {
      out[s] = inside ? n : (polar ? T(0) : h);
    } else if (i < N) {
      const T scale = inside ? T(1) : (polar ? T(0) : h / sn);
      out[s] = z[s] * scale;
    } else {
      out[s] = T(0);
    }
  }
}

template <int G> constexpr int kGroupsPerWarp = 32 / G;
// Q's values a group stages in shared memory: its n^2 at one row a lane;
// none at several (each lane reads its rows from device memory).
template <int K>
constexpr int kStageValues = kLaneRows<K> == 1 ? 9 * K * K : 0;
template <typename T, int K, int G, template <typename, int, int> class X>
constexpr int kBlockShared =
    kWarpsPerBlock * kGroupsPerWarp<G> * (kStageValues<K> + X<T, K, G>::kSlots);

template <typename T, int K, int G, template <typename, int, int> class X>
__global__ void __launch_bounds__(32 * kWarpsPerBlock) apgd_cone_solve_kernel(
    const T* __restrict__ Q, const T* __restrict__ q, T* __restrict__ x_out,
    long long B, int iterations) {
  constexpr int N = 3 * K, NN = N * N, P = kGroupsPerWarp<G>,
                R = kLaneRows<K>;
  static_assert(N <= G * R && 32 % G == 0 && (R == 1 || G == 32),
                "a problem's rows fit its group");
  __shared__ __align__(16) T shared[kBlockShared<T, K, G, X>];
  const int warp = threadIdx.x >> 5, in_warp = threadIdx.x & 31;
  const int lane = in_warp % G, group = in_warp / G;
  const long long first = ((long long)blockIdx.x * kWarpsPerBlock + warp) * P;
  const long long mine = first + group;
  const bool store = mine < B;
  const long long b = store ? mine : B - 1;

  T row[R][N];
  if constexpr (R == 1) {
    // The warp's groups' Q, read whole and in order, then row by row.
    T* stage = shared + warp * P * NN;
    for (int e = in_warp; e < P * NN; e += 32) {
      const long long p = first + e / NN;
      stage[e] = Q[(p < B ? p : B - 1) * NN + e % NN];
    }
    __syncwarp(kFullMask);
#pragma unroll
    for (int j = 0; j < N; ++j)
      row[0][j] = lane < N ? stage[group * NN + lane * N + j] : T(0);
  } else {
#pragma unroll
    for (int s = 0; s < R; ++s)
#pragma unroll
      for (int j = 0; j < N; ++j)
        row[s][j] = s * G + lane < N ? Q[b * NN + (s * G + lane) * N + j]
                                     : T(0);
  }
  T qi[R];
#pragma unroll
  for (int s = 0; s < R; ++s)
    qi[s] = s * G + lane < N ? q[b * N + s * G + lane] : T(0);
  X<T, K, G> ex(shared + kWarpsPerBlock * P * kStageValues<K> +
                    (warp * P + group) * X<T, K, G>::kSlots,
                lane);

  // Lipschitz estimate by power iteration. The exchange's rows alternate;
  // the FISTA loop's matvec takes row 1 and its projection row 0, so that
  // no row is written before the last reads of it have met a __syncwarp.
  T v[R], w[R], sq[R];
#pragma unroll
  for (int s = 0; s < R; ++s)
    v[s] = s * G + lane < N ? T(1) / sqrt(T(N)) : T(0);
  for (int it = 0; it < kPowerIterations; ++it) {
    matvec<T, N, R>(row, v, ex, it & 1, w);
#pragma unroll
    for (int s = 0; s < R; ++s) sq[s] = w[s] * w[s];
    const T norm = sqrt(clamp_below(rows_sum<G, R>(sq), T(1e-30)));
#pragma unroll
    for (int s = 0; s < R; ++s) v[s] = w[s] / norm;
  }
  matvec<T, N, R>(row, v, ex, kPowerIterations & 1, w);
#pragma unroll
  for (int s = 0; s < R; ++s) sq[s] = v[s] * w[s];
  const T lam = rows_sum<G, R>(sq);
  const T inv_L = T(1) / (T(1.1) * clamp_below(lam, T(1e-12)));

  T x[R], y[R], z[R], x_new[R], step[R];
#pragma unroll
  for (int s = 0; s < R; ++s) x[s] = y[s] = T(0);
  T t = T(1);
  for (int it = 0; it < iterations; ++it) {
    matvec<T, N, R>(row, y, ex, 1, w);
#pragma unroll
    for (int s = 0; s < R; ++s) z[s] = y[s] - inv_L * (w[s] + qi[s]);
    project<T, K, G, R>(z, lane, ex, 0, x_new);
    T t_new = T(0.5) * (T(1) + sqrt(T(1) + T(4) * t * t));
    T momentum = (t - T(1)) / t_new;
#pragma unroll
    for (int s = 0; s < R; ++s) {
      step[s] = x_new[s] - x[s];
      sq[s] = (y[s] - x_new[s]) * step[s];
    }
    const bool restart = rows_sum<G, R>(sq) > T(0);
    if (restart) {
      t_new = T(1);
      momentum = T(0);
    }
#pragma unroll
    for (int s = 0; s < R; ++s) {
      y[s] = x_new[s] + momentum * step[s];
      x[s] = x_new[s];
    }
    t = t_new;
  }
  if (store)
#pragma unroll
    for (int s = 0; s < R; ++s)
      if (s * G + lane < N) x_out[b * N + s * G + lane] = x[s];
}

template <typename T, int K, int G, template <typename, int, int> class X>
int launch_design(const void* Q, const void* q, void* x, long long B,
                  int iterations, cudaStream_t stream) {
  constexpr long long per_block = kWarpsPerBlock * kGroupsPerWarp<G>;
  static_assert(sizeof(T) * kBlockShared<T, K, G, X> <= 48 * 1024,
                "a block's shared memory fits in 48 KB");
  const unsigned blocks = (unsigned)((B + per_block - 1) / per_block);
  apgd_cone_solve_kernel<T, K, G, X><<<blocks, 32 * kWarpsPerBlock, 0,
                                       stream>>>(
      (const T*)Q, (const T*)q, (T*)x, B, iterations);
  return (int)cudaGetLastError();
}

}  // namespace

// The plain C entry point of k cones in type T (bound with ctypes):
// apgd_cone_solve_k<K>_<SUFFIX>. Tensors are contiguous: Q (B, 3k, 3k), q
// (B, 3k) -> x (B, 3k). Returns cudaGetLastError() after the launch.
#define DEFINE_APGD_ENTRY(K, T, SUFFIX)                                       \
  extern "C" int apgd_cone_solve_k##K##_##SUFFIX(                            \
      const void* Q, const void* q, void* x, long long B, int iterations,    \
      void* stream) {                                                        \
    return launch_design<T, K, kGroupLanes<K>, SharedExchange>(              \
        Q, q, x, B, iterations, (cudaStream_t)stream);                       \
  }
