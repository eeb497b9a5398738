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
// kept in registers for the whole solve; lanes past n hold zeros.
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

// Lanes a problem of k cones: the smallest of 8, 16 and 32 that holds its
// 3k rows.
template <int K>
constexpr int kGroupLanes = 3 * K <= 8 ? 8 : (3 * K <= 16 ? 16 : 32);

template <typename T>
__device__ __forceinline__ T clamp_below(T x, T c) {
  return x < c ? c : x;
}

// The sum of v over the G lanes of a group, left in every lane of it.
template <int G, typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int offset = G / 2; offset > 0; offset >>= 1)
    v = v + __shfl_xor_sync(kFullMask, v, offset, G);
  return v;
}

// Values a shared row of the iterate holds: n padded to 16 bytes.
template <typename T, int N>
constexpr int kRowValues =
    (N * (int)sizeof(T) + 15) / 16 * 16 / (int)sizeof(T);

// Sixteen bytes of shared memory into registers.
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

// How a group's lanes see each other's entries of a vector that each holds
// one entry of, through the group's two rows of shared memory:
// publish(v, row) hands this lane's entry over (every lane of the warp
// calls it), then all(out) gives every entry and entry(j) the j-th.
template <typename T, int K, int G>
struct SharedExchange {
  static constexpr int N = 3 * K, kRow = kRowValues<T, N>;
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

// (Q v)_lane = sum_j Q[lane][j] v[j], columns in order; v published to
// `row` of the exchange.
template <typename T, int N, typename X>
__device__ __forceinline__ T matvec(const T (&q_row)[N], T v, X& ex,
                                    int row) {
  ex.publish(v, row);
  T all[N];
  ex.all(all);
  T acc = q_row[0] * all[0];
#pragma unroll
  for (int j = 1; j < N; ++j) acc = acc + q_row[j] * all[j];
  return acc;
}

// Projection onto the cones of the stacked vector held one entry a lane
// (z on this lane), published to `row` of the exchange.
template <typename T, int K, typename X>
__device__ __forceinline__ T project(T z, int lane, X& ex, int row) {
  constexpr int N = 3 * K;
  ex.publish(z, row);
  const int cone = lane < K ? lane : (lane < N ? (lane - K) >> 1 : 0);
  const T n = ex.entry(cone);
  const T tx = ex.entry(K + 2 * cone);
  const T ty = ex.entry(K + 2 * cone + 1);
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

// Problems a warp and a block, and the shared values a block needs: each
// group's Q and its exchange's slots.
template <int G> constexpr int kGroupsPerWarp = 32 / G;
template <typename T, int K, int G, template <typename, int, int> class X>
constexpr int kBlockShared =
    kWarpsPerBlock * kGroupsPerWarp<G> * (9 * K * K + X<T, K, G>::kSlots);

// Thread t of a block is lane t % G of group t / G; the warp's groups are
// consecutive problems.
template <typename T, int K, int G, template <typename, int, int> class X>
__global__ void __launch_bounds__(32 * kWarpsPerBlock) apgd_cone_solve_kernel(
    const T* __restrict__ Q, const T* __restrict__ q, T* __restrict__ x_out,
    long long B, int iterations) {
  constexpr int N = 3 * K, NN = N * N, P = kGroupsPerWarp<G>;
  static_assert(N <= G && 32 % G == 0, "a problem's rows fit its group");
  __shared__ __align__(16) T shared[kBlockShared<T, K, G, X>];
  const int warp = threadIdx.x >> 5, in_warp = threadIdx.x & 31;
  const int lane = in_warp % G, group = in_warp / G;
  const long long first = ((long long)blockIdx.x * kWarpsPerBlock + warp) * P;
  const long long mine = first + group;
  const bool store = mine < B;
  const long long b = store ? mine : B - 1;

  // The warp's groups' Q, read whole and in order, then row by row.
  T* stage = shared + warp * P * NN;
  for (int e = in_warp; e < P * NN; e += 32) {
    const long long p = first + e / NN;
    stage[e] = Q[(p < B ? p : B - 1) * NN + e % NN];
  }
  __syncwarp(kFullMask);
  const bool active = lane < N;
  T row[N];
#pragma unroll
  for (int j = 0; j < N; ++j)
    row[j] = active ? stage[group * NN + lane * N + j] : T(0);
  const T qi = active ? q[b * N + lane] : T(0);
  X<T, K, G> ex(shared + kWarpsPerBlock * P * NN +
                    (warp * P + group) * X<T, K, G>::kSlots,
                lane);

  // Lipschitz estimate by power iteration. The exchange's rows alternate;
  // the FISTA loop's matvec takes row 1 and its projection row 0, so that
  // no row is written before the last reads of it have met a __syncwarp.
  T v = active ? T(1) / sqrt(T(N)) : T(0);
  for (int it = 0; it < kPowerIterations; ++it) {
    const T w = matvec<T, N>(row, v, ex, it & 1);
    const T norm = sqrt(clamp_below(group_sum<G>(w * w), T(1e-30)));
    v = w / norm;
  }
  const T lam =
      group_sum<G>(v * matvec<T, N>(row, v, ex, kPowerIterations & 1));
  const T inv_L = T(1) / (T(1.1) * clamp_below(lam, T(1e-12)));

  T x = T(0), y = T(0), t = T(1);
  for (int it = 0; it < iterations; ++it) {
    const T grad = matvec<T, N>(row, y, ex, 1) + qi;
    const T x_new = project<T, K>(y - inv_L * grad, lane, ex, 0);
    T t_new = T(0.5) * (T(1) + sqrt(T(1) + T(4) * t * t));
    T momentum = (t - T(1)) / t_new;
    const T step = x_new - x;
    const bool restart = group_sum<G>((y - x_new) * step) > T(0);
    if (restart) {
      t_new = T(1);
      momentum = T(0);
    }
    y = x_new + momentum * step;
    x = x_new;
    t = t_new;
  }
  if (store && active) x_out[b * N + lane] = x;
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

// The shipped design at each k: packed groups, the iterate through shared
// memory (scripts/probe_apgd.py, PERF.md).
template <typename T, int K>
int launch_k(const void* Q, const void* q, void* x, long long B,
             int iterations, cudaStream_t stream) {
  return launch_design<T, K, kGroupLanes<K>, SharedExchange>(
      Q, q, x, B, iterations, stream);
}

template <typename T>
int launch(const void* Q, const void* q, void* x, long long B, int k,
           int iterations, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  switch (k) {
    case 1: return launch_k<T, 1>(Q, q, x, B, iterations, stream);
    case 2: return launch_k<T, 2>(Q, q, x, B, iterations, stream);
    case 3: return launch_k<T, 3>(Q, q, x, B, iterations, stream);
    case 4: return launch_k<T, 4>(Q, q, x, B, iterations, stream);
    case 5: return launch_k<T, 5>(Q, q, x, B, iterations, stream);
    case 6: return launch_k<T, 6>(Q, q, x, B, iterations, stream);
    case 7: return launch_k<T, 7>(Q, q, x, B, iterations, stream);
    case 8: return launch_k<T, 8>(Q, q, x, B, iterations, stream);
    case 9: return launch_k<T, 9>(Q, q, x, B, iterations, stream);
    case 10: return launch_k<T, 10>(Q, q, x, B, iterations, stream);
    default: return (int)cudaErrorInvalidValue;
  }
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
