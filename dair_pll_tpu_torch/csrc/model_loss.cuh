// ContactNets loss kernels of any model of the fused loss kernels' class, on
// the generic terms of model_terms.cuh:
//
//   K1 model_loss_terms_kernel + model_loss_fwd_lanes_kernel (at one
//      thread a sample, model_loss_fwd_kernel) replaces `_fwd_kernel` of
//      dair_pll_tpu/ops/soa_loss_pallas.py: terms at the observed next
//      state, the detached cold hybrid solve, the loss.
//   K3 model_loss_terms_kernel + model_loss_fwd_warm_lanes_kernel
//      (model_loss_fwd_warm_kernel) replaces `_fwd_kernel_warm`: as K1,
//      with the solve warm-started from the impulse of a previous visit.
//   K2 model_loss_bwd_kernel (+ model_reduce_partials_kernel) replaces
//      `_bwd_kernel`: the gradient of sum(ct * loss) at the saved impulse
//      with respect to the derived scalars (summed over the batch) and the
//      states.
//
// The box cube keeps its own kernels (contactnets_loss.cuh). The wrappers
// in ops/soa_loss_kernels.py instantiate these at first use for each
// ModelSize they meet (DEFINE_MODEL_FWD_ENTRY, DEFINE_MODEL_BWD_ENTRIES; the
// forward and the backward of each type a library of their own, so that
// they build in parallel), and build the model descriptor. The TPU kernels read a model's derived
// scalars from SMEM; here each block stages them in shared memory.
//
// K2 is one reverse-mode sweep per sample (model_loss_vjp,
// model_adjoint.cuh), one thread a sample at every size: K1's terms once
// forward in plain arithmetic, then their adjoint, written out by hand,
// back through the assembly, the contact and Lagrangian terms and the
// kinematic tree. Each thread keeps its sample's derived-scalar gradient;
// a warp sums it with shuffles in a fixed tree, the block its warps in
// order, and a second pass the blocks' partials in a fixed order. No
// atomics: float64 results repeat bit for bit.
//
// What bounds them on an H100 (the elbow, float32, B = 2,097,152): K1 and K3
// read 15 + 15 values (K3 24 more) and write 26 per sample, some 0.14 ms of
// bytes at 3.35 TB/s; their solve's ~10^5 operations or more per sample
// bound them by operations. K2 reads 54 values and writes 30 a sample
// (0.14 ms of bytes); its sweep's some 10^4 operations a sample bound it by
// operations too.
//
// One thread carrying a whole (7, 8) sample holds a few hundred live values
// (M, J, the cone state), past the 255-register cap, and spills. So at the
// elbow's size K1 and K3 run in two kernels (kFwdLanes of model_terms.cuh
// sets the lanes a sample at each size): one thread a sample computes the
// terms and writes them to a scratch pack in device memory (some 1 KB a
// sample in float32; the bytes are a few percent of the kernels' time);
// then a group of L lanes a sample each loads its contacts' columns of J
// and q with M whole, and runs the solve of hybrid_solve.cuh on them,
// exchanging the sums over contacts through its group's slots in shared
// memory, folded in contact order, so the results are one thread's bit
// for bit. The terms stay on one thread: on every lane they cost L times
// their issue slots. Elsewhere one thread a sample runs terms, solve and
// loss in one kernel: at the polygon cube's k = 4 and the box and sphere
// body's k = 5 lanes lost to it in float32 (fewer samples in flight, each
// lane repeating the sample's factors).
//
// At one free body's sizes (kConstFreeBody of model_terms.cuh: one free
// body, but the polygon cube's (6, 4)) the body's joint is a compile-time
// constant in the three kernels, K1's cold solve leaves its loops at their
// exact fixed points, a warp together (kFwdColdExits; the threads past the
// batch solve its last sample again, so that every lane of a warp meets
// each exit), and K2 keeps each sample's gradient as a column of the
// block's dynamic shared memory where the columns take at most 64 KB
// (kBwdGradShared, GradColumn), so that the sweep's runtime indices (a
// geometry's friction and shape scalars) do not put it in the thread's
// local stack. At the box and sphere body's (6, 5) these took float32 K1
// from 28.5-28.9 to 22.8-23.0 ms and K2 from 8.7-9.0 to 3.0-3.2 (its
// spills 2,064 -> 596 B); K3 stayed at 19.2-19.6 (PERF.md §6).
#pragma once

#include <type_traits>

#include "model_adjoint.cuh"

namespace {

constexpr int kModelThreads = 64;      // K1, K3
constexpr int kModelBwdThreads = 128;  // K2
constexpr int kModelReduceThreads = 256;

template <typename S, typename Z>
__device__ __forceinline__ void stage_params(const ModelDesc<Z>& desc,
                                             const S* __restrict__ pvec,
                                             S* shared_p) {
  for (int i = threadIdx.x; i < desc.n_params; i += blockDim.x)
    shared_p[i] = pvec[i];
  __syncthreads();
}

template <typename S, typename Z>
__device__ __forceinline__ void load_model_states(
    const ModelDesc<Z>& desc, const S* __restrict__ xin,
    const S* __restrict__ xp, long long B, long long b,
    S (&x)[Z::NX + Z::NU], S (&x_plus)[Z::NX]) {
#pragma unroll
  for (int i = 0; i < Z::NX; ++i) {
    x[i] = xin[i * B + b];
    x_plus[i] = xp[i * B + b];
  }
#pragma unroll
  for (int i = 0; i < Z::NU; ++i)
    x[Z::NX + i] = i < desc.n_u ? xin[(Z::NX + i) * B + b] : S(0);
}

// The impulse of the lane's contacts; the loss and valid from lane 0.
template <typename S, typename Z, int L>
__device__ __forceinline__ void store_model_solution(
    S loss, const S (&f)[3][Z::K / L], bool valid, long long B, long long b,
    int lane, S* __restrict__ l, S* __restrict__ force,
    unsigned char* __restrict__ v) {
  constexpr int KL = Z::K / L;
  if (lane == 0) {
    l[b] = loss;
    v[b] = valid ? 1 : 0;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < KL; ++c)
      force[(i * Z::K + lane * KL + c) * B + b] = f[i][c];
}

// K1's group of one thread a sample: WarpSolo where its solve takes the
// exits (kFwdColdExits), whose warps leave the loops together.
template <typename Z>
using OneThread = std::conditional_t<kFwdColdExits<Z>, WarpSolo, Solo>;

// K1 and K3 at L = 1: one thread a sample, terms, solve and loss.
template <typename S, typename Z>
__global__ void __launch_bounds__(kModelThreads) model_loss_fwd_kernel(
    const __grid_constant__ ModelDesc<Z> desc, const S* __restrict__ pvec,
    const S* __restrict__ xin, const S* __restrict__ xp,
    S* __restrict__ loss, S* __restrict__ force,
    unsigned char* __restrict__ valid, long long B, double dt, double eps,
    int ipm_iterations, int newton_iterations) {
  __shared__ S shared_p[Z::PMAX];
  stage_params<S, Z>(desc, pvec, shared_p);
  // A thread past the batch returns, or, where the warp leaves the
  // solve's loops together (kFwdColdExits), solves the last sample again
  // and writes nothing.
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (!kFwdColdExits<Z> && t >= B) return;
  const long long b = t < B ? t : B - 1;
  S x[Z::NX + Z::NU], x_plus[Z::NX], f[3][Z::K];
  load_model_states<S, Z>(desc, xin, xp, B, b, x, x_plus);
  bool ok;
  const S l = model_loss_cold<S, Z, OneThread<Z>>(
      desc, shared_p, x, x_plus, S(dt), eps, ipm_iterations,
      newton_iterations, f, ok);
  if (t < B)
    store_model_solution<S, Z, 1>(l, f, ok, B, b, 0, loss, force, valid);
}

template <typename S, typename Z>
__global__ void __launch_bounds__(kModelThreads) model_loss_fwd_warm_kernel(
    const __grid_constant__ ModelDesc<Z> desc, const S* __restrict__ pvec,
    const S* __restrict__ xin, const S* __restrict__ xp,
    const S* __restrict__ fprev, S* __restrict__ loss, S* __restrict__ force,
    unsigned char* __restrict__ valid, long long B, double dt, double eps,
    int ipm_iterations, int newton_iterations) {
  __shared__ S shared_p[Z::PMAX];
  stage_params<S, Z>(desc, pvec, shared_p);
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  S x[Z::NX + Z::NU], x_plus[Z::NX], f_prev[3][Z::K], f[3][Z::K];
  load_model_states<S, Z>(desc, xin, xp, B, b, x, x_plus);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < Z::K; ++c)
      f_prev[i][c] = fprev[(i * Z::K + c) * B + b];
  bool ok;
  const S l = model_loss_warm<S, Z>(desc, shared_p, x, x_plus, f_prev, S(dt),
                                    eps, ipm_iterations, newton_iterations, f,
                                    ok);
  store_model_solution<S, Z, 1>(l, f, ok, B, b, 0, loss, force, valid);
}

// K1 and K3 at L > 1, first kernel: one thread a sample computes the terms
// and writes the sample's pack (kPackValues of model_terms.cuh, batch-minor).
template <typename S, typename Z>
__global__ void __launch_bounds__(kModelThreads) model_loss_terms_kernel(
    const __grid_constant__ ModelDesc<Z> desc, const S* __restrict__ pvec,
    const S* __restrict__ xin, const S* __restrict__ xp,
    S* __restrict__ pack, long long B, double dt) {
  __shared__ S shared_p[Z::PMAX];
  stage_params<S, Z>(desc, pvec, shared_p);
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  S x[Z::NX + Z::NU], x_plus[Z::NX];
  load_model_states<S, Z>(desc, xin, xp, B, b, x, x_plus);
  ModelParts<S, Z> lp;
  model_parts_at<S, Z>(desc, shared_p, x, x_plus, S(dt), lp);
  pack_problem<S, Z>(lp, pack + b, B);
}

// Second kernel: thread t runs lane t % L of sample t / L, its slots in
// shared memory. A group past the batch solves its last sample again and
// writes nothing, so that every lane of a warp meets each exchange.
template <typename S, typename Z, int L>
__device__ __forceinline__ WarpLanes<S, L> solve_lanes() {
  __shared__ S slots[kModelThreads / L][kLaneSlots<Z::NV, Z::K>];
  return WarpLanes<S, L>(&slots[threadIdx.x / L][0]);
}

// K1's solve and loss on L lanes a sample.
template <typename S, typename Z, int L>
__global__ void __launch_bounds__(kModelThreads) model_loss_fwd_lanes_kernel(
    const S* __restrict__ pack, S* __restrict__ loss, S* __restrict__ force,
    unsigned char* __restrict__ valid, long long B, double eps,
    int ipm_iterations, int newton_iterations) {
  using G = WarpLanes<S, L>;
  const long long b = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / L;
  const G g = solve_lanes<S, Z, L>();
  LaneParts<S, Z, G> parts;
  unpack_problem<S, Z, G>(pack + (b < B ? b : B - 1), B, eps, g, parts);
  S f[3][Z::K / L];
  bool ok;
  const S l = lane_loss_cold<S, Z, G>(parts, eps, ipm_iterations,
                                      newton_iterations, f, ok, g);
  if (b < B)
    store_model_solution<S, Z, L>(l, f, ok, B, b, g.lane(), loss, force,
                                  valid);
}

// K3's solve and loss on L lanes a sample, from the previous impulses.
template <typename S, typename Z, int L>
__global__ void __launch_bounds__(kModelThreads)
model_loss_fwd_warm_lanes_kernel(const S* __restrict__ pack,
                                 const S* __restrict__ fprev,
                                 S* __restrict__ loss, S* __restrict__ force,
                                 unsigned char* __restrict__ valid,
                                 long long B, double eps, int ipm_iterations,
                                 int newton_iterations) {
  using G = WarpLanes<S, L>;
  constexpr int KL = Z::K / L;
  const long long b = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / L;
  const long long at = b < B ? b : B - 1;
  const G g = solve_lanes<S, Z, L>();
  LaneParts<S, Z, G> parts;
  unpack_problem<S, Z, G>(pack + at, B, eps, g, parts);
  S f_prev[3][KL], f[3][KL];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < KL; ++c)
      f_prev[i][c] = fprev[(i * Z::K + g.lane() * KL + c) * B + at];
  bool ok;
  const S l = lane_loss_warm<S, Z, G>(parts, f_prev, eps, ipm_iterations,
                                      newton_iterations, f, ok, g);
  if (b < B)
    store_model_solution<S, Z, L>(l, f, ok, B, b, g.lane(), loss, force,
                                  valid);
}

// Whether K2 keeps each sample's derived-scalar gradient in shared memory
// (a column of the block's array a thread, GradColumn) rather than in the
// thread's local stack, where the sweep's runtime indices put it: at the
// sizes of kConstFreeBody whose columns of PMAX scalars of S take at most
// 64 KB a block (the box and sphere body's 60 in float64, the largest
// measured). A larger size, as a polygon of many vertices, keeps the local
// array, which holds any size.
template <typename S, typename Z>
constexpr bool kBwdGradShared =
    kConstFreeBody<Z> &&
    (size_t)Z::PMAX * kModelBwdThreads * sizeof(S) <= 64 * 1024;

// K2's dynamic shared memory: the gradient columns of kBwdGradShared.
template <typename S, typename Z>
inline size_t model_bwd_shared(int n_params) {
  return kBwdGradShared<S, Z>
             ? (size_t)n_params * kModelBwdThreads * sizeof(S)
             : 0;
}

// A size's designs in S as bits, for reports (soa_loss_kernels.loss_design
// reads them from the built K2 library): K1's and K3's lanes a sample in
// bits 0-7, the free body's joint as constants in bit 8, K1's cold exits
// in bit 9, K2's gradient columns in shared memory in bit 10.
template <typename S, typename Z> constexpr int model_design() {
  return kFwdLanes<Z> | int(kConstFreeBody<Z>) << 8 |
         int(kFwdColdExits<Z>) << 9 | int(kBwdGradShared<S, Z>) << 10;
}

// K2, first pass: each thread's sample (model_loss_vjp, one reverse-mode
// sweep) writes the state gradients; each warp sums its samples'
// derived-scalar gradients with shuffles, and the block its warps in
// order, into partial (n_blocks, n_params). The gradient of a sample lies
// in the thread's local array g_p, or (kBwdGradShared) in its column of
// the block's dynamic shared memory.
template <typename S, typename Z>
__global__ void __launch_bounds__(kModelBwdThreads) model_loss_bwd_kernel(
    const __grid_constant__ ModelDesc<Z> desc, const S* __restrict__ pvec,
    const S* __restrict__ xin, const S* __restrict__ xp,
    const S* __restrict__ force, const unsigned char* __restrict__ valid,
    const S* __restrict__ ct, S* __restrict__ partial, S* __restrict__ dxin,
    S* __restrict__ dxp, long long B, double dt) {
  constexpr int kWarps = kModelBwdThreads / 32;
  __shared__ S shared_p[Z::PMAX];
  __shared__ S warp_dp[kWarps][Z::PMAX];
  stage_params<S, Z>(desc, pvec, shared_p);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long b = (long long)blockIdx.x * blockDim.x + tid;
  const int n_p = desc.n_params;
  constexpr bool shared_grad = kBwdGradShared<S, Z>;
  using Grad = std::conditional_t<shared_grad, GradColumn<S>, S*>;
  S g_local[shared_grad ? 1 : Z::PMAX];
  Grad g_p;
  if constexpr (shared_grad) {
    extern __shared__ __align__(16) unsigned char model_bwd_columns[];
    g_p = GradColumn<S>{reinterpret_cast<S*>(model_bwd_columns) + tid,
                        kModelBwdThreads};
  } else {
    g_p = g_local;
  }
  if (b < B) {
    S x[Z::NX + Z::NU], x_plus[Z::NX], f[3][Z::K];
    load_model_states<S, Z>(desc, xin, xp, B, b, x, x_plus);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int c = 0; c < Z::K; ++c) f[i][c] = force[(i * Z::K + c) * B + b];
    S g_xin[Z::NX + Z::NU], g_xp[Z::NX];
    model_loss_vjp<S, Z>(desc, shared_p, x, x_plus, f, valid[b] != 0, ct[b],
                         S(dt), g_p, g_xin, g_xp);
#pragma unroll
    for (int i = 0; i < Z::NX; ++i) {
      dxin[i * B + b] = g_xin[i];
      dxp[i * B + b] = g_xp[i];
    }
#pragma unroll
    for (int i = 0; i < Z::NU; ++i)
      if (i < desc.n_u) dxin[(Z::NX + i) * B + b] = g_xin[Z::NX + i];
  } else {
    for (int s = 0; s < n_p; ++s) g_p[s] = S(0);
  }
  for (int s = 0; s < n_p; ++s) {
    S g = g_p[s];
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1)
      g = g + __shfl_down_sync(0xffffffffu, g, offset);
    if (lane == 0) warp_dp[warp][s] = g;
  }
  __syncthreads();
  for (int s = tid; s < n_p; s += kModelBwdThreads) {
    S acc = warp_dp[0][s];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) acc = acc + warp_dp[w][s];
    partial[blockIdx.x * (long long)n_p + s] = acc;
  }
}

// K2, second pass: one block per derived scalar sums the blocks' partials,
// each thread a fixed stride of them in order, then a fixed tree.
template <typename S>
__global__ void __launch_bounds__(kModelReduceThreads)
model_reduce_partials_kernel(const S* __restrict__ partial,
                             long long n_blocks, int n_p,
                             S* __restrict__ dp) {
  __shared__ S sums[kModelReduceThreads];
  const int tid = threadIdx.x;
  S acc = S(0);
  for (long long j = tid; j < n_blocks; j += kModelReduceThreads)
    acc = acc + partial[j * n_p + blockIdx.x];
  sums[tid] = acc;
  __syncthreads();
  for (int stride = kModelReduceThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) sums[tid] = sums[tid] + sums[tid + stride];
    __syncthreads();
  }
  if (tid == 0) dp[blockIdx.x] = sums[0];
}

inline long long model_blocks(long long B, int threads) {
  return (B + threads - 1) / threads;
}

// K1 (fprev null) or K3: at L = 1 one kernel; else the terms kernel into
// `pack` (kPackValues<Z> x B values, n_pack the caller's count of them),
// then the lanes' kernel.
template <typename S, typename Z, int L>
int launch_model_fwd(const void* desc, const void* pvec, const void* xin,
                     const void* xp, const void* fprev, void* loss,
                     void* force, void* valid, void* pack, long long n_pack,
                     long long B, double dt, double eps, int ipm_iterations,
                     int newton_iterations, void* stream) {
  const ModelDesc<Z>& d = *(const ModelDesc<Z>*)desc;
  const cudaStream_t st = (cudaStream_t)stream;
  if constexpr (L == 1) {
    const unsigned blocks = (unsigned)model_blocks(B, kModelThreads);
    if (fprev == nullptr)
      model_loss_fwd_kernel<S, Z><<<blocks, kModelThreads, 0, st>>>(
          d, (const S*)pvec, (const S*)xin, (const S*)xp, (S*)loss,
          (S*)force, (unsigned char*)valid, B, dt, eps, ipm_iterations,
          newton_iterations);
    else
      model_loss_fwd_warm_kernel<S, Z><<<blocks, kModelThreads, 0, st>>>(
          d, (const S*)pvec, (const S*)xin, (const S*)xp, (const S*)fprev,
          (S*)loss, (S*)force, (unsigned char*)valid, B, dt, eps,
          ipm_iterations, newton_iterations);
    return (int)cudaGetLastError();
  } else {
    if (n_pack != (long long)kPackValues<Z> * B)
      return (int)cudaErrorInvalidValue;
    model_loss_terms_kernel<S, Z>
        <<<(unsigned)model_blocks(B, kModelThreads), kModelThreads, 0, st>>>(
            d, (const S*)pvec, (const S*)xin, (const S*)xp, (S*)pack, B, dt);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    const unsigned blocks = (unsigned)model_blocks(B * L, kModelThreads);
    if (fprev == nullptr)
      model_loss_fwd_lanes_kernel<S, Z, L><<<blocks, kModelThreads, 0, st>>>(
          (const S*)pack, (S*)loss, (S*)force, (unsigned char*)valid, B, eps,
          ipm_iterations, newton_iterations);
    else
      model_loss_fwd_warm_lanes_kernel<S, Z, L>
          <<<blocks, kModelThreads, 0, st>>>(
              (const S*)pack, (const S*)fprev, (S*)loss, (S*)force,
              (unsigned char*)valid, B, eps, ipm_iterations,
              newton_iterations);
    return (int)cudaGetLastError();
  }
}

template <typename S, typename Z>
int launch_model_bwd(const void* desc, const void* pvec, const void* xin,
                     const void* xp, const void* force, const void* valid,
                     const void* ct, void* partial, void* dp, void* dxin,
                     void* dxp, long long B, double dt, void* stream) {
  const ModelDesc<Z>& d = *(const ModelDesc<Z>*)desc;
  const long long n_blocks = model_blocks(B, kModelBwdThreads);
  const size_t shared = model_bwd_shared<S, Z>(d.n_params);
  if (shared > 48 * 1024 &&
      cudaFuncSetAttribute(model_loss_bwd_kernel<S, Z>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)shared) != cudaSuccess)
    return (int)cudaGetLastError();
  model_loss_bwd_kernel<S, Z>
      <<<(unsigned)n_blocks, kModelBwdThreads, shared,
         (cudaStream_t)stream>>>(
          d, (const S*)pvec, (const S*)xin, (const S*)xp, (const S*)force,
          (const unsigned char*)valid, (const S*)ct, (S*)partial, (S*)dxin,
          (S*)dxp, B, dt);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  model_reduce_partials_kernel<S>
      <<<(unsigned)d.n_params, kModelReduceThreads, 0,
         (cudaStream_t)stream>>>((const S*)partial, n_blocks, d.n_params,
                                 (S*)dp);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points of one ModelSize (bound with ctypes). Tensors are
// contiguous and batch-minor: pvec (P,), xin (n_x + n_u, B), xp (n_x, B),
// fprev and force (3, k, B), loss and ct (B,), valid (B,) as bytes; desc
// points to the host's ModelDesc; the forward's scratch `pack` holds
// n_pack = kPackValues<Z> * B values (unused at L = 1), the backward's
// `partial` model_loss_bwd_scratch(B, P). Each returns cudaGetLastError()
// after its launches.
#define DEFINE_MODEL_FWD_ENTRY(Z, NAME, S, SUFFIX, L)                         \
  extern "C" int contactnets_loss_fwd_##NAME##_##SUFFIX(                     \
      const void* desc, const void* pvec, const void* xin, const void* xp,   \
      void* loss, void* force, void* valid, void* pack, long long n_pack,    \
      long long B, double dt, double eps, int ipm_iterations,                \
      int newton_iterations, void* stream) {                                 \
    return launch_model_fwd<S, Z, L>(desc, pvec, xin, xp, nullptr, loss,     \
                                     force, valid, pack, n_pack, B, dt, eps, \
                                     ipm_iterations, newton_iterations,      \
                                     stream);                                \
  }                                                                          \
  extern "C" int contactnets_loss_fwd_warm_##NAME##_##SUFFIX(                \
      const void* desc, const void* pvec, const void* xin, const void* xp,   \
      const void* fprev, void* loss, void* force, void* valid, void* pack,   \
      long long n_pack, long long B, double dt, double eps,                  \
      int ipm_iterations, int newton_iterations, void* stream) {             \
    return launch_model_fwd<S, Z, L>(desc, pvec, xin, xp, fprev, loss,       \
                                     force, valid, pack, n_pack, B, dt, eps, \
                                     ipm_iterations, newton_iterations,      \
                                     stream);                                \
  }

// K1 and K3 of one ModelSize on L lanes a sample, float32 and float64.
#define DEFINE_MODEL_FWD_ENTRIES(Z, NAME, L)                                  \
  DEFINE_MODEL_FWD_ENTRY(Z, NAME, float, f32, L)                             \
  DEFINE_MODEL_FWD_ENTRY(Z, NAME, double, f64, L)

#define DEFINE_MODEL_BWD_ENTRIES(Z, NAME, S, SUFFIX)                          \
  extern "C" int contactnets_loss_bwd_##NAME##_##SUFFIX(                     \
      const void* desc, const void* pvec, const void* xin, const void* xp,   \
      const void* force, const void* valid, const void* ct, void* partial,   \
      void* dp, void* dxin, void* dxp, long long B, double dt, double eps,   \
      void* stream) {                                                        \
    (void)eps; /* no term of the gradient at a fixed impulse */              \
    return launch_model_bwd<S, Z>(desc, pvec, xin, xp, force, valid, ct,     \
                                  partial, dp, dxin, dxp, B, dt, stream);    \
  }
