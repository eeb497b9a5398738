// ContactNets loss kernels of the cube, one CUDA thread per sample:
//
//   K1 contactnets_loss_fwd_kernel       replaces `_fwd_kernel` of
//      dair_pll_tpu/ops/soa_loss_pallas.py: terms at the observed next
//      state, the detached cold hybrid solve, the loss.
//   K3 contactnets_loss_fwd_warm_kernel  replaces `_fwd_kernel_warm`: as K1,
//      with the solve warm-started from the impulse of a previous visit.
//   K2 contactnets_loss_bwd_kernel (+ reduce_partials_kernel) replaces
//      `_bwd_kernel`: the gradient of sum(ct * loss) at the saved impulse
//      with respect to the derived scalars (summed over the batch) and the
//      states.
//
// Each computes what its plain PyTorch version in
// dair_pll_tpu_torch/ops/soa_loss_kernels.py computes, with the terms and
// the assembly of cube_terms.cuh, the solves of hybrid_solve.cuh and K2's
// adjoint in cube_adjoint.cuh.
//
// The TPU kernel K2 calls jax.grad inside the kernel body. Here each thread
// makes one reverse-mode sweep per sample (cube_loss_vjp, no solve: the
// envelope theorem): the terms once in plain arithmetic, keeping what the
// adjoint needs, then the adjoint of the terms and the assembly written out
// by hand. The configuration rows of x get exactly 0, as in JAX. The TPU
// kernel sums the parameter gradient over its sequential grid; the blocks
// here run in no order, so each block sums its samples in shared memory in
// a fixed tree order and a second pass sums the blocks' partials in a fixed
// order. No atomics: float64 results repeat bit for bit.
//
// What bounds them on an H100 (cube, float32, B = 2,097,152): K1 and K3
// read 26 and 38 values and write 14 per sample (K3: 436 MB, 0.13 ms at
// 3.35 TB/s), and the operations their own bodies need (some 6 x 10^4 and
// 4 x 10^4 a sample: chip_smoke.py counts this code built for the host,
// ops/host_adjoint.py) bound them by operations. K2 reads 40
// values and writes 26 per sample (553 MB, 0.16 ms); its sweep needs some
// 4,200 operations per sample (chip_smoke.py counts them on this code built
// for the host, ops/host_adjoint.py), 0.13 ms at the float32 peak, so K2 is
// bound by its bytes. The design keeps the JAX public batch-minor
// layout, so that neighbouring threads read neighbouring addresses, loads
// the 15 derived scalars into shared memory once per block, and masks the
// ragged edge instead of padding. One thread carries a whole sample, so
// its few hundred live scalars reach the 255-register cap: K1 and K3
// spill, and K2, whose adjoint keeps some 240 values of the forward sweep,
// spills 80 bytes a thread in float32 (some 2.8 KB in float64). K2's launch
// bounds name its 128-thread block and no minimum of blocks per SM, so
// that ptxas may give each thread all 255 registers: a minimum that fits
// more blocks caps the registers and spills more, which cost more time on
// an H100 than the occupancy won.
// K3 was measured against other designs on an NVIDIA H100 80GB HBM3 at
// 700 W (scripts/probe_cube_k3.py, PERF.md), all bit for bit equal
// to it: it takes 10.0-10.2 ms at 2,097,152 (f64 30.8-31.8 ms): the terms
// and assembly 0.71 ms, an IPM iteration 0.80 ms, a Newton iteration
// 0.56 ms; 255 registers and 344 B of stack a thread (f64 2,232 B). Blocks
// of 32 or 128 threads, or a minimum of 4 blocks, gave the same times
// within their spread; a minimum of 6 blocks (168 registers, 832 B of
// stack) 11.3 ms. The terms on a kernel of their own, written to a pack
// the solve reads, took 13.0 ms with the solve on one thread (the terms
// kernel 1.6 ms; the solve alone still holds 255 registers and spills 456
// B: the solve, not the terms, sets the registers), 14.4 ms on 2 lanes a
// sample and 23.4 ms on 4 (their Newton iterations 0.92 and 1.78 ms
// against 0.56: at (6, 4) each lane repeats the 6 x 6 factors and solves
// for too few contacts). So one thread a sample stays.
// K1's cold solve leaves its IPM and SAP-Newton loops at their exact fixed
// points (hybrid_solve.cuh's exits), a warp once all its threads are at
// theirs, with the same bits. On the box cube's 2,097,152 training
// transitions on an NVIDIA H100 80GB HBM3 at 700 W (scripts/probe_cube_k3.py
// --k1, PERF.md): 13.7-14.1 ms without the exits, 11.2-11.5 ms with them
// in float32 (an IPM iteration 0.77 -> 0.50 ms on average: in float32 mu
// freezes in 42% of the IPM iterations); float64 gains nothing (62-64
// ms). Each thread leaving on its own gave the same times; fewer live
// values in the solve (the Newton matrix factored in place, the line
// search's candidates streamed) 1-2% in float32 and none in float64, with
// the same registers and stack, so the solve stays as it is.
//
// Build: ops/soa_kernels.py compiles this source at first use into a
// library of its own (the instantiation "contactnets_loss_cube"), as every
// other kernel's.
#pragma once

#include "cube_adjoint.cuh"

namespace {

constexpr int kThreads = 64;      // K1, K3
constexpr int kBwdThreads = 128;  // K2

template <typename S>
__device__ __forceinline__ void load_params(const S* __restrict__ pvec,
                                            S (&p)[kCubeP]) {
  __shared__ S shared_p[kCubeP];
  if (threadIdx.x < kCubeP) shared_p[threadIdx.x] = pvec[threadIdx.x];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kCubeP; ++i) p[i] = shared_p[i];
}

template <typename S>
__device__ __forceinline__ void load_states(const S* __restrict__ xin,
                                            const S* __restrict__ xp,
                                            long long B, long long b,
                                            S (&x)[kCubeNX],
                                            S (&x_plus)[kCubeNX]) {
#pragma unroll
  for (int i = 0; i < kCubeNX; ++i) {
    x[i] = xin[i * B + b];
    x_plus[i] = xp[i * B + b];
  }
}

template <typename S>
__device__ __forceinline__ void store_solution(S loss, const S (&f)[3][kCubeK],
                                               bool valid, long long B,
                                               long long b, S* __restrict__ l,
                                               S* __restrict__ force,
                                               unsigned char* __restrict__ v) {
  l[b] = loss;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < kCubeK; ++c) force[(i * kCubeK + c) * B + b] = f[i][c];
  v[b] = valid ? 1 : 0;
}

// K1.
template <typename S>
__global__ void __launch_bounds__(kThreads) contactnets_loss_fwd_kernel(
    const S* __restrict__ pvec, const S* __restrict__ xin,
    const S* __restrict__ xp, S* __restrict__ loss, S* __restrict__ force,
    unsigned char* __restrict__ valid, long long B, double dt, double eps,
    int ipm_iterations, int newton_iterations) {
  S p[kCubeP];
  load_params<S>(pvec, p);
  // A thread past the batch solves the last sample again and writes
  // nothing, so that every thread of a warp meets each vote of the solve's
  // exits.
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long b = t < B ? t : B - 1;
  S x[kCubeNX], x_plus[kCubeNX], f[3][kCubeK];
  load_states<S>(xin, xp, B, b, x, x_plus);
  bool ok;
  const S l = cube_loss_cold<S, true, WarpSolo>(p, x, x_plus, S(dt), eps,
                                                ipm_iterations,
                                                newton_iterations, f, ok);
  if (t < B) store_solution<S>(l, f, ok, B, b, loss, force, valid);
}

// K3.
template <typename S>
__global__ void __launch_bounds__(kThreads) contactnets_loss_fwd_warm_kernel(
    const S* __restrict__ pvec, const S* __restrict__ xin,
    const S* __restrict__ xp, const S* __restrict__ fprev,
    S* __restrict__ loss, S* __restrict__ force,
    unsigned char* __restrict__ valid, long long B, double dt, double eps,
    int ipm_iterations, int newton_iterations) {
  S p[kCubeP];
  load_params<S>(pvec, p);
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  S x[kCubeNX], x_plus[kCubeNX], f_prev[3][kCubeK], f[3][kCubeK];
  load_states<S>(xin, xp, B, b, x, x_plus);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < kCubeK; ++c)
      f_prev[i][c] = fprev[(i * kCubeK + c) * B + b];
  bool ok;
  const S l = cube_loss_warm<S>(p, x, x_plus, f_prev, S(dt), eps,
                                ipm_iterations, newton_iterations, f, ok);
  store_solution<S>(l, f, ok, B, b, loss, force, valid);
}

// K2, first pass: one reverse-mode sweep per sample (cube_loss_vjp) writes
// the state gradients, and each block sums its samples' derived-scalar
// gradients in a fixed tree order into partial (n_blocks, 15). eps enters
// the loss but not its gradient at the saved impulse.
template <typename S>
__global__ void __launch_bounds__(kBwdThreads)
contactnets_loss_bwd_kernel(const S* __restrict__ pvec,
                            const S* __restrict__ xin,
                            const S* __restrict__ xp,
                            const S* __restrict__ force,
                            const unsigned char* __restrict__ valid,
                            const S* __restrict__ ct, S* __restrict__ partial,
                            S* __restrict__ dxin, S* __restrict__ dxp,
                            long long B, double dt) {
  __shared__ S shared_dp[kCubeP][kBwdThreads];
  S p[kCubeP];
  load_params<S>(pvec, p);
  const int tid = threadIdx.x;
  const long long b = (long long)blockIdx.x * blockDim.x + tid;
  if (b < B) {
    S x[kCubeNX], x_plus[kCubeNX], f[3][kCubeK];
    load_states<S>(xin, xp, B, b, x, x_plus);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int c = 0; c < kCubeK; ++c) f[i][c] = force[(i * kCubeK + c) * B + b];
    S g_p[kCubeP], g_v[kCubeNV], g_xp[kCubeNX];
    cube_loss_vjp<S>(p, x, x_plus, f, valid[b] != 0, ct[b], S(dt), g_p, g_v,
                     g_xp);
#pragma unroll
    for (int s = 0; s < kCubeP; ++s) shared_dp[s][tid] = g_p[s];
#pragma unroll
    for (int i = 0; i < kCubeNQ; ++i) dxin[i * B + b] = S(0);
#pragma unroll
    for (int i = 0; i < kCubeNV; ++i) dxin[(kCubeNQ + i) * B + b] = g_v[i];
#pragma unroll
    for (int i = 0; i < kCubeNX; ++i) dxp[i * B + b] = g_xp[i];
  } else {
#pragma unroll
    for (int s = 0; s < kCubeP; ++s) shared_dp[s][tid] = S(0);
  }
  __syncthreads();
  for (int stride = kBwdThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride)
#pragma unroll
      for (int s = 0; s < kCubeP; ++s)
        shared_dp[s][tid] = shared_dp[s][tid] + shared_dp[s][tid + stride];
    __syncthreads();
  }
  if (tid < kCubeP) partial[blockIdx.x * (long long)kCubeP + tid] =
      shared_dp[tid][0];
}

// K2, second pass: one block per derived scalar sums the blocks' partials,
// each thread a fixed stride of them in order, then a fixed tree.
constexpr int kReduceThreads = 256;

template <typename S>
__global__ void __launch_bounds__(kReduceThreads) reduce_partials_kernel(
    const S* __restrict__ partial, long long n_blocks, S* __restrict__ dp) {
  __shared__ S sums[kReduceThreads];
  const int tid = threadIdx.x;
  S acc = S(0);
  for (long long j = tid; j < n_blocks; j += kReduceThreads)
    acc = acc + partial[j * kCubeP + blockIdx.x];
  sums[tid] = acc;
  __syncthreads();
  for (int stride = kReduceThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) sums[tid] = sums[tid] + sums[tid + stride];
    __syncthreads();
  }
  if (tid == 0) dp[blockIdx.x] = sums[0];
}

long long n_blocks_for(long long B, int threads) {
  return (B + threads - 1) / threads;
}

template <typename S>
int launch_fwd(const void* pvec, const void* xin, const void* xp, void* loss,
               void* force, void* valid, long long B, double dt, double eps,
               int ipm_iterations, int newton_iterations, void* stream) {
  contactnets_loss_fwd_kernel<S>
      <<<(unsigned)n_blocks_for(B, kThreads), kThreads, 0,
         (cudaStream_t)stream>>>(
          (const S*)pvec, (const S*)xin, (const S*)xp, (S*)loss, (S*)force,
          (unsigned char*)valid, B, dt, eps, ipm_iterations,
          newton_iterations);
  return (int)cudaGetLastError();
}

template <typename S>
int launch_fwd_warm(const void* pvec, const void* xin, const void* xp,
                    const void* fprev, void* loss, void* force, void* valid,
                    long long B, double dt, double eps, int ipm_iterations,
                    int newton_iterations, void* stream) {
  contactnets_loss_fwd_warm_kernel<S>
      <<<(unsigned)n_blocks_for(B, kThreads), kThreads, 0,
         (cudaStream_t)stream>>>(
          (const S*)pvec, (const S*)xin, (const S*)xp, (const S*)fprev,
          (S*)loss, (S*)force, (unsigned char*)valid, B, dt, eps,
          ipm_iterations, newton_iterations);
  return (int)cudaGetLastError();
}

template <typename S>
int launch_bwd(const void* pvec, const void* xin, const void* xp,
               const void* force, const void* valid, const void* ct,
               void* partial, void* dp, void* dxin, void* dxp, long long B,
               double dt, void* stream) {
  const long long n_blocks = n_blocks_for(B, kBwdThreads);
  contactnets_loss_bwd_kernel<S>
      <<<(unsigned)n_blocks, kBwdThreads, 0, (cudaStream_t)stream>>>(
          (const S*)pvec, (const S*)xin, (const S*)xp, (const S*)force,
          (const unsigned char*)valid, (const S*)ct, (S*)partial, (S*)dxin,
          (S*)dxp, B, dt);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  reduce_partials_kernel<S>
      <<<kCubeP, kReduceThreads, 0, (cudaStream_t)stream>>>(
          (const S*)partial, n_blocks, (S*)dp);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Tensors are contiguous and
// batch-minor: pvec (15,), xin (13, B), xp (13, B), fprev and force
// (3, 4, B), loss and ct (B,), valid (B,) as bytes; the backward's scratch
// `partial` holds contactnets_loss_bwd_scratch(B) values. Each returns
// cudaGetLastError() after its launches.
extern "C" long long contactnets_loss_bwd_scratch(long long B) {
  return n_blocks_for(B, kBwdThreads) * kCubeP;
}

#define DEFINE_ENTRIES(S, SUFFIX)                                            \
  extern "C" int contactnets_loss_fwd_cube_##SUFFIX(                         \
      const void* pvec, const void* xin, const void* xp, void* loss,         \
      void* force, void* valid, long long B, double dt, double eps,          \
      int ipm_iterations, int newton_iterations, void* stream) {             \
    return launch_fwd<S>(pvec, xin, xp, loss, force, valid, B, dt, eps,      \
                         ipm_iterations, newton_iterations, stream);         \
  }                                                                          \
  extern "C" int contactnets_loss_fwd_warm_cube_##SUFFIX(                    \
      const void* pvec, const void* xin, const void* xp, const void* fprev,  \
      void* loss, void* force, void* valid, long long B, double dt,          \
      double eps, int ipm_iterations, int newton_iterations, void* stream) { \
    return launch_fwd_warm<S>(pvec, xin, xp, fprev, loss, force, valid, B,   \
                              dt, eps, ipm_iterations, newton_iterations,    \
                              stream);                                       \
  }                                                                          \
  extern "C" int contactnets_loss_bwd_cube_##SUFFIX(                         \
      const void* pvec, const void* xin, const void* xp, const void* force,  \
      const void* valid, const void* ct, void* partial, void* dp,            \
      void* dxin, void* dxp, long long B, double dt, double eps,             \
      void* stream) {                                                        \
    (void)eps; /* no term of the gradient at a fixed impulse */              \
    return launch_bwd<S>(pvec, xin, xp, force, valid, ct, partial, dp, dxin, \
                         dxp, B, dt, stream);                                \
  }

DEFINE_ENTRIES(float, f32)
DEFINE_ENTRIES(double, f64)
