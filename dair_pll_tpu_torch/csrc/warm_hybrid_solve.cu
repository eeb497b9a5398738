// Warm-started hybrid cone solve (NT interior point + SAP-Newton), one
// CUDA thread per sample.
//
// Replaces the TPU kernel `_warm_kernel` of dair_pll_tpu/ops/soa_pallas.py
// (called through `solve_warm_hybrid_soa_pallas`), the only kernel on the
// fused rollout path. It computes what the plain PyTorch version
// `dair_pll_tpu_torch.ops.soa_solver.solve_warm_hybrid_soa` computes, in the
// same operation order: the IPM with merit-best iterate tracking and the
// per-sample freeze on convergence, NT scaling and arrow solves, the Schur
// complement M + J^T A^-1 J with its LDL^T, the start chosen by primal cost,
// SAP-Newton with the crease-bracketed exact line search and its polish
// steps, and the final failure mask.
//
// What bounds it on an H100: at the rollout batch (8,192 samples, cube:
// n_v = 6, k = 4) it reads 126 and writes 19 values per sample, 4.75 MB in
// f32, about 1.4 us at 3.35 TB/s; the arithmetic (about 10^5 operations per
// sample at the (14, 6) budget) is a few us at the f32 vector peak. Neither
// is reached: one thread per sample fills fewer than 2 warps per SM, each
// thread runs a long dependent chain, and its ~300 live scalars spill to
// local memory, so the kernel is bound by latency. This first design keeps
// the JAX public batch-minor layout, so that neighbouring threads read
// neighbouring addresses, masks the ragged edge instead of padding, and
// leaves shared-memory staging, several threads per sample and occupancy
// work to later changes.
//
// The elbow's instantiation, (n_v, k) = (7, 8), runs the same code on a
// larger problem: one thread then carries M (49 values), J (168) and the
// (3, 8) cone state, and spills far more than the cube's.
//
// Build: ops/soa_kernels.py compiles every source of this directory into one
// library (no fast math: the solver relies on isfinite, NaN comparisons and
// the |f| > 1e3 mask; no fused multiply-adds, -fmad=false, so that every
// product and sum rounds as in the plain version, whose one-ulp differences
// the line search would amplify). The device functions live in
// hybrid_solve.cuh, shared with the ContactNets loss kernels.

#include "hybrid_solve.cuh"

namespace {

// ---------------------------------------------------------------------------
template <typename T, int NV, int K>
__global__ void warm_hybrid_solve_kernel(
    const T* __restrict__ M, const T* __restrict__ Jc,
    const T* __restrict__ qc, const T* __restrict__ w0, T* __restrict__ force,
    T* __restrict__ w_out, unsigned char* __restrict__ valid_out, long long B,
    double eps, int ipm_iterations, int newton_iterations) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  Problem<T, NV, K> P;
  load_packed_problem<T, NV, K>(M, Jc, qc, B, b, eps, P);

  T w[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) w[i] = w0[i * B + b];
  T gamma[3][K];
  const bool valid = warm_hybrid_solve<T, NV, K>(P, ipm_iterations,
                                                 newton_iterations, w, gamma);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < K; ++c) force[(i * K + c) * B + b] = gamma[i][c];
#pragma unroll
  for (int i = 0; i < NV; ++i) w_out[i * B + b] = w[i];
  valid_out[b] = valid ? 1 : 0;
}

constexpr int kThreads = 32;

template <typename T, int NV, int K>
int launch(const void* M, const void* Jc, const void* qc, const void* w0,
           void* force, void* w, void* valid, long long B, double eps,
           int ipm_iterations, int newton_iterations, void* stream) {
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  warm_hybrid_solve_kernel<T, NV, K>
      <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (const T*)M, (const T*)Jc, (const T*)qc, (const T*)w0, (T*)force,
          (T*)w, (unsigned char*)valid, B, eps, ipm_iterations,
          newton_iterations);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes), one per (n_v, k) and type: the
// cube's (6, 4) and the elbow's (7, 8). Tensors are contiguous and
// batch-minor: M (n_v * n_v, B), Jc (3, n_v, k, B), qc (3, k, B), w0 (n_v,
// B) -> force (3, k, B), w (n_v, B), valid (B,) as bytes. Returns
// cudaGetLastError() after the launch.
#define DEFINE_ENTRY(NV, K, T, SUFFIX)                                        \
  extern "C" int warm_hybrid_solve_nv##NV##_k##K##_##SUFFIX(                 \
      const void* M, const void* Jc, const void* qc, const void* w0,         \
      void* force, void* w, void* valid, long long B, double eps,            \
      int ipm_iterations, int newton_iterations, void* stream) {             \
    return launch<T, NV, K>(M, Jc, qc, w0, force, w, valid, B, eps,          \
                            ipm_iterations, newton_iterations, stream);      \
  }

DEFINE_ENTRY(6, 4, float, f32)
DEFINE_ENTRY(6, 4, double, f64)
DEFINE_ENTRY(7, 8, float, f32)
DEFINE_ENTRY(7, 8, double, f64)
