// Cold hybrid cone solve (NT interior point, then SAP-Newton from the IPM
// iterate), one CUDA thread per sample.
//
// Replaces the TPU kernel `_kernel` of dair_pll_tpu/ops/soa_pallas.py
// (called through `solve_contact_impulse_soa_pallas`), the detached solve of
// the ContactNets loss for models the fused loss kernels do not cover, such
// as deep-support (ICNN) geometry. It computes what the plain PyTorch
// version `dair_pll_tpu_torch.ops.soa_solver.solve_contact_impulse_soa`
// computes, in the same operation order: `ipm_iterations` of the IPM with
// merit-best iterate tracking and the per-sample freeze on convergence,
// w = M^-1 J^T x_ipm, `newton_iterations` of SAP-Newton with the
// crease-bracketed exact line search, and the failure mask. The device code
// is `cold_hybrid_solve` of hybrid_solve.cuh, which the cold loss kernel K1
// runs too.
//
// What bounds it on an H100: at the ICNN training batch (262,144 samples,
// n_v = 6, k = 4) it reads 120 and writes 12 values and a byte per sample,
// 139 MB in f32, about 0.04 ms at 3.35 TB/s; the arithmetic at the (10, 10)
// budget, about 10^5 operations per sample, is about 0.4 ms at the f32
// vector peak, so operations bound it. One thread per sample with ~300 live
// scalars (255 registers and spills, as in K5 and K1) makes it bound by
// latency instead. As in K5, the TPU kernel's sublane packing, padding and
// VMEM blocks do not carry over: the kernel reads the batch-minor layout,
// neighbouring threads on neighbouring addresses, and masks the ragged
// edge.
//
// The elbow's instantiation, (n_v, k) = (7, 8), runs the same code on a
// larger problem: one thread then carries M (49 values), J (168) and the
// (3, 8) cone state, and spills far more than the cube's.

#include "hybrid_solve.cuh"

namespace {

// ---------------------------------------------------------------------------
template <typename T, int NV, int K>
__global__ void cold_hybrid_solve_kernel(
    const T* __restrict__ M, const T* __restrict__ Jc,
    const T* __restrict__ qc, T* __restrict__ force,
    unsigned char* __restrict__ valid_out, long long B, double eps,
    int ipm_iterations, int newton_iterations) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  Problem<T, NV, K> P;
  load_packed_problem<T, NV, K>(M, Jc, qc, B, b, eps, P);
  T gamma[3][K];
  const bool valid = cold_hybrid_solve<T, NV, K>(P, ipm_iterations,
                                                 newton_iterations, gamma);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < K; ++c) force[(i * K + c) * B + b] = gamma[i][c];
  valid_out[b] = valid ? 1 : 0;
}

constexpr int kThreads = 32;

template <typename T, int NV, int K>
int launch(const void* M, const void* Jc, const void* qc, void* force,
           void* valid, long long B, double eps, int ipm_iterations,
           int newton_iterations, void* stream) {
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  cold_hybrid_solve_kernel<T, NV, K>
      <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (const T*)M, (const T*)Jc, (const T*)qc, (T*)force,
          (unsigned char*)valid, B, eps, ipm_iterations, newton_iterations);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes), one per (n_v, k) and type: the
// cube's (6, 4) and the elbow's (7, 8). Tensors are contiguous and
// batch-minor: M (n_v * n_v, B), Jc (3, n_v, k, B), qc (3, k, B) -> force
// (3, k, B), valid (B,) as bytes. Returns cudaGetLastError() after the
// launch.
#define DEFINE_ENTRY(NV, K, T, SUFFIX)                                        \
  extern "C" int cold_hybrid_solve_nv##NV##_k##K##_##SUFFIX(                 \
      const void* M, const void* Jc, const void* qc, void* force,            \
      void* valid, long long B, double eps, int ipm_iterations,              \
      int newton_iterations, void* stream) {                                 \
    return launch<T, NV, K>(M, Jc, qc, force, valid, B, eps, ipm_iterations, \
                            newton_iterations, stream);                      \
  }

DEFINE_ENTRY(6, 4, float, f32)
DEFINE_ENTRY(6, 4, double, f64)
DEFINE_ENTRY(7, 8, float, f32)
DEFINE_ENTRY(7, 8, double, f64)
