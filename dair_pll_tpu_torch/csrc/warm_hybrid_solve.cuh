// Warm-started hybrid cone solve (NT interior point + SAP-Newton): K5.
//
// Replaces the TPU kernel `_warm_kernel` of dair_pll_tpu/ops/soa_pallas.py
// (called through `solve_warm_hybrid_soa_pallas`), the solve of the fused
// rollouts and of the warm loss of models outside the fused loss kernels
// (the ICNN cube and elbow). It computes what the plain PyTorch version
// `dair_pll_tpu_torch.ops.soa_solver.solve_warm_hybrid_soa` computes, in the
// same operation order: the IPM with merit-best iterate tracking and the
// per-sample freeze on convergence, NT scaling and arrow solves, the Schur
// complement M + J^T A^-1 J with its LDL^T, the start chosen by primal cost,
// SAP-Newton with the crease-bracketed exact line search and its polish
// steps, and the final failure mask. The body is hybrid_solve.cuh's
// warm_solve_packed.
//
// What bounds it on an H100: at the rollout batch (8,192 samples, cube:
// n_v = 6, k = 4) it reads 126 and writes 19 values per sample, 4.75 MB in
// f32, about 1.4 us at 3.35 TB/s; its own body needs 74,426 operations a
// QP there (HostModelTerms.warm_solve_count), 9.1 us at the f32 vector
// peak. Neither is reached: one thread per sample fills fewer than 2 warps
// per SM, each thread runs a long dependent chain, and its live scalars
// spill to local memory, so the kernel is bound by latency. The kernel
// keeps the JAX public batch-minor layout, so that neighbouring threads
// read neighbouring addresses, and masks the ragged edge instead of
// padding.
//
// So each QP runs on 4 lanes of a warp (kWarmLanes), one contact a lane at
// the cube's (6, 4), two at the elbow's (7, 8): each lane loads M whole and
// its contacts' columns of Jc and qc, and the lanes exchange every sum over
// contacts through shared memory, folded in contact order, so the results
// are one thread's bit for bit. Measured on an NVIDIA H100 80GB HBM3 at
// 700 W (scripts/probe_loss_lanes.py --solves and its k5_* variants,
// PERF.md), in float32 (float64) on the rollouts' QPs at (14, 6), 81-82%
// of them with contact:
//
// - (6, 4), 8,192 QPs: one thread 0.34-0.37 ms (0.59-0.65; 255 registers,
//   376 B of stack, f64 2,392 B), 2 lanes 0.23-0.24 (0.32-0.33), 4 lanes
//   0.17-0.21 (0.25-0.28; 184 registers, no stack, f64 344 B); at 65,536
//   QPs 0.69-0.76 (2.95-3.04), 0.78-0.79 (1.40-1.44), 0.97-1.00
//   (1.51-1.59); on the ICNN cube's 262,144 warm loss QPs (no contact)
//   1.57-1.66 (5.07-5.26), 1.96-2.06 (3.93-3.94), 2.64-2.69 (4.06-4.14).
//   Once one thread a QP fills the card (132 multiprocessors x 8 warps at
//   255 registers, 33,792 threads), the lanes only repeat the 6 x 6
//   factors on each lane: so float32 batches of kWarmSoloFrom QPs or more
//   run one thread a QP. In float64 one thread spills 2,392 B and stays
//   behind at every batch.
// - (7, 8), 8,192 QPs: one thread 0.98-1.01 ms (2.17-2.20; 2,336 B of
//   stack), 2 lanes 0.49 (1.53-1.54), 4 lanes 0.27-0.31 (0.55-0.57; 80 B),
//   8 lanes 0.34-0.35 (0.56-0.58); at 65,536 4.78-4.82, 1.98, 1.73-1.78
//   and 2.22-2.27 ms. The ICNN elbow's 65,536 warm loss QPs have no
//   contact at initial parameters and do not weigh in the choice.
//
// Blocks of 32, 64 or 128 threads on 4 lanes lay within each other's
// spread at both sizes. Every design gave the same bits.
//
// Build: ops/soa_kernels.py compiles one instantiation per (n_v, k) and type
// at first use (no fast math: the solver relies on isfinite, NaN comparisons and
// the |f| > 1e3 mask; no fused multiply-adds, -fmad=false, so that every
// product and sum rounds as in the plain version, whose one-ulp differences
// the line search would amplify). The device functions live in
// hybrid_solve.cuh, shared with the ContactNets loss kernels.

#pragma once

#include <climits>

#include "hybrid_solve.cuh"

namespace {

// ---------------------------------------------------------------------------
// Thread t is lane t % L of QP t / L (L = kWarmLanes, or 1 from
// kWarmSoloFrom QPs on), in blocks of kBlock<L> threads. On lanes, each
// group's slots (kLaneSlots values) sit in dynamic shared memory, and a
// group past the batch solves the last QP again and writes nothing, so that
// every lane of a warp meets each exchange.
template <int L> constexpr int kBlock = L == 1 ? 32 : 64;

// The batch from which K5 runs one thread a QP: the cube's (6, 4) in
// float32 from about the batch at which one thread a QP fills an H100
// (see above); never at the elbow's (7, 8) or in float64.
template <typename T, int NV, int K>
constexpr long long kWarmSoloFrom =
    sizeof(T) == 4 && NV == 6 && K == 4 ? 32768 : LLONG_MAX;

// The shared memory of a block on lanes, within the 48 KB a launch gets
// without raising the kernel's limit.
template <typename T, int NV, int K, int L>
constexpr size_t kSharedBytes =
    L == 1 ? 0 : sizeof(T) * (kBlock<L> / L) * kLaneSlots<NV, K>;

template <typename T, int NV, int K, int L>
__global__ void __launch_bounds__(kBlock<L>) warm_hybrid_solve_kernel(
    const T* __restrict__ M, const T* __restrict__ Jc,
    const T* __restrict__ qc, const T* __restrict__ w0, T* __restrict__ force,
    T* __restrict__ w_out, unsigned char* __restrict__ valid_out, long long B,
    double eps, int ipm_iterations, int newton_iterations) {
  const long long b = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / L;
  if constexpr (L == 1) {
    if (b >= B) return;
    warm_solve_packed<T, NV, K>(M, Jc, qc, w0, force, w_out, valid_out, B, b,
                                true, eps, ipm_iterations, newton_iterations);
  } else {
    using G = WarpLanes<T, L>;
    extern __shared__ __align__(16) unsigned char lane_slots[];
    const G g(reinterpret_cast<T*>(lane_slots) +
              (threadIdx.x / L) * kLaneSlots<NV, K>);
    warm_solve_packed<T, NV, K, G>(M, Jc, qc, w0, force, w_out, valid_out, B,
                                   b < B ? b : B - 1, b < B, eps,
                                   ipm_iterations, newton_iterations, g);
  }
}

template <typename T, int NV, int K, int L>
int launch_lanes(const void* M, const void* Jc, const void* qc,
                 const void* w0, void* force, void* w, void* valid,
                 long long B, double eps, int ipm_iterations,
                 int newton_iterations, void* stream) {
  constexpr size_t shared = kSharedBytes<T, NV, K, L>;
  static_assert(shared <= 48 * 1024, "a block's slots fit in 48 KB");
  const unsigned blocks = (unsigned)((B * L + kBlock<L> - 1) / kBlock<L>);
  warm_hybrid_solve_kernel<T, NV, K, L>
      <<<blocks, kBlock<L>, shared, (cudaStream_t)stream>>>(
          (const T*)M, (const T*)Jc, (const T*)qc, (const T*)w0, (T*)force,
          (T*)w, (unsigned char*)valid, B, eps, ipm_iterations,
          newton_iterations);
  return (int)cudaGetLastError();
}

template <typename T, int NV, int K>
int launch(const void* M, const void* Jc, const void* qc, const void* w0,
           void* force, void* w, void* valid, long long B, double eps,
           int ipm_iterations, int newton_iterations, void* stream) {
  if constexpr (kWarmSoloFrom<T, NV, K> < LLONG_MAX)
    if (B >= kWarmSoloFrom<T, NV, K>)
      return launch_lanes<T, NV, K, 1>(M, Jc, qc, w0, force, w, valid, B,
                                       eps, ipm_iterations,
                                       newton_iterations, stream);
  return launch_lanes<T, NV, K, kWarmLanes<NV, K>>(
      M, Jc, qc, w0, force, w, valid, B, eps, ipm_iterations,
      newton_iterations, stream);
}

}  // namespace

// The plain C entry point (bound with ctypes) of one (n_v, k) and type,
// which ops/soa_kernels.py instantiates at first use for each size it meets
// (the cube's (6, 4), the elbow's (7, 8), a ball's (6, 1), ...). Tensors are contiguous and
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

