// Cold hybrid cone solve (NT interior point, then SAP-Newton from the IPM
// iterate): K4.
//
// Replaces the TPU kernel `_kernel` of dair_pll_tpu/ops/soa_pallas.py
// (called through `solve_contact_impulse_soa_pallas`), the detached solve of
// the ContactNets loss for models the fused loss kernels do not cover, such
// as deep-support (ICNN) geometry. It computes what the plain PyTorch
// version `dair_pll_tpu_torch.ops.soa_solver.solve_contact_impulse_soa`
// computes, in the same operation order: `ipm_iterations` of the IPM with
// merit-best iterate tracking and the per-sample freeze on convergence,
// w = M^-1 J^T x_ipm, `newton_iterations` of SAP-Newton with the
// crease-bracketed exact line search, and the failure mask. The body is
// hybrid_solve.cuh's cold_solve_packed, whose cold_hybrid_solve the box
// cube's cold loss kernel K1 runs too.
//
// What bounds it on an H100: at the ICNN training batch (262,144 samples,
// n_v = 6, k = 4) it reads 120 and writes 12 values and a byte per sample,
// 139 MB in f32, about 0.04 ms at 3.35 TB/s; the arithmetic its own body
// needs at the (10, 10) budget (HostModelTerms.cold_solve_count, the bound
// in chip_smoke.py) bounds it by operations. One thread a QP carries M, J
// and the cone state in 255 registers and spills (at (7, 8) 2,312 B of
// stack in f32), so it is bound by latency instead.
//
// The design is K5's (warm_hybrid_solve.cuh): a QP on kColdLanes lanes of a
// warp, the lanes' sums over contacts exchanged through shared memory and
// folded in contact order, so the results are one thread's bit for bit.
// SAP-Newton leaves its loop at its exact fixed point, and in float64 the
// IPM too (hybrid_solve.cuh's exits): the TPU kernel runs every iteration
// on every sample because its vector lanes move together; a warp here
// leaves a loop once, for each of its samples, a Newton iteration left w's
// bits unchanged (or an IPM iteration applied no update), with the bits of
// the whole budget. The kernel keeps the batch-minor layout, so that
// neighbouring threads read neighbouring addresses, and masks the ragged
// edge instead of padding.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (scripts/probe_loss_lanes.py
// --k4 and its k4_* variants, PERF.md), float32 (float64), on contact-rich
// QPs (the cube's and the elbow's rollouts near the ground, 81-82% with
// contact) and on the ICNN models' cold loss QPs at initial parameters
// (none):
//
// - (7, 8), 65,536 rich QPs: one thread a QP 4.18-4.50 ms (10.5-10.9), 2
//   lanes 1.89-2.39 (9.9-10.3), 4 lanes 1.69-1.86 (3.45-3.66), 8 lanes
//   2.52-2.53 (4.17-4.22); at 8,192 0.94-1.01, 0.40-0.50, 0.24-0.30 and
//   0.31-0.32 ms.
// - (6, 4): at 8,192 rich QPs 4 lanes 0.14-0.19 ms (0.20-0.26), 2 lanes
//   0.18-0.25, one thread 0.25-0.31. In float32 one thread a QP overtakes
//   4 lanes by 32,768 QPs (262,144: 2.00-2.16 against 3.76-3.95 with the
//   IPM's exits), as in K5; in float64 2 lanes overtake 4 by 32,768
//   (262,144: 5.17-5.42 against 6.61-6.95), where one thread spills 2,344
//   B. So from kColdFewerFrom QPs on the cube's K4 runs kColdFewerLanes.
// - The exits. With the IPM's exits in float32 too, the ICNN QPs ran
//   faster (the ICNN cube's 262,144: 1.24-1.35 ms against 1.76-1.84;
//   the ICNN elbow's 65,536: 1.23-1.35 against 1.64-1.68), but the
//   contact-rich ones slower (the elbow's 65,536: 1.97-2.16 against
//   1.72-1.83; the cube's 262,144 on one thread: 4.90-5.24 against
//   2.00-2.16), with the same bits and fewer operations; whether a warp
//   left together or each QP on its own, and with the problem pinned in
//   registers. Without any exits, the rich QPs ran as with SAP-Newton's
//   alone. In float64 the IPM's exits cost nothing there (the cube's
//   262,144 on 2 lanes: 5.17-5.30 with both loops' exits, 5.39-5.79
//   without any). The contact-rich QPs decide, as a trained shape's.
//
// Every design gave the same bits in both types on every set, float64
// equal to the plain version.

#pragma once

#include <climits>

#include "hybrid_solve.cuh"

namespace {

// Which of K4's loops leave at their fixed points: SAP-Newton in both
// types, the IPM in float64 only (see above).
template <typename T> constexpr bool kColdIpmExits = sizeof(T) == 8;
constexpr bool kColdNewtonExits = true;

// Thread t is lane t % L of QP t / L (L = kColdLanes, or kColdFewerLanes
// from kColdFewerFrom QPs on), in blocks of kBlock<L> threads. On lanes, each
// group's slots (kLaneSlots values) sit in dynamic shared memory. A group
// (or thread) past the batch solves the last QP again and writes nothing,
// so that every lane of a warp meets each exchange and each vote of the
// exits.
template <int L> constexpr int kBlock = L == 1 ? 32 : 64;

// The batch from which K4 runs on fewer lanes a QP, kColdFewerLanes: at
// the cube's (6, 4), one thread a QP in float32 (as K5) and 2 lanes in
// float64; never at the elbow's (7, 8).
template <int NV, int K>
constexpr long long kColdFewerFrom = NV == 6 && K == 4 ? 32768 : LLONG_MAX;
template <typename T> constexpr int kColdFewerLanes = sizeof(T) == 4 ? 1 : 2;

template <typename T, int NV, int K, int L>
constexpr size_t kSharedBytes =
    L == 1 ? 0 : sizeof(T) * (kBlock<L> / L) * kLaneSlots<NV, K>;

template <typename T, int NV, int K, int L>
__global__ void __launch_bounds__(kBlock<L>) cold_hybrid_solve_kernel(
    const T* __restrict__ M, const T* __restrict__ Jc,
    const T* __restrict__ qc, T* __restrict__ force,
    unsigned char* __restrict__ valid_out, long long B, double eps,
    int ipm_iterations, int newton_iterations) {
  const long long b = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / L;
  if constexpr (L == 1) {
    cold_solve_packed<T, NV, K, WarpSolo, kColdIpmExits<T>,
                      kColdNewtonExits>(
        M, Jc, qc, force, valid_out, B, b < B ? b : B - 1, b < B, eps,
        ipm_iterations, newton_iterations);
  } else {
    using G = WarpLanes<T, L>;
    extern __shared__ __align__(16) unsigned char lane_slots[];
    const G g(reinterpret_cast<T*>(lane_slots) +
              (threadIdx.x / L) * kLaneSlots<NV, K>);
    cold_solve_packed<T, NV, K, G, kColdIpmExits<T>, kColdNewtonExits>(
        M, Jc, qc, force, valid_out, B, b < B ? b : B - 1, b < B, eps,
        ipm_iterations, newton_iterations, g);
  }
}

template <typename T, int NV, int K, int L>
int launch_lanes(const void* M, const void* Jc, const void* qc, void* force,
                 void* valid, long long B, double eps, int ipm_iterations,
                 int newton_iterations, void* stream) {
  constexpr size_t shared = kSharedBytes<T, NV, K, L>;
  static_assert(shared <= 48 * 1024, "a block's slots fit in 48 KB");
  const unsigned blocks = (unsigned)((B * L + kBlock<L> - 1) / kBlock<L>);
  cold_hybrid_solve_kernel<T, NV, K, L>
      <<<blocks, kBlock<L>, shared, (cudaStream_t)stream>>>(
          (const T*)M, (const T*)Jc, (const T*)qc, (T*)force,
          (unsigned char*)valid, B, eps, ipm_iterations, newton_iterations);
  return (int)cudaGetLastError();
}

template <typename T, int NV, int K>
int launch(const void* M, const void* Jc, const void* qc, void* force,
           void* valid, long long B, double eps, int ipm_iterations,
           int newton_iterations, void* stream) {
  if constexpr (kColdFewerFrom<NV, K> < LLONG_MAX)
    if (B >= kColdFewerFrom<NV, K>)
      return launch_lanes<T, NV, K, kColdFewerLanes<T>>(
          M, Jc, qc, force, valid, B, eps, ipm_iterations, newton_iterations,
          stream);
  return launch_lanes<T, NV, K, kColdLanes<NV, K>>(
      M, Jc, qc, force, valid, B, eps, ipm_iterations, newton_iterations,
      stream);
}

}  // namespace

// The plain C entry point (bound with ctypes) of one (n_v, k) and type,
// which ops/soa_kernels.py instantiates at first use for each size it meets
// (the cube's (6, 4), the elbow's (7, 8), a ball's (6, 1), ...). Tensors are contiguous and
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

