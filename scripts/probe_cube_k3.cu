// Designs of the box cube's warm loss kernel K3, and of its cold loss kernel
// K1, timed beside the shipped ones by scripts/probe_cube_k3.py (not part of
// the kernel library). Each K3 design computes what contactnets_loss.cu's
// contactnets_loss_fwd_warm_kernel computes, operation for operation:
//
//   t<N>[_min<M>]  the shipped one-thread body (cube_loss_warm) in blocks of
//                  N threads, with at least M blocks a multiprocessor;
//   split1         a terms kernel (one thread a sample: cube_terms.cuh's
//                  terms written to a pack in model_terms.cuh's layout,
//                  kPackValues values a sample) and a solve kernel (one
//                  thread a sample reads the pack: the warm solve and the
//                  assembly of model_terms.cuh at the box cube's size);
//   split<L>       the terms kernel, then the solve on L lanes a sample
//                  (model_loss.cuh's model_loss_fwd_warm_lanes_kernel).
//
// and each K1 design what contactnets_loss_fwd_kernel computes, bit for bit:
//
//   k1_exits       the one-thread body (cube_loss_cold) in blocks of 64
//                  threads, its cold solve leaving the IPM and Newton loops
//                  at their exact fixed points once every thread of the
//                  warp is at its own (the shipped K1);
//   k1_exits_diverge  the same, each thread leaving on its own;
//   k1_no_exits    the same without the exits (K1 before them);
//   k1_lean        k1_exits built against a copy of csrc/ with the script's
//                  LEAN_EDITS: fewer live values in the solve (the Newton
//                  matrix factored in place, the line search's crease
//                  candidates taken as each contact's roots are found).
//
// The script compiles this file once per group (-DPROBE_GROUP_<NAME>), each
// into a library of its own, with the kernel library's nvcc flags and a
// csrc/ on the include path (the measured checkout's for the K3 groups,
// this checkout's, or its LEAN_EDITS copy, for the K1 groups). Every entry
// takes the same arguments: pvec (15,), xin and xp (13, B), fprev (3, 4, B;
// read by K3 only) -> loss (B,), force (3, 4, B), valid (B,); pack
// (kPackValues * B values, read by the split designs only).

#include "model_loss.cuh"

namespace {

using CubeSize = ModelSize<1, 7, 6, 1, 4>;  // the box cube's generic size

template <typename S>
__device__ __forceinline__ void probe_params(const S* __restrict__ pvec,
                                             S (&p)[kCubeP]) {
  __shared__ S shared_p[kCubeP];
  if (threadIdx.x < kCubeP) shared_p[threadIdx.x] = pvec[threadIdx.x];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kCubeP; ++i) p[i] = shared_p[i];
}

template <typename S>
__device__ __forceinline__ S probe_warm_body(
    const S* __restrict__ pvec, const S* __restrict__ xin,
    const S* __restrict__ xp, const S* __restrict__ fprev, long long B,
    long long b, const S (&p)[kCubeP], double dt, double eps, int ipm,
    int newton, S (&f)[3][kCubeK], bool& ok) {
  S x[kCubeNX], x_plus[kCubeNX], f_prev[3][kCubeK];
#pragma unroll
  for (int i = 0; i < kCubeNX; ++i) {
    x[i] = xin[i * B + b];
    x_plus[i] = xp[i * B + b];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < kCubeK; ++c)
      f_prev[i][c] = fprev[(i * kCubeK + c) * B + b];
  return cube_loss_warm<S>(p, x, x_plus, f_prev, S(dt), eps, ipm, newton, f,
                           ok);
}

template <typename S>
__device__ __forceinline__ void probe_store(S l, const S (&f)[3][kCubeK],
                                            bool ok, long long B, long long b,
                                            S* __restrict__ loss,
                                            S* __restrict__ force,
                                            unsigned char* __restrict__ v) {
  loss[b] = l;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < kCubeK; ++c) force[(i * kCubeK + c) * B + b] = f[i][c];
  v[b] = ok ? 1 : 0;
}

// The shipped body in blocks of N threads, no minimum of blocks.
template <typename S, int N>
__global__ void __launch_bounds__(N) k3_threads_kernel(
    const S* __restrict__ pvec, const S* __restrict__ xin,
    const S* __restrict__ xp, const S* __restrict__ fprev,
    S* __restrict__ loss, S* __restrict__ force,
    unsigned char* __restrict__ valid, long long B, double dt, double eps,
    int ipm, int newton) {
  S p[kCubeP];
  probe_params<S>(pvec, p);
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  S f[3][kCubeK];
  bool ok;
  const S l = probe_warm_body<S>(pvec, xin, xp, fprev, B, b, p, dt, eps, ipm,
                                 newton, f, ok);
  probe_store<S>(l, f, ok, B, b, loss, force, valid);
}

// The same with at least M blocks a multiprocessor (fewer registers).
template <typename S, int N, int M>
__global__ void __launch_bounds__(N, M) k3_min_blocks_kernel(
    const S* __restrict__ pvec, const S* __restrict__ xin,
    const S* __restrict__ xp, const S* __restrict__ fprev,
    S* __restrict__ loss, S* __restrict__ force,
    unsigned char* __restrict__ valid, long long B, double dt, double eps,
    int ipm, int newton) {
  S p[kCubeP];
  probe_params<S>(pvec, p);
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  S f[3][kCubeK];
  bool ok;
  const S l = probe_warm_body<S>(pvec, xin, xp, fprev, B, b, p, dt, eps, ipm,
                                 newton, f, ok);
  probe_store<S>(l, f, ok, B, b, loss, force, valid);
}

// The split designs' first kernel: the cube's terms of each sample, one
// thread a sample, into the pack (pack_problem's layout: M, J, qc, phi, dv).
template <typename S>
__global__ void __launch_bounds__(kModelThreads) cube_terms_kernel(
    const S* __restrict__ pvec, const S* __restrict__ xin,
    const S* __restrict__ xp, S* __restrict__ pack, long long B, double dt) {
  S p[kCubeP];
  probe_params<S>(pvec, p);
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  S x[kCubeNX], x_plus[kCubeNX];
#pragma unroll
  for (int i = 0; i < kCubeNX; ++i) {
    x[i] = xin[i * B + b];
    x_plus[i] = xp[i * B + b];
  }
  LossParts<S> lp;
  cube_parts_at<S>(p, x, x_plus, S(dt), lp);
  constexpr int NV = kCubeNV, K = kCubeK, J0 = NV * NV, Q0 = J0 + 3 * NV * K,
                PHI0 = Q0 + 3 * K, DV0 = PHI0 + K;
  S* out = pack + b;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    out[(DV0 + i) * B] = lp.dv[i];
#pragma unroll
    for (int j = 0; j < NV; ++j) out[(i * NV + j) * B] = lp.M[i][j];
  }
#pragma unroll
  for (int c = 0; c < K; ++c) {
    out[(PHI0 + c) * B] = lp.phi[c];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      out[(Q0 + i * K + c) * B] = lp.qc[i][c];
#pragma unroll
      for (int j = 0; j < NV; ++j)
        out[(J0 + (i * NV + j) * K + c) * B] = lp.J[i][j][c];
    }
  }
}

// split1's second kernel: one thread a sample reads its pack.
template <typename S>
__global__ void __launch_bounds__(kModelThreads) split_solve_kernel(
    const S* __restrict__ pack, const S* __restrict__ fprev,
    S* __restrict__ loss, S* __restrict__ force,
    unsigned char* __restrict__ valid, long long B, double eps, int ipm,
    int newton) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  LaneParts<S, CubeSize, Solo> parts;
  unpack_problem<S, CubeSize, Solo>(pack + b, B, eps, Solo(), parts);
  S f_prev[3][kCubeK], f[3][kCubeK];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < kCubeK; ++c)
      f_prev[i][c] = fprev[(i * kCubeK + c) * B + b];
  bool ok;
  const S l = lane_loss_warm<S, CubeSize, Solo>(parts, f_prev, eps, ipm,
                                                newton, f, ok, Solo());
  store_model_solution<S, CubeSize, 1>(l, f, ok, B, b, 0, loss, force,
                                       valid);
}

unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

template <typename S, int N>
int launch_threads(const void* pvec, const void* xin, const void* xp,
                   const void* fprev, void* loss, void* force, void* valid,
                   long long B, double dt, double eps, int ipm, int newton,
                   cudaStream_t st) {
  k3_threads_kernel<S, N><<<blocks_for(B, N), N, 0, st>>>(
      (const S*)pvec, (const S*)xin, (const S*)xp, (const S*)fprev,
      (S*)loss, (S*)force, (unsigned char*)valid, B, dt, eps, ipm, newton);
  return (int)cudaGetLastError();
}

template <typename S, int N, int M>
int launch_min_blocks(const void* pvec, const void* xin, const void* xp,
                      const void* fprev, void* loss, void* force, void* valid,
                      long long B, double dt, double eps, int ipm, int newton,
                      cudaStream_t st) {
  k3_min_blocks_kernel<S, N, M><<<blocks_for(B, N), N, 0, st>>>(
      (const S*)pvec, (const S*)xin, (const S*)xp, (const S*)fprev,
      (S*)loss, (S*)force, (unsigned char*)valid, B, dt, eps, ipm, newton);
  return (int)cudaGetLastError();
}

template <typename S, int L>
int launch_split(const void* pvec, const void* xin, const void* xp,
                 const void* fprev, void* loss, void* force, void* valid,
                 void* pack, long long B, double dt, double eps, int ipm,
                 int newton, cudaStream_t st) {
  cube_terms_kernel<S><<<blocks_for(B, kModelThreads), kModelThreads, 0,
                         st>>>((const S*)pvec, (const S*)xin, (const S*)xp,
                               (S*)pack, B, dt);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if constexpr (L == 1)
    split_solve_kernel<S><<<blocks_for(B, kModelThreads), kModelThreads, 0,
                            st>>>((const S*)pack, (const S*)fprev, (S*)loss,
                                  (S*)force, (unsigned char*)valid, B, eps,
                                  ipm, newton);
  else
    model_loss_fwd_warm_lanes_kernel<S, CubeSize, L>
        <<<blocks_for(B * L, kModelThreads), kModelThreads, 0, st>>>(
            (const S*)pack, (const S*)fprev, (S*)loss, (S*)force,
            (unsigned char*)valid, B, eps, ipm, newton);
  return (int)cudaGetLastError();
}

#if defined(PROBE_GROUP_K1) || defined(PROBE_GROUP_K1LEAN)
// K1's body (cube_loss_cold, exits on or off, voting by the group G) in
// blocks of 64 threads; a thread past the batch solves the last sample
// again and writes nothing, as in the shipped kernel.
template <typename S, bool kExits, typename G>
__global__ void __launch_bounds__(64) k1_kernel(
    const S* __restrict__ pvec, const S* __restrict__ xin,
    const S* __restrict__ xp, S* __restrict__ loss, S* __restrict__ force,
    unsigned char* __restrict__ valid, long long B, double dt, double eps,
    int ipm, int newton) {
  S p[kCubeP];
  probe_params<S>(pvec, p);
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long b = t < B ? t : B - 1;
  S x[kCubeNX], x_plus[kCubeNX], f[3][kCubeK];
#pragma unroll
  for (int i = 0; i < kCubeNX; ++i) {
    x[i] = xin[i * B + b];
    x_plus[i] = xp[i * B + b];
  }
  bool ok;
  const S l = cube_loss_cold<S, kExits, G>(p, x, x_plus, S(dt), eps, ipm,
                                           newton, f, ok);
  if (t < B) probe_store<S>(l, f, ok, B, b, loss, force, valid);
}

template <typename S, bool kExits, typename G>
int launch_k1(const void* pvec, const void* xin, const void* xp,
              const void* fprev, void* loss, void* force, void* valid,
              long long B, double dt, double eps, int ipm, int newton,
              cudaStream_t st) {
  (void)fprev;
  k1_kernel<S, kExits, G><<<blocks_for(B, 64), 64, 0, st>>>(
      (const S*)pvec, (const S*)xin, (const S*)xp, (S*)loss, (S*)force,
      (unsigned char*)valid, B, dt, eps, ipm, newton);
  return (int)cudaGetLastError();
}
#endif

}  // namespace

extern "C" long long probe_pack_values() { return kPackValues<CubeSize>; }

#define PROBE_ENTRY(NAME, S, SUFFIX, CALL)                                   \
  extern "C" int probe_k3_##NAME##_##SUFFIX(                                 \
      const void* pvec, const void* xin, const void* xp, const void* fprev,  \
      void* loss, void* force, void* valid, void* pack, long long B,         \
      double dt, double eps, int ipm, int newton, void* stream) {            \
    (void)pack;                                                              \
    const cudaStream_t st = (cudaStream_t)stream;                            \
    return CALL;                                                             \
  }
#define PROBE_ENTRIES(NAME, CALL_F, CALL_D) \
  PROBE_ENTRY(NAME, float, f32, CALL_F)     \
  PROBE_ENTRY(NAME, double, f64, CALL_D)

#define ARGS pvec, xin, xp, fprev, loss, force, valid
#define TAIL B, dt, eps, ipm, newton, st

#ifdef PROBE_GROUP_T64
PROBE_ENTRIES(t64, (launch_threads<float, 64>(ARGS, TAIL)),
              (launch_threads<double, 64>(ARGS, TAIL)))
PROBE_ENTRIES(t64_min6, (launch_min_blocks<float, 64, 6>(ARGS, TAIL)),
              (launch_min_blocks<double, 64, 6>(ARGS, TAIL)))
#endif
#ifdef PROBE_GROUP_T128
PROBE_ENTRIES(t128, (launch_threads<float, 128>(ARGS, TAIL)),
              (launch_threads<double, 128>(ARGS, TAIL)))
PROBE_ENTRIES(t128_min3, (launch_min_blocks<float, 128, 3>(ARGS, TAIL)),
              (launch_min_blocks<double, 128, 3>(ARGS, TAIL)))
#endif
#ifdef PROBE_GROUP_T32
PROBE_ENTRIES(t32, (launch_threads<float, 32>(ARGS, TAIL)),
              (launch_threads<double, 32>(ARGS, TAIL)))
PROBE_ENTRIES(t64_min4, (launch_min_blocks<float, 64, 4>(ARGS, TAIL)),
              (launch_min_blocks<double, 64, 4>(ARGS, TAIL)))
#endif
#ifdef PROBE_GROUP_SPLIT1
PROBE_ENTRIES(split1, (launch_split<float, 1>(ARGS, pack, TAIL)),
              (launch_split<double, 1>(ARGS, pack, TAIL)))
#endif
#ifdef PROBE_GROUP_SPLIT2
PROBE_ENTRIES(split2, (launch_split<float, 2>(ARGS, pack, TAIL)),
              (launch_split<double, 2>(ARGS, pack, TAIL)))
#endif
#ifdef PROBE_GROUP_SPLIT4
PROBE_ENTRIES(split4, (launch_split<float, 4>(ARGS, pack, TAIL)),
              (launch_split<double, 4>(ARGS, pack, TAIL)))
#endif
#ifdef PROBE_GROUP_K1
PROBE_ENTRIES(k1_exits, (launch_k1<float, true, WarpSolo>(ARGS, TAIL)),
              (launch_k1<double, true, WarpSolo>(ARGS, TAIL)))
PROBE_ENTRIES(k1_exits_diverge, (launch_k1<float, true, Solo>(ARGS, TAIL)),
              (launch_k1<double, true, Solo>(ARGS, TAIL)))
PROBE_ENTRIES(k1_no_exits, (launch_k1<float, false, Solo>(ARGS, TAIL)),
              (launch_k1<double, false, Solo>(ARGS, TAIL)))
#endif
#ifdef PROBE_GROUP_K1LEAN
PROBE_ENTRIES(k1_lean, (launch_k1<float, true, WarpSolo>(ARGS, TAIL)),
              (launch_k1<double, true, WarpSolo>(ARGS, TAIL)))
#endif
