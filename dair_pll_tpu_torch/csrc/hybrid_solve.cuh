// Device functions of the hybrid cone solve (NT interior point + SAP-Newton),
// shared by the warm and cold hybrid solve kernels (warm_hybrid_solve.cuh,
// cold_hybrid_solve.cuh) and the ContactNets loss kernels
// (contactnets_loss.cuh, model_loss.cuh). Each mirrors its plain PyTorch counterpart in
// dair_pll_tpu_torch/ops/soa_solver.py in the same operation order.
//
// A sample's K contacts are spread over a group of L lanes (the group type G,
// last template parameter of each function; Solo, one thread a sample, by
// default): lane l holds contacts l*KL .. l*KL + KL - 1 (KL = K / L) of every
// cone field and of the contact Jacobian, and every lane holds the
// quantities of the whole sample (M, the Schur and Newton matrices and their
// factors, w). Work on one contact runs on its lane; a sum (or minimum) over
// the contacts is exchanged through the group's slots and folded in contact
// order c = 0, 1, ..., K-1 exactly as one thread folds it, so every lane
// holds the same value and the rounding is the plain version's. At L = 1 the
// exchanges are the folds themselves: the arithmetic of one thread a sample.
#pragma once

#include <cuda_runtime.h>
#include <cfloat>
#include <cmath>

namespace {

template <typename T> struct Num;
template <> struct Num<float> {
  static constexpr float machine_eps = FLT_EPSILON;
  static constexpr float max_finite = FLT_MAX;
  __device__ static float rsqrt_(float x) { return rsqrtf(x); }
};
template <> struct Num<double> {
  static constexpr double machine_eps = DBL_EPSILON;
  static constexpr double max_finite = DBL_MAX;
  __device__ static double rsqrt_(double x) { return rsqrt(x); }
};

// NaN-propagating helpers with the semantics of torch.clamp_min,
// torch.clamp_max, torch.minimum and torch.maximum.
template <typename T> __device__ __forceinline__ T clamp_min(T a, T c) {
  return a < c ? c : a;
}
template <typename T> __device__ __forceinline__ T clamp_max(T a, T c) {
  return a > c ? c : a;
}
template <typename T> __device__ __forceinline__ T pminimum(T a, T b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return b < a ? b : a;
}
template <typename T> __device__ __forceinline__ T pmaximum(T a, T b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return b > a ? b : a;
}
template <typename T> __device__ __forceinline__ T sign_(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : x);
}
template <typename T> __device__ __forceinline__ T nan_to_num(T x) {
  if (isnan(x)) return T(0);
  if (isinf(x)) return x > T(0) ? Num<T>::max_finite : -Num<T>::max_finite;
  return x;
}

// ---------------------------------------------------------------------------
// Exact fixed-point exits (solve_ipm's and sap_newton's kExits, which the
// cold solve takes apart: kIpmExits, kNewtonExits). An IPM iteration that
// applies no update leaves x, z and the merit-best iterate as they were, so
// every later iteration repeats it; a SAP-Newton iteration depends only on
// w, so once w comes out of the line search with its bits unchanged, every
// later one repeats it. Leaving the loop there gives the bits of the whole
// budget. On the card a warp leaves together, once every sample it holds
// is at its fixed point (the group's warp_all): the samples there first
// repeat their last iteration, with the same bits, so that the warp never
// runs two parts of the solve one after the other. The hook notes each
// exit: `fixed` iterations of loop `loop` (0 the IPM, 1 SAP-Newton) repeat
// the one before; a no-op on the card, a tally in the host build's count
// (ops/host_adjoint.py), which counts one sample's exits.
#ifndef HYBRID_SOLVE_EXIT_HOOK
#define HYBRID_SOLVE_EXIT_HOOK(loop, fixed) ((void)0)
#endif

// Whether b has a's bits: a finite a equal to b with the same sign (the
// only distinct finite values that compare equal are -0 and +0). A NaN or
// infinite a never matches, so a non-finite iterate never exits.
template <typename T> __device__ __forceinline__ bool same_finite_bits(T a,
                                                                      T b) {
  return isfinite(a) && a == b && signbit(a) == signbit(b);
}

// ---------------------------------------------------------------------------
// The lanes of one sample. A group type has kLanes, lane() and warp_all()
// (whether a condition holds for every sample of the warp the group runs
// in: the solve's exits leave a loop on it); with more than one lane also
// slots() (the group's scratch, kLaneSlots values) and sync() (a barrier of
// the group's lanes): WarpLanes below on the card, a thread per lane in the
// host build (ops/host_adjoint.py). Solo is one thread a sample on its own.
struct Solo {
  static constexpr int kLanes = 1;
  __device__ static constexpr int lane() { return 0; }
  __device__ static bool warp_all(bool p) { return p; }
};

// Slots a group of a sample with NV velocities and K contacts needs: rows of
// K terms (one slot of padding a row) and a result a row, for up to
// NV (NV + 1) / 2 rows (the lower triangle of an NV x NV matrix).
template <int NV, int K>
constexpr int kLaneSlots = (NV * (NV + 1) / 2) * (K + 2);

#ifdef __CUDACC__
// L consecutive lanes of a warp; slots in shared memory.
template <typename T, int L> struct WarpLanes {
  static_assert(L > 1 && 32 % L == 0, "a group is part of one warp");
  static constexpr int kLanes = L;
  T* slots_;
  unsigned mask_;
  int lane_;
  __device__ WarpLanes(T* slots) : slots_(slots) {
    const int in_warp = threadIdx.x % 32;
    lane_ = in_warp % L;
    mask_ = ((1u << L) - 1u) << (in_warp - lane_);
  }
  __device__ int lane() const { return lane_; }
  __device__ T* slots() const { return slots_; }
  __device__ void sync() const { __syncwarp(mask_); }
  // Every lane of the warp takes part: a kernel on lanes keeps all 32 of
  // each warp running to its end.
  __device__ bool warp_all(bool p) const { return __all_sync(~0u, p); }
};

// One thread a sample, the samples of a warp leaving the solve's loops
// together (warp_all); the kernel keeps all 32 threads of each warp
// running to its end.
struct WarpSolo {
  static constexpr int kLanes = 1;
  __device__ static constexpr int lane() { return 0; }
  __device__ static bool warp_all(bool p) { return __all_sync(~0u, p); }
};
#endif

// out[n] = the sum over the K contacts of term(n, c) (c the lane's own
// contacts' index), folded in contact order. On one thread each term is
// added as it is computed. Across lanes: each lane writes its terms, lane l
// folds rows l, l + L, ... (every lane folds every row when there are at
// most two), every lane reads the sums.
template <typename T, int N, int KL, typename G, typename F>
__device__ __forceinline__ void sum_rows(const G& g, const F& term,
                                         T (&out)[N]) {
  if constexpr (G::kLanes == 1) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      T acc = term(n, 0);
#pragma unroll
      for (int c = 1; c < KL; ++c) acc = acc + term(n, c);
      out[n] = acc;
    }
  } else {
    constexpr int K = KL * G::kLanes, W = K + 1;
    T* s = g.slots();
    g.sync();
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int c = 0; c < KL; ++c) s[n * W + g.lane() * KL + c] = term(n, c);
    g.sync();
    if constexpr (N <= 2) {
#pragma unroll
      for (int n = 0; n < N; ++n) {
        T acc = s[n * W];
#pragma unroll
        for (int c = 1; c < K; ++c) acc = acc + s[n * W + c];
        out[n] = acc;
      }
    } else {
      for (int n = g.lane(); n < N; n += G::kLanes) {
        T acc = s[n * W];
#pragma unroll
        for (int c = 1; c < K; ++c) acc = acc + s[n * W + c];
        s[N * W + n] = acc;
      }
      g.sync();
#pragma unroll
      for (int n = 0; n < N; ++n) out[n] = s[N * W + n];
    }
  }
}

// all[n][c] = t[n][c] of every contact c, on every lane (L > 1).
template <typename T, int N, int KL, typename G>
__device__ __forceinline__ void gather(const G& g, const T (&t)[N][KL],
                                       T (&all)[N][KL * G::kLanes]) {
  constexpr int K = KL * G::kLanes;
  T* s = g.slots();
  g.sync();
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int c = 0; c < KL; ++c) s[n * K + g.lane() * KL + c] = t[n][c];
  g.sync();
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int c = 0; c < K; ++c) all[n][c] = s[n * K + c];
}

// out[n] = the NaN-propagating minimum over the K contacts of term(n, c),
// folded in contact order.
template <typename T, int N, int KL, typename G, typename F>
__device__ __forceinline__ void min_rows(const G& g, const F& term,
                                         T (&out)[N]) {
  if constexpr (G::kLanes == 1) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      T acc = term(n, 0);
#pragma unroll
      for (int c = 1; c < KL; ++c) acc = pminimum(acc, term(n, c));
      out[n] = acc;
    }
  } else {
    constexpr int K = KL * G::kLanes;
    T mine[N][KL], all[N][K];
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int c = 0; c < KL; ++c) mine[n][c] = term(n, c);
    gather<T, N, KL, G>(g, mine, all);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      T acc = all[n][0];
#pragma unroll
      for (int c = 1; c < K; ++c) acc = pminimum(acc, all[n][c]);
      out[n] = acc;
    }
  }
}

// Whether `ok` holds on every lane of the group.
template <typename T, typename G>
__device__ __forceinline__ bool all_lanes(const G& g, bool ok) {
  if constexpr (G::kLanes == 1) {
    return ok;
  } else {
    T rows[1][1] = {{ok ? T(1) : T(0)}}, all[1][G::kLanes];
    gather<T, 1, 1, G>(g, rows, all);
    bool every = true;
#pragma unroll
    for (int l = 0; l < G::kLanes; ++l) every = every && all[0][l] != T(0);
    return every;
  }
}

// ---------------------------------------------------------------------------
// Per-sample state. Cone fields are [3][K]; the contact Jacobian [3][NV][K]
// (on a lane of a group, its own KL contacts' columns).
template <typename T, int NV, int K> struct Problem {
  T M[NV][NV];
  T J[3][NV][K];
  T q[3][K];
  T eps, inv_eps, half_eps;
};

// Reads sample b of a packed, batch-minor QP: M (NV*NV, B), Jc (3, NV, K,
// B), qc (3, K, B), the layout of ops/soa_kernels.pack_qp. On a lane of a
// group, M whole and the lane's own contacts' columns of Jc and qc.
template <typename T, int NV, int K, typename G = Solo>
__device__ __forceinline__ void load_packed_problem(
    const T* __restrict__ M, const T* __restrict__ Jc,
    const T* __restrict__ qc, long long B, long long b, double eps,
    Problem<T, NV, K / G::kLanes>& P, const G& g = G()) {
  constexpr int KL = K / G::kLanes;
  static_assert(KL * G::kLanes == K, "whole contacts a lane");
  const int c0 = g.lane() * KL;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < NV; ++j) P.M[i][j] = M[(i * NV + j) * B + b];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int c = 0; c < KL; ++c)
        P.J[i][v][c] = Jc[((i * NV + v) * K + c0 + c) * B + b];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < KL; ++c) P.q[i][c] = qc[(i * K + c0 + c) * B + b];
  P.eps = T(eps);
  P.inv_eps = T(1.0 / eps);
  P.half_eps = T(0.5 * eps);
}

template <typename T, int NV> struct Ldlt {
  T L[NV][NV];
  T dinv[NV];
};

template <typename T, int NV>
__device__ __forceinline__ void ldlt(const T (&M)[NV][NV], Ldlt<T, NV>& f) {
  T C[NV][NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    T s = M[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - f.L[j][k] * C[j][k];
    const T dj_inv = T(1) / s;
    f.dinv[j] = dj_inv;
#pragma unroll
    for (int i = j + 1; i < NV; ++i) {
      T c = M[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) c = c - f.L[i][k] * C[j][k];
      C[i][j] = c;
      f.L[i][j] = c * dj_inv;
    }
  }
}

template <typename T, int NV>
__device__ __forceinline__ void ldlt_solve(const Ldlt<T, NV>& f,
                                           const T (&rhs)[NV], T (&x)[NV]) {
  T y[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    T s = rhs[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - f.L[i][k] * y[k];
    y[i] = s;
  }
#pragma unroll
  for (int i = NV - 1; i >= 0; --i) {
    T s = y[i] * f.dinv[i];
#pragma unroll
    for (int k = i + 1; k < NV; ++k) s = s - f.L[k][i] * x[k];
    x[i] = s;
  }
}

template <typename T, int NV>
__device__ __forceinline__ T dot(const T (&a)[NV], const T (&b)[NV]) {
  T acc = a[0] * b[0];
#pragma unroll
  for (int i = 1; i < NV; ++i) acc = acc + a[i] * b[i];
  return acc;
}

template <typename T, int NV>
__device__ __forceinline__ void matvec(const T (&A)[NV][NV], const T (&x)[NV],
                                       T (&out)[NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) out[i] = dot<T, NV>(A[i], x);
}

// J w per cone: out[i][c] = 0 + sum_v J[i][v][c] w[v].
template <typename T, int NV, int K>
__device__ __forceinline__ void j_dot(const T (&J)[3][NV][K], const T (&w)[NV],
                                      T (&out)[3][K]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < K; ++c) {
      T acc = T(0);
#pragma unroll
      for (int v = 0; v < NV; ++v) acc = acc + J[i][v][c] * w[v];
      out[i][c] = acc;
    }
}

// J^T u summed over cones and components.
template <typename T, int NV, int K, typename G = Solo>
__device__ __forceinline__ void jt_dot(const T (&J)[3][NV][K],
                                       const T (&u)[3][K], T (&out)[NV],
                                       const G& g = G()) {
  sum_rows<T, NV, K, G>(
      g,
      [&](int v, int c) {
        return J[0][v][c] * u[0][c] + J[1][v][c] * u[1][c] +
               J[2][v][c] * u[2][c];
      },
      out);
}

template <typename T, int K, typename G = Solo>
__device__ __forceinline__ T field_sqnorm(const T (&u)[3][K],
                                          const G& g = G()) {
  T out[1];
  sum_rows<T, 1, K, G>(
      g,
      [&](int, int c) {
        return u[0][c] * u[0][c] + u[1][c] * u[1][c] + u[2][c] * u[2][c];
      },
      out);
  return out[0];
}

template <typename T, int K, typename G = Solo>
__device__ __forceinline__ T gap(const T (&x)[3][K], const T (&z)[3][K],
                                 const G& g = G()) {
  T out[1];
  sum_rows<T, 1, K, G>(
      g,
      [&](int, int c) {
        return x[0][c] * z[0][c] + x[1][c] * z[1][c] + x[2][c] * z[2][c];
      },
      out);
  return out[0] / (T(2) * T(K * G::kLanes));
}

// ---------------------------------------------------------------------------
// Lorentz-cone primitives on one cone (n, t1, t2).
template <typename T>
__device__ __forceinline__ T cone_det(T u0, T u1, T u2) {
  return u0 * u0 - u1 * u1 - u2 * u2;
}

template <typename T> struct Regions {
  T s_inv, s;
  bool in_cone, in_polar;
};

template <typename T>
__device__ __forceinline__ Regions<T> regions(T n, T t1, T t2) {
  Regions<T> r;
  const T sq = clamp_min(t1 * t1 + t2 * t2, T(1e-30));
  r.s_inv = Num<T>::rsqrt_(sq);
  r.s = sq * r.s_inv;
  r.in_cone = r.s <= n;
  r.in_polar = r.s <= -n;
  return r;
}

template <typename T>
__device__ __forceinline__ void project(T n, T t1, T t2, T& g0, T& g1, T& g2) {
  const Regions<T> r = regions(n, t1, t2);
  const T h = T(0.5) * (n + r.s);
  const T coeff = r.in_cone ? T(1) : (r.in_polar ? T(0) : h * r.s_inv);
  g0 = r.in_cone ? n : (r.in_polar ? T(0) : h);
  g1 = coeff * t1;
  g2 = coeff * t2;
}

// Fused (P(z), D(z) u).
template <typename T>
__device__ __forceinline__ void project_and_jacobian_apply(
    T n, T t1, T t2, T u0, T u1, T u2, T& g0, T& g1, T& g2, T& d0, T& d1,
    T& d2) {
  const Regions<T> r = regions(n, t1, t2);
  const T h = T(0.5) * (n + r.s);
  const T hos = h * r.s_inv;
  const T coeff = r.in_cone ? T(1) : (r.in_polar ? T(0) : hos);
  g0 = r.in_cone ? n : (r.in_polar ? T(0) : h);
  g1 = coeff * t1;
  g2 = coeff * t2;
  const T h1 = t1 * r.s_inv, h2 = t2 * r.s_inv;
  const T hd = h1 * u1 + h2 * u2;
  const T b0 = T(0.5) * (u0 + hd);
  const T b1 = T(0.5) * u0 * h1 + hos * (u1 - h1 * hd) + T(0.5) * h1 * hd;
  const T b2 = T(0.5) * u0 * h2 + hos * (u2 - h2 * hd) + T(0.5) * h2 * hd;
  d0 = r.in_cone ? u0 : (r.in_polar ? T(0) : b0);
  d1 = r.in_cone ? u1 : (r.in_polar ? T(0) : b1);
  d2 = r.in_cone ? u2 : (r.in_polar ? T(0) : b2);
}

// Fused (P(z), D(z)) with D a dense 3x3.
template <typename T>
__device__ __forceinline__ void project_and_jacobian_matrix(
    T n, T t1, T t2, T (&g)[3], T (&D)[3][3]) {
  const Regions<T> r = regions(n, t1, t2);
  const T h1 = t1 * r.s_inv, h2 = t2 * r.s_inv;
  const T h = T(0.5) * (n + r.s);
  const T hos = h * r.s_inv;
  const T coeff = r.in_cone ? T(1) : (r.in_polar ? T(0) : hos);
  g[0] = r.in_cone ? n : (r.in_polar ? T(0) : h);
  g[1] = coeff * t1;
  g[2] = coeff * t2;
  const T b[3][3] = {
      {T(0.5), T(0.5) * h1, T(0.5) * h2},
      {T(0.5) * h1, hos * (T(1) - h1 * h1) + T(0.5) * h1 * h1,
       (T(0.5) - hos) * h1 * h2},
      {T(0.5) * h2, (T(0.5) - hos) * h1 * h2,
       hos * (T(1) - h2 * h2) + T(0.5) * h2 * h2}};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      D[i][j] = r.in_cone ? (i == j ? T(1) : T(0))
                          : (r.in_polar ? T(0) : b[i][j]);
}

template <typename T>
__device__ __forceinline__ void arrow_solve(T u0, T u1, T u2, T b0, T b1, T b2,
                                            T& y0, T& y1, T& y2) {
  T d = cone_det(u0, u1, u2);
  d = fabs(d) > T(1e-30) ? d : T(1e-30);
  const T u0_inv = T(1) / u0;
  y0 = (u0 * b0 - u1 * b1 - u2 * b2) / d;
  y1 = (b1 - y0 * u1) * u0_inv;
  y2 = (b2 - y0 * u2) * u0_inv;
}

template <typename T>
__device__ __forceinline__ T step_to_boundary_one(T u0, T u1, T u2, T du0,
                                                  T du1, T du2) {
  const T A = cone_det(du0, du1, du2);
  const T B = T(2) * (u0 * du0 - u1 * du1 - u2 * du2);
  const T C = clamp_min(cone_det(u0, u1, u2), T(0));
  const T disc = B * B - T(4) * A * C;
  const T sqrt_disc = sqrt(clamp_min(disc, T(0)));
  const T tiny = T(1e-30);
  const T safe_A = fabs(A) > tiny ? A : tiny;
  const T safe_B = fabs(B) > tiny ? B : tiny;
  const T inv_2a = T(0.5) / safe_A;
  const T r1 = (-B - sqrt_disc) * inv_2a;
  const T r2 = (-B + sqrt_disc) * inv_2a;
  const T lin = -C / safe_B;
  const bool is_linear = fabs(A) <= T(1e-14) * clamp_min(fabs(B), T(1));
  const bool lin_crossing = is_linear && (B < T(0));
  const T root1 = is_linear ? (lin_crossing ? lin : T(2)) : r1;
  const T root2 = is_linear ? T(2) : r2;
  const bool disc_ok = disc >= T(0);
  const T pos1 = (root1 >= T(-1e-12) && disc_ok) ? clamp_min(root1, T(0))
                                                 : T(2);
  const T pos2 = (root2 >= T(-1e-12) && disc_ok) ? clamp_min(root2, T(0))
                                                 : T(2);
  const T alpha_det = pminimum(pos1, pos2);
  const T alpha_scalar =
      du0 < T(0) ? clamp_min(u0, T(0)) / (du0 < T(0) ? -du0 : tiny) : T(2);
  return pminimum(alpha_det, alpha_scalar);
}

// Min over cones, capped at 1, of the steps along du and along dv, and the
// smaller of the two (one exchange).
template <typename T, int K, typename G = Solo>
__device__ __forceinline__ T step_to_boundary2(const T (&u)[3][K],
                                               const T (&du)[3][K],
                                               const T (&dv)[3][K],
                                               const G& g = G()) {
  T alpha[2];
  min_rows<T, 2, K, G>(
      g,
      [&](int n, int c) {
        const T(&d)[3][K] = n == 0 ? du : dv;
        return step_to_boundary_one(u[0][c], u[1][c], u[2][c], d[0][c],
                                    d[1][c], d[2][c]);
      },
      alpha);
  return pminimum(clamp_max(alpha[0], T(1)), clamp_max(alpha[1], T(1)));
}

// NT scaling of one cone: v (det-1 Jordan square root), eta, 1/eta.
template <typename T, int K> struct NTScaling {
  T v[3][K];
  T eta[K];
  T eta_inv[K];

  __device__ __forceinline__ void apply(const T (&u)[3][K],
                                        T (&out)[3][K]) const {
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const T vu = v[0][c] * u[0][c] + v[1][c] * u[1][c] + v[2][c] * u[2][c];
      out[0][c] = eta[c] * (T(2) * v[0][c] * vu - u[0][c]);
      out[1][c] = eta[c] * (T(2) * v[1][c] * vu - (-u[1][c]));
      out[2][c] = eta[c] * (T(2) * v[2][c] * vu - (-u[2][c]));
    }
  }
};

template <typename T, int K>
__device__ __forceinline__ void nt_scaling(const T (&x)[3][K],
                                           const T (&z)[3][K],
                                           NTScaling<T, K>& s,
                                           T (&lam)[3][K]) {
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const T det_x = clamp_min(cone_det(x[0][c], x[1][c], x[2][c]), T(1e-30));
    const T det_z = clamp_min(cone_det(z[0][c], z[1][c], z[2][c]), T(1e-30));
    const T sx = Num<T>::rsqrt_(det_x);
    const T sz = Num<T>::rsqrt_(det_z);
    const T xb0 = x[0][c] * sx, xb1 = x[1][c] * sx, xb2 = x[2][c] * sx;
    const T zb0 = z[0][c] * sz, zb1 = z[1][c] * sz, zb2 = z[2][c] * sz;
    const T gamma2 =
        clamp_min(T(0.5) * (T(1) + (xb0 * zb0 + xb1 * zb1 + xb2 * zb2)),
                  T(1e-15));
    const T inv_2g = T(0.5) * Num<T>::rsqrt_(gamma2);
    const T wb0 = (zb0 + xb0) * inv_2g;
    const T wb1 = (zb1 + (-xb1)) * inv_2g;
    const T wb2 = (zb2 + (-xb2)) * inv_2g;
    const T denom = Num<T>::rsqrt_(T(2) * (wb0 + T(1)));
    s.v[0][c] = (wb0 + T(1)) * denom;
    s.v[1][c] = wb1 * denom;
    s.v[2][c] = wb2 * denom;
    const T eta2 = (det_z * sz) * sx;
    s.eta[c] = sqrt(eta2);
    s.eta_inv[c] = Num<T>::rsqrt_(eta2);
  }
  s.apply(x, lam);
}

// Inverse of W^2 + eps I per cone, as a symmetric 3x3.
template <typename T, int K>
__device__ __forceinline__ void nt_w2_inverse(const NTScaling<T, K>& s, T eps,
                                              T (&A_inv)[3][3][K]) {
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const T v0 = s.v[0][c], v1 = s.v[1][c], v2 = s.v[2][c];
    const T w0 = v0 * v0 + v1 * v1 + v2 * v2;
    const T w1 = v0 * v1 + v0 * v1;
    const T w2 = v0 * v2 + v0 * v2;
    const T eta2 = s.eta[c] * s.eta[c];
    const T a01 = eta2 * T(2) * w0 * w1;
    const T a02 = eta2 * T(2) * w0 * w2;
    const T a12 = eta2 * T(2) * w1 * w2;
    const T a = eta2 * (T(2) * w0 * w0 - T(1)) + eps;
    const T b = a01, cc = a02;
    const T d = eta2 * (T(2) * w1 * w1 + T(1)) + eps;
    const T e = a12;
    const T f = eta2 * (T(2) * w2 * w2 + T(1)) + eps;
    const T co_a = d * f - e * e;
    const T co_b = cc * e - b * f;
    const T co_c = b * e - cc * d;
    const T co_d = a * f - cc * cc;
    const T co_e = b * cc - a * e;
    const T co_f = a * d - b * b;
    T det3 = a * co_a + b * co_b + cc * co_c;
    det3 = fabs(det3) > T(1e-30) ? det3 : T(1e-30);
    const T inv = T(1) / det3;
    A_inv[0][0][c] = co_a * inv;
    A_inv[0][1][c] = co_b * inv;
    A_inv[0][2][c] = co_c * inv;
    A_inv[1][0][c] = co_b * inv;
    A_inv[1][1][c] = co_d * inv;
    A_inv[1][2][c] = co_e * inv;
    A_inv[2][0][c] = co_c * inv;
    A_inv[2][1][c] = co_e * inv;
    A_inv[2][2][c] = co_f * inv;
  }
}

// out = A (3x3 per cone) applied to a cone field.
template <typename T, int K>
__device__ __forceinline__ void cone_matvec(const T (&A)[3][3][K],
                                            const T (&u)[3][K],
                                            T (&out)[3][K]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < K; ++c)
      out[i][c] = A[i][0][c] * u[0][c] + A[i][1][c] * u[1][c] +
                  A[i][2][c] * u[2][c];
}

// Row v1 of lower-triangle entry n (entries (v1, v2 <= v1) in row order).
__device__ constexpr int tri_row(int n) {
  int r = 0;
  while ((r + 1) * (r + 2) / 2 <= n) ++r;
  return r;
}

// Symmetric M + scale * sum_c J^T G J, with G[i][j][c] per cone; the
// lower triangle's entries are folded over the contacts in one exchange.
template <typename T, int NV, int K, typename Grp = Solo>
__device__ __forceinline__ void assemble_jtgj(const T (&M)[NV][NV],
                                              const T (&J)[3][NV][K],
                                              const T (&G)[3][3][K],
                                              const T* scale, T (&S)[NV][NV],
                                              const Grp& g = Grp()) {
  constexpr int R = NV * (NV + 1) / 2;
  T GJ[3][NV][K];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int c = 0; c < K; ++c)
        GJ[i][v][c] = G[i][0][c] * J[0][v][c] + G[i][1][c] * J[1][v][c] +
                      G[i][2][c] * J[2][v][c];
  T sums[R];
  sum_rows<T, R, K, Grp>(
      g,
      [&](int n, int c) {
        const int v1 = tri_row(n), v2 = n - v1 * (v1 + 1) / 2;
        return J[0][v1][c] * GJ[0][v2][c] + J[1][v1][c] * GJ[1][v2][c] +
               J[2][v1][c] * GJ[2][v2][c];
      },
      sums);
#pragma unroll
  for (int v1 = 0; v1 < NV; ++v1)
#pragma unroll
    for (int v2 = 0; v2 <= v1; ++v2) {
      T acc = sums[v1 * (v1 + 1) / 2 + v2];
      if (scale != nullptr) acc = *scale * acc;
      S[v1][v2] = M[v1][v2] + acc;
      if (v2 < v1) S[v2][v1] = M[v2][v1] + acc;
    }
}

// ---------------------------------------------------------------------------
// Interior point (cf. soa_solver.solve_ipm_mj). With kExits the loop ends
// at the first iteration that applies no update (of every sample of the
// warp): at once when mu is frozen, after the step when the step is not
// finite.
template <typename T, int NV, int K, typename G = Solo, bool kExits = false>
__device__ void solve_ipm(const Problem<T, NV, K>& P, int iterations,
                          T (&x_out)[3][K], const G& g = G()) {
  Ldlt<T, NV> F_M;
  ldlt<T, NV>(P.M, F_M);
  const T eps = P.eps;

  auto q_dot = [&](const T (&x)[3][K], T (&out)[3][K]) {
    T jtx[NV], h[NV], jw[3][K];
    jt_dot<T, NV, K, G>(P.J, x, jtx, g);
    ldlt_solve<T, NV>(F_M, jtx, h);
    j_dot<T, NV, K>(P.J, h, jw);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int c = 0; c < K; ++c) out[i][c] = jw[i][c] + eps * x[i][c];
  };
  // gap + |r| + 1e6 (violation(x) + violation(z)): the four sums over
  // contacts in one exchange.
  auto merit = [&](const T (&x)[3][K], const T (&z)[3][K],
                   const T (&r)[3][K]) {
    T sums[4];
    sum_rows<T, 4, K, G>(
        g,
        [&](int n, int c) -> T {
          if (n == 0)
            return x[0][c] * z[0][c] + x[1][c] * z[1][c] + x[2][c] * z[2][c];
          if (n == 1)
            return r[0][c] * r[0][c] + r[1][c] * r[1][c] + r[2][c] * r[2][c];
          const T(&u)[3][K] = n == 2 ? x : z;
          return clamp_min(
              sqrt(u[1][c] * u[1][c] + u[2][c] * u[2][c]) - u[0][c], T(0));
        },
        sums);
    const T mu = sums[0] / (T(2) * T(K * G::kLanes));
    return mu + sqrt(sums[1]) + T(1e6) * (sums[2] + sums[3]);
  };

  const T scale = clamp_min(
      sqrt(field_sqnorm<T, K, G>(P.q, g) / T(3 * K * G::kLanes)), T(1));
  const T sqrt_scale = sqrt(scale);
  T x[3][K], z[3][K], x_best[3][K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    x[0][c] = sqrt_scale;
    x[1][c] = T(0);
    x[2][c] = T(0);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < K; ++c) {
      z[i][c] = x[i][c];
      x_best[i][c] = x[i][c];
    }
  T merit_best = T(INFINITY);
  const T freeze = T(100) * Num<T>::machine_eps * scale;

#pragma unroll 1
  for (int it = 0; it < iterations; ++it) {
    T r[3][K];
    {
      T qx[3][K];
      q_dot(x, qx);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int c = 0; c < K; ++c) r[i][c] = qx[i][c] + P.q[i][c] - z[i][c];
    }
    const T mu = gap<T, K, G>(x, z, g);
    const T m = merit(x, z, r);
    const bool better = isfinite(m) && (m < merit_best);
    if (better) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int c = 0; c < K; ++c) x_best[i][c] = x[i][c];
      merit_best = m;
    }
    if constexpr (kExits) {
      if (g.warp_all(mu <= freeze)) {
        HYBRID_SOLVE_EXIT_HOOK(0, iterations - it);
        break;
      }
    }

    NTScaling<T, K> scaling;
    T lam[3][K];
    nt_scaling<T, K>(x, z, scaling, lam);
    T A_inv[3][3][K];
    nt_w2_inverse<T, K>(scaling, eps, A_inv);
    Ldlt<T, NV> F_S;
    {
      T S[NV][NV];
      assemble_jtgj<T, NV, K, G>(P.M, P.J, A_inv, nullptr, S, g);
      ldlt<T, NV>(S, F_S);
    }

    // Returns (dx, W dx, W^-1 dz); dz from W^-1 dz + W dx = d.
    auto kkt_solve = [&](const T (&d)[3][K], T (&dx)[3][K], T (&wdx)[3][K],
                         T (&wizd)[3][K]) {
      T wd[3][K], rhs[3][K], u[3][K], jtu[NV], h[NV], jh[3][K], ajh[3][K];
      scaling.apply(d, wd);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int c = 0; c < K; ++c) rhs[i][c] = wd[i][c] - r[i][c];
      cone_matvec<T, K>(A_inv, rhs, u);
      jt_dot<T, NV, K, G>(P.J, u, jtu, g);
      ldlt_solve<T, NV>(F_S, jtu, h);
      j_dot<T, NV, K>(P.J, h, jh);
      cone_matvec<T, K>(A_inv, jh, ajh);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int c = 0; c < K; ++c) dx[i][c] = u[i][c] - ajh[i][c];
      scaling.apply(dx, wdx);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int c = 0; c < K; ++c) wizd[i][c] = d[i][c] - wdx[i][c];
    };

    // Affine (predictor) step in NT-scaled coordinates.
    T ll[3][K], d[3][K], dx[3][K], wdx_aff[3][K], wizd_aff[3][K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      ll[0][c] = lam[0][c] * lam[0][c] + lam[1][c] * lam[1][c] +
                 lam[2][c] * lam[2][c];
      ll[1][c] = lam[0][c] * lam[1][c] + lam[0][c] * lam[1][c];
      ll[2][c] = lam[0][c] * lam[2][c] + lam[0][c] * lam[2][c];
      arrow_solve(lam[0][c], lam[1][c], lam[2][c], -ll[0][c], -ll[1][c],
                  -ll[2][c], d[0][c], d[1][c], d[2][c]);
    }
    kkt_solve(d, dx, wdx_aff, wizd_aff);
    const T alpha_aff =
        step_to_boundary2<T, K, G>(lam, wdx_aff, wizd_aff, g);
    T mu_aff;
    {
      T la_x[3][K], la_z[3][K];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int c = 0; c < K; ++c) {
          la_x[i][c] = lam[i][c] + alpha_aff * wdx_aff[i][c];
          la_z[i][c] = lam[i][c] + alpha_aff * wizd_aff[i][c];
        }
      mu_aff = gap<T, K, G>(la_x, la_z, g);
    }
    const T ratio = mu_aff / clamp_min(mu, T(1e-30));
    T sigma = ratio * ratio * ratio;
    sigma = sigma < T(0) ? T(0) : (sigma > T(1) ? T(1) : sigma);

    // Corrector step (same Schur factorization).
    T wdx[3][K], wizd[3][K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const T c0 = wdx_aff[0][c] * wizd_aff[0][c] +
                   wdx_aff[1][c] * wizd_aff[1][c] +
                   wdx_aff[2][c] * wizd_aff[2][c];
      const T c1 = wdx_aff[0][c] * wizd_aff[1][c] +
                   wizd_aff[0][c] * wdx_aff[1][c];
      const T c2 = wdx_aff[0][c] * wizd_aff[2][c] +
                   wizd_aff[0][c] * wdx_aff[2][c];
      arrow_solve(lam[0][c], lam[1][c], lam[2][c],
                  sigma * mu - ll[0][c] - c0, -ll[1][c] - c1,
                  -ll[2][c] - c2, d[0][c], d[1][c], d[2][c]);
    }
    kkt_solve(d, dx, wdx, wizd);
    T dz[3][K];
    scaling.apply(wizd, dz);

    const T alpha = T(0.99) * step_to_boundary2<T, K, G>(lam, wdx, wizd, g);
    const bool converged = mu <= freeze;
    bool finite = true;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int c = 0; c < K; ++c)
        finite = finite && isfinite(dx[i][c]) && isfinite(dz[i][c]);
    const bool step_ok = all_lanes<T, G>(g, finite);
    if (step_ok && !converged) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int c = 0; c < K; ++c) {
          x[i][c] = x[i][c] + alpha * dx[i][c];
          z[i][c] = z[i][c] + alpha * dz[i][c];
        }
    }
    if constexpr (kExits) {
      if (g.warp_all(!(step_ok && !converged))) {
        HYBRID_SOLVE_EXIT_HOOK(0, iterations - it);
        break;
      }
    }
  }

  T r_final[3][K];
  {
    T qx[3][K];
    q_dot(x, qx);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int c = 0; c < K; ++c)
        r_final[i][c] = qx[i][c] + P.q[i][c] - z[i][c];
  }
  const T m_final = merit(x, z, r_final);
  const bool take_last = isfinite(m_final) && (m_final < merit_best);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < K; ++c) x_out[i][c] = take_last ? x[i][c] : x_best[i][c];
}

// ---------------------------------------------------------------------------
// SAP-Newton (cf. soa_solver.sap_newton, _line_search, primal_cost).
template <typename T, int NV, int K>
__device__ __forceinline__ void sap_argument(const Problem<T, NV, K>& P,
                                             const T (&w)[NV], T (&z)[3][K]) {
  T jw[3][K];
  j_dot<T, NV, K>(P.J, w, jw);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < K; ++c) z[i][c] = -(jw[i][c] + P.q[i][c]) * P.inv_eps;
}

template <typename T, int NV, int K, typename G = Solo>
__device__ T primal_cost(const Problem<T, NV, K>& P, const T (&w)[NV],
                         const G& g = G()) {
  T jw[3][K];
  j_dot<T, NV, K>(P.J, w, jw);
  T sq[1];
  sum_rows<T, 1, K, G>(
      g,
      [&](int, int c) {
        T g0, g1, g2;
        project(-(jw[0][c] + P.q[0][c]) / P.eps,
                -(jw[1][c] + P.q[1][c]) / P.eps,
                -(jw[2][c] + P.q[2][c]) / P.eps, g0, g1, g2);
        return g0 * g0 + g1 * g1 + g2 * g2;
      },
      sq);
  T Mw[NV];
  matvec<T, NV>(P.M, w, Mw);
  const T quad = T(0.5) * dot<T, NV>(w, Mw);
  return quad + P.half_eps * sq[0];
}

template <typename T, int K, typename G = Solo>
__device__ __forceinline__ T g_prime_at(T alpha, T a0, T a1, T eps,
                                        const T (&z0)[3][K],
                                        const T (&dz)[3][K],
                                        const G& g = G()) {
  T acc[1];
  sum_rows<T, 1, K, G>(
      g,
      [&](int, int c) {
        T g0, g1, g2;
        project(z0[0][c] + alpha * dz[0][c], z0[1][c] + alpha * dz[1][c],
                z0[2][c] + alpha * dz[2][c], g0, g1, g2);
        return dz[0][c] * g0 + dz[1][c] * g1 + dz[2][c] * g2;
      },
      acc);
  return a0 + a1 * alpha + eps * acc[0];
}

template <typename T, int NV, int K, typename G = Solo>
__device__ void line_search(const Problem<T, NV, K>& P, T (&w)[NV],
                            const T (&dw)[NV], const G& g = G()) {
  T z0[3][K], dz[3][K];
  sap_argument<T, NV, K>(P, w, z0);
  {
    T jdw[3][K];
    j_dot<T, NV, K>(P.J, dw, jdw);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int c = 0; c < K; ++c) dz[i][c] = -jdw[i][c] * P.inv_eps;
  }
  T a0, a1;
  {
    T Mw[NV];
    matvec<T, NV>(P.M, w, Mw);
    a0 = dot<T, NV>(dw, Mw);
    matvec<T, NV>(P.M, dw, Mw);
    a1 = dot<T, NV>(dw, Mw);
  }

  // Candidates 0, the 2K crease breakpoints, 1; g' is nondecreasing along
  // the ray, so the bracket needs no sort.
  const T big = T(2);
  T lo = -big, hi = big;
  auto consider = [&](T c) {
    const T gp = g_prime_at<T, K, G>(c, a0, a1, P.eps, z0, dz, g);
    lo = pmaximum(lo, gp <= T(0) ? c : -big);
    hi = pminimum(hi, gp > T(0) ? c : big);
    return gp;
  };
  T roots[2][K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const T n0 = z0[0][c], dn = dz[0][c];
    const T A = dz[1][c] * dz[1][c] + dz[2][c] * dz[2][c] - dn * dn;
    const T B = T(2) * (z0[1][c] * dz[1][c] + z0[2][c] * dz[2][c] - n0 * dn);
    const T C = z0[1][c] * z0[1][c] + z0[2][c] * z0[2][c] - n0 * n0;
    const T disc = B * B - T(4) * A * C;
    const T sqrt_disc = sqrt(clamp_min(disc, T(0)));
    const T tiny = T(1e-30);
    const T safe_A = fabs(A) > tiny ? A : tiny;
    const T safe_B = fabs(B) > tiny ? B : tiny;
    T r1 = (-B - sign_(safe_B) * sqrt_disc) / (T(2) * safe_A);
    const T den = safe_A * r1;
    T r2 = C / (fabs(den) > tiny ? den : tiny);
    const T lin = -C / safe_B;
    const bool is_linear = fabs(A) <= T(1e-12) * clamp_min(fabs(B), T(1));
    r1 = is_linear ? lin : r1;
    r2 = is_linear ? T(1) : r2;
    const bool no_root = (disc < T(0)) && !is_linear;
    const bool v1 = (r1 > T(1e-12)) && (r1 < T(1)) && !no_root;
    const bool v2 = (r2 > T(1e-12)) && (r2 < T(1)) && !no_root;
    roots[0][c] = v1 ? r1 : T(1);
    roots[1][c] = v2 ? r2 : T(1);
  }
  bool take_full;
  if constexpr (G::kLanes == 1) {
    consider(T(0));
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < K; ++c) consider(roots[j][c]);
    take_full = consider(T(1)) <= T(0);
  } else {
    // The candidates 0, every contact's roots in contact order, then 1.
    // Each one's g' is independent of the others', so their sums over the
    // contacts are one exchange; the bracket then takes them in order.
    constexpr int KT = K * G::kLanes, NC = 2 * KT + 2;
    T cand[NC];
    {
      T all_roots[2][KT];
      gather<T, 2, K, G>(g, roots, all_roots);
      cand[0] = T(0);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < KT; ++c) cand[1 + j * KT + c] = all_roots[j][c];
      cand[NC - 1] = T(1);
    }
    T sums[NC];
    sum_rows<T, NC, K, G>(
        g,
        [&](int n, int c) {
          T g0, g1, g2;
          project(z0[0][c] + cand[n] * dz[0][c],
                  z0[1][c] + cand[n] * dz[1][c],
                  z0[2][c] + cand[n] * dz[2][c], g0, g1, g2);
          return dz[0][c] * g0 + dz[1][c] * g1 + dz[2][c] * g2;
        },
        sums);
    T gp = T(0);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      gp = a0 + a1 * cand[n] + P.eps * sums[n];
      lo = pmaximum(lo, gp <= T(0) ? cand[n] : -big);
      hi = pminimum(hi, gp > T(0) ? cand[n] : big);
    }
    take_full = gp <= T(0);
  }
  lo = clamp_min(lo, T(0));
  hi = hi > T(1) ? T(1) : hi;
  hi = pmaximum(hi, lo);

  T alpha = T(0.5) * (lo + hi);
#pragma unroll 1
  for (int step = 0; step < 6; ++step) {
    T terms[2][K], sums[2];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      T g0, g1, g2, d0, d1, d2;
      project_and_jacobian_apply(
          z0[0][c] + alpha * dz[0][c], z0[1][c] + alpha * dz[1][c],
          z0[2][c] + alpha * dz[2][c], dz[0][c], dz[1][c], dz[2][c], g0, g1,
          g2, d0, d1, d2);
      terms[0][c] = dz[0][c] * g0 + dz[1][c] * g1 + dz[2][c] * g2;
      terms[1][c] = dz[0][c] * d0 + dz[1][c] * d1 + dz[2][c] * d2;
    }
    sum_rows<T, 2, K, G>(
        g, [&](int n, int c) { return terms[n][c]; }, sums);
    const T gp_a = a0 + a1 * alpha + P.eps * sums[0];
    const T gpp_a = clamp_min(a1 + P.eps * sums[1], T(1e-30));
    lo = gp_a <= T(0) ? alpha : lo;
    hi = gp_a > T(0) ? alpha : hi;
    const T newton = alpha - gp_a / gpp_a;
    const bool inside = (newton > lo) && (newton < hi);
    alpha = inside ? newton : T(0.5) * (lo + hi);
  }
  alpha = take_full ? T(1) : alpha;
#pragma unroll
  for (int i = 0; i < NV; ++i) w[i] = w[i] + alpha * dw[i];
}

// With kExits the loop ends once the line search leaves w's bits as they
// were (of every sample of the warp; w is the same on every lane of a
// group).
template <typename T, int NV, int K, typename G = Solo, bool kExits = false>
__device__ void sap_newton(const Problem<T, NV, K>& P, int iterations,
                           T (&w)[NV], T (&gamma)[3][K], const G& g = G()) {
#pragma unroll 1
  for (int it = 0; it < iterations; ++it) {
    T z[3][K], gc[3][K], D[3][3][K];
    sap_argument<T, NV, K>(P, w, z);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      T pc[3], Dc[3][3];
      project_and_jacobian_matrix(z[0][c], z[1][c], z[2][c], pc, Dc);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        gc[i][c] = pc[i];
#pragma unroll
        for (int j = 0; j < 3; ++j) D[i][j][c] = Dc[i][j];
      }
    }
    T grad[NV];
    {
      T Mw[NV], jtg[NV];
      matvec<T, NV>(P.M, w, Mw);
      jt_dot<T, NV, K, G>(P.J, gc, jtg, g);
#pragma unroll
      for (int i = 0; i < NV; ++i) grad[i] = Mw[i] - jtg[i];
    }
    T dw[NV];
    {
      T H[NV][NV];
      assemble_jtgj<T, NV, K, G>(P.M, P.J, D, &P.inv_eps, H, g);
#pragma unroll
      for (int i = 0; i < NV; ++i) H[i][i] = H[i][i] + T(1e-10);
      Ldlt<T, NV> F_H;
      ldlt<T, NV>(H, F_H);
      ldlt_solve<T, NV>(F_H, grad, dw);
#pragma unroll
      for (int i = 0; i < NV; ++i) dw[i] = -dw[i];
    }
    if constexpr (kExits) {
      T w_before[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) w_before[i] = w[i];
      line_search<T, NV, K, G>(P, w, dw, g);
      bool fixed = true;
#pragma unroll
      for (int i = 0; i < NV; ++i)
        fixed = fixed && same_finite_bits(w_before[i], w[i]);
      if (g.warp_all(fixed)) {
        HYBRID_SOLVE_EXIT_HOOK(1, iterations - it);
        break;
      }
    } else {
      line_search<T, NV, K, G>(P, w, dw, g);
    }
  }
  T z[3][K];
  sap_argument<T, NV, K>(P, w, z);
#pragma unroll
  for (int c = 0; c < K; ++c)
    project(z[0][c], z[1][c], z[2][c], gamma[0][c], gamma[1][c], gamma[2][c]);
}

// ---------------------------------------------------------------------------
// Whole solves of one sample (cf. soa_solver._mask_failures,
// solve_contact_impulse_soa and solve_warm_hybrid_soa).

// Failure mask: a non-finite or |gamma| > 1e3 impulse is zeroed; returns
// whether the sample is valid.
template <typename T, int K, typename G = Solo>
__device__ __forceinline__ bool mask_failures(T (&gamma)[3][K],
                                              const G& g = G()) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < K; ++c) ok = ok && isfinite(gamma[i][c]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < K; ++c) ok = ok && (fabs(gamma[i][c]) <= T(1e3));
  const bool valid = all_lanes<T, G>(g, ok);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < K; ++c)
      gamma[i][c] = valid ? nan_to_num(gamma[i][c]) : T(0);
  return valid;
}

// w = M^-1 J^T u.
template <typename T, int NV, int K, typename G = Solo>
__device__ __forceinline__ void minv_jt(const Problem<T, NV, K>& P,
                                        const T (&u)[3][K], T (&w)[NV],
                                        const G& g = G()) {
  T jtu[NV];
  jt_dot<T, NV, K, G>(P.J, u, jtu, g);
  Ldlt<T, NV> F_M;
  ldlt<T, NV>(P.M, F_M);
  ldlt_solve<T, NV>(F_M, jtu, w);
}

// Cold hybrid solve: IPM, then SAP-Newton from the IPM iterate;
// kIpmExits and kNewtonExits leave each loop at its fixed point (the same
// bits).
template <typename T, int NV, int K, typename G = Solo,
          bool kIpmExits = false, bool kNewtonExits = kIpmExits>
__device__ bool cold_hybrid_solve(const Problem<T, NV, K>& P,
                                  int ipm_iterations, int newton_iterations,
                                  T (&gamma)[3][K], const G& g = G()) {
  T x_ipm[3][K];
  solve_ipm<T, NV, K, G, kIpmExits>(P, ipm_iterations, x_ipm, g);
  T w[NV];
  minv_jt<T, NV, K, G>(P, x_ipm, w, g);
  sap_newton<T, NV, K, G, kNewtonExits>(P, newton_iterations, w, gamma, g);
  return mask_failures<T, K, G>(gamma, g);
}

// Warm-started hybrid solve: a short IPM, then SAP-Newton from the better
// (by primal cost) of the carried primal w and the IPM iterate. On return
// w holds the final primal, zeroed (and NaN-free) where the sample failed.
template <typename T, int NV, int K, typename G = Solo>
__device__ bool warm_hybrid_solve(const Problem<T, NV, K>& P,
                                  int ipm_iterations, int newton_iterations,
                                  T (&w)[NV], T (&gamma)[3][K],
                                  const G& g = G()) {
  T x_ipm[3][K];
  solve_ipm<T, NV, K, G>(P, ipm_iterations, x_ipm, g);
  T w_ipm[NV];
  minv_jt<T, NV, K, G>(P, x_ipm, w_ipm, g);
  const T cost_carry = primal_cost<T, NV, K, G>(P, w, g);
  const T cost_ipm = primal_cost<T, NV, K, G>(P, w_ipm, g);
  const bool carry_better = cost_carry < cost_ipm;
#pragma unroll
  for (int i = 0; i < NV; ++i) w[i] = carry_better ? w[i] : w_ipm[i];
  sap_newton<T, NV, K, G>(P, newton_iterations, w, gamma, g);
  const bool valid = mask_failures<T, K, G>(gamma, g);
#pragma unroll
  for (int i = 0; i < NV; ++i) w[i] = valid ? nan_to_num(w[i]) : T(0);
  return valid;
}

// K5's body: the warm solve of sample b of a packed QP (w0 (NV, B) the
// carried primal) on one thread or on the lanes of a group. Writes the
// lane's contacts' impulses into force (3, K, B), and (lane 0) the final
// primal into w_out (NV, B) and the valid byte, unless `store` is false (a
// group past the batch, which solves its last sample again so that its
// lanes meet every exchange).
template <typename T, int NV, int K, typename G = Solo>
__device__ __forceinline__ void warm_solve_packed(
    const T* __restrict__ M, const T* __restrict__ Jc,
    const T* __restrict__ qc, const T* __restrict__ w0,
    T* __restrict__ force, T* __restrict__ w_out,
    unsigned char* __restrict__ valid_out, long long B, long long b,
    bool store, double eps, int ipm_iterations, int newton_iterations,
    const G& g = G()) {
  constexpr int KL = K / G::kLanes;
  Problem<T, NV, KL> P;
  load_packed_problem<T, NV, K, G>(M, Jc, qc, B, b, eps, P, g);
  T w[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) w[i] = w0[i * B + b];
  T gamma[3][KL];
  const bool valid = warm_hybrid_solve<T, NV, KL, G>(
      P, ipm_iterations, newton_iterations, w, gamma, g);
  if (!store) return;
  const int c0 = g.lane() * KL;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < KL; ++c) force[(i * K + c0 + c) * B + b] = gamma[i][c];
  if (g.lane() == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) w_out[i * B + b] = w[i];
    valid_out[b] = valid ? 1 : 0;
  }
}

// K4's body: the cold solve of sample b of a packed QP on one thread or on
// the lanes of a group, with the IPM's and SAP-Newton's fixed-point exits
// as chosen. Writes the lane's contacts' impulses into force (3, K, B) and
// (lane 0) the valid byte, unless `store` is false (a group past the
// batch, as in warm_solve_packed).
template <typename T, int NV, int K, typename G = Solo,
          bool kIpmExits = false, bool kNewtonExits = kIpmExits>
__device__ __forceinline__ void cold_solve_packed(
    const T* __restrict__ M, const T* __restrict__ Jc,
    const T* __restrict__ qc, T* __restrict__ force,
    unsigned char* __restrict__ valid_out, long long B, long long b,
    bool store, double eps, int ipm_iterations, int newton_iterations,
    const G& g = G()) {
  constexpr int KL = K / G::kLanes;
  Problem<T, NV, KL> P;
  load_packed_problem<T, NV, K, G>(M, Jc, qc, B, b, eps, P, g);
  T gamma[3][KL];
  const bool valid = cold_hybrid_solve<T, NV, KL, G, kIpmExits,
                                       kNewtonExits>(
      P, ipm_iterations, newton_iterations, gamma, g);
  if (!store) return;
  const int c0 = g.lane() * KL;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < KL; ++c) force[(i * K + c0 + c) * B + b] = gamma[i][c];
  if (g.lane() == 0) valid_out[b] = valid ? 1 : 0;
}

// Lanes a QP of K5 at a size: 4 at the elbow's k = 8 (two contacts a
// lane; 2 and 8 lanes were slower on an H100 at the rollout's 8,192 QPs)
// and at the cube's k = 4 (one contact a lane; one thread and 2 lanes were
// slower there). scripts/probe_loss_lanes.py --solves, PERF.md. Large
// float32 batches at the cube's size run one thread a QP instead
// (kWarmSoloFrom, warm_hybrid_solve.cuh).
// Other sizes split their contacts evenly over 4 or 2 lanes, or run one
// thread a QP where k is odd.
template <int NV, int K>
constexpr int kWarmLanes = K % 4 == 0 ? 4 : (K % 2 == 0 ? 2 : 1);

// Lanes a QP of K4 at a size: 4, as K5 (two contacts a lane at the elbow's
// k = 8, one at the cube's k = 4; 1, 2 and 8 lanes were slower on an H100
// at the elbow's 65,536 contact-rich QPs and the cube's 8,192). Large
// batches at the cube's size run fewer (kColdFewerFrom,
// cold_hybrid_solve.cuh). scripts/probe_loss_lanes.py --k4, PERF.md.
// Other sizes as K5's (kWarmLanes).
template <int NV, int K> constexpr int kColdLanes = kWarmLanes<NV, K>;

}  // namespace
