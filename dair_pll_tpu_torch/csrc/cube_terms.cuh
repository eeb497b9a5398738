// ContactNets loss terms of the cube for one sample per CUDA thread.
//
// A templated counterpart of dair_pll_tpu_torch/multibody/soa_terms.py's
// soa_loss_parts and soa_loss_assemble, specialised to the cube: one free
// body, a ground plane (world frame) against a box (body frame) with
// n_query = 4 witness points, and the P = 15 derived scalars of
// ops/soa_loss_kernels.pack_derived: pi (10), mu of the plane and of the
// box, the box half lengths (3). Every product and sum comes in the plain
// version's order, so that in float64 the two agree to the last bits (the
// library is built without fused multiply-adds).
//
// The scalar type T is float, double, or a forward-mode dual number
// Dual<S> of either. The Coriolis terms take the time derivative of the
// rotation along qdot with one more dual level (the plain version's
// torch.func.jvp), so the backward kernel, which seeds one input direction
// at a time in Dual<S>, runs the kinematics in Dual<Dual<S>>.
//
// The per-sample loss functions at the end (cube_loss_cold, cube_loss_warm,
// cube_loss_grad) are what the kernels of contactnets_loss.cu run.
#pragma once

#include "hybrid_solve.cuh"

namespace {

// ---------------------------------------------------------------------------
// Forward-mode dual numbers.
template <typename S> struct Dual;

template <typename T> struct BaseOf { using type = T; };
template <typename S> struct BaseOf<Dual<S>> {
  using type = typename BaseOf<S>::type;
};
// The float or double at the bottom of a (nested) dual type.
template <typename T> using base_t = typename BaseOf<T>::type;

template <typename S> struct Dual {
  S v;  // value
  S d;  // derivative along the seeded direction
  Dual() = default;
  __device__ __forceinline__ Dual(S value, S deriv) : v(value), d(deriv) {}
  // A constant: zero derivative.
  __device__ __forceinline__ explicit Dual(base_t<S> c)
      : v(c), d(base_t<S>(0)) {}
};

template <typename S>
__device__ __forceinline__ Dual<S> operator+(const Dual<S>& a,
                                             const Dual<S>& b) {
  return Dual<S>(a.v + b.v, a.d + b.d);
}
template <typename S>
__device__ __forceinline__ Dual<S> operator-(const Dual<S>& a,
                                             const Dual<S>& b) {
  return Dual<S>(a.v - b.v, a.d - b.d);
}
template <typename S>
__device__ __forceinline__ Dual<S> operator*(const Dual<S>& a,
                                             const Dual<S>& b) {
  return Dual<S>(a.v * b.v, a.d * b.v + a.v * b.d);
}
template <typename S>
__device__ __forceinline__ Dual<S> operator/(const Dual<S>& a,
                                             const Dual<S>& b) {
  const S r = a.v / b.v;
  return Dual<S>(r, (a.d - r * b.d) / b.v);
}
template <typename S>
__device__ __forceinline__ Dual<S> operator-(const Dual<S>& a) {
  return Dual<S>(-a.v, -a.d);
}
// Mixed with a constant of the base type.
template <typename S>
__device__ __forceinline__ Dual<S> operator+(const Dual<S>& a, base_t<S> c) {
  return Dual<S>(a.v + c, a.d);
}
template <typename S>
__device__ __forceinline__ Dual<S> operator+(base_t<S> c, const Dual<S>& a) {
  return Dual<S>(c + a.v, a.d);
}
template <typename S>
__device__ __forceinline__ Dual<S> operator-(const Dual<S>& a, base_t<S> c) {
  return Dual<S>(a.v - c, a.d);
}
template <typename S>
__device__ __forceinline__ Dual<S> operator-(base_t<S> c, const Dual<S>& a) {
  return Dual<S>(c - a.v, -a.d);
}
template <typename S>
__device__ __forceinline__ Dual<S> operator*(const Dual<S>& a, base_t<S> c) {
  return Dual<S>(a.v * c, a.d * c);
}
template <typename S>
__device__ __forceinline__ Dual<S> operator*(base_t<S> c, const Dual<S>& a) {
  return Dual<S>(c * a.v, c * a.d);
}

__device__ __forceinline__ float primal(float x) { return x; }
__device__ __forceinline__ double primal(double x) { return x; }
template <typename S>
__device__ __forceinline__ base_t<S> primal(const Dual<S>& x) {
  return primal(x.v);
}

__device__ __forceinline__ float sqrt_(float x) { return sqrt(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
template <typename S>
__device__ __forceinline__ Dual<S> sqrt_(const Dual<S>& a) {
  const S r = sqrt_(a.v);
  return Dual<S>(r, a.d / (base_t<S>(2) * r));
}

// |x| with derivative sign(x), 0 at 0 (as torch and JAX differentiate it).
__device__ __forceinline__ float abs_(float x) { return fabs(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }
template <typename S>
__device__ __forceinline__ Dual<S> abs_(const Dual<S>& a) {
  const base_t<S> p = primal(a);
  if (p > base_t<S>(0)) return a;
  if (p < base_t<S>(0)) return -a;
  return Dual<S>(abs_(a.v), S(base_t<S>(0)));
}

// ---------------------------------------------------------------------------
// Small dense algebra on any scalar type, in soa.py's order of operations.
template <typename T>
__device__ __forceinline__ void matvec3(const T (&A)[3][3], const T (&x)[3],
                                        T (&out)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = A[i][0] * x[0] + A[i][1] * x[1] +
                                       A[i][2] * x[2];
}

template <typename T>
__device__ __forceinline__ void skew3(const T (&v)[3], T (&S)[3][3]) {
  const T z = T(0);
  S[0][0] = z;     S[0][1] = -v[2]; S[0][2] = v[1];
  S[1][0] = v[2];  S[1][1] = z;     S[1][2] = -v[0];
  S[2][0] = -v[1]; S[2][1] = v[0];  S[2][2] = z;
}

// soa.dot over n entries: the first product, then the rest added in order.
template <typename T, int N>
__device__ __forceinline__ T dot_n(const T (&a)[N], const T (&b)[N]) {
  T acc = a[0] * b[0];
#pragma unroll
  for (int i = 1; i < N; ++i) acc = acc + a[i] * b[i];
  return acc;
}

// soa.quat_to_rotmat of a wxyz quaternion.
template <typename T>
__device__ __forceinline__ void quat_to_rotmat(const T (&q)[4],
                                               T (&R)[3][3]) {
  using B = base_t<T>;
  const T w = q[0], x = q[1], y = q[2], z = q[3];
  const T xx = x * x, yy = y * y, zz = z * z;
  const T xy = x * y, xz = x * z, yz = y * z;
  const T wx = w * x, wy = w * y, wz = w * z;
  R[0][0] = B(1) - B(2) * (yy + zz);
  R[0][1] = B(2) * (xy - wz);
  R[0][2] = B(2) * (xz + wy);
  R[1][0] = B(2) * (xy + wz);
  R[1][1] = B(1) - B(2) * (xx + zz);
  R[1][2] = B(2) * (yz - wx);
  R[2][0] = B(2) * (xz - wy);
  R[2][1] = B(2) * (yz + wx);
  R[2][2] = B(1) - B(2) * (xx + yy);
}

// ---------------------------------------------------------------------------
constexpr int kCubeNV = 6;       // velocity dimension
constexpr int kCubeNQ = 7;       // configuration dimension
constexpr int kCubeNX = 13;      // state dimension
constexpr int kCubeK = 4;        // contact points (box witnesses)
constexpr int kCubeP = 15;       // derived scalars
constexpr double kGravity = 9.81;

// Everything soa_loss_parts returns: mass matrix, cone-major contact
// Jacobian [J_n; mu J_t], signed distances, the QP's linear term, and the
// velocity residual.
template <typename T> struct LossParts {
  T M[kCubeNV][kCubeNV];
  T J[3][kCubeNV][kCubeK];
  T phi[kCubeK];
  T qc[3][kCubeK];
  T dv[kCubeNV];
};

// soa_loss_parts for the cube: the multibody terms at the observed next
// state (q, vp), then the ContactNets QP pieces. v is the velocity of the
// current state; p the 15 derived scalars.
template <typename T>
__device__ void cube_loss_parts(const T (&p)[kCubeP], const T (&v)[kCubeNV],
                                const T (&q)[kCubeNQ],
                                const T (&vp)[kCubeNV], base_t<T> dt,
                                LossParts<T>& out) {
  using B = base_t<T>;
  constexpr int NV = kCubeNV, K = kCubeK;

  // Kinematics and its time derivative along qdot (soa_configuration_rate,
  // then the JVP of soa_body_kinematics): R and Rdot of the free body.
  T R[3][3], Rdot[3][3];
  {
    const T qw = q[0], qx = q[1], qy = q[2], qz = q[3];
    const T wx = vp[0], wy = vp[1], wz = vp[2];
    const T qdot[4] = {B(0.5) * (-qx * wx - qy * wy - qz * wz),
                       B(0.5) * (qw * wx + qy * wz - qz * wy),
                       B(0.5) * (qw * wy + qz * wx - qx * wz),
                       B(0.5) * (qw * wz + qx * wy - qy * wx)};
    Dual<T> qd[4], Rd[3][3];
#pragma unroll
    for (int i = 0; i < 4; ++i) qd[i] = Dual<T>(q[i], qdot[i]);
    quat_to_rotmat(qd, Rd);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        R[i][j] = Rd[i][j].v;
        Rdot[i][j] = Rd[i][j].d;
      }
  }
  // Angular and linear Jacobians: Jw = [R | 0], Jv = [0 | I], their rates
  // Jw_dot = [Rdot | 0], Jv_dot = 0.
  T Jw[3][NV], Jw_dot[3][NV], Jv[3][NV];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      Jw[i][j] = j < 3 ? R[i][j] : T(0);
      Jw_dot[i][j] = j < 3 ? Rdot[i][j] : T(0);
      Jv[i][j] = j == 3 + i ? T(1) : T(0);
    }

  // soa_lagrangian_terms: mass matrix M and force F.
  T M[NV][NV], F[NV];
  {
    const T mass = p[0];
    const T c_B[3] = {p[1] / mass, p[2] / mass, p[3] / mass};
    const T I_B[3][3] = {{p[4], p[7], p[8]}, {p[7], p[5], p[9]},
                         {p[8], p[9], p[6]}};
    T c_W[3], c_W_dot[3];
    matvec3(R, c_B, c_W);
    matvec3(Rdot, c_B, c_W_dot);
    T S[3][3], S_dot[3][3];
    skew3(c_W, S);
    skew3(c_W_dot, S_dot);
    // J_cm = Jv - skew(c_W) Jw;
    // J_cm_dot = (Jv_dot - skew(c_W_dot) Jw) - skew(c_W) Jw_dot.
    T J_cm[3][NV], J_cm_dot[3][NV];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const T a = S[i][0] * Jw[0][j] + S[i][1] * Jw[1][j] +
                    S[i][2] * Jw[2][j];
        const T b = S_dot[i][0] * Jw[0][j] + S_dot[i][1] * Jw[1][j] +
                    S_dot[i][2] * Jw[2][j];
        const T c = S[i][0] * Jw_dot[0][j] + S[i][1] * Jw_dot[1][j] +
                    S[i][2] * Jw_dot[2][j];
        J_cm[i][j] = Jv[i][j] - a;
        J_cm_dot[i][j] = (T(0) - b) - c;
      }
    T omega[3], omega_dot_bias[3], a_cm_bias[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      omega[i] = dot_n<T, NV>(Jw[i], vp);
      omega_dot_bias[i] = dot_n<T, NV>(Jw_dot[i], vp);
      a_cm_bias[i] = dot_n<T, NV>(J_cm_dot[i], vp);
    }
    // I_cm_W = (R I_B) R^T.
    T I_W[3][3];
    {
      T RI[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          RI[i][j] = R[i][0] * I_B[0][j] + R[i][1] * I_B[1][j] +
                     R[i][2] * I_B[2][j];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          I_W[i][j] = RI[i][0] * R[j][0] + RI[i][1] * R[j][1] +
                      RI[i][2] * R[j][2];
    }
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        T acc = T(0);
#pragma unroll
        for (int a = 0; a < 3; ++a) acc = acc + mass * J_cm[a][i] * J_cm[a][j];
#pragma unroll
        for (int x = 0; x < 3; ++x)
#pragma unroll
          for (int y = 0; y < 3; ++y)
            acc = acc + Jw[x][i] * I_W[x][y] * Jw[y][j];
        M[i][j] = acc;
      }
    T I_omega[3], torque_bias[3], force_bias[3];
    matvec3(I_W, omega, I_omega);
    matvec3(I_W, omega_dot_bias, torque_bias);
    torque_bias[0] = torque_bias[0] +
                     (omega[1] * I_omega[2] - omega[2] * I_omega[1]);
    torque_bias[1] = torque_bias[1] +
                     (omega[2] * I_omega[0] - omega[0] * I_omega[2]);
    torque_bias[2] = torque_bias[2] +
                     (omega[0] * I_omega[1] - omega[1] * I_omega[0]);
#pragma unroll
    for (int a = 0; a < 3; ++a) force_bias[a] = mass * a_cm_bias[a];
    const T g_W[3] = {T(0), T(0), T(B(-kGravity))};
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      T cor = T(0), grav = T(0);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        cor = cor + Jw[a][i] * torque_bias[a] + J_cm[a][i] * force_bias[a];
        grav = grav + J_cm[a][i] * mass * g_W[a];
      }
      F[i] = T(0) + grav - cor;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = i + 1; j < NV; ++j) M[i][j] = M[j][i];
  }

  // soa_contact_terms: box witnesses against the plane. The plane frame is
  // the world frame and the box frame the body frame, so R_AB = R and the
  // box origin in the plane frame is the body position.
  T J_rel[3][NV][K];
  {
    const T dir[3] = {-R[2][0], -R[2][1], -R[2][2]};
    // The 8 corners, in _UNIT_BOX_VERTICES order, sorted by support value
    // (descending) through soa.sort_with_payload's insertion network,
    // whose tie order picks the witnesses.
    T key[8], pay[3][8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const T vert[3] = {B((n >> 2) & 1 ? 1 : -1) * p[12],
                         B((n >> 1) & 1 ? 1 : -1) * p[13],
                         B(n & 1 ? 1 : -1) * p[14]};
      key[n] = vert[0] * dir[0] + vert[1] * dir[1] + vert[2] * dir[2];
#pragma unroll
      for (int i = 0; i < 3; ++i) pay[i][n] = vert[i];
    }
#pragma unroll
    for (int i = 1; i < 8; ++i)
#pragma unroll
      for (int j = i; j > 0; --j) {
        const bool swap = primal(key[j - 1]) < primal(key[j]);
        const T a = key[j - 1], b = key[j];
        key[j - 1] = swap ? b : a;
        key[j] = swap ? a : b;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const T pa = pay[r][j - 1], pb = pay[r][j];
          pay[r][j - 1] = swap ? pb : pa;
          pay[r][j] = swap ? pa : pb;
        }
      }
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const T w_B[3] = {pay[0][c], pay[1][c], pay[2][c]};
      T off_B[3];  // R w_B: the witness offset in the world frame
      matvec3(R, w_B, off_B);
      const T off_A[3] = {off_B[0] + q[4], off_B[1] + q[5], T(0)};
      out.phi[c] = off_B[2] + q[6];
      // J_rel = (Jv_B - skew(off_B) Jw_B) - (Jv_A - skew(off_A) Jw_A) with
      // the plane's Jacobians zero.
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const T z = T(0);
        const T sB0 = off_B[1] * Jw[2][j] - off_B[2] * Jw[1][j];
        const T sB1 = off_B[2] * Jw[0][j] - off_B[0] * Jw[2][j];
        const T sB2 = off_B[0] * Jw[1][j] - off_B[1] * Jw[0][j];
        const T sA0 = off_A[1] * z - off_A[2] * z;
        const T sA1 = off_A[2] * z - off_A[0] * z;
        const T sA2 = off_A[0] * z - off_A[1] * z;
        J_rel[0][j][c] = (Jv[0][j] - z) - sB0 + sA0;
        J_rel[1][j][c] = (Jv[1][j] - z) - sB1 + sA1;
        J_rel[2][j][c] = (Jv[2][j] - z) - sB2 + sA2;
      }
    }
    const T mu_a = p[10], mu_b = p[11];
    const T mu_pair = (B(2) * mu_a * mu_b) / (mu_a + mu_b);
    // Rows [normal, mu t_x, mu t_y] in the plane's (the world's) axes.
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int c = 0; c < K; ++c) {
        out.J[0][j][c] = J_rel[2][j][c];
        out.J[1][j][c] = mu_pair * J_rel[0][j][c];
        out.J[2][j][c] = mu_pair * J_rel[1][j][c];
      }
  }

  // Contact-free acceleration a_nc = M^-1 F.
  T a_nc[NV];
  {
    Ldlt<T, NV> F_M;
    ldlt<T, NV>(M, F_M);
    ldlt_solve<T, NV>(F_M, F, a_nc);
  }
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < NV; ++j) out.M[i][j] = M[i][j];

  // The QP's linear term q_pred + q_comp + q_diss.
#pragma unroll
  for (int i = 0; i < NV; ++i) out.dv[i] = vp[i] - (v[i] + a_nc[i] * dt);
#pragma unroll
  for (int c = 0; c < K; ++c) {
    T j_dv[3], j_vp[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      T a = T(0), b = T(0);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        a = a + out.J[i][j][c] * out.dv[j];
        b = b + out.J[i][j][c] * vp[j];
      }
      j_dv[i] = a;
      j_vp[i] = b;
    }
    const T s1 = j_vp[1], s2 = j_vp[2];
    const T sliding_sq = s1 * s1 + s2 * s2;
    // Safe norm at exactly resting contacts: value 0, derivative 0.
    const bool at_rest = primal(sliding_sq) < B(1e-24);
    const T speed = sqrt_(at_rest ? T(1) : sliding_sq);
    const T sliding_speed = at_rest ? T(0) : speed;
    out.qc[0][c] = -j_dv[0] + abs_(out.phi[c]) + dt * sliding_speed;
    out.qc[1][c] = -j_dv[1] + dt * s1;
    out.qc[2][c] = -j_dv[2] + dt * s2;
  }
}

// soa_loss_assemble: the loss at a given (detached) impulse,
// 0.5 f'(D + eps I) f + f'q + 0.5 dv'M dv + sum max(-phi, 0)^2, with f'D f
// computed as (J'f)' M^-1 (J'f); 0 for a failed solve.
template <typename T>
__device__ T cube_loss_assemble(const LossParts<T>& lp,
                                const base_t<T> (&f)[3][kCubeK], bool valid,
                                base_t<T> eps) {
  using B = base_t<T>;
  constexpr int NV = kCubeNV, K = kCubeK;
  T jtf[NV], minv_jtf[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    T acc = T(0);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const T term = lp.J[0][j][c] * f[0][c] + lp.J[1][j][c] * f[1][c] +
                     lp.J[2][j][c] * f[2][c];
      acc = c == 0 ? term : acc + term;
    }
    jtf[j] = acc;
  }
  {
    Ldlt<T, NV> F_M;
    ldlt<T, NV>(lp.M, F_M);
    ldlt_solve<T, NV>(F_M, jtf, minv_jtf);
  }
  B f_sq = B(0);
  T f_dot_q = T(0), penetration = T(0);
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const B sq = f[0][c] * f[0][c] + f[1][c] * f[1][c] + f[2][c] * f[2][c];
    const T fq = f[0][c] * lp.qc[0][c] + f[1][c] * lp.qc[1][c] +
                 f[2][c] * lp.qc[2][c];
    const T neg = -lp.phi[c];
    const T pen = primal(neg) < B(0) ? T(0) : neg;  // clamp_min(-phi, 0)
    f_sq = c == 0 ? sq : f_sq + sq;
    f_dot_q = c == 0 ? fq : f_dot_q + fq;
    penetration = c == 0 ? pen * pen : penetration + pen * pen;
  }
  const T quad = dot_n<T, NV>(jtf, minv_jtf) + eps * f_sq;
  T M_dv[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) M_dv[i] = dot_n<T, NV>(lp.M[i], lp.dv);
  const T constant = B(0.5) * dot_n<T, NV>(lp.dv, M_dv) + penetration;
  const T loss = B(0.5) * quad + f_dot_q + constant;
  return valid ? loss : T(0);
}

// ---------------------------------------------------------------------------
// Per-sample bodies of the kernels. Inputs are one column of the
// batch-minor tensors: p the derived scalars, x the current state (only
// its velocity enters), xp the observed next state.

template <typename S>
__device__ __forceinline__ void cube_parts_at(const S (&p)[kCubeP],
                                              const S (&x)[kCubeNX],
                                              const S (&xp)[kCubeNX], S dt,
                                              LossParts<S>& lp) {
  S v[kCubeNV], q[kCubeNQ], vp[kCubeNV];
#pragma unroll
  for (int i = 0; i < kCubeNV; ++i) {
    v[i] = x[kCubeNQ + i];
    vp[i] = xp[kCubeNQ + i];
  }
#pragma unroll
  for (int i = 0; i < kCubeNQ; ++i) q[i] = xp[i];
  cube_loss_parts<S>(p, v, q, vp, dt, lp);
}

template <typename S>
__device__ __forceinline__ void problem_from(const LossParts<S>& lp,
                                             double eps,
                                             Problem<S, kCubeNV, kCubeK>& P) {
#pragma unroll
  for (int i = 0; i < kCubeNV; ++i)
#pragma unroll
    for (int j = 0; j < kCubeNV; ++j) P.M[i][j] = lp.M[i][j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < kCubeNV; ++j)
#pragma unroll
      for (int c = 0; c < kCubeK; ++c) P.J[i][j][c] = lp.J[i][j][c];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < kCubeK; ++c) P.q[i][c] = lp.qc[i][c];
  P.eps = S(eps);
  P.inv_eps = S(1.0 / eps);
  P.half_eps = S(0.5 * eps);
}

// K1's body: terms, the cold hybrid solve, the loss. Writes the impulse;
// returns the loss and sets valid.
template <typename S>
__device__ S cube_loss_cold(const S (&p)[kCubeP], const S (&x)[kCubeNX],
                            const S (&xp)[kCubeNX], S dt, double eps,
                            int ipm_iterations, int newton_iterations,
                            S (&force)[3][kCubeK], bool& valid) {
  LossParts<S> lp;
  cube_parts_at<S>(p, x, xp, dt, lp);
  Problem<S, kCubeNV, kCubeK> P;
  problem_from<S>(lp, eps, P);
  valid = cold_hybrid_solve<S, kCubeNV, kCubeK>(P, ipm_iterations,
                                                newton_iterations, force);
  return cube_loss_assemble<S>(lp, force, valid, S(eps));
}

// K3's body: as K1, with the warm solve from w = M^-1 J^T f_prev at the
// current parameters.
template <typename S>
__device__ S cube_loss_warm(const S (&p)[kCubeP], const S (&x)[kCubeNX],
                            const S (&xp)[kCubeNX],
                            const S (&f_prev)[3][kCubeK], S dt, double eps,
                            int ipm_iterations, int newton_iterations,
                            S (&force)[3][kCubeK], bool& valid) {
  LossParts<S> lp;
  cube_parts_at<S>(p, x, xp, dt, lp);
  Problem<S, kCubeNV, kCubeK> P;
  problem_from<S>(lp, eps, P);
  S w[kCubeNV];
  minv_jt<S, kCubeNV, kCubeK>(P, f_prev, w);
  valid = warm_hybrid_solve<S, kCubeNV, kCubeK>(P, ipm_iterations,
                                                newton_iterations, w, force);
  return cube_loss_assemble<S>(lp, force, valid, S(eps));
}

// K2's body: the gradient of ct * loss at the saved impulse with respect
// to the input seeded by `direction`: 0-14 the derived scalars, 15-20 the
// velocity rows of x, 21-33 the rows of xp. One forward-mode pass of the
// terms and the assembly (no solve: the envelope theorem).
constexpr int kCubeDirections = kCubeP + kCubeNV + kCubeNX;

template <typename S>
__device__ S cube_loss_grad(const S (&p)[kCubeP], const S (&x)[kCubeNX],
                            const S (&xp)[kCubeNX],
                            const S (&force)[3][kCubeK], bool valid, S ct,
                            S dt, S eps, int direction) {
  using D = Dual<S>;
  if (!valid) return S(0);
  D pd[kCubeP], v[kCubeNV], q[kCubeNQ], vp[kCubeNV];
#pragma unroll
  for (int i = 0; i < kCubeP; ++i)
    pd[i] = D(p[i], S(direction == i ? 1 : 0));
#pragma unroll
  for (int i = 0; i < kCubeNV; ++i)
    v[i] = D(x[kCubeNQ + i], S(direction == kCubeP + i ? 1 : 0));
#pragma unroll
  for (int i = 0; i < kCubeNQ; ++i)
    q[i] = D(xp[i], S(direction == kCubeP + kCubeNV + i ? 1 : 0));
#pragma unroll
  for (int i = 0; i < kCubeNV; ++i)
    vp[i] = D(xp[kCubeNQ + i],
              S(direction == kCubeP + kCubeNV + kCubeNQ + i ? 1 : 0));
  LossParts<D> lp;
  cube_loss_parts<D>(pd, v, q, vp, dt, lp);
  const D loss = cube_loss_assemble<D>(lp, force, true, eps);
  return loss.d * ct;
}

}  // namespace
