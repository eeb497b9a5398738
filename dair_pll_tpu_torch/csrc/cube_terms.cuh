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
// The scalar type T is float or double. The Coriolis terms take the time
// derivative of the rotation along qdot as a forward-mode JVP in
// Dual<T>, as the plain version does with torch.func.jvp.
//
// The per-sample loss functions at the end (cube_loss_cold, cube_loss_warm)
// are what the forward kernels of contactnets_loss.cu run; the backward
// kernel's adjoint of the same terms is in cube_adjoint.cuh.
#pragma once

#include "hybrid_solve.cuh"

namespace {

// ---------------------------------------------------------------------------
// Forward-mode dual numbers, with the operations quat_to_rotmat needs.
template <typename S> struct Dual {
  S v;  // value
  S d;  // derivative along the seeded direction
  Dual() = default;
  __device__ __forceinline__ Dual(S value, S deriv) : v(value), d(deriv) {}
};

template <typename T> struct BaseOf { using type = T; };
template <typename S> struct BaseOf<Dual<S>> { using type = S; };
// The float or double under a dual type.
template <typename T> using base_t = typename BaseOf<T>::type;

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
// Mixed with a constant.
template <typename S>
__device__ __forceinline__ Dual<S> operator-(S c, const Dual<S>& a) {
  return Dual<S>(c - a.v, -a.d);
}
template <typename S>
__device__ __forceinline__ Dual<S> operator*(S c, const Dual<S>& a) {
  return Dual<S>(c * a.v, c * a.d);
}

// A constant of the code in any scalar type (zero tangents).
template <typename X> struct Const {
  __device__ __forceinline__ static X make(double c) {
    return X(base_t<X>(c));
  }
};
template <typename T> struct Const<Dual<T>> {
  __device__ __forceinline__ static Dual<T> make(double c) {
    return Dual<T>(Const<T>::make(c), Const<T>::make(0.0));
  }
};
template <typename X> __device__ __forceinline__ X cst(double c) {
  return Const<X>::make(c);
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
// velocity residual. Then what the adjoint (cube_adjoint.cuh) keeps from
// the forward sweep; the forward kernels leave it unread.
template <typename T> struct LossParts {
  T M[kCubeNV][kCubeNV];
  T J[3][kCubeNV][kCubeK];
  T phi[kCubeK];
  T qc[3][kCubeK];
  T dv[kCubeNV];
  T R[3][3], Rdot[3][3];   // rotation and its rate along qdot
  Ldlt<T, kCubeNV> F_M;    // M = L D L'
  T a_nc[kCubeNV];         // contact-free acceleration M^-1 F
  T slide[3][kCubeK];      // j_vp[1], j_vp[2], sliding speed (0 at rest)
  int corner[kCubeK];      // each witness's box corner (vertex index)
  // The Lagrangian terms' intermediates, in the world frame: the centre of
  // mass offset c_W = R c_B and its rate, the angular velocity Om and the
  // bias Omd = Rdot omega, the inertia I_W, the momentum h = I_W Om, the
  // torque and acceleration biases, and J_cm's angular block X.
  T c_W[3], c_dot[3], Om[3], Omd[3], I_W[3][3], h[3], tau[3], a_cm[3];
  T X[3][3];
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
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      out.c_W[i] = c_W[i];
      out.c_dot[i] = c_W_dot[i];
      out.Om[i] = omega[i];
      out.Omd[i] = omega_dot_bias[i];
      out.h[i] = I_omega[i];
      out.tau[i] = torque_bias[i];
      out.a_cm[i] = a_cm_bias[i];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        out.I_W[i][j] = I_W[i][j];
        out.X[i][j] = J_cm[i][j];
      }
    }
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
    int index[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      index[n] = n;
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
        const bool swap = key[j - 1] < key[j];
        const T a = key[j - 1], b = key[j];
        key[j - 1] = swap ? b : a;
        key[j] = swap ? a : b;
        const int ia = index[j - 1], ib = index[j];
        index[j - 1] = swap ? ib : ia;
        index[j] = swap ? ia : ib;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const T pa = pay[r][j - 1], pb = pay[r][j];
          pay[r][j - 1] = swap ? pb : pa;
          pay[r][j] = swap ? pa : pb;
        }
      }
#pragma unroll
    for (int c = 0; c < K; ++c) {
      out.corner[c] = index[c];
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
  ldlt<T, NV>(M, out.F_M);
  ldlt_solve<T, NV>(out.F_M, F, out.a_nc);
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < NV; ++j) out.M[i][j] = M[i][j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      out.R[i][j] = R[i][j];
      out.Rdot[i][j] = Rdot[i][j];
    }

  // The QP's linear term q_pred + q_comp + q_diss.
#pragma unroll
  for (int i = 0; i < NV; ++i) out.dv[i] = vp[i] - (v[i] + out.a_nc[i] * dt);
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
    const bool at_rest = sliding_sq < B(1e-24);
    const T speed = sqrt(at_rest ? T(1) : sliding_sq);
    const T sliding_speed = at_rest ? T(0) : speed;
    out.slide[0][c] = s1;
    out.slide[1][c] = s2;
    out.slide[2][c] = sliding_speed;
    out.qc[0][c] = -j_dv[0] + fabs(out.phi[c]) + dt * sliding_speed;
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
    const T pen = neg < B(0) ? T(0) : neg;  // clamp_min(-phi, 0)
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
// returns the loss and sets valid. kExits: the solve leaves its loops at
// their exact fixed points (hybrid_solve.cuh), as K1 runs it, its samples
// voting by the group type G (WarpSolo on the card).
template <typename S, bool kExits = true, typename G = Solo>
__device__ S cube_loss_cold(const S (&p)[kCubeP], const S (&x)[kCubeNX],
                            const S (&xp)[kCubeNX], S dt, double eps,
                            int ipm_iterations, int newton_iterations,
                            S (&force)[3][kCubeK], bool& valid,
                            const G& g = G()) {
  LossParts<S> lp;
  cube_parts_at<S>(p, x, xp, dt, lp);
  Problem<S, kCubeNV, kCubeK> P;
  problem_from<S>(lp, eps, P);
  valid = cold_hybrid_solve<S, kCubeNV, kCubeK, G, kExits, kExits>(
      P, ipm_iterations, newton_iterations, force, g);
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

}  // namespace
