// Reverse-mode gradient of the cube's ContactNets loss for one sample: the
// body of the backward kernel K2 (contactnets_loss.cu).
//
// The loss at a detached impulse f is
//   L = 0.5 (J'f)' M^-1 (J'f) + 0.5 eps |f|^2 + f'qc + 0.5 dv'M dv
//       + sum_c max(-phi_c, 0)^2
// (cube_loss_assemble), with M, J, phi, qc and dv the terms of
// cube_loss_parts. cube_loss_vjp runs that forward sweep once in plain
// arithmetic, keeping what the adjoint needs (LossParts' R, Rdot, the
// factors of M, a_nc, the sliding rates, the witnesses' corners and the
// Lagrangian terms' intermediates, so that the dynamics are written out
// once, in cube_loss_parts), then
// one adjoint sweep written out by hand in reverse order: the assembly, the
// QP's linear term, dv = vp - (v + M^-1 F dt), the contact Jacobian and
// the witnesses, the Lagrangian terms (M, F), and last the quaternion
// kinematics (R quadratic in q, Rdot bilinear in q and qdot(q, omega)).
// The sweep exploits the cube's structure: Jw = [R | 0], Jv = [0 | I], so a
// column j < 3 of J_cm or of a witness's J_rel is a cross product R e_j x o.
//
// It follows the plain version's (torch autograd's) branch conventions:
// |phi| has derivative sign(phi), 0 at 0; clamp_min(-phi, 0) passes the
// gradient where -phi >= 0; the safe sliding norm has derivative 0 at rest;
// the sort routes the witnesses' cotangents to the corners the forward
// picked; a failed solve (valid false) gives exactly 0, and so do the
// configuration rows of x, which the loss does not read. eps does not enter
// the gradient at a fixed impulse.
#pragma once

#include "cube_terms.cuh"

namespace {

// out += a x b
template <typename S>
__device__ __forceinline__ void add_cross(S a0, S a1, S a2, S b0, S b1, S b2,
                                          S (&out)[3]) {
  out[0] = out[0] + (a1 * b2 - a2 * b1);
  out[1] = out[1] + (a2 * b0 - a0 * b2);
  out[2] = out[2] + (a0 * b1 - a1 * b0);
}

// out += the gradient of sum_ij A_ij R_ij(q) with respect to the wxyz
// quaternion q, for R = quat_to_rotmat(q). Any scalar type: the generic
// adjoint (model_adjoint.cuh) calls it in Dual arithmetic.
template <typename S>
__device__ __forceinline__ void quat_to_rotmat_vjp(const S (&A)[3][3],
                                                   const S (&q)[4],
                                                   S (&out)[4]) {
  const S w = q[0], x = q[1], y = q[2], z = q[3];
  const S two = cst<S>(2.0), four = cst<S>(4.0);
  out[0] = out[0] + two * (-A[0][1] * z + A[0][2] * y + A[1][0] * z -
                           A[1][2] * x - A[2][0] * y + A[2][1] * x);
  out[1] = out[1] + two * (A[0][1] * y + A[0][2] * z + A[1][0] * y -
                           A[1][2] * w + A[2][0] * z + A[2][1] * w) -
           four * x * (A[1][1] + A[2][2]);
  out[2] = out[2] + two * (A[0][1] * x + A[0][2] * w + A[1][0] * x +
                           A[1][2] * z - A[2][0] * w + A[2][1] * z) -
           four * y * (A[0][0] + A[2][2]);
  out[3] = out[3] + two * (-A[0][1] * w + A[0][2] * x + A[1][0] * w +
                           A[1][2] * y + A[2][0] * x + A[2][1] * y) -
           four * z * (A[0][0] + A[1][1]);
}

// The gradient of ct * L for one sample with respect to the 15 derived
// scalars (dp), the velocity rows of x (dv_in) and the 13 rows of x+
// (dxp), at the impulse f.
template <typename S>
__device__ void cube_loss_vjp(const S (&p)[kCubeP], const S (&x)[kCubeNX],
                              const S (&xp)[kCubeNX],
                              const S (&f)[3][kCubeK], bool valid, S ct,
                              S dt, S (&dp)[kCubeP], S (&dv_in)[kCubeNV],
                              S (&dxp)[kCubeNX]) {
  constexpr int NV = kCubeNV, K = kCubeK;
#pragma unroll
  for (int i = 0; i < kCubeP; ++i) dp[i] = S(0);
#pragma unroll
  for (int i = 0; i < NV; ++i) dv_in[i] = S(0);
#pragma unroll
  for (int i = 0; i < kCubeNX; ++i) dxp[i] = S(0);
  if (!valid) return;

  // (a) The forward sweep, and w = M^-1 J'f.
  LossParts<S> lp;
  cube_parts_at<S>(p, x, xp, dt, lp);
  const S* q = xp;
  const S* vp = xp + kCubeNQ;
  S jtf[NV], w[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    S acc = S(0);
#pragma unroll
    for (int c = 0; c < K; ++c)
      acc = acc + (lp.J[0][j][c] * f[0][c] + lp.J[1][j][c] * f[1][c] +
                   lp.J[2][j][c] * f[2][c]);
    jtf[j] = acc;
  }
  ldlt_solve<S, NV>(lp.F_M, jtf, w);

  // (b) The adjoint, for a unit cotangent of L; ct scales the outputs.
  //
  // Assembly and linear term. qc's cotangent is f, so J's cotangent is
  // Jbar[i][j][c] = f[i][c] u[j] + (sliding rows) sb[i-1][c] vp[j] with
  // u = M^-1 J'f - dv, and dv's is M dv - J'f.
  S u[NV], dv_bar[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    S m_dv = S(0);
#pragma unroll
    for (int j = 0; j < NV; ++j) m_dv = m_dv + lp.M[i][j] * lp.dv[j];
    dv_bar[i] = m_dv - jtf[i];
    u[i] = w[i] - lp.dv[i];
  }
  S phi_bar[K], sb[2][K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const S phi = lp.phi[c];
    const S sign = phi > S(0) ? S(1) : (phi < S(0) ? S(-1) : S(0));
    const S pen = -phi < S(0) ? S(0) : -phi;
    phi_bar[c] = f[0][c] * sign - S(2) * pen;
    sb[0][c] = f[1][c] * dt;
    sb[1][c] = f[2][c] * dt;
    const S speed = lp.slide[2][c];
    if (speed != S(0)) {  // not at rest
      const S g = f[0][c] * dt / speed;
      sb[0][c] = sb[0][c] + g * lp.slide[0][c];
      sb[1][c] = sb[1][c] + g * lp.slide[1][c];
    }
  }
  S vp_bar[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    S acc = dv_bar[j];
#pragma unroll
    for (int c = 0; c < K; ++c)
      acc = acc + (sb[0][c] * lp.J[1][j][c] + sb[1][c] * lp.J[2][j][c]);
    vp_bar[j] = acc;
  }

  // dv = vp - (v + a_nc dt), a_nc = M^-1 F: F's cotangent Fb = -dt M^-1
  // dv_bar; M's cotangent, symmetrised (M is symmetric by construction),
  // Mb = -0.5 w w' + 0.5 dv dv' - sym(Fb a_nc'), lower triangle.
  S Fb[NV];
  {
    S a_bar[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) a_bar[i] = -dt * dv_bar[i];
    ldlt_solve<S, NV>(lp.F_M, a_bar, Fb);
  }
  S Mb[NV][NV];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      Mb[i][j] = S(0.5) * (lp.dv[i] * lp.dv[j] - w[i] * w[j] -
                           Fb[i] * lp.a_nc[j] - lp.a_nc[i] * Fb[j]);
      Mb[j][i] = Mb[i][j];
    }

  const S (&R)[3][3] = lp.R;
  const S (&Rdot)[3][3] = lp.Rdot;
  S Rb[3][3], Rdotb[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Rb[i][j] = Rdotb[i][j] = S(0);

  // Contact Jacobian: J = [J_rel[2]; mu J_rel[0]; mu J_rel[1]], column
  // j < 3 of J_rel is R e_j x o_c (o_c = R w_c, the witness offset), the
  // columns 3 and 4 of J_rel[0] and J_rel[1] are 1; phi_c = o_c[2] + q[6].
  const S mu_a = p[10], mu_b = p[11];
  const S mu_pair = (S(2) * mu_a * mu_b) / (mu_a + mu_b);
  S mu_bar = S(0), half_bar[3] = {S(0), S(0), S(0)}, q6_bar = S(0);
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const int n = lp.corner[c];
    const S sgn[3] = {(n >> 2) & 1 ? S(1) : S(-1), (n >> 1) & 1 ? S(1) : S(-1),
                      n & 1 ? S(1) : S(-1)};
    const S wc[3] = {sgn[0] * p[12], sgn[1] * p[13], sgn[2] * p[14]};
    S o[3];
    matvec3(R, wc, o);
    S ob[3] = {S(0), S(0), phi_bar[c]};
    q6_bar = q6_bar + phi_bar[c];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const S jb0 = f[0][c] * u[j];
      const S jb1 = f[1][c] * u[j] + sb[0][c] * vp[j];
      const S jb2 = f[2][c] * u[j] + sb[1][c] * vp[j];
      const S ub[3] = {mu_pair * jb1, mu_pair * jb2, jb0};  // J_rel's
      const S r0 = R[0][j], r1 = R[1][j], r2 = R[2][j];
      mu_bar = mu_bar + jb1 * (r1 * o[2] - r2 * o[1]) +
               jb2 * (r2 * o[0] - r0 * o[2]);
      S rb[3] = {S(0), S(0), S(0)};
      add_cross(o[0], o[1], o[2], ub[0], ub[1], ub[2], rb);
      add_cross(ub[0], ub[1], ub[2], r0, r1, r2, ob);
#pragma unroll
      for (int i = 0; i < 3; ++i) Rb[i][j] = Rb[i][j] + rb[i];
    }
    mu_bar = mu_bar + (f[1][c] * u[3] + sb[0][c] * vp[3]) +
             (f[2][c] * u[4] + sb[1][c] * vp[4]);
    // o = R wc
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) Rb[i][j] = Rb[i][j] + ob[i] * wc[j];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      half_bar[k] = half_bar[k] +
                    sgn[k] * (R[0][k] * ob[0] + R[1][k] * ob[1] +
                              R[2][k] * ob[2]);
  }

  // Lagrangian terms: M = mass J_cm'J_cm + Jw' I_W Jw and
  // F = J_cm'(mass g - f_b) - Jw' tau, J_cm = [X | I] with X e_j =
  // R e_j x c_W, tau = I_W Omd + Om x I_W Om, f_b = mass a_cm, a_cm =
  // -c_dot x Om - c_W x Omd, where Om = R omega, Omd = Rdot omega,
  // c_W = R c_B, c_dot = Rdot c_B, I_W = R I_B R'.
  // The forward sweep kept the intermediates (LossParts).
  const S mass = p[0];
  const S c_B[3] = {p[1] / mass, p[2] / mass, p[3] / mass};
  const S I_B[3][3] = {{p[4], p[7], p[8]}, {p[7], p[5], p[9]},
                       {p[8], p[9], p[6]}};
  const S omega[3] = {vp[0], vp[1], vp[2]};
  const S (&c_W)[3] = lp.c_W;
  const S (&c_dot)[3] = lp.c_dot;
  const S (&Om)[3] = lp.Om;
  const S (&Omd)[3] = lp.Omd;
  const S (&I_W)[3][3] = lp.I_W;
  const S (&h)[3] = lp.h;
  const S (&tau)[3] = lp.tau;
  const S (&a_cm)[3] = lp.a_cm;
  const S (&X)[3][3] = lp.X;  // X[:, j] = R[:, j] x c_W
  const S g_z = S(-kGravity);
  // J_cm Fb, and the cotangents of f_b and tau.
  S jf[3], fb_bar[3], tau_bar[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    jf[a] = X[a][0] * Fb[0] + X[a][1] * Fb[1] + X[a][2] * Fb[2] + Fb[3 + a];
    fb_bar[a] = -jf[a];
    tau_bar[a] = -(R[a][0] * Fb[0] + R[a][1] * Fb[1] + R[a][2] * Fb[2]);
  }
  S mass_bar = jf[2] * g_z;
  // M's cotangent: mass, X, Jw (R) and I_W.
  S Xb[3][3], IWb[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) mass_bar = mass_bar + Mb[3 + a][3 + a];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      S xm = Mb[3 + a][j];  // (X Mb_aa + Mb_la)[a][j]
#pragma unroll
      for (int k = 0; k < 3; ++k) xm = xm + X[a][k] * Mb[k][j];
      mass_bar = mass_bar + X[a][j] * (xm + Mb[3 + a][j]);
      const S f_b = mass * a_cm[a];
      const S g_a = a == 2 ? mass * g_z : S(0);
      Xb[a][j] = S(2) * mass * xm + (g_a - f_b) * Fb[j];
    }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      // Rb += 2 I_W R Mb_aa - tau Fb_ang'
      S rm = S(0), r_mb_rt = S(0);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        S rmk = S(0);  // (R Mb_aa)[i][k]
#pragma unroll
        for (int l = 0; l < 3; ++l) rmk = rmk + R[i][l] * Mb[l][k];
        r_mb_rt = r_mb_rt + rmk * R[j][k];
        S irk = S(0);  // (I_W R)[i][k]
#pragma unroll
        for (int l = 0; l < 3; ++l) irk = irk + I_W[i][l] * R[l][k];
        rm = rm + irk * Mb[k][j];
      }
      Rb[i][j] = Rb[i][j] + S(2) * rm - tau[i] * Fb[j];
      IWb[i][j] = r_mb_rt + tau_bar[i] * Omd[j];
    }
  // a_cm = -(c_dot x Om) - c_W x Omd; its cotangent ab = mass fb_bar.
  S ab[3], cdot_bar[3] = {S(0), S(0), S(0)}, cW_bar[3] = {S(0), S(0), S(0)};
  S Om_bar[3] = {S(0), S(0), S(0)}, Omd_bar[3], h_bar[3] = {S(0), S(0), S(0)};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    mass_bar = mass_bar + fb_bar[a] * a_cm[a];
    ab[a] = mass * fb_bar[a];
  }
  add_cross(ab[0], ab[1], ab[2], Om[0], Om[1], Om[2], cdot_bar);
  add_cross(c_dot[0], c_dot[1], c_dot[2], ab[0], ab[1], ab[2], Om_bar);
  add_cross(ab[0], ab[1], ab[2], Omd[0], Omd[1], Omd[2], cW_bar);
  matvec3(I_W, tau_bar, Omd_bar);
  add_cross(c_W[0], c_W[1], c_W[2], ab[0], ab[1], ab[2], Omd_bar);
  // tau = I_W Omd + Om x h, h = I_W Om.
  add_cross(h[0], h[1], h[2], tau_bar[0], tau_bar[1], tau_bar[2], Om_bar);
  add_cross(tau_bar[0], tau_bar[1], tau_bar[2], Om[0], Om[1], Om[2], h_bar);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    Om_bar[i] = Om_bar[i] + (I_W[0][i] * h_bar[0] + I_W[1][i] * h_bar[1] +
                             I_W[2][i] * h_bar[2]);
#pragma unroll
    for (int j = 0; j < 3; ++j) IWb[i][j] = IWb[i][j] + h_bar[i] * Om[j];
  }
  // X[:, j] = R[:, j] x c_W.
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    S rb[3] = {S(0), S(0), S(0)};
    add_cross(c_W[0], c_W[1], c_W[2], Xb[0][j], Xb[1][j], Xb[2][j], rb);
    add_cross(Xb[0][j], Xb[1][j], Xb[2][j], R[0][j], R[1][j], R[2][j],
              cW_bar);
#pragma unroll
    for (int i = 0; i < 3; ++i) Rb[i][j] = Rb[i][j] + rb[i];
  }
  // Om = R omega, Omd = Rdot omega, c_W = R c_B, c_dot = Rdot c_B.
  S omega_bar[3], cB_bar[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    omega_bar[k] = R[0][k] * Om_bar[0] + R[1][k] * Om_bar[1] +
                   R[2][k] * Om_bar[2] + (Rdot[0][k] * Omd_bar[0] +
                   Rdot[1][k] * Omd_bar[1] + Rdot[2][k] * Omd_bar[2]);
    cB_bar[k] = R[0][k] * cW_bar[0] + R[1][k] * cW_bar[1] +
                R[2][k] * cW_bar[2] + (Rdot[0][k] * cdot_bar[0] +
                Rdot[1][k] * cdot_bar[1] + Rdot[2][k] * cdot_bar[2]);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      Rb[i][j] = Rb[i][j] + Om_bar[i] * omega[j] + cW_bar[i] * c_B[j];
      Rdotb[i][j] = Omd_bar[i] * omega[j] + cdot_bar[i] * c_B[j];
    }
  // I_W = R I_B R': Rb += (IWb + IWb') R I_B, I_B's cotangent R' IWb R.
  S IBb[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      S acc = S(0), ib = S(0);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        S ri = S(0);  // (R I_B)[k][j]
#pragma unroll
        for (int l = 0; l < 3; ++l) ri = ri + R[k][l] * I_B[l][j];
        acc = acc + (IWb[i][k] + IWb[k][i]) * ri;
        S rw = S(0);  // (R' IWb)[i][k]
#pragma unroll
        for (int l = 0; l < 3; ++l) rw = rw + R[l][i] * IWb[l][k];
        ib = ib + rw * R[k][j];
      }
      Rb[i][j] = Rb[i][j] + acc;
      IBb[i][j] = ib;
    }

  // The derived scalars: mass, first moments (c_B = p[1:4] / mass),
  // inertia, friction (mu_pair = 2 mu_a mu_b / (mu_a + mu_b)), halves.
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dp[1 + k] = cB_bar[k] / mass;
    mass_bar = mass_bar - cB_bar[k] * c_B[k] / mass;
  }
  dp[0] = mass_bar;
  dp[4] = IBb[0][0];
  dp[5] = IBb[1][1];
  dp[6] = IBb[2][2];
  dp[7] = IBb[0][1] + IBb[1][0];
  dp[8] = IBb[0][2] + IBb[2][0];
  dp[9] = IBb[1][2] + IBb[2][1];
  {
    const S sum = mu_a + mu_b;
    const S scale = S(2) * mu_bar / (sum * sum);
    dp[10] = scale * mu_b * mu_b;
    dp[11] = scale * mu_a * mu_a;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) dp[12 + k] = half_bar[k];

  // Quaternion kinematics: R(q), Rdot = dR(q)[qdot], qdot = 0.5 Q(omega) q.
  const S qv[4] = {q[0], q[1], q[2], q[3]};
  const S qdot[4] = {
      S(0.5) * (-q[1] * omega[0] - q[2] * omega[1] - q[3] * omega[2]),
      S(0.5) * (q[0] * omega[0] + q[2] * omega[2] - q[3] * omega[1]),
      S(0.5) * (q[0] * omega[1] + q[3] * omega[0] - q[1] * omega[2]),
      S(0.5) * (q[0] * omega[2] + q[1] * omega[1] - q[2] * omega[0])};
  S q_bar[4] = {S(0), S(0), S(0), S(0)};
  S qdot_bar[4] = {S(0), S(0), S(0), S(0)};
  quat_to_rotmat_vjp(Rb, qv, q_bar);
  quat_to_rotmat_vjp(Rdotb, qdot, q_bar);
  quat_to_rotmat_vjp(Rdotb, qv, qdot_bar);
  {
    const S a0 = S(0.5) * qdot_bar[0], a1 = S(0.5) * qdot_bar[1],
            a2 = S(0.5) * qdot_bar[2], a3 = S(0.5) * qdot_bar[3];
    q_bar[0] = q_bar[0] + (a1 * omega[0] + a2 * omega[1] + a3 * omega[2]);
    q_bar[1] = q_bar[1] + (-a0 * omega[0] - a2 * omega[2] + a3 * omega[1]);
    q_bar[2] = q_bar[2] + (-a0 * omega[1] + a1 * omega[2] - a3 * omega[0]);
    q_bar[3] = q_bar[3] + (-a0 * omega[2] - a1 * omega[1] + a2 * omega[0]);
    omega_bar[0] = omega_bar[0] + (-a0 * q[1] + a1 * q[0] + a2 * q[3] -
                                   a3 * q[2]);
    omega_bar[1] = omega_bar[1] + (-a0 * q[2] - a1 * q[3] + a2 * q[0] +
                                   a3 * q[1]);
    omega_bar[2] = omega_bar[2] + (-a0 * q[3] + a1 * q[2] - a2 * q[1] +
                                   a3 * q[0]);
  }

  // Outputs, scaled by ct. q[4], q[5] enter no term; omega = vp[0:3].
#pragma unroll
  for (int i = 0; i < kCubeP; ++i) dp[i] = ct * dp[i];
#pragma unroll
  for (int i = 0; i < NV; ++i) dv_in[i] = -ct * dv_bar[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) dxp[i] = ct * q_bar[i];
  dxp[6] = ct * q6_bar;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    dxp[kCubeNQ + i] = ct * (vp_bar[i] + omega_bar[i]);
    dxp[kCubeNQ + 3 + i] = ct * vp_bar[3 + i];
  }
}

}  // namespace
