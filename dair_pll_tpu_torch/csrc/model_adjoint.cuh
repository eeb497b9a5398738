// Reverse-mode gradient of the ContactNets loss of any model of the generic
// loss kernels' class for one sample: the body of the backward kernel K2
// (model_loss.cuh). The model-generic counterpart of cube_adjoint.cuh.
//
// The loss at a detached impulse f is
//   L = 0.5 (J'f)' M^-1 (J'f) + 0.5 eps |f|^2 + f'qc + 0.5 dv'M dv
//       + sum_c max(-phi_c, 0)^2
// (model_loss_assemble), with M, J, phi, qc and dv the terms of
// model_loss_parts. model_loss_vjp runs that forward sweep once in plain
// arithmetic (model_frames, model_loss_parts: the body frames with their
// rates, the factor of M, a_nc, the sliding rates), then one adjoint sweep
// written out by hand in reverse order: the assembly, the QP's linear term,
// dv = vp - (v + M^-1 F dt), the contact Jacobian pair by pair (each pair's
// frames and witnesses recomputed, pair_terms), the Lagrangian terms body
// by body (recomputed, body_terms), and last the kinematic tree in reverse
// body order, each body adding into its parent's frame cotangent, then
// configuration_rate.
//
// Two structures keep the sweep short. J's cotangent is f u' + (sliding
// rows) sb vp' with u = M^-1 J'f - dv, rank two in (u, vp) for each
// contact, so a contact's Jacobian rows take their cotangent through the
// geometries' Jw u, Jw vp, Jv u and Jv vp (3-vectors), not column by
// column. And the kinematics runs in Dual (value, rate along qdot): the
// cotangent of a Dual is held as a Dual with the roles swapped (its value
// the rate's cotangent, its derivative the value's), so that the adjoint of
// y = g(a) is a^ += y^ g'(a) computed in Dual arithmetic, and the tree's
// reverse sweep, rates included, reads as its forward.
//
// It follows the plain version's (torch autograd's) branch conventions:
// |phi| has derivative sign(phi), 0 at 0; clamp_min(-phi, 0) passes the
// gradient where -phi >= 0; the safe sliding norm has derivative 0 at rest;
// the sort's keys take no cotangent, and each witness's goes to the vertex
// the forward picked; a failed solve (valid false) gives exactly 0, and so
// do the configuration rows of xin, which the loss does not read. eps does
// not enter the gradient at a fixed impulse. A box's or a polygon's
// witness is a vertex, whose cotangent goes to its shape scalars alone; a
// sphere's is its radius along the support direction, so its cotangent
// goes to the radius and, through the direction, to the frames
// (contact_terms_vjp).
#pragma once

#include "cube_adjoint.cuh"
#include "model_terms.cuh"

namespace {

// The derived-scalar gradient of one sample as a column of a block's
// shared array, entry i at base[i * stride]: runtime indices (a geometry's
// friction and shape) reach shared memory, not a thread's local stack.
template <typename S> struct GradColumn {
  S* base;
  int stride;
  __device__ __forceinline__ S& operator[](int i) const {
    return base[i * stride];
  }
};

// Forward terms the sweep recomputes from the frames instead of keeping
// them from the forward sweep (pair_terms, witness_offsets, body_terms,
// configuration_rate): registers are dearer than arithmetic here. The
// host's counting build (ops/host_adjoint.py) specialises Recompute for
// its scalar to leave this work out of the operations the gradient needs.
template <typename S> struct Recompute {
  template <typename F>
  __device__ __forceinline__ static void run(const F& f) {
    f();
  }
};

// out += a x b (cube_adjoint.cuh's, on arrays).
template <typename X>
__device__ __forceinline__ void add_cross(const X (&a)[3], const X (&b)[3],
                                          X (&out)[3]) {
  add_cross(a[0], a[1], a[2], b[0], b[1], b[2], out);
}
template <typename X>
__device__ __forceinline__ void cross3(const X (&a)[3], const X (&b)[3],
                                       X (&out)[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}
// a[i] += x for a runtime index i.
template <int N, typename X>
__device__ __forceinline__ void add_at(X (&a)[N], int i, const X& x) {
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (n == i) a[n] = a[n] + x;
}
// A (3 x NV) times x (NV).
template <typename S, int NV>
__device__ __forceinline__ void mv3n(const S (&A)[3][NV], const S (&x)[NV],
                                     S (&out)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = dotn<S, NV>(A[i], x);
}

template <typename S, int NV>
__device__ __forceinline__ void zero_frame(Frame<S, NV>& f) {
  const Dual<S> zero(S(0), S(0));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    f.p[i] = zero;
#pragma unroll
    for (int j = 0; j < 3; ++j) f.R[i][j] = zero;
#pragma unroll
    for (int v = 0; v < NV; ++v) f.Jw[i][v] = f.Jv[i][v] = zero;
  }
}

// The cotangent of a geometry's world frame (geometry_frame) -> its body's
// frame cotangent Fh (values only): R_bar and p_bar of the geometry's pose,
// its Jacobians' cotangents Jv_bar = alpha u' + beta vp' and Jw_bar =
// gamma u' + delta vp', and Wu = Jw u, Wp = Jw vp of its body.
template <typename S, typename Z>
__device__ void geometry_frame_vjp(
    const GeomDesc& g, const Frame<S, Z::NV> (&F)[Z::NB],
    const S (&R_bar)[3][3], const S (&p_bar)[3], const S (&alpha)[3],
    const S (&beta)[3], const S (&gamma)[3], const S (&delta)[3],
    const S (&u)[Z::NV], const S (&vp)[Z::NV], const S (&Wu)[3],
    const S (&Wp)[3], Frame<S, Z::NV> (&Fh)[Z::NB]) {
  constexpr int NV = Z::NV;
#pragma unroll
  for (int b = 0; b < Z::NB; ++b) {
    if (g.body != b) continue;
    S R_WB[3][3], R_BG[3][3], p_BG[3], offset[3], offset_bar[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) R_WB[i][j] = F[b].R[i][j].v;
    const_mat(g.R_BG, R_BG);
    const_vec(g.p_BG, p_BG);
    mv3(R_WB, p_BG, offset);
    // Jv_G = Jv - offset x Jw, columnwise; p_G = p + offset.
#pragma unroll
    for (int i = 0; i < 3; ++i) offset_bar[i] = p_bar[i];
    add_cross(alpha, Wu, offset_bar);
    add_cross(beta, Wp, offset_bar);
    S gu[3], gp[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      gu[i] = gamma[i];
      gp[i] = delta[i];
    }
    add_cross(offset, alpha, gu);
    add_cross(offset, beta, gp);
    Frame<S, NV>& fh = Fh[b];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      fh.p[i].d = fh.p[i].d + p_bar[i];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        fh.Jv[i][v].d = fh.Jv[i][v].d + (alpha[i] * u[v] + beta[i] * vp[v]);
        fh.Jw[i][v].d = fh.Jw[i][v].d + (gu[i] * u[v] + gp[i] * vp[v]);
      }
      // R_G = R R_BG, offset = R p_BG.
#pragma unroll
      for (int j = 0; j < 3; ++j)
        fh.R[i][j].d = fh.R[i][j].d +
                       (R_bar[i][0] * R_BG[j][0] + R_bar[i][1] * R_BG[j][1] +
                        R_bar[i][2] * R_BG[j][2] + offset_bar[i] * p_BG[j]);
    }
  }
}

// The geometry's Jw u, Jw vp, Jv u and Jv vp (geometry_frame's Jacobians
// along the two directions of J's cotangent); zero for the world.
template <typename S, typename Z>
__device__ __forceinline__ void geometry_rates(const GeomDesc& g,
                                               const S (&Jw)[3][Z::NV],
                                               const S (&Jv)[3][Z::NV],
                                               const S (&u)[Z::NV],
                                               const S (&vp)[Z::NV],
                                               S (&Wu)[3], S (&Wp)[3],
                                               S (&Vu)[3], S (&Vp)[3]) {
  if (g.body < 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) Wu[i] = Wp[i] = Vu[i] = Vp[i] = S(0);
    return;
  }
  mv3n<S, Z::NV>(Jw, u, Wu);
  mv3n<S, Z::NV>(Jw, vp, Wp);
  mv3n<S, Z::NV>(Jv, u, Vu);
  mv3n<S, Z::NV>(Jv, vp, Vp);
}

// The contact terms' adjoint for pair pp: J's cotangent f u' + [0; sb] vp'
// and phi's phi_bar -> the frame cotangents Fh and the derived scalars'
// g_p (friction, shape; GP a pointer or GradColumn).
template <typename S, typename Z, typename GP>
__device__ void contact_terms_vjp(const ModelDesc<Z>& desc, const S* p,
                                  const Frame<S, Z::NV> (&F)[Z::NB], int pp,
                                  const S (&f)[3][Z::K], const S (&sb)[2][Z::K],
                                  const S (&phi_bar)[Z::K],
                                  const S (&u)[Z::NV], const S (&vp)[Z::NV],
                                  GP g_p, Frame<S, Z::NV> (&Fh)[Z::NB]) {
  const GeomDesc& ga = desc.plane[pp];
  const GeomDesc& gb = desc.convex[pp];
  const bool a_moves = ga.body >= 0, b_moves = gb.body >= 0;
  PairTerms<S, Z> t;
  Recompute<S>::run([&] { pair_terms<S, Z>(desc, p, F, pp, t); });
  S Wu_A[3], Wp_A[3], Vu_A[3], Vp_A[3], Wu_B[3], Wp_B[3], Vu_B[3], Vp_B[3];
  geometry_rates<S, Z>(ga, t.Jw_A, t.Jv_A, u, vp, Wu_A, Wp_A, Vu_A, Vp_A);
  geometry_rates<S, Z>(gb, t.Jw_B, t.Jv_B, u, vp, Wu_B, Wp_B, Vu_B, Vp_B);
  S R_WA_bar[3][3], R_WB_bar[3][3], R_AB_bar[3][3], pab_bar[3];
  S al_A[3], be_A[3], ga_A[3], de_A[3], al_B[3], be_B[3], ga_B[3], de_B[3];
  S mu_bar = S(0);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pab_bar[i] = S(0);
    al_A[i] = be_A[i] = ga_A[i] = de_A[i] = S(0);
    al_B[i] = be_B[i] = ga_B[i] = de_B[i] = S(0);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      R_WA_bar[i][j] = R_WB_bar[i][j] = R_AB_bar[i][j] = S(0);
  }
#pragma unroll
  for (int c = 0; c < Z::KQ; ++c) {
    if (c >= Z::kq(pp)) continue;
    const int k = Z::first(pp) + c;
    S w_A[3], off_A[3], off_B[3];
    Recompute<S>::run([&] { witness_offsets<S, Z>(t, c, w_A, off_A, off_B); });
    // J_rel along u and vp: (Jv_B - Jv_A) x - off_B x Jw_B x + off_A x
    // Jw_A x for x = u, vp.
    S ru[3], rp[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ru[i] = Vu_B[i] - Vu_A[i];
      rp[i] = Vp_B[i] - Vp_A[i];
    }
    add_cross(Wu_B, off_B, ru);
    add_cross(Wp_B, off_B, rp);
    if (a_moves) {
      add_cross(off_A, Wu_A, ru);
      add_cross(off_A, Wp_A, rp);
    }
    // Rows [n, mu t_x, mu t_y], t = R_WA' J_rel: the contact frame's
    // cotangents ft (along u) and st (along vp), in A's axes (x, y, z).
    const S ft[3] = {t.mu_pair * f[1][k], t.mu_pair * f[2][k], f[0][k]};
    const S st[2] = {t.mu_pair * sb[0][k], t.mu_pair * sb[1][k]};
    S tu[3], tp[2];
    mtv3(t.R_WA, ru, tu);
    tp[0] = t.R_WA[0][0] * rp[0] + t.R_WA[1][0] * rp[1] + t.R_WA[2][0] * rp[2];
    tp[1] = t.R_WA[0][1] * rp[0] + t.R_WA[1][1] * rp[1] + t.R_WA[2][1] * rp[2];
    mu_bar = mu_bar + (f[1][k] * tu[0] + f[2][k] * tu[1] + sb[0][k] * tp[0] +
                       sb[1][k] * tp[1]);
    S a[3], b[3];  // J_rel's cotangent a u' + b vp', world frame
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      a[i] = t.R_WA[i][0] * ft[0] + t.R_WA[i][1] * ft[1] +
             t.R_WA[i][2] * ft[2];
      b[i] = t.R_WA[i][0] * st[0] + t.R_WA[i][1] * st[1];
    }
    S off_B_bar[3] = {S(0), S(0), S(0)}, off_A_bar[3] = {S(0), S(0), S(0)};
    if (b_moves) {
      add_cross(a, Wu_B, off_B_bar);
      add_cross(b, Wp_B, off_B_bar);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        al_B[i] = al_B[i] + a[i];
        be_B[i] = be_B[i] + b[i];
      }
      add_cross(off_B, a, ga_B);
      add_cross(off_B, b, de_B);
    }
    S w_A_bar[3];
    w_A_bar[2] = phi_bar[k];
    if (a_moves) {
      add_cross(Wu_A, a, off_A_bar);
      add_cross(Wp_A, b, off_A_bar);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        al_A[i] = al_A[i] - a[i];
        be_A[i] = be_A[i] - b[i];
      }
      add_cross(a, off_A, ga_A);
      add_cross(b, off_A, de_A);
      // t = R_WA' J_rel; off_A = R_WA [w_A0, w_A1, 0].
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        R_WA_bar[i][0] = R_WA_bar[i][0] +
                         (ru[i] * ft[0] + rp[i] * st[0] + off_A_bar[i] * w_A[0]);
        R_WA_bar[i][1] = R_WA_bar[i][1] +
                         (ru[i] * ft[1] + rp[i] * st[1] + off_A_bar[i] * w_A[1]);
        R_WA_bar[i][2] = R_WA_bar[i][2] + ru[i] * ft[2];
      }
      w_A_bar[0] = t.R_WA[0][0] * off_A_bar[0] + t.R_WA[1][0] * off_A_bar[1] +
                   t.R_WA[2][0] * off_A_bar[2];
      w_A_bar[1] = t.R_WA[0][1] * off_A_bar[0] + t.R_WA[1][1] * off_A_bar[1] +
                   t.R_WA[2][1] * off_A_bar[2];
    } else {
      w_A_bar[0] = w_A_bar[1] = S(0);
    }
    // off_B = R_WB wit, w_A = R_AB wit + p_AoBo_A.
    S wit_bar[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      wit_bar[i] = t.R_WB[0][i] * off_B_bar[0] + t.R_WB[1][i] * off_B_bar[1] +
                   t.R_WB[2][i] * off_B_bar[2] +
                   (t.R_AB[0][i] * w_A_bar[0] + t.R_AB[1][i] * w_A_bar[1] +
                    t.R_AB[2][i] * w_A_bar[2]);
      pab_bar[i] = pab_bar[i] + w_A_bar[i];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (b_moves)
          R_WB_bar[i][j] = R_WB_bar[i][j] + off_B_bar[i] * t.wit[c][j];
        R_AB_bar[i][j] = R_AB_bar[i][j] + w_A_bar[i] * t.wit[c][j];
      }
    }
    // The witness is the vertex the sort picked: a box's corner (signed
    // half lengths) or a polygon's vertex; a sphere's is its radius along
    // the support direction dir = -R_AB[2] (wit = dir * radius).
    const int m = t.vertex[c];
    if (gb.kind == kGeomSphere) {
      const S radius = p[gb.shape_index];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        g_p[gb.shape_index] =
            g_p[gb.shape_index] + wit_bar[i] * (-t.R_AB[2][i]);
        R_AB_bar[2][i] = R_AB_bar[2][i] - wit_bar[i] * radius;
      }
    } else if (gb.kind == kGeomBox) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
        g_p[gb.shape_index + i] =
            g_p[gb.shape_index + i] +
            ((m >> (2 - i)) & 1 ? wit_bar[i] : -wit_bar[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 3; ++i)
        g_p[gb.shape_index + 3 * m + i] =
            g_p[gb.shape_index + 3 * m + i] + wit_bar[i];
    }
  }
  // mu_pair = 2 mu_a mu_b / (mu_a + mu_b).
  {
    const S sum = t.mu_a + t.mu_b;
    const S scale = S(2) * mu_bar / (sum * sum);
    g_p[ga.mu_index] = g_p[ga.mu_index] + scale * t.mu_b * t.mu_b;
    g_p[gb.mu_index] = g_p[gb.mu_index] + scale * t.mu_a * t.mu_a;
  }
  // R_AB = R_WA' R_WB, p_AoBo_A = R_WA' (p_WB - p_WA). A world-fixed
  // geometry's frame takes no cotangent.
  S d_bar[3];
  mv3(t.R_WA, pab_bar, d_bar);
  if (b_moves) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        R_WB_bar[i][j] = R_WB_bar[i][j] +
                         (t.R_WA[i][0] * R_AB_bar[0][j] +
                          t.R_WA[i][1] * R_AB_bar[1][j] +
                          t.R_WA[i][2] * R_AB_bar[2][j]);
    geometry_frame_vjp<S, Z>(gb, F, R_WB_bar, d_bar, al_B, be_B, ga_B, de_B,
                             u, vp, Wu_B, Wp_B, Fh);
  }
  if (a_moves) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        R_WA_bar[i][j] = R_WA_bar[i][j] +
                         (t.R_WB[i][0] * R_AB_bar[j][0] +
                          t.R_WB[i][1] * R_AB_bar[j][1] +
                          t.R_WB[i][2] * R_AB_bar[j][2] + t.d[i] * pab_bar[j]);
    const S pa_bar[3] = {-d_bar[0], -d_bar[1], -d_bar[2]};
    geometry_frame_vjp<S, Z>(ga, F, R_WA_bar, pa_bar, al_A, be_A, ga_A, de_A,
                             u, vp, Wu_A, Wp_A, Fh);
  }
}

// The Lagrangian terms' adjoint for body b: M's cotangent Mb (symmetric,
// both triangles) and F's Fb -> the frame cotangent Fh[b] (values and
// rates), the body's inertial scalars' g_p, and vp_bar.
template <typename S, typename Z, typename GP>
__device__ void lagrangian_terms_vjp(const S* p,
                                     const Frame<S, Z::NV>& f, int b,
                                     const S (&vp)[Z::NV],
                                     const S (&Mb)[Z::NV][Z::NV],
                                     const S (&Fb)[Z::NV], GP g_p,
                                     S (&vp_bar)[Z::NV],
                                     Frame<S, Z::NV>& fh) {
  constexpr int NV = Z::NV;
  BodyTerms<S, Z> o;
  Recompute<S>::run([&] { body_terms<S, Z>(p, f, b, vp, o); });
  const S g_z = S(-kGravity);
  S Jcm_bar[3][NV], Jw_bar[3][NV];
  // F += J_cm' (mass g - mass a_cm) - Jw' tau.
  S jf[3], tau_bar[3], fb_bar[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    jf[a] = dotn<S, NV>(o.J_cm[a], Fb);
    tau_bar[a] = -dotn<S, NV>(o.Jw[a], Fb);
    fb_bar[a] = -jf[a];
  }
  S mass_bar = g_z * jf[2];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const S coef = (a == 2 ? o.mass * g_z : S(0)) - o.mass * o.a_cm_bias[a];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      Jcm_bar[a][j] = coef * Fb[j];
      Jw_bar[a][j] = -(o.torque_bias[a] * Fb[j]);
    }
  }
  // M += mass J_cm' J_cm + Jw' I_W Jw.
  S IW_bar[3][3];
  {
    S JM[3][NV], WM[3][NV];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        S jm = o.J_cm[a][0] * Mb[0][j], wm = o.Jw[a][0] * Mb[0][j];
#pragma unroll
        for (int i = 1; i < NV; ++i) {
          jm = jm + o.J_cm[a][i] * Mb[i][j];
          wm = wm + o.Jw[a][i] * Mb[i][j];
        }
        JM[a][j] = jm;
        WM[a][j] = wm;
      }
    S two_mass = S(2) * o.mass;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      mass_bar = mass_bar + dotn<S, NV>(JM[a], o.J_cm[a]);
#pragma unroll
      for (int j = 0; j < NV; ++j)
        Jcm_bar[a][j] = Jcm_bar[a][j] + two_mass * JM[a][j];
#pragma unroll
      for (int y = 0; y < 3; ++y) IW_bar[a][y] = dotn<S, NV>(WM[a], o.Jw[y]);
    }
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      const S Is[3] = {o.I_W[x][0] + o.I_W[0][x], o.I_W[x][1] + o.I_W[1][x],
                       o.I_W[x][2] + o.I_W[2][x]};
#pragma unroll
      for (int j = 0; j < NV; ++j)
        Jw_bar[x][j] = Jw_bar[x][j] + (Is[0] * WM[0][j] + Is[1] * WM[1][j] +
                                       Is[2] * WM[2][j]);
    }
  }
  // force_bias = mass a_cm; tau = I_W omega_dot_bias + omega x I_omega;
  // I_omega = I_W omega.
  S acm_bar[3], odb_bar[3], om_bar[3] = {S(0), S(0), S(0)}, iom_bar[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    mass_bar = mass_bar + fb_bar[a] * o.a_cm_bias[a];
    acm_bar[a] = o.mass * fb_bar[a];
  }
  mtv3(o.I_W, tau_bar, odb_bar);
  add_cross(o.I_omega, tau_bar, om_bar);
  cross3(tau_bar, o.omega, iom_bar);
  {
    S t[3];
    mtv3(o.I_W, iom_bar, t);
#pragma unroll
    for (int i = 0; i < 3; ++i) om_bar[i] = om_bar[i] + t[i];
  }
#pragma unroll
  for (int x = 0; x < 3; ++x)
#pragma unroll
    for (int y = 0; y < 3; ++y)
      IW_bar[x][y] = IW_bar[x][y] + (tau_bar[x] * o.omega_dot_bias[y] +
                                     iom_bar[x] * o.omega[y]);
  // a_cm = J_cm_dot vp, omega_dot_bias = Jw_dot vp, omega = Jw vp, with
  // J_cm_dot = Jv_dot - c_W_dot x Jw - c_W x Jw_dot (columnwise): its
  // cotangent acm_bar vp'.
  S cWd_bar[3], cW_bar[3], cu[3], cv[3];
  cross3(acm_bar, o.omega, cWd_bar);
  cross3(acm_bar, o.omega_dot_bias, cW_bar);
  cross3(o.c_W_dot, acm_bar, cu);
  cross3(o.c_W, acm_bar, cv);
  S Jwd_bar[3][NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    vp_bar[j] = vp_bar[j] + (o.J_cm_dot[0][j] * acm_bar[0] +
                             o.J_cm_dot[1][j] * acm_bar[1] +
                             o.J_cm_dot[2][j] * acm_bar[2] +
                             (o.Jwd[0][j] * odb_bar[0] +
                              o.Jwd[1][j] * odb_bar[1] +
                              o.Jwd[2][j] * odb_bar[2]) +
                             (o.Jw[0][j] * om_bar[0] + o.Jw[1][j] * om_bar[1] +
                              o.Jw[2][j] * om_bar[2]));
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      Jw_bar[x][j] = Jw_bar[x][j] + (om_bar[x] + cu[x]) * vp[j];
      Jwd_bar[x][j] = (odb_bar[x] + cv[x]) * vp[j];
    }
  }
  // J_cm = Jv - c_W x Jw (columnwise).
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const S jb[3] = {Jcm_bar[0][j], Jcm_bar[1][j], Jcm_bar[2][j]};
    const S jw[3] = {o.Jw[0][j], o.Jw[1][j], o.Jw[2][j]};
    S cj[3];
    add_cross(jb, jw, cW_bar);
    cross3(o.c_W, jb, cj);
#pragma unroll
    for (int x = 0; x < 3; ++x) Jw_bar[x][j] = Jw_bar[x][j] + cj[x];
  }
  // I_W = R I_B R': R_bar = (IW_bar + IW_bar') R I_B, I_B's cotangent
  // R' IW_bar R; c_W = R c_B, c_W_dot = R_dot c_B.
  S R_bar[3][3], IB_bar[3][3], cB_bar[3];
  {
    S RI[3][3], RtW[3][3];
    mm3(o.R, o.I_B, RI);
    mtm3(o.R, IW_bar, RtW);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        S acc = cW_bar[i] * o.c_B[j], ib = RtW[i][0] * o.R[0][j];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          acc = acc + (IW_bar[i][k] + IW_bar[k][i]) * RI[k][j];
#pragma unroll
        for (int k = 1; k < 3; ++k) ib = ib + RtW[i][k] * o.R[k][j];
        R_bar[i][j] = acc;
        IB_bar[i][j] = ib;
      }
#pragma unroll
    for (int k = 0; k < 3; ++k)
      cB_bar[k] = o.R[0][k] * cW_bar[0] + o.R[1][k] * cW_bar[1] +
                  o.R[2][k] * cW_bar[2] +
                  (o.Rd[0][k] * cWd_bar[0] + o.Rd[1][k] * cWd_bar[1] +
                   o.Rd[2][k] * cWd_bar[2]);
  }
  // The inertial scalars: mass, first moments (c_B = p[1:4] / mass),
  // inertia [Ixx, Iyy, Izz, Ixy, Ixz, Iyz].
  const int g = 10 * b;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g_p[g + 1 + k] = g_p[g + 1 + k] + cB_bar[k] / o.mass;
    mass_bar = mass_bar - cB_bar[k] * o.c_B[k] / o.mass;
  }
  g_p[g] = g_p[g] + mass_bar;
  g_p[g + 4] = g_p[g + 4] + IB_bar[0][0];
  g_p[g + 5] = g_p[g + 5] + IB_bar[1][1];
  g_p[g + 6] = g_p[g + 6] + IB_bar[2][2];
  g_p[g + 7] = g_p[g + 7] + (IB_bar[0][1] + IB_bar[1][0]);
  g_p[g + 8] = g_p[g + 8] + (IB_bar[0][2] + IB_bar[2][0]);
  g_p[g + 9] = g_p[g + 9] + (IB_bar[1][2] + IB_bar[2][1]);
  // The frame's cotangent: values in .d, rates in .v (Jv_dot's is
  // acm_bar vp').
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      fh.R[i][j].d = fh.R[i][j].d + R_bar[i][j];
      fh.R[i][j].v = fh.R[i][j].v + cWd_bar[i] * o.c_B[j];
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      fh.Jw[i][j].d = fh.Jw[i][j].d + Jw_bar[i][j];
      fh.Jw[i][j].v = fh.Jw[i][j].v + Jwd_bar[i][j];
      fh.Jv[i][j].d = fh.Jv[i][j].d + Jcm_bar[i][j];
      fh.Jv[i][j].v = fh.Jv[i][j].v + acm_bar[i] * vp[j];
    }
  }
}

// body_kinematics' adjoint, in reverse body order: the frame cotangents Fh
// (swapped Duals) -> qh, the swapped cotangent of the Dual (q, qdot): .d
// q's cotangent, .v qdot's. Each body adds into its parent's cotangent.
template <typename S, typename Z>
__device__ void body_kinematics_vjp(const ModelDesc<Z>& desc,
                                    const Dual<S> (&q)[Z::NQ],
                                    const Frame<S, Z::NV> (&F)[Z::NB],
                                    Frame<S, Z::NV> (&Fh)[Z::NB],
                                    Dual<S> (&qh)[Z::NQ]) {
  using X = Dual<S>;
  constexpr int NV = Z::NV;
  const X zero = cst<X>(0.0), one = cst<X>(1.0);
#pragma unroll
  for (int b = Z::NB - 1; b >= 0; --b) {
    const auto& bd = body_desc<Z>(desc, b);
    const Frame<S, NV>& f = F[b];
    Frame<S, NV>& fh = Fh[b];
    if (bd.joint == kJointFree) {
      // R = quat_to_rotmat(quat), Jw[:, v_off + j] = R[:, j], p = q[4:7].
      X Rh[3][3], quat[4], quat_h[4] = {zero, zero, zero, zero};
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          Rh[i][j] = fh.R[i][j] + pick<NV>(fh.Jw[i], bd.v_off + j);
#pragma unroll
      for (int j = 0; j < 4; ++j) quat[j] = pick<Z::NQ>(q, bd.q_off + j);
      quat_to_rotmat_vjp(Rh, quat, quat_h);
#pragma unroll
      for (int j = 0; j < 4; ++j) add_at<Z::NQ>(qh, bd.q_off + j, quat_h[j]);
#pragma unroll
      for (int i = 0; i < 3; ++i) add_at<Z::NQ>(qh, bd.q_off + 4 + i, fh.p[i]);
      continue;
    }
    if (bd.joint == kJointFixed && bd.parent < 0) continue;  // constant
    const bool has_parent = bd.parent >= 0;
    // The parent's frame; the world's for -1.
    Frame<S, NV> P;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      P.p[i] = zero;
#pragma unroll
      for (int j = 0; j < 3; ++j) P.R[i][j] = i == j ? one : zero;
#pragma unroll
      for (int v = 0; v < NV; ++v) P.Jw[i][v] = P.Jv[i][v] = zero;
    }
#pragma unroll
    for (int pb = 0; pb < Z::NB; ++pb)
      if (pb < b && bd.parent == pb) P = F[pb];
    X R_PJ[3][3], p_PJ[3], R_WJ[3][3], axis[3], axis_W[3];
    const_mat(bd.R_PJ, R_PJ);
    const_vec(bd.p_PJ, p_PJ);
    const_vec(bd.axis, axis);
    mm3(P.R, R_PJ, R_WJ);
    mv3(R_WJ, axis, axis_W);
    X R_WJ_h[3][3], offset_h[3], axis_W_h[3], r_h[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      offset_h[i] = axis_W_h[i] = r_h[i] = zero;
#pragma unroll
      for (int j = 0; j < 3; ++j) R_WJ_h[i][j] = zero;
    }
    // Jv = P.Jv - r x P.Jw (columnwise), r = p - P.p; prismatic adds
    // axis_W to column v_off. Jw = P.Jw; revolute adds axis_W to column
    // v_off.
    if (bd.joint == kJointPrismatic) {
#pragma unroll
      for (int i = 0; i < 3; ++i) axis_W_h[i] = pick<NV>(fh.Jv[i], bd.v_off);
    } else if (bd.joint == kJointRevolute) {
#pragma unroll
      for (int i = 0; i < 3; ++i) axis_W_h[i] = pick<NV>(fh.Jw[i], bd.v_off);
    }
    Frame<S, NV> Ph;
    if (has_parent) {
      X r[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) r[i] = f.p[i] - P.p[i];
      zero_frame<S, NV>(Ph);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const X jh[3] = {fh.Jv[0][v], fh.Jv[1][v], fh.Jv[2][v]};
        const X jw[3] = {P.Jw[0][v], P.Jw[1][v], P.Jw[2][v]};
        X rj[3];
        add_cross(jh, jw, r_h);
        cross3(r, jh, rj);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          Ph.Jv[i][v] = fh.Jv[i][v];
          Ph.Jw[i][v] = fh.Jw[i][v] + rj[i];
        }
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) Ph.p[i] = fh.p[i];
    }
    // p = P.p + offset (+ disp axis_W): offset's cotangent p's and r's.
    X p_h[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      p_h[i] = fh.p[i] + r_h[i];
      offset_h[i] = p_h[i];
    }
    if (bd.joint == kJointRevolute) {
      // R = R_WJ rot(q), rot = axis_angle_rotation(axis, angle).
      const X angle = pick<Z::NQ>(q, bd.q_off);
      X rot[3][3], rot_h[3][3];
      axis_angle_rotation(axis, angle, rot);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          R_WJ_h[i][j] = fh.R[i][0] * rot[j][0] + fh.R[i][1] * rot[j][1] +
                         fh.R[i][2] * rot[j][2];
          rot_h[i][j] = R_WJ[0][i] * fh.R[0][j] + R_WJ[1][i] * fh.R[1][j] +
                        R_WJ[2][i] * fh.R[2][j];
        }
      // d rot / d angle = -s I + c K + s a a'.
      const X s = sin(angle), c = cos(angle);
      X K[3][3];
      skew(axis, zero, K);
      X angle_h = zero;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const X d = (i == j ? -s : zero) + c * K[i][j] +
                      s * axis[i] * axis[j];
          angle_h = angle_h + rot_h[i][j] * d;
        }
      add_at<Z::NQ>(qh, bd.q_off, angle_h);
    } else {  // prismatic or fixed: R = R_WJ
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) R_WJ_h[i][j] = fh.R[i][j];
      if (bd.joint == kJointPrismatic) {
        const X disp = pick<Z::NQ>(q, bd.q_off);
        X disp_h = zero;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          disp_h = disp_h + p_h[i] * axis_W[i];
          axis_W_h[i] = axis_W_h[i] + disp * p_h[i];
        }
        add_at<Z::NQ>(qh, bd.q_off, disp_h);
      }
    }
    // axis_W = R_WJ axis.
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        R_WJ_h[i][j] = R_WJ_h[i][j] + axis_W_h[i] * axis[j];
    if (!has_parent) continue;
    // R_WJ = P.R R_PJ, offset = P.R p_PJ.
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        Ph.R[i][j] = R_WJ_h[i][0] * R_PJ[j][0] + R_WJ_h[i][1] * R_PJ[j][1] +
                     R_WJ_h[i][2] * R_PJ[j][2] + offset_h[i] * p_PJ[j];
#pragma unroll
    for (int pb = 0; pb < Z::NB; ++pb)
      if (pb < b && bd.parent == pb) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          Fh[pb].p[i] = Fh[pb].p[i] + Ph.p[i];
#pragma unroll
          for (int j = 0; j < 3; ++j) Fh[pb].R[i][j] = Fh[pb].R[i][j] + Ph.R[i][j];
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            Fh[pb].Jw[i][v] = Fh[pb].Jw[i][v] + Ph.Jw[i][v];
            Fh[pb].Jv[i][v] = Fh[pb].Jv[i][v] + Ph.Jv[i][v];
          }
        }
      }
  }
}

// configuration_rate's adjoint: qdot's cotangent -> q's and vp's.
template <typename S, typename Z>
__device__ void configuration_rate_vjp(const ModelDesc<Z>& desc,
                                       const S (&q)[Z::NQ],
                                       const S (&vp)[Z::NV],
                                       const S (&qdot_bar)[Z::NQ],
                                       S (&q_bar)[Z::NQ],
                                       S (&vp_bar)[Z::NV]) {
#pragma unroll
  for (int b = 0; b < Z::NB; ++b) {
    const auto& bd = body_desc<Z>(desc, b);
    if (bd.joint == kJointFree) {
      const int o = bd.q_off, w = bd.v_off;
      const S q0 = pick<Z::NQ>(q, o), q1 = pick<Z::NQ>(q, o + 1),
              q2 = pick<Z::NQ>(q, o + 2), q3 = pick<Z::NQ>(q, o + 3);
      const S w0 = pick<Z::NV>(vp, w), w1 = pick<Z::NV>(vp, w + 1),
              w2 = pick<Z::NV>(vp, w + 2);
      const S a0 = S(0.5) * pick<Z::NQ>(qdot_bar, o),
              a1 = S(0.5) * pick<Z::NQ>(qdot_bar, o + 1),
              a2 = S(0.5) * pick<Z::NQ>(qdot_bar, o + 2),
              a3 = S(0.5) * pick<Z::NQ>(qdot_bar, o + 3);
      add_at<Z::NQ>(q_bar, o, a1 * w0 + a2 * w1 + a3 * w2);
      add_at<Z::NQ>(q_bar, o + 1, -a0 * w0 - a2 * w2 + a3 * w1);
      add_at<Z::NQ>(q_bar, o + 2, -a0 * w1 + a1 * w2 - a3 * w0);
      add_at<Z::NQ>(q_bar, o + 3, -a0 * w2 - a1 * w1 + a2 * w0);
      add_at<Z::NV>(vp_bar, w, -a0 * q1 + a1 * q0 + a2 * q3 - a3 * q2);
      add_at<Z::NV>(vp_bar, w + 1, -a0 * q2 - a1 * q3 + a2 * q0 + a3 * q1);
      add_at<Z::NV>(vp_bar, w + 2, -a0 * q3 + a1 * q2 - a2 * q1 + a3 * q0);
#pragma unroll
      for (int i = 0; i < 3; ++i)
        add_at<Z::NV>(vp_bar, w + 3 + i, pick<Z::NQ>(qdot_bar, o + 4 + i));
    } else if (bd.joint == kJointRevolute || bd.joint == kJointPrismatic) {
      add_at<Z::NV>(vp_bar, bd.v_off, pick<Z::NQ>(qdot_bar, bd.q_off));
    }
  }
}

// K2's body: the gradient of ct * L for one sample with respect to the
// n_params derived scalars (g_p: a pointer to them, or the sample's
// GradColumn), the velocity and actuation rows of xin
// (g_xin, whose configuration rows get exactly 0) and the rows of xp
// (g_xp), at the saved impulse f. A failed solve's loss is 0, and so is
// its gradient. Inline in the kernel: as an out-of-line call the sweep ran
// some 7% slower in float32.
template <typename S, typename Z, typename GP>
__device__ __forceinline__ void model_loss_vjp(const ModelDesc<Z>& desc, const S* p,
                               const S (&xin)[Z::NX + Z::NU],
                               const S (&xp)[Z::NX],
                               const S (&f)[3][Z::K], bool valid, S ct, S dt,
                               GP g_p, S (&g_xin)[Z::NX + Z::NU],
                               S (&g_xp)[Z::NX]) {
  constexpr int NV = Z::NV, NQ = Z::NQ, NU = Z::NU, K = Z::K;
#pragma unroll
  for (int i = 0; i < Z::NX + NU; ++i) g_xin[i] = S(0);
#pragma unroll
  for (int i = 0; i < Z::NX; ++i) g_xp[i] = S(0);
  for (int i = 0; i < desc.n_params; ++i) g_p[i] = S(0);
  if (!valid) return;

  // (a) The forward sweep, and w = M^-1 J'f.
  S v[NV], u[NU], q[NQ], vp[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    v[i] = xin[NQ + i];
    vp[i] = xp[NQ + i];
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) u[i] = xin[Z::NX + i];
#pragma unroll
  for (int i = 0; i < NQ; ++i) q[i] = xp[i];
  Frame<S, NV> F[Z::NB];
  model_frames<S, Z>(desc, q, vp, F);
  ModelParts<S, Z> lp;
  model_loss_parts<S, Z>(desc, p, v, u, vp, F, dt, lp);
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
  // Assembly and linear term. qc's cotangent is f, so J's is
  // f u' + (sliding rows) sb vp' with u = M^-1 J'f - dv, and dv's is
  // M dv - J'f.
  S uu[NV], dv_bar[NV], vp_bar[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    dv_bar[i] = dotn<S, NV>(lp.M[i], lp.dv) - jtf[i];
    uu[i] = w[i] - lp.dv[i];
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
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    S acc = dv_bar[j];
#pragma unroll
    for (int c = 0; c < K; ++c)
      acc = acc + (sb[0][c] * lp.J[1][j][c] + sb[1][c] * lp.J[2][j][c]);
    vp_bar[j] = acc;
  }

  // dv = vp - (v + a_nc dt), a_nc = M^-1 F: F's cotangent Fb = -dt M^-1
  // dv_bar; M's, symmetrised (M is symmetric by construction),
  // Mb = -0.5 w w' + 0.5 dv dv' - sym(Fb a_nc').
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

  // Contact terms, then Lagrangian terms (and actuation, F[v_off] += u),
  // into the frames' cotangents.
  Frame<S, NV> Fh[Z::NB];
#pragma unroll
  for (int b = 0; b < Z::NB; ++b) zero_frame<S, NV>(Fh[b]);
#pragma unroll
  for (int pp = 0; pp < Z::NPAIR; ++pp)
    contact_terms_vjp<S, Z>(desc, p, F, pp, f, sb, phi_bar, uu, vp, g_p, Fh);
  S u_bar[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) u_bar[i] = S(0);
#pragma unroll
  for (int b = 0; b < Z::NB; ++b) {
    lagrangian_terms_vjp<S, Z>(p, F[b], b, vp, Mb, Fb, g_p, vp_bar, Fh[b]);
    const auto& bd = body_desc<Z>(desc, b);
    if (bd.u_index >= 0)
      add_at<NU>(u_bar, bd.u_index, pick<NV>(Fb, bd.v_off));
  }

  // The kinematic tree, then qdot = configuration_rate(q, vp).
  S q_bar[NQ];
  {
    S qdot[NQ];
    Recompute<S>::run([&] { configuration_rate<S, Z>(desc, q, vp, qdot); });
    Dual<S> qd[NQ], qh[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      qd[i] = Dual<S>(q[i], qdot[i]);
      qh[i] = Dual<S>(S(0), S(0));
    }
    body_kinematics_vjp<S, Z>(desc, qd, F, Fh, qh);
    S qdot_bar[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      q_bar[i] = qh[i].d;
      qdot_bar[i] = qh[i].v;
    }
    configuration_rate_vjp<S, Z>(desc, q, vp, qdot_bar, q_bar, vp_bar);
  }

  // Outputs, scaled by ct.
  for (int i = 0; i < desc.n_params; ++i) g_p[i] = ct * g_p[i];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    g_xin[NQ + i] = -ct * dv_bar[i];
    g_xp[NQ + i] = ct * vp_bar[i];
  }
#pragma unroll
  for (int i = 0; i < NU; ++i)
    if (i < desc.n_u) g_xin[Z::NX + i] = ct * u_bar[i];
#pragma unroll
  for (int i = 0; i < NQ; ++i) g_xp[i] = ct * q_bar[i];
}

}  // namespace
