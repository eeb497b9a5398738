// ContactNets loss terms of any model of the fused loss kernels' class, for
// one sample per CUDA thread.
//
// The model-generic counterpart of cube_terms.cuh, and of
// dair_pll_tpu_torch/multibody/soa_terms.py's soa_loss_parts and
// soa_loss_assemble: kinematic trees of free, revolute, prismatic and fixed
// joints, plane-versus-convex contact pairs whose convex is a box, a polygon
// (of any vertex count) or a sphere, and actuation of revolute and
// prismatic joints. The sizes are template parameters (ModelSize: bodies,
// configuration and velocity dimension, derived scalars, polygon vertices,
// each pair's witnesses),
// so every loop over bodies, pairs, witnesses and velocity rows unrolls;
// the model itself is a small descriptor (ModelDesc) that the wrapper builds
// once from the MultibodyModel and passes by value. Branches on the
// descriptor are uniform across a warp, and array indices stay compile-time
// constants: a runtime offset (a joint's place in q or v, a body's parent)
// is met by a compile-time loop over the candidates (pick, put).
//
// Every product and sum comes in the plain version's order, so that in
// float64 the two agree to the last bits (the library is built without fused
// multiply-adds). The derived scalars p are the layout of
// ops/soa_loss_kernels.pack_derived: pi (10 per body), mu (one per
// geometry), then each geometry's shape (a box's 3 half lengths, a
// polygon's vertices, a sphere's radius).
//
// The scalar type T is float or double (or, in the host build that counts
// operations, a counting scalar). The kinematics' rates along qdot are a
// forward-mode JVP in Dual<T>, as the plain version's torch.func.jvp. The
// forward pieces keep what the backward kernel K2 needs (ModelParts' factor
// of M, the sliding rates; PairTerms and BodyTerms, which the adjoint
// recomputes per pair and per body): its reverse-mode sweep is in
// model_adjoint.cuh.
#pragma once

#include "cube_terms.cuh"

namespace {

// The math library's functions beside this file's overloads for the dual
// types (a name declared here would otherwise hide them).
using ::cos;
using ::fabs;
using ::sin;
using ::sqrt;

// Dual (value and rate along qdot) operations beyond cube_terms.cuh's, with
// the tangents of torch's forward-mode rules.
template <typename S>
__device__ __forceinline__ Dual<S> operator-(const Dual<S>& a) {
  return Dual<S>(-a.v, -a.d);
}
template <typename S>
__device__ __forceinline__ Dual<S> sin(const Dual<S>& a) {
  return Dual<S>(sin(a.v), a.d * cos(a.v));
}
template <typename S>
__device__ __forceinline__ Dual<S> cos(const Dual<S>& a) {
  return Dual<S>(cos(a.v), a.d * (-sin(a.v)));
}

// a[i] for a runtime index i < N, by a compile-time loop (no local memory).
template <int N, typename X>
__device__ __forceinline__ X pick(const X (&a)[N], int i) {
  X r = a[0];
#pragma unroll
  for (int n = 1; n < N; ++n)
    if (n == i) r = a[n];
  return r;
}
// a[i] = x for a runtime index i (no store when i is out of range).
template <int N, typename X>
__device__ __forceinline__ void put(X (&a)[N], int i, const X& x) {
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (n == i) a[n] = x;
}

// ---------------------------------------------------------------------------
// Small algebra in soa.py's order of operations, on any scalar type.
template <typename X>
__device__ __forceinline__ void mm3(const X (&A)[3][3], const X (&B)[3][3],
                                   X (&out)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[i][j] = A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j];
}
// A' B.
template <typename X>
__device__ __forceinline__ void mtm3(const X (&A)[3][3], const X (&B)[3][3],
                                    X (&out)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[i][j] = A[0][i] * B[0][j] + A[1][i] * B[1][j] + A[2][i] * B[2][j];
}
template <typename X>
__device__ __forceinline__ void mv3(const X (&A)[3][3], const X (&x)[3],
                                   X (&out)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = A[i][0] * x[0] + A[i][1] * x[1] + A[i][2] * x[2];
}
// A' x (soa.matvec_t).
template <typename X>
__device__ __forceinline__ void mtv3(const X (&A)[3][3], const X (&x)[3],
                                    X (&out)[3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
    out[j] = A[0][j] * x[0] + A[1][j] * x[1] + A[2][j] * x[2];
}
// soa.skew, its zeros `zero`.
template <typename X>
__device__ __forceinline__ void skew(const X (&v)[3], const X& zero,
                                    X (&S)[3][3]) {
  S[0][0] = zero;  S[0][1] = -v[2]; S[0][2] = v[1];
  S[1][0] = v[2];  S[1][1] = zero;  S[1][2] = -v[0];
  S[2][0] = -v[1]; S[2][1] = v[0];  S[2][2] = zero;
}
// A (3 x 3) times J (3 x NV).
template <typename X, int NV>
__device__ __forceinline__ void mm3n(const X (&A)[3][3], const X (&J)[3][NV],
                                    X (&out)[3][NV]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < NV; ++j)
      out[i][j] = A[i][0] * J[0][j] + A[i][1] * J[1][j] + A[i][2] * J[2][j];
}
// J_a - skew(r) J_w (soa.msub(J_a, soa.matmul(soa.skew(r), J_w))).
template <typename X, int NV>
__device__ __forceinline__ void shift_jacobian(const X (&Ja)[3][NV],
                                              const X (&r)[3],
                                              const X (&Jw)[3][NV],
                                              const X& zero,
                                              X (&out)[3][NV]) {
  X S[3][3], SJ[3][NV];
  skew(r, zero, S);
  mm3n<X, NV>(S, Jw, SJ);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < NV; ++j) out[i][j] = Ja[i][j] - SJ[i][j];
}
// soa.dot over n entries.
template <typename X, int N>
__device__ __forceinline__ X dotn(const X (&a)[N], const X (&b)[N]) {
  X acc = a[0] * b[0];
#pragma unroll
  for (int i = 1; i < N; ++i) acc = acc + a[i] * b[i];
  return acc;
}

// ---------------------------------------------------------------------------
// The model descriptor. Joint and geometry kinds:
constexpr int kJointFree = 0, kJointRevolute = 1, kJointPrismatic = 2,
              kJointFixed = 3;
constexpr int kGeomPlane = 0, kGeomBox = 1, kGeomPolygon = 2,
              kGeomSphere = 3;
constexpr int kBoxVertices = 8;

// A body and its inboard joint: q_off and v_off its coordinates' place in
// q and v, u_index its actuator's row of u (-1 for none); R_PJ, p_PJ the
// joint frame in the parent's, axis the joint axis.
struct BodyDesc {
  int joint, parent, q_off, v_off, u_index;
  double R_PJ[3][3], p_PJ[3], axis[3];
};
// A collision geometry: its kind, body (-1 the world), vertex count (a
// polygon's), the indices of its friction and of its first shape scalar in
// p, and its pose in the body frame.
struct GeomDesc {
  int kind, body, n_vertices, mu_index, shape_index;
  double R_BG[3][3], p_BG[3];
};

// Sizes of an instantiation: NB bodies, NQ/NV configuration and velocity
// dimensions, PMAX the most derived scalars, NVERT the vertices a convex's
// sort takes (a box's 8, or a polygon's count if larger), and one witness
// count for each plane-convex pair (NPAIR pairs, K contacts in all,
// pair-major: pair pp's witnesses are contacts first(pp) ..
// first(pp) + kq(pp) - 1; KQ the most witnesses of a pair); NU the most
// actuators. ops/soa_loss_kernels.py builds one instantiation per size at
// first use (generic_size names it).
template <int NB_, int NQ_, int NV_, int PMAX_, int NVERT_, int... KQS>
struct ModelSize {
  static_assert(sizeof...(KQS) > 0 && NVERT_ >= kBoxVertices,
                "one pair or more; a box's vertices fit the sort");
  // Witnesses of pair pp, and its first contact (pp a compile-time
  // constant once the loops over pairs unroll).
  __host__ __device__ static constexpr int kq(int pp) {
    constexpr int counts[] = {KQS...};
    return counts[pp];
  }
  __host__ __device__ static constexpr int first(int pp) {
    constexpr int counts[] = {KQS...};
    int k = 0;
    for (int i = 0; i < pp; ++i) k += counts[i];
    return k;
  }
  __host__ __device__ static constexpr int most() {
    constexpr int counts[] = {KQS...};
    int m = 0;
    for (int c : counts) m = c > m ? c : m;
    return m;
  }
  static constexpr int NB = NB_, NQ = NQ_, NV = NV_,
                       NPAIR = (int)sizeof...(KQS), K = (KQS + ...),
                       KQ = most(), NU = NB_, NX = NQ_ + NV_, PMAX = PMAX_,
                       NVERT = NVERT_;
};

template <typename Z> struct ModelDesc {
  BodyDesc body[Z::NB];
  GeomDesc plane[Z::NPAIR], convex[Z::NPAIR];  // each pair's geometries
  int n_params, n_u;
};

// Whether a size's kernels take its body's joint as compile-time
// constants. One body with 7 coordinates and 6 velocities has one free
// joint, parented to the world, at the start of q and v and unactuated;
// as constants, the kinematics' runtime offsets (pick, put) become fixed
// indices and the other joints' code drops out, with the same arithmetic.
// The polygon cube's (6, 4) keeps reading them from the descriptor.
template <typename Z>
constexpr bool kConstFreeBody =
    Z::NB == 1 && Z::NQ == 7 && Z::NV == 6 && Z::K != 4;

// Body b's descriptor: a copy with the free body's fields as constants at
// the sizes of kConstFreeBody, else the descriptor's own entry.
template <typename Z>
__device__ __forceinline__ decltype(auto) body_desc(const ModelDesc<Z>& desc,
                                                    int b) {
  if constexpr (kConstFreeBody<Z>) {
    BodyDesc bd = desc.body[b];
    bd.joint = kJointFree;
    bd.parent = -1;
    bd.q_off = 0;
    bd.v_off = 0;
    bd.u_index = -1;
    return bd;
  } else {
    return (desc.body[b]);
  }
}

// ---------------------------------------------------------------------------
// soa_body_kinematics with its JVP along qdot: each body's world pose and
// angular and linear Jacobians, every entry a Dual (value, rate).
template <typename T, int NV> struct Frame {
  Dual<T> R[3][3], p[3], Jw[3][NV], Jv[3][NV];
};

template <typename X>
__device__ __forceinline__ void const_mat(const double (&a)[3][3],
                                          X (&out)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) out[i][j] = cst<X>(a[i][j]);
}
template <typename X>
__device__ __forceinline__ void const_vec(const double (&a)[3], X (&out)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = cst<X>(a[i]);
}

// Rodrigues rotation about a constant unit axis (_axis_angle_rotation).
template <typename X>
__device__ __forceinline__ void axis_angle_rotation(const X (&axis)[3],
                                                    const X& angle,
                                                    X (&out)[3][3]) {
  const X zero = cst<X>(0.0);
  const X s = sin(angle), c = cos(angle);
  const X one_c = cst<X>(1.0) - c;
  X K[3][3];
  skew(axis, zero, K);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[i][j] = (i == j ? c : zero) + s * K[i][j] +
                  one_c * axis[i] * axis[j];
}

template <typename T, typename Z>
__device__ void body_kinematics(const ModelDesc<Z>& desc,
                                const Dual<T> (&q)[Z::NQ],
                                Frame<T, Z::NV> (&F)[Z::NB]) {
  using X = Dual<T>;
  constexpr int NV = Z::NV;
  const X zero = cst<X>(0.0), one = cst<X>(1.0);
#pragma unroll
  for (int b = 0; b < Z::NB; ++b) {
    const auto& bd = body_desc<Z>(desc, b);
    Frame<T, NV>& f = F[b];
    if (bd.joint == kJointFree) {
      X quat[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) quat[j] = pick<Z::NQ>(q, bd.q_off + j);
      quat_to_rotmat(quat, f.R);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        f.p[i] = pick<Z::NQ>(q, bd.q_off + 4 + i);
#pragma unroll
        for (int v = 0; v < NV; ++v) f.Jw[i][v] = f.Jv[i][v] = zero;
#pragma unroll
        for (int j = 0; j < 3; ++j) put<NV>(f.Jw[i], bd.v_off + j, f.R[i][j]);
        put<NV>(f.Jv[i], bd.v_off + 3 + i, one);
      }
      continue;
    }
    X R_PJ[3][3], p_PJ[3];
    const_mat(bd.R_PJ, R_PJ);
    const_vec(bd.p_PJ, p_PJ);
    if (bd.joint == kJointFixed && bd.parent < 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        f.p[i] = p_PJ[i];
#pragma unroll
        for (int j = 0; j < 3; ++j) f.R[i][j] = R_PJ[i][j];
#pragma unroll
        for (int v = 0; v < NV; ++v) f.Jw[i][v] = f.Jv[i][v] = zero;
      }
      continue;
    }
    // The parent's frame; the world's for -1.
    Frame<T, NV> P;
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

    X R_WJ[3][3], offset[3], r[3];
    mm3(P.R, R_PJ, R_WJ);
    mv3(P.R, p_PJ, offset);
    if (bd.joint == kJointRevolute) {
      X axis[3], rot[3][3], axis_W[3];
      const_vec(bd.axis, axis);
#pragma unroll
      for (int i = 0; i < 3; ++i) f.p[i] = P.p[i] + offset[i];
      axis_angle_rotation(axis, pick<Z::NQ>(q, bd.q_off), rot);
      mm3(R_WJ, rot, f.R);
      mv3(R_WJ, axis, axis_W);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        r[i] = f.p[i] - P.p[i];
#pragma unroll
        for (int v = 0; v < NV; ++v)
          f.Jw[i][v] = v == bd.v_off ? P.Jw[i][v] + axis_W[i] : P.Jw[i][v];
      }
      shift_jacobian<X, NV>(P.Jv, r, P.Jw, zero, f.Jv);
    } else if (bd.joint == kJointPrismatic) {
      X axis[3], axis_W[3];
      const_vec(bd.axis, axis);
      mv3(R_WJ, axis, axis_W);
      const X disp = pick<Z::NQ>(q, bd.q_off);
#pragma unroll
      for (int i = 0; i < 3; ++i)
        f.p[i] = P.p[i] + offset[i] + disp * axis_W[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        r[i] = f.p[i] - P.p[i];
#pragma unroll
        for (int j = 0; j < 3; ++j) f.R[i][j] = R_WJ[i][j];
#pragma unroll
        for (int v = 0; v < NV; ++v) f.Jw[i][v] = P.Jw[i][v];
      }
      shift_jacobian<X, NV>(P.Jv, r, P.Jw, zero, f.Jv);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int v = 0; v < NV; ++v)
          if (v == bd.v_off) f.Jv[i][v] = f.Jv[i][v] + axis_W[i];
    } else {  // fixed, to a body
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        f.p[i] = P.p[i] + offset[i];
#pragma unroll
        for (int j = 0; j < 3; ++j) f.R[i][j] = R_WJ[i][j];
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        r[i] = f.p[i] - P.p[i];
#pragma unroll
        for (int v = 0; v < NV; ++v) f.Jw[i][v] = P.Jw[i][v];
      }
      shift_jacobian<X, NV>(P.Jv, r, P.Jw, zero, f.Jv);
    }
  }
}

// soa_configuration_rate: qdot from (q, v).
template <typename T, typename Z>
__device__ void configuration_rate(const ModelDesc<Z>& desc,
                                   const T (&q)[Z::NQ], const T (&v)[Z::NV],
                                   T (&qdot)[Z::NQ]) {
  using B = base_t<T>;
#pragma unroll
  for (int i = 0; i < Z::NQ; ++i) qdot[i] = T(B(0));
#pragma unroll
  for (int b = 0; b < Z::NB; ++b) {
    const auto& bd = body_desc<Z>(desc, b);
    if (bd.joint == kJointFree) {
      const T qw = pick<Z::NQ>(q, bd.q_off), qx = pick<Z::NQ>(q, bd.q_off + 1),
              qy = pick<Z::NQ>(q, bd.q_off + 2),
              qz = pick<Z::NQ>(q, bd.q_off + 3);
      const T wx = pick<Z::NV>(v, bd.v_off), wy = pick<Z::NV>(v, bd.v_off + 1),
              wz = pick<Z::NV>(v, bd.v_off + 2);
      put<Z::NQ>(qdot, bd.q_off, B(0.5) * (-qx * wx - qy * wy - qz * wz));
      put<Z::NQ>(qdot, bd.q_off + 1, B(0.5) * (qw * wx + qy * wz - qz * wy));
      put<Z::NQ>(qdot, bd.q_off + 2, B(0.5) * (qw * wy + qz * wx - qx * wz));
      put<Z::NQ>(qdot, bd.q_off + 3, B(0.5) * (qw * wz + qx * wy - qy * wx));
#pragma unroll
      for (int i = 0; i < 3; ++i)
        put<Z::NQ>(qdot, bd.q_off + 4 + i, pick<Z::NV>(v, bd.v_off + 3 + i));
    } else if (bd.joint == kJointRevolute || bd.joint == kJointPrismatic) {
      put<Z::NQ>(qdot, bd.q_off, pick<Z::NV>(v, bd.v_off));
    }
  }
}

// ---------------------------------------------------------------------------
// soa_geometry_kinematics for one geometry: world pose and Jacobians.
template <typename T, typename Z>
__device__ void geometry_frame(const GeomDesc& g,
                               const Frame<T, Z::NV> (&F)[Z::NB],
                               T (&R)[3][3], T (&p)[3], T (&Jw)[3][Z::NV],
                               T (&Jv)[3][Z::NV]) {
  using B = base_t<T>;
  constexpr int NV = Z::NV;
  const T zero = T(B(0));
  T R_BG[3][3], p_BG[3];
  const_mat(g.R_BG, R_BG);
  const_vec(g.p_BG, p_BG);
  if (g.body < 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      p[i] = p_BG[i];
#pragma unroll
      for (int j = 0; j < 3; ++j) R[i][j] = R_BG[i][j];
#pragma unroll
      for (int v = 0; v < NV; ++v) Jw[i][v] = Jv[i][v] = zero;
    }
    return;
  }
  T R_WB[3][3], p_WB[3], Jw_B[3][NV], Jv_B[3][NV];
#pragma unroll
  for (int b = 0; b < Z::NB; ++b)
    if (b == 0 || g.body == b) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        p_WB[i] = F[b].p[i].v;
#pragma unroll
        for (int j = 0; j < 3; ++j) R_WB[i][j] = F[b].R[i][j].v;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          Jw_B[i][v] = F[b].Jw[i][v].v;
          Jv_B[i][v] = F[b].Jv[i][v].v;
        }
      }
    }
  T offset_W[3];
  mv3(R_WB, p_BG, offset_W);
  mm3(R_WB, R_BG, R);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = p_WB[i] + offset_W[i];
#pragma unroll
    for (int v = 0; v < NV; ++v) Jw[i][v] = Jw_B[i][v];
  }
  shift_jacobian<T, NV>(Jv_B, offset_W, Jw_B, zero, Jv);
}

// _soa_support_points: the KQ witnesses of a convex geometry for a support
// direction (in its frame): a box's or polygon's top vertices by support
// value, through soa.sort_with_payload's insertion network (whose tie order
// picks the witnesses); a sphere's point along the direction. vertex[c] is
// the vertex witness c came from (the adjoint routes its cotangent there).
template <typename T, typename Z>
__device__ void support_points(const GeomDesc& g, const T* p,
                               const T (&dir)[3], T (&w)[Z::KQ][3],
                               int (&vertex)[Z::KQ]) {
  using B = base_t<T>;
  constexpr int NVERT = Z::NVERT;
  if (g.kind == kGeomSphere) {
    const T radius = p[g.shape_index];
#pragma unroll
    for (int c = 0; c < Z::KQ; ++c) {
#pragma unroll
      for (int i = 0; i < 3; ++i) w[c][i] = dir[i] * radius;
      vertex[c] = 0;
    }
    return;
  }
  T key[NVERT], pay[3][NVERT];
  int index[NVERT];
  const int n = g.kind == kGeomBox ? kBoxVertices : g.n_vertices;
#pragma unroll
  for (int m = 0; m < NVERT; ++m) {
    T vert[3];
    if (g.kind == kGeomBox) {
      // _UNIT_BOX_VERTICES: signs (x, y, z) counting in binary, - before +.
#pragma unroll
      for (int i = 0; i < 3; ++i)
        vert[i] = B((m >> (2 - i)) & 1 ? 1 : -1) * p[g.shape_index + i];
    } else {
#pragma unroll
      for (int i = 0; i < 3; ++i)
        vert[i] = m < n ? p[g.shape_index + 3 * m + i] : T(B(0));
    }
    key[m] = vert[0] * dir[0] + vert[1] * dir[1] + vert[2] * dir[2];
    index[m] = m;
#pragma unroll
    for (int i = 0; i < 3; ++i) pay[i][m] = vert[i];
  }
#pragma unroll
  for (int i = 1; i < NVERT; ++i)
    if (i < n) {
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
    }
#pragma unroll
  for (int c = 0; c < Z::KQ; ++c) {
    vertex[c] = index[c];
#pragma unroll
    for (int i = 0; i < 3; ++i) w[c][i] = pay[i][c];
  }
}

// ---------------------------------------------------------------------------
// Everything soa_loss_parts returns: mass matrix, cone-major contact
// Jacobian [J_n; mu J_t], signed distances, the QP's linear term and the
// velocity residual. Then what the adjoint (model_adjoint.cuh) keeps from
// the forward sweep; the forward kernels leave it unread.
template <typename T, typename Z> struct ModelParts {
  T M[Z::NV][Z::NV];
  T J[3][Z::NV][Z::K];
  T phi[Z::K];
  T qc[3][Z::K];
  T dv[Z::NV];
  Ldlt<T, Z::NV> F_M;  // M = L D L'
  T a_nc[Z::NV];       // contact-free acceleration M^-1 F
  T slide[3][Z::K];    // j_vp[1], j_vp[2], sliding speed (0 at rest)
};

// One plane-convex pair of soa_contact_terms up to its Jacobian rows: both
// geometries' world frames (A the plane, B the convex), B's pose in A, the
// witnesses (in B's frame, with their vertices) and the pair's friction.
template <typename T, typename Z> struct PairTerms {
  T R_WA[3][3], p_WA[3], Jw_A[3][Z::NV], Jv_A[3][Z::NV];
  T R_WB[3][3], p_WB[3], Jw_B[3][Z::NV], Jv_B[3][Z::NV];
  T R_AB[3][3], d[3], p_AoBo_A[3];
  T wit[Z::KQ][3];
  int vertex[Z::KQ];
  T mu_a, mu_b, mu_pair;
};

template <typename T, typename Z>
__device__ __forceinline__ void pair_terms(const ModelDesc<Z>& desc,
                                           const T* p,
                                           const Frame<T, Z::NV> (&F)[Z::NB],
                                           int pp, PairTerms<T, Z>& t) {
  using B = base_t<T>;
  geometry_frame<T, Z>(desc.plane[pp], F, t.R_WA, t.p_WA, t.Jw_A, t.Jv_A);
  geometry_frame<T, Z>(desc.convex[pp], F, t.R_WB, t.p_WB, t.Jw_B, t.Jv_B);
  mtm3(t.R_WA, t.R_WB, t.R_AB);
#pragma unroll
  for (int i = 0; i < 3; ++i) t.d[i] = t.p_WB[i] - t.p_WA[i];
  mtv3(t.R_WA, t.d, t.p_AoBo_A);
  // Support direction on B: -z axis of A, in B coordinates.
  const T dir[3] = {-t.R_AB[2][0], -t.R_AB[2][1], -t.R_AB[2][2]};
  support_points<T, Z>(desc.convex[pp], p, dir, t.wit, t.vertex);
  t.mu_a = p[desc.plane[pp].mu_index];
  t.mu_b = p[desc.convex[pp].mu_index];
  t.mu_pair = (B(2) * t.mu_a * t.mu_b) / (t.mu_a + t.mu_b);
}

// Witness c of a pair: its point in A's frame (w_A, phi = w_A[2]), and the
// world-frame offsets of its projection on the plane from A's origin
// (off_A) and of the witness from B's origin (off_B).
template <typename T, typename Z>
__device__ __forceinline__ void witness_offsets(const PairTerms<T, Z>& t,
                                                int c, T (&w_A)[3],
                                                T (&off_A)[3],
                                                T (&off_B)[3]) {
  using B = base_t<T>;
  T pa[3];
  mv3(t.R_AB, t.wit[c], w_A);
#pragma unroll
  for (int i = 0; i < 3; ++i) w_A[i] = w_A[i] + t.p_AoBo_A[i];
  pa[0] = w_A[0];
  pa[1] = w_A[1];
  pa[2] = T(B(0));
  mv3(t.R_WA, pa, off_A);
  mv3(t.R_WB, t.wit[c], off_B);
}

// soa_contact_terms: each pair's witnesses, signed distances and Jacobian
// rows, pair-major.
template <typename T, typename Z>
__device__ void contact_terms(const ModelDesc<Z>& desc,
                              const T* p,
                              const Frame<T, Z::NV> (&F)[Z::NB],
                              T (&J)[3][Z::NV][Z::K], T (&phi)[Z::K]) {
  constexpr int NV = Z::NV;
#pragma unroll
  for (int pp = 0; pp < Z::NPAIR; ++pp) {
    PairTerms<T, Z> t;
    pair_terms<T, Z>(desc, p, F, pp, t);
#pragma unroll
    for (int c = 0; c < Z::KQ; ++c) {
      if (c >= Z::kq(pp)) continue;
      const int k = Z::first(pp) + c;
      T w_A[3], off_A[3], off_B[3];
      witness_offsets<T, Z>(t, c, w_A, off_A, off_B);
      phi[k] = w_A[2];
      // J_rel = (J_Bc - J_Ac), J_*c = Jv - skew(off) Jw; rows [t_x, t_y,
      // n] in the plane's axes.
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const T sB0 = off_B[1] * t.Jw_B[2][v] - off_B[2] * t.Jw_B[1][v];
        const T sB1 = off_B[2] * t.Jw_B[0][v] - off_B[0] * t.Jw_B[2][v];
        const T sB2 = off_B[0] * t.Jw_B[1][v] - off_B[1] * t.Jw_B[0][v];
        const T sA0 = off_A[1] * t.Jw_A[2][v] - off_A[2] * t.Jw_A[1][v];
        const T sA1 = off_A[2] * t.Jw_A[0][v] - off_A[0] * t.Jw_A[2][v];
        const T sA2 = off_A[0] * t.Jw_A[1][v] - off_A[1] * t.Jw_A[0][v];
        const T rel[3] = {(t.Jv_B[0][v] - t.Jv_A[0][v]) - sB0 + sA0,
                          (t.Jv_B[1][v] - t.Jv_A[1][v]) - sB1 + sA1,
                          (t.Jv_B[2][v] - t.Jv_A[2][v]) - sB2 + sA2};
        const T t_x = t.R_WA[0][0] * rel[0] + t.R_WA[1][0] * rel[1] +
                      t.R_WA[2][0] * rel[2];
        const T t_y = t.R_WA[0][1] * rel[0] + t.R_WA[1][1] * rel[1] +
                      t.R_WA[2][1] * rel[2];
        const T n_r = t.R_WA[0][2] * rel[0] + t.R_WA[1][2] * rel[1] +
                      t.R_WA[2][2] * rel[2];
        J[0][v][k] = n_r;
        J[1][v][k] = t.mu_pair * t_x;
        J[2][v][k] = t.mu_pair * t_y;
      }
    }
  }
}

// One body's share of soa_lagrangian_terms before it enters M and F: its
// inertial parameters, its frame's values and rates along qdot, the
// centre of mass offset c_W = R c_B and its Jacobian J_cm and their rates,
// the angular velocity omega = Jw v, the biases Jw_dot v and J_cm_dot v,
// the world inertia I_W = R I_B R', its momentum I_W omega and the torque
// bias I_W Jw_dot v + omega x I_W omega.
template <typename T, typename Z> struct BodyTerms {
  T mass, c_B[3], I_B[3][3];
  T R[3][3], Rd[3][3];
  T Jw[3][Z::NV], Jwd[3][Z::NV], Jv[3][Z::NV], Jvd[3][Z::NV];
  T c_W[3], c_W_dot[3], J_cm[3][Z::NV], J_cm_dot[3][Z::NV];
  T omega[3], omega_dot_bias[3], a_cm_bias[3];
  T I_W[3][3], I_omega[3], torque_bias[3];
};

template <typename T, typename Z>
__device__ __forceinline__ void body_terms(const T* p,
                                           const Frame<T, Z::NV>& f, int b,
                                           const T (&v)[Z::NV],
                                           BodyTerms<T, Z>& o) {
  using B = base_t<T>;
  constexpr int NV = Z::NV;
  const T zero = T(B(0));
  o.mass = p[10 * b];
#pragma unroll
  for (int i = 0; i < 3; ++i) o.c_B[i] = p[10 * b + 1 + i] / o.mass;
  const int inertia[3][3] = {{4, 7, 8}, {7, 5, 9}, {8, 9, 6}};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) o.I_B[i][j] = p[10 * b + inertia[i][j]];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      o.R[i][j] = f.R[i][j].v;
      o.Rd[i][j] = f.R[i][j].d;
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      o.Jw[i][j] = f.Jw[i][j].v;
      o.Jwd[i][j] = f.Jw[i][j].d;
      o.Jv[i][j] = f.Jv[i][j].v;
      o.Jvd[i][j] = f.Jv[i][j].d;
    }
  }
  mv3(o.R, o.c_B, o.c_W);
  mv3(o.Rd, o.c_B, o.c_W_dot);
  shift_jacobian<T, NV>(o.Jv, o.c_W, o.Jw, zero, o.J_cm);
  {
    T A[3][NV], SJ[3][3], CJ[3][NV];
    shift_jacobian<T, NV>(o.Jvd, o.c_W_dot, o.Jw, zero, A);
    skew(o.c_W, zero, SJ);
    mm3n<T, NV>(SJ, o.Jwd, CJ);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < NV; ++j) o.J_cm_dot[i][j] = A[i][j] - CJ[i][j];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o.omega[i] = dotn<T, NV>(o.Jw[i], v);
    o.omega_dot_bias[i] = dotn<T, NV>(o.Jwd[i], v);
    o.a_cm_bias[i] = dotn<T, NV>(o.J_cm_dot[i], v);
  }
  // I_cm_W = (R I_B) R'.
  T RI[3][3];
  mm3(o.R, o.I_B, RI);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      o.I_W[i][j] = RI[i][0] * o.R[j][0] + RI[i][1] * o.R[j][1] +
                    RI[i][2] * o.R[j][2];
  mv3(o.I_W, o.omega, o.I_omega);
  mv3(o.I_W, o.omega_dot_bias, o.torque_bias);
  o.torque_bias[0] = o.torque_bias[0] + (o.omega[1] * o.I_omega[2] -
                                         o.omega[2] * o.I_omega[1]);
  o.torque_bias[1] = o.torque_bias[1] + (o.omega[2] * o.I_omega[0] -
                                         o.omega[0] * o.I_omega[2]);
  o.torque_bias[2] = o.torque_bias[2] + (o.omega[0] * o.I_omega[1] -
                                         o.omega[1] * o.I_omega[0]);
}

// soa_lagrangian_terms: mass matrix M and force F (gravity, the
// Coriolis and centrifugal bias, actuation).
template <typename T, typename Z>
__device__ void lagrangian_terms(const ModelDesc<Z>& desc,
                                 const T* p,
                                 const Frame<T, Z::NV> (&F)[Z::NB],
                                 const T (&v)[Z::NV], const T (&u)[Z::NU],
                                 T (&M)[Z::NV][Z::NV], T (&Fo)[Z::NV]) {
  using B = base_t<T>;
  constexpr int NV = Z::NV;
  const T zero = T(B(0));
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    Fo[i] = zero;
#pragma unroll
    for (int j = 0; j < NV; ++j) M[i][j] = zero;
  }
  const T g_W[3] = {zero, zero, T(B(-kGravity))};
#pragma unroll
  for (int b = 0; b < Z::NB; ++b) {
    BodyTerms<T, Z> o;
    body_terms<T, Z>(p, F[b], b, v, o);
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        T acc = M[i][j];
#pragma unroll
        for (int a = 0; a < 3; ++a)
          acc = acc + o.mass * o.J_cm[a][i] * o.J_cm[a][j];
#pragma unroll
        for (int x = 0; x < 3; ++x)
#pragma unroll
          for (int y = 0; y < 3; ++y)
            acc = acc + o.Jw[x][i] * o.I_W[x][y] * o.Jw[y][j];
        M[i][j] = acc;
      }
    T force_bias[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) force_bias[a] = o.mass * o.a_cm_bias[a];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      T cor = zero, grav = zero;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        cor = cor + o.Jw[a][i] * o.torque_bias[a] +
              o.J_cm[a][i] * force_bias[a];
        grav = grav + o.J_cm[a][i] * o.mass * g_W[a];
      }
      Fo[i] = Fo[i] + grav - cor;
    }
  }
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = i + 1; j < NV; ++j) M[i][j] = M[j][i];
#pragma unroll
  for (int b = 0; b < Z::NB; ++b) {
    const auto& bd = body_desc<Z>(desc, b);
    if (bd.u_index >= 0) {
      const T ub = pick<Z::NU>(u, bd.u_index);
#pragma unroll
      for (int i = 0; i < NV; ++i)
        if (i == bd.v_off) Fo[i] = Fo[i] + ub;
    }
  }
}

// The body frames of soa_loss_parts at the observed next state (q, vp):
// soa_configuration_rate, then soa_body_kinematics with its JVP along qdot.
template <typename T, typename Z>
__device__ __forceinline__ void model_frames(const ModelDesc<Z>& desc,
                                             const T (&q)[Z::NQ],
                                             const T (&vp)[Z::NV],
                                             Frame<T, Z::NV> (&F)[Z::NB]) {
  T qdot[Z::NQ];
  configuration_rate<T, Z>(desc, q, vp, qdot);
  Dual<T> qd[Z::NQ];
#pragma unroll
  for (int i = 0; i < Z::NQ; ++i) qd[i] = Dual<T>(q[i], qdot[i]);
  body_kinematics<T, Z>(desc, qd, F);
}

// soa_loss_parts from the body frames F at (q, vp): the multibody terms,
// then the ContactNets QP pieces; v is the current state's velocity and u
// its actuation.
template <typename T, typename Z>
__device__ void model_loss_parts(const ModelDesc<Z>& desc, const T* p,
                                 const T (&v)[Z::NV], const T (&u)[Z::NU],
                                 const T (&vp)[Z::NV],
                                 const Frame<T, Z::NV> (&F)[Z::NB],
                                 base_t<T> dt, ModelParts<T, Z>& out) {
  using B = base_t<T>;
  constexpr int NV = Z::NV, K = Z::K;
  T Fo[NV];
  lagrangian_terms<T, Z>(desc, p, F, vp, u, out.M, Fo);
  contact_terms<T, Z>(desc, p, F, out.J, out.phi);
  ldlt<T, NV>(out.M, out.F_M);
  ldlt_solve<T, NV>(out.F_M, Fo, out.a_nc);
#pragma unroll
  for (int i = 0; i < NV; ++i)
    out.dv[i] = vp[i] - (v[i] + out.a_nc[i] * dt);
  T j_dv[3][K], j_vp[3][K];
  j_dot<T, NV, K>(out.J, out.dv, j_dv);
  j_dot<T, NV, K>(out.J, vp, j_vp);
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const T s1 = j_vp[1][c], s2 = j_vp[2][c];
    const T sliding_sq = s1 * s1 + s2 * s2;
    // Safe norm at exactly resting contacts: value 0, derivative 0.
    const bool at_rest = sliding_sq < B(1e-24);
    const T speed = sqrt(at_rest ? T(B(1)) : sliding_sq);
    const T sliding_speed = at_rest ? T(B(0)) : speed;
    out.slide[0][c] = s1;
    out.slide[1][c] = s2;
    out.slide[2][c] = sliding_speed;
    out.qc[0][c] = -j_dv[0][c] + fabs(out.phi[c]) + dt * sliding_speed;
    out.qc[1][c] = -j_dv[1][c] + dt * s1;
    out.qc[2][c] = -j_dv[2][c] + dt * s2;
  }
}

// soa_loss_assemble: the loss at a given (detached) impulse,
// 0.5 f'(D + eps I) f + f'q + 0.5 dv'M dv + sum max(-phi, 0)^2, with f'D f
// computed as (J'f)' M^-1 (J'f); 0 for a failed solve. J, qc, phi and f are
// the lane's contacts (all K at L = 1); the sums over contacts are one
// exchange of NV + 3 rows.
template <typename T, int NV, int K, typename G = Solo>
__device__ T model_loss_assemble(const T (&M)[NV][NV], const T (&dv)[NV],
                                 const T (&J)[3][NV][K], const T (&qc)[3][K],
                                 const T (&phi)[K], const T (&f)[3][K],
                                 bool valid, T eps, const G& g = G()) {
  using B = base_t<T>;
  // Rows: (J'f)_j, then |f|^2, f'q and max(-phi, 0)^2 per contact.
  T sums[NV + 3];
  sum_rows<T, NV + 3, K, G>(
      g,
      [&](int n, int c) -> T {
        if (n < NV)
          return J[0][n][c] * f[0][c] + J[1][n][c] * f[1][c] +
                 J[2][n][c] * f[2][c];
        if (n == NV)
          return f[0][c] * f[0][c] + f[1][c] * f[1][c] + f[2][c] * f[2][c];
        if (n == NV + 1)
          return f[0][c] * qc[0][c] + f[1][c] * qc[1][c] +
                 f[2][c] * qc[2][c];
        const T neg = -phi[c];
        const T pen = neg < B(0) ? T(B(0)) : neg;  // clamp_min(-phi, 0)
        return pen * pen;
      },
      sums);
  T jtf[NV], minv_jtf[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) jtf[j] = sums[j];
  {
    Ldlt<T, NV> F_M;
    ldlt<T, NV>(M, F_M);
    ldlt_solve<T, NV>(F_M, jtf, minv_jtf);
  }
  const T quad = dotn<T, NV>(jtf, minv_jtf) + eps * sums[NV];
  T M_dv[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) M_dv[i] = dotn<T, NV>(M[i], dv);
  const T constant = B(0.5) * dotn<T, NV>(dv, M_dv) + sums[NV + 2];
  const T loss = B(0.5) * quad + sums[NV + 1] + constant;
  return valid ? loss : T(B(0));
}

// ---------------------------------------------------------------------------
// Per-sample bodies of the kernels. Inputs are one column of the
// batch-minor tensors: p the derived scalars (uniform over the batch), xin
// the current state and its actuation rows (only the velocity and the
// actuation enter), xp the observed next state.
template <typename S, typename Z>
__device__ __forceinline__ void model_parts_at(const ModelDesc<Z>& desc,
                                               const S* p,
                                               const S (&xin)[Z::NX + Z::NU],
                                               const S (&xp)[Z::NX], S dt,
                                               ModelParts<S, Z>& lp) {
  S v[Z::NV], u[Z::NU], q[Z::NQ], vp[Z::NV];
#pragma unroll
  for (int i = 0; i < Z::NV; ++i) {
    v[i] = xin[Z::NQ + i];
    vp[i] = xp[Z::NQ + i];
  }
#pragma unroll
  for (int i = 0; i < Z::NU; ++i) u[i] = xin[Z::NX + i];
#pragma unroll
  for (int i = 0; i < Z::NQ; ++i) q[i] = xp[i];
  Frame<S, Z::NV> F[Z::NB];
  model_frames<S, Z>(desc, q, vp, F);
  model_loss_parts<S, Z>(desc, p, v, u, vp, F, dt, lp);
}

// Lanes a sample in the card's K1 and K3 at a size: two contacts a lane
// (the elbow's k = 8 on 4 lanes); one thread a sample at k = 4, where the
// lanes' repeated whole-sample work costs more than the one thread's
// spills, and wherever two contacts a lane do not make a group that
// divides a warp (odd k; k / 2 not a power of two). At the box and sphere
// body's k = 5, one contact a lane (five lanes, six groups a warp) took
// float32 K1 and K3 from 23 and 19 ms to 49 and 38, and the terms on a
// kernel of their own before the solve on one thread a sample took K3 to
// 18.6-18.8 ms in float32 but from 65 to 71 in float64 (PERF.md §6).
template <typename Z>
constexpr int kFwdLanes =
    Z::K > 4 && Z::K % 2 == 0 && 32 % (Z::K / 2) == 0 ? Z::K / 2 : 1;

// Whether K1's cold solve leaves its IPM and SAP-Newton loops at their
// exact fixed points (hybrid_solve.cuh's exits: the same bits), a warp
// together on the card: at the sizes of kConstFreeBody (at the box and
// sphere body's size they took float32 K1 from 28.1 to 22.8-23.1 ms; the
// warm solve's exits gained K3 nothing there).
template <typename Z> constexpr bool kFwdColdExits = kConstFreeBody<Z>;

// What the solve and the assembly of a sample need, on one lane of its
// group: the problem with the lane's contacts' columns (M whole), dv, and
// the lane's contacts' phi.
template <typename S, typename Z, typename G>
struct LaneParts {
  static constexpr int KL = Z::K / G::kLanes;
  static_assert(KL * G::kLanes == Z::K, "whole contacts a lane");
  Problem<S, Z::NV, KL> P;
  S dv[Z::NV];
  S phi[KL];
};

// The terms of one sample as one thread hands them to the solve, on its
// own lanes or on one thread: M, J, qc, phi and dv, value v of the sample
// at pack[v * stride].
template <typename Z>
constexpr int kPackValues =
    Z::NV * Z::NV + 3 * Z::NV * Z::K + 4 * Z::K + Z::NV;

template <typename S, typename Z>
__device__ __forceinline__ void pack_problem(const ModelParts<S, Z>& lp,
                                             S* pack, long long stride) {
  constexpr int NV = Z::NV, K = Z::K, J0 = NV * NV, Q0 = J0 + 3 * NV * K,
                PHI0 = Q0 + 3 * K, DV0 = PHI0 + K;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    pack[(DV0 + i) * stride] = lp.dv[i];
#pragma unroll
    for (int j = 0; j < NV; ++j) pack[(i * NV + j) * stride] = lp.M[i][j];
  }
#pragma unroll
  for (int c = 0; c < K; ++c) {
    pack[(PHI0 + c) * stride] = lp.phi[c];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pack[(Q0 + i * K + c) * stride] = lp.qc[i][c];
#pragma unroll
      for (int j = 0; j < NV; ++j)
        pack[(J0 + (i * NV + j) * K + c) * stride] = lp.J[i][j][c];
    }
  }
}

// A lane's parts from its sample's pack: contacts lane * KL ... .
template <typename S, typename Z, typename G>
__device__ __forceinline__ void unpack_problem(const S* pack,
                                               long long stride, double eps,
                                               const G& g,
                                               LaneParts<S, Z, G>& out) {
  constexpr int NV = Z::NV, K = Z::K, J0 = NV * NV, Q0 = J0 + 3 * NV * K,
                PHI0 = Q0 + 3 * K, DV0 = PHI0 + K;
  constexpr int KL = LaneParts<S, Z, G>::KL;
  const int c0 = g.lane() * KL;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    out.dv[i] = pack[(DV0 + i) * stride];
#pragma unroll
    for (int j = 0; j < NV; ++j) out.P.M[i][j] = pack[(i * NV + j) * stride];
  }
#pragma unroll
  for (int c = 0; c < KL; ++c) {
    out.phi[c] = pack[(PHI0 + c0 + c) * stride];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      out.P.q[i][c] = pack[(Q0 + i * K + c0 + c) * stride];
#pragma unroll
      for (int j = 0; j < NV; ++j)
        out.P.J[i][j][c] = pack[(J0 + (i * NV + j) * K + c0 + c) * stride];
    }
  }
  out.P.eps = S(eps);
  out.P.inv_eps = S(1.0 / eps);
  out.P.half_eps = S(0.5 * eps);
}

// The cold hybrid solve and the loss on a sample's lanes. Writes the
// impulse of the lane's contacts; returns the loss and sets valid (both
// alike on every lane).
template <typename S, typename Z, typename G>
__device__ S lane_loss_cold(const LaneParts<S, Z, G>& lane, double eps,
                            int ipm_iterations, int newton_iterations,
                            S (&force)[3][Z::K / G::kLanes], bool& valid,
                            const G& g) {
  constexpr int KL = Z::K / G::kLanes;
  valid = cold_hybrid_solve<S, Z::NV, KL, G, kFwdColdExits<Z>>(
      lane.P, ipm_iterations, newton_iterations, force, g);
  return model_loss_assemble<S, Z::NV, KL, G>(lane.P.M, lane.dv, lane.P.J,
                                              lane.P.q, lane.phi, force,
                                              valid, S(eps), g);
}

// As lane_loss_cold, with the warm solve from w = M^-1 J^T f_prev at the
// current parameters (f_prev: the lane's contacts').
template <typename S, typename Z, typename G>
__device__ S lane_loss_warm(const LaneParts<S, Z, G>& lane,
                            const S (&f_prev)[3][Z::K / G::kLanes],
                            double eps, int ipm_iterations,
                            int newton_iterations,
                            S (&force)[3][Z::K / G::kLanes], bool& valid,
                            const G& g) {
  constexpr int KL = Z::K / G::kLanes;
  S w[Z::NV];
  minv_jt<S, Z::NV, KL, G>(lane.P, f_prev, w, g);
  valid = warm_hybrid_solve<S, Z::NV, KL, G>(lane.P, ipm_iterations,
                                             newton_iterations, w, force, g);
  return model_loss_assemble<S, Z::NV, KL, G>(lane.P.M, lane.dv, lane.P.J,
                                              lane.P.q, lane.phi, force,
                                              valid, S(eps), g);
}

// The terms of one sample, handed to its solve on the same thread.
template <typename S, typename Z, typename G = Solo>
__device__ __forceinline__ void model_parts_one(
    const ModelDesc<Z>& desc, const S* p, const S (&xin)[Z::NX + Z::NU],
    const S (&xp)[Z::NX], S dt, double eps, LaneParts<S, Z, G>& out) {
  S pack[kPackValues<Z>];
  {
    ModelParts<S, Z> lp;
    model_parts_at<S, Z>(desc, p, xin, xp, dt, lp);
    pack_problem<S, Z>(lp, pack, 1);
  }
  unpack_problem<S, Z, G>(pack, 1, eps, G(), out);
}

// K1's body on one thread (G: Solo, or on the card WarpSolo, whose warp
// leaves the solve's loops together): terms, the cold hybrid solve, the
// loss. Writes the impulse; returns the loss and sets valid. The actuation
// rows of xin past n_u are never read by the terms (no body's u_index
// reaches them).
template <typename S, typename Z, typename G = Solo>
__device__ S model_loss_cold(const ModelDesc<Z>& desc, const S* p,
                             const S (&xin)[Z::NX + Z::NU],
                             const S (&xp)[Z::NX], S dt, double eps,
                             int ipm_iterations, int newton_iterations,
                             S (&force)[3][Z::K], bool& valid) {
  LaneParts<S, Z, G> lane;
  model_parts_one<S, Z, G>(desc, p, xin, xp, dt, eps, lane);
  return lane_loss_cold<S, Z, G>(lane, eps, ipm_iterations,
                                 newton_iterations, force, valid, G());
}

// K3's body on one thread: as K1, warm-started from f_prev.
template <typename S, typename Z>
__device__ S model_loss_warm(const ModelDesc<Z>& desc, const S* p,
                             const S (&xin)[Z::NX + Z::NU],
                             const S (&xp)[Z::NX],
                             const S (&f_prev)[3][Z::K], S dt, double eps,
                             int ipm_iterations, int newton_iterations,
                             S (&force)[3][Z::K], bool& valid) {
  LaneParts<S, Z, Solo> lane;
  model_parts_one<S, Z>(desc, p, xin, xp, dt, eps, lane);
  return lane_loss_warm<S, Z, Solo>(lane, f_prev, eps, ipm_iterations,
                                    newton_iterations, force, valid, Solo());
}

}  // namespace
