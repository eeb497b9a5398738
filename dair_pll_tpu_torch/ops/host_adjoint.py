r"""Host builds of the loss backward kernel K2's per-sample bodies, compiled
with ``g++``: the box cube's ``cube_loss_vjp`` (``csrc/cube_adjoint.cuh``,
:class:`HostAdjoint`) and the generic ``model_loss_vjp``
(``csrc/model_adjoint.cuh``, with the generic forward bodies,
:class:`HostModelTerms`). Each gives the gradient in float64 (held against
the plain version by the tests) and a count of the arithmetic the sweep
needs (K2's bound in ``chip_smoke.py``). :class:`HostModelTerms` also
counts the forward bodies (the generic and the box cube's K1 and K3 bounds)
and K5's body at the cube's (6, 4) and the elbow's (7, 8) (its bounds),
and runs that body on lanes as the card does.

A stand-in ``cuda_runtime.h`` turns the CUDA qualifiers into plain C++, so
the device code compiles unchanged. The count runs the same code on
``Counted<float>`` or ``Counted<double>``, a scalar that does the
arithmetic of its base type (so every branch goes as on the card) and
tallies each operation whose operands are not all constants of the code.
It keeps two tallies:

- ``needed``: the additions, subtractions, products, quotients and square
  roots the function needs. An operation with a structural zero or one of
  the code (a constant 0, 1 or -1, or a product with one) is free there:
  the forward sweep's dense algebra over ``Jw = [R | 0]`` and ``Jv = [0 |
  I]`` counts only its nonzero work. This is the count K2's bound uses.
- ``executed``: every such operation with an operand from the data, the
  structural ones included, as the kernel runs them (IEEE arithmetic
  keeps ``x * 0`` and ``0 - x``; a compiler may still fold ``x * 1`` and
  ``x - 0``).

The generic sweep recomputes some forward terms rather than keep them
(``Recompute`` in ``model_adjoint.cuh``): that work is executed but not
needed, and ``HostModelTerms.count`` reports its needed operations apart
as ``recomputed``.

Negations and absolute values are free (operand modifiers on the card);
comparisons and selects are not counted; a quotient or a square root
counts one, so the count is a floor on the card's instructions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from dair_pll_tpu_torch.ops import soa_kernels

#: Stand-in for ``cuda_runtime.h``: the device code as plain C++.
SHIM = r"""#pragma once
#include <cmath>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline double rsqrt(double x) { return 1.0 / std::sqrt(x); }
using std::isfinite, std::isinf, std::isnan, std::sqrt, std::fabs, std::sin,
    std::cos, std::signbit;
"""

#: The counting scalar. ``constant`` marks a constant of the code (built
#: from a literal, or a product with a structural zero), as opposed to a
#: value of the data.
COUNTED = r"""#pragma once
#include <cmath>
#include <type_traits>

struct Tally {
  long long needed = 0, executed = 0, recomputed = 0;
  // Iterations of the cold solve's IPM and SAP-Newton loops that repeat the
  // one before (hybrid_solve.cuh's exits; counted where the exits are on).
  long long ipm_fixed = 0, newton_fixed = 0;
};
// One tally per thread; initial-exec keeps its address a register read.
static thread_local Tally tally __attribute__((tls_model("initial-exec")));
#define HYBRID_SOLVE_EXIT_HOOK(loop, fixed) \
  ((loop) == 0 ? (tally.ipm_fixed += (fixed)) \
               : (tally.newton_fixed += (fixed)))

template <typename B> struct Counted {
  B v;
  bool constant;
  Counted() = default;
  template <typename C,
            typename = std::enable_if_t<std::is_arithmetic_v<C>>>
  Counted(C c) : v(B(c)), constant(true) {}
  static Counted data(B x) {
    Counted r;
    r.v = x;
    r.constant = false;
    return r;
  }

  bool is(B c) const { return constant && v == c; }
  bool unit() const { return is(B(1)) || is(B(-1)); }
  // The result of one operation: counted unless both operands are
  // constants; needed unless `structural`.
  static Counted op(B v, const Counted& a, const Counted& b,
                    bool structural, bool constant_result) {
    if (!(a.constant && b.constant)) {
      ++tally.executed;
      if (!structural) ++tally.needed;
    }
    Counted r;
    r.v = v;
    r.constant = constant_result || (a.constant && b.constant);
    return r;
  }

  friend Counted operator+(const Counted& a, const Counted& b) {
    return op(a.v + b.v, a, b, a.is(B(0)) || b.is(B(0)), false);
  }
  friend Counted operator-(const Counted& a, const Counted& b) {
    return op(a.v - b.v, a, b, a.is(B(0)) || b.is(B(0)), false);
  }
  friend Counted operator*(const Counted& a, const Counted& b) {
    const bool zero = a.is(B(0)) || b.is(B(0));
    return op(a.v * b.v, a, b, zero || a.unit() || b.unit(), zero);
  }
  friend Counted operator/(const Counted& a, const Counted& b) {
    return op(a.v / b.v, a, b, a.is(B(0)) || b.unit(), a.is(B(0)));
  }
  friend Counted operator-(const Counted& a) {
    Counted r = a;
    r.v = -a.v;
    return r;
  }
  friend Counted sqrt(const Counted& a) {
    return op(std::sqrt(a.v), a, a, false, false);
  }
  friend Counted fabs(const Counted& a) {
    Counted r = a;
    r.v = std::fabs(a.v);
    return r;
  }
  // A sine or cosine counts one, as a square root does.
  friend Counted sin(const Counted& a) {
    return op(std::sin(a.v), a, a, false, false);
  }
  friend Counted cos(const Counted& a) {
    return op(std::cos(a.v), a, a, false, false);
  }
  friend bool isnan(const Counted& a) { return std::isnan(a.v); }
  friend bool isinf(const Counted& a) { return std::isinf(a.v); }
  friend bool isfinite(const Counted& a) { return std::isfinite(a.v); }
  friend bool signbit(const Counted& a) { return std::signbit(a.v); }
  friend bool operator<(const Counted& a, const Counted& b) {
    return a.v < b.v;
  }
  friend bool operator>(const Counted& a, const Counted& b) {
    return a.v > b.v;
  }
  friend bool operator<=(const Counted& a, const Counted& b) {
    return a.v <= b.v;
  }
  friend bool operator>=(const Counted& a, const Counted& b) {
    return a.v >= b.v;
  }
  friend bool operator==(const Counted& a, const Counted& b) {
    return a.v == b.v;
  }
  friend bool operator!=(const Counted& a, const Counted& b) {
    return a.v != b.v;
  }
};
"""

#: The box cube's K2 body over batch-minor inputs (``cube_adjoint.cuh``):
#: ``sweep`` for any scalar, and the float64 gradient ``cube_loss_vjp_f64``
#: (``dp`` per sample ``(B, 15)``). Both host builds carry it.
CUBE_SWEEP = r"""
// A value of the data in the scalar type S, and back.
template <typename S, typename B> static S data(B x) { return S::data(x); }
template <> double data<double, double>(double x) { return x; }
template <typename B> static B value(const Counted<B>& x) { return x.v; }
static double value(double x) { return x; }

// cube_loss_vjp<S> over the samples [lo, hi) of n batch-minor ones; with
// dp non-null, writes dp (n, 15), dxin and dxp (13, n).
template <typename S, typename B>
static void sweep(const B* pvec, const B* xin, const B* xp, const B* force,
                  const unsigned char* valid, const B* ct, long long n,
                  long long lo, long long hi, double dt, B* dp, B* dxin,
                  B* dxp) {
  S p[kCubeP];
  for (int i = 0; i < kCubeP; ++i) p[i] = data<S>(pvec[i]);
  for (long long b = lo; b < hi; ++b) {
    S x[kCubeNX], x_plus[kCubeNX], f[3][kCubeK];
    S g_p[kCubeP], g_v[kCubeNV], g_xp[kCubeNX];
    for (int i = 0; i < kCubeNX; ++i) {
      x[i] = data<S>(xin[i * n + b]);
      x_plus[i] = data<S>(xp[i * n + b]);
    }
    for (int i = 0; i < 3; ++i)
      for (int c = 0; c < kCubeK; ++c)
        f[i][c] = data<S>(force[(i * kCubeK + c) * n + b]);
    cube_loss_vjp<S>(p, x, x_plus, f, valid[b] != 0, data<S>(ct[b]),
                     data<S>(B(dt)), g_p, g_v, g_xp);
    if (dp == nullptr) continue;
    for (int i = 0; i < kCubeP; ++i) dp[b * kCubeP + i] = value(g_p[i]);
    for (int i = 0; i < kCubeNQ; ++i) dxin[i * n + b] = B(0);
    for (int i = 0; i < kCubeNV; ++i)
      dxin[(kCubeNQ + i) * n + b] = value(g_v[i]);
    for (int i = 0; i < kCubeNX; ++i) dxp[i * n + b] = value(g_xp[i]);
  }
}

// cube_loss_vjp<double>, as K2's float64 kernel runs it.
extern "C" void cube_loss_vjp_f64(const double* pvec, const double* xin,
                                  const double* xp, const double* force,
                                  const unsigned char* valid,
                                  const double* ct, long long n, double dt,
                                  double* dp, double* dxin, double* dxp) {
  sweep<double, double>(pvec, xin, xp, force, valid, ct, n, 0, n, dt, dp,
                        dxin, dxp);
}
"""

#: Batch entry points over batch-minor inputs: the float64 gradient
#: (``CUBE_SWEEP``) and the counts.
BATCH = r"""#include <thread>
#include <vector>

#include "counted.h"
#include "cube_adjoint.cuh"
""" + CUBE_SWEEP + r"""
// The counts of cube_loss_vjp<Counted<B>> over n samples, on `threads`
// threads; counts = {needed, executed}. With dp non-null (one thread) it
// also writes the gradients, as cube_loss_vjp_f64 does.
template <typename B>
static void count(const B* pvec, const B* xin, const B* xp, const B* force,
                  const unsigned char* valid, const B* ct, long long n,
                  double dt, int threads, long long* counts, B* dp, B* dxin,
                  B* dxp) {
  std::vector<std::thread> pool;
  std::vector<Tally> tallies(threads);
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([=, &tallies] {
      tally = Tally();
      sweep<Counted<B>, B>(pvec, xin, xp, force, valid, ct, n,
                           n * t / threads, n * (t + 1) / threads, dt, dp,
                           dxin, dxp);
      tallies[t] = tally;
    });
  counts[0] = counts[1] = 0;
  for (int t = 0; t < threads; ++t) {
    pool[t].join();
    counts[0] += tallies[t].needed;
    counts[1] += tallies[t].executed;
  }
}

extern "C" void cube_loss_vjp_count_f32(
    const float* pvec, const float* xin, const float* xp, const float* force,
    const unsigned char* valid, const float* ct, long long n, double dt,
    int threads, long long* counts, float* dp, float* dxin, float* dxp) {
  count<float>(pvec, xin, xp, force, valid, ct, n, dt, threads, counts, dp,
               dxin, dxp);
}

extern "C" void cube_loss_vjp_count_f64(
    const double* pvec, const double* xin, const double* xp,
    const double* force, const unsigned char* valid, const double* ct,
    long long n, double dt, int threads, long long* counts, double* dp,
    double* dxin, double* dxp) {
  count<double>(pvec, xin, xp, force, valid, ct, n, dt, threads, counts, dp,
                dxin, dxp);
}
"""

_P, _LL, _D, _I = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double,
                   ctypes.c_int)
_SIGNATURES = {
    "cube_loss_vjp_f64": [_P] * 6 + [_LL, _D] + [_P] * 3,
    **{f"cube_loss_vjp_count_{s}": [_P] * 6 + [_LL, _D, _I] + [_P] * 4
       for s in ("f32", "f64")},
}
_COUNT_ENTRY = {torch.float32: "cube_loss_vjp_count_f32",
                torch.float64: "cube_loss_vjp_count_f64"}
_NP = {torch.float32: np.float32, torch.float64: np.float64}


def count_torch_operations(fn: Callable[[], object]) -> int:
    """Arithmetic operations ``fn()`` performs in PyTorch: one per output
    element of each pointwise ATen operation and one per input element of
    each reduction (torch autograd's sweep, counted as the plain version
    runs it, beside the kernels' own counts)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if torch.Tag.pointwise in func.tags:
                outs = out if isinstance(out, (tuple, list)) else (out,)
                Counter.ops += sum(o.numel() for o in outs
                                   if isinstance(o, torch.Tensor))
            elif torch.Tag.reduction in func.tags:
                Counter.ops += args[0].numel()
            return out

    with Counter():
        fn()
    return Counter.ops


def _cube_vjp(lib, pvec, xin, xp, force, valid, ct, dt
              ) -> Tuple[Tensor, Tensor, Tensor]:
    """A host build's ``cube_loss_vjp_f64`` (``CUBE_SWEEP``) over a
    batch-minor batch: ``dp`` per sample ``(B, 15)``, ``dxin`` and ``dxp``
    ``(13, B)``."""
    n = xin.shape[1]
    ins = HostAdjoint._arrays(np.float64, pvec, xin, xp, force, valid, ct)
    outs = [np.zeros((n, 15)), np.zeros((13, n)), np.zeros((13, n))]
    lib.cube_loss_vjp_f64(*[a.ctypes.data for a in ins], n, dt,
                          *[a.ctypes.data for a in outs])
    return tuple(torch.from_numpy(o) for o in outs)


def compiler() -> Optional[str]:
    """The host C++ compiler, or None."""
    return shutil.which("g++") or shutil.which("c++")


def _build_host(work_dir: str, source: str, text: str, level: str,
                flags: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """Writes the stand-in headers and ``text`` as ``source`` into
    ``work_dir``, compiles it with ``g++`` at optimization ``level`` (and
    ``flags``) against ``csrc/``, and loads it."""
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++ or c++) found")
    os.makedirs(work_dir, exist_ok=True)
    for name, body in (("cuda_runtime.h", SHIM), ("counted.h", COUNTED),
                       (source, text)):
        with open(os.path.join(work_dir, name), "w") as handle:
            handle.write(body)
    # The text's hash in the name: builds of other sizes in one directory
    # load as libraries of their own.
    digest = hashlib.sha256(text.encode() + "\0".join(flags).encode())
    library = os.path.join(work_dir, f"lib{os.path.splitext(source)[0]}_"
                                     f"{digest.hexdigest()[:12]}.so")
    proc = subprocess.run(
        [cxx, "-std=c++17", level, *flags, "-ffp-contract=off", "-pthread",
         "-shared", "-fPIC", f"-I{work_dir}", f"-I{soa_kernels.SOURCE_DIR}",
         os.path.join(work_dir, source), "-o", library],
        capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed to build {source}:\n"
                           f"{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(library)


class HostAdjoint:
    """``cube_loss_vjp`` built for the host into ``work_dir``."""

    def __init__(self, work_dir: str):
        self._lib = _build_host(work_dir, "batch.cpp", BATCH, "-O2")
        for name, argtypes in _SIGNATURES.items():
            getattr(self._lib, name).argtypes = argtypes
            getattr(self._lib, name).restype = None

    @staticmethod
    def _arrays(dtype, pvec, xin, xp, force, valid, ct):
        return [np.ascontiguousarray(t.detach().cpu().numpy(), dtype=d)
                for t, d in ((pvec, dtype), (xin, dtype), (xp, dtype),
                             (force, dtype), (valid, np.uint8), (ct, dtype))]

    def vjp(self, pvec: Tensor, xin: Tensor, xp: Tensor, force: Tensor,
            valid: Tensor, ct: Tensor, dt: float
            ) -> Tuple[Tensor, Tensor, Tensor]:
        """``cube_loss_vjp<double>`` over a batch-minor batch: ``dp`` per
        sample ``(B, 15)``, ``dxin`` and ``dxp`` ``(13, B)``."""
        return _cube_vjp(self._lib, pvec, xin, xp, force, valid, ct, dt)

    def count(self, pvec: Tensor, xin: Tensor, xp: Tensor, force: Tensor,
              valid: Tensor, ct: Tensor, dt: float, threads: int = 1,
              gradients: bool = False) -> Dict:
        """The operations ``cube_loss_vjp`` does over the batch in
        ``xin``'s dtype (float32 or float64), on ``threads`` threads:
        ``{"needed": ..., "executed": ..., "valid": samples}``, and with
        ``gradients`` (one thread) the counted sweep's ``dp`` per sample,
        ``dxin`` and ``dxp``."""
        dtype = _NP[xin.dtype]
        n = xin.shape[1]
        ins = self._arrays(dtype, pvec, xin, xp, force, valid, ct)
        counts = np.zeros(2, dtype=np.int64)
        outs = ([np.zeros((n, 15), dtype), np.zeros((13, n), dtype),
                 np.zeros((13, n), dtype)] if gradients else [])
        getattr(self._lib, _COUNT_ENTRY[xin.dtype])(
            *[a.ctypes.data for a in ins], n, dt,
            1 if gradients else threads, counts.ctypes.data,
            *([a.ctypes.data for a in outs] if gradients else [None] * 3))
        result = {"needed": int(counts[0]), "executed": int(counts[1]),
                  "valid": int(ins[4].astype(bool).sum())}
        if gradients:
            result["gradients"] = tuple(torch.from_numpy(o) for o in outs)
        return result


# -- the model-generic terms ----------------------------------------------------
#: Host entries of the generic kernels' per-sample bodies (K1's
#: ``model_loss_cold`` and K3's ``model_loss_warm`` of
#: ``csrc/model_terms.cuh``, K2's reverse-mode ``model_loss_vjp`` of
#: ``csrc/model_adjoint.cuh``) at every generic size, in float64 and
#: counted in float32 and float64; K1's and K3's bodies also as the card
#: runs them, on L = k lanes a sample (``HostLanes``: a thread a lane, a
#: barrier for the warp's ``__syncwarp``, the slots a shared array); and the
#: box cube's ``cube_loss_cold``/``_warm`` (``cube_terms.cuh``) and
#: ``cube_loss_vjp`` (``cube_adjoint.cuh``) in float64, to hold the generic
#: code against the cube's, and ``cube_loss_cold``/``_warm`` counted (the
#: cube's K1 and K3 bounds); and K5's body at the sizes the card builds,
#: the cube's (6, 4) and the elbow's (7, 8) (``hybrid_solve.cuh``'s
#: ``warm_solve_packed``), on one thread or on the card's lanes a QP, in
#: float32 and float64, and counted (its bounds).
MODEL_BATCH = r"""#include <atomic>
#include <limits>
#include <thread>
#include <vector>

#include "counted.h"
#include "model_adjoint.cuh"

namespace {
// The solve's numeric traits for the counting scalar; rsqrt counts one.
template <typename B> struct Num<Counted<B>> {
  static constexpr B machine_eps = std::numeric_limits<B>::epsilon();
  static constexpr B max_finite = std::numeric_limits<B>::max();
  static Counted<B> rsqrt_(const Counted<B>& x) {
    return Counted<B>::op(B(1) / std::sqrt(x.v), x, x, false, false);
  }
};
// The gradient's sweep recomputes some forward terms: executed, and
// needed once already, so tallied apart as `recomputed`.
template <typename B> struct Recompute<Counted<B>> {
  template <typename F> static void run(const F& f) {
    const long long needed = tally.needed;
    f();
    tally.recomputed += tally.needed - needed;
    tally.needed = needed;
  }
};
}  // namespace

// A value of the data in the scalar type S, and back.
template <typename S> struct Scalar {
  template <typename B> static S in(B x) { return S(x); }
  static double out(S x) { return x; }
};
template <typename B> struct Scalar<Counted<B>> {
  static Counted<B> in(B x) { return Counted<B>::data(x); }
  static double out(const Counted<B>& x) { return x.v; }
};

enum Kind { kCold = 0, kWarm = 1, kVjp = 2 };

// A barrier of n threads (sense by generation; waiters yield).
class SpinBarrier {
 public:
  explicit SpinBarrier(int n) : n_(n) {}
  void wait() {
    const int gen = gen_.load(std::memory_order_acquire);
    if (arrived_.fetch_add(1, std::memory_order_acq_rel) + 1 == n_) {
      arrived_.store(0, std::memory_order_relaxed);
      gen_.store(gen + 1, std::memory_order_release);
    } else {
      while (gen_.load(std::memory_order_acquire) == gen)
        std::this_thread::yield();
    }
  }

 private:
  const int n_;
  std::atomic<int> arrived_{0}, gen_{0};
};

// The lanes of one sample as hybrid_solve.cuh's group (WarpLanes on the
// card): lane l on a thread of its own, sync() a barrier of the L threads.
template <typename T, int L> struct HostLanes {
  static constexpr int kLanes = L;
  T* slots_;
  SpinBarrier* barrier_;
  int lane_;
  int lane() const { return lane_; }
  T* slots() const { return slots_; }
  void sync() const { barrier_->wait(); }
  // The host runs one sample's group at a time: its warp is the group.
  static bool warp_all(bool p) { return p; }
};

// K1's (fin null) or K3's body in float64 over n batch-minor samples as
// the card's kernels run it at L lanes a sample: the terms of each sample
// on one thread into the pack, then each lane its contacts' part of the
// solve and the loss, reading and writing its contacts' impulses (lane 0
// the loss and valid).
template <typename Z, int L>
static void run_lanes(const ModelDesc<Z>& desc, const double* pvec,
                      const double* xin, const double* xp, const double* fin,
                      long long n, double dt, double eps, int ipm, int newton,
                      double* loss, double* force, unsigned char* valid) {
  constexpr int KL = Z::K / L, K = Z::K, NX = Z::NX, NU = Z::NU;
  double p[Z::PMAX];
  for (int i = 0; i < desc.n_params; ++i) p[i] = pvec[i];
  std::vector<double> pack(kPackValues<Z> * n);
  for (long long b = 0; b < n; ++b) {
    double x[NX + NU], x_plus[NX];
    for (int i = 0; i < NX; ++i) {
      x[i] = xin[i * n + b];
      x_plus[i] = xp[i * n + b];
    }
    for (int i = 0; i < NU; ++i)
      x[NX + i] = i < desc.n_u ? xin[(NX + i) * n + b] : 0.0;
    ModelParts<double, Z> lp;
    model_parts_at<double, Z>(desc, p, x, x_plus, dt, lp);
    pack_problem<double, Z>(lp, pack.data() + b, n);
  }
  std::vector<double> slots(kLaneSlots<Z::NV, K>);
  SpinBarrier barrier(L);
  std::vector<std::thread> pool;
  for (int lane = 0; lane < L; ++lane)
    pool.emplace_back([&, lane] {
      using G = HostLanes<double, L>;
      const G g{slots.data(), &barrier, lane};
      for (long long b = 0; b < n; ++b) {
        LaneParts<double, Z, G> parts;
        unpack_problem<double, Z, G>(pack.data() + b, n, eps, g, parts);
        double f_in[3][KL], f[3][KL];
        bool ok;
        double l;
        if (fin == nullptr) {
          l = lane_loss_cold<double, Z, G>(parts, eps, ipm, newton, f, ok,
                                           g);
        } else {
          for (int i = 0; i < 3; ++i)
            for (int c = 0; c < KL; ++c)
              f_in[i][c] = fin[(i * K + lane * KL + c) * n + b];
          l = lane_loss_warm<double, Z, G>(parts, f_in, eps, ipm, newton, f,
                                           ok, g);
        }
        if (lane == 0) {
          loss[b] = l;
          valid[b] = ok ? 1 : 0;
        }
        for (int i = 0; i < 3; ++i)
          for (int c = 0; c < KL; ++c)
            force[(i * K + lane * KL + c) * n + b] = f[i][c];
      }
    });
  for (std::thread& t : pool) t.join();
}

// One kind of body over the samples [lo, hi) of n batch-minor ones: the
// cold or warm loss (fin: the previous impulse) writing loss, force and
// valid, or the gradient (fin: the saved impulse) writing dp (n, P), dxin
// and dxp; outputs are skipped when null. kVjpOnly builds the gradient's
// branch alone.
template <typename S, typename B, typename Z, bool kVjpOnly = false>
static void run(int kind, const ModelDesc<Z>& desc, const B* pvec,
                const B* xin, const B* xp, const B* fin,
                const unsigned char* valid_in, const B* ct, long long n,
                long long lo, long long hi, double dt, double eps, int ipm,
                int newton, B* loss, B* force, unsigned char* valid, B* dp,
                B* dxin, B* dxp) {
  using V = Scalar<S>;
  constexpr int K = Z::K, NX = Z::NX, NU = Z::NU;
  const int n_p = desc.n_params;
  S p[Z::PMAX];
  for (int i = 0; i < n_p; ++i) p[i] = V::in(pvec[i]);
  const S dt_s = V::in(B(dt));
  for (long long b = lo; b < hi; ++b) {
    S x[NX + NU], x_plus[NX], f_in[3][K], f[3][K];
    for (int i = 0; i < NX; ++i) {
      x[i] = V::in(xin[i * n + b]);
      x_plus[i] = V::in(xp[i * n + b]);
    }
    for (int i = 0; i < NU; ++i)
      x[NX + i] = i < desc.n_u ? V::in(xin[(NX + i) * n + b]) : S(0);
    if (fin != nullptr)
      for (int i = 0; i < 3; ++i)
        for (int c = 0; c < K; ++c) f_in[i][c] = V::in(fin[(i * K + c) * n + b]);
    if (kind == kVjp) {
      S g_p[Z::PMAX], g_xin[NX + NU], g_xp[NX];
      model_loss_vjp<S, Z>(desc, p, x, x_plus, f_in, valid_in[b] != 0,
                           V::in(ct[b]), dt_s, g_p, g_xin, g_xp);
      if (dp == nullptr) continue;
      for (int i = 0; i < n_p; ++i) dp[b * n_p + i] = B(V::out(g_p[i]));
      for (int i = 0; i < NX + desc.n_u; ++i)
        dxin[i * n + b] = B(V::out(g_xin[i]));
      for (int i = 0; i < NX; ++i) dxp[i * n + b] = B(V::out(g_xp[i]));
      continue;
    }
    if constexpr (!kVjpOnly) {
      bool ok;
      const S l = kind == kCold
                      ? model_loss_cold<S, Z>(desc, p, x, x_plus, dt_s, eps,
                                              ipm, newton, f, ok)
                      : model_loss_warm<S, Z>(desc, p, x, x_plus, f_in, dt_s,
                                              eps, ipm, newton, f, ok);
      if (loss == nullptr) continue;
      loss[b] = B(V::out(l));
      for (int i = 0; i < 3; ++i)
        for (int c = 0; c < K; ++c)
          force[(i * K + c) * n + b] = B(V::out(f[i][c]));
      valid[b] = ok ? 1 : 0;
    }
  }
}

// A size Z read as the kernels read sizes outside kConstFreeBody: the
// body's joint from the descriptor (the generic K2's sweep before the
// free body's constants), with Z's descriptor layout.
template <typename Z> struct DescBody : Z {};
namespace {
template <typename Z> constexpr bool kConstFreeBody<DescBody<Z>> = false;
}  // namespace

// K2's sweep in float64 at a size of kConstFreeBody with the joint read
// from the descriptor (DescBody), as HOST_ENTRIES' model_host at kVjp;
// returns 1 at other sizes, whose kernels read it there already.
template <typename Z>
static int vjp_desc_body(const void* desc, const double* pvec,
                         const double* xin, const double* xp,
                         const double* fin, const unsigned char* valid_in,
                         const double* ct, long long n, double dt, double* dp,
                         double* dxin, double* dxp) {
  if constexpr (kConstFreeBody<Z>) {
    run<double, double, DescBody<Z>, true>(
        kVjp, *(const ModelDesc<DescBody<Z>>*)desc, pvec, xin, xp, fin,
        valid_in, ct, n, 0, n, dt, 0.0, 0, 0, nullptr, nullptr, nullptr, dp,
        dxin, dxp);
    return 0;
  }
  return 1;
}

// Runs body(lo, hi) over the samples [lo, hi) of n split among `threads`
// threads, each tallying on its own; counts = {needed, executed,
// recomputed, ipm_fixed, newton_fixed}, summed.
template <typename F>
static void tally_on_threads(long long n, int threads, long long* counts,
                             const F& body) {
  std::vector<std::thread> pool;
  std::vector<Tally> tallies(threads);
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([=, &body, &tallies] {
      tally = Tally();
      body(n * t / threads, n * (t + 1) / threads);
      tallies[t] = tally;
    });
  for (int i = 0; i < 5; ++i) counts[i] = 0;
  for (int t = 0; t < threads; ++t) {
    pool[t].join();
    counts[0] += tallies[t].needed;
    counts[1] += tallies[t].executed;
    counts[2] += tallies[t].recomputed;
    counts[3] += tallies[t].ipm_fixed;
    counts[4] += tallies[t].newton_fixed;
  }
}

// The counts of one kind on Counted<B> over n samples, on `threads`
// threads; counts as tally_on_threads'.
template <typename B, typename Z>
static void count(int kind, const ModelDesc<Z>& desc, const B* pvec,
                  const B* xin, const B* xp, const B* fin,
                  const unsigned char* valid_in, const B* ct, long long n,
                  double dt, double eps, int ipm, int newton, int threads,
                  long long* counts) {
  tally_on_threads(n, threads, counts, [&](long long lo, long long hi) {
    run<Counted<B>, B, Z>(kind, desc, pvec, xin, xp, fin, valid_in, ct, n,
                          lo, hi, dt, eps, ipm, newton, nullptr, nullptr,
                          nullptr, nullptr, nullptr, nullptr);
  });
}

#define HOST_ENTRIES(Z, NAME)                                                \
  extern "C" void model_host_##NAME(                                         \
      int kind, const void* desc, const double* pvec, const double* xin,     \
      const double* xp, const double* fin, const unsigned char* valid_in,    \
      const double* ct, long long n, double dt, double eps, int ipm,         \
      int newton, double* loss, double* force, unsigned char* valid,         \
      double* dp, double* dxin, double* dxp) {                               \
    run<double, double, Z>(kind, *(const ModelDesc<Z>*)desc, pvec, xin, xp,  \
                           fin, valid_in, ct, n, 0, n, dt, eps, ipm, newton, \
                           loss, force, valid, dp, dxin, dxp);               \
  }                                                                          \
  extern "C" int model_fwd_lanes_##NAME() { return kFwdLanes<Z>; }          \
  extern "C" int model_vjp_desc_body_##NAME(                                 \
      const void* desc, const double* pvec, const double* xin,               \
      const double* xp, const double* fin, const unsigned char* valid_in,    \
      const double* ct, long long n, double dt, double* dp, double* dxin,    \
      double* dxp) {                                                         \
    return vjp_desc_body<Z>(desc, pvec, xin, xp, fin, valid_in, ct, n, dt,   \
                            dp, dxin, dxp);                                  \
  }                                                                          \
  extern "C" int model_lanes_host_##NAME(                                    \
      int lanes, const void* desc, const double* pvec, const double* xin,    \
      const double* xp, const double* fin, long long n, double dt,           \
      double eps, int ipm, int newton, double* loss, double* force,           \
      unsigned char* valid) {                                                \
    const ModelDesc<Z>& d = *(const ModelDesc<Z>*)desc;                      \
    if (lanes == Z::K) {                                                     \
      run_lanes<Z, Z::K>(d, pvec, xin, xp, fin, n, dt, eps, ipm, newton,     \
                         loss, force, valid);                                \
      return 0;                                                              \
    }                                                                        \
    if constexpr (kFwdLanes<Z> > 1 && kFwdLanes<Z> < Z::K)                   \
      if (lanes == kFwdLanes<Z>) {                                           \
        run_lanes<Z, kFwdLanes<Z>>(d, pvec, xin, xp, fin, n, dt, eps, ipm,   \
                                   newton, loss, force, valid);              \
        return 0;                                                            \
      }                                                                      \
    return 1;                                                                \
  }                                                                          \
  extern "C" void model_count_##NAME##_f32(                                  \
      int kind, const void* desc, const float* pvec, const float* xin,       \
      const float* xp, const float* fin, const unsigned char* valid_in,      \
      const float* ct, long long n, double dt, double eps, int ipm,          \
      int newton, int threads, long long* counts) {                          \
    count<float, Z>(kind, *(const ModelDesc<Z>*)desc, pvec, xin, xp, fin,    \
                    valid_in, ct, n, dt, eps, ipm, newton, threads, counts); \
  }                                                                          \
  extern "C" void model_count_##NAME##_f64(                                  \
      int kind, const void* desc, const double* pvec, const double* xin,     \
      const double* xp, const double* fin, const unsigned char* valid_in,    \
      const double* ct, long long n, double dt, double eps, int ipm,         \
      int newton, int threads, long long* counts) {                          \
    count<double, Z>(kind, *(const ModelDesc<Z>*)desc, pvec, xin, xp, fin,   \
                     valid_in, ct, n, dt, eps, ipm, newton, threads,         \
                     counts);                                                \
  }

SIZE_ENTRIES

// K5's body (hybrid_solve.cuh's warm_solve_packed) over n packed QPs of
// (n_v, k) = (NV, K) in type T, as the card runs it: one thread a QP (L =
// 1), or L lanes a QP, a thread a lane meeting at a barrier where the card
// calls __syncwarp, over `groups` >= n groups, those past n solving the
// last QP again and writing nothing.
template <typename T, int NV, int K, int L>
static void run_warm_solve(const T* M, const T* Jc, const T* qc,
                           const T* w0, long long n, long long groups,
                           double eps, int ipm, int newton, T* force, T* w,
                           unsigned char* valid) {
  if constexpr (L == 1) {
    for (long long b = 0; b < n; ++b)
      warm_solve_packed<T, NV, K>(M, Jc, qc, w0, force, w, valid, n, b, true,
                                  eps, ipm, newton);
  } else {
    std::vector<T> slots(kLaneSlots<NV, K>);
    SpinBarrier barrier(L);
    std::vector<std::thread> pool;
    for (int lane = 0; lane < L; ++lane)
      pool.emplace_back([&, lane] {
        using G = HostLanes<T, L>;
        const G g{slots.data(), &barrier, lane};
        for (long long b = 0; b < groups; ++b)
          warm_solve_packed<T, NV, K, G>(M, Jc, qc, w0, force, w, valid, n,
                                         b < n ? b : n - 1, b < n, eps, ipm,
                                         newton, g);
      });
    for (std::thread& t : pool) t.join();
  }
}

// K5 at (NV, K) on one thread a QP (lanes 1) or on the card's kWarmLanes
// lanes a QP; returns 1 for another count of lanes.
#define WARM_SOLVE_ENTRY(NV, K, T, SUFFIX)                                   \
  extern "C" int warm_solve_host_nv##NV##_k##K##_##SUFFIX(                   \
      int lanes, const T* M, const T* Jc, const T* qc, const T* w0,          \
      long long n, long long groups, double eps, int ipm, int newton,        \
      T* force, T* w, unsigned char* valid) {                                \
    constexpr int L = kWarmLanes<NV, K>;                                     \
    if (lanes == 1)                                                          \
      run_warm_solve<T, NV, K, 1>(M, Jc, qc, w0, n, groups, eps, ipm,        \
                                  newton, force, w, valid);                  \
    else if (lanes == L)                                                     \
      run_warm_solve<T, NV, K, L>(M, Jc, qc, w0, n, groups, eps, ipm,        \
                                  newton, force, w, valid);                  \
    else                                                                     \
      return 1;                                                              \
    return 0;                                                                \
  }

// The counts of K5's body at (NV, K) (warm_solve_packed, one thread a QP)
// on Counted<T> over the QPs [lo, hi) of n packed QPs, each read into a
// one-QP pack of data values.
template <typename T, int NV, int K>
static void warm_solve_count_run(const T* M, const T* Jc, const T* qc,
                                 const T* w0, long long n, long long lo,
                                 long long hi, double eps, int ipm,
                                 int newton) {
  using S = Counted<T>;
  S m[NV * NV], jc[3 * NV * K], q[3 * K], w[NV], force[3 * K], w_out[NV];
  unsigned char valid;
  for (long long b = lo; b < hi; ++b) {
    for (int i = 0; i < NV * NV; ++i) m[i] = S::data(M[i * n + b]);
    for (int i = 0; i < 3 * NV * K; ++i) jc[i] = S::data(Jc[i * n + b]);
    for (int i = 0; i < 3 * K; ++i) q[i] = S::data(qc[i * n + b]);
    for (int i = 0; i < NV; ++i) w[i] = S::data(w0[i * n + b]);
    warm_solve_packed<S, NV, K>(m, jc, q, w, force, w_out, &valid, 1, 0,
                                true, eps, ipm, newton);
  }
}

// As count() for the loss bodies: counts = {needed, executed, recomputed
// (none)}.
#define WARM_SOLVE_COUNT_ENTRY(NV, K, T, SUFFIX)                             \
  extern "C" void warm_solve_count_nv##NV##_k##K##_##SUFFIX(                 \
      const T* M, const T* Jc, const T* qc, const T* w0, long long n,        \
      double eps, int ipm, int newton, int threads, long long* counts) {     \
    tally_on_threads(n, threads, counts, [&](long long lo, long long hi) {   \
      warm_solve_count_run<T, NV, K>(M, Jc, qc, w0, n, lo, hi, eps, ipm,     \
                                     newton);                                \
    });                                                                      \
  }

// K5's host entries at one (n_v, k).
#define WARM_SOLVE_SIZE(NV, K)                                               \
  WARM_SOLVE_ENTRY(NV, K, float, f32)                                        \
  WARM_SOLVE_ENTRY(NV, K, double, f64)                                       \
  WARM_SOLVE_COUNT_ENTRY(NV, K, float, f32)                                  \
  WARM_SOLVE_COUNT_ENTRY(NV, K, double, f64)                                 \
  extern "C" int warm_lanes_nv##NV##_k##K() { return kWarmLanes<NV, K>; }
WARM_SHAPE_ENTRIES

// K4's body (hybrid_solve.cuh's cold_solve_packed, both loops' exits on
// or off) over n packed QPs as the card runs it, on one thread a QP or L
// lanes a QP, as run_warm_solve runs K5's.
template <typename T, int NV, int K, int L, bool kExits>
static void run_cold_solve(const T* M, const T* Jc, const T* qc, long long n,
                           long long groups, double eps, int ipm, int newton,
                           T* force, unsigned char* valid) {
  if constexpr (L == 1) {
    for (long long b = 0; b < n; ++b)
      cold_solve_packed<T, NV, K, Solo, kExits, kExits>(
          M, Jc, qc, force, valid, n, b, true, eps, ipm, newton);
  } else {
    std::vector<T> slots(kLaneSlots<NV, K>);
    SpinBarrier barrier(L);
    std::vector<std::thread> pool;
    for (int lane = 0; lane < L; ++lane)
      pool.emplace_back([&, lane] {
        using G = HostLanes<T, L>;
        const G g{slots.data(), &barrier, lane};
        for (long long b = 0; b < groups; ++b)
          cold_solve_packed<T, NV, K, G, kExits, kExits>(
              M, Jc, qc, force, valid, n, b < n ? b : n - 1, b < n, eps, ipm,
              newton, g);
      });
    for (std::thread& t : pool) t.join();
  }
}

template <typename T, int NV, int K, bool kExits>
static int run_cold_solve_lanes(int lanes, const T* M, const T* Jc,
                                const T* qc, long long n, long long groups,
                                double eps, int ipm, int newton, T* force,
                                unsigned char* valid) {
  constexpr int L = kColdLanes<NV, K>;
  if (lanes == 1) {
    run_cold_solve<T, NV, K, 1, kExits>(M, Jc, qc, n, groups, eps, ipm,
                                        newton, force, valid);
  } else if (lanes == L) {
    run_cold_solve<T, NV, K, L, kExits>(M, Jc, qc, n, groups, eps, ipm,
                                        newton, force, valid);
  } else {
    // The cube's float64 QPs run on 2 lanes from a batch on.
    if constexpr (NV == 6 && K == 4)
      if (lanes == 2) {
        run_cold_solve<T, NV, K, 2, kExits>(M, Jc, qc, n, groups, eps, ipm,
                                            newton, force, valid);
        return 0;
      }
    return 1;
  }
  return 0;
}

// The counts of K4's body (cold_solve_packed, one thread a QP, each loop's
// exits on or off) on Counted<T> over the QPs [lo, hi) of n, as
// warm_solve_count_run.
template <typename T, int NV, int K, bool kIpmExits, bool kNewtonExits>
static void cold_solve_count_run(const T* M, const T* Jc, const T* qc,
                                 long long n, long long lo, long long hi,
                                 double eps, int ipm, int newton) {
  using S = Counted<T>;
  S m[NV * NV], jc[3 * NV * K], q[3 * K], force[3 * K];
  unsigned char valid;
  for (long long b = lo; b < hi; ++b) {
    for (int i = 0; i < NV * NV; ++i) m[i] = S::data(M[i * n + b]);
    for (int i = 0; i < 3 * NV * K; ++i) jc[i] = S::data(Jc[i * n + b]);
    for (int i = 0; i < 3 * K; ++i) q[i] = S::data(qc[i * n + b]);
    cold_solve_packed<S, NV, K, Solo, kIpmExits, kNewtonExits>(
        m, jc, q, force, &valid, 1, 0, true, eps, ipm, newton);
  }
}

// K4 at (NV, K) on one thread a QP (lanes 1), on the card's kColdLanes
// lanes a QP or, at (6, 4), on 2, exits on or off (returns 1 for another
// count of lanes); and its counts, as the loss bodies' count() (counts as
// tally_on_threads'), with exits 0 (none), 1 (both loops') or 2
// (SAP-Newton's alone).
#define COLD_SOLVE_ENTRIES(NV, K, T, SUFFIX)                                 \
  extern "C" int cold_solve_host_nv##NV##_k##K##_##SUFFIX(                   \
      int lanes, int exits, const T* M, const T* Jc, const T* qc,            \
      long long n, long long groups, double eps, int ipm, int newton,        \
      T* force, unsigned char* valid) {                                      \
    return exits ? run_cold_solve_lanes<T, NV, K, true>(                     \
                       lanes, M, Jc, qc, n, groups, eps, ipm, newton, force, \
                       valid)                                                \
                 : run_cold_solve_lanes<T, NV, K, false>(                    \
                       lanes, M, Jc, qc, n, groups, eps, ipm, newton, force, \
                       valid);                                               \
  }                                                                          \
  extern "C" void cold_solve_count_nv##NV##_k##K##_##SUFFIX(                 \
      int exits, const T* M, const T* Jc, const T* qc, long long n,          \
      double eps, int ipm, int newton, int threads, long long* counts) {     \
    tally_on_threads(n, threads, counts, [&](long long lo, long long hi) {   \
      if (exits == 1)                                                        \
        cold_solve_count_run<T, NV, K, true, true>(M, Jc, qc, n, lo, hi,     \
                                                   eps, ipm, newton);        \
      else if (exits == 2)                                                   \
        cold_solve_count_run<T, NV, K, false, true>(M, Jc, qc, n, lo, hi,    \
                                                    eps, ipm, newton);       \
      else                                                                   \
        cold_solve_count_run<T, NV, K, false, false>(M, Jc, qc, n, lo, hi,   \
                                                     eps, ipm, newton);      \
    });                                                                      \
  }
#define COLD_SOLVE_SIZE(NV, K)                                               \
  COLD_SOLVE_ENTRIES(NV, K, float, f32)                                      \
  COLD_SOLVE_ENTRIES(NV, K, double, f64)                                     \
  extern "C" int cold_lanes_nv##NV##_k##K() { return kColdLanes<NV, K>; }
COLD_SHAPE_ENTRIES

// The counts of the box cube's K1 (cube_loss_cold, fin null; its solve's
// exits on or off) or K3 (cube_loss_warm from fin) on Counted<B> over the
// samples [lo, hi) of n.
template <typename B>
static void cube_count_run(int kind, int exits, const B* pvec, const B* xin,
                           const B* xp, const B* fin, long long n,
                           long long lo, long long hi, double dt, double eps,
                           int ipm, int newton) {
  using S = Counted<B>;
  using V = Scalar<S>;
  S p[kCubeP];
  for (int i = 0; i < kCubeP; ++i) p[i] = V::in(pvec[i]);
  const S dt_s = V::in(B(dt));
  for (long long b = lo; b < hi; ++b) {
    S x[kCubeNX], x_plus[kCubeNX], f_prev[3][kCubeK], f[3][kCubeK];
    for (int i = 0; i < kCubeNX; ++i) {
      x[i] = V::in(xin[i * n + b]);
      x_plus[i] = V::in(xp[i * n + b]);
    }
    bool ok;
    if (kind == kCold && exits) {
      cube_loss_cold<S, true>(p, x, x_plus, dt_s, eps, ipm, newton, f, ok);
    } else if (kind == kCold) {
      cube_loss_cold<S, false>(p, x, x_plus, dt_s, eps, ipm, newton, f, ok);
    } else {
      for (int i = 0; i < 3; ++i)
        for (int c = 0; c < kCubeK; ++c)
          f_prev[i][c] = V::in(fin[(i * kCubeK + c) * n + b]);
      cube_loss_warm<S>(p, x, x_plus, f_prev, dt_s, eps, ipm, newton, f,
                        ok);
    }
  }
}

// As count() for the generic bodies (recomputed none).
#define CUBE_COUNT_ENTRY(B, SUFFIX)                                          \
  extern "C" void cube_count_##SUFFIX(                                       \
      int kind, int exits, const B* pvec, const B* xin, const B* xp,         \
      const B* fin, long long n, double dt, double eps, int ipm, int newton, \
      int threads, long long* counts) {                                      \
    tally_on_threads(n, threads, counts, [&](long long lo, long long hi) {   \
      cube_count_run<B>(kind, exits, pvec, xin, xp, fin, n, lo, hi, dt, eps, \
                        ipm, newton);                                        \
    });                                                                      \
  }
CUBE_COUNT_ENTRY(float, f32)
CUBE_COUNT_ENTRY(double, f64)

// cube_loss_cold<double> (fprev null; exits on, as K1 runs it, or off) or
// cube_loss_warm<double>.
extern "C" void cube_host_f64(int exits, const double* pvec,
                              const double* xin, const double* xp,
                              const double* fprev, long long n, double dt,
                              double eps, int ipm, int newton, double* loss,
                              double* force, unsigned char* valid) {
  double p[kCubeP];
  for (int i = 0; i < kCubeP; ++i) p[i] = pvec[i];
  for (long long b = 0; b < n; ++b) {
    double x[kCubeNX], x_plus[kCubeNX], f_prev[3][kCubeK], f[3][kCubeK];
    for (int i = 0; i < kCubeNX; ++i) {
      x[i] = xin[i * n + b];
      x_plus[i] = xp[i * n + b];
    }
    bool ok;
    double l;
    if (fprev == nullptr && exits) {
      l = cube_loss_cold<double, true>(p, x, x_plus, dt, eps, ipm, newton, f,
                                       ok);
    } else if (fprev == nullptr) {
      l = cube_loss_cold<double, false>(p, x, x_plus, dt, eps, ipm, newton,
                                        f, ok);
    } else {
      for (int i = 0; i < 3; ++i)
        for (int c = 0; c < kCubeK; ++c)
          f_prev[i][c] = fprev[(i * kCubeK + c) * n + b];
      l = cube_loss_warm<double>(p, x, x_plus, f_prev, dt, eps, ipm, newton,
                                 f, ok);
    }
    loss[b] = l;
    for (int i = 0; i < 3; ++i)
      for (int c = 0; c < kCubeK; ++c) force[(i * kCubeK + c) * n + b] = f[i][c];
    valid[b] = ok ? 1 : 0;
  }
}
""" + CUBE_SWEEP


_KINDS = {"cold": 0, "warm": 1, "vjp": 2}
_HOST_ARGS = [_I, _P] + [_P] * 6 + [_LL, _D, _D, _I, _I] + [_P] * 6
_LANES_ARGS = [_I] + [_P] * 5 + [_LL, _D, _D, _I, _I] + [_P] * 3
_VJP_ARGS = [_P] * 7 + [_LL, _D] + [_P] * 3
_COUNT_ARGS = [_I, _P] + [_P] * 6 + [_LL, _D, _D, _I, _I, _I, _P]
_WARM_SOLVE_ARGS = [_I] + [_P] * 4 + [_LL, _LL, _D, _I, _I] + [_P] * 3
_CUBE_COUNT_ARGS = [_I, _I] + [_P] * 4 + [_LL, _D, _D, _I, _I, _I, _P]
_WARM_COUNT_ARGS = [_P] * 4 + [_LL, _D, _I, _I, _I, _P]
_COLD_SOLVE_ARGS = [_I, _I] + [_P] * 3 + [_LL, _LL, _D, _I, _I] + [_P] * 2
_COLD_COUNT_ARGS = [_I] + [_P] * 3 + [_LL, _D, _I, _I, _I, _P]
#: The host entries' tallies (``tally_on_threads``).
_TALLIES = ("needed", "executed", "recomputed", "ipm_fixed", "newton_fixed")


def _tallies(counts, *keys) -> Dict:
    return {key: int(counts[_TALLIES.index(key)]) for key in keys}


def _model_batch_source(sizes, shapes) -> str:
    entries = "\n".join(
        f"using Size_{size.name} = {size.template};\n"
        f"HOST_ENTRIES(Size_{size.name}, {size.name})" for size in sizes)
    return (MODEL_BATCH.replace("SIZE_ENTRIES", entries)
            .replace("WARM_SHAPE_ENTRIES", "\n".join(
                f"WARM_SOLVE_SIZE({n_v}, {k})" for n_v, k in shapes))
            .replace("COLD_SHAPE_ENTRIES", "\n".join(
                f"COLD_SOLVE_SIZE({n_v}, {k})" for n_v, k in shapes)))


class HostModelTerms:
    """The generic loss kernels' per-sample bodies built for the host into
    ``work_dir``: the cold and warm loss (``csrc/model_terms.cuh``) and
    K2's gradient (``csrc/model_adjoint.cuh``) of any model the generic
    kernels cover, in float64 and counted; the box cube's loss (also
    counted) and gradient from ``cube_terms.cuh`` and ``cube_adjoint.cuh``;
    and K4's and K5's bodies as the card runs them, and counted. The
    generic bodies are built at ``sizes`` (``soa_loss_kernels.ModelSize``
    or its fields, as ``soa_loss_kernels.model_size`` gives them for the
    models to run), K4 and K5 at ``shapes`` (``(n_v, k)``)."""

    def __init__(self, work_dir: str, sizes, shapes,
                 flags: Tuple[str, ...] = ()):
        from dair_pll_tpu_torch.ops.soa_loss_kernels import ModelSize
        sizes = list({size.name: size for size in
                      (ModelSize(*size) for size in sizes)}.values())
        self._sizes = {size.name for size in sizes}
        self._shapes = tuple(tuple(shape) for shape in shapes)
        # -O1: the unrolled bodies of every size and scalar make one large
        # source, which -O2 compiles several times slower. ``flags`` go to
        # g++ as well (tests/check_torch_k2_host_builds.py: sanitizers, the
        # fill of uninitialised locals).
        self._lib = _build_host(work_dir, "model_batch.cpp",
                                _model_batch_source(sizes, self._shapes),
                                "-O1", flags)
        for name in self._sizes:
            getattr(self._lib, f"model_host_{name}").argtypes = _HOST_ARGS
            getattr(self._lib, f"model_lanes_host_{name}").argtypes = \
                _LANES_ARGS
            getattr(self._lib, f"model_fwd_lanes_{name}").argtypes = []
            getattr(self._lib, f"model_vjp_desc_body_{name}").argtypes = \
                _VJP_ARGS
            for s in ("f32", "f64"):
                getattr(self._lib, f"model_count_{name}_{s}").argtypes = \
                    _COUNT_ARGS
        self._lib.cube_host_f64.argtypes = [_I] + [_P] * 4 + \
            [_LL, _D, _D, _I, _I] + [_P] * 3
        for s in ("f32", "f64"):
            getattr(self._lib, f"cube_count_{s}").argtypes = \
                _CUBE_COUNT_ARGS
            getattr(self._lib, f"cube_count_{s}").restype = None
        for n_v, k in self._shapes:
            for s in ("f32", "f64"):
                fn = getattr(self._lib, f"warm_solve_host_nv{n_v}_k{k}_{s}")
                fn.argtypes = _WARM_SOLVE_ARGS
                fn = getattr(self._lib, f"warm_solve_count_nv{n_v}_k{k}_{s}")
                fn.argtypes, fn.restype = _WARM_COUNT_ARGS, None
            getattr(self._lib, f"warm_lanes_nv{n_v}_k{k}").argtypes = []
            for s in ("f32", "f64"):
                fn = getattr(self._lib, f"cold_solve_host_nv{n_v}_k{k}_{s}")
                fn.argtypes = _COLD_SOLVE_ARGS
                fn = getattr(self._lib, f"cold_solve_count_nv{n_v}_k{k}_{s}")
                fn.argtypes, fn.restype = _COLD_COUNT_ARGS, None
            getattr(self._lib, f"cold_lanes_nv{n_v}_k{k}").argtypes = []
        self._lib.cube_loss_vjp_f64.argtypes = \
            _SIGNATURES["cube_loss_vjp_f64"]
        for fn in (self._lib.cube_host_f64, self._lib.cube_loss_vjp_f64,
                   *(getattr(self._lib, f"model_host_{n}")
                     for n in self._sizes)):
            fn.restype = None

    def _desc(self, model):
        from dair_pll_tpu_torch.ops import soa_loss_kernels
        name = soa_loss_kernels.generic_size(model)
        if name is None:
            raise NotImplementedError("the generic loss kernels do not cover "
                                      "this model")
        if name not in self._sizes:
            raise ValueError(f"this host build has no size {name}; built: "
                             f"{sorted(self._sizes)}")
        return name, soa_loss_kernels.model_descriptor(model)

    @staticmethod
    def _array(t, dtype):
        if t is None:
            return None
        return np.ascontiguousarray(t.detach().cpu().numpy(), dtype=dtype)

    def fwd_lanes(self, model) -> int:
        """Lanes a sample of the card's K1 and K3 at the model's size
        (``kFwdLanes`` of ``csrc/model_terms.cuh``)."""
        return getattr(self._lib, f"model_fwd_lanes_{self._desc(model)[0]}")()

    def loss(self, model, pvec: Tensor, xin: Tensor, xp: Tensor, dt: float,
             eps: float, ipm: int, newton: int,
             fprev: Optional[Tensor] = None,
             lanes: int = 1) -> Tuple[Tensor, Tensor, Tensor]:
        """K1's body (``fprev`` None) or K3's in float64 over a
        batch-minor batch: ``(loss (B,), force (3, k, B), valid (B,))``;
        one thread a sample, or on ``lanes`` lanes a sample as the card's
        kernels run them (k, or ``fwd_lanes(model)``)."""
        name, desc = self._desc(model)
        n = xin.shape[1]
        ins = [self._array(t, np.float64) for t in (pvec, xin, xp, fprev)]
        outs = [np.zeros(n), np.zeros((3, model.n_contacts, n)),
                np.zeros(n, dtype=np.uint8)]
        if lanes > 1:
            if getattr(self._lib, f"model_lanes_host_{name}")(
                    lanes, ctypes.addressof(desc), *[_ptr(a) for a in ins],
                    n, dt, eps, ipm, newton, *[_ptr(a) for a in outs]):
                raise ValueError(f"no host build of {lanes} lanes a sample "
                                 f"at size {name}")
        else:
            getattr(self._lib, f"model_host_{name}")(
                _KINDS["cold" if fprev is None else "warm"],
                ctypes.addressof(desc), *[_ptr(a) for a in ins], None, None,
                n, dt, eps, ipm, newton, *[_ptr(a) for a in outs], None,
                None, None)
        return (torch.from_numpy(outs[0]), torch.from_numpy(outs[1]),
                torch.from_numpy(outs[2].astype(bool)))

    def cube_loss(self, pvec: Tensor, xin: Tensor, xp: Tensor, dt: float,
                  eps: float, ipm: int, newton: int,
                  fprev: Optional[Tensor] = None, exits: bool = True):
        """``cube_terms.cuh``'s ``cube_loss_cold`` (``fprev`` None; its
        solve's fixed-point exits on, as K1 runs it, or off) or
        ``cube_loss_warm`` in float64: ``(loss, force, valid)``."""
        n = xin.shape[1]
        ins = [self._array(t, np.float64) for t in (pvec, xin, xp, fprev)]
        outs = [np.zeros(n), np.zeros((3, 4, n)), np.zeros(n, dtype=np.uint8)]
        self._lib.cube_host_f64(int(exits), *[_ptr(a) for a in ins], n, dt,
                                eps, ipm, newton, *[_ptr(a) for a in outs])
        return (torch.from_numpy(outs[0]), torch.from_numpy(outs[1]),
                torch.from_numpy(outs[2].astype(bool)))

    def cube_count(self, kind: str, pvec: Tensor, xin: Tensor, xp: Tensor,
                   fin: Optional[Tensor], dt: float, eps: float, ipm: int,
                   newton: int, threads: int = 1, exits: bool = True) -> Dict:
        """The operations the box cube's K1 (``kind`` ``cold``:
        ``cube_terms.cuh``'s ``cube_loss_cold``, its solve's exits on, as
        K1 runs it, or off) or K3 (``warm``: ``cube_loss_warm`` from
        ``fin``) does over the batch in ``xin``'s dtype (float32 or
        float64), on ``threads`` threads, as :meth:`count` tallies the
        generic bodies: ``{"needed": ..., "executed": ..., "ipm_fixed":
        ..., "newton_fixed": ...}``, the last two the cold solve's
        iterations that repeated the one before (counted with the
        exits)."""
        dtype = _NP[xin.dtype]
        ins = [self._array(t, dtype) for t in (pvec, xin, xp, fin)]
        counts = np.zeros(len(_TALLIES), dtype=np.int64)
        getattr(self._lib, f"cube_count_{_SUFFIX[xin.dtype]}")(
            _KINDS[kind], int(exits), *[_ptr(a) for a in ins], xin.shape[1],
            dt, eps, ipm, newton, threads, counts.ctypes.data)
        return _tallies(counts, "needed", "executed", "ipm_fixed",
                        "newton_fixed")

    def warm_lanes(self, shape: Tuple[int, int]) -> int:
        """Lanes a QP of the card's K5 at ``shape``, ``(n_v, k)``, one of
        the build's shapes (``kWarmLanes`` of ``csrc/hybrid_solve.cuh``)."""
        n_v, k = shape
        return getattr(self._lib, f"warm_lanes_nv{n_v}_k{k}")()

    def warm_solve(self, m: Tensor, jc: Tensor, qc: Tensor, w0: Tensor,
                   eps: float, ipm: int, newton: int, lanes: int = 1,
                   groups: Optional[int] = None
                   ) -> Tuple[Tensor, Tensor, Tensor]:
        """K5's body (``warm_solve_packed``) at the QPs' ``(n_v, k)``, from
        ``jc (3, n_v, k, B)``, on packed QPs in their dtype (float32 or
        float64), as the card runs it: one thread a QP, or on ``lanes``
        (``warm_lanes((n_v, k))``) lanes a QP over ``groups`` (at least the
        batch; those past it solve the last QP again and write nothing).
        Returns ``(force (3, k, B), w (n_v, B), valid (B,))``, as
        ``soa_kernels.plain_packed``."""
        dtype = _NP[m.dtype]
        _, n_v, k, n = jc.shape
        ins = [self._array(t, dtype) for t in (m, jc, qc, w0)]
        outs = [np.zeros((3, k, n), dtype), np.zeros((n_v, n), dtype),
                np.zeros(n, dtype=np.uint8)]
        entry = f"warm_solve_host_nv{n_v}_k{k}_{_SUFFIX[m.dtype]}"
        if getattr(self._lib, entry)(
                lanes, *[_ptr(a) for a in ins], n,
                n if groups is None else groups, eps, ipm, newton,
                *[_ptr(a) for a in outs]):
            raise ValueError(f"no host build of K5 at {(n_v, k)} on {lanes} "
                             f"lanes a QP")
        return (torch.from_numpy(outs[0]), torch.from_numpy(outs[1]),
                torch.from_numpy(outs[2].astype(bool)))

    def warm_solve_count(self, m: Tensor, jc: Tensor, qc: Tensor,
                         w0: Tensor, eps: float, ipm: int, newton: int,
                         threads: int = 1) -> Dict:
        """The operations K5's body (``warm_solve_packed``) at the QPs'
        ``(n_v, k)`` does on packed QPs in their dtype (float32 or
        float64), on ``threads`` threads, as :meth:`cube_count` tallies the
        loss bodies: ``{"needed": ..., "executed": ...}``."""
        dtype = _NP[m.dtype]
        _, n_v, k, n = jc.shape
        ins = [self._array(t, dtype) for t in (m, jc, qc, w0)]
        counts = np.zeros(len(_TALLIES), dtype=np.int64)
        getattr(self._lib, f"warm_solve_count_nv{n_v}_k{k}_"
                           f"{_SUFFIX[m.dtype]}")(
            *[_ptr(a) for a in ins], n, eps, ipm, newton, threads,
            counts.ctypes.data)
        return _tallies(counts, "needed", "executed")

    def cold_lanes(self, shape: Tuple[int, int]) -> int:
        """Lanes a QP of the card's K4 at ``shape``, ``(n_v, k)``
        (``kColdLanes`` of ``csrc/hybrid_solve.cuh``)."""
        n_v, k = shape
        return getattr(self._lib, f"cold_lanes_nv{n_v}_k{k}")()

    def cold_solve(self, m: Tensor, jc: Tensor, qc: Tensor, eps: float,
                   ipm: int, newton: int, lanes: int = 1,
                   groups: Optional[int] = None, exits: bool = True
                   ) -> Tuple[Tensor, Tensor]:
        """K4's body (``cold_solve_packed``, its loops' fixed-point exits
        on, as the card runs it, or off) at the QPs' ``(n_v, k)`` on packed
        QPs in their dtype, on one thread a QP or on ``lanes``
        (``cold_lanes((n_v, k))``, or 2 at (6, 4), where the card's float64
        kernel runs 2 from a batch on) lanes a QP over ``groups``, as
        :meth:`warm_solve`. Returns ``(force (3, k, B), valid (B,))``, as
        ``soa_kernels.plain_packed_cold``."""
        dtype = _NP[m.dtype]
        _, n_v, k, n = jc.shape
        ins = [self._array(t, dtype) for t in (m, jc, qc)]
        outs = [np.zeros((3, k, n), dtype), np.zeros(n, dtype=np.uint8)]
        entry = f"cold_solve_host_nv{n_v}_k{k}_{_SUFFIX[m.dtype]}"
        if getattr(self._lib, entry)(
                lanes, int(exits), *[_ptr(a) for a in ins], n,
                n if groups is None else groups, eps, ipm, newton,
                *[_ptr(a) for a in outs]):
            raise ValueError(f"no host build of K4 at {(n_v, k)} on {lanes} "
                             f"lanes a QP")
        return (torch.from_numpy(outs[0]),
                torch.from_numpy(outs[1].astype(bool)))

    def cold_solve_count(self, m: Tensor, jc: Tensor, qc: Tensor,
                         eps: float, ipm: int, newton: int,
                         threads: int = 1, exits=True) -> Dict:
        """The operations K4's body (``cold_solve_packed``) at the QPs'
        ``(n_v, k)`` does on packed QPs in their dtype, on ``threads``
        threads, with ``exits`` True (both loops' exits), False (none) or
        ``"newton"`` (SAP-Newton's alone), as :meth:`cube_count` tallies
        K1's: ``{"needed", "executed", "ipm_fixed", "newton_fixed"}``."""
        dtype = _NP[m.dtype]
        _, n_v, k, n = jc.shape
        ins = [self._array(t, dtype) for t in (m, jc, qc)]
        counts = np.zeros(len(_TALLIES), dtype=np.int64)
        getattr(self._lib, f"cold_solve_count_nv{n_v}_k{k}_"
                           f"{_SUFFIX[m.dtype]}")(
            {False: 0, True: 1, "newton": 2}[exits], *[_ptr(a) for a in ins],
            n, eps, ipm, newton, threads, counts.ctypes.data)
        return _tallies(counts, "needed", "executed", "ipm_fixed",
                        "newton_fixed")

    def cube_vjp(self, pvec: Tensor, xin: Tensor, xp: Tensor, force: Tensor,
                 valid: Tensor, ct: Tensor, dt: float
                 ) -> Tuple[Tensor, Tensor, Tensor]:
        """The box cube's K2 body, ``cube_adjoint.cuh``'s ``cube_loss_vjp``,
        in float64: ``dp`` per sample ``(B, 15)``, ``dxin`` and ``dxp``
        ``(13, B)``."""
        return _cube_vjp(self._lib, pvec, xin, xp, force, valid, ct, dt)

    def vjp(self, model, pvec: Tensor, xin: Tensor, xp: Tensor,
            force: Tensor, valid: Tensor, ct: Tensor, dt: float
            ) -> Tuple[Tensor, Tensor, Tensor]:
        """K2's body (``model_adjoint.cuh``'s reverse-mode sweep) in
        float64: ``dp`` per sample ``(B, P)``, ``dxin`` and ``dxp`` shaped
        as the inputs."""
        name, desc = self._desc(model)
        n = xin.shape[1]
        ins = [self._array(t, np.float64) for t in (pvec, xin, xp, force)]
        ins += [self._array(valid, np.uint8), self._array(ct, np.float64)]
        outs = [np.zeros((n, pvec.numel())), np.zeros(tuple(xin.shape)),
                np.zeros(tuple(xp.shape))]
        getattr(self._lib, f"model_host_{name}")(
            _KINDS["vjp"], ctypes.addressof(desc), *[_ptr(a) for a in ins],
            n, dt, 0.0, 0, 0, None, None, None, *[_ptr(a) for a in outs])
        return tuple(torch.from_numpy(o) for o in outs)

    def vjp_desc_body(self, model, pvec: Tensor, xin: Tensor, xp: Tensor,
                      force: Tensor, valid: Tensor, ct: Tensor, dt: float
                      ) -> Tuple[Tensor, Tensor, Tensor]:
        """As :meth:`vjp`, with the body's joint read from the descriptor
        at a size whose kernels take it as compile-time constants
        (``kConstFreeBody`` of ``csrc/model_terms.cuh``): the sweep before
        the constants. Raises at other sizes."""
        name, desc = self._desc(model)
        n = xin.shape[1]
        ins = [self._array(t, np.float64) for t in (pvec, xin, xp, force)]
        ins += [self._array(valid, np.uint8), self._array(ct, np.float64)]
        outs = [np.zeros((n, pvec.numel())), np.zeros(tuple(xin.shape)),
                np.zeros(tuple(xp.shape))]
        if getattr(self._lib, f"model_vjp_desc_body_{name}")(
                ctypes.addressof(desc), *[_ptr(a) for a in ins], n, dt,
                *[_ptr(a) for a in outs]):
            raise ValueError(f"size {name} reads its joints from the "
                             "descriptor already")
        return tuple(torch.from_numpy(o) for o in outs)

    def count(self, kind: str, model, pvec: Tensor, xin: Tensor, xp: Tensor,
              fin: Optional[Tensor], valid: Optional[Tensor],
              ct: Optional[Tensor], dt: float, eps: float, ipm: int,
              newton: int, threads: int = 1) -> Dict:
        """The operations one body (``kind`` ``cold``, ``warm`` or
        ``vjp``; ``fin`` the previous or the saved impulse) does over the
        batch in ``xin``'s dtype (float32 or float64), on ``threads``
        threads: ``{"needed": ..., "executed": ..., "recomputed": ...}``
        (``recomputed``: the needed operations of the forward terms that
        K2's sweep computes a second time, in ``executed``, not in
        ``needed``)."""
        name, desc = self._desc(model)
        dtype = _NP[xin.dtype]
        ins = [self._array(t, dtype) for t in (pvec, xin, xp, fin)]
        ins += [self._array(valid, np.uint8), self._array(ct, dtype)]
        counts = np.zeros(len(_TALLIES), dtype=np.int64)
        getattr(self._lib, f"model_count_{name}_{_SUFFIX[xin.dtype]}")(
            _KINDS[kind], ctypes.addressof(desc), *[_ptr(a) for a in ins],
            xin.shape[1], dt, eps, ipm, newton, threads, counts.ctypes.data)
        return _tallies(counts, "needed", "executed", "recomputed")


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _ptr(array) -> Optional[int]:
    return None if array is None else array.ctypes.data
