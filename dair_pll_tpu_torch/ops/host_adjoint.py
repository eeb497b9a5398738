r"""Host builds of K2's per-sample body, ``cube_loss_vjp``
(``csrc/cube_adjoint.cuh``), compiled with ``g++``: the gradient in float64
(held against the plain version by the tests) and a count of the
arithmetic the sweep needs (K2's bound in ``chip_smoke.py``).

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

Negations and absolute values are free (operand modifiers on the card);
comparisons and selects are not counted; a quotient or a square root
counts one, so the count is a floor on the card's instructions.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from typing import Dict, Optional, Tuple

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
using std::isfinite, std::isinf, std::isnan, std::sqrt, std::fabs;
"""

#: The counting scalar. ``constant`` marks a constant of the code (built
#: from a literal, or a product with a structural zero), as opposed to a
#: value of the data.
COUNTED = r"""#pragma once
#include <cmath>
#include <type_traits>

struct Tally {
  long long needed = 0, executed = 0;
};
// One tally per thread; initial-exec keeps its address a register read.
static thread_local Tally tally __attribute__((tls_model("initial-exec")));

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

#: Batch entry points over batch-minor inputs: the float64 gradient
#: (``dp`` per sample, ``(B, 15)``) and the counts.
BATCH = r"""#include <thread>
#include <vector>

#include "counted.h"
#include "cube_adjoint.cuh"

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


def compiler() -> Optional[str]:
    """The host C++ compiler, or None."""
    return shutil.which("g++") or shutil.which("c++")


class HostAdjoint:
    """``cube_loss_vjp`` built for the host into ``work_dir``."""

    def __init__(self, work_dir: str):
        cxx = compiler()
        if cxx is None:
            raise RuntimeError("no host C++ compiler (g++ or c++) found")
        os.makedirs(work_dir, exist_ok=True)
        for name, text in (("cuda_runtime.h", SHIM), ("counted.h", COUNTED),
                           ("batch.cpp", BATCH)):
            with open(os.path.join(work_dir, name), "w") as handle:
                handle.write(text)
        library = os.path.join(work_dir, "libcube_adjoint_host.so")
        proc = subprocess.run(
            [cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-pthread",
             "-shared", "-fPIC", f"-I{work_dir}",
             f"-I{soa_kernels.SOURCE_DIR}",
             os.path.join(work_dir, "batch.cpp"), "-o", library],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed to build cube_loss_vjp:\n"
                               f"{proc.stdout}{proc.stderr}")
        self._lib = ctypes.CDLL(library)
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
        n = xin.shape[1]
        ins = self._arrays(np.float64, pvec, xin, xp, force, valid, ct)
        outs = [np.zeros((n, 15)), np.zeros((13, n)), np.zeros((13, n))]
        self._lib.cube_loss_vjp_f64(*[a.ctypes.data for a in ins], n, dt,
                                    *[a.ctypes.data for a in outs])
        return tuple(torch.from_numpy(o) for o in outs)

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
