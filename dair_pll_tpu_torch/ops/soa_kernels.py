r"""Hand-written CUDA kernel for the warm-started hybrid cone solve.

Counterpart of ``dair_pll_tpu/ops/soa_pallas.py``'s
``solve_warm_hybrid_soa_pallas`` (the TPU kernel ``_warm_kernel``): the
whole solve of ``ops/soa_solver.solve_warm_hybrid_soa`` runs in one launch
of ``csrc/warm_hybrid_solve.cu``, one CUDA thread per sample.

The kernel is built at first use from the repository's source with
``nvcc`` into ``build/kernels/`` (listed in ``.gitignore``) and bound with
``ctypes``. For tensors on the CPU the wrapper calls the plain version in
``ops/soa_solver.py``; for CUDA tensors it launches the kernel or raises.
``solve_warm_hybrid_soa_cuda.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import List, Optional, Tuple

import torch
from torch import Tensor

from dair_pll_tpu_torch.ops import soa, soa_solver

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PACKAGE_DIR, "csrc", "warm_hybrid_solve.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE_DIR), "build", "kernels")

#: Problem sizes the kernel is instantiated for: (n_v, k) of the cube.
KERNEL_SHAPES = ((6, 4),)
_ENTRY = {torch.float32: "warm_hybrid_solve_nv6_k4_f32",
          torch.float64: "warm_hybrid_solve_nv6_k4_f64"}


class _Library:
    """The built shared library; loaded once per process."""
    lib: Optional[ctypes.CDLL] = None
    build_log: str = ""


def _nvcc() -> str:
    for candidate in (shutil.which("nvcc"),
                      os.path.join(os.environ.get("CUDA_HOME",
                                                  "/usr/local/cuda"),
                                   "bin", "nvcc")):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernel cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


#: ``nvcc`` flags. No fast math: the solver relies on ``isfinite``, NaN
#: comparisons and the ``|f| > 1e3`` failure mask. No contraction into
#: fused multiply-adds either (``-fmad=false``): the plain version rounds
#: every product and sum on its own, and the line search amplifies
#: one-ulp differences.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def build_command(output: str) -> List[str]:
    """The ``nvcc`` command that builds the kernel library."""
    return [_nvcc(), *NVCC_FLAGS, "-o", output, _SOURCE]


def load_library() -> ctypes.CDLL:
    """Builds (if needed) and loads the kernel library. The file name
    carries a hash of the source, the compiler's path and its flags, so a
    change to any of them is rebuilt."""
    if _Library.lib is not None:
        return _Library.lib
    hasher = hashlib.sha256()
    with open(_SOURCE, "rb") as handle:
        hasher.update(handle.read())
    hasher.update("\0".join((_nvcc(),) + NVCC_FLAGS).encode())
    digest = hasher.hexdigest()[:16]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    path = os.path.join(_BUILD_DIR, f"libwarm_hybrid_solve_{digest}.so")
    if not os.path.exists(path):
        tmp = f"{path}.tmp.{os.getpid()}"
        proc = subprocess.run(build_command(tmp), capture_output=True,
                              text=True, check=False)
        _Library.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed to build "
                               f"{_SOURCE}:\n{_Library.build_log}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_longlong, ctypes.c_double, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    _Library.lib = lib
    return lib


def build_log() -> str:
    """``nvcc``'s output (with ``ptxas``'s register and spill report)
    from this process's build; empty when the library was already built."""
    return _Library.build_log


def _check(name: str, t: Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def pack_qp(M, Jc, qc) -> Tuple[Tensor, Tensor, Tensor]:
    """Nested-list QP -> the kernel's packed layout: ``m (n_v*n_v, B)``,
    ``jc (3, n_v, k, B)``, ``qc (3, k, B)``; one copy each."""
    n_v = len(M)
    k, B = qc[0].shape
    m = torch.stack([M[i][j].expand(B) for i in range(n_v)
                     for j in range(n_v)])
    jc = torch.stack([Jc[i][v] for i in range(3)
                      for v in range(n_v)]).reshape(3, n_v, k, B)
    return m, jc, torch.stack(list(qc))


def unpack_qp(m: Tensor, jc: Tensor):
    """Packed ``m`` and ``jc`` -> nested lists of views (no copy):
    ``M`` ``(n_v, n_v)`` of ``(B,)``, ``Jc`` ``(3, n_v)`` of ``(k, B)``."""
    n_v = jc.shape[1]
    return ([[m[i * n_v + j] for j in range(n_v)] for i in range(n_v)],
            [[jc[i, v] for v in range(n_v)] for i in range(3)])


def plain_packed(m: Tensor, jc: Tensor, qc: Tensor, w0: Tensor, eps: float,
                 ipm_iterations: int, newton_iterations: int
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """The plain PyTorch version of the kernel on the packed layout of
    :func:`solve_warm_hybrid_soa_cuda_packed`, on any device."""
    M, Jc = unpack_qp(m, jc)
    force, w, valid = soa_solver.solve_warm_hybrid_soa(
        M, Jc, soa.unstack(qc), soa.unstack(w0), eps, ipm_iterations,
        newton_iterations)
    return torch.stack(force), torch.stack(w), valid


def solve_warm_hybrid_soa_cuda_packed(
        m: Tensor, jc: Tensor, qc: Tensor, w0: Tensor, eps: float,
        ipm_iterations: int, newton_iterations: int
        ) -> Tuple[Tensor, Tensor, Tensor]:
    """Packed-tensor entry: ``m (n_v*n_v, B)``, ``jc (3, n_v, k, B)``,
    ``qc (3, k, B)``, ``w0 (n_v, B)`` -> ``force (3, k, B)``,
    ``w (n_v, B)``, ``valid (B,)`` bool.

    CPU tensors go to the plain version; CUDA tensors launch the kernel
    on the current stream (float32 or float64, ``(n_v, k) = (6, 4)``,
    contiguous) or raise."""
    if m.device.type == "cpu":
        return plain_packed(m, jc, qc, w0, eps, ipm_iterations,
                            newton_iterations)
    if m.device.type != "cuda":
        raise ValueError(f"unsupported device {m.device}")
    n_v, B = w0.shape
    k = qc.shape[1]
    if (n_v, k) not in KERNEL_SHAPES:
        raise ValueError(f"no kernel for (n_v, k) = {(n_v, k)}; built for "
                         f"{KERNEL_SHAPES}")
    dtype = m.dtype
    if dtype not in _ENTRY:
        raise TypeError(f"no kernel for dtype {dtype}")
    _check("m", m, (n_v * n_v, B), dtype, m.device)
    _check("jc", jc, (3, n_v, k, B), dtype, m.device)
    _check("qc", qc, (3, k, B), dtype, m.device)
    _check("w0", w0, (n_v, B), dtype, m.device)

    force = torch.empty((3, k, B), dtype=dtype, device=m.device)
    w = torch.empty((n_v, B), dtype=dtype, device=m.device)
    valid = torch.empty((B,), dtype=torch.bool, device=m.device)
    if B == 0:
        return force, w, valid
    fn = getattr(load_library(), _ENTRY[dtype])
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(m.data_ptr(), jc.data_ptr(), qc.data_ptr(), w0.data_ptr(),
                 force.data_ptr(), w.data_ptr(), valid.data_ptr(), B,
                 float(eps), int(ipm_iterations), int(newton_iterations),
                 stream)
    if err != 0:
        raise RuntimeError(f"warm hybrid solve kernel launch failed: CUDA "
                           f"error {err}")
    solve_warm_hybrid_soa_cuda.launches += 1
    return force, w, valid


def solve_warm_hybrid_soa_cuda(M, Jc, qc, w_carry, eps: float,
                               ipm_iterations: int, newton_iterations: int):
    """Same inputs and outputs as the JAX package's
    ``solve_warm_hybrid_soa_pallas``: ``M`` an ``(n_v, n_v)`` nested list
    of ``(B,)`` leaves, ``Jc`` ``(3, n_v)`` of ``(k, B)``, ``qc`` a cone
    field of ``(k, B)``, ``w_carry`` an svec of ``(B,)``. Returns
    ``(force cone field, w svec, valid (B,))``."""
    m, jc, qc_packed = pack_qp(M, Jc, qc)
    B = qc_packed.shape[-1]
    w0 = torch.stack([w.reshape(-1).expand(B) for w in w_carry])
    force, w, valid = solve_warm_hybrid_soa_cuda_packed(
        m, jc, qc_packed, w0, eps, ipm_iterations, newton_iterations)
    return soa.unstack(force), soa.unstack(w), valid


solve_warm_hybrid_soa_cuda.launches = 0
