r"""The port's CUDA kernel library, and the hybrid cone-solve kernels.

Every source under ``dair_pll_tpu_torch/csrc/`` builds into one shared
library at first use: ``nvcc`` compiles each ``.cu`` file (all started
together), links them into ``build/kernels/`` (listed in ``.gitignore``),
and ``ctypes`` binds their plain C entry points. The library's file name
carries a hash of every file under ``csrc/`` (headers included), the
compiler's path and its flags, so a change to any of them builds anew.

The warm hybrid solve kernel here is the counterpart of
``dair_pll_tpu/ops/soa_pallas.py``'s ``solve_warm_hybrid_soa_pallas`` (the
TPU kernel ``_warm_kernel``): the whole solve of
``ops/soa_solver.solve_warm_hybrid_soa`` runs in one launch of
``csrc/warm_hybrid_solve.cu``, on 4 lanes of a warp per sample at the
cube's ``(n_v, k)`` and at the elbow's (at the cube's, large float32
batches one CUDA thread per sample). For tensors on
the CPU the wrapper calls the plain version in ``ops/soa_solver.py``; for
CUDA tensors it launches the kernel or raises.
``solve_warm_hybrid_soa_cuda.launches`` counts launches, and
``launches_by`` counts them by instantiation: ``(n_v, k)`` is ``(6, 4)``
(the cube) or ``(7, 8)`` (the elbow), each in float32 and float64.

The cold hybrid solve kernel is the counterpart of
``solve_contact_impulse_soa_pallas`` (the TPU kernel ``_kernel``): the
whole of ``ops/soa_solver.solve_contact_impulse_soa`` in one launch of
``csrc/cold_hybrid_solve.cu``, with the same routing;
``solve_contact_impulse_soa_cuda.launches`` (and ``launches_by``) counts
its launches. The
ContactNets loss kernels' wrappers are in ``ops/soa_loss_kernels.py``,
the APGD cone solve kernel's in ``ops/cone_kernels.py``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import List, Optional, Tuple

import torch
from torch import Tensor

from dair_pll_tpu_torch.ops import soa, soa_solver

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_DIR = os.path.join(_PACKAGE_DIR, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE_DIR), "build", "kernels")

#: Problem sizes the solve kernels are instantiated for, (n_v, k): the
#: cube's and the elbow's.
KERNEL_SHAPES = ((6, 4), (7, 8))
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_ENTRY = {(n_v, k, dtype): f"warm_hybrid_solve_nv{n_v}_k{k}_{suffix}"
          for n_v, k in KERNEL_SHAPES for dtype, suffix in _SUFFIX.items()}
_COLD_ENTRY = {(n_v, k, dtype): f"cold_hybrid_solve_nv{n_v}_k{k}_{suffix}"
               for n_v, k in KERNEL_SHAPES
               for dtype, suffix in _SUFFIX.items()}
#: The model-generic ContactNets loss kernels' sizes (``csrc/
#: model_loss_{fwd,bwd}_*.cu``): name -> (bodies, n_q, n_v, plane-convex
#: pairs, witnesses per pair).
MODEL_SIZES = {"b1_q7_v6_k4": (1, 7, 6, 1, 4),
               "b2_q8_v7_k8": (2, 8, 7, 2, 4)}
_P, _I, _LL, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_double)
_FWD, _FWD_WARM, _BWD = ([_P] * 6 + [_LL, _D, _D, _I, _I, _P],
                         [_P] * 7 + [_LL, _D, _D, _I, _I, _P],
                         [_P] * 10 + [_LL, _D, _D, _P])
#: The model-generic forward entries: the descriptor's address first, and
#: after ``valid`` the scratch ``pack`` and its count of values.
_MODEL_FWD, _MODEL_FWD_WARM = (
    [_P] * 8 + [_LL, _LL, _D, _D, _I, _I, _P],
    [_P] * 9 + [_LL, _LL, _D, _D, _I, _I, _P])
#: ``ctypes`` signatures of the library's entry points: argument types and
#: return type. Pointers and the stream are ``c_void_p``; the model-generic
#: loss entries take the model descriptor's address first.
SIGNATURES = {
    **{name: ([_P] * 7 + [_LL, _D, _I, _I, _P], _I)
       for name in _ENTRY.values()},
    **{name: ([_P] * 5 + [_LL, _D, _I, _I, _P], _I)
       for name in _COLD_ENTRY.values()},
    **{f"contactnets_loss_{kind}_cube_{s}": (args, _I)
       for kind, args in (("fwd", _FWD), ("fwd_warm", _FWD_WARM),
                          ("bwd", _BWD))
       for s in _SUFFIX.values()},
    **{f"contactnets_loss_{kind}_{model}_{s}": (args, _I)
       for kind, args in (("fwd", _MODEL_FWD),
                          ("fwd_warm", _MODEL_FWD_WARM),
                          ("bwd", [_P] + _BWD))
       for model in MODEL_SIZES for s in _SUFFIX.values()},
    "contactnets_loss_bwd_scratch": ([_LL], _LL),
    "model_loss_bwd_scratch": ([_LL, _I], _LL),
    **{f"apgd_cone_solve_{s}": ([_P] * 3 + [_LL, _I, _I, _P], _I)
       for s in ("f32", "f64")},
}


def count_launch(wrapper, instance: str) -> None:
    """Adds one launch to a wrapper's count, in all and for the kernel's
    instantiation (``wrapper.launches_by``, by size or model)."""
    wrapper.launches += 1
    wrapper.launches_by[instance] = wrapper.launches_by.get(instance, 0) + 1


def reset_launches(wrapper) -> None:
    """Sets a wrapper's launch counts to 0."""
    wrapper.launches = 0
    wrapper.launches_by = {}


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
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


#: ``nvcc`` flags of each source's compile. No fast math: the solver
#: relies on ``isfinite``, NaN comparisons and the ``|f| > 1e3`` failure
#: mask. No contraction into fused multiply-adds either (``-fmad=false``):
#: the plain versions round every product and sum on their own, and the
#: line search amplifies one-ulp differences.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: Flags of the link into one shared library.
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")


def _sources(source_dir: str) -> List[str]:
    return sorted(os.path.join(source_dir, name)
                  for name in os.listdir(source_dir) if name.endswith(".cu"))


def library_path(source_dir: str = SOURCE_DIR,
                 nvcc: Optional[str] = None) -> str:
    """Where the library built from ``source_dir`` lives: its name hashes
    every file under ``source_dir`` (names and bytes), the compiler's path
    and the flags."""
    hasher = hashlib.sha256()
    for root, dirs, files in os.walk(source_dir):
        dirs.sort()
        for name in sorted(files):
            path = os.path.join(root, name)
            hasher.update(os.path.relpath(path, source_dir).encode() + b"\0")
            with open(path, "rb") as handle:
                hasher.update(handle.read() + b"\0")
    hasher.update("\0".join((nvcc or _nvcc(),) + NVCC_FLAGS + LINK_FLAGS)
                  .encode())
    return os.path.join(_BUILD_DIR,
                        f"libdair_pll_kernels_{hasher.hexdigest()[:16]}.so")


def _build(path: str) -> str:
    """Compiles every source at once (one ``nvcc`` each), then links them
    into ``path``; returns the compilers' output, each source's headed by
    its name and the seconds its compile took."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as work:
        procs = []
        start = time.perf_counter()
        for source in _sources(SOURCE_DIR):
            obj = os.path.join(work, os.path.basename(source) + ".o")
            out = open(obj + ".log", "w+")
            procs.append((source, obj, out, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, source],
                stdout=out, stderr=subprocess.STDOUT, text=True)))
        seconds = {}
        while len(seconds) < len(procs):
            for source, _, _, proc in procs:
                if source not in seconds and proc.poll() is not None:
                    seconds[source] = time.perf_counter() - start
            time.sleep(0.05)
        log = []
        failed = []
        for source, _, out, proc in procs:
            out.seek(0)
            log.append(f"== {os.path.basename(source)} "
                       f"({seconds[source]:.1f} s)\n{out.read()}")
            out.close()
            if proc.returncode != 0:
                failed.append(source)
        if failed:
            raise RuntimeError(f"nvcc failed to build {failed}:\n"
                               + "\n".join(log))
        tmp = os.path.join(work, "lib.so")
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", tmp,
                               *(obj for _, obj, _, _ in procs)],
                              capture_output=True, text=True, check=False)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link the kernel library:\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(tmp, path)
    return "\n".join(log)


def load_library() -> ctypes.CDLL:
    """Builds (if needed) and loads the kernel library."""
    if _Library.lib is not None:
        return _Library.lib
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        _Library.build_log = _build(path)
    lib = ctypes.CDLL(path)
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _Library.lib = lib
    return lib


def build_log() -> str:
    """``nvcc``'s output (with ``ptxas``'s register and spill report)
    from this process's build; empty when the library was already built."""
    return _Library.build_log


def check_tensor(name: str, t: Tensor, shape, dtype, device) -> None:
    """Raises unless ``t`` has the device, dtype and shape a kernel takes
    and is contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def on_cpu(*tensors: Tensor) -> bool:
    """The route of a wrapper's call: ``True`` (the plain version) when
    every tensor lies on the CPU, ``False`` (the kernel) when every tensor
    lies on one CUDA card; raises for a mix of devices or another kind."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("a kernel's inputs lie on several devices: "
                         f"{sorted(str(d) for d in devices)}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device.type == "cpu"


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


def _check_qp(m: Tensor, jc: Tensor, qc: Tensor) -> Tuple[int, int, int]:
    """Raises unless the solve kernels take this packed QP; returns
    ``(n_v, k, B)``."""
    if jc.dim() != 4:
        raise ValueError(f"jc has shape {tuple(jc.shape)}, expected "
                         "(3, n_v, k, B)")
    _, n_v, k, B = jc.shape
    if (n_v, k) not in KERNEL_SHAPES:
        raise ValueError(f"no kernel for (n_v, k) = {(n_v, k)}; built for "
                         f"{KERNEL_SHAPES} (other sizes: ROADMAP.md, Queue "
                         "2)")
    dtype = m.dtype
    if dtype not in _SUFFIX:
        raise TypeError(f"no kernel for dtype {dtype}")
    check_tensor("m", m, (n_v * n_v, B), dtype, m.device)
    check_tensor("jc", jc, (3, n_v, k, B), dtype, m.device)
    check_tensor("qc", qc, (3, k, B), dtype, m.device)
    return n_v, k, B


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
    on the current stream (float32 or float64, ``(n_v, k)`` in
    ``KERNEL_SHAPES``, contiguous) or raise."""
    if on_cpu(m, jc, qc, w0):
        return plain_packed(m, jc, qc, w0, eps, ipm_iterations,
                            newton_iterations)
    n_v, k, B = _check_qp(m, jc, qc)
    dtype = m.dtype
    check_tensor("w0", w0, (n_v, B), dtype, m.device)

    force = torch.empty((3, k, B), dtype=dtype, device=m.device)
    w = torch.empty((n_v, B), dtype=dtype, device=m.device)
    valid = torch.empty((B,), dtype=torch.bool, device=m.device)
    if B == 0:
        return force, w, valid
    fn = getattr(load_library(), _ENTRY[n_v, k, dtype])
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(m.data_ptr(), jc.data_ptr(), qc.data_ptr(), w0.data_ptr(),
                 force.data_ptr(), w.data_ptr(), valid.data_ptr(), B,
                 float(eps), int(ipm_iterations), int(newton_iterations),
                 stream)
    if err != 0:
        raise RuntimeError(f"warm hybrid solve kernel launch failed: CUDA "
                           f"error {err}")
    count_launch(solve_warm_hybrid_soa_cuda, f"nv{n_v}_k{k}")
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


reset_launches(solve_warm_hybrid_soa_cuda)


def plain_packed_cold(m: Tensor, jc: Tensor, qc: Tensor, eps: float,
                      ipm_iterations: int, newton_iterations: int
                      ) -> Tuple[Tensor, Tensor]:
    """The plain PyTorch version of the cold solve kernel on the packed
    layout of :func:`solve_contact_impulse_soa_cuda_packed`, on any
    device."""
    M, Jc = unpack_qp(m, jc)
    force, valid = soa_solver.solve_contact_impulse_soa(
        M, Jc, soa.unstack(qc), eps, ipm_iterations, newton_iterations)
    return torch.stack(force), valid


def solve_contact_impulse_soa_cuda_packed(
        m: Tensor, jc: Tensor, qc: Tensor, eps: float, ipm_iterations: int,
        newton_iterations: int) -> Tuple[Tensor, Tensor]:
    """Packed-tensor entry of the cold hybrid solve: ``m (n_v*n_v, B)``,
    ``jc (3, n_v, k, B)``, ``qc (3, k, B)`` -> ``force (3, k, B)``,
    ``valid (B,)`` bool.

    CPU tensors go to the plain version; CUDA tensors launch the kernel
    on the current stream (float32 or float64, ``(n_v, k)`` in
    ``KERNEL_SHAPES``, contiguous) or raise."""
    if on_cpu(m, jc, qc):
        return plain_packed_cold(m, jc, qc, eps, ipm_iterations,
                                 newton_iterations)
    n_v, k, B = _check_qp(m, jc, qc)
    force = torch.empty((3, k, B), dtype=m.dtype, device=m.device)
    valid = torch.empty((B,), dtype=torch.bool, device=m.device)
    if B == 0:
        return force, valid
    fn = getattr(load_library(), _COLD_ENTRY[n_v, k, m.dtype])
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(m.data_ptr(), jc.data_ptr(), qc.data_ptr(),
                 force.data_ptr(), valid.data_ptr(), B, float(eps),
                 int(ipm_iterations), int(newton_iterations), stream)
    if err != 0:
        raise RuntimeError(f"cold hybrid solve kernel launch failed: CUDA "
                           f"error {err}")
    count_launch(solve_contact_impulse_soa_cuda, f"nv{n_v}_k{k}")
    return force, valid


def solve_contact_impulse_soa_cuda(M, Jc, qc, eps: float,
                                   ipm_iterations: int,
                                   newton_iterations: int):
    """Same inputs and outputs as the JAX package's
    ``solve_contact_impulse_soa_pallas``, but for the ``(B,)`` valid mask
    (JAX's is ``(1, B)``): ``M`` an ``(n_v, n_v)`` nested list of ``(B,)``
    leaves, ``Jc`` ``(3, n_v)`` of ``(k, B)``, ``qc`` a cone field of
    ``(k, B)``. Returns ``(force cone field, valid (B,))``."""
    force, valid = solve_contact_impulse_soa_cuda_packed(
        *pack_qp(M, Jc, qc), eps, ipm_iterations, newton_iterations)
    return soa.unstack(force), valid


reset_launches(solve_contact_impulse_soa_cuda)
