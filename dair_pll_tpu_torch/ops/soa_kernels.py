r"""The port's CUDA kernels, built at first use, and the hybrid cone-solve
kernels.

Every kernel is instantiated for the size it meets, at first use: the
wrapper names the instantiation (an :class:`Instance`: a few lines of
generated CUDA that include a header of ``dair_pll_tpu_torch/csrc/`` and
instantiate its templates for one size and type), ``nvcc`` compiles it
into a shared library of its own under ``build/kernels/`` (listed in
``.gitignore``), and ``ctypes`` binds its plain C entry points. The
library's file name carries a hash of every file under ``csrc/`` (headers
included), the compiler's path, its flags and the generated source, so a
change to any of them builds anew. :func:`build_instances` builds many at
once (one ``nvcc`` each, all started together); a file lock keeps two
processes from building one library twice. A build or a launch that fails
raises: no size runs the plain version on the card.

The warm hybrid solve kernel here is the counterpart of
``dair_pll_tpu/ops/soa_pallas.py``'s ``solve_warm_hybrid_soa_pallas`` (the
TPU kernel ``_warm_kernel``): the whole solve of
``ops/soa_solver.solve_warm_hybrid_soa`` runs in one launch of
``csrc/warm_hybrid_solve.cuh`` at any ``(n_v, k)``, on 4 or 2 lanes of a
warp per sample where the contacts split evenly (the cube's (6, 4), the
elbow's (7, 8)), else one thread a sample (at the cube's size, large
float32 batches one thread a sample too). For tensors on the CPU the
wrapper calls the plain version in ``ops/soa_solver.py``; for CUDA tensors
it launches the kernel or raises. ``solve_warm_hybrid_soa_cuda.launches``
counts launches, and ``launches_by`` counts them by instantiation,
``f"nv{n_v}_k{k}"``.

The cold hybrid solve kernel is the counterpart of
``solve_contact_impulse_soa_pallas`` (the TPU kernel ``_kernel``): the
whole of ``ops/soa_solver.solve_contact_impulse_soa`` in one launch of
``csrc/cold_hybrid_solve.cuh``, with the same routing;
``solve_contact_impulse_soa_cuda.launches`` (and ``launches_by``) counts
its launches. The
ContactNets loss kernels' wrappers are in ``ops/soa_loss_kernels.py``,
the APGD cone solve kernel's in ``ops/cone_kernels.py``.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from dair_pll_tpu_torch.ops import soa, soa_solver

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_DIR = os.path.join(_PACKAGE_DIR, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE_DIR), "build", "kernels")

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_CTYPE = {torch.float32: "float", torch.float64: "double"}
_P, _I, _LL, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_double)
_WARM_ARGS = [_P] * 7 + [_LL, _D, _I, _I, _P]
_COLD_ARGS = [_P] * 5 + [_LL, _D, _I, _I, _P]


class Instance(NamedTuple):
    """One instantiation of a kernel: its name (the library's and the
    launch counts' key), the CUDA source that instantiates it, and its
    entry points' ``ctypes`` signatures (argument types, return type)."""
    name: str
    text: str
    entries: Tuple[Tuple[str, tuple, object], ...]


def warm_instance(n_v: int, k: int, dtype) -> Instance:
    """K5 at ``(n_v, k)`` in ``dtype``."""
    name = f"warm_hybrid_solve_nv{n_v}_k{k}_{_SUFFIX[dtype]}"
    return Instance(name, '#include "warm_hybrid_solve.cuh"\n'
                    f"DEFINE_ENTRY({n_v}, {k}, {_CTYPE[dtype]}, "
                    f"{_SUFFIX[dtype]})\n",
                    ((name, tuple(_WARM_ARGS), _I),))


def cold_instance(n_v: int, k: int, dtype) -> Instance:
    """K4 at ``(n_v, k)`` in ``dtype``."""
    name = f"cold_hybrid_solve_nv{n_v}_k{k}_{_SUFFIX[dtype]}"
    return Instance(name, '#include "cold_hybrid_solve.cuh"\n'
                    f"DEFINE_ENTRY({n_v}, {k}, {_CTYPE[dtype]}, "
                    f"{_SUFFIX[dtype]})\n",
                    ((name, tuple(_COLD_ARGS), _I),))


def count_launch(wrapper, instance: str) -> None:
    """Adds one launch to a wrapper's count, in all and for the kernel's
    instantiation (``wrapper.launches_by``, by size or model)."""
    wrapper.launches += 1
    wrapper.launches_by[instance] = wrapper.launches_by.get(instance, 0) + 1


def reset_launches(wrapper) -> None:
    """Sets a wrapper's launch counts to 0."""
    wrapper.launches = 0
    wrapper.launches_by = {}


class _Built:
    """This process's loaded libraries (by instance name) and its builds'
    readings: seconds and ``nvcc``'s output, ``ptxas``'s register and
    spill report included."""
    libraries: Dict[str, ctypes.CDLL] = {}
    builds: Dict[str, dict] = {}


def _nvcc() -> str:
    for candidate in (shutil.which("nvcc"),
                      os.path.join(os.environ.get("CUDA_HOME",
                                                  "/usr/local/cuda"),
                                   "bin", "nvcc")):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


#: ``nvcc`` flags of each instantiation's build into a shared library. No
#: fast math: the solver relies on ``isfinite``, NaN comparisons and the
#: ``|f| > 1e3`` failure mask. No contraction into fused multiply-adds
#: either (``-fmad=false``): the plain versions round every product and
#: sum on their own, and the line search amplifies one-ulp differences.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-shared")


def library_path(instance: Instance, source_dir: str = SOURCE_DIR,
                 nvcc: Optional[str] = None) -> str:
    """Where the library of an instantiation built from ``source_dir``
    lives: its name hashes every file under ``source_dir`` (names and
    bytes), the compiler's path, the flags and the instantiation's
    source."""
    hasher = hashlib.sha256()
    for root, dirs, files in os.walk(source_dir):
        dirs.sort()
        for name in sorted(files):
            path = os.path.join(root, name)
            hasher.update(os.path.relpath(path, source_dir).encode() + b"\0")
            with open(path, "rb") as handle:
                hasher.update(handle.read() + b"\0")
    hasher.update("\0".join((nvcc or _nvcc(),) + NVCC_FLAGS).encode())
    hasher.update(b"\0" + instance.text.encode())
    return os.path.join(_BUILD_DIR,
                        f"lib{instance.name}_{hasher.hexdigest()[:16]}.so")


def build_instances(instances: Iterable[Instance],
                    jobs: Optional[int] = None) -> Dict[str, dict]:
    """Builds the libraries of those ``instances`` not built yet, at most
    ``jobs`` ``nvcc`` processes at a time (all the card machine's cores by
    default); returns each build's seconds and ``nvcc``'s output by
    instance name (also kept for :func:`build_log`). Raises if any build
    fails."""
    nvcc = _nvcc()
    todo = {inst.name: inst for inst in instances}
    os.makedirs(_BUILD_DIR, exist_ok=True)
    paths = {name: library_path(inst, SOURCE_DIR, nvcc)
             for name, inst in todo.items()}
    locks = []
    try:
        for name in sorted(todo):
            handle = open(paths[name] + ".lock", "w")
            fcntl.flock(handle, fcntl.LOCK_EX)
            locks.append(handle)
        missing = [name for name in sorted(todo)
                   if not os.path.exists(paths[name])]
        readings = _compile(nvcc, [todo[n] for n in missing],
                            [paths[n] for n in missing],
                            jobs or os.cpu_count() or 1)
    finally:
        for handle in locks:
            fcntl.flock(handle, fcntl.LOCK_UN)
            handle.close()
    _Built.builds.update(readings)
    return readings


def _compile(nvcc: str, instances: List[Instance], paths: List[str],
             jobs: int) -> Dict[str, dict]:
    readings, failed = {}, []
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as work:
        pending = list(zip(instances, paths))
        running = []
        start = time.perf_counter()
        while pending or running:
            while pending and len(running) < jobs:
                inst, path = pending.pop(0)
                source = os.path.join(work, inst.name + ".cu")
                with open(source, "w", encoding="utf-8") as handle:
                    handle.write(inst.text)
                out = open(source + ".log", "w+")
                tmp = os.path.join(work, inst.name + ".so")
                running.append((inst, path, tmp, out, time.perf_counter(),
                                subprocess.Popen(
                                    [nvcc, *NVCC_FLAGS, "-I", SOURCE_DIR,
                                     "-o", tmp, source],
                                    stdout=out, stderr=subprocess.STDOUT,
                                    text=True)))
            time.sleep(0.05)
            for entry in [e for e in running if e[-1].poll() is not None]:
                running.remove(entry)
                inst, path, tmp, out, began, proc = entry
                out.seek(0)
                readings[inst.name] = {
                    "seconds": time.perf_counter() - began,
                    "since_start": time.perf_counter() - start,
                    "log": out.read()}
                out.close()
                if proc.returncode != 0:
                    failed.append(inst.name)
                else:
                    os.replace(tmp, path)
    if failed:
        raise RuntimeError(f"nvcc failed to build {failed}:\n" + "\n".join(
            f"== {name}\n{readings[name]['log']}" for name in failed))
    return readings


def instance_library(instance: Instance) -> ctypes.CDLL:
    """The loaded library of an instantiation, built first if needed."""
    lib = _Built.libraries.get(instance.name)
    if lib is not None:
        return lib
    path = library_path(instance)
    if not os.path.exists(path):
        build_instances([instance])
    lib = ctypes.CDLL(path)
    for name, argtypes, restype in instance.entries:
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    _Built.libraries[instance.name] = lib
    return lib


def entry(instance: Instance, name: Optional[str] = None):
    """An entry point of an instantiation (its first by default)."""
    return getattr(instance_library(instance),
                   name or instance.entries[0][0])


def build_log() -> str:
    """``nvcc``'s output (with ``ptxas``'s register and spill report) of
    this process's builds, each headed ``== <instance> (<seconds> s)``;
    empty for libraries that were already built."""
    return "\n".join(f"== {name} ({reading['seconds']:.1f} s)\n"
                     f"{reading['log']}"
                     for name, reading in _Built.builds.items())


def build_readings() -> Dict[str, dict]:
    """This process's builds: seconds and ``nvcc``'s output by instance."""
    return dict(_Built.builds)


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
    if n_v < 1 or k < 1:
        raise ValueError(f"no kernel for (n_v, k) = {(n_v, k)}")
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
    on the current stream (float32 or float64, any ``(n_v, k)``, built at
    first use; contiguous) or raise."""
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
    fn = entry(warm_instance(n_v, k, dtype))
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
    on the current stream (float32 or float64, any ``(n_v, k)``, built at
    first use; contiguous) or raise."""
    if on_cpu(m, jc, qc):
        return plain_packed_cold(m, jc, qc, eps, ipm_iterations,
                                 newton_iterations)
    n_v, k, B = _check_qp(m, jc, qc)
    force = torch.empty((3, k, B), dtype=m.dtype, device=m.device)
    valid = torch.empty((B,), dtype=torch.bool, device=m.device)
    if B == 0:
        return force, valid
    fn = entry(cold_instance(n_v, k, m.dtype))
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
