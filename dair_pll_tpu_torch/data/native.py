r"""ctypes bindings for the native (C++) trajectory slicer.

A copy of ``dair_pll_tpu/data/native.py`` (it imports no JAX); it loads
the same ``native/libdairslicer.so`` at the root of the checkout.

Loads ``native/libdairslicer.so`` (building it on first use if a compiler
is available) and exposes :func:`slice_trajectories_native` with the same
contract as the pure-Python
:func:`dair_pll_tpu_torch.data.management.slice_trajectories`. Falls back
to the Python implementation when the native library cannot be built.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libdairslicer.so")

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _load() -> Optional[ctypes.CDLL]:
    """Loads (building if needed) the native library; None on failure."""
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    try:
        if not os.path.exists(_LIB_PATH):
            subprocess.run(
                ["sh", os.path.join(_NATIVE_DIR, "build.sh")],
                check=True, capture_output=True)
        lib = ctypes.CDLL(_LIB_PATH)
        i64 = ctypes.c_int64
        p_i64 = ctypes.POINTER(ctypes.c_int64)
        p_f32 = ctypes.POINTER(ctypes.c_float)
        lib.slice_count.restype = i64
        lib.slice_count.argtypes = [p_i64, i64, i64, i64, i64]
        lib.slice_trajectories.restype = None
        lib.slice_trajectories.argtypes = [
            p_f32, p_i64, p_i64, i64, i64, i64, i64, i64, p_f32, p_f32,
            i64]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def native_available() -> bool:
    """Whether the native slicer is usable on this host."""
    return _load() is not None


def slice_trajectories_native(
        trajectories: Sequence[np.ndarray], t_skip: int, t_history: int,
        t_prediction: int,
        n_threads: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Native-threaded version of
    :func:`dair_pll_tpu_torch.data.management.slice_trajectories`.

    Args / Returns: identical to the Python version.

    Raises:
        RuntimeError: if the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native slicer unavailable")
    if not trajectories:
        raise ValueError("no trajectories")
    n_x = trajectories[0].shape[-1]
    lengths = np.asarray([t.shape[0] for t in trajectories],
                         dtype=np.int64)
    offsets = np.zeros(len(trajectories), dtype=np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    data = np.ascontiguousarray(
        np.concatenate([np.asarray(t, np.float32) for t in trajectories],
                       axis=0))

    n_slices = int(lib.slice_count(
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(trajectories), t_skip, t_history, t_prediction))
    past = np.empty((n_slices, t_history, n_x), np.float32)
    future = np.empty((n_slices, t_prediction, n_x), np.float32)
    if n_threads is None:
        n_threads = min(16, os.cpu_count() or 1)

    p_f32 = ctypes.POINTER(ctypes.c_float)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    lib.slice_trajectories(
        data.ctypes.data_as(p_f32), offsets.ctypes.data_as(p_i64),
        lengths.ctypes.data_as(p_i64), len(trajectories), n_x, t_skip,
        t_history, t_prediction, past.ctypes.data_as(p_f32),
        future.ctypes.data_as(p_f32), n_threads)
    return past, future
