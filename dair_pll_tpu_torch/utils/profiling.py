r"""Tracing and wall-clock profiling utilities (PyTorch).

Counterpart of ``dair_pll_tpu/utils/profiling.py``: the per-epoch
durations flow through the experiment logger; these are the instruments
around them.

* :class:`Timer`: an accumulating wall-clock section timer.
* :func:`trace`: a ``torch.profiler`` trace of host and, on the card,
  device activity, written as a Chrome trace into ``log_dir``.
* :func:`device_timeit`: median seconds of a callable, synchronising the
  card after each call.

The JAX package's ``utils/cache.py`` turns on JAX's persistent compile
cache; the port's counterpart is the kernel library's build directory,
named by a hash of every kernel source (``ops/soa_kernels.py``).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict

import torch


class Timer:
    """Accumulating wall-clock timer for named sections."""

    def __init__(self) -> None:
        self.durations: Dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        start = time.monotonic()
        try:
            yield
        finally:
            self.durations[name] = (self.durations.get(name, 0.0) +
                                    time.monotonic() - start)


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Records a ``torch.profiler`` trace of the block into
    ``log_dir/trace.json`` (CUDA activity too when a card is present);
    yields the profiler, or ``None`` when disabled."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as profiler:
        yield profiler
    profiler.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_timeit(fn: Callable[[], Any], n: int = 8,
                  warmup: int = 1) -> float:
    """Median wall-clock seconds of ``fn()``, the card synchronised after
    each call (CUDA launches return before the work is done)."""

    def force():
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    for _ in range(warmup):
        force()
    times = []
    for _ in range(n):
        start = time.monotonic()
        force()
        times.append(time.monotonic() - start)
    times.sort()
    return times[len(times) // 2]
