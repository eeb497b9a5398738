#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dair_pll_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It imports nothing of JAX and nothing of
the JAX package, needs one CUDA card, and exits with a non-zero code,
printing no result, when there is none or when the port is not beside it.
Phases, each of which raises on failure:

1. Device: the card's name and power limit as ``nvidia-smi`` reports them.
2. Kernel against plain version: builds the warm hybrid cone-solve kernel
   (``csrc/warm_hybrid_solve.cu``) from the checkout and runs it on the
   contact QPs of a cube rollout step at 8,192 samples with the rollout
   budget (14, 6), eps = 1e-4: in float64 against the plain PyTorch
   version on the card, and in float32 against the plain float32 version,
   with the samples where the two differ decided against the plain
   float64 result. Times the kernel and the plain version with CUDA
   events and computes the kernel's bound from the bytes it moves and the
   operations the plain version counts.
3. Rollouts: ``MultibodyLearnableSystem.from_urdfs(cube)`` on the card,
   ``simulate_batch`` over 8,192 trajectories x 128 steps in float32 (the
   simulation-bench shape of the JAX package), with the kernel's launch
   count read around that run alone; the first 10 steps of 8 trajectories
   rerun in float64 on the card and on the CPU must agree. Then the
   kernels on the card per step from a ``torch.profiler`` trace, and a
   breakdown of one step's time into terms, solve and update.

It prints, in this order: one JSON line per phase, the kernel table as
one JSON line ``{"kernels": [...]}``, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

B = 8192                  # samples / trajectories
STEPS = 128               # rollout steps
DT = 0.0068               # the cube's time step
EPS = 1e-4                # dynamics regularization of the rollout solves
BUDGET = (14, 6)          # (ipm, newton) of the rollout solves
CHECK_TRAJ, CHECK_STEPS = 8, 10
#: Kernel vs plain version in float64: |kernel - plain| <= TOL64 (1 +
#: |plain|). Both round every operation in IEEE float64 in the same order
#: (the kernel is built without fused multiply-adds); what remains are the
#: order of a few sums and the last bit of rsqrt.
TOL64 = 1e-9
#: Kernel vs plain version in float32, per sample: agreement within
#: TOL32 (1 + |plain|), else the sample is a tail, decided against the
#: plain float64 result: over the tails the kernel's error from float64
#: must stay within TAIL_FACTOR times the plain float32 version's, at the
#: median and at the maximum. Float32 solves at eps = 1e-4 amplify a
#: rounding difference by up to 1/eps, so a few samples part. Both limits
#: come from the H100 readings in PERF.md: 2 tails of 8,192 in every run,
#: over which the kernel's error from float64 was 0.94 times the plain
#: version's at the median and 0.69 times at the maximum. The limits are
#: 4 times that count (8 samples) and about twice the larger ratio.
TOL32 = 1e-3
TAIL_FACTOR = 2.0
MAX_TAIL_SHARE = 1e-3
#: float64 rollout on the card vs on the CPU (the JAX package's bar for
#: its fused-vs-vmapped rollout parity).
ROLLOUT_ATOL = 1e-7
#: H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median time of ``fn()`` on the card, in ms, from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def count_operations(fn) -> int:
    """Arithmetic operations ``fn()`` performs in PyTorch: one per output
    element of each pointwise ATen operation and one per input element of
    each reduction."""
    import torch
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


def phase_device() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    line = proc.stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": line})
    return line


def build_kernels() -> None:
    from dair_pll_tpu_torch.ops import soa_kernels
    t0 = time.perf_counter()
    soa_kernels.load_library()
    ptxas = [ln.strip() for ln in soa_kernels.build_log().splitlines()
             if any(key in ln for key in ("Function properties",
                                          "registers", "spill"))]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas})


def rollout_qps(system, params, x0):
    """Packed contact QPs the main path solves at its fifth step, with the
    primal it carries from the fourth: ``(m, jc, qc, w0)``."""
    import torch
    from dair_pll_tpu_torch.multibody.learnable_system import (
        CONTACT_FILTER_EPS)
    from dair_pll_tpu_torch.multibody.soa_terms import (
        soa_forward_dynamics_batch, soa_rollout_qp)
    model = system.model
    traj = system.simulate_batch(params, x0, 4, use_fused=True)
    with torch.no_grad():
        _, w_carry = soa_forward_dynamics_batch(
            model, params, traj[:, 3], torch.zeros_like(traj[:, 0, :6]), DT,
            EPS, CONTACT_FILTER_EPS, *BUDGET)
        m, jc, qc, _, _ = soa_rollout_qp(model, params, traj[:, 4], DT)
    return m, jc, qc, w_carry.T.contiguous()


def phase_kernel(system, x0_64):
    import torch
    from dair_pll_tpu_torch.ops import soa_kernels
    kernel = soa_kernels.solve_warm_hybrid_soa_cuda_packed
    plain = soa_kernels.plain_packed

    params64 = system.initial_params(torch.float64)
    qps64 = rollout_qps(system, params64, x0_64)
    qps32 = tuple(t.float() for t in qps64)

    def run(fn, qps):
        with torch.no_grad():
            out = fn(*qps, EPS, *BUDGET)
        torch.cuda.synchronize()
        return out

    k64, p64 = run(kernel, qps64), run(plain, qps64)
    k32, p32 = run(kernel, qps32), run(plain, qps32)

    # float64: every sample, force, w and the valid mask.
    err64 = 0.0
    for got, ref in zip(k64[:2], p64[:2]):
        excess = (got - ref).abs() - TOL64 * (1 + ref.abs())
        if excess.max().item() > 0:
            raise AssertionError(
                f"float64 kernel differs from the plain version by "
                f"{(got - ref).abs().max().item():.3e}")
        err64 = max(err64, (got - ref).abs().max().item())
    if not torch.equal(k64[2], p64[2]):
        raise AssertionError("float64 valid masks differ")

    # float32: per-sample agreement, tails decided against float64.
    def per_sample(a, b):
        out = torch.zeros(B, dtype=torch.float64, device=a[0].device)
        for x, y in zip(a[:2], b[:2]):
            d = (x.double() - y.double()).abs() / (1 + y.double().abs())
            out = torch.maximum(out, d.reshape(-1, B).amax(dim=0))
        return out

    rel_k_p = per_sample(k32, p32)
    tails = (rel_k_p > TOL32) | (k32[2] != p32[2])
    n_tails = int(tails.sum().item())
    err_k = per_sample(k32, p64)[tails]
    err_p = per_sample(p32, p64)[tails]
    tail = {"samples": n_tails}
    if n_tails:
        tail.update(kernel_median=err_k.median().item(),
                    plain_median=err_p.median().item(),
                    kernel_max=err_k.max().item(),
                    plain_max=err_p.max().item())
    if n_tails > MAX_TAIL_SHARE * B:
        raise AssertionError(f"float32: {n_tails} of {B} samples differ "
                             f"beyond {TOL32}: {tail}")
    if n_tails and (
            tail["kernel_median"] > TAIL_FACTOR * tail["plain_median"] or
            tail["kernel_max"] > TAIL_FACTOR * tail["plain_max"]):
        raise AssertionError(f"float32 tails: the kernel is further from "
                             f"float64 than the plain version: {tail}")
    agree = ~tails
    err32 = max((g - r).abs().max().item() for g, r in zip(k32[:2], p32[:2]))
    err32_agreeing = max((g[..., agree] - r[..., agree]).abs().max().item()
                         for g, r in zip(k32[:2], p32[:2]))
    emit({"phase": "kernel_vs_plain", "B": B, "budget": list(BUDGET),
          "float64_max_abs_err": err64, "float32_max_abs_err": err32,
          "float32_max_abs_err_agreeing": err32_agreeing,
          "float32_tails": tail,
          "valid_share": k32[2].float().mean().item()})

    # Times at the main path's shapes (float32), and the kernel's bound.
    with torch.no_grad():
        ms = cuda_ms(lambda: kernel(*qps32, EPS, *BUDGET), reps=30)
        ms64 = cuda_ms(lambda: kernel(*qps64, EPS, *BUDGET), reps=10)
        plain_ms = cuda_ms(lambda: plain(*qps32, EPS, *BUDGET), reps=3,
                           warmup=1)
        ops = count_operations(lambda: plain(*qps32, EPS, *BUDGET))
    n_bytes = sum(t.numel() * t.element_size() for t in qps32) + \
        sum(t.numel() * t.element_size() for t in k32)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S["float32"] * 1e3
    timing = {"ms": ms, "ms_float64": ms64, "plain_ms": plain_ms,
              "bytes": n_bytes, "operations": ops,
              "operations_per_sample": ops / B, "bytes_ms": bytes_ms,
              "operations_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
              "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    emit({"phase": "kernel_timing", **timing})
    return {"max_abs_err": err32, "max_abs_err_float64": err64, **timing}


def phase_rollout(system, x0_64):
    import numpy as np
    import torch
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    from dair_pll_tpu_torch.ops import soa_kernels
    counter = soa_kernels.solve_warm_hybrid_soa_cuda

    params = system.initial_params(torch.float32)
    x0 = x0_64.float()
    system.simulate_batch(params, x0[:1024], 2)      # warm-up
    torch.cuda.synchronize()

    counter.launches = 0
    t0 = time.perf_counter()
    traj = system.simulate_batch(params, x0, STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counter.launches

    if tuple(traj.shape) != (B, STEPS + 1, 13):
        raise AssertionError(f"trajectory shape {tuple(traj.shape)}")
    if not bool(torch.isfinite(traj).all()):
        raise AssertionError("non-finite states in the float32 rollout")
    if launches != STEPS:
        raise AssertionError(f"{launches} kernel launches in a {STEPS}-"
                             "step rollout")

    # float64 on the card (kernel) against the CPU (plain version).
    x_check = x0_64[:CHECK_TRAJ]
    gpu = system.simulate_batch(system.initial_params(torch.float64),
                                x_check, CHECK_STEPS, use_fused=True)
    cpu_system = MultibodyLearnableSystem(system.model, DT, device="cpu")
    cpu = cpu_system.simulate_batch(cpu_system.initial_params(torch.float64),
                                    x_check.cpu(), CHECK_STEPS,
                                    use_fused=True)
    check_err = (gpu.cpu() - cpu).abs().max().item()
    if not check_err <= ROLLOUT_ATOL:
        raise AssertionError(f"float64 rollout on the card differs from the "
                             f"CPU by {check_err:.3e}")

    heights = traj[..., 6].double().cpu().numpy()
    result = {"phase": "rollout", "B": B, "steps": STEPS, "dtype": "float32",
              "seconds": seconds, "steps_per_s": STEPS / seconds,
              "transitions_per_s": B * STEPS / seconds,
              "kernel_launches": launches,
              "float64_card_vs_cpu_max_abs_err": check_err,
              "min_center_height_m": float(np.min(heights))}
    emit(result)
    return traj, launches, seconds


def phase_profile(system, x0_64, step_seconds: float) -> None:
    """Kernels on the card per rollout step, from a ``torch.profiler``
    trace of one step; the busy share divides their time by the host's
    time per step in the unprofiled rollout."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile

    params = system.initial_params(torch.float32)
    x0 = x0_64.float()
    steps = 1
    system.simulate_batch(params, x0, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        system.simulate_batch(params, x0, steps)
        torch.cuda.synchronize()
    events = prof.events()
    per_name = collections.Counter()
    launches = 0
    for event in events:
        if event.device_type == torch.autograd.DeviceType.CUDA:
            per_name[event.name] += event.time_range.elapsed_us()
            launches += 1
    device_ms = sum(per_name.values()) / 1e3 / steps
    emit({"phase": "profile", "B": B, "steps": steps,
          "seconds": time.perf_counter() - t0,
          "device_kernels_per_step": launches / steps,
          "device_ms_per_step": device_ms,
          "host_ms_per_step": step_seconds * 1e3,
          "device_busy_share": (device_ms / (step_seconds * 1e3)
                                if launches else None),
          "top_kernels_ms_per_step": [
              [name[:80], us / 1e3 / steps]
              for name, us in per_name.most_common(6)]})


def phase_breakdown(system, traj):
    """Median time of one step's parts at the main path's shapes."""
    import torch
    from dair_pll_tpu_torch.multibody.learnable_system import (
        CONTACT_FILTER_EPS)
    from dair_pll_tpu_torch.multibody.soa_terms import soa_rollout_qp
    from dair_pll_tpu_torch.ops import soa, soa_solver
    from dair_pll_tpu_torch.ops.soa_kernels import (
        solve_warm_hybrid_soa_cuda_packed, unpack_qp)

    params = system.initial_params(torch.float32)
    space = system.space
    x = traj[:, STEPS // 2].contiguous()
    w0 = torch.zeros((6, B), device=x.device)
    state = {}

    def terms():
        state["qp"] = soa_rollout_qp(system.model, params, x, DT)

    def solve():
        m, jc, qc, _, _ = state["qp"]
        state["sol"] = solve_warm_hybrid_soa_cuda_packed(m, jc, qc, w0, EPS,
                                                         *BUDGET)

    def update():
        m, jc, _, phi, v_minus = state["qp"]
        gamma = torch.where(phi <= CONTACT_FILTER_EPS, state["sol"][0],
                            0.0).unbind(0)
        M, Jc = unpack_qp(m, jc)
        dv = soa.spd_solve(M, soa_solver.jt_dot(Jc, gamma))
        v_plus = torch.stack([v_minus[i] + dv[i] for i in range(6)], dim=-1)
        space.x(space.euler_step(space.q(x), v_plus, DT), v_plus)

    with torch.no_grad():
        parts = {"terms_ms": cuda_ms(terms, reps=5),
                 "solve_ms": cuda_ms(solve, reps=5),
                 "update_ms": cuda_ms(update, reps=5)}
    total = sum(parts.values())
    emit({"phase": "step_breakdown", "B": B, **parts,
          **{k.replace("_ms", "_share"): v / total
             for k, v in parts.items()}})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import dair_pll_tpu_torch
    found = os.path.dirname(os.path.abspath(dair_pll_tpu_torch.__file__))
    if found != os.path.join(HERE, "dair_pll_tpu_torch"):
        print(f"chip_smoke: the port was imported from {found}, not from "
              "this checkout", file=sys.stderr)
        return 2
    import numpy as np
    from dair_pll_tpu_torch import assets
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_device()
    build_kernels()
    system = MultibodyLearnableSystem.from_urdfs(
        {"cube": assets.get_asset("cube")}, DT)
    x0_64 = torch.tensor(
        assets.cube_states_near_ground(np.random.default_rng(0), B),
        dtype=torch.float64, device=system.device)
    k = phase_kernel(system, x0_64)
    traj, launches, seconds = phase_rollout(system, x0_64)
    phase_profile(system, x0_64, seconds / STEPS)
    phase_breakdown(system, traj)

    emit({"kernels": [{
        "name": "warm_hybrid_solve",
        "route": "cuda",
        "source": "dair_pll_tpu_torch/csrc/warm_hybrid_solve.cu",
        "replaces": "dair_pll_tpu/ops/soa_pallas.py:151",
        "launches": launches,
        "max_abs_err": k["max_abs_err"],
        "max_abs_err_float64": k["max_abs_err_float64"],
        "ms": k["ms"],
        "ms_float64": k["ms_float64"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": None,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
