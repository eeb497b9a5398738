"""Designs of the box cube's loss kernels K3 and K1 timed in turns on one card.

On ``bench.py``'s 2,097,152 training transitions
(``chip_smoke.train_transitions``, initial parameters, warm-started from
K1's impulses at the (4, 10) budget, eps 1e-3). The shipped K3 (the
``--tree`` checkout's library, through
``soa_loss_kernels.fused_loss_fwd_warm``) and each design of
``scripts/probe_cube_k3.cu`` (the one-thread body at other launch
bounds; the terms split from the solve, the solve on one thread or on 2
or 4 lanes a sample), in float32 and float64:

- each against the plain version ``plain_loss_fwd_warm`` on the batch's
  first 8,192 samples, and against the shipped kernel on the whole batch,
  bit for bit (loss, impulses, valid mask);
- ``--rounds`` rounds, each timing every design once in turn (median of
  CUDA events over a few launches), in float32 at the training budget and
  at (0, 0), (10, 0) and (10, 10) for the split into the terms, an IPM
  iteration and a Newton iteration, and in float64 at the training budget;
- ptxas's registers and stack of every design.

With ``--k1``, the same for the cold loss kernel K1 at the (10, 10)
budget (plain version ``plain_loss_fwd``): the ``--tree``'s shipped K1
beside the designs of ``probe_cube_k3.cu``'s K1 groups, built from this
checkout (its solve's fixed-point exits on and off, and the exits with
fewer live values in the solve, ``LEAN_EDITS`` applied to a copy of
``csrc/``), each also with the shares of its time split.

Builds go under ``build/cube_k3_probe/`` (``.gitignore`` lists it), every
``nvcc`` at once, with the kernel library's flags. To compare two
checkouts, unpack the other into a directory ``.gitignore`` lists and run
both in one call (``--tree committed_tree/parent --label parent``).

    python3 scripts/probe_cube_k3.py [--tree DIR] [--label NAME]
        [--rounds N] [--k1]

Needs one CUDA card and ``nvcc``. Prints one JSON line and appends it to
``chiprun_out/probe_cube_k3.jsonl``.
"""
import argparse
import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BUILD = os.path.join(ROOT, "build", "cube_k3_probe")
#: Compile groups of ``probe_cube_k3.cu`` and the designs each defines.
K3_GROUPS = {"T64": ("t64", "t64_min6"), "T128": ("t128", "t128_min3"),
             "T32": ("t32", "t64_min4"), "SPLIT1": ("split1",),
             "SPLIT2": ("split2",), "SPLIT4": ("split4",)}
K1_GROUPS = {"K1": ("k1_exits", "k1_exits_diverge", "k1_no_exits"),
             "K1LEAN": ("k1_lean",)}
#: Each K1 design's kernel: its solve's exits on or off, and whether a
#: warp's threads leave the loops together (``WarpSolo``).
K1_KERNELS = {"k1_exits": (True, True), "k1_exits_diverge": (True, False),
              "k1_no_exits": (False, False), "k1_lean": (True, True)}
#: Fewer live values in the solve (``k1_lean``), as edits (old, new) of
#: ``hybrid_solve.cuh``, each bit for bit: the Newton matrix factored in
#: place (its lower triangle overwritten by the factor's unscaled columns,
#: L = C D^-1 written transposed above the diagonal, which the
#: factorization never reads); and, on one thread, each contact's two
#: crease candidates considered as soon as they are found, in place of
#: keeping all 2K (the bracket is a NaN-free maximum and minimum over the
#: candidates, none of them a second zero, so their order does not change
#: its bits).
LEAN_EDITS = (
    ("""      Ldlt<T, NV> F_H;
      ldlt<T, NV>(H, F_H);
      ldlt_solve<T, NV>(F_H, grad, dw);""",
     """      T dinv[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        T s = H[j][j];
#pragma unroll
        for (int k = 0; k < j; ++k) s = s - H[k][j] * H[j][k];
        const T dj_inv = T(1) / s;
        dinv[j] = dj_inv;
#pragma unroll
        for (int i = j + 1; i < NV; ++i) {
          T c = H[i][j];
#pragma unroll
          for (int k = 0; k < j; ++k) c = c - H[k][i] * H[j][k];
          H[i][j] = c;
          H[j][i] = c * dj_inv;
        }
      }
      T y[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        T s = grad[i];
#pragma unroll
        for (int k = 0; k < i; ++k) s = s - H[k][i] * y[k];
        y[i] = s;
      }
#pragma unroll
      for (int i = NV - 1; i >= 0; --i) {
        T s = y[i] * dinv[i];
#pragma unroll
        for (int k = i + 1; k < NV; ++k) s = s - H[i][k] * dw[k];
        dw[i] = s;
      }"""),
    ("""  T roots[2][K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const T n0""",
     """  auto roots_of = [&](int c, T& root1, T& root2) {
    const T n0"""),
    ("""    roots[0][c] = v1 ? r1 : T(1);
    roots[1][c] = v2 ? r2 : T(1);
  }
  bool take_full;
  if constexpr (G::kLanes == 1) {
    consider(T(0));
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < K; ++c) consider(roots[j][c]);
    take_full = consider(T(1)) <= T(0);
  } else {""",
     """    root1 = v1 ? r1 : T(1);
    root2 = v2 ? r2 : T(1);
  };
  bool take_full;
  if constexpr (G::kLanes == 1) {
    consider(T(0));
#pragma unroll
    for (int c = 0; c < K; ++c) {
      T root1, root2;
      roots_of(c, root1, root2);
      consider(root1);
      consider(root2);
    }
    take_full = consider(T(1)) <= T(0);
  } else {
    T roots[2][K];
#pragma unroll
    for (int c = 0; c < K; ++c) roots_of(c, roots[0][c], roots[1][c]);"""),
)
#: Budgets of the time split: (0, 0) the terms and assembly, then ten IPM
#: iterations, then ten Newton iterations.
SPLIT_BUDGETS = ((0, 0), (10, 0), (10, 10))


def nvcc_all(jobs, flags) -> dict:
    """Runs one ``nvcc`` per job (name -> (source, include dir, output,
    extra flags)), all at once; returns each job's log (ptxas's report)
    and seconds; raises if any fails."""
    procs, start = {}, time.perf_counter()
    for name, (source, include, output, extra) in jobs.items():
        os.makedirs(os.path.dirname(output), exist_ok=True)
        procs[name] = subprocess.Popen(
            [flags[0], *flags[1:], "-shared", f"-I{include}", *extra, "-o",
             output, source], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        out[name] = {"log": log, "seconds": time.perf_counter() - start}
    return out


def timed_rounds(cs, calls: dict, rounds: int, reps: int) -> dict:
    """Each call's median ms over ``rounds`` rounds, the calls in turns
    within a round: name -> list of the rounds' times."""
    times = {name: [] for name in calls}
    for _ in range(rounds):
        for name, fn in calls.items():
            times[name].append(cs.cuda_ms(fn, reps=reps, warmup=1))
    return times


def same_bits(a, b) -> bool:
    import torch
    return all(torch.equal(x, y) for x, y in zip(a, b))


def k1_ptxas(log: str, dtype: str, exits: bool, warp: bool) -> list:
    """ptxas's register and spill lines of one K1 design's kernel
    (``k1_kernel<dtype, exits, WarpSolo or Solo>``) in an ``nvcc`` log."""
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = (f"k1_kernelI{dtype}Lb{int(exits)}E" in line and
                    ("WarpSolo" in line) == warp)
        if keep and ("registers" in line or "spill" in line):
            lines.append(line.strip())
    return lines


def lean_csrc() -> str:
    """A copy of this checkout's ``csrc/`` under the build directory with
    ``LEAN_EDITS`` applied to ``hybrid_solve.cuh``; returns its path."""
    import shutil
    out = os.path.join(BUILD, "k1_lean_csrc")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "dair_pll_tpu_torch", "csrc"), out)
    path = os.path.join(out, "hybrid_solve.cuh")
    with open(path) as handle:
        text = handle.read()
    for old, new in LEAN_EDITS:
        if text.count(old) != 1:
            raise RuntimeError(f"hybrid_solve.cuh does not hold {old!r} once")
        text = text.replace(old, new)
    with open(path, "w") as handle:
        handle.write(text)
    return out


def run_designs(cs, tree: str, rounds: int, k1: bool) -> dict:
    """K3's designs (or, with ``k1``, K1's) beside the ``--tree``'s shipped
    kernel, as the module's docstring lists."""
    import torch
    from dair_pll_tpu_torch import assets
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    from dair_pll_tpu_torch.ops import soa_kernels
    from dair_pll_tpu_torch.ops import soa_loss_kernels as lk
    source = os.path.join(HERE, "probe_cube_k3.cu")
    groups = K1_GROUPS if k1 else K3_GROUPS
    csrc = {group: os.path.join(tree, "dair_pll_tpu_torch", "csrc")
            for group in groups}
    if k1:
        csrc = {"K1": os.path.join(ROOT, "dair_pll_tpu_torch", "csrc"),
                "K1LEAN": lean_csrc()}
    jobs = {group: (source, csrc[group],
                    os.path.join(BUILD, f"k3_{group}", "lib.so"),
                    [f"-DPROBE_GROUP_{group}"]) for group in groups}
    t0 = time.perf_counter()
    soa_kernels.load_library()
    out = {"library_seconds": time.perf_counter() - t0, "designs": {}}
    built = nvcc_all(jobs, [soa_kernels._nvcc(), *soa_kernels.NVCC_FLAGS])
    P = ctypes.c_void_p
    entries = {}
    for group, names in groups.items():
        lib = ctypes.CDLL(jobs[group][2])
        lib.probe_pack_values.restype = ctypes.c_longlong
        pack_values = lib.probe_pack_values()
        for name in names:
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"probe_k3_{name}_{suffix}")
                fn.argtypes = [P] * 8 + [ctypes.c_longlong, ctypes.c_double,
                                         ctypes.c_double, ctypes.c_int,
                                         ctypes.c_int, P]
                fn.restype = ctypes.c_int
                entries[name, suffix] = fn
            log = built[group]["log"]
            if k1:
                out["designs"][name] = {
                    "build_seconds": built[group]["seconds"],
                    "ptxas": k1_ptxas(log, "f", *K1_KERNELS[name]),
                    "ptxas_float64": k1_ptxas(log, "d", *K1_KERNELS[name])}
                continue
            kernels = (("cube_terms_kernel", "split_solve_kernel")
                       if name == "split1" else
                       ("cube_terms_kernel",
                        "model_loss_fwd_warm_lanes_kernel")
                       if name.startswith("split") else
                       ("k3_min_blocks_kernel" if "min" in name
                        else "k3_threads_kernel",))
            out["designs"][name] = {
                "build_seconds": built[group]["seconds"],
                **{key: [line for kernel in kernels
                         for line in cs.ptxas_of(log, kernel + mangled)]
                   for key, mangled in (("ptxas", "If"),
                                        ("ptxas_float64", "Id"))}}
    shipped = ("contactnets_loss_fwd_kernel" if k1 else
               "contactnets_loss_fwd_warm_kernel")
    out["designs"]["shipped"] = {key: cs.ptxas_lines(
        "contactnets_loss.cu", shipped + mangled)
        for key, mangled in (("ptxas", "If"), ("ptxas_float64", "Id"))}
    budget = cs.COLD_BUDGET if k1 else cs.WARM_BUDGET

    system = MultibodyLearnableSystem.from_urdfs(
        {"cube": assets.get_asset("cube")}, cs.DT)
    model = system.model
    x, x_plus = cs.train_transitions(cs.TRAIN_B, system.device)
    inputs = {torch.float32: (cs.derived_vector(
        system, system.initial_params(torch.float32)), x.T.contiguous(),
        x_plus.T.contiguous())}
    del x, x_plus
    inputs[torch.float32] += (lk.fused_loss_fwd(
        model, *inputs[torch.float32], cs.DT, cs.LOSS_EPS,
        *cs.COLD_BUDGET)[1],)
    inputs[torch.float64] = tuple(t.double() for t in inputs[torch.float32])
    n = inputs[torch.float32][1].shape[1]
    pack = torch.empty((pack_values * n,), dtype=torch.float64,
                       device=system.device)

    def run(name, dtype, budget=budget, cols=None):
        pvec, xin, xp, fprev = inputs[dtype]
        if cols is not None:
            xin, xp, fprev = (t[..., cols].contiguous()
                              for t in (xin, xp, fprev))
        if name == "shipped" and k1:
            return lk.fused_loss_fwd(model, pvec, xin, xp, cs.DT,
                                     cs.LOSS_EPS, *budget)
        if name == "shipped":
            return lk.fused_loss_fwd_warm(model, pvec, xin, xp, fprev, cs.DT,
                                          cs.LOSS_EPS, *budget)
        B = xin.shape[1]
        loss, force, valid = lk._outputs(model, pvec, B)
        err = entries[name, "f32" if dtype == torch.float32 else "f64"](
            pvec.data_ptr(), xin.data_ptr(), xp.data_ptr(), fprev.data_ptr(),
            loss.data_ptr(), force.data_ptr(), valid.data_ptr(),
            pack.data_ptr(), B, cs.DT, cs.LOSS_EPS, *budget,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"design {name}: CUDA error {err}")
        return loss, force, valid

    names = ["shipped", *(name for names in groups.values()
                          for name in names)]
    small = slice(0, cs.B)
    with torch.no_grad():
        for dtype in (torch.float32, torch.float64):
            key = str(dtype).split(".")[1]
            pvec, xin, xp, fprev = inputs[dtype]
            plain = (lk.plain_loss_fwd(
                model, pvec, xin[:, small].contiguous(),
                xp[:, small].contiguous(), cs.DT, cs.LOSS_EPS, *budget)
                if k1 else lk.plain_loss_fwd_warm(
                model, pvec, xin[:, small].contiguous(),
                xp[:, small].contiguous(), fprev[..., small].contiguous(),
                cs.DT, cs.LOSS_EPS, *budget))
            whole = run("shipped", dtype)
            for name in names:
                entry = out["designs"].setdefault(name, {})
                entry[f"{key}_equals_plain_at_{cs.B}"] = same_bits(
                    run(name, dtype, cols=small), plain)
                entry[f"{key}_equals_shipped_at_{n}"] = same_bits(
                    run(name, dtype), whole)
            del plain, whole
        torch.cuda.synchronize()
        for what, dtype, at, reps in (
                ("ms", torch.float32, budget, 5),
                ("ms_float64", torch.float64, budget, 3),
                *((f"ms_{i},{j}", torch.float32, (i, j), 3)
                  for i, j in SPLIT_BUDGETS)):
            times = timed_rounds(cs, {
                name: (lambda nm=name, dt=dtype, bg=at: run(nm, dt, bg))
                for name in names}, rounds, reps)
            for name, t in times.items():
                out["designs"][name][what] = t
    for entry in out["designs"].values():
        med = {what: statistics.median(entry[what])
               for what in ("ms_0,0", "ms_10,0", "ms_10,10")}
        entry["split"] = {
            "terms_ms": med["ms_0,0"],
            "ipm_iteration_ms": (med["ms_10,0"] - med["ms_0,0"]) / 10,
            "newton_iteration_ms": (med["ms_10,10"] - med["ms_10,0"]) / 10}
    out["B"] = n
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=ROOT,
                        help="checkout whose package and kernels to measure")
    parser.add_argument("--label", default="change")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--k1", action="store_true",
                        help="K1's designs in place of K3's")
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("probe_cube_k3: no CUDA device is available", file=sys.stderr)
        return 2
    import dair_pll_tpu_torch
    found = os.path.dirname(os.path.dirname(
        os.path.abspath(dair_pll_tpu_torch.__file__)))
    if found != tree:
        raise RuntimeError(f"the package came from {found}, not {tree}")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"label": args.label, "tree": tree, "kernel": "K1" if args.k1
           else "K3", "nvidia_smi": cs.phase_device(), "rounds": args.rounds}
    t0 = time.perf_counter()
    out.update(run_designs(cs, tree, args.rounds, args.k1))
    out["seconds"] = time.perf_counter() - t0
    line = json.dumps(out)
    print(line, flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "probe_cube_k3.jsonl"),
              "a") as sink:
        sink.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
