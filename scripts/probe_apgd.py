"""Designs of the APGD cone solve kernel K6 timed in turns on one card.

The shipped K6 (the ``--tree`` checkout's library, through
``cone_kernels.solve_cone_qp_cuda``) and the four designs of
``scripts/probe_apgd.cu`` (built from this checkout's ``csrc/``): one warp
or one packed group of lanes a problem, the iterate by shuffles or through
shared memory. On these sets of problems, 200 iterations:

- ``route_65536``: the cube loss QPs of the K6 route's training step
  (``chip_smoke.apgd_loss_qps`` on ``chip_smoke.train_transitions``,
  initial parameters, k = 4) at 65,536, the main path's batch;
  ``route_262144`` (``APGD_TIMING_B``) and ``route_256`` the same recipe
  at those batches;
- ``random_k1`` and ``random_k9``: ``chip_smoke.random_psd_qps`` at 65,536.

For each set, in float32 and float64: every design's outputs against the
shipped kernel's bit for bit on the whole set and against the plain
version ``plain_apgd`` on its first 8,192 problems, and ``--rounds``
rounds, each timing every design once in turn (median of CUDA events over
ten launches). ptxas's registers and stack of every design.

The build goes under ``build/apgd_probe/`` (``.gitignore`` lists it). To
compare two checkouts, unpack the other into a directory ``.gitignore``
lists and run both in one call, in turns:

    python3 scripts/probe_apgd.py --tree committed_tree/parent \\
        --label parent
    python3 scripts/probe_apgd.py --label change

Needs one CUDA card and ``nvcc``. Prints one JSON line and appends it to
``chiprun_out/probe_apgd.jsonl``.
"""
import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BUILD = os.path.join(ROOT, "build", "apgd_probe")
DESIGNS = ("warp_shuffle", "group_shuffle", "group_shared", "warp_shared")
#: The cone counts the designs are built for, and each one's group width
#: (``kGroupLanes``), as the kernels' mangled names carry it.
GROUP_LANES = {1: 8, 4: 16, 9: 32}
CHECK_B = 8192


def build(soa_kernels) -> tuple:
    """``probe_apgd.cu`` into ``build/apgd_probe/lib.so``; returns the
    library, ptxas's report and the build's seconds."""
    os.makedirs(BUILD, exist_ok=True)
    output = os.path.join(BUILD, "lib.so")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [soa_kernels._nvcc(), *soa_kernels.NVCC_FLAGS, "-shared",
         f"-I{os.path.join(ROOT, 'dair_pll_tpu_torch', 'csrc')}", "-o",
         output, os.path.join(HERE, "probe_apgd.cu")],
        capture_output=True, text=True, check=False)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on probe_apgd.cu:\n{log}")
    lib = ctypes.CDLL(output)
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name in DESIGNS:
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"probe_apgd_{name}_{suffix}")
            fn.argtypes = [P, P, P, LL, I, I, P]
            fn.restype = I
    return lib, log, time.perf_counter() - t0


def design_ptxas(cs, log: str, name: str) -> dict:
    """ptxas's lines of a design's kernels, by type and k."""
    exchange = "SharedExchange" if name.endswith("shared") else \
        "ShuffleExchange"
    out = {}
    for t, key in (("f", "float32"), ("d", "float64")):
        for k, group in GROUP_LANES.items():
            width = 32 if name.startswith("warp") else group
            lines, keep = [], False
            for line in log.splitlines():
                if "Compiling entry function" in line:
                    keep = (f"apgd_cone_solve_kernelI{t}Li{k}ELi{width}E"
                            in line and exchange in line)
                if keep and ("registers" in line or "spill" in line):
                    lines.append(line.strip())
            out[f"{key}_k{k}"] = lines
    return out


def problem_sets(cs, system):
    """The sets of the module's docstring: name -> float64 ``(Q, q)``."""
    import torch
    x, x_plus = cs.train_transitions(cs.APGD_TIMING_B, system.device)
    Q32, q32 = cs.apgd_loss_qps(system, system.initial_params(torch.float32),
                                x, x_plus)
    del x, x_plus
    Q, q = Q32.double(), q32.double()
    del Q32, q32
    return {"route_65536": (Q[:cs.VMAPPED_BIG_B].contiguous(),
                            q[:cs.VMAPPED_BIG_B].contiguous()),
            "route_262144": (Q, q),
            "route_256": (Q[:256].contiguous(), q[:256].contiguous()),
            "random_k1": cs.random_psd_qps(cs.VMAPPED_BIG_B, 1,
                                           system.device),
            "random_k9": cs.random_psd_qps(cs.VMAPPED_BIG_B, 9,
                                           system.device)}


def run_sets(cs, lib, rounds: int) -> dict:
    import torch
    from dair_pll_tpu_torch import assets
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    from dair_pll_tpu_torch.ops import cone_kernels
    from dair_pll_tpu_torch.ops.socp_solver import mask_failures
    system = MultibodyLearnableSystem.from_urdfs(
        {"cube": assets.get_asset("cube")}, cs.DT)
    iterations = cs.APGD_ITERATIONS

    def call(name, Q, q):
        if name == "shipped":
            return cone_kernels.solve_cone_qp_cuda(Q, q, iterations)
        x = torch.empty_like(q)
        suffix = "f32" if q.dtype == torch.float32 else "f64"
        err = getattr(lib, f"probe_apgd_{name}_{suffix}")(
            Q.data_ptr(), q.data_ptr(), x.data_ptr(), q.shape[0],
            q.shape[1] // 3, iterations,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"K6 design {name}: CUDA error {err}")
        return x

    names = ("shipped", *DESIGNS)
    out = {}
    for set_name, (Q64, q64) in problem_sets(cs, system).items():
        entry = {"B": int(q64.shape[0]), "k": int(q64.shape[1] // 3)}
        for dtype in (torch.float32, torch.float64):
            key = str(dtype).split(".")[1]
            Q, q = Q64.to(dtype), q64.to(dtype)
            with torch.no_grad():
                shipped = call("shipped", Q, q)
                small = slice(0, min(CHECK_B, q.shape[0]))
                plain = cone_kernels.plain_apgd(Q[small], q[small],
                                                iterations)
                _, valid = mask_failures(shipped)
                entry[f"{key}_valid_share"] = valid.float().mean().item()
                for name in names:
                    got = call(name, Q, q)
                    entry.setdefault(name, {})[
                        f"{key}_equals_shipped"] = torch.equal(got, shipped)
                    entry[name][f"{key}_equals_plain_at_{CHECK_B}"] = \
                        torch.equal(got[small], plain)
                for _ in range(rounds):
                    for name in names:
                        entry[name].setdefault(f"ms_{key}", []).append(
                            cs.cuda_ms(lambda nm=name: call(nm, Q, q),
                                       reps=10, warmup=1))
            del Q, q, shipped, plain
        out[set_name] = entry
        torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=ROOT,
                        help="checkout whose package and kernels to measure")
    parser.add_argument("--label", default="change")
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("probe_apgd: no CUDA device is available", file=sys.stderr)
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
    from dair_pll_tpu_torch.ops import soa_kernels
    out = {"label": args.label, "tree": tree,
           "nvidia_smi": cs.phase_device(), "rounds": args.rounds}
    t0 = time.perf_counter()
    soa_kernels.load_library()
    out["library_seconds"] = time.perf_counter() - t0
    out["ptxas_shipped"] = {
        f"{key}_k{k}": cs.ptxas_lines("apgd_cone_solve.cu",
                                      f"apgd_cone_solve_kernelI{t}Li{k}E")
        for t, key in (("f", "float32"), ("d", "float64"))
        for k in GROUP_LANES}
    lib, log, seconds = build(soa_kernels)
    out["probe_build_seconds"] = seconds
    out["ptxas"] = {name: design_ptxas(cs, log, name) for name in DESIGNS}
    out["sets"] = run_sets(cs, lib, args.rounds)
    out["seconds"] = time.perf_counter() - t0
    line = json.dumps(out)
    print(line, flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "probe_apgd.jsonl"),
              "a") as sink:
        sink.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
