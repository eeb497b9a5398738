"""Whether the generic K2's sweep (``csrc/model_adjoint.cuh``) reads
memory it should not, checked on its host build (``g++``, through
``ops/host_adjoint.HostModelTerms``).

Builds the sweep three ways and runs each, in a process of its own, on the
five parity models' inputs of ``tests/test_torch_model_terms_host.py``
(solved impulses, random impulses, and the edge cases):

- ``pattern`` and ``zero``: every uninitialised local filled with a
  pattern or with zeros (``-ftrivial-auto-var-init``). A sweep that reads
  an unset local gives different bits in the two.
- ``sanitized``: ``-fsanitize=address,undefined`` with
  ``-fsanitize=bounds-strict``, stopping at the first fault (an access out
  of an array's bounds, out of an object, or undefined arithmetic).

Then it compares the three builds' float64 gradients bit for bit.

    python3 tests/check_torch_k2_host_builds.py

Needs ``g++`` with its sanitizer runtimes; about four minutes on one
core, most of it the sanitized build. Prints one JSON line; exits non-zero
on a fault or a difference.
"""
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORK = os.path.join(ROOT, "build", "host_checks")
SANITIZE = ("-fsanitize=address,undefined", "-fsanitize=bounds-strict",
            "-fno-sanitize-recover=all")
BUILDS = {"pattern": ("-ftrivial-auto-var-init=pattern",),
          "zero": ("-ftrivial-auto-var-init=zero",),
          "sanitized": SANITIZE}


def run_build(name: str) -> None:
    """One build's gradients on every input set, saved to WORK."""
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import test_torch_model_terms_host as host_test
    from torch_parity import DT, KERNEL_MODELS
    from dair_pll_tpu_torch.ops import host_adjoint
    urdfs = os.path.join(WORK, "urdfs")
    os.makedirs(urdfs, exist_ok=True)
    host = host_adjoint.HostModelTerms(
        os.path.join(WORK, name), host_test.model_sizes(urdfs),
        tuple(host_test.WARM_SHAPES.values()), BUILDS[name])
    out = {}
    for model_name in sorted(KERNEL_MODELS):
        model, pvec, xin, xp, force, valid, ct = host_test._inputs(
            model_name, urdfs)
        random_force, random_valid = host_test._random_impulses(force,
                                                                valid, 3)
        edge = host_test._edge_inputs(model_name, urdfs)
        for case, args in (("solved", (force, valid)),
                           ("random", (random_force, random_valid))):
            out[f"{model_name}/{case}"] = host.vjp(model, pvec, xin, xp,
                                                   *args, ct, DT)
        out[f"{model_name}/edge"] = host.vjp(*edge[:6], edge[6], DT)
    torch.save(out, os.path.join(WORK, f"{name}.pt"))


def main() -> int:
    if len(sys.argv) > 1:
        run_build(sys.argv[1])
        return 0
    os.makedirs(WORK, exist_ok=True)
    faults = {}
    for name in BUILDS:
        env = dict(os.environ)
        if name == "sanitized":
            runtimes = [subprocess.run(["g++", f"-print-file-name={lib}"],
                                       capture_output=True, text=True,
                                       check=True).stdout.strip()
                        for lib in ("libasan.so", "libubsan.so")]
            env.update(LD_PRELOAD=" ".join(runtimes),
                       ASAN_OPTIONS="detect_leaks=0",
                       UBSAN_OPTIONS="print_stacktrace=1")
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               name], env=env, check=False)
        if proc.returncode != 0:
            faults[name] = proc.returncode
    if faults:
        print(json.dumps({"faults": faults}))
        return 1
    outs = {name: torch.load(os.path.join(WORK, f"{name}.pt"))
            for name in BUILDS}
    differ = sorted({f"{name}:{case}" for name in ("zero", "sanitized")
                     for case, grads in outs[name].items()
                     if not all(torch.equal(a, b) for a, b in
                                zip(grads, outs["pattern"][case]))})
    print(json.dumps({"builds": sorted(BUILDS), "cases": len(outs["pattern"]),
                      "faults": {}, "differ": differ}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
