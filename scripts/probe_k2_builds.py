"""Whether the generic K2's float64 results depend on how it is built.

Builds the elbow-size float64 source of the generic loss backward
(``dair_pll_tpu_torch/csrc/model_loss_bwd_b2_f64.cu``) in several variants
of the same arithmetic, runs each in a process of its own, twice, on the
same inputs (``chip_smoke.py``'s elbow training recipe at float32 impulses
from K1, cast to float64), and compares:

- each variant's ``dxin`` and ``dxp`` (one column a sample) with the shipped
  library's, bit for bit, and its batch-summed ``dp``;
- the shipped library's ``dxin``, ``dxp`` and ``dp`` with the plain version
  (``plain_loss_bwd``, torch autograd) over the whole batch, in chunks, and
  every variant with it on the samples where the variant and the shipped
  library differ.

Variants: ``stock`` (the shipped source compiled alone), ``threads64`` and
``threads256`` (``kModelBwdThreads``: the order of the ``dp`` sum only),
``maxrreg128`` (``-maxrregcount=128``: another register allocation) and
``outline`` (``model_loss_vjp`` as an out-of-line call). The per-sample
outputs must not depend on any of these.

    python3 scripts/probe_k2_builds.py [--n 2097152]

Needs one CUDA card and ``nvcc``; writes its readings, one JSON object a
line, to standard output and to ``chiprun_out/k2_builds.json``.
"""
import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORK = os.path.join(ROOT, "build", "k2_probe")
SOURCE = "model_loss_bwd_b2_f64.cu"
ENTRY = "contactnets_loss_bwd_b2_q8_v7_k8_f64"
PLAIN_CHUNK = 65536
VARIANTS = {
    "stock": ((), ()),
    "threads64": ((("model_loss.cuh",
                    "constexpr int kModelBwdThreads = 128;",
                    "constexpr int kModelBwdThreads = 64;"),), ()),
    "threads256": ((("model_loss.cuh",
                     "constexpr int kModelBwdThreads = 128;",
                     "constexpr int kModelBwdThreads = 256;"),), ()),
    "maxrreg128": ((), ("-maxrregcount=128",)),
    "outline": ((("model_adjoint.cuh",
                  "__device__ __forceinline__ void model_loss_vjp(",
                  "__device__ __noinline__ void model_loss_vjp("),), ()),
}


def emit(obj, sink) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    sink.append(obj)


def start_build(name: str):
    """A copy of ``csrc/`` with the variant's edits, and its ``nvcc``
    process building ``SOURCE`` into ``lib.so``."""
    from dair_pll_tpu_torch.ops import soa_kernels
    edits, flags = VARIANTS[name]
    src = os.path.join(WORK, name, "csrc")
    shutil.rmtree(os.path.join(WORK, name), ignore_errors=True)
    shutil.copytree(soa_kernels.SOURCE_DIR, src)
    for header, old, new in edits:
        path = os.path.join(src, header)
        with open(path) as handle:
            text = handle.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not once in {header}")
        with open(path, "w") as handle:
            handle.write(text.replace(old, new))
    log = open(os.path.join(WORK, name, "nvcc.log"), "w")
    cmd = [soa_kernels._nvcc(), *soa_kernels.NVCC_FLAGS, *flags, "-shared",
           "-o", os.path.join(WORK, name, "lib.so"),
           os.path.join(src, SOURCE)]
    return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)


def make_inputs(n: int) -> None:
    """The elbow's training recipe, K1's float32 impulses, all in float64,
    saved for the runs."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from dair_pll_tpu_torch.ops import soa_loss_kernels as lk
    system = cs.elbow_system()
    model = system.model
    x, xp = cs.elbow_train_transitions(n, system.device)
    pvec = cs.derived_vector(system, system.initial_params(torch.float64))
    xin32, xp32 = x.T.contiguous(), xp.T.contiguous()
    _, force, valid = lk.fused_loss_fwd(model, pvec.float(), xin32, xp32,
                                        cs.DT, cs.LOSS_EPS, *cs.COLD_BUDGET)
    torch.save({"pvec": pvec, "xin": xin32.double(), "xp": xp32.double(),
                "force": force.double(), "valid": valid,
                "ct": torch.ones(n, dtype=torch.float64,
                                 device=system.device)},
               os.path.join(WORK, "inputs.pt"))


def run_one(name: str) -> None:
    """One build's K2, twice, on the saved inputs; saves its outputs."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from dair_pll_tpu_torch.ops import soa_loss_kernels as lk
    system = cs.elbow_system()
    model = system.model
    ins = torch.load(os.path.join(WORK, "inputs.pt"))
    args = (ins["pvec"], ins["xin"], ins["xp"], ins["force"], ins["valid"],
            ins["ct"])
    if name == "shipped":
        def k2():
            return lk.fused_loss_bwd(model, *args, cs.DT, cs.LOSS_EPS)
    else:
        lib = ctypes.CDLL(os.path.join(WORK, name, "lib.so"))
        fn = getattr(lib, ENTRY)
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_longlong,
                                                ctypes.c_double,
                                                ctypes.c_double,
                                                ctypes.c_void_p]
        fn.restype = ctypes.c_int
        desc = lk.model_descriptor(model)
        n = ins["xin"].shape[1]
        # Room for the partial sums of blocks of 32 threads or more.
        partial = torch.empty((-(-n // 32)) * ins["pvec"].numel(),
                              dtype=torch.float64, device=system.device)

        def k2():
            dp = torch.empty_like(ins["pvec"])
            dxin, dxp = torch.empty_like(ins["xin"]), torch.empty_like(
                ins["xp"])
            err = fn(ctypes.addressof(desc),
                     *(t.data_ptr() for t in args), partial.data_ptr(),
                     dp.data_ptr(), dxin.data_ptr(), dxp.data_ptr(), n,
                     cs.DT, cs.LOSS_EPS,
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"{name}: CUDA error {err}")
            return dp, dxin, dxp
    first = k2()
    torch.cuda.synchronize()
    second = k2()
    torch.cuda.synchronize()
    repeat = all(torch.equal(bits(a), bits(b)) for a, b in zip(first, second))
    torch.save({"out": tuple(t.cpu() for t in first), "repeat": repeat},
               os.path.join(WORK, f"{name}.pt"))


def bits(t):
    """``t``'s bit patterns, so that equal NaNs compare equal."""
    return t.contiguous().view(torch.int64 if t.element_size() == 8
                               else torch.int32)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=2097152)
    parser.add_argument("--run", default=None)
    options = parser.parse_args()
    sys.path.insert(0, ROOT)
    if not torch.cuda.is_available():
        print("probe_k2_builds: no CUDA device is available", file=sys.stderr)
        return 2
    if options.run is not None:
        run_one(options.run)
        return 0
    from dair_pll_tpu_torch.ops import soa_kernels
    from dair_pll_tpu_torch.ops import soa_loss_kernels as lk
    import chip_smoke as cs
    sink = []
    sink.append({"phase": "device", "nvidia_smi": cs.phase_device()})
    os.makedirs(WORK, exist_ok=True)
    t0 = time.perf_counter()
    builds = {name: start_build(name) for name in VARIANTS}
    soa_kernels.load_library()
    failed = [name for name, proc in builds.items() if proc.wait() != 0]
    if failed:
        for name in failed:
            with open(os.path.join(WORK, name, "nvcc.log")) as handle:
                print(handle.read(), file=sys.stderr)
        return 1
    ptxas = {}
    for name in VARIANTS:
        with open(os.path.join(WORK, name, "nvcc.log")) as handle:
            ptxas[name] = [line.strip() for line in handle
                           if "Used" in line or "stack frame" in line][:4]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas}, sink)
    make_inputs(options.n)
    outputs = {}
    for name in ("shipped", *VARIANTS):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--n", str(options.n), "--run", name],
                              cwd=ROOT, check=False)
        if proc.returncode != 0:
            return proc.returncode
        outputs[name] = torch.load(os.path.join(WORK, f"{name}.pt"))
    ins = torch.load(os.path.join(WORK, "inputs.pt"))
    system = cs.elbow_system()
    model = system.model
    n = ins["xin"].shape[1]

    def plain(cols):
        cols = torch.as_tensor(cols, device=system.device)
        dp, dxin, dxp = lk.plain_loss_bwd(
            model, ins["pvec"], ins["xin"][:, cols].contiguous(),
            ins["xp"][:, cols].contiguous(), ins["force"][..., cols]
            .contiguous(), ins["valid"][cols], ins["ct"][cols], cs.DT,
            cs.LOSS_EPS)
        return dp.cpu(), dxin.cpu(), dxp.cpu()

    # The shipped library against the plain version over the whole batch.
    shipped = outputs["shipped"]["out"]
    dp_plain = torch.zeros_like(shipped[0])
    worst = {"dxin": 0.0, "dxp": 0.0}
    excess = {"dxin": 0.0, "dxp": 0.0}
    for lo in range(0, n, PLAIN_CHUNK):
        cols = list(range(lo, min(n, lo + PLAIN_CHUNK)))
        ref = plain(cols)
        dp_plain += ref[0]
        for i, what in ((1, "dxin"), (2, "dxp")):
            got = shipped[i][:, lo:lo + len(cols)]
            err = (got - ref[i]).abs()
            worst[what] = max(worst[what], err.max().item())
            excess[what] = max(excess[what], (
                err - (cs.GRAD_ATOL + cs.GRAD_RTOL * ref[i].abs()))
                .max().item())
    dp_err = (shipped[0] - dp_plain).abs()
    emit({"phase": "shipped_vs_plain", "B": n,
          "valid_share": ins["valid"].double().mean().item(),
          "finite": all(bool(t.isfinite().all()) for t in shipped),
          "repeat_bit_identical": outputs["shipped"]["repeat"],
          "max_abs_err": {**worst, "dp": dp_err.max().item()},
          "dp_max_abs": shipped[0].abs().max().item(),
          "over_bar": {**excess, "dp": (dp_err - (
              cs.GRAD_ATOL + cs.GRAD_RTOL * dp_plain.abs())).max().item()}},
         sink)

    # Each variant against the shipped library, and on the samples where
    # they differ, against the plain version.
    ok = max(excess.values()) <= 0 and outputs["shipped"]["repeat"]
    for name in VARIANTS:
        out = outputs[name]["out"]
        differ = torch.zeros(n, dtype=torch.bool)
        for i in (1, 2):
            differ |= (bits(out[i]) != bits(shipped[i])).any(dim=0)
        cols = differ.nonzero().flatten()[:4096].tolist()
        reading = {"phase": "variant", "name": name,
                   "repeat_bit_identical": outputs[name]["repeat"],
                   "finite": all(bool(t.isfinite().all()) for t in out),
                   "samples_differing": int(differ.sum()),
                   "first_differing": cols[:8],
                   "dp_max_abs_diff": (out[0] - shipped[0]).abs().max()
                   .item()}
        if cols:
            ref = plain(cols)
            reading["on_differing_vs_plain"] = {
                who: max((o[i][:, cols] - ref[i]).abs().max().item()
                         for i in (1, 2))
                for who, o in (("variant", out), ("shipped", shipped))}
        emit(reading, sink)
        ok = ok and reading["repeat_bit_identical"] and not cols
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k2_builds.json"), "w") as f:
        json.dump(sink, f, indent=1)
    emit({"phase": "verdict", "per_sample_outputs_build_independent": ok},
         sink)
    return 0


if __name__ == "__main__":
    sys.exit(main())
