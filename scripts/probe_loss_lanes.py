"""The loss kernels K1, K3 and K2 (and the solves K5, K4) of one checkout
on one card.

With ``--model NAME`` (``box_sphere``, ``ball``, ``elbow``,
``cube_polygon``, ``cube``, ``wide_polygon``, ``chip_smoke.py``'s free
body with a 20-vertex polygon and a sphere, or ``wide_polygon_80``, the
same with 80 vertices, whose kernels take some 5 minutes to build), for
the checkout at
``--tree`` (this one by default): the model's loss kernels built at first
use
(``soa_kernels.build_instances``), with ptxas's register and spill lines
of K1, K3 and K2 in float32 and float64 (``chip_smoke.loss_ptxas``; the
box cube's own ``contactnets_loss.cuh`` kernels for ``cube``); their
times at the model's training batch (2,097,152 transitions of
``chip_smoke.train_transitions``, the elbow's
``elbow_train_transitions``, the polygon cube's and the wide polygons'
262,144) in both types,
``--reps`` launches each; with ``--budgets`` K1's and K3's times at every
(ipm, newton) budget of ``chip_smoke.SOLVE_BUDGETS`` with their split
into the terms, an IPM and a Newton iteration
(``chip_smoke.budget_timing``); with ``--check`` (generic sizes) K1, K3
and K2 against their plain versions on 8,192 transitions of the model's
own float64 rollout (``chip_smoke.compare_loss_kernels``, whose float64
bars raise) and a digest of the three kernels' float64 outputs there
(equal digests across trees and variants: equal bits); with ``--train``
a training round at the batch (``chip_smoke.TrainingRun``: a cold step,
the seed, 8 warm steps) and its step times.

The older modes, written for older checkouts (``--tree``) whose kernels
build into one library (their ``load_library``):

- ptxas's registers and stack of K1, K3 and K2 at both generic sizes, in
  float32 and float64 (``chip_smoke.loss_ptxas``);
- with ``--check``, K1, K3 and K2 against their plain versions on 8,192
  transitions of the elbow's, the polygon elbow's and the polygon cube's
  own rollouts (``chip_smoke.compare_loss_kernels``, whose float64 bars
  raise);
- K1's and K3's times on the elbow's 2,097,152 training transitions
  (``chip_smoke.elbow_train_transitions``, initial parameters) at every
  (ipm, newton) budget of ``chip_smoke.SOLVE_BUDGETS`` in float32 and at
  the training budgets in float64, and on the polygon cube's 262,144
  (``chip_smoke.train_transitions``) at the training budgets in both
  types;
- with ``--solves``, instead of the loss kernels, the hybrid solve
  kernels that share the solve's source, K5 and K4 at (n_v, k) = (6, 4)
  and (7, 8), on the QPs of the box cube's and the elbow's fused rollouts
  (``chip_smoke.rollout_qps``): K4 on 65,536 in both types; K5 on 8,192
  and 65,536 rollout QPs (at (6, 4) also 16,384, 32,768 and 49,152, about
  where one thread a QP fills the card) and on the QPs an ICNN model's
  warm loss hands it
  (the ICNN cube's 262,144 at (6, 4), the ICNN elbow's 65,536 at (7, 8)),
  each set with the share of its QPs that have contact, a digest of K5's
  outputs in each type (equal digests across trees and variants: equal
  bits) and its times in both types, and on the 8,192 against
  ``soa_kernels.plain_packed`` in float64 bit for bit; with ptxas's lines
  of K5 at both sizes;
- with ``--k4``, the cold solve K4 alone at the cold loss's budget (10,
  10), eps 1e-3, on its contact-rich sets (the QPs of the box cube's and
  the elbow's fused rollouts near the ground: 8,192, 32,768, 65,536 and
  262,144 at (6, 4), 8,192 and 65,536 at (7, 8)) and on the QPs the ICNN cube's (262,144)
  and the ICNN elbow's (65,536) cold loss hands it at initial parameters,
  with each set's share of QPs with contact, its digest and times in both
  types (three rounds), float64 against ``plain_packed_cold`` bit for bit
  on the 8,192 sets, and ptxas's K4 lines.

The data, checks and timing are this checkout's ``chip_smoke.py``; the
package, and so the kernels' sources, are the ``--tree``'s, built under its
``build/kernels``. ``--variant NAME`` measures instead a copy of the
tree's package under ``build/lane_probe/NAME/`` with the source edits of
``VARIANTS[NAME]``, designs the shipped kernels were measured against:
the box and sphere body's (``k3_*``, ``k2_*``, ``no_const_body``, on this
tree's sources, with ``--model``; these were measured beside designs
whose code was then taken out: K1 and K3 on five lanes a sample, with and without
exits and at 8 blocks a multiprocessor, the terms on a kernel of their own
before the solve on one thread a sample, alone and at 5 blocks, and K3's
warm solve with its exits; ``PERF.md`` §6 has their times); the older trees' (the ``k5_*`` ones
K5's at (7, 8), the ``k5_cube_*`` ones K5's at (6, 4), measured with
``--solves``; the ``k4_*`` ones K4's, measured with ``--k4``). To compare
two checkouts on one card, unpack the other into a directory
``.gitignore`` lists and run both in turns in one call:

    python3 scripts/probe_loss_lanes.py --model box_sphere --check \\
        --budgets --tree committed_tree/parent --label parent
    python3 scripts/probe_loss_lanes.py --model box_sphere --check --budgets
    python3 scripts/probe_loss_lanes.py --model box_sphere --variant \\
        k3_no_exits
    python3 scripts/probe_loss_lanes.py --solves --variant k5_lanes8
    python3 scripts/probe_loss_lanes.py --k4 --variant k4_lanes2

Needs one CUDA card and ``nvcc``. Prints one JSON line and appends it to
``chiprun_out/probe_loss_lanes.jsonl``.
"""
import argparse
import hashlib
import importlib.util
import json
import os
import re
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: QPs K4 is timed on with ``--solves``, and the rollout batches K5 is
#: timed on at the cube's (6, 4): about where one thread a QP fills the
#: card (``kWarmSoloFrom``), too.
SOLVE_K4_B = 65536
CUBE_K5_BATCHES = (8192, 16384, 32768, 49152, 65536)
#: The lines of the solve's sources that set K5's layout: lanes a QP (the
#: whole line, whatever the tree's counts), threads a block, and the 48 KB
#: of shared memory a block may hold.
K5_LANES = re.compile(r"template <int NV, int K> constexpr int kWarmLanes = "
                      r"[^;]*;")
K5_BLOCK = "template <int L> constexpr int kBlock = L == 1 ? 32 : 64;"
K5_SHARED = ('  static_assert(shared <= 48 * 1024, "a block\'s slots fit in '
             '48 KB");')


#: The lines of the cold solve's sources that set K4's design: lanes a QP
#: (the whole line), the batch from which the cube's runs fewer, and which
#: of its loops leave at their fixed points; as edits.
K4_LANES = re.compile(r"template <int NV, int K> constexpr int kColdLanes = "
                      r"[^;]*;")
K4_FEWER = "? 32768 : LLONG_MAX;"
K4_IPM_EXITS = ("template <typename T> constexpr bool kColdIpmExits = "
                "sizeof(T) == 8;")
K4_ALL_EXITS = ("cold_hybrid_solve.cu", K4_IPM_EXITS,
                "template <typename T> constexpr bool kColdIpmExits = true;")
K4_NO_IPM_EXITS = ("cold_hybrid_solve.cu", K4_IPM_EXITS,
                   "template <typename T> constexpr bool kColdIpmExits = "
                   "false;")
K4_NO_NEWTON_EXITS = ("cold_hybrid_solve.cu",
                      "constexpr bool kColdNewtonExits = true;",
                      "constexpr bool kColdNewtonExits = false;")


def k4_design(elbow: int, cube: int) -> list:
    """Edits that run K4 on ``elbow`` lanes a QP at (7, 8) and ``cube`` at
    (6, 4) (the shipped kernel's batch rule kept), raising the kernel's
    shared memory past 48 KB where the block needs it."""
    return [("hybrid_solve.cuh", K4_LANES,
             "template <int NV, int K> constexpr int kColdLanes = "
             f"K > 4 ? {elbow} : {cube};"),
            ("cold_hybrid_solve.cu", K5_SHARED,
             "  if (shared > 48 * 1024 && cudaFuncSetAttribute(\n"
             "          cold_hybrid_solve_kernel<T, NV, K, L>,\n"
             "          cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
             "          (int)shared) != cudaSuccess)\n"
             "    return (int)cudaGetLastError();")]


#: K4 with each value of its problem pinned where it was loaded (an empty
#: asm that the compiler must assume changes it), so that the solve keeps
#: the values in registers or its own stack and cannot load them again from
#: the inputs in global memory inside its loops.
K4_PIN = ("hybrid_solve.cuh",
          "  T gamma[3][KL];\n  const bool valid = cold_hybrid_solve<",
          """#ifdef __CUDA_ARCH__
  auto pin = [](T& x) {
    if constexpr (sizeof(T) == 4) asm volatile("" : "+f"(x));
    else asm volatile("" : "+d"(x));
  };
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < NV; ++j) pin(P.M[i][j]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < KL; ++c) {
      pin(P.q[i][c]);
#pragma unroll
      for (int v = 0; v < NV; ++v) pin(P.J[i][v][c]);
    }
#endif
  T gamma[3][KL];
  const bool valid = cold_hybrid_solve<""")


def k5_design(elbow: int, cube: int, threads: int,
              one_thread_block: int = 32) -> list:
    """Edits that run K5 on ``elbow`` lanes a QP at (7, 8) and ``cube`` at
    (6, 4), in blocks of ``threads`` threads (``one_thread_block`` where a
    QP has one thread), raising the kernel's shared memory past 48 KB where
    the block needs it."""
    return [("hybrid_solve.cuh", K5_LANES,
             "template <int NV, int K> constexpr int kWarmLanes = "
             f"K > 4 ? {elbow} : {cube};"),
            ("warm_hybrid_solve.cu", K5_BLOCK,
             "template <int L> constexpr int kBlock = "
             f"L == 1 ? {one_thread_block} : {threads};"),
            ("warm_hybrid_solve.cu", K5_SHARED,
             "  if (shared > 48 * 1024 && cudaFuncSetAttribute(\n"
             "          warm_hybrid_solve_kernel<T, NV, K, L>,\n"
             "          cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
             "          (int)shared) != cudaSuccess)\n"
             "    return (int)cudaGetLastError();")]


#: The lines of this tree's sources that choose the generic loss
#: kernels' designs at a size (``csrc/model_terms.cuh``,
#: ``csrc/model_loss.cuh``): one free body's joint as constants, K1's
#: exits, K2's gradient in shared memory.
COLD_EXITS = ("template <typename Z> constexpr bool kFwdColdExits = "
              "kConstFreeBody<Z>;")
CONST_BODY = re.compile(r"constexpr bool kConstFreeBody =[^;]*;")
BWD_SHARED = ("template <typename S, typename Z>\n"
              "constexpr bool kBwdGradShared =\n"
              "    kConstFreeBody<Z> &&\n"
              "    (size_t)Z::PMAX * kModelBwdThreads * sizeof(S) <= "
              "64 * 1024;")


def pin(line: str, value: str, source: str = "model_terms.cuh") -> tuple:
    """An edit that sets one of the choices above to ``value``."""
    head = line[:line.index("=") + 1]
    return (source, line, f"{head} {value};")


#: Other designs of the generic K1/K3 and K2, and of K5 and K4, as edits
#: (file under ``csrc/``, old text or pattern, new text) of the shipped
#: sources.
VARIANTS = {
    # The box and sphere body's (k = 5) K1 and K3 held to 5 blocks a
    # multiprocessor (fewer registers, more warps), and K1 without its
    # solve's exits.
    "k3_one_thread_blocks5": [
        ("model_loss.cuh", f"__launch_bounds__(kModelThreads) {name}(",
         f"__launch_bounds__(kModelThreads, 5) {name}(")
        for name in ("model_loss_fwd_kernel", "model_loss_fwd_warm_kernel")],
    "k3_no_exits": [pin(COLD_EXITS, "false")],
    # The joint of one free body read from the descriptor (the parent's
    # code), the other choices as shipped.
    "no_const_body": [("model_terms.cuh", CONST_BODY,
                       "constexpr bool kConstFreeBody = false;"),
                      pin(COLD_EXITS, "Z::K == 5"),
                      pin(BWD_SHARED, "Z::K == 5", "model_loss.cuh")],
    # K2's gradient in the thread's local stack (the parent's); K2 in
    # blocks of 64 threads.
    "k2_local_grad": [pin(BWD_SHARED, "false", "model_loss.cuh")],
    "k2_block64": [("model_loss.cuh",
                    "constexpr int kModelBwdThreads = 128;  // K2",
                    "constexpr int kModelBwdThreads = 64;  // K2")],
    # K5 at (7, 8) on one thread a QP (its design before lanes), on 2 or 8
    # lanes a QP, and on the shipped 4 in blocks of 32 or 128 threads (the
    # cube's at its shipped 4 lanes).
    "k5_one_thread": k5_design(1, 4, 64),
    "k5_lanes2": k5_design(2, 4, 64),
    "k5_lanes8": k5_design(8, 4, 64),
    "k5_block32": k5_design(4, 4, 32),
    "k5_block128": k5_design(4, 4, 128),
    # K5 at the cube's (6, 4) on one thread a QP in blocks of 64 (its
    # design before lanes had blocks of 32), on 2 lanes a QP, and on the
    # shipped 4 in blocks of 32 or 128 threads; and on 4 lanes at every
    # batch, float32 included (the shipped kernel runs one thread a QP
    # from kWarmSoloFrom QPs on).
    "k5_cube_one_thread": k5_design(4, 1, 64, one_thread_block=64),
    "k5_cube_lanes2": k5_design(4, 2, 64),
    "k5_cube_block32": k5_design(4, 4, 32),
    "k5_cube_block128": k5_design(4, 4, 128),
    "k5_cube_lanes_always": [("warm_hybrid_solve.cu", "? 32768 : LLONG_MAX;",
                              "? LLONG_MAX : LLONG_MAX;")],
    # K4's designs, each with its exits as measured. The shipped kernel
    # leaves SAP-Newton at its fixed point in both types and the IPM in
    # float64 only; ALL_EXITS (the PR's first design) leaves the IPM in
    # float32 too. K4 on one thread a QP at both sizes and in both types
    # (its design before lanes), on 2 lanes a QP at both sizes, on 8 at
    # (7, 8), and at (6, 4) on 4 lanes at every batch in both types (the
    # shipped kernel runs one thread a QP in float32 and 2 lanes in
    # float64 there from kColdFewerFrom QPs on), each with ALL_EXITS.
    "k4_one_thread": [*k4_design(1, 1), K4_ALL_EXITS],
    "k4_lanes2": [*k4_design(2, 2), K4_ALL_EXITS],
    "k4_lanes8": [*k4_design(8, 4), K4_ALL_EXITS],
    "k4_cube_lanes_always": [("cold_hybrid_solve.cu", K4_FEWER,
                              "? LLONG_MAX : LLONG_MAX;"), K4_ALL_EXITS],
    # The shipped layout with ALL_EXITS, with no exits, with the IPM's
    # alone, with SAP-Newton's alone in both types, and with the IPM's
    # frozen-mu exit alone (before the iteration's step); 2 lanes a QP at
    # both sizes without exits.
    "k4_all_exits": [K4_ALL_EXITS],
    "k4_no_exits": [K4_NO_IPM_EXITS, K4_NO_NEWTON_EXITS],
    "k4_ipm_exit_only": [K4_ALL_EXITS, K4_NO_NEWTON_EXITS],
    "k4_newton_exit_only": [K4_NO_IPM_EXITS],
    "k4_frozen_exit_only": [
        K4_ALL_EXITS, K4_NO_NEWTON_EXITS,
        ("hybrid_solve.cuh",
         "      if (g.warp_all(!(step_ok && !converged))) {",
         "      if (false) {")],
    "k4_lanes2_no_exits": [*k4_design(2, 2), K4_NO_IPM_EXITS,
                           K4_NO_NEWTON_EXITS],
    # ALL_EXITS with the problem pinned (K4_PIN): as shipped, on 2 lanes a
    # QP, on 4 lanes at every batch at (6, 4); and the pin without exits.
    "k4_pin": [K4_PIN, K4_ALL_EXITS],
    "k4_pin_no_exits": [K4_PIN, K4_NO_IPM_EXITS, K4_NO_NEWTON_EXITS],
    "k4_pin_lanes2": [K4_PIN, *k4_design(2, 2), K4_ALL_EXITS],
    "k4_pin_cube_lanes_always": [K4_PIN, ("cold_hybrid_solve.cu", K4_FEWER,
                                          "? LLONG_MAX : LLONG_MAX;"),
                                 K4_ALL_EXITS],
    # ALL_EXITS with each QP leaving the loops on its own, in place of a
    # warp leaving them together once all its QPs are at their fixed
    # points (the groups' warp_all).
    "k4_exits_diverge": [
        K4_ALL_EXITS,
        ("hybrid_solve.cuh", "  __device__ bool warp_all(bool p) const { "
         "return __all_sync(~0u, p); }",
         "  __device__ bool warp_all(bool p) const { return p; }"),
        ("hybrid_solve.cuh", "  __device__ static bool warp_all(bool p) { "
         "return __all_sync(~0u, p); }",
         "  __device__ static bool warp_all(bool p) { return p; }")],
    # One lane a contact at the elbow's size (8 lanes a sample).
    "lanes8": [("model_terms.cuh",
                "constexpr int kFwdLanes = Z::K > 4 ? Z::K / 2 : 1;",
                "constexpr int kFwdLanes = Z::K > 4 ? Z::K : 1;")],
    # Two contacts a lane at the polygon cube's size too.
    "polygon_lanes2": [("model_terms.cuh",
                        "constexpr int kFwdLanes = Z::K > 4 ? Z::K / 2 : 1;",
                        "constexpr int kFwdLanes = Z::K / 2;")],
    # The lanes' kernels held to 6 blocks a multiprocessor (168 registers,
    # 12 warps against 8 at 255).
    "min_blocks6": [
        ("model_loss.cuh",
         "__launch_bounds__(kModelThreads) model_loss_fwd_lanes_kernel(",
         "__launch_bounds__(kModelThreads, 6) model_loss_fwd_lanes_kernel("),
        ("model_loss.cuh",
         "__launch_bounds__(kModelThreads)\nmodel_loss_fwd_warm_lanes_kernel(",
         "__launch_bounds__(kModelThreads, 6)\n"
         "model_loss_fwd_warm_lanes_kernel(")],
    # Sums of more than two rows (the Schur and Newton matrices' 28
    # entries among them) folded in place on every lane from warp
    # shuffles, in place of shared memory with one lane a row.
    "rows_by_shuffle": [
        ("hybrid_solve.cuh",
         "  __device__ void sync() const { __syncwarp(mask_); }\n};",
         "  __device__ void sync() const { __syncwarp(mask_); }\n"
         "  __device__ T shfl(T v, int lane) const {\n"
         "    return __shfl_sync(mask_, v, threadIdx.x % 32 - lane_ + lane);\n"
         "  }\n};"),
        ("hybrid_solve.cuh",
         "  } else {\n    constexpr int K = KL * G::kLanes, W = K + 1;",
         "  } else if constexpr (N > 2) {\n"
         "#pragma unroll\n"
         "    for (int n = 0; n < N; ++n) {\n"
         "      T acc = g.shfl(t[n][0], 0);\n"
         "#pragma unroll\n"
         "      for (int c = 1; c < KL * G::kLanes; ++c)\n"
         "        acc = acc + g.shfl(t[n][c % KL], c / KL);\n"
         "      out[n] = acc;\n"
         "    }\n"
         "  } else {\n    constexpr int K = KL * G::kLanes, W = K + 1;")],
}


def variant_tree(tree: str, name: str) -> str:
    """A copy of ``tree``'s package under ``build/lane_probe/<name>/`` with
    the edits of ``VARIANTS[name]``; returns the copy's root."""
    root = os.path.join(ROOT, "build", "lane_probe", name)
    package = os.path.join(root, "dair_pll_tpu_torch")
    shutil.rmtree(package, ignore_errors=True)
    shutil.copytree(os.path.join(tree, "dair_pll_tpu_torch"), package,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for source, old, new in VARIANTS[name]:
        path = os.path.join(package, "csrc", source)
        with open(path) as handle:
            text = handle.read()
        if not isinstance(old, re.Pattern):
            old = re.compile(re.escape(old))
        text, found = old.subn(lambda _: new, text)
        if found != 1:
            raise RuntimeError(f"variant {name}: {source} does not hold "
                               f"{old.pattern!r} once")
        with open(path, "w") as handle:
            handle.write(text)
    return root


#: The training batch each ``--model`` is timed at: chip_smoke.py's.
MODEL_BATCH = {"box_sphere": 2097152, "ball": 2097152, "elbow": 2097152,
               "cube": 2097152, "cube_polygon": 262144,
               "wide_polygon": 262144, "wide_polygon_80": 262144}


def model_system(cs, name: str):
    """The system of a ``--model`` on the card."""
    from dair_pll_tpu_torch import assets
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    if name in cs.SIZE_URDFS:
        return cs.size_systems()[name]
    if name == "wide_polygon":
        return cs.wide_polygon_system()
    if name == "wide_polygon_80":
        return cs.wide_polygon_system(sides=40)
    if name == "elbow":
        return cs.elbow_system()
    return MultibodyLearnableSystem.from_urdfs(
        {"cube": assets.get_asset("cube" if name == "cube" else
                                  "cube_mesh")}, cs.DT,
        **({} if name == "cube" else {"mesh_representation": "polygon"}))


def model_times(cs, name: str, check: bool, budgets: bool, train: bool,
                reps: int) -> dict:
    """``--model``'s readings, as the module's docstring lists."""
    import torch
    from dair_pll_tpu_torch.ops import soa_kernels
    from dair_pll_tpu_torch.ops import soa_loss_kernels as lk
    system = model_system(cs, name)
    model = system.model
    cube = name == "cube"
    size = None if cube else lk.model_size(model)
    out = {"model": name, "size": "cube" if cube else size.name}
    t0 = time.perf_counter()
    soa_kernels.build_instances(
        [lk.CUBE_INSTANCE] if cube else
        [i for dtype in (torch.float32, torch.float64)
         for i in lk.loss_instances(size, dtype)])
    out["build_seconds"] = time.perf_counter() - t0
    out["ptxas"] = (cs.ptxas_lines("contactnets_loss_cube") if cube else
                    cs.loss_ptxas(size.name))
    if check and not cube:
        x0 = cs.states_near_ground(system, cs.B, 21)
        x64, xp64 = cs.model_transitions(system, x0)
        out["vs_plain"] = cs.compare_loss_kernels(system, x64, xp64)[0]
        pvec = cs.derived_vector(system,
                                 system.initial_params(torch.float64))
        xin, xp = x64.T.contiguous(), xp64.T.contiguous()
        ct = torch.ones_like(xin[0])
        k1 = lk.fused_loss_fwd(model, pvec, xin, xp, cs.DT, cs.LOSS_EPS,
                               *cs.COLD_BUDGET)
        k3 = lk.fused_loss_fwd_warm(model, pvec, xin, xp, k1[1], cs.DT,
                                    cs.LOSS_EPS, *cs.WARM_BUDGET)
        k2 = lk.fused_loss_bwd(model, pvec, xin, xp, k3[1], k3[2], ct,
                               cs.DT, cs.LOSS_EPS)
        out["float64_digests"] = {"K1": digest(k1), "K3": digest(k3),
                                  "K2": digest(k2)}
        del x64, xp64, xin, xp, k1, k3, k2
    n = MODEL_BATCH[name]
    transitions = (cs.elbow_train_transitions if name == "elbow" else
                   cs.train_transitions)
    x, x_plus = transitions(n, system.device)
    if train:
        run = cs.TrainingRun(system, x, x_plus)
        report = run.timed()[0]
        out["train"] = {key: report[key] for key in (
            "cold_step_ms", "seed_ms", "warm_step_median_ms", "warm_step_ms",
            "warm_transitions_per_s", "launches")}
        del run
    pvec = cs.derived_vector(system, system.initial_params(torch.float32))
    xin, xp = x.T.contiguous(), x_plus.T.contiguous()
    del x, x_plus
    out["B"] = n
    for dtype in (torch.float32, torch.float64):
        args = [t.to(dtype) for t in (pvec, xin, xp)]
        ct = torch.ones_like(args[1][0])
        cold = lk.fused_loss_fwd(model, *args, cs.DT, cs.LOSS_EPS,
                                 *cs.COLD_BUDGET)
        r = reps if dtype == torch.float32 else max(1, reps // 2)
        out[str(dtype).split(".")[1]] = {
            "K1": cs.cuda_ms(lambda: lk.fused_loss_fwd(
                model, *args, cs.DT, cs.LOSS_EPS, *cs.COLD_BUDGET), r,
                warmup=1),
            "K3": cs.cuda_ms(lambda: lk.fused_loss_fwd_warm(
                model, *args, cold[1], cs.DT, cs.LOSS_EPS,
                *cs.WARM_BUDGET), r, warmup=1),
            "K2": cs.cuda_ms(lambda: lk.fused_loss_bwd(
                model, *args, cold[1], cold[2], ct, cs.DT, cs.LOSS_EPS), r,
                warmup=1),
            "valid_share": cold[2].float().mean().item()}
        if budgets and dtype == torch.float32:
            out["budgets"] = cs.budget_timing(model, *args, cold[1], reps=3)
        del args, cold, ct
        torch.cuda.empty_cache()
    return out


def loss_times(cs, check: bool) -> dict:
    """The generic K1 and K3 (and with ``check`` K1, K3 and K2 against
    their plain versions) on the elbow's and the polygon cube's training
    transitions, as the module's docstring lists."""
    import torch
    from dair_pll_tpu_torch import assets
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    from dair_pll_tpu_torch.ops import soa_loss_kernels as lk
    out = {}
    systems = {"elbow": cs.elbow_system(),
               "elbow_polygon": cs.elbow_system(
                   "elbow_mesh", mesh_representation="polygon"),
               "cube_polygon": MultibodyLearnableSystem.from_urdfs(
                   {"cube": assets.get_asset("cube_mesh")}, cs.DT,
                   mesh_representation="polygon")}
    if check:
        out["vs_plain"] = {}
        for i, (name, system) in enumerate(systems.items()):
            x0 = cs.states_near_ground(system, cs.B, 6 + i)
            out["vs_plain"][name] = cs.compare_loss_kernels(
                system, *cs.model_transitions(system, x0))[0]

    def training_budgets(model, pvec, xin, xp, fprev, dtype) -> dict:
        args = [t.to(dtype) for t in (pvec, xin, xp, fprev)]
        return {
            "K1": cs.cuda_ms(lambda: lk.fused_loss_fwd(
                model, *args[:3], cs.DT, cs.LOSS_EPS, *cs.COLD_BUDGET), 3,
                warmup=1),
            "K3": cs.cuda_ms(lambda: lk.fused_loss_fwd_warm(
                model, *args, cs.DT, cs.LOSS_EPS, *cs.WARM_BUDGET), 3,
                warmup=1)}

    for name, n, transitions in (
            ("elbow", cs.ELBOW_TRAIN_B, cs.elbow_train_transitions),
            ("cube_polygon", cs.POLYGON_TRAIN_B, cs.train_transitions)):
        system = systems[name]
        x, x_plus = transitions(n, system.device)
        xin, xp = x.T.contiguous(), x_plus.T.contiguous()
        del x, x_plus
        pvec = cs.derived_vector(system, system.initial_params(torch.float32))
        fprev = lk.fused_loss_fwd(system.model, pvec, xin, xp, cs.DT,
                                  cs.LOSS_EPS, *cs.COLD_BUDGET)[1]
        timing = {"B": n}
        if name == "elbow":
            timing["budgets"] = cs.budget_timing(system.model, pvec, xin, xp,
                                                 fprev, reps=3)
        for dtype in (torch.float32, torch.float64):
            timing[str(dtype).split(".")[1]] = training_budgets(
                system.model, pvec, xin, xp, fprev, dtype)
        out[f"timing_{name}"] = timing
        del xin, xp, fprev
        torch.cuda.empty_cache()
    return out


def solve_times(cs, elbow) -> dict:
    """K5 and K4 at (6, 4) (the box cube) and (7, 8) (the elbow) on the
    QPs of their fused rollouts at the initial parameters, in ms, float32
    and float64: K4 on 65,536 at the cold loss's budget; K5 on the sets of
    ``k5_sets``."""
    import torch
    from dair_pll_tpu_torch import assets
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    from dair_pll_tpu_torch.ops import soa_kernels
    cube = MultibodyLearnableSystem.from_urdfs(
        {"cube": assets.get_asset("cube")}, cs.DT)
    kernel = soa_kernels.solve_contact_impulse_soa_cuda_packed
    out = {}
    for shape, system, states in (
            ("nv6_k4", cube, lambda n: cube_states(cs, cube, n)),
            ("nv7_k8", elbow, lambda n: cs.states_near_ground(elbow, n, 4))):
        q64 = cs.rollout_qps(system, system.initial_params(torch.float64),
                             states(SOLVE_K4_B))
        for dtype in (torch.float32, torch.float64):
            q = tuple(t.to(dtype) for t in q64[:3])
            with torch.no_grad():
                out[f"K4_{shape}_{str(dtype).split('.')[1]}"] = cs.cuda_ms(
                    lambda: kernel(*q, cs.LOSS_EPS, *cs.COLD_BUDGET), 5)
        del q64, q
        torch.cuda.empty_cache()
    out["K5_nv6_k4"] = k5_sets(cs, cube, (6, 4), CUBE_K5_BATCHES, (
        ("icnn_loss_262144", lambda: icnn_warm_qps(
            cs, MultibodyLearnableSystem.from_urdfs(
                {"cube": assets.get_asset("cube_mesh")}, cs.DT),
            cs.train_transitions, cs.ICNN_TRAIN_B)),))
    out["K5_nv7_k8"] = k5_sets(cs, elbow, (7, 8), (cs.B, SOLVE_K4_B), (
        ("icnn_loss_65536", lambda: icnn_warm_qps(
            cs, cs.elbow_system("elbow_mesh"), cs.elbow_train_transitions,
            cs.ELBOW_ICNN_B)),))
    return out


def k4_times(cs) -> dict:
    """K4 on its contact-rich sets and on the ICNN models' cold loss QPs,
    as the module's docstring lists: per set the share of QPs with
    contact, the digest of the outputs and the times in each type; on the
    8,192 sets, float64 against the plain version bit for bit. ptxas's
    lines of K4 at both sizes."""
    import torch
    from dair_pll_tpu_torch import assets
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    from dair_pll_tpu_torch.ops import soa_kernels
    kernel = soa_kernels.solve_contact_impulse_soa_cuda_packed
    args = (cs.LOSS_EPS, *cs.COLD_BUDGET)
    cube = MultibodyLearnableSystem.from_urdfs(
        {"cube": assets.get_asset("cube")}, cs.DT)
    elbow = cs.elbow_system()
    out = {shape: cs.k4_ptxas(shape) for shape in ("nv6_k4", "nv7_k8")}

    def rollout(system, states, n):
        return cs.rollout_qps(system, system.initial_params(torch.float64),
                              states(n))[:3]

    def icnn(system, transitions, n):
        return cs.cold_loss_qps(system, system.initial_params(torch.float32),
                                *transitions(n, system.device))

    cube_at = (lambda n: cube_states(cs, cube, n))
    elbow_at = (lambda n: cs.states_near_ground(elbow, n, 4))
    sets = (
        ("rich_nv6_k4_8192", lambda: rollout(cube, cube_at, cs.B)),
        ("rich_nv6_k4_32768", lambda: rollout(cube, cube_at, 32768)),
        ("rich_nv6_k4_65536", lambda: rollout(cube, cube_at, 65536)),
        ("rich_nv6_k4_262144", lambda: rollout(cube, cube_at, 262144)),
        ("rich_nv7_k8_8192", lambda: rollout(elbow, elbow_at, cs.B)),
        ("rich_nv7_k8_65536", lambda: rollout(elbow, elbow_at, 65536)),
        ("icnn_nv6_k4_262144", lambda: icnn(
            MultibodyLearnableSystem.from_urdfs(
                {"cube": assets.get_asset("cube_mesh")}, cs.DT),
            cs.train_transitions, cs.ICNN_TRAIN_B)),
        ("icnn_nv7_k8_65536", lambda: icnn(
            cs.elbow_system("elbow_mesh"), cs.elbow_train_transitions,
            cs.ELBOW_ICNN_B)))
    for name, make in sets:
        qps = make()
        entry = {"B": int(qps[0].shape[-1])}
        for dtype in (torch.float32, torch.float64):
            key = str(dtype).split(".")[1]
            q = tuple(t.to(dtype) for t in qps)
            with torch.no_grad():
                got = kernel(*q, *args)
                entry[f"{key}_digest"] = digest(got)
                entry[f"{key}_contact_share"] = got[0].abs().amax(
                    dim=(0, 1)).gt(0).float().mean().item()
                if name.endswith("_8192") and dtype == torch.float64:
                    entry["float64_equals_plain"] = all(
                        torch.equal(a, b) for a, b in zip(
                            got, soa_kernels.plain_packed_cold(*q, *args)))
                entry["ms" if key == "float32" else "ms_float64"] = [
                    cs.cuda_ms(lambda: kernel(*q, *args), 5)
                    for _ in range(3)]
        out[name] = entry
        del qps, q, got
        torch.cuda.empty_cache()
    return out


def cube_states(cs, cube, n: int):
    """The box cube's rollout states near the ground, as ``chip_smoke.py``
    makes them."""
    import numpy as np
    import torch
    from dair_pll_tpu_torch import assets
    return torch.tensor(
        assets.cube_states_near_ground(np.random.default_rng(0), n),
        dtype=torch.float64, device=cube.device)


def digest(outputs) -> str:
    """A digest of a solve's outputs' bits."""
    h = hashlib.sha256()
    for t in outputs:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def k5_sets(cs, system, shape, batches, loss_sets) -> dict:
    """K5 at ``shape`` on the model's rollout QPs at ``batches`` (8,192,
    the main path's batch, first; budget (14, 6), eps 1e-4) and on the sets of
    ``loss_sets`` (name, maker of ``(qps, args)``: the QPs an ICNN
    model's warm loss hands it): per set the share of QPs with any
    impulse, the digest of the outputs and the time in each type; on the
    8,192, float64 against the plain version bit for bit. ptxas's lines
    of K5 at ``shape``."""
    import torch
    from dair_pll_tpu_torch.ops import soa_kernels
    kernel = soa_kernels.solve_warm_hybrid_soa_cuda_packed
    params = system.initial_params(torch.float64)
    rollout = (cs.EPS, *cs.BUDGET)
    states = ((lambda n: cube_states(cs, system, n)) if shape == (6, 4) else
              (lambda n: cs.states_near_ground(system, n, 4)))
    n_v, k = shape
    out = {"ptxas": [line for t in "fd" for line in cs.ptxas_lines(
        "warm_hybrid_solve.cu",
        f"warm_hybrid_solve_kernelI{t}Li{n_v}ELi{k}E")]}
    sets = (*((f"rollout_{n}", lambda n=n: (cs.rollout_qps(
                system, params, states(n)), rollout)) for n in batches),
            *loss_sets)
    for name, make in sets:
        qps, args = make()
        entry = {"B": int(qps[0].shape[-1]), "args": list(args)}
        for dtype in (torch.float32, torch.float64):
            key = str(dtype).split(".")[1]
            q = tuple(t.to(dtype) for t in qps)
            with torch.no_grad():
                got = kernel(*q, *args)
                entry[f"{key}_digest"] = digest(got)
                entry[f"{key}_active_share"] = got[0].abs().amax(
                    dim=(0, 1)).gt(0).float().mean().item()
                if name == "rollout_8192" and dtype == torch.float64:
                    entry["float64_equals_plain"] = all(
                        torch.equal(a, b) for a, b in zip(
                            got, soa_kernels.plain_packed(*q, *args)))
                entry["ms" if key == "float32" else "ms_float64"] = [
                    cs.cuda_ms(lambda: kernel(*q, *args), 10)
                    for _ in range(3)]
        out[name] = entry
        del qps, q, got
        torch.cuda.empty_cache()
    return out


def icnn_warm_qps(cs, system, transitions, n: int):
    """The packed QPs ``(m, jc, qc, w0)`` and arguments ``(eps, ipm,
    newton)`` an ICNN model's warm loss hands K5 at ``n`` transitions of
    ``transitions(n, device)`` (the model's training recipe: float32,
    initial parameters, warm-started from the cache's seed as
    ``chip_smoke.py``'s ICNN phases run it), captured at
    ``solve_warm_hybrid_soa_cuda_packed``."""
    import torch
    from dair_pll_tpu_torch.ops import soa_kernels
    x, x_plus = transitions(n, system.device)
    params = system.initial_params(torch.float32)
    u = x.new_zeros((x.shape[0], 0))
    solve = soa_kernels.solve_warm_hybrid_soa_cuda_packed
    captured = []

    def capture(*args):
        captured.append(args)
        return solve(*args)

    with torch.no_grad():
        _, seed = system.contactnets_loss_batch_warm(
            params, x, u, x_plus,
            x.new_zeros((3, system.model.n_contacts, x.shape[0])),
            budget=cs.COLD_BUDGET)
        soa_kernels.solve_warm_hybrid_soa_cuda_packed = capture
        try:
            system.contactnets_loss_batch_warm(params, x, u, x_plus, seed)
        finally:
            soa_kernels.solve_warm_hybrid_soa_cuda_packed = solve
    if len(captured) != 1:
        raise AssertionError(f"the warm loss solved {len(captured)} times")
    return captured[0][:4], captured[0][4:]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=ROOT,
                        help="checkout whose package and kernels to measure")
    parser.add_argument("--label", default="change")
    parser.add_argument("--check", action="store_true",
                        help="hold the kernels against their plain versions")
    parser.add_argument("--solves", action="store_true",
                        help="time K5 and K4 instead of the loss kernels")
    parser.add_argument("--k4", action="store_true",
                        help="time the cold solve K4 alone")
    parser.add_argument("--variant", choices=sorted(VARIANTS),
                        help="measure the tree with this design's edits")
    parser.add_argument("--model", choices=sorted(MODEL_BATCH),
                        help="time this model's loss kernels")
    parser.add_argument("--budgets", action="store_true",
                        help="with --model, K1 and K3 at every budget")
    parser.add_argument("--train", action="store_true",
                        help="with --model, a training round's steps")
    parser.add_argument("--reps", type=int, default=5,
                        help="with --model, launches timed a kernel")
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    if args.variant:
        tree = variant_tree(tree, args.variant)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("probe_loss_lanes: no CUDA device is available",
              file=sys.stderr)
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

    out = {"label": args.label, "tree": tree, "variant": args.variant,
           "nvidia_smi": cs.phase_device()}
    if args.model:
        out.update(model_times(cs, args.model, args.check, args.budgets,
                               args.train, args.reps))
    else:
        t0 = time.perf_counter()
        soa_kernels.load_library()
        out["build_seconds"] = time.perf_counter() - t0
        out["ptxas"] = {size: cs.loss_ptxas(size) for size in ("b1", "b2")}
        if args.k4:
            out["k4"] = k4_times(cs)
        elif args.solves:
            out["solves"] = solve_times(cs, cs.elbow_system())
        else:
            out.update(loss_times(cs, args.check))

    line = json.dumps(out)
    print(line, flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "probe_loss_lanes.jsonl"),
              "a") as sink:
        sink.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
